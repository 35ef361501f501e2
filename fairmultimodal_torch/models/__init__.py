"""Encoders and the FAME fusion model (port of ``fairmultimodal_tpu.models``)."""
