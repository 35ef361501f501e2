"""Checkpoint reading (port of ``fairmultimodal_tpu.utils``)."""
