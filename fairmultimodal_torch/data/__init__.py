"""Host-side feature assembly (port of ``fairmultimodal_tpu.data``)."""
