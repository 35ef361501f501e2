"""Serving pipeline (port of ``fairmultimodal_tpu.pipelines``)."""
