"""Data layer (port of ``fairmultimodal_tpu.data``): the MIMIC-III ETL
(``etl``, ``native``, ``validate``; no pandas), port tables and their CSV
reader / writer (``table``), feature assembly, splits, loaders and synthetic
MIMIC-shaped data."""
