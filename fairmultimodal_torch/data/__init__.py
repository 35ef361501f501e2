"""Data layer (port of ``fairmultimodal_tpu.data``): the MIMIC-III ETL
(``etl``, ``native``, ``validate``; no pandas), port tables and their CSV
reader / writer (``table``), feature assembly, splits, loaders and synthetic
MIMIC-shaped data.  The package exports the JAX package's names."""

from fairmultimodal_torch.data.device import DeviceLoader
from fairmultimodal_torch.data.featurize import FeatureBundle, assemble_features
from fairmultimodal_torch.data.loader import BatchIterator, pad_to_multiple
from fairmultimodal_torch.data.prefetch import PrefetchLoader, prefetch_to_device
from fairmultimodal_torch.data.split import (
    multilabel_stratified_split,
    reference_three_way_split,
)

__all__ = [
    "DeviceLoader",
    "PrefetchLoader",
    "prefetch_to_device",
    "multilabel_stratified_split",
    "reference_three_way_split",
    "FeatureBundle",
    "assemble_features",
    "BatchIterator",
    "pad_to_multiple",
]
