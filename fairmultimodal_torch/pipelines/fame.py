"""Model input arrays of the FAME pipeline (port of ``pipelines/fame.py:90-102``).

Training (``run_fame_experiment`` and its loaders) is the next slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from fairmultimodal_torch.data.featurize import FeatureBundle

__all__ = ["build_model_arrays"]


def build_model_arrays(bundle: FeatureBundle) -> Dict[str, np.ndarray]:
    """FeatureBundle -> flat dict of model input arrays (10_FAME:714-723)."""
    n = bundle.num_patients
    return {
        "demo_dummy_ids": np.zeros((n, 1), np.int32),
        "demo_attn_mask": np.ones((n, 1), np.int32),
        "age_ids": bundle.age_codes.astype(np.int32),
        "gender_ids": bundle.gender_codes.astype(np.int32),
        "ethnicity_ids": bundle.ethnicity_codes.astype(np.int32),
        "insurance_ids": bundle.insurance_codes.astype(np.int32),
        "lab_features": bundle.labs.astype(np.float32),
        "text_embedding": bundle.text_embeddings.astype(np.float32),
    }
