"""Read the JAX package's exported parameter files.

``fairmultimodal_tpu.utils.checkpoint.save_params_npz`` writes a flat npz
whose keys are the ``/``-joined flax parameter paths, plus an optional
``__metadata_json__`` entry (the model geometry, thresholds and dynamic
weights).  These readers return plain numpy / JSON, ready for
:func:`fairmultimodal_torch.interop.load_flax_params`.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

__all__ = ["load_params_npz", "load_metadata_npz"]

_META_KEY = "__metadata_json__"


def load_params_npz(path: str) -> Dict:
    """Exported npz -> nested dict of numpy arrays (the flax tree)."""
    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            if key == _META_KEY:
                continue
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


def load_metadata_npz(path: str) -> Optional[Dict]:
    """The metadata stored beside the parameters (None when absent)."""
    with np.load(path) as data:
        if _META_KEY not in data.files:
            return None
        return json.loads(bytes(data[_META_KEY].tolist()).decode())
