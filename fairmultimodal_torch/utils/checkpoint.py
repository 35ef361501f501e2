"""Exported parameter files in the JAX package's format.

``fairmultimodal_tpu.utils.checkpoint.save_params_npz`` writes a flat npz
whose keys are the ``/``-joined flax parameter paths, plus an optional
``__metadata_json__`` entry (the model geometry, thresholds and dynamic
weights as JSON bytes).  :func:`save_params_npz` writes the same file from a
flax tree (:func:`fairmultimodal_torch.interop.flax_params`); the readers
return plain numpy / JSON, ready for
:func:`fairmultimodal_torch.interop.load_flax_params`.  Each package reads
the other's files.

Not ported: the JAX ``Checkpointer`` (train-state resume, ROADMAP).
"""

from __future__ import annotations

import json
from typing import Dict, Mapping, Optional

import numpy as np

__all__ = ["save_params_npz", "load_params_npz", "load_metadata_npz"]

_META_KEY = "__metadata_json__"


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    # Sorted keys at every level: the order jax.tree_util flattens a dict in.
    flat: Dict[str, np.ndarray] = {}
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, Mapping):
            flat.update(_flatten(val, f"{prefix}{key}/"))
        else:
            flat[prefix + key] = np.asarray(val)
    return flat


def save_params_npz(path: str, params: Mapping, metadata: Optional[Dict] = None) -> None:
    """Flat-key npz export of a nested parameter tree; ``metadata``
    (JSON-serializable, e.g. the model geometry) rides along."""
    flat = _flatten(params)
    if metadata is not None:
        flat[_META_KEY] = np.frombuffer(json.dumps(metadata).encode(), dtype=np.uint8)
    np.savez(path, **flat)


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
