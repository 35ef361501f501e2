"""Exported parameter files in the JAX package's format.

``fairmultimodal_tpu.utils.checkpoint.save_params_npz`` writes a flat npz
whose keys are the ``/``-joined flax parameter paths, plus an optional
``__metadata_json__`` entry (the model geometry, thresholds and dynamic
weights as JSON bytes).  :func:`save_params_npz` writes the same file from a
flax tree (:func:`fairmultimodal_torch.interop.flax_params`); the readers
return plain numpy / JSON, ready for
:func:`fairmultimodal_torch.interop.load_flax_params`.  Each package reads
the other's files.

:class:`Checkpointer` keeps the train state for resume in the port's own
format (the JAX one writes orbax directories): one ``step_<k>.pt`` per
completed epoch, written under a temporary name and moved into place with
``os.replace``, so a reader never sees a torn file.  Each file holds tensors
and plain Python containers only and reads back with ``torch.load(...,
weights_only=True)``.  Under a mesh rank 0 writes, every rank
waits until the file is in place, and every rank reads.  A tensor-parallel
trainer hands it the full parameters and moments, gathered over the model
group, so the file is the one a single process writes.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

__all__ = ["save_params_npz", "load_params_npz", "load_metadata_npz", "Checkpointer"]

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


class Checkpointer:
    """Per-epoch train-state files ``<directory>/step_<k>.pt``; with a
    ``mesh`` only rank 0 writes them."""

    _STEP = re.compile(r"step_(\d+)\.pt")

    def __init__(self, directory: str, mesh=None):
        self.directory = os.path.abspath(directory)
        self.mesh = mesh
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, state: Union[Dict[str, Any], Callable[[], Dict[str, Any]]]) -> str:
        """Write ``state`` (or what the function ``state`` returns, called on
        the writing rank only) for ``step``; returns the file's path.  Under a
        mesh every rank returns once the file is in place."""
        path = self.path(step)
        if self.mesh is None or self.mesh.rank == 0:
            tmp = f"{path}.tmp.{os.getpid()}"
            try:
                torch.save(state() if callable(state) else state, tmp)
                os.replace(tmp, path)
            except BaseException:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise
        if self.mesh is not None:
            from fairmultimodal_torch.parallel.sharding import barrier

            barrier(self.mesh)
        return path

    def restore(self, step: int, map_location=None) -> Dict[str, Any]:
        return torch.load(self.path(step), map_location=map_location, weights_only=True)

    def latest_step(self) -> Optional[int]:
        """The largest completed step; temporary files do not count."""
        steps = [int(m.group(1)) for m in map(self._STEP.fullmatch, os.listdir(self.directory))
                 if m]
        return max(steps) if steps else None
