"""Device-resident training data (port of ``fairmultimodal_tpu/data/device.py``).

:class:`DeviceLoader` moves a split's arrays to the device once; each batch
is then gathered there with ``index_select`` from a ``[B]`` int32 index
tensor, so the host sends a few hundred bytes per step instead of the batch.
Pad rows are zeroed and ``weight`` is the valid mask, so every batch equals
the host :class:`~fairmultimodal_torch.data.loader.BatchIterator` batch
moved to the device, bit for bit: the same ``np.random.default_rng((seed,
epoch))`` permutation, the same zero-padded final batch.

Under a data-parallel ``mesh`` (the JAX loader's ``mesh=``) the whole split
is parked on every rank's device, replicated as in JAX, and each rank
gathers only its contiguous columns of the epoch's ``[B]`` index: the rows
``parallel.shard_batch`` would give it of the global batch.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from fairmultimodal_torch.ops.gates import resolve_device

__all__ = ["DeviceLoader"]


class DeviceLoader:
    """Shuffled fixed-shape batches gathered on ``device`` from parked arrays.

    Yields ``{"model_inputs": {...}, "labels": ..., "weight": ...}`` batches
    of device tensors; ``device_resident = True`` makes
    :class:`~fairmultimodal_torch.data.prefetch.PrefetchLoader` pass them
    through untouched.

    Args:
      model_inputs: flat dict of per-patient arrays (leading dim N).
      labels: [N, T] float labels.
      batch_size: fixed batch size; the final batch is padded and masked.
      shuffle: per-epoch reshuffle with the BatchIterator protocol.
      seed: shuffle seed (permutation = default_rng((seed, epoch))).
      device: ``None`` means CUDA and raises without it; ``"cpu"`` for tests.
      mesh: a mesh: park on ``mesh.device`` and yield this rank's
        ``batch_size / mesh.data`` rows of each global batch, by its data
        index (the ranks of a model group take the same rows).
    """

    device_resident = True

    def __init__(self, model_inputs: Dict[str, np.ndarray], labels: np.ndarray,
                 batch_size: int, shuffle: bool = False, seed: int = 42, device=None,
                 mesh=None):
        sizes = {k: len(v) for k, v in model_inputs.items()}
        sizes["labels"] = len(labels)
        if len(set(sizes.values())) != 1:
            raise ValueError(f"ragged arrays: {sizes}")
        self.mesh = mesh
        if mesh is not None:
            if batch_size % mesh.data:
                raise ValueError(f"batch_size {batch_size} does not split over the mesh's "
                                 f"{mesh.data} ranks")
            device = mesh.device
        self.device = resolve_device(device)
        self.n = len(labels)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self._data = {k: self._put(v) for k, v in model_inputs.items()}
        self._labels = self._put(labels)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def add_arrays(self, extra: Dict[str, np.ndarray]) -> None:
        """Park additional per-patient arrays; they appear under
        ``model_inputs`` in every later batch."""
        for k, v in extra.items():
            if len(v) != self.n:
                raise ValueError(f"{k}: length {len(v)} != {self.n}")
            self._data[k] = self._put(v)

    def __len__(self) -> int:
        return (self.n + self.batch_size - 1) // self.batch_size

    def _permutation(self) -> np.ndarray:
        """This pass's row order; a shuffled pass consumes one epoch."""
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
            self.epoch += 1
        return idx

    def epoch_index_matrix(self) -> Tuple[np.ndarray, np.ndarray]:
        """One epoch's batching as ([steps, B] int32, [steps, B] bool), with
        ``__iter__``'s permutation, zero-index padding and epoch use."""
        idx = self._permutation()
        steps = len(self)
        pad = steps * self.batch_size - self.n
        valid = np.ones(steps * self.batch_size, bool)
        if pad:
            idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
            valid[-pad:] = False
        return (idx.reshape(steps, self.batch_size).astype(np.int32),
                valid.reshape(steps, self.batch_size))

    def _gather(self, idx: torch.Tensor, valid: torch.Tensor) -> Dict:
        def take(a):
            b = a.index_select(0, idx)
            # Zero the pad rows so device batches equal BatchIterator's
            # zero-padded host batches bit for bit.
            return b.masked_fill(~valid.reshape((-1,) + (1,) * (b.dim() - 1)), 0)

        return {"model_inputs": {k: take(v) for k, v in self._data.items()},
                "labels": take(self._labels), "weight": valid.to(torch.float32)}

    def __iter__(self) -> Iterator[Dict]:
        idx_mat, valid_mat = self.epoch_index_matrix()
        if self.mesh is not None:
            b = self.batch_size // self.mesh.data
            cols = slice(self.mesh.data_index * b, (self.mesh.data_index + 1) * b)
            idx_mat, valid_mat = idx_mat[:, cols], valid_mat[:, cols]
        for idx, valid in zip(idx_mat, valid_mat):
            yield self._gather(torch.from_numpy(idx).to(self.device, non_blocking=True),
                               torch.from_numpy(valid).to(self.device, non_blocking=True))
