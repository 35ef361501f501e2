"""Fixed-shape batch iteration (the port's own copy of
``fairmultimodal_tpu/data/loader.py``).

Every batch has the same shape: the final batch is zero-padded up to the
batch size and carries a ``weight`` mask (1 real / 0 pad) that every loss
and metric reduces with, so padding changes no result.  Shuffles are seeded
per (seed, epoch) with numpy, exactly as the JAX package shuffles, so both
packages see the same batches.
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np

__all__ = ["BatchIterator", "NestedLoader", "pad_to_multiple"]


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, value=0):
    """Pad ``x`` along ``axis`` so its size is a multiple of ``multiple``."""
    size = x.shape[axis]
    target = ((size + multiple - 1) // multiple) * multiple
    if target == size:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - size)
    return np.pad(x, pad, constant_values=value)


class BatchIterator:
    """Shuffled, padded, fixed-shape batch iterator over a dict of arrays.

    Yields dicts with the same keys plus ``"weight"`` ([B] float32 validity
    mask).  Each pass with ``shuffle`` draws the (seed, epoch) permutation
    and advances ``epoch``.
    """

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int, shuffle: bool = False,
                 seed: int = 42, drop_remainder: bool = False):
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"ragged arrays: {sizes}")
        self.arrays = arrays
        self.n = next(iter(sizes.values()))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.epoch = 0

    def __len__(self) -> int:
        if self.drop_remainder:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
            self.epoch += 1
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            weight = np.ones(len(sel), dtype=np.float32)
            batch = {k: v[sel] for k, v in self.arrays.items()}
            if len(sel) < self.batch_size:
                pad_n = self.batch_size - len(sel)
                batch = {k: np.concatenate([v, np.zeros((pad_n,) + v.shape[1:], v.dtype)])
                         for k, v in batch.items()}
                weight = np.concatenate([weight, np.zeros(pad_n, np.float32)])
            batch["weight"] = weight
            yield batch


class NestedLoader:
    """Flat :class:`BatchIterator` -> the trainer's batch schema
    (``{"model_inputs": {...}, "labels", "weight"}``), keeping the keys the
    model consumes (``fairmultimodal_tpu/pipelines/common.py::NestedLoader``)."""

    def __init__(self, it: BatchIterator, keys: Sequence[str]):
        self.it = it
        self.keys = tuple(keys)

    def __len__(self) -> int:
        return len(self.it)

    def __iter__(self):
        for flat in self.it:
            yield {"model_inputs": {k: flat[k] for k in self.keys if k in flat},
                   "labels": flat["labels"], "weight": flat["weight"]}
