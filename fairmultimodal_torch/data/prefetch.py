"""Host -> device batch prefetching (port of ``fairmultimodal_tpu/data/prefetch.py``).

Each (nested) numpy batch is copied to the device one batch ahead of its
use: the arrays are staged in pinned host memory and copied with
``non_blocking=True``, so the copy of batch N+1 overlaps the card computing
step N.  Tensors already on the device pass through unchanged, and a loader
marked ``device_resident`` (:class:`~fairmultimodal_torch.data.device.DeviceLoader`)
is iterated as it is.  Under a mesh each host batch is cut to this rank's
rows (``parallel.shard_batch``, by its data index) before its copy; a
device-resident loader must have been parked under the same mesh.
"""

from __future__ import annotations

import collections
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from fairmultimodal_torch.ops.gates import resolve_device
from fairmultimodal_torch.parallel.sharding import shard_batch

__all__ = ["to_device", "prefetch_to_device", "PrefetchLoader"]


def to_device(batch: Any, device: torch.device) -> Any:
    """Nested dict of arrays -> the same dict of tensors on ``device``."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    t = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(batch))
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def prefetch_to_device(iterable: Iterable, size: int = 2, device=None) -> Iterator:
    """Yield the batches of ``iterable`` on ``device`` (``None`` means CUDA
    and raises without it), keeping ``size`` copies in flight (the JAX
    function's; its ``sharding`` is a device here)."""
    device = resolve_device(device)
    queue: collections.deque = collections.deque()
    it = iter(iterable)

    def enqueue(n):
        for _ in range(n):
            try:
                queue.append(to_device(next(it), device))
            except StopIteration:
                return

    enqueue(size)
    while queue:
        yield queue.popleft()
        enqueue(1)


class PrefetchLoader:
    """Re-iterable wrapper: each ``iter()`` is a fresh pass over ``loader``
    with the next batch's copy already queued when a batch is handed out;
    with a ``mesh``, of this rank's rows of each batch."""

    def __init__(self, loader, device: torch.device, mesh=None):
        self.loader = loader
        self.device = torch.device(device)
        self.mesh = mesh

    def __len__(self) -> int:
        return len(self.loader)

    def _put(self, batch):
        if self.mesh is not None:
            batch = shard_batch(batch, self.mesh)
        return to_device(batch, self.device)

    def __iter__(self) -> Iterator[Any]:
        if getattr(self.loader, "device_resident", False):
            # Its batches are on the device already, sharded by the mesh it
            # was parked under: a trainer of another mesh would train on the
            # wrong rows.
            if getattr(self.loader, "mesh", None) is not self.mesh:
                raise ValueError(
                    "device-resident loader was built without the trainer's mesh; pass "
                    "mesh=... when constructing DeviceLoader (e.g. "
                    "prepare_experiment(..., mesh=mesh))")
            yield from self.loader
            return
        it = iter(self.loader)
        try:
            nxt = self._put(next(it))
        except StopIteration:
            return
        for batch in it:
            cur, nxt = nxt, self._put(batch)
            yield cur
        yield nxt
