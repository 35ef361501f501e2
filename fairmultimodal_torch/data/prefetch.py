"""Host -> device batch prefetching (port of ``fairmultimodal_tpu/data/prefetch.py``).

Each (nested) numpy batch is copied to the device one batch ahead of its
use: the arrays are staged in pinned host memory and copied with
``non_blocking=True``, so the copy of batch N+1 overlaps the card computing
step N.  Tensors already on the device pass through unchanged, and a loader
marked ``device_resident`` (:class:`~fairmultimodal_torch.data.device.DeviceLoader`)
is iterated as it is.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch

__all__ = ["to_device", "PrefetchLoader"]


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


class PrefetchLoader:
    """Re-iterable wrapper: each ``iter()`` is a fresh pass over ``loader``
    with the next batch's copy already queued when a batch is handed out."""

    def __init__(self, loader, device: torch.device):
        self.loader = loader
        self.device = torch.device(device)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[Any]:
        if getattr(self.loader, "device_resident", False):
            yield from self.loader
            return
        it = iter(self.loader)
        try:
            nxt = to_device(next(it), self.device)
        except StopIteration:
            return
        for batch in it:
            cur, nxt = nxt, to_device(batch, self.device)
            yield cur
        yield nxt
