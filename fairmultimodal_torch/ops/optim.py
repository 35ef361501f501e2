"""Optimizer of the FAME train step (port of ``fairmultimodal_tpu/ops/optim.py``).

The reference clips with ``torch.nn.utils.clip_grad_norm_(params, max_norm)``
-- every gradient times ``min(max_norm / (norm + 1e-6), 1)``, the
``+1e-6`` that the JAX package re-implements as ``clip_by_global_norm_torch``
-- and steps ``torch.optim.AdamW(weight_decay=0.01)``.  Here both are
torch's own.

The modality classifier heads (``classifier_demo/lab/text``) are outside the
loss graph (``train/loop.py:49-50`` in the JAX package): the reference's
AdamW skips them because their ``.grad`` stays None, so they get neither an
update nor weight decay.  :func:`make_adamw` leaves them out of the
optimizer altogether, and the trainer zeroes gradients with
``set_to_none=True`` (zero tensors would let AdamW decay a parameter).

``fused_clip_adamw_apply`` (JAX, opt-in, a measured negative result) is not
ported.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

__all__ = ["LOSS_FREE_HEADS", "trainable_parameters", "make_adamw"]

LOSS_FREE_HEADS = frozenset({"classifier_demo", "classifier_lab", "classifier_text"})


def _is_loss_free(name: str) -> bool:
    return any(part in LOSS_FREE_HEADS for part in name.split("."))


def trainable_parameters(model: nn.Module) -> List[nn.Parameter]:
    """Every parameter but the loss-free heads', in ``named_parameters`` order."""
    return [p for n, p in model.named_parameters() if not _is_loss_free(n)]


def make_adamw(model: nn.Module, lr: float, weight_decay: float = 0.01) -> torch.optim.AdamW:
    return torch.optim.AdamW(trainable_parameters(model), lr=lr, weight_decay=weight_decay)
