"""Losses (port of ``fairmultimodal_tpu/ops/losses.py:24-101``).

- :func:`bce_with_logits`: log-sum-exp stable BCE with an optional per-task
  ``pos_weight`` (torch ``BCEWithLogitsLoss``) and a per-sample ``weight``
  mask whose sum is the mean's denominator, so the zero-padded tail of a
  fixed-shape batch changes nothing.
- :func:`focal_loss`: ``(1 - exp(-BCE))^gamma * BCE``, with p_t taken from the
  *weighted* BCE when ``pos_weight`` is set, as the reference writes it.

Given a data-parallel process ``group`` (``axis_name`` in JAX), the BCE's
mean sums numerator and denominator over the ranks
(:func:`~fairmultimodal_torch.parallel.global_sum`): every rank gets the
global masked mean, and the gradients summed over the ranks are its gradient.

Both compute in at least fp32 (bf16 logits give an fp32 loss, f64 stays f64).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from fairmultimodal_torch.parallel.sharding import global_sum

__all__ = ["bce_with_logits", "focal_loss", "sigmoid"]

#: The logistic function (the JAX module exports ``jax.nn.sigmoid``).
sigmoid = torch.sigmoid


def _weighted_mean(loss: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    w = weight.reshape(weight.shape + (1,) * (loss.dim() - weight.dim())).to(loss.dtype)
    loss = loss * w
    denom = torch.clamp(w.sum() * (loss.numel() / w.numel()), min=1.0)
    return loss.sum() / denom


def _global_mean(loss: torch.Tensor, weight: Optional[torch.Tensor], group) -> torch.Tensor:
    """The mean over every rank's rows: numerator and denominator summed
    over ``group`` in one all-reduce."""
    if weight is None:
        count = torch.tensor(float(loss.numel()), dtype=loss.dtype, device=loss.device)
    else:
        w = weight.reshape(weight.shape + (1,) * (loss.dim() - weight.dim())).to(loss.dtype)
        loss = loss * w
        count = w.sum() * (loss.numel() / w.numel())
    num, den = global_sum(torch.stack([loss.sum(), count]), group).unbind()
    return num / (den if weight is None else torch.clamp(den, min=1.0))


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    pos_weight: Optional[torch.Tensor] = None,
                    weight: Optional[torch.Tensor] = None,
                    reduction: str = "mean", group=None) -> torch.Tensor:
    """``l = -[pw * y * log sigmoid(x) + (1 - y) * log(1 - sigmoid(x))]`` with
    ``log sigmoid(x) = -softplus(-x)``; ``weight`` [B] masks rows.  With a
    process ``group`` the ``"mean"`` and ``"sum"`` reductions run over every
    rank's rows."""
    acc = torch.promote_types(logits.dtype, torch.float32)
    logits, labels = logits.to(acc), labels.to(acc)
    sp = F.softplus(-logits)
    pos = labels * -sp
    if pos_weight is not None:
        pos = pos_weight.to(acc) * pos
    loss = -(pos + (1.0 - labels) * (-logits - sp))
    if group is not None and reduction == "mean":
        return _global_mean(loss, weight, group)
    if weight is not None and reduction == "mean":
        return _weighted_mean(loss, weight)
    if weight is not None:
        loss = loss * weight.reshape(weight.shape + (1,) * (loss.dim() - weight.dim())).to(acc)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum() if group is None else global_sum(loss.sum(), group)
    return loss


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
               alpha: Optional[float] = None, pos_weight: Optional[torch.Tensor] = None,
               weight: Optional[torch.Tensor] = None, reduction: str = "mean") -> torch.Tensor:
    """Reference FocalLoss (02_BioClinicalBERT.py:18-39)."""
    bce = bce_with_logits(logits, labels, pos_weight=pos_weight, reduction="none")
    loss = (1.0 - torch.exp(-bce)) ** gamma * bce
    if alpha is not None:
        loss = alpha * loss
    if weight is not None and reduction == "mean":
        return _weighted_mean(loss, weight)
    if weight is not None:
        loss = loss * weight.reshape(weight.shape + (1,) * (loss.dim() - weight.dim())).to(loss.dtype)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss
