"""Differentiable L_EDDI loss (port of ``fairmultimodal_tpu/fairness/loss.py:31-105``).

Reference semantics (``10_FAME.py:423-442``): for every task and every
sensitive attribute, with soft error ``|p - y|``, the RMSE over the subgroups
PRESENT in the batch of (subgroup mean error - overall mean error), with
``1e-8`` inside the sqrt; the loss is the mean of the 3 x 3 RMSE values.
The subgroup reduction is a one-hot segment sum over the static code space
with a presence mask, so nothing leaves the device; a ``weight`` mask drops
padded rows from every count and sum.

Given a data-parallel process ``group`` (``axis_name`` in JAX), the per-group
counts and error sums and the overall error sum and count are summed over the
ranks before the nonlinearity, in one all-reduce for the whole loss
(:func:`~fairmultimodal_torch.parallel.global_sum`), so every rank gets the
global loss and the gradients summed over the ranks are its gradient.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from fairmultimodal_torch.parallel.sharding import global_sum

__all__ = ["subgroup_soft_errors", "eddi_loss"]

_Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _local_stats(probs: torch.Tensor, labels: torch.Tensor, group_ids: torch.Tensor,
                 num_groups: int, weight: Optional[torch.Tensor]) -> _Stats:
    """(counts [G], error sums [G], total error, total count) of this
    process's rows for one task and attribute."""
    err = (probs - labels).abs()
    groups = torch.arange(num_groups, device=group_ids.device)
    onehot = (group_ids.long()[:, None] == groups[None, :]).to(probs.dtype)
    if weight is not None:
        w = weight.to(probs.dtype)
        onehot = onehot * w[:, None]
        err = err * w
        total_n = w.sum()
    else:
        total_n = torch.tensor(float(err.shape[0]), dtype=probs.dtype, device=probs.device)
    return onehot.sum(dim=0), err @ onehot, err.sum(), total_n


def _global_stats(stats: List[_Stats], group) -> List[_Stats]:
    """Every statistic summed over ``group``'s ranks in one all-reduce."""
    flat = global_sum(torch.cat([torch.cat([c, s, te[None], tn[None]])
                                 for c, s, te, tn in stats]), group)
    out, start = [], 0
    for counts, *_ in stats:
        g = counts.numel()
        part = flat[start:start + 2 * g + 2]
        out.append((part[:g], part[g:2 * g], part[2 * g], part[2 * g + 1]))
        start += 2 * g + 2
    return out


def _soft_errors(stats: _Stats):
    counts, sums, total_err, total_n = stats
    return sums / torch.clamp(counts, min=1.0), counts > 0, total_err / total_n


def subgroup_soft_errors(probs: torch.Tensor, labels: torch.Tensor, group_ids: torch.Tensor,
                         num_groups: int, weight: Optional[torch.Tensor] = None):
    """Per-subgroup mean soft error for one task: returns (sub_err [G],
    present [G] bool, overall scalar)."""
    return _soft_errors(_local_stats(probs, labels, group_ids, num_groups, weight))


def eddi_loss(probs: torch.Tensor, labels: torch.Tensor, sensitive: Sequence[torch.Tensor],
              group_sizes: Sequence[int], weight: Optional[torch.Tensor] = None,
              group=None) -> torch.Tensor:
    """L_EDDI over probs / labels [B, T] and one [B] code array per sensitive
    attribute (reference order: age, ethnicity, insurance), over every rank's
    rows given a process ``group``."""
    labels = labels.to(probs.dtype)
    stats = [_local_stats(probs[:, i], labels[:, i], sens, g, weight)
             for i in range(probs.shape[1]) for sens, g in zip(sensitive, group_sizes)]
    if group is not None:
        stats = _global_stats(stats, group)
    rmses = []
    for s in stats:
        sub_err, present, overall = _soft_errors(s)
        diffs = torch.where(present, (sub_err - overall) ** 2, torch.zeros_like(sub_err))
        n_present = torch.clamp(present.to(probs.dtype).sum(), min=1.0)
        rmses.append(torch.sqrt(diffs.sum() / n_present + 1e-8))
    return torch.stack(rmses).mean()
