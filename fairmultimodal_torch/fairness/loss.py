"""Differentiable L_EDDI loss (port of ``fairmultimodal_tpu/fairness/loss.py:31-105``).

Reference semantics (``10_FAME.py:423-442``): for every task and every
sensitive attribute, with soft error ``|p - y|``, the RMSE over the subgroups
PRESENT in the batch of (subgroup mean error - overall mean error), with
``1e-8`` inside the sqrt; the loss is the mean of the 3 x 3 RMSE values.
The subgroup reduction is a one-hot segment sum over the static code space
with a presence mask, so nothing leaves the device; a ``weight`` mask drops
padded rows from every count and sum.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["subgroup_soft_errors", "eddi_loss"]


def subgroup_soft_errors(probs: torch.Tensor, labels: torch.Tensor, group_ids: torch.Tensor,
                         num_groups: int, weight: Optional[torch.Tensor] = None):
    """Per-subgroup mean soft error for one task: returns (sub_err [G],
    present [G] bool, overall scalar)."""
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
    counts = onehot.sum(dim=0)
    sums = err @ onehot
    present = counts > 0
    return sums / torch.clamp(counts, min=1.0), present, err.sum() / total_n


def eddi_loss(probs: torch.Tensor, labels: torch.Tensor, sensitive: Sequence[torch.Tensor],
              group_sizes: Sequence[int], weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L_EDDI over probs / labels [B, T] and one [B] code array per sensitive
    attribute (reference order: age, ethnicity, insurance)."""
    labels = labels.to(probs.dtype)
    rmses = []
    for i in range(probs.shape[1]):
        for sens, g in zip(sensitive, group_sizes):
            sub_err, present, overall = subgroup_soft_errors(probs[:, i], labels[:, i], sens,
                                                             g, weight)
            diffs = torch.where(present, (sub_err - overall) ** 2, torch.zeros_like(sub_err))
            n_present = torch.clamp(present.to(probs.dtype).sum(), min=1.0)
            rmses.append(torch.sqrt(diffs.sum() / n_present + 1e-8))
    return torch.stack(rmses).mean()
