"""EDDI (Error-Distribution Disparity Index), the port's own copy of
``fairmultimodal_tpu/fairness/eddi.py`` (numpy; the trainer's dynamic-weight
update needs it, and the port imports nothing of the JAX package).

Per sensitive subgroup ``s``: ``d_s = (err_s - err) / max(err, 1 - err)``
(1.0 at the 0/1 endpoints), ``EDDI = sqrt(sum_s d_s^2) / n_groups``, with
the reference's variants (``complete_groups``, ``divisor``,
``empty_group_value``, ``prebinarized``) kept.  :func:`subgroup_error_stats`
gives per-group (count, errors) with one-hot segment sums on the device and
:func:`eddi_from_stats` turns them into the same EDDI on the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "compute_eddi",
    "combined_eddi",
    "subgroup_error_stats",
    "eddi_from_stats",
]


def _normalizer(overall_error: float) -> float:
    """Shared EDDI normalizer: max(err, 1-err); 1.0 at the 0/1 endpoints."""
    return max(overall_error, 1.0 - overall_error) if overall_error not in (0.0, 1.0) else 1.0


def compute_eddi(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    sensitive_labels: np.ndarray,
    threshold: float = 0.5,
    complete_groups: Optional[Sequence] = None,
    divisor: str = "valid",
    empty_group_value: Optional[float] = None,
    prebinarized: bool = False,
) -> Tuple[float, Dict]:
    """EDDI for one sensitive attribute.

    Args:
      y_true: [N] binary ground truth.
      y_pred: [N] probabilities (or hard predictions when ``prebinarized``).
      sensitive_labels: [N] subgroup codes (ints or strings).
      threshold: binarization threshold (reference uses ``>``, strict).
      complete_groups: full code space to iterate (fame variant); ``None``
        uses ``np.unique(sensitive_labels)``.
      divisor: "valid" divides by the number of non-empty groups
        (``10_FAME.py:77-78``); "total" divides by the number of iterated
        groups (``01_BEHRT.py:98``).
      empty_group_value: value recorded for empty groups ("behrt" uses NaN,
        "fame" skips them — ``None`` skips).
      prebinarized: y_pred already holds hard 0/1 predictions (09 variant).

    Returns:
      (overall_eddi, {group: disparity}) matching the reference outputs.
    """
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    sensitive_labels = np.asarray(sensitive_labels)
    y_bin = y_pred.astype(int) if prebinarized else (y_pred > threshold).astype(int)

    groups = np.array(complete_groups) if complete_groups is not None else np.unique(sensitive_labels)

    overall_error = float(np.mean(y_bin != y_true))
    denom = _normalizer(overall_error)

    subgroup: Dict = {}
    valid = 0
    for group in groups:
        mask = sensitive_labels == group
        if not np.any(mask):
            if empty_group_value is not None:
                subgroup[group] = empty_group_value
            continue
        valid += 1
        er_group = float(np.mean(y_bin[mask] != y_true[mask]))
        subgroup[group] = (er_group - overall_error) / denom

    n = valid if divisor == "valid" else len(groups)
    if n > 0:
        overall = float(np.sqrt(np.nansum(np.square(list(subgroup.values())))) / n)
    else:
        overall = 0.0
    return overall, subgroup


def combined_eddi(*attribute_eddis: float) -> float:
    """Combined EDDI over sensitive attributes: sqrt(sum e_a^2)/n_attrs.

    Reference: ``10_FAME.py:363,901`` and ``01_BEHRT.py:101-102`` (both use
    exactly three attributes: age, ethnicity, insurance).
    """
    arr = np.asarray(attribute_eddis, dtype=np.float64)
    return float(np.sqrt(np.sum(arr**2)) / len(arr))


# ---------------------------------------------------------------------------
# Device-side sufficient statistics.
# ---------------------------------------------------------------------------

def subgroup_error_stats(y_true: torch.Tensor, y_bin: torch.Tensor, group_ids: torch.Tensor,
                         num_groups: int, weight: Optional[torch.Tensor] = None):
    """Per-group (count, error-count) [G] fp32 via a one-hot segment sum;
    ``weight`` [B] masks padded rows.  Exact small-integer sums."""
    groups = torch.arange(num_groups, device=group_ids.device)
    onehot = (group_ids.long()[:, None] == groups[None, :]).to(torch.float32)
    if weight is not None:
        onehot = onehot * weight.to(torch.float32)[:, None]
    err = (y_bin != y_true).to(torch.float32)
    return onehot.sum(dim=0), err @ onehot


def eddi_from_stats(
    counts: np.ndarray,
    errors: np.ndarray,
    divisor: str = "valid",
) -> float:
    """Overall EDDI from per-group (count, error) sufficient statistics.

    Exactly reproduces ``compute_eddi`` with ``complete_groups=range(G)``:
    groups with zero samples are skipped and (by default) the divisor is the
    number of non-empty groups (``10_FAME.py:67-78``).
    """
    counts = np.asarray(counts, dtype=np.float64)
    errors = np.asarray(errors, dtype=np.float64)
    total = counts.sum()
    if total == 0:
        return 0.0
    overall_error = float(errors.sum() / total)
    denom = _normalizer(overall_error)
    present = counts > 0
    er_group = np.zeros_like(counts)
    er_group[present] = errors[present] / counts[present]
    d = (er_group[present] - overall_error) / denom
    n = int(present.sum()) if divisor == "valid" else len(counts)
    if n == 0:
        return 0.0
    return float(np.sqrt(np.sum(d**2)) / n)
