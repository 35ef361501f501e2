"""Equalized-Odds style fairness metrics (the port's own copy of
``fairmultimodal_tpu/fairness/eo.py``, numpy only).

The reference computes, per subgroup, TPR and FPR, then aggregates absolute
pairwise differences.  Two aggregation conventions exist:

- "pairs"  (``10_FAME.py:99-122``): mean over the C(n,2) pairs, then
  EO = (avg |dTPR| + avg |dFPR|) / 2.
- "n2"     (``01_BEHRT.py:27-42``): *sums* of pairwise diffs divided by n^2
  (not the pair count), then the same average of the two terms.

``09_multimodal_sigmoid_fusion.py:29-45`` names the "pairs" variant
"equalized opportunity"; it is numerically the same aggregation.

TPR/FPR per group are plain confusion-matrix ratios with a 0.0 convention for
empty denominators (``10_FAME.py:84-97``).  The confusion-matrix label order
([1,0] vs [0,1]) only affects how TP/FN/FP/TN are *unpacked* in the reference
and not the resulting TPR/FPR, so a single implementation covers all scripts.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["tpr_fpr", "equalized_odds", "equalized_odds_pairwise", "group_tpr_fpr"]


def tpr_fpr(y_true: np.ndarray, y_pred: np.ndarray) -> Tuple[float, float]:
    """TPR and FPR with 0.0 for empty denominators (10_FAME.py:84-97)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    tp = int(np.sum((y_true == 1) & (y_pred == 1)))
    fn = int(np.sum((y_true == 1) & (y_pred == 0)))
    fp = int(np.sum((y_true == 0) & (y_pred == 1)))
    tn = int(np.sum((y_true == 0) & (y_pred == 0)))
    tpr = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    fpr = fp / (fp + tn) if (fp + tn) > 0 else 0.0
    return tpr, fpr


def group_tpr_fpr(
    y_true: np.ndarray, y_pred: np.ndarray, sensitive: np.ndarray
) -> Tuple[Dict, Dict]:
    """Per-subgroup TPR/FPR dicts keyed by group value."""
    sensitive = np.asarray(sensitive)
    tprs: Dict = {}
    fprs: Dict = {}
    for group in np.unique(sensitive):
        mask = sensitive == group
        t, f = tpr_fpr(np.asarray(y_true)[mask], np.asarray(y_pred)[mask])
        tprs[group] = t
        fprs[group] = f
    return tprs, fprs


def equalized_odds_pairwise(tprs: Dict, fprs: Dict, aggregation: str = "pairs") -> Dict[str, float]:
    """Aggregate pairwise |TPR_i - TPR_j| and |FPR_i - FPR_j| gaps.

    aggregation:
      "pairs": divide by C(n,2)  (10_FAME.py:110-118 — np.mean over diffs).
      "n2":    divide by n**2    (01_BEHRT.py:39-40).
    """
    groups = list(tprs.keys())
    n = len(groups)
    if n == 0:
        return {"EOTPR": 0.0, "EOFPR": 0.0, "EO": 0.0}
    tpr_diffs = []
    fpr_diffs = []
    for i in range(n):
        for j in range(i + 1, n):
            tpr_diffs.append(abs(tprs[groups[i]] - tprs[groups[j]]))
            fpr_diffs.append(abs(fprs[groups[i]] - fprs[groups[j]]))
    if aggregation == "pairs":
        avg_t = float(np.mean(tpr_diffs)) if tpr_diffs else 0.0
        avg_f = float(np.mean(fpr_diffs)) if fpr_diffs else 0.0
    elif aggregation == "n2":
        avg_t = float(np.sum(tpr_diffs)) / (n**2)
        avg_f = float(np.sum(fpr_diffs)) / (n**2)
    else:
        raise ValueError(f"unknown aggregation {aggregation!r}")
    return {"EOTPR": avg_t, "EOFPR": avg_f, "EO": (avg_t + avg_f) / 2.0}


def equalized_odds(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    sensitive: np.ndarray,
    aggregation: str = "pairs",
) -> Dict[str, float]:
    """End-to-end EO metric for one sensitive attribute (hard predictions)."""
    tprs, fprs = group_tpr_fpr(y_true, y_pred, sensitive)
    out = equalized_odds_pairwise(tprs, fprs, aggregation=aggregation)
    out["group_tpr"] = tprs
    out["group_fpr"] = fprs
    return out
