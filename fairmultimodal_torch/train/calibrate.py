"""Decision-threshold calibration by F1 grid search (the port's own copy of
``fairmultimodal_tpu/train/calibrate.py``, numpy only).

Reference (``10_FAME.py:451-482``): per task, scan 101 thresholds in
[0, 1], keep the first threshold achieving the best F1 on the validation
set (strict ``>`` comparison keeps the earliest maximum; default 0.5 when
no threshold beats F1=0).

Vectorized: the whole [T_thresholds x N] prediction grid is one broadcast;
per-threshold TP/FP/FN are matmul-free sums.  Runs in numpy on the host —
calibration consumes logits already pulled for evaluation.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

__all__ = ["calibrate_thresholds", "f1_grid"]


def f1_grid(probs: np.ndarray, labels: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """F1 at each threshold. probs/labels [N], grid [T]. Returns [T]."""
    preds = probs[None, :] > grid[:, None]          # [T, N]
    y = labels[None, :].astype(bool)
    tp = np.sum(preds & y, axis=1).astype(np.float64)
    fp = np.sum(preds & ~y, axis=1).astype(np.float64)
    fn = np.sum(~preds & y, axis=1).astype(np.float64)
    denom = 2 * tp + fp + fn
    with np.errstate(invalid="ignore", divide="ignore"):
        f1 = np.where(denom > 0, 2 * tp / denom, 0.0)
    return f1


def calibrate_thresholds(
    probs: np.ndarray,
    labels: np.ndarray,
    task_names: Sequence[str] = ("mortality", "los", "mechanical_ventilation"),
    num_points: int = 101,
) -> Dict[str, float]:
    """Per-task best-F1 thresholds, reference tie-breaking.

    Args:
      probs: [N, T] sigmoid probabilities.
      labels: [N, T] binary labels.
    """
    grid = np.linspace(0, 1, num_points)
    out = {}
    for i, name in enumerate(task_names):
        f1 = f1_grid(probs[:, i], labels[:, i], grid)
        best = float(np.max(f1))
        if best <= 0.0:
            out[name] = 0.5  # reference keeps the 0.5 default (10_FAME:473-480)
        else:
            out[name] = float(grid[int(np.argmax(f1))])
    return out
