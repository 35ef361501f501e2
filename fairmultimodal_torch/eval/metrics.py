"""Binary classification metrics in numpy, with scikit-learn 1.9's conventions.

The JAX package's report (``fairmultimodal_tpu/eval/report.py``) calls
``sklearn.metrics``; the card's machine has no scikit-learn, so the port
computes the same numbers here.  Only the binary case with 0/1 labels and no
sample weights is supported, which is all the report asks for.

Conventions kept from scikit-learn 1.9:

- the curves group tied scores: thresholds are the distinct scores in
  decreasing order (a stable descending sort), and true / false positives
  are cumulative float64 counts at the last index of each tie group;
- :func:`roc_curve` drops collinear points (``drop_intermediate``) and starts
  at (0, 0); :func:`roc_auc_score` is its trapezoidal area and returns NaN,
  with a warning, when ``y_true`` holds one class;
- :func:`average_precision_score` is the step sum sum_n (R_n - R_{n-1}) P_n,
  clipped at 0; with no positive label the recall is 1 everywhere and the
  score is 0.0;
- :func:`auc` is trapezoidal, needs two points, and accepts ``x`` monotone in
  either direction;
- :func:`precision_score`, :func:`recall_score` and :func:`f1_score` divide
  float64 counts and give ``zero_division`` where the denominator is 0; F1
  is 2 tp / (2 tp + fp + fn).
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np

__all__ = ["roc_curve", "roc_auc_score", "precision_recall_curve",
           "average_precision_score", "auc", "precision_score", "recall_score",
           "f1_score"]


def _binary_inputs(y_true, y_score) -> Tuple[np.ndarray, np.ndarray]:
    y_true = np.asarray(y_true).ravel()
    y_score = np.asarray(y_score).ravel()
    if len(y_true) != len(y_score):
        raise ValueError(f"inconsistent lengths {len(y_true)} and {len(y_score)}")
    if not np.isfinite(y_score).all():
        raise ValueError("y_score contains NaN or infinity")
    if not np.isin(y_true, (0, 1)).all():
        raise ValueError("y_true must hold 0/1 labels")
    return y_true, y_score


def _clf_curve(y_true, y_score):
    """(fps, tps, thresholds) at each distinct score, highest first."""
    y_true, y_score = _binary_inputs(y_true, y_score)
    order = np.argsort(-y_score, kind="stable")
    y_score = y_score[order]
    y_true = (y_true[order] == 1).astype(np.float64)
    idx = np.r_[np.nonzero(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def roc_curve(y_true, y_score):
    """(fpr, tpr, thresholds) with collinear points dropped."""
    fps, tps, thr = _clf_curve(y_true, y_score)
    if len(fps) > 2:
        keep = np.nonzero(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                                True])[0]
        fps, tps, thr = fps[keep], tps[keep], thr[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thr = np.r_[np.inf, thr.astype(np.float64)]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thr


def roc_auc_score(y_true, y_score) -> float:
    """Area under the ROC curve; NaN (with a warning) for one class."""
    y_true, y_score = _binary_inputs(y_true, y_score)
    if len(np.unique(y_true)) != 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score is not "
                      "defined in that case.", RuntimeWarning, stacklevel=2)
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return auc(fpr, tpr)


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds), recall decreasing, ending at (1, 0)."""
    fps, tps, thr = _clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], thr[::-1]


def average_precision_score(y_true, y_score) -> float:
    """Step-sum average precision sum_n (R_n - R_{n-1}) P_n."""
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def auc(x, y) -> float:
    """Trapezoidal area under (x, y); ``x`` increasing or decreasing."""
    x = np.asarray(x).ravel()
    y = np.asarray(y).ravel()
    if len(x) != len(y):
        raise ValueError(f"inconsistent lengths {len(x)} and {len(y)}")
    if x.shape[0] < 2:
        raise ValueError("At least 2 points are needed to compute area under curve, "
                         f"but x.shape = {x.shape[0]}")
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
        direction = -1
    # numpy's trapezoid rule, written out (numpy 1.x names it trapz).
    return float(direction * np.add.reduce(dx * (y[1:] + y[:-1]) / 2.0))


def _counts(y_true, y_pred) -> Tuple[float, float, float]:
    """(tp, fp, fn) of the positive class 1, as float64."""
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    if len(y_true) != len(y_pred):
        raise ValueError(f"inconsistent lengths {len(y_true)} and {len(y_pred)}")
    t, p = y_true == 1, y_pred == 1
    return float(np.sum(t & p)), float(np.sum(~t & p)), float(np.sum(t & ~p))


def _divide(num: float, den: float, zero_division: float) -> float:
    return float(zero_division) if den == 0 else num / den


def precision_score(y_true, y_pred, zero_division: float = 0.0) -> float:
    tp, fp, _ = _counts(y_true, y_pred)
    return _divide(tp, tp + fp, zero_division)


def recall_score(y_true, y_pred, zero_division: float = 0.0) -> float:
    tp, _, fn = _counts(y_true, y_pred)
    return _divide(tp, tp + fn, zero_division)


def f1_score(y_true, y_pred, zero_division: float = 0.0) -> float:
    tp, fp, fn = _counts(y_true, y_pred)
    return _divide(2.0 * tp, 2.0 * tp + fp + fn, zero_division)
