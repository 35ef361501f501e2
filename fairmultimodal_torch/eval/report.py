"""Evaluation metrics and reference-format reports (port of
``fairmultimodal_tpu/eval/report.py``; the scikit-learn metrics it calls come
from :mod:`fairmultimodal_torch.eval.metrics`, numpy with scikit-learn 1.9's
conventions, since the card's machine has no scikit-learn).

``evaluate_multitask`` mirrors ``evaluate_model_multi`` (10_FAME.py:484-552):
per task — AUROC, AUPRC, F1, recall, precision, TPR, FPR at the calibrated
threshold — plus per-attribute Equalized-Odds blocks and the final subgroup
EDDI statistics (10_FAME.py:887-915).  Print output matches the reference's
committed ``.log`` files line-shape so runs diff cleanly.

AUPRC convention differs across reference scripts: 10_FAME uses
``average_precision_score`` while 01_BEHRT integrates the PR curve
(``auc(recall, precision)``); both are provided via ``auprc_mode``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
from fairmultimodal_torch import (
    AGE_BUCKET_LABELS,
    ETHNICITY_LABELS,
    EXPECTED_AGE_CODES,
    EXPECTED_ETHNICITY_CODES,
    EXPECTED_INSURANCE_CODES,
    INSURANCE_LABELS,
    TASKS,
)
from fairmultimodal_torch.eval.metrics import (
    auc,
    average_precision_score,
    f1_score,
    precision_recall_curve,
    precision_score,
    recall_score,
    roc_auc_score,
)
from fairmultimodal_torch.fairness.eddi import combined_eddi, compute_eddi
from fairmultimodal_torch.fairness.eo import equalized_odds

__all__ = ["task_metrics", "evaluate_multitask", "eddi_report"]

_COMPLETE = {
    "age": EXPECTED_AGE_CODES,
    "ethnicity": EXPECTED_ETHNICITY_CODES,
    "insurance": EXPECTED_INSURANCE_CODES,
}
_LABELS = {
    "age": AGE_BUCKET_LABELS,
    "ethnicity": ETHNICITY_LABELS,
    "insurance": INSURANCE_LABELS,
}


def _named(attr: str, subgroups: Dict) -> Dict:
    """Map integer subgroup codes to the reference's printed names
    (02_BioClinicalBERT.py:255-278 fixed subgroup orders); non-integer or
    out-of-range keys pass through unchanged."""
    names = _LABELS.get(attr)
    if names is None:
        return subgroups
    out = {}
    for k, v in subgroups.items():
        try:
            out[names[int(k)] if 0 <= int(k) < len(names) else k] = v
        except (TypeError, ValueError):
            out[k] = v
    return out


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def task_metrics(probs: np.ndarray, labels: np.ndarray, threshold: float,
                 auprc_mode: str = "ap") -> Dict[str, float]:
    """Single-task metric block (10_FAME.py:514-540 conventions)."""
    preds = (probs > threshold).astype(int)
    try:
        aucroc = float(roc_auc_score(labels, probs))
    except ValueError:
        aucroc = float("nan")
    try:
        if auprc_mode == "ap":
            auprc = float(average_precision_score(labels, probs))
        else:  # PR-curve integration (01_BEHRT.py:278-279)
            p, r, _ = precision_recall_curve(labels, probs)
            auprc = float(auc(r, p))
    except ValueError:
        auprc = float("nan")
    f1 = float(f1_score(labels, preds, zero_division=0))
    rec = float(recall_score(labels, preds, zero_division=0))
    prec = float(precision_score(labels, preds, zero_division=0))
    tp = int(np.sum((labels == 1) & (preds == 1)))
    fn = int(np.sum((labels == 1) & (preds == 0)))
    fp = int(np.sum((labels == 0) & (preds == 1)))
    tn = int(np.sum((labels == 0) & (preds == 0)))
    tpr = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    fpr = fp / (fp + tn) if (fp + tn) > 0 else 0.0
    return {"aucroc": aucroc, "auprc": auprc, "f1": f1, "recall (TPR)": rec,
            "TPR": tpr, "precision": prec, "fpr": fpr,
            "optimal_threshold": threshold}


def evaluate_multitask(
    logits: np.ndarray,
    labels: np.ndarray,
    sensitive: Dict[str, np.ndarray],
    thresholds,
    task_names: Sequence[str] = TASKS,
    verbose: bool = True,
    auprc_mode: str = "ap",
):
    """Full test-set evaluation: per-task metrics + EO fairness blocks.

    Args:
      logits: [N, T]; labels: [N, T];
      sensitive: {"age"/"ethnicity"/"insurance": [N] codes};
      thresholds: dict per task or scalar.
    Returns (metrics, fairness_details).
    """
    metrics = {}
    fairness: Dict[str, Dict] = {}
    for i, task in enumerate(task_names):
        thr = thresholds[task] if isinstance(thresholds, dict) else float(thresholds)
        probs = _sigmoid(logits[:, i])
        y = labels[:, i]
        metrics[task] = task_metrics(probs, y, thr, auprc_mode=auprc_mode)
        preds = (probs > thr).astype(int)
        fairness[task] = {}
        if verbose:
            print(f"\nOutcome: {task} (Threshold: {thr:.2f})")
        eo_list = []
        for attr, values in sensitive.items():
            eo = equalized_odds(y, preds, values)
            fairness[task][attr] = {"avg_tpr_diff": eo["EOTPR"],
                                    "avg_fpr_diff": eo["EOFPR"],
                                    "eo_metric": eo["EO"]}
            eo_list.append(eo["EO"])
            if verbose:
                print(f"Fairness metrics for sensitive attribute: {attr}")
                for g in sorted(eo["group_tpr"]):
                    print(f"  Group {g}: TPR = {eo['group_tpr'][g]:.3f}, "
                          f"FPR = {eo['group_fpr'][g]:.3f}")
                print(f"  Average TPR difference across groups: {eo['EOTPR']:.3f}")
                print(f"  Average FPR difference across groups: {eo['EOFPR']:.3f}")
                print(f"  EO fairness metric (average of TPR and FPR differences): "
                      f"{eo['EO']:.3f}\n")
        overall_eo = float(np.mean(eo_list)) if eo_list else 0.0
        fairness[task]["overall_eo"] = overall_eo
        if verbose:
            print(f"Overall EO fairness metric for outcome {task}: {overall_eo:.3f}")
    return metrics, fairness


def eddi_report(
    logits: np.ndarray,
    labels: np.ndarray,
    sensitive: Dict[str, np.ndarray],
    thresholds,
    task_names: Sequence[str] = TASKS,
    verbose: bool = True,
) -> Dict[str, Dict]:
    """Final subgroup EDDI statistics block (10_FAME.py:887-915)."""
    out: Dict[str, Dict] = {}
    combined_per_task = {}
    if verbose:
        print("\n--- Sensitive Subgroup EDDI Statistics ---")
    for i, task in enumerate(task_names):
        thr = thresholds[task] if isinstance(thresholds, dict) else float(thresholds)
        probs = _sigmoid(logits[:, i])
        y = labels[:, i]
        attr_eddi = {}
        subgroups = {}
        for attr, values in sensitive.items():
            e, sub = compute_eddi(y, probs, np.asarray(values), threshold=thr,
                                  complete_groups=_COMPLETE.get(attr))
            attr_eddi[attr] = e
            subgroups[attr] = sub
        combined = combined_eddi(*attr_eddi.values())
        combined_per_task[task] = combined
        out[task] = {"attribute_eddi": attr_eddi, "subgroups": subgroups,
                     "combined_eddi": combined}
        if verbose:
            print(f"\nOutcome: {task} (Threshold: {thr:.2f})")
            for attr in sensitive:
                print(f" {attr.capitalize()} EDDI:")
                print("  Overall:", attr_eddi[attr])
                print("  Subgroups:", _named(attr, subgroups[attr]))
            print(" Combined EDDI:", combined)
    overall = float(np.mean(list(combined_per_task.values())))
    out["overall_combined_eddi"] = overall
    if verbose:
        print("\n--- Overall Combined EDDI across outcomes ---")
        print("Overall Combined EDDI:", overall)
    return out
