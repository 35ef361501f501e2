"""The port's evaluation tail against scikit-learn 1.9 and the JAX package.

- ``eval/metrics.py`` (numpy; the card has no scikit-learn) against
  ``sklearn.metrics`` on scores with heavy ties, integer scores, one class,
  no predicted positives and N = 1: 1e-12, NaN where scikit-learn gives NaN,
  an error where it raises;
- ``evaluate_multitask`` / ``eddi_report`` / ``calibrate_thresholds`` /
  ``equalized_odds`` / ``compute_pos_weights`` / ``zscore`` against the JAX
  functions on the same inputs: the dicts equal to 1e-12 and the captured
  stdout identical line for line;
- the line patterns of ``tests/test_report_format.py`` on the port's output.
"""

import io
import math
import re
import warnings
from contextlib import redirect_stdout

import numpy as np
import pytest
import sklearn.metrics as skm

from fairmultimodal_torch.data import featurize as t_feat
from fairmultimodal_torch.eval import metrics as tm
from fairmultimodal_torch.eval import report as t_report
from fairmultimodal_torch.fairness import eo as t_eo
from fairmultimodal_torch.train import calibrate as t_cal
from fairmultimodal_tpu.data import featurize as j_feat
from fairmultimodal_tpu.eval import report as j_report
from fairmultimodal_tpu.fairness import eo as j_eo
from fairmultimodal_tpu.train import calibrate as j_cal

TOL = 1e-12


def _cases():
    rng = np.random.default_rng(0)
    out = {}
    y = (rng.random(400) < 0.3).astype(float)
    out["ties"] = (y, np.round(rng.random(400), 1))                 # 11 distinct scores
    out["integers"] = ((rng.random(200) < 0.5).astype(int), rng.integers(0, 5, 200))
    out["continuous"] = ((rng.random(300) < 0.1).astype(float), rng.random(300))
    out["one_class_neg"] = (np.zeros(50), rng.random(50))
    out["one_class_pos"] = (np.ones(50), np.round(rng.random(50), 2))
    out["all_tied"] = ((rng.random(30) < 0.5).astype(float), np.full(30, 0.5))
    out["n1_pos"] = (np.ones(1), np.array([0.3]))
    out["n1_neg"] = (np.zeros(1), np.array([0.3]))
    return out


CASES = _cases()


def _both(fn_t, fn_s, *args):
    """(port, sklearn) results, an exception's type standing for a result."""
    res = []
    for fn in (fn_t, fn_s):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                res.append(fn(*args))
            except ValueError:
                res.append(ValueError)
    return res


def _close(a, b):
    if a is ValueError or b is ValueError:
        return a is b
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and np.allclose(a, b, rtol=0, atol=TOL, equal_nan=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranking_metrics_match_sklearn(case):
    y, s = CASES[case]
    for fn_t, fn_s in ((tm.roc_auc_score, skm.roc_auc_score),
                       (tm.average_precision_score, skm.average_precision_score)):
        got, want = _both(fn_t, fn_s, y, s)
        assert _close(got, want), (fn_t.__name__, got, want)
    for fn_t, fn_s in ((tm.precision_recall_curve, skm.precision_recall_curve),
                       (tm.roc_curve, skm.roc_curve)):
        got, want = _both(fn_t, fn_s, y, s)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert _close(g, w), (fn_t.__name__, g, w)
    (p, r, _), _ = _both(tm.precision_recall_curve, skm.precision_recall_curve, y, s)
    assert _close(*_both(tm.auc, skm.auc, r, p))


def test_auc_directions_and_errors():
    x = np.array([0.0, 0.2, 0.5, 1.0])
    y = np.array([0.1, 0.4, 0.4, 0.9])
    for xx in (x, x[::-1]):
        assert _close(*_both(tm.auc, skm.auc, xx, y))
    assert _both(tm.auc, skm.auc, np.array([0.0, 1.0, 0.5]), y[:3]) == [ValueError] * 2
    assert _both(tm.auc, skm.auc, np.array([0.5]), np.array([1.0])) == [ValueError] * 2


@pytest.mark.parametrize("case", ["ties", "integers", "one_class_neg", "no_pred_pos",
                                  "all_wrong", "n1_pos", "n1_neg"])
def test_threshold_metrics_match_sklearn(case):
    rng = np.random.default_rng(1)
    if case in CASES:
        y, s = CASES[case]
        pred = (s > np.median(s)).astype(int)
    elif case == "no_pred_pos":
        y, pred = (rng.random(40) < 0.4).astype(float), np.zeros(40, int)
    else:
        y = (rng.random(40) < 0.4).astype(float)
        pred = 1 - y.astype(int)
    for fn_t, fn_s in ((tm.f1_score, skm.f1_score), (tm.precision_score, skm.precision_score),
                       (tm.recall_score, skm.recall_score)):
        got = fn_t(y, pred, zero_division=0)
        want = fn_s(y, pred, zero_division=0)
        assert abs(got - want) <= TOL, (fn_t.__name__, got, want)


def _eval_inputs(n=200, seed=0, prev=(0.12, 0.3, 0.5)):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (n, 3))
    labels = (rng.random((n, 3)) < np.asarray(prev)).astype(float)
    sensitive = {"age": rng.integers(0, 4, n), "ethnicity": rng.integers(0, 5, n),
                 "insurance": rng.integers(0, 6, n)}
    return logits, labels, sensitive


def _captured(fn, *args, **kwargs):
    buf = io.StringIO()
    with redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def _assert_tree_close(got, want, path="root"):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, tuple):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_close(g, w, f"{path}/{i}")
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), path
    else:
        assert abs(got - want) <= TOL, (path, got, want)


@pytest.mark.parametrize("auprc_mode", ["ap", "pr"])
@pytest.mark.parametrize("variant", ["per_task", "scalar", "one_class"])
def test_evaluate_multitask_matches_jax(variant, auprc_mode):
    logits, labels, sensitive = _eval_inputs(seed=3)
    thresholds = {"mortality": 0.31, "los": 0.5, "mechanical_ventilation": 0.77}
    if variant == "scalar":
        thresholds = 0.5
    elif variant == "one_class":
        labels[:, 0] = 0.0                 # AUROC NaN, AP 0.0
        logits[:, 2] = 50.0                # every prediction positive
    got, out_t = _captured(t_report.evaluate_multitask, logits, labels, sensitive, thresholds,
                           auprc_mode=auprc_mode)
    want, out_j = _captured(j_report.evaluate_multitask, logits, labels, sensitive,
                            thresholds, auprc_mode=auprc_mode)
    _assert_tree_close(got, want)
    assert out_t.splitlines() == out_j.splitlines()


@pytest.mark.parametrize("seed", [1, 4])
def test_eddi_report_matches_jax(seed):
    logits, labels, sensitive = _eval_inputs(seed=seed)
    sensitive["age"] = np.where(sensitive["age"] == 2, 1, sensitive["age"])   # an empty group
    thresholds = {"mortality": 0.2, "los": 0.5, "mechanical_ventilation": 0.65}
    got, out_t = _captured(t_report.eddi_report, logits, labels, sensitive, thresholds)
    want, out_j = _captured(j_report.eddi_report, logits, labels, sensitive, thresholds)
    assert out_t.splitlines() == out_j.splitlines()
    assert got.keys() == want.keys()
    assert abs(got["overall_combined_eddi"] - want["overall_combined_eddi"]) <= TOL
    for task in t_report.TASKS:
        assert abs(got[task]["combined_eddi"] - want[task]["combined_eddi"]) <= TOL
        _assert_tree_close(got[task]["attribute_eddi"], want[task]["attribute_eddi"])
        for attr, sub in want[task]["subgroups"].items():
            assert list(got[task]["subgroups"][attr]) == list(sub)
            for g, v in sub.items():
                assert abs(got[task]["subgroups"][attr][g] - v) <= TOL


def test_named_subgroups_follow_jax():
    for attr, groups in (("age", {0: 1.0, 3: 2.0, 7: 3.0}), ("insurance", {"x": 1.0, 5: 0.5}),
                         ("other", {1: 0.0})):
        assert t_report._named(attr, groups) == j_report._named(attr, groups)


@pytest.mark.parametrize("seed", [0, 5])
def test_calibrate_thresholds_matches_jax(seed):
    logits, labels, _ = _eval_inputs(n=150, seed=seed)
    labels[:, 1] = 0.0                     # best F1 0 keeps 0.5
    probs = 1 / (1 + np.exp(-logits))
    got = t_cal.calibrate_thresholds(probs, labels)
    want = j_cal.calibrate_thresholds(probs, labels)
    assert got == want and got["los"] == 0.5
    grid = np.linspace(0, 1, 101)
    assert all(np.isclose(grid, v, rtol=0, atol=0).any() for v in got.values())
    np.testing.assert_array_equal(t_cal.f1_grid(probs[:, 0], labels[:, 0], grid),
                                  j_cal.f1_grid(probs[:, 0], labels[:, 0], grid))


@pytest.mark.parametrize("aggregation", ["pairs", "n2"])
def test_equalized_odds_matches_jax(aggregation):
    rng = np.random.default_rng(2)
    y = rng.integers(0, 2, 120)
    pred = rng.integers(0, 2, 120)
    groups = rng.integers(0, 5, 120)
    got = t_eo.equalized_odds(y, pred, groups, aggregation=aggregation)
    want = j_eo.equalized_odds(y, pred, groups, aggregation=aggregation)
    _assert_tree_close(got, want)
    assert t_eo.tpr_fpr(np.zeros(3), np.zeros(3)) == j_eo.tpr_fpr(np.zeros(3), np.zeros(3))
    assert t_eo.equalized_odds_pairwise({}, {}) == j_eo.equalized_odds_pairwise({}, {})


def test_pos_weights_and_zscore_match_jax():
    rng = np.random.default_rng(3)
    labels = (rng.random((90, 3)) < [0.1, 0.5, 0.0]).astype(np.float32)
    got, want = t_feat.compute_pos_weights(labels), j_feat.compute_pos_weights(labels)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and got[2] == 1.0
    x = rng.normal(3, 2, (40, 6)).astype(np.float32)
    for a, b in zip(t_feat.zscore(x), j_feat.zscore(x)):
        np.testing.assert_array_equal(a, b)
    _, mean, std = t_feat.zscore(x)
    for a, b in zip(t_feat.zscore(x[:7], mean, std), j_feat.zscore(x[:7], mean, std)):
        np.testing.assert_array_equal(a, b)


def test_report_format_patterns():
    """tests/test_report_format.py's patterns on the port's printed blocks."""
    logits, labels, sensitive = _eval_inputs(seed=0, prev=(0.3, 0.3, 0.3))
    (metrics, fairness), out = _captured(t_report.evaluate_multitask, logits, labels,
                                         sensitive, 0.5)
    assert out.count("Fairness metrics for sensitive attribute:") == 9
    assert re.search(r"Group \d+: TPR = \d\.\d{3}, FPR = \d\.\d{3}", out)
    assert "Average TPR difference across groups:" in out
    assert "EO fairness metric (average of TPR and FPR differences):" in out
    for task in ("mortality", "los", "mechanical_ventilation"):
        assert f"Overall EO fairness metric for outcome {task}:" in out
        assert set(metrics[task]) == {"aucroc", "auprc", "f1", "recall (TPR)", "TPR",
                                      "precision", "fpr", "optimal_threshold"}
        assert fairness[task]["overall_eo"] >= 0.0
    _, out = _captured(t_report.eddi_report, logits, labels, sensitive, 0.5)
    assert "--- Sensitive Subgroup EDDI Statistics ---" in out
    for attr in ("Age", "Ethnicity", "Insurance"):
        assert f"{attr} EDDI:" in out
    assert out.count("\n Combined EDDI:") == 3
    assert "--- Overall Combined EDDI across outcomes ---" in out
    for name in ("15-29", "70-89", "Black", "White", "Medicare", "Self Pay"):
        assert f"'{name}'" in out, name
