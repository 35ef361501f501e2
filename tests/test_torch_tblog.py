"""``--tensorboard`` event files from the port (``utils/tblog.py``), read
back with tensorboard's ``EventAccumulator`` as the JAX package's
``tests/test_tblog.py`` reads its own; the port writes the same tags and
values as the JAX module from the same result dict."""

import glob

import pytest

pytest.importorskip("torch.utils.tensorboard")
from tensorboard.backend.event_processing.event_accumulator import (  # noqa: E402
    EventAccumulator,
)

from fairmultimodal_torch.utils import tblog as t_tblog  # noqa: E402
from fairmultimodal_tpu.utils import tblog as j_tblog  # noqa: E402


class _Trainer:
    tracked_dynamic_weights = {"mortality": [[0.4, 0.3, 0.3], [0.5, 0.25, 0.25]],
                               "los": [[1 / 3] * 3, [0.2, 0.4, 0.4]]}


def _out():
    return {
        "history": [{"epoch": 1, "train_loss": 1.5, "train_bce": 1.2, "val_loss": 1.4,
                     "lr": 1e-3},
                    {"epoch": 2, "train_loss": 1.1, "train_bce": 0.9, "val_loss": 1.2,
                     "lr": 1e-4}],
        "metrics": {"mortality": {"aucroc": 0.91, "auprc": 0.55, "recall (TPR)": 0.5},
                    "los": {"aucroc": 0.88}},
        "fairness": {"mortality": {"age": {"eo_metric": 0.015}, "overall_eo": 0.015}},
        "eddi": {"mortality": {"attribute_eddi": {"age": 0.03}, "subgroups": {
            "age": {"15-29": 0.01}}, "combined_eddi": 0.021}, "overall_combined_eddi": 0.02},
        "trainer": _Trainer(),
    }


def _scalars(log_dir):
    acc = EventAccumulator(log_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_log_run_writes_the_jax_curves_and_final_blocks(tmp_path):
    got_dir = t_tblog.log_run(_out(), str(tmp_path / "port"), verbose=False)
    j_tblog.log_run(_out(), str(tmp_path / "jax"), verbose=False)
    assert got_dir == str(tmp_path / "port")
    assert glob.glob(str(tmp_path / "port" / "events.out.tfevents.*"))
    got, want = _scalars(got_dir), _scalars(str(tmp_path / "jax"))
    assert got == want
    assert got["train/val_loss"] == [(1, pytest.approx(1.4)), (2, pytest.approx(1.2))]
    assert got["dynamic_weights/los/lab"][1] == (2, pytest.approx(0.4))
    assert "test/mortality/recall__TPR_" in got and "eddi/mortality/combined" in got


def test_log_run_skips_what_is_not_a_run(tmp_path):
    assert t_tblog.log_run(None, str(tmp_path / "x"), verbose=False) is None
    assert t_tblog.log_run({"metrics": {}}, str(tmp_path / "y"), verbose=False) is not None
