"""The host utilities against the JAX package's (CPU).

- ``utils/debug.py``: ``check_finite_tree`` gives the JAX function's paths on
  a tree carried across with ``interop.flax_params`` with NaN and infinity
  injected, reads a module and a state dict, skips integer leaves;
  ``enable_nan_checks`` is autograd's anomaly mode;
- ``utils/profiling.py``: ``hlo_self_times`` reads positive per-op
  self-times from a CPU capture of ``profile_to``, ``trace``'s range among
  them; ``throughput`` returns the JAX function's keys; ``Timer`` times a
  block;
- ``eval/plots.py``: each plot function returns what the JAX one returns for
  the same inputs (the path of a PNG it wrote), and ``None`` in both
  packages when matplotlib cannot be imported.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from fairmultimodal_torch.eval import plots as t_plots
from fairmultimodal_torch.interop import flax_params, load_flax_params
from fairmultimodal_torch.train.adversarial import AdvPredictor
from fairmultimodal_torch.utils import debug as t_debug
from fairmultimodal_torch.utils import profiling as t_prof
from fairmultimodal_tpu.eval import plots as j_plots
from fairmultimodal_tpu.utils import debug as j_debug
from fairmultimodal_tpu.utils import profiling as j_prof


def _carried_tree():
    """A JAX-shaped tree of two MLPs, with a NaN and an infinity injected."""
    model = torch.nn.ModuleDict({"predictor": AdvPredictor(5, 4), "other": AdvPredictor(3, 2)})
    tree = flax_params(model)
    tree["predictor"]["fc1"]["kernel"][2, 1] = np.nan
    tree["other"]["fc2"]["bias"][0] = np.inf
    tree["step"] = np.array([3, 4], np.int32)
    return tree


def test_check_finite_tree_gives_the_jax_paths():
    tree = _carried_tree()
    want = j_debug.check_finite_tree(jax.tree_util.tree_map(np.asarray, tree), "params")
    assert want == ["params/other/fc2/bias", "params/predictor/fc1/kernel"]
    assert t_debug.check_finite_tree(tree, "params") == want
    assert t_debug.check_finite_tree({"x": torch.ones(3)}, "clean") == []


def test_check_finite_tree_reads_modules_and_state_dicts():
    tree = _carried_tree()
    tree.pop("step")
    model = torch.nn.ModuleDict({"predictor": AdvPredictor(5, 4), "other": AdvPredictor(3, 2)})
    load_flax_params(model, tree)
    want = ["m/other/fc2/bias", "m/predictor/fc1/weight"]
    assert t_debug.check_finite_tree(model, "m") == want
    assert t_debug.check_finite_tree(model.state_dict(), "m") == want
    grads = {"w": torch.tensor([1.0, float("nan")], dtype=torch.bfloat16)}
    assert t_debug.check_finite_tree(grads) == ["tree/w"]


def test_enable_nan_checks_is_anomaly_mode():
    before = torch.is_anomaly_enabled()
    try:
        t_debug.enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
        t_debug.enable_nan_checks(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)


def test_hlo_self_times_of_a_cpu_capture(tmp_path):
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with t_prof.profile_to(str(tmp_path)) as prof:
        with t_prof.trace("two_products"):
            c = torch.relu(a @ b) @ b
    assert c.shape == (64, 64) and prof is not None
    by_category, by_op = t_prof.hlo_self_times(str(tmp_path))
    assert set(by_category) == {"cpu_op", "user_annotation"}
    assert by_op and all(t >= 0 for t in by_op.values()) and by_op["aten::mm"] > 0
    assert "two_products" in by_op and "aten::relu" in by_op
    assert sum(by_op.values()) == pytest.approx(sum(by_category.values()))
    with pytest.raises(FileNotFoundError):
        t_prof.hlo_self_times(str(tmp_path / "empty"))


def test_throughput_has_the_jax_keys_and_timer_times():
    x = torch.randn(32, 32)
    got = t_prof.throughput(lambda: (x @ x, x + 1), iters=3, warmup=1, items_per_call=4)
    want = j_prof.throughput(jax.jit(lambda v: v @ v), np.ones((4, 4), np.float32), iters=2,
                             warmup=1)
    assert list(got) == list(want)
    assert got["n_chips"] == 1.0 and got["items_per_sec"] == pytest.approx(
        4 * got["calls_per_sec"])
    with t_prof.Timer() as timer:
        y = x @ x
        elapsed = timer.stop(y)
    assert 0 < elapsed <= timer.elapsed


def _plot_inputs(tmp_path, who):
    rng = np.random.default_rng(0)
    probs, labels = rng.uniform(0, 1, 30), rng.integers(0, 2, 30).astype(float)
    groups = rng.integers(0, 3, 30)
    return {
        "jitter_plot": (probs, labels, groups, str(tmp_path / f"{who}_jitter.png")),
        "disparity_bars": ({"a": 0.2, "b": -0.1, 3: 0.0}, str(tmp_path / f"{who}_bars.png")),
        "training_curves": ([{"epoch": e, "train_loss": 1.0 / e, "val_loss": 1.2 / e}
                             for e in (1, 2, 3)], str(tmp_path / f"{who}_curves.png")),
    }


@pytest.mark.parametrize("name", ["jitter_plot", "disparity_bars", "training_curves"])
def test_plots_return_what_the_jax_ones_return(name, tmp_path, monkeypatch):
    j_args, t_args = (_plot_inputs(tmp_path, who)[name] for who in ("jax", "port"))
    want, got = getattr(j_plots, name)(*j_args), getattr(t_plots, name)(*t_args)
    assert (want, got) == (j_args[-1], t_args[-1])
    assert os.path.getsize(got) > 0 and os.path.getsize(want) > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert getattr(j_plots, name)(*j_args) is None
    assert getattr(t_plots, name)(*t_args) is None
