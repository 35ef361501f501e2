"""04's stage 2 (``train/adversarial.py``) against the JAX package's (CPU, fp32).

- ``AdvPredictor`` / ``AdvAdversary`` with the flax modules' weights
  (``interop``): outputs within 1e-6;
- ``train_adversarial`` for 20 iterations at dropout 0, with and without the
  adversary, from the JAX run's initial weights (the port's ``init_params``
  replaced by a load of the ``threefry_key(cfg.seed)`` init): every logged
  loss within 1e-5 relative, each final parameter within 1e-5 of its
  max-abs, the validation probabilities within 1e-6.  The biases read
  6-8e-6 of their max-abs: ``optax.adam`` rounds its bias correction in
  fp32 (1 - 0.999 = 9.99987e-4, 6.4e-6 relative after the square root),
  ``torch.optim.Adam`` in float64;
- with dropout on, one seed gives the same curves twice, another seed others;
- ``match_case_control`` and ``resample_smoteenn`` index for index (imblearn
  is not installed: both packages take the oversampling branch), for
  several seeds and a label without positives;
- ``adv_metrics`` within 1e-12 of the JAX one (scikit-learn's AUROC), NaN in
  the same places;
- ``params_tostring`` on all 64 points of ``REFERENCE_GRID``;
- the npz artifacts: the port's files load in the JAX package's
  ``load_adv_artifact`` and the JAX files in the port's, with the same
  predictions within 1e-6;
- the entry points default to CUDA and raise without it.
"""

import dataclasses
import itertools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairmultimodal_torch.interop import flax_params, load_flax_params
from fairmultimodal_torch.train import adversarial as T
from fairmultimodal_tpu.train import adversarial as J
from fairmultimodal_tpu.utils.rng import threefry_key


def _data(seed=11, n=48, f=7, nv=24):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (n, f)).astype(np.float32),
            rng.integers(0, 2, n).astype(np.float32),
            rng.integers(0, 2, n).astype(np.float32),
            rng.normal(0, 1, (nv, f)).astype(np.float32),
            rng.integers(0, 2, nv).astype(np.float32),
            rng.integers(0, 3, nv).astype(np.float32))


def jax_init(cfg, num_features):
    """The initial weights ``train_adversarial`` draws in the JAX package."""
    k1, k2 = jax.random.split(threefry_key(cfg.seed))
    p0 = J.AdvPredictor(cfg.num_nodes, cfg.dropout_rate).init(
        k1, jnp.zeros((1, num_features)))["params"]
    a0 = J.AdvAdversary(cfg.num_nodes_adv, cfg.dropout_rate).init(
        k2, jnp.zeros((1, 2)))["params"]
    return {"predictor": jax.tree_util.tree_map(np.asarray, p0),
            "adversary": jax.tree_util.tree_map(np.asarray, a0)}


def carry_jax_init(monkeypatch, cfg, num_features):
    """Start the port's networks from the JAX package's initial weights."""
    init = jax_init(cfg, num_features)
    monkeypatch.setattr(T, "init_params", lambda module, seed: load_flax_params(module, init))


def port_config(cfg):
    return T.AdvConfig(**dataclasses.asdict(cfg))


def assert_params_close(module, tree, tol, label):
    got = flax_params(module)
    for layer, leaves in tree.items():
        for leaf, want in leaves.items():
            want = np.asarray(want)
            err = np.abs(got[layer][leaf] - want).max() / np.abs(want).max()
            assert err <= tol, f"{label} {layer}/{leaf}: {err}"


@pytest.mark.parametrize("kind", ["predictor", "adversary"])
def test_networks_match_jax(kind):
    rng = np.random.default_rng(3)
    if kind == "predictor":
        j_mod, t_mod, x = J.AdvPredictor(12, 0.3), T.AdvPredictor(5, 12, 0.3), rng.normal(
            0, 1, (9, 5))
    else:
        j_mod, t_mod, x = J.AdvAdversary(6, 0.3), T.AdvAdversary(6, 0.3), rng.uniform(
            0, 1, (9, 2))
    x = x.astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, j_mod.init(threefry_key(1), x)["params"])
    load_flax_params(t_mod, params)
    want = np.asarray(j_mod.apply({"params": params}, x))
    with torch.no_grad():
        got = t_mod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (9, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert set(flax_params(t_mod)) == {"fc1", "fc2"}


@pytest.mark.parametrize("adversarial", [True, False])
def test_train_adversarial_matches_jax(adversarial, monkeypatch):
    data = _data()
    cfg = J.AdvConfig(learning_rate=1e-3, num_iters=20, num_nodes=8, num_nodes_adv=6,
                      dropout_rate=0.0, alpha=1.0, seed=3, adversarial=adversarial)
    want = J.train_adversarial(*data, cfg, verbose=False, log_every=1)
    carry_jax_init(monkeypatch, cfg, data[0].shape[1])
    got = T.train_adversarial(*data, port_config(cfg), verbose=False, log_every=1,
                              device="cpu")
    for key in ("train_curve", "valid_curve"):
        assert len(got[key]) == 20
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=0)
    assert_params_close(got["predictor"], want["predictor_params"], 1e-5, "predictor")
    if adversarial:
        assert_params_close(got["adversary"], want["adversary_params"], 1e-5, "adversary")
    else:     # never stepped: still the initial weights
        init = jax_init(cfg, data[0].shape[1])["adversary"]
        for layer, leaves in flax_params(got["adversary"]).items():
            for leaf, v in leaves.items():
                np.testing.assert_array_equal(v, init[layer][leaf])
    assert got["yhat_valid"].shape == want["yhat_valid"].shape == (24, 1)
    np.testing.assert_allclose(got["yhat_valid"], want["yhat_valid"], rtol=0, atol=1e-6)


def test_train_adversarial_prints_the_jax_lines(monkeypatch, capsys):
    data = _data(5)
    cfg = J.AdvConfig(learning_rate=1e-3, num_iters=7, num_nodes=4, num_nodes_adv=3,
                      dropout_rate=0.0, seed=2)
    J.train_adversarial(*data, cfg, log_every=3)
    want = capsys.readouterr().out
    carry_jax_init(monkeypatch, cfg, data[0].shape[1])
    T.train_adversarial(*data, port_config(cfg), log_every=3, device="cpu")
    got = capsys.readouterr().out
    number = r"-?\d+\.\d+"
    assert re.sub(number, "#", got) == re.sub(number, "#", want)
    assert got.count("Iteration:") == 3
    # Four decimals of values within 1e-6 of each other: one digit may round apart.
    np.testing.assert_allclose([float(v) for v in re.findall(number, got)],
                               [float(v) for v in re.findall(number, want)], rtol=0,
                               atol=1.01e-4)


def test_dropout_curves_repeat_for_a_seed():
    data = _data(7)

    def curves(seed):
        cfg = T.AdvConfig(learning_rate=1e-3, num_iters=12, num_nodes=8, num_nodes_adv=6,
                          dropout_rate=0.3, seed=seed)
        out = T.train_adversarial(*data, cfg, verbose=False, log_every=1, device="cpu")
        return out["train_curve"] + out["valid_curve"]

    first = curves(4)
    assert curves(4) == first
    assert curves(5) != first
    no_dropout = T.train_adversarial(*data, T.AdvConfig(learning_rate=1e-3, num_iters=1,
                                                        num_nodes=8, num_nodes_adv=6,
                                                        dropout_rate=0.0, seed=4),
                                     verbose=False, log_every=1, device="cpu")
    assert no_dropout["train_curve"][0] != first[0]     # the same init, masks applied


@pytest.mark.parametrize("seed", [0, 1, 25])
@pytest.mark.parametrize("positives", [0, 3, 17])
def test_matching_and_resampling_are_index_exact(seed, positives):
    rng = np.random.default_rng(seed + 100)
    n = 120
    y = np.zeros(n, np.float32)
    y[rng.choice(n, positives, replace=False)] = 1
    X = rng.normal(0, 1, (n, 4)).astype(np.float32)
    z = rng.integers(0, 3, n).astype(np.float32)
    keep = T.match_case_control(y, 20, seed)
    np.testing.assert_array_equal(keep, J.match_case_control(y, 20, seed))
    assert keep.dtype == np.int64 and len(keep) == 21 * positives
    for src in ((X, y, z), (X[keep], y[keep], z[keep])):
        got, want = T.resample_smoteenn(*src, seed=seed), J.resample_smoteenn(*src, seed=seed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _metric_cases():
    rng = np.random.default_rng(9)
    n = 40
    yhat = rng.uniform(0, 1, n)
    y = rng.integers(0, 2, n).astype(np.float32)
    z = rng.integers(0, 4, n).astype(np.float32)
    only_neg_in_z0 = np.where(z == 0, 0.0, y).astype(np.float32)
    return {"mixed": (yhat, y, z), "one class": (yhat, np.zeros(n, np.float32), z),
            "all positive": (yhat, np.ones(n, np.float32), z),
            "no positive at z=0": (yhat, only_neg_in_z0, z),
            "ties": (np.round(yhat, 1), y, z), "column shapes": (yhat[:, None], y, z[:, None]),
            "threshold 0.3": (yhat, y, z, 0.3, 0.1)}


@pytest.mark.parametrize("case", list(_metric_cases()))
def test_adv_metrics_match_jax(case):
    args = _metric_cases()[case]
    got, want = T.adv_metrics(*args), J.adv_metrics(*args)
    assert list(got) == list(want)
    for k in want:
        assert np.isnan(got[k]) == np.isnan(want[k]), (k, got[k], want[k])
        if not np.isnan(want[k]):
            assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    if case == "one class":
        assert np.isnan(got["auroc"])


def test_params_tostring_on_the_reference_grid():
    keys = list(T.REFERENCE_GRID)
    assert T.REFERENCE_GRID == J.REFERENCE_GRID and T.REDUCED_GRID == J.REDUCED_GRID
    points = list(itertools.product(*(T.REFERENCE_GRID[k] for k in keys)))
    assert len(points) == 64
    for values in points:
        point = dict(zip(keys, values))
        assert T.params_tostring(T.AdvConfig(**point)) == J.params_tostring(
            J.AdvConfig(**point))
    assert T.params_tostring(T.AdvConfig(**dict(zip(keys, points[0])))).endswith("alpha_1")
    assert [f.name for f in dataclasses.fields(T.AdvConfig)] == [
        f.name for f in dataclasses.fields(J.AdvConfig)]


def _predict(module, x):
    if isinstance(module, torch.nn.Module):
        with torch.no_grad():
            return torch.sigmoid(module(torch.from_numpy(x))).numpy()
    mod, params = module
    return np.asarray(jax.nn.sigmoid(mod.apply({"params": params}, x)))


@pytest.mark.parametrize("adversarial", [True, False])
def test_artifacts_load_in_both_packages(adversarial, tmp_path):
    """One grid point's networks written by each package, read by both."""
    X, y, z, Xv, yv, zv = _data(13, f=5)
    cfg = J.AdvConfig(learning_rate=1e-3, num_iters=3, num_nodes=6, num_nodes_adv=4,
                      dropout_rate=0.1, alpha=2, adversarial=adversarial)
    config = dataclasses.asdict(cfg)
    out = J.train_adversarial(X, y, z, Xv, yv, zv, cfg, verbose=False)
    t_pred, t_adv = T.AdvPredictor(5, 6, 0.1), T.AdvAdversary(4, 0.1)
    load_flax_params(t_pred, out["predictor_params"])
    load_flax_params(t_adv, out["adversary_params"])
    written = {
        "jax": J.save_adv_artifacts(str(tmp_path / "jax"), [
            {"config": config, "predictor_params": out["predictor_params"],
             "adversary_params": out["adversary_params"]}], 5),
        "port": T.save_adv_artifacts(str(tmp_path / "port"), [
            {"config": config, "predictor": t_pred, "adversary": t_adv}], 5)}
    rel = [os.path.relpath(p, tmp_path / "port") for p in written["port"]]
    assert rel == [os.path.relpath(p, tmp_path / "jax") for p in written["jax"]]
    tag = J.params_tostring(cfg)
    assert rel[:2] == [f"model/model-basic_{tag}.npz", "model/model-basic_final.npz"]
    assert len(rel) == (4 if adversarial else 2)
    assert sorted(os.listdir(tmp_path / "port")) == ["adv", "metrics", "model"]
    xs = {"predictor": Xv, "adversary": np.stack([np.linspace(0, 1, 7)] * 2, 1).astype(
        np.float32)}
    for path in rel:
        for writer in ("jax", "port"):
            full = str(tmp_path / writer / path)
            j_mod, j_params, j_cfg = J.load_adv_artifact(full)
            t_mod, t_cfg = T.load_adv_artifact(full, device="cpu")
            assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg) == config
            kind = "predictor" if path.startswith("model") else "adversary"
            assert isinstance(t_mod, T.AdvPredictor if kind == "predictor" else T.AdvAdversary)
            np.testing.assert_allclose(_predict(t_mod, xs[kind]),
                                       _predict((j_mod, j_params), xs[kind]), rtol=0, atol=1e-6)


def test_load_rejects_a_file_without_the_metadata(tmp_path):
    np.savez(tmp_path / "x.npz", a=np.zeros(2))
    with pytest.raises(ValueError, match="not a stage-2"):
        T.load_adv_artifact(str(tmp_path / "x.npz"), device="cpu")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    from fairmultimodal_torch.pipelines.adv_debias import run_adv_debias_experiment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _data()
    cfg = T.AdvConfig(num_iters=1, num_nodes=4, num_nodes_adv=3)
    for call in (lambda: T.train_adversarial(*data, cfg, verbose=False),
                 lambda: T.adv_grid_search(*data, grid=T.REDUCED_GRID, verbose=False),
                 lambda: run_adv_debias_experiment(None, None, verbose=False)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    T.save_adv_artifacts(str(tmp_path), [{"config": dataclasses.asdict(cfg),
                                          "predictor": T.AdvPredictor(7, 4),
                                          "adversary": T.AdvAdversary(3)}], 7)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.load_adv_artifact(str(tmp_path / "model" / "model-basic_final.npz"))
