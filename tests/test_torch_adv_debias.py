"""04 AdvDebias end to end against the JAX package's (CPU, fp32, tiny widths).

- ``FeatureBundle.labs_raw`` (the lab columns after ``fillna(0)``, before the
  z-score) equals the JAX bundle's bit for bit, NaN cells and an integer lab
  column included;
- ``run_adv_debias_experiment`` on the tiny configuration of the JAX
  package's golden 04 transcript (96 patients, 8 labs, width 32, one
  layer, one epoch at batch 32; stage 2's one-point grid at dropout 0), with
  the tiny text encoder of ``test_torch_baseline_pipelines.py``: stage 1 as
  ``test_torch_dfc.py`` holds 03 (the JAX run's initial weights, the train
  forward without dropout; splits exact, losses 1e-5 relative, test logits
  1e-4), stage 2 on the same matched and resampled rows from the JAX run's
  initial weights (the train curve 1e-5 relative), the same artifact files,
  ``metrics.csv`` with the JAX header and its values within 1e-5 (empty
  where the JAX file's are), and the printed lines with every number
  collapsed.
"""

import csv
import io
import os
import re
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
from test_torch_adversarial import jax_init
from test_torch_baseline_pipelines import _recording, encoders  # noqa: F401

from fairmultimodal_torch.data import featurize as t_featurize
from fairmultimodal_torch.interop import load_flax_params
from fairmultimodal_torch.pipelines import adv_debias as t_adv
from fairmultimodal_torch.pipelines import common as t_common
from fairmultimodal_torch.train import adversarial as t_train
from fairmultimodal_tpu.data import featurize as j_featurize
from fairmultimodal_tpu.data.synthetic import make_common_frames
from fairmultimodal_tpu.pipelines import adv_debias as j_adv
from fairmultimodal_tpu.train import adversarial as j_train
from fairmultimodal_tpu.train import simple as j_simple

GRID = {"learning_rate": [1e-3], "num_iters": [60], "num_nodes": [16], "num_nodes_adv": [8],
        "dropout_rate": [0.0], "alpha": [1.0]}


@pytest.fixture(scope="module")
def frames():
    return make_common_frames(n_patients=96, n_lab_features=8, seed=5)


def test_labs_raw_is_the_jax_bundles(frames):
    s, u = frames[0].copy(), frames[1]
    lab = [c for c in s.columns if c.startswith("lab_")]
    s.loc[s.index[::7], lab[1]] = np.nan
    s.loc[s.index[3::11], lab[4]] = np.nan
    s[lab[2]] = np.arange(len(s), dtype=np.int64) - 40
    want = j_featurize.assemble_features(s, u).labs_raw
    got = t_featurize.assemble_features(s, u).labs_raw
    assert got.dtype == want.dtype == np.float32 and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)
    assert not np.isnan(got).any()


def _config(module, out_dir):
    cfg = module.AdvDebiasPipelineConfig(
        text_max_length=32, text_batch_size=16, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, stage2_grid=GRID, out_dir=str(out_dir))
    cfg.train.lr, cfg.train.num_epochs, cfg.train.batch_size = 1e-3, 1, 32
    cfg.train.deterministic_forward = True
    return cfg


def _metrics_csv(path):
    with open(path, newline="") as f:
        header, *rows = list(csv.reader(f))
    values = [[np.nan if v == "" else float(v == "True") if v in ("True", "False")
               else float(v) for v in row] for row in rows]
    return header, np.asarray(values, np.float64)


def _tree(out_dir):
    return sorted(os.path.relpath(os.path.join(d, f), out_dir)
                  for d, _, files in os.walk(out_dir) for f in files)


def _shape(text):
    text = re.sub(r"/\S+", "<path>", text)
    return [re.sub(r"-?(\d+(\.\d*)?(e[-+]?\d+)?|nan)", "#", line) for line in text.splitlines()]


def test_pipeline_matches_jax(frames, encoders, tmp_path, monkeypatch):  # noqa: F811
    calls, init, stage2 = {"jax": {}, "port": {}}, {}, {}
    original = j_simple.MultitaskTrainer.init_params
    j_grid_search = j_train.adv_grid_search

    def init_params(self, example):
        params = original(self, example)
        init["params"] = jax.tree_util.tree_map(np.array, params)     # the step donates
        return params

    def grid_search(X, *args, **kwargs):
        stage2["num_features"] = X.shape[1]
        return j_grid_search(X, *args, **kwargs)

    def recording(module, who):
        train = module.train_adversarial

        def run(*args, **kwargs):
            stage2[who] = args[:6]
            return train(*args, **kwargs)
        return run

    mp = pytest.MonkeyPatch()
    _recording(mp, j_adv, calls["jax"])
    mp.setattr(j_simple.MultitaskTrainer, "init_params", init_params)
    mp.setattr(j_adv, "adv_grid_search", grid_search)
    mp.setattr(j_train, "train_adversarial", recording(j_train, "jax"))
    cfg = _config(j_adv, tmp_path / "jax")
    cfg.train.rng_impl = "threefry"
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            want = j_adv.run_adv_debias_experiment(*frames, cfg, text_encoder=encoders[0])
    finally:
        mp.undo()
    j_out = buf.getvalue()

    point = t_train.AdvConfig(**{k: v[0] for k, v in GRID.items()})
    carried = jax_init(point, stage2["num_features"])
    _recording(monkeypatch, t_common, calls["port"])
    monkeypatch.setattr(t_adv, "init_params",
                        lambda model, seed: load_flax_params(model, init["params"]))
    monkeypatch.setattr(t_train, "init_params",
                        lambda model, seed: load_flax_params(model, carried))
    monkeypatch.setattr(t_train, "train_adversarial", recording(t_train, "port"))
    buf = io.StringIO()
    with redirect_stdout(buf):
        got = t_adv.run_adv_debias_experiment(*frames, _config(t_adv, tmp_path / "port"),
                                              text_encoder=encoders[1], device="cpu")
    t_out = buf.getvalue()

    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(got["prep"].idx[split], want["prep"].idx[split])
    np.testing.assert_array_equal(got["prep"].pos_weight, want["prep"].pos_weight)
    assert len(got["history"]) == len(want["history"]) == 1
    for g, w in zip(got["history"], want["history"]):
        assert g["train_loss"] == pytest.approx(w["train_loss"], rel=1e-5), (g, w)
        assert g["val_loss"] == pytest.approx(w["val_loss"], rel=1e-5), (g, w)
    (t_logits, t_labels), (j_logits, j_labels) = (
        c["evaluate_multitask"][:2] for c in (calls["port"], calls["jax"]))
    np.testing.assert_allclose(t_logits, j_logits, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(t_labels, j_labels)

    assert stage2["num_features"] == len(got["prep"].bundle.lab_columns)
    for g, w in zip(stage2["port"], stage2["jax"]):       # matched + resampled, val
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    (g2,), (w2,) = got["stage2"], want["stage2"]
    assert g2["config"] == w2["config"]
    np.testing.assert_allclose(g2["train_curve"], w2["train_curve"], rtol=1e-5, atol=0)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert "loss_metrics.png" in _tree(tmp_path / "port")
    (t_head, t_rows), (j_head, j_rows) = (_metrics_csv(tmp_path / d / "metrics.csv")
                                          for d in ("port", "jax"))
    assert t_head == j_head == list(w2["config"]) + list(w2["metrics"])
    assert t_rows.shape == j_rows.shape == (1, len(j_head))
    np.testing.assert_allclose(t_rows, j_rows, rtol=0, atol=1e-5, equal_nan=True)
    assert _shape(t_out) == _shape(j_out)
    assert set(got["timings"]) >= {"train", "stage2", "artifacts"}
