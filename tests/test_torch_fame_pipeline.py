"""The FAME experiment end to end: the port's ``run_fame_experiment``
against the JAX package's on one synthetic cohort (CPU, fp32).

Both runs get the same tiny text-encoder weights, the tiny geometry of
``tests/test_train.py``, ``deterministic_forward=True`` and the same initial
model weights (the JAX trainer's ``init_params`` output, loaded into the
port's model by a monkeypatch of the pipeline's ``init_params``).  Checked:
the splits and positive-class weights exactly, the per-epoch losses to 1e-5
relative, the validation and test logits to 1e-4, the dynamic weights to
1e-6, the artifacts' names and keys, and the printed lines' shape.  The
port's calibration, evaluation and EDDI report on the JAX run's own logits
equal the JAX numbers exactly, which separates the numpy tail from training
round-off.  The port runs with ``device_data`` on and off;
``reference_compat=True`` reproduces the JAX indices.
"""

import glob
import io
import os
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairmultimodal_torch.eval import report as t_report
from fairmultimodal_torch.interop import load_flax_params
from fairmultimodal_torch.models import bert as t_bert
from fairmultimodal_torch.models import fusion as t_fusion
from fairmultimodal_torch.models import text as t_text
from fairmultimodal_torch.pipelines import fame as t_fame
from fairmultimodal_torch.pipelines.common import build_arrays
from fairmultimodal_torch.pipelines.inference import FAMEPredictor
from fairmultimodal_torch.train import calibrate as t_cal
from fairmultimodal_torch.train import loop as t_loop
from fairmultimodal_torch.train.loop import TrainConfig as TTrainConfig
from fairmultimodal_torch.utils import checkpoint as t_ckpt
from fairmultimodal_tpu.data.featurize import compute_pos_weights as j_pos_weights
from fairmultimodal_tpu.data.synthetic import make_common_frames
from fairmultimodal_tpu.models import bert as j_bert
from fairmultimodal_tpu.models import text as j_text
from fairmultimodal_tpu.pipelines import fame as j_fame
from fairmultimodal_tpu.train import loop as j_loop
from fairmultimodal_tpu.utils import checkpoint as j_ckpt

TEXT_CFG = dict(vocab_size=512, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=64, max_position_embeddings=64)
GEO = dict(text_max_length=32, text_batch_size=16, hidden_size=32, demo_layers=1,
           demo_heads=2, lab_layers=1, lab_heads=2, fusion_hidden=16, val_size=0.15)
TRAIN = dict(lr=1e-3, num_epochs=3, batch_size=32, lambda_edd=0.2, lambda_l1=0.001,
             patience=10, deterministic_forward=True)
TASKS = ("mortality", "los", "mechanical_ventilation")


@pytest.fixture(scope="module")
def frames():
    return make_common_frames(n_patients=200, n_lab_features=12, seed=3)


@pytest.fixture(scope="module")
def encoders():
    cfg = j_bert.BertConfig(**TEXT_CFG)
    params = jax.jit(j_bert.BertEncoderModel(cfg).init)(
        jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params["params"]))
    return (j_text.TextEncoder(cfg, params, j_text.HashingTokenizer(cfg.vocab_size)),
            t_text.TextEncoder.from_params(params, t_bert.BertConfig(**TEXT_CFG), device="cpu"))


def _recording(module, names, calls):
    """Wrap ``module``'s functions so each call's arguments are kept."""
    originals = {n: getattr(module, n) for n in names}

    def wrap(name):
        def fn(*args, **kwargs):
            calls[name] = args
            return originals[name](*args, **kwargs)
        return fn

    return {n: wrap(n) for n in names}


RECORDED = ("calibrate_thresholds", "evaluate_multitask", "eddi_report")


def _run_jax(frames, encoders, out_dir, reference_compat=False, epochs=3):
    """The JAX experiment; returns (result, stdout, recorded calls, init params)."""
    calls, init = {}, {}
    mp = pytest.MonkeyPatch()
    for name, fn in _recording(j_fame, RECORDED, calls).items():
        mp.setattr(j_fame, name, fn)
    original_init = j_loop.FAMETrainer.init_params

    def init_params(self, example):
        params = original_init(self, example)
        # A host copy now: the first train step donates the device buffers.
        init["params"] = jax.tree_util.tree_map(np.array, params)
        return params

    mp.setattr(j_loop.FAMETrainer, "init_params", init_params)
    cfg = j_fame.FAMEPipelineConfig(
        train=j_loop.TrainConfig(rng_impl="threefry", **dict(TRAIN, num_epochs=epochs)),
        out_dir=str(out_dir), reference_compat=reference_compat, **GEO)
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            out = j_fame.run_fame_experiment(*frames, cfg, text_encoder=encoders[0])
    finally:
        mp.undo()
    return out, buf.getvalue(), calls, init["params"]


def _run_port(frames, encoders, out_dir, init, monkeypatch, device_data=True,
              reference_compat=False, epochs=3):
    calls = {}
    for name, fn in _recording(t_fame, RECORDED, calls).items():
        monkeypatch.setattr(t_fame, name, fn)
    monkeypatch.setattr(t_fame, "init_params", lambda model, seed: load_flax_params(model, init))
    cfg = t_fame.FAMEPipelineConfig(
        train=TTrainConfig(**dict(TRAIN, num_epochs=epochs)), out_dir=str(out_dir),
        device_data=device_data, reference_compat=reference_compat, **GEO)
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = t_fame.run_fame_experiment(*frames, cfg, text_encoder=encoders[1], device="cpu")
    return out, buf.getvalue(), calls


@pytest.fixture(scope="module")
def jax_run(frames, encoders, tmp_path_factory):
    return _run_jax(frames, encoders, tmp_path_factory.mktemp("jax"))


def _shape(text):
    """Printed lines with every digit run collapsed and the out_dir dropped."""
    return [re.sub(r"\d+", "#", re.sub(r"Saved best model to .*/", "Saved best model to ", line))
            for line in text.splitlines()]


def _artifacts(out_dir):
    names = sorted(re.sub(r"\d{8}_\d{6}", "<ts>", os.path.basename(p))
                   for p in glob.glob(os.path.join(out_dir, "*")))
    keys = {}
    for p in glob.glob(os.path.join(out_dir, "*.npz")):
        with np.load(p) as z:
            keys[re.sub(r"_\d{8}_\d{6}", "", os.path.basename(p))] = {
                k: z[k].shape for k in z.files if k != "__metadata_json__"}
    return names, keys


@pytest.mark.parametrize("device_data", [True, False])
def test_experiment_matches_jax(device_data, frames, encoders, jax_run, tmp_path, monkeypatch):
    want, j_stdout, j_calls, init = jax_run
    got, t_stdout, t_calls = _run_port(frames, encoders, tmp_path, init, monkeypatch,
                                       device_data=device_data)
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(got["splits"][split], want["splits"][split])
    labels = want["bundle"].labels
    np.testing.assert_array_equal(got["trainer"].pos_weight.numpy(),
                                  j_pos_weights(labels[want["splits"]["train"]]))
    np.testing.assert_array_equal(got["bundle"].labels, labels)
    np.testing.assert_allclose(got["bundle"].text_embeddings, want["bundle"].text_embeddings,
                               rtol=1e-5, atol=1e-5)

    assert len(got["history"]) == len(want["history"]) == TRAIN["num_epochs"]
    for g, w in zip(got["history"], want["history"]):
        for k in ("train_loss", "train_bce", "val_loss"):
            assert g[k] == pytest.approx(w[k], rel=1e-5), (g, w)
        assert g["lr"] == w["lr"]
    np.testing.assert_allclose(got["trainer"].dynamic_weights,
                               want["trainer"].dynamic_weights, rtol=0, atol=1e-6)
    for task in TASKS:
        np.testing.assert_allclose(got["trainer"].tracked_dynamic_weights[task],
                                   want["trainer"].tracked_dynamic_weights[task], atol=1e-6)

    # Validation and test logits (the best state's), labels and groups.
    (t_val_probs, t_val_labels), (j_val_probs, j_val_labels) = (
        t_calls["calibrate_thresholds"], j_calls["calibrate_thresholds"])
    np.testing.assert_array_equal(t_val_labels, j_val_labels)
    np.testing.assert_allclose(t_val_probs, j_val_probs, rtol=0, atol=1e-4)
    t_logits, t_labels, t_sens, _ = t_calls["evaluate_multitask"]
    j_logits, j_labels, j_sens, _ = j_calls["evaluate_multitask"]
    np.testing.assert_allclose(t_logits, j_logits, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(t_labels, j_labels)
    for k in j_sens:
        np.testing.assert_array_equal(t_sens[k], j_sens[k])

    # The numpy tail on the JAX run's own inputs gives the JAX numbers exactly.
    assert t_cal.calibrate_thresholds(*j_calls["calibrate_thresholds"]) == want["thresholds"]
    with redirect_stdout(io.StringIO()):
        metrics, fairness = t_report.evaluate_multitask(*j_calls["evaluate_multitask"])
        eddi = t_report.eddi_report(*j_calls["eddi_report"])
    np.testing.assert_equal(metrics, want["metrics"])
    np.testing.assert_equal(fairness, want["fairness"])
    np.testing.assert_equal(eddi, want["eddi"])

    assert list(got["timings"]) == list(want["timings"])
    assert set(got) == set(want)
    assert _shape(t_stdout) == _shape(j_stdout)
    assert _artifacts(str(tmp_path)) == _artifacts(os.path.dirname(want["artifacts"]
                                                                   ["best_model"]))


def test_eval_passes_and_npz_use_the_best_state_not_the_last(frames, encoders, jax_run,
                                                              tmp_path, monkeypatch):
    """With only epoch 1 counted as an improvement, the best state is not the
    last: validation, test logits, extracted vectors and the saved npz must
    all come from the best one.  The port's predictor and the JAX
    ``load_params_npz`` both read the npz back."""
    step, fit, last = t_loop.EarlyStopper.step, t_loop.FAMETrainer.fit, {}

    def first_epoch_only(self, val_loss):
        first = self.best == float("inf")
        stop = step(self, val_loss)
        self.improved = first
        return stop

    def fit_keeping_the_last_state(self, *args, **kwargs):
        out = fit(self, *args, **kwargs)
        last.update(self._state_copy())
        return out

    monkeypatch.setattr(t_loop.EarlyStopper, "step", first_epoch_only)
    monkeypatch.setattr(t_loop.FAMETrainer, "fit", fit_keeping_the_last_state)
    got, _, calls = _run_port(frames, encoders, tmp_path, jax_run[3], monkeypatch)
    assert any(not torch.equal(v, got["best_params"][k]) for k, v in last.items())

    path = got["artifacts"]["best_model"]
    meta = t_ckpt.load_metadata_npz(path)
    assert meta["thresholds"] == got["thresholds"]
    np.testing.assert_array_equal(meta["dynamic_weights"], got["trainer"].dynamic_weights)
    model = load_flax_params(t_fusion.FAMEModel(**meta["model"]), t_ckpt.load_params_npz(path))
    for k, v in model.state_dict().items():
        assert torch.equal(v, got["best_params"][k]), k
    test_idx = got["splits"]["test"]
    arrays = {k: v[test_idx] for k, v in build_arrays(got["bundle"], t_fame.FAME_KEYS).items()}

    def probs(state):
        model.load_state_dict(state)
        return FAMEPredictor(model, meta["thresholds"], batch_size=32,
                             dynamic_weights=meta["dynamic_weights"],
                             device="cpu").predict_arrays(arrays)["probs"]

    run_probs = 1 / (1 + np.exp(-calls["evaluate_multitask"][0]))
    np.testing.assert_allclose(probs(got["best_params"]), run_probs, rtol=0, atol=1e-6)
    assert np.abs(probs(last) - run_probs).max() > 1e-4
    with np.load(glob.glob(str(tmp_path / "extracted_vectors_*.npz"))[0]) as vec:
        np.testing.assert_array_equal(vec["logits"], calls["evaluate_multitask"][0])
        assert vec["gated_vectors"].shape == (len(test_idx), 3 * 256)
    # The JAX reader takes the file too, in the structure of the JAX params.
    j_ckpt.load_params_npz(path, jax_run[3])


def test_reference_compat_gives_the_jax_indices(frames, encoders, tmp_path, monkeypatch):
    want, _, _, init = _run_jax(frames, encoders, tmp_path / "jax", reference_compat=True,
                                epochs=1)
    got, _, _ = _run_port(frames, encoders, tmp_path / "port", init, monkeypatch,
                          reference_compat=True, epochs=1)
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(got["splits"][split], want["splits"][split])
    # The relative indices overlap the test rows: the reference's bug.
    assert np.intersect1d(got["splits"]["train"], got["splits"]["test"]).size > 0
    assert got["history"][0]["train_loss"] == pytest.approx(want["history"][0]["train_loss"],
                                                            rel=1e-5)
