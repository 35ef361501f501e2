"""The five baseline pipelines end to end against the JAX package's (CPU,
fp32, tiny widths).

01 behrt, 02 text-only, 07 average fusion, 09 sigmoid fusion and 08 EDDI
fusion run on one synthetic cohort in both packages, each for two epochs at
batch 16 with its own loss, optimizer and learning rate, with the same tiny
text encoder (the JAX one's weights,
converted), the train forward without dropout (``deterministic_forward``;
for 08, whose JAX runner has no such hook, the JAX loss is called in
inference mode) and the JAX run's initial weights (the port pipeline's
``init_params`` is replaced by a load of them).  Checked: the splits and
positive-class weights exactly, the per-epoch losses to 1e-5 relative, the
learning rates exactly, the test logits to 1e-4 with the labels and groups
exactly, 08's fusion weights to 1e-6, 07's extracted embeddings to 1e-4,
and the printed lines with every digit run collapsed.

01 runs at the command line's tiny width (64): at 32, with its fixed 8
heads of width 4, Adam's first updates (lr * sign(g)) flip on gradients
that sit at fp32 rounding noise, and the test logits drift 1.4e-4 apart in
two epochs; ``tests/test_torch_simple_trainer.py`` holds the arithmetic in
float64.

Also: 01 runs without an unstructured table (the JAX function raises
there), 09's ``reference_compat`` age bucket, and 02's readmission regime.
"""

import dataclasses
import io
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fairmultimodal_torch.interop import load_flax_params
from fairmultimodal_torch.models import bert as t_bert
from fairmultimodal_torch.models import text as t_text
from fairmultimodal_torch.pipelines import average_fusion as t_avg
from fairmultimodal_torch.pipelines import behrt as t_behrt
from fairmultimodal_torch.pipelines import common as t_common
from fairmultimodal_torch.pipelines import eddi_fusion as t_eddi
from fairmultimodal_torch.pipelines import sigmoid_fusion as t_sig
from fairmultimodal_torch.pipelines import text_only as t_text_only
from fairmultimodal_tpu.data.synthetic import make_common_frames
from fairmultimodal_tpu.models import bert as j_bert
from fairmultimodal_tpu.models import text as j_text
from fairmultimodal_tpu.pipelines import average_fusion as j_avg
from fairmultimodal_tpu.pipelines import behrt as j_behrt
from fairmultimodal_tpu.pipelines import eddi_fusion as j_eddi
from fairmultimodal_tpu.pipelines import sigmoid_fusion as j_sig
from fairmultimodal_tpu.pipelines import text_only as j_text_only
from fairmultimodal_tpu.train import simple as j_simple

TEXT_CFG = dict(vocab_size=512, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=64, max_position_embeddings=64)
TEXT = dict(text_max_length=32, text_batch_size=16)
SMALL = dict(hidden_size=32, demo_layers=1, demo_heads=2, lab_layers=1, lab_heads=2, **TEXT)
#: pipeline -> (JAX module, port module, config overrides, port-only overrides)
PIPELINES = {
    "behrt": (j_behrt, t_behrt, dict(hidden_size=64)),
    "text_only": (j_text_only, t_text_only, dict(TEXT)),
    "average_fusion": (j_avg, t_avg, dict(hidden_size=32, num_hidden_layers=1,
                                          num_attention_heads=2, **TEXT)),
    "sigmoid_fusion": (j_sig, t_sig, dict(SMALL)),
    "eddi_fusion": (j_eddi, t_eddi, dict(SMALL)),
}
RUNNERS = {"behrt": "run_behrt_experiment", "text_only": "run_text_only_experiment",
           "average_fusion": "run_average_fusion_experiment",
           "sigmoid_fusion": "run_sigmoid_fusion_experiment",
           "eddi_fusion": "run_eddi_fusion_experiment"}
CONFIGS = {"behrt": "BEHRTPipelineConfig", "text_only": "TextOnlyPipelineConfig",
           "average_fusion": "AverageFusionPipelineConfig",
           "sigmoid_fusion": "SigmoidFusionPipelineConfig",
           "eddi_fusion": "EDDIFusionPipelineConfig"}
TRAIN = dict(num_epochs=2, deterministic_forward=True)


@pytest.fixture(scope="module")
def frames():
    return make_common_frames(n_patients=160, n_lab_features=12, seed=3)


@pytest.fixture(scope="module")
def encoders():
    cfg = j_bert.BertConfig(**TEXT_CFG)
    params = jax.jit(j_bert.BertEncoderModel(cfg).init)(
        jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params["params"]))
    return (j_text.TextEncoder(cfg, params, j_text.HashingTokenizer(cfg.vocab_size)),
            t_text.TextEncoder.from_params(params, t_bert.BertConfig(**TEXT_CFG), device="cpu"))


def _config(module, name, overrides, jax_side):
    cfg = getattr(module, CONFIGS[name])(**overrides)
    cfg.train = dataclasses.replace(cfg.train, **TRAIN,
                                    **({"rng_impl": "threefry"} if jax_side else {}))
    return cfg


def _recording(mp, module, calls):
    for fn in ("evaluate_multitask", "eddi_report"):
        original = getattr(module, fn)

        def wrapped(*args, _fn=fn, _original=original, **kwargs):
            calls[_fn] = args
            return _original(*args, **kwargs)

        mp.setattr(module, fn, wrapped)


def _run_jax(name, frames, encoders, overrides=None, unstructured=True):
    """The JAX pipeline: (result, stdout, recorded report calls, init params)."""
    j_mod, _, geo = PIPELINES[name]
    calls, init = {}, {}
    mp = pytest.MonkeyPatch()
    _recording(mp, j_mod, calls)
    if name == "eddi_fusion":
        base = j_eddi.EDDIFusionFull

        class Recording(base):
            def init(self, *args, **kwargs):
                out = super().init(*args, **kwargs)
                init["params"] = jax.tree_util.tree_map(np.array, out["params"])
                return out

        make_loss = j_eddi.make_eddi_fusion_loss

        def inference_loss(*args, **kwargs):
            loss_fn = make_loss(*args, **kwargs)
            return lambda params, batch, w_prev, rng, train: loss_fn(params, batch, w_prev,
                                                                     rng, False)

        mp.setattr(j_eddi, "EDDIFusionFull", Recording)
        mp.setattr(j_eddi, "make_eddi_fusion_loss", inference_loss)
    else:
        original = j_simple.MultitaskTrainer.init_params

        def init_params(self, example):
            params = original(self, example)
            init["params"] = jax.tree_util.tree_map(np.array, params)
            return params

        mp.setattr(j_simple.MultitaskTrainer, "init_params", init_params)
    cfg = _config(j_mod, name, dict(geo, **(overrides or {})), jax_side=True)
    kwargs = {} if name == "behrt" else {"text_encoder": encoders[0]}
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            out = getattr(j_mod, RUNNERS[name])(frames[0], frames[1] if unstructured else None,
                                                cfg, **kwargs)
    finally:
        mp.undo()
    return out, buf.getvalue(), calls, init["params"]


def _run_port(name, frames, encoders, init, monkeypatch, overrides=None, unstructured=True):
    _, t_mod, geo = PIPELINES[name]
    calls = {}
    _recording(monkeypatch, t_common if name != "eddi_fusion" else t_eddi, calls)
    if init is not None:
        monkeypatch.setattr(t_mod, "init_params",
                            lambda model, seed: load_flax_params(model, init))
    cfg = _config(t_mod, name, dict(geo, **(overrides or {})), jax_side=False)
    kwargs = {} if name == "behrt" else {"text_encoder": encoders[1]}
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = getattr(t_mod, RUNNERS[name])(frames[0], frames[1] if unstructured else None,
                                            cfg, device="cpu", **kwargs)
    return out, buf.getvalue(), calls


def _shape(text):
    return [re.sub(r"\d+", "#", re.sub(r"Saved fused embeddings to .*", "Saved", line))
            for line in text.splitlines()]


@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipeline_matches_jax(name, frames, encoders, tmp_path, monkeypatch):
    overrides = {"out_dir": str(tmp_path / "jax")} if name == "average_fusion" else None
    want, j_stdout, j_calls, init = _run_jax(name, frames, encoders, overrides)
    if overrides:
        overrides = {"out_dir": str(tmp_path / "port")}
    got, t_stdout, t_calls = _run_port(name, frames, encoders, init, monkeypatch, overrides)

    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(got["prep"].idx[split], want["prep"].idx[split])
    np.testing.assert_array_equal(got["prep"].pos_weight, want["prep"].pos_weight)
    np.testing.assert_array_equal(got["prep"].bundle.labels, want["prep"].bundle.labels)

    assert len(got["history"]) == len(want["history"]) == TRAIN["num_epochs"]
    for g, w in zip(got["history"], want["history"]):
        assert g["train_loss"] == pytest.approx(w["train_loss"], rel=1e-5), (g, w)
        assert g["val_loss"] == pytest.approx(w["val_loss"], rel=1e-5), (g, w)
        if "lr" in w:
            assert g["lr"] == w["lr"]
        if "weights" in w:
            np.testing.assert_allclose(g["weights"], w["weights"], rtol=0, atol=1e-6)

    t_logits, t_labels, t_sens = t_calls["evaluate_multitask"][:3]
    j_logits, j_labels, j_sens = j_calls["evaluate_multitask"][:3]
    np.testing.assert_allclose(t_logits, j_logits, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(t_labels, j_labels)
    for k in j_sens:
        np.testing.assert_array_equal(t_sens[k], j_sens[k])
    if name == "eddi_fusion":
        np.testing.assert_allclose(got["weights"], want["weights"], rtol=0, atol=1e-6)
    if name == "average_fusion":
        with np.load(want["artifacts"]["extracted_embeddings"]) as jz, \
                np.load(got["artifacts"]["extracted_embeddings"]) as tz:
            assert sorted(tz.files) == sorted(jz.files) == ["embeddings", "labels"]
            n = sum(len(got["prep"].idx[s]) for s in ("train", "val", "test"))
            assert tz["embeddings"].shape == jz["embeddings"].shape == (n, 2 * 256)
            np.testing.assert_allclose(tz["embeddings"], jz["embeddings"], rtol=0, atol=1e-4)
            np.testing.assert_array_equal(tz["labels"], jz["labels"])
    assert _shape(t_stdout) == _shape(j_stdout)
    assert {k for k in want if k != "trainer"} <= set(got)


def test_behrt_runs_without_an_unstructured_table(frames, encoders, monkeypatch):
    """01 keeps patients without notes, so the structured table alone is its
    cohort.  The JAX function raises there: its check asks for note columns."""
    with pytest.raises(Exception, match="note_"):
        _run_jax("behrt", frames, encoders, unstructured=False)
    alone, _, calls = _run_port("behrt", frames, encoders, None, monkeypatch,
                                unstructured=False)
    both, _, _ = _run_port("behrt", frames, encoders, None, monkeypatch)
    assert alone["prep"].bundle.num_patients == len(frames[0])
    np.testing.assert_array_equal(alone["prep"].bundle.labs, both["prep"].bundle.labs)
    assert alone["history"][-1]["val_loss"] == both["history"][-1]["val_loss"]


def test_sigmoid_reference_compat_and_readmission_regime(frames, encoders, monkeypatch):
    """09's ``reference_compat`` is the 70-90 age bucket in both packages;
    02's readmission regime trains one head on ``readmission_within_30d``."""
    want, _, _, _ = _run_jax("sigmoid_fusion", frames, encoders, {"reference_compat": True})
    got, _, _ = _run_port("sigmoid_fusion", frames, encoders, None, monkeypatch,
                          {"reference_compat": True})
    np.testing.assert_array_equal(got["prep"].bundle.age_codes,
                                  want["prep"].bundle.age_codes)
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(got["prep"].idx[split], want["prep"].idx[split])

    got, _, calls = _run_port("text_only", frames, encoders, None, monkeypatch,
                              {"task": "readmission"})
    s = frames[0].set_index("subject_id").loc[got["prep"].bundle.subject_id]
    np.testing.assert_array_equal(got["prep"].bundle.labels[:, 0],
                                  s["readmission_within_30d"].to_numpy(np.float32))
    assert calls["evaluate_multitask"][0].shape[1] == 1
    assert list(got["metrics"]) == ["readmission"]
