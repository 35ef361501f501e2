"""06 FairEHR-CLP against the JAX package (CPU, fp32).

- ``contrastive_loss`` with and without ``weight`` (pad rows, no real row)
  within 1e-6;
- the convolution: flax's ``nn.Conv(kernel_size=(3,), padding="SAME")`` on
  the same weights (``interop`` carries the [3, in, out] kernel across as
  ``nn.Conv1d``'s [out, in, 3]) within 1e-5, and the same as
  ``torch.nn.functional.conv1d`` on the [B, E, F] transpose; the weight
  round-trips through ``flax_params``;
- ``LongitudinalEncoder`` and ``FairEHRCLP`` (its real widths: H 256, FFN
  512) from the JAX modules' weights, the JAX encoder layers' FFN on the
  Pallas kernel in interpret mode (its gate opened as on a TPU; the
  attention gate stays shut, as at 549 features): outputs within 1e-5,
  grads within 1e-4; with and without the synthetic views;
- ``synthesize_demographics`` / ``synthesize_longitudinal``: the noise's
  scale, and one generator seed gives one draw;
- ``run_fairehr_clp_experiment`` end to end in both modes against the JAX
  pipeline: the splits and weights exactly, the synthetic views bit for bit
  (the JAX ``DeviceLoader.add_arrays`` calls recorded), per-epoch losses 1e-5
  relative, test logits 1e-4, the printed lines.
"""

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from test_torch_baseline_pipelines import (_recording, _shape, encoders,  # noqa: F401
                                           frames)
from test_torch_baselines import _check

from fairmultimodal_torch.interop import flax_params, load_flax_params, state_dict_from_flax
from fairmultimodal_torch.models import fairehr as t_fe
from fairmultimodal_torch.pipelines import common as t_common
from fairmultimodal_torch.pipelines import fairehr_clp as t_clp
from fairmultimodal_tpu.data import device as j_device
from fairmultimodal_tpu.models import behrt as j_behrt
from fairmultimodal_tpu.models import fairehr as j_fe
from fairmultimodal_tpu.pipelines import fairehr_clp as j_clp
from fairmultimodal_tpu.train import simple as j_simple

B, FEATS, TEXT = 2, 10, 24


@pytest.fixture
def pallas_ffn(monkeypatch):
    """The JAX encoder layers' FFN on the Pallas kernel (interpret mode off
    the TPU); the attention gate shut, as the card's at 549 features."""
    monkeypatch.setattr(j_behrt, "can_use_fused_attention_block", lambda x, nh: False)
    monkeypatch.setattr(j_behrt, "can_use_fused_ffn", lambda x, h, f: True)


@pytest.mark.parametrize("pad", [None, 0, 2, 6])
def test_contrastive_loss_matches_jax(pad):
    rng = np.random.default_rng(20 + (pad or 0))
    e_real, e_syn = (rng.normal(0, 1, (6, 16)).astype(np.float32) for _ in range(2))
    weight = None
    if pad is not None:
        weight = np.ones(6, np.float32)
        weight[6 - pad:] = 0
        e_real[6 - pad:] = 0          # pad rows carry zeros, as the loaders pad them
    kw = dict(tau=0.5, gamma=0.1)
    want = j_fe.contrastive_loss(jnp.asarray(e_real), jnp.asarray(e_syn),
                                 weight=None if weight is None else jnp.asarray(weight), **kw)
    got = t_fe.contrastive_loss(torch.from_numpy(e_real), torch.from_numpy(e_syn),
                                weight=None if weight is None else torch.from_numpy(weight),
                                **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)
    assert np.isfinite(float(got))


def test_conv_is_flax_same_conv_on_the_interop_weights():
    rng = np.random.default_rng(21)
    x = rng.normal(0, 1, (2, 7, 6)).astype(np.float32)
    conv = nn.Conv(5, kernel_size=(3,), padding="SAME")
    params = jax.tree_util.tree_map(np.asarray, conv.init(jax.random.PRNGKey(1), x)["params"])
    want = np.asarray(conv.apply({"params": params}, x))
    t_conv = torch.nn.Conv1d(6, 5, 3)
    t_conv.load_state_dict(state_dict_from_flax(params))
    got = t_fe.conv1d_same(torch.from_numpy(x), t_conv, torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    direct = torch.nn.functional.conv1d(torch.from_numpy(x).transpose(1, 2), t_conv.weight,
                                        t_conv.bias, padding=1).transpose(1, 2)
    np.testing.assert_allclose(got.detach().numpy(), direct.detach().numpy(), rtol=1e-6,
                               atol=1e-6)
    back = flax_params(t_conv)
    np.testing.assert_array_equal(back["kernel"], params["kernel"])
    np.testing.assert_array_equal(back["bias"], params["bias"])


@pytest.mark.parametrize("pallas", [True, False])
def test_longitudinal_encoder_matches_jax(pallas, monkeypatch):
    monkeypatch.setattr(j_behrt, "can_use_fused_attention_block", lambda x, nh: False)
    monkeypatch.setattr(j_behrt, "can_use_fused_ffn", lambda x, h, f: pallas)
    x = np.random.default_rng(22).normal(0, 1, (B, FEATS)).astype(np.float32)
    kw = dict(embed_dim=64, conv_out=128, num_heads=2, num_layers=2, ffn=256)
    params = _check(j_fe.LongitudinalEncoder(**kw), t_fe.LongitudinalEncoder(**kw), (x,))
    assert params["conv"]["kernel"].shape == (3, 64, 128)


def _clp_inputs(seed, syn):
    rng = np.random.default_rng(seed)
    out = {"demo_features": rng.integers(0, 5, (B, 4)).astype(np.float32),
           "lab_features": rng.normal(0, 1, (B, FEATS)).astype(np.float32),
           "text_embedding": rng.normal(0, 1, (B, TEXT)).astype(np.float32)}
    if syn:
        out["demo_features_syn"] = out["demo_features"] + 0.05 * rng.normal(
            0, 1, (B, 4)).astype(np.float32)
        out["lab_features_syn"] = out["lab_features"] + 0.01 * rng.normal(
            0, 1, (B, FEATS)).astype(np.float32)
    return out


@pytest.mark.parametrize("syn", [True, False])
def test_fairehr_clp_matches_jax(syn, pallas_ffn):
    params = _check(j_fe.FairEHRCLP(), t_fe.FairEHRCLP(text_embed_size=TEXT),
                    _clp_inputs(23, syn))
    assert set(params) == {"demo_encoder", "long_encoder", "notes_encoder", "fusion", "dr",
                           "classifier_hidden", "classifier"}
    np.testing.assert_array_equal(params["dr"]["weights"], np.ones(256, np.float32))


def test_fairehr_clp_init_and_train_mode():
    """The port's own init keeps the gate at ones; train mode with a
    generator drops (logits differ), without one it does not."""
    from fairmultimodal_torch.models._layers import init_params

    model = init_params(t_fe.FairEHRCLP(text_embed_size=TEXT), seed=0)
    assert torch.equal(model.dr.weights, torch.ones(256))
    batch = {k: torch.from_numpy(v) for k, v in _clp_inputs(24, True).items()}
    model.train()
    plain = model(batch)["logits"]
    dropped = model(batch, generator=torch.Generator().manual_seed(1))["logits"]
    assert not torch.equal(plain, dropped)
    assert torch.equal(plain, model.eval()(batch)["logits"])


def test_synthesized_views_have_the_noise_scale():
    demo = torch.zeros(4000, 4)
    g = torch.Generator().manual_seed(3)
    d = t_fe.synthesize_demographics(g, demo)
    lab = t_fe.synthesize_longitudinal(g, torch.ones(4000, 8))
    assert d.shape == demo.shape and d.dtype == torch.float32
    assert float(d.std()) == pytest.approx(0.05, rel=0.03)
    assert float((lab - 1).std()) == pytest.approx(0.01, rel=0.03)
    again = t_fe.synthesize_demographics(torch.Generator().manual_seed(3), demo)
    assert torch.equal(d, again)


SMALL = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2, text_max_length=32,
             text_batch_size=16)


def _run_pair(frames, encoders, monkeypatch, contrastive):  # noqa: F811
    calls, init, added = {"jax": {}, "port": {}}, {}, []
    original = j_simple.MultitaskTrainer.init_params
    original_add = j_device.DeviceLoader.add_arrays

    def init_params(self, example):
        params = original(self, example)
        init["params"] = jax.tree_util.tree_map(np.array, params)     # the step donates
        return params

    def add_arrays(self, extra):
        added.append({k: np.array(v) for k, v in extra.items()})
        return original_add(self, extra)

    def config(module, **train):
        cfg = module.FairEHRCLPPipelineConfig(**SMALL, contrastive=contrastive)
        cfg.train.num_epochs, cfg.train.deterministic_forward = 2, True
        for k, v in train.items():
            setattr(cfg.train, k, v)
        return cfg

    mp = pytest.MonkeyPatch()
    _recording(mp, j_clp, calls["jax"])
    mp.setattr(j_simple.MultitaskTrainer, "init_params", init_params)
    mp.setattr(j_device.DeviceLoader, "add_arrays", add_arrays)
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            want = j_clp.run_fairehr_clp_experiment(
                *frames, config(j_clp, rng_impl="threefry"), text_encoder=encoders[0])
    finally:
        mp.undo()
    j_out = buf.getvalue()

    _recording(monkeypatch, t_common, calls["port"])
    monkeypatch.setattr(t_clp, "init_params",
                        lambda model, seed: load_flax_params(model, init["params"]))
    buf = io.StringIO()
    with redirect_stdout(buf):
        got = t_clp.run_fairehr_clp_experiment(*frames, config(t_clp),
                                               text_encoder=encoders[1], device="cpu")
    return want, j_out, got, buf.getvalue(), calls, added


@pytest.mark.parametrize("contrastive", [False, True])
def test_pipeline_matches_jax(contrastive, frames, encoders, monkeypatch):  # noqa: F811
    want, j_out, got, t_out, calls, added = _run_pair(frames, encoders, monkeypatch,
                                                      contrastive)
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(got["prep"].idx[split], want["prep"].idx[split])
    np.testing.assert_array_equal(got["prep"].pos_weight, want["prep"].pos_weight)
    assert len(got["history"]) == len(want["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        assert g["train_loss"] == pytest.approx(w["train_loss"], rel=1e-5), (g, w)
        assert g["val_loss"] == pytest.approx(w["val_loss"], rel=1e-5), (g, w)
        assert g["lr"] == w["lr"]
    (t_logits, t_labels, t_sens), (j_logits, j_labels, j_sens) = (
        c["evaluate_multitask"][:3] for c in (calls["port"], calls["jax"]))
    np.testing.assert_allclose(t_logits, j_logits, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(t_labels, j_labels)
    for k in j_sens:
        np.testing.assert_array_equal(t_sens[k], j_sens[k])
    assert _shape(t_out) == _shape(j_out)

    model = got["trainer"].model
    if not contrastive:
        assert added == [] and type(model).__name__ == "StructTextModel"
        return
    assert isinstance(model, t_fe.FairEHRCLP) and got["trainer"].loss_extras is not None
    views = t_clp.synthetic_views(got["prep"].arrays, got["prep"].idx, 42)
    assert len(added) == 3
    for split, jax_view in zip(("train", "val", "test"), added):
        assert set(jax_view) == set(views[split]) == {"demo_features_syn", "lab_features_syn"}
        loader = got["prep"].loaders[split]
        for k, v in jax_view.items():
            np.testing.assert_array_equal(views[split][k], v)
            np.testing.assert_array_equal(loader._data[k].numpy(), v)
    # The contrastive term is in the loss: without it the first batch's
    # loss is smaller.
    batch = next(iter(got["prep"].loaders["val"]))
    trainer = got["trainer"]
    with torch.no_grad():
        with_extra = float(trainer._loss(batch, None)[0])
        trainer.loss_extras = None
        assert float(trainer._loss(batch, None)[0]) < with_extra
