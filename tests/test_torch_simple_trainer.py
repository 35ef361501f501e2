"""The port's ``MultitaskTrainer`` against the JAX package's, on the CPU.

- five ``train_step``s in float64 of a tiny ``SigmoidFusionFull`` (demo
  BERT, lab encoder, gates) against the JAX trainer with
  ``deterministic_forward=True`` on the same weights and batches, with Adam,
  AdamW (weight decay 0) and the clip at 1.0, and a ``set_lr`` after step 2:
  per-step loss rel 1e-8, every parameter atol 1e-9 rtol 1e-6;
- ``loss_extras``: the same five f64 steps with a hook that adds a term of
  the outputs and one of the parameters (the JAX hook reads the parameter
  tree, the port's the module), train and eval losses rel 1e-8;
- ``masked_task_loss`` (BCE and focal, pad rows) against the JAX function;
- a three-epoch ``fit`` that stops early: history, learning rates, the
  printed lines and the best state (the first epoch's, not the last) equal
  the JAX run's; ``predict`` returns the real rows and the extra keys.
"""

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairmultimodal_torch.data.loader import BatchIterator, NestedLoader
from fairmultimodal_torch.data.prefetch import to_device
from fairmultimodal_torch.models.baselines import SigmoidFusionFull as TSig
from fairmultimodal_torch.train import simple as t_simple
from fairmultimodal_tpu.data.loader import BatchIterator as JBatchIterator
from fairmultimodal_tpu.models.baselines import SigmoidFusionFull as JSig
from fairmultimodal_tpu.pipelines.common import NestedLoader as JNestedLoader
from fairmultimodal_tpu.train import simple as j_simple

H, LABS, TEXT, B = 16, 10, 12, 8
N_AGE, N_GEN, N_ETH, N_INS = 4, 2, 5, 6
GEO = dict(num_ages=N_AGE, num_genders=N_GEN, num_ethnicities=N_ETH, num_insurances=N_INS,
           lab_token_count=LABS, hidden_size=H, demo_layers=1, demo_heads=2, lab_layers=1,
           lab_heads=2, fusion_hidden=8)
POS_W = np.array([2.0, 0.5, 3.0], np.float32)
KEYS = ("demo_dummy_ids", "demo_attn_mask", "age_ids", "gender_ids", "ethnicity_ids",
        "insurance_ids", "lab_features", "text_embedding")


def _arrays(rng, n, dtype=np.float64):
    return {
        "demo_dummy_ids": np.zeros((n, 1), np.int32),
        "demo_attn_mask": np.ones((n, 1), np.int32),
        "age_ids": rng.integers(0, N_AGE, n).astype(np.int32),
        "gender_ids": rng.integers(0, N_GEN, n).astype(np.int32),
        "ethnicity_ids": rng.integers(0, N_ETH, n).astype(np.int32),
        "insurance_ids": rng.integers(0, N_INS, n).astype(np.int32),
        "lab_features": rng.normal(0, 1, (n, LABS)).astype(dtype),
        "text_embedding": rng.normal(0, 1, (n, TEXT)).astype(dtype),
        "labels": rng.integers(0, 2, (n, 3)).astype(dtype),
    }


def _batches(seed, count):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        a = _arrays(rng, B)
        out.append({"model_inputs": {k: a[k] for k in KEYS}, "labels": a["labels"],
                    "weight": np.ones(B, np.float64)})
    out[-1]["weight"][-3:] = 0          # a padded tail
    return out


def _f64_state(params, prefix=""):
    """Flax params -> the port's state-dict names in float64."""
    out = {}
    for key, val in params.items():
        if isinstance(val, dict):
            out.update(_f64_state(val, f"{prefix}{key}."))
            continue
        arr = np.asarray(val, np.float64)
        out[prefix + ("weight" if key in ("kernel", "embedding", "scale") else key)] = (
            arr.T if key == "kernel" else arr)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _pair(cfg_kwargs, example, dtype=jnp.float64, extras=(None, None)):
    jcfg = j_simple.SimpleTrainConfig(rng_impl="threefry", deterministic_forward=True,
                                      **cfg_kwargs)
    jt = j_simple.MultitaskTrainer(JSig(**GEO, dtype=dtype), jcfg, pos_weight=POS_W,
                                   loss_extras=extras[0])
    params = jt.init_params({"model_inputs": jax.tree_util.tree_map(jnp.asarray, example)})
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64 if dtype == jnp.float64
                                                         else np.float32), params)
    tdt = torch.float64 if dtype == jnp.float64 else torch.float32
    tm = TSig(**GEO, text_embed_size=TEXT, dtype=tdt).to(tdt)
    tm.load_state_dict({k: v.to(tdt) for k, v in _f64_state(params).items()})
    tt = t_simple.MultitaskTrainer(tm, t_simple.SimpleTrainConfig(deterministic_forward=True,
                                                                  **cfg_kwargs),
                                   pos_weight=POS_W, device="cpu", loss_extras=extras[1])
    return jt, params, tt


def _jax_extras(params, out, batch):
    w = batch["weight"][:, None]
    return (0.3 * jnp.sum(out["aggregated"] ** 2 * w) / jnp.maximum(jnp.sum(w), 1.0)
            + 0.05 * jnp.sum(params["fusion"]["classifier"]["kernel"] ** 2))


def _port_extras(model, out, batch):
    w = batch["weight"][:, None]
    return (0.3 * (out["aggregated"] ** 2 * w).sum() / torch.clamp(w.sum(), min=1.0)
            + 0.05 * (model.fusion.classifier.weight ** 2).sum())


@pytest.mark.parametrize("optimizer,grad_clip,loss,extras", [
    ("adam", None, "focal", False), ("adamw", 1.0, "bce", False),
    ("adamw", None, "focal", False), ("adam", 1.0, "focal", True)])
def test_five_train_steps_match_the_jax_trainer_f64(optimizer, grad_clip, loss, extras):
    host = _batches(3, 2)
    kw = dict(lr=1e-2, optimizer=optimizer, grad_clip=grad_clip, loss=loss, gamma=2.0,
              batch_size=B)
    with jax.enable_x64(True):
        jt, params, tt = _pair(kw, host[0]["model_inputs"],
                               extras=(_jax_extras, _port_extras) if extras else (None, None))
        params = jax.tree_util.tree_map(jnp.asarray, params)
        opt_state = jt.tx.init(params)
        tt.init()
        for step in range(5):
            if step == 2:
                opt_state = jt.set_lr(opt_state, 3e-3)
                tt.set_lr(3e-3)
            batch = host[step % 2]
            params, opt_state, jl = jt._train_step(
                params, opt_state, jax.tree_util.tree_map(jnp.asarray, batch),
                jax.random.key(0, impl="threefry2x32"))
            tl = tt.train_step(to_device(batch, tt.device))
            assert float(tl) == pytest.approx(float(jl), rel=1e-8), step
        if extras:      # the eval loss carries the hook too
            jel, _ = jt._eval_step(params, jax.tree_util.tree_map(jnp.asarray, host[1]))
            tt.model.eval()
            with torch.no_grad():
                tel, _ = tt._loss(to_device(host[1], tt.device), None)
            assert float(tel) == pytest.approx(float(jel), rel=1e-8)
            tt.loss_extras = None
            with torch.no_grad():
                assert float(tt._loss(to_device(host[1], tt.device), None)[0]) < float(tel)
        want = _f64_state(jax.tree_util.tree_map(np.asarray, params))
        for name, p in tt.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6,
                                       atol=1e-9, err_msg=name)


@pytest.mark.parametrize("loss", ["bce", "focal"])
def test_masked_task_loss_matches_jax(loss):
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 2, (10, 3)).astype(np.float32)
    labels = rng.integers(0, 2, (10, 3)).astype(np.float32)
    weight = np.ones(10, np.float32)
    weight[-4:] = 0
    want = j_simple.masked_task_loss(jnp.asarray(logits), jnp.asarray(labels),
                                     jnp.asarray(weight), loss=loss, gamma=2.0,
                                     pos_weight=jnp.asarray(POS_W))
    got = t_simple.masked_task_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                    torch.from_numpy(weight), loss=loss, gamma=2.0,
                                    pos_weight=torch.from_numpy(POS_W))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    # Pad rows change nothing: the real rows alone give the same loss.
    alone = t_simple.masked_task_loss(*(torch.from_numpy(a[:6]) for a in (logits, labels,
                                                                          weight)),
                                      loss=loss, gamma=2.0, pos_weight=torch.from_numpy(POS_W))
    assert float(alone) == pytest.approx(float(got), rel=1e-6)


def test_fit_stops_early_and_keeps_the_best_state_as_jax_does():
    # Every train label is 1 and every validation label 0 (the same rows): as
    # training raises the logits, the validation loss rises after epoch 1.
    train = _arrays(np.random.default_rng(5), 24)
    train["labels"][:] = 1.0
    val = dict(train, labels=np.zeros_like(train["labels"]))
    kw = dict(lr=0.02, num_epochs=3, patience=1, batch_size=B, optimizer="adam", loss="focal")

    def loaders(bi, nl):
        return (nl(bi(dict(train), B, shuffle=True, seed=1), KEYS),
                nl(bi(dict(val), B), KEYS))

    with jax.enable_x64(True):
        jt, params, tt = _pair(kw, {k: v[:B] for k, v in train.items() if k in KEYS})
        buf = io.StringIO()
        with redirect_stdout(buf):
            j_best, j_hist = jt.fit(jax.tree_util.tree_map(jnp.asarray, params),
                                    *loaders(JBatchIterator, JNestedLoader))
        j_out = buf.getvalue()
        j_pred = jt.predict(j_best, JNestedLoader(JBatchIterator(dict(val), B), KEYS))
    buf = io.StringIO()
    with redirect_stdout(buf):
        t_best, t_hist = tt.fit(*loaders(BatchIterator, NestedLoader))
    t_out = buf.getvalue()

    assert "Early stopping triggered." in j_out and len(j_hist) < 3
    assert t_out.splitlines() == j_out.splitlines()
    assert len(t_hist) == len(j_hist)
    for g, w in zip(t_hist, j_hist):
        assert g["train_loss"] == pytest.approx(w["train_loss"], rel=1e-8)
        assert g["val_loss"] == pytest.approx(w["val_loss"], rel=1e-8)
        assert g["lr"] == w["lr"]
    want = _f64_state(jax.tree_util.tree_map(np.asarray, j_best))
    for name, v in t_best.items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=name)
    # The best state is the first epoch's, not the trained-on last state.
    assert any(not torch.equal(v, t_best[k]) for k, v in tt.model.state_dict().items())

    tt.model.load_state_dict(t_best)
    pred = tt.predict(NestedLoader(BatchIterator(dict(val), B), KEYS),
                      extra_keys=("age_ids", "insurance_ids"))
    assert pred["logits"].shape == (24, 3)
    np.testing.assert_array_equal(pred["labels"], val["labels"])
    np.testing.assert_array_equal(pred["insurance_ids"], val["insurance_ids"])
    np.testing.assert_allclose(pred["logits"], j_pred["logits"], rtol=1e-6, atol=1e-9)
