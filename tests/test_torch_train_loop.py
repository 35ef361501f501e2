"""The port's FAME trainer against the JAX package's, on the CPU.

- six ``train_step``s in float64 of the port's ``FAMETrainer`` against the
  JAX ``FAMETrainer`` with ``deterministic_forward=True`` on the same weights
  and batches, with a learning-rate decay at step 3: per-step loss rel 1e-8,
  every parameter atol 1e-9 rtol 1e-6 and the loss-free heads bit-identical
  to init -- the tolerances of
  ``test_e2e_torch_parity.py::test_fame_optimizer_trajectory_matches_torch``,
  whose torch oracle the port's update chain (torch clip + AdamW) is;
- a three-epoch ``fit``: history, learning-rate decays and the dynamic-weight
  trajectory (f64, 1e-8);
- the losses and the EDDI functions against the JAX ones, including absent
  groups and padded rows;
- the scheduler and early stopper on one val-loss sequence;
- dropout-on training: the same generator seed gives the same parameters,
  another seed other ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairmultimodal_torch.data.loader import BatchIterator, NestedLoader
from fairmultimodal_torch.data.prefetch import to_device
from fairmultimodal_torch.fairness import eddi as t_eddi
from fairmultimodal_torch.fairness.loss import eddi_loss as t_eddi_loss
from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.fusion import FAMEModel as TFAME
from fairmultimodal_torch.ops.losses import bce_with_logits as t_bce
from fairmultimodal_torch.ops.losses import focal_loss as t_focal
from fairmultimodal_torch.train import loop as tloop
from fairmultimodal_tpu.fairness import eddi as j_eddi
from fairmultimodal_tpu.fairness.loss import eddi_loss as j_eddi_loss
from fairmultimodal_tpu.models.fusion import FAMEModel as JFAME
from fairmultimodal_tpu.ops.losses import bce_with_logits as j_bce
from fairmultimodal_tpu.ops.losses import focal_loss as j_focal
from fairmultimodal_tpu.train import loop as jloop

H, NH, LAYERS, LABS, TEXT, B = 32, 4, 2, 20, 12, 8
N_AGE, N_GEN, N_ETH, N_INS = 4, 2, 5, 6
POS_W = np.array([2.0, 0.5, 3.0], np.float32)
HEADS = ("classifier_demo", "classifier_lab", "classifier_text")
GEO = dict(num_ages=N_AGE, num_genders=N_GEN, num_ethnicities=N_ETH, num_insurances=N_INS,
           lab_token_count=LABS, hidden_size=H, demo_layers=LAYERS, demo_heads=NH,
           lab_layers=2, lab_heads=NH)


def _inputs(rng, n):
    return {
        "demo_dummy_ids": np.ones((n, 1), np.int32),
        "demo_attn_mask": np.ones((n, 1), np.int32),
        "age_ids": rng.integers(0, N_AGE, n).astype(np.int32),
        "gender_ids": rng.integers(0, N_GEN, n).astype(np.int32),
        "ethnicity_ids": rng.integers(0, N_ETH, n).astype(np.int32),
        "insurance_ids": rng.integers(0, N_INS, n).astype(np.int32),
        "lab_features": rng.normal(0, 1, (n, LABS)),
        "text_embedding": rng.normal(0, 1, (n, TEXT)),
    }


def _batches(seed, count):
    rng = np.random.default_rng(seed)
    return [{"model_inputs": _inputs(rng, B),
             "labels": rng.integers(0, 2, (B, 3)).astype(np.float64),
             "weight": np.ones(B, np.float64)} for _ in range(count)]


def _flat_f64(tree, prefix=""):
    """Flax params -> the port's state-dict names in float64 (the mapping of
    ``interop.state_dict_from_flax`` without its fp32 cast)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat_f64(val, f"{prefix}{key}."))
            continue
        arr = np.asarray(val, np.float64)
        if key == "kernel":
            out[prefix + "weight"] = arr.T
        elif key in ("embedding", "scale"):
            out[prefix + "weight"] = arr
        else:
            out[prefix + key] = arr
    return out


def _pair(cfg_kwargs, example):
    """The JAX trainer with f64 params and the port's trainer on the same
    weights."""
    jm = JFAME(**GEO, dtype=jnp.float64)
    jcfg = jloop.TrainConfig(rng_impl="threefry", deterministic_forward=True, **cfg_kwargs)
    jt = jloop.FAMETrainer(jm, jcfg, pos_weight=POS_W)
    dev = jax.tree_util.tree_map(jnp.asarray, example)
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), jt.init_params(dev))
    # float64 leaves (the JAX init draws pos_embedding in f64 under x64) load
    # without interop's fp32 cast.
    tm = TFAME(**GEO, text_embed_size=TEXT, dtype=torch.float64).double()
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                        _flat_f64(jax.tree_util.tree_map(np.asarray, params)).items()})
    tt = tloop.FAMETrainer(tm, tloop.TrainConfig(deterministic_forward=True,
                                                          **cfg_kwargs),
                           pos_weight=POS_W, device="cpu")
    return jt, params, tt


def test_six_train_steps_match_the_jax_trainer_f64():
    host = _batches(7, 2)
    lr = 1e-3
    dyn_w = np.full((3, 3), 0.33, np.float32)
    with jax.enable_x64(True):
        jt, params, tt = _pair(dict(lr=lr, weight_decay=0.01, grad_clip=1.0, lambda_edd=0.8,
                                    lambda_l1=0.01, batch_size=B), host[0])
        heads0 = {k: v.clone() for k, v in tt.model.state_dict().items()
                  if k.split(".")[1] in HEADS}
        jheads0 = jax.tree_util.tree_map(np.asarray, {h: params["fusion"][h] for h in HEADS})
        opt_state = jt.init_opt_state(params)
        key = jax.random.key(0, impl="threefry2x32")
        for step in range(6):
            if step == 3:
                opt_state = jt.set_lr(opt_state, lr * 0.1)
                tt.set_lr(lr * 0.1)
            b = host[step % 2]
            params, opt_state, jtotal, _ = jt._train_step(
                params, opt_state, jax.tree_util.tree_map(jnp.asarray, b), jnp.asarray(dyn_w),
                key)
            ttotal, _ = tt.train_step(to_device(b, tt.device), dyn_w)
            assert float(ttotal) == pytest.approx(float(jtotal), rel=1e-8), f"step {step}"
        want = _flat_f64(jax.tree_util.tree_map(np.asarray, params))
    got = {k: v.detach().numpy() for k, v in tt.model.state_dict().items()}
    assert set(got) == set(want)
    for name, v in want.items():
        np.testing.assert_allclose(got[name], v, atol=1e-9, rtol=1e-6, err_msg=name)
    for k, v in heads0.items():
        assert torch.equal(tt.model.state_dict()[k], v), k
    for h in HEADS:
        for leaf in ("kernel", "bias"):
            assert np.array_equal(np.asarray(params["fusion"][h][leaf]), jheads0[h][leaf])


def test_three_epoch_fit_matches_the_jax_trainer_f64():
    train, val = _batches(11, 3), _batches(12, 2)
    cfg = dict(lr=1e-3, weight_decay=0.01, grad_clip=1.0, lambda_edd=0.8, lambda_l1=0.01,
               batch_size=B, num_epochs=3, patience=10, scheduler_factor=0.1,
               scheduler_patience=0, threshold=0.5, beta=1.0)
    with jax.enable_x64(True):
        jt, params, tt = _pair(cfg, train[0])
        dev = lambda bs: [jax.tree_util.tree_map(jnp.asarray, b) for b in bs]  # noqa: E731
        _, jhist = jt.fit(params, dev(train), dev(val), verbose=False)
    _, thist = tt.fit(train, val, verbose=False)
    assert len(thist) == len(jhist) == 3
    for e, (a, b) in enumerate(zip(thist, jhist)):
        for k in ("train_loss", "train_bce", "val_loss"):
            assert a[k] == pytest.approx(b[k], rel=1e-8), (e, k)
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-12), e
    assert [h["lr"] for h in thist] != [cfg["lr"]] * 3        # the scheduler decayed
    for task in tt.tracked_dynamic_weights:
        np.testing.assert_allclose(np.asarray(tt.tracked_dynamic_weights[task]),
                                   np.asarray(jt.tracked_dynamic_weights[task]),
                                   atol=1e-8, rtol=0, err_msg=task)
    np.testing.assert_allclose(tt.dynamic_weights, jt.dynamic_weights, atol=1e-8, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax_with_absent_groups_and_padded_rows(masked):
    rng = np.random.default_rng(3 + masked)
    n = 10
    logits = rng.normal(0, 2, (n, 3))
    labels = rng.integers(0, 2, (n, 3)).astype(np.float64)
    sens = [np.array([0, 0, 1, 1, 3, 3, 0, 1, 3, 0]),             # group 2 absent
            rng.integers(0, 5, n), np.full(n, 4)]                   # one group only
    weight = np.ones(n)
    if masked:
        weight[-3:] = 0.0                                          # a padded tail
        sens[0][-3:] = 2                                           # present only in pad rows
    with jax.enable_x64(True):
        jw = jnp.asarray(weight)
        want_bce = j_bce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(POS_W), jw)
        want_focal = j_focal(jnp.asarray(logits), jnp.asarray(labels), 2.0, 0.25,
                             jnp.asarray(POS_W), jw)
        probs = jax.nn.sigmoid(jnp.asarray(logits))
        want_eddi = j_eddi_loss(probs, jnp.asarray(labels), [jnp.asarray(s) for s in sens],
                                (4, 5, 6), weight=jw)
    tw = torch.from_numpy(weight)
    got_bce = t_bce(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(POS_W),
                    tw)
    got_focal = t_focal(torch.from_numpy(logits), torch.from_numpy(labels), 2.0, 0.25,
                        torch.from_numpy(POS_W), tw)
    got_eddi = t_eddi_loss(torch.sigmoid(torch.from_numpy(logits)), torch.from_numpy(labels),
                           [torch.from_numpy(s) for s in sens], (4, 5, 6), weight=tw)
    for got, want in ((got_bce, want_bce), (got_focal, want_focal), (got_eddi, want_eddi)):
        assert float(got) == pytest.approx(float(want), rel=1e-12)
    if masked:   # padded rows change nothing: the same loss on the real rows only
        keep = slice(0, n - 3)
        ragged = t_eddi_loss(torch.sigmoid(torch.from_numpy(logits[keep])),
                             torch.from_numpy(labels[keep]),
                             [torch.from_numpy(s[keep]) for s in sens], (4, 5, 6))
        assert float(ragged) == pytest.approx(float(got_eddi), rel=1e-12)


@pytest.mark.parametrize("variant", ["fame", "behrt", "prebinarized"])
def test_eddi_matches_jax(variant):
    rng = np.random.default_rng(9)
    n = 40
    y = rng.integers(0, 2, n)
    p = rng.random(n)
    sens = rng.choice([0, 1, 3], n)                       # code 2 absent
    kw = {"fame": dict(complete_groups=range(4)),
          "behrt": dict(divisor="total", empty_group_value=float("nan")),
          "prebinarized": dict(prebinarized=True)}[variant]
    yp = (p > 0.5).astype(int) if variant == "prebinarized" else p
    got, got_groups = t_eddi.compute_eddi(y, yp, sens, **kw)
    want, want_groups = j_eddi.compute_eddi(y, yp, sens, **kw)
    assert got == want and got_groups.keys() == want_groups.keys()
    # the trainer's path: device statistics (padded rows masked) -> host EDDI
    w = np.ones(n, np.float32)
    w[-5:] = 0.0
    counts, errors = t_eddi.subgroup_error_stats(
        torch.from_numpy(y).float(), torch.from_numpy((p > 0.5).astype(np.float32)),
        torch.from_numpy(sens), 4, weight=torch.from_numpy(w))
    real = slice(0, n - 5)
    jc, je = j_eddi.subgroup_error_stats(jnp.asarray(y[real], jnp.float32),
                                         jnp.asarray((p[real] > 0.5), jnp.float32),
                                         jnp.asarray(sens[real]), 4)
    assert np.array_equal(counts.numpy(), np.asarray(jc))
    assert np.array_equal(errors.numpy(), np.asarray(je))
    assert t_eddi.eddi_from_stats(counts.numpy(), errors.numpy()) == j_eddi.compute_eddi(
        y[real], p[real], sens[real], complete_groups=range(4))[0]
    assert t_eddi.combined_eddi(0.1, 0.2, 0.3) == j_eddi.combined_eddi(0.1, 0.2, 0.3)


def test_scheduler_and_early_stopper_match_jax():
    seq = [1.0, 0.9, 0.95, 0.9, 0.91, 0.92, 0.85, 0.86, 0.87, 0.88, 0.89, 0.9]
    js, ts = jloop.PlateauScheduler(1e-3, 0.1, 2), tloop.PlateauScheduler(1e-3, 0.1, 2)
    je, te = jloop.EarlyStopper(3), tloop.EarlyStopper(3)
    trace = []
    for v in seq:
        trace.append((ts.step(v), te.step(v), te.improved, te.counter))
        assert trace[-1] == (js.step(v), je.step(v), je.improved, je.counter)
    assert trace[-1][1] and min(t[0] for t in trace) < 1e-3


def _dropout_run(seed):
    rng = np.random.default_rng(5)
    n = 12
    arrays = _inputs(rng, n)
    arrays["labels"] = rng.integers(0, 2, (n, 3)).astype(np.float32)
    arrays = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in arrays.items()}
    model = init_params(TFAME(**GEO, text_embed_size=TEXT, fusion_hidden=16), seed=0)
    t = tloop.FAMETrainer(model, tloop.TrainConfig(lr=1e-3, batch_size=8), pos_weight=POS_W,
                          rngs_seed=seed, device="cpu")
    keys = [k for k in arrays if k != "labels"]
    t.train_epoch(NestedLoader(BatchIterator(arrays, 8, shuffle=True), keys))
    return {k: v.clone() for k, v in t.model.state_dict().items()}


def test_dropout_training_is_reproducible_per_generator_seed():
    a, b, c = _dropout_run(0), _dropout_run(0), _dropout_run(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    moved = [k for k in a if not torch.equal(a[k], c[k])]
    assert any("layer_" in k for k in moved) and any("fusion_dense" in k for k in moved)
