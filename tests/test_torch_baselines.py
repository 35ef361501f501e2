"""The baseline models and 08's loss against the JAX package (CPU, fp32).

Each model of ``models/baselines.py`` (and through them ``BEHRTCombined``,
``AverageFusionModel`` and ``SigmoidFusionModel``) starts from the JAX
module's own initialised weights, carried across by
``interop.load_flax_params``; the same numpy inputs go through both, in
inference mode: every output within 1e-5, and the gradients of one random
projection of the outputs with respect to every parameter within 1e-4.  The
lab encoders of 01, 08 and 09 run the JAX Pallas kernels in interpret mode
(their gates opened as on a TPU) against the port's plain versions.

08: ``batch_eddi_weights`` against the JAX function on batches with pad rows
and with one gender absent, and ``make_eddi_fusion_loss`` (loss, new
weights, fused logits, grads) against the JAX loss on the same weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairmultimodal_torch.interop import load_flax_params, state_dict_from_flax
from fairmultimodal_torch.models import baselines as t_base
from fairmultimodal_torch.pipelines import eddi_fusion as t_eddi
from fairmultimodal_tpu.models import baselines as j_base
from fairmultimodal_tpu.models import behrt as j_behrt
from fairmultimodal_tpu.pipelines import eddi_fusion as j_eddi
from fairmultimodal_tpu.train.simple import SimpleTrainConfig as JSimpleTrainConfig

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
B, LABS, TEXT = 3, 12, 24
N_AGE, N_GEN, N_ETH, N_INS = 4, 2, 5, 6
# The Pallas kernels take H a multiple of 128; the BERTs run plain at any width.
LAB_H = 128
SMALL = dict(hidden_size=32, demo_layers=1, demo_heads=2)


def _inputs(seed, n=B):
    rng = np.random.default_rng(seed)
    return {
        "demo_dummy_ids": np.zeros((n, 1), np.int32),
        "demo_attn_mask": np.ones((n, 1), np.int32),
        "age_ids": rng.integers(0, N_AGE + 1, n).astype(np.int32),    # one id past the table
        "gender_ids": rng.integers(0, N_GEN, n).astype(np.int32),
        "ethnicity_ids": rng.integers(0, N_ETH, n).astype(np.int32),
        "insurance_ids": rng.integers(0, N_INS, n).astype(np.int32),
        "segment_ids": rng.integers(0, 2, n).astype(np.int32),
        "adm_loc_ids": rng.integers(0, 10, n).astype(np.int32),
        "disch_loc_ids": rng.integers(0, 10, n).astype(np.int32),
        "lab_features": rng.normal(0, 1, (n, LABS)).astype(np.float32),
        "text_embedding": rng.normal(0, 1, (n, TEXT)).astype(np.float32),
    }


@pytest.fixture
def pallas_lab(monkeypatch):
    """Open the JAX kernel gates so the lab encoder runs the Pallas kernels
    (interpret mode off the TPU)."""
    monkeypatch.setattr(j_behrt, "can_use_fused_attention_block", lambda x, nh: True)
    monkeypatch.setattr(j_behrt, "can_use_fused_ffn", lambda x, h, f: True)


def _flat(tree, prefix=""):
    """Flatten any nested output (dicts, tuples) to {path: array}."""
    if isinstance(tree, dict):
        return {k: v for key, val in tree.items() for k, v in _flat(val, f"{prefix}{key}/").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, val in enumerate(tree) for k, v in _flat(val, f"{prefix}{i}/").items()}
    return {prefix.rstrip("/"): tree}


def _check(jm, tm, inputs, seed=0):
    """Forward and gradient parity of a model pair called on a batch dict,
    or on the arrays (or dicts) of a tuple as positional arguments."""
    args = inputs if isinstance(inputs, tuple) else (inputs,)
    j_in = jax.tree_util.tree_map(jnp.asarray, args)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(seed), *j_in)["params"])
    load_flax_params(tm, params).eval()
    t_in = jax.tree_util.tree_map(torch.from_numpy, args)

    want = _flat(jax.jit(jm.apply)({"params": params}, *j_in))
    got = _flat(tm(*t_in))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), err_msg=k,
                                   **OUT_TOL)

    rng = np.random.default_rng(seed + 1)
    proj = {k: rng.normal(0, 1, np.shape(v)).astype(np.float32) for k, v in want.items()}

    def objective(p):
        out = _flat(jm.apply({"params": p}, *j_in))
        return sum(jnp.sum(out[k].astype(jnp.float32) * proj[k]) for k in out)

    j_grads = state_dict_from_flax(jax.jit(jax.grad(objective))(
        jax.tree_util.tree_map(jnp.asarray, params)))
    tm.zero_grad()
    sum((got[k].float() * torch.from_numpy(proj[k])).sum() for k in got).backward()
    for name, p in tm.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), j_grads[name].numpy(), err_msg=name, **GRAD_TOL)
    return params


def test_behrt_lab_only_model(pallas_lab):
    _check(j_base.BEHRTLabOnlyModel(LABS, hidden_size=LAB_H),
           t_base.BEHRTLabOnlyModel(LABS, hidden_size=LAB_H), _inputs(1))


def test_behrt_lab_only_model_single_task():
    params = _check(j_base.BEHRTLabOnlyModel(LABS, hidden_size=LAB_H, tasks=("mech",)),
                    t_base.BEHRTLabOnlyModel(LABS, hidden_size=LAB_H, tasks=("mech",)),
                    _inputs(2))
    assert set(params["combined"]) == {"lab_model", "fusion_fc", "classifier_mech"}


def test_text_only_classifier():
    _check(j_base.TextOnlyClassifier(num_tasks=3),
           t_base.TextOnlyClassifier(TEXT, num_tasks=3), _inputs(3))


def test_struct_text_model_and_its_pre_relu_fused_embedding():
    kw = dict(num_ages=N_AGE, hidden_size=32, num_hidden_layers=1, num_attention_heads=2)
    params = _check(j_base.StructTextModel(**kw), t_base.StructTextModel(**kw,
                                                                          text_embed_size=TEXT),
                    _inputs(4))
    # The seven BEHRTFull tables.
    assert {k for k in params["behrt"] if k.endswith("_embedding")} == {
        "age_embedding", "segment_embedding", "admission_loc_embedding",
        "discharge_loc_embedding", "gender_embedding", "ethnicity_embedding",
        "insurance_embedding"}


def test_sigmoid_fusion_full(pallas_lab):
    kw = dict(num_ages=N_AGE, num_genders=N_GEN, num_ethnicities=N_ETH, num_insurances=N_INS,
              lab_token_count=LABS, hidden_size=LAB_H, demo_layers=1, demo_heads=2,
              lab_layers=1, lab_heads=2, fusion_hidden=16)
    params = _check(j_base.SigmoidFusionFull(**kw),
                    t_base.SigmoidFusionFull(**kw, text_embed_size=TEXT), _inputs(5))
    assert {"sig_weights_demo", "sig_weights_lab", "sig_weights_text",
            "classifier_hidden"} <= set(params["fusion"])


@pytest.mark.parametrize("tasks", [("mortality", "los", "mech"), ("los",)])
def test_eddi_fusion_full(tasks, pallas_lab):
    kw = dict(num_ages=N_AGE, num_genders=N_GEN, num_ethnicities=N_ETH, num_insurances=N_INS,
              lab_token_count=LABS, hidden_size=LAB_H, demo_layers=1, demo_heads=2,
              lab_layers=1, lab_heads=2, tasks=tasks)
    params = _check(j_base.EDDIFusionFull(**kw),
                    t_base.EDDIFusionFull(**kw, text_embed_size=TEXT), _inputs(6))
    assert sum(k.startswith("head_") for k in params) == 3 * len(tasks)


# -- 08: the per-batch EDDI weights and the joint loss ------------------------------------

def _weights_case(seed, n=12, tasks=3, pad=0, one_gender=False):
    rng = np.random.default_rng(seed)
    tm = rng.normal(0, 1.5, (n, tasks, 3)).astype(np.float32)
    labels = rng.integers(0, 2, (n, tasks)).astype(np.float32)
    gender = rng.integers(0, 2, n).astype(np.int32)
    if one_gender:
        gender[:] = 1
    weight = np.ones(n, np.float32)
    if pad:
        weight[-pad:] = 0
        gender[-pad:] = 0       # pad rows carry zero ids, as the loaders pad them
    w_prev = rng.uniform(0.2, 0.5, (tasks, 3)).astype(np.float32)
    return tm, labels, gender, w_prev, weight


@pytest.mark.parametrize("pad,one_gender,tasks", [(0, False, 3), (4, False, 3), (0, True, 3),
                                                  (5, True, 1), (12, False, 3)])
def test_batch_eddi_weights_match_jax(pad, one_gender, tasks):
    tm, labels, gender, w_prev, weight = _weights_case(pad + 10 * tasks, tasks=tasks, pad=pad,
                                                       one_gender=one_gender)
    jw, je = j_eddi.batch_eddi_weights(jnp.asarray(tm), jnp.asarray(labels),
                                       jnp.asarray(gender), jnp.asarray(w_prev), 0.3,
                                       weight=jnp.asarray(weight))
    tw, te = t_eddi.batch_eddi_weights(*(torch.from_numpy(a) for a in (tm, labels, gender,
                                                                        w_prev)), 0.3,
                                       weight=torch.from_numpy(weight))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    if pad == 12:       # no real row: the weights come back unchanged
        np.testing.assert_array_equal(tw.numpy(), w_prev)


def test_eddi_fusion_loss_matches_jax():
    kw = dict(num_ages=N_AGE, num_genders=N_GEN, num_ethnicities=N_ETH, num_insurances=N_INS,
              lab_token_count=LABS, lab_layers=1, lab_heads=2, **SMALL)
    jm, tm = j_base.EDDIFusionFull(**kw), t_base.EDDIFusionFull(**kw, text_embed_size=TEXT)
    inputs = _inputs(7, n=10)
    inputs["gender_ids"][:] = 0                  # the second gender absent
    rng = np.random.default_rng(8)
    weight = np.ones(10, np.float32)
    weight[-3:] = 0
    batch = {"model_inputs": inputs, "labels": rng.integers(0, 2, (10, 3)).astype(np.float32),
             "weight": weight}
    j_in = jax.tree_util.tree_map(jnp.asarray, batch)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                        j_in["model_inputs"])["params"])
    load_flax_params(tm, params).eval()
    pos_weight = np.array([3.0, 1.5, 2.5], np.float32)
    w_prev = np.full((3, 3), 0.33, np.float32)
    j_cfg = j_eddi.EDDIFusionPipelineConfig(train=JSimpleTrainConfig(gamma=1.0))
    t_cfg = t_eddi.EDDIFusionPipelineConfig()
    j_loss = j_eddi.make_eddi_fusion_loss(jm, j_cfg, pos_weight)

    def jf(p):
        loss, aux = j_loss(p, j_in, jnp.asarray(w_prev), None, False)
        return loss, aux

    (jl, (jw, jfused)), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    t_batch = jax.tree_util.tree_map(torch.from_numpy, batch)
    tl, tw, tfused = t_eddi.make_eddi_fusion_loss(tm, t_cfg, pos_weight)(
        t_batch, torch.from_numpy(w_prev))
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tfused.detach().numpy(), np.asarray(jfused), **OUT_TOL)
    jg = state_dict_from_flax(jg)
    for name, p in tm.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), jg[name].numpy(), err_msg=name, **GRAD_TOL)
    # The weights are a constant of the loss: no gradient reaches them.
    assert not tw.requires_grad
