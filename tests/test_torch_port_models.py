"""Module parity of the PyTorch port against the JAX package (CPU, fp32).

Every module starts from the JAX module's own initialised weights, carried
across by ``fairmultimodal_torch.interop``; the same numpy inputs go through
both, and outputs must agree to 1e-5 (the JAX package's own forward
tolerance against its torch oracles, PARITY.md).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairmultimodal_torch.interop import load_flax_params, state_dict_from_flax
from fairmultimodal_torch.models import behrt as t_behrt
from fairmultimodal_torch.models import bert as t_bert
from fairmultimodal_torch.models import fusion as t_fusion
from fairmultimodal_tpu.models import behrt as j_behrt
from fairmultimodal_tpu.models import bert as j_bert
from fairmultimodal_tpu.models import fusion as j_fusion

TOL = dict(rtol=1e-5, atol=1e-5)
H = 32
N_AGE, N_GEN, N_ETH, N_INS = 4, 2, 5, 6


def _params(module, *args, seed=0, **kw):
    params = module.init(jax.random.PRNGKey(seed), *args, **kw)["params"]
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def _close(a, b, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               err_msg=what, **TOL)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def test_interop_renames_and_transposes():
    tree = {"a": {"kernel": np.arange(6.0).reshape(2, 3), "bias": np.ones(3)},
            "emb": {"embedding": np.zeros((4, 2))}, "ln": {"scale": np.ones(2)},
            "pos_embedding": np.ones((5, 2))}
    sd = state_dict_from_flax(tree)
    assert set(sd) == {"a.weight", "a.bias", "emb.weight", "ln.weight", "pos_embedding"}
    np.testing.assert_array_equal(sd["a.weight"].numpy(), np.arange(6.0).reshape(2, 3).T)
    assert all(v.dtype == torch.float32 for v in sd.values())


@pytest.mark.parametrize("seq", [1, 10])
def test_bert_encoder_matches_jax(seq):
    cfg = dict(vocab_size=50, hidden_size=H, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=64, max_position_embeddings=16)
    rng = np.random.default_rng(seq)
    ids = rng.integers(0, 50, (3, seq)).astype(np.int32)
    mask = np.ones((3, seq), np.int32)
    if seq > 1:
        mask[1, seq // 2:] = 0
        mask[2, :] = 0   # fully masked row: finite uniform softmax in both
    jm = j_bert.BertEncoderModel(j_bert.BertConfig(**cfg))
    params = _params(jm, jnp.asarray(ids), jnp.asarray(mask))
    tm = load_flax_params(t_bert.BertEncoderModel(t_bert.BertConfig(**cfg)), params).eval()
    for pool in (None, "cls"):
        want = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask), pool=pool)
        got = tm(_t(ids), _t(mask), pool=pool)
        _close(got.detach(), want, f"pool={pool}")


def test_torch_encoder_layer_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 12, H)).astype(np.float32)
    mask = np.ones((2, 12), np.int32)
    mask[0, 9:] = 0
    jm = j_behrt.TorchEncoderLayer(H, 4, ffn_size=64)
    params = _params(jm, jnp.asarray(x), jnp.asarray(mask))
    tm = load_flax_params(t_behrt.TorchEncoderLayer(H, 4, ffn_size=64), params).eval()
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    _close(tm(_t(x), _t(mask)).detach(), want)


def test_behrt_lab_pads_before_embedding_like_jax():
    L = 13   # not a multiple of 16: the 13 -> 16 pad path runs
    rng = np.random.default_rng(2)
    labs = rng.normal(0, 1, (3, L)).astype(np.float32)
    jm = j_behrt.BEHRTLab(L, H, num_heads=4, num_layers=2)
    params = _params(jm, jnp.asarray(labs))
    tm = load_flax_params(t_behrt.BEHRTLab(L, H, num_heads=4, num_layers=2), params).eval()
    want = jm.apply({"params": params}, jnp.asarray(labs))
    got = tm(_t(labs))
    assert got.shape == (3, H)
    _close(got.detach(), want)


def _demo_inputs(n, rng):
    return dict(dummy_ids=np.zeros((n, 1), np.int32), attn_mask=np.ones((n, 1), np.int32),
                age_ids=rng.integers(0, N_AGE + 2, n).astype(np.int32),  # some clipped
                gender_ids=rng.integers(0, N_GEN, n).astype(np.int32),
                ethnicity_ids=rng.integers(0, N_ETH, n).astype(np.int32),
                insurance_ids=rng.integers(0, N_INS, n).astype(np.int32))


def test_behrt_demo_broadcast_pad_row_and_nan_guard():
    rng = np.random.default_rng(3)
    inp = _demo_inputs(4, rng)
    inp["dummy_ids"][3] = 0
    inp["attn_mask"][3] = 0      # zero-padded tail row: admitted
    jm = j_behrt.BEHRTDemo(N_AGE, N_GEN, N_ETH, N_INS, hidden_size=H,
                           num_hidden_layers=2, num_attention_heads=2, intermediate_size=64)
    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    params = _params(jm, *jin.values())
    tm = load_flax_params(t_behrt.BEHRTDemo(
        N_AGE, N_GEN, N_ETH, N_INS, hidden_size=H, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64), params).eval()
    want = jm.apply({"params": params}, *jin.values())
    got = tm(*[_t(v) for v in inp.values()])
    assert np.isfinite(got.detach().numpy()).all()
    _close(got.detach(), want)

    inp["dummy_ids"][1] = 7      # per-row tokens: both poison with NaN
    want = jm.apply({"params": params}, *[jnp.asarray(v) for v in inp.values()])
    got = tm(*[_t(v) for v in inp.values()])
    assert np.isnan(np.asarray(want)).all() and torch.isnan(got).all()


def _fame_batch(n, L, text_dim, rng):
    b = _demo_inputs(n, rng)
    return {"demo_dummy_ids": b["dummy_ids"], "demo_attn_mask": b["attn_mask"],
            "age_ids": b["age_ids"], "gender_ids": b["gender_ids"],
            "ethnicity_ids": b["ethnicity_ids"], "insurance_ids": b["insurance_ids"],
            "lab_features": rng.normal(0, 1, (n, L)).astype(np.float32),
            "text_embedding": rng.normal(0, 1, (n, text_dim)).astype(np.float32)}


@pytest.mark.parametrize("compat", [True, False])
def test_fame_model_matches_jax_every_output(compat):
    L, text_dim = 11, 24
    geo = dict(num_ages=N_AGE, num_genders=N_GEN, num_ethnicities=N_ETH,
               num_insurances=N_INS, lab_token_count=L, text_embed_size=text_dim,
               hidden_size=H, demo_layers=1, demo_heads=2, lab_layers=2, lab_heads=4,
               fusion_hidden=16, reference_weight_compat=compat)
    rng = np.random.default_rng(4)
    batch = _fame_batch(5, L, text_dim, rng)
    dw = rng.uniform(0.1, 0.6, (3, 3)).astype(np.float32)
    jm = j_fusion.FAMEModel(**geo)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _params(jm, jb)
    tm = load_flax_params(t_fusion.FAMEModel(**geo), params).eval()
    tb = {k: _t(v) for k, v in batch.items()}
    for weights in (None, dw):
        want = jm.apply({"params": params}, jb,
                        dynamic_weights=None if weights is None else jnp.asarray(weights))
        got = tm(tb, dynamic_weights=None if weights is None else _t(weights))
        assert set(got) == set(want) and set(got["modality_logits"]) == {"demo", "lab", "text"}
        for key in ("fused_logits", "sigmoid_weights", "gated_vector", "fusion_pre_relu"):
            assert got[key].dtype == torch.float32
            _close(got[key].detach(), want[key], key)
        for mod in ("demo", "lab", "text"):
            _close(got["modality_logits"][mod].detach(), want["modality_logits"][mod], mod)
