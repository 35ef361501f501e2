"""The flash route of the port (Pallas #9 / #10, ``fused_qkv`` and BERT
training-mode attention) against the JAX package, on the CPU.

- ``flash_attention_reference`` against ``fairmultimodal_tpu.ops.
  flash_attention.flash_attention`` run in the Pallas interpreter, and
  ``flash_attention_backward_reference`` against ``jax.vjp`` of it, at
  B 3, 2 heads, S 48, d 32 / 64, with no mask and with per-row masks
  including a fully masked row (the backward also at d 96, and at S 80 --
  a whole 64-row tile of the kernels and a ragged one -- with and without
  masks).  fp32: forward 2e-5, grads 5e-5 of each
  grad's max-abs.  bf16: ``BF16_TOL`` of each output's max-abs.
- the CPU wrapper: its forward is the plain version, autograd through it
  gives the plain backward bit for bit, S > 1024 raises, nothing launches.
- ``multi_head_attention``: S = 1 returns v, the gate stays shut on CPU
  tensors, ``use_kernel`` picks the wrapper or the plain path.
- ``TorchEncoderLayer(attn_kernel=False)`` and ``(fused_qkv=True)`` with the
  JAX layer's weights (a strict load of the ``qkv`` Dense) against the JAX
  layer, output and grads within 1e-5, with the plain attention and with
  the flash wrapper (gate opened); ``FAMEModel`` with flash-route lab layers
  against the JAX model in f64 (outputs and grads 1e-9); two f64
  ``FAMETrainer`` steps on the flash route against the JAX trainer (loss
  1e-8 relative); ``BertEncoderModel`` in training mode with dropout 0
  against JAX with ``deterministic=False``.
- the flash route with dropout on equals the folded route (the same Philox
  streams).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairmultimodal_torch.data.prefetch import to_device
from fairmultimodal_torch.interop import load_flax_params, state_dict_from_flax
from fairmultimodal_torch.models import behrt as t_behrt
from fairmultimodal_torch.models import bert as t_bert
from fairmultimodal_torch.models.fusion import FAMEModel as TFAME
from fairmultimodal_torch.ops import attention as t_attention
from fairmultimodal_torch.ops import flash_attention as t_flash
from fairmultimodal_torch.ops.gates import can_use_flash_attention
from fairmultimodal_torch.train import loop as tloop
from fairmultimodal_torch.utils import rng as t_rng
from fairmultimodal_tpu.models import behrt as j_behrt
from fairmultimodal_tpu.models import bert as j_bert
from fairmultimodal_tpu.models.fusion import FAMEModel as JFAME
from fairmultimodal_tpu.ops.flash_attention import flash_attention as j_flash
from fairmultimodal_tpu.train import loop as jloop

B, NH, S = 3, 2, 48
FWD_TOL = 2e-5
BWD_TOL = 5e-5
# bf16: both sides round the normalised p (forward) and p and ds * scale
# (backward) to bf16, but sum their fp32 products in another order, so a
# rounding can land one bf16 ulp (2^-8 relative) apart and carry into the
# next product; the bound is four ulps of each output's largest entry.  A
# missing rounding point moves far more.
BF16_TOL = 2.0 ** -6
IO = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(rng, *shape, std=1.0):
    return rng.normal(0, std, shape).astype(np.float32)


def _row_mask(rng, b, s):
    lens = rng.integers(s // 3, s, b)
    mask = (np.arange(s)[None] < lens[:, None]).astype(np.int32)
    mask[-1] = 0                      # a fully masked row: finite, uniform softmax
    return mask


def _qkv(seed, d, dtype, masked, s=S):
    rng = np.random.default_rng(seed)
    arrays = [_np(rng, B, NH, s, d) for _ in range(4)]          # q, k, v, dO
    mask = _row_mask(rng, B, s) if masked else None
    jdt, tdt = IO[dtype]
    jargs = [jnp.asarray(a).astype(jdt) for a in arrays]
    targs = [torch.from_numpy(a).to(tdt) for a in arrays]
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    return jargs, targs, jm, tm


def _close(name, got, want, dtype, tol):
    got = got.float().detach().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=(tol if dtype == "float32" else BF16_TOL) * scale,
                               err_msg=name)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_pallas_interpret(dtype, masked, d):
    (jq, jk, jv, _), (tq, tk, tv, _), jm, tm = _qkv(1 + d, d, dtype, masked)
    want = j_flash(jq, jk, jv, jm, True)
    got = t_flash.flash_attention_reference(tq, tk, tv, tm)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)
    else:
        _close("o", got, want, dtype, FWD_TOL)
    if masked:                        # the fully masked row: the mean of v over every key
        np.testing.assert_allclose(got[-1].float().numpy(),
                                   tv[-1].float().mean(dim=1, keepdim=True)
                                   .expand(NH, S, d).numpy(), rtol=0, atol=2e-2)


# S 48 with per-row masks (a fully masked row among them); d 96 (the lab
# encoder's); S 80 (one whole 64-row tile of the kernels and a ragged one of
# 16) with and without masks.
_PLAIN_BWD_CASES = [pytest.param(dt, d, 48, True, id=f"{dt}-{d}")
                    for dt in ("float32", "bfloat16") for d in (32, 64)]
_PLAIN_BWD_CASES += [pytest.param("float32", 96, 48, True, id="float32-96")]
_PLAIN_BWD_CASES += [pytest.param("float32", d, 80, m,
                                  id=f"float32-{d}-S80-{'mask' if m else 'nomask'}")
                     for d in (32, 64, 96) for m in (True, False)]
_PLAIN_BWD_CASES += [pytest.param("bfloat16", 96, 80, True, id="bfloat16-96-S80-mask")]


@pytest.mark.parametrize("dtype,d,s,masked", _PLAIN_BWD_CASES)
def test_plain_backward_matches_jax_vjp(dtype, d, s, masked):
    (jq, jk, jv, jg), (tq, tk, tv, tg), jm, tm = _qkv(7 + d, d, dtype, masked=masked, s=s)
    _, vjp = jax.vjp(lambda q, k, v: j_flash(q, k, v, jm, True), jq, jk, jv)
    want = vjp(jg)
    got = t_flash.flash_attention_backward_reference(tq, tk, tv, tm, tg)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tq.dtype, name
        _close(name, a, w, dtype, BWD_TOL)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    (_, _, _, _), (tq, tk, tv, tg), _, tm = _qkv(3, 32, "float32", masked=True)
    t_flash.launches = t_flash.bwd_launches = 0
    with torch.no_grad():
        assert torch.equal(t_flash.flash_attention(tq, tk, tv, tm),
                           t_flash.flash_attention_reference(tq, tk, tv, tm))
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = t_flash.flash_attention(*leaves, tm)
    assert torch.equal(out.detach(), t_flash.flash_attention_reference(tq, tk, tv, tm))
    grads = torch.autograd.grad(out, leaves, tg)
    plain = t_flash.flash_attention_backward_reference(tq, tk, tv, tm, tg)
    for name, a, p in zip(("dq", "dk", "dv"), grads, plain):
        assert torch.equal(a, p), name
    assert t_flash.launches == t_flash.bwd_launches == 0
    long = torch.zeros(1, 1, t_flash.MAX_SEQ + 16, 32)
    with pytest.raises(ValueError, match="sequence length"):
        t_flash.flash_attention(long, long, long)


def test_gate_takes_exactly_the_jax_shapes():
    def fake(shape, dtype=torch.bfloat16, cuda=True):
        return types.SimpleNamespace(shape=shape, dtype=dtype, is_cuda=cuda)

    assert can_use_flash_attention(fake((256, 8, 560, 96)))           # the lab encoder
    assert can_use_flash_attention(fake((32, 12, 512, 64), torch.float32))
    assert can_use_flash_attention(fake((2, 4, 256, 32)))
    assert can_use_flash_attention(fake((2, 4, 1024, 128)))
    assert not can_use_flash_attention(fake((256, 8, 560, 96), cuda=False))
    assert not can_use_flash_attention(fake((256, 8, 560, 96), torch.float16))
    for shape in ((2, 4, 128, 64), (2, 4, 1040, 64), (2, 4, 520, 64), (2, 4, 512, 48),
                  (2, 4, 512, 12)):
        assert not can_use_flash_attention(fake(shape)), shape


def test_multi_head_attention_routing(monkeypatch):
    (_, _, _, _), (tq, tk, tv, _), _, tm = _qkv(5, 32, "float32", masked=True)
    one = [t[:, :, :1] for t in (tq, tk, tv)]
    assert t_attention.multi_head_attention(*one, tm[:, :1]) is one[2]
    calls = []
    monkeypatch.setattr(t_attention, "flash_attention",
                        lambda *a: calls.append("flash") or t_flash.flash_attention(*a))
    t_flash.launches = 0
    plain = t_attention.multi_head_attention(tq, tk, tv, tm)          # gate: CPU -> plain
    assert calls == [] and t_flash.launches == 0
    np.testing.assert_array_equal(plain.numpy(),
                                  t_attention.attention_reference(tq, tk, tv, tm).numpy())
    forced = t_attention.multi_head_attention(tq, tk, tv, tm, use_kernel=True)
    assert calls == ["flash"] and t_flash.launches == 0
    assert torch.equal(forced, t_flash.flash_attention_reference(tq, tk, tv, tm))
    np.testing.assert_allclose(forced.numpy(), plain.numpy(), rtol=1e-5, atol=1e-6)
    t_attention.multi_head_attention(tq, tk, tv, tm, use_kernel=False)
    assert calls == ["flash"]


# -- the layer, the model, the trainer and BERT on the flash route ----------------------

H, F, LS = 64, 128, 32


def _open_gate(monkeypatch):
    """Let ``multi_head_attention`` take the flash wrapper on CPU tensors
    (its plain version and plain backward), as the card takes the kernels."""
    monkeypatch.setattr(t_attention, "can_use_flash_attention", lambda q: True)


def _layer_pair(fused_qkv, seed=0, h=H, nh=NH, f=F, s=LS):
    rng = np.random.default_rng(seed)
    x = _np(rng, B, s, h)
    mask = _row_mask(rng, B, s)
    mask[-1, :3] = 1
    kw = dict(fused_qkv=True) if fused_qkv else dict(attn_kernel=False)
    jm = j_behrt.TorchEncoderLayer(h, nh, ffn_size=f, **kw)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed),
                                                        jnp.asarray(x), jnp.asarray(mask))
                                    ["params"])
    tl = load_flax_params(t_behrt.TorchEncoderLayer(h, nh, ffn_size=f, **kw), params)
    return x, mask, jm, params, tl


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash_wrapper"])
@pytest.mark.parametrize("fused_qkv", [False, True], ids=["attn_kernel_false", "fused_qkv"])
def test_flash_route_layer_matches_jax_with_grads(monkeypatch, fused_qkv, flash):
    if flash:
        _open_gate(monkeypatch)
    x, mask, jm, params, tl = _layer_pair(fused_qkv)
    names = {n for n, _ in tl.named_parameters()}
    assert ("qkv.weight" in names) == fused_qkv and ("query.weight" in names) != fused_qkv
    g = _np(np.random.default_rng(1), B, LS, H)
    jout, vjp = jax.vjp(lambda p, xx: jm.apply({"params": p}, xx, jnp.asarray(mask)),
                        params, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    want = {k: v.numpy() for k, v in
            state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgp)).items()}
    tl.eval()
    t_flash.launches = t_flash.bwd_launches = 0
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tl(tx, torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **LAYER_TOL)
    out.backward(torch.from_numpy(g))
    assert t_flash.launches == t_flash.bwd_launches == 0
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **LAYER_TOL)
    got = {n: p.grad.numpy() for n, p in tl.named_parameters()}
    assert set(got) == set(want)
    for n, w in want.items():
        scale = float(np.abs(w).max())
        if n == "key.bias":             # zero in exact arithmetic: rounding noise only
            scale = float(np.abs(want["query.bias"]).max())
        np.testing.assert_allclose(got[n], w, rtol=0, atol=1e-5 * scale, err_msg=n)


def test_fused_qkv_equals_separate_projections():
    """The [3H, H] qkv weight is query | key | value stacked: the fused
    layer computes the unfused one."""
    x, mask, _, params, unfused = _layer_pair(False, seed=4)
    fused = t_behrt.TorchEncoderLayer(H, NH, ffn_size=F, fused_qkv=True)
    sd = {k: v for k, v in unfused.state_dict().items()
          if k.split(".")[0] not in ("query", "key", "value")}
    for leaf in ("weight", "bias"):
        sd[f"qkv.{leaf}"] = torch.cat([unfused.state_dict()[f"{n}.{leaf}"]
                                       for n in ("query", "key", "value")])
    fused.load_state_dict(sd, strict=True)
    with torch.no_grad():
        a = fused.eval()(torch.from_numpy(x), torch.from_numpy(mask))
        b = unfused.eval()(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    fused.attn_kernel = True            # the megakernel takes separate projections
    with pytest.raises(ValueError, match="fused_qkv"):
        fused(torch.from_numpy(x), torch.from_numpy(mask))


def test_flash_route_with_dropout_equals_folded_route(monkeypatch):
    """One generator state draws the same three seeds on both routes and
    both drop the same elements (the attention output on Philox stream 0 of
    its seed): equal within fp32 rounding, and dropout does act."""
    _open_gate(monkeypatch)
    x, mask, _, params, _ = _layer_pair(False, seed=3)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    g = torch.from_numpy(_np(np.random.default_rng(8), B, LS, H))
    runs = {}
    for route in (True, False):
        layer = t_behrt.TorchEncoderLayer(H, NH, ffn_size=F, attn_kernel=route,
                                          ffn_kernel=True, fold_ln=True)
        layer = load_flax_params(layer, params).train()
        leaves = dict(layer.named_parameters())
        xx = tx.clone().requires_grad_(True)
        out = layer(xx, tm, t_rng.make_generator(11))
        grads = torch.autograd.grad(out, [xx, *leaves.values()], g)
        runs[route] = (out.detach(), dict(zip(["x", *leaves], grads)))
    (out_f, grads_f), (out_r, grads_r) = runs[True], runs[False]
    np.testing.assert_allclose(out_r.numpy(), out_f.numpy(), rtol=1e-5, atol=1e-5)
    for n, w in grads_f.items():
        scale = float(w.abs().max())
        if n == "key.bias":
            scale = float(grads_f["query.bias"].abs().max())
        np.testing.assert_allclose(grads_r[n].numpy(), w.numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=n)
    with torch.no_grad():
        layer = t_behrt.TorchEncoderLayer(H, NH, ffn_size=F, attn_kernel=False)
        still = load_flax_params(layer, params).eval()(tx, tm)
    assert float((still - out_r).abs().max()) > 0.1


LABS, TEXT = 20, 12
GEO = dict(num_ages=4, num_genders=2, num_ethnicities=5, num_insurances=6,
           lab_token_count=LABS, hidden_size=32, demo_layers=1, demo_heads=2, lab_layers=2,
           lab_heads=4, fusion_hidden=16, text_embed_size=TEXT)


def _fame_inputs(rng, n):
    return {"demo_dummy_ids": np.zeros((n, 1), np.int32),
            "demo_attn_mask": np.ones((n, 1), np.int32),
            "age_ids": rng.integers(0, 4, n).astype(np.int32),
            "gender_ids": rng.integers(0, 2, n).astype(np.int32),
            "ethnicity_ids": rng.integers(0, 5, n).astype(np.int32),
            "insurance_ids": rng.integers(0, 6, n).astype(np.int32),
            "lab_features": _np(rng, n, LABS), "text_embedding": _np(rng, n, TEXT)}


def _flash_route(model):
    for layer in model.modules():
        if isinstance(layer, t_behrt.TorchEncoderLayer):
            layer.attn_kernel = False
    return model


def _fame_loss(out, c):
    return (out["fused_logits"] * c[0]).sum() + sum(
        (out["modality_logits"][m] * c[i + 1]).sum() for i, m in enumerate(("demo", "lab",
                                                                            "text")))


def _f64(arrays):
    return {k: (v.astype(np.float64) if v.dtype == np.float32 else v) for k, v in arrays.items()}


def test_fame_model_with_flash_route_lab_layers_matches_jax_f64(monkeypatch):
    """Outputs and every parameter grad in float64, where the two sides
    differ only in summation order."""
    _open_gate(monkeypatch)
    rng = np.random.default_rng(6)
    batch = _f64(_fame_inputs(rng, 5))
    c = [rng.normal(0, 1, (5, 3)) for _ in range(4)]
    with jax.enable_x64(True):
        jm = JFAME(**GEO, dtype=jnp.float64)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                        jax.jit(jm.init)(jax.random.PRNGKey(0), jb)["params"])

        def jloss(p):
            return _fame_loss(jm.apply({"params": p}, jb), [jnp.asarray(a) for a in c])

        jl, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
        want = _flat_f64(jax.tree_util.tree_map(np.asarray, jgrads))
    tm = TFAME(**GEO, dtype=torch.float64).double()
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in _flat_f64(params).items()})
    tm = _flash_route(tm).eval()
    loss = _fame_loss(tm({k: torch.from_numpy(v) for k, v in batch.items()}),
                      [torch.from_numpy(a) for a in c])
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-10)
    for n, p in tm.named_parameters():
        w = want[n]
        scale = max(float(np.abs(w).max()), 1e-12)
        if n.endswith("key.bias"):
            scale = max(scale, float(np.abs(want[n.replace("key", "query")]).max()))
        got = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-9 * scale, err_msg=n)


def _flat_f64(tree, prefix=""):
    """Flax params -> the port's state-dict names in float64."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat_f64(val, f"{prefix}{key}."))
            continue
        arr = np.asarray(val, np.float64)
        out[prefix + ("weight" if key in ("kernel", "embedding", "scale") else key)] = \
            arr.T if key == "kernel" else arr
    return out


def test_two_f64_train_steps_on_the_flash_route_match_the_jax_trainer(monkeypatch):
    _open_gate(monkeypatch)
    rng = np.random.default_rng(9)
    n = 6
    batches = [{"model_inputs": _f64(_fame_inputs(rng, n)),
                "labels": rng.integers(0, 2, (n, 3)).astype(np.float64),
                "weight": np.ones(n, np.float64)} for _ in range(2)]
    pos_w = np.array([2.0, 0.5, 3.0], np.float32)
    cfg = dict(lr=1e-3, weight_decay=0.01, grad_clip=1.0, lambda_edd=0.8, lambda_l1=0.01,
               batch_size=n)
    dyn_w = np.full((3, 3), 0.33, np.float32)
    with jax.enable_x64(True):
        jm = JFAME(**GEO, dtype=jnp.float64)
        jt = jloop.FAMETrainer(jm, jloop.TrainConfig(rng_impl="threefry",
                                                     deterministic_forward=True, **cfg),
                               pos_weight=pos_w)
        inputs = jax.tree_util.tree_map(jnp.asarray, batches[0]["model_inputs"])
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64),
                                        jax.jit(jm.init)(jax.random.PRNGKey(2), inputs)["params"])
        tm = TFAME(**GEO, dtype=torch.float64).double()
        tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                            _flat_f64(jax.tree_util.tree_map(np.asarray, params)).items()})
        tt = tloop.FAMETrainer(_flash_route(tm), tloop.TrainConfig(deterministic_forward=True,
                                                                   **cfg),
                               pos_weight=pos_w, device="cpu")
        opt_state = jt.init_opt_state(params)
        key = jax.random.key(0, impl="threefry2x32")
        for step, b in enumerate(batches):
            params, opt_state, jtotal, _ = jt._train_step(
                params, opt_state, jax.tree_util.tree_map(jnp.asarray, b), jnp.asarray(dyn_w),
                key)
            ttotal, _ = tt.train_step(to_device(b, tt.device), dyn_w)
            assert float(ttotal) == pytest.approx(float(jtotal), rel=1e-8), f"step {step}"
        want = _flat_f64(jax.tree_util.tree_map(np.asarray, params))
    for name, v in want.items():
        np.testing.assert_allclose(tt.model.state_dict()[name].numpy(), v, atol=1e-9,
                                   rtol=1e-6, err_msg=name)


def test_bert_training_mode_matches_jax(monkeypatch):
    """``BertSelfAttention`` in training mode takes ``multi_head_attention``
    (the flash kernels on the card); dropout 0, so JAX with
    ``deterministic=False`` computes the same function."""
    _open_gate(monkeypatch)
    cfg_kw = dict(vocab_size=50, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                  intermediate_size=64, max_position_embeddings=64, hidden_dropout_prob=0.0)
    rng = np.random.default_rng(10)
    ids = rng.integers(0, 50, (B, LS)).astype(np.int32)
    mask = _row_mask(rng, B, LS)
    mask[-1, :2] = 1
    jmodel = j_bert.BertEncoderModel(j_bert.BertConfig(**cfg_kw))
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))["params"])
    g = _np(rng, B, LS, 32)

    def fj(p):
        return jmodel.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                            deterministic=False, rngs={"dropout": jax.random.PRNGKey(1)})

    jout, vjp = jax.vjp(fj, params)
    want = {k: v.numpy() for k, v in state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, vjp(jnp.asarray(g))[0])).items()}
    tmodel = load_flax_params(t_bert.BertEncoderModel(t_bert.BertConfig(**cfg_kw)), params)
    tmodel.train()
    calls = []
    monkeypatch.setattr(t_attention, "flash_attention",
                        lambda *a: calls.append(1) or t_flash.flash_attention(*a))
    out = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
    assert len(calls) == cfg_kw["num_hidden_layers"]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **LAYER_TOL)
    out.backward(torch.from_numpy(g))
    for n, p in tmodel.named_parameters():
        w = want[n]
        scale = max(float(np.abs(w).max()), 1e-6)
        if n.endswith("key.bias"):
            scale = max(scale, float(np.abs(want[n.replace("key", "query")]).max()))
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-5 * scale, err_msg=n)
