"""The unfolded encoder layer (``fold_ln=False`` / ``FMTPU_FOLD_LN=0``) of the port
against the JAX package, on the CPU.

- ``fused_attention_block`` and ``fused_ffn`` (Pallas #5-#8): the port's
  plain forward and backward, and autograd through the wrapper on CPU
  tensors, against the Pallas kernels run as the JAX package's own tests run
  them (``interpret=True``) and their ``jax.vjp``, at H 256, 4 heads, S 32,
  F 384, with a masked tail and a fully masked row.  Tolerances as PERF.md
  section 2: forward 2e-5, backward dx 5e-5 and weights rtol 5e-5 atol 5e-4
  at fp32; bf16 relative to each output's largest entry (``BF16_TOL``).
- ``TorchEncoderLayer(fold_ln=False, attn_kernel=True, ffn_kernel=True)``
  with the JAX layer's weights (``interop.py``) against the JAX layer with
  the same fields, output and grads; one checkpoint loads into both
  configurations; ``FMTPU_FOLD_LN`` routes to the unfolded wrappers.
- Unfolded against folded with dropout on and the same generator (the
  shared Philox streams), for the layer and for one ``FAMETrainer`` step.
- The slice: ``FAMEModel`` with unfolded lab layers against the JAX model,
  outputs and grads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairmultimodal_torch.data.prefetch import to_device
from fairmultimodal_torch.interop import load_flax_params, state_dict_from_flax
from fairmultimodal_torch.models import behrt as t_behrt
from fairmultimodal_torch.models.fusion import FAMEModel as TFAME
from fairmultimodal_torch.ops import dropout_add_layernorm as t_addnorm
from fairmultimodal_torch.ops import fused_attention_block as t_fab
from fairmultimodal_torch.ops import fused_ffn as t_ffn
from fairmultimodal_torch.train import loop as tloop
from fairmultimodal_torch.utils import rng as t_rng
from fairmultimodal_tpu.models import behrt as j_behrt
from fairmultimodal_tpu.models.fusion import FAMEModel as JFAME
from fairmultimodal_tpu.ops import fused_attention_block as j_fab
from fairmultimodal_tpu.ops.fused_ffn import fused_ffn as j_fused_ffn

B, S, H, NH, F = 2, 32, 256, 4, 384
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
DX_TOL = dict(rtol=5e-5, atol=5e-5)
W_TOL = dict(rtol=5e-5, atol=5e-4)
# bf16: both sides round the same intermediates to bf16 but sum their fp32
# products in another order, so a rounding can land one bf16 ulp (2^-8
# relative) apart and carry into the next product; the bound is four ulps
# of each output's largest entry.  A missing rounding point moves far more.
BF16_TOL = 2.0 ** -6
IO = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BLOCK_NAMES = ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
FFN_NAMES = ("x", "w1", "b1", "w2", "b2")


def _np(rng, *shape, std=1.0):
    return rng.normal(0, std, shape).astype(np.float32)


def _as_port(name, g):
    """A JAX grad in the port's layout: Dense kernels [in, out] -> [out, in]."""
    g = np.asarray(jnp.asarray(g, jnp.float32))
    return g.T if name.startswith("w") and g.ndim == 2 else g


def _both(arrays, dtype):
    """numpy arrays in JAX's layout -> (JAX arrays, port tensors), weights
    transposed to nn.Linear's [out, in]."""
    jdt, tdt = IO[dtype]
    jargs = [jnp.asarray(a).astype(jdt) for a in arrays]
    targs = [torch.from_numpy(np.ascontiguousarray(a.T if i and a.ndim == 2 else a)).to(tdt)
             for i, a in enumerate(arrays)]
    return jargs, targs


def _close(name, got, want, dtype, tol, scale=None):
    got = got.float().detach().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=name, **tol)
    else:
        scale = float(np.abs(want).max()) if scale is None else scale
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL * scale, err_msg=name)


def _mask(rng, b, s):
    lens = rng.integers(s // 2, s, b)
    mask = (np.arange(s)[None] < lens[:, None]).astype(np.int32)   # masked tails
    mask[-1] = 0                       # a fully masked row: finite, uniform softmax
    return mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_forward_and_backward_match_pallas_interpret(dtype):
    rng = np.random.default_rng(5)
    x = _np(rng, B + 1, S, H)
    ws = []
    for _ in range(4):
        ws += [_np(rng, H, H, std=H ** -0.5), _np(rng, H, std=0.05)]
    mask = _mask(rng, B + 1, S)
    g = _np(rng, B + 1, S, H)
    jargs, targs = _both([x, *ws], dtype)
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)

    jout, vjp = jax.vjp(lambda *a: j_fab.fused_attention_block(*a, jm, NH, True), *jargs)
    want = [_as_port(n, w) for n, w in zip(BLOCK_NAMES, vjp(jnp.asarray(g).astype(jout.dtype)))]
    out, res = t_fab.fused_attention_block_reference(*targs, tm, num_heads=NH,
                                                     return_residuals=True)
    assert out.dtype == targs[0].dtype
    _close("out", out, jnp.asarray(jout, jnp.float32), dtype, FWD_TOL)

    tg = torch.from_numpy(g).to(targs[0].dtype)
    x_, wq, _, wk, _, wv, _, wo, _ = targs
    plain = t_fab.fused_attention_block_backward_reference(
        tg, x_, res["qkv"], res["o"], wq, wk, wv, wo, tm, num_heads=NH)
    leaves = [t.clone().requires_grad_(True) for t in targs]
    wout = t_fab.fused_attention_block(*leaves, tm, num_heads=NH)
    assert torch.equal(wout, out)
    wrapped = torch.autograd.grad(wout, leaves, tg)
    # dbk is zero in exact arithmetic (softmax ignores a key bias): measure
    # its rounding noise on the scale of the q/k/v bias grads.
    bias_scale = float(np.abs(np.concatenate(want[2:7:2])).max())
    for n, p, a, w in zip(BLOCK_NAMES, plain, wrapped, want):
        assert p.dtype == targs[BLOCK_NAMES.index(n)].dtype, n
        assert torch.equal(p, a), n                     # the wrapper is the plain version
        _close(n, p, w, dtype, DX_TOL if n == "x" else W_TOL,
               bias_scale if n in ("bq", "bk", "bv") else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_ffn_forward_and_backward_match_pallas_interpret(activation, dtype):
    r = 200                             # not a multiple of the JAX row block: its pad path
    rng = np.random.default_rng(9)
    arrays = [_np(rng, r, H), _np(rng, H, F, std=H ** -0.5), _np(rng, F, std=0.05),
              _np(rng, F, H, std=F ** -0.5), _np(rng, H, std=0.05)]
    g = _np(rng, r, H)
    jargs, targs = _both(arrays, dtype)

    def fj(*a):
        return j_fused_ffn(*a, jnp.zeros((1,), jnp.int32), 0.1, True, True, activation)

    jout, vjp = jax.vjp(fj, *jargs)
    want = [_as_port(n, w) for n, w in zip(FFN_NAMES, vjp(jnp.asarray(g).astype(jout.dtype)))]
    out, res = t_ffn.fused_ffn_reference(*targs, activation=activation, return_residuals=True)
    assert out.dtype == targs[0].dtype
    _close("out", out, jnp.asarray(jout, jnp.float32), dtype, FWD_TOL)

    tg = torch.from_numpy(g).to(targs[0].dtype)
    plain = t_ffn.fused_ffn_backward_reference(tg, targs[0], res["hd"], targs[1], targs[3],
                                               activation=activation)
    leaves = [t.clone().requires_grad_(True) for t in targs]
    wout = t_ffn.fused_ffn(*leaves, activation=activation)
    assert torch.equal(wout, out)
    wrapped = torch.autograd.grad(wout, leaves, tg)
    for n, p, a, w in zip(FFN_NAMES, plain, wrapped, want):
        assert p.dtype == targs[FFN_NAMES.index(n)].dtype, n
        assert torch.equal(p, a), n
        _close(n, p, w, dtype, DX_TOL if n == "x" else W_TOL)


def test_ffn_dropout_stream_and_replay():
    """relu takes the inner dropout on Philox stream 0 of ``seed`` -- the
    folded FFN's inner stream -- and the backward replays it from hd > 0;
    gelu refuses a dropout, as the JAX kernel asserts."""
    r, h, f, rate, seed = 96, 128, 256, 0.1, 41
    rng = np.random.default_rng(3)
    targs = [torch.from_numpy(a) for a in (
        _np(rng, r, h), _np(rng, f, h, std=h ** -0.5), _np(rng, f, std=0.05),
        _np(rng, h, f, std=f ** -0.5), _np(rng, h, std=0.05))]
    tg = torch.from_numpy(_np(rng, r, h))
    kw = dict(activation="relu", rate=rate, seed=seed)
    out, res = t_ffn.fused_ffn_reference(*targs, return_residuals=True, **kw)
    ones = (torch.ones(h), torch.zeros(h))
    _, res_ln = t_ffn.fused_ffn_ln_reference(*targs, *ones, activation="relu", ln_eps=1e-5,
                                             rate=rate, seeds=(seed, seed + 1),
                                             return_residuals=True)
    assert torch.equal(res["hd"], res_ln["hd"])      # the same inner mask as the folded FFN
    hpre = targs[0] @ targs[1].t() + targs[2]
    assert torch.equal(res["hd"] > 0, t_rng.dropout_mask(seed, 0, (r, f), rate) & (hpre > 0))

    leaves = [t.clone().requires_grad_(True) for t in targs]
    want = torch.autograd.grad(t_ffn.fused_ffn_reference(*leaves, **kw), leaves, tg)
    plain = t_ffn.fused_ffn_backward_reference(tg, targs[0], res["hd"], targs[1], targs[3], **kw)
    wrapped = torch.autograd.grad(t_ffn.fused_ffn(*leaves, deterministic=False, **kw), leaves,
                                  tg)
    for n, p, a, w in zip(FFN_NAMES, plain, wrapped, want):
        assert torch.equal(p, a), n
        np.testing.assert_allclose(p.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()), err_msg=n)
    with pytest.raises(ValueError, match="gelu"):
        t_ffn.fused_ffn(*targs, activation="gelu", rate=rate, deterministic=False, seed=seed)
    with pytest.raises(ValueError, match="seed"):
        t_ffn.fused_ffn(*targs, rate=rate, deterministic=False)


def test_dropout_add_layernorm_draws_the_given_stream():
    rng = np.random.default_rng(4)
    x, y = (torch.from_numpy(_np(rng, 6, 40)) for _ in range(2))
    gamma, beta = torch.from_numpy(1 + _np(rng, 40, std=0.1)), torch.from_numpy(_np(rng, 40))
    drop = t_rng.Dropout.make(13, 1, 0.25)
    got = t_addnorm.dropout_add_layernorm(x, y, gamma, beta, eps=1e-5, dropout=drop)
    keep = t_rng.dropout_mask(13, 1, (6, 40), 0.25)
    want = torch.nn.functional.layer_norm(x + torch.where(keep, y / 0.75, 0.0), (40,), gamma,
                                          beta, 1e-5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    plain = t_addnorm.dropout_add_layernorm(x, y, gamma, beta, eps=1e-5)
    assert not torch.allclose(got, plain)


def _layer_pair(fold_ln, seed=0, h=H, nh=NH, f=F, s=S):
    rng = np.random.default_rng(seed)
    x = _np(rng, B, s, h)
    mask = _mask(rng, B, s)
    mask[-1, :3] = 1
    jm = j_behrt.TorchEncoderLayer(h, nh, ffn_size=f, fold_ln=fold_ln, attn_kernel=True,
                                   ffn_kernel=True)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed),
                                                        jnp.asarray(x), jnp.asarray(mask))
                                    ["params"])
    return x, mask, jm, params


def _port_layer(params, fold_ln, h=H, nh=NH, f=F):
    tl = t_behrt.TorchEncoderLayer(h, nh, ffn_size=f, fold_ln=fold_ln, attn_kernel=True,
                                   ffn_kernel=True)
    return load_flax_params(tl, params)


def test_unfolded_layer_matches_jax_with_grads():
    x, mask, jm, params = _layer_pair(fold_ln=False)
    g = _np(np.random.default_rng(1), B, S, H)
    jout, vjp = jax.vjp(lambda p, xx: jm.apply({"params": p}, xx, jnp.asarray(mask)),
                        params, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    want = {k: v.numpy() for k, v in
            state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgp)).items()}
    tl = _port_layer(params, fold_ln=False).eval()
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tl(tx, torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD_TOL)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **DX_TOL)
    got = {n: p.grad.numpy() for n, p in tl.named_parameters()}
    assert set(got) == set(want)
    for n, w in want.items():
        scale = float(np.abs(w).max())
        if n == "key.bias":             # zero in exact arithmetic: rounding noise only
            scale = float(np.abs(want["query.bias"]).max())
        np.testing.assert_allclose(got[n], w, rtol=0, atol=2e-5 * scale, err_msg=n)


def test_one_checkpoint_loads_into_both_configurations():
    """norm1 / norm2 keep their names whether folded or not, so one JAX
    parameter tree serves both, and each matches its JAX configuration."""
    x, mask, jm_fold, params = _layer_pair(fold_ln=True, seed=2, h=128, nh=2, f=256)
    for fold in (True, False):
        jm = j_behrt.TorchEncoderLayer(128, 2, ffn_size=256, fold_ln=fold, attn_kernel=True,
                                       ffn_kernel=True)
        want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
        tl = _port_layer(params, fold, h=128, nh=2, f=256).eval()
        with torch.no_grad():
            got = tl(torch.from_numpy(x), torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"fold={fold}",
                                   **FWD_TOL)


@pytest.mark.parametrize("env,unfolded", [("0", True), ("1", False), (None, False)])
def test_fold_ln_env_routes_the_layer(monkeypatch, env, unfolded):
    if env is None:
        monkeypatch.delenv("FMTPU_FOLD_LN", raising=False)
    else:
        monkeypatch.setenv("FMTPU_FOLD_LN", env)
    calls = []
    for name in ("fused_attention_block", "fused_attention_block_ln", "fused_ffn",
                 "fused_ffn_ln", "dropout_add_layernorm"):
        fn = getattr(t_behrt, name)
        monkeypatch.setattr(t_behrt, name,
                            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    layer = t_behrt.TorchEncoderLayer(32, 2, ffn_size=64, attn_kernel=True, ffn_kernel=True)
    layer(torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(0)))
    want = (["fused_attention_block", "dropout_add_layernorm", "fused_ffn",
             "dropout_add_layernorm"] if unfolded else
            ["fused_attention_block_ln", "fused_ffn_ln"])
    assert calls == want
    layer.fold_ln = unfolded                     # the attribute wins over the environment
    calls.clear()
    layer(torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(0)))
    assert ("fused_ffn_ln" in calls) == unfolded


def _grads_of(layer, x, mask, g, gen_seed):
    leaves = dict(layer.named_parameters())
    tx = x.clone().requires_grad_(True)
    out = layer(tx, mask, t_rng.make_generator(gen_seed))
    grads = torch.autograd.grad(out, [tx, *leaves.values()], g)
    return out.detach(), dict(zip(["x", *leaves], grads))


def test_unfolded_equals_folded_with_dropout_on():
    """The same generator state draws the same three seeds in both
    configurations and both drop the same elements (shared Philox streams):
    equal within fp32 rounding, and dropout does act."""
    x, mask, _, params = _layer_pair(fold_ln=False, seed=3, h=128, nh=2, f=256)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    g = torch.from_numpy(_np(np.random.default_rng(8), B, S, 128))
    runs = {}
    for fold in (True, False):
        layer = _port_layer(params, fold, h=128, nh=2, f=256).train()
        runs[fold] = _grads_of(layer, tx, tm, g, gen_seed=11)
    (out_f, grads_f), (out_u, grads_u) = runs[True], runs[False]
    np.testing.assert_allclose(out_u.numpy(), out_f.numpy(), rtol=1e-5, atol=1e-5)
    for n, w in grads_f.items():
        scale = float(w.abs().max())
        if n == "key.bias":
            scale = float(grads_f["query.bias"].abs().max())
        np.testing.assert_allclose(grads_u[n].numpy(), w.numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=n)
    with torch.no_grad():
        still = _port_layer(params, False, h=128, nh=2, f=256).eval()(tx, tm)
    assert float((still - out_u).abs().max()) > 0.1


# -- the slice: FAMEModel and one FAMETrainer step with unfolded lab layers -------------

LABS, TEXT = 20, 12
GEO = dict(num_ages=4, num_genders=2, num_ethnicities=5, num_insurances=6,
           lab_token_count=LABS, hidden_size=32, demo_layers=1, demo_heads=2, lab_layers=2,
           lab_heads=4, fusion_hidden=16, text_embed_size=TEXT)


def _fame_batch(rng, n):
    return {"demo_dummy_ids": np.zeros((n, 1), np.int32),
            "demo_attn_mask": np.ones((n, 1), np.int32),
            "age_ids": rng.integers(0, 4, n).astype(np.int32),
            "gender_ids": rng.integers(0, 2, n).astype(np.int32),
            "ethnicity_ids": rng.integers(0, 5, n).astype(np.int32),
            "insurance_ids": rng.integers(0, 6, n).astype(np.int32),
            "lab_features": _np(rng, n, LABS), "text_embedding": _np(rng, n, TEXT)}


def _unfold(model):
    for layer in model.modules():
        if isinstance(layer, t_behrt.TorchEncoderLayer):
            layer.fold_ln, layer.attn_kernel, layer.ffn_kernel = False, True, True
    return model


def _fame_loss(out, c):
    return (out["fused_logits"] * c[0]).sum() + sum(
        (out["modality_logits"][m] * c[i + 1]).sum() for i, m in enumerate(("demo", "lab",
                                                                            "text")))


def test_fame_model_with_unfolded_lab_layers_matches_jax():
    rng = np.random.default_rng(6)
    batch = _fame_batch(rng, 5)
    c = [_np(rng, 5, 3) for _ in range(4)]
    jm = JFAME(**GEO)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jb)
                                    ["params"])

    def jloss(p):
        return _fame_loss(jm.apply({"params": p}, jb), [jnp.asarray(a) for a in c])

    jl, jgrads = jax.value_and_grad(jloss)(params)
    want = {k: v.numpy() for k, v in
            state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads)).items()}
    tm = _unfold(load_flax_params(TFAME(**GEO), params)).eval()
    loss = _fame_loss(tm({k: torch.from_numpy(v) for k, v in batch.items()}),
                      [torch.from_numpy(a) for a in c])
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    for n, p in tm.named_parameters():
        w = want[n]
        scale = max(float(np.abs(w).max()), 1e-6)
        if n.endswith("key.bias"):
            scale = max(scale, float(np.abs(want[n.replace("key", "query")]).max()))
        got = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-4 * scale, err_msg=n)


def test_train_step_unfolded_equals_folded_with_dropout_on():
    rng = np.random.default_rng(7)
    n = 6
    batch = {"model_inputs": _fame_batch(rng, n),
             "labels": rng.integers(0, 2, (n, 3)).astype(np.float32),
             "weight": np.ones(n, np.float32)}
    params = jax.jit(JFAME(**GEO).init)(
        jax.random.PRNGKey(1), {k: jnp.asarray(v) for k, v in batch["model_inputs"].items()})
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    step = {}
    for fold in (True, False):
        model = _unfold(load_flax_params(TFAME(**GEO), params))
        for layer in model.modules():
            if isinstance(layer, t_behrt.TorchEncoderLayer):
                layer.fold_ln = fold
        trainer = tloop.FAMETrainer(model, tloop.TrainConfig(lr=1e-3, batch_size=n),
                                    pos_weight=np.ones(3, np.float32), rngs_seed=4,
                                    device="cpu")
        total, _ = trainer.train_step(to_device(batch, trainer.device))
        step[fold] = (float(total), {k: p.grad.clone() for k, p in model.named_parameters()
                                     if p.grad is not None})
    (loss_f, grads_f), (loss_u, grads_u) = step[True], step[False]
    assert loss_u == pytest.approx(loss_f, rel=1e-6)
    assert set(grads_u) == set(grads_f)
    for k, w in grads_f.items():
        scale = max(float(w.abs().max()), 1e-6)
        if k.endswith("key.bias"):
            scale = max(scale, float(grads_f[k.replace("key", "query")].abs().max()))
        np.testing.assert_allclose(grads_u[k].numpy(), w.numpy(), rtol=0, atol=1e-4 * scale,
                                   err_msg=k)
