"""The training slice's kernels' plain versions against the JAX package, on the CPU.

- The backward of both half-layers -- the port's plain backward
  (``*_backward_reference``) and ``torch.autograd.grad`` through the wrapper
  on CPU tensors -- against ``jax.vjp`` of the Pallas kernels run as the JAX
  package's own tests run them (``interpret=True``), dropout off, masked
  rows, at fp32 with the JAX package's tolerances
  (``tests/test_fused_attention_block.py:171-179``: dx rtol/atol 5e-5,
  weights rtol 5e-5 atol 5e-4) and at bf16 (``BF16_GRAD_TOL``).
- Philox: the plain version against an independent scalar Philox4x32-10
  and Random123's known-answer vectors; kept-fraction statistics.
- Dropout on: the plain backward against autograd of the plain forward with
  the Philox mask in it (the backward replays the forward's mask), and the
  FFN's inner mask recovered from hd > 0 equals the drawn mask where
  relu(h) > 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairmultimodal_torch.ops import fused_attention_block as t_fab
from fairmultimodal_torch.ops import fused_ffn as t_ffn
from fairmultimodal_torch.utils import rng as t_rng
from fairmultimodal_tpu.ops import fused_attention_block as j_fab
from fairmultimodal_tpu.ops.fused_ffn import fused_ffn_ln as j_fused_ffn_ln

DX_TOL = dict(rtol=5e-5, atol=5e-5)
W_TOL = dict(rtol=5e-5, atol=5e-4)
# bf16: both sides round the same intermediates (da, dO, p, ds * scale,
# dq/dk/dv, dy, dh) to bf16 but sum their fp32 products in another order, so
# a rounding can land one bf16 ulp (2^-8 relative) apart and carry into the
# next product, and every grad is itself rounded to bf16 at the end.  The
# bound is four ulps of each grad's largest entry; a missing rounding point
# moves the sums by far more.
BF16_GRAD_TOL = 2.0 ** -6
IO = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ATTN_NAMES = ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "gamma", "beta")
FFN_NAMES = ("x", "w1", "b1", "w2", "b2", "gamma", "beta")


def _np(rng, *shape, std=1.0):
    return rng.normal(0, std, shape).astype(np.float32)


def _close(name, got, want, dtype, scale=None):
    """got: a torch grad in the port's layout; want: numpy in the same layout.
    bf16 errors are measured against ``scale``, by default the largest entry
    of ``want``."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=name, **(DX_TOL if name == "x" else W_TOL))
    else:
        scale = float(np.abs(want).max()) if scale is None else scale
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_GRAD_TOL * scale, err_msg=name)


def _as_port(name, g):
    """A JAX grad in the port's layout: Dense kernels [in, out] -> [out, in]."""
    g = np.asarray(jnp.asarray(g, jnp.float32))
    return g.T if name.startswith("w") and g.ndim == 2 else g


def _attn_inputs(b, s, h, dtype, seed):
    rng = np.random.default_rng(seed)
    x = _np(rng, b, s, h)
    ws = []
    for _ in range(4):
        ws += [_np(rng, h, h, std=h ** -0.5), _np(rng, h, std=0.05)]
    gamma, beta = 1.0 + _np(rng, h, std=0.1), _np(rng, h, std=0.1)
    mask = (rng.random((b, s)) < 0.8).astype(np.int32)
    mask[0, 0] = 1
    mask[-1, :] = 0                 # a fully masked row: finite, uniform softmax
    g = _np(rng, b, s, h)
    jdt, tdt = IO[dtype]
    jargs = [jnp.asarray(x).astype(jdt)] + [jnp.asarray(w).astype(jdt) for w in ws] + \
        [jnp.asarray(gamma), jnp.asarray(beta)]
    targs = [torch.from_numpy(x).to(tdt)] + \
        [torch.from_numpy(np.ascontiguousarray(w.T if w.ndim == 2 else w)).to(tdt) for w in ws] + \
        [torch.from_numpy(gamma), torch.from_numpy(beta)]
    return jargs, targs, mask, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,nh", [(2, 48, 256, 4), (3, 32, 128, 2)])
def test_attention_backward_matches_pallas_interpret(b, s, h, nh, dtype):
    eps = 1e-5
    jargs, targs, mask, g = _attn_inputs(b, s, h, dtype, seed=h + s)
    jdt, tdt = IO[dtype]
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)

    def f(*a):
        return j_fab.fused_attention_block_ln(*a, jm, jnp.zeros((1,), jnp.int32), nh, 0.1, True,
                                              True, eps)

    jout, vjp = jax.vjp(f, *jargs)
    want = [_as_port(n, w) for n, w in zip(ATTN_NAMES, vjp(jnp.asarray(g).astype(jdt)))]
    tg = torch.from_numpy(g).to(tdt)

    # the plain backward from the plain forward's residuals
    out, res = t_fab.fused_attention_block_ln_reference(*targs, tm, num_heads=nh, ln_eps=eps,
                                                        return_residuals=True)
    x, wq, _, wk, _, wv, _, wo, _, gamma, _ = targs
    plain = t_fab.fused_attention_block_ln_backward_reference(
        tg, x, res["qkv"], res["o"], res["z"], wq, wk, wv, wo, gamma, tm, num_heads=nh,
        ln_eps=eps)
    # autograd through the wrapper on CPU tensors
    leaves = [t.clone().requires_grad_(True) for t in targs]
    wrapped = torch.autograd.grad(
        t_fab.fused_attention_block_ln(*leaves, tm, num_heads=nh, ln_eps=eps), leaves, tg)
    # dbk is zero in exact arithmetic (softmax ignores a key bias): its
    # entries are rounding noise, measured on the scale of the q/k/v bias
    # grads, the one [3H] buffer they come out of.
    bias_scale = float(np.abs(np.concatenate(want[2:7:2])).max())
    for n, p, a, w in zip(ATTN_NAMES, plain, wrapped, want):
        assert p.dtype == targs[ATTN_NAMES.index(n)].dtype
        assert torch.equal(p, a), n                     # the wrapper is the plain version
        _close(n, p, w, dtype, bias_scale if n in ("bq", "bk", "bv") else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation,eps", [("relu", 1e-5), ("gelu", 1e-12)])
def test_ffn_backward_matches_pallas_interpret(activation, eps, dtype):
    r, h, f = 200, 256, 512        # R not a multiple of the row block: the pad path
    rng = np.random.default_rng(17)
    x = _np(rng, r, h)
    ws = [_np(rng, h, f, std=h ** -0.5), _np(rng, f, std=0.05), _np(rng, f, h, std=f ** -0.5),
          _np(rng, h, std=0.05)]
    gamma, beta = 1.0 + _np(rng, h, std=0.1), _np(rng, h, std=0.1)
    g = _np(rng, r, h)
    jdt, tdt = IO[dtype]
    jargs = [jnp.asarray(x).astype(jdt)] + [jnp.asarray(w).astype(jdt) for w in ws] + \
        [jnp.asarray(gamma), jnp.asarray(beta)]
    targs = [torch.from_numpy(x).to(tdt)] + \
        [torch.from_numpy(np.ascontiguousarray(w.T if w.ndim == 2 else w)).to(tdt) for w in ws] + \
        [torch.from_numpy(gamma), torch.from_numpy(beta)]

    def fj(*a):
        return j_fused_ffn_ln(*a, jnp.zeros((2,), jnp.int32), 0.1, True, True, activation, eps)

    _, vjp = jax.vjp(fj, *jargs)
    want = [_as_port(n, w) for n, w in zip(FFN_NAMES, vjp(jnp.asarray(g).astype(jdt)))]
    tg = torch.from_numpy(g).to(tdt)
    _, res = t_ffn.fused_ffn_ln_reference(*targs, activation=activation, ln_eps=eps,
                                          return_residuals=True)
    plain = t_ffn.fused_ffn_ln_backward_reference(tg, targs[0], res["hd"], res["z"], targs[1],
                                                  targs[3], targs[5], activation=activation,
                                                  ln_eps=eps)
    leaves = [t.clone().requires_grad_(True) for t in targs]
    wrapped = torch.autograd.grad(
        t_ffn.fused_ffn_ln(*leaves, activation=activation, ln_eps=eps), leaves, tg)
    for n, p, a, w in zip(FFN_NAMES, plain, wrapped, want):
        assert p.dtype == targs[FFN_NAMES.index(n)].dtype
        assert torch.equal(p, a), n
        _close(n, p, w, dtype)


# -- Philox ---------------------------------------------------------------------------


def _philox_scalar(ctr, key):
    """Philox4x32-10 on Python ints (Salmon et al., SC'11): an independent
    implementation with exact 64-bit products."""
    m0, m1, w0, w1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
    c, k = list(ctr), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + w0) & 0xFFFFFFFF, (k[1] + w1) & 0xFFFFFFFF]
        p0, p1 = m0 * c[0], m1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & 0xFFFFFFFF]
    return c


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    assert tuple(_philox_scalar(ctr, key)) == want
    words = t_rng.philox4x32(*[torch.tensor([c], dtype=torch.int64) for c in ctr], *key)
    assert tuple(int(w) for w in words) == want


@pytest.mark.parametrize("seed,stream", [(0, 0), (123, 1), (2 ** 31 - 2, 2), (2 ** 40 + 5, 7)])
def test_random_bits_match_scalar_philox(seed, stream):
    n = 4099                                   # a ragged last counter
    got = t_rng.random_bits(seed, stream, n).tolist()
    key = (seed & 0xFFFFFFFF, seed >> 32)
    want = [_philox_scalar(((i >> 2) & 0xFFFFFFFF, i >> 34, stream, 0), key)[i & 3]
            for i in range(n)]
    assert got == want


def test_keep_fraction_and_independent_streams():
    n, rate = 1 << 21, 0.1
    masks = {(s, st): t_rng.dropout_mask(s, st, (n,), rate) for s in (1, 2) for st in (0, 1)}
    sigma = (rate * (1 - rate) / n) ** 0.5      # 2.1e-4
    for m in masks.values():
        assert abs(m.float().mean().item() - (1 - rate)) < 5 * sigma
    a = masks[(1, 0)]
    for other in ((1, 1), (2, 0)):             # another stream or seed: another mask,
        both = (a & masks[other]).float().mean().item()   # uncorrelated
        assert not torch.equal(a, masks[other])
        assert abs(both - (1 - rate) ** 2) < 5 * sigma
    assert t_rng.keep_threshold(0.0) == 2 ** 32 - 1
    x = torch.ones(8)
    assert torch.equal(t_rng.dropout(x, 0.1, None), x)


# -- dropout on: replay consistency ---------------------------------------------------


def _grads(fn, leaves, g):
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    return torch.autograd.grad(fn(*leaves), leaves, g)


def test_attention_dropout_backward_replays_the_forward_mask():
    b, s, h, nh, eps, rate, seed = 2, 40, 128, 2, 1e-5, 0.1, 77
    _, targs, mask, g = _attn_inputs(b, s, h, "float32", seed=5)
    tm, tg = torch.from_numpy(mask), torch.from_numpy(g)
    kw = dict(num_heads=nh, ln_eps=eps, rate=rate, seed=seed)
    want = _grads(lambda *a: t_fab.fused_attention_block_ln_reference(*a, tm, **kw), targs, tg)
    _, res = t_fab.fused_attention_block_ln_reference(*targs, tm, return_residuals=True, **kw)
    x, wq, _, wk, _, wv, _, wo, _, gamma, _ = targs
    plain = t_fab.fused_attention_block_ln_backward_reference(
        tg, x, res["qkv"], res["o"], res["z"], wq, wk, wv, wo, gamma, tm, **kw)
    wrapped = _grads(lambda *a: t_fab.fused_attention_block_ln(
        *a, tm, num_heads=nh, ln_eps=eps, rate=rate, deterministic=False, seed=seed), targs, tg)
    no_drop = _grads(lambda *a: t_fab.fused_attention_block_ln_reference(
        *a, tm, num_heads=nh, ln_eps=eps), targs, tg)
    scale = {n: float(w.abs().max()) for n, w in zip(ATTN_NAMES, want)}
    scale["bk"] = scale["bq"]                  # dbk is zero in exact arithmetic
    for n, p, a, w, nd in zip(ATTN_NAMES, plain, wrapped, want, no_drop):
        assert torch.equal(p, a), n
        np.testing.assert_allclose(p.numpy(), w.numpy(), rtol=0, atol=1e-5 * scale[n],
                                   err_msg=n)
        if n in ("x", "wo", "bo"):             # the mask matters
            assert float((nd - w).abs().max()) > 1e-2 * scale[n]


@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_ffn_dropout_backward_replays_the_forward_masks(activation):
    r, h, f, eps, rate, seeds = 120, 128, 256, 1e-5, 0.1, (31, 32)
    rng = np.random.default_rng(6)
    targs = [torch.from_numpy(a) for a in (
        _np(rng, r, h), _np(rng, f, h, std=h ** -0.5), _np(rng, f, std=0.05),
        _np(rng, h, f, std=f ** -0.5), _np(rng, h, std=0.05), 1.0 + _np(rng, h, std=0.1),
        _np(rng, h, std=0.1))]
    tg = torch.from_numpy(_np(rng, r, h))
    kw = dict(activation=activation, ln_eps=eps, rate=rate, seeds=seeds)
    want = _grads(lambda *a: t_ffn.fused_ffn_ln_reference(*a, **kw), targs, tg)
    out, res = t_ffn.fused_ffn_ln_reference(*targs, return_residuals=True, **kw)
    plain = t_ffn.fused_ffn_ln_backward_reference(tg, targs[0], res["hd"], res["z"], targs[1],
                                                  targs[3], targs[5], **kw)
    wrapped = _grads(lambda *a: t_ffn.fused_ffn_ln(*a, activation=activation, ln_eps=eps,
                                                   rate=rate, deterministic=False, seeds=seeds),
                     targs, tg)
    assert torch.equal(t_ffn.fused_ffn_ln(*targs, activation=activation, ln_eps=eps, rate=rate,
                                          deterministic=False, seeds=seeds), out)
    for n, p, a, w in zip(FFN_NAMES, plain, wrapped, want):
        assert torch.equal(p, a), n
        np.testing.assert_allclose(p.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()), err_msg=n)
    if activation == "relu":
        # The backward keeps no inner mask: it recovers it from hd > 0, which
        # is exactly the drawn mask where relu(h) > 0.
        hpre = targs[0] @ targs[1].t() + targs[2]
        drawn = t_rng.dropout_mask(seeds[0], 0, (r, f), rate)
        assert torch.equal(res["hd"] > 0, drawn & (hpre > 0))
        assert 0.85 < drawn.float().mean().item() < 0.95
