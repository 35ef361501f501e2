"""The port's kernel wrappers and plain versions against the JAX package.

The two Pallas kernels on the serving path run here as the JAX package's
own tests run them on the CPU (the Pallas interpreter); the port's plain
versions -- what its wrappers run on a CPU tensor, and what the card's
CUDA kernels are held against -- must agree at fp32 within 2e-5, the JAX
package's own kernel tolerance, and in bf16 within one bf16 ulp of the
LayerNorm output (see ``BF16_TOL``), which shows that the plain versions
round to bf16 where the TPU kernels round.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairmultimodal_torch.ops import attention as t_attn
from fairmultimodal_torch.ops import fused_attention_block as t_fab
from fairmultimodal_torch.ops import fused_ffn as t_ffn
from fairmultimodal_torch.ops import gates
from fairmultimodal_tpu.ops import attention as j_attn
from fairmultimodal_tpu.ops import fused_attention_block as j_fab
from fairmultimodal_tpu.ops.fused_ffn import fused_ffn_ln as j_fused_ffn_ln
from fairmultimodal_tpu.ops.fused_ffn import fused_ffn_ln_infer as j_fused_ffn_ln_infer

KTOL = dict(rtol=2e-5, atol=2e-5)
# bf16: both sides round the same intermediates (q/k/v, p, o, the activation,
# z) to bf16 but sum the fp32 products in another order, so a rounding can
# land one bf16 ulp apart and carry through the residual into the LayerNorm.
# The outputs are LayerNorm outputs with |y| < 4, where one bf16 ulp is at
# most 2**-6; a rounding point missing on one side moves them by far more.
BF16_TOL = dict(rtol=0.0, atol=2.0 ** -6)
IO_DTYPES = {"float32": (jnp.float32, torch.float32),
             "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(rng, *shape, std=1.0):
    return rng.normal(0, std, shape).astype(np.float32)


def _operands(x, args, n_io, dtype):
    """JAX and port operands from the same fp32 arrays: x and the first
    ``n_io`` args (weights, biases) in the io dtype, LayerNorm gamma/beta in
    fp32 as the models pass them; the port's weights in nn.Linear layout."""
    jdt, tdt = IO_DTYPES[dtype]
    jargs = [jnp.asarray(a).astype(jdt) if i < n_io else jnp.asarray(a)
             for i, a in enumerate(args)]
    targs = [torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a))
             for a in args]
    targs = [t.to(tdt) if i < n_io else t for i, t in enumerate(targs)]
    return jnp.asarray(x).astype(jdt), jargs, torch.from_numpy(x).to(tdt), targs


def _check(got, want, dtype):
    assert got.dtype == IO_DTYPES[dtype][1]
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(KTOL if dtype == "float32" else BF16_TOL))


def _attn_args(h, seed):
    rng = np.random.default_rng(seed)
    w = []
    for _ in range(4):
        w += [_np(rng, h, h, std=h ** -0.5), _np(rng, h, std=0.05)]
    gamma = 1.0 + _np(rng, h, std=0.1)
    beta = _np(rng, h, std=0.1)
    return w + [gamma, beta]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["ln", "infer"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("h,nh", [(256, 4), (384, 4)])   # d 64 and d 96
def test_attention_half_layer_matches_pallas_interpret(h, nh, masked, entry, dtype):
    b, s, eps = 2, 48, (1e-5 if entry == "ln" else 1e-12)
    rng = np.random.default_rng(h + masked)
    x = _np(rng, b, s, h)
    mask = None
    if masked:
        mask = rng.integers(0, 2, (b, s)).astype(np.int32)
        mask[0, 0] = 1
        mask[1, :] = 0       # a fully masked row: finite, uniform softmax
    jx, jargs, tx, targs = _operands(x, _attn_args(h, h), 8, dtype)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    if entry == "ln":
        want = j_fab.fused_attention_block_ln(jx, *jargs, jm, jnp.zeros((1,), jnp.int32), nh,
                                              0.1, True, True, eps)
        got = t_fab.fused_attention_block_ln(tx, *targs, tm, num_heads=nh, ln_eps=eps)
    else:
        want = j_fab.fused_attention_block_ln_infer(jx, *jargs, jm, nh, True, eps)
        got = t_fab.fused_attention_block_ln_infer(tx, *targs, tm, num_heads=nh, ln_eps=eps)
    assert got.shape == (b, s, h)
    _check(got, want, dtype)


def _ffn_args(h, f, seed):
    rng = np.random.default_rng(seed)
    return [_np(rng, h, f, std=h ** -0.5), _np(rng, f, std=0.05),
            _np(rng, f, h, std=f ** -0.5), _np(rng, h, std=0.05),
            1.0 + _np(rng, h, std=0.1), _np(rng, h, std=0.1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["ln", "infer"])
@pytest.mark.parametrize("activation,eps", [("relu", 1e-5), ("gelu", 1e-12),
                                            ("relu", 1e-12), ("gelu", 1e-5)])
def test_ffn_half_layer_matches_pallas_interpret(activation, eps, entry, dtype):
    r, h, f = 200, 256, 512     # R not a multiple of the row block: pad path
    rng = np.random.default_rng(7)
    x = _np(rng, r, h)
    jx, jargs, tx, targs = _operands(x, _ffn_args(h, f, 8), 4, dtype)
    if entry == "ln":
        want = j_fused_ffn_ln(jx, *jargs, jnp.zeros((2,), jnp.int32), 0.1,
                              True, True, activation, eps)
        got = t_ffn.fused_ffn_ln(tx, *targs, activation=activation, ln_eps=eps)
    else:
        want = j_fused_ffn_ln_infer(jx, *jargs, True, activation, eps)
        got = t_ffn.fused_ffn_ln_infer(tx, *targs, activation=activation, ln_eps=eps)
    _check(got, want, dtype)


def test_cpu_wrappers_run_the_plain_versions_bf16():
    """On a CPU tensor the wrapper is its plain version, in every dtype."""
    rng = np.random.default_rng(9)
    x_np = _np(rng, 2, 32, 128)
    _, _, x, a = _operands(x_np, _attn_args(128, 1), 8, "bfloat16")
    got = t_fab.fused_attention_block_ln_infer(x, *a, None, num_heads=2, ln_eps=1e-12)
    want = t_fab.fused_attention_block_ln_reference(x, *a, None, num_heads=2, ln_eps=1e-12)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    _, _, x2, f = _operands(x_np.reshape(-1, 128), _ffn_args(128, 256, 2), 4, "bfloat16")
    assert torch.equal(t_ffn.fused_ffn_ln(x2, *f, activation="gelu", ln_eps=1e-5),
                       t_ffn.fused_ffn_ln_reference(x2, *f, activation="gelu", ln_eps=1e-5))


def test_dropout_and_unknown_activation_raise():
    """Dropout without its Philox seed raises (it never draws from a global
    RNG); so does an unknown activation."""
    x = torch.zeros(2, 16, 128)
    a = [torch.from_numpy(t) for t in _attn_args(128, 3)]
    with pytest.raises(ValueError, match="needs a seed"):
        t_fab.fused_attention_block_ln(x, *a, None, num_heads=2, ln_eps=1e-5,
                                       deterministic=False)
    f = [torch.from_numpy(t) for t in _ffn_args(128, 128, 4)]
    with pytest.raises(ValueError, match="needs seeds"):
        t_ffn.fused_ffn_ln(x.view(-1, 128), *f, ln_eps=1e-5, deterministic=False)
    with pytest.raises(ValueError):
        t_ffn.fused_ffn_ln_infer(x.view(-1, 128), *f, activation="tanh", ln_eps=1e-5)


@pytest.mark.parametrize("seq", [1, 24])
def test_multi_head_attention_matches_jax(seq):
    rng = np.random.default_rng(seq)
    q, k, v = (_np(rng, 2, 3, seq, 16) for _ in range(3))
    mask = np.ones((2, seq), np.int32)
    mask[1, seq // 2:] = 0
    want = j_attn.multi_head_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(mask))
    got = t_attn.multi_head_attention(*map(torch.from_numpy, (q, k, v)),
                                      torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    if seq == 1:
        assert np.array_equal(got.numpy(), v)


def test_gates_are_off_on_cpu_and_device_none_means_cuda(monkeypatch):
    x = torch.zeros(1, 512, 768)
    assert not gates.can_use_fused_attention_block(x, 12)
    assert not gates.can_use_fused_ffn(x, 768, 3072)
    assert gates.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gates.resolve_device(None)
