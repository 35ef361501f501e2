"""The bf16 flash backward's contract, on the CPU.

The card's bf16 backward (``fairmultimodal_torch/ops/csrc/flash_attention.cu``,
``flash_bwd_dq_mma_kernel`` and ``flash_bwd_dkdv_mma_kernel``) recomputes p
from the forward's row statistics and takes the softmax-VJP row term from
the stored bf16 o.  ``chip_smoke.flash_bwd_kernel_order``, which the card
check holds the kernels to, repeats its arithmetic in PyTorch, in its order
of rounding:

- D = rowsum(dO * o), o the bf16 output of the kernel-order forward;
- p = exp2((s * scale + bias - m) * log2 e) * (1 / l), the forward's
  expression for its unnormalised p times the reciprocal of its row sum;
- dv = round(p)^T . dO; ds = p * (dO . v^T - D); round(ds * scale) before
  dq = . k and dk = ^T . q; dq, dk, dv rounded to bf16 when written.

The tests hold it against ``jax.vjp`` of the Pallas flash attention
(``fairmultimodal_tpu/ops/flash_attention.py``, #9 / #10 in interpret mode)
and against the port's plain ``flash_attention_backward_reference``, in bf16,
under the limits the card check holds the kernels to (``chip_smoke.py``
phase 3d: each grad within 2^-4 of its max-abs, mean 2^-10), at d 32 and 64,
with no mask and with per-row masks including a fully masked row.  Also the
pure-Python logic around the kernels: the column partials' row count from
the one tile definition, the tile definitions against the kernel sources,
and the split-K counts of the weight-grad GEMM for its 128 x 256 tiles.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairmultimodal_torch.ops import _build
from fairmultimodal_torch.ops import flash_attention as t_flash
from fairmultimodal_torch.ops import fused_attention_block as t_fab
from fairmultimodal_tpu.ops.flash_attention import flash_attention as j_flash

_ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", _ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

B, NH, S = 3, 2, 80          # S: one whole 64-row tile and a ragged one of 16
TILE = 64                    # the forward's key tile
LOG2E = 1.4426950408889634
GRAD_MAX, GRAD_MEAN = 2.0 ** -4, 2.0 ** -10
BF = torch.bfloat16


def _inputs(seed, d, masked):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(0, 1, (B, NH, S, d)).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        lens = rng.integers(S // 3, S, B)
        mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
        mask[-1] = 0                  # a fully masked row: finite, uniform softmax
    return q, k, v, do, mask


def _bias(mask, b, s):
    if mask is None:
        return torch.zeros(b, s)
    return torch.where(torch.as_tensor(mask) > 0, 0.0, -1e9)


def _kernel_forward(q, k, v, mask):
    """(o, m, l) of the card's bf16 forward (one pass over 64-key tiles,
    p rounded unnormalised, o divided by l once; see
    tests/test_torch_flash_forward_contract.py)."""
    b, nh, s, d = q.shape
    scale = 1.0 / d ** 0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    bias = _bias(mask, b, s)[:, None, None, :]
    m = torch.full((b, nh, s), float("-inf"))
    l = torch.zeros(b, nh, s)
    o = torch.zeros(b, nh, s, d)
    for k0 in range(0, s, TILE):
        x = (qf @ kf[:, :, k0:k0 + TILE].transpose(-1, -2)) * scale + bias[..., k0:k0 + TILE]
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2((x - m_new[..., None]) * LOG2E)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + p.to(BF).float() @ vf[:, :, k0:k0 + TILE]
        m = m_new
    return (o / l[..., None]).to(BF), m, l


def _within(name, got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    assert err.max() <= GRAD_MAX * scale, f"{name}: max {err.max()} (max-abs {scale})"
    assert err.mean() <= GRAD_MEAN * scale, f"{name}: mean {err.mean()} (max-abs {scale})"


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_order_matches_pallas_vjp_in_bf16(masked, d):
    q, k, v, do, mask = _inputs(41 + d, d, masked)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(BF) for a in (q, k, v, do))
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, do))
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b_, c: j_flash(a, b_, c, jmask, True), jq, jk, jv)
    want = vjp(jdo)
    o, m, l = _kernel_forward(tq, tk, tv, mask)
    tm = None if mask is None else torch.from_numpy(mask)
    got = chip_smoke.flash_bwd_kernel_order(tq, tk, tv, o, torch.stack([m, l], -1), tm, tdo)
    plain = t_flash.flash_attention_backward_reference(tq, tk, tv, tm, tdo)
    for name, g, w, pl in zip(("dq", "dk", "dv"), got, want, plain):
        assert g.dtype == BF and g.shape == tq.shape and torch.isfinite(g.float()).all()
        _within(f"{name} vs Pallas", g, jnp.asarray(w, jnp.float32))
        _within(f"{name} vs plain", g, pl.float())
    if masked:                        # the fully masked row: uniform p over every key
        x = (tq[-1].float() @ tk[-1].float().transpose(-1, -2)) / d ** 0.5 - 1e9
        p = torch.exp2((x - m[-1][..., None]) * LOG2E) / l[-1][..., None]
        np.testing.assert_allclose(p.numpy(), 1.0 / S, rtol=2e-2, atol=0)


def test_kernel_p_is_the_forward_softmax():
    q, k, v, _, mask = _inputs(7, 64, masked=True)
    tq, tk, tv = (torch.from_numpy(a).to(BF) for a in (q, k, v))
    _, m, l = _kernel_forward(tq, tk, tv, mask)
    x = (tq.float() @ tk.float().transpose(-1, -2)) / 8.0 + _bias(mask, B, S)[:, None, None]
    p = torch.exp2((x - m[..., None]) * LOG2E) * (1.0 / l[..., None])
    np.testing.assert_allclose(p.double().numpy(), torch.softmax(x.double(), -1).numpy(),
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("dtype,tile", [(torch.bfloat16, 64), (torch.float32, 32)])
def test_colpart_rows_follow_the_one_tile_definition(dtype, tile):
    assert _build.FLASH_BWD_TILE[dtype] == tile
    for b, s in ((256, 560), (32, 512), (3, 200), (1, 80), (2, 81)):
        assert _build.flash_bwd_colpart_rows(b, s, dtype) == b * -(-s // tile)
    assert _build.flash_bwd_colpart_rows(256, 560, torch.bfloat16) == 256 * 9   # 8 x 64 + 48
    # The wrapper sizes its check from the same definition: a partial buffer
    # with another tile's row count is refused before anything launches.
    x = torch.zeros(2, 4, 160, 32, dtype=dtype)
    stats = torch.zeros(2, 4, 160, 2)
    rowterm = torch.zeros(2, 4, 160)
    bad = torch.zeros(2 * 2, 3 * 4 * 32)            # ceil(160 / 80) rows per batch row
    with pytest.raises(ValueError, match="colpart"):
        _build.flash_attention_bwd(x, x, x, x, x, None, stats, rowterm, x, x, x, colpart=bad)


def test_tile_definitions_match_the_kernel_sources():
    csrc = _ROOT / "fairmultimodal_torch" / "ops" / "csrc"

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    gemm = (csrc / "gemm.cu").read_text()
    flash = (csrc / "flash_attention.cu").read_text()
    assert _build.WGMMA_TILE == (const(gemm, "WG_BM"), const(gemm, "WG_BN"))
    assert _build.FLASH_BWD_TILE == {torch.bfloat16: const(flash, "BWD_TILE"),
                                     torch.float32: const(flash, "F32_TL")}


@pytest.mark.parametrize("m,n,k,sms,splits", [
    (2304, 768, 256 * 560, 132, 7),   # dWqkv: 18 x 3 = 54 tiles -> 378 blocks, 2.9 waves
    (768, 768, 256 * 560, 132, 7),    # dWo: 18 tiles -> 126 blocks, one wave
    (2048, 768, 256 * 560, 132, 8),   # dW1: 48 tiles -> 384 blocks
    (768, 2048, 256 * 560, 132, 8),   # dW2
    (2304, 768, 600, 132, 1),         # fewer than 2048 rows: no split
    (2304, 768, 4096, 132, 2),
    (2304, 768, 256 * 560, 114, 2),   # a 114-SM card: 108 blocks fill one wave
])
def test_weight_grad_splits_fit_the_128x256_tiles(m, n, k, sms, splits):
    assert t_fab._splits(m, n, k, sms) == splits
    tiles = -(-m // 128) * -(-n // 256)
    assert tiles * splits <= 3 * sms and (splits == 1 or k // splits >= 2048)
