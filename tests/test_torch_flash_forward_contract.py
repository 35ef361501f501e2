"""The bf16 flash forward's rounding contract, on the CPU.

The card's bf16 forward (``fairmultimodal_torch/ops/csrc/flash_attention.cu``,
``flash_attn_fwd_wgmma_kernel``) makes one pass over key tiles of
``_build.flash_fwd_bf16_keys(S)`` keys (112 at S 560 and 80, 128 at S 512)
with a running row max and sum, rounds the UNNORMALISED p = exp(s -
m_running) to bf16 before p.v, and divides o by the fp32 row sum once at the
end.  The
Pallas kernel (``fairmultimodal_tpu/ops/flash_attention.py::_fwd_kernel``)
rounds the normalised p instead.  ``_kernel_order`` repeats the card
kernel's arithmetic in that order in PyTorch, and the tests hold it

- against the Pallas kernel in interpret mode and against the port's plain
  ``flash_attention_reference`` (which follows the Pallas rounding), in
  bf16, under the limits the card check holds the kernel to
  (``chip_smoke.py`` phase 3d: max 2^-6, mean 2^-10 of the output's
  max-abs), at a ragged S (80: one tile of 112, 32 keys past S), with no
  mask and with per-row masks including a fully masked row, at d 32 and 64,
  and at the lab and text lengths (S 560 = 5 x 112, S 512 = 4 x 128) with a
  fully masked row;
- for its (m, l) stats: m is the row max of s * scale + bias, and
  exp(s * scale + bias - m) / l -- the p the backward kernels recompute --
  is the softmax (fp64) to fp32 rounding, summing to 1 over each row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairmultimodal_torch.ops import _build
from fairmultimodal_torch.ops import flash_attention as t_flash
from fairmultimodal_tpu.ops.flash_attention import flash_attention as j_flash

B, NH, S = 3, 2, 80          # S: one ragged key tile
LOG2E = 1.4426950408889634
FWD_MAX, FWD_MEAN = 2.0 ** -6, 2.0 ** -10


def _inputs(seed, d, masked, b=B, s=S):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, 1, (b, NH, s, d)).astype(np.float32) for _ in range(3))
    mask = None
    if masked:
        lens = rng.integers(s // 3, s, b)
        mask = (np.arange(s)[None] < lens[:, None]).astype(np.int32)
        mask[-1] = 0                  # a fully masked row: finite, uniform softmax
    return q, k, v, mask


def _bias(mask, b, s):
    if mask is None:
        return torch.zeros(b, s)
    return torch.where(torch.as_tensor(mask) > 0, 0.0, -1e9)


def _kernel_order(q, k, v, mask):
    """(o, m, l) as the card's bf16 forward computes them: q, k, v bf16
    [B, heads, S, d]; key tiles of the kernel's width at S
    (``_build.flash_fwd_bf16_keys``), scale then the -1e9 key bias added to
    the fp32 scores, the running max m and sum l in fp32, exp taken as
    exp2((x - m) * log2 e), p rounded to bf16 before p.v, o rescaled when m
    grows and divided by l once at the end, then rounded to bf16."""
    b, nh, s, d = q.shape
    scale = 1.0 / d ** 0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    bias = _bias(mask, b, s)[:, None, None, :]
    m = torch.full((b, nh, s), float("-inf"))
    l = torch.zeros(b, nh, s)
    o = torch.zeros(b, nh, s, d)
    tile = _build.flash_fwd_bf16_keys(s)
    for k0 in range(0, s, tile):
        x = (qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)) * scale + bias[..., k0:k0 + tile]
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2((m - m_new) * LOG2E)        # 0 on the first tile
        p = torch.exp2((x - m_new[..., None]) * LOG2E)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + tile]
        m = m_new
    return (o / l[..., None]).to(torch.bfloat16), m, l


def _within(name, got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    assert err.max() <= FWD_MAX * scale, f"{name}: max {err.max()} (max-abs {scale})"
    assert err.mean() <= FWD_MEAN * scale, f"{name}: mean {err.mean()} (max-abs {scale})"


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("masked", [False, True])
def test_one_pass_order_matches_pallas_interpret_in_bf16(masked, d):
    q, k, v, mask = _inputs(11 + d, d, masked)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = j_flash(jq, jk, jv, None if mask is None else jnp.asarray(mask), True)
    got, _, _ = _kernel_order(tq, tk, tv, mask)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    assert torch.isfinite(got.float()).all()
    _within("vs Pallas", got, jnp.asarray(want, jnp.float32))
    tm = None if mask is None else torch.from_numpy(mask)
    _within("vs plain", got, t_flash.flash_attention_reference(tq, tk, tv, tm).float())
    if masked:                        # the fully masked row: the mean of v over every key
        np.testing.assert_allclose(got[-1].float().numpy(),
                                   tv[-1].float().mean(dim=1, keepdim=True)
                                   .expand(NH, S, d).numpy(), rtol=0, atol=2e-2)


@pytest.mark.parametrize("s,d,tiles", [(560, 32, 5), (512, 64, 4)])
def test_key_tiles_of_the_lab_and_text_lengths_match_pallas_in_bf16(s, d, tiles):
    # Several running maxima per row (the kernel's tiles), a fully masked row.
    assert -(-s // _build.flash_fwd_bf16_keys(s)) == tiles
    q, k, v, mask = _inputs(5 + d, d, True, b=2, s=s)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = j_flash(jq, jk, jv, jnp.asarray(mask), True)
    got, m, l = _kernel_order(tq, tk, tv, mask)
    assert torch.isfinite(got.float()).all()
    _within("vs Pallas", got, jnp.asarray(want, jnp.float32))
    _within("vs plain", got, t_flash.flash_attention_reference(
        tq, tk, tv, torch.from_numpy(mask)).float())
    np.testing.assert_allclose(got[-1].float().numpy(),
                               tv[-1].float().mean(dim=1, keepdim=True).expand(NH, s, d).numpy(),
                               rtol=0, atol=2e-2)
    x = (tq.float() @ tk.float().transpose(-1, -2)) / d ** 0.5 + _bias(mask, 2, s)[:, None, None]
    np.testing.assert_allclose((torch.exp(x - m[..., None]) / l[..., None]).double().sum(-1)
                               .numpy(), 1.0, rtol=0, atol=2e-6)


@pytest.mark.parametrize("d", [32, 64])
def test_stats_give_the_two_pass_p(d):
    q, k, v, mask = _inputs(29 + d, d, masked=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    _, m, l = _kernel_order(tq, tk, tv, mask)
    x = (tq.float() @ tk.float().transpose(-1, -2)) / d ** 0.5 + _bias(mask, B, S)[:, None, None]
    torch.testing.assert_close(m, x.amax(-1), rtol=1e-6, atol=0)
    p = torch.exp(x - m[..., None]) / l[..., None]     # the backward's recompute
    want = torch.softmax(x.double(), dim=-1)
    np.testing.assert_allclose(p.double().numpy(), want.numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(p.double().sum(-1).numpy(), 1.0, rtol=0, atol=2e-6)
