"""The fp32 flash forward's design, on the CPU.

The card's fp32 forward (``fairmultimodal_torch/ops/csrc/flash_attention.cu``,
``flash_attn_fwd_f32_kernel``) makes one pass over key tiles of 64 (32 at
d 128) with a running row max and sum taken in log2 units: t = s * (scale
log2 e) + bias log2 e, p = exp2(t - m2), o rescaled when m2 grows and divided
by the fp32 row sum once at the end; its stats hand the backward m = m2 ln 2
(natural-log units) and l.  ``_kernel_order`` repeats that arithmetic in
PyTorch, and the tests hold it

- against the Pallas kernel in interpret mode (2e-5 of max-abs, the plain
  version's forward limit) and against float64 (1e-5 of max-abs, the card
  check's limit in ``chip_smoke.py`` phase 3d, a fully masked row held to the
  mean of v) at a ragged S, d 32 / 64 / 96 / 128, with and without masks;
- for its stats: a fully masked row gets m = -1e9 exactly and l = S, so the
  backward's p = exp(s * scale + bias - m) / l is its uniform softmax; on
  every row that p is the softmax within fp32 rounding and sums to 1.

And the kernel's geometry, read from the source: the rows per block that
``_build.flash_fwd_f32_rows`` repeats (112 at S 560, 128 at S 512), the
thread map (every row, key and output column of a tile owned once) and the
shared memory of each instantiation (one block per SM, within 227 KB).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairmultimodal_torch.ops import _build
from fairmultimodal_torch.ops import flash_attention as t_flash
from fairmultimodal_tpu.ops.flash_attention import flash_attention as j_flash

_SRC = (Path(__file__).resolve().parents[1] / "fairmultimodal_torch" / "ops" / "csrc"
        / "flash_attention.cu").read_text()
B, NH, S = 3, 2, 80          # S: whole key tiles and a ragged one of 16
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
PALLAS_TOL, F64_TOL = 2e-5, 1e-5


def _tile(d):
    return 32 if d == 128 else 64


def _inputs(seed, d, masked):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, 1, (B, NH, S, d)).astype(np.float32) for _ in range(3))
    mask = None
    if masked:
        lens = rng.integers(S // 3, S, B)
        mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
        mask[-1] = 0                  # a fully masked row: finite, uniform softmax
    return q, k, v, mask


def _bias(mask, b, s):
    if mask is None:
        return torch.zeros(b, s)
    return torch.where(torch.as_tensor(mask) > 0, 0.0, -1e9)


def _kernel_order(q, k, v, mask):
    """(o, m, l) as the card's fp32 forward computes them from fp32 q, k, v
    [B, heads, S, d]: key tiles, t = s * (scale log2 e) + bias log2 e, the
    running max m2 and sum l in fp32, p = exp2(t - m2), o rescaled when m2
    grows and divided by l once at the end; m = m2 ln 2."""
    b, nh, s, d = q.shape
    f = torch.float32
    scale2 = torch.tensor(1.0 / d ** 0.5, dtype=f) * torch.tensor(LOG2E, dtype=f)
    bias2 = (_bias(mask, b, s) * torch.tensor(LOG2E, dtype=f))[:, None, None, :]
    m = torch.full((b, nh, s), float("-inf"))
    l = torch.zeros(b, nh, s)
    o = torch.zeros(b, nh, s, d)
    tile = _tile(d)
    for k0 in range(0, s, tile):
        t = (q @ k[:, :, k0:k0 + tile].transpose(-1, -2)) * scale2 + bias2[..., k0:k0 + tile]
        m_new = torch.maximum(m, t.amax(-1))
        alpha = torch.exp2(m - m_new)                  # 0 on the first tile
        p = torch.exp2(t - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + p @ v[:, :, k0:k0 + tile]
        m = m_new
    return o / l[..., None], m * torch.tensor(LN2, dtype=f), l


def _f64_reference(q, k, v, mask):
    """The same function in float64; a fully masked row is the mean of v
    (fp32's s * scale - 1e9 rounds to -1e9 for every key)."""
    want = t_flash.flash_attention_reference(q.double(), k.double(), v.double(),
                                             None if mask is None else torch.as_tensor(mask))
    if mask is not None:
        dead = torch.as_tensor(~(mask > 0).any(axis=1))
        want[dead] = v.double()[dead].mean(dim=2, keepdim=True).expand_as(want[dead])
    return want


@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("masked", [False, True])
def test_one_pass_order_matches_pallas_interpret_and_float64(masked, d):
    q, k, v, mask = _inputs(7 + d, d, masked)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got, _, _ = _kernel_order(tq, tk, tv, mask)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None if mask is None else jnp.asarray(mask), True), np.float32)
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= PALLAS_TOL * scale
    want64 = _f64_reference(tq, tk, tv, mask)
    err = float((got.double() - want64).abs().max())
    assert err <= F64_TOL * float(want64.abs().max()), err


@pytest.mark.parametrize("d", [64, 96])
def test_stats_give_the_backward_its_softmax(d):
    q, k, v, mask = _inputs(31 + d, d, masked=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _, m, l = _kernel_order(tq, tk, tv, mask)
    # The fully masked row: m is -1e9 exactly and l counts every key, so the
    # backward's p is 1 / S for each key, the forward's uniform softmax.
    assert torch.equal(m[-1], torch.full_like(m[-1], -1e9))
    assert torch.equal(l[-1], torch.full_like(l[-1], float(S)))
    x = (tq @ tk.transpose(-1, -2)) / d ** 0.5 + _bias(mask, B, S)[:, None, None]
    live = torch.as_tensor((mask > 0).any(axis=1))
    # Elsewhere m is the row max of s * scale + bias within a few roundings ...
    np.testing.assert_allclose(m[live].numpy(), x[live].amax(-1).numpy(), rtol=1e-6, atol=0)
    # ... and the backward's recompute is the softmax, summing to 1.
    p = torch.exp(x - m[..., None]) / l[..., None]
    want = torch.softmax(x.double(), dim=-1)
    np.testing.assert_allclose(p[live].double().numpy(), want[live].numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(p.double().sum(-1).numpy(), 1.0, rtol=0, atol=2e-6)


def _tm_rule():
    body = re.search(r"int f32_fwd_tm\(int S\) \{ return (.+?) \? 7 : 8; \}", _SRC).group(1)
    return lambda s: 112 if eval(body.replace("/", "//"), {"S": s}) else 128


@pytest.mark.parametrize("seq", [200, 256, 272, 384, 512, 549, 560, 768, 1024])
def test_rows_per_block_follow_the_kernel(seq):
    rows = _build.flash_fwd_f32_rows(seq)
    assert rows == _tm_rule()(seq)
    # The choice pads S to the fewer rows of the two tilings (ties to 128).
    pad = {bm: -(-seq // bm) * bm for bm in (112, 128)}
    assert pad[rows] == min(pad.values())
    if pad[112] == pad[128]:
        assert rows == 128


def test_rows_per_block_at_the_main_shapes():
    assert _build.flash_fwd_f32_rows(560) == 112      # the lab encoder: 5 x 112, no pad row
    assert _build.flash_fwd_f32_rows(512) == 128      # the text bucket: 4 x 128


def _smem(dp, tm):
    """FwdF32Smem<DP, TM>'s fields, evaluated from the source."""
    body = re.search(r"struct FwdF32Smem \{.*?\n\};", _SRC, re.S).group(0)
    env = {"DP": dp, "TM": tm}
    for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);", body):
        expr = re.sub(r"(\w+) == (\d+) \? (\d+) : (\d+)", r"(\3 if \1 == \2 else \4)", expr)
        env[name] = eval(expr, {}, env)
    return env


@pytest.mark.parametrize("dp", [32, 64, 96, 128])
@pytest.mark.parametrize("tm", [7, 8])
def test_thread_map_owns_each_row_key_and_column_once(dp, tm):
    geo = _smem(dp, tm)
    assert geo["BM"] == 16 * tm and geo["BN"] == _tile(dp)
    # One block per SM within the 227 KB a block may use; 16-byte pitches.
    assert geo["BYTES"] <= 232448
    assert geo["LD"] % 4 == 0 and (geo["LD"] // 4) % 2 == 1 and geo["LP"] % 32 == 16
    rows, keys, cols = [], [], []
    nq, h2 = dp // 64, dp % 64 == 32
    for tid in range(256):
        warp, lane = divmod(tid, 32)
        r, c = 2 * warp + lane // 16, lane % 16
        rows += [(c, r + 16 * i) for i in range(tm)]
        keys += [(r, c + 16 * j) for j in range(geo["BN"] // 16)]
        cols += [(r, 64 * jj + 4 * c + e) for jj in range(nq) for e in range(4)]
        cols += [(r, 64 * nq + 2 * c + e) for e in range(2)] if h2 else []
    # Per column lane, every row once; per row group, every key and column once.
    assert sorted(rows) == sorted((c, x) for c in range(16) for x in range(geo["BM"]))
    assert sorted(keys) == sorted((r, x) for r in range(16) for x in range(geo["BN"]))
    assert sorted(cols) == sorted((r, x) for r in range(16) for x in range(dp))
