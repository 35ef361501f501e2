"""The LayerNorm backward's and the column sums' order, on the CPU.

The card's LayerNorm backward (``fairmultimodal_torch/ops/csrc/add_layernorm.cu``,
``layernorm_bwd_kernel``) and the fixed-order column sums that turn its
partials into dgamma, dbeta and the bias grad (``gemm.cu``, ``colsum_kernel``)
keep four orders, whatever grid and memory path bring the rows to the SM:

1. a row's sums: lane l holds the 8-wide chunks l + 32 j, sums them serially
   in (j, k) order, then ``fm::warp_sum``'s butterfly (xor 16, 8, 4, 2, 1);
2. the elementwise terms: xhat = (z - mu) * rstd, g * gamma rounded into m1's
   sum and fused into m2's, dz = rstd * fma(-xhat, m2, fma(g, gamma, -m1)),
   da = the dropout replay of dz at the flat index row * H + col;
3. a 64-row unit's partials of (g * xhat, g, da): warp w sums rows w, w + 8,
   ..., w + 56 in order (g * xhat fused), then the 8 warps in warp order;
4. a column sum: chain r = 0..7 over rows r, r + 8, ... from +0, then the
   chains in order from +0 (the "tall" layout streams 256-row tiles whose
   rows past M land as +0; the "wide" one loads 8 rows at a time, +0 past
   M; both give the chain order's bits, since a chain begun at +0 is never
   -0 and so a +0 added to it changes no bit).

``_kernel_order`` and ``_colsum_chains`` repeat them in PyTorch (an fma as
one rounding of the float64 product and sum).  The tests hold them against
``_layer_norm_vjp`` (the plain version), against ``_ln_bwd_math`` of the
JAX package, and against ``jax.vjp`` of Pallas #4 (``fused_ffn_ln``) in
interpret mode, at fp32, each output within TOL of its max-abs: the orders
of the sums differ and rsqrt rounds differently, nothing else.  R is ragged
(one whole 64-row unit and one of 16), H 64 / 256 / 768 / 1024, dropout on
and off, dz in fp32 and in the io dtype (bf16, within BF16_TOL: one bf16
rounding of dz and of da).  The column-sum layouts against the chain order
bit for bit, at M <= 8 with -0 entries (an all -0 column sums to +0) and
across tiles, one plane and three.

And the launch plans against the kernel sources: rows a unit, threads, the
shared bytes a block (132 x H), blocks an SM (two at H 768 in bf16 and fp32,
one at H 1024, under 227 KB), the persistent grid, the column sums' layouts
and their ring, and that the wrapper hands up to three planes to one launch
(the LayerNorm-fused backwards' three sums, the glue's two).
"""

import contextlib
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairmultimodal_torch.ops import _build
from fairmultimodal_torch.ops.fused_attention_block import _layer_norm_vjp
from fairmultimodal_torch.utils.rng import Dropout, apply_dropout
from test_torch_flash_tma_layout import _Recorder

j_ffn = importlib.import_module("fairmultimodal_tpu.ops.fused_ffn")   # the module, not the op
_OPS = Path(__file__).resolve().parents[1] / "fairmultimodal_torch" / "ops"
_LN_SRC = (_OPS / "csrc" / "add_layernorm.cu").read_text()
_GEMM_SRC = (_OPS / "csrc" / "gemm.cu").read_text()

R = 80                 # one whole 64-row unit and a ragged one of 16
EPS = 1e-5
TOL = 1e-5             # of each output's max-abs: fp32 summation order and rsqrt only
BF16_TOL = 2 ** -7     # dz / da in bf16: one rounding each, against the plain's own rounding
UNIT = _build.LN_BWD_ROWS
BF = torch.bfloat16


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _butterfly(v):
    """``fm::warp_sum`` over the last axis (32 lanes): v += shfl_xor(v, o)."""
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    return v[..., 0]


def _lanes(t, nc):
    """[R, H] -> [R, 32, NC, 8] (lane, chunk j, element k), +0 past H, and
    whether each chunk exists."""
    r, h = t.shape
    pad = torch.zeros(r, nc * 256, dtype=t.dtype)
    pad[:, :h] = t
    have = (torch.arange(nc * 32).view(nc, 32).T * 8 < h)       # [32, NC]
    return pad.view(r, nc, 32, 8).permute(0, 2, 1, 3), have


def _unlanes(t, h):
    return t.permute(0, 2, 1, 3).reshape(t.shape[0], -1)[:, :h]


def _kernel_order(g, z, gamma, eps, drop=Dropout()):
    """(dz, da, part) as ``layernorm_bwd_kernel`` computes them in fp32 (dz
    and da before they are stored in the output dtypes)."""
    r, h = g.shape
    nc = -(-h // 256)
    gv, have = _lanes(g.float(), nc)
    zv, _ = _lanes(z.float(), nc)
    gm = _lanes(gamma.float().expand(1, h), nc)[0]
    zero = torch.zeros(r, 32)

    def serial(step):
        s = zero
        for j in range(nc):
            for k in range(8):
                s = torch.where(have[:, j], step(s, j, k), s)
        return s

    mu = _butterfly(serial(lambda s, j, k: s + zv[:, :, j, k])) / h
    mu_ = mu[:, None]
    sq = serial(lambda s, j, k: _fma(zv[:, :, j, k] - mu_, zv[:, :, j, k] - mu_, s))
    rstd = torch.rsqrt(_butterfly(sq) / h + eps)[:, None, None, None]
    xhat = (zv - mu[:, None, None, None]) * rstd
    gg = gv * gm
    m1 = (_butterfly(serial(lambda s, j, k: s + gg[:, :, j, k])) / h)[:, None, None, None]
    m2 = (_butterfly(serial(lambda s, j, k: _fma(gg[:, :, j, k], xhat[:, :, j, k], s)))
          / h)[:, None, None, None]
    dz = _unlanes(rstd * _fma(-xhat, m2.expand_as(xhat), _fma(gv, gm.expand_as(gv),
                                                                -m1.expand_as(gv))), h)
    da = apply_dropout(dz, drop)
    xh = _unlanes(xhat, h)
    # The units' partials: rows padded to whole units with g = xhat = da = +0.
    units = -(-r // UNIT)
    pads = [torch.zeros(units * UNIT, h) for _ in range(3)]
    pads[0][:r], pads[1][:r], pads[2][:r] = g.float(), xh, da
    gp, xp, ap = (t.view(units, UNIT // 8, 8, h) for t in pads)  # [unit, t, warp, H]
    slices = [torch.zeros(units, 8, h) for _ in range(3)]
    for t in range(UNIT // 8):
        slices[0] = _fma(gp[:, t], xp[:, t], slices[0])
        slices[1] = slices[1] + gp[:, t]
        slices[2] = slices[2] + ap[:, t]
    part = torch.zeros(3, units, h)
    for w in range(8):
        part = part + torch.stack([s[:, w] for s in slices])
    return dz, da, part


def _colsum_chains(x):
    """[P, M, N] -> [P, N]: chain r over rows r, r + 8, ... from +0, then
    the chains in order from +0."""
    p, m, n = x.shape
    s = torch.zeros(p, 8, n)
    for i in range(-(-m // 8)):
        rows = x[:, 8 * i:8 * i + 8]
        s[:, :rows.shape[1]] = s[:, :rows.shape[1]] + rows
    t = torch.zeros(p, n)
    for r in range(8):
        t = t + s[:, r]
    return t


def _colsum_tall(x):
    """The tall layout: tiles of ``tile`` rows, rows past M read as +0,
    each chain adding its rows of a tile in order."""
    p, m, n = x.shape
    tile = _build.COLSUM["tile"]
    tiles = -(-m // tile)
    pad = torch.zeros(p, tiles * tile, n)
    pad[:, :m] = x
    s = torch.zeros(p, 8, n)
    for i in range(tiles):
        rows = pad[:, i * tile:(i + 1) * tile].view(p, tile // 8, 8, n)
        for k in range(tile // 8):
            s = s + rows[:, k]
    t = torch.zeros(p, n)
    for r in range(8):
        t = t + s[:, r]
    return t


def _colsum_wide(x):
    """The wide layout: 8 rows at a time, +0 past M, into 8 chains."""
    p, m, n = x.shape
    s = torch.zeros(p, 8, n)
    for m0 in range(0, m, 8):
        v = torch.zeros(p, 8, n)
        v[:, :min(8, m - m0)] = x[:, m0:m0 + 8]
        s = s + v
    t = torch.zeros(p, n)
    for r in range(8):
        t = t + s[:, r]
    return t


def _inputs(seed, r, h, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.normal(0, 1, (r, h)).astype(np.float32)).to(dtype)
    z = torch.from_numpy((rng.normal(0, 2, (r, h)) + 0.5).astype(np.float32)).to(dtype)
    gamma = torch.from_numpy((1 + 0.1 * rng.normal(0, 1, h)).astype(np.float32))
    return g, z, gamma


def _close(name, got, want, tol):
    scale = max(want.abs().max().item(), 1e-30)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * scale, f"{name}: {err} > {tol} of {scale}"


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("h", [64, 256, 768, 1024])
def test_kernel_order_matches_plain_and_jax(h, rate):
    g, z, gamma = _inputs(h + int(rate * 10), R, h)
    drop = Dropout.make(9 + h, 1, rate) if rate else Dropout()
    dz, da, part = _kernel_order(g, z, gamma, EPS, drop)
    sums = _colsum_chains(part)
    want_dz, want_dgamma, want_dbeta = _layer_norm_vjp(g, z, gamma, EPS)
    want_da = apply_dropout(want_dz, drop)
    _close("dz", dz, want_dz, TOL)
    _close("da", da, want_da, TOL)
    for name, got, want in (("dgamma", sums[0], want_dgamma), ("dbeta", sums[1], want_dbeta),
                            ("bias grad", sums[2], want_da.sum(0))):
        _close(name, got, want, TOL)
    # Each unit's partials against the plain sums over its rows.
    for u in range(-(-R // UNIT)):
        rows = slice(u * UNIT, (u + 1) * UNIT)
        _, pg, pb = _layer_norm_vjp(g[rows], z[rows], gamma, EPS)
        _close(f"unit {u} g*xhat", part[0, u], pg, TOL)
        _close(f"unit {u} g", part[1, u], pb, TOL)
        _close(f"unit {u} da", part[2, u], want_da[rows].sum(0), TOL)
    jdz, jdgamma, jdbeta = j_ffn._ln_bwd_math(jnp.asarray(g.numpy()), jnp.asarray(z.numpy()),
                                              jnp.asarray(gamma.numpy()), EPS)
    _close("dz vs jax", dz, torch.from_numpy(np.array(jdz)), TOL)
    _close("dgamma vs jax", sums[0], torch.from_numpy(np.array(jdgamma)).view(-1), TOL)
    _close("dbeta vs jax", sums[1], torch.from_numpy(np.array(jdbeta)).view(-1), TOL)


@pytest.mark.parametrize("dz_io", [False, True])
def test_kernel_order_in_bf16_io(dz_io):
    """bf16 g and z: dz stored in fp32 or (the glue's residual branch) in
    bf16, da in bf16; the partials stay fp32 sums of the fp32 terms."""
    g, z, gamma = _inputs(5, R, 768, BF)
    drop = Dropout.make(77, 1, 0.1)
    dz, da, part = _kernel_order(g, z, gamma, EPS, drop)
    stored_dz = dz.to(BF) if dz_io else dz
    want_dz, want_dgamma, want_dbeta = _layer_norm_vjp(g.float(), z, gamma, EPS)
    want_da = apply_dropout(want_dz, drop)
    _close("dz", stored_dz, want_dz.to(stored_dz.dtype), BF16_TOL if dz_io else TOL)
    _close("da", da.to(BF), want_da.to(BF), BF16_TOL)
    sums = _colsum_chains(part)
    for name, got, want in (("dgamma", sums[0], want_dgamma), ("dbeta", sums[1], want_dbeta),
                            ("bias grad", sums[2], want_da.sum(0))):
        _close(name, got, want, TOL)


def test_kernel_order_matches_pallas_ffn_ln_vjp():
    """Pallas #4 in interpret mode (dropout off): its dgamma, dbeta and db2
    are the LayerNorm VJP's column sums over every row, from the z its
    forward stored; the order model gives them from the same g and z."""
    h, f = 128, 256
    rng = np.random.default_rng(21)
    x = rng.normal(0, 1, (R, h)).astype(np.float32)
    w1 = rng.normal(0, h ** -0.5, (h, f)).astype(np.float32)
    b1 = rng.normal(0, 0.05, f).astype(np.float32)
    w2 = rng.normal(0, f ** -0.5, (f, h)).astype(np.float32)
    b2 = rng.normal(0, 0.05, h).astype(np.float32)
    gamma = (1 + 0.1 * rng.normal(0, 1, h)).astype(np.float32)
    beta = rng.normal(0, 0.1, h).astype(np.float32)
    g = rng.normal(0, 1, (R, h)).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, w1, b1, w2, b2, gamma, beta)]
    seed = jnp.zeros((2,), jnp.int32)
    _, _, jz = j_ffn._fwd_ln_impl(*args, seed, rate=0.0, deterministic=True, interpret=True,
                                  activation="relu", ln_eps=EPS)

    def fn(*a):
        return j_ffn.fused_ffn_ln(*a, seed, 0.0, True, True, "relu", EPS)

    _, vjp = jax.vjp(fn, *args)
    grads = vjp(jnp.asarray(g))
    jdb2, jdgamma, jdbeta = (torch.from_numpy(np.array(grads[i])) for i in (4, 5, 6))
    z = torch.from_numpy(np.array(jz)[:R])
    _, _, part = _kernel_order(torch.from_numpy(g), z, torch.from_numpy(gamma), EPS)
    sums = _colsum_chains(part)
    _close("dgamma vs Pallas #4", sums[0], jdgamma, TOL)
    _close("dbeta vs Pallas #4", sums[1], jdbeta, TOL)
    _close("db2 vs Pallas #4", sums[2], jdb2, TOL)


@pytest.mark.parametrize("planes,m,n", [(1, 1, 40), (1, 3, 40), (2, 8, 40), (3, 33, 24),
                                        (3, 140, 48), (1, 300, 16), (3, 530, 24)])
def test_colsum_layouts_give_the_chain_order(planes, m, n):
    rng = np.random.default_rng(m * 7 + n)
    x = torch.from_numpy(rng.normal(0, 1, (planes, m, n)).astype(np.float32))
    x[:, :, ::5] = -0.0                       # all -0 columns
    x[:, 0, 1::7] = -x[:, -1, 1::7] if m > 1 else x[:, 0, 1::7]   # cancelling pairs
    want = _colsum_chains(x)
    for got in (_colsum_tall(x), _colsum_wide(x)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not torch.signbit(want[:, ::5]).any()        # an all -0 column sums to +0
    _close("sum", want, x.double().sum(1).float(), TOL)


# -- the launch plans against the kernel sources ----------------------------------------


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_layernorm_bwd_plan_matches_the_kernel_source():
    plan = _build.LN_BWD
    assert plan["rows"] == _const(_LN_SRC, "BWD_ROWS") == UNIT == 64
    assert plan["threads"] == _const(_LN_SRC, "LN_THREADS")
    assert plan["warps"] == plan["threads"] // 32
    assert plan["sm_smem"] == _const(_LN_SRC, "SM_SMEM")
    assert plan["reserved"] == _const(_LN_SRC, "BLOCK_RESERVED_SMEM")
    m = re.search(r"constexpr int bwd_min_blocks\(int nc\) \{ return nc <= (\d) \? (\d) : (\d); \}",
                  _LN_SRC)
    cut, lo, hi = (int(v) for v in m.groups())
    assert plan["min_blocks"] == {nc: lo if nc <= cut else hi for nc in (1, 2, 3, 4)}
    assert re.search(r"__launch_bounds__\(LN_THREADS, bwd_min_blocks\(NC\)\)", _LN_SRC)
    # The shared bytes: slices, gamma, ring rows (g and z of bf16, z of fp32).
    body = re.search(r"constexpr int bwd_smem\(int H\) \{\s*return (.+?);\s*\}", _LN_SRC,
                     re.S).group(1)
    assert "WARPS * 3 * H + H" in body and "ring_holds_g<T>() ? 2 : 1" in body
    assert re.search(r"constexpr bool ring_holds_g\(\) \{ return sizeof\(T\) == 2; \}",
                     _LN_SRC)
    for dt in (BF, torch.float32):
        for h in (64, 256, 768, 1024):
            assert _build.layernorm_bwd_plan(R, h, dt, 132)["smem"] == 132 * h


@pytest.mark.parametrize("dtype", [BF, torch.float32])
def test_layernorm_bwd_plan_at_the_main_shapes(dtype):
    lab = _build.layernorm_bwd_plan(143360, 768, dtype, 132)
    assert lab == dict(smem=101376, blocks_per_sm=2, units=2240, grid=264)
    b16 = _build.layernorm_bwd_plan(8960, 768, dtype, 132)
    assert b16["blocks_per_sm"] == 2 and b16["grid"] == b16["units"] == 140   # all resident
    wide = _build.layernorm_bwd_plan(8960, 1024, dtype, 132)
    assert wide["smem"] <= 232448 and wide["blocks_per_sm"] == 1          # 227 KB a block
    assert _build.layernorm_bwd_plan(8784, 256, dtype, 132)["blocks_per_sm"] == 2
    assert _build.layernorm_bwd_plan(80, 768, dtype, 132)["grid"] == 2


def _colsum_launch(m, n, planes=1):
    """``fm_colsum``'s launch at M x N: (layout, grid, threads)."""
    plan = _build.COLSUM
    if m <= plan["wide_rows"]:
        cols = n // 4 if n % 4 == 0 else n
        return "wide", (-(-cols // plan["wide_threads"]), planes), plan["wide_threads"]
    return "tall", (-(-n // plan["cols"]), planes), plan["cols"] * plan["chains"]


def test_colsum_plan_matches_the_kernel_source():
    plan = _build.COLSUM
    for key, name in (("cols", "COLSUM_COLS"), ("chains", "COLSUM_CHAINS"),
                      ("tile", "COLSUM_TILE"), ("stages", "COLSUM_STAGES"),
                      ("wide_rows", "COLSUM_WIDE_ROWS"), ("wide_threads", "COLSUM_WIDE_THREADS"),
                      ("planes", "COLSUM_MAX_PLANES")):
        assert plan[key] == _const(_GEMM_SRC, name), key
    ring = plan["stages"] * plan["tile"] * plan["cols"] * 4
    assert ring + plan["chains"] * (plan["cols"] + 1) * 4 <= 48 * 1024      # static shared
    assert plan["cols"] * 4 == 32                  # a tall tile row is one 32-byte sector
    assert plan["tile"] % plan["chains"] == 0      # a tile starts a new round of the chains
    assert _colsum_launch(2240, 768, 3) == ("tall", (96, 3), 64)
    assert _colsum_launch(140, 768, 3) == ("tall", (96, 3), 64)
    assert _colsum_launch(7, 1769472) == ("wide", (1728, 1), 256)   # 4 columns a thread
    assert _colsum_launch(3, 4098) == ("wide", (17, 1), 256)       # N % 4 != 0: one
    assert _colsum_launch(32, 589824)[0] == "wide"
    assert _colsum_launch(33, 589824)[0] == "tall"
    launch = re.search(r"if \(M <= COLSUM_WIDE_ROWS\) \{(.+?)\n  \}", _GEMM_SRC, re.S).group(1)
    assert "N % 4 == 0" in launch and "? 4 : 1" in launch and "colsum_kernel<true>" in launch


def _recording(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, "kernels", lambda: rec)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build, "_stream", lambda t: 0)
    return rec


@pytest.mark.parametrize("planes", [1, 2, 3])
def test_colsum_hands_its_planes_to_one_launch(monkeypatch, planes):
    rec = _recording(monkeypatch)
    x = torch.zeros(planes, 140, 48)
    outs = [torch.zeros(48, dtype=BF if i == 2 else torch.float32) for i in range(planes)]
    assert _build.colsum(x if planes > 1 else x[0], *outs) is outs[0]
    (fn, args), = rec.calls
    assert fn == "fm_colsum" and len(args) == len(_build._SIGNATURES["gemm.cu"]["fm_colsum"])
    ptrs, (m, n, p, mask, _stream) = args[1:4], args[4:]
    assert ptrs == tuple([o.data_ptr() for o in outs] + [None] * (3 - planes))
    assert (m, n, p, mask) == (140, 48, planes, 4 if planes == 3 else 0)
    with pytest.raises(ValueError):
        _build.colsum(x if planes > 1 else x[0], *outs, torch.zeros(48))


def test_ln_fused_backwards_sum_their_three_planes_in_one_launch():
    for mod, bias in (("fused_attention_block.py", "dbo"), ("fused_ffn.py", "db2")):
        src = (_OPS / mod).read_text()
        stage = re.search(r'\("ln_bias_sums", (.+?)\),\n', src).group(1)
        assert stage == f"lambda: _build.colsum(part, dgamma, dbeta, {bias})", mod
    glue = (_OPS / "dropout_add_layernorm.py").read_text()
    assert glue.count("_build.colsum(") == 1 and "_build.colsum(part[:2], dgamma, dbeta)" in glue
