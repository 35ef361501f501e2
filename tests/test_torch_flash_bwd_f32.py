"""The fp32 flash backward's pass order, on the CPU.

The card's fp32 backward (``fairmultimodal_torch/ops/csrc/flash_attention.cu``,
``flash_bwd_rowterm_f32_kernel``, ``flash_bwd_dkdv_f32_kernel`` and
``flash_bwd_dq_f32_kernel``) does each of the function's five [S, S, d]
products once, in three launches:

1. D = rowsum(dO * o), four column classes per row summed apart, then pairwise;
2. the dK / dV pass: p = exp(s * scale + bias - m) / l and ds = p * (dp - D) *
   scale from the forward's stats, dv += p^T . dO and dk += ds^T . q, and ds
   stored to a [B, heads, S, SP] scratch (SP = S rounded up to the 64-row
   owned tile: keys past S hold p = 0, so ds = 0);
3. the dQ pass: dq = ds . k from the stored ds, over the keys in walked tiles
   in order, with the column partials of each 64-row tile (each thread row's
   4 rows, then the 16 thread rows in order).

``_pass_order`` repeats that order in PyTorch.  The tests hold it against
``flash_attention_backward_reference`` and against ``jax.vjp`` of the Pallas
kernel (``fairmultimodal_tpu/ops/flash_attention.py``, #9 / #10, in interpret
mode), each grad within 5e-5 of its max-abs (the plain version's fp32
backward limit), at a ragged S (one whole 64-row tile and one of 16), d 32 /
64 / 96 / 128, with no mask and with per-row masks including a fully masked
row; its column partials against the plain grads' sums over each tile.  The
scratch's keys past S are zero, so the dQ walk to SP is the walk to S.

And the wrapper's plan against the kernel source: the scratch's shape, bytes
and row pitch (``_build.flash_bwd_f32_scratch``, ``f32_ds_pitch``), the owned
and walked tile rows of both passes and their shared memory (the dQ pass
two blocks per SM), and that the wrapper hands the fp32 launch a scratch and
the bf16 one none.  Also ``chip_smoke.flash_bwd_f64``, the float64 yardstick
of the card check (phase 3d), against the plain version in float64 and, on a
fully masked row, against the uniform softmax's VJP.
"""

import contextlib
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
from fairmultimodal_tpu.ops.flash_attention import flash_attention as j_flash
from test_torch_flash_tma_layout import _Recorder

_ROOT = Path(__file__).resolve().parents[1]
_SRC = (_ROOT / "fairmultimodal_torch" / "ops" / "csrc" / "flash_attention.cu").read_text()
_spec = importlib.util.spec_from_file_location("chip_smoke", _ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

B, NH, S = 3, 2, 80          # S: one whole 64-row tile and a ragged one of 16
TOL = 5e-5                   # of each grad's max-abs: the plain version's fp32 backward limit
PLAN = _build.FLASH_BWD_F32


def _inputs(seed, d, masked):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(0, 1, (B, NH, S, d)).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        lens = rng.integers(S // 3, S, B)
        mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
        mask[-1] = 0                  # a fully masked row: finite, uniform softmax
    return q, k, v, do, mask


def _rowterm(do, o):
    """D as ``flash_bwd_rowterm_f32_kernel`` sums it: column classes j mod 4
    apart, each in column order, then (c0 + c1) + (c2 + c3)."""
    prod = do * o
    part = [prod[..., j::4].sum(-1) for j in range(4)]
    return (part[0] + part[1]) + (part[2] + part[3])


def _tile_partials(g):
    """Column partials of a [B, heads, S, d] grad over each 64-row tile, in
    the kernels' order (rows r + 16 i of thread row r, then r = 0..15), as
    [B * tiles, heads * d] rows (head h at column h * d)."""
    b, nh, s, d = g.shape
    tile = _build.FLASH_BWD_TILE[torch.float32]
    rows = []
    for bi in range(b):
        for r0 in range(0, s, tile):
            total = torch.zeros(nh, d)
            for r in range(16):
                per = torch.zeros(nh, d)
                for i in range(4):
                    if r0 + r + 16 * i < s:
                        per = per + g[bi, :, r0 + r + 16 * i]
                total = total + per
            rows.append(total.reshape(nh * d))
    return torch.stack(rows)


def _pass_order(q, k, v, do, mask):
    """(dq, dk, dv, scratch, partials) of the three fp32 passes from fp32 q,
    k, v, dO [B, heads, S, d]: the forward's o and stats (m, l) from the
    plain forward, D, the dK / dV pass storing ds * scale into the [B, heads,
    S, SP] scratch, the dQ pass walking it ``dq_walk`` keys at a time."""
    b, nh, s, d = q.shape
    scale = torch.tensor(1.0 / d ** 0.5, dtype=torch.float32)
    tm = None if mask is None else torch.from_numpy(mask)
    o, stats = t_flash._forward_with_stats(q, k, v, tm)
    m, l = stats[..., 0:1], stats[..., 1:2]
    D = _rowterm(do, o)[..., None]
    shape, _ = _build.flash_bwd_f32_scratch(b, nh, s)
    sp = shape[-1]
    kp, vp = (torch.cat((t, t.new_zeros(b, nh, sp - s, d)), 2) for t in (k, v))
    bias = torch.full((b, sp), float("-inf"))           # keys past S weigh 0
    bias[:, :s] = 0.0 if tm is None else torch.where(tm > 0, 0.0, -1e9)
    x = (q @ kp.transpose(-1, -2)) * scale + bias[:, None, None, :]
    p = torch.exp(x - m) / l
    dp = do @ vp.transpose(-1, -2)
    ds = p * (dp - D) * scale
    scratch = ds                                          # [B, heads, S, SP]
    dv = (p.transpose(-1, -2) @ do)[:, :, :s]
    dk = (ds.transpose(-1, -2) @ q)[:, :, :s]
    dq = torch.zeros_like(q)
    for k0 in range(0, sp, PLAN["dq_walk"]):              # the stored ds, key tiles in order
        t = slice(k0, k0 + PLAN["dq_walk"])
        dq = dq + scratch[..., t] @ kp[:, :, t]
    return dq, dk, dv, scratch, [_tile_partials(g) for g in (dq, dk, dv)]


def _within(name, got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{name}: {err} (max-abs {scale})"


@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("masked", [False, True])
def test_pass_order_matches_plain_and_pallas_vjp(masked, d):
    q, k, v, do, mask = _inputs(17 + d, d, masked)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    dq, dk, dv, scratch, parts = _pass_order(tq, tk, tv, tdo, mask)
    tm = None if mask is None else torch.from_numpy(mask)
    plain = t_flash.flash_attention_backward_reference(tq, tk, tv, tm, tdo)
    jm = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b_, c: j_flash(a, b_, c, jm, True),
                     *(jnp.asarray(a) for a in (q, k, v)))
    pallas = vjp(jnp.asarray(do))
    for name, g, pl, jx in zip(("dq", "dk", "dv"), (dq, dk, dv), plain, pallas):
        assert g.dtype == torch.float32 and g.shape == tq.shape and torch.isfinite(g).all()
        _within(f"{name} vs plain", g.numpy(), pl.numpy())
        _within(f"{name} vs Pallas", g.numpy(), jx)
    # The column partials: one row per batch row and 64-row tile, whose
    # fixed-order sums are each tile's column sums of the plain grads.
    tile = _build.FLASH_BWD_TILE[torch.float32]
    assert parts[0].shape == (_build.flash_bwd_colpart_rows(B, S, torch.float32), NH * d)
    for name, part, pl in zip(("dq", "dk", "dv"), parts, plain):
        want = torch.stack([pl[bi, :, r0:r0 + tile].sum(1).reshape(NH * d)
                            for bi in range(B) for r0 in range(0, S, tile)])
        _within(f"{name} partials", part.numpy(), want.numpy())
    # Keys past S hold ds = 0: the walk to SP adds nothing to the walk to S.
    assert scratch.shape == _build.flash_bwd_f32_scratch(B, NH, S)[0]
    assert not scratch[..., S:].any()
    _within("dq walked to S", dq.numpy(), (scratch[..., :S] @ tk).numpy())


def test_fully_masked_row_takes_the_uniform_softmax():
    q, k, v, do, mask = _inputs(5, 64, masked=True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    _, stats = t_flash._forward_with_stats(tq, tk, tv, torch.from_numpy(mask))
    # m is -1e9 exactly and l counts every key: p = 1 / S on the dead row, so
    # its ds is the uniform softmax's VJP and its dv the mean of dO.
    assert torch.equal(stats[-1, ..., 0], torch.full((NH, S), -1e9))
    assert torch.equal(stats[-1, ..., 1], torch.full((NH, S), float(S)))
    _, _, dv, scratch, _ = _pass_order(tq, tk, tv, tdo, mask)
    np.testing.assert_allclose(dv[-1].numpy(), tdo[-1].sum(1, keepdim=True).expand(NH, S, 64)
                               .numpy() / S, rtol=0, atol=1e-5)
    assert torch.isfinite(scratch).all()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))


def _smem(struct, dp):
    """``struct``<DP>'s fields, evaluated from the source."""
    body = re.search(rf"struct {struct} \{{.*?\n\}};", _SRC, re.S).group(0)
    env = {"DP": dp, "F32_TL": _const("F32_TL"), "F32_DQ_WALK": _const("F32_DQ_WALK")}
    for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);", body):
        expr = re.sub(r"(\w+) == (\d+) \? (\d+) : (\d+)", r"(\3 if \1 == \2 else \4)", expr)
        env[name] = eval(expr, {}, env)
    return env


def _pitch_rule():
    body = re.search(r"int f32_ds_pitch\(int S\) \{\s*return (.+?);\s*\}", _SRC).group(1)
    return lambda s: eval(body.replace("/", "//"), {"S": s, "F32_TL": _const("F32_TL")})


def test_plan_matches_the_kernel_source():
    assert PLAN["owned"] == _const("F32_TL") == _build.FLASH_BWD_TILE[torch.float32]
    assert PLAN["dq_walk"] == _const("F32_DQ_WALK")
    assert PLAN["dq_threads"] == _const("F32_DQ_THREADS") == 8 * 16
    assert PLAN["dq_blocks"] == _const("F32_DQ_BLOCKS")
    for dp, walk in PLAN["walk"].items():
        dkdv, dq = _smem("BwdF32Smem", dp), _smem("DqF32Smem", dp)
        assert dkdv["TW"] == walk and dq["TW"] == PLAN["dq_walk"]
        # The dK / dV kernel one block per SM, the dQ kernel dq_blocks (each
        # block also holds 1 KB of the SM's 228 KB for the system); the dQ
        # kernel's ring then holds its [64][DP] dq tile for the column sums.
        assert dkdv["BYTES"] <= 232448
        assert PLAN["dq_blocks"] * (dq["BYTES"] + 1024) <= 233472
        assert dq["BYTES"] >= PLAN["owned"] * dp * 4
        assert dq["LD"] == dp + 4 and dq["LP"] == PLAN["dq_walk"] + 8
    assert _smem("DqF32Smem", 96)["BYTES"] == 46080            # 45 KB at the lab's d 96


@pytest.mark.parametrize("dp", [32, 64, 96, 128])
def test_dq_thread_map_owns_each_row_and_column_once(dp):
    # Thread (g, c) of the dQ kernel's 8 x 16 grid: rows g + 8 i (i < 8),
    # columns 2c + 32 jj + {0, 1}; its ds reads are one row of the tile per
    # 16 lanes, its k reads one 128-byte row segment per half-warp.
    owned = []
    for tid in range(PLAN["dq_threads"]):
        g, c = divmod(tid, 16)
        owned += [(g + 8 * i, 2 * c + 32 * jj + e) for i in range(8) for jj in range(dp // 32)
                  for e in range(2)]
    assert sorted(owned) == [(r, col) for r in range(PLAN["owned"]) for col in range(dp)]


@pytest.mark.parametrize("b,nh,s", [(16, 8, 560), (256, 8, 560), (16, 4, 560), (4, 12, 512),
                                    (3, 2, 80), (2, 3, 40), (1, 1, 1), (2, 2, 1024)])
def test_scratch_shape_bytes_and_pitch(b, nh, s):
    shape, nbytes = _build.flash_bwd_f32_scratch(b, nh, s)
    sp = shape[-1]
    assert shape == (b, nh, s, sp) and nbytes == 4 * b * nh * s * sp
    assert sp == _pitch_rule()(s) == -(-s // PLAN["owned"]) * PLAN["owned"]
    # The dK / dV blocks cover keys [0, SP); the dQ walk reads whole tiles of it.
    assert sp >= s and sp - s < PLAN["owned"] and sp % PLAN["dq_walk"] == 0
    assert sp % min(PLAN["walk"].values()) == 0


def test_scratch_at_the_main_shapes():
    assert _build.flash_bwd_f32_scratch(16, 8, 560) == ((16, 8, 560, 576), 165150720)
    assert _build.flash_bwd_f32_scratch(256, 8, 560)[1] == 2642411520     # 2.6 GB at B 256


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_hands_the_fp32_launch_its_scratch(monkeypatch, dtype):
    rec, asked = _Recorder(), []
    monkeypatch.setattr(_build, "kernels", lambda: rec)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build, "_stream", lambda t: 0)
    real = _build.flash_bwd_f32_scratch

    def spy(*args):
        asked.append(args)
        return real(*args)
    monkeypatch.setattr(_build, "flash_bwd_f32_scratch", spy)
    b, nh, s, d = 2, 3, 72, 32
    q, k, v, o, g, dq, dk, dv = (torch.zeros(b, nh, s, d, dtype=dtype) for _ in range(8))
    stats, rowterm = torch.zeros(b, nh, s, 2), torch.zeros(b, nh, s)
    _build.flash_attention_bwd(q, k, v, o, g, None, stats, rowterm, dq, dk, dv)
    (fn, args), = rec.calls
    assert fn == "fm_flash_attention_bwd"
    ds_ptr = args[21]                 # after colpart (None here)
    assert args[20] is None
    if dtype == torch.float32:
        assert asked == [(b, nh, s)] and ds_ptr not in (None, 0)
    else:
        assert asked == [] and ds_ptr is None


@pytest.mark.parametrize("masked", [False, True])
def test_f64_yardstick_is_the_function_in_float64(masked):
    q, k, v, do, mask = _inputs(29, 64, masked)
    tq, tk, tv, tdo = (torch.from_numpy(a).double() for a in (q, k, v, do))
    tm = None if mask is None else torch.from_numpy(mask)
    got = chip_smoke.flash_bwd_f64(tq, tk, tv, tm, tdo)
    want = t_flash.flash_attention_backward_reference(tq, tk, tv, tm, tdo)
    live = slice(None) if mask is None else slice(0, B - 1)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a[live].numpy(), w[live].numpy(), rtol=0,
                                   atol=1e-12 * float(w.abs().max()), err_msg=name)
    if masked:                        # the dead row: the uniform softmax's VJP
        p = torch.full((NH, S, S), 1.0 / S, dtype=torch.float64)
        o = p @ tv[-1]
        ds = p * (tdo[-1] @ tv[-1].transpose(-1, -2) - (tdo[-1] * o).sum(-1, keepdim=True)) \
            / 64 ** 0.5
        for a, w in zip(got, (ds @ tk[-1], ds.transpose(-1, -2) @ tq[-1],
                              p.transpose(-1, -2) @ tdo[-1])):
            np.testing.assert_allclose(a[-1].numpy(), w.numpy(), rtol=0, atol=1e-12)
