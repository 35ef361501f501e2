"""The bf16 "nn" / "tn" GEMM kernel's design, on the CPU.

``gemm.cu``'s ``gemm_bf16_nn_tn_kernel`` runs every bf16 backward product
(dO, dx + residual, the relu / dgelu gated dh with its column partials, and
the split-K weight grads of Pallas #3, #4, #6 and #8): one persistent block
per SM walking (tile, K split) units, two consumer warpgroups of m64n256k16
wgmma with one batch kept in flight, a producer thread that feeds the ring by
TMA and a second that brings the unit's gate or residual by TMA in sets of
the tile's rows x 128 bytes into two buffers, whose rows the consumer warps
then use as their staging rows for the epilogue on the fragments.  These
tests hold ``_build.WGMMA_NN_TN`` and ``bf16_nn_tn_schedule`` against the
source, pin the units on the busiest SM and the "tn" split counts and
boundaries at the port's shapes on 132- and 114-SM cards, model the set
buffers' protocol (every set loaded once, the first two of a unit under its
main loop), and model the epilogue: every output element is stored once from
the accumulator that holds it, each gate or residual element reaches the
lane that holds its output once, the shared-memory accesses take the fewest
wavefronts their bytes allow, and the gated dh's column partials are added
in the order the one-block-a-tile kernel it replaced added them (row order
within a warp's 16 rows, then the 8 warps in order), so they keep its bits.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fairmultimodal_torch.ops import _build
from fairmultimodal_torch.ops import fused_attention_block as t_fab

_CSRC = Path(__file__).resolve().parents[1] / "fairmultimodal_torch" / "ops" / "csrc"
_GEMM = (_CSRC / "gemm.cu").read_text()
SMEM_PER_BLOCK = 232448        # 227 KB: what a block of an H100 may take
REGS_PER_SM = 65536
NN = _build.WGMMA_NN_TN
BM, BN = NN["tile"]
BK, CHUNK = NN["bk"], NN["chunk"]
BF = torch.bfloat16
LAB, B16, TEXT, R06 = 256 * 560, 16 * 560, 32 * 512, 8784


def _consts(prefix):
    """Every ``constexpr int <prefix>* = expr;`` of gemm.cu, evaluated in order."""
    env = {}
    for name, expr in re.findall(rf"constexpr int ({prefix}\w+) = ([^;]+);", _GEMM):
        env[name] = eval(" ".join(expr.split()).replace("/", "//"), {}, dict(env))  # noqa: S307
    return env


C = _consts("WG_")


def _body(start, end):
    i = _GEMM.index(start)
    return _GEMM[i:_GEMM.index(end, i)]


KERNEL = _body("gemm_bf16_nn_tn_kernel(const", "\n// The map of one bf16 operand")
PASS = _body("__device__ __forceinline__ void wg_pass(", "\ntemplate <typename TOut, int AT")
AUX = _body("__device__ __noinline__ void wg_aux(", "\n// Epilogue pass CH")
LAUNCH = _body("cudaError_t launch_bf16_nn_tn(", "\n}\n")


def _src(expr, text=KERNEL):
    assert expr in text, expr
    return expr


def test_build_mirrors_the_kernel_constants():
    assert NN["tile"] == (C["WG_BM"], C["WG_BN"]) == _build.WGMMA_TILE == (128, 256)
    assert (NN["bk"], NN["stages"], NN["consumers"], NN["threads"]) == (
        C["WG_BK"], C["WG_STAGES"], C["WG_CONSUMERS"], C["WG_THREADS"])
    assert (NN["chunk"], NN["set"], NN["bufs"], NN["smem"]) == (
        C["WG_CHUNK"], C["WG_SET"], C["WG_BUFS"], C["WG_SMEM"])
    # The split-K model is sized from this kernel's tile, one block an SM and
    # its K slice, as it was for the kernel it replaced.
    assert _build.GEMM_SCHEDULE[BF] == (_build.WGMMA_TILE, 1, C["WG_BK"], 2048)
    # One 128-byte swizzle line of bf16 per K row of a slice; MN-major boxes
    # of [64 K][64 MN] (B always, A for "tn"), a K-major A in [128][64 K].
    assert BK * 2 == 128 and C["WG_BOX"] == 64 * BK * 2
    _src("return mn_major ? tma_map(map, p, false, K, mn, WG_BK, 64)", _GEMM)
    _src(": tma_map(map, p, false, mn, K, box_mn, WG_BK);", _GEMM)
    _src("!operand_map(&ta, A, M, K, AT, WG_BM) || !operand_map(&tb, B, N, K, true, WG_BN)", LAUNCH)
    # A set: the tile's rows x one 128-byte swizzle line, 64 bf16 gate or 32
    # fp32 residual columns.
    _src("MODE == EPI_GATE && !tma_map(&te, e.gate, false, M, N, WG_BM, 64)", LAUNCH)
    _src("MODE == EPI_RESID && !tma_map(&te, e.resid, true, M, N, WG_BM, 32)", LAUNCH)
    assert NN["set"] == BM * 128 == BM * 64 * 2 == BM * 32 * 4


def test_shared_memory_fits_the_residency():
    ring = NN["stages"] * (BM + BN) * BK * 2
    sets = NN["bufs"] * NN["set"]                        # each also 8 warps' staging rows
    bars = (2 * NN["stages"] + 2 * NN["bufs"]) * 8       # full, empty; sfull, sempty
    assert (ring, sets, bars) == (196608, 32768, 96)
    assert NN["smem"] == ring + sets + bars + 1024 == 230496
    assert NN["smem"] * NN["blocks_per_sm"] <= SMEM_PER_BLOCK
    assert C["WG_SLICE"] * 4 * NN["consumers"] == NN["set"]  # a warp's 16 rows of a set
    # A tile's gate (64 KB) or residual (128 KB) does not fit beside the ring,
    # nor a third set buffer: hence sets, two in flight.
    assert ring + BM * BN * 2 > SMEM_PER_BLOCK and ring + BM * BN * 4 > SMEM_PER_BLOCK
    assert ring + 3 * NN["set"] + bars + 1024 > SMEM_PER_BLOCK
    assert ((BM + BN) * BK * 2) % 1024 == 0 and NN["set"] % 1024 == 0  # swizzle atoms aligned
    assert re.search(r"__launch_bounds__\(WG_THREADS, 1\)\s*gemm_bf16_nn_tn_kernel", _GEMM)
    assert NN["threads"] == (NN["consumers"] + 1) * 128
    _src("kernel<<<grid, WG_THREADS, WG_SMEM, s>>>", LAUNCH)
    _src("const int grid = units < sms ? (int)units : sms;", LAUNCH)


def test_registers_fit_each_quarter_of_the_file():
    # Warp k of every warpgroup sits on quarter k of the register file (16384
    # registers): 384 threads start at 168 a thread, then setmaxnreg moves
    # registers from the producer warpgroup to the two consumers.
    start = (REGS_PER_SM // NN["threads"]) // 8 * 8
    assert start == 168
    dec = int(re.search(r"setmaxnreg_dec<(\d+)>\(\);", KERNEL).group(1))
    inc = int(re.search(r"setmaxnreg_inc<(\d+)>\(\);", KERNEL).group(1))
    assert (dec, inc) == (40, 232)
    assert dec < start < inc and dec % 8 == 0 and inc % 8 == 0
    assert (NN["consumers"] * inc + dec) * 32 <= REGS_PER_SM // 4
    # A consumer thread holds 128 fp32 accumulators (64 x 256 over 128
    # threads); the gate and residual wait in shared memory, not in registers,
    # and the column sums take two a pass.
    assert 64 * BN // 128 == 128
    assert "float acc[128];" in KERNEL and "float cs[2];" in PASS
    assert "uint4" not in PASS and "__ldg" not in KERNEL


# ---- the persistent schedule and the "tn" splits --------------------------------------

def _shapes(r, h, f, attention=True):
    """(name, layout, M, N, K) of the backward products at R rows, width h, FFN f."""
    out = [("dh", "nn", r, f, h), ("dx ffn", "nn", r, h, f),
           ("dW1", "tn", f, h, r), ("dW2", "tn", h, f, r)]
    if attention:
        out = [("dO", "nn", r, h, h), ("dx attn", "nn", r, h, 3 * h),
               ("dWo", "tn", h, h, r), ("dWqkv", "tn", 3 * h, h, r)] + out
    return out


# shape: {SMs: {product: (splits, units, units on the busiest SM, rows per split)}}
SCHEDULES = {
    "lab": (_shapes(LAB, 768, 2048), {
        132: {"dO": (1, 3360, 26), "dx attn": (1, 3360, 26), "dh": (1, 8960, 68),
              "dx ffn": (1, 3360, 26), "dWo": (7, 126, 1, 20480), "dWqkv": (7, 378, 3, 20480),
              "dW1": (8, 384, 3, 17920), "dW2": (8, 384, 3, 17920)},
        114: {"dO": (1, 3360, 30), "dx attn": (1, 3360, 30), "dh": (1, 8960, 79),
              "dx ffn": (1, 3360, 30), "dWo": (19, 342, 3, 7552), "dWqkv": (2, 108, 1, 71680),
              "dW1": (7, 336, 3, 20480), "dW2": (7, 336, 3, 20480)}}),
    "B16": (_shapes(B16, 768, 2048), {
        sms: {"dO": (1, 210, 2), "dx attn": (1, 210, 2), "dh": (1, 560, 5),
              "dx ffn": (1, 210, 2), "dWo": (4, 72, 1, 2240), "dWqkv": (2, 108, 1, 4480),
              "dW1": (2, 96, 1, 4480), "dW2": (2, 96, 1, 4480)} for sms in (132, 114)}),
    "text": (_shapes(TEXT, 768, 3072), {
        132: {"dO": (1, 384, 3), "dx attn": (1, 384, 3), "dh": (1, 1536, 12),
              "dx ffn": (1, 384, 3), "dWo": (7, 126, 1, 2368), "dWqkv": (7, 378, 3, 2368),
              "dW1": (5, 360, 3, 3328), "dW2": (5, 360, 3, 3328)},
        114: {"dO": (1, 384, 4), "dx attn": (1, 384, 4), "dh": (1, 1536, 14),
              "dx ffn": (1, 384, 4), "dWo": (6, 108, 1, 2752), "dWqkv": (2, 108, 1, 8192),
              "dW1": (3, 216, 2, 5504), "dW2": (3, 216, 2, 5504)}}),
    "06": (_shapes(R06, 256, 512, attention=False), {
        sms: {"dh": (1, 138, 2), "dx ffn": (1, 69, 1), "dW1": (4, 16, 1, 2240),
              "dW2": (4, 16, 1, 2240)} for sms in (132, 114)}),
}
CASES = [(shape, sms, name, layout, m, n, k, want[sms][name])
         for shape, (products, want) in SCHEDULES.items() for sms in (132, 114)
         for name, layout, m, n, k in products]


def _block_units(m, n, splits, sms, block):
    """The (row, column, split) of the units block ``block`` runs, in order:
    u = block + grid * i, split u // tiles, tile u % tiles numbered N-fastest."""
    tiles_n = -(-n // BN)
    tiles = -(-m // BM) * tiles_n
    grid, units = _build.bf16_nn_tn_schedule(m, n, splits, sms)[:2]
    return [(u % tiles // tiles_n * BM, u % tiles % tiles_n * BN, u // tiles)
            for u in range(block, units, grid)]


@pytest.mark.parametrize("shape,sms,name,layout,m,n,k,want", CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in CASES])
def test_persistent_schedule(shape, sms, name, layout, m, n, k, want):
    splits = t_fab._splits(m, n, k, sms) if layout == "tn" else 1
    grid, units, busiest = _build.bf16_nn_tn_schedule(m, n, splits, sms)
    assert (splits, units, busiest) == want[:3]
    assert grid == min(sms, units)
    # The blocks' unit lists cover every (tile, split) once; each block (one
    # per SM) runs floor or ceil(units / grid), both consumers on each.
    seen = []
    for b in range(grid):
        mine = _block_units(m, n, splits, sms, b)
        assert len(mine) in (units // grid, -(-units // grid))
        seen += mine
    assert len(seen) == units == len(set(seen))
    assert set(seen) == {(mt * BM, nt * BN, s) for mt in range(-(-m // BM))
                         for nt in range(-(-n // BN)) for s in range(splits)}
    assert max(len(_block_units(m, n, splits, sms, b)) for b in range(grid)) == busiest
    if layout == "tn":
        assert _build.split_rows(k, splits, BF) == want[3]


def _split_rows_model(k, splits):
    """The kernel's Kc and each split's [kb, kend) and slice count (wg_unit)."""
    kc = ((k + splits - 1) // splits + BK - 1) // BK * BK
    out = []
    for s in range(splits):
        kb, kend = s * kc, min(s * kc + kc, k)
        out.append((kb, kend, -(-(kend - kb) // BK) if kend > kb else 0))
    return kc, out


@pytest.mark.parametrize("case", [c for c in CASES if c[3] == "tn"],
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in CASES if c[3] == "tn"])
def test_split_boundaries_are_the_parents(case):
    # The parent sized a split as ceil(K / splits) rounded up to the 64-row K
    # slice (its gridDim.z blocks); the units keep those rows, so each weight
    # grad sums the same rows in the same 16-deep steps and keeps its bits.
    shape, sms, name, layout, m, n, k, want = case
    splits = t_fab._splits(m, n, k, sms)
    kc, rows = _split_rows_model(k, splits)
    assert kc == _build.split_rows(k, splits, BF) and kc % BK == 0
    covered = [r for kb, kend, _ in rows for r in range(kb, kend)]
    assert covered == list(range(k))                   # every row once, in order
    assert all(kb % BK == 0 for kb, _, _ in rows)      # slices never cross a boundary
    assert all(nk * BK >= kend - kb for kb, kend, nk in rows)
    _src("const int Kc = ((K + splits - 1) / splits + WG_BK - 1) / WG_BK * WG_BK;", LAUNCH)
    _src("r.kb = r.split * Kc;", _GEMM)
    _src("r.kend = min(r.kb + Kc, K);", _GEMM)
    _src("r.nk = r.kend > r.kb ? (r.kend - r.kb + WG_BK - 1) / WG_BK : 0;", _GEMM)


def test_schedule_matches_the_kernel_source():
    # The two producer threads and the consumers walk one order of units.
    assert KERNEL.count("for (int u = blockIdx.x; u < units; u += gridDim.x") == 3
    assert KERNEL.count("const WgUnit t = wg_unit(u, tiles, tiles_n, K, Kc);") == 3
    _src("const int units = tiles * splits;")
    _src("r.split = u / tiles;", _GEMM)
    _src("r.m0 = t / tiles_n * WG_BM;", _GEMM)
    _src("r.n0 = t % tiles_n * WG_BN;", _GEMM)
    _src("C + (size_t)t.split * M * N;")
    # The one-block-a-tile form is gone: no launch takes a grid of tiles.
    assert "gemm_wgmma_kernel" not in _GEMM and "gridDim.z" not in _GEMM
    assert "launch_bf16_nn_tn<float, AT, MODE>" in _GEMM
    assert "launch_bf16_nn_tn<fm_bf16, AT, MODE>" in _GEMM


def test_one_wgmma_batch_stays_in_flight():
    main = _body("for (int kt = 0; kt < t.nk; ++kt, ++qs) {", "wg_pass<0, MODE, GK>")
    _src("wgmma.wait_group.sync.aligned 1;", main)
    assert main.index("wait_group.sync.aligned 1") < main.index(
        "if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(qs - 1) % WG_STAGES]);")
    # The last slice's stage is released after the final wait.
    assert main.index("wgmma_wait_all();") < main.index(
        "if (t.nk > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(qs - 1) % WG_STAGES]);")
    _src("wgmma_m64n256k16<AT, 1>(acc, wg_desc<AT>(a, kk), wg_desc<1>(b, kk));", main)


def _set_protocol(units, sets, gate):
    """The set buffers' events as the two sides take them: the producer loads
    set gs into buffer gs % 2 once the consumers released that buffer's
    previous set (gs - 2); the consumers take sets in order, releasing each
    when its pass is done (a residual pass takes two and releases the first
    as soon as it is read).  Returns, per unit, the consumer event after
    which each of its sets may load: ("main", j) for unit j's main loop or
    earlier, ("pass", j, ch) for pass ch of unit j's epilogue."""
    released = {}   # set gs -> the consumer event that releases it
    for j in range(units):
        for ch in range(4):
            if gate:
                released[j * sets + ch] = ("pass", j, ch)
            else:
                released[j * sets + 2 * ch] = ("pass", j, ch)
                released[j * sets + 2 * ch + 1] = ("pass", j, ch)
    may_load = {}
    for gs in range(units * sets):
        j = gs // sets
        prev = gs - 2              # the set that last held buffer gs % 2
        if prev < 0 or released[prev][1] < j:
            may_load[gs] = ("main", j)   # released by an earlier unit: under this main loop
        else:
            may_load[gs] = released[prev]
    return may_load


@pytest.mark.parametrize("gate", [True, False], ids=["gate", "residual"])
def test_gate_and_residual_are_fetched_under_the_main_loop(gate):
    sets = 4 if gate else 8
    assert sets == (BN // 64 if gate else BN // 32)
    may_load = _set_protocol(5, sets, gate)
    for j in range(5):
        # The unit's first two sets load under its main loop (from the previous
        # unit's last passes on); each later set is two ahead of its pass.
        assert may_load[j * sets] == ("main", j) and may_load[j * sets + 1] == ("main", j)
        for x in range(2, sets):
            kind, jj, ch = may_load[j * sets + x]
            assert (kind, jj) == ("pass", j)
            assert ch == ((x - 2) if gate else (x - 2) // 2)
    # The source: a second producer thread walks the units' sets in order,
    # waiting on each buffer's release; the consumers wait on its arrival and
    # release it once per set.
    producer = KERNEL[KERNEL.index("int gs = 0;  // sets issued"):KERNEL.index("    return;\n")]
    _src("for (int x = 0; x < wg_sets<MODE>(); ++x, ++gs) {", producer)
    _src("mbar_wait(&sempty[b], ((gs / WG_BUFS) & 1) ^ 1);", producer)
    _src("mbar_expect_tx(&sfull[b], WG_SET);", producer)
    _src("tma_load(bufs + b * WG_SET, &tmE, t.n0 + x * (WG_BN / wg_sets<MODE>()), t.m0,", producer)
    assert PASS.count("mbar_wait(&sfull[b], (gs / WG_BUFS) & 1);") == 2
    _src("if (lane == 0) mbar_arrive(&sempty[b]);", PASS)
    _src("if (lane == 0) mbar_arrive(&sempty[gs % WG_BUFS]);", PASS)
    _src("mbar_init(&sempty[b], 4 * WG_CONSUMERS);")
    # No load of the gate or residual from the consumers.
    assert "e.gate)" not in PASS and "e.resid" not in PASS


# ---- the epilogue's thread map ------------------------------------------------------

def _stage_off(r, k):
    """gemm.cu's wn_stage_off: byte offset of 16-byte word k of staging row r."""
    return r * 128 + ((k ^ (2 * (r & 3) + ((r >> 2) & 1))) << 4)


def _fragment(warp, lane, idx):
    """(row, column) in the 128 x 256 tile of accumulator ``idx`` of consumer
    thread (warp, lane): wgmma m64nNk16's fp32 D layout."""
    i, e = divmod(idx, 4)
    row = (warp // 4) * 64 + (warp % 4) * 16 + lane // 4 + 8 * (e >> 1)
    return row, 8 * i + 2 * (lane % 4) + (e & 1)


def _set_off(r, k):
    """gemm.cu's wg_set_off: byte offset of 16-byte word k of row r of a set
    as TMA's 128-byte swizzle lays it (word k ^ (r & 7))."""
    return r * 128 + ((k ^ (r & 7)) << 4)


def test_thread_map_is_the_source():
    _src("const int i = CH * (WG_CHUNK / 8) + g, c = 8 * (g - p * PER) + 2 * q;", PASS)
    _src("wn_stage(st, rq, c, acc[4 * i], acc[4 * i + 1], (TOut*)nullptr);", PASS)
    _src("wn_stage(st, rq + 8, c, acc[4 * i + 2], acc[4 * i + 3], (TOut*)nullptr);", PASS)
    _src("wn_flush(st, out, t.m0 + lr, col0 + p * PER * 8, M, N, lane);", PASS)
    _src("const int col0 = t.n0 + CH * WG_CHUNK;", PASS)
    _src("const int lane = tid % 32, warp = tid / 32;  // consumer warp 0 .. 7", PASS)
    _src("const int lr = warp * 16;                    // its first row in the tile", PASS)
    _src("const int rq = lane / 4, q = lane % 4;", PASS)
    # (lr = 64 (warp / 4) + 16 (warp % 4): the warpgroup's 64 rows, the warp's 16.)
    assert all(64 * (w // 4) + 16 * (w % 4) == 16 * w for w in range(8))
    # The four passes, each a template instance so every acc index is a constant.
    for ch in range(BN // CHUNK):
        _src(f"wg_pass<{ch}, MODE, GK>(acc, e, t, out, bufs, sfull, sempty, gs, M, N);")
    # The staging rows: the warp's own 16 rows of a set buffer (buffer 0
    # where no set comes), written only once the warp has read its set there.
    _src("return r * 128 + ((k ^ (r & 7)) << 4);", _GEMM)
    assert PASS.count("st = bufs + b * WG_SET + warp * WG_SLICE;") == 2
    _src("st = bufs + warp * WG_SLICE;  // no sets: buffer 0's rows stage C", PASS)
    # The fragment pairs of a set: bf16 at word g, byte 4 q; fp32 at word c / 4.
    _src("const int a0 = wg_set_off(lr + rq, 0) + q * 4;", PASS)
    _src("set + (a0 + 1024 * h ^ 16 * g));", PASS)
    # (a0 + 1024 h) ^ 16 g is wg_set_off(lr + rq + 8 h, g) + 4 q: rows 8 apart share a swizzle.
    for r in range(0, 128, 16):
        for rq in range(8):
            for q in range(4):
                a0 = _set_off(r + rq, 0) + 4 * q
                for h in range(2):
                    for g in range(8):
                        assert (a0 + 1024 * h ^ 16 * g) == _set_off(r + rq + 8 * h, g) + 4 * q
    _src("set + wg_set_off(lr + rq + 8 * h, c / 4) + (c % 4) * 4);", PASS)


@pytest.mark.parametrize("size", [2, 4], ids=["bf16 out", "fp32 partials"])
def test_every_output_is_stored_once_from_its_accumulator(size):
    per = 128 // size // 8          # fragment groups a staged 128-byte row holds
    elems = 16 // size              # elements of a lane's 16-byte store
    stored = {}
    for warp in range(8):
        lr = (warp // 4) * 64 + (warp % 4) * 16
        for ch in range(BN // CHUNK):
            for p in range(CHUNK // 8 // per):
                buf = {}
                for lane in range(32):
                    rq, q = divmod(lane, 4)
                    for g in range(p * per, (p + 1) * per):
                        i, c = ch * (CHUNK // 8) + g, 8 * (g - p * per) + 2 * q
                        for r, x0 in ((rq, 0), (rq + 8, 2)):
                            for x in (0, 1):
                                at = _stage_off(r, (c + x) // elems) + (c + x) % elems * size
                                assert at not in buf
                                buf[at] = (warp, lane, 4 * i + x0 + x)
                assert sorted(buf) == list(range(0, 16 * 128, size))
                for lane in range(32):                    # wn_flush's 16-byte stores
                    k = lane % 8
                    for j in range(4):
                        r = lane // 8 + 4 * j
                        for x in range(elems):
                            row, col = lr + r, ch * CHUNK + p * per * 8 + k * elems + x
                            assert (row, col) not in stored
                            w, ln, acc = buf[_stage_off(r, k) + x * size]
                            assert _fragment(w, ln, acc) == (row, col)
                            stored[(row, col)] = True
    assert set(stored) == {(r, c) for r in range(BM) for c in range(BN)}


@pytest.mark.parametrize("size", [2, 4], ids=["bf16 gate", "fp32 residual"])
def test_each_gate_or_residual_element_reaches_its_accumulator_once(size):
    # Set s: the tile's 128 rows x the 128 bytes from column (128 / size) s,
    # as TMA lays it (row r, word k at k ^ (r & 7)); consumer warp w reads
    # its rows lr + rq (+ 8): bf16 pairs at word g, byte 4 q (the set is pass
    # s), fp32 pairs at word c / 4, c = 8 (g - 4 hf) + 2 q (half hf of pass s // 2).
    cols = 128 // size
    per = 16 // size
    got = {}
    for s_ in range(BN // cols):
        landed = {}
        for r in range(BM):
            for k in range(8):
                for x in range(per):
                    landed[_set_off(r, k) + x * size] = (r, s_ * cols + k * per + x)
        assert sorted(landed) == list(range(0, BM * 128, size))
        ch, hf = (s_, None) if size == 2 else divmod(s_, 2)
        groups = range(8) if size == 2 else range(4 * hf, 4 * hf + 4)
        for warp in range(8):
            lr = (warp // 4) * 64 + (warp % 4) * 16
            for lane in range(32):
                rq, q = divmod(lane, 4)
                for g in groups:
                    i = ch * (CHUNK // 8) + g
                    for h in range(2):
                        if size == 2:
                            at = _set_off(lr + rq + 8 * h, g) + q * 4
                        else:
                            c = 8 * (g - 4 * hf) + 2 * q
                            at = _set_off(lr + rq + 8 * h, c // 4) + (c % 4) * 4
                        for x in (0, 1):
                            elem = landed[at + x * size]
                            assert elem == _fragment(warp, lane, 4 * i + 2 * h + x)
                            assert elem not in got
                            got[elem] = True
    assert set(got) == {(r, c) for r in range(BM) for c in range(BN)}


def test_the_aux_is_each_gate_element_once():
    # The dgelu gate's aux: lane l reads word l % 8 of rows l / 8 + 4 j of the
    # warp's 16 and stores its 8 elements as one 16-byte word.
    _src("const uint4 v = *reinterpret_cast<const uint4*>(set + wg_set_off(r0 + r, lane % 8));",
         AUX)
    _src("const int r = lane / 8 + 4 * j, row = row0 + r;", AUX)
    _src("const int col = col0 + (lane % 8) * 8;", AUX)
    _src("store_group<8>(aux + (size_t)row * N + col, g);", AUX)
    _src("wg_aux(set, static_cast<fm_bf16*>(e.aux), t.m0 + lr, lr, col0, M, N, lane);", PASS)
    seen = set()
    for warp in range(8):
        lr = (warp // 4) * 64 + (warp % 4) * 16
        for lane in range(32):
            for j in range(4):
                r = lr + lane // 8 + 4 * j
                for x in range(8):
                    elem = (r, (lane % 8) * 8 + x)
                    assert elem not in seen
                    seen.add(elem)
    assert seen == {(r, c) for r in range(BM) for c in range(64)}
    # A warp's read for one j: 4 rows x 128 bytes, four wavefronts; its stores
    # whole 128-byte lines.
    for warp in range(8):
        lr = (warp // 4) * 64 + (warp % 4) * 16
        for j in range(4):
            addrs = [_set_off(lr + lane // 8 + 4 * j, lane % 8) for lane in range(32)]
            assert _wavefronts(addrs, 16) == 4


def _wavefronts(addrs, width):
    """Shared-memory wavefronts of one warp access of ``width`` bytes a lane."""
    per_bank = {}
    for a in set(addrs):
        for b in range(a // 4, a // 4 + width // 4):
            per_bank.setdefault(b % 32, set()).add(a)
    return max(len(v) for v in per_bank.values())


def test_staging_accesses_take_the_fewest_wavefronts():
    for warp in range(8):
        lr = (warp // 4) * 64 + (warp % 4) * 16
        for h in range(2):
            for g in range(8):   # the gate's bf16 pairs (128 bytes): one
                addrs = [_set_off(lr + lane // 4 + 8 * h, g) + 4 * (lane % 4) for lane in range(32)]
                assert len(set(addrs)) == 32 and _wavefronts(addrs, 4) == 1
            for g in range(4):   # the residual's fp32 pairs (256 bytes): two
                cs = [8 * g + 2 * (lane % 4) for lane in range(32)]
                addrs = [_set_off(lr + lane // 4 + 8 * h, c // 4) + c % 4 * 4
                         for lane, c in zip(range(32), cs)]
                assert len(set(addrs)) == 32 and _wavefronts(addrs, 8) == 2
    for r in range(16):       # the column sums' reads: a row's 128 bytes, one
        addrs = [_stage_off(r, lane // 4) + (lane % 4) * 4 for lane in range(32)]
        assert len(set(addrs)) == 32 and _wavefronts(addrs, 4) == 1
    # Without the swizzle a warp's bf16 pairs (8 rows, one word each) share 4 banks.
    plain = [(lane // 4) * 128 + 4 * (lane % 4) for lane in range(32)]
    assert _wavefronts(plain, 4) == 8


# ---- the gated dh's column partials -------------------------------------------------

def _parent_order(m0, m):
    """Per tile column, the rows the one-block-a-tile kernel added, in order:
    warp w (rows 16 w ..) summed its rows from 0 in row order, skipping rows
    past M, and the 8 warp sums were then added in warp order.  As nested
    lists: [warp][row]."""
    return [[r for r in range(16 * w, 16 * w + 16) if m0 + r < m] for w in range(8)]


def _kernel_order(m0, m, col):
    """The same for this kernel, from its thread map: in pass col // 64, half
    (col % 64) // 32, lane col % 32 of each warp adds all 16 staged rows of
    its column in order into cs[half] (a row past M holds +0: TMA zero-fills
    A's and the gate's rows there); the warps write cs into their rows of the
    set buffer and, between two barriers, thread col % 64 adds the 8 warps'
    sums in warp order."""
    order = []
    for warp in range(8):
        lr = (warp // 4) * 64 + (warp % 4) * 16
        ch, rest = divmod(col, CHUNK)
        hf, lane = divmod(rest, 32)
        assert ch * CHUNK + 32 * hf + lane == col
        order.append([lr + r for r in range(16)])
    return order


@pytest.mark.parametrize("m0,m", [(0, 4096), (8704, 8784), (143232, 143360)],
                         ids=["whole tile", "ragged B16 tile", "last lab tile"])
def test_column_partials_keep_the_parents_order(m0, m):
    # The kernel adds the parent's rows in the parent's order, and beyond them
    # only rows past M.
    for col in range(BN):
        for mine, theirs in zip(_kernel_order(m0, m, col), _parent_order(m0, m)):
            assert [r for r in mine if m0 + r < m] == theirs
            assert all(m0 + r >= m for r in mine[len(theirs):])
    # The same sums in float32 on values whose order matters, signed zeros
    # among them, and +0 past M (what the kernel's staged rows hold there): a
    # sum from +0 never becomes -0, so adding +0 leaves its bits.
    rng = np.random.default_rng(7)
    v = (rng.standard_normal((BM, BN)) * 10.0 ** rng.integers(-4, 5, (BM, BN))).astype(np.float32)
    v[rng.random((BM, BN)) < 0.05] = np.float32(-0.0)
    v[max(0, m - m0):] = np.float32(0.0)

    def add(rows_by_warp, col):
        total = np.float32(0.0)
        for rows in rows_by_warp:
            part = np.float32(0.0)
            for r in rows:
                part = np.float32(part + v[r, col])
            total = np.float32(total + part)
        return total

    for col in range(BN):
        assert add(_kernel_order(m0, m, col), col).tobytes() == \
            add(_parent_order(m0, m), col).tobytes()
    # The source: lane l down the 16 staged rows from 0; thread c over the
    # warps in order, between two named barriers of the 256 consumer threads.
    _src("float s = 0.0f;\n#pragma unroll\n      for (int r = 0; r < 16; ++r) {", PASS)
    _src("s += *reinterpret_cast<const float*>(st + wn_stage_off(r, lane / 4) + (lane % 4) * 4);",
         PASS)
    _src("cs[hf] = s;", PASS)
    _src("reinterpret_cast<float*>(st)[lane] = cs[0];", PASS)
    _src("reinterpret_cast<float*>(st)[32 + lane] = cs[1];", PASS)
    _src("if (c < WG_CHUNK && col0 + c < N) {", PASS)
    _src("s += reinterpret_cast<const float*>(buf + w * WG_SLICE)[c];", PASS)
    _src("e.colpart[(size_t)(t.m0 / WG_BM) * N + col0 + c] = s;", PASS)
    barrier = 'asm volatile("bar.sync 1, %0;\\n" ::"n"(WG_CONSUMERS * 128) : "memory");'
    assert PASS.count(barrier) == 2
    assert "bar.sync" not in KERNEL


def test_gate_arithmetic_is_the_parents():
    # v * gate' in fp32 (relu: 1[hd > 0] * scale; dgelu(hd)), v + resid, then
    # the store's rounding; aux = round(gelu(hd)) from the bits of hd.
    _src("acc[4 * i + 2 * h] *= t0 > 0.0f ? e.gate_scale : 0.0f;", PASS)
    _src("acc[4 * i + 2 * h] *= dgelu(t0);", PASS)
    _src("acc[4 * i + 2 * h] += r.x;", PASS)
    _src("g[k] = gelu(__uint_as_float(k % 2 ? w[k / 2] & 0xffff0000u : w[k / 2] << 16));", AUX)
    # The gate's kind is a kernel of its own.
    _src("kernel = e.gate_kind == GATE_RELU ? gemm_bf16_nn_tn_kernel<TOut, AT, MODE, GATE_RELU>",
         LAUNCH)
    # bf16 k of a little-endian word pair: its bits are the fp32's top half.
    h = torch.tensor([1.5, -2.25, 3.0e-3, 7.0], dtype=BF)
    words = h.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
    w = words[0::2] | words[1::2] << 16
    for k in range(4):
        bits = (w[k // 2] & 0xFFFF0000) if k % 2 else (w[k // 2] << 16) & 0xFFFFFFFF
        assert np.uint32(bits).view(np.float32) == h[k].float().item()
