"""The fp32 "nn" / "tn" GEMM kernel's design, on the CPU.

``gemm.cu``'s ``gemm_f32_nn_tn_kernel`` runs every fp32 backward product
(the "nn" dO / dx / dh and the "tn" weight grads of Pallas #3, #4, #6 and #8):
one persistent block per SM, two consumers of a warpgroup each with its own
producer warp, a TMA ring of 32-deep K slices with the 128-byte swizzle (a
K-major A in [128 rows][32 K] boxes, an MN-major operand in [32 K][32 MN]
boxes), read in place; units of one 128 x 64 tile over one K split.  These
tests hold ``_build.SGEMM_NN_TN`` and the schedule helpers against the source,
pin the units on the busiest SM and consumer at the backward shapes on 132- and
114-SM cards and the "tn" split boundaries (the cp.async kernel's counts and
16-row boundaries, kept so a weight grad is the same bits), model the
consumer's thread map under the TMA swizzle for both majornesses (every read
lands on the element the math needs, each warp read of the ring is one
shared-memory wavefront, the epilogue stores whole 128-byte lines from the
registers), and the gated "nn"'s column sums in the cp.async kernel's order.
"""

import re
from pathlib import Path

import pytest
import torch

from fairmultimodal_torch.ops import _build
from fairmultimodal_torch.ops import fused_attention_block as t_fab

_GEMM = (Path(__file__).resolve().parents[1] / "fairmultimodal_torch" / "ops" / "csrc"
         / "gemm.cu").read_text()
SMEM_PER_BLOCK = 232448        # 227 KB: what a block of an H100 may take
REGS_PER_SM = 65536
F32 = torch.float32


def _mn_consts():
    """Every ``constexpr int MN_* = expr;`` of gemm.cu, evaluated in order."""
    env = {}
    for name, expr in re.findall(r"constexpr int (MN_\w+) = ([^;]+);", _GEMM):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))   # noqa: S307
    return env


C = _mn_consts()
BM, BN = _build.SGEMM_NN_TN["tile"]
BK = _build.SGEMM_NN_TN["bk"]
BOX = C["MN_BOX"]
A_BYTES = C["MN_A_BYTES"]


def _body():
    """The source of gemm_f32_nn_tn_kernel."""
    start = _GEMM.index("gemm_f32_nn_tn_kernel(const __grid_constant__")
    return _GEMM[start:_GEMM.index("\ntemplate <int AT, int MODE>\ncudaError_t launch_f32_nn_tn(",
                                   start)]


def _src(expr):
    assert expr in _GEMM, expr
    return expr


def test_build_mirrors_the_kernel_constants():
    k = _build.SGEMM_NN_TN
    assert k["tile"] == (C["MN_BM"], C["MN_BN"]) == _build.SGEMM_TILE
    assert (k["bk"], k["stages"], k["consumers"], k["threads"]) == (
        C["MN_BK"], C["MN_STAGES"], C["MN_CONSUMERS"], C["MN_THREADS"])
    assert k["smem"] == C["MN_SMEM"] and k["csum"] == C["MN_CSUM"]
    assert k["box"][0] * k["box"][1] * 4 == BOX
    # One 128-byte swizzle line of fp32: a K slice's depth and an MN box's width.
    assert BK * 4 == 128 and k["box"] == (BK, BK)
    # Splits keep the cp.async kernel's 16-row boundaries, inside 32-deep slices.
    assert _build.GEMM_SCHEDULE[F32][2] == C["MN_KSTEP"] == BK // 2
    for layout in ("nn", "tn"):
        assert _build.sgemm_tile(layout, 8960, 768, 1, 132) == k["tile"]
    _src("tma_map(&ta, A, true, K, M, MN_BK, MN_BK)")      # "tn" A [K, M]: [32 K][32 M]
    _src("tma_map(&ta, A, true, M, K, MN_BM, MN_BK)")      # "nn" A [M, K]: [128][32 K]
    _src("!tma_map(&tb, B, true, K, N, MN_BK, MN_BK)")     # B [K, N]: [32 K][32 N]
    _src("else return launch_f32_nn_tn<AT, MODE>(A, B, C, M, N, K, splits, e, s);")


def test_shared_memory_and_registers_fit_the_residency():
    k = _build.SGEMM_NN_TN
    ring = k["stages"] * (BM + BN) * BK * 4
    bars = 2 * k["stages"] * 8
    assert k["smem"] == k["consumers"] * (ring + k["csum"] + bars) + 1024
    assert k["smem"] * k["blocks_per_sm"] <= SMEM_PER_BLOCK
    # The column sums: 16 thread rows x 64 columns of fp32 a consumer.
    assert k["csum"] == 16 * BN * 4
    # Swizzle atoms (1024 bytes) stay aligned from box to box and stage to stage.
    assert BOX % 1024 == 0 and A_BYTES % 1024 == 0 and ring % 1024 == 0
    assert re.search(r"__launch_bounds__\(MN_THREADS, 1\)\s*gemm_f32_nn_tn_kernel", _GEMM)
    assert k["threads"] == (k["consumers"] + 1) * 128
    _src("gemm_f32_nn_tn_kernel<AT, MODE><<<grid, MN_THREADS, MN_SMEM, s>>>(")
    _src("const int grid = units < sms ? (int)units : sms;")


def test_registers_fit_each_quarter_of_the_file():
    # As the "nt" kernel: 384 threads start at 168 registers, then setmaxnreg
    # moves registers from the producers' warpgroup to the consumers'.
    threads, consumers = _build.SGEMM_NN_TN["threads"], _build.SGEMM_NN_TN["consumers"]
    start = (REGS_PER_SM // threads) // 8 * 8
    body = _body()
    dec = int(re.search(r"setmaxnreg\.dec\.sync\.aligned\.u32 (\d+);", body).group(1))
    inc = int(re.search(r"setmaxnreg\.inc\.sync\.aligned\.u32 (\d+);", body).group(1))
    assert dec < start < inc and dec % 8 == 0 and inc % 8 == 0
    assert (consumers * inc + dec) * 32 <= REGS_PER_SM // 4
    # The consumers' need: 64 accumulators and a chunk of operands (16
    # float4) with room for the next one in flight (the chunk loop is
    # unrolled by 2), or in the epilogue the 16 preloaded gate / residual
    # groups, plus addresses.
    assert 64 + 2 * 64 < inc
    assert "#pragma unroll 2\n      for (int ch = 0; ch < nch; ++ch) {" in body


def _units(m, n, splits, sms, block, consumer):
    """(split, row, column) of the units consumer ``consumer`` of block
    ``block`` runs, in order, as the kernel's loop walks them: unit u =
    split * tiles + t, tiles numbered N-fastest, u = block + grid * (2 i + c)."""
    tiles_n = -(-n // BN)
    tiles = -(-m // BM) * tiles_n
    grid, units = _build.sgemm_nn_tn_schedule(m, n, splits, sms)[:2]
    step = grid * _build.SGEMM_NN_TN["consumers"]
    return [(u // tiles, u % tiles // tiles_n * BM, u % tiles % tiles_n * BN)
            for u in range(block + grid * consumer, units, step)]


R16, LAB, TEXT = 16 * 560, 256 * 560, 8 * 512
# shape, layout, M, N, K, {SMs: (splits, units, on the busiest SM, on the busiest consumer)}
SCHEDULES = [
    ("B16 dO dx nn", "nn", R16, 768, 768, {132: (1, 840, 7, 4), 114: (1, 840, 8, 4)}),
    ("B16 dh nn", "nn", R16, 2048, 768, {132: (1, 2240, 17, 9), 114: (1, 2240, 20, 10)}),
    ("B16 dWo tn", "tn", 768, 768, R16, {132: (7, 504, 4, 2), 114: (6, 432, 4, 2)}),
    ("B16 dWqkv tn", "tn", 2304, 768, R16, {132: (7, 1512, 12, 6), 114: (2, 432, 4, 2)}),
    ("B16 dW1 tn", "tn", 2048, 768, R16, {132: (8, 1536, 12, 6), 114: (7, 1344, 12, 6)}),
    ("B16 dW2 tn", "tn", 768, 2048, R16, {132: (8, 1536, 12, 6), 114: (7, 1344, 12, 6)}),
    ("lab dh nn", "nn", LAB, 2048, 768, {132: (1, 35840, 272, 136), 114: (1, 35840, 315, 158)}),
    ("lab dWqkv tn", "tn", 2304, 768, LAB, {132: (7, 1512, 12, 6), 114: (2, 432, 4, 2)}),
    ("text dh nn", "nn", TEXT, 3072, 768, {132: (1, 1536, 12, 6), 114: (1, 1536, 14, 7)}),
    ("text dW1 tn", "tn", 3072, 768, TEXT, {132: (5, 1440, 11, 6), 114: (3, 864, 8, 4)}),
    ("06 dh nn", "nn", 8784, 512, 256, {132: (1, 552, 5, 3), 114: (1, 552, 5, 3)}),
    ("06 dW1 tn", "tn", 512, 256, 8784, {132: (17, 272, 3, 2), 114: (17, 272, 3, 2)}),
    ("tp dh nn F1024", "nn", R16, 1024, 768, {132: (1, 1120, 9, 5), 114: (1, 1120, 10, 5)}),
    ("tp dW1 tn F1024", "tn", 1024, 768, R16, {132: (11, 1056, 8, 4), 114: (9, 864, 8, 4)}),
    ("ragged nn", "nn", 600, 200, 96, {132: (1, 20, 1, 1), 114: (1, 20, 1, 1)}),
    ("ragged tn", "tn", 600, 200, 5000, {132: (9, 180, 2, 1), 114: (9, 180, 2, 1)}),
]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape,layout,m,n,k,want", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_persistent_schedule(shape, layout, m, n, k, want, sms):
    splits = t_fab._splits(m, n, k, sms, F32) if layout == "tn" else 1
    grid, units, per_block, per_consumer = _build.sgemm_nn_tn_schedule(m, n, splits, sms)
    assert (splits, units, per_block, per_consumer) == want[sms]
    assert grid == min(sms, units)
    # The consumers' unit lists, as the kernel walks them, cover every (tile,
    # split) once; each block (one per SM) holds floor or ceil(units / grid),
    # its two consumers taking them in turn.
    seen = []
    for b in range(grid):
        lists = [_units(m, n, splits, sms, b, c) for c in range(2)]
        counts = [len(x) for x in lists]
        assert counts[0] - counts[1] in (0, 1)
        assert sum(counts) in (units // grid, -(-units // grid))
        assert max(counts) <= per_consumer
        seen += lists[0] + lists[1]
    want_units = {(s, mt * BM, nt * BN) for s in range(splits)
                  for mt in range(-(-m // BM)) for nt in range(-(-n // BN))}
    assert len(seen) == units and set(seen) == want_units
    # Split-major: the first round of units (u < 2 grid, one a consumer)
    # reads the rows of splits 0 .. (2 grid - 1) // tiles only.
    tiles = units // splits
    firsts = {x[0][0] for b in range(grid)
              for x in (_units(m, n, splits, sms, b, c) for c in range(2)) if x}
    assert firsts == set(range((min(units, 2 * grid) - 1) // tiles + 1))


def test_schedule_matches_the_kernel_source():
    _src("const int first = blockIdx.x + gridDim.x * c, step = gridDim.x * MN_CONSUMERS;")
    _src("const int units = tiles * splits;")
    _src("const int t = u % tiles;")
    _src("r.split = u / tiles;")
    _src("r.m0 = t / tiles_n * MN_BM;")
    _src("r.n0 = t % tiles_n * MN_BN;")
    _src("r.kend = min(r.kb + Kc, K);")
    assert _body().count("for (int u = first; u < units; u += step)") == 2
    assert _body().count("const Unit t = mn_unit(u, tiles, tiles_n, K, Kc);") == 2


# weight grad, M, N, rows K, SMs
SPLITS = [("B16 dWo", 768, 768, R16, 132), ("B16 dWqkv", 2304, 768, R16, 132),
          ("B16 dW1", 2048, 768, R16, 132), ("B16 dW1 114", 2048, 768, R16, 114),
          ("lab dWqkv", 2304, 768, LAB, 132), ("text dW1", 3072, 768, TEXT, 132),
          ("FAME dWqkv R8784", 2304, 768, 16 * 549, 132), ("06 dW2", 256, 512, 8784, 132),
          ("ragged", 600, 200, 5000, 132)]


@pytest.mark.parametrize("name,m,n,k,sms", SPLITS, ids=[s[0] for s in SPLITS])
def test_split_boundaries(name, m, n, k, sms):
    # The cp.async kernel's splits: Kc rows on 16-row boundaries.  The kernel's
    # slices are 32 deep from each split's start; a split that ends before K
    # stops its last slice's chunks at its end (the rest is the next split's),
    # and past K TMA's zeros add 0 * 0.  So each split sums exactly its rows,
    # in order, as the cp.async kernel's 16-deep slices did.
    splits = t_fab._splits(m, n, k, sms, F32)
    kc = _build.split_rows(k, splits, F32)
    assert kc % C["MN_KSTEP"] == 0
    rows = []
    for s in range(splits):
        kb, kend = s * kc, min(s * kc + kc, k)
        assert kend > kb                          # no empty split at these shapes
        nk = -(-(kend - kb) // BK)
        for kt in range(nk):
            k0 = kb + kt * BK
            nch = (min(BK, kend - k0) if kend < k else BK) // 4
            assert nch in (4, 8) and (kend == k or k0 + 4 * nch <= kend)
            rows += [r for r in range(k0, k0 + 4 * nch) if r < k]
    assert rows == list(range(k))                 # every row once, in order
    _src("const int Kc = ((K + splits - 1) / splits + MN_KSTEP - 1) / MN_KSTEP * MN_KSTEP;")
    _src("r.kb = r.split * Kc;")
    _src("r.nk = r.kend > r.kb ? (r.kend - r.kb + MN_BK - 1) / MN_BK : 0;")
    _src("const int k0 = t.kb + kt * MN_BK;")
    _src("const int nch = (t.kend < K ? min(MN_BK, t.kend - k0) : MN_BK) / 4;")
    _src("for (int ch = 0; ch < nch; ++ch) {  // k = 4 ch + kk")


# ---- the consumer's reads under the TMA swizzle ----------------------------------------

def _kmajor(row, k):
    """Byte of element (row, k) of a [rows][32] fp32 box under
    CU_TENSOR_MAP_SWIZZLE_128B: 128-byte rows, 16-byte chunk k // 4 of row r
    at chunk (k // 4) ^ (r & 7)."""
    return row * 128 + (((k // 4) ^ (row & 7)) << 4) + (k % 4) * 4


def _mnmajor(k, col):
    """Byte of element (k, col) of consecutive [32 K][32 MN] fp32 boxes (box
    col // 32): 128-byte lines of 32 columns, chunk g of line k at g ^ (k & 7)."""
    return (col // 32) * BOX + k * 128 + ((((col % 32) // 4) ^ (k & 7)) << 4) + (col % 4) * 4


def _thread(tid, at):
    """The kernel's consumer thread map (its lines are checked against the
    source below)."""
    w, lane = tid // 32, tid % 32
    rq, cq = lane // 8, lane % 8
    r0 = (w // 2) * 64 + (w % 2) * 4 + rq
    ga = 4 * w + rq
    offa = (w // 2) * BOX + ((4 * (w % 2) + rq) << 4) if at else r0 * 128 + ((r0 & 7) << 4)
    offb = A_BYTES + (cq << 4)
    rows = [4 * ga + (i & 3) + 64 * (i >> 2) for i in range(8)] if at else \
        [r0 + 8 * i for i in range(8)]
    cols = [4 * cq + (j & 3) + 32 * (j >> 2) for j in range(8)]
    return dict(w=w, rq=rq, cq=cq, offa=offa, offb=offb, rows=rows, cols=cols)


def _reads(t, at, ch):
    """The float4 reads of chunk ch as the kernel issues them: ("a" | "b",
    kk, the first of the 4 rows / columns it fills, byte address in the
    stage); "nn" reads row i's 4 k at once (kk None)."""
    xb = (t["offb"] + 512 * ch) ^ ((ch & 1) << 6)
    out = []
    for kk in range(4):
        out += [("b", kk, 0, (xb ^ (kk << 4)) + 128 * kk),
                ("b", kk, 4, (xb ^ (kk << 4)) + 128 * kk + BOX)]
    if at:
        xa = (t["offa"] + 512 * ch) ^ ((ch & 1) << 6)
        for kk in range(4):
            out += [("a", kk, 0, (xa ^ (kk << 4)) + 128 * kk),
                    ("a", kk, 4, (xa ^ (kk << 4)) + 128 * kk + 2 * BOX)]
    else:
        out += [("a", None, i, (t["offa"] ^ (ch << 4)) + 1024 * i) for i in range(8)]
    return out


def test_thread_map_is_the_source():
    _src("const int rq = lane / 8, cq = lane % 8;")
    _src("const int r0 = (w / 2) * 64 + (w % 2) * 4 + rq;  // \"nn\": rows r0 + 8 i")
    _src("const int ga = 4 * w + rq;")
    _src("const uint32_t offa = AT ? (w / 2) * MN_BOX + ((4 * (w % 2) + rq) << 4)\n"
         "                           : r0 * 128 + ((r0 & 7) << 4);")
    _src("const uint32_t offb = MN_A_BYTES + (cq << 4);")
    _src("const uint32_t xb = (offb + 512 * ch) ^ ((ch & 1) << 6);")
    _src("const uint32_t xa = (offa + 512 * ch) ^ ((ch & 1) << 6);")
    assert _body().count(
        "reinterpret_cast<const float4*>(st + ((xb ^ (kk << 4)) + 128 * kk));") == 1
    _src("reinterpret_cast<const float4*>(st + ((xa ^ (kk << 4)) + 128 * kk));")
    _src("*reinterpret_cast<float4*>(&b[kk][4]) = p[MN_BOX / 16];  // box 1: columns + 32")
    _src("*reinterpret_cast<float4*>(&a[kk][4]) = p[2 * MN_BOX / 16];  // boxes + 2: rows + 64")
    _src("const float4* pa = reinterpret_cast<const float4*>(st + (offa ^ (ch << 4)));")
    _src("const float4 r = pa[64 * i];")
    _src("a[0][i] = r.x; a[1][i] = r.y; a[2][i] = r.z; a[3][i] = r.w;")
    assert _body().count(
        "const int row = t.m0 + (AT ? 4 * ga + (i & 3) + 64 * (i >> 2) : r0 + 8 * i);") == 2
    assert _body().count("const int col = t.n0 + 4 * cq + 32 * h;") == 2


@pytest.mark.parametrize("at", [0, 1], ids=["nn", "tn"])
def test_each_thread_reads_its_elements_where_tma_put_them(at):
    cover = set()
    for tid in range(128):
        t = _thread(tid, at)
        for ch in range(BK // 4):
            for what, kk, first, addr in _reads(t, at, ch):
                for e in range(4):   # the float4's .x .y .z .w
                    if what == "b":  # b[kk][first + e]: B at (k, column)
                        want = A_BYTES + _mnmajor(4 * ch + kk, t["cols"][first + e])
                    elif at:         # a[kk][first + e]: A^T at (k, row)
                        want = _mnmajor(4 * ch + kk, t["rows"][first + e])
                    else:            # a[e][first]: A at (row, k = 4 ch + e)
                        want = _kmajor(t["rows"][first], 4 * ch + e)
                    assert addr + 4 * e == want, (tid, ch, what, kk, first, e)
        cover |= {(r, c) for r in t["rows"] for c in t["cols"]}
    assert cover == {(r, c) for r in range(BM) for c in range(BN)}   # each output once


def _wavefronts(addrs, width):
    """Shared-memory wavefronts of one warp access of ``width`` bytes a lane
    (4, 16): unique ``width``-byte words, grouped by the banks they take; a
    wavefront serves words on distinct banks."""
    per_bank = {}
    for a in set(addrs):
        for b in range(a // 4, a // 4 + width // 4):
            per_bank.setdefault(b % 32, set()).add(a)
    return max(len(v) for v in per_bank.values())


@pytest.mark.parametrize("at", [0, 1], ids=["nn", "tn"])
def test_every_warp_read_of_the_ring_is_one_wavefront(at):
    for w in range(4):
        lanes = [_thread(32 * w + lane, at) for lane in range(32)]
        for ch in range(BK // 4):
            reads = [_reads(t, at, ch) for t in lanes]
            for n in range(len(reads[0])):
                what = reads[0][n][0]
                addrs = [r[n][3] for r in reads]
                # B: the 8 chunks of one 128-byte line; A: 4 chunks of a line
                # ("tn") or 4 rows of distinct r & 7 ("nn").
                assert len(set(addrs)) == (8 if what == "b" else 4)
                assert _wavefronts(addrs, 16) == 1


def test_epilogue_stores_whole_lines_from_the_registers():
    # No staging tile: a warp's 16-byte stores of row i, group h cover 4 rows x
    # 128 aligned bytes of C (fp32, N a multiple of 32 here), and so do its
    # resid / gate loads, all read before the first store.
    n = 768
    for at in (0, 1):
        for w in range(4):
            lanes = [_thread(32 * w + lane, at) for lane in range(32)]
            for i in range(8):
                for h in range(2):
                    addrs = {4 * (t["rows"][i] * n + t["cols"][4 * h]) for t in lanes}
                    lines = {a // 128 for a in addrs}
                    assert len(addrs) == 32 and len(lines) == 4
                    assert all(sum(1 for a in addrs if a // 128 == x) == 8 for x in lines)
    body = _body()
    assert "stage[" not in body
    _src("*reinterpret_cast<const float4*>(src + (size_t)row * N + col);")
    assert body.index("src + (size_t)row * N + col") < body.index("epilogue_group<MODE, 4")
    _src("epilogue_group<MODE, 4, float, float>(e, row, col, N, &acc[i][4 * h], out, &csum[4 * h],")


def _cp_async_groups():
    """The cp.async kernel's order of a 128-row tile's column sum: 16 groups
    tr, each of 8 rows summed in order from 0 (its thread's rows 4 ga + {0..3}
    and 4 ga + 16 + {0..3}, ga = 8 (tr / 4) + tr % 4), then the groups in
    order."""
    return [[4 * (8 * (tr // 4) + tr % 4) + d for d in (0, 1, 2, 3, 16, 17, 18, 19)]
            for tr in range(16)]


def test_gate_column_sums_take_the_cp_async_order():
    # colpart[m0 / 128, col] of a gated "nn" tile: the kernel's shuffle chains
    # visit each group's rows in the cp.async kernel's order, so db1 is the
    # same bits as before.  Group g of warp w: tr = 4 (2 (w / 2) + a) + w % 2 +
    # 2 b (g = 2 a + b), hop h at lane rq = h % 4, row r0 + 8 i with i = 4 a +
    # b (+ 2 from hop 4 on); each hop reads the sum from lane rq - 1.
    groups = _cp_async_groups()
    assert sorted(r for g in groups for r in g) == list(range(BM))   # every row once
    seen = {}
    for w in range(4):
        for g in range(4):
            a, b = g >> 1, g & 1
            tr = 4 * (2 * (w // 2) + a) + w % 2 + 2 * b
            chain = []
            for hop in range(8):
                rq = hop % 4
                i = 4 * a + b + (0 if hop < 4 else 2)
                chain.append(_thread(32 * w + 8 * rq, 0)["rows"][i])
            seen[tr] = chain
    assert seen == dict(enumerate(groups))
    # One colpart row per 128-row tile (the wrapper's [ceil(M / 128), N]).
    assert BM == _build.SUM_ROWS
    _src("const int i = 4 * (g >> 1) + (g & 1) + (hop < 4 ? 0 : 2);")
    _src("const int tr = 4 * (2 * (w / 2) + (g >> 1)) + w % 2 + 2 * (g & 1);")
    _src("if (hop > 0) p[g][j] = __shfl_sync(0xffffffffu, p[g][j], (lane + 24) % 32);")
    _src("p[g][j] = (hop > 0 ? p[g][j] : 0.0f) + (in ? acc[i][j] : 0.0f);")
    _src("for (int r = 0; r < 16; ++r) sum += sums[r * MN_BN + tid];")
    _src("e.colpart[(size_t)(t.m0 / MN_BM) * N + t.n0 + tid] = sum;")
    # (lane + 24) % 32 is the same cq one rq down (rq 0 from rq 3).
    for lane in range(32):
        src = (lane + 24) % 32
        assert src % 8 == lane % 8 and src // 8 == (lane // 8 - 1) % 4
    # Named barriers of the consumer's 128 threads before (the last tile's
    # sums are read) and after (all are written) the stores.
    assert _body().count('asm volatile("bar.sync %0, 128;\\n" ::"r"(1 + c) : "memory");') == 2


def test_accumulation_order_is_k_ascending():
    # One fmaf chain per element: the 4 k of a chunk in order (kk outermost;
    # the serpentine order runs over columns, not k), chunks and slices in
    # order over the split.
    body = _body()
    loop = re.search(r"for \(int ch = 0; ch < nch; \+\+ch\) \{(.*?)\n      \}\n", body,
                     re.S).group(1)
    fma = loop[loop.rindex("#pragma unroll\n        for (int kk"):]
    assert re.findall(r"for \(int (\w+) = 0;", fma) == ["kk", "i", "jj"]
    assert "const int j = (i & 1) ? 7 - jj : jj;" in fma
    assert "acc[i][j] = fmaf(a[kk][i], b[kk][j], acc[i][j]);" in fma
    assert body.count("fmaf(") == 1
    assert "for (int kt = 0; kt < t.nk; ++kt, ++q) {" in body
