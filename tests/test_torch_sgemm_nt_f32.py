"""The fp32 "nt" GEMM kernel's design, on the CPU.

``gemm.cu``'s ``gemm_f32_nt_kernel`` runs every fp32 "nt" product (the
forward's QKV, Wo, W1 and W2): one persistent block per SM, two consumers of
a warpgroup each with its own producer warp, a TMA ring of 32-deep K slices
with the 128-byte swizzle, read in place.  These tests hold ``_build.SGEMM_NT``
and the schedule helpers against the source, pin the tiles on the busiest SM
and consumer at the shapes the port runs on 132- and 114-SM cards, and model
the consumer's thread map under the TMA swizzle: each warp read of the ring
is one shared-memory wavefront, every read lands on the element the math
needs, and the staging tile's stores and loads take no more wavefronts than
their bytes.
"""

import re
from pathlib import Path

import pytest

from fairmultimodal_torch.ops import _build

_CSRC = Path(__file__).resolve().parents[1] / "fairmultimodal_torch" / "ops" / "csrc"
_GEMM = (_CSRC / "gemm.cu").read_text()
# The TMA-map encoding gemm.cu calls, shared with flash_attention.cu.
_HOPPER = (_CSRC / "fm_hopper.cuh").read_text()
SMEM_PER_BLOCK = 232448        # 227 KB: what a block of an H100 may take
REGS_PER_SM = 65536


def _nt_consts():
    """Every ``constexpr int NT_* = expr;`` of gemm.cu, evaluated in order."""
    env = {}
    for name, expr in re.findall(r"constexpr int (NT_\w+) = ([^;]+);", _GEMM):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))   # noqa: S307
    return env


C = _nt_consts()


def _nt_body():
    """The source of gemm_f32_nt_kernel."""
    start = _GEMM.index("gemm_f32_nt_kernel(")
    return _GEMM[start:_GEMM.index("\ncudaError_t launch_f32_nt(", start)]
BM, BN = _build.SGEMM_NT["tile"]
BK = _build.SGEMM_NT["bk"]


def test_build_mirrors_the_kernel_constants():
    nt = _build.SGEMM_NT
    assert nt["tile"] == (C["NT_BM"], C["NT_BN"])
    assert (nt["bk"], nt["stages"], nt["consumers"]) == (
        C["NT_BK"], C["NT_STAGES"], C["NT_CONSUMERS"])
    assert nt["threads"] == C["NT_THREADS"]
    assert nt["pitch"] == C["NT_CPITCH"]
    assert nt["smem"] == C["NT_SMEM"]
    assert _build.sgemm_tile("nt", 8960, 2304, 1, 132) == nt["tile"]
    # One 128-byte swizzle line of fp32 per row of a K slice.
    assert BK * 4 == 128
    assert 'tma_map(&ta, A, true, M, K, NT_BM, NT_BK)' in _GEMM
    assert 'tma_map(&tb, B, true, N, K, NT_BN, NT_BK)' in _GEMM
    assert '#include "fm_hopper.cuh"' in _GEMM
    tma_map = _HOPPER[_HOPPER.index("static inline bool tma_map("):]
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in tma_map[:tma_map.index("\n}\n")]


def test_shared_memory_and_registers_fit_the_residency():
    nt = _build.SGEMM_NT
    ring = nt["stages"] * (BM + BN) * BK * 4
    staging = BM * nt["pitch"] * 4
    bars = 2 * nt["stages"] * 8
    assert nt["smem"] == nt["consumers"] * (ring + staging + bars) + 1024
    assert nt["smem"] * nt["blocks_per_sm"] <= SMEM_PER_BLOCK
    # Swizzle atoms (1024 bytes) stay aligned from stage to stage.
    assert ((BM + BN) * BK * 4) % 1024 == 0 and staging % 1024 == 0
    # The residency is the launch's: one block of NT_THREADS per SM, a
    # warpgroup per consumer and one for the producers.
    assert re.search(r"__launch_bounds__\(NT_THREADS, 1\)\s*gemm_f32_nt_kernel", _GEMM)
    assert nt["threads"] == (nt["consumers"] + 1) * 128
    assert "<<<sms < tiles ? sms : tiles, NT_THREADS, NT_SMEM, s>>>" in _GEMM


def test_registers_fit_each_quarter_of_the_file():
    # The SM's 65536 registers are four files of 16384, one per scheduler, and
    # warp k of every warpgroup sits on file k: a block starts at what 384
    # threads allow (168), then setmaxnreg moves registers from the
    # producers' warpgroup to the consumers'.
    threads, consumers = _build.SGEMM_NT["threads"], _build.SGEMM_NT["consumers"]
    start = (REGS_PER_SM // threads) // 8 * 8
    assert start == 168
    dec = int(re.search(r"setmaxnreg\.dec\.sync\.aligned\.u32 (\d+);", _nt_body()).group(1))
    inc = int(re.search(r"setmaxnreg\.inc\.sync\.aligned\.u32 (\d+);", _nt_body()).group(1))
    assert dec < start < inc and dec % 8 == 0 and inc % 8 == 0
    assert (consumers * inc + dec) * 32 <= REGS_PER_SM // 4
    # The consumers' need: 64 accumulators, a chunk of operands (8 + 8 float4)
    # and room for the next one in flight, plus addresses.
    assert 64 + 2 * 64 < inc


def _consumer_tiles(m, n, sms, block, consumer):
    """The (row, column) origins of the tiles consumer ``consumer`` of block
    ``block`` runs, in order, as the kernel's loop walks them: tiles numbered
    N-fastest, t = block + grid * (consumers * i + consumer)."""
    tiles_n = -(-n // BN)
    grid, tiles = _build.sgemm_nt_schedule(m, n, sms)[:2]
    step = grid * _build.SGEMM_NT["consumers"]
    return [(t // tiles_n * BM, t % tiles_n * BN)
            for t in range(block + grid * consumer, tiles, step)]


# shape, M, N, {SMs: (tiles, on the busiest SM, on the busiest consumer)}
SCHEDULES = [
    ("lab B16 qkv", 16 * 560, 2304, {132: (2520, 20, 10), 114: (2520, 23, 12)}),
    ("lab B16 w1", 16 * 560, 2048, {132: (2240, 17, 9), 114: (2240, 20, 10)}),
    ("lab B16 wo w2", 16 * 560, 768, {132: (840, 7, 4), 114: (840, 8, 4)}),
    ("lab B256 qkv", 256 * 560, 2304, {132: (40320, 306, 153), 114: (40320, 354, 177)}),
    ("lab B256 w1", 256 * 560, 2048, {132: (35840, 272, 136), 114: (35840, 315, 158)}),
    ("lab B256 wo w2", 256 * 560, 768, {132: (13440, 102, 51), 114: (13440, 118, 59)}),
    ("text qkv", 8 * 512, 2304, {132: (1152, 9, 5), 114: (1152, 11, 6)}),
    ("text w1", 8 * 512, 3072, {132: (1536, 12, 6), 114: (1536, 14, 7)}),
    ("text w2", 8 * 512, 768, {132: (384, 3, 2), 114: (384, 4, 2)}),
    ("06 w1", 8784, 512, {132: (552, 5, 3), 114: (552, 5, 3)}),
    ("06 w2", 8784, 256, {132: (276, 3, 2), 114: (276, 3, 2)}),
    ("tp w1 F1024", 16 * 560, 1024, {132: (1120, 9, 5), 114: (1120, 10, 5)}),
    ("ragged", 600, 200, {132: (20, 1, 1), 114: (20, 1, 1)}),
]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape,m,n,want", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_persistent_schedule(shape, m, n, want, sms):
    grid, tiles, per_block, per_consumer = _build.sgemm_nt_schedule(m, n, sms)
    assert (tiles, per_block, per_consumer) == want[sms]
    assert grid == min(sms, tiles)
    # The consumers' tile lists, as the kernel walks them, cover every tile
    # once; each block (one per SM) holds floor or ceil(tiles / grid), its two
    # consumers taking them in turn.
    seen = []
    for b in range(grid):
        lists = [_consumer_tiles(m, n, sms, b, c) for c in range(2)]
        counts = [len(t) for t in lists]
        assert counts[0] - counts[1] in (0, 1)
        assert sum(counts) in (tiles // grid, -(-tiles // grid))
        assert max(counts) <= per_consumer
        seen += lists[0] + lists[1]
    origins = {(mt * BM, nt * BN) for mt in range(-(-m // BM)) for nt in range(-(-n // BN))}
    assert len(seen) == tiles and set(seen) == origins
    # N-fastest: a consumer's next tile is the one grid * 2 on in that order.
    first = _consumer_tiles(m, n, sms, 0, 0)[:2]
    if len(first) == 2:
        tn = -(-n // BN)
        t1 = first[1][0] // BM * tn + first[1][1] // BN
        assert t1 == 2 * grid


def test_schedule_matches_the_kernel_source():
    assert "const int first = blockIdx.x + gridDim.x * c, step = gridDim.x * NT_CONSUMERS;" \
        in _GEMM
    assert _GEMM.count("const int m0 = t / tiles_n * NT_BM, n0 = t % tiles_n * NT_BN;") == 2
    assert _GEMM.count("for (int t = first; t < tiles; t += step)") == 2


# ---- the consumer's reads under the TMA swizzle ----------------------------------------

def _tma_offset(row, k):
    """Byte offset of element (row, k) of a [rows][32] fp32 box in shared
    memory under CU_TENSOR_MAP_SWIZZLE_128B: 128-byte rows, the 16-byte chunk
    k // 4 of row r at chunk (k // 4) ^ (r & 7)."""
    return row * 128 + (((k // 4) ^ (row & 7)) << 4) + (k % 4) * 4


def _src(expr):
    assert expr in _GEMM, expr
    return expr


def _thread(tid):
    """The kernel's consumer thread map (its lines are checked against the
    source below): rows r0 + 8 i, columns cq + 8 j, and the two offsets."""
    w, lane = tid // 32, tid % 32
    rq, cq = lane // 8, lane % 8
    r0 = (w // 2) * 64 + (w % 2) * 4 + rq
    offa = r0 * 128 + ((r0 & 7) << 4)
    offb = BM * BK * 4 + cq * 128 + (cq << 4)
    return r0, cq, offa, offb


def test_thread_map_is_the_source():
    _src("const int rq = lane / 8, cq = lane % 8;")
    _src("const int r0 = (w / 2) * 64 + (w % 2) * 4 + rq;")
    _src("const uint32_t offa = r0 * 128 + ((r0 & 7) << 4);")
    _src("const uint32_t offb = NT_A_BYTES + cq * 128 + (cq << 4);")
    _src("reinterpret_cast<const float4*>(st + (offa ^ (ch << 4)));")
    _src("reinterpret_cast<const float4*>(st + (offb ^ (ch << 4)));")
    _src("for (int i = 0; i < 8; ++i) a[i] = pa[64 * i];")
    _src("for (int j = 0; j < 8; ++j) b[j] = pb[64 * j];")
    _src("stage[(r0 + 8 * i) * NT_CPITCH + cq + 8 * j] = acc[i][j];")


def test_each_thread_reads_its_rows_where_tma_put_them():
    a_bytes = BM * BK * 4
    cover = set()
    for tid in range(128):
        r0, cq, offa, offb = _thread(tid)
        for ch in range(BK // 4):
            for i in range(8):
                addr = (offa ^ (ch << 4)) + 1024 * i
                for e in range(4):   # the float4's .x .y .z .w are k = 4 ch .. 4 ch + 3
                    assert addr + 4 * e == _tma_offset(r0 + 8 * i, 4 * ch + e)
            for j in range(8):
                addr = (offb ^ (ch << 4)) + 1024 * j - a_bytes
                for e in range(4):
                    assert addr + 4 * e == _tma_offset(cq + 8 * j, 4 * ch + e)
        cover |= {(r0 + 8 * i, cq + 8 * j) for i in range(8) for j in range(8)}
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


def test_every_warp_read_of_the_ring_is_one_wavefront():
    for w in range(4):
        lanes = [_thread(32 * w + lane) for lane in range(32)]
        for ch in range(BK // 4):
            for i in range(8):
                addrs = [(offa ^ (ch << 4)) + 1024 * i for _, _, offa, _ in lanes]
                assert len(set(addrs)) == 4 and _wavefronts(addrs, 16) == 1
            for j in range(8):
                addrs = [(offb ^ (ch << 4)) + 1024 * j for _, _, _, offb in lanes]
                assert len(set(addrs)) == 8 and _wavefronts(addrs, 16) == 1


def test_unswizzled_rows_four_apart_would_conflict():
    # The layout the swizzle replaces: unswizzled 64-byte rows (16 K) read a
    # lane per row, rows 4 apart (the K-major reads gemm.cu's note records as
    # 13% slower): all on one bank quad, one wavefront per row.
    addrs = [row * 64 for row in range(0, 32, 4)]
    assert _wavefronts(addrs, 16) == 8


def test_staging_tile_stores_and_loads():
    pitch = _build.SGEMM_NT["pitch"]
    for w in range(4):
        lanes = [_thread(32 * w + lane) for lane in range(32)]
        for i in range(8):
            for j in range(8):   # scalar stores: 32 distinct banks
                addrs = [4 * ((r0 + 8 * i) * pitch + cq + 8 * j) for r0, cq, _, _ in lanes]
                assert _wavefronts(addrs, 4) == 1
        for u in range(BM * BN // 4 // 128):   # float4 loads: 512 bytes in 4 wavefronts
            g = [u * 128 + 32 * w + lane for lane in range(32)]
            addrs = [4 * ((x // (BN // 4)) * pitch + 4 * (x % (BN // 4))) for x in g]
            assert _wavefronts(addrs, 16) == 4
    _src("load_group<4>(stage + lr * NT_CPITCH + 4 * (g % (NT_BN / 4)), v);")


def test_accumulation_order_is_k_ascending():
    # One fmaf chain per element: the .x .y .z .w of chunk ch are k = 4 ch + 0..3,
    # chunks in order within a slice, slices in order over K.
    body = re.search(r"for \(int ch = 0; ch < NT_BK / 4; \+\+ch\) \{(.*?)__syncwarp", _GEMM,
                     re.S).group(1)
    fmas = re.findall(r"acc\[i\]\[j\] = fmaf\(a\[i\]\.(\w), b\[j\]\.(\w), acc\[i\]\[j\]\);",
                      body)
    assert fmas == [("x", "x"), ("y", "y"), ("z", "z"), ("w", "w")]
