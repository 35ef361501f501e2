"""The bf16 "nt" GEMM kernel's design, on the CPU.

``gemm.cu``'s ``gemm_bf16_nt_kernel`` runs every bf16 "nt" product (QKV, Wo,
W1 and W2 of Pallas #1, #2, #5 and #7, and the note encoder's): one
persistent block per SM walking 128 x 256 tiles N-fastest, two consumer
warpgroups of m64n256k16 wgmma, a producer warpgroup whose warp 8 issues the
TMA copies and whose warps 9-11 draw each tile's dropout keep bits a tile
ahead, and an epilogue that each consumer warp runs on its fragments in
registers and stages through rows of its own for full-line stores.  These tests hold ``_build.WGMMA_NT`` and ``bf16_nt_schedule`` against
the source, pin the tiles on the busiest SM at the port's shapes on 132- and
114-SM cards, check that ``fm_gemm`` sends "nt" to this kernel and "nn" /
"tn" to ``gemm_bf16_nn_tn_kernel``, and model the epilogue: every output element
is stored once, from the accumulator that holds it, each shared-memory access
takes the fewest wavefronts its bytes allow, and the keep bits are Philox's
at counter (row * N + col) >> 2, word (row * N + col) & 3, which is
``utils.rng.dropout_mask`` tile by tile.
"""

import re
from pathlib import Path

import pytest
import torch

from fairmultimodal_torch.ops import _build
from fairmultimodal_torch.utils import rng

_CSRC = Path(__file__).resolve().parents[1] / "fairmultimodal_torch" / "ops" / "csrc"
_GEMM = (_CSRC / "gemm.cu").read_text()
SMEM_PER_BLOCK = 232448        # 227 KB: what a block of an H100 may take
REGS_PER_SM = 65536
NT = _build.WGMMA_NT
BM, BN = NT["tile"]
CHUNK = NT["chunk"]


def _consts(prefix):
    """Every ``constexpr int <prefix>* = expr;`` of gemm.cu, evaluated in order."""
    env = {}
    for name, expr in re.findall(rf"constexpr int ({prefix}\w+) = ([^;]+);", _GEMM):
        env[name] = eval(" ".join(expr.split()).replace("/", "//"), {}, dict(env))  # noqa: S307
    return env


C = _consts("WN_")


def _body(start, end):
    i = _GEMM.index(start)
    return _GEMM[i:_GEMM.index(end, i)]


KERNEL = _body("gemm_bf16_nt_kernel(const", "\ncudaError_t launch_bf16_nt(")


def _src(expr, text=KERNEL):
    assert expr in text, expr
    return expr


def test_build_mirrors_the_kernel_constants():
    assert NT["tile"] == (C["WN_BM"], C["WN_BN"])
    assert (NT["bk"], NT["stages"], NT["consumers"], NT["threads"]) == (
        C["WN_BK"], C["WN_STAGES"], C["WN_CONSUMERS"], C["WN_THREADS"])
    assert (NT["chunk"], NT["mask"], NT["mask_threads"], NT["smem"]) == (
        C["WN_CHUNK"], C["WN_MASK"], C["WN_MASK_THREADS"], C["WN_SMEM"])
    # One 128-byte swizzle line of bf16 per row of a K slice, both operands K-major.
    assert NT["bk"] * 2 == 128
    _src("tma_map(&ta, A, false, M, K, WN_BM, WN_BK)", _GEMM)
    _src("tma_map(&tb, B, false, N, K, WN_BN, WN_BK)", _GEMM)
    # The "nn" / "tn" kernel keeps its tile and the split-K model sized from it,
    # so the bf16 weight grads keep their split counts and bits.
    wg = _consts("WG_")
    assert _build.WGMMA_TILE == (wg["WG_BM"], wg["WG_BN"]) == (BM, BN)
    assert _build.GEMM_SCHEDULE[torch.bfloat16] == (_build.WGMMA_TILE, 1, 64, 2048)


def test_shared_memory_fits_the_residency():
    ring = NT["stages"] * (BM + BN) * NT["bk"] * 2
    chunks = 4 * NT["consumers"] * 16 * 128            # 16 staging rows of 128 bytes a warp
    biases = 4 * NT["consumers"] * BN * 4              # and its copy of the tile's bias
    masks = 2 * BM * BN // 8                           # two tiles of keep bits
    bars = (2 * NT["stages"] + 4) * 8                  # full, empty; mfull, mempty
    assert NT["smem"] == ring + chunks + biases + masks + bars + 1024
    assert NT["smem"] * NT["blocks_per_sm"] <= SMEM_PER_BLOCK
    assert ((BM + BN) * NT["bk"] * 2) % 1024 == 0     # swizzle atoms stay aligned
    assert NT["mask"] == BM * BN // 8
    assert re.search(r"__launch_bounds__\(WN_THREADS, 1\)\s*gemm_bf16_nt_kernel", _GEMM)
    assert NT["threads"] == (NT["consumers"] + 1) * 128
    _src("<<<sms < tiles ? sms : tiles, WN_THREADS, WN_SMEM, s>>>", _GEMM)
    # Warp 8 issues the copies; warps 9-11 draw the masks.
    assert NT["mask_threads"] == 3 * 32
    _src("const int mt = threadIdx.x - (4 * WN_CONSUMERS + 1) * 32;")


def test_registers_fit_each_quarter_of_the_file():
    # Warp k of every warpgroup sits on quarter k of the SM's register file
    # (16384 registers): a block of 384 starts at 168 a thread, then setmaxnreg
    # moves registers from the producer warpgroup to the two consumers.
    start = (REGS_PER_SM // NT["threads"]) // 8 * 8
    assert start == 168
    dec = int(re.search(r"setmaxnreg_dec<(\d+)>\(\);", KERNEL).group(1))
    inc = int(re.search(r"setmaxnreg_inc<(\d+)>\(\);", KERNEL).group(1))
    assert (dec, inc) == (56, 224)
    assert dec < start < inc and dec % 8 == 0 and inc % 8 == 0
    assert (NT["consumers"] * inc + dec) * 32 <= REGS_PER_SM // 4
    # A consumer holds 128 fp32 accumulators (64 x 256 over 128 threads) and,
    # in the epilogue, 8 values, 8 bias terms and addresses beside them.
    assert 64 * BN // 128 == 128 and 128 + 8 + 8 + 32 < inc
    assert "float acc[128];" in KERNEL


# shape, M, N, {SMs: (tiles, tiles on the busiest SM)}
SCHEDULES = [
    ("lab qkv", 256 * 560, 2304, {132: (10080, 77), 114: (10080, 89)}),
    ("lab w1", 256 * 560, 2048, {132: (8960, 68), 114: (8960, 79)}),
    ("lab wo w2", 256 * 560, 768, {132: (3360, 26), 114: (3360, 30)}),
    ("text qkv", 32 * 512, 2304, {132: (1152, 9), 114: (1152, 11)}),
    ("text w1", 32 * 512, 3072, {132: (1536, 12), 114: (1536, 14)}),
    ("text wo w2", 32 * 512, 768, {132: (384, 3), 114: (384, 4)}),
    ("B16 qkv", 16 * 549, 2304, {132: (621, 5), 114: (621, 6)}),
    ("B16 w1", 16 * 549, 2048, {132: (552, 5), 114: (552, 5)}),
    ("B16 wo w2", 16 * 549, 768, {132: (207, 2), 114: (207, 2)}),
    ("06 w1", 8784, 512, {132: (138, 2), 114: (138, 2)}),
    ("06 w2", 8784, 256, {132: (69, 1), 114: (69, 1)}),
    ("ragged", 600, 200, {132: (5, 1), 114: (5, 1)}),
]


def _block_tiles(m, n, sms, block):
    """The (row, column) origins of the tiles block ``block`` runs, in order,
    as the kernel's loop walks them: tiles numbered N-fastest, t = block +
    grid * i."""
    tiles_n = -(-n // BN)
    grid, tiles = _build.bf16_nt_schedule(m, n, sms)[:2]
    return [(t // tiles_n * BM, t % tiles_n * BN) for t in range(block, tiles, grid)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape,m,n,want", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_persistent_schedule(shape, m, n, want, sms):
    grid, tiles, busiest = _build.bf16_nt_schedule(m, n, sms)
    assert (tiles, busiest) == want[sms]
    assert grid == min(sms, tiles)
    # The blocks' tile lists cover every tile once; each block (one per SM)
    # runs floor or ceil(tiles / grid), both consumers on each.
    seen = []
    for b in range(grid):
        mine = _block_tiles(m, n, sms, b)
        assert len(mine) in (tiles // grid, -(-tiles // grid))
        seen += mine
    origins = {(mt * BM, nt * BN) for mt in range(-(-m // BM)) for nt in range(-(-n // BN))}
    assert len(seen) == tiles and set(seen) == origins
    assert max(len(_block_tiles(m, n, sms, b)) for b in range(grid)) == busiest


def test_schedule_matches_the_kernel_source():
    # The producer, the mask warps and the consumers walk one order.
    assert KERNEL.count("for (int t = blockIdx.x; t < tiles; t += gridDim.x") == 3
    assert KERNEL.count("const int m0 = t / tiles_n * WN_BM, n0 = t % tiles_n * WN_BN;") == 3
    _src("const int tiles = (M + WN_BM - 1) / WN_BM * tiles_n;")


def test_no_narrower_tile_clears_the_b16_tail():
    # Wo / W2 at batch 16 (R 8784, N 768): 207 tiles of 128 x 256 on 132 SMs,
    # two on the busiest against 1.57 on average.  In units of a 128 x 256
    # tile's work, what the busiest SM would run with other tiles, and the L2
    # bytes each tile reads per FLOP (1 / BM + 1 / BN) against 128 x 256's.
    def busiest(bm, bn):
        tiles = -(-8784 // bm) * -(-768 // bn)
        return -(-tiles // min(132, tiles)) * bm * bn / (128 * 256)

    traffic = lambda bm, bn: (1 / bm + 1 / bn) / (1 / 128 + 1 / 256)   # noqa: E731
    assert busiest(128, 256) == 2.0
    assert busiest(128, 128) == busiest(64, 256) == 2.0    # no lighter
    assert busiest(128, 192) == 2.25                       # heavier
    # Only tiles of a third or a quarter of the width lighten it, for 1.56x
    # and 2x the L2 traffic of a tile whose own traffic may already bound it.
    assert busiest(128, 96) == 1.875 and round(traffic(128, 96), 2) == 1.56
    assert busiest(128, 64) == 1.75 and traffic(128, 64) == 2.0


def test_nt_runs_the_persistent_kernel_and_nn_tn_the_wgmma_kernel():
    launch = _body("template <int AT, int BT, int MODE>\ncudaError_t launch(", "\n}\n")
    f32, bf16 = launch.split("  if constexpr (!AT && !BT) {")
    assert "if (dtype == FM_F32) {" in f32 and "launch_bf16_nt" not in f32
    nt, other = bf16.split("} else {")
    assert "launch_bf16_nt<float>" in nt and "launch_bf16_nt<fm_bf16>" in nt
    assert "launch_bf16_nn_tn" not in nt
    assert "launch_bf16_nn_tn<float, AT, MODE>" in other and "launch_bf16_nt" not in other
    # fm_gemm: "nt" is layout 0 with both operands K-major; "nn" / "tn" set BT.
    assert "if (layout == 0) return launch<0, 0, EPI_BIAS_ACT>" in _GEMM
    assert "if (layout == 2) return launch<1, 1, EPI_STORE>" in _GEMM
    assert _GEMM.count("return launch<0, 1, EPI_") == 3
    # gemm_bf16_nn_tn_kernel takes B MN-major only; the "nt" kernel both K-major.
    wg = _body("gemm_bf16_nn_tn_kernel(const", "\n// The map of one bf16 operand")
    assert "wgmma_m64n256k16<AT, 1>(acc, wg_desc<AT>(a, kk), wg_desc<1>(b, kk));" in wg
    _src("wgmma_m64n256k16<0, 0>(acc, wg_desc<0>(a, kk), wg_desc<0>(b, kk));")
    assert "template <typename TOut, int AT, int MODE, int GK>\n__global__" in _GEMM
    # No switch selects another kernel.
    assert "getenv" not in _GEMM


def test_one_wgmma_batch_stays_in_flight():
    main = _body("for (int kt = 0; kt < nk; ++kt, ++qs) {", "// Epilogue")
    _src("wgmma.wait_group.sync.aligned 1;", main)
    # The previous slice's stage is released after the wait, the last one after
    # the final wait_group 0.
    assert main.index("wait_group.sync.aligned 1") < main.index(
        "if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(qs - 1) % WN_STAGES]);")
    assert main.index("wgmma_wait_all();") < main.index(
        "if (nk > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(qs - 1) % WN_STAGES]);")


# ---- the epilogue's thread map ------------------------------------------------------

def _stage_off(r, k):
    """gemm.cu's wn_stage_off: byte offset of 16-byte word k of staging row r,
    at word k ^ swz(r), swz(r) = 2 (r & 3) + ((r >> 2) & 1)."""
    return r * 128 + ((k ^ (2 * (r & 3) + ((r >> 2) & 1))) << 4)


def test_thread_map_is_the_source():
    _src("return r * 128 + ((k ^ (2 * (r & 3) + ((r >> 2) & 1))) << 4);", _GEMM)
    _src("const int k = lane % 8, col = col0 + k * E;", _GEMM)
    _src("const int r = lane / 8 + 4 * j, row = row0 + r;", _GEMM)
    _src("*reinterpret_cast<__nv_bfloat162*>(st + wn_stage_off(r, c / 8) + (c % 8) * 2) = h;", _GEMM)
    _src("*reinterpret_cast<float2*>(st + wn_stage_off(r, c / 4) + (c % 4) * 4) = make_float2(a, b);",
         _GEMM)
    _src("const int rq = lane / 4, q = lane % 4;")
    _src("const int lr = wg * 64 + (warp % 4) * 16;")
    _src("const int i = ch * (WN_CHUNK / 8) + g;")
    _src("const float2 b = *reinterpret_cast<const float2*>(bias_s + 8 * i + 2 * q);")
    _src("const int c = 8 * (g - p * PER) + 2 * q;")
    _src("wn_stage(chunk, rq, c, v[g][0], v[g][1], (TOut*)nullptr);")
    _src("wn_stage(chunk, rq + 8, c, v[g][2], v[g][3], (TOut*)nullptr);")
    _src("wn_flush(chunk, C, m0 + lr, col0 + p * PER * 8, M, N, lane);")
    _src("wn_stage(chunk, rq, 8 * g + 2 * q, v[g][0], v[g][1], (fm_bf16*)nullptr);")
    _src("wn_flush(chunk, static_cast<fm_bf16*>(e.aux), m0 + lr, col0, M, N, lane);")
    _src("const int col0 = n0 + ch * WN_CHUNK;")


def _fragment(warp, lane, idx):
    """(row, column) in the 128 x 256 tile of accumulator ``idx`` of consumer
    thread (warp, lane): wgmma m64nNk16's fp32 D layout, warp w % 4 of
    warpgroup w // 4 holding rows 16 (w % 4) + lane / 4 (+ 8) of its 64."""
    i, e = divmod(idx, 4)
    row = (warp // 4) * 64 + (warp % 4) * 16 + lane // 4 + 8 * (e >> 1)
    return row, 8 * i + 2 * (lane % 4) + (e & 1)


@pytest.mark.parametrize("size", [2, 4], ids=["bf16 out and aux", "fp32 out"])
def test_every_output_is_stored_once_from_its_accumulator(size):
    per = 128 // size // 8          # fragment groups a staged 128-byte row holds
    elems = 16 // size              # elements of a lane's 16-byte store
    stored = {}
    for warp in range(8):
        lr = (warp // 4) * 64 + (warp % 4) * 16
        for ch in range(BN // CHUNK):
            for p in range(CHUNK // 8 // per):
                buf = {}
                for lane in range(32):                    # the fragment pairs
                    rq, q = divmod(lane, 4)
                    for g in range(p * per, (p + 1) * per):
                        i, c = ch * (CHUNK // 8) + g, 8 * (g - p * per) + 2 * q
                        for r, x0 in ((rq, 0), (rq + 8, 2)):
                            for x in (0, 1):
                                at = _stage_off(r, (c + x) // elems) + (c + x) % elems * size
                                assert at not in buf
                                buf[at] = (warp, lane, 4 * i + x0 + x)
                assert sorted(buf) == list(range(0, 16 * 128, size))   # each element once
                for lane in range(32):                    # the rows' 16-byte stores
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
    # 8 lanes store one row's 128 bytes: full lines.
    assert 8 * 16 == 128


def _wavefronts(addrs, width):
    """Shared-memory wavefronts of one warp access of ``width`` bytes a lane:
    distinct words grouped by bank; a wavefront serves one word a bank."""
    per_bank = {}
    for a in set(addrs):
        for b in range(a // 4, a // 4 + width // 4):
            per_bank.setdefault(b % 32, set()).add(a)
    return max(len(v) for v in per_bank.values())


def test_staging_accesses_take_the_fewest_wavefronts():
    for g in range(8):
        for h in range(2):
            # bf16 pairs (4 bytes a lane, 128 bytes a warp): one wavefront.
            addrs = [_stage_off(lane // 4 + 8 * h, g) + 4 * (lane % 4) for lane in range(32)]
            assert len(set(addrs)) == 32 and _wavefronts(addrs, 4) == 1
            if g < 4:   # fp32 pairs (8 bytes, 256 bytes): two
                addrs = [_stage_off(lane // 4 + 8 * h, 2 * g + (lane % 4) // 2) + 8 * (lane % 2)
                         for lane in range(32)]
                assert len(set(addrs)) == 32 and _wavefronts(addrs, 8) == 2
    for j in range(4):  # the rows' 16-byte reads (512 bytes): four
        addrs = [_stage_off(lane // 8 + 4 * j, lane % 8) for lane in range(32)]
        assert len(set(addrs)) == 32 and _wavefronts(addrs, 16) == 4
    # Without the swizzle a warp's bf16 pairs (8 rows, one word each) share 4 banks.
    plain = [(lane // 4) * 128 + 4 * (lane % 4) for lane in range(32)]
    assert _wavefronts(plain, 4) == 8


# ---- the dropout keep bits ----------------------------------------------------------

def _keep_words(drop, m0, n0, m, n):
    """The tile's mask at (m0, n0) as the mask warps draw it: word w holds
    row m0 + w // 8, columns n0 + 32 (w % 8) + b at bit b, 1 where dropout
    keeps the element (0 for a row past M); 8 counters of 4 columns a word
    where N % 4 == 0, one flat index a bit otherwise.  [1024] int64."""
    w = torch.arange(BM * BN // 32)
    row = m0 + w // (BN // 32)
    base = row * n + n0 + 32 * (w % (BN // 32))
    if n % 4 == 0:     # counter base / 4 + h holds columns 4 h .. 4 h + 3
        q = (base // 4)[:, None] + torch.arange(8)
        k0, k1 = drop.seed & 0xFFFFFFFF, drop.seed >> 32
        words = rng.philox4x32(q & 0xFFFFFFFF, q >> 32, torch.full_like(q, drop.stream),
                               torch.zeros_like(q), k0, k1)
        bits = torch.stack(words, dim=2).reshape(len(w), 32)      # bit 4 h + e
    else:              # element by element at flat index base + b
        flat = rng.random_bits(drop.seed, drop.stream, int(base.max()) + 32)
        bits = flat[base[:, None] + torch.arange(32)]
    keep = (bits < drop.threshold).long() << torch.arange(32)
    return torch.where(row < m, keep.sum(dim=1), 0)


def test_keep_bits_are_the_source():
    _src("const unsigned long long base = (unsigned long long)row * N + col0;", _GEMM)
    _src("const uint4 r = fm::random_words(d.seed, d.stream, (base >> 2) + h);", _GEMM)
    _src("w |= ((uint32_t)(r.x < d.threshold) | (uint32_t)(r.y < d.threshold) << 1 |\n"
         "            (uint32_t)(r.z < d.threshold) << 2 | (uint32_t)(r.w < d.threshold) << 3)\n"
         "           << (4 * h);", _GEMM)
    _src("w |= (uint32_t)(fm::random_bits(d.seed, d.stream, base + b) < d.threshold) << b;",
         _GEMM)
    _src("for (int x = mt; x < WN_MASK / 8; x += WN_MASK_THREADS) {")
    _src("const int w = x / 64 * 128 + x % 64;")
    _src("bits[w] = keep_word(e.drop, m0 + w / (WN_BN / 32), n0 + 32 * (w % (WN_BN / 32)), M,\n"
         "                              N);")
    _src("(lr + 8 + rq) * (WN_BN / 32);")
    _src("mine[q + 4 * u] = keep_word(e.drop, m0 + lr + 8 + rq, n0 + 32 * (q + 4 * u), M, N);")
    _src("keep + (lr + rq + 8 * h) * (WN_BN / 8) + ch * (WN_CHUNK / 8));")
    _src("t = (kb[x >> 1] >> (8 * g + 2 * q + (x & 1))) & 1ull ? t * e.drop.inv_keep : 0.0f;")


def test_mask_warps_and_consumers_draw_each_word_once():
    # The mask warps draw rows 0-7 of each consumer warp's 16 a tile ahead
    # (word x % 64 of block x // 64); consumer warp b's lane (rq, q) draws
    # words q and q + 4 of row 16 b + 8 + rq itself, under its last slices.
    words = [x // 64 * 128 + x % 64 for mt in range(NT["mask_threads"])
             for x in range(mt, NT["mask"] // 8, NT["mask_threads"])]
    assert all((w // 8) % 16 < 8 for w in words)
    for warp in range(8):
        lr = (warp // 4) * 64 + (warp % 4) * 16
        for lane in range(32):
            rq, q = divmod(lane, 4)
            words += [(lr + 8 + rq) * (BN // 32) + q + 4 * u for u in range(2)]
    assert sorted(words) == list(range(NT["mask"] // 4))
    # Each consumer warp reads only its own 16 rows' bytes, so its own words
    # need no more than a __syncwarp; the mask warps' need mfull.
    _src("keep + (lr + rq + 8 * h) * (WN_BN / 8) + ch * (WN_CHUNK / 8));")
    _src("__syncwarp();  // the warp's own words")


@pytest.mark.parametrize("m,n", [(300, 520), (200, 196), (150, 198)],
                         ids=["N%8==0", "N%4==0", "ragged N"])
def test_keep_bits_are_the_plain_mask(m, n):
    # The model of the mask warps and of the consumers' reads, tile by tile,
    # gives utils.rng.dropout_mask's keep mask element for element.
    drop = rng.Dropout.make(1234567, 3, 0.1)
    want = rng.dropout_mask(drop.seed, drop.stream, (m, n), 0.1)
    got = torch.full((m, n), -1, dtype=torch.int64)
    # Consumer thread (warp, lane), pass ch, row half h: the 8 bytes of the
    # mask it reads, and the 16 elements (group g, pair x) its bits gate.
    warp, lane, ch, h = torch.meshgrid(torch.arange(8), torch.arange(32),
                                       torch.arange(BN // CHUNK), torch.arange(2), indexing="ij")
    lrow = (warp // 4) * 64 + (warp % 4) * 16 + lane // 4 + 8 * h
    first = lrow * (BN // 8) + ch * (CHUNK // 8)
    tiles_n = -(-n // BN)
    for t in range(-(-m // BM) * tiles_n):
        m0, n0 = t // tiles_n * BM, t % tiles_n * BN
        words = _keep_words(drop, m0, n0, m, n)
        mask = torch.stack([(words >> (8 * i)) & 0xFF for i in range(4)], dim=1).reshape(-1)
        kb = sum(mask[first + b] << (8 * b) for b in range(8))      # the little-endian read
        for g in range(CHUNK // 8):
            for x in range(2):
                row = m0 + lrow
                col = n0 + ch * CHUNK + 8 * g + 2 * (lane % 4) + x
                ok = (row < m) & (col < n)
                assert (got[row[ok], col[ok]] == -1).all()          # each element once
                got[row[ok], col[ok]] = (kb[ok] >> (8 * g + 2 * (lane[ok] % 4) + x)) & 1
    assert (got >= 0).all()
    assert torch.equal(got.bool(), want)
    assert 0.85 < want.float().mean().item() < 0.95
