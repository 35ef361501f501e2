"""Split-K of the weight-grad GEMMs, per io dtype, on the CPU.

``fused_attention_block.weight_grad`` runs every "tn" product (dWqkv, dWo,
dW1, dW2) as K splits of fp32 partials that ``fm_colsum`` adds in a fixed
order.  The split count is sized from a tile and a residency
(``_build.GEMM_SCHEDULE``): the bf16 "nn" / "tn" kernel's 128 x 256 tile at one
block per SM; for fp32 the 128 x 128 tile at two blocks per SM of the
cp.async kernel that ran "nn" / "tn" before the persistent one, whose counts
and 16-row split boundaries the persistent kernel keeps, so a weight grad is
the same bits; each split sums ``_build.split_rows`` rows (a multiple of the
K step, 64 or 16; at least 2048 or 512).  Every fp32 product runs a 128 x 64
tile on a persistent kernel ("nt" its own, tests/test_torch_sgemm_nt_f32.py;
"nn" / "tn" tests/test_torch_sgemm_nn_tn_f32.py), so no narrower tile
shortens a wave tail.  At batch 16 the fp32 weight
grads take 7-8 splits of 1120-1280 rows where the bf16 ones take 2-4.  The
tests pin both at the lab (B 256 x S 560), text (B 32 x S 512, FFN 3072) and
baseline (B 16 x S 560) shapes on a 132-SM H100, and hold the Python
constants against ``gemm.cu``.
"""

import re
from pathlib import Path

import pytest
import torch

from fairmultimodal_torch.ops import _build
from fairmultimodal_torch.ops import fused_attention_block as t_fab

_GEMM = (Path(__file__).resolve().parents[1] / "fairmultimodal_torch" / "ops" / "csrc"
         / "gemm.cu").read_text()
BF, F32 = torch.bfloat16, torch.float32
LAB, TEXT, BASE = 256 * 560, 32 * 512, 16 * 560

# shape, weight grad, M, N, rows K, {dtype: (splits, rows per split)}
CASES = [
    ("lab", "dWqkv", 2304, 768, LAB, {BF: (7, 20480), F32: (7, 20480)}),
    ("lab", "dWo", 768, 768, LAB, {BF: (7, 20480), F32: (7, 20480)}),
    ("lab", "dW1", 2048, 768, LAB, {BF: (8, 17920), F32: (8, 17920)}),
    ("lab", "dW2", 768, 2048, LAB, {BF: (8, 17920), F32: (8, 17920)}),
    ("text", "dWqkv", 2304, 768, TEXT, {BF: (7, 2368), F32: (7, 2352)}),
    ("text", "dW1", 3072, 768, TEXT, {BF: (5, 3328), F32: (5, 3280)}),
    ("text", "dW2", 768, 3072, TEXT, {BF: (5, 3328), F32: (5, 3280)}),
    ("baseline", "dWqkv", 2304, 768, BASE, {BF: (2, 4480), F32: (7, 1280)}),
    ("baseline", "dWo", 768, 768, BASE, {BF: (4, 2240), F32: (7, 1280)}),
    ("baseline", "dW1", 2048, 768, BASE, {BF: (2, 4480), F32: (8, 1120)}),
    ("baseline", "dW2", 768, 2048, BASE, {BF: (2, 4480), F32: (8, 1120)}),
]


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _GEMM).group(1))


@pytest.mark.parametrize("dtype", [BF, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape,grad,m,n,k,want", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_split_count_and_rows_per_split(shape, grad, m, n, k, want, dtype):
    splits = t_fab._splits(m, n, k, 132, dtype)
    rows = _build.split_rows(k, splits, dtype)
    assert (splits, rows) == want[dtype]
    (tile_m, tile_n), per_sm, step, least = _build.GEMM_SCHEDULE[dtype]
    tiles = -(-m // tile_m) * -(-n // tile_n)
    # At most three waves of blocks, at least 2048 (bf16) or 512 (fp32) rows a
    # split, every split non-empty and the K step respected.
    assert tiles * splits <= 3 * 132 * per_sm
    assert splits == 1 or k // splits >= least
    assert rows % step == 0 and (splits - 1) * rows < k <= splits * rows


def test_bf16_default_keeps_the_wgmma_count():
    for _, _, m, n, k, want in CASES:
        assert t_fab._splits(m, n, k, 132) == want[BF][0]


def test_schedule_matches_the_kernel_source():
    assert _build.SGEMM_TILE == (_const("MN_BM"), _const("MN_BN"))
    assert _build.WGMMA_TILE == (_const("WG_BM"), _const("WG_BN"))
    # fp32 keeps the cp.async kernel's split model: 128 x 128 tiles, two blocks
    # an SM, splits on 16-row boundaries (MN_KSTEP), whatever tile runs them.
    assert _build.GEMM_SCHEDULE[F32][:3] == ((128, 128), 2, _const("MN_KSTEP"))
    assert _build.GEMM_SCHEDULE[BF][:3] == (_build.WGMMA_TILE, 1, _const("WG_BK"))
    assert re.search(r"__launch_bounds__\(MN_THREADS, 1\)\s*gemm_f32_nn_tn_kernel", _GEMM)
    assert re.search(r"__launch_bounds__\(WG_THREADS, 1\)\s*gemm_bf16_nn_tn_kernel", _GEMM)
    # Both launches size a split the way split_rows does.
    assert "((K + splits - 1) / splits + MN_KSTEP - 1) / MN_KSTEP * MN_KSTEP" in _GEMM
    assert "((K + splits - 1) / splits + WG_BK - 1) / WG_BK * WG_BK" in _GEMM


@pytest.mark.parametrize("dtype", [BF, F32], ids=["bf16", "fp32"])
def test_a_card_with_fewer_sms_gets_its_own_count(dtype):
    # 114 SMs (an H100 PCIe): the fp32 kernel's 228 slots take dWqkv's 108
    # tiles in 2 splits of 71680 rows, the wgmma kernel's 114 its 54 tiles too.
    assert t_fab._splits(2304, 768, LAB, 114, dtype) == 2
    assert _build.split_rows(LAB, 2, dtype) == 71680


# layout, M, N, splits, SMs, the tile that runs: every fp32 layout's 128 x 64
TILES = [
    ("nt", BASE, 768, 1, 132, (128, 64)),        # Wo, W2 at batch 16: the "nt" kernel's
    ("nn", BASE, 768, 1, 132, (128, 64)),        # dO, both N-768 dx
    ("nt", BASE, 2304, 1, 132, (128, 64)),       # QKV: every "nt" shape takes that tile
    ("nt", BASE, 2048, 1, 132, (128, 64)),       # W1
    ("nt", TEXT, 768, 1, 132, (128, 64)),
    ("nt", LAB, 768, 1, 132, (128, 64)),
    ("nn", 600, 200, 1, 132, (128, 64)),         # one round: 20 units on 20 SMs
    ("tn", 768, 768, 1, 132, (128, 64)),         # the weight grads: the "nn" / "tn" kernel's
    ("nt", BASE, 768, 2, 132, (128, 64)),
    ("nt", BASE, 768, 1, 114, (128, 64)),
    ("nn", BASE, 2048, 1, 132, (128, 64)),       # "nn" dh: N > 768
    ("nn", TEXT, 768, 1, 132, (128, 64)),
    ("nn", BASE, 768, 2, 132, (128, 64)),
    ("nn", BASE, 768, 1, 114, (128, 64)),
]


@pytest.mark.parametrize("layout,m,n,splits,sms,tile", TILES,
                         ids=[f"{t[0]}-M{t[1]}-N{t[2]}-s{t[3]}-sm{t[4]}" for t in TILES])
def test_narrow_tile_where_its_wave_tail_is_shorter(layout, m, n, splits, sms, tile):
    # No narrow tile any more: both fp32 kernels are persistent, so the busiest
    # SM's work (units on it x tile width) is never more than the 128 x 128
    # tile's that ran "nn" / "tn" before, at any shape.
    assert _build.sgemm_tile(layout, m, n, splits, sms) == tile
    if layout == "nt":
        assert tile == _build.SGEMM_NT["tile"]
        per_sm = _build.sgemm_nt_schedule(m, n, sms)[2]
    else:
        assert tile == _build.SGEMM_TILE
        per_sm = _build.sgemm_nn_tn_schedule(m, n, splits, sms)[2]
    mt = -(-m // 128)
    assert per_sm * tile[1] <= -(-mt * -(-n // 128) * (splits if layout != "nt" else 1)
                                  // sms) * 128


def test_persistent_schedule_matches_the_kernel_source():
    # The narrow tile and its rule are gone with the cp.async kernel; "nn" and
    # "tn" launch the persistent kernel, one block per SM over the units.
    for gone in ("BN_NARROW", "sgemm_narrow", "gemm_f32_kernel<", "launch_f32_tile"):
        assert gone not in _GEMM
    assert not hasattr(_build, "SGEMM_NARROW_TILE")
    assert "const long long units = (long long)((M + MN_BM - 1) / MN_BM) * ((N + MN_BN - 1) / " \
        "MN_BN) * splits;" in _GEMM
    assert "const int grid = units < sms ? (int)units : sms;" in _GEMM
    assert "for (int u = first; u < units; u += step)" in _GEMM
