#!/usr/bin/env python3
"""Time the bf16 GEMMs and the flash kernels of several source trees, in turns.

    python3 compare_kernels.py TREE [TREE ...]      # needs one CUDA card

Each TREE is a directory holding a copy of ``fairmultimodal_torch/`` and
``chip_smoke.py`` (the parent commit unpacked with ``git archive``, or a
variant of a kernel source) inside a directory that ``.gitignore`` lists, such
as ``build/var/<name>``.  The trees run in the order given, each in its own
process, which builds its kernels into ``TREE/build/kernels`` and prints: what
``-Xptxas -v`` says of the two kernels, the "nt" GEMM at the lab stages (QKV,
W1 with relu + inner dropout + aux, W1 plain, W2) checked against its fp32
epilogue and timed beside ``F.linear``; the backward's "nn" dx (R 143360, K
2304) and "tn" dWqkv (2304 x 768 over 143360 rows, split-K with its
fixed-order sum) checked against fp32 and timed beside ``torch.matmul``; and
the flash forward and backward at the lab (B 256, S 560, 8 x 96) and text
(B 32, S 512, 12 x 64) shapes, checked against their plain versions and timed
(CUDA-event medians of 20).  Only entry points every tree has are called.
Give a tree twice (A B A B) to see the spread between repeats.  Lines start
with GEMM, BWDGEMM, FLASH or FLASHERR.
"""

import os
import subprocess
import sys

_RUN = r'''
import json, torch, chip_smoke as c
from fairmultimodal_torch.ops import _build, flash_attention as flash
from fairmultimodal_torch.ops import fused_attention_block as fab
torch.backends.cuda.matmul.allow_tf32 = False
print(json.dumps(c.ptxas_report(_build)), flush=True)
gen = torch.Generator(device="cuda").manual_seed(5)
for stage in (("qkv lab", c.R_LAB, 2304, 768, "none", 0.0, False, False, True),
              ("w1 lab relu dropout aux", c.R_LAB, 2048, 768, "relu", 0.1, True, False, True),
              ("w1 lab plain", c.R_LAB, 2048, 768, "none", 0.0, False, False, True),
              ("w2 lab", c.R_LAB, 768, 2048, "none", 0.0, False, False, True)):
    row = c.nt_gemm_check(_build, gen, *stage)
    print("GEMM", json.dumps({k: row[k] for k in ("stage", "ms", "tflops", "library_ms")}),
          flush=True)
bf = torch.bfloat16
R = 256 * 560
for name, layout, M, N, K in (("dx nn", "nn", R, 768, 2304), ("dWqkv tn", "tn", 2304, 768, R)):
    a = torch.randn(*((M, K) if layout == "nn" else (K, M)), generator=gen, device="cuda").to(bf)
    b = (torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5).to(bf)
    out = torch.empty(M, N, device="cuda", dtype=bf)
    run = (lambda: _build.gemm(a, b, out, layout="nn")) if layout == "nn" else \
        (lambda: fab.weight_grad(a, b, out))
    lib = (lambda: torch.matmul(a, b)) if layout == "nn" else (lambda: torch.matmul(a.t(), b))
    run()
    want = a.float() @ b.float() if layout == "nn" else a.float().t() @ b.float()
    err = ((out.float() - want).abs().max() / want.abs().max()).item()
    ms, lib_ms = c.time_ms(run, reps=20), c.time_ms(lib, reps=20)
    print("BWDGEMM", json.dumps({"stage": name, "rel_err": err, "ms": ms,
                                 "tflops": 2 * M * N * K / ms / 1e9, "library_ms": lib_ms}),
          flush=True)
    del a, b, out, want
    torch.cuda.empty_cache()
gen = torch.Generator(device="cuda").manual_seed(4)
for kw in (dict(B=256, S=560, nh=8, d=96, mask_kind="lab"), dict(B=32, S=512, nh=12, d=64)):
    row = c.flash_check(flash, gen, bf, **kw)
    print("FLASHERR", kw, {n: e["max_abs_err"] / e["max_abs"] for n, e in row["errors"].items()})
    _, q, k, v, mask, g = c._flash_inputs(kw["B"], kw["S"], kw["nh"], kw["d"], "dense",
                                          kw.get("mask_kind", "rows"), bf, gen)
    with torch.no_grad():
        q, k, v = (t.detach() for t in (q, k, v))
        ops = flash._operands(q, k, v, mask)
        o, stats = flash._forward_kernel(*ops, residuals=True)
        saved = (*ops[:3], o, stats, ops[3])
        print("FLASH", kw, c.time_ms(lambda: flash.flash_attention(q, k, v, mask), reps=20),
              "bwd", c.time_ms(lambda: flash._backward_kernel(*saved, g), reps=20), flush=True)
    del q, k, v, o, stats, saved, g
    torch.cuda.empty_cache()
'''


def main(args) -> int:
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in args:
        print(f"==== {tree}", flush=True)
        rc |= subprocess.run([sys.executable, "-c", _RUN], cwd=os.path.abspath(tree)).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
