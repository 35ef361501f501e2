#!/usr/bin/env python3
"""Time the bf16 GEMMs and the flash kernels of several source trees, in turns.

    python3 compare_kernels.py TREE [TREE ...]      # needs one CUDA card

Each TREE is a directory holding a copy of ``fairmultimodal_torch/`` and
``chip_smoke.py`` (the parent commit unpacked with ``git archive``, or a
variant of a kernel source) inside a directory that ``.gitignore`` lists, such
as ``build/var/<name>``.  The trees run in the order given, each in its own
process, which builds its kernels into ``TREE/build/kernels`` and prints: what
``-Xptxas -v`` says of the bf16 GEMM and flash kernels, the "nt" GEMM at the
lab stages (QKV, Wo, W1 with relu + inner dropout + aux, W1 plain, W2), at
batch 16 (R 8784: QKV, W1 with relu + dropout + aux, W2 into fp32) and at
the note encoder's S 512 (QKV, W1 with gelu + aux, W2), each checked against
its fp32 epilogue and timed with its TFLOP/s beside ``F.linear``; every
backward "nn" / "tn" stage at the lab (R 143360) and batch-16 (R 8960)
shapes with the epilogue its path gives it (dO, dx + residual, the relu-gated
dh with its column partials, the split-K weight grads with their fixed-order
sum) and the text encoder's dgelu-gated dh, checked against fp32 and timed
beside ``torch.matmul`` (BWDGEMM); and
the flash forward and backward at the lab (B 256, S 560, 8 x 96) and text
(B 32, S 512, 12 x 64) shapes, checked against their plain versions and timed
(CUDA-event medians of 20, the kernels' device time from the profiler, the host
time of a forward call) beside SDPA with the -1e9 bias and its autograd
backward; a hash of each bf16 GEMM layout's output on fixed inputs and of
each "nn" / "tn" epilogue (relu and dgelu gates with aux and column partials,
the residual, a split-K weight grad) at R 8784 (GEMMBITS: equal hashes,
equal bits); #2 (serving, and the training forward with
dropout) and #7 at the lab (R 143360), batch-16 (R 8784) and text (R 16384,
F 3072 gelu) shapes beside one library composition each, #2 with its
stages (FFN); #4 at the lab and batch-16 (R 8960) shapes and #8 at the lab
shape with their stages, plain and library times (BWD); #1 (no residuals)
at the lab (B 256 and 16) and text (B 32 x S 512, B 64 x S 256, 12 x 64) shapes, #3 (forward with
residuals and backward, dropout 0.1) and #5 / #6 at the lab shape (B 256 and
16) and #5 / #6 at the text shape (B 32 x S 512), each beside its library
composition (ATTN); and the bf16 FAME train step at batch 256 (phase 5's
model and batch: CUDA-event median of 20, then the profiler's busy / idle
split and the device time of every kernel by name over 3 steps, with the
"nt" GEMMs' device time a step by output dtype and the "nn" / "tn" GEMMs' by
mode (store, gate, residual; "tn"), whichever kernel ran them: STEP).  Only
entry points every tree has are called (the parent of the persistent bf16
"nt" kernel has them all), so a tree and its parent run in
turns.  Give a tree twice (A B A B) to see the spread between repeats.  Lines
start with GEMM, BWDGEMM, GEMMBITS, FLASH, FLASHERR, FFN, ATTN, BWD or STEP.

    python3 compare_kernels.py --fp32 [--steps] TREE [TREE ...]

times the fp32 path instead, at the pipelines' batch 16 (B 16 x S 560, 8 x
96, FFN 2048): what ``-Xptxas -v`` says of the fp32 GEMM and flash backward
kernels; a hash of the fp32 flash backward's dq, dk, dv, column partials and
row term D on fixed inputs at the lab shape (B 16 x S 560, 8 x 96, the lab
mask with one fully masked row), the tensor-parallel shard (4 heads) and d 64
(B 4 x S 512 x 12, per-row masks), through ``_build.flash_attention_bwd``
(FLASHBITS: equal hashes, equal bits); each fp32 GEMM stage ("nt" QKV / Wo /
W1 with relu, inner dropout and aux / W2, the text encoder's W1 with gelu and
aux / W2 at 8 x 512, the tensor-parallel W1 / W2 at F 1024 and 06's at R 8784
x 256 x 512;
every "nn" / "tn" stage with its epilogue: dO, dx + resid, the relu-gated dh
with its column partials and the four split-K weight grads at B 16, 06's and
the tensor-parallel FFN's, each with its schedule) against float64 on the
card, reruns bit for bit, and beside ``F.linear`` / ``torch.matmul`` with
TF32 off (F32GEMM); #2 and #7's fp32 forwards at B 16 with their residuals
beside one library composition each (F32FFN); the fp32 flash backward checked
against its plain version and timed, its dQ and dK / dV kernels apart from
the profiler (F32FLASH); the fp32 flash forward at the lab (B 16, S 560, 8 x
96) and text (B 32, S 512, 12 x 64) shapes beside SDPA, and #1's four forward
stages at B 16 beside F.linear / SDPA / F.linear / dropout + add +
F.layer_norm (F32FLASHFWD); and #3 / #4 (the LN-fused backwards) with their
stages, plain and library times (F32BWD).  With ``--steps`` also FAME's
default train step (``FAMETrainer.train_step`` at the reference geometry,
fp32, batch 16, dropout 0.1) and the 01 fp32 step, each a CUDA-event median
of 20 and profiled (STEP; FAME's step also by every kernel's full name and
the fp32 GEMMs' device time by layout, STEPGEMM), after phase 8's fp32 rows
of #1-#10 at B 16 (ROWS: ms, plain, library).  It calls only entry points the parent commit of
the fp32 redesign has too.

    python3 compare_kernels.py --steps-only TREE [TREE ...]

runs only the two STEP measurements, one process per tree: give the trees in
turns (A B B A A B ...) to read the host-bound FAME step's spread.

    python3 compare_kernels.py --host TREE [TREE ...]

times what the host pays to drive the kernels, through public entry points
every tree has: the bits of each launch that draws dropout (the "nt" W1
epilogue, the add + LayerNorm row kernel and its backward, bf16 and fp32;
DROPBITS: equal hashes, equal masks and values) and GEMMBITS; the host microseconds of one
wrapper call from an idle card (median of 40) for each kernel pair at FAME's
default lab layer (fp32, B 16 x S 560), its forward with grad on and its
backward, and the text encoder's no-grad forwards (HOSTUS); and FAME's eager
train step in fp32 at batch 16 and in bf16 at batch 256, each a CUDA-event
median of 20 with the profiler's busy / idle split (STEP).

    python3 compare_kernels.py --steps-host TREE [TREE ...]

runs only those two steps, one short process per tree (give many trees in
turns, A B B A B A A B ...: the host's speed differs from process to
process): each step's CUDA-event median of 20 as ``time_train_step`` takes
it, the host time of one forward + backward from an idle card with the
dynamic weights already on the card (median of 15), and how many
synchronising CUDA calls one ``train_step`` makes (torch's sync debug mode;
STEPSHOST).

    python3 compare_kernels.py --ln TREE [TREE ...]

measures the LayerNorm backward (``layernorm_bwd``) and the fixed-order column
sums (``colsum``) alone: what ``-Xptxas -v`` says of both kernels; the bits of
dz, da and the [3, ceil(R / 64), H] partials at R 4480, a ragged 4496 and the
lab 143360, with dz in the io dtype, dropout on and off, H 256 / 768 / 1024
(LNBITS), and of every column sum: each partials plane alone and, where the
tree takes planes, all three in one launch (which must give the same bits),
and the split-K and tall sums at M 1-2304 with -0 entries (COLSUMBITS); each
kernel's CUDA-event median at the shapes the main path gives it (bf16 lab R
143360, the glue's dz in the io dtype, batch 16 R 8960 in bf16 and fp32, 06's
R 8784 x 256) and its device time (profiler) beside its bound (bytes at 3.35
TB/s) and one library composition (aten's LayerNorm backward from the saved
mean / rstd + the dropout backward + ``sum(0)``; ``x.sum(0)``; LNROW,
COLSUMROW); the forward add + LayerNorm and the unfolded path's per-128-row
column partials the same way at the bf16 lab and fp32 batch-16 shapes
(ADDLNROW, ROWSUMROW); and both FAME steps (fp32 B 16, bf16 B 256) by the
profiler: the device time and launches a step of the LayerNorm backward, the
column sums, the add + LayerNorm and every kernel (LNSTEP). The bf16 mode
prints the bf16 LNROW / COLSUMROW lines too, ``--fp32`` the fp32 ones, and
``--host`` LNBITS / COLSUMBITS after DROPBITS.
"""

import os
import subprocess
import sys

_GEMMBITS = r'''
# Bits of every bf16 GEMM layout on fixed inputs, and of each "nn" / "tn"
# epilogue at a ragged batch-16 shape (the outputs, aux and column partials).
import hashlib
gen = torch.Generator(device="cuda").manual_seed(9)
bf = torch.bfloat16
bits = {}
for layout, (M, N, K) in (("nt", (4096, 2304, 768)), ("nn", (4096, 768, 2304)),
                          ("tn", (2304, 768, 4096))):
    a = torch.randn(*((K, M) if layout == "tn" else (M, K)), generator=gen, device="cuda").to(bf)
    b = torch.randn(*((N, K) if layout == "nt" else (K, N)), generator=gen, device="cuda").to(bf)
    out = torch.empty(M, N, device="cuda", dtype=bf)
    _build.gemm(a, b, out, layout=layout)
    bits[layout] = hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
M, K = 16 * 549, 768
for name, N, gate_kind in (("nn relu gate", 2048, "relu"), ("nn dgelu gate", 3072, "dgelu"),
                           ("nn resid", 768, None), ("tn split-K", 768, None)):
    a = torch.randn(M, K, generator=gen, device="cuda").to(bf)
    b = (torch.randn(K if name != "tn split-K" else M, N, generator=gen, device="cuda")
         * K ** -0.5).to(bf)
    out = torch.empty(M if name != "tn split-K" else K, N, device="cuda", dtype=bf)
    extra = []
    if name == "tn split-K":
        fab.weight_grad(a, b, out)
    else:
        gate = torch.randn(M, N, generator=gen, device="cuda").to(bf) if gate_kind else None
        resid = None if gate_kind else torch.randn(M, N, generator=gen, device="cuda")
        aux = torch.empty_like(gate) if gate_kind == "dgelu" else None
        colpart = torch.empty(-(-M // 128), N, device="cuda") if gate_kind else None
        _build.gemm(a, b, out, layout="nn", gate=gate, gate_kind=gate_kind,
                    gate_scale=1 / 0.9 if gate_kind == "relu" else 1.0, aux=aux, resid=resid,
                    colpart=colpart)
        extra = [t for t in (aux, colpart) if t is not None]
    h = hashlib.sha256()
    for t in (out, *extra):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    bits[name] = h.hexdigest()[:16]
print("GEMMBITS", json.dumps(bits), flush=True)
del a, b, out, extra
torch.cuda.empty_cache()
'''


_LNBITS = r"""
# Bits of the LayerNorm backward (dz, da, the [3, ceil(R / 64), H] partials)
# and of the fixed-order column sums, on fixed inputs: ragged and whole
# 64-row units, the lab R, dz in the io dtype, dropout on and off (LNBITS);
# each partials plane and a split-K sum at M <= 8 with -0 entries, through
# the one-plane entry every tree has, and through the planes entry where the
# tree has one, which must give the same bits (COLSUMBITS).
import hashlib, inspect
def _digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]
from fairmultimodal_torch.utils.rng import Dropout as _Drop
lnbits, csbits, planes = {}, {}, {}
_planes_api = any(p.kind == p.VAR_POSITIONAL
                  for p in inspect.signature(_build.colsum).parameters.values())
gen = torch.Generator(device="cuda").manual_seed(31)
for dt, R, H, dz_io, rate in ((torch.bfloat16, 4480, 768, False, 0.1),
                              (torch.bfloat16, 4496, 768, False, 0.1),
                              (torch.bfloat16, 4496, 768, True, 0.1),
                              (torch.bfloat16, 4496, 768, False, 0.0),
                              (torch.bfloat16, 143360, 768, False, 0.1),
                              (torch.bfloat16, 4496, 1024, False, 0.1),
                              (torch.float32, 4480, 768, False, 0.1),
                              (torch.float32, 4496, 768, False, 0.1),
                              (torch.float32, 4496, 768, True, 0.1),
                              (torch.float32, 8784, 256, False, 0.1)):
    name = f"{str(dt)[6:]} R{R} H{H}{' dz io' if dz_io else ''} rate {rate}"
    g = torch.randn(R, H, generator=gen, device="cuda").to(dt)
    z = (torch.randn(R, H, generator=gen, device="cuda") * 2 + 0.5).to(dt)
    gamma = 1 + 0.1 * torch.randn(H, generator=gen, device="cuda")
    dz = torch.empty(R, H, device="cuda", dtype=dt if dz_io else torch.float32)
    da = torch.empty(R, H, device="cuda", dtype=dt)
    part = torch.empty(3, -(-R // _build.LN_BWD_ROWS), H, device="cuda")
    drop = _Drop.make(key_of(55555 | 7 << 32, "cuda"), 1, rate)
    _build.layernorm_bwd(g, z, gamma, dz, da, part, 1e-5, drop)
    lnbits[name] = _digest(dz, da, part)
    outs = [torch.empty(H, device="cuda", dtype=o) for o in (torch.float32, torch.float32, dt)]
    for i in range(3):
        _build.colsum(part[i], outs[i])
    csbits[name] = _digest(*outs)
    if _planes_api:
        alt = [torch.empty_like(o) for o in outs]
        _build.colsum(part, *alt)
        planes[name] = all(torch.equal(a.view(torch.uint8), o.view(torch.uint8))
                           for a, o in zip(alt, outs))
    del g, z, dz, da, part
for M, N in ((1, 4096), (3, 4096), (7, 589824), (8, 589824), (13, 1769472), (22, 589824),
             (140, 768), (2304, 2304), (1120, 2048)):
    x = torch.randn(M, N, generator=gen, device="cuda")
    x[:, ::5] = -0.0
    x[0, 1::7] = -x[-1, 1::7] if M > 1 else x[0, 1::7]
    out = torch.empty(N, device="cuda")
    _build.colsum(x, out)
    outb = torch.empty(N, device="cuda", dtype=torch.bfloat16)
    _build.colsum(x, outb)
    csbits[f"M{M} N{N}"] = _digest(out, outb)
    del x, out, outb
print("LNBITS", json.dumps(lnbits), flush=True)
print("COLSUMBITS", json.dumps({**csbits, "planes_equal_single": planes}), flush=True)
torch.cuda.empty_cache()
"""


# The LayerNorm backward and the fixed-order column sums alone, at the shapes
# the main path gives them (LN_DTYPES picks the io dtypes), each beside its
# bound (bytes at 3.35 TB/s) and one library composition (LNROW, COLSUMROW).
_LNROWS = r"""
import inspect
from fairmultimodal_torch.utils.rng import Dropout as _Drop, random_bits as _rbits
_planes_api = any(p.kind == p.VAR_POSITIONAL
                  for p in inspect.signature(_build.colsum).parameters.values())
gen = torch.Generator(device="cuda").manual_seed(32)
_aten = torch.ops.aten
def _dev_ms(fn, name):  # device ms a call of the kernels whose name holds name (profiler)
    return sum(v for k, v in c.device_kernels(fn, reps=10).items() if name in k)
for label, dt, R, H, dz_io in (("bf16 lab R143360 H768", torch.bfloat16, 143360, 768, False),
                               ("bf16 glue R143360 H768 dz io", torch.bfloat16, 143360, 768, True),
                               ("bf16 B16 R8960 H768", torch.bfloat16, 8960, 768, False),
                               ("fp32 B16 R8960 H768", torch.float32, 8960, 768, False),
                               ("fp32 glue B16 R8960 H768 dz io", torch.float32, 8960, 768, True),
                               ("fp32 06 R8784 H256", torch.float32, 8784, 256, False),
                               ("bf16 06 R8784 H256", torch.bfloat16, 8784, 256, False)):
    if str(dt)[6:].replace("float32", "fp32").replace("bfloat16", "bf16") not in LN_DTYPES:
        continue
    g = torch.randn(R, H, generator=gen, device="cuda").to(dt)
    z = torch.randn(R, H, generator=gen, device="cuda").to(dt)
    gamma = 1 + 0.1 * torch.randn(H, generator=gen, device="cuda")
    dz = torch.empty(R, H, device="cuda", dtype=dt if dz_io else torch.float32)
    da = torch.empty(R, H, device="cuda", dtype=dt)
    U = -(-R // _build.LN_BWD_ROWS)
    part = torch.empty(3, U, H, device="cuda")
    drop = _Drop.make(key_of(4321, "cuda"), 1, 0.1)
    run = lambda: _build.layernorm_bwd(g, z, gamma, dz, da, part, 1e-5, drop)  # noqa: E731
    es = g.element_size()
    nbytes = R * H * (2 * es + dz.element_size() + es) + 3 * U * H * 4 + H * 4
    # Library: aten's LayerNorm backward from the saved mean / rstd, with
    # gamma in the io dtype, then the dropout backward and the bias grad.
    _, mean, rstd = _aten.native_layer_norm(z, [H], gamma.to(dt), None, 1e-5)
    keep = (_rbits(4321, 1, R * H, "cuda") < drop.threshold).view(R, H)
    gdt = gamma.to(dt)
    def library():
        dx, dgm, dbt = _aten.native_layer_norm_backward(g, z, [H], mean, rstd, gdt, None,
                                                        [True, True, False])
        d = _aten.native_dropout_backward(dx, keep, drop.inv_keep)
        return d.sum(0)
    row = {"shape": label, "ms": c.time_ms(run, reps=20),
           "device_ms": _dev_ms(run, "layernorm_bwd"), "bound_ms": 1e3 * nbytes / c.HBM_RATE,
           "bytes": nbytes,
           "library_ms": c.time_ms(library, reps=20)}
    row["ratio_to_bound"] = row["ms"] / row["bound_ms"]
    print("LNROW", json.dumps(row), flush=True)
    run()
    outs = [torch.empty(H, device="cuda", dtype=o) for o in (torch.float32, torch.float32, dt)]
    cb = 3 * U * H * 4 + 2 * H * 4 + H * es
    three = lambda: [_build.colsum(part[i], outs[i]) for i in range(3)]  # noqa: E731
    crow = {"shape": label + " LN partials 3 x " + str(U) + " x " + str(H),
            "three_launches_ms": c.time_ms(three, reps=20),
            "three_launches_device_ms": _dev_ms(three, "colsum"),
            "bound_ms": 1e3 * cb / c.HBM_RATE, "library_ms": c.time_ms(lambda: part.sum(1),
                                                                       reps=20)}
    if _planes_api:
        crow["planes_ms"] = c.time_ms(lambda: _build.colsum(part, *outs), reps=20)
        crow["planes_device_ms"] = _dev_ms(lambda: _build.colsum(part, *outs), "colsum")
    print("COLSUMROW", json.dumps(crow), flush=True)
    del g, z, dz, da, part, keep, mean, rstd
    torch.cuda.empty_cache()
# The other column sums of the step: the flash backward's column partials
# (dbqkv), the gated "nn"'s (db1) and the split-K weight grads' partials.
sms = torch.cuda.get_device_properties(0).multi_processor_count
for label, dt, M, N in (("bf16 lab dbqkv colpart", torch.bfloat16, 256 * 9, 2304),
                        ("bf16 lab db1 colpart", torch.bfloat16, 1120, 2048),
                        ("bf16 lab dWo split-K", torch.bfloat16,
                         fab._splits(768, 768, 143360, sms, torch.bfloat16), 768 * 768),
                        ("bf16 lab dWqkv split-K", torch.bfloat16,
                         fab._splits(2304, 768, 143360, sms, torch.bfloat16), 2304 * 768),
                        ("bf16 lab dW1 split-K", torch.bfloat16,
                         fab._splits(2048, 768, 143360, sms, torch.bfloat16), 2048 * 768),
                        ("fp32 B16 dbqkv colpart", torch.float32, 16 * 9, 2304),
                        ("fp32 B16 db1 colpart", torch.float32, 70, 2048),
                        ("fp32 B16 dWo split-K", torch.float32,
                         fab._splits(768, 768, 8960, sms, torch.float32), 768 * 768),
                        ("fp32 B16 dWqkv split-K", torch.float32,
                         fab._splits(2304, 768, 8960, sms, torch.float32), 2304 * 768),
                        ("fp32 B16 dW1 split-K", torch.float32,
                         fab._splits(2048, 768, 8960, sms, torch.float32), 2048 * 768)):
    if label[:4] not in LN_DTYPES or M < 2:
        continue
    x = torch.randn(M, N, generator=gen, device="cuda")
    out = torch.empty(N, device="cuda", dtype=dt)
    cb = M * N * 4 + N * out.element_size()
    print("COLSUMROW", json.dumps({"shape": f"{label} {M} x {N}",
                                   "ms": c.time_ms(lambda: _build.colsum(x, out), reps=20),
                                   "device_ms": _dev_ms(lambda: _build.colsum(x, out), "colsum"),
                                   "bound_ms": 1e3 * cb / c.HBM_RATE,
                                   "library_ms": c.time_ms(lambda: x.sum(0), reps=20)}),
          flush=True)
    del x, out
# The other two row kernels: the forward add + LayerNorm (#1 / #2's epilogue,
# y the fp32 GEMM output, z stored) and the unfolded path's per-128-row column
# partials, each beside its bound and one library composition (ADDLNROW,
# ROWSUMROW).
for label, dt, R, H in (("bf16 lab R143360 H768", torch.bfloat16, 143360, 768),
                        ("fp32 B16 R8960 H768", torch.float32, 8960, 768)):
    if label[:4] not in LN_DTYPES:
        continue
    x = torch.randn(R, H, generator=gen, device="cuda").to(dt)
    y = torch.randn(R, H, generator=gen, device="cuda")
    gamma = 1 + 0.1 * torch.randn(H, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(H, generator=gen, device="cuda")
    out, z = torch.empty_like(x), torch.empty_like(x)
    drop = _Drop.make(key_of(4322, "cuda"), 1, 0.1)
    es = x.element_size()
    gdt, bdt = gamma.to(dt), beta.to(dt)
    def library():
        yd, _ = _aten.native_dropout(y, 0.1, True)
        return _aten.native_layer_norm(x + yd.to(dt), [H], gdt, bdt, 1e-5)
    fwd = lambda: _build.add_layernorm(x, y, gamma, beta, out, 1e-5, drop, z)  # noqa: E731
    print("ADDLNROW", json.dumps({
        "shape": label, "ms": c.time_ms(fwd, reps=20), "device_ms": _dev_ms(fwd, "add_layernorm"),
        "bound_ms": 1e3 * (R * H * (3 * es + 4) + 2 * H * 4) / c.HBM_RATE,
        "library_ms": c.time_ms(library, reps=20)}), flush=True)
    part = torch.empty(-(-R // _build.SUM_ROWS), H, device="cuda")
    sums = lambda: _build.row_block_sums(x, part)  # noqa: E731
    print("ROWSUMROW", json.dumps({
        "shape": label, "ms": c.time_ms(sums, reps=20),
        "device_ms": _dev_ms(sums, "row_block_sums"),
        "bound_ms": 1e3 * (R * H * es + part.numel() * 4) / c.HBM_RATE,
        "library_ms": c.time_ms(lambda: x.view(-1, _build.SUM_ROWS, H).sum(
            1, dtype=torch.float32), reps=20)}), flush=True)
    del x, y, out, z, part
torch.cuda.empty_cache()
"""


_LN_ONLY = r"""
import json, torch, chip_smoke as c
from fairmultimodal_torch.ops import _build, fused_attention_block as fab
torch.backends.cuda.matmul.allow_tf32 = False
print(json.dumps(c.ptxas_report(_build, ("layernorm_bwd_kernel", "colsum_kernel"))), flush=True)
LN_DTYPES = ("bf16", "fp32")
""" + _LNBITS + _LNROWS + r"""
# Both FAME steps (fp32 B 16, bf16 B 256): the device time and launches a step
# of the LayerNorm backward, the column sums and every kernel (LNSTEP).
import numpy as np, re
from torch.profiler import ProfilerActivity, profile
from fairmultimodal_torch.data.prefetch import to_device
from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.fusion import FAMEModel
from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig
for label, dtype, n, seed in (("FAME default fp32 B16", torch.float32, 16, 9),
                              ("FAME bf16 B256", torch.bfloat16, 256, 2)):
    trainer = FAMETrainer(init_params(FAMEModel(**c.TRAIN_GEO, dtype=dtype), seed=0),
                          TrainConfig(lr=1e-4, batch_size=n), pos_weight=c.POS_WEIGHT,
                          rngs_seed=0, device="cuda")
    a = c.synthetic_cohort(np.random.default_rng(seed), n)
    keys = [k for k in a if k != "labels"]
    batch = to_device({"model_inputs": {k: a[k] for k in keys}, "labels": a["labels"],
                       "weight": np.ones(n, np.float32)}, trainer.device)
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            trainer.train_step(batch)
        torch.cuda.synchronize()
    groups = {}
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        for gname, pat in (("layernorm_bwd", "layernorm_bwd_kernel"), ("colsum", "colsum_kernel"),
                           ("add_layernorm", "add_layernorm_kernel"), ("all", "")):
            if pat in e.key:
                t = groups.setdefault(gname, [0.0, 0.0])
                t[0] += e.self_device_time_total / 3e3
                t[1] += e.count / 3
    print("LNSTEP", json.dumps({"step": label, "ms_launches": groups}), flush=True)
    del trainer, batch
    torch.cuda.empty_cache()
"""


_RUN = r'''
import json, time, torch, chip_smoke as c
from fairmultimodal_torch.ops import _build, flash_attention as flash
from fairmultimodal_torch.ops import fused_attention_block as fab, fused_ffn as ffn
torch.backends.cuda.matmul.allow_tf32 = False
# The tree's own bf16 kernels (the "nn" / "tn" one is gemm_wgmma_kernel in a
# parent of the persistent gemm_bf16_nn_tn_kernel).
print(json.dumps(c.ptxas_report(_build, tuple(n for n in c.PTXAS_KERNELS if "f32" not in n))),
      flush=True)
gen = torch.Generator(device="cuda").manual_seed(5)
R16 = 16 * c.N_LABS
for stage in (("qkv lab", c.R_LAB, 2304, 768, "none", 0.0, False, False, True),
              ("wo lab", c.R_LAB, 768, 768, "none", 0.0, False, False, True),
              ("w1 lab relu dropout aux", c.R_LAB, 2048, 768, "relu", 0.1, True, False, True),
              ("w1 lab plain", c.R_LAB, 2048, 768, "none", 0.0, False, False, True),
              ("w2 lab", c.R_LAB, 768, 2048, "none", 0.0, False, False, True),
              ("qkv B16", R16, 2304, 768, "none", 0.0, False, False, True),
              ("w1 B16 relu dropout aux", R16, 2048, 768, "relu", 0.1, True, False, True),
              ("w1 B16 plain", R16, 2048, 768, "none", 0.0, False, False, True),
              ("w2 B16 fp32 out", R16, 768, 2048, "none", 0.0, False, True, True),
              ("qkv text S512", c.R_TEXT, 2304, 768, "none", 0.0, False, False, True),
              ("w1 text gelu aux", c.R_TEXT, 3072, 768, "gelu", 0.0, True, False, True),
              ("w2 text", c.R_TEXT, 768, 3072, "none", 0.0, False, False, True)):
    row = c.nt_gemm_check(_build, gen, *stage)
    print("GEMM", json.dumps({k: row[k] for k in ("stage", "ms", "tflops", "library_ms",
                                                  "library_tflops")}), flush=True)
bf = torch.bfloat16
R = 256 * 560
# Every bf16 "nn" / "tn" stage of the backward at the lab and batch-16 shapes,
# with the epilogue its path gives it, checked against fp32 and timed beside
# torch.matmul (phase 3c's check).
gen = torch.Generator(device="cuda").manual_seed(6)
R16B = 16 * 560
for stage in (("dO attention", "nn", R, 768, 768, None, False, True),
              ("dx attention + resid", "nn", R, 768, 2304, None, True, True),
              ("dh ffn relu gate + colpart", "nn", R, 2048, 768, "relu", False, True),
              ("dx ffn + resid", "nn", R, 768, 2048, None, True, True),
              ("dx ffn plain", "nn", R, 768, 2048, None, False, True),
              ("dWo split-K", "tn", 768, 768, R, None, False, True),
              ("dWqkv split-K", "tn", 2304, 768, R, None, False, True),
              ("dW1 split-K", "tn", 2048, 768, R, None, False, True),
              ("dW2 split-K", "tn", 768, 2048, R, None, False, True),
              ("dO attention B16", "nn", R16B, 768, 768, None, False, True),
              ("dx attention B16 + resid", "nn", R16B, 768, 2304, None, True, True),
              ("dh ffn B16 relu gate + colpart", "nn", R16B, 2048, 768, "relu", False, True),
              ("dx ffn B16 + resid", "nn", R16B, 768, 2048, None, True, True),
              ("dWqkv B16 split-K", "tn", 2304, 768, R16B, None, False, True),
              ("dW1 B16 split-K", "tn", 2048, 768, R16B, None, False, True),
              ("dh text dgelu gate + aux", "nn", c.R_TEXT, 3072, 768, "dgelu", False, True)):
    row = c.nn_tn_gemm_check(_build, fab, gen, *stage)
    print("BWDGEMM", json.dumps({k: row.get(k) for k in (
        "stage", "ms", "tflops", "library_ms", "bound_ms", "bound_by", "splits")}), flush=True)
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
        F = torch.nn.functional
        bias = None if mask is None else \
            torch.where(mask > 0, 0.0, -1e9).to(bf)[:, None, None, :]
        torch.cuda.synchronize()     # host time of one forward call, the card kept busy
        t0 = time.perf_counter()
        for _ in range(50):
            flash.flash_attention(q, k, v, mask)
        host_us = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
        row = {"ms": c.time_ms(lambda: flash.flash_attention(q, k, v, mask), reps=20),
               "host_us": host_us,
               "dev_ms": c.device_kernels(lambda: flash.flash_attention(q, k, v, mask), reps=10),
               "bwd_dev_ms": c.device_kernels(lambda: flash._backward_kernel(*saved, g), reps=10),
               "bwd_ms": c.time_ms(lambda: flash._backward_kernel(*saved, g), reps=20),
               "sdpa_ms": c.time_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=bias), reps=20)}
    lib = [t.clone().requires_grad_(True) for t in (q, k, v)]
    row["sdpa_bwd_ms"] = c._time_backward(F.scaled_dot_product_attention(
        *lib, attn_mask=bias), lib, g)
    print("FLASH", kw, json.dumps(row), flush=True)
    del q, k, v, o, stats, saved, g, lib
    torch.cuda.empty_cache()
#GEMMBITS#
# #2 (serving; the training forward with dropout 0.1) and #7 (the inner
# dropout 0.1 after relu; gelu takes none), bf16, beside one library
# composition each.
F = torch.nn.functional
gen = torch.Generator(device="cuda").manual_seed(8)
for label, R, FF, act, eps in (("lab R143360", c.R_LAB, 2048, "relu", 1e-5),
                               ("B16 R8784", R16, 2048, "relu", 1e-5),
                               ("text R16384", c.R_TEXT, 3072, "gelu", 1e-12)):
    run, plain, library, stages, flops, nbytes = c.ffn_case(ffn, R, 768, FF, act, eps, bf, gen)
    with torch.inference_mode():
        row = {"shape": label, "#2 serving ms": c.time_ms(run, reps=20),
               "#2 serving library_ms": c.time_ms(library, reps=20),
               "#2 stages_ms": {n: c.time_ms(fn, reps=20) for n, fn in stages()},
               "#2 bound_ms": c.bound_ms(flops, nbytes)[0]}
    del run, plain, library, stages
    fact = F.relu if act == "relu" else F.gelu
    f_in = [(torch.randn(*shape, generator=gen, device="cuda") * std).to(bf)
            for shape, std in (((R, 768), 1.0), ((FF, 768), 768 ** -0.5), ((FF,), 0.02),
                               ((768, FF), FF ** -0.5), ((768,), 0.02))]
    gamma = 1 + 0.1 * torch.randn(768, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(768, generator=gen, device="cuda")
    leaves = [t.clone().requires_grad_(True) for t in f_in + [gamma, beta]]
    x, w1, b1, w2, b2 = f_in
    inner = 0.1 if act == "relu" else 0.0
    lib7 = lambda: F.linear(F.dropout(fact(F.linear(x, w1, b1)), inner), w2, b2)  # noqa: E731
    row.update({
        "#2 train fwd ms": c.time_ms(lambda: ffn.fused_ffn_ln(
            *leaves, rate=0.1, deterministic=False, seeds=(21, 22), activation=act,
            ln_eps=eps), reps=20),
        "#2 train fwd library_ms": c.time_ms(lambda: F.layer_norm(
            x + F.dropout(lib7(), 0.1), (768,), gamma.to(bf), beta.to(bf), eps), reps=20),
        "#7 ms": c.time_ms(lambda: ffn.fused_ffn(*leaves[:5], deterministic=not inner,
                                                 seed=21 if inner else None, activation=act,
                                                 rate=inner), reps=20),
        "#7 library_ms": c.time_ms(lib7, reps=20)})
    print("FFN", json.dumps(row), flush=True)
    del f_in, leaves, x, w1, b1, w2, b2
    torch.cuda.empty_cache()
# #1 without residuals (serving), #3 and #5 / #6 timed, bf16.
gen = torch.Generator(device="cuda").manual_seed(6)
for label, shape in (("lab B256", dict(B=256, S=560, H=768, nh=8, eps=1e-5, mask_kind="lab")),
                     ("lab B16", dict(B=16, S=560, H=768, nh=8, eps=1e-5, mask_kind="lab")),
                     ("text B32 S512", dict(B=32, S=512, H=768, nh=12, eps=1e-12,
                                            mask_kind="text")),
                     ("text B64 S256", dict(B=64, S=256, H=768, nh=12, eps=1e-12,
                                            mask_kind="text"))):
    run, plain, library, stages, flops, nbytes = c.attention_case(fab, **shape, dtype=bf, gen=gen)
    with torch.inference_mode():
        print("ATTN", json.dumps({"kernel": "#1 serving", "shape": label, "ms": c.time_ms(run, reps=20),
                                  "library_ms": c.time_ms(library, reps=20),
                                  "stages_ms": {n: c.time_ms(fn, reps=20) for n, fn in stages()},
                                  "bound_ms": c.bound_ms(flops, nbytes)[0]}), flush=True)
    del run, plain, library, stages
    torch.cuda.empty_cache()
for label, kw in (("lab B256", dict(B=256)), ("lab B16", dict(B=16))):
    row = c.attention_train_check(fab, _build, gen, bf, 0.1, timed=True, **kw)
    print("ATTN", json.dumps({"kernel": "#1 residuals / #3", "shape": label, **{k: row.get(k) for k in (
        "fwd_res_ms", "ms", "stages_ms", "library_ms", "bound_ms", "deterministic")}}), flush=True)
    torch.cuda.empty_cache()
for label, kw in (("lab B256", dict(B=256)), ("lab B16", dict(B=16)),
                  ("text B32 S512", dict(B=32, S=512, nh=12, L=512))):
    row = c.block_check(fab, gen, bf, timed=True, **kw)
    print("ATTN", json.dumps({"kernel": "#5 / #6", "shape": label, **{k: row.get(k) for k in (
        "ms", "fwd_res_ms", "bwd_ms", "bwd_stages_ms", "library_ms", "library_bwd_ms", "bound_ms",
        "bwd_bound_ms", "bwd_deterministic")}}), flush=True)
    torch.cuda.empty_cache()
# #4 (the LN-fused FFN backward) at the lab and batch-16 shapes and #8 (the
# unfolded one) at the lab shape, bf16, dropout 0.1, with their stages.
gen = torch.Generator(device="cuda").manual_seed(16)
for label, rows in (("lab R143360", c.R_LAB), ("B16 R8960", 16 * 560)):
    row = c.ffn_train_check(ffn, _build, gen, bf, 0.1, R=rows, timed=True)
    print("BWD", json.dumps({"kernel": "#4", "shape": label, **{k: row.get(k) for k in (
        "ms", "stages_ms", "plain_ms", "library_ms", "bound_ms", "deterministic")}}), flush=True)
    torch.cuda.empty_cache()
# #8's check at the lab shape holds the bf16 grads to one ulp of their max-abs,
# which an input with a pre-activation rounded across zero (a relu flip)
# misses in the plain version: the inputs of the first seed that passes, the
# same seeds in every tree.
for seed in (17, 18, 19, 20):
    try:
        row = c.unfolded_ffn_check(ffn, torch.Generator(device="cuda").manual_seed(seed), bf,
                                   0.1, timed=True)
        break
    except AssertionError as err:
        print("BWD #8 seed", seed, "missed its check:", str(err)[:160], flush=True)
print("BWD", json.dumps({"kernel": "#8", "shape": "lab R143360", "seed": seed,
                        **{k: row.get(k) for k in (
                            "bwd_ms", "bwd_stages_ms", "plain_bwd_ms", "library_bwd_ms",
                            "bwd_bound_ms", "bwd_deterministic")}}), flush=True)
torch.cuda.empty_cache()
LN_DTYPES = ("bf16",)
#LNROWS#
# The bf16 FAME train step at batch 256 (phase 5's model and batch).
import numpy as np
from fairmultimodal_torch.data.loader import BatchIterator, NestedLoader
from fairmultimodal_torch.data.prefetch import to_device
from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.fusion import FAMEModel
from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig
from torch.profiler import ProfilerActivity, profile
train = c.synthetic_cohort(np.random.default_rng(2), 256)
keys = [k for k in train if k != "labels"]
trainer = FAMETrainer(init_params(FAMEModel(**c.TRAIN_GEO, dtype=bf), seed=0),
                      TrainConfig(lr=1e-4, batch_size=256), pos_weight=c.POS_WEIGHT,
                      rngs_seed=0, device="cuda")
batch = to_device(next(iter(NestedLoader(BatchIterator(train, 256, shuffle=True, seed=0), keys))),
                  trainer.device)
timed = c.time_train_step(trainer, batch)
split = c.profile_train_step(trainer, batch)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
full = {e.key: (e.self_device_time_total / 3e3, e.count / 3) for e in prof.key_averages()
        if e.self_device_time_total > 0}
names = {key[:100]: v for key, v in full.items()}
import re
nt = {}     # the "nt" GEMMs a step by output dtype: this kernel or the wgmma one's "nt" form
# The "nn" / "tn" GEMMs a step by mode, whichever kernel ran them (the persistent
# gemm_bf16_nn_tn_kernel<TOut, AT, MODE, GK> or its parent's gemm_wgmma_kernel<TOut, AT, MODE>).
nn_tn = {}
modes = {"0": "nn store", "2": "nn gate", "3": "nn resid"}
for key, (ms, n) in full.items():
    m = re.search(r"gemm_bf16_nt_kernel<(\w+)>|gemm_wgmma_kernel<(\w+), 0, 0,", key)
    if m:
        total = nt.setdefault("bf16 out" if "bfloat16" in (m.group(1) or m.group(2))
                              else "fp32 out", [0.0, 0.0])
        total[0] += ms
        total[1] += n
    m = re.search(r"(?:gemm_bf16_nn_tn_kernel|gemm_wgmma_kernel)<\w+, (\d), (\d)[,>]", key)
    if m:
        for group in ("tn" if m.group(1) == "1" else modes[m.group(2)], "all"):
            total = nn_tn.setdefault(group, [0.0, 0.0])
            total[0] += ms
            total[1] += n
print("STEP", json.dumps({"step": "FAME bf16 B256", "timed": timed,
                          "busy_ms": split["device_busy_ms"], "wall_ms": split["wall_ms"],
                          "idle_share": split["idle_share"], "nt_ms_launches": nt,
                          "nn_tn_ms_launches": nn_tn,
                          "by_kernel_ms_launches": dict(sorted(names.items(),
                                                               key=lambda x: -x[1][0]))}),
      flush=True)
'''.replace("#GEMMBITS#\n", _GEMMBITS).replace("#LNROWS#\n", _LNROWS)


_RUN_F32 = r'''
import json, sys, numpy as np, torch, chip_smoke as c
from fairmultimodal_torch.ops import _build, flash_attention as flash
from fairmultimodal_torch.ops import fused_attention_block as fab, fused_ffn as ffn
torch.backends.cuda.matmul.allow_tf32 = False
print(json.dumps(c.ptxas_report(_build, ("gemm_f32_nt_kernel",
                                         "gemm_f32_nn_tn_kernel", "flash_attn_fwd_f32_kernel",
                                         "flash_bwd_dq_f32_kernel",
                                         "flash_bwd_dkdv_f32_kernel"))), flush=True)
# Bits of the fp32 flash backward on fixed inputs (contiguous operands, one
# fully masked batch row): dq, dk, dv, the column partials and D at the lab
# shape, the tensor-parallel shard's 4 heads and d 64.
import hashlib
bits = {}
for name, (B, S, nh, d, mk) in (("lab B16 S560 8x96", (16, 560, 8, 96, "lab")),
                                ("tp B16 S560 4x96", (16, 560, 4, 96, "lab")),
                                ("d64 B4 S512 12x64", (4, 512, 12, 64, "rows"))):
    g = torch.Generator(device="cuda").manual_seed(23)
    q, k, v, do = (torch.randn(B, nh, S, d, generator=g, device="cuda") for _ in range(4))
    if mk == "lab":
        mask = (torch.arange(S, device="cuda") < c.N_LABS).int()[None].repeat(B, 1)
    else:
        lens = torch.randint(1, S + 1, (B,), generator=g, device="cuda")
        mask = (torch.arange(S, device="cuda")[None] < lens[:, None]).int()
    mask[-1] = 0
    o, stats = torch.empty_like(q), torch.empty(B, nh, S, 2, device="cuda")
    _build.flash_attention_fwd(q, k, v, mask, o, stats)
    rowterm = torch.empty(B, nh, S, device="cuda")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    colpart = torch.empty(_build.flash_bwd_colpart_rows(B, S, torch.float32), 3 * nh * d,
                          device="cuda")
    _build.flash_attention_bwd(q, k, v, o, do, mask, stats, rowterm, dq, dk, dv, colpart=colpart)
    bits[name] = {n: hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
                  .hexdigest()[:16] for n, t in (("dq", dq), ("dk", dk), ("dv", dv),
                                                 ("colpart", colpart), ("D", rowterm))}
    del q, k, v, do, o, stats, rowterm, dq, dk, dv, colpart
print("FLASHBITS", json.dumps(bits), flush=True)
torch.cuda.empty_cache()
gen = torch.Generator(device="cuda").manual_seed(7)
R = 16 * 560
# Every fp32 "nt" stage with the epilogue its path gives it, against float64.
for stage in (("qkv", "nt", R, 2304, 768, "none", 0.0, False, True),
              ("wo", "nt", R, 768, 768, "none", 0.0, False, True),
              ("w1 relu dropout aux", "nt", R, 2048, 768, "relu", 0.1, True, True),
              ("w2", "nt", R, 768, 2048, "none", 0.0, False, True),
              ("text w1 gelu aux", "nt", 8 * 512, 3072, 768, "gelu", 0.0, True, True),
              ("text w2", "nt", 8 * 512, 768, 3072, "none", 0.0, False, True),
              ("tp w1 F1024 relu dropout aux", "nt", R, 1024, 768, "relu", 0.1, True, True),
              ("tp w2 K1024", "nt", R, 768, 1024, "none", 0.0, False, True),
              ("06 w1 relu dropout aux", "nt", 8784, 512, 256, "relu", 0.1, True, True),
              ("06 w2", "nt", 8784, 256, 512, "none", 0.0, False, True)):
    row = c.f32_gemm_check(_build, fab, gen, *stage)
    print("F32GEMM", json.dumps({"stage": row["stage"] + " nt",
                                 "rel_err_vs_f64": row["errors"]["max_abs_err"]
                                 / row["errors"]["max_abs"],
                                 **{k: row[k] for k in ("ms", "tflops", "library_ms",
                                                        "library_tflops")}}), flush=True)
# #2 (LN-fused) and #7 (unfolded) FFN forwards at B 16, fp32, as a train step
# runs them (leaves that need grads, so the residuals are kept), beside one
# library composition each.
F = torch.nn.functional
H, FF = 768, 2048
f_in = [torch.randn(*shape, generator=gen, device="cuda") * std
        for shape, std in (((R, H), 1.0), ((FF, H), H ** -0.5), ((FF,), 0.02),
                           ((H, FF), FF ** -0.5), ((H,), 0.02))]
gamma = 1 + 0.1 * torch.randn(H, generator=gen, device="cuda")
beta = 0.1 * torch.randn(H, generator=gen, device="cuda")
leaves = [t.clone().requires_grad_(True) for t in f_in + [gamma, beta]]
x, w1, b1, w2, b2 = f_in
lib7 = lambda: F.linear(F.dropout(F.relu(F.linear(x, w1, b1)), 0.1), w2, b2)  # noqa: E731
print("F32FFN", json.dumps({
    "#2 ms": c.time_ms(lambda: ffn.fused_ffn_ln(*leaves, rate=0.1, deterministic=False,
                                                 seeds=(21, 22), activation="relu",
                                                 ln_eps=1e-5), reps=20),
    "#2 library_ms": c.time_ms(lambda: F.layer_norm(x + F.dropout(lib7(), 0.1), (H,), gamma,
                                                    beta, 1e-5), reps=20),
    "#7 ms": c.time_ms(lambda: ffn.fused_ffn(*leaves[:5], deterministic=False, seed=21,
                                             activation="relu", rate=0.1), reps=20),
    "#7 library_ms": c.time_ms(lib7, reps=20)}), flush=True)
del f_in, leaves, x, w1, b1, w2, b2
torch.cuda.empty_cache()
# Every fp32 "nn" / "tn" stage with the epilogue its path gives it, against
# float64: the lab layer at B 16, 06's at R 8784 x 256 x 512 and the sharded
# FFN's at F 1024; each with the tree's schedule where it records one.
for stage in (("dO attention", "nn", R, 768, 768, None, False, False, True),
              ("dx attention + resid", "nn", R, 768, 2304, None, True, False, True),
              ("dh ffn relu gate + colpart", "nn", R, 2048, 768, "relu", False, False, True),
              ("dx ffn + resid", "nn", R, 768, 2048, None, True, False, True),
              ("dWo split-K", "tn", 768, 768, R, None, False, False, True),
              ("dWqkv split-K", "tn", 2304, 768, R, None, False, False, True),
              ("dW1 split-K", "tn", 2048, 768, R, None, False, False, True),
              ("dW2 split-K", "tn", 768, 2048, R, None, False, False, True),
              ("06 dh relu gate + colpart", "nn", 8784, 512, 256, "relu", False, False, True),
              ("06 dx + resid", "nn", 8784, 256, 512, None, True, False, True),
              ("06 dW1 split-K", "tn", 512, 256, 8784, None, False, False, True),
              ("06 dW2 split-K", "tn", 256, 512, 8784, None, False, False, True),
              ("tp dh F1024 relu gate + colpart", "nn", R, 1024, 768, "relu", False, False, True),
              ("tp dx F1024 + resid", "nn", R, 768, 1024, None, True, False, True),
              ("tp dW1 F1024 split-K", "tn", 1024, 768, R, None, False, False, True),
              ("tp dW2 F1024 split-K", "tn", 768, 1024, R, None, False, False, True)):
    row = c.f32_gemm_check(_build, fab, gen, *stage)
    print("F32GEMM", json.dumps({"stage": row["stage"] + " " + row["layout"],
                                 "rel_err_vs_f64": row["errors"]["max_abs_err"]
                                 / row["errors"]["max_abs"],
                                 **{k: row[k] for k in ("ms", "tflops", "library_ms",
                                                        "library_tflops", "splits", "schedule",
                                                        "deterministic") if k in row}}),
          flush=True)
kw = dict(B=16, S=560, nh=8, d=96, mask_kind="lab")
row = c.flash_check(flash, gen, torch.float32, **kw)
_, q, k, v, mask, g = c._flash_inputs(16, 560, 8, 96, "dense", "lab", torch.float32, gen)
with torch.no_grad():
    q, k, v = (t.detach() for t in (q, k, v))
    ops = flash._operands(q, k, v, mask)
    o, stats = flash._forward_kernel(*ops, residuals=True)
    saved = (*ops[:3], o, stats, ops[3])
    print("F32FLASH", json.dumps({"rel_err": {n: e["max_abs_err"] / e["max_abs"]
                                              for n, e in row["errors"].items()},
                                  "bwd_ms": c.time_ms(lambda: flash._backward_kernel(*saved, g),
                                                      reps=20),
                                  "bwd_stages_ms": c._flash_bwd_stages_ms(flash, saved, g)}),
          flush=True)
del q, k, v, o, stats, saved, g
# The fp32 flash forward at the lab and text shapes beside SDPA (fp32, -1e9
# bias), then #1's forward stages at B 16 beside their library calls.
F = torch.nn.functional
for B, S, nh, d, mk in ((16, 560, 8, 96, "lab"), (32, 512, 12, 64, "rows")):
    _, q, k, v, mask, _ = c._flash_inputs(B, S, nh, d, "dense", mk, torch.float32, gen)
    with torch.no_grad():
        q, k, v = (t.detach() for t in (q, k, v))
        ops = flash._operands(q, k, v, mask)
        o, _ = flash._forward_kernel(*ops, residuals=True)
        want = flash.flash_attention_reference(q, k, v, mask)
        bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
        ms = c.time_ms(lambda: flash._forward_kernel(*ops, residuals=True), reps=20)
        lib_ms = c.time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias),
                           reps=20)
    flops = 4 * B * nh * S * S * d
    print("F32FLASHFWD", json.dumps({"shape": f"B{B} S{S} {nh}x{d} mask {mk}",
                                     "rel_err": ((o - want).abs().max() / want.abs().max()).item(),
                                     "ms": ms, "tflops": flops / ms / 1e9, "library_ms": lib_ms,
                                     "library_tflops": flops / lib_ms / 1e9}), flush=True)
    del q, k, v, o, want, ops
from fairmultimodal_torch.utils.rng import Dropout
inputs, mask, _ = c._attn_train_case(fab, 16, 560, 768, 8, 1e-5, torch.float32, gen, c.N_LABS)
x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta = inputs
with torch.no_grad():
    fwd, _, _ = fab.half_layer_stages(*inputs, mask, num_heads=8, ln_eps=1e-5,
                                      dropout=Dropout.make(key_of(1234, "cuda"), 0, 0.1),
                                      residuals=True)
    for _, fn in fwd:
        fn()
    w_qkv, b_qkv = torch.cat((wq, wk, wv)), torch.cat((bq, bk, bv))
    qkv = F.linear(x, w_qkv, b_qkv)
    q, k, v = (t.transpose(1, 2) for t in qkv.view(16, 560, 3, 8, 96).unbind(2))
    bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias).transpose(1, 2).reshape(16, 560, 768)
    y = F.linear(o, wo, bo)
    lib = {"qkv_gemm": lambda: F.linear(x, w_qkv, b_qkv),
           "flash_attn_fwd": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias),
           "wo_gemm": lambda: F.linear(o, wo, bo),
           "add_layernorm": lambda: F.layer_norm(x + F.dropout(y, 0.1), (768,), gamma, beta, 1e-5)}
    print("F32FLASHFWD", json.dumps({"#1 stages B16": {name: {
        "ms": c.time_ms(fn, reps=20), "library_ms": c.time_ms(lib[name], reps=20)}
        for name, fn in fwd}, "whole_ms": c.time_ms(lambda: [fn() for _, fn in fwd], reps=20)}),
        flush=True)
del inputs, x, fwd, qkv, q, k, v, o, y, lib
torch.cuda.empty_cache()
gen = torch.Generator(device="cuda").manual_seed(16)
for name, check, mod, shape in (("#3 attention", c.attention_train_check, fab, dict(B=16)),
                                ("#4 ffn", c.ffn_train_check, ffn, dict(R=R))):
    row = check(mod, _build, gen, torch.float32, 0.1, timed=True, **shape)
    print("F32BWD", json.dumps({"kernel": name, **{k: row[k] for k in (
        "ms", "stages_ms", "plain_ms", "library_ms", "fwd_res_ms")}, "deterministic": row.get("deterministic")}), flush=True)
    torch.cuda.empty_cache()
LN_DTYPES = ("fp32",)
#LNROWS#
if "--steps" in sys.argv:
    import inspect
    # Phase 8's rows at B 16 (#1-#4, and #5-#10 where the tree's phase 8 times
    # them; else the same checks timed here), fp32.
    if "flash" in inspect.signature(c.baseline_kernel_rows).parameters:
        rows = c.baseline_kernel_rows(fab, ffn, flash, _build)
    else:
        rows = c.baseline_kernel_rows(fab, ffn, _build)
        gen = torch.Generator(device="cuda").manual_seed(16)
        blk = c.block_check(fab, gen, torch.float32, B=16, timed=True)
        uffn = c.unfolded_ffn_check(ffn, gen, torch.float32, 0.1, R=R, timed=True)
        for name, row in (("fused_attention_block", blk), ("fused_ffn", uffn)):
            rows[name] = {"float32": {"ms": row["fwd_res_ms"], "plain_ms": row["plain_ms"],
                                      "library_ms": row["library_ms"]}}
            rows[name + "_bwd"] = {"float32": {"ms": row["bwd_ms"],
                                               "plain_ms": row["plain_bwd_ms"],
                                               "library_ms": row["library_bwd_ms"]}}
        # #9 / #10 as phase 8 times them (the forward with its residuals).
        F = torch.nn.functional
        _, q, k, v, mask, g = c._flash_inputs(16, 560, 8, 96, "dense", "lab", torch.float32, gen)
        q, k, v = (t.detach() for t in (q, k, v))
        bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
        with torch.no_grad():
            ops = flash._operands(q, k, v, mask)
            o, stats = flash._forward_kernel(*ops, residuals=True)
            saved = (*ops[:3], o, stats, ops[3])
            rows["flash_attention"] = {"float32": {
                "ms": c.time_ms(lambda: flash._forward_kernel(*ops, residuals=True)),
                "plain_ms": c.time_ms(lambda: flash.flash_attention_reference(q, k, v, mask),
                                      reps=5),
                "library_ms": c.time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=bias))}}
            bwd = {"ms": c.time_ms(lambda: flash._backward_kernel(*saved, g)),
                   "plain_ms": c.time_ms(lambda: flash.flash_attention_backward_reference(
                       q, k, v, mask, g), reps=3)}
        lib = [t.clone().requires_grad_(True) for t in (q, k, v)]
        bwd["library_ms"] = c._time_backward(F.scaled_dot_product_attention(
            *lib, attn_mask=bias), lib, g)
        rows["flash_attention_bwd"] = {"float32": bwd}
    print("ROWS", json.dumps({k: {m: v["float32"][m] for m in ("ms", "plain_ms", "library_ms")}
                              for k, v in rows.items()}), flush=True)
    torch.cuda.empty_cache()
'''.replace("#LNROWS#\n", _LNROWS)

_STEPS = r'''
import json, re, numpy as np, torch, chip_smoke as c
from fairmultimodal_torch.data.prefetch import to_device
from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.fusion import FAMEModel
from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig
from fairmultimodal_torch.train.simple import MultitaskTrainer
torch.backends.cuda.matmul.allow_tf32 = False
a = c.synthetic_cohort(np.random.default_rng(9), 16)
keys = [k for k in a if k != "labels"]
trainer = FAMETrainer(init_params(FAMEModel(**c.TRAIN_GEO, dtype=torch.float32), seed=0),
                      TrainConfig(), pos_weight=c.POS_WEIGHT, rngs_seed=0, device="cuda")
batch = to_device({"model_inputs": {k: a[k] for k in keys}, "labels": a["labels"],
                   "weight": np.ones(16, np.float32)}, trainer.device)
print("STEP", json.dumps({"step": "FAME default fp32 B16",
                          "timed": c.time_train_step(trainer, batch),
                          "profile": c.profile_train_step(trainer, batch)}), flush=True)
# Device time per step of every kernel by its full name (no top-N cut), and
# the fp32 GEMMs by layout: "nt", "nn" (by epilogue) and "tn" with the
# split partials' fixed-order sum.
from torch.profiler import ProfilerActivity, profile
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
names = {e.key: (e.self_device_time_total / 3e3, e.count / 3) for e in prof.key_averages()
         if e.self_device_time_total > 0}
groups = {}
for key, (ms, n) in names.items():
    m = re.search(r"gemm_f32_(?:nn_tn_)?kernel<(\d), (\d)", key)
    g = ("tn" if m.group(1) == "1" else "nn mode " + m.group(2)) if m else \
        "nt" if "gemm_f32_nt_kernel" in key else "colsum" if "colsum_kernel" in key else None
    if g:
        total = groups.setdefault(g, [0.0, 0.0])
        total[0] += ms
        total[1] += n
print("STEPGEMM", json.dumps({"by_layout_ms_launches": groups,
                              "by_kernel_ms_launches": {k[:120]: v for k, v in sorted(
                                  names.items(), key=lambda x: -x[1][0])}}), flush=True)
del trainer, batch
name, factory, keys, cfg = c._baseline_models()[0]
trainer = MultitaskTrainer(init_params(factory(torch.float32), seed=0), cfg, c.POS_WEIGHT,
                           device="cuda")
batch = c._baseline_batch(keys, "cuda")
print("STEP", json.dumps({"step": "01 fp32 B16", "timed": c.time_train_step(trainer, batch),
                          "profile": c.profile_train_step(trainer, batch)}), flush=True)
'''


_HOST = r'''
import hashlib, json, statistics, time, numpy as np, torch, chip_smoke as c
from fairmultimodal_torch.data.prefetch import to_device
from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.fusion import FAMEModel
from fairmultimodal_torch.ops import _build, dropout_add_layernorm as addnorm
from fairmultimodal_torch.ops import flash_attention as flash
from fairmultimodal_torch.ops import fused_attention_block as fab, fused_ffn as ffn
from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig
from fairmultimodal_torch.utils.rng import Dropout
torch.backends.cuda.matmul.allow_tf32 = False
_build.build()
_build.kernels()
dev, f32 = "cuda", torch.float32
gen = torch.Generator(device=dev).manual_seed(21)


def rnd(*shape, dtype=f32, std=1.0):
    return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)


def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# Bits of every launch that draws dropout: the "nt" epilogue (relu + dropout),
# the add + LayerNorm row kernel and its backward, from int seeds (the high
# word set, as fold_in sets it).
bits = {}
for dt in (torch.bfloat16, f32):
    name = str(dt)[6:]
    a, w, bias = rnd(4480, 768, dtype=dt), rnd(2048, 768, dtype=dt, std=0.04), rnd(2048)
    out = torch.empty(4480, 2048, device=dev, dtype=dt)
    _build.gemm(a, w, out, bias=bias, activation="relu",
                dropout=Dropout.make(key_of(123456789 | 3 << 32, dev), 0, 0.1))
    bits["nt relu dropout " + name] = digest(out)
    x, y, gamma, beta = rnd(4480, 768, dtype=dt), rnd(4480, 768), 1 + rnd(768, std=0.1), rnd(768)
    o, z = torch.empty_like(x), torch.empty_like(x)
    drop = Dropout.make(key_of(987654321, dev), 1, 0.1)
    _build.add_layernorm(x, y, gamma, beta, o, 1e-5, drop, z)
    bits["add_layernorm dropout " + name] = digest(o, z)
    dz, da = torch.empty(4480, 768, device=dev), torch.empty_like(x)
    part = torch.empty((3, -(-4480 // _build.LN_BWD_ROWS), 768), device=dev)
    _build.layernorm_bwd(rnd(4480, 768, dtype=dt), z, gamma, dz, da, part, 1e-5, drop)
    bits["layernorm_bwd dropout " + name] = digest(dz, da, part)
print("DROPBITS", json.dumps(bits), flush=True)
#LNBITS#
#GEMMBITS#
gen = torch.Generator(device=dev).manual_seed(22)


def host_us(fn, n=40):
    """Median host time of one call from an idle card (enqueue only)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


# Host microseconds per wrapper call at FAME's default lab layer (fp32, B 16 x
# S 560, 8 x 96, F 2048), forward with grad on (residuals, dropout from an int
# seed), its backward, and the no-grad forward of the text encoder's entries.
B, S, H, NH, F = 16, 560, 768, 8, 2048
x = rnd(B, S, H).requires_grad_(True)
w = [rnd(H, H, std=H ** -0.5).requires_grad_(True) if i % 2 == 0 else
     rnd(H, std=0.05).requires_grad_(True) for i in range(8)]
gamma, beta = (1 + rnd(H, std=0.1)).requires_grad_(True), rnd(H, std=0.1).requires_grad_(True)
mask = (torch.rand(B, S, generator=gen, device=dev) > 0.1).int()
fw = [rnd(B * S, H).requires_grad_(True), rnd(F, H, std=H ** -0.5).requires_grad_(True),
      rnd(F, std=0.05).requires_grad_(True), rnd(H, F, std=F ** -0.5).requires_grad_(True),
      rnd(H, std=0.05).requires_grad_(True)]
qkv = rnd(B, S, 3 * H).requires_grad_(True)
qv, kv, vv = (t.transpose(1, 2) for t in qkv.view(B, S, 3, NH, H // NH).unbind(2))
calls = {
    "attention_block_ln": (lambda: fab.fused_attention_block_ln(
        x, *w, gamma, beta, mask, num_heads=NH, ln_eps=1e-5, rate=0.1, deterministic=False,
        seed=11), [x, *w, gamma, beta]),
    "ffn_ln": (lambda: ffn.fused_ffn_ln(*fw, gamma, beta, ln_eps=1e-5, rate=0.1,
                                        deterministic=False, seeds=(12, 13)), [*fw, gamma, beta]),
    "attention_block": (lambda: fab.fused_attention_block(x, *w, mask, num_heads=NH), [x, *w]),
    "ffn": (lambda: ffn.fused_ffn(*fw, rate=0.1, deterministic=False, seed=14), fw),
    "flash_attention": (lambda: flash.flash_attention(qv, kv, vv, mask), [qkv]),
    "dropout_add_layernorm": (lambda: addnorm.dropout_add_layernorm(
        x, x * 0.5, gamma, beta, eps=1e-5, dropout=Dropout.make(15, 0, 0.1)), [x, gamma, beta]),
}
us = {}
for name, (fwd, leaves) in calls.items():
    us[name] = host_us(fwd)
    out = fwd()
    g = torch.ones_like(out)
    us[name + "_bwd"] = host_us(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))
    del out, g
with torch.no_grad():
    us["attention_block_ln_infer"] = host_us(lambda: fab.fused_attention_block_ln_infer(
        x, *w, gamma, beta, mask, num_heads=NH, ln_eps=1e-5))
    us["ffn_ln_infer"] = host_us(lambda: ffn.fused_ffn_ln_infer(*fw, gamma, beta, ln_eps=1e-5))
print("HOSTUS", json.dumps({k: round(v, 1) for k, v in us.items()}), flush=True)
del x, w, fw, qkv, qv, kv, vv, calls
torch.cuda.empty_cache()

# The eager steps: FAME's default (fp32, B 16) and phase 5's (bf16, B 256).
for label, dtype, n, seed in (("FAME default fp32 B16", f32, 16, 9),
                              ("FAME bf16 B256", torch.bfloat16, 256, 2)):
    trainer = FAMETrainer(init_params(FAMEModel(**c.TRAIN_GEO, dtype=dtype), seed=0),
                          TrainConfig(lr=1e-4, batch_size=n), pos_weight=c.POS_WEIGHT,
                          rngs_seed=0, device=dev)
    a = c.synthetic_cohort(np.random.default_rng(seed), n)
    keys = [k for k in a if k != "labels"]
    batch = to_device({"model_inputs": {k: a[k] for k in keys}, "labels": a["labels"],
                       "weight": np.ones(n, np.float32)}, trainer.device)
    print("STEP", json.dumps({"step": label, "timed": c.time_train_step(trainer, batch),
                              "profile": c.profile_train_step(trainer, batch)}), flush=True)
    del trainer, batch
    torch.cuda.empty_cache()
'''.replace("#GEMMBITS#\n", _GEMMBITS).replace("#LNBITS#\n", _LNBITS)


_STEPS_HOST = r'''
import json, statistics, time, warnings, numpy as np, torch, chip_smoke as c
from fairmultimodal_torch.data.prefetch import to_device
from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.fusion import FAMEModel
from fairmultimodal_torch.ops import _build
from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig
torch.backends.cuda.matmul.allow_tf32 = False
_build.build()
_build.kernels()
out = {}
for label, dtype, n, seed in (("fp32 B16", torch.float32, 16, 9),
                              ("bf16 B256", torch.bfloat16, 256, 2)):
    trainer = FAMETrainer(init_params(FAMEModel(**c.TRAIN_GEO, dtype=dtype), seed=0),
                          TrainConfig(lr=1e-4, batch_size=n), pos_weight=c.POS_WEIGHT,
                          rngs_seed=0, device="cuda")
    a = c.synthetic_cohort(np.random.default_rng(seed), n)
    keys = [k for k in a if k != "labels"]
    batch = to_device({"model_inputs": {k: a[k] for k in keys}, "labels": a["labels"],
                       "weight": np.ones(n, np.float32)}, trainer.device)
    row = {"step_ms": c.time_train_step(trainer, batch)["train_step_ms"]}
    dyn = trainer._dyn_w()          # on the card, as train_epoch passes it
    host = []
    for _ in range(15):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.backward(batch, dyn)
        host.append(1e3 * (time.perf_counter() - t0))
    row["fwd_bwd_host_ms"] = statistics.median(host)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer.train_step(batch)
        torch.cuda.set_sync_debug_mode(0)
    row["step_syncs"] = sum("synchronizing" in str(m.message) for m in caught)
    out[label] = row
    del trainer, batch
    torch.cuda.empty_cache()
print("STEPSHOST", json.dumps(out), flush=True)
'''


# Every script first: ``key_of(seed, device)``, a dropout seed as the tree's
# launchers take it (a key tensor on the card where they read the key from device
# memory, else the int itself).
_KEYS = r'''
import importlib.util
if importlib.util.find_spec("fairmultimodal_torch.ops._library") is not None:
    from fairmultimodal_torch.ops._library import key_of
else:
    def key_of(seed, device):
        return seed
'''


def main(args) -> int:
    flags = ("--fp32", "--steps", "--steps-only", "--host", "--steps-host", "--ln")
    fp32, steps, only, host, steps_host, ln = (f in args for f in flags)
    trees = [a for a in args if a not in flags]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    script = _LN_ONLY if ln else _STEPS_HOST if steps_host else _HOST if host else (
        _STEPS if only else _RUN_F32 + (_STEPS if steps else "") if fp32 else _RUN)
    rc = 0
    for tree in trees:
        print(f"==== {tree}", flush=True)
        cmd = [sys.executable, "-c", _KEYS + script] + (["--steps"] if steps else [])
        rc |= subprocess.run(cmd, cwd=os.path.abspath(tree)).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
