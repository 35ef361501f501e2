#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fairmultimodal_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card

Phases, each of which fails the run (non-zero exit) when it goes wrong:

1. card: the name and power limit from ``nvidia-smi``;
2. build: every kernel compiled from ``fairmultimodal_torch/ops/csrc``, and
   what ``-Xptxas -v`` reports (registers, stack, spills) for each
   instantiation of the wgmma GEMM ("nt", "nn", "tn") and of the mma.sync
   flash forward, dQ and dK / dV kernels;
3. kernels: each ported kernel's wrapper against its plain PyTorch version
   on the card, at the shapes the serving path gives it, in fp32 (max abs
   error <= 1e-4: only the summation order differs) and in bf16 (max abs
   <= 0.125 and mean abs <= 2e-3: the outputs are LayerNorm outputs with
   |y| < 8, where a bf16 ulp is at most 0.03125; the two versions round the
   same intermediates but sum in another order, so a rounding can flip by
   an ulp and carry through the residual and the LayerNorm); then timed with
   CUDA events (median of 10 after warm-up) beside the plain version, one
   PyTorch library composition of the same function (F.linear + SDPA +
   layer_norm; never called by the port) and the card's bound, and each of
   the half-layer's kernel launches timed alone the same way; one more
   attention shape off the serving path (head dim 12, ragged S) is checked
   for errors only, so every code path of the attention kernels runs;
4. slice: the serving main path at full width -- a bf16 FAME model (demo
   BERT 12L/12H, lab encoder 2L/8H over 549 labs, H 768) and a BERT-base
   note encoder, seeded random weights, a 300-patient cohort whose notes hit
   every bucket -- through ``encode_note_chunks`` -> ``build_model_arrays``
   -> ``FAMEPredictor.predict_arrays``, with the kernels' launch counts read
   around it; then the same model in fp32 on 8 patients on the card and on
   the CPU (probabilities within 1e-4); then ``FAMEPredictor.benchmark``.

3b. training kernels: forward-with-residuals plus backward of both
   half-layers through their ``autograd.Function`` against the plain forward
   plus the plain backward on the card, at the lab shapes (attention B256
   S560 8x96, FFN R143360 F2048 relu), fp32 and bf16, dropout off and at
   rate 0.1 (the same Philox seed, so the same masks); limits per grad,
   relative to that grad's largest entry: fp32 1e-4 (only summation order
   differs), bf16 see ``TRAIN_BF16_MAX`` / ``TRAIN_BF16_MEAN``.  Dropout:
   every stream keeps 0.9 +- 0.001 of its elements, the same seed gives
   bit-identical outputs and another seed another mask.  The gelu branch of
   the FFN backward is checked for errors at a reduced text shape, and both
   backwards at a shape off the main path (600 rows, S 200, head dim 12, a
   fully masked row).  Timed
   (bf16, dropout on, CUDA-event medians): the forward with residuals, the
   backward, each backward launch alone, the plain backward and one library
   composition's backward (torch autograd of F.linear + SDPA + dropout +
   layer_norm; never called by the port), beside the bound;
5. training slice: ``FAMETrainer.fit`` for 2 epochs at full width in bf16
   (batch 256, 1024 train / 256 validation synthetic patients, dropout on),
   with the kernels' launch counts read around it; then one fp32 train step
   on 8 patients on the card and on the CPU with the same generator seed
   (loss within 1e-5 relative, every grad within 1e-3 of its max-abs); then
   the train-step time at batch 256 bf16 (median of 20 after warm-up) and its
   device time by kernel from ``torch.profiler``.

3c. unfolded kernels (the layer with ``fold_ln=False``): ``fused_attention_block``
   (Pallas #5 / #6) and ``fused_ffn`` (#7 / #8) forward and backward through
   their ``autograd.Function`` against the plain forward and backward, at
   the lab shapes (B256 S560 8x96; R143360 F2048 relu with the inner dropout
   off and at 0.1) and at a text shape (R 64 x 512, F 3072, gelu), fp32 and
   bf16, plus shapes off the main path (S 272, head dim 64, a fully masked
   row; 600 rows); the dropout + residual + LayerNorm glue against its plain
   version; limits at the phase.  Timed in bf16: each forward and backward
   launch, plain versions, one library composition of each (F.linear x3 +
   SDPA + F.linear; F.linear + relu + dropout + F.linear; their autograd
   backwards), beside the bound.  Then each bf16 "nt" GEMM stage of the path
   alone (QKV, Wo into bf16 and fp32, W1 with relu + inner dropout + aux, W2
   at K 2048, the text encoder's S-512 QKV; errors only: the text W1 with
   gelu and a ragged M 600 / N 200 / K 96) against the same epilogue in fp32,
   timed beside F.linear with the TFLOP/s of each, and the W1 launch with a
   bias of +8 (no pre-activation near zero) zeroing exactly the elements the
   plain Philox mask drops; then each bf16 backward product of the lab path
   alone ("nn": dO, dx with and without the fp32 residual, dh with the relu
   gate and its column partials, the FFN's dx; "tn" split-K: dWo, dWqkv, dW1,
   dW2; errors only: the text dgelu gate with aux and ragged M 600 / N 200
   shapes) against the same epilogue in fp32, timed beside torch.matmul.
   The bf16 backwards of #3 and #6 run twice on the same inputs and must
   leave bit-identical grads (no float atomics);
5b. unfolded slice: an fp32 train step unfolded on the card against the
   folded one on the card (loss 1e-6 relative, grads 1e-4 of max-abs) and
   against the CPU plain path (phase 5's limits); ``FAMETrainer.fit`` for 1
   epoch with validation under ``FMTPU_FOLD_LN=0`` (512 train / 256
   validation patients, full width) whose launch counts of #5-#8 and of the
   glue must equal the protocol's, with #1-#4 never launched; the bf16
   train step at batch 256 folded and unfolded in turns and the unfolded
   one's profiler split; fp32 serving probabilities unfolded vs folded
   (1e-5) and ``FAMEPredictor.benchmark`` unfolded.

3d. flash kernels (Pallas #9 / #10, the flash route): ``flash_attention``
   forward and backward (dq, dk, dv) through its autograd.Function against
   ``flash_attention_reference`` / ``flash_attention_backward_reference`` on
   the card, fp32 and bf16, at the lab shape (B256 S560 8x96, q/k/v head
   views of three [B, S, H] Dense outputs, 549 of 560 keys, the mask
   expanded as BEHRTLab builds it), the text-train shape (B32 S512 12x64,
   per-row masks, a fully masked row) and off the main path (d 32 at S 256
   without a mask; d 128 at S 1024 on contiguous [B, heads, S, d] tensors;
   the packed ``fused_qkv`` layout); limits at the phase.  In bf16 the
   backward is also held against its own rounding order repeated in
   PyTorch: at most 1% of the entries differ, by at most one bf16 ulp of
   max-abs.  Timed in bf16 at the lab shape: the
   kernels (the backward's dQ and dK / dV kernels also apart, from the
   profiler), their plain versions, SDPA with the -1e9 bias and its autograd
   backward (never called by the port), beside the bound; the backward run
   twice must give bit-identical dq, dk, dv.
   Also ``TorchEncoderLayer(fused_qkv=True)`` against the same layer unfused
   in fp32 (forward and grads 1e-4 of max-abs);
5c. flash-route slice (``attn_kernel=False`` on every lab layer): an fp32
   train step with dropout on against the folded card step and the CPU
   plain path (phase 5's limits); ``FAMETrainer.fit`` for 1 epoch (512 train
   / 256 validation patients, full width) whose launch counts of #9, #10,
   ``fused_ffn_ln`` and the glue must equal the protocol's, with #1 / #3 /
   #5 / #6 never launched; the bf16 train step at batch 256 folded and on
   the flash route in turns and the flash route's profiler split; fp32
   serving probabilities flash route vs folded (1e-4) and
   ``FAMEPredictor.benchmark`` on the flash route.

It prints a ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BF16_PEAK = 989e12        # H100 SXM dense bf16 tensor-core FLOP/s
HBM_RATE = 3.35e12        # H100 SXM HBM3 bytes/s
FP32_TOL = 1e-4
BF16_MAX_TOL, BF16_MEAN_TOL = 0.125, 2e-3
N_PATIENTS, N_LABS = 300, 549
CHUNK_WORDS = (30, 100, 200, 450)   # -> buckets 64, 128, 256, 512


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=10, warmup=2):
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / BF16_PEAK, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# -- phase 3: kernels against their plain versions --------------------------------


def attention_case(fab, B, S, H, nh, eps, mask_kind, dtype, gen):
    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    x = rn(B, S, H)
    w = []
    for _ in range(4):
        w += [rn(H, H, std=H ** -0.5), rn(H, std=0.02)]
    gamma = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda"))
    beta = 0.1 * torch.randn(H, generator=gen, device="cuda")
    if mask_kind == "lab":      # 549 real lab tokens padded to 560
        mask = (torch.arange(S, device="cuda") < N_LABS).int()[None].expand(B, S).contiguous()
    else:                       # note lengths; zero rows are the padded batch tail
        lens = torch.randint(1, S + 1, (B,), generator=gen, device="cuda")
        lens[-2:] = 0
        mask = (torch.arange(S, device="cuda")[None] < lens[:, None]).int()
    args = (x, *w, gamma, beta, mask)
    kw = dict(num_heads=nh, ln_eps=eps)
    run = lambda: fab.fused_attention_block_ln_infer(*args, **kw)
    plain = lambda: fab.fused_attention_block_ln_reference(*args, **kw)

    wqkv = torch.cat(w[0:6:2])
    bqkv = torch.cat(w[1:6:2])
    bias = torch.where(mask > 0, 0.0, -1e9).to(dtype)[:, None, None, :]
    d = H // nh

    def library():
        qkv = torch.nn.functional.linear(x, wqkv, bqkv).view(B, S, 3, nh, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        y = torch.nn.functional.linear(o.transpose(1, 2).reshape(B, S, H), w[6], w[7])
        return torch.nn.functional.layer_norm(x + y, (H,), gamma.to(dtype), beta.to(dtype),
                                              eps)

    flops = B * (8 * S * H * H + 4 * S * S * H)
    nbytes = 2 * B * S * H * x.element_size() + 4 * H * H * x.element_size() + B * S * 4
    stages = lambda: fab.half_layer_stages(*args, **kw)[0]
    return run, plain, library, stages, flops, nbytes


def ffn_case(ffn, R, H, F, act, eps, dtype, gen):
    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    x = rn(R, H)
    w1, b1, w2, b2 = rn(F, H, std=H ** -0.5), rn(F, std=0.02), rn(H, F, std=F ** -0.5), rn(H, std=0.02)
    gamma = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda"))
    beta = 0.1 * torch.randn(H, generator=gen, device="cuda")
    args = (x, w1, b1, w2, b2, gamma, beta)
    kw = dict(activation=act, ln_eps=eps)
    run = lambda: ffn.fused_ffn_ln_infer(*args, **kw)
    plain = lambda: ffn.fused_ffn_ln_reference(*args, **kw)
    fact = torch.relu if act == "relu" else torch.nn.functional.gelu

    def library():
        y = torch.nn.functional.linear(fact(torch.nn.functional.linear(x, w1, b1)), w2, b2)
        return torch.nn.functional.layer_norm(x + y, (H,), gamma.to(dtype), beta.to(dtype),
                                              eps)

    flops = 4 * R * H * F
    nbytes = 2 * R * H * x.element_size() + 2 * H * F * x.element_size()
    stages = lambda: ffn.half_layer_stages(*args, **kw)[0]
    return run, plain, library, stages, flops, nbytes


def check_errors(name, label, dtype, run, plain):
    """Max and mean abs error of the kernel against its plain version."""
    out = run()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name} {label} {dtype}: non-finite output")
    err = (out.float() - plain().float()).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    if dtype == torch.float32 and max_err > FP32_TOL:
        raise AssertionError(f"{name} {label} fp32: max abs err {max_err} > {FP32_TOL}")
    if dtype == torch.bfloat16 and (max_err > BF16_MAX_TOL or mean_err > BF16_MEAN_TOL):
        raise AssertionError(f"{name} {label} bf16: max {max_err} mean {mean_err}")
    return max_err, mean_err


def kernel_phase(fab, ffn):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ("fused_attention_block_ln", "lab B256 S560 8x96", "attn",
         dict(B=256, S=560, H=768, nh=8, eps=1e-5, mask_kind="lab")),
        ("fused_attention_block_ln", "text B32 S512 12x64", "attn",
         dict(B=32, S=512, H=768, nh=12, eps=1e-12, mask_kind="text")),
        ("fused_attention_block_ln", "text B64 S256 12x64", "attn",
         dict(B=64, S=256, H=768, nh=12, eps=1e-12, mask_kind="text")),
        ("fused_ffn_ln", "lab R143360 F2048 relu", "ffn",
         dict(R=256 * 560, H=768, F=2048, act="relu", eps=1e-5)),
        ("fused_ffn_ln", "text R16384 F3072 gelu", "ffn",
         dict(R=32 * 512, H=768, F=3072, act="gelu", eps=1e-12)),
    ]
    results = []
    for name, label, kind, shape in cases:
        row = {"kernel": name, "shape": label}
        for dtype in (torch.float32, torch.bfloat16):
            make = attention_case if kind == "attn" else ffn_case
            mod = fab if kind == "attn" else ffn
            run, plain, library, stages, flops, nbytes = make(mod, **shape, dtype=dtype, gen=gen)
            with torch.inference_mode():
                tag = "fp32" if dtype == torch.float32 else "bf16"
                row[f"max_abs_err_{tag}"], row[f"mean_abs_err_{tag}"] = \
                    check_errors(name, label, dtype, run, plain)
                if dtype == torch.bfloat16:
                    row["ms"] = time_ms(run)
                    row["plain_ms"] = time_ms(plain)
                    row["library_ms"] = time_ms(library)
                    row["stages_ms"] = {stage: time_ms(fn) for stage, fn in stages()}
                    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
                    row["flops"], row["bytes"] = flops, nbytes
            del run, plain, library, stages
            torch.cuda.empty_cache()
        log(f"[kernels] {json.dumps(row)}")
        results.append(row)

    # Off the serving path: head dim 12 (element loads in the bf16 tile
    # loader, DP 32) and S 200 (a ragged last key tile), errors only.
    label = "B4 S200 64x12"
    for dtype in (torch.float32, torch.bfloat16):
        run, plain, *_ = attention_case(fab, B=4, S=200, H=768, nh=64, eps=1e-12,
                                        mask_kind="text", dtype=dtype, gen=gen)
        with torch.inference_mode():
            errs = check_errors("fused_attention_block_ln", label, dtype, run, plain)
        log(f"[kernels] fused_attention_block_ln {label} {dtype}: max/mean abs err {errs}")
    return results


# -- phase 3b: the training kernels against their plain versions ------------------------

# bf16 limits, relative to each grad's largest entry.  Kernel and plain
# version round the same intermediates (da / dy, dO, p, ds * scale, dq / dk
# / dv, dh) to bf16 but sum their fp32 products in another order (the
# tensor cores' fp32 accumulation is not the CUDA cores'), so a rounding can
# land one bf16 ulp (2^-8 relative) apart and carry through a product with
# thousands of terms.  In the FFN a pre-activation within that noise of zero
# can also fall on the other side of the relu mask (a few hundred of the
# 2.9e8 elements), which moves dx of its row by one term dh * W1: the tail of
# dx reaches about 3% of its largest entry there, while every mean stays
# near 1e-5.  A missing rounding point or a wrong dropout mask moves the
# mean by orders of magnitude.
TRAIN_FP32_TOL = 1e-4
TRAIN_BF16_MAX, TRAIN_BF16_MEAN = 2.0 ** -4, 2.0 ** -10
KEEP_TOL = 1e-3
ATTN_GRADS = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dgamma", "dbeta")
FFN_GRADS = ("dx", "dw1", "db1", "dw2", "db2", "dgamma", "dbeta")


def _leaves(tensors):
    return [t.detach().clone().requires_grad_(True) for t in tensors]


def _attn_train_case(fab, B, S, H, nh, eps, dtype, gen, L):
    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    x = rn(B, S, H)
    w = []
    for _ in range(4):
        w += [rn(H, H, std=H ** -0.5), rn(H, std=0.02)]
    gamma = 1 + 0.1 * torch.randn(H, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(H, generator=gen, device="cuda")
    mask = (torch.arange(S, device="cuda") < L).int()[None].expand(B, S).contiguous()
    if B < 8:
        mask[-1] = 0      # a padded batch row: every key masked
    g = rn(B, S, H)
    return [x, *w, gamma, beta], mask, g


def _grouped_attn(grads):
    """(dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo, dgamma, dbeta) -> the
    port's buffers: dW and db of q | k | v as one tensor each."""
    dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo, dgamma, dbeta = grads
    return dict(zip(ATTN_GRADS, (dx, torch.cat((dwq, dwk, dwv)), torch.cat((dbq, dbk, dbv)),
                                 dwo, dbo, dgamma, dbeta)))


def _compare(label, dtype, got, want):
    """Max / mean abs error of each grad, checked against the limits."""
    rows = {}
    for name, w in want.items():
        a, b = got[name].float(), w.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{label}: {name} not finite")
        err = (a - b).abs()
        scale = max(b.abs().max().item(), 1e-30)
        mx, mean = err.max().item(), err.mean().item()
        rows[name] = {"max_abs_err": mx, "mean_abs_err": mean, "max_abs": scale}
        if dtype == torch.float32:
            ok = mx <= TRAIN_FP32_TOL * scale
        else:
            ok = mx <= TRAIN_BF16_MAX * scale and mean <= TRAIN_BF16_MEAN * scale
        if not ok:
            raise AssertionError(f"{label}: {name} max {mx} mean {mean} (max-abs {scale})")
    return rows


def _time_backward(out, leaves, g):
    """CUDA-event median of the backward alone (the forward's graph kept)."""
    return time_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))


def attention_train_check(fab, _build, gen, dtype, rate, B=256, S=560, H=768, nh=8, eps=1e-5,
                          L=N_LABS, timed=False):
    inputs, mask, g = _attn_train_case(fab, B, S, H, nh, eps, dtype, gen, L)
    seed = 1234 if rate else None
    kw = dict(num_heads=nh, ln_eps=eps)
    leaves = _leaves(inputs)
    out = fab.fused_attention_block_ln(*leaves, mask, rate=rate, deterministic=not rate,
                                       seed=seed, **kw)
    grads = torch.autograd.grad(out, leaves, g, retain_graph=timed)
    with torch.no_grad():
        out_p, res = fab.fused_attention_block_ln_reference(*inputs, mask, rate=rate, seed=seed,
                                                            return_residuals=True, **kw)
        x, wq, _, wk, _, wv, _, wo, _, gamma, _ = inputs
        plain = lambda: fab.fused_attention_block_ln_backward_reference(  # noqa: E731
            g, x, res["qkv"], res["o"], res["z"], wq, wk, wv, wo, gamma, mask, rate=rate,
            seed=seed, **kw)
        grads_p = plain()
    label = f"attention B{B} S{S} {H // nh}x{nh} {dtype} rate {rate}"
    errs = _compare(label, dtype, {"out": out, **_grouped_attn(grads)},
                    {"out": out_p, **_grouped_attn(grads_p)})
    row = {"case": label, "errors": errs}
    if rate:
        row["same_seed_identical"] = bool(torch.equal(out, fab.fused_attention_block_ln(
            *inputs, mask, rate=rate, deterministic=False, seed=seed, **kw)))
        row["other_seed_differs"] = not torch.equal(out, fab.fused_attention_block_ln(
            *inputs, mask, rate=rate, deterministic=False, seed=seed + 1, **kw))
        if not (row["same_seed_identical"] and row["other_seed_differs"]):
            raise AssertionError(f"{label}: dropout not reproducible per seed {row}")
    if timed:
        from fairmultimodal_torch.utils.rng import Dropout
        drop = Dropout.make(seed, 0, rate)
        with torch.no_grad():
            fwd, _, saved = fab.half_layer_stages(*inputs, mask, dropout=drop, residuals=True,
                                                  **kw)
            for _, fn in fwd:
                fn()
            bwd, bwd_grads = fab.backward_stages(g, saved, inputs[7], inputs[9], dropout=drop,
                                                 **kw)
            row["fwd_res_ms"] = time_ms(lambda: [fn() for _, fn in fwd])
            row["ms"] = time_ms(lambda: [fn() for _, fn in bwd])
            row["stages_ms"] = {name: time_ms(fn) for name, fn in bwd}
            row["deterministic"] = _runs_bit_identical(lambda: fab._run(bwd), bwd_grads)
            if not row["deterministic"]:
                raise AssertionError(f"{label}: two backward runs differ")
            row["plain_ms"] = time_ms(plain, reps=5)
        row["library_ms"] = _attention_library_bwd_ms(inputs, mask, g, nh, eps, rate)
        flops = B * (16 * S * H * H + 8 * S * S * H)
        nbytes = (8 * B * S * H + 4 * H * H) * x.element_size()
        row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
        row["flops"], row["bytes"] = flops, nbytes
    del out, grads, grads_p, res
    torch.cuda.empty_cache()
    return row


def _attention_library_bwd_ms(inputs, mask, g, nh, eps, rate):
    F = torch.nn.functional
    leaves = _leaves(inputs)
    x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta = leaves
    B, S, H = x.shape
    d = H // nh
    bias = torch.where(mask > 0, 0.0, -1e9).to(x.dtype)[:, None, None, :]
    qkv = F.linear(x, torch.cat((wq, wk, wv)), torch.cat((bq, bk, bv))).view(B, S, 3, nh, d)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    y = F.dropout(F.linear(o.transpose(1, 2).reshape(B, S, H), wo, bo), rate)
    out = F.layer_norm(x + y, (H,), gamma.to(x.dtype), beta.to(x.dtype), eps)
    return _time_backward(out, leaves, g)


def ffn_train_check(ffn, _build, gen, dtype, rate, R=256 * 560, H=768, F=2048, act="relu",
                    eps=1e-5, timed=False):
    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    inputs = [rn(R, H), rn(F, H, std=H ** -0.5), rn(F, std=0.02), rn(H, F, std=F ** -0.5),
              rn(H, std=0.02), 1 + 0.1 * torch.randn(H, generator=gen, device="cuda"),
              0.1 * torch.randn(H, generator=gen, device="cuda")]
    g = rn(R, H)
    seeds = (21, 22) if rate else None
    kw = dict(activation=act, ln_eps=eps)
    leaves = _leaves(inputs)
    out = ffn.fused_ffn_ln(*leaves, rate=rate, deterministic=not rate, seeds=seeds, **kw)
    grads = torch.autograd.grad(out, leaves, g, retain_graph=timed)
    with torch.no_grad():
        out_p, res = ffn.fused_ffn_ln_reference(*inputs, rate=rate, seeds=seeds,
                                                return_residuals=True, **kw)
        plain = lambda: ffn.fused_ffn_ln_backward_reference(  # noqa: E731
            g, inputs[0], res["hd"], res["z"], inputs[1], inputs[3], inputs[5], rate=rate,
            seeds=seeds, **kw)
        grads_p = plain()
    label = f"ffn R{R} F{F} {act} {dtype} rate {rate}"
    errs = _compare(label, dtype, {"out": out, **dict(zip(FFN_GRADS, grads))},
                    {"out": out_p, **dict(zip(FFN_GRADS, grads_p))})
    row = {"case": label, "errors": errs}
    if rate:
        again = ffn.fused_ffn_ln(*inputs, rate=rate, deterministic=False, seeds=seeds, **kw)
        other = ffn.fused_ffn_ln(*inputs, rate=rate, deterministic=False,
                                 seeds=(seeds[0] + 7, seeds[1] + 7), **kw)
        row["same_seed_identical"] = bool(torch.equal(out, again))
        row["other_seed_differs"] = not torch.equal(out, other)
        if not (row["same_seed_identical"] and row["other_seed_differs"]):
            raise AssertionError(f"{label}: dropout not reproducible per seed {row}")
    if timed:
        inner, outer = ffn._streams(seeds, rate, act)
        with torch.no_grad():
            fwd, _, saved = ffn.half_layer_stages(*inputs, inner=inner, outer=outer,
                                                  residuals=True, **kw)
            for _, fn in fwd:
                fn()
            bwd, _ = ffn.backward_stages(g, saved, inputs[1], inputs[3], inputs[5], outer=outer,
                                         inv_keep=inner.inv_keep, **kw)
            row["fwd_res_ms"] = time_ms(lambda: [fn() for _, fn in fwd])
            row["ms"] = time_ms(lambda: [fn() for _, fn in bwd])
            row["stages_ms"] = {name: time_ms(fn) for name, fn in bwd}
            row["plain_ms"] = time_ms(plain, reps=5)
        row["library_ms"] = _ffn_library_bwd_ms(inputs, g, act, eps, rate)
        flops = 8 * R * H * F
        nbytes = (4 * R * H + R * F) * inputs[0].element_size() + 2 * H * F * 2
        row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
        row["flops"], row["bytes"] = flops, nbytes
    del out, grads, grads_p, res
    torch.cuda.empty_cache()
    return row


def _ffn_library_bwd_ms(inputs, g, act, eps, rate):
    F = torch.nn.functional
    leaves = _leaves(inputs)
    x, w1, b1, w2, b2, gamma, beta = leaves
    fact = F.relu if act == "relu" else F.gelu
    y = F.dropout(F.linear(F.dropout(fact(F.linear(x, w1, b1)), rate), w2, b2), rate)
    out = F.layer_norm(x + y, (x.shape[1],), gamma.to(x.dtype), beta.to(x.dtype), eps)
    return _time_backward(out, leaves, g)


def dropout_keep_fractions(rng_mod):
    """Kept fraction of each Philox stream of the lab layer at rate 0.1:
    attention output and FFN outer [R, H], FFN inner [R, F]."""
    R, H, F = 256 * 560, 768, 2048
    fr = {}
    for name, seed, stream, shape in (("attn_out", 1234, 0, (R, H)), ("ffn_inner", 21, 0, (R, F)),
                                      ("ffn_outer", 22, 1, (R, H))):
        fr[name] = rng_mod.dropout_mask(seed, stream, shape, 0.1, "cuda").float().mean().item()
        if abs(fr[name] - 0.9) > KEEP_TOL:
            raise AssertionError(f"dropout stream {name}: kept fraction {fr[name]}")
    return fr


def train_kernel_phase(fab, ffn, _build):
    from fairmultimodal_torch.utils import rng as rng_mod

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {"attention": [], "ffn": []}
    for dtype in (torch.float32, torch.bfloat16):
        for rate in (0.0, 0.1):
            timed = dtype == torch.bfloat16 and rate > 0
            for kind, check, mod in (("attention", attention_train_check, fab),
                                     ("ffn", ffn_train_check, ffn)):
                row = check(mod, _build, gen, dtype, rate, timed=timed)
                log(f"[train-kernels] {json.dumps(row)}")
                rows[kind].append(row)
        # gelu branch of the FFN backward, errors only, at a reduced text shape
        for rate in (0.0, 0.1):
            row = ffn_train_check(ffn, _build, gen, dtype, rate, R=8 * 512, F=3072, act="gelu",
                                  eps=1e-12)
            log(f"[train-kernels] {json.dumps(row)}")
        # Off the main path, errors only: 600 rows (a weight-grad reduction
        # with a ragged last slice), S 200 (a ragged key / query tile) and
        # head dim 12 (element loads, head pad 32), with a fully masked row.
        row = attention_train_check(fab, _build, gen, dtype, 0.1, B=3, S=200, nh=64, L=190,
                                    eps=1e-12)
        log(f"[train-kernels] {json.dumps(row)}")
        row = ffn_train_check(ffn, _build, gen, dtype, 0.1, R=600)
        log(f"[train-kernels] {json.dumps(row)}")
    keep = dropout_keep_fractions(rng_mod)
    log(f"[train-kernels] kept fractions at rate 0.1: {json.dumps(keep)}")
    return rows, keep


# -- phase 3c: the unfolded kernels (Pallas #5-#8) against their plain versions -------------
#
# Limits: fp32 forward max abs error FP32_TOL (only summation order differs);
# every bf16 output and every grad against the limits of _compare, relative
# to its largest entry (TRAIN_FP32_TOL; bf16 TRAIN_BF16_MAX / TRAIN_BF16_MEAN,
# for the reason given there: the same intermediates are rounded to bf16 on
# both sides, summed in another order).  The glue's LayerNorm outputs take
# phase 3's bf16 limits.

BLOCK_GRADS = ("dx", "dwqkv", "dbqkv", "dwo", "dbo")
UFFN_GRADS = ("dx", "dw1", "db1", "dw2", "db2")


def _grouped_block(grads):
    dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo = grads
    return dict(zip(BLOCK_GRADS, (dx, torch.cat((dwq, dwk, dwv)), torch.cat((dbq, dbk, dbv)),
                                  dwo, dbo)))


def _runs_bit_identical(run, outs):
    """Whether ``run()`` twice leaves the same bits in ``outs`` (no float
    atomics: the sums are taken in a fixed order)."""
    run()
    first = [t.clone() for t in outs]
    run()
    return all(torch.equal(a, b) for a, b in zip(first, outs))


def _check_forward(label, dtype, out, want):
    if dtype == torch.float32:
        err = (out.float() - want.float()).abs()
        if not torch.isfinite(out).all() or err.max().item() > FP32_TOL:
            raise AssertionError(f"{label}: forward max abs err {err.max().item()}")
        return {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item()}
    return _compare(label, dtype, {"out": out}, {"out": want})["out"]


def block_check(fab, gen, dtype, B=256, S=560, H=768, nh=8, L=N_LABS, timed=False):
    """#5 and #6 through ``fused_attention_block`` and its autograd.Function
    against the plain forward and backward."""
    inputs, mask, g = _attn_train_case(fab, B, S, H, nh, 0.0, dtype, gen, L)
    inputs = inputs[:9]                       # x and the four projections, no LayerNorm
    x, wq, _, wk, _, wv, _, wo, _ = inputs
    kw = dict(num_heads=nh)
    label = f"block B{B} S{S} {H // nh}x{nh} {dtype}"
    with torch.no_grad():
        out_p, res = fab.fused_attention_block_reference(*inputs, mask, return_residuals=True,
                                                         **kw)
        fwd = _check_forward(label, dtype, fab.fused_attention_block(*inputs, mask, **kw), out_p)
    leaves = _leaves(inputs)
    out = fab.fused_attention_block(*leaves, mask, **kw)
    grads = torch.autograd.grad(out, leaves, g)
    plain = lambda: fab.fused_attention_block_backward_reference(   # noqa: E731
        g, x, res["qkv"], res["o"], wq, wk, wv, wo, mask, **kw)
    with torch.no_grad():
        grads_p = plain()
    errs = _compare(label, dtype, {"out": out, **_grouped_block(grads)},
                    {"out": out_p, **_grouped_block(grads_p)})
    row = {"case": label, "forward": fwd, "errors": errs}
    del out, grads, grads_p
    if timed:
        F = torch.nn.functional
        d = H // nh
        bias = torch.where(mask > 0, 0.0, -1e9).to(dtype)[:, None, None, :]

        def library(xx, q_w, q_b, k_w, k_b, v_w, v_b, o_w, o_b):
            qkv = F.linear(xx, torch.cat((q_w, k_w, v_w)), torch.cat((q_b, k_b, v_b)))
            q, k, v = (t.transpose(1, 2) for t in qkv.view(B, S, 3, nh, d).unbind(2))
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
            return F.linear(o.transpose(1, 2).reshape(B, S, H), o_w, o_b)

        with torch.no_grad():
            infer, _, _ = fab.block_stages(*inputs, mask, **kw)
            fwd_res, _, saved = fab.block_stages(*inputs, mask, residuals=True, **kw)
            fab._run(fwd_res)
            bwd, bwd_grads = fab.block_backward_stages(g, saved, wo, **kw)
            row["ms"] = time_ms(lambda: fab._run(infer))
            row["stages_ms"] = {name: time_ms(fn) for name, fn in infer}
            row["fwd_res_ms"] = time_ms(lambda: fab._run(fwd_res))
            row["bwd_ms"] = time_ms(lambda: fab._run(bwd))
            row["bwd_stages_ms"] = {name: time_ms(fn) for name, fn in bwd}
            row["bwd_deterministic"] = _runs_bit_identical(lambda: fab._run(bwd), bwd_grads)
            if not row["bwd_deterministic"]:
                raise AssertionError(f"{label}: two backward runs differ")
            row["plain_ms"] = time_ms(lambda: fab.fused_attention_block_reference(
                *inputs, mask, **kw), reps=5)
            row["plain_bwd_ms"] = time_ms(plain, reps=5)
            row["library_ms"] = time_ms(lambda: library(*inputs))
        lib_leaves = _leaves(inputs)
        row["library_bwd_ms"] = _time_backward(library(*lib_leaves), lib_leaves, g)
        e = x.element_size()
        flops = B * (8 * S * H * H + 4 * S * S * H)
        nbytes = 2 * B * S * H * e + 4 * H * H * e + B * S * 4
        row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
        flops_b = B * (16 * S * H * H + 8 * S * S * H)
        nbytes_b = (7 * B * S * H + 8 * H * H) * e
        row["bwd_bound_ms"], row["bwd_bound_by"] = bound_ms(flops_b, nbytes_b)
        row["flops"], row["bytes"], row["bwd_flops"], row["bwd_bytes"] = \
            flops, nbytes, flops_b, nbytes_b
        del saved, fwd_res, bwd, infer, lib_leaves
    del res, out_p
    torch.cuda.empty_cache()
    return row


def unfolded_ffn_check(ffn, gen, dtype, rate, R=256 * 560, H=768, F=2048, act="relu",
                       timed=False):
    """#7 and #8 through ``fused_ffn`` and its autograd.Function against the
    plain forward and backward, with the inner dropout at ``rate``."""
    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    inputs = [rn(R, H), rn(F, H, std=H ** -0.5), rn(F, std=0.02), rn(H, F, std=F ** -0.5),
              rn(H, std=0.02)]
    x, w1, b1, w2, b2 = inputs
    g = rn(R, H)
    seed = 21 if rate else None
    kw = dict(activation=act, rate=rate)
    label = f"ffn R{R} F{F} {act} {dtype} rate {rate}"
    with torch.no_grad():
        out_p, res = ffn.fused_ffn_reference(*inputs, seed=seed, return_residuals=True, **kw)
        fwd = _check_forward(label, dtype, ffn.fused_ffn(*inputs, deterministic=not rate,
                                                        seed=seed, **kw), out_p)
    leaves = _leaves(inputs)
    out = ffn.fused_ffn(*leaves, deterministic=not rate, seed=seed, **kw)
    grads = torch.autograd.grad(out, leaves, g)
    plain = lambda: ffn.fused_ffn_backward_reference(g, x, res["hd"], w1, w2,   # noqa: E731
                                                     seed=seed, **kw)
    with torch.no_grad():
        grads_p = plain()
    errs = _compare(label, dtype, {"out": out, **dict(zip(UFFN_GRADS, grads))},
                    {"out": out_p, **dict(zip(UFFN_GRADS, grads_p))})
    row = {"case": label, "forward": fwd, "errors": errs}
    if rate:
        with torch.no_grad():
            again = ffn.fused_ffn(*inputs, deterministic=False, seed=seed, **kw)
            other = ffn.fused_ffn(*inputs, deterministic=False, seed=seed + 7, **kw)
        row["same_seed_identical"] = bool(torch.equal(out, again))
        row["other_seed_differs"] = not torch.equal(out, other)
        if not (row["same_seed_identical"] and row["other_seed_differs"]):
            raise AssertionError(f"{label}: dropout not reproducible per seed {row}")
        del again, other
    del out, grads, grads_p
    if timed:
        Fn = torch.nn.functional
        fact = Fn.relu if act == "relu" else Fn.gelu

        def library(xx, a_w, a_b, b_w, b_b):
            return Fn.linear(Fn.dropout(fact(Fn.linear(xx, a_w, a_b)), rate), b_w, b_b)

        inner = ffn._inner_stream(seed, rate, not rate, act)
        with torch.no_grad():
            infer, _, _ = ffn.ffn_stages(*inputs, activation=act, inner=inner)
            fwd_res, _, saved = ffn.ffn_stages(*inputs, activation=act, inner=inner,
                                               residuals=True)
            ffn._run(fwd_res)
            bwd, _ = ffn.ffn_backward_stages(g, saved, w1, w2, activation=act,
                                             inv_keep=inner.inv_keep)
            row["ms"] = time_ms(lambda: ffn._run(infer))
            row["stages_ms"] = {name: time_ms(fn) for name, fn in infer}
            row["fwd_res_ms"] = time_ms(lambda: ffn._run(fwd_res))
            row["bwd_ms"] = time_ms(lambda: ffn._run(bwd))
            row["bwd_stages_ms"] = {name: time_ms(fn) for name, fn in bwd}
            row["plain_ms"] = time_ms(lambda: ffn.fused_ffn_reference(*inputs, seed=seed, **kw),
                                      reps=5)
            row["plain_bwd_ms"] = time_ms(plain, reps=5)
            row["library_ms"] = time_ms(lambda: library(*inputs))
        lib_leaves = _leaves(inputs)
        row["library_bwd_ms"] = _time_backward(library(*lib_leaves), lib_leaves, g)
        e = x.element_size()
        flops = 4 * R * H * F
        nbytes = (2 * R * H + 2 * H * F) * e
        row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
        flops_b = 8 * R * H * F
        nbytes_b = (3 * R * H + R * F + 4 * H * F) * e
        row["bwd_bound_ms"], row["bwd_bound_by"] = bound_ms(flops_b, nbytes_b)
        row["flops"], row["bytes"], row["bwd_flops"], row["bwd_bytes"] = \
            flops, nbytes, flops_b, nbytes_b
        del saved, fwd_res, bwd, infer, lib_leaves
    del res, out_p
    torch.cuda.empty_cache()
    return row


def glue_check(addnorm, gen, dtype, R=256 * 560, H=768, rate=0.1, timed=False):
    """The unfolded layer's dropout + residual + LayerNorm (the row kernels
    with y and dz in the io dtype) against its plain version."""
    from fairmultimodal_torch.utils.rng import Dropout

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    inputs = [rn(R, H), rn(R, H, std=0.3), 1 + 0.1 * torch.randn(H, generator=gen, device="cuda"),
              0.1 * torch.randn(H, generator=gen, device="cuda")]
    g = rn(R, H)
    kw = dict(eps=1e-5, dropout=Dropout.make(1234, 0, rate))
    label = f"dropout_add_layernorm R{R} {dtype} rate {rate}"
    with torch.no_grad():
        out = addnorm.dropout_add_layernorm(*inputs, **kw)
        want = addnorm.dropout_add_layernorm_reference(*inputs, **kw)
    errs = (out.float() - want.float()).abs()
    fwd = {"max_abs_err": errs.max().item(), "mean_abs_err": errs.mean().item()}
    lim = (FP32_TOL, 1.0) if dtype == torch.float32 else (BF16_MAX_TOL, BF16_MEAN_TOL)
    if fwd["max_abs_err"] > lim[0] or fwd["mean_abs_err"] > lim[1]:
        raise AssertionError(f"{label}: forward {fwd}")
    leaves = _leaves(inputs)
    grads = torch.autograd.grad(addnorm.dropout_add_layernorm(*leaves, **kw), leaves, g)
    leaves_p = _leaves(inputs)
    grads_p = torch.autograd.grad(addnorm.dropout_add_layernorm_reference(*leaves_p, **kw),
                                  leaves_p, g)
    names = ("dx", "dy", "dgamma", "dbeta")
    row = {"case": label, "forward": fwd,
           "errors": _compare(label, dtype, dict(zip(names, grads)), dict(zip(names, grads_p)))}
    if timed:
        with torch.no_grad():
            row["ms"] = time_ms(lambda: addnorm.dropout_add_layernorm(*inputs, **kw))
        row["bwd_ms"] = _time_backward(addnorm.dropout_add_layernorm(*leaves, **kw), leaves, g)
    del grads, grads_p, leaves, leaves_p
    torch.cuda.empty_cache()
    return row


def unfolded_kernel_phase(fab, ffn, addnorm):
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {"block": [], "ffn": [], "glue": []}
    for dtype in (torch.float32, torch.bfloat16):
        timed = dtype == torch.bfloat16
        cases = [("block", lambda: block_check(fab, gen, dtype, timed=timed)),
                 # off the main path: head dim 64, S 272, a fully masked row
                 ("block", lambda: block_check(fab, gen, dtype, B=4, S=272, nh=12, L=250)),
                 ("ffn", lambda: unfolded_ffn_check(ffn, gen, dtype, 0.0)),
                 ("ffn", lambda: unfolded_ffn_check(ffn, gen, dtype, 0.1, timed=timed)),
                 ("ffn", lambda: unfolded_ffn_check(ffn, gen, dtype, 0.0, R=64 * 512, F=3072,
                                                    act="gelu")),
                 ("ffn", lambda: unfolded_ffn_check(ffn, gen, dtype, 0.1, R=600)),
                 ("glue", lambda: glue_check(addnorm, gen, dtype, timed=timed))]
        for kind, check in cases:
            row = check()
            log(f"[unfolded-kernels] {json.dumps(row)}")
            rows[kind].append(row)
    return rows


# -- phase 3c, continued: each bf16 "nt" GEMM stage of the path beside F.linear -------------
#
# One launch of ``_build.gemm`` (layout "nt": csrc/gemm.cu::gemm_nt_wgmma_kernel)
# at each shape the main path gives it, held against the same product and
# epilogue computed in fp32 on the card (TF32 off) and rounded once, and
# timed beside one ``F.linear`` on the same operands (cuBLAS; a yardstick the
# port never calls), each with its achieved TFLOP/s.  Limits, relative to the
# output's largest entry: bf16 out NT_BF16_MAX (one bf16 ulp: both round an
# fp32 sum of the same products, taken in another order) and mean
# TRAIN_BF16_MEAN; fp32 out NT_F32_TOL (summation order only).  Then the
# Philox mapping element for element: W1 with relu and inner dropout, its bias
# large enough that no pre-activation is near zero (relu zeroes nothing),
# must zero exactly the elements that ``utils.rng.dropout_mask`` drops.

NT_BF16_MAX, NT_F32_TOL = 2.0 ** -7, 1e-5
NT_SEED = 21
R_LAB, R_TEXT = 256 * 560, 32 * 512
# name, M, N, K, activation, inner-dropout rate, aux, fp32 out, timed
NT_STAGES = (
    ("qkv lab", R_LAB, 2304, 768, "none", 0.0, False, False, True),
    ("wo lab", R_LAB, 768, 768, "none", 0.0, False, False, True),
    ("wo lab fp32 out", R_LAB, 768, 768, "none", 0.0, False, True, True),
    ("w1 lab relu dropout aux", R_LAB, 2048, 768, "relu", 0.1, True, False, True),
    ("w2 lab", R_LAB, 768, 2048, "none", 0.0, False, False, True),
    ("qkv text S512", R_TEXT, 2304, 768, "none", 0.0, False, False, True),
    ("w1 text gelu aux", R_TEXT, 3072, 768, "gelu", 0.0, True, False, False),
    ("ragged M600 N200 K96", 600, 200, 96, "relu", 0.1, True, False, False),
)


def _nt_plain(a, w, bias, act, drop, out_dtype):
    """The "nt" GEMM's epilogue in fp32 on the same inputs: (out, aux)."""
    from fairmultimodal_torch.utils import rng

    pre = torch.addmm(bias, a.float(), w.float().t())
    v = torch.relu(pre) if act == "relu" else \
        torch.nn.functional.gelu(pre) if act == "gelu" else pre
    return rng.apply_dropout(v, drop).to(out_dtype), pre.to(a.dtype)


def _rel_errors(got, want):
    err = (got.float() - want.float()).abs()
    scale = max(want.float().abs().max().item(), 1e-30)
    return {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(), "max_abs": scale}


def nt_gemm_check(_build, gen, name, M, N, K, act, rate, with_aux, out_f32, timed,
                  bias_shift=0.0):
    from fairmultimodal_torch.utils.rng import Dropout

    bf = torch.bfloat16
    a = torch.randn(M, K, generator=gen, device="cuda").to(bf)
    w = (torch.randn(N, K, generator=gen, device="cuda") * K ** -0.5).to(bf)
    bias = 0.02 * torch.randn(N, generator=gen, device="cuda") + bias_shift
    drop = Dropout.make(NT_SEED, 0, rate)
    out = torch.empty(M, N, device="cuda", dtype=torch.float32 if out_f32 else bf)
    aux = torch.empty(M, N, device="cuda", dtype=bf) if with_aux else None
    run = lambda: _build.gemm(a, w, out, bias=bias, activation=act, dropout=drop,  # noqa: E731
                              aux=aux)
    run()
    torch.cuda.synchronize()
    want, want_aux = _nt_plain(a, w, bias, act, drop, out.dtype)
    row = {"stage": name, "M": M, "N": N, "K": K, "activation": act, "dropout": rate,
           "out": "float32" if out_f32 else "bfloat16", "errors": _rel_errors(out, want)}
    checks = [("out", row["errors"])]
    if with_aux:
        row["aux_errors"] = _rel_errors(aux, want_aux)
        checks.append(("aux", row["aux_errors"]))
    for what, e in checks:
        if not torch.isfinite(out).all() or (
                e["max_abs_err"] > NT_F32_TOL * e["max_abs"] if out_f32 and what == "out" else
                e["max_abs_err"] > NT_BF16_MAX * e["max_abs"]
                or e["mean_abs_err"] > TRAIN_BF16_MEAN * e["max_abs"]):
            raise AssertionError(f"nt gemm {name}: {what} {e}")
    if bias_shift:
        kept = out != 0
        row["zeroed_as_plain"] = bool(torch.equal(kept, want != 0))
        row["kept_fraction"] = kept.float().mean().item()
        row["min_pre_activation"] = want_aux.float().min().item()
        if not row["min_pre_activation"] > 0 or not row["zeroed_as_plain"]:
            raise AssertionError(f"nt gemm {name}: dropout mask differs from the plain one {row}")
    del want, want_aux
    if timed:
        flops = 2 * M * N * K
        bias_io = bias.to(bf)
        row["ms"] = time_ms(run)
        row["tflops"] = flops / row["ms"] / 1e9
        row["library_ms"] = time_ms(lambda: torch.nn.functional.linear(a, w, bias_io))
        row["library_tflops"] = flops / row["library_ms"] / 1e9
        nbytes = (M * K + N * K) * 2 + M * N * out.element_size() * (2 if with_aux else 1)
        row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
    del a, w, out, aux
    torch.cuda.empty_cache()
    return row


def nt_gemm_phase(_build):
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for stage in NT_STAGES:
        row = nt_gemm_check(_build, gen, *stage)
        log(f"[nt-gemm] {json.dumps(row)}")
        rows.append(row)
    # The Philox mapping, element for element: no pre-activation near zero.
    row = nt_gemm_check(_build, gen, "w1 lab relu dropout, bias +8", R_LAB, 2048, 768, "relu", 0.1,
                        True, False, False, bias_shift=8.0)
    log(f"[nt-gemm] {json.dumps(row)}")
    rows.append(row)
    return rows


# -- phase 3c, continued: each bf16 "nn" / "tn" GEMM stage of the backward -----------------
#
# Each bf16 backward product of the lab path alone, at its shape: "nn" through
# ``_build.gemm`` (csrc/gemm.cu::gemm_wgmma_kernel with B MN-major) with the
# epilogue the path gives it, "tn" through ``fused_attention_block.weight_grad``
# (the same kernel with both operands MN-major, split-K fp32 partials and
# their fixed-order sum), held against the same product and epilogue in fp32
# on the card, rounded once.  Limits as the "nt" stages: NT_BF16_MAX (one bf16
# ulp of max-abs) and mean TRAIN_BF16_MEAN; the gated stages' column sums
# (fp32, summed over 143360 rows in another order) TRAIN_FP32_TOL of their
# max-abs; the dgelu gate's aux (round(gelu(gate))) one bf16 ulp.  Timed
# beside one ``torch.matmul`` on the same operands (cuBLAS; a yardstick the
# port never calls), each with its TFLOP/s.

# name, layout, M, N, K, gate ("relu" | "dgelu" | None), fp32 residual, timed
NN_TN_STAGES = (
    ("dO attention", "nn", R_LAB, 768, 768, None, False, True),
    ("dx attention", "nn", R_LAB, 768, 2304, None, False, True),
    ("dx attention + resid", "nn", R_LAB, 768, 2304, None, True, True),
    ("dh ffn relu gate + colpart", "nn", R_LAB, 2048, 768, "relu", False, True),
    ("dx ffn", "nn", R_LAB, 768, 2048, None, False, True),
    ("dWo split-K", "tn", 768, 768, R_LAB, None, False, True),
    ("dWqkv split-K", "tn", 2304, 768, R_LAB, None, False, True),
    ("dW1 split-K", "tn", 2048, 768, R_LAB, None, False, True),
    ("dW2 split-K", "tn", 768, 2048, R_LAB, None, False, True),
    ("dh text dgelu gate + aux", "nn", R_TEXT, 3072, 768, "dgelu", False, False),
    ("ragged nn M600 N200 K96 relu gate", "nn", 600, 200, 96, "relu", False, False),
    ("ragged tn M600 N200 K5000", "tn", 600, 200, 5000, None, False, False),
)
GATE_SCALE = 1.0 / 0.9     # the relu gate's 1 / keep with the inner dropout on


def _nn_tn_plain(layout, a, b, gate, gate_kind, resid, out_dtype):
    """The product and its epilogue in fp32: (out, aux, column sums)."""
    v = a.float() @ b.float() if layout == "nn" else a.float().t() @ b.float()
    aux = colsum = None
    if gate_kind == "relu":
        v = v * torch.where(gate.float() > 0, GATE_SCALE, 0.0)
    elif gate_kind == "dgelu":
        u = gate.float()
        v = v * (0.5 * (1.0 + torch.erf(u * 0.70710678118654752))
                 + u * 0.3989422804014327 * torch.exp(-0.5 * u * u))
        aux = torch.nn.functional.gelu(u).to(a.dtype)
    if resid is not None:
        v = v + resid
    if gate_kind:
        colsum = v.sum(dim=0)
    return v.to(out_dtype), aux, colsum


def nn_tn_gemm_check(_build, fab, gen, name, layout, M, N, K, gate_kind, with_resid, timed):
    bf = torch.bfloat16
    a_shape = (M, K) if layout == "nn" else (K, M)
    a = torch.randn(*a_shape, generator=gen, device="cuda").to(bf)
    b = (torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5).to(bf)
    gate = torch.randn(M, N, generator=gen, device="cuda").to(bf) if gate_kind else None
    resid = torch.randn(M, N, generator=gen, device="cuda") if with_resid else None
    out = torch.empty(M, N, device="cuda", dtype=bf)
    aux = torch.empty(M, N, device="cuda", dtype=bf) if gate_kind == "dgelu" else None
    colpart = torch.empty(-(-M // 128), N, device="cuda") if gate_kind else None
    if layout == "tn":
        run = lambda: fab.weight_grad(a, b, out)  # noqa: E731
    else:
        run = lambda: _build.gemm(  # noqa: E731
            a, b, out, layout="nn", gate=gate, gate_kind=gate_kind,
            gate_scale=GATE_SCALE if gate_kind == "relu" else 1.0, aux=aux, resid=resid,
            colpart=colpart)
    run()
    torch.cuda.synchronize()
    want, want_aux, want_sum = _nn_tn_plain(layout, a, b, gate, gate_kind, resid, bf)
    row = {"stage": name, "layout": layout, "M": M, "N": N, "K": K, "gate": gate_kind,
           "resid": with_resid, "errors": _rel_errors(out, want)}
    if layout == "tn":
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        row["splits"] = fab._splits(M, N, K, sms)
    checks = [("out", row["errors"], NT_BF16_MAX)]
    if aux is not None:
        row["aux_errors"] = _rel_errors(aux, want_aux)
        checks.append(("aux", row["aux_errors"], NT_BF16_MAX))
    if colpart is not None:
        row["colsum_errors"] = _rel_errors(colpart.sum(dim=0), want_sum)
        checks.append(("column sums", row["colsum_errors"], TRAIN_FP32_TOL))
    for what, e, lim in checks:
        if not torch.isfinite(out).all() or e["max_abs_err"] > lim * e["max_abs"] \
                or e["mean_abs_err"] > TRAIN_BF16_MEAN * e["max_abs"]:
            raise AssertionError(f"{layout} gemm {name}: {what} {e}")
    del want, want_aux, want_sum
    if timed:
        flops = 2 * M * N * K
        row["ms"] = time_ms(run)
        row["tflops"] = flops / row["ms"] / 1e9
        lib = (lambda: torch.matmul(a, b)) if layout == "nn" else (lambda: torch.matmul(a.t(), b))
        row["library_ms"] = time_ms(lib)
        row["library_tflops"] = flops / row["library_ms"] / 1e9
        nbytes = (M * K + K * N + M * N) * 2 + (M * N * 2 if gate is not None else 0) \
            + (M * N * 4 if resid is not None else 0)
        row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
    del a, b, gate, resid, out, aux, colpart
    torch.cuda.empty_cache()
    return row


def nn_tn_gemm_phase(_build, fab):
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for stage in NN_TN_STAGES:
        row = nn_tn_gemm_check(_build, fab, gen, *stage)
        log(f"[nn-tn-gemm] {json.dumps(row)}")
        rows.append(row)
    return rows


#: The kernels the bf16 path redesigned for Hopper, whose ``-Xptxas -v`` lines phase 2 reports.
PTXAS_KERNELS = ("gemm_wgmma_kernel", "flash_attn_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
                 "flash_bwd_dkdv_mma_kernel")


def ptxas_report(_build, names=PTXAS_KERNELS):
    """What ``nvcc -Xptxas -v`` said of each instantiation of ``names``
    (the build's logs): registers, stack, spills, and any warning about
    them."""
    import re

    report = {}
    for lib in _build.build().values():
        current = None
        for line in lib.with_suffix(".log").read_text().splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?",
                          line)
            if m:
                current = m.group(1) if any(n in m.group(1) for n in names) else None
                if current:
                    report.setdefault(current, {})
                continue
            if "warning" in line and any(n in line for n in names + ("setmaxnreg",)):
                report.setdefault("warnings", []).append(line.strip())
            if current is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                report[current].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                       spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[current]["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                report[current]["static_smem"] = int(m.group(1)) if m else 0
    if not any(k != "warnings" for k in report):
        raise AssertionError("ptxas report: no entry for the redesigned kernels in the build logs")
    return report


# -- phase 3d: the flash kernels (Pallas #9 / #10) against their plain versions -------------
#
# Limits, relative to each output's largest entry: fp32 FP32_FLASH_TOL for o,
# dq, dk, dv (only the summation order differs: the kernel's online softmax
# and tiled sums against the plain version's whole-row ones).  bf16 forward
# FLASH_BF16_FWD (max) / TRAIN_BF16_MEAN (mean): the plain version (as the
# TPU kernel) rounds the normalised p to bf16 before p.v, the kernel the
# unnormalised exp(s - m_running) and divides o by the fp32 row sum once at
# the end; both round o to bf16.  The two differ by at most one bf16 rounding
# of each p (2^-8 relative) and of o; four ulps of margin
# (tests/test_torch_flash_forward_contract.py holds the kernel's order
# against the Pallas kernel on the CPU).  bf16 grads TRAIN_BF16_MAX /
# TRAIN_BF16_MEAN, phase 3b's: the
# kernel takes the softmax-VJP row term as rowsum(dO * O) from the stored
# bf16 o, the plain version (as the TPU kernel) rowsum(dP * P); equal for a
# normalised P, in bf16 they differ by about one rounding of the row term,
# and ds * scale and p are rounded to bf16 on both sides from sums taken in
# another order, so a rounding can flip by an ulp and carry into a product
# over S terms.
#
# The bf16 backward is also held against its own order of rounding repeated
# in PyTorch (flash_bwd_kernel_order, on the forward kernel's o and stats;
# tests/test_torch_flash_backward_contract.py holds that function against
# the Pallas kernel on the CPU).  Only fp32 summation orders differ there, so
# an entry may differ by the flip of its final rounding, plus the rare flip
# of a rounded p or ds * scale carried into a sum over S terms; such a flip
# moves a term by 2^-8 of itself, and a large p makes that a visible share of
# an entry near zero.  On the H100 0.03-0.13% of the entries differ, the
# most by one bf16 ulp of an entry near max-abs (at most 3.3e-3 of it).
# Limits: at most FLASH_BWD_ORDER_SHARE of the entries differ at all, and
# each by at most NT_BF16_MAX (one bf16 ulp) of max-abs.  A drift of the
# order shows in the share: D from the unrounded o changes about 18% of dq
# and dk, a p left unrounded before dv 42% of dv.

FP32_FLASH_TOL = 1e-4
FLASH_BF16_FWD = 2.0 ** -6
FLASH_GRADS = ("dq", "dk", "dv")
FLASH_BWD_ORDER_SHARE = 0.01
LOG2E = 1.4426950408889634


def _flash_inputs(B, S, nh, d, layout, mask_kind, dtype, gen):
    """q, k, v as the callers lay them out, all leaves' views: "dense" --
    three [B, S, H] Dense outputs viewed as heads (the layer's); "packed" --
    one [B, S, 3H] buffer split as ``fused_qkv`` splits it; "contiguous" --
    [B, heads, S, d] tensors.  Returns (leaves, q, k, v, mask, g)."""
    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    H = nh * d
    if layout == "dense":
        leaves = [rn(B, S, H).requires_grad_(True) for _ in range(3)]
        q, k, v = (t.view(B, S, nh, d).transpose(1, 2) for t in leaves)
    elif layout == "packed":
        leaves = [rn(B, S, 3 * H).requires_grad_(True)]
        q, k, v = (t.transpose(1, 2) for t in leaves[0].view(B, S, 3, nh, d).unbind(2))
    else:
        leaves = [rn(B, nh, S, d).requires_grad_(True) for _ in range(3)]
        q, k, v = leaves
    if mask_kind == "lab":       # 549 real lab tokens padded to 560, as BEHRTLab expands it
        mask = (torch.arange(S, device="cuda") < N_LABS).int()[None].expand(B, S)
    elif mask_kind == "rows":    # per-row lengths, the last row fully masked
        lens = torch.randint(1, S + 1, (B,), generator=gen, device="cuda")
        lens[-1] = 0
        mask = (torch.arange(S, device="cuda")[None] < lens[:, None]).int()
    else:
        mask = None
    return leaves, q, k, v, mask, rn(B, nh, S, d)


def flash_check(flash, gen, dtype, B, S, nh, d, layout="dense", mask_kind="rows", timed=False):
    """#9 and #10 through ``flash_attention`` and its autograd.Function
    against ``flash_attention_reference`` and
    ``flash_attention_backward_reference`` on the same inputs."""
    leaves, q, k, v, mask, g = _flash_inputs(B, S, nh, d, layout, mask_kind, dtype, gen)
    label = f"flash B{B} S{S} {nh}x{d} {layout} mask {mask_kind} {dtype}"
    out = flash.flash_attention(q, k, v, mask)
    grads = torch.autograd.grad(out, (q, k, v), g)
    with torch.no_grad():
        qd, kd, vd = (t.detach() for t in (q, k, v))
        want = flash.flash_attention_reference(qd, kd, vd, mask)
        want_grads = flash.flash_attention_backward_reference(qd, kd, vd, mask, g)
    got = {"o": out.detach(), **dict(zip(FLASH_GRADS, grads))}
    ref = {"o": want, **dict(zip(FLASH_GRADS, want_grads))}
    rows = {}
    for name, w in ref.items():
        a, b_ = got[name].float(), w.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{label}: {name} not finite")
        err = (a - b_).abs()
        scale = max(b_.abs().max().item(), 1e-30)
        mx, mean = err.max().item(), err.mean().item()
        rows[name] = {"max_abs_err": mx, "mean_abs_err": mean, "max_abs": scale}
        if dtype == torch.float32:
            ok = mx <= FP32_FLASH_TOL * scale
        else:
            lim = FLASH_BF16_FWD if name == "o" else TRAIN_BF16_MAX
            ok = mx <= lim * scale and mean <= TRAIN_BF16_MEAN * scale
        if not ok:
            raise AssertionError(f"{label}: {name} max {mx} mean {mean} (max-abs {scale})")
    row = {"case": label, "errors": rows}
    del out, grads, got, want_grads
    with torch.no_grad():
        ops = flash._operands(qd, kd, vd, mask)
        o, stats = flash._forward_kernel(*ops, residuals=True)
        saved = (*ops[:3], o, stats, ops[3])
        if dtype == torch.bfloat16:
            row["kernel_order"] = _flash_bwd_order_check(flash, label, saved, g)
    if timed:
        F = torch.nn.functional
        with torch.no_grad():
            row["ms"] = time_ms(lambda: flash.flash_attention(qd, kd, vd, mask))
            row["fwd_res_ms"] = time_ms(lambda: flash._forward_kernel(*ops, residuals=True))
            row["bwd_ms"] = time_ms(lambda: flash._backward_kernel(*saved, g))
            row["bwd_stages_ms"] = _flash_bwd_stages_ms(flash, saved, g)
            first = flash._backward_kernel(*saved, g)
            again = flash._backward_kernel(*saved, g)
            row["bwd_deterministic"] = all(torch.equal(a, b_) for a, b_ in zip(first, again))
            if not row["bwd_deterministic"]:
                raise AssertionError(f"{label}: two backward runs differ")
            del first, again
            row["plain_ms"] = time_ms(lambda: flash.flash_attention_reference(qd, kd, vd, mask),
                                      reps=5)
            row["plain_bwd_ms"] = time_ms(lambda: flash.flash_attention_backward_reference(
                qd, kd, vd, mask, g), reps=3)
            bias = None if mask is None else \
                torch.where(mask > 0, 0.0, -1e9).to(dtype)[:, None, None, :]
            row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=bias))
        lib = [t.detach().clone().requires_grad_(True) for t in (qd, kd, vd)]
        row["library_bwd_ms"] = _time_backward(
            F.scaled_dot_product_attention(*lib, attn_mask=bias), lib, g)
        e = qd.element_size()
        mask_bytes = 0 if mask is None else B * S * 4
        flops, nbytes = 4 * B * nh * S * S * d, 4 * B * nh * S * d * e + mask_bytes
        row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
        flops_b, nbytes_b = 10 * B * nh * S * S * d, 7 * B * nh * S * d * e + mask_bytes
        row["bwd_bound_ms"], row["bwd_bound_by"] = bound_ms(flops_b, nbytes_b)
        row["flops"], row["bytes"], row["bwd_flops"], row["bwd_bytes"] = \
            flops, nbytes, flops_b, nbytes_b
        del lib
    del leaves, q, k, v, qd, kd, vd, want, g, ops, o, stats, saved
    torch.cuda.empty_cache()
    return row


def flash_bwd_kernel_order(q, k, v, o, stats, mask, g):
    """dq, dk, dv of the bf16 backward kernels in their order of rounding,
    in PyTorch, from the forward kernel's bf16 o and its stats (m, l):
    D = rowsum(dO * o); p = exp2((s * scale + bias - m) * log2 e) * (1 / l);
    dv = round(p)^T . dO; round(p * (dO . v^T - D) * scale) before dq = . k
    and dk = ^T . q; each grad rounded when written."""
    bf = torch.bfloat16
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    m, l = stats[..., 0:1], stats[..., 1:2]
    D = (gf * o.float()).sum(-1, keepdim=True)
    x = (qf @ kf.transpose(-1, -2)) * scale
    if mask is not None:
        x = x + torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
    p = torch.exp2((x - m) * LOG2E) * (1.0 / l)
    del x
    dv = (p.to(bf).float().transpose(-1, -2) @ gf).to(bf)
    ds = (p * (gf @ vf.transpose(-1, -2) - D) * scale).to(bf).float()
    del p
    return (ds @ kf).to(bf), (ds.transpose(-1, -2) @ qf).to(bf), dv


def _flash_bwd_order_check(flash, label, saved, g):
    """The bf16 backward kernels against :func:`flash_bwd_kernel_order` on
    the same forward residuals: the share of each grad's entries that differ
    (FLASH_BWD_ORDER_SHARE at most) and its largest difference relative to
    its max-abs (NT_BF16_MAX at most)."""
    got = flash._backward_kernel(*saved, g)
    q, k, v, o, stats, mask = saved
    want = flash_bwd_kernel_order(q, k, v, o, stats, mask, g)
    res = {}
    for name, a, w in zip(FLASH_GRADS, got, want):
        a, w = a.float(), w.float()
        rel = (a - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        share = (a != w).float().mean().item()
        res[name] = {"max_rel_err": rel, "differ_share": share}
        if not (rel <= NT_BF16_MAX and share <= FLASH_BWD_ORDER_SHARE):
            raise AssertionError(f"{label}: {name} differs from the kernel's rounding order "
                                 f"by {rel} of max-abs in {share} of the entries (limits "
                                 f"{NT_BF16_MAX}, {FLASH_BWD_ORDER_SHARE})")
    del got, want
    return res


def _flash_bwd_stages_ms(flash, saved, g, reps=10):
    """The flash backward's two kernels timed apart: device time per call of
    the dQ kernel (which writes the row term D) and of the dK / dV kernel
    (which reads it), from torch.profiler over ``reps`` backward calls on
    the forward's residuals."""
    from torch.profiler import ProfilerActivity, profile

    flash._backward_kernel(*saved, g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flash._backward_kernel(*saved, g)
        torch.cuda.synchronize()
    ms = {"flash_bwd_dq": 0.0, "flash_bwd_dkdv": 0.0}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            for name in ms:
                if name in e.key:
                    ms[name] += e.self_device_time_total / 1e3 / reps
    if not all(ms.values()):
        raise AssertionError(f"flash backward stages: the profiler saw {ms}")
    return ms


def fused_qkv_layer_check(gen, B=16, S=560, H=768, nh=8):
    """``TorchEncoderLayer(fused_qkv=True)`` against the same layer unfused,
    the qkv weight concatenated from query / key / value, fp32, train mode
    with dropout on (one generator seed): forward and every grad within
    FP32_FLASH_TOL of its max-abs."""
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.models.behrt import TorchEncoderLayer
    from fairmultimodal_torch.utils.rng import make_generator

    unfused = init_params(TorchEncoderLayer(H, nh, attn_kernel=False), seed=7).cuda().train()
    fused = TorchEncoderLayer(H, nh, fused_qkv=True).cuda().train()
    sd = {k: v for k, v in unfused.state_dict().items()
          if k.split(".")[0] not in ("query", "key", "value")}
    for leaf in ("weight", "bias"):
        sd[f"qkv.{leaf}"] = torch.cat([unfused.state_dict()[f"{n}.{leaf}"]
                                       for n in ("query", "key", "value")])
    fused.load_state_dict(sd, strict=True)
    x = torch.randn(B, S, H, generator=gen, device="cuda")
    mask = (torch.arange(S, device="cuda") < N_LABS).int()[None].expand(B, S)
    g = torch.randn(B, S, H, generator=gen, device="cuda")
    runs = {}
    for name, layer in (("unfused", unfused), ("fused", fused)):
        xx = x.clone().requires_grad_(True)
        out = layer(xx, mask, make_generator(3))
        out.backward(g)
        grads = {n: p.grad for n, p in layer.named_parameters()}
        if name == "fused":
            for leaf in ("weight", "bias"):
                for n, part in zip(("query", "key", "value"), grads.pop(f"qkv.{leaf}").chunk(3)):
                    grads[f"{n}.{leaf}"] = part
        runs[name] = {"out": out.detach(), "x": xx.grad, **grads}
    errs = {}
    for n, w in runs["unfused"].items():
        scale = w.abs().max().item()
        if n == "key.bias":        # zero in exact arithmetic: rounding noise only
            scale = runs["unfused"]["query.bias"].abs().max().item()
        err = (runs["fused"][n] - w).abs().max().item()
        errs[n] = err / scale
        if not err <= FP32_FLASH_TOL * scale:
            raise AssertionError(f"fused_qkv layer: {n} max abs err {err} (max-abs {scale})")
    worst = max(errs, key=errs.get)
    del unfused, fused, runs
    torch.cuda.empty_cache()
    return {"case": f"TorchEncoderLayer fused_qkv vs unfused B{B} S{S} {nh}x{H // nh} fp32",
            "worst": worst, "worst_rel_err": errs[worst]}


def flash_kernel_phase(flash):
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        timed = dtype == torch.bfloat16
        for kw in (dict(B=256, S=560, nh=8, d=96, mask_kind="lab", timed=timed),  # lab
                   dict(B=32, S=512, nh=12, d=64),                                 # text-train
                   dict(B=8, S=256, nh=8, d=32, mask_kind="none"),                 # off the path
                   dict(B=4, S=1024, nh=4, d=128, layout="contiguous"),
                   dict(B=8, S=384, nh=12, d=64, layout="packed")):
            row = flash_check(flash, gen, dtype, **kw)
            log(f"[flash-kernels] {json.dumps(row)}")
            rows.append(row)
    layer = fused_qkv_layer_check(gen)
    log(f"[flash-kernels] {json.dumps(layer)}")
    return rows, layer


# -- phase 4: the serving slice ------------------------------------------------------


def make_cohort(rng, n):
    words = ("patient stable intubated sedated ventilator weaning afebrile lungs clear "
             "bilateral infiltrates sepsis pressors lasix cardiac failure renal improving "
             "deteriorating family meeting comfort care extubated alert oriented pain "
             "controlled discharge planning").split()
    notes = []
    for i in range(n):
        if i % 10 == 9:
            notes.append([])                     # a patient without notes
            continue
        k = 1 + i % 3
        lens = [CHUNK_WORDS[(i + j) % 4] for j in range(k)]
        notes.append([" ".join(rng.choice(words, m)) for m in lens])
    return notes


def bundle_for(featurize, notes, rng):
    n = len(notes)
    return featurize.FeatureBundle(
        subject_id=np.arange(10_000, 10_000 + n, dtype=np.int64),
        age_codes=rng.integers(0, 4, n).astype(np.int32),
        gender_codes=rng.integers(0, 2, n).astype(np.int32),
        ethnicity_codes=rng.integers(0, 5, n).astype(np.int32),
        insurance_codes=rng.integers(0, 6, n).astype(np.int32),
        labs=rng.normal(0, 1, (n, N_LABS)).astype(np.float32),
        labels=np.zeros((n, 3), np.float32), lab_columns=[f"lab_{i}" for i in range(N_LABS)],
        note_chunks=notes)


def expected_text_launches(tokenizer, notes, batch_size, layers):
    """Text-encoder kernel launches per kernel: one per layer per batch of
    the 256 and 512 buckets (rows per batch as in encode_note_chunks)."""
    flat = [c for chunks in notes for c in chunks]
    _, mask = tokenizer.encode_batch(flat, max_length=512)
    buckets = np.searchsorted(np.asarray([64, 128, 256, 512]), mask.sum(axis=1))
    total = 0
    for b_i, b_len in ((2, 256), (3, 512)):
        rows = batch_size * min(8, max(1, 512 // b_len))
        total += -(-int((buckets == b_i).sum()) // rows)
    return total * layers


def slice_phase(fab, ffn):
    from fairmultimodal_torch.data import featurize
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.models.bert import bio_clinical_bert_config
    from fairmultimodal_torch.models.fusion import FAMEModel
    from fairmultimodal_torch.models.text import TextEncoder, encode_note_chunks
    from fairmultimodal_torch.pipelines.fame import build_model_arrays
    from fairmultimodal_torch.pipelines.inference import FAMEPredictor

    bert_config = bio_clinical_bert_config()
    rng = np.random.default_rng(0)
    notes = make_cohort(rng, N_PATIENTS)
    bundle = bundle_for(featurize, notes, rng)
    geo = dict(num_ages=4, num_genders=2, num_ethnicities=5, num_insurances=6,
               lab_token_count=N_LABS, text_embed_size=768, hidden_size=768, demo_layers=12,
               demo_heads=12, lab_layers=2, lab_heads=8, fusion_hidden=512)
    t0 = time.perf_counter()
    model = init_params(FAMEModel(**geo, dtype=torch.bfloat16), seed=0)
    encoder = TextEncoder.from_pretrained(fallback_config=bert_config, dtype=torch.bfloat16,
                                          seed=1, device="cuda")
    predictor = FAMEPredictor(model, batch_size=256, device="cuda")
    log(f"[slice] models built in {time.perf_counter() - t0:.1f} s")

    # The main path, with the launch counters read around it.
    fab.launches = ffn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle.text_embeddings = encode_note_chunks(encoder, notes, max_length=512, batch_size=32)
    t_encode = time.perf_counter() - t0
    text = {"fused_attention_block_ln": fab.launches, "fused_ffn_ln": ffn.launches}
    t0 = time.perf_counter()
    out = predictor.predict_arrays(build_model_arrays(bundle))
    t_predict = time.perf_counter() - t0
    total = {"fused_attention_block_ln": fab.launches, "fused_ffn_ln": ffn.launches}
    lab = {k: total[k] - text[k] for k in total}
    log(f"[slice] encode {len(notes)} patients {t_encode:.3f} s, predict {t_predict:.3f} s "
        f"(host clock, first call); launches text {text} lab {lab}")

    want_text = expected_text_launches(encoder.tokenizer, notes, 32, bert_config.num_hidden_layers)
    want_lab = geo["lab_layers"] * -(-N_PATIENTS // 256)
    for k in total:
        if text[k] != want_text or want_text == 0:
            raise AssertionError(f"{k}: {text[k]} text-encoder launches, expected {want_text}")
        if lab[k] != want_lab:
            raise AssertionError(f"{k}: {lab[k]} lab-encoder launches, expected {want_lab}")
    emb = bundle.text_embeddings
    no_notes = np.asarray([not c for c in notes])
    if emb.shape != (N_PATIENTS, 768) or not np.isfinite(emb).all():
        raise AssertionError(f"text embeddings {emb.shape} not finite")
    if emb[no_notes].any() or not np.abs(emb[~no_notes]).sum(axis=1).all():
        raise AssertionError("text embeddings: zero rows must be exactly the note-less patients")
    probs = out["probs"]
    if probs.shape != (N_PATIENTS, 3) or not np.isfinite(probs).all() \
            or probs.min() < 0 or probs.max() > 1:
        raise AssertionError(f"probabilities {probs.shape} not finite in [0, 1]")
    if not set(np.unique(out["preds"])) <= {0, 1}:
        raise AssertionError("predictions are not 0/1")

    # fp32 on 8 patients with long notes: kernels on the card vs plain on the CPU.
    pick = [i for i, c in enumerate(notes) if len(c) == 3][:8]
    sub_notes = [notes[i] for i in pick]
    sub = bundle_for(featurize, sub_notes, np.random.default_rng(1))
    probs_by_device = {}
    for device in ("cuda", "cpu"):
        m32 = init_params(FAMEModel(**geo, dtype=torch.float32), seed=0)
        enc32 = TextEncoder.from_pretrained(fallback_config=bert_config, seed=1, device=device)
        fab.launches = ffn.launches = 0
        sub.text_embeddings = encode_note_chunks(enc32, sub_notes, max_length=512, batch_size=2)
        pred32 = FAMEPredictor(m32, batch_size=8, device=device)
        probs_by_device[device] = pred32.predict_arrays(build_model_arrays(sub))["probs"]
        counts = (fab.launches, ffn.launches)
        if (device == "cuda") != (min(counts) > 0) or (device == "cpu" and max(counts)):
            raise AssertionError(f"{device}: kernel launches {counts}")
        del m32, enc32, pred32
    diff = float(np.abs(probs_by_device["cuda"] - probs_by_device["cpu"]).max())
    log(f"[slice] fp32 8 patients: max |p_cuda - p_cpu| = {diff:.3e}")
    if not diff <= 1e-4:
        raise AssertionError(f"fp32 card vs CPU probabilities differ by {diff}")

    bench = predictor.benchmark(iters=20)
    log(f"[slice] FAMEPredictor.benchmark bf16: {json.dumps(bench)}")
    return total, {"text": text, "lab": lab, "encode_s": t_encode, "predict_s": t_predict,
                   "fp32_card_vs_cpu_max_abs": diff, "benchmark": bench}


# -- phase 5: the training slice -----------------------------------------------------


def synthetic_cohort(rng, n):
    """Model-input arrays and labels of ``n`` synthetic patients at the
    reference geometry (549 labs, 768-d note embeddings)."""
    return {
        "demo_dummy_ids": np.zeros((n, 1), np.int32),
        "demo_attn_mask": np.ones((n, 1), np.int32),
        "age_ids": rng.integers(0, 4, n).astype(np.int32),
        "gender_ids": rng.integers(0, 2, n).astype(np.int32),
        "ethnicity_ids": rng.integers(0, 5, n).astype(np.int32),
        "insurance_ids": rng.integers(0, 6, n).astype(np.int32),
        "lab_features": rng.normal(0, 1, (n, N_LABS)).astype(np.float32),
        "text_embedding": rng.normal(0, 1, (n, 768)).astype(np.float32),
        "labels": rng.integers(0, 2, (n, 3)).astype(np.float32),
    }


TRAIN_GEO = dict(num_ages=4, num_genders=2, num_ethnicities=5, num_insurances=6,
                 lab_token_count=N_LABS, text_embed_size=768, hidden_size=768, demo_layers=12,
                 demo_heads=12, lab_layers=2, lab_heads=8, fusion_hidden=512)
POS_WEIGHT = np.array([3.0, 1.5, 2.0], np.float32)
N_TRAIN, N_VAL, TRAIN_BATCH, TRAIN_EPOCHS = 1024, 256, 256, 2
# fp32 card vs CPU: the same weights, batch and Philox masks; the card sums
# in other orders (its kernels, cuBLAS-free) than the CPU's plain path, so
# the loss agrees to fp32 rounding (1e-5 relative) and each grad leaf to
# 1e-3 of its largest entry (grads are differences of nearly equal sums).
XDEV_LOSS_TOL, XDEV_GRAD_TOL = 1e-5, 1e-3
#: fp32 one-step results (loss, grads) by configuration, shared by phases 5 and 5b.
FP32_STEPS = {}


def fp32_step_batch(train, keys, n=8):
    sub = {k: v[:n] for k, v in train.items()}
    return {"model_inputs": {k: sub[k] for k in keys}, "labels": sub["labels"],
            "weight": np.ones(n, np.float32)}


def set_fold(model, fold):
    """Set ``fold_ln`` on every encoder layer of ``model`` (None: read
    ``FMTPU_FOLD_LN``)."""
    from fairmultimodal_torch.models.behrt import TorchEncoderLayer

    for layer in model.modules():
        if isinstance(layer, TorchEncoderLayer):
            layer.fold_ln = fold
    return model


def set_flash(model, flash=True):
    """Send every encoder layer of ``model`` down the flash route
    (``attn_kernel=False``: projections, Pallas #9 / #10, dropout + residual
    + LayerNorm), or back to the gates (``flash=False``)."""
    from fairmultimodal_torch.models.behrt import TorchEncoderLayer

    for layer in model.modules():
        if isinstance(layer, TorchEncoderLayer):
            layer.attn_kernel = False if flash else None
    return model


def fp32_train_step(batch, device, fold=None, flash=False):
    """One fp32 ``FAMETrainer.train_step`` with dropout on, at full width,
    from seed-0 weights and generator seed 5: (loss, grads on the host)."""
    from fairmultimodal_torch.data.prefetch import to_device
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.models.fusion import FAMEModel
    from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig

    m32 = set_flash(set_fold(init_params(FAMEModel(**TRAIN_GEO, dtype=torch.float32), seed=0),
                             fold), flash)
    t32 = FAMETrainer(m32, TrainConfig(lr=1e-4, batch_size=8), pos_weight=POS_WEIGHT,
                      rngs_seed=5, device=device)
    total, _ = t32.train_step(to_device(batch, t32.device))
    return float(total), {n: p.grad.detach().cpu() for n, p in m32.named_parameters()
                          if p.grad is not None}


def compare_steps(got, want):
    """(loss rel, worst leaf, its max error over its max-abs) of two
    :func:`fp32_train_step` results."""
    (loss_c, grads_c), (loss_h, grads_h) = got, want
    if set(grads_c) != set(grads_h):
        raise AssertionError(f"grad leaves differ: {set(grads_c) ^ set(grads_h)}")

    def scale(name):
        # A key bias has a zero grad in exact arithmetic (softmax ignores
        # it): measure its rounding noise on the q/k/v bias grads' scale.
        if name.endswith("key.bias"):
            return max(float(grads_h[name.replace("key", k)].abs().max())
                       for k in ("query", "key", "value"))
        return float(grads_h[name].abs().max())

    rel = {n: float((grads_c[n] - g).abs().max()) / scale(n)
           for n, g in grads_h.items() if scale(n) > 0}
    worst = max(rel, key=rel.get)
    return abs(loss_c - loss_h) / abs(loss_h), worst, rel[worst]


def train_slice_phase(fab, ffn):
    from fairmultimodal_torch.data.loader import BatchIterator, NestedLoader
    from fairmultimodal_torch.data.prefetch import to_device
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.models.fusion import FAMEModel
    from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig

    rng = np.random.default_rng(2)
    train, val = synthetic_cohort(rng, N_TRAIN), synthetic_cohort(rng, N_VAL)
    keys = [k for k in train if k != "labels"]
    train_loader = NestedLoader(BatchIterator(train, TRAIN_BATCH, shuffle=True, seed=0), keys)
    val_loader = NestedLoader(BatchIterator(val, TRAIN_BATCH), keys)
    model = init_params(FAMEModel(**TRAIN_GEO, dtype=torch.bfloat16), seed=0)
    trainer = FAMETrainer(model, TrainConfig(lr=1e-4, num_epochs=TRAIN_EPOCHS,
                                             batch_size=TRAIN_BATCH),
                          pos_weight=POS_WEIGHT, rngs_seed=0, device="cuda")
    heads0 = {k: v.clone() for k, v in model.state_dict().items() if ".classifier_" in k}
    sig0 = model.fusion.sig_weights.detach().clone()

    # The main path, with the launch counters read around it.
    fab.launches = ffn.launches = fab.bwd_launches = ffn.bwd_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, history = trainer.fit(train_loader, val_loader, verbose=True)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    counts = {"fused_attention_block_ln": fab.launches, "fused_ffn_ln": ffn.launches,
              "fused_attention_block_ln_bwd": fab.bwd_launches,
              "fused_ffn_ln_bwd": ffn.bwd_launches}
    layers = TRAIN_GEO["lab_layers"]
    steps = TRAIN_EPOCHS * -(-N_TRAIN // TRAIN_BATCH)
    forwards = TRAIN_EPOCHS * (-(-N_TRAIN // TRAIN_BATCH) * 2 + -(-N_VAL // TRAIN_BATCH))
    want = {"fused_attention_block_ln": layers * forwards, "fused_ffn_ln": layers * forwards,
            "fused_attention_block_ln_bwd": layers * steps, "fused_ffn_ln_bwd": layers * steps}
    log(f"[train] fit {TRAIN_EPOCHS} epochs in {t_fit:.1f} s (host clock, first call); "
        f"launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    losses = [v for h in history for k, v in h.items() if k.endswith("loss")]
    if len(history) != TRAIN_EPOCHS or not np.isfinite(losses).all():
        raise AssertionError(f"training history {history}")
    for k, v in heads0.items():
        if not torch.equal(model.state_dict()[k], v):
            raise AssertionError(f"loss-free head {k} moved")
    if torch.equal(model.fusion.sig_weights.detach(), sig0):
        raise AssertionError("sig_weights did not move")
    log(f"[train] history {json.dumps(history)}")
    log(f"[train] dynamic weights {json.dumps(trainer.dynamic_weights.tolist())}")

    # fp32, 8 patients, dropout on: one train step on the card and on the CPU.
    batch = fp32_step_batch(train, keys)
    for device in ("cuda", "cpu"):
        fab.bwd_launches = ffn.bwd_launches = 0
        FP32_STEPS[device] = fp32_train_step(batch, device)
        if (device == "cuda") != (min(fab.bwd_launches, ffn.bwd_launches) > 0):
            raise AssertionError(f"{device}: backward launches {fab.bwd_launches}, "
                                 f"{ffn.bwd_launches}")
    loss_rel, worst, grad_rel = compare_steps(FP32_STEPS["cuda"], FP32_STEPS["cpu"])
    log(f"[train] fp32 8 patients, one step card vs CPU: loss {FP32_STEPS['cuda'][0]:.8f} vs "
        f"{FP32_STEPS['cpu'][0]:.8f} (rel {loss_rel:.2e}); worst grad leaf {worst} "
        f"{grad_rel:.2e} of its max-abs")
    if not loss_rel <= XDEV_LOSS_TOL or not grad_rel <= XDEV_GRAD_TOL:
        raise AssertionError(f"fp32 card vs CPU: loss rel {loss_rel}, grads {grad_rel}")

    # Train-step time at batch 256, bf16, dropout on.
    batch = to_device(next(iter(train_loader)), trainer.device)
    bench = time_train_step(trainer, batch)
    log(f"[train] train step bf16: {json.dumps(bench)}")
    split = profile_train_step(trainer, batch)
    log(f"[train] train step split by kernel (profiler, per step): {json.dumps(split)}")
    return counts, {"step_split": split, "fit_s": t_fit, "history": history,
                    "dynamic_weights": trainer.dynamic_weights.tolist(),
                    "fp32_card_vs_cpu": {"loss_rel": loss_rel, "worst_grad_rel": grad_rel},
                    "train_step": bench}


def time_train_step(trainer, batch, steps=20, warmup=3):
    """Median CUDA-event time of ``trainer.train_step`` over ``steps``
    after ``warmup``."""
    for _ in range(warmup):
        trainer.train_step(batch)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.train_step(batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    bs = len(batch["labels"])
    return {"batch_size": bs, "train_step_ms": ms, "patients_per_sec": 1e3 * bs / ms,
            "min_ms": min(times), "max_ms": max(times),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def profile_train_step(trainer, batch, steps=3, top=16):
    """Device time by kernel over ``steps`` train steps (torch.profiler's
    CUPTI trace), per step in ms, and the share of the host-clock window in
    which the card ran no kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    rows = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": (1.0 - busy / wall_ms) if busy else None,
            "by_kernel_ms": {e.key[:90]: e.self_device_time_total / 1e3 / steps for e in rows},
            "launches_per_step": sum(e.count for e in kernels) / steps}


# -- phase 5b: the unfolded slice (FMTPU_FOLD_LN=0) ----------------------------------------

# fp32 unfolded vs folded on the card: the same weights, batch and Philox
# masks, and the same GEMM and flash kernels in the same order; only where
# the LayerNorm's residual cotangent is added to dx (inside the dx GEMM's
# epilogue or by autograd after it) and the glue's LayerNorm rows differ,
# so loss and grads agree to a few fp32 ulps.
FOLD_LOSS_TOL, FOLD_GRAD_TOL = 1e-6, 1e-4
N_FIT_TRAIN, N_FIT_VAL = 512, 256
PRED_FOLD_TOL = 1e-5


def _unfolded_counts(fab, ffn):
    return {"fused_attention_block": fab.unfolded_launches, "fused_ffn": ffn.unfolded_launches,
            "fused_attention_block_bwd": fab.unfolded_bwd_launches,
            "fused_ffn_bwd": ffn.unfolded_bwd_launches,
            "fused_attention_block_ln": fab.launches, "fused_ffn_ln": ffn.launches,
            "fused_attention_block_ln_bwd": fab.bwd_launches, "fused_ffn_ln_bwd": ffn.bwd_launches}


def _reset_counts(fab, ffn, addnorm):
    fab.launches = ffn.launches = fab.bwd_launches = ffn.bwd_launches = 0
    fab.unfolded_launches = ffn.unfolded_launches = 0
    fab.unfolded_bwd_launches = ffn.unfolded_bwd_launches = 0
    addnorm.launches = addnorm.bwd_launches = 0


def unfolded_slice_phase(fab, ffn, addnorm):
    import os

    from fairmultimodal_torch.data.loader import BatchIterator, NestedLoader
    from fairmultimodal_torch.data.prefetch import to_device
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.models.fusion import FAMEModel
    from fairmultimodal_torch.pipelines.inference import FAMEPredictor
    from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig

    info = {}
    rng = np.random.default_rng(2)
    train, val = synthetic_cohort(rng, N_TRAIN), synthetic_cohort(rng, N_VAL)
    keys = [k for k in train if k != "labels"]

    # fp32 one step, dropout on: unfolded on the card vs folded on the card
    # (phase 5's run) and vs the plain path on the CPU (phase 5's run).
    _reset_counts(fab, ffn, addnorm)
    FP32_STEPS["cuda_unfolded"] = fp32_train_step(fp32_step_batch(train, keys), "cuda",
                                                  fold=False)
    counts = _unfolded_counts(fab, ffn)
    if min(list(counts.values())[:4]) == 0 or max(list(counts.values())[4:]) > 0:
        raise AssertionError(f"fp32 unfolded step: launches {counts}")
    for other, (loss_tol, grad_tol) in (("cuda", (FOLD_LOSS_TOL, FOLD_GRAD_TOL)),
                                        ("cpu", (XDEV_LOSS_TOL, XDEV_GRAD_TOL))):
        loss_rel, worst, grad_rel = compare_steps(FP32_STEPS["cuda_unfolded"], FP32_STEPS[other])
        info[f"fp32_unfolded_vs_{other}"] = {"loss_rel": loss_rel, "worst_leaf": worst,
                                             "worst_grad_rel": grad_rel}
        what = "folded card" if other == "cuda" else "CPU plain path"
        log(f"[unfolded] fp32 one step, unfolded card vs {what}: loss rel {loss_rel:.2e}, "
            f"worst grad leaf {worst} {grad_rel:.2e} of its max-abs")
        if not loss_rel <= loss_tol or not grad_rel <= grad_tol:
            raise AssertionError(f"fp32 unfolded vs {other}: loss rel {loss_rel}, "
                                 f"grads {grad_rel}")

    # The main path: FAMETrainer.fit, 1 epoch with validation, FMTPU_FOLD_LN=0.
    fit_train = {k: v[:N_FIT_TRAIN] for k, v in train.items()}
    train_loader = NestedLoader(BatchIterator(fit_train, TRAIN_BATCH, shuffle=True, seed=0),
                                keys)
    val_loader = NestedLoader(BatchIterator(val, TRAIN_BATCH), keys)
    model = init_params(FAMEModel(**TRAIN_GEO, dtype=torch.bfloat16), seed=0)
    trainer = FAMETrainer(model, TrainConfig(lr=1e-4, num_epochs=1, batch_size=TRAIN_BATCH),
                          pos_weight=POS_WEIGHT, rngs_seed=0, device="cuda")
    os.environ["FMTPU_FOLD_LN"] = "0"
    try:
        _reset_counts(fab, ffn, addnorm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, history = trainer.fit(train_loader, val_loader, verbose=True)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        counts = _unfolded_counts(fab, ffn)
        glue = {"forward": addnorm.launches, "backward": addnorm.bwd_launches}
    finally:
        del os.environ["FMTPU_FOLD_LN"]
    layers = TRAIN_GEO["lab_layers"]
    steps = -(-N_FIT_TRAIN // TRAIN_BATCH)
    forwards = steps * 2 + -(-N_VAL // TRAIN_BATCH)
    want = {"fused_attention_block": layers * forwards, "fused_ffn": layers * forwards,
            "fused_attention_block_bwd": layers * steps, "fused_ffn_bwd": layers * steps,
            "fused_attention_block_ln": 0, "fused_ffn_ln": 0,
            "fused_attention_block_ln_bwd": 0, "fused_ffn_ln_bwd": 0}
    want_glue = {"forward": 2 * layers * forwards, "backward": 2 * layers * steps}
    log(f"[unfolded] fit 1 epoch ({N_FIT_TRAIN} + {N_VAL} patients) in {t_fit:.1f} s "
        f"(host clock, first call); launches {counts}, expected {want}; glue {glue}")
    if counts != want or glue != want_glue:
        raise AssertionError(f"unfolded fit launches {counts} {glue}, expected {want} "
                             f"{want_glue}")
    losses = [v for h in history for k, v in h.items() if k.endswith("loss")]
    if len(history) != 1 or not np.isfinite(losses).all():
        raise AssertionError(f"unfolded training history {history}")
    info.update(fit_s=t_fit, fit_launches=counts, fit_glue_launches=glue, history=history)

    # bf16 train step at batch 256: folded and unfolded in turns, same call.
    batch = to_device(next(iter(train_loader)), trainer.device)
    steps_ms = {}
    for fold in (True, False, False, True):
        set_fold(model, fold)
        tag = "folded" if fold else "unfolded"
        steps_ms.setdefault(tag, []).append(time_train_step(trainer, batch))
    set_fold(model, False)
    split = profile_train_step(trainer, batch)
    info["train_step"] = steps_ms
    info["step_split"] = split
    log(f"[unfolded] train step bf16, folded / unfolded in turns: {json.dumps(steps_ms)}")
    log(f"[unfolded] unfolded train step split by kernel (profiler, per step): "
        f"{json.dumps(split)}")

    # Serving: fp32 probabilities unfolded vs folded, then the bf16 benchmark.
    arrays = {k: v[:64] for k, v in val.items() if k != "labels"}
    probs = {}
    for fold in (True, False):
        m32 = set_fold(init_params(FAMEModel(**TRAIN_GEO, dtype=torch.float32), seed=0), fold)
        probs[fold] = FAMEPredictor(m32, batch_size=64, device="cuda").predict_arrays(
            arrays)["probs"]
        del m32
    diff = float(np.abs(probs[True] - probs[False]).max())
    log(f"[unfolded] fp32 serving 64 patients: max |p_unfolded - p_folded| = {diff:.3e}")
    if not diff <= PRED_FOLD_TOL:
        raise AssertionError(f"fp32 unfolded vs folded probabilities differ by {diff}")
    serve = set_fold(init_params(FAMEModel(**TRAIN_GEO, dtype=torch.bfloat16), seed=0), False)
    bench = FAMEPredictor(serve, batch_size=256, device="cuda").benchmark(iters=20)
    log(f"[unfolded] FAMEPredictor.benchmark bf16 unfolded: {json.dumps(bench)}")
    info.update(fp32_serving_unfolded_vs_folded=diff, benchmark=bench)
    del trainer, model, serve
    torch.cuda.empty_cache()
    return counts, info


# -- phase 5c: the flash-route slice (attn_kernel=False) ----------------------------------

# fp32 serving, flash route vs folded on the card: the same weights; the
# attention core runs the same flash forward (through other strides) and the
# projections, Wo and the LayerNorm take other kernels or PyTorch ops, so the
# probabilities agree to fp32 rounding.
PRED_FLASH_TOL = 1e-4


def _flash_counts(flash, fab, ffn, addnorm):
    return {"flash_attention": flash.launches, "flash_attention_bwd": flash.bwd_launches,
            "fused_ffn_ln": ffn.launches, "fused_ffn_ln_bwd": ffn.bwd_launches,
            "glue": addnorm.launches, "glue_bwd": addnorm.bwd_launches,
            "fused_attention_block_ln": fab.launches,
            "fused_attention_block_ln_bwd": fab.bwd_launches,
            "fused_attention_block": fab.unfolded_launches,
            "fused_attention_block_bwd": fab.unfolded_bwd_launches,
            "fused_ffn": ffn.unfolded_launches, "fused_ffn_bwd": ffn.unfolded_bwd_launches}


def flash_slice_phase(flash, fab, ffn, addnorm):
    from fairmultimodal_torch.data.loader import BatchIterator, NestedLoader
    from fairmultimodal_torch.data.prefetch import to_device
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.models.fusion import FAMEModel
    from fairmultimodal_torch.pipelines.inference import FAMEPredictor
    from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig

    def reset():
        _reset_counts(fab, ffn, addnorm)
        flash.launches = flash.bwd_launches = 0

    info = {}
    rng = np.random.default_rng(2)
    train, val = synthetic_cohort(rng, N_TRAIN), synthetic_cohort(rng, N_VAL)
    keys = [k for k in train if k != "labels"]

    # fp32 one step, dropout on: the flash route on the card vs the folded
    # step on the card and the plain path on the CPU (phase 5's runs).
    reset()
    FP32_STEPS["cuda_flash"] = fp32_train_step(fp32_step_batch(train, keys), "cuda", flash=True)
    counts = _flash_counts(flash, fab, ffn, addnorm)
    if min(counts["flash_attention"], counts["flash_attention_bwd"]) == 0 or \
            counts["fused_attention_block_ln"] or counts["fused_attention_block"]:
        raise AssertionError(f"fp32 flash-route step: launches {counts}")
    for other in ("cuda", "cpu"):
        loss_rel, worst, grad_rel = compare_steps(FP32_STEPS["cuda_flash"], FP32_STEPS[other])
        info[f"fp32_flash_vs_{other}"] = {"loss_rel": loss_rel, "worst_leaf": worst,
                                          "worst_grad_rel": grad_rel}
        what = "folded card" if other == "cuda" else "CPU plain path"
        log(f"[flash] fp32 one step, flash route card vs {what}: loss rel {loss_rel:.2e}, "
            f"worst grad leaf {worst} {grad_rel:.2e} of its max-abs")
        if not loss_rel <= XDEV_LOSS_TOL or not grad_rel <= XDEV_GRAD_TOL:
            raise AssertionError(f"fp32 flash route vs {other}: loss rel {loss_rel}, "
                                 f"grads {grad_rel}")

    # The main path: FAMETrainer.fit, 1 epoch with validation, flash route.
    fit_train = {k: v[:N_FIT_TRAIN] for k, v in train.items()}
    train_loader = NestedLoader(BatchIterator(fit_train, TRAIN_BATCH, shuffle=True, seed=0),
                                keys)
    val_loader = NestedLoader(BatchIterator(val, TRAIN_BATCH), keys)
    model = set_flash(init_params(FAMEModel(**TRAIN_GEO, dtype=torch.bfloat16), seed=0))
    trainer = FAMETrainer(model, TrainConfig(lr=1e-4, num_epochs=1, batch_size=TRAIN_BATCH),
                          pos_weight=POS_WEIGHT, rngs_seed=0, device="cuda")
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, history = trainer.fit(train_loader, val_loader, verbose=True)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    counts = _flash_counts(flash, fab, ffn, addnorm)
    layers = TRAIN_GEO["lab_layers"]
    steps = -(-N_FIT_TRAIN // TRAIN_BATCH)
    forwards = steps * 2 + -(-N_VAL // TRAIN_BATCH)
    want = {k: 0 for k in counts}
    want.update(flash_attention=layers * forwards, flash_attention_bwd=layers * steps,
                fused_ffn_ln=layers * forwards, fused_ffn_ln_bwd=layers * steps,
                glue=layers * forwards, glue_bwd=layers * steps)
    log(f"[flash] fit 1 epoch ({N_FIT_TRAIN} + {N_VAL} patients) in {t_fit:.1f} s "
        f"(host clock, first call); launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError(f"flash-route fit launches {counts}, expected {want}")
    losses = [v for h in history for k, v in h.items() if k.endswith("loss")]
    if len(history) != 1 or not np.isfinite(losses).all():
        raise AssertionError(f"flash-route training history {history}")
    info.update(fit_s=t_fit, fit_launches=counts, history=history)

    # bf16 train step at batch 256: folded and flash route in turns, same call.
    batch = to_device(next(iter(train_loader)), trainer.device)
    steps_ms = {}
    for on in (False, True, True, False):
        set_flash(model, on)
        steps_ms.setdefault("flash" if on else "folded", []).append(
            time_train_step(trainer, batch))
    set_flash(model)
    split = profile_train_step(trainer, batch)
    info["train_step"] = steps_ms
    info["step_split"] = split
    log(f"[flash] train step bf16, folded / flash route in turns: {json.dumps(steps_ms)}")
    log(f"[flash] flash-route train step split by kernel (profiler, per step): "
        f"{json.dumps(split)}")

    # Serving: fp32 probabilities flash route vs folded, then the bf16 benchmark.
    arrays = {k: v[:64] for k, v in val.items() if k != "labels"}
    probs = {}
    for on in (False, True):
        m32 = set_flash(init_params(FAMEModel(**TRAIN_GEO, dtype=torch.float32), seed=0), on)
        probs[on] = FAMEPredictor(m32, batch_size=64, device="cuda").predict_arrays(
            arrays)["probs"]
        del m32
    diff = float(np.abs(probs[True] - probs[False]).max())
    log(f"[flash] fp32 serving 64 patients: max |p_flash - p_folded| = {diff:.3e}")
    if not diff <= PRED_FLASH_TOL:
        raise AssertionError(f"fp32 flash route vs folded probabilities differ by {diff}")
    serve = set_flash(init_params(FAMEModel(**TRAIN_GEO, dtype=torch.bfloat16), seed=0))
    bench = FAMEPredictor(serve, batch_size=256, device="cuda").benchmark(iters=20)
    log(f"[flash] FAMEPredictor.benchmark bf16 flash route: {json.dumps(bench)}")
    info.update(fp32_serving_flash_vs_folded=diff, benchmark=bench)
    del trainer, model, serve
    torch.cuda.empty_cache()
    return counts, info


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 2
    from fairmultimodal_torch.ops import _build
    from fairmultimodal_torch.ops import dropout_add_layernorm as addnorm
    from fairmultimodal_torch.ops import flash_attention as flash
    from fairmultimodal_torch.ops import fused_attention_block as fab
    from fairmultimodal_torch.ops import fused_ffn as ffn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build()
    _build.kernels()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    log(f"[build] ptxas -v of the redesigned kernels: {json.dumps(ptxas_report(_build))}")

    rows = kernel_phase(fab, ffn)
    train_rows, keep = train_kernel_phase(fab, ffn, _build)
    unfolded_rows = unfolded_kernel_phase(fab, ffn, addnorm)
    nt_gemm_phase(_build)
    nn_tn_gemm_phase(_build, fab)
    flash_rows, flash_layer = flash_kernel_phase(flash)
    launches, slice_info = slice_phase(fab, ffn)
    log(f"[slice] {json.dumps(slice_info)}")
    train_launches, train_info = train_slice_phase(fab, ffn)
    log(f"[train] {json.dumps(train_info)}")
    unfolded_launches, unfolded_info = unfolded_slice_phase(fab, ffn, addnorm)
    log(f"[unfolded] {json.dumps(unfolded_info)}")
    flash_launches, flash_info = flash_slice_phase(flash, fab, ffn, addnorm)
    log(f"[flash] {json.dumps(flash_info)}")

    meta = {
        "fused_attention_block_ln": ("fairmultimodal_torch/ops/csrc/flash_attention.cu",
                                     "fairmultimodal_tpu/ops/fused_attention_block.py:517"),
        "fused_ffn_ln": ("fairmultimodal_torch/ops/csrc/gemm.cu",
                         "fairmultimodal_tpu/ops/fused_ffn.py:414"),
    }
    timed_train = {"fused_attention_block_ln": next(r for r in train_rows["attention"]
                                                    if "ms" in r),
                   "fused_ffn_ln": next(r for r in train_rows["ffn"] if "ms" in r)}
    kernels = []
    for name, (source, replaces) in meta.items():
        mine = [r for r in rows if r["kernel"] == name]
        main = mine[0]    # the lab-encoder shape of the serving batch, bf16
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": main["max_abs_err_bf16"],
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"], "dtype": "bfloat16", "stages_ms": main["stages_ms"],
            "sources": ["fairmultimodal_torch/ops/csrc/gemm.cu",
                        "fairmultimodal_torch/ops/csrc/flash_attention.cu",
                        "fairmultimodal_torch/ops/csrc/add_layernorm.cu"]
            if name == "fused_attention_block_ln" else
            ["fairmultimodal_torch/ops/csrc/gemm.cu",
             "fairmultimodal_torch/ops/csrc/add_layernorm.cu"],
            "launches_by_encoder": {"text": slice_info["text"][name],
                                    "lab": slice_info["lab"][name]},
            "launches_training": train_launches[name],
            "fwd_res_dropout_ms": timed_train[name]["fwd_res_ms"],
            "shapes": mine,
        })
    for name, part, source, replaces in (
            ("fused_attention_block_ln_bwd", "attention",
             "fairmultimodal_torch/ops/csrc/flash_attention.cu",
             "fairmultimodal_tpu/ops/fused_attention_block.py:657"),
            ("fused_ffn_ln_bwd", "ffn", "fairmultimodal_torch/ops/csrc/gemm.cu",
             "fairmultimodal_tpu/ops/fused_ffn.py:530")):
        row = timed_train[name[:-4]]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": train_launches[name], "max_abs_err": row["errors"]["dx"]["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "stages_ms": row["stages_ms"], "shape": row["case"], "dtype": "bfloat16",
            "sources": ["fairmultimodal_torch/ops/csrc/add_layernorm.cu",
                        "fairmultimodal_torch/ops/csrc/gemm.cu"]
            + (["fairmultimodal_torch/ops/csrc/flash_attention.cu"] if part == "attention"
               else []),
            "errors": {r["case"]: r["errors"] for r in train_rows[part]},
            "kept_fraction": keep,
        })
    sources = {"block": ["fairmultimodal_torch/ops/csrc/gemm.cu",
                         "fairmultimodal_torch/ops/csrc/flash_attention.cu"],
               "ffn": ["fairmultimodal_torch/ops/csrc/gemm.cu"]}
    for name, part, source, replaces, bwd in (
            ("fused_attention_block", "block", "fairmultimodal_torch/ops/csrc/flash_attention.cu",
             "fairmultimodal_tpu/ops/fused_attention_block.py:150", False),
            ("fused_attention_block_bwd", "block",
             "fairmultimodal_torch/ops/csrc/flash_attention.cu",
             "fairmultimodal_tpu/ops/fused_attention_block.py:250", True),
            ("fused_ffn", "ffn", "fairmultimodal_torch/ops/csrc/gemm.cu",
             "fairmultimodal_tpu/ops/fused_ffn.py:122", False),
            ("fused_ffn_bwd", "ffn", "fairmultimodal_torch/ops/csrc/gemm.cu",
             "fairmultimodal_tpu/ops/fused_ffn.py:205", True)):
        row = next(r for r in unfolded_rows[part] if "ms" in r)     # lab shape, bf16
        pre = "bwd_" if bwd else ""
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": unfolded_launches[name],
            "max_abs_err": row["errors"]["dx"]["max_abs_err"] if bwd else
            row["forward"]["max_abs_err"],
            "ms": row[pre + "ms"], "plain_ms": row["plain_" + pre + "ms"],
            "bound_ms": row[pre + "bound_ms"], "bound_by": row[pre + "bound_by"],
            "library_ms": row["library_" + pre + "ms"], "stages_ms": row[pre + "stages_ms"],
            "shape": row["case"], "dtype": "bfloat16", "sources": sources[part],
            "errors": {r["case"]: {"forward": r["forward"], **r["errors"]}
                       for r in unfolded_rows[part]},
        })
    row = next(r for r in flash_rows if "ms" in r)          # lab shape, bf16
    errors = {r["case"]: r["errors"] for r in flash_rows}
    for name, replaces, pre, outs in (
            ("flash_attention", "fairmultimodal_tpu/ops/flash_attention.py:44", "", ("o",)),
            ("flash_attention_bwd", "fairmultimodal_tpu/ops/flash_attention.py:67", "bwd_",
             FLASH_GRADS)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fairmultimodal_torch/ops/csrc/flash_attention.cu", "replaces": replaces,
            "launches": flash_launches[name],
            "max_abs_err": max(row["errors"][n]["max_abs_err"] for n in outs),
            "ms": row[pre + "ms"], "plain_ms": row["plain_" + pre + "ms"],
            "bound_ms": row[pre + "bound_ms"], "bound_by": row[pre + "bound_by"],
            "library_ms": row["library_" + pre + "ms"], "shape": row["case"],
            "dtype": "bfloat16", "errors": errors,
            **({"fwd_res_ms": row["fwd_res_ms"], "fused_qkv_layer": flash_layer} if not pre
               else {"stages_ms": row["bwd_stages_ms"],
                     "kernel_order": row["kernel_order"]}),
        })
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
