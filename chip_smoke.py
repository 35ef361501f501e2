#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fairmultimodal_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card

Phases, each of which fails the run (non-zero exit) when it goes wrong:

1. card: the name and power limit from ``nvidia-smi``;
2. build: every kernel compiled from ``fairmultimodal_torch/ops/csrc``;
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 2
    from fairmultimodal_torch.ops import _build
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

    rows = kernel_phase(fab, ffn)
    launches, slice_info = slice_phase(fab, ffn)
    log(f"[slice] {json.dumps(slice_info)}")

    meta = {
        "fused_attention_block_ln": ("fairmultimodal_torch/ops/csrc/flash_attention.cu",
                                     "fairmultimodal_tpu/ops/fused_attention_block.py:517"),
        "fused_ffn_ln": ("fairmultimodal_torch/ops/csrc/gemm.cu",
                         "fairmultimodal_tpu/ops/fused_ffn.py:414"),
    }
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
            "shapes": mine,
        })
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
