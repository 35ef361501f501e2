"""Attention half-layer ``LayerNorm(x + attn_block(x))`` on the card.

Port of ``fairmultimodal_tpu/ops/fused_attention_block.py``:
``fused_attention_block_ln`` / ``fused_attention_block_ln_infer`` and their
Pallas kernel ``_mega_ln_fwd_kernel``.  Forward only, dropout off: the
backward kernel and the dropout stream belong to the training slice.

On a CUDA tensor the half-layer is four hand-written kernel launches
(``csrc/``): the q/k/v projections as one GEMM into a [B, S, 3H] buffer
(bias added in fp32, rounded to the io dtype), flash attention over that
buffer, the output projection into fp32, and the residual + LayerNorm row
kernel.  The Pallas kernel keeps q/k/v/o in VMEM; here they round-trip
device memory (the first design, see the notes in each ``.cu``).

On a CPU tensor the wrappers run :func:`fused_attention_block_ln_reference`,
the plain PyTorch version with the TPU kernel's rounding points.

Weights take nn.Linear's [H_out, H_in] layout (``linear.weight``), the
layout the GEMM kernel streams; the JAX package's [H_in, H_out] Dense
kernels are transposed once, by :mod:`fairmultimodal_torch.interop`.
``ln_eps`` has no default: the lab encoder passes 1e-5, BERT 1e-12.
"""

from __future__ import annotations

from typing import Optional

import torch

from fairmultimodal_torch.ops import _build

__all__ = ["fused_attention_block_ln", "fused_attention_block_ln_infer",
           "fused_attention_block_ln_reference", "half_layer_stages"]

NEG_INF = -1e9

#: Kernel launches on CUDA tensors since the last reset (one per half-layer).
launches = 0


def _layer_norm_rows(z32: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float) -> torch.Tensor:
    mu = z32.mean(dim=-1, keepdim=True)
    var = ((z32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return (z32 - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()


def fused_attention_block_ln_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta,
                                       mask: Optional[torch.Tensor] = None, *,
                                       num_heads: int, ln_eps: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel, rounding where the TPU kernel
    rounds: q/k/v after the bias, p before p.v, o before Wo, z before the
    LayerNorm statistics.  x [B, S, H]; returns [B, S, H] in ``x.dtype``."""
    dt = x.dtype
    b, s, h = x.shape
    d = h // num_heads
    x32 = x.float()

    def heads(w, bias):
        y = (x32 @ w.float().t() + bias.float()).to(dt)
        return y.view(b, s, num_heads, d).transpose(1, 2).float()

    q, k, v = heads(wq, bq), heads(wk, bk), heads(wv, bv)
    scores = (q @ k.transpose(-1, -2)) * (1.0 / d ** 0.5)
    if mask is not None:
        scores = scores + torch.where(mask[:, None, None, :] > 0, 0.0, NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(dt)
    o = (p.float() @ v).to(dt).transpose(1, 2).reshape(b, s, h)
    y = o.float() @ wo.float().t() + bo.float()
    z = (x32 + y).to(dt)
    return _layer_norm_rows(z.float(), gamma, beta, ln_eps).to(dt)


def half_layer_stages(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, mask, *,
                      num_heads: int, ln_eps: float):
    """Check the operands of the CUDA half-layer and lay out its kernel
    launches: returns ``(stages, out)``, the launches in order as
    ``(name, thunk)`` pairs and the [B, S, H] tensor the last one fills.
    Each thunk can be run again on its own (``chip_smoke.py`` times them
    one by one); running them all in order is one half-layer."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, H], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    b, s, h = x.shape
    if h % num_heads:
        raise ValueError(f"H={h} is not a multiple of num_heads={num_heads}")
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        if tuple(w.shape) != (h, h) or w.dtype != x.dtype or w.device != x.device:
            raise ValueError(f"{name}: expected [{h}, {h}] {x.dtype} on {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta)):
        raise NotImplementedError(
            "the CUDA attention half-layer is forward only; its backward kernel "
            "comes with the training slice (run under torch.inference_mode())")
    dev = x.device
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    mask = mask.to(device=dev, dtype=torch.int32).contiguous()
    f32 = lambda t: t.to(torch.float32).contiguous()

    x2 = x.view(b * s, h)
    w_qkv = torch.cat((wq, wk, wv))                                   # [3H, H]
    b_qkv = f32(torch.cat((bq, bk, bv)))
    qkv = torch.empty((b, s, 3 * h), dtype=x.dtype, device=dev)
    o = torch.empty((b, s, h), dtype=x.dtype, device=dev)
    y = torch.empty((b * s, h), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    wo, bo, gamma, beta = wo.contiguous(), f32(bo), f32(gamma), f32(beta)
    stages = [
        ("qkv_gemm", lambda: _build.gemm_bias_act(x2, w_qkv, b_qkv, qkv.view(b * s, 3 * h))),
        ("flash_attn_fwd", lambda: _build.flash_attn_fwd(qkv, mask, o, num_heads)),
        ("wo_gemm", lambda: _build.gemm_bias_act(o.view(b * s, h), wo, bo, y)),
        ("add_layernorm", lambda: _build.add_layernorm(x2, y, gamma, beta,
                                                       out.view(b * s, h), ln_eps)),
    ]
    return stages, out


def _launch(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, mask, num_heads, ln_eps):
    global launches
    stages, out = half_layer_stages(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, mask,
                                    num_heads=num_heads, ln_eps=ln_eps)
    for _, run in stages:
        run()
    launches += 1
    return out


def _forward(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, mask, num_heads, ln_eps):
    if x.is_cuda:
        return _launch(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, mask,
                       num_heads, ln_eps)
    return fused_attention_block_ln_reference(
        x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, mask,
        num_heads=num_heads, ln_eps=ln_eps)


def fused_attention_block_ln(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta,
                             mask: Optional[torch.Tensor] = None, *, num_heads: int,
                             ln_eps: float, rate: float = 0.1,
                             deterministic: bool = True) -> torch.Tensor:
    """Attention half-layer ``LayerNorm(x + dropout(attn_block(x)))``.

    x [B, S, H] (fp32 or bf16); weights [H_out, H_in] and biases [H] in
    ``x.dtype``; gamma/beta [H]; mask [B, S] (1 = attend) or None.  Dropout
    is not available in this port yet: ``deterministic=False`` with
    ``rate > 0`` raises.  Returns [B, S, H] in ``x.dtype``.
    """
    if not deterministic and rate > 0.0:
        raise NotImplementedError(
            "dropout in the attention half-layer comes with the training slice")
    return _forward(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, mask,
                    num_heads, ln_eps)


def fused_attention_block_ln_infer(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta,
                                   mask: Optional[torch.Tensor] = None, *,
                                   num_heads: int, ln_eps: float) -> torch.Tensor:
    """Inference entry (the frozen text encoder's): the same math as
    :func:`fused_attention_block_ln` with dropout off."""
    return _forward(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, mask,
                    num_heads, ln_eps)
