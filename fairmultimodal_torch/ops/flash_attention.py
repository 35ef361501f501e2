"""Flash attention on the card (port of ``fairmultimodal_tpu/ops/flash_attention.py``).

``flash_attention(q, k, v, mask)`` computes ``softmax(q k^T / sqrt(d) + bias) v``
over q, k, v [B, heads, S, D] with an optional [B, S] mask (1 = attend; a
masked key gets -1e9 added, so a fully masked row stays a finite uniform
softmax).  It replaces the Pallas kernels ``_fwd_kernel`` (#9, forward) and
``_bwd_kernel`` (#10, its VJP), which ``ops/attention.py::multi_head_attention``
reaches wherever the half-layer megakernel is not taken at 256 <= S <= 1024:
``TorchEncoderLayer`` with ``attn_kernel=False`` or ``fused_qkv=True`` and
``BertSelfAttention`` in training mode.

On a CUDA tensor the forward and the backward are the hand-written kernels
of ``csrc/flash_attention.cu`` (``fm_flash_attention_fwd`` / ``_bwd``), which
read q, k, v and dO through their strides: the head views of the layer's
[B, S, H] projections or of a fused [B, S, 3H] one are never copied, and o,
dq, dk, dv are written into [B, S, heads, D] memory and returned as
[B, heads, S, D] views, so the head merge after them is a view too.  The
forward stores each row's softmax max and sum; the backward recomputes p
from them.  On a CPU tensor the wrapper runs the plain versions below,
differentiated by their own backward.

Numerics, as the TPU kernels: scores, softmax and every product accumulate
in fp32; the bf16 forward rounds the normalised p to bf16 before p.v; the
backward rounds p and ``ds * scale`` to the input dtype before their
products.  The softmax-VJP row term: ``_bwd_kernel`` takes rowsum(dP * P),
which :func:`flash_attention_backward_reference` follows; the kernel takes
rowsum(dO * O) from the stored o, equal for a normalised P (one pass over
the keys instead of two).  In bf16 the stored o carries p's rounding, so
the two differ by about one bf16 rounding of the row term; the card's check
(``chip_smoke.py`` phase 3d) holds the kernel's grads to the plain version
within 2^-4 of each grad's max-abs (max) and 2^-10 (mean), fp32 within 1e-4.

S > 1024 raises ``ValueError``, as ``_pick_block_q`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from fairmultimodal_torch.ops import _build, _library

__all__ = ["flash_attention", "flash_attention_reference", "flash_attention_backward_reference",
           "MAX_SEQ"]

NEG_INF = -1e9
#: Longest sequence the kernels take (the TPU kernel's whole-S block limit).
MAX_SEQ = 1024

#: Forward launches (Pallas #9) on CUDA tensors since the last reset.
launches = 0
#: Backward launches (Pallas #10) on CUDA tensors since the last reset.
bwd_launches = 0


def _check_seq(s: int) -> None:
    if s > MAX_SEQ:
        raise ValueError(
            f"flash_attention: unsupported sequence length {s} (> {MAX_SEQ}); the "
            f"kernel requires S <= {MAX_SEQ} -- use attention_reference")


def _scores(q, k, mask):
    """fp32 scaled scores plus the key bias: [B, heads, S, S]."""
    d = q.shape[-1]
    acc = torch.promote_types(q.dtype, torch.float32)
    s = (q.to(acc) @ k.to(acc).transpose(-1, -2)) * (1.0 / d ** 0.5)
    if mask is not None:
        s = s + torch.where(mask[:, None, None, :] > 0, 0.0, NEG_INF).to(acc)
    return s


def _softmax(s):
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _forward_with_stats(q, k, v, mask):
    """:func:`flash_attention_reference` and each row's softmax max and sum
    of the scaled, biased scores [B, heads, S, 2] fp32 (what the forward
    kernel stores), from one score matrix."""
    dt = q.dtype
    acc = torch.promote_types(dt, torch.float32)
    s = _scores(q, k, mask)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    total = e.sum(dim=-1, keepdim=True)
    o = ((e / total).to(dt).to(acc) @ v.to(acc)).to(dt)
    return o, torch.cat((m, total), dim=-1).float()


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of ``_fwd_kernel``: q, k, v [B, heads, S, D],
    mask [B, S] or None; the normalised p rounded to the input dtype before
    p.v, accumulation in (at least) fp32, output in the input dtype."""
    return _forward_with_stats(q, k, v, mask)[0]


def flash_attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                       mask: Optional[torch.Tensor], do: torch.Tensor
                                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``_bwd_kernel``, step by step: p recomputed
    from q and k in fp32, ``dv = round(p)^T . dO``, ``dp = dO . v^T``,
    ``ds = p * (dp - rowsum(dp * p))``, ``dq = round(ds * scale) . k`` and
    ``dk = round(ds * scale)^T . q``, each product accumulated in fp32 and
    each grad rounded to the input dtype.  Returns (dq, dk, dv)."""
    dt = q.dtype
    acc = torch.promote_types(dt, torch.float32)
    scale = 1.0 / q.shape[-1] ** 0.5
    q32, k32, v32, do32 = (t.to(dt).to(acc) for t in (q, k, v, do))
    p = _softmax(_scores(q, k, mask))
    dv = p.to(dt).to(acc).transpose(-1, -2) @ do32
    dp = do32 @ v32.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds_b = (ds * scale).to(dt).to(acc)
    dq = ds_b @ k32
    dk = ds_b.transpose(-1, -2) @ q32
    return dq.to(dt), dk.to(dt), dv.to(dt)


# -- the CUDA path ----------------------------------------------------------------------


def _last_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _heads_like(q: torch.Tensor) -> torch.Tensor:
    """An empty [B, heads, S, D] tensor over [B, S, heads, D] memory."""
    b, nh, s, d = q.shape
    return torch.empty((b, s, nh, d), dtype=q.dtype, device=q.device).transpose(1, 2)


def _mask_operand(mask: Optional[torch.Tensor], q: torch.Tensor) -> Optional[torch.Tensor]:
    # A contiguous int32 copy: BEHRTLab's mask is an expanded (stride-0) view.
    if mask is None:
        return None
    return mask.to(device=q.device, dtype=torch.int32).contiguous()


def _operands(q, k, v, mask):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must be [B, heads, S, D] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    return (*(_last_contiguous(t) for t in (q, k, v)), _mask_operand(mask, q))


def _forward_kernel(q, k, v, mask, residuals: bool):
    b, nh, s, _ = q.shape
    o = _heads_like(q)
    stats = torch.empty((b, nh, s, 2), dtype=torch.float32, device=q.device) \
        if residuals else None
    _build.flash_attention_fwd(q, k, v, mask, o, stats)
    return o, stats


def _backward_kernel(q, k, v, o, stats, mask, g):
    b, nh, s, _ = q.shape
    dq, dk, dv = _heads_like(q), _heads_like(q), _heads_like(q)
    rowterm = torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
    _build.flash_attention_bwd(q, k, v, o, _last_contiguous(g.to(q.dtype)), mask, stats,
                               rowterm, dq, dk, dv)
    return dq, dk, dv


def _in_heads_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` [B, heads, S, D] copied into [B, S, heads, D] memory: the
    layout the kernels write."""
    out = _heads_like(t)
    out.copy_(t)
    return out


# -- the ops (``_library``): Pallas #9 / #10 --------------------------------------------


def _flash_cpu(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor], residuals: bool
               ) -> Tuple[Tensor, Tensor]:
    """Pallas #9: (o, stats) -- o in [B, S, heads, D] memory, stats (the
    rows' softmax max and sum) the backward's residual, a placeholder
    without ``residuals``."""
    o, stats = _forward_with_stats(q, k, v, mask)
    return _in_heads_layout(o), stats if residuals else _library.placeholder(q, torch.float32)


def _flash_cuda(q, k, v, mask, residuals):
    global launches
    o, stats = _forward_kernel(*_operands(q, k, v, mask), residuals=residuals)
    launches += 1
    return o, stats if residuals else _library.placeholder(q, torch.float32)


def _flash_fake(q, k, v, mask, residuals):
    b, nh, s, _ = q.shape
    return _heads_like(q), (q.new_empty((b, nh, s, 2), dtype=torch.float32) if residuals
                            else _library.placeholder(q, torch.float32))


def _flash_bwd_cpu(g: Tensor, q: Tensor, k: Tensor, v: Tensor, o: Tensor, stats: Tensor,
                   mask: Optional[Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
    """Pallas #10: (dq, dk, dv), in [B, S, heads, D] memory."""
    return tuple(_in_heads_layout(t)
                 for t in flash_attention_backward_reference(q, k, v, mask, g))


def _flash_bwd_cuda(g, q, k, v, o, stats, mask):
    global bwd_launches
    q, k, v, mask = _operands(q, k, v, mask)
    grads = _backward_kernel(q, k, v, o, stats, mask, g)
    bwd_launches += 1
    return grads


def _flash_bwd_fake(g, q, k, v, o, stats, mask):
    return _heads_like(q), _heads_like(q), _heads_like(q)


def _flash_setup(ctx, inputs, output):
    q, k, v, mask, residuals = inputs
    o, stats = output
    _library.residual_context(ctx, (q, k, v, o, stats, mask), dict(residuals=residuals),
                              (stats,))


def _flash_backward(ctx, g, _):
    if not ctx.residuals:
        raise RuntimeError("fm::flash_attention was called without residuals")
    q, k, v, o, stats, mask = ctx.saved_tensors
    return (*flash_attention_bwd_op(g, q, k, v, o, stats, mask), None, None)


flash_attention_bwd_op = _library.register("flash_attention_bwd", _flash_bwd_cpu,
                                           _flash_bwd_cuda, _flash_bwd_fake)
flash_attention_op = _library.register("flash_attention", _flash_cpu, _flash_cuda, _flash_fake,
                                       _flash_backward, _flash_setup)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused attention: q, k, v [B, heads, S, D] (fp32 or bf16 on the card;
    any batch / head / row strides), mask [B, S] (1 = attend) or None.
    Returns [B, heads, S, D] in the input dtype, over [B, S, heads, D]
    memory.  Differentiable: with grad enabled the forward keeps its row
    statistics and the backward is ``fm::flash_attention_bwd`` (#10).  On a
    CUDA tensor the kernels run or the call raises; on a CPU tensor the
    plain versions run.  S > 1024 raises ``ValueError``."""
    _check_seq(q.shape[2])
    if q.is_cuda:       # the kernels' operands, made once for the forward and the backward
        q, k, v, mask = _operands(q, k, v, mask)
    return flash_attention_op(q, k, v, mask, _library.needs_grad(q, k, v))[0]
