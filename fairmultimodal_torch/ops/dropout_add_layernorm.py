"""Dropout + residual + LayerNorm after an unfolded half-layer kernel.

With ``fold_ln=False`` the JAX encoder layer follows each unfolded Pallas
kernel with XLA glue: ``nn.Dropout``, ``x + y`` and ``nn.LayerNorm``
(``fairmultimodal_tpu/models/behrt.py:127-130, 174-176``).  This is that
glue as one :class:`torch.autograd.Function`:

- on a CUDA tensor the forward is the ``add_layernorm`` row kernel
  (``csrc/add_layernorm.cu``) with y in the io dtype: z = round(x +
  dropout(y)) with the mask of Philox ``(seed, stream)`` at the flat index
  row * H + col, LayerNorm of z, z stored.  The backward is the
  ``layernorm_bwd`` row kernel: dz, the cotangent of z, written in the io
  dtype (x's grad, which autograd adds to the kernel's dx as XLA adds the
  two cotangents), dy = round(replay(dz)), and per-block partials that two
  fixed-order column sums turn into dgamma and dbeta.  The Philox streams
  are the folded kernels' (stream 0 of the attention seed, stream 1 of the
  FFN's outer seed), so the two configurations drop the same elements.
  Not the plain int64 Philox, nor ``nn.Dropout``: on a 143360 x 768 tensor
  the former is dozens of elementwise passes, and the latter draws from the
  global RNG.
- on a CPU tensor it is the plain version: ``x + dropout(y)`` in x's dtype,
  then the LayerNorm in at least fp32 (the arithmetic of
  ``models/_layers.layer_norm``), differentiated by autograd.

Rounding: the plain version (as JAX) rounds ``y / keep`` and ``x + y`` to the
io dtype separately; the kernel multiplies in fp32 and rounds once.  In fp32
the two agree to the last ulp; in bf16 z can differ by one bf16 ulp (2^-8
relative).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fairmultimodal_torch.ops import _build
from fairmultimodal_torch.ops.fused_attention_block import _f32
from fairmultimodal_torch.utils.rng import Dropout, apply_dropout

__all__ = ["dropout_add_layernorm", "dropout_add_layernorm_reference"]

#: Forward row-kernel launches on CUDA tensors since the last reset.
launches = 0
#: Backward row-kernel launches on CUDA tensors since the last reset.
bwd_launches = 0


def dropout_add_layernorm_reference(x: torch.Tensor, y: torch.Tensor, gamma: torch.Tensor,
                                    beta: torch.Tensor, *, eps: float,
                                    dropout: Dropout = Dropout()) -> torch.Tensor:
    """``LayerNorm(x + dropout(y))`` in plain PyTorch: the sum in x's dtype,
    the statistics in at least fp32, the result in x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    z = x + apply_dropout(y.to(x.dtype), dropout)
    return F.layer_norm(z.to(acc), (x.shape[-1],), gamma.to(acc), beta.to(acc),
                        eps).to(x.dtype)


def _rows(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1]).to(dt).contiguous()


class _AddNorm(torch.autograd.Function):
    """The two row kernels as forward and backward (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, x, y, gamma, beta, drop, eps):
        global launches
        x2 = _rows(x, x.dtype)
        out, z = torch.empty_like(x2), torch.empty_like(x2)
        _build.add_layernorm(x2, _rows(y, x.dtype), _f32(gamma), _f32(beta), out, eps, drop, z)
        launches += 1
        ctx.drop, ctx.eps, ctx.shape = drop, eps, x.shape
        ctx.save_for_backward(z, gamma)
        return out.view(x.shape)

    @staticmethod
    def backward(ctx, g):
        global bwd_launches
        z, gamma = ctx.saved_tensors
        r, h = z.shape
        f32 = dict(dtype=torch.float32, device=z.device)
        dz, dy = torch.empty_like(z), torch.empty_like(z)
        part = torch.empty((3, -(-r // _build.LN_BWD_ROWS), h), **f32)
        _build.layernorm_bwd(_rows(g, z.dtype), z, _f32(gamma), dz, dy, part, ctx.eps,
                             ctx.drop)
        dgamma, dbeta = torch.empty((h,), **f32), torch.empty((h,), **f32)
        _build.colsum(part[0], dgamma)
        _build.colsum(part[1], dbeta)
        bwd_launches += 1
        return (dz.view(ctx.shape), dy.view(ctx.shape), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None, None)


def dropout_add_layernorm(x: torch.Tensor, y: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, *, eps: float,
                          dropout: Dropout = Dropout()) -> torch.Tensor:
    """``LayerNorm(x + dropout(y))`` over the last axis: x, y [..., H] in the
    io dtype (fp32 or bf16), gamma / beta [H]; ``dropout`` one Philox stream
    (``Dropout()`` for none).  Differentiable.  On a CUDA tensor the row
    kernels (H % 8 == 0, H <= 1024, else the launch raises); on a CPU
    tensor :func:`dropout_add_layernorm_reference`."""
    global launches
    if not x.is_cuda:
        return dropout_add_layernorm_reference(x, y, gamma, beta, eps=eps, dropout=dropout)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, y, gamma, beta)):
        return _AddNorm.apply(x, y, gamma, beta, dropout, eps)
    x2 = _rows(x, x.dtype)
    out = torch.empty_like(x2)
    _build.add_layernorm(x2, _rows(y, x.dtype), _f32(gamma), _f32(beta), out, eps, dropout)
    launches += 1
    return out.view(x.shape)
