"""Dropout + residual + LayerNorm after an unfolded half-layer kernel.

With ``fold_ln=False`` the JAX encoder layer follows each unfolded Pallas
kernel with XLA glue: ``nn.Dropout``, ``x + y`` and ``nn.LayerNorm``
(``fairmultimodal_tpu/models/behrt.py:127-130, 174-176``).  This is that
glue as one op pair, ``fm::dropout_add_layernorm`` and its backward
``fm::dropout_add_layernorm_bwd`` (``ops/_library.py``):

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
  ``models/_layers.layer_norm``); its backward is the LayerNorm VJP from
  the stored z in that precision, dz rounded to x's dtype, and dy the
  replayed dropout of it -- what autograd gives through the plain forward,
  up to the order of the LayerNorm VJP's sums.

Rounding: the plain version (as JAX) rounds ``y / keep`` and ``x + y`` to the
io dtype separately; the kernel multiplies in fp32 and rounds once.  In fp32
the two agree to the last ulp; in bf16 z can differ by one bf16 ulp (2^-8
relative).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from fairmultimodal_torch.ops import _build, _library
from fairmultimodal_torch.ops.fused_attention_block import _f32, _layer_norm_vjp
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
    return _plain(x, y, gamma, beta, eps, dropout)[0]


def _plain(x, y, gamma, beta, eps, dropout):
    """The plain forward: (out, z) with z = x + dropout(y) in x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    z = x + apply_dropout(y.to(x.dtype), dropout)
    out = F.layer_norm(z.to(acc), (x.shape[-1],), gamma.to(acc), beta.to(acc), eps)
    return out.to(x.dtype), z


def _rows(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1]).to(dt).contiguous()


def _stream(key, stream, threshold, inv_keep) -> Dropout:
    return Dropout() if key is None else Dropout(key, stream, threshold, inv_keep, 1)


def _glue_cpu(x: Tensor, y: Tensor, gamma: Tensor, beta: Tensor, key: Optional[Tensor],
              stream: int, threshold: int, inv_keep: float, eps: float, residuals: bool
              ) -> Tuple[Tensor, Tensor]:
    """(out, z): z = x + dropout(y) in x's dtype, the backward's residual
    (a placeholder without ``residuals``)."""
    out, z = _plain(x, y, gamma, beta, eps, _stream(key, stream, threshold, inv_keep))
    return out, z if residuals else _library.placeholder(x)


def _glue_cuda(x, y, gamma, beta, key, stream, threshold, inv_keep, eps, residuals):
    global launches
    x2 = _rows(x, x.dtype)
    out = torch.empty_like(x2)
    z = torch.empty_like(x2) if residuals else None
    _build.add_layernorm(x2, _rows(y, x.dtype), _f32(gamma), _f32(beta), out, eps,
                         _stream(key, stream, threshold, inv_keep), z)
    launches += 1
    return out.view(x.shape), z.view(x.shape) if residuals else _library.placeholder(x)


def _glue_fake(x, y, gamma, beta, key, stream, threshold, inv_keep, eps, residuals):
    return x.new_empty(x.shape), x.new_empty(x.shape) if residuals else _library.placeholder(x)


def _glue_bwd_cpu(g: Tensor, z: Tensor, gamma: Tensor, key: Optional[Tensor], stream: int,
                  threshold: int, inv_keep: float, eps: float
                  ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(dx, dy, dgamma, dbeta): dx = dz in z's dtype, dy its replayed
    dropout, in z's dtype too (autograd casts it to y's)."""
    dt = z.dtype
    acc = torch.promote_types(dt, torch.float32)
    h = z.shape[-1]
    dz, dgamma, dbeta = _layer_norm_vjp(g.reshape(-1, h).to(acc), z.reshape(-1, h), gamma, eps,
                                        acc)
    dz = dz.to(dt)
    dy = apply_dropout(dz, _stream(key, stream, threshold, inv_keep))
    return (dz.view(z.shape), (dy.clone() if dy is dz else dy).view(z.shape),
            dgamma.to(gamma.dtype), dbeta.to(gamma.dtype))


def _glue_bwd_cuda(g, z, gamma, key, stream, threshold, inv_keep, eps):
    global bwd_launches
    z2 = _rows(z, z.dtype)
    r, h = z2.shape
    f32 = dict(dtype=torch.float32, device=z.device)
    dz, dy = torch.empty_like(z2), torch.empty_like(z2)
    part = torch.empty((3, -(-r // _build.LN_BWD_ROWS), h), **f32)
    _build.layernorm_bwd(_rows(g, z.dtype), z2, _f32(gamma), dz, dy, part, eps,
                         _stream(key, stream, threshold, inv_keep))
    dgamma, dbeta = torch.empty((h,), **f32), torch.empty((h,), **f32)
    _build.colsum(part[:2], dgamma, dbeta)
    bwd_launches += 1
    return dz.view(z.shape), dy.view(z.shape), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


def _glue_bwd_fake(g, z, gamma, key, stream, threshold, inv_keep, eps):
    return (z.new_empty(z.shape), z.new_empty(z.shape), gamma.new_empty(gamma.shape),
            gamma.new_empty(gamma.shape))


def _glue_setup(ctx, inputs, output):
    x, y, gamma, beta, key, stream, threshold, inv_keep, eps, residuals = inputs
    _library.residual_context(
        ctx, (output[1], gamma, key),
        dict(stream=stream, threshold=threshold, inv_keep=inv_keep, eps=eps,
             residuals=residuals), output[1:])


def _glue_backward(ctx, g, _):
    if not ctx.residuals:
        raise RuntimeError("fm::dropout_add_layernorm was called without residuals")
    z, gamma, key = ctx.saved_tensors
    return (*dropout_add_layernorm_bwd_op(g, z, gamma, key, ctx.stream, ctx.threshold,
                                          ctx.inv_keep, ctx.eps),
            None, None, None, None, None, None)


dropout_add_layernorm_bwd_op = _library.register(
    "dropout_add_layernorm_bwd", _glue_bwd_cpu, _glue_bwd_cuda, _glue_bwd_fake)
dropout_add_layernorm_op = _library.register(
    "dropout_add_layernorm", _glue_cpu, _glue_cuda, _glue_fake, _glue_backward, _glue_setup)


def dropout_add_layernorm(x: torch.Tensor, y: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, *, eps: float,
                          dropout: Dropout = Dropout()) -> torch.Tensor:
    """``LayerNorm(x + dropout(y))`` over the last axis: x, y [..., H] in the
    io dtype (fp32 or bf16), gamma / beta [H]; ``dropout`` one Philox stream
    (``Dropout()`` for none; its seed an int or a key tensor).
    Differentiable.  On a CUDA tensor the row kernels (H % 8 == 0, H <= 1024,
    else the launch raises); on a CPU tensor the plain version
    (:func:`dropout_add_layernorm_reference`'s arithmetic)."""
    key = _library.key_of(dropout.seed if dropout.on else None, x.device)
    return dropout_add_layernorm_op(x, y, gamma, beta, key, dropout.stream, dropout.threshold,
                                    dropout.inv_keep, eps,
                                    _library.needs_grad(x, y, gamma, beta))[0]
