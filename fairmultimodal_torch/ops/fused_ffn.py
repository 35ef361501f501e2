"""FFN half-layer ``LayerNorm(x + dropout(act_dropout(x.W1 + b1).W2 + b2))`` on the card.

Port of ``fairmultimodal_tpu/ops/fused_ffn.py``: ``fused_ffn_ln`` /
``fused_ffn_ln_infer``, their forward Pallas kernel ``_fwd_ln_kernel`` (with
the inner and outer dropout) and the backward kernel ``_bwd_ln_kernel``.
``activation`` is ``"relu"`` (the lab encoder's torch encoder layer; inner
dropout after the relu) or ``"gelu"`` (BERT: exact erf gelu, no inner
dropout; the TPU kernel used a rational erf approximation because Mosaic
has no erf, CUDA has ``erff``).

On a CUDA tensor the forward is three hand-written kernel launches
(``csrc/``): x.W1 + b1 with the activation and the inner dropout in the GEMM
epilogue, rounded to the io dtype into an [R, F] buffer ``hd`` (for gelu the
pre-activation is what the backward keeps); that buffer times W2 plus b2 in
fp32; the residual + outer dropout + LayerNorm row kernel (storing z).
With grad enabled the call is a :class:`torch.autograd.Function` whose
backward is :func:`backward_stages`: the LayerNorm-backward row kernel (dz,
the replayed outer dropout, partial sums), ``dh = (dy.W2) * s`` with s =
1[hd > 0] / keep (the inner mask recovered from hd) or dgelu(hd), ``dx = dz
+ dh.W1``, ``dW1 = dh^T.x``, ``dW2 = dy^T.a``, and fixed-order column sums
for the bias, gamma and beta grads.

On a CPU tensor the wrappers run :func:`fused_ffn_ln_reference` and
:func:`fused_ffn_ln_backward_reference`.  ``seeds`` = (inner, outer): the
inner mask is Philox stream 0 of ``seeds[0]`` over [R, F], the outer stream
1 of ``seeds[1]`` over [R, H].  Weights take nn.Linear's [out, in] layout:
``w1`` [F, H], ``w2`` [H, F].  ``ln_eps`` has no default.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from fairmultimodal_torch.ops import _build
from fairmultimodal_torch.ops.fused_attention_block import (
    _f32, _layer_norm_rows, _layer_norm_vjp, _run, weight_grad)
from fairmultimodal_torch.utils.rng import Dropout, apply_dropout

__all__ = ["fused_ffn_ln", "fused_ffn_ln_infer", "fused_ffn_ln_reference",
           "fused_ffn_ln_backward_reference", "half_layer_stages", "backward_stages"]

#: Forward kernel launches on CUDA tensors since the last reset (one per half-layer).
launches = 0
#: Backward kernel launches on CUDA tensors since the last reset (one per half-layer).
bwd_launches = 0


def _check_activation(activation: str) -> None:
    if activation not in ("relu", "gelu"):
        raise ValueError(f"activation must be 'relu' or 'gelu', got {activation!r}")


def _streams(seeds: Optional[Sequence[int]], rate: float, activation: str):
    """(inner, outer) dropout streams; gelu (BERT) has no inner dropout."""
    if seeds is None or rate <= 0.0:
        return Dropout(), Dropout()
    inner = Dropout.make(seeds[0], 0, rate) if activation == "relu" else Dropout()
    return inner, Dropout.make(seeds[1], 1, rate)


def _dgelu(u: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(u * 0.7071067811865476)) + \
        u * (1.0 / math.sqrt(2.0 * math.pi)) * torch.exp(-0.5 * u * u)


def _forward_reference(x, w1, b1, w2, b2, gamma, beta, activation, ln_eps, inner, outer):
    dt = x.dtype
    x32 = x.float()
    h = x32 @ w1.float().t() + b1.float()
    if activation == "relu":
        hd = apply_dropout(torch.relu(h), inner).to(dt)     # the W2 operand and the residual
        a = hd
    else:
        hd = h.to(dt)                                  # the backward's pre-activation
        a = F.gelu(h).to(dt)
    y = apply_dropout(a.float() @ w2.float().t() + b2.float(), outer)
    z = (x32 + y).to(dt)
    return _layer_norm_rows(z.float(), gamma, beta, ln_eps).to(dt), {"hd": hd, "z": z}


def fused_ffn_ln_reference(x, w1, b1, w2, b2, gamma, beta, *, activation: str,
                           ln_eps: float, rate: float = 0.0,
                           seeds: Optional[Sequence[int]] = None,
                           return_residuals: bool = False):
    """Plain PyTorch version of the forward kernel with its rounding points:
    dropout(relu(h)) rounded (it is the W2 operand), gelu(h) computed in
    fp32 then rounded, z = x + dropout(y) rounded before the LayerNorm
    statistics.  x [R, H]; with ``return_residuals`` also the dict of hd, z
    the plain backward takes.  Differentiable by autograd."""
    _check_activation(activation)
    out, res = _forward_reference(x, w1, b1, w2, b2, gamma, beta, activation, ln_eps,
                                  *_streams(seeds, rate, activation))
    return (out, res) if return_residuals else out


def fused_ffn_ln_backward_reference(g, x, hd, z, w1, w2, gamma, *, activation: str,
                                    ln_eps: float, rate: float = 0.0,
                                    seeds: Optional[Sequence[int]] = None):
    """Plain PyTorch version of the backward kernel from the forward's
    residuals (hd [R, F], z [R, H], io dtype), rounding where
    ``_bwd_ln_kernel`` rounds: dy to the io dtype before both products, dh
    to the io dtype, dx to the io dtype; dW1 / dW2 accumulated in fp32 and
    cast to the weights' dtype, db1 summed from the fp32 dh and db2 from the
    fp32 dy before rounding (``fused_ffn.py:548-568, 693-697``).  The inner
    relu mask is recovered from hd > 0; gelu recomputes a = gelu(hd).

    Returns (dx, dw1, db1, dw2, db2, dgamma, dbeta)."""
    _check_activation(activation)
    inner, outer = _streams(seeds, rate, activation)
    return _backward_reference(g, x, hd, z, w1, w2, gamma, activation, ln_eps, outer,
                               inner.inv_keep)


def _backward_reference(g, x, hd, z, w1, w2, gamma, activation, ln_eps, outer, inv_keep):
    dt = x.dtype
    dz, dgamma, dbeta = _layer_norm_vjp(g.float(), z, gamma, ln_eps)
    dy = apply_dropout(dz, outer)
    dy_b = dy.to(dt).float()
    dh = dy_b @ w2.float()
    if activation == "relu":
        dh = dh * ((hd.float() > 0).float() * inv_keep)
        a = hd
    else:
        u = hd.float()
        dh = dh * _dgelu(u)
        a = F.gelu(u).to(dt)
    db1 = dh.sum(dim=0)
    dh_b = dh.to(dt).float()
    dx = (dz + dh_b @ w1.float()).to(dt)
    dw1 = (dh_b.t() @ x.float()).to(w1.dtype)
    dw2 = (dy_b.t() @ a.float()).to(w2.dtype)
    return (dx, dw1, db1.to(w1.dtype), dw2, dy.sum(dim=0).to(w2.dtype),
            dgamma.to(gamma.dtype), dbeta.to(gamma.dtype))


# -- the CUDA path ----------------------------------------------------------------------


def half_layer_stages(x, w1, b1, w2, b2, gamma, beta, *, activation: str, ln_eps: float,
                      inner: Dropout = Dropout(),
                      outer: Dropout = Dropout(), residuals: bool = False):
    """Check the operands of the CUDA forward and lay out its kernel
    launches: returns ``(stages, out, saved)`` as
    :func:`fused_attention_block.half_layer_stages` does."""
    _check_activation(activation)
    if x.dim() != 2:
        raise ValueError(f"x must be [R, H], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    r, h = x.shape
    f = w1.shape[0]
    for name, w, shape in (("w1", w1, (f, h)), ("w2", w2, (h, f))):
        if tuple(w.shape) != shape or w.dtype != x.dtype or w.device != x.device:
            raise ValueError(f"{name}: expected {list(shape)} {x.dtype} on {x.device}")
    dev = x.device
    w1, w2, b1, b2, gamma, beta = (w1.contiguous(), w2.contiguous(), _f32(b1), _f32(b2),
                                   _f32(gamma), _f32(beta))
    a = torch.empty((r, f), dtype=x.dtype, device=dev)
    pre = torch.empty_like(a) if residuals and activation == "gelu" else None
    y = torch.empty((r, h), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    z = torch.empty_like(x) if residuals else None
    stages = [
        ("w1_gemm_" + activation, lambda: _build.gemm(x, w1, a, bias=b1, activation=activation,
                                                      dropout=inner, aux=pre)),
        ("w2_gemm", lambda: _build.gemm(a, w2, y, bias=b2)),
        ("add_layernorm", lambda: _build.add_layernorm(x, y, gamma, beta, out, ln_eps, outer,
                                                       z)),
    ]
    saved = {"x": x, "hd": a if pre is None else pre, "z": z} if residuals else None
    return stages, out, saved


def backward_stages(g, saved: Dict[str, torch.Tensor], w1, w2, gamma, *, activation: str,
                    ln_eps: float, outer: Dropout = Dropout(),
                    inv_keep: float = 1.0):
    """Lay out the CUDA backward's launches: returns ``(stages, grads)`` with
    grads (dx, dw1, db1, dw2, db2, dgamma, dbeta), filled when the stages
    have run.  ``inv_keep`` scales the recovered relu mask (1/keep with the
    inner dropout on)."""
    x, hd, z = saved["x"], saved["hd"], saved["z"]
    r, h = x.shape
    f = hd.shape[1]
    dev, dt = x.device, x.dtype
    f32 = dict(dtype=torch.float32, device=dev)
    g = g.to(dt).contiguous()
    w1, w2, gamma = w1.contiguous(), w2.contiguous(), _f32(gamma)
    dz = torch.empty((r, h), **f32)
    dy = torch.empty((r, h), dtype=dt, device=dev)
    part = torch.empty((3, -(-r // _build.LN_BWD_ROWS), h), **f32)
    dh = torch.empty((r, f), dtype=dt, device=dev)
    db1part = torch.empty((-(-r // 128), f), **f32)
    a = hd if activation == "relu" else torch.empty_like(hd)   # gelu: round(gelu(hd))
    dx = torch.empty_like(x)
    dw1 = torch.empty((f, h), dtype=dt, device=dev)
    dw2 = torch.empty((h, f), dtype=dt, device=dev)
    db1 = torch.empty((f,), dtype=dt, device=dev)
    db2 = torch.empty((h,), dtype=dt, device=dev)
    dgamma = torch.empty((h,), **f32)
    dbeta = torch.empty((h,), **f32)

    def ln_sums():
        for i, dst in enumerate((dgamma, dbeta, db2)):
            _build.colsum(part[i], dst)

    gate = "relu" if activation == "relu" else "dgelu"
    stages = [
        ("layernorm_bwd", lambda: _build.layernorm_bwd(g, z, gamma, dz, dy, part, ln_eps,
                                                        outer)),
        ("ln_bias_sums", ln_sums),
        ("dh_gemm_" + activation, lambda: _build.gemm(
            dy, w2, dh, layout="nn", gate=hd, gate_kind=gate, gate_scale=inv_keep,
            aux=None if activation == "relu" else a, colpart=db1part)),
        ("db1_sum", lambda: _build.colsum(db1part, db1)),
        ("dx_gemm", lambda: _build.gemm(dh, w1, dx, layout="nn", resid=dz)),
        ("dw1_gemm", lambda: weight_grad(dh, x, dw1)),
        ("dw2_gemm", lambda: weight_grad(dy, a, dw2)),
    ]
    return stages, (dx, dw1, db1, dw2, db2, dgamma, dbeta)


class _HalfLayer(torch.autograd.Function):
    """Forward with residuals + backward; the kernels on CUDA tensors, the
    plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, gamma, beta, inner, outer, activation, ln_eps):
        global launches
        ctx.activation, ctx.ln_eps, ctx.outer = activation, ln_eps, outer
        ctx.inv_keep = inner.inv_keep
        ctx.param_dtype = gamma.dtype
        ctx.cuda = x.is_cuda
        if x.is_cuda:
            stages, out, saved = half_layer_stages(
                x, w1, b1, w2, b2, gamma, beta, activation=activation, ln_eps=ln_eps,
                inner=inner, outer=outer, residuals=True)
            _run(stages)
            launches += 1
            hd, z = saved["hd"], saved["z"]
        else:
            out, res = _forward_reference(x, w1, b1, w2, b2, gamma, beta, activation, ln_eps,
                                          inner, outer)
            hd, z = res["hd"], res["z"]
        ctx.save_for_backward(x, hd, z, w1, w2, gamma)
        return out

    @staticmethod
    def backward(ctx, g):
        global bwd_launches
        x, hd, z, w1, w2, gamma = ctx.saved_tensors
        if ctx.cuda:
            stages, grads = backward_stages(
                g, {"x": x, "hd": hd, "z": z}, w1, w2, gamma, activation=ctx.activation,
                ln_eps=ctx.ln_eps, outer=ctx.outer, inv_keep=ctx.inv_keep)
            _run(stages)
            bwd_launches += 1
            grads = grads[:-2] + tuple(t.to(ctx.param_dtype) for t in grads[-2:])
        else:
            grads = _backward_reference(g, x, hd, z, w1, w2, gamma, ctx.activation, ctx.ln_eps,
                                        ctx.outer, ctx.inv_keep)
        return (*grads, None, None, None, None)


def _infer(x, w1, b1, w2, b2, gamma, beta, activation, ln_eps, inner, outer):
    global launches
    _check_activation(activation)
    if not x.is_cuda:
        return _forward_reference(x, w1, b1, w2, b2, gamma, beta, activation, ln_eps,
                                  inner, outer)[0]
    stages, out, _ = half_layer_stages(x, w1, b1, w2, b2, gamma, beta, activation=activation,
                                       ln_eps=ln_eps, inner=inner, outer=outer)
    _run(stages)
    launches += 1
    return out


def fused_ffn_ln(x, w1, b1, w2, b2, gamma, beta, *, ln_eps: float,
                 activation: str = "relu", rate: float = 0.1, deterministic: bool = True,
                 seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
    """FFN half-layer ``LayerNorm(x + dropout(ffn(x)))``.

    x [R, H] (fp32 or bf16); w1 [F, H], w2 [H, F] and biases in ``x.dtype``;
    gamma/beta [H].  With ``deterministic=False`` and ``rate > 0`` the inner
    (relu only) and outer dropout draw from Philox ``seeds`` = (inner,
    outer), which is then required.  Differentiable: with grad enabled the
    backward runs the backward kernels (their plain version on a CPU
    tensor).  Returns [R, H].
    """
    _check_activation(activation)
    if not deterministic and rate > 0.0 and seeds is None:
        raise ValueError("dropout (deterministic=False, rate > 0) needs seeds")
    inner, outer = _streams(None if deterministic else seeds, rate, activation)
    args = (x, w1, b1, w2, b2, gamma, beta)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _HalfLayer.apply(*args, inner, outer, activation, ln_eps)
    return _infer(*args, activation, ln_eps, inner, outer)


def fused_ffn_ln_infer(x, w1, b1, w2, b2, gamma, beta, *, ln_eps: float,
                       activation: str = "relu") -> torch.Tensor:
    """Inference entry (the frozen text encoder's): the same math as
    :func:`fused_ffn_ln` with dropout off, storing no residuals."""
    return _infer(x, w1, b1, w2, b2, gamma, beta, activation, ln_eps, Dropout(),
                  Dropout())
