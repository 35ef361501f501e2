"""FFN half-layer kernels on the card, LayerNorm-fused and unfolded.

Port of ``fairmultimodal_tpu/ops/fused_ffn.py``, two kernel pairs:

- ``fused_ffn_ln`` / ``fused_ffn_ln_infer``: ``LayerNorm(x + dropout(
  act_dropout(x.W1 + b1).W2 + b2))``, the forward Pallas kernel
  ``_fwd_ln_kernel`` (with the inner and outer dropout) and the backward
  kernel ``_bwd_ln_kernel``;
- ``fused_ffn``: ``act_dropout(x.W1 + b1).W2 + b2`` alone, rounded to the io
  dtype: ``_fwd_kernel`` / ``_bwd_kernel``, which the JAX encoder layer runs
  with ``fold_ln=False`` and follows with XLA dropout + residual + LayerNorm
  (here :mod:`~fairmultimodal_torch.ops.dropout_add_layernorm`).

``activation`` is ``"relu"`` (the lab encoder's torch encoder layer; inner
dropout after the relu) or ``"gelu"`` (BERT: exact erf gelu, no inner
dropout; the TPU kernel used the Abramowitz & Stegun rational erf, within
1.5e-7 of erf, because Mosaic has no erf, CUDA has ``erff``).

On a CUDA tensor both forwards start with x.W1 + b1, the activation and the
inner dropout in the GEMM epilogue, rounded to the io dtype into an [R, F]
buffer ``hd`` (for gelu the pre-activation is what the backward keeps).
The LN-fused forward then runs that buffer times W2 plus b2 into fp32 and
the residual + outer dropout + LayerNorm row kernel (storing z); the
unfolded one runs W2 plus b2 rounded to the io dtype, as ``_fwd_kernel``
rounds ``out``.  Each pair is a torch op, ``fm::ffn_ln`` / ``fm::ffn_ln_bwd``
and ``fm::ffn`` / ``fm::ffn_bwd`` (``ops/_library.py``).  Both backwards
share ``dh = (dy.W2) * s`` with s = 1[hd > 0] / keep (the inner mask
recovered from hd) or dgelu(hd), its bias-grad column sums, ``dW1 =
dh^T.x`` and ``dW2 = dy^T.a``.  In
:func:`backward_stages` dy comes from the LayerNorm-backward row kernel
(dz, the replayed outer dropout, partial sums) and ``dx = dz + dh.W1``; in
:func:`ffn_backward_stages` dy is the cotangent g itself, ``dx = dh.W1`` is
a plain store and ``db2`` a fixed-order column sum of g.

On a CPU tensor the wrappers run the plain versions.  The LN-fused pair
takes ``seeds`` = (inner, outer): the inner mask is Philox stream 0 of
``seeds[0]`` over [R, F], the outer stream 1 of ``seeds[1]`` over [R, H];
``fused_ffn`` takes the inner ``seed`` alone (stream 0), so the two
configurations drop the same elements from one generator state.  Weights
take nn.Linear's [out, in] layout: ``w1`` [F, H], ``w2`` [H, F].  ``ln_eps``
has no default.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from fairmultimodal_torch.ops import _build, _library
from fairmultimodal_torch.ops.fused_attention_block import (
    _f32, _layer_norm_rows, _layer_norm_vjp, _run, column_sum, weight_grad)
from fairmultimodal_torch.ops.gates import can_use_fused_ffn
from fairmultimodal_torch.utils.rng import Dropout, Seed, apply_dropout

__all__ = ["fused_ffn_ln", "fused_ffn_ln_infer", "fused_ffn_ln_reference",
           "fused_ffn_ln_backward_reference", "half_layer_stages", "backward_stages",
           "fused_ffn", "fused_ffn_reference", "fused_ffn_backward_reference", "ffn_stages",
           "ffn_backward_stages", "can_use_fused_ffn"]

#: LN-fused forward launches (Pallas #2) on CUDA tensors since the last reset (one per half-layer).
launches = 0
#: LN-fused backward launches (Pallas #4) on CUDA tensors since the last reset.
bwd_launches = 0
#: Unfolded forward launches (Pallas #7) on CUDA tensors since the last reset.
unfolded_launches = 0
#: Unfolded backward launches (Pallas #8) on CUDA tensors since the last reset.
unfolded_bwd_launches = 0


def _check_activation(activation: str) -> None:
    if activation not in ("relu", "gelu"):
        raise ValueError(f"activation must be 'relu' or 'gelu', got {activation!r}")


def _streams(seeds: Optional[Sequence[Seed]], rate: float, activation: str):
    """(inner, outer) dropout streams; gelu (BERT) has no inner dropout."""
    if seeds is None or rate <= 0.0:
        return Dropout(), Dropout()
    inner = Dropout.make(seeds[0], 0, rate) if activation == "relu" else Dropout()
    return inner, Dropout.make(seeds[1], 1, rate)


def _inner_stream(seed: Optional[Seed], rate: float, deterministic: bool,
                  activation: str) -> Dropout:
    """The unfolded FFN's one dropout stream, after the relu."""
    if deterministic or rate <= 0.0:
        return Dropout()
    if activation == "gelu":
        # BERT's FFN has no inner dropout, and the gelu residual (the
        # pre-activation) could not recover a mask (fused_ffn.py:154-158).
        raise ValueError("gelu FFN supports no inner dropout")
    if seed is None:
        raise ValueError("dropout (deterministic=False, rate > 0) needs a seed")
    return Dropout.make(seed, 0, rate)


def _dgelu(u: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(u * 0.7071067811865476)) + \
        u * (1.0 / math.sqrt(2.0 * math.pi)) * torch.exp(-0.5 * u * u)


def _hidden(x, w1, b1, activation, inner):
    """(hd, a): the backward's [R, F] residual and the W2 operand, both in
    the io dtype.  relu: hd = a = round(dropout(relu(h))); gelu: hd =
    round(h) (the pre-activation), a = round(gelu(h)) from the fp32 h."""
    dt = x.dtype
    h = x.float() @ w1.float().t() + b1.float()
    if activation == "relu":
        hd = apply_dropout(torch.relu(h), inner).to(dt)
        return hd, hd
    return h.to(dt), F.gelu(h).to(dt)


def _forward_reference(x, w1, b1, w2, b2, gamma, beta, activation, ln_eps, inner, outer):
    dt = x.dtype
    hd, a = _hidden(x, w1, b1, activation, inner)
    y = apply_dropout(a.float() @ w2.float().t() + b2.float(), outer)
    z = (x.float() + y).to(dt)
    return _layer_norm_rows(z.float(), gamma, beta, ln_eps).to(dt), {"hd": hd, "z": z}


def _ffn_reference(x, w1, b1, w2, b2, activation, inner):
    hd, a = _hidden(x, w1, b1, activation, inner)
    return (a.float() @ w2.float().t() + b2.float()).to(x.dtype), {"hd": hd}


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


def fused_ffn_reference(x, w1, b1, w2, b2, *, activation: str = "relu", rate: float = 0.0,
                        seed: Optional[int] = None, return_residuals: bool = False):
    """Plain PyTorch version of ``_fwd_kernel`` with its rounding points:
    hd = round(dropout(relu(h))) (relu; inner dropout from Philox ``seed``,
    stream 0) or hd = round(h) and a = round(gelu(h)) (gelu), ``out =
    round(a . W2 + b2)``.  x [R, H]; with ``return_residuals`` also the dict
    of hd the plain backward takes.  Differentiable by autograd."""
    _check_activation(activation)
    inner = _inner_stream(seed, rate, seed is None, activation)
    out, res = _ffn_reference(x, w1, b1, w2, b2, activation, inner)
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


def fused_ffn_backward_reference(g, x, hd, w1, w2, *, activation: str = "relu",
                                 rate: float = 0.0, seed: Optional[int] = None):
    """Plain PyTorch version of ``_bwd_kernel`` from the cotangent g [R, H]
    and the forward's residual hd [R, F], rounding where it rounds
    (``fused_ffn.py:205-251``): dh = (g . W2) * s rounded (s = 1[hd > 0] /
    keep or dgelu(hd)), dx rounded; dW1 = dh^T x and dW2 = a^T g in fp32,
    db1 from the fp32 dh, db2 from g in fp32, all cast to the weights' dtype
    (``:340-350``).

    Returns (dx, dw1, db1, dw2, db2)."""
    _check_activation(activation)
    inner = _inner_stream(seed, rate, seed is None, activation)
    return _ffn_backward_reference(g, x, hd, w1, w2, activation, inner.inv_keep)


def _core_backward(dy_b, x, hd, w1, w2, activation, inv_keep):
    """The part both backwards share, from dy_b [R, H] (fp32 holding
    io-dtype values, the cotangent of the W2 product): returns the fp32
    ``dh . W1`` [R, H] and (dw1, db1, dw2) in the weights' dtype."""
    dt = x.dtype
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
    dw1 = (dh_b.t() @ x.float()).to(w1.dtype)
    dw2 = (dy_b.t() @ a.float()).to(w2.dtype)
    return dh_b @ w1.float(), (dw1, db1.to(w1.dtype), dw2)


def _backward_reference(g, x, hd, z, w1, w2, gamma, activation, ln_eps, outer, inv_keep):
    dt = x.dtype
    dz, dgamma, dbeta = _layer_norm_vjp(g.float(), z, gamma, ln_eps)
    dy = apply_dropout(dz, outer)
    dx32, (dw1, db1, dw2) = _core_backward(dy.to(dt).float(), x, hd, w1, w2, activation,
                                           inv_keep)
    return ((dz + dx32).to(dt), dw1, db1, dw2, dy.sum(dim=0).to(w2.dtype),
            dgamma.to(gamma.dtype), dbeta.to(gamma.dtype))


def _ffn_backward_reference(g, x, hd, w1, w2, activation, inv_keep):
    g32 = g.to(x.dtype).float()
    dx32, (dw1, db1, dw2) = _core_backward(g32, x, hd, w1, w2, activation, inv_keep)
    return dx32.to(x.dtype), dw1, db1, dw2, g32.sum(dim=0).to(w2.dtype)


# -- the CUDA path ----------------------------------------------------------------------


def _hidden_stage(x, w1, b1, w2, activation, inner, residuals):
    """Check the operands and lay out the W1 launch both forwards start
    with; returns ``(stage, a, hd)``: the W2 operand and, with
    ``residuals``, the backward's [R, F] residual (else None)."""
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
    w1, b1 = w1.contiguous(), _f32(b1)
    a = torch.empty((r, f), dtype=x.dtype, device=x.device)
    pre = torch.empty_like(a) if residuals and activation == "gelu" else None
    stage = ("w1_gemm_" + activation, lambda: _build.gemm(x, w1, a, bias=b1,
                                                          activation=activation,
                                                          dropout=inner, aux=pre))
    hd = (a if pre is None else pre) if residuals else None
    return stage, a, hd


def half_layer_stages(x, w1, b1, w2, b2, gamma, beta, *, activation: str, ln_eps: float,
                      inner: Dropout = Dropout(),
                      outer: Dropout = Dropout(), residuals: bool = False):
    """Check the operands of the LN-fused CUDA forward and lay out its
    kernel launches: returns ``(stages, out, saved)`` as
    :func:`fused_attention_block.half_layer_stages` does."""
    w1_stage, a, hd = _hidden_stage(x, w1, b1, w2, activation, inner, residuals)
    r, h = x.shape
    w2, b2, gamma, beta = w2.contiguous(), _f32(b2), _f32(gamma), _f32(beta)
    y = torch.empty((r, h), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    z = torch.empty_like(x) if residuals else None
    stages = [
        w1_stage,
        ("w2_gemm", lambda: _build.gemm(a, w2, y, bias=b2)),
        ("add_layernorm", lambda: _build.add_layernorm(x, y, gamma, beta, out, ln_eps, outer,
                                                       z)),
    ]
    saved = {"x": x, "hd": hd, "z": z} if residuals else None
    return stages, out, saved


def ffn_stages(x, w1, b1, w2, b2, *, activation: str, inner: Dropout = Dropout(),
               residuals: bool = False):
    """Lay out the unfolded CUDA forward (Pallas #7) as
    :func:`half_layer_stages` does: W1 with the activation and the inner
    dropout, then W2 plus b2 into the io dtype; with ``residuals`` the
    tensors :func:`ffn_backward_stages` needs."""
    w1_stage, a, hd = _hidden_stage(x, w1, b1, w2, activation, inner, residuals)
    w2, b2 = w2.contiguous(), _f32(b2)
    out = torch.empty_like(x)
    stages = [w1_stage, ("w2_gemm", lambda: _build.gemm(a, w2, out, bias=b2))]
    return stages, out, ({"x": x, "hd": hd} if residuals else None)


def _core_backward_stages(dy, saved, w1, w2, activation, inv_keep):
    """The launches both backwards share, from dy [R, H] (io dtype): dh
    with its gate and bias-grad partials, db1, dW1 and dW2.  Returns
    ``(stages, dh, (dw1, db1, dw2))``."""
    x, hd = saved["x"], saved["hd"]
    r, h = x.shape
    f = hd.shape[1]
    dev, dt = x.device, x.dtype
    w2 = w2.contiguous()
    dh = torch.empty((r, f), dtype=dt, device=dev)
    db1part = torch.empty((-(-r // 128), f), dtype=torch.float32, device=dev)
    a = hd if activation == "relu" else torch.empty_like(hd)   # gelu: round(gelu(hd))
    dw1 = torch.empty((f, h), dtype=dt, device=dev)
    dw2 = torch.empty((h, f), dtype=dt, device=dev)
    db1 = torch.empty((f,), dtype=dt, device=dev)
    gate = "relu" if activation == "relu" else "dgelu"
    stages = [
        ("dh_gemm_" + activation, lambda: _build.gemm(
            dy, w2, dh, layout="nn", gate=hd, gate_kind=gate, gate_scale=inv_keep,
            aux=None if activation == "relu" else a, colpart=db1part)),
        ("db1_sum", lambda: _build.colsum(db1part, db1)),
        ("dw1_gemm", lambda: weight_grad(dh, x, dw1)),
        ("dw2_gemm", lambda: weight_grad(dy, a, dw2)),
    ]
    return stages, dh, (dw1, db1, dw2)


def backward_stages(g, saved: Dict[str, torch.Tensor], w1, w2, gamma, *, activation: str,
                    ln_eps: float, outer: Dropout = Dropout(),
                    inv_keep: float = 1.0):
    """Lay out the LN-fused CUDA backward's launches: returns ``(stages,
    grads)`` with grads (dx, dw1, db1, dw2, db2, dgamma, dbeta), filled when
    the stages have run.  ``inv_keep`` scales the recovered relu mask (1/keep
    with the inner dropout on)."""
    x, z = saved["x"], saved["z"]
    r, h = x.shape
    dev, dt = x.device, x.dtype
    f32 = dict(dtype=torch.float32, device=dev)
    g = g.to(dt).contiguous()
    gamma = _f32(gamma)
    dz = torch.empty((r, h), **f32)
    dy = torch.empty((r, h), dtype=dt, device=dev)
    part = torch.empty((3, -(-r // _build.LN_BWD_ROWS), h), **f32)
    dx = torch.empty_like(x)
    db2 = torch.empty((h,), dtype=dt, device=dev)
    dgamma = torch.empty((h,), **f32)
    dbeta = torch.empty((h,), **f32)
    core, dh, (dw1, db1, dw2) = _core_backward_stages(dy, saved, w1, w2, activation, inv_keep)

    stages = [
        ("layernorm_bwd", lambda: _build.layernorm_bwd(g, z, gamma, dz, dy, part, ln_eps,
                                                        outer)),
        ("ln_bias_sums", lambda: _build.colsum(part, dgamma, dbeta, db2)),
        *core[:2],
        ("dx_gemm", lambda: _build.gemm(dh, w1.contiguous(), dx, layout="nn", resid=dz)),
        *core[2:],
    ]
    return stages, (dx, dw1, db1, dw2, db2, dgamma, dbeta)


def ffn_backward_stages(g, saved: Dict[str, torch.Tensor], w1, w2, *, activation: str,
                        inv_keep: float = 1.0):
    """Lay out the unfolded CUDA backward (Pallas #8) from the cotangent g
    [R, H]: returns ``(stages, grads)`` with grads (dx, dw1, db1, dw2, db2),
    filled when the stages have run."""
    x = saved["x"]
    r, h = x.shape
    g = g.reshape(r, h).to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    db2 = torch.empty((h,), dtype=x.dtype, device=x.device)
    core, dh, (dw1, db1, dw2) = _core_backward_stages(g, saved, w1, w2, activation, inv_keep)
    stages = [
        *core[:2],
        ("dx_gemm", lambda: _build.gemm(dh, w1.contiguous(), dx, layout="nn")),
        *core[2:],
        ("db2_sum", lambda: column_sum(g, db2)),
    ]
    return stages, (dx, dw1, db1, dw2, db2)


# -- the ops (``_library``): Pallas #2 / #4 and #7 / #8 ---------------------------------


def _keys(inner: Dropout, outer: Dropout, device):
    return tuple(_library.key_of(d.seed if d.on else None, device) for d in (inner, outer))


def _ffn_ln_cpu(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor, gamma: Tensor,
                beta: Tensor, inner_key: Optional[Tensor], outer_key: Optional[Tensor],
                rate: float, activation: str, ln_eps: float, residuals: bool
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """Pallas #2: (out, hd, z), hd and z the backward's residuals
    (placeholders without ``residuals``); the inner stream is 0 of
    ``inner_key``, the outer stream 1 of ``outer_key``."""
    out, res = _forward_reference(x, w1, b1, w2, b2, gamma, beta, activation, ln_eps,
                                  Dropout.make(inner_key, 0, rate),
                                  Dropout.make(outer_key, 1, rate))
    return (out, *_library.residual_outputs(x, res if residuals else None, ("hd", "z")))


def _ffn_ln_cuda(x, w1, b1, w2, b2, gamma, beta, inner_key, outer_key, rate, activation,
                 ln_eps, residuals):
    global launches
    stages, out, saved = half_layer_stages(
        x, w1, b1, w2, b2, gamma, beta, activation=activation, ln_eps=ln_eps,
        inner=Dropout.make(inner_key, 0, rate),
        outer=Dropout.make(outer_key, 1, rate), residuals=residuals)
    _run(stages)
    launches += 1
    return (out, *_library.residual_outputs(x, saved, ("hd", "z")))


def _hidden_fake(x, w1, residuals):
    return x.new_empty((x.shape[0], w1.shape[0])) if residuals else _library.placeholder(x)


def _ffn_ln_fake(x, w1, b1, w2, b2, gamma, beta, inner_key, outer_key, rate, activation,
                 ln_eps, residuals):
    return (x.new_empty(x.shape), _hidden_fake(x, w1, residuals),
            x.new_empty(x.shape) if residuals else _library.placeholder(x))


def _ffn_ln_bwd_cpu(g: Tensor, x: Tensor, hd: Tensor, z: Tensor, w1: Tensor, w2: Tensor,
                    gamma: Tensor, outer_key: Optional[Tensor], rate: float, inv_keep: float,
                    activation: str, ln_eps: float
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Pallas #4: (dx, dw1, db1, dw2, db2, dgamma, dbeta); ``inv_keep``
    scales the relu mask recovered from hd (1/keep with the inner dropout
    on)."""
    return _backward_reference(g, x, hd, z, w1, w2, gamma, activation, ln_eps,
                               Dropout.make(outer_key, 1, rate), inv_keep)


def _ffn_ln_bwd_cuda(g, x, hd, z, w1, w2, gamma, outer_key, rate, inv_keep, activation,
                     ln_eps):
    global bwd_launches
    stages, grads = backward_stages(
        g, {"x": x, "hd": hd, "z": z}, w1, w2, gamma, activation=activation, ln_eps=ln_eps,
        outer=Dropout.make(outer_key, 1, rate), inv_keep=inv_keep)
    _run(stages)
    bwd_launches += 1
    return (*grads[:-2], *(t.to(gamma.dtype) for t in grads[-2:]))


def _weight_grads_fake(x, w1, w2):
    return (x.new_empty(x.shape), w1.new_empty(w1.shape), w1.new_empty((w1.shape[0],)),
            w2.new_empty(w2.shape), w2.new_empty((w2.shape[0],)))


def _ffn_ln_bwd_fake(g, x, hd, z, w1, w2, gamma, outer_key, rate, inv_keep, activation,
                     ln_eps):
    return (*_weight_grads_fake(x, w1, w2), gamma.new_empty(gamma.shape),
            gamma.new_empty(gamma.shape))


def _ffn_ln_setup(ctx, inputs, output):
    x, w1, b1, w2, b2, gamma, beta, inner_key, outer_key, rate, activation, ln_eps, \
        residuals = inputs
    _, hd, z = output
    inv_keep = Dropout.make(inner_key, 0, rate).inv_keep
    _library.residual_context(
        ctx, (x, hd, z, w1, w2, gamma, outer_key),
        dict(rate=rate, inv_keep=inv_keep, activation=activation, ln_eps=ln_eps,
             residuals=residuals), output[1:])


def _ffn_ln_backward(ctx, g, *_):
    if not ctx.residuals:
        raise RuntimeError("fm::ffn_ln was called without residuals")
    grads = ffn_ln_bwd_op(g, *ctx.saved_tensors, ctx.rate, ctx.inv_keep, ctx.activation,
                          ctx.ln_eps)
    return (*grads, None, None, None, None, None, None)


ffn_ln_bwd_op = _library.register("ffn_ln_bwd", _ffn_ln_bwd_cpu, _ffn_ln_bwd_cuda,
                                  _ffn_ln_bwd_fake)
ffn_ln_op = _library.register("ffn_ln", _ffn_ln_cpu, _ffn_ln_cuda, _ffn_ln_fake,
                              _ffn_ln_backward, _ffn_ln_setup)


def _ffn_cpu(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
             key: Optional[Tensor], rate: float, activation: str, residuals: bool
             ) -> Tuple[Tensor, Tensor]:
    """Pallas #7: (out, hd), hd the backward's residual; the inner dropout
    is stream 0 of ``key``."""
    out, res = _ffn_reference(x, w1, b1, w2, b2, activation, Dropout.make(key, 0, rate))
    return (out, *_library.residual_outputs(x, res if residuals else None, ("hd",)))


def _ffn_cuda(x, w1, b1, w2, b2, key, rate, activation, residuals):
    global unfolded_launches
    stages, out, saved = ffn_stages(x, w1, b1, w2, b2, activation=activation,
                                    inner=Dropout.make(key, 0, rate),
                                    residuals=residuals)
    _run(stages)
    unfolded_launches += 1
    return (out, *_library.residual_outputs(x, saved, ("hd",)))


def _ffn_fake(x, w1, b1, w2, b2, key, rate, activation, residuals):
    return x.new_empty(x.shape), _hidden_fake(x, w1, residuals)


def _ffn_bwd_cpu(g: Tensor, x: Tensor, hd: Tensor, w1: Tensor, w2: Tensor, inv_keep: float,
                 activation: str) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Pallas #8: (dx, dw1, db1, dw2, db2)."""
    return _ffn_backward_reference(g, x, hd, w1, w2, activation, inv_keep)


def _ffn_bwd_cuda(g, x, hd, w1, w2, inv_keep, activation):
    global unfolded_bwd_launches
    stages, grads = ffn_backward_stages(g, {"x": x, "hd": hd}, w1, w2, activation=activation,
                                        inv_keep=inv_keep)
    _run(stages)
    unfolded_bwd_launches += 1
    return grads


def _ffn_bwd_fake(g, x, hd, w1, w2, inv_keep, activation):
    return _weight_grads_fake(x, w1, w2)


def _ffn_setup(ctx, inputs, output):
    x, w1, b1, w2, b2, key, rate, activation, residuals = inputs
    _library.residual_context(
        ctx, (x, output[1], w1, w2),
        dict(inv_keep=Dropout.make(key, 0, rate).inv_keep, activation=activation,
             residuals=residuals), output[1:])


def _ffn_backward(ctx, g, *_):
    if not ctx.residuals:
        raise RuntimeError("fm::ffn was called without residuals")
    grads = ffn_bwd_op(g, *ctx.saved_tensors, ctx.inv_keep, ctx.activation)
    return (*grads, None, None, None, None)


ffn_bwd_op = _library.register("ffn_bwd", _ffn_bwd_cpu, _ffn_bwd_cuda, _ffn_bwd_fake)
ffn_op = _library.register("ffn", _ffn_cpu, _ffn_cuda, _ffn_fake, _ffn_backward, _ffn_setup)


def fused_ffn_ln(x, w1, b1, w2, b2, gamma, beta, *, ln_eps: float,
                 activation: str = "relu", rate: float = 0.1, deterministic: bool = True,
                 seeds: Optional[Sequence[Seed]] = None) -> torch.Tensor:
    """FFN half-layer ``LayerNorm(x + dropout(ffn(x)))``.

    x [R, H] (fp32 or bf16); w1 [F, H], w2 [H, F] and biases in ``x.dtype``;
    gamma/beta [H].  With ``deterministic=False`` and ``rate > 0`` the inner
    (relu only) and outer dropout draw from Philox ``seeds`` = (inner,
    outer), ints or key tensors, which are then required.  Differentiable:
    with grad enabled the backward is ``fm::ffn_ln_bwd`` (#4; its plain
    version on a CPU tensor).  Returns [R, H].
    """
    _check_activation(activation)
    if not deterministic and rate > 0.0 and seeds is None:
        raise ValueError("dropout (deterministic=False, rate > 0) needs seeds")
    inner, outer = _streams(None if deterministic else seeds, rate, activation)
    args = (x, w1, b1, w2, b2, gamma, beta)
    return ffn_ln_op(*args, *_keys(inner, outer, x.device), rate, activation, ln_eps,
                     _library.needs_grad(*args))[0]


def fused_ffn_ln_infer(x, w1, b1, w2, b2, gamma, beta, *, ln_eps: float,
                       activation: str = "relu") -> torch.Tensor:
    """Inference entry (the frozen text encoder's): the same math as
    :func:`fused_ffn_ln` with dropout off, storing no residuals."""
    _check_activation(activation)
    return ffn_ln_op(x, w1, b1, w2, b2, gamma, beta, None, None, 0.0, activation, ln_eps,
                     False)[0]


def fused_ffn(x, w1, b1, w2, b2, *, activation: str = "relu", rate: float = 0.1,
              deterministic: bool = True, seed: Optional[Seed] = None) -> torch.Tensor:
    """FFN ``dropout(act(x . W1^T + b1)) . W2^T + b2`` (the JAX ``fused_ffn``,
    ``fused_ffn.py:305``).

    x [R, H] (fp32 or bf16); w1 [F, H], w2 [H, F] and biases in ``x.dtype``.
    With ``deterministic=False`` and ``rate > 0`` the dropout after the relu
    draws from Philox ``seed`` (an int or a key tensor; required), stream 0;
    gelu takes no dropout and raises if asked for one.  Differentiable
    (``fm::ffn_bwd``, Pallas #8's backward; its plain version on a CPU
    tensor).  Returns [R, H] in ``x.dtype``.
    """
    _check_activation(activation)
    inner = _inner_stream(seed, rate, deterministic, activation)
    args = (x, w1, b1, w2, b2)
    key = _library.key_of(inner.seed if inner.on else None, x.device)
    return ffn_op(*args, key, rate if inner.on else 0.0, activation,
                  _library.needs_grad(*args))[0]
