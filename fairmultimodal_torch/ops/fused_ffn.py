"""FFN half-layer ``LayerNorm(x + act(x.W1 + b1).W2 + b2)`` on the card.

Port of ``fairmultimodal_tpu/ops/fused_ffn.py``: ``fused_ffn_ln`` /
``fused_ffn_ln_infer`` and their Pallas kernel ``_fwd_ln_kernel``, forward
only with dropout off (the backward and dropout are the training slice's).
``activation`` is ``"relu"`` (the lab encoder's torch encoder layer) or
``"gelu"`` (BERT: exact erf gelu; the TPU kernel used a rational erf
approximation because Mosaic has no erf, CUDA has ``erff``).

On a CUDA tensor the half-layer is three hand-written kernel launches
(``csrc/``): x.W1 + b1 with the activation in the GEMM epilogue, rounded to
the io dtype into an [R, F] buffer; that buffer times W2 plus b2 in fp32;
the residual + LayerNorm row kernel.  The Pallas kernel keeps the [R, F]
intermediate in VMEM; here it round-trips device memory.

On a CPU tensor the wrappers run :func:`fused_ffn_ln_reference`.  Weights
take nn.Linear's [out, in] layout: ``w1`` [F, H], ``w2`` [H, F] (the JAX
package's Dense kernels transposed, as :mod:`fairmultimodal_torch.interop`
does).  ``ln_eps`` has no default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fairmultimodal_torch.ops import _build
from fairmultimodal_torch.ops.fused_attention_block import _layer_norm_rows

__all__ = ["fused_ffn_ln", "fused_ffn_ln_infer", "fused_ffn_ln_reference",
           "half_layer_stages"]

#: Kernel launches on CUDA tensors since the last reset (one per half-layer).
launches = 0


def _check_activation(activation: str) -> None:
    if activation not in ("relu", "gelu"):
        raise ValueError(f"activation must be 'relu' or 'gelu', got {activation!r}")


def fused_ffn_ln_reference(x, w1, b1, w2, b2, gamma, beta, *, activation: str,
                           ln_eps: float) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's rounding points: relu(h)
    rounded (it is the W2 operand), gelu(h) computed in fp32 then rounded,
    z = x + y rounded before the LayerNorm statistics.  x [R, H]."""
    _check_activation(activation)
    dt = x.dtype
    x32 = x.float()
    h = x32 @ w1.float().t() + b1.float()
    a = (torch.relu(h) if activation == "relu" else F.gelu(h)).to(dt)
    y = a.float() @ w2.float().t() + b2.float()
    z = (x32 + y).to(dt)
    return _layer_norm_rows(z.float(), gamma, beta, ln_eps).to(dt)


def half_layer_stages(x, w1, b1, w2, b2, gamma, beta, *, activation: str, ln_eps: float):
    """Check the operands of the CUDA half-layer and lay out its kernel
    launches: returns ``(stages, out)``, the launches in order as
    ``(name, thunk)`` pairs and the [R, H] tensor the last one fills (see
    :func:`fused_attention_block.half_layer_stages`)."""
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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2, gamma, beta)):
        raise NotImplementedError(
            "the CUDA FFN half-layer is forward only; its backward kernel comes "
            "with the training slice (run under torch.inference_mode())")
    dev = x.device
    f32 = lambda t: t.to(torch.float32).contiguous()
    w1, w2, b1, b2, gamma, beta = (w1.contiguous(), w2.contiguous(), f32(b1), f32(b2),
                                   f32(gamma), f32(beta))
    a = torch.empty((r, f), dtype=x.dtype, device=dev)
    y = torch.empty((r, h), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    stages = [
        ("w1_gemm_" + activation, lambda: _build.gemm_bias_act(x, w1, b1, a, activation)),
        ("w2_gemm", lambda: _build.gemm_bias_act(a, w2, b2, y)),
        ("add_layernorm", lambda: _build.add_layernorm(x, y, gamma, beta, out, ln_eps)),
    ]
    return stages, out


def _launch(x, w1, b1, w2, b2, gamma, beta, activation, ln_eps):
    global launches
    stages, out = half_layer_stages(x, w1, b1, w2, b2, gamma, beta, activation=activation,
                                    ln_eps=ln_eps)
    for _, run in stages:
        run()
    launches += 1
    return out


def _forward(x, w1, b1, w2, b2, gamma, beta, activation, ln_eps):
    if x.is_cuda:
        return _launch(x, w1, b1, w2, b2, gamma, beta, activation, ln_eps)
    return fused_ffn_ln_reference(x, w1, b1, w2, b2, gamma, beta,
                                  activation=activation, ln_eps=ln_eps)


def fused_ffn_ln(x, w1, b1, w2, b2, gamma, beta, *, ln_eps: float,
                 activation: str = "relu", rate: float = 0.1,
                 deterministic: bool = True) -> torch.Tensor:
    """FFN half-layer ``LayerNorm(x + dropout(ffn(x)))``.

    x [R, H] (fp32 or bf16); w1 [F, H], w2 [H, F] and biases in ``x.dtype``;
    gamma/beta [H].  Dropout is not available in this port yet:
    ``deterministic=False`` with ``rate > 0`` raises.  Returns [R, H].
    """
    if not deterministic and rate > 0.0:
        raise NotImplementedError(
            "dropout in the FFN half-layer comes with the training slice")
    return _forward(x, w1, b1, w2, b2, gamma, beta, activation, ln_eps)


def fused_ffn_ln_infer(x, w1, b1, w2, b2, gamma, beta, *, ln_eps: float,
                       activation: str = "relu") -> torch.Tensor:
    """Inference entry (the frozen text encoder's): the same math as
    :func:`fused_ffn_ln` with dropout off."""
    return _forward(x, w1, b1, w2, b2, gamma, beta, activation, ln_eps)
