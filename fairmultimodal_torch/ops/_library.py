"""The port's kernels as torch ops: the ``fm`` namespace.

Every kernel entry of the port is an op ``fm::<name>``, defined by the module
of its wrapper through :func:`register` on one ``torch.library.Library``
(the dispatcher itself, without ``custom_op``'s Python layer, whose checks
cost a host call tens of microseconds), each with

- a CUDA impl: the hand-written launches, counted in the module's launch
  counters (one per call on the host: under CUDA-graph capture a call counts
  once, however often the graph replays; under fake tensors it counts
  nothing);
- a CPU impl: the module's plain PyTorch version;
- ``register_fake``: the impls' shapes, dtypes and strides, so that
  ``torch.compile`` traces through the op;
- ``register_autograd`` on each forward op: its backward is the matching
  ``fm::<name>_bwd`` op (also registered, with a fake, and no autograd of its
  own).

The schema is the CPU impl's signature (``torch.library.infer_schema``).
What a backward needs from its forward are outputs of the forward op (the
residuals), computed only when its ``residuals`` argument is true: otherwise
each is a 0-element placeholder.  They are marked non-differentiable, and
gradients are not materialised for them.  An op's schema takes tensors,
ints, floats, bools and strs only: a dropout stream travels as its key (a
0-dim int64 tensor, ``utils/rng.py``; None when off) with its stream index
and rate or threshold, and an optional mask as ``Tensor?``.

Call an op directly as ``torch.ops.fm.ffn_ln(...)`` or through the object its
module defines (``fused_ffn.ffn_ln_op``, the op's ``OpOverload``); the public
wrappers (``fused_ffn_ln``, ``flash_attention``, ...) check their arguments,
turn seeds into keys and call the op.  :data:`OPS` lists every op.
"""

from __future__ import annotations

from typing import Optional

import torch

from fairmultimodal_torch.utils.rng import Seed, device_key

__all__ = ["NS", "OPS", "key_of", "needs_grad", "placeholder", "residual_outputs", "register",
           "residual_context"]

#: The ops' namespace.
NS = "fm"
#: ``fm::`` name -> the op (its ``OpOverload``), forward and backward, in the
#: order the modules register them.
OPS = {}
_LIB = torch.library.Library(NS, "DEF")


def key_of(seed: Optional[Seed], device: torch.device) -> Optional[torch.Tensor]:
    """The key tensor an op takes for ``seed``: None for none, a key tensor
    as it is, an int as a key on ``device`` (:func:`~fairmultimodal_torch.
    utils.rng.device_key`)."""
    if seed is None or isinstance(seed, torch.Tensor):
        return seed
    return device_key(seed, device)


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether a call's outputs need a backward: then its forward op keeps
    its residuals."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def placeholder(like: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A residual the call does not keep: a 0-element tensor."""
    return like.new_empty((0,), dtype=dtype or like.dtype)


def residual_outputs(like: torch.Tensor, saved: Optional[dict], names):
    """A forward op's residual outputs: ``saved``'s tensors by ``names``, or
    placeholders when the call keeps none (``saved`` None)."""
    if saved is None:
        return tuple(placeholder(like) for _ in names)
    return tuple(saved[n] for n in names)


def register(name: str, cpu, cuda, fake, backward=None, setup_context=None):
    """``fm::<name>`` with the schema of ``cpu`` (its CPU impl), ``cuda`` as
    its CUDA impl, ``fake`` and, for a forward, its autograd formula.
    Returns the op."""
    qualname = f"{NS}::{name}"
    _LIB.define(name + torch.library.infer_schema(cpu, mutates_args=()))
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(qualname, fake, lib=_LIB)
    if backward is not None:
        torch.library.register_autograd(qualname, backward, setup_context=setup_context,
                                        lib=_LIB)
    op = getattr(torch.ops.fm, name).default
    OPS[name] = op
    return op


def residual_context(ctx, saved, constants, residuals):
    """The common part of a forward op's ``setup_context``: its residual
    outputs marked non-differentiable, no zero gradients made for them, the
    tensors the backward needs saved and its other arguments on ``ctx``."""
    ctx.set_materialize_grads(False)
    ctx.mark_non_differentiable(*residuals)
    ctx.save_for_backward(*saved)
    for k, v in constants.items():
        setattr(ctx, k, v)
