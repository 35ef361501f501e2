"""Helpers shared by the port's modules: flax-style compute-dtype layers,
dropout seeds and the seeded random init.

Parameters stay fp32 and are cast to the module's compute ``dtype`` at use,
as flax's ``nn.Dense(dtype=...)`` / ``nn.Embed`` / ``nn.LayerNorm`` do, so a
bf16 model computes in bf16 from fp32 weights exactly like the JAX one.
LayerNorm statistics run in at least fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fairmultimodal_torch.parallel.sharding import copy_to_model, reduce_from_model
from fairmultimodal_torch.utils.rng import Seed, draw_seed

__all__ = ["linear", "layer_norm", "embed", "dropout_seed", "column_input", "row_linear",
           "init_params"]


def linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    acc = torch.promote_types(dtype, torch.float32)
    return F.layer_norm(x.to(acc), ln.normalized_shape, ln.weight.to(acc),
                        ln.bias.to(acc), ln.eps).to(dtype)


def embed(ids: torch.Tensor, table: nn.Embedding, dtype: torch.dtype) -> torch.Tensor:
    return F.embedding(ids.long(), table.weight).to(dtype)


def dropout_seed(module: nn.Module, rate: float, generator: Optional[torch.Generator],
                 sharded: bool = False) -> Optional[Seed]:
    """Philox seed of one dropout site, drawn on the host from the caller's
    generator when ``module`` trains and has dropout (from a
    :class:`~fairmultimodal_torch.utils.rng.KeyTape`, the site's key); None
    (no dropout) otherwise.  Dropout runs in train mode given a generator: no module
    draws from the global RNG (the JAX modules' ``rngs={"dropout": ...}``).
    ``sharded``: the site's activation is a tensor-parallel shard
    (``utils/rng.py::draw_seed``)."""
    if module.training and rate > 0.0 and generator is not None:
        return draw_seed(generator, sharded)
    return None


def column_input(x: torch.Tensor, tp) -> torch.Tensor:
    """The input of a half-layer's column-parallel products: ``x``, through
    the model group's "copy" on a sharded half (``tp``, its mesh)."""
    return x if tp is None else copy_to_model(x, tp)


def row_linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype, tp) -> torch.Tensor:
    """A half-layer's row-parallel product: :func:`linear`, or on a sharded
    half this rank's partial sum reduced over the model group, then the
    (replicated) bias added once."""
    if tp is None:
        return linear(x, lin, dtype)
    partial = F.linear(x.to(dtype), lin.weight.to(dtype))
    return reduce_from_model(partial, tp) + lin.bias.to(dtype)


@torch.no_grad()
def init_params(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init in flax's families: Dense kernels normal with
    std 1/sqrt(fan_in) and zero bias, embeddings normal with std
    1/sqrt(features), LayerNorm ones/zeros, ``nn.Conv1d`` kernels normal
    with std 1/sqrt(in x width), a raw parameter named in its module's
    ``init_ones`` (06's gate, the legacy EDDI weights) ones, and the other
    raw parameters (``pos_embedding``, ``sig_weights``) standard normal.  The
    values differ from the JAX init (a different generator); parity tests
    carry the JAX weights across with :mod:`fairmultimodal_torch.interop`
    instead."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(owner, nn.LayerNorm):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif isinstance(owner, nn.Linear) and leaf == "weight":
            p.copy_(torch.randn(p.shape, generator=gen) * p.shape[1] ** -0.5)
        elif isinstance(owner, nn.Embedding):
            p.copy_(torch.randn(p.shape, generator=gen) * p.shape[1] ** -0.5)
        elif isinstance(owner, nn.Conv1d) and leaf == "weight":
            p.copy_(torch.randn(p.shape, generator=gen) * (p.shape[1] * p.shape[2]) ** -0.5)
        elif leaf in getattr(owner, "init_ones", ()):
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=gen))
    return module
