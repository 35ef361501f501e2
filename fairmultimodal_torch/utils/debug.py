"""NaN debugging (port of ``fairmultimodal_tpu/utils/debug.py``; replaces
the reference's NaN-batch skipping, 01_BEHRT.py:227-229, with checks).

- :func:`enable_nan_checks`: autograd's anomaly mode;
- :func:`check_finite_tree`: the paths of the non-finite floating leaves of
  a module, a state dict or a nested mapping of tensors or arrays, instead
  of training on NaNs silently.
"""

from __future__ import annotations

from typing import List, Mapping

import torch
from torch import nn

__all__ = ["enable_nan_checks", "check_finite_tree"]


def enable_nan_checks(enabled: bool = True) -> None:
    """Autograd anomaly mode: a backward that produces NaN raises at the op,
    with the forward traceback that made it.  This checks the backward pass;
    the JAX package's ``jax_debug_nans`` checks every primitive."""
    torch.autograd.set_detect_anomaly(enabled)


def check_finite_tree(tree, name: str = "tree") -> List[str]:
    """``name/a/b`` for each floating leaf holding a NaN or an infinity
    (empty when clean).  Mapping keys are visited in sorted order, as
    ``jax.tree_util`` flattens a dict; a module is read as its state dict,
    whose ``.``-joined keys become ``/``-joined paths.  On
    ``interop.flax_params(module)`` the paths are the JAX package's for the
    same tree."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, Mapping):
        return [path for key in sorted(tree)
                for path in check_finite_tree(tree[key], f"{name}/{str(key).replace('.', '/')}")]
    leaf = torch.as_tensor(tree)
    if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
        return [name]
    return []
