"""JAX-package parameters <-> this port's state dicts.

The port's module and parameter names mirror the flax tree, so the mapping
is mechanical: a nested dict (as flax gives it, or as
:func:`fairmultimodal_torch.utils.checkpoint.load_params_npz` reads an
exported ``best_model_*.npz``) is flattened with ``.`` and each leaf renamed:

- Dense ``kernel`` [in, out] -> ``weight`` [out, in] (transposed);
- Conv ``kernel`` [k, in, out] -> ``weight`` [out, in, k] (an
  ``nn.Conv1d``'s; flax's channels-last 1-D convolution);
- Embed ``embedding`` -> ``weight``;
- LayerNorm ``scale`` -> ``weight`` (``bias`` stays ``bias``);
- raw parameters (``pos_embedding``, ``sig_weights``, ``sig_weights_*``)
  pass through.

The same function serves ``FAMEModel``, ``BertEncoderModel`` and the
baseline models' trees (``models/baselines.py``: ``BEHRTFull``'s seven
tables, the ``head_<task>_<modality>`` denses, 09's gates), 03's DfC, 06's
FairEHR-CLP (its gate ``weights`` passes through) and the legacy models.
:func:`flax_params` is the inverse, for writing checkpoints in the JAX
format.  A 2-D ``weight`` is a Dense kernel or an Embed table and a 1-D one
a LayerNorm scale, so it dispatches on the type of the module that owns the
parameter, never on its shape (a 3-D ``kernel`` is always a convolution's).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["state_dict_from_flax", "load_flax_params", "flax_params", "flax_leaf"]


def state_dict_from_flax(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested flax parameter dict -> flat port state dict (fp32 tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in params.items():
        if isinstance(val, Mapping):
            out.update(state_dict_from_flax(val, f"{prefix}{key}."))
            continue
        arr = np.asarray(val, dtype=np.float32)
        if key == "kernel" and arr.ndim == 3:
            out[prefix + "weight"] = torch.from_numpy(arr.transpose(2, 1, 0).copy())
        elif key == "kernel":
            out[prefix + "weight"] = torch.from_numpy(arr.T.copy())
        elif key in ("embedding", "scale"):
            out[prefix + "weight"] = torch.from_numpy(arr.copy())
        else:
            out[prefix + key] = torch.from_numpy(arr.copy())
    return out


def load_flax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Load a flax parameter tree into ``module`` (strict: every parameter
    of the module must be present and nothing extra)."""
    module.load_state_dict(state_dict_from_flax(params), strict=True)
    return module


def flax_params(module: nn.Module,
                state_dict: Optional[Mapping[str, torch.Tensor]] = None) -> Dict:
    """The module's parameters (or ``state_dict``'s values for them, such as
    a saved best state) -> the nested flax tree of fp32 numpy arrays that
    :func:`state_dict_from_flax` reads back."""
    values = dict(module.named_parameters()) if state_dict is None else state_dict
    tree: Dict = {}
    for name, _ in module.named_parameters():
        arr = values[name].detach().float().cpu().numpy()
        key, _ = flax_leaf(module, name, arr.shape)
        if key.endswith("/kernel") or key == "kernel":
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 1, 0)
        *parents, leaf = key.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def flax_leaf(module: nn.Module, name: str, shape=()):
    """A parameter's flax path (``/``-joined) and its shape in flax's layout
    (a Dense kernel ``[in, out]``, a convolution's ``[k, in, out]``), from
    the port's name and shape."""
    path, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    owner = module.get_submodule(path)
    shape = tuple(shape)
    if isinstance(owner, nn.Linear) and leaf == "weight":
        leaf, shape = "kernel", shape[::-1]
    elif isinstance(owner, nn.Conv1d) and leaf == "weight":
        leaf, shape = "kernel", shape[::-1]
    elif isinstance(owner, nn.Embedding) and leaf == "weight":
        leaf = "embedding"
    elif isinstance(owner, nn.LayerNorm) and leaf == "weight":
        leaf = "scale"
    return "/".join(path.split(".") + [leaf]) if path else leaf, shape
