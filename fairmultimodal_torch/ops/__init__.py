"""Ops of the port: the CUDA half-layer kernels with their plain versions,
attention, losses and the kernel-path gates.

The package exports the JAX ``fairmultimodal_tpu.ops`` names.  Two of them,
``flash_attention`` and ``fused_ffn``, are also the names of the submodules
that hold those wrappers (the JAX package's function hides its module).
Here the name stays the module, and the module is callable as its wrapper,
so ``ops.flash_attention(q, k, v, mask)`` and ``from
fairmultimodal_torch.ops import flash_attention as flash; flash.launches``
both hold.
"""

import types

from fairmultimodal_torch.ops import flash_attention, fused_ffn
from fairmultimodal_torch.ops.attention import attention_reference, multi_head_attention
from fairmultimodal_torch.ops.fused_ffn import can_use_fused_ffn
from fairmultimodal_torch.ops.losses import bce_with_logits, focal_loss, sigmoid

__all__ = ["multi_head_attention", "attention_reference", "flash_attention",
           "fused_ffn", "can_use_fused_ffn",
           "bce_with_logits", "focal_loss", "sigmoid"]


class _CallableModule(types.ModuleType):
    """A kernel module called as the wrapper it is named after."""

    def __call__(self, *args, **kwargs):
        return getattr(self, self.__name__.rsplit(".", 1)[1])(*args, **kwargs)


for _module in (flash_attention, fused_ffn):
    _module.__class__ = _CallableModule
del _module
