"""Device resolution and the shape gates of the CUDA kernel path.

The JAX package routes a half-layer to its Pallas kernel when the backend
is a TPU and the shapes fit the kernel (``fairmultimodal_tpu/ops/gates.py``
plus the ``can_use_*`` functions).  Here "the tensor lies on a CUDA device"
takes the place of "the backend is a TPU", and the shape rules are the same,
so the port takes the kernel path on exactly the shapes the JAX package
does: the lab encoder (S 560) and the 256 / 512 text buckets, never the S=1
demo BERT or the 64 / 128 buckets.  Behind a passed gate the encoder layer
runs the LayerNorm-fused kernels (#1-#4) or, with ``fold_ln=False`` /
``FMTPU_FOLD_LN=0``, the unfolded ones (#5-#8); ``TorchEncoderLayer``'s
``attn_kernel`` / ``ffn_kernel`` fields can force a wrapper (True) or the
plain path (False) past the gates, as the JAX layer's fields do.  Where the
megakernel is not taken -- ``attn_kernel=False``, ``fused_qkv=True``,
``BertSelfAttention`` in training mode -- ``ops/attention.py`` applies
:func:`can_use_flash_attention` (``attention.py:54-70``) and runs the flash
kernels (#9 / #10) on the shapes it passes.

There is no kill switch.  On a CUDA tensor that passes a gate the wrapper
launches its kernel or raises; on a CPU tensor the wrappers run their plain
PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "can_use_fused_attention_block", "can_use_fused_ffn",
           "can_use_flash_attention"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means CUDA.  Raises when CUDA is asked for and absent: the
    port never drops silently to the CPU; callers pass ``"cpu"`` for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def can_use_fused_attention_block(x: torch.Tensor, num_heads: int) -> bool:
    """Attention half-layer kernel gate (``fused_attention_block.py:964``):
    CUDA tensor, fp32/bf16, H % 128 == 0, d = H/heads <= 128,
    256 <= S <= 1024 and S % 16 == 0."""
    if not x.is_cuda or x.dtype not in _KERNEL_DTYPES:
        return False
    _, s, h = x.shape
    if h % num_heads or h % 128:
        return False
    return 256 <= s <= 1024 and s % 16 == 0 and h // num_heads <= 128


def can_use_fused_ffn(x: torch.Tensor, hdim: int, fdim: int) -> bool:
    """FFN half-layer kernel gate (``fused_ffn.py:703``): CUDA tensor,
    fp32/bf16, H and F multiples of 128."""
    if not x.is_cuda or x.dtype not in _KERNEL_DTYPES:
        return False
    return hdim % 128 == 0 and fdim % 128 == 0


def can_use_flash_attention(q: torch.Tensor) -> bool:
    """Flash-attention kernel gate (``attention.py:54-70``): CUDA tensor,
    fp32/bf16, q [B, heads, S, d] with S % 16 == 0, d in {32, 64, 96, 128}
    and 256 <= S <= 1024."""
    if not q.is_cuda or q.dtype not in _KERNEL_DTYPES:
        return False
    _, _, s, d = q.shape
    return s % 16 == 0 and d in (32, 64, 96, 128) and 256 <= s <= 1024
