"""Multi-head attention (port of ``fairmultimodal_tpu/ops/attention.py``).

Every attention that no half-layer kernel takes runs here: the S=1 demo
BERT, the 64 / 128 text buckets, ``BertSelfAttention`` in training mode and
a ``TorchEncoderLayer`` with ``attn_kernel=False`` or ``fused_qkv=True``.
``multi_head_attention`` dispatches as the JAX function does
(``attention.py:73-93``): S = 1 returns v; otherwise a CUDA tensor whose
shapes pass :func:`~fairmultimodal_torch.ops.gates.can_use_flash_attention`
(256 <= S <= 1024, S % 16 == 0, d in {32, 64, 96, 128}), or any call with
``use_kernel=True``, goes to :func:`~fairmultimodal_torch.ops.flash_attention.
flash_attention` (Pallas #9, backward #10); everything else to the plain
:func:`attention_reference`.
"""

from __future__ import annotations

from typing import Optional

import torch

from fairmultimodal_torch.ops.flash_attention import flash_attention
from fairmultimodal_torch.ops.gates import can_use_flash_attention

__all__ = ["multi_head_attention", "attention_reference"]


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v [B, heads, S, D]; mask [B, S] (1 = attend).

    Scores and softmax in at least fp32, probabilities rounded to the input
    dtype before p.v, output in the input dtype -- as the JAX reference.
    """
    dtype = q.dtype
    acc = torch.promote_types(dtype, torch.float32)
    scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
    scores = scores / torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=acc))
    if mask is not None:
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(acc)
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(dtype).to(acc), v.to(acc))
    return out.to(dtype)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         use_kernel: Optional[bool] = None) -> torch.Tensor:
    """q, k, v [B, heads, S, D]; mask [B, S].  ``use_kernel`` (the JAX
    ``use_pallas``): None applies the gate, True takes the flash wrapper (its
    plain version on a CPU tensor), False the plain path."""
    if q.shape[2] == 1:
        # One token attending to itself: the softmax over one key is 1, so
        # the output is v (the demo BERT's dummy-token input).
        return v
    if use_kernel is None:
        use_kernel = can_use_flash_attention(q)
    if use_kernel:
        return flash_attention(q, k, v, mask)
    return attention_reference(q, k, v, mask)
