"""Multi-head attention, plain PyTorch (port of ``fairmultimodal_tpu/ops/attention.py``).

Every attention that no half-layer kernel takes runs here: the S=1 demo
BERT and the 64 / 128 text buckets, and a ``TorchEncoderLayer`` with
``attn_kernel=False``.  The JAX package would send 256 <= S <= 1024 with the
megakernel gate off (``BertSelfAttention`` in training mode, the layer with
``attn_kernel=False`` or ``fused_qkv=True``) to its Pallas flash kernel
(#9, backward #10); those are the kernels on this route still to port, so
those shapes run the plain version below.
"""

from __future__ import annotations

from typing import Optional

import torch

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
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v [B, heads, S, D]; mask [B, S]."""
    if q.shape[2] == 1:
        # One token attending to itself: the softmax over one key is 1, so
        # the output is v (the demo BERT's dummy-token input).
        return v
    return attention_reference(q, k, v, mask)
