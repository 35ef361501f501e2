"""FairEHR-CLP's contrastive components (port of
``fairmultimodal_tpu/models/fairehr.py``; reference 06_FairEHR-CLP.py).

- :class:`DemographicEncoder` -- MLP in -> 128 -> 128 (06:280-289);
- :class:`LongitudinalEncoder` -- each lab scalar a token (Linear(1, E)), a
  width-3 convolution along the feature axis, two ``TorchEncoderLayer``\\ s
  (256, 8 heads, FFN 512) without a mask, the mean over the features and a
  projection (06:291-309, the JAX package's shape-corrected form);
- :class:`NotesProjector`, :class:`FusionModule`, :class:`DynamicRelevance`
  (the learnable sigmoid gate, ones-initialised) and :class:`FairEHRCLP`,
  which encodes the real and the synthetic view through the same modules and
  classifies the gated real one (06:311-470);
- :func:`contrastive_loss` -- InfoNCE over (real, synthetic) pairs plus the
  synthetic view's variance, ``weight`` masking pad rows (06:472-487);
- :func:`synthesize_demographics` / :func:`synthesize_longitudinal` -- the
  Gaussian perturbations (06:227-233), drawn from a :class:`torch.Generator`
  (the pipeline draws its views with numpy instead, as the JAX one does).

The convolution is flax's ``nn.Conv(kernel_size=(3,), padding="SAME")``
over the channels-last [B, F, E] activation.  Its weight is an
``nn.Conv1d(E, C, 3)``'s [C, E, 3] (``interop`` carries flax's [3, E, C]
kernel across), applied as one matrix product over the three shifted
windows, so it follows the matmul precision (IEEE fp32 on the card) and
not cuDNN's TF32 default.  On the card the encoder layers take the FFN
kernels (#2 / #4: H 256 and F 512 pass their gate); at S = F = 549 the
attention gates refuse, and the attention runs the plain path.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from fairmultimodal_torch.models._layers import dropout_seed, linear
from fairmultimodal_torch.models.behrt import TorchEncoderLayer
from fairmultimodal_torch.utils.rng import dropout

__all__ = ["DemographicEncoder", "LongitudinalEncoder", "NotesProjector", "FusionModule",
           "DynamicRelevance", "FairEHRCLP", "contrastive_loss", "synthesize_demographics",
           "synthesize_longitudinal"]


class DemographicEncoder(nn.Module):
    """``fc1`` + ReLU + ``fc2``."""

    def __init__(self, in_features: int = 4, hidden: int = 128, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(torch.relu(linear(x, self.fc1, self.dtype)), self.fc2, self.dtype)


def conv1d_same(x: torch.Tensor, conv: nn.Conv1d, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(C, (k,), padding="SAME")`` on channels-last x [B, F, E]
    with an ``nn.Conv1d(E, C, k)``'s weight, k odd: [B, F, C]."""
    c, e, k = conv.weight.shape
    half = k // 2
    xp = F.pad(x.to(dtype), (0, 0, half, half))                        # [B, F + k - 1, E]
    n = x.shape[1]
    windows = torch.cat([xp[:, i:i + n] for i in range(k)], dim=-1)    # [B, F, k E]
    w = conv.weight.permute(0, 2, 1).reshape(c, k * e)                 # [C, (k, E)]
    return F.linear(windows, w.to(dtype), conv.bias.to(dtype))


class LongitudinalEncoder(nn.Module):
    """[B, F] lab scalars -> [B, E]: ``feature_embedding`` Linear(1, E),
    ``conv``, ``layer_<i>`` encoder layers, mean over F, ``proj``."""

    def __init__(self, embed_dim: int = 256, conv_out: int = 256, num_heads: int = 8,
                 num_layers: int = 2, ffn: int = 512, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_layers = num_layers
        self.feature_embedding = nn.Linear(1, embed_dim)
        self.conv = nn.Conv1d(embed_dim, conv_out, 3)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TorchEncoderLayer(conv_out, num_heads, ffn_size=ffn,
                                                            dtype=dtype))
        self.proj = nn.Linear(conv_out, embed_dim)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        h = conv1d_same(linear(x[..., None], self.feature_embedding, dt), self.conv, dt)
        for i in range(self.num_layers):
            h = getattr(self, f"layer_{i}")(h, None, generator)
        acc = torch.promote_types(dt, torch.float32)
        return linear(h.to(acc).mean(dim=1).to(dt), self.proj, dt)


class NotesProjector(nn.Module):
    """``proj`` + ReLU over the precomputed note embedding."""

    def __init__(self, in_features: int = 768, out: int = 256, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Linear(in_features, out)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return torch.relu(linear(emb, self.proj, self.dtype))


class FusionModule(nn.Module):
    """``fc1`` + ReLU + ``fc2`` over the concatenated branches."""

    def __init__(self, in_features: int, fusion_dim: int = 256, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(in_features, fusion_dim)
        self.fc2 = nn.Linear(fusion_dim, fusion_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(torch.relu(linear(x, self.fc1, self.dtype)), self.fc2, self.dtype)


class DynamicRelevance(nn.Module):
    """``sigmoid(weights) * x``, the gate in the parameter's dtype cast to x's;
    ``weights`` starts at ones."""

    init_ones = ("weights",)

    def __init__(self, dim: int = 256):
        super().__init__()
        self.weights = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.weights).to(x.dtype) * x


class FairEHRCLP(nn.Module):
    """The full model: both views through ``demo_encoder``,
    ``long_encoder``, ``notes_encoder``, ``fusion`` and the gate ``dr``; the
    gated real view through ``classifier_hidden`` + ReLU + dropout +
    ``classifier`` (06:344-353).

    ``batch``: ``demo_features`` [B, Dd], ``lab_features`` [B, F],
    ``text_embedding`` [B, T] and optionally ``*_syn`` views of each (absent:
    the real one).  Returns fp32 ``logits`` [B, tasks], ``e_adj`` and
    ``e_adj_syn`` [B, fusion_dim].  The encoder's dropout draws its seeds
    for the real view, then for the synthetic one.
    """

    def __init__(self, num_tasks: int = 3, demo_features: int = 4, demo_hidden: int = 128,
                 embed_dim: int = 256, fusion_dim: int = 256, text_embed_size: int = 768,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.demo_encoder = DemographicEncoder(demo_features, demo_hidden, dtype)
        self.long_encoder = LongitudinalEncoder(embed_dim=embed_dim, dtype=dtype)
        self.notes_encoder = NotesProjector(text_embed_size, embed_dim, dtype)
        self.fusion = FusionModule(demo_hidden + 2 * embed_dim, fusion_dim, dtype)
        self.dr = DynamicRelevance(fusion_dim)
        self.classifier_hidden = nn.Linear(fusion_dim, fusion_dim // 2)
        self.classifier = nn.Linear(fusion_dim // 2, num_tasks)
        self.dropout_rate = 0.1

    def _view(self, demo, lab, text, generator):
        return self.dr(self.fusion(torch.cat([
            self.demo_encoder(demo), self.long_encoder(lab, generator),
            self.notes_encoder(text)], dim=-1)))

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        dt, rate = self.dtype, self.dropout_rate
        demo, lab, text = (batch[k].to(dt) for k in ("demo_features", "lab_features",
                                                       "text_embedding"))
        e_adj = self._view(demo, lab, text, generator)
        e_adj_syn = self._view(batch.get("demo_features_syn", demo),
                               batch.get("lab_features_syn", lab),
                               batch.get("text_embedding_syn", text), generator)
        h = torch.relu(linear(e_adj, self.classifier_hidden, dt))
        h = dropout(h, rate, dropout_seed(self, rate, generator))
        return {"logits": linear(h, self.classifier, dt).to(torch.float32),
                "e_adj": e_adj.to(torch.float32), "e_adj_syn": e_adj_syn.to(torch.float32)}


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)


def contrastive_loss(e_real: torch.Tensor, e_syn: torch.Tensor, tau: float = 0.5,
                     gamma: float = 0.1, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """InfoNCE of each real row against every synthetic row (its own the
    positive) plus ``gamma`` times the synthetic view's variance.  With
    ``weight``, pad columns get an additive -1e9 and both terms are means
    over the real rows with the denominator ``max(sum(weight), 1)``."""
    sim = _l2_normalize(e_real) @ _l2_normalize(e_syn).T / tau              # [B, B]
    if weight is not None:
        sim = sim + torch.where(weight[None, :] > 0, 0.0, -1e9).to(sim.dtype)
    nce = -(torch.diagonal(sim) - torch.logsumexp(sim, dim=1))
    if weight is None:
        return nce.mean() + gamma * ((e_syn - e_syn.mean(dim=0, keepdim=True)) ** 2).mean()
    w = weight.to(sim.dtype)
    denom = torch.clamp(w.sum(), min=1.0)
    mean_syn = (e_syn * w[:, None]).sum(dim=0, keepdim=True) / denom
    reg = (((e_syn - mean_syn) ** 2) * w[:, None]).sum() / (denom * e_syn.shape[1])
    return (nce * w).sum() / denom + gamma * reg


def synthesize_demographics(generator: torch.Generator, demo: torch.Tensor,
                            scale: float = 0.05) -> torch.Tensor:
    """``demo`` plus N(0, scale^2) noise (06:227-229)."""
    noise = torch.randn(demo.shape, generator=generator, dtype=demo.dtype,
                        device=generator.device)
    return demo + scale * noise.to(demo.device)


def synthesize_longitudinal(generator: torch.Generator, lab: torch.Tensor,
                            scale: float = 0.01) -> torch.Tensor:
    """``lab`` plus N(0, scale^2) noise (06:231-233)."""
    return synthesize_demographics(generator, lab, scale)
