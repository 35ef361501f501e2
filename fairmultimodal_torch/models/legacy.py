"""The legacy-generation models (port of ``fairmultimodal_tpu/models/legacy.py``).

- :class:`BEHRTSequence` -- the sequence BEHRT of FinalCode/New/02_BEHRT.py
  (:175-240): per-admission disease ids through a BERT (pad id 0, which is
  also the attention mask: ``ids != 0``), seven per-position embedding tables
  (ids clipped into each) summed onto its output, and one single-logit head
  per task on the first position.
- :class:`EDDIEnhancementLayer` / :class:`EDDIDotFusion` -- the early EDDI
  layer (FinalCode/Code/EDDI.py:203-261): each modality's 256-d projection
  times ``sigmoid(projection) * eddi_weight`` summed to one scalar per
  branch; the three scalars feed ``dense1`` 512 + ReLU + dropout +
  ``dense2``.
- :class:`LegacyEDDIFull` -- BEHRT-Demo + BEHRT-Lab + the text embedding
  through :class:`EDDIDotFusion`, two tasks (EDDI.py:225-322).

On the card the lab encoder runs the LN-fused kernels #1-#4; the sequence
BERT runs at S = the longest admission sequence rounded up to 8, below every
kernel gate.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from fairmultimodal_torch.models._layers import dropout_seed, embed, linear
from fairmultimodal_torch.models.behrt import BEHRTDemo, BEHRTLab
from fairmultimodal_torch.models.bert import BertConfig, BertEncoderModel
from fairmultimodal_torch.models.fusion import _out_dtype, _Projector
from fairmultimodal_torch.utils.rng import dropout

__all__ = ["BEHRTSequence", "EDDIEnhancementLayer", "EDDIDotFusion", "LegacyEDDIFull"]

_SEQ_TABLES = (("age_ids", "age_embedding"), ("segment_ids", "segment_embedding"),
               ("adm_loc_ids", "admission_loc_embedding"),
               ("disch_loc_ids", "discharge_loc_embedding"),
               ("gender_ids", "gender_embedding"), ("ethnicity_ids", "ethnicity_embedding"),
               ("insurance_ids", "insurance_embedding"))


class BEHRTSequence(nn.Module):
    """Batch keys, each [B, S] int: ``disease_ids`` and the seven of
    :data:`_SEQ_TABLES`.  Returns ``{"logits": [B, 3]}`` (mortality, los,
    mech) in at least fp32.  The BERT's vocabulary is diseases + ages +
    segments + both location tables + 2, its FFN 4 H."""

    def __init__(self, num_diseases: int, num_ages: int, num_segments: int = 2,
                 num_admission_locs: int = 100, num_discharge_locs: int = 100,
                 num_genders: int = 2, num_ethnicities: int = 6, num_insurances: int = 6,
                 hidden_size: int = 768, num_hidden_layers: int = 12,
                 num_attention_heads: int = 12, num_tasks: int = 3, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        vocab = (num_diseases + num_ages + num_segments + num_admission_locs
                 + num_discharge_locs + 2)
        self.bert = BertEncoderModel(BertConfig(
            vocab_size=vocab, hidden_size=hidden_size, num_hidden_layers=num_hidden_layers,
            num_attention_heads=num_attention_heads, intermediate_size=hidden_size * 4),
            dtype)
        sizes = (num_ages, num_segments, num_admission_locs, num_discharge_locs, num_genders,
                 num_ethnicities, num_insurances)
        for (_, name), n in zip(_SEQ_TABLES, sizes):
            self.add_module(name, nn.Embedding(n, hidden_size))
        self.classifier_mortality = nn.Linear(hidden_size, 1)
        self.classifier_los = nn.Linear(hidden_size, 1)
        self.classifier_mech = nn.Linear(hidden_size, 1)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        dt = self.dtype
        ids = batch["disease_ids"]
        x = self.bert(ids, (ids != 0).to(torch.int32), generator=generator)    # [B, S, H]
        for key, name in _SEQ_TABLES:
            table = getattr(self, name)
            x = x + embed(batch[key].clamp(0, table.num_embeddings - 1), table, dt)
        cls = x[:, 0, :]
        logits = torch.cat([linear(cls, head, dt) for head in (
            self.classifier_mortality, self.classifier_los, self.classifier_mech)], dim=-1)
        return {"logits": logits.to(_out_dtype(dt))}


class EDDIEnhancementLayer(nn.Module):
    """``sigmoid(x) * eddi_weight``, the weight ones-initialised and cast to
    x's dtype."""

    init_ones = ("eddi_weight",)

    def __init__(self, dim: int = 256):
        super().__init__()
        self.eddi_weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(x) * self.eddi_weight.to(x.dtype)


class EDDIDotFusion(nn.Module):
    """Per branch ``<m>_projector`` -> ``eddi_<m>`` -> the dot product of the
    projection and its enhancement; the [B, 3] scalars through ``dense1`` +
    ReLU + dropout + ``dense2``.  Returns ``logits`` and ``branch_scalars``
    in at least fp32."""

    def __init__(self, demo_dim: int, lab_dim: int, text_dim: int, proj_dim: int = 256,
                 fusion_hidden: int = 512, num_tasks: int = 3, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        for name, dim in (("demo", demo_dim), ("lab", lab_dim), ("text", text_dim)):
            self.add_module(f"{name}_projector", _Projector(dim, proj_dim, dtype))
            self.add_module(f"eddi_{name}", EDDIEnhancementLayer(proj_dim))
        self.dense1 = nn.Linear(3, fusion_hidden)
        self.dense2 = nn.Linear(fusion_hidden, num_tasks)
        self.dropout_rate = 0.1

    def forward(self, demo_emb, lab_emb, text_emb,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        dt, rate = self.dtype, self.dropout_rate
        scalars = []
        for name, x in (("demo", demo_emb), ("lab", lab_emb), ("text", text_emb)):
            proj = getattr(self, f"{name}_projector")(x)
            enhanced = getattr(self, f"eddi_{name}")(proj)
            scalars.append((proj * enhanced).sum(dim=-1, keepdim=True))
        fused = torch.cat(scalars, dim=-1)                                   # [B, 3]
        h = torch.relu(linear(fused, self.dense1, dt))
        h = dropout(h, rate, dropout_seed(self, rate, generator))
        od = _out_dtype(dt)
        return {"logits": linear(h, self.dense2, dt).to(od), "branch_scalars": fused.to(od)}


class LegacyEDDIFull(nn.Module):
    """``behrt_demo`` (12L/12H) + ``behrt_lab`` (2L/8H) + the text embedding
    through ``fusion`` (:class:`EDDIDotFusion`), two tasks (mortality,
    readmission within 30 days)."""

    def __init__(self, num_ages: int, num_genders: int, num_ethnicities: int,
                 num_insurances: int, lab_token_count: int, hidden_size: int = 768,
                 demo_layers: int = 12, demo_heads: int = 12, lab_layers: int = 2,
                 lab_heads: int = 8, num_tasks: int = 2, text_embed_size: int = 768,
                 dtype=torch.float32):
        super().__init__()
        self.behrt_demo = BEHRTDemo(num_ages, num_genders, num_ethnicities, num_insurances,
                                    hidden_size=hidden_size, num_hidden_layers=demo_layers,
                                    num_attention_heads=demo_heads, dtype=dtype)
        self.behrt_lab = BEHRTLab(lab_token_count, hidden_size, num_heads=lab_heads,
                                  num_layers=lab_layers, dtype=dtype)
        self.fusion = EDDIDotFusion(hidden_size, hidden_size, text_embed_size,
                                    num_tasks=num_tasks, dtype=dtype)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        demo = self.behrt_demo(batch["demo_dummy_ids"], batch["demo_attn_mask"],
                               batch["age_ids"], batch["gender_ids"], batch["ethnicity_ids"],
                               batch["insurance_ids"], generator)
        lab = self.behrt_lab(batch["lab_features"], generator)
        return self.fusion(demo, lab, batch["text_embedding"], generator)
