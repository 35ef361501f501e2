"""The baseline models (port of ``fairmultimodal_tpu/models/baselines.py``).

Each takes one ``model_inputs`` dict (and, in train mode, the caller's
dropout generator) and returns the JAX keys, so every baseline trains under
:class:`~fairmultimodal_torch.train.simple.MultitaskTrainer`.  Module and
parameter names mirror the flax trees, so JAX weights load with
:func:`fairmultimodal_torch.interop.load_flax_params`.

- :class:`BEHRTFull` -- BERT CLS over a dummy token, run per row (no
  broadcast), plus the mean of seven demographic / ward embeddings
  (04_AdvDebias.py:254-301, shared by 06 / 07).
- :class:`StructTextModel` -- BEHRTFull + the text embedding through
  :class:`AverageFusionModel` (07_multimodal_average_fusion.py:205-238).
- :class:`TextOnlyClassifier` -- 02's 768 -> 256 -> T head over the frozen
  note embeddings (02_BioClinicalBERT.py:122-134).
- :class:`SigmoidFusionFull` -- 09's demo BERT + lab encoder + text with the
  sigmoid gates (09_multimodal_sigmoid_fusion.py:106-222).
- :class:`EDDIFusionFull` -- 08's 6L/6H demo BERT + lab + text with three
  256-d projectors and one single-logit head per (task, modality)
  (08_multimodal_eddi_fusion.py:261-402); ``task_modality_logits`` [B, T, 3].
- :class:`BEHRTLabOnlyModel` -- 01's structured-only baseline.

The lab encoders run the LN-fused kernels #1-#4 on the card; the demo and
full BERTs run at one token, where the kernel gate sends them down the plain
path.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from fairmultimodal_torch.models._layers import dropout_seed, embed, linear
from fairmultimodal_torch.models.behrt import BEHRTCombined, BEHRTDemo, BEHRTLab
from fairmultimodal_torch.models.bert import BertConfig, BertEncoderModel
from fairmultimodal_torch.models.fusion import (AverageFusionModel, SigmoidFusionModel,
                                                _Projector)
from fairmultimodal_torch.utils.rng import dropout

__all__ = ["BEHRTFull", "StructTextModel", "TextOnlyClassifier", "SigmoidFusionFull",
           "EDDIFusionFull", "BEHRTLabOnlyModel"]

_EXTRA_TABLES = (("age_ids", "age_embedding"), ("segment_ids", "segment_embedding"),
                 ("adm_loc_ids", "admission_loc_embedding"),
                 ("disch_loc_ids", "discharge_loc_embedding"),
                 ("gender_ids", "gender_embedding"), ("ethnicity_ids", "ethnicity_embedding"),
                 ("insurance_ids", "insurance_embedding"))


class BEHRTFull(nn.Module):
    """BERT CLS over ``demo_dummy_ids`` plus the mean of the age, segment,
    admission / discharge location, gender, ethnicity and insurance
    embeddings, each id clipped into its table.  The BERT runs on every row
    with its own dropout in train mode."""

    def __init__(self, num_ages: int, num_segments: int = 2, num_admission_locs: int = 10,
                 num_discharge_locs: int = 10, num_genders: int = 2, num_ethnicities: int = 5,
                 num_insurances: int = 6, hidden_size: int = 768, num_hidden_layers: int = 12,
                 num_attention_heads: int = 12, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        vocab = num_ages + num_segments + num_admission_locs + num_discharge_locs + 2
        self.bert = BertEncoderModel(BertConfig(
            vocab_size=max(vocab, 4), hidden_size=hidden_size,
            num_hidden_layers=num_hidden_layers, num_attention_heads=num_attention_heads),
            dtype)
        sizes = (num_ages, num_segments, num_admission_locs, num_discharge_locs, num_genders,
                 num_ethnicities, num_insurances)
        for (_, name), n in zip(_EXTRA_TABLES, sizes):
            self.add_module(name, nn.Embedding(n, hidden_size))

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cls = self.bert(batch["demo_dummy_ids"], batch["demo_attn_mask"], pool="cls",
                        generator=generator)
        extra = 0.0
        for key, name in _EXTRA_TABLES:
            table = getattr(self, name)
            extra = extra + embed(batch[key].clamp(0, table.num_embeddings - 1), table,
                                  self.dtype)
        return cls + extra / 7.0


class StructTextModel(nn.Module):
    """07's two branches: :class:`BEHRTFull` and the precomputed text
    embedding through :class:`AverageFusionModel`; returns ``logits`` and
    the pre-ReLU ``fused_embedding``."""

    def __init__(self, num_ages: int, num_ethnicities: int = 5, num_insurances: int = 6,
                 hidden_size: int = 768, num_hidden_layers: int = 12,
                 num_attention_heads: int = 12, fusion_hidden: int = 512, num_tasks: int = 3,
                 text_embed_size: int = 768, dtype=torch.float32):
        super().__init__()
        self.behrt = BEHRTFull(num_ages, num_ethnicities=num_ethnicities,
                               num_insurances=num_insurances, hidden_size=hidden_size,
                               num_hidden_layers=num_hidden_layers,
                               num_attention_heads=num_attention_heads, dtype=dtype)
        self.fusion = AverageFusionModel(hidden_size, text_embed_size,
                                         fusion_hidden=fusion_hidden, num_tasks=num_tasks,
                                         dtype=dtype)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        return self.fusion(self.behrt(batch, generator), batch["text_embedding"], generator)


class TextOnlyClassifier(nn.Module):
    """``fc1`` 768 -> 256, ReLU, dropout 0.1, ``fc2`` 256 -> T; fp32 logits."""

    def __init__(self, text_embed_size: int = 768, hidden: int = 256, num_tasks: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(text_embed_size, hidden)
        self.fc2 = nn.Linear(hidden, num_tasks)
        self.dropout_rate = 0.1

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        dt, rate = self.dtype, self.dropout_rate
        x = torch.relu(linear(batch["text_embedding"], self.fc1, dt))
        x = dropout(x, rate, dropout_seed(self, rate, generator))
        return {"logits": linear(x, self.fc2, dt).to(torch.float32)}


def _demo_and_lab(module, batch, generator):
    demo = module.behrt_demo(batch["demo_dummy_ids"], batch["demo_attn_mask"],
                             batch["age_ids"], batch["gender_ids"], batch["ethnicity_ids"],
                             batch["insurance_ids"], generator)
    return demo, module.behrt_lab(batch["lab_features"], generator)


class SigmoidFusionFull(nn.Module):
    """09: :class:`BEHRTDemo` (12L/12H) + :class:`BEHRTLab` (2L/8H) + the
    text embedding through :class:`SigmoidFusionModel`."""

    def __init__(self, num_ages: int, num_genders: int, num_ethnicities: int,
                 num_insurances: int, lab_token_count: int, hidden_size: int = 768,
                 demo_layers: int = 12, demo_heads: int = 12, lab_layers: int = 2,
                 lab_heads: int = 8, fusion_hidden: int = 512, num_tasks: int = 3,
                 text_embed_size: int = 768, dtype=torch.float32):
        super().__init__()
        self.behrt_demo = BEHRTDemo(num_ages, num_genders, num_ethnicities, num_insurances,
                                    hidden_size=hidden_size, num_hidden_layers=demo_layers,
                                    num_attention_heads=demo_heads, dtype=dtype)
        self.behrt_lab = BEHRTLab(lab_token_count, hidden_size, num_heads=lab_heads,
                                  num_layers=lab_layers, dtype=dtype)
        self.fusion = SigmoidFusionModel(hidden_size, hidden_size, text_embed_size,
                                         fusion_hidden=fusion_hidden, num_tasks=num_tasks,
                                         dtype=dtype)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, object]:
        demo, lab = _demo_and_lab(self, batch, generator)
        return self.fusion(demo, lab, batch["text_embedding"], generator)


class EDDIFusionFull(nn.Module):
    """08: :class:`BEHRTDemo` (6L/6H) + :class:`BEHRTLab` + text, three
    256-d projectors and one ``head_<task>_<modality>`` Linear(256, 1) per
    pair.  Returns ``task_modality_logits`` [B, T, 3] (fp32) and their mean
    over the modalities as ``logits``; the EDDI fusion weights are loop
    state (``pipelines/eddi_fusion.py``).  The default task names are the
    JAX module's (``mortality``, ``los``, ``mech``)."""

    def __init__(self, num_ages: int, num_genders: int, num_ethnicities: int,
                 num_insurances: int, lab_token_count: int, hidden_size: int = 768,
                 demo_layers: int = 6, demo_heads: int = 6, lab_layers: int = 2,
                 lab_heads: int = 8, proj_dim: int = 256,
                 tasks: Tuple[str, ...] = ("mortality", "los", "mech"),
                 text_embed_size: int = 768, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.tasks = tuple(tasks)
        self.behrt_demo = BEHRTDemo(num_ages, num_genders, num_ethnicities, num_insurances,
                                    hidden_size=hidden_size, num_hidden_layers=demo_layers,
                                    num_attention_heads=demo_heads, dtype=dtype)
        self.behrt_lab = BEHRTLab(lab_token_count, hidden_size, num_heads=lab_heads,
                                  num_layers=lab_layers, dtype=dtype)
        self.demo_projector = _Projector(hidden_size, proj_dim, dtype)
        self.lab_projector = _Projector(hidden_size, proj_dim, dtype)
        self.text_projector = _Projector(text_embed_size, proj_dim, dtype)
        for task in self.tasks:
            for m in ("demo", "lab", "text"):
                self.add_module(f"head_{task}_{m}", nn.Linear(proj_dim, 1))

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        demo, lab = _demo_and_lab(self, batch, generator)
        projs = (self.demo_projector(demo), self.lab_projector(lab),
                 self.text_projector(batch["text_embedding"]))
        rows = [torch.cat([linear(x, getattr(self, f"head_{task}_{m}"), self.dtype)
                           for m, x in zip(("demo", "lab", "text"), projs)], dim=-1)
                for task in self.tasks]
        tm = torch.stack(rows, dim=1).to(torch.float32)
        return {"task_modality_logits": tm, "logits": tm.mean(dim=2)}


class BEHRTLabOnlyModel(nn.Module):
    """01: :class:`BEHRTCombined` over ``lab_features``."""

    def __init__(self, lab_token_count: int, hidden_size: int = 768, dtype=torch.float32,
                 tasks: Tuple[str, ...] = ("mort", "los", "mech")):
        super().__init__()
        self.combined = BEHRTCombined(lab_token_count, hidden_size, dtype=dtype, tasks=tasks)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        return {"logits": self.combined(batch["lab_features"], generator)}
