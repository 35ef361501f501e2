"""FAME fusion head and full model (port of ``fairmultimodal_tpu/models/fusion.py``).

Dynamic EDDI weights enter as a [3, 3] (task x modality) tensor.  Reference
quirk kept under ``reference_weight_compat`` (default True): the mortality
row of the weights scales every task's fusion (10_FAME.py:283-285); False
fuses each task with its own row through the shared trunk.  Outputs are in
at least fp32 whatever the compute dtype.  The fusion head's dropout (JAX
``fusion.py:108,122,136``) is Philox dropout seeded from the caller's
generator in train mode; ``FAMEModel.forward`` passes the generator to every
dropout site (lab encoder, fusion head; the broadcast demo BERT has none).

Also here: 03's :class:`DfCModel` and 08's bare :class:`EDDIFusionModel`
(the nine single-logit heads over precomputed embeddings, which the JAX
package exports and no pipeline calls).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from fairmultimodal_torch.models._layers import dropout_seed, embed, linear
from fairmultimodal_torch.models.behrt import BEHRTDemo, BEHRTLab
from fairmultimodal_torch.models.bert import BertConfig, BertEncoderModel
from fairmultimodal_torch.utils.rng import dropout

__all__ = ["FAMEFusion", "FAMEModel", "AverageFusionModel", "SigmoidFusionModel",
           "EDDIFusionModel", "DfCModel"]


def _out_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


class _Projector(nn.Module):
    """Linear(., 256) + ReLU modality projector (10_FAME.py:235-246).
    ``return_pre=True`` also returns the pre-ReLU output: 07 saves
    ``cat(ts_pre, text_pre)`` (07_multimodal_average_fusion.py:227-237)."""

    def __init__(self, in_features: int, out: int = 256, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dense = nn.Linear(in_features, out)

    def forward(self, x: torch.Tensor, return_pre: bool = False):
        pre = linear(x, self.dense, self.dtype)
        post = torch.relu(pre)
        return (pre, post) if return_pre else post


class FAMEFusion(nn.Module):
    """Fusion over precomputed modality embeddings [B, H_m].

    Returns ``fused_logits`` [B, 3], ``modality_logits`` (demo/lab/text),
    ``sigmoid_weights`` [3*proj_dim], ``gated_vector`` and
    ``fusion_pre_relu`` (the extraction artifacts of 10_FAME.py:559-604).
    """

    def __init__(self, demo_dim: int, lab_dim: int, text_dim: int,
                 fusion_hidden: int = 512, proj_dim: int = 256, num_tasks: int = 3,
                 reference_weight_compat: bool = True, dtype=torch.float32):
        super().__init__()
        p = proj_dim
        self.num_tasks = num_tasks
        self.reference_weight_compat = reference_weight_compat
        self.dtype = dtype
        self.demo_projector = _Projector(demo_dim, p, dtype)
        self.lab_projector = _Projector(lab_dim, p, dtype)
        self.text_projector = _Projector(text_dim, p, dtype)
        self.sig_weights = nn.Parameter(torch.empty(3 * p))
        nn.init.normal_(self.sig_weights)
        self.fusion_dense1 = nn.Linear(3 * p, fusion_hidden)
        self.fusion_dense2 = nn.Linear(fusion_hidden, num_tasks)
        self.classifier_demo = nn.Linear(p, num_tasks)
        self.classifier_lab = nn.Linear(p, num_tasks)
        self.classifier_text = nn.Linear(p, num_tasks)
        self.dropout_rate = 0.1

    def forward(self, demo_emb, lab_emb, text_emb,
                dynamic_weights: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, object]:
        dt, T, rate = self.dtype, self.num_tasks, self.dropout_rate
        seed = dropout_seed(self, rate, generator)
        demo_proj = self.demo_projector(demo_emb)
        lab_proj = self.lab_projector(lab_emb)
        text_proj = self.text_projector(text_emb)
        if dynamic_weights is None:
            w = torch.full((T, 3), 0.33, dtype=dt, device=demo_proj.device)
        else:
            w = dynamic_weights.to(device=demo_proj.device, dtype=dt)
        sig = torch.sigmoid(self.sig_weights).to(dt)

        if self.reference_weight_compat:
            row = w[0]
            fused = torch.cat([row[0] * demo_proj, row[1] * lab_proj, row[2] * text_proj],
                              dim=-1)
            gated = fused * sig
            pre_relu = linear(gated, self.fusion_dense1, dt)
            h = dropout(torch.relu(pre_relu), rate, seed)
            fused_logits = linear(h, self.fusion_dense2, dt)
        else:
            projs = torch.stack([demo_proj, lab_proj, text_proj], dim=1)   # [B, 3, p]
            scaled = w[None, :, :, None] * projs[:, None]                  # [B, T, 3, p]
            gated_t = scaled.reshape(scaled.shape[0], T, -1) * sig         # [B, T, 3p]
            pre_relu_t = linear(gated_t, self.fusion_dense1, dt)
            out = linear(dropout(torch.relu(pre_relu_t), rate, seed), self.fusion_dense2, dt)
            fused_logits = torch.diagonal(out, dim1=1, dim2=2)             # [B, T]
            gated = gated_t[:, 0]
            pre_relu = pre_relu_t[:, 0]

        od = _out_dtype(dt)
        return {
            "fused_logits": fused_logits.to(od),
            "modality_logits": {
                "demo": linear(demo_proj, self.classifier_demo, dt).to(od),
                "lab": linear(lab_proj, self.classifier_lab, dt).to(od),
                "text": linear(text_proj, self.classifier_text, dt).to(od),
            },
            "sigmoid_weights": torch.sigmoid(self.sig_weights),
            "gated_vector": gated.to(od),
            "fusion_pre_relu": pre_relu.to(od),
        }


class FAMEModel(nn.Module):
    """BEHRT-Demo + BEHRT-Lab + precomputed text embedding + FAMEFusion
    (10_FAME.py:226-313,774-785).  ``batch`` holds ``demo_dummy_ids``,
    ``demo_attn_mask``, ``age_ids``, ``gender_ids``, ``ethnicity_ids``,
    ``insurance_ids``, ``lab_features`` and ``text_embedding``."""

    def __init__(self, num_ages: int, num_genders: int, num_ethnicities: int,
                 num_insurances: int, lab_token_count: int, text_embed_size: int = 768,
                 hidden_size: int = 768, demo_layers: int = 12, demo_heads: int = 12,
                 lab_layers: int = 2, lab_heads: int = 8, fusion_hidden: int = 512,
                 reference_weight_compat: bool = True, dtype=torch.float32):
        super().__init__()
        self.num_ages = num_ages
        self.num_genders = num_genders
        self.num_ethnicities = num_ethnicities
        self.num_insurances = num_insurances
        self.lab_token_count = lab_token_count
        self.text_embed_size = text_embed_size
        self.dtype = dtype
        self.behrt_demo = BEHRTDemo(
            num_ages, num_genders, num_ethnicities, num_insurances,
            hidden_size=hidden_size, num_hidden_layers=demo_layers,
            num_attention_heads=demo_heads, dtype=dtype)
        self.behrt_lab = BEHRTLab(lab_token_count, hidden_size, num_heads=lab_heads,
                                  num_layers=lab_layers, dtype=dtype)
        self.fusion = FAMEFusion(hidden_size, hidden_size, text_embed_size, fusion_hidden,
                                 reference_weight_compat=reference_weight_compat,
                                 dtype=dtype)

    def forward(self, batch: Dict[str, torch.Tensor],
                dynamic_weights: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, object]:
        """Dropout runs in train mode when ``generator`` (the caller's
        seed source, a CPU :class:`torch.Generator`) is given."""
        demo_emb = self.behrt_demo(batch["demo_dummy_ids"], batch["demo_attn_mask"],
                                   batch["age_ids"], batch["gender_ids"],
                                   batch["ethnicity_ids"], batch["insurance_ids"], generator)
        lab_emb = self.behrt_lab(batch["lab_features"], generator)
        return self.fusion(demo_emb, lab_emb, batch["text_embedding"], dynamic_weights,
                           generator)


class AverageFusionModel(nn.Module):
    """07: structured + text -> two 256-d projectors -> concat -> MLP -> T
    logits (07_multimodal_average_fusion.py:205-238).  ``fused_embedding``,
    07's extraction artifact, is the concatenation of the two PRE-ReLU
    projector outputs (07:227-237), not the classifier's pre-activation."""

    def __init__(self, struct_dim: int, text_dim: int, proj_dim: int = 256,
                 fusion_hidden: int = 512, num_tasks: int = 3, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.struct_projector = _Projector(struct_dim, proj_dim, dtype)
        self.text_projector = _Projector(text_dim, proj_dim, dtype)
        self.dense1 = nn.Linear(2 * proj_dim, fusion_hidden)
        self.dense2 = nn.Linear(fusion_hidden, num_tasks)
        self.dropout_rate = 0.1

    def forward(self, struct_emb, text_emb,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        dt, rate = self.dtype, self.dropout_rate
        s_pre, s = self.struct_projector(struct_emb, return_pre=True)
        t_pre, t = self.text_projector(text_emb, return_pre=True)
        h = torch.relu(linear(torch.cat([s, t], dim=-1), self.dense1, dt))
        h = dropout(h, rate, dropout_seed(self, rate, generator))
        od = _out_dtype(dt)
        return {"logits": linear(h, self.dense2, dt).to(od),
                "fused_embedding": torch.cat([s_pre, t_pre], dim=-1).to(od)}


class SigmoidFusionModel(nn.Module):
    """09: per-modality learnable sigmoid gates after the projectors, concat
    -> ``proj`` 768->512 + ReLU -> ``classifier_hidden`` 512->512 + ReLU +
    dropout -> ``classifier`` (09_multimodal_sigmoid_fusion.py:162-222).
    The gates ``sig_weights_*`` start from N(0, 1); their sigmoid is taken in
    the parameters' dtype and cast to the compute dtype."""

    def __init__(self, demo_dim: int, lab_dim: int, text_dim: int, proj_dim: int = 256,
                 fusion_hidden: int = 512, num_tasks: int = 3, dtype=torch.float32):
        super().__init__()
        p = proj_dim
        self.dtype = dtype
        self.demo_projector = _Projector(demo_dim, p, dtype)
        self.lab_projector = _Projector(lab_dim, p, dtype)
        self.text_projector = _Projector(text_dim, p, dtype)
        for m in ("demo", "lab", "text"):
            w = nn.Parameter(torch.empty(p))
            nn.init.normal_(w)
            self.register_parameter(f"sig_weights_{m}", w)
        self.proj = nn.Linear(3 * p, fusion_hidden)
        self.classifier_hidden = nn.Linear(fusion_hidden, fusion_hidden)
        self.classifier = nn.Linear(fusion_hidden, num_tasks)
        self.dropout_rate = 0.1

    def forward(self, demo_emb, lab_emb, text_emb,
                generator: Optional[torch.Generator] = None) -> Dict[str, object]:
        dt, rate = self.dtype, self.dropout_rate
        gates = tuple(torch.sigmoid(getattr(self, f"sig_weights_{m}"))
                      for m in ("demo", "lab", "text"))
        projs = (self.demo_projector(demo_emb), self.lab_projector(lab_emb),
                 self.text_projector(text_emb))
        fused = torch.cat([x * g.to(dt) for x, g in zip(projs, gates)], dim=-1)
        agg = torch.relu(linear(fused, self.proj, dt))
        h = torch.relu(linear(agg, self.classifier_hidden, dt))
        h = dropout(h, rate, dropout_seed(self, rate, generator))
        od = _out_dtype(dt)
        return {"logits": linear(h, self.classifier, dt).to(od), "aggregated": agg.to(od),
                "gates": gates}


class EDDIFusionModel(nn.Module):
    """08's heads alone: three 256-d projectors over precomputed modality
    embeddings and one ``head_<task>_<modality>`` Linear(256, 1) per pair,
    returned as ``{"<task>_<modality>": [B, 1]}`` (08_multimodal_eddi_fusion.py:
    314-402; the EDDI weighting of the nine logits is the training loop's)."""

    TASKS = ("mortality", "los", "mechanical_ventilation")

    def __init__(self, demo_dim: int, lab_dim: int, text_dim: int, proj_dim: int = 256,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.demo_projector = _Projector(demo_dim, proj_dim, dtype)
        self.lab_projector = _Projector(lab_dim, proj_dim, dtype)
        self.text_projector = _Projector(text_dim, proj_dim, dtype)
        for task in self.TASKS:
            for m in ("demo", "lab", "text"):
                self.add_module(f"head_{task}_{m}", nn.Linear(proj_dim, 1))

    def forward(self, demo_emb, lab_emb, text_emb,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        projs = {"demo": self.demo_projector(demo_emb), "lab": self.lab_projector(lab_emb),
                 "text": self.text_projector(text_emb)}
        od = _out_dtype(self.dtype)
        return {f"{task}_{m}": linear(x, getattr(self, f"head_{task}_{m}"), self.dtype).to(od)
                for task in self.TASKS for m, x in projs.items()}


class DfCModel(nn.Module):
    """03, demographics-free: a BERT's [CLS] over the dummy token plus the
    mean (``/ 3``) of the segment, admission and discharge location
    embeddings (ids clipped into each table), a 256-d projector beside the
    text's, concat -> ``dense1`` 512 + ReLU + dropout -> ``dense2``
    (03_DfC.py:156-220).  The BERT's vocabulary is ``max(segments +
    admission + discharge locations + 2, 4)``, its FFN 4 H.  ``batch`` keys:
    ``dummy_ids``, ``attn_mask``, ``segment_ids``, ``admission_loc_ids``,
    ``discharge_loc_ids``, ``text_embedding``."""

    def __init__(self, num_segments: int = 2, num_admission_locs: int = 10,
                 num_discharge_locs: int = 10, hidden_size: int = 768,
                 num_hidden_layers: int = 12, num_attention_heads: int = 12,
                 proj_dim: int = 256, num_tasks: int = 3, text_embed_size: int = 768,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        vocab = num_segments + num_admission_locs + num_discharge_locs + 2
        self.bert = BertEncoderModel(BertConfig(
            vocab_size=max(vocab, 4), hidden_size=hidden_size,
            num_hidden_layers=num_hidden_layers, num_attention_heads=num_attention_heads,
            intermediate_size=hidden_size * 4), dtype)
        self.segment_embedding = nn.Embedding(num_segments, hidden_size)
        self.admission_loc_embedding = nn.Embedding(num_admission_locs, hidden_size)
        self.discharge_loc_embedding = nn.Embedding(num_discharge_locs, hidden_size)
        self.struct_projector = _Projector(hidden_size, proj_dim, dtype)
        self.text_projector = _Projector(text_embed_size, proj_dim, dtype)
        self.dense1 = nn.Linear(2 * proj_dim, 512)
        self.dense2 = nn.Linear(512, num_tasks)
        self.dropout_rate = 0.1

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        dt, rate = self.dtype, self.dropout_rate
        cls = self.bert(batch["dummy_ids"], batch["attn_mask"], pool="cls", generator=generator)

        def emb(key, table):
            return embed(batch[key].clamp(0, table.num_embeddings - 1), table, dt)

        extra = (emb("segment_ids", self.segment_embedding)
                 + emb("admission_loc_ids", self.admission_loc_embedding)
                 + emb("discharge_loc_ids", self.discharge_loc_embedding)) / 3.0
        s = self.struct_projector(cls + extra)
        t = self.text_projector(batch["text_embedding"])
        h = torch.relu(linear(torch.cat([s, t], dim=-1), self.dense1, dt))
        h = dropout(h, rate, dropout_seed(self, rate, generator))
        return {"logits": linear(h, self.dense2, dt).to(_out_dtype(dt))}
