"""BEHRT-style structured-data encoders (port of ``fairmultimodal_tpu/models/behrt.py``).

- :class:`TorchEncoderLayer` -- post-LN torch-style encoder layer (ReLU FFN
  2048, LayerNorm eps 1e-5), with the JAX layer's ``fused_qkv``,
  ``fold_ln``, ``attn_kernel`` and ``ffn_kernel`` fields (``behrt.py:63-86``).
  On a CUDA tensor whose shapes pass the gates (or where a field forces it)
  each half-layer is one kernel wrapper call, differentiable through the
  backward kernels: with the LayerNorm folded (the default) the LN-fused
  kernels (``behrt.py:116-122, 155-162``); with ``fold_ln=False``, or
  ``FMTPU_FOLD_LN=0`` read at call time when ``fold_ln`` is None
  (``behrt.py:101-104``), the unfolded kernels followed by dropout +
  residual + LayerNorm (``behrt.py:123-130, 163-176``).  Where the attention
  megakernel is not taken -- ``attn_kernel=False``, or ``fused_qkv=True``
  (one ``qkv`` [H, 3H] projection, the JAX ``qkv`` Dense) with the field
  left to the gate (``behrt.py:107-110``) -- the attention half is the
  flash route (``behrt.py:131-147``): the projections, then
  :func:`multi_head_attention` (the flash kernels #9 / #10 on shapes that
  pass their gate), the output projection and dropout + residual +
  LayerNorm.  In train mode with a generator it draws one dropout seed for
  the attention half-layer and two for the FFN (inner, outer) on every
  route, as the JAX layer does (``behrt.py:121,160``), and every route
  applies the same Philox streams at the same flat indices (the attention
  output on stream 0 of its seed), so all drop the same elements.
- :class:`BEHRTLab` -- every z-scored lab scalar becomes a token (shared
  Linear(1, H) + learned positional embedding).  The [B, L] scalars and the
  positional table are padded to a multiple of 16 BEFORE the embedding
  (549 -> 560), pad keys are masked out of attention, and the output is the
  mean over the first L tokens only.
- :class:`BEHRTDemo` -- BERT over one dummy token plus the mean of four
  demographic embeddings.  With ``broadcast_dummy`` the BERT runs on one row
  and is broadcast, with the NaN guard for per-row token inputs.
- :class:`BEHRTCombined` -- 01's structured-only baseline: the lab encoder,
  ``fusion_fc``, dropout and one single-logit head per task
  (01_BEHRT.py:132-149), returned in fp32 whatever the compute dtype.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fairmultimodal_torch.models._layers import (column_input, dropout_seed, embed, layer_norm,
                                                 linear, row_linear)
from fairmultimodal_torch.models.bert import BertConfig, BertEncoderModel
from fairmultimodal_torch.ops.attention import multi_head_attention
from fairmultimodal_torch.ops.dropout_add_layernorm import dropout_add_layernorm
from fairmultimodal_torch.ops.fused_attention_block import (
    fused_attention_block, fused_attention_block_ln)
from fairmultimodal_torch.ops.fused_ffn import fused_ffn, fused_ffn_ln
from fairmultimodal_torch.ops.gates import can_use_fused_attention_block, can_use_fused_ffn
from fairmultimodal_torch.parallel.sharding import reduce_from_model
from fairmultimodal_torch.utils.rng import Dropout, dropout

__all__ = ["TorchEncoderLayer", "BEHRTLab", "BEHRTDemo", "BEHRTCombined"]


class TorchEncoderLayer(nn.Module):
    """torch ``nn.TransformerEncoderLayer(d_model, nhead)`` semantics: post-LN,
    ReLU, dim_feedforward 2048, dropout 0.1, layer_norm_eps 1e-5.

    ``fused_qkv``: one ``qkv`` Linear(H, 3H) in place of query / key /
    value (fixed at construction: it decides the parameters).
    ``attn_kernel`` / ``ffn_kernel``: None applies the kernel gates (the
    attention megakernel only without ``fused_qkv``), True forces the
    wrapper (its plain version on a CPU tensor), False the flash route /
    plain FFN.  ``fold_ln``: None reads ``FMTPU_FOLD_LN`` at call time ("0"
    = unfolded), True / False choose the LN-fused or the unfolded kernels.
    These three may be set on a built layer.

    Tensor parallelism (:func:`~fairmultimodal_torch.parallel.shard_params_tp`):
    ``attn_tp`` / ``ffn_tp`` hold the mesh of a sharded half (None: whole).
    A sharded attention half runs the flash route on this rank's heads and
    a sharded FFN half its ``F / model`` columns (``fused_ffn``, #7 / #8,
    with a zero ``b2``, on shapes that pass the gate); each row-parallel
    partial sum is reduced over the model group before its bias, the
    dropout, the residual and the LayerNorm (the replicated glue).  The
    LayerNorm-fused kernels (#1-#4) fold the LayerNorm into the product the
    reduction splits, so a sharded layer never runs them: ``shard_params_tp``
    sets ``attn_kernel=False`` and ``fold_ln=False`` on it, and forcing either
    back raises."""

    def __init__(self, hidden_size: int, num_heads: int, ffn_size: int = 2048,
                 dropout: float = 0.1, dtype=torch.float32, layer_norm_eps: float = 1e-5,
                 fold_ln: Optional[bool] = None, attn_kernel: Optional[bool] = None,
                 ffn_kernel: Optional[bool] = None, fused_qkv: bool = False):
        super().__init__()
        h = hidden_size
        self.num_heads = num_heads
        self.ffn_size = ffn_size
        self.dropout_rate = dropout
        self.dtype = dtype
        self.layer_norm_eps = layer_norm_eps
        self.fold_ln = fold_ln
        self.attn_kernel = attn_kernel
        self.ffn_kernel = ffn_kernel
        self.fused_qkv = fused_qkv
        if fused_qkv:
            self.qkv = nn.Linear(h, 3 * h)
        else:
            self.query = nn.Linear(h, h)
            self.key = nn.Linear(h, h)
            self.value = nn.Linear(h, h)
        self.attn_out = nn.Linear(h, h)
        self.norm1 = nn.LayerNorm(h, eps=layer_norm_eps)
        self.ffn_in = nn.Linear(h, ffn_size)
        self.ffn_out = nn.Linear(ffn_size, h)
        self.norm2 = nn.LayerNorm(h, eps=layer_norm_eps)
        self.attn_tp = None
        self.ffn_tp = None

    def tp_halves(self):
        """The Megatron pairs ``shard_params_tp`` may split: (field, column
        products, row product, heads, fields set on a sharded half)."""
        cols = ("qkv",) if self.fused_qkv else ("query", "key", "value")
        return (("attn_tp", cols, "attn_out", self.num_heads,
                 {"attn_kernel": False, "fold_ln": False}),
                ("ffn_tp", ("ffn_in",), "ffn_out", None, {"fold_ln": False}))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt, nh, eps, rate = self.dtype, self.num_heads, self.layer_norm_eps, self.dropout_rate
        b, s, h = x.shape

        def params(*lins):
            return [t for lin in lins for t in (lin.weight.to(dt), lin.bias.to(dt))]

        a_tp, f_tp = self.attn_tp, self.ffn_tp
        if (a_tp is not None and self.attn_kernel is not False) or (
                (a_tp or f_tp) is not None and self.fold_ln is not False):
            raise ValueError("a tensor-parallel layer runs attn_kernel=False and "
                             "fold_ln=False: the LayerNorm-fused and megakernel paths cannot "
                             "span the row-parallel reduction")
        seed = lambda sharded=False: dropout_seed(self, rate, generator, sharded)  # noqa: E731
        attn_seed = seed()
        ffn_seeds = (seed(f_tp is not None), seed()) if attn_seed is not None else None
        fold = (self.fold_ln if self.fold_ln is not None
                else os.environ.get("FMTPU_FOLD_LN", "1") != "0")
        use_attn = self.attn_kernel
        if use_attn is None:
            use_attn = not self.fused_qkv and can_use_fused_attention_block(x, nh)
        if use_attn and self.fused_qkv:
            raise ValueError("the attention megakernel takes separate query / key / value "
                             "projections; a fused_qkv layer runs the flash route")
        if use_attn and fold:
            x = fused_attention_block_ln(
                x.to(dt), *params(self.query, self.key, self.value, self.attn_out),
                self.norm1.weight, self.norm1.bias, mask, num_heads=nh, ln_eps=eps, rate=rate,
                deterministic=attn_seed is None, seed=attn_seed)
        elif use_attn:
            x = x.to(dt)
            attn = fused_attention_block(
                x, *params(self.query, self.key, self.value, self.attn_out), mask, num_heads=nh)
            x = dropout_add_layernorm(x, attn, self.norm1.weight, self.norm1.bias, eps=eps,
                                      dropout=Dropout.make(attn_seed, 0, rate))
        else:
            # The flash route: head views of the projections (no copies), the
            # flash kernels on shapes that pass their gate, a view back; on a
            # sharded half this rank's heads and a reduced output projection.
            d = h // nh
            nh_l = nh // (a_tp.model if a_tp is not None else 1)
            xin = column_input(x, a_tp)
            if self.fused_qkv:
                qkv = linear(xin, self.qkv, dt).view(b, s, 3, nh_l, d)
                q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
            else:
                q, k, v = (linear(xin, lin, dt).view(b, s, nh_l, d).transpose(1, 2)
                           for lin in (self.query, self.key, self.value))
            attn = multi_head_attention(q, k, v, mask)
            attn = row_linear(attn.transpose(1, 2).reshape(b, s, nh_l * d), self.attn_out, dt,
                              a_tp)
            x = dropout_add_layernorm(x.to(dt), attn, self.norm1.weight, self.norm1.bias,
                                      eps=eps, dropout=Dropout.make(attn_seed, 0, rate))

        use_ffn = self.ffn_kernel
        if use_ffn is None:
            use_ffn = can_use_fused_ffn(x, h, self.ffn_in.out_features)
        inner, outer = ffn_seeds or (None, None)
        if use_ffn and fold:
            return fused_ffn_ln(
                x.reshape(b * s, h).to(dt), *params(self.ffn_in, self.ffn_out),
                self.norm2.weight, self.norm2.bias, activation="relu", ln_eps=eps, rate=rate,
                deterministic=ffn_seeds is None, seeds=ffn_seeds).view(b, s, h)
        if use_ffn:
            x2 = x.reshape(b * s, h).to(dt)
            w1, b1, w2, b2 = params(self.ffn_in, self.ffn_out)
            if f_tp is not None:
                # This rank's F / model columns with a zero b2 (its gradient
                # goes nowhere); the bias is added once after the reduction.
                y = fused_ffn(column_input(x2, f_tp), w1, b1, w2, torch.zeros_like(b2),
                              activation="relu", rate=rate, deterministic=inner is None,
                              seed=inner)
                y = reduce_from_model(y, f_tp) + b2
            else:
                y = fused_ffn(x2, w1, b1, w2, b2, activation="relu", rate=rate,
                              deterministic=inner is None, seed=inner)
            return dropout_add_layernorm(x2, y, self.norm2.weight, self.norm2.bias, eps=eps,
                                         dropout=Dropout.make(outer, 1, rate)).view(b, s, h)
        y = dropout(torch.relu(linear(column_input(x, f_tp), self.ffn_in, dt)), rate, inner,
                    stream=0)
        y = dropout(row_linear(y, self.ffn_out, dt, f_tp), rate, outer, stream=1)
        return layer_norm(x + y, self.norm2, dt)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class BEHRTLab(nn.Module):
    """Scalar-token lab encoder: [B, L] z-scored labs -> [B, H]."""

    def __init__(self, lab_token_count: int, hidden_size: int = 768, num_heads: int = 8,
                 num_layers: int = 2, dropout: float = 0.1, dtype=torch.float32,
                 pad_to: int = 16):
        super().__init__()
        self.num_layers = num_layers
        self.pad_to = pad_to
        self.dtype = dtype
        self.pos_embedding = nn.Parameter(torch.empty(lab_token_count, hidden_size))
        nn.init.normal_(self.pos_embedding)
        self.token_embedding = nn.Linear(1, hidden_size)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TorchEncoderLayer(
                hidden_size, num_heads, dropout=dropout, dtype=dtype))

    def forward(self, lab_features: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        b, L = lab_features.shape
        S = _round_up(L, self.pad_to)
        pos = self.pos_embedding
        if S != L:
            # Pad the scalars and the positional table, not the [B, S, H]
            # activation: pad lanes carry the embedding bias and are masked.
            lab_features = F.pad(lab_features, (0, S - L))
            pos = F.pad(pos, (0, 0, 0, S - L))
        x = linear(lab_features[..., None], self.token_embedding, dt)
        x = x + pos[None].to(dt)
        mask = (torch.arange(S, device=x.device) < L).to(torch.int32)[None, :].expand(b, S)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask, generator)
        acc = torch.promote_types(dt, torch.float32)
        return x[:, :L, :].to(acc).mean(dim=1).to(dt)


class BEHRTDemo(nn.Module):
    """Demographic encoder: BERT CLS over a [B, 1] dummy token plus the mean
    of four demographic embeddings (ids clipped into each table)."""

    def __init__(self, num_ages: int, num_genders: int, num_ethnicities: int,
                 num_insurances: int, hidden_size: int = 768, num_hidden_layers: int = 12,
                 num_attention_heads: int = 12, intermediate_size: int = 3072,
                 dtype=torch.float32, broadcast_dummy: bool = True):
        super().__init__()
        self.sizes = (num_ages, num_genders, num_ethnicities, num_insurances)
        self.dtype = dtype
        self.broadcast_dummy = broadcast_dummy
        cfg = BertConfig(
            vocab_size=sum(self.sizes) + 2, hidden_size=hidden_size,
            num_hidden_layers=num_hidden_layers, num_attention_heads=num_attention_heads,
            intermediate_size=intermediate_size,
            # The broadcast branch runs its BERT without dropout in every mode
            # (the JAX module calls it with deterministic=True).
            hidden_dropout_prob=0.0 if broadcast_dummy else 0.1)
        self.bert = BertEncoderModel(cfg, dtype=dtype)
        self.age_embedding = nn.Embedding(num_ages, hidden_size)
        self.gender_embedding = nn.Embedding(num_genders, hidden_size)
        self.ethnicity_embedding = nn.Embedding(num_ethnicities, hidden_size)
        self.insurance_embedding = nn.Embedding(num_insurances, hidden_size)

    def forward(self, dummy_ids, attn_mask, age_ids, gender_ids, ethnicity_ids,
                insurance_ids, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        if self.broadcast_dummy:
            one = self.bert(dummy_ids[:1], attn_mask[:1], pool="cls")
            cls = one.expand(dummy_ids.shape[0], one.shape[-1])
            # Broadcasting is exact only for row-constant inputs: poison the
            # output with NaN otherwise.  All-zero rows (padded batch tails)
            # are admitted.
            row_eq = ((dummy_ids == dummy_ids[:1]) & (attn_mask == attn_mask[:1])).all(dim=1)
            row_pad = ((dummy_ids == 0) & (attn_mask == 0)).all(dim=1)
            cls = torch.where((row_eq | row_pad).all(), cls, torch.full_like(cls, float("nan")))
        else:
            cls = self.bert(dummy_ids, attn_mask, pool="cls", generator=generator)

        def emb(ids, n, table):
            return embed(ids.clamp(0, n - 1), table, dt)

        na, ng, ne, ni = self.sizes
        extra = (emb(age_ids, na, self.age_embedding)
                 + emb(gender_ids, ng, self.gender_embedding)
                 + emb(ethnicity_ids, ne, self.ethnicity_embedding)
                 + emb(insurance_ids, ni, self.insurance_embedding)) / 4.0
        return cls + extra


class BEHRTCombined(nn.Module):
    """Lab encoder (2L/8H) -> ``fusion_fc`` -> dropout -> ``classifier_<task>``
    per task, concatenated to [B, len(tasks)] fp32 logits (the JAX module
    casts to float32 even in a float64 model).  A one-task tuple is the
    Mechanical_Ventilation generation's single-task regime."""

    def __init__(self, lab_token_count: int, hidden_size: int = 768, dtype=torch.float32,
                 tasks=("mort", "los", "mech")):
        super().__init__()
        self.dtype = dtype
        self.tasks = tuple(tasks)
        self.lab_model = BEHRTLab(lab_token_count, hidden_size, dtype=dtype)
        self.fusion_fc = nn.Linear(hidden_size, hidden_size)
        for t in self.tasks:
            self.add_module(f"classifier_{t}", nn.Linear(hidden_size, 1))
        self.dropout_rate = 0.1

    def forward(self, lab_features: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt, rate = self.dtype, self.dropout_rate
        x = self.lab_model(lab_features, generator)
        x = dropout(linear(x, self.fusion_fc, dt), rate, dropout_seed(self, rate, generator))
        return torch.cat([linear(x, getattr(self, f"classifier_{t}"), dt) for t in self.tasks],
                         dim=-1).to(torch.float32)
