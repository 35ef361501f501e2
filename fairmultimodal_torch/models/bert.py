"""Config-parametric BERT encoder (port of ``fairmultimodal_tpu/models/bert.py``).

One implementation serves the BEHRT-Demo BERT (12L/12H over a 1-token dummy
input) and the frozen Bio_ClinicalBERT note encoder.  Post-LN BERT with
exact gelu and LayerNorm eps 1e-12.  Module and parameter names mirror the
flax tree (``embeddings.word_embeddings``, ``layer_0.attention.query``, ...)
so JAX weights convert mechanically (:mod:`fairmultimodal_torch.interop`).

Dropout (``hidden_dropout_prob``; the JAX BERT has no attention-probability
dropout) is Philox dropout seeded from the caller's generator in train mode
(``models/_layers.py::dropout_seed``).

Per-half-layer kernel dispatch, as ``bert.py:151-230``: in eval mode, on a
CUDA tensor whose shapes pass :func:`can_use_fused_attention_block`
(256 <= S <= 1024, i.e. the 256 / 512 note buckets), the attention
half-layer is :func:`fused_attention_block_ln_infer` and the FFN half-layer
:func:`fused_ffn_ln_infer` with gelu (eval mode only, so always the
inference entries).  Everywhere else the attention goes through
:func:`multi_head_attention`, which in training mode at those shapes runs
the flash kernels (#9 / #10, ``bert.py:175-186``); in training mode on a
CUDA tensor the attention half's dropout + residual + LayerNorm is then the
row kernel of :func:`dropout_add_layernorm` (Philox stream 0 of the site's
seed), except for the demo BERT's one-token rows, which stay on the plain
path as their attention (v itself) does.  The rest -- the 64 / 128 buckets
in eval mode, the FFN in training mode, the CPU -- runs the plain PyTorch
layer.  A half that :func:`~fairmultimodal_torch.parallel.shard_params_tp`
sharded (``tp``: its mesh) never takes the LayerNorm-fused kernels: it runs
this rank's heads (or intermediate columns) and reduces the row-parallel
partial sum over the model group before the bias, dropout, residual and
LayerNorm.

:func:`load_hf_bert_params` reads a Hugging Face BERT snapshot (a local
directory, or a model name that the hub cache already holds) with torch and
json alone -- ``config.json`` plus ``model.safetensors`` or
``pytorch_model.bin`` -- into the JAX package's parameter tree, which
:func:`fairmultimodal_torch.interop.load_flax_params` loads.  Nothing is
downloaded.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from fairmultimodal_torch.models._layers import (column_input, dropout_seed, embed, layer_norm,
                                                 linear, row_linear)
from fairmultimodal_torch.ops.attention import multi_head_attention
from fairmultimodal_torch.ops.dropout_add_layernorm import dropout_add_layernorm
from fairmultimodal_torch.ops.fused_attention_block import fused_attention_block_ln_infer
from fairmultimodal_torch.ops.fused_ffn import fused_ffn_ln_infer
from fairmultimodal_torch.ops.gates import can_use_fused_attention_block, can_use_fused_ffn
from fairmultimodal_torch.utils.rng import Dropout, dropout

__all__ = ["BertConfig", "bio_clinical_bert_config", "BertEmbeddings",
           "BertSelfAttention", "BertLayer", "BertEncoderModel", "resolve_hf_snapshot",
           "read_safetensors", "load_hf_bert_params"]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12


def bio_clinical_bert_config() -> BertConfig:
    """emilyalsentzer/Bio_ClinicalBERT = bert-base-cased geometry."""
    return BertConfig(vocab_size=28996)


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, dtype=torch.float32):
        super().__init__()
        c = config
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.dropout_rate = c.hidden_dropout_prob

    def forward(self, input_ids: torch.Tensor, token_type_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        seq = input_ids.shape[1]
        pos_ids = torch.arange(seq, device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (embed(input_ids, self.word_embeddings, self.dtype)
             + embed(pos_ids, self.position_embeddings, self.dtype)
             + embed(token_type_ids, self.token_type_embeddings, self.dtype))
        return dropout(layer_norm(x, self.layer_norm, self.dtype), self.dropout_rate,
                       dropout_seed(self, self.dropout_rate, generator))


class BertSelfAttention(nn.Module):
    """Attention half-layer: ``LN(dropout(Wo . mha(q, k, v)) + hidden)``."""

    def __init__(self, config: BertConfig, dtype=torch.float32):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.dtype = dtype
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.output_dense = nn.Linear(h, h)
        self.output_layer_norm = nn.LayerNorm(h, eps=config.layer_norm_eps)
        self.tp = None

    def tp_halves(self):
        """The Megatron pair ``shard_params_tp`` may split (see
        ``TorchEncoderLayer.tp_halves``): q / k / v and ``output_dense``."""
        return (("tp", ("query", "key", "value"), "output_dense",
                 self.config.num_attention_heads, {}),)

    def forward(self, hidden: torch.Tensor, mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c, dt, tp = self.config, self.dtype, self.tp
        nh = c.num_attention_heads
        b, s, h = hidden.shape
        x = hidden.to(dt)
        if tp is None and not self.training and can_use_fused_attention_block(x, nh):
            w = lambda lin: lin.weight.to(dt)
            bb = lambda lin: lin.bias.to(dt)
            return fused_attention_block_ln_infer(
                x, w(self.query), bb(self.query), w(self.key), bb(self.key),
                w(self.value), bb(self.value), w(self.output_dense), bb(self.output_dense),
                self.output_layer_norm.weight, self.output_layer_norm.bias, mask,
                num_heads=nh, ln_eps=c.layer_norm_eps)

        d = h // nh
        nh_l = nh // (tp.model if tp is not None else 1)     # this rank's heads
        xin = column_input(hidden, tp)

        def heads(lin):
            return linear(xin, lin, dt).view(b, s, nh_l, d).transpose(1, 2)

        out = multi_head_attention(heads(self.query), heads(self.key), heads(self.value),
                                   mask)
        out = row_linear(out.transpose(1, 2).reshape(b, s, nh_l * d), self.output_dense, dt,
                         tp)
        rate = c.hidden_dropout_prob
        seed = dropout_seed(self, rate, generator)
        if self.training and x.is_cuda and s > 1:
            ln = self.output_layer_norm
            return dropout_add_layernorm(x, out, ln.weight, ln.bias, eps=c.layer_norm_eps,
                                         dropout=Dropout.make(seed, 0, rate))
        return layer_norm(dropout(out, rate, seed) + hidden, self.output_layer_norm, dt)


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig, dtype=torch.float32):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.dtype = dtype
        self.attention = BertSelfAttention(config, dtype)
        self.intermediate = nn.Linear(h, config.intermediate_size)
        self.output = nn.Linear(config.intermediate_size, h)
        self.output_layer_norm = nn.LayerNorm(h, eps=config.layer_norm_eps)
        self.tp = None

    def tp_halves(self):
        """The FFN's Megatron pair: ``intermediate`` and ``output``."""
        return (("tp", ("intermediate",), "output", None, {}),)

    def forward(self, hidden: torch.Tensor, mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c, dt, tp = self.config, self.dtype, self.tp
        h = c.hidden_size
        x = self.attention(hidden, mask, generator)
        # The attention-geometry gate applies to the FFN too (bert.py:203-213),
        # so the kernels engage only on note-encode shapes.
        if (tp is None and not self.training
                and can_use_fused_ffn(x.to(dt), h, c.intermediate_size)
                and can_use_fused_attention_block(x.to(dt), c.num_attention_heads)):
            b, s, _ = x.shape
            out = fused_ffn_ln_infer(
                x.reshape(b * s, h).to(dt), self.intermediate.weight.to(dt),
                self.intermediate.bias.to(dt), self.output.weight.to(dt),
                self.output.bias.to(dt), self.output_layer_norm.weight,
                self.output_layer_norm.bias, activation="gelu", ln_eps=c.layer_norm_eps)
            return out.view(b, s, h)
        y = F.gelu(linear(column_input(x, tp), self.intermediate, dt))
        rate = c.hidden_dropout_prob
        y = dropout(row_linear(y, self.output, dt, tp), rate,
                    dropout_seed(self, rate, generator))
        return layer_norm(y + x, self.output_layer_norm, dt)


class BertEncoderModel(nn.Module):
    """BERT trunk: (input_ids, attention_mask) -> last hidden state, or the
    [CLS] vector with ``pool="cls"`` (the reference never uses the pooler)."""

    def __init__(self, config: BertConfig, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.embeddings = BertEmbeddings(config, dtype)
        for i in range(config.num_hidden_layers):
            self.add_module(f"layer_{i}", BertLayer(config, dtype))

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                pool: Optional[str] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.embeddings(input_ids, token_type_ids, generator)
        for i in range(self.config.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x, attention_mask, generator)
        if pool == "cls":
            return x[:, 0, :]
        if pool is not None:
            raise ValueError(f"unknown pool {pool!r} (only 'cls' is ported)")
        return x


# -- Hugging Face snapshots, read without transformers ----------------------------------

def resolve_hf_snapshot(model_name_or_path: str) -> str:
    """A directory as it is; a model name ``org/name`` -> the snapshot the hub
    cache holds for it: ``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
    ``~/.cache/huggingface/hub``, then ``models--org--name/snapshots/<the
    revision in refs/main>``.  Raises ``FileNotFoundError`` when it is not
    there; nothing is downloaded."""
    if os.path.isdir(model_name_or_path):
        return model_name_or_path
    cache = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME") or os.path.join(
            os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache"),
            "huggingface"), "hub")
    repo = os.path.join(cache, "models--" + model_name_or_path.replace("/", "--"))
    try:
        with open(os.path.join(repo, "refs", "main")) as f:
            snapshot = os.path.join(repo, "snapshots", f.read().strip())
    except OSError as e:
        raise FileNotFoundError(f"{model_name_or_path!r} is neither a directory nor in the "
                                f"Hugging Face hub cache {cache} ({e})") from e
    if not os.path.isdir(snapshot):
        raise FileNotFoundError(f"{model_name_or_path!r}: refs/main names {snapshot}, "
                                "which is not there")
    return snapshot


_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file: an 8-byte little-endian header length, a JSON
    header {name: {dtype, shape, data_offsets}}, then the raw little-endian
    tensors."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        count = (end - start) // torch.empty((), dtype=dtype).element_size()
        t = torch.frombuffer(data, dtype=dtype, count=count, offset=start) if count else \
            torch.empty(0, dtype=dtype)
        out[name] = t.reshape(info["shape"])
    return out


def _hf_state_dict(snapshot: str) -> Dict[str, torch.Tensor]:
    st, pt = (os.path.join(snapshot, n) for n in ("model.safetensors", "pytorch_model.bin"))
    if os.path.exists(st):
        sd = read_safetensors(st)
    elif os.path.exists(pt):
        sd = torch.load(pt, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"{snapshot}: no model.safetensors or pytorch_model.bin")
    out = {}
    for k, v in sd.items():
        # A BertForPreTraining checkpoint prefixes "bert."; old TF conversions
        # name the LayerNorm parameters gamma / beta.
        k = k[len("bert."):] if k.startswith("bert.") else k
        k = k.replace("LayerNorm.gamma", "LayerNorm.weight").replace("LayerNorm.beta",
                                                                     "LayerNorm.bias")
        out[k] = v
    return out


def load_hf_bert_params(model_name_or_path: str, config: Optional[BertConfig] = None,
                        return_config: bool = False):
    """A Hugging Face BERT snapshot -> the JAX ``BertEncoderModel`` parameter
    tree (numpy float32; without the pooler, which the encoder never runs),
    and with ``return_config=True`` the
    :class:`BertConfig` derived from its ``config.json`` as the JAX function
    derives it from the loaded model (``bert.py:310-321``)."""
    snapshot = resolve_hf_snapshot(model_name_or_path)
    if config is None:
        with open(os.path.join(snapshot, "config.json")) as f:
            hf = json.load(f)
        config = BertConfig(**{f.name: hf.get(f.name, f.default)
                               for f in dataclasses.fields(BertConfig)})
    sd = {k: v.float().numpy() if v.is_floating_point() else v.numpy()
          for k, v in _hf_state_dict(snapshot).items()}

    def dense(prefix):
        return {"kernel": sd[f"{prefix}.weight"].T, "bias": sd[f"{prefix}.bias"]}

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    params: Dict = {"embeddings": {
        "word_embeddings": {"embedding": sd["embeddings.word_embeddings.weight"]},
        "position_embeddings": {"embedding": sd["embeddings.position_embeddings.weight"]},
        "token_type_embeddings": {"embedding": sd["embeddings.token_type_embeddings.weight"]},
        "layer_norm": ln("embeddings.LayerNorm"),
    }}
    for i in range(config.num_hidden_layers):
        p = f"encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "attention": {
                "query": dense(f"{p}.attention.self.query"),
                "key": dense(f"{p}.attention.self.key"),
                "value": dense(f"{p}.attention.self.value"),
                "output_dense": dense(f"{p}.attention.output.dense"),
                "output_layer_norm": ln(f"{p}.attention.output.LayerNorm"),
            },
            "intermediate": dense(f"{p}.intermediate.dense"),
            "output": dense(f"{p}.output.dense"),
            "output_layer_norm": ln(f"{p}.output.LayerNorm"),
        }
    return (params, config) if return_config else params
