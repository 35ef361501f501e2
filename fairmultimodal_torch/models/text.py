"""Text modality: frozen BERT note encoding (port of ``fairmultimodal_tpu/models/text.py``).

All (patient, chunk) pairs are flattened, tokenized once, routed to the
smallest sequence bucket that holds them ({64, 128, 256, 512} clipped to
``max_length``), encoded in fixed-shape zero-padded batches, and reduced
back to patients (mean or max); patients without notes get the zero vector.
On the card the 256 and 512 buckets run the CUDA half-layer kernels.

Weights: :meth:`TextEncoder.from_params` takes a JAX parameter tree;
:meth:`TextEncoder.from_pretrained` falls back to a seeded random init with
:class:`HashingTokenizer`.  Loading Hugging Face weights and the
content-addressed embedding cache are not ported yet.
"""

from __future__ import annotations

import hashlib
import os
import warnings
from typing import List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fairmultimodal_torch.interop import load_flax_params
from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.bert import BertConfig, BertEncoderModel, bio_clinical_bert_config
from fairmultimodal_torch.ops.gates import resolve_device

__all__ = ["TextEncoder", "encode_note_chunks", "HashingTokenizer"]


class HashingTokenizer:
    """Deterministic offline stand-in for a WordPiece tokenizer.

    Whitespace tokens map to stable ids through a 4-byte little-endian
    blake2s digest; CLS=101 / SEP=102 / PAD=0 for real-sized vocabularies,
    compact ids (1 / 2, words from 3) for tiny test vocabularies.
    """

    pad_token_id = 0

    def __init__(self, vocab_size: int = 28996):
        self.vocab_size = vocab_size
        self.cls_token_id = 101 if vocab_size > 1000 else 1
        self.sep_token_id = 102 if vocab_size > 1000 else 2
        self._base = 1000 if vocab_size > 1000 else 3
        self._memo: dict = {}   # cohorts repeat a bounded vocabulary

    def _tok(self, word: str) -> int:
        t = self._memo.get(word)
        if t is None:
            h = int.from_bytes(hashlib.blake2s(word.encode(), digest_size=4).digest(),
                               "little")
            t = self._base + (h % (self.vocab_size - self._base))
            self._memo[word] = t
        return t

    def encode_batch(self, texts: Sequence[str], max_length: int = 512
                     ) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.zeros((len(texts), max_length), np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, text in enumerate(texts):
            row = [self._tok(w) for w in text.split()][: max_length - 2]
            k = len(row) + 2
            ids[i, 0] = self.cls_token_id
            ids[i, 1:k - 1] = row
            ids[i, k - 1] = self.sep_token_id
            mask[i, :k] = 1
        return ids, mask


class TextEncoder:
    """Frozen BERT text encoder producing CLS embeddings on ``device``."""

    #: True when :meth:`from_pretrained` fell back to random init.
    is_fallback: bool = False

    def __init__(self, config: BertConfig, model: BertEncoderModel, tokenizer,
                 dtype=torch.float32, device: Optional[Union[str, torch.device]] = None):
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        # Frozen everywhere in the reference: eval mode, no gradients.
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.tokenizer = tokenizer

    @classmethod
    def from_params(cls, params: Mapping, config: BertConfig, tokenizer=None,
                    dtype=torch.float32, device=None) -> "TextEncoder":
        """Encoder from a JAX ``BertEncoderModel`` parameter tree."""
        model = load_flax_params(BertEncoderModel(config, dtype=dtype), params)
        return cls(config, model, tokenizer or HashingTokenizer(config.vocab_size),
                   dtype=dtype, device=device)

    @classmethod
    def from_pretrained(cls, model_name: str = "emilyalsentzer/Bio_ClinicalBERT",
                        dtype=torch.float32, fallback_config: Optional[BertConfig] = None,
                        seed: int = 0, device=None) -> "TextEncoder":
        """Seeded random init + :class:`HashingTokenizer` (loading
        ``model_name``'s Hugging Face weights is not ported yet).  Without an
        explicit ``fallback_config`` it warns: the embeddings carry no
        meaning on real data.
        """
        if fallback_config is None:
            warnings.warn(
                f"weights for {model_name!r} are not loaded (not ported yet); using a "
                "seeded RANDOM INIT + HashingTokenizer. Text embeddings will be "
                "meaningless on real data.", stacklevel=2)
        config = fallback_config or bio_clinical_bert_config()
        model = init_params(BertEncoderModel(config, dtype=dtype), seed)
        enc = cls(config, model, HashingTokenizer(config.vocab_size), dtype=dtype,
                  device=device)
        enc.is_fallback = True
        return enc

    @torch.inference_mode()
    def encode_ids(self, input_ids, attention_mask) -> torch.Tensor:
        """[N, S] ids and mask -> [N, H] CLS embeddings (on ``self.device``)."""
        ids = torch.as_tensor(input_ids, dtype=torch.int64).to(self.device, non_blocking=True)
        mask = torch.as_tensor(attention_mask, dtype=torch.int32).to(self.device,
                                                                   non_blocking=True)
        return self.model(ids, mask, pool="cls")


def encode_note_chunks(
    encoder: TextEncoder,
    note_chunks: Sequence[List[str]],
    max_length: int = 512,
    batch_size: int = 32,
    aggregation: str = "mean",
    buckets: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Per-patient aggregated CLS embeddings [n_patients, H] float32.

    ``buckets`` defaults to {64, 128, 256} below ``max_length`` plus
    ``max_length``; ``FMTPU_TEXT_BUCKETS`` overrides, as in the JAX package
    (``0``/``off`` = one ``max_length`` shape, or a comma list such as
    ``128,512``).  Each
    bucket's batches hold ``batch_size * min(8, max(1, max_bucket // len))``
    rows (a constant token budget), zero-padded to that fixed shape.
    """
    if buckets is None:
        env = os.environ.get("FMTPU_TEXT_BUCKETS", "").strip()
        if env in ("0", "off"):
            buckets = [max_length]
        elif env:
            buckets = [int(b) for b in env.split(",")]
        else:
            buckets = [b for b in (64, 128, 256) if b < max_length] + [max_length]
    buckets = sorted({min(int(b), max_length) for b in buckets} | {max_length})
    if aggregation not in ("mean", "max"):
        raise ValueError(f"unknown aggregation {aggregation!r}")

    n_patients = len(note_chunks)
    hidden = encoder.config.hidden_size
    flat_texts: List[str] = []
    owners: List[int] = []
    for pid, chunks in enumerate(note_chunks):
        for c in chunks:
            if isinstance(c, str) and c.strip():
                flat_texts.append(c)
                owners.append(pid)
    out = np.zeros((n_patients, hidden), np.float32)
    if not flat_texts:
        return out

    ids, mask = encoder.tokenizer.encode_batch(flat_texts, max_length=max_length)

    # Every batch is dispatched before any result is copied back, so the
    # device queue stays full; results are pulled in dispatch order.
    pending: List[Tuple[np.ndarray, torch.Tensor]] = []
    bucket_of = np.searchsorted(np.asarray(buckets), mask.sum(axis=1))
    for b_i, b_len in enumerate(buckets):
        idxs = np.nonzero(bucket_of == b_i)[0]
        rows_b = batch_size * min(8, max(1, buckets[-1] // b_len))
        for start in range(0, len(idxs), rows_b):
            sel = idxs[start:start + rows_b]
            bi, bm = ids[sel, :b_len], mask[sel, :b_len]
            if len(sel) < rows_b:   # one fixed shape per bucket
                pad = rows_b - len(sel)
                bi = np.pad(bi, ((0, pad), (0, 0)))
                bm = np.pad(bm, ((0, pad), (0, 0)))
            pending.append((sel, encoder.encode_ids(bi, bm)))

    embs = np.zeros((len(flat_texts), hidden), np.float32)
    for sel, cls in pending:
        embs[sel] = cls[: len(sel)].float().cpu().numpy()

    owners_arr = np.asarray(owners)
    if aggregation == "mean":
        counts = np.zeros(n_patients, np.float32)
        np.add.at(out, owners_arr, embs)
        np.add.at(counts, owners_arr, 1.0)
        nz = counts > 0
        out[nz] /= counts[nz, None]
    else:
        # -inf init so negative components survive; note-less patients keep 0.
        tmp = np.full((n_patients, hidden), -np.inf, np.float32)
        np.maximum.at(tmp, owners_arr, embs)
        has = np.zeros(n_patients, bool)
        has[owners_arr] = True
        out[has] = tmp[has]
    return out
