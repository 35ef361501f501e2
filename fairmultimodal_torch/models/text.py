"""Text modality: frozen BERT note encoding (port of ``fairmultimodal_tpu/models/text.py``).

All (patient, chunk) pairs are flattened, tokenized once, routed to the
smallest sequence bucket that holds them ({64, 128, 256, 512} clipped to
``max_length``), encoded in fixed-shape zero-padded batches, and reduced
back to patients (mean or max); patients without notes get the zero vector.
On the card the 256 and 512 buckets run the CUDA half-layer kernels.

Weights: :meth:`TextEncoder.from_params` takes a JAX parameter tree;
:meth:`TextEncoder.from_pretrained` loads a Hugging Face snapshot (a local
directory, or a model name the hub cache already holds) with
:func:`~fairmultimodal_torch.models.bert.load_hf_bert_params` and its
WordPiece tokenizer (:mod:`fairmultimodal_torch.models.tokenizer`), and
otherwise falls back to a seeded random init with :class:`HashingTokenizer`.

The embeddings are a pure function of (weights, notes, settings), so
:func:`encode_note_chunks` keeps them in a content-addressed cache
(``cache_dir``, else ``FMTPU_TEXT_CACHE``, which ``--text_cache`` sets): a
blake2b key over the encoder's fingerprint, every chunk string, the
truncation length, the aggregation and the buckets, one ``savez_compressed``
file per key written under a temporary name and moved into place.  The
fingerprint names the port, so the port and the JAX package never read each
other's entries.

Under a ``mesh`` (the JAX encoder's ``shard_map`` over the chunk rows) each
fixed-shape batch is split over the data axis, each rank encodes its data
index's contiguous rows and the embeddings are all-gathered over the data
group, so every rank returns the whole array; the batch size is rounded up
to a multiple of the data axis with pad rows, which change nothing.  The
encoder is frozen and never sharded over a model axis: the ranks of a model
group encode the same rows.  Rank 0 alone writes the cache, whose key does
not depend on the mesh.
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
from fairmultimodal_torch.models.bert import (BertConfig, BertEncoderModel,
                                              bio_clinical_bert_config, load_hf_bert_params,
                                              resolve_hf_snapshot)
from fairmultimodal_torch.models.tokenizer import WordPieceTokenizer
from fairmultimodal_torch.ops.gates import resolve_device
from fairmultimodal_torch.parallel.sharding import all_agree, gather_rows

__all__ = ["TextEncoder", "encode_note_chunks", "HashingTokenizer"]


def _text_cache_key(encoder: "TextEncoder", note_chunks, max_length: int, aggregation: str,
                    buckets: Sequence[int]) -> str:
    """Encoder identity x cohort notes x settings (``text.py:36-53`` of the
    JAX package, over the port's fingerprint)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(encoder.cache_fingerprint().encode())
    h.update(f"|L{max_length}|{aggregation}|n{len(note_chunks)}"
             f"|b{','.join(map(str, buckets))}".encode())
    for chunks in note_chunks:
        h.update(b"\x00")                      # patient boundary
        for c in chunks:
            if isinstance(c, str):
                h.update(c.encode("utf-8", "replace"))
                h.update(b"\x01")
    return h.hexdigest()


def _text_cache_store(cache_path: Optional[str], embeddings: np.ndarray) -> None:
    if cache_path is None:
        return
    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
    # A name of this process's own, so concurrent writers never share a
    # temporary file; a failed write leaves nothing behind.
    tmp = f"{cache_path}.tmp.{os.getpid()}.npz"
    try:
        np.savez_compressed(tmp, embeddings=embeddings)
        os.replace(tmp, cache_path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _state_sample_digest(model: torch.nn.Module) -> str:
    """Digest of the first 256 values of the first four entries of the state
    dict, sorted by name: the embedding tables and first-layer weights, where
    any retrained or revised checkpoint differs."""
    h = hashlib.blake2b(digest_size=16)
    for name, t in sorted(model.state_dict().items())[:4]:
        h.update(f"{name}{tuple(t.shape)}".encode())
        h.update(t.detach().reshape(-1)[:256].float().cpu().numpy().tobytes())
    return h.hexdigest()


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
    """Frozen BERT text encoder producing CLS embeddings on ``device`` (on
    ``mesh.device``, its batches split over the ranks, given a
    data-parallel ``mesh``)."""

    #: True when :meth:`from_pretrained` fell back to random init.
    is_fallback: bool = False
    #: Identity for the embedding cache, set by :meth:`from_pretrained`;
    #: other constructions leave it None and the cache digests the weights.
    fingerprint: Optional[str] = None

    def __init__(self, config: BertConfig, model: BertEncoderModel, tokenizer,
                 dtype=torch.float32, device: Optional[Union[str, torch.device]] = None,
                 mesh=None):
        self.config = config
        self.dtype = dtype
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        # Frozen everywhere in the reference: eval mode, no gradients.
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.tokenizer = tokenizer

    def cache_fingerprint(self) -> str:
        """Identity of (weights, dtype, geometry) for keying cached embeddings."""
        if self.fingerprint is not None:
            return self.fingerprint
        return (f"fairmultimodal_torch|params:{_state_sample_digest(self.model)}"
                f"|{str(self.dtype).replace('torch.', '')}|h{self.config.hidden_size}")

    @classmethod
    def from_params(cls, params: Mapping, config: BertConfig, tokenizer=None,
                    dtype=torch.float32, device=None, mesh=None) -> "TextEncoder":
        """Encoder from a JAX ``BertEncoderModel`` parameter tree."""
        model = load_flax_params(BertEncoderModel(config, dtype=dtype), params)
        return cls(config, model, tokenizer or HashingTokenizer(config.vocab_size),
                   dtype=dtype, device=device, mesh=mesh)

    @classmethod
    def from_pretrained(cls, model_name: str = "emilyalsentzer/Bio_ClinicalBERT",
                        dtype=torch.float32, fallback_config: Optional[BertConfig] = None,
                        seed: int = 0, require_weights: bool = False,
                        device=None, mesh=None) -> "TextEncoder":
        """The Hugging Face snapshot of ``model_name`` (a directory, or a name
        the hub cache holds) with its WordPiece tokenizer; the geometry comes
        from the snapshot's ``config.json``.  When it cannot be loaded:
        ``require_weights=True`` raises, as the JAX function does; otherwise a
        seeded random init + :class:`HashingTokenizer`, with a warning unless
        ``fallback_config`` is given (the embeddings carry no meaning on real
        data).
        """
        device = mesh.device if mesh is not None else resolve_device(device)
        try:
            snapshot = resolve_hf_snapshot(model_name)
            params, config = load_hf_bert_params(snapshot, return_config=True)
            tokenizer = WordPieceTokenizer.from_pretrained(snapshot)
            enc = cls.from_params(params, config, tokenizer, dtype=dtype, device=device,
                                  mesh=mesh)
            weight_id = f"hf:{_state_sample_digest(enc.model)}"
        except Exception as e:
            if require_weights:
                raise RuntimeError(
                    f"HF weights for {model_name!r} are required (--require_hf_weights) but "
                    f"could not be loaded: {e}") from e
            if fallback_config is None:
                warnings.warn(
                    f"HF weights for {model_name!r} unavailable ({e}); using a seeded "
                    "RANDOM INIT + HashingTokenizer. Text embeddings will be meaningless "
                    "on real data -- pass require_weights=True (--require_hf_weights) to "
                    "make this fatal.", stacklevel=2)
            config = fallback_config or bio_clinical_bert_config()
            model = init_params(BertEncoderModel(config, dtype=dtype), seed)
            enc = cls(config, model, HashingTokenizer(config.vocab_size), dtype=dtype,
                      device=device, mesh=mesh)
            enc.is_fallback = True
            weight_id = f"fallback:{seed}"
        enc.fingerprint = (f"fairmultimodal_torch|{model_name}|{weight_id}"
                           f"|{str(dtype).replace('torch.', '')}"
                           f"|h{config.hidden_size}L{config.num_hidden_layers}"
                           f"v{config.vocab_size}")
        return enc

    @torch.inference_mode()
    def encode_ids(self, input_ids, attention_mask) -> torch.Tensor:
        """[N, S] ids and mask -> [N, H] CLS embeddings (on ``self.device``).
        Under a mesh every rank passes the same N rows (N a multiple of the
        rank count), encodes its contiguous share and gets all N back."""
        if self.mesh is not None:
            n = len(input_ids) // self.mesh.data
            rows = slice(self.mesh.data_index * n, (self.mesh.data_index + 1) * n)
            input_ids, attention_mask = input_ids[rows], attention_mask[rows]
        ids = torch.as_tensor(input_ids, dtype=torch.int64).to(self.device, non_blocking=True)
        mask = torch.as_tensor(attention_mask, dtype=torch.int32).to(self.device,
                                                                   non_blocking=True)
        cls = self.model(ids, mask, pool="cls")
        return cls if self.mesh is None else gather_rows(cls, self.mesh)


def encode_note_chunks(
    encoder: TextEncoder,
    note_chunks: Sequence[List[str]],
    max_length: int = 512,
    batch_size: int = 32,
    aggregation: str = "mean",
    buckets: Optional[Sequence[int]] = None,
    cache_dir: Optional[str] = None,
) -> np.ndarray:
    """Per-patient aggregated CLS embeddings [n_patients, H] float32.

    ``cache_dir`` (default: ``FMTPU_TEXT_CACHE``) holds the content-addressed
    embedding cache; a hit returns the stored array without encoding.

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

    mesh = encoder.mesh
    cache_dir = cache_dir or os.environ.get("FMTPU_TEXT_CACHE") or None
    cache_path = None
    if cache_dir:
        key = _text_cache_key(encoder, note_chunks, max_length, aggregation, buckets)
        cache_path = os.path.join(cache_dir, f"text_emb_{key}.npz")
        cached = None
        if os.path.exists(cache_path):
            with np.load(cache_path) as z:
                cached = z["embeddings"]
            if cached.shape[0] != len(note_chunks):
                cached = None
        hit = cached is not None
        if mesh is not None:
            # Every rank encodes, or none does: the encode's collectives need all.
            hit = all_agree(hit, mesh)
            cache_path = cache_path if mesh.rank == 0 else None   # rank 0 writes
        if hit:
            return np.asarray(cached, np.float32)
    if mesh is not None and batch_size % mesh.data:
        # Whole rows per rank; the pad rows are encoded and dropped.
        batch_size += mesh.data - batch_size % mesh.data

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
        _text_cache_store(cache_path, out)
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
    _text_cache_store(cache_path, out)
    return out
