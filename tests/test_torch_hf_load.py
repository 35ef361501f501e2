"""The Hugging Face load without transformers, against transformers (CPU).

A small random ``transformers.BertModel`` and ``BertTokenizerFast`` are saved
with ``save_pretrained`` to a temporary directory, as
``tests/test_text_pretrained.py`` does for the JAX package; nothing is
downloaded.  Held here:

- the port's WordPiece ids and masks equal ``BertTokenizerFast``'s on
  varied text (accents, case, punctuation, CJK, control characters,
  unknown and over-long words, truncation), lower-casing on and off;
- ``TextEncoder.from_pretrained`` reads the snapshot (``model.safetensors``
  or ``pytorch_model.bin``) with its geometry from ``config.json``; its CLS
  embeddings equal the transformers model's and the JAX
  ``TextEncoder.from_pretrained``'s to 1e-5;
- a model name resolves through a temporary ``HF_HUB_CACHE``
  (``models--org--name/snapshots/<refs/main>``), and a name that is not
  there falls back, or raises with ``require_weights=True``;
- a changed checkpoint under the same name misses the embedding cache,
  and the dtype is part of the fingerprint.
"""

import glob
import os

import numpy as np
import pytest
import torch
import transformers

from fairmultimodal_torch.models import bert as t_bert
from fairmultimodal_torch.models import text as t_text
from fairmultimodal_torch.models.tokenizer import WordPieceTokenizer
from fairmultimodal_tpu.models import text as j_text

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "the", "patient", "was", "intub", "##ated", "on", "arrival", "stable", "sepsis",
         "lactate", "elevated", "##s", "a", "b", "c", "notes", "chest", "pain", "no", "acute",
         "distress", "é", "naive", "cafe", "##é", "x", "##x", "!", ",", ".", "中", "##ing", "(",
         ")", "-", "'", "$", "^", "~", "p", "##a", "##t", "##i", "##e", "##n", "The", "Café"]
TEXTS = ["The patient WAS intubated on arrival!", "naïve café, Café", "中文字 x中x",
         "a\x00b​c\tthe the\x0cthe the\x85the", "patienting " * 3, "x" * 101 + " the",
         "x" * 100, "", "   ", "($patient^~'s)", "İstanbul résumé ÅÆ", "sepsis " * 40,
         "chest pain — no acute distress…", "�the　p", "lactate\nelevated\r\nb"]
GEO = dict(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=64, max_position_embeddings=48, type_vocab_size=2)
NOTES = [["the patient was intubated on arrival", "sepsis lactate elevated"], [],
         ["chest pain no acute distress"]]


def save_snapshot(path, seed=0, safe=True, lower=True):
    """A random BertModel + tokenizer saved like a real snapshot."""
    torch.manual_seed(seed)
    model = transformers.BertModel(transformers.BertConfig(**GEO)).eval()
    model.save_pretrained(path, safe_serialization=safe)
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(VOCAB) + "\n")
    tok = transformers.BertTokenizerFast(vocab_file=os.path.join(path, "vocab.txt"),
                                         do_lower_case=lower)
    tok.save_pretrained(path)
    return model, tok


@pytest.mark.parametrize("lower", [True, False])
def test_wordpiece_equals_bert_tokenizer_fast(lower, tmp_path):
    _, tok = save_snapshot(str(tmp_path), lower=lower)
    mine = WordPieceTokenizer.from_pretrained(str(tmp_path))
    assert mine.do_lower_case is lower
    for max_length in (24, 6):
        ids, mask = mine.encode_batch(TEXTS, max_length=max_length)
        want = tok(TEXTS, max_length=max_length, padding="max_length", truncation=True,
                   return_tensors="np")
        np.testing.assert_array_equal(ids, want["input_ids"])
        np.testing.assert_array_equal(mask, want["attention_mask"])
        assert ids.dtype == mask.dtype == np.int32


def test_tokenizer_config_defaults_to_lower_case(tmp_path):
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    tok = WordPieceTokenizer.from_pretrained(str(tmp_path))      # no tokenizer_config.json
    assert tok.do_lower_case and tok.strip_accents
    assert tok.tokenize_ids("The Café") == [VOCAB.index("the"), VOCAB.index("cafe")]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _cls(model, tok, chunks, max_len):
    batch = tok(chunks, max_length=max_len, padding="max_length", truncation=True,
                return_tensors="pt")
    with torch.no_grad():
        return model(**batch).last_hidden_state[:, 0, :].numpy()


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "pytorch_model_bin"])
def test_from_pretrained_matches_transformers_and_jax(safe, tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    path = str(tmp_path / "snapshot")
    model, tok = save_snapshot(path, safe=safe)
    assert os.path.exists(os.path.join(path, "model.safetensors" if safe else
                                       "pytorch_model.bin"))
    enc = t_text.TextEncoder.from_pretrained(path, require_weights=True, device="cpu")
    assert not enc.is_fallback
    assert (enc.config.hidden_size, enc.config.num_hidden_layers, enc.config.vocab_size,
            enc.config.max_position_embeddings) == (32, 2, len(VOCAB), 48)
    ours = t_text.encode_note_chunks(enc, NOTES, max_length=16, batch_size=4)
    np.testing.assert_array_equal(ours[1], np.zeros(32, np.float32))
    for pid, chunks in enumerate(NOTES):
        if chunks:
            np.testing.assert_allclose(ours[pid], _cls(model, tok, chunks, 16).mean(axis=0),
                                       rtol=1e-5, atol=1e-5)
    j_enc = j_text.TextEncoder.from_pretrained(path, require_weights=True)
    theirs = j_text.encode_note_chunks(j_enc, NOTES, max_length=16, batch_size=4)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)
    # The loaded tree is the JAX converter's, leaf for leaf, but for the
    # pooler, which neither encoder runs.
    params = t_bert.load_hf_bert_params(path)
    want = {k: v for k, v in _flat(j_enc.params).items() if not k.startswith("pooler/")}
    assert set(_flat(params)) == set(want)
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)


def test_model_name_resolves_through_the_hub_cache(tmp_path, monkeypatch):
    repo = tmp_path / "hub" / "models--emilyalsentzer--Bio_ClinicalBERT"
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text("abc123\n")
    save_snapshot(str(repo / "snapshots" / "abc123"))
    save_snapshot(str(repo / "snapshots" / "old456"), seed=9)    # another revision
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    snap = t_bert.resolve_hf_snapshot("emilyalsentzer/Bio_ClinicalBERT")
    assert snap == str(repo / "snapshots" / "abc123")
    enc = t_text.TextEncoder.from_pretrained(require_weights=True, device="cpu")
    direct = t_text.TextEncoder.from_pretrained(snap, require_weights=True, device="cpu")
    np.testing.assert_array_equal(t_text.encode_note_chunks(enc, NOTES, max_length=16),
                                  t_text.encode_note_chunks(direct, NOTES, max_length=16))
    # HF_HOME/hub when HF_HUB_CACHE is not set.
    monkeypatch.delenv("HF_HUB_CACHE")
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    assert t_bert.resolve_hf_snapshot("emilyalsentzer/Bio_ClinicalBERT") == snap
    # A name that is not there: a loud fallback, or an error when required.
    with pytest.raises(FileNotFoundError):
        t_bert.resolve_hf_snapshot("no/such-model")
    with pytest.raises(RuntimeError, match="required"):
        t_text.TextEncoder.from_pretrained("no/such-model", require_weights=True, device="cpu")
    tiny = t_bert.BertConfig(vocab_size=32, hidden_size=16, num_hidden_layers=1,
                             num_attention_heads=2, intermediate_size=32,
                             max_position_embeddings=16)
    with pytest.warns(UserWarning, match="RANDOM INIT"):
        fb = t_text.TextEncoder.from_pretrained("no/such-model", device="cpu")
    assert fb.is_fallback
    assert t_text.TextEncoder.from_pretrained("no/such-model", fallback_config=tiny,
                                              device="cpu").is_fallback


def test_changed_checkpoint_same_name_misses_cache(tmp_path):
    path, cache = str(tmp_path / "snapshot"), str(tmp_path / "cache")
    notes = [["the patient was stable"]]
    save_snapshot(path, seed=0)
    enc_a = t_text.TextEncoder.from_pretrained(path, require_weights=True, device="cpu")
    emb_a = t_text.encode_note_chunks(enc_a, notes, max_length=16, cache_dir=cache)
    save_snapshot(path, seed=1)                      # a new revision in the same directory
    enc_b = t_text.TextEncoder.from_pretrained(path, require_weights=True, device="cpu")
    assert enc_a.fingerprint != enc_b.fingerprint
    emb_b = t_text.encode_note_chunks(enc_b, notes, max_length=16, cache_dir=cache)
    assert not np.allclose(emb_a, emb_b), "stale cache served after a checkpoint change"
    assert len(glob.glob(os.path.join(cache, "text_emb_*.npz"))) == 2
    enc_b2 = t_text.TextEncoder.from_pretrained(path, require_weights=True, device="cpu")
    assert enc_b2.fingerprint == enc_b.fingerprint
    np.testing.assert_array_equal(
        t_text.encode_note_chunks(enc_b2, notes, max_length=16, cache_dir=cache), emb_b)
    bf16 = t_text.TextEncoder.from_pretrained(path, require_weights=True, dtype=torch.bfloat16,
                                              device="cpu")
    assert bf16.fingerprint != enc_b.fingerprint
    assert enc_b.fingerprint.startswith("fairmultimodal_torch|")
