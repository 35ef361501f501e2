"""The port's text-embedding cache (``--text_cache`` / ``FMTPU_TEXT_CACHE``),
held to the JAX package's tests of its own (``tests/test_text_cache.py``).

The frozen encoder's output is a pure function of (weights, note text,
settings), so ``encode_note_chunks`` keeps it content-addressed: a second
call is read from the cache without encoding, bit for bit; a change of note
text, truncation length, aggregation or encoder makes a new entry; the
environment variable is the default; an all-empty cohort is cached too.
The fingerprint names the port, so the port and the JAX package, sharing
one directory, keep an entry each and never read the other's.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fairmultimodal_torch.models import bert as t_bert
from fairmultimodal_torch.models import text as t_text
from fairmultimodal_tpu.models import bert as j_bert
from fairmultimodal_tpu.models import text as j_text

TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=64)
CHUNKS = [["alpha beta gamma", "delta epsilon"], [], ["zeta eta"]]


@pytest.fixture(scope="module")
def encoder():
    return t_text.TextEncoder.from_pretrained("no/such-model",
                                              fallback_config=t_bert.BertConfig(**TINY),
                                              device="cpu")


def _encode(encoder, cache_dir, chunks=CHUNKS, **kw):
    return t_text.encode_note_chunks(encoder, chunks, max_length=16, batch_size=4,
                                     cache_dir=cache_dir, **kw)


def _entries(cache):
    return glob.glob(os.path.join(cache, "text_emb_*.npz"))


def _no_encode(monkeypatch, encoder):
    monkeypatch.setattr(encoder, "encode_ids",
                        lambda *a, **k: pytest.fail("cache miss: encode_ids called"))


def test_cache_round_trip_and_no_reencode(encoder, tmp_path, monkeypatch):
    cache = str(tmp_path / "cache")
    first = _encode(encoder, cache)
    assert len(_entries(cache)) == 1
    assert not glob.glob(os.path.join(cache, "*.tmp*"))
    _no_encode(monkeypatch, encoder)
    second = _encode(encoder, cache)
    np.testing.assert_array_equal(first, second)
    assert second.dtype == np.float32


def test_cache_key_sensitivity(encoder, tmp_path):
    cache = str(tmp_path / "cache")
    _encode(encoder, cache)
    _encode(encoder, cache, chunks=[["alpha beta CHANGED"], [], ["zeta eta"]])
    t_text.encode_note_chunks(encoder, CHUNKS, max_length=8, batch_size=4, cache_dir=cache)
    _encode(encoder, cache, aggregation="max")
    other = t_text.TextEncoder.from_pretrained("no/such-model", seed=7, device="cpu",
                                               fallback_config=t_bert.BertConfig(**TINY))
    _encode(other, cache)
    assert len(_entries(cache)) == 5


def test_cache_fingerprint_without_from_pretrained(encoder, tmp_path):
    manual = t_text.TextEncoder(encoder.config, encoder.model, encoder.tokenizer, device="cpu")
    assert manual.fingerprint is None
    fp = manual.cache_fingerprint()
    assert fp.startswith("fairmultimodal_torch|params:") and manual.cache_fingerprint() == fp
    cache = str(tmp_path / "cache")
    np.testing.assert_array_equal(_encode(manual, cache), _encode(manual, cache))
    assert len(_entries(cache)) == 1


def test_env_var_default(encoder, tmp_path, monkeypatch):
    cache = str(tmp_path / "env_cache")
    monkeypatch.setenv("FMTPU_TEXT_CACHE", cache)
    out = t_text.encode_note_chunks(encoder, CHUNKS, max_length=16, batch_size=4)
    assert _entries(cache)
    _no_encode(monkeypatch, encoder)
    again = t_text.encode_note_chunks(encoder, CHUNKS, max_length=16, batch_size=4)
    np.testing.assert_array_equal(out, again)


def test_all_empty_cohort_cached(encoder, tmp_path):
    cache = str(tmp_path / "cache")
    out = _encode(encoder, cache, chunks=[[], [], []])
    np.testing.assert_array_equal(out, np.zeros_like(out))
    assert _entries(cache)


def test_the_two_packages_keep_apart_entries(tmp_path):
    """The same weights, notes and settings: one entry each, equal values."""
    cfg = j_bert.BertConfig(**TINY)
    params = jax.jit(j_bert.BertEncoderModel(cfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params["params"]))
    j_enc = j_text.TextEncoder(cfg, params, j_text.HashingTokenizer(cfg.vocab_size))
    t_enc = t_text.TextEncoder.from_params(params, t_bert.BertConfig(**TINY), device="cpu")
    cache = str(tmp_path / "cache")
    theirs = j_text.encode_note_chunks(j_enc, CHUNKS, max_length=16, batch_size=4,
                                       cache_dir=cache)
    ours = _encode(t_enc, cache)
    assert len(_entries(cache)) == 2
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)
