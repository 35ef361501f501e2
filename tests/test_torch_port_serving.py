"""The serving slice end to end: the JAX package's ``run_fame_inference``
and the port's, on one synthetic cohort, one exported checkpoint and one set
of text-encoder weights (CPU, fp32).

Embeddings and probabilities must agree to 1e-5 and the thresholded
predictions must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fairmultimodal_torch.data import featurize as t_feat
from fairmultimodal_torch.interop import load_flax_params
from fairmultimodal_torch.models import bert as t_bert
from fairmultimodal_torch.models import fusion as t_fusion
from fairmultimodal_torch.models import text as t_text
from fairmultimodal_torch.pipelines import inference as t_inf
from fairmultimodal_torch.pipelines.common import build_arrays
from fairmultimodal_torch.pipelines.fame import FAME_KEYS
from fairmultimodal_torch.utils import checkpoint as t_ckpt
from fairmultimodal_tpu.data.featurize import assemble_features as j_assemble
from fairmultimodal_tpu.data.synthetic import make_common_frames
from fairmultimodal_tpu.models import bert as j_bert
from fairmultimodal_tpu.models import fusion as j_fusion
from fairmultimodal_tpu.models import text as j_text
from fairmultimodal_tpu.pipelines import inference as j_inf
from fairmultimodal_tpu.pipelines.fame import build_model_arrays as j_arrays
from fairmultimodal_tpu.utils.checkpoint import save_params_npz


def t_arrays(bundle):
    return build_arrays(bundle, FAME_KEYS)


TOL = dict(rtol=1e-5, atol=1e-5)
TEXT_CFG = dict(vocab_size=256, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=64, max_position_embeddings=64)
MAX_LEN = 64
BUCKETS = "16,32"    # with max_length 64: buckets 16 / 32 / 64 all run


@pytest.fixture(scope="module")
def frames():
    # 67 patients, 65 with notes: not a multiple of any predictor batch used.
    return make_common_frames(n_patients=67, n_lab_features=8, seed=11)


@pytest.fixture(scope="module")
def encoders():
    # Built directly from an init (no weight lookup, nothing fetched).
    cfg = j_bert.BertConfig(**TEXT_CFG)
    init = jax.jit(j_bert.BertEncoderModel(cfg).init)
    params = init(jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32),
                  jnp.ones((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    j_enc = j_text.TextEncoder(cfg, params, j_text.HashingTokenizer(cfg.vocab_size))
    t_enc = t_text.TextEncoder.from_params(params, t_bert.BertConfig(**TEXT_CFG),
                                           device="cpu")
    return j_enc, t_enc


@pytest.fixture(scope="module")
def exported(frames, encoders, tmp_path_factory):
    """A tiny JAX FAMEModel exported with its metadata, as training would."""
    j_enc, _ = encoders
    s, u = frames
    bundle = j_assemble(s, u)
    bundle.text_embeddings = j_text.encode_note_chunks(j_enc, bundle.note_chunks,
                                                      max_length=MAX_LEN)
    n_ages, n_gen, n_eth, n_ins = bundle.vocab_sizes()
    geometry = dict(num_ages=n_ages, num_genders=n_gen, num_ethnicities=n_eth,
                    num_insurances=n_ins, lab_token_count=bundle.num_lab_features,
                    text_embed_size=32, hidden_size=32, demo_layers=1, demo_heads=2,
                    lab_layers=1, lab_heads=2, fusion_hidden=16)
    model = j_fusion.FAMEModel(**geometry)
    arrays = j_arrays(bundle)
    params = jax.jit(model.init)(jax.random.PRNGKey(3),
                                 {k: jnp.asarray(v[:4]) for k, v in arrays.items()})["params"]
    path = str(tmp_path_factory.mktemp("ckpt") / "best_model.npz")
    meta = {"model": geometry,
            "thresholds": {"mortality": 0.45, "los": 0.5, "mechanical_ventilation": 0.55},
            "dynamic_weights": [[0.2, 0.5, 0.3], [0.3, 0.3, 0.4], [0.4, 0.4, 0.2]]}
    save_params_npz(path, params, metadata=meta)
    return path, model, params, arrays, meta


def test_hashing_tokenizer_ids_match_jax():
    text = "patient stable intubated sedated ventilator weaning patient stable"
    for vocab in (256, 28996):
        j, t = j_text.HashingTokenizer(vocab), t_text.HashingTokenizer(vocab)
        for got, want in zip(t.encode_batch([text, "a b", ""], 12),
                             j.encode_batch([text, "a b", ""], 12)):
            np.testing.assert_array_equal(got, want)


def test_checkpoint_reader_returns_the_flax_tree(exported):
    path, _, params, _, meta = exported
    tree = t_ckpt.load_params_npz(path)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [str(p) for p, _ in got] == [str(p) for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert t_ckpt.load_metadata_npz(path) == meta


def test_features_and_arrays_match_jax(frames):
    s, u = frames
    jb, tb = j_assemble(s, u), t_feat.assemble_features(s, u)
    assert tb.note_chunks == jb.note_chunks and tb.lab_columns == jb.lab_columns
    assert tb.vocab_sizes() == jb.vocab_sizes()
    jb.text_embeddings = tb.text_embeddings = np.ones((tb.num_patients, 4), np.float32)
    ja, ta = j_arrays(jb), t_arrays(tb)
    assert set(ja) == set(ta)
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)


@pytest.mark.parametrize("aggregation", ["mean", "max"])
def test_encode_note_chunks_matches_jax(frames, encoders, aggregation):
    j_enc, t_enc = encoders
    notes = t_feat.assemble_features(*frames).note_chunks
    notes = notes[:20] + [[]] + notes[20:30]      # a patient without notes
    kw = dict(max_length=MAX_LEN, batch_size=4, aggregation=aggregation,
              buckets=[16, 32])
    want = j_text.encode_note_chunks(j_enc, notes, **kw)
    got = t_text.encode_note_chunks(t_enc, notes, **kw)
    assert got.shape == (31, 32) and got.dtype == np.float32
    assert not got[20].any()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("env", ["0", "8,16,32"])
def test_text_bucket_variable_is_the_jax_one(frames, encoders, env, monkeypatch):
    """With only ``FMTPU_TEXT_BUCKETS`` set, the port buckets as the JAX
    encoder does: the same [rows, length] batch shapes in the same order, and
    the same embeddings."""
    j_enc, t_enc = encoders
    notes = t_feat.assemble_features(*frames).note_chunks[:24]
    monkeypatch.delenv("FMTORCH_TEXT_BUCKETS", raising=False)
    monkeypatch.setenv("FMTPU_TEXT_BUCKETS", env)
    shapes = {"jax": [], "torch": []}
    for name, enc in (("jax", j_enc), ("torch", t_enc)):
        def record(ids, mask, _encode=enc.encode_ids, _shapes=shapes[name]):
            _shapes.append(tuple(np.shape(ids)))
            return _encode(ids, mask)
        monkeypatch.setattr(enc, "encode_ids", record)
    kw = dict(max_length=MAX_LEN, batch_size=4)
    want = j_text.encode_note_chunks(j_enc, notes, **kw)
    got = t_text.encode_note_chunks(t_enc, notes, **kw)
    assert shapes["torch"] == shapes["jax"]
    lengths = {s[1] for s in shapes["torch"]}
    if env == "0":
        assert lengths == {MAX_LEN}
    else:
        assert lengths <= {8, 16, 32, MAX_LEN} and len(lengths) > 1
    np.testing.assert_allclose(got, want, **TOL)


def test_run_fame_inference_matches_jax(frames, encoders, exported, monkeypatch):
    j_enc, t_enc = encoders
    s, u = frames
    path = exported[0]
    monkeypatch.setenv("FMTPU_TEXT_BUCKETS", BUCKETS)
    want = j_inf.run_fame_inference(s, u, path, text_encoder=j_enc,
                                    text_max_length=MAX_LEN, verbose=False)
    got = t_inf.run_fame_inference(s, u, path, text_encoder=t_enc, text_max_length=MAX_LEN,
                                   verbose=False, device="cpu")
    assert list(got.columns) == list(want.columns) and len(got) == len(want) > 0
    np.testing.assert_array_equal(got["subject_id"], want["subject_id"])
    for task in ("mortality", "los", "mechanical_ventilation"):
        np.testing.assert_allclose(got[f"{task}_prob"], want[f"{task}_prob"], **TOL)
        np.testing.assert_array_equal(got[f"{task}_pred"], want[f"{task}_pred"])


def test_predictor_padded_tail_and_benchmark_match_jax(exported):
    _, model, params, arrays, meta = exported
    dw = np.asarray(meta["dynamic_weights"], np.float32)
    want = j_inf.FAMEPredictor(model, params, meta["thresholds"], batch_size=16,
                               dynamic_weights=dw).predict_arrays(arrays)
    t_model = load_flax_params(t_fusion.FAMEModel(**meta["model"]),
                               jax.tree_util.tree_map(np.asarray, params))
    pred = t_inf.FAMEPredictor(t_model, meta["thresholds"], batch_size=16,
                               dynamic_weights=dw, device="cpu")
    got = pred.predict_arrays(arrays)
    assert len(arrays["age_ids"]) % 16 != 0
    np.testing.assert_allclose(got["probs"], want["probs"], **TOL)
    np.testing.assert_array_equal(got["preds"], want["preds"])
    r = pred.benchmark(iters=2, warmup=1)
    assert r["batch_size"] == 16 and r["device"] == "cpu"
    assert r["batch_latency_ms"] > 0 and np.isfinite(r["patients_per_sec"])
