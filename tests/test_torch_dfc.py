"""03 DfC and 08's bare ``EDDIFusionModel`` against the JAX package (CPU, fp32).

- ``DfCModel`` (through the pipeline's ``DfCBatchModel``, whose ``dfc``
  nesting is the JAX adapter's) and ``EDDIFusionModel`` from the JAX
  modules' own weights (``interop.load_flax_params``): every output within
  1e-5, the grads of a random projection of the outputs within 1e-4; DfC's
  ids past their tables are clipped, and its vocabulary is at least 4;
- ``run_dfc_experiment`` end to end on a tiny cohort against the JAX
  pipeline (scikit-multilearn's split and the clip-10 weights exactly,
  per-epoch losses 1e-5 relative, test logits 1e-4, the printed lines), as
  ``test_torch_baseline_pipelines.py`` holds the other baselines.
"""

import io
import types
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch
from test_torch_baseline_pipelines import (_recording, _shape, encoders,  # noqa: F401
                                           frames)
from test_torch_baselines import _check, _inputs

from fairmultimodal_torch.interop import load_flax_params
from fairmultimodal_torch.models import fusion as t_fusion
from fairmultimodal_torch.pipelines import common as t_common
from fairmultimodal_torch.pipelines import dfc as t_dfc
from fairmultimodal_tpu.models import fusion as j_fusion
from fairmultimodal_tpu.pipelines import dfc as j_dfc
from fairmultimodal_tpu.train import simple as j_simple

TEXT = 24
SMALL = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2)


def _jax_dfc_batch_model(**kw):
    """The JAX pipeline's ``DfCBatchModel`` (built inside
    ``run_dfc_experiment``), captured from one call."""
    seen = {}

    class Stop(Exception):
        pass

    class Trainer:
        def __init__(self, model, *args, **kwargs):
            seen["model"] = model
            raise Stop

    mp = pytest.MonkeyPatch()
    mp.setattr(j_dfc, "MultitaskTrainer", Trainer)
    mp.setattr(j_dfc, "prepare_experiment",
               lambda *a, **k: types.SimpleNamespace(pos_weight=None))
    try:
        with pytest.raises(Stop):
            j_dfc.run_dfc_experiment(None, None, j_dfc.DfCPipelineConfig(**kw), verbose=False)
    finally:
        mp.undo()
    return seen["model"]


@pytest.mark.parametrize("far_ids", [False, True])
def test_dfc_batch_model_matches_jax(far_ids):
    inputs = _inputs(11, n=5)
    inputs["text_embedding"] = inputs["text_embedding"][:, :TEXT]
    if far_ids:        # ids past every table: clipped into them
        for k in ("segment_ids", "adm_loc_ids", "disch_loc_ids"):
            inputs[k] = inputs[k] + 40
    params = _check(_jax_dfc_batch_model(**SMALL),
                    t_dfc.DfCBatchModel(**SMALL, text_embed_size=TEXT), inputs)
    assert set(params) == {"dfc"}
    assert {"bert", "segment_embedding", "admission_loc_embedding", "discharge_loc_embedding",
            "struct_projector", "text_projector", "dense1", "dense2"} == set(params["dfc"])


def test_dfc_vocabulary_is_at_least_four():
    small = dict(num_segments=1, num_admission_locs=1, num_discharge_locs=0)
    model = t_fusion.DfCModel(**small, **SMALL)
    assert model.bert.embeddings.word_embeddings.num_embeddings == 4
    big = t_fusion.DfCModel(**SMALL)
    assert big.bert.embeddings.word_embeddings.num_embeddings == 2 + 10 + 10 + 2
    assert big.bert.layer_0.intermediate.out_features == 4 * SMALL["hidden_size"]


def test_eddi_fusion_model_matches_jax():
    rng = np.random.default_rng(12)
    demo, lab, text = (rng.normal(0, 1, (4, d)).astype(np.float32) for d in (16, 20, TEXT))
    params = _check(j_fusion.EDDIFusionModel(proj_dim=8),
                    t_fusion.EDDIFusionModel(16, 20, TEXT, proj_dim=8), (demo, lab, text))
    assert sum(k.startswith("head_") for k in params) == 9


def test_dfc_pipeline_matches_jax(frames, encoders, monkeypatch):  # noqa: F811
    """The JAX pipeline with its train forward deterministic, then the
    port's from the JAX run's initial weights."""
    calls, init = {"jax": {}, "port": {}}, {}
    original = j_simple.MultitaskTrainer.init_params

    def init_params(self, example):
        params = original(self, example)
        init["params"] = jax.tree_util.tree_map(np.array, params)     # the step donates
        return params

    def config(module, **train):
        cfg = module.DfCPipelineConfig(**SMALL, text_max_length=32, text_batch_size=16)
        cfg.train.num_epochs, cfg.train.deterministic_forward = 2, True
        for k, v in train.items():
            setattr(cfg.train, k, v)
        return cfg

    mp = pytest.MonkeyPatch()
    _recording(mp, j_dfc, calls["jax"])
    mp.setattr(j_simple.MultitaskTrainer, "init_params", init_params)
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            want = j_dfc.run_dfc_experiment(*frames, config(j_dfc, rng_impl="threefry"),
                                            text_encoder=encoders[0])
    finally:
        mp.undo()
    j_out = buf.getvalue()

    _recording(monkeypatch, t_common, calls["port"])
    monkeypatch.setattr(t_dfc, "init_params",
                        lambda model, seed: load_flax_params(model, init["params"]))
    buf = io.StringIO()
    with redirect_stdout(buf):
        got = t_dfc.run_dfc_experiment(*frames, config(t_dfc), text_encoder=encoders[1],
                                       device="cpu")
    t_out = buf.getvalue()

    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(got["prep"].idx[split], want["prep"].idx[split])
    np.testing.assert_array_equal(got["prep"].pos_weight, want["prep"].pos_weight)
    assert len(got["history"]) == len(want["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        assert g["train_loss"] == pytest.approx(w["train_loss"], rel=1e-5), (g, w)
        assert g["val_loss"] == pytest.approx(w["val_loss"], rel=1e-5), (g, w)
        assert g["lr"] == w["lr"]
    (t_logits, t_labels, t_sens), (j_logits, j_labels, j_sens) = (
        c["evaluate_multitask"][:3] for c in (calls["port"], calls["jax"]))
    np.testing.assert_allclose(t_logits, j_logits, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(t_labels, j_labels)
    for k in j_sens:
        np.testing.assert_array_equal(t_sens[k], j_sens[k])
    assert _shape(t_out) == _shape(j_out)
    assert isinstance(got["trainer"].model, t_dfc.DfCBatchModel)
    assert got["best_params"]["dfc.dense2.weight"].dtype == torch.float32
