"""The legacy-generation models and experiments against the JAX package
(CPU, fp32).

- ``make_admission_frame``: every cell equal to the JAX DataFrame's (the
  times to the nanosecond);
- ``prepare_admission_sequences``: arrays, labels, groups and vocab equal
  to the JAX function's, index for index, from the port's table, from the
  JAX DataFrame, from the table written to CSV (by pandas, and by the port's
  writer) and read back without pandas (times as strings), and on frames
  with missing values, a shuffled row order, no time columns or no
  ``ETHNICITY``;
- ``BEHRTSequence``, ``EDDIEnhancementLayer``, ``EDDIDotFusion`` and
  ``LegacyEDDIFull`` (its lab encoder on the JAX Pallas kernels in interpret
  mode) from the JAX modules' weights: outputs within 1e-5, grads within
  1e-4;
- ``run_legacy_behrt_experiment`` and ``run_legacy_eddi_experiment`` end to
  end against the JAX pipelines, with and without ``reference_compat``: the
  splits exactly, per-epoch losses 1e-5 relative, test logits 1e-4, labels
  and groups exactly, the printed lines; 08's-era label columns (the
  ``_30_days`` spelling, ``mortality_30d_post_discharge``).
"""

import io
from contextlib import redirect_stdout

import jax
import numpy as np
import pandas as pd
import pytest
from test_torch_baseline_pipelines import (_recording, _shape, encoders,  # noqa: F401
                                           frames)
from test_torch_baselines import (LAB_H, N_AGE, N_ETH, N_GEN, N_INS, _check,  # noqa: F401
                                  _inputs, pallas_lab)

from fairmultimodal_torch.data import synthetic as t_syn
from fairmultimodal_torch.data.table import read_csv_table, table_from_frame, write_csv_table
from fairmultimodal_torch.interop import load_flax_params
from fairmultimodal_torch.models import legacy as t_leg
from fairmultimodal_torch.pipelines import common as t_common
from fairmultimodal_torch.pipelines import legacy as t_pipe
from fairmultimodal_tpu.data import synthetic as j_syn
from fairmultimodal_tpu.models import legacy as j_leg
from fairmultimodal_tpu.pipelines import legacy as j_pipe
from fairmultimodal_tpu.train import simple as j_simple


@pytest.mark.parametrize("n,max_adm,seed", [(80, 4, 0), (150, 7, 9)])
def test_make_admission_frame_matches_jax(n, max_adm, seed):
    got = t_syn.make_admission_frame(n, max_adm, seed=seed)
    want = j_syn.make_admission_frame(n, max_adm, seed=seed)
    assert list(got) == list(want.columns)
    for k, v in got.items():
        w = want[k].to_numpy()
        if k.endswith("TIME"):
            assert v.dtype == np.dtype("datetime64[ns]")
            np.testing.assert_array_equal(v.astype(np.int64),
                                          w.astype("datetime64[ns]").astype(np.int64), k)
        else:
            assert v.tolist() == w.tolist(), k
    assert np.isnat(got["DEATHTIME"]).sum() == (got["short_term_mortality"] == 0).sum()


def _assert_sequences_equal(got, want):
    (ga, gl, gs, gv), (wa, wl, ws, wv) = got, want
    assert set(ga) == set(wa)
    for k in wa:
        assert ga[k].dtype == wa[k].dtype, k
        np.testing.assert_array_equal(ga[k], wa[k], k)
    assert gl.dtype == wl.dtype
    np.testing.assert_array_equal(gl, wl)
    for k in ws:
        np.testing.assert_array_equal(gs[k], ws[k], k)
    assert gv == wv


def _variant(frame, kind):
    """A DataFrame that departs from the synthetic one as a real table might."""
    df = frame.copy()
    rng = np.random.default_rng(5)
    if kind == "shuffled":
        return df.iloc[rng.permutation(len(df))].reset_index(drop=True)
    if kind == "missing":
        df["age"] = df["age"].astype(float)
        df.loc[rng.random(len(df)) < 0.1, "age"] = np.nan
        df.loc[rng.random(len(df)) < 0.1, "ETHNICITY"] = None
        df.loc[rng.random(len(df)) < 0.1, "GENDER"] = None
        df.loc[::7, "DISCHTIME"] = df.loc[::7, "ADMITTIME"] + pd.Timedelta(hours=3)
        return df
    if kind == "no_times":
        return df.drop(columns=["ADMITTIME", "DISCHTIME", "DEATHTIME", "ETHNICITY",
                                "FIRST_WARDID"])
    raise ValueError(kind)


@pytest.mark.parametrize("source", ["port_table", "jax_frame", "csv", "port_csv", "shuffled",
                                    "missing", "no_times"])
def test_prepare_admission_sequences_matches_jax(source, tmp_path):
    frame = j_syn.make_admission_frame(120, seed=4)
    if source == "port_table":
        want, arg = j_pipe.prepare_admission_sequences(frame), t_syn.make_admission_frame(
            120, seed=4)
    elif source == "jax_frame":
        want, arg = j_pipe.prepare_admission_sequences(frame), frame
    elif source == "csv":
        frame.to_csv(tmp_path / "s.csv", index=False)
        want = j_pipe.prepare_admission_sequences(pd.read_csv(tmp_path / "s.csv"))
        arg = read_csv_table(str(tmp_path / "s.csv"))
        assert arg["ADMITTIME"].dtype == object
    elif source == "port_csv":     # written by the port, read by both
        write_csv_table(str(tmp_path / "s.csv"), t_syn.make_admission_frame(120, seed=4))
        want = j_pipe.prepare_admission_sequences(pd.read_csv(tmp_path / "s.csv"))
        _assert_sequences_equal(want, j_pipe.prepare_admission_sequences(frame))
        arg = read_csv_table(str(tmp_path / "s.csv"))
    else:
        df = _variant(frame, source)
        want, arg = j_pipe.prepare_admission_sequences(df), table_from_frame(df)
    got = t_pipe.prepare_admission_sequences(arg)
    _assert_sequences_equal(got, want)
    if source == "missing":    # the 6-hour filter dropped the 3-hour stays that lived
        assert len(got[1]) <= len(want[1]) and got[0]["disease_ids"].shape[1] % 8 == 0


SEQ = dict(num_diseases=40, num_ages=6, num_admission_locs=7, num_discharge_locs=5,
           num_genders=2, num_ethnicities=3, num_insurances=4, hidden_size=32,
           num_hidden_layers=1, num_attention_heads=2)


def test_behrt_sequence_matches_jax():
    rng = np.random.default_rng(30)
    n, s = 4, 8
    ids = rng.integers(0, 40, (n, s)).astype(np.int32)
    ids[:, 5:] = 0                               # pads (0 also masks a disease)
    inputs = {"disease_ids": ids}
    for key, hi in (("age_ids", 9), ("segment_ids", 2), ("adm_loc_ids", 9),
                    ("disch_loc_ids", 9), ("gender_ids", 3), ("ethnicity_ids", 5),
                    ("insurance_ids", 6)):       # some past their tables: clipped
        inputs[key] = rng.integers(0, hi, (n, s)).astype(np.int32)
    params = _check(j_leg.BEHRTSequence(**SEQ), t_leg.BEHRTSequence(**SEQ), inputs)
    assert {"classifier_mortality", "classifier_los", "classifier_mech"} <= set(params)


def test_eddi_enhancement_and_dot_fusion_match_jax():
    rng = np.random.default_rng(31)
    x = rng.normal(0, 1, (3, 8)).astype(np.float32)
    params = _check(j_leg.EDDIEnhancementLayer(8), t_leg.EDDIEnhancementLayer(8), (x,))
    np.testing.assert_array_equal(params["eddi_weight"], np.ones(8, np.float32))
    demo, lab, text = (rng.normal(0, 1, (3, d)).astype(np.float32) for d in (16, 12, 20))
    params = _check(j_leg.EDDIDotFusion(proj_dim=8, fusion_hidden=16),
                    t_leg.EDDIDotFusion(16, 12, 20, proj_dim=8, fusion_hidden=16),
                    (demo, lab, text))
    assert {"eddi_demo", "eddi_lab", "eddi_text", "dense1", "dense2"} <= set(params)


def test_legacy_eddi_full_matches_jax(pallas_lab):  # noqa: F811
    kw = dict(num_ages=N_AGE, num_genders=N_GEN, num_ethnicities=N_ETH, num_insurances=N_INS,
              lab_token_count=12, hidden_size=LAB_H, demo_layers=1, demo_heads=2,
              lab_layers=1, lab_heads=2)
    params = _check(j_leg.LegacyEDDIFull(**kw), t_leg.LegacyEDDIFull(**kw, text_embed_size=24),
                    _inputs(32))
    assert params["fusion"]["dense2"]["kernel"].shape[1] == 2


def _run_pair(name, args, config_kw, encoders, monkeypatch):  # noqa: F811
    """The JAX pipeline (train forward deterministic), then the port's from
    the JAX run's initial weights: (JAX result, JAX stdout, port result,
    port stdout, recorded report calls)."""
    runner, cfg_cls = {"behrt": ("run_legacy_behrt_experiment", "LegacyBEHRTPipelineConfig"),
                       "eddi": ("run_legacy_eddi_experiment", "LegacyEDDIPipelineConfig")}[name]
    calls, init = {"jax": {}, "port": {}}, {}
    original = j_simple.MultitaskTrainer.init_params

    def init_params(self, example):
        params = original(self, example)
        init["params"] = jax.tree_util.tree_map(np.array, params)     # the step donates
        return params

    def config(module, **train):
        cfg = getattr(module, cfg_cls)(**config_kw)
        cfg.train.num_epochs, cfg.train.deterministic_forward = 2, True
        for k, v in train.items():
            setattr(cfg.train, k, v)
        return cfg

    kwargs = {} if name == "behrt" else {"text_encoder": encoders[0]}
    mp = pytest.MonkeyPatch()
    _recording(mp, j_pipe, calls["jax"])
    mp.setattr(j_simple.MultitaskTrainer, "init_params", init_params)
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            want = getattr(j_pipe, runner)(*args, config(j_pipe, rng_impl="threefry"), **kwargs)
    finally:
        mp.undo()
    j_out = buf.getvalue()

    _recording(monkeypatch, t_common, calls["port"])
    monkeypatch.setattr(t_pipe, "init_params",
                        lambda model, seed: load_flax_params(model, init["params"]))
    if name == "eddi":
        kwargs = {"text_encoder": encoders[1]}
        args = tuple(table_from_frame(a) for a in args)
    buf = io.StringIO()
    with redirect_stdout(buf):
        got = getattr(t_pipe, runner)(*args, config(t_pipe), device="cpu", **kwargs)
    return want, j_out, got, buf.getvalue(), calls


def _assert_runs_match(want, j_out, got, t_out, calls):
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(got["splits"][split], want["splits"][split])
    assert len(got["history"]) == len(want["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        assert g["train_loss"] == pytest.approx(w["train_loss"], rel=1e-5), (g, w)
        assert g["val_loss"] == pytest.approx(w["val_loss"], rel=1e-5), (g, w)
        assert g["lr"] == w["lr"]
    (t_logits, t_labels, t_sens), (j_logits, j_labels, j_sens) = (
        c["evaluate_multitask"][:3] for c in (calls["port"], calls["jax"]))
    np.testing.assert_allclose(t_logits, j_logits, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(t_labels, j_labels)
    assert set(t_sens) == set(j_sens) == {"age", "ethnicity", "insurance"}
    for k in j_sens:
        np.testing.assert_array_equal(t_sens[k], j_sens[k])
    assert _shape(t_out) == _shape(j_out)
    assert set(got["metrics"]) == set(want["metrics"])


@pytest.mark.parametrize("reference_compat", [False, True])
def test_legacy_behrt_pipeline_matches_jax(reference_compat, encoders,  # noqa: F811
                                           monkeypatch):
    frame = j_syn.make_admission_frame(96, seed=6)
    run = _run_pair("behrt", (frame,), dict(hidden_size=32, num_hidden_layers=1,
                                            num_attention_heads=2,
                                            reference_compat=reference_compat),
                    encoders, monkeypatch)
    _assert_runs_match(*run)
    want, _, got, _, _ = run
    assert got["vocab"] == want["vocab"]
    n = len(got["splits"]["test"])
    if reference_compat:       # train == val == test == the whole cohort
        assert all(np.array_equal(got["splits"][s], np.arange(n)) for s in ("train", "val"))
    else:
        assert n < sum(len(v) for v in got["splits"].values())


@pytest.mark.parametrize("reference_compat,era_columns", [(False, False), (True, True)])
def test_legacy_eddi_pipeline_matches_jax(reference_compat, era_columns, frames,  # noqa: F811
                                          encoders, monkeypatch):
    s, u = frames
    if era_columns:
        s = s.rename(columns={"readmission_within_30d": "readmission_within_30_days"})
        s["mortality_30d_post_discharge"] = (s["subject_id"] % 5 == 0).astype(np.int64)
    run = _run_pair("eddi", (s, u), dict(hidden_size=32, demo_layers=1, demo_heads=2,
                                         lab_layers=1, lab_heads=2, text_max_length=32,
                                         text_batch_size=16,
                                         reference_compat=reference_compat),
                    encoders, monkeypatch)
    _assert_runs_match(*run)
    got, calls = run[2], run[4]
    assert set(got["metrics"]) == {"mortality", "readmission"}
    if era_columns:
        labels = got["bundle"].labels
        rows = {sid: i for i, sid in enumerate(s["subject_id"].tolist())}
        want = s["mortality_30d_post_discharge"].to_numpy()[
            [rows[i] for i in got["bundle"].subject_id.tolist()]]
        np.testing.assert_array_equal(labels[:, 0], want)
