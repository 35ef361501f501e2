"""The port's MIMIC-III ETL (``fairmultimodal_torch/data/etl.py``) against the
JAX package's on the CPU.

``run_etl`` of both packages on ``write_raw_mimic(30, seed=0)`` and
``write_raw_mimic(400, seed=0)``, native scanners on and off: each of the
five CSVs read back with pandas has the same columns in the same order, the
same dtypes and rows; text, integers and times are equal and NaN sits in
the same cells; floats agree within 1e-12 of each column's max-abs (pandas'
group mean sums with compensation, the port's segments do not).  The port's
raw-table writers against the JAX writers, table for table after parsing.

One test per trap of the port: the first-stay sort's ties (pandas' unstable
sort decides which 2-hour bin's lab value survives; a stable sort changes
cells at 400 subjects), the ventilation dedup (first wins, ``charttime``
compared as text, a missing ``ICUSTAY_ID`` dropped), an all-NaN group (mean
NaN, sum 0.0), both readmission modes, ``mortality_30d_post_discharge``,
the categorizers' catch-alls and the printed ``count_unmapped`` lines, and
note cleaning with a non-ASCII document.
"""

import gzip
import io
import os
from contextlib import redirect_stdout

import numpy as np
import pandas as pd
import pytest
import torch

from fairmultimodal_tpu.data import etl as j_etl
from fairmultimodal_tpu.data import synthetic as j_syn
from fairmultimodal_torch.data import etl as t_etl
from fairmultimodal_torch.data import synthetic as t_syn
from fairmultimodal_torch.data.table import to_datetime, write_csv_table

FILES = ("final_structured_dataset.csv", "final_structured_with_feature_set_C_24h_2h_bins.csv",
         "unstructured_with_demographics.csv", "final_structured_common.csv",
         "final_unstructured_common.csv")
CPU = torch.device("cpu")


def assert_csvs_match(want_dir, got_dir, files=FILES, tol=1e-12):
    """The CSV rule: columns, dtypes and rows equal; text, integers, bools
    and times exactly; NaN in the same cells; floats within ``tol`` of the
    column's max-abs."""
    for name in files:
        want = pd.read_csv(os.path.join(want_dir, name))
        got = pd.read_csv(os.path.join(got_dir, name))
        assert list(got.columns) == list(want.columns), name
        assert got.shape == want.shape, name
        for col in want.columns:
            w, g = want[col], got[col]
            assert g.dtype == w.dtype, (name, col, g.dtype, w.dtype)
            np.testing.assert_array_equal(g.isna().to_numpy(), w.isna().to_numpy(),
                                          err_msg=f"{name}:{col}")
            w, g = w[w.notna()].to_numpy(), g[g.notna()].to_numpy()
            if w.dtype.kind == "f" and len(w):
                scale = max(np.abs(w).max(), 1e-300)
                assert np.abs(g - w).max() <= tol * scale, (name, col)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{name}:{col}")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """JAX-written raw tables at 30 and 400 subjects."""
    out = {}
    for n in (30, 400):
        d = str(tmp_path_factory.mktemp(f"raw{n}"))
        j_syn.write_raw_mimic(d, n_subjects=n, seed=0)
        out[n] = d
    return out


def _run_both(raw_dir, tmp_path, **kw):
    with redirect_stdout(io.StringIO()) as j_out:
        j_stats = j_etl.run_etl(raw_dir, str(tmp_path / "jax"), **kw)
    with redirect_stdout(io.StringIO()) as t_out:
        t_stats = t_etl.run_etl(raw_dir, str(tmp_path / "port"), device="cpu", **kw)
    return j_stats, t_stats, j_out.getvalue(), t_out.getvalue()


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("n", [30, 400])
def test_run_etl_matches_jax(raw, n, use_native, tmp_path):
    j_stats, t_stats, j_out, t_out = _run_both(raw[n], tmp_path, use_native=use_native)
    assert t_stats == j_stats
    assert t_out == j_out                   # the [etl] lines
    assert_csvs_match(tmp_path / "jax", tmp_path / "port")


def test_timing_lines_and_stats(raw, tmp_path):
    j_stats, t_stats, j_out, t_out = _run_both(raw[30], tmp_path, use_native=False, timing=True)
    keys = [(e["table"], e["path"], e["rows"]) for e in t_stats.pop("timings")]
    assert keys == [(e["table"], "plain" if e["path"] == "pandas" else e["path"], e["rows"])
                    for e in j_stats.pop("timings")]
    assert t_stats == j_stats

    def shape(text):
        import re
        return [re.sub(r"[\d.]+ s|[\d.]+M rows/s", "#", line.replace("pandas path", "plain path"))
                for line in text.splitlines()]

    assert shape(t_out) == shape(j_out) and "[etl timing] structured phase" in t_out


def test_port_writers_match_jax(raw, tmp_path):
    """``write_raw_mimic`` table for table, parsed; the scaled writer at a tiny size."""
    t_syn.write_raw_mimic(str(tmp_path / "w400"), n_subjects=400, seed=0)
    names = sorted(os.listdir(raw[400]))
    assert sorted(os.listdir(tmp_path / "w400")) == names
    assert_csvs_match(raw[400], tmp_path / "w400", files=names, tol=0)
    kw = dict(n_subjects=20, chartevents_rows=3000, chunk_rows=1000, verbose=False, seed=3)
    want = j_syn.write_raw_mimic_scaled(str(tmp_path / "sj"), **kw)
    assert t_syn.write_raw_mimic_scaled(str(tmp_path / "st"), **kw) == want
    assert_csvs_match(tmp_path / "sj", tmp_path / "st", files=sorted(os.listdir(tmp_path / "sj")),
                      tol=0)


def test_scaled_tables_through_both_etls(tmp_path):
    t_syn.write_raw_mimic_scaled(str(tmp_path / "raw"), n_subjects=40, chartevents_rows=4000,
                                 chunk_rows=1500, verbose=False)
    _run_both(str(tmp_path / "raw"), tmp_path, use_native=None)
    assert_csvs_match(tmp_path / "jax", tmp_path / "port")


# -- trap 1: the first-stay sort's ties --------------------------------------------------

def test_nargsort_is_pandas_sort_values():
    rng = np.random.default_rng(0)
    days = rng.integers(0, 40, 3000)          # many ties
    times = (np.datetime64("2150-01-01", "ns") + days.astype("timedelta64[D]")).astype(
        "datetime64[ns]")
    times[rng.random(3000) < 0.05] = np.datetime64("NaT")
    want = pd.DataFrame({"INTIME": times}).sort_values(by="INTIME").index.to_numpy()
    np.testing.assert_array_equal(t_etl._nargsort(times), want)


def test_first_stay_ties_decide_lab_cells(raw, tmp_path, monkeypatch):
    """At 400 subjects the quicksort's tie order matches the JAX cells; a
    stable sort in its place changes lab cells of the base cohort."""
    j_etl.run_etl(raw[400], str(tmp_path / "jax"), use_native=False)
    t_etl.run_etl(raw[400], str(tmp_path / "port"), use_native=False, device="cpu")
    assert_csvs_match(tmp_path / "jax", tmp_path / "port", files=FILES[:1])

    def stable(times):
        nat = np.isnat(times)
        idx = np.arange(len(times))
        return np.concatenate([idx[~nat][np.argsort(times[~nat], kind="stable")], idx[nat]])

    monkeypatch.setattr(t_etl, "_nargsort", stable)
    t_etl.run_etl(raw[400], str(tmp_path / "stable"), use_native=False, device="cpu")
    want = pd.read_csv(tmp_path / "jax" / FILES[0])
    got = pd.read_csv(tmp_path / "stable" / FILES[0])
    labs = [c for c in want.columns if c.startswith("lab_t")]
    differ = ~((want[labs] == got[labs]) | (want[labs].isna() & got[labs].isna()))
    assert int(differ.to_numpy().sum()) > 0


# -- trap 2: the ventilation dedup -------------------------------------------------------

def _write(path, table):
    write_csv_table(str(path), {k: np.asarray(v, dtype=object) if isinstance(v[0], str)
                                else np.asarray(v) for k, v in table.items()})


def test_ventilation_dedup_first_wins_on_text_charttime(tmp_path):
    """Stay 1: CHARTEVENTS' all-zero row at "2150-01-01 06:00:00" wins over
    PROCEDUREEVENTS_MV's extubation at the same text -> 0.  Stay 2: the same
    instant written "2150-01-02T06:00:00" is another key, so the extubation
    stays -> 1.  Stay 3: its only mechvent row has no ICUSTAY_ID -> dropped
    -> no flag row at all."""
    _write(tmp_path / "ICUSTAYS.csv.gz", {"SUBJECT_ID": [1, 2, 3], "HADM_ID": [11, 12, 13],
                                          "ICUSTAY_ID": [21, 22, 23]})
    with gzip.open(tmp_path / "CHARTEVENTS.csv.gz", "wt") as f:
        f.write("ICUSTAY_ID,CHARTTIME,ITEMID,VALUE,ERROR\n"
                "21,2150-01-01 06:00:00,226732,Room air,0\n"
                "22,2150-01-02 06:00:00,226732,Room air,0\n"
                ",2150-01-03 06:00:00,223849,CMV,0\n"
                "23,2150-01-03 07:00:00,226732,Room air,\n"
                "23,2150-01-03 08:00:00,223849,CMV,1\n")
    _write(tmp_path / "PROCEDUREEVENTS_MV.csv.gz", {
        "ICUSTAY_ID": [21, 22, 22], "STARTTIME": ["2150-01-01 06:00:00", "2150-01-02T06:00:00",
                                                  "2150-01-02T06:00:00"],
        "ITEMID": [227194, 225468, 225468]})
    want = j_etl.compute_ventilation_flags(str(tmp_path))
    got = t_etl.compute_ventilation_flags(str(tmp_path), device="cpu")
    assert list(got) == list(want.columns)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k].to_numpy(), err_msg=k)
    assert dict(zip(got["subject_id"].tolist(), got["mechanical_ventilation"].tolist())) == {
        1: 0, 2: 1, 3: 0}


# -- group-by semantics -------------------------------------------------------------------

def test_groups_reduce_as_pandas_groupby():
    """Mean and sum skip NaN (an all-NaN group: NaN / 0.0), max skips NaN,
    groups in sorted key order, a missing key dropped, float64 on ``device``."""
    rng = np.random.default_rng(5)
    n = 500
    a = rng.integers(0, 6, n).astype(np.float64)
    a[rng.random(n) < 0.05] = np.nan
    b = np.array([f"t{k}" for k in rng.integers(0, 4, n)], dtype=object)
    v = rng.normal(size=(n, 2))
    v[rng.random((n, 2)) < 0.3] = np.nan
    v[(a == 2) & (b == "t1"), 0] = np.nan          # an all-NaN group in column 0
    frame = pd.DataFrame({"a": a, "b": b, "x": v[:, 0], "y": v[:, 1]})
    want = frame.groupby(["a", "b"])
    g = t_etl._Groups([a, b], CPU)
    assert g.n == want.ngroups
    np.testing.assert_array_equal(g.key(a), want.mean().index.get_level_values(0))
    np.testing.assert_array_equal(g.key(b), want.mean().index.get_level_values(1))
    for how in ("mean", "sum", "max"):
        np.testing.assert_allclose(getattr(g, how)(v).numpy(),
                                   getattr(want, how)()[["x", "y"]].to_numpy(),
                                   rtol=0, atol=1e-12, err_msg=how)
    all_nan = [i for i, k in enumerate(zip(g.key(a), g.key(b))) if k == (2.0, "t1")]
    assert np.isnan(g.mean(v).numpy()[all_nan, 0]).all()
    assert (g.sum(v).numpy()[all_nan, 0] == 0).all()
    first = g.first(~np.isnan(v))
    np.testing.assert_array_equal(np.where(first >= 0, v[first, [0, 1]], np.nan),
                                  want.first()[["x", "y"]].to_numpy())


def test_all_nan_group_through_both_feature_tables(tmp_path):
    """OUTPUTEVENTS (sum) and CHARTEVENTS (mean) with a group whose only
    value does not parse: the plain path gives 0.0 / NaN as pandas does."""
    _write(tmp_path / "OUTPUTEVENTS.csv.gz", {
        "SUBJECT_ID": [1, 1, 2], "HADM_ID": [11, 11, 12],
        "CHARTTIME": ["2150-01-01 01:00:00", "2150-01-01 03:00:00", "2150-01-02 01:00:00"],
        "ITEMID": [226573, 226573, 226573], "VALUE": ["abc", "5.5", "7.25"]})
    _write(tmp_path / "CHARTEVENTS.csv.gz", {
        "SUBJECT_ID": [1, 2], "HADM_ID": [11, 12],
        "CHARTTIME": ["2150-01-01 01:00:00", "2150-01-02 01:00:00"],
        "ITEMID": [220045, 220045], "VALUE": ["n/a-ish", "80"]})
    times = ["2150-01-01 00:00:00", "2150-01-02 00:00:00"]
    j_stays = pd.DataFrame({"subject_id": [1, 2], "hadm_id": [11, 12],
                            "intime": pd.to_datetime(times)})
    t_stays = {"subject_id": np.array([1, 2]), "hadm_id": np.array([11, 12]),
               "intime": to_datetime(np.array(times, dtype=object))}
    for table, want_first in (("outputevents", 0.0), ("chartevents", np.nan)):
        want = j_etl.aggregate_feature_table(str(tmp_path), table, {1, 2}, j_stays,
                                             use_native=False)
        got = t_etl.aggregate_feature_table(str(tmp_path), table, np.array([1, 2]), t_stays,
                                            use_native=False, device="cpu")
        assert list(got) == list(want.columns)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k].to_numpy(), err_msg=k)
        np.testing.assert_array_equal(got[list(got)[2]][0], want_first)


# -- labels -------------------------------------------------------------------------------

def _admissions(rng, n=300):
    subj = rng.integers(0, 60, n)
    admit = (np.datetime64("2150-01-01", "ns")
             + (rng.integers(0, 200, n) * 86400 + rng.integers(0, 3, n) * 3600).astype(
                 "timedelta64[s]")).astype("datetime64[ns]")
    admit[rng.random(n) < 0.05] = np.datetime64("NaT")
    disch = admit + rng.integers(1, 30 * 86400, n).astype("timedelta64[s]")
    return {"subject_id": subj, "hadm_id": np.arange(n) + 1000, "ADMITTIME": admit,
            "DISCHTIME": disch}


@pytest.mark.parametrize("mode", ["reference", "discharge_gap"])
def test_readmission_labels_match_jax(mode):
    t = _admissions(np.random.default_rng(7))
    want = j_etl.compute_readmission_labels(pd.DataFrame(t), mode=mode)
    got = t_etl.compute_readmission_labels(t, mode=mode)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k].to_numpy(), err_msg=k)
    assert 0 < got["readmission_within_30d"].sum() < len(got["hadm_id"])
    with pytest.raises(ValueError, match="unknown readmission mode"):
        t_etl.compute_readmission_labels(t, mode="other")


def test_run_etl_discharge_gap_mode_matches_jax(raw, tmp_path):
    _run_both(raw[30], tmp_path, use_native=False, readmission_mode="discharge_gap")
    assert_csvs_match(tmp_path / "jax", tmp_path / "port")


def test_mortality_30d_post_discharge_matches_jax():
    rng = np.random.default_rng(8)
    t = _admissions(rng)
    death = t["DISCHTIME"] + rng.integers(-5 * 86400, 60 * 86400, len(t["hadm_id"])).astype(
        "timedelta64[s]")
    death[rng.random(len(death)) < 0.4] = np.datetime64("NaT")
    t["DEATHTIME"] = death
    want = j_etl.compute_mortality_30d_post_discharge(pd.DataFrame(t))
    got = t_etl.compute_mortality_30d_post_discharge(t)
    np.testing.assert_array_equal(got, want.to_numpy())
    assert 0 < got.sum() < len(got)


# -- categories and notes -------------------------------------------------------------------

def test_categorizers_catch_alls_and_unmapped_lines(tmp_path):
    d = tmp_path / "raw"
    j_syn.write_raw_mimic(str(d), n_subjects=24, seed=4)
    adm = pd.read_csv(d / "ADMISSIONS.csv.gz")
    adm.loc[adm.index[:5], "ETHNICITY"] = "UNSEEN CATEGORY X"
    adm.loc[adm.index[5:8], "INSURANCE"] = "Workers Comp"
    adm.loc[adm.index[8], "ETHNICITY"] = np.nan
    adm.to_csv(d / "ADMISSIONS.csv.gz", index=False, compression="gzip")
    _, _, j_out, t_out = _run_both(str(d), tmp_path, use_native=False)
    lines = [line for line in t_out.splitlines() if line.startswith("[etl]")]
    assert lines == [line for line in j_out.splitlines() if line.startswith("[etl]")]
    assert any("unmapped ETHNICITY routed to 'Other'" in x for x in lines)
    assert any("unmapped INSURANCE routed to 'Government'" in x for x in lines)
    assert_csvs_match(tmp_path / "jax", tmp_path / "port")
    values = ["WHITE", "white - russian", "ASIAN - INDIAN", "MARTIAN", None, np.nan, 7,
              "Medicare HMO", "private", "Self Pay", "Other"]
    for fn in ("categorize_ethnicity", "categorize_insurance"):
        assert [getattr(t_etl, fn)(v) for v in values] == [getattr(j_etl, fn)(v) for v in values]
    ages = [14, 15, 29, 30, 49.0, 50, 69, 70, 89, 90, np.nan]
    assert [t_etl.categorize_age(a) for a in ages] == [j_etl.categorize_age(a) for a in ages]


@pytest.mark.parametrize("use_native", [True, False])
def test_note_cleaning_with_a_non_ascii_document(use_native):
    texts = ["Admission Date: [**2112-3-4**] Dr. Smith M.D. 12. seen -- ok",
             "naïve café [é] dr. 5. résumé " + "mot " * 600, "", None,
             "plain words " * 700, "Discharge Date:\r\n==__--x"]
    want = j_etl.clean_and_chunk_texts(texts, use_native=False)
    assert t_etl.clean_and_chunk_texts(texts, use_native=use_native) == want
    assert len(want[1][1]) == 2                        # the non-ASCII document chunks too
    table = t_etl.chunk_lists_to_table(want[1])
    frame = j_etl.chunk_lists_to_frame(want[1], pd.RangeIndex(len(texts)))
    assert list(table) == list(frame.columns)
    for k in table:
        assert [None if isinstance(v, float) else v for v in frame[k]] == table[k].tolist()
