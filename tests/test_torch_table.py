"""The port's cohort tables against the JAX package's DataFrames (CPU).

- ``data/synthetic.py::make_common_frames`` gives the JAX function's
  tables: names, order, dtype kinds and values exactly, for several seeds
  and sizes and for one note chunk; its DataFrame form too.
- ``assemble_features`` on port tables gives the JAX ``assemble_features``
  bundle exactly: synthetic cohorts, a duplicate merge key, a missing
  ``ETHNICITY`` column, missing lab cells, notes that read ``NA``, rows only
  one table holds, ``Age`` for ``age``, a missing ``GENDER`` cell.
- A CSV round trip through ``write_csv_table`` and ``read_csv_table`` gives
  the bundle that ``pd.read_csv`` plus the JAX ``assemble_features`` give
  from the same files; the reader types columns as ``pd.read_csv`` does and
  keeps every float exactly, as pandas' ``float_precision="round_trip"``
  does (its default parser is not correctly rounded, by about 1e-13
  relative, which the float32 features do not see).
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest

from fairmultimodal_torch.data import featurize as t_feat
from fairmultimodal_torch.data import synthetic as t_syn
from fairmultimodal_torch.data import table as t_table
from fairmultimodal_tpu.data import featurize as j_feat
from fairmultimodal_tpu.data import synthetic as j_syn


def _assert_tables_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert a.tolist() == b.tolist() or np.array_equal(a, b, equal_nan=True), k


def _assert_bundles_equal(got, want):
    for f in dataclasses.fields(t_feat.FeatureBundle):
        if f.name == "text_embeddings":
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("n,labs,chunks,seed", [(64, 32, 3, 42), (240, 8, 3, 0), (50, 5, 1, 7),
                                                (300, 549, 3, 43)])
def test_make_common_frames_equals_jax(n, labs, chunks, seed):
    want = j_syn.make_common_frames(n, labs, chunks, seed)
    got = t_syn.make_common_frames(n, labs, chunks, seed)
    for g, w in zip(got, want):
        _assert_tables_equal(g, t_table.table_from_frame(w))
        assert [g[k].dtype.kind for k in g] == [
            "O" if not pd.api.types.is_numeric_dtype(w[k]) else w[k].dtype.kind for k in w]
    for g, w in zip(t_syn.make_common_frames(n, labs, chunks, seed, frames=True), want):
        assert list(g.columns) == list(w.columns)
        _assert_tables_equal(t_table.table_from_frame(g), t_table.table_from_frame(w))


def _edge_frames():
    s, u = j_syn.make_common_frames(120, 6, 3, 5)
    s = s.rename(columns={"age": "Age"}).drop(columns=["ETHNICITY"])
    s.loc[[3, 9], "lab_t50801"] = np.nan
    s.loc[4, "GENDER"] = np.nan
    s = pd.concat([s, s.iloc[[7, 20]]], ignore_index=True)          # duplicate left keys
    u = u.copy()
    u.loc[[2, 5], "note_chunk_1"] = "NA"
    u = pd.concat([u, u.iloc[[7]],                                      # a duplicate right key
                   pd.DataFrame({"subject_id": [1], "hadm_id": [2],
                                 "note_chunk_1": ["only here"]})], ignore_index=True)
    return s.iloc[2:], u.iloc[::-1]                                     # rows one table lacks


def test_assemble_features_on_tables_equals_jax():
    for s, u in (j_syn.make_common_frames(200, 12, 3, 3), _edge_frames()):
        want = j_feat.assemble_features(s, u)
        got = t_feat.assemble_features(t_table.table_from_frame(s), t_table.table_from_frame(u))
        _assert_bundles_equal(got, want)
        _assert_bundles_equal(t_feat.assemble_features(s, u), want)    # the DataFrame front
    ts, tu = t_syn.make_common_frames(150, 9, 3, 11)
    _assert_bundles_equal(t_feat.assemble_features(ts, tu),
                          j_feat.assemble_features(*j_syn.make_common_frames(150, 9, 3, 11)))


def test_assemble_features_merge_order_and_suffixes():
    s = {"subject_id": np.array([1, 2, 1, 3]), "hadm_id": np.array([5, 6, 5, 7]),
         "x": np.array([10.0, 20.0, 30.0, 40.0]), "short_term_mortality": np.array([0, 1, 0, 1]),
         "los_binary": np.array([1, 1, 0, 0]), "mechanical_ventilation": np.array([0, 0, 1, 1])}
    u = {"subject_id": np.array([2, 1, 1]), "hadm_id": np.array([6, 5, 5]),
         "x": np.array([7.0, 8.0, 9.0]),
         "note_chunk_1": np.array(["a", "b", "c"], dtype=object)}
    merged = t_feat._inner_merge(s, u, ("subject_id", "hadm_id"), ("_struct", "_unstruct"))
    want = pd.merge(pd.DataFrame(s), pd.DataFrame(u), on=["subject_id", "hadm_id"],
                    how="inner", suffixes=("_struct", "_unstruct"))
    _assert_tables_equal(merged, t_table.table_from_frame(want))
    _assert_bundles_equal(t_feat.assemble_features(s, u),
                          j_feat.assemble_features(pd.DataFrame(s), pd.DataFrame(u)))


def test_csv_round_trip_gives_the_jax_bundle(tmp_path):
    s, u = t_syn.make_common_frames(300, 24, 3, 9)
    s["flag"] = np.arange(300) % 3 == 0                                 # a bool column
    s["lab_t50801"] = np.where(np.arange(300) % 17 == 0, np.nan, s["lab_t50801"])
    paths = [str(tmp_path / f"final_{k}_common.csv") for k in ("structured", "unstructured")]
    for p, t in zip(paths, (s, u)):
        t_table.write_csv_table(p, t)
    got = [t_table.read_csv_table(p) for p in paths]
    frames = [pd.read_csv(p) for p in paths]
    for g, p, orig in zip(got, paths, (s, u)):
        # pandas' correctly rounded parser gives the same table; its default
        # one is not correctly rounded (1e-13 relative here).
        want = t_table.table_from_frame(pd.read_csv(p, float_precision="round_trip"))
        _assert_tables_equal(g, want)
        assert list(g) == list(orig)
        for k in g:
            if g[k].dtype.kind == "f":
                np.testing.assert_array_equal(g[k], np.asarray(orig[k], np.float64))
    _assert_bundles_equal(t_feat.assemble_features(*got), j_feat.assemble_features(*frames))
    _assert_bundles_equal(t_feat.assemble_features(*got), t_feat.assemble_features(s, u))


def test_read_csv_table_types_like_pandas(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("i,f,b,t,na,mixed,empty,blank\n"
                    "1,1.5,True,x,NA,1,,\n"
                    " 2 ,-inf,false,\"a, b\",,x,,\n"
                    "3,NaN,TRUE,N/A,null,2.5,,\n"
                    "\n")
    got = t_table.read_csv_table(str(path))
    want = t_table.table_from_frame(pd.read_csv(path))
    assert list(got) == list(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tolist() == want[k].tolist() or np.array_equal(
            got[k], want[k], equal_nan=True), k
    assert got["t"].tolist() == ["x", "a, b", None]
    assert len(t_table.MISSING_VALUES) == 19


def test_head_takes_the_first_rows_of_each_table():
    s, u = t_syn.make_common_frames(40, 4, 2, 1)
    js, ju = j_syn.make_common_frames(40, 4, 2, 1)
    _assert_bundles_equal(t_feat.assemble_features(t_table.head(s, 25), t_table.head(u, 30)),
                          j_feat.assemble_features(js.head(25), ju.head(30)))
