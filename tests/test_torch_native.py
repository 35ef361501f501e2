"""The port's ctypes binding of the native ETL scanners
(``fairmultimodal_torch/data/native.py``) against the JAX binding on the
same files: quoted fields, a multi-stay admission, no itemid filter, a
missing file, and the notes fuzz of ``tests/test_native.py``.  The port
builds its own libraries under ``build/native/<hash>/`` and leaves the
tracked ``native/lib/*.so`` byte for byte as they were.
"""

import hashlib
import pathlib

import numpy as np
import pytest

from fairmultimodal_tpu.data import native as j_native
from fairmultimodal_torch.data import native as t_native
from tests.test_native import _python_clean_chunk, _write_events

REPO = pathlib.Path(__file__).resolve().parent.parent
BASE = np.datetime64("2150-01-01T00:00:00", "s")


def _stays(offsets_hours):
    """(subject, hadm, intime) triples and the epoch-second arrays."""
    import pandas as pd

    stays = [(s, h, pd.Timestamp(BASE) + pd.Timedelta(hours=o)) for s, h, o in offsets_hours]
    arrays = (np.array([s for s, _, _ in stays], np.int64), np.array([h for _, h, _ in stays],
                                                                       np.int64),
              np.array([(BASE + np.timedelta64(int(o * 3600), "s")).astype(np.int64)
                        for _, _, o in offsets_hours], np.float64))
    return stays, arrays


def _both(path, arrays, itemids, agg):
    want = j_native.aggregate_events_native(str(path), *arrays, itemids, agg=agg)
    got = t_native.aggregate_events_native(str(path), *arrays, itemids, agg=agg)
    for g, w in zip(got[:5], want[:5]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[5] == want[5] and got[5] > 0
    return got


@pytest.mark.parametrize("agg", ["mean", "sum"])
@pytest.mark.parametrize("quoted", [False, True])
def test_aggregate_matches_jax_binding(tmp_path, agg, quoted):
    rng = np.random.default_rng(3 if quoted else 4)
    stays, arrays = _stays([(1000 + i, 5000 + i, 24 * int(rng.integers(0, 50)))
                            for i in range(12)])
    path = tmp_path / "events.csv.gz"
    _write_events(str(path), rng, stays, quoted=quoted)
    got = _both(path, arrays, np.array([100, 200, 300], np.int64), agg)
    assert set(got[3].tolist()) <= {100, 200, 300}


@pytest.mark.parametrize("agg", ["mean", "sum"])
def test_multi_stay_admission_and_no_filter(tmp_path, agg):
    rng = np.random.default_rng(7)
    stays, arrays = _stays([(1, 10, 0), (1, 10, 6), (1, 10, 30), (2, 20, 48), (3, 30, 120)])
    path = tmp_path / "multi.csv.gz"
    _write_events(str(path), rng, stays, n_rows=400)
    got = _both(path, arrays, np.array([100, 200, 300, 400], np.int64), agg)
    assert len(np.unique(got[2][got[0] == 1])) > 1       # subject 1's three stays' bins
    got = _both(path, arrays, None, agg)
    assert 400 in set(got[3].tolist())


def test_missing_file_raises():
    with pytest.raises(RuntimeError, match="cannot open"):
        t_native.aggregate_events_native("/nonexistent/file.csv.gz", np.zeros(1, np.int64),
                                         np.zeros(1, np.int64), np.zeros(1))


def test_notes_fuzz_matches_the_python_chain():
    rng = np.random.default_rng(20260818)
    alphabet = list("abcdefghij XYZ.0123456789[]-_=\t\n\r:\x0b\x0c\x1c\x1d\x1e\x1f") + [
        "dr.", "m.d.", "admission date:", "discharge date:", "--", "__", "==",
        "[**2112-1-2**]", " 42. ", "é"]
    docs = ["".join(rng.choice(alphabet) for _ in range(int(rng.integers(0, 120))))
            for _ in range(200)]
    docs += [" ".join(f"tok{i}. [x{i}]" for i in range(3000)), "dr. " * 2000, None]
    cleaned, chunks = t_native.clean_and_chunk_native(docs, chunk_size=512)
    for t, c, ch in zip(docs, cleaned, chunks):
        assert (c, ch) == _python_clean_chunk(t, 512), repr(str(t)[:80])
    assert (cleaned, chunks) == j_native.clean_and_chunk_native(docs, chunk_size=512)


def test_tracked_libraries_unchanged_and_built_under_build():
    libs = sorted((REPO / "native" / "lib").glob("*.so"))
    before = {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in libs}
    assert set(before) == {"libfastetl.so", "libfastnotes.so"}
    paths = [t_native.library_path(name) for name in ("fastetl", "fastnotes")]
    assert t_native.available() and t_native.notes_available()
    for p in paths:
        assert pathlib.Path(p).parent.parent == REPO / "build" / "native"
    assert {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in libs} == before
