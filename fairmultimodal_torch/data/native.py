"""ctypes bindings of the native ETL scanners (port of ``fairmultimodal_tpu/data/native.py``).

:func:`aggregate_events_native` streams a MIMIC event ``csv.gz`` through
``native/fastetl/fastetl.cc`` and returns the (subject, hadm, bin, itemid)
-> value aggregation as numpy arrays, sorted by those keys.
:func:`clean_and_chunk_native` runs the note clean-up and 512-token
chunking through ``native/fastnotes/fastnotes.cc``; a non-ASCII document
goes through the Python functions of :mod:`fairmultimodal_torch.data.etl`
instead, so the result never depends on the route.

The libraries are built from those sources at first use with ``g++ -O3
-fPIC -std=c++17 -shared`` (``-lz`` for fastetl; no ``-march=native``, so a
checkout copied to another machine loads what it built) into
``build/native/<hash of the source, flags and machine>/``; a build writes a
temporary file and renames it, so concurrent processes may build at once.
``native/lib/`` is never written.  :func:`available` /
:func:`notes_available` say whether a library could be built and loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["build", "available", "notes_available", "library_path",
           "aggregate_events_native", "clean_and_chunk_native"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]
_SOURCES = {"fastetl": ("native/fastetl/fastetl.cc", ["-lz"]),
            "fastnotes": ("native/fastnotes/fastnotes.cc", [])}
_loaded: dict = {}


def library_path(name: str) -> str:
    """Build ``lib<name>.so`` from its source unless this source with these
    flags was built on this machine before; returns its path.  Raises when
    ``g++`` fails."""
    source, libs = _SOURCES[name]
    src = os.path.join(_REPO_ROOT, source)
    with open(src, "rb") as f:
        key = f.read() + " ".join(_FLAGS + libs + list(os.uname())).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    out_dir = os.path.join(_REPO_ROOT, "build", "native", digest)
    out = os.path.join(out_dir, f"lib{name}.so")
    if not os.path.exists(out):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run(["g++", *_FLAGS, "-o", tmp, src, *libs], check=True,
                       capture_output=True, timeout=600)
        os.replace(tmp, out)
    return out


def _load(name: str, declare) -> Optional[ctypes.CDLL]:
    """The library, built and declared once per process; None when it
    cannot be built or loaded."""
    if name not in _loaded:
        try:
            lib = ctypes.CDLL(library_path(name))
        except (OSError, subprocess.SubprocessError):
            lib = None
        if lib is not None:
            declare(lib)
        _loaded[name] = lib
    return _loaded[name]


def _declare_etl(lib: ctypes.CDLL) -> None:
    i64p, f64p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)
    lib.fastetl_aggregate.restype = ctypes.c_void_p
    lib.fastetl_aggregate.argtypes = [
        ctypes.c_char_p, i64p, i64p, f64p, ctypes.c_int64, i64p, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    for fn in (lib.fastetl_size, lib.fastetl_rows_scanned):
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.fastetl_fill.restype = None
    lib.fastetl_fill.argtypes = [ctypes.c_void_p, i64p, i64p, ctypes.POINTER(ctypes.c_int32),
                                 i64p, f64p]
    lib.fastetl_free.restype = None
    lib.fastetl_free.argtypes = [ctypes.c_void_p]


def _declare_notes(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.fastnotes_clean.restype = ctypes.c_void_p
    lib.fastnotes_clean.argtypes = [ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_int32,
                                    ctypes.c_char_p, ctypes.c_int]
    for fn in (lib.fastnotes_buf_size, lib.fastnotes_n_chunks, lib.fastnotes_clean_buf_size):
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.fastnotes_fill.restype = None
    lib.fastnotes_fill.argtypes = [ctypes.c_void_p, ctypes.c_char_p, i64p,
                                   ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, i64p]
    lib.fastnotes_free.restype = None
    lib.fastnotes_free.argtypes = [ctypes.c_void_p]


def build(quiet: bool = True) -> bool:
    """Compile the native libraries (idempotent); returns success.  With
    ``quiet=False`` a failed ``g++`` prints its error."""
    try:
        for name in _SOURCES:
            library_path(name)
    except (OSError, subprocess.SubprocessError) as e:
        if not quiet:
            print(getattr(e, "stderr", None) or e)
        return False
    return True


def available() -> bool:
    return _load("fastetl", _declare_etl) is not None


def notes_available() -> bool:
    return _load("fastnotes", _declare_notes) is not None


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def clean_and_chunk_native(texts: List[str],
                           chunk_size: int = 512) -> Tuple[List[str], List[List[str]]]:
    """Cleaned text and ``chunk_size``-token chunks per document, as
    ``data/etl.py::clean_and_chunk_texts``' Python chain gives them."""
    lib = _load("fastnotes", _declare_notes)
    if lib is None:
        raise RuntimeError("native fastnotes library unavailable (build failed)")
    from fairmultimodal_torch.data.etl import clean_note_text, split_text_to_chunks

    cleaned: List[Optional[str]] = [None] * len(texts)
    chunks: List[Optional[List[str]]] = [None] * len(texts)
    native_idx, enc = [], []
    for i, t in enumerate(texts):
        t = "" if t is None else str(t)
        if t.isascii():
            native_idx.append(i)
            enc.append(t.encode("ascii"))
        else:
            y = clean_note_text(t.replace("\n", " ").replace("\r", " ").strip().lower())
            cleaned[i], chunks[i] = y, split_text_to_chunks(y, chunk_size)
    if native_idx:
        offsets = np.zeros(len(enc) + 1, np.int64)
        np.cumsum([len(b) for b in enc], out=offsets[1:])
        err = ctypes.create_string_buffer(256)
        handle = lib.fastnotes_clean(b"".join(enc), _ptr(offsets, ctypes.c_int64), len(enc),
                                     chunk_size, err, len(err))
        if not handle:
            raise RuntimeError(f"fastnotes: {err.value.decode() or 'unknown error'}")
        try:
            out_buf = ctypes.create_string_buffer(max(lib.fastnotes_buf_size(handle), 1))
            clean_buf = ctypes.create_string_buffer(max(lib.fastnotes_clean_buf_size(handle), 1))
            chunk_off = np.empty(lib.fastnotes_n_chunks(handle) + 1, np.int64)
            doc_counts = np.empty(len(enc), np.int32)
            doc_off = np.empty(len(enc) + 1, np.int64)
            lib.fastnotes_fill(handle, out_buf, _ptr(chunk_off, ctypes.c_int64),
                               _ptr(doc_counts, ctypes.c_int32), clean_buf,
                               _ptr(doc_off, ctypes.c_int64))
        finally:
            lib.fastnotes_free(handle)
        raw_chunks, raw_clean, c = out_buf.raw, clean_buf.raw, 0
        for d, i in enumerate(native_idx):
            cleaned[i] = raw_clean[doc_off[d]:doc_off[d + 1]].decode("ascii")
            k = int(doc_counts[d])
            chunks[i] = [raw_chunks[chunk_off[c + j]:chunk_off[c + j + 1]].decode("ascii")
                         for j in range(k)]
            c += k
    return cleaned, chunks  # type: ignore[return-value]


def aggregate_events_native(
    path: str,
    stay_subject: np.ndarray,
    stay_hadm: np.ndarray,
    stay_intime_epoch: np.ndarray,
    itemids: Optional[np.ndarray] = None,
    window_hours: float = 24.0,
    bin_hours: float = 2.0,
    agg: str = "mean",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Stream-aggregate one event table: (subject_id, hadm_id, hour_bin,
    itemid, value, rows_scanned), one row per (subject, hadm, bin, itemid)
    group in key order; ``rows_scanned`` counts the data lines read."""
    lib = _load("fastetl", _declare_etl)
    if lib is None:
        raise RuntimeError("native fastetl library unavailable (build failed)")
    subj = np.ascontiguousarray(stay_subject, np.int64)
    hadm = np.ascontiguousarray(stay_hadm, np.int64)
    intime = np.ascontiguousarray(stay_intime_epoch, np.float64)
    items = np.ascontiguousarray(itemids if itemids is not None else np.zeros(0), np.int64)
    err = ctypes.create_string_buffer(512)
    handle = lib.fastetl_aggregate(
        path.encode(), _ptr(subj, ctypes.c_int64), _ptr(hadm, ctypes.c_int64),
        _ptr(intime, ctypes.c_double), len(subj), _ptr(items, ctypes.c_int64), len(items),
        float(window_hours), float(bin_hours), 1 if agg == "sum" else 0, err, len(err))
    if not handle:
        raise RuntimeError(f"fastetl: {err.value.decode() or 'unknown error'}")
    try:
        n = lib.fastetl_size(handle)
        rows_scanned = int(lib.fastetl_rows_scanned(handle))
        out = [np.empty(n, np.int64), np.empty(n, np.int64), np.empty(n, np.int32),
               np.empty(n, np.int64), np.empty(n, np.float64)]
        if n:
            lib.fastetl_fill(handle, _ptr(out[0], ctypes.c_int64), _ptr(out[1], ctypes.c_int64),
                             _ptr(out[2], ctypes.c_int32), _ptr(out[3], ctypes.c_int64),
                             _ptr(out[4], ctypes.c_double))
    finally:
        lib.fastetl_free(handle)
    order = np.lexsort((out[3], out[2], out[1], out[0]))
    return (*(a[order] for a in out), rows_scanned)
