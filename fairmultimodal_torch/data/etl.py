"""MIMIC-III ETL: cohort construction and feature tables (port of
``fairmultimodal_tpu/data/etl.py``), without pandas.

The same five CSVs from the same raw ``csv.gz`` tables:

- ``final_structured_dataset.csv``                       (base cohort)
- ``final_structured_with_feature_set_C_24h_2h_bins.csv`` (wide features)
- ``unstructured_with_demographics.csv``                 (notes + chunks)
- ``final_structured_common.csv`` / ``final_unstructured_common.csv``

Tables are port tables (:mod:`fairmultimodal_torch.data.table`), read by
:func:`~fairmultimodal_torch.data.table.read_raw_table`, which drops rows
by cohort and itemid while it reads.  The host does the string work and the
file reading: the ventilation flags' itemid / ``VALUE`` rules, note
cleaning and chunking (``native/fastnotes`` when it is used), ages by
calendar fields, and the two first-stay sorts.  ``device`` (CUDA unless the
caller asks for the CPU) does the numeric relational core in float64:
group-by keys compacted and sorted there, then every group-by reduction
(the flags' max, the lab-bin and feature-set-C mean or sum, the sum across
the two ``inputevents`` files on the native path), the pivot to wide
``<table>_t<itemid>`` columns, the per-stay collapse and the final
per-subject mean / first.  Each reduction runs over key-sorted segments in
a fixed order (``torch.segment_reduce``; no atomics), so two runs write the
same bytes.

pandas' semantics are kept where they decide a cell: merges keep the left
order with the right's matches in the right's order and match a missing key
to a missing key; group-bys drop a missing key and give groups in sorted key
order; mean and sum skip NaN (an all-NaN group: mean NaN, sum 0.0); ``first``
takes each column's first present value; a left merge that leaves a row
unmatched turns an int column into float64.  The first-stay step
(``sort_values(by="INTIME").groupby("subject_id").first()``) runs after the
lab-bin merge, which repeats each stay once per 2-hour bin with one
``INTIME``: which bin's lab value survives depends on the tie order of
pandas' unstable sort, which is numpy's quicksort of the ``datetime64``
column (NaT last), so that is what sorts here.  The ventilation dedup keeps
the CHARTEVENTS row of an (icustay, charttime) key over the
PROCEDUREEVENTS_MV one, with ``charttime`` compared as the raw text.

One departure: the ``--timing`` lines and ``stats["timings"]`` call the
non-native path ``plain`` where the JAX package says ``pandas``.
``use_native=None`` takes the C++ scanners when they build and load and the
plain path otherwise; an error inside a scanner is raised, never swallowed.
"""

from __future__ import annotations

import errno
import math
import os
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fairmultimodal_torch.data.table import (Table, num_rows, read_csv_table, read_header,
                                             read_raw_table, take_rows, text_array,
                                             to_datetime, to_numeric, write_csv_table)
from fairmultimodal_torch.data.validate import count_unmapped, validate_mimic_dir
from fairmultimodal_torch.ops.gates import resolve_device

__all__ = ["run_etl", "FEATURE_SET_C", "split_text_to_chunks", "clean_note_text",
           "clean_and_chunk_texts", "chunk_lists_to_table", "chunk_lists_to_frame"]

# --- Constant tables (data, reproduced from 00_data.py:64-78,346-352) -------

VENT_ITEMIDS = [
    720, 223848, 223849, 467,
    445, 448, 449, 450, 1340, 1486, 1600, 224687,
    639, 654, 681, 682, 683, 684, 224685, 224684, 224686,
    218, 436, 535, 444, 224697, 224695, 224696, 224746, 224747,
    221, 1, 1211, 1655, 2000, 226873, 224738, 224419, 224750, 227187,
    543, 5865, 5866, 224707, 224709, 224705, 224706,
    60, 437, 505, 506, 686, 220339, 224700,
    3459,
    501, 502, 503, 224702,
    223, 667, 668, 669, 670, 671, 672,
    224701,
    468, 469, 470, 471, 227287, 226732, 223834,
]

# itemids that imply mechanical ventilation unconditionally (00_data.py:98-106).
_MECHVENT_ALWAYS = {
    445, 448, 449, 450, 1340, 1486, 1600, 224687,
    639, 654, 681, 682, 683, 684, 224685, 224684, 224686,
    218, 436, 535, 444, 224697, 224695, 224696, 224746, 224747,
    221, 1, 1211, 1655, 2000, 226873, 224738, 224419, 224750, 227187,
    543, 5865, 5866, 224707, 224709, 224705, 224706,
    60, 437, 505, 506, 686, 220339, 224700,
    3459, 501, 502, 503, 224702,
    223, 667, 668, 669, 670, 671, 672, 224701,
}

_O2_DEVICES_MV = [
    "Nasal cannula", "Face tent", "Aerosol-cool", "Trach mask ",
    "High flow neb", "Non-rebreather", "Venti mask ", "Medium conc mask ",
    "T-piece", "High flow nasal cannula", "Ultrasonic neb", "Vapomist",
]
_O2_DEVICES_CV = [
    "Cannula", "Nasal Cannula", "Face Tent", "Aerosol-Cool", "Trach Mask",
    "Hi Flow Neb", "Non-Rebreather", "Venti Mask", "Medium Conc Mask",
    "Vapotherm", "T-Piece", "Hood", "Hut", "TranstrachealCat",
    "Heated Neb", "Ultrasonic Neb",
]

FEATURE_SET_C: Dict[str, list] = {
    "chartevents": [220051, 220052, 618, 220210, 224641, 220292, 535, 224695,
                    506, 220339, 448, 224687, 224685, 220293, 444, 224697,
                    220074, 224688, 223834, 50815, 225664, 220059, 683, 224684,
                    220060, 226253, 224161, 642, 225185, 226758, 226757, 226756,
                    220050, 211, 220045, 223761, 223835, 226873, 226871, 8364,
                    8555, 8368, 53, 646, 1529, 50809, 50931, 51478, 224639,
                    763, 224639, 226707],
    "labevents": [51221, 51480, 51265, 50811, 51222, 51249, 51248, 51250,
                  51279, 51277, 50902, 50868, 50912, 50809, 50931, 51478,
                  50960, 50893, 50970, 51237, 51274, 51275, 51375, 51427,
                  51446, 51116, 51244, 51355, 51379, 51120, 51254, 51256,
                  51367, 51387, 51442, 51112, 51146, 51345, 51347, 51368,
                  51419, 51444, 51114, 51200, 51474, 50820, 50831, 51094,
                  51491, 50802, 50804, 50818, 51498, 50813, 50861, 50878,
                  50863, 50862, 490, 1165, 50902, 50819],
    "inputevents": [30008, 220864, 30005, 220970, 221385, 30023, 221456,
                    221668, 221749, 221794, 221828, 221906, 30027, 222011,
                    222056, 223258, 30126, 225154, 30297, 225166, 225168,
                    30144, 225799, 225823, 44367, 225828, 225943, 30065,
                    225944, 226089, 226364, 30056, 226452, 30059, 226453,
                    227522, 227523, 30044, 221289, 30051, 222315, 30043,
                    221662, 30124, 30118, 221744, 30131, 222168],
    "outputevents": [226573, 40054, 40085, 44890, 43703, 226580, 226588,
                     226589, 226599, 226626, 226633, 227510],
    "prescriptions": ["Docusate Sodium", "Aspirin", "Bisacodyl",
                      "Humulin-R Insulin", "Metoprolol",
                      "Pantoprazole Sodium", "Pantoprazole"],
}

INPUT_FILES = {
    "chartevents": "CHARTEVENTS.csv.gz",
    "labevents": "LABEVENTS.csv.gz",
    "inputevents": ["inputevents_cv.csv.gz", "inputevents_mv.csv.gz"],
    "outputevents": "OUTPUTEVENTS.csv.gz",
    "prescriptions": "PRESCRIPTIONS.csv.gz",
}

_TIME_COLUMNS = ["charttime", "starttime", "storetime", "eventtime", "endtime"]
_VALUE_COLUMNS = ["value", "amount", "valuenum"]
_KEYS = ["subject_id", "hadm_id"]
_NS_PER_DAY = 86400 * 10 ** 9


# --- Demographic categorizers (00_data.py:7-46) ------------------------------

def calculate_age(dob: np.ndarray, intime: np.ndarray) -> np.ndarray:
    """``intime.year - dob.year - ((intime.month, intime.day) < (dob.month,
    dob.day))`` per row of two ``datetime64`` arrays: int64, or float64 with
    NaN where either time is NaT (as the JAX ``apply`` gives it)."""
    def fields(t):
        months = t.astype("datetime64[M]")
        return (t.astype("datetime64[Y]").astype(np.int64) + 1970,
                months.astype(np.int64) % 12 + 1,
                (t.astype("datetime64[D]") - months.astype("datetime64[D]")).astype(np.int64) + 1)

    (yi, mi, di), (yd, md, dd) = fields(intime), fields(dob)
    age = yi - yd - ((mi < md) | ((mi == md) & (di < dd)))
    missing = np.isnat(dob) | np.isnat(intime)
    return np.where(missing, math.nan, age) if missing.any() else age


def categorize_age(age) -> str:
    if 15 <= age <= 29:
        return "15-29"
    elif 30 <= age <= 49:
        return "30-49"
    elif 50 <= age <= 69:
        return "50-69"
    elif 70 <= age <= 89:
        return "70-89"
    return "Other"


def categorize_ethnicity(ethnicity) -> str:
    eth = str(ethnicity).upper()
    if eth in ("WHITE", "WHITE - RUSSIAN", "WHITE - OTHER EUROPEAN",
               "WHITE - BRAZILIAN", "WHITE - EASTERN EUROPEAN"):
        return "White"
    if eth in ("BLACK/AFRICAN AMERICAN", "BLACK/CAPE VERDEAN", "BLACK/HAITIAN",
               "BLACK/AFRICAN", "CARIBBEAN ISLAND"):
        return "Black"
    if eth in ("HISPANIC OR LATINO", "HISPANIC/LATINO - PUERTO RICAN",
               "HISPANIC/LATINO - DOMINICAN", "HISPANIC/LATINO - MEXICAN"):
        return "Hispanic"
    if eth in ("ASIAN", "ASIAN - CHINESE", "ASIAN - INDIAN"):
        return "Asian"
    return "Other"


def categorize_insurance(insurance) -> str:
    ins = str(insurance).upper()
    if "MEDICARE" in ins:
        return "Medicare"
    if "PRIVATE" in ins:
        return "Private"
    if "MEDICAID" in ins:
        return "Medicaid"
    if "SELF PAY" in ins:
        return "Self Pay"
    return "Government"


# --- Note cleaning (00_data.py:395-439) --------------------------------------

def clean_note_text(x: str) -> str:
    """Regex cleanup applied to lowercased note text (00_data.py:395-406)."""
    y = re.sub(r"\[(.*?)\]", "", x)
    y = re.sub(r"[0-9]+\.", "", y)
    y = re.sub(r"dr\.", "doctor", y)
    y = re.sub(r"m\.d\.", "md", y)
    y = re.sub(r"admission date:", "", y)
    y = re.sub(r"discharge date:", "", y)
    y = re.sub(r"--|__|==", "", y)
    return y


def split_text_to_chunks(text: str, chunk_size: int = 512) -> List[str]:
    """Whitespace-token chunking (00_data.py:422-429)."""
    tokens = text.split()
    return [" ".join(tokens[i:i + chunk_size]) for i in range(0, len(tokens), chunk_size)]


# --- Table operations with pandas' semantics ----------------------------------------

def _isna(col: np.ndarray) -> np.ndarray:
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype.kind == "M":
        return np.isnat(col)
    if col.dtype.kind == "O":
        return np.array([v is None or (isinstance(v, float) and math.isnan(v))
                         for v in col.tolist()], bool)
    return np.zeros(len(col), bool)


def _take(col: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``col[idx]`` where -1 is a missing cell: NaN (an int column becomes
    float64, as pandas makes it), NaT, or None (a bool column becomes text)."""
    miss = idx < 0
    if not miss.any():
        return col[idx]
    kind = col.dtype.kind
    src = col if len(col) else np.zeros(1, col.dtype)
    out = src[np.where(miss, 0, idx)]
    if kind in "iuf":
        out = out.astype(np.float64)
        out[miss] = math.nan
    elif kind == "M":
        out[miss] = np.datetime64("NaT")
    else:
        out = out.astype(object)
        out[miss] = None
    return out


def _rename(table: Table, names: Dict[str, str]) -> Table:
    return {names.get(k, k): v for k, v in table.items()}


def _lower(table: Table) -> Table:
    return {k.lower(): v for k, v in table.items()}


def _key_codes(cols: Sequence[np.ndarray]) -> List[np.ndarray]:
    """int64 codes per column, equal exactly where the values are (a
    missing value equals a missing value, an int equals the same float)."""
    codes = []
    for col in cols:
        if col.dtype.kind in "iufbM":
            v = (col.astype("datetime64[ns]").astype(np.int64) if col.dtype.kind == "M"
                 else col.astype(np.float64))
            codes.append(np.unique(v, return_inverse=True)[1].astype(np.int64).ravel())
        else:
            seen: Dict = {}
            codes.append(np.array([seen.setdefault(None if v is None or v != v else v, len(seen))
                                   for v in col.tolist()], np.int64))
    return codes


def _joint_code(codes: List[np.ndarray]) -> np.ndarray:
    if len(codes) == 1:
        return codes[0]
    return np.unique(np.stack(codes, 1), axis=0, return_inverse=True)[1].ravel()


def _merge(left: Table, right: Table, on: Sequence[str], how: str) -> Table:
    """``left.merge(right, on=on, how=how)`` for ``how`` in {"left",
    "inner"}: left rows in order, each with its matches in right order."""
    nl = num_rows(left)
    both = _key_codes([np.concatenate([_as_key(left[k]), _as_key(right[k])]) for k in on])
    code = _joint_code(both)
    lcode, rcode = code[:nl], code[nl:]
    order = np.argsort(rcode, kind="stable")
    rs = rcode[order]
    lo, hi = np.searchsorted(rs, lcode, "left"), np.searchsorted(rs, lcode, "right")
    count = hi - lo
    reps = count if how == "inner" else np.maximum(count, 1)
    li = np.repeat(np.arange(nl), reps)
    within = np.arange(len(li)) - np.repeat(np.cumsum(reps) - reps, reps)
    hit = np.flatnonzero(np.repeat(count, reps) > 0)
    ri = np.full(len(li), -1)
    ri[hit] = order[np.repeat(lo, reps)[hit] + within[hit]]
    out = {k: v[li] for k, v in left.items()}
    for k, v in right.items():
        if k in on:
            continue
        if k in out:
            raise ValueError(f"merge: column {k!r} on both sides")
        out[k] = _take(v, ri)
    return out


def _as_key(col: np.ndarray) -> np.ndarray:
    return col.astype(object) if col.dtype.kind == "O" else col


def _drop_duplicates(table: Table, subset: Sequence[str]) -> Table:
    code = _joint_code(_key_codes([table[k] for k in subset]))
    _, first = np.unique(code, return_index=True)
    return take_rows(table, np.sort(first))


def _concat(tables: Sequence[Table]) -> Table:
    """``pd.concat(tables, ignore_index=True)``: the union of the columns in
    order of appearance, a column a table lacks missing in its rows."""
    names: List[str] = []
    for t in tables:
        names += [k for k in t if k not in names]
    out = {}
    for k in names:
        parts = [t[k] if k in t else _take(np.zeros(0, np.float64), -np.ones(num_rows(t), int))
                 for t in tables]
        kinds = {p.dtype.kind for p in parts if len(p)}
        if kinds <= set("iu"):
            out[k] = np.concatenate(parts)
        elif kinds <= set("iuf"):
            out[k] = np.concatenate([p.astype(np.float64) for p in parts])
        elif kinds == {"M"}:
            out[k] = np.concatenate(parts)
        else:
            out[k] = np.concatenate([_missing_as_none(p) for p in parts])
    return out


def _missing_as_none(col: np.ndarray) -> np.ndarray:
    out = col.astype(object)
    out[_isna(col)] = None
    return out


def _nargsort(times: np.ndarray) -> np.ndarray:
    """``sort_values`` of a time column: numpy's quicksort of the
    ``datetime64`` values that are present (not an int64 view: numpy sorts
    int64 with another algorithm whose ties land elsewhere), NaT rows last
    in their order."""
    nat = np.isnat(times)
    idx = np.arange(len(times))
    return np.concatenate([idx[~nat][np.argsort(times[~nat], kind="quicksort")], idx[nat]])


def _seconds(later: np.ndarray, earlier: np.ndarray) -> np.ndarray:
    """``(later - earlier).dt.total_seconds()``: NaN where either is NaT."""
    diff = (later.astype("datetime64[ns]") - earlier.astype("datetime64[ns]"))
    out = diff.astype(np.int64).astype(np.float64) / 1e9
    out[np.isnat(diff)] = math.nan
    return out


def _days(later: np.ndarray, earlier: np.ndarray) -> np.ndarray:
    """``(later - earlier).dt.days`` (floored) as float64, NaN where NaT."""
    diff = later.astype("datetime64[ns]") - earlier.astype("datetime64[ns]")
    out = np.floor_divide(diff.astype(np.int64), _NS_PER_DAY).astype(np.float64)
    out[np.isnat(diff)] = math.nan
    return out


# --- Group-by on the device -----------------------------------------------------------

def _compact(values: torch.Tensor) -> torch.Tensor:
    """Each value's rank among the distinct values (``np.unique``'s
    inverse), by one stable sort."""
    order = torch.sort(values, stable=True).indices
    ranked = values[order]
    step = torch.zeros(len(values), dtype=torch.int64, device=values.device)
    step[1:] = (ranked[1:] != ranked[:-1]).long()
    codes = torch.empty_like(step)
    codes[order] = torch.cumsum(step, 0)
    return codes


class _Groups:
    """Rows grouped by key columns on ``device``, as ``DataFrame.groupby``
    groups them: a row with a missing key is left out, groups come in sorted
    key order and rows keep their order inside a group.  Keys are compacted
    to int64 codes (:func:`_compact` for numbers, the host for text) and
    sorted by stable sorts from the last key to the first."""

    def __init__(self, keys: Sequence[np.ndarray], device: torch.device):
        self.device = device
        present = np.ones(len(keys[0]), bool)
        for k in keys:
            present &= ~_isna(k)
        rows = np.flatnonzero(present)
        codes = [self._codes(k[rows]) for k in keys]
        order = torch.arange(len(rows), device=device)
        for c in reversed(codes):
            order = order[torch.sort(c[order], stable=True).indices]
        stacked = (torch.stack([c[order] for c in codes], 1) if len(rows)
                   else torch.zeros((0, len(keys)), dtype=torch.int64, device=device))
        new = torch.ones(len(rows), dtype=torch.bool, device=device)
        new[1:] = (stacked[1:] != stacked[:-1]).any(1)
        starts = torch.nonzero(new).flatten()
        self.lengths = torch.diff(torch.cat([starts, torch.tensor([len(rows)], device=device)]))
        self.rows = torch.as_tensor(rows, device=device)[order]
        self.codes = stacked[starts]                      # [groups, keys]
        self.first_rows = self.rows[starts].cpu().numpy()
        self.n = len(starts)

    def _codes(self, col: np.ndarray) -> torch.Tensor:
        if col.dtype.kind in "iufbM":
            values = (col.astype("datetime64[ns]").astype(np.int64) if col.dtype.kind == "M"
                      else col.astype(np.float64) if col.dtype.kind in "fb" else col)
            return _compact(torch.as_tensor(values, device=self.device))
        inverse = np.unique(np.array(col.tolist(), dtype=str), return_inverse=True)[1]
        return torch.as_tensor(inverse.ravel().astype(np.int64), device=self.device)

    def _sorted(self, values) -> Tuple[torch.Tensor, torch.Tensor]:
        v = torch.as_tensor(np.asarray(values, np.float64), device=self.device)
        v = (v[:, None] if v.ndim == 1 else v)[self.rows]
        return v, ~torch.isnan(v)

    def _segments(self, v: torch.Tensor, how: str) -> torch.Tensor:
        if not self.n:
            return v.new_zeros((0,) + tuple(v.shape[1:]))
        return torch.segment_reduce(v, how, lengths=self.lengths, axis=0, unsafe=True)

    def sum(self, values) -> torch.Tensor:
        """NaN-skipping sum per group and column (an all-NaN group gives 0.0)."""
        v, ok = self._sorted(values)
        return self._segments(torch.where(ok, v, 0.0), "sum")

    def mean(self, values) -> torch.Tensor:
        """NaN-skipping mean (an all-NaN group gives NaN)."""
        v, ok = self._sorted(values)
        total = self._segments(torch.where(ok, v, 0.0), "sum")
        count = self._segments(ok.double(), "sum")
        return torch.where(count > 0, total / count.clamp(min=1), math.nan)

    def max(self, values) -> torch.Tensor:
        v, ok = self._sorted(values)
        top = self._segments(torch.where(ok, v, -math.inf), "max")
        return torch.where(self._segments(ok.double(), "sum") > 0, top, math.nan)

    def first(self, present: np.ndarray) -> np.ndarray:
        """Row index of each group's first row where ``present`` [rows,
        columns] holds, -1 where none does."""
        ok = torch.as_tensor(present, device=self.device)[self.rows]
        pos = torch.arange(len(self.rows), device=self.device, dtype=torch.float64)[:, None]
        first = self._segments(torch.where(ok, pos, math.inf), "min")
        found = torch.isfinite(first)
        idx = self.rows[torch.where(found, first, 0).long()]
        return torch.where(found, idx, -1).cpu().numpy()

    def key(self, col: np.ndarray) -> np.ndarray:
        return col[self.first_rows]


def _group_first(table: Table, key: str, device) -> Table:
    """``table.groupby(key).first().reset_index()``."""
    g = _Groups([table[key]], device)
    others = [k for k in table if k != key]
    out = {key: g.key(table[key])}
    if g.n and others:
        first = g.first(np.stack([~_isna(table[k]) for k in others], 1))
        for j, k in enumerate(others):
            out[k] = _take(table[k], first[:, j])
    else:
        out.update({k: table[k][:0] for k in others})
    return out


def _wide(subject, hadm, hour_bin, itemid, values, how: str, prefix: str, device) -> Table:
    """``groupby([subject, hadm, bin, itemid])[value].agg(how).unstack()``
    without ``hour_bin``: one row per (subject, hadm, bin) in key order, one
    ``<prefix>_t<itemid>`` column per itemid in order, NaN where a bin lacks
    an itemid."""
    g = _Groups([subject, hadm, hour_bin, itemid], device)
    values = np.asarray(values, np.float64)
    if how == "first":      # one row per key: the value itself, NaN included
        reduced = torch.as_tensor(values[g.first(np.ones((len(values), 1), bool))[:, 0]],
                                  device=device)
    else:
        reduced = getattr(g, how)(values)[:, 0]
    codes = g.codes
    new_row = torch.ones(g.n, dtype=torch.bool, device=device)
    new_row[1:] = (codes[1:, :3] != codes[:-1, :3]).any(1)
    row = torch.cumsum(new_row.long(), 0) - 1
    col = _compact(codes[:, 3])
    n_rows = int(new_row.sum()) if g.n else 0
    n_cols = int(col.max()) + 1 if g.n else 0
    wide = torch.full((n_rows, n_cols), math.nan, dtype=torch.float64, device=device)
    wide[row, col] = reduced
    row_first = g.first_rows[torch.nonzero(new_row).flatten().cpu().numpy()]
    item_values = g.key(np.asarray(itemid))[
        np.unique(codes[:, 3].cpu().numpy(), return_index=True)[1]]
    out = {"subject_id": subject[row_first], "hadm_id": hadm[row_first]}
    values_host = wide.cpu().numpy()
    for j, item in enumerate(item_values.tolist()):
        out[f"{prefix}_t{int(item)}"] = values_host[:, j]
    return out


def _group_mean(table: Table, keys: Sequence[str], device) -> Table:
    """``table.groupby(keys, as_index=False).mean()`` of the value columns."""
    g = _Groups([table[k] for k in keys], device)
    out = {k: g.key(table[k]) for k in keys}
    others = [k for k in table if k not in keys]
    if others:
        means = g.mean(np.stack([table[k] for k in others], 1)).cpu().numpy()
        out.update({k: means[:, j] for j, k in enumerate(others)})
    return out


# --- Pipeline stages ----------------------------------------------------------

def _path(mimic_dir: str, name: str) -> str:
    """A raw table's path; a table the ETL reads but the directory lacks
    raises, as the JAX ``pd.read_csv`` does (optional tables included)."""
    path = os.path.join(mimic_dir, name)
    if not os.path.exists(path):
        raise FileNotFoundError(errno.ENOENT, os.strerror(errno.ENOENT), path)
    return path


def _read(mimic_dir: str, name: str, **kw) -> Tuple[Table, int]:
    return read_raw_table(_path(mimic_dir, name), **kw)


def _header(mimic_dir: str, name: str) -> List[str]:
    return read_header(_path(mimic_dir, name))


def _isin(cells: np.ndarray, values) -> np.ndarray:
    """``isin`` of text cells' numbers: a cell that is an integer's plain
    text is looked up as text, any other (a sign, a point, a leading zero,
    spaces, a missing cell) is parsed first, as pandas would type it."""
    numbers = np.asarray(list(values), np.float64)
    text = {str(int(v)) for v in numbers.tolist() if float(v).is_integer()}
    cells = cells.tolist()
    found = np.fromiter(map(text.__contains__, cells), bool, len(cells))
    rest = np.flatnonzero(~found)
    joined = "," + ",".join(cells[i] for i in rest)
    if len(rest) and (",0" in joined or not joined.replace(",", "").isdigit()):
        found[rest] = np.isin(to_numeric(np.array([cells[i] for i in rest], dtype=object)),
                              numbers)
    return found


def compute_ventilation_flags(mimic_dir: str, device=None) -> Table:
    """Per-(subject, hadm) mechanical_ventilation flag (00_data.py:54-170):
    the itemid / value rules on the host, then the (icustay, charttime) max,
    the first-wins dedup against PROCEDUREEVENTS_MV and the (subject, hadm)
    max on ``device``."""
    device = resolve_device(device)
    ce, _ = _read(mimic_dir, "CHARTEVENTS.csv.gz",
                  usecols=["ICUSTAY_ID", "CHARTTIME", "ITEMID", "VALUE", "ERROR"],
                  keep=lambda c: _isin(c["ITEMID"], VENT_ITEMIDS))
    ce = _lower(ce)
    ce = take_rows(ce, ~_isna(ce["value"]))
    err = ce["error"]
    if err.dtype.kind in "iuf":
        ce = take_rows(ce, (err != 1) | np.isnan(err.astype(np.float64)))

    iv = ce["itemid"]
    val = np.array([str(v) for v in ce["value"].tolist()], dtype=object)

    def among(values):
        return np.array([v in values for v in val.tolist()], bool)

    mechvent = (((iv == 720) & (val != "Other/Remarks"))
                | ((iv == 223848) & (val != "Other"))
                | (iv == 223849)
                | ((iv == 467) & (val == "Ventilator"))
                | np.isin(iv, sorted(_MECHVENT_ALWAYS)))
    oxygen = ((iv == 226732) & among(set(_O2_DEVICES_MV))) | (
        (iv == 467) & among(set(_O2_DEVICES_CV)))
    # itemid 640 (extubation, 00_data.py:118-121) is not in VENT_ITEMIDS, so
    # after the whitelist these flags never fire from CHARTEVENTS (kept for parity).
    extubated = (iv == 640) & among({"Extubated", "Self Extubation"})
    selfext = (iv == 640) & (val == "Self Extubation")
    flag_names = ["mechvent", "oxygentherapy", "extubated", "selfextubated"]
    flags = np.stack([mechvent, oxygen, extubated, selfext], 1).astype(np.float64)
    g = _Groups([ce["icustay_id"], ce["charttime"]], device)
    top = g.max(flags).cpu().numpy().astype(np.int64)
    vent_ce = {"icustay_id": g.key(ce["icustay_id"]), "charttime": g.key(ce["charttime"]),
               **{k: top[:, j] for j, k in enumerate(flag_names)}}

    pe = _lower(_read(mimic_dir, "PROCEDUREEVENTS_MV.csv.gz",
                      usecols=["ICUSTAY_ID", "STARTTIME", "ITEMID"])[0])
    pe = _rename(take_rows(pe, np.isin(pe["itemid"], [227194, 225468, 225477])),
                 {"starttime": "charttime"})
    n = num_rows(pe)
    vent_pe = _drop_duplicates({
        "icustay_id": pe["icustay_id"], "charttime": pe["charttime"],
        "mechvent": np.zeros(n, np.int64), "oxygentherapy": np.zeros(n, np.int64),
        "extubated": np.ones(n, np.int64),
        "selfextubated": (pe["itemid"] == 225468).astype(np.int64)},
        ["icustay_id", "charttime"] + flag_names)

    both = _drop_duplicates(_concat([vent_ce, vent_pe]), ["icustay_id", "charttime"])
    stays = _lower(_read(mimic_dir, "ICUSTAYS.csv.gz",
                         usecols=["SUBJECT_ID", "HADM_ID", "ICUSTAY_ID"])[0])
    both = _merge(both, stays, ["icustay_id"], "left")
    g = _Groups([both["subject_id"], both["hadm_id"]], device)
    per_flag = g.max(np.stack([both[k] for k in flag_names], 1).astype(np.float64))
    vent = per_flag.max(1).values.cpu().numpy().astype(np.int64)
    return {"subject_id": g.key(both["subject_id"]), "hadm_id": g.key(both["hadm_id"]),
            "mechanical_ventilation": vent}


def aggregate_lab_bins(mimic_dir: str, bin_size: int = 2, device=None) -> Optional[Table]:
    """LABEVENTS -> per-(subject, hadm, 2h-bin) mean per itemid, wide
    ``lab_t<itemid>`` columns (00_data.py:173-197)."""
    device = resolve_device(device)
    header = _header(mimic_dir, "LABEVENTS.csv.gz")
    names = {h.lower(): h for h in header}
    if "valuenum" not in names:
        return None
    used = [names[k] for k in ("subject_id", "hadm_id", "charttime", "itemid", "valuenum")
            if k in names]
    df, _ = _read(mimic_dir, "LABEVENTS.csv.gz", usecols=used,
                  keep=lambda c: ~_isna(to_numeric(c[names["valuenum"]])))
    df = _lower(df)
    stays = _lower(_read(mimic_dir, "ICUSTAYS.csv.gz",
                         usecols=["SUBJECT_ID", "HADM_ID", "INTIME"])[0])
    stays["intime"] = to_datetime(stays["intime"])
    df = _merge(df, stays, _KEYS, "inner")
    df["charttime"] = to_datetime(df["charttime"], errors="coerce")
    df = take_rows(df, ~np.isnat(df["charttime"]))
    hours = _seconds(df["charttime"], df["intime"]) / 3600
    inside = (hours >= 0) & (hours <= 24)
    df = take_rows(df, inside)
    hour_bin = np.floor_divide(hours[inside], bin_size).astype(np.int64)
    return _wide(df["subject_id"], df["hadm_id"], hour_bin, df["itemid"],
                 to_numeric(df["valuenum"]), "mean", "lab", device)


def _native_stay_arrays(icu_stays: Table):
    """(subject, hadm, intime epoch seconds) as ``_native_stay_arrays``
    computes them: seconds from pandas' microsecond values where every
    time is whole microseconds, else from nanoseconds."""
    ns = icu_stays["intime"].astype("datetime64[ns]").astype(np.int64)
    seconds = (ns // 1000) / 1e6 if not (ns % 1000).any() else ns / 1e9
    return (icu_stays["subject_id"].astype(np.int64), icu_stays["hadm_id"].astype(np.int64),
            seconds.astype(np.float64))


def _aggregate_native(mimic_dir: str, files, table_name: str, icu_stays: Table, itemids,
                      agg_func: str, device) -> Optional[Tuple[Table, int]]:
    """Native streaming path: per-file long-form aggregation via
    ``native/fastetl``, then the cross-file sum and the pivot on ``device``.
    Only valid when cross-file re-aggregation is associative (sum) or
    single-file (mean).  Returns (wide table, rows scanned) or None."""
    from fairmultimodal_torch.data import native

    file_list = files if isinstance(files, list) else [files]
    if agg_func == "mean" and len(file_list) > 1:
        return None      # per-file means don't combine; use the plain path
    subj, hadm, intime = _native_stay_arrays(icu_stays)
    items = np.asarray(sorted(itemids), np.int64) if itemids else None
    parts, rows_scanned = [], 0
    for f in file_list:
        path = os.path.join(mimic_dir, f)
        if not os.path.exists(path):
            continue
        *long, n_rows = native.aggregate_events_native(
            path, subj, hadm, intime, items, window_hours=24.0, bin_hours=2.0, agg=agg_func)
        rows_scanned += n_rows
        parts.append(long)
    if not parts:
        return None
    s, h, b, item, value = (np.concatenate(c) for c in zip(*parts))
    how = "sum" if len(parts) > 1 else "first"   # sum across files (the reference concatenates)
    return _wide(s, h, b.astype(np.int64), item, value, how, table_name, device), rows_scanned


def aggregate_feature_table(
    mimic_dir: str,
    table_name: str,
    filtered_subjects: np.ndarray,
    icu_stays: Table,
    use_native: Optional[bool] = None,
    timing_sink: Optional[List[Dict]] = None,
    device=None,
) -> Optional[Table]:
    """One feature-set-C table -> wide ``<table>_t<itemid>`` columns, one
    row per (subject, hadm, bin) (00_data.py:200-256): sum for input /
    output events, mean otherwise.  ``use_native``: None = the native
    scanner when it builds (``prescriptions`` never), True = require it,
    False = the plain path.  ``timing_sink`` collects {table, path, rows,
    seconds} for the ``--timing`` report."""
    device = resolve_device(device)
    t0 = time.perf_counter()

    def record(path_kind: str, rows: int):
        if timing_sink is not None:
            timing_sink.append({"table": table_name, "path": path_kind, "rows": int(rows),
                                "seconds": time.perf_counter() - t0})

    agg_func = "sum" if table_name in ("inputevents", "outputevents") else "mean"
    if table_name != "prescriptions" and use_native is not False:
        from fairmultimodal_torch.data import native

        if native.available():
            stays = take_rows(icu_stays, np.isin(icu_stays["subject_id"], filtered_subjects))
            out = _aggregate_native(mimic_dir, INPUT_FILES[table_name], table_name, stays,
                                    FEATURE_SET_C.get(table_name, []), agg_func, device)
            if out is not None:
                record("native", out[1])
                return out[0]
        elif use_native:
            raise RuntimeError("native fastetl library unavailable (build failed)")
    files = INPUT_FILES[table_name]
    files = files if isinstance(files, list) else [files]
    headers = [_header(mimic_dir, f) for f in files]
    columns: List[str] = []
    for h in headers:
        columns += [c.lower() for c in h if c.lower() not in columns]
    ts_col = next((c for c in _TIME_COLUMNS if c in columns), None)
    numeric_col = next((c for c in _VALUE_COLUMNS if c in columns), None)
    if "subject_id" not in columns or ts_col is None or numeric_col is None \
            or "itemid" not in columns:
        return None
    wanted = {"subject_id", "hadm_id", ts_col, "itemid", numeric_col}
    whitelist = None if table_name == "prescriptions" else FEATURE_SET_C.get(table_name, [])
    parts, n_raw = [], 0
    for f, h in zip(files, headers):
        names = {c.lower(): c for c in h}

        def keep(c, names=names):
            ok = _isin(c[names["subject_id"]], filtered_subjects)
            if whitelist is not None and "itemid" in names:
                ok &= _isin(c[names["itemid"]], whitelist)
            return ok

        part, n = _read(mimic_dir, f, usecols=[c for c in h if c.lower() in wanted], keep=keep)
        parts.append(_lower(part))
        n_raw += n
    df = _concat(parts)
    df[ts_col] = to_datetime(df[ts_col], errors="coerce")
    df = take_rows(df, ~np.isnat(df[ts_col]))
    df = _merge(df, {k: icu_stays[k] for k in ("subject_id", "hadm_id", "intime")}, _KEYS,
                "inner")
    hours = _seconds(df[ts_col], df["intime"]) / 3600
    inside = (hours >= 0) & (hours <= 24)
    df, hour_bin = take_rows(df, inside), np.floor_divide(hours[inside], 2).astype(np.int64)
    wide = _wide(df["subject_id"], df["hadm_id"], hour_bin, df["itemid"],
                 to_numeric(df[numeric_col]), agg_func, table_name, device)
    record("plain", n_raw)
    return wide


def compute_readmission_labels(admissions: Table, mode: str = "reference") -> Table:
    """Per-admission 30-day readmission label, rows sorted by (subject_id,
    ADMITTIME) (NaT last, ties in table order).

    ``mode="reference"`` (Code/1_preprocessing_structured.py:27-28): the
    floored day gap between consecutive admission times of a subject,
    flagged (<= 30) on the later admission; a first admission is 0.
    ``mode="discharge_gap"``: the next ADMITTIME within 0-30 days of this
    DISCHTIME, flagged on the earlier admission.
    Returns ``[subject_id, hadm_id, readmission_within_30d]``.
    """
    if mode not in ("reference", "discharge_gap"):
        raise ValueError(f"unknown readmission mode {mode!r}; "
                         "expected 'reference' or 'discharge_gap'")
    subj, admit = admissions["subject_id"], admissions["ADMITTIME"]
    rank = [np.unique(subj.astype(np.float64), return_inverse=True)[1].ravel()]
    t = admit.astype("datetime64[ns]").astype(np.int64)
    t_rank = np.unique(t, return_inverse=True)[1].ravel()
    rank.append(np.where(np.isnat(admit), t_rank.max(initial=0) + 1, t_rank))
    order = np.lexsort((rank[1], rank[0]))
    s = take_rows(admissions, order)
    same = np.zeros(len(order), bool)
    same[1:] = (s["subject_id"][1:] == s["subject_id"][:-1])
    if mode == "reference":
        prev = np.concatenate([[np.datetime64("NaT", "ns")], s["ADMITTIME"][:-1]])
        gap = _days(s["ADMITTIME"], np.where(same, prev, np.datetime64("NaT", "ns")))
        label = (gap <= 30).astype(np.int64)
    else:
        later = np.zeros(len(order), bool)
        later[:-1] = same[1:]
        nxt = np.concatenate([s["ADMITTIME"][1:], [np.datetime64("NaT", "ns")]])
        gap = _seconds(np.where(later, nxt, np.datetime64("NaT", "ns")), s["DISCHTIME"]) / 86400.0
        label = ((gap >= 0) & (gap <= 30)).astype(np.int64)
    return {"subject_id": s["subject_id"], "hadm_id": s["hadm_id"],
            "readmission_within_30d": label}


def compute_mortality_30d_post_discharge(df: Table) -> np.ndarray:
    """Earliest-era mortality label (Code/1_preprocessing_structured.py:24-26):
    ``(DEATHTIME - DISCHTIME).dt.days <= 30``; no DEATHTIME gives 0,
    in-hospital deaths (negative gaps) give 1."""
    return (_days(df["DEATHTIME"], df["DISCHTIME"]) <= 30).astype(np.int64)


def _fill_int(col: np.ndarray) -> np.ndarray:
    """``fillna(0).astype(int)``."""
    return np.where(_isna(col), 0, col).astype(np.int64)


def build_structured(mimic_dir: str, out_dir: str, los_threshold_hours: float = 168.0,
                     readmission_mode: str = "reference",
                     use_native: Optional[bool] = None,
                     timing_sink: Optional[List[Dict]] = None, device=None) -> Table:
    """Base cohort + labels + lab bins + feature set C (00_data.py:259-392)."""
    device = resolve_device(device)
    admissions = _read(mimic_dir, "ADMISSIONS.csv.gz",
                       usecols=["SUBJECT_ID", "HADM_ID", "ADMITTIME", "DISCHTIME",
                                "DEATHTIME", "ETHNICITY", "INSURANCE"])[0]
    patients = _read(mimic_dir, "PATIENTS.csv.gz", usecols=["SUBJECT_ID", "GENDER", "DOB"])[0]
    icu = _read(mimic_dir, "ICUSTAYS.csv.gz",
                usecols=["SUBJECT_ID", "HADM_ID", "ICUSTAY_ID", "INTIME", "OUTTIME"])[0]
    for col in ["ADMITTIME", "DISCHTIME", "DEATHTIME"]:
        admissions[col] = to_datetime(admissions[col])
    icu["INTIME"] = to_datetime(icu["INTIME"])
    icu["OUTTIME"] = to_datetime(icu["OUTTIME"])
    keys = {"SUBJECT_ID": "subject_id", "HADM_ID": "hadm_id"}
    admissions, patients, icu = (_rename(t, keys) for t in (admissions, patients, icu))

    df = _merge(icu, admissions, _KEYS, "left")
    df = _merge(df, patients, ["subject_id"], "left")
    df["DOB"] = to_datetime(df["DOB"], errors="coerce")
    df["age"] = calculate_age(df["DOB"], df["INTIME"])
    df = take_rows(df, (df["age"] >= 15) & (df["age"] <= 90))
    df["age_bucket"] = text_array([categorize_age(a) for a in df["age"].tolist()])
    df["ethnicity_category"] = text_array([categorize_ethnicity(math.nan if e is None else e)
                                      for e in df["ETHNICITY"].tolist()])
    df["insurance_category"] = text_array([categorize_insurance(math.nan if i is None else i)
                                      for i in df["INSURANCE"].tolist()])
    # Real-data observability: the reference silently routes unexpected
    # category strings to the catch-all bucket (00_data.py:22-47); report
    # how many rows took that path so surprises are visible, not silent.
    n_eth = count_unmapped(df["ETHNICITY"], df["ethnicity_category"], "Other")
    n_ins = count_unmapped(df["INSURANCE"], df["insurance_category"], "Government")
    if n_eth:
        print(f"[etl] {n_eth} rows with unmapped ETHNICITY routed to 'Other'")
    if n_ins:
        print(f"[etl] {n_ins} rows with unmapped INSURANCE routed to "
              f"'Government' (reference catch-all, 00_data.py:35-46)")
    df["gender"] = text_array([g if g is None else
                          "male" if "m" in g.lower() else "female" if "f" in g.lower()
                          else g.lower() for g in df["GENDER"].tolist()])

    df["short_term_mortality"] = (~np.isnat(df["DEATHTIME"])).astype(np.int64)
    df["icu_los"] = _seconds(df["OUTTIME"], df["INTIME"]) / 3600
    df["los_binary"] = (df["icu_los"] > los_threshold_hours).astype(np.int64)

    # Legacy-era labels kept in the inventory (Code/1_preprocessing_structured
    # .py:24-28; used by the earliest mortality+readmission generations).
    df["mortality_30d_post_discharge"] = compute_mortality_30d_post_discharge(df)
    df = _merge(df, compute_readmission_labels(admissions, mode=readmission_mode), _KEYS, "left")
    df["readmission_within_30d"] = _fill_int(df["readmission_within_30d"])

    df = _merge(df, compute_ventilation_flags(mimic_dir, device), _KEYS, "left")
    df["mechanical_ventilation"] = _fill_int(df["mechanical_ventilation"])

    lab = aggregate_lab_bins(mimic_dir, device=device)
    if lab is not None:
        df = _merge(df, lab, _KEYS, "left")

    # First ICU stay per subject (00_data.py:323).
    df = _group_first(take_rows(df, _nargsort(df["INTIME"])), "subject_id", device)
    write_csv_table(os.path.join(out_dir, "final_structured_dataset.csv"), df)

    # Feature set C merge (00_data.py:329-386).
    filtered_subjects = np.unique(df["subject_id"])
    stays = _lower(_read(mimic_dir, "ICUSTAYS.csv.gz",
                         usecols=["SUBJECT_ID", "HADM_ID", "INTIME", "OUTTIME"])[0])
    stays["intime"] = to_datetime(stays["intime"])
    stays["outtime"] = to_datetime(stays["outtime"])
    stays["icu_los"] = _seconds(stays["outtime"], stays["intime"]) / 3600
    stays = take_rows(stays, np.isin(stays["subject_id"], filtered_subjects)
                      & (stays["icu_los"] >= 30))

    merged = dict(df)
    for table in INPUT_FILES:
        feat = aggregate_feature_table(mimic_dir, table, filtered_subjects, stays,
                                       use_native=use_native, timing_sink=timing_sink,
                                       device=device)
        if feat is not None:
            # One row per stay before the merge: every value of one table is
            # repeated uniformly in the reference's Cartesian merge
            # (00_data.py:373-386), so the final mean is the per-stay mean.
            merged = _merge(merged, _group_mean(feat, _KEYS, device), _KEYS, "left")

    numeric = [k for k, v in merged.items() if v.dtype.kind in "iuf"]
    g = _Groups([merged["subject_id"]], device)
    means = g.mean(np.stack([merged[k] for k in numeric], 1)).cpu().numpy()
    out = {k: means[:, j] for j, k in enumerate(numeric)}
    categorical = [k for k in merged if k not in numeric]
    if categorical:
        first = g.first(np.stack([~_isna(merged[k]) for k in categorical], 1))
        out.update({k: _take(merged[k], first[:, j]) for j, k in enumerate(categorical)})
    write_csv_table(os.path.join(
        out_dir, "final_structured_with_feature_set_C_24h_2h_bins.csv"), out)
    return out


def clean_and_chunk_texts(texts: List[str], use_native: Optional[bool] = None) -> tuple:
    """(cleaned_texts, chunk_lists) for a list of raw note blobs: newline /
    CR -> space, strip, lower, :func:`clean_note_text`,
    :func:`split_text_to_chunks` (reference 00_data.py:395-439), through
    ``native/fastnotes`` when it is used (the same output)."""
    if use_native is not False:
        from fairmultimodal_torch.data import native

        if native.notes_available():
            return native.clean_and_chunk_native(list(texts))
        if use_native:
            raise RuntimeError("native fastnotes library unavailable (build failed)")
    cleaned = [clean_note_text(("" if t is None else str(t))
                               .replace("\n", " ").replace("\r", " ").strip().lower())
               for t in texts]
    return cleaned, [split_text_to_chunks(t) for t in cleaned]


def chunk_lists_to_table(chunk_lists: List[List[str]]) -> Table:
    """``note_chunk_i`` columns from per-document chunk lists, as the
    reference's ``apply(pd.Series)`` builds them (00_data.py:431-436):
    note_chunk_1..max, missing where a document has fewer chunks."""
    max_c = max((len(c) for c in chunk_lists), default=0)
    return {f"note_chunk_{i + 1}": text_array([cl[i] if i < len(cl) else None for cl in chunk_lists])
            for i in range(max_c)}


def chunk_lists_to_frame(chunk_lists: List[List[str]], index=None) -> Table:
    """The JAX function's name for :func:`chunk_lists_to_table` (a port table
    in place of its DataFrame; ``index``, the DataFrame's row labels, must
    have one entry per document and is not kept)."""
    if index is not None and len(index) != len(chunk_lists):
        raise ValueError(f"index of {len(index)} rows for {len(chunk_lists)} documents")
    return chunk_lists_to_table(chunk_lists)


def build_unstructured(mimic_dir: str, out_dir: str, use_native: Optional[bool] = None,
                       device=None) -> Table:
    """First-stay notes -> cleaned text -> 512-token chunk columns
    (00_data.py:441-501)."""
    device = resolve_device(device)
    stays = _read(mimic_dir, "ICUSTAYS.csv.gz",
                  usecols=["SUBJECT_ID", "HADM_ID", "ICUSTAY_ID", "INTIME", "OUTTIME"])[0]
    stays["INTIME"] = to_datetime(stays["INTIME"], errors="coerce")
    stays["OUTTIME"] = to_datetime(stays["OUTTIME"], errors="coerce")
    stays = _rename(stays, {"SUBJECT_ID": "subject_id", "HADM_ID": "hadm_id"})
    first = _group_first(take_rows(stays, _nargsort(stays["INTIME"])), "subject_id", device)
    first_hadm = first["hadm_id"][~_isna(first["hadm_id"])].astype(np.float64)

    notes = _read(mimic_dir, "NOTEEVENTS.csv.gz",
                  usecols=["SUBJECT_ID", "HADM_ID", "CHARTDATE", "TEXT"],
                  keep=lambda c: _isin(c["HADM_ID"], first_hadm),
                  typed_over_file=("SUBJECT_ID", "HADM_ID"))[0]
    notes["CHARTDATE"] = to_datetime(notes["CHARTDATE"], errors="coerce")
    notes = _rename(notes, {"SUBJECT_ID": "subject_id", "HADM_ID": "hadm_id"})
    adm = {"subject_id": first["subject_id"], "hadm_id": first["hadm_id"],
           "admission_time": first["INTIME"], "discharge_time": first["OUTTIME"]}
    merged = _merge(notes, adm, _KEYS, "inner")
    merged = take_rows(merged, (merged["CHARTDATE"] >= merged["admission_time"])
                       & (merged["CHARTDATE"] <= merged["discharge_time"]))

    g = _Groups([merged["subject_id"], merged["hadm_id"]], device)
    rows = g.rows.cpu().numpy()
    bounds = np.concatenate([[0], np.cumsum(g.lengths.cpu().numpy())])
    text = merged["TEXT"]
    joined = [" ".join(text[rows[a:b]].tolist()) for a, b in zip(bounds[:-1], bounds[1:])]
    cleaned, chunk_lists = clean_and_chunk_texts(joined, use_native=use_native)
    agg = {"subject_id": g.key(merged["subject_id"]), "hadm_id": g.key(merged["hadm_id"]),
           "TEXT": text_array(cleaned), **chunk_lists_to_table(chunk_lists)}

    structured = read_csv_table(os.path.join(out_dir, "final_structured_dataset.csv"))
    if "los_binary" not in structured:
        structured["los_binary"] = (structured["icu_los"] > 168).astype(np.int64)
    out = _merge(agg, {k: structured[k] for k in (
        "subject_id", "short_term_mortality", "icu_los", "los_binary", "mechanical_ventilation",
        "age", "age_bucket", "ethnicity_category", "insurance_category", "gender")},
        ["subject_id"], "left")
    write_csv_table(os.path.join(out_dir, "unstructured_with_demographics.csv"), out)
    return out


def run_etl(mimic_dir: str, out_dir: str, los_threshold_hours: float = 168.0,
            readmission_mode: str = "reference", use_native: Optional[bool] = None,
            timing: bool = False, device=None) -> dict:
    """Full pipeline; returns summary stats (the reference's print block,
    00_data.py:507-545, as a dict).

    ``use_native``: None = the C++ streaming aggregator / chunker when they
    build and load, True = require them, False = the plain path.
    ``timing=True`` prints per-table path + rows/sec lines and adds a
    ``"timings"`` list to the returned stats.  ``device`` runs the group-by
    core (CUDA unless ``"cpu"`` is asked for; raises without CUDA).
    """
    device = resolve_device(device)
    validate_mimic_dir(mimic_dir)   # fail fast, naming file+column problems
    os.makedirs(out_dir, exist_ok=True)
    timing_sink: Optional[List[Dict]] = [] if timing else None
    t0 = time.perf_counter()
    structured = build_structured(mimic_dir, out_dir, los_threshold_hours,
                                  readmission_mode=readmission_mode, use_native=use_native,
                                  timing_sink=timing_sink, device=device)
    t_struct = time.perf_counter() - t0
    t0 = time.perf_counter()
    unstructured = build_unstructured(mimic_dir, out_dir, use_native=use_native, device=device)
    t_unstruct = time.perf_counter() - t0
    if timing_sink is not None:
        for e in timing_sink:
            rate = e["rows"] / e["seconds"] if e["seconds"] > 0 else 0.0
            print(f"[etl timing] {e['table']}: {e['path']} path, "
                  f"{e['rows']:,} rows in {e['seconds']:.2f} s "
                  f"({rate / 1e6:.2f}M rows/s)")
        print(f"[etl timing] structured phase: {t_struct:.1f} s, "
              f"unstructured phase: {t_unstruct:.1f} s")

    common = np.intersect1d(structured["subject_id"].astype(np.float64),
                            unstructured["subject_id"].astype(np.float64))
    s_common = take_rows(structured, np.isin(structured["subject_id"], common))
    u_common = take_rows(unstructured, np.isin(unstructured["subject_id"], common))
    write_csv_table(os.path.join(out_dir, "final_structured_common.csv"), s_common)
    write_csv_table(os.path.join(out_dir, "final_unstructured_common.csv"), u_common)

    stats = {
        "structured_shape": (num_rows(structured), len(structured)),
        "unstructured_shape": (num_rows(unstructured), len(unstructured)),
        "n_common": len(common),
        "common_mortality_positives": int(np.nansum(s_common["short_term_mortality"])),
        "common_los_positives": int(np.nansum(s_common["los_binary"])),
        "common_vent_positives": int(np.nansum(s_common["mechanical_ventilation"])),
    }
    if timing_sink is not None:
        stats["timings"] = timing_sink
    return stats
