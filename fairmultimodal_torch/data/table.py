"""Cohort tables without pandas.

A table is an ordered ``{column name: numpy array}`` dict whose arrays all
have one length: int64, float64 (NaN for a missing cell), bool,
``datetime64[ns]`` (NaT for a missing cell), or object arrays of ``str``
with ``None`` for a missing cell.  The two cohort tables
(``final_structured_common.csv`` / ``final_unstructured_common.csv``) are
read and written here with the standard ``csv`` module, so the command line
needs no pandas.

:func:`read_csv_table` types each column as ``pandas.read_csv`` does with its
defaults, for the cells a cohort holds: pandas' missing-value strings
(:data:`MISSING_VALUES`) are missing; a column is int64 when every cell
parses as an integer and none is missing, bool when every cell is
``True`` / ``False`` (any case pandas accepts) and none is missing, float64
when every non-missing cell parses as a float, and text otherwise.  Floats
are parsed correctly rounded, as pandas' ``float_precision="round_trip"``
parses them (its default parser can be about 1e-13 relative off).
:func:`write_csv_table` writes floats with ``repr``, so a round trip is
exact, and a missing cell as an empty field, as ``DataFrame.to_csv`` does.
:func:`table_from_frame` / :func:`frame_from_table` convert to and from a
DataFrame where pandas exists (imported inside those two functions only).
"""

from __future__ import annotations

import csv
import math
from typing import Dict, List

import numpy as np

__all__ = ["MISSING_VALUES", "Table", "read_csv_table", "write_csv_table", "table_from_frame",
           "frame_from_table", "num_rows", "take_rows", "head", "is_missing"]

Table = Dict[str, np.ndarray]

#: pandas' default ``na_values`` (``pandas._libs.parsers.STR_NA_VALUES``).
MISSING_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_TRUE = frozenset({"True", "TRUE", "true"})
_FALSE = frozenset({"False", "FALSE", "false"})


def is_missing(v) -> bool:
    """A missing cell: ``None`` or a float NaN (pandas' NaN in a DataFrame)."""
    return v is None or (isinstance(v, float) and math.isnan(v))


def num_rows(table: Table) -> int:
    return len(next(iter(table.values()))) if table else 0


def take_rows(table: Table, index) -> Table:
    """The rows ``index`` (an integer array or a boolean mask), in its order."""
    return {k: v[index] for k, v in table.items()}


def head(table: Table, n: int) -> Table:
    """The first ``n`` rows (``DataFrame.head``)."""
    return {k: v[:n] for k, v in table.items()}


def _int(cell: str) -> int:
    if "_" in cell:             # Python's int() takes "1_0"; pandas does not
        raise ValueError(cell)
    v = int(cell)
    if not -2 ** 63 <= v < 2 ** 63:
        raise ValueError(cell)
    return v


def _float(cell: str) -> float:
    if "_" in cell:
        raise ValueError(cell)
    return float(cell)


def _column(cells: List[str]) -> np.ndarray:
    missing = [c in MISSING_VALUES for c in cells]
    if not any(missing):
        try:
            return np.array([_int(c) for c in cells], dtype=np.int64)
        except ValueError:
            pass
        if all(c in _TRUE or c in _FALSE for c in cells):
            return np.array([c in _TRUE for c in cells], dtype=bool)
    try:
        return np.array([math.nan if m else _float(c) for c, m in zip(cells, missing)],
                        dtype=np.float64)
    except ValueError:
        pass
    out = np.empty(len(cells), dtype=object)
    out[:] = [None if m else c for c, m in zip(cells, missing)]
    return out


def read_csv_table(path: str) -> Table:
    """A CSV file with a header row -> table (``pd.read_csv(path)``'s columns
    and values)."""
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        try:
            header = next(reader)
        except StopIteration:
            raise ValueError(f"{path}: no header row") from None
        rows = list(reader)
    if len(set(header)) != len(header):
        raise ValueError(f"{path}: duplicate column names")
    width = len(header)
    columns: List[List[str]] = [[] for _ in header]
    for line, row in enumerate(rows, start=2):
        if not row:
            continue                      # pandas skips blank lines
        if len(row) > width:
            raise ValueError(f"{path}:{line}: {len(row)} fields, header has {width}")
        row = row + [""] * (width - len(row))
        for col, cell in zip(columns, row):
            col.append(cell)
    return {name: _column(cells) for name, cells in zip(header, columns)}


def _cell(v) -> str:
    if is_missing(v):
        return ""
    if isinstance(v, (bool, np.bool_)):
        return "True" if v else "False"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return str(v)


def _column_cells(col: np.ndarray) -> list:
    """A time column as ISO-8601 text at its own resolution (``2150-02-06
    05:50:54.129725084``, one width for the column, so the text sorts as the
    times do), a missing time as None; any other column's values."""
    if col.dtype.kind != "M":
        return col.tolist()
    text = np.char.replace(np.datetime_as_string(col), "T", " ").tolist()
    return [None if m else t for t, m in zip(text, np.isnat(col).tolist())]


def write_csv_table(path: str, table: Table) -> None:
    """Table -> CSV with a header row, no index (``to_csv(index=False)``).
    A time column is read back as text, which ``pd.to_datetime`` and the
    legacy pipeline parse."""
    names = list(table)
    cols = [_column_cells(table[k]) for k in names]
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        for row in zip(*cols):
            w.writerow([_cell(v) for v in row])


def table_from_frame(df) -> Table:
    """DataFrame -> table: numeric and bool columns as their numpy arrays,
    time columns (without a time zone) as ``datetime64[ns]``, every other
    column as an object array with ``None`` for a missing cell."""
    import pandas as pd

    out: Table = {}
    for name in df.columns:
        col = df[name]
        if pd.api.types.is_bool_dtype(col.dtype) or (
                pd.api.types.is_numeric_dtype(col.dtype) and col.dtype.kind in "iuf"):
            out[str(name)] = col.to_numpy()
        elif col.dtype.kind == "M":
            out[str(name)] = col.to_numpy().astype("datetime64[ns]")
        else:
            arr = col.to_numpy(dtype=object).copy()
            arr[pd.isna(arr)] = None
            out[str(name)] = arr
    return out


def frame_from_table(table: Table):
    """Table -> DataFrame, for callers that want one."""
    import pandas as pd

    return pd.DataFrame({k: v for k, v in table.items()})
