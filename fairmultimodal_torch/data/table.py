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
A time column is written as ``DataFrame.to_csv`` writes it: ``YYYY-MM-DD``
when every time in it is a midnight, else ``YYYY-MM-DD HH:MM:SS`` with as many
fraction digits (0, 3, 6 or 9) as its finest time needs.
:func:`table_from_frame` / :func:`frame_from_table` convert to and from a
DataFrame where pandas exists (imported inside those two functions only).

The raw MIMIC-III tables are read by :func:`read_raw_table`: a ``csv.gz``
streamed in chunks with ``usecols`` (returned in the file's column order, as
pandas returns them), an optional ``keep`` filter applied to each chunk's
text cells while reading, and each kept column typed as above at the end.
:func:`to_datetime` parses text into ``datetime64[ns]`` as
``pd.to_datetime`` does for ISO-8601 cells: the format is taken from the
first cell, a cell of another format is an error (or NaT with
``errors="coerce"``), and so is an impossible date.  :func:`to_numeric` is
``pd.to_numeric(errors="coerce")`` into float64.
"""

from __future__ import annotations

import csv
import gzip
import math
import re
from itertools import chain, compress, islice
from operator import itemgetter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["MISSING_VALUES", "Table", "read_csv_table", "write_csv_table", "table_from_frame",
           "frame_from_table", "num_rows", "take_rows", "head", "is_missing", "read_raw_table",
           "read_header", "to_datetime", "to_numeric", "format_times", "write_rows", "text_array"]

Table = Dict[str, np.ndarray]

#: pandas' default ``na_values`` (``pandas._libs.parsers.STR_NA_VALUES``).
MISSING_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_TRUE = frozenset({"True", "TRUE", "true"})
_CHUNK_ROWS = 1 << 17
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


def _slow_column(cells, missing: List[bool]) -> np.ndarray:
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
        return _text(cells, missing)


def text_array(values) -> np.ndarray:
    """A text column: an object array of ``str``, ``None`` kept for a
    missing cell."""
    out = np.empty(len(values), dtype=object)
    out[:] = [None if v is None else str(v) for v in values]
    return out


def _text(cells, missing) -> np.ndarray:
    out = np.empty(len(cells), dtype=object)
    out[:] = cells
    out[np.asarray(missing, bool)] = None
    return out


def _column(cells: Sequence[str]) -> np.ndarray:
    """Cells of one column -> its typed array (the module docstring's rule).
    A column whose first cell is not a number is text or bool without
    parsing the rest; a numeric one is parsed with ``int`` / ``float`` over
    the cells at C speed, and cell by cell only where a cell has a ``_``."""
    cells = list(cells)
    n = len(cells)
    missing = np.fromiter(map(MISSING_VALUES.__contains__, cells), bool, n)
    gaps = bool(missing.any())
    present = list(compress(cells, ~missing)) if gaps else cells
    if not present:
        return np.full(n, math.nan)
    try:
        _float(present[0])
    except ValueError:
        if not gaps and all(c in _TRUE or c in _FALSE for c in cells):
            return np.array([c in _TRUE for c in cells], dtype=bool)
        return _text(cells, missing)
    if "_" in "\x00".join(present):        # int() and float() take "1_0"; pandas does not
        return _slow_column(cells, missing.tolist())
    if not gaps:
        try:
            return np.fromiter(map(int, cells), np.int64, n)
        except (ValueError, OverflowError):
            pass
    try:
        values = np.fromiter(map(float, present), np.float64, len(present))
    except ValueError:
        return _text(cells, missing)
    out = np.full(n, math.nan)
    out[~missing] = values
    return out


def to_numeric(cells) -> np.ndarray:
    """``pd.to_numeric(cells, errors="coerce")`` as float64: a missing or
    unparsable cell is NaN.  A numeric array is returned as float64."""
    cells = np.asarray(cells)
    if cells.dtype.kind in "iufb":
        return cells.astype(np.float64)
    out = np.full(len(cells), math.nan)
    idx = np.flatnonzero([isinstance(c, str) and c not in MISSING_VALUES
                          for c in cells.tolist()])
    text = np.array(cells[idx].tolist(), dtype=str)
    if not (text.view(np.uint32) == ord("_")).any():
        try:
            out[idx] = text.astype(np.float64)
            return out
        except ValueError:
            pass
    for i in idx.tolist():
        try:
            out[i] = _float(cells[i])
        except ValueError:
            pass
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


def read_header(path: str) -> List[str]:
    """The column names of a ``csv.gz`` (or plain CSV) file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", newline="", encoding="utf-8") as f:
        header = next(csv.reader(f), None)
    if not header:
        raise ValueError(f"{path}: no columns to parse from file")
    return header


def read_raw_table(path: str, usecols: Optional[Sequence[str]] = None,
                   keep: Optional[Callable[[Table], np.ndarray]] = None,
                   typed_over_file: Sequence[str] = ()) -> Tuple[Table, int]:
    """A ``csv.gz`` (or plain CSV) file -> (table, rows read).

    ``usecols`` names the columns to keep; they come back in the file's
    order, and a name the header lacks is an error, as in ``pd.read_csv``.
    The file is read _CHUNK_ROWS rows at a time; ``keep``, when given,
    gets each chunk as ``{name: object array of the cells' text}`` and
    returns the rows to keep (a bool mask), so memory follows the rows kept.
    The kept cells of each column are typed at the end (module docstring),
    over the kept rows: pandas types a column over the whole file, so a
    column named in ``typed_over_file`` that is int64 over the kept rows
    becomes float64 when a dropped row had a missing cell in it.
    """
    header = read_header(path)
    if usecols is None:
        names = list(header)
    else:
        absent = [c for c in usecols if c not in header]
        if absent:
            raise ValueError(f"{path}: usecols do not match columns, columns expected "
                             f"but not found: {absent}")
        names = [h for h in header if h in set(usecols)]
    getters = [itemgetter(header.index(n)) for n in names]
    width, n_rows = len(header), 0
    parts: List[List[np.ndarray]] = [[] for _ in names]
    gaps = {n: False for n in typed_over_file}
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", newline="", encoding="utf-8") as f:
        reader = csv.reader(chain.from_iterable(_lines(f)))
        next(reader)
        while True:
            rows = list(islice(reader, _CHUNK_ROWS))
            if not rows:
                break
            if set(map(len, rows)) != {width}:
                rows = [_pad(path, r, width) for r in rows if r]    # pandas skips blank lines
            n_rows += len(rows)
            chunk = _Chunk(rows, dict(zip(names, getters)))
            for n in gaps:
                gaps[n] = gaps[n] or not MISSING_VALUES.isdisjoint(chunk[n].tolist())
            if keep is not None:
                mask = keep(chunk)
                chunk = _Chunk(list(compress(rows, mask)), chunk.getters,
                               {n: v[mask] for n, v in chunk.items()})
            for part, n in zip(parts, names):
                part.append(chunk[n])
    out = {n: _column(np.concatenate(part).tolist() if part else [])
           for n, part in zip(names, parts)}
    for n, gap in gaps.items():
        if gap and out[n].dtype.kind == "i":
            out[n] = out[n].astype(np.float64)
    return out, n_rows


class _Chunk(dict):
    """A chunk's columns as object arrays of text, each built from the rows
    when first asked for (a filter reads one or two of them)."""

    def __init__(self, rows: List[List[str]], getters: Dict, built: Optional[Dict] = None):
        super().__init__(built or {})
        self.rows, self.getters = rows, getters

    def __missing__(self, name: str) -> np.ndarray:
        col = np.fromiter(map(self.getters[name], self.rows), dtype=object, count=len(self.rows))
        self[name] = col
        return col


def _lines(f, block: int = 1 << 22):
    """The lines of a text file, newline kept, read in large blocks (a
    gzip stream checks itself once a line when read line by line)."""
    rest = ""
    while True:
        data = f.read(block)
        if not data:
            break
        lines = (rest + data).split("\n")
        rest = lines.pop()
        yield [line + "\n" for line in lines]
    if rest:
        yield [rest]


def _pad(path: str, row: List[str], width: int) -> List[str]:
    if len(row) > width:
        raise ValueError(f"{path}: a row of {len(row)} fields, the header has {width}")
    return row + [""] * (width - len(row))


_TIME_FORMAT = re.compile(
    r"(\d{4})-(\d{2})-(\d{2})(?:([ T])(\d{2}):(\d{2})(?::(\d{2})(?:\.(\d{1,9}))?)?)?\Z")
_NAT_TEXT = frozenset({"", "NaT", "nat", "NAT", "NaN", "nan", "None"})
_MONTH_DAYS = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])


def to_datetime(cells, errors: str = "raise") -> np.ndarray:
    """``pd.to_datetime(cells, errors=errors)`` into ``datetime64[ns]`` for
    ISO-8601 text (``YYYY-MM-DD``, then optionally `` `` or ``T`` and
    ``HH:MM``, ``:SS``, ``.f`` with 1-9 digits).  The first present cell
    sets the format; a cell of another format or an impossible date raises
    ``ValueError``, or is NaT with ``errors="coerce"``.  A first cell in no
    such format, or a year outside 1678-2261, always raises."""
    cells = np.asarray(cells)
    if cells.dtype.kind == "M":
        return cells.astype("datetime64[ns]")
    out = np.full(len(cells), np.datetime64("NaT", "ns"))
    idx = np.flatnonzero([isinstance(c, str) and c not in _NAT_TEXT for c in cells.tolist()])
    if not len(idx):
        return out
    first = cells[idx[0]]
    m = _TIME_FORMAT.match(first)
    if m is None:
        raise ValueError(f"time data {first!r} is not an ISO-8601 date or time")
    text = np.array(cells[idx].tolist(), dtype=str)
    codes = np.zeros((len(text), 29), np.int64)
    width = min(text.dtype.itemsize // 4, 29)
    codes[:, :width] = text.view(np.uint32).reshape(len(text), -1)[:, :width].astype(np.int64)
    length = np.char.str_len(text)
    digits = codes - ord("0")
    is_digit = (digits >= 0) & (digits <= 9)

    def number(*pos):
        v = np.zeros(len(text), np.int64)
        for p in pos:
            v = v * 10 + digits[:, p]
        return v

    ok = is_digit[:, [0, 1, 2, 3, 5, 6, 8, 9]].all(1)
    ok &= (codes[:, 4] == ord("-")) & (codes[:, 7] == ord("-"))
    year, month, day = number(0, 1, 2, 3), number(5, 6), number(8, 9)
    hour = minute = second = frac = 0
    if m.group(4) is None:
        ok &= length == 10
    else:
        ok &= (codes[:, 10] == ord(m.group(4))) & (codes[:, 13] == ord(":"))
        ok &= is_digit[:, [11, 12, 14, 15]].all(1)
        hour, minute = number(11, 12), number(14, 15)
        if m.group(7) is None:
            ok &= length == 16
        else:
            ok &= (codes[:, 16] == ord(":")) & is_digit[:, [17, 18]].all(1)
            second = number(17, 18)
            if m.group(8) is None:
                ok &= length == 19
            else:
                ok &= (codes[:, 19] == ord(".")) & (length >= 21) & (length <= 29)
                inside = np.arange(20, 29)[None, :] < length[:, None]
                ok &= (is_digit[:, 20:29] | ~inside).all(1)
                frac = (np.where(inside, digits[:, 20:29], 0)
                        * 10 ** np.arange(8, -1, -1)).sum(1)
    leap = (year % 4 == 0) & ((year % 100 != 0) | (year % 400 == 0))
    month_days = _MONTH_DAYS[np.clip(month, 1, 12) - 1] + ((month == 2) & leap)
    ok &= (month >= 1) & (month <= 12) & (day >= 1) & (day <= month_days)
    ok &= (hour <= 23) & (minute <= 59) & (second <= 59)
    if not ok.all() and errors != "coerce":
        raise ValueError(f"time data {cells[idx[np.argmin(ok)]]!r} does not match the "
                         f"format of {first!r}")
    if ((year[ok] < 1678) | (year[ok] > 2261)).any():
        raise ValueError("a time outside 1678-2261 does not fit datetime64[ns]")
    y = year - (month <= 2)                 # days from the civil date (H. Hinnant)
    era = np.floor_divide(y, 400)
    yoe = y - era * 400
    doy = (153 * np.where(month > 2, month - 3, month + 9) + 2) // 5 + day - 1
    days = era * 146097 + yoe * 365 + yoe // 4 - yoe // 100 + doy - 719468
    ns = (((days * 24 + hour) * 60 + minute) * 60 + second) * 10 ** 9 + frac
    out[idx[ok]] = ns[ok].astype("datetime64[ns]")
    return out


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


_NS_PER_DAY = 86400 * 10 ** 9


def format_times(col: np.ndarray) -> list:
    """A time column as ``DataFrame.to_csv`` writes it (see the module
    docstring), a missing time as None."""
    valid = ~np.isnat(col)
    ns = col.astype("datetime64[ns]").astype(np.int64)[valid]
    if not valid.any() or not (ns % _NS_PER_DAY).any():
        unit = "D"
    else:
        sub = ns % 10 ** 9
        unit = ("ns" if (sub % 1000).any() else "us" if (sub % 10 ** 6).any()
                else "ms" if sub.any() else "s")
    text = np.char.replace(np.datetime_as_string(col.astype(f"datetime64[{unit}]")), "T", " ")
    return [t if ok else None for t, ok in zip(text.tolist(), valid.tolist())]


def _column_text(col: np.ndarray) -> List[str]:
    """A column's CSV fields: floats by ``repr``, times by
    :func:`format_times`, a missing cell empty (a numpy ``str`` array, which
    has none, is written as it is)."""
    kind = col.dtype.kind
    if kind == "M":
        return ["" if t is None else t for t in format_times(col)]
    if kind == "f":
        return [repr(v) if v == v else "" for v in col.tolist()]
    if kind in "iuU":
        return col.astype(str).tolist()
    return [_cell(v) for v in col.tolist()]


def write_rows(f, table: Table, header: bool = True) -> None:
    """Table -> CSV rows on an open text file (``to_csv(index=False)``'s
    fields and quoting), the header row first unless ``header=False``."""
    w = csv.writer(f, lineterminator="\n")
    if header:
        w.writerow(list(table))
    w.writerows(zip(*(_column_text(v) for v in table.values())))


def write_csv_table(path: str, table: Table) -> None:
    """Table -> CSV with a header row, no index (``to_csv(index=False)``),
    gzipped (at level 1, for speed) when ``path`` ends in ``.gz``.  A time
    column is read back as text, which ``pd.to_datetime`` and
    :func:`to_datetime` parse."""
    if path.endswith(".gz"):
        with gzip.open(path, "wt", compresslevel=1, newline="", encoding="utf-8") as f:
            write_rows(f, table)
    else:
        with open(path, "w", newline="", encoding="utf-8") as f:
            write_rows(f, table)


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
