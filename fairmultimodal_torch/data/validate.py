"""Raw MIMIC-III input validation (port of ``fairmultimodal_tpu/data/validate.py``).

:func:`validate_mimic_dir` is the ETL's pre-flight: every required raw table
exists, is a readable gzipped CSV, and carries the columns the ETL reads.
It reads each header with ``gzip`` and ``csv`` (milliseconds even on 30-GB
tables) and raises :class:`MimicInputError` with the JAX function's
messages, naming the file and the columns.  :func:`count_unmapped` counts
the rows whose category text fell through to a catch-all bucket, on arrays.

:func:`validate_common_frames` is the cohort tables' pre-flight with the
JAX function's signature and error: it runs
:func:`fairmultimodal_torch.data.featurize.validate_common_frames` (tables
or DataFrames) and raises :class:`MimicInputError`.
"""

from __future__ import annotations

import csv
import gzip
import os
import zlib
from typing import Dict, Iterable, List, Optional

import numpy as np

__all__ = ["MimicInputError", "REQUIRED_RAW_COLUMNS", "validate_mimic_dir",
           "validate_common_frames", "count_unmapped"]


class MimicInputError(ValueError):
    """Raised when an input table is missing, unreadable, or lacks columns
    the pipeline needs.  Message always names the file and the columns."""


# Columns each raw table must carry = exactly what data/etl.py reads
# (usecols and downstream accesses).  Optional tables may be absent entirely
# (the ETL skips them) but when present must have these columns.
REQUIRED_RAW_COLUMNS: Dict[str, Dict] = {
    "ADMISSIONS.csv.gz": {
        "required": True,
        "columns": ["SUBJECT_ID", "HADM_ID", "ADMITTIME", "DISCHTIME",
                    "DEATHTIME", "ETHNICITY", "INSURANCE"],
    },
    "PATIENTS.csv.gz": {
        "required": True,
        "columns": ["SUBJECT_ID", "GENDER", "DOB"],
    },
    "ICUSTAYS.csv.gz": {
        "required": True,
        "columns": ["SUBJECT_ID", "HADM_ID", "ICUSTAY_ID", "INTIME",
                    "OUTTIME"],
    },
    "CHARTEVENTS.csv.gz": {
        "required": True,
        "columns": ["SUBJECT_ID", "HADM_ID", "ICUSTAY_ID", "CHARTTIME",
                    "ITEMID", "VALUE", "ERROR"],
    },
    "LABEVENTS.csv.gz": {
        "required": False,
        "columns": ["SUBJECT_ID", "HADM_ID", "CHARTTIME", "ITEMID",
                    "VALUENUM"],
    },
    "PROCEDUREEVENTS_MV.csv.gz": {
        "required": False,
        "columns": ["ICUSTAY_ID", "STARTTIME", "ITEMID"],
    },
    "NOTEEVENTS.csv.gz": {
        "required": True,
        "columns": ["SUBJECT_ID", "HADM_ID", "TEXT"],
    },
    # Feature-set-C event tables: any subset may be present.
    "inputevents_cv.csv.gz": {"required": False,
                              "columns": ["SUBJECT_ID", "HADM_ID", "ITEMID"]},
    "inputevents_mv.csv.gz": {"required": False,
                              "columns": ["SUBJECT_ID", "HADM_ID", "ITEMID"]},
    "OUTPUTEVENTS.csv.gz": {"required": False,
                            "columns": ["SUBJECT_ID", "HADM_ID", "ITEMID"]},
    "PRESCRIPTIONS.csv.gz": {"required": False,
                             "columns": ["SUBJECT_ID", "HADM_ID"]},
}


def _read_header(path: str) -> List[str]:
    try:
        with gzip.open(path, "rt", newline="", encoding="utf-8") as f:
            header = next(csv.reader(f), None)
    except (OSError, EOFError, zlib.error) as e:
        raise MimicInputError(f"{path}: cannot read table header ({e})")
    except (UnicodeDecodeError, csv.Error) as e:
        raise MimicInputError(
            f"{path}: not a parseable gzipped CSV ({type(e).__name__}: {e})")
    if not header:
        raise MimicInputError(f"{path}: not a parseable gzipped CSV (EmptyDataError: "
                              f"No columns to parse from file)")
    return [c.upper() for c in header]


def validate_mimic_dir(mimic_dir: str, tables: Optional[Iterable[str]] = None) -> None:
    """Fail fast (milliseconds) if the raw MIMIC directory cannot feed the
    ETL: missing required files, unreadable files, or missing columns — each
    error names the file and the exact columns."""
    if not os.path.isdir(mimic_dir):
        raise MimicInputError(
            f"{mimic_dir}: not a directory (pass --mimic_dir pointing at the "
            f"raw MIMIC-III csv.gz tables)")
    problems: List[str] = []
    for name in tables or REQUIRED_RAW_COLUMNS:
        spec = REQUIRED_RAW_COLUMNS[name]
        path = os.path.join(mimic_dir, name)
        if not os.path.exists(path):
            if spec["required"]:
                problems.append(f"{name}: required table is missing")
            continue
        try:
            header = _read_header(path)
        except MimicInputError as e:
            problems.append(str(e))
            continue
        missing = [c for c in spec["columns"] if c.upper() not in header]
        if missing:
            problems.append(f"{name}: missing column(s) "
                            f"{', '.join(missing)} "
                            f"(found: {', '.join(sorted(header)[:12])}...)")
    if problems:
        raise MimicInputError(
            "raw MIMIC input validation failed in "
            f"{mimic_dir}:\n  - " + "\n  - ".join(problems))


def validate_common_frames(structured, unstructured,
                           label_columns: Optional[Iterable[str]] = None) -> None:
    """Pre-flight for the training pipelines (``validate.py:131``): the two
    cohort tables carry the merge keys, the label columns (default the three
    tasks') without NaN, and note chunks."""
    from fairmultimodal_torch import LABEL_COLUMNS
    from fairmultimodal_torch.data.featurize import CohortInputError
    from fairmultimodal_torch.data.featurize import validate_common_frames as check

    try:
        check(structured, unstructured, list(label_columns or LABEL_COLUMNS))
    except CohortInputError as e:
        raise MimicInputError(str(e)) from None


def count_unmapped(raw, mapped, catch_all: str) -> int:
    """Rows whose raw category text fell through to the catch-all bucket
    without literally being that bucket (a missing cell counts as the text
    ``nan``, as pandas' ``astype(str)`` makes it)."""
    text = np.array(["nan" if v is None else str(v) for v in np.asarray(raw).tolist()],
                    dtype=object)
    literal = np.array([t.strip().upper() == catch_all.upper() for t in text.tolist()], bool)
    return int(((np.asarray(mapped) == catch_all) & ~literal).sum())
