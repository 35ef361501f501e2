"""Feature assembly (port of ``fairmultimodal_tpu/data/featurize.py``).

Reproduces ``10_FAME.py:610-731``: merge the two cohort tables, keep
patients with at least one valid note chunk, map demographics to category
codes, select and z-score the lab columns, and stack the three task labels
into a :class:`FeatureBundle` of dense numpy arrays.

Host-side numpy over port tables (:mod:`fairmultimodal_torch.data.table`),
so a machine without pandas featurizes the cohort; a DataFrame is converted
to a table first (pandas is imported inside that conversion only).  The
pandas semantics kept: the inner merge's row order and ``_struct`` /
``_unstruct`` suffixes, category codes over the sorted observed values (-1
for a missing one), numeric columns as lab features in column order,
``fillna(0)`` and the float32 z-score.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from fairmultimodal_torch import LABEL_COLUMNS
from fairmultimodal_torch.data.table import Table, is_missing, num_rows, table_from_frame, \
    take_rows

__all__ = ["FeatureBundle", "assemble_features", "zscore", "compute_pos_weights",
           "get_age_bucket", "map_ethnicity", "map_insurance", "CohortInputError",
           "validate_common_frames", "as_table"]

# Columns never used as lab features (10_FAME.py:700-702).
EXCLUDE_COLS = {
    "subject_id", "ROW_ID", "hadm_id", "ICUSTAY_ID",
    "short_term_mortality", "los_binary", "mechanical_ventilation",
    "readmission_within_30d", "readmission_within_30_days",
    "mortality_30d_post_discharge",
    "age", "GENDER", "GENDERS", "ETHNICITY", "INSURANCE",
}


@dataclasses.dataclass
class FeatureBundle:
    """Dense feature arrays for one cohort."""

    subject_id: np.ndarray          # [N] int64
    age_codes: np.ndarray           # [N] int32 (bucket codes)
    gender_codes: np.ndarray        # [N] int32
    ethnicity_codes: np.ndarray     # [N] int32
    insurance_codes: np.ndarray     # [N] int32
    labs: np.ndarray                # [N, L] float32, z-scored
    labels: np.ndarray              # [N, 3] float32
    lab_columns: List[str]
    note_chunks: List[List[str]]    # per-patient list of non-empty chunk texts
    text_embeddings: Optional[np.ndarray] = None  # [N, H] float32, filled later
    # The lab matrix before the z-score (fillna(0) only): 04's stage 2 takes
    # the raw lab columns (04_AdvDebias.py:888-891, no scaling).
    labs_raw: Optional[np.ndarray] = None  # [N, L] float32

    @property
    def num_patients(self) -> int:
        return len(self.subject_id)

    @property
    def num_lab_features(self) -> int:
        return self.labs.shape[1]

    def vocab_sizes(self):
        """(num_ages, num_genders, num_ethnicities, num_insurances): the
        number of distinct observed codes (10_FAME.py:762-765)."""
        return (
            int(len(np.unique(self.age_codes))),
            int(len(np.unique(self.gender_codes))),
            int(len(np.unique(self.ethnicity_codes))),
            int(len(np.unique(self.insurance_codes))),
        )


def get_age_bucket(age, upper: int = 89) -> str:
    """10_FAME.py:644-658.  ``upper=90`` is 09's bucket edge
    (09_multimodal_sigmoid_fusion.py:57-67: the last bucket is 70-90, so
    age-90 patients land in it instead of "Other")."""
    try:
        age = float(age)
    except (TypeError, ValueError):
        return "Other"
    if 15 <= age <= 29:
        return "15-29"
    elif 30 <= age <= 49:
        return "30-49"
    elif 50 <= age <= 69:
        return "50-69"
    elif 70 <= age <= upper:
        return f"70-{upper}"
    return "Other"


def map_ethnicity(e) -> str:
    """10_FAME.py:662-670."""
    try:
        e = int(e)
        return {0: "White", 1: "Black", 2: "Hispanic", 3: "Asian"}.get(e, "Other")
    except (TypeError, ValueError):
        e = str(e).strip().title()
        return e if e in {"White", "Black", "Asian", "Hispanic"} else "Other"


def map_insurance(i) -> str:
    """10_FAME.py:677-686."""
    try:
        i = int(i)
        return {0: "Government", 1: "Medicare", 2: "Medicaid", 3: "Private",
                4: "Self Pay"}.get(i, "Other")
    except (TypeError, ValueError):
        i = str(i).strip().title()
        return i if i in {"Government", "Medicare", "Medicaid", "Private",
                          "Self Pay"} else "Other"


def zscore(x: np.ndarray, mean=None, std=None, eps: float = 1e-6):
    """Global z-score with the reference's epsilon (10_FAME.py:710-712).
    Returns (scaled, mean, std); pass a fitted ``mean`` / ``std`` to scale
    another cohort the same way."""
    x = np.asarray(x, dtype=np.float32)
    mean = np.mean(x, axis=0) if mean is None else mean
    std = np.std(x, axis=0) if std is None else std
    return (x - mean) / (std + eps), mean, std


def compute_pos_weights(labels: np.ndarray) -> np.ndarray:
    """Per-task positive-class weight n/(2*n_pos), 1.0 for a task without
    positives (10_FAME.py:48-52,756-759)."""
    labels = np.asarray(labels)
    n = len(labels)
    out = []
    for i in range(labels.shape[1]):
        pos = labels[:, i].sum()
        out.append(n / (2.0 * pos) if pos > 0 else 1.0)
    return np.asarray(out, dtype=np.float32)


class CohortInputError(ValueError):
    """A cohort table lacks a merge key, a label column or note chunks."""


def as_table(frame) -> Table:
    """A port table as it is; a DataFrame through :func:`table_from_frame`."""
    return frame if isinstance(frame, Mapping) else table_from_frame(frame)


def validate_common_frames(structured, unstructured,
                           label_columns: Sequence[str] = LABEL_COLUMNS,
                           require_notes: bool = True) -> None:
    """Fail fast, naming the table and column, before any featurization.
    Takes tables or DataFrames.  Note chunk columns are required only with
    ``require_notes``: the JAX check asks for them always, so its
    structured-only 01 run without an unstructured table raises
    (``pipelines/behrt.py:64-66``); the port runs it."""
    structured, unstructured = as_table(structured), as_table(unstructured)
    problems: List[str] = []
    for key in ("subject_id", "hadm_id"):
        if key not in structured:
            problems.append(f"structured table: missing merge key '{key}'")
        if key not in unstructured:
            problems.append(f"unstructured table: missing merge key '{key}'")
    for col in label_columns:
        if col not in structured:
            problems.append(f"structured table: missing label column '{col}'")
            continue
        n_missing = sum(map(is_missing, structured[col].tolist()))
        if n_missing:
            problems.append(f"structured table: label column '{col}' has "
                            f"{n_missing} NaN rows (labels must be 0/1)")
    if require_notes and not any(c.startswith("note_") for c in unstructured):
        problems.append("unstructured table: no note_* chunk columns "
                        "(expected note_chunk_1, note_chunk_2, ...)")
    if problems:
        raise CohortInputError(
            "cohort table validation failed:\n  - " + "\n  - ".join(problems))


def _is_note(v) -> bool:
    return isinstance(v, str) and bool(v.strip())


def _inner_merge(left: Table, right: Table, on: Sequence[str],
                 suffixes: Tuple[str, str]) -> Table:
    """``pd.merge(left, right, on=on, how="inner", suffixes=suffixes)``: the
    left rows in their order, each repeated for its matching right rows in
    theirs; the left columns, then the right's other columns, a name in both
    suffixed on each side."""
    index: Dict[tuple, List[int]] = {}
    for j, key in enumerate(zip(*(right[k].tolist() for k in on))):
        index.setdefault(key, []).append(j)
    li, ri = [], []
    for i, key in enumerate(zip(*(left[k].tolist() for k in on))):
        for j in index.get(key, ()):
            li.append(i)
            ri.append(j)
    li, ri = np.asarray(li, np.int64), np.asarray(ri, np.int64)
    both = (set(left) & set(right)) - set(on)
    out: Table = {}
    for k, v in left.items():
        out[k + suffixes[0] if k in both else k] = v[li]
    for k, v in right.items():
        if k not in on:
            out[k + suffixes[1] if k in both else k] = v[ri]
    return out


def _category_codes(values: Sequence) -> np.ndarray:
    """``Series.astype("category").cat.codes``: each value's index among the
    sorted distinct observed values, -1 for a missing one."""
    cats = {v: i for i, v in enumerate(sorted({v for v in values if not is_missing(v)}))}
    return np.asarray([-1 if is_missing(v) else cats[v] for v in values], np.int32)


def assemble_features(structured, unstructured, require_notes: bool = True,
                      age_bucket_upper: int = 89,
                      label_columns: Optional[Sequence[str]] = None) -> FeatureBundle:
    """Merge + featurize the two cohort tables (10_FAME.py:610-731).  Takes
    port tables (:mod:`fairmultimodal_torch.data.table`) or DataFrames, which
    are converted first: one implementation serves both.

    ``require_notes``: keep only the patients with at least one note chunk
    (False for structured-only models).  ``age_bucket_upper``: the last age
    bucket's upper edge (90 for 09's variant).  ``label_columns``: the label
    columns to stack (default the three tasks; 02's readmission regime
    passes ``("readmission_within_30d",)``)."""
    label_columns = list(label_columns or LABEL_COLUMNS)
    s, u = as_table(structured), as_table(unstructured)
    validate_common_frames(s, u, label_columns, require_notes)
    dropped = {"short_term_mortality", "los_binary", "mechanical_ventilation",
               "age", "GENDER", "ETHNICITY", "INSURANCE"}
    u = {k: v for k, v in u.items() if k not in dropped}
    df = _inner_merge(s, u, ("subject_id", "hadm_id"), ("_struct", "_unstruct"))
    if num_rows(df) == 0:
        raise ValueError("Merged DataFrame is empty. Check your merge keys.")

    for col in label_columns:
        df[col] = df[col].astype(np.int64)

    note_columns = [c for c in df if c.startswith("note_")]
    if require_notes:
        notes = [df[c].tolist() for c in note_columns]
        keep = np.asarray([any(_is_note(col[i]) for col in notes)
                           for i in range(num_rows(df))], bool)
        df = take_rows(df, keep)
    n = num_rows(df)

    if "age" not in df:
        if "Age" in df:
            df = {("age" if k == "Age" else k): v for k, v in df.items()}
        else:
            df["age"] = np.zeros(n, np.int64)

    # Category codes over the observed sorted values, as the reference.
    df["age"] = _category_codes([get_age_bucket(a, age_bucket_upper)
                                 for a in df["age"].tolist()])
    for col, mapper in (("ETHNICITY", map_ethnicity), ("INSURANCE", map_insurance),
                        ("GENDER", None)):
        if col in df:
            vals = df[col].tolist()
            df[col] = _category_codes([mapper(v) for v in vals] if mapper else vals)
        else:
            df[col] = np.zeros(n, np.int64)

    lab_cols = [c for c in df
                if c not in EXCLUDE_COLS and not c.startswith("note_")
                and df[c].dtype.kind in "biuf"]
    # fillna(0), then each column to float32, as DataFrame.to_numpy(float32)
    # does; column-major like its result, so the z-score's column sums run
    # in the same order.
    labs_t = np.zeros((len(lab_cols), n), np.float32)
    for j, c in enumerate(lab_cols):
        col = df[c]
        labs_t[j] = np.where(np.isnan(col), 0, col) if col.dtype.kind == "f" else col
    labs, _, _ = zscore(labs_t.T)

    note_cols = [df[c].tolist() for c in note_columns]
    chunks = [[col[i] for col in note_cols if _is_note(col[i])] for i in range(n)]

    return FeatureBundle(
        subject_id=df["subject_id"].astype(np.int64),
        age_codes=df["age"].astype(np.int32),
        gender_codes=df["GENDER"].astype(np.int32),
        ethnicity_codes=df["ETHNICITY"].astype(np.int32),
        insurance_codes=df["INSURANCE"].astype(np.int32),
        labs=labs,
        labs_raw=np.ascontiguousarray(labs_t.T),
        labels=np.stack([df[c] for c in label_columns], axis=1).astype(np.float32)
        if n else np.zeros((0, len(label_columns)), np.float32),
        lab_columns=lab_cols,
        note_chunks=chunks,
    )
