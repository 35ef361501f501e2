"""Feature assembly (port of ``fairmultimodal_tpu/data/featurize.py``).

Reproduces ``10_FAME.py:610-731``: merge the two cohort tables, keep
patients with at least one valid note chunk, map demographics to category
codes, select and z-score the lab columns, and stack the three task labels
into a :class:`FeatureBundle` of dense numpy arrays.

Host-side numpy; ``pandas`` is imported only inside the functions that take
DataFrames, so the rest of the port (and a machine without pandas) can use
:class:`FeatureBundle` directly.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from fairmultimodal_torch import LABEL_COLUMNS

__all__ = ["FeatureBundle", "assemble_features", "zscore", "compute_pos_weights",
           "get_age_bucket", "map_ethnicity", "map_insurance", "CohortInputError",
           "validate_common_frames"]

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


def get_age_bucket(age) -> str:
    """10_FAME.py:644-658."""
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
    elif 70 <= age <= 89:
        return "70-89"
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


def validate_common_frames(structured, unstructured) -> None:
    """Fail fast, naming the table and column, before any featurization."""
    problems: List[str] = []
    labels = list(LABEL_COLUMNS)
    for key in ("subject_id", "hadm_id"):
        if key not in structured.columns:
            problems.append(f"structured table: missing merge key '{key}'")
        if key not in unstructured.columns:
            problems.append(f"unstructured table: missing merge key '{key}'")
    for col in labels:
        if col not in structured.columns:
            problems.append(f"structured table: missing label column '{col}'")
        elif structured[col].isna().any():
            problems.append(f"structured table: label column '{col}' has "
                            f"{int(structured[col].isna().sum())} NaN rows "
                            f"(labels must be 0/1)")
    if not any(c.startswith("note_") for c in unstructured.columns):
        problems.append("unstructured table: no note_* chunk columns "
                        "(expected note_chunk_1, note_chunk_2, ...)")
    if problems:
        raise CohortInputError(
            "cohort table validation failed:\n  - " + "\n  - ".join(problems))


def _is_note(v) -> bool:
    return isinstance(v, str) and bool(v.strip())


def assemble_features(structured, unstructured) -> FeatureBundle:
    """Merge + featurize the two cohort DataFrames (10_FAME.py:610-731),
    keeping the patients with at least one note chunk."""
    import pandas as pd

    label_columns = list(LABEL_COLUMNS)
    validate_common_frames(structured, unstructured)
    unstructured = unstructured.drop(
        columns=["short_term_mortality", "los_binary", "mechanical_ventilation",
                 "age", "GENDER", "ETHNICITY", "INSURANCE"],
        errors="ignore",
    )
    df = pd.merge(structured, unstructured, on=["subject_id", "hadm_id"],
                  how="inner", suffixes=("_struct", "_unstruct"))
    if df.empty:
        raise ValueError("Merged DataFrame is empty. Check your merge keys.")

    for col in label_columns:
        df[col] = df[col].astype(int)

    note_columns = [c for c in df.columns if c.startswith("note_")]
    mask = df.apply(lambda r: any(_is_note(r[c]) for c in note_columns), axis=1)
    df = df[mask].copy()

    if "age" not in df.columns:
        if "Age" in df.columns:
            df = df.rename(columns={"Age": "age"})
        else:
            df["age"] = 0

    # Category codes over the observed sorted values, as the reference.
    df["age"] = df["age"].apply(get_age_bucket).astype("category").cat.codes
    if "ETHNICITY" in df.columns:
        df["ETHNICITY"] = df["ETHNICITY"].apply(map_ethnicity).astype("category").cat.codes
    else:
        df["ETHNICITY"] = 0
    if "INSURANCE" in df.columns:
        df["INSURANCE"] = df["INSURANCE"].apply(map_insurance).astype("category").cat.codes
    else:
        df["INSURANCE"] = 0
    if "GENDER" in df.columns:
        df["GENDER"] = df["GENDER"].astype("category").cat.codes
    else:
        df["GENDER"] = 0

    lab_cols = [c for c in df.columns
                if c not in EXCLUDE_COLS and not c.startswith("note_")
                and pd.api.types.is_numeric_dtype(df[c])]
    labs, _, _ = zscore(df[lab_cols].fillna(0).to_numpy(dtype=np.float32))

    chunks = [[row[c] for c in note_columns if _is_note(row[c])]
              for _, row in df.iterrows()]

    return FeatureBundle(
        subject_id=df["subject_id"].to_numpy(np.int64),
        age_codes=df["age"].to_numpy(np.int32),
        gender_codes=df["GENDER"].to_numpy(np.int32),
        ethnicity_codes=df["ETHNICITY"].to_numpy(np.int32),
        insurance_codes=df["INSURANCE"].to_numpy(np.int32),
        labs=labs,
        labels=df[label_columns].to_numpy(np.float32),
        lab_columns=lab_cols,
        note_chunks=chunks,
    )
