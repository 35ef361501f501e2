"""Synthetic cohort tables (port of ``make_common_frames`` in
``fairmultimodal_tpu/data/synthetic.py``), built with numpy alone.

:func:`make_common_frames` makes the same draws from the same
``np.random.default_rng(seed)`` in the same order as the JAX function and
returns the two cohort tables (``final_structured_common.csv`` /
``final_unstructured_common.csv`` columns) as port tables
(:mod:`fairmultimodal_torch.data.table`): the same column names in the same
order and the same values, text columns as object arrays with ``None``
where the DataFrame holds NaN.  ``frames=True`` returns DataFrames, where
pandas exists.

:func:`make_admission_frame` is the legacy sequence BEHRT's multi-admission
table, with the JAX function's draws in its order; its time columns are
``datetime64[ns]`` arrays (``NaT`` for a missing ``DEATHTIME``), each value
the instant the JAX DataFrame holds.

Not ported here: ``write_raw_mimic`` (the ETL slice, ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from fairmultimodal_torch.data.table import Table, frame_from_table

__all__ = ["make_common_frames", "make_admission_frame"]

# The JAX module's word lists, copied.
_ETHNICITIES = [
    "WHITE", "BLACK/AFRICAN AMERICAN", "HISPANIC OR LATINO", "ASIAN",
    "WHITE - RUSSIAN", "OTHER", "UNKNOWN/NOT SPECIFIED",
]
_INSURANCES = ["Medicare", "Private", "Medicaid", "Self Pay", "Government"]
_WORDS = (
    "patient stable intubated sedated ventilator weaning afebrile lungs clear "
    "bilateral infiltrates sepsis pressors lasix cardiac failure renal improving "
    "deteriorating family meeting comfort care extubated alert oriented pain "
    "controlled discharge planning"
).split()
_AGE_EDGES = np.array([14, 29, 49, 69, 89, 200])
_AGE_LABELS = ["15-29", "30-49", "50-69", "70-89", "Other"]
_NS_PER_HOUR, _NS_PER_DAY = 3600 * 10 ** 9, 86400 * 10 ** 9
_ADMISSION_BASE = np.datetime64("2150-01-01", "ns")


def _text(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = [None if v is None else str(v) for v in values]
    return out


def _age_bucket(age: np.ndarray) -> np.ndarray:
    """``pd.cut(age, [14, 29, 49, 69, 89, 200], labels=...).astype(str)``:
    right-closed bins (a, b]; outside every bin "nan"."""
    i = np.searchsorted(_AGE_EDGES, age, side="left")
    inside = (i >= 1) & (i < len(_AGE_EDGES))
    return _text([_AGE_LABELS[k - 1] if ok else "nan" for k, ok in zip(i, inside)])


def make_common_frames(n_patients: int = 240, n_lab_features: int = 32,
                       n_note_chunks: int = 3, seed: int = 0,
                       frames: bool = False) -> Tuple[Table, Table]:
    """(structured_common, unstructured_common) with learnable label
    structure: labels from a linear signal over a few lab columns plus an age
    gradient and noise; notes of 8-39 words from a fixed list with weak
    per-task marker words; every 37th patient without notes."""
    rng = np.random.default_rng(seed)
    subject_id = np.arange(10_000, 10_000 + n_patients)
    hadm_id = subject_id + 50_000

    age = rng.integers(15, 91, n_patients)
    gender = rng.choice(["M", "F"], n_patients)
    ethnicity = rng.choice(_ETHNICITIES, n_patients)
    insurance = rng.choice(_INSURANCES, n_patients)

    labs = rng.normal(0, 1, (n_patients, n_lab_features)).astype(np.float32)
    w = np.zeros(n_lab_features)
    w[:4] = [1.5, -1.2, 0.9, 0.7]
    age_sig = 0.03 * (age - 52.0)
    logit_mort = labs @ w - 1.2 + age_sig + 0.3 * rng.normal(size=n_patients)
    logit_los = labs @ np.roll(w, 4) - 0.4 + age_sig + 0.3 * rng.normal(size=n_patients)
    logit_vent = labs @ np.roll(w, 8) + 0.8 + 0.3 * rng.normal(size=n_patients)
    mort = (1 / (1 + np.exp(-logit_mort)) > 0.5).astype(np.int64)
    los = (1 / (1 + np.exp(-logit_los)) > 0.5).astype(np.int64)
    vent = (1 / (1 + np.exp(-logit_vent)) > 0.5).astype(np.int64)
    logit_readm = labs @ np.roll(w, 2) - 0.9 + 0.3 * rng.normal(size=n_patients)
    readm = (1 / (1 + np.exp(-logit_readm)) > 0.5).astype(np.int64)

    structured: Table = {
        "subject_id": subject_id,
        "hadm_id": hadm_id,
        "age": age,
        "GENDER": _text(gender),
        "ETHNICITY": _text(ethnicity),
        "INSURANCE": _text(insurance),
        "gender": _text(np.where(gender == "M", "male", "female")),
        "ethnicity_category": _text(ethnicity),
        "insurance_category": _text(insurance),
        "age_bucket": _age_bucket(age),
        "icu_los": rng.uniform(20, 400, n_patients),
        "short_term_mortality": mort,
        "los_binary": los,
        "mechanical_ventilation": vent,
        "readmission_within_30d": readm,
    }
    for i in range(n_lab_features):
        structured[f"lab_t{50800 + i}"] = labs[:, i]

    note_cols = {}
    for k in range(n_note_chunks):
        texts = []
        for i in range(n_patients):
            if k > 0 and rng.random() < 0.4:
                texts.append(None)        # ragged chunk counts
                continue
            n_words = rng.integers(8, 40)
            words = list(rng.choice(_WORDS, n_words))
            if vent[i] and rng.random() < 0.8:
                words += ["intubated", "ventilator"]
            if mort[i] and rng.random() < 0.8:
                words += ["unresponsive", "expired"]
            if los[i] and rng.random() < 0.8:
                words += ["prolonged", "tracheostomy"]
            texts.append(" ".join(words))
        note_cols[f"note_chunk_{k + 1}"] = texts
    for i in range(0, n_patients, 37):   # patients with no notes at all
        for k in range(n_note_chunks):
            note_cols[f"note_chunk_{k + 1}"][i] = None

    unstructured: Table = {
        "subject_id": subject_id,
        "hadm_id": hadm_id,
        "short_term_mortality": mort,
        "los_binary": los,
        "mechanical_ventilation": vent,
        "age": age,
        **{k: _text(v) for k, v in note_cols.items()},
    }
    if frames:
        return frame_from_table(structured), frame_from_table(unstructured)
    return structured, unstructured


def make_admission_frame(n_subjects: int = 80, max_admissions: int = 4, seed: int = 0,
                         frames: bool = False) -> Table:
    """One row per admission for the legacy sequence BEHRT
    (FinalCode/New/02_BEHRT.py): ``ADMITTIME`` / ``DISCHTIME`` /
    ``DEATHTIME``, ``FIRST_WARDID`` / ``LAST_WARDID``, the demographics and
    the three labels, which carry a weak signal through the ward ids.  A
    discharge ``h`` hours after admission is ``int(h * 3600 * 1e9)``
    nanoseconds later, as ``pd.Timedelta(hours=h)`` truncates it."""
    rng = np.random.default_rng(seed)
    cols = {k: [] for k in ("subject_id", "hadm_id", "ADMITTIME", "DISCHTIME", "DEATHTIME",
                            "FIRST_WARDID", "LAST_WARDID", "age", "GENDER", "ETHNICITY",
                            "INSURANCE", "short_term_mortality", "los_binary",
                            "mechanical_ventilation")}
    hadm = 90_000
    for s in range(n_subjects):
        n_adm = int(rng.integers(1, max_admissions + 1))
        age = int(rng.integers(15, 90))
        gender = str(rng.choice(["M", "F"]))
        eth = str(rng.choice(_ETHNICITIES))
        ins = str(rng.choice(_INSURANCES))
        risk = float(rng.normal())
        for a in range(n_adm):
            hadm += 1
            admit = (int(rng.integers(0, 900)) + 30 * a) * _NS_PER_DAY
            disch = admit + int(float(rng.uniform(10, 300)) * 3600 * 1e9)
            ward = int(rng.integers(1, 20))
            mort = int(risk + 0.15 * ward / 10 + rng.normal(0, 0.6) > 1.0)
            row = {"subject_id": 20_000 + s, "hadm_id": hadm, "ADMITTIME": admit,
                   "DISCHTIME": disch, "DEATHTIME": disch + _NS_PER_DAY if mort else None,
                   "FIRST_WARDID": ward, "LAST_WARDID": int(rng.integers(1, 20)), "age": age,
                   "GENDER": gender, "ETHNICITY": eth, "INSURANCE": ins,
                   "short_term_mortality": mort,
                   "los_binary": int(risk + rng.normal(0, 0.6) > 0.3),
                   "mechanical_ventilation": int(-risk + rng.normal(0, 0.6) > -0.4)}
            for k, v in row.items():
                cols[k].append(v)
    table: Table = {}
    for k, v in cols.items():
        if k.endswith("TIME"):
            # int64's least value is NaT, which the sum keeps.
            ns = np.asarray([np.iinfo(np.int64).min if t is None else t for t in v], np.int64)
            table[k] = _ADMISSION_BASE + ns.astype("timedelta64[ns]")
        elif k in ("GENDER", "ETHNICITY", "INSURANCE"):
            table[k] = _text(v)
        else:
            table[k] = np.asarray(v, np.int64)
    return frame_from_table(table) if frames else table
