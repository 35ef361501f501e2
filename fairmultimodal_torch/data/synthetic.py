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


:func:`write_raw_mimic` and :func:`write_raw_mimic_scaled` write the raw
MIMIC-III-shaped ``csv.gz`` tables the ETL (:mod:`fairmultimodal_torch.data.etl`)
reads, with the JAX functions' draws in their order: the same tables, cell
for cell once parsed (time cells as ``DataFrame.to_csv`` writes them, a
``pd.Timedelta`` of a float number of hours or days truncated to
nanoseconds as pandas truncates it); only the gzip bytes may differ.
"""

from __future__ import annotations

import gzip
import os
from typing import List, Tuple

import numpy as np

from fairmultimodal_torch.data.table import (Table, frame_from_table, text_array,
                                             write_csv_table, write_rows)

__all__ = ["make_common_frames", "make_admission_frame", "write_raw_mimic",
           "write_raw_mimic_scaled"]

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


def _age_bucket(age: np.ndarray) -> np.ndarray:
    """``pd.cut(age, [14, 29, 49, 69, 89, 200], labels=...).astype(str)``:
    right-closed bins (a, b]; outside every bin "nan"."""
    i = np.searchsorted(_AGE_EDGES, age, side="left")
    inside = (i >= 1) & (i < len(_AGE_EDGES))
    return text_array([_AGE_LABELS[k - 1] if ok else "nan" for k, ok in zip(i, inside)])


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
        "GENDER": text_array(gender),
        "ETHNICITY": text_array(ethnicity),
        "INSURANCE": text_array(insurance),
        "gender": text_array(np.where(gender == "M", "male", "female")),
        "ethnicity_category": text_array(ethnicity),
        "insurance_category": text_array(insurance),
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
        **{k: text_array(v) for k, v in note_cols.items()},
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
            table[k] = text_array(v)
        else:
            table[k] = np.asarray(v, np.int64)
    return frame_from_table(table) if frames else table


_RAW_BASE = int(np.datetime64("2150-01-01", "ns").astype(np.int64))


def _td(days=0, hours=0) -> int:
    """``pd.Timedelta(days=days, hours=hours).value``: the float sum in
    seconds times 1e9, truncated, as pandas computes it."""
    return int((((days + 0 * 7) * 24 + hours) * 3600 + 0 * 60 + 0) * 1_000_000_000)


def _times(ns: List) -> np.ndarray:
    """Nanoseconds since the epoch (None for a missing time) -> datetime64[ns]."""
    return np.array([np.iinfo(np.int64).min if t is None else t for t in ns],
                    np.int64).astype("datetime64[ns]")


def _rows_table(rows: List[dict]) -> Table:
    """``pd.DataFrame(rows)``'s columns; ``*TIME`` / ``*DATE`` columns hold
    nanoseconds here."""
    table: Table = {}
    for k in rows[0]:
        v = [r[k] for r in rows]
        if k.endswith(("TIME", "DATE")):
            table[k] = _times(v)
        elif isinstance(v[0], str):
            table[k] = text_array(v)
        else:
            table[k] = np.asarray(v)
    return table


def write_raw_mimic(out_dir: str, n_subjects: int = 40, seed: int = 0) -> None:
    """Write tiny gzipped raw MIMIC-III-shaped tables into ``out_dir``:
    the columns the ETL reads, synthetic values (the JAX function's)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    sid = np.arange(1, n_subjects + 1)
    hadm = sid + 1000
    icustay = sid + 2000

    intime = [_RAW_BASE + _td(days=int(d)) for d in rng.integers(0, 300, n_subjects)]
    los_h = rng.uniform(26, 400, n_subjects)
    outtime = [t + _td(hours=float(h)) for t, h in zip(intime, los_h)]
    dob = [t - _td(days=int(365.25 * a))
           for t, a in zip(intime, rng.integers(10, 95, n_subjects))]
    death = [t + _td(days=2) if rng.random() < 0.2 else None for t in outtime]
    # Every second death lands 43 days later (past the 30-day window).
    death_rows = [i for i, d in enumerate(death) if d is not None]
    for j, i in enumerate(death_rows):
        if j % 2 == 1:
            death[i] = death[i] + _td(days=43)
    adm = [{"SUBJECT_ID": s, "HADM_ID": h, "ADMITTIME": a, "DISCHTIME": d, "DEATHTIME": x,
            "ETHNICITY": e, "INSURANCE": i}
           for s, h, a, d, x, e, i in zip(sid.tolist(), hadm.tolist(), intime, outtime, death,
                                          rng.choice(_ETHNICITIES, n_subjects).tolist(),
                                          rng.choice(_INSURANCES, n_subjects).tolist())]
    # Prior admissions (no ICU stay) for a third of subjects, gaps on both
    # sides of 30 days, from their own stream.
    rng2 = np.random.default_rng(seed + 987)
    for i in range(0, n_subjects, 3):
        gap_days = float(rng2.choice([12.0, 45.0])) + float(rng2.uniform(0, 5))
        prior_admit = intime[i] - _td(days=gap_days)
        adm.append({"SUBJECT_ID": int(sid[i]), "HADM_ID": 900_000 + i,
                    "ADMITTIME": prior_admit, "DISCHTIME": prior_admit + _td(days=2.0),
                    "DEATHTIME": None, "ETHNICITY": str(rng2.choice(_ETHNICITIES)),
                    "INSURANCE": str(rng2.choice(_INSURANCES))})
    write_csv_table(f"{out_dir}/ADMISSIONS.csv.gz", _rows_table(adm))
    write_csv_table(f"{out_dir}/PATIENTS.csv.gz", {
        "SUBJECT_ID": sid, "GENDER": text_array(rng.choice(["M", "F"], n_subjects)),
        "DOB": _times(dob)})
    write_csv_table(f"{out_dir}/ICUSTAYS.csv.gz", {
        "SUBJECT_ID": sid, "HADM_ID": hadm, "ICUSTAY_ID": icustay,
        "INTIME": _times(intime), "OUTTIME": _times(outtime)})

    # CHARTEVENTS: mix of vent itemids and feature-set-C itemids.
    rows = []
    for i in range(n_subjects):
        for _ in range(rng.integers(3, 10)):
            itemid = int(rng.choice([223849, 467, 220045, 220210, 618, 646]))
            rows.append({
                "ICUSTAY_ID": int(icustay[i]),
                "CHARTTIME": intime[i] + _td(hours=float(rng.uniform(0, 23))),
                "ITEMID": itemid,
                "VALUE": "Ventilator" if itemid == 467 else f"{rng.uniform(40, 180):.1f}",
                "VALUENUM": float(rng.uniform(40, 180)),
                "ERROR": 0,
                "SUBJECT_ID": int(sid[i]), "HADM_ID": int(hadm[i]),
            })
    write_csv_table(f"{out_dir}/CHARTEVENTS.csv.gz", _rows_table(rows))

    rows = []
    for i in range(n_subjects):
        for _ in range(rng.integers(4, 12)):
            rows.append({
                "SUBJECT_ID": int(sid[i]), "HADM_ID": int(hadm[i]),
                "CHARTTIME": intime[i] + _td(hours=float(rng.uniform(0, 23))),
                "ITEMID": int(rng.choice([51221, 50912, 50868, 51265])),
                "VALUENUM": float(rng.uniform(0.5, 40)),
            })
    write_csv_table(f"{out_dir}/LABEVENTS.csv.gz", _rows_table(rows))

    for name, items, col in [("inputevents_cv", [30008, 30023], "AMOUNT"),
                             ("inputevents_mv", [220864, 225154], "AMOUNT")]:
        rows = []
        for i in range(n_subjects):
            for _ in range(rng.integers(1, 5)):
                rows.append({
                    "SUBJECT_ID": int(sid[i]), "HADM_ID": int(hadm[i]),
                    "STARTTIME": intime[i] + _td(hours=float(rng.uniform(0, 23))),
                    "ITEMID": int(rng.choice(items)),
                    col: float(rng.uniform(1, 500)),
                })
        write_csv_table(f"{out_dir}/{name}.csv.gz", _rows_table(rows))

    write_csv_table(f"{out_dir}/OUTPUTEVENTS.csv.gz", _rows_table([
        {"SUBJECT_ID": int(sid[i]), "HADM_ID": int(hadm[i]),
         "CHARTTIME": intime[i] + _td(hours=2.0), "ITEMID": 226573,
         "VALUE": float(rng.uniform(10, 400))} for i in range(n_subjects)]))
    write_csv_table(f"{out_dir}/PRESCRIPTIONS.csv.gz", _rows_table([
        {"SUBJECT_ID": int(sid[i]), "HADM_ID": int(hadm[i]), "STARTDATE": intime[i],
         "DRUG": str(rng.choice(["Aspirin", "Metoprolol", "Bisacodyl"]))}
        for i in range(n_subjects)]))
    write_csv_table(f"{out_dir}/PROCEDUREEVENTS_MV.csv.gz", _rows_table([
        {"ICUSTAY_ID": int(icustay[i]), "STARTTIME": intime[i] + _td(hours=30.0),
         "ITEMID": int(rng.choice([227194, 225468, 225477]))}
        for i in range(0, n_subjects, 3)]))

    rows = []
    for i in range(n_subjects):
        if rng.random() < 0.9:
            n_words = int(rng.integers(20, 1200))
            day = intime[i] + _td(days=1)
            rows.append({
                "SUBJECT_ID": int(sid[i]), "HADM_ID": int(hadm[i]),
                "CHARTDATE": day - day % _NS_PER_DAY,
                "TEXT": " ".join(rng.choice(_WORDS, n_words)) + " Dr. Smith [**Name**] 1. item",
            })
    write_csv_table(f"{out_dir}/NOTEEVENTS.csv.gz", _rows_table(rows))


def _epoch_to_str(seconds: np.ndarray) -> np.ndarray:
    """'YYYY-MM-DDTHH:MM:SS' strings from epoch seconds (both ETL paths
    parse the 'T' separator)."""
    return np.asarray(seconds, "datetime64[s]").astype(str)


def write_raw_mimic_scaled(
    out_dir: str,
    n_subjects: int = 3000,
    chartevents_rows: int = 20_000_000,
    seed: int = 0,
    chunk_rows: int = 2_000_000,
    verbose: bool = True,
) -> dict:
    """Raw MIMIC-III tables at a realistic volume for ETL throughput runs:
    ``chartevents_rows`` events over ``n_subjects`` first-ICU-stay subjects,
    LABEVENTS at 1/8 of the rows, input / output events at 1/40, one long
    note per subject.  Event tables are generated vectorized and streamed to
    ``csv.gz`` ``chunk_rows`` rows at a time, so memory stays bounded.
    Itemids: ~70% feature-set-C chartevents ids, ~10% vent ids (text VALUE),
    ~20% non-whitelisted; ~2% ERROR=1 rows; times U(0, 48 h) past INTIME.
    Returns the row count of each table."""
    from fairmultimodal_torch.data.etl import FEATURE_SET_C

    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    sid = np.arange(1, n_subjects + 1, dtype=np.int64)
    hadm = sid + 1_000_000
    icustay = sid + 2_000_000

    base_s = _RAW_BASE // 10 ** 9
    intime_s = base_s + rng.integers(0, 300 * 86400, n_subjects)
    los_h = rng.uniform(26, 400, n_subjects)
    outtime_s = intime_s + (los_h * 3600).astype(np.int64)
    age_years = rng.integers(10, 95, n_subjects)
    dob_s = intime_s - (age_years * 365.25 * 86400).astype(np.int64)
    died = rng.random(n_subjects) < 0.2
    death_str = np.where(died, _epoch_to_str(outtime_s + 2 * 86400), "")

    write_csv_table(f"{out_dir}/ADMISSIONS.csv.gz", {
        "SUBJECT_ID": sid, "HADM_ID": hadm,
        "ADMITTIME": _epoch_to_str(intime_s), "DISCHTIME": _epoch_to_str(outtime_s),
        "DEATHTIME": death_str,
        "ETHNICITY": rng.choice(_ETHNICITIES, n_subjects),
        "INSURANCE": rng.choice(_INSURANCES, n_subjects)})
    write_csv_table(f"{out_dir}/PATIENTS.csv.gz", {
        "SUBJECT_ID": sid, "GENDER": rng.choice(["M", "F"], n_subjects),
        "DOB": _epoch_to_str(dob_s)})
    write_csv_table(f"{out_dir}/ICUSTAYS.csv.gz", {
        "SUBJECT_ID": sid, "HADM_ID": hadm, "ICUSTAY_ID": icustay,
        "INTIME": _epoch_to_str(intime_s), "OUTTIME": _epoch_to_str(outtime_s)})
    counts = {"ADMISSIONS": n_subjects, "PATIENTS": n_subjects, "ICUSTAYS": n_subjects}

    feat_items = np.asarray(sorted(set(FEATURE_SET_C["chartevents"])), np.int64)
    vent_items = np.asarray([223849, 467, 720, 445, 218], np.int64)
    other_items = np.asarray([999001, 999002, 999003], np.int64)

    def stream_events(name, total, make_chunk):
        written = 0
        with gzip.open(f"{out_dir}/{name}", "wt", compresslevel=1, newline="",
                       encoding="utf-8") as f:
            while written < total:
                n = min(chunk_rows, total - written)
                write_rows(f, make_chunk(n), header=written == 0)
                written += n
                if verbose:
                    print(f"  {name}: {written:,}/{total:,} rows", flush=True)
        return total

    def chartevents_chunk(n):
        subj_idx = rng.integers(0, n_subjects, n)
        kind = rng.random(n)
        items = np.where(
            kind < 0.70, feat_items[rng.integers(0, len(feat_items), n)],
            np.where(kind < 0.80, vent_items[rng.integers(0, len(vent_items), n)],
                     other_items[rng.integers(0, len(other_items), n)]))
        t = intime_s[subj_idx] + rng.integers(0, 48 * 3600, n)
        vals = rng.uniform(40, 180, n).round(1).astype(str)
        vals = np.where(items == 467, "Ventilator", vals)
        vals = np.where(items == 223849, "CMV", vals)
        return {"SUBJECT_ID": sid[subj_idx], "HADM_ID": hadm[subj_idx],
                "ICUSTAY_ID": icustay[subj_idx], "CHARTTIME": _epoch_to_str(t),
                "ITEMID": items, "VALUE": vals,
                "VALUENUM": rng.uniform(40, 180, n).round(1),
                "ERROR": (rng.random(n) < 0.02).astype(np.int64)}

    counts["CHARTEVENTS"] = stream_events("CHARTEVENTS.csv.gz", chartevents_rows,
                                          chartevents_chunk)
    lab_items = np.asarray(sorted(set(FEATURE_SET_C["labevents"])), np.int64)

    def labevents_chunk(n):
        subj_idx = rng.integers(0, n_subjects, n)
        t = intime_s[subj_idx] + rng.integers(0, 48 * 3600, n)
        return {"SUBJECT_ID": sid[subj_idx], "HADM_ID": hadm[subj_idx],
                "CHARTTIME": _epoch_to_str(t),
                "ITEMID": lab_items[rng.integers(0, len(lab_items), n)],
                "VALUENUM": rng.uniform(0.5, 40, n).round(2)}

    counts["LABEVENTS"] = stream_events("LABEVENTS.csv.gz", max(chartevents_rows // 8, 1),
                                        labevents_chunk)

    def io_chunk_factory(items, time_col, value_col):
        items = np.asarray(items, np.int64)

        def make(n):
            subj_idx = rng.integers(0, n_subjects, n)
            t = intime_s[subj_idx] + rng.integers(0, 48 * 3600, n)
            return {"SUBJECT_ID": sid[subj_idx], "HADM_ID": hadm[subj_idx],
                    time_col: _epoch_to_str(t),
                    "ITEMID": items[rng.integers(0, len(items), n)],
                    value_col: rng.uniform(1, 500, n).round(1)}
        return make

    io_rows = max(chartevents_rows // 40, 1)
    counts["inputevents_cv"] = stream_events(
        "inputevents_cv.csv.gz", io_rows,
        io_chunk_factory(FEATURE_SET_C["inputevents"][:24], "STARTTIME", "AMOUNT"))
    counts["inputevents_mv"] = stream_events(
        "inputevents_mv.csv.gz", io_rows,
        io_chunk_factory(FEATURE_SET_C["inputevents"][24:], "STARTTIME", "AMOUNT"))
    counts["OUTPUTEVENTS"] = stream_events(
        "OUTPUTEVENTS.csv.gz", io_rows,
        io_chunk_factory(FEATURE_SET_C["outputevents"], "CHARTTIME", "VALUE"))

    write_csv_table(f"{out_dir}/PRESCRIPTIONS.csv.gz", {
        "SUBJECT_ID": sid, "HADM_ID": hadm, "STARTDATE": _epoch_to_str(intime_s),
        "DRUG": rng.choice(["Aspirin", "Metoprolol", "Bisacodyl"], n_subjects)})
    pe_idx = np.arange(0, n_subjects, 3)
    write_csv_table(f"{out_dir}/PROCEDUREEVENTS_MV.csv.gz", {
        "ICUSTAY_ID": icustay[pe_idx],
        "STARTTIME": _epoch_to_str(intime_s[pe_idx] + 30 * 3600),
        "ITEMID": rng.choice([227194, 225468, 225477], len(pe_idx))})
    counts["PRESCRIPTIONS"] = n_subjects
    counts["PROCEDUREEVENTS_MV"] = len(pe_idx)

    # One long note per subject (thousands of words, as ICU discharge
    # summaries run).
    n_words = rng.integers(200, 2000, n_subjects)
    notes = [" ".join(rng.choice(_WORDS, k)) + " Dr. Smith [**Name**] 1. item" for k in n_words]
    write_csv_table(f"{out_dir}/NOTEEVENTS.csv.gz", {
        "SUBJECT_ID": sid, "HADM_ID": hadm,
        "CHARTDATE": _epoch_to_str(((intime_s + 86400) // 86400) * 86400),
        "TEXT": text_array(notes)})
    counts["NOTEEVENTS"] = n_subjects
    return counts
