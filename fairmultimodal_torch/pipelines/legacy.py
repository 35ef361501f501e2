"""The legacy-generation experiments (port of
``fairmultimodal_tpu/pipelines/legacy.py``), without pandas.

- :func:`run_legacy_behrt_experiment` -- the sequence BEHRT of
  FinalCode/New/02_BEHRT.py: one "disease" token per admission (its
  ``hadm_id`` mapped to an index in first-appearance order, :25-27), the
  6-hour time-to-discharge / death filter (:81-84), raw per-admission ages
  fed to an ``nunique + 1`` table (:96, 245), segment ids alternating 0 / 1
  (:98), per-patient labels the max over the admissions (:110-112); BCE with
  ``n / (2 positives)`` weights over the whole filtered cohort and AdamW at
  1e-5 (weight decay 0.01).
- :func:`run_legacy_eddi_experiment` -- the EDDI-dot fusion era
  (FinalCode/Code/EDDI.py): BEHRT-Demo + BEHRT-Lab + the text embedding at
  ``max_length`` 128 through :class:`~fairmultimodal_torch.models.legacy.
  LegacyEDDIFull`, two tasks (mortality -- ``mortality_30d_post_discharge``
  where the table has it -- and readmission within 30 days, either spelling
  of its column), the focal loss (gamma 2) with clip-10 neg/pos weights over
  the whole cohort, the clip at 1.0, Adam at 1e-5 (EDDI.py:53, 346,
  536-539).  On the card the lab encoder runs #1-#4.

Both split the cohort by iterstrat (test 0.2, then validation 0.05 of the
rest) or, with ``reference_compat``, train and evaluate on the whole cohort
as the reference does (its only loader, New/02_BEHRT.py:173).
:func:`prepare_admission_sequences` reproduces the JAX function's pandas
steps on a port table (or a DataFrame) index for index: category codes over
the sorted observed values (-1 for a missing one), the stable sort on
subject and ``ADMITTIME``, the groups in subject order.  Time columns are
``datetime64`` arrays or ISO-8601 strings (as a CSV holds them); an
unparsable ``DEATHTIME`` counts as missing (``errors="coerce"``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from fairmultimodal_torch.data.featurize import (_category_codes, as_table,
                                                 assemble_features, compute_pos_weights,
                                                 map_ethnicity)
from fairmultimodal_torch.data.table import is_missing, num_rows, take_rows
from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.behrt import _round_up
from fairmultimodal_torch.models.legacy import BEHRTSequence, LegacyEDDIFull
from fairmultimodal_torch.models.text import TextEncoder, encode_note_chunks
from fairmultimodal_torch.pipelines.common import (StageTimer, build_arrays, evaluate_test,
                                                   make_loaders, make_split,
                                                   pos_weight_neg_over_pos, torch_dtype)
from fairmultimodal_torch.train.simple import MultitaskTrainer, SimpleTrainConfig

__all__ = ["LegacyBEHRTPipelineConfig", "run_legacy_behrt_experiment",
           "LegacyEDDIPipelineConfig", "run_legacy_eddi_experiment",
           "prepare_admission_sequences", "LEGACY_TASKS"]

_SEQ_KEYS = ("disease_ids", "age_ids", "segment_ids", "adm_loc_ids", "disch_loc_ids",
             "gender_ids", "ethnicity_ids", "insurance_ids")
_SEQ_SENSITIVE = (("age", "sens_age"), ("ethnicity", "sens_ethnicity"),
                  ("insurance", "sens_insurance"))
_NAT = np.iinfo(np.int64).min


def _nanoseconds(column: np.ndarray, coerce: bool = False) -> np.ndarray:
    """A time column -> int64 nanoseconds, ``_NAT`` where missing.  Objects
    may be ``str`` (ISO 8601), ``datetime`` / ``pd.Timestamp`` or missing;
    with ``coerce`` an unparsable string is missing too."""
    if column.dtype.kind == "M":
        return column.astype("datetime64[ns]").astype(np.int64)
    out = np.empty(len(column), np.int64)
    for i, v in enumerate(column.tolist()):
        if is_missing(v):
            out[i] = _NAT
            continue
        to64 = getattr(v, "to_datetime64", None)
        try:
            t = to64() if to64 is not None else np.datetime64(
                v.strip() if isinstance(v, str) else v)
        except ValueError:
            if not coerce:
                raise
            t = np.datetime64("NaT")
        out[i] = t.astype("datetime64[ns]").astype(np.int64)
    return out


def _hours(later: np.ndarray, earlier: np.ndarray) -> np.ndarray:
    """``(later - earlier).dt.total_seconds() / 3600``: NaN where either is
    missing."""
    bad = (later == _NAT) | (earlier == _NAT)
    return np.where(bad, np.nan, (later - earlier) / 1e9) / 3600


def _nunique(values: np.ndarray) -> int:
    """``Series.nunique()``: distinct non-missing values."""
    return len({v for v in values.tolist() if not is_missing(v)})


def _sort_key(v):
    return (1, 0) if is_missing(v) else (0, v)


def prepare_admission_sequences(table, pad_multiple: int = 8):
    """New/02_BEHRT.py:85-172's data prep as arrays: (``_SEQ_KEYS`` ->
    [N, S] int32 with pad 0, labels [N, 3] float32, sensitive codes of each
    patient's first admission, vocab sizes).  S is the longest sequence
    rounded up to ``pad_multiple``.  The pad id 0 is also the first mapped
    admission's id, which the ``ids != 0`` mask hides, as the reference's
    does."""
    t = dict(as_table(table))
    hadm = t["hadm_id"].tolist()
    mapping: Dict = {}
    for h in hadm:                      # hadm_id -> index in first-appearance order
        mapping.setdefault(h, len(mapping))
    t["mapped_disease_id"] = np.asarray([mapping[h] for h in hadm], np.int64)

    if "ADMITTIME" in t and "DISCHTIME" in t:
        admit, disch = _nanoseconds(t["ADMITTIME"]), _nanoseconds(t["DISCHTIME"])
        death = (_nanoseconds(t["DEATHTIME"], coerce=True) if "DEATHTIME" in t
                 else np.full(len(admit), _NAT))
        ttd, ttdeath = _hours(disch, admit), _hours(death, admit)
        mort = t["short_term_mortality"].astype(np.int64)
        t = take_rows(t, ((ttd > 6) & (mort == 0)) | ((ttdeath > 6) & (mort == 1)))

    n = num_rows(t)
    for col in ("FIRST_WARDID", "LAST_WARDID"):
        if col not in t:
            t[col] = np.zeros(n, np.int64)
    t["GENDER"] = _category_codes(t["GENDER"].tolist())
    t["INSURANCE"] = _category_codes(t["INSURANCE"].tolist())
    t["eth_code"] = (_category_codes([map_ethnicity(e) for e in t["ETHNICITY"].tolist()])
                     if "ETHNICITY" in t else np.zeros(n, np.int64))
    age = t["age"]
    if age.dtype.kind == "f":
        age = np.where(np.isnan(age), 0, age)
    elif age.dtype == object:
        age = np.asarray([0 if is_missing(a) else a for a in age.tolist()], np.float64)
    t["age"] = age.astype(np.int64)

    sort_cols = ["subject_id"] + (["ADMITTIME"] if "ADMITTIME" in t else [])
    keys = list(zip(*(t[c].tolist() for c in sort_cols)))
    order = sorted(range(n), key=lambda i: tuple(_sort_key(v) for v in keys[i]))
    t = take_rows(t, np.asarray(order, np.int64))

    subjects = t["subject_id"]
    starts = [i for i in range(n) if i == 0 or subjects[i] != subjects[i - 1]]
    bounds = list(zip(starts, starts[1:] + [n]))
    cols = {"disease_ids": "mapped_disease_id", "age_ids": "age", "adm_loc_ids": "FIRST_WARDID",
            "disch_loc_ids": "LAST_WARDID", "gender_ids": "GENDER", "ethnicity_ids": "eth_code",
            "insurance_ids": "INSURANCE"}
    max_len = max(b - a for a, b in bounds)
    S = max(_round_up(max_len, pad_multiple), pad_multiple)
    arrays = {k: np.zeros((len(bounds), S), np.int32) for k in _SEQ_KEYS}
    for p, (a, b) in enumerate(bounds):
        for key, col in cols.items():
            arrays[key][p, :b - a] = t[col][a:b].astype(np.int64)
        arrays["segment_ids"][p, :b - a] = np.arange(b - a) % 2
    label_cols = ("short_term_mortality", "los_binary", "mechanical_ventilation")
    labels = np.asarray([[int(t[c][a:b].max()) for c in label_cols] for a, b in bounds],
                        np.float32)
    firsts = np.asarray([a for a, _ in bounds], np.int64)
    sens = {"age": t["age"][firsts].astype(np.int32),
            "ethnicity": t["eth_code"][firsts].astype(np.int32),
            "insurance": t["INSURANCE"][firsts].astype(np.int32)}
    vocab = {
        "num_diseases": len(mapping),
        "num_ages": _nunique(t["age"]) + 1,                          # :245
        "num_segments": 2,
        "num_admission_locs": max(_nunique(t["FIRST_WARDID"]), 1),
        "num_discharge_locs": max(_nunique(t["LAST_WARDID"]), 1),
        "num_genders": max(_nunique(t["GENDER"]), 1),
        "num_ethnicities": max(_nunique(t["eth_code"]), 1),
        "num_insurances": max(_nunique(t["INSURANCE"]), 1),
    }
    return arrays, labels, sens, vocab


@dataclasses.dataclass
class LegacyBEHRTPipelineConfig:
    train: SimpleTrainConfig = dataclasses.field(default_factory=lambda: SimpleTrainConfig(
        lr=1e-5, num_epochs=10, batch_size=16, loss="bce", optimizer="adamw",
        weight_decay=0.01, patience=10))
    test_size: float = 0.20
    split_seed: int = 42
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    reference_compat: bool = False     # True = train == eval == the whole cohort
    dtype: str = "float32"


def run_legacy_behrt_experiment(structured, config: Optional[LegacyBEHRTPipelineConfig] = None,
                                verbose: bool = True, device=None) -> Dict:
    """The sequence-BEHRT experiment on one multi-admission table (a port
    table or a DataFrame).  ``device``: ``None`` means CUDA and raises
    without it."""
    cfg = config or LegacyBEHRTPipelineConfig()
    timer = StageTimer()
    arrays, labels, sens, vocab = prepare_admission_sequences(structured)
    if verbose:
        print(f"Patients: {len(labels)}, max sequence length: "
              f"{arrays['disease_ids'].shape[1]}, vocab: {vocab}")
    timer.mark("featurize")
    n = len(labels)
    idx = ({"train": np.arange(n), "val": np.arange(n), "test": np.arange(n)}
           if cfg.reference_compat else make_split(labels, cfg.test_size, 0.05, cfg.split_seed))
    arrays.update({f"sens_{k}": v for k, v in sens.items()})
    loaders = make_loaders(arrays, labels, idx, cfg.train.batch_size, seed=cfg.train.seed,
                           device=device)
    model = init_params(BEHRTSequence(
        **vocab, hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads, dtype=torch_dtype(cfg.dtype)),
        seed=cfg.train.seed)
    # BCE pos_weight n / (2 positives) over the whole filtered cohort: the
    # reference never splits (:267-287).
    trainer = MultitaskTrainer(model, cfg.train, pos_weight=compute_pos_weights(labels),
                               device=device)
    next(iter(loaders["train"]))        # the JAX init example's shuffle
    timer.mark("split_and_loaders")
    best, history = trainer.fit(loaders["train"], loaders["val"], verbose=verbose)
    timer.mark("train")
    _, metrics, fairness, eddi = evaluate_test(
        trainer, best, loaders["test"], ("mortality", "los", "mechanical_ventilation"),
        verbose, sensitive=_SEQ_SENSITIVE)
    timer.mark("eval")
    return {"metrics": metrics, "fairness": fairness, "eddi": eddi, "history": history,
            "best_params": best, "vocab": vocab, "splits": idx, "trainer": trainer,
            "timings": timer.result()}


LEGACY_TASKS = ("short_term_mortality", "readmission_within_30d")


@dataclasses.dataclass
class LegacyEDDIPipelineConfig:
    train: SimpleTrainConfig = dataclasses.field(default_factory=lambda: SimpleTrainConfig(
        lr=1e-5, num_epochs=5, batch_size=16, loss="focal", gamma=2.0, optimizer="adam",
        patience=10, grad_clip=1.0))
    text_model: str = "emilyalsentzer/Bio_ClinicalBERT"
    text_max_length: int = 128         # EDDI.py:109-110
    text_batch_size: int = 32
    test_size: float = 0.20
    split_seed: int = 42
    hidden_size: int = 768
    demo_layers: int = 12
    demo_heads: int = 12
    lab_layers: int = 2
    lab_heads: int = 8
    reference_compat: bool = False     # True = train == eval == the whole cohort
    dtype: str = "float32"


def run_legacy_eddi_experiment(structured, unstructured,
                               config: Optional[LegacyEDDIPipelineConfig] = None,
                               text_encoder: Optional[TextEncoder] = None, verbose: bool = True,
                               device=None) -> Dict:
    """The EDDI-dot fusion experiment on two cohort tables (port tables or
    DataFrames).  ``device``: ``None`` means CUDA and raises without it."""
    cfg = config or LegacyEDDIPipelineConfig()
    dtype = torch_dtype(cfg.dtype)
    timer = StageTimer()
    structured = as_table(structured)
    if ("readmission_within_30d" not in structured
            and "readmission_within_30_days" in structured):
        structured = {("readmission_within_30d" if k == "readmission_within_30_days" else k): v
                      for k, v in structured.items()}
    label_cols = list(LEGACY_TASKS)
    if "mortality_30d_post_discharge" in structured:
        # This era's own mortality: death within 30 days of discharge
        # (Code/1_preprocessing_structured.py:24-26).
        label_cols[0] = "mortality_30d_post_discharge"
    bundle = assemble_features(structured, unstructured, label_columns=tuple(label_cols))
    timer.mark("featurize")
    if text_encoder is None:
        text_encoder = TextEncoder.from_pretrained(cfg.text_model, dtype=dtype,
                                                   device=device)
    bundle.text_embeddings = encode_note_chunks(
        text_encoder, bundle.note_chunks, max_length=cfg.text_max_length,
        batch_size=cfg.text_batch_size)
    timer.mark("text_precompute")

    n = len(bundle.labels)
    idx = ({"train": np.arange(n), "val": np.arange(n), "test": np.arange(n)}
           if cfg.reference_compat
           else make_split(bundle.labels, cfg.test_size, 0.05, cfg.split_seed))
    keys = ("demo_dummy_ids", "demo_attn_mask", "age_ids", "gender_ids", "ethnicity_ids",
            "insurance_ids", "lab_features", "text_embedding")
    loaders = make_loaders(build_arrays(bundle, keys), bundle.labels, idx,
                           cfg.train.batch_size, seed=cfg.train.seed, device=device)
    n_ages, n_gen, n_eth, n_ins = bundle.vocab_sizes()
    model = init_params(LegacyEDDIFull(
        n_ages, n_gen, n_eth, n_ins, bundle.num_lab_features, hidden_size=cfg.hidden_size,
        demo_layers=cfg.demo_layers, demo_heads=cfg.demo_heads, lab_layers=cfg.lab_layers,
        lab_heads=cfg.lab_heads, num_tasks=len(LEGACY_TASKS),
        text_embed_size=bundle.text_embeddings.shape[1], dtype=dtype), seed=cfg.train.seed)
    # Clip-10 neg/pos weights over the whole filtered cohort (EDDI.py:53, 536-539).
    trainer = MultitaskTrainer(model, cfg.train,
                               pos_weight=pos_weight_neg_over_pos(bundle.labels, clip=10.0),
                               device=device)
    next(iter(loaders["train"]))        # the JAX init example's shuffle
    timer.mark("split_and_loaders")
    best, history = trainer.fit(loaders["train"], loaders["val"], verbose=verbose)
    timer.mark("train")
    _, metrics, fairness, eddi = evaluate_test(trainer, best, loaders["test"],
                                               ("mortality", "readmission"), verbose)
    timer.mark("eval")
    return {"metrics": metrics, "fairness": fairness, "eddi": eddi, "history": history,
            "best_params": best, "splits": idx, "trainer": trainer, "bundle": bundle,
            "timings": timer.result()}
