"""Shared preparation stages of the baseline pipelines (port of
``fairmultimodal_tpu/pipelines/common.py``).

Every baseline script of the reference repeats one preamble: merge the two
cohort tables, featurize, precompute the text embeddings, split, build the
loaders, weigh the positive class.  :func:`prepare_experiment` is that
preamble once, parameterised by each script's deltas: the text
``max_length``, the split family, whether notes are required, the age
bucket edge, the label columns.

It takes port tables (:mod:`fairmultimodal_torch.data.table`) or DataFrames
and needs no pandas for a table.  The split families are numpy copies of
the reference's libraries: iterstrat, scikit-multilearn and scikit-learn's
stratified ``train_test_split`` (:mod:`fairmultimodal_torch.data.split`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from fairmultimodal_torch import TASKS
from fairmultimodal_torch.data.device import DeviceLoader
from fairmultimodal_torch.data.featurize import (FeatureBundle, as_table, assemble_features,
                                                 compute_pos_weights)
from fairmultimodal_torch.data.iterstrat_exact import iterative_train_test_split
from fairmultimodal_torch.data.loader import BatchIterator, NestedLoader
from fairmultimodal_torch.data.split import (reference_three_way_split,
                                             stratified_train_test_split)
from fairmultimodal_torch.data.table import head as head_rows
from fairmultimodal_torch.eval.report import eddi_report, evaluate_multitask
from fairmultimodal_torch.models.text import TextEncoder, encode_note_chunks
from fairmultimodal_torch.ops.gates import resolve_device

__all__ = ["TASK_SHORT", "EXTRA_TASK_COLUMNS", "resolve_task", "task_label_columns",
           "pos_weight_neg_over_pos", "make_split", "make_loaders", "build_arrays", "PreparedExperiment",
           "prepare_experiment", "torch_dtype", "StageTimer", "SENSITIVE", "evaluate_test"]

#: Short head names of the reference's per-task classifier layers.
TASK_SHORT = {"mortality": "mort", "los": "los", "mechanical_ventilation": "mech"}

#: Single-task labels outside the three-task space: task -> structured column.
#: "readmission" is the readmission-only text regime of the Uni_label_run
#: generation (Readmit_Biobert_2(1).py).
EXTRA_TASK_COLUMNS = {"readmission": "readmission_within_30d"}

#: The reports' sensitive attributes and the model-input arrays that hold them.
SENSITIVE = (("age", "age_ids"), ("ethnicity", "ethnicity_ids"),
             ("insurance", "insurance_ids"))


class StageTimer:
    """Host-clock seconds per pipeline stage: :meth:`mark` charges the time
    since the previous mark to ``stage``.  ``timings`` holds stages already
    spent.  The result dicts' ``timings`` (the port's; the JAX baselines
    return none): featurize, text_precompute, split_and_loaders, train, eval,
    artifacts (FAME: calibrate_and_eval), total."""

    def __init__(self, timings: Optional[Dict[str, float]] = None):
        self.timings: Dict[str, float] = dict(timings or {})
        self._t0 = time.perf_counter()

    def mark(self, stage: str) -> None:
        now = time.perf_counter()
        self.timings[stage] = self.timings.get(stage, 0.0) + (now - self._t0)
        self._t0 = now

    def result(self) -> Dict[str, float]:
        return {**self.timings, "total": sum(self.timings.values())}


def torch_dtype(name: str) -> torch.dtype:
    """A pipeline config's ``dtype`` string -> the compute dtype."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def task_label_columns(task: Optional[str]):
    """Label-column override for :func:`prepare_experiment` (None for the
    three-task label space)."""
    if task in EXTRA_TASK_COLUMNS:
        return (EXTRA_TASK_COLUMNS[task],)
    return None


def resolve_task(task: Optional[str], allow_extra: bool = False):
    """Optional single-task selection -> (task_names, task_index).

    ``None`` is the three-task regime; a task name trains one label with one
    head.  ``allow_extra`` also accepts :data:`EXTRA_TASK_COLUMNS` tasks,
    whose label comes from another column (``task_index`` is then None: the
    bundle is already single-column)."""
    if task is None:
        return tuple(TASKS), None
    if allow_extra and task in EXTRA_TASK_COLUMNS:
        return (task,), None
    if task not in TASKS:
        raise ValueError(f"unknown task {task!r}; expected one of {TASKS}")
    return (task,), list(TASKS).index(task)


def pos_weight_neg_over_pos(labels: np.ndarray, clip: Optional[float] = None) -> np.ndarray:
    """Per-task neg/pos positive weight (01_BEHRT.py:204-211), 1.0 for a task
    without positives; ``clip`` caps it (10 in 02-09)."""
    labels = np.asarray(labels)
    out = []
    for i in range(labels.shape[1]):
        pos = labels[:, i].sum()
        w = ((len(labels) - pos) / pos) if pos > 0 else 1.0
        if clip is not None:
            w = min(w, clip)
        out.append(w)
    return np.asarray(out, np.float32)


def make_split(labels: np.ndarray, test_size: float, val_size: float, seed: int,
               method: str = "iterstrat") -> Dict[str, np.ndarray]:
    """Two-stage split into train / val / test indices.  ``method``:

    - "iterstrat": iterstrat's MultilabelStratifiedShuffleSplit, index-exact
      (01/07/08/10); ``val_size`` is a fraction of train+val;
    - "skmultilearn": order-2 iterative stratification (02), the val
      fraction ``val_size / (1 - test_size)`` of train+val, so val is
      ``val_size`` of the whole cohort;
    - "sklearn": scikit-learn's stratified ``train_test_split`` on the
      mortality column (09_multimodal_sigmoid_fusion.py:592-593), each set
      sorted.
    """
    if method == "sklearn":
        strat = labels[:, 0]
        rest, test = stratified_train_test_split(strat, test_size, seed)
        rel_train, rel_val = stratified_train_test_split(strat[rest], val_size, seed)
        return {"train": np.sort(rest[rel_train]), "val": np.sort(rest[rel_val]),
                "test": np.sort(test)}
    if method == "skmultilearn":
        train_val, test = iterative_train_test_split(labels, test_size, seed)
        rel_train, rel_val = iterative_train_test_split(labels[train_val],
                                                        val_size / (1.0 - test_size), seed)
        return {"train": train_val[rel_train], "val": train_val[rel_val], "test": test}
    if method != "iterstrat":
        raise ValueError(f"unknown split method {method!r}")
    train, val, test = reference_three_way_split(labels, test_size, val_size, seed=seed)
    return {"train": train, "val": val, "test": test}


def make_loaders(arrays: Dict[str, np.ndarray], labels: np.ndarray,
                 idx: Dict[str, np.ndarray], batch_size: int, seed: int = 42,
                 device_data: bool = True, device=None, mesh=None):
    """Per-split loaders over the model-input ``arrays``; the train split is
    shuffled.  ``device_data=True`` parks each split's arrays on ``device``
    once and gathers batches there (:class:`DeviceLoader`; under a
    data-parallel ``mesh``, each rank its rows); False gives host loaders
    whose batches the trainer shards and copies to the device."""
    loaders = {}
    for split, indices in idx.items():
        flat = {k: v[indices] for k, v in arrays.items()}
        shuffle = split == "train"
        if device_data:
            loaders[split] = DeviceLoader(flat, labels[indices], batch_size, shuffle=shuffle,
                                          seed=seed, device=device, mesh=mesh)
        else:
            flat["labels"] = labels[indices]
            loaders[split] = NestedLoader(
                BatchIterator(flat, batch_size, shuffle=shuffle, seed=seed), tuple(arrays))
    return loaders


@dataclasses.dataclass
class PreparedExperiment:
    bundle: FeatureBundle
    arrays: Dict[str, np.ndarray]
    idx: Dict[str, np.ndarray]
    loaders: Dict[str, object]
    pos_weight: np.ndarray
    text_encoder: Optional[TextEncoder]

    def vocab_sizes(self):
        return self.bundle.vocab_sizes()


def build_arrays(bundle: FeatureBundle,
                 keys: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """FeatureBundle -> the model-input arrays named in ``keys`` (FAME's:
    10_FAME:714-723); ``None`` gives every array, as the JAX function does
    (``text_embedding`` only once the notes are encoded).  The ward columns
    are zeros, as the reference's when they are absent (07:579-589);
    ``demo_features`` is the [N, 4] float32 code matrix (age, gender,
    ethnicity, insurance) FairEHR-CLP takes (06:439-441); ``text_embedding``
    needs the encoded notes."""
    n = bundle.num_patients
    make = {
        "demo_dummy_ids": lambda: np.zeros((n, 1), np.int32),
        "demo_attn_mask": lambda: np.ones((n, 1), np.int32),
        "age_ids": lambda: bundle.age_codes.astype(np.int32),
        "gender_ids": lambda: bundle.gender_codes.astype(np.int32),
        "ethnicity_ids": lambda: bundle.ethnicity_codes.astype(np.int32),
        "insurance_ids": lambda: bundle.insurance_codes.astype(np.int32),
        "segment_ids": lambda: np.zeros(n, np.int32),
        "adm_loc_ids": lambda: np.zeros(n, np.int32),
        "disch_loc_ids": lambda: np.zeros(n, np.int32),
        "lab_features": lambda: bundle.labs.astype(np.float32),
        "demo_features": lambda: np.stack([
            bundle.age_codes, bundle.gender_codes, bundle.ethnicity_codes,
            bundle.insurance_codes], axis=1).astype(np.float32),
        "text_embedding": lambda: bundle.text_embeddings.astype(np.float32),
    }
    if keys is None:
        keys = [k for k in make if k != "text_embedding" or bundle.text_embeddings is not None]
    return {k: make[k]() for k in keys}


_POS_WEIGHT_MODES = ("balanced", "neg_over_pos", "neg_over_pos_clip10",
                     "neg_over_pos_clip10_all", "none")


def prepare_experiment(
    structured,
    unstructured,
    *,
    model_keys: Sequence[str],
    batch_size: int,
    text_encoder: Optional[TextEncoder] = None,
    text_model: str = "emilyalsentzer/Bio_ClinicalBERT",
    text_max_length: int = 512,
    text_batch_size: int = 32,
    need_text: bool = True,
    require_notes: bool = True,
    head: Optional[int] = None,
    test_size: float = 0.20,
    val_size: float = 0.05,
    split_seed: int = 42,
    split_method: str = "iterstrat",
    pos_weight_mode: str = "balanced",
    seed: int = 42,
    age_bucket_upper: int = 89,
    task_index: Optional[int] = None,
    label_columns: Optional[Sequence[str]] = None,
    verbose: bool = True,
    dtype: torch.dtype = torch.float32,
    device=None,
    timer: Optional[StageTimer] = None,
    mesh=None,
) -> PreparedExperiment:
    """Featurize, encode the notes, split, build the loaders and the
    positive-class weights.

    ``pos_weight_mode``: "balanced" (n / 2 n_pos over train), "neg_over_pos"
    (over train), "neg_over_pos_clip10" (over train, capped at 10),
    "neg_over_pos_clip10_all" (over the whole filtered cohort, as 07-09
    compute it) or "none".  ``task_index`` keeps one label column.  The
    split arrays are parked on ``device`` (:class:`DeviceLoader`).  A text
    encoder built here takes ``dtype``.  ``timer`` is charged the
    featurize, text_precompute and split_and_loaders stages.  A
    data-parallel ``mesh`` (the JAX function's ``mesh=``) shards the text
    encode over its ranks and parks the loaders on ``mesh.device``, each
    rank gathering its rows; the trainer must take the same mesh.
    """
    if pos_weight_mode not in _POS_WEIGHT_MODES:
        raise ValueError(f"unknown pos_weight_mode {pos_weight_mode!r}")
    device = mesh.device if mesh is not None else resolve_device(device)
    timer = timer or StageTimer()
    structured = as_table(structured)
    unstructured = as_table(unstructured)
    if head:
        structured, unstructured = head_rows(structured, head), head_rows(unstructured, head)
    bundle = assemble_features(structured, unstructured, require_notes=require_notes,
                               age_bucket_upper=age_bucket_upper, label_columns=label_columns)
    if task_index is not None:
        bundle.labels = bundle.labels[:, [task_index]]
    if verbose:
        print(f"After filtering, number of rows: {bundle.num_patients}")
    timer.mark("featurize")

    if need_text:
        if text_encoder is None:
            text_encoder = TextEncoder.from_pretrained(text_model, dtype=dtype, device=device,
                                                       mesh=mesh)
        bundle.text_embeddings = encode_note_chunks(
            text_encoder, bundle.note_chunks, max_length=text_max_length,
            batch_size=text_batch_size)
        if verbose:
            print("Aggregated text embeddings shape:", bundle.text_embeddings.shape)
    timer.mark("text_precompute")

    idx = make_split(bundle.labels, test_size, val_size, split_seed, method=split_method)
    if verbose:
        print(f"Train size: {len(idx['train'])}, Validation size: {len(idx['val'])}, "
              f"Test size: {len(idx['test'])}")

    arrays = build_arrays(bundle, model_keys)
    loaders = make_loaders(arrays, bundle.labels, idx, batch_size, seed=seed, device=device,
                           mesh=mesh)

    train_labels = bundle.labels[idx["train"]]
    if pos_weight_mode == "balanced":
        pw = compute_pos_weights(train_labels)
    elif pos_weight_mode == "neg_over_pos":
        pw = pos_weight_neg_over_pos(train_labels)
    elif pos_weight_mode == "neg_over_pos_clip10":
        pw = pos_weight_neg_over_pos(train_labels, clip=10.0)
    elif pos_weight_mode == "neg_over_pos_clip10_all":
        # 03/04/06/07/08/09 weigh over the whole filtered cohort, not the
        # train split (e.g. 07_multimodal_average_fusion.py:643-647).
        pw = pos_weight_neg_over_pos(bundle.labels, clip=10.0)
    else:
        pw = np.ones(train_labels.shape[1], np.float32)
    timer.mark("split_and_loaders")

    return PreparedExperiment(bundle=bundle, arrays=arrays, idx=idx, loaders=loaders,
                              pos_weight=pw, text_encoder=text_encoder)


def evaluate_test(trainer, best: Dict, loader, task_names,
                  verbose: bool, auprc_mode: str = "ap", sensitive=SENSITIVE):
    """Load the best state, predict the test loader and report: (test
    predictions, metrics, EO blocks, EDDI report).  ``sensitive``: the
    (attribute, model-input key) pairs of the groups."""
    trainer.model.load_state_dict(best)
    test = trainer.predict(loader, extra_keys=tuple(k for _, k in sensitive))
    groups = {a: test[k] for a, k in sensitive}
    metrics, fairness = evaluate_multitask(test["logits"], test["labels"], groups, 0.5,
                                           verbose=verbose, task_names=task_names,
                                           auprc_mode=auprc_mode)
    eddi = eddi_report(test["logits"], test["labels"], groups, 0.5, task_names=task_names,
                       verbose=verbose)
    return test, metrics, fairness, eddi
