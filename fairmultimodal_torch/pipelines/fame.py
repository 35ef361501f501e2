"""The FAME experiment (port of ``fairmultimodal_tpu/pipelines/fame.py``;
reference: 10_FAME.py run_experiment, :606-918).

Stages: featurize -> batched text precompute -> splits -> fixed-shape
loaders -> ``FAMETrainer.fit`` (dynamic fairness weights) -> threshold
calibration -> test evaluation + EDDI report -> artifacts (best params in
the JAX package's npz format, dynamic-weights CSV, extracted vectors npz,
tracked npy), with the JAX function's prints, ``timings`` keys and result
dict.

The pipeline is split in two: :func:`run_fame_bundle` starts from a
:class:`FeatureBundle`; :func:`run_fame_experiment` takes the two cohort
tables (port tables, :mod:`fairmultimodal_torch.data.table`, or
DataFrames), featurizes them and calls it.  Neither needs pandas for a port
table.  ``checkpoint_dir`` makes ``fit`` save a train-state file per epoch
there and resume from the latest one.

``FAMEPipelineConfig.mesh`` (a :class:`~fairmultimodal_torch.parallel.Mesh`,
from ``get_mesh`` in each rank's process) runs the experiment on every rank
of the mesh: the text encode, the loaders and the trainer split their
batches over the data axis, every rank computes the same splits, metrics and
thresholds, and rank 0 alone prints and writes the artifacts.  With a model
axis (``model > 1``) the FAME model is sharded by
:func:`~fairmultimodal_torch.parallel.shard_params_tp` before training, as
the JAX command line's help promises; the JAX pipeline never calls it, so
there the model axis holds replicas that repeat each other's work.  The
results are the same; the best state and the npz hold the full parameters.

Reference bug handled here: ``10_FAME.py:744-755`` indexes the full-cohort
tensors with indices *relative to the train_val subframe*, silently training
on the wrong rows.  Default mode maps everything to absolute indices;
``reference_compat=True`` reproduces the buggy indexing for log-parity runs.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from fairmultimodal_torch.data.featurize import (
    FeatureBundle,
    as_table,
    assemble_features,
    compute_pos_weights,
)
from fairmultimodal_torch.data.table import head
from fairmultimodal_torch.eval.report import eddi_report, evaluate_multitask
from fairmultimodal_torch.interop import flax_params
from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.fusion import FAMEModel
from fairmultimodal_torch.models.text import TextEncoder, encode_note_chunks
from fairmultimodal_torch.ops.gates import resolve_device
from fairmultimodal_torch.parallel.sharding import load_full_state_dict, shard_params_tp
from fairmultimodal_torch.pipelines.common import (StageTimer, build_arrays, make_loaders,
                                                   make_split)
from fairmultimodal_torch.train.calibrate import calibrate_thresholds
from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig
from fairmultimodal_torch.utils.checkpoint import Checkpointer, save_params_npz

__all__ = ["FAMEPipelineConfig", "FAME_KEYS", "build_model_arrays", "run_fame_bundle",
           "run_fame_experiment"]

#: FAMEModel's inputs (10_FAME:714-723), as :func:`build_arrays` names them.
FAME_KEYS = ("demo_dummy_ids", "demo_attn_mask", "age_ids", "gender_ids", "ethnicity_ids",
             "insurance_ids", "lab_features", "text_embedding")


def build_model_arrays(bundle: FeatureBundle) -> Dict[str, np.ndarray]:
    """FeatureBundle -> flat dict of FAME's model input arrays (10_FAME:714-723)."""
    return build_arrays(bundle, FAME_KEYS)


@dataclasses.dataclass
class FAMEPipelineConfig:
    """The JAX config's fields.  ``mesh``: a ``data x model`` mesh."""

    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    text_model: str = "emilyalsentzer/Bio_ClinicalBERT"
    text_max_length: int = 512
    text_batch_size: int = 128
    test_size: float = 0.20
    val_size: float = 0.05
    split_seed: int = 42
    out_dir: str = "."
    head: Optional[int] = None        # 05_FPM-style .head(n) subsample of the tables
    reference_compat: bool = False
    # 10_FAME.py:283-285 quirk: the mortality row's dynamic weights scale all
    # three tasks' fusions.  False = per-task weight rows (the fixed mode).
    reference_weight_compat: bool = True
    # A missing pretrained Bio_ClinicalBERT is fatal instead of the loud
    # random-init fallback (real-data runs should set this).
    require_hf_weights: bool = False
    # Print a per-phase wall-clock block at the end; timings are always
    # returned in the result dict under "timings".
    timing: bool = False
    mesh: Optional[object] = None
    # Park split arrays on the device and gather batches there (data/device.py);
    # False runs BatchIterator + PrefetchLoader.  The batches are bit-identical.
    device_data: bool = True
    save_artifacts: bool = True
    checkpoint_dir: Optional[str] = None
    # Tiny-model overrides for CPU smoke runs (defaults = reference sizes).
    hidden_size: int = 768
    demo_layers: int = 12
    demo_heads: int = 12
    lab_layers: int = 2
    lab_heads: int = 8
    fusion_hidden: int = 512
    dtype: str = "float32"


def _check_config(cfg: FAMEPipelineConfig) -> None:
    mesh = cfg.mesh
    if mesh is not None and mesh.world > 1 and mesh.group is None:
        raise ValueError(f"mesh {mesh.data}x{mesh.model} has no process group: build it with "
                         "parallel.get_mesh in each rank")


def run_fame_bundle(bundle: FeatureBundle, config: Optional[FAMEPipelineConfig] = None,
                    text_encoder: Optional[TextEncoder] = None, verbose: bool = True,
                    device=None, timings: Optional[Dict[str, float]] = None) -> Dict:
    """Train + evaluate full FAME from a featurized cohort (no pandas).

    ``device``: ``None`` means CUDA and raises without it (under a mesh,
    ``mesh.device``).  ``timings`` holds stage times already spent (the
    DataFrame front passes its ``featurize`` time).  Returns the JAX
    function's result dict; its ``best_params`` is the best state dict,
    loaded into ``trainer.model``.
    """
    cfg = config or FAMEPipelineConfig()
    _check_config(cfg)
    if cfg.head:
        raise ValueError("head subsamples the cohort tables: run_fame_experiment applies it")
    mesh = cfg.mesh
    device = mesh.device if mesh is not None else resolve_device(device)
    rank0 = mesh is None or mesh.rank == 0
    verbose = verbose and rank0
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    timer = StageTimer(timings or {"featurize": 0.0})
    if verbose:
        print(f"After filtering, number of rows: {bundle.num_patients}")
        print(f"Number of lab feature columns: {bundle.num_lab_features}")

    # Text precompute (frozen encoder), batched.
    if text_encoder is None:
        text_encoder = TextEncoder.from_pretrained(
            cfg.text_model, dtype=dtype, require_weights=cfg.require_hf_weights,
            device=device, mesh=mesh)
    bundle.text_embeddings = encode_note_chunks(
        text_encoder, bundle.note_chunks, max_length=cfg.text_max_length,
        batch_size=cfg.text_batch_size)
    if verbose:
        print("Aggregated text embeddings shape:", bundle.text_embeddings.shape)
    timer.mark("text_precompute")

    # Two-stage multilabel stratified split (10_FAME:733-742).
    idx = make_split(bundle.labels, cfg.test_size, cfg.val_size, cfg.split_seed)
    if cfg.reference_compat:
        # Reproduce 10_FAME.py:744-755: positions within train+val applied
        # to the full-cohort tensors.
        train_val = np.union1d(idx["train"], idx["val"])
        idx["train"], idx["val"] = (np.searchsorted(train_val, idx[s]) for s in ("train", "val"))
    train_idx, val_idx, test_idx = idx["train"], idx["val"], idx["test"]
    if verbose:
        print(f"Train size: {len(train_idx)}, Validation size: {len(val_idx)}, "
              f"Test size: {len(test_idx)}")

    loaders = make_loaders(build_model_arrays(bundle), bundle.labels, idx,
                           cfg.train.batch_size, seed=cfg.train.seed,
                           device_data=cfg.device_data, device=device, mesh=mesh)

    pos_weight = compute_pos_weights(bundle.labels[train_idx])
    n_ages, n_genders, n_eth, n_ins = bundle.vocab_sizes()
    if verbose:
        print("NUM_AGES:", n_ages, "NUM_GENDERS:", n_genders,
              "NUM_ETHNICITIES:", n_eth, "NUM_INSURANCES:", n_ins)
        print("NUM_LAB_FEATURES (tokens):", bundle.num_lab_features)

    geometry = {
        "num_ages": n_ages, "num_genders": n_genders,
        "num_ethnicities": n_eth, "num_insurances": n_ins,
        "lab_token_count": bundle.num_lab_features,
        "text_embed_size": int(bundle.text_embeddings.shape[1]),
        "hidden_size": cfg.hidden_size, "demo_layers": cfg.demo_layers,
        "demo_heads": cfg.demo_heads, "lab_layers": cfg.lab_layers,
        "lab_heads": cfg.lab_heads, "fusion_hidden": cfg.fusion_hidden,
        "reference_weight_compat": cfg.reference_weight_compat,
    }
    model = init_params(FAMEModel(**geometry, dtype=dtype), seed=cfg.train.seed)
    if mesh is not None and mesh.model > 1:
        shard_params_tp(model, mesh)

    os.makedirs(cfg.out_dir, exist_ok=True)
    trainer = FAMETrainer(
        model, cfg.train, pos_weight, rngs_seed=cfg.train.seed, device=device,
        dynamic_weights_csv=os.path.join(cfg.out_dir, "dynamic_weights_per_epoch1.csv")
        if cfg.save_artifacts else None, mesh=mesh)

    timer.mark("split_and_loaders")
    checkpointer = Checkpointer(cfg.checkpoint_dir, mesh=mesh) if cfg.checkpoint_dir else None
    best_params, history = trainer.fit(loaders["train"], loaders["val"], verbose=verbose,
                                       checkpointer=checkpointer)
    # Every pass below reads the best state, as the JAX pipeline passes best_params.
    load_full_state_dict(model, best_params)
    timer.mark("train")

    # Threshold calibration on validation (10_FAME:868).
    _, val_logits, val_labels = trainer.validate(loaders["val"])
    thresholds = calibrate_thresholds(1 / (1 + np.exp(-val_logits)), val_labels)
    if verbose:
        print("\nOptimal thresholds from validation:")
        for k, v in thresholds.items():
            print(f"{k}: {v:.2f}")

    test_out = trainer.predict_logits(loaders["test"])
    sensitive = {"age": test_out["age"], "ethnicity": test_out["ethnicity"],
                 "insurance": test_out["insurance"]}
    metrics, fairness = evaluate_multitask(
        test_out["logits"], test_out["labels"], sensitive, thresholds,
        verbose=verbose)
    eddi = eddi_report(test_out["logits"], test_out["labels"], sensitive,
                       thresholds, verbose=verbose)
    timer.mark("calibrate_and_eval")

    if verbose:
        print("\n--- Final Evaluation Metrics on Test Set ---")
        for task, m in metrics.items():
            print(f"\nOutcome: {task}")
            print("  AUROC     : {:.4f}".format(m["aucroc"]))
            print("  AUPRC     : {:.4f}".format(m["auprc"]))
            print("  F1 Score  : {:.4f}".format(m["f1"]))
            print("  Recall    : {:.4f}".format(m["recall (TPR)"]))
            print("  Precision : {:.4f}".format(m["precision"]))
            print("  TPR       : {:.4f}".format(m["TPR"]))
            print("  FPR       : {:.4f}".format(m["fpr"]))
            print("  Optimal Thresh: {:.2f}".format(m["optimal_threshold"]))
            print("  Overall EO fairness metric: {:.3f}".format(
                fairness[task]["overall_eo"]))

    artifacts = {}
    if cfg.save_artifacts:
        # A pass of every rank (its outputs are gathered); rank 0 writes.
        vectors = trainer.extract_vectors(loaders["test"])
    if cfg.save_artifacts and rank0:
        ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        best_path = os.path.join(cfg.out_dir, f"best_model_{ts}.npz")
        save_params_npz(best_path, flax_params(model, best_params), metadata={
            "model": geometry,
            "thresholds": {k: float(v) for k, v in thresholds.items()},
            "dynamic_weights": trainer.dynamic_weights.tolist(),
        })
        np.save(os.path.join(cfg.out_dir, "tracked_dynamic_weights.npy"),
                trainer.tracked_dynamic_weights, allow_pickle=True)
        np.save(os.path.join(cfg.out_dir, "tracked_sigmoid_weights.npy"),
                np.array(trainer.tracked_sigmoid_weights))
        # extract_and_save_vectors parity (10_FAME.py:559-604): the reference
        # npz keys are gated_vectors [N, 768], fusion_pre_relu_vectors
        # [N, 512], labels, age, ethnicity, insurance; `logits` is an extra.
        np.savez(os.path.join(cfg.out_dir, f"extracted_vectors_{ts}.npz"),
                 logits=test_out["logits"], **vectors)
        artifacts = {"best_model": best_path}
        if verbose:
            print("Saved best model to", best_path)
    timer.mark("artifacts")

    timings = timer.result()
    if cfg.timing and verbose:
        print("\n--- Phase wall-clock (s) ---")
        for phase, secs in timings.items():
            print(f"  {phase:<20s} {secs:9.2f}")

    return {
        "timings": timings,
        "metrics": metrics,
        "fairness": fairness,
        "eddi": eddi,
        "thresholds": thresholds,
        "history": history,
        "artifacts": artifacts,
        "best_params": best_params,
        "trainer": trainer,
        "bundle": bundle,
        "splits": idx,
    }


def run_fame_experiment(structured, unstructured, config: Optional[FAMEPipelineConfig] = None,
                        text_encoder: Optional[TextEncoder] = None, verbose: bool = True,
                        device=None) -> Dict:
    """Train + evaluate full FAME from the two cohort tables (port tables or
    DataFrames): ``head``, :func:`assemble_features`, then
    :func:`run_fame_bundle`."""
    cfg = config or FAMEPipelineConfig()
    _check_config(cfg)
    device = cfg.mesh.device if cfg.mesh is not None else resolve_device(device)
    t0 = time.perf_counter()
    structured, unstructured = as_table(structured), as_table(unstructured)
    if cfg.head:
        structured, unstructured = head(structured, cfg.head), head(unstructured, cfg.head)
    bundle = assemble_features(structured, unstructured)
    return run_fame_bundle(bundle, dataclasses.replace(cfg, head=None), text_encoder,
                           verbose=verbose, device=device,
                           timings={"featurize": time.perf_counter() - t0})
