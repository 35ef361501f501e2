"""04_AdvDebias: two-stage adversarial debiasing (port of
``fairmultimodal_tpu/pipelines/adv_debias.py``; reference 04_AdvDebias.py).

Stage 1 (04:817-1046): 07's :class:`StructTextModel` (``BEHRTFull``, a
12L/12H BERT per row, plus the text embedding at ``max_length`` 128) trained
with the focal loss (gamma 1, clip-10 neg/pos weights over the whole cohort),
Adam at 1e-4, iterstrat's split; no kernel runs there (the BERT sees one
token, the text buckets stay below the kernels' 256).  ``dtype="bfloat16"``
builds this model (and a text encoder built here) in bf16.

Stage 2 (04:559-789): :func:`~fairmultimodal_torch.train.adversarial.adv_grid_search`
over the RAW lab columns (``FeatureBundle.labs_raw``: fillna(0), no scaling,
04:888-891), the label column ``stage2_task`` and the sensitive attribute
``stage2_sensitive`` (binarized ``z > 0`` in the engine), on the train and
val splits, always in fp32.  The default grid is the reference's 64-point
``REFERENCE_GRID``.  Artifacts (04:752-772, 1089-1091): the per-point and
final predictor / adversary npz files, ``metrics.csv`` (the config columns,
then the metrics columns, written without pandas as ``to_csv(index=False)``
writes them) and, when matplotlib is installed, ``loss_metrics.png``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np

from fairmultimodal_torch import TASKS
from fairmultimodal_torch.data.table import write_csv_table
from fairmultimodal_torch.eval.plots import _plt
from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.baselines import StructTextModel
from fairmultimodal_torch.models.text import TextEncoder
from fairmultimodal_torch.pipelines.common import (StageTimer, evaluate_test,
                                                   prepare_experiment, torch_dtype)
from fairmultimodal_torch.train.adversarial import adv_grid_search, save_adv_artifacts
from fairmultimodal_torch.train.simple import MultitaskTrainer, SimpleTrainConfig

__all__ = ["AdvDebiasPipelineConfig", "run_adv_debias_experiment"]

_KEYS = ("demo_dummy_ids", "demo_attn_mask", "age_ids", "segment_ids",
         "adm_loc_ids", "disch_loc_ids", "gender_ids", "ethnicity_ids",
         "insurance_ids", "text_embedding", "lab_features")


@dataclasses.dataclass
class AdvDebiasPipelineConfig:
    train: SimpleTrainConfig = dataclasses.field(default_factory=lambda: SimpleTrainConfig(
        lr=1e-4, num_epochs=20, batch_size=16, loss="focal", gamma=1.0, optimizer="adam"))
    text_model: str = "emilyalsentzer/Bio_ClinicalBERT"
    text_max_length: int = 128
    text_batch_size: int = 32
    test_size: float = 0.20
    val_size: float = 0.05
    split_seed: int = 42
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    dtype: str = "float32"
    # Stage 2 (04:888-893, 1081-1088): the mortality column, ethnicity
    # binarized z > 0, the full grid.
    stage2_task: int = 0
    stage2_sensitive: str = "ethnicity"
    stage2_grid: Optional[Dict[str, List]] = None   # None -> REFERENCE_GRID
    run_stage2: bool = True
    out_dir: str = "."
    save_artifacts: bool = True


def _write_stage2(out_dir: str, stage2: List[Dict], num_features: int, verbose: bool) -> Dict:
    """The npz files, ``metrics.csv`` and ``loss_metrics.png``; returns their paths."""
    os.makedirs(out_dir, exist_ok=True)
    written = save_adv_artifacts(out_dir, stage2, num_features)
    if verbose and written:
        print(f"Saved {len(written)} stage-2 model artifacts under",
              os.path.join(out_dir, "model"), "and", os.path.join(out_dir, "adv"))
    rows = [dict(**r["config"], **r["metrics"]) for r in stage2]
    csv_path = os.path.join(out_dir, "metrics.csv")
    write_csv_table(csv_path, {k: np.asarray([row[k] for row in rows]) for k in rows[0]})
    artifacts = {"npz": written, "metrics_csv": csv_path}
    plt = _plt()
    if plt is not None:
        # The reference plots its last run; the first point's curves, as the JAX package.
        plt.figure()
        plt.plot(stage2[0]["train_curve"], color="blue", label="Train Loss")
        plt.plot(stage2[0]["valid_curve"], color="red", label="Valid Loss")
        plt.legend()
        artifacts["loss_png"] = os.path.join(out_dir, "loss_metrics.png")
        plt.savefig(artifacts["loss_png"])
        plt.close()
    if verbose:
        print("Evaluation metrics saved to", csv_path)
    return artifacts


def run_adv_debias_experiment(structured, unstructured,
                              config: Optional[AdvDebiasPipelineConfig] = None,
                              text_encoder: Optional[TextEncoder] = None,
                              stage2_features: Optional[np.ndarray] = None,
                              verbose: bool = True, device=None) -> Dict:
    """Both stages on two cohort tables (port tables or DataFrames).
    ``stage2_features`` replaces the raw lab columns as stage 2's X.
    ``device``: ``None`` means CUDA and raises without it."""
    cfg = config or AdvDebiasPipelineConfig()
    dtype = torch_dtype(cfg.dtype)
    timer = StageTimer()
    prep = prepare_experiment(
        structured, unstructured, model_keys=_KEYS, batch_size=cfg.train.batch_size,
        text_encoder=text_encoder, text_model=cfg.text_model,
        text_max_length=cfg.text_max_length, text_batch_size=cfg.text_batch_size,
        test_size=cfg.test_size, val_size=cfg.val_size, split_seed=cfg.split_seed,
        split_method="iterstrat", pos_weight_mode="neg_over_pos_clip10_all",
        seed=cfg.train.seed, verbose=verbose, dtype=dtype, device=device, timer=timer)

    n_ages, _, n_eth, n_ins = prep.vocab_sizes()
    model = init_params(StructTextModel(
        n_ages, num_ethnicities=n_eth, num_insurances=n_ins, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_hidden_layers, num_attention_heads=cfg.num_attention_heads,
        text_embed_size=prep.bundle.text_embeddings.shape[1], dtype=dtype),
        seed=cfg.train.seed)
    trainer = MultitaskTrainer(model, cfg.train, pos_weight=prep.pos_weight, device=device)
    next(iter(prep.loaders["train"]))       # the JAX init example's shuffle
    timer.mark("split_and_loaders")       # the model's build and init
    best, history = trainer.fit(prep.loaders["train"], prep.loaders["val"], verbose=verbose)
    timer.mark("train")
    _, metrics, fairness, eddi = evaluate_test(trainer, best, prep.loaders["test"], TASKS,
                                               verbose)
    timer.mark("eval")

    stage2, artifacts = None, {}
    if cfg.run_stage2:
        b = prep.bundle
        X = b.labs_raw if stage2_features is None else stage2_features
        y = b.labels[:, cfg.stage2_task]
        z = {"gender": b.gender_codes, "age": b.age_codes, "ethnicity": b.ethnicity_codes,
             "insurance": b.insurance_codes}[cfg.stage2_sensitive]
        tr, va = prep.idx["train"], prep.idx["val"]
        stage2 = adv_grid_search(X[tr], y[tr], z[tr], X[va], y[va], z[va],
                                 grid=cfg.stage2_grid, verbose=verbose, device=device)
        if verbose:
            for r in stage2:
                print("stage2", r["config"], "->",
                      {k: round(v, 4) for k, v in r["metrics"].items()})
        timer.mark("stage2")
        if cfg.save_artifacts:
            artifacts = _write_stage2(cfg.out_dir, stage2, X.shape[1], verbose)
        timer.mark("artifacts")

    return {"metrics": metrics, "fairness": fairness, "eddi": eddi, "history": history,
            "best_params": best, "trainer": trainer, "prep": prep, "stage2": stage2,
            "artifacts": artifacts, "timings": timer.result()}
