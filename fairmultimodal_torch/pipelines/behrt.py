"""01_BEHRT: the structured-only baseline (port of
``fairmultimodal_tpu/pipelines/behrt.py``; reference 01_BEHRT.py:365-498).

The lab encoder alone (the reference leaves the demo branch unused,
01_BEHRT.py:181,414) trained with per-task BCE(pos_weight = neg/pos over
train), the clip at 1.0, AdamW (weight decay 0), the plateau LR and early
stopping; evaluated with AUROC / AUPRC (the PR-curve integration) / F1 / TPR
/ FPR, the EO blocks and the per-attribute EDDI.  Patients without notes are
kept.  ``unstructured`` may be None: the cohort is then the structured table
alone (the JAX function raises there, its check asking for note columns).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.baselines import BEHRTLabOnlyModel
from fairmultimodal_torch.pipelines.common import (TASK_SHORT, StageTimer, evaluate_test,
                                                   prepare_experiment, resolve_task,
                                                   torch_dtype)
from fairmultimodal_torch.train.simple import MultitaskTrainer, SimpleTrainConfig

__all__ = ["BEHRTPipelineConfig", "run_behrt_experiment"]

_KEYS = ("lab_features", "age_ids", "ethnicity_ids", "insurance_ids")


@dataclasses.dataclass
class BEHRTPipelineConfig:
    train: SimpleTrainConfig = dataclasses.field(default_factory=lambda: SimpleTrainConfig(
        lr=2e-5, num_epochs=50, batch_size=16, loss="bce", optimizer="adamw", grad_clip=1.0))
    test_size: float = 0.20
    val_size: float = 0.05
    split_seed: int = 42
    hidden_size: int = 768
    dtype: str = "float32"
    # None = the three-task regime; a task name trains one label
    # (FinalCode/Mechanical_Ventilation/02_BEHRT.py).
    task: Optional[str] = None


def run_behrt_experiment(structured, unstructured=None,
                         config: Optional[BEHRTPipelineConfig] = None, verbose: bool = True,
                         device=None) -> Dict:
    """Train and evaluate the structured-only baseline on two cohort tables
    (port tables or DataFrames).  ``device``: ``None`` means CUDA and raises
    without it.  Returns the JAX function's result dict (``best_params`` is
    the best state dict, loaded into ``trainer.model``)."""
    cfg = config or BEHRTPipelineConfig()
    task_names, task_index = resolve_task(cfg.task)
    if unstructured is None:
        unstructured = {"subject_id": np.asarray(structured["subject_id"]),
                        "hadm_id": np.asarray(structured["hadm_id"])}
    timer = StageTimer()
    prep = prepare_experiment(
        structured, unstructured, model_keys=_KEYS, batch_size=cfg.train.batch_size,
        need_text=False, require_notes=False, test_size=cfg.test_size,
        val_size=cfg.val_size, split_seed=cfg.split_seed, split_method="iterstrat",
        pos_weight_mode="neg_over_pos", seed=cfg.train.seed, task_index=task_index,
        verbose=verbose, device=device, timer=timer)

    model = init_params(BEHRTLabOnlyModel(
        prep.bundle.num_lab_features, cfg.hidden_size, dtype=torch_dtype(cfg.dtype),
        tasks=tuple(TASK_SHORT[t] for t in task_names)), seed=cfg.train.seed)
    trainer = MultitaskTrainer(model, cfg.train, pos_weight=prep.pos_weight, device=device)
    # The JAX pipeline draws its init example from the train loader, which
    # consumes the first (seed, epoch) shuffle; so does the port, so that the
    # epochs see the same batches.
    next(iter(prep.loaders["train"]))
    timer.mark("split_and_loaders")       # the model's build and init
    best, history = trainer.fit(prep.loaders["train"], prep.loaders["val"], verbose=verbose)
    timer.mark("train")
    _, metrics, fairness, eddi = evaluate_test(trainer, best, prep.loaders["test"], task_names,
                                               verbose, auprc_mode="pr_curve")
    timer.mark("eval")
    return {"metrics": metrics, "fairness": fairness, "eddi": eddi, "history": history,
            "best_params": best, "trainer": trainer, "prep": prep,
            "timings": timer.result()}
