"""02_BioClinicalBERT: the text-only baseline (port of
``fairmultimodal_tpu/pipelines/text_only.py``; reference
02_BioClinicalBERT.py:401-635).

Frozen Bio_ClinicalBERT note embeddings at ``max_length`` 512 (the 256 and
512 buckets run kernels #1 / #2 on the card) -> the 768 -> 256 -> T head,
trained with the focal loss (gamma 2, ``pos_weight`` n / 2 n_pos over the
train split: 02 defines a clipped weight but its criteria use
``compute_class_weights``, 02:488-497) and AdamW at 2e-5.  The split is
scikit-multilearn's order-2 iterative stratification.  ``task="readmission"``
is the readmission-only regime: the label is ``readmission_within_30d``.

``dtype`` is the port's: the compute dtype of the text encoder built here
and of the head (the JAX config has none and runs both in float32).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.baselines import TextOnlyClassifier
from fairmultimodal_torch.models.text import TextEncoder
from fairmultimodal_torch.pipelines.common import (StageTimer, evaluate_test,
                                                   prepare_experiment, resolve_task,
                                                   task_label_columns, torch_dtype)
from fairmultimodal_torch.train.simple import MultitaskTrainer, SimpleTrainConfig

__all__ = ["TextOnlyPipelineConfig", "run_text_only_experiment"]

_KEYS = ("text_embedding", "age_ids", "ethnicity_ids", "insurance_ids")


@dataclasses.dataclass
class TextOnlyPipelineConfig:
    train: SimpleTrainConfig = dataclasses.field(default_factory=lambda: SimpleTrainConfig(
        lr=2e-5, num_epochs=10, batch_size=16, loss="focal", gamma=2.0, optimizer="adamw"))
    text_model: str = "emilyalsentzer/Bio_ClinicalBERT"
    text_max_length: int = 512
    text_batch_size: int = 32
    head: Optional[int] = None          # 02:405 uses .head(1000)
    test_size: float = 0.20
    val_size: float = 0.05
    split_seed: int = 42
    # Single-task regime (FinalCode/Mechanical_Ventilation/04_BioclinicalBERT),
    # or "readmission".
    task: Optional[str] = None
    dtype: str = "float32"


def run_text_only_experiment(structured, unstructured,
                             config: Optional[TextOnlyPipelineConfig] = None,
                             text_encoder: Optional[TextEncoder] = None, verbose: bool = True,
                             device=None) -> Dict:
    cfg = config or TextOnlyPipelineConfig()
    task_names, task_index = resolve_task(cfg.task, allow_extra=True)
    dtype = torch_dtype(cfg.dtype)
    timer = StageTimer()
    prep = prepare_experiment(
        structured, unstructured, model_keys=_KEYS, batch_size=cfg.train.batch_size,
        text_encoder=text_encoder, text_model=cfg.text_model,
        text_max_length=cfg.text_max_length, text_batch_size=cfg.text_batch_size,
        head=cfg.head, test_size=cfg.test_size, val_size=cfg.val_size,
        split_seed=cfg.split_seed, split_method="skmultilearn", pos_weight_mode="balanced",
        seed=cfg.train.seed, task_index=task_index, label_columns=task_label_columns(cfg.task),
        verbose=verbose, dtype=dtype, device=device, timer=timer)

    model = init_params(TextOnlyClassifier(prep.bundle.text_embeddings.shape[1],
                                           num_tasks=len(task_names), dtype=dtype),
                        seed=cfg.train.seed)
    trainer = MultitaskTrainer(model, cfg.train, pos_weight=prep.pos_weight, device=device)
    next(iter(prep.loaders["train"]))       # the JAX init example's shuffle
    timer.mark("split_and_loaders")       # the model's build and init
    best, history = trainer.fit(prep.loaders["train"], prep.loaders["val"], verbose=verbose)
    timer.mark("train")
    _, metrics, fairness, eddi = evaluate_test(trainer, best, prep.loaders["test"], task_names,
                                               verbose)
    timer.mark("eval")
    return {"metrics": metrics, "fairness": fairness, "eddi": eddi, "history": history,
            "best_params": best, "trainer": trainer, "prep": prep,
            "timings": timer.result()}
