"""09_multimodal_sigmoid_fusion: gate-only fusion (port of
``fairmultimodal_tpu/pipelines/sigmoid_fusion.py``; reference
09_multimodal_sigmoid_fusion.py:512-748).

Demo BERT (12L/12H) + the lab encoder (2L/8H, kernels #1-#4 on the card) +
the text embedding at ``max_length`` 128 with three learnable 256-d sigmoid
gates; the focal loss (gamma 1, clip-10 neg/pos over the whole cohort) and
Adam at 1e-4.  The split is scikit-learn's stratified ``train_test_split``
on mortality (09:592-593), index-exact without scikit-learn
(:func:`~fairmultimodal_torch.data.split.stratified_train_test_split`).

Not copied, as in the JAX package: 09 realigns the precomputed embeddings by
an ``argsort`` of subject ids against split rows (09:605), which misaligns
patients; here every array is indexed alike.  ``reference_compat`` gives
09's 70-90 last age bucket (09:57-67).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.baselines import SigmoidFusionFull
from fairmultimodal_torch.models.text import TextEncoder
from fairmultimodal_torch.pipelines.common import (StageTimer, evaluate_test,
                                                   prepare_experiment, resolve_task,
                                                   torch_dtype)
from fairmultimodal_torch.train.simple import MultitaskTrainer, SimpleTrainConfig

__all__ = ["SigmoidFusionPipelineConfig", "run_sigmoid_fusion_experiment"]

_KEYS = ("demo_dummy_ids", "demo_attn_mask", "age_ids", "gender_ids", "ethnicity_ids",
         "insurance_ids", "lab_features", "text_embedding")


@dataclasses.dataclass
class SigmoidFusionPipelineConfig:
    train: SimpleTrainConfig = dataclasses.field(default_factory=lambda: SimpleTrainConfig(
        lr=1e-4, num_epochs=20, batch_size=16, loss="focal", gamma=1.0, optimizer="adam"))
    text_model: str = "emilyalsentzer/Bio_ClinicalBERT"
    text_max_length: int = 128      # 09:285
    text_batch_size: int = 32
    test_size: float = 0.20
    val_size: float = 0.05
    split_seed: int = 42
    hidden_size: int = 768
    demo_layers: int = 12
    demo_heads: int = 12
    lab_layers: int = 2
    lab_heads: int = 8
    dtype: str = "float32"
    # 09's age mapper's 70-90 last bucket (09:57-67) instead of 70-89.
    reference_compat: bool = False
    # Single-task regime (FinalCode/Mechanical_Ventilation/06_*).
    task: Optional[str] = None


def run_sigmoid_fusion_experiment(structured, unstructured,
                                  config: Optional[SigmoidFusionPipelineConfig] = None,
                                  text_encoder: Optional[TextEncoder] = None,
                                  verbose: bool = True, device=None) -> Dict:
    cfg = config or SigmoidFusionPipelineConfig()
    task_names, task_index = resolve_task(cfg.task)
    dtype = torch_dtype(cfg.dtype)
    timer = StageTimer()
    prep = prepare_experiment(
        structured, unstructured, model_keys=_KEYS, batch_size=cfg.train.batch_size,
        text_encoder=text_encoder, text_model=cfg.text_model,
        text_max_length=cfg.text_max_length, text_batch_size=cfg.text_batch_size,
        test_size=cfg.test_size, val_size=cfg.val_size, split_seed=cfg.split_seed,
        split_method="sklearn", pos_weight_mode="neg_over_pos_clip10_all",
        seed=cfg.train.seed, age_bucket_upper=90 if cfg.reference_compat else 89,
        task_index=task_index, verbose=verbose, dtype=dtype, device=device, timer=timer)

    n_ages, n_gen, n_eth, n_ins = prep.vocab_sizes()
    model = init_params(SigmoidFusionFull(
        n_ages, n_gen, n_eth, n_ins, prep.bundle.num_lab_features,
        hidden_size=cfg.hidden_size, demo_layers=cfg.demo_layers, demo_heads=cfg.demo_heads,
        lab_layers=cfg.lab_layers, lab_heads=cfg.lab_heads, num_tasks=len(task_names),
        text_embed_size=prep.bundle.text_embeddings.shape[1], dtype=dtype),
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
