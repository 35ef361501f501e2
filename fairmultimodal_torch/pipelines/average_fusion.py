"""07_multimodal_average_fusion: plain concatenation fusion (port of
``fairmultimodal_tpu/pipelines/average_fusion.py``; reference
07_multimodal_average_fusion.py:531-790).

:class:`BEHRTFull` (a 12L/12H BERT run per row, plus seven embeddings) and
the text embedding at ``max_length`` 128 -> two 256-d projectors -> concat
-> MLP, trained with the focal loss (gamma 1, clip-10 neg/pos over the whole
cohort) and Adam at 1e-4.  No kernel runs here: the BERT sees one token and
the text buckets stay below the kernels' 256.  With ``save_artifacts`` the
pre-ReLU fused embeddings of the real rows of train, val and test (in the
loaders' order) go to ``extracted_embeddings.npz`` with their labels
(07:496-528, 781-785).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from fairmultimodal_torch.data.prefetch import PrefetchLoader
from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.baselines import StructTextModel
from fairmultimodal_torch.models.text import TextEncoder
from fairmultimodal_torch.pipelines.common import (StageTimer, evaluate_test,
                                                   prepare_experiment, resolve_task,
                                                   torch_dtype)
from fairmultimodal_torch.train.simple import MultitaskTrainer, SimpleTrainConfig

__all__ = ["AverageFusionPipelineConfig", "run_average_fusion_experiment"]

_KEYS = ("demo_dummy_ids", "demo_attn_mask", "age_ids", "segment_ids", "adm_loc_ids",
         "disch_loc_ids", "gender_ids", "ethnicity_ids", "insurance_ids", "text_embedding")


@dataclasses.dataclass
class AverageFusionPipelineConfig:
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
    out_dir: str = "."
    save_artifacts: bool = True
    # Single-task regime (FinalCode/Mechanical_Ventilation/05_*).
    task: Optional[str] = None


def run_average_fusion_experiment(structured, unstructured,
                                  config: Optional[AverageFusionPipelineConfig] = None,
                                  text_encoder: Optional[TextEncoder] = None,
                                  verbose: bool = True, device=None) -> Dict:
    cfg = config or AverageFusionPipelineConfig()
    task_names, task_index = resolve_task(cfg.task)
    dtype = torch_dtype(cfg.dtype)
    timer = StageTimer()
    prep = prepare_experiment(
        structured, unstructured, model_keys=_KEYS, batch_size=cfg.train.batch_size,
        text_encoder=text_encoder, text_model=cfg.text_model,
        text_max_length=cfg.text_max_length, text_batch_size=cfg.text_batch_size,
        test_size=cfg.test_size, val_size=cfg.val_size, split_seed=cfg.split_seed,
        split_method="iterstrat", pos_weight_mode="neg_over_pos_clip10_all",
        seed=cfg.train.seed, task_index=task_index, verbose=verbose, dtype=dtype,
        device=device, timer=timer)

    n_ages, _, n_eth, n_ins = prep.vocab_sizes()
    model = init_params(StructTextModel(
        n_ages, num_ethnicities=n_eth, num_insurances=n_ins, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_hidden_layers, num_attention_heads=cfg.num_attention_heads,
        num_tasks=len(task_names), text_embed_size=prep.bundle.text_embeddings.shape[1],
        dtype=dtype), seed=cfg.train.seed)
    trainer = MultitaskTrainer(model, cfg.train, pos_weight=prep.pos_weight, device=device)
    next(iter(prep.loaders["train"]))       # the JAX init example's shuffle
    timer.mark("split_and_loaders")       # the model's build and init
    best, history = trainer.fit(prep.loaders["train"], prep.loaders["val"], verbose=verbose)
    timer.mark("train")
    _, metrics, fairness, eddi = evaluate_test(trainer, best, prep.loaders["test"], task_names,
                                               verbose)
    timer.mark("eval")

    artifacts = {}
    if cfg.save_artifacts:
        embs, labels = [], []
        model.eval()
        with torch.inference_mode():
            for split in ("train", "val", "test"):
                for batch in PrefetchLoader(prep.loaders[split], trainer.device):
                    keep = batch["weight"].cpu().numpy() > 0
                    e = model(batch["model_inputs"])["fused_embedding"]
                    embs.append(e.cpu().numpy()[keep])
                    labels.append(batch["labels"].cpu().numpy()[keep])
        os.makedirs(cfg.out_dir, exist_ok=True)
        path = os.path.join(cfg.out_dir, "extracted_embeddings.npz")
        np.savez(path, embeddings=np.concatenate(embs), labels=np.concatenate(labels))
        artifacts["extracted_embeddings"] = path
        if verbose:
            print("Saved fused embeddings to", path)
    timer.mark("artifacts")

    return {"metrics": metrics, "fairness": fairness, "eddi": eddi, "history": history,
            "best_params": best, "trainer": trainer, "prep": prep, "artifacts": artifacts,
            "timings": timer.result()}
