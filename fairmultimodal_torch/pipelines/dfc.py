"""03_DfC: demographics-free classification (port of
``fairmultimodal_tpu/pipelines/dfc.py``; reference 03_DfC.py:555-781).

The model never sees age, gender, ethnicity or insurance: a BERT over the
dummy token plus the segment / ward embeddings, fused with the text
embedding at ``max_length`` 128 (:class:`~fairmultimodal_torch.models.fusion.
DfCModel`, under the name ``dfc`` as the JAX adapter nests it).  The
sensitive attributes ride along for the evaluation only.  The focal loss
(gamma 1, clip-10 neg/pos weights over the whole cohort, 03:648-653), Adam
at 1e-4, scikit-multilearn's order-2 split.  No kernel runs here: the BERT
sees one token and the text buckets stay below the kernels' 256.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from fairmultimodal_torch import TASKS
from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.fusion import DfCModel
from fairmultimodal_torch.models.text import TextEncoder
from fairmultimodal_torch.pipelines.common import (StageTimer, evaluate_test,
                                                   prepare_experiment, torch_dtype)
from fairmultimodal_torch.train.simple import MultitaskTrainer, SimpleTrainConfig

__all__ = ["DfCPipelineConfig", "DfCBatchModel", "run_dfc_experiment"]

_KEYS = ("demo_dummy_ids", "demo_attn_mask", "segment_ids", "adm_loc_ids", "disch_loc_ids",
         "text_embedding", "age_ids", "ethnicity_ids", "insurance_ids")
#: DfCModel's batch keys <- the common batch keys (the JAX ``DfCBatchModel``).
_KEY_MAP = {"dummy_ids": "demo_dummy_ids", "attn_mask": "demo_attn_mask",
            "segment_ids": "segment_ids", "admission_loc_ids": "adm_loc_ids",
            "discharge_loc_ids": "disch_loc_ids", "text_embedding": "text_embedding"}


@dataclasses.dataclass
class DfCPipelineConfig:
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


class DfCBatchModel(nn.Module):
    """The common batch keys -> :class:`DfCModel`'s (``dfc``)."""

    def __init__(self, **kwargs):
        super().__init__()
        self.dfc = DfCModel(**kwargs)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        return self.dfc({k: batch[v] for k, v in _KEY_MAP.items()}, generator)


def run_dfc_experiment(structured, unstructured, config: Optional[DfCPipelineConfig] = None,
                       text_encoder: Optional[TextEncoder] = None, verbose: bool = True,
                       device=None) -> Dict:
    """Train and evaluate 03 on two cohort tables (port tables or
    DataFrames).  ``device``: ``None`` means CUDA and raises without it."""
    cfg = config or DfCPipelineConfig()
    dtype = torch_dtype(cfg.dtype)
    timer = StageTimer()
    prep = prepare_experiment(
        structured, unstructured, model_keys=_KEYS, batch_size=cfg.train.batch_size,
        text_encoder=text_encoder, text_model=cfg.text_model,
        text_max_length=cfg.text_max_length, text_batch_size=cfg.text_batch_size,
        test_size=cfg.test_size, val_size=cfg.val_size, split_seed=cfg.split_seed,
        split_method="skmultilearn", pos_weight_mode="neg_over_pos_clip10_all",
        seed=cfg.train.seed, verbose=verbose, dtype=dtype, device=device, timer=timer)

    model = init_params(DfCBatchModel(
        hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
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
    return {"metrics": metrics, "fairness": fairness, "eddi": eddi, "history": history,
            "best_params": best, "trainer": trainer, "prep": prep, "timings": timer.result()}
