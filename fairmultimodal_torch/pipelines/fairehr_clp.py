"""06_FairEHR-CLP (port of ``fairmultimodal_tpu/pipelines/fairehr_clp.py``;
reference 06_FairEHR-CLP.py:790-829).

Reference behaviour (the default, ``contrastive=False``): the reference
defines the whole FairEHR-CLP stack but its ``train_pipeline`` trains the
plain two-branch :class:`~fairmultimodal_torch.models.baselines.StructTextModel`
(07's model), and so does this one.  ``contrastive=True`` trains
:class:`~fairmultimodal_torch.models.fairehr.FairEHRCLP` with the InfoNCE +
variance term added to the task loss through ``MultitaskTrainer``'s
``loss_extras``, over a synthetic view of every patient: Gaussian
perturbations of the demographic codes (0.05) and the lab features (0.01),
drawn once per run from ``np.random.default_rng(seed)`` split by split
(train, val, test) in the JAX order, so they equal the JAX draws bit for
bit, and parked beside the split's arrays (``DeviceLoader.add_arrays``).

Both modes: the focal loss (gamma 1, clip-10 neg/pos weights over the
whole cohort, 06:722-727), Adam at 1e-4, iterstrat's split, text at
``max_length`` 128.  On the card the contrastive encoder's two layers run
the FFN kernels #2 / #4 (H 256, F 512) twice per step, once for each view.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from fairmultimodal_torch import TASKS
from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.baselines import StructTextModel
from fairmultimodal_torch.models.fairehr import FairEHRCLP, contrastive_loss
from fairmultimodal_torch.models.text import TextEncoder
from fairmultimodal_torch.pipelines.common import (StageTimer, evaluate_test,
                                                   prepare_experiment, torch_dtype)
from fairmultimodal_torch.train.simple import MultitaskTrainer, SimpleTrainConfig

__all__ = ["FairEHRCLPPipelineConfig", "run_fairehr_clp_experiment", "synthetic_views"]

_KEYS_REF = ("demo_dummy_ids", "demo_attn_mask", "age_ids", "segment_ids", "adm_loc_ids",
             "disch_loc_ids", "gender_ids", "ethnicity_ids", "insurance_ids", "text_embedding")
_KEYS_CLP = ("demo_features", "lab_features", "text_embedding", "age_ids", "ethnicity_ids",
             "insurance_ids")


@dataclasses.dataclass
class FairEHRCLPPipelineConfig:
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
    contrastive: bool = False          # False = the reference's behaviour
    contrastive_weight: float = 0.1
    tau: float = 0.5
    syn_noise_demo: float = 0.05       # 06:227-233
    syn_noise_long: float = 0.01


def synthetic_views(arrays: Dict[str, np.ndarray], idx: Dict[str, np.ndarray], seed: int,
                    noise_demo: float = 0.05, noise_long: float = 0.01):
    """Per split (in ``idx``'s order), ``demo_features_syn`` and
    ``lab_features_syn``: the split's rows plus scaled standard normal draws
    of one ``np.random.default_rng(seed)``, demographics first."""
    rng = np.random.default_rng(seed)
    views = {}
    for split, rows in idx.items():
        dfeat, lfeat = arrays["demo_features"][rows], arrays["lab_features"][rows]
        views[split] = {
            "demo_features_syn": dfeat + noise_demo
            * rng.standard_normal(dfeat.shape).astype(np.float32),
            "lab_features_syn": lfeat + noise_long
            * rng.standard_normal(lfeat.shape).astype(np.float32)}
    return views


def run_fairehr_clp_experiment(structured, unstructured,
                               config: Optional[FairEHRCLPPipelineConfig] = None,
                               text_encoder: Optional[TextEncoder] = None, verbose: bool = True,
                               device=None) -> Dict:
    """Train and evaluate 06 on two cohort tables (port tables or
    DataFrames).  ``device``: ``None`` means CUDA and raises without it."""
    cfg = config or FairEHRCLPPipelineConfig()
    dtype = torch_dtype(cfg.dtype)
    timer = StageTimer()
    prep = prepare_experiment(
        structured, unstructured, model_keys=_KEYS_CLP if cfg.contrastive else _KEYS_REF,
        batch_size=cfg.train.batch_size, text_encoder=text_encoder, text_model=cfg.text_model,
        text_max_length=cfg.text_max_length, text_batch_size=cfg.text_batch_size,
        test_size=cfg.test_size, val_size=cfg.val_size, split_seed=cfg.split_seed,
        split_method="iterstrat", pos_weight_mode="neg_over_pos_clip10_all",
        seed=cfg.train.seed, verbose=verbose, dtype=dtype, device=device, timer=timer)
    text_dim = prep.bundle.text_embeddings.shape[1]

    if cfg.contrastive:
        views = synthetic_views(prep.arrays, prep.idx, cfg.train.seed, cfg.syn_noise_demo,
                                cfg.syn_noise_long)
        for split, loader in prep.loaders.items():
            loader.add_arrays(views[split])

        def extras(model, out, batch):
            return cfg.contrastive_weight * contrastive_loss(
                out["e_adj"], out["e_adj_syn"], tau=cfg.tau, weight=batch["weight"])

        model = FairEHRCLP(text_embed_size=text_dim, dtype=dtype)
    else:
        extras = None
        n_ages, _, n_eth, n_ins = prep.vocab_sizes()
        model = StructTextModel(
            n_ages, num_ethnicities=n_eth, num_insurances=n_ins, hidden_size=cfg.hidden_size,
            num_hidden_layers=cfg.num_hidden_layers,
            num_attention_heads=cfg.num_attention_heads, text_embed_size=text_dim, dtype=dtype)
    trainer = MultitaskTrainer(init_params(model, seed=cfg.train.seed), cfg.train,
                               pos_weight=prep.pos_weight, device=device, loss_extras=extras)
    next(iter(prep.loaders["train"]))       # the JAX init example's shuffle
    timer.mark("split_and_loaders")       # the views, the model's build and init
    best, history = trainer.fit(prep.loaders["train"], prep.loaders["val"], verbose=verbose)
    timer.mark("train")
    _, metrics, fairness, eddi = evaluate_test(trainer, best, prep.loaders["test"], TASKS,
                                               verbose)
    timer.mark("eval")
    return {"metrics": metrics, "fairness": fairness, "eddi": eddi, "history": history,
            "best_params": best, "trainer": trainer, "prep": prep, "timings": timer.result()}
