"""08_multimodal_eddi_fusion: EDDI-weighted logit-level fusion (port of
``fairmultimodal_tpu/pipelines/eddi_fusion.py``; reference
08_multimodal_eddi_fusion.py).

Nine single-logit heads (tasks x (demo, lab, text)) over the 6L/6H demo
BERT, the lab encoder (kernels #1-#4 on the card) and the text embedding at
``max_length`` 128.  Per batch, each modality's EDDI is taken on that batch
with gender as the sensitive attribute (08:470-474), from the detached
logits, and the fused logit is ``sum_m w_m * logit_m`` with ``w_m = w_prev +
beta * (eddi_max - eddi_m)``, beta 0.3 (08:348-402).  The loss is the
per-task focal loss (gamma 1, clip-10 neg/pos over the whole cohort) plus
``reg_weight * mean((fused_mort - 1)^2)`` (08:486-487); Adam at 1e-4.

The loop's rules, each the reference's (08:861-916):

- ``w_prev`` is fixed for every batch of an epoch (train, val and test);
  each batch fuses with its own effective weights;
- the base weight is 0.33, not 1/3 (08:389-392);
- the plateau LR is computed and thrown away (``_ = sched.step(val_loss)``):
  the learning rate never changes;
- the last validation batch's effective weights become ``w_prev`` for the
  next epoch, except on the early-stop epoch, which breaks first;
- the three-task model keeps the long head names ``head_mortality_*``; the
  single-task regime uses the short ones.

``train.deterministic_forward`` (a test hook) trains without dropout; the
JAX runner has no such hook.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from fairmultimodal_torch.data.prefetch import PrefetchLoader
from fairmultimodal_torch.eval.report import eddi_report, evaluate_multitask
from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.baselines import EDDIFusionFull
from fairmultimodal_torch.models.text import TextEncoder
from fairmultimodal_torch.ops.gates import resolve_device
from fairmultimodal_torch.ops.losses import focal_loss
from fairmultimodal_torch.pipelines.common import (SENSITIVE, TASK_SHORT, StageTimer,
                                                   prepare_experiment, resolve_task,
                                                   torch_dtype)
from fairmultimodal_torch.train.loop import EarlyStopper, PlateauScheduler
from fairmultimodal_torch.train.simple import SimpleTrainConfig
from fairmultimodal_torch.utils.rng import make_generator

__all__ = ["EDDIFusionPipelineConfig", "run_eddi_fusion_experiment", "batch_eddi_weights",
           "make_eddi_fusion_loss"]

_KEYS = ("demo_dummy_ids", "demo_attn_mask", "age_ids", "gender_ids", "ethnicity_ids",
         "insurance_ids", "lab_features", "text_embedding")


@dataclasses.dataclass
class EDDIFusionPipelineConfig:
    train: SimpleTrainConfig = dataclasses.field(default_factory=lambda: SimpleTrainConfig(
        lr=1e-4, num_epochs=20, batch_size=16, loss="focal", gamma=1.0, optimizer="adam"))
    beta: float = 0.3                  # 08:355
    reg_weight: float = 1.0            # the (mort_logit - 1)^2 term
    text_model: str = "emilyalsentzer/Bio_ClinicalBERT"
    text_max_length: int = 128
    text_batch_size: int = 32
    test_size: float = 0.20
    val_size: float = 0.05
    split_seed: int = 42
    hidden_size: int = 768
    demo_layers: int = 6               # 08:261-271
    demo_heads: int = 6
    lab_layers: int = 2
    lab_heads: int = 8
    dtype: str = "float32"
    # Single-task regime (FinalCode/Mechanical_Ventilation/07_*EDDI*); the
    # regulariser then applies to that task's fused logit.
    task: Optional[str] = None


@torch.no_grad()
def batch_eddi_weights(tm_logits: torch.Tensor, labels: torch.Tensor,
                       gender_ids: torch.Tensor, w_prev: torch.Tensor, beta: float,
                       weight: Optional[torch.Tensor] = None, num_groups: int = 2):
    """Per-batch EDDI weight update (08:348-402) from detached logits.

    tm_logits [B, T, M], labels [B, T], gender_ids [B], w_prev [T, M],
    weight [B] (pad rows 0).  Returns (w_new [T, M], eddi [T, M]): a group
    absent from the batch adds nothing, and a batch with no rows gives
    ``w_prev`` back."""
    tm = tm_logits.detach()
    preds = (torch.sigmoid(tm) > 0.5).to(torch.float32)
    err = (preds != labels.to(torch.float32)[:, :, None]).to(torch.float32)        # [B, T, M]
    groups = torch.arange(num_groups, device=tm.device)
    onehot = (gender_ids.long()[:, None] == groups[None, :]).to(torch.float32)     # [B, G]
    if weight is not None:
        onehot = onehot * weight.to(torch.float32)[:, None]
    counts = onehot.sum(dim=0)                                                      # [G]
    err_sums = torch.einsum("btm,bg->tmg", err, onehot)                             # [T, M, G]
    overall = err_sums.sum(dim=-1) / torch.clamp(counts.sum(), min=1.0)             # [T, M]
    present = counts > 0
    er_g = err_sums / torch.clamp(counts, min=1.0)[None, None, :]
    denom = torch.maximum(overall, 1.0 - overall)
    d = torch.where(present[None, None, :],
                    (er_g - overall[..., None]) / torch.clamp(denom[..., None], min=1e-12),
                    torch.zeros((), device=tm.device))
    n_present = torch.clamp(present.sum(), min=1)
    eddi = torch.sqrt((d ** 2).sum(dim=-1)) / n_present                            # [T, M]
    w_new = w_prev + beta * (eddi.max(dim=1, keepdim=True).values - eddi)
    return w_new, eddi


def make_eddi_fusion_loss(model, cfg: EDDIFusionPipelineConfig, pos_weight=None):
    """08's joint loss (08:454-490) as one callable: ``loss_fn(batch,
    w_prev, generator) -> (loss, w_new, fused)``.  The forward runs in the
    model's current mode; ``generator`` seeds its dropout in train mode."""
    def loss_fn(batch, w_prev, generator=None):
        tm = model(batch["model_inputs"], generator=generator)["task_modality_logits"]
        w = batch["weight"]
        w_new, _ = batch_eddi_weights(tm, batch["labels"], batch["model_inputs"]["gender_ids"],
                                      w_prev, cfg.beta, weight=w)
        fused = torch.einsum("btm,tm->bt", tm, w_new)
        pw = None if pos_weight is None else torch.as_tensor(
            np.asarray(pos_weight), dtype=torch.float32, device=fused.device)
        per = focal_loss(fused, batch["labels"], gamma=cfg.train.gamma, pos_weight=pw,
                         reduction="none")
        wc = w.to(per.dtype)[:, None]
        denom = torch.clamp(wc.sum(), min=1.0)
        loss = ((per * wc).sum(dim=0) / denom).sum()
        reg = (((fused[:, 0] - 1.0) ** 2) * w.to(fused.dtype)).sum() / denom
        return loss + cfg.reg_weight * reg, w_new, fused

    return loss_fn


def run_eddi_fusion_experiment(structured, unstructured,
                               config: Optional[EDDIFusionPipelineConfig] = None,
                               text_encoder: Optional[TextEncoder] = None,
                               verbose: bool = True, device=None) -> Dict:
    cfg = config or EDDIFusionPipelineConfig()
    device = resolve_device(device)
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

    n_ages, n_gen, n_eth, n_ins = prep.vocab_sizes()
    tasks = (("mortality", "los", "mech") if task_index is None
             else tuple(TASK_SHORT[t] for t in task_names))
    model = init_params(EDDIFusionFull(
        n_ages, n_gen, n_eth, n_ins, prep.bundle.num_lab_features,
        hidden_size=cfg.hidden_size, demo_layers=cfg.demo_layers, demo_heads=cfg.demo_heads,
        lab_layers=cfg.lab_layers, lab_heads=cfg.lab_heads, tasks=tasks,
        text_embed_size=prep.bundle.text_embeddings.shape[1], dtype=dtype),
        seed=cfg.train.seed).to(device)
    loss_fn = make_eddi_fusion_loss(model, cfg, pos_weight=prep.pos_weight)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.train.lr)
    generator = make_generator(cfg.train.seed)
    train_gen = None if cfg.train.deterministic_forward else generator
    batches = lambda split: PrefetchLoader(prep.loaders[split], device)   # noqa: E731
    next(iter(prep.loaders["train"]))       # the JAX init example's shuffle
    weights = torch.full((len(task_names), 3), 0.33, dtype=torch.float32, device=device)

    def evaluate(split, w_prev):
        model.eval()
        with torch.inference_mode():
            return [(*loss_fn(b, w_prev), b) for b in batches(split)]

    sched = PlateauScheduler(cfg.train.lr, cfg.train.scheduler_factor,
                             cfg.train.scheduler_patience)
    stopper = EarlyStopper(cfg.train.patience)
    best = {k: v.detach().clone() for k, v in model.state_dict().items()}
    history = []
    timer.mark("split_and_loaders")       # the model's build and init
    for epoch in range(cfg.train.num_epochs):
        model.train()
        losses = []
        for batch in batches("train"):
            loss, _, _ = loss_fn(batch, weights, train_gen)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
        nb = len(losses)
        total = float(np.sum(torch.stack(losses).cpu().numpy(), dtype=np.float64)) if nb else 0.0
        val = evaluate("val", weights)
        last_val_weights = val[-1][1] if val else None
        val_loss = (float(np.mean(torch.stack([v[0] for v in val]).cpu().numpy(),
                                  dtype=np.float64)) if val else float("inf"))
        if verbose:
            print(f"[Epoch {epoch + 1}] Train Loss: {total / max(nb, 1):.4f} "
                  f"| Val Loss: {val_loss:.4f}")
        _ = sched.step(val_loss)        # computed and not applied, as 08 does
        stop = stopper.step(val_loss)
        if stopper.improved:
            best = {k: v.detach().clone() for k, v in model.state_dict().items()}
        history.append({"epoch": epoch + 1, "train_loss": total / max(nb, 1),
                        "val_loss": val_loss, "weights": weights.cpu().numpy().tolist()})
        if stop:
            # 08 breaks before the weight update (08:908-916).
            if verbose:
                print("Early stopping triggered.")
            break
        if last_val_weights is not None:
            weights = last_val_weights.clone()
            if verbose:
                print("Updated old EDDI weights for next epoch:",
                      weights.cpu().numpy().round(4).tolist())

    timer.mark("train")
    model.load_state_dict(best)
    test = evaluate("test", weights)
    keep = [b["weight"].cpu().numpy() > 0 for _, _, _, b in test]
    logits = np.concatenate([f.cpu().numpy()[k] for (_, _, f, _), k in zip(test, keep)])
    labels = np.concatenate([b["labels"].cpu().numpy()[k] for (*_, b), k in zip(test, keep)])
    sensitive = {a: np.concatenate([b["model_inputs"][key].cpu().numpy()[k]
                                    for (*_, b), k in zip(test, keep)])
                 for a, key in SENSITIVE}
    metrics, fairness = evaluate_multitask(logits, labels, sensitive, 0.5,
                                           task_names=task_names, verbose=verbose)
    eddi = eddi_report(logits, labels, sensitive, 0.5, task_names=task_names, verbose=verbose)
    timer.mark("eval")
    return {"metrics": metrics, "fairness": fairness, "eddi": eddi, "history": history,
            "best_params": best, "weights": weights.cpu().numpy(), "prep": prep,
            "model": model, "timings": timer.result()}
