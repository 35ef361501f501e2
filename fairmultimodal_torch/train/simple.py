"""The multitask trainer of the baseline models (port of
``fairmultimodal_tpu/train/simple.py``).

Every non-FAME training script of the reference shares one protocol
(01_BEHRT.py:204-305, 02:489-527, 07:531-640, 09:512-640): a per-task
criterion (BCE with ``pos_weight`` or the focal loss) summed over the tasks,
Adam or AdamW, ReduceLROnPlateau after each epoch, early stopping on the
best validation loss, and the best state kept.  :class:`MultitaskTrainer`
runs that protocol on any model whose forward takes a ``model_inputs`` dict
(and a dropout generator) and returns ``{"logits": [B, T], ...}``.

As in :class:`~fairmultimodal_torch.train.loop.FAMETrainer`, the model's
parameters are updated in place and the optimizer lives on the trainer.
The semantics kept from the JAX trainer:

- the loss is the masked batch mean of each task's loss, summed over the
  tasks, with the denominator ``max(sum(weight), 1)`` (``simple.py:56-72``);
- the optimizer is Adam, or AdamW with ``weight_decay`` (0.0 by default,
  passed explicitly: torch's AdamW defaults to 0.01), over every parameter;
- the clip is torch's ``clip_grad_norm_`` (the ``+1e-6`` denominator of
  ``clip_by_global_norm_torch``), only when ``grad_clip`` is set;
- :meth:`set_lr` applies the plateau learning rate after every epoch, as the
  float32 the JAX ``set_lr`` stores;
- dropout seeds come from the trainer's own :class:`torch.Generator`;
  ``deterministic_forward`` (a test hook) trains without dropout;
- ``loss_extras(model, out, batch)`` (the JAX hook's ``fn(params, out,
  batch)``, the module in place of the parameters) is added to the task
  loss of every train and eval batch (``simple.py:82-91, 107-119``): 06's
  contrastive term.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fairmultimodal_torch.data.prefetch import PrefetchLoader
from fairmultimodal_torch.ops.gates import resolve_device
from fairmultimodal_torch.ops.losses import bce_with_logits, focal_loss
from fairmultimodal_torch.train.loop import EarlyStopper, PlateauScheduler
from fairmultimodal_torch.utils.rng import make_generator

__all__ = ["SimpleTrainConfig", "MultitaskTrainer", "masked_task_loss"]


@dataclasses.dataclass
class SimpleTrainConfig:
    lr: float = 1e-4
    num_epochs: int = 20
    batch_size: int = 16
    weight_decay: float = 0.0
    loss: str = "focal"              # "focal" | "bce"
    gamma: float = 1.0               # focal gamma (02 uses 2, 07/09 use 1)
    optimizer: str = "adam"          # "adam" | "adamw"
    patience: int = 5
    scheduler_factor: float = 0.1
    scheduler_patience: int = 2
    grad_clip: Optional[float] = None
    seed: int = 42
    # Test hook: the train forward without dropout, so trajectories compare
    # against the JAX trainer's.  Never set in production configs.
    deterministic_forward: bool = False


def masked_task_loss(logits: torch.Tensor, labels: torch.Tensor, weight: torch.Tensor, *,
                     loss: str, gamma: float,
                     pos_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum over tasks of each task's masked batch-mean loss: the reference's
    ``crit_mort(...) + crit_los(...) + crit_vent(...)`` (01_BEHRT.py:233-236)."""
    if loss == "bce":
        per = bce_with_logits(logits, labels, pos_weight=pos_weight, reduction="none")
    else:
        per = focal_loss(logits, labels, gamma=gamma, pos_weight=pos_weight, reduction="none")
    w = weight[:, None].to(per.dtype)
    return ((per * w).sum(dim=0) / torch.clamp(w.sum(), min=1.0)).sum()


class MultitaskTrainer:
    """Runs the baseline protocol on ``model`` (moved to ``device``; ``None``
    means CUDA and raises without it).

    Batches: ``{"model_inputs": {...}, "labels": [B, T], "weight": [B]}``.
    """

    def __init__(self, model, config: SimpleTrainConfig, pos_weight=None, device=None,
                 loss_extras: Optional[Callable] = None):
        self.device = resolve_device(device)
        self.loss_extras = loss_extras
        self.model = model.to(self.device)
        self.config = config
        self.pos_weight = (None if pos_weight is None else torch.as_tensor(
            np.asarray(pos_weight), dtype=torch.float32, device=self.device))
        self.generator = make_generator(config.seed)
        self.history: List[Dict[str, Any]] = []
        self.optimizer = self.init()

    def init(self) -> torch.optim.Optimizer:
        """A fresh optimizer over every parameter (the JAX ``tx.init``)."""
        cfg = self.config
        params = list(self.model.parameters())
        if cfg.optimizer == "adamw":
            self.optimizer = torch.optim.AdamW(params, lr=cfg.lr,
                                               weight_decay=cfg.weight_decay)
        elif cfg.optimizer == "adam":
            self.optimizer = torch.optim.Adam(params, lr=cfg.lr)
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        return self.optimizer

    def set_lr(self, lr: float) -> None:
        # The JAX set_lr stores jnp.asarray(lr, jnp.float32).
        for group in self.optimizer.param_groups:
            group["lr"] = float(np.float32(lr))

    def _loss(self, batch, generator) -> Tuple[torch.Tensor, torch.Tensor]:
        out = self.model(batch["model_inputs"], generator=generator)
        logits = out["logits"]
        cfg = self.config
        loss = masked_task_loss(logits, batch["labels"], batch["weight"], loss=cfg.loss,
                                gamma=cfg.gamma, pos_weight=self.pos_weight)
        if self.loss_extras is not None:
            loss = loss + self.loss_extras(self.model, out, batch)
        return loss, logits

    def train_step(self, batch) -> torch.Tensor:
        """One optimizer step on a device batch; returns the loss tensor,
        left on the device."""
        self.model.train()
        gen = None if self.config.deterministic_forward else self.generator
        loss, _ = self._loss(batch, gen)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        # A parameter the step does not reach (the demo BERT's query / key at
        # one token) gets a zero gradient, as jax.grad gives it.
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        if self.config.grad_clip:
            torch.nn.utils.clip_grad_norm_(self.model.parameters(), self.config.grad_clip)
        self.optimizer.step()
        return loss.detach()

    def _batches(self, loader):
        return PrefetchLoader(loader, self.device)

    def train_epoch(self, loader) -> float:
        """One pass; the losses come back in one pull at the end and are
        averaged in float64."""
        losses = [self.train_step(batch) for batch in self._batches(loader)]
        if not losses:
            return 0.0
        return float(np.sum(torch.stack(losses).cpu().numpy(), dtype=np.float64)) / len(losses)

    def _eval_pass(self, loader):
        """(loss, logits, batch) of every batch in eval mode without autograd,
        left on the device."""
        self.model.eval()
        with torch.inference_mode():
            return [(*self._loss(batch, None), batch) for batch in self._batches(loader)]

    def evaluate_loss(self, loader) -> float:
        res = self._eval_pass(loader)
        if not res:
            return float("inf")
        return float(np.mean(torch.stack([r[0] for r in res]).cpu().numpy().astype(np.float64)))

    def predict(self, loader, extra_keys: Tuple[str, ...] = ()) -> Dict[str, np.ndarray]:
        """Logits, labels and the ``model_inputs`` arrays named in
        ``extra_keys`` of the real rows of every batch."""
        out: Dict[str, list] = {"logits": [], "labels": [], **{k: [] for k in extra_keys}}
        for _, logits, batch in self._eval_pass(loader):
            keep = batch["weight"].cpu().numpy() > 0
            out["logits"].append(logits.cpu().numpy()[keep])
            out["labels"].append(batch["labels"].cpu().numpy()[keep])
            for k in extra_keys:
                out[k].append(batch["model_inputs"][k].cpu().numpy()[keep])
        return {k: (np.concatenate(v) if v else np.zeros((0,))) for k, v in out.items()}

    def _state_copy(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    def fit(self, train_loader, val_loader, verbose: bool = True):
        """Epochs + plateau LR + early stop + best-state capture, with the
        JAX ``fit``'s prints.  Returns (best state dict, history)."""
        cfg = self.config
        self.init()
        sched = PlateauScheduler(cfg.lr, cfg.scheduler_factor, cfg.scheduler_patience)
        stopper = EarlyStopper(cfg.patience)
        best = self._state_copy()
        for epoch in range(cfg.num_epochs):
            train_loss = self.train_epoch(train_loader)
            val_loss = self.evaluate_loss(val_loader)
            lr = sched.step(val_loss)
            self.set_lr(lr)
            if verbose:
                print(f"[Epoch {epoch + 1}] Train Loss: {train_loss:.4f} | "
                      f"Val Loss: {val_loss:.4f}")
            stop = stopper.step(val_loss)
            if stopper.improved:
                best = self._state_copy()
                if verbose:
                    print("Validation loss improved. Saving model...")
            self.history.append({"epoch": epoch + 1, "train_loss": train_loss,
                                 "val_loss": val_loss, "lr": lr})
            if stop:
                if verbose:
                    print("Early stopping triggered.")
                break
        return best, self.history
