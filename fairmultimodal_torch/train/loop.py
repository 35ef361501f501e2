"""Training loop of the FAME model (port of ``fairmultimodal_tpu/train/loop.py``).

- :meth:`FAMETrainer.train_step`: forward (dropout from the trainer's Philox
  generator), BCE(pos_weight) + lambda_edd * (10 * L_EDDI) + lambda_l1 *
  ||sig_weights||_1, backward (on the card through the half-layers'
  backward kernels), torch's clip at ``grad_clip`` and AdamW with weight
  decay; the loss-free modality heads are outside the optimizer.
- Per-epoch dynamic EDDI weights are a [3, 3] (task x modality) float64
  array on the host, passed to every forward; the per-batch statistics of
  the update (``loop.py:332-362``) stay on the device and are pulled once.
- :class:`PlateauScheduler` and :class:`EarlyStopper` are torch
  ``ReduceLROnPlateau(factor, patience)`` and the reference's best-val-loss
  early stop (10_FAME.py:829-840).
- Batches are nested dicts ``{"model_inputs": {...}, "labels": [B, 3],
  "weight": [B]}`` of numpy arrays (or tensors); padded rows carry weight 0
  and change no loss, metric or statistic.

Train and eval passes take a host loader (``NestedLoader`` over
``BatchIterator``) or a :class:`~fairmultimodal_torch.data.device.DeviceLoader`.
The eval passes read the live model: load ``fit``'s best state into
``trainer.model`` first (the JAX trainer passes ``best_params`` to them).

:meth:`FAMETrainer.fit` takes a
:class:`~fairmultimodal_torch.utils.checkpoint.Checkpointer`: the train
state is saved after each epoch's dynamic-weight update and the latest step
is restored on entry, so a resumed run continues bit for bit.

Data parallelism (``mesh=``, the JAX trainer's ``shard_map`` path,
``loop.py:203-276``): every rank holds the whole model and takes its
contiguous ``B / world`` rows of each batch (``parallel.shard_batch``; the
loaders shard for it).  The BCE and L_EDDI are global values with a local
gradient path (``parallel.global_sum``), the L1 term enters rank 0's
gradient only, and the gradients are summed in one flat all-reduce per step
before the zero-grad rule, the clip and AdamW, so every rank takes the same
step and the parameters stay bit-identical.  The eval passes gather their
per-row outputs back to global arrays in batch order; the dynamic-weight
statistics are summed over the ranks (exact integer sums: bit-identical to
one process).  Each rank folds its rank into its dropout seeds
(``utils.rng.RankGenerator``); the generator's stream, and so every
checkpoint, is the single process's.  Only rank 0 writes files.

Tensor parallelism (a mesh with ``model > 1``, the JAX trainer's mixed-mesh
GSPMD path, ``loop.py:213-246``): the model's Megatron pairs are sharded
over the model group (``parallel.shard_params_tp``, before the trainer is
built; an unsharded model trains replicated).  Every collective over the
batch -- the losses, the gradient sum, the dynamic-weight statistics, the
gathered eval rows -- runs over the **data group** (the ranks with this
rank's model index), and the batch is split by the data index, so the ranks
of a model group take the same rows.  The L1 term enters on data index 0.
The clip takes the global norm: the shards' square-sums summed over the
model group, each replicated gradient counted once; AdamW steps each shard.
Dropout sites fold the data index, and the sharded FFN's inner site the
model index too (``utils/rng.py``).  Checkpoints and the best state hold the
full parameters and moments, gathered over the model group, so one process
reads them.

Not ported here (ROADMAP): the one-dispatch statistics scan (the batchwise
pass gives the same weights: its statistics are exact integer sums).
"""

from __future__ import annotations

import csv
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fairmultimodal_torch import EXPECTED_AGE_CODES, EXPECTED_ETHNICITY_CODES, \
    EXPECTED_INSURANCE_CODES, TASKS
from fairmultimodal_torch.data.prefetch import PrefetchLoader
from fairmultimodal_torch.fairness.eddi import combined_eddi, eddi_from_stats
from fairmultimodal_torch.fairness.loss import eddi_loss
from fairmultimodal_torch.ops.gates import resolve_device
from fairmultimodal_torch.ops.losses import bce_with_logits
from fairmultimodal_torch.ops.optim import make_adamw
from fairmultimodal_torch.parallel.sharding import (all_reduce_flat, full_optimizer_state,
                                                    full_state_dict, gather_rows, grad_norm_sq,
                                                    load_full_optimizer_state,
                                                    load_full_state_dict, replicate,
                                                    shard_state_dict, tp_plan)
from fairmultimodal_torch.utils.rng import RankGenerator, make_generator

__all__ = ["TrainConfig", "PlateauScheduler", "EarlyStopper", "FAMETrainer"]

MODALITIES = ("demo", "lab", "text")
GROUP_SIZES = (len(EXPECTED_AGE_CODES), len(EXPECTED_ETHNICITY_CODES),
               len(EXPECTED_INSURANCE_CODES))
_SENSITIVE = ("age_ids", "ethnicity_ids", "insurance_ids")


@dataclasses.dataclass
class TrainConfig:
    """Hyperparameters; defaults are the reference grid (10_FAME.py:921-924)."""

    lr: float = 1e-5
    num_epochs: int = 50
    lambda_edd: float = 0.8
    lambda_l1: float = 0.01
    batch_size: int = 16
    threshold: float = 0.5
    weight_decay: float = 0.01
    beta: float = 1.0
    patience: int = 5
    scheduler_factor: float = 0.1
    scheduler_patience: int = 2
    grad_clip: float = 1.0
    seed: int = 42
    # Dropout randomness: counter-based Philox seeded from a torch.Generator
    # (utils/rng.py) -- the JAX package's "unsafe_rbg" / "threefry" choice.
    rng_impl: str = "philox"
    # Test hook: the train forward without dropout, so trajectories compare
    # against the JAX trainer's deterministic_forward.  Never set in
    # production configs.
    deterministic_forward: bool = False


class PlateauScheduler:
    """torch ReduceLROnPlateau(mode=min, threshold=1e-4 rel) semantics."""

    def __init__(self, lr: float, factor: float = 0.1, patience: int = 2,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad = 0

    def step(self, val_loss: float) -> float:
        if val_loss < self.best * (1.0 - self.threshold):
            self.best = val_loss
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr


class EarlyStopper:
    """Best-val-loss early stopping (strict improvement, 10_FAME.py:830-840)."""

    def __init__(self, patience: int = 5):
        self.patience = patience
        self.best = float("inf")
        self.counter = 0
        self.improved = False

    def step(self, val_loss: float) -> bool:
        """Returns True when training should stop."""
        if val_loss < self.best:
            self.best = val_loss
            self.counter = 0
            self.improved = True
            return False
        self.improved = False
        self.counter += 1
        return self.counter >= self.patience


class FAMETrainer:
    """Runs the FAME training protocol on ``model`` (a
    :class:`~fairmultimodal_torch.models.fusion.FAMEModel`, moved to
    ``device``; ``None`` means CUDA and raises without it).

    Unlike the JAX trainer, which threads explicit params and optimizer
    state, the model's parameters are updated in place and the optimizer
    (``self.optimizer``) lives on the trainer; :meth:`fit` starts a fresh
    one, as the JAX ``fit`` inits its optimizer state.

    With a ``mesh`` (:func:`~fairmultimodal_torch.parallel.get_mesh`) the
    trainer runs on ``mesh.device``, broadcasts data index 0's weights, and
    every batch it is given is this rank's data shard of a global batch of
    ``config.batch_size`` rows.
    """

    def __init__(self, model, config: TrainConfig, pos_weight, rngs_seed: int = 0,
                 device=None, dynamic_weights_csv: Optional[str] = None, mesh=None):
        if config.rng_impl != "philox":
            raise ValueError(f"rng_impl {config.rng_impl!r}: the port's dropout is 'philox'")
        self.mesh = mesh
        if mesh is not None:
            if config.batch_size % mesh.data:
                raise ValueError(
                    f"batch_size {config.batch_size} must be divisible by the mesh's data "
                    f"axis ({mesh.data}) for the data-parallel path")
            device = mesh.device
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        if mesh is not None:
            replicate(self.model, mesh)
        self.config = config
        # fp32 like the JAX trainer's (jnp.float32); promoted inside the loss.
        self.pos_weight = torch.as_tensor(np.asarray(pos_weight), dtype=torch.float32,
                                          device=self.device)
        self.dynamic_weights_csv = dynamic_weights_csv
        self.generator = make_generator(rngs_seed)
        # Every rank draws the single process's seeds, each folded with its
        # data index (and on a sharded site its model index).
        self._dropout_rng = (self.generator if mesh is None
                             else RankGenerator(self.generator, mesh.data_index,
                                                mesh.model_index))
        self.optimizer = make_adamw(self.model, config.lr, config.weight_decay)
        # Host dynamic weights stay float64 like the reference's python floats.
        self.dynamic_weights = np.full((3, 3), 0.33)
        self.history: List[Dict[str, Any]] = []
        self.tracked_dynamic_weights = {t: [] for t in TASKS}
        self.tracked_sigmoid_weights: List[np.ndarray] = []

    # -- steps --------------------------------------------------------------------

    def _dyn_w(self, dynamic_weights=None) -> torch.Tensor:
        dw = self.dynamic_weights if dynamic_weights is None else dynamic_weights
        return torch.as_tensor(dw, device=self.device)

    @property
    def _group(self):
        return None if self.mesh is None else self.mesh.data_group

    @property
    def _rank0(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _loss(self, out, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        logits, labels, w = out["fused_logits"], batch["labels"], batch["weight"]
        bce = bce_with_logits(logits, labels, pos_weight=self.pos_weight, weight=w,
                              group=self._group)
        mi = batch["model_inputs"]
        leddi = eddi_loss(torch.sigmoid(logits), labels, [mi[k] for k in _SENSITIVE],
                          GROUP_SIZES, weight=w, group=self._group)
        l1 = self.model.fusion.sig_weights.abs().sum()
        if self.mesh is not None and self.mesh.data_index:
            # A term of the parameters alone: the gradients are summed over
            # the data group, so it enters through data index 0's only.
            l1 = l1.detach()
        cfg = self.config
        return bce + cfg.lambda_edd * (10.0 * leddi) + cfg.lambda_l1 * l1, bce

    def backward(self, batch, dynamic_weights=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward and backward of one device batch (this rank's shard under a
        mesh), leaving in each optimized parameter's ``.grad`` the gradient
        of the global loss; returns the (total, bce) loss tensors."""
        self.model.train()
        gen = None if self.config.deterministic_forward else self._dropout_rng
        out = self.model(batch["model_inputs"], dynamic_weights=self._dyn_w(dynamic_weights),
                         generator=gen)
        total, bce = self._loss(out, batch)
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        # A trainable parameter the step does not reach (the demo BERT's
        # query/key at one token) gets a zero gradient, as jax.grad gives it,
        # so AdamW still decays it; the loss-free heads are not in the
        # optimizer and keep no gradient.
        params = [p for group in self.optimizer.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.mesh is not None:
            all_reduce_flat([p.grad for p in params], self.mesh)
        return total.detach(), bce.detach()

    def train_step(self, batch, dynamic_weights=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step on a device batch; returns the (total, bce) loss
        tensors, left on the device."""
        total, bce = self.backward(batch, dynamic_weights)
        if tp_plan(self.model):
            self._clip_global()
        else:
            torch.nn.utils.clip_grad_norm_(self.model.parameters(), self.config.grad_clip)
        self.optimizer.step()
        return total, bce

    @torch.no_grad()
    def _clip_global(self) -> None:
        """torch's clip (``clip_grad_norm_``'s ``max / (norm + 1e-6)``,
        clamped at 1) at the global norm of a sharded model's gradients."""
        params = [p for p in self.model.parameters() if p.grad is not None]
        norm = grad_norm_sq(params, self.model).sqrt()
        coef = torch.clamp(self.config.grad_clip / (norm + 1e-6), max=1.0)
        torch._foreach_mul_([p.grad for p in params], coef)

    def set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def _batches(self, loader):
        return PrefetchLoader(loader, self.device, mesh=self.mesh)

    def train_epoch(self, loader) -> Tuple[float, float]:
        """One pass; the step losses stay on the device until the pass ends
        and come back in one pull.  Returns mean (total, bce)."""
        dyn_w = self._dyn_w()
        totals, bces = [], []
        for batch in self._batches(loader):
            total, bce = self.train_step(batch, dyn_w)
            totals.append(total)
            bces.append(bce)
        nb = len(totals)
        if not nb:
            return 0.0, 0.0
        stacked = torch.stack(totals + bces).cpu().numpy()
        return (float(np.sum(stacked[:nb], dtype=np.float64)) / nb,
                float(np.sum(stacked[nb:], dtype=np.float64)) / nb)

    def _eval_pass(self, loader, fn: Callable) -> List[Tuple[Any, Dict]]:
        """``fn(out, batch)`` over every batch in eval mode without autograd;
        the results stay on the device, with the batch, for one pull."""
        self.model.eval()
        dyn_w = self._dyn_w()
        results = []
        with torch.inference_mode():
            for batch in self._batches(loader):
                results.append((fn(self.model(batch["model_inputs"], dynamic_weights=dyn_w),
                                   batch), batch))
        return results

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    def _rows(self, t: torch.Tensor) -> np.ndarray:
        """Per-row values of a (sharded) batch, in global batch order, on the host."""
        return self._host(t if self.mesh is None else gather_rows(t, self.mesh))

    def validate(self, loader) -> Tuple[float, np.ndarray, np.ndarray]:
        """Mean val BCE over batches (10_FAME.py:825), logits and labels of
        the real rows."""
        res = self._eval_pass(loader, lambda out, b: (
            bce_with_logits(out["fused_logits"], b["labels"], pos_weight=self.pos_weight,
                            weight=b["weight"], group=self._group), out["fused_logits"]))
        if not res:
            return float("inf"), np.zeros((0, 3)), np.zeros((0, 3))
        losses = [float(v) for v in self._host(torch.stack([r[0][0] for r in res]))]
        keep = [self._rows(b["weight"]) > 0 for _, b in res]
        logits = np.concatenate([self._rows(r[0][1])[k] for r, k in zip(res, keep)])
        labels = np.concatenate([self._rows(b["labels"])[k] for (_, b), k in zip(res, keep)])
        return float(np.mean(losses)), logits, labels

    def _collect(self, res, named: Dict[str, Callable]) -> Dict[str, np.ndarray]:
        out = {k: [] for k in named}
        for item, batch in res:
            keep = self._rows(batch["weight"]) > 0
            for k, get in named.items():
                out[k].append(self._rows(get(item, batch))[keep])
        return {k: np.concatenate(v) if v else np.zeros(0) for k, v in out.items()}

    def _sensitive(self) -> Dict[str, Callable]:
        return {"labels": lambda i, b: b["labels"],
                "age": lambda i, b: b["model_inputs"]["age_ids"],
                "ethnicity": lambda i, b: b["model_inputs"]["ethnicity_ids"],
                "insurance": lambda i, b: b["model_inputs"]["insurance_ids"]}

    def predict_logits(self, loader) -> Dict[str, np.ndarray]:
        res = self._eval_pass(loader, lambda out, b: out["fused_logits"])
        return self._collect(res, {"logits": lambda i, b: i, **self._sensitive()})

    def extract_vectors(self, loader) -> Dict[str, np.ndarray]:
        """Per real row: the 768-d ``gated_vectors`` and 512-d
        ``fusion_pre_relu_vectors`` plus labels / age / ethnicity / insurance,
        under the reference's npz key names (10_FAME.py:559-604)."""
        res = self._eval_pass(loader, lambda out, b: (out["gated_vector"],
                                                      out["fusion_pre_relu"]))
        return self._collect(res, {"gated_vectors": lambda i, b: i[0],
                                   "fusion_pre_relu_vectors": lambda i, b: i[1],
                                   **self._sensitive()})

    def dynamic_weight_stats(self, loader, threshold: float = 0.5) -> np.ndarray:
        """The statistics of :meth:`update_dynamic_weights`, flat in float64:
        per attribute, group counts [G] then per-(modality, task) error
        counts [M, T, G].  Each batch reduces to them on the device (exact
        small-integer sums in fp32) and their sum comes back in one pull;
        under a mesh it is summed over the ranks too (exact: the single
        process's bits)."""
        def stats(out, b):
            ml = out["modality_logits"]
            probs = torch.sigmoid(torch.stack([ml[m] for m in MODALITIES], dim=1))  # [B, M, T]
            err = ((probs > threshold).float() != b["labels"][:, None, :].float()).float()
            w = b["weight"].float()
            res = []
            for key, g in zip(_SENSITIVE, GROUP_SIZES):
                groups = torch.arange(g, device=w.device)
                onehot = (b["model_inputs"][key].long()[:, None] == groups).float() * w[:, None]
                res += [onehot.sum(dim=0), torch.einsum("bmt,bg->mtg", err, onehot)]
            return torch.cat([r.reshape(-1) for r in res])

        res = self._eval_pass(loader, stats)
        if not res:
            return np.zeros(sum(s for g in GROUP_SIZES for s in (g, 9 * g)))
        summed = torch.stack([r for r, _ in res]).sum(dim=0)
        if self.mesh is not None:
            all_reduce_flat([summed], self.mesh)
        return self._host(summed).astype(np.float64)

    def update_dynamic_weights(self, loader, threshold: float = 0.5) -> np.ndarray:
        """Per-epoch EDDI-guided weight update (10_FAME.py:315-399) from
        :meth:`dynamic_weight_stats`, on the host in float64: per task, each
        modality's weight moves by clip(beta * (eddi_max - eddi_m), +-0.05),
        floored at 0.1 and renormalised."""
        sizes = [s for g in GROUP_SIZES for s in (g, 9 * g)]
        parts = np.split(self.dynamic_weight_stats(loader, threshold), np.cumsum(sizes)[:-1])
        counts = parts[0::2]
        errors = [e.reshape(3, 3, -1) for e in parts[1::2]]

        new_w = np.zeros_like(self.dynamic_weights)
        for t in range(3):
            eddis = [combined_eddi(*[eddi_from_stats(counts[a], errors[a][m, t])
                                     for a in range(3)]) for m in range(3)]
            upd = np.clip(self.config.beta * (max(eddis) - np.asarray(eddis)), -0.05, 0.05)
            w = np.maximum(self.dynamic_weights[t] + upd, 0.1)
            new_w[t] = w / w.sum()
        self.dynamic_weights = new_w
        return self.dynamic_weights

    # -- protocol -------------------------------------------------------------------

    def _state_copy(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    def _checkpoint_state(self, best, sched, stopper, csv_rows, loader_epoch) -> Dict:
        """Everything a resumed ``fit`` needs, as CPU tensors and plain
        Python values (``torch.load(weights_only=True)`` reads it)."""
        def cpu(tree):
            if isinstance(tree, torch.Tensor):
                return tree.detach().cpu()
            if isinstance(tree, dict):
                return {k: cpu(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(cpu(v) for v in tree)
            return tree

        return {
            "model": cpu(full_state_dict(self.model)),
            "best": cpu(full_state_dict(self.model, best)),
            "optimizer": cpu(full_optimizer_state(self.model, self.optimizer)),
            "dynamic_weights": torch.from_numpy(np.array(self.dynamic_weights, np.float64)),
            "scheduler": {"lr": sched.lr, "best": sched.best, "num_bad": sched.num_bad},
            "stopper": {"best": stopper.best, "counter": stopper.counter},
            "generator": self.generator.get_state(),
            "history": self.history,
            "tracked_dynamic_weights": self.tracked_dynamic_weights,
            "tracked_sigmoid_weights": [torch.from_numpy(np.array(w))
                                        for w in self.tracked_sigmoid_weights],
            "csv_rows": [list(r) for r in csv_rows],
            "loader_epoch": loader_epoch,
        }

    def _restore(self, state: Dict, sched, stopper):
        """Load a :meth:`_checkpoint_state`; returns (best, csv_rows,
        loader_epoch)."""
        load_full_state_dict(self.model, state["model"])
        best = shard_state_dict(self.model, {k: v.to(self.device)
                                             for k, v in state["best"].items()})
        load_full_optimizer_state(self.model, self.optimizer, state["optimizer"])
        self.dynamic_weights = state["dynamic_weights"].numpy().astype(np.float64)
        sched.lr, sched.best, sched.num_bad = (state["scheduler"][k]
                                               for k in ("lr", "best", "num_bad"))
        stopper.best, stopper.counter = state["stopper"]["best"], state["stopper"]["counter"]
        self.set_lr(sched.lr)
        self.generator.set_state(state["generator"])
        self.history = list(state["history"])
        self.tracked_dynamic_weights = {t: list(v) for t, v in
                                        state["tracked_dynamic_weights"].items()}
        self.tracked_sigmoid_weights = [w.numpy() for w in state["tracked_sigmoid_weights"]]
        return best, [tuple(r) for r in state["csv_rows"]], state["loader_epoch"]

    def fit(self, train_loader, val_loader, verbose: bool = True,
            on_epoch_end: Optional[Callable] = None, checkpointer=None):
        """Epochs + plateau LR + early stop + best-state capture + per-epoch
        dynamic weight updates.  Returns (best state dict, history); a
        sharded model's best state holds the full parameters
        (``parallel.load_full_state_dict`` loads it back).

        With a ``checkpointer`` the full train state (model and best state,
        AdamW's state, the float64 dynamic weights, the scheduler and stopper
        scalars, the dropout generator, the histories and CSV rows, and the
        train loader's consumed-epoch count) is saved after each epoch's
        dynamic-weight update, and the latest step is restored on entry.
        Under a mesh every rank restores; give the checkpointer the mesh, so
        that rank 0 alone writes.

        The loader's count is what makes the resume bit-identical.  Each
        completed epoch draws two ``(seed, epoch)`` permutations from the
        train loader, one for the train pass and one for the dynamic-weight
        pass.  The JAX ``fit`` re-aligns the loader to ``start_epoch``
        instead (``loop.py:745-750``), so its resumed run draws other
        shuffles from the second epoch on: a fault of the JAX package, which
        the port does not copy.  An uninterrupted run is the JAX one.
        """
        cfg = self.config
        self.optimizer = make_adamw(self.model, cfg.lr, cfg.weight_decay)
        sched = PlateauScheduler(cfg.lr, cfg.scheduler_factor, cfg.scheduler_patience)
        stopper = EarlyStopper(cfg.patience)
        best = self._state_copy()
        csv_rows = [("Epoch", "Outcome", "demo_weight", "lab_weight", "text_weight")]
        inner = getattr(train_loader, "it", train_loader)
        loader_epoch, start_epoch = 0, 0    # the (seed, epoch) shuffles start at epoch 0
        if checkpointer is not None:
            latest = checkpointer.latest_step()
            if latest is not None:
                best, csv_rows, loader_epoch = self._restore(
                    checkpointer.restore(latest), sched, stopper)
                start_epoch = latest
                if verbose:
                    print(f"Resumed from checkpoint at epoch {latest}.")
        if hasattr(inner, "epoch"):
            inner.epoch = loader_epoch

        for epoch in range(start_epoch, cfg.num_epochs):
            t0 = time.time()
            train_loss, train_bce = self.train_epoch(train_loader)
            val_loss, _, _ = self.validate(val_loader)
            prev_lr = sched.lr
            lr = sched.step(val_loss)
            self.set_lr(lr)
            if verbose and lr != prev_lr:
                print(f"Epoch {epoch + 1}: reducing learning rate to {lr:.4e}.")
            if verbose:
                print(f"[Epoch {epoch + 1}] Train Loss: {train_loss:.4f} | "
                      f"Val Loss: {val_loss:.4f} ({time.time() - t0:.1f}s)")
            stop = stopper.step(val_loss)
            if stopper.improved:
                best = self._state_copy()
                if verbose:
                    print("Validation loss improved. Saving model...")
            elif verbose:
                print(f"No improvement for {stopper.counter} consecutive epochs.")
            self.history.append({"epoch": epoch + 1, "train_loss": train_loss,
                                 "train_bce": train_bce, "val_loss": val_loss, "lr": lr})
            if stop:
                if verbose:
                    print("Early stopping triggered.")
                break

            new_w = self.update_dynamic_weights(train_loader, cfg.threshold)
            for ti, task in enumerate(TASKS):
                self.tracked_dynamic_weights[task].append(list(map(float, new_w[ti])))
                csv_rows.append((epoch + 1, task, *[f"{v:.6f}" for v in new_w[ti]]))
                if verbose:
                    print(f"[{task} Weight Update] New dynamic weights: "
                          f"{{'demo': {new_w[ti][0]:.6f}, 'lab': {new_w[ti][1]:.6f}, "
                          f"'text': {new_w[ti][2]:.6f}}}")
            self.tracked_sigmoid_weights.append(
                self._host(torch.sigmoid(self.model.fusion.sig_weights.detach())))
            if checkpointer is not None:
                state = lambda: self._checkpoint_state(    # noqa: E731
                    best, sched, stopper, csv_rows, getattr(inner, "epoch", None))
                # A sharded model's state is gathered by every rank of its group.
                checkpointer.save(epoch + 1, state() if tp_plan(self.model) else state)
            if on_epoch_end is not None:
                on_epoch_end(epoch, self.model)

        if self.dynamic_weights_csv and self._rank0:
            with open(self.dynamic_weights_csv, "w", newline="") as f:
                csv.writer(f).writerows(csv_rows)
        return full_state_dict(self.model, best), self.history
