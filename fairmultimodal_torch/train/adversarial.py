"""Adversarial debiasing, 04's stage 2 (port of
``fairmultimodal_tpu/train/adversarial.py``; reference 04_AdvDebias.py:559-789).

A predictor MLP (X -> hidden -> 1 logit) is trained jointly against an
adversary MLP that tries to recover the binarized sensitive attribute from
``(sigmoid(logit), y)``; the combined objective is

    L_pred - alpha * L_adv + L_pred / (L_adv + 1e-8)        (04:720)

The update is the reference's (04:724-731): it calls
``adv_loss.backward(retain_graph=True)`` and then ``combined.backward()``
with no ``detach()`` and no ``zero_grad`` between them, so both backward
passes land in both networks' ``.grad`` before either ``step()``.  Each
network takes one Adam step on ``d(L_adv + combined) / d(own parameters)``
at the old parameters: :func:`adversarial_step` runs one backward of
``combined + L_adv`` into both networks, then one ``torch.optim.Adam`` step
each (``optax.adam``'s arithmetic: the JAX package's torch oracle matches
the two step for step).  Alternating the two steps is another trajectory.
With ``adversarial=False`` the loss is ``L_pred`` alone and the adversary
is neither stepped nor saved.

Dropout is live in the train step only, with the port's Philox
(:mod:`fairmultimodal_torch.utils.rng`): one seed per site and iteration,
drawn on the host from a generator seeded with ``cfg.seed + 1`` (the JAX
package's ``threefry_key(cfg.seed + 1)``).  Validation is deterministic, as
in the JAX package (the reference leaves dropout on there; PARITY.md).
Nothing waits on the card inside the loop: the losses come to the host
only at the logged iterations.

The networks are ``nn.Module``\\ s with the flax names (``fc1``, ``fc2``), so
:mod:`fairmultimodal_torch.interop` maps them both ways.  A result holds the
trained modules under ``predictor`` / ``adversary`` where the JAX result
holds ``predictor_params`` / ``adversary_params`` trees
(``interop.flax_params(module)`` gives those).  Their initial values come
from :func:`~fairmultimodal_torch.models._layers.init_params` (another
generator than flax's).

``match_case_control`` and ``resample_smoteenn`` are the JAX package's numpy
draws in the same order, so their indices are the same.  SMOTEENN is
imblearn's; without imblearn ``resample_smoteenn`` runs the JAX package's
own random minority oversampling (the branch both packages take where
imblearn is not installed).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from fairmultimodal_torch.eval.metrics import roc_auc_score
from fairmultimodal_torch.interop import flax_params, load_flax_params
from fairmultimodal_torch.models._layers import dropout_seed, init_params
from fairmultimodal_torch.ops.gates import resolve_device
from fairmultimodal_torch.ops.losses import bce_with_logits
from fairmultimodal_torch.utils.checkpoint import (load_metadata_npz, load_params_npz,
                                                   save_params_npz)
from fairmultimodal_torch.utils.rng import dropout, make_generator

__all__ = ["AdvConfig", "AdvPredictor", "AdvAdversary", "train_adversarial",
           "adv_grid_search", "match_case_control", "resample_smoteenn",
           "adv_metrics", "REFERENCE_GRID", "REDUCED_GRID", "params_tostring",
           "save_adv_artifacts", "load_adv_artifact", "init_adv_models", "adversarial_step"]

# The reference stage-2 grid (04_AdvDebias.py:1081-1088): the full 2^6
# product, 64 points, the default.
REFERENCE_GRID: Dict[str, List] = {
    "learning_rate": [1e-4, 5e-5],
    "num_iters": [1000, 2000],
    "num_nodes": [64, 128],
    "num_nodes_adv": [32, 64],
    "dropout_rate": [0.3, 0.5],
    "alpha": [1, 2],
}

# One cheap point for tests and --tiny runs.
REDUCED_GRID: Dict[str, List] = {
    "learning_rate": [1e-3], "num_iters": [500], "num_nodes": [64],
    "num_nodes_adv": [32], "dropout_rate": [0.1], "alpha": [1.0],
}

# The reference's grid-point naming order (04_AdvDebias.py:555, 586-589).
_HYPERPARAMETER_LIST = ("learning_rate", "num_iters", "num_nodes",
                        "num_nodes_adv", "dropout_rate", "alpha")


def params_tostring(cfg: "AdvConfig") -> str:
    """Reference ``params_tostring`` (04:586-594): ``name_value`` joined by
    hyphens in the reference's order, with each value as the grid gave it
    (``alpha_1`` for the reference grid's int)."""
    return "-".join(f"{k}_{getattr(cfg, k)}" for k in _HYPERPARAMETER_LIST)


@dataclasses.dataclass
class AdvConfig:
    """One grid point (04:569-585); defaults are the first value of each
    ``REFERENCE_GRID`` axis.  The fields are the JAX package's: an
    artifact's metadata rebuilds it in either package."""

    learning_rate: float = 1e-4
    num_iters: int = 1000
    num_nodes: int = 64
    num_nodes_adv: int = 32
    dropout_rate: float = 0.3
    alpha: float = 1.0
    adversarial: bool = True
    seed: int = 25


class _MLP(nn.Module):
    """``fc1`` -> relu -> dropout -> ``fc2`` (one logit), fp32."""

    def __init__(self, in_features: int, hidden: int, dropout_rate: float):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, 1)
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = torch.relu(self.fc1(x))
        rate = self.dropout_rate
        return self.fc2(dropout(h, rate, dropout_seed(self, rate, generator)))


class AdvPredictor(_MLP):
    """X -> ``num_nodes`` -> 1 logit (the reference applies the sigmoid in
    the module and takes BCELoss; logits and BCE with logits are the same
    math, stabler)."""

    def __init__(self, num_features: int, num_nodes: int = 64, dropout_rate: float = 0.1):
        super().__init__(num_features, num_nodes, dropout_rate)


class AdvAdversary(_MLP):
    """``(y_hat, y)`` -> ``num_nodes_adv`` -> 1 logit (04:639-655)."""

    def __init__(self, num_nodes_adv: int = 32, dropout_rate: float = 0.1):
        super().__init__(2, num_nodes_adv, dropout_rate)


def init_adv_models(num_features: int, cfg: AdvConfig) -> Tuple[AdvPredictor, AdvAdversary]:
    """The grid point's two networks on the CPU, initialised from one
    generator seeded with ``cfg.seed`` (the JAX package splits one key)."""
    pred = AdvPredictor(num_features, cfg.num_nodes, cfg.dropout_rate)
    adv = AdvAdversary(cfg.num_nodes_adv, cfg.dropout_rate)
    init_params(nn.ModuleDict({"predictor": pred, "adversary": adv}), seed=cfg.seed)
    return pred, adv


def match_case_control(y: np.ndarray, match_number: int = 20,
                       seed: int = 0) -> np.ndarray:
    """1:``match_number`` case/control matching indices (04:677-692)."""
    rng = np.random.default_rng(seed)
    idx_case = np.flatnonzero(y == 1)
    idx_control = np.flatnonzero(y == 0)
    matched: List[int] = []
    for _ in idx_case:
        k = min(match_number, len(idx_control))
        matched.extend(rng.choice(idx_control, size=k, replace=False).tolist())
    return np.concatenate([np.asarray(matched, np.int64), idx_case])


def resample_smoteenn(X: np.ndarray, y: np.ndarray, z: np.ndarray,
                      seed: int = 25) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SMOTEENN over [X | z] as the reference does (04:694-702); random
    minority oversampling when imblearn is not installed."""
    Xz = np.concatenate([X, z.reshape(-1, 1)], axis=1)
    try:
        from imblearn.combine import SMOTEENN
        from imblearn.under_sampling import EditedNearestNeighbours

        res = SMOTEENN(enn=EditedNearestNeighbours(sampling_strategy="majority"),
                       random_state=seed)
        Xz_r, y_r = res.fit_resample(Xz, y)
    except Exception:
        rng = np.random.default_rng(seed)
        pos = np.flatnonzero(y == 1)
        neg = np.flatnonzero(y == 0)
        if len(pos) == 0 or len(neg) == 0:
            Xz_r, y_r = Xz, y
        else:
            n_extra = max(len(neg) - len(pos), 0)
            extra = rng.choice(pos, size=n_extra, replace=True)
            keep = np.concatenate([np.arange(len(y)), extra])
            Xz_r, y_r = Xz[keep], y[keep]
    return Xz_r[:, :-1], np.asarray(y_r, np.float32), (Xz_r[:, -1] > 0).astype(np.float32)


def _losses(pred: AdvPredictor, adv: AdvAdversary, X: torch.Tensor, y: torch.Tensor,
            z: torch.Tensor, cfg: AdvConfig,
            generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(combined, L_adv); (L_pred, None) when ``cfg.adversarial`` is off."""
    logits = pred(X, generator)
    l_pred = bce_with_logits(logits, y)
    if not cfg.adversarial:
        return l_pred, None
    l_adv = bce_with_logits(adv(torch.cat([torch.sigmoid(logits), y], dim=1), generator), z)
    return l_pred - cfg.alpha * l_adv + l_pred / (l_adv + 1e-8), l_adv


def adversarial_step(pred: AdvPredictor, adv: AdvAdversary,
                     optimizers: Sequence[torch.optim.Optimizer], X: torch.Tensor,
                     y: torch.Tensor, z: torch.Tensor, cfg: AdvConfig,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    """One iteration: the backward of ``combined + L_adv`` (of ``L_pred``
    without the adversary) at the current parameters, then each optimizer's
    step.  ``y`` and ``z`` are [N, 1].  Returns the combined loss (L_pred
    without the adversary) before the step, detached, left on the device."""
    combined, l_adv = _losses(pred, adv, X, y, z, cfg, generator)
    for opt in optimizers:
        opt.zero_grad(set_to_none=True)
    (combined if l_adv is None else combined + l_adv).backward()
    for opt in optimizers:
        opt.step()
    return combined.detach()


def train_adversarial(
    X: np.ndarray, y: np.ndarray, z: np.ndarray,
    Xval: np.ndarray, yval: np.ndarray, zval: np.ndarray,
    cfg: AdvConfig,
    verbose: bool = True,
    log_every: int = 100,
    device=None,
) -> Dict:
    """Full-batch adversarial training of one grid point on ``device``
    (``None`` means CUDA and raises without it).

    Returns the trained ``predictor`` and ``adversary``, the train and
    validation loss curves (every ``log_every``-th iteration) and the
    validation probabilities ``yhat_valid`` [Nv, 1]."""
    dev = resolve_device(device)

    def col(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev).reshape(-1, 1)

    X_d = torch.as_tensor(np.asarray(X, np.float32), device=dev)
    y_d, z_d = col(y), col(z)
    Xv = torch.as_tensor(np.asarray(Xval, np.float32), device=dev)
    yv, zv = col(yval), col(np.asarray(zval) > 0)
    pred, adv = (m.to(dev) for m in init_adv_models(X_d.shape[1], cfg))
    optimizers = [torch.optim.Adam(pred.parameters(), lr=cfg.learning_rate)]
    if cfg.adversarial:
        optimizers.append(torch.optim.Adam(adv.parameters(), lr=cfg.learning_rate))
    generator = make_generator(cfg.seed + 1)

    train_curve, valid_curve = [], []
    for t in range(cfg.num_iters):
        combined = adversarial_step(pred, adv, optimizers, X_d, y_d, z_d, cfg, generator)
        if t % log_every == 0:
            with torch.no_grad():
                vl = float(_losses(pred, adv, Xv, yv, zv, cfg)[0])
            train_curve.append(float(combined))
            valid_curve.append(vl)
            if verbose:
                print(f"Iteration: {t}, Train Loss: {float(combined):.4f}, "
                      f"Valid Loss: {vl:.4f}")

    with torch.no_grad():
        yhat_val = torch.sigmoid(pred(Xv)).cpu().numpy()
    return {"predictor": pred, "adversary": adv, "train_curve": train_curve,
            "valid_curve": valid_curve, "yhat_valid": yhat_val}


def adv_metrics(yhat: np.ndarray, y: np.ndarray, z: np.ndarray,
                threshold: float = 0.5, prevalence: float = 0.05) -> Dict[str, float]:
    """Reference get_metrics block (04:791-815): accuracy, recall, precision,
    specificity, PPV / NPV at an assumed prevalence, F1, AUROC (NaN where
    scikit-learn's raises: one class in ``y``, a non-finite score) and the
    recall gap between z = 0 and z > 0."""
    yhat = np.asarray(yhat).reshape(-1)
    y = np.asarray(y).reshape(-1)
    # Binarize the sensitive attribute like the reference eval (04:783):
    # group 0 vs everyone else.
    z = (np.asarray(z).reshape(-1) > 0).astype(np.float64)
    pred = (yhat > threshold).astype(int)
    tp = int(((pred == 1) & (y == 1)).sum())
    tn = int(((pred == 0) & (y == 0)).sum())
    fp = int(((pred == 1) & (y == 0)).sum())
    fn = int(((pred == 0) & (y == 1)).sum())
    sens = tp / (tp + fn) if tp + fn else 0.0
    spec = tn / (tn + fp) if tn + fp else 0.0
    ppv = (sens * prevalence) / max(
        sens * prevalence + (1 - spec) * (1 - prevalence), 1e-12)
    npv = (spec * (1 - prevalence)) / max(
        (1 - sens) * prevalence + spec * (1 - prevalence), 1e-12)
    prec = tp / (tp + fp) if tp + fp else 0.0
    f1 = 2 * prec * sens / max(prec + sens, 1e-12)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)      # one class: NaN
            auroc = float(roc_auc_score(y, yhat))
    except ValueError:
        auroc = float("nan")
    gaps = []
    for g in (0.0, 1.0):
        m = z == g
        if m.any() and (y[m] == 1).any():
            gp = ((pred[m] == 1) & (y[m] == 1)).sum() / max((y[m] == 1).sum(), 1)
            gaps.append(float(gp))
    recall_gap = abs(gaps[0] - gaps[1]) if len(gaps) == 2 else float("nan")
    return {"accuracy": (tp + tn) / max(len(y), 1), "recall": sens,
            "precision": prec, "specificity": spec, "PPV": ppv, "NPV": npv,
            "f1": f1, "auroc": auroc, "recall_gap_z": recall_gap}


def save_adv_artifacts(out_dir: str, results: List[Dict],
                       num_features: int) -> List[str]:
    """Write the stage-2 networks in the JAX package's npz layout.

    As the reference, every grid point overwrites ``model/model-basic_final``
    and ``adv/model-adv_final`` (04:758-761, so the files left are the last
    point's), and the ``model`` / ``adv`` / ``metrics`` directories are made
    (04:1089-1091); every point is also kept under its
    :func:`params_tostring` name.  The metadata carries the point's config
    and the feature width, so :func:`load_adv_artifact` (either package's)
    rebuilds the network.  No adversary is written without one."""
    for d in ("model", "adv", "metrics"):
        os.makedirs(os.path.join(out_dir, d), exist_ok=True)
    written: List[str] = []
    for r in results:
        tag = params_tostring(AdvConfig(**{
            k: r["config"][k] for k in _HYPERPARAMETER_LIST}))
        meta = {"config": r["config"], "num_features": int(num_features)}
        for kind, module, sub, stem in (
                ("predictor", r["predictor"], "model", "model-basic"),
                ("adversary", r["adversary"], "adv", "model-adv")):
            if kind == "adversary" and not r["config"].get("adversarial", True):
                continue
            params = flax_params(module)
            for name in (f"{stem}_{tag}.npz", f"{stem}_final.npz"):
                path = os.path.join(out_dir, sub, name)
                save_params_npz(path, params, metadata=dict(meta, kind=kind))
                written.append(path)
    return written


def load_adv_artifact(path: str, device=None) -> Tuple[nn.Module, AdvConfig]:
    """A stage-2 file of either package -> ``(module, config)``, the module
    rebuilt from the metadata with the file's parameters, on ``device``
    (``None`` means CUDA)."""
    meta = load_metadata_npz(path)
    if not meta or "kind" not in meta:
        raise ValueError(f"{path} is not a stage-2 adversarial artifact")
    cfg = AdvConfig(**meta["config"])
    if meta["kind"] == "predictor":
        module = AdvPredictor(int(meta["num_features"]), cfg.num_nodes, cfg.dropout_rate)
    else:
        module = AdvAdversary(cfg.num_nodes_adv, cfg.dropout_rate)
    return load_flax_params(module, load_params_npz(path)).to(resolve_device(device)), cfg


def adv_grid_search(
    X, y, z, Xval, yval, zval,
    grid: Optional[Dict[str, List]] = None,
    adversarial: bool = True,
    match_number: int = 20,
    use_data_as_is: bool = False,
    verbose: bool = True,
    device=None,
) -> List[Dict]:
    """Reference two-stage protocol (04:569-585, 664-702): case/control
    matching and SMOTEENN once, then ``itertools.product`` over the grid in
    its key order (default ``REFERENCE_GRID``).  One result per point:
    config, metrics, curves and the two trained networks."""
    grid = grid or REFERENCE_GRID
    y = np.asarray(y, np.float32)
    z = (np.asarray(z) > 0).astype(np.float32)
    if not use_data_as_is:
        keep = match_case_control(y, match_number)
        X, y, z = X[keep], y[keep], z[keep]
    X, y, z = resample_smoteenn(X, y, z)

    results = []
    keys = list(grid)
    for values in itertools.product(*(grid[k] for k in keys)):
        cfg = AdvConfig(**dict(zip(keys, values)), adversarial=adversarial)
        out = train_adversarial(X, y, z, Xval, yval, zval, cfg, verbose=verbose, device=device)
        metrics = adv_metrics(out["yhat_valid"], yval, zval)
        results.append({"config": dataclasses.asdict(cfg), "metrics": metrics,
                        "train_curve": out["train_curve"],
                        "valid_curve": out["valid_curve"],
                        "predictor": out["predictor"], "adversary": out["adversary"]})
        if verbose:
            print("Training complete for hyperparameter setting:",
                  dict(zip(keys, values)))
    return results
