"""Evaluation plots (port of ``fairmultimodal_tpu/eval/plots.py``; the
legacy notebook's jitter plots and subgroup disparity charts, Code/BEHRT.ipynb).

Each function writes a PNG through matplotlib's Agg backend and returns its
path, or returns ``None`` when matplotlib is not installed (the card's
machine has none).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["jitter_plot", "disparity_bars", "training_curves"]


def _plt():
    """``matplotlib.pyplot`` on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def jitter_plot(probs: np.ndarray, labels: np.ndarray, sensitive: np.ndarray,
                path: str, title: str = "Predicted risk by subgroup",
                seed: int = 0) -> Optional[str]:
    """Per-subgroup jittered scatter of predicted probabilities, colored by
    outcome (the legacy notebook's per-group risk spread view)."""
    plt = _plt()
    if plt is None:
        return None
    rng = np.random.default_rng(seed)
    groups = np.unique(sensitive)
    fig, ax = plt.subplots(figsize=(1.6 * max(len(groups), 3) + 2, 4))
    for i, g in enumerate(groups):
        m = sensitive == g
        xs = i + rng.uniform(-0.25, 0.25, int(m.sum()))
        colors = np.where(labels[m] > 0.5, "tab:red", "tab:blue")
        ax.scatter(xs, probs[m], s=6, c=colors, alpha=0.5, linewidths=0)
    ax.set_xticks(range(len(groups)))
    ax.set_xticklabels([str(g) for g in groups])
    ax.set_ylabel("predicted probability")
    ax.set_xlabel("subgroup")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def disparity_bars(subgroup_disparities: Dict, path: str,
                   title: str = "EDDI subgroup disparities") -> Optional[str]:
    """Bar chart of per-subgroup EDDI disparity values (the dict returned by
    ``fairness.eddi.compute_eddi``)."""
    plt = _plt()
    if plt is None:
        return None
    keys = [str(k) for k in subgroup_disparities]
    vals = [float(v) for v in subgroup_disparities.values()]
    fig, ax = plt.subplots(figsize=(1.2 * max(len(keys), 3) + 2, 3.5))
    ax.bar(keys, vals, color=["tab:red" if v > 0 else "tab:blue" for v in vals])
    ax.axhline(0.0, color="black", linewidth=0.8)
    ax.set_ylabel("(subgroup err - overall err) / norm")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def training_curves(history: Sequence[Dict], path: str) -> Optional[str]:
    """Train/val loss curves from a trainer history list."""
    plt = _plt()
    if plt is None:
        return None
    epochs = [h["epoch"] for h in history]
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.plot(epochs, [h["train_loss"] for h in history], color="blue",
            label="Train Loss")
    ax.plot(epochs, [h["val_loss"] for h in history], color="red",
            label="Valid Loss")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
