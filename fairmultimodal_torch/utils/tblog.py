"""TensorBoard event files for ``--tensorboard`` (port of
``fairmultimodal_tpu/utils/tblog.py``).

:func:`log_run` writes a finished pipeline's result dict through
``torch.utils.tensorboard.SummaryWriter``: the per-epoch curves
(``train/<key>`` from the fit history), the FAME dynamic-weight
trajectories (``dynamic_weights/<task>/<modality>``) and the final test,
fairness and EDDI blocks as single-step scalars.  Where the ``tensorboard``
package is missing, the logger says so once and does nothing: the flag
concerns a log file, never the run.
"""

from __future__ import annotations

import numbers
import os
from typing import Any, Dict, Optional, Sequence

__all__ = ["TensorBoardLogger", "log_run"]

_MODALITIES = ("demo", "lab", "text")


def _make_writer(log_dir: str, verbose: bool = True):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception as exc:  # pragma: no cover - environment-dependent
        if verbose:
            print(f"[tensorboard] torch.utils.tensorboard unavailable "
                  f"({exc}); --tensorboard is a no-op for this run.")
        return None
    os.makedirs(log_dir, exist_ok=True)
    return SummaryWriter(log_dir=log_dir)


def _scalars(prefix: str, obj: Any, sink, step: int) -> None:
    """Recursively emit every numeric leaf of ``obj`` under ``prefix``.

    Dict keys join with '/'; sequences of numbers index as '/<i>'; strings,
    arrays of non-scalars, and other non-numeric leaves are skipped.  Tag
    characters outside TensorBoard's safe set are replaced with '_' (metric
    names like ``recall (TPR)`` contain spaces/parens)."""
    if isinstance(obj, numbers.Real) and not isinstance(obj, bool):
        tag = "".join(c if (c.isalnum() or c in "_/.-") else "_"
                      for c in prefix)
        sink(tag, float(obj), step)
        return
    if isinstance(obj, dict):
        for k, v in obj.items():
            _scalars(f"{prefix}/{k}", v, sink, step)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _scalars(f"{prefix}/{i}", v, sink, step)
    # numpy scalars satisfy numbers.Real; arrays and strings fall through.


class TensorBoardLogger:
    """Thin wrapper over ``SummaryWriter`` with the run-shaped helpers."""

    def __init__(self, log_dir: str, verbose: bool = True):
        self.log_dir = log_dir
        self.writer = _make_writer(log_dir, verbose=verbose)
        if self.writer is not None and verbose:
            print(f"TensorBoard events -> {log_dir}")

    @property
    def enabled(self) -> bool:
        return self.writer is not None

    def scalar(self, tag: str, value: float, step: int = 0) -> None:
        if self.writer is not None:
            _scalars(tag, value, self.writer.add_scalar, step)

    def log_history(self, history: Sequence[Dict[str, Any]]) -> None:
        """Per-epoch fit curves.  Rows are the trainers' history dicts
        (``epoch``, ``train_loss``, ``val_loss``, ``lr``, optionally
        ``train_bce``); the epoch number is the global step."""
        if self.writer is None:
            return
        for row in history or ():
            step = int(row.get("epoch", 0))
            for key, value in row.items():
                if key != "epoch":
                    _scalars(f"train/{key}", value, self.writer.add_scalar,
                             step)

    def log_dynamic_weights(self,
                            tracked: Dict[str, Sequence[Sequence[float]]]
                            ) -> None:
        """FAME's per-epoch modality weights
        (``FAMETrainer.tracked_dynamic_weights``: task -> [[demo, lab,
        text], ...], one row per completed epoch)."""
        if self.writer is None:
            return
        for task, rows in (tracked or {}).items():
            for epoch, row in enumerate(rows, start=1):
                for name, w in zip(_MODALITIES, row):
                    _scalars(f"dynamic_weights/{task}/{name}", float(w),
                             self.writer.add_scalar, epoch)

    def log_final(self, out: Dict[str, Any]) -> None:
        """Final test blocks from a pipeline output dict (single step 0)."""
        if self.writer is None:
            return
        add = self.writer.add_scalar
        _scalars("test", out.get("metrics") or {}, add, 0)
        _scalars("fairness", out.get("fairness") or {}, add, 0)
        eddi = out.get("eddi") or {}
        for task, block in eddi.items():
            if isinstance(block, dict):
                _scalars(f"eddi/{task}/combined",
                         block.get("combined_eddi"), add, 0)
                _scalars(f"eddi/{task}", block.get("attribute_eddi") or {},
                         add, 0)
                _scalars(f"eddi/{task}/subgroups",
                         block.get("subgroups") or {}, add, 0)
            else:
                _scalars(f"eddi/{task}", block, add, 0)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.flush()
            self.writer.close()


def log_run(out: Dict[str, Any], log_dir: str, verbose: bool = True
            ) -> Optional[str]:
    """One-shot: write a finished pipeline's curves + final blocks.

    Returns the event directory, or None when tensorboard is unavailable
    (or ``out`` is not a pipeline output dict, e.g. the data/predict
    pipelines which have no training history)."""
    if not isinstance(out, dict):
        return None
    logger = TensorBoardLogger(log_dir, verbose=verbose)
    if not logger.enabled:
        return None
    try:
        logger.log_history(out.get("history") or ())
        trainer = out.get("trainer")
        tracked = getattr(trainer, "tracked_dynamic_weights", None)
        if tracked:
            logger.log_dynamic_weights(tracked)
        logger.log_final(out)
    finally:
        logger.close()
    return log_dir
