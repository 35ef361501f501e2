"""Batch inference / serving (port of ``fairmultimodal_tpu/pipelines/inference.py``).

:class:`FAMEPredictor` runs a FAME model in fixed batches (256 by default),
zero-padding the tail batch so every call sees one shape.
:func:`run_fame_inference` goes from the two cohort tables (port tables or
DataFrames) and an exported ``best_model_*.npz`` (the JAX package's
``save_params_npz`` format, read as it is) to a per-patient risk table,
written as the JAX function's CSV without pandas.
"""

from __future__ import annotations

import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from fairmultimodal_torch import TASKS
from fairmultimodal_torch.data.featurize import as_table, assemble_features
from fairmultimodal_torch.data.table import frame_from_table, num_rows, write_csv_table
from fairmultimodal_torch.interop import load_flax_params
from fairmultimodal_torch.models.fusion import FAMEModel
from fairmultimodal_torch.models.text import TextEncoder, encode_note_chunks
from fairmultimodal_torch.ops.gates import resolve_device
from fairmultimodal_torch.pipelines.common import build_arrays
from fairmultimodal_torch.pipelines.fame import FAME_KEYS
from fairmultimodal_torch.utils.checkpoint import load_metadata_npz, load_params_npz

__all__ = ["FAMEPredictor", "run_fame_inference"]


class FAMEPredictor:
    """Fixed-shape batch predictor over a FAME model (moved to ``device``,
    eval mode, frozen)."""

    def __init__(self, model: FAMEModel, thresholds: Optional[Dict] = None,
                 batch_size: int = 256, dynamic_weights: Optional[np.ndarray] = None,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.batch_size = batch_size
        self.thresholds = thresholds or {t: 0.5 for t in TASKS}
        dw = (np.full((3, 3), 0.33, np.float32) if dynamic_weights is None
              else np.asarray(dynamic_weights, np.float32))
        self._dw = torch.as_tensor(dw, device=self.device)

    @torch.inference_mode()
    def _probs(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.sigmoid(self.model(batch, dynamic_weights=self._dw)["fused_logits"])

    def predict_arrays(self, arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Model-input arrays [N, ...] -> {"probs": [N, 3], "preds": [N, 3]}.

        Every batch is enqueued before the results are copied back, so the
        device never waits on the host between batches."""
        n = len(next(iter(arrays.values())))
        bs = self.batch_size
        outs = []
        for start in range(0, n, bs):
            stop = min(start + bs, n)
            chunk = {k: v[start:stop] for k, v in arrays.items()}
            if stop - start < bs:   # pad the tail to the fixed shape
                pad = bs - (stop - start)
                chunk = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                         for k, v in chunk.items()}
            batch = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                     for k, v in chunk.items()}
            outs.append((start, stop, self._probs(batch)))
        probs = np.zeros((n, 3), np.float32)
        for start, stop, p in outs:
            probs[start:stop] = p[: stop - start].float().cpu().numpy()
        thr = np.asarray([self.thresholds[t] for t in TASKS], np.float32)
        return {"probs": probs, "preds": (probs > thr).astype(np.int32)}

    def benchmark(self, iters: int = 20, warmup: int = 3, seed: int = 0) -> Dict[str, object]:
        """Serving throughput at the fixed batch shape on synthetic inputs.

        ``iters`` back-to-back batches after ``warmup``; on CUDA timed with
        events around the run (device time, launch gaps included), on the
        CPU with the host clock.  Returns batch latency (ms), patients/s
        and the device it ran on.
        """
        rng = np.random.default_rng(seed)
        bs, m = self.batch_size, self.model
        arrays = {
            "demo_dummy_ids": np.zeros((bs, 1), np.int32),
            "demo_attn_mask": np.ones((bs, 1), np.int32),
            "age_ids": rng.integers(0, m.num_ages, bs).astype(np.int32),
            "gender_ids": rng.integers(0, m.num_genders, bs).astype(np.int32),
            "ethnicity_ids": rng.integers(0, m.num_ethnicities, bs).astype(np.int32),
            "insurance_ids": rng.integers(0, m.num_insurances, bs).astype(np.int32),
            "lab_features": rng.normal(0, 1, (bs, m.lab_token_count)).astype(np.float32),
            "text_embedding": rng.normal(0, 1, (bs, m.text_embed_size)).astype(np.float32),
        }
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in arrays.items()}
        for _ in range(warmup):
            self._probs(batch)
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                self._probs(batch)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / iters
            name = torch.cuda.get_device_name(self.device)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                self._probs(batch)
            ms = 1e3 * (time.perf_counter() - t0) / iters
            name = "cpu"
        return {"batch_size": float(bs), "batch_latency_ms": ms,
                "patients_per_sec": 1e3 * bs / ms, "device": name}


def run_fame_inference(structured, unstructured, params_path: str,
                       thresholds: Optional[Dict] = None,
                       text_encoder: Optional[TextEncoder] = None,
                       text_max_length: int = 512, model_kwargs: Optional[Dict] = None,
                       out_csv: Optional[str] = None, verbose: bool = True, device=None,
                       dtype=torch.float32):
    """Cohort tables + exported params -> per-patient risk table
    (``subject_id`` and ``<task>_prob`` / ``<task>_pred`` per task): a port
    table, or a DataFrame when ``structured`` is one.  ``dtype`` is the
    compute dtype of the model and of the text encoder built here (the
    parameters stay float32)."""
    device = resolve_device(device)
    frames = not isinstance(structured, Mapping)
    bundle = assemble_features(as_table(structured), as_table(unstructured))
    if text_encoder is None:
        text_encoder = TextEncoder.from_pretrained(dtype=dtype, device=device)
    bundle.text_embeddings = encode_note_chunks(text_encoder, bundle.note_chunks,
                                                max_length=text_max_length)
    arrays = build_arrays(bundle, FAME_KEYS)

    meta = load_metadata_npz(params_path) or {}
    n_ages, n_gen, n_eth, n_ins = bundle.vocab_sizes()
    kwargs = dict(num_ages=n_ages, num_genders=n_gen, num_ethnicities=n_eth,
                  num_insurances=n_ins, lab_token_count=bundle.num_lab_features,
                  text_embed_size=bundle.text_embeddings.shape[1])
    # Self-describing checkpoints: the stored geometry wins, explicit
    # model_kwargs override both.
    kwargs.update(meta.get("model", {}))
    kwargs.update(model_kwargs or {})
    if thresholds is None and "thresholds" in meta:
        thresholds = meta["thresholds"]
    model = load_flax_params(FAMEModel(**kwargs, dtype=dtype), load_params_npz(params_path))

    dw = (np.asarray(meta["dynamic_weights"], np.float32)
          if "dynamic_weights" in meta else None)
    out = FAMEPredictor(model, thresholds, dynamic_weights=dw,
                        device=device).predict_arrays(arrays)
    table = {"subject_id": bundle.subject_id}
    for i, t in enumerate(TASKS):
        table[f"{t}_prob"] = out["probs"][:, i]
        table[f"{t}_pred"] = out["preds"][:, i]
    if out_csv:
        write_csv_table(out_csv, table)
        if verbose:
            print(f"Wrote predictions for {num_rows(table)} patients to {out_csv}")
    return frame_from_table(table) if frames else table
