"""The command line (port of ``fairmultimodal_tpu/cli/main.py``).

Usage:

    python -m fairmultimodal_torch.cli fame --synthetic 2048 --synthetic_labs 549 --bf16
    python -m fairmultimodal_torch.cli predict --params outputs/best_model_<ts>.npz
    python -m fairmultimodal_torch.cli fame --synthetic 64 --tiny --device cpu

The parser is the JAX package's: the same pipelines, flags, choices and
defaults, so every JAX command line parses, plus ``--device {cuda,cpu}``
(default ``cuda``, the analogue of ``JAX_PLATFORMS``): without ``--device
cpu`` a machine with no card raises instead of running on the CPU.

``fame`` and ``fpm`` run the FAME experiment at the reference geometry
(``--tiny`` for the JAX package's tiny one, ``--bf16`` for bfloat16);
``predict`` scores the cohort with an exported ``best_model_*.npz`` of
either package.  The cohort comes from ``--synthetic N`` or from the two
CSV tables in ``--data_dir``, read without pandas.  The other pipelines and
``--mesh`` exit naming the ROADMAP item that ports them.

Where the port departs from the JAX command line:

- ``--runs N`` with ``--checkpoint_dir`` gives each run
  ``<checkpoint_dir>/seed_<seed>``.  The JAX ``_run_multi`` hands every run
  the same directory, so run 2 resumes from run 1's last epoch, trains for
  no epochs, and reports run 1's model on its own split.  With ``--runs 1``
  the directory is used as given.
- ``--bf16`` is the compute dtype of every model the run builds.  The JAX
  command line builds the text encoder in float32 when
  ``--require_hf_weights`` is given (and in the run's dtype otherwise), and
  its ``predict`` scores in float32 whatever ``--bf16`` says; the flags'
  help promises neither.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time
from typing import Optional

from fairmultimodal_torch.ops.gates import resolve_device

__all__ = ["PIPELINES", "build_parser", "main", "run_pipeline"]

PIPELINES = ("data", "behrt", "bioclinicalbert", "dfc", "advdebias", "fpm",
             "fairehrclp", "average", "eddi", "sigmoid", "fame", "predict",
             "legacy-behrt", "legacy-eddi")

# Pipelines of the JAX command line that the port does not run yet.
_NOT_PORTED = {
    "data": "ROADMAP queue 1 item 4 (data/etl.py, native/)",
    **{name: "ROADMAP queue 1 item 5 (other pipelines)"
       for name in ("behrt", "bioclinicalbert", "dfc", "advdebias", "fairehrclp", "average",
                    "eddi", "sigmoid", "legacy-behrt", "legacy-eddi")},
}


def build_parser(default_pipeline: Optional[str] = None):
    import argparse

    p = argparse.ArgumentParser(
        prog="fairmultimodal-torch",
        description="FAME on PyTorch/CUDA: fairness-aware multimodal EHR models.")
    if default_pipeline is None:
        p.add_argument("pipeline", choices=PIPELINES)
    else:
        p.set_defaults(pipeline=default_pipeline)
    p.add_argument("--task", choices=["mortality", "los", "ventilation", "readmission", "all"],
                   default="all",
                   help="evaluation focus, or the label for --single_task; 'readmission' is "
                        "single-task-only")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--bsz", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lambda", dest="lambda_edd", type=float, default=None,
                   help="EDDI loss weight (FAME/FPM)")
    p.add_argument("--beta", type=float, default=None, help="dynamic-weight step size")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--runs", type=int, default=1, metavar="N",
                   help="repeat the experiment over N seeds (seed, seed+1, ...) and print "
                        "the Table-3-shaped mean±std AUROC/AUPRC/EDDI%%/EO%% block; per-run "
                        "values land in <out_dir>/runs_aggregate.csv")
    p.add_argument("--mimic_dir", default=".")
    p.add_argument("--use_native", choices=("auto", "on", "off"), default="auto",
                   help="data pipeline (not ported yet)")
    p.add_argument("--data_dir", default=".")
    p.add_argument("--out_dir", default="./outputs")
    p.add_argument("--head", type=int, default=None,
                   help="subsample the first N rows of each cohort table")
    p.add_argument("--synthetic", type=int, default=None, metavar="N",
                   help="use N synthetic patients instead of real CSVs")
    p.add_argument("--synthetic_labs", type=int, default=32,
                   help="lab feature columns in the synthetic cohort "
                        "(549 = reference geometry)")
    p.add_argument("--synthetic_chunks", type=int, default=3,
                   help="note-chunk columns in the synthetic cohort")
    p.add_argument("--mesh", default=None, metavar="DATA[xMODEL]",
                   help="multi-device training (not ported yet: ROADMAP queue 1 item 6)")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--tiny", action="store_true", help="tiny geometry for CPU smoke runs")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--reference_compat", action="store_true",
                   help="reproduce the reference's relative-index split "
                        "(10_FAME.py:744-755)")
    p.add_argument("--single_task", action="store_true",
                   help="train a single-label model on --task (not for fame/fpm)")
    p.add_argument("--timing", action="store_true",
                   help="print a per-phase wall-clock block at the end (fame/fpm)")
    p.add_argument("--tensorboard", action="store_true",
                   help="write TensorBoard event files under "
                        "<out_dir>/tensorboard/<pipeline>_<ts>/")
    p.add_argument("--checkpoint_dir", default=None,
                   help="FAME/FPM: save the train state per epoch (step_<k>.pt) and resume "
                        "from the latest one when the directory holds any (bit-identical "
                        "resume); with --runs N each run uses <dir>/seed_<seed>")
    p.add_argument("--text_cache", default=None, metavar="DIR",
                   help="persistent text-embedding cache, content-addressed by encoder "
                        "weights + note text + settings (sets FMTPU_TEXT_CACHE)")
    p.add_argument("--require_hf_weights", action="store_true",
                   help="fail instead of random-init fallback when the pretrained "
                        "Bio_ClinicalBERT snapshot cannot be loaded (recommended for any "
                        "real-data run)")
    p.add_argument("--params", default=None, help="exported best_model_*.npz for `predict`")
    p.add_argument("--thresholds", default=None,
                   help="JSON file of calibrated per-task thresholds")
    p.add_argument("--predictions_csv", default="predictions.csv")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to run; without 'cpu' a machine with no card raises")
    return p


def _load_frames(args):
    """The two cohort tables: synthetic, or the CSVs in ``--data_dir``."""
    if args.synthetic:
        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
        from fairmultimodal_torch.data.synthetic import make_common_frames

        return make_common_frames(n_patients=args.synthetic, n_lab_features=args.synthetic_labs,
                                  n_note_chunks=args.synthetic_chunks, seed=args.seed)
    from fairmultimodal_torch.data.table import read_csv_table

    return tuple(read_csv_table(os.path.join(args.data_dir, f"final_{kind}_common.csv"))
                 for kind in ("structured", "unstructured"))


def _apply_overrides(train_cfg, args):
    if args.epochs is not None:
        train_cfg.num_epochs = args.epochs
    if args.bsz is not None:
        train_cfg.batch_size = args.bsz
    if args.lr is not None:
        train_cfg.lr = args.lr
    train_cfg.seed = args.seed
    return train_cfg


_TASK_KEY = {"mortality": "mortality", "los": "los",
             "ventilation": "mechanical_ventilation", "readmission": "readmission"}
_SINGLE_TASK_PIPELINES = ("behrt", "bioclinicalbert", "average", "sigmoid", "eddi")


def _finish_run(out, args) -> int:
    """Post-run hooks: the ``--runs`` collection, ``--tensorboard``, then the
    ``--task`` report focus."""
    if getattr(args, "_collect", None) is not None and isinstance(out, dict):
        args._collect.append(out)
    if args.tensorboard and isinstance(out, dict):
        from fairmultimodal_torch.utils.tblog import log_run

        log_run(out, os.path.join(args.out_dir, "tensorboard",
                                  f"{args.pipeline}_{time.strftime('%Y%m%d-%H%M%S')}"),
                verbose=not args.quiet)
    return _report_task_focus(out, args)


def _report_task_focus(out, args) -> int:
    """``--task``: re-print the selected task's metric block after the run."""
    if args.task != "all" and isinstance(out, dict) and "metrics" in out:
        key = _TASK_KEY[args.task]
        m = out["metrics"].get(key)
        if m and not args.quiet:
            print(f"\n=== Selected task: {key} ===")
            for k, v in m.items():
                print(f"  {k}: {v:.4f}" if isinstance(v, float) else f"  {k}: {v}")
    return 0


def _run_multi(args) -> int:
    """``--runs N``: the pipeline over seeds seed .. seed+N-1 (the seed feeds
    the init, the shuffles and the ``--synthetic`` cohort), then the
    Table-3 block and ``<out_dir>/runs_aggregate.csv``.  Each run resumes
    from, and saves into, ``<checkpoint_dir>/seed_<seed>``."""
    from fairmultimodal_torch.eval.aggregate import (aggregate_runs, extract_table3_row,
                                                     format_table3, write_runs_csv)

    if args.pipeline == "predict":
        raise SystemExit(f"--runs is for training pipelines, not {args.pipeline!r}")
    rows, seeds = [], []
    for r in range(args.runs):
        run_args = copy.copy(args)
        run_args.runs = 1
        run_args.seed = args.seed + r
        if args.checkpoint_dir:
            run_args.checkpoint_dir = os.path.join(args.checkpoint_dir, f"seed_{run_args.seed}")
        run_args._collect = collected = []
        if not args.quiet:
            print(f"\n===== Run {r + 1}/{args.runs} (seed {run_args.seed}) =====")
        rc = run_pipeline(run_args)
        if rc != 0:
            return rc
        if collected:
            rows.append(extract_table3_row(collected[-1]))
            seeds.append(run_args.seed)
    if not rows:
        raise SystemExit("--runs: no run produced a metrics dict")
    agg = aggregate_runs(rows)
    print(f"\n===== Aggregate over {len(rows)} runs (seeds {seeds[0]}..{seeds[-1]}) =====")
    print(format_table3(agg, len(rows)))
    os.makedirs(args.out_dir, exist_ok=True)
    csv_path = os.path.join(args.out_dir, "runs_aggregate.csv")
    write_runs_csv(csv_path, rows, seeds, agg)
    print(f"Per-run metrics written to {csv_path}")
    return 0


def run_pipeline(args) -> int:
    name = args.pipeline
    if name in _NOT_PORTED:
        raise SystemExit(f"{name!r} is not ported to fairmultimodal_torch yet: "
                         f"{_NOT_PORTED[name]}; run it with fairmultimodal_tpu.cli")
    if args.mesh:
        raise SystemExit("--mesh: multi-GPU training is not ported to fairmultimodal_torch "
                         "yet (ROADMAP queue 1 item 6)")
    if args.runs > 1:
        return _run_multi(args)
    verbose = not args.quiet
    if args.text_cache:
        # encode_note_chunks reads this default, so every text precompute sees it.
        os.environ["FMTPU_TEXT_CACHE"] = args.text_cache
    if args.single_task:
        raise SystemExit(f"--single_task is not supported by {name!r} "
                         f"(supported: {', '.join(_SINGLE_TASK_PIPELINES)})")
    if args.task == "readmission":
        raise SystemExit("--task readmission requires --single_task (the 3-headed models "
                         "have no readmission head)")
    device = resolve_device(args.device)

    s, u = _load_frames(args)
    os.makedirs(args.out_dir, exist_ok=True)
    dtype = "bfloat16" if args.bf16 else "float32"

    import torch

    from fairmultimodal_torch.models.text import TextEncoder

    # With --require_hf_weights the encoder is built here, so a missing
    # snapshot fails before any featurization.
    torch_dtype = torch.bfloat16 if args.bf16 else torch.float32
    text_encoder = (TextEncoder.from_pretrained(require_weights=True, dtype=torch_dtype,
                                                device=device)
                    if args.require_hf_weights else None)

    if name == "predict":
        from fairmultimodal_torch.pipelines.inference import run_fame_inference

        if not args.params:
            raise SystemExit("predict requires --params <best_model.npz>")
        thresholds = None
        if args.thresholds:
            with open(args.thresholds) as f:
                thresholds = json.load(f)
        model_kwargs = ({"hidden_size": 64, "demo_layers": 1, "demo_heads": 2,
                         "lab_layers": 1, "lab_heads": 2, "fusion_hidden": 32}
                        if args.tiny else None)
        run_fame_inference(s, u, args.params, thresholds=thresholds, model_kwargs=model_kwargs,
                           text_encoder=text_encoder,
                           out_csv=os.path.join(args.out_dir, args.predictions_csv),
                           verbose=verbose, device=device, dtype=torch_dtype)
        return 0

    # fame / fpm
    from fairmultimodal_torch.pipelines.fame import FAMEPipelineConfig, run_fame_experiment
    from fairmultimodal_torch.train.loop import TrainConfig

    tc = _apply_overrides(TrainConfig(), args)
    if args.lambda_edd is not None:
        tc.lambda_edd = args.lambda_edd
    elif name == "fpm":
        tc.lambda_edd = 1.0          # 05_FPM.py:920
    if args.beta is not None:
        tc.beta = args.beta
    cfg = FAMEPipelineConfig(train=tc, out_dir=args.out_dir, dtype=dtype,
                             head=args.head or (1000 if name == "fpm" else None),
                             reference_compat=args.reference_compat,
                             require_hf_weights=args.require_hf_weights, timing=args.timing,
                             checkpoint_dir=args.checkpoint_dir)
    if args.tiny:
        cfg.hidden_size, cfg.demo_layers, cfg.demo_heads = 64, 1, 2
        cfg.lab_layers, cfg.lab_heads, cfg.fusion_hidden = 1, 2, 32
        cfg.text_max_length = 64
    out = run_fame_experiment(s, u, cfg, text_encoder=text_encoder, verbose=verbose,
                              device=device)
    return _finish_run(out, args)


def main(argv=None, default_pipeline: Optional[str] = None) -> int:
    return run_pipeline(build_parser(default_pipeline).parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
