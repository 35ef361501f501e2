"""The command line (port of ``fairmultimodal_tpu/cli/main.py``).

Usage:

    python -m fairmultimodal_torch.cli fame --synthetic 2048 --synthetic_labs 549 --bf16
    python -m fairmultimodal_torch.cli predict --params outputs/best_model_<ts>.npz
    python -m fairmultimodal_torch.cli fame --synthetic 64 --tiny --device cpu
    python -m fairmultimodal_torch.cli behrt --synthetic 64 --tiny --device cpu
    python -m fairmultimodal_torch.cli legacy-behrt --synthetic 64 --tiny --device cpu
    python -m fairmultimodal_torch.cli data --mimic_dir /path/to/mimic-iii --out_dir . --timing

The parser is the JAX package's: the same pipelines, flags, choices and
defaults, so every JAX command line parses, plus ``--device {cuda,cpu}``
(default ``cuda``, the analogue of ``JAX_PLATFORMS``): without ``--device
cpu`` a machine with no card raises instead of running on the CPU.

``fame`` and ``fpm`` run the FAME experiment at the reference geometry
(``--tiny`` for the JAX package's tiny one, ``--bf16`` for bfloat16);
``behrt``, ``bioclinicalbert``, ``dfc``, ``fairehrclp``, ``average``,
``sigmoid`` and ``eddi`` run the baselines 01, 02, 03, 06 (its reference
behaviour), 07, 09 and 08 at their configs' defaults (``--tiny`` shrinks
them as the JAX ``tinyize`` does; ``--single_task --task T`` trains one
label in 01, 02, 07, 09 and 08); ``advdebias`` runs 04's two stages (the
reference's 64-point stage-2 grid; ``--tiny`` also takes the JAX command
line's one-point grid) with its artifacts under ``--out_dir``;
``legacy-behrt`` and ``legacy-eddi`` run the legacy-generation experiments
(``--reference_compat`` trains and evaluates on the whole cohort);
``predict`` scores the cohort with an exported ``best_model_*.npz`` of
either package.  The cohort comes from ``--synthetic N``
(``make_admission_frame`` for ``legacy-behrt``) or from the CSV tables in
``--data_dir``, read without pandas.  ``data`` runs the MIMIC-III ETL
(:func:`fairmultimodal_torch.data.etl.run_etl`, no pandas) from the raw
``csv.gz`` tables in ``--mimic_dir`` (``--synthetic N``: ``write_raw_mimic``
tables in a fresh temporary directory) into the five CSVs in ``--out_dir``,
with ``--use_native`` and ``--timing``.

``--mesh N`` (or ``Nx1``) trains ``fame`` / ``fpm`` data-parallel over N
ranks (:mod:`fairmultimodal_torch.parallel`), and ``--mesh NxM`` over N data
x M tensor-parallel ranks: NCCL over N·M cards, or gloo ranks on the CPU
with ``--device cpu``.  Started as one command it spawns its N·M rank
processes; under ``torchrun --nproc-per-node N·M`` each process joins the
job it finds.  ``--mesh`` on another pipeline exits as the JAX command line
does.

Where the port departs from the JAX command line:

- ``--runs N`` with ``--checkpoint_dir`` gives each run
  ``<checkpoint_dir>/seed_<seed>``.  The JAX ``_run_multi`` hands every run
  the same directory, so run 2 resumes from run 1's last epoch, trains for
  no epochs, and reports run 1's model on its own split.  With ``--runs 1``
  the directory is used as given.
- ``--mesh NxM`` with M > 1 shards the FAME model over the M ranks of each
  model group (``parallel.shard_params_tp``), as the JAX help promises
  ("4-way data x 2-way tensor parallelism").  The JAX command line never
  shards: its model axis holds replicas that repeat each other's work.  The
  numbers are the same.
- ``--bf16`` is the compute dtype of every model the run builds.  The JAX
  command line builds the text encoder in float32 when
  ``--require_hf_weights`` is given (and, for the baselines, always: its
  ``prepare_experiment`` builds it in float32), its ``predict`` scores in
  float32 whatever ``--bf16`` says, and its ``bioclinicalbert`` ignores
  ``--bf16``; the flags' help promises none of these.
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

# The numbered reference scripts' pipelines (``main(default_pipeline="01")``).
_SCRIPT_TO_PIPELINE = {
    "00": "data", "01": "behrt", "02": "bioclinicalbert", "03": "dfc", "04": "advdebias",
    "05": "fpm", "06": "fairehrclp", "07": "average", "08": "eddi", "09": "sigmoid",
    "10": "fame",
}

def build_parser(default_pipeline: Optional[str] = None):
    import argparse

    p = argparse.ArgumentParser(
        prog="fairmultimodal-torch",
        description="FAME on PyTorch/CUDA: fairness-aware multimodal EHR models.")
    if default_pipeline is None:
        p.add_argument("pipeline", choices=PIPELINES)
    else:
        p.set_defaults(pipeline=_SCRIPT_TO_PIPELINE.get(default_pipeline, default_pipeline))
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
                   help="data pipeline: C++ streaming aggregator/chunker for the big event "
                        "tables (auto = use when it builds; on = require; off = the plain "
                        "path). --timing prints the chosen path + rows/sec per table")
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
                   help="training over DATA x MODEL ranks (fame/fpm): '8' = 8-way data "
                        "parallelism, '4x2' = 4-way data x 2-way tensor parallelism; one "
                        "process per rank, NCCL over one card each, or gloo ranks with "
                        "--device cpu; spawned here, or joined under torchrun")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--tiny", action="store_true", help="tiny geometry for CPU smoke runs")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--reference_compat", action="store_true",
                   help="reproduce the reference's relative-index split "
                        "(10_FAME.py:744-755)")
    p.add_argument("--single_task", action="store_true",
                   help="train a single-label model on --task (not for fame/fpm)")
    p.add_argument("--timing", action="store_true",
                   help="print a per-phase wall-clock block at the end (fame/fpm; data: "
                        "per-table path and rows/s)")
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


_TINY = dict(hidden_size=64, text_batch_size=16)


def tinyize(cfg, args):
    """``--tiny``: the JAX command line's tiny geometry for a baseline config."""
    if not args.tiny:
        return cfg
    for k, v in _TINY.items():
        if hasattr(cfg, k):
            setattr(cfg, k, v)
    for attr in ("num_hidden_layers", "demo_layers", "lab_layers"):
        if hasattr(cfg, attr):
            setattr(cfg, attr, 1)
    for attr in ("num_attention_heads", "demo_heads", "lab_heads"):
        if hasattr(cfg, attr):
            setattr(cfg, attr, 2)
    if hasattr(cfg, "text_max_length"):
        cfg.text_max_length = min(cfg.text_max_length, 64)
    return cfg


def _apply_single_task(cfg, args):
    """``--single_task``: train a one-label model on ``--task``."""
    if args.single_task:
        if args.task == "all":
            raise SystemExit("--single_task requires --task "
                             "mortality|los|ventilation|readmission")
        if args.task == "readmission" and args.pipeline != "bioclinicalbert":
            raise SystemExit("--task readmission is the Uni_label_run text-only regime; use "
                             "the bioclinicalbert pipeline")
        cfg.task = _TASK_KEY[args.task]
    return cfg


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
    """``--task``: re-print the selected task's metric block after the run
    (a ``--single_task`` run's metrics are that task's already)."""
    if args.single_task:
        return 0
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

    if args.pipeline in ("data", "predict"):
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
    if not _rank0(args):
        return 0
    agg = aggregate_runs(rows)
    print(f"\n===== Aggregate over {len(rows)} runs (seeds {seeds[0]}..{seeds[-1]}) =====")
    print(format_table3(agg, len(rows)))
    os.makedirs(args.out_dir, exist_ok=True)
    csv_path = os.path.join(args.out_dir, "runs_aggregate.csv")
    write_runs_csv(csv_path, rows, seeds, agg)
    print(f"Per-run metrics written to {csv_path}")
    return 0


def _rank0(args) -> bool:
    mesh = getattr(args, "_mesh", None)
    return mesh is None or mesh.rank == 0


def _run_meshed(args) -> int:
    """``--mesh``: in a rank of a job (``torchrun``, or a process this
    function spawned) join it; else run a one-rank mesh here, or spawn one
    process per rank, each of which runs the command."""
    from fairmultimodal_torch import parallel

    if args.pipeline not in ("fame", "fpm"):
        raise SystemExit("--mesh is supported for fame/fpm only")
    try:
        data, model = parallel.parse_mesh(args.mesh)
    except ValueError as e:
        raise SystemExit(f"--mesh: {e}") from None
    world = data * model
    devices = ["cpu"] * world if args.device == "cpu" else None
    if world > 1 and not parallel.launched():
        parallel.mesh_devices(devices, data, model)
        threads = max(1, (os.cpu_count() or 1) // world) if args.device == "cpu" else None
        return max(parallel.launch(run_pipeline, world, args=(args,), threads=threads))
    mesh = parallel.get_mesh(data, model, devices=devices)
    try:
        rank_args = copy.copy(args)
        rank_args._mesh = mesh
        if mesh.rank:
            rank_args.quiet, rank_args.tensorboard = True, False
        return run_pipeline(rank_args)
    finally:
        mesh.close()


def run_pipeline(args) -> int:
    name = args.pipeline
    if args.mesh and getattr(args, "_mesh", None) is None:
        return _run_meshed(args)
    if args.runs > 1:
        return _run_multi(args)
    verbose = not args.quiet
    if args.text_cache:
        # encode_note_chunks reads this default, so every text precompute sees it.
        os.environ["FMTPU_TEXT_CACHE"] = args.text_cache
    if args.single_task and name not in _SINGLE_TASK_PIPELINES:
        raise SystemExit(f"--single_task is not supported by {name!r} "
                         f"(supported: {', '.join(_SINGLE_TASK_PIPELINES)})")
    if args.task == "readmission" and not args.single_task:
        raise SystemExit("--task readmission requires --single_task (the 3-headed models "
                         "have no readmission head)")
    device = resolve_device(args.device)
    dtype = "bfloat16" if args.bf16 else "float32"
    if name == "data":
        return _data(args, device)
    if name == "legacy-behrt":
        return _finish_run(_legacy_behrt(args, dtype, verbose, device), args)

    s, u = _load_frames(args)
    os.makedirs(args.out_dir, exist_ok=True)

    import torch

    from fairmultimodal_torch.models.text import TextEncoder

    # With --require_hf_weights the encoder is built here, so a missing
    # snapshot fails before any featurization.
    torch_dtype = torch.bfloat16 if args.bf16 else torch.float32
    text_encoder = (TextEncoder.from_pretrained(require_weights=True, dtype=torch_dtype,
                                                device=device,
                                                mesh=getattr(args, "_mesh", None))
                    if args.require_hf_weights and name != "behrt" else None)

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

    if name in _BASELINES:
        return _finish_run(_BASELINES[name](s, u, args, dtype, text_encoder, verbose, device),
                           args)

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
                             checkpoint_dir=args.checkpoint_dir,
                             mesh=getattr(args, "_mesh", None))
    if args.tiny:
        cfg.hidden_size, cfg.demo_layers, cfg.demo_heads = 64, 1, 2
        cfg.lab_layers, cfg.lab_heads, cfg.fusion_hidden = 1, 2, 32
        cfg.text_max_length = 64
    out = run_fame_experiment(s, u, cfg, text_encoder=text_encoder, verbose=verbose,
                              device=device)
    return _finish_run(out, args)


def _data(args, device) -> int:
    """The MIMIC-III ETL into ``--out_dir``; ``--synthetic N`` writes
    ``write_raw_mimic`` tables into a new temporary directory first."""
    from fairmultimodal_torch.data.etl import run_etl

    if args.synthetic:
        import tempfile

        from fairmultimodal_torch.data.synthetic import write_raw_mimic

        args.mimic_dir = tempfile.mkdtemp(prefix="mimic_syn_")
        write_raw_mimic(args.mimic_dir, n_subjects=args.synthetic, seed=args.seed)
    use_native = {"auto": None, "on": True, "off": False}[args.use_native]
    run_etl(args.mimic_dir, args.out_dir, use_native=use_native, timing=args.timing,
            device=device)
    return 0


def _behrt(s, u, args, dtype, text_encoder, verbose, device):
    from fairmultimodal_torch.pipelines.behrt import BEHRTPipelineConfig, run_behrt_experiment

    cfg = BEHRTPipelineConfig(dtype=dtype)
    _apply_overrides(cfg.train, args)
    _apply_single_task(tinyize(cfg, args), args)
    return run_behrt_experiment(s, u, cfg, verbose=verbose, device=device)


def _bioclinicalbert(s, u, args, dtype, text_encoder, verbose, device):
    from fairmultimodal_torch.pipelines.text_only import (TextOnlyPipelineConfig,
                                                          run_text_only_experiment)

    # 02 subsamples to 1000 patients (02:405) under --reference_compat; an
    # explicit --head wins.
    cfg = TextOnlyPipelineConfig(head=args.head if args.head is not None
                                 else (1000 if args.reference_compat else None), dtype=dtype)
    _apply_overrides(cfg.train, args)
    _apply_single_task(tinyize(cfg, args), args)
    return run_text_only_experiment(s, u, cfg, text_encoder=text_encoder, verbose=verbose,
                                    device=device)


def _average(s, u, args, dtype, text_encoder, verbose, device):
    from fairmultimodal_torch.pipelines.average_fusion import (AverageFusionPipelineConfig,
                                                               run_average_fusion_experiment)

    cfg = AverageFusionPipelineConfig(dtype=dtype, out_dir=args.out_dir)
    _apply_overrides(cfg.train, args)
    _apply_single_task(tinyize(cfg, args), args)
    return run_average_fusion_experiment(s, u, cfg, text_encoder=text_encoder,
                                         verbose=verbose, device=device)


def _sigmoid(s, u, args, dtype, text_encoder, verbose, device):
    from fairmultimodal_torch.pipelines.sigmoid_fusion import (SigmoidFusionPipelineConfig,
                                                               run_sigmoid_fusion_experiment)

    cfg = SigmoidFusionPipelineConfig(dtype=dtype, reference_compat=args.reference_compat)
    _apply_overrides(cfg.train, args)
    _apply_single_task(tinyize(cfg, args), args)
    return run_sigmoid_fusion_experiment(s, u, cfg, text_encoder=text_encoder,
                                         verbose=verbose, device=device)


def _eddi(s, u, args, dtype, text_encoder, verbose, device):
    from fairmultimodal_torch.pipelines.eddi_fusion import (EDDIFusionPipelineConfig,
                                                            run_eddi_fusion_experiment)

    cfg = EDDIFusionPipelineConfig(dtype=dtype)
    _apply_overrides(cfg.train, args)
    if args.beta is not None:
        cfg.beta = args.beta
    tinyize(cfg, args)
    if args.tiny:
        cfg.demo_layers, cfg.demo_heads = 1, 2
    _apply_single_task(cfg, args)
    return run_eddi_fusion_experiment(s, u, cfg, text_encoder=text_encoder, verbose=verbose,
                                      device=device)


#: The branches that only build a pipeline's config and run it on the two
#: tables: name -> (module under ``pipelines``, config class, runner).  A
#: config with a ``reference_compat`` field takes --reference_compat.
_TABLE_RUNS = {"dfc": ("dfc", "DfCPipelineConfig", "run_dfc_experiment"),
               "fairehrclp": ("fairehr_clp", "FairEHRCLPPipelineConfig",
                              "run_fairehr_clp_experiment"),
               "legacy-eddi": ("legacy", "LegacyEDDIPipelineConfig",
                               "run_legacy_eddi_experiment")}


def _advdebias(s, u, args, dtype, text_encoder, verbose, device):
    from fairmultimodal_torch.pipelines.adv_debias import (AdvDebiasPipelineConfig,
                                                           run_adv_debias_experiment)

    cfg = AdvDebiasPipelineConfig(dtype=dtype, out_dir=args.out_dir)
    _apply_overrides(cfg.train, args)
    tinyize(cfg, args)
    if args.tiny:
        cfg.stage2_grid = {"learning_rate": [1e-3], "num_iters": [100], "num_nodes": [16],
                           "num_nodes_adv": [8], "dropout_rate": [0.1], "alpha": [1.0]}
    return run_adv_debias_experiment(s, u, cfg, text_encoder=text_encoder, verbose=verbose,
                                     device=device)


def _table_run(s, u, args, dtype, text_encoder, verbose, device):
    import importlib

    module, config, runner = _TABLE_RUNS[args.pipeline]
    mod = importlib.import_module(f"fairmultimodal_torch.pipelines.{module}")
    cfg = getattr(mod, config)(dtype=dtype)
    if hasattr(cfg, "reference_compat"):
        cfg.reference_compat = args.reference_compat
    _apply_overrides(cfg.train, args)
    tinyize(cfg, args)
    return getattr(mod, runner)(s, u, cfg, text_encoder=text_encoder, verbose=verbose,
                                device=device)


def _legacy_behrt(args, dtype, verbose, device):
    """The sequence BEHRT on its own multi-admission table:
    ``make_admission_frame`` for ``--synthetic N``, else
    ``final_structured_common.csv``."""
    from fairmultimodal_torch.pipelines.legacy import (LegacyBEHRTPipelineConfig,
                                                       run_legacy_behrt_experiment)

    if args.synthetic:
        from fairmultimodal_torch.data.synthetic import make_admission_frame

        frame = make_admission_frame(n_subjects=args.synthetic, seed=args.seed)
    else:
        from fairmultimodal_torch.data.table import read_csv_table

        frame = read_csv_table(os.path.join(args.data_dir, "final_structured_common.csv"))
    cfg = LegacyBEHRTPipelineConfig(dtype=dtype, reference_compat=args.reference_compat)
    _apply_overrides(cfg.train, args)
    if args.tiny:
        cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads = 64, 1, 2
    return run_legacy_behrt_experiment(frame, cfg, verbose=verbose, device=device)


_BASELINES = {"behrt": _behrt, "bioclinicalbert": _bioclinicalbert, "average": _average,
              "sigmoid": _sigmoid, "eddi": _eddi, "advdebias": _advdebias,
              **dict.fromkeys(_TABLE_RUNS, _table_run)}


def main(argv=None, default_pipeline: Optional[str] = None) -> int:
    return run_pipeline(build_parser(default_pipeline).parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
