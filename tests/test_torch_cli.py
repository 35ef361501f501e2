"""The port's command line against the JAX package's (CPU, fp32, tiny).

``python -m fairmultimodal_torch.cli`` has the JAX parser's flags plus
``--device``; ``fame --synthetic 64 --tiny --epochs 2 --bsz 16 --device
cpu`` prints the JAX command line's report with metrics within 1e-4 of the
JAX run on the same arguments; ``predict`` reads a JAX-written and a
port-written npz and writes the JAX CSV to 1e-5 (``--runs 2`` is held
against the JAX command line in ``test_torch_resume.py``).  Both command
lines get one tiny text encoder (the JAX one's weights, converted),
a train forward without dropout and the JAX trainer's initial weights (the
port's ``init_params`` is replaced by a load of them), through wrappers
around the functions the command lines call.  ``--bf16`` is the
compute dtype of every model the run builds.  ``--mesh 4x2`` needs 8
devices; without
``--device`` the command raises the CUDA error here; a subprocess in which
pandas, scikit-learn, transformers and jax cannot be imported runs ``fame``,
``predict`` and ``data`` to the end.  ``data --synthetic 40 --device cpu``
writes the JAX command line's five CSVs with its contents (the rule of
``test_torch_etl.py``).

The baselines (``behrt``, ``bioclinicalbert``, ``average``, ``sigmoid``,
``eddi``; their results are held against the JAX pipelines in
``test_torch_baseline_pipelines.py``): each runs to its metric blocks with
``--synthetic 64 --tiny --epochs 1 --device cpu``; ``--single_task --task
ventilation`` trains one head; ``bioclinicalbert --single_task --task
readmission`` trains on ``readmission_within_30d``; ``--runs 2`` prints the
Table-3 block; ``--bf16`` is the dtype of the text encoder and the model.

The pipelines of the last slice (``dfc``, ``fairehrclp``, ``legacy-behrt``,
``legacy-eddi``; their results are held against the JAX pipelines in
``test_torch_dfc.py``, ``test_torch_fairehr.py`` and
``test_torch_legacy.py``): ``--synthetic 64 --tiny --epochs 1 --device cpu``
prints the JAX command line's lines (every digit run collapsed) with
finite metrics, ``--reference_compat`` reaches the legacy configs, and
``--bf16`` is the model's (and the text encoder's) dtype.

04 (``advdebias``; held against the JAX pipeline in
``test_torch_adv_debias.py``): ``--tiny --synthetic 8 --device cpu`` runs
both stages on the JAX command line's one-point stage-2 grid and writes the
npz files, ``metrics.csv`` and ``loss_metrics.png``; ``--bf16`` is the dtype
of its text encoder and stage-1 model.
"""

import csv
import glob
import importlib
import io
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fairmultimodal_tpu.pipelines as j_pipelines
from fairmultimodal_torch.interop import load_flax_params
from fairmultimodal_torch.models import bert as t_bert
from fairmultimodal_torch.models import text as t_text
from fairmultimodal_torch.pipelines import fame as t_fame
from fairmultimodal_tpu.models import bert as j_bert
from fairmultimodal_tpu.models import text as j_text
from fairmultimodal_tpu.train import loop as j_loop

# The modules (each package's ``cli`` exports a function of the same name).
t_cli = importlib.import_module("fairmultimodal_torch.cli.main")
j_cli = importlib.import_module("fairmultimodal_tpu.cli.main")
TEXT_CFG = dict(vocab_size=512, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=64, max_position_embeddings=64)
FAME = ["fame", "--synthetic", "64", "--tiny", "--epochs", "2", "--bsz", "16"]
TASKS = ("mortality", "los", "mechanical_ventilation")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def encoders():
    cfg = j_bert.BertConfig(**TEXT_CFG)
    params = jax.jit(j_bert.BertEncoderModel(cfg).init)(
        jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params["params"]))
    return (j_text.TextEncoder(cfg, params, j_text.HashingTokenizer(cfg.vocab_size)),
            t_text.TextEncoder.from_params(params, t_bert.BertConfig(**TEXT_CFG), device="cpu"))


def _deterministic(run, outs):
    """Wrap a ``run_fame_experiment``: train forward without dropout, keep
    the result dict."""
    def wrapped(s, u, cfg, *args, **kwargs):
        cfg.train.deterministic_forward = True
        out = run(s, u, cfg, *args, **kwargs)
        outs.append(out)
        return out
    return wrapped


def _run_jax(argv, encoders, monkeypatch):
    """The JAX command line; returns (stdout, result dicts, initial weights)."""
    outs, inits = [], []
    init = j_loop.FAMETrainer.init_params

    def init_params(self, example):
        params = init(self, example)
        inits.append(jax.tree_util.tree_map(np.array, params))
        return params

    monkeypatch.setattr(j_loop.FAMETrainer, "init_params", init_params)
    monkeypatch.setattr(j_text.TextEncoder, "from_pretrained",
                        classmethod(lambda cls, *a, **k: encoders[0]))
    monkeypatch.setattr(j_pipelines, "run_fame_experiment",
                        _deterministic(j_pipelines.run_fame_experiment, outs))
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert j_cli.main(argv) == 0
    monkeypatch.undo()
    return buf.getvalue(), outs, inits


def _run_port(argv, encoders, monkeypatch, inits=()):
    """The port's command line on the CPU with the JAX runs' initial weights."""
    outs, queue = [], list(inits)
    monkeypatch.setattr(t_text.TextEncoder, "from_pretrained",
                        classmethod(lambda cls, *a, **k: encoders[1]))
    if queue:
        monkeypatch.setattr(t_fame, "init_params",
                            lambda model, seed: load_flax_params(model, queue.pop(0)))
    monkeypatch.setattr(t_fame, "run_fame_experiment",
                        _deterministic(t_fame.run_fame_experiment, outs))
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert t_cli.main(argv + ["--device", "cpu"]) == 0
    monkeypatch.undo()
    return buf.getvalue(), outs


@pytest.fixture(scope="module")
def fame_runs(encoders, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    j_dir, t_dir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    j_out, j_res, inits = _run_jax(FAME + ["--out_dir", str(j_dir)], encoders, mp)
    t_out, t_res = _run_port(FAME + ["--out_dir", str(t_dir)], encoders, mp, inits)
    return (j_out, j_res[0], j_dir), (t_out, t_res[0], t_dir)


def _actions(parser):
    return {tuple(a.option_strings) or (a.dest,): (a.dest, a.default, a.choices, a.nargs,
                                                   a.type, a.const, a.required)
            for a in parser._actions if a.dest != "help"}


def test_parser_has_the_jax_flags_plus_device():
    want, got = _actions(j_cli.build_parser()), _actions(t_cli.build_parser())
    assert got.pop(("--device",)) == ("device", "cuda", ("cuda", "cpu"), None, None, None,
                                      False)
    assert got == want
    assert t_cli.PIPELINES == j_cli.PIPELINES
    assert _actions(t_cli.build_parser("fame")) == {
        **_actions(j_cli.build_parser("fame")), ("--device",): _actions(
            t_cli.build_parser("fame"))[("--device",)]}


def _report(text):
    """The lines from the final metric block on, digits collapsed."""
    lines = text.splitlines()
    start = lines.index("--- Final Evaluation Metrics on Test Set ---")
    return [re.sub(r"\d+", "#", re.sub(r"Saved best model to .*", "Saved", line))
            for line in lines[start:]]


def test_fame_prints_the_jax_report(fame_runs):
    (j_out, want, _), (t_out, got, _) = fame_runs
    assert _report(t_out) == _report(j_out)
    assert "Optimal thresholds from validation:" in t_out
    for task in TASKS:
        for k, v in want["metrics"][task].items():
            assert got["metrics"][task][k] == pytest.approx(v, abs=1e-4), (task, k)
        assert got["fairness"][task]["overall_eo"] == pytest.approx(
            want["fairness"][task]["overall_eo"], abs=1e-4)
    assert got["eddi"]["overall_combined_eddi"] == pytest.approx(
        want["eddi"]["overall_combined_eddi"], abs=1e-4)
    assert got["thresholds"] == want["thresholds"]
    for g, w in zip(got["history"], want["history"]):
        assert g["val_loss"] == pytest.approx(w["val_loss"], rel=1e-5)


def _csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], np.asarray(rows[1:], dtype=np.float64)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_predict_reads_either_npz_and_writes_the_jax_csv(writer, fame_runs, encoders,
                                                         tmp_path, monkeypatch):
    (_, _, j_dir), (_, _, t_dir) = fame_runs
    npz = glob.glob(str((j_dir if writer == "jax" else t_dir) / "best_model_*.npz"))[0]
    argv = ["predict", "--synthetic", "64", "--tiny", "--params", npz]
    _run_jax(argv + ["--out_dir", str(tmp_path / "jax")], encoders, monkeypatch)
    t_out, _ = _run_port(argv + ["--out_dir", str(tmp_path / "port")], encoders, monkeypatch)
    assert "Wrote predictions for " in t_out
    (j_head, j_rows), (t_head, t_rows) = (_csv(tmp_path / d / "predictions.csv")
                                          for d in ("jax", "port"))
    assert t_head == j_head == ["subject_id"] + [f"{t}_{k}" for t in TASKS
                                                 for k in ("prob", "pred")]
    np.testing.assert_allclose(t_rows, j_rows, rtol=0, atol=1e-5)


def test_mesh_exits_naming_its_item(monkeypatch):
    """Data and tensor parallelism are ported (tests/test_torch_parallel.py,
    tests/test_torch_tensor_parallel.py): ``--mesh 4x2`` is checked against
    the devices before any rank starts, and names what it needs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="mesh 4x2 needs 8 devices, have 1"):
        t_cli.main(FAME + ["--mesh", "4x2"])


@pytest.mark.parametrize("pipeline", ["fame", "fpm", "predict", "behrt", "bioclinicalbert",
                                      "average", "sigmoid", "eddi", "dfc", "fairehrclp",
                                      "legacy-behrt", "legacy-eddi", "advdebias", "data"])
def test_without_device_the_command_raises_the_cuda_error(pipeline, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cli.main([pipeline, "--synthetic", "8", "--tiny", "--out_dir", str(tmp_path)])


class _Stop(Exception):
    pass


@pytest.mark.parametrize("bf16", [True, False])
def test_bf16_is_the_dtype_of_every_model_the_run_builds(bf16, monkeypatch, tmp_path):
    """``--bf16`` reaches the text encoder under ``--require_hf_weights`` and
    the predict model; the JAX command line builds both in float32 there."""
    from fairmultimodal_torch.pipelines import inference

    seen = {}

    def encoder(cls, *args, **kwargs):
        seen["encoder"] = kwargs["dtype"]
        return "encoder"

    def inference_run(*args, **kwargs):
        seen["predict"] = kwargs["dtype"]
        raise _Stop

    def experiment(*args, **kwargs):
        seen["fame"] = args[2].dtype
        raise _Stop

    monkeypatch.setattr(t_text.TextEncoder, "from_pretrained", classmethod(encoder))
    monkeypatch.setattr(inference, "run_fame_inference", inference_run)
    monkeypatch.setattr(t_fame, "run_fame_experiment", experiment)
    flags = ["--synthetic", "8", "--device", "cpu", "--require_hf_weights",
             "--out_dir", str(tmp_path)] + (["--bf16"] if bf16 else [])
    want = torch.bfloat16 if bf16 else torch.float32
    for argv in (["fame"] + flags, ["predict", "--params", "x.npz"] + flags):
        with pytest.raises(_Stop):
            t_cli.main(argv)
    assert seen == {"encoder": want, "predict": want,
                    "fame": "bfloat16" if bf16 else "float32"}


def _hub_snapshot(hub):
    """A tiny random Bio_ClinicalBERT snapshot in a hub cache, written with
    transformers (the subprocess below reads it without)."""
    import transformers

    from fairmultimodal_torch.data.synthetic import _WORDS

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + _WORDS
    repo = hub / "models--emilyalsentzer--Bio_ClinicalBERT"
    snap = repo / "snapshots" / "0123abcd"
    snap.mkdir(parents=True)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("0123abcd")
    torch.manual_seed(0)
    transformers.BertModel(transformers.BertConfig(
        vocab_size=len(vocab), hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=64, max_position_embeddings=64)).save_pretrained(snap)
    (snap / "vocab.txt").write_text("\n".join(vocab) + "\n")


def test_fame_and_predict_run_without_pandas_sklearn_transformers_or_jax(tmp_path):
    _hub_snapshot(tmp_path / "hub")
    code = (
        "import glob, sys\n"
        "for name in ('pandas', 'sklearn', 'transformers', 'jax', 'fairmultimodal_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from fairmultimodal_torch.cli import main\n"
        f"out = {str(tmp_path)!r}\n"
        "common = ['--synthetic', '40', '--tiny', '--device', 'cpu', '--out_dir', out,\n"
        "          '--quiet', '--require_hf_weights']\n"
        "assert main(['fame', '--epochs', '1', '--bsz', '16'] + common) == 0\n"
        "npz = glob.glob(out + '/best_model_*.npz')[0]\n"
        "assert main(['predict', '--params', npz] + common) == 0\n"
        "assert main(['data', '--synthetic', '40', '--device', 'cpu', '--quiet',\n"
        "             '--out_dir', out + '/etl', '--use_native', 'off']) == 0\n"
        "bad = [m for m in ('pandas', 'sklearn', 'transformers', 'jax')\n"
        "       if sys.modules.get(m) is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, HF_HUB_CACHE=str(tmp_path / "hub"))
    out = subprocess.run([sys.executable, "-W", "ignore", "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
    _, rows = _csv(tmp_path / "predictions.csv")
    assert rows.shape[1] == 7 and np.isfinite(rows).all()
    assert len(os.listdir(tmp_path / "etl")) == 5


@pytest.mark.parametrize("native", ["auto", "off"])
def test_data_synthetic_writes_the_jax_files(native, tmp_path):
    from tests.test_torch_etl import FILES, assert_csvs_match

    argv = ["data", "--synthetic", "40", "--timing", "--use_native", native]
    outs = []
    for cli, name, extra in ((j_cli, "jax", []), (t_cli, "port", ["--device", "cpu"])):
        with redirect_stdout(io.StringIO()) as out:
            assert cli.main(argv + extra + ["--out_dir", str(tmp_path / name)]) == 0
        outs.append(out.getvalue())
    assert_csvs_match(tmp_path / "jax", tmp_path / "port")
    assert sorted(os.listdir(tmp_path / "port")) == sorted(FILES)
    paths = [re.findall(r"\[etl timing\] (\w+): (\w+) path, ([\d,]+) rows", o) for o in outs]
    assert paths[1] == [(t, "plain" if p == "pandas" else p, n) for t, p, n in paths[0]]
    assert len(paths[1]) == 4 and {p for _, p, _ in paths[1]} == (
        {"plain"} if native == "off" else {"native"})
    with pytest.raises(SystemExit, match="--runs is for training pipelines"):
        t_cli.main(argv + ["--runs", "2", "--device", "cpu"])


# -- the baselines ------------------------------------------------------------------------

BASELINES = {"behrt": "behrt", "bioclinicalbert": "text_only", "average": "average_fusion",
             "sigmoid": "sigmoid_fusion", "eddi": "eddi_fusion"}
RUNNERS = {"behrt": "run_behrt_experiment", "bioclinicalbert": "run_text_only_experiment",
           "average": "run_average_fusion_experiment",
           "sigmoid": "run_sigmoid_fusion_experiment", "eddi": "run_eddi_fusion_experiment"}


def _baseline(pipeline, argv, encoders, monkeypatch, tmp_path):
    """``python -m fairmultimodal_torch.cli <pipeline> ...`` on the CPU with the
    tiny text encoder; returns (stdout, the pipeline's result dicts)."""
    module = importlib.import_module(f"fairmultimodal_torch.pipelines.{BASELINES[pipeline]}")
    outs, run = [], getattr(module, RUNNERS[pipeline])

    def recording(*args, **kwargs):
        outs.append(run(*args, **kwargs))
        return outs[-1]

    monkeypatch.setattr(module, RUNNERS[pipeline], recording)
    monkeypatch.setattr(t_text.TextEncoder, "from_pretrained",
                        classmethod(lambda cls, *a, **k: encoders[1]))
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert t_cli.main([pipeline, "--synthetic", "64", "--tiny", "--epochs", "1",
                           "--device", "cpu", "--out_dir", str(tmp_path)] + argv) == 0
    return buf.getvalue(), outs


@pytest.mark.parametrize("pipeline", list(BASELINES))
def test_baselines_run_to_their_metric_blocks(pipeline, encoders, monkeypatch, tmp_path):
    out, (res,) = _baseline(pipeline, [], encoders, monkeypatch, tmp_path)
    for task in TASKS:
        assert f"Outcome: {task} (Threshold: 0.50)" in out
        assert np.isfinite(res["metrics"][task]["aucroc"])
    assert "Overall Combined EDDI:" in out and "[Epoch 1] Train Loss:" in out
    if pipeline == "average":
        with np.load(tmp_path / "extracted_embeddings.npz") as z:
            assert z["embeddings"].shape[1] == 512


@pytest.mark.parametrize("pipeline,head", [("behrt", "combined.classifier_mech"),
                                           ("eddi", "head_mech_")])
def test_single_task_ventilation_trains_one_head(pipeline, head, encoders, monkeypatch,
                                                 tmp_path):
    out, (res,) = _baseline(pipeline, ["--single_task", "--task", "ventilation"], encoders,
                            monkeypatch, tmp_path)
    assert list(res["metrics"]) == ["mechanical_ventilation"]
    heads = {k.rsplit(".", 1)[0] for k in res["best_params"] if "classifier_" in k
             or k.startswith("head_")}
    assert heads and all(h.startswith(head) for h in heads), heads
    assert "=== Selected task" not in out


def test_bioclinicalbert_readmission_reads_its_column(encoders, monkeypatch, tmp_path):
    from fairmultimodal_torch.data.synthetic import make_common_frames

    _, (res,) = _baseline("bioclinicalbert", ["--single_task", "--task", "readmission"],
                          encoders, monkeypatch, tmp_path)
    structured, _ = make_common_frames(n_patients=64, n_lab_features=32, seed=42)
    row = {s: i for i, s in enumerate(structured["subject_id"].tolist())}
    bundle = res["prep"].bundle
    want = structured["readmission_within_30d"][[row[s] for s in bundle.subject_id.tolist()]]
    np.testing.assert_array_equal(bundle.labels, want[:, None].astype(np.float32))
    assert list(res["metrics"]) == ["readmission"]


def test_runs_2_prints_the_table3_block(encoders, monkeypatch, tmp_path):
    out, res = _baseline("bioclinicalbert", ["--runs", "2"], encoders, monkeypatch, tmp_path)
    assert len(res) == 2
    assert "===== Aggregate over 2 runs (seeds 42..43) =====" in out
    assert "| Task        | AUROC ↑ | AUPRC ↑ | EDDI % ↓ | EO % ↓ |" in out
    assert (tmp_path / "runs_aggregate.csv").exists()


@pytest.mark.parametrize("pipeline", ["bioclinicalbert", "average", "sigmoid", "eddi"])
def test_bf16_is_the_dtype_of_the_baseline_encoder_and_model(pipeline, monkeypatch, tmp_path):
    """``--bf16 --require_hf_weights``: the text encoder and the model both
    take bfloat16 (the JAX command line builds the baselines' text encoder in
    float32, and its ``bioclinicalbert`` has no dtype)."""
    module = importlib.import_module(f"fairmultimodal_torch.pipelines.{BASELINES[pipeline]}")
    seen = {}

    def encoder(cls, *args, **kwargs):
        seen["encoder"] = kwargs["dtype"]
        return "encoder"

    def experiment(s, u, cfg, **kwargs):
        seen["model"] = cfg.dtype
        raise _Stop

    monkeypatch.setattr(t_text.TextEncoder, "from_pretrained", classmethod(encoder))
    monkeypatch.setattr(module, RUNNERS[pipeline], experiment)
    with pytest.raises(_Stop):
        t_cli.main([pipeline, "--synthetic", "8", "--device", "cpu", "--require_hf_weights",
                    "--bf16", "--out_dir", str(tmp_path)])
    assert seen == {"encoder": torch.bfloat16, "model": "bfloat16"}


# -- 03, 06 and the legacy pair -----------------------------------------------------------

NEW = {"dfc": ("dfc", "run_dfc_experiment"),
       "fairehrclp": ("fairehr_clp", "run_fairehr_clp_experiment"),
       "legacy-behrt": ("legacy", "run_legacy_behrt_experiment"),
       "legacy-eddi": ("legacy", "run_legacy_eddi_experiment")}


def _digits(text):
    """Each line with every number (sign, exponent, nan) as "#"."""
    return [re.sub(r"-?(\d+(\.\d*)?(e[-+]?\d+)?|nan)", "#", line)
            for line in text.splitlines()]


@pytest.mark.parametrize("pipeline", list(NEW))
def test_new_pipelines_print_the_jax_lines(pipeline, encoders, monkeypatch, tmp_path):
    argv = [pipeline, "--synthetic", "64", "--tiny", "--epochs", "1"]
    mp = pytest.MonkeyPatch()
    mp.setattr(j_text.TextEncoder, "from_pretrained",
               classmethod(lambda cls, *a, **k: encoders[0]))
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            assert j_cli.main(argv + ["--out_dir", str(tmp_path / "jax")]) == 0
    finally:
        mp.undo()
    module = importlib.import_module(f"fairmultimodal_torch.pipelines.{NEW[pipeline][0]}")
    outs, run = [], getattr(module, NEW[pipeline][1])

    def recording(*args, **kwargs):
        outs.append(run(*args, **kwargs))
        return outs[-1]

    monkeypatch.setattr(module, NEW[pipeline][1], recording)
    monkeypatch.setattr(t_text.TextEncoder, "from_pretrained",
                        classmethod(lambda cls, *a, **k: encoders[1]))
    t_buf = io.StringIO()
    with redirect_stdout(t_buf):
        assert t_cli.main(argv + ["--device", "cpu", "--out_dir", str(tmp_path / "port")]) == 0
    assert _digits(t_buf.getvalue()) == _digits(buf.getvalue())
    (res,) = outs
    tasks = ("mortality", "readmission") if pipeline == "legacy-eddi" else TASKS
    assert list(res["metrics"]) == list(tasks)
    for task in tasks:
        assert np.isfinite(res["metrics"][task]["aucroc"])
    assert "[Epoch 1] Train Loss:" in t_buf.getvalue()


@pytest.mark.parametrize("pipeline", list(NEW))
@pytest.mark.parametrize("flags", [["--bf16", "--reference_compat"], []])
def test_new_pipelines_take_bf16_and_reference_compat(pipeline, flags, monkeypatch, tmp_path):
    module = importlib.import_module(f"fairmultimodal_torch.pipelines.{NEW[pipeline][0]}")
    seen = {}

    def encoder(cls, *args, **kwargs):
        seen["encoder"] = kwargs["dtype"]
        return "encoder"

    def experiment(*args, **kwargs):
        cfg = args[1] if pipeline == "legacy-behrt" else args[2]
        seen["model"] = cfg.dtype
        seen["reference_compat"] = getattr(cfg, "reference_compat", None)
        seen["device"] = kwargs["device"]
        raise _Stop

    monkeypatch.setattr(t_text.TextEncoder, "from_pretrained", classmethod(encoder))
    monkeypatch.setattr(module, NEW[pipeline][1], experiment)
    with pytest.raises(_Stop):
        t_cli.main([pipeline, "--synthetic", "8", "--device", "cpu", "--require_hf_weights",
                    "--out_dir", str(tmp_path)] + flags)
    bf16 = "--bf16" in flags
    want = {"model": "bfloat16" if bf16 else "float32", "device": torch.device("cpu"),
            "reference_compat": bf16 if pipeline.startswith("legacy") else None}
    if pipeline != "legacy-behrt":      # it has no text encoder
        want["encoder"] = torch.bfloat16 if bf16 else torch.float32
    assert seen == want


# -- 04 adv_debias ------------------------------------------------------------------------

def test_advdebias_tiny_runs_and_writes_its_artifacts(encoders, monkeypatch, tmp_path):
    """``advdebias --tiny --synthetic 8 --device cpu``: both stages, the JAX
    command line's one-point stage-2 grid, and the reference's artifacts."""
    from fairmultimodal_torch.pipelines import adv_debias

    outs, run = [], adv_debias.run_adv_debias_experiment

    def recording(*args, **kwargs):
        outs.append(run(*args, **kwargs))
        return outs[-1]

    monkeypatch.setattr(adv_debias, "run_adv_debias_experiment", recording)
    monkeypatch.setattr(t_text.TextEncoder, "from_pretrained",
                        classmethod(lambda cls, *a, **k: encoders[1]))
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert t_cli.main(["advdebias", "--tiny", "--synthetic", "8", "--device", "cpu",
                           "--out_dir", str(tmp_path)]) == 0
    out = buf.getvalue()
    (res,) = outs
    (point,) = res["stage2"]
    assert point["config"] == {"learning_rate": 1e-3, "num_iters": 100, "num_nodes": 16,
                               "num_nodes_adv": 8, "dropout_rate": 0.1, "alpha": 1.0,
                               "adversarial": True, "seed": 25}
    assert "Outcome: mortality (Threshold: 0.50)" in out and "Iteration: 0," in out
    tag = ("learning_rate_0.001-num_iters_100-num_nodes_16-num_nodes_adv_8-dropout_rate_0.1-"
           "alpha_1.0")
    for path in (f"model/model-basic_{tag}.npz", "model/model-basic_final.npz",
                 f"adv/model-adv_{tag}.npz", "adv/model-adv_final.npz", "metrics.csv",
                 "loss_metrics.png"):
        assert (tmp_path / path).is_file(), path
    assert (tmp_path / "metrics").is_dir()
    with open(tmp_path / "metrics.csv") as f:
        assert f.readline().startswith("learning_rate,num_iters,num_nodes,num_nodes_adv,")


def test_advdebias_bf16_is_the_dtype_of_the_encoder_and_stage_1(monkeypatch, tmp_path):
    """``--bf16 --require_hf_weights``: the text encoder and stage 1's model
    take bfloat16 (the JAX command line builds this encoder in float32);
    stage 2 has no dtype, it is float32."""
    from fairmultimodal_torch.pipelines import adv_debias

    seen = {}

    def encoder(cls, *args, **kwargs):
        seen["encoder"] = kwargs["dtype"]
        return "encoder"

    def experiment(s, u, cfg, **kwargs):
        seen["model"] = cfg.dtype
        raise _Stop

    monkeypatch.setattr(t_text.TextEncoder, "from_pretrained", classmethod(encoder))
    monkeypatch.setattr(adv_debias, "run_adv_debias_experiment", experiment)
    with pytest.raises(_Stop):
        t_cli.main(["advdebias", "--synthetic", "8", "--device", "cpu", "--require_hf_weights",
                    "--bf16", "--out_dir", str(tmp_path)])
    assert seen == {"encoder": torch.bfloat16, "model": "bfloat16"}
