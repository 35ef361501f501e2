"""The port stands alone: no JAX anywhere in it, and CUDA unless asked.

- no module of ``fairmultimodal_torch`` imports ``jax``, ``flax`` or
  ``fairmultimodal_tpu``;
- every module imports in a fresh interpreter where those are unimportable;
- entry points called with ``device=None`` on a machine without CUDA raise
  instead of falling back to the CPU;
- the card's machine has no pandas, scikit-learn or transformers: no module
  imports ``sklearn`` or ``transformers``, ``pandas`` is imported only inside
  the functions that take DataFrames, and every module imports without them;
- the experiment's config fields that are not ported yet raise;
- the baseline pipelines and ``MultitaskTrainer`` default to CUDA and
  raise without it, and a baseline run on port tables in a subprocess
  leaves no ``jax``, ``pandas``, ``sklearn`` or ``transformers`` in
  ``sys.modules``;
- the modules of 03, 06 and the legacy pair are among those the scans
  read, import neither JAX nor pandas at any level, and their pipelines
  (06 in both modes, ``legacy-behrt`` from a CSV read without pandas) run
  in a subprocess where pandas and JAX cannot be imported;
- so are the ETL's modules (``data/etl.py``, ``native.py``, ``validate.py``,
  ``synthetic.py``), and ``run_etl`` defaults to CUDA and raises without it;
- every name in a JAX module's ``__all__`` resolves in the port's module of
  the same path, apart from the deliberate exclusions below; the new names
  compute what their JAX counterparts do.
"""

import ast
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import fairmultimodal_torch
from fairmultimodal_torch.data.device import DeviceLoader
from fairmultimodal_torch.data.featurize import FeatureBundle
from fairmultimodal_torch.models.bert import BertConfig
from fairmultimodal_torch.models.fusion import FAMEModel
from fairmultimodal_torch.models.text import TextEncoder
from fairmultimodal_torch.parallel import Mesh
from fairmultimodal_torch.pipelines.fame import (FAMEPipelineConfig, run_fame_bundle,
                                                 run_fame_experiment)
from fairmultimodal_torch.pipelines.inference import FAMEPredictor, run_fame_inference
from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig

PKG = pathlib.Path(fairmultimodal_torch.__file__).parent
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|fairmultimodal_tpu)\b", re.M)


def test_no_module_imports_jax_flax_or_the_jax_package():
    offenders = [str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
                 if FORBIDDEN.search(p.read_text())]
    assert offenders == []


# The two fresh interpreters that import every module, one with JAX
# unimportable and one without pandas, scikit-learn and transformers.
_IMPORT_CHECKS = {
    "no_jax": (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'flax', 'fairmultimodal_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import fairmultimodal_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'fairmultimodal_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in {k for k, v in sys.modules.items() if v is not None}\n"
        "print(len(names))\n"),
    "no_pandas": (
        "import sys, pkgutil, importlib\n"
        "for name in ('pandas', 'sklearn', 'transformers'):\n"
        "    sys.modules[name] = None\n"
        "import fairmultimodal_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, 'fairmultimodal_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n"),
}


@pytest.fixture(scope="module")
def import_checks():
    """Both interpreters, started together: name -> (returncode, stdout, stderr)."""
    procs = {name: subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True, cwd=PKG.parent)
             for name, code in _IMPORT_CHECKS.items()}
    out = {}
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            raise
        out[name] = (proc.returncode, stdout, stderr)
    return out


def test_every_module_imports_with_jax_unimportable(import_checks):
    rc, stdout, stderr = import_checks["no_jax"]
    assert rc == 0, stderr
    assert int(stdout.strip()) >= 15


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = FAMEModel(2, 2, 2, 2, lab_token_count=4, text_embed_size=8, hidden_size=16,
                      demo_layers=1, demo_heads=2, lab_layers=1, lab_heads=2,
                      fusion_hidden=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FAMEPredictor(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FAMETrainer(model, TrainConfig(), pos_weight=np.ones(3))
    tiny = BertConfig(vocab_size=32, hidden_size=16, num_hidden_layers=1,
                      num_attention_heads=2, intermediate_size=32, max_position_embeddings=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TextEncoder.from_pretrained(fallback_config=tiny)
    np.savez(tmp_path / "p.npz", x=np.zeros(1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_fame_inference(None, None, str(tmp_path / "p.npz"))


def _imports(node):
    if isinstance(node, ast.Import):
        return [a.name.split(".")[0] for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.module and not node.level:
        return [node.module.split(".")[0]]
    return []


def _module_level_imports(tree):
    """Top-level names imported outside any function body."""
    found, stack = [], list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        found += _imports(node)
        stack.extend(ast.iter_child_nodes(node))
    return found


def test_no_sklearn_or_transformers_and_pandas_only_in_functions():
    bad, pandas_top, pandas_any = [], [], 0
    for p in PKG.rglob("*.py"):
        tree = ast.parse(p.read_text())
        every = [n for node in ast.walk(tree) for n in _imports(node)]
        bad += [f"{p.relative_to(PKG)}: {n}" for n in every if n in ("sklearn", "transformers")]
        pandas_any += every.count("pandas")
        if "pandas" in _module_level_imports(tree):
            pandas_top.append(str(p.relative_to(PKG)))
    assert bad == [] and pandas_top == []
    assert pandas_any >= 2          # the DataFrame functions do import it


def test_every_module_imports_without_pandas_sklearn_or_transformers(import_checks):
    rc, stdout, stderr = import_checks["no_pandas"]
    assert rc == 0 and stdout.strip() == "ok", stderr


def _bundle(n=12):
    rng = np.random.default_rng(0)
    return FeatureBundle(
        subject_id=np.arange(n), age_codes=rng.integers(0, 4, n).astype(np.int32),
        gender_codes=np.zeros(n, np.int32), ethnicity_codes=np.zeros(n, np.int32),
        insurance_codes=np.zeros(n, np.int32), labs=np.zeros((n, 3), np.float32),
        labels=np.zeros((n, 3), np.float32), lab_columns=["a", "b", "c"],
        note_chunks=[["note"]] * n)


def test_experiment_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceLoader({"x": np.zeros((4, 1))}, np.zeros((4, 3)), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_fame_bundle(_bundle(), verbose=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_fame_experiment(None, None, verbose=False)


@pytest.mark.parametrize("field,value,error,match", [
    # Data and tensor parallelism are ported; a mesh needs its process group
    # (parallel.get_mesh in each rank).
    ("mesh", Mesh(data=2, model=2, rank=0, device=torch.device("cpu")), ValueError,
     "mesh 2x2 has no process group"),
    ("require_hf_weights", True, RuntimeError, "required"),
])
def test_experiment_fields_not_ported_raise(field, value, error, match, tmp_path):
    cfg = FAMEPipelineConfig(out_dir=str(tmp_path), **{field: value})
    with pytest.raises(error, match=match):
        run_fame_bundle(_bundle(), cfg, verbose=False, device="cpu")
    if field != "require_hf_weights":
        with pytest.raises(error, match=match):
            run_fame_experiment(None, None, cfg, verbose=False, device="cpu")
    with pytest.raises(RuntimeError, match="required"):
        TextEncoder.from_pretrained(require_weights=True, device="cpu")


def test_baseline_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from fairmultimodal_torch import pipelines
    from fairmultimodal_torch.data.synthetic import make_common_frames
    from fairmultimodal_torch.models.baselines import TextOnlyClassifier
    from fairmultimodal_torch.pipelines.common import prepare_experiment
    from fairmultimodal_torch.train.simple import MultitaskTrainer, SimpleTrainConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tables = make_common_frames(n_patients=16, n_lab_features=4, seed=0)
    for run in ("run_behrt_experiment", "run_text_only_experiment",
                "run_average_fusion_experiment", "run_sigmoid_fusion_experiment",
                "run_eddi_fusion_experiment"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            getattr(pipelines, run)(*tables, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prepare_experiment(*tables, model_keys=("lab_features",), batch_size=4,
                           need_text=False, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultitaskTrainer(TextOnlyClassifier(8), SimpleTrainConfig())


def test_a_baseline_runs_on_port_tables_without_jax_pandas_sklearn_or_transformers():
    code = (
        "import sys, warnings\n"
        "warnings.simplefilter('ignore')\n"
        "from fairmultimodal_torch import pipelines\n"
        "from fairmultimodal_torch.models import baselines, fusion\n"
        "from fairmultimodal_torch.pipelines import common\n"
        "from fairmultimodal_torch.train import simple\n"
        "from fairmultimodal_torch.data import split\n"
        "from fairmultimodal_torch.data.synthetic import make_common_frames\n"
        "from fairmultimodal_torch.models.bert import BertConfig\n"
        "from fairmultimodal_torch.models.text import TextEncoder\n"
        "enc = TextEncoder.from_pretrained('no/such-model', device='cpu', fallback_config=\n"
        "    BertConfig(vocab_size=512, hidden_size=32, num_hidden_layers=1,\n"
        "               num_attention_heads=2, intermediate_size=64,\n"
        "               max_position_embeddings=64))\n"
        "cfg = pipelines.SigmoidFusionPipelineConfig(hidden_size=32, demo_layers=1,\n"
        "    demo_heads=2, lab_layers=1, lab_heads=2, text_max_length=32)\n"
        "cfg.train.num_epochs = 1\n"
        "out = pipelines.run_sigmoid_fusion_experiment(\n"
        "    *make_common_frames(n_patients=48, n_lab_features=6, seed=1), cfg,\n"
        "    text_encoder=enc, verbose=False, device='cpu')\n"
        "assert set(out['metrics']) == {'mortality', 'los', 'mechanical_ventilation'}\n"
        "loaded = [m for m in ('jax', 'pandas', 'sklearn', 'transformers')\n"
        "          if m in sys.modules]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=240)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


NEW_MODULES = ("models/fairehr.py", "models/legacy.py", "pipelines/dfc.py",
               "pipelines/fairehr_clp.py", "pipelines/legacy.py", "data/etl.py",
               "data/native.py", "data/validate.py", "data/synthetic.py")


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_the_new_modules_are_scanned_and_import_no_jax_or_pandas(rel):
    path = PKG / rel
    assert path in set(PKG.rglob("*.py"))
    tree = ast.parse(path.read_text())
    every = {n for node in ast.walk(tree) for n in _imports(node)}
    assert not every & {"jax", "flax", "fairmultimodal_tpu", "pandas", "sklearn",
                        "transformers"}, every


def test_new_pipelines_run_without_jax_or_pandas(tmp_path):
    code = (
        "import sys, warnings\n"
        "for name in ('pandas', 'sklearn', 'transformers', 'jax', 'fairmultimodal_tpu'):\n"
        "    sys.modules[name] = None\n"
        "warnings.simplefilter('ignore')\n"
        "from fairmultimodal_torch import pipelines\n"
        "from fairmultimodal_torch.cli import main\n"
        "from fairmultimodal_torch.data.synthetic import make_admission_frame, make_common_frames\n"
        "from fairmultimodal_torch.data.table import write_csv_table\n"
        "from fairmultimodal_torch.models.bert import BertConfig\n"
        "from fairmultimodal_torch.models.text import TextEncoder\n"
        "enc = TextEncoder.from_pretrained('no/such-model', device='cpu', fallback_config=\n"
        "    BertConfig(vocab_size=512, hidden_size=32, num_hidden_layers=1,\n"
        "               num_attention_heads=2, intermediate_size=64,\n"
        "               max_position_embeddings=64))\n"
        "tables = make_common_frames(n_patients=48, n_lab_features=6, seed=1)\n"
        "for contrastive in (False, True):\n"
        "    cfg = pipelines.FairEHRCLPPipelineConfig(hidden_size=32, num_hidden_layers=1,\n"
        "        num_attention_heads=2, text_max_length=32, contrastive=contrastive)\n"
        "    cfg.train.num_epochs = 1\n"
        "    out = pipelines.run_fairehr_clp_experiment(*tables, cfg, text_encoder=enc,\n"
        "                                                verbose=False, device='cpu')\n"
        "    assert len(out['metrics']) == 3\n"
        f"write_csv_table({str(tmp_path / 'final_structured_common.csv')!r},\n"
        "                make_admission_frame(40, seed=2))\n"
        f"assert main(['legacy-behrt', '--data_dir', {str(tmp_path)!r}, '--tiny',\n"
        "             '--epochs', '1', '--device', 'cpu', '--quiet']) == 0\n"
        "bad = [m for m in ('pandas', 'sklearn', 'transformers', 'jax')\n"
        "       if sys.modules.get(m) is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=240)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_run_etl_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    from fairmultimodal_torch.data.etl import run_etl

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_etl(str(tmp_path), str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


#: Names of the JAX package's ``__all__`` lists the port leaves out on purpose.
NOT_PORTED = {
    # The kernels' build cache is build/kernels/<hash>/ (ops/_build.py).
    "fairmultimodal_tpu.cachedir": "*",
    # No environment kill switch, and no process-wide fallback: the port's
    # sharded layers run hand-written kernels that need no partitioner.
    "fairmultimodal_tpu.ops.gates": {"kernels_enabled", "force_xla_path", "forced_xla_reason",
                                     "clear_forced_xla_path"},
    # A measured negative result in JAX; an optax transform (torch clips).
    "fairmultimodal_tpu.ops.optim": {"fused_clip_adamw_apply", "clip_by_global_norm_torch"},
    # JAX PRNG keys; the port's dropout is Philox (utils/rng.py).
    "fairmultimodal_tpu.utils.rng": {"make_rng", "threefry_key"},
    "fairmultimodal_tpu.utils": {"make_rng", "threefry_key"},
}


def test_every_jax_public_name_resolves_in_the_port():
    import importlib
    import pkgutil

    import fairmultimodal_tpu

    missing, checked = {}, 0
    for info in pkgutil.walk_packages(fairmultimodal_tpu.__path__, "fairmultimodal_tpu."):
        names = getattr(importlib.import_module(info.name), "__all__", None)
        skip = NOT_PORTED.get(info.name, set())
        if names is None or skip == "*":
            continue
        port = importlib.import_module(info.name.replace("fairmultimodal_tpu",
                                                         "fairmultimodal_torch"))
        gone = [n for n in names if n not in skip and not hasattr(port, n)]
        checked += len(names)
        if gone:
            missing[info.name] = gone
    assert missing == {} and checked > 250


def test_the_new_public_names_match_jax():
    import dataclasses

    import jax.numpy as jnp
    import pandas as pd

    from fairmultimodal_torch import data, fairness, ops, parallel
    from fairmultimodal_torch.data import etl, native, validate
    from fairmultimodal_torch.pipelines.common import build_arrays
    from fairmultimodal_torch.pipelines.fame import build_model_arrays
    from fairmultimodal_tpu.data import etl as j_etl
    from fairmultimodal_tpu.data import validate as j_validate
    from fairmultimodal_tpu.data.featurize import FeatureBundle as JBundle
    from fairmultimodal_tpu.ops import losses as j_losses
    from fairmultimodal_tpu.pipelines.common import build_arrays as j_build_arrays
    from fairmultimodal_tpu.pipelines.fame import build_model_arrays as j_build_model_arrays

    bundle = _bundle()
    bundle.text_embeddings = np.arange(36, dtype=np.float64).reshape(12, 3)
    j_bundle = JBundle(**{f.name: getattr(bundle, f.name)
                          for f in dataclasses.fields(JBundle)})
    for got, want in ((build_arrays(bundle), j_build_arrays(j_bundle)),
                      (build_model_arrays(bundle), j_build_model_arrays(j_bundle))):
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert "text_embedding" not in build_arrays(_bundle())

    x = np.linspace(-30, 30, 101)
    np.testing.assert_allclose(ops.sigmoid(torch.from_numpy(x)).numpy(),
                               np.asarray(j_losses.sigmoid(jnp.asarray(x, jnp.float32))),
                               atol=1e-7)
    batches = [{"a": np.full(2, i)} for i in range(5)]
    got = list(data.prefetch_to_device(batches, size=2, device="cpu"))
    assert [int(b["a"][0]) for b in got] == list(range(5))
    assert all(isinstance(b["a"], torch.Tensor) for b in got)
    assert ops.flash_attention.__name__ == "fairmultimodal_torch.ops.flash_attention"
    q = torch.randn(1, 2, 4, 8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(ops.flash_attention(q, q, q), ops.flash_attention.flash_attention(q, q, q))
    assert parallel.DEFAULT_TP_RULES and fairness.eddi_loss and data.DeviceLoader

    chunks = [["a b", "c"], [], ["d"]]
    index = pd.RangeIndex(3)
    want = j_etl.chunk_lists_to_frame(chunks, index)
    got = etl.chunk_lists_to_frame(chunks, index)
    assert list(got) == list(want.columns)
    for col in want:
        assert [None if v is None or v != v else v for v in want[col]] == list(got[col])
    assert native.build() is True

    ok = pd.DataFrame({"subject_id": [1], "hadm_id": [2], "short_term_mortality": [0],
                       "los_binary": [1], "mechanical_ventilation": [0]})
    notes = pd.DataFrame({"subject_id": [1], "hadm_id": [2], "note_chunk_1": ["x"]})
    validate.validate_common_frames(ok, notes)
    for s, u in ((ok.drop(columns="hadm_id"), notes), (ok, notes.drop(columns="note_chunk_1")),
                 (ok.assign(los_binary=[np.nan]), notes)):
        with pytest.raises(j_validate.MimicInputError) as want_err:
            j_validate.validate_common_frames(s, u)
        with pytest.raises(validate.MimicInputError) as got_err:
            validate.validate_common_frames(s, u)
        assert str(got_err.value) == str(want_err.value)

