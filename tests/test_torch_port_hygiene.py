"""The port stands alone: no JAX anywhere in it, and CUDA unless asked.

- no module of ``fairmultimodal_torch`` imports ``jax``, ``flax`` or
  ``fairmultimodal_tpu``;
- every module imports in a fresh interpreter where those are unimportable;
- entry points called with ``device=None`` on a machine without CUDA raise
  instead of falling back to the CPU.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import fairmultimodal_torch
from fairmultimodal_torch.models.bert import BertConfig
from fairmultimodal_torch.models.fusion import FAMEModel
from fairmultimodal_torch.models.text import TextEncoder
from fairmultimodal_torch.pipelines.inference import FAMEPredictor, run_fame_inference
from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig

PKG = pathlib.Path(fairmultimodal_torch.__file__).parent
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|fairmultimodal_tpu)\b", re.M)


def test_no_module_imports_jax_flax_or_the_jax_package():
    offenders = [str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
                 if FORBIDDEN.search(p.read_text())]
    assert offenders == []


def test_every_module_imports_with_jax_unimportable():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'flax', 'fairmultimodal_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import fairmultimodal_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'fairmultimodal_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in {k for k, v in sys.modules.items() if v is not None}\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


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
