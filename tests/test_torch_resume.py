"""Resume of ``FAMETrainer.fit`` from the port's ``Checkpointer``, and the
command line's checkpoint layout (CPU, fp32, tiny).

Two faults of the JAX package are pinned here by what the port does:

1. The JAX resume is not bit-identical, though its help text and ``fit``
   docstring promise it (``train/loop.py:690-702``).  Each completed epoch
   draws two ``(seed, epoch)`` permutations from the train loader, one for
   the train pass and one for the dynamic-weight pass (``loop.py:627-640``),
   but the JAX ``fit`` re-aligns the loader to ``start_epoch``
   (``loop.py:745-750``), so a resumed run draws other shuffles from its
   second epoch on.  The port checkpoints the loader's consumed-epoch count:
   2 epochs uninterrupted and 1 epoch plus a resume to 2 leave bit-identical
   parameters, best state, AdamW state, dynamic weights and history, with
   dropout on, on a shuffled host loader and on ``DeviceLoader``; putting
   the JAX realignment back breaks it.
2. ``--runs N`` with ``--checkpoint_dir`` shares one directory across the
   seeds in the JAX command line (``cli/main.py:278-321``): run 2 resumes
   from run 1's last epoch, trains for no epochs and reports run 1's model.
   The port gives each run ``<checkpoint_dir>/seed_<seed>``: both seeds
   train, and their rows differ.

The uninterrupted run with checkpoints still matches the JAX command line
(``--runs 2``, no checkpoints) to ``test_torch_fame_pipeline.py``'s
tolerances: losses 1e-5 relative, dynamic weights 1e-6, metrics and the
aggregate CSV 1e-4.  A second invocation on a finished directory resumes and
rewrites no file.
"""

import csv
import os

import numpy as np
import pytest
import torch
from test_torch_cli import FAME, _run_jax, _run_port, encoders  # noqa: F401  (fixture)

from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.fusion import FAMEModel
from fairmultimodal_torch.pipelines.common import make_loaders
from fairmultimodal_torch.train import loop as t_loop
from fairmultimodal_torch.train.loop import FAMETrainer, TrainConfig
from fairmultimodal_torch.utils.checkpoint import Checkpointer

N, N_TRAIN, BATCH, LABS, TEXT = 48, 36, 16, 12, 16


def _data():
    rng = np.random.default_rng(0)
    arrays = {
        "demo_dummy_ids": np.zeros((N, 1), np.int32),
        "demo_attn_mask": np.ones((N, 1), np.int32),
        "age_ids": rng.integers(0, 4, N).astype(np.int32),
        "gender_ids": rng.integers(0, 2, N).astype(np.int32),
        "ethnicity_ids": rng.integers(0, 5, N).astype(np.int32),
        "insurance_ids": rng.integers(0, 6, N).astype(np.int32),
        "lab_features": rng.normal(size=(N, LABS)).astype(np.float32),
        "text_embedding": rng.normal(size=(N, TEXT)).astype(np.float32),
    }
    labels = (rng.random((N, 3)) < 0.4).astype(np.float32)
    return arrays, labels


def _fit(ckpt_dir, epochs, device_data):
    """A fresh tiny model and trainer (dropout on) through ``fit``."""
    arrays, labels = _data()
    loaders = make_loaders(arrays, labels, {"train": np.arange(N_TRAIN),
                                            "val": np.arange(N_TRAIN, N)},
                           BATCH, seed=7, device_data=device_data, device="cpu")
    model = init_params(FAMEModel(4, 2, 5, 6, lab_token_count=LABS, text_embed_size=TEXT,
                                  hidden_size=32, demo_layers=1, demo_heads=2, lab_layers=1,
                                  lab_heads=2, fusion_hidden=16), seed=3)
    trainer = FAMETrainer(model, TrainConfig(lr=1e-3, num_epochs=epochs, batch_size=BATCH),
                          np.ones(3), rngs_seed=5, device="cpu")
    best, history = trainer.fit(loaders["train"], loaders["val"], verbose=False,
                                checkpointer=Checkpointer(str(ckpt_dir)))
    return trainer, best, history


def _assert_same(a, b, path="state"):
    """Bit-identical nested state (tensors, arrays, containers, scalars)."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}/{i}")
    else:
        assert a == b, path


@pytest.mark.parametrize("device_data", [False, True], ids=["host_loader", "device_loader"])
def test_resume_is_bit_identical(device_data, tmp_path, capsys):
    whole, best, history = _fit(tmp_path / "whole", 2, device_data)
    _fit(tmp_path / "cut", 1, device_data)
    assert Checkpointer(str(tmp_path / "cut")).latest_step() == 1
    capsys.readouterr()
    trainer, best_r, history_r = _fit(tmp_path / "cut", 2, device_data)
    assert [h["epoch"] for h in history_r] == [1, 2]
    _assert_same(history_r, history)
    _assert_same(trainer.model.state_dict(), whole.model.state_dict())
    _assert_same(best_r, best)
    _assert_same(trainer.optimizer.state_dict(), whole.optimizer.state_dict())
    np.testing.assert_array_equal(trainer.dynamic_weights, whole.dynamic_weights)
    assert trainer.dynamic_weights.dtype == np.float64
    _assert_same(trainer.tracked_dynamic_weights, whole.tracked_dynamic_weights)
    _assert_same(trainer.tracked_sigmoid_weights, whole.tracked_sigmoid_weights)
    _assert_same(trainer.generator.get_state(), whole.generator.get_state())
    _assert_same(Checkpointer(str(tmp_path / "cut")).restore(2),
                 Checkpointer(str(tmp_path / "whole")).restore(2))


def test_the_jax_realignment_breaks_resume(tmp_path, monkeypatch):
    """Restore the loader to the resumed epoch, as the JAX ``fit`` does, and
    the second epoch trains on other shuffles than the uninterrupted run."""
    _, _, history = _fit(tmp_path / "whole", 2, True)
    _fit(tmp_path / "cut", 1, True)
    restore = t_loop.FAMETrainer._restore

    def jax_realignment(self, state, sched, stopper):
        best, rows, _ = restore(self, state, sched, stopper)
        return best, rows, len(state["history"])      # start_epoch, not the count

    monkeypatch.setattr(t_loop.FAMETrainer, "_restore", jax_realignment)
    _, _, history_r = _fit(tmp_path / "cut", 2, True)
    assert history_r[0] == history[0]
    assert history_r[1]["train_loss"] != history[1]["train_loss"]


def test_checkpoint_files_are_atomic_and_weights_only(tmp_path):
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() is None
    ck.save(2, {"x": torch.arange(3), "rows": [("Epoch", 1)], "lr": 1e-3})
    (tmp_path / "step_9.pt.tmp.123").write_bytes(b"torn")
    assert ck.latest_step() == 2
    assert torch.load(ck.path(2), weights_only=True)["rows"] == [("Epoch", 1)]
    with pytest.raises(Exception):
        ck.save(3, {"f": lambda: 0})                  # not picklable: nothing left behind
    assert sorted(os.listdir(tmp_path)) == ["step_2.pt", "step_9.pt.tmp.123"]


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_runs_2_matches_jax_and_checkpoints_each_seed_apart(encoders, tmp_path,  # noqa: F811
                                                            monkeypatch):
    """``--runs 2`` prints the Table-3 block and writes the JAX run's
    ``runs_aggregate.csv`` (1e-4), each seed checkpointed apart; the same
    command cut after epoch 1 and run again resumes both seeds to the same
    numbers, bit for bit."""
    argv = FAME + ["--runs", "2"]
    j_out, want, inits = _run_jax(argv + ["--quiet", "--out_dir", str(tmp_path / "jax")],
                                  encoders, monkeypatch)
    ck = tmp_path / "ck"
    t_out, got = _run_port(argv + ["--out_dir", str(tmp_path / "port"),
                                   "--checkpoint_dir", str(ck)], encoders, monkeypatch, inits)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for gh, wh in zip(g["history"], w["history"]):
            for k in ("train_loss", "train_bce", "val_loss"):
                assert gh[k] == pytest.approx(wh[k], rel=1e-5)
        np.testing.assert_allclose(g["trainer"].dynamic_weights, w["trainer"].dynamic_weights,
                                   rtol=0, atol=1e-6)
    assert "===== Aggregate over 2 runs (seeds 42..43) =====" in t_out
    table = [line for line in t_out.splitlines() if line.startswith("|")]
    assert table[0] == "| Task        | AUROC ↑ | AUPRC ↑ | EDDI % ↓ | EO % ↓ |"
    assert len(table) == len([line for line in j_out.splitlines() if line.startswith("|")])
    port_csv, jax_csv = (_rows(tmp_path / d / "runs_aggregate.csv") for d in ("port", "jax"))
    assert [r[:4] for r in port_csv] == [r[:4] for r in jax_csv]
    np.testing.assert_allclose([float(r[4]) for r in port_csv[1:]],
                               [float(r[4]) for r in jax_csv[1:]], rtol=0, atol=1e-4)

    # Both seeds trained into their own directory, and their rows differ.
    for seed in (42, 43):
        assert sorted(os.listdir(ck / f"seed_{seed}")) == ["step_1.pt", "step_2.pt"]
    by_run = {r[0]: [] for r in port_csv[1:]}
    for r in port_csv[1:]:
        by_run[r[0]].append(r[4])
    assert by_run["0"] != by_run["1"]
    assert "Resumed" not in t_out

    # Cut after epoch 1, then the same command again: both seeds resume.
    cut = tmp_path / "cut"
    for epochs in ("1", "2"):
        resumed, _ = _run_port(argv[:5] + [epochs] + argv[6:] + [
            "--out_dir", str(tmp_path / f"cut_{epochs}"), "--checkpoint_dir", str(cut)],
            encoders, monkeypatch, inits)
    assert resumed.count("Resumed from checkpoint at epoch 1.") == 2
    assert _rows(tmp_path / "cut_2" / "runs_aggregate.csv") == port_csv
    for seed in (42, 43):
        _assert_same(Checkpointer(str(cut / f"seed_{seed}")).restore(2),
                     Checkpointer(str(ck / f"seed_{seed}")).restore(2))


def test_second_invocation_on_a_finished_directory_rewrites_nothing(encoders,  # noqa: F811
                                                                    tmp_path, monkeypatch):
    ck = tmp_path / "ck"
    argv = FAME + ["--out_dir", str(tmp_path), "--checkpoint_dir", str(ck)]
    _run_port(argv + ["--quiet"], encoders, monkeypatch)
    steps = sorted(os.listdir(ck))
    assert steps == ["step_1.pt", "step_2.pt"]
    mtimes = {s: os.stat(ck / s).st_mtime_ns for s in steps}
    out, _ = _run_port(argv, encoders, monkeypatch)
    assert "Resumed from checkpoint at epoch 2." in out
    assert sorted(os.listdir(ck)) == steps
    assert {s: os.stat(ck / s).st_mtime_ns for s in steps} == mtimes


def test_fit_docstring_names_the_jax_fault():
    doc = FAMETrainer.fit.__doc__
    assert "loop.py:745-750" in doc and "consumed-epoch count" in doc
    import importlib

    cli_doc = importlib.import_module("fairmultimodal_torch.cli.main").__doc__
    assert "seed_<seed>" in cli_doc and "_run_multi" in cli_doc
