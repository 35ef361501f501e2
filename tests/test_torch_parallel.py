"""Data-parallel FAME training (``fairmultimodal_torch.parallel``, ``--mesh N``)
on two gloo ranks on the CPU, against the JAX package's ``shard_map`` DP
path (``get_mesh(data=2, model=1)`` over conftest's virtual devices) and
against the single-process port, on the same seeded numpy inputs and
weights (the port's seeded init, carried to the JAX trees by ``interop``).

The two-rank job starts once, in the module fixture :func:`dp`, in the
background, and runs every rank-side check (:func:`_rank_checks`); the
references (:func:`refs`) are computed while it runs, and the tests below
assert on what each rank returned.  Rank processes are spawned, so this
module imports no ``jax`` at its top: the JAX side runs in the test process
only.  Each rank runs one thread, a fresh port, a 60 s collective timeout
and a launch timeout, so a hung rank fails the fixture instead of the suite.

Tolerances are the trainer tests' (float64): losses 1e-8 relative, logits,
grads and parameters 1e-9 + 1e-6 relative; the dynamic-weight statistics
and the cross-rank parameters bit for bit; the text encode (fp32) 1e-5
relative + 1e-6, as the JAX DP encode test holds it.
"""

import concurrent.futures
import contextlib
import glob
import hashlib
import importlib
import io
import os
import time

import numpy as np
import pytest
import torch

from fairmultimodal_torch import parallel
from fairmultimodal_torch.data.device import DeviceLoader
from fairmultimodal_torch.data.loader import BatchIterator, NestedLoader
from fairmultimodal_torch.data.prefetch import PrefetchLoader, to_device
from fairmultimodal_torch.models.bert import BertConfig
from fairmultimodal_torch.models.fusion import FAMEModel as TFAME
from fairmultimodal_torch.models.text import TextEncoder, encode_note_chunks
from fairmultimodal_torch.train import loop as tloop
from fairmultimodal_torch.utils import rng as trng

H, NH, LABS, TEXT, B = 32, 4, 20, 12, 8
N_AGE, N_GEN, N_ETH, N_INS = 4, 2, 5, 6
POS_W = np.array([2.0, 0.5, 3.0], np.float32)
GEO = dict(num_ages=N_AGE, num_genders=N_GEN, num_ethnicities=N_ETH, num_insurances=N_INS,
           lab_token_count=LABS, hidden_size=H, demo_layers=1, demo_heads=NH,
           lab_layers=1, lab_heads=NH)
CFG = dict(lr=1e-3, weight_decay=0.01, grad_clip=1.0, lambda_edd=0.8, lambda_l1=0.01,
           batch_size=B)
BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=16)
CHUNKS = [["alpha beta", "gamma"], [], ["delta epsilon zeta"], ["eta", "theta iota", "kappa"],
          ["lambda"], [], ["mu nu xi omicron"]]
CLI_TEXT = dict(vocab_size=512, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=64, max_position_embeddings=64)
CLI = ["fame", "--synthetic", "64", "--tiny", "--bsz", "16", "--device", "cpu", "--mesh", "2"]
LOSS_REL, ATOL, RTOL = 1e-8, 1e-9, 1e-6
N_STEPS, N_FIT, N_VAL = 6, 20, 12
CPU = torch.device("cpu")


def _inputs(rng, n):
    return {
        "demo_dummy_ids": np.ones((n, 1), np.int32),
        "demo_attn_mask": np.ones((n, 1), np.int32),
        "age_ids": rng.integers(0, N_AGE, n).astype(np.int32),
        "gender_ids": rng.integers(0, N_GEN, n).astype(np.int32),
        "ethnicity_ids": rng.integers(0, N_ETH, n).astype(np.int32),
        "insurance_ids": rng.integers(0, N_INS, n).astype(np.int32),
        "lab_features": rng.normal(0, 1, (n, LABS)),
        "text_embedding": rng.normal(0, 1, (n, TEXT)),
    }


def _batch(seed, n=B, pad=0):
    rng = np.random.default_rng(seed)
    weight = np.ones(n, np.float64)
    if pad:
        weight[-pad:] = 0.0            # a padded tail: the global denominators differ
    return {"model_inputs": _inputs(rng, n),
            "labels": rng.integers(0, 2, (n, 3)).astype(np.float64), "weight": weight}


def _split(seed, n):
    rng = np.random.default_rng(seed)
    return _inputs(rng, n), rng.integers(0, 2, (n, 3)).astype(np.float64)


def _model(weights):
    m = TFAME(**GEO, text_embed_size=TEXT, dtype=torch.float64).double()
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in weights.items()})
    return m


def _trainer(weights, mesh=None, deterministic=True, **cfg):
    return tloop.FAMETrainer(
        _model(weights), tloop.TrainConfig(deterministic_forward=deterministic, **{**CFG, **cfg}),
        pos_weight=POS_W, device="cpu", mesh=mesh)


def _state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _grads(trainer):
    return {n: p.grad.detach().numpy().copy() for n, p in trainer.model.named_parameters()
            if p.grad is not None}


def _digest(model):
    h = hashlib.blake2b(digest_size=16)
    for v in model.state_dict().values():
        h.update(v.detach().numpy().tobytes())
    return h.hexdigest()


def _device_loaders(mesh, batch_size=B):
    (x, y), (xv, yv) = _split(31, N_FIT), _split(32, N_VAL)
    return (DeviceLoader(x, y, batch_size, shuffle=True, seed=3, device="cpu", mesh=mesh),
            DeviceLoader(xv, yv, batch_size, device="cpu", mesh=mesh))


def _host_loader(shuffle=True):
    x, y = _split(31, N_FIT)
    return NestedLoader(BatchIterator(dict(x, labels=y), B, shuffle=shuffle, seed=3), tuple(x))


def _text_encoder(params, mesh=None):
    return TextEncoder.from_params(params, BertConfig(**BERT), device="cpu", mesh=mesh)


# -- what each rank runs --------------------------------------------------------------


def _rank_one_fails():
    mesh = parallel.get_mesh(2, devices=["cpu", "cpu"], timeout_s=60)
    if mesh.rank == 1:
        raise ValueError("rank one fails")
    parallel.barrier(mesh)       # waits for a rank that is gone


def _dynamic_weights(weights, mesh):
    """Per loader kind (device-resident and ragged, host): the statistics
    and the updated weights, each from a fresh loader."""
    out = {}
    for kind in ("device", "host"):
        trainer = _trainer(weights, mesh)
        make = (lambda: _device_loaders(mesh)[0]) if kind == "device" else _host_loader
        out[kind] = (trainer.dynamic_weight_stats(make(), 0.5),
                     trainer.update_dynamic_weights(make(), 0.5))
    return out


def _fit_checks(mesh, weights):
    """A 2-epoch fit with device-resident loaders, then the eval passes."""
    trainer = _trainer(weights, mesh, num_epochs=2, scheduler_patience=0)
    train, val = _device_loaders(mesh)
    best, history = trainer.fit(train, val, verbose=False)
    trainer.model.load_state_dict(best)
    return {"history": history, "dynamic_weights": trainer.dynamic_weights,
            "predict": trainer.predict_logits(val), "vectors": trainer.extract_vectors(val)}


def _cli_checks(mesh, tmp):
    """``cli fame --mesh 2`` inside the job (each rank joins it), artifacts
    and stdout per rank, then a resumed run against an uninterrupted one."""
    cli = importlib.import_module("fairmultimodal_torch.cli.main")

    pretrained = TextEncoder.from_pretrained.__func__
    TextEncoder.from_pretrained = classmethod(lambda cls, *a, **k: pretrained(
        cls, "x/offline", fallback_config=BertConfig(**CLI_TEXT), seed=5, device="cpu",
        mesh=k.get("mesh")))
    out = {}
    for run, epochs, ckpt in (("A", 2, "A"), ("B", 1, "B"), ("C", 2, "B")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(CLI + [
                "--epochs", str(epochs), "--out_dir", os.path.join(tmp, f"out_{run}"),
                "--checkpoint_dir", os.path.join(tmp, f"ckpt_{ckpt}")])
        out[run] = {"rc": rc, "stdout": buf.getvalue()}
    return out


def _rank_checks(weights, bert_params, tmp):
    mesh = parallel.get_mesh(2, devices=["cpu", "cpu"], timeout_s=60)
    rank = mesh.rank
    res = {"rank": rank, "world": mesh.world, "backend": mesh.backend}

    # Eval loss and logits of one global batch, with and without pad rows.
    for pad in (0, 3):
        trainer = _trainer(weights, mesh)
        loss, logits, labels = trainer.validate([_batch(5, pad=pad)])
        res[f"eval_pad{pad}"] = (loss, logits, labels)

    # The summed gradient of one step (the L1 term at two weights).
    for l1 in (0.01, 1.0):
        trainer = _trainer(weights, mesh, lambda_l1=l1)
        shard = to_device(parallel.shard_batch(_batch(6, pad=3), mesh), trainer.device)
        total, _ = trainer.backward(shard, np.full((3, 3), 0.33, np.float32))
        res[f"grads_l1_{l1}"] = (float(total), _grads(trainer))

    # Six deterministic steps over two batches, the lr decayed at step 3.
    trainer = _trainer(weights, mesh)
    losses = []
    for step in range(N_STEPS):
        if step == 3:
            trainer.set_lr(CFG["lr"] * 0.1)
        batch = to_device(parallel.shard_batch(_batch(7 + step % 2), mesh), trainer.device)
        losses.append(float(trainer.train_step(batch, np.full((3, 3), 0.33, np.float32))[0]))
    res["steps"] = (losses, _state(trainer.model))

    # Dropout on: three steps, a digest of the parameters after each; the
    # same backward twice from one generator state.
    trainer = _trainer(weights, mesh, deterministic=False)
    digests = []
    for step in range(3):
        trainer.train_step(to_device(parallel.shard_batch(_batch(8 + step), mesh), CPU))
        digests.append(_digest(trainer.model))
    state = trainer.generator.get_state()
    batch = to_device(parallel.shard_batch(_batch(11), mesh), CPU)
    twice = []
    for _ in range(2):
        trainer.generator.set_state(state)
        trainer.backward(batch)
        twice.append(_grads(trainer))
    gen = trainer._dropout_rng
    seed = trng.draw_seed(trng.RankGenerator(trng.make_generator(0), rank))
    res["dropout"] = {"digests": digests, "twice": twice, "rank_of_generator": gen.rank,
                      "seed": seed, "mask": trng.dropout_mask(seed, 0, (256,), 0.5).numpy()}

    res["dynamic_weights"] = _dynamic_weights(weights, mesh)

    res["fit"] = _fit_checks(mesh, weights)
    res["text"] = encode_note_chunks(_text_encoder(bert_params, mesh), CHUNKS, max_length=16,
                                     batch_size=3)
    res["cli"] = _cli_checks(mesh, tmp)
    return res


# -- the fixtures (the test process) ----------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """Seeded port weights carried to the JAX trees by ``interop``: the FAME
    model's (float64 on both sides, from fp32 values) and a text encoder's."""
    from fairmultimodal_torch.interop import flax_params, state_dict_from_flax
    from fairmultimodal_torch.models._layers import init_params

    tree = flax_params(init_params(TFAME(**GEO, text_embed_size=TEXT), seed=0))
    port = {k: v.double().numpy() for k, v in state_dict_from_flax(tree).items()}
    bert = flax_params(TextEncoder.from_pretrained("x/offline", fallback_config=BertConfig(**BERT),
                                                   seed=3, device="cpu").model)
    return {"tree": tree, "port": port, "bert": bert}


@pytest.fixture(scope="module")
def dp(weights, tmp_path_factory):
    """The two-rank job, started once in the background: (future of each
    rank's results in rank order, its work directory)."""
    tmp = str(tmp_path_factory.mktemp("dp"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(parallel.launch, _rank_checks, 2, (weights["port"], weights["bert"],
                                                             tmp), 240, 1), tmp


def _jax_dp():
    import jax
    import jax.numpy as jnp

    from fairmultimodal_tpu.models.fusion import FAMEModel as JFAME
    from fairmultimodal_tpu.parallel import get_mesh
    from fairmultimodal_tpu.train import loop as jloop

    mesh = get_mesh(data=2, model=1, devices=jax.devices()[:2])
    cfg = jloop.TrainConfig(rng_impl="threefry", deterministic_forward=True, **CFG)
    return jloop.FAMETrainer(JFAME(**GEO, dtype=jnp.float64), cfg, pos_weight=POS_W,
                             mesh=mesh), mesh


@pytest.fixture(scope="module")
def refs(dp, weights):
    """What the ranks are held against, computed while they run: the JAX DP
    path (eval, grads, dynamic weights, text encode) and the single-process
    port (the same and the steps and the fit)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from test_torch_train_loop import _flat_f64

    from fairmultimodal_tpu.data.device import DeviceLoader as JDeviceLoader
    from fairmultimodal_tpu.models.bert import BertConfig as JBertConfig
    from fairmultimodal_tpu.models.text import HashingTokenizer as JHashingTokenizer
    from fairmultimodal_tpu.models.text import TextEncoder as JTextEncoder
    from fairmultimodal_tpu.models.text import encode_note_chunks as j_encode
    from fairmultimodal_tpu.parallel import shard_batch as j_shard

    w = weights["port"]
    out = {"eval": {}, "grads": {}}
    dyn = np.full((3, 3), 0.33, np.float32)
    with jax.enable_x64(True):
        jt, mesh = _jax_dp()
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), weights["tree"])
        for pad in (0, 3):
            batch = _batch(5, pad=pad)
            _, bce, logits = jt._eval_step(params, j_shard(batch, mesh),
                                           jnp.asarray(jt.dynamic_weights))
            out["eval"][pad] = {"single": _trainer(w).validate([batch]), "jax_bce": float(bce),
                                "jax_logits": np.asarray(logits)[batch["weight"] > 0]}
        batch = _batch(6, pad=3)
        loss = jax.shard_map(
            lambda p, b: jt._loss_fn(p, b, jnp.asarray(dyn), jax.random.PRNGKey(0), False,
                                     "data")[0],
            mesh=mesh, in_specs=(P(), P("data")), out_specs=P())
        out["jax_grads"] = _flat_f64(jax.tree_util.tree_map(
            np.asarray, jax.jit(jax.grad(loss))(params, j_shard(batch, mesh))))
        x, y = _split(31, N_FIT)
        out["jax_dynamic_weights"] = jt.update_dynamic_weights(
            params, JDeviceLoader(x, y, B, shuffle=True, seed=3, mesh=mesh))
    j_enc = JTextEncoder(JBertConfig(**BERT), weights["bert"], JHashingTokenizer(BERT["vocab_size"]),
                         mesh=mesh)
    out["jax_text"] = j_encode(j_enc, CHUNKS, max_length=16, batch_size=3)

    for l1 in (0.01, 1.0):
        single = _trainer(w, lambda_l1=l1)
        total, _ = single.backward(to_device(batch, CPU), dyn)
        out["grads"][l1] = (float(total), _grads(single))
    single, losses = _trainer(w), []
    for step in range(N_STEPS):
        if step == 3:
            single.set_lr(CFG["lr"] * 0.1)
        losses.append(float(single.train_step(to_device(_batch(7 + step % 2), CPU), dyn)[0]))
    out["steps"] = (losses, _state(single.model))
    out["dynamic_weights"] = _dynamic_weights(w, None)
    out["fit"] = _fit_checks(None, w)
    out["text"] = encode_note_chunks(_text_encoder(weights["bert"]), CHUNKS, max_length=16,
                                     batch_size=3)
    return out


@pytest.fixture(scope="module")
def ranks(dp, refs):
    """Each rank's results (the references computed first, while they ran)."""
    return dp[0].result()


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# -- mode selection and errors ----------------------------------------------------------


def test_mesh_errors():
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        parallel.get_mesh(2, devices=["cpu"])
    with pytest.raises(ValueError, match="mesh 2x2 needs 4 ranks; this job has 1"):
        parallel.get_mesh(2, 2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="NCCL needs one device per rank"):
        parallel.get_mesh(2, devices=["cpu", "cpu"], backend="nccl")
    with pytest.raises(ValueError, match="expected 'N' or 'NxM'"):
        parallel.parse_mesh("2x")
    assert parallel.parse_mesh("4") == (4, 1) and parallel.parse_mesh("2X1") == (2, 1)
    mesh = parallel.Mesh(data=2, model=1, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="batch_size 7 must be divisible by the mesh's data"):
        tloop.FAMETrainer(TFAME(**GEO, text_embed_size=TEXT), tloop.TrainConfig(batch_size=7),
                          POS_W, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="does not split over"):
        parallel.shard_batch({"x": np.zeros(3)}, mesh)


def test_get_mesh_without_cuda_raises_unless_the_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.get_mesh(1)
    mesh = parallel.get_mesh(1, devices=["cpu"])
    try:
        assert (mesh.rank, mesh.world, mesh.backend, mesh.device.type) == (0, 1, "gloo", "cpu")
        assert parallel.gather_rows(torch.arange(3.0), mesh).tolist() == [0.0, 1.0, 2.0]
    finally:
        mesh.close()
    assert not torch.distributed.is_initialized()


def test_cli_mesh_modes(monkeypatch):
    """--mesh on another pipeline exits; a one-card machine refuses 2 ranks
    before spawning any; --device cpu spawns one rank per mesh entry (data x
    model of them for a model axis)."""
    cli = importlib.import_module("fairmultimodal_torch.cli.main")

    with pytest.raises(SystemExit, match="--mesh is supported for fame/fpm only"):
        cli.main(["behrt", "--mesh", "2", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    calls = []
    monkeypatch.setattr(parallel, "launch", lambda fn, world, args, threads: calls.append(
        (fn, world, args[0].mesh, threads)) or [0] * world)
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        cli.main(["fame", "--mesh", "2"])
    assert cli.main(["fame", "--mesh", "3", "--device", "cpu"]) == 0
    assert cli.main(["fpm", "--mesh", "2x2", "--device", "cpu"]) == 0
    assert [(c[0], c[1], c[2]) for c in calls] == [(cli.run_pipeline, 3, "3"),
                                                   (cli.run_pipeline, 4, "2x2")]


def test_a_failing_rank_fails_the_launch_without_a_hang():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank one fails"):
        parallel.launch(_rank_one_fails, 2, threads=1, timeout_s=120)
    assert time.perf_counter() - t0 < 45


def test_prefetch_refuses_a_loader_parked_without_the_mesh():
    x, y = _split(1, 8)
    mesh = parallel.Mesh(data=2, model=1, rank=1, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="built without the trainer's mesh"):
        next(iter(PrefetchLoader(DeviceLoader(x, y, 4, device="cpu"), "cpu", mesh=mesh)))
    with pytest.raises(ValueError, match="built without the trainer's mesh"):
        next(iter(PrefetchLoader(DeviceLoader(x, y, 4, device="cpu", mesh=mesh), "cpu")))
    # Rank 1's columns of each [B] index; a host batch cut the same way.
    sharded = list(DeviceLoader(x, y, 4, device="cpu", mesh=mesh))
    whole = list(DeviceLoader(x, y, 4, device="cpu"))
    host = list(PrefetchLoader(NestedLoader(BatchIterator(dict(x, labels=y), 4), tuple(x)),
                               "cpu", mesh=mesh))
    for s, w, h in zip(sharded, whole, host):
        assert torch.equal(s["labels"], w["labels"][2:]) and torch.equal(s["weight"],
                                                                         w["weight"][2:])
        assert torch.equal(h["model_inputs"]["lab_features"], s["model_inputs"]["lab_features"])


def test_rank_fold_keeps_rank_zero_and_moves_the_key():
    g = trng.make_generator(9)
    base = trng.draw_seed(trng.make_generator(9))
    assert trng.draw_seed(trng.RankGenerator(g, 0)) == base
    assert trng.draw_seed(trng.RankGenerator(trng.make_generator(9), 3)) == base | (3 << 32)
    m0, m1 = (trng.dropout_mask(trng.fold_in(base, r), 1, (64,), 0.5) for r in (0, 1))
    assert torch.equal(m0, trng.dropout_mask(base, 1, (64,), 0.5)) and not torch.equal(m0, m1)


# -- the two ranks ----------------------------------------------------------------------


def test_the_job_is_two_gloo_ranks(ranks):
    assert [(r["rank"], r["world"], r["backend"]) for r in ranks] == [(0, 2, "gloo"),
                                                                      (1, 2, "gloo")]


@pytest.mark.parametrize("pad", [0, 3])
def test_dp_eval_matches_single_device_and_jax(ranks, refs, pad):
    want = refs["eval"][pad]
    keep = _batch(5, pad=pad)["weight"] > 0
    for r in ranks:
        loss, logits, labels = r[f"eval_pad{pad}"]
        assert loss == pytest.approx(want["single"][0], rel=LOSS_REL)
        assert loss == pytest.approx(want["jax_bce"], rel=LOSS_REL)
        _close(logits, want["single"][1])
        _close(logits, want["jax_logits"])
        assert np.array_equal(labels, _batch(5, pad=pad)["labels"][keep])


@pytest.mark.parametrize("l1", [0.01, 1.0])
def test_dp_grads_match_single_device(ranks, refs, l1):
    """The summed gradient is the global one: a term counted once per rank
    (the L1 term entering every rank's gradient, or cotangent seeds summed
    by an all-reduce in the backward) doubles its share and fails here.
    The default weight is also held against the JAX DP path's gradient."""
    total, want = refs["grads"][l1]
    for r in ranks:
        got_total, got = r[f"grads_l1_{l1}"]
        assert got_total == pytest.approx(total, rel=LOSS_REL)
        assert set(got) == set(want)
        for name in want:
            _close(got[name], want[name])
            if l1 == CFG["lambda_l1"]:
                _close(got[name], refs["jax_grads"][name])
    # The L1 term's share of sig_weights' gradient is far above the limit.
    share = refs["grads"][1.0][1]["fusion.sig_weights"] - refs["grads"][0.01][1][
        "fusion.sig_weights"]
    assert np.abs(share).min() > 0.9


def test_dp_steps_match_single_device_and_stay_replicated(ranks, refs):
    (l0, s0), (l1, s1) = ranks[0]["steps"], ranks[1]["steps"]
    assert l0 == l1 and all(np.array_equal(s0[k], s1[k]) for k in s0)
    losses, state = refs["steps"]
    assert l0 == pytest.approx(losses, rel=LOSS_REL)
    for name, v in state.items():
        _close(s0[name], v)


def test_dp_dropout_steps_stay_bit_identical_across_ranks_with_rank_masks(ranks):
    d0, d1 = ranks[0]["dropout"], ranks[1]["dropout"]
    assert d0["digests"] == d1["digests"] and len(set(d0["digests"])) == 3
    for d in (d0, d1):
        a, b = d["twice"]
        assert all(np.array_equal(a[k], b[k]) for k in a)
    assert (d0["rank_of_generator"], d1["rank_of_generator"]) == (0, 1)
    assert d0["seed"] == trng.draw_seed(trng.make_generator(0)) == d1["seed"] & 0xFFFFFFFF
    assert not np.array_equal(d0["mask"], d1["mask"])


@pytest.mark.parametrize("kind", ["device", "host"])
def test_dp_dynamic_weight_statistics_bit_identical(ranks, refs, kind):
    stats, weights = refs["dynamic_weights"][kind]
    assert stats.sum() > 0
    for r in ranks:
        np.testing.assert_array_equal(r["dynamic_weights"][kind][0], stats)
        np.testing.assert_array_equal(r["dynamic_weights"][kind][1], weights)
    np.testing.assert_allclose(weights, refs["jax_dynamic_weights"], atol=1e-8, rtol=0)


def test_dp_fit_with_device_loader_matches_single_device(ranks, refs):
    want = refs["fit"]
    for r in ranks:
        got = r["fit"]
        assert len(got["history"]) == 2
        for a, b in zip(got["history"], want["history"]):
            for k in ("train_loss", "train_bce", "val_loss", "lr"):
                assert a[k] == pytest.approx(b[k], rel=LOSS_REL), k
        np.testing.assert_allclose(got["dynamic_weights"], want["dynamic_weights"], atol=1e-12)
        assert got["predict"]["logits"].shape == (N_VAL, 3)
        assert got["vectors"]["gated_vectors"].shape[0] == N_VAL
        for part in ("predict", "vectors"):
            for k, v in want[part].items():
                assert got[part][k].shape == v.shape, (part, k)
                _close(got[part][k], v)


def test_dp_text_encode_matches_single_device_and_jax(ranks, refs):
    """Odd batch size (rounded up to 4 with a pad row) and note-less patients."""
    for r in ranks:
        got = r["text"]
        assert got.shape == (len(CHUNKS), BERT["hidden_size"])
        np.testing.assert_allclose(got, refs["text"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, refs["jax_text"], rtol=1e-5, atol=1e-6)
        assert not got[[1, 5]].any() and np.abs(got[[0, 2, 3, 4, 6]]).sum(axis=1).all()


def _same(a, b, path="state"):
    """Bit-identical nested checkpoint states."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def test_cli_fame_mesh_2_writes_its_artifacts_once_and_resumes_bit_identically(ranks, dp):
    tmp = dp[1]
    r0, r1 = ranks[0]["cli"], ranks[1]["cli"]
    assert all(r[k]["rc"] == 0 for r in (r0, r1) for k in "ABC")
    assert "AUROC" in r0["A"]["stdout"]
    assert "Resumed from checkpoint at epoch 1." in r0["C"]["stdout"]
    assert not any(r1[k]["stdout"].strip() for k in "ABC")
    for run in "AB":
        out = os.path.join(tmp, f"out_{run}")
        names = sorted(os.listdir(out))
        assert len(glob.glob(os.path.join(out, "best_model_*.npz"))) == 1, names
        assert len(glob.glob(os.path.join(out, "extracted_vectors_*.npz"))) == 1, names
        assert {"dynamic_weights_per_epoch1.csv", "tracked_dynamic_weights.npy",
                "tracked_sigmoid_weights.npy"} <= set(names)
    assert sorted(os.listdir(os.path.join(tmp, "ckpt_A"))) == ["step_1.pt", "step_2.pt"]
    a, b = (torch.load(os.path.join(tmp, f"ckpt_{c}", "step_2.pt"), weights_only=True)
            for c in "AB")
    _same(a, b)
