"""Tensor-parallel FAME training (``parallel.shard_params_tp``,
``DEFAULT_TP_RULES``, ``--mesh DxM``) on a 2 x 2 gloo mesh on the CPU (four
ranks), against the JAX package's mixed-mesh path (``get_mesh(data=2,
model=2)`` over conftest's virtual devices) and the single-process port.

As in ``tests/test_torch_parallel.py``, the four-rank job starts once, in
the module fixture :func:`tp`, in the background, and runs every rank-side
check (:func:`_rank_checks`); a two-rank job runs ``fame --mesh 1x2``
beside it (:func:`_cli_1x2`); the references are computed while they run,
and the tests assert on what each rank returned.  Rank processes are
spawned, so this module imports no ``jax`` at its top.

The checks:
- the JAX package's four (``tests/test_parallel.py:70-153``) at its tiny
  model: the eval loss of sharded parameters equal to one process's at
  rtol 2e-5, a train step that updates the sharded parameters, the specs,
  a 2-epoch ``fit`` with validation and dynamic-weight updates;
- the spec of every leaf against JAX's ``shard_params_tp`` at model 2 and 4,
  and at model 3, where JAX drops the lab FFN's rules (2048 % 3) as the port
  does, and splits a head (2 heads over 3), which the port replicates;
- six float64 steps of the 2 x 2 trainer against one process and the JAX
  2 x 2 trainer at the trainer's tolerances (loss 1e-8 relative, parameters
  1e-9 + 1e-6 relative), the clip engaged;
- dropout: replicated parameters bit-identical on all four ranks after
  three dropout steps, shards equal across the data group and different
  across the model group, the backward bit-identical twice, the sharded FFN
  site's seed folded with the model index and the other sites' not;
- ``fame --mesh 2x2 --device cpu`` and ``--mesh 1x2`` (the port shards, the
  JAX command line replicates) against JAX's ``--mesh 2x2``: splits exact,
  losses 1e-5 relative, logits 1e-4; each rank holds 1 / M of each sharded
  leaf; the npz holds full leaves that ``predict`` reads.
"""

import concurrent.futures
import contextlib
import glob
import hashlib
import importlib
import io
import os

import numpy as np
import pytest
import torch

from fairmultimodal_torch import parallel
from fairmultimodal_torch.data.prefetch import to_device
from fairmultimodal_torch.models.fusion import FAMEModel as TFAME
from fairmultimodal_torch.train import loop as tloop
from fairmultimodal_torch.utils import rng as trng

H, NH, LABS, TEXT, B = 32, 4, 20, 12, 8
GEO = dict(num_ages=4, num_genders=2, num_ethnicities=5, num_insurances=6, lab_token_count=LABS,
           hidden_size=H, demo_layers=1, demo_heads=NH, lab_layers=1, lab_heads=NH)
# tests/test_parallel.py's _tiny_model.
TINY = dict(num_ages=4, num_genders=2, num_ethnicities=5, num_insurances=6, lab_token_count=8,
            text_embed_size=16, hidden_size=16, demo_layers=1, demo_heads=2, lab_layers=1,
            lab_heads=2, fusion_hidden=8)
POS_W = np.array([2.0, 0.5, 3.0], np.float32)
CFG = dict(lr=1e-3, weight_decay=0.01, grad_clip=1.0, lambda_edd=0.8, lambda_l1=0.01,
           batch_size=B)
CLI_TEXT = dict(vocab_size=512, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=64, max_position_embeddings=64)
CLI = ["fame", "--synthetic", "64", "--tiny", "--epochs", "1", "--bsz", "16"]
LOSS_REL, ATOL, RTOL = 1e-8, 1e-9, 1e-6
N_STEPS = 6
CPU = torch.device("cpu")


def _inputs(rng, n, labs=LABS, text=TEXT):
    return {
        "demo_dummy_ids": np.ones((n, 1), np.int32),
        "demo_attn_mask": np.ones((n, 1), np.int32),
        "age_ids": rng.integers(0, 4, n).astype(np.int32),
        "gender_ids": rng.integers(0, 2, n).astype(np.int32),
        "ethnicity_ids": rng.integers(0, 5, n).astype(np.int32),
        "insurance_ids": rng.integers(0, 6, n).astype(np.int32),
        "lab_features": rng.normal(0, 1, (n, labs)),
        "text_embedding": rng.normal(0, 1, (n, text)),
    }


def _batch(seed, n=B):
    rng = np.random.default_rng(seed)
    return {"model_inputs": _inputs(rng, n), "weight": np.ones(n),
            "labels": rng.integers(0, 2, (n, 3)).astype(np.float64)}


def _tiny_batch(n, seed=0):
    """tests/test_parallel.py's ``_batch`` (float32, numpy only)."""
    rng = np.random.default_rng(seed)
    return {
        "model_inputs": {
            "demo_dummy_ids": np.zeros((n, 1), np.int32),
            "demo_attn_mask": np.ones((n, 1), np.int32),
            "age_ids": rng.integers(0, 4, n).astype(np.int32),
            "gender_ids": rng.integers(0, 2, n).astype(np.int32),
            "ethnicity_ids": rng.integers(0, 5, n).astype(np.int32),
            "insurance_ids": rng.integers(0, 6, n).astype(np.int32),
            "lab_features": rng.normal(0, 1, (n, 8)).astype(np.float32),
            "text_embedding": rng.normal(0, 1, (n, 16)).astype(np.float32),
        },
        "labels": rng.integers(0, 2, (n, 3)).astype(np.float32),
        "weight": np.ones(n, np.float32),
    }


def _model(weights, geo=GEO, text=TEXT, dtype=torch.float64):
    m = TFAME(**{"text_embed_size": text, **geo}, dtype=dtype).to(dtype)
    m.load_state_dict({k: torch.from_numpy(np.array(v)).to(dtype) for k, v in weights.items()})
    return m


def _trainer(weights, mesh=None, deterministic=True, geo=GEO, dtype=torch.float64,
             pos_weight=POS_W, **cfg):
    model = _model(weights, geo, dtype=dtype)
    if mesh is not None and mesh.model > 1:
        parallel.shard_params_tp(model, mesh)
    return tloop.FAMETrainer(
        model, tloop.TrainConfig(deterministic_forward=deterministic, **{**CFG, **cfg}),
        pos_weight=pos_weight, device="cpu", mesh=mesh)


def _tiny_trainer(tiny, mesh=None, **cfg):
    """tests/test_parallel.py's trainer: fp32, pos_weight 1."""
    return _trainer(tiny, mesh, geo=TINY, dtype=torch.float32, pos_weight=np.ones(3), **cfg)


def _full(trainer):
    return {k: v.numpy().copy() for k, v in parallel.full_state_dict(trainer.model).items()}


def _digest(tensors):
    h = hashlib.blake2b(digest_size=16)
    for t in tensors:
        h.update(t.detach().numpy().tobytes())
    return h.hexdigest()


def _shard(batch, mesh):
    return to_device(parallel.shard_batch(batch, mesh), CPU)


# -- what each rank runs --------------------------------------------------------------


def _jax_checks(tiny, mesh):
    """tests/test_parallel.py's four checks, at its tiny model in fp32."""
    out = {}
    trainer = _tiny_trainer(tiny, mesh, lr=1e-3)
    out["eval_loss"] = trainer.validate([_tiny_batch(8)])[0]
    trainer = _tiny_trainer(tiny, mesh, lr=1e-2)
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    total, _ = trainer.train_step(_shard(_tiny_batch(8, seed=1), mesh))
    out["step"] = {"total": float(total), "changed": sorted(
        n for n, p in trainer.model.named_parameters() if not torch.equal(p, before[n]))}
    trainer = _tiny_trainer(tiny, mesh, lr=1e-3, num_epochs=2)
    loader = [_tiny_batch(8, seed=1), _tiny_batch(8, seed=2)]
    _, history = trainer.fit(loader, loader, verbose=False)
    out["fit"] = {"history": history, "dynamic_weights": trainer.dynamic_weights}
    return out


def _layer_checks(mesh):
    """A sharded ``TorchEncoderLayer`` (separate q / k / v and fused ``qkv``)
    against the whole layer in fp32 (the kernels' dtype), dropout off: the
    flash wrapper and ``fused_ffn`` (their plain versions here) on this
    rank's heads and columns, the zero ``b2`` and the bias after the
    reduction.  The output's and the input gradient's error over their
    max-abs, and the worst gathered parameter gradient's over its own."""
    from fairmultimodal_torch.models._layers import init_params
    from fairmultimodal_torch.models.behrt import TorchEncoderLayer
    from fairmultimodal_torch.ops import attention

    gate = attention.can_use_flash_attention
    attention.can_use_flash_attention = lambda q: True
    out = {}
    try:
        for fused in (False, True):
            g = torch.Generator().manual_seed(3)
            x = torch.randn(2, 16, H, generator=g)
            cot = torch.randn(2, 16, H, generator=g)
            mask = torch.ones(2, 16, dtype=torch.int32)
            mask[1, 11:] = 0
            runs = []
            for sharded in (False, True):
                layer = init_params(TorchEncoderLayer(H, NH, fused_qkv=fused, attn_kernel=False,
                                                      ffn_kernel=True), seed=4)
                if sharded:
                    parallel.shard_params_tp(layer, mesh)
                xi = x.clone().requires_grad_(True)
                y = layer(xi, mask)
                (y * cot).sum().backward()
                grads = {n: p.grad for n, p in layer.named_parameters()}
                runs.append((y.detach(), xi.grad, parallel.full_state_dict(layer, grads)))
            (y0, dx0, g0), (y1, dx1, g1) = runs
            rel = lambda a, b, s=None: float((a - b).abs().max() / (s or b.abs().max()))  # noqa

            def scale(name):
                # The key bias's grad is zero in exact arithmetic (the softmax
                # ignores it): its rounding noise is measured on q / k / v's.
                if name.endswith("key.bias"):
                    return max(float(g0[f"{t}.bias"].abs().max()) for t in ("query", "value"))
                return None

            out[fused] = {"y": rel(y1, y0), "dx": rel(dx1, dx0),
                          "grads": max(rel(g1[n], g0[n], scale(n)) for n in g0),
                          "sharded": len(parallel.tp_plan(layer))}
    finally:
        attention.can_use_flash_attention = gate
    return out


def _resume_checks(tiny, mesh, tmp):
    """A 2-epoch fit with a checkpointer, and a 1-epoch fit resumed to 2."""
    from fairmultimodal_torch.utils.checkpoint import Checkpointer

    loader = [_tiny_batch(8, seed=1), _tiny_batch(8, seed=2)]
    for run, epochs in (("A", 2), ("B", 1), ("B", 2)):
        trainer = _tiny_trainer(tiny, mesh, lr=1e-3, num_epochs=epochs)
        trainer.fit(loader, loader, verbose=False,
                    checkpointer=Checkpointer(os.path.join(tmp, f"ckpt_{run}"), mesh=mesh))


def _dropout_checks(weights, mesh):
    """Three dropout steps; the seeds each lab-layer site draws in the first."""
    from fairmultimodal_torch.models import behrt

    drawn = []
    draw = behrt.dropout_seed

    def recording(module, rate, generator, sharded=False):
        seed = draw(module, rate, generator, sharded)
        drawn.append((sharded, seed))
        return seed

    behrt.dropout_seed = recording
    try:
        trainer = _trainer(weights, mesh, deterministic=False)
        plan = parallel.tp_plan(trainer.model)
        named = dict(trainer.model.named_parameters())
        digests = []
        for step in range(3):
            trainer.train_step(_shard(_batch(8 + step), mesh))
            digests.append((_digest([p for n, p in named.items() if n not in plan]),
                            _digest([named[n] for n in plan])))
            if step == 0:
                seeds = list(drawn)
    finally:
        behrt.dropout_seed = draw
    state, batch = trainer.generator.get_state(), _shard(_batch(11), mesh)
    twice = []
    for _ in range(2):
        trainer.generator.set_state(state)
        trainer.backward(batch)
        twice.append(_digest([p.grad for p in trainer.model.parameters() if p.grad is not None]))
    return {"digests": digests, "seeds": seeds, "twice": twice}


def _patch_cli(inits, encoder_params):
    """The port's command line with the JAX run's initial weights and the
    tiny text encoder, its train forward without dropout."""
    from fairmultimodal_torch.interop import load_flax_params
    from fairmultimodal_torch.models import text as t_text
    from fairmultimodal_torch.models.bert import BertConfig
    from fairmultimodal_torch.pipelines import fame as t_fame

    outs, queue = [], list(inits)
    enc = lambda mesh: t_text.TextEncoder.from_params(   # noqa: E731
        encoder_params, BertConfig(**CLI_TEXT), device="cpu", mesh=mesh)
    t_text.TextEncoder.from_pretrained = classmethod(lambda cls, *a, **k: enc(k.get("mesh")))
    t_fame.init_params = lambda model, seed: load_flax_params(model, queue.pop(0))
    run = t_fame.run_fame_experiment

    def deterministic(s, u, cfg, *args, **kwargs):
        cfg.train.deterministic_forward = True
        out = run(s, u, cfg, *args, **kwargs)
        outs.append(out)
        return out

    t_fame.run_fame_experiment = deterministic
    return outs


def _cli_run(mesh, inits, encoder_params, out_dir, spec):
    cli = importlib.import_module("fairmultimodal_torch.cli.main")
    outs = _patch_cli(inits, encoder_params)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(CLI + ["--device", "cpu", "--mesh", spec, "--out_dir", out_dir])
    out = outs[0]
    trainer = out["trainer"]
    return {"rc": rc, "stdout": buf.getvalue(),
            "splits": {k: np.asarray(v) for k, v in out["splits"].items()},
            "history": out["history"], "metrics": out["metrics"],
            "thresholds": out["thresholds"],
            "local_shapes": {n: tuple(p.shape) for n, p in trainer.model.named_parameters()},
            "plan": dict(parallel.tp_plan(trainer.model)),
            "best_shapes": {k: tuple(v.shape) for k, v in out["best_params"].items()},
            "artifacts": out["artifacts"]}


def _cli_1x2(inits, encoder_params, out_dir):
    mesh = parallel.get_mesh(1, 2, devices=["cpu"] * 2, timeout_s=60)
    return _cli_run(mesh, inits, encoder_params, out_dir, "1x2")


def _rank_checks(weights, tiny, inits, encoder_params, tmp):
    mesh = parallel.get_mesh(2, 2, devices=["cpu"] * 4, timeout_s=60)
    res = {"rank": mesh.rank, "index": (mesh.data_index, mesh.model_index),
           "world": mesh.world, "backend": mesh.backend}
    res["jax_checks"] = _jax_checks(tiny, mesh)
    res["layer"] = _layer_checks(mesh)
    _resume_checks(tiny, mesh, tmp)

    # Six deterministic float64 steps over two batches, the lr decayed at step 3.
    trainer = _trainer(weights, mesh)
    losses = []
    for step in range(N_STEPS):
        if step == 3:
            trainer.set_lr(CFG["lr"] * 0.1)
        losses.append(float(trainer.train_step(_shard(_batch(7 + step % 2), mesh),
                                               np.full((3, 3), 0.33, np.float32))[0]))
    res["steps"] = (losses, _full(trainer))
    res["dropout"] = _dropout_checks(weights, mesh)
    res["cli"] = _cli_run(mesh, inits, encoder_params, os.path.join(tmp, "cli_2x2"), "2x2")
    return res


# -- the fixtures (the test process) ----------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """Seeded port weights (the trajectory model's and the JAX tiny model's),
    carried to the JAX trees by ``interop``."""
    from fairmultimodal_torch.interop import flax_params, state_dict_from_flax
    from fairmultimodal_torch.models._layers import init_params

    tree = flax_params(init_params(TFAME(**GEO, text_embed_size=TEXT), seed=0))
    tiny_tree = flax_params(init_params(TFAME(**TINY), seed=1))
    return {"tree": tree, "port": {k: v.double().numpy()
                                   for k, v in state_dict_from_flax(tree).items()},
            "tiny_tree": tiny_tree, "tiny": {k: v.numpy() for k, v in
                                             state_dict_from_flax(tiny_tree).items()}}


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    """JAX's ``fame --mesh 2x2`` (replicas on its model axis), its initial
    weights and the tiny text encoder's parameters."""
    import jax
    import jax.numpy as jnp
    from test_torch_cli import _run_jax

    from fairmultimodal_tpu.models import bert as j_bert
    from fairmultimodal_tpu.models import text as j_text

    cfg = j_bert.BertConfig(**CLI_TEXT)
    params = jax.jit(j_bert.BertEncoderModel(cfg).init)(
        jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params["params"]))
    encoders = (j_text.TextEncoder(cfg, params, j_text.HashingTokenizer(cfg.vocab_size)), None)
    out_dir = tmp_path_factory.mktemp("jax_cli")
    mp = pytest.MonkeyPatch()
    stdout, outs, inits = _run_jax(CLI + ["--mesh", "2x2", "--out_dir", str(out_dir)],
                                   encoders, mp)
    return {"stdout": stdout, "out": outs[0], "inits": inits, "encoder": params}


@pytest.fixture(scope="module")
def tp(weights, jax_cli, tmp_path_factory):
    """The four-rank job and the two-rank ``--mesh 1x2`` job, started once in
    the background: (futures of each job's results in rank order, the work
    directory)."""
    tmp = str(tmp_path_factory.mktemp("tp"))
    inits, enc = jax_cli["inits"], jax_cli["encoder"]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        yield (pool.submit(parallel.launch, _rank_checks, 4,
                           (weights["port"], weights["tiny"], inits, enc, tmp), 300, 1),
               pool.submit(parallel.launch, _cli_1x2, 2,
                           (inits, enc, os.path.join(tmp, "cli_1x2")), 300, 1)), tmp


def _jax_2x2_steps(tree, batches, lr):
    """The JAX trainer on a 2 x 2 mesh: six float64 steps from ``tree``."""
    import jax
    import jax.numpy as jnp
    from test_torch_train_loop import _flat_f64

    from fairmultimodal_tpu.models.fusion import FAMEModel as JFAME
    from fairmultimodal_tpu.parallel import get_mesh, replicate, shard_batch, shard_params_tp
    from fairmultimodal_tpu.train import loop as jloop

    mesh = get_mesh(data=2, model=2, devices=jax.devices()[:4])
    cfg = jloop.TrainConfig(rng_impl="threefry", deterministic_forward=True, **CFG)
    jt = jloop.FAMETrainer(JFAME(**GEO, dtype=jnp.float64), cfg, pos_weight=POS_W, mesh=mesh)
    params = shard_params_tp(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                                    tree), mesh)
    opt_state = replicate(jt.init_opt_state(params), mesh)
    dyn = replicate(jnp.full((3, 3), 0.33, jnp.float32), mesh)
    key = jax.random.key(0, impl="threefry2x32")
    losses = []
    for step, b in enumerate(batches):
        if step == 3:
            opt_state = jt.set_lr(opt_state, lr * 0.1)
        params, opt_state, total, _ = jt._train_step(params, opt_state, shard_batch(b, mesh),
                                                     dyn, key)
        losses.append(float(total))
    return losses, _flat_f64(jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def refs(tp, weights):
    """What the ranks are held against, computed while they run: one
    process's port and the JAX package."""
    import jax
    import jax.numpy as jnp

    from fairmultimodal_tpu.models.fusion import FAMEModel as JFAME
    from fairmultimodal_tpu.parallel import get_mesh, shard_batch, shard_params_tp
    from fairmultimodal_tpu.train import loop as jloop

    out = {}
    tiny = weights["tiny"]
    out["tiny_eval_loss"] = _tiny_trainer(tiny).validate([_tiny_batch(8)])[0]
    jt = jloop.FAMETrainer(JFAME(**TINY), jloop.TrainConfig(lr=1e-3, batch_size=8),
                           np.ones(3, np.float32), rngs_seed=0)
    jb = jax.tree_util.tree_map(jnp.asarray, _tiny_batch(8))
    dyn = jnp.asarray(jt.dynamic_weights)
    tree = jax.tree_util.tree_map(jnp.asarray, weights["tiny_tree"])
    out["jax_tiny_eval"] = float(jt._eval_step(tree, jb, dyn)[1])
    mesh = get_mesh(data=2, model=2, devices=jax.devices()[:4])
    out["jax_tiny_eval_sharded"] = float(jloop.FAMETrainer(
        JFAME(**TINY), jloop.TrainConfig(lr=1e-3, batch_size=8), np.ones(3, np.float32),
        rngs_seed=0, mesh=mesh)._eval_step(shard_params_tp(tree, mesh),
                                           shard_batch(_tiny_batch(8), mesh), dyn)[1])

    # One process: six steps (train_step's arithmetic), each step's global
    # gradient norm before its clip.
    single, losses, norms = _trainer(weights["port"]), [], []
    for step in range(N_STEPS):
        if step == 3:
            single.set_lr(CFG["lr"] * 0.1)
        total, _ = single.backward(to_device(_batch(7 + step % 2), CPU),
                                   np.full((3, 3), 0.33, np.float32))
        losses.append(float(total))
        norms.append(float(torch.nn.utils.clip_grad_norm_(single.model.parameters(),
                                                          CFG["grad_clip"])))
        single.optimizer.step()
    out["steps"] = (losses, {k: v.numpy() for k, v in single.model.state_dict().items()},
                    norms)
    with jax.enable_x64(True):
        out["jax_steps"] = _jax_2x2_steps(weights["tree"], [_batch(7 + s % 2)
                                                            for s in range(N_STEPS)], CFG["lr"])
    return out


@pytest.fixture(scope="module")
def ranks(tp, refs):
    return tp[0][0].result()


@pytest.fixture(scope="module")
def ranks_1x2(tp, refs):
    return tp[0][1].result()


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# -- the specs (no ranks) ---------------------------------------------------------------


def _jax_specs(geo, model):
    import jax
    import jax.numpy as jnp

    from fairmultimodal_tpu.models.fusion import FAMEModel as JFAME
    from fairmultimodal_tpu.parallel import get_mesh, shard_params_tp

    batch = jax.tree_util.tree_map(jnp.asarray, _tiny_batch(4)["model_inputs"])
    batch["lab_features"] = jnp.zeros((4, geo["lab_token_count"]), jnp.float32)
    batch["text_embedding"] = jnp.zeros((4, geo["text_embed_size"]), jnp.float32)
    params = JFAME(**geo).init(jax.random.PRNGKey(0), batch)["params"]
    sharded = shard_params_tp(params, get_mesh(data=1, model=model,
                                               devices=jax.devices()[:model]))
    return {"/".join(getattr(k, "key", str(k)) for k in path): tuple(leaf.sharding.spec)
            for path, leaf in jax.tree_util.tree_flatten_with_path(sharded)[0]}


def _port_specs(geo, model):
    from fairmultimodal_torch.models._layers import init_params

    m = init_params(TFAME(**geo), seed=0)
    full = {n: p.detach().clone() for n, p in m.named_parameters()}
    meshes = [parallel.Mesh(data=1, model=model, rank=r, device=CPU) for r in range(model)]
    specs = parallel.shard_params_tp(m, meshes[0])
    return specs, m, full, meshes


@pytest.mark.parametrize("model,heads", [(2, 2), (4, 4)])
def test_specs_equal_jax_leaf_by_leaf(model, heads):
    geo = dict(TINY, demo_heads=heads, lab_heads=heads)
    specs, m, full, _ = _port_specs(geo, model)
    want = _jax_specs(geo, model)
    assert specs == want
    assert sum(map(bool, specs.values())) == 20
    q = specs["behrt_demo/bert/layer_0/attention/query/kernel"]
    assert q == (None, "model")
    assert specs["behrt_demo/bert/layer_0/attention/output_dense/kernel"] == ("model", None)
    # This rank's slice of each sharded leaf: 1 / model of its full size.
    plan = parallel.tp_plan(m)
    for name, p in m.named_parameters():
        assert p.numel() * (model if name in plan else 1) == full[name].numel(), name


def test_a_dropped_rule_and_a_split_head():
    """Model 3 at hidden 24: JAX drops the lab FFN's rules (2048 % 3) and the
    port replicates it too; 24 % 3 lets JAX split q / k / v / attn_out through
    a head (2 heads over 3), which the port replicates; the demo BERT's FFN
    (3072) is sharded by both."""
    geo = dict(TINY, hidden_size=24, text_embed_size=24)
    specs, m, _, _ = _port_specs(geo, 3)
    want = _jax_specs(geo, 3)
    attention = [k for k in want if k.split("/")[-2] in ("query", "key", "value", "attn_out",
                                                         "output_dense")]
    split = [k for k in attention if want[k]]
    assert len(attention) == 16 and len(split) == 14 and all(
        k.endswith("bias") and k.split("/")[-2] in ("attn_out", "output_dense")
        for k in set(attention) - set(split))
    assert all(specs[k] == () for k in attention)
    assert {k: v for k, v in specs.items() if k not in attention} == \
        {k: v for k, v in want.items() if k not in attention}
    for half in ("ffn_in/kernel", "ffn_in/bias", "ffn_out/kernel"):
        assert want[f"behrt_lab/layer_0/{half}"] == () == specs[f"behrt_lab/layer_0/{half}"]
    assert specs["behrt_demo/bert/layer_0/intermediate/kernel"] == (None, "model")
    assert m.behrt_demo.bert.layer_0.tp is not None and m.behrt_lab.layer_0.attn_tp is None
    assert m.behrt_demo.bert.layer_0.attention.tp is None and m.behrt_lab.layer_0.ffn_tp is None


def test_sharding_slices_and_state_round_trips():
    """Each rank's slices of a fused ``qkv`` hold its own heads of q, k and v;
    the slices of every rank join back to the full tensor, and a sharded layer
    refuses the LayerNorm-fused path."""
    from fairmultimodal_torch.models.behrt import TorchEncoderLayer

    full = TorchEncoderLayer(16, 4, ffn_size=32, fused_qkv=True)
    state = {k: v.clone() for k, v in full.state_dict().items()}
    parts = []
    for r in range(2):
        layer = TorchEncoderLayer(16, 4, ffn_size=32, fused_qkv=True)
        layer.load_state_dict(state)
        specs = parallel.shard_params_tp(layer, parallel.Mesh(1, 2, r, CPU))
        assert specs["qkv/kernel"] == (None, "model") and specs["attn_out/bias"] == ()
        assert (layer.attn_kernel, layer.fold_ln) == (False, False)
        q, k, v = state["qkv.weight"].view(3, 4, 4, 16).unbind(0)
        want = torch.cat([t[2 * r:2 * r + 2].reshape(8, 16) for t in (q, k, v)])
        assert torch.equal(layer.qkv.weight, want)
        assert layer.ffn_out.weight.shape == (16, 16) and layer.ffn_out.bias.shape == (16,)
        parts.append(parallel.shard_state_dict(layer, state))
        assert all(torch.equal(parts[-1][n], p) for n, p in layer.named_parameters())
    plan = parallel.tp_plan(layer)
    for name, kind in plan.items():
        assert torch.equal(parallel.sharding._join([p[name] for p in parts], kind), state[name])
    layer.fold_ln = None
    with pytest.raises(ValueError, match="fold_ln=False"):
        layer(torch.zeros(1, 4, 16))


def test_rules_that_split_no_megatron_pair_raise():
    model = TFAME(**TINY)
    with pytest.raises(ValueError, match="no half-layer of the port splits"):
        parallel.shard_params_tp(model, parallel.Mesh(1, 2, 0, CPU),
                                 rules=((r".*token_embedding/kernel$", (None, "model")),))
    with pytest.raises(ValueError, match="not a Megatron pair"):
        parallel.shard_params_tp(model, parallel.Mesh(1, 2, 0, CPU),
                                 rules=((r".*query/kernel$", (None, "model")),))


def test_seed_folds_keep_rank_zero_and_move_only_the_sharded_site():
    base = trng.draw_seed(trng.make_generator(9))
    for d, m in ((0, 0), (1, 0), (0, 1), (1, 1)):
        rep = trng.draw_seed(trng.RankGenerator(trng.make_generator(9), d, m))
        shard = trng.draw_seed(trng.RankGenerator(trng.make_generator(9), d, m), sharded=True)
        assert rep == base | (d << 32) and shard == base | ((d | m << 16) << 32)
    assert trng.draw_seed(trng.RankGenerator(trng.make_generator(9), 0, 1), sharded=True) != base


# -- the ranks ----------------------------------------------------------------------------


def test_the_job_is_a_2x2_mesh(ranks):
    assert [(r["rank"], r["index"], r["world"], r["backend"]) for r in ranks] == [
        (0, (0, 0), 4, "gloo"), (1, (0, 1), 4, "gloo"), (2, (1, 0), 4, "gloo"),
        (3, (1, 1), 4, "gloo")]


def test_jax_checks_eval_step_specs_and_fit(ranks, refs):
    """tests/test_parallel.py:70-153 on the port's 2 x 2 mesh."""
    want = refs["tiny_eval_loss"]
    assert want == pytest.approx(refs["jax_tiny_eval"], rel=2e-5)
    assert refs["jax_tiny_eval_sharded"] == pytest.approx(want, rel=2e-5)
    for r in ranks:
        got = r["jax_checks"]
        assert got["eval_loss"] == pytest.approx(want, rel=2e-5)
        assert np.isfinite(got["step"]["total"])
        changed = set(got["step"]["changed"])
        assert "fusion.sig_weights" in changed
        assert {"behrt_lab.layer_0.query.weight", "behrt_demo.bert.layer_0.output.weight"} \
            <= changed
        history = got["fit"]["history"]
        assert len(history) == 2 and all(np.isfinite(h["val_loss"]) for h in history)
        np.testing.assert_allclose(got["fit"]["dynamic_weights"].sum(axis=1), 1.0, atol=1e-5)


def test_a_sharded_layer_on_the_kernel_wrappers_is_the_whole_layer(ranks):
    for r in ranks:
        for fused, got in r["layer"].items():
            assert got["sharded"] == (6 if fused else 10), fused
            assert max(got["y"], got["dx"]) <= 1e-5 and got["grads"] <= 1e-4, (fused, got)


def test_checkpoints_hold_full_leaves_resume_bit_identically_and_load_in_one_process(ranks,
                                                                                   tp):
    from test_torch_parallel import _same

    tmp = tp[1]
    assert sorted(os.listdir(os.path.join(tmp, "ckpt_A"))) == ["step_1.pt", "step_2.pt"]
    a, b = (torch.load(os.path.join(tmp, f"ckpt_{c}", "step_2.pt"), weights_only=True)
            for c in "AB")
    _same(a, b)
    assert a["model"]["behrt_lab.layer_0.ffn_in.weight"].shape == (2048, 16)
    moments = a["optimizer"]["state"]
    assert {tuple(s["exp_avg"].shape) for s in moments.values()} >= {(2048, 16), (16, 2048)}
    # One process reads the mesh's train state.
    from fairmultimodal_torch.utils.checkpoint import Checkpointer

    one = _tiny_trainer({k: v.numpy() for k, v in a["model"].items()}, lr=1e-3, num_epochs=3)
    history = one.fit([_tiny_batch(8, seed=1)], [_tiny_batch(8, seed=2)], verbose=False,
                      checkpointer=Checkpointer(os.path.join(tmp, "ckpt_A")))[1]
    assert [h["epoch"] for h in history] == [1, 2, 3]


def test_six_f64_steps_match_one_process_and_the_jax_2x2_trainer(ranks, refs):
    """The clip engages (the global norm is above 1 at some step); a clip on
    a rank's local norm, collectives over the whole mesh instead of the data
    group, or the L1 term on every rank leave this trajectory."""
    losses, state, norms = refs["steps"]
    assert max(norms) > CFG["grad_clip"]
    j_losses, j_state = refs["jax_steps"]
    assert losses == pytest.approx(j_losses, rel=LOSS_REL)
    for r in ranks:
        got_losses, got = r["steps"]
        assert got_losses == pytest.approx(losses, rel=LOSS_REL)
        assert set(got) == set(state)
        for name in state:
            _close(got[name], state[name])
            _close(got[name], j_state[name])


def test_dropout_replicas_agree_and_shards_draw_their_own_masks(ranks):
    digests = [r["dropout"]["digests"] for r in ranks]
    for step in range(3):
        assert len({d[step][0] for d in digests}) == 1      # replicated: all four ranks
        shards = [d[step][1] for d in digests]
        assert shards[0] == shards[2] and shards[1] == shards[3] and shards[0] != shards[1]
    assert len({d[0] for d in digests[0]}) == 3
    for r in ranks:
        a, b = r["dropout"]["twice"]
        assert a == b
    seeds = {r["index"]: r["dropout"]["seeds"] for r in ranks}
    # The lab layer draws attention, inner FFN (sharded), outer FFN.
    assert [s for s, _ in seeds[(0, 0)]] == [False, True, False]
    for d in (0, 1):
        (_, a0), (_, i0), (_, o0) = seeds[(d, 0)]
        (_, a1), (_, i1), (_, o1) = seeds[(d, 1)]
        assert (a0, o0) == (a1, o1) and i0 != i1
        assert (a0 >> 32, i1 >> 32) == (d, d | 1 << 16)
    assert seeds[(0, 0)][0][1] < 2 ** 31 and seeds[(0, 0)][1][1] < 2 ** 31


def _jax_splits(jax_cli):
    return {k: np.asarray(v) for k, v in jax_cli["out"]["splits"].items()}


@pytest.mark.parametrize("spec", ["2x2", "1x2"])
def test_cli_mesh_shards_and_gives_the_jax_mesh_numbers(spec, ranks, ranks_1x2, jax_cli, tp):
    """The JAX command line's ``--mesh 2x2`` holds replicas; the port's
    shards: each rank holds 1 / M of every sharded leaf, and the run's
    numbers are JAX's."""
    job = ranks if spec == "2x2" else ranks_1x2
    want = jax_cli["out"]
    model = int(spec[-1])
    for r in job:
        got = r["cli"] if spec == "2x2" else r
        assert got["rc"] == 0
        assert {k: v.tolist() for k, v in got["splits"].items()} == \
            {k: v.tolist() for k, v in _jax_splits(jax_cli).items()}
        for g, w in zip(got["history"], want["history"]):
            for k in ("train_loss", "val_loss"):
                assert g[k] == pytest.approx(w[k], rel=1e-5), k
        for task, m in want["metrics"].items():
            assert got["metrics"][task]["aucroc"] == pytest.approx(m["aucroc"], abs=1e-4)
        assert len(got["plan"]) == 20
        for name, kind in got["plan"].items():
            full, local = got["best_shapes"][name], list(got["local_shapes"][name])
            dim = 1 if kind == "row" else 0
            local[dim] *= model
            assert tuple(local) == full, name
    r0 = job[0]["cli"] if spec == "2x2" else job[0]
    assert "AUROC" in r0["stdout"] and not any(
        (r["cli"] if spec == "2x2" else r)["stdout"].strip() for r in job[1:])
    npz = glob.glob(os.path.join(tp[1], f"cli_{spec}", "best_model_*.npz"))
    assert len(npz) == 1
    from fairmultimodal_torch.utils.checkpoint import load_params_npz

    tree = load_params_npz(npz[0])
    assert tree["behrt_lab"]["layer_0"]["ffn_in"]["kernel"].shape == (64, 2048)
    assert tree["behrt_demo"]["bert"]["layer_0"]["attention"]["query"]["kernel"].shape == (64, 64)


def test_predict_reads_the_tensor_parallel_npz(ranks, tp, jax_cli, tmp_path, monkeypatch):
    from fairmultimodal_torch.models import text as t_text
    from fairmultimodal_torch.models.bert import BertConfig

    cli = importlib.import_module("fairmultimodal_torch.cli.main")
    encoder = t_text.TextEncoder.from_params(jax_cli["encoder"], BertConfig(**CLI_TEXT),
                                             device="cpu")
    monkeypatch.setattr(t_text.TextEncoder, "from_pretrained",
                        classmethod(lambda cls, *a, **k: encoder))
    npz = glob.glob(os.path.join(tp[1], "cli_2x2", "best_model_*.npz"))[0]
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = cli.main(["predict", "--synthetic", "64", "--tiny", "--device", "cpu",
                       "--params", npz, "--out_dir", str(tmp_path)])
    assert rc == 0 and "Wrote predictions for " in buf.getvalue()
    assert os.path.exists(tmp_path / "predictions.csv")
