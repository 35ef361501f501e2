"""Data and tensor parallelism over ``torch.distributed`` (port of
``fairmultimodal_tpu/parallel/sharding.py`` and of the trainer's mesh paths).

One process per rank of a ``data x model`` mesh: NCCL between CUDA devices,
gloo on the CPU (gloo also takes CUDA tensors, which lets two ranks share
one card; NCCL refuses that).  Rank ``r`` is ``(d, m) = divmod(r, model)``,
the JAX ``reshape(data, model)`` grid.

- :class:`Mesh` is what a rank knows of the mesh: its shape, its rank, its
  data and model index, its device, the process group of the whole mesh,
  the **data group** (the ranks with its model index: the batch's
  collectives) and the **model group** (the ranks with its data index: the
  tensor-parallel collectives).
- :func:`get_mesh` builds it.  It checks the mesh against the devices as the
  JAX function does ("mesh 4x2 needs 8 devices, have 1") and joins the
  process group it finds (already initialized, or described by ``RANK`` /
  ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` as ``torchrun`` and
  :func:`launch` set them); a one-rank mesh creates its own group.  Every
  group it creates has a ``timeout``, so a rank that dies fails its peers'
  collectives instead of hanging them.
- :func:`launch` starts one spawned process per rank, so ``fame --mesh 2x2``
  stays one command.
- :func:`shard_batch` gives a rank its data index's contiguous ``B / data``
  rows; :func:`replicate` broadcasts data index 0's tensors; :func:`global_sum`
  and :func:`all_reduce_flat` are the collectives of the losses and the
  gradients; :func:`gather_rows` reassembles per-row outputs in batch order.
- Tensor parallelism (``model > 1``): :func:`shard_params_tp` slices each
  Megatron pair of the FAME model (:data:`DEFAULT_TP_RULES`, in the JAX
  package's flax paths) to this rank's shard in place; the sharded layers run
  their column-parallel products on :func:`copy_to_model`'s input and reduce
  their row-parallel partial sums with :func:`reduce_from_model`.
  :func:`full_state_dict` / :func:`load_full_state_dict` gather and slice a
  sharded model's state, so every file holds the full parameters.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "get_mesh", "parse_mesh", "mesh_devices", "launch", "launched",
           "shard_batch", "replicate", "global_sum", "all_reduce_flat", "gather_rows",
           "all_agree", "barrier", "DEFAULT_TIMEOUT_S", "DEFAULT_TP_RULES", "shard_params_tp",
           "tp_plan", "copy_to_model", "reduce_from_model", "full_state_dict",
           "shard_state_dict", "load_full_state_dict", "full_optimizer_state",
           "load_full_optimizer_state", "grad_norm_sq"]

#: Seconds a collective waits for a missing rank before the run fails.
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a ``data x model`` mesh.

    ``group`` is the process group of the whole mesh (the default group of
    the process when the mesh made it); ``owns_group`` says that
    :meth:`close` destroys it.  ``data_group`` holds the ranks with this
    rank's model index, ``model_group`` those with its data index (None
    without a model axis).
    """

    data: int
    model: int
    rank: int
    device: torch.device
    group: Any = None
    backend: str = "gloo"
    owns_group: bool = False
    data_group: Any = None
    model_group: Any = None

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def close(self) -> None:
        """Destroy the process group (and its subgroups) if this mesh created it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def parse_mesh(spec: str):
    """``'N'`` or ``'NxM'`` -> (data, model)."""
    parts = str(spec).lower().split("x")
    try:
        data = int(parts[0])
        model = int(parts[1]) if len(parts) > 1 else 1
    except ValueError:
        raise ValueError(f"mesh {spec!r}: expected 'N' or 'NxM'") from None
    if len(parts) > 2 or data < 1 or model < 1:
        raise ValueError(f"mesh {spec!r}: expected 'N' or 'NxM' with N, M >= 1")
    return data, model


def mesh_devices(devices: Optional[Sequence[Union[str, torch.device]]] = None,
                 data: Optional[int] = None, model: int = 1) -> List[torch.device]:
    """The devices a ``data x model`` mesh may use: ``devices`` as given,
    else every CUDA device (raising when there is none: the CPU is asked for
    by name).  Raises, as the JAX ``get_mesh`` does, when the mesh needs
    more than there are."""
    from fairmultimodal_torch.ops.gates import resolve_device

    if devices is None:
        resolve_device(None)
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
    if data is not None and data * model > len(devs):
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {len(devs)}")
    return devs


def launched() -> bool:
    """True inside a rank of a job: a process group exists, or ``torchrun``
    (or :func:`launch`) described one in the environment."""
    return dist.is_initialized() or "RANK" in os.environ


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _subgroups(data: int, model: int, rank: int, timeout_s: float):
    """(data group, model group) of ``rank``.  Every rank creates every
    subgroup, in the same order (``new_group`` is collective)."""
    timeout = datetime.timedelta(seconds=timeout_s)
    mine = {}
    for m in range(model):
        ranks = [d * model + m for d in range(data)]
        g = dist.new_group(ranks, timeout=timeout)
        if rank in ranks:
            mine["data"] = g
    for d in range(data):
        ranks = [d * model + m for m in range(model)]
        g = dist.new_group(ranks, timeout=timeout)
        if rank in ranks:
            mine["model"] = g
    return mine["data"], mine["model"]


def get_mesh(data: Optional[int] = None, model: int = 1,
             devices: Optional[Sequence[Union[str, torch.device]]] = None,
             backend: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """This process's rank of a ``data x model`` mesh over ``devices``.

    ``data=None`` uses every device divided by ``model``.  ``devices``
    defaults to every CUDA device; name them to choose (``["cpu"] * n`` for
    gloo ranks on the CPU, ``["cuda:0"] * 2`` with ``backend="gloo"`` for two
    ranks on one card).  Rank ``r`` runs on ``devices[LOCAL_RANK]``
    (``LOCAL_RANK`` defaults to ``r``) at ``(data index, model index) =
    divmod(r, model)``.  ``backend=None`` is NCCL on CUDA devices and gloo on
    the CPU.

    A mesh of more than one rank needs its processes: :func:`launch` or
    ``torchrun`` starts them, and each calls this function.
    """
    devs = mesh_devices(devices, data, model)
    if data is None:
        if len(devs) % model:
            raise ValueError(f"{len(devs)} devices not divisible by model={model}")
        data = len(devs) // model
    n = data * model
    if backend == "nccl" and len(set(devs[:n])) < n:
        raise ValueError(f"NCCL needs one device per rank; mesh {data}x{model} has "
                         f"{len(set(devs[:n]))} distinct devices (gloo shares a device)")
    if dist.is_initialized():
        if backend is not None and backend != dist.get_backend():
            raise ValueError(f"backend {backend!r}: the process group runs "
                             f"{dist.get_backend()!r}")
        backend, owns = dist.get_backend(), False
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        backend = backend or ("nccl" if devs[0].type == "cuda" else "gloo")
        rank = int(os.environ.get("RANK", 0))
        world = int(os.environ.get("WORLD_SIZE", 1))
        if world == 1 and "MASTER_PORT" not in os.environ:
            addr, port = "localhost", _free_port()
        else:
            addr, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
        owns = True
    if world != n:
        raise ValueError(f"mesh {data}x{model} needs {n} ranks; this job has {world} "
                         "(start them with parallel.launch or torchrun)")
    device = devs[int(os.environ.get("LOCAL_RANK", rank))]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if owns:
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
    data_group, model_group = dist.group.WORLD, None
    if model > 1:
        data_group, model_group = _subgroups(data, model, rank, timeout_s)
    return Mesh(data, model, rank, device, group=dist.group.WORLD, backend=backend,
                owns_group=owns, data_group=data_group, model_group=model_group)


# -- launching ranks ---------------------------------------------------------------------


def _rank_main(fn, args, rank, world, port, queue, threads):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    if threads:
        torch.set_num_threads(threads)
    try:
        result = fn(*args)
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    queue.put((rank, True, result))


def launch(fn: Callable, world: int, args: tuple = (), timeout_s: float = 3600.0,
           threads: Optional[int] = None) -> List[Any]:
    """``fn(*args)`` in ``world`` spawned processes, one per rank, each with
    ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
    ``MASTER_PORT`` set (a free port on localhost) and, given ``threads``,
    ``torch.set_num_threads(threads)``; ``fn`` calls :func:`get_mesh` to join.

    Returns each rank's result, in rank order.  ``fn`` and its arguments and
    result must pickle (``fn`` by import path).  A rank that raises or dies
    fails the launch with its traceback at once, and the ranks still running
    are terminated; so does passing ``timeout_s``.
    """
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, args, r, world, port, queue, threads))
             for r in range(world)]
    for p in procs:
        p.start()
    done: Dict[int, Any] = {}
    failed: Dict[int, str] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(done) < world and not failed:
            while not queue.empty():
                rank, ok, payload = queue.get()
                (done if ok else failed)[rank] = payload
            if failed or len(done) == world:
                break
            for r, p in enumerate(procs):
                if p.exitcode not in (None, 0) and r not in done and queue.empty():
                    failed[r] = f"rank {r} exited with code {p.exitcode}"
            if time.monotonic() > deadline:
                failed[-1] = f"ranks {sorted(set(range(world)) - set(done))} still running " \
                             f"after {timeout_s:.0f} s"
            time.sleep(0.02)
    finally:
        for p in procs:
            p.join(timeout=0 if failed else 60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if failed:
        raise RuntimeError("launch failed:\n" +
                           "\n".join(f"[rank {r}] {msg}" for r, msg in sorted(failed.items())))
    return [done[r] for r in range(world)]


# -- batches and replicas ----------------------------------------------------------------


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous ``B / data`` rows of every leaf's leading axis
    (numpy arrays or tensors, nested dicts), by its data index: the ranks of
    one model group take the same rows.  0-d leaves pass through."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if np.ndim(batch) == 0:
        return batch
    n = len(batch)
    if n % mesh.data:
        raise ValueError(f"a batch of {n} rows does not split over {mesh.data} ranks")
    b = n // mesh.data
    return batch[mesh.data_index * b:(mesh.data_index + 1) * b]


def _by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[torch.Tensor]]:
    out: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out


def _flat_collective(tensors: Sequence[torch.Tensor], run: Callable) -> None:
    """``run(flat)`` on one flat buffer per dtype, copied back in place."""
    for group in _by_dtype(tensors).values():
        flat = torch.cat([t.reshape(-1) for t in group])
        run(flat)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


def all_reduce_flat(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Sum ``tensors`` over the data group in place: one all-reduce of one
    flat buffer (per dtype), every rank left with the same bits.  A
    tensor-parallel mesh with one data rank has nothing to sum."""
    if mesh.model > 1 and mesh.data == 1:
        return
    _flat_collective(tensors, lambda flat: dist.all_reduce(flat, group=mesh.data_group))


@torch.no_grad()
def replicate(obj, mesh: Mesh):
    """Broadcast rank 0's values in place -- a module's parameters and
    buffers, a tensor, or a list / dict of tensors -- and return ``obj``.
    A module's tensor-parallel shards (:func:`shard_params_tp`) come from
    data index 0 of their model index instead."""
    if isinstance(obj, torch.nn.Module):
        plan = tp_plan(obj)
        named = dict(obj.named_parameters())
        tensors = [p for n, p in named.items() if n not in plan] + list(obj.buffers())
        shards = [named[n] for n in plan]
        if shards and mesh.data > 1:
            _flat_collective(shards, lambda flat: dist.broadcast(
                flat, mesh.model_index, group=mesh.data_group))
    elif isinstance(obj, torch.Tensor):
        tensors = [obj]
    else:
        tensors = list(obj.values() if isinstance(obj, dict) else obj)
    _flat_collective(tensors, lambda flat: dist.broadcast(flat, 0, group=mesh.group))
    return obj


class _GlobalSum(torch.autograd.Function):
    """Forward: the sum over the ranks.  Backward: the identity.  So each
    rank's value is global, its gradient path is its own term, and the
    gradients summed over the ranks (:func:`all_reduce_flat`) are the
    global value's gradient.  This is ``local + (all_reduce(local.detach())
    - local.detach())`` with the forward's value exact."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks, differentiable along this rank's
    term only (see :class:`_GlobalSum`).  ``torch.distributed.nn.all_reduce``
    would instead all-reduce the cotangents, counting every seed once per rank."""
    return _GlobalSum.apply(x, group)


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data rank's rows of ``t`` concatenated in data order: per-row
    outputs of a sharded batch back in batch order, on every rank."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.data)]
    dist.all_gather(parts, t, group=mesh.data_group)
    return torch.cat(parts)


def all_agree(flag: bool, mesh: Mesh) -> bool:
    """True when ``flag`` holds on every rank."""
    t = torch.tensor([0 if flag else 1], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t, group=mesh.group)
    return int(t) == 0


def barrier(mesh: Mesh) -> None:
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


# -- tensor parallelism ------------------------------------------------------------------

#: Path pattern -> PartitionSpec (as a tuple) of the JAX package's tensor
#: parallelism, in flax paths and ``[in, out]`` kernels: q / k / v / qkv and
#: the FFN's first product column-parallel, the output projections
#: row-parallel (an all-reduce after), the column-parallel biases split.
DEFAULT_TP_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r".*(query|key|value|qkv)/kernel$", (None, "model")),
    (r".*(intermediate|ffn_in)/kernel$", (None, "model")),
    (r".*attention/output_dense/kernel$", ("model", None)),
    (r".*attn_out/kernel$", ("model", None)),
    (r".*layer_\d+/output/kernel$", ("model", None)),
    (r".*ffn_out/kernel$", ("model", None)),
    (r".*(query|key|value|qkv)/bias$", ("model",)),
    (r".*(intermediate|ffn_in)/bias$", ("model",)),
)

_COL, _ROW = (None, "model"), ("model", None)


def tp_plan(model: torch.nn.Module) -> Dict[str, str]:
    """The sharded parameters of a model :func:`shard_params_tp` sliced:
    name -> ``"col"`` (dim 0 split), ``"row"`` (dim 1 split) or ``"qkv"``
    (each of q / k / v's rows split); empty for an unsharded model."""
    return getattr(model, "_tp_plan", {})


def _rule_spec(path: str, shape: Sequence[int], rules, m: int) -> Tuple:
    """The JAX ``shard_params_tp``'s choice for one leaf: the first rule
    whose pattern matches decides, dropped (replicated) where a sharded
    dimension does not divide by the model axis."""
    for pattern, candidate in rules:
        if re.match(pattern, path):
            if any(name == "model" and shape[i] % m for i, name in enumerate(candidate)):
                return ()
            return tuple(candidate)
    return ()


def _take(t: torch.Tensor, kind: str, index: int, m: int) -> torch.Tensor:
    if kind == "col":
        return t.chunk(m, 0)[index]
    if kind == "row":
        return t.chunk(m, 1)[index]
    return torch.cat([part.chunk(m, 0)[index] for part in t.chunk(3, 0)])


def _join(parts: Sequence[torch.Tensor], kind: str) -> torch.Tensor:
    if kind == "col":
        return torch.cat(parts, 0)
    if kind == "row":
        return torch.cat(parts, 1)
    return torch.cat([torch.cat([p.chunk(3, 0)[j] for p in parts]) for j in range(3)])


@torch.no_grad()
def shard_params_tp(model: torch.nn.Module, mesh: Mesh, rules=DEFAULT_TP_RULES) -> Dict[str, Tuple]:
    """Slice ``model``'s Megatron pairs to this rank's shard, in place, by
    ``rules`` (JAX's, ``sharding.py:61-102``); return every leaf's spec in
    JAX's form: flax path -> the PartitionSpec as a tuple, ``()`` for a
    replicated leaf.

    The specs are in flax ``[in, out]`` terms, so a column-parallel kernel
    ``(None, "model")`` splits the port's ``[out, in]`` weight on dim 0 and a
    row-parallel one on dim 1.  The unit of sharding is the half-layer a
    module names in ``tp_halves()`` (``TorchEncoderLayer``'s attention and
    FFN halves, ``BertSelfAttention``, ``BertLayer``'s FFN): its
    column-parallel products keep this rank's output features (with a fused
    ``qkv``, this rank's heads of each of q, k and v), the row-parallel one
    this rank's input features, its bias replicated and added once after the
    reduction.  A half is sharded when the rules give it that pairing, and
    replicated when they give it none, as where a dimension does not divide
    (JAX's guard).  The port also replicates an attention half whose heads
    do not divide by the model axis (JAX's guard checks dimensions only, so
    JAX splits a head there).  A rule that shards anything else raises.

    Each sharded module learns its model group (its ``tp_halves`` field is
    set to ``mesh``), so its forward runs the local heads and widths and
    reduces the row-parallel partial sums (:func:`reduce_from_model`).
    Every rank must hold the same full parameters when this runs (the same
    seeded init; :func:`replicate` after it keeps the shards apart).
    """
    from fairmultimodal_torch.interop import flax_leaf

    m = mesh.model
    params = dict(model.named_parameters())
    specs = {}
    for name, p in params.items():
        path, shape = flax_leaf(model, name, tuple(p.shape))
        specs[name] = (path, _rule_spec(path, shape, rules, m) if m > 1 else ())
    plan: Dict[str, str] = {}
    halves = []
    for prefix, module in model.named_modules():
        for attr, cols, row, heads, fields in getattr(module, "tp_halves", lambda: ())():
            pre = f"{prefix}." if prefix else ""
            want = {f"{pre}{row}.weight": _ROW, f"{pre}{row}.bias": ()}
            for c in cols:
                want.update({f"{pre}{c}.weight": _COL, f"{pre}{c}.bias": ("model",)})
            got = {n: specs[n][1] for n in want}
            if heads is not None and heads % m:
                for n in want:
                    specs[n] = (specs[n][0], ())
            elif got == want and m > 1:
                halves.append((module, attr, fields))
                for c in cols:
                    kind = "qkv" if c == "qkv" else "col"
                    plan.update({f"{pre}{c}.weight": kind, f"{pre}{c}.bias": kind})
                plan[f"{pre}{row}.weight"] = "row"
            elif any(got.values()):
                raise ValueError(f"tensor parallelism: the rules give {prefix or 'the model'}'s "
                                 f"{attr} half {got}, not a Megatron pair")
    stray = [specs[n][0] for n in specs if specs[n][1] and n not in plan]
    if stray:
        raise ValueError(f"tensor parallelism: the rules shard {stray}, which no half-layer "
                         "of the port splits")
    for name, kind in plan.items():
        owner_name, leaf = name.rsplit(".", 1)
        owner = model.get_submodule(owner_name)
        old = params[name]
        setattr(owner, leaf, torch.nn.Parameter(_take(old.detach(), kind, mesh.model_index, m)
                                                .clone(), requires_grad=old.requires_grad))
        if leaf == "weight":
            owner.out_features, owner.in_features = owner.weight.shape
    for module, attr, fields in halves:
        setattr(module, attr, mesh)
        for k, v in fields.items():
            setattr(module, k, v)
    model._tp_plan = {**tp_plan(model), **plan}
    model._tp_mesh = mesh
    return {path: spec for path, spec in specs.values()}


class _CopyToModel(torch.autograd.Function):
    """Megatron's "copy": identity forward, all-reduce over the model group
    backward (the input of the column-parallel products, whose cotangent
    each rank holds a part of)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The input of a column-parallel product on a sharded layer."""
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's "reduce": the row-parallel partial sums all-reduced over
    the model group, identity backward (:func:`global_sum`)."""
    return global_sum(x.contiguous(), mesh.model_group)


def _gather(t: torch.Tensor, kind: str, mesh: Mesh) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.model)]
    dist.all_gather(parts, t, group=mesh.model_group)
    return _join(parts, kind)


@torch.no_grad()
def full_state_dict(model: torch.nn.Module, state: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
    """``model``'s state dict (or ``state``, one of its state dicts, such as
    a saved best state) with every tensor-parallel shard gathered over the
    model group: the full parameters, on every rank of the group.  An
    unsharded model's is returned as it is."""
    state = model.state_dict() if state is None else state
    plan = tp_plan(model)
    if not plan:
        return state
    mesh = model._tp_mesh
    return {k: _gather(v, plan[k], mesh) if k in plan else v for k, v in state.items()}


def shard_state_dict(model: torch.nn.Module, state: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A full state dict of ``model`` with each sharded tensor cut to this
    rank's shard (the inverse of :func:`full_state_dict`)."""
    plan = tp_plan(model)
    if not plan:
        return state
    mesh = model._tp_mesh
    return {k: _take(v, plan[k], mesh.model_index, mesh.model) if k in plan else v
            for k, v in state.items()}


@torch.no_grad()
def load_full_state_dict(model: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Load full parameters (from :func:`full_state_dict`, a file, one
    process) into ``model``, each sharded tensor cut to this rank's shard."""
    model.load_state_dict(shard_state_dict(model, state))


def _optimizer_names(model: torch.nn.Module, optimizer) -> List[str]:
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def full_optimizer_state(model: torch.nn.Module, optimizer) -> Dict:
    """The optimizer's state dict with each sharded parameter's state
    tensors (AdamW's moments) gathered like :func:`full_state_dict`."""
    state = optimizer.state_dict()
    plan = tp_plan(model)
    if not plan:
        return state
    mesh, names = model._tp_mesh, _optimizer_names(model, optimizer)
    with torch.no_grad():
        per = {i: {k: _gather(v, plan[names[i]], mesh)
                   if names[i] in plan and torch.is_tensor(v) and v.dim() else v
                   for k, v in s.items()} for i, s in state["state"].items()}
    return {**state, "state": per}


def load_full_optimizer_state(model: torch.nn.Module, optimizer, state: Dict) -> None:
    """Load a :func:`full_optimizer_state` (or one process's) into ``optimizer``."""
    plan = tp_plan(model)
    if plan:
        mesh, names = model._tp_mesh, _optimizer_names(model, optimizer)
        state = {**state, "state": {
            i: {k: _take(v, plan[names[i]], mesh.model_index, mesh.model)
                if names[i] in plan and torch.is_tensor(v) and v.dim() else v
                for k, v in s.items()} for i, s in state["state"].items()}}
    optimizer.load_state_dict(state)


def grad_norm_sq(params: Sequence[torch.nn.Parameter], model: torch.nn.Module
                 ) -> torch.Tensor:
    """The squared global 2-norm of ``params``' gradients over a sharded
    model: the shards' square-sums summed over the model group, each
    replicated gradient counted once."""
    plan = {id(p) for n, p in model.named_parameters() if n in tp_plan(model)}
    grads = [p.grad for p in params if p.grad is not None]
    norms = lambda gs: (torch.stack(torch._foreach_norm(gs)).pow(2).sum()   # noqa: E731
                        if gs else torch.zeros((), device=grads[0].device))
    shards = norms([p.grad for p in params if p.grad is not None and id(p) in plan])
    rest = norms([p.grad for p in params if p.grad is not None and id(p) not in plan])
    if plan:
        dist.all_reduce(shards, group=model._tp_mesh.model_group)
    return rest + shards
