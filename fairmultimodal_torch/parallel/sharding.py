"""Data parallelism over ``torch.distributed`` (port of
``fairmultimodal_tpu/parallel/sharding.py:27-57`` and of the trainer's
``shard_map`` data-parallel path).

One process per rank, each holding a full replica of the model on its own
device: NCCL between CUDA devices, gloo on the CPU (gloo also takes CUDA
tensors, which lets two ranks share one card; NCCL refuses that).

- :class:`Mesh` is what a rank knows of the mesh: its shape, its rank, its
  device and the process group.
- :func:`get_mesh` builds it.  It checks the mesh against the devices as the
  JAX function does ("mesh 2x1 needs 2 devices, have 1") and joins the
  process group it finds (already initialized, or described by ``RANK`` /
  ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` as ``torchrun`` and
  :func:`launch` set them); a one-rank mesh creates its own group.  Every
  group it creates has a ``timeout``, so a rank that dies fails its peers'
  collectives instead of hanging them.
- :func:`launch` starts one spawned process per rank, so ``fame --mesh 2``
  stays one command.
- :func:`shard_batch` gives a rank its contiguous ``B / world`` rows;
  :func:`replicate` broadcasts rank 0's tensors; :func:`global_sum` and
  :func:`all_reduce_flat` are the collectives of the losses and the
  gradients; :func:`gather_rows` reassembles per-row outputs in batch order.

Tensor parallelism (a ``model`` axis over 1, the JAX package's
``shard_params_tp`` / ``DEFAULT_TP_RULES``) is not ported: such a mesh
raises, naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from fairmultimodal_torch.ops.gates import resolve_device

__all__ = ["Mesh", "get_mesh", "parse_mesh", "mesh_devices", "check_data_parallel",
           "launch", "launched", "shard_batch", "replicate", "global_sum", "all_reduce_flat",
           "gather_rows", "all_agree", "barrier", "TP_ITEM", "DEFAULT_TIMEOUT_S"]

#: Where tensor parallelism stands in the ROADMAP (named by every refusal).
TP_ITEM = "ROADMAP queue 1 item 6, its tensor-parallel part"
#: Seconds a collective waits for a missing rank before the run fails.
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a ``data x model`` mesh.

    ``group`` is the process group of the mesh's collectives (the default
    group of the process when the mesh made it); ``owns_group`` says that
    :meth:`close` destroys it.
    """

    data: int
    model: int
    rank: int
    device: torch.device
    group: Any = None
    backend: str = "gloo"
    owns_group: bool = False

    @property
    def world(self) -> int:
        return self.data * self.model

    def close(self) -> None:
        """Destroy the process group if this mesh created it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def check_data_parallel(data: Optional[int], model: int) -> None:
    """Raise for a mesh with a ``model`` axis: only data parallelism is ported."""
    if model != 1:
        raise NotImplementedError(
            f"mesh {data}x{model}: tensor parallelism (model > 1) is not ported ({TP_ITEM}); "
            "use a data-parallel mesh, 'N' or 'Nx1'")


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


def get_mesh(data: Optional[int] = None, model: int = 1,
             devices: Optional[Sequence[Union[str, torch.device]]] = None,
             backend: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """This process's rank of a ``data x model`` mesh over ``devices``.

    ``data=None`` uses every device.  ``devices`` defaults to every CUDA
    device; name them to choose (``["cpu"] * n`` for gloo ranks on the CPU,
    ``["cuda:0"] * 2`` with ``backend="gloo"`` for two ranks on one card).
    Rank ``r`` runs on ``devices[LOCAL_RANK]`` (``LOCAL_RANK`` defaults to
    ``r``).  ``backend=None`` is NCCL on CUDA devices and gloo on the CPU.

    A mesh of more than one rank needs its processes: :func:`launch` or
    ``torchrun`` starts them, and each calls this function.
    """
    check_data_parallel(data, model)
    devs = mesh_devices(devices, data, model)
    if data is None:
        data = len(devs)
    if backend == "nccl" and len(set(devs[:data])) < data:
        raise ValueError(f"NCCL needs one device per rank; mesh {data}x{model} has "
                         f"{len(set(devs[:data]))} distinct devices (gloo shares a device)")
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
    if world != data:
        raise ValueError(f"mesh {data}x{model} needs {data} ranks; this job has {world} "
                         "(start them with parallel.launch or torchrun)")
    device = devs[int(os.environ.get("LOCAL_RANK", rank))]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if owns:
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh(data, model, rank, device, group=dist.group.WORLD, backend=backend,
                owns_group=owns)


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
        raise RuntimeError("data-parallel launch failed:\n" +
                           "\n".join(f"[rank {r}] {msg}" for r, msg in sorted(failed.items())))
    return [done[r] for r in range(world)]


# -- batches and replicas ----------------------------------------------------------------


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous ``B / world`` rows of every leaf's leading axis
    (numpy arrays or tensors, nested dicts); 0-d leaves pass through."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if np.ndim(batch) == 0:
        return batch
    n = len(batch)
    if n % mesh.data:
        raise ValueError(f"a batch of {n} rows does not split over {mesh.data} ranks")
    b = n // mesh.data
    return batch[mesh.rank * b:(mesh.rank + 1) * b]


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
    """Sum ``tensors`` over the ranks in place: one all-reduce of one flat
    buffer (per dtype), every rank left with the same bits."""
    _flat_collective(tensors, lambda flat: dist.all_reduce(flat, group=mesh.group))


@torch.no_grad()
def replicate(obj, mesh: Mesh):
    """Broadcast rank 0's values in place -- a module's parameters and
    buffers, a tensor, or a list / dict of tensors -- and return ``obj``."""
    if isinstance(obj, torch.nn.Module):
        tensors = [*obj.parameters(), *obj.buffers()]
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
    """Every rank's rows of ``t`` concatenated in rank order: per-row outputs
    of a sharded batch back in batch order, on every rank."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t, group=mesh.group)
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
