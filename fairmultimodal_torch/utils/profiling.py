"""Tracing and profiling (port of ``fairmultimodal_tpu/utils/profiling.py``).

- :func:`trace`: a named range (``torch.profiler.record_function``) that
  shows in captured traces;
- :func:`profile_to`: a ``torch.profiler`` capture (CPU, and CUDA where
  there is a card) around a block, written as a Chrome trace under a
  directory;
- :func:`hlo_self_times`: the newest trace's self-times in microseconds,
  summed over the trace, by event category and by name: the device's
  kernels (and copies / sets) where the trace holds any, else the CPU ops
  and :func:`trace` ranges;
- :class:`Timer` / :func:`throughput`: host-clock timing that waits for the
  card before it reads the clock.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["trace", "profile_to", "hlo_self_times", "Timer", "throughput"]

#: Chrome-trace categories of work on the card, and of the host's ops and ranges.
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATEGORIES = ("cpu_op", "user_annotation")


@contextlib.contextmanager
def trace(name: str):
    """Named range visible in captured profiles."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile_to(logdir: str):
    """Profile the block and write ``<logdir>/<time_ns>.pt.trace.json``.
    Yields the ``torch.profiler.profile`` object (its ``key_averages()``
    hold the launch counts)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"{time.time_ns()}.pt.trace.json"))


def _synchronize(*tensors) -> None:
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)


class Timer:
    """Host-clock timer; :meth:`stop` waits for the given tensors' card."""

    def __init__(self):
        self.elapsed = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False

    def stop(self, *tensors):
        """Synchronise the devices of ``tensors``, then record elapsed."""
        _synchronize(*tensors)
        self.elapsed = time.perf_counter() - self._t0
        return self.elapsed


def throughput(step_fn: Callable, *args, iters: int = 20, warmup: int = 3,
               items_per_call: int = 1) -> Dict[str, float]:
    """Steady-state throughput of ``step_fn(*args)``: ``warmup`` calls, then
    ``iters`` timed calls with one synchronisation on the last call's output
    (a tensor or a tuple / list of them).  Returns wall seconds, calls/s,
    items/s and the per-device rate, over the ranks of the process group
    when there is one (``jax.device_count()`` in JAX): under data
    parallelism ``items_per_call`` is the global batch."""

    def wait(out):
        _synchronize(*(out if isinstance(out, (tuple, list)) else (out,)))

    out = None
    for _ in range(warmup):
        out = step_fn(*args)
    wait(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step_fn(*args)
    wait(out)
    dt = time.perf_counter() - t0
    n_chips = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "seconds": dt,
        "calls_per_sec": iters / dt,
        "items_per_sec": iters * items_per_call / dt,
        "items_per_sec_per_chip": iters * items_per_call / dt / n_chips,
        "n_chips": float(n_chips),
    }


def hlo_self_times(logdir: str) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(by category, by name) self-times in microseconds from the newest
    trace :func:`profile_to` wrote under ``logdir``, summed over every step
    traced (divide by the step count for per-step numbers).  The events are
    the card's kernels, copies and sets when the trace holds any, else the
    CPU ops and the :func:`trace` ranges; an event's self-time is its
    duration less that of the events nested in it on its thread (kernels on
    a stream do not nest)."""
    paths = sorted(glob.glob(os.path.join(logdir, "*.pt.trace.json")), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {logdir}")
    with open(paths[-1]) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in _DEVICE_CATEGORIES]
    events = device or [e for e in events if e.get("cat") in _HOST_CATEGORIES]
    rows, threads = [], {}          # [event, self-time]; the open events of each thread
    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        stack = threads.setdefault((e["pid"], e["tid"]), [])
        while stack and e["ts"] >= stack[-1][0]["ts"] + stack[-1][0]["dur"]:
            stack.pop()
        if stack:
            stack[-1][1] -= e["dur"]
        stack.append([e, float(e["dur"])])
        rows.append(stack[-1])
    by_category: Dict[str, float] = {}
    by_op: Dict[str, float] = {}
    for e, t in rows:
        by_category[e["cat"]] = by_category.get(e["cat"], 0.0) + t
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + t
    return by_category, by_op
