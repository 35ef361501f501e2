"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all started
together) into a shared library with a plain C interface for ``sm_90a``,
loaded with :mod:`ctypes`.  Nothing here runs at import time: the first
kernel launch builds, so the CPU tests import every module without a
compiler.  Libraries go to ``build/kernels/<hash>/`` at the repository root,
keyed by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once.

Launch helpers take torch tensors, make the tensors' device current, pass
raw pointers and that device's current stream, and raise
:class:`KernelLaunchError` when the C entry returns a non-zero
``cudaGetLastError()`` (a refused launch never runs, and a later synchronise
would not report it).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

__all__ = ["KernelLaunchError", "build", "kernels", "gemm_bias_act",
           "flash_attn_fwd", "add_layernorm", "ACT_CODES"]

_CSRC = Path(__file__).resolve().with_name("csrc")
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
_SOURCES = ("gemm.cu", "flash_attention.cu", "add_layernorm.cu")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ACT_CODES = {"none": 0, "relu": 1, "gelu": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "gemm.cu": {"fm_gemm_bias_act": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]},
    "flash_attention.cu": {"fm_flash_attn_fwd": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P]},
    "add_layernorm.cu": {"fm_add_layernorm": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P]},
}


class KernelLaunchError(RuntimeError):
    """A CUDA kernel of this package was refused or failed at launch."""


def _nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")] \
        if os.environ.get("CUDA_HOME") else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise FileNotFoundError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                            "the CUDA kernels are built from source at first use")


def _source_hash() -> str:
    h = hashlib.blake2b(digest_size=8)
    h.update(" ".join(_NVCC_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build() -> Dict[str, Path]:
    """Compile every source that has no library yet; returns name -> .so.

    One ``nvcc`` per source, run in parallel.  The compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside each
    library as ``<name>.log``.
    """
    out_dir = _BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src: out_dir / (Path(src).stem + ".so") for src in _SOURCES}
    todo = [src for src, lib in libs.items() if not lib.exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = libs[src].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        (out_dir / (Path(src).stem + ".log")).write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, libs[src])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def kernels() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every library once per process."""
    loaded = {}
    for src, path in build().items():
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[src].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        loaded[src] = lib
    err = loaded["gemm.cu"].fm_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return loaded


def _check(rc: int, name: str) -> None:
    if rc != 0:
        msg = kernels()["gemm.cu"].fm_error_string(rc).decode()
        raise KernelLaunchError(f"{name}: CUDA error {rc} ({msg})")


def _dtype_code(t: torch.Tensor) -> int:
    try:
        return _DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, got {t.dtype}") from None


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def gemm_bias_act(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  out: torch.Tensor, activation: str = "none") -> torch.Tensor:
    """``out = act(a @ w.T + bias)``: a [M, K], w [N, K] (nn.Linear layout)
    in the io dtype, bias [N] fp32, out [M, N] in the io dtype or fp32."""
    m, k = a.shape
    n = w.shape[0]
    if k % 32:
        raise ValueError(f"gemm: K={k} must be a multiple of 32")
    _require(a, "a", (m, k), a.dtype, a.device)
    _require(w, "w", (n, k), a.dtype, a.device)
    _require(bias, "bias", (n,), torch.float32, a.device)
    _require(out, "out", (m, n), out.dtype, a.device)
    code = _dtype_code(a)
    if out.dtype not in (a.dtype, torch.float32):
        raise TypeError(f"gemm: out must be {a.dtype} or float32, got {out.dtype}")
    with torch.cuda.device(a.device):
        rc = kernels()["gemm.cu"].fm_gemm_bias_act(
            a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), m, n, k, code,
            int(out.dtype == torch.float32), ACT_CODES[activation], _stream(a))
    _check(rc, "fm_gemm_bias_act")
    return out


def flash_attn_fwd(qkv: torch.Tensor, mask: torch.Tensor, out: torch.Tensor,
                   num_heads: int) -> torch.Tensor:
    """Masked attention over qkv [B, S, 3H] into out [B, S, H]."""
    b, s, h3 = qkv.shape
    h = h3 // 3
    d = h // num_heads
    if h3 % 3 or h % num_heads or d > 128:
        raise ValueError(f"attention: H={h}, heads={num_heads} needs d=H/heads <= 128")
    _require(qkv, "qkv", (b, s, h3), qkv.dtype, qkv.device)
    _require(mask, "mask", (b, s), torch.int32, qkv.device)
    _require(out, "out", (b, s, h), qkv.dtype, qkv.device)
    with torch.cuda.device(qkv.device):
        rc = kernels()["flash_attention.cu"].fm_flash_attn_fwd(
            qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), b, s, num_heads, d,
            1.0 / (d ** 0.5), _dtype_code(qkv), _stream(qkv))
    _check(rc, "fm_flash_attn_fwd")
    return out


def add_layernorm(x: torch.Tensor, y: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, out: torch.Tensor, eps: float) -> torch.Tensor:
    """``out = LN(round(x + y))``: x, out [R, H] io dtype; y [R, H] fp32."""
    r, h = x.shape
    _require(x, "x", (r, h), x.dtype, x.device)
    _require(y, "y", (r, h), torch.float32, x.device)
    _require(gamma, "gamma", (h,), torch.float32, x.device)
    _require(beta, "beta", (h,), torch.float32, x.device)
    _require(out, "out", (r, h), x.dtype, x.device)
    with torch.cuda.device(x.device):
        rc = kernels()["add_layernorm.cu"].fm_add_layernorm(
            x.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            r, h, float(eps), _dtype_code(x), _stream(x))
    _check(rc, "fm_add_layernorm")
    return out
