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
from typing import Dict, Optional

import torch

from fairmultimodal_torch.utils.rng import Dropout

__all__ = ["KernelLaunchError", "build", "kernels", "gemm", "colsum", "row_block_sums",
           "flash_attn_fwd", "flash_attn_bwd", "flash_attention_fwd", "flash_attention_bwd",
           "add_layernorm", "layernorm_bwd", "ACT_CODES", "FLASH_BWD_TILE", "LN_BWD_ROWS",
           "SUM_ROWS", "WGMMA_TILE", "flash_bwd_colpart_rows"]

_CSRC = Path(__file__).resolve().with_name("csrc")
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
_SOURCES = ("gemm.cu", "flash_attention.cu", "add_layernorm.cu")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ACT_CODES = {"none": 0, "relu": 1, "gelu": 2}
_GATE_CODES = {None: 0, "relu": 1, "dgelu": 2}
_LAYOUTS = {"nt": 0, "nn": 1, "tn": 2}
#: Rows a flash-backward block owns, in both of its kernels (its column
#: partials have B * ceil(S / tile) rows): bf16 64 = 4 warps x 16, fp32 32.
FLASH_BWD_TILE = {torch.bfloat16: 64, torch.float32: 32}
#: The bf16 ``wgmma`` GEMM's block tile (rows, columns): ``gemm.cu``'s WG_BM x WG_BN.
WGMMA_TILE = (128, 256)


def flash_bwd_colpart_rows(batch: int, seq: int, dtype: torch.dtype) -> int:
    """Rows of the flash backward's column partials: one per owned tile."""
    return batch * -(-seq // FLASH_BWD_TILE[dtype])

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_U64 = ctypes.c_ulonglong
_F = ctypes.c_float
_L = ctypes.c_longlong
_S3 = ctypes.POINTER(ctypes.c_longlong)   # (batch, head, row) strides of one operand
_DROP = [_U64, _U, _U, _F, _I]        # the fields of a utils.rng.Dropout
_SIGNATURES = {
    "gemm.cu": {
        "fm_gemm": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, *_DROP, _P, _P, _I, _F,
                    _P, _P, _P],
        "fm_colsum": [_P, _P, _I, _I, _I, _P],
        "fm_row_block_sums": [_P, _P, _I, _I, _I, _P],
    },
    "flash_attention.cu": {
        "fm_flash_attention_fwd": [_P, _S3, _P, _S3, _P, _S3, _P, _L, _P, _S3, _P,
                                   _I, _I, _I, _I, _F, _I, _P],
        "fm_flash_attention_bwd": [_P, _S3, _P, _S3, _P, _S3, _P, _S3, _P, _S3, _P, _L, _P, _P,
                                   _P, _S3, _P, _S3, _P, _S3, _P, _I, _I, _I, _I, _F, _I, _P],
    },
    "add_layernorm.cu": {
        "fm_add_layernorm": [_P, _P, _P, _P, _P, _P, _I, _I, _F, *_DROP, _I, _I, _P],
        "fm_layernorm_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _F, *_DROP, _I, _I, _P],
    },
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


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def gemm(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, *, layout: str = "nt",
         bias: Optional[torch.Tensor] = None, activation: str = "none",
         dropout: Dropout = Dropout(), aux: Optional[torch.Tensor] = None,
         gate: Optional[torch.Tensor] = None, gate_kind: Optional[str] = None,
         gate_scale: float = 1.0, resid: Optional[torch.Tensor] = None,
         colpart: Optional[torch.Tensor] = None, splits: int = 1) -> torch.Tensor:
    """``out = epilogue(op(a) . op(b))`` (``csrc/gemm.cu``).

    ``layout`` "nt": a [M, K], b [N, K] (nn.Linear weight); "nn": a [M, K],
    b [K, N]; "tn": a [K, M], b [K, N] (a weight grad, K the rows; with
    ``splits`` > 1 ``out`` is [splits, M, N] fp32 partials for
    :func:`colsum`).  a, b in the io dtype; out in the io dtype or fp32.
    Epilogue operands: bias [N] fp32, aux / gate [M, N] io dtype, resid
    [M, N] fp32, colpart [ceil(M / 128), N] fp32.  "nt" takes bias,
    activation, dropout and aux (the pre-activation); "nn" takes gate (with
    colpart, and aux for the dgelu gate) or resid; "tn" takes none.
    """
    if layout == "tn":
        k, m = a.shape
        n = b.shape[1]
        bshape = (k, n)
    else:
        m, k = a.shape
        n = b.shape[0] if layout == "nt" else b.shape[1]
        bshape = (n, k) if layout == "nt" else (k, n)
    dev, dt = a.device, a.dtype
    if layout != "tn" and (k % 32 or splits != 1):
        raise ValueError(f"gemm {layout}: K={k} must be a multiple of 32, one split")
    if (layout == "nn" and n % 8) or (layout == "tn" and (m % 8 or n % 8)):
        raise ValueError(f"gemm {layout}: M={m}, N={n} must be multiples of 8")
    _require(a, "a", a.shape, dt, dev)
    _require(b, "b", bshape, dt, dev)
    _require(out, "out", (splits, m, n) if splits > 1 else (m, n), out.dtype, dev)
    if out.dtype not in (dt, torch.float32) or (splits > 1 and out.dtype != torch.float32):
        raise TypeError(f"gemm: out must be {dt} or float32 (float32 when split), got {out.dtype}")
    if bias is not None:
        _require(bias, "bias", (n,), torch.float32, dev)
    for name, t in (("aux", aux), ("gate", gate)):
        if t is not None:
            _require(t, name, (m, n), dt, dev)
    if resid is not None:
        _require(resid, "resid", (m, n), torch.float32, dev)
    if colpart is not None:
        _require(colpart, "colpart", (-(-m // 128), n), torch.float32, dev)
    if (gate is None) != (gate_kind is None):
        raise ValueError("gemm: gate and gate_kind go together")
    with torch.cuda.device(dev):
        rc = kernels()["gemm.cu"].fm_gemm(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, _LAYOUTS[layout], splits,
            _dtype_code(a), int(out.dtype == torch.float32), _ptr(bias), ACT_CODES[activation],
            *dropout, _ptr(aux), _ptr(gate), _GATE_CODES[gate_kind], float(gate_scale),
            _ptr(resid), _ptr(colpart), _stream(a))
    _check(rc, "fm_gemm")
    return out


def colsum(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out[n] = sum_m x[m, n]`` in a fixed order (x fp32 [M, N], out [N]
    fp32 or bf16): the deterministic reduction of every partial sum."""
    m, n = x.shape
    _require(x, "x", (m, n), torch.float32, x.device)
    _require(out, "out", (n,), out.dtype, x.device)
    _dtype_code(out)
    with torch.cuda.device(x.device):
        rc = kernels()["gemm.cu"].fm_colsum(x.data_ptr(), out.data_ptr(), m, n,
                                             int(out.dtype == torch.bfloat16), _stream(x))
    _check(rc, "fm_colsum")
    return out


#: Rows of a :func:`row_block_sums` block (its partials have ceil(M / 128) rows).
SUM_ROWS = 128


def row_block_sums(x: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """``part[i, n] = sum of x[m, n]`` over rows 128 i .. 128 i + 127, in a
    fixed order (x [M, N] io dtype, N % 8 == 0; part [ceil(M / 128), N]
    fp32): the first pass of a column sum over an io-dtype matrix, whose
    second is :func:`colsum` over ``part``."""
    m, n = x.shape
    if n % 8:
        raise ValueError(f"row_block_sums: N={n} must be a multiple of 8")
    _require(x, "x", (m, n), x.dtype, x.device)
    _require(part, "part", (-(-m // SUM_ROWS), n), torch.float32, x.device)
    with torch.cuda.device(x.device):
        rc = kernels()["gemm.cu"].fm_row_block_sums(x.data_ptr(), part.data_ptr(), m, n,
                                                     _dtype_code(x), _stream(x))
    _check(rc, "fm_row_block_sums")
    return part


def _require_heads(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    """A [B, heads, S, d] operand: any batch / head / row strides, the last
    dim contiguous."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dim must be contiguous, got strides {t.stride()}")


def _strides(t: torch.Tensor):
    return (_L * 3)(*t.stride()[:3])


def _check_flash_operands(q, k, v, mask):
    b, nh, s, d = q.shape
    if d > 128:
        raise ValueError(f"flash attention: head dim {d} > 128")
    _dtype_code(q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require_heads(t, name, q.shape, q.dtype, q.device)
    if mask is not None:
        _require(mask, "mask", (b, s), torch.int32, q.device)
    return b, nh, s, d


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor], o: torch.Tensor,
                        stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked attention (Pallas #9) over strided q, k, v into o, all
    [B, heads, S, d] with the last dim contiguous (any other strides);
    mask [B, S] int32 contiguous, or None for every key; with ``stats``
    [B, heads, S, 2] fp32 also each row's softmax max and sum."""
    b, nh, s, d = _check_flash_operands(q, k, v, mask)
    _require_heads(o, "o", q.shape, q.dtype, q.device)
    if stats is not None:
        _require(stats, "stats", (b, nh, s, 2), torch.float32, q.device)
    with torch.cuda.device(q.device):
        rc = kernels()["flash_attention.cu"].fm_flash_attention_fwd(
            q.data_ptr(), _strides(q), k.data_ptr(), _strides(k), v.data_ptr(), _strides(v),
            _ptr(mask), s, o.data_ptr(), _strides(o), _ptr(stats), b, s, nh, d,
            1.0 / (d ** 0.5), _dtype_code(q), _stream(q))
    _check(rc, "fm_flash_attention_fwd")
    return o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        dout: torch.Tensor, mask: Optional[torch.Tensor], stats: torch.Tensor,
                        rowterm: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor,
                        dv: torch.Tensor, colpart: Optional[torch.Tensor] = None) -> None:
    """Backward of :func:`flash_attention_fwd` (Pallas #10, two launches):
    dq, dk, dv (strided as q, io dtype) from q, k, v, o, dout and the
    forward's stats; rowterm [B, heads, S] fp32 is scratch.  With
    ``colpart`` [:func:`flash_bwd_colpart_rows`, 3 * heads * d] fp32 also
    the column partials of the fp32 dq | dk | dv over each tile's rows (the
    bias grads of the half-layer kernels)."""
    b, nh, s, d = _check_flash_operands(q, k, v, mask)
    for name, t in (("o", o), ("dout", dout), ("dq", dq), ("dk", dk), ("dv", dv)):
        _require_heads(t, name, q.shape, q.dtype, q.device)
    _require(stats, "stats", (b, nh, s, 2), torch.float32, q.device)
    _require(rowterm, "rowterm", (b, nh, s), torch.float32, q.device)
    if colpart is not None:
        _require(colpart, "colpart", (flash_bwd_colpart_rows(b, s, q.dtype), 3 * nh * d),
                 torch.float32, q.device)
    with torch.cuda.device(q.device):
        rc = kernels()["flash_attention.cu"].fm_flash_attention_bwd(
            q.data_ptr(), _strides(q), k.data_ptr(), _strides(k), v.data_ptr(), _strides(v),
            o.data_ptr(), _strides(o), dout.data_ptr(), _strides(dout), _ptr(mask), s,
            stats.data_ptr(), rowterm.data_ptr(), dq.data_ptr(), _strides(dq), dk.data_ptr(),
            _strides(dk), dv.data_ptr(), _strides(dv), _ptr(colpart), b, s, nh, d,
            1.0 / (d ** 0.5), _dtype_code(q), _stream(q))
    _check(rc, "fm_flash_attention_bwd")


def _packed_heads(t: torch.Tensor, num_heads: int, n: int = 1):
    """The head views of a packed [B, S, n * H] buffer: n [B, heads, S, d]
    views of its H-column blocks (head h at column h*d of each)."""
    b, s, w = t.shape
    return [x.transpose(1, 2)
            for x in t.view(b, s, n, num_heads, w // (n * num_heads)).unbind(2)]


def flash_attn_fwd(qkv: torch.Tensor, mask: torch.Tensor, out: torch.Tensor,
                   num_heads: int, stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`flash_attention_fwd` over the packed layout of the half-layer
    kernels: qkv [B, S, 3H] (q | k | v column blocks, head h at column h*d
    of each) into out [B, S, H]."""
    b, s, h3 = qkv.shape
    if h3 % 3 or (h3 // 3) % num_heads:
        raise ValueError(f"attention: 3H={h3} does not split into 3 x {num_heads} heads")
    _require(qkv, "qkv", (b, s, h3), qkv.dtype, qkv.device)
    _require(out, "out", (b, s, h3 // 3), qkv.dtype, qkv.device)
    q, k, v = _packed_heads(qkv, num_heads, 3)
    flash_attention_fwd(q, k, v, mask, *_packed_heads(out, num_heads), stats)
    return out


def flash_attn_bwd(qkv: torch.Tensor, o: torch.Tensor, dout: torch.Tensor, mask: torch.Tensor,
                   stats: torch.Tensor, rowterm: torch.Tensor, dqkv: torch.Tensor,
                   colpart: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Backward of :func:`flash_attn_fwd` (two launches): dqkv [B, S, 3H]
    (io dtype) from qkv, o, dout [B, S, H] and the forward's stats;
    rowterm [B, heads, S] fp32 is scratch, colpart [B * ceil(S / tile), 3H]
    fp32 receives the column partials of the fp32 dq | dk | dv."""
    for name, t in (("qkv", qkv), ("o", o), ("dout", dout), ("dqkv", dqkv)):
        _require(t, name, t.shape, qkv.dtype, qkv.device)
    if dqkv.shape != qkv.shape:
        raise ValueError(f"dqkv: expected shape {tuple(qkv.shape)}, got {tuple(dqkv.shape)}")
    q, k, v = _packed_heads(qkv, num_heads, 3)
    dq, dk, dv = _packed_heads(dqkv, num_heads, 3)
    flash_attention_bwd(q, k, v, *_packed_heads(o, num_heads), *_packed_heads(dout, num_heads),
                        mask, stats, rowterm, dq, dk, dv, colpart=colpart)
    return dqkv


def _check_ln_width(h: int) -> None:
    if h % 8 or h > 1024:
        raise ValueError(f"layernorm: H={h} must be a multiple of 8 and at most 1024")


def add_layernorm(x: torch.Tensor, y: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, out: torch.Tensor, eps: float,
                  dropout: Dropout = Dropout(), z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out = LN(z)``, ``z = round(x + dropout(y))``: x, out [R, H] io dtype;
    y [R, H] fp32 or io dtype; z [R, H] io dtype is stored when given.
    H % 8 == 0, H <= 1024."""
    r, h = x.shape
    _check_ln_width(h)
    _require(x, "x", (r, h), x.dtype, x.device)
    if y.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"y: expected float32 or {x.dtype}, got {y.dtype}")
    _require(y, "y", (r, h), y.dtype, x.device)
    _require(gamma, "gamma", (h,), torch.float32, x.device)
    _require(beta, "beta", (h,), torch.float32, x.device)
    _require(out, "out", (r, h), x.dtype, x.device)
    if z is not None:
        _require(z, "z", (r, h), x.dtype, x.device)
    with torch.cuda.device(x.device):
        rc = kernels()["add_layernorm.cu"].fm_add_layernorm(
            x.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            _ptr(z), r, h, float(eps), *dropout, _dtype_code(x),
            int(y.dtype != torch.float32), _stream(x))
    _check(rc, "fm_add_layernorm")
    return out


#: Rows of a LayerNorm-backward block (its partials have ceil(R / 64) rows).
LN_BWD_ROWS = 64


def layernorm_bwd(g: torch.Tensor, z: torch.Tensor, gamma: torch.Tensor, dz: torch.Tensor,
                  da: torch.Tensor, part: torch.Tensor, eps: float,
                  dropout: Dropout = Dropout()) -> torch.Tensor:
    """LayerNorm VJP from the stored z: dz [R, H] fp32 (or the io dtype, for
    the residual branch of an unfolded half-layer), da = round(replay(dz))
    [R, H] io dtype, and part [3, ceil(R / 64), H] fp32 block partials of
    (g * xhat, g, replay(dz)) for dgamma, dbeta and the bias grad."""
    r, h = g.shape
    _check_ln_width(h)
    dev, dt = g.device, g.dtype
    _require(g, "g", (r, h), dt, dev)
    _require(z, "z", (r, h), dt, dev)
    _require(gamma, "gamma", (h,), torch.float32, dev)
    if dz.dtype not in (torch.float32, dt):
        raise TypeError(f"dz: expected float32 or {dt}, got {dz.dtype}")
    _require(dz, "dz", (r, h), dz.dtype, dev)
    _require(da, "da", (r, h), dt, dev)
    _require(part, "part", (3, -(-r // LN_BWD_ROWS), h), torch.float32, dev)
    with torch.cuda.device(dev):
        rc = kernels()["add_layernorm.cu"].fm_layernorm_bwd(
            g.data_ptr(), z.data_ptr(), gamma.data_ptr(), dz.data_ptr(), da.data_ptr(),
            part.data_ptr(), r, h, float(eps), *dropout, _dtype_code(g),
            int(dz.dtype != torch.float32), _stream(g))
    _check(rc, "fm_layernorm_bwd")
    return da
