"""Attention half-layer kernels on the card, LayerNorm-fused and unfolded.

Port of ``fairmultimodal_tpu/ops/fused_attention_block.py``, two kernel pairs:

- ``fused_attention_block_ln`` / ``fused_attention_block_ln_infer``:
  ``LayerNorm(x + dropout(attn_block(x)))``, the forward Pallas kernel
  ``_mega_ln_fwd_kernel`` (with the output dropout) and the backward kernel
  ``_mega_ln_bwd_kernel``;
- ``fused_attention_block``: ``attn_block(x) = concat_h(softmax(q k^T /
  sqrt(d) + mask) v) Wo + bo`` alone, rounded to the io dtype, no dropout and
  no LayerNorm: ``_mega_fwd_kernel`` / ``_mega_bwd_kernel``, which the JAX
  encoder layer runs with ``fold_ln=False`` and follows with XLA dropout +
  residual + LayerNorm (here :mod:`~fairmultimodal_torch.ops.dropout_add_layernorm`).

On a CUDA tensor both forwards start with the same hand-written launches
(``csrc/``): the q/k/v projections as one GEMM into a [B, S, 3H] buffer, and
flash attention over it (writing each row's softmax max and sum when the
backward will need them).  The LN-fused forward then runs the output
projection into fp32 and the residual + dropout + LayerNorm row kernel
(storing z); the unfolded one runs the output projection with its bias,
rounded to the io dtype, as ``_mega_fwd_kernel`` rounds ``out``.

With grad enabled each call is a :class:`torch.autograd.Function`.  Both
backwards share ``dO = da . Wo``, ``dWo = da^T . o``, the two flash-backward
kernels into one [B, S, 3H] ``dqkv`` buffer, its bias-grad column sums and
``dWqkv = dqkv^T . x``.  In :func:`backward_stages` ``da`` comes from the
LayerNorm-backward row kernel (dz, the replayed dropout, partial sums) and
``dx = dz + dqkv . Wqkv``; in :func:`block_backward_stages` ``da`` is the
cotangent g itself, ``dx = dqkv . Wqkv`` is a plain store and ``dbo`` a
fixed-order column sum of g.  No float atomics anywhere: a step gives the
same bits twice.

On a CPU tensor the wrappers run the plain versions
(``*_reference`` / ``*_backward_reference``), which round where the TPU
kernels round.  Dropout is Philox (``utils/rng.py``, stream 0 of ``seed``)
in both, so the two draw the same mask.

Weights take nn.Linear's [H_out, H_in] layout; ``ln_eps`` has no default
(lab encoder 1e-5, BERT 1e-12).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from fairmultimodal_torch.ops import _build
from fairmultimodal_torch.utils.rng import Dropout, apply_dropout

__all__ = ["fused_attention_block_ln", "fused_attention_block_ln_infer",
           "fused_attention_block_ln_reference", "fused_attention_block_ln_backward_reference",
           "half_layer_stages", "backward_stages", "fused_attention_block",
           "fused_attention_block_reference", "fused_attention_block_backward_reference",
           "block_stages", "block_backward_stages", "weight_grad", "column_sum"]

NEG_INF = -1e9
_STREAM = 0             # Philox stream of the output dropout

#: LN-fused forward launches (Pallas #1) on CUDA tensors since the last reset (one per half-layer).
launches = 0
#: LN-fused backward launches (Pallas #3) on CUDA tensors since the last reset.
bwd_launches = 0
#: Unfolded forward launches (Pallas #5) on CUDA tensors since the last reset.
unfolded_launches = 0
#: Unfolded backward launches (Pallas #6) on CUDA tensors since the last reset.
unfolded_bwd_launches = 0


def _layer_norm_rows(z32: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float) -> torch.Tensor:
    mu = z32.mean(dim=-1, keepdim=True)
    var = ((z32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return (z32 - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()


def _layer_norm_vjp(g32: torch.Tensor, z: torch.Tensor, gamma: torch.Tensor, eps: float):
    """LN VJP from the stored z (TPU ``_ln_bwd_math``): (dz, dgamma, dbeta),
    fp32, over the last axis of [R, H]."""
    zz = z.float()
    mu = zz.mean(dim=-1, keepdim=True)
    var = ((zz - mu) ** 2).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (zz - mu) * rstd
    gg = g32 * gamma.float()
    m1 = gg.mean(dim=-1, keepdim=True)
    m2 = (gg * xhat).mean(dim=-1, keepdim=True)
    dz = rstd * (gg - m1 - xhat * m2)
    return dz, (g32 * xhat).sum(dim=0), g32.sum(dim=0)


def _dropout(seed: Optional[int], rate: float, deterministic: bool) -> Dropout:
    if deterministic or rate <= 0.0:
        return Dropout()
    if seed is None:
        raise ValueError("dropout (deterministic=False, rate > 0) needs a seed")
    return Dropout.make(seed, _STREAM, rate)


def _key_bias(mask: Optional[torch.Tensor], b: int, s: int, device) -> torch.Tensor:
    if mask is None:
        return torch.zeros((b, 1, 1, s), device=device)
    return torch.where(mask[:, None, None, :] > 0, 0.0, NEG_INF).to(device)


def _attention_core(x, wq, bq, wk, bk, wv, bv, mask, num_heads):
    """The part both forwards share, rounding where the TPU kernels round
    (q/k/v after the bias, p before p.v, o): returns qkv [B, S, 3H] and o
    [B, S, H] in ``x.dtype``."""
    dt = x.dtype
    b, s, h = x.shape
    d = h // num_heads
    x32 = x.float()
    qkv = torch.cat([(x32 @ w.float().t() + bias.float()).to(dt)
                     for w, bias in ((wq, bq), (wk, bk), (wv, bv))], dim=-1)
    q, k, v = (t.reshape(b, s, num_heads, d).transpose(1, 2).float()
               for t in qkv.split(h, dim=-1))
    scores = (q @ k.transpose(-1, -2)) * (1.0 / d ** 0.5) + _key_bias(mask, b, s, x.device)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(dt)
    o = (p.float() @ v).to(dt).transpose(1, 2).reshape(b, s, h)
    return qkv, o


def _forward_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, mask, num_heads,
                       ln_eps, drop):
    dt = x.dtype
    qkv, o = _attention_core(x, wq, bq, wk, bk, wv, bv, mask, num_heads)
    y = apply_dropout(o.float() @ wo.float().t() + bo.float(), drop)
    z = (x.float() + y).to(dt)
    out = _layer_norm_rows(z.float(), gamma, beta, ln_eps).to(dt)
    return out, {"qkv": qkv, "o": o, "z": z}


def _block_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, mask, num_heads):
    qkv, o = _attention_core(x, wq, bq, wk, bk, wv, bv, mask, num_heads)
    out = (o.float() @ wo.float().t() + bo.float()).to(x.dtype)
    return out, {"qkv": qkv, "o": o}


def fused_attention_block_ln_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta,
                                       mask: Optional[torch.Tensor] = None, *,
                                       num_heads: int, ln_eps: float, rate: float = 0.0,
                                       seed: Optional[int] = None,
                                       return_residuals: bool = False):
    """Plain PyTorch version of the forward kernel, rounding where the TPU
    kernel rounds: q/k/v after the bias, p before p.v, o before Wo, z before
    the LayerNorm statistics; the output dropout (Philox ``seed``, stream 0,
    flat index over [B*S, H]) on the fp32 projection.  x [B, S, H]; returns
    [B, S, H] in ``x.dtype`` (and, with ``return_residuals``, the dict of
    qkv, o, z the plain backward takes).  Differentiable by autograd."""
    drop = Dropout.make(seed, _STREAM, rate)
    out, res = _forward_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, mask,
                                  num_heads, ln_eps, drop)
    return (out, res) if return_residuals else out


def fused_attention_block_reference(x, wq, bq, wk, bk, wv, bv, wo, bo,
                                    mask: Optional[torch.Tensor] = None, *, num_heads: int,
                                    return_residuals: bool = False):
    """Plain PyTorch version of ``_mega_fwd_kernel``: the attention block
    rounded where it rounds (q/k/v after the bias, p before p.v, o before Wo,
    ``out`` after the fp32 ``o . Wo + bo``).  x [B, S, H]; returns [B, S, H]
    in ``x.dtype`` (and, with ``return_residuals``, the dict of qkv, o the
    plain backward takes).  Differentiable by autograd."""
    out, res = _block_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, mask, num_heads)
    return (out, res) if return_residuals else out


def fused_attention_block_ln_backward_reference(g, x, qkv, o, z, wq, wk, wv, wo, gamma,
                                                mask: Optional[torch.Tensor] = None, *,
                                                num_heads: int, ln_eps: float,
                                                rate: float = 0.0, seed: Optional[int] = None):
    """Plain PyTorch version of the backward kernel from the forward's
    residuals (qkv [B, S, 3H], o, z [B, S, H], io dtype), rounding where
    ``_mega_ln_bwd_kernel`` rounds: ``da`` before dO and dWo, dO, p before
    dV, ``ds * scale`` before dQ and dK, dq/dk/dv before the weight grads
    and dx; bias grads are sums of the fp32 values before rounding; weight
    and bias grads are accumulated in fp32 and cast to ``x.dtype``, gamma /
    beta grads to ``gamma.dtype``.  The row term of the softmax VJP is
    rowsum(dP * P), as the TPU kernel takes it.

    Returns (dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo, dgamma, dbeta)."""
    return _backward_reference(g, x, qkv, o, z, wq, wk, wv, wo, gamma, mask, num_heads,
                               ln_eps, Dropout.make(seed, _STREAM, rate))


def fused_attention_block_backward_reference(g, x, qkv, o, wq, wk, wv, wo,
                                             mask: Optional[torch.Tensor] = None, *,
                                             num_heads: int):
    """Plain PyTorch version of ``_mega_bwd_kernel`` from the cotangent g
    [B, S, H] and the forward's residuals (qkv, o), rounding where it rounds
    (``fused_attention_block.py:250-363``): dO, p before dV, ``ds * scale``,
    dq/dk/dv before dx and the weight grads, dx; dbq/dbk/dbv summed from the
    fp32 dq/dk/dv and dbo from g in fp32; every grad cast to ``x.dtype``
    (``:469-489``).  Row term rowsum(dP * P) as the TPU kernel.

    Returns (dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo)."""
    return _block_backward_reference(g, x, qkv, o, wq, wk, wv, wo, mask, num_heads)


def _core_backward(da, x, qkv, o, wq, wk, wv, wo, mask, num_heads):
    """The part both backwards share, from ``da`` [R, H] (fp32 holding
    io-dtype values, the cotangent of the output projection): returns the
    fp32 ``dqkv . Wqkv`` [R, H] and (dwq, dbq, dwk, dbk, dwv, dbv, dwo) in
    ``x.dtype``."""
    dt = x.dtype
    b, s, h = x.shape
    d = h // num_heads
    scale = 1.0 / d ** 0.5
    o2 = o.reshape(-1, h).float()
    dout = (da @ wo.float()).to(dt)
    dwo = da.t() @ o2

    def heads(t):
        return t.reshape(b, s, num_heads, d).transpose(1, 2).float()

    q, k, v = (heads(t) for t in qkv.split(h, dim=-1))
    do = heads(dout)
    scores = (q @ k.transpose(-1, -2)) * scale + _key_bias(mask, b, s, x.device)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = p.to(dt).float().transpose(-1, -2) @ do
    dpm = do @ v.transpose(-1, -2)
    ds = p * (dpm - (dpm * p).sum(dim=-1, keepdim=True))
    ds_b = (ds * scale).to(dt).float()
    dq = ds_b @ k
    dk = ds_b.transpose(-1, -2) @ q
    merge = lambda t: t.transpose(1, 2).reshape(b * s, h)           # noqa: E731
    dqkv32 = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)   # [R, 3H]
    dbqkv = dqkv32.sum(dim=0)
    dqkv = dqkv32.to(dt).float()
    w_qkv = torch.cat((wq, wk, wv)).float()
    dwqkv = (dqkv.t() @ x.reshape(-1, h).float()).to(dt)
    dwq, dwk, dwv = dwqkv.split(h)
    dbq, dbk, dbv = dbqkv.to(dt).split(h)
    return dqkv @ w_qkv, (dwq, dbq, dwk, dbk, dwv, dbv, dwo.to(dt))


def _backward_reference(g, x, qkv, o, z, wq, wk, wv, wo, gamma, mask, num_heads, ln_eps,
                        drop):
    dt = x.dtype
    h = x.shape[-1]
    dz, dgamma, dbeta = _layer_norm_vjp(g.reshape(-1, h).float(), z.reshape(-1, h), gamma,
                                        ln_eps)
    dattn = apply_dropout(dz, drop)
    dx32, grads = _core_backward(dattn.to(dt).float(), x, qkv, o, wq, wk, wv, wo, mask,
                                 num_heads)
    dx = (dz + dx32).to(dt).view(x.shape)
    return (dx, *grads, dattn.sum(dim=0).to(dt), dgamma.to(gamma.dtype),
            dbeta.to(gamma.dtype))


def _block_backward_reference(g, x, qkv, o, wq, wk, wv, wo, mask, num_heads):
    dt = x.dtype
    g32 = g.reshape(-1, x.shape[-1]).to(dt).float()
    dx32, grads = _core_backward(g32, x, qkv, o, wq, wk, wv, wo, mask, num_heads)
    return (dx32.to(dt).view(x.shape), *grads, g32.sum(dim=0).to(dt))


# -- the CUDA path ----------------------------------------------------------------------


def _check_operands(x, num_heads, weights):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, H], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    h = x.shape[-1]
    if h % num_heads:
        raise ValueError(f"H={h} is not a multiple of num_heads={num_heads}")
    for name, w in weights:
        if tuple(w.shape) != (h, h) or w.dtype != x.dtype or w.device != x.device:
            raise ValueError(f"{name}: expected [{h}, {h}] {x.dtype} on {x.device}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _core_stages(x, wq, bq, wk, bk, wv, bv, wo, mask, num_heads, residuals):
    """Check the operands and lay out the launches both forwards start
    with (the QKV GEMM, the flash forward); returns ``(stages, o, saved)``
    with ``saved`` the backward's residuals (x, qkv, o, stats, mask, w_qkv)
    when ``residuals`` (else None)."""
    _check_operands(x, num_heads, (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)))
    b, s, h = x.shape
    dev = x.device
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    mask = mask.to(device=dev, dtype=torch.int32).contiguous()
    w_qkv = torch.cat((wq, wk, wv))                                   # [3H, H]
    b_qkv = _f32(torch.cat((bq, bk, bv)))
    qkv = torch.empty((b, s, 3 * h), dtype=x.dtype, device=dev)
    o = torch.empty((b, s, h), dtype=x.dtype, device=dev)
    stats = torch.empty((b, num_heads, s, 2), dtype=torch.float32, device=dev) \
        if residuals else None
    stages = [
        ("qkv_gemm", lambda: _build.gemm(x.view(b * s, h), w_qkv, qkv.view(b * s, 3 * h),
                                         bias=b_qkv)),
        ("flash_attn_fwd", lambda: _build.flash_attn_fwd(qkv, mask, o, num_heads, stats)),
    ]
    saved = {"x": x, "qkv": qkv, "o": o, "stats": stats, "mask": mask,
             "w_qkv": w_qkv} if residuals else None
    return stages, o, saved


def half_layer_stages(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, mask, *,
                      num_heads: int, ln_eps: float, dropout: Dropout = Dropout(),
                      residuals: bool = False):
    """Check the operands of the LN-fused CUDA forward and lay out its
    kernel launches: returns ``(stages, out, saved)``, the launches in order
    as ``(name, thunk)`` pairs, the [B, S, H] tensor the last one fills and,
    with ``residuals``, the tensors :func:`backward_stages` needs (else
    None).  Each thunk can be run again on its own (``chip_smoke.py`` times
    them one by one); running them all in order is one half-layer."""
    stages, o, saved = _core_stages(x, wq, bq, wk, bk, wv, bv, wo, mask, num_heads, residuals)
    b, s, h = x.shape
    x2 = x.view(b * s, h)
    y = torch.empty((b * s, h), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    z = torch.empty_like(x) if residuals else None
    wo, bo, gamma, beta = wo.contiguous(), _f32(bo), _f32(gamma), _f32(beta)
    stages += [
        ("wo_gemm", lambda: _build.gemm(o.view(b * s, h), wo, y, bias=bo)),
        ("add_layernorm", lambda: _build.add_layernorm(
            x2, y, gamma, beta, out.view(b * s, h), ln_eps, dropout,
            None if z is None else z.view(b * s, h))),
    ]
    if residuals:
        saved["z"] = z
    return stages, out, saved


def block_stages(x, wq, bq, wk, bk, wv, bv, wo, bo, mask, *, num_heads: int,
                 residuals: bool = False):
    """Lay out the unfolded CUDA forward (Pallas #5) as
    :func:`half_layer_stages` does: the QKV GEMM, the flash forward and the
    Wo GEMM with its bias into the io dtype; with ``residuals`` the tensors
    :func:`block_backward_stages` needs."""
    stages, o, saved = _core_stages(x, wq, bq, wk, bk, wv, bv, wo, mask, num_heads, residuals)
    b, s, h = x.shape
    out = torch.empty_like(x)
    wo, bo = wo.contiguous(), _f32(bo)
    stages.append(("wo_gemm", lambda: _build.gemm(o.view(b * s, h), wo, out.view(b * s, h),
                                                  bias=bo)))
    return stages, out, saved


def _splits(m: int, n: int, k: int, sms: int) -> int:
    """K splits of a weight-grad GEMM over the wgmma GEMM's tiles
    (``_build.WGMMA_TILE``, one block per SM at a time on a card of ``sms``
    SMs): the count, at most three waves of blocks and at least 2048 rows
    each, whose blocks fill their waves best (time ~ waves / splits), the
    smallest within 5% of the best (fewer fp32 partials to add)."""
    tile_m, tile_n = _build.WGMMA_TILE
    tiles = -(-m // tile_m) * -(-n // tile_n)
    cap = max(1, min(3 * sms // tiles, k // 2048))
    cost = {s: -(-tiles * s // sms) / s for s in range(1, cap + 1)}
    best = min(cost.values())
    return min(s for s, c in cost.items() if c <= 1.05 * best)


def weight_grad(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out = a^T . b`` (a [K, M], b [K, N]) through the split-K "tn" GEMM
    and a fixed-order sum of the split partials."""
    k, m = a.shape
    n = b.shape[1]
    splits = _splits(m, n, k, torch.cuda.get_device_properties(a.device).multi_processor_count)
    if splits == 1:
        return _build.gemm(a, b, out, layout="tn")
    part = torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
    _build.gemm(a, b, part, layout="tn", splits=splits)
    _build.colsum(part.view(splits, m * n), out.view(m * n))
    return out


def column_sum(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out[n] = sum_m x[m, n]`` of an io-dtype x [M, N] in fp32 and a
    fixed order (per-128-row partials, then their column sums), written in
    ``out.dtype``: the bias grads taken from a cotangent."""
    m, n = x.shape
    part = torch.empty((-(-m // _build.SUM_ROWS), n), dtype=torch.float32, device=x.device)
    _build.row_block_sums(x, part)
    return _build.colsum(part, out)


def _core_backward_stages(da, saved, wo, num_heads):
    """The launches both backwards share, from ``da`` [R, H] (io dtype):
    dO, dWo, the flash backward, its bias-grad sum and dWqkv.  Returns
    ``(stages, dqkv, grads)`` with grads (dwq, dbq, dwk, dbk, dwv, dbv, dwo)
    -- views of one [3H, H] and one [3H] buffer for q | k | v."""
    x, qkv, o, stats, mask = (saved[k] for k in ("x", "qkv", "o", "stats", "mask"))
    b, s, h = x.shape
    r, dev, dt = b * s, x.device, x.dtype
    f32 = dict(dtype=torch.float32, device=dev)
    dout = torch.empty((b, s, h), dtype=dt, device=dev)
    rowterm = torch.empty((b, num_heads, s), **f32)
    dqkv = torch.empty((b, s, 3 * h), dtype=dt, device=dev)
    colpart = torch.empty((_build.flash_bwd_colpart_rows(b, s, dt), 3 * h), **f32)
    dwqkv = torch.empty((3 * h, h), dtype=dt, device=dev)
    dbqkv = torch.empty((3 * h,), dtype=dt, device=dev)
    dwo = torch.empty((h, h), dtype=dt, device=dev)
    stages = [
        ("do_gemm", lambda: _build.gemm(da, wo.contiguous(), dout.view(r, h), layout="nn")),
        ("dwo_gemm", lambda: weight_grad(da, o.view(r, h), dwo)),
        ("flash_attn_bwd", lambda: _build.flash_attn_bwd(qkv, o, dout, mask, stats, rowterm,
                                                         dqkv, colpart, num_heads)),
        ("dbqkv_sum", lambda: _build.colsum(colpart, dbqkv)),
        ("dwqkv_gemm", lambda: weight_grad(dqkv.view(r, 3 * h), x.view(r, h), dwqkv)),
    ]
    dwq, dwk, dwv = dwqkv.split(h)
    dbq, dbk, dbv = dbqkv.split(h)
    return stages, dqkv, (dwq, dbq, dwk, dbk, dwv, dbv, dwo)


def backward_stages(g, saved: Dict[str, torch.Tensor], wo, gamma, *, num_heads: int,
                    ln_eps: float, dropout: Dropout = Dropout()):
    """Lay out the LN-fused CUDA backward's launches (as
    :func:`half_layer_stages`): returns ``(stages, grads)`` with grads (dx,
    dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo, dgamma, dbeta), filled when the
    stages have run; dwq/dwk/dwv are views of one [3H, H] buffer and
    dbq/dbk/dbv of one [3H]."""
    x, z = saved["x"], saved["z"]
    b, s, h = x.shape
    r, dev, dt = b * s, x.device, x.dtype
    f32 = dict(dtype=torch.float32, device=dev)
    g2 = g.reshape(r, h).to(dt).contiguous()
    gamma = _f32(gamma)
    dz = torch.empty((r, h), **f32)
    da = torch.empty((r, h), dtype=dt, device=dev)
    part = torch.empty((3, -(-r // _build.LN_BWD_ROWS), h), **f32)
    dx = torch.empty_like(x)
    dbo = torch.empty((h,), dtype=dt, device=dev)
    dgamma = torch.empty((h,), **f32)
    dbeta = torch.empty((h,), **f32)
    core, dqkv, grads = _core_backward_stages(da, saved, wo, num_heads)

    def ln_sums():
        for i, dst in enumerate((dgamma, dbeta, dbo)):
            _build.colsum(part[i], dst)

    stages = [
        ("layernorm_bwd", lambda: _build.layernorm_bwd(g2, z.view(r, h), gamma, dz, da, part,
                                                        ln_eps, dropout)),
        ("ln_bias_sums", ln_sums),
        *core,
        ("dx_gemm", lambda: _build.gemm(dqkv.view(r, 3 * h), saved["w_qkv"], dx.view(r, h),
                                        layout="nn", resid=dz)),
    ]
    return stages, (dx, *grads, dbo, dgamma, dbeta)


def block_backward_stages(g, saved: Dict[str, torch.Tensor], wo, *, num_heads: int):
    """Lay out the unfolded CUDA backward (Pallas #6) from the cotangent g
    [B, S, H]: returns ``(stages, grads)`` with grads (dx, dwq, dbq, dwk,
    dbk, dwv, dbv, dwo, dbo) in the io dtype, filled when the stages have
    run."""
    x = saved["x"]
    b, s, h = x.shape
    r, dev, dt = b * s, x.device, x.dtype
    g2 = g.reshape(r, h).to(dt).contiguous()
    dx = torch.empty_like(x)
    dbo = torch.empty((h,), dtype=dt, device=dev)
    core, dqkv, grads = _core_backward_stages(g2, saved, wo, num_heads)
    stages = [
        *core,
        ("dx_gemm", lambda: _build.gemm(dqkv.view(r, 3 * h), saved["w_qkv"], dx.view(r, h),
                                        layout="nn")),
        ("dbo_sum", lambda: column_sum(g2, dbo)),
    ]
    return stages, (dx, *grads, dbo)


def _run(stages) -> None:
    for _, fn in stages:
        fn()


class _HalfLayer(torch.autograd.Function):
    """LN-fused forward with residuals + backward; the kernels on CUDA
    tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, mask, drop, num_heads,
                ln_eps):
        global launches
        ctx.num_heads, ctx.ln_eps, ctx.drop = num_heads, ln_eps, drop
        ctx.param_dtype = gamma.dtype
        if x.is_cuda:
            stages, out, saved = half_layer_stages(
                x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, mask, num_heads=num_heads,
                ln_eps=ln_eps, dropout=drop, residuals=True)
            _run(stages)
            launches += 1
            ctx.cuda, ctx.keys = True, tuple(saved)
            ctx.save_for_backward(*saved.values(), wo, gamma)
            return out
        out, res = _forward_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, mask,
                                      num_heads, ln_eps, drop)
        ctx.cuda = False
        ctx.save_for_backward(x, res["qkv"], res["o"], res["z"], wq, wk, wv, wo, gamma, mask)
        return out

    @staticmethod
    def backward(ctx, g):
        global bwd_launches
        if ctx.cuda:
            *vals, wo, gamma = ctx.saved_tensors
            stages, grads = backward_stages(g, dict(zip(ctx.keys, vals)), wo, gamma,
                                            num_heads=ctx.num_heads, ln_eps=ctx.ln_eps,
                                            dropout=ctx.drop)
            _run(stages)
            bwd_launches += 1
            dgamma, dbeta = (t.to(ctx.param_dtype) for t in grads[-2:])
            grads = grads[:-2] + (dgamma, dbeta)
        else:
            grads = _backward_reference(g, *ctx.saved_tensors, ctx.num_heads, ctx.ln_eps,
                                        ctx.drop)
        return (*grads, None, None, None, None)


class _Block(torch.autograd.Function):
    """Unfolded forward with residuals + backward (Pallas #5 / #6); the
    kernels on CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, wq, bq, wk, bk, wv, bv, wo, bo, mask, num_heads):
        global unfolded_launches
        ctx.num_heads = num_heads
        ctx.cuda = x.is_cuda
        if x.is_cuda:
            stages, out, saved = block_stages(x, wq, bq, wk, bk, wv, bv, wo, bo, mask,
                                              num_heads=num_heads, residuals=True)
            _run(stages)
            unfolded_launches += 1
            ctx.keys = tuple(saved)
            ctx.save_for_backward(*saved.values(), wo)
            return out
        out, res = _block_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, mask, num_heads)
        ctx.save_for_backward(x, res["qkv"], res["o"], wq, wk, wv, wo, mask)
        return out

    @staticmethod
    def backward(ctx, g):
        global unfolded_bwd_launches
        if ctx.cuda:
            *vals, wo = ctx.saved_tensors
            stages, grads = block_backward_stages(g, dict(zip(ctx.keys, vals)), wo,
                                                  num_heads=ctx.num_heads)
            _run(stages)
            unfolded_bwd_launches += 1
        else:
            grads = _block_backward_reference(g, *ctx.saved_tensors, ctx.num_heads)
        return (*grads, None, None)


def _infer(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, mask, num_heads, ln_eps, drop):
    global launches
    if not x.is_cuda:
        return _forward_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, mask,
                                  num_heads, ln_eps, drop)[0]
    stages, out, _ = half_layer_stages(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, mask,
                                       num_heads=num_heads, ln_eps=ln_eps, dropout=drop)
    _run(stages)
    launches += 1
    return out


def fused_attention_block_ln(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta,
                             mask: Optional[torch.Tensor] = None, *, num_heads: int,
                             ln_eps: float, rate: float = 0.1, deterministic: bool = True,
                             seed: Optional[int] = None) -> torch.Tensor:
    """Attention half-layer ``LayerNorm(x + dropout(attn_block(x)))``.

    x [B, S, H] (fp32 or bf16); weights [H_out, H_in] and biases [H] in
    ``x.dtype``; gamma/beta [H]; mask [B, S] (1 = attend) or None.  With
    ``deterministic=False`` and ``rate > 0`` the output dropout draws from
    Philox ``seed`` (required).  Differentiable: with grad enabled the
    forward stores its residuals and the backward runs the backward kernels
    (their plain version on a CPU tensor).  Returns [B, S, H] in ``x.dtype``.
    """
    drop = _dropout(seed, rate, deterministic)
    args = (x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _HalfLayer.apply(*args, mask, drop, num_heads, ln_eps)
    return _infer(*args, mask, num_heads, ln_eps, drop)


def fused_attention_block_ln_infer(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta,
                                   mask: Optional[torch.Tensor] = None, *,
                                   num_heads: int, ln_eps: float) -> torch.Tensor:
    """Inference entry (the frozen text encoder's): the same math as
    :func:`fused_attention_block_ln` with dropout off, storing no residuals."""
    return _infer(x, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta, mask, num_heads, ln_eps,
                  Dropout())


def fused_attention_block(x, wq, bq, wk, bk, wv, bv, wo, bo,
                          mask: Optional[torch.Tensor] = None, *,
                          num_heads: int) -> torch.Tensor:
    """Attention block ``concat_h(softmax(q k^T / sqrt(d) + mask) v) Wo + bo``
    (the JAX ``fused_attention_block``, ``fused_attention_block.py:434``).

    x [B, S, H] (fp32 or bf16); weights [H_out, H_in] and biases [H] in
    ``x.dtype``; mask [B, S] (1 = attend) or None.  No dropout, no
    LayerNorm: the unfolded encoder layer applies both after it.
    Differentiable (Pallas #6's backward; its plain version on a CPU
    tensor).  Returns [B, S, H] in ``x.dtype``.
    """
    global unfolded_launches
    args = (x, wq, bq, wk, bk, wv, bv, wo, bo)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _Block.apply(*args, mask, num_heads)
    if not x.is_cuda:
        return _block_reference(*args, mask, num_heads)[0]
    stages, out, _ = block_stages(*args, mask, num_heads=num_heads)
    _run(stages)
    unfolded_launches += 1
    return out
