"""The bf16 flash wrapper's TMA layout rule, on the CPU.

The card's bf16 flash kernels (``flash_attention.cu``'s wgmma kernels) read
q, k, v (and o, dO in the backward) by TMA through a rank-4 map over each
operand's own strides, which needs a 16-byte aligned base and strides of a
multiple of 16 bytes.  ``_build.tma_compatible`` states that rule and
``_build.tma_operand`` copies an operand that breaks it into a contiguous
buffer with rows padded to 16 bytes.  The tests hold

- the rule on the layouts the callers pass (three [B, S, H] Dense outputs
  viewed as heads, one packed [B, S, 3H] buffer, contiguous [B, heads, S, d]
  tensors) at d 32 / 64 / 96 / 128 (read in place), and on the ones it must
  refuse (d 12 and 20 head strides, a base off 16 bytes, a zero stride);
- the copy: strides the rule takes, the same values, and the plain flash
  forward and backward on the copies equal to the originals' bit for bit;
- the launch helpers ``_build.flash_attention_fwd`` / ``_bwd`` with the
  library replaced by a recorder: in bf16 every pointer and stride the C
  entry receives for a TMA operand passes the rule, the copies hold the
  operands' values, outputs keep their own layout, and fp32 passes its
  operands untouched.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from fairmultimodal_torch.ops import _build
from fairmultimodal_torch.ops import flash_attention as t_flash

BF = torch.bfloat16


def _layout(kind, b, s, nh, d, dtype=BF, seed=0):
    g = torch.Generator().manual_seed(seed)
    H = nh * d
    if kind == "dense":
        return [torch.randn(b, s, H, generator=g).to(dtype).view(b, s, nh, d).transpose(1, 2)
                for _ in range(3)]
    if kind == "packed":
        buf = torch.randn(b, s, 3 * H, generator=g).to(dtype)
        return [t.transpose(1, 2) for t in buf.view(b, s, 3, nh, d).unbind(2)]
    return [torch.randn(b, nh, s, d, generator=g).to(dtype) for _ in range(3)]


@pytest.mark.parametrize("kind", ["dense", "packed", "contiguous"])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_the_callers_layouts_are_read_in_place(kind, d):
    for t in _layout(kind, 2, 40, 3, d):
        assert _build.tma_compatible(t)
        assert _build.tma_operand(t) is t


@pytest.mark.parametrize("kind", ["dense", "packed", "contiguous"])
@pytest.mark.parametrize("d", [12, 20])
def test_head_dims_off_16_bytes_are_copied(kind, d):
    ts = _layout(kind, 2, 40, 3, d, seed=d)
    for t in ts:
        assert not _build.tma_compatible(t)
        c = _build.tma_operand(t)
        assert _build.tma_compatible(c) and c.shape == t.shape and torch.equal(c, t)
        assert c.data_ptr() % 16 == 0 and c.stride()[2] == -(-d // 8) * 8
    q, k, v = ts
    cq, ck, cv = (_build.tma_operand(t) for t in ts)
    mask = (torch.arange(40)[None] < torch.tensor([[25], [0]])).int()
    assert torch.equal(t_flash.flash_attention_reference(cq, ck, cv, mask),
                       t_flash.flash_attention_reference(q, k, v, mask))
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(BF)
    for a, w in zip(t_flash.flash_attention_backward_reference(cq, ck, cv, mask, g),
                    t_flash.flash_attention_backward_reference(q, k, v, mask, g)):
        assert torch.equal(a, w)


def test_bases_and_strides_the_rule_refuses_or_ignores():
    x = torch.zeros(2 * 4 * 16 * 64 + 8, dtype=BF)
    off = x[1:1 + 2 * 4 * 16 * 64].view(2, 4, 16, 64)          # base 2 bytes past 16
    assert not _build.tma_compatible(off) and _build.tma_compatible(_build.tma_operand(off))
    zero = torch.zeros(1, 1, 16, 64, dtype=BF).expand(3, 4, 16, 64)   # stride 0 over B, heads
    assert not _build.tma_compatible(zero)
    assert torch.equal(_build.tma_operand(zero), zero)
    one = torch.zeros(1, 1, 16, 64, dtype=BF).as_strided((1, 1, 16, 64), (7, 3, 64, 1))
    assert _build.tma_compatible(one)                         # size-1 dims: strides unused
    odd_rows = torch.zeros(2, 3, 16, 72, dtype=BF)[..., :64]   # 144-byte rows
    assert _build.tma_compatible(odd_rows)
    odd = torch.zeros(2, 3, 16, 68, dtype=BF)[..., :64]        # 136-byte rows
    assert not _build.tma_compatible(odd)
    assert _build.tma_compatible(torch.zeros(2, 3, 16, 12, dtype=torch.float32))


class _Recorder:
    """Stands in for the built library: records what the C entries get."""

    def __init__(self):
        self.calls = []

    def __getitem__(self, name):
        return self

    def __getattr__(self, fn):
        def entry(*args):
            self.calls.append((fn, args))
            return 0
        return entry


def _strides(arr):
    return tuple(ctypes.cast(arr, ctypes.POINTER(ctypes.c_longlong))[i] for i in range(3))


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("d", [12, 96])
def test_launch_helpers_pass_tma_operands(monkeypatch, dtype, d):
    rec = _Recorder()
    monkeypatch.setattr(_build, "kernels", lambda: rec)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build, "_stream", lambda t: 0)
    copies = []
    real = _build.tma_operand

    def spy(t):
        c = real(t)
        copies.append((t, c))
        return c
    monkeypatch.setattr(_build, "tma_operand", spy)
    b, s, nh = 2, 40, 3
    q, k, v = _layout("packed", b, s, nh, d, dtype, seed=3)
    o, g, dq, dk, dv = (torch.empty(b, s, nh, d, dtype=dtype).transpose(1, 2) for _ in range(5))
    o.copy_(q)
    g.copy_(k)
    stats = torch.zeros(b, nh, s, 2)
    rowterm = torch.zeros(b, nh, s)
    _build.flash_attention_fwd(q, k, v, None, o, stats)
    _build.flash_attention_bwd(q, k, v, o, g, None, stats, rowterm, dq, dk, dv)
    (fwd, fa), (bwd, ba) = rec.calls
    assert (fwd, bwd) == ("fm_flash_attention_fwd", "fm_flash_attention_bwd")
    read = [(fa[0], fa[1]), (fa[2], fa[3]), (fa[4], fa[5])] + \
        [(ba[i], ba[i + 1]) for i in (0, 2, 4, 6, 8)]
    written = [(fa[8], fa[9], o)] + [(ba[i], ba[i + 1], t) for i, t in
                                     ((14, dq), (16, dk), (18, dv))]
    if dtype == BF:
        assert len(copies) == 8 and all(torch.equal(c, t) for t, c in copies)
        for ptr, st in read:
            assert ptr % 16 == 0 and all(x * 2 % 16 == 0 for x in _strides(st))
        assert [p for p, _ in read] == [c.data_ptr() for _, c in copies]
        assert all((c is t) == (d == 96) for t, c in copies)
    else:
        assert not copies
        assert [p for p, _ in read] == [t.data_ptr() for t in (q, k, v, q, k, v, o, g)]
    for ptr, st, t in written:          # outputs keep the caller's layout
        assert ptr == t.data_ptr() and _strides(st) == t.stride()[:3]
    np.testing.assert_array_equal(fa[11:15], [b, s, nh, d])
