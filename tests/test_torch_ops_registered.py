"""The port's kernels as registered torch ops (``fm::``), on the CPU.

- ``torch.library.opcheck`` on every op of ``ops/_library.OPS``, forward and
  backward, fp32 and bf16, at tiny shapes with dropout on: the schema (no
  output aliases an input), the fake impl against the CPU impl (shapes,
  dtypes, strides), the autograd registration and AOT dispatch.
- One ``TorchEncoderLayer`` (folded, unfolded, and the flash route through
  the monkeypatched gate, as ``tests/test_torch_flash_attention.py`` opens
  it) under ``torch.compile(fullgraph=True, backend="aot_eager")``, forward
  and backward with dropout on, its keys read from a ``KeyTape``: within
  1e-6 of the eager layer drawing from the generator itself, relative to
  each tensor's max-abs, with no graph break.
- A key given as a tensor gives ``random_bits``'s int-key bits, the high
  words ``fold_in`` sets included, and a ``KeyTape`` draws the generator's
  seeds in the recorded order.
- No ``torch.autograd.Function`` is left in ``fairmultimodal_torch/ops/``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from fairmultimodal_torch.models._layers import init_params
from fairmultimodal_torch.models.behrt import TorchEncoderLayer
from fairmultimodal_torch.ops import _library
from fairmultimodal_torch.ops import attention as t_attention
from fairmultimodal_torch.ops import dropout_add_layernorm as t_glue
from fairmultimodal_torch.ops import flash_attention as t_flash
from fairmultimodal_torch.ops import fused_attention_block as t_fab
from fairmultimodal_torch.ops import fused_ffn as t_ffn
from fairmultimodal_torch.utils import rng as t_rng

B, S, H, NH, F = 2, 16, 32, 2, 64
RATE = 0.1
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(rng, *shape, dtype=torch.float32, std=1.0):
    return torch.from_numpy(rng.normal(0.0, std, shape).astype(np.float32)).to(dtype)


def _mask(rng):
    m = (rng.random((B, S)) > 0.2).astype(np.int32)
    m[:, 0] = 1
    return torch.from_numpy(m)


def _key(seed):
    return torch.tensor(t_rng.fold_in(seed, 1, 2), dtype=torch.int64)


def _attention_args(rng, dt):
    """x, [w_qkv, b_qkv, wo, bo] (q | k | v packed, as the ops take them),
    gamma, beta, mask."""
    x = _t(rng, B, S, H, dtype=dt)
    w = [_t(rng, 3 * H, H, dtype=dt, std=H ** -0.5), _t(rng, 3 * H, dtype=dt, std=0.05),
         _t(rng, H, H, dtype=dt, std=H ** -0.5), _t(rng, H, dtype=dt, std=0.05)]
    return x, w, 1.0 + _t(rng, H, std=0.1), _t(rng, H, std=0.1), _mask(rng)


def _ffn_args(rng, dt):
    return (_t(rng, B * S, H, dtype=dt), _t(rng, F, H, dtype=dt, std=H ** -0.5),
            _t(rng, F, dtype=dt, std=0.05), _t(rng, H, F, dtype=dt, std=F ** -0.5),
            _t(rng, H, dtype=dt, std=0.05))


def _op_cases(dt):
    """op name -> (op, args): each forward with dropout on where it draws,
    and each backward from its forward's residuals."""
    rng = np.random.default_rng(7)
    cases = {}
    x, w, gamma, beta, mask = _attention_args(rng, dt)
    g = _t(rng, B, S, H, dtype=dt)
    fwd = (x, *w, gamma, beta, mask, _key(11), RATE, NH, 1e-5, True)
    _, qkv, o, stats, z = t_fab.attention_block_ln_op(*fwd)
    cases["attention_block_ln"] = (t_fab.attention_block_ln_op, fwd)
    cases["attention_block_ln_bwd"] = (t_fab.attention_block_ln_bwd_op, (
        g, x, qkv, o, stats, z, w[0], w[2], gamma, mask, _key(11), RATE, NH, 1e-5))
    fwd = (x, *w, mask, NH, True)
    _, qkv, o, stats = t_fab.attention_block_op(*fwd)
    cases["attention_block"] = (t_fab.attention_block_op, fwd)
    cases["attention_block_bwd"] = (t_fab.attention_block_bwd_op,
                                    (g, x, qkv, o, stats, w[0], w[2], mask, NH))

    x2, w1, b1, w2, b2 = _ffn_args(rng, dt)
    g2 = _t(rng, B * S, H, dtype=dt)
    fwd = (x2, w1, b1, w2, b2, gamma, beta, _key(12), _key(13), RATE, "relu", 1e-5, True)
    _, hd, z2 = t_ffn.ffn_ln_op(*fwd)
    cases["ffn_ln"] = (t_ffn.ffn_ln_op, fwd)
    cases["ffn_ln_bwd"] = (t_ffn.ffn_ln_bwd_op, (g2, x2, hd, z2, w1, w2, gamma, _key(13), RATE,
                                                 1.0 / (1.0 - RATE), "relu", 1e-5))
    fwd = (x2, w1, b1, w2, b2, _key(14), RATE, "relu", True)
    _, hd = t_ffn.ffn_op(*fwd)
    cases["ffn"] = (t_ffn.ffn_op, fwd)
    cases["ffn_bwd"] = (t_ffn.ffn_bwd_op, (g2, x2, hd, w1, w2, 1.0 / (1.0 - RATE), "relu"))

    # q, k, v: strided head views of one packed [B, S, 3H] projection.
    q, k, v = (t.transpose(1, 2) for t in
               _t(rng, B, S, 3 * H, dtype=dt).view(B, S, 3, NH, H // NH).unbind(2))
    fwd = (q, k, v, mask, True)
    o, stats = t_flash.flash_attention_op(*fwd)
    cases["flash_attention"] = (t_flash.flash_attention_op, fwd)
    cases["flash_attention_bwd"] = (t_flash.flash_attention_bwd_op,
                                    (_t(rng, B, NH, S, H // NH, dtype=dt), q, k, v, o, stats,
                                     mask))

    drop = t_rng.Dropout.make(_key(15), 1, RATE)
    fwd = (x, g, gamma, beta, drop.seed, drop.stream, drop.threshold, drop.inv_keep, 1e-5,
           True)
    _, z3 = t_glue.dropout_add_layernorm_op(*fwd)
    cases["dropout_add_layernorm"] = (t_glue.dropout_add_layernorm_op, fwd)
    cases["dropout_add_layernorm_bwd"] = (t_glue.dropout_add_layernorm_bwd_op, (
        g, z3, gamma, drop.seed, drop.stream, drop.threshold, drop.inv_keep, 1e-5))
    return cases


def test_every_kernel_entry_is_an_op():
    assert sorted(_library.OPS) == sorted(
        f"{n}{s}" for n in ("attention_block_ln", "attention_block", "ffn_ln", "ffn",
                            "flash_attention", "dropout_add_layernorm") for s in ("", "_bwd"))
    for name, op in _library.OPS.items():
        assert getattr(torch.ops.fm, name).default is op


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", sorted(f"{n}{s}" for n in (
    "attention_block_ln", "attention_block", "ffn_ln", "ffn", "flash_attention",
    "dropout_add_layernorm") for s in ("", "_bwd")))
def test_opcheck(name, dtype):
    op, args = _op_cases(DTYPES[dtype])[name]
    if not name.endswith("_bwd"):       # the autograd registration is checked with grads on
        args = tuple(a.clone().requires_grad_(True)
                     if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                     for a in args)
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def _rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.parametrize("route", ["folded", "unfolded", "flash"])
def test_encoder_layer_compiles_whole_with_dropout(monkeypatch, route):
    torch._dynamo.reset()
    if route == "flash":
        monkeypatch.setattr(t_attention, "can_use_flash_attention", lambda q: True)
    layer = TorchEncoderLayer(H, NH, ffn_size=F, dropout=RATE, fold_ln=route == "folded",
                              attn_kernel=route != "flash", ffn_kernel=True,
                              fused_qkv=route == "flash")
    init_params(layer, seed=3).train()
    rng = np.random.default_rng(5)
    x, mask, g = _t(rng, B, S, H), _mask(rng), _t(rng, B, S, H)

    def run(fn, generator):
        xx = x.clone().requires_grad_(True)
        layer.zero_grad(set_to_none=True)
        out = fn(xx, mask, generator)
        out.backward(g)
        return [out.detach(), xx.grad] + [p.grad for p in layer.parameters()]

    eager = run(layer, t_rng.make_generator(21))
    tape = t_rng.KeyTape(t_rng.make_generator(21), "cpu")
    recorded = run(layer, tape)                       # the first pass records
    assert len(tape.sites) == 3
    for a, b in zip(recorded, eager):
        assert torch.equal(a, b)
    tape.generator = t_rng.make_generator(21)
    tape.redraw().upload()
    compiled = torch.compile(layer, fullgraph=True, backend="aot_eager")
    got = run(compiled, tape)
    assert tape.cursor == 3
    for a, b in zip(got, eager):
        assert _rel(a, b) <= 1e-6
    # The masks move with the keys: another draw gives another output.
    tape.redraw().upload()
    assert not torch.equal(run(compiled, tape)[0], eager[0])


def test_a_key_tensor_gives_the_int_key_bits():
    for seed in (0, 7, 2 ** 31 - 2, t_rng.fold_in(123456789, 3), t_rng.fold_in(99, 5, 7)):
        key = torch.tensor(seed, dtype=torch.int64)
        for stream in (0, 1):
            assert torch.equal(t_rng.random_bits(key, stream, 1001),
                               t_rng.random_bits(seed, stream, 1001))
        assert torch.equal(t_rng.dropout_mask(key, 1, (9, 13), 0.3),
                           t_rng.dropout_mask(seed, 1, (9, 13), 0.3))
        x = torch.randn(9, 13, generator=torch.Generator().manual_seed(1))
        assert torch.equal(t_rng.apply_dropout(x, t_rng.Dropout.make(key, 0, 0.3)),
                           t_rng.apply_dropout(x, t_rng.Dropout.make(seed, 0, 0.3)))
    assert t_rng.device_key(t_rng.fold_in(5, 2), "cpu").item() == 5 | 2 << 32


def test_key_tape_draws_the_generators_seeds_in_order():
    plain = t_rng.RankGenerator(t_rng.make_generator(8), 3, 1)
    want = [t_rng.draw_seed(plain, sharded) for sharded in (False, True, False) * 2]
    tape = t_rng.KeyTape(t_rng.RankGenerator(t_rng.make_generator(8), 3, 1), "cpu")
    got = [tape.key(sharded) for sharded in (False, True, False)]
    assert got == want[:3] and tape.sites == [False, True, False]
    tape.redraw().upload()
    assert [int(tape.key(s)) for s in (False, True, False)] == want[3:]
    with pytest.raises(IndexError):
        tape.key()


def test_no_autograd_function_is_left_in_ops():
    ops_dir = Path(t_fab.__file__).parent
    for path in ops_dir.glob("*.py"):
        assert "autograd.Function)" not in path.read_text(), path.name
