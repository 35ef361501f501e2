"""Counter-based dropout randomness: Philox4x32-10.

Counterpart of ``fairmultimodal_tpu/utils/rng.py``, which picks the TPU's
hardware random-bit generator.  The port draws every dropout bit from one
function of ``(seed, stream, flat element index)``:

    bits(seed, stream, i) = philox4x32_10(ctr=(q_lo, q_hi, stream, 0),
                                          key=(seed_lo, seed_hi))[i & 3]
    with q = i >> 2

written twice: here on int64 tensors (the plain version, any device) and in
``ops/csrc/philox.cuh`` (inside the kernels).  Both give the same bits, so a
kernel and its plain version -- and the CPU plain path and the card's kernel
path of a whole model -- draw identical masks from one seed.

Dropout keeps an element where ``bits < min(int(keep * 2**32), 2**32 - 1)``
and scales it by ``1 / keep`` (the JAX kernels' contract).  Seeds come from
an explicit :class:`torch.Generator` that the caller owns (the trainer's):
each dropout site draws its own seed on the host with :func:`draw_seed`, as
``TorchEncoderLayer._dropout_seed`` does in JAX.  Nothing here touches the
global RNG.

A rank of a mesh draws from a :class:`RankGenerator`: the trainer's
generator, which every rank holds in the same state, with the rank's data
index folded into each seed it draws (:func:`fold_in`,
``jax.random.fold_in(rng, axis_index)`` in the JAX trainer).  The seed is
the Philox key, so the fold reaches the plain masks and the kernels' alike.
Under tensor parallelism a dropout site whose activation is replicated over
the model group (every site but one) folds the data index only, so the
replicas draw one mask; the site on a sharded activation (the FFN's inner
dropout on this rank's ``F / model`` columns) also folds the model index,
so the shards do not repeat one mask.  Rank (0, 0) keeps the seed.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple, Union

import torch

__all__ = ["philox4x32", "random_bits", "keep_threshold", "dropout_mask", "Dropout",
           "apply_dropout", "dropout", "draw_seed", "make_generator", "fold_in",
           "RankGenerator", "device_key", "KeyTape"]

#: A dropout seed: an int on the host, or a 0-dim int64 tensor holding it.
Seed = Union[int, torch.Tensor]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF
_CHUNK = 1 << 24            # counters per pass, bounds the int64 temporaries


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of ``a * m`` for a < 2**32 on int64 tensors.

    The 64-bit product does not fit int64, so ``m`` is split into 16-bit
    halves: a * m = (a * m_hi) * 2**16 + a * m_lo, each partial < 2**48."""
    ph = a * (m >> 16)
    pl = a * (m & 0xFFFF)
    low = pl + ((ph & 0xFFFF) << 16)          # < 2**49
    return (ph >> 16) + (low >> 32), low & _U32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors of 32-bit counter words; returns the
    four output words.  The key words are ints or 0-dim int64 tensors."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def random_bits(seed: Seed, stream: int, n: int,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """``bits(seed, stream, i)`` for i in [0, n) as int64 values in [0, 2**32).
    ``seed`` is an int or a key tensor (:func:`device_key`), which is read
    where it lies: nothing here waits on the card."""
    if isinstance(seed, torch.Tensor):
        key = seed.reshape(())
        k0, k1 = key & _U32, (key >> 32) & _U32
    else:
        k0, k1 = int(seed) & _U32, (int(seed) >> 32) & _U32
    nq = -(-n // 4)
    out = torch.empty((nq, 4), dtype=torch.int64, device=device)
    for start in range(0, nq, _CHUNK):
        q = torch.arange(start, min(start + _CHUNK, nq), dtype=torch.int64, device=device)
        words = philox4x32(q & _U32, q >> 32, torch.full_like(q, int(stream) & _U32),
                           torch.zeros_like(q), k0, k1)
        out[start:start + len(q)] = torch.stack(words, dim=1)
    return out.view(-1)[:n]


def keep_threshold(rate: float) -> int:
    return min(int((1.0 - rate) * 2 ** 32), 2 ** 32 - 1)


def dropout_mask(seed: Seed, stream: int, shape, rate: float,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """Boolean keep-mask of ``shape`` (flat row-major element index)."""
    n = 1
    for s in shape:
        n *= int(s)
    return (random_bits(seed, stream, n, device) < keep_threshold(rate)).view(*shape)


class Dropout(NamedTuple):
    """One dropout stream as the kernels take it (``ops/csrc/philox.cuh``):
    keep where ``bits(seed, stream, i) < threshold``, scale kept values by
    ``inv_keep``; ``Dropout()`` is no dropout.  ``seed`` is an int or a key
    tensor; a launch takes it as a key (``ops/_build.py``)."""
    seed: Seed = 0
    stream: int = 0
    threshold: int = 0
    inv_keep: float = 1.0
    on: int = 0

    @classmethod
    def make(cls, seed: Optional[Seed], stream: int, rate: float) -> "Dropout":
        if seed is None or rate <= 0.0:
            return cls()
        return cls(seed if isinstance(seed, torch.Tensor) else int(seed), int(stream),
                   keep_threshold(rate), 1.0 / (1.0 - rate), 1)


def apply_dropout(x: torch.Tensor, drop: Dropout) -> torch.Tensor:
    """``x`` through the stream ``drop`` (flat row-major element index), kept
    values multiplied by 1/keep in ``x``'s dtype: the kernels' arithmetic."""
    if not drop.on:
        return x
    keep = random_bits(drop.seed, drop.stream, x.numel(), x.device) < drop.threshold
    return torch.where(keep.view(x.shape), x * drop.inv_keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, seed: Optional[Seed], stream: int = 0) -> torch.Tensor:
    """Philox dropout of ``x``; identity when ``seed`` is None or rate is 0."""
    return apply_dropout(x, Dropout.make(seed, stream, rate))


def fold_in(seed: int, rank: int, model: int = 0) -> int:
    """``seed`` (below 2**32) with ``rank`` (a data index, below 2**16) and
    ``model`` (a model index) as the Philox key's high word: key = (seed,
    rank | model << 16).  Rank 0 keeps the seed, so a one-rank mesh draws
    the single process's masks."""
    return int(seed) | ((int(rank) | (int(model) << 16)) << 32)


class RankGenerator(NamedTuple):
    """``generator`` as the rank at data index ``rank`` and model index
    ``model`` of a mesh draws from it: the same draws, each seed folded with
    the data index, and with the model index too for a sharded site
    (:func:`fold_in`)."""
    generator: torch.Generator
    rank: int
    model: int = 0


def draw_seed(generator, sharded: bool = False) -> Seed:
    """One dropout seed from the caller's generator (host): in [0, 2**31 - 1)
    from a ``torch.Generator``, folded with the data index from a
    :class:`RankGenerator` (and the model index for a ``sharded`` site); from
    a :class:`KeyTape`, its next site's seed or key."""
    if isinstance(generator, KeyTape):
        return generator.key(sharded)
    if isinstance(generator, RankGenerator):
        return fold_in(draw_seed(generator.generator), generator.rank,
                       generator.model if sharded else 0)
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator).item())


def make_generator(seed: int) -> torch.Generator:
    """The trainer's dropout stream: a CPU generator, so drawing a seed never
    waits on the card."""
    return torch.Generator(device="cpu").manual_seed(int(seed))


def device_key(seed: int, device) -> torch.Tensor:
    """``seed`` as a key on ``device``: a 0-dim int64 tensor, made on the card
    by a fill launch (no copy from the host, so nothing waits).  Made while a
    CUDA graph is being captured, the fill would be frozen into the graph with
    this seed, so that raises: a captured step takes its keys from a
    :class:`KeyTape`."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a dropout seed drawn while a CUDA graph is captured would be "
                           "frozen into it; pass a KeyTape as the generator")
    return torch.full((), int(seed), dtype=torch.int64, device=device)


class KeyTape:
    """The dropout keys of a step in memory that the step reads, for a step
    captured into a CUDA graph or traced whole by ``torch.compile``.

    Pass it where a model takes its dropout generator (:func:`draw_seed`).
    Its first pass records: each dropout site draws its seed from
    ``generator`` on the host, as it would from the generator itself, and the
    tape notes the site.  :meth:`redraw` then draws the seeds of a next pass,
    one per recorded site in the recorded order, from the generator's state
    at that moment, into host memory (pinned for a CUDA ``device``), and
    :meth:`upload` copies them into ``keys`` on ``device`` and rewinds: from
    then on site i of a pass takes ``keys[i]``, a key tensor, and no host
    draw.  With the generator in one state, a pass through the tape draws the
    masks a pass through the generator draws.

    Captured into a CUDA graph, :meth:`upload` is the graph's node that
    copies the host slots (``fm_copy_h2d``), so each replay reads what the
    last :meth:`redraw` wrote there: fresh masks on every replay.
    :meth:`redraw` first waits until the last upload has read the slots
    (an event recorded after the copy, which a captured upload records
    again at every replay), so that no copy sees them change: the host
    may run one pass ahead of the card, not more."""

    def __init__(self, generator, device):
        self.generator = generator
        self.device = torch.device(device)
        self.sites: List[bool] = []           # each recorded site's ``sharded``
        self.host: Optional[torch.Tensor] = None
        self.keys: Optional[torch.Tensor] = None
        self.cursor: Optional[int] = None     # None while the first pass records
        self._read = None                     # CUDA event: the last upload has read the slots

    def key(self, sharded: bool = False) -> Seed:
        """The seed of the next site: drawn from the generator while
        recording, else the next slot of ``keys``."""
        if self.cursor is None:
            self.sites.append(bool(sharded))
            return draw_seed(self.generator, sharded)
        i = self.cursor
        if i >= len(self.sites):
            raise IndexError(f"the pass has more dropout sites than the {len(self.sites)} "
                             "the tape recorded")
        self.cursor = i + 1
        return self.keys[i]

    def redraw(self) -> "KeyTape":
        """Draw every recorded site's seed anew into the host slots."""
        n = len(self.sites)
        if self.host is None:
            cuda = self.device.type == "cuda"
            self.host = torch.empty(n, dtype=torch.int64, pin_memory=cuda)
            self.keys = torch.empty(n, dtype=torch.int64, device=self.device)
        elif self._read is not None:
            self._read.synchronize()
        self.host.copy_(torch.tensor([int(draw_seed(self.generator, s)) for s in self.sites],
                                     dtype=torch.int64))
        self.cursor = 0
        return self

    def upload(self) -> "KeyTape":
        """Copy the host slots into ``keys`` (in stream order on the card)
        and rewind to the first site."""
        if self.host is None:
            raise RuntimeError("redraw() first: the tape has no keys yet")
        if self.device.type == "cuda":
            from fairmultimodal_torch.ops import _build
            _build.copy_h2d(self.keys, self.host)
            if self._read is None:
                self._read = torch.cuda.Event(external=True)
            self._read.record(torch.cuda.current_stream(self.device))
        else:
            self.keys.copy_(self.host)
        self.cursor = 0
        return self
