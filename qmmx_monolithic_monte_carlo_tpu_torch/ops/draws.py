"""The uniform-row layouts of the fused kernels, in one place.

First contact (``GbmLayout``).  The JAX package spells this layout inline
in ``ops/pallas_mc.py:606-622`` and sizes it at ``:744-754``.  Here the plain
version (``ops/cuda_mc.mc_paths_fused_reference``), the kernel wrapper
(``ops/cuda_mc.mc_paths_fused``, which checks injected uniforms against it)
and the tests read this one spec; ``ops/csrc/mc_first_contact.cu`` computes
the same row offsets.

GBM, one block of ``lanes`` paths × ``W`` bars, rows of ``lanes`` uniforms:

    rows [0, W/2)        u1  Box-Muller radius draws (paired normals)
    rows [W/2, W)        u2  Box-Muller angle draws
    rows [W, 2W)         u3  Brownian-bridge high draws
    rows [2W, 3W)        u4  Brownian-bridge low draws
    row  3W              tie coin
    rows 3W+1 .. 3W+4    (with execution noise) two more Box-Muller pairs

Normal pair k (cos, sin) drives bars k and k + W/2.

Gated lifecycle (``GatedLayout``), the JAX package's ``_gated_stride`` layout
(``ops/pallas_mc.py:1052-1064``, ``:1119-1124``, ``:1273-1305``): one block
is 8 rows of ``lanes`` paths (path ``block * 8 * lanes + s * lanes + j``),
and double-bar step t2 (bars 2·t2 and 2·t2+1) takes uniforms
``t2 * stride + k``:

    k = 0, 1        Box-Muller (u1, u2): cos drives bar 2·t2, sin bar 2·t2+1
    k = 2, 3, 4     (u3, u4, tie) of bar 2·t2: bridge high, bridge low, tie coin
    k = 5, 6, 7     the same of bar 2·t2+1
    k = 8 .. 11     (with noise) radius, angle, radius, angle of the two
                    noise pairs of bar 2·t2: (level jitter, entry slip) and
                    (stop slip, target slip)
    k = 12 .. 15    the same of bar 2·t2+1

stride = 8, or 16 with noise, so ``u_rows = stride * W / 2``.  Injected
uniforms keep the JAX shape f32[n_blocks, u_rows, 8, lanes]; in Philox mode
row r of a block is one row of 8·lanes paths on the stream ``GATED_STREAM``,
so four consecutive rows of a path are the four words of one Philox call.

Full engine (``EngineLayout``), the JAX package's ``_draw_stride`` layout for
gbm (``ops/pallas_engine.py:108-144``, ``:374-435``): blocks of 8 rows of
``lanes`` paths as above, and double-bar step t2 takes uniforms
``t2 * stride + k``:

    k = 0, 1        price Box-Muller (u1, u2): cos drives bar 2·t2, sin bar 2·t2+1
    k = 2, 3        volume Box-Muller pair, the same way
    k = 4, 5, 6     (u_high, u_low, tie) of bar 2·t2
    k = 7, 8, 9     the same of bar 2·t2+1
    k = 10 .. 13    (with noise) radius, angle, radius, angle of bar 2·t2's
                    two noise pairs: (level jitter, entry slip), (stop slip,
                    target slip)
    k = 14 .. 17    the same of bar 2·t2+1

stride = 10, or 18 with noise, on the stream ``ENGINE_STREAM``.  Ten is not a
multiple of four, so a Philox call (four rows) feeds parts of two steps: the
kernel keeps the last call's four words and draws a new call only when a row
leaves them.

Market factor of a correlated book (``MarketLayout``), the JAX corr kernels'
shared ``market_uniforms`` (``ops/pallas_mc.py:2484-2489``, ``:2593``;
``ops/pallas_engine.py:2780-2784``, ``:3021``): blocks of 8 rows of
``lanes`` paths as above, and double-bar step t2 takes market rows
``2 * t2 + k``:

    k = 0, 1        market Box-Muller (u1, u2): cos drives bar 2·t2, sin bar 2·t2+1

so ``u_rows = W``.  The rows are drawn on the stream ``MARKET_STREAM`` at
symbol 0 (``prng.stream_key(STREAM_MARKET, 0)``) for every symbol of the
book, counted on (column, row // 4, global block) like every other draw, so
path p sees the same market normals in every symbol.  Injected, they are
f32[n_blocks, W, 8, lanes], the JAX shape.  (The JAX kernels' Heston
sampler reads 4 market rows a step; it is not ported yet.)
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import prng

# The streams of the fused kernels' uniforms (one each, rows laid out below).
FUSED_STREAM = prng.STREAM_PATH
GATED_STREAM = prng.STREAM_GATED
ENGINE_STREAM = prng.STREAM_ENGINE
MARKET_STREAM = prng.STREAM_MARKET
GATED_SUB = 8        # rows of paths in one gated block
ENGINE_SUB = 8       # rows of paths in one engine block


@dataclasses.dataclass(frozen=True)
class GbmLayout:
    num_bars: int
    noise: bool = False

    def __post_init__(self):
        if self.num_bars <= 0 or self.num_bars % 2:
            raise ValueError("num_bars must be even and positive "
                             "(paired Box-Muller draws)")

    @property
    def half(self) -> int:
        return self.num_bars // 2

    @property
    def u1(self) -> slice:
        return slice(0, self.half)

    @property
    def u2(self) -> slice:
        return slice(self.half, self.num_bars)

    @property
    def u3(self) -> slice:
        return slice(self.num_bars, 2 * self.num_bars)

    @property
    def u4(self) -> slice:
        return slice(2 * self.num_bars, 3 * self.num_bars)

    @property
    def tie(self) -> int:
        return 3 * self.num_bars

    @property
    def noise_rows(self) -> tuple[int, int, int, int]:
        """(radius 1, angle 1, radius 2, angle 2) of the two noise pairs."""
        t = self.tie
        return (t + 1, t + 2, t + 3, t + 4)

    @property
    def n_rows(self) -> int:
        return 3 * self.num_bars + 1 + (4 if self.noise else 0)


def fused_uniforms(seed: int, layout: GbmLayout, *, block0: int,
                   n_blocks: int, lanes: int, symbol: int = 0,
                   device=None) -> torch.Tensor:
    """f32[n_blocks, layout.n_rows, lanes]: the uniforms the kernel draws in
    Philox mode for global blocks ``block0 ..`` of universe symbol
    ``symbol``, bit for bit."""
    return prng.uniform_rows(seed, FUSED_STREAM, block0=block0,
                             n_blocks=n_blocks, n_rows=layout.n_rows,
                             lanes=lanes, symbol=symbol, device=device)


@dataclasses.dataclass(frozen=True)
class GatedLayout:
    num_bars: int
    noise: bool = False

    def __post_init__(self):
        if self.num_bars <= 0 or self.num_bars % 2:
            raise ValueError("num_bars must be even and positive "
                             "(paired Box-Muller draws)")

    @property
    def stride(self) -> int:
        return 16 if self.noise else 8

    @property
    def u_rows(self) -> int:
        return self.stride * (self.num_bars // 2)

    def row(self, t2: int, k: int) -> int:
        return t2 * self.stride + k


def gated_uniforms(seed: int, layout: GatedLayout, *, block0: int,
                   n_blocks: int, lanes: int, symbol: int = 0,
                   device=None) -> torch.Tensor:
    """f32[n_blocks, layout.u_rows, 8, lanes]: the uniforms the gated kernel
    draws in Philox mode for global blocks ``block0 ..`` of universe
    symbol ``symbol``, bit for bit."""
    u = prng.uniform_rows(seed, GATED_STREAM, block0=block0, n_blocks=n_blocks,
                          n_rows=layout.u_rows, lanes=GATED_SUB * lanes,
                          symbol=symbol, device=device)
    return u.view(n_blocks, layout.u_rows, GATED_SUB, lanes)


@dataclasses.dataclass(frozen=True)
class EngineLayout:
    num_bars: int
    noise: bool = False

    def __post_init__(self):
        if self.num_bars <= 0 or self.num_bars % 2:
            raise ValueError("num_bars must be even and positive "
                             "(paired Box-Muller draws)")

    @property
    def stride(self) -> int:
        return 18 if self.noise else 10

    @property
    def u_rows(self) -> int:
        return self.stride * (self.num_bars // 2)

    def row(self, t2: int, k: int) -> int:
        return t2 * self.stride + k


def engine_uniforms(seed: int, layout: EngineLayout, *, block0: int,
                    n_blocks: int, lanes: int, symbol: int = 0,
                    device=None) -> torch.Tensor:
    """f32[n_blocks, layout.u_rows, 8, lanes]: the uniforms the engine kernel
    draws in Philox mode for global blocks ``block0 ..`` of universe
    symbol ``symbol``, bit for bit."""
    u = prng.uniform_rows(seed, ENGINE_STREAM, block0=block0, n_blocks=n_blocks,
                          n_rows=layout.u_rows, lanes=ENGINE_SUB * lanes,
                          symbol=symbol, device=device)
    return u.view(n_blocks, layout.u_rows, ENGINE_SUB, lanes)


@dataclasses.dataclass(frozen=True)
class MarketLayout:
    num_bars: int

    def __post_init__(self):
        if self.num_bars <= 0 or self.num_bars % 2:
            raise ValueError("num_bars must be even and positive "
                             "(paired Box-Muller draws)")

    stride = 2

    @property
    def u_rows(self) -> int:
        return self.stride * (self.num_bars // 2)

    def row(self, t2: int, k: int) -> int:
        return t2 * self.stride + k


def market_uniforms(seed: int, layout: MarketLayout, *, block0: int, n_blocks: int,
                    lanes: int, device=None) -> torch.Tensor:
    """f32[n_blocks, layout.u_rows, 8, lanes]: the market rows the book
    kernels draw in Philox mode for global blocks ``block0 ..`` (every
    symbol's), bit for bit."""
    u = prng.uniform_rows(seed, MARKET_STREAM, block0=block0, n_blocks=n_blocks,
                          n_rows=layout.u_rows, lanes=GATED_SUB * lanes, device=device)
    return u.view(n_blocks, layout.u_rows, GATED_SUB, lanes)
