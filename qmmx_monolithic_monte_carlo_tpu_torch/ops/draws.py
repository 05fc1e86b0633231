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
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import prng

# The streams of the fused kernels' uniforms (one each, rows laid out below).
FUSED_STREAM = prng.STREAM_PATH
GATED_STREAM = prng.STREAM_GATED
GATED_SUB = 8        # rows of paths in one gated block


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
                   n_blocks: int, lanes: int, device=None) -> torch.Tensor:
    """f32[n_blocks, layout.n_rows, lanes]: the uniforms the kernel draws in
    Philox mode for global blocks ``block0 ..``, bit for bit."""
    return prng.uniform_rows(seed, FUSED_STREAM, block0=block0,
                             n_blocks=n_blocks, n_rows=layout.n_rows,
                             lanes=lanes, device=device)


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
                   n_blocks: int, lanes: int, device=None) -> torch.Tensor:
    """f32[n_blocks, layout.u_rows, 8, lanes]: the uniforms the gated kernel
    draws in Philox mode for global blocks ``block0 ..``, bit for bit."""
    u = prng.uniform_rows(seed, GATED_STREAM, block0=block0, n_blocks=n_blocks,
                          n_rows=layout.u_rows, lanes=GATED_SUB * lanes,
                          device=device)
    return u.view(n_blocks, layout.u_rows, GATED_SUB, lanes)
