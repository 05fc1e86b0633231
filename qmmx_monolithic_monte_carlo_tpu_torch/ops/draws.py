"""The uniform-row layout of the first-contact kernel, in one place.

The JAX package spells this layout inline in ``ops/pallas_mc.py:606-622`` and
sizes it at ``:744-754``.  Here the plain version
(``ops/cuda_mc.mc_paths_fused_reference``), the kernel wrapper
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
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import prng

# The stream of the fused kernel's uniforms (one stream, rows laid out below).
FUSED_STREAM = prng.STREAM_PATH


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
