"""How the host packs arguments for the port's CUDA kernels.

Shared by the first-contact (``ops/cuda_mc.py``) and gated
(``ops/cuda_gated.py``) wrappers and their plain versions, so both kernels see
the same float32 constants, noise knobs, level slots and grid:

* ``f32`` -- the float32 rounding of a host number;
* ``consts`` -- (drift, sig_dt, log_s0), float64 on the host, rounded to float32;
* ``knobs`` -- padding, proximity and execution-noise stds as float32;
* ``level_slots`` -- level prices and validity padded to ``MAX_LEVELS``;
* ``grid_size`` -- the pass-1 grid, a function of num_paths alone;
* ``check_blocks`` / ``check_uniforms`` -- the launch checks the gated and
  engine wrappers share (blocks of 8 x lanes paths, injected uniforms).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..types import Levels
from ..utils import prng

MAX_LEVELS = 8           # level slots a kernel holds in its arguments
BLOCK = 256              # CUDA threads per CTA (matches the .cu sources)
MAX_CTAS = 4096          # pass-1 grid cap: fixed, so results do not depend on the card


def f32(x) -> float:
    """A Python float holding the float32 rounding of ``x``."""
    return float(np.float32(float(x)))


def consts(s0, mu, sigma, dt) -> tuple[float, float, float]:
    """(drift, sig_dt, log_s0) computed in float64 on the host and rounded to
    float32, as ``_mc_paths_pallas_jit`` does (pallas_mc.py:741-742, :652)."""
    drift = (mu - 0.5 * sigma * sigma) * dt
    sig_dt = sigma * math.sqrt(dt)
    return f32(drift), f32(sig_dt), f32(math.log(float(s0)))


def knobs(params, noise) -> dict:
    """The TPU kernel's (1, 8) knob row as float32 values; zero noise stds
    when ``noise`` is None."""
    def std(name):
        return f32(getattr(noise, name)) if noise is not None else 0.0

    return {
        "prox": f32(params.contact_prox), "stop_pad": f32(params.stop_padding),
        "tp_pad": f32(params.tp_padding),
        "lvl_jit": std("level_jitter_std"), "entry_slip": std("entry_slip_std"),
        "stop_slip": std("stop_slip_std"), "tgt_slip": std("target_slip_std"),
    }


def level_slots(levels: Levels) -> tuple[list[float], list[float]]:
    """Level prices (invalid slots zeroed, as ``_level_rows`` does) and 1/0
    validity, padded to MAX_LEVELS."""
    price = levels.price.detach().cpu().to(torch.float32)
    valid = levels.valid.detach().cpu()
    lp = torch.where(torch.isfinite(price), price, 0.0).tolist()
    lv = valid.to(torch.float32).tolist()
    pad = MAX_LEVELS - len(lp)
    return lp + [0.0] * pad, lv + [0.0] * pad


def grid_size(num_paths: int) -> int:
    """Pass-1 CTAs: a function of num_paths only, never of the card."""
    return max(1, min(-(-num_paths // BLOCK), MAX_CTAS))


def check_blocks(seed, levels: Levels, *, num_paths: int, lanes: int, sub: int,
                 what: str) -> None:
    """The seed, whole blocks of ``sub`` x ``lanes`` paths, and at most
    MAX_LEVELS level slots for the ``what`` kernel."""
    prng.check_seed(seed)
    block = sub * lanes
    if lanes <= 0 or num_paths <= 0 or num_paths % block != 0:
        raise ValueError(f"num_paths must be a positive multiple of {block} "
                         f"({sub} x lanes)")
    if levels.max_levels > MAX_LEVELS:
        raise ValueError(f"the {what} kernel supports up to {MAX_LEVELS} level slots")


def check_uniforms(external_uniforms, want: tuple, *, antithetic: bool,
                   lanes: int) -> None:
    """Antithetic half-row pairs, and injected uniforms: a float32 torch
    tensor of shape ``want``."""
    if antithetic and lanes % 256 != 0:
        raise ValueError("antithetic needs lanes % 256 == 0 (half-row pairs)")
    if external_uniforms is None:
        return
    if not torch.is_tensor(external_uniforms):
        raise ValueError("external_uniforms must be a torch tensor")
    if tuple(external_uniforms.shape) != want:
        raise ValueError(f"external_uniforms must have shape {want}, "
                         f"got {tuple(external_uniforms.shape)}")
    if external_uniforms.dtype != torch.float32:
        raise ValueError("external_uniforms must be float32")
