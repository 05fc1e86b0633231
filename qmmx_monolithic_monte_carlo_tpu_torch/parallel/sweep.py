"""Grid sweeps over the Monte Carlo engine with common random numbers (CRN).

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/parallel/sweep.py:26-202``.
The reference evaluates STOP_PADDING / TP_PADDING / touch budget / Q_MIN_PROB
one configuration at a time; a sweep evaluates a whole grid over the same
simulated paths, so grid points differ only by their parameters:

* ``grid_params`` / ``grid_params_gated`` -- the cartesian grid ('ij' order)
  as records whose leaves carry a leading [G] axis;
* ``sweep_paths`` / ``sweep_paths_gated`` -- the streamed pipelines: each
  block's bars and tie coins are drawn once (the draws of
  ``sim.pathsim.mc_paths`` / ``sim.gatedpath.mc_paths_gated``) and every
  grid row replays them, so row g equals the single-configuration pipeline
  at the same seed, bit for bit;
* ``replay_grid`` / ``replay_grid_gated`` -- one block's G-row replay, the
  ``jax.vmap(per_cfg)`` of the JAX sweeps' scan body.

Row g of a record with [G] leaves, and G, are ``ops/kernel_args.grid_row`` /
``grid_len``.  The fused CUDA sweeps are
``ops/cuda_mc.mc_paths_sweep_fused``,
``ops/cuda_gated.mc_paths_gated_sweep_fused`` and
``ops/cuda_engine.mc_paths_engine_sweep_fused``.  ``sharded_sweep`` (the path
axis over a mesh) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import EngineParams
from ..ops.kernel_args import grid_len, grid_row, tensor_leaves
from ..sim import gatedpath, pathsim
from ..sim.pathsim import LIFE_HIST_HI, LIFE_HIST_LO, PathStats
from ..types import Levels
from ..utils import device as devices
from ..utils import prng

_F32 = torch.float32


def _broadcast_gate(obj, g: int):
    """A record (a GateConfig, or EngineParams) with every leaf broadcast to a
    leading [G] axis; leaves already [G] stay."""
    return dataclasses.replace(obj, **{
        k: v if v.dim() >= 1 and v.shape[0] == g else v.expand((g,) + v.shape).clone()
        for k, v in tensor_leaves(obj).items()})


def grid_params(base: EngineParams, *, stop_paddings, tp_paddings) -> EngineParams:
    """A [G]-batched EngineParams over the cartesian stop x tp grid."""
    sp, tp = torch.meshgrid(torch.as_tensor(stop_paddings, dtype=_F32).reshape(-1),
                            torch.as_tensor(tp_paddings, dtype=_F32).reshape(-1),
                            indexing="ij")
    sp, tp = sp.reshape(-1), tp.reshape(-1)
    return dataclasses.replace(_broadcast_gate(base, sp.shape[0]), stop_padding=sp, tp_padding=tp)


def grid_params_gated(base: EngineParams, base_gate, *, stop_paddings=None,
                      tp_paddings=None, touch_limits=None, q_min_probs=None):
    """Cartesian (stop x tp x touch_limit x q_min_prob) grid -> a [G]-batched
    (EngineParams, GateConfig) pair; an omitted axis stays at its base value
    (a singleton axis).  touch_limit becomes int32, as in JAX."""
    def axis(vals, base_val):
        return torch.as_tensor(vals if vals is not None else [float(base_val)],
                               dtype=_F32).reshape(-1)

    axes = [axis(stop_paddings, base.stop_padding), axis(tp_paddings, base.tp_padding),
            axis(touch_limits, base_gate.touch_limit),
            axis(q_min_probs, base_gate.q_min_prob)]
    sp, tp, tl, qm = (m.reshape(-1) for m in torch.meshgrid(*axes, indexing="ij"))
    g = sp.shape[0]
    params_g = dataclasses.replace(_broadcast_gate(base, g), stop_padding=sp, tp_padding=tp)
    gate_g = dataclasses.replace(_broadcast_gate(base_gate, g), touch_limit=tl.to(torch.int32),
                                 q_min_prob=qm)
    return params_g, gate_g


def replay_grid(paths, levels: Levels, grid: EngineParams, tie) -> PathStats:
    """One block's first-contact replay for every grid row: [G] PathStats."""
    return PathStats.stack([
        PathStats.from_outcomes(*pathsim.path_replay(paths, levels, grid_row(grid, g), tie))
        for g in range(grid_len(grid))])


def replay_grid_gated(paths, levels: Levels, grid: EngineParams, gate_g, tie) -> PathStats:
    """One block's gated lifecycle for every grid row: [G] PathStats."""
    out = []
    for g in range(grid_len(grid, gate_g)):
        o = gatedpath.gated_path_replay(paths, levels, grid_row(grid, g),
                                        grid_row(gate_g, g), tie)
        out.append(PathStats.from_lifecycle(
            equity=o.equity, trades=o.trades, wins=o.wins, losses=o.losses,
            open_at_end=o.open_at_end, max_dd=o.max_dd))
    return PathStats.stack(out)


def _zero(g: int, lifecycle: bool, device) -> PathStats:
    rng = (LIFE_HIST_LO, LIFE_HIST_HI) if lifecycle else ()
    return PathStats.stack([PathStats.zero(*rng, device=device) for _ in range(g)])


def _check_blocks(num_paths: int, block_paths: int) -> int:
    if num_paths % block_paths != 0 or num_paths < block_paths:
        raise ValueError(f"num_paths ({num_paths}) must be a positive multiple of "
                         f"block_paths ({block_paths})")
    return num_paths // block_paths


def sweep_paths(seed: int, levels: Levels, grid: EngineParams, *, num_paths: int,
                num_bars: int = 40, s0=100.0, mu: float = 0.0, sigma: float = 0.15,
                dt: float = 1.0 / (390.0 * 252.0), block_paths: int = 1 << 14,
                sampler: str = "gbm", device=None) -> PathStats:
    """All grid rows over common random paths: [G] PathStats.  Each block's
    bars and tie coins are those of ``sim.pathsim.mc_paths`` (gbm only; the
    other samplers raise), drawn once; runs on ``device``, the CUDA device
    by default, the CPU when asked."""
    n_blocks = _check_blocks(num_paths, block_paths)
    device = devices.resolve(device)
    levels = levels.to(device)
    out = _zero(grid_len(grid), False, device)
    for b in range(n_blocks):
        paths = pathsim.sample_block(seed, b, block_paths=block_paths, num_bars=num_bars,
                                     s0=s0, mu=mu, sigma=sigma, dt=dt, sampler=sampler,
                                     device=device)
        tie = prng.uniform_rows(seed, prng.STREAM_TIE_COIN, block0=b, n_blocks=1,
                                n_rows=1, lanes=block_paths, device=device)[0, 0]
        out = out.merge(replay_grid(paths, levels, grid, tie))
    return out


def sweep_paths_gated(seed: int, levels: Levels, grid: EngineParams, gate=None, *,
                      num_paths: int, num_bars: int = 40, s0=100.0, mu: float = 0.0,
                      sigma: float = 0.15, dt: float = 1.0 / (390.0 * 252.0),
                      block_paths: int = 1 << 14, sampler: str = "gbm",
                      device=None) -> PathStats:
    """Grid sweep of the gated multi-trade lifecycle: each block's paths and
    per-bar tie coins (those of ``sim.gatedpath.mc_paths_gated``) are drawn
    once and every row replays the whole lifecycle on them.  ``gate``
    (default ``GateConfig.default()``, as in JAX) may carry [G] leaves to put
    gate knobs on the grid axis (``grid_params_gated``)."""
    if gate is None:
        gate = gatedpath.GateConfig.default()
    n_blocks = _check_blocks(num_paths, block_paths)
    device = devices.resolve(device)
    levels = levels.to(device)
    gate_g = _broadcast_gate(gate, grid_len(grid, gate))
    out = _zero(gate_g.q_min_prob.shape[0], True, device)
    for b in range(n_blocks):
        paths = pathsim.sample_block(seed, b, block_paths=block_paths, num_bars=num_bars,
                                     s0=s0, mu=mu, sigma=sigma, dt=dt, sampler=sampler,
                                     device=device)
        tie = prng.uniform_rows(seed, prng.STREAM_TIE_COIN, block0=b, n_blocks=1,
                                n_rows=num_bars, lanes=block_paths, device=device)[0].T
        out = out.merge(replay_grid_gated(paths, levels, grid, gate_g, tie))
    return out

