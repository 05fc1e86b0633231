"""Multi-symbol universe runs: per-symbol MC and the batched policy refresh.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/parallel/universe.py:31-135``.
BASELINE config #4 is a 100-symbol universe x 2^20 paths with a per-symbol
batched logistic policy refresh; each symbol has its own levels, spot and
volatility:

* ``stack_levels`` -- [S] lists of level rows -> Levels batched [S, L];
* ``universe_mc`` -- the streamed per-symbol pipeline: symbol s runs
  ``sim.pathsim.mc_paths`` (first contact) or ``sim.gatedpath.mc_paths_gated``
  (with ``gate``) at its levels, s0 and sigma and with ``symbol=s``, so every
  draw is keyed by the symbol (``utils/prng.stream_key``); row s equals that
  single pipeline bit for bit, and symbol 0 is the single run;
* ``universe_policy_refresh`` -- the per-symbol IRLS refresh
  (``models.logistic.fit_batched``), on the card by default.

The fused kernels are ``ops/cuda_mc.mc_paths_universe_fused`` (#2),
``ops/cuda_gated.mc_paths_gated_universe_fused`` (#5),
``ops/cuda_engine.mc_paths_engine_universe_fused`` (#10) and
``mc_paths_engine_universe_sweep_fused`` (#11).  ``sharded_universe`` and a
mesh for the refresh (the symbol axis over several cards) are not ported
yet: they wait for the multi-GPU slice.
"""

from __future__ import annotations

import torch

from ..config import EngineParams
from ..models import logistic as L
from ..ops.kernel_args import f32, symbol_rows
from ..sim import gatedpath, pathsim
from ..types import Levels
from ..utils import device as devices


def stack_levels(level_rows_per_symbol: list[list[dict]], max_levels: int = 16) -> Levels:
    """Host helper: [S] lists of level dicts -> Levels batched on a leading axis."""
    built = [Levels.from_rows(rows, max_levels=max_levels) for rows in level_rows_per_symbol]
    return Levels(**{k: torch.stack([getattr(b, k) for b in built]) for k in Levels._DTYPES})


def universe_mc(seed: int, levels: Levels, params: EngineParams, s0, sigma, *,
                paths_per_symbol: int, num_bars: int = 40,
                dt: float = 1.0 / (390.0 * 252.0), block_paths: int = 1 << 14,
                gate=None, device=None) -> pathsim.PathStats:
    """[S]-batched PathStats, one independent MC per symbol: first-contact
    replay, or the engine-gated multi-trade lifecycle when ``gate`` is set.
    ``levels`` is [S, L]; ``s0``, ``sigma`` and ``params``' leaves are
    scalars or [S]; mu is 0.  Runs on ``device``: the CUDA device by default
    (raising where there is none), the CPU when asked."""
    device = devices.resolve(device)
    kw = dict(num_paths=paths_per_symbol, num_bars=num_bars, mu=0.0, dt=dt,
              block_paths=block_paths, device=device)
    out = []
    for s, (lv, s0_s, sg_s, p) in enumerate(symbol_rows(levels, s0, sigma, params)):
        s0_s, sg_s = f32(s0_s), f32(sg_s)     # float32, as the JAX pipeline takes them
        if gate is None:
            out.append(pathsim.mc_paths(seed, lv, p, s0=s0_s, sigma=sg_s, symbol=s, **kw))
        else:
            out.append(gatedpath.mc_paths_gated(seed, lv, p, gate, s0=s0_s, sigma=sg_s,
                                                symbol=s, **kw))
    return pathsim.PathStats.stack(out)


def universe_policy_refresh(mesh, xs, ys, weights=None, *, max_iter: int = 30,
                            symbols_axis: str = "symbols", device=None) -> L.LRModel:
    """Per-symbol batched LR refresh: xs [S, N, D], ys [S, N], optional 0/1
    weights padding symbols with fewer samples; fits in the dtype of ``xs``.
    Runs on ``device``: that of a tensor ``xs``, else the CUDA device by
    default (raising where there is none), the CPU when asked.  ``mesh``
    must be None: sharding the symbol axis over several cards is not ported
    yet."""
    del symbols_axis
    if mesh is not None:
        raise NotImplementedError("a mesh is not ported yet (the multi-GPU slice); "
                                  "pass mesh=None")
    device = devices.resolve(device, xs if torch.is_tensor(xs) else None)
    return L.fit_batched(torch.as_tensor(xs, device=device), ys, weights,
                         max_iter=max_iter)
