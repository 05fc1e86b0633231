"""Engine-gated trade lifecycle over generated paths: the QMMX engine at scale.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/sim/gatedpath.py:59-347``.

The first-contact pipeline (sim/pathsim.py) replays one trade per path.  The
reference engine trades repeatedly over its window, and its Monte Carlo sums
each trial's equity curve into peak-tracked drawdown (qmmx_monolithic.py
:3491-3525).  Per path and bar, over all paths at once:

  1. position management first: stop/target first hit off the bar's
     high/low with the same-bar distance-weighted tie coin (sim/hits.py); a
     close updates equity/peak/drawdown and arms the cooldown, and a path
     never re-enters on the bar that closed it;
  2. paths flat at the start of the bar and out of cooldown evaluate entry
     at the close: direction known (c != prev_c), nearest level within
     CONTACT_PROX, the fresh-touch latch (``touch_gap_bars`` de-dup)
     counting touches per (path, level), LEVEL_OVERTOUCHED when the count
     reaches ``touch_limit``, confidence >= Q_MIN_PROB.  A passing path opens
     at the close with stop/target = level -/+ the paddings.

``Lifecycle`` is that state machine, one bar per ``step``; the streamed
pipeline here (``gated_path_replay``, ``mc_paths_gated``) and the plain
version of the gated CUDA kernel (``ops/cuda_gated.py``) both drive it.
Outputs reduce through ``PathStats.from_lifecycle``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import EngineParams
from ..ops import confidence as C
from ..ops import features as F
from ..ops import pathgen as PG
from ..types import DIR_DOWN, DIR_UP, SIDE_FLAT, SIDE_LONG, SIDE_SHORT, Levels, TensorRecord
from ..utils import device as devices
from ..utils import prng
from ..utils.floats import fma
from . import pathsim
from .hits import bar_hit_outcome
from .pathsim import LIFE_HIST_HI, LIFE_HIST_LO, PathStats

_F32 = torch.float32
_I32 = torch.int32


@dataclasses.dataclass
class GateConfig(TensorRecord):
    """Gate knobs of the generated-path lifecycle, as 0-d tensors
    (``from_numpy`` takes the JAX ``GateConfig``'s fields)."""

    touch_limit: torch.Tensor     # i32: skip when a level's touch count
                                  # reaches this (LEVEL_OVERTOUCHED at 4)
    q_min_prob: torch.Tensor      # f32: confidence floor
    cooldown_bars: torch.Tensor   # i32: full bars blocked after a close
    touch_gap_bars: torch.Tensor  # i32: fresh-touch de-dup gap (180 s)
    use_confidence: torch.Tensor  # bool: False gates on the touch budget only

    _DTYPES = {"touch_limit": _I32, "q_min_prob": _F32,
               "cooldown_bars": _I32, "touch_gap_bars": _I32,
               "use_confidence": torch.bool}

    @classmethod
    def default(cls, *, touch_limit: int = 4, q_min_prob: float = 0.60,
                cooldown_bars: int = 0, touch_gap_bars: int = 3,
                use_confidence: bool = True) -> "GateConfig":
        return cls.from_numpy(dict(
            touch_limit=touch_limit, q_min_prob=q_min_prob,
            cooldown_bars=cooldown_bars, touch_gap_bars=touch_gap_bars,
            use_confidence=use_confidence))

    @classmethod
    def from_params(cls, params: EngineParams, *, touch_limit: int = 4,
                    cooldown_bars: int = 0, touch_gap_bars: int = 3,
                    use_confidence: bool = True) -> "GateConfig":
        """Engine defaults with the confidence floor of ``params``."""
        return cls.default(touch_limit=touch_limit,
                           q_min_prob=float(params.q_min_prob),
                           cooldown_bars=cooldown_bars,
                           touch_gap_bars=touch_gap_bars,
                           use_confidence=use_confidence)



class LifecycleOutcome(NamedTuple):
    """Per-path lifecycle results ([P] each)."""

    equity: torch.Tensor       # f32 total R over all closed trades
    trades: torch.Tensor       # i32 entries taken
    wins: torch.Tensor         # i32 target closes
    losses: torch.Tensor       # i32 stop closes
    open_at_end: torch.Tensor  # bool position still open after the last bar
    max_dd: torch.Tensor       # f32 peak-tracked max drawdown in R (>= 0)


class Lifecycle:
    """The gated state machine over P paths; ``step`` advances one bar.

    Float32 and int32 throughout, in the JAX package's order of operations
    (with its fused multiply-adds, ``fma``), so the same bars give the same
    bits."""

    def __init__(self, prev_c: torch.Tensor, levels: Levels,
                 params: EngineParams, gate: GateConfig, noise=None):
        dev = prev_c.device
        p, n_lvl = prev_c.shape[0], levels.max_levels
        self.levels, self.params, self.gate = levels.to(dev), params, gate.to(dev)
        self.noise = noise
        zf = torch.zeros((p,), dtype=_F32, device=dev)
        zi = torch.zeros((p,), dtype=_I32, device=dev)
        self.side, self.cooldown = zi, zi
        self.entry = self.stop = self.target = zf
        self.equity = self.peak = self.dd = zf
        self.trades = self.wins = self.losses = zi
        self.touch = torch.zeros((p, n_lvl), dtype=_I32, device=dev)
        self.last_tb = torch.full((p, n_lvl), -1, dtype=_I32, device=dev)
        self.lvl_iota = torch.arange(n_lvl, dtype=_I32, device=dev)
        self.prev_c = prev_c.to(_F32)

    def step(self, bar: int, h, l, c, tie, nz=None) -> None:
        """Bar ``bar`` with high/low/close/tie f32[P]; ``nz`` the bar's four
        execution-noise normals (level jitter, entry, stop, target slips)."""
        params, gate = self.params, self.gate
        side, entry, stop, target = self.side, self.entry, self.stop, self.target

        # ---- 1) position management
        is_open = side != SIDE_FLAT
        bh = bar_hit_outcome(is_open=is_open, is_long=side == SIDE_LONG,
                             entry=entry, stop=stop, target=target, high=h,
                             low=l, tie=tie)
        tf, closed = bh.target_first, bh.hit
        risk = torch.clamp((entry - stop).abs(), min=1e-9)
        reward = (target - entry).abs()
        r = torch.where(closed, torch.where(tf, reward / risk, -1.0), 0.0)
        self.equity = self.equity + r
        self.peak = torch.maximum(self.peak, self.equity)
        self.dd = torch.maximum(self.dd, self.peak - self.equity)
        self.wins = self.wins + (closed & tf).to(_I32)
        self.losses = self.losses + (closed & ~tf).to(_I32)
        side = torch.where(closed, SIDE_FLAT, side)

        # ---- 2) entry evaluation at the close (flat-at-bar-start paths only)
        cd_ok = self.cooldown <= 0
        self.cooldown = torch.where(closed, gate.cooldown_bars,
                                    torch.clamp(self.cooldown - 1, min=0))
        dir_known = c != self.prev_c
        new_side = torch.where(c > self.prev_c, SIDE_LONG, SIDE_SHORT).to(_I32)
        idx, dist, lvlp, lvlk = F.nearest_level_full(self.levels, c)
        near = dist <= params.contact_prox
        signal = ~is_open & cd_ok & dir_known & near

        # fresh-touch latch: counted on a signal, de-duplicated by the gap
        onehot = self.lvl_iota[None, :] == idx[:, None]             # [P, L]
        tc_old = torch.where(onehot, self.touch, 0).sum(dim=1, dtype=_I32)
        last_t = torch.where(onehot, self.last_tb, 0).sum(dim=1, dtype=_I32)
        seen = (onehot & (self.last_tb >= 0)).any(dim=1)
        fresh = signal & (~seen | (bar - last_t >= gate.touch_gap_bars))
        tc_new = tc_old + fresh.to(_I32)
        upd = onehot & fresh[:, None]
        self.touch = torch.where(upd, tc_new[:, None], self.touch)
        self.last_tb = torch.where(upd, bar, self.last_tb)

        # LEVEL_OVERTOUCHED and the confidence gate
        overtouched = tc_new >= gate.touch_limit
        conf = C.compute_confidence(
            level_price=lvlp, level_kind=lvlk, price=c,
            direction=torch.where(new_side == SIDE_LONG, DIR_UP, DIR_DOWN),
            touch_count=tc_new, contact_prox=params.contact_prox)
        conf_ok = ~gate.use_confidence | (conf >= gate.q_min_prob)
        enter = signal & ~overtouched & conf_ok

        # stop/target scaffold = level -/+ paddings; entry at the close
        go_long = new_side == SIDE_LONG
        self.side = torch.where(enter, new_side, side)
        noise = self.noise
        if noise is not None:
            lvl_eff = fma(nz[0], noise.level_jitter_std, lvlp)
            fill = fma(nz[1], noise.entry_slip_std, c)
        else:
            lvl_eff, fill = lvlp, c
        new_stop = torch.where(go_long, lvl_eff - params.stop_padding,
                               lvl_eff + params.stop_padding)
        new_target = torch.where(go_long, lvl_eff + params.tp_padding,
                                 lvl_eff - params.tp_padding)
        if noise is not None:
            new_stop = fma(nz[2], noise.stop_slip_std, new_stop)
            new_target = fma(nz[3], noise.target_slip_std, new_target)
        self.entry = torch.where(enter, fill, entry)
        self.stop = torch.where(enter, new_stop, stop)
        self.target = torch.where(enter, new_target, target)
        self.trades = self.trades + enter.to(_I32)
        self.prev_c = c

    def outcome(self) -> LifecycleOutcome:
        return LifecycleOutcome(
            equity=self.equity, trades=self.trades, wins=self.wins,
            losses=self.losses, open_at_end=self.side != SIDE_FLAT,
            max_dd=self.dd)


def gated_path_replay(paths: PG.PathBars, levels: Levels, params: EngineParams,
                      gate: GateConfig, tie_uniform, noise=None,
                      noise_normals=None, return_curve: bool = False):
    """Run the gated lifecycle over every path, a Python loop over bars.

    ``tie_uniform`` f32[P, W] holds one same-bar tie coin per bar;
    ``noise`` (sim.montecarlo.McNoise) perturbs the scaffold of each entry
    with that bar's four normals in ``noise_normals`` (f32[4, P, W]: level
    jitter, entry, stop and target slips); gate decisions see the true
    levels.  ``return_curve=True`` also returns the post-bar equity curve
    f32[W, P]."""
    close = torch.as_tensor(paths.close, dtype=_F32)
    w = close.shape[1]
    life = Lifecycle(torch.as_tensor(paths.open, dtype=_F32)[:, 0], levels,
                     params, gate, noise=noise)
    tie = torch.as_tensor(tie_uniform, dtype=_F32)
    curve = []
    for bar in range(w):
        nz = (tuple(n[:, bar] for n in noise_normals)
              if noise is not None else None)
        life.step(bar, paths.high[:, bar], paths.low[:, bar], close[:, bar],
                  tie[:, bar], nz)
        if return_curve:
            curve.append(life.equity)
    out = life.outcome()
    return (out, torch.stack(curve)) if return_curve else out


def _one_block_gated(seed: int, block: int, *, levels, params, gate,
                     block_paths, num_bars, s0, mu, sigma, dt, sampler,
                     antithetic, noise, volume_model, device,
                     symbol: int = 0) -> PathStats:
    paths = pathsim.sample_block(
        seed, block, block_paths=block_paths, num_bars=num_bars, s0=s0, mu=mu,
        sigma=sigma, dt=dt, sampler=sampler, antithetic=antithetic,
        volume_model=volume_model, symbol=symbol, device=device)
    tie = prng.uniform_rows(seed, prng.STREAM_TIE_COIN, block0=block,
                            n_blocks=1, n_rows=num_bars, lanes=block_paths,
                            symbol=symbol, device=device)[0].T
    draws = (pathsim.noise_normals(seed, block, block_paths, device,
                                   num_bars=num_bars, symbol=symbol)
             if noise is not None else None)
    out = gated_path_replay(paths, levels, params, gate, tie, noise=noise,
                            noise_normals=draws)
    return PathStats.from_lifecycle(
        equity=out.equity, trades=out.trades, wins=out.wins, losses=out.losses,
        open_at_end=out.open_at_end, max_dd=out.max_dd)


def mc_paths_gated(seed: int, levels: Levels, params: EngineParams,
                   gate: GateConfig | None = None, *, num_paths: int,
                   num_bars: int = 40, s0=100.0, mu: float = 0.0,
                   sigma: float = 0.15, dt: float = 1.0 / (390.0 * 252.0),
                   sampler: str = "gbm", block_paths: int = 1 << 16,
                   antithetic: bool = False, noise=None, volume_model=None,
                   symbol: int = 0, device=None) -> PathStats:
    """Streamed generated-path MC with the gated multi-trade lifecycle:
    ``num_paths`` paths in blocks of ``block_paths`` (memory holds one block),
    merged into a PathStats over the lifecycle histogram range; ``symbol``
    keys the draws as in ``pathsim.mc_paths``.  Runs on ``device``: the CUDA
    device by default (raising where there is none), the CPU when asked."""
    if gate is None:
        gate = GateConfig.from_params(params)
    if num_paths % block_paths != 0:
        raise ValueError("num_paths must be a multiple of block_paths")
    device = devices.resolve(device)
    levels = levels.to(device)
    out = PathStats.zero(LIFE_HIST_LO, LIFE_HIST_HI, device=device)
    for b in range(num_paths // block_paths):
        out = out.merge(_one_block_gated(
            seed, b, levels=levels, params=params, gate=gate,
            block_paths=block_paths, num_bars=num_bars, s0=s0, mu=mu,
            sigma=sigma, dt=dt, sampler=sampler, antithetic=antithetic,
            noise=noise, volume_model=volume_model, device=device,
            symbol=symbol))
    return out
