"""Generated-path Monte Carlo: sampler → per-path stop/target replay → reductions.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/sim/pathsim.py:34-415``.

Per path: find the first bar whose close lies within CONTACT_PROX of the
nearest level, enter at that close with the level ∓ STOP/TP paddings
scaffold, walk the remaining bars to the first hit with the same-bar tie
coin.  Outcomes reduce to a ``PathStats`` block of sums, counts and a
histogram that is associative, so path blocks combine with ``merge``.

``mc_paths`` streams blocks of ``block_paths`` paths through a Python loop,
so memory holds one block at a time whatever the path count.  The fused
first-contact kernel (``ops/cuda_mc.py``) is the fast path on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import EngineParams
from ..ops import features as F
from ..ops import hitscan as H
from ..ops import pathgen as PG
from ..types import (OUTCOME_OPEN, OUTCOME_STOP, OUTCOME_TP, SIDE_LONG,
                     SIDE_SHORT, Levels)
from ..utils import device as devices
from ..utils import prng
from ..utils.floats import div

HIST_BINS = 128  # R histogram bins
HIST_LO = -1.5   # single-trade R range: stop = -1, tp = reward/risk (≈ 0.714)
HIST_HI = 2.5
# Multi-trade lifecycle totals bin over a wider range (the gated slice).
LIFE_HIST_LO = -6.0
LIFE_HIST_HI = 8.0

_F32 = torch.float32


def _scalar(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32, device=device)


@dataclasses.dataclass
class PathStats:
    """Associative accumulator over path outcomes (combine with ``merge``).

    First-contact replay (``from_outcomes``) takes one trade per path, so
    n_tp + n_stop + n_open == n_entered and sum_trades == n_entered.  Every
    field but ``hist`` is a float32 0-d tensor; ``hist`` is f32[HIST_BINS].
    ``hist_lo``/``hist_hi`` record the histogram's R range; ``merge`` refuses
    to combine mismatched ranges."""

    n: torch.Tensor          # paths counted
    n_tp: torch.Tensor
    n_stop: torch.Tensor
    n_open: torch.Tensor
    n_entered: torch.Tensor  # paths that found a level contact
    sum_r: torch.Tensor
    sum_r2: torch.Tensor
    min_r: torch.Tensor
    max_r: torch.Tensor
    sum_trades: torch.Tensor  # total trades taken across paths
    sum_dd: torch.Tensor      # sum of per-path max drawdown (R, >= 0)
    max_dd: torch.Tensor      # worst per-path drawdown (R, >= 0; 'max' combine)
    hist: torch.Tensor        # f32[HIST_BINS] of R values (entered paths)
    hist_lo: float = HIST_LO
    hist_hi: float = HIST_HI

    @classmethod
    def zero(cls, hist_lo: float = HIST_LO, hist_hi: float = HIST_HI,
             device=None) -> "PathStats":
        z = _scalar(0.0, device)
        return cls(n=z, n_tp=z, n_stop=z, n_open=z, n_entered=z, sum_r=z,
                   sum_r2=z, min_r=_scalar(float("inf"), device),
                   max_r=_scalar(float("-inf"), device),
                   sum_trades=z, sum_dd=z, max_dd=z,
                   hist=torch.zeros((HIST_BINS,), dtype=_F32, device=device),
                   hist_lo=float(hist_lo), hist_hi=float(hist_hi))

    @classmethod
    def from_outcomes(cls, r, outcome, entered) -> "PathStats":
        r = torch.as_tensor(r, dtype=_F32)
        entered = torch.as_tensor(entered, device=r.device).to(torch.bool)
        outcome = torch.as_tensor(outcome, device=r.device)
        w = entered.to(_F32)
        bin_idx = torch.clamp(
            (div(r - HIST_LO, HIST_HI - HIST_LO) * HIST_BINS).to(torch.int32),
            0, HIST_BINS - 1)
        hist = torch.zeros((HIST_BINS,), dtype=_F32, device=r.device)
        hist.index_add_(0, bin_idx.to(torch.int64), w)
        inf = float("inf")
        # single-trade equity curve: peak = max(0, r), so drawdown = max(0, -r)
        dd = torch.clamp(-r, min=0.0) * w
        return cls(
            n=torch.ones_like(r).sum(),
            n_tp=(w * (outcome == OUTCOME_TP)).sum(),
            n_stop=(w * (outcome == OUTCOME_STOP)).sum(),
            n_open=(w * (outcome == OUTCOME_OPEN)).sum(),
            n_entered=w.sum(),
            sum_r=(w * r).sum(),
            sum_r2=(w * r * r).sum(),
            min_r=torch.where(entered, r, inf).min(),
            max_r=torch.where(entered, r, -inf).max(),
            sum_trades=w.sum(),
            sum_dd=dd.sum(),
            max_dd=torch.clamp(dd.max(), min=0.0),
            hist=hist,
        )

    @classmethod
    def from_lifecycle(cls, *, equity, trades, wins, losses, open_at_end,
                       max_dd, hist_lo: float = LIFE_HIST_LO,
                       hist_hi: float = LIFE_HIST_HI) -> "PathStats":
        """Multi-trade per-path accumulator (sim/gatedpath.py): ``equity`` is
        the per-path total R; hist/min/max/moments cover path totals;
        n_tp/n_stop count trades; n_open counts paths left holding a
        position."""
        equity = torch.as_tensor(equity, dtype=_F32)
        dev = equity.device
        trades = torch.as_tensor(trades, device=dev).to(_F32)
        entered = trades > 0
        w = entered.to(_F32)
        bin_idx = torch.clamp(
            (div(equity - hist_lo, hist_hi - hist_lo) * HIST_BINS).to(torch.int32),
            0, HIST_BINS - 1)
        hist = torch.zeros((HIST_BINS,), dtype=_F32, device=dev)
        hist.index_add_(0, bin_idx.to(torch.int64), w)
        inf = float("inf")
        dd = torch.as_tensor(max_dd, device=dev).to(_F32) * w
        return cls(
            n=torch.ones_like(equity).sum(),
            n_tp=torch.as_tensor(wins, device=dev).to(_F32).sum(),
            n_stop=torch.as_tensor(losses, device=dev).to(_F32).sum(),
            n_open=(torch.as_tensor(open_at_end, device=dev).to(_F32) * w).sum(),
            n_entered=w.sum(),
            sum_r=(w * equity).sum(),
            sum_r2=(w * equity * equity).sum(),
            min_r=torch.where(entered, equity, inf).min(),
            max_r=torch.where(entered, equity, -inf).max(),
            sum_trades=trades.sum(),
            sum_dd=dd.sum(),
            max_dd=torch.clamp(dd.max(), min=0.0),
            hist=hist,
            hist_lo=float(hist_lo),
            hist_hi=float(hist_hi),
        )

    def merge(self, other: "PathStats") -> "PathStats":
        if (self.hist_lo, self.hist_hi) != (other.hist_lo, other.hist_hi):
            raise ValueError(
                f"cannot merge PathStats with different histogram ranges: "
                f"[{self.hist_lo}, {self.hist_hi}] vs "
                f"[{other.hist_lo}, {other.hist_hi}]")
        return PathStats(
            n=self.n + other.n,
            n_tp=self.n_tp + other.n_tp,
            n_stop=self.n_stop + other.n_stop,
            n_open=self.n_open + other.n_open,
            n_entered=self.n_entered + other.n_entered,
            sum_r=self.sum_r + other.sum_r,
            sum_r2=self.sum_r2 + other.sum_r2,
            min_r=torch.minimum(self.min_r, other.min_r),
            max_r=torch.maximum(self.max_r, other.max_r),
            sum_trades=self.sum_trades + other.sum_trades,
            sum_dd=self.sum_dd + other.sum_dd,
            max_dd=torch.maximum(self.max_dd, other.max_dd),
            hist=self.hist + other.hist,
            hist_lo=self.hist_lo,
            hist_hi=self.hist_hi,
        )

    @classmethod
    def stack(cls, rows: list["PathStats"]) -> "PathStats":
        """[G] PathStats from G of them (all over one histogram range): every
        field gains a leading [G] axis, the form of JAX's vmapped PathStats.
        ``merge`` and the derived metrics work elementwise on it; ``row``
        takes one back out."""
        ranges = {(r.hist_lo, r.hist_hi) for r in rows}
        if len(ranges) != 1:
            raise ValueError(f"cannot stack PathStats over histogram ranges {sorted(ranges)}")
        ((lo, hi),) = ranges
        return cls(**{f.name: torch.stack([getattr(r, f.name) for r in rows])
                      for f in dataclasses.fields(cls) if f.name not in ("hist_lo", "hist_hi")},
                   hist_lo=lo, hist_hi=hi)

    def row(self, g: int) -> "PathStats":
        """Row ``g`` of a stacked [G] PathStats."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name)[g] for f in dataclasses.fields(self)
            if f.name not in ("hist_lo", "hist_hi")})

    def _one_histogram(self, what: str) -> None:
        if self.hist.dim() != 1:
            raise ValueError(f"{what} of a stacked [G] PathStats: take .row(g) first")

    # ---- derived metrics ----
    @property
    def mean_r(self):
        return self.sum_r / torch.clamp(self.n_entered, min=1.0)

    @property
    def std_r(self):
        m = self.mean_r
        return torch.sqrt(torch.clamp(
            self.sum_r2 / torch.clamp(self.n_entered, min=1.0) - m * m, min=0.0))

    @property
    def hit_rate(self):
        return self.n_tp / torch.clamp(self.n_tp + self.n_stop, min=1.0)

    @property
    def mean_trades(self):
        """Trades per entered path (1.0 exactly for first-contact replay)."""
        return self.sum_trades / torch.clamp(self.n_entered, min=1.0)

    @property
    def mean_dd(self):
        """Mean per-path max drawdown in R."""
        return self.sum_dd / torch.clamp(self.n_entered, min=1.0)

    def quantile(self, q):
        """Histogram-estimated R quantile: binned-CDF inversion over this
        accumulator's own [hist_lo, hist_hi] range, interpolated in the bin."""
        self._one_histogram("quantile")
        nb = self.hist.shape[-1]
        cdf = torch.cumsum(self.hist, dim=-1)
        target = _scalar(q, self.hist.device) * cdf[-1]
        idx = torch.clamp(torch.searchsorted(cdf, target.reshape(1),
                                             side="left")[0], 0, nb - 1)
        prev = torch.where(idx > 0, cdf[idx - 1], 0.0)
        frac = torch.where(self.hist[idx] > 0,
                           (target - prev) / torch.clamp(self.hist[idx], min=1.0),
                           0.0)
        w = (self.hist_hi - self.hist_lo) / nb
        return self.hist_lo + (idx.to(_F32) + frac) * w

    def cvar(self, q=0.05):
        """Histogram-estimated mean of the lower q tail."""
        self._one_histogram("cvar")
        nb = self.hist.shape[-1]
        cdf = torch.cumsum(self.hist, dim=-1)
        cutoff = _scalar(q, self.hist.device) * cdf[-1]
        w = (self.hist_hi - self.hist_lo) / nb
        centers = self.hist_lo + (torch.arange(nb, dtype=_F32,
                                               device=self.hist.device) + 0.5) * w
        prev_cdf = torch.cat([torch.zeros((1,), dtype=_F32,
                                          device=self.hist.device), cdf[:-1]])
        take = torch.minimum(torch.clamp(cutoff - prev_cdf, min=0.0), self.hist)
        return (take * centers).sum() / torch.clamp(cutoff, min=1.0)


def path_replay(paths: PG.PathBars, levels: Levels, params: EngineParams,
                tie_uniform, noise=None, noise_normals=None):
    """Replay the level-contact trade on each generated path.

    Returns (r, outcome, entered) over the path axis.  Entry: first bar with
    close within CONTACT_PROX of the nearest level; side from the move into
    that bar (long if the close rose, short otherwise); stop/target = level ∓
    paddings.  ``noise`` (sim.montecarlo.McNoise) perturbs the scaffold with
    the per-path standard normals ``noise_normals`` = (level jitter, entry,
    stop, target), f32[4, P]; contact detection still sees the true levels."""
    close = paths.close                             # [P, W]
    p, w = close.shape
    dev = close.device
    idx, dist = F.nearest_level(levels, close)      # [P, W]
    near = dist <= params.contact_prox
    # side needs a previous close: bar 0 compares against the open
    prev = torch.cat([paths.open[:, :1], close[:, :-1]], dim=1)
    entered = near.any(dim=1)
    ebar = torch.where(entered, torch.argmax(near.to(torch.uint8), dim=1), 0)

    rows = torch.arange(p, device=dev)
    lvl = levels.price[idx[rows, ebar].to(torch.int64)]
    entry = close[rows, ebar]
    side = torch.where(entry > prev[rows, ebar], SIDE_LONG, SIDE_SHORT)
    if noise is not None:
        nj, ne, ns, nt = noise_normals
        lvl = lvl + nj * noise.level_jitter_std.to(dev)
        entry = entry + ne * noise.entry_slip_std.to(dev)
    is_long = side == SIDE_LONG
    stop = torch.where(is_long, lvl - params.stop_padding, lvl + params.stop_padding)
    target = torch.where(is_long, lvl + params.tp_padding, lvl - params.tp_padding)
    if noise is not None:
        stop = stop + ns * noise.stop_slip_std.to(dev)
        target = target + nt * noise.target_slip_std.to(dev)

    after = torch.arange(w, device=dev)[None, :] > ebar[:, None]
    r, outcome = H.stop_target_outcome(
        highs=paths.high, lows=paths.low, side=side, entry=entry, stop=stop,
        target=target, tie_uniform=tie_uniform, valid_mask=after)
    r = torch.where(entered, r, 0.0)
    outcome = torch.where(entered, outcome, OUTCOME_OPEN)
    return r, outcome, entered


def sample_block(seed: int, block: int, *, block_paths, num_bars, s0, mu,
                 sigma, dt, sampler="gbm", antithetic=False, volume_model=None,
                 symbol: int = 0, device=None) -> PG.PathBars:
    """One path block of global index ``block`` (of universe symbol
    ``symbol``) from the named sampler.  Only "gbm" is ported; the others
    raise."""
    if sampler != "gbm":
        raise NotImplementedError(
            f"sampler {sampler!r} is not ported yet (gbm only)")
    return PG.gbm_paths(seed, block, num_paths=block_paths, num_bars=num_bars,
                        s0=s0, mu=mu, sigma=sigma, dt=dt,
                        antithetic=antithetic, volume_model=volume_model,
                        symbol=symbol, device=device)


def noise_normals(seed: int, block: int, n: int, device=None,
                  num_bars: int | None = None, symbol: int = 0) -> tuple:
    """The four execution-noise standard-normal draws (level jitter, entry
    slip, stop slip, target slip) of one block, each on its own stream:
    f32[n] each, or f32[n, num_bars] (one draw per path and bar, the shape
    the gated lifecycle takes) when ``num_bars`` is given."""
    rows = 1 if num_bars is None else num_bars
    out = tuple(
        prng.normal_rows(seed, s, block=block, n_rows=rows, lanes=n,
                         symbol=symbol, device=device)
        for s in (prng.STREAM_LEVEL_JITTER, prng.STREAM_ENTRY_SLIP,
                  prng.STREAM_STOP_SLIP, prng.STREAM_TARGET_SLIP))
    if num_bars is None:
        return tuple(x[0] for x in out)
    return tuple(x.T for x in out)


def mc_paths(seed: int, levels: Levels, params: EngineParams, *,
             num_paths: int, num_bars: int = 40, s0=100.0, mu: float = 0.0,
             sigma: float = 0.15, dt: float = 1.0 / (390.0 * 252.0),
             sampler: str = "gbm", block_paths: int = 1 << 16,
             antithetic: bool = False, noise=None, volume_model=None,
             symbol: int = 0, device=None) -> PathStats:
    """Streamed generated-path MC: ``num_paths`` paths in blocks of
    ``block_paths``; returns the merged PathStats.  ``noise``
    (sim.montecarlo.McNoise) adds the reference MC's execution-noise
    gaussians per path.  ``symbol`` keys every draw as universe symbol
    ``symbol`` does (``parallel.universe``; 0 is the single run).  Runs on
    ``device``: the CUDA device by default (raising where there is none), the
    CPU when asked."""
    if num_paths % block_paths != 0:
        raise ValueError("num_paths must be a multiple of block_paths")
    device = devices.resolve(device)
    levels = levels.to(device)
    out = PathStats.zero(device=device)
    for b in range(num_paths // block_paths):
        paths = sample_block(seed, b, block_paths=block_paths,
                             num_bars=num_bars, s0=s0, mu=mu, sigma=sigma,
                             dt=dt, sampler=sampler, antithetic=antithetic,
                             volume_model=volume_model, symbol=symbol,
                             device=device)
        tie = prng.uniform_rows(seed, prng.STREAM_TIE_COIN, block0=b,
                                n_blocks=1, n_rows=1, lanes=block_paths,
                                symbol=symbol, device=device)[0, 0]
        draws = (noise_normals(seed, b, block_paths, device, symbol=symbol)
                 if noise is not None else None)
        r, outcome, entered = path_replay(paths, levels, params, tie,
                                          noise=noise, noise_normals=draws)
        out = out.merge(PathStats.from_outcomes(r, outcome, entered))
    return out
