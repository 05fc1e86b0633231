"""Correlated books: S symbols on one market factor, with book-level risk.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/parallel/portfolio.py:60-167,
177-356, 359-588``, under every sampler.  The reference trades one ticker; a book
trades S symbols whose shocks share a market factor,

    z_s = beta_s * z_mkt + sqrt(1 - beta_s^2) * eps_s,

and sums the symbols' weighted per-bar equity curves, per path, into the
book's curve: its final value gives the book's VaR/CVaR, and its drawdown is
tracked over time (``sim/book.py``), which no aggregation of per-symbol
results can give.

* ``bars_from_shocks`` -- GBM OHLC bars from given shocks (``_bars_from_shocks``);
* ``portfolio_mc`` -- the streamed book over the gated lifecycle
  (``sim.gatedpath``), returning ([S] PathStats, book PathStats);
* ``portfolio_mc_engine`` -- the same over the full 12-gate engine
  (``sim.enginepath``), the mixed shock also driving each symbol's volume,
  returning ([S] PathStats, book PathStats, int64 [S, 16] skip tables, int64
  [S] escalations).

Each block of ``block_paths`` paths draws the market normal once (stream
``STREAM_MARKET`` at symbol 0, shared by every symbol) and walks the
symbols in order; symbol s's idiosyncratic, bridge, tie and volume draws are
its universe draws (``prng.stream_key``), so with beta = 0 symbol s equals
row s of ``parallel.universe.universe_mc`` (or ``sim.enginepath.mc_paths_engine``
at ``symbol=s``) bit for bit.  Antithetic books pair the market and the
idiosyncratic normals alike (path halves).  The fused kernels are
``ops/cuda_gated.mc_paths_gated_corr_fused`` (#7) and
``ops/cuda_engine.mc_paths_engine_corr_fused`` (#12).

The other samplers ride the same split.  ``bootstrap`` and
``block_bootstrap`` replay joint recorded days: a block's recorded-bar
indices are drawn once on the market stream (``ops/pathgen.
joint_resample_idx``) and every symbol gathers them from its own [S, H]
history, rebased on its own s0 (beta unused; the ties stay the symbol's;
the engine sees the recorded volumes).  ``heston`` draws the market's price
and variance normals as the two Box-Muller branches of 2W market rows (the
variance's on ``key_for(key, STREAM_MARKET, b, 1)`` in JAX), a symbol's own
likewise on its ``STREAM_PATH`` rows, mixes each pair with the symbol's
loading and steps the variance (``ops/pathgen.heston_bars_from_shocks``);
its volume comes from the volume model on the mixed price shock.

``portfolio_mc_engine(harvest=True)`` also returns each symbol's
closed-trade label harvest (``models/harvest.EngineHarvest``), the
flywheel's input from correlated books.  Not ported yet: ``exact_tail_book``
(the exact tail).
"""

from __future__ import annotations

import torch

from ..models import harvest as HV
from ..ops import pathgen as PG
from ..ops.draws import SAMPLERS
from ..ops.kernel_args import symbol_rows
from ..ops.samplers import Sampler, make_sampler
from ..sim import enginepath
from ..sim.book import BookCurve, mix_shocks
from ..sim.gatedpath import GateConfig, gated_path_replay
from ..sim.pathsim import LIFE_HIST_HI, LIFE_HIST_LO, PathStats
from ..types import Levels
from ..utils import device as devices
from ..utils import prng

_DT = 1.0 / (390.0 * 252.0)


def bars_from_shocks(z, u_hi, u_lo, *, s0, mu: float = 0.0, sigma: float = 0.15,
                     dt: float = _DT, volume=None) -> PG.PathBars:
    """GBM OHLC bars f32[P, W] from given close-to-close shocks ``z`` and
    bridge uniforms ``u_hi`` / ``u_lo`` (``ops.pathgen.gbm_bars_from_draws``
    with the normal draw replaced by the correlated combination); ``volume``
    defaults to zeros (the gated lifecycle never reads it)."""
    return PG.gbm_bars_from_draws(z, u_hi, u_lo, s0=s0, mu=mu, sigma=sigma, dt=dt,
                                  volume=volume)


def _check(sampler: str, antithetic: bool, block_paths: int, num_paths: int, *, n_sym: int,
           hist_bars, block_len: int) -> Sampler:
    """The JAX book's checks (``parallel/portfolio.py:217-232``); returns the
    book's ``Sampler``: [S, 5, H] tables of the [S, H] ``hist_bars``
    (bootstrap), or the sampler alone (its Heston constants are
    ``heston_bars_from_shocks``' float32 values)."""
    if sampler not in SAMPLERS:
        raise ValueError(f"book samplers: {' | '.join(repr(s) for s in SAMPLERS)}")
    if antithetic and sampler != "gbm":
        raise ValueError("book antithetic pairs gbm normals only")
    if antithetic and block_paths % 2 != 0:
        raise ValueError("antithetic requires an even block_paths")
    if num_paths % block_paths != 0:
        raise ValueError("num_paths must be a multiple of block_paths")
    if sampler in ("bootstrap", "block_bootstrap"):
        if hist_bars is None:
            raise ValueError(f"sampler={sampler!r} requires hist_bars ([S, H] recorded "
                             "o/h/l/c/v histories)")
        return make_sampler(sampler, hist_bars=hist_bars, block_len=block_len,
                            symbols=n_sym)
    return Sampler(sampler)


def _normals(seed: int, stream: int, block: int, *, num_paths: int, num_bars: int,
             antithetic: bool, symbol: int, device) -> torch.Tensor:
    """f32[P, W] normals of one block as ``ops.pathgen.gbm_paths`` draws
    them (W = 2 x bars: the price and variance normals as
    ``ops.pathgen.heston_paths`` draws them); with ``antithetic`` the second
    half of the paths is the first half negated."""
    n = num_paths // 2 if antithetic else num_paths
    z = prng.normal_rows(seed, stream, block=block, n_rows=num_bars, lanes=n,
                         symbol=symbol, device=device).T
    return torch.cat([z, -z], dim=0) if antithetic else z


def _book_block(seed: int, block: int, rows: list, replay, *, block_paths: int,
                num_bars: int, mu: float, dt: float, antithetic: bool,
                volume_model, sampler: Sampler, heston, device):
    """One block of the book: ([S] per-symbol (outcome, PathStats), book
    PathStats).  ``replay(s, bars, tie, row)`` runs symbol s's lifecycle and
    returns (outcome, post-bar equity curve f32[W, P])."""
    hes = sampler.kind == "heston"
    kw = dict(num_paths=block_paths, num_bars=num_bars * (2 if hes else 1),
              antithetic=antithetic, device=device)
    if sampler.resamples:
        idx = PG.joint_resample_idx(seed, block, num_paths=block_paths, num_bars=num_bars,
                                    n_hist=sampler.hist_len, block_len=sampler.block_len,
                                    device=device)
    else:
        z_mkt = _normals(seed, prng.STREAM_MARKET, block, symbol=0, **kw)
    book = BookCurve(block_paths, num_bars, device=device)

    def uniforms(stream, s):
        return prng.uniform_rows(seed, stream, block0=block, n_blocks=1, n_rows=num_bars,
                                 lanes=block_paths, symbol=s, device=device)[0].T

    per_symbol = []
    for s, row in enumerate(rows):
        lv, s0_s, sg_s, beta_s, w_s = row[0], row[1], row[2], row[-2], row[-1]
        if sampler.resamples:
            bars = PG.bootstrap_bars_from_draws(idx, sampler.row(s).tables.to(device),
                                                s0=s0_s)
        else:
            zs = mix_shocks(beta_s, z_mkt, _normals(seed, prng.STREAM_PATH, block, symbol=s,
                                                    **kw))
            z = zs[:, :num_bars]
            volume = (None if volume_model is None else volume_model.volumes(
                seed, block, z, num_paths=block_paths, num_bars=num_bars, symbol=s,
                device=device))
            bridge = (uniforms(prng.STREAM_BRIDGE_HI, s), uniforms(prng.STREAM_BRIDGE_LO, s))
            if hes:
                bars = PG.heston_bars_from_shocks(z, zs[:, num_bars:], *bridge, s0=s0_s,
                                                  heston=heston, mu=mu, dt=dt, volume=volume)
            else:
                bars = bars_from_shocks(z, *bridge, s0=s0_s, mu=mu, sigma=sg_s, dt=dt,
                                        volume=volume)
        out, curve = replay(s, bars, uniforms(prng.STREAM_TIE_COIN, s), row)
        book.add_curve(w_s, curve)
        book.add_symbol(out)
        per_symbol.append((out, PathStats.from_lifecycle(
            equity=out.equity, trades=out.trades, wins=out.wins, losses=out.losses,
            open_at_end=out.open_at_end, max_dd=out.max_dd)))
    b = book.outcome()
    return per_symbol, PathStats.from_lifecycle(
        equity=b.equity, trades=b.trades, wins=b.wins, losses=b.losses,
        open_at_end=b.open_at_end, max_dd=b.max_dd)


def _f32_rows(rows: list) -> list:
    """Spot and volatility as float32 values, as the JAX pipeline takes them."""
    from ..ops.kernel_args import f32

    return [(r[0], f32(r[1]), f32(r[2]), *r[3:]) for r in rows]


def _stream(seed, rows, replay, *, num_paths, block_paths, device, tally=None, **kw):
    """Every block of the book, merged: ([S] PathStats, book PathStats, and
    with ``tally`` the per-symbol sums over blocks of ``tally(outcome)``)."""
    zero = PathStats.zero(LIFE_HIST_LO, LIFE_HIST_HI, device=device)
    sym, book, tallies = [zero] * len(rows), zero, [0] * len(rows)
    for b in range(num_paths // block_paths):
        per_symbol, book_b = _book_block(seed, b, rows, replay, block_paths=block_paths,
                                         device=device, **kw)
        sym = [acc.merge(st) for acc, (_, st) in zip(sym, per_symbol)]
        book = book.merge(book_b)
        if tally is not None:
            tallies = [acc + tally(out) for acc, (out, _) in zip(tallies, per_symbol)]
    return PathStats.stack(sym), book, tallies


def portfolio_mc(seed: int, levels: Levels, params, s0, sigma, beta, weights,
                 gate: GateConfig | None = None, *, num_paths: int, num_bars: int = 40,
                 dt: float = _DT, mu: float = 0.0, block_paths: int = 1 << 13,
                 sampler: str = "gbm", hist_bars=None, block_len: int = 10,
                 heston: dict | None = None, antithetic: bool = False,
                 device=None) -> tuple[PathStats, PathStats]:
    """Correlated book over the gated lifecycle: ([S] PathStats, book
    PathStats).  ``levels`` is [S, L]; s0, sigma, beta and weights are
    scalars or [S]; ``params``' leaves are scalars or [S] (its knobs per
    symbol); ``gate`` (default ``GateConfig.from_params(params)``) is shared.
    Path p carries the same market shocks in every symbol, so the book's
    fields are a joint Monte Carlo: its histogram, quantile and cvar describe
    the book's final R per path, ``max_dd`` the worst drawdown of the book's
    curve, ``n_tp`` / ``n_stop`` / ``sum_trades`` the trades of the whole
    book and ``n_entered`` the paths on which any symbol traded.  Samplers
    as ``portfolio_mc_engine``'s: ``bootstrap`` / ``block_bootstrap`` (joint
    recorded days over ``hist_bars``, [S, H] o/h/l/c/v, runs of
    ``block_len`` bars) and ``heston`` (a dict of v0/kappa/theta/xi/rho).
    Runs on ``device``: the CUDA device by default (raising where there is
    none), the CPU when asked."""
    rows = _f32_rows(symbol_rows(levels, s0, sigma, params, beta=beta, weights=weights))
    samp = _check(sampler, antithetic, block_paths, num_paths, n_sym=len(rows),
                  hist_bars=hist_bars, block_len=block_len)
    device = devices.resolve(device)
    if gate is None:
        gate = GateConfig.from_params(params)

    def replay(s, bars, tie, row):
        return gated_path_replay(bars, row[0].to(device), row[3], gate, tie,
                                 return_curve=True)

    sym, book, _ = _stream(seed, rows, replay, num_paths=num_paths,
                           block_paths=block_paths, num_bars=num_bars, mu=mu, dt=dt,
                           antithetic=antithetic, volume_model=None, sampler=samp,
                           heston=heston, device=device)
    return sym, book


def portfolio_mc_engine(seed: int, levels: Levels, params, s0, sigma, beta, weights, *,
                        num_paths: int, num_bars: int = 40, dt: float = _DT,
                        mu: float = 0.0, block_paths: int = 1 << 12, policy=None,
                        ml_model=None, touch_params=None, guard_params=None,
                        policy_gate_disabled: bool | None = None,
                        escalation: bool = True, bar0_minute: int = 0,
                        volume_model: PG.VolumeModel | None = None,
                        harvest: bool = False, sampler: str = "gbm", hist_bars=None,
                        block_len: int = 10, heston: dict | None = None,
                        antithetic: bool = False, device=None):
    """Correlated book under the full 12-gate engine: ([S] PathStats, book
    PathStats, int64 [S, 16] first-fail skip tables ordered as
    ``sim.enginepath.SKIP_REASONS``, int64 [S] escalations).  Each symbol
    runs ``sim.enginepath.engine_path_replay`` over its own bars, its
    synthetic volumes driven by its mixed shock (``ops.pathgen.VolumeModel``),
    so a market-wide move prints volume on every symbol.  Arguments as in
    ``portfolio_mc``; the engine records (policy, ML model, touch and guard
    parameters) are shared.  Under ``bootstrap`` / ``block_bootstrap`` every
    symbol replays the same recorded day, gathered from its own history with
    its recorded volumes; under ``heston`` the market factor moves both the
    price and the variance shocks through the same loading.
    ``harvest=True`` returns a 5-tuple ending in the [S]-batched
    ``models/harvest.EngineHarvest`` (JAX portfolio.py:407, :547-584)."""
    rows = _f32_rows(symbol_rows(levels, s0, sigma, params, beta=beta, weights=weights))
    samp = _check(sampler, antithetic, block_paths, num_paths, n_sym=len(rows),
                  hist_bars=hist_bars, block_len=block_len)
    device = devices.resolve(device)
    engine_kw = dict(policy=policy, ml_model=ml_model, touch_params=touch_params,
                     guard_params=guard_params, policy_gate_disabled=policy_gate_disabled,
                     escalation=escalation, bar0_minute=bar0_minute)

    hvs = [HV.EngineHarvest.zero(device=device) for _ in rows]

    def replay(s, bars, tie, row):
        out, curve = enginepath.engine_path_replay(bars, row[0].to(device), row[3], tie,
                                                   return_curve=True, harvest=harvest,
                                                   **engine_kw)
        if harvest:
            hvs[s] = hvs[s].merge(out.harvest)
        return out, curve

    def tally(out):
        return torch.cat([out.skip_counts.to(torch.int64),
                          out.escalations.sum(dtype=torch.int64)[None]])

    sym, book, tallies = _stream(
        seed, rows, replay, num_paths=num_paths, block_paths=block_paths,
        num_bars=num_bars, mu=mu, dt=dt, antithetic=antithetic,
        volume_model=PG.VolumeModel() if volume_model is None else volume_model,
        sampler=samp, heston=heston, device=device, tally=tally)
    tallies = torch.stack(tallies)
    skips, escal = tallies[:, :-1], tallies[:, -1]
    return (sym, book, skips, escal) + ((HV.stack(hvs),) if harvest else ())


def exact_tail_book(*args, **kwargs):
    """Exact book VaR/CVaR by distributed selection (JAX
    ``parallel/portfolio.py:591-721``): not ported yet."""
    raise NotImplementedError("exact_tail_book is not ported yet (the exact-tail "
                              "selection, with sim/tailexact.py)")
