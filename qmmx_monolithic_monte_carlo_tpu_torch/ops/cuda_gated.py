"""Fused gated lifecycle: generate -> multi-trade gated lifecycle -> reduce, as one CUDA kernel.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:1067-1565``
and ``:1825-1971`` (kernel #4, ``_gated_kernel`` with ``_gated_lifecycle_loop``
and ``_gated_accumulate``, entry ``mc_paths_pallas_gated`` ``:2381-2390``),
gbm sampler only; the bootstrap, block-bootstrap and Heston branches are not
ported yet.

* ``mc_paths_gated_fused`` -- the entry.  For a CUDA device it launches
  ``ops/csrc/mc_gated.cu`` (pass 1: the sweep kernel at one grid row, one
  thread per path, one partial row per CTA; pass 2: a fixed-order fold of
  the rows) or raises.  For the CPU it runs the plain version.
* ``gated_totals_reference`` -- the plain PyTorch version: the TPU kernel's
  double-bar streaming loop over (block, 8, lanes) tensors, driving the
  ``sim.gatedpath.Lifecycle`` state machine; optionally per path.
* ``mc_paths_gated_sweep_fused`` -- the gate-knob grid sweep under common
  random numbers, the counterpart of ``mc_paths_pallas_gated_sweep``
  (kernel #6, ``_gated_sweep_kernel``, ``pallas_mc.py:2163-2401``): the whole
  lifecycle re-run for every row of (stop, tp, gate knobs, noise stds) on the
  same uniforms; row g equals ``mc_paths_gated_fused`` under row g's knobs,
  bit for bit.  A CUDA device launches ``mc_gated_sweep_kernel`` (CTAs x G)
  and one fold of all rows, or raises; the CPU runs
  ``gated_sweep_totals_reference``.
* ``mc_paths_gated_universe_fused`` -- the per-symbol gated universe, the
  counterpart of ``mc_paths_pallas_gated_universe`` (kernel #5,
  ``_gated_universe_kernel``, ``pallas_mc.py:1568-1822``, ``:2404-2414``):
  S symbols in one launch of ``mc_gated_sweep_kernel`` with one row per
  symbol (its levels, s0, sigma, knobs, noise stds and key
  ``prng.stream_key``; the gate knobs shared); row s equals
  ``mc_paths_gated_fused`` at symbol s's inputs and ``symbol=s``, bit for
  bit.  The CPU runs ``gated_universe_totals_reference``.
* ``LAUNCHES`` -- how many times each kernel was launched.

Uniforms follow ``ops/draws.GatedLayout``: injected as
``external_uniforms`` f32[n_blocks, u_rows, 8, lanes] (the JAX shape), or
drawn from Philox (``ops/draws.gated_uniforms``; the kernel computes the same
bits).  Counts stay int64 until ``stats_from_gated_totals`` turns them into
the float32 ``PathStats``.  (The TPU kernel sums trades, wins and losses in
float32 rows, which stop being exact past 2^24.)
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..sim.book import BookCurve, mix_shocks
from ..sim.gatedpath import GateConfig, Lifecycle
from ..sim.pathsim import HIST_BINS, LIFE_HIST_HI, LIFE_HIST_LO, PathStats
from ..types import KIND_SOLID, Levels
from ..utils import build, prng
from ..utils import device as devices
from .draws import (GATED_STREAM, GATED_SUB, MARKET_STREAM, GatedLayout, MarketLayout,
                    gated_uniforms)
from .draws import market_uniforms as draws_market
from .kernel_args import (BLOCK, MAX_LEVELS, book_pairs, check_blocks, check_uniforms, consts,
                          device_rows, f32, fold_rows, grid_columns, grid_len, grid_row,
                          grid_rows, grid_size, knob_columns, launch_pointer, symbol_columns,
                          symbol_rows, symbol_uniforms)

GATED_LANES = 1024       # logical lanes per block row (one block = 8 x lanes paths)
N_COUNTS = 6             # n, entered, wins, losses, open, trades
ROW_COUNTS = N_COUNTS + HIST_BINS
ROW_FLOATS = 6           # sum_eq, sum_eq2, sum_dd, min_eq, max_eq, max_dd
PATH_COLS = 6            # per-path output: equity, trades, wins, losses, open, dd
# the TPU kernel's lifecycle binning: (equity - LO) * f32(BINS / (HI - LO))
LIFE_BIN_SCALE = f32(HIST_BINS / (LIFE_HIST_HI - LIFE_HIST_LO))
_BIG = 3.4e38
_SOURCE = "mc_gated"
MAX_CURVE_SHARED_BYTES = 160 * 1024  # the book's curves in shared memory (W x BLOCK
                                     # floats, 40 KB at W = 40), beside its 227 KB less the rest

# Kernel launches, counted by the wrappers where they launch and nowhere else.
LAUNCHES = {"mc_gated": 0, "mc_gated_reduce_rows": 0, "mc_gated_sweep": 0,
            "mc_gated_sweep_reduce_rows": 0, "mc_gated_universe": 0,
            "mc_gated_universe_reduce_rows": 0, "mc_gated_corr": 0,
            "mc_gated_corr_reduce_rows": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class _GatedArgs(ctypes.Structure):
    """Mirror of ``struct GatedArgs`` in ops/csrc/mc_gated.cu."""

    _fields_ = [
        ("num_paths", ctypes.c_int64), ("ext_offset", ctypes.c_int64),
        ("level_price", ctypes.c_float * MAX_LEVELS),
        ("level_valid", ctypes.c_float * MAX_LEVELS),
        ("level_kind", ctypes.c_int32 * MAX_LEVELS),
        ("prox", ctypes.c_float), ("stop_pad", ctypes.c_float),
        ("tp_pad", ctypes.c_float),
        ("lvl_jit", ctypes.c_float), ("entry_slip", ctypes.c_float),
        ("stop_slip", ctypes.c_float), ("tgt_slip", ctypes.c_float),
        ("qmin", ctypes.c_float), ("drift", ctypes.c_float),
        ("sig_dt", ctypes.c_float), ("log_s0", ctypes.c_float),
        ("seed", ctypes.c_uint32), ("stream", ctypes.c_uint32),
        ("touch_limit", ctypes.c_int32), ("cooldown_bars", ctypes.c_int32),
        ("touch_gap", ctypes.c_int32), ("use_conf", ctypes.c_int32),
        ("max_levels", ctypes.c_int32), ("num_bars", ctypes.c_int32),
        ("lanes", ctypes.c_int32), ("u_rows", ctypes.c_int32),
        ("use_noise", ctypes.c_int32), ("antithetic", ctypes.c_int32),
    ]


def _check(seed, levels, *, num_paths, num_bars, lanes, noise, antithetic,
           external_uniforms) -> GatedLayout:
    """The checks of ``_mc_paths_pallas_gated_jit`` (pallas_mc.py:1882-1899)."""
    check_blocks(seed, levels, num_paths=num_paths, lanes=lanes, sub=GATED_SUB,
                 what="gated")
    layout = GatedLayout(num_bars, noise is not None)
    check_uniforms(external_uniforms,
                   (num_paths // (GATED_SUB * lanes), layout.u_rows, GATED_SUB, lanes),
                   antithetic=antithetic, lanes=lanes)
    return layout


# --------------------------------------------------------------------------
# the plain PyTorch version
# --------------------------------------------------------------------------

def box_muller(u1, u2):
    """(r cos a, r sin a) of radius draw ``u1`` and angle draw ``u2``."""
    radius = torch.sqrt(-2.0 * torch.log(u1))
    angle = prng.TWO_PI * u2
    return radius * torch.cos(angle), radius * torch.sin(angle)


def gated_bar(log_s, z, u3, u4, drift: float, sig_dt: float):
    """One streamed GBM bar (pallas_mc.py:1376-1384): (log_close, close,
    high, low) from the previous log close, the normal ``z`` and the bridge
    uniforms; float32 in the TPU kernel's order."""
    log_close = log_s + (drift + sig_dt * z)
    two_s2 = f32(2.0 * f32(sig_dt * sig_dt))
    diff = log_close - log_s
    d2 = diff * diff
    mid = log_s + log_close
    high = torch.exp(0.5 * (mid + torch.sqrt(d2 - two_s2 * torch.log(u3))))
    low = torch.exp(0.5 * (mid - torch.sqrt(d2 - two_s2 * torch.log(u4))))
    return log_close, torch.exp(log_close), high, low


def gated_bars_from_uniforms(u: torch.Tensor, layout: GatedLayout, *, s0=100.0,
                             mu: float = 0.0, sigma: float = 0.15,
                             dt: float = 1.0 / (390.0 * 252.0),
                             antithetic: bool = False, market_uniforms=None,
                             beta: float = 0.0):
    """The bars the plain version generates from uniforms f32[nb, u_rows, 8,
    lanes]: (PathBars f32[P, W], tie f32[P, W], noise normals f32[4, P, W] or
    None), path p = block * 8 * lanes + s * lanes + j.  For replaying them
    through ``sim.gatedpath.gated_path_replay``.  A book symbol's bars mix
    the market normals of ``market_uniforms`` f32[nb, W, 8, lanes] with
    loading ``beta`` into its own."""
    from .pathgen import PathBars

    drift, sig_dt, log_s0 = consts(s0, mu, sigma, dt)
    nb, _, sub, lanes = u.shape
    log_s = torch.full((nb, sub, lanes), log_s0, dtype=torch.float32,
                       device=u.device)
    cols = {k: [] for k in ("open", "high", "low", "close", "tie", "nz")}
    market = (None if market_uniforms is None
              else (market_normals(market_uniforms, antithetic), f32(beta)))
    for _, _, z, (u3, u4, tie), nz in _steps(u, layout, antithetic, market):
        log_close, c, high, low = gated_bar(log_s, z, u3, u4, drift, sig_dt)
        cols["open"].append(torch.exp(log_s))
        for k, v in (("high", high), ("low", low), ("close", c), ("tie", tie)):
            cols[k].append(v)
        if nz is not None:
            cols["nz"].append(torch.stack(nz))
        log_s = log_close

    def flat(rows):
        return torch.stack(rows, dim=-1).reshape(nb * sub * lanes, -1)

    bars = PathBars(open=flat(cols["open"]), high=flat(cols["high"]),
                    low=flat(cols["low"]), close=flat(cols["close"]),
                    volume=torch.zeros_like(flat(cols["close"])))
    nzs = (torch.stack(cols["nz"], dim=-1).reshape(4, nb * sub * lanes, -1)
           if layout.noise else None)
    return bars, flat(cols["tie"]), nzs


def market_normals(um: torch.Tensor, antithetic: bool) -> list:
    """Per double-bar step, the (cos, sin) market normals [nb, 8, lanes] of a
    book's market uniforms um f32[nb, W, 8, lanes] (``ops/draws.MarketLayout``:
    rows 2·t2 and 2·t2 + 1); antithetic lane pairs mirror them as the
    idiosyncratic normals."""
    out = []
    for t2 in range(um.shape[1] // 2):
        z_pair = box_muller(um[:, 2 * t2], um[:, 2 * t2 + 1])
        out.append(_mirror(z_pair, um.shape[-1]) if antithetic else z_pair)
    return out


def _mirror(z_pair, lanes: int):
    """Antithetic lane pairs: the right half-lanes take the left half's
    normals negated."""
    h = lanes // 2
    return tuple(torch.cat([z[..., :h], -z[..., :h]], dim=-1) for z in z_pair)


def _steps(u, layout: GatedLayout, antithetic: bool, market=None):
    """Per bar, in order: (t2, half, z, (u3, u4, tie), noise normals or
    None), each [nb, 8, lanes], as ``_gated_lifecycle_loop`` draws them.  A
    book symbol's ``market`` = (``market_normals``, beta) mixes the market's
    normals into z (``sim/book.mix_shocks``)."""
    for t2 in range(layout.num_bars // 2):
        def draw(k):
            return u[:, layout.row(t2, k)]

        z_pair = box_muller(draw(0), draw(1))
        if antithetic:
            z_pair = _mirror(z_pair, u.shape[-1])
        if market is not None:
            zm, beta = market[0][t2], market[1]
            z_pair = tuple(mix_shocks(beta, zm[h], z_pair[h]) for h in range(2))
        for half in range(2):
            nz = None
            if layout.noise:
                k = 8 + 4 * half
                nz = (box_muller(draw(k), draw(k + 1))
                      + box_muller(draw(k + 2), draw(k + 3)))
            yield (t2, half, z_pair[half],
                   tuple(draw(2 + 3 * half + i) for i in range(3)), nz)


def lifecycle_rows(out) -> torch.Tensor:
    """f32[P, 6] per-path rows of a lifecycle outcome: equity, trades, wins,
    losses, open, dd."""
    return torch.stack([out.equity, out.trades.float(), out.wins.float(),
                        out.losses.float(), out.open_at_end.float(), out.max_dd], dim=1)


def _chunk_gated(u, layout: GatedLayout, levels, params, gate, noise, consts,
                 antithetic, per_path: bool, market=None, book=None, weight=None):
    """Totals (and per-path rows) of one chunk of blocks, u f32[nb, u_rows,
    8, lanes]: the TPU kernel's block computation with the lifecycle of
    ``sim.gatedpath``, binned as ``_gated_accumulate`` bins.  A book symbol
    (``market`` as in ``_steps``) adds its post-bar equity, times
    ``weight``, into the ``book`` (``sim/book.BookCurve``) after every bar."""
    nb, _, sub, lanes = u.shape
    dev = u.device
    drift, sig_dt, log_s0 = consts
    log_s = torch.full((nb, sub, lanes), log_s0, dtype=torch.float32, device=dev)
    life = Lifecycle(torch.exp(log_s).reshape(-1), levels, params, gate,
                     noise=noise)
    held = torch.zeros((), dtype=torch.int64, device=dev)
    for t2, half, z, (u3, u4, tie), nz in _steps(u, layout, antithetic, market):
        held = held + (life.side != 0).sum()   # bars that evaluate high/low
        log_s, c, high, low = gated_bar(log_s, z, u3, u4, drift, sig_dt)
        life.step(2 * t2 + half, high.reshape(-1), low.reshape(-1),
                  c.reshape(-1), tie.reshape(-1),
                  None if nz is None else tuple(x.reshape(-1) for x in nz))
        if book is not None:
            book.add_bar(2 * t2 + half, weight, life.equity)
    out = life.outcome()
    if book is not None:
        book.add_symbol(out)
    counts, floats = lifecycle_totals(out, N_COUNTS)
    return counts, floats, held, lifecycle_rows(out) if per_path else None


def lifecycle_totals(out, n_counts: int):
    """int64 [n, entered, wins, losses, open, trades, 0 ..., hist...] of
    length ``n_counts + HIST_BINS`` and float64 [sum_eq, sum_eq2, sum_dd,
    min_eq, max_eq, max_dd] of a lifecycle outcome (per-path equity, trades,
    wins, losses, open_at_end, max_dd), binned as the TPU kernels bin."""
    eq, dd = out.equity, out.max_dd
    dev = eq.device
    entered = out.trades > 0
    counts = torch.zeros(n_counts + HIST_BINS, dtype=torch.int64, device=dev)
    counts[0] = eq.numel()
    counts[1] = entered.sum()
    counts[2] = out.wins.sum()
    counts[3] = out.losses.sum()
    counts[4] = out.open_at_end.sum()
    counts[5] = out.trades.sum()
    bins = torch.clamp(((eq - LIFE_HIST_LO) * LIFE_BIN_SCALE).to(torch.int32),
                       0, HIST_BINS - 1)
    counts[n_counts:] = torch.bincount(bins[entered].to(torch.int64),
                                       minlength=HIST_BINS)
    ee = eq[entered]
    has = ee.numel() > 0
    f64 = dict(dtype=torch.float64, device=dev)
    floats = torch.stack([
        eq.double().sum(), (eq * eq).double().sum(), dd.double().sum(),
        ee.min().double() if has else torch.tensor(_BIG, **f64),
        ee.max().double() if has else torch.tensor(-_BIG, **f64),
        torch.clamp(dd.max().double(), min=0.0),
    ])
    return counts, floats


def merge_totals(a, b):
    """Two chunks' (counts, floats) totals -> one."""
    if a is None:
        return b
    (ca, fa), (cb, fb) = a, b
    return ca + cb, torch.stack([
        fa[0] + fb[0], fa[1] + fb[1], fa[2] + fb[2],
        torch.minimum(fa[3], fb[3]), torch.maximum(fa[4], fb[4]),
        torch.maximum(fa[5], fb[5])])


def stats_from_gated_totals(counts: torch.Tensor, floats: torch.Tensor) -> PathStats:
    """int64 counts [..., n, entered, wins, losses, open, trades, hist...] and
    float64 [..., sum_eq, sum_eq2, sum_dd, min_eq, max_eq, max_dd] -> the
    float32 lifecycle PathStats (``_unpack_acc_gated``), with a leading [G]
    axis for a sweep's totals."""
    c = counts.to(torch.float32)
    f = floats.to(torch.float32)
    has = c[..., 1] > 0
    inf = float("inf")
    return PathStats(
        n=c[..., 0], n_entered=c[..., 1], n_tp=c[..., 2], n_stop=c[..., 3],
        n_open=c[..., 4], sum_r=f[..., 0], sum_r2=f[..., 1],
        min_r=torch.where(has, f[..., 3], inf), max_r=torch.where(has, f[..., 4], -inf),
        sum_trades=c[..., 5], sum_dd=f[..., 2], max_dd=f[..., 5],
        hist=c[..., N_COUNTS:], hist_lo=LIFE_HIST_LO, hist_hi=LIFE_HIST_HI)


def gated_totals_reference(seed, levels: Levels, params, gate=None, *,
                           num_paths: int, num_bars: int = 40,
                           s0: float = 100.0, mu: float = 0.0,
                           sigma: float = 0.15,
                           dt: float = 1.0 / (390.0 * 252.0),
                           lanes: int = GATED_LANES, noise=None,
                           antithetic: bool = False, external_uniforms=None,
                           device=None, chunk_blocks: int = 16,
                           per_path: bool = False, work: bool = False, symbol: int = 0):
    """The plain version's (int64 counts, float64 floats) totals, computed
    on ``device`` (default: that of ``external_uniforms``, else the CUDA
    device) in chunks of ``chunk_blocks`` blocks, Philox draws keyed as
    universe symbol ``symbol``; then the f32[P, 6] per-path
    rows (equity, trades, wins, losses, open, dd) when ``per_path``; then,
    when ``work``, the bars on which a path held a position (where the kernel
    evaluates the bridge high/low), for bounding the kernel's time."""
    layout = _check(seed, levels, num_paths=num_paths, num_bars=num_bars,
                    lanes=lanes, noise=noise, antithetic=antithetic,
                    external_uniforms=external_uniforms)
    device = devices.resolve(device, external_uniforms)
    gate = GateConfig.from_params(params) if gate is None else gate
    cs = consts(s0, mu, sigma, dt)
    n_blocks = num_paths // (GATED_SUB * lanes)
    tot, rows, held = None, [], 0
    for b0 in range(0, n_blocks, chunk_blocks):
        nb = min(chunk_blocks, n_blocks - b0)
        if external_uniforms is not None:
            u = external_uniforms[b0:b0 + nb]
        else:
            u = gated_uniforms(seed, layout, block0=b0, n_blocks=nb,
                               lanes=lanes, symbol=symbol, device=device)
        counts, floats, part_held, part_rows = _chunk_gated(
            u, layout, levels, params, gate, noise, cs, antithetic, per_path)
        tot = merge_totals(tot, (counts, floats))
        held = held + part_held
        if per_path:
            rows.append(part_rows)
    out = tot
    if per_path:
        out += (torch.cat(rows),)
    if work:
        out += (held,)
    return out


def gated_sweep_totals_reference(seed, levels: Levels, params, grid_stops, grid_tps,
                                 grid_gate=None, *, num_paths: int, num_bars: int = 40,
                                 s0: float = 100.0, mu: float = 0.0,
                                 sigma: float = 0.15, dt: float = 1.0 / (390.0 * 252.0),
                                 lanes: int = GATED_LANES, noise=None,
                                 external_uniforms=None, device=None,
                                 chunk_blocks: int = 16, per_path: bool = False,
                                 work: bool = False):
    """The plain version of the sweep: int64 [G, 134] counts and float64
    [G, 6] floats; then f32[G, P, 6] per-(row, path) rows when ``per_path``;
    then int64 [G] held bars when ``work``.  Each chunk's uniforms are drawn
    once and every row runs the whole lifecycle on them (the TPU kernel's
    reseeding); ``grid_gate`` (default ``GateConfig.from_params(params)``)
    and ``noise`` may carry [G] leaves."""
    rows = grid_rows(params, grid_stops, grid_tps,
                     GateConfig.from_params(params) if grid_gate is None else grid_gate, noise)
    layout = _check(seed, levels, num_paths=num_paths, num_bars=num_bars, lanes=lanes,
                    noise=noise, antithetic=False, external_uniforms=external_uniforms)
    device = devices.resolve(device, external_uniforms)
    cs = consts(s0, mu, sigma, dt)
    n_blocks = num_paths // (GATED_SUB * lanes)
    tot = [None] * len(rows)
    held = [0] * len(rows)
    path_rows = [[] for _ in rows]
    for b0 in range(0, n_blocks, chunk_blocks):
        nb = min(chunk_blocks, n_blocks - b0)
        if external_uniforms is not None:
            u = external_uniforms[b0:b0 + nb]
        else:
            u = gated_uniforms(seed, layout, block0=b0, n_blocks=nb, lanes=lanes,
                               device=device)
        for g, (p_g, gate_g, noise_g) in enumerate(rows):
            counts, floats, part_held, part_rows = _chunk_gated(
                u, layout, levels, p_g, gate_g, noise_g, cs, False, per_path)
            tot[g] = merge_totals(tot[g], (counts, floats))
            held[g] = held[g] + part_held
            if per_path:
                path_rows[g].append(part_rows)
    out = (torch.stack([t[0] for t in tot]), torch.stack([t[1] for t in tot]))
    if per_path:
        out += (torch.stack([torch.cat(r) for r in path_rows]),)
    if work:
        out += (torch.stack(held),)
    return out


def _check_universe(seed, levels: Levels, params, s0, sigma, gate, noise, *,
                    paths_per_symbol: int, num_bars: int, lanes: int,
                    external_uniforms) -> tuple[GatedLayout, GateConfig]:
    """The checks of ``_mc_paths_pallas_gated_universe_jit``
    (pallas_mc.py:1745-1760) and the single kernel's; returns the layout and
    the shared gate."""
    cols = symbol_columns(levels, s0, sigma, params, noise)
    gate = GateConfig.from_params(params) if gate is None else gate
    if grid_len(gate) != 1:
        raise ValueError("the gate knobs are shared by every symbol: scalar leaves")
    layout = _check(seed, grid_row(levels, 0), num_paths=paths_per_symbol,
                    num_bars=num_bars, lanes=lanes, noise=noise, antithetic=False,
                    external_uniforms=None)
    check_uniforms(external_uniforms, (len(cols["s0"]), paths_per_symbol // (GATED_SUB * lanes),
                                       layout.u_rows, GATED_SUB, lanes),
                   antithetic=False, lanes=lanes)
    return layout, gate


def gated_universe_totals_reference(seed, levels: Levels, params, s0, sigma, gate=None, *,
                                    paths_per_symbol: int, num_bars: int = 40,
                                    dt: float = 1.0 / (390.0 * 252.0),
                                    lanes: int = GATED_LANES, noise=None,
                                    external_uniforms=None, device=None,
                                    chunk_blocks: int = 16, per_path: bool = False,
                                    work: bool = False):
    """The plain version of the gated universe: int64 [S, 134] counts and
    float64 [S, 6] floats, then f32[S, P, 6] per-(symbol, path) rows with
    ``per_path``, then int64 [S] held bars with ``work``; symbol s by
    ``gated_totals_reference`` at its levels, s0, sigma, knobs and noise stds
    (``params`` and ``noise`` leaves scalar or [S]), the shared ``gate``, mu
    0, its uniforms ``external_uniforms[s]`` or its key."""
    _, gate = _check_universe(seed, levels, params, s0, sigma, gate, noise,
                              paths_per_symbol=paths_per_symbol, num_bars=num_bars,
                              lanes=lanes, external_uniforms=external_uniforms)
    rows = symbol_rows(levels, s0, sigma, params, noise)
    device = devices.resolve(device, external_uniforms)
    out = [gated_totals_reference(
        seed, lv, p, gate, num_paths=paths_per_symbol, num_bars=num_bars, s0=s0_s, mu=0.0,
        sigma=sg_s, dt=dt, lanes=lanes, noise=nz, symbol=s, device=device,
        chunk_blocks=chunk_blocks, per_path=per_path, work=work,
        external_uniforms=symbol_uniforms(external_uniforms, s))
        for s, (lv, s0_s, sg_s, p, nz) in enumerate(rows)]
    return tuple(torch.stack(x) for x in zip(*out))


# --------------------------------------------------------------------------
# the correlated book (kernel #7)
# --------------------------------------------------------------------------

def _check_corr(seed, levels: Levels, params, s0, sigma, beta, weights, gate, noise, *,
                paths_per_symbol: int, num_bars: int, lanes: int, antithetic: bool,
                external_uniforms, market_uniforms, sampler: str):
    """The checks of ``_mc_paths_pallas_gated_corr_jit`` (pallas_mc.py:
    2600-2625) and the kernel's envelope; returns (layout, market layout,
    the shared gate, ``symbol_columns``)."""
    if sampler != "gbm":
        raise NotImplementedError(f"sampler {sampler!r} is not ported yet for the book "
                                  "kernel (the samplers slice); the port runs gbm")
    cols = symbol_columns(levels, s0, sigma, params, noise, beta=beta, weights=weights)
    gate = GateConfig.from_params(params) if gate is None else gate
    if grid_len(gate) != 1:
        raise ValueError("the gate knobs are shared by every symbol: scalar leaves")
    layout = _check(seed, grid_row(levels, 0), num_paths=paths_per_symbol,
                    num_bars=num_bars, lanes=lanes, noise=noise, antithetic=antithetic,
                    external_uniforms=None)
    if (external_uniforms is None) != (market_uniforms is None):
        raise ValueError("external_uniforms and market_uniforms go together")
    n_sym, n_blocks = len(cols["s0"]), paths_per_symbol // (GATED_SUB * lanes)
    mlayout = MarketLayout(num_bars)
    check_uniforms(external_uniforms, (n_sym, n_blocks, layout.u_rows, GATED_SUB, lanes),
                   antithetic=antithetic, lanes=lanes)
    check_uniforms(market_uniforms, (n_blocks, mlayout.u_rows, GATED_SUB, lanes),
                   antithetic=antithetic, lanes=lanes)
    return layout, mlayout, gate, cols


def gated_corr_totals_reference(seed, levels: Levels, params, s0, sigma, beta, weights,
                                gate=None, *, paths_per_symbol: int, num_bars: int = 40,
                                dt: float = 1.0 / (390.0 * 252.0), lanes: int = GATED_LANES,
                                noise=None, antithetic: bool = False, external_uniforms=None,
                                market_uniforms=None, sampler: str = "gbm", device=None,
                                chunk_blocks: int = 16, per_path: bool = False,
                                work: bool = False):
    """The plain version of the gated book: int64 [S + 1, 134] counts and
    float64 [S + 1, 6] floats (row s symbol s's, row S the book's); then
    f32[S + 1, P, 6] per-path rows with ``per_path``; then int64 [S] held bars
    with ``work``.  Symbol s runs as ``gated_universe_totals_reference``'s
    symbol s, its normal mixed with the market's (``sim/book.mix_shocks``,
    market uniforms ``market_uniforms`` f32[blocks, W, 8, lanes] or Philox on
    the market key), and adds its weighted post-bar equity into the book's
    curve; the book folds as ``sim/book.BookCurve`` folds."""
    layout, mlayout, gate, _ = _check_corr(
        seed, levels, params, s0, sigma, beta, weights, gate, noise,
        paths_per_symbol=paths_per_symbol, num_bars=num_bars, lanes=lanes,
        antithetic=antithetic, external_uniforms=external_uniforms,
        market_uniforms=market_uniforms, sampler=sampler)
    rows = symbol_rows(levels, s0, sigma, params, noise, beta=beta, weights=weights)
    device = devices.resolve(device, external_uniforms)
    n_blocks = paths_per_symbol // (GATED_SUB * lanes)
    n_sym = len(rows)
    tot, held, path_rows = [None] * (n_sym + 1), [0] * n_sym, [[] for _ in range(n_sym + 1)]
    for b0 in range(0, n_blocks, chunk_blocks):
        nb = min(chunk_blocks, n_blocks - b0)
        um = (market_uniforms[b0:b0 + nb] if market_uniforms is not None else
              draws_market(seed, mlayout, block0=b0, n_blocks=nb, lanes=lanes, device=device))
        zm = market_normals(um, antithetic)
        book = BookCurve(nb * GATED_SUB * lanes, num_bars, device=device)
        for s, (lv, s0_s, sg_s, p, nz, beta_s, w_s) in enumerate(rows):
            if external_uniforms is not None:
                u = external_uniforms[s, b0:b0 + nb]
            else:
                u = gated_uniforms(seed, layout, block0=b0, n_blocks=nb, lanes=lanes,
                                   symbol=s, device=device)
            counts, floats, part_held, part_rows = _chunk_gated(
                u, layout, lv, p, gate, nz, consts(s0_s, 0.0, sg_s, dt), antithetic,
                per_path, market=(zm, beta_s), book=book, weight=w_s)
            tot[s] = merge_totals(tot[s], (counts, floats))
            held[s] = held[s] + part_held
            if per_path:
                path_rows[s].append(part_rows)
        out = book.outcome()
        tot[n_sym] = merge_totals(tot[n_sym], lifecycle_totals(out, N_COUNTS))
        if per_path:
            path_rows[n_sym].append(lifecycle_rows(out))
    res = (torch.stack([t[0] for t in tot]), torch.stack([t[1] for t in tot]))
    if per_path:
        res += (torch.stack([torch.cat(r) for r in path_rows]),)
    if work:
        res += (torch.stack([torch.as_tensor(h) for h in held]),)
    return res


def reduce_rows_reference(part_counts: torch.Tensor, part_floats: torch.Tensor):
    """Plain version of the pass-2 kernel: partial rows [..., R, C] ->
    totals [..., C] (one segment, or one per grid row of a sweep)."""
    f = part_floats.double()
    return part_counts.sum(dim=-2), torch.stack(
        [f[..., 0].sum(-1), f[..., 1].sum(-1), f[..., 2].sum(-1), f[..., 3].amin(-1),
         f[..., 4].amax(-1), f[..., 5].amax(-1)], dim=-1)


# --------------------------------------------------------------------------
# the kernel wrappers
# --------------------------------------------------------------------------

_BOUND: set[int] = set()


def _library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures set."""
    lib = build.load(_SOURCE)
    if id(lib) not in _BOUND:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.qmmx_gated_args_size.argtypes = []
        lib.qmmx_gated_args_size.restype = ci
        lib.qmmx_gated_error_string.argtypes = [ci]
        lib.qmmx_gated_error_string.restype = ctypes.c_char_p
        lib.qmmx_mc_gated_sweep.argtypes = [vp, ci, ci, vp, vp, vp, vp, ci, vp]
        lib.qmmx_mc_gated_sweep.restype = ci
        lib.qmmx_mc_gated_reduce_rows.argtypes = [vp, vp, ci, ci, vp, vp, vp]
        lib.qmmx_mc_gated_reduce_rows.restype = ci
        if lib.qmmx_gated_args_size() != ctypes.sizeof(_GatedArgs):
            raise RuntimeError("GatedArgs layout differs between "
                               "mc_gated.cu and cuda_gated._GatedArgs")
        _BOUND.add(id(lib))
    return lib


def _corr_library() -> ctypes.CDLL:
    """The book kernel's library (``ops/csrc/mc_gated_corr.cu``, its own
    build of ``mc_gated.cuh``), built at first use, with its C signature set;
    the gated library's struct-layout check first."""
    _library()
    lib = build.load(_SOURCE + "_corr")
    if id(lib) not in _BOUND:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.qmmx_mc_gated_corr.argtypes = [vp, vp, ci, ci, ci, vp, vp, ctypes.c_uint, vp, vp,
                                           vp, vp, ci, vp]
        lib.qmmx_mc_gated_corr.restype = ci
        _BOUND.add(id(lib))
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().qmmx_gated_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _gated_args(seed, levels: Levels, params, gate, noise, layout: GatedLayout, *, n: int,
                num_paths: int, s0, sigma, mu: float, dt: float, lanes: int,
                antithetic: bool, symbols, ext_offset=0) -> np.ndarray:
    """The kernel's arguments for ``n`` rows (one configuration, a sweep's
    grid rows, a universe's or a book's symbols) as one array of
    ``GatedArgs``, packed column by column: ``levels`` [L] (every row's) or
    [n, L]; the leaves of ``params``, ``gate`` and ``noise`` (None: zero
    stds), s0 and sigma (float64, for ``consts``) and ``ext_offset`` scalars
    or [n]; row r keyed as universe symbol ``symbols[r]``."""
    a = np.zeros(n, dtype=np.dtype(_GatedArgs))

    def col(x, dtype=np.float32):
        return np.broadcast_to(np.asarray(torch.as_tensor(x).detach().cpu().numpy(), dtype), (n,))

    price = levels.price.detach().cpu().to(torch.float32)
    n_lv = price.shape[-1]
    a["level_price"][:, :n_lv] = torch.where(torch.isfinite(price), price, 0.0).numpy()
    a["level_valid"][:, :n_lv] = levels.valid.detach().cpu().to(torch.float32).numpy()
    a["level_kind"][:, :n_lv] = (levels.kind.detach().cpu() == KIND_SOLID).numpy()
    a["num_paths"], a["ext_offset"] = num_paths, ext_offset
    for field, value in knob_columns(params, noise).items():
        a[field] = col(value)
    s0, sigma = (np.broadcast_to(np.asarray(x, np.float64), (n,)).tolist() for x in (s0, sigma))
    derived = [consts(s0_r, mu, sg_r, dt) for s0_r, sg_r in zip(s0, sigma)]
    a["drift"], a["sig_dt"], a["log_s0"] = (np.asarray(c, np.float32) for c in zip(*derived))
    a["qmin"] = col(gate.q_min_prob)
    a["seed"] = int(seed)
    a["stream"] = [prng.stream_key(GATED_STREAM, sym) for sym in symbols]
    a["touch_limit"] = col(gate.touch_limit, np.int32)
    a["cooldown_bars"] = col(gate.cooldown_bars, np.int32)
    a["touch_gap"] = col(gate.touch_gap_bars, np.int32)
    a["use_conf"] = col(gate.use_confidence, bool)
    a["max_levels"], a["num_bars"], a["lanes"], a["u_rows"] = (
        levels.max_levels, layout.num_bars, lanes, layout.u_rows)
    a["use_noise"], a["antithetic"] = int(noise is not None), int(bool(antithetic))
    return a


def _launch(args, max_levels: int, *, num_paths: int, ext_ptr, device: torch.device,
            per_path: bool, what: str):
    """One launch of ``mc_gated_sweep_kernel`` over the argument structs
    ``args`` (one per grid row), counted in ``LAUNCHES[what]``: int64 [G,
    grid, 134] and f32 [G, grid, 6] partial rows, one per (grid row, CTA),
    plus f32[G, P, 6] per-(row, path) rows when ``per_path``."""
    args_dev = device_rows(args, device)
    g, grid = len(args), grid_size(num_paths)
    part_counts = torch.empty((g, grid, ROW_COUNTS), dtype=torch.int64, device=device)
    part_floats = torch.empty((g, grid, ROW_FLOATS), dtype=torch.float32, device=device)
    path_rows = (torch.empty((g, num_paths, PATH_COLS), dtype=torch.float32, device=device)
                 if per_path else None)
    rc = _library().qmmx_mc_gated_sweep(
        args_dev.data_ptr(), g, max_levels, ext_ptr, part_counts.data_ptr(),
        part_floats.data_ptr(), path_rows.data_ptr() if per_path else None, grid,
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, what)
    LAUNCHES[what] += 1
    out = (part_counts, part_floats)
    return out + (path_rows,) if per_path else out


def gated_rows(seed, levels: Levels, params, gate=None, *, num_paths: int,
               num_bars: int, s0: float, mu: float, sigma: float, dt: float,
               lanes: int, noise, antithetic: bool, external_uniforms,
               device: torch.device, per_path: bool = False, symbol: int = 0):
    """Launch pass 1 on a CUDA device (the kernel at one grid row): int64
    [grid, 134] count rows and f32 [grid, 6] float rows, one row per CTA,
    plus the f32[P, 6] per-path rows when ``per_path``; Philox keyed as
    universe symbol ``symbol``."""
    layout = _check(seed, levels, num_paths=num_paths, num_bars=num_bars,
                    lanes=lanes, noise=noise, antithetic=antithetic,
                    external_uniforms=external_uniforms)
    device = torch.device(device)
    ext_ptr = launch_pointer(num_paths, num_bars, external_uniforms, device, "gated_rows")
    gate = GateConfig.from_params(params) if gate is None else gate
    args = _gated_args(seed, levels, params, gate, noise, layout, n=1, num_paths=num_paths,
                       s0=s0, sigma=sigma, mu=mu, dt=dt, lanes=lanes, antithetic=antithetic,
                       symbols=[symbol])
    out = _launch(args, levels.max_levels, num_paths=num_paths, ext_ptr=ext_ptr,
                  device=device, per_path=per_path, what="mc_gated")
    return tuple(x[0] for x in out)


def gated_sweep_rows(seed, levels: Levels, params, grid_stops, grid_tps, grid_gate=None,
                     *, num_paths: int, num_bars: int, s0: float, mu: float,
                     sigma: float, dt: float, lanes: int, noise, external_uniforms,
                     device: torch.device, per_path: bool = False):
    """Launch the sweep's pass 1 on a CUDA device, one launch for the whole
    grid: int64 [G, grid, 134] and f32 [G, grid, 6] partial rows, one per
    (grid row, CTA), plus f32[G, P, 6] per-(row, path) rows when
    ``per_path``."""
    gate = GateConfig.from_params(params) if grid_gate is None else grid_gate
    n_grid, grid_params = grid_columns(params, grid_stops, grid_tps, gate, noise)
    layout = _check(seed, levels, num_paths=num_paths, num_bars=num_bars, lanes=lanes,
                    noise=noise, antithetic=False, external_uniforms=external_uniforms)
    device = torch.device(device)
    ext_ptr = launch_pointer(num_paths, num_bars, external_uniforms, device,
                             "gated_sweep_rows")
    args = _gated_args(seed, levels, grid_params, gate, noise, layout, n=n_grid,
                       num_paths=num_paths, s0=s0, sigma=sigma, mu=mu, dt=dt, lanes=lanes,
                       antithetic=False, symbols=[0] * n_grid)
    return _launch(args, levels.max_levels, num_paths=num_paths, ext_ptr=ext_ptr,
                   device=device, per_path=per_path, what="mc_gated_sweep")


def gated_universe_rows(seed, levels: Levels, params, s0, sigma, gate=None, *,
                        paths_per_symbol: int, num_bars: int, dt: float, lanes: int,
                        noise, external_uniforms, device: torch.device,
                        per_path: bool = False):
    """Launch the universe's pass 1 on a CUDA device, one launch of
    ``mc_gated_sweep_kernel`` with a row per symbol: int64 [S, grid, 134] and
    f32 [S, grid, 6] partial rows, plus f32[S, P, 6] per-(symbol, path) rows
    when ``per_path``."""
    layout, gate = _check_universe(
        seed, levels, params, s0, sigma, gate, noise, paths_per_symbol=paths_per_symbol,
        num_bars=num_bars, lanes=lanes, external_uniforms=external_uniforms)
    device = torch.device(device)
    ext_ptr = launch_pointer(paths_per_symbol, num_bars, external_uniforms, device,
                             "gated_universe_rows")
    args = _symbols_args(seed, levels, params, gate, noise, layout,
                         symbol_columns(levels, s0, sigma, params, noise),
                         paths_per_symbol=paths_per_symbol, dt=dt, lanes=lanes,
                         antithetic=False)
    return _launch(args, levels.max_levels, num_paths=paths_per_symbol, ext_ptr=ext_ptr,
                   device=device, per_path=per_path, what="mc_gated_universe")


def _symbols_args(seed, levels: Levels, params, gate, noise, layout: GatedLayout,
                  cols: dict, *, paths_per_symbol: int, dt: float, lanes: int,
                  antithetic: bool) -> np.ndarray:
    """A universe's or a book's ``GatedArgs``, a row a symbol (``cols`` from
    ``symbol_columns``): symbol s on its key and its injected uniforms, mu 0."""
    n_sym = len(cols["s0"])
    return _gated_args(seed, levels, params, gate, noise, layout, n=n_sym,
                       num_paths=paths_per_symbol, s0=cols["s0"], sigma=cols["sigma"], mu=0.0,
                       dt=dt, lanes=lanes, antithetic=antithetic, symbols=range(n_sym),
                       ext_offset=np.arange(n_sym) * paths_per_symbol * layout.u_rows)


def gated_corr_rows(seed, levels: Levels, params, s0, sigma, beta, weights, gate=None, *,
                    paths_per_symbol: int, num_bars: int = 40,
                    dt: float = 1.0 / (390.0 * 252.0), lanes: int = GATED_LANES, noise=None,
                    antithetic: bool = False, external_uniforms=None, market_uniforms=None,
                    device=None, sampler: str = "gbm", per_path: bool = False):
    """Launch the book's pass 1 on a CUDA device, one launch of
    ``mc_gated_corr_kernel``: int64 [S + 1, grid, 134] and f32 [S + 1, grid,
    6] partial rows (the symbols', then the book's), plus f32[S + 1, P, 6]
    per-path rows when ``per_path``.  The book curves lie in shared memory,
    or in a device-memory buffer when num_bars x 1 KB passes
    ``MAX_CURVE_SHARED_BYTES``."""
    layout, _, gate, cols = _check_corr(
        seed, levels, params, s0, sigma, beta, weights, gate, noise,
        paths_per_symbol=paths_per_symbol, num_bars=num_bars, lanes=lanes,
        antithetic=antithetic, external_uniforms=external_uniforms,
        market_uniforms=market_uniforms, sampler=sampler)
    device = torch.device("cuda" if device is None else device)
    ext_ptr = launch_pointer(paths_per_symbol, num_bars, external_uniforms, device,
                             "gated_corr_rows")
    m_ptr = launch_pointer(paths_per_symbol, num_bars, market_uniforms, device,
                           "gated_corr_rows")
    args_dev = device_rows(_symbols_args(seed, levels, params, gate, noise, layout, cols,
                                         paths_per_symbol=paths_per_symbol, dt=dt,
                                         lanes=lanes, antithetic=antithetic), device)
    n_sym, grid = len(cols["s0"]), grid_size(paths_per_symbol)
    part_counts = torch.empty((n_sym + 1, grid, ROW_COUNTS), dtype=torch.int64, device=device)
    part_floats = torch.empty((n_sym + 1, grid, ROW_FLOATS), dtype=torch.float32,
                              device=device)
    path_rows = (torch.empty((n_sym + 1, paths_per_symbol, PATH_COLS), dtype=torch.float32,
                             device=device) if per_path else None)
    curve_mem = (torch.empty((num_bars, grid * BLOCK), dtype=torch.float32, device=device)
                 if num_bars * BLOCK * 4 > MAX_CURVE_SHARED_BYTES else None)
    bw = book_pairs(cols, device)
    rc = _corr_library().qmmx_mc_gated_corr(
        args_dev.data_ptr(), bw.data_ptr(), n_sym, levels.max_levels, num_bars, ext_ptr, m_ptr,
        prng.stream_key(MARKET_STREAM, 0), None if curve_mem is None else curve_mem.data_ptr(),
        part_counts.data_ptr(), part_floats.data_ptr(),
        path_rows.data_ptr() if per_path else None, grid,
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, "mc_gated_corr")
    LAUNCHES["mc_gated_corr"] += 1
    out = (part_counts, part_floats)
    return out + (path_rows,) if per_path else out


def reduce_rows(part_counts: torch.Tensor, part_floats: torch.Tensor, what=None):
    """Pass 2: partial rows [R, ...] -> (int64 [134] counts, float64 [6]
    floats), or a sweep's (or universe's) [G, R, ...] -> ([G, 134], [G, 6])
    in one launch, one CTA per grid row, counted under ``what`` when given.
    CUDA tensors go through the kernel, CPU tensors through the plain
    version."""
    if part_counts.device.type == "cpu" and part_floats.device.type == "cpu":
        return reduce_rows_reference(part_counts, part_floats)
    return fold_rows(_library().qmmx_mc_gated_reduce_rows, _raise_on, part_counts,
                     part_floats, (ROW_COUNTS, ROW_FLOATS), "mc_gated", LAUNCHES, what)


def mc_paths_gated_fused(seed, levels: Levels, params, gate=None, *,
                         num_paths: int, num_bars: int = 40, s0: float = 100.0,
                         mu: float = 0.0, sigma: float = 0.15,
                         dt: float = 1.0 / (390.0 * 252.0),
                         lanes: int = GATED_LANES, noise=None,
                         antithetic: bool = False, external_uniforms=None,
                         device=None, symbol: int = 0) -> PathStats:
    """Fused gated-lifecycle MC, the counterpart of ``mc_paths_pallas_gated``
    (gbm): the lifecycle PathStats contract of ``sim.gatedpath.mc_paths_gated``
    with the McNoise per-entry execution noise and antithetic lane pairs;
    ``gate`` defaults to ``GateConfig.from_params(params)``; ``symbol`` keys
    the draws as universe symbol ``symbol`` (0: the single run).

    ``device`` (default: that of ``external_uniforms``, else the CUDA device,
    which raises where there is none) picks the path: a CUDA device launches
    the kernel or raises; the CPU runs the plain version.  Draws agree with
    ``sim.gatedpath.mc_paths_gated`` statistically, not bitwise."""
    _check(seed, levels, num_paths=num_paths, num_bars=num_bars, lanes=lanes,
           noise=noise, antithetic=antithetic,
           external_uniforms=external_uniforms)
    device = devices.resolve(device, external_uniforms)
    kw = dict(num_paths=num_paths, num_bars=num_bars, s0=s0, mu=mu,
              sigma=sigma, dt=dt, lanes=lanes, noise=noise,
              antithetic=antithetic, external_uniforms=external_uniforms, symbol=symbol)
    if device.type == "cpu":
        return stats_from_gated_totals(*gated_totals_reference(
            seed, levels, params, gate, device=device, **kw))
    rows = gated_rows(seed, levels, params, gate, device=device, **kw)
    return stats_from_gated_totals(*reduce_rows(*rows))


def mc_paths_gated_sweep_fused(seed, levels: Levels, params, grid_stops, grid_tps,
                               grid_gate=None, *, noise=None, num_paths: int,
                               num_bars: int = 40, s0: float = 100.0, mu: float = 0.0,
                               sigma: float = 0.15, dt: float = 1.0 / (390.0 * 252.0),
                               lanes: int = GATED_LANES, external_uniforms=None,
                               device=None) -> PathStats:
    """Fused gate-knob grid sweep, the counterpart of
    ``mc_paths_pallas_gated_sweep`` (gbm): [G] lifecycle PathStats, row g
    under (grid_stops[g], grid_tps[g]), row g of ``grid_gate`` (a GateConfig
    with scalar or [G] leaves; default ``GateConfig.from_params(params)``)
    and of ``noise`` (McNoise, scalar or [G] stds), every row on the same
    uniforms (CRN).  Row g equals ``mc_paths_gated_fused`` under those knobs
    at the same seed, bit for bit.  ``device`` as in ``mc_paths_gated_fused``."""
    kw = dict(noise=noise, num_paths=num_paths, num_bars=num_bars, s0=s0, mu=mu,
              sigma=sigma, dt=dt, lanes=lanes, external_uniforms=external_uniforms)
    grid_rows(params, grid_stops, grid_tps, grid_gate, noise)
    _check(seed, levels, num_paths=num_paths, num_bars=num_bars, lanes=lanes,
           noise=noise, antithetic=False, external_uniforms=external_uniforms)
    device = devices.resolve(device, external_uniforms)
    if device.type == "cpu":
        return stats_from_gated_totals(*gated_sweep_totals_reference(
            seed, levels, params, grid_stops, grid_tps, grid_gate, device=device, **kw))
    rows = gated_sweep_rows(seed, levels, params, grid_stops, grid_tps, grid_gate,
                            device=device, **kw)
    return stats_from_gated_totals(*reduce_rows(*rows))


def mc_paths_gated_universe_fused(seed, levels: Levels, params, s0, sigma, gate=None, *,
                                  paths_per_symbol: int, num_bars: int = 40,
                                  dt: float = 1.0 / (390.0 * 252.0),
                                  lanes: int = GATED_LANES, noise=None,
                                  external_uniforms=None, device=None) -> PathStats:
    """Fused per-symbol gated universe, the counterpart of
    ``mc_paths_pallas_gated_universe`` (gbm): [S] lifecycle PathStats, symbol
    s under its own [S, L] levels row, s0[s], sigma[s], knobs (``params``
    leaves scalar or [S]), noise stds (``noise`` leaves scalar or [S]) and
    key, the gate knobs shared (``gate`` defaults to
    ``GateConfig.from_params(params)``); drift, sig_dt and log_s0 per symbol
    in float64 on the host, mu 0.  Row s equals ``mc_paths_gated_fused`` at
    those inputs with ``symbol=s`` bit for bit; injected uniforms are
    f32[S, blocks, u_rows, 8, lanes].  ``device`` as in
    ``mc_paths_gated_fused``."""
    kw = dict(paths_per_symbol=paths_per_symbol, num_bars=num_bars, lanes=lanes,
              noise=noise, external_uniforms=external_uniforms)
    _check_universe(seed, levels, params, s0, sigma, gate, **kw)
    device = devices.resolve(device, external_uniforms)
    if device.type == "cpu":
        return stats_from_gated_totals(*gated_universe_totals_reference(
            seed, levels, params, s0, sigma, gate, dt=dt, device=device, **kw))
    rows = gated_universe_rows(seed, levels, params, s0, sigma, gate, dt=dt, device=device,
                               **kw)
    return stats_from_gated_totals(*reduce_rows(*rows, what="mc_gated_universe_reduce_rows"))


def mc_paths_gated_corr_fused(seed, levels: Levels, params, s0, sigma, beta, weights,
                              gate=None, *, paths_per_symbol: int, num_bars: int = 40,
                              dt: float = 1.0 / (390.0 * 252.0), lanes: int = GATED_LANES,
                              noise=None, antithetic: bool = False, external_uniforms=None,
                              market_uniforms=None, sampler: str = "gbm",
                              device=None) -> tuple[PathStats, PathStats]:
    """Fused correlated gated book, the counterpart of
    ``mc_paths_pallas_gated_corr`` (gbm): ([S] lifecycle PathStats, the
    book's PathStats) from one launch.  Symbol s runs under its own [S, L]
    levels row, s0[s], sigma[s], knobs (``params`` leaves scalar or [S]),
    noise stds (``noise`` leaves scalar or [S]) and key, the gate knobs
    shared; its normal is ``beta[s] * z_mkt + sqrt(1 - beta[s]^2) * eps``
    with the market normal shared by every symbol; the book sums the
    symbols' post-bar equity curves times ``weights`` per path, its final R
    into the histogram and its drawdown tracked over time.  With beta = 0,
    symbol s equals ``mc_paths_gated_universe_fused``'s symbol s (on the
    card: per path and in its counts; in its float sums too up to 2^20 paths
    a symbol, one path a thread, past which a CTA adds its paths chunk by
    chunk).  Injected
    uniforms are f32[S, blocks, u_rows, 8, lanes] with the market's
    f32[blocks, W, 8, lanes].  ``device`` as in ``mc_paths_gated_fused``."""
    kw = dict(paths_per_symbol=paths_per_symbol, num_bars=num_bars, dt=dt, lanes=lanes,
              noise=noise, antithetic=antithetic, external_uniforms=external_uniforms,
              market_uniforms=market_uniforms, sampler=sampler)
    _check_corr(seed, levels, params, s0, sigma, beta, weights, gate, noise,
                **{k: v for k, v in kw.items() if k not in ("dt", "noise")})
    device = devices.resolve(device, external_uniforms)
    if device.type == "cpu":
        c, f = gated_corr_totals_reference(seed, levels, params, s0, sigma, beta, weights,
                                           gate, device=device, **kw)
    else:
        c, f = reduce_rows(*gated_corr_rows(seed, levels, params, s0, sigma, beta, weights,
                                            gate, device=device, **kw),
                           what="mc_gated_corr_reduce_rows")
    return stats_from_gated_totals(c[:-1], f[:-1]), stats_from_gated_totals(c[-1], f[-1])
