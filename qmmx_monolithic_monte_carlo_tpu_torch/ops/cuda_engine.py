"""Fused full engine: generate -> 12-gate engine lifecycle -> reduce, as one CUDA kernel.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py:1506-1806``
(kernel #8, ``_engine_kernel`` with ``_engine_lifecycle_loop`` and
``_engine_accumulate``, entry ``mc_paths_pallas_engine`` ``:1617-1712``), with
execution noise, antithetic lanes (gbm) and all four samplers, over the JAX
kernels' envelope: 1-64 level slots (``MAX_KERNEL_LEVELS``), any horizon W
>= 2 (an odd W ends with a half step; a book's W is even) and horizons past
the guard's 61-bar window (the windowed guard), in the single configuration,
the sweep, the universe, the sweep of universes and the correlated book.
Where the parent kernels fit (<= 8 level slots, an even W <= 61) the single
run, the universe and the sweep of universes go to the rows kernel
(``ops/csrc/mc_engine_rows.cu``: producer warpgroups make the bars, two
consumer warpgroups run the lifecycle; equal to the parents
``mc_engine_sweep_kernel`` and ``mc_engine_sampler_kernel`` bit for bit),
the books to the book rows kernel (``ops/csrc/mc_engine_book_rows.cu``, the
same design through every symbol of a chunk; equal to the parents
``mc_engine_corr_kernel`` and ``mc_engine_corr_sampler_kernel`` bit for
bit), counted under the parent's name with ``_rows`` (``mc_engine_rows``,
``mc_engine_rows_sampler``, ``mc_engine_rows_universe``, ...,
``mc_engine_rows_corr[_sampler]``; the parents stay built, as the checks'
A/B, ``_FORCE_PARENT``); elsewhere each launch goes to the
envelope kernel (``ops/csrc/mc_engine_wide*.cu``, ``needs_envelope``), counted
under the parent's name with ``_wide`` (``mc_engine_wide``,
``mc_engine_wide_sampler``, ...).  ``harvest=True`` (the single run, the
universe and the book) adds the closed-trade label harvest (``models/harvest.EngineHarvest``) and goes to the
envelope kernels' harvest builds at every shape
(``ops/csrc/mc_engine_wide*_harvest.cu``, counted under the envelope's name
with ``_harvest``: ``mc_engine_wide_harvest``, ``mc_engine_wide_universe_harvest``,
``mc_engine_wide_corr_harvest``, ...; the rows fold in
``mc_engine_harvest_reduce_rows``); the sweeps take no harvest, as in JAX.
The envelope kernels and their harvest builds, the books' included
(``ops/csrc/mc_engine_env.cuh``), keep a path's flags and contact counts in
shared memory sized by the launch's level count (``env_smem_bytes``);
``env_tail`` passes the device scratch of the touch registers and the
windowed guard's rings (``env_scratch_slots``) and the persistent grid's cell
counter.

* ``mc_paths_engine_fused`` -- the entry.  For a CUDA device it launches
  ``ops/csrc/mc_engine_rows.cu`` (pass 1: ``mc_engine_rows_kernel`` at one
  row, under gbm and the bootstrap, block-bootstrap and Heston samplers, one
  partial row per CTA; pass 2: ``ops/csrc/mc_engine.cu``'s fixed-order fold
  of the rows), or raises.  For the CPU it runs the plain version.
* ``engine_totals_reference`` -- the plain PyTorch version: the TPU kernel's
  double-bar streaming loop over (block, 8, lanes) tensors, driving
  ``sim.enginepath.EngineLifecycle.step``; optionally per path.
* ``mc_paths_engine_sweep_fused`` -- the engine-knob grid sweep under common
  random numbers, the counterpart of ``mc_paths_pallas_engine_sweep``
  (kernel #9, ``_engine_sweep_kernel``, ``pallas_engine.py:1813-2091``): the
  whole engine re-run for every row of EngineParams (and McNoise stds) with
  [G] leaves on the same uniforms; row g equals ``mc_paths_engine_fused``
  under row g's knobs, bit for bit.  A CUDA device launches
  ``mc_engine_bar_sweep_kernel`` (``ops/csrc/mc_engine_bar_sweep.cu``, under
  every sampler and at every shape: each path's bars made once into a bar
  store, every row replayed over them, ``bar_sweep_plan``) and one fold of
  all rows, or raises; the CPU runs ``engine_sweep_totals_reference``.
* ``mc_paths_engine_universe_fused`` -- the per-symbol engine universe, the
  counterpart of ``mc_paths_pallas_engine_universe`` (kernel #10,
  ``_engine_universe_kernel``, ``pallas_engine.py:2098-2279``, ``:2598-2689``):
  the sweep of universes below at one grid row, so S symbols in one launch of
  ``mc_engine_rows_kernel`` with one row per symbol (its levels, s0, sigma,
  all 17 knobs and noise stds, its key ``prng.stream_key``; the ML, policy,
  touch and guard records shared); row s equals ``mc_paths_engine_fused`` at
  symbol s's inputs and ``symbol=s``, bit for bit; with ``harvest=True``
  each symbol's harvest too.
* ``mc_paths_engine_universe_sweep_fused`` -- the sweep of universes (kernel
  #11, ``_engine_universe_sweep_kernel``, ``pallas_engine.py:2282-2588``): S x
  G rows in one launch, row (s, g) under row g of symbol s's knob grid
  (leaves scalar, [G] or [S, G]) on symbol s's key (common random numbers
  within a symbol); it equals the engine universe at symbol s under row g's
  knobs, bit for bit.  Under the bootstrap, block-bootstrap and Heston
  samplers the universe and the sweep of universes launch the same kernel's
  sampler kinds with the same rows, a universe's symbols each on their own
  recorded history.
* ``LAUNCHES`` -- how many times each kernel was launched.

Uniforms follow ``ops/draws.EngineLayout``: injected as ``external_uniforms``
f32[n_blocks, u_rows, 8, lanes] (the JAX shape), or drawn from Philox
(``ops/draws.engine_uniforms``; the kernel computes the same bits).  Counts,
the 16-reason skip table and escalations stay int64 until
``stats_from_engine_totals``.  (The TPU kernel sums them as float32, which
stops counting exactly past 2^24.)
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from ..models import harvest as HV
from ..ops.pathgen import PathBars, VolumeModel
from ..sim.book import BookCurve, mix_shocks
from ..sim.enginepath import (SKIP_REASONS, EngineLifecycle, blend_weights, engine_knobs,
                              skip_columns)
from ..sim.pathsim import HIST_BINS
from ..types import KIND_SOLID, Levels
from ..utils import build, prng
from ..utils import device as devices
from ..utils.floats import div
from .cuda_gated import (book_market, box_muller, gated_bar, lifecycle_rows,
                         lifecycle_totals, merge_totals, reduce_rows_reference,
                         stats_from_gated_totals)
from .draws import (ENGINE_STREAM, ENGINE_SUB, MARKET_STREAM, EngineLayout, MarketLayout,
                    engine_uniforms)
from .draws import market_uniforms as draws_market
from .kernel_args import (BLOCK, MAX_ENGINE_LEVELS, MAX_LEVELS, SamplerArgs, book_pairs,
                          check_blocks, check_uniforms, consts, device_rows, f32, fold_rows,
                          grid_row, grid_size, knob_columns, knob_rows, launch_pointer,
                          repeat_rows, sampler_args, sg_columns, sg_rows, symbol_columns,
                          symbol_grid, symbol_rows, symbol_uniforms, tensor_leaves)
from .regular import GUARD_WINDOW_BARS
from .samplers import Sampler, StreamBars, make_sampler, sampler_steps

ENGINE_LANES = 256       # logical lanes per block row (one block = 8 x lanes paths)
TAP_SLOTS = 3            # the kernel's edge-tap stack depth == fatigue_hits
N_COUNTS = 7             # n, entered, wins, losses, open, trades, escalations
N_SKIPS = len(SKIP_REASONS)
ROW_COUNTS = N_COUNTS + N_SKIPS + HIST_BINS
ROW_FLOATS = 6           # sum_eq, sum_eq2, sum_dd, min_eq, max_eq, max_dd
PATH_COLS = 7 + N_SKIPS  # per-path output: equity, trades, wins, losses, open, dd,
                         # escalations, the 16 skip counts
_SOURCE = "mc_engine"
_F32 = torch.float32
MAX_BARS = (2 ** 31 - 1) // 60_000   # bar timestamps are int32 milliseconds

# Kernel launches, counted by the wrappers where they launch and nowhere else.
LAUNCHES = {"mc_engine": 0, "mc_engine_reduce_rows": 0, "mc_engine_sampler": 0,
            "mc_engine_sweep_reduce_rows": 0, "mc_engine_universe": 0,
            "mc_engine_universe_reduce_rows": 0, "mc_engine_universe_sweep": 0,
            "mc_engine_universe_sweep_reduce_rows": 0, "mc_engine_corr": 0,
            "mc_engine_corr_reduce_rows": 0,
            "mc_engine_universe_sampler": 0, "mc_engine_universe_sweep_sampler": 0,
            "mc_engine_corr_sampler": 0}
# the envelope kernels' launches: each parent launch counter with "_wide"
LAUNCHES.update({"mc_engine_wide" + k[len("mc_engine"):]: 0 for k in list(LAUNCHES)
                 if not k.endswith("reduce_rows")})
# the harvest builds' launches (the single run, the universe, the book) and
# their rows' fold
LAUNCHES.update({k + "_harvest": 0 for k in (
    "mc_engine_wide", "mc_engine_wide_sampler", "mc_engine_wide_universe",
    "mc_engine_wide_universe_sampler", "mc_engine_wide_corr",
    "mc_engine_wide_corr_sampler")})
LAUNCHES["mc_engine_harvest_reduce_rows"] = 0
# the engine sweep (every launch of engine_sweep_rows): gbm, and the samplers
LAUNCHES.update({"mc_engine_bar_sweep": 0, "mc_engine_bar_sweep_sampler": 0})
# the single-run rows kernel (ops/csrc/mc_engine_rows.cu) and the book rows
# kernel (ops/csrc/mc_engine_book_rows.cu): each launch counter of the parents
# they take, with "_rows" (mc_engine_rows, mc_engine_rows_sampler,
# mc_engine_rows_universe, ..., mc_engine_rows_corr, mc_engine_rows_corr_sampler)
LAUNCHES.update({"mc_engine_rows" + k: 0 for k in (
    "", "_sampler", "_universe", "_universe_sampler", "_universe_sweep",
    "_universe_sweep_sampler", "_corr", "_corr_sampler")})
HV_COUNTS, HV_SUMS = HV.COUNT_COLS, HV.SUM_COLS   # a harvest partial row's columns


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_F, _I = ctypes.c_float, ctypes.c_int32


class _EngineArgs(ctypes.Structure):
    """Mirror of ``struct EngineArgs`` in ops/csrc/mc_engine.cu."""

    _fields_ = [("num_paths", ctypes.c_int64), ("ext_offset", ctypes.c_int64),
                ("level_price", _F * MAX_LEVELS), ("level_round", _F * MAX_LEVELS),
                ("level_valid", _I * MAX_LEVELS), ("level_kind", _I * MAX_LEVELS)]
    _fields_ += [(k, _F) for k in (
        "prox", "prox_conf", "stop_pad", "tp_pad", "qmin", "veto_strong",
        "veto_near", "confl_within", "w_rules", "w_ml", "lvl_jit", "entry_slip",
        "stop_slip", "tgt_slip")]
    _fields_ += [("ml_coef", _F * 4), ("ml_intercept", _F), ("pol_w", (_F * 7) * 3)]
    _fields_ += [(k, _F) for k in (
        "tm_tol_bps", "tm_min_px_bps", "tm_decay", "tm_fat_vol_k", "g_comp",
        "g_vol_k", "drift", "sig_dt", "two_s2", "log_s0", "vm_base", "vm_uamp",
        "vm_sigma", "vm_rc", "vm_day", "vm_open", "vm_den", "vm_third",
        "vm_half_s2", "vm_mean_abs", "vm_sd_abs", "vm_floor")]
    _fields_ += [("seed", ctypes.c_uint32), ("stream", ctypes.c_uint32)]
    _fields_ += [(k, _I) for k in (
        "cooldown_ms", "overtouch_limit", "enable_veto", "use_blend", "ml_usable",
        "ml_ran", "policy_on", "bar0_minute", "has_levels", "tm_min_gap_ms",
        "tm_max_bounces", "tm_fat_win_ms", "g_min_bars", "g_clear_bars",
        "max_levels", "num_bars", "lanes", "u_rows", "stride", "use_noise",
        "antithetic", "escalation")]


def _check(seed, levels, kw: dict, *, num_paths, num_bars, lanes, noise,
           antithetic, external_uniforms, sampler: Sampler = Sampler(),
           book: bool = False) -> EngineLayout:
    """The checks of ``mc_paths_pallas_engine`` (pallas_engine.py:1678-1698)
    and the kernels' envelope (up to 64 level slots, W >= 2, even in a book,
    int32 bar timestamps); ``book``: a book symbol's layout."""
    check_blocks(seed, levels, num_paths=num_paths, lanes=lanes, sub=ENGINE_SUB,
                 what="engine", max_slots=MAX_ENGINE_LEVELS)
    if antithetic and sampler.kind != "gbm":
        raise ValueError("kernel antithetic pairs gbm normals only")
    layout = EngineLayout(num_bars, noise is not None, sampler.kind, book)
    if num_bars > MAX_BARS:
        raise ValueError(f"the engine kernels take num_bars <= {MAX_BARS} (bar "
                         "timestamps in int32 milliseconds)")
    if int(kw["touch_params"].fatigue_hits) != TAP_SLOTS:
        raise ValueError(f"the engine kernel is built for fatigue_hits == {TAP_SLOTS}")
    gp = kw["guard_params"]
    if int(gp.vol_short) != 5 or int(gp.vol_long) != 20:
        raise ValueError("the engine kernel is built for 5/20-bar guard MAs")
    check_uniforms(external_uniforms,
                   (num_paths // (ENGINE_SUB * lanes), layout.u_rows, ENGINE_SUB, lanes),
                   antithetic=antithetic, lanes=lanes)
    return layout


# --------------------------------------------------------------------------
# the plain PyTorch version
# --------------------------------------------------------------------------

class _VolumeConsts:
    """The volume model's float32 constants, computed on the host in float64
    (or, where the JAX kernel rounds twice, as it does) and rounded once."""

    def __init__(self, vm: VolumeModel):
        sig = f32(vm.noise_sigma)
        self.base, self.uamp, self.sigma = f32(vm.base), f32(vm.u_amp), sig
        self.rc, self.day, self.open = f32(vm.ret_coupling), f32(vm.day_minutes), f32(vm.open_minute)
        self.den = f32(max(vm.day_minutes - 1, 1))
        self.third = f32(1.0 / 3.0)
        self.half_s2 = f32(0.5 * sig * sig)       # the f32 product, halved
        self.mean_abs = f32(math.sqrt(2.0 / math.pi))
        self.sd_abs = f32(math.sqrt(1.0 - 2.0 / math.pi))
        self.floor = f32(0.05 * vm.base)

    def volume(self, t: int, z: torch.Tensor, zv: torch.Tensor) -> torch.Tensor:
        """VolumeModel.volumes for bar ``t`` (pallas_engine.py:528-539):
        float32 in the kernel's order."""
        def s(x):
            return torch.tensor(x, dtype=_F32)

        m_min = torch.remainder(s(self.open) + float(t), s(self.day))
        xu = 2.0 * m_min / s(self.den) - 1.0
        ushape = 1.0 + s(self.uamp) * (xu * xu - s(self.third))
        v = s(self.base) * ushape.to(z.device) * torch.exp(self.sigma * zv - self.half_s2)
        if self.rc != 0.0:
            v = v * (1.0 + s(self.rc) * div(z.abs() - self.mean_abs, self.sd_abs))
        return torch.clamp(v, min=self.floor)


def _bars(u, layout: EngineLayout, antithetic: bool, cs, vc: _VolumeConsts, market=None,
          sampler: Sampler = Sampler()):
    """Per bar, in order: (t, log open, high, low, close, volume, tie coin,
    noise normals or None), each [nb, 8, lanes], as
    ``_engine_lifecycle_loop`` draws and builds them from uniforms u
    f32[nb, u_rows, 8, lanes].  A book symbol's ``market`` = (market
    draws, beta) (``ops/cuda_gated.book_market``) mixes the market into
    the price normal before the volume model sees it (or, bootstrap, gives
    its index uniforms).  A bootstrap ``sampler``'s bars bring their recorded
    volumes; Heston's go through the volume model as gbm's do."""
    drift, sig_dt, log_s0 = cs
    if sampler.kind != "gbm":
        stream = StreamBars(sampler, log_s0, u[:, 0].shape, u.device)
        for t, x, zq, zv, bridge_u, tie, nz in sampler_steps(u, layout, market):
            log_open, _, high, low, c, vol = stream.bar(t, x, zq, bridge_u)
            yield (t, log_open, high, low, c, vc.volume(t, x, zv) if vol is None else vol,
                   tie, nz)
        return
    nb, _, sub, lanes = u.shape
    log_s = torch.full((nb, sub, lanes), log_s0, dtype=_F32, device=u.device)
    for t2 in range((layout.num_bars + 1) // 2):
        def draw(k):
            return u[:, layout.row(t2, k)]

        z_pair = box_muller(draw(0), draw(1))
        if antithetic:
            h = lanes // 2
            z_pair = tuple(torch.cat([z[..., :h], -z[..., :h]], dim=-1) for z in z_pair)
        if market is not None:
            zm, beta = market[0][t2], market[1]
            z_pair = tuple(mix_shocks(beta, zm[h], z_pair[h]) for h in range(2))
        zv_pair = box_muller(draw(2), draw(3))
        # an odd W's last step is a half step: the cos branch of each pair
        for half in range(min(2, layout.num_bars - 2 * t2)):
            t, z = 2 * t2 + half, z_pair[half]
            u3, u4, tie = (draw(4 + 3 * half + i) for i in range(3))
            nz = None
            if layout.noise:
                k = 10 + 4 * half
                nz = box_muller(draw(k), draw(k + 1)) + box_muller(draw(k + 2), draw(k + 3))
            log_open = log_s
            log_s, c, high, low = gated_bar(log_s, z, u3, u4, drift, sig_dt)
            yield t, log_open, high, low, c, vc.volume(t, z, zv_pair[half]), tie, nz


def engine_bars_from_uniforms(u: torch.Tensor, layout: EngineLayout, *,
                              s0=100.0, mu: float = 0.0, sigma: float = 0.15,
                              dt: float = 1.0 / (390.0 * 252.0),
                              antithetic: bool = False, volume_model=None,
                              market_uniforms=None, beta: float = 0.0,
                              sampler: Sampler = Sampler()):
    """The bars the plain version generates from uniforms f32[nb, u_rows, 8,
    lanes]: (PathBars f32[P, W] with volumes, tie f32[P, W], noise normals
    f32[4, P, W] or None), path p = block * 8 * lanes + s * lanes + j.  For
    replaying them through ``sim.enginepath.engine_path_replay``.  A book
    symbol's bars (``layout.book``) take the market's draws of
    ``market_uniforms`` f32[nb, u_rows, 8, lanes] (``ops/draws.MarketLayout``)
    with loading ``beta``, as ``ops/cuda_gated.gated_bars_from_uniforms``'."""
    vc = _VolumeConsts(VolumeModel() if volume_model is None else volume_model)
    nb, _, sub, lanes = u.shape
    cols = {k: [] for k in ("open", "high", "low", "close", "volume", "tie", "nz")}
    market = (None if market_uniforms is None
              else (book_market(market_uniforms, antithetic, sampler), f32(beta)))
    for _, log_open, high, low, c, v, tie, nz in _bars(
            u, layout, antithetic, consts(s0, mu, sigma, dt), vc, market, sampler):
        for k, x in (("open", torch.exp(log_open)), ("high", high), ("low", low),
                     ("close", c), ("volume", v), ("tie", tie)):
            cols[k].append(x)
        if nz is not None:
            cols["nz"].append(torch.stack(nz))

    def flat(rows):
        return torch.stack(rows, dim=-1).reshape(nb * sub * lanes, -1)

    bars = PathBars(*(flat(cols[k]) for k in ("open", "high", "low", "close", "volume")))
    nzs = (torch.stack(cols["nz"], dim=-1).reshape(4, nb * sub * lanes, -1)
           if layout.noise else None)
    return bars, flat(cols["tie"]), nzs


def path_rows(out, path_skips: torch.Tensor) -> torch.Tensor:
    """f32[P, PATH_COLS] per-path rows of an engine outcome and its per-path
    skip table int[P, 16]: equity, trades, wins, losses, open, dd,
    escalations, then the skip counts ordered as SKIP_REASONS."""
    return torch.cat([torch.stack([out.equity, out.trades.float(), out.wins.float(),
                                   out.losses.float(), out.open_at_end.float(),
                                   out.max_dd, out.escalations.float()], dim=1),
                      path_skips.float()], dim=1)


def _chunk_engine(u, layout: EngineLayout, levels, params, kw, noise, cs, vc,
                  antithetic, per_path: bool, market=None, book=None, weight=None,
                  sampler: Sampler = Sampler(), harvest: bool = False):
    """Totals, per-path rows (or None) and harvest (or None) of one chunk
    of blocks, u f32[nb, u_rows, 8, lanes]: the TPU kernel's block
    computation with the engine of ``sim.enginepath``, binned as
    ``_engine_accumulate`` bins.  A book symbol (``market`` as in ``_bars``)
    adds its post-bar equity, times ``weight``, into the ``book``
    (``sim/book.BookCurve``) after every bar."""
    life, path_skips = None, 0
    for t, log_open, *bar, nz in _bars(u, layout, antithetic, cs, vc, market, sampler):
        if life is None:
            life = EngineLifecycle(torch.exp(log_open).reshape(-1), levels, params,
                                   noise=noise, windowed=layout.num_bars > GUARD_WINDOW_BARS,
                                   harvest=harvest, **kw)
        reason = life.step(t, *(x.reshape(-1) for x in bar),
                           None if nz is None else tuple(x.reshape(-1) for x in nz))
        if per_path:
            path_skips = path_skips + skip_columns(reason)
        if book is not None:
            book.add_bar(t, weight, life.equity)
    out = life.outcome()
    if book is not None:
        book.add_symbol(out)
    counts, floats = lifecycle_totals(out, N_COUNTS + N_SKIPS)
    counts[6] = out.escalations.sum()
    counts[N_COUNTS:N_COUNTS + N_SKIPS] = out.skip_counts
    return (counts, floats, path_rows(out, path_skips) if per_path else None,
            out.harvest)


def stats_from_engine_totals(counts: torch.Tensor, floats: torch.Tensor):
    """int64 counts [..., n, entered, wins, losses, open, trades,
    escalations, skips..., hist...] and float64 [..., sum_eq, sum_eq2, sum_dd,
    min_eq, max_eq, max_dd] -> (float32 lifecycle PathStats, int64[..., 16]
    skip table, int64 escalations), the triple of ``_unpack_acc_engine``,
    with a leading [G] axis for a sweep's totals."""
    lifecycle = torch.cat([counts[..., :6], counts[..., N_COUNTS + N_SKIPS:]], dim=-1)
    return (stats_from_gated_totals(lifecycle, floats),
            counts[..., N_COUNTS:N_COUNTS + N_SKIPS], counts[..., 6])


def engine_totals_reference(seed, levels: Levels, params, *, policy=None,
                            ml_model=None, touch_params=None, guard_params=None,
                            policy_gate_disabled=None, escalation: bool = True,
                            bar0_minute: int = 0, volume_model=None, noise=None,
                            antithetic: bool = False, num_paths: int,
                            num_bars: int = 40, s0: float = 100.0, mu: float = 0.0,
                            sigma: float = 0.15, dt: float = 1.0 / (390.0 * 252.0),
                            lanes: int = ENGINE_LANES, external_uniforms=None,
                            device=None, chunk_blocks: int = 16,
                            per_path: bool = False, symbol: int = 0, sampler: str = "gbm",
                            hist_bars=None, tables=None, block_len: int = 10,
                            heston=None, harvest: bool = False):
    """The plain version's (int64 counts, float64 floats) totals, computed
    on ``device`` (default: that of ``external_uniforms``, else the CUDA
    device) in chunks of ``chunk_blocks`` blocks, Philox draws keyed as
    universe symbol ``symbol``, ``sampler`` and its inputs as in
    ``mc_paths_engine_fused``; then, when ``per_path``, the f32[P,
    PATH_COLS] per-path rows of ``path_rows``; then, with ``harvest``, the
    ``models/harvest.EngineHarvest`` of the closed trades."""
    kw = engine_knobs(policy, ml_model, touch_params, guard_params,
                    policy_gate_disabled, escalation, bar0_minute)
    samp = make_sampler(sampler, hist_bars=hist_bars, tables=tables, block_len=block_len,
                        heston=heston, mu=mu, dt=dt)
    layout = _check(seed, levels, kw, num_paths=num_paths, num_bars=num_bars,
                    lanes=lanes, noise=noise, antithetic=antithetic,
                    external_uniforms=external_uniforms, sampler=samp)
    device = devices.resolve(device, external_uniforms)
    levels = levels.to(device)
    cs = consts(s0, mu, sigma, dt)
    vc = _VolumeConsts(VolumeModel() if volume_model is None else volume_model)
    n_blocks = num_paths // (ENGINE_SUB * lanes)
    tot, rows = None, []
    hv = HV.EngineHarvest.zero(device=device) if harvest else None
    for b0 in range(0, n_blocks, chunk_blocks):
        nb = min(chunk_blocks, n_blocks - b0)
        if external_uniforms is not None:
            u = external_uniforms[b0:b0 + nb]
        else:
            u = engine_uniforms(seed, layout, block0=b0, n_blocks=nb, lanes=lanes,
                                symbol=symbol, device=device)
        *part, part_rows, part_hv = _chunk_engine(u, layout, levels, params, kw, noise, cs,
                                                  vc, antithetic, per_path, sampler=samp,
                                                  harvest=harvest)
        tot = merge_totals(tot, part)
        if per_path:
            rows.append(part_rows)
        if harvest:
            hv = hv.merge(part_hv)
    return (*tot, *((torch.cat(rows),) if per_path else ()), *((hv,) if harvest else ()))


def engine_sweep_totals_reference(seed, levels: Levels, grid_params, *, n_grid=None,
                                  policy=None, ml_model=None, touch_params=None,
                                  guard_params=None, policy_gate_disabled=None,
                                  escalation: bool = True, bar0_minute: int = 0,
                                  volume_model=None, noise=None, num_paths: int,
                                  num_bars: int = 40, s0: float = 100.0, mu: float = 0.0,
                                  sigma: float = 0.15, dt: float = 1.0 / (390.0 * 252.0),
                                  lanes: int = ENGINE_LANES, external_uniforms=None,
                                  device=None, chunk_blocks: int = 16,
                                  per_path: bool = False, symbol: int = 0,
                                  sampler: str = "gbm", hist_bars=None, tables=None,
                                  block_len: int = 10, heston=None, harvest: bool = False):
    """The plain version of the sweep: int64 [G, 151] counts and float64
    [G, 6] floats, then f32[G, P, PATH_COLS] per-(row, path) rows when
    ``per_path``, then with ``harvest`` (the universes' rows: the sweeps
    themselves take none) the [G] ``EngineHarvest``.  Each chunk's uniforms are drawn once (keyed as universe
    symbol ``symbol``) and every row runs the whole engine on them (the TPU
    kernel's reseeding); ``sampler`` and its inputs as in
    ``mc_paths_engine_fused`` (every row on the same history)."""
    rows = knob_rows(grid_params, noise, n_grid)
    kw = engine_knobs(policy, ml_model, touch_params, guard_params,
                      policy_gate_disabled, escalation, bar0_minute)
    samp = make_sampler(sampler, hist_bars=hist_bars, tables=tables, block_len=block_len,
                        heston=heston, mu=mu, dt=dt)
    layout = _check(seed, levels, kw, num_paths=num_paths, num_bars=num_bars,
                    lanes=lanes, noise=noise, antithetic=False,
                    external_uniforms=external_uniforms, sampler=samp)
    device = devices.resolve(device, external_uniforms)
    levels = levels.to(device)
    cs = consts(s0, mu, sigma, dt)
    vc = _VolumeConsts(VolumeModel() if volume_model is None else volume_model)
    n_blocks = num_paths // (ENGINE_SUB * lanes)
    tot, path_rows = [None] * len(rows), [[] for _ in rows]
    hvs = [HV.EngineHarvest.zero(device=device) for _ in rows]
    for b0 in range(0, n_blocks, chunk_blocks):
        nb = min(chunk_blocks, n_blocks - b0)
        if external_uniforms is not None:
            u = external_uniforms[b0:b0 + nb]
        else:
            u = engine_uniforms(seed, layout, block0=b0, n_blocks=nb, lanes=lanes,
                                symbol=symbol, device=device)
        for g, (p_g, noise_g) in enumerate(rows):
            *part, part_rows, part_hv = _chunk_engine(u, layout, levels, p_g, kw, noise_g,
                                                      cs, vc, False, per_path, sampler=samp,
                                                      harvest=harvest)
            tot[g] = merge_totals(tot[g], part)
            if per_path:
                path_rows[g].append(part_rows)
            if harvest:
                hvs[g] = hvs[g].merge(part_hv)
    out = (torch.stack([t[0] for t in tot]), torch.stack([t[1] for t in tot]))
    if per_path:
        out += (torch.stack([torch.cat(r) for r in path_rows]),)
    return out + (HV.stack(hvs),) if harvest else out


# --------------------------------------------------------------------------
# the kernel wrappers
# --------------------------------------------------------------------------

_BOUND: set[int] = set()


def _library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures set."""
    lib = build.load(_SOURCE)
    if id(lib) not in _BOUND:
        vp = ctypes.c_void_p
        lib.qmmx_engine_args_size.argtypes = []
        lib.qmmx_engine_args_size.restype = ctypes.c_int
        lib.qmmx_engine_error_string.argtypes = [ctypes.c_int]
        lib.qmmx_engine_error_string.restype = ctypes.c_char_p
        ci = ctypes.c_int
        lib.qmmx_mc_engine_sweep.argtypes = [vp, ci, ci, ci, vp, vp, vp, vp, ci, vp]
        lib.qmmx_mc_engine_sweep.restype = ci
        lib.qmmx_mc_engine_reduce_rows.argtypes = [vp, vp, ci, ci, vp, vp, vp]
        lib.qmmx_mc_engine_reduce_rows.restype = ci
        if lib.qmmx_engine_args_size() != ctypes.sizeof(_EngineArgs):
            raise RuntimeError("EngineArgs layout differs between "
                               "mc_engine.cu and cuda_engine._EngineArgs")
        _BOUND.add(id(lib))
    return lib


def _corr_library() -> ctypes.CDLL:
    """The book kernel's library (``ops/csrc/mc_engine_corr.cu``, its own
    build of ``mc_engine.cuh``), built at first use, with its C signature set;
    the engine library's struct-layout check first."""
    _library()
    lib = build.load(_SOURCE + "_corr")
    if id(lib) not in _BOUND:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.qmmx_mc_engine_corr.argtypes = [vp, vp, ci, ci, ci, vp, vp, ctypes.c_uint, vp, vp,
                                            vp, vp, ci, vp]
        lib.qmmx_mc_engine_corr.restype = ci
        _BOUND.add(id(lib))
    return lib


def _corr_sampler_library() -> ctypes.CDLL:
    """The book sampler kernel's library (``ops/csrc/mc_engine_corr_samplers.cu``,
    its own build of ``mc_engine.cuh``), built at first use, with its C
    signature set; the engine library's struct-layout check first."""
    _library()
    lib = build.load(_SOURCE + "_corr_samplers")
    if id(lib) not in _BOUND:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.qmmx_engine_corr_sampler_args_size.argtypes = []
        lib.qmmx_engine_corr_sampler_args_size.restype = ci
        lib.qmmx_mc_engine_corr_sampler.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp, vp,
                                                    ctypes.c_uint, vp, vp, vp, vp, ci, vp]
        lib.qmmx_mc_engine_corr_sampler.restype = ci
        if lib.qmmx_engine_corr_sampler_args_size() != ctypes.sizeof(SamplerArgs):
            raise RuntimeError("SamplerArgs layout differs between sampler.cuh and "
                               "kernel_args.SamplerArgs")
        _BOUND.add(id(lib))
    return lib


def _sampler_library() -> ctypes.CDLL:
    """The sampler kernels' library (``ops/csrc/mc_engine_samplers.cu``, its
    own build of ``mc_engine.cuh``), built at first use, with its C signature
    set; the engine library's struct-layout check first."""
    _library()
    lib = build.load(_SOURCE + "_samplers")
    if id(lib) not in _BOUND:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.qmmx_engine_sampler_args_size.argtypes = []
        lib.qmmx_engine_sampler_args_size.restype = ci
        lib.qmmx_mc_engine_sampler.argtypes = [vp, vp, ci, ci, ci, ci, vp, vp, vp, vp, ci,
                                               vp]
        lib.qmmx_mc_engine_sampler.restype = ci
        if lib.qmmx_engine_sampler_args_size() != ctypes.sizeof(SamplerArgs):
            raise RuntimeError("SamplerArgs layout differs between sampler.cuh and "
                               "kernel_args.SamplerArgs")
        _BOUND.add(id(lib))
    return lib


ROWS_SOURCE = "mc_engine_rows"


def _rows_library() -> ctypes.CDLL:
    """The single-run rows kernel's library (``ops/csrc/mc_engine_rows.cu``),
    built at first use, with its C signature set and its struct layouts
    checked against the host's; the engine library first (the fold and the
    error strings are its)."""
    _library()
    lib = build.load(ROWS_SOURCE)
    if id(lib) not in _BOUND:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.qmmx_engine_rows_size.argtypes = [ci]
        lib.qmmx_engine_rows_size.restype = ci
        lib.qmmx_mc_engine_rows.argtypes = [vp, vp, ci, ci, ci, ci, vp, vp, vp, vp, ci, vp]
        lib.qmmx_mc_engine_rows.restype = ci
        if [lib.qmmx_engine_rows_size(i) for i in range(2)] != [ctypes.sizeof(_EngineArgs),
                                                                ctypes.sizeof(SamplerArgs)]:
            raise RuntimeError("the struct layouts differ between mc_engine_rows.cu "
                               "and cuda_engine.py")
        _BOUND.add(id(lib))
    return lib


BOOK_ROWS_SOURCE = "mc_engine_book_rows"


def _book_rows_library() -> ctypes.CDLL:
    """The book rows kernel's library (``ops/csrc/mc_engine_book_rows.cu``),
    built at first use, with its C signatures set and its struct layouts
    checked against the host's; the engine library first (the fold and the
    error strings are its)."""
    _library()
    lib = build.load(BOOK_ROWS_SOURCE)
    if id(lib) not in _BOUND:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.qmmx_engine_book_rows_size, lib.qmmx_engine_book_rows_scratch):
            fn.argtypes = [ci]
            fn.restype = ci
        lib.qmmx_mc_engine_book_rows.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp, vp,
                                                 ctypes.c_uint, vp, ci, vp, vp, vp, ci, vp]
        lib.qmmx_mc_engine_book_rows.restype = ci
        if [lib.qmmx_engine_book_rows_size(i) for i in range(2)] != [
                ctypes.sizeof(_EngineArgs), ctypes.sizeof(SamplerArgs)]:
            raise RuntimeError("the struct layouts differ between mc_engine_book_rows.cu "
                               "and cuda_engine.py")
        _BOUND.add(id(lib))
    return lib


_WIDE_SIGNATURES = {   # the envelope libraries' C entries (ops/csrc/mc_engine_wide*.cu)
    # v: a pointer (or the stream), i: an int, u: an unsigned (the market key)
    # (every entry ends with the scratch and the cell counter before the
    # stream: scratch, scratch_ctas, next; env_tail)
    "_wide": ("qmmx_mc_engine_wide_sweep", "vviiivvvvivivv"),
    "_wide_samplers": ("qmmx_mc_engine_wide_sampler", "vvviiiivvvvivivv"),
    "_wide_corr": ("qmmx_mc_engine_wide_corr", "vvviiivvuvvvvivivv"),
    "_wide_corr_samplers": ("qmmx_mc_engine_wide_corr_sampler", "vvvviiiivvuvvvvivivv"),
    # the harvest builds: two more pointers (the harvest rows) before the grid
    "_wide_harvest": ("qmmx_mc_engine_wide_harvest", "vviiivvvvvvivivv"),
    "_wide_samplers_harvest": ("qmmx_mc_engine_wide_sampler_harvest", "vvviiiivvvvvvivivv"),
    "_wide_corr_harvest": ("qmmx_mc_engine_wide_corr_harvest", "vvviiivvuvvvvvvivivv"),
    "_wide_corr_samplers_harvest": ("qmmx_mc_engine_wide_corr_sampler_harvest",
                                    "vvvviiiivvuvvvvvvivivv"),
}


def _wide_library(suffix: str) -> ctypes.CDLL:
    """An envelope kernel's library (``ops/csrc/mc_engine<suffix>.cu``), built
    at first use, with its C signature set and its struct layouts checked
    against the host's (``EngineArgs`` through the engine library, the level
    slot through ``mc_engine_wide``'s, ``SamplerArgs``)."""
    if suffix == "_wide":
        _library()
    else:
        _wide_library("_wide")
    lib = build.load(_SOURCE + suffix)
    if id(lib) not in _BOUND:
        name, sig = _WIDE_SIGNATURES[suffix]
        types = {"v": ctypes.c_void_p, "i": ctypes.c_int, "u": ctypes.c_uint}
        fn = getattr(lib, name)
        fn.argtypes = [types[c] for c in sig]
        fn.restype = ctypes.c_int
        if suffix == "_wide":
            lib.qmmx_engine_wide_level_size.restype = ctypes.c_int
            if lib.qmmx_engine_wide_level_size() != _WIDE_LEVEL.itemsize:
                raise RuntimeError("WideLevel layout differs between mc_engine_wide.cuh "
                                   "and cuda_engine._WIDE_LEVEL")
            for fn in (lib.qmmx_engine_env_smem_bytes, lib.qmmx_engine_env_scratch_slots):
                fn.argtypes = [ctypes.c_int, ctypes.c_int]
                fn.restype = ctypes.c_int
            for n in range(1, MAX_ENGINE_LEVELS + 1):
                if (lib.qmmx_engine_env_smem_bytes(n, ENV_THREADS) != env_smem_bytes(n)
                        or lib.qmmx_engine_env_scratch_slots(n, 1)
                        != env_scratch_slots(n, GUARD_WINDOW_BARS + 1)
                        or lib.qmmx_engine_env_scratch_slots(n, 0) != env_scratch_slots(n, 2)):
                    raise RuntimeError("the shared-memory or scratch layout differs between "
                                       "mc_engine_env.cuh and cuda_engine.env_*")
        if suffix == "_wide_harvest":
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.qmmx_mc_engine_harvest_reduce_rows.argtypes = [vp, vp, ci, ci, vp, vp, vp]
            lib.qmmx_mc_engine_harvest_reduce_rows.restype = ci
            lib.qmmx_engine_harvest_cols.restype = ci
            if lib.qmmx_engine_harvest_cols() != HV_COUNTS * 100 + HV_SUMS:
                raise RuntimeError("the harvest row layout differs between "
                                   "mc_engine_wide.cuh and models/harvest.py")
        size = {"_wide_samplers": "qmmx_engine_wide_sampler_args_size",
                "_wide_corr_samplers": "qmmx_engine_wide_corr_sampler_args_size",
                "_wide_samplers_harvest": "qmmx_engine_wide_sampler_harvest_args_size",
                "_wide_corr_samplers_harvest":
                    "qmmx_engine_wide_corr_sampler_harvest_args_size"}.get(suffix)
        if size is not None:
            getattr(lib, size).restype = ctypes.c_int
            if getattr(lib, size)() != ctypes.sizeof(SamplerArgs):
                raise RuntimeError("SamplerArgs layout differs between sampler.cuh and "
                                   "kernel_args.SamplerArgs")
        _BOUND.add(id(lib))
    return lib


# The redesigned envelope kernels (gbm, the samplers, the books and their
# harvest builds; ops/csrc/mc_engine_env.cuh): a path's flags and contact
# counts are in dynamic shared memory, ``env_thread_bytes`` a thread, in CTAs of
# ENV_THREADS at every level count (64 levels: 64.5 KB of an SM's 228); its
# touch registers and the windowed guard's rings in a device scratch,
# ``env_scratch_slots`` 4-byte slots a thread, for the most threads an SM
# holds at the kernels' register bounds (1024: the samplers' 64 registers a
# thread); the C side launches no more CTAs than the scratch holds.
ENV_THREADS = 256
ENV_STATIC_MAX = 4096          # the kernels' static shared memory, at most (checked at launch)
_ENV_SCRATCH_THREADS_SM = 1024
_VOL_RING, _CLOSE_RING = 20, 5  # mc_engine.cuh's VOL_RING, CLOSE_RING


def env_thread_bytes(max_levels: int) -> int:
    """A thread's shared memory in the envelope kernels (mc_engine_env.cuh's
    ``env_thread_bytes``): the volume and close rings and the latch and
    touch-flag words in 4 bytes a slot, the contact counts in 2."""
    words = (max_levels + 31) // 32 + (2 * max_levels + 31) // 32
    return 4 * (_VOL_RING + _CLOSE_RING + words) + 2 * max_levels


def env_smem_bytes(max_levels: int) -> int:
    """A CTA's dynamic shared memory at ``max_levels`` slots (``env_smem_bytes``):
    the [max_levels] level table and its threads' ``env_thread_bytes``."""
    return _WIDE_LEVEL.itemsize * max_levels + ENV_THREADS * env_thread_bytes(max_levels)


def env_scratch_slots(max_levels: int, num_bars: int) -> int:
    """A thread's 4-byte slots of the envelope kernels' device scratch
    (``env_scratch_slots``): each (level, side)'s touch count and bar, and
    its price; the windowed guard's 61 lows and 61 highs past 61 bars."""
    return 4 * max_levels + (2 * GUARD_WINDOW_BARS if num_bars > GUARD_WINDOW_BARS else 0)


ENV_BOOK_MIN_BLOCKS = 4   # the books' CTAs an SM under __launch_bounds__ (mc_engine_wide_corr.cuh)


def env_book_static_bytes(harvest: bool) -> int:
    """The book kernels' static shared memory (mc_engine_wide_corr.cuh): the
    symbol's EngineArgs, SamplerArgs and (beta, weight), the cell index, and
    env_add_path_row's counts, histogram and warp sums; with the harvest the
    CTA's 64-bit tallies and hv_cta_row's warp sums."""
    warps = ENV_THREADS // 32
    n = (ctypes.sizeof(_EngineArgs) + ctypes.sizeof(SamplerArgs) + 8 + 4
         + 4 * (N_COUNTS + N_SKIPS) + 4 * HIST_BINS + 4 * 6 * warps)
    return n + (8 * HV_COUNTS + 4 * HV_SUMS * warps if harvest else 0)


def env_tail(max_levels: int, num_bars: int, device) -> tuple:
    """The envelope entries' last arguments before the stream: (scratch,
    scratch_ctas, next) and the tensors behind the two pointers (kept alive
    by the caller until the launch is queued)."""
    ctas = (torch.cuda.get_device_properties(device).multi_processor_count
            * _ENV_SCRATCH_THREADS_SM // ENV_THREADS)
    scratch = torch.empty(env_scratch_slots(max_levels, num_bars) * ctas * ENV_THREADS,
                          dtype=_F32, device=device)
    next_cell = torch.empty(1, dtype=torch.int32, device=device)
    return (scratch.data_ptr(), ctas, next_cell.data_ptr()), (scratch, next_cell)


def _rows(what: str) -> str:
    """The rows kernel's launch counter of a parent's: ``mc_engine`` ->
    ``mc_engine_rows``, ``mc_engine_universe_sampler`` ->
    ``mc_engine_rows_universe_sampler``."""
    return "mc_engine_rows" + what[len("mc_engine"):]


def _wide(what: str) -> str:
    """The envelope kernel's launch counter of a parent's counter ``what``."""
    return "mc_engine_wide" + what[len("mc_engine"):]


def _harvest_rows(n: int, grid: int, device) -> tuple:
    """Empty harvest partial rows of ``n`` launch rows: int64 [n, grid,
    HV_COUNTS] and f32 [n, grid, HV_SUMS]."""
    return (torch.empty((n, grid, HV_COUNTS), dtype=torch.int64, device=device),
            torch.empty((n, grid, HV_SUMS), dtype=_F32, device=device))


def reduce_harvest(part_counts: torch.Tensor, part_sums: torch.Tensor) -> HV.EngineHarvest:
    """The harvest rows' pass 2: int64 [..., R, HV_COUNTS] and f32 [..., R,
    HV_SUMS] partial rows -> the [...] ``EngineHarvest`` (counts summed in
    int64, sums in float64 in row order, then rounded to float32), one launch
    of ``fold_harvest_rows`` (a CTA a segment) counted in
    ``LAUNCHES["mc_engine_harvest_reduce_rows"]`` for CUDA tensors, the plain
    version for CPU tensors."""
    lead = part_counts.shape[:-2]
    if part_counts.device.type == "cpu" and part_sums.device.type == "cpu":
        return HV.EngineHarvest.from_columns(part_counts.sum(dim=-2),
                                             part_sums.double().sum(dim=-2))
    pc = part_counts.reshape(-1, *part_counts.shape[-2:]).contiguous()
    ps = part_sums.reshape(-1, *part_sums.shape[-2:]).contiguous()
    segs, rows = pc.shape[:2]
    if pc.dtype != torch.int64 or ps.dtype != _F32 or ps.shape[:2] != pc.shape[:2] \
            or pc.shape[2] != HV_COUNTS or ps.shape[2] != HV_SUMS:
        raise ValueError(f"harvest rows must be int64 [..., R, {HV_COUNTS}] and "
                         f"float32 [..., R, {HV_SUMS}]")
    tc = torch.empty((segs, HV_COUNTS), dtype=torch.int64, device=pc.device)
    ts = torch.empty((segs, HV_SUMS), dtype=torch.float64, device=pc.device)
    rc = _wide_library("_wide_harvest").qmmx_mc_engine_harvest_reduce_rows(
        pc.data_ptr(), ps.data_ptr(), rows, segs, tc.data_ptr(), ts.data_ptr(),
        torch.cuda.current_stream(pc.device).cuda_stream)
    _raise_on(rc, "mc_engine_harvest_reduce_rows")
    LAUNCHES["mc_engine_harvest_reduce_rows"] += 1
    return HV.EngineHarvest.from_columns(tc.view(*lead, HV_COUNTS), ts.view(*lead, HV_SUMS))


SAMPLER_KINDS = {"bootstrap": 1, "block_bootstrap": 1, "heston": 3}   # sampler.cuh


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().qmmx_engine_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


# One level slot of the envelope kernels' level table (struct WideLevel of
# ops/csrc/mc_engine_wide.cuh).
_WIDE_LEVEL = np.dtype([("price", np.float32), ("round", np.float32), ("valid", np.int32),
                        ("kind", np.int32)])


def level_table(levels: Levels, n: int) -> np.ndarray:
    """The level slots of ``n`` launch rows as a [n, L] table of
    ``_WIDE_LEVEL`` (``levels`` [L], every row's, or [n, L]): the price
    (invalid slots zeroed), its rounding to cents for the touch memory, 1/0
    validity and 1 for a solid level, each float32 as the plain version
    computes it.  The envelope kernels read it; the parents take its columns
    in their ``EngineArgs``."""
    cpu = levels.to("cpu")
    price = cpu.price.to(_F32)
    t = np.zeros((n, price.shape[-1]), _WIDE_LEVEL)
    t["price"] = torch.where(torch.isfinite(price), price, 0.0).numpy()
    t["round"] = torch.where(cpu.valid, torch.round(cpu.price * 100.0) / 100.0, 0.0).numpy()
    t["valid"] = cpu.valid.numpy()
    t["kind"] = (cpu.kind == KIND_SOLID).numpy()
    return t


def needs_envelope(max_levels: int, num_bars: int) -> bool:
    """Whether the shape needs the envelope kernels: the parents take at most
    8 level slots and an even W <= 61."""
    return not (max_levels <= MAX_LEVELS and num_bars % 2 == 0
                and num_bars <= GUARD_WINDOW_BARS)


# A check's hook: while true, every launch goes to the envelope kernel, even
# where the parent fits, to hold the two against each other bit for bit.
_FORCE_ENVELOPE = False


# A check's hook: while true, the launches the rows kernels take go to the
# parents they replaced (mc_engine_sweep_kernel, mc_engine_sampler_kernel,
# mc_engine_corr_kernel, mc_engine_corr_sampler_kernel), to hold the two
# against each other bit for bit.
_FORCE_PARENT = False


def _use_envelope(max_levels: int, num_bars: int, harvest: bool = False) -> bool:
    """Whether a launch goes to the envelope kernels: where the parents do
    not take the shape, under the checks' hook, and always with the harvest
    (only the envelope kernels have a harvest build)."""
    return harvest or _FORCE_ENVELOPE or needs_envelope(max_levels, num_bars)


def _pack_args(seed, levels: Levels, params, kw: dict, layout: EngineLayout, *, n: int,
               num_paths: int, s0, sigma, mu: float, dt: float, lanes: int, noise,
               antithetic: bool, volume_model, symbols, ext_offset=0) -> np.ndarray:
    """The kernel's arguments for ``n`` rows (one configuration, a sweep's
    grid rows, the cells of a sweep of universes, a book's symbols) as one
    array of ``EngineArgs``, packed column by column: ``levels`` [L] (every
    row's) or [n, L]; the leaves of ``params`` and ``noise``, s0 and sigma
    (float64, for ``consts``) and ``ext_offset`` scalars or [n]; the ML, policy, touch, guard and volume
    records shared; row r keyed as universe symbol ``symbols[r]``.  Every
    float32 is computed as the plain version computes it (torch float32 on
    the CPU, or float64 rounded once).  The level slots (``level_table``)
    fill the struct's 8 where they fit; the envelope kernels read the
    table."""
    tp, gp, ml, pol = (kw["touch_params"], kw["guard_params"], kw["ml_model"],
                       kw["policy"])
    a = np.zeros(n, dtype=np.dtype(_EngineArgs))

    def col(x, dtype=np.float32):
        return np.broadcast_to(np.asarray(torch.as_tensor(x).detach().cpu().numpy(), dtype), (n,))

    table = level_table(levels, n)
    n_lv = table.shape[1]
    if n_lv <= MAX_LEVELS:
        for k in ("price", "round", "valid", "kind"):
            a["level_" + k][:, :n_lv] = table[k]
    a["has_levels"] = col(levels.count.cpu() > 0, bool)
    a["num_paths"], a["ext_offset"] = num_paths, ext_offset
    for field, value in knob_columns(params, noise).items():
        a[field] = col(value)
    prox = params.contact_prox.to(_F32)
    w_rules, w_ml = blend_weights(params)
    a["prox_conf"] = col(torch.clamp(prox, min=1e-4))
    a["qmin"], a["veto_strong"] = col(params.q_min_prob), col(params.veto_vol_strong)
    a["veto_near"] = col(torch.maximum(params.veto_prox.to(_F32), prox * 0.12))
    a["confl_within"] = col(params.confluence_within)
    a["w_rules"], a["w_ml"] = col(w_rules), col(w_ml)
    a["ml_coef"], a["ml_intercept"] = ml.coef.detach().cpu().numpy(), f32(ml.intercept)
    a["pol_w"] = pol.w_entry.detach().cpu().numpy()
    a["tm_tol_bps"], a["tm_min_px_bps"] = f32(tp.tol_bps), f32(tp.min_price_gap_bps)
    a["tm_decay"], a["tm_fat_vol_k"] = f32(tp.decay), f32(tp.fatigue_vol_k)
    a["g_comp"] = f32(gp.compression_bp.to(_F32) / 10000.0)
    a["g_vol_k"] = f32(gp.vol_k)
    s0, sigma = (np.broadcast_to(np.asarray(x, np.float64), (n,)).tolist() for x in (s0, sigma))
    derived = [consts(s0_r, mu, sg_r, dt) for s0_r, sg_r in zip(s0, sigma)]
    a["drift"], a["sig_dt"], a["log_s0"] = (np.asarray(c, np.float32) for c in zip(*derived))
    a["two_s2"] = [f32(2.0 * f32(sd * sd)) for _, sd, _ in derived]
    vc = _VolumeConsts(VolumeModel() if volume_model is None else volume_model)
    for k in ("base", "uamp", "sigma", "rc", "day", "open", "den", "third", "half_s2",
              "mean_abs", "sd_abs", "floor"):
        a["vm_" + k] = getattr(vc, k)
    a["seed"] = int(seed)
    a["stream"] = [prng.stream_key(ENGINE_STREAM, sym) for sym in symbols]
    a["cooldown_ms"] = col((params.cooldown_s.to(_F32) * 1000.0).to(torch.int32), np.int32)
    a["overtouch_limit"] = col(params.overtouch_limit, np.int32)
    a["enable_veto"], a["use_blend"] = col(params.enable_veto, bool), col(params.use_blend, bool)
    a["ml_usable"] = int(ml.usable)
    a["ml_ran"] = ~col(params.disable_ml_gate, bool)
    a["policy_on"], a["bar0_minute"] = int(not kw["policy_gate_disabled"]), kw["bar0_minute"]
    a["tm_min_gap_ms"], a["tm_max_bounces"] = int(tp.min_time_gap_ms), int(tp.max_bounces)
    a["tm_fat_win_ms"] = int(tp.fatigue_window_ms)
    a["g_min_bars"], a["g_clear_bars"] = int(gp.min_bars), int(gp.reenter_clear_bars)
    a["max_levels"], a["num_bars"], a["lanes"] = levels.max_levels, layout.num_bars, lanes
    a["u_rows"], a["stride"] = layout.u_rows, layout.stride
    a["use_noise"], a["antithetic"] = int(noise is not None), int(bool(antithetic))
    a["escalation"] = int(kw["escalation"])
    return a


def _launch(args, levels: Levels, num_bars: int, *, num_paths: int, ext_ptr,
            device: torch.device, per_path: bool, what: str, harvest: bool = False):
    """One launch of ``mc_engine_rows_kernel`` under gbm over the argument
    structs ``args`` (one per grid row) of ``levels`` ([L], or a row's [G,
    L]), counted in ``LAUNCHES[_rows(what)]`` (under ``_FORCE_PARENT`` of the
    parent it replaced, ``mc_engine_sweep_kernel``, counted in
    ``LAUNCHES[what]``), or where the parents do not take the shape
    (``_use_envelope``) of ``mc_engine_wide_kernel`` on the rows'
    ``level_table``, counted in ``LAUNCHES[_wide(what)]``, or with
    ``harvest`` of ``mc_engine_wide_harvest_kernel``, counted in
    ``LAUNCHES[_wide(what) + "_harvest"]``: int64 [G, grid, 151] and f32 [G,
    grid, 6] partial rows, one per (grid row, CTA), plus f32[G, P, PATH_COLS]
    per-(row, path) rows when ``per_path``, plus the harvest rows
    (``_harvest_rows``) with ``harvest``."""
    max_levels = levels.max_levels
    args_dev = device_rows(args, device)
    g, grid = len(args), grid_size(num_paths)
    part_counts = torch.empty((g, grid, ROW_COUNTS), dtype=torch.int64, device=device)
    part_floats = torch.empty((g, grid, ROW_FLOATS), dtype=_F32, device=device)
    path_rows = (torch.empty((g, num_paths, PATH_COLS), dtype=_F32, device=device)
                 if per_path else None)
    tail = (ext_ptr, part_counts.data_ptr(), part_floats.data_ptr(),
            path_rows.data_ptr() if per_path else None, grid,
            torch.cuda.current_stream(device).cuda_stream)
    hv = _harvest_rows(g, grid, device) if harvest else ()
    if harvest:
        what = _wide(what) + "_harvest"
        table = device_rows(level_table(levels, g), device)
        env, _keep = env_tail(max_levels, num_bars, device)
        rc = _wide_library("_wide_harvest").qmmx_mc_engine_wide_harvest(
            args_dev.data_ptr(), table.data_ptr(), g, max_levels, num_bars, *tail[:4],
            *(x.data_ptr() for x in hv), tail[4], *env, tail[5])
    elif _use_envelope(max_levels, num_bars):
        what = _wide(what)
        table = device_rows(level_table(levels, g), device)
        env, _keep = env_tail(max_levels, num_bars, device)
        rc = _wide_library("_wide").qmmx_mc_engine_wide_sweep(
            args_dev.data_ptr(), table.data_ptr(), g, max_levels, num_bars, *tail[:5], *env,
            tail[5])
    elif _FORCE_PARENT:
        rc = _library().qmmx_mc_engine_sweep(args_dev.data_ptr(), g, max_levels, num_bars,
                                             *tail)
    else:
        what = _rows(what)
        rc = _rows_library().qmmx_mc_engine_rows(args_dev.data_ptr(), None, g, _GBM_KIND,
                                                 max_levels, num_bars, *tail)
    _raise_on(rc, what)
    LAUNCHES[what] += 1
    return (part_counts, part_floats) + ((path_rows,) if per_path else ()) + hv


def engine_rows(seed, levels: Levels, params, *, policy=None, ml_model=None,
                touch_params=None, guard_params=None, policy_gate_disabled=None,
                escalation: bool = True, bar0_minute: int = 0, volume_model=None,
                noise=None, antithetic: bool = False, num_paths: int,
                num_bars: int = 40, s0: float = 100.0, mu: float = 0.0,
                sigma: float = 0.15, dt: float = 1.0 / (390.0 * 252.0),
                lanes: int = ENGINE_LANES, external_uniforms=None, device=None,
                per_path: bool = False, symbol: int = 0, sampler: str = "gbm",
                hist_bars=None, tables=None, block_len: int = 10, heston=None,
                harvest: bool = False):
    """Launch pass 1 on a CUDA device (``mc_engine_rows_kernel`` at one row,
    under gbm or the other samplers; the envelope kernels where the shape
    needs them, their harvest builds with ``harvest``; ``_launch``,
    ``_sampler_launch``): int64 [grid, 151] count rows and f32 [grid, 6] float rows,
    one row per CTA, plus the f32[P, PATH_COLS] per-path rows of
    ``path_rows`` when ``per_path``, plus int64 [grid, 72] and f32 [grid, 16]
    harvest rows with ``harvest``; Philox keyed as universe symbol
    ``symbol``; ``sampler`` and its inputs as in ``mc_paths_engine_fused``."""
    kw = engine_knobs(policy, ml_model, touch_params, guard_params,
                    policy_gate_disabled, escalation, bar0_minute)
    samp = make_sampler(sampler, hist_bars=hist_bars, tables=tables, block_len=block_len,
                        heston=heston, mu=mu, dt=dt)
    layout = _check(seed, levels, kw, num_paths=num_paths, num_bars=num_bars,
                    lanes=lanes, noise=noise, antithetic=antithetic,
                    external_uniforms=external_uniforms, sampler=samp)
    device = torch.device("cuda" if device is None else device)
    ext_ptr = launch_pointer(num_paths, num_bars, external_uniforms, device, "engine_rows")
    args = _pack_args(seed, levels, params, kw, layout, n=1, num_paths=num_paths, s0=s0,
                      sigma=sigma, mu=mu, dt=dt, lanes=lanes, noise=noise,
                      antithetic=antithetic, volume_model=volume_model, symbols=[symbol])
    if samp.kind != "gbm":
        out = _sampler_launch(args, levels, samp, num_bars, num_paths=num_paths,
                              ext_ptr=ext_ptr, device=device, per_path=per_path,
                              what="mc_engine_sampler", harvest=harvest)
    else:
        out = _launch(args, levels, num_bars, num_paths=num_paths, ext_ptr=ext_ptr,
                      device=device, per_path=per_path, what="mc_engine", harvest=harvest)
    return tuple(x[0] for x in out)


def _sampler_launch(args, levels: Levels, sampler: Sampler, num_bars: int, *,
                    num_paths: int, ext_ptr, device: torch.device, per_path: bool, what: str,
                    table_rows=None, harvest: bool = False):
    """One launch of ``mc_engine_rows_kernel`` under ``sampler`` over the
    argument structs ``args`` (one per row) of ``levels``, row r reading
    table ``table_rows[r]`` (default: the one history), counted in
    ``LAUNCHES[_rows(what)]`` (under ``_FORCE_PARENT`` of the parent it
    replaced, ``mc_engine_sampler_kernel``, counted in ``LAUNCHES[what]``),
    or where the parents do not take the shape of
    ``mc_engine_wide_sampler_kernel`` (``_use_envelope``), counted in
    ``LAUNCHES[_wide(what)]``, or with ``harvest`` of
    ``mc_engine_wide_sampler_harvest_kernel``, counted in
    ``LAUNCHES[_wide(what) + "_harvest"]``: int64 [R, grid, 151] and f32 [R,
    grid, 6] partial rows, plus f32[R, P, PATH_COLS] per-(row, path) rows when
    ``per_path``, plus the harvest rows with ``harvest``."""
    max_levels = levels.max_levels
    n, grid = len(args), grid_size(num_paths)
    args_dev = device_rows(args, device)
    samp_dev, _tables = sampler_args(sampler, device, [0] * n if table_rows is None
                                     else table_rows)
    part_counts = torch.empty((n, grid, ROW_COUNTS), dtype=torch.int64, device=device)
    part_floats = torch.empty((n, grid, ROW_FLOATS), dtype=_F32, device=device)
    path_rows = (torch.empty((n, num_paths, PATH_COLS), dtype=_F32, device=device)
                 if per_path else None)
    tail = (ext_ptr, part_counts.data_ptr(), part_floats.data_ptr(),
            path_rows.data_ptr() if per_path else None, grid,
            torch.cuda.current_stream(device).cuda_stream)
    hv = _harvest_rows(n, grid, device) if harvest else ()
    if harvest:
        what = _wide(what) + "_harvest"
        table = device_rows(level_table(levels, n), device)
        env, _keep = env_tail(max_levels, num_bars, device)
        rc = _wide_library("_wide_samplers_harvest").qmmx_mc_engine_wide_sampler_harvest(
            args_dev.data_ptr(), samp_dev.data_ptr(), table.data_ptr(), n,
            SAMPLER_KINDS[sampler.kind], max_levels, num_bars, *tail[:4],
            *(x.data_ptr() for x in hv), tail[4], *env, tail[5])
    elif _use_envelope(max_levels, num_bars):
        what = _wide(what)
        table = device_rows(level_table(levels, n), device)
        env, _keep = env_tail(max_levels, num_bars, device)
        rc = _wide_library("_wide_samplers").qmmx_mc_engine_wide_sampler(
            args_dev.data_ptr(), samp_dev.data_ptr(), table.data_ptr(), n,
            SAMPLER_KINDS[sampler.kind], max_levels, num_bars, *tail[:5], *env, tail[5])
    elif _FORCE_PARENT:
        rc = _sampler_library().qmmx_mc_engine_sampler(
            args_dev.data_ptr(), samp_dev.data_ptr(), n, SAMPLER_KINDS[sampler.kind],
            max_levels, num_bars, *tail)
    else:
        what = _rows(what)
        rc = _rows_library().qmmx_mc_engine_rows(
            args_dev.data_ptr(), samp_dev.data_ptr(), n, SAMPLER_KINDS[sampler.kind],
            max_levels, num_bars, *tail)
    _raise_on(rc, what)
    LAUNCHES[what] += 1
    return (part_counts, part_floats) + ((path_rows,) if per_path else ()) + hv


# The engine sweep (ops/csrc/mc_engine_bar_sweep.cu): each path's bars made
# once into a bar store of the resident CTAs, every grid row replayed over
# them.  Its store, shared memory and scratch come from the library
# (qmmx_engine_bar_sweep_plan).
BAR_SWEEP_SOURCE = "mc_engine_bar_sweep"
_GBM_KIND = 0                 # mc_engine_env.cuh's ENV_GBM
# the argument fields that make the bars: every row of a sweep shares them
_BAR_FIELDS = ("num_paths", "ext_offset", "drift", "sig_dt", "two_s2", "log_s0", "seed",
               "stream", "num_bars", "lanes", "u_rows", "stride", "use_noise", "antithetic",
               "max_levels") + tuple("vm_" + k for k in (
                   "base", "uamp", "sigma", "rc", "day", "open", "den", "third", "half_s2",
                   "mean_abs", "sd_abs", "floor"))


@dataclasses.dataclass(frozen=True)
class BarSweepPlan:
    """How ``engine_sweep_rows`` launches a grid: the kernel and its launch
    counter, the sampler kind it is built for and whether it takes the
    windowed guard."""
    kernel: str
    counter: str
    kind: int
    windowed: bool


def bar_sweep_plan(sampler: str, max_levels: int, num_bars: int, n_rows: int) -> BarSweepPlan:
    """The launch of a sweep of ``n_rows`` grid rows under ``sampler`` at
    ``max_levels`` slots and ``num_bars`` bars: ``mc_engine_bar_sweep_kernel``
    at every shape the engine takes (1-64 slots, any W >= 2; past 61 bars
    with the windowed guard), gbm counted as ``mc_engine_bar_sweep``, the
    samplers as ``mc_engine_bar_sweep_sampler``."""
    kind = _GBM_KIND if sampler == "gbm" else SAMPLER_KINDS[sampler]
    if not (1 <= max_levels <= MAX_ENGINE_LEVELS and num_bars >= 2 and n_rows >= 1):
        raise ValueError(f"no engine sweep at {max_levels} levels, {num_bars} bars, "
                         f"{n_rows} rows")
    gbm = kind == _GBM_KIND
    return BarSweepPlan(kernel="mc_engine_bar_sweep_kernel",
                        counter="mc_engine_bar_sweep" + ("" if gbm else "_sampler"), kind=kind,
                        windowed=num_bars > GUARD_WINDOW_BARS)


def _bar_sweep_library() -> ctypes.CDLL:
    """The engine sweep's library (``ops/csrc/mc_engine_bar_sweep.cu``),
    built at first use, with its C signatures set and its struct layouts
    checked against the host's; the engine library first (the fold is its)."""
    _library()
    lib = build.load(BAR_SWEEP_SOURCE)
    if id(lib) not in _BOUND:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.qmmx_engine_bar_sweep_size.argtypes = [ci]
        lib.qmmx_engine_bar_sweep_size.restype = ci
        lib.qmmx_engine_bar_sweep_plan.argtypes = [ci, ci, ci, ci, ci,
                                                   ctypes.POINTER(ctypes.c_longlong)]
        lib.qmmx_engine_bar_sweep_plan.restype = ci
        lib.qmmx_engine_bar_sweep_error_string.argtypes = [ci]
        lib.qmmx_engine_bar_sweep_error_string.restype = ctypes.c_char_p
        lib.qmmx_mc_engine_bar_sweep.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp, vp, vp, ci, ci,
                                                 vp, vp, vp, vp]
        lib.qmmx_mc_engine_bar_sweep.restype = ci
        want = [ctypes.sizeof(_EngineArgs), ctypes.sizeof(SamplerArgs), _WIDE_LEVEL.itemsize]
        if [lib.qmmx_engine_bar_sweep_size(i) for i in range(3)] != want:
            raise RuntimeError("the struct layouts differ between mc_engine_bar_sweep.cu "
                               "and cuda_engine.py")
        _BOUND.add(id(lib))
    return lib


def bar_sweep_launch_plan(kind: int, max_levels: int, num_bars: int, n_rows: int,
                          vgrid: int) -> dict:
    """The library's plan of a launch (``qmmx_engine_bar_sweep_plan``): the
    physical CTAs, the store's and the scratch's floats, a CTA's dynamic
    shared memory and the rows replayed over one making of the bars."""
    lib = _bar_sweep_library()
    out = (ctypes.c_longlong * 5)()
    rc = lib.qmmx_engine_bar_sweep_plan(kind, max_levels, num_bars, n_rows, vgrid, out)
    if rc != 0:
        msg = lib.qmmx_engine_bar_sweep_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"no engine sweep plan: CUDA error {rc} ({msg})")
    return dict(zip(("ctas", "store_floats", "scratch_floats", "smem_bytes", "rows_per_pass"),
                    out))


def _bar_sweep_launch(args, levels: Levels, sampler: Sampler, num_bars: int, *,
                      num_paths: int, ext_ptr, device: torch.device, per_path: bool):
    """One launch of ``mc_engine_bar_sweep_kernel`` for the grid rows
    ``args`` of ``levels`` under ``sampler`` (every row on the same draws
    and the one history: the bars' fields of ``args`` agree), counted in
    ``LAUNCHES[plan.counter]`` (``bar_sweep_plan``): each path's bars made
    once into a bar store of the resident CTAs, every row replayed over
    them; int64 [G, grid, 151] and f32 [G, grid, 6] partial rows, plus
    f32[G, P, PATH_COLS] per-(row, path) rows when ``per_path``, each row
    equal to the one-row launch (``engine_rows``) at its arguments."""
    for field in _BAR_FIELDS:
        if not (args[field] == args[field][:1]).all():
            raise ValueError(f"the sweep's rows must share the bars: {field} differs")
    max_levels = levels.max_levels
    n, grid = len(args), grid_size(num_paths)
    plan = bar_sweep_plan(sampler.kind, max_levels, num_bars, n)
    lib = _bar_sweep_library()
    launch = bar_sweep_launch_plan(plan.kind, max_levels, num_bars, n, grid)
    args_dev = device_rows(args, device)
    table = device_rows(level_table(levels, n), device)
    samp_dev, _tables = (sampler_args(sampler, device) if plan.kind != _GBM_KIND
                         else (None, None))
    store = torch.empty(launch["store_floats"], dtype=_F32, device=device)
    scratch = torch.empty(launch["scratch_floats"], dtype=_F32, device=device)
    part_counts = torch.empty((n, grid, ROW_COUNTS), dtype=torch.int64, device=device)
    part_floats = torch.empty((n, grid, ROW_FLOATS), dtype=_F32, device=device)
    path_rows = (torch.empty((n, num_paths, PATH_COLS), dtype=_F32, device=device)
                 if per_path else None)
    rc = lib.qmmx_mc_engine_bar_sweep(
        args_dev.data_ptr(), None if samp_dev is None else samp_dev.data_ptr(),
        table.data_ptr(), n, plan.kind, max_levels, num_bars, ext_ptr, store.data_ptr(),
        scratch.data_ptr(), launch["ctas"], grid, part_counts.data_ptr(),
        part_floats.data_ptr(), path_rows.data_ptr() if per_path else None,
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = lib.qmmx_engine_bar_sweep_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{plan.counter} launch failed: CUDA error {rc} ({msg})")
    LAUNCHES[plan.counter] += 1
    return (part_counts, part_floats) + ((path_rows,) if per_path else ())


def engine_sweep_rows(seed, levels: Levels, grid_params, *, n_grid=None, policy=None,
                      ml_model=None, touch_params=None, guard_params=None,
                      policy_gate_disabled=None, escalation: bool = True,
                      bar0_minute: int = 0, volume_model=None, noise=None,
                      num_paths: int, num_bars: int = 40, s0: float = 100.0,
                      mu: float = 0.0, sigma: float = 0.15,
                      dt: float = 1.0 / (390.0 * 252.0), lanes: int = ENGINE_LANES,
                      external_uniforms=None, device=None, per_path: bool = False,
                      sampler: str = "gbm", hist_bars=None, tables=None, block_len: int = 10,
                      heston=None):
    """Launch the sweep's pass 1 on a CUDA device, one launch of
    ``mc_engine_bar_sweep_kernel`` for the whole grid under every sampler and
    at every shape (``bar_sweep_plan``; each path's bars made once, every row
    on the same draws and history): int64 [G, grid, 151] and f32 [G, grid,
    6] partial rows, one per (grid row, CTA), plus f32[G, P, PATH_COLS]
    per-(row, path) rows when ``per_path``; row g equals ``engine_rows`` at
    row g's knobs bit for bit."""
    n_grid = len(knob_rows(grid_params, noise, n_grid))
    kw = engine_knobs(policy, ml_model, touch_params, guard_params,
                      policy_gate_disabled, escalation, bar0_minute)
    samp = make_sampler(sampler, hist_bars=hist_bars, tables=tables, block_len=block_len,
                        heston=heston, mu=mu, dt=dt)
    layout = _check(seed, levels, kw, num_paths=num_paths, num_bars=num_bars,
                    lanes=lanes, noise=noise, antithetic=False,
                    external_uniforms=external_uniforms, sampler=samp)
    device = torch.device("cuda" if device is None else device)
    ext_ptr = launch_pointer(num_paths, num_bars, external_uniforms, device,
                             "engine_sweep_rows")
    # one argument struct per row, the per-row derived values (cooldown ms,
    # blend weights, ...) computed on the [G] columns
    args = _pack_args(seed, levels, grid_params, kw, layout, n=n_grid, num_paths=num_paths,
                      s0=s0, sigma=sigma, mu=mu, dt=dt, lanes=lanes, noise=noise,
                      antithetic=False, volume_model=volume_model, symbols=[0] * n_grid)
    return _bar_sweep_launch(args, levels, samp, num_bars, num_paths=num_paths,
                             ext_ptr=ext_ptr, device=device, per_path=per_path)


def reduce_rows(part_counts: torch.Tensor, part_floats: torch.Tensor, what=None):
    """Pass 2: partial rows [R, ...] -> (int64 [151] counts, float64 [6]
    floats), or a sweep's (or universe's) [G, R, ...] -> ([G, 151], [G, 6])
    in one launch, one CTA per grid row, counted under ``what`` when given.
    CUDA tensors go through the kernel, CPU tensors through the plain
    version."""
    if part_counts.device.type == "cpu" and part_floats.device.type == "cpu":
        return reduce_rows_reference(part_counts, part_floats)
    return fold_rows(_library().qmmx_mc_engine_reduce_rows, _raise_on, part_counts,
                     part_floats, (ROW_COUNTS, ROW_FLOATS), "mc_engine", LAUNCHES, what)


def mc_paths_engine_fused(seed, levels: Levels, params, *, policy=None,
                          ml_model=None, touch_params=None, guard_params=None,
                          policy_gate_disabled=None, escalation: bool = True,
                          bar0_minute: int = 0, volume_model=None, noise=None,
                          antithetic: bool = False, num_paths: int,
                          num_bars: int = 40, s0: float = 100.0, mu: float = 0.0,
                          sigma: float = 0.15, dt: float = 1.0 / (390.0 * 252.0),
                          lanes: int = ENGINE_LANES, external_uniforms=None,
                          device=None, symbol: int = 0, sampler: str = "gbm",
                          hist_bars=None, tables=None, block_len: int = 10, heston=None,
                          harvest: bool = False):
    """Fused full-engine MC, the counterpart of ``mc_paths_pallas_engine``:
    returns (PathStats, int64[16] skip table ordered as
    ``sim.enginepath.SKIP_REASONS``, int64 escalations), the contract of
    ``sim.enginepath.mc_paths_engine``, with McNoise per-entry execution
    noise and antithetic lane pairs (gbm); ``symbol`` keys the draws as
    universe symbol ``symbol`` (0: the single run).  ``sampler``,
    ``hist_bars``, ``tables``, ``block_len`` and ``heston`` as in
    ``ops/cuda_mc.mc_paths_fused``: a recorded bar brings its recorded
    volume to the volume gates; injected uniforms then follow
    ``ops/draws.EngineLayout``'s layout for the sampler.  ``harvest=True``
    returns a 4-tuple ending in the ``models/harvest.EngineHarvest`` of the
    closed trades (the kernel: ``mc_engine_wide_harvest_kernel`` or its
    sampler form, at every shape).

    ``device`` (default: that of ``external_uniforms``, else the CUDA device,
    which raises where there is none) picks the path: a CUDA device launches
    the kernel or raises; the CPU runs the plain version.  Draws agree with
    ``sim.enginepath.mc_paths_engine`` statistically, not bitwise."""
    kw = dict(policy=policy, ml_model=ml_model, touch_params=touch_params,
              guard_params=guard_params, policy_gate_disabled=policy_gate_disabled,
              escalation=escalation, bar0_minute=bar0_minute,
              volume_model=volume_model, noise=noise, antithetic=antithetic,
              num_paths=num_paths, num_bars=num_bars, s0=s0, mu=mu, sigma=sigma,
              dt=dt, lanes=lanes, external_uniforms=external_uniforms, symbol=symbol,
              harvest=harvest)
    samp = make_sampler(sampler, hist_bars=hist_bars, tables=tables, block_len=block_len,
                        heston=heston, mu=mu, dt=dt)
    kw.update(sampler=sampler, tables=samp.tables, block_len=block_len, heston=heston)
    _check(seed, levels, engine_knobs(policy, ml_model, touch_params, guard_params,
                                    policy_gate_disabled, escalation, bar0_minute),
           num_paths=num_paths, num_bars=num_bars, lanes=lanes, noise=noise,
           antithetic=antithetic, external_uniforms=external_uniforms, sampler=samp)
    device = devices.resolve(device, external_uniforms)
    if device.type == "cpu":
        out = engine_totals_reference(seed, levels, params, device=device, **kw)
        stats = stats_from_engine_totals(*out[:2])
    else:
        out = engine_rows(seed, levels, params, device=device, **kw)
        stats = stats_from_engine_totals(*reduce_rows(*out[:2]))
        if harvest:
            out = (reduce_harvest(*out[2:]),)
    return stats + (out[-1],) if harvest else stats


def mc_paths_engine_sweep_fused(seed, levels: Levels, grid_params, *, n_grid=None,
                                policy=None, ml_model=None, touch_params=None,
                                guard_params=None, policy_gate_disabled=None,
                                noise=None, escalation: bool = True,
                                bar0_minute: int = 0, volume_model=None,
                                num_paths: int, num_bars: int = 40, s0: float = 100.0,
                                mu: float = 0.0, sigma: float = 0.15,
                                dt: float = 1.0 / (390.0 * 252.0),
                                lanes: int = ENGINE_LANES, external_uniforms=None,
                                device=None, sampler: str = "gbm", hist_bars=None,
                                tables=None, block_len: int = 10, heston=None):
    """Fused engine-knob grid sweep, the counterpart of
    ``mc_paths_pallas_engine_sweep``: ``grid_params`` (EngineParams
    whose leaves are [G] vectors or shared scalars) and ``noise`` (McNoise,
    scalar or [G] stds) give G rows, every row on the same uniforms (CRN).
    Returns ([G] PathStats, int64 [G, 16] skip tables, int64 [G]
    escalations); row g equals ``mc_paths_engine_fused`` under row g's knobs
    at the same seed, bit for bit.  ``sampler`` and its inputs as in
    ``mc_paths_engine_fused`` (every row on the same history, its recorded
    volumes into the volume gates; Heston at the caller's ``mu``).
    ``device`` as in ``mc_paths_engine_fused``."""
    samp = make_sampler(sampler, hist_bars=hist_bars, tables=tables, block_len=block_len,
                        heston=heston, mu=mu, dt=dt)
    kw = dict(n_grid=n_grid, policy=policy, ml_model=ml_model, touch_params=touch_params,
              guard_params=guard_params, policy_gate_disabled=policy_gate_disabled,
              escalation=escalation, bar0_minute=bar0_minute, volume_model=volume_model,
              noise=noise, num_paths=num_paths, num_bars=num_bars, s0=s0, mu=mu,
              sigma=sigma, dt=dt, lanes=lanes, external_uniforms=external_uniforms,
              sampler=sampler, tables=samp.tables, block_len=block_len, heston=heston)
    knob_rows(grid_params, noise, n_grid)
    _check(seed, levels, engine_knobs(policy, ml_model, touch_params, guard_params,
                                    policy_gate_disabled, escalation, bar0_minute),
           num_paths=num_paths, num_bars=num_bars, lanes=lanes, noise=noise,
           antithetic=False, external_uniforms=external_uniforms, sampler=samp)
    device = devices.resolve(device, external_uniforms)
    if device.type == "cpu":
        return stats_from_engine_totals(*engine_sweep_totals_reference(
            seed, levels, grid_params, device=device, **kw))
    rows = engine_sweep_rows(seed, levels, grid_params, device=device, **kw)
    return stats_from_engine_totals(*reduce_rows(*rows))


# --------------------------------------------------------------------------
# the universes (kernels #10 and #11): one row of mc_engine_rows_kernel per
# (symbol, grid row); the engine universe is the sweep of universes at one
# grid row
# --------------------------------------------------------------------------

def _universe_layout(seed, sym_levels: Levels, kw: dict, noise, n_sym: int, *,
                     paths_per_symbol: int, num_bars: int, lanes: int, external_uniforms,
                     sampler: str = "gbm", hist_bars=None, tables=None, block_len: int = 10,
                     heston=None, dt: float = 1.0 / (390.0 * 252.0)):
    """The checks of ``mc_paths_pallas_engine_universe(_sweep)``
    (pallas_engine.py:2248-2267, :2440-2457) and the single kernel's envelope,
    on one symbol's levels; injected uniforms f32[S, blocks, u_rows, 8, lanes].
    Returns the layout and the universe's ``Sampler``: each symbol's own
    recorded history (``hist_bars`` [S, H] o/h/l/c/v, or [S, 5, H]
    ``tables``), or Heston's constants at mu 0 (pallas_engine.py:2277)."""
    samp = make_sampler(sampler, hist_bars=hist_bars, tables=tables, block_len=block_len,
                        heston=heston, mu=0.0, dt=dt, symbols=n_sym)
    layout = _check(seed, sym_levels, kw, num_paths=paths_per_symbol, num_bars=num_bars,
                    lanes=lanes, noise=noise, antithetic=False, external_uniforms=None,
                    sampler=samp)
    check_uniforms(external_uniforms, (n_sym, paths_per_symbol // (ENGINE_SUB * lanes),
                                       layout.u_rows, ENGINE_SUB, lanes),
                   antithetic=False, lanes=lanes)
    return layout, samp


def _one_row(levels: Levels, s0, sigma, params, noise):
    """The engine universe's knobs as the sweep of universes takes them at
    one grid row: ``params`` and ``noise`` with their [S] leaves as [S, 1],
    after the universe's own checks (scalar or [S] leaves)."""
    symbol_rows(levels, s0, sigma, params, noise)

    def column(obj):
        if obj is None:
            return None
        leaves = tensor_leaves(obj)
        if any(v.dim() > 1 for v in leaves.values()):
            raise ValueError("per-symbol leaves must be scalars or [S]")
        return dataclasses.replace(obj, **{k: v[:, None] for k, v in leaves.items()
                                           if v.dim() == 1})

    return column(params), column(noise)


def engine_universe_sweep_totals_reference(seed, levels: Levels, grid_params, s0, sigma, *,
                                           n_grid=None, policy=None, ml_model=None,
                                           touch_params=None, guard_params=None,
                                           policy_gate_disabled=None,
                                           escalation: bool = True, bar0_minute: int = 0,
                                           volume_model=None, noise=None,
                                           paths_per_symbol: int, num_bars: int = 40,
                                           dt: float = 1.0 / (390.0 * 252.0),
                                           lanes: int = ENGINE_LANES,
                                           external_uniforms=None, device=None,
                                           chunk_blocks: int = 16, per_path: bool = False,
                                           sampler: str = "gbm", hist_bars=None, tables=None,
                                           block_len: int = 10, heston=None,
                                           harvest: bool = False):
    """The plain version of the sweep of universes: int64 [S, G, 151] counts
    and float64 [S, G, 6] floats, then f32[S, G, P, PATH_COLS] per-path rows
    with ``per_path``, then the [S, G] ``EngineHarvest`` with ``harvest``; symbol s by ``engine_sweep_totals_reference`` over its
    grid (the [S, G] leaves of ``grid_params`` and ``noise`` cut to row s)
    at its levels, s0, sigma, mu 0 and its uniforms or key, and its own
    history under the bootstrap samplers (``_universe_layout``)."""
    gates = dict(policy=policy, ml_model=ml_model, touch_params=touch_params,
                 guard_params=guard_params, policy_gate_disabled=policy_gate_disabled,
                 escalation=escalation, bar0_minute=bar0_minute)
    sym = symbol_rows(levels, s0, sigma)
    n_grid = len(sg_rows(grid_params, noise, len(sym), n_grid)[0])
    _, samp = _universe_layout(
        seed, sym[0][0], engine_knobs(**gates), noise, len(sym),
        paths_per_symbol=paths_per_symbol, num_bars=num_bars, lanes=lanes,
        external_uniforms=external_uniforms, sampler=sampler, hist_bars=hist_bars,
        tables=tables, block_len=block_len, heston=heston, dt=dt)
    device = devices.resolve(device, external_uniforms)
    out = [engine_sweep_totals_reference(
        seed, lv, symbol_grid(grid_params, s), n_grid=n_grid, noise=symbol_grid(noise, s),
        volume_model=volume_model, num_paths=paths_per_symbol, num_bars=num_bars,
        s0=s0_s, mu=0.0, sigma=sg_s, dt=dt, lanes=lanes, symbol=s,
        external_uniforms=symbol_uniforms(external_uniforms, s), device=device,
        chunk_blocks=chunk_blocks, per_path=per_path, sampler=sampler,
        tables=samp.row(s).tables, block_len=block_len, heston=heston, harvest=harvest,
        **gates)
        for s, (lv, s0_s, sg_s) in enumerate(sym)]
    return tuple(HV.stack(x) if isinstance(x[0], HV.EngineHarvest) else torch.stack(x)
                 for x in zip(*out))


def engine_universe_sweep_rows(seed, levels: Levels, grid_params, s0, sigma, *,
                               n_grid=None, policy=None, ml_model=None, touch_params=None,
                               guard_params=None, policy_gate_disabled=None,
                               escalation: bool = True, bar0_minute: int = 0,
                               volume_model=None, noise=None, paths_per_symbol: int,
                               num_bars: int = 40, dt: float = 1.0 / (390.0 * 252.0),
                               lanes: int = ENGINE_LANES, external_uniforms=None,
                               device=None, per_path: bool = False,
                               what: str = "mc_engine_universe_sweep", sampler: str = "gbm",
                               hist_bars=None, tables=None, block_len: int = 10,
                               heston=None, harvest: bool = False):
    """Launch the sweep of universes' pass 1 on a CUDA device, one launch of
    ``mc_engine_rows_kernel`` (``_launch``, ``_sampler_launch``; under the
    other samplers counted in ``LAUNCHES[_rows(what) + "_sampler"]``, cell
    (s, g) reading symbol s's history) with S x G rows (row s * G + g for (s,
    g)), under gbm counted in ``LAUNCHES[_rows(what)]``: int64 [S, G, grid,
    151] and f32 [S, G, grid, 6] partial rows, plus f32[S, G, P, PATH_COLS]
    per-path rows when ``per_path``, plus int64 [S, G, grid, 72] and f32 [S,
    G, grid, 16] harvest rows with ``harvest`` (the harvest builds of the
    envelope kernels, counted under ``_wide(...) + "_harvest"``)."""
    kw = engine_knobs(policy, ml_model, touch_params, guard_params,
                      policy_gate_disabled, escalation, bar0_minute)
    sym = symbol_rows(levels, s0, sigma)
    grid = sg_rows(grid_params, noise, len(sym), n_grid)
    layout, samp = _universe_layout(
        seed, sym[0][0], kw, noise, len(sym), paths_per_symbol=paths_per_symbol,
        num_bars=num_bars, lanes=lanes, external_uniforms=external_uniforms, sampler=sampler,
        hist_bars=hist_bars, tables=tables, block_len=block_len, heston=heston, dt=dt)
    device = torch.device("cuda" if device is None else device)
    ext_ptr = launch_pointer(paths_per_symbol, num_bars, external_uniforms, device, what)
    n_sym, n_grid = len(sym), len(grid[0])
    cell_sym = np.repeat(np.arange(n_sym), n_grid)          # cell (s, g) at s * G + g
    cell_levels = repeat_rows(levels, n_grid)
    args = _pack_args(seed, cell_levels, sg_columns(grid_params, n_sym, n_grid),
                      kw, layout, n=n_sym * n_grid, num_paths=paths_per_symbol,
                      s0=[sym[s][1] for s in cell_sym], sigma=[sym[s][2] for s in cell_sym],
                      mu=0.0, dt=dt, lanes=lanes, noise=sg_columns(noise, n_sym, n_grid),
                      antithetic=False, volume_model=volume_model, symbols=cell_sym.tolist(),
                      ext_offset=cell_sym * paths_per_symbol * layout.u_rows)
    if samp.kind != "gbm":
        out = _sampler_launch(args, cell_levels, samp, num_bars,
                              num_paths=paths_per_symbol, ext_ptr=ext_ptr, device=device,
                              per_path=per_path, what=what + "_sampler",
                              table_rows=np.asarray(samp.table_rows(n_sym))[cell_sym],
                              harvest=harvest)
    else:
        out = _launch(args, cell_levels, num_bars, num_paths=paths_per_symbol,
                      ext_ptr=ext_ptr, device=device, per_path=per_path, what=what,
                      harvest=harvest)
    return tuple(x.view(n_sym, n_grid, *x.shape[1:]) for x in out)


def _universe_sweep_totals(seed, levels: Levels, grid_params, s0, sigma, *, device,
                           what: str, **kw):
    """(int64 [S, G, 151], float64 [S, G, 6]) of the sweep of universes on
    the resolved ``device``, then the [S, G] ``EngineHarvest`` with
    ``harvest``: the plain version on the CPU, else one launch and one fold
    (and the harvest rows' fold), counted under ``what`` and ``what +
    "_reduce_rows"``."""
    device = devices.resolve(device, kw.get("external_uniforms"))
    if device.type == "cpu":
        return engine_universe_sweep_totals_reference(seed, levels, grid_params, s0, sigma,
                                                      device=device, **kw)
    pc, pf, *hv = engine_universe_sweep_rows(seed, levels, grid_params, s0, sigma,
                                             device=device, what=what, **kw)
    c, f = reduce_rows(pc.flatten(0, 1), pf.flatten(0, 1), what=what + "_reduce_rows")
    out = (c.view(*pc.shape[:2], -1), f.view(*pf.shape[:2], -1))
    return out + (reduce_harvest(*hv),) if hv else out


def engine_universe_totals_reference(seed, levels: Levels, params, s0, sigma, *,
                                     noise=None, harvest: bool = False, **kw):
    """The plain version of the engine universe: int64 [S, 151] counts and
    float64 [S, 6] floats, then f32[S, P, PATH_COLS] per-(symbol, path) rows
    with ``per_path``; the sweep of universes' plain version at one grid row
    (symbol s by ``engine_totals_reference`` at its levels, s0, sigma, knobs
    and noise stds, mu 0, its uniforms ``external_uniforms[s]`` or its key),
    then the [S] ``EngineHarvest`` with ``harvest``.  Keywords as in
    ``engine_universe_sweep_totals_reference``."""
    grid, g_noise = _one_row(levels, s0, sigma, params, noise)
    out = engine_universe_sweep_totals_reference(seed, levels, grid, s0, sigma, n_grid=1,
                                                 noise=g_noise, harvest=harvest, **kw)
    return tuple(_row0(x) for x in out)


def _row0(x):
    """Grid row 0 of an [S, G, ...] tensor or ``EngineHarvest``."""
    return HV.EngineHarvest(*(f[:, 0] for f in x)) if isinstance(x, HV.EngineHarvest) \
        else x[:, 0]


def engine_universe_rows(seed, levels: Levels, params, s0, sigma, *, noise=None,
                         harvest: bool = False, **kw):
    """Launch the universe's pass 1 on a CUDA device: the sweep of
    universes' launch at one grid row, counted in
    ``LAUNCHES["mc_engine_rows_universe"]`` (with ``harvest``: its harvest build,
    ``mc_engine_wide_universe_harvest``): int64 [S, grid, 151] and f32 [S,
    grid, 6] partial rows, plus f32[S, P, PATH_COLS] per-(symbol, path) rows
    with ``per_path``, plus int64 [S, grid, 72] and f32 [S, grid, 16] harvest
    rows with ``harvest``.  Keywords as in ``engine_universe_sweep_rows``."""
    grid, g_noise = _one_row(levels, s0, sigma, params, noise)
    out = engine_universe_sweep_rows(seed, levels, grid, s0, sigma, n_grid=1, noise=g_noise,
                                     what="mc_engine_universe", harvest=harvest, **kw)
    return tuple(x[:, 0] for x in out)


def mc_paths_engine_universe_fused(seed, levels: Levels, params, s0, sigma, *,
                                   policy=None, ml_model=None, touch_params=None,
                                   guard_params=None, policy_gate_disabled=None,
                                   escalation: bool = True, bar0_minute: int = 0,
                                   volume_model=None, noise=None, harvest: bool = False,
                                   paths_per_symbol: int, num_bars: int = 40,
                                   dt: float = 1.0 / (390.0 * 252.0),
                                   lanes: int = ENGINE_LANES, external_uniforms=None,
                                   device=None, sampler: str = "gbm", hist_bars=None,
                                   tables=None, block_len: int = 10, heston=None):
    """Fused per-symbol full-engine universe, the counterpart of
    ``mc_paths_pallas_engine_universe``: ([S] PathStats, int64 [S, 16] skip
    tables, int64 [S] escalations[, the [S] EngineHarvest with ``harvest``]),
    symbol s under its own
    [S, L] levels row, s0[s], sigma[s], all engine knobs (``params`` leaves
    scalar or [S]), noise stds (``noise`` leaves scalar or [S]) and key, the
    ML, policy, touch and guard records shared; drift, sig_dt and log_s0 per
    symbol in float64 on the host, mu 0.  ``sampler``, ``hist_bars`` ([S, H]
    o/h/l/c/v), ``tables`` ([S, 5, H]), ``block_len`` and ``heston`` as in
    ``ops/cuda_mc.mc_paths_universe_fused``: each symbol resamples its own
    history, its recorded volumes into the volume gates.  It runs as the
    sweep of universes at one grid row.  Row s equals
    ``mc_paths_engine_fused`` at those inputs with ``symbol=s`` bit for bit;
    injected uniforms are f32[S, blocks, u_rows, 8, lanes].  ``device`` as in
    ``mc_paths_engine_fused``."""
    grid, g_noise = _one_row(levels, s0, sigma, params, noise)
    out = _universe_sweep_totals(
        seed, levels, grid, s0, sigma, n_grid=1, policy=policy, ml_model=ml_model,
        touch_params=touch_params, guard_params=guard_params,
        policy_gate_disabled=policy_gate_disabled, escalation=escalation,
        bar0_minute=bar0_minute, volume_model=volume_model, noise=g_noise,
        paths_per_symbol=paths_per_symbol, num_bars=num_bars, dt=dt, lanes=lanes,
        external_uniforms=external_uniforms, device=device, what="mc_engine_universe",
        sampler=sampler, hist_bars=hist_bars, tables=tables, block_len=block_len,
        heston=heston, harvest=harvest)
    stats = stats_from_engine_totals(out[0][:, 0], out[1][:, 0])
    return stats + (_row0(out[2]),) if harvest else stats


def mc_paths_engine_universe_sweep_fused(seed, levels: Levels, grid_params, s0, sigma, *,
                                         n_grid=None, policy=None, ml_model=None,
                                         touch_params=None, guard_params=None,
                                         policy_gate_disabled=None, escalation: bool = True,
                                         bar0_minute: int = 0, volume_model=None,
                                         noise=None, paths_per_symbol: int,
                                         num_bars: int = 40,
                                         dt: float = 1.0 / (390.0 * 252.0),
                                         lanes: int = ENGINE_LANES, external_uniforms=None,
                                         device=None, sampler: str = "gbm", hist_bars=None,
                                         tables=None, block_len: int = 10, heston=None):
    """Fused sweep of universes, the counterpart of
    ``mc_paths_pallas_engine_universe_sweep``: ([S, G] PathStats,
    int64 [S, G, 16] skip tables, int64 [S, G] escalations), cell (s, g)
    under symbol s's levels, s0, sigma and key and row g of its knob grid
    (``grid_params`` and ``noise`` leaves scalar, [G] or [S, G]), every row
    of a symbol on the same draws (CRN within a symbol) and, under the
    bootstrap samplers, on the symbol's own history (``sampler`` and its
    inputs as in ``mc_paths_engine_universe_fused``).  Cell (s, g) equals
    ``mc_paths_engine_universe_fused`` at symbol s under row g's knobs, bit
    for bit.  ``device`` as in ``mc_paths_engine_fused``."""
    return stats_from_engine_totals(*_universe_sweep_totals(
        seed, levels, grid_params, s0, sigma, n_grid=n_grid, policy=policy,
        ml_model=ml_model, touch_params=touch_params, guard_params=guard_params,
        policy_gate_disabled=policy_gate_disabled, escalation=escalation,
        bar0_minute=bar0_minute, volume_model=volume_model, noise=noise,
        paths_per_symbol=paths_per_symbol, num_bars=num_bars, dt=dt, lanes=lanes,
        external_uniforms=external_uniforms, device=device,
        what="mc_engine_universe_sweep", sampler=sampler, hist_bars=hist_bars, tables=tables,
        block_len=block_len, heston=heston))


# --------------------------------------------------------------------------
# the correlated book (kernel #12)
# --------------------------------------------------------------------------

def _check_corr(seed, levels: Levels, params, s0, sigma, beta, weights, kw: dict, noise, *,
                paths_per_symbol: int, num_bars: int, lanes: int, antithetic: bool,
                external_uniforms, market_uniforms, sampler: str,
                hist_bars=None, tables=None, block_len: int = 10, heston=None,
                dt: float = 1.0 / (390.0 * 252.0)):
    """The checks of ``mc_paths_pallas_engine_corr`` (pallas_engine.py:
    3058-3087) and the kernel's envelope (<= 8 levels, an even horizon of at
    most 61 bars); returns (layout, market layout, ``symbol_columns``, the
    book's ``Sampler`` as ``ops/cuda_gated._check_corr``'s, Heston at mu 0,
    pallas_engine.py:3100)."""
    cols = symbol_columns(levels, s0, sigma, params, noise, beta=beta, weights=weights)
    n_sym, n_blocks = len(cols["s0"]), paths_per_symbol // (ENGINE_SUB * lanes)
    samp = make_sampler(sampler, hist_bars=hist_bars, tables=tables, block_len=block_len,
                        heston=heston, mu=0.0, dt=dt, symbols=n_sym, shared=True)
    layout = _check(seed, grid_row(levels, 0), kw, num_paths=paths_per_symbol,
                    num_bars=num_bars, lanes=lanes, noise=noise, antithetic=antithetic,
                    external_uniforms=None, sampler=samp, book=True)
    if (external_uniforms is None) != (market_uniforms is None):
        raise ValueError("external_uniforms and market_uniforms go together")
    mlayout = MarketLayout(num_bars, samp.kind)
    check_uniforms(external_uniforms, (n_sym, n_blocks, layout.u_rows, ENGINE_SUB, lanes),
                   antithetic=antithetic, lanes=lanes)
    check_uniforms(market_uniforms, (n_blocks, mlayout.u_rows, ENGINE_SUB, lanes),
                   antithetic=antithetic, lanes=lanes)
    return layout, mlayout, cols, samp


def engine_corr_totals_reference(seed, levels: Levels, params, s0, sigma, beta, weights, *,
                                 policy=None, ml_model=None, touch_params=None,
                                 guard_params=None, policy_gate_disabled=None,
                                 escalation: bool = True, bar0_minute: int = 0,
                                 volume_model=None, noise=None, harvest: bool = False,
                                 antithetic: bool = False, paths_per_symbol: int,
                                 num_bars: int = 40, dt: float = 1.0 / (390.0 * 252.0),
                                 lanes: int = ENGINE_LANES, external_uniforms=None,
                                 market_uniforms=None, sampler: str = "gbm", hist_bars=None,
                                 tables=None, block_len: int = 10, heston=None, device=None,
                                 chunk_blocks: int = 16, per_path: bool = False):
    """The plain version of the engine book: int64 [S + 1, 151] counts and
    float64 [S + 1, 6] floats (row s symbol s's, row S the book's, whose
    escalation and skip columns are zero), then f32[S + 1, P, PATH_COLS]
    per-path rows with ``per_path``, then the symbols' [S] ``EngineHarvest``
    with ``harvest``.  Symbol s runs as the engine
    universe's symbol s, its price normal mixed with the market's
    (``sim/book.mix_shocks``) before the volume model sees it, and adds its
    weighted post-bar equity into the book's curve (``sim/book.BookCurve``);
    under the other samplers as ``ops/cuda_gated.gated_corr_totals_reference``
    (a recorded bar brings its recorded volume).  ``sampler`` and its inputs
    as in ``mc_paths_engine_corr_fused``."""
    kw = engine_knobs(policy, ml_model, touch_params, guard_params,
                      policy_gate_disabled, escalation, bar0_minute)
    layout, mlayout, _, samp = _check_corr(
        seed, levels, params, s0, sigma, beta, weights, kw, noise,
        paths_per_symbol=paths_per_symbol, num_bars=num_bars, lanes=lanes,
        antithetic=antithetic, external_uniforms=external_uniforms,
        market_uniforms=market_uniforms, sampler=sampler,
        hist_bars=hist_bars, tables=tables, block_len=block_len, heston=heston, dt=dt)
    rows = symbol_rows(levels, s0, sigma, params, noise, beta=beta, weights=weights)
    device = devices.resolve(device, external_uniforms)
    vc = _VolumeConsts(VolumeModel() if volume_model is None else volume_model)
    n_blocks = paths_per_symbol // (ENGINE_SUB * lanes)
    n_sym = len(rows)
    tot, path_rows_ = [None] * (n_sym + 1), [[] for _ in range(n_sym + 1)]
    hvs = [HV.EngineHarvest.zero(device=device) for _ in range(n_sym)]
    for b0 in range(0, n_blocks, chunk_blocks):
        nb = min(chunk_blocks, n_blocks - b0)
        um = (market_uniforms[b0:b0 + nb] if market_uniforms is not None else
              draws_market(seed, mlayout, block0=b0, n_blocks=nb, lanes=lanes, device=device))
        mk = book_market(um, antithetic, samp)
        book = BookCurve(nb * ENGINE_SUB * lanes, num_bars, device=device)
        for s, (lv, s0_s, sg_s, p, nz, beta_s, w_s) in enumerate(rows):
            if external_uniforms is not None:
                u = external_uniforms[s, b0:b0 + nb]
            else:
                u = engine_uniforms(seed, layout, block0=b0, n_blocks=nb, lanes=lanes,
                                    symbol=s, device=device)
            *part, part_rows, part_hv = _chunk_engine(
                u, layout, lv.to(device), p, kw, nz, consts(s0_s, 0.0, sg_s, dt), vc,
                antithetic, per_path, market=(mk, beta_s), book=book, weight=w_s,
                sampler=samp.row(s), harvest=harvest)
            tot[s] = merge_totals(tot[s], part)
            if per_path:
                path_rows_[s].append(part_rows)
            if harvest:
                hvs[s] = hvs[s].merge(part_hv)
        out = book.outcome()
        tot[n_sym] = merge_totals(tot[n_sym], lifecycle_totals(out, N_COUNTS + N_SKIPS))
        if per_path:   # the book's escalation and skip columns are zero
            path_rows_[n_sym].append(torch.cat([lifecycle_rows(out), torch.zeros(
                (out.equity.shape[0], PATH_COLS - 6), dtype=_F32, device=device)], dim=1))
    res = (torch.stack([t[0] for t in tot]), torch.stack([t[1] for t in tot]))
    if per_path:
        res += (torch.stack([torch.cat(r) for r in path_rows_]),)
    return res + (HV.stack(hvs),) if harvest else res


def engine_corr_rows(seed, levels: Levels, params, s0, sigma, beta, weights, *, policy=None,
                     ml_model=None, touch_params=None, guard_params=None,
                     policy_gate_disabled=None, escalation: bool = True,
                     bar0_minute: int = 0, volume_model=None, noise=None,
                     harvest: bool = False, antithetic: bool = False,
                     paths_per_symbol: int, num_bars: int = 40,
                     dt: float = 1.0 / (390.0 * 252.0), lanes: int = ENGINE_LANES,
                     external_uniforms=None, market_uniforms=None, sampler: str = "gbm",
                     hist_bars=None, tables=None, block_len: int = 10, heston=None,
                     device=None, per_path: bool = False):
    """Launch the engine book's pass 1 on a CUDA device, one launch of
    ``mc_engine_book_rows_kernel`` under gbm or the other samplers (symbol s
    reading its own history or the one every symbol shares), counted under
    ``mc_engine_rows_corr(_sampler)``, with the scratch the library sizes
    (the curves and market draws of its resident threads; under
    ``_FORCE_PARENT`` the parent it replaced, ``mc_engine_corr_kernel`` or
    ``mc_engine_corr_sampler_kernel``, counted under
    ``mc_engine_corr(_sampler)``, the curves in a [W, grid x 256] buffer);
    where the parents do not take the shape, ``mc_engine_wide_corr_kernel``,
    counted under ``mc_engine_wide_corr(_sampler)``: int64 [S + 1, grid, 151]
    and f32 [S + 1, grid, 6] partial rows (the symbols', then the book's), plus
    f32[S + 1, P, PATH_COLS] per-path rows when ``per_path``, plus the
    symbols' int64 [S, grid, 72] and f32 [S, grid, 16] harvest rows with
    ``harvest`` (the harvest builds ``mc_engine_wide_corr_harvest_kernel``, at
    every shape, counted under ``mc_engine_wide_corr(_sampler)_harvest``; with
    ``env_tail``'s scratch)."""
    kw = engine_knobs(policy, ml_model, touch_params, guard_params,
                      policy_gate_disabled, escalation, bar0_minute)
    layout, _, cols, samp = _check_corr(
        seed, levels, params, s0, sigma, beta, weights, kw, noise,
        paths_per_symbol=paths_per_symbol, num_bars=num_bars, lanes=lanes,
        antithetic=antithetic, external_uniforms=external_uniforms,
        market_uniforms=market_uniforms, sampler=sampler,
        hist_bars=hist_bars, tables=tables, block_len=block_len, heston=heston, dt=dt)
    device = torch.device("cuda" if device is None else device)
    ext_ptr = launch_pointer(paths_per_symbol, num_bars, external_uniforms, device,
                             "engine_corr_rows")
    m_ptr = launch_pointer(paths_per_symbol, num_bars, market_uniforms, device,
                           "engine_corr_rows")
    n_sym, grid = len(cols["s0"]), grid_size(paths_per_symbol)
    args = _pack_args(
        seed, levels, params, kw, layout, n=n_sym, num_paths=paths_per_symbol, s0=cols["s0"],
        sigma=cols["sigma"], mu=0.0, dt=dt, lanes=lanes, noise=noise, antithetic=antithetic,
        volume_model=volume_model, symbols=range(n_sym),
        ext_offset=np.arange(n_sym) * paths_per_symbol * layout.u_rows)
    args_dev = device_rows(args, device)
    part_counts = torch.empty((n_sym + 1, grid, ROW_COUNTS), dtype=torch.int64, device=device)
    part_floats = torch.empty((n_sym + 1, grid, ROW_FLOATS), dtype=_F32, device=device)
    path_rows_ = (torch.empty((n_sym + 1, paths_per_symbol, PATH_COLS), dtype=_F32,
                              device=device) if per_path else None)
    bw = book_pairs(cols, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    m_stream = prng.stream_key(MARKET_STREAM, 0)
    path_ptr = path_rows_.data_ptr() if per_path else None
    wide = _use_envelope(levels.max_levels, num_bars, harvest)
    gbm = samp.kind == "gbm"
    if not gbm:
        samp_dev, _tables = sampler_args(samp, device, samp.table_rows(n_sym))
    if not (wide or _FORCE_PARENT):
        what = _rows("mc_engine_corr" + ("" if gbm else "_sampler"))
        lib = _book_rows_library()
        ctas = min(grid, torch.cuda.get_device_properties(device).multi_processor_count)
        scratch = torch.empty(lib.qmmx_engine_book_rows_scratch(num_bars) * ctas * BLOCK,
                              dtype=_F32, device=device)
        rc = lib.qmmx_mc_engine_book_rows(
            args_dev.data_ptr(), None if gbm else samp_dev.data_ptr(), bw.data_ptr(), n_sym,
            _GBM_KIND if gbm else SAMPLER_KINDS[samp.kind], levels.max_levels, num_bars,
            ext_ptr, m_ptr, m_stream, scratch.data_ptr(), ctas, part_counts.data_ptr(),
            part_floats.data_ptr(), path_ptr, grid, stream)
        _raise_on(rc, what)
        LAUNCHES[what] += 1
        return (part_counts, part_floats) + ((path_rows_,) if per_path else ())
    curve_mem = torch.empty((num_bars, grid * BLOCK), dtype=_F32, device=device)
    hv = _harvest_rows(n_sym, grid, device) if harvest else ()
    head = (m_stream, curve_mem.data_ptr(), part_counts.data_ptr(), part_floats.data_ptr(),
            path_ptr, *(x.data_ptr() for x in hv), grid)
    if wide:
        lv_dev = device_rows(level_table(levels, n_sym), device)
        env, _keep = env_tail(levels.max_levels, num_bars, device)
        tail = head + env + (stream,)
    else:
        tail = head + (stream,)
    if not gbm:
        what = "mc_engine_corr_sampler"
        kind = SAMPLER_KINDS[samp.kind]
        if harvest:
            what = _wide(what) + "_harvest"
            lib = _wide_library("_wide_corr_samplers_harvest")
            rc = lib.qmmx_mc_engine_wide_corr_sampler_harvest(
                args_dev.data_ptr(), samp_dev.data_ptr(), lv_dev.data_ptr(), bw.data_ptr(),
                n_sym, kind, levels.max_levels, num_bars, ext_ptr, m_ptr, *tail)
        elif wide:
            what = _wide(what)
            rc = _wide_library("_wide_corr_samplers").qmmx_mc_engine_wide_corr_sampler(
                args_dev.data_ptr(), samp_dev.data_ptr(), lv_dev.data_ptr(), bw.data_ptr(),
                n_sym, kind, levels.max_levels, num_bars, ext_ptr, m_ptr, *tail)
        else:
            rc = _corr_sampler_library().qmmx_mc_engine_corr_sampler(
                args_dev.data_ptr(), samp_dev.data_ptr(), bw.data_ptr(), n_sym, kind,
                levels.max_levels, num_bars, ext_ptr, m_ptr, *tail)
    elif harvest:
        what = _wide("mc_engine_corr") + "_harvest"
        rc = _wide_library("_wide_corr_harvest").qmmx_mc_engine_wide_corr_harvest(
            args_dev.data_ptr(), lv_dev.data_ptr(), bw.data_ptr(), n_sym, levels.max_levels,
            num_bars, ext_ptr, m_ptr, *tail)
    elif wide:
        what = _wide("mc_engine_corr")
        rc = _wide_library("_wide_corr").qmmx_mc_engine_wide_corr(
            args_dev.data_ptr(), lv_dev.data_ptr(), bw.data_ptr(), n_sym, levels.max_levels,
            num_bars, ext_ptr, m_ptr, *tail)
    else:
        what = "mc_engine_corr"
        rc = _corr_library().qmmx_mc_engine_corr(
            args_dev.data_ptr(), bw.data_ptr(), n_sym, levels.max_levels, num_bars, ext_ptr,
            m_ptr, *tail)
    _raise_on(rc, what)
    LAUNCHES[what] += 1
    return (part_counts, part_floats) + ((path_rows_,) if per_path else ()) + hv


def mc_paths_engine_corr_fused(seed, levels: Levels, params, s0, sigma, beta, weights, *,
                               policy=None, ml_model=None, touch_params=None,
                               guard_params=None, policy_gate_disabled=None,
                               escalation: bool = True, bar0_minute: int = 0,
                               volume_model=None, noise=None, harvest: bool = False,
                               antithetic: bool = False, paths_per_symbol: int,
                               num_bars: int = 40, dt: float = 1.0 / (390.0 * 252.0),
                               lanes: int = ENGINE_LANES, external_uniforms=None,
                               market_uniforms=None, sampler: str = "gbm", hist_bars=None,
                               tables=None, block_len: int = 10, heston=None, device=None):
    """Fused correlated full-engine book, the counterpart of
    ``mc_paths_pallas_engine_corr``: ([S] PathStats, the book's PathStats,
    int64 [S, 16] skip tables, int64 [S] escalations[, the symbols' [S]
    ``EngineHarvest`` with ``harvest``]) from one launch, in
    ``portfolio_mc_engine``'s order.  Symbol s runs the full
    engine under its own [S, L] levels row, s0[s], sigma[s], all engine
    knobs (``params`` leaves scalar or [S]), noise stds (``noise`` leaves
    scalar or [S]) and key, the ML, policy, touch and guard records shared;
    its normal is ``beta[s] * z_mkt + sqrt(1 - beta[s]^2) * eps`` with the
    market normal shared by every symbol, and the mixed shock also drives its
    volume; the book sums the symbols' post-bar equity curves times
    ``weights`` per path.  With beta = 0, symbol s equals
    ``mc_paths_engine_universe_fused``'s symbol s (on the card: per path and
    in its counts; in its float sums too up to 2^20 paths a symbol).
    ``sampler``, ``hist_bars``, ``tables``, ``block_len`` and ``heston`` as
    in ``ops/cuda_gated.mc_paths_gated_corr_fused`` (joint recorded days,
    each symbol's recorded volumes into its volume gates; Heston's variance
    shock mixed with the market's, its volume from the volume model on the
    mixed price shock).  Injected uniforms are f32[S, blocks, u_rows, 8,
    lanes] (``ops/draws.EngineLayout`` in its book form) with the market's
    f32[blocks, u_rows, 8, lanes].  ``device`` as in
    ``mc_paths_engine_fused``."""
    kw = dict(policy=policy, ml_model=ml_model, touch_params=touch_params,
              guard_params=guard_params, policy_gate_disabled=policy_gate_disabled,
              escalation=escalation, bar0_minute=bar0_minute, volume_model=volume_model,
              noise=noise, harvest=harvest, antithetic=antithetic,
              paths_per_symbol=paths_per_symbol, num_bars=num_bars, dt=dt, lanes=lanes,
              external_uniforms=external_uniforms, market_uniforms=market_uniforms,
              sampler=sampler, block_len=block_len, heston=heston)
    *_, samp = _check_corr(seed, levels, params, s0, sigma, beta, weights,
                           engine_knobs(policy, ml_model, touch_params, guard_params,
                                        policy_gate_disabled, escalation, bar0_minute), noise,
                           paths_per_symbol=paths_per_symbol, num_bars=num_bars, lanes=lanes,
                           antithetic=antithetic, external_uniforms=external_uniforms,
                           market_uniforms=market_uniforms, sampler=sampler,
                           hist_bars=hist_bars, tables=tables, block_len=block_len,
                           heston=heston, dt=dt)
    kw["tables"] = samp.tables
    device = devices.resolve(device, external_uniforms)
    if device.type == "cpu":
        c, f, *hv = engine_corr_totals_reference(seed, levels, params, s0, sigma, beta,
                                                 weights, device=device, **kw)
    else:
        pc, pf, *rows = engine_corr_rows(seed, levels, params, s0, sigma, beta, weights,
                                         device=device, **kw)
        c, f = reduce_rows(pc, pf, what="mc_engine_corr_reduce_rows")
        hv = [reduce_harvest(*rows)] if harvest else []
    sym, skips, escal = stats_from_engine_totals(c[:-1], f[:-1])
    book, _, _ = stats_from_engine_totals(c[-1], f[-1])
    return (sym, book, skips, escal, *hv)
