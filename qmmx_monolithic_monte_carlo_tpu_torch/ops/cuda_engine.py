"""Fused full engine: generate -> 12-gate engine lifecycle -> reduce, as one CUDA kernel.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py:1506-1806``
(kernel #8, ``_engine_kernel`` with ``_engine_lifecycle_loop`` and
``_engine_accumulate``, entry ``mc_paths_pallas_engine`` ``:1617-1712``), gbm
sampler with execution noise and antithetic lanes, up to 8 levels and an even
horizon of at most 61 bars.  The bootstrap, block-bootstrap and Heston
branches, 9-64 levels, odd horizons, longer horizons (the windowed guard)
and the closed-trade harvest are not ported yet; ``sim/enginepath`` runs the
same engine at any horizon.

* ``mc_paths_engine_fused`` -- the entry.  For a CUDA device it launches
  ``ops/csrc/mc_engine.cu`` (pass 1: the sweep kernel at one grid row, one
  thread per path, one partial row per CTA; pass 2: a fixed-order fold of
  the rows) or raises.  For the CPU it runs the plain version.
* ``engine_totals_reference`` -- the plain PyTorch version: the TPU kernel's
  double-bar streaming loop over (block, 8, lanes) tensors, driving
  ``sim.enginepath.EngineLifecycle.step``; optionally per path.
* ``mc_paths_engine_sweep_fused`` -- the engine-knob grid sweep under common
  random numbers, the counterpart of ``mc_paths_pallas_engine_sweep``
  (kernel #9, ``_engine_sweep_kernel``, ``pallas_engine.py:1813-2091``): the
  whole engine re-run for every row of EngineParams (and McNoise stds) with
  [G] leaves on the same uniforms; row g equals ``mc_paths_engine_fused``
  under row g's knobs, bit for bit.  A CUDA device launches
  ``mc_engine_sweep_kernel`` (CTAs x G) and one fold of all rows, or raises;
  the CPU runs ``engine_sweep_totals_reference``.
* ``mc_paths_engine_universe_fused`` -- the per-symbol engine universe, the
  counterpart of ``mc_paths_pallas_engine_universe`` (kernel #10,
  ``_engine_universe_kernel``, ``pallas_engine.py:2098-2279``, ``:2598-2689``):
  the sweep of universes below at one grid row, so S symbols in one launch of
  ``mc_engine_sweep_kernel`` with one row per symbol (its levels, s0, sigma,
  all 17 knobs and noise stds, its key ``prng.stream_key``; the ML, policy,
  touch and guard records shared); row s equals ``mc_paths_engine_fused`` at
  symbol s's inputs and ``symbol=s``, bit for bit.  ``harvest=True`` is not
  ported yet.
* ``mc_paths_engine_universe_sweep_fused`` -- the sweep of universes (kernel
  #11, ``_engine_universe_sweep_kernel``, ``pallas_engine.py:2282-2588``): S x
  G rows in one launch, row (s, g) under row g of symbol s's knob grid
  (leaves scalar, [G] or [S, G]) on symbol s's key (common random numbers
  within a symbol); it equals the engine universe at symbol s under row g's
  knobs, bit for bit.
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

from ..ops.pathgen import PathBars, VolumeModel
from ..sim.book import BookCurve, mix_shocks
from ..sim.enginepath import (SKIP_REASONS, EngineLifecycle, blend_weights, engine_knobs,
                              skip_columns)
from ..sim.pathsim import HIST_BINS
from ..types import KIND_SOLID, Levels
from ..utils import build, prng
from ..utils import device as devices
from ..utils.floats import div
from .cuda_gated import (box_muller, gated_bar, lifecycle_rows, lifecycle_totals,
                         market_normals, merge_totals, reduce_rows_reference,
                         stats_from_gated_totals)
from .draws import (ENGINE_STREAM, ENGINE_SUB, MARKET_STREAM, EngineLayout, MarketLayout,
                    engine_uniforms)
from .draws import market_uniforms as draws_market
from .kernel_args import (BLOCK, MAX_LEVELS, book_pairs, check_blocks, check_uniforms, consts,
                          device_rows, f32, fold_rows, grid_row, grid_size, knob_columns,
                          knob_rows, launch_pointer, repeat_rows, sg_columns, sg_rows,
                          symbol_columns, symbol_grid, symbol_rows, symbol_uniforms,
                          tensor_leaves)
from .regular import GUARD_WINDOW_BARS

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

# Kernel launches, counted by the wrappers where they launch and nowhere else.
LAUNCHES = {"mc_engine": 0, "mc_engine_reduce_rows": 0, "mc_engine_sweep": 0,
            "mc_engine_sweep_reduce_rows": 0, "mc_engine_universe": 0,
            "mc_engine_universe_reduce_rows": 0, "mc_engine_universe_sweep": 0,
            "mc_engine_universe_sweep_reduce_rows": 0, "mc_engine_corr": 0,
            "mc_engine_corr_reduce_rows": 0}


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
           antithetic, external_uniforms) -> EngineLayout:
    """The checks of ``mc_paths_pallas_engine`` (pallas_engine.py:1678-1698)
    and this kernel's envelope."""
    check_blocks(seed, levels, num_paths=num_paths, lanes=lanes, sub=ENGINE_SUB,
                 what="engine")
    layout = EngineLayout(num_bars, noise is not None)
    if num_bars > GUARD_WINDOW_BARS:
        raise ValueError(f"the engine kernel takes num_bars <= {GUARD_WINDOW_BARS} "
                         "(the running guard box); longer horizons are not "
                         "ported yet (sim.enginepath runs them)")
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


def _bars(u, layout: EngineLayout, antithetic: bool, cs, vc: _VolumeConsts, market=None):
    """Per bar, in order: (t, log open, high, low, close, volume, tie coin,
    noise normals or None), each [nb, 8, lanes], as
    ``_engine_lifecycle_loop`` draws and builds them from uniforms u
    f32[nb, u_rows, 8, lanes].  A book symbol's ``market`` = (market
    normals, beta) (``ops/cuda_gated.market_normals``) mixes the market into
    the price normal before the volume model sees it."""
    drift, sig_dt, log_s0 = cs
    nb, _, sub, lanes = u.shape
    log_s = torch.full((nb, sub, lanes), log_s0, dtype=_F32, device=u.device)
    for t2 in range(layout.num_bars // 2):
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
        for half in range(2):
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
                              market_uniforms=None, beta: float = 0.0):
    """The bars the plain version generates from uniforms f32[nb, u_rows, 8,
    lanes]: (PathBars f32[P, W] with volumes, tie f32[P, W], noise normals
    f32[4, P, W] or None), path p = block * 8 * lanes + s * lanes + j.  For
    replaying them through ``sim.enginepath.engine_path_replay``.  A book
    symbol's bars mix the market normals of ``market_uniforms`` f32[nb, W, 8,
    lanes] with loading ``beta`` into its own."""
    vc = _VolumeConsts(VolumeModel() if volume_model is None else volume_model)
    nb, _, sub, lanes = u.shape
    cols = {k: [] for k in ("open", "high", "low", "close", "volume", "tie", "nz")}
    market = (None if market_uniforms is None
              else (market_normals(market_uniforms, antithetic), f32(beta)))
    for _, log_open, high, low, c, v, tie, nz in _bars(
            u, layout, antithetic, consts(s0, mu, sigma, dt), vc, market):
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
                  antithetic, per_path: bool, market=None, book=None, weight=None):
    """Totals (and per-path rows) of one chunk of blocks, u f32[nb, u_rows,
    8, lanes]: the TPU kernel's block computation with the engine of
    ``sim.enginepath``, binned as ``_engine_accumulate`` bins.  A book
    symbol (``market`` as in ``_bars``) adds its post-bar equity, times
    ``weight``, into the ``book`` (``sim/book.BookCurve``) after every bar."""
    life, path_skips = None, 0
    for t, log_open, *bar, nz in _bars(u, layout, antithetic, cs, vc, market):
        if life is None:
            life = EngineLifecycle(torch.exp(log_open).reshape(-1), levels, params,
                                   noise=noise, **kw)
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
    return counts, floats, path_rows(out, path_skips) if per_path else None


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
                            per_path: bool = False, symbol: int = 0):
    """The plain version's (int64 counts, float64 floats) totals, computed
    on ``device`` (default: that of ``external_uniforms``, else the CUDA
    device) in chunks of ``chunk_blocks`` blocks, Philox draws keyed as
    universe symbol ``symbol``; then, when ``per_path``, the f32[P,
    PATH_COLS] per-path rows of ``path_rows``."""
    kw = engine_knobs(policy, ml_model, touch_params, guard_params,
                    policy_gate_disabled, escalation, bar0_minute)
    layout = _check(seed, levels, kw, num_paths=num_paths, num_bars=num_bars,
                    lanes=lanes, noise=noise, antithetic=antithetic,
                    external_uniforms=external_uniforms)
    device = devices.resolve(device, external_uniforms)
    levels = levels.to(device)
    cs = consts(s0, mu, sigma, dt)
    vc = _VolumeConsts(VolumeModel() if volume_model is None else volume_model)
    n_blocks = num_paths // (ENGINE_SUB * lanes)
    tot, rows = None, []
    for b0 in range(0, n_blocks, chunk_blocks):
        nb = min(chunk_blocks, n_blocks - b0)
        if external_uniforms is not None:
            u = external_uniforms[b0:b0 + nb]
        else:
            u = engine_uniforms(seed, layout, block0=b0, n_blocks=nb, lanes=lanes,
                                symbol=symbol, device=device)
        *part, part_rows = _chunk_engine(u, layout, levels, params, kw, noise, cs,
                                         vc, antithetic, per_path)
        tot = merge_totals(tot, part)
        if per_path:
            rows.append(part_rows)
    return (*tot, torch.cat(rows)) if per_path else tot


def engine_sweep_totals_reference(seed, levels: Levels, grid_params, *, n_grid=None,
                                  policy=None, ml_model=None, touch_params=None,
                                  guard_params=None, policy_gate_disabled=None,
                                  escalation: bool = True, bar0_minute: int = 0,
                                  volume_model=None, noise=None, num_paths: int,
                                  num_bars: int = 40, s0: float = 100.0, mu: float = 0.0,
                                  sigma: float = 0.15, dt: float = 1.0 / (390.0 * 252.0),
                                  lanes: int = ENGINE_LANES, external_uniforms=None,
                                  device=None, chunk_blocks: int = 16,
                                  per_path: bool = False, symbol: int = 0):
    """The plain version of the sweep: int64 [G, 151] counts and float64
    [G, 6] floats, then f32[G, P, PATH_COLS] per-(row, path) rows when
    ``per_path``.  Each chunk's uniforms are drawn once (keyed as universe
    symbol ``symbol``) and every row runs the whole engine on them (the TPU
    kernel's reseeding)."""
    rows = knob_rows(grid_params, noise, n_grid)
    kw = engine_knobs(policy, ml_model, touch_params, guard_params,
                      policy_gate_disabled, escalation, bar0_minute)
    layout = _check(seed, levels, kw, num_paths=num_paths, num_bars=num_bars,
                    lanes=lanes, noise=noise, antithetic=False,
                    external_uniforms=external_uniforms)
    device = devices.resolve(device, external_uniforms)
    levels = levels.to(device)
    cs = consts(s0, mu, sigma, dt)
    vc = _VolumeConsts(VolumeModel() if volume_model is None else volume_model)
    n_blocks = num_paths // (ENGINE_SUB * lanes)
    tot, path_rows = [None] * len(rows), [[] for _ in rows]
    for b0 in range(0, n_blocks, chunk_blocks):
        nb = min(chunk_blocks, n_blocks - b0)
        if external_uniforms is not None:
            u = external_uniforms[b0:b0 + nb]
        else:
            u = engine_uniforms(seed, layout, block0=b0, n_blocks=nb, lanes=lanes,
                                symbol=symbol, device=device)
        for g, (p_g, noise_g) in enumerate(rows):
            *part, part_rows = _chunk_engine(u, layout, levels, p_g, kw, noise_g, cs, vc,
                                             False, per_path)
            tot[g] = merge_totals(tot[g], part)
            if per_path:
                path_rows[g].append(part_rows)
    out = (torch.stack([t[0] for t in tot]), torch.stack([t[1] for t in tot]))
    return out + (torch.stack([torch.cat(r) for r in path_rows]),) if per_path else out


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


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().qmmx_engine_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


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
    the CPU, or float64 rounded once)."""
    tp, gp, ml, pol = (kw["touch_params"], kw["guard_params"], kw["ml_model"],
                       kw["policy"])
    a = np.zeros(n, dtype=np.dtype(_EngineArgs))

    def col(x, dtype=np.float32):
        return np.broadcast_to(np.asarray(torch.as_tensor(x).detach().cpu().numpy(), dtype), (n,))

    cpu = levels.to("cpu")
    price = cpu.price.to(_F32)
    n_lv = price.shape[-1]
    a["level_price"][:, :n_lv] = torch.where(torch.isfinite(price), price, 0.0).numpy()
    a["level_round"][:, :n_lv] = torch.where(
        cpu.valid, torch.round(cpu.price * 100.0) / 100.0, 0.0).numpy()
    a["level_valid"][:, :n_lv] = cpu.valid.numpy()
    a["level_kind"][:, :n_lv] = (cpu.kind == KIND_SOLID).numpy()
    a["has_levels"] = col(cpu.count > 0, bool)
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


def _launch(args, max_levels: int, num_bars: int, *, num_paths: int, ext_ptr,
            device: torch.device, per_path: bool, what: str):
    """One launch of ``mc_engine_sweep_kernel`` over the argument structs
    ``args`` (one per grid row), counted in ``LAUNCHES[what]``: int64 [G,
    grid, 151] and f32 [G, grid, 6] partial rows, one per (grid row, CTA),
    plus f32[G, P, PATH_COLS] per-(row, path) rows when ``per_path``."""
    args_dev = device_rows(args, device)
    g, grid = len(args), grid_size(num_paths)
    part_counts = torch.empty((g, grid, ROW_COUNTS), dtype=torch.int64, device=device)
    part_floats = torch.empty((g, grid, ROW_FLOATS), dtype=_F32, device=device)
    path_rows = (torch.empty((g, num_paths, PATH_COLS), dtype=_F32, device=device)
                 if per_path else None)
    rc = _library().qmmx_mc_engine_sweep(
        args_dev.data_ptr(), g, max_levels, num_bars, ext_ptr, part_counts.data_ptr(),
        part_floats.data_ptr(), path_rows.data_ptr() if per_path else None, grid,
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, what)
    LAUNCHES[what] += 1
    out = (part_counts, part_floats)
    return out + (path_rows,) if per_path else out


def engine_rows(seed, levels: Levels, params, *, policy=None, ml_model=None,
                touch_params=None, guard_params=None, policy_gate_disabled=None,
                escalation: bool = True, bar0_minute: int = 0, volume_model=None,
                noise=None, antithetic: bool = False, num_paths: int,
                num_bars: int = 40, s0: float = 100.0, mu: float = 0.0,
                sigma: float = 0.15, dt: float = 1.0 / (390.0 * 252.0),
                lanes: int = ENGINE_LANES, external_uniforms=None, device=None,
                per_path: bool = False, symbol: int = 0):
    """Launch pass 1 on a CUDA device (the kernel at one grid row): int64
    [grid, 151] count rows and f32 [grid, 6] float rows, one row per CTA,
    plus the f32[P, PATH_COLS] per-path rows of ``path_rows`` when
    ``per_path``; Philox keyed as universe symbol ``symbol``."""
    kw = engine_knobs(policy, ml_model, touch_params, guard_params,
                    policy_gate_disabled, escalation, bar0_minute)
    layout = _check(seed, levels, kw, num_paths=num_paths, num_bars=num_bars,
                    lanes=lanes, noise=noise, antithetic=antithetic,
                    external_uniforms=external_uniforms)
    device = torch.device("cuda" if device is None else device)
    ext_ptr = launch_pointer(num_paths, num_bars, external_uniforms, device, "engine_rows")
    args = _pack_args(seed, levels, params, kw, layout, n=1, num_paths=num_paths, s0=s0,
                      sigma=sigma, mu=mu, dt=dt, lanes=lanes, noise=noise,
                      antithetic=antithetic, volume_model=volume_model, symbols=[symbol])
    out = _launch(args, levels.max_levels, num_bars, num_paths=num_paths, ext_ptr=ext_ptr,
                  device=device, per_path=per_path, what="mc_engine")
    return tuple(x[0] for x in out)


def engine_sweep_rows(seed, levels: Levels, grid_params, *, n_grid=None, policy=None,
                      ml_model=None, touch_params=None, guard_params=None,
                      policy_gate_disabled=None, escalation: bool = True,
                      bar0_minute: int = 0, volume_model=None, noise=None,
                      num_paths: int, num_bars: int = 40, s0: float = 100.0,
                      mu: float = 0.0, sigma: float = 0.15,
                      dt: float = 1.0 / (390.0 * 252.0), lanes: int = ENGINE_LANES,
                      external_uniforms=None, device=None, per_path: bool = False):
    """Launch the sweep's pass 1 on a CUDA device, one launch for the whole
    grid: int64 [G, grid, 151] and f32 [G, grid, 6] partial rows, one per
    (grid row, CTA), plus f32[G, P, PATH_COLS] per-(row, path) rows when
    ``per_path``."""
    n_grid = len(knob_rows(grid_params, noise, n_grid))
    kw = engine_knobs(policy, ml_model, touch_params, guard_params,
                      policy_gate_disabled, escalation, bar0_minute)
    layout = _check(seed, levels, kw, num_paths=num_paths, num_bars=num_bars,
                    lanes=lanes, noise=noise, antithetic=False,
                    external_uniforms=external_uniforms)
    device = torch.device("cuda" if device is None else device)
    ext_ptr = launch_pointer(num_paths, num_bars, external_uniforms, device,
                             "engine_sweep_rows")
    # one argument struct per row, the per-row derived values (cooldown ms,
    # blend weights, ...) computed on the [G] columns
    args = _pack_args(seed, levels, grid_params, kw, layout, n=n_grid, num_paths=num_paths,
                      s0=s0, sigma=sigma, mu=mu, dt=dt, lanes=lanes, noise=noise,
                      antithetic=False, volume_model=volume_model, symbols=[0] * n_grid)
    return _launch(args, levels.max_levels, num_bars, num_paths=num_paths, ext_ptr=ext_ptr,
                   device=device, per_path=per_path, what="mc_engine_sweep")


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
                          device=None, symbol: int = 0):
    """Fused full-engine MC, the counterpart of ``mc_paths_pallas_engine``
    (gbm): returns (PathStats, int64[16] skip table ordered as
    ``sim.enginepath.SKIP_REASONS``, int64 escalations), the contract of
    ``sim.enginepath.mc_paths_engine``, with McNoise per-entry execution
    noise and antithetic lane pairs; ``symbol`` keys the draws as universe
    symbol ``symbol`` (0: the single run).

    ``device`` (default: that of ``external_uniforms``, else the CUDA device,
    which raises where there is none) picks the path: a CUDA device launches
    the kernel or raises; the CPU runs the plain version.  Draws agree with
    ``sim.enginepath.mc_paths_engine`` statistically, not bitwise."""
    kw = dict(policy=policy, ml_model=ml_model, touch_params=touch_params,
              guard_params=guard_params, policy_gate_disabled=policy_gate_disabled,
              escalation=escalation, bar0_minute=bar0_minute,
              volume_model=volume_model, noise=noise, antithetic=antithetic,
              num_paths=num_paths, num_bars=num_bars, s0=s0, mu=mu, sigma=sigma,
              dt=dt, lanes=lanes, external_uniforms=external_uniforms, symbol=symbol)
    _check(seed, levels, engine_knobs(policy, ml_model, touch_params, guard_params,
                                    policy_gate_disabled, escalation, bar0_minute),
           num_paths=num_paths, num_bars=num_bars, lanes=lanes, noise=noise,
           antithetic=antithetic, external_uniforms=external_uniforms)
    device = devices.resolve(device, external_uniforms)
    if device.type == "cpu":
        return stats_from_engine_totals(*engine_totals_reference(
            seed, levels, params, device=device, **kw))
    rows = engine_rows(seed, levels, params, device=device, **kw)
    return stats_from_engine_totals(*reduce_rows(*rows))


def mc_paths_engine_sweep_fused(seed, levels: Levels, grid_params, *, n_grid=None,
                                policy=None, ml_model=None, touch_params=None,
                                guard_params=None, policy_gate_disabled=None,
                                noise=None, escalation: bool = True,
                                bar0_minute: int = 0, volume_model=None,
                                num_paths: int, num_bars: int = 40, s0: float = 100.0,
                                mu: float = 0.0, sigma: float = 0.15,
                                dt: float = 1.0 / (390.0 * 252.0),
                                lanes: int = ENGINE_LANES, external_uniforms=None,
                                device=None):
    """Fused engine-knob grid sweep, the counterpart of
    ``mc_paths_pallas_engine_sweep`` (gbm): ``grid_params`` (EngineParams
    whose leaves are [G] vectors or shared scalars) and ``noise`` (McNoise,
    scalar or [G] stds) give G rows, every row on the same uniforms (CRN).
    Returns ([G] PathStats, int64 [G, 16] skip tables, int64 [G]
    escalations); row g equals ``mc_paths_engine_fused`` under row g's knobs
    at the same seed, bit for bit.  ``device`` as in
    ``mc_paths_engine_fused``."""
    kw = dict(n_grid=n_grid, policy=policy, ml_model=ml_model, touch_params=touch_params,
              guard_params=guard_params, policy_gate_disabled=policy_gate_disabled,
              escalation=escalation, bar0_minute=bar0_minute, volume_model=volume_model,
              noise=noise, num_paths=num_paths, num_bars=num_bars, s0=s0, mu=mu,
              sigma=sigma, dt=dt, lanes=lanes, external_uniforms=external_uniforms)
    knob_rows(grid_params, noise, n_grid)
    _check(seed, levels, engine_knobs(policy, ml_model, touch_params, guard_params,
                                    policy_gate_disabled, escalation, bar0_minute),
           num_paths=num_paths, num_bars=num_bars, lanes=lanes, noise=noise,
           antithetic=False, external_uniforms=external_uniforms)
    device = devices.resolve(device, external_uniforms)
    if device.type == "cpu":
        return stats_from_engine_totals(*engine_sweep_totals_reference(
            seed, levels, grid_params, device=device, **kw))
    rows = engine_sweep_rows(seed, levels, grid_params, device=device, **kw)
    return stats_from_engine_totals(*reduce_rows(*rows))


# --------------------------------------------------------------------------
# the universes (kernels #10 and #11): one row of mc_engine_sweep_kernel per
# (symbol, grid row); the engine universe is the sweep of universes at one
# grid row
# --------------------------------------------------------------------------

def _universe_layout(seed, sym_levels: Levels, kw: dict, noise, n_sym: int, *,
                     paths_per_symbol: int, num_bars: int, lanes: int,
                     external_uniforms) -> EngineLayout:
    """The checks of ``mc_paths_pallas_engine_universe(_sweep)``
    (pallas_engine.py:2248-2267, :2440-2457) and the single kernel's envelope,
    on one symbol's levels; injected uniforms f32[S, blocks, u_rows, 8, lanes]."""
    layout = _check(seed, sym_levels, kw, num_paths=paths_per_symbol, num_bars=num_bars,
                    lanes=lanes, noise=noise, antithetic=False, external_uniforms=None)
    check_uniforms(external_uniforms, (n_sym, paths_per_symbol // (ENGINE_SUB * lanes),
                                       layout.u_rows, ENGINE_SUB, lanes),
                   antithetic=False, lanes=lanes)
    return layout


def _one_row(levels: Levels, s0, sigma, params, noise, harvest: bool):
    """The engine universe's knobs as the sweep of universes takes them at
    one grid row: ``params`` and ``noise`` with their [S] leaves as [S, 1],
    after the universe's own checks (scalar or [S] leaves, no harvest)."""
    if harvest:
        raise NotImplementedError("harvest=True is not ported yet (the flywheel slice, "
                                  "with models/harvest.py)")
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
                                           chunk_blocks: int = 16, per_path: bool = False):
    """The plain version of the sweep of universes: int64 [S, G, 151] counts
    and float64 [S, G, 6] floats, then f32[S, G, P, PATH_COLS] per-path rows
    with ``per_path``; symbol s by ``engine_sweep_totals_reference`` over its
    grid (the [S, G] leaves of ``grid_params`` and ``noise`` cut to row s)
    at its levels, s0, sigma, mu 0 and its uniforms or key."""
    gates = dict(policy=policy, ml_model=ml_model, touch_params=touch_params,
                 guard_params=guard_params, policy_gate_disabled=policy_gate_disabled,
                 escalation=escalation, bar0_minute=bar0_minute)
    sym = symbol_rows(levels, s0, sigma)
    n_grid = len(sg_rows(grid_params, noise, len(sym), n_grid)[0])
    _universe_layout(seed, sym[0][0], engine_knobs(**gates), noise, len(sym),
                     paths_per_symbol=paths_per_symbol, num_bars=num_bars, lanes=lanes,
                     external_uniforms=external_uniforms)
    device = devices.resolve(device, external_uniforms)
    out = [engine_sweep_totals_reference(
        seed, lv, symbol_grid(grid_params, s), n_grid=n_grid, noise=symbol_grid(noise, s),
        volume_model=volume_model, num_paths=paths_per_symbol, num_bars=num_bars,
        s0=s0_s, mu=0.0, sigma=sg_s, dt=dt, lanes=lanes, symbol=s,
        external_uniforms=symbol_uniforms(external_uniforms, s), device=device,
        chunk_blocks=chunk_blocks, per_path=per_path, **gates)
        for s, (lv, s0_s, sg_s) in enumerate(sym)]
    return tuple(torch.stack(x) for x in zip(*out))


def engine_universe_sweep_rows(seed, levels: Levels, grid_params, s0, sigma, *,
                               n_grid=None, policy=None, ml_model=None, touch_params=None,
                               guard_params=None, policy_gate_disabled=None,
                               escalation: bool = True, bar0_minute: int = 0,
                               volume_model=None, noise=None, paths_per_symbol: int,
                               num_bars: int = 40, dt: float = 1.0 / (390.0 * 252.0),
                               lanes: int = ENGINE_LANES, external_uniforms=None,
                               device=None, per_path: bool = False,
                               what: str = "mc_engine_universe_sweep"):
    """Launch the sweep of universes' pass 1 on a CUDA device, one launch of
    ``mc_engine_sweep_kernel`` with S x G rows (row s * G + g for (s, g)),
    counted in ``LAUNCHES[what]``: int64 [S, G, grid, 151] and f32 [S, G,
    grid, 6] partial rows, plus f32[S, G, P, PATH_COLS] per-path rows when
    ``per_path``."""
    kw = engine_knobs(policy, ml_model, touch_params, guard_params,
                      policy_gate_disabled, escalation, bar0_minute)
    sym = symbol_rows(levels, s0, sigma)
    grid = sg_rows(grid_params, noise, len(sym), n_grid)
    layout = _universe_layout(seed, sym[0][0], kw, noise, len(sym),
                              paths_per_symbol=paths_per_symbol, num_bars=num_bars,
                              lanes=lanes, external_uniforms=external_uniforms)
    device = torch.device("cuda" if device is None else device)
    ext_ptr = launch_pointer(paths_per_symbol, num_bars, external_uniforms, device, what)
    n_sym, n_grid = len(sym), len(grid[0])
    cell_sym = np.repeat(np.arange(n_sym), n_grid)          # cell (s, g) at s * G + g
    args = _pack_args(seed, repeat_rows(levels, n_grid), sg_columns(grid_params, n_sym, n_grid),
                      kw, layout, n=n_sym * n_grid, num_paths=paths_per_symbol,
                      s0=[sym[s][1] for s in cell_sym], sigma=[sym[s][2] for s in cell_sym],
                      mu=0.0, dt=dt, lanes=lanes, noise=sg_columns(noise, n_sym, n_grid),
                      antithetic=False, volume_model=volume_model, symbols=cell_sym.tolist(),
                      ext_offset=cell_sym * paths_per_symbol * layout.u_rows)
    out = _launch(args, levels.max_levels, num_bars, num_paths=paths_per_symbol,
                  ext_ptr=ext_ptr, device=device, per_path=per_path, what=what)
    return tuple(x.view(n_sym, n_grid, *x.shape[1:]) for x in out)


def _universe_sweep_totals(seed, levels: Levels, grid_params, s0, sigma, *, device,
                           what: str, **kw):
    """(int64 [S, G, 151], float64 [S, G, 6]) of the sweep of universes on
    the resolved ``device``: the plain version on the CPU, else one launch
    and one fold, counted under ``what`` and ``what + "_reduce_rows"``."""
    device = devices.resolve(device, kw.get("external_uniforms"))
    if device.type == "cpu":
        return engine_universe_sweep_totals_reference(seed, levels, grid_params, s0, sigma,
                                                      device=device, **kw)
    pc, pf = engine_universe_sweep_rows(seed, levels, grid_params, s0, sigma, device=device,
                                        what=what, **kw)
    c, f = reduce_rows(pc.flatten(0, 1), pf.flatten(0, 1), what=what + "_reduce_rows")
    return c.view(*pc.shape[:2], -1), f.view(*pf.shape[:2], -1)


def engine_universe_totals_reference(seed, levels: Levels, params, s0, sigma, *,
                                     noise=None, harvest: bool = False, **kw):
    """The plain version of the engine universe: int64 [S, 151] counts and
    float64 [S, 6] floats, then f32[S, P, PATH_COLS] per-(symbol, path) rows
    with ``per_path``; the sweep of universes' plain version at one grid row
    (symbol s by ``engine_totals_reference`` at its levels, s0, sigma, knobs
    and noise stds, mu 0, its uniforms ``external_uniforms[s]`` or its key).
    Keywords as in ``engine_universe_sweep_totals_reference``."""
    grid, g_noise = _one_row(levels, s0, sigma, params, noise, harvest)
    out = engine_universe_sweep_totals_reference(seed, levels, grid, s0, sigma, n_grid=1,
                                                 noise=g_noise, **kw)
    return tuple(x[:, 0] for x in out)


def engine_universe_rows(seed, levels: Levels, params, s0, sigma, *, noise=None,
                         harvest: bool = False, **kw):
    """Launch the universe's pass 1 on a CUDA device: the sweep of
    universes' launch at one grid row, counted in
    ``LAUNCHES["mc_engine_universe"]``: int64 [S, grid, 151] and f32 [S,
    grid, 6] partial rows, plus f32[S, P, PATH_COLS] per-(symbol, path) rows
    with ``per_path``.  Keywords as in ``engine_universe_sweep_rows``."""
    grid, g_noise = _one_row(levels, s0, sigma, params, noise, harvest)
    out = engine_universe_sweep_rows(seed, levels, grid, s0, sigma, n_grid=1, noise=g_noise,
                                     what="mc_engine_universe", **kw)
    return tuple(x[:, 0] for x in out)


def mc_paths_engine_universe_fused(seed, levels: Levels, params, s0, sigma, *,
                                   policy=None, ml_model=None, touch_params=None,
                                   guard_params=None, policy_gate_disabled=None,
                                   escalation: bool = True, bar0_minute: int = 0,
                                   volume_model=None, noise=None, harvest: bool = False,
                                   paths_per_symbol: int, num_bars: int = 40,
                                   dt: float = 1.0 / (390.0 * 252.0),
                                   lanes: int = ENGINE_LANES, external_uniforms=None,
                                   device=None):
    """Fused per-symbol full-engine universe, the counterpart of
    ``mc_paths_pallas_engine_universe`` (gbm, no harvest): ([S] PathStats,
    int64 [S, 16] skip tables, int64 [S] escalations), symbol s under its own
    [S, L] levels row, s0[s], sigma[s], all engine knobs (``params`` leaves
    scalar or [S]), noise stds (``noise`` leaves scalar or [S]) and key, the
    ML, policy, touch and guard records shared; drift, sig_dt and log_s0 per
    symbol in float64 on the host, mu 0.  It runs as the sweep of universes
    at one grid row.  Row s equals ``mc_paths_engine_fused`` at those inputs
    with ``symbol=s`` bit for bit; injected uniforms are f32[S, blocks,
    u_rows, 8, lanes].  ``harvest=True`` raises (not ported yet).  ``device``
    as in ``mc_paths_engine_fused``."""
    grid, g_noise = _one_row(levels, s0, sigma, params, noise, harvest)
    c, f = _universe_sweep_totals(
        seed, levels, grid, s0, sigma, n_grid=1, policy=policy, ml_model=ml_model,
        touch_params=touch_params, guard_params=guard_params,
        policy_gate_disabled=policy_gate_disabled, escalation=escalation,
        bar0_minute=bar0_minute, volume_model=volume_model, noise=g_noise,
        paths_per_symbol=paths_per_symbol, num_bars=num_bars, dt=dt, lanes=lanes,
        external_uniforms=external_uniforms, device=device, what="mc_engine_universe")
    return stats_from_engine_totals(c[:, 0], f[:, 0])


def mc_paths_engine_universe_sweep_fused(seed, levels: Levels, grid_params, s0, sigma, *,
                                         n_grid=None, policy=None, ml_model=None,
                                         touch_params=None, guard_params=None,
                                         policy_gate_disabled=None, escalation: bool = True,
                                         bar0_minute: int = 0, volume_model=None,
                                         noise=None, paths_per_symbol: int,
                                         num_bars: int = 40,
                                         dt: float = 1.0 / (390.0 * 252.0),
                                         lanes: int = ENGINE_LANES, external_uniforms=None,
                                         device=None):
    """Fused sweep of universes, the counterpart of
    ``mc_paths_pallas_engine_universe_sweep`` (gbm): ([S, G] PathStats,
    int64 [S, G, 16] skip tables, int64 [S, G] escalations), cell (s, g)
    under symbol s's levels, s0, sigma and key and row g of its knob grid
    (``grid_params`` and ``noise`` leaves scalar, [G] or [S, G]), every row
    of a symbol on the same draws (CRN within a symbol).  Cell (s, g) equals
    ``mc_paths_engine_universe_fused`` at symbol s under row g's knobs, bit
    for bit.  ``device`` as in ``mc_paths_engine_fused``."""
    return stats_from_engine_totals(*_universe_sweep_totals(
        seed, levels, grid_params, s0, sigma, n_grid=n_grid, policy=policy,
        ml_model=ml_model, touch_params=touch_params, guard_params=guard_params,
        policy_gate_disabled=policy_gate_disabled, escalation=escalation,
        bar0_minute=bar0_minute, volume_model=volume_model, noise=noise,
        paths_per_symbol=paths_per_symbol, num_bars=num_bars, dt=dt, lanes=lanes,
        external_uniforms=external_uniforms, device=device,
        what="mc_engine_universe_sweep"))


# --------------------------------------------------------------------------
# the correlated book (kernel #12)
# --------------------------------------------------------------------------

def _check_corr(seed, levels: Levels, params, s0, sigma, beta, weights, kw: dict, noise, *,
                paths_per_symbol: int, num_bars: int, lanes: int, antithetic: bool,
                external_uniforms, market_uniforms, sampler: str, harvest: bool):
    """The checks of ``mc_paths_pallas_engine_corr`` (pallas_engine.py:
    3058-3087) and the kernel's envelope (<= 8 levels, an even horizon of at
    most 61 bars); returns (layout, market layout, ``symbol_columns``)."""
    if sampler != "gbm":
        raise NotImplementedError(f"sampler {sampler!r} is not ported yet for the book "
                                  "kernel (the samplers slice); the port runs gbm")
    if harvest:
        raise NotImplementedError("harvest=True is not ported yet (the flywheel slice, "
                                  "with models/harvest.py)")
    cols = symbol_columns(levels, s0, sigma, params, noise, beta=beta, weights=weights)
    layout = _check(seed, grid_row(levels, 0), kw, num_paths=paths_per_symbol,
                    num_bars=num_bars, lanes=lanes, noise=noise, antithetic=antithetic,
                    external_uniforms=None)
    if (external_uniforms is None) != (market_uniforms is None):
        raise ValueError("external_uniforms and market_uniforms go together")
    n_sym, n_blocks = len(cols["s0"]), paths_per_symbol // (ENGINE_SUB * lanes)
    mlayout = MarketLayout(num_bars)
    check_uniforms(external_uniforms, (n_sym, n_blocks, layout.u_rows, ENGINE_SUB, lanes),
                   antithetic=antithetic, lanes=lanes)
    check_uniforms(market_uniforms, (n_blocks, mlayout.u_rows, ENGINE_SUB, lanes),
                   antithetic=antithetic, lanes=lanes)
    return layout, mlayout, cols


def engine_corr_totals_reference(seed, levels: Levels, params, s0, sigma, beta, weights, *,
                                 policy=None, ml_model=None, touch_params=None,
                                 guard_params=None, policy_gate_disabled=None,
                                 escalation: bool = True, bar0_minute: int = 0,
                                 volume_model=None, noise=None, harvest: bool = False,
                                 antithetic: bool = False, paths_per_symbol: int,
                                 num_bars: int = 40, dt: float = 1.0 / (390.0 * 252.0),
                                 lanes: int = ENGINE_LANES, external_uniforms=None,
                                 market_uniforms=None, sampler: str = "gbm", device=None,
                                 chunk_blocks: int = 16, per_path: bool = False):
    """The plain version of the engine book: int64 [S + 1, 151] counts and
    float64 [S + 1, 6] floats (row s symbol s's, row S the book's, whose
    escalation and skip columns are zero), then f32[S + 1, P, PATH_COLS]
    per-path rows with ``per_path``.  Symbol s runs as the engine
    universe's symbol s, its price normal mixed with the market's
    (``sim/book.mix_shocks``) before the volume model sees it, and adds its
    weighted post-bar equity into the book's curve (``sim/book.BookCurve``)."""
    kw = engine_knobs(policy, ml_model, touch_params, guard_params,
                      policy_gate_disabled, escalation, bar0_minute)
    layout, mlayout, _ = _check_corr(
        seed, levels, params, s0, sigma, beta, weights, kw, noise,
        paths_per_symbol=paths_per_symbol, num_bars=num_bars, lanes=lanes,
        antithetic=antithetic, external_uniforms=external_uniforms,
        market_uniforms=market_uniforms, sampler=sampler, harvest=harvest)
    rows = symbol_rows(levels, s0, sigma, params, noise, beta=beta, weights=weights)
    device = devices.resolve(device, external_uniforms)
    vc = _VolumeConsts(VolumeModel() if volume_model is None else volume_model)
    n_blocks = paths_per_symbol // (ENGINE_SUB * lanes)
    n_sym = len(rows)
    tot, path_rows_ = [None] * (n_sym + 1), [[] for _ in range(n_sym + 1)]
    for b0 in range(0, n_blocks, chunk_blocks):
        nb = min(chunk_blocks, n_blocks - b0)
        um = (market_uniforms[b0:b0 + nb] if market_uniforms is not None else
              draws_market(seed, mlayout, block0=b0, n_blocks=nb, lanes=lanes, device=device))
        zm = market_normals(um, antithetic)
        book = BookCurve(nb * ENGINE_SUB * lanes, num_bars, device=device)
        for s, (lv, s0_s, sg_s, p, nz, beta_s, w_s) in enumerate(rows):
            if external_uniforms is not None:
                u = external_uniforms[s, b0:b0 + nb]
            else:
                u = engine_uniforms(seed, layout, block0=b0, n_blocks=nb, lanes=lanes,
                                    symbol=s, device=device)
            *part, part_rows = _chunk_engine(u, layout, lv.to(device), p, kw, nz,
                                             consts(s0_s, 0.0, sg_s, dt), vc, antithetic,
                                             per_path, market=(zm, beta_s), book=book,
                                             weight=w_s)
            tot[s] = merge_totals(tot[s], part)
            if per_path:
                path_rows_[s].append(part_rows)
        out = book.outcome()
        tot[n_sym] = merge_totals(tot[n_sym], lifecycle_totals(out, N_COUNTS + N_SKIPS))
        if per_path:   # the book's escalation and skip columns are zero
            path_rows_[n_sym].append(torch.cat([lifecycle_rows(out), torch.zeros(
                (out.equity.shape[0], PATH_COLS - 6), dtype=_F32, device=device)], dim=1))
    res = (torch.stack([t[0] for t in tot]), torch.stack([t[1] for t in tot]))
    if per_path:
        res += (torch.stack([torch.cat(r) for r in path_rows_]),)
    return res


def engine_corr_rows(seed, levels: Levels, params, s0, sigma, beta, weights, *, policy=None,
                     ml_model=None, touch_params=None, guard_params=None,
                     policy_gate_disabled=None, escalation: bool = True,
                     bar0_minute: int = 0, volume_model=None, noise=None,
                     harvest: bool = False, antithetic: bool = False,
                     paths_per_symbol: int, num_bars: int = 40,
                     dt: float = 1.0 / (390.0 * 252.0), lanes: int = ENGINE_LANES,
                     external_uniforms=None, market_uniforms=None, sampler: str = "gbm",
                     device=None, per_path: bool = False):
    """Launch the engine book's pass 1 on a CUDA device, one launch of
    ``mc_engine_corr_kernel``: int64 [S + 1, grid, 151] and f32 [S + 1, grid,
    6] partial rows (the symbols', then the book's), plus f32[S + 1, P,
    PATH_COLS] per-path rows when ``per_path``.  The book curves lie in a
    device-memory buffer (the engine's rings already take 25 KB of shared
    memory a CTA)."""
    kw = engine_knobs(policy, ml_model, touch_params, guard_params,
                      policy_gate_disabled, escalation, bar0_minute)
    layout, _, cols = _check_corr(
        seed, levels, params, s0, sigma, beta, weights, kw, noise,
        paths_per_symbol=paths_per_symbol, num_bars=num_bars, lanes=lanes,
        antithetic=antithetic, external_uniforms=external_uniforms,
        market_uniforms=market_uniforms, sampler=sampler, harvest=harvest)
    device = torch.device("cuda" if device is None else device)
    ext_ptr = launch_pointer(paths_per_symbol, num_bars, external_uniforms, device,
                             "engine_corr_rows")
    m_ptr = launch_pointer(paths_per_symbol, num_bars, market_uniforms, device,
                           "engine_corr_rows")
    n_sym, grid = len(cols["s0"]), grid_size(paths_per_symbol)
    args_dev = device_rows(_pack_args(
        seed, levels, params, kw, layout, n=n_sym, num_paths=paths_per_symbol, s0=cols["s0"],
        sigma=cols["sigma"], mu=0.0, dt=dt, lanes=lanes, noise=noise, antithetic=antithetic,
        volume_model=volume_model, symbols=range(n_sym),
        ext_offset=np.arange(n_sym) * paths_per_symbol * layout.u_rows), device)
    part_counts = torch.empty((n_sym + 1, grid, ROW_COUNTS), dtype=torch.int64, device=device)
    part_floats = torch.empty((n_sym + 1, grid, ROW_FLOATS), dtype=_F32, device=device)
    path_rows_ = (torch.empty((n_sym + 1, paths_per_symbol, PATH_COLS), dtype=_F32,
                              device=device) if per_path else None)
    curve_mem = torch.empty((num_bars, grid * BLOCK), dtype=_F32, device=device)
    bw = book_pairs(cols, device)
    rc = _corr_library().qmmx_mc_engine_corr(
        args_dev.data_ptr(), bw.data_ptr(), n_sym, levels.max_levels, num_bars, ext_ptr, m_ptr,
        prng.stream_key(MARKET_STREAM, 0), curve_mem.data_ptr(),
        part_counts.data_ptr(), part_floats.data_ptr(),
        path_rows_.data_ptr() if per_path else None, grid,
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, "mc_engine_corr")
    LAUNCHES["mc_engine_corr"] += 1
    out = (part_counts, part_floats)
    return out + (path_rows_,) if per_path else out


def mc_paths_engine_corr_fused(seed, levels: Levels, params, s0, sigma, beta, weights, *,
                               policy=None, ml_model=None, touch_params=None,
                               guard_params=None, policy_gate_disabled=None,
                               escalation: bool = True, bar0_minute: int = 0,
                               volume_model=None, noise=None, harvest: bool = False,
                               antithetic: bool = False, paths_per_symbol: int,
                               num_bars: int = 40, dt: float = 1.0 / (390.0 * 252.0),
                               lanes: int = ENGINE_LANES, external_uniforms=None,
                               market_uniforms=None, sampler: str = "gbm", device=None):
    """Fused correlated full-engine book, the counterpart of
    ``mc_paths_pallas_engine_corr`` (gbm, no harvest): ([S] PathStats, the
    book's PathStats, int64 [S, 16] skip tables, int64 [S] escalations) from
    one launch, in ``portfolio_mc_engine``'s order.  Symbol s runs the full
    engine under its own [S, L] levels row, s0[s], sigma[s], all engine
    knobs (``params`` leaves scalar or [S]), noise stds (``noise`` leaves
    scalar or [S]) and key, the ML, policy, touch and guard records shared;
    its normal is ``beta[s] * z_mkt + sqrt(1 - beta[s]^2) * eps`` with the
    market normal shared by every symbol, and the mixed shock also drives its
    volume; the book sums the symbols' post-bar equity curves times
    ``weights`` per path.  With beta = 0, symbol s equals
    ``mc_paths_engine_universe_fused``'s symbol s (on the card: per path and
    in its counts; in its float sums too up to 2^20 paths a symbol).
    Injected uniforms are
    f32[S, blocks, u_rows, 8, lanes] with the market's f32[blocks, W, 8,
    lanes].  ``device`` as in ``mc_paths_engine_fused``."""
    kw = dict(policy=policy, ml_model=ml_model, touch_params=touch_params,
              guard_params=guard_params, policy_gate_disabled=policy_gate_disabled,
              escalation=escalation, bar0_minute=bar0_minute, volume_model=volume_model,
              noise=noise, harvest=harvest, antithetic=antithetic,
              paths_per_symbol=paths_per_symbol, num_bars=num_bars, dt=dt, lanes=lanes,
              external_uniforms=external_uniforms, market_uniforms=market_uniforms,
              sampler=sampler)
    _check_corr(seed, levels, params, s0, sigma, beta, weights,
                engine_knobs(policy, ml_model, touch_params, guard_params,
                             policy_gate_disabled, escalation, bar0_minute), noise,
                paths_per_symbol=paths_per_symbol, num_bars=num_bars, lanes=lanes,
                antithetic=antithetic, external_uniforms=external_uniforms,
                market_uniforms=market_uniforms, sampler=sampler, harvest=harvest)
    device = devices.resolve(device, external_uniforms)
    if device.type == "cpu":
        c, f = engine_corr_totals_reference(seed, levels, params, s0, sigma, beta, weights,
                                            device=device, **kw)
    else:
        c, f = reduce_rows(*engine_corr_rows(seed, levels, params, s0, sigma, beta, weights,
                                             device=device, **kw),
                           what="mc_engine_corr_reduce_rows")
    sym, skips, escal = stats_from_engine_totals(c[:-1], f[:-1])
    book, _, _ = stats_from_engine_totals(c[-1], f[-1])
    return sym, book, skips, escal
