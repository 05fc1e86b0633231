"""Fused first-contact Monte Carlo: generate → replay → reduce, as one CUDA kernel.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:57-821``
(kernel #1, ``_mc_kernel``, and its entry ``mc_paths_pallas``), with all four
samplers: gbm, and the bootstrap, block-bootstrap and Heston branches.

* ``mc_paths_fused`` — the entry.  For a CUDA device it launches
  ``ops/csrc/mc_first_contact.cu`` (pass 1: ``mc_universe_kernel`` at one
  symbol, one thread per path, one partial row per CTA, any even W; pass 2:
  a fixed-order fold of the rows) or, for the other samplers,
  ``ops/csrc/mc_first_contact_samplers.cu`` (pass 1:
  ``mc_first_contact_sampler_kernel``; the same fold), or raises.
  For the CPU it runs the plain version.
* ``mc_paths_fused_reference`` — the plain PyTorch version: the TPU kernel's
  block computation, vectorised over (block, bar, lane) tensors.
* ``mc_paths_sweep_fused`` — the stop/target grid sweep under common random
  numbers, the counterpart of ``mc_paths_pallas_sweep`` (kernel #3,
  ``_sweep_kernel``, ``pallas_mc.py:1978-2156``): each path's bars and first
  contact once, replayed for every (stop, tp) row; row g equals
  ``mc_paths_fused`` with (stop_g, tp_g) bit for bit.  For a CUDA device it
  launches ``mc_first_contact_sweep_kernel`` (``ops/csrc/mc_first_contact_sweep.cu``,
  partial rows per (row, CTA); under the other samplers
  ``mc_first_contact_sampler_sweep_kernel``; each walks a path once for every
  row) and one fold of all rows, or raises; for the CPU
  it runs ``sweep_totals_reference``.  No noise and no antithetic lanes, as
  the TPU sweep kernel has none.
* ``mc_paths_universe_fused`` — the per-symbol universe, the counterpart of
  ``mc_paths_pallas_universe`` (kernel #2, ``_universe_kernel``,
  ``pallas_mc.py:828-1024``): S symbols in one launch, each with its own
  levels, s0, sigma, (prox, stop, tp) knobs and key (``prng.stream_key``);
  row s equals ``mc_paths_fused`` at symbol s's inputs and ``symbol=s``, bit
  for bit.  A CUDA device launches ``mc_universe_kernel`` (CTAs x S; under
  the other samplers ``mc_first_contact_sampler_kernel`` with a row a symbol,
  each on its own recorded history) and one fold of all symbols, or raises;
  the CPU runs ``universe_totals_reference``.  No noise and no antithetic
  lanes, as the TPU universe kernel has none.
* ``LAUNCHES`` — how many times each kernel was launched.

The gbm kernels keep the first sine halves of a path's Box-Muller pairs in
shared memory and draw the pairs past them again (each kernel's launch owns
that policy and reports it: ``universe_plan``, ``sweep_plan``), so a path's
results do not depend on how many are kept: ``mc_universe_kernel`` up to 24
(every one up to W = 48), the sweep's ``mc_first_contact_sweep_kernel`` up to
64 (W = ``MAX_HALF_BARS``, 128).  Their launches count under the kernel's
name (``mc_first_contact``, ``mc_universe``, ``mc_sweep``) where the plan
keeps every half, else with ``_long``
(``mc_first_contact_long``, ``mc_universe_long``, ``mc_sweep_long``); under
``_FORCE_LONG`` (a checks' hook) they keep none.  The sampler kernels draw
their pairs again at every W.  No first-contact launch has a horizon cap.

Uniforms follow ``ops/draws.GbmLayout``; in Philox mode they come from
``utils/prng`` (the kernel computes the same bits), or they are injected as
``external_uniforms`` f32[n_blocks, n_rows, lanes], lane j of block i being
global path ``i * lanes + j``.  ``lanes`` is a logical block width only: it
fixes which draws a path takes, not how the kernel is launched.

Counts stay int64 until ``stats_from_totals`` turns them into the float32
``PathStats``.  (The TPU kernel sums its counts in float32 rows, which stop
being exact past 2^24 entered paths.)
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..sim.pathsim import HIST_BINS, HIST_HI, HIST_LO, PathStats
from ..types import Levels
from ..utils import build, prng
from ..utils import device as devices
from ..utils.floats import fma
from .draws import FUSED_STREAM, GbmLayout, fused_uniforms
from .kernel_args import (MAX_LEVELS, check_uniforms, consts, device_rows, f32, fold_rows,
                          grid_rows, grid_size, knobs, launch_pointer, level_slots,
                          SamplerArgs, sampler_args, symbol_rows, symbol_uniforms)
from .pathgen import cumsum_f32
from .samplers import (Sampler, block_offset, block_start, gather, heston_shock, heston_step,
                       iid_index, make_sampler)

SINGLE_LANES = 8192      # logical paths per block (the TPU kernel's default)
UNIVERSE_LANES = 2048    # the TPU universe kernel's block (pallas_mc.LANES)
MAX_HALF_BARS = 128      # past it the gbm sweep draws pairs again for their sine halves
N_COUNTS = 5             # n, entered, tp, stop, open
ROW_COUNTS = N_COUNTS + HIST_BINS
ROW_FLOATS = 4           # sum_r, sum_r2, min_r, max_r
_BIG = 3.4e38            # empty min/max sentinel, as the TPU kernel's
SWEEP_ROWS = 16          # grid rows one sweep launch takes (mc_first_contact.cuh)
_SOURCE = "mc_first_contact"
_SWEEP_SOURCE = "mc_first_contact_sweep"
_SAMPLER_SOURCE = "mc_first_contact_samplers"
_SAMPLER_SWEEP_SOURCE = "mc_first_contact_sampler_sweep"

# Kernel launches, counted by the wrappers where they launch and nowhere else.
LAUNCHES = {"mc_first_contact": 0, "mc_reduce_rows": 0, "mc_sweep": 0,
            "mc_sweep_reduce_rows": 0, "mc_universe": 0, "mc_universe_reduce_rows": 0,
            "mc_first_contact_sampler": 0, "mc_sweep_sampler": 0, "mc_universe_sampler": 0,
            "mc_first_contact_long": 0, "mc_sweep_long": 0, "mc_universe_long": 0}

# A check's hook: while true, the gbm kernels keep no sine half (each pair
# drawn again), even where every half fits, to hold the two ways against
# each other bit for bit.
_FORCE_LONG = False


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class _McArgs(ctypes.Structure):
    """Mirror of ``struct McArgs`` in ops/csrc/mc_first_contact.cu."""

    _fields_ = [
        ("num_paths", ctypes.c_int64), ("ext_offset", ctypes.c_int64),
        ("level_price", ctypes.c_float * MAX_LEVELS),
        ("level_valid", ctypes.c_float * MAX_LEVELS),
        ("prox", ctypes.c_float), ("stop_pad", ctypes.c_float),
        ("tp_pad", ctypes.c_float),
        ("lvl_jit", ctypes.c_float), ("entry_slip", ctypes.c_float),
        ("stop_slip", ctypes.c_float), ("tgt_slip", ctypes.c_float),
        ("drift", ctypes.c_float), ("sig_dt", ctypes.c_float),
        ("log_s0", ctypes.c_float),
        ("seed", ctypes.c_uint32), ("stream", ctypes.c_uint32),
        ("max_levels", ctypes.c_int32), ("num_bars", ctypes.c_int32),
        ("lanes", ctypes.c_int32), ("n_rows", ctypes.c_int32),
        ("use_noise", ctypes.c_int32), ("antithetic", ctypes.c_int32),
    ]


class _SweepGrid(ctypes.Structure):
    """Mirror of ``struct SweepGrid`` in ops/csrc/mc_first_contact.cuh."""

    _fields_ = [("n_rows", ctypes.c_int32),
                ("stop_pad", ctypes.c_float * SWEEP_ROWS),
                ("tp_pad", ctypes.c_float * SWEEP_ROWS)]


def _check(seed, levels, *, num_paths, num_bars, lanes, noise, antithetic,
           external_uniforms, sampler: Sampler = Sampler()) -> GbmLayout:
    """The checks of ``_mc_paths_pallas_jit`` (pallas_mc.py:724-738)."""
    prng.check_seed(seed)
    if lanes <= 0 or num_paths <= 0 or num_paths % lanes != 0:
        raise ValueError(f"num_paths must be a positive multiple of {lanes}")
    if antithetic and sampler.kind != "gbm":
        raise ValueError("kernel antithetic pairs gbm normals only")
    layout = GbmLayout(num_bars, noise is not None, sampler.kind)
    if levels.max_levels > MAX_LEVELS:
        raise ValueError(f"the first-contact kernel supports up to "
                         f"{MAX_LEVELS} level slots")
    if antithetic and lanes % 2 != 0:
        raise ValueError("antithetic needs an even lanes (half-block pairs)")
    if external_uniforms is not None:
        if not torch.is_tensor(external_uniforms):
            raise ValueError("external_uniforms must be a torch tensor")
        want = (num_paths // lanes, layout.n_rows, lanes)
        if tuple(external_uniforms.shape) != want:
            raise ValueError(f"external_uniforms must have shape {want}, "
                             f"got {tuple(external_uniforms.shape)}")
        if external_uniforms.dtype != torch.float32:
            raise ValueError("external_uniforms must be float32")
    return layout


def _check_sweep(seed, levels, params, grid_stops, grid_tps, *, num_paths, num_bars,
                 lanes, external_uniforms,
                 sampler: Sampler = Sampler()) -> tuple[GbmLayout, list[dict]]:
    """The checks of ``_mc_paths_pallas_sweep_jit`` (pallas_mc.py:2083-2098):
    the single kernel's, and the grid's; returns the layout and each row's
    knobs."""
    layout = _check(seed, levels, num_paths=num_paths, num_bars=num_bars, lanes=lanes,
                    noise=None, antithetic=False, external_uniforms=external_uniforms,
                    sampler=sampler)
    return layout, [knobs(p_g, None) for (p_g,) in grid_rows(params, grid_stops, grid_tps)]


# --------------------------------------------------------------------------
# the plain PyTorch version
# --------------------------------------------------------------------------

def _normals(r1, r2):
    """The paired Box-Muller normals of radius rows ``r1`` and angle rows
    ``r2`` [nb, W/2, lanes]: cosines for bars 0 .. W/2-1, sines after."""
    rad = torch.sqrt(-2.0 * torch.log(r1))
    ang = prng.TWO_PI * r2
    return torch.cat([rad * torch.cos(ang), rad * torch.sin(ang)], dim=1)


def _block_bars(u, layout: GbmLayout, consts, antithetic, sampler: Sampler):
    """One chunk's bars, (close, opens, high, low) f32[nb, W, lanes]: the
    TPU kernel's ``_gbm_block``, ``_heston_block`` or ``_bootstrap_block``
    with a serial float32 cumsum."""
    lanes = u.shape[-1]
    drift, sig_dt, log_s0 = consts
    if sampler.resamples:
        idx = _resample_index(u[:, layout.idx], sampler)
        logc = gather(sampler.tables, 0, idx)
        log_close = log_s0 + cumsum_f32(logc, dim=1)
        log_prev = log_close - logc
        return (torch.exp(log_close), torch.exp(log_prev + gather(sampler.tables, 3, idx)),
                torch.exp(log_prev + gather(sampler.tables, 1, idx)),
                torch.exp(log_prev + gather(sampler.tables, 2, idx)))
    z = _normals(u[:, layout.u1], u[:, layout.u2])
    if sampler.kind == "heston":
        incr, sig2dt = _heston_incr(z, _normals(u[:, layout.q1], u[:, layout.q2]),
                                    sampler.heston)
        two_s2 = 2.0 * sig2dt
    else:
        if antithetic:
            zh = z[..., :lanes // 2]
            z = torch.cat([zh, -zh], dim=-1)
        incr = drift + sig_dt * z                          # [nb, W, lanes]
        sig2dt = f32(np.float32(sig_dt) * np.float32(sig_dt))
        two_s2 = f32(np.float32(2.0) * np.float32(sig2dt))
    log_close = log_s0 + cumsum_f32(incr, dim=1)
    log_open = log_close - incr
    diff = log_close - log_open
    d2 = diff * diff
    mid = log_open + log_close
    high = torch.exp(0.5 * (mid + torch.sqrt(d2 - two_s2 * torch.log(u[:, layout.u3]))))
    low = torch.exp(0.5 * (mid - torch.sqrt(d2 - two_s2 * torch.log(u[:, layout.u4]))))
    return torch.exp(log_close), torch.exp(log_open), high, low


def _resample_index(u, sampler: Sampler):
    """f32[nb, W, lanes] recorded-bar indices of the index rows ``u``:
    ``_bootstrap_block``'s (block bootstrap: bar j takes its block's start,
    drawn from the block's first row, plus its offset)."""
    h = sampler.hist_len
    if not sampler.block_len:
        return iid_index(u, h)
    starts = block_start(u, h, sampler.block_len)
    bl = sampler.block_len
    return torch.stack([starts[:, (j // bl) * bl] + block_offset(j, bl)
                        for j in range(u.shape[1])], dim=1)


def _heston_incr(z, zq, hc):
    """``_heston_block``'s serial variance chain over bars: (log increments,
    bridge variances v+ dt) f32[nb, W, lanes]."""
    shock = heston_shock(z, zq, hc)
    v = torch.full_like(z[:, 0], hc.v0)
    incr, sig2 = [], []
    for t in range(z.shape[1]):
        drift, sig_bar, sig2dt, v = heston_step(v, z[:, t], shock[:, t], hc)
        incr.append(fma(sig_bar, z[:, t], drift * hc.dt))
        sig2.append(sig2dt)
    return torch.stack(incr, dim=1), torch.stack(sig2, dim=1)


def _contact(u, layout: GbmLayout, lp, lv, n_levels, prox, consts, antithetic,
             sampler: Sampler = Sampler()) -> dict:
    """One chunk of blocks, u f32[nb, n_rows, lanes], up to the first
    contact: the TPU kernel's bar block and ``_first_contact``.  Every row
    of a sweep replays this once."""
    nb, _, lanes = u.shape
    w = layout.num_bars
    dev = u.device
    close, opens, high, low = _block_bars(u, layout, consts, antithetic, sampler)

    # first contact: nearest valid level by running min, first bar within prox
    best_d = torch.full_like(close, _BIG)
    best_p = torch.zeros_like(close)
    for i in range(n_levels):
        if lv[i] <= 0.0:
            continue        # an invalid slot's distance is _BIG: never taken
        d = (close - lp[i]).abs()
        take = d < best_d
        best_p = torch.where(take, lp[i], best_p)
        best_d = torch.where(take, d, best_d)
    near = best_d <= prox
    iota = torch.arange(w, device=dev).view(1, w, 1)
    ebar = torch.where(near, iota, w).amin(dim=1)          # [nb, lanes]
    at_entry = iota == ebar[:, None]
    entry = torch.where(at_entry, close, 0.0).sum(dim=1)
    return dict(u=u, iota=iota, ebar=ebar, entered=ebar < w, high=high, low=low,
                entry=entry, lvl=torch.where(at_entry, best_p, 0.0).sum(dim=1),
                is_long=entry > torch.where(at_entry, opens, 0.0).sum(dim=1))


def _replay(ct: dict, layout: GbmLayout, knobs) -> tuple:
    """Totals of one chunk's contacts ``ct`` under one configuration
    ``knobs``: the TPU kernel's ``_replay_config`` -> ``_accumulate``; then
    the bars walked and each path's R (NaN where it did not enter), f32[P]
    in path order."""
    u, iota, ebar, entered = ct["u"], ct["iota"], ct["ebar"], ct["entered"]
    high, low, entry, lvl, is_long = ct["high"], ct["low"], ct["entry"], ct["lvl"], ct["is_long"]
    nb, _, lanes = u.shape
    w = layout.num_bars
    dev = u.device
    after = iota > ebar[:, None]
    stop_slip = tgt_slip = 0.0
    if layout.noise:
        r1_row, a1_row, r2_row, a2_row = layout.noise_rows
        r1 = torch.sqrt(-2.0 * torch.log(u[:, r1_row]))
        a1 = prng.TWO_PI * u[:, a1_row]
        r2 = torch.sqrt(-2.0 * torch.log(u[:, r2_row]))
        a2 = prng.TWO_PI * u[:, a2_row]
        lvl = lvl + r1 * torch.cos(a1) * knobs["lvl_jit"]
        entry = entry + r1 * torch.sin(a1) * knobs["entry_slip"]
        stop_slip = r2 * torch.cos(a2) * knobs["stop_slip"]
        tgt_slip = r2 * torch.sin(a2) * knobs["tgt_slip"]
    sp, tp = knobs["stop_pad"], knobs["tp_pad"]
    stop = torch.where(is_long, lvl - sp, lvl + sp) + stop_slip
    target = torch.where(is_long, lvl + tp, lvl - tp) + tgt_slip

    lg = is_long[:, None]
    stop_hit = torch.where(lg, low <= stop[:, None], high >= stop[:, None])
    tgt_hit = torch.where(lg, high >= target[:, None], low <= target[:, None])
    j_stop = torch.where(after & stop_hit, iota, w).amin(dim=1)
    j_tgt = torch.where(after & tgt_hit, iota, w).amin(dim=1)
    none_hit = (j_stop >= w) & (j_tgt >= w)
    tie = (j_stop == j_tgt) & ~none_hit
    at_hit = iota == torch.clamp(torch.minimum(j_stop, j_tgt), max=w - 1)[:, None]
    hh = torch.where(at_hit, high, 0.0).sum(dim=1)
    ll = torch.where(at_hit, low, 0.0).sum(dim=1)
    up = torch.clamp(hh - entry, min=0.0)
    dn = torch.clamp(entry - ll, min=0.0)
    coin_tp = u[:, layout.tie] < up / (up + dn + 1e-9)
    target_first = torch.where(tie, coin_tp, j_tgt < j_stop)
    risk = torch.clamp((entry - stop).abs(), min=1e-9)
    reward = (target - entry).abs()
    r = torch.where(none_hit, 0.0, torch.where(target_first, reward / risk, -1.0))
    # the kernel's walk: bars to the first hit (else all W), the Box-Muller
    # pairs that takes, and the bars after contact (bridge extremes evaluated)
    walked = torch.where(entered & ~none_hit, torch.minimum(j_stop, j_tgt) + 1, w)

    rr = r[entered]
    counts = torch.zeros(ROW_COUNTS, dtype=torch.int64, device=dev)
    counts[0] = nb * lanes
    counts[1] = entered.sum()
    counts[2] = (entered & ~none_hit & target_first).sum()
    counts[3] = (entered & ~none_hit & ~target_first).sum()
    counts[4] = (entered & none_hit).sum()
    bins = torch.clamp(((rr - HIST_LO) * (HIST_BINS / (HIST_HI - HIST_LO)))
                       .to(torch.int32), 0, HIST_BINS - 1)
    counts[N_COUNTS:] = torch.bincount(bins.to(torch.int64), minlength=HIST_BINS)
    has = rr.numel() > 0
    floats = torch.stack([
        rr.double().sum(), (rr * rr).double().sum(),
        rr.min().double() if has else torch.tensor(_BIG, dtype=torch.float64, device=dev),
        rr.max().double() if has else torch.tensor(-_BIG, dtype=torch.float64, device=dev),
    ])
    return counts, floats, walked, torch.where(entered, r, float("nan")).reshape(-1)


def philox_groups(walked, ebar, entered, w: int):
    """Per path, the Philox4x32-10 calls its uniforms need (``GbmLayout``,
    rows 4j .. 4j + 3 the four words of call j): the distinct groups of four
    rows among its radius rows 0 .. p-1 and angle rows W/2 .. W/2 + p-1 (p =
    min(walked, W/2) Box-Muller pairs) and, after contact at bar ``ebar``,
    its high rows W + t and low rows 2W + t of the bars t it walks on (the
    tie coin and the noise rows not counted)."""
    half = w // 2
    pairs = torch.clamp(walked, max=half)
    post = entered & (walked - 1 > ebar)
    spans = ((0, pairs - 1, pairs > 0), (half, half + pairs - 1, pairs > 0),
             (w + ebar + 1, w + walked - 1, post), (2 * w + ebar + 1, 2 * w + walked - 1, post))
    total = torch.zeros_like(walked)
    last = torch.full_like(walked, -1)          # the last group counted (spans ascend)
    for lo, hi, on in spans:
        g0 = torch.maximum(torch.as_tensor(lo, device=walked.device) // 4, last + 1)
        n = torch.clamp(hi // 4 - g0 + 1, min=0)
        total = total + torch.where(on, n, 0)
        last = torch.where(on, torch.maximum(last, hi // 4), last)
    return total


def _work(ct: dict, walked, w: int):
    """int64 [Box-Muller pairs, bars walked, bars walked after contact,
    Philox calls (``philox_groups``)] of per-path ``walked`` bars (bars to
    the first hit, else all W)."""
    return torch.stack([torch.clamp(walked, max=w // 2).sum(), walked.sum(),
                        torch.where(ct["entered"], walked - ct["ebar"] - 1, 0).sum(),
                        philox_groups(walked, ct["ebar"], ct["entered"], w).sum()])


def _sweep_work(work, row_bars):
    """A sweep's work: ``_work``'s with the bars x rows checked after contact
    before the Philox calls (the Philox calls last, as in ``_work``)."""
    return torch.cat([work[:3], row_bars.view(1), work[3:]])


def _merge_totals(a, b):
    if a is None:
        return b
    fa, fb = a[1], b[1]
    return a[0] + b[0], torch.stack([fa[..., 0] + fb[..., 0], fa[..., 1] + fb[..., 1],
                                     torch.minimum(fa[..., 2], fb[..., 2]),
                                     torch.maximum(fa[..., 3], fb[..., 3])], dim=-1), a[2] + b[2]


def stats_from_totals(counts: torch.Tensor, floats: torch.Tensor) -> PathStats:
    """int64 counts [..., n, entered, tp, stop, open, hist...] and float64
    [..., sum_r, sum_r2, min_r, max_r] → the float32 PathStats
    (``_unpack_acc``), with a leading [G] axis for a sweep's totals.

    Single-trade replay makes the trade and drawdown fields exact
    derivations: every entered path is one trade, and the only negative R is
    a stop's -1, so sum_dd = n_stop and max_dd = max(0, -min_r)."""
    c = counts.to(torch.float32)
    f = floats.to(torch.float32)
    has = c[..., 1] > 0
    inf = float("inf")
    min_r = torch.where(has, f[..., 2], inf)
    return PathStats(
        n=c[..., 0], n_entered=c[..., 1], n_tp=c[..., 2], n_stop=c[..., 3],
        n_open=c[..., 4], sum_r=f[..., 0], sum_r2=f[..., 1], min_r=min_r,
        max_r=torch.where(has, f[..., 3], -inf),
        sum_trades=c[..., 1], sum_dd=c[..., 3],
        max_dd=torch.where(has, torch.clamp(-min_r, min=0.0), 0.0),
        hist=c[..., N_COUNTS:],
    )


def fused_totals_reference(seed, levels: Levels, params, *, num_paths: int,
                           num_bars: int = 40, s0: float = 100.0,
                           mu: float = 0.0, sigma: float = 0.15,
                           dt: float = 1.0 / (390.0 * 252.0),
                           lanes: int = SINGLE_LANES, noise=None,
                           antithetic: bool = False, external_uniforms=None,
                           device=None, chunk_blocks: int = 16,
                           work: bool = False, symbol: int = 0, sampler: str = "gbm",
                           hist_bars=None, tables=None, block_len: int = 10,
                           heston=None, per_path: bool = False):
    """The plain version's (int64 counts, float64 floats) totals, computed on
    ``device`` (default: that of ``external_uniforms``, else the CUDA device)
    in chunks of ``chunk_blocks`` blocks; Philox draws keyed as universe
    symbol ``symbol``; ``sampler`` and its inputs as in ``mc_paths_fused``.
    ``per_path=True`` adds each path's R, f32[P] (NaN where it did not
    enter); ``work=True`` then the kernel's work on these paths, int64
    [Box-Muller pairs, bars walked, bars walked after contact, Philox calls],
    for bounding its time."""
    samp = make_sampler(sampler, hist_bars=hist_bars, tables=tables, block_len=block_len,
                        heston=heston, mu=mu, dt=dt)
    layout = _check(seed, levels, num_paths=num_paths, num_bars=num_bars,
                    lanes=lanes, noise=noise, antithetic=antithetic,
                    external_uniforms=external_uniforms, sampler=samp)
    device = devices.resolve(device, external_uniforms)
    samp = samp.on(device)
    lp, lv = level_slots(levels)
    kn = knobs(params, noise)
    cs = consts(s0, mu, sigma, dt)
    n_blocks = num_paths // lanes
    tot, rs = None, []
    for b0 in range(0, n_blocks, chunk_blocks):
        nb = min(chunk_blocks, n_blocks - b0)
        if external_uniforms is not None:
            u = external_uniforms[b0:b0 + nb].to(device)
        else:
            u = fused_uniforms(seed, layout, block0=b0, n_blocks=nb,
                               lanes=lanes, symbol=symbol, device=device)
        ct = _contact(u, layout, lp, lv, levels.max_levels, kn["prox"], cs, antithetic, samp)
        counts, floats, walked, r = _replay(ct, layout, kn)
        tot = _merge_totals(tot, (counts, floats, _work(ct, walked, num_bars)))
        rs.append(r)
    return tot[:2] + ((torch.cat(rs),) if per_path else ()) + (tot[2:] if work else ())


def mc_paths_fused_reference(seed, levels: Levels, params, **kw) -> PathStats:
    """The plain PyTorch version of ``mc_paths_fused`` (same arguments, plus
    ``chunk_blocks``); runs on ``device`` as ``fused_totals_reference``."""
    return stats_from_totals(*fused_totals_reference(seed, levels, params, **kw))


def sweep_totals_reference(seed, levels: Levels, params, grid_stops, grid_tps, *,
                           num_paths: int, num_bars: int = 40, s0: float = 100.0,
                           mu: float = 0.0, sigma: float = 0.15,
                           dt: float = 1.0 / (390.0 * 252.0),
                           lanes: int = SINGLE_LANES, external_uniforms=None,
                           device=None, chunk_blocks: int = 16, work: bool = False,
                           sampler: str = "gbm", hist_bars=None, tables=None,
                           block_len: int = 10, heston=None, per_path: bool = False):
    """The plain version of the sweep: int64 [G, 133] counts and float64
    [G, 4] floats, each chunk's bars and contacts computed once and replayed
    for every (stop, tp) row; on ``device`` as ``fused_totals_reference``,
    ``sampler`` and its inputs as in ``mc_paths_fused`` (every row on the
    same history).  ``per_path=True`` adds each row's per-path R, f32[G, P]
    (NaN where a path did not enter); ``work=True`` then the sweep kernel's
    work, int64 [Box-Muller pairs, bars walked (to the last row's hit), bars
    walked after contact, bars x rows checked after contact, Philox calls]."""
    samp = make_sampler(sampler, hist_bars=hist_bars, tables=tables, block_len=block_len,
                        heston=heston, mu=mu, dt=dt)
    layout, rows = _check_sweep(seed, levels, params, grid_stops, grid_tps,
                                num_paths=num_paths, num_bars=num_bars, lanes=lanes,
                                external_uniforms=external_uniforms, sampler=samp)
    device = devices.resolve(device, external_uniforms)
    samp = samp.on(device)
    lp, lv = level_slots(levels)
    cs = consts(s0, mu, sigma, dt)
    n_blocks = num_paths // lanes
    tot, rs = None, []
    for b0 in range(0, n_blocks, chunk_blocks):
        nb = min(chunk_blocks, n_blocks - b0)
        if external_uniforms is not None:
            u = external_uniforms[b0:b0 + nb].to(device)
        else:
            u = fused_uniforms(seed, layout, block0=b0, n_blocks=nb, lanes=lanes,
                               device=device)
        ct = _contact(u, layout, lp, lv, levels.max_levels, rows[0]["prox"], cs, False, samp)
        per_row = [_replay(ct, layout, row) for row in rows]
        walked = torch.stack([x[2] for x in per_row]).amax(dim=0)
        row_bars = sum(_work(ct, x[2], num_bars)[2] for x in per_row)
        tot = _merge_totals(tot, (torch.stack([x[0] for x in per_row]),
                                  torch.stack([x[1] for x in per_row]),
                                  _sweep_work(_work(ct, walked, num_bars), row_bars)))
        rs.append(torch.stack([x[3] for x in per_row]))
    return tot[:2] + ((torch.cat(rs, dim=1),) if per_path else ()) + (tot[2:] if work else ())


def _check_universe(seed, levels: Levels, params, s0, sigma, *, paths_per_symbol: int,
                    num_bars: int, lanes: int, external_uniforms, sampler: str = "gbm",
                    hist_bars=None, tables=None, block_len: int = 10, heston=None,
                    dt: float = 1.0 / (390.0 * 252.0)) -> tuple[GbmLayout, list, Sampler]:
    """The checks of ``_mc_paths_pallas_universe_jit`` (pallas_mc.py:947-961)
    and the single kernel's; returns the layout, ``symbol_rows`` and the
    universe's ``Sampler``: each symbol's own recorded history (``hist_bars``
    [S, H] arrays, or [S, 5, H] ``tables``), or Heston's constants shared by
    every symbol at mu 0 (pallas_mc.py:1021)."""
    rows = symbol_rows(levels, s0, sigma, params)
    samp = make_sampler(sampler, hist_bars=hist_bars, tables=tables, block_len=block_len,
                        heston=heston, mu=0.0, dt=dt, symbols=len(rows))
    layout = _check(seed, rows[0][0], num_paths=paths_per_symbol, num_bars=num_bars,
                    lanes=lanes, noise=None, antithetic=False, external_uniforms=None,
                    sampler=samp)
    check_uniforms(external_uniforms, (len(rows), paths_per_symbol // lanes, layout.n_rows,
                                       lanes), antithetic=False, lanes=lanes)
    return layout, rows, samp


def universe_totals_reference(seed, levels: Levels, params, s0, sigma, *,
                              paths_per_symbol: int, num_bars: int = 40,
                              dt: float = 1.0 / (390.0 * 252.0), lanes: int = UNIVERSE_LANES,
                              external_uniforms=None, device=None, chunk_blocks: int = 16,
                              work: bool = False, sampler: str = "gbm", hist_bars=None,
                              tables=None, block_len: int = 10, heston=None,
                              per_path: bool = False):
    """The plain version of the universe: int64 [S, 133] counts and float64
    [S, 4] floats (then f32[S, P] per-path R with ``per_path``, then int64
    [S, 4] work with ``work``), symbol s by
    ``fused_totals_reference`` at its levels, s0, sigma, knobs (``params``
    leaves scalar or [S]), mu 0, its uniforms ``external_uniforms[s]`` or
    its key, and its own history (``_check_universe``); on ``device`` as
    ``fused_totals_reference``."""
    _, rows, samp = _check_universe(
        seed, levels, params, s0, sigma, paths_per_symbol=paths_per_symbol,
        num_bars=num_bars, lanes=lanes, external_uniforms=external_uniforms, sampler=sampler,
        hist_bars=hist_bars, tables=tables, block_len=block_len, heston=heston, dt=dt)
    device = devices.resolve(device, external_uniforms)
    out = [fused_totals_reference(
        seed, lv, p, num_paths=paths_per_symbol, num_bars=num_bars, s0=s0_s, mu=0.0,
        sigma=sg_s, dt=dt, lanes=lanes, symbol=s, device=device, chunk_blocks=chunk_blocks,
        work=work, external_uniforms=symbol_uniforms(external_uniforms, s), sampler=sampler,
        tables=samp.row(s).tables, block_len=block_len, heston=heston, per_path=per_path)
        for s, (lv, s0_s, sg_s, p) in enumerate(rows)]
    return tuple(torch.stack(x) for x in zip(*out))


def reduce_rows_reference(part_counts: torch.Tensor, part_floats: torch.Tensor):
    """Plain version of the pass-2 kernel: partial rows [..., R, C] → totals
    [..., C] (one segment, or one per grid row of a sweep)."""
    f = part_floats.double()
    return part_counts.sum(dim=-2), torch.stack(
        [f[..., 0].sum(-1), f[..., 1].sum(-1), f[..., 2].amin(-1), f[..., 3].amax(-1)],
        dim=-1)


# --------------------------------------------------------------------------
# the kernel wrappers
# --------------------------------------------------------------------------

_BOUND: set[int] = set()


def _library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures set."""
    lib = build.load(_SOURCE)
    if id(lib) not in _BOUND:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.qmmx_mc_args_size.argtypes = []
        lib.qmmx_mc_args_size.restype = ci
        lib.qmmx_cuda_error_string.argtypes = [ci]
        lib.qmmx_cuda_error_string.restype = ctypes.c_char_p
        lib.qmmx_mc_universe_plan.argtypes = [ci, ci, ctypes.POINTER(ctypes.c_int * 4)]
        lib.qmmx_mc_universe_plan.restype = ci
        lib.qmmx_mc_universe.argtypes = [vp, ci, ci, ci, vp, vp, vp, ci, vp]
        lib.qmmx_mc_universe.restype = ci
        lib.qmmx_mc_reduce_rows.argtypes = [vp, vp, ci, ci, vp, vp, vp]
        lib.qmmx_mc_reduce_rows.restype = ci
        if lib.qmmx_mc_args_size() != ctypes.sizeof(_McArgs):
            raise RuntimeError("McArgs layout differs between mc_first_contact.cu and "
                               "cuda_mc.py")
        _BOUND.add(id(lib))
    return lib


def _sweep_library() -> ctypes.CDLL:
    """The gbm sweep kernel's library (``ops/csrc/mc_first_contact_sweep.cu``,
    its own build of ``mc_first_contact.cuh``), built at first use, with its C
    signature set and its struct layouts checked; the first-contact library's
    first (the fold is that library's)."""
    _library()
    lib = build.load(_SWEEP_SOURCE)
    if id(lib) not in _BOUND:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.qmmx_fc_sweep_size.argtypes = [ci]
        lib.qmmx_fc_sweep_size.restype = ci
        lib.qmmx_fc_sweep_plan.argtypes = [ci, ci, ctypes.POINTER(ctypes.c_int * 4)]
        lib.qmmx_fc_sweep_plan.restype = ci
        lib.qmmx_fc_sweep.argtypes = [ctypes.POINTER(_McArgs), ctypes.POINTER(_SweepGrid), ci,
                                      vp, vp, vp, ci, vp]
        lib.qmmx_fc_sweep.restype = ci
        if [lib.qmmx_fc_sweep_size(i) for i in range(2)] != [ctypes.sizeof(_McArgs),
                                                            ctypes.sizeof(_SweepGrid)]:
            raise RuntimeError("McArgs or SweepGrid layout differs between "
                               "mc_first_contact_sweep.cu and cuda_mc.py")
        _BOUND.add(id(lib))
    return lib


def universe_plan(num_bars: int) -> tuple[int, int, int, int]:
    """What a gbm single or universe launch at ``num_bars`` takes, as the
    kernel's launch decides it (``qmmx_mc_universe_plan``): (sine halves a
    thread keeps, the kernel's CTAs an SM, static and dynamic shared memory
    in bytes); it keeps none under ``_FORCE_LONG``."""
    out = (ctypes.c_int * 4)()
    rc = _library().qmmx_mc_universe_plan(num_bars, int(not _FORCE_LONG), ctypes.byref(out))
    _raise_on(rc, "mc_universe")
    return tuple(out)


def sweep_plan(num_bars: int) -> tuple[int, int, int, int]:
    """What a gbm sweep launch at ``num_bars`` takes, as the kernel's launch
    decides it (``qmmx_fc_sweep_plan``): (sine halves a thread keeps, its
    build's CTAs an SM, static and dynamic shared memory in bytes); it keeps
    none under ``_FORCE_LONG``."""
    out = (ctypes.c_int * 4)()
    rc = _sweep_library().qmmx_fc_sweep_plan(num_bars, int(not _FORCE_LONG), ctypes.byref(out))
    _raise_on(rc, "mc_sweep")
    return tuple(out)


def _sampler_library() -> ctypes.CDLL:
    """The sampler kernels' library (``ops/csrc/mc_first_contact_samplers.cu``,
    its own build of ``mc_first_contact.cuh``), built at first use, with its
    C signature set; the first-contact library's struct-layout check first."""
    _library()
    lib = build.load(_SAMPLER_SOURCE)
    if id(lib) not in _BOUND:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.qmmx_sampler_args_size.argtypes = []
        lib.qmmx_sampler_args_size.restype = ci
        lib.qmmx_mc_sampler.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, ci, vp]
        lib.qmmx_mc_sampler.restype = ci
        if lib.qmmx_sampler_args_size() != ctypes.sizeof(SamplerArgs):
            raise RuntimeError("SamplerArgs layout differs between sampler.cuh and "
                               "kernel_args.SamplerArgs")
        _BOUND.add(id(lib))
    return lib


def _sampler_sweep_library() -> ctypes.CDLL:
    """The sampler sweep kernel's library
    (``ops/csrc/mc_first_contact_sampler_sweep.cu``, its own build of
    ``mc_first_contact.cuh``), built at first use, with its C signature set
    and its struct layouts checked; the first-contact library's first (the
    fold is that library's)."""
    _library()
    lib = build.load(_SAMPLER_SWEEP_SOURCE)
    if id(lib) not in _BOUND:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.qmmx_sampler_sweep_struct_size.argtypes = [ci]
        lib.qmmx_sampler_sweep_struct_size.restype = ci
        lib.qmmx_mc_sampler_sweep.argtypes = [vp, vp, ctypes.POINTER(_SweepGrid), ci, ci, vp,
                                              vp, vp, ci, vp]
        lib.qmmx_mc_sampler_sweep.restype = ci
        sizes = [lib.qmmx_sampler_sweep_struct_size(i) for i in range(3)]
        if sizes != [ctypes.sizeof(_McArgs), ctypes.sizeof(SamplerArgs),
                     ctypes.sizeof(_SweepGrid)]:
            raise RuntimeError("McArgs, SamplerArgs or SweepGrid layout differs between "
                               "mc_first_contact_sampler_sweep.cu and cuda_mc.py")
        _BOUND.add(id(lib))
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().qmmx_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _launch_args(seed, levels: Levels, params, layout: GbmLayout, *, num_paths: int,
                 num_bars: int, s0, mu, sigma, dt, lanes: int, noise, antithetic,
                 external_uniforms, device: torch.device, what: str, symbol: int = 0):
    """The launch checks of pass 1, and (McArgs, injected-uniform pointer);
    the Philox key is universe symbol ``symbol``'s."""
    ext_ptr = launch_pointer(num_paths, num_bars, external_uniforms, device, what)
    lp, lv = level_slots(levels)
    drift, sig_dt, log_s0 = consts(s0, mu, sigma, dt)
    args = _McArgs(
        num_paths=num_paths,
        level_price=(ctypes.c_float * MAX_LEVELS)(*lp),
        level_valid=(ctypes.c_float * MAX_LEVELS)(*lv),
        drift=drift, sig_dt=sig_dt, log_s0=log_s0,
        seed=int(seed), stream=prng.stream_key(FUSED_STREAM, symbol),
        max_levels=levels.max_levels, num_bars=num_bars, lanes=lanes,
        n_rows=layout.n_rows, use_noise=int(noise is not None),
        antithetic=int(bool(antithetic)),
        **knobs(params, noise),
    )
    return args, ext_ptr


def _launch(args, num_bars: int, *, num_paths: int, ext_ptr, device: torch.device,
            what: str):
    """One launch of ``mc_universe_kernel`` over the argument structs ``args``
    (one per symbol), counted in ``LAUNCHES[what]``, or where its plan draws
    pairs again for their sine halves (``universe_plan``: past 48 bars, or
    under ``_FORCE_LONG``, which keeps none) in ``LAUNCHES[what + "_long"]``:
    int64 [S, grid, 133] and f32 [S, grid, 4] partial rows, one per (symbol,
    CTA)."""
    args_dev = device_rows(args, device)
    n, ctas = len(args), grid_size(num_paths)
    part_counts = torch.empty((n, ctas, ROW_COUNTS), dtype=torch.int64, device=device)
    part_floats = torch.empty((n, ctas, ROW_FLOATS), dtype=torch.float32, device=device)
    if 2 * universe_plan(num_bars)[0] != num_bars:
        what = what + "_long"
    rc = _library().qmmx_mc_universe(
        args_dev.data_ptr(), n, num_bars, int(not _FORCE_LONG), ext_ptr, part_counts.data_ptr(),
        part_floats.data_ptr(), ctas, torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, what)
    LAUNCHES[what] += 1
    return part_counts, part_floats


def first_contact_rows(seed, levels: Levels, params, *, num_paths: int,
                       num_bars: int, s0: float, mu: float, sigma: float,
                       dt: float, lanes: int, noise, antithetic: bool,
                       external_uniforms, device: torch.device, symbol: int = 0,
                       sampler: str = "gbm", hist_bars=None, tables=None,
                       block_len: int = 10, heston=None):
    """Launch pass 1 on a CUDA device (the universe kernel at one symbol, or
    for the other samplers ``mc_first_contact_sampler_kernel``): int64 [grid, 133] count
    rows and f32 [grid, 4] float rows, one row per CTA; Philox keyed as
    universe symbol ``symbol``; ``sampler`` and its inputs as in
    ``mc_paths_fused``."""
    samp = make_sampler(sampler, hist_bars=hist_bars, tables=tables, block_len=block_len,
                        heston=heston, mu=mu, dt=dt)
    if samp.kind != "gbm":
        if antithetic:
            raise ValueError("kernel antithetic pairs gbm normals only")
        return _sampler_rows(seed, levels, params, num_paths=num_paths, num_bars=num_bars,
                             s0=s0, mu=mu, sigma=sigma, dt=dt, lanes=lanes, noise=noise,
                             sampler=samp, external_uniforms=external_uniforms,
                             device=device, symbol=symbol)
    layout = _check(seed, levels, num_paths=num_paths, num_bars=num_bars,
                    lanes=lanes, noise=noise, antithetic=antithetic,
                    external_uniforms=external_uniforms)
    args, ext_ptr = _launch_args(
        seed, levels, params, layout, num_paths=num_paths, num_bars=num_bars, s0=s0,
        mu=mu, sigma=sigma, dt=dt, lanes=lanes, noise=noise, antithetic=antithetic,
        external_uniforms=external_uniforms, device=device, what="first_contact_rows",
        symbol=symbol)
    return tuple(x[0] for x in _launch((_McArgs * 1)(args), num_bars, num_paths=num_paths,
                                       ext_ptr=ext_ptr, device=device,
                                       what="mc_first_contact"))


SAMPLER_KINDS = {"bootstrap": 1, "block_bootstrap": 1, "heston": 3}   # sampler.cuh


def _sampler_rows(seed, levels: Levels, params, *, num_paths: int, num_bars: int, s0: float,
                  mu: float, sigma: float, dt: float, lanes: int, noise, sampler: Sampler,
                  external_uniforms, device: torch.device, symbol: int = 0):
    """Launch pass 1 of a bootstrap, block-bootstrap or Heston run on a CUDA
    device (``mc_first_contact_sampler_kernel`` at one row): int64 [grid,
    133] count rows and f32 [grid, 4] float rows, one row per CTA."""
    layout = _check(seed, levels, num_paths=num_paths, num_bars=num_bars, lanes=lanes,
                    noise=noise, antithetic=False, external_uniforms=external_uniforms,
                    sampler=sampler)
    args, ext_ptr = _launch_args(
        seed, levels, params, layout, num_paths=num_paths, num_bars=num_bars, s0=s0,
        mu=mu, sigma=sigma, dt=dt, lanes=lanes, noise=noise, antithetic=False,
        external_uniforms=external_uniforms, device=device, what="sampler_rows",
        symbol=symbol)
    return tuple(x[0] for x in _sampler_launch(
        (_McArgs * 1)(args), sampler, num_bars, num_paths=num_paths, ext_ptr=ext_ptr,
        device=device, what="mc_first_contact_sampler"))


def _sampler_launch(args, sampler: Sampler, num_bars: int, *, num_paths: int, ext_ptr,
                    device: torch.device, what: str, table_rows=None):
    """One launch of ``mc_first_contact_sampler_kernel`` over the argument
    structs ``args`` (one per row) under ``sampler``, row r reading table
    ``table_rows[r]`` (default: the one history), counted in
    ``LAUNCHES[what]``: int64 [R, grid, 133] and f32 [R, grid, 4] partial
    rows, one per (row, CTA)."""
    n, ctas = len(args), grid_size(num_paths)
    args_dev = device_rows(args, device)
    samp_dev, _tables = sampler_args(sampler, device, [0] * n if table_rows is None
                                     else table_rows)
    part_counts = torch.empty((n, ctas, ROW_COUNTS), dtype=torch.int64, device=device)
    part_floats = torch.empty((n, ctas, ROW_FLOATS), dtype=torch.float32, device=device)
    rc = _sampler_library().qmmx_mc_sampler(
        args_dev.data_ptr(), samp_dev.data_ptr(), n, SAMPLER_KINDS[sampler.kind], num_bars,
        ext_ptr, part_counts.data_ptr(), part_floats.data_ptr(), ctas,
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, what)
    LAUNCHES[what] += 1
    return part_counts, part_floats


def _sweep_grids(stops, tps):
    """The (first row, ``_SweepGrid``) of each launch of a sweep: SWEEP_ROWS
    grid rows a launch."""
    for g0 in range(0, len(stops), SWEEP_ROWS):
        sp, tp = stops[g0:g0 + SWEEP_ROWS], tps[g0:g0 + SWEEP_ROWS]
        pad = [0.0] * (SWEEP_ROWS - len(sp))
        yield g0, _SweepGrid(n_rows=len(sp), stop_pad=(ctypes.c_float * SWEEP_ROWS)(*sp, *pad),
                             tp_pad=(ctypes.c_float * SWEEP_ROWS)(*tp, *pad))


def sweep_rows(seed, levels: Levels, params, grid_stops, grid_tps, *, num_paths: int,
               num_bars: int, s0: float, mu: float, sigma: float, dt: float,
               lanes: int, external_uniforms, device: torch.device, sampler: str = "gbm",
               hist_bars=None, tables=None, block_len: int = 10, heston=None):
    """Launch the sweep's pass 1 on a CUDA device: int64 [G, grid, 133] count
    rows and f32 [G, grid, 4] float rows, one row per (grid row, CTA), one
    launch per SWEEP_ROWS grid rows: under gbm of
    ``mc_first_contact_sweep_kernel`` (counted as ``mc_sweep``, or as
    ``mc_sweep_long`` where it draws pairs again for their sine halves: past
    ``MAX_HALF_BARS``, or under ``_FORCE_LONG``), under the other samplers
    of ``mc_first_contact_sampler_sweep_kernel`` (counted as
    ``mc_sweep_sampler``); each walks a path's bars once for every row of its
    launch."""
    samp = make_sampler(sampler, hist_bars=hist_bars, tables=tables, block_len=block_len,
                        heston=heston, mu=mu, dt=dt)
    layout, rows = _check_sweep(seed, levels, params, grid_stops, grid_tps,
                                num_paths=num_paths, num_bars=num_bars, lanes=lanes,
                                external_uniforms=external_uniforms, sampler=samp)
    stops, tps = [r["stop_pad"] for r in rows], [r["tp_pad"] for r in rows]
    args, ext_ptr = _launch_args(
        seed, levels, params, layout, num_paths=num_paths, num_bars=num_bars, s0=s0,
        mu=mu, sigma=sigma, dt=dt, lanes=lanes, noise=None, antithetic=False,
        external_uniforms=external_uniforms, device=device, what="sweep_rows")
    g, ctas = len(stops), grid_size(num_paths)
    part_counts = torch.empty((g, ctas, ROW_COUNTS), dtype=torch.int64, device=device)
    part_floats = torch.empty((g, ctas, ROW_FLOATS), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    if samp.kind != "gbm":
        what, lib = "mc_sweep_sampler", _sampler_sweep_library()
        args_dev = device_rows((_McArgs * 1)(args), device)
        samp_dev, _tables = sampler_args(samp, device)
        for g0, grid in _sweep_grids(stops, tps):
            rc = lib.qmmx_mc_sampler_sweep(
                args_dev.data_ptr(), samp_dev.data_ptr(), ctypes.byref(grid),
                SAMPLER_KINDS[samp.kind], num_bars, ext_ptr, part_counts[g0].data_ptr(),
                part_floats[g0].data_ptr(), ctas, stream)
            _raise_on(rc, what)
            LAUNCHES[what] += 1
        return part_counts, part_floats
    what = "mc_sweep" if 2 * sweep_plan(num_bars)[0] == num_bars else "mc_sweep_long"
    lib = _sweep_library()
    for g0, grid in _sweep_grids(stops, tps):
        rc = lib.qmmx_fc_sweep(ctypes.byref(args), ctypes.byref(grid), int(not _FORCE_LONG),
                               ext_ptr, part_counts[g0].data_ptr(), part_floats[g0].data_ptr(),
                               ctas, stream)
        _raise_on(rc, what)
        LAUNCHES[what] += 1
    return part_counts, part_floats


def universe_rows(seed, levels: Levels, params, s0, sigma, *, paths_per_symbol: int,
                  num_bars: int, dt: float, lanes: int, external_uniforms,
                  device: torch.device, sampler: str = "gbm", hist_bars=None, tables=None,
                  block_len: int = 10, heston=None):
    """Launch the universe's pass 1 on a CUDA device, one launch for all S
    symbols (``mc_universe_kernel``, or under the other samplers
    ``mc_first_contact_sampler_kernel`` with row s reading symbol s's
    history): int64 [S, grid, 133] and f32 [S, grid, 4] partial rows, one
    per (symbol, CTA)."""
    layout, rows, samp = _check_universe(
        seed, levels, params, s0, sigma, paths_per_symbol=paths_per_symbol,
        num_bars=num_bars, lanes=lanes, external_uniforms=external_uniforms, sampler=sampler,
        hist_bars=hist_bars, tables=tables, block_len=block_len, heston=heston, dt=dt)
    device = torch.device(device)
    ext_ptr = launch_pointer(paths_per_symbol, num_bars, external_uniforms, device,
                             "universe_rows")
    per_symbol = paths_per_symbol * layout.n_rows     # injected uniforms of one symbol
    args = (_McArgs * len(rows))()
    for s, (lv, s0_s, sg_s, p) in enumerate(rows):
        args[s], _ = _launch_args(
            seed, lv, p, layout, num_paths=paths_per_symbol, num_bars=num_bars, s0=s0_s,
            mu=0.0, sigma=sg_s, dt=dt, lanes=lanes, noise=None, antithetic=False,
            external_uniforms=None, device=device, what="universe_rows", symbol=s)
        args[s].ext_offset = s * per_symbol
    if samp.kind != "gbm":
        return _sampler_launch(args, samp, num_bars, num_paths=paths_per_symbol,
                               ext_ptr=ext_ptr, device=device, what="mc_universe_sampler",
                               table_rows=samp.table_rows(len(rows)))
    return _launch(args, num_bars, num_paths=paths_per_symbol, ext_ptr=ext_ptr,
                   device=device, what="mc_universe")


def reduce_rows(part_counts: torch.Tensor, part_floats: torch.Tensor, what=None):
    """Pass 2: partial rows [R, ...] → (int64 [133] counts, float64 [4]
    floats), or a sweep's (or universe's) [G, R, ...] → ([G, 133], [G, 4]) in
    one launch, one CTA per grid row, counted under ``what`` when given.
    CUDA tensors go through the kernel, CPU tensors through the plain
    version."""
    if part_counts.device.type == "cpu" and part_floats.device.type == "cpu":
        return reduce_rows_reference(part_counts, part_floats)
    return fold_rows(_library().qmmx_mc_reduce_rows, _raise_on, part_counts, part_floats,
                     (ROW_COUNTS, ROW_FLOATS), "mc", LAUNCHES, what)


def mc_paths_fused(seed, levels: Levels, params, *, num_paths: int,
                   num_bars: int = 40, s0: float = 100.0, mu: float = 0.0,
                   sigma: float = 0.15, dt: float = 1.0 / (390.0 * 252.0),
                   lanes: int = SINGLE_LANES, noise=None,
                   antithetic: bool = False, external_uniforms=None,
                   device=None, symbol: int = 0, sampler: str = "gbm", hist_bars=None,
                   tables=None, block_len: int = 10, heston=None) -> PathStats:
    """Fused first-contact MC, the counterpart of ``mc_paths_pallas``: the
    same PathStats contract as ``sim.pathsim.mc_paths``, with the McNoise
    execution-noise knobs and antithetic lane pairs (gbm); ``symbol`` keys
    the draws as universe symbol ``symbol`` (0: the single run).
    ``sampler`` "bootstrap" and "block_bootstrap" resample the recorded bars
    of ``hist_bars`` (a PathBars of 1-D o/h/l/c arrays) or of their
    ``ops/pathgen.bootstrap_tables`` given as ``tables`` (float32 [5, H]),
    the latter in runs of ``block_len`` bars; "heston" generates Heston bars
    (``heston``: a dict of v0/kappa/theta/xi/rho, the rest the JAX defaults);
    injected uniforms then follow ``ops/draws.GbmLayout``'s layout for the
    sampler.

    ``device`` (default: that of ``external_uniforms``, else the CUDA device,
    which raises where there is none) picks the path: a CUDA device launches
    the kernel or raises; the CPU runs the plain version.  Draws agree with
    ``sim.pathsim.mc_paths`` statistically, not bitwise (different stream
    layouts)."""
    samp = make_sampler(sampler, hist_bars=hist_bars, tables=tables, block_len=block_len,
                        heston=heston, mu=mu, dt=dt)
    _check(seed, levels, num_paths=num_paths, num_bars=num_bars, lanes=lanes,
           noise=noise, antithetic=antithetic,
           external_uniforms=external_uniforms, sampler=samp)
    device = devices.resolve(device, external_uniforms)
    kw = dict(num_paths=num_paths, num_bars=num_bars, s0=s0, mu=mu,
              sigma=sigma, dt=dt, lanes=lanes, noise=noise,
              external_uniforms=external_uniforms, symbol=symbol)
    kw.update(antithetic=antithetic, sampler=sampler, tables=samp.tables,
              block_len=block_len, heston=heston)
    if device.type == "cpu":
        return mc_paths_fused_reference(seed, levels, params, device=device, **kw)
    rows = first_contact_rows(seed, levels, params, device=device, **kw)
    return stats_from_totals(*reduce_rows(*rows))


def mc_paths_sweep_fused(seed, levels: Levels, params, grid_stops, grid_tps, *,
                         num_paths: int, num_bars: int = 40, s0: float = 100.0,
                         mu: float = 0.0, sigma: float = 0.15,
                         dt: float = 1.0 / (390.0 * 252.0), lanes: int = SINGLE_LANES,
                         device=None, external_uniforms=None, sampler: str = "gbm",
                         hist_bars=None, tables=None, block_len: int = 10,
                         heston=None) -> PathStats:
    """Fused first-contact grid sweep, the counterpart of
    ``mc_paths_pallas_sweep``: [G] PathStats, row g for (grid_stops[g],
    grid_tps[g]) with the other knobs of ``params``, every row over the same
    paths (CRN); row g equals ``mc_paths_fused`` with those paddings at the
    same seed, bit for bit.  ``sampler`` and its inputs as in
    ``mc_paths_fused`` (every row resamples the same history, or walks the
    same Heston bars; Heston at the caller's ``mu``).  ``device`` as in
    ``mc_paths_fused``."""
    samp = make_sampler(sampler, hist_bars=hist_bars, tables=tables, block_len=block_len,
                        heston=heston, mu=mu, dt=dt)
    _check_sweep(seed, levels, params, grid_stops, grid_tps, num_paths=num_paths,
                 num_bars=num_bars, lanes=lanes, external_uniforms=external_uniforms,
                 sampler=samp)
    device = devices.resolve(device, external_uniforms)
    kw = dict(num_paths=num_paths, num_bars=num_bars, s0=s0, mu=mu, sigma=sigma, dt=dt,
              lanes=lanes, external_uniforms=external_uniforms, sampler=sampler,
              tables=samp.tables, block_len=block_len, heston=heston)
    if device.type == "cpu":
        return stats_from_totals(*sweep_totals_reference(
            seed, levels, params, grid_stops, grid_tps, device=device, **kw))
    rows = sweep_rows(seed, levels, params, grid_stops, grid_tps, device=device, **kw)
    return stats_from_totals(*reduce_rows(*rows))


def mc_paths_universe_fused(seed, levels: Levels, params, s0, sigma, *,
                            paths_per_symbol: int, num_bars: int = 40,
                            dt: float = 1.0 / (390.0 * 252.0), lanes: int = UNIVERSE_LANES,
                            external_uniforms=None, device=None, sampler: str = "gbm",
                            hist_bars=None, tables=None, block_len: int = 10,
                            heston=None) -> PathStats:
    """Fused per-symbol first-contact universe, the counterpart of
    ``mc_paths_pallas_universe``: [S] PathStats, symbol s under its own
    [S, L] levels row, s0[s], sigma[s], knobs (``params`` leaves scalar or
    [S]: prox, stop and tp paddings) and key; drift, sig_dt and log_s0 per
    symbol in float64 on the host, mu 0.  ``sampler`` "bootstrap" and
    "block_bootstrap" resample each symbol's own recorded bars (``hist_bars``
    a PathBars of [S, H] o/h/l/c arrays, or their [S, 5, H]
    ``ops/pathgen.universe_tables`` as ``tables``), rebased on its s0;
    "heston" shares ``heston`` across symbols (mu 0).  Row s equals
    ``mc_paths_fused`` at those inputs (its own history) with ``symbol=s``
    bit for bit; injected uniforms are f32[S, paths_per_symbol / lanes,
    n_rows, lanes] (``ops/draws.GbmLayout``).  ``device`` as in
    ``mc_paths_fused``."""
    kw = dict(paths_per_symbol=paths_per_symbol, num_bars=num_bars, lanes=lanes,
              external_uniforms=external_uniforms, sampler=sampler, hist_bars=hist_bars,
              tables=tables, block_len=block_len, heston=heston, dt=dt)
    _, _, samp = _check_universe(seed, levels, params, s0, sigma, **kw)
    kw.update(hist_bars=None, tables=samp.tables)
    device = devices.resolve(device, external_uniforms)
    if device.type == "cpu":
        return stats_from_totals(*universe_totals_reference(
            seed, levels, params, s0, sigma, device=device, **kw))
    rows = universe_rows(seed, levels, params, s0, sigma, device=device, **kw)
    what = "mc_universe_reduce_rows"
    return stats_from_totals(*reduce_rows(*rows, what=what))
