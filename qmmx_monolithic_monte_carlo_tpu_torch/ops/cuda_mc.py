"""Fused first-contact Monte Carlo: generate → replay → reduce, as one CUDA kernel.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:57-821``
(kernel #1, ``_mc_kernel``, and its entry ``mc_paths_pallas``), gbm sampler
only; the bootstrap, block-bootstrap and Heston branches are not ported yet.

* ``mc_paths_fused`` — the entry.  For a CUDA device it launches
  ``ops/csrc/mc_first_contact.cu`` (pass 1: one thread per path, one partial
  row per CTA; pass 2: a fixed-order fold of the rows) or raises.  For the CPU
  it runs the plain version.
* ``mc_paths_fused_reference`` — the plain PyTorch version: the TPU kernel's
  block computation, vectorised over (block, bar, lane) tensors.
* ``LAUNCHES`` — how many times each kernel was launched.

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
from .draws import FUSED_STREAM, GbmLayout, fused_uniforms
from .kernel_args import MAX_LEVELS, consts, f32, grid_size, knobs, level_slots
from .pathgen import cumsum_f32

SINGLE_LANES = 8192      # logical paths per block (the TPU kernel's default)
MAX_KERNEL_BARS = 128    # the kernel keeps W/2 sine normals in registers
N_COUNTS = 5             # n, entered, tp, stop, open
ROW_COUNTS = N_COUNTS + HIST_BINS
ROW_FLOATS = 4           # sum_r, sum_r2, min_r, max_r
_BIG = 3.4e38            # empty min/max sentinel, as the TPU kernel's
_SOURCE = "mc_first_contact"

# Kernel launches, counted by the wrappers where they launch and nowhere else.
LAUNCHES = {"mc_first_contact": 0, "mc_reduce_rows": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class _McArgs(ctypes.Structure):
    """Mirror of ``struct McArgs`` in ops/csrc/mc_first_contact.cu."""

    _fields_ = [
        ("num_paths", ctypes.c_int64),
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


def _check(seed, levels, *, num_paths, num_bars, lanes, noise, antithetic,
           external_uniforms) -> GbmLayout:
    """The checks of ``_mc_paths_pallas_jit`` (pallas_mc.py:724-738)."""
    prng.check_seed(seed)
    if lanes <= 0 or num_paths <= 0 or num_paths % lanes != 0:
        raise ValueError(f"num_paths must be a positive multiple of {lanes}")
    layout = GbmLayout(num_bars, noise is not None)
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


# --------------------------------------------------------------------------
# the plain PyTorch version
# --------------------------------------------------------------------------

def _chunk_totals(u, layout: GbmLayout, lp, lv, n_levels, knobs, consts,
                  antithetic):
    """Totals of one chunk of blocks, u f32[nb, n_rows, lanes]: the TPU
    kernel's block computation (``_gbm_block`` → ``_first_contact`` →
    ``_replay_config`` → ``_accumulate``), with a serial float32 cumsum."""
    nb, _, lanes = u.shape
    w = layout.num_bars
    dev = u.device
    drift, sig_dt, log_s0 = consts
    rad = torch.sqrt(-2.0 * torch.log(u[:, layout.u1]))
    ang = prng.TWO_PI * u[:, layout.u2]
    z = torch.cat([rad * torch.cos(ang), rad * torch.sin(ang)], dim=1)
    if antithetic:
        zh = z[..., :lanes // 2]
        z = torch.cat([zh, -zh], dim=-1)
    incr = drift + sig_dt * z                              # [nb, W, lanes]
    log_close = log_s0 + cumsum_f32(incr, dim=1)
    log_open = log_close - incr
    close = torch.exp(log_close)
    opens = torch.exp(log_open)
    sig2dt = f32(np.float32(sig_dt) * np.float32(sig_dt))
    two_s2 = f32(np.float32(2.0) * np.float32(sig2dt))
    diff = log_close - log_open
    d2 = diff * diff
    mid = log_open + log_close
    high = torch.exp(0.5 * (mid + torch.sqrt(d2 - two_s2 * torch.log(u[:, layout.u3]))))
    low = torch.exp(0.5 * (mid - torch.sqrt(d2 - two_s2 * torch.log(u[:, layout.u4]))))

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
    near = best_d <= knobs["prox"]
    iota = torch.arange(w, device=dev).view(1, w, 1)
    ebar = torch.where(near, iota, w).amin(dim=1)          # [nb, lanes]
    entered = ebar < w
    at_entry = iota == ebar[:, None]
    entry = torch.where(at_entry, close, 0.0).sum(dim=1)
    lvl = torch.where(at_entry, best_p, 0.0).sum(dim=1)
    is_long = entry > torch.where(at_entry, opens, 0.0).sum(dim=1)
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
    work = torch.stack([torch.clamp(walked, max=w // 2).sum(), walked.sum(),
                        torch.where(entered, walked - ebar - 1, 0).sum()])

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
    return counts, floats, work


def _merge_totals(a, b):
    if a is None:
        return b
    fa, fb = a[1], b[1]
    return a[0] + b[0], torch.stack([fa[0] + fb[0], fa[1] + fb[1],
                                     torch.minimum(fa[2], fb[2]),
                                     torch.maximum(fa[3], fb[3])]), a[2] + b[2]


def stats_from_totals(counts: torch.Tensor, floats: torch.Tensor) -> PathStats:
    """int64 counts [n, entered, tp, stop, open, hist...] and float64
    [sum_r, sum_r2, min_r, max_r] → the float32 PathStats (``_unpack_acc``).

    Single-trade replay makes the trade and drawdown fields exact
    derivations: every entered path is one trade, and the only negative R is
    a stop's -1, so sum_dd = n_stop and max_dd = max(0, -min_r)."""
    c = counts.to(torch.float32)
    f = floats.to(torch.float32)
    has = c[1] > 0
    inf = float("inf")
    min_r = torch.where(has, f[2], inf)
    return PathStats(
        n=c[0], n_entered=c[1], n_tp=c[2], n_stop=c[3], n_open=c[4],
        sum_r=f[0], sum_r2=f[1], min_r=min_r,
        max_r=torch.where(has, f[3], -inf),
        sum_trades=c[1], sum_dd=c[3],
        max_dd=torch.where(has, torch.clamp(-min_r, min=0.0), 0.0),
        hist=c[N_COUNTS:],
    )


def fused_totals_reference(seed, levels: Levels, params, *, num_paths: int,
                           num_bars: int = 40, s0: float = 100.0,
                           mu: float = 0.0, sigma: float = 0.15,
                           dt: float = 1.0 / (390.0 * 252.0),
                           lanes: int = SINGLE_LANES, noise=None,
                           antithetic: bool = False, external_uniforms=None,
                           device=None, chunk_blocks: int = 16,
                           work: bool = False):
    """The plain version's (int64 counts, float64 floats) totals, computed on
    ``device`` (default: that of ``external_uniforms``, else the CUDA device)
    in chunks of ``chunk_blocks`` blocks.  ``work=True`` adds the kernel's
    work on these paths, int64 [Box-Muller pairs, bars walked, bars walked
    after contact], for bounding its time."""
    layout = _check(seed, levels, num_paths=num_paths, num_bars=num_bars,
                    lanes=lanes, noise=noise, antithetic=antithetic,
                    external_uniforms=external_uniforms)
    device = devices.resolve(device, external_uniforms)
    lp, lv = level_slots(levels)
    kn = knobs(params, noise)
    cs = consts(s0, mu, sigma, dt)
    n_blocks = num_paths // lanes
    tot = None
    for b0 in range(0, n_blocks, chunk_blocks):
        nb = min(chunk_blocks, n_blocks - b0)
        if external_uniforms is not None:
            u = external_uniforms[b0:b0 + nb].to(device)
        else:
            u = fused_uniforms(seed, layout, block0=b0, n_blocks=nb,
                               lanes=lanes, device=device)
        tot = _merge_totals(tot, _chunk_totals(
            u, layout, lp, lv, levels.max_levels, kn, cs, antithetic))
    return tot if work else tot[:2]


def mc_paths_fused_reference(seed, levels: Levels, params, **kw) -> PathStats:
    """The plain PyTorch version of ``mc_paths_fused`` (same arguments, plus
    ``chunk_blocks``); runs on ``device`` as ``fused_totals_reference``."""
    return stats_from_totals(*fused_totals_reference(seed, levels, params, **kw))


def reduce_rows_reference(part_counts: torch.Tensor, part_floats: torch.Tensor):
    """Plain version of the pass-2 kernel: partial rows → totals."""
    f = part_floats.double()
    return part_counts.sum(dim=0), torch.stack(
        [f[:, 0].sum(), f[:, 1].sum(), f[:, 2].min(), f[:, 3].max()])


# --------------------------------------------------------------------------
# the kernel wrappers
# --------------------------------------------------------------------------

_BOUND: set[int] = set()


def _library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures set."""
    lib = build.load(_SOURCE)
    if id(lib) not in _BOUND:
        vp = ctypes.c_void_p
        lib.qmmx_mc_args_size.argtypes = []
        lib.qmmx_mc_args_size.restype = ctypes.c_int
        lib.qmmx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.qmmx_cuda_error_string.restype = ctypes.c_char_p
        lib.qmmx_mc_first_contact.argtypes = [
            ctypes.POINTER(_McArgs), vp, vp, vp, ctypes.c_int, vp]
        lib.qmmx_mc_first_contact.restype = ctypes.c_int
        lib.qmmx_mc_reduce_rows.argtypes = [vp, vp, ctypes.c_int, vp, vp, vp]
        lib.qmmx_mc_reduce_rows.restype = ctypes.c_int
        if lib.qmmx_mc_args_size() != ctypes.sizeof(_McArgs):
            raise RuntimeError("McArgs layout differs between "
                               "mc_first_contact.cu and cuda_mc._McArgs")
        _BOUND.add(id(lib))
    return lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.qmmx_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def first_contact_rows(seed, levels: Levels, params, *, num_paths: int,
                       num_bars: int, s0: float, mu: float, sigma: float,
                       dt: float, lanes: int, noise, antithetic: bool,
                       external_uniforms, device: torch.device):
    """Launch pass 1 on a CUDA device: int64 [grid, 133] count rows and f32
    [grid, 4] float rows, one row per CTA."""
    layout = _check(seed, levels, num_paths=num_paths, num_bars=num_bars,
                    lanes=lanes, noise=noise, antithetic=antithetic,
                    external_uniforms=external_uniforms)
    if device.type != "cuda":
        raise ValueError("first_contact_rows launches the CUDA kernel; "
                         f"got device {device}")
    if num_bars > MAX_KERNEL_BARS:
        raise ValueError(f"the CUDA kernel takes num_bars <= {MAX_KERNEL_BARS}")
    if num_paths >= 1 << 40:
        raise ValueError("num_paths must be below 2^40 (per-CTA uint32 counts)")
    ext_ptr = None
    if external_uniforms is not None:
        if not external_uniforms.is_contiguous():
            raise ValueError("external_uniforms must be contiguous")
        ext_ptr = external_uniforms.data_ptr()
    lp, lv = level_slots(levels)
    drift, sig_dt, log_s0 = consts(s0, mu, sigma, dt)
    args = _McArgs(
        num_paths=num_paths,
        level_price=(ctypes.c_float * MAX_LEVELS)(*lp),
        level_valid=(ctypes.c_float * MAX_LEVELS)(*lv),
        drift=drift, sig_dt=sig_dt, log_s0=log_s0,
        seed=int(seed), stream=FUSED_STREAM,
        max_levels=levels.max_levels, num_bars=num_bars, lanes=lanes,
        n_rows=layout.n_rows, use_noise=int(noise is not None),
        antithetic=int(bool(antithetic)),
        **knobs(params, noise),
    )
    grid = grid_size(num_paths)
    part_counts = torch.empty((grid, ROW_COUNTS), dtype=torch.int64, device=device)
    part_floats = torch.empty((grid, ROW_FLOATS), dtype=torch.float32, device=device)
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.qmmx_mc_first_contact(ctypes.byref(args), ext_ptr,
                                   part_counts.data_ptr(),
                                   part_floats.data_ptr(), grid, stream)
    _raise_on(lib, rc, "mc_first_contact")
    LAUNCHES["mc_first_contact"] += 1
    return part_counts, part_floats


def reduce_rows(part_counts: torch.Tensor, part_floats: torch.Tensor):
    """Pass 2: partial rows → (int64 [133] counts, float64 [4] floats).  CUDA
    tensors go through the kernel, CPU tensors through the plain version."""
    if part_counts.device.type == "cpu" and part_floats.device.type == "cpu":
        return reduce_rows_reference(part_counts, part_floats)
    if (part_counts.device != part_floats.device
            or part_counts.device.type != "cuda"):
        raise ValueError("part_counts and part_floats must lie on one CUDA device")
    rows = part_counts.shape[0]
    if (part_counts.dtype != torch.int64 or part_floats.dtype != torch.float32
            or tuple(part_counts.shape) != (rows, ROW_COUNTS)
            or tuple(part_floats.shape) != (rows, ROW_FLOATS)
            or not part_counts.is_contiguous() or not part_floats.is_contiguous()):
        raise ValueError(f"partial rows must be contiguous int64 [R, {ROW_COUNTS}] "
                         f"and float32 [R, {ROW_FLOATS}]")
    dev = part_counts.device
    tot_counts = torch.empty((ROW_COUNTS,), dtype=torch.int64, device=dev)
    tot_floats = torch.empty((ROW_FLOATS,), dtype=torch.float64, device=dev)
    lib = _library()
    rc = lib.qmmx_mc_reduce_rows(part_counts.data_ptr(), part_floats.data_ptr(),
                                 rows, tot_counts.data_ptr(),
                                 tot_floats.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "mc_reduce_rows")
    LAUNCHES["mc_reduce_rows"] += 1
    return tot_counts, tot_floats


def mc_paths_fused(seed, levels: Levels, params, *, num_paths: int,
                   num_bars: int = 40, s0: float = 100.0, mu: float = 0.0,
                   sigma: float = 0.15, dt: float = 1.0 / (390.0 * 252.0),
                   lanes: int = SINGLE_LANES, noise=None,
                   antithetic: bool = False, external_uniforms=None,
                   device=None) -> PathStats:
    """Fused first-contact MC, the counterpart of ``mc_paths_pallas`` (gbm):
    the same PathStats contract as ``sim.pathsim.mc_paths``, with the McNoise
    execution-noise knobs and antithetic lane pairs.

    ``device`` (default: that of ``external_uniforms``, else the CUDA device,
    which raises where there is none) picks the path: a CUDA device launches
    the kernel or raises; the CPU runs the plain version.  Draws agree with
    ``sim.pathsim.mc_paths`` statistically, not bitwise (different stream
    layouts)."""
    _check(seed, levels, num_paths=num_paths, num_bars=num_bars, lanes=lanes,
           noise=noise, antithetic=antithetic,
           external_uniforms=external_uniforms)
    device = devices.resolve(device, external_uniforms)
    kw = dict(num_paths=num_paths, num_bars=num_bars, s0=s0, mu=mu,
              sigma=sigma, dt=dt, lanes=lanes, noise=noise,
              antithetic=antithetic, external_uniforms=external_uniforms)
    if device.type == "cpu":
        return mc_paths_fused_reference(seed, levels, params, device=device, **kw)
    rows = first_contact_rows(seed, levels, params, device=device, **kw)
    return stats_from_totals(*reduce_rows(*rows))
