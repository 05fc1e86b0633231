"""Fused gated lifecycle: generate -> multi-trade gated lifecycle -> reduce, as one CUDA kernel.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:1067-1565``
and ``:1825-1971`` (kernel #4, ``_gated_kernel`` with ``_gated_lifecycle_loop``
and ``_gated_accumulate``, entry ``mc_paths_pallas_gated`` ``:2381-2390``),
gbm sampler only; the bootstrap, block-bootstrap and Heston branches are not
ported yet.

* ``mc_paths_gated_fused`` -- the entry.  For a CUDA device it launches
  ``ops/csrc/mc_gated.cu`` (pass 1: one thread per path, one partial row per
  CTA; pass 2: a fixed-order fold of the rows) or raises.  For the CPU it
  runs the plain version.
* ``gated_totals_reference`` -- the plain PyTorch version: the TPU kernel's
  double-bar streaming loop over (block, 8, lanes) tensors, driving the
  ``sim.gatedpath.Lifecycle`` state machine; optionally per path.
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

import torch

from ..sim.gatedpath import GateConfig, Lifecycle
from ..sim.pathsim import HIST_BINS, LIFE_HIST_HI, LIFE_HIST_LO, PathStats
from ..types import KIND_SOLID, Levels
from ..utils import build, prng
from ..utils import device as devices
from .draws import GATED_STREAM, GATED_SUB, GatedLayout, gated_uniforms
from .kernel_args import MAX_LEVELS, consts, f32, grid_size, knobs, level_slots

GATED_LANES = 1024       # logical lanes per block row (one block = 8 x lanes paths)
N_COUNTS = 6             # n, entered, wins, losses, open, trades
ROW_COUNTS = N_COUNTS + HIST_BINS
ROW_FLOATS = 6           # sum_eq, sum_eq2, sum_dd, min_eq, max_eq, max_dd
PATH_COLS = 6            # per-path output: equity, trades, wins, losses, open, dd
# the TPU kernel's lifecycle binning: (equity - LO) * f32(BINS / (HI - LO))
LIFE_BIN_SCALE = f32(HIST_BINS / (LIFE_HIST_HI - LIFE_HIST_LO))
_BIG = 3.4e38
_SOURCE = "mc_gated"

# Kernel launches, counted by the wrappers where they launch and nowhere else.
LAUNCHES = {"mc_gated": 0, "mc_gated_reduce_rows": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class _GatedArgs(ctypes.Structure):
    """Mirror of ``struct GatedArgs`` in ops/csrc/mc_gated.cu."""

    _fields_ = [
        ("num_paths", ctypes.c_int64),
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
    prng.check_seed(seed)
    block = GATED_SUB * lanes
    if lanes <= 0 or num_paths <= 0 or num_paths % block != 0:
        raise ValueError(f"num_paths must be a positive multiple of {block} "
                         f"(8 x lanes)")
    layout = GatedLayout(num_bars, noise is not None)
    if levels.max_levels > MAX_LEVELS:
        raise ValueError(f"the gated kernel supports up to {MAX_LEVELS} "
                         "level slots")
    if antithetic and lanes % 256 != 0:
        raise ValueError("antithetic needs lanes % 256 == 0 (half-row pairs)")
    if external_uniforms is not None:
        if not torch.is_tensor(external_uniforms):
            raise ValueError("external_uniforms must be a torch tensor")
        want = (num_paths // block, layout.u_rows, GATED_SUB, lanes)
        if tuple(external_uniforms.shape) != want:
            raise ValueError(f"external_uniforms must have shape {want}, "
                             f"got {tuple(external_uniforms.shape)}")
        if external_uniforms.dtype != torch.float32:
            raise ValueError("external_uniforms must be float32")
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
                             antithetic: bool = False):
    """The bars the plain version generates from uniforms f32[nb, u_rows, 8,
    lanes]: (PathBars f32[P, W], tie f32[P, W], noise normals f32[4, P, W] or
    None), path p = block * 8 * lanes + s * lanes + j.  For replaying them
    through ``sim.gatedpath.gated_path_replay``."""
    from .pathgen import PathBars

    drift, sig_dt, log_s0 = consts(s0, mu, sigma, dt)
    nb, _, sub, lanes = u.shape
    log_s = torch.full((nb, sub, lanes), log_s0, dtype=torch.float32,
                       device=u.device)
    cols = {k: [] for k in ("open", "high", "low", "close", "tie", "nz")}
    for _, _, z, (u3, u4, tie), nz in _steps(u, layout, antithetic):
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


def _steps(u, layout: GatedLayout, antithetic: bool):
    """Per bar, in order: (t2, half, z, (u3, u4, tie), noise normals or
    None), each [nb, 8, lanes], as ``_gated_lifecycle_loop`` draws them."""
    for t2 in range(layout.num_bars // 2):
        def draw(k):
            return u[:, layout.row(t2, k)]

        z_pair = box_muller(draw(0), draw(1))
        if antithetic:
            h = u.shape[-1] // 2
            z_pair = tuple(torch.cat([z[..., :h], -z[..., :h]], dim=-1)
                           for z in z_pair)
        for half in range(2):
            nz = None
            if layout.noise:
                k = 8 + 4 * half
                nz = (box_muller(draw(k), draw(k + 1))
                      + box_muller(draw(k + 2), draw(k + 3)))
            yield (t2, half, z_pair[half],
                   tuple(draw(2 + 3 * half + i) for i in range(3)), nz)


def _chunk_gated(u, layout: GatedLayout, levels, params, gate, noise, consts,
                 antithetic, per_path: bool):
    """Totals (and per-path rows) of one chunk of blocks, u f32[nb, u_rows,
    8, lanes]: the TPU kernel's block computation with the lifecycle of
    ``sim.gatedpath``, binned as ``_gated_accumulate`` bins."""
    nb, _, sub, lanes = u.shape
    dev = u.device
    drift, sig_dt, log_s0 = consts
    log_s = torch.full((nb, sub, lanes), log_s0, dtype=torch.float32, device=dev)
    life = Lifecycle(torch.exp(log_s).reshape(-1), levels, params, gate,
                     noise=noise)
    held = torch.zeros((), dtype=torch.int64, device=dev)
    for t2, half, z, (u3, u4, tie), nz in _steps(u, layout, antithetic):
        held = held + (life.side != 0).sum()   # bars that evaluate high/low
        log_s, c, high, low = gated_bar(log_s, z, u3, u4, drift, sig_dt)
        life.step(2 * t2 + half, high.reshape(-1), low.reshape(-1),
                  c.reshape(-1), tie.reshape(-1),
                  None if nz is None else tuple(x.reshape(-1) for x in nz))
    out = life.outcome()
    eq, dd = out.equity, out.max_dd
    entered = out.trades > 0
    counts = torch.zeros(ROW_COUNTS, dtype=torch.int64, device=dev)
    counts[0] = eq.numel()
    counts[1] = entered.sum()
    counts[2] = out.wins.sum()
    counts[3] = out.losses.sum()
    counts[4] = out.open_at_end.sum()
    counts[5] = out.trades.sum()
    bins = torch.clamp(((eq - LIFE_HIST_LO) * LIFE_BIN_SCALE).to(torch.int32),
                       0, HIST_BINS - 1)
    counts[N_COUNTS:] = torch.bincount(bins[entered].to(torch.int64),
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
    rows = None
    if per_path:
        rows = torch.stack([eq, out.trades.float(), out.wins.float(),
                            out.losses.float(), out.open_at_end.float(), dd],
                           dim=1)
    return counts, floats, held, rows


def _merge_totals(a, b):
    if a is None:
        return b
    fa, fb = a[1], b[1]
    return a[0] + b[0], torch.stack([
        fa[0] + fb[0], fa[1] + fb[1], fa[2] + fb[2],
        torch.minimum(fa[3], fb[3]), torch.maximum(fa[4], fb[4]),
        torch.maximum(fa[5], fb[5])]), a[2] + b[2]


def stats_from_gated_totals(counts: torch.Tensor, floats: torch.Tensor) -> PathStats:
    """int64 counts [n, entered, wins, losses, open, trades, hist...] and
    float64 [sum_eq, sum_eq2, sum_dd, min_eq, max_eq, max_dd] -> the float32
    lifecycle PathStats (``_unpack_acc_gated``)."""
    c = counts.to(torch.float32)
    f = floats.to(torch.float32)
    has = c[1] > 0
    inf = float("inf")
    return PathStats(
        n=c[0], n_entered=c[1], n_tp=c[2], n_stop=c[3], n_open=c[4],
        sum_r=f[0], sum_r2=f[1], min_r=torch.where(has, f[3], inf),
        max_r=torch.where(has, f[4], -inf), sum_trades=c[5], sum_dd=f[2],
        max_dd=f[5], hist=c[N_COUNTS:], hist_lo=LIFE_HIST_LO,
        hist_hi=LIFE_HIST_HI)


def gated_totals_reference(seed, levels: Levels, params, gate=None, *,
                           num_paths: int, num_bars: int = 40,
                           s0: float = 100.0, mu: float = 0.0,
                           sigma: float = 0.15,
                           dt: float = 1.0 / (390.0 * 252.0),
                           lanes: int = GATED_LANES, noise=None,
                           antithetic: bool = False, external_uniforms=None,
                           device=None, chunk_blocks: int = 16,
                           per_path: bool = False, work: bool = False):
    """The plain version's (int64 counts, float64 floats) totals, computed
    on ``device`` (default: that of ``external_uniforms``, else the CUDA
    device) in chunks of ``chunk_blocks`` blocks; then the f32[P, 6] per-path
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
    tot, rows = None, []
    for b0 in range(0, n_blocks, chunk_blocks):
        nb = min(chunk_blocks, n_blocks - b0)
        if external_uniforms is not None:
            u = external_uniforms[b0:b0 + nb]
        else:
            u = gated_uniforms(seed, layout, block0=b0, n_blocks=nb,
                               lanes=lanes, device=device)
        *part, part_rows = _chunk_gated(u, layout, levels, params, gate,
                                        noise, cs, antithetic, per_path)
        tot = _merge_totals(tot, part)
        if per_path:
            rows.append(part_rows)
    out = tot[:2]
    if per_path:
        out += (torch.cat(rows),)
    if work:
        out += (tot[2],)
    return out


def reduce_rows_reference(part_counts: torch.Tensor, part_floats: torch.Tensor):
    """Plain version of the pass-2 kernel: partial rows -> totals."""
    f = part_floats.double()
    return part_counts.sum(dim=0), torch.stack(
        [f[:, 0].sum(), f[:, 1].sum(), f[:, 2].sum(), f[:, 3].min(),
         f[:, 4].max(), f[:, 5].max()])


# --------------------------------------------------------------------------
# the kernel wrappers
# --------------------------------------------------------------------------

_BOUND: set[int] = set()


def _library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures set."""
    lib = build.load(_SOURCE)
    if id(lib) not in _BOUND:
        vp = ctypes.c_void_p
        lib.qmmx_gated_args_size.argtypes = []
        lib.qmmx_gated_args_size.restype = ctypes.c_int
        lib.qmmx_gated_error_string.argtypes = [ctypes.c_int]
        lib.qmmx_gated_error_string.restype = ctypes.c_char_p
        lib.qmmx_mc_gated.argtypes = [
            ctypes.POINTER(_GatedArgs), vp, vp, vp, vp, ctypes.c_int, vp]
        lib.qmmx_mc_gated.restype = ctypes.c_int
        lib.qmmx_mc_gated_reduce_rows.argtypes = [vp, vp, ctypes.c_int, vp, vp, vp]
        lib.qmmx_mc_gated_reduce_rows.restype = ctypes.c_int
        if lib.qmmx_gated_args_size() != ctypes.sizeof(_GatedArgs):
            raise RuntimeError("GatedArgs layout differs between "
                               "mc_gated.cu and cuda_gated._GatedArgs")
        _BOUND.add(id(lib))
    return lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.qmmx_gated_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def gated_rows(seed, levels: Levels, params, gate=None, *, num_paths: int,
               num_bars: int, s0: float, mu: float, sigma: float, dt: float,
               lanes: int, noise, antithetic: bool, external_uniforms,
               device: torch.device, per_path: bool = False):
    """Launch pass 1 on a CUDA device: int64 [grid, 134] count rows and f32
    [grid, 6] float rows, one row per CTA, plus the f32[P, 6] per-path rows
    when ``per_path``."""
    layout = _check(seed, levels, num_paths=num_paths, num_bars=num_bars,
                    lanes=lanes, noise=noise, antithetic=antithetic,
                    external_uniforms=external_uniforms)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"gated_rows launches the CUDA kernel; got device {device}")
    if num_paths >= 1 << 40:
        raise ValueError("num_paths must be below 2^40 (per-CTA uint32 histogram)")
    if num_bars >= 1 << 29:
        raise ValueError("num_bars must be below 2^29")
    gate = GateConfig.from_params(params) if gate is None else gate
    ext_ptr = None
    if external_uniforms is not None:
        if not external_uniforms.is_cuda or not external_uniforms.is_contiguous():
            raise ValueError("external_uniforms must be a contiguous CUDA tensor")
        ext_ptr = external_uniforms.data_ptr()
    lp, lv = level_slots(levels)
    lk = levels.kind.detach().cpu().tolist()
    lk = [int(k == KIND_SOLID) for k in lk] + [0] * (MAX_LEVELS - len(lk))
    drift, sig_dt, log_s0 = consts(s0, mu, sigma, dt)
    args = _GatedArgs(
        num_paths=num_paths,
        level_price=(ctypes.c_float * MAX_LEVELS)(*lp),
        level_valid=(ctypes.c_float * MAX_LEVELS)(*lv),
        level_kind=(ctypes.c_int32 * MAX_LEVELS)(*lk),
        qmin=f32(gate.q_min_prob), drift=drift, sig_dt=sig_dt, log_s0=log_s0,
        seed=int(seed), stream=GATED_STREAM,
        touch_limit=int(gate.touch_limit), cooldown_bars=int(gate.cooldown_bars),
        touch_gap=int(gate.touch_gap_bars), use_conf=int(bool(gate.use_confidence)),
        max_levels=levels.max_levels, num_bars=num_bars, lanes=lanes,
        u_rows=layout.u_rows, use_noise=int(noise is not None),
        antithetic=int(bool(antithetic)),
        **knobs(params, noise),
    )
    grid = grid_size(num_paths)
    part_counts = torch.empty((grid, ROW_COUNTS), dtype=torch.int64, device=device)
    part_floats = torch.empty((grid, ROW_FLOATS), dtype=torch.float32, device=device)
    rows = (torch.empty((num_paths, PATH_COLS), dtype=torch.float32, device=device)
            if per_path else None)
    lib = _library()
    rc = lib.qmmx_mc_gated(ctypes.byref(args), ext_ptr, part_counts.data_ptr(),
                           part_floats.data_ptr(),
                           rows.data_ptr() if per_path else None, grid,
                           torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, rc, "mc_gated")
    LAUNCHES["mc_gated"] += 1
    return (part_counts, part_floats, rows) if per_path else (part_counts, part_floats)


def reduce_rows(part_counts: torch.Tensor, part_floats: torch.Tensor):
    """Pass 2: partial rows -> (int64 [134] counts, float64 [6] floats).  CUDA
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
    rc = lib.qmmx_mc_gated_reduce_rows(part_counts.data_ptr(), part_floats.data_ptr(),
                                       rows, tot_counts.data_ptr(),
                                       tot_floats.data_ptr(),
                                       torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "mc_gated_reduce_rows")
    LAUNCHES["mc_gated_reduce_rows"] += 1
    return tot_counts, tot_floats


def mc_paths_gated_fused(seed, levels: Levels, params, gate=None, *,
                         num_paths: int, num_bars: int = 40, s0: float = 100.0,
                         mu: float = 0.0, sigma: float = 0.15,
                         dt: float = 1.0 / (390.0 * 252.0),
                         lanes: int = GATED_LANES, noise=None,
                         antithetic: bool = False, external_uniforms=None,
                         device=None) -> PathStats:
    """Fused gated-lifecycle MC, the counterpart of ``mc_paths_pallas_gated``
    (gbm): the lifecycle PathStats contract of ``sim.gatedpath.mc_paths_gated``
    with the McNoise per-entry execution noise and antithetic lane pairs;
    ``gate`` defaults to ``GateConfig.from_params(params)``.

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
              antithetic=antithetic, external_uniforms=external_uniforms)
    if device.type == "cpu":
        return stats_from_gated_totals(*gated_totals_reference(
            seed, levels, params, gate, device=device, **kw))
    rows = gated_rows(seed, levels, params, gate, device=device, **kw)
    return stats_from_gated_totals(*reduce_rows(*rows))
