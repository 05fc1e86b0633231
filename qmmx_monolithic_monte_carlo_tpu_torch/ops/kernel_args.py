"""How the host packs arguments for the port's CUDA kernels and launches them.

Shared by the first-contact (``ops/cuda_mc.py``), gated (``ops/cuda_gated.py``)
and engine (``ops/cuda_engine.py``) wrappers and their plain versions, so the
kernels see the same float32 constants, noise knobs, level slots and grid:

* ``f32`` -- the float32 rounding of a host number;
* ``consts`` -- (drift, sig_dt, log_s0), float64 on the host, rounded to float32;
* ``knobs`` / ``knob_columns`` -- padding, proximity and execution-noise
  stds as float32, or as the records' leaves (a row or a column a knob);
* ``level_slots`` -- level prices and validity padded to ``MAX_LEVELS``;
* ``grid_size`` -- the pass-1 grid, a function of num_paths alone;
* ``check_blocks`` / ``check_uniforms`` -- the launch checks the gated and
  engine wrappers share (blocks of 8 x lanes paths, injected uniforms);
* ``launch_pointer`` -- the checks of a pass-1 launch, and the pointer of the
  injected uniforms;
* ``grid_row`` / ``grid_len`` -- row g of a record with [G] (or scalar)
  leaves, and G;
* ``grid_rows`` / ``grid_columns`` / ``knob_rows`` -- the rows (or [G]
  columns) of a fused sweep, as the JAX sweep kernels take them: (stop, tp)
  columns beside records of scalar or [G] leaves (first contact, gated), or
  EngineParams with [G] leaves (engine);
* ``symbol_rows`` / ``sg_rows`` -- the rows of a universe, with the checks of
  the JAX universe entries: per symbol its levels, spot and volatility (as
  float64, for ``consts``), its row of records with scalar or [S] leaves
  and, for a book, its market loading and weight;
  or, for a sweep of universes, row (s, g) of records with scalar, [G] or
  [S, G] leaves; ``symbol_grid`` / ``symbol_uniforms`` -- symbol s's grid
  and injected uniforms, for the plain versions;
* ``symbol_columns`` / ``sg_columns`` / ``repeat_rows`` -- the same checks,
  the per-symbol numbers as columns, a sweep of universes' leaves as S x G
  columns, a universe's levels a row a cell (the wrappers pack every row's
  arguments at once);
* ``device_rows`` / ``book_pairs`` -- a sweep's (or universe's) argument
  structs, one per grid row, on the card; a book's (beta, weight) pairs;
* ``fold_rows`` -- pass 2 over [R, C] partial rows, or a sweep's [G, R, C]
  with one CTA per grid row;
* ``sampler_args`` -- a sampler kernel's ``SamplerArgs``, one per launch row
  (the row's recorded-bar table's pointer, H and block length, the Heston
  constants) on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from ..types import Levels
from ..utils import prng

MAX_LEVELS = 8           # level slots a kernel holds in its arguments
MAX_ENGINE_LEVELS = 64   # level slots of the engine's envelope kernels (a level table;
                         # MAX_KERNEL_LEVELS, pallas_engine.py:95)
BLOCK = 256              # CUDA threads per CTA (matches the .cu sources)
MAX_CTAS = 4096          # pass-1 grid cap: fixed, so results do not depend on the card
MAX_GRID_ROWS = 65535    # grid rows of one fused sweep (the gated and engine
                         # kernels take a row per gridDim.y)
_F32 = torch.float32


def f32(x) -> float:
    """A Python float holding the float32 rounding of ``x``."""
    return float(np.float32(float(x)))


def consts(s0, mu, sigma, dt) -> tuple[float, float, float]:
    """(drift, sig_dt, log_s0) computed in float64 on the host and rounded to
    float32, as ``_mc_paths_pallas_jit`` does (pallas_mc.py:741-742, :652)."""
    drift = (mu - 0.5 * sigma * sigma) * dt
    sig_dt = sigma * math.sqrt(dt)
    return f32(drift), f32(sig_dt), f32(math.log(float(s0)))


def knob_columns(params, noise) -> dict:
    """The TPU kernel's (1, 8) knob row as the records' leaves (scalars, or
    columns of a sweep's or a universe's rows); zero noise stds when
    ``noise`` is None."""
    def std(name):
        return getattr(noise, name) if noise is not None else 0.0

    return {
        "prox": params.contact_prox, "stop_pad": params.stop_padding,
        "tp_pad": params.tp_padding,
        "lvl_jit": std("level_jitter_std"), "entry_slip": std("entry_slip_std"),
        "stop_slip": std("stop_slip_std"), "tgt_slip": std("target_slip_std"),
    }


def knobs(params, noise) -> dict:
    """``knob_columns`` of one row as float32 values."""
    return {k: f32(v) for k, v in knob_columns(params, noise).items()}


def level_slots(levels: Levels) -> tuple[list[float], list[float]]:
    """Level prices (invalid slots zeroed, as ``_level_rows`` does) and 1/0
    validity, padded to MAX_LEVELS."""
    price = levels.price.detach().cpu().to(torch.float32)
    valid = levels.valid.detach().cpu()
    lp = torch.where(torch.isfinite(price), price, 0.0).tolist()
    lv = valid.to(torch.float32).tolist()
    pad = MAX_LEVELS - len(lp)
    return lp + [0.0] * pad, lv + [0.0] * pad


def grid_size(num_paths: int) -> int:
    """Pass-1 CTAs: a function of num_paths only, never of the card."""
    return max(1, min(-(-num_paths // BLOCK), MAX_CTAS))


def check_blocks(seed, levels: Levels, *, num_paths: int, lanes: int, sub: int,
                 what: str, max_slots: int = MAX_LEVELS) -> None:
    """The seed, whole blocks of ``sub`` x ``lanes`` paths, and at most
    ``max_slots`` level slots for the ``what`` kernel."""
    prng.check_seed(seed)
    block = sub * lanes
    if lanes <= 0 or num_paths <= 0 or num_paths % block != 0:
        raise ValueError(f"num_paths must be a positive multiple of {block} "
                         f"({sub} x lanes)")
    if levels.max_levels > max_slots:
        raise ValueError(f"the {what} kernel supports up to {max_slots} level slots")


def check_uniforms(external_uniforms, want: tuple, *, antithetic: bool,
                   lanes: int) -> None:
    """Antithetic half-row pairs, and injected uniforms: a float32 torch
    tensor of shape ``want``."""
    if antithetic and lanes % 256 != 0:
        raise ValueError("antithetic needs lanes % 256 == 0 (half-row pairs)")
    if external_uniforms is None:
        return
    if not torch.is_tensor(external_uniforms):
        raise ValueError("external_uniforms must be a torch tensor")
    if tuple(external_uniforms.shape) != want:
        raise ValueError(f"external_uniforms must have shape {want}, "
                         f"got {tuple(external_uniforms.shape)}")
    if external_uniforms.dtype != torch.float32:
        raise ValueError("external_uniforms must be float32")


def launch_pointer(num_paths: int, num_bars: int, external_uniforms, device,
                   what: str):
    """The checks of a pass-1 launch on ``device``; returns the pointer of the
    injected uniforms (None in Philox mode)."""
    if device.type != "cuda":
        raise ValueError(f"{what} launches the CUDA kernel; got device {device}")
    if num_paths >= 1 << 40:
        raise ValueError("num_paths must be below 2^40 (per-CTA uint32 counts)")
    if num_bars >= 1 << 29:
        raise ValueError("num_bars must be below 2^29")
    if external_uniforms is None:
        return None
    if not external_uniforms.is_cuda or not external_uniforms.is_contiguous():
        raise ValueError("external_uniforms must be a contiguous CUDA tensor")
    return external_uniforms.data_ptr()


def tensor_leaves(obj) -> dict:
    """The tensor fields of a dataclass record, by name."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if torch.is_tensor(getattr(obj, f.name))}


def grid_len(*objs) -> int:
    """G: the length of the [G] leaves of ``objs`` (records of tensors, or
    None); 1 when every leaf is a scalar.  Leaves of two lengths raise."""
    sizes = {int(v.shape[0]) for o in objs if o is not None
             for v in tensor_leaves(o).values() if v.dim() >= 1}
    if len(sizes) > 1:
        raise ValueError(f"grid leaves of different lengths {sorted(sizes)}")
    return sizes.pop() if sizes else 1


def grid_row(obj, g: int):
    """Row ``g`` of a record whose leaves are [G] vectors or scalars (which
    every row shares); None stays None."""
    if obj is None:
        return None
    return dataclasses.replace(obj, **{k: v[g] if v.dim() >= 1 else v
                                       for k, v in tensor_leaves(obj).items()})


def _check_rows(g: int) -> None:
    if not 1 <= g <= MAX_GRID_ROWS:
        raise ValueError(f"the grid takes 1 to {MAX_GRID_ROWS} rows, got {g}")


def grid_columns(params, grid_stops, grid_tps, *records) -> tuple:
    """(G, params carrying the [G] columns grid_stops and grid_tps), with the
    checks of the JAX sweep kernels: the two columns of one length, the
    records' (GateConfig, McNoise, ... or None) leaves scalars or [G]."""
    stops = torch.as_tensor(grid_stops, dtype=_F32).reshape(-1)
    tps = torch.as_tensor(grid_tps, dtype=_F32).reshape(-1)
    g = stops.shape[0]
    if tps.shape[0] != g:
        raise ValueError("grid_stops and grid_tps must have equal length")
    _check_rows(g)
    if grid_len(*records) not in (1, g):
        raise ValueError(f"grid leaves must be scalars or of length {g}")
    return g, params.replace(stop_padding=stops, tp_padding=tps)


def grid_rows(params, grid_stops, grid_tps, *records) -> list:
    """[(params_g, *records_g)] for g < G: params_g (EngineParams) carries
    (grid_stops[g], grid_tps[g]), each record its row g; the checks of
    ``grid_columns``."""
    g, cols = grid_columns(params, grid_stops, grid_tps, *records)
    return [(params.replace(stop_padding=cols.stop_padding[i], tp_padding=cols.tp_padding[i]),
             *(grid_row(r, i) for r in records)) for i in range(g)]


def knob_rows(grid_params, noise=None, n_grid=None) -> list:
    """[(params_g, noise_g)] of an engine sweep, with the checks of
    ``mc_paths_pallas_engine_sweep`` (pallas_engine.py:1968-1976): G is
    ``n_grid``, else the length of grid_params' [G] leaves (there must be
    some, of one length); every leaf, noise stds included, is a scalar or [G]."""
    if n_grid is None:
        sizes = {int(v.shape[0]) for v in tensor_leaves(grid_params).values() if v.dim() == 1}
        if len(sizes) != 1:
            raise ValueError("pass n_grid or give grid_params at least one [G] leaf "
                             f"(found sizes {sorted(sizes)})")
        (n_grid,) = sizes
    _check_rows(int(n_grid))
    if grid_len(grid_params, noise) not in (1, n_grid):
        raise ValueError(f"grid leaves must be scalars or of length {n_grid}")
    return [(grid_row(grid_params, g), grid_row(noise, g)) for g in range(int(n_grid))]


def _symbol_column(name: str, x, n_sym: int) -> list[float]:
    v = torch.as_tensor(x, dtype=torch.float64).reshape(-1)
    if v.shape[0] not in (1, n_sym):
        raise ValueError(f"{name} must be a scalar or of length {n_sym}")
    return v.expand(n_sym).tolist()


def symbol_columns(levels: Levels, s0, sigma, *records, beta=None, weights=None) -> dict:
    """The checks of ``symbol_rows`` without cutting the records into rows:
    {"s0", "sigma": [S] float64 values; "beta", "weights": [S] float32
    values, for a book}."""
    if levels.price.dim() != 2:
        raise ValueError("levels must be [S, L]-batched (parallel.universe.stack_levels)")
    n_sym = int(levels.price.shape[0])
    _check_rows(n_sym)
    cols = {name: _symbol_column(name, x, n_sym) for name, x in (("s0", s0), ("sigma", sigma))}
    if (beta is None) != (weights is None):
        raise ValueError("a book takes beta and weights together")
    if beta is not None:
        cols.update({name: [f32(v) for v in _symbol_column(name, x, n_sym)]
                     for name, x in (("beta", beta), ("weights", weights))})
    if grid_len(*records) not in (1, n_sym):
        raise ValueError(f"per-symbol leaves must be scalars or of length {n_sym}")
    return cols


def symbol_rows(levels: Levels, s0, sigma, *records, beta=None, weights=None) -> list:
    """[(levels_s, s0_s, sigma_s, *records_s)] for the S symbols of a
    universe: row s of the [S, L] ``levels``, s0 and sigma (scalars or [S])
    as float64 Python floats, as ``_derived_consts`` takes them
    (pallas_mc.py:1646-1660), and row s of each record (EngineParams,
    McNoise, ... or None) whose leaves are scalars or [S].  A book's rows
    (``beta`` and ``weights`` given, scalars or [S]) end with the symbol's
    market loading and book weight as float32 values, as the JAX book takes
    them: (..., beta_s, weight_s)."""
    cols = symbol_columns(levels, s0, sigma, *records, beta=beta, weights=weights)
    book = [cols[k] for k in ("beta", "weights") if k in cols]
    return [(grid_row(levels, s), cols["s0"][s], cols["sigma"][s],
             *(grid_row(r, s) for r in records), *(c[s] for c in book))
            for s in range(len(cols["s0"]))]


def symbol_uniforms(external_uniforms, s: int):
    """Symbol s's injected uniforms of a universe's [S, ...] tensor, or None."""
    return None if external_uniforms is None else external_uniforms[s]


def _sg_leaf(v: torch.Tensor, s: int, g: int) -> torch.Tensor:
    return v if v.dim() == 0 else v[g] if v.dim() == 1 else v[s, g]


def sg_rows(grid_params, noise, n_sym: int, n_grid=None) -> list:
    """[[(params_sg, noise_sg) for g < G] for s < S] of a sweep of universes,
    with the checks of ``mc_paths_pallas_engine_universe_sweep``
    (pallas_engine.py:2440-2457): every leaf of ``grid_params`` and ``noise``
    is a scalar, a [G] vector (one grid shared by all symbols) or an [S, G]
    matrix (per-symbol grids); G is ``n_grid``, else the one length of the
    [G] and [S, G] leaves.  At most MAX_GRID_ROWS rows in all."""
    leaves = [v for o in (grid_params, noise) if o is not None
              for v in tensor_leaves(o).values()]
    if any(v.dim() > 2 for v in leaves):
        raise ValueError("grid leaves must be scalars, [G] or [S, G]")
    if n_grid is None:
        sizes = {int(v.shape[-1]) for v in tensor_leaves(grid_params).values()
                 if v.dim() in (1, 2)}
        if len(sizes) != 1:
            raise ValueError("pass n_grid or give grid_params at least one [G] or [S, G] "
                             f"leaf (found sizes {sorted(sizes)})")
        (n_grid,) = sizes
    n_grid = int(n_grid)
    for v in leaves:
        if v.dim() >= 1 and int(v.shape[-1]) != n_grid:
            raise ValueError(f"grid leaves must be scalars or of length {n_grid}")
        if v.dim() == 2 and int(v.shape[0]) != n_sym:
            raise ValueError("[S, G] grid leaves must match the symbol count")
    _check_rows(n_sym * n_grid)

    def row(obj, s, g):
        if obj is None:
            return None
        return dataclasses.replace(obj, **{k: _sg_leaf(v, s, g)
                                           for k, v in tensor_leaves(obj).items()})

    return [[(row(grid_params, s, g), row(noise, s, g)) for g in range(n_grid)]
            for s in range(n_sym)]


def symbol_grid(obj, s: int):
    """Symbol s's grid of a record with scalar, [G] or [S, G] leaves: its
    [S, G] leaves cut to row s ([G]); the rest unchanged."""
    if obj is None:
        return None
    return dataclasses.replace(obj, **{k: v[s] for k, v in tensor_leaves(obj).items()
                                       if v.dim() == 2})


def sg_columns(obj, n_sym: int, n_grid: int):
    """A record of scalar, [G] or [S, G] leaves (``sg_rows``) with each
    non-scalar leaf as the column of its S x G cells, cell (s, g) at
    s * G + g; None stays None."""
    if obj is None:
        return None
    return dataclasses.replace(obj, **{k: v.expand(n_sym, n_grid).reshape(-1)
                                       for k, v in tensor_leaves(obj).items() if v.dim() >= 1})


def repeat_rows(obj, times: int):
    """A record of [S, ...] leaves with each row repeated ``times`` times in
    place (row s at s * times + g)."""
    return dataclasses.replace(obj, **{k: v.repeat_interleave(times, dim=0)
                                       for k, v in tensor_leaves(obj).items()})


def book_pairs(cols: dict, device: torch.device) -> torch.Tensor:
    """A book's f32[S, 2] (beta, weight) pairs of ``symbol_columns`` on the
    card, the book kernels' ``bw``."""
    return torch.tensor(list(zip(cols["beta"], cols["weights"])), dtype=_F32, device=device)


class SamplerArgs(ctypes.Structure):
    """Mirror of ``struct SamplerArgs`` in ops/csrc/sampler.cuh."""

    _fields_ = [("tables", ctypes.c_void_p), ("hist_len", ctypes.c_int32),
                ("block_len", ctypes.c_int32)]
    _fields_ += [(k, ctypes.c_float) for k in (
        "hf", "bl", "v0", "theta", "xi", "rho", "rho_perp", "mu", "dt", "kappa_dt")]


def sampler_args(sampler, device: torch.device,
                 table_rows=(0,)) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(the ``SamplerArgs`` of ``sampler`` (an ``ops/samplers.Sampler``), one
    per launch row, as bytes on the card; its tables on the card or None);
    the caller keeps the tables alive until the launch has run.  Row r reads
    table ``table_rows[r]`` of a universe's [S, 5, H] tables (a sweep's rows
    all read its one [5, H] table, table 0); H and the block length go as
    float32 too, as the kernels' index arithmetic takes them; the Heston
    constants are every row's."""
    n = len(table_rows)
    a = np.zeros(n, dtype=np.dtype(SamplerArgs))
    tables = None
    if sampler.resamples:
        tables = sampler.tables.to(device=device, dtype=_F32).contiguous()
        per_table = tables.shape[-2] * tables.shape[-1] * tables.element_size()
        n_tables = 1 if tables.dim() == 2 else tables.shape[0]
        rows = np.asarray(table_rows, np.int64)
        if rows.min() < 0 or rows.max() >= n_tables:
            raise ValueError(f"table rows must lie in [0, {n_tables})")
        a["tables"] = tables.data_ptr() + rows * per_table
        a["hist_len"], a["block_len"] = sampler.hist_len, sampler.block_len
        a["hf"], a["bl"] = f32(sampler.hist_len), f32(sampler.block_len)
    if sampler.heston is not None:
        for k in ("v0", "theta", "xi", "rho", "rho_perp", "mu", "dt", "kappa_dt"):
            a[k] = getattr(sampler.heston, k)
    return device_rows(a, device), tables


def device_rows(rows, device: torch.device) -> torch.Tensor:
    """An array of argument structs (numpy or ctypes, one per grid row)
    copied to the card, as bytes."""
    return torch.frombuffer(bytearray(bytes(rows)), dtype=torch.uint8).to(device)


def fold_rows(fn, raise_on, part_counts: torch.Tensor, part_floats: torch.Tensor,
              widths: tuple[int, int], family: str, launches: dict, what=None):
    """Pass 2 through the C entry ``fn`` (``raise_on(rc, what)`` reports a
    failed launch), over partial rows of int64 counts and float32 floats of
    the kernel's ``widths``: [R, C] (one segment; -> int64 [C], float64
    [row_floats]; counted in ``launches[family + "_reduce_rows"]``) or a
    sweep's [G, R, C] (one CTA per grid row; -> [G, C], [G, row_floats];
    counted in ``launches[family + "_sweep_reduce_rows"]``).  ``what``
    names another counter (a universe's fold)."""
    if (part_counts.device != part_floats.device
            or part_counts.device.type != "cuda"):
        raise ValueError("part_counts and part_floats must lie on one CUDA device")
    sweep = part_counts.dim() == 3
    if what is None:
        what = f"{family}_sweep_reduce_rows" if sweep else f"{family}_reduce_rows"
    if not sweep:
        part_counts, part_floats = part_counts[None], part_floats[None]
    row_counts, row_floats = widths
    segs, rows = part_counts.shape[:2]
    if (part_counts.dim() != 3 or part_counts.dtype != torch.int64
            or part_floats.dtype != torch.float32
            or tuple(part_counts.shape) != (segs, rows, row_counts)
            or tuple(part_floats.shape) != (segs, rows, row_floats)
            or not part_counts.is_contiguous() or not part_floats.is_contiguous()):
        raise ValueError(f"partial rows must be contiguous int64 [R, {row_counts}] "
                         f"and float32 [R, {row_floats}] (a sweep's: [G, R, ...])")
    dev = part_counts.device
    tot_counts = torch.empty((segs, row_counts), dtype=torch.int64, device=dev)
    tot_floats = torch.empty((segs, row_floats), dtype=torch.float64, device=dev)
    rc = fn(part_counts.data_ptr(), part_floats.data_ptr(), rows, segs,
            tot_counts.data_ptr(), tot_floats.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(rc, what)
    launches[what] += 1
    return (tot_counts, tot_floats) if sweep else (tot_counts[0], tot_floats[0])
