"""Command-line interface of the port.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/host/cli.py`` for the
subcommands the port carries so far:

  paths   — generated-path Monte Carlo at scale: first-contact replay, with
            ``--gated`` the engine-gated multi-trade lifecycle, with
            ``--engine`` the full 12-gate engine; ``--sampler`` gbm, or
            bootstrap / block_bootstrap (resampled recorded bars of
            ``--bars-csv``, default a synthetic 390-bar fixture, in runs of
            ``--block-len``) or heston (``--heston-*``)
  sweep   — the same three over a grid of settings (stop x tp, with
            ``--gated`` x touch limit x Q_MIN_PROB, with ``--engine`` x
            level-jitter std) under common random numbers: every row
            replays the same simulated paths (``--sampler`` gbm, or
            bootstrap / block_bootstrap over ``--bars-csv``); one JSON line
            per row
  book    — a correlated book of symbols on one market factor (beta
            loadings) over the gated lifecycle, with ``--engine`` the full
            engine: one JSON line per symbol, then the book's (VaR/CVaR of
            the book's R, drawdown of its curve over time); ``--sampler``
            gbm, or bootstrap / block_bootstrap (joint recorded days of one
            ``--bars-csv`` history every symbol shares, rebased on its own
            spot) or heston (the market factor in the price and variance
            shocks); ``--engine --harvest`` also harvests each symbol's
            closed-trade labels and refreshes its ML gate on them (the
            ``labeled`` and ``ml_coef`` keys)
  flywheel — simulate -> label -> retrain -> re-simulate (``sim/flywheel``):
            each round runs the full engine with the label harvest, refreshes
            the ML gate and the OnlinePolicy entry heads on it and arms them
            for the next round (``--explore-paths``: a gates-off exploration
            population merged into every armed round); one JSON row per round

``--device`` (default ``cuda``) says where it runs; without a GPU the CLI
exits unless ``--device cpu`` is given.  ``--backend cuda`` runs the fused
CUDA kernel (``ops/cuda_mc.py``, ``ops/cuda_gated.py`` with ``--gated``,
``ops/cuda_engine.py`` with ``--engine``; for ``book`` their book
kernels), ``--backend torch`` the streamed PyTorch pipeline
(``sim/pathsim.py``, ``sim/gatedpath.py``, ``sim/enginepath.py`` or
``parallel/portfolio.py``) on ``--device``, and ``auto`` the kernel on a CUDA
device when the shape fits it (``_fits``) and the pipeline otherwise; it
never changes the device.  The output JSON carries the JAX CLI's keys.
Options of the JAX CLI whose code is not ported yet exit with a "not ported
yet" message.

    python -m qmmx_monolithic_monte_carlo_tpu_torch.host.cli paths --backend cuda
    python -m qmmx_monolithic_monte_carlo_tpu_torch.host.cli paths --gated --backend cuda
    python -m qmmx_monolithic_monte_carlo_tpu_torch.host.cli paths --engine --backend cuda
    python -m qmmx_monolithic_monte_carlo_tpu_torch.host.cli paths --gated --backend cuda \
        --sampler block_bootstrap --bars-csv bars.csv --block-len 10
    python -m qmmx_monolithic_monte_carlo_tpu_torch.host.cli sweep --gated --backend cuda
    python -m qmmx_monolithic_monte_carlo_tpu_torch.host.cli sweep --engine --backend cuda \
        --sampler bootstrap --bars-csv bars.csv
    python -m qmmx_monolithic_monte_carlo_tpu_torch.host.cli book --engine --backend cuda
    python -m qmmx_monolithic_monte_carlo_tpu_torch.host.cli book --backend cuda \
        --sampler block_bootstrap --bars-csv bars.csv
    python -m qmmx_monolithic_monte_carlo_tpu_torch.host.cli book --engine --harvest \
        --backend cuda
    python -m qmmx_monolithic_monte_carlo_tpu_torch.host.cli flywheel --backend cuda \
        --rounds 3 --explore-paths 16777216
"""

from __future__ import annotations

import argparse
import json
import sys


_HESTON = ("v0", "kappa", "theta", "xi", "rho")


def _connect(args):
    from ..io import db as _db

    conn = _db.db_connect(args.db)
    _db.db_init(conn)
    return conn


def _levels_and_params(conn, args):
    from ..config import EngineParams
    from ..io import db as _db
    from ..types import Levels

    rows = _db.load_levels(conn)
    if not rows:
        # convenience: seed levels around the synthetic s0 when the DB is empty
        s0 = args.s0
        rows = [
            {"color": "blue", "type": "solid", "index": 0, "price": s0},
            {"color": "orange", "type": "dashed", "index": 0, "price": s0 + 0.4},
            {"color": "teal", "type": "solid", "index": 0, "price": s0 - 0.3},
        ]
    levels = Levels.from_rows(rows, max_levels=max(64, len(rows)))
    params = EngineParams.from_settings(lambda k, d=None: _db.settings_get(conn, k, d))
    if args.qmin is not None:
        params = params.replace(q_min_prob=args.qmin)
    return rows, levels, params


def _not_ported(args) -> None:
    for flag, on in (("--exact-tail", getattr(args, "exact_tail", False)),
                     ("--ckpt-dir", getattr(args, "ckpt_dir", None) is not None)):
        if on:
            raise SystemExit(
                f"{flag} is not ported yet: the port runs the first-contact, gated and "
                "engine paths and their sweeps under every sampler (use "
                "qmmx_monolithic_monte_carlo_tpu)")


def _load_bars(args) -> dict:
    """The recorded bars of ``--bars-csv`` as {t, o, h, l, c, v} arrays, or
    the JAX CLI's synthetic fixture (``host/cli.py:41-70``): ``num_bars``
    cents-rounded closes from a seeded random walk, highs and lows around
    them, opens at the previous close, zero volumes."""
    import numpy as np

    if getattr(args, "bars_csv", None):
        from ..io import native

        return native.parse_bars_csv(args.bars_csv)
    rng = np.random.default_rng(getattr(args, "seed", 0))
    n = getattr(args, "num_bars", 240)
    s0 = getattr(args, "s0", 100.0)
    c = np.round(s0 + np.cumsum(rng.normal(0, 0.04, n)), 2)
    h = np.round(c + np.abs(rng.normal(0, 0.05, n)), 2)
    lo = np.round(c - np.abs(rng.normal(0, 0.05, n)), 2)
    o = np.concatenate([[c[0]], c[:-1]])
    return {"t": np.arange(n, dtype=np.int64) * 60_000, "o": o, "h": h, "l": lo, "c": c,
            "v": np.zeros(n)}


def _hist_paths_bars(args):
    """The recorded o/h/l/c/v history (a PathBars of 1-D float32 tensors) of
    the bootstrap samplers: ``--bars-csv`` if given, else the synthetic
    fixture at 390 bars or ``--num-bars``, whichever is more (the horizon is
    not the history's length), as the JAX CLI's ``_hist_paths_bars``."""
    import types

    import torch

    from ..ops.pathgen import PathBars

    a = types.SimpleNamespace(**vars(args))
    if not getattr(args, "bars_csv", None):
        a.num_bars = max(390, getattr(args, "num_bars", 0))
    cols = _load_bars(a)
    return PathBars(*(torch.as_tensor(cols[k], dtype=torch.float32) for k in "ohlcv"))


def _heston_dict(args) -> dict:
    return {k: float(getattr(args, f"heston_{k}")) for k in _HESTON
            if hasattr(args, f"heston_{k}")}


def _sampler_kw(args) -> dict:
    """The sampler and what it reads, as the entries take them."""
    sampler = getattr(args, "sampler", "gbm")
    if sampler != "gbm" and getattr(args, "antithetic", False):
        raise SystemExit("--antithetic pairs gbm normals only (the kernels refuse "
                         f"it under --sampler {sampler})")
    kw = {"sampler": sampler}
    if sampler in ("bootstrap", "block_bootstrap"):
        kw.update(hist_bars=_hist_paths_bars(args), block_len=args.block_len)
    elif sampler == "heston":
        kw["heston"] = _heston_dict(args)
    return kw


def _book_sampler_kw(args, n_sym: int, cuda: bool) -> dict:
    """A book's sampler and what it reads: one recorded history every symbol
    shares, as the JAX CLI broadcasts it to [S, H] rows; the kernels take its
    tables once ([1, 5, H]), the pipeline the [S, H] view."""
    import torch

    from ..ops.pathgen import PathBars, history_tables

    kw = _sampler_kw(args)
    hist = kw.pop("hist_bars", None)
    if hist is not None and cuda:
        kw["tables"] = torch.stack(history_tables(hist))[None]
    elif hist is not None:
        kw["hist_bars"] = PathBars(*(x.expand(n_sym, -1) for x in hist))
    return kw


def _fits(args, rows) -> str | None:
    """None when the shape fits the path's CUDA kernel (``paths``, ``sweep``
    or ``book``), else what it needs.  The engine's kernels take up to 64
    levels and any --num-bars >= 2 (an even one in a book), as the JAX CLI's
    (``host/cli.py:323-346``); the others up to 8 levels."""
    from ..ops import cuda_engine, cuda_gated, cuda_mc
    from ..ops.kernel_args import MAX_ENGINE_LEVELS, MAX_GRID_ROWS

    if getattr(args, "cmd", None) == "sweep" and len(_grid(args)) > MAX_GRID_ROWS:
        return f"at most {MAX_GRID_ROWS} grid rows"
    if args.engine:
        block = cuda_engine.ENGINE_SUB * cuda_engine.ENGINE_LANES
        if len(rows) > MAX_ENGINE_LEVELS:
            return f"at most {MAX_ENGINE_LEVELS} levels"
        if getattr(args, "cmd", None) == "book" and args.num_bars % 2:
            return "an even --num-bars (a book walks double bars)"
        if not 2 <= args.num_bars <= cuda_engine.MAX_BARS:
            return f"--num-bars from 2 to {cuda_engine.MAX_BARS}"
        if args.num_paths % block:
            return f"--num-paths a multiple of {block}"
        if getattr(args, "explore_paths", 0) % block:
            return f"--explore-paths a multiple of {block}"
        return None
    if len(rows) > cuda_mc.MAX_LEVELS:
        return f"at most {cuda_mc.MAX_LEVELS} levels"
    odd_ok = not args.gated and getattr(args, "sampler", "gbm") in (
        "bootstrap", "block_bootstrap")     # one index uniform a bar, no pairs
    if args.num_bars <= 0 or (args.num_bars % 2 and not odd_ok):
        return "an even --num-bars"
    if args.gated:
        block = cuda_gated.GATED_SUB * cuda_gated.GATED_LANES
        if args.num_paths % block:
            return f"--num-paths a multiple of {block}"
    elif args.num_bars > cuda_mc.MAX_KERNEL_BARS or args.num_paths % cuda_mc.SINGLE_LANES:
        return (f"--num-bars <= {cuda_mc.MAX_KERNEL_BARS} and --num-paths a multiple "
                f"of {cuda_mc.SINGLE_LANES}")
    return None


def _kernel_levels(args, rows):
    """The DB's levels at the kernel's width: the first-contact and gated
    kernels' 8 slots, the engine's one slot a level (``max_levels=len(rows)``,
    as the JAX CLI builds them)."""
    from ..ops.cuda_mc import MAX_LEVELS
    from ..types import Levels

    return Levels.from_rows(rows, max_levels=max(len(rows), 1) if args.engine else MAX_LEVELS)


def _backend(args, rows) -> str:
    """``cuda`` or ``torch``: the kernel or the pipeline, on ``--device``."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is false); "
                         "pass --device cpu to run on the CPU")
    need = _fits(args, rows)
    if args.backend == "auto":   # the pipeline where the kernels do not reach
        return "cuda" if args.device == "cuda" and need is None else "torch"
    if args.backend == "cuda":
        if args.device != "cuda":
            raise SystemExit("--backend cuda launches the CUDA kernel and "
                             "needs --device cuda (a CUDA device)")
        if need is not None:
            raise SystemExit(f"the cuda backend needs {need}; use --backend torch")
    return args.backend


def cmd_paths(args):
    from ..sim import enginepath, gatedpath, pathsim
    from ..sim.montecarlo import McNoise
    from ..types import Levels

    _not_ported(args)
    conn = _connect(args)
    try:
        rows, levels, params = _levels_and_params(conn, args)
    finally:
        conn.close()
    backend = _backend(args, rows)

    noise = None
    stds = (args.entry_slip_std, args.level_jitter_std, args.stop_slip_std,
            args.target_slip_std)
    if any(s != 0.0 for s in stds):
        noise = McNoise.make(*stds)
    common = dict(num_paths=args.num_paths, num_bars=args.num_bars, s0=args.s0,
                  sigma=args.sigma, noise=noise, antithetic=args.antithetic,
                  device=args.device, **_sampler_kw(args))
    if backend == "cuda":
        levels = _kernel_levels(args, rows)
    else:
        common["block_paths"] = min(args.num_paths, 1 << (15 if args.engine else 17))
    skips = escal = None
    if args.engine:
        if backend == "cuda":
            from ..ops.cuda_engine import mc_paths_engine_fused as run
        else:
            run = enginepath.mc_paths_engine
        stats, skips, escal = run(args.seed, levels, params, **common)
    elif args.gated:
        gate = gatedpath.GateConfig.from_params(
            params, touch_limit=args.touch_limit,
            cooldown_bars=args.cooldown_bars)
        if backend == "cuda":
            from ..ops.cuda_gated import mc_paths_gated_fused as run
        else:
            run = gatedpath.mc_paths_gated
        stats = run(args.seed, levels, params, gate, **common)
    else:
        if backend == "cuda":
            from ..ops.cuda_mc import mc_paths_fused as run
        else:
            run = pathsim.mc_paths
        stats = run(args.seed, levels, params, **common)
    out = {
        "paths": float(stats.n), "entered": float(stats.n_entered),
        "hit_rate": float(stats.hit_rate), "mean_r": float(stats.mean_r),
        "std_r": float(stats.std_r), "var_05": float(stats.quantile(0.05)),
        "cvar_05": float(stats.cvar(0.05)),
        "best_r": float(stats.max_r), "worst_r": float(stats.min_r),
    }
    if args.gated or args.engine:
        out.update({
            "trades": float(stats.sum_trades),
            "mean_trades": float(stats.mean_trades),
            "mean_dd": float(stats.mean_dd), "max_dd": float(stats.max_dd),
        })
    if args.engine:
        out["escalations"] = int(escal)
        out["skips"] = {r.name: int(n) for r, n in
                        zip(enginepath.SKIP_REASONS, skips.tolist()) if n}
    print(json.dumps(out))
    return 0


def _grid(args) -> list[tuple]:
    """The sweep's rows in the JAX CLI's order: (stop, tp, touch limit, q_min)
    for the first-contact and gated forms (None where an axis is not given),
    (stop, tp, level-jitter std) for the engine."""
    import itertools

    if args.engine:
        return list(itertools.product(args.stops, args.tps, args.jitter_stds or [None]))
    gate_axes = ((args.touch_limits or [None]), (args.qmins or [None])) if args.gated \
        else ([None], [None])
    return list(itertools.product(args.stops, args.tps, *gate_axes))


def _sweep_engine(args, backend, levels, params, combos):
    """(stop, tp[, level-jitter std]) rows over the full engine: one kernel
    launch for the grid (``--backend cuda``), or per-row pipeline runs at
    the same seed (identical paths, exact CRN), as the JAX CLI runs it on the
    CPU.  With ``--jitter-stds`` every row scales the same per-entry noise
    normals by its own level-jitter std."""
    import torch

    from ..ops.kernel_args import grid_row
    from ..sim import enginepath
    from ..sim.montecarlo import McNoise
    from ..sim.pathsim import PathStats

    grid = params.replace(stop_padding=[c[0] for c in combos],
                          tp_padding=[c[1] for c in combos])
    noise = None
    if args.jitter_stds is not None:
        jit = torch.tensor([c[2] for c in combos], dtype=torch.float32)
        noise = McNoise(level_jitter_std=jit,
                        entry_slip_std=torch.full_like(jit, args.entry_slip_std),
                        stop_slip_std=torch.full_like(jit, args.stop_slip_std),
                        target_slip_std=torch.full_like(jit, args.target_slip_std))
    common = dict(num_paths=args.num_paths, num_bars=args.num_bars, s0=args.s0,
                  sigma=args.sigma, device=args.device, **_sampler_kw(args))
    if backend == "cuda":
        from ..ops.cuda_engine import mc_paths_engine_sweep_fused

        stats, _skips, escal = mc_paths_engine_sweep_fused(
            args.seed, levels, grid, noise=noise, **common)
        return stats, escal.tolist()
    per = [enginepath.mc_paths_engine(
        args.seed, levels, grid_row(grid, g), noise=grid_row(noise, g),
        block_paths=min(args.num_paths, 1 << 13), **common) for g in range(len(combos))]
    return PathStats.stack([p[0] for p in per]), [int(p[2]) for p in per]


def cmd_sweep(args):
    from ..parallel import sweep as PS
    from ..sim.gatedpath import GateConfig
    from ..types import Levels

    if not args.gated and (args.touch_limits or args.qmins):
        raise SystemExit("--touch-limits/--qmins require --gated")
    _not_ported(args)
    conn = _connect(args)
    try:
        rows, levels, params = _levels_and_params(conn, args)
    finally:
        conn.close()
    backend = _backend(args, rows)
    if backend == "cuda":
        levels = _kernel_levels(args, rows)
    combos = _grid(args)
    common = dict(num_paths=args.num_paths, num_bars=args.num_bars, s0=args.s0,
                  sigma=args.sigma, device=args.device, **_sampler_kw(args))
    block = dict(block_paths=min(args.num_paths, 1 << 14))
    escal = None
    if args.engine:
        stats, escal = _sweep_engine(args, backend, levels, params, combos)
    elif args.gated:
        # --qmin sets the base gate (GateConfig.from_params); --touch-limits
        # and --qmins put gate knobs on the grid axis
        grid, gate_g = PS.grid_params_gated(
            params, GateConfig.from_params(params), stop_paddings=args.stops,
            tp_paddings=args.tps, touch_limits=args.touch_limits,
            q_min_probs=args.qmins)
        if backend == "cuda":
            from ..ops.cuda_gated import mc_paths_gated_sweep_fused

            stats = mc_paths_gated_sweep_fused(args.seed, levels, params, grid.stop_padding,
                                               grid.tp_padding, gate_g, **common)
        else:
            stats = PS.sweep_paths_gated(args.seed, levels, grid, gate=gate_g,
                                         **common, **block)
    else:
        grid = PS.grid_params(params, stop_paddings=args.stops, tp_paddings=args.tps)
        if backend == "cuda":
            from ..ops.cuda_mc import mc_paths_sweep_fused

            stats = mc_paths_sweep_fused(args.seed, levels, params, grid.stop_padding,
                                         grid.tp_padding, **common)
        else:
            stats = PS.sweep_paths(args.seed, levels, grid, **common, **block)
    for g, combo in enumerate(combos):
        row = {"stop_padding": combo[0], "tp_padding": combo[1],
               "hit_rate": float(stats.hit_rate[g]), "mean_r": float(stats.mean_r[g])}
        if args.engine:
            row.update({"mean_trades": float(stats.mean_trades[g]),
                        "mean_dd": float(stats.mean_dd[g]), "escalations": int(escal[g])})
            if combo[2] is not None:
                row["level_jitter_std"] = combo[2]
        else:
            if combo[2] is not None:
                row["touch_limit"] = combo[2]
            if combo[3] is not None:
                row["q_min_prob"] = combo[3]
            if args.gated:
                row.update({"mean_trades": float(stats.mean_trades[g]),
                            "mean_dd": float(stats.mean_dd[g])})
        print(json.dumps(row))
    return 0


def _veclist(txt, n: int, default: float):
    """[n] float32 values from a comma-separated list (one value: all n), or
    ``default`` for all (the JAX CLI's parsing)."""
    import numpy as np

    if txt is None:
        return np.full(n, default, np.float32)
    vals = np.asarray([float(x) for x in txt.split(",")], np.float32)
    if vals.size == 1:
        return np.full(n, float(vals[0]), np.float32)
    if vals.size != n:
        raise SystemExit(f"expected {n} comma-separated values, got {vals.size}")
    return vals


def cmd_book(args):
    """A correlated book: one-factor co-movement (beta loadings on a shared
    market factor) over the gated lifecycle, or the full engine with
    ``--engine``; one JSON row per symbol, then the book's row (VaR/CVaR of
    the book's R per path, drawdown of its curve over time)."""
    from ..parallel import portfolio as P
    from ..parallel.universe import stack_levels

    if args.exact_tail:
        raise SystemExit("--exact-tail is not ported yet (the exact-tail slice; use "
                         "qmmx_monolithic_monte_carlo_tpu)")
    harvest = args.harvest
    if harvest and not args.engine:
        raise SystemExit("--harvest needs --engine (the label harvest rides the "
                         "full-engine ladder)")
    conn = _connect(args)
    try:
        _rows, _lv, params = _levels_and_params(conn, args)
    finally:
        conn.close()
    n = args.num_symbols
    s0 = _veclist(args.s0s, n, args.s0)
    sigma = _veclist(args.sigmas, n, args.sigma)
    beta = _veclist(args.betas, n, args.beta)
    w = _veclist(args.weights, n, 1.0 / n)
    # a level scaffold around each symbol's spot (the DB holds one symbol's
    # levels), as the JAX CLI builds them
    rows = [[{"color": "blue", "type": "solid", "index": 0, "price": float(s0[s])},
             {"color": "orange", "type": "dashed", "index": 0, "price": float(s0[s]) + 0.4}]
            for s in range(n)]
    levels = stack_levels(rows, max_levels=4)
    backend = _backend(args, rows[0])
    common = dict(num_bars=args.num_bars, antithetic=args.antithetic, device=args.device,
                  **_book_sampler_kw(args, n, backend == "cuda"))
    skips = escal = hv = None
    if args.engine and backend == "cuda":
        from ..ops.cuda_engine import mc_paths_engine_corr_fused

        sym, port, skips, escal, *hv = mc_paths_engine_corr_fused(
            args.seed, levels, params, s0, sigma, beta, w, paths_per_symbol=args.num_paths,
            harvest=harvest, **common)
    elif args.engine:
        sym, port, skips, escal, *hv = P.portfolio_mc_engine(
            args.seed, levels, params, s0, sigma, beta, w, num_paths=args.num_paths,
            block_paths=min(args.num_paths, 1 << 12), harvest=harvest, **common)
    elif backend == "cuda":
        from ..ops.cuda_gated import mc_paths_gated_corr_fused

        sym, port = mc_paths_gated_corr_fused(
            args.seed, levels, params, s0, sigma, beta, w, paths_per_symbol=args.num_paths,
            **common)
    else:
        sym, port = P.portfolio_mc(
            args.seed, levels, params, s0, sigma, beta, w, num_paths=args.num_paths,
            block_paths=min(args.num_paths, 1 << 13), **common)
    hv = hv[0] if hv else None
    if hv is not None:
        # the book's flywheel: each symbol's LR refresh on the labels harvested
        # from the correlated run (ref :3833-3853 per book member)
        from ..models import harvest as HVM
        from ..parallel.universe import universe_policy_refresh

        xs, ys, ws = HVM.ml_batch_from_harvest(hv, stop_padding=float(params.stop_padding))
        ml_refreshed = universe_policy_refresh(None, xs, ys, ws)
    for s in range(n):
        row = {"symbol": s, "beta": round(float(beta[s]), 4), "weight": round(float(w[s]), 4),
               "hit_rate": float(sym.hit_rate[s]), "mean_r": float(sym.mean_r[s]),
               "mean_trades": float(sym.mean_trades[s]), "max_dd": float(sym.max_dd[s])}
        if escal is not None:
            row["escalations"] = int(escal[s])
        if hv is not None:
            row["labeled"] = float(hv.n_labeled[s])
            row["ml_coef"] = [round(float(c), 6) for c in ml_refreshed.coef[s].tolist()]
        print(json.dumps(row))
    print(json.dumps({
        "portfolio": True, "mean_r": float(port.mean_r), "std_r": float(port.std_r),
        "var_05": float(port.quantile(0.05)), "cvar_05": float(port.cvar(0.05)),
        "max_dd": float(port.max_dd), "mean_dd": float(port.mean_dd)}))
    return 0


def cmd_flywheel(args):
    """simulate -> label -> retrain -> re-simulate at path scale
    (``sim/flywheel.policy_iteration``): one JSON row per round, with the
    JAX CLI's keys."""
    from ..sim import enginepath
    from ..sim import flywheel as FW

    conn = _connect(args)
    try:
        rows, levels, params = _levels_and_params(conn, args)
    finally:
        conn.close()
    backend = _backend(args, rows)
    if backend == "cuda":
        levels = _kernel_levels(args, rows)
    rounds = FW.policy_iteration(
        args.seed, levels, params, rounds=args.rounds, num_paths=args.num_paths,
        num_bars=args.num_bars, s0=args.s0, sigma=args.sigma, backend=backend,
        device=args.device, min_samples=args.min_samples,
        arm_policy_gate=args.arm_policy_gate, block_paths=min(args.num_paths, 1 << 13),
        explore_paths=args.explore_paths)
    names = [r.name for r in enginepath.SKIP_REASONS]
    for i, rd in enumerate(rounds):
        st = rd.stats
        print(json.dumps({
            "round": i, "labeled": rd.labeled, "explored": rd.explored,
            "hit_rate": round(float(st.hit_rate), 5), "mean_r": round(float(st.mean_r), 5),
            "trades": float(st.sum_trades), "escalations": rd.escalations,
            "ml_present": bool(rd.ml_model.present),
            "skips": {n: float(s) for n, s in zip(names, rd.skips) if float(s) > 0}}))
    return 0


def _device_flags(parser) -> None:
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where to run; without a GPU, pass --device cpu")
    parser.add_argument("--backend", choices=["auto", "torch", "cuda"],
                        default="auto",
                        help="cuda = the fused CUDA kernel (<=8 levels, even bars; "
                             "--engine: <=64 levels, any bars >= 2, even in a book); "
                             "torch = the streamed PyTorch pipeline on --device; "
                             "auto = the kernel on a CUDA device when the shape fits, "
                             "else the pipeline")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qmmx-torch",
        description="PyTorch/CUDA port of the QMMX Monte Carlo backtesting framework",
    )
    p.add_argument("--db", default="qmmx.db", help="SQLite store path")
    sub = p.add_subparsers(dest="cmd", required=True)

    pa = sub.add_parser("paths")
    pa.add_argument("--num-paths", type=int, default=1 << 20)
    pa.add_argument("--num-bars", type=int, default=40)
    pa.add_argument("--s0", type=float, default=100.0)
    pa.add_argument("--sigma", type=float, default=0.3)
    pa.add_argument("--seed", type=int, default=0)
    pa.add_argument("--antithetic", action="store_true")
    pa.add_argument("--qmin", type=float, default=None)
    pa.add_argument("--sampler",
                    choices=["gbm", "bootstrap", "block_bootstrap", "heston"],
                    default="gbm",
                    help="path sampler: gbm generates; bootstrap/block_bootstrap "
                         "resample RECORDED bars (--bars-csv, real volumes; "
                         "block_ keeps contiguous runs); heston generates "
                         "stochastic-volatility bars")
    pa.add_argument("--block-len", type=int, default=10,
                    help="block_bootstrap: contiguous run length")
    for k, dv in (("v0", 0.04), ("kappa", 3.0), ("theta", 0.04), ("xi", 0.6), ("rho", -0.7)):
        pa.add_argument(f"--heston-{k}", type=float, default=dv,
                        help=f"heston sampler: {k} (default {dv})")
    pa.add_argument("--bars-csv", default=None,
                    help="recorded t,o,h,l,c[,v] history for the bootstrap samplers "
                         "(default: a synthetic 390-bar fixture)")
    _device_flags(pa)
    pa.add_argument("--gated", action="store_true",
                    help="run the engine-gated multi-trade lifecycle per path "
                         "(cooldown/touch-budget/confidence gates, per-path "
                         "equity+drawdown)")
    pa.add_argument("--engine", action="store_true",
                    help="FULL 12-gate engine lifecycle (guard/veto/ML/policy"
                         "/escalation over generated paths, volume-aware)")
    pa.add_argument("--touch-limit", type=int, default=4)
    pa.add_argument("--cooldown-bars", type=int, default=0)
    # execution-noise knobs (reference MC), default off
    pa.add_argument("--entry-slip-std", type=float, default=0.0)
    pa.add_argument("--level-jitter-std", type=float, default=0.0)
    pa.add_argument("--stop-slip-std", type=float, default=0.0)
    pa.add_argument("--target-slip-std", type=float, default=0.0)
    pa.add_argument("--exact-tail", action="store_true", help="not ported yet")
    pa.add_argument("--ckpt-dir", default=None, help="not ported yet")
    pa.set_defaults(fn=cmd_paths)

    sw = sub.add_parser("sweep")
    sw.add_argument("--num-paths", type=int, default=1 << 18)
    sw.add_argument("--num-bars", type=int, default=40)
    sw.add_argument("--s0", type=float, default=100.0)
    sw.add_argument("--sigma", type=float, default=0.3)
    sw.add_argument("--seed", type=int, default=0)
    sw.add_argument("--stops", type=float, nargs="+", default=[0.25, 0.35, 0.45])
    sw.add_argument("--tps", type=float, nargs="+", default=[0.15, 0.25, 0.35])
    sw.add_argument("--qmin", type=float, default=None)
    sw.add_argument("--gated", action="store_true",
                    help="sweep the engine-gated multi-trade lifecycle "
                         "(CRN: every config replays the same paths)")
    sw.add_argument("--touch-limits", type=int, nargs="+", default=None,
                    help="gated only: put LEVEL_OVERTOUCHED budgets on the "
                         "grid axis (cartesian with stops/tps/qmins)")
    sw.add_argument("--qmins", type=float, nargs="+", default=None,
                    help="gated only: put Q_MIN_PROB values on the grid axis")
    sw.add_argument("--engine", action="store_true",
                    help="sweep the FULL 12-gate engine lifecycle (CRN; one "
                         "kernel launch for the grid with --backend cuda)")
    sw.add_argument("--sampler", choices=["gbm", "bootstrap", "block_bootstrap"],
                    default="gbm",
                    help="bootstrap family sweeps the knob grid over RECORDED bars "
                         "(--bars-csv) with CRN: identical resample indices and paths "
                         "per row")
    sw.add_argument("--bars-csv", default=None,
                    help="recorded t,o,h,l,c[,v] history for --sampler bootstrap "
                         "(default: a synthetic 390-bar fixture)")
    sw.add_argument("--block-len", type=int, default=10,
                    help="block_bootstrap: contiguous run length")
    sw.add_argument("--jitter-stds", type=float, nargs="+", default=None,
                    help="engine only: put level-jitter stds on the grid axis "
                         "(cartesian with stops/tps); every row replays the "
                         "same noise normals scaled by its std")
    sw.add_argument("--entry-slip-std", type=float, default=0.0)
    sw.add_argument("--stop-slip-std", type=float, default=0.0)
    sw.add_argument("--target-slip-std", type=float, default=0.0)
    _device_flags(sw)
    sw.set_defaults(fn=cmd_sweep)

    bk = sub.add_parser("book", help="correlated book of symbols with book-level "
                        "VaR/CVaR/drawdown (one-factor beta co-movement over the gated "
                        "lifecycle, or the full engine)")
    bk.add_argument("--num-symbols", type=int, default=8)
    bk.add_argument("--num-paths", type=int, default=1 << 16, help="paths per symbol")
    bk.add_argument("--num-bars", type=int, default=40)
    bk.add_argument("--s0", type=float, default=100.0)
    bk.add_argument("--sigma", type=float, default=0.3)
    bk.add_argument("--beta", type=float, default=0.6,
                    help="shared market loading (or --betas per symbol)")
    bk.add_argument("--s0s", type=str, default=None, help="comma-separated per-symbol spots")
    bk.add_argument("--sigmas", type=str, default=None)
    bk.add_argument("--betas", type=str, default=None)
    bk.add_argument("--weights", type=str, default=None,
                    help="comma-separated book weights (default equal)")
    bk.add_argument("--seed", type=int, default=0)
    bk.add_argument("--qmin", type=float, default=None)
    bk.add_argument("--engine", action="store_true",
                    help="run the FULL 12-gate engine ladder per symbol instead of the "
                         "gated subset")
    bk.add_argument("--antithetic", action="store_true",
                    help="antithetic book pairs: market AND idio shocks sign-flipped per "
                         "pair")
    bk.add_argument("--exact-tail", action="store_true", help="not ported yet")
    bk.add_argument("--harvest", action="store_true",
                    help="with --engine: harvest each symbol's closed-trade labels and "
                         "refresh its ML gate on them (the labeled and ml_coef keys)")
    bk.add_argument("--sampler", choices=["gbm", "bootstrap", "block_bootstrap", "heston"],
                    default="gbm",
                    help="bootstrap family replays JOINT recorded days (shared resample "
                         "indices: the book co-moves exactly as the joint history did; "
                         "--bars-csv, real volumes); heston correlates price AND vol shocks "
                         "through beta (gated and --engine ladders, both backends)")
    bk.add_argument("--bars-csv", default=None,
                    help="recorded t,o,h,l,c[,v] history for the bootstrap samplers "
                         "(shared geometry, rebased per symbol; default: a synthetic "
                         "390-bar fixture)")
    bk.add_argument("--block-len", type=int, default=10,
                    help="block_bootstrap: contiguous run length")
    for k, dv in (("v0", 0.04), ("kappa", 3.0), ("theta", 0.04), ("xi", 0.6), ("rho", -0.7)):
        bk.add_argument(f"--heston-{k}", type=float, default=dv,
                        help=f"heston sampler: {k} (default {dv})")
    _device_flags(bk)
    bk.set_defaults(fn=cmd_book, gated=True)

    fw = sub.add_parser("flywheel", help="simulate->label->retrain->re-simulate policy "
                        "iteration at path scale")
    fw.add_argument("--rounds", type=int, default=2)
    fw.add_argument("--num-paths", type=int, default=1 << 16)
    fw.add_argument("--num-bars", type=int, default=40)
    fw.add_argument("--s0", type=float, default=100.0)
    fw.add_argument("--sigma", type=float, default=0.3)
    fw.add_argument("--seed", type=int, default=0)
    fw.add_argument("--qmin", type=float, default=None)
    fw.add_argument("--min-samples", type=int, default=50,
                    help="retrain gate (>=50 labeled trades, ref :3838)")
    fw.add_argument("--explore-paths", type=int, default=0,
                    help="per armed round, also harvest this many gates-off exploration "
                         "paths and merge them before the model refresh (fixes pure "
                         "on-policy retraining's survivorship collapse)")
    fw.add_argument("--arm-policy-gate", action="store_true",
                    help="also arm the refreshed OnlinePolicy two-head gate (chosen >= "
                         "0.60 vetoes everything when the win rate is below 60%%: the "
                         "reference's DISABLE_POLICY_GATE posture is the default)")
    _device_flags(fw)
    fw.set_defaults(fn=cmd_flywheel, engine=True, gated=False)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
