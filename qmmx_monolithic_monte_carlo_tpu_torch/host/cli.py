"""Command-line interface of the port.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/host/cli.py`` for the
subcommand the port carries so far:

  paths   — generated-path Monte Carlo at scale (gbm sampler): first-contact
            replay, or with ``--gated`` the engine-gated multi-trade lifecycle

``--device`` (default ``cuda``) says where it runs; without a GPU the CLI
exits unless ``--device cpu`` is given.  ``--backend cuda`` runs the fused
CUDA kernel (``ops/cuda_mc.py``, or ``ops/cuda_gated.py`` with ``--gated``),
``--backend torch`` the streamed PyTorch pipeline (``sim/pathsim.py`` or
``sim/gatedpath.py``) on ``--device``, and ``auto`` the kernel on a CUDA
device when the shape fits it and the pipeline otherwise; it never changes
the device.  The output JSON carries the JAX CLI's keys.  Options of the JAX
CLI whose code is not ported yet exit with a "not ported yet" message.

    python -m qmmx_monolithic_monte_carlo_tpu_torch.host.cli paths --backend cuda
    python -m qmmx_monolithic_monte_carlo_tpu_torch.host.cli paths --gated --backend cuda
"""

from __future__ import annotations

import argparse
import json
import sys


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
    levels = Levels.from_rows(rows, max_levels=64)
    params = EngineParams.from_settings(lambda k, d=None: _db.settings_get(conn, k, d))
    if args.qmin is not None:
        params = params.replace(q_min_prob=args.qmin)
    return rows, levels, params


def _not_ported(args) -> None:
    for flag, on in (("--engine", args.engine),
                     ("--exact-tail", args.exact_tail),
                     ("--ckpt-dir", args.ckpt_dir is not None),
                     (f"--sampler {args.sampler}", args.sampler != "gbm")):
        if on:
            raise SystemExit(
                f"{flag} is not ported yet: the port runs the gbm "
                "first-contact and gated paths (use qmmx_monolithic_monte_carlo_tpu)")


def _backend(args, rows) -> str:
    """``cuda`` or ``torch``: the kernel or the pipeline, on ``--device``."""
    import torch

    from ..ops import cuda_gated, cuda_mc

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is false); "
                         "pass --device cpu to run on the CPU")
    block = cuda_gated.GATED_SUB * cuda_gated.GATED_LANES
    fits = len(rows) <= cuda_mc.MAX_LEVELS and (
        args.num_paths % block == 0 and args.num_bars % 2 == 0
        if args.gated else args.num_bars <= cuda_mc.MAX_KERNEL_BARS)
    if args.backend == "auto":
        return "cuda" if args.device == "cuda" and fits else "torch"
    if args.backend == "cuda":
        if args.device != "cuda":
            raise SystemExit("--backend cuda launches the CUDA kernel and "
                             "needs --device cuda (a CUDA device)")
        if len(rows) > cuda_mc.MAX_LEVELS:
            raise SystemExit(f"the cuda backend supports up to "
                             f"{cuda_mc.MAX_LEVELS} levels; use --backend torch")
        if args.gated and not fits:
            raise SystemExit(
                f"the cuda gated backend needs --num-paths a multiple of {block} "
                "and an even --num-bars; use --backend torch")
    return args.backend


def cmd_paths(args):
    from ..sim import gatedpath, pathsim
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
                  device=args.device)
    if backend == "cuda":
        from ..ops.cuda_mc import MAX_LEVELS

        levels = Levels.from_rows(rows, max_levels=MAX_LEVELS)
    else:
        common["block_paths"] = min(args.num_paths, 1 << 17)
    if args.gated:
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
    if args.gated:
        out.update({
            "trades": float(stats.sum_trades),
            "mean_trades": float(stats.mean_trades),
            "mean_dd": float(stats.mean_dd), "max_dd": float(stats.max_dd),
        })
    print(json.dumps(out))
    return 0


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
                    default="gbm", help="path sampler (only gbm is ported)")
    pa.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where to run; without a GPU, pass --device cpu")
    pa.add_argument("--backend", choices=["auto", "torch", "cuda"],
                    default="auto",
                    help="cuda = the fused CUDA kernel (<=8 levels); torch = "
                         "the streamed PyTorch pipeline on --device; auto = "
                         "the kernel on a CUDA device when the shape fits, "
                         "else the pipeline")
    pa.add_argument("--gated", action="store_true",
                    help="run the engine-gated multi-trade lifecycle per path "
                         "(cooldown/touch-budget/confidence gates, per-path "
                         "equity+drawdown)")
    pa.add_argument("--engine", action="store_true", help="not ported yet")
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
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
