"""Command-line interface of the port.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/host/cli.py`` for the
subcommand the port carries so far:

  paths   — generated-path first-contact MC at scale (gbm sampler)

``--backend cuda`` runs the fused CUDA kernel (``ops/cuda_mc.py``),
``--backend torch`` the streamed PyTorch pipeline (``sim/pathsim.py``) on the
CPU, and ``auto`` picks ``cuda`` when a CUDA device is present.  The output
JSON carries the JAX CLI's keys.  Options of the JAX CLI whose code is not
ported yet exit with a "not ported yet" message.

    python -m qmmx_monolithic_monte_carlo_tpu_torch.host.cli paths --backend cuda
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
    for flag, on in (("--gated", args.gated), ("--engine", args.engine),
                     ("--exact-tail", args.exact_tail),
                     ("--ckpt-dir", args.ckpt_dir is not None),
                     (f"--sampler {args.sampler}", args.sampler != "gbm")):
        if on:
            raise SystemExit(
                f"{flag} is not ported yet: the port runs the gbm "
                "first-contact path (use qmmx_monolithic_monte_carlo_tpu)")


def cmd_paths(args):
    import torch

    from ..sim import pathsim
    from ..sim.montecarlo import McNoise

    _not_ported(args)
    backend = args.backend
    if backend == "auto":
        backend = "cuda" if torch.cuda.is_available() else "torch"
    if backend == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--backend cuda needs a CUDA device "
                         "(torch.cuda.is_available() is false)")
    conn = _connect(args)
    try:
        rows, levels, params = _levels_and_params(conn, args)
    finally:
        conn.close()

    noise = None
    stds = (args.entry_slip_std, args.level_jitter_std, args.stop_slip_std,
            args.target_slip_std)
    if any(s != 0.0 for s in stds):
        noise = McNoise.make(*stds)
    if backend == "cuda":
        from ..ops.cuda_mc import MAX_LEVELS, mc_paths_fused
        from ..types import Levels

        if len(rows) > MAX_LEVELS:
            raise SystemExit(f"the cuda backend supports up to {MAX_LEVELS} "
                             "levels; use --backend torch")
        small = Levels.from_rows(rows, max_levels=MAX_LEVELS)
        stats = mc_paths_fused(
            args.seed, small, params,
            num_paths=args.num_paths, num_bars=args.num_bars, s0=args.s0,
            sigma=args.sigma, noise=noise, antithetic=args.antithetic,
            device="cuda")
    else:
        stats = pathsim.mc_paths(
            args.seed, levels, params,
            num_paths=args.num_paths, num_bars=args.num_bars, s0=args.s0,
            sigma=args.sigma, block_paths=min(args.num_paths, 1 << 17),
            antithetic=args.antithetic, noise=noise)
    out = {
        "paths": float(stats.n), "entered": float(stats.n_entered),
        "hit_rate": float(stats.hit_rate), "mean_r": float(stats.mean_r),
        "std_r": float(stats.std_r), "var_05": float(stats.quantile(0.05)),
        "cvar_05": float(stats.cvar(0.05)),
        "best_r": float(stats.max_r), "worst_r": float(stats.min_r),
    }
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
    pa.add_argument("--backend", choices=["auto", "torch", "cuda"],
                    default="auto",
                    help="cuda = the fused CUDA kernel (<=8 levels); torch = "
                         "the streamed PyTorch pipeline on the CPU; auto "
                         "picks cuda when a CUDA device is present")
    pa.add_argument("--gated", action="store_true", help="not ported yet")
    pa.add_argument("--engine", action="store_true", help="not ported yet")
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
