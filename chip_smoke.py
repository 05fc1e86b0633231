#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (qmmx_monolithic_monte_carlo_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device — require CUDA; print the nvidia-smi name and power limit; TF32 off;
2. build  — compile the CUDA kernels from ops/csrc/ into build/kernels/, one
   nvcc per source, all started together;
   first contact (kernel #1, ops/csrc/mc_first_contact.cu):
3. injected uniforms — kernel vs plain PyTorch version on the same uniforms
   (W = 40, lanes 8192, 16 blocks; plain, execution noise, antithetic);
4. Philox — kernel vs plain version on the Philox stream at 2^22 paths, and
   the row-reduction kernel vs its plain version on the kernel's rows;
   kernel and plain timed at 2^24 paths;
5. main path — the port CLI's ``paths --backend cuda`` at the benchmark's
   size (2^28 paths x 40 bars, sigma 0.3), launch counts set to 0 just
   before and read just after, the output checked, paths/s timed;
   gated lifecycle (kernel #4, ops/csrc/mc_gated.cu):
6. injected uniforms — kernel on the card vs plain version on CPU copies,
   path by path (W = 40, lanes 1024, 16 blocks of 8 x 1024 = 131072 paths;
   engine defaults, multi-trade, tight gates, execution noise, antithetic);
   every path that differs is traced bar by bar: the plain lifecycle over
   the card's bars must equal the kernel's row exactly, and over the CPU's
   bars must part from it at a bar where a decision flips;
7. Philox — kernel vs plain version, both on the card, path by path at 2^22
   paths with and without noise; the row fold vs its plain fold; kernel and
   plain timed at 2^24 paths;
8. main path — the port CLI's ``paths --gated --backend cuda`` at 2^28 paths
   x 40 bars, launch counts set to 0 just before and read just after, the
   output checked, paths/s timed; the kernel alone timed at 2^28.

Tolerances.  First contact (phases 3-4): the kernel sums each path's log
increments serially in float32 and uses CUDA's logf/expf/sincosf, the plain
version PyTorch's; their ulps flip O(1) threshold crossings per 1024 paths.
So: n exact; entered/tp/stop/open within F = 2 + paths/1024; sum_r within
F * max|R|; histogram L1 within 2F; min_r and max_r within 1e-3.
Gated (phases 6-7): the same ulps, and a flipped decision persists within its
path.  So, path by path: at most F paths differ, a path differing when its
(trades, wins, losses, open) differ or its equity or dd moved by more than
1e-3 per trade (a flip can keep the counts and move a trade); 1e-3 per trade
is the drift of paths that agree, because a log-price ulp (4.8e-7 near log
100) moves a price by ~6 price ulps and R = reward / risk (risk >= 0.3)
carries it on.  On totals: n exact; entered within F; histogram L1 within
2F; sums within F * max|equity|.  The row folds: counts exact, float64 sums
within 1e-9 relative.

Bounds (``bound_ms``): the larger of the bytes each kernel must move over
3.35 TB/s and its operations over the card's peak rate for their type: float32
operations over 67 TFLOP/s (the H100 SXM's dense float32 peak), and the
issue rates of the special-function unit (logf, expf, sqrtf and division
each take one MUFU operation, 16 per SM per clock) and of 32-bit integer
multiplies (Philox4x32-10: 40 per call, 64 per SM per clock), at the card's
``clocks.max.sm`` and SM count.  The work depends on the data (where paths
enter, how long they hold), so it is counted by the plain versions on the
first 2^22 paths of the timed inputs and scaled to their size.

The line before last is a JSON object of the kernels (route, source, the TPU
kernel each replaces, launches in its main-path run, max error, times and
bounds); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

NUM_BARS = 40
SIGMA = 0.3
DT = 1.0 / (390.0 * 252.0)
MAIN_PATHS = 1 << 28
PHILOX_PATHS = 1 << 22
PLAIN_PATHS = 1 << 24
LANES = 8192
GATED_LANES = 1024
GATED_INJECT_BLOCKS = 16
CSRC = "qmmx_monolithic_monte_carlo_tpu_torch/ops/csrc/"
FC_SOURCE = CSRC + "mc_first_contact.cu"
GATED_SOURCE = CSRC + "mc_gated.cu"
FC_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:584"
GATED_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:1067"
# the port CLI's levels when its DB is empty (host/cli.py), for the work counts
CLI_ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
            {"color": "orange", "type": "dashed", "index": 0, "price": 100.4},
            {"color": "teal", "type": "solid", "index": 0, "price": 99.7}]
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
SFU_PER_SM_CLK = 16
IMUL_PER_SM_CLK = 64
PHILOX_IMULS = 40


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Card:
    """Peak rates of this card for the bounds."""

    def __init__(self, clock_mhz: float, sms: int):
        self.clock_hz, self.sms = clock_mhz * 1e6, sms

    def bound(self, *, bytes_: float, f32: float, sfu: float, imul: float) -> dict:
        parts = {
            "bytes_ms": bytes_ / HBM_BYTES_S * 1e3,
            "f32_ms": f32 / F32_FLOPS * 1e3,
            "sfu_ms": sfu / (SFU_PER_SM_CLK * self.sms * self.clock_hz) * 1e3,
            "imul_ms": imul / (IMUL_PER_SM_CLK * self.sms * self.clock_hz) * 1e3,
        }
        ms = max(parts.values())
        return {"bound_ms": ms,
                "bound_by": "bytes" if parts["bytes_ms"] == ms else "operations",
                "bound_parts": parts}


def fc_ops(work, entered: int, scale: float) -> dict:
    """Operations of the first-contact kernel (no noise) from the plain
    version's work counts [Box-Muller pairs, bars walked, bars after contact],
    scaled by ``scale``."""
    pairs, walked, post = (float(x) * scale for x in work)
    entered *= scale
    logf = pairs + 2 * post
    sqrtf = pairs + 2 * post
    expf = (walked - post) + entered + 2 * post     # closes, the entry's open, high/low
    sincos = pairs
    div = entered                                   # reward / risk
    philox = 2 * pairs + 2 * post
    # float32 work counted one operation per transcendental plus ~20 per bar
    f32 = logf + sqrtf + expf + 2 * sincos + div + 20 * walked
    return dict(f32=f32, sfu=logf + sqrtf + expf + div, imul=PHILOX_IMULS * philox)


def gated_ops(n_paths: float, held: float, trades: float) -> dict:
    """Operations of the gated kernel (no noise) for ``n_paths`` paths of
    NUM_BARS bars, ``held`` bars on which a position was open (bridge high/low
    evaluated) and ``trades`` entries."""
    pairs = n_paths * NUM_BARS / 2
    bars = n_paths * NUM_BARS
    logf = pairs + 2 * held
    sqrtf = pairs + 2 * held
    expf = bars + n_paths + 2 * held                # closes, bar 0's prev close, high/low
    div = 2 * trades                                # confidence, reward / risk
    philox = n_paths * NUM_BARS                     # W calls of four words a path
    f32 = logf + sqrtf + expf + 2 * pairs + div + 30 * bars
    return dict(f32=f32, sfu=logf + sqrtf + expf + div, imul=PHILOX_IMULS * philox)


def compare(name: str, want, got, n_paths: int) -> float:
    """Hold first-contact kernel totals ``got`` against plain totals ``want``
    (both (int64 counts, float64 floats)); returns |delta mean R|."""
    wc, wf = (t.cpu() for t in want)
    gc, gf = (t.cpu() for t in got)
    flips = 2 + n_paths // 1024
    bad = []
    if int(gc[0]) != int(wc[0]) or int(wc[0]) != n_paths:
        bad.append(f"n {int(gc[0])} vs {int(wc[0])}")
    for i, fld in enumerate(("entered", "tp", "stop", "open"), start=1):
        if abs(int(gc[i]) - int(wc[i])) > flips:
            bad.append(f"{fld} {int(gc[i])} vs {int(wc[i])} (budget {flips})")
    max_abs_r = max(abs(float(wf[2])), abs(float(wf[3])))
    if abs(float(gf[0]) - float(wf[0])) > flips * max_abs_r:
        bad.append(f"sum_r {float(gf[0])} vs {float(wf[0])}")
    l1 = int((gc[5:] - wc[5:]).abs().sum())
    if l1 > 2 * flips:
        bad.append(f"hist L1 {l1} > {2 * flips}")
    for j, fld in ((2, "min_r"), (3, "max_r")):
        if abs(float(gf[j]) - float(wf[j])) > 1e-3:
            bad.append(f"{fld} {float(gf[j])} vs {float(wf[j])}")
    d_mean = abs(float(gf[0]) / max(int(gc[1]), 1)
                 - float(wf[0]) / max(int(wc[1]), 1))
    log(f"  {name}: entered {int(gc[1])}/{int(wc[1])} tp {int(gc[2])}/{int(wc[2])} "
        f"stop {int(gc[3])}/{int(wc[3])} open {int(gc[4])}/{int(wc[4])} "
        f"sum_r {float(gf[0]):.6f}/{float(wf[0]):.6f} hist L1 {l1} "
        f"|d mean_r| {d_mean:.3e}")
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with plain: {bad}")
    return d_mean


def compare_gated(name: str, want, got, n_paths: int):
    """Hold gated kernel output ``got`` against the plain version's ``want``
    (both (int64 counts, float64 floats, f32[P, 6] per-path rows)), path by
    path and on totals; returns the largest |d equity| or |d dd| on the paths
    that agree, and the bool[P] mask of the paths that differ."""
    import torch

    wc, wf, wr = (t.cpu() for t in want[:3])
    gc, gf, gr = (t.cpu() for t in got[:3])
    flips = 2 + n_paths // 1024
    bad = []
    if int(gc[0]) != int(wc[0]) or int(wc[0]) != n_paths:
        bad.append(f"n {int(gc[0])} vs {int(wc[0])}")
    if abs(int(gc[1]) - int(wc[1])) > flips:
        bad.append(f"entered {int(gc[1])} vs {int(wc[1])} (budget {flips})")
    l1 = int((gc[6:] - wc[6:]).abs().sum())
    if l1 > 2 * flips:
        bad.append(f"hist L1 {l1} > {2 * flips}")
    max_eq = float(wr[:, 0].abs().max())
    for j, fld in ((0, "sum_eq"), (2, "sum_dd")):
        if abs(float(gf[j]) - float(wf[j])) > flips * max(max_eq, 1.0):
            bad.append(f"{fld} {float(gf[j])} vs {float(wf[j])}")
    # a flipped decision may keep a path's counts and still move its trades,
    # so a path differs when its counts differ or its equity/dd moved more
    # than the ulp drift allows (1e-3 per trade)
    err = (gr[:, [0, 5]] - wr[:, [0, 5]]).abs().amax(dim=1)
    differ = ((gr[:, 1:5] != wr[:, 1:5]).any(dim=1)
              | (err > 1e-3 * torch.clamp(wr[:, 1], min=1.0)))
    if int(differ.sum()) > flips:
        bad.append(f"{int(differ.sum())} paths differ (budget {flips})")
    max_err = float(err[~differ].max()) if bool((~differ).any()) else 0.0
    log(f"  {name}: entered {int(gc[1])}/{int(wc[1])} trades {int(gc[5])}/{int(wc[5])} "
        f"wins {int(gc[2])}/{int(wc[2])} losses {int(gc[3])}/{int(wc[3])} "
        f"open {int(gc[4])}/{int(wc[4])} sum_eq {float(gf[0]):.6f}/{float(wf[0]):.6f} "
        f"hist L1 {l1}; paths differing {int(differ.sum())}, max |d eq|,|d dd| "
        f"elsewhere {max_err:.3e}")
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with plain: {bad}")
    return max_err, differ


def lifecycle_trace(bars, tie, nzs, levels, params, gate, noise):
    """Drive the plain ``Lifecycle`` over ``bars`` on the CPU, recording after
    every bar its integer state (side, trades, wins, losses, cooldown, touch
    counts, last touch bars) as int[P, W, k] and (entry, stop, target,
    equity) as f32[P, W, 4]; returns (outcome, ints, floats)."""
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import Lifecycle

    life = Lifecycle(bars.open[:, 0], levels, params, gate, noise=noise)
    ints, floats = [], []
    for t in range(bars.close.shape[1]):
        nz = tuple(n[:, t] for n in nzs) if nzs is not None else None
        life.step(t, bars.high[:, t], bars.low[:, t], bars.close[:, t], tie[:, t], nz)
        ints.append(torch.cat([torch.stack([life.side, life.trades, life.wins,
                                            life.losses, life.cooldown], 1),
                               life.touch, life.last_tb], 1))
        floats.append(torch.stack([life.entry, life.stop, life.target, life.equity], 1))
    return life.outcome(), torch.stack(ints, 1), torch.stack(floats, 1)


def trace_flips(name, u, differ, kernel_rows, cpu_rows, levels, params, gate,
                noise, antithetic, dev) -> dict:
    """Show that the paths on which the kernel and the plain version on CPU
    copies differ are flipped decisions, not a kernel fault.

    The bars are generated twice from the same uniforms, by the plain version
    on the CPU and on the card (PyTorch's transcendentals against CUDA's),
    and the same plain ``Lifecycle`` runs on the CPU over each.  Checks, for
    every differing path: the run over the card's bars equals the kernel's
    per-path row exactly, the run over the CPU's bars equals the plain row,
    and the two runs' integer state parts at some bar (a stop, target, tie,
    entry, direction, level or touch decision went the other way).  Prints
    the first flipped bar of the first path whose counts agree, with the bar's
    close/high/low on both sides in ulps."""
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_gated
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import GatedLayout

    idx = torch.nonzero(differ).flatten()
    if idx.numel() == 0:
        return {"paths": 0}
    layout = GatedLayout(NUM_BARS, noise is not None)
    kw = dict(s0=100.0, mu=0.0, sigma=SIGMA, dt=DT, antithetic=antithetic)
    runs = []
    for src in (u, u.to(dev)):
        bars, tie, nzs = cuda_gated.gated_bars_from_uniforms(src, layout, **kw)
        pick = type(bars)(*(x[idx.to(x.device)].cpu() for x in bars))
        runs.append((pick, tie[idx.to(tie.device)].cpu(),
                     None if nzs is None else nzs[:, idx.to(nzs.device)].cpu()))
    (b_cpu, _, _), (b_dev, _, _) = runs
    out_cpu, i_cpu, f_cpu = lifecycle_trace(*runs[0], levels, params, gate, noise)
    out_dev, i_dev, f_dev = lifecycle_trace(*runs[1], levels, params, gate, noise)

    def rows(o):
        return torch.stack([o.equity, o.trades.float(), o.wins.float(),
                            o.losses.float(), o.open_at_end.float(), o.max_dd], 1)

    if not torch.equal(rows(out_dev), kernel_rows[idx]):
        raise AssertionError(f"{name}: the kernel differs from the plain lifecycle "
                             "on the card's own bars")
    if not torch.equal(rows(out_cpu), cpu_rows[idx]):
        raise AssertionError(f"{name}: the traced lifecycle differs from the plain version")
    parted = (i_cpu != i_dev).any(dim=2)                        # [n, W]
    if not bool(parted.any(dim=1).all()):
        raise AssertionError(f"{name}: a differing path shows no flipped decision")
    flip_bar = parted.int().argmax(dim=1)

    def ulps(a, b):
        return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()

    bar_ulps = torch.stack([ulps(getattr(b_cpu, k), getattr(b_dev, k)).amax(dim=1)
                            for k in ("close", "high", "low")], 1)
    same_counts = (kernel_rows[idx, 1:5] == cpu_rows[idx, 1:5]).all(dim=1)
    log(f"  {name}: {idx.numel()} differing paths ({int(same_counts.sum())} with "
        f"equal counts), each traced to a flipped decision at bars "
        f"{flip_bar.tolist()}; bars differ by at most "
        f"{int(bar_ulps.max())} ulps; kernel == plain lifecycle on the card's bars")
    if bool(same_counts.any()):
        k = int(torch.nonzero(same_counts).flatten()[0])
        t = int(flip_bar[k])
        cols = ("side", "trades", "wins", "losses")

        lv = levels.price[levels.valid]

        def at(b, fs, i, tt):
            st = fs[k, tt - 1].tolist() if tt > 0 else [0.0] * 4
            dist = float((b.close[k, tt] - lv).abs().min())
            return (f"close {b.close[k, tt]:.9g} high {b.high[k, tt]:.9g} "
                    f"low {b.low[k, tt]:.9g} level dist {dist:.9g} "
                    f"(prox {params.contact_prox}) | before: entry {st[0]:.9g} "
                    f"stop {st[1]:.9g} target {st[2]:.9g} | after: "
                    + " ".join(f"{c} {int(v)}" for c, v in zip(cols, i[k, tt, :4])))

        log(f"    path {int(idx[k])} flips at bar {t} "
            f"(close/high/low differ by "
            f"{[int(ulps(getattr(b_cpu, c)[k, t:t + 1], getattr(b_dev, c)[k, t:t + 1])) for c in ('close', 'high', 'low')]} ulps there):")
        log(f"      cpu bars : {at(b_cpu, f_cpu, i_cpu, t)}")
        log(f"      card bars: {at(b_dev, f_dev, i_dev, t)}")
        log(f"      equity: plain on CPU {float(cpu_rows[idx[k], 0]):.7g}, lifecycle "
            f"on the card's bars {float(out_dev.equity[k]):.7g}, kernel "
            f"{float(kernel_rows[idx[k], 0]):.7g}")
    return {"paths": idx.numel(), "equal_counts": int(same_counts.sum()),
            "max_bar_ulps": int(bar_ulps.max())}


def check_fold(name, plain, got) -> float:
    """A row-fold kernel's totals ``got`` against its plain fold ``plain``;
    returns the largest float error."""
    plain_c, plain_f = (t.cpu() for t in plain)
    got_c, got_f = (t.cpu() for t in got)
    if not bool((plain_c == got_c).all()):
        raise AssertionError(f"{name} counts differ from the plain fold")
    diff = (got_f - plain_f).abs()
    # float64 folds of float32 rows in two orders: relative 1e-9 is ample
    if float((diff / plain_f.abs().clamp(min=1.0)).max()) > 1e-9:
        raise AssertionError(f"{name} floats differ by {diff.tolist()}")
    return float(diff.max())


def run_cli(cli, argv, reset, launches) -> tuple[dict, list[float], dict]:
    """The CLI four times (one warm-up, three timed), the launch counts set to
    0 just before and read just after; returns (output, seconds, launches)."""
    import torch

    reset()
    secs = []
    for _ in range(4):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if rc != 0:
            raise AssertionError(f"cli exited {rc}")
    counts = dict(launches)
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"  cli output: {json.dumps(out)}")
    log(f"  launches in the main-path runs: {counts}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    if not all(isinstance(v, float) and math.isfinite(v) for v in out.values()):
        raise AssertionError(f"non-finite cli output: {out}")
    if out["paths"] != float(MAIN_PATHS) or not out["entered"] > 0:
        raise AssertionError(f"unexpected path counts: {out}")
    if not 0.0 < out["hit_rate"] < 1.0:
        raise AssertionError(f"hit_rate out of (0, 1): {out}")
    rep_s = sum(secs[1:]) / 3
    log(f"  cli wall per run: warm-up {secs[0]:.3f} s, reps "
        f"{', '.join(f'{s:.3f}' for s in secs[1:])} s -> "
        f"{MAIN_PATHS / rep_s:.6e} paths/s end to end")
    return out, secs, counts


def main() -> int:
    import torch

    # ---- phase 1: device
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: "
                           "this smoke test needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.host import cli
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_gated, cuda_mc
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import GatedLayout
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import GateConfig
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
    from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels
    from qmmx_monolithic_monte_carlo_tpu_torch.utils import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = Card(float(clock), torch.cuda.get_device_properties(0).multi_processor_count)
    log(f"[1] device: torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}; {card.sms} SMs, "
        f"clocks.max.sm {clock} MHz")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- phase 2: build, one nvcc per source, all at once
    t0 = time.perf_counter()
    build.build_all(["mc_first_contact", "mc_gated"])
    log(f"[2] build: {time.perf_counter() - t0:.2f} s wall")
    for name, info in build.BUILD_LOG.items():
        log(f"  {name}: nvcc {info['seconds']:.2f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill",
                                       "error")):
                log(f"    ptxas: {line.strip()}")

    levels = Levels.from_rows(
        [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
         {"color": "orange", "type": "dashed", "index": 0, "price": 100.4}],
        max_levels=8)
    cli_levels = Levels.from_rows(CLI_ROWS, max_levels=8)
    params = EngineParams.default()
    noise = McNoise.make(entry_slip_std=0.01, level_jitter_std=0.02,
                         stop_slip_std=0.015, target_slip_std=0.015)
    common = dict(num_bars=NUM_BARS, s0=100.0, mu=0.0, sigma=SIGMA, dt=DT,
                  lanes=LANES)

    # ---- phase 3: first contact, injected uniforms
    log("[3] first contact, injected uniforms: kernel vs plain (plain on CPU copies)")
    fc_err = 0.0
    n_blocks = 16
    for case, nz, anti in (("plain", None, False), ("noise", noise, False),
                           ("antithetic", None, True),
                           ("noise+antithetic", noise, True)):
        n_rows = 3 * NUM_BARS + 1 + (4 if nz is not None else 0)
        rng = np.random.default_rng(len(case))
        u = torch.from_numpy(
            rng.uniform(1e-9, 1.0, (n_blocks, n_rows, LANES)).astype(np.float32))
        kw = dict(common, num_paths=n_blocks * LANES, noise=nz, antithetic=anti)
        want = cuda_mc.fused_totals_reference(0, levels, params,
                                              external_uniforms=u, **kw)
        rows = cuda_mc.first_contact_rows(0, levels, params, device=dev,
                                          external_uniforms=u.to(dev), **kw)
        got = cuda_mc.reduce_rows(*rows)
        torch.cuda.synchronize()
        fc_err = max(fc_err, compare(case, want, got, n_blocks * LANES))

    # ---- phase 4: first contact, Philox stream, and the row reduction
    log(f"[4] first contact, Philox: kernel vs plain at {PHILOX_PATHS} paths "
        "(plain on the card)")
    reduce_err = 0.0
    for case, nz, anti in (("philox", None, False), ("philox+noise", noise, True)):
        kw = dict(common, num_paths=PHILOX_PATHS, noise=nz, antithetic=anti)
        want = cuda_mc.fused_totals_reference(7, levels, params, device=dev, **kw)
        rows = cuda_mc.first_contact_rows(7, levels, params, device=dev,
                                          external_uniforms=None, **kw)
        got = cuda_mc.reduce_rows(*rows)
        torch.cuda.synchronize()
        fc_err = max(fc_err, compare(case, want, got, PHILOX_PATHS))
        reduce_err = max(reduce_err, check_fold(
            "mc_reduce_rows", cuda_mc.reduce_rows_reference(*rows), got))
    log(f"  mc_reduce_rows: counts exact, float max abs err {reduce_err:.3e}")

    # kernel and plain times at PLAIN_PATHS on the main path's inputs (seed 0,
    # the CLI's levels, Philox, no noise); the work sample for the bounds
    kw = dict(common, num_paths=PLAIN_PATHS, noise=None, antithetic=False,
              external_uniforms=None)

    def run_fc(n=PLAIN_PATHS):
        return cuda_mc.first_contact_rows(0, cli_levels, params, device=dev,
                                          **dict(kw, num_paths=n))

    run_fc()
    fc_ms = cuda_ms(run_fc, 3)
    fc_rows = run_fc()
    plain_ms = cuda_ms(lambda: cuda_mc.fused_totals_reference(
        0, cli_levels, params, device=dev, **kw), 1)
    red_ms = cuda_ms(lambda: cuda_mc.reduce_rows(*fc_rows), 20)
    red_plain_ms = cuda_ms(lambda: cuda_mc.reduce_rows_reference(*fc_rows), 20)
    sc, _, work = cuda_mc.fused_totals_reference(
        0, cli_levels, params, device=dev, work=True,
        **dict(kw, num_paths=PHILOX_PATHS))
    fc_bound = card.bound(bytes_=fc_rows[0].numel() * 8 + fc_rows[1].numel() * 4,
                          **fc_ops(work.cpu(), int(sc[1]), PLAIN_PATHS / PHILOX_PATHS))
    red_bytes = (fc_rows[0].numel() * 8 + fc_rows[1].numel() * 4
                 + cuda_mc.ROW_COUNTS * 8 + cuda_mc.ROW_FLOATS * 8)
    red_bound = card.bound(bytes_=red_bytes, f32=0.0, sfu=0.0, imul=0.0)
    log(f"  at {PLAIN_PATHS} paths: kernel {fc_ms:.3f} ms "
        f"({PLAIN_PATHS / fc_ms * 1e3:.6e} paths/s), bound {fc_bound['bound_ms']:.3f} ms "
        f"{fc_bound['bound_parts']}, plain {plain_ms:.3f} ms "
        f"({PLAIN_PATHS / plain_ms * 1e3:.6e} paths/s)")
    log(f"  work per path (first {PHILOX_PATHS} paths): pairs, walked, after contact "
        f"{[round(float(x) / PHILOX_PATHS, 4) for x in work.cpu()]}")
    log(f"  row reduction ({fc_rows[0].shape[0]} rows): kernel {red_ms:.4f} ms, "
        f"plain {red_plain_ms:.4f} ms, bound {red_bound['bound_ms']:.4f} ms")

    # ---- phase 5: the first-contact main path through the CLI
    log(f"[5] main path: cli paths --backend cuda --num-paths {MAIN_PATHS}")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--db", os.path.join(tmp, "smoke.db"), "paths", "--backend",
                "cuda", "--num-paths", str(MAIN_PATHS), "--num-bars",
                str(NUM_BARS), "--sigma", str(SIGMA)]
        _, fc_secs, fc_launches = run_cli(
            cli, argv, lambda: (cuda_mc.reset_launches(), cuda_gated.reset_launches()),
            cuda_mc.LAUNCHES)
    fc_main_ms = cuda_ms(lambda: run_fc(MAIN_PATHS), 2)
    fc_main_bound = card.bound(
        bytes_=fc_rows[0].numel() * 8 + fc_rows[1].numel() * 4,
        **fc_ops(work.cpu(), int(sc[1]), MAIN_PATHS / PHILOX_PATHS))
    log(f"  kernel alone at {MAIN_PATHS} paths: {fc_main_ms:.3f} ms "
        f"({MAIN_PATHS / fc_main_ms * 1e3:.6e} paths/s), bound "
        f"{fc_main_bound['bound_ms']:.3f} ms {fc_main_bound['bound_parts']}")

    # ---- phase 6: gated, injected uniforms
    gcommon = dict(num_bars=NUM_BARS, s0=100.0, mu=0.0, sigma=SIGMA, dt=DT,
                   lanes=GATED_LANES)
    n_inj = GATED_INJECT_BLOCKS * 8 * GATED_LANES
    log(f"[6] gated, injected uniforms: kernel vs plain (plain on CPU copies), "
        f"{n_inj} paths")
    gated_err = 0.0
    for case, gate, nz, anti in (
            ("defaults", GateConfig.from_params(params), None, False),
            ("multi-trade", GateConfig.default(touch_limit=100, touch_gap_bars=1,
                                               use_confidence=False), None, False),
            ("tight", GateConfig.default(touch_limit=2, cooldown_bars=3), None, False),
            ("noise", GateConfig.from_params(params), noise, False),
            ("antithetic", GateConfig.from_params(params), None, True)):
        rng = np.random.default_rng(100 + len(case))
        u = torch.from_numpy(rng.uniform(
            1e-9, 1.0, (GATED_INJECT_BLOCKS, GatedLayout(NUM_BARS, nz is not None).u_rows,
                        8, GATED_LANES)).astype(np.float32))
        kw = dict(gcommon, num_paths=n_inj, noise=nz, antithetic=anti)
        want = cuda_gated.gated_totals_reference(0, levels, params, gate,
                                                 external_uniforms=u,
                                                 per_path=True, **kw)
        pc, pf, rows = cuda_gated.gated_rows(0, levels, params, gate, device=dev,
                                             external_uniforms=u.to(dev),
                                             per_path=True, **kw)
        got = (*cuda_gated.reduce_rows(pc, pf), rows)
        torch.cuda.synchronize()
        err, differ = compare_gated(case, want, got, n_inj)
        gated_err = max(gated_err, err)
        trace_flips(case, u, differ, rows.cpu(), want[2].cpu(), levels, params,
                    gate, nz, anti, dev)

    # ---- phase 7: gated, Philox stream, and the row fold
    log(f"[7] gated, Philox: kernel vs plain at {PHILOX_PATHS} paths (plain on "
        "the card), the main path's inputs")
    gated_red_err = 0.0
    gate = GateConfig.from_params(params)
    for case, nz in (("philox", None), ("philox+noise", noise)):
        kw = dict(gcommon, num_paths=PHILOX_PATHS, noise=nz, antithetic=False)
        want = cuda_gated.gated_totals_reference(
            0, cli_levels, params, gate, device=dev, chunk_blocks=64,
            per_path=True, work=True, **kw)
        pc, pf, rows = cuda_gated.gated_rows(0, cli_levels, params, gate,
                                             device=dev, external_uniforms=None,
                                             per_path=True, **kw)
        got = (*cuda_gated.reduce_rows(pc, pf), rows)
        torch.cuda.synchronize()
        gated_err = max(gated_err, compare_gated(case, want, got, PHILOX_PATHS)[0])
        gated_red_err = max(gated_red_err, check_fold(
            "mc_gated_reduce_rows", cuda_gated.reduce_rows_reference(pc, pf), got[:2]))
        if nz is None:
            g_trades, g_held = float(want[0][5]), float(want[3])
    log(f"  mc_gated_reduce_rows: counts exact, float max abs err {gated_red_err:.3e}")
    log(f"  work per path (first {PHILOX_PATHS} paths): trades "
        f"{g_trades / PHILOX_PATHS:.4f}, bars held {g_held / PHILOX_PATHS:.4f} of {NUM_BARS}")

    kw = dict(gcommon, num_paths=PLAIN_PATHS, noise=None, antithetic=False,
              external_uniforms=None)

    def run_gated(n=PLAIN_PATHS):
        return cuda_gated.gated_rows(0, cli_levels, params, gate, device=dev,
                                     **dict(kw, num_paths=n))

    run_gated()
    g_ms = cuda_ms(run_gated, 3)
    g_rows = run_gated()
    g_plain_ms = cuda_ms(lambda: cuda_gated.gated_totals_reference(
        0, cli_levels, params, gate, device=dev, chunk_blocks=256, **kw), 1)
    g_red_ms = cuda_ms(lambda: cuda_gated.reduce_rows(*g_rows), 20)
    g_red_plain_ms = cuda_ms(lambda: cuda_gated.reduce_rows_reference(*g_rows), 20)
    g_row_bytes = g_rows[0].numel() * 8 + g_rows[1].numel() * 4

    def g_bound(n):
        s = n / PHILOX_PATHS
        return card.bound(bytes_=g_row_bytes, **gated_ops(n, g_held * s, g_trades * s))

    g_bound_plain = g_bound(PLAIN_PATHS)
    g_red_bound = card.bound(bytes_=g_row_bytes + cuda_gated.ROW_COUNTS * 8
                             + cuda_gated.ROW_FLOATS * 8, f32=0.0, sfu=0.0, imul=0.0)
    log(f"  at {PLAIN_PATHS} paths: kernel {g_ms:.3f} ms "
        f"({PLAIN_PATHS / g_ms * 1e3:.6e} paths/s), bound {g_bound_plain['bound_ms']:.3f} ms "
        f"{g_bound_plain['bound_parts']}, plain {g_plain_ms:.3f} ms "
        f"({PLAIN_PATHS / g_plain_ms * 1e3:.6e} paths/s)")
    log(f"  row fold ({g_rows[0].shape[0]} rows): kernel {g_red_ms:.4f} ms, "
        f"plain {g_red_plain_ms:.4f} ms, bound {g_red_bound['bound_ms']:.4f} ms")

    # ---- phase 8: the gated main path through the CLI
    log(f"[8] main path: cli paths --gated --backend cuda --num-paths {MAIN_PATHS}")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--db", os.path.join(tmp, "smoke.db"), "paths", "--gated",
                "--backend", "cuda", "--num-paths", str(MAIN_PATHS),
                "--num-bars", str(NUM_BARS), "--sigma", str(SIGMA)]
        g_out, g_secs, g_launches = run_cli(
            cli, argv, lambda: (cuda_mc.reset_launches(), cuda_gated.reset_launches()),
            cuda_gated.LAUNCHES)
    if not g_out["trades"] >= g_out["entered"] > 0:
        raise AssertionError(f"trades < entered: {g_out}")
    if not g_out["mean_trades"] >= 1.0 or not g_out["max_dd"] >= 0.0:
        raise AssertionError(f"mean_trades < 1 or max_dd < 0: {g_out}")
    if cuda_mc.LAUNCHES["mc_first_contact"] != 0:
        raise AssertionError("the gated main path launched the first-contact kernel")
    g_main_ms = cuda_ms(lambda: run_gated(MAIN_PATHS), 3)
    g_main_bound = g_bound(MAIN_PATHS)
    log(f"  kernel alone at {MAIN_PATHS} paths: {g_main_ms:.3f} ms "
        f"({MAIN_PATHS / g_main_ms * 1e3:.6e} paths/s), bound "
        f"{g_main_bound['bound_ms']:.3f} ms {g_main_bound['bound_parts']}")

    def entry(name, source, replaces, launches, err, ms, plain, bound, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain, "bound_ms": bound["bound_ms"],
                "bound_by": bound["bound_by"], "library_ms": None,
                "bound_parts": bound["bound_parts"], **extra}

    print(json.dumps({"kernels": [
        entry("mc_first_contact", FC_SOURCE, FC_REPLACES,
              fc_launches["mc_first_contact"], fc_err, fc_ms, plain_ms, fc_bound,
              paths=PLAIN_PATHS, main_path_ms=fc_main_ms,
              main_path_bound_ms=fc_main_bound["bound_ms"],
              cli_s=fc_secs[1:]),
        entry("mc_reduce_rows", FC_SOURCE, FC_REPLACES,
              fc_launches["mc_reduce_rows"], reduce_err, red_ms, red_plain_ms,
              red_bound, rows=int(fc_rows[0].shape[0])),
        entry("mc_gated", GATED_SOURCE, GATED_REPLACES, g_launches["mc_gated"],
              gated_err, g_ms, g_plain_ms, g_bound_plain, paths=PLAIN_PATHS,
              main_path_ms=g_main_ms, main_path_bound_ms=g_main_bound["bound_ms"],
              cli_s=g_secs[1:]),
        entry("mc_gated_reduce_rows", GATED_SOURCE, GATED_REPLACES,
              g_launches["mc_gated_reduce_rows"], gated_red_err, g_red_ms,
              g_red_plain_ms, g_red_bound, rows=int(g_rows[0].shape[0])),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as exc:  # any failed phase: report it, print no result
        import traceback

        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(exc).__name__}: {exc}", file=sys.stderr)
        code = 1
    sys.exit(code)
