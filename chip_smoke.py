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
   output checked, paths/s timed; the kernel alone timed at 2^28;
   full 12-gate engine (kernel #8, ops/csrc/mc_engine.cu):
9. injected uniforms — kernel on the card vs plain version on CPU copies,
   path by path (W = 40, 16 blocks of 8 x 256 = 32768 paths, levels 100.0 /
   100.4 / 99.6; engine defaults, accumulation gates active, ML and policy
   gates armed, the same with a policy that lets entries through and with the
   blended gate, execution noise, antithetic); every differing path is traced
   bar by bar as in phase 6 (the card's bars run through the plain engine on
   the card, so its sigmoid is CUDA's too);
10. Philox — kernel vs plain version, both on the card, path by path at 2^22
   paths with and without noise; the row fold vs its plain fold; the work
   counts for the bound; kernel and plain timed at 2^22;
11. main path — the port CLI's ``paths --engine --backend cuda`` at 2^28
   paths x 40 bars, launch counts set to 0 just before and read just after
   (``mc_engine`` and its fold once a run, no other kernel), the output
   checked, paths/s timed; the kernel alone timed at 2^28;
   the common-random-number grid sweeps (kernels #3, #6, #9):
12. first-contact sweep (``mc_sweep_kernel``, mc_first_contact.cu): injected
   uniforms, the CLI's 3 x 3 (stop, tp) grid (BASELINE config #5's three
   rows among them), each row against the plain version on CPU copies;
   Philox at 2^22 on the same 9 rows, each row equal to the single
   configuration's launch bit for bit and within budget of the plain
   version on the card, the fold against its plain fold; config #5 at its
   full size (2^30 paths x 40 bars x 3 rows), kernel alone, timed; the
   port CLI's ``sweep --backend cuda`` at 2^28 paths (the 3 x 3 grid),
   launch counts set to 0 just before and read just after (one sweep launch
   and one fold a run, nothing else), rows and keys in the JAX CLI's order;
13. gated sweep (``mc_gated_sweep_kernel``, mc_gated.cu): injected uniforms
   path by path, 3 rows with a noise-std row, every differing path traced
   as in phase 6; Philox at 2^22, each row equal to the one-row launch of
   the same kernel (``mc_paths_gated_fused``'s) bit for bit, per path
   included, and the plain version on the card equal to the kernel on every
   path; ``PathStats.from_lifecycle`` / ``from_outcomes``
   bins on the card equal to the CPU's; the CLI's ``sweep --gated --backend
   cuda --num-paths 2^26 --touch-limits 2 4`` (18 rows) with its launches;
14. engine sweep (``mc_engine_sweep_kernel``, mc_engine.cu): injected uniforms
   path by path with the four configurations of the JAX engine sweep test,
   then with [G] noise stds (level jitter 0 and 0.02, the main path's rows,
   and a slip row), every differing path traced as in phase 9; Philox at
   2^22, each row of both grids equal to the one-row launch
   (``mc_paths_engine_fused``'s) bit for bit, skip counts included; kernel
   vs plain on the card path by path at 2^20 x both grids; the CLI's ``sweep
   --engine --backend cuda --num-paths 2^24 --jitter-stds 0 0.02`` (18 rows)
   with its launches; the kernel alone at 2^26 paths x 9 rows;
   the per-symbol universes (kernels #2, #5, #10, #11), three symbols with
   their own levels, s0, sigma and [S] knobs (and [S] noise stds for the
   lifecycles), and BASELINE config #4's universe (100 symbols, one blue
   level at s0 = 100 + i, sigma 0.25, 2^20 paths a symbol, 40 bars):
15. first-contact universe (``mc_universe_kernel``, mc_first_contact.cu):
   injected uniforms, each symbol against the plain version on CPU copies;
   Philox at 2^22 a symbol, each symbol equal to its one-symbol launch (the
   single configuration's) at its inputs and key bit for bit and within
   budget of the plain version
   on the card (both timed), the fold against its plain fold; the
   one-symbol universe equal to today's single run; on the main path's
   inputs (config #4's 100 symbols) at 2^16 paths a symbol, each symbol
   within budget of the plain version on the card; ``mc_paths_universe_fused``
   on config #4's universe, warm-up then timed, with its launches;
16. gated universe (``mc_gated_sweep_kernel``, a row per symbol): injected
   uniforms path by path with [S] noise stds, every differing path traced as
   in phase 6; Philox at 2^22 a symbol, each symbol equal to the single
   kernel bit for bit (per path included), the plain version on the card
   equal to the kernel on every path, at three symbols and on config #4's
   100 symbols at 2^16 paths a symbol; ``mc_paths_gated_universe_fused`` on
   config #4's universe with its launches;
17. engine universe (``mc_engine_sweep_kernel``, a row per symbol, the sweep
   of universes at one grid row): injected uniforms path by path with [S]
   knobs (proximity, paddings, q_min) and noise stds, every differing path
   traced as in phase 9; Philox, each symbol equal to the single kernel bit
   for bit at 2^22 and to the plain version on the card on every path at
   2^20, and config #4's 100 symbols equal to the plain version on the card
   on every path at 2^16 a symbol; BASELINE config #4 through
   ``mc_paths_engine_universe_fused``, one
   warm-up then timed, with its launches; then the per-symbol refresh
   (``universe_policy_refresh``) on run_all.py's [100, 64, 4] float32 shapes
   on the card, timed and held against the float64 fit on the CPU (1e-4);
18. sweep of universes (``mc_engine_sweep_kernel``, S x G rows): an [S, G]
   grid ([S, G] stop paddings, [G] q_min and noise stds) on injected
   uniforms path by path, every differing path traced; Philox, cell (s, g)
   equal to the engine universe under row g's knobs bit for bit, the plain
   version on the card equal to the kernel on every path, and so on the
   main path's inputs (config #4's first 8 symbols x the 4 configurations)
   at 2^16 paths a symbol; the entry ``mc_paths_engine_universe_sweep_fused``
   at those 8 symbols x 4 rows x 2^20 paths with its launches;
   the correlated books (kernels #7 and #12: one market factor, z_s =
   beta_s z_mkt + sqrt(1 - beta_s^2) eps_s, and the book's equity curve),
   three symbols with their own levels, s0, sigma, beta, weight, [S] knobs
   and noise stds, and the main path's book (100 symbols, spots 100 .. 199
   with the CLI's level scaffold, sigma 0.3, betas 0.2 .. 0.8, equal
   weights, 2^20 paths a symbol, 40 bars):
19. gated book (``mc_gated_corr_kernel``, mc_gated_corr.cu): injected uniforms
   (16 blocks of 8 x 1024 paths a symbol, antithetic) path by path, symbols
   and the book, every differing path traced as in phase 6 (a book path by
   its symbols' lifecycles over the CPU's and the card's bars, combined as
   the book combines them); Philox at
   2^20 a symbol, every symbol at beta 0 equal to the gated universe kernel
   (#5) bit for bit, per path included, and a one-symbol book of weight 1
   equal to its symbol; on the main path's inputs at 2^16 paths a symbol the
   plain version on the card equal to the kernel on every path, symbols and
   book; the kernel alone at the main-path size (the curves in shared
   memory), and the fold; the port CLI's ``book
   --backend cuda`` at the main-path size, launch counts set to 0 just
   before and read just after (one ``mc_gated_corr`` and one fold a run,
   nothing else), rows in the JAX CLI's form; the CLI's defaults once;
20. engine book (``mc_engine_corr_kernel``, mc_engine_corr.cu): the same, with
   the ML and policy gates armed, noise and antithetic in one injected case
   and the accumulation gates active in another, the identity against the
   engine universe kernel (#10), the curves in device memory, and ``book
   --engine --backend cuda``.

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
Engine (phases 9-10): the gated rules, a path's trades also differing when
its escalations differ; besides, a path whose trades agree differs when any
of its 16 per-path skip counts differ (a ulp can move a first-fail reason
from one gate to another and change no trade).  That is a threshold
crossing of its own, at any of the gates a bar reaches, so those paths have
a budget of their own: at most F paths whose trades differ and at most F
whose first-fail reasons alone differ.  Every differing path of an injected
comparison is traced (as in phase 6) before either budget is applied.  Each
skip counter's total within W times the number of differing paths (a path
moves at most one reason a bar, so 0 where no path differs) and
escalations within F.
Sweeps (phases 12-14): each row under its family's rules above; a row of a
sweep kernel and the single-configuration launch under that row's knobs:
equal, bit for bit.  Universes (phases 15-18): each symbol (or cell) under
its family's rules; a symbol of a universe kernel and the single kernel at
the symbol's inputs and key: equal, bit for bit.  Books (phases 19-20):
each symbol and the book under their family's rules (the book's row is a
lifecycle row of the book's R per path); a book symbol at beta 0 and the
universe kernel's symbol: equal, bit for bit.

Bounds (``bound_ms``): the larger of the bytes each kernel must move over
3.35 TB/s and its operations over the card's peak rate for their type: float32
operations over 67 TFLOP/s (the H100 SXM's dense float32 peak), and the
issue rates of the special-function unit (logf, expf, sqrtf and division
each take one MUFU operation, 16 per SM per clock) and of 32-bit integer
multiplies (Philox4x32-10: 40 per call, 64 per SM per clock), at the card's
``clocks.max.sm`` and SM count.  The work depends on the data (where paths
enter, how long they hold), so it is counted by the plain versions on the
first 2^22 paths of the timed inputs (the universes' main paths: 2^16 paths
of each symbol) and scaled to their size.  For the
engine the count is a floor: the work every bar does, plus the gates that the
plain version's skip table shows were reached (engine_ops).  A book's bound
is its symbols' lifecycles plus the market pair, counted once a path
(book_market_ops), though the kernels draw it again for every symbol.  A sweep's bound
counts each path's bars once and each row's decisions on them (sweep_ops,
gated_sweep_ops, engine_sweep_ops), so the gated and engine sweeps'
regeneration of the bars for every row shows against it.

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
ENGINE_SOURCE = CSRC + "mc_engine.cu"
GATED_CORR_SOURCE = CSRC + "mc_gated_corr.cu"
ENGINE_CORR_SOURCE = CSRC + "mc_engine_corr.cu"
FC_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:584"
GATED_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:1067"
ENGINE_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py:1415"
SWEEP_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:1978"
GATED_SWEEP_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:2163"
ENGINE_SWEEP_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py:1813"
# BASELINE config #5 (benchmarks/run_all.py:221-260): three (stop, tp) rows,
# 2^30 paths x 40 bars
CONFIG5 = [(0.25, 0.15), (0.35, 0.25), (0.45, 0.35)]
CONFIG5_PATHS = 1 << 30
SWEEP_INJECT_BLOCKS = 8
ENGINE_LANES = 256
ENGINE_INJECT_BLOCKS = 16
# the JAX engine kernel tests' levels (tests/test_pallas_engine.py:25-32)
ENGINE_ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
               {"color": "orange", "type": "dashed", "index": 0, "price": 100.4},
               {"color": "teal", "type": "solid", "index": 0, "price": 99.6}]
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


def engine_gate_divs(counts, scale: float) -> float:
    """The divisions of the gates a configuration reached (the confidence
    division past the contact latch, the slope's 3 past the veto, one a
    close), from the plain version's int64 totals ``counts`` on a sample,
    scaled by ``scale``."""
    c = [float(x) for x in counts]
    skips = c[7:23]
    reached7 = (c[0] * NUM_BARS - sum(skips[:5])) * scale
    reached10 = reached7 - sum(skips[5:11]) * scale
    return reached7 + 3 * reached10 + (c[2] + c[3]) * scale


def engine_ops(n_paths: float, counts, scale: float) -> dict:
    """A floor on the engine kernel's operations (no noise) for ``n_paths``
    paths of NUM_BARS bars, from the plain version's int64 totals ``counts``
    (n, entered, wins, losses, open, trades, escalations, 16 skips, ...) on a
    sample, scaled by ``scale``.  Every bar: the close, bridge high/low and
    volume (3 logf, 3 sqrtf, 4 expf, half of two sincosf pairs), 4 divisions
    (minute of day, volume coupling, two minute-close MAs) and the guard's
    MAs once defined; a bar that reaches the contact latch adds the
    confidence division, one that reaches the veto the slope's 3; a close,
    the R division.  ~100 float32 operations of logic a bar besides."""
    bars = n_paths * NUM_BARS
    guard_divs = n_paths * sum((t + 1 >= 5) + (t + 1 >= 20) for t in range(NUM_BARS))
    logf, sqrtf, expf = 3 * bars, 3 * bars, 4 * bars
    div = 4 * bars + guard_divs + engine_gate_divs(counts, scale)
    philox = n_paths * math.ceil(10 * NUM_BARS / 2 / 4)   # 10 rows a step, 4 a call
    f32 = logf + sqrtf + expf + 2 * bars + div + 100 * bars
    return dict(f32=f32, sfu=logf + sqrtf + expf + div, imul=PHILOX_IMULS * philox)


def sweep_ops(work, entered: int, rows: int, scale: float) -> dict:
    """Operations of the first-contact sweep for its work counts [Box-Muller
    pairs, bars walked (to the last row's hit), bars walked after contact,
    bars x rows checked after contact], scaled by ``scale``: each path's bars
    and contact once (``fc_ops``), plus every row's stop/target recomputed
    and checked (~8 float32 operations a row and bar) and its R division."""
    ops = fc_ops(work[:3], entered, scale)
    row_bars = float(work[3]) * scale
    extra_div = (rows - 1) * entered * scale
    ops["f32"] += 8 * row_bars + extra_div
    ops["sfu"] += extra_div
    return ops


def gated_sweep_ops(n_paths: float, held_rows, trades_rows) -> dict:
    """A floor on the gated sweep's operations with each path's bars made
    once: ``gated_ops`` for the bars (bridge extremes on the bars the row
    that holds longest holds), plus each further row's decisions (~30
    float32 operations a bar) and its confidence and R divisions."""
    ops = gated_ops(n_paths, max(held_rows), sum(trades_rows))
    ops["f32"] += (len(held_rows) - 1) * 30 * n_paths * NUM_BARS
    return ops


def engine_sweep_ops(n_paths: float, counts_rows, scale: float) -> dict:
    """A floor on the engine sweep's operations with each path's bars, its
    volumes and their MAs made once: ``engine_ops`` for the first row, plus
    for each further row the divisions of the gates it reached and ~100
    float32 operations of logic a bar."""
    ops = engine_ops(n_paths, counts_rows[0], scale)
    for c in counts_rows[1:]:
        div = engine_gate_divs(c, scale)
        ops["sfu"] += div
        ops["f32"] += div + 100 * n_paths * NUM_BARS
    return ops


def compare(name: str, want, got, n_paths: int, quiet: bool = False) -> float:
    """Hold first-contact kernel totals ``got`` against plain totals ``want``
    (both (int64 counts, float64 floats)); returns |delta mean R|.  ``quiet``
    logs only a failure."""
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
    if not quiet or bad:
        log(f"  {name}: entered {int(gc[1])}/{int(wc[1])} tp {int(gc[2])}/{int(wc[2])} "
            f"stop {int(gc[3])}/{int(wc[3])} open {int(gc[4])}/{int(wc[4])} "
            f"sum_r {float(gf[0]):.6f}/{float(wf[0]):.6f} hist L1 {l1} "
            f"|d mean_r| {d_mean:.3e}")
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with plain: {bad}")
    return d_mean


def compare_lifecycle(name: str, want, got, n_paths: int, engine: bool = False,
                      trace=None, quiet: bool = False):
    """Hold gated (or, with ``engine``, engine) kernel output ``got`` against
    the plain version's ``want`` (both (int64 counts, float64 floats, f32[P,
    6] per-path rows; the engine's counts carry escalations and 16 skip
    counters before the histogram, its rows an escalation column and the
    path's 16 skip counts)), path by path and on totals; returns the largest
    |d equity| or |d dd| on the paths that agree, and the bool[P] mask of the
    paths that differ.  ``trace(differ)``, when given, runs on the differing
    paths before any budget is applied (it raises unless each is a flipped
    decision); ``quiet`` logs only a failure."""
    import torch

    wc, wf, wr = (t.cpu() for t in want[:3])
    gc, gf, gr = (t.cpu() for t in got[:3])
    flips = 2 + n_paths // 1024
    hist = 23 if engine else 6
    bad = []
    if int(gc[0]) != int(wc[0]) or int(wc[0]) != n_paths:
        bad.append(f"n {int(gc[0])} vs {int(wc[0])}")
    if abs(int(gc[1]) - int(wc[1])) > flips:
        bad.append(f"entered {int(gc[1])} vs {int(wc[1])} (budget {flips})")
    l1 = int((gc[hist:] - wc[hist:]).abs().sum())
    if l1 > 2 * flips:
        bad.append(f"hist L1 {l1} > {2 * flips}")
    max_eq = float(wr[:, 0].abs().max())
    for j, fld in ((0, "sum_eq"), (2, "sum_dd")):
        if abs(float(gf[j]) - float(wf[j])) > flips * max(max_eq, 1.0):
            bad.append(f"{fld} {float(gf[j])} vs {float(wf[j])}")
    # a flipped decision may keep a path's counts and still move its trades,
    # so a path's trades differ when its counts (the engine's escalations
    # too) differ or its equity/dd moved more than the ulp drift allows
    # (1e-3 per trade); an engine path whose trades agree differs still when
    # a first-fail reason moved from one gate to another (its skip counts)
    cols = [1, 2, 3, 4] + ([6] if engine else [])
    err = (gr[:, [0, 5]] - wr[:, [0, 5]]).abs().amax(dim=1)
    trades_differ = ((gr[:, cols] != wr[:, cols]).any(dim=1)
                     | (err > 1e-3 * torch.clamp(wr[:, 1], min=1.0)))
    reason_only = torch.zeros_like(trades_differ)
    if engine:
        reason_only = (gr[:, 7:23] != wr[:, 7:23]).any(dim=1) & ~trades_differ
    differ = trades_differ | reason_only
    n_differ = int(differ.sum())
    if trace is not None:
        trace(differ)
    if int(trades_differ.sum()) > flips:
        bad.append(f"{int(trades_differ.sum())} paths' trades differ (budget {flips})")
    if int(reason_only.sum()) > flips:
        bad.append(f"{int(reason_only.sum())} paths differ in first-fail reasons only "
                   f"(budget {flips})")
    extra = ""
    if engine:
        if abs(int(gc[6]) - int(wc[6])) > flips:
            bad.append(f"escalations {int(gc[6])} vs {int(wc[6])} (budget {flips})")
        d_skips = (gc[7:23] - wc[7:23]).abs()
        if int(d_skips.max()) > NUM_BARS * n_differ:
            bad.append(f"skip counters differ by {d_skips.tolist()} "
                       f"(budget {NUM_BARS * n_differ})")
        if not torch.equal(gc[7:23], gr[:, 7:23].to(torch.int64).sum(dim=0)):
            bad.append("the kernel's skip totals differ from its per-path skip counts")
        extra = (f" escalations {int(gc[6])}/{int(wc[6])}; skip counters "
                 f"{gc[7:23].tolist()} (max |d| {int(d_skips.max())});")
    max_err = float(err[~differ].max()) if bool((~differ).any()) else 0.0
    if engine:
        extra += f" reasons only {int(reason_only.sum())};"
    if not quiet or bad:
        log(f"  {name}: entered {int(gc[1])}/{int(wc[1])} trades {int(gc[5])}/{int(wc[5])} "
            f"wins {int(gc[2])}/{int(wc[2])} losses {int(gc[3])}/{int(wc[3])} "
            f"open {int(gc[4])}/{int(wc[4])} sum_eq {float(gf[0]):.6f}/{float(wf[0]):.6f} "
            f"hist L1 {l1};{extra} paths differing {n_differ}, max |d eq|,|d dd| "
            f"elsewhere {max_err:.3e}")
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with plain: {bad}")
    return max_err, differ


def engine_trace(bars, tie, nzs, levels, params, kw, noise, device):
    """Drive the plain ``EngineLifecycle`` over ``bars`` on ``device``,
    recording after every bar (side, trades, wins, losses, escalations,
    first-fail reason) as int[P, W, 6], the equity as f32[P, W] and (entry,
    stop, target) as f32[P, W, 3]; returns (per-path rows, ints, equity,
    prices)."""
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.ops.cuda_engine import path_rows
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.enginepath import (
        EngineLifecycle, skip_columns)

    life = EngineLifecycle(bars.open[:, 0].to(device), levels, params, noise=noise, **kw)
    ints, skips, equity, prices = [], 0, [], []
    for t in range(bars.close.shape[1]):
        cols = (bars.high, bars.low, bars.close, bars.volume, tie)
        nz = tuple(n[:, t].to(device) for n in nzs) if nzs is not None else None
        reason = life.step(t, *(x[:, t].to(device) for x in cols), nz)
        skips = skips + skip_columns(reason)
        ints.append(torch.stack([life.side, life.trades, life.wins, life.losses,
                                 life.escal, reason], 1).cpu())
        equity.append(life.equity.cpu())
        prices.append(torch.stack([life.entry, life.stop, life.target], 1).cpu())
    return (path_rows(life.outcome(), skips).cpu(), torch.stack(ints, 1),
            torch.stack(equity, 1), torch.stack(prices, 1))


def trace_engine_flips(name, u, differ, kernel_rows, cpu_rows, levels, params, gates,
                       sigma, noise, antithetic, dev, s0: float = 100.0,
                       market=None) -> dict:
    """Phase 6's trace for the engine: the plain engine over the bars the
    plain version makes on the CPU (run on the CPU) and over those it makes
    on the card (run on the card).  For every differing path the card run
    equals the kernel's row exactly, the CPU run the plain row, and the two
    runs part at some bar (a decision or a first-fail reason went the other
    way).  A book symbol's ``market`` = (market uniforms, beta)."""
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.enginepath import engine_knobs

    idx = torch.nonzero(differ).flatten()
    if idx.numel() == 0:
        return {"paths": 0}
    layout = EngineLayout(NUM_BARS, noise is not None)
    kw = engine_knobs(**gates)
    runs = []
    for src, where in ((u, torch.device("cpu")), (u.to(dev), dev)):
        mkw = ({} if market is None
               else dict(market_uniforms=market[0].to(where), beta=market[1]))
        bars, tie, nzs = cuda_engine.engine_bars_from_uniforms(
            src, layout, s0=s0, mu=0.0, sigma=sigma, dt=DT, antithetic=antithetic, **mkw)
        pick = type(bars)(*(x[idx.to(x.device)] for x in bars))
        runs.append(engine_trace(pick, tie[idx.to(tie.device)],
                                 None if nzs is None else nzs[:, idx.to(nzs.device)],
                                 levels, params, kw, noise, where))
    (rows_cpu, i_cpu, _, px_cpu), (rows_dev, i_dev, _, px_dev) = runs
    trade_cols = [1, 2, 3, 4, 6]
    equal_trades = int((kernel_rows[idx][:, trade_cols] == cpu_rows[idx][:, trade_cols])
                       .all(dim=1).sum())
    if not torch.equal(rows_dev, kernel_rows[idx]):
        raise AssertionError(f"{name}: the kernel differs from the plain engine "
                             "on the card's own bars")
    if not torch.equal(rows_cpu, cpu_rows[idx]):
        raise AssertionError(f"{name}: the traced engine differs from the plain version")
    parted = (i_cpu != i_dev).any(dim=2)
    if not bool(parted.any(dim=1).all()):
        for k in torch.nonzero(~parted.any(dim=1)).flatten().tolist():
            d = (px_cpu[k] - px_dev[k]).abs()
            log(f"    untraced path {int(idx[k])}: kernel {kernel_rows[idx[k], :7].tolist()} "
                f"plain {cpu_rows[idx[k], :7].tolist()}; max |d entry, stop, target| "
                f"{d.amax(dim=0).tolist()} at bars {d.argmax(dim=0).tolist()}")
        raise AssertionError(f"{name}: a differing path shows no flipped decision")
    flip_bar = parted.int().argmax(dim=1)
    log(f"  {name}: {idx.numel()} differing paths ({equal_trades} with equal trade "
        f"counts), each traced to a flipped decision or first-fail reason at bars "
        f"{flip_bar.tolist()}; kernel == plain engine on the card's bars")
    return {"paths": idx.numel(), "equal_trade_counts": equal_trades}


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
                noise, antithetic, dev, s0: float = 100.0, sigma: float = SIGMA,
                market=None) -> dict:
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
    close/high/low on both sides in ulps.  A book symbol's ``market`` =
    (market uniforms, beta)."""
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_gated
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import GatedLayout

    idx = torch.nonzero(differ).flatten()
    if idx.numel() == 0:
        return {"paths": 0}
    layout = GatedLayout(NUM_BARS, noise is not None)
    kw = dict(s0=s0, mu=0.0, sigma=sigma, dt=DT, antithetic=antithetic)
    runs = []
    for src in (u, u.to(dev)):
        mkw = ({} if market is None
               else dict(market_uniforms=market[0].to(src.device), beta=market[1]))
        bars, tie, nzs = cuda_gated.gated_bars_from_uniforms(src, layout, **kw, **mkw)
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


def launch_counts() -> dict:
    """Every kernel's launch count, across the port's three kernel modules."""
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated, cuda_mc

    return {k: v for m in (cuda_mc, cuda_gated, cuda_engine) for k, v in m.LAUNCHES.items()}


def run_cli(cli, argv, reset, expect: dict, n_paths: int = None, work: int = None,
            unit: str = None) -> tuple[list, list, dict]:
    """The CLI four times (one warm-up, three timed), the launch counts set to
    0 just before and read just after; the kernels named in ``expect`` must
    have been launched exactly that often and no other kernel at all.
    ``work`` counts what a run simulates (default: paths x output rows).
    Returns (the last run's JSON lines, seconds, the counts of ``expect``)."""
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
    counts = launch_counts()
    lines = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    log(f"  cli output: {json.dumps(lines[-1])}" + (f" (last of {len(lines)} rows)"
                                                    if len(lines) > 1 else ""))
    log(f"  launches in the main-path runs: { {k: v for k, v in counts.items() if v} }")
    if {k: v for k, v in counts.items() if v} != expect:
        raise AssertionError(f"the main path launched {counts}, not exactly {expect}")
    for out in lines:
        floats = {k: v for k, v in out.items() if isinstance(v, float)}
        if not all(math.isfinite(v) for v in floats.values()):
            raise AssertionError(f"non-finite cli output: {out}")
        if "hit_rate" in out and not 0.0 < out["hit_rate"] < 1.0:
            raise AssertionError(f"hit_rate out of (0, 1): {out}")
    rep_s = sum(secs[1:]) / 3
    work = work or (n_paths or MAIN_PATHS) * len(lines)
    unit = unit or ("paths x rows" if len(lines) > 1 else "paths")
    log(f"  cli wall per run: warm-up {secs[0]:.3f} s, reps "
        f"{', '.join(f'{s:.3f}' for s in secs[1:])} s -> "
        f"{work / rep_s:.6e} {unit}/s end to end")
    return lines, secs, {k: counts[k] for k in expect}


def check_sweep_output(lines: list, combos: list, keys: list) -> None:
    """A ``sweep`` run's rows: the JAX CLI's keys in its order, one row per
    grid point in the JAX CLI's row order."""
    if len(lines) != len(combos):
        raise AssertionError(f"{len(lines)} sweep rows, not {len(combos)}")
    for out, combo in zip(lines, combos):
        if list(out) != keys:
            raise AssertionError(f"sweep row keys {list(out)}, not {keys}")
        grid = [out[k] for k in keys if k in ("stop_padding", "tp_padding", "touch_limit",
                                               "q_min_prob", "level_jitter_std")]
        if grid != list(combo):
            raise AssertionError(f"sweep row {grid} out of the grid's order ({combo})")


def stack_params(cfgs):
    """EngineParams whose leaves stack the configurations ``cfgs`` ([G])."""
    import dataclasses

    import torch

    return type(cfgs[0])(**{f.name: torch.stack([getattr(c, f.name) for c in cfgs])
                            for f in dataclasses.fields(cfgs[0])})


def check_paths_output(out: dict) -> None:
    """The ``paths`` main paths' output: every path counted, some entered."""
    if out["paths"] != float(MAIN_PATHS) or not out["entered"] > 0:
        raise AssertionError(f"unexpected path counts: {out}")


# ---- the universes (kernels #2, #5, #10, #11) and BASELINE config #4
UNI_SYMBOLS = 100          # BASELINE config #4 (benchmarks/run_all.py:147-220)
UNI_PATHS = 1 << 20        # paths a symbol
UNI_SIGMA = 0.25
UNI_SAMPLE_PATHS = 1 << 16    # a symbol: config #4's inputs, kernel vs plain on the card
UNI_ENGINE_PATHS = 1 << 20     # a symbol, for the engine universe's plain on the card
UNI_SWEEP_PATHS = 1 << 18      # a symbol, for the sweep of universes' plain on the card
UNI_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:828"
GATED_UNI_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:1568"
ENGINE_UNI_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py:2098"
ENGINE_UNI_SWEEP_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py:2282"
# three symbols with their own levels, spot, volatility and knobs
UNI3_ROWS = [[ENGINE_ROWS[0], ENGINE_ROWS[2]],
             [{"color": "red", "type": "dashed", "index": 0, "price": 100.3}],
             [{"color": "green", "type": "solid", "index": 0, "price": 99.7}, ENGINE_ROWS[1]]]
UNI3_S0 = (100.0, 100.1, 99.9)
UNI3_SIGMA = (0.3, 0.2, 0.35)
# the engine universe sweep's main path: config #4's first 8 symbols x the 4
# configurations of tests/test_pallas_engine.py:320-325
UNI_SWEEP_SYMBOLS = 8


def entry(name, source, replaces, launches, err, ms, plain, bound, **extra) -> dict:
    """One kernel of the ``kernels`` line."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": None,
            "bound_parts": bound["bound_parts"], **extra}


def run_entry(name: str, fn, reset, expect: dict, runs: int = 2):
    """A user's entry point ``fn`` ``runs`` times (one warm-up, then timed),
    the launch counts set to 0 just before and read just after: exactly the
    kernels of ``expect`` ran, that often.  Returns (the last output, the
    seconds of each run, the counts of ``expect``)."""
    import torch

    reset()
    secs, out = [], None
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = {k: v for k, v in launch_counts().items() if v}
    log(f"  launches in the main-path runs: {counts}; wall per run "
        f"{', '.join(f'{x:.3f}' for x in secs)} s")
    if counts != expect:
        raise AssertionError(f"{name} launched {counts}, not exactly {expect}")
    return out, secs, {k: counts[k] for k in expect}


def timed(fn):
    """(fn(), milliseconds) on the host clock around fn and a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def config4(n_sym: int | None = None):
    """BASELINE config #4's universe (benchmarks/run_all.py:153-162): symbol
    i has one blue level at 100 + i, s0 100 + i and sigma 0.25, at most 4
    level slots; its first ``n_sym`` symbols."""
    import numpy as np

    from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U

    n_sym = UNI_SYMBOLS if n_sym is None else n_sym
    rows = [[{"color": "blue", "type": "solid", "index": 0, "price": 100.0 + i}]
            for i in range(n_sym)]
    return (U.stack_levels(rows, max_levels=4),
            np.array([100.0 + i for i in range(n_sym)], np.float32),
            np.full(n_sym, UNI_SIGMA, np.float32))


def check_universe_stats(name: str, stats, n_sym: int, pps: int) -> None:
    """A universe run's [S] PathStats: every symbol counted in full, every
    symbol entered, finite sums, lifecycle accounting."""
    import torch

    if tuple(stats.n.shape) != (n_sym,) or not bool((stats.n == pps).all()):
        raise AssertionError(f"{name}: path counts {stats.n.tolist()}, not {n_sym} x {pps}")
    if not bool((stats.n_entered > 0).all()):
        raise AssertionError(f"{name}: a symbol never entered")
    for f in ("sum_r", "sum_r2", "sum_dd", "max_dd", "sum_trades"):
        if not bool(torch.isfinite(getattr(stats, f)).all()):
            raise AssertionError(f"{name}: non-finite {f}")
    if not bool((stats.sum_trades >= stats.n_entered).all()):
        raise AssertionError(f"{name}: fewer trades than entered paths")


def same_on_card(name, want, got, n_cells, n_paths, cell, engine=True):
    """Each cell's kernel output ``got`` (counts, floats, per-path rows)
    equals the plain version's ``want`` on every path (a gated lifecycle
    unless ``engine``); returns the largest float error."""
    err = 0.0
    for i in range(n_cells):
        e, differ = compare_lifecycle(f"{name} {cell(i)}", *(
            tuple(x[i] for x in t) for t in (want, got)), n_paths, engine=engine,
            quiet=True)
        if bool(differ.any()):
            raise AssertionError(f"{name} {cell(i)}: kernel and plain on the card differ "
                                 f"on {int(differ.sum())} paths")
        err = max(err, e)
    d = (got[0].cpu() - want[0].cpu()).abs().amax()
    log(f"    every one of {n_cells} cells equals the plain version on every path "
        f"(counts |d| {int(d)}, sum_eq |d| max "
        f"{float((got[1][..., 0].cpu() - want[1][..., 0].cpu()).abs().max()):.3e})")
    return err


def universe_phases(dev, card, reset) -> list:
    """Phases 15-18: the four universe kernels against their plain versions
    and their single kernels, BASELINE config #4 and its refresh; returns
    their entries of the ``kernels`` line."""
    import numpy as np
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated, cuda_mc
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import (EngineLayout, GatedLayout,
                                                                 GbmLayout)
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row, grid_size
    from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import GateConfig
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise

    params = EngineParams.default()
    lv3 = U.stack_levels(UNI3_ROWS, max_levels=8)
    s0_3, sg_3 = np.array(UNI3_S0, np.float32), np.array(UNI3_SIGMA, np.float32)
    # per-symbol knobs ([S] leaves) and noise stds: proximity and paddings
    # (tests/test_pallas_mc.py:260-305) for #2 and #5; those and q_min
    # (tests/test_pallas_engine.py:352-405) for #10
    p3 = params.replace(contact_prox=[0.05, 0.08, 0.03], stop_padding=[0.35, 0.20, 0.45],
                        tp_padding=[0.25, 0.40, 0.15])
    p3e = p3.replace(q_min_prob=[0.60, 0.40, 0.55])
    noise3 = McNoise(level_jitter_std=torch.tensor([0.0, 0.02, 0.01]),
                     entry_slip_std=torch.tensor([0.01, 0.0, 0.0]),
                     stop_slip_std=torch.tensor([0.0, 0.015, 0.0]),
                     target_slip_std=torch.tensor([0.015, 0.0, 0.0]))
    c4 = config4()
    main_scale = UNI_PATHS / UNI_SAMPLE_PATHS

    def sym(s):
        return dict(s0=float(s0_3[s]), sigma=float(sg_3[s]), symbol=s)

    def row_bytes(mod, n_rows, pps):
        """Bytes of the partial rows ``n_rows`` rows of ``pps`` paths write."""
        return n_rows * grid_size(pps) * (mod.ROW_COUNTS * 8 + mod.ROW_FLOATS * 4)

    def fold_cols(rows, mod):
        return rows[0].numel() * 8 + rows[1].numel() * 4 + rows[0].shape[0] * (
            mod.ROW_COUNTS * 8 + mod.ROW_FLOATS * 8)

    def fold(mod, rows):
        """Partial rows [S, R, C] (and per-path rows) -> ([S, C] totals, per-path rows)."""
        return (*mod.reduce_rows(rows[0], rows[1]), rows[2])

    def main_inputs(what, cells):
        log(f"  {what} on the main path's inputs ({cells}) at {UNI_SAMPLE_PATHS} paths a "
            "symbol, Philox: kernel vs plain on the card")

    out = []

    # ---- phase 15: first-contact universe (kernel #2)
    lanes = cuda_mc.UNIVERSE_LANES
    nb = 4
    log(f"[15] first-contact universe (mc_universe_kernel), injected uniforms: 3 symbols x "
        f"{nb * lanes} paths (own levels, s0, sigma, prox, paddings), kernel vs plain on "
        "CPU copies")
    u = torch.from_numpy(np.random.default_rng(600).uniform(
        1e-9, 1.0, (3, nb, GbmLayout(NUM_BARS).n_rows, lanes)).astype(np.float32))
    kw = dict(paths_per_symbol=nb * lanes, num_bars=NUM_BARS, dt=DT, lanes=lanes)
    want = cuda_mc.universe_totals_reference(0, lv3, p3, s0_3, sg_3, external_uniforms=u, **kw)
    got = cuda_mc.reduce_rows(*cuda_mc.universe_rows(0, lv3, p3, s0_3, sg_3, device=dev,
                                                     external_uniforms=u.to(dev), **kw))
    torch.cuda.synchronize()
    uni_err = 0.0
    for s in range(3):
        uni_err = max(uni_err, compare(f"symbol {s}", (want[0][s], want[1][s]),
                                       (got[0][s], got[1][s]), nb * lanes))
    log(f"  Philox at {PHILOX_PATHS} paths a symbol: each symbol vs the one-symbol launch "
        "(first_contact_rows) at its inputs and key bit for bit; kernel vs plain on the card")
    kw = dict(paths_per_symbol=PHILOX_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
              external_uniforms=None)
    run = lambda: cuda_mc.universe_rows(7, lv3, p3, s0_3, sg_3, device=dev, **kw)
    rows = run()
    got = cuda_mc.reduce_rows(*rows)
    for s in range(3):
        one = cuda_mc.first_contact_rows(
            7, grid_row(lv3, s), grid_row(p3, s), num_paths=PHILOX_PATHS, num_bars=NUM_BARS,
            mu=0.0, dt=DT, lanes=lanes, noise=None, antithetic=False, external_uniforms=None,
            device=dev, **sym(s))
        tot = cuda_mc.reduce_rows(*one)
        if not (torch.equal(one[0], rows[0][s]) and torch.equal(one[1], rows[1][s])
                and torch.equal(tot[0], got[0][s]) and torch.equal(tot[1], got[1][s])):
            raise AssertionError(f"universe symbol {s} differs from its one-symbol launch")
    (wc, wf, work), uni_plain_ms = timed(lambda: cuda_mc.universe_totals_reference(
        7, lv3, p3, s0_3, sg_3, device=dev, chunk_blocks=64, work=True, **kw))
    for s in range(3):
        uni_err = max(uni_err, compare(f"philox symbol {s}", (wc[s], wf[s]),
                                       (got[0][s], got[1][s]), PHILOX_PATHS))
    uni_red_err = check_fold("mc_universe_reduce_rows", cuda_mc.reduce_rows_reference(*rows),
                             got)
    uni_ms = cuda_ms(run, 3)
    uni_bound = card.bound(bytes_=rows[0].numel() * 8 + rows[1].numel() * 4,
                           **fc_ops(work.sum(0).cpu(), int(wc[:, 1].sum()), 1.0))
    red_ms = cuda_ms(lambda: cuda_mc.reduce_rows(*rows, what="mc_universe_reduce_rows"), 20)
    red_plain_ms = cuda_ms(lambda: cuda_mc.reduce_rows_reference(*rows), 20)
    red_bound = card.bound(bytes_=fold_cols(rows, cuda_mc), f32=0.0, sfu=0.0, imul=0.0)
    log(f"  every symbol equals its one-symbol launch bit for bit; at 3 x {PHILOX_PATHS} "
        f"paths: kernel {uni_ms:.3f} ms, bound {uni_bound['bound_ms']:.3f} ms "
        f"{uni_bound['bound_parts']}, plain {uni_plain_ms:.3f} ms; fold {red_ms:.4f} ms")
    lv1, s0_1, sg_1 = config4(1)
    a = cuda_mc.mc_paths_universe_fused(3, lv1, params, s0_1, sg_1,
                                        paths_per_symbol=PHILOX_PATHS, device=dev)
    b = cuda_mc.mc_paths_fused(3, grid_row(lv1, 0), params, num_paths=PHILOX_PATHS,
                               s0=100.0, sigma=UNI_SIGMA, lanes=lanes, device=dev)
    if not (torch.equal(a.sum_r[0], b.sum_r) and torch.equal(a.hist[0], b.hist)):
        raise AssertionError("the one-symbol universe differs from the single run")
    log("  the one-symbol universe equals today's single run (mc_paths_fused) bit for bit")
    main_inputs("mc_universe_kernel", f"config #4's {UNI_SYMBOLS} symbols")
    c4kw = dict(paths_per_symbol=UNI_SAMPLE_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
                external_uniforms=None, device=dev)
    sc, sf, swork = cuda_mc.universe_totals_reference(0, c4[0], params, *c4[1:], work=True,
                                                      **c4kw)
    kc, kf = cuda_mc.reduce_rows(*cuda_mc.universe_rows(0, c4[0], params, *c4[1:], **c4kw))
    c4_err = max(compare(f"config #4 symbol {s}", (sc[s], sf[s]), (kc[s], kf[s]),
                         UNI_SAMPLE_PATHS, quiet=True) for s in range(UNI_SYMBOLS))
    uni_err = max(uni_err, c4_err)
    log(f"    every symbol within budget (2 + {UNI_SAMPLE_PATHS // 1024}): entered/tp/stop/open "
        f"|d| max {int((kc[:, 1:5].cpu() - sc[:, 1:5].cpu()).abs().max())}, hist L1 max "
        f"{int((kc[:, 5:].cpu() - sc[:, 5:].cpu()).abs().sum(1).max())}, |d mean_r| max "
        f"{c4_err:.3e}")
    log(f"[15] main path: mc_paths_universe_fused, config #4's universe ({UNI_SYMBOLS} symbols "
        f"x {UNI_PATHS} paths x {NUM_BARS} bars)")
    st, secs, launches = run_entry(
        "mc_paths_universe_fused", lambda: cuda_mc.mc_paths_universe_fused(
            0, c4[0], params, *c4[1:], paths_per_symbol=UNI_PATHS, num_bars=NUM_BARS, dt=DT),
        reset, {"mc_universe": 2, "mc_universe_reduce_rows": 2})
    check_universe_stats("first-contact universe", st, UNI_SYMBOLS, UNI_PATHS)
    if not bool((st.n_tp + st.n_stop + st.n_open == st.n_entered).all()):
        raise AssertionError("first-contact universe: tp + stop + open != entered")
    main_ms = cuda_ms(lambda: cuda_mc.universe_rows(
        0, c4[0], params, *c4[1:], paths_per_symbol=UNI_PATHS, num_bars=NUM_BARS, dt=DT,
        lanes=lanes, external_uniforms=None, device=dev), 2)
    main_bound = card.bound(bytes_=row_bytes(cuda_mc, UNI_SYMBOLS, UNI_PATHS),
                            **fc_ops(swork.sum(0).cpu(), int(sc[:, 1].sum()), main_scale))
    log(f"  kernel alone at {UNI_SYMBOLS} x {UNI_PATHS} paths: {main_ms:.3f} ms "
        f"({UNI_SYMBOLS * UNI_PATHS / main_ms * 1e3:.6e} paths/s), bound "
        f"{main_bound['bound_ms']:.3f} ms {main_bound['bound_parts']}")
    out += [entry("mc_universe", FC_SOURCE, UNI_REPLACES, launches["mc_universe"], uni_err,
                  uni_ms, uni_plain_ms, uni_bound, symbols=3, paths=PHILOX_PATHS,
                  main_path_ms=main_ms, main_path_bound_ms=main_bound["bound_ms"],
                  main_s=secs[1:]),
            entry("mc_universe_reduce_rows", FC_SOURCE, UNI_REPLACES,
                  launches["mc_universe_reduce_rows"], uni_red_err, red_ms, red_plain_ms,
                  red_bound, rows=int(rows[0].shape[1]), symbols=3)]

    # ---- phase 16: gated universe (kernel #5)
    lanes = GATED_LANES
    gate = GateConfig.from_params(params)
    n_inj = nb * 8 * lanes
    log(f"[16] gated universe (mc_gated_sweep_kernel, a row per symbol), injected uniforms: "
        f"3 symbols x {n_inj} paths, [S] knobs and noise stds, kernel vs plain on CPU "
        "copies path by path, every differing path traced")
    u = torch.from_numpy(np.random.default_rng(601).uniform(
        1e-9, 1.0, (3, nb, GatedLayout(NUM_BARS, True).u_rows, 8, lanes)).astype(np.float32))
    kw = dict(paths_per_symbol=n_inj, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=noise3)
    want = cuda_gated.gated_universe_totals_reference(0, lv3, p3, s0_3, sg_3, gate,
                                                      external_uniforms=u, per_path=True, **kw)
    pc, pf, prow = cuda_gated.gated_universe_rows(0, lv3, p3, s0_3, sg_3, gate, device=dev,
                                                  external_uniforms=u.to(dev), per_path=True,
                                                  **kw)
    gc, gf = cuda_gated.reduce_rows(pc, pf)
    torch.cuda.synchronize()
    g_err = 0.0
    for s in range(3):
        err, _ = compare_lifecycle(
            f"symbol {s}", (want[0][s], want[1][s], want[2][s]), (gc[s], gf[s], prow[s]), n_inj,
            trace=lambda d: trace_flips(f"symbol {s}", u[s], d, prow[s].cpu(), want[2][s].cpu(),
                                        grid_row(lv3, s), grid_row(p3, s), gate,
                                        grid_row(noise3, s), False, dev, s0=float(s0_3[s]),
                                        sigma=float(sg_3[s])))
        g_err = max(g_err, err)
    log(f"  Philox at {PHILOX_PATHS} paths a symbol: each symbol vs the single kernel "
        "(gated_rows) at its inputs and key bit for bit, per path included; kernel vs plain "
        "on the card path by path")
    kw = dict(paths_per_symbol=PHILOX_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
              noise=noise3, external_uniforms=None)
    rows = cuda_gated.gated_universe_rows(7, lv3, p3, s0_3, sg_3, gate, device=dev,
                                          per_path=True, **kw)
    gc, gf = cuda_gated.reduce_rows(*rows[:2])
    for s in range(3):
        one = cuda_gated.gated_rows(7, grid_row(lv3, s), grid_row(p3, s), gate,
                                    num_paths=PHILOX_PATHS, num_bars=NUM_BARS, mu=0.0, dt=DT,
                                    lanes=lanes, noise=grid_row(noise3, s), antithetic=False,
                                    external_uniforms=None, device=dev, per_path=True, **sym(s))
        if not all(torch.equal(a, b[s]) for a, b in zip(one, rows)):
            raise AssertionError(f"gated universe symbol {s} differs from the single kernel")
    (wc, wf, wrow, held), g_plain_ms = timed(lambda: cuda_gated.gated_universe_totals_reference(
        7, lv3, p3, s0_3, sg_3, gate, device=dev, chunk_blocks=64, per_path=True, work=True,
        **kw))
    for s in range(3):
        err, differ = compare_lifecycle(f"philox symbol {s}", (wc[s], wf[s], wrow[s]),
                                        (gc[s], gf[s], rows[2][s]), PHILOX_PATHS)
        g_err = max(g_err, err)
        if bool(differ.any()):
            raise AssertionError(f"gated universe symbol {s}: kernel and plain on the card "
                                 "differ")
    g_red_err = check_fold("mc_gated_universe_reduce_rows",
                           cuda_gated.reduce_rows_reference(*rows[:2]), (gc, gf))
    rows = rows[:2]
    run = lambda: cuda_gated.gated_universe_rows(7, lv3, p3, s0_3, sg_3, gate, device=dev, **kw)
    g_ms = cuda_ms(run, 3)
    # the noise terms add 2 Philox calls a double bar and a Box-Muller pair an entry
    g_ops = gated_ops(3 * PHILOX_PATHS, float(held.sum()), float(wc[:, 5].sum()))
    g_ops["imul"] *= 2
    g_bound = card.bound(bytes_=rows[0].numel() * 8 + rows[1].numel() * 4, **g_ops)
    g_red_ms = cuda_ms(lambda: cuda_gated.reduce_rows(*rows, what="mc_gated_universe_reduce_rows"),
                       20)
    g_red_plain_ms = cuda_ms(lambda: cuda_gated.reduce_rows_reference(*rows), 20)
    g_red_bound = card.bound(bytes_=fold_cols(rows, cuda_gated), f32=0.0, sfu=0.0, imul=0.0)
    log(f"  every symbol equals the single kernel bit for bit; the plain version on the card "
        f"equals the kernel on every path; at 3 x {PHILOX_PATHS} paths with noise: kernel "
        f"{g_ms:.3f} ms, bound {g_bound['bound_ms']:.3f} ms {g_bound['bound_parts']}, plain "
        f"{g_plain_ms:.3f} ms; fold {g_red_ms:.4f} ms")
    main_inputs("the gated universe", f"config #4's {UNI_SYMBOLS} symbols, path by path")
    c4kw = dict(paths_per_symbol=UNI_SAMPLE_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
                noise=None, external_uniforms=None, device=dev, per_path=True)
    sc, sf, srow, held = cuda_gated.gated_universe_totals_reference(
        0, c4[0], params, *c4[1:], chunk_blocks=64, work=True, **c4kw)
    g_err = max(g_err, same_on_card(
        "gated", (sc, sf, srow), fold(cuda_gated, cuda_gated.gated_universe_rows(
            0, c4[0], params, *c4[1:], **c4kw)), UNI_SYMBOLS, UNI_SAMPLE_PATHS,
        lambda s: f"symbol {s}", engine=False))
    del srow
    log(f"[16] main path: mc_paths_gated_universe_fused, config #4's universe "
        f"({UNI_SYMBOLS} x {UNI_PATHS} paths)")
    st, secs, launches = run_entry(
        "mc_paths_gated_universe_fused", lambda: cuda_gated.mc_paths_gated_universe_fused(
            0, c4[0], params, *c4[1:], paths_per_symbol=UNI_PATHS, num_bars=NUM_BARS, dt=DT),
        reset, {"mc_gated_universe": 2, "mc_gated_universe_reduce_rows": 2})
    check_universe_stats("gated universe", st, UNI_SYMBOLS, UNI_PATHS)
    g_main = dict(paths_per_symbol=UNI_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=None,
                  external_uniforms=None, device=dev)
    g_main_ms = cuda_ms(lambda: cuda_gated.gated_universe_rows(0, c4[0], params, *c4[1:],
                                                               **g_main), 2)
    g_main_bound = card.bound(
        bytes_=row_bytes(cuda_gated, UNI_SYMBOLS, UNI_PATHS),
        **gated_ops(UNI_SYMBOLS * UNI_PATHS, float(held.sum()) * main_scale,
                    float(sc[:, 5].sum()) * main_scale))
    log(f"  kernel alone at {UNI_SYMBOLS} x {UNI_PATHS} paths: {g_main_ms:.3f} ms "
        f"({UNI_SYMBOLS * UNI_PATHS / g_main_ms * 1e3:.6e} paths/s), bound "
        f"{g_main_bound['bound_ms']:.3f} ms {g_main_bound['bound_parts']}")
    out += [entry("mc_gated_universe", GATED_SOURCE, GATED_UNI_REPLACES,
                  launches["mc_gated_universe"], g_err, g_ms, g_plain_ms, g_bound, symbols=3,
                  paths=PHILOX_PATHS, noise=True, main_path_ms=g_main_ms,
                  main_path_bound_ms=g_main_bound["bound_ms"], main_s=secs[1:]),
            entry("mc_gated_universe_reduce_rows", GATED_SOURCE, GATED_UNI_REPLACES,
                  launches["mc_gated_universe_reduce_rows"], g_red_err, g_red_ms,
                  g_red_plain_ms, g_red_bound, rows=int(rows[0].shape[1]), symbols=3)]

    # ---- phase 17: engine universe (kernel #10), BASELINE config #4 and its refresh
    lanes = ENGINE_LANES
    n_inj = nb * 8 * lanes
    log(f"[17] engine universe (mc_engine_sweep_kernel, a row per symbol), injected "
        f"uniforms: 3 symbols x {n_inj} paths, [S] knobs and noise stds, kernel vs plain on "
        "CPU copies path by path, every differing path traced")
    u = torch.from_numpy(np.random.default_rng(602).uniform(
        1e-6, 1.0, (3, nb, EngineLayout(NUM_BARS, True).u_rows, 8, lanes)).astype(np.float32))
    kw = dict(paths_per_symbol=n_inj, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=noise3)
    want = cuda_engine.engine_universe_totals_reference(0, lv3, p3e, s0_3, sg_3,
                                                        external_uniforms=u, per_path=True, **kw)
    pc, pf, prow = cuda_engine.engine_universe_rows(0, lv3, p3e, s0_3, sg_3, device=dev,
                                                    external_uniforms=u.to(dev), per_path=True,
                                                    **kw)
    ec, ef = cuda_engine.reduce_rows(pc, pf)
    torch.cuda.synchronize()
    e_err = 0.0
    for s in range(3):
        err, _ = compare_lifecycle(
            f"symbol {s}", (want[0][s], want[1][s], want[2][s]), (ec[s], ef[s], prow[s]), n_inj,
            engine=True,
            trace=lambda d: trace_engine_flips(f"symbol {s}", u[s], d, prow[s].cpu(),
                                               want[2][s].cpu(), grid_row(lv3, s),
                                               grid_row(p3e, s), {}, float(sg_3[s]),
                                               grid_row(noise3, s), False, dev,
                                               s0=float(s0_3[s])))
        e_err = max(e_err, err)
    e_paths = UNI_ENGINE_PATHS
    log(f"  Philox at {PHILOX_PATHS} paths a symbol: each symbol vs the single kernel "
        f"(engine_rows) bit for bit, per path and skip counts included; at {e_paths} paths a "
        "symbol kernel vs plain on the card path by path")
    kw = dict(num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=noise3, external_uniforms=None)
    rows = cuda_engine.engine_universe_rows(7, lv3, p3e, s0_3, sg_3, device=dev, per_path=True,
                                            paths_per_symbol=PHILOX_PATHS, **kw)
    for s in range(3):
        one = cuda_engine.engine_rows(7, grid_row(lv3, s), grid_row(p3e, s),
                                      num_paths=PHILOX_PATHS, mu=0.0, device=dev,
                                      per_path=True, **dict(kw, noise=grid_row(noise3, s)),
                                      **sym(s))
        if not all(torch.equal(a, b[s]) for a, b in zip(one, rows)):
            raise AssertionError(f"engine universe symbol {s} differs from the single kernel")
    del rows, one
    kw = dict(kw, paths_per_symbol=e_paths)
    rows = cuda_engine.engine_universe_rows(7, lv3, p3e, s0_3, sg_3, device=dev, per_path=True,
                                            **kw)
    ec, ef = cuda_engine.reduce_rows(*rows[:2])
    (wc, wf, wrow), e_plain_ms = timed(lambda: cuda_engine.engine_universe_totals_reference(
        7, lv3, p3e, s0_3, sg_3, device=dev, chunk_blocks=512, per_path=True, **kw))
    for s in range(3):
        err, differ = compare_lifecycle(f"card symbol {s}", (wc[s], wf[s], wrow[s]),
                                        (ec[s], ef[s], rows[2][s]), e_paths, engine=True)
        e_err = max(e_err, err)
        if bool(differ.any()):
            raise AssertionError(f"engine universe symbol {s}: kernel and plain on the card "
                                 "differ")
    e_red_err = check_fold("mc_engine_universe_reduce_rows",
                           cuda_engine.reduce_rows_reference(*rows[:2]), (ec, ef))
    rows = rows[:2]
    e_ms = cuda_ms(lambda: cuda_engine.engine_universe_rows(7, lv3, p3e, s0_3, sg_3, device=dev,
                                                            **kw), 3)
    e_bound = card.bound(bytes_=rows[0].numel() * 8 + rows[1].numel() * 4,
                         **engine_ops(3 * e_paths, wc.sum(0).cpu(), 1.0))
    e_red_ms = cuda_ms(lambda: cuda_engine.reduce_rows(
        *rows, what="mc_engine_universe_reduce_rows"), 20)
    e_red_plain_ms = cuda_ms(lambda: cuda_engine.reduce_rows_reference(*rows), 20)
    e_red_bound = card.bound(bytes_=fold_cols(rows, cuda_engine), f32=0.0, sfu=0.0, imul=0.0)
    log(f"  every symbol equals the single kernel bit for bit; the plain version on the card "
        f"equals the kernel on every path; at 3 x {e_paths} paths with noise: kernel "
        f"{e_ms:.3f} ms, bound {e_bound['bound_ms']:.3f} ms {e_bound['bound_parts']}, plain "
        f"{e_plain_ms:.3f} ms; fold {e_red_ms:.4f} ms")
    main_inputs("the engine universe", f"config #4's {UNI_SYMBOLS} symbols, path by path")
    c4kw = dict(paths_per_symbol=UNI_SAMPLE_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
                external_uniforms=None, device=dev, per_path=True)
    sc, sf, srow = cuda_engine.engine_universe_totals_reference(
        0, c4[0], params, *c4[1:], chunk_blocks=512, **c4kw)
    e_err = max(e_err, same_on_card(
        "engine", (sc, sf, srow), fold(cuda_engine, cuda_engine.engine_universe_rows(
            0, c4[0], params, *c4[1:], **c4kw)), UNI_SYMBOLS, UNI_SAMPLE_PATHS,
        lambda s: f"symbol {s}"))
    del srow
    log(f"[17] main path: BASELINE config #4, mc_paths_engine_universe_fused ({UNI_SYMBOLS} "
        f"symbols x {UNI_PATHS} paths x {NUM_BARS} bars, sigma {UNI_SIGMA}, default params), "
        "one warm-up then timed")
    (st, skips, escal), secs, launches = run_entry(
        "mc_paths_engine_universe_fused", lambda: cuda_engine.mc_paths_engine_universe_fused(
            0, c4[0], params, *c4[1:], paths_per_symbol=UNI_PATHS, num_bars=NUM_BARS, dt=DT),
        reset, {"mc_engine_universe": 2, "mc_engine_universe_reduce_rows": 2})
    check_universe_stats("engine universe", st, UNI_SYMBOLS, UNI_PATHS)
    # one level a symbol: no next level to escalate to, so no escalation
    if not (tuple(skips.shape) == (UNI_SYMBOLS, 16) and bool((skips.sum(1) > 0).all())
            and tuple(escal.shape) == (UNI_SYMBOLS,)):
        raise AssertionError(f"engine universe: skips {tuple(skips.shape)}, escalations "
                             f"{tuple(escal.shape)}")
    log(f"  config #4 wall {secs[-1]:.3f} s ({UNI_SYMBOLS * UNI_PATHS / secs[-1]:.6e} paths/s "
        f"end to end); symbol 0: entered {int(st.n_entered[0])}, trades "
        f"{int(st.sum_trades[0])}, mean equity {float(st.mean_r[0]):.6f}, escalations "
        f"{int(escal[0])}")
    e_main = dict(paths_per_symbol=UNI_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
                  external_uniforms=None, device=dev)
    e_main_ms = cuda_ms(lambda: cuda_engine.engine_universe_rows(0, c4[0], params, *c4[1:],
                                                                 **e_main), 1)
    e_main_bound = card.bound(
        bytes_=row_bytes(cuda_engine, UNI_SYMBOLS, UNI_PATHS),
        **engine_ops(UNI_SYMBOLS * UNI_PATHS, sc.sum(0).cpu(), main_scale))
    log(f"  kernel alone at {UNI_SYMBOLS} x {UNI_PATHS} paths: {e_main_ms:.3f} ms "
        f"({UNI_SYMBOLS * UNI_PATHS / e_main_ms * 1e3:.6e} paths/s), bound "
        f"{e_main_bound['bound_ms']:.3f} ms {e_main_bound['bound_parts']}")
    # the refresh on run_all.py:205-209's shapes, made from a seed with numpy
    rng = np.random.default_rng(0)
    xs = rng.normal(0, 1, (UNI_SYMBOLS, 64, 4)).astype(np.float32)
    ys = (rng.uniform(size=(UNI_SYMBOLS, 64)) < 0.5).astype(np.int32)
    ws = np.ones((UNI_SYMBOLS, 64), np.float32)
    U.universe_policy_refresh(None, xs, ys, ws)
    model, refresh_ms = timed(lambda: U.universe_policy_refresh(None, xs, ys, ws))
    ref = U.universe_policy_refresh(None, xs.astype(np.float64), ys, ws.astype(np.float64),
                                    device="cpu")
    if model.coef.device.type != dev.type or model.coef.dtype != torch.float32:
        raise AssertionError(f"the refresh ran on {model.coef.device} in {model.coef.dtype}")
    d_coef = float((model.coef.cpu().double() - ref.coef).abs().max())
    d_icpt = float((model.intercept.cpu().double() - ref.intercept).abs().max())
    # float32 against float64 on [64, 4] designs: agreement to ~1e-6, held to 1e-4
    if not (d_coef <= 1e-4 and d_icpt <= 1e-4 and bool(torch.isfinite(model.coef).all())):
        raise AssertionError(f"the refresh differs from its float64 CPU fit: coef {d_coef}, "
                             f"intercept {d_icpt}")
    log(f"  refresh: universe_policy_refresh on [{UNI_SYMBOLS}, 64, 4] float32 on the card "
        f"{refresh_ms:.3f} ms (Newton steps {model.n_iter.tolist()[:4]}...); vs the float64 "
        f"CPU fit (steps {ref.n_iter.tolist()[:4]}...): max |d coef| {d_coef:.3e}, "
        f"|d intercept| {d_icpt:.3e}")
    out += [entry("mc_engine_universe", ENGINE_SOURCE, ENGINE_UNI_REPLACES,
                  launches["mc_engine_universe"], e_err, e_ms, e_plain_ms, e_bound, symbols=3,
                  paths=e_paths, noise=True, main_path_ms=e_main_ms,
                  main_path_bound_ms=e_main_bound["bound_ms"], config4_s=secs[1:],
                  refresh_ms=refresh_ms, refresh_max_abs_err=max(d_coef, d_icpt)),
            entry("mc_engine_universe_reduce_rows", ENGINE_SOURCE, ENGINE_UNI_REPLACES,
                  launches["mc_engine_universe_reduce_rows"], e_red_err, e_red_ms,
                  e_red_plain_ms, e_red_bound, rows=int(rows[0].shape[1]), symbols=3)]

    # ---- phase 18: sweep of universes (kernel #11)
    stops = torch.tensor([[0.35, 0.25, 0.45], [0.20, 0.30, 0.25], [0.45, 0.35, 0.30]])
    qmin = torch.tensor([0.60, 0.45, 0.60])
    grid = params.replace(stop_padding=stops, q_min_prob=qmin)
    g_noise = McNoise(level_jitter_std=torch.tensor([0.0, 0.02, 0.02]),
                      entry_slip_std=torch.tensor([0.0, 0.0, 0.01]),
                      stop_slip_std=torch.tensor([0.0, 0.0, 0.015]),
                      target_slip_std=torch.tensor([0.0, 0.0, 0.015]))
    nb2 = 2
    n_inj = nb2 * 8 * lanes
    log(f"[18] sweep of universes (mc_engine_sweep_kernel, S x G rows), injected uniforms: "
        f"3 symbols x 3 rows x {n_inj} paths ([S, G] stop paddings, [G] q_min and noise "
        "stds), kernel vs plain on CPU copies path by path, every differing path traced")
    u = torch.from_numpy(np.random.default_rng(603).uniform(
        1e-6, 1.0, (3, nb2, EngineLayout(NUM_BARS, True).u_rows, 8, lanes)).astype(np.float32))
    kw = dict(paths_per_symbol=n_inj, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=g_noise)
    want = cuda_engine.engine_universe_sweep_totals_reference(
        0, lv3, grid, s0_3, sg_3, external_uniforms=u, per_path=True, **kw)
    pc, pf, prow = cuda_engine.engine_universe_sweep_rows(
        0, lv3, grid, s0_3, sg_3, device=dev, external_uniforms=u.to(dev), per_path=True, **kw)
    ec, ef = cuda_engine.reduce_rows(pc.flatten(0, 1), pf.flatten(0, 1))
    ec, ef = ec.view(3, 3, -1), ef.view(3, 3, -1)
    torch.cuda.synchronize()
    es_err = 0.0
    for s in range(3):
        for g in range(3):
            err, _ = compare_lifecycle(
                f"cell ({s}, {g})", (want[0][s, g], want[1][s, g], want[2][s, g]),
                (ec[s, g], ef[s, g], prow[s, g]), n_inj, engine=True,
                trace=lambda d: trace_engine_flips(
                    f"cell ({s}, {g})", u[s], d, prow[s, g].cpu(), want[2][s, g].cpu(),
                    grid_row(lv3, s),
                    params.replace(stop_padding=stops[s, g], q_min_prob=qmin[g]), {},
                    float(sg_3[s]), grid_row(g_noise, g), False, dev, s0=float(s0_3[s])))
            es_err = max(es_err, err)
    es_paths = UNI_SWEEP_PATHS
    log(f"  Philox at {es_paths} paths a symbol: cell (s, g) vs the engine universe at row "
        "g's knobs bit for bit, per path included; kernel vs plain on the card path by path")
    kw = dict(paths_per_symbol=es_paths, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=g_noise,
              external_uniforms=None)
    rows = cuda_engine.engine_universe_sweep_rows(7, lv3, grid, s0_3, sg_3, device=dev,
                                                  per_path=True, **kw)
    for g in range(3):
        uni = cuda_engine.engine_universe_rows(
            7, lv3, params.replace(stop_padding=stops[:, g], q_min_prob=qmin[g]), s0_3, sg_3,
            device=dev, per_path=True, **dict(kw, noise=grid_row(g_noise, g)))
        if not all(torch.equal(a, b[:, g]) for a, b in zip(uni, rows)):
            raise AssertionError(f"sweep-of-universes row {g} differs from the engine universe")
    ec, ef = cuda_engine.reduce_rows(rows[0].flatten(0, 1), rows[1].flatten(0, 1))
    (wc, wf, wrow), es_plain_ms = timed(
        lambda: cuda_engine.engine_universe_sweep_totals_reference(
            7, lv3, grid, s0_3, sg_3, device=dev, chunk_blocks=512, per_path=True, **kw))
    for s in range(3):
        for g in range(3):
            err, differ = compare_lifecycle(
                f"card cell ({s}, {g})", (wc[s, g], wf[s, g], wrow[s, g]),
                (ec[3 * s + g], ef[3 * s + g], rows[2][s, g]), es_paths, engine=True)
            es_err = max(es_err, err)
            if bool(differ.any()):
                raise AssertionError(f"cell ({s}, {g}): kernel and plain on the card differ")
    es_red_err = check_fold("mc_engine_universe_sweep_reduce_rows",
                            cuda_engine.reduce_rows_reference(rows[0].flatten(0, 1),
                                                              rows[1].flatten(0, 1)), (ec, ef))
    rows = tuple(x.flatten(0, 1) for x in rows[:2])
    es_ms = cuda_ms(lambda: cuda_engine.engine_universe_sweep_rows(
        7, lv3, grid, s0_3, sg_3, device=dev, **kw), 3)
    es_bound = card.bound(bytes_=rows[0].numel() * 8 + rows[1].numel() * 4,
                          **engine_sweep_ops(3 * es_paths, [wc[:, g].sum(0).cpu()
                                                            for g in range(3)], 1.0))
    es_red_ms = cuda_ms(lambda: cuda_engine.reduce_rows(
        *rows, what="mc_engine_universe_sweep_reduce_rows"), 20)
    es_red_plain_ms = cuda_ms(lambda: cuda_engine.reduce_rows_reference(*rows), 20)
    es_red_bound = card.bound(bytes_=fold_cols(rows, cuda_engine), f32=0.0, sfu=0.0, imul=0.0)
    log(f"  every cell equals the engine universe bit for bit; the plain version on the card "
        f"equals the kernel on every path; at 3 x 3 x {es_paths} paths with noise: kernel "
        f"{es_ms:.3f} ms, bound {es_bound['bound_ms']:.3f} ms {es_bound['bound_parts']}, plain "
        f"{es_plain_ms:.3f} ms; fold {es_red_ms:.4f} ms")
    cfgs = [EngineParams.default(),
            EngineParams.default(stop_padding=0.20, tp_padding=0.40),
            EngineParams.default(q_min_prob=0.40, enable_veto=False),
            EngineParams.default(overtouch_limit=2, cooldown_s=180.0)]
    grid4 = stack_params(cfgs)
    c8 = config4(UNI_SWEEP_SYMBOLS)
    main_inputs("the sweep of universes", f"config #4's first {UNI_SWEEP_SYMBOLS} symbols x "
                "4 rows, path by path")
    c8kw = dict(paths_per_symbol=UNI_SAMPLE_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
                external_uniforms=None, device=dev, per_path=True)
    sc, sf, srow = cuda_engine.engine_universe_sweep_totals_reference(
        0, c8[0], grid4, *c8[1:], chunk_blocks=512, **c8kw)
    krows = cuda_engine.engine_universe_sweep_rows(0, c8[0], grid4, *c8[1:], **c8kw)
    es_err = max(es_err, same_on_card(
        "engine", tuple(x.flatten(0, 1) for x in (sc, sf, srow)),
        fold(cuda_engine, tuple(x.flatten(0, 1) for x in krows)), UNI_SWEEP_SYMBOLS * 4,
        UNI_SAMPLE_PATHS, lambda i: f"cell ({i // 4}, {i % 4})"))
    del srow, krows
    log(f"[18] main path: mc_paths_engine_universe_sweep_fused, config #4's first "
        f"{UNI_SWEEP_SYMBOLS} symbols x the 4 configurations of "
        f"tests/test_pallas_engine.py:320-325 x {UNI_PATHS} paths")
    (st, skips, escal), secs, launches = run_entry(
        "mc_paths_engine_universe_sweep_fused",
        lambda: cuda_engine.mc_paths_engine_universe_sweep_fused(
            0, c8[0], grid4, *c8[1:], paths_per_symbol=UNI_PATHS, num_bars=NUM_BARS, dt=DT),
        reset, {"mc_engine_universe_sweep": 2, "mc_engine_universe_sweep_reduce_rows": 2})
    if tuple(st.n.shape) != (UNI_SWEEP_SYMBOLS, 4) or not bool((st.n == UNI_PATHS).all()):
        raise AssertionError(f"sweep of universes: counts {st.n.tolist()}")
    if not (bool((st.n_entered > 0).all()) and bool(torch.isfinite(st.sum_r).all())
            and len({tuple(x) for x in skips[0].tolist()}) == 4):
        raise AssertionError("sweep of universes: a cell never entered, a non-finite sum, or "
                             "two rows deciding alike")
    es_main = dict(paths_per_symbol=UNI_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
                   external_uniforms=None, device=dev)
    es_main_ms = cuda_ms(lambda: cuda_engine.engine_universe_sweep_rows(
        0, c8[0], grid4, *c8[1:], **es_main), 1)
    es_main_bound = card.bound(
        bytes_=row_bytes(cuda_engine, UNI_SWEEP_SYMBOLS * 4, UNI_PATHS),
        **engine_sweep_ops(UNI_SWEEP_SYMBOLS * UNI_PATHS, [sc[:, g].sum(0).cpu()
                                                           for g in range(4)], main_scale))
    log(f"  kernel alone at {UNI_SWEEP_SYMBOLS} x 4 x {UNI_PATHS}: {es_main_ms:.3f} ms "
        f"({UNI_SWEEP_SYMBOLS * 4 * UNI_PATHS / es_main_ms * 1e3:.6e} paths x rows/s), bound "
        f"{es_main_bound['bound_ms']:.3f} ms {es_main_bound['bound_parts']}")
    out += [entry("mc_engine_universe_sweep", ENGINE_SOURCE, ENGINE_UNI_SWEEP_REPLACES,
                  launches["mc_engine_universe_sweep"], es_err, es_ms, es_plain_ms, es_bound,
                  symbols=3, grid_rows=3, paths=es_paths, noise=True, main_path_ms=es_main_ms,
                  main_path_bound_ms=es_main_bound["bound_ms"], main_s=secs[1:]),
            entry("mc_engine_universe_sweep_reduce_rows", ENGINE_SOURCE,
                  ENGINE_UNI_SWEEP_REPLACES, launches["mc_engine_universe_sweep_reduce_rows"],
                  es_red_err, es_red_ms, es_red_plain_ms, es_red_bound,
                  rows=int(rows[0].shape[1]), cells=9)]
    return out

# ---- the correlated books (kernels #7, #12): the CLI's ``book`` at 100
# symbols x 2^20 paths x 40 bars, BASELINE config #4's scale, spots 100 ..
# 199, sigma 0.3, betas from 0.2 to 0.8, equal weights
BOOK_SYMBOLS = 100
BOOK_PATHS = 1 << 20
BOOK_SAMPLE_PATHS = 1 << 16    # a symbol: the main path's inputs, kernel vs plain on the card
BOOK_S0 = [100.0 + i for i in range(BOOK_SYMBOLS)]
BOOK_BETAS = [0.2 + 0.6 * i / (BOOK_SYMBOLS - 1) for i in range(BOOK_SYMBOLS)]
BOOK3_BETAS = (0.8, 0.6, 0.3)
BOOK3_WEIGHTS = (0.5, 0.3, 0.2)
GATED_CORR_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:2421"
ENGINE_CORR_REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_engine.py:2692"


def book_market_ops(n_paths: float, n_sym: int) -> dict:
    """The operations a book adds to its symbols' lifecycles, the market
    counted once a path: a Box-Muller pair a double-bar step (logf, sqrtf,
    sincosf; half a Philox call, two rows of four words), the mix and the
    curve's fused multiply-add a symbol and bar, the fold a bar."""
    pairs = n_paths * NUM_BARS / 2
    f32 = 4 * pairs + n_paths * NUM_BARS * (n_sym * 4 + 3)
    return dict(f32=f32, sfu=2 * pairs, imul=PHILOX_IMULS * pairs / 2)


def book_argv(engine: bool) -> list:
    """The main path's ``book`` arguments."""
    return (["book"] + (["--engine"] if engine else [])
            + ["--backend", "cuda", "--num-symbols", str(BOOK_SYMBOLS), "--num-paths",
               str(BOOK_PATHS), "--num-bars", str(NUM_BARS), "--sigma", str(SIGMA),
               "--s0s", ",".join(repr(x) for x in BOOK_S0),
               "--betas", ",".join(repr(x) for x in BOOK_BETAS)])


def check_book_output(lines: list, n_sym: int, engine: bool) -> None:
    """A ``book`` run's rows: one a symbol with the JAX CLI's keys in its
    order, then the book's; finite, hit rates in (0, 1), the book's VaR below
    its mean and its drawdowns ordered."""
    keys = ["symbol", "beta", "weight", "hit_rate", "mean_r", "mean_trades", "max_dd"]
    keys += ["escalations"] if engine else []
    if len(lines) != n_sym + 1:
        raise AssertionError(f"{len(lines)} book rows, not {n_sym + 1}")
    for s, row in enumerate(lines[:-1]):
        if list(row) != keys or row["symbol"] != s:
            raise AssertionError(f"book row {s}: keys {list(row)}, not {keys}")
        if not row["mean_trades"] >= 1.0:
            raise AssertionError(f"book row {s}: fewer trades than entered paths: {row}")
    port = lines[-1]
    if list(port) != ["portfolio", "mean_r", "std_r", "var_05", "cvar_05", "max_dd",
                      "mean_dd"] or port["portfolio"] is not True:
        raise AssertionError(f"book row: {port}")
    if not (port["cvar_05"] <= port["var_05"] <= port["mean_r"]
            and port["max_dd"] >= port["mean_dd"] >= 0.0 and port["std_r"] > 0.0):
        raise AssertionError(f"book risk out of order: {port}")


def book_phases(dev, card, reset, cli) -> list:
    """Phases 19-20: the two book kernels against their plain versions and
    the universe kernels, and the CLI's ``book`` / ``book --engine`` at the
    main-path size; returns their entries of the ``kernels`` line."""
    import numpy as np
    import torch

    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.engine.state import MlModel
    from qmmx_monolithic_monte_carlo_tpu_torch.models.online_policy import PolicyParams
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout, GatedLayout
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.guard import GuardParams
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row, grid_size
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.touch import TouchMemoryParams
    from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.enginepath import SKIP_REASONS, engine_knobs
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import GateConfig
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise

    params = EngineParams.default()
    lv3 = U.stack_levels(UNI3_ROWS, max_levels=8)
    s0_3, sg_3 = np.array(UNI3_S0, np.float32), np.array(UNI3_SIGMA, np.float32)
    b3, w3 = np.array(BOOK3_BETAS, np.float32), np.array(BOOK3_WEIGHTS, np.float32)
    p3 = params.replace(contact_prox=[0.05, 0.08, 0.03], stop_padding=[0.35, 0.20, 0.45],
                        tp_padding=[0.25, 0.40, 0.15])
    p3e = p3.replace(q_min_prob=[0.60, 0.40, 0.55])
    noise3 = McNoise(level_jitter_std=torch.tensor([0.0, 0.02, 0.01]),
                     entry_slip_std=torch.tensor([0.01, 0.0, 0.0]),
                     stop_slip_std=torch.tensor([0.0, 0.015, 0.0]),
                     target_slip_std=torch.tensor([0.015, 0.0, 0.0]))
    # the main path's book: the CLI's level scaffold around each spot
    lv100 = U.stack_levels([[{"color": "blue", "type": "solid", "index": 0, "price": x},
                             {"color": "orange", "type": "dashed", "index": 0,
                              "price": x + 0.4}] for x in BOOK_S0], max_levels=4)
    s0_100 = np.array(BOOK_S0, np.float32)
    sg_100 = np.full(BOOK_SYMBOLS, SIGMA, np.float32)
    b100 = np.array(BOOK_BETAS, np.float32)
    w100 = np.full(BOOK_SYMBOLS, 1.0 / BOOK_SYMBOLS, np.float32)
    book100 = (lv100, params, s0_100, sg_100, b100, w100)
    main_scale = BOOK_PATHS / BOOK_SAMPLE_PATHS
    out = []

    def book_trace(name, differ, kernel_rows, cpu_rows, symbol_runs, weights):
        """Phase 6's trace for the book's differing paths: every symbol's
        plain lifecycle over the bars the plain version makes on the CPU and
        over those it makes on the card (``symbol_runs(s, on_card, idx)`` ->
        (equity f32[n, W], rows f32[n, 6], integer state int[n, W, k])),
        combined as the book combines them (``sim/book.BookCurve``).  The
        card's combine equals the kernel's book row exactly, the CPU's the
        plain row, and on every differing path some symbol's integer state
        parts between the two at some bar (a decision flipped; its final row
        may agree with the plain one, as a close a bar later does)."""
        from qmmx_monolithic_monte_carlo_tpu_torch.ops.cuda_gated import lifecycle_rows
        from qmmx_monolithic_monte_carlo_tpu_torch.sim.book import BookCurve
        from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import LifecycleOutcome

        idx = torch.nonzero(differ).flatten()
        if idx.numel() == 0:
            return
        parted = torch.zeros(idx.numel(), dtype=torch.bool)
        books = []
        runs = [[symbol_runs(s, on_card, idx) for s in range(len(weights))]
                for on_card in (False, True)]
        for side in runs:
            book = BookCurve(idx.numel(), NUM_BARS)
            for (eq, rows, _), w in zip(side, weights):
                book.add_curve(float(w), eq.T.contiguous())
                book.add_symbol(LifecycleOutcome(
                    equity=rows[:, 0], trades=rows[:, 1].int(), wins=rows[:, 2].int(),
                    losses=rows[:, 3].int(), open_at_end=rows[:, 4] > 0, max_dd=rows[:, 5]))
            books.append(lifecycle_rows(book.outcome()))
        for (_, _, i_cpu), (_, _, i_dev) in zip(*runs):
            parted |= (i_cpu != i_dev).flatten(1).any(dim=1)
        if not torch.equal(books[1], kernel_rows[idx][:, :6]):
            raise AssertionError(f"{name}: the kernel's book differs from the plain book "
                                 "on the card's bars")
        if not torch.equal(books[0], cpu_rows[idx][:, :6]):
            raise AssertionError(f"{name}: the traced book differs from the plain version")
        if not bool(parted.all()):
            raise AssertionError(f"{name}: a differing book path shows no flipped decision "
                                 "in any symbol")
        log(f"  {name} book: {idx.numel()} differing paths, each traced to a flipped "
            "decision of a symbol; kernel == plain book on the card's bars")

    def injected(name, mod, want, got, n, trace_one, trace_book):
        err = 0.0
        for s in range(3):
            e, _ = compare_lifecycle(
                f"{name} symbol {s}", (want[0][s], want[1][s], want[2][s]),
                (got[0][s], got[1][s], got[2][s]), n, engine=mod is cuda_engine,
                trace=lambda dd: trace_one(s, dd))
            err = max(err, e)
        e, _ = compare_lifecycle(
            f"{name} book", (want[0][3], want[1][3], want[2][3]),
            (got[0][3], got[1][3], got[2][3]), n, engine=mod is cuda_engine,
            trace=lambda dd: book_trace(name, dd, got[2][3].cpu(), want[2][3].cpu(),
                                        trace_book, w3))
        return max(err, e)

    def beta0_and_one_symbol(name, rows_fn, uni_fn, one_fn, paths):
        """At ``paths`` a symbol (one path a thread: a book CTA's rows then add
        its paths in the universe's order, so its float sums are the
        universe's too)."""
        a = rows_fn(0.0, paths)
        b = uni_fn(paths)
        if not all(torch.equal(x[:3], y) for x, y in zip(a, b)):
            raise AssertionError(f"{name} at beta 0 differs from the universe kernel")
        c, f, r = one_fn(paths)
        cols = [0, 1, 2, 3, 4, 5]
        if not (torch.equal(r[1][:, :6], r[0][:, :6]) and torch.equal(f[1], f[0])
                and torch.equal(c[1][cols], c[0][cols])
                and torch.equal(c[1][-128:], c[0][-128:])):
            raise AssertionError(f"{name}: the one-symbol book of weight 1 differs from its "
                                 "symbol")
        log(f"  Philox at {paths} paths a symbol: every symbol of the book at beta 0 equals "
            "the universe kernel's bit for bit (partial and per-path rows); a one-symbol "
            "book of weight 1 equals its symbol's row bit for bit")

    def book_row(i):
        return "the book" if i == BOOK_SYMBOLS else f"symbol {i}"

    def alone(name, rows_fn):
        rows_fn()                                        # warm
        ms = cuda_ms(rows_fn, 2)
        log(f"  {name} alone at {BOOK_SYMBOLS} x {BOOK_PATHS} paths: {ms:.3f} ms "
            f"({BOOK_SYMBOLS * BOOK_PATHS / ms * 1e3:.6e} paths x symbols/s)")
        return ms

    # ---- phase 19: the gated book (kernel #7)
    lanes = GATED_LANES
    gate = GateConfig.from_params(params)
    nb = GATED_INJECT_BLOCKS
    n_inj = nb * 8 * lanes
    log(f"[19] gated book (mc_gated_corr_kernel), injected uniforms: 3 symbols x {n_inj} "
        "paths (own levels, s0, sigma, beta, weight, knobs, [S] noise stds), antithetic, "
        "kernel vs plain on CPU copies path by path, every differing path traced")
    rng = np.random.default_rng(700)
    u = torch.from_numpy(rng.uniform(
        1e-9, 1.0, (3, nb, GatedLayout(NUM_BARS, True).u_rows, 8, lanes)).astype(np.float32))
    um = torch.from_numpy(rng.uniform(1e-9, 1.0, (nb, NUM_BARS, 8, lanes)).astype(np.float32))
    kw = dict(paths_per_symbol=n_inj, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=noise3,
              antithetic=True, per_path=True)
    want = cuda_gated.gated_corr_totals_reference(0, lv3, p3, s0_3, sg_3, b3, w3, gate,
                                                  external_uniforms=u, market_uniforms=um,
                                                  **kw)
    pc, pf, prow = cuda_gated.gated_corr_rows(0, lv3, p3, s0_3, sg_3, b3, w3, gate, device=dev,
                                              external_uniforms=u.to(dev),
                                              market_uniforms=um.to(dev), **kw)
    gc, gf = cuda_gated.reduce_rows(pc, pf)
    torch.cuda.synchronize()
    def gated_runs(s, on_card, idx):
        src = dev if on_card else torch.device("cpu")
        bars, tie, nzs = cuda_gated.gated_bars_from_uniforms(
            u[s].to(src), GatedLayout(NUM_BARS, True), s0=float(s0_3[s]), mu=0.0,
            sigma=float(sg_3[s]), dt=DT, antithetic=True, market_uniforms=um.to(src),
            beta=float(b3[s]))
        pick = type(bars)(*(x[idx.to(src)].cpu() for x in bars))
        out, ints, floats = lifecycle_trace(pick, tie[idx.to(src)].cpu(),
                                            nzs[:, idx.to(src)].cpu(), grid_row(lv3, s),
                                            grid_row(p3, s), gate, grid_row(noise3, s))
        return floats[:, :, 3], cuda_gated.lifecycle_rows(out), ints

    g_err = injected("gated", cuda_gated, want, (gc, gf, prow), n_inj,
                     lambda s, d: trace_flips(
                         f"symbol {s}", u[s], d, prow[s].cpu(), want[2][s].cpu(),
                         grid_row(lv3, s), grid_row(p3, s), gate, grid_row(noise3, s), True,
                         dev, s0=float(s0_3[s]), sigma=float(sg_3[s]),
                         market=(um, float(b3[s]))), gated_runs)
    g_red_err = check_fold("mc_gated_corr_reduce_rows",
                           cuda_gated.reduce_rows_reference(pc, pf), (gc, gf))
    gkw = dict(num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=noise3, external_uniforms=None,
               device=dev, per_path=True)
    beta0_and_one_symbol(
        "the gated book",
        lambda beta, n: cuda_gated.gated_corr_rows(7, lv3, p3, s0_3, sg_3, beta, w3, gate,
                                                   paths_per_symbol=n, **gkw),
        lambda n: cuda_gated.gated_universe_rows(7, lv3, p3, s0_3, sg_3, gate,
                                                 paths_per_symbol=n, **gkw),
        lambda n: (lambda r: (*cuda_gated.reduce_rows(r[0], r[1]), r[2]))(
            cuda_gated.gated_corr_rows(7, U.stack_levels(UNI3_ROWS[:1], max_levels=8),
                                       params, [100.0], [SIGMA], [0.7], [1.0], gate,
                                       paths_per_symbol=n, **dict(gkw, noise=None))),
        BOOK_PATHS)
    log(f"  on the main path's inputs ({BOOK_SYMBOLS} symbols) at {BOOK_SAMPLE_PATHS} paths a "
        "symbol, Philox: kernel vs plain on the card, path by path")
    skw = dict(paths_per_symbol=BOOK_SAMPLE_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
               noise=None, external_uniforms=None, device=dev, per_path=True)
    (sc, sf, srow, held), g_plain_ms = timed(lambda: cuda_gated.gated_corr_totals_reference(
        0, *book100, chunk_blocks=64, work=True, **skw))
    krows = cuda_gated.gated_corr_rows(0, *book100, **skw)
    g_err = max(g_err, same_on_card("gated book", (sc, sf, srow),
                                    (*cuda_gated.reduce_rows(krows[0], krows[1]), krows[2]),
                                    BOOK_SYMBOLS + 1, BOOK_SAMPLE_PATHS, book_row, engine=False))
    del srow, krows
    g_sample_ms = cuda_ms(lambda: cuda_gated.gated_corr_rows(0, *book100, **dict(
        skw, per_path=False)), 2)
    main = dict(paths_per_symbol=BOOK_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=None,
                external_uniforms=None, device=dev)
    g_main_ms = alone("the gated book kernel",
                      lambda: cuda_gated.gated_corr_rows(0, *book100, **main))
    g_ops = gated_ops(BOOK_SYMBOLS * BOOK_PATHS, float(held.sum()) * main_scale,
                      float(sc[:-1, 5].sum()) * main_scale)
    for k, v in book_market_ops(BOOK_PATHS, BOOK_SYMBOLS).items():
        g_ops[k] += v
    g_rows = cuda_gated.gated_corr_rows(0, *book100, **main)
    g_row_bytes = g_rows[0].numel() * 8 + g_rows[1].numel() * 4
    g_bound = card.bound(bytes_=g_row_bytes, **g_ops)
    g_red_ms = cuda_ms(lambda: cuda_gated.reduce_rows(*g_rows, what="mc_gated_corr_reduce_rows"),
                       20)
    g_red_plain_ms = cuda_ms(lambda: cuda_gated.reduce_rows_reference(*g_rows), 20)
    g_red_bound = card.bound(bytes_=g_row_bytes + (BOOK_SYMBOLS + 1) * (
        cuda_gated.ROW_COUNTS * 8 + cuda_gated.ROW_FLOATS * 8), f32=0.0, sfu=0.0, imul=0.0)
    log(f"  bound at {BOOK_SYMBOLS} x {BOOK_PATHS} paths: {g_bound['bound_ms']:.3f} ms "
        f"{g_bound['bound_parts']}; plain on the card at {BOOK_SYMBOLS} x "
        f"{BOOK_SAMPLE_PATHS} paths {g_plain_ms:.3f} ms (kernel there {g_sample_ms:.3f} ms); "
        f"fold of {BOOK_SYMBOLS + 1} x {grid_size(BOOK_PATHS)} rows {g_red_ms:.4f} ms")
    with tempfile.TemporaryDirectory() as tmp:
        db = ["--db", os.path.join(tmp, "smoke.db")]
        log(f"[19] main path: cli book --backend cuda, {BOOK_SYMBOLS} symbols x {BOOK_PATHS} "
            f"paths x {NUM_BARS} bars (spots {BOOK_S0[0]:g}..{BOOK_S0[-1]:g}, sigma {SIGMA}, "
            "betas 0.2..0.8, equal weights)")
        lines, g_secs, g_launches = run_cli(
            cli, db + book_argv(False), reset,
            {"mc_gated_corr": 4, "mc_gated_corr_reduce_rows": 4},
            work=BOOK_SYMBOLS * BOOK_PATHS, unit="paths x symbols")
        check_book_output(lines, BOOK_SYMBOLS, False)
        log(f"  book row: {json.dumps(lines[-1])}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(db + ["book", "--backend", "cuda"])
        dflt = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
        if rc != 0:
            raise AssertionError(f"cli book (defaults) exited {rc}")
        check_book_output(dflt, 8, False)
        log(f"  cli book --backend cuda at its defaults (8 x {1 << 16}): {len(dflt)} rows in "
            "the JAX CLI's form")
    out += [entry("mc_gated_corr", GATED_CORR_SOURCE, GATED_CORR_REPLACES,
                  g_launches["mc_gated_corr"], g_err, g_main_ms, g_plain_ms, g_bound,
                  symbols=BOOK_SYMBOLS, paths=BOOK_PATHS, plain_paths=BOOK_SAMPLE_PATHS,
                  kernel_ms_at_plain_size=g_sample_ms, cli_s=g_secs[1:]),
            entry("mc_gated_corr_reduce_rows", GATED_SOURCE, GATED_CORR_REPLACES,
                  g_launches["mc_gated_corr_reduce_rows"], g_red_err, g_red_ms, g_red_plain_ms,
                  g_red_bound, rows=int(g_rows[0].shape[1]), segments=BOOK_SYMBOLS + 1)]
    del g_rows

    # ---- phase 20: the engine book (kernel #12)
    lanes = ENGINE_LANES
    n_inj = ENGINE_INJECT_BLOCKS * 8 * lanes
    w_pass = np.zeros((3, 7), np.float32)
    w_pass[0, 0], w_pass[0, 6] = -0.6, 20.0     # phase 9's policy that lets longs
    w_pass[1, 0], w_pass[1, 6] = -0.2, 20.0     # through from bar ~20, shorts from ~12
    w_pass[2, 0] = -1.0
    armed = dict(policy=PolicyParams.init().replace(w_entry=torch.from_numpy(w_pass)),
                 ml_model=MlModel.from_weights(np.array([0.4, -0.8, -0.3, 0.2],
                                                        np.float32), 0.55))
    accumulating = dict(
        guard_params=GuardParams.default().replace(min_bars=6, compression_bp=300.0),
        touch_params=TouchMemoryParams.default().replace(
            max_bounces=1, min_time_gap_ms=120_000, fatigue_vol_k=0.0))
    e_err = 0.0
    for case, gates, sig, nz, anti, blocks in (
            ("ml and policy gates armed, noise, antithetic", armed, sg_3, noise3, True,
             ENGINE_INJECT_BLOCKS),
            ("accumulation", accumulating, np.full(3, 0.05, np.float32), None, False, 4)):
        n = blocks * 8 * lanes
        log(f"[20] engine book (mc_engine_corr_kernel), injected uniforms: 3 symbols x {n} "
            f"paths ([S] knobs, beta, weight), {case}: kernel vs plain on CPU copies path by "
            "path, every differing path traced")
        rng = np.random.default_rng(800 + blocks)
        u = torch.from_numpy(rng.uniform(1e-6, 1.0, (
            3, blocks, EngineLayout(NUM_BARS, nz is not None).u_rows, 8, lanes)).astype(
                np.float32))
        um = torch.from_numpy(rng.uniform(1e-6, 1.0, (blocks, NUM_BARS, 8, lanes)).astype(
            np.float32))
        kw = dict(paths_per_symbol=n, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=nz,
                  antithetic=anti, per_path=True, **gates)
        want = cuda_engine.engine_corr_totals_reference(0, lv3, p3e, s0_3, sig, b3, w3,
                                                        external_uniforms=u,
                                                        market_uniforms=um, **kw)
        pc, pf, prow = cuda_engine.engine_corr_rows(0, lv3, p3e, s0_3, sig, b3, w3, device=dev,
                                                    external_uniforms=u.to(dev),
                                                    market_uniforms=um.to(dev), **kw)
        ec, ef = cuda_engine.reduce_rows(pc, pf)
        torch.cuda.synchronize()
        def engine_runs(s, on_card, idx, u=u, um=um, gates=gates, sig=sig, nz=nz, anti=anti):
            src = dev if on_card else torch.device("cpu")
            bars, tie, nzs = cuda_engine.engine_bars_from_uniforms(
                u[s].to(src), EngineLayout(NUM_BARS, nz is not None), s0=float(s0_3[s]),
                mu=0.0, sigma=float(sig[s]), dt=DT, antithetic=anti,
                market_uniforms=um.to(src), beta=float(b3[s]))
            pick = type(bars)(*(x[idx.to(src)] for x in bars))
            rows, ints, eq, _ = engine_trace(pick, tie[idx.to(src)],
                                          None if nzs is None else nzs[:, idx.to(src)],
                                          grid_row(lv3, s), grid_row(p3e, s),
                                          engine_knobs(**gates), grid_row(nz, s), src)
            return eq, rows[:, :6], ints

        e_err = max(e_err, injected(
            "engine", cuda_engine, want, (ec, ef, prow), n,
            lambda s, d: trace_engine_flips(
                f"symbol {s}", u[s], d, prow[s].cpu(), want[2][s].cpu(), grid_row(lv3, s),
                grid_row(p3e, s), gates, float(sig[s]), grid_row(nz, s), anti, dev,
                s0=float(s0_3[s]), market=(um, float(b3[s]))), engine_runs))
        skips = ec[:3, 7:23].sum(dim=0).tolist()
        named = dict(zip((r.name for r in SKIP_REASONS), skips))
        if case == "accumulation" and not (named["EDGE_FATIGUE"] + named["TOUCH_BUDGET"]
                                           + named["TOUCH_COOLDOWN"]) > 0:
            raise AssertionError(f"accumulation case: no accumulation gate fired: {named}")
        if case.startswith("ml and policy") and not (
                (named["ML_CONF_LOW"] > 0 or named["ONLINE_POLICY"] > 0) and int(ec[3, 5]) > 0):
            raise AssertionError(f"{case}: a gate never fired or nothing entered: {named}")
        if bool(ec[3, 6:23].any()):
            raise AssertionError("the engine book's escalation and skip columns are not zero")
    e_red_err = check_fold("mc_engine_corr_reduce_rows",
                           cuda_engine.reduce_rows_reference(pc, pf), (ec, ef))
    ekw = dict(num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=noise3, external_uniforms=None,
               device=dev, per_path=True)
    beta0_and_one_symbol(
        "the engine book",
        lambda beta, n: cuda_engine.engine_corr_rows(7, lv3, p3e, s0_3, sg_3, beta, w3,
                                                     paths_per_symbol=n, **ekw),
        lambda n: cuda_engine.engine_universe_rows(7, lv3, p3e, s0_3, sg_3,
                                                   paths_per_symbol=n, **ekw),
        lambda n: (lambda r: (*cuda_engine.reduce_rows(r[0], r[1]), r[2]))(
            cuda_engine.engine_corr_rows(7, U.stack_levels(UNI3_ROWS[:1], max_levels=8),
                                         params, [100.0], [SIGMA], [0.7], [1.0],
                                         paths_per_symbol=n, **dict(ekw, noise=None))),
        BOOK_PATHS)
    log(f"  on the main path's inputs ({BOOK_SYMBOLS} symbols) at {BOOK_SAMPLE_PATHS} paths a "
        "symbol, Philox: kernel vs plain on the card, path by path")
    skw = dict(paths_per_symbol=BOOK_SAMPLE_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes,
               noise=None, external_uniforms=None, device=dev, per_path=True)
    (sc, sf, srow), e_plain_ms = timed(lambda: cuda_engine.engine_corr_totals_reference(
        0, *book100, chunk_blocks=64, **skw))
    krows = cuda_engine.engine_corr_rows(0, *book100, **skw)
    e_err = max(e_err, same_on_card("engine book", (sc, sf, srow),
                                    (*cuda_engine.reduce_rows(krows[0], krows[1]), krows[2]),
                                    BOOK_SYMBOLS + 1, BOOK_SAMPLE_PATHS, book_row))
    del srow, krows
    e_sample_ms = cuda_ms(lambda: cuda_engine.engine_corr_rows(0, *book100, **dict(
        skw, per_path=False)), 1)
    main = dict(paths_per_symbol=BOOK_PATHS, num_bars=NUM_BARS, dt=DT, lanes=lanes, noise=None,
                external_uniforms=None, device=dev)
    e_main_ms = alone("the engine book kernel",
                      lambda: cuda_engine.engine_corr_rows(0, *book100, **main))
    sc = sc.cpu()
    e_ops = {"f32": 0.0, "sfu": 0.0, "imul": 0.0}
    for s in range(BOOK_SYMBOLS):
        for k, v in engine_ops(BOOK_PATHS, sc[s], main_scale).items():
            e_ops[k] += v
    for k, v in book_market_ops(BOOK_PATHS, BOOK_SYMBOLS).items():
        e_ops[k] += v
    e_rows = cuda_engine.engine_corr_rows(0, *book100, **main)
    e_row_bytes = e_rows[0].numel() * 8 + e_rows[1].numel() * 4
    e_bound = card.bound(bytes_=e_row_bytes, **e_ops)
    e_red_ms = cuda_ms(lambda: cuda_engine.reduce_rows(*e_rows,
                                                       what="mc_engine_corr_reduce_rows"), 20)
    e_red_plain_ms = cuda_ms(lambda: cuda_engine.reduce_rows_reference(*e_rows), 20)
    e_red_bound = card.bound(bytes_=e_row_bytes + (BOOK_SYMBOLS + 1) * (
        cuda_engine.ROW_COUNTS * 8 + cuda_engine.ROW_FLOATS * 8), f32=0.0, sfu=0.0, imul=0.0)
    log(f"  bound at {BOOK_SYMBOLS} x {BOOK_PATHS} paths: {e_bound['bound_ms']:.3f} ms "
        f"{e_bound['bound_parts']}; plain on the card at {BOOK_SYMBOLS} x "
        f"{BOOK_SAMPLE_PATHS} paths {e_plain_ms:.3f} ms (kernel there {e_sample_ms:.3f} ms); "
        f"fold of {BOOK_SYMBOLS + 1} x {grid_size(BOOK_PATHS)} rows {e_red_ms:.4f} ms")
    log(f"  work per path and symbol (first {BOOK_SAMPLE_PATHS} paths): trades "
        f"{float(sc[:-1, 5].sum()) / BOOK_SAMPLE_PATHS / BOOK_SYMBOLS:.4f}, skips "
        f"{[round(float(x) / BOOK_SAMPLE_PATHS / BOOK_SYMBOLS, 4) for x in sc[:-1, 7:23].sum(0)]}")
    with tempfile.TemporaryDirectory() as tmp:
        db = ["--db", os.path.join(tmp, "smoke.db")]
        log(f"[20] main path: cli book --engine --backend cuda, {BOOK_SYMBOLS} symbols x "
            f"{BOOK_PATHS} paths x {NUM_BARS} bars")
        lines, e_secs, e_launches = run_cli(
            cli, db + book_argv(True), reset,
            {"mc_engine_corr": 4, "mc_engine_corr_reduce_rows": 4},
            work=BOOK_SYMBOLS * BOOK_PATHS, unit="paths x symbols")
        check_book_output(lines, BOOK_SYMBOLS, True)
        log(f"  book row: {json.dumps(lines[-1])}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(db + ["book", "--engine", "--backend", "cuda"])
        dflt = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
        if rc != 0:
            raise AssertionError(f"cli book --engine (defaults) exited {rc}")
        check_book_output(dflt, 8, True)
        log(f"  cli book --engine --backend cuda at its defaults (8 x {1 << 16}): {len(dflt)} "
            "rows in the JAX CLI's form")
    out += [entry("mc_engine_corr", ENGINE_CORR_SOURCE, ENGINE_CORR_REPLACES,
                  e_launches["mc_engine_corr"], e_err, e_main_ms, e_plain_ms, e_bound,
                  symbols=BOOK_SYMBOLS, paths=BOOK_PATHS, plain_paths=BOOK_SAMPLE_PATHS,
                  kernel_ms_at_plain_size=e_sample_ms, cli_s=e_secs[1:]),
            entry("mc_engine_corr_reduce_rows", ENGINE_SOURCE, ENGINE_CORR_REPLACES,
                  e_launches["mc_engine_corr_reduce_rows"], e_red_err, e_red_ms,
                  e_red_plain_ms, e_red_bound, rows=int(e_rows[0].shape[1]),
                  segments=BOOK_SYMBOLS + 1)]
    return out


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
    from qmmx_monolithic_monte_carlo_tpu_torch.engine.state import MlModel
    from qmmx_monolithic_monte_carlo_tpu_torch.models.online_policy import PolicyParams
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated, cuda_mc
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout, GatedLayout
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.guard import GuardParams
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.touch import TouchMemoryParams
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.enginepath import SKIP_REASONS
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import GateConfig
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.pathsim import (LIFE_HIST_HI,
                                                                   LIFE_HIST_LO, PathStats)
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
    build.build_all(["mc_first_contact", "mc_gated", "mc_engine", "mc_gated_corr",
                     "mc_engine_corr"])
    log(f"[2] build: {time.perf_counter() - t0:.2f} s wall")
    for name, info in build.BUILD_LOG.items():
        log(f"  {name}: nvcc {info['seconds']:.2f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill",
                                       "error")):
                log(f"    ptxas: {line.strip()}")

    def reset_all():
        for mod in (cuda_mc, cuda_gated, cuda_engine):
            mod.reset_launches()

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
        (fc_out,), fc_secs, fc_launches = run_cli(
            cli, argv, reset_all, {"mc_first_contact": 4, "mc_reduce_rows": 4})
    check_paths_output(fc_out)
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
        err, _ = compare_lifecycle(
            case, want, got, n_inj,
            trace=lambda d: trace_flips(case, u, d, rows.cpu(), want[2].cpu(), levels,
                                        params, gate, nz, anti, dev))
        gated_err = max(gated_err, err)

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
        gated_err = max(gated_err, compare_lifecycle(case, want, got, PHILOX_PATHS)[0])
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
        (g_out,), g_secs, g_launches = run_cli(
            cli, argv, reset_all, {"mc_gated": 4, "mc_gated_reduce_rows": 4})
    check_paths_output(g_out)
    if not g_out["trades"] >= g_out["entered"] > 0:
        raise AssertionError(f"trades < entered: {g_out}")
    if not g_out["mean_trades"] >= 1.0 or not g_out["max_dd"] >= 0.0:
        raise AssertionError(f"mean_trades < 1 or max_dd < 0: {g_out}")
    g_main_ms = cuda_ms(lambda: run_gated(MAIN_PATHS), 3)
    g_main_bound = g_bound(MAIN_PATHS)
    log(f"  kernel alone at {MAIN_PATHS} paths: {g_main_ms:.3f} ms "
        f"({MAIN_PATHS / g_main_ms * 1e3:.6e} paths/s), bound "
        f"{g_main_bound['bound_ms']:.3f} ms {g_main_bound['bound_parts']}")

    # ---- phase 9: engine, injected uniforms
    ecommon = dict(num_bars=NUM_BARS, s0=100.0, mu=0.0, dt=DT, lanes=ENGINE_LANES)
    e_levels = Levels.from_rows(ENGINE_ROWS, max_levels=8)
    n_einj = ENGINE_INJECT_BLOCKS * 8 * ENGINE_LANES
    rng = np.random.default_rng(7)
    w_entry = rng.normal(0, 0.8, (3, 7)).astype(np.float32)
    w_entry[0, 0] += 0.8
    w_entry[1, 0] += 0.8
    w_entry[2, 0] -= 0.5
    armed = dict(policy=PolicyParams.init().replace(w_entry=torch.from_numpy(w_entry)),
                 ml_model=MlModel.from_weights(np.array([0.4, -0.8, -0.3, 0.2],
                                                        np.float32), 0.55))
    w_pass = np.zeros((3, 7), np.float32)
    w_pass[0, 0], w_pass[0, 6] = -0.6, 20.0     # longs pass from bar ~20,
    w_pass[1, 0], w_pass[1, 6] = -0.2, 20.0     # shorts from bar ~12
    w_pass[2, 0] = -1.0
    passing = dict(armed, policy=PolicyParams.init().replace(w_entry=torch.from_numpy(w_pass)))
    accumulating = dict(
        guard_params=GuardParams.default().replace(min_bars=6, compression_bp=300.0),
        touch_params=TouchMemoryParams.default().replace(
            max_bounces=1, min_time_gap_ms=120_000, fatigue_vol_k=0.0))
    log(f"[9] engine, injected uniforms: kernel vs plain (plain on CPU copies), "
        f"{n_einj} paths")
    engine_err = 0.0
    blend = EngineParams.default(use_blend=True, w_rules=0.5, w_ml=0.7, q_min_prob=0.62)
    for case, sig, gates, nz, anti, e_params in (
            ("defaults", SIGMA, {}, None, False, params),
            ("accumulation", 0.05, accumulating, None, False, params),
            ("ml+policy", SIGMA, armed, None, False, params),
            ("ml+policy passing", SIGMA, passing, None, False, params),
            ("blend", SIGMA, passing, None, False, blend),
            ("noise", SIGMA, {}, noise, False, params),
            ("antithetic", SIGMA, {}, None, True, params)):
        rng = np.random.default_rng(200 + len(case))
        u = torch.from_numpy(rng.uniform(
            1e-6, 1.0, (ENGINE_INJECT_BLOCKS, EngineLayout(NUM_BARS, nz is not None).u_rows,
                        8, ENGINE_LANES)).astype(np.float32))
        kw = dict(ecommon, sigma=sig, num_paths=n_einj, noise=nz, antithetic=anti, **gates)
        want = cuda_engine.engine_totals_reference(0, e_levels, e_params,
                                                   external_uniforms=u, per_path=True, **kw)
        pc, pf, rows = cuda_engine.engine_rows(0, e_levels, e_params, device=dev,
                                               external_uniforms=u.to(dev),
                                               per_path=True, **kw)
        got = (*cuda_engine.reduce_rows(pc, pf), rows)
        torch.cuda.synchronize()
        err, _ = compare_lifecycle(
            case, want, got, n_einj, engine=True,
            trace=lambda d: trace_engine_flips(case, u, d, rows.cpu(), want[2].cpu(),
                                               e_levels, e_params, gates, sig, nz, anti, dev))
        engine_err = max(engine_err, err)
        skips = dict(zip((r.name for r in SKIP_REASONS), got[0][7:23].tolist()))
        if case == "accumulation" and not (skips["EDGE_FATIGUE"] + skips["TOUCH_BUDGET"]
                                           + skips["TOUCH_COOLDOWN"]) > 0:
            raise AssertionError(f"accumulation case: no accumulation gate fired: {skips}")
        if case.startswith("ml+policy") and not (skips["ML_CONF_LOW"] > 0
                                                 or skips["ONLINE_POLICY"] > 0):
            raise AssertionError(f"{case} case: neither gate fired: {skips}")
        if case in ("ml+policy passing", "blend") and not int(got[0][5]) > 0:
            raise AssertionError(f"{case} case: no entry passed the gates")
        if case == "blend" and not skips["COMBINED_LOW"] > 0:
            raise AssertionError(f"blend case: the blended gate never fired: {skips}")

    # ---- phase 10: engine, Philox stream, and the row fold
    log(f"[10] engine, Philox: kernel vs plain at {PHILOX_PATHS} paths (plain on "
        "the card), the main path's inputs")
    engine_red_err = 0.0
    for case, nz in (("philox", None), ("philox+noise", noise)):
        kw = dict(ecommon, sigma=SIGMA, num_paths=PHILOX_PATHS, noise=nz, antithetic=False)
        t0 = time.perf_counter()
        want = cuda_engine.engine_totals_reference(
            0, cli_levels, params, device=dev, chunk_blocks=512, per_path=True, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        pc, pf, rows = cuda_engine.engine_rows(0, cli_levels, params, device=dev,
                                               per_path=True, **kw)
        got = (*cuda_engine.reduce_rows(pc, pf), rows)
        torch.cuda.synchronize()
        engine_err = max(engine_err, compare_lifecycle(case, want, got, PHILOX_PATHS, engine=True)[0])
        engine_red_err = max(engine_red_err, check_fold(
            "mc_engine_reduce_rows", cuda_engine.reduce_rows_reference(pc, pf), got[:2]))
        if nz is None:
            e_counts, e_plain_ms = want[0].cpu(), plain_s * 1e3
    log(f"  mc_engine_reduce_rows: counts exact, float max abs err {engine_red_err:.3e}")
    log(f"  plain version at {PHILOX_PATHS} paths (no noise, plain on the card): "
        f"{e_plain_ms:.3f} ms")
    log(f"  work per path (first {PHILOX_PATHS} paths): trades "
        f"{float(e_counts[5]) / PHILOX_PATHS:.4f}, escalations "
        f"{float(e_counts[6]) / PHILOX_PATHS:.4f}, skips per path "
        f"{[round(float(x) / PHILOX_PATHS, 4) for x in e_counts[7:23]]}")

    kw = dict(ecommon, sigma=SIGMA, noise=None, antithetic=False, external_uniforms=None)

    def run_engine(n=PHILOX_PATHS):
        return cuda_engine.engine_rows(0, cli_levels, params, device=dev,
                                       **dict(kw, num_paths=n))

    run_engine()
    e_ms = cuda_ms(run_engine, 3)
    e_rows = run_engine()
    e_red_ms = cuda_ms(lambda: cuda_engine.reduce_rows(*e_rows), 20)
    e_red_plain_ms = cuda_ms(lambda: cuda_engine.reduce_rows_reference(*e_rows), 20)
    e_row_bytes = e_rows[0].numel() * 8 + e_rows[1].numel() * 4

    def e_bound(n):
        return card.bound(bytes_=e_row_bytes, **engine_ops(n, e_counts, n / PHILOX_PATHS))

    e_bound_philox = e_bound(PHILOX_PATHS)
    e_red_bound = card.bound(bytes_=e_row_bytes + cuda_engine.ROW_COUNTS * 8
                             + cuda_engine.ROW_FLOATS * 8, f32=0.0, sfu=0.0, imul=0.0)
    log(f"  at {PHILOX_PATHS} paths: kernel {e_ms:.3f} ms "
        f"({PHILOX_PATHS / e_ms * 1e3:.6e} paths/s), bound {e_bound_philox['bound_ms']:.3f} ms "
        f"{e_bound_philox['bound_parts']}, plain {e_plain_ms:.3f} ms")
    log(f"  row fold ({e_rows[0].shape[0]} rows): kernel {e_red_ms:.4f} ms, "
        f"plain {e_red_plain_ms:.4f} ms, bound {e_red_bound['bound_ms']:.4f} ms")

    # ---- phase 11: the engine main path through the CLI
    log(f"[11] main path: cli paths --engine --backend cuda --num-paths {MAIN_PATHS}")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--db", os.path.join(tmp, "smoke.db"), "paths", "--engine",
                "--backend", "cuda", "--num-paths", str(MAIN_PATHS),
                "--num-bars", str(NUM_BARS), "--sigma", str(SIGMA)]
        (e_out,), e_secs, e_launches = run_cli(
            cli, argv, reset_all, {"mc_engine": 4, "mc_engine_reduce_rows": 4})
    check_paths_output(e_out)
    if not e_out["trades"] >= e_out["entered"] > 0 or not e_out["escalations"] > 0:
        raise AssertionError(f"trades < entered, or no escalation: {e_out}")
    sk = e_out["skips"]
    if not (sk.get("TOO_FAR", 0) > 0 and sk.get("CONF_LOW", 0) > 0
            and sk.get("CONTRA_VOL_LONG", 0) + sk.get("CONTRA_VOL_SHORT", 0) > 0):
        raise AssertionError(f"skips lack TOO_FAR, CONF_LOW or a CONTRA_VOL entry: {sk}")
    e_main_ms = cuda_ms(lambda: run_engine(MAIN_PATHS), 2)
    e_main_bound = e_bound(MAIN_PATHS)
    log(f"  kernel alone at {MAIN_PATHS} paths: {e_main_ms:.3f} ms "
        f"({MAIN_PATHS / e_main_ms * 1e3:.6e} paths/s), bound "
        f"{e_main_bound['bound_ms']:.3f} ms {e_main_bound['bound_parts']}")

    # ---- phase 12: first-contact sweep (kernel #3)
    stops5, tps5 = [c[0] for c in CONFIG5], [c[1] for c in CONFIG5]
    # the CLI sweep's default 3 x 3 grid, the main path's rows (config #5's
    # three rows among them)
    grid9 = [(sp, tp) for sp in (0.25, 0.35, 0.45) for tp in (0.15, 0.25, 0.35)]
    stops9, tps9 = [c[0] for c in grid9], [c[1] for c in grid9]
    n_sinj = 16 * LANES
    log(f"[12] first-contact sweep, injected uniforms: kernel vs plain (plain on CPU "
        f"copies), {n_sinj} paths, the CLI's 3 x 3 grid {grid9}")
    rng = np.random.default_rng(300)
    u = torch.from_numpy(rng.uniform(
        1e-9, 1.0, (16, 3 * NUM_BARS + 1, LANES)).astype(np.float32))
    kw = dict(common, num_paths=n_sinj)
    want = cuda_mc.sweep_totals_reference(0, levels, params, stops9, tps9,
                                          external_uniforms=u, **kw)
    got = cuda_mc.reduce_rows(*cuda_mc.sweep_rows(
        0, levels, params, stops9, tps9, device=dev, external_uniforms=u.to(dev), **kw))
    torch.cuda.synchronize()
    sw_err = 0.0
    for g, (sp, tp) in enumerate(grid9):
        sw_err = max(sw_err, compare(f"row {g} ({sp}, {tp})", (want[0][g], want[1][g]),
                                     (got[0][g], got[1][g]), n_sinj))
    log(f"  Philox at {PHILOX_PATHS} paths, the main path's inputs and 9 rows: each row "
        "vs the single configuration's launch (first_contact_rows) bit for bit, vs the plain "
        "version on the card")
    kw = dict(common, num_paths=PHILOX_PATHS, external_uniforms=None)
    sw_rows = cuda_mc.sweep_rows(0, cli_levels, params, stops9, tps9, device=dev, **kw)
    got = cuda_mc.reduce_rows(*sw_rows)
    want = cuda_mc.sweep_totals_reference(0, cli_levels, params, stops9, tps9,
                                          device=dev, **kw)
    for g, (sp, tp) in enumerate(grid9):
        one_rows = cuda_mc.first_contact_rows(
            0, cli_levels, params.replace(stop_padding=sp, tp_padding=tp), device=dev,
            noise=None, antithetic=False, **kw)
        one = cuda_mc.reduce_rows(*one_rows)
        if not (torch.equal(one_rows[0], sw_rows[0][g]) and torch.equal(one_rows[1], sw_rows[1][g])
                and torch.equal(one[0], got[0][g]) and torch.equal(one[1], got[1][g])):
            raise AssertionError(f"sweep row {g} differs from the single configuration")
        sw_err = max(sw_err, compare(f"philox row {g}", (want[0][g], want[1][g]),
                                     (got[0][g], got[1][g]), PHILOX_PATHS))
    log("  every row equals the single configuration bit for bit (partial rows and totals)")
    sw_red_err = check_fold("mc_sweep_reduce_rows", cuda_mc.reduce_rows_reference(*sw_rows), got)
    log(f"  mc_sweep_reduce_rows: counts exact, float max abs err {sw_red_err:.3e}")

    kw = dict(common, num_paths=PLAIN_PATHS, external_uniforms=None)

    def run_sw(n=PLAIN_PATHS, rows=CONFIG5):
        return cuda_mc.sweep_rows(0, cli_levels, params, [r[0] for r in rows],
                                  [r[1] for r in rows], device=dev, **dict(kw, num_paths=n))

    run_sw()
    sw_ms = cuda_ms(run_sw, 3)
    sw_rows = run_sw()
    sw_plain_ms = cuda_ms(lambda: cuda_mc.sweep_totals_reference(
        0, cli_levels, params, stops5, tps5, device=dev, **kw), 1)
    sw_red_ms = cuda_ms(lambda: cuda_mc.reduce_rows(*sw_rows), 20)
    sw_red_plain_ms = cuda_ms(lambda: cuda_mc.reduce_rows_reference(*sw_rows), 20)
    sc, _, swork = cuda_mc.sweep_totals_reference(
        0, cli_levels, params, stops5, tps5, device=dev, work=True,
        **dict(kw, num_paths=PHILOX_PATHS))
    sw_row_bytes = sw_rows[0].numel() * 8 + sw_rows[1].numel() * 4

    def sw_bound(n):
        return card.bound(bytes_=sw_row_bytes, **sweep_ops(swork.cpu(), int(sc[0, 1]), 3,
                                                            n / PHILOX_PATHS))

    sw_bound_plain = sw_bound(PLAIN_PATHS)
    sw_red_bound = card.bound(bytes_=sw_row_bytes + 3 * (cuda_mc.ROW_COUNTS * 8
                                                         + cuda_mc.ROW_FLOATS * 8),
                              f32=0.0, sfu=0.0, imul=0.0)
    log(f"  at {PLAIN_PATHS} paths x 3 rows: kernel {sw_ms:.3f} ms "
        f"({PLAIN_PATHS / sw_ms * 1e3:.6e} paths/s), bound {sw_bound_plain['bound_ms']:.3f} ms "
        f"{sw_bound_plain['bound_parts']}, plain {sw_plain_ms:.3f} ms")
    log(f"  work per path (first {PHILOX_PATHS} paths): pairs, walked, after contact, "
        f"rows x bars after contact {[round(float(x) / PHILOX_PATHS, 4) for x in swork.cpu()]}")
    log(f"  row fold (3 x {sw_rows[0].shape[1]} rows): kernel {sw_red_ms:.4f} ms, plain "
        f"{sw_red_plain_ms:.4f} ms, bound {sw_red_bound['bound_ms']:.4f} ms")
    c5_ms = cuda_ms(lambda: run_sw(CONFIG5_PATHS), 2)
    c5_bound = sw_bound(CONFIG5_PATHS)
    log(f"  BASELINE config #5 at full size ({CONFIG5_PATHS} paths x {NUM_BARS} bars x 3 "
        f"rows), kernel alone: {c5_ms:.3f} ms ({CONFIG5_PATHS / c5_ms * 1e3:.6e} paths/s), "
        f"bound {c5_bound['bound_ms']:.3f} ms {c5_bound['bound_parts']}")
    log(f"[12] main path: cli sweep --backend cuda --num-paths {MAIN_PATHS} (3 x 3 grid)")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--db", os.path.join(tmp, "smoke.db"), "sweep", "--backend", "cuda",
                "--num-paths", str(MAIN_PATHS), "--num-bars", str(NUM_BARS),
                "--sigma", str(SIGMA)]
        sw_out, sw_secs, sw_launches = run_cli(
            cli, argv, reset_all, {"mc_sweep": 4, "mc_sweep_reduce_rows": 4})
    check_sweep_output(sw_out, grid9, ["stop_padding", "tp_padding", "hit_rate", "mean_r"])
    sw_main_ms = cuda_ms(lambda: run_sw(MAIN_PATHS, grid9), 2)
    log(f"  kernel alone on the CLI's grid ({MAIN_PATHS} paths x 9 rows): {sw_main_ms:.3f} ms")

    # ---- phase 13: gated sweep (kernel #6)
    g_stops, g_tps = [0.35, 0.35, 0.25], [0.25, 0.25, 0.15]
    g_gate = GateConfig.from_params(params).replace(touch_limit=[4, 4, 2],
                                                    cooldown_bars=[0, 0, 3])
    g_noise = McNoise(entry_slip_std=torch.tensor([0.0, 0.01, 0.0]),
                      level_jitter_std=torch.tensor([0.0, 0.02, 0.0]),
                      stop_slip_std=torch.tensor([0.0, 0.015, 0.0]),
                      target_slip_std=torch.tensor([0.0, 0.015, 0.0]))
    n_ginj = SWEEP_INJECT_BLOCKS * 8 * GATED_LANES
    log(f"[13] gated sweep, injected uniforms: kernel vs plain (plain on CPU copies), "
        f"{n_ginj} paths x 3 rows (defaults; a noise-std row; touch limit 2 with "
        "cooldown 3)")
    rng = np.random.default_rng(400)
    u = torch.from_numpy(rng.uniform(
        1e-9, 1.0, (SWEEP_INJECT_BLOCKS, GatedLayout(NUM_BARS, True).u_rows, 8,
                    GATED_LANES)).astype(np.float32))
    kw = dict(gcommon, num_paths=n_ginj, noise=g_noise)
    want = cuda_gated.gated_sweep_totals_reference(0, levels, params, g_stops, g_tps, g_gate,
                                                   external_uniforms=u, per_path=True, **kw)
    pc, pf, rows = cuda_gated.gated_sweep_rows(0, levels, params, g_stops, g_tps, g_gate,
                                               device=dev, external_uniforms=u.to(dev),
                                               per_path=True, **kw)
    gc, gf = cuda_gated.reduce_rows(pc, pf)
    torch.cuda.synchronize()
    gs_err = 0.0
    for g in range(3):
        err, _ = compare_lifecycle(
            f"row {g}", (want[0][g], want[1][g], want[2][g]), (gc[g], gf[g], rows[g]), n_ginj,
            trace=lambda d: trace_flips(
                f"row {g}", u, d, rows[g].cpu(), want[2][g].cpu(), levels,
                params.replace(stop_padding=g_stops[g], tp_padding=g_tps[g]),
                grid_row(g_gate, g), grid_row(g_noise, g), False, dev))
        gs_err = max(gs_err, err)
    log(f"  Philox at {PHILOX_PATHS} paths, the main path's inputs: each row vs the "
        "one-row launch (gated_rows) bit for bit, vs the plain version on the card path "
        "by path")
    ps_gate = GateConfig.from_params(params).replace(touch_limit=[2, 4, 4],
                                                     cooldown_bars=[0, 0, 3])
    kw = dict(gcommon, num_paths=PHILOX_PATHS, noise=None)
    t0 = time.perf_counter()
    want = cuda_gated.gated_sweep_totals_reference(
        0, cli_levels, params, stops5, tps5, ps_gate, device=dev, chunk_blocks=64,
        per_path=True, work=True, **kw)
    torch.cuda.synchronize()
    gs_plain_ms = (time.perf_counter() - t0) * 1e3
    gs_rows = cuda_gated.gated_sweep_rows(0, cli_levels, params, stops5, tps5, ps_gate,
                                          device=dev, external_uniforms=None,
                                          per_path=True, **kw)
    gc, gf = cuda_gated.reduce_rows(*gs_rows[:2])
    for g in range(3):
        one = cuda_gated.gated_rows(0, cli_levels, params.replace(
            stop_padding=stops5[g], tp_padding=tps5[g]), grid_row(ps_gate, g), device=dev,
            external_uniforms=None, antithetic=False, per_path=True, **kw)
        if not all(torch.equal(a, b[g]) for a, b in zip(one, gs_rows)):
            raise AssertionError(f"gated sweep row {g} differs from the one-row launch")
        err, differ = compare_lifecycle(f"philox row {g}", (want[0][g], want[1][g], want[2][g]),
                                        (gc[g], gf[g], gs_rows[2][g]), PHILOX_PATHS)
        gs_err = max(gs_err, err)
        if bool(differ.any()):
            raise AssertionError(f"philox row {g}: the kernel and the plain version on "
                                 "the card differ")
    log("  every row equals the one-row launch bit for bit (partial rows, per-path rows); "
        "the plain version on the card equals the kernel on every path")
    gs_red_err = check_fold("mc_gated_sweep_reduce_rows",
                            cuda_gated.reduce_rows_reference(*gs_rows[:2]), (gc, gf))
    log(f"  mc_gated_sweep_reduce_rows: counts exact, float max abs err {gs_red_err:.3e}")
    # repair: the lifecycle histogram's scalar division on the card
    eq, tr = gs_rows[2][0][:, 0], gs_rows[2][0][:, 1]
    stats_on = {}
    for where in (dev, torch.device("cpu")):
        e, t = eq.to(where), tr.to(where)
        z = torch.zeros_like(e)
        stats_on[where.type] = (
            PathStats.from_lifecycle(equity=e, trades=t, wins=t, losses=z,
                                     open_at_end=z.bool(), max_dd=z).hist.cpu(),
            PathStats.from_outcomes(e, torch.ones_like(t, dtype=torch.int32),
                                    t > 0).hist.cpu())
    if not all(torch.equal(a, b) for a, b in zip(stats_on["cuda"], stats_on["cpu"])):
        raise AssertionError("from_lifecycle / from_outcomes bins differ between the card "
                             "and the CPU")
    lo, span = LIFE_HIST_LO, LIFE_HIST_HI - LIFE_HIST_LO
    moved = int((((eq - lo) / span * 128).int() != ((eq.cpu() - lo) / span * 128).int()
                 .to(dev)).sum())
    log(f"  from_lifecycle / from_outcomes bins of {eq.numel()} equities: card == CPU; "
        f"a division by the CPU scalar on the card would move {moved} of them")

    kw = dict(gcommon, num_paths=PHILOX_PATHS, noise=None, external_uniforms=None)

    def run_gs(n=PHILOX_PATHS, stops=stops5, tps=tps5, gate=ps_gate):
        return cuda_gated.gated_sweep_rows(0, cli_levels, params, stops, tps, gate,
                                           device=dev, **dict(kw, num_paths=n))

    run_gs()
    gs_ms = cuda_ms(run_gs, 3)
    g_sw_rows = run_gs()
    gs_red_ms = cuda_ms(lambda: cuda_gated.reduce_rows(*g_sw_rows), 20)
    gs_red_plain_ms = cuda_ms(lambda: cuda_gated.reduce_rows_reference(*g_sw_rows), 20)
    gs_row_bytes = g_sw_rows[0].numel() * 8 + g_sw_rows[1].numel() * 4
    gs_held, gs_trades = [float(x) for x in want[3]], [float(x) for x in want[0][:, 5]]
    gs_bound = card.bound(bytes_=gs_row_bytes,
                          **gated_sweep_ops(PHILOX_PATHS, gs_held, gs_trades))
    gs_red_bound = card.bound(bytes_=gs_row_bytes + 3 * (cuda_gated.ROW_COUNTS * 8
                                                         + cuda_gated.ROW_FLOATS * 8),
                              f32=0.0, sfu=0.0, imul=0.0)
    log(f"  at {PHILOX_PATHS} paths x 3 rows: kernel {gs_ms:.3f} ms, bound "
        f"{gs_bound['bound_ms']:.3f} ms {gs_bound['bound_parts']}, plain {gs_plain_ms:.3f} ms")
    log(f"  work per path and row: trades {[round(x / PHILOX_PATHS, 4) for x in gs_trades]}, "
        f"bars held {[round(x / PHILOX_PATHS, 4) for x in gs_held]}")
    log(f"  row fold (3 x {g_sw_rows[0].shape[1]} rows): kernel {gs_red_ms:.4f} ms, plain "
        f"{gs_red_plain_ms:.4f} ms, bound {gs_red_bound['bound_ms']:.4f} ms")
    gs_cli_paths = 1 << 26
    log(f"[13] main path: cli sweep --gated --backend cuda --num-paths {gs_cli_paths} "
        "--touch-limits 2 4 (18 rows)")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--db", os.path.join(tmp, "smoke.db"), "sweep", "--gated", "--backend",
                "cuda", "--num-paths", str(gs_cli_paths), "--num-bars", str(NUM_BARS),
                "--sigma", str(SIGMA), "--touch-limits", "2", "4"]
        gs_out, gs_secs, gs_launches = run_cli(
            cli, argv, reset_all, {"mc_gated_sweep": 4, "mc_gated_sweep_reduce_rows": 4},
            n_paths=gs_cli_paths)
    check_sweep_output(gs_out, [(sp, tp, tl) for sp, tp in grid9 for tl in (2, 4)],
                       ["stop_padding", "tp_padding", "hit_rate", "mean_r", "touch_limit",
                        "mean_trades", "mean_dd"])
    gate18 = GateConfig.from_params(params).replace(touch_limit=[tl for _ in grid9
                                                                 for tl in (2, 4)])
    gs_main_ms = cuda_ms(lambda: run_gs(gs_cli_paths, [r[0] for r in grid9 for _ in (2, 4)],
                                        [r[1] for r in grid9 for _ in (2, 4)], gate18), 1)
    log(f"  kernel alone on the CLI's grid ({gs_cli_paths} paths x 18 rows): "
        f"{gs_main_ms:.3f} ms")

    # ---- phase 14: engine sweep (kernel #9)
    e_cfgs = [EngineParams.default(),
              EngineParams.default(stop_padding=0.20, tp_padding=0.40),
              EngineParams.default(q_min_prob=0.40, enable_veto=False),
              EngineParams.default(overtouch_limit=2, cooldown_s=180.0)]
    e_grid = stack_params(e_cfgs)
    n_einj = SWEEP_INJECT_BLOCKS * 8 * ENGINE_LANES
    log(f"[14] engine sweep, injected uniforms: kernel vs plain (plain on CPU copies), "
        f"{n_einj} paths x the 4 configurations of tests/test_pallas_engine.py:320-325")
    rng = np.random.default_rng(500)
    u = torch.from_numpy(rng.uniform(
        1e-6, 1.0, (SWEEP_INJECT_BLOCKS, EngineLayout(NUM_BARS).u_rows, 8,
                    ENGINE_LANES)).astype(np.float32))
    kw = dict(ecommon, sigma=SIGMA, num_paths=n_einj)
    want = cuda_engine.engine_sweep_totals_reference(0, e_levels, e_grid, external_uniforms=u,
                                                     per_path=True, **kw)
    pc, pf, rows = cuda_engine.engine_sweep_rows(0, e_levels, e_grid, device=dev,
                                                 external_uniforms=u.to(dev),
                                                 per_path=True, **kw)
    ec, ef = cuda_engine.reduce_rows(pc, pf)
    torch.cuda.synchronize()
    es_err = 0.0
    for g in range(4):
        err, _ = compare_lifecycle(
            f"row {g}", (want[0][g], want[1][g], want[2][g]), (ec[g], ef[g], rows[g]), n_einj,
            engine=True,
            trace=lambda d: trace_engine_flips(f"row {g}", u, d, rows[g].cpu(),
                                               want[2][g].cpu(), e_levels, e_cfgs[g], {}, SIGMA,
                                               None, False, dev))
        es_err = max(es_err, err)
    # [G] noise stds: the main path's rows (`--jitter-stds 0 0.02`) and a slip row
    e_noise = McNoise(level_jitter_std=torch.tensor([0.0, 0.02, 0.02]),
                      entry_slip_std=torch.tensor([0.0, 0.0, 0.01]),
                      stop_slip_std=torch.tensor([0.0, 0.0, 0.015]),
                      target_slip_std=torch.tensor([0.0, 0.0, 0.015]))
    log(f"  injected uniforms with [G] noise stds, {n_einj} paths x 3 rows (level "
        "jitter 0 and 0.02, as `--jitter-stds 0 0.02`; jitter 0.02 with slips)")
    u = torch.from_numpy(rng.uniform(
        1e-6, 1.0, (SWEEP_INJECT_BLOCKS, EngineLayout(NUM_BARS, True).u_rows, 8,
                    ENGINE_LANES)).astype(np.float32))
    kw = dict(ecommon, sigma=SIGMA, num_paths=n_einj, n_grid=3, noise=e_noise)
    want = cuda_engine.engine_sweep_totals_reference(0, e_levels, params, external_uniforms=u,
                                                     per_path=True, **kw)
    pc, pf, rows = cuda_engine.engine_sweep_rows(0, e_levels, params, device=dev,
                                                 external_uniforms=u.to(dev),
                                                 per_path=True, **kw)
    ec, ef = cuda_engine.reduce_rows(pc, pf)
    torch.cuda.synchronize()
    for g in range(3):
        err, _ = compare_lifecycle(
            f"noise row {g}", (want[0][g], want[1][g], want[2][g]), (ec[g], ef[g], rows[g]),
            n_einj, engine=True,
            trace=lambda d: trace_engine_flips(f"noise row {g}", u, d, rows[g].cpu(),
                                               want[2][g].cpu(), e_levels, params, {}, SIGMA,
                                               grid_row(e_noise, g), False, dev))
        es_err = max(es_err, err)
    log(f"  Philox at {PHILOX_PATHS} paths, the main path's inputs: each row vs the "
        "one-row launch (engine_rows) bit for bit (the four configurations, then the "
        "three noise rows)")
    kw = dict(ecommon, sigma=SIGMA, external_uniforms=None)
    for grid, n_grid, nz, singles in (
            (e_grid, None, None, [(c, None) for c in e_cfgs]),
            (params, 3, e_noise, [(params, grid_row(e_noise, g)) for g in range(3)])):
        es_rows = cuda_engine.engine_sweep_rows(0, cli_levels, grid, n_grid=n_grid, noise=nz,
                                                device=dev, per_path=True,
                                                **dict(kw, num_paths=PHILOX_PATHS))
        for g, (p_g, nz_g) in enumerate(singles):
            one = cuda_engine.engine_rows(0, cli_levels, p_g, noise=nz_g, device=dev,
                                          per_path=True, **dict(kw, num_paths=PHILOX_PATHS))
            if not all(torch.equal(a, b[g]) for a, b in zip(one, es_rows)):
                raise AssertionError(f"engine sweep row {g} (noise {nz_g}) differs from "
                                     "the one-row launch")
    log("  every row equals the one-row launch bit for bit (partial rows, per-path rows "
        "with their skip counts)")
    es_paths = 1 << 20
    log(f"  kernel vs plain, both on the card, path by path at {es_paths} paths x 4 rows, "
        "then x the 3 noise rows")
    t0 = time.perf_counter()
    want = cuda_engine.engine_sweep_totals_reference(
        0, cli_levels, e_grid, device=dev, chunk_blocks=512, per_path=True,
        **dict(kw, num_paths=es_paths))
    torch.cuda.synchronize()
    es_plain_ms = (time.perf_counter() - t0) * 1e3
    pc, pf, rows = cuda_engine.engine_sweep_rows(0, cli_levels, e_grid, device=dev,
                                                 per_path=True, **dict(kw, num_paths=es_paths))
    ec, ef = cuda_engine.reduce_rows(pc, pf)
    nkw = dict(kw, num_paths=es_paths, n_grid=3, noise=e_noise)
    n_want = cuda_engine.engine_sweep_totals_reference(
        0, cli_levels, params, device=dev, chunk_blocks=512, per_path=True, **nkw)
    n_pc, n_pf, n_rows = cuda_engine.engine_sweep_rows(0, cli_levels, params, device=dev,
                                                       per_path=True, **nkw)
    n_ec, n_ef = cuda_engine.reduce_rows(n_pc, n_pf)
    for name, w, got in (("card row", want, (ec, ef, rows)),
                         ("card noise row", n_want, (n_ec, n_ef, n_rows))):
        for g in range(w[0].shape[0]):
            err, differ = compare_lifecycle(f"{name} {g}", (w[0][g], w[1][g], w[2][g]),
                                            (got[0][g], got[1][g], got[2][g]), es_paths,
                                            engine=True)
            es_err = max(es_err, err)
            if bool(differ.any()):
                raise AssertionError(f"{name} {g}: the kernel and the plain version on the "
                                     "card differ")
    es_red_err = check_fold("mc_engine_sweep_reduce_rows",
                            cuda_engine.reduce_rows_reference(pc, pf), (ec, ef))
    log(f"  mc_engine_sweep_reduce_rows: counts exact, float max abs err {es_red_err:.3e}")
    es_counts = want[0].cpu()

    def run_es(n=es_paths, grid=e_grid, noise=None):
        return cuda_engine.engine_sweep_rows(0, cli_levels, grid, device=dev, noise=noise,
                                             **dict(kw, num_paths=n))

    run_es()
    es_ms = cuda_ms(run_es, 3)
    e_sw_rows = run_es()
    es_red_ms = cuda_ms(lambda: cuda_engine.reduce_rows(*e_sw_rows), 20)
    es_red_plain_ms = cuda_ms(lambda: cuda_engine.reduce_rows_reference(*e_sw_rows), 20)
    es_row_bytes = e_sw_rows[0].numel() * 8 + e_sw_rows[1].numel() * 4
    es_bound = card.bound(bytes_=es_row_bytes, **engine_sweep_ops(es_paths, es_counts, 1.0))
    es_red_bound = card.bound(bytes_=es_row_bytes + 4 * (cuda_engine.ROW_COUNTS * 8
                                                         + cuda_engine.ROW_FLOATS * 8),
                              f32=0.0, sfu=0.0, imul=0.0)
    log(f"  at {es_paths} paths x 4 rows: kernel {es_ms:.3f} ms, bound "
        f"{es_bound['bound_ms']:.3f} ms {es_bound['bound_parts']}, plain {es_plain_ms:.3f} ms")
    log(f"  row fold (4 x {e_sw_rows[0].shape[1]} rows): kernel {es_red_ms:.4f} ms, plain "
        f"{es_red_plain_ms:.4f} ms, bound {es_red_bound['bound_ms']:.4f} ms")
    es_cli_paths = 1 << 24
    log(f"[14] main path: cli sweep --engine --backend cuda --num-paths {es_cli_paths} "
        "--jitter-stds 0 0.02 (18 rows)")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--db", os.path.join(tmp, "smoke.db"), "sweep", "--engine", "--backend",
                "cuda", "--num-paths", str(es_cli_paths), "--num-bars", str(NUM_BARS),
                "--sigma", str(SIGMA), "--jitter-stds", "0", "0.02"]
        es_out, es_secs, es_launches = run_cli(
            cli, argv, reset_all, {"mc_engine_sweep": 4, "mc_engine_sweep_reduce_rows": 4},
            n_paths=es_cli_paths)
    check_sweep_output(es_out, [(sp, tp, j) for sp, tp in grid9 for j in (0.0, 0.02)],
                       ["stop_padding", "tp_padding", "hit_rate", "mean_r", "mean_trades",
                        "mean_dd", "escalations", "level_jitter_std"])
    if not all(o["escalations"] > 0 for o in es_out):
        raise AssertionError("a row of the engine sweep took no escalation")
    jit18 = torch.tensor([j for _ in grid9 for j in (0.0, 0.02)])
    grid18_e = params.replace(stop_padding=[r[0] for r in grid9 for _ in (0, 1)],
                              tp_padding=[r[1] for r in grid9 for _ in (0, 1)])
    noise18 = McNoise(level_jitter_std=jit18, entry_slip_std=torch.zeros(18),
                      stop_slip_std=torch.zeros(18), target_slip_std=torch.zeros(18))
    es_cli_ms = cuda_ms(lambda: run_es(es_cli_paths, grid18_e, noise18), 1)
    log(f"  kernel alone on the CLI's grid ({es_cli_paths} paths x 18 rows, with noise): "
        f"{es_cli_ms:.3f} ms")
    grid9_e = params.replace(stop_padding=[r[0] for r in grid9], tp_padding=[r[1] for r in grid9])
    es9_counts = cuda_engine.engine_sweep_totals_reference(
        0, cli_levels, grid9_e, device=dev, chunk_blocks=512,
        **dict(kw, num_paths=1 << 18))[0].cpu()
    es_big = 1 << 26
    es_main_ms = cuda_ms(lambda: run_es(es_big, grid9_e), 1)
    es_main_bound = card.bound(bytes_=es_row_bytes,
                               **engine_sweep_ops(es_big, es9_counts, es_big / (1 << 18)))
    log(f"  kernel alone at {es_big} paths x 9 rows: {es_main_ms:.3f} ms "
        f"({es_big * 9 / es_main_ms * 1e3:.6e} paths x rows/s), bound "
        f"{es_main_bound['bound_ms']:.3f} ms {es_main_bound['bound_parts']}")

    universe = universe_phases(dev, card, reset_all)
    books = book_phases(dev, card, reset_all, cli)

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
        entry("mc_engine", ENGINE_SOURCE, ENGINE_REPLACES, e_launches["mc_engine"],
              engine_err, e_ms, e_plain_ms, e_bound_philox, paths=PHILOX_PATHS,
              main_path_ms=e_main_ms, main_path_bound_ms=e_main_bound["bound_ms"],
              cli_s=e_secs[1:]),
        entry("mc_engine_reduce_rows", ENGINE_SOURCE, ENGINE_REPLACES,
              e_launches["mc_engine_reduce_rows"], engine_red_err, e_red_ms,
              e_red_plain_ms, e_red_bound, rows=int(e_rows[0].shape[0])),
        entry("mc_sweep", FC_SOURCE, SWEEP_REPLACES, sw_launches["mc_sweep"], sw_err, sw_ms,
              sw_plain_ms, sw_bound_plain, paths=PLAIN_PATHS, grid_rows=3,
              config5_ms=c5_ms, config5_bound_ms=c5_bound["bound_ms"],
              cli_kernel_ms=sw_main_ms, cli_s=sw_secs[1:]),
        entry("mc_sweep_reduce_rows", FC_SOURCE, SWEEP_REPLACES,
              sw_launches["mc_sweep_reduce_rows"], sw_red_err, sw_red_ms, sw_red_plain_ms,
              sw_red_bound, rows=int(sw_rows[0].shape[1]), grid_rows=3),
        entry("mc_gated_sweep", GATED_SOURCE, GATED_SWEEP_REPLACES,
              gs_launches["mc_gated_sweep"], gs_err, gs_ms, gs_plain_ms, gs_bound,
              paths=PHILOX_PATHS, grid_rows=3, cli_kernel_ms=gs_main_ms, cli_s=gs_secs[1:]),
        entry("mc_gated_sweep_reduce_rows", GATED_SOURCE, GATED_SWEEP_REPLACES,
              gs_launches["mc_gated_sweep_reduce_rows"], gs_red_err, gs_red_ms,
              gs_red_plain_ms, gs_red_bound, rows=int(g_sw_rows[0].shape[1]), grid_rows=3),
        entry("mc_engine_sweep", ENGINE_SOURCE, ENGINE_SWEEP_REPLACES,
              es_launches["mc_engine_sweep"], es_err, es_ms, es_plain_ms, es_bound,
              paths=es_paths, grid_rows=4, main_path_ms=es_main_ms,
              main_path_bound_ms=es_main_bound["bound_ms"], cli_kernel_ms=es_cli_ms,
              cli_s=es_secs[1:]),
        entry("mc_engine_sweep_reduce_rows", ENGINE_SOURCE, ENGINE_SWEEP_REPLACES,
              es_launches["mc_engine_sweep_reduce_rows"], es_red_err, es_red_ms,
              es_red_plain_ms, es_red_bound, rows=int(e_sw_rows[0].shape[1]), grid_rows=4),
    ] + universe + books}))
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
