#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (qmmx_monolithic_monte_carlo_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device — require CUDA; print the nvidia-smi name and power limit; TF32 off;
2. build  — compile the CUDA kernels from ops/csrc/ into build/kernels/;
3. injected uniforms — kernel vs plain PyTorch version on the same uniforms
   (W = 40, lanes 8192, 16 blocks; plain, execution noise, antithetic);
4. Philox — kernel vs plain version on the Philox stream at 2^22 paths, and
   the row-reduction kernel vs its plain version on the kernel's rows;
5. main path — the port CLI's ``paths --backend cuda`` at the benchmark's
   size (2^28 paths x 40 bars, sigma 0.3) with launch counts, the output
   checked, paths/s timed; the plain version timed at 2^24 paths.

Tolerances (phases 3-4): the kernel sums each path's log increments serially
in float32 and uses CUDA's logf/expf/sincosf, the plain version PyTorch's;
their ulps flip O(1) threshold crossings per 1024 paths.  So: n exact;
entered/tp/stop/open within F = 2 + paths/1024; sum_r within F * max|R|;
histogram L1 within 2F; min_r and max_r within 1e-3.

The line before last is a JSON object of the kernels (route, source, the TPU
kernel each replaces, launches in the main-path run, max error, times); the
last line is {"ok": true, "device": {...}}.
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
MAIN_PATHS = 1 << 28
PHILOX_PATHS = 1 << 22
PLAIN_PATHS = 1 << 24
LANES = 8192
REPLACES = "qmmx_monolithic_monte_carlo_tpu/ops/pallas_mc.py:584"
SOURCE = "qmmx_monolithic_monte_carlo_tpu_torch/ops/csrc/mc_first_contact.cu"


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


def compare(name: str, want, got, n_paths: int) -> float:
    """Hold kernel totals ``got`` against plain totals ``want`` (both
    (int64 counts, float64 floats)); returns |delta mean R|."""
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


def main() -> int:
    import torch

    # ---- phase 1: device
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: "
                           "this smoke test needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.host import cli
    from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_mc
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
    from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels
    from qmmx_monolithic_monte_carlo_tpu_torch.utils import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[1] device: torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- phase 2: build
    t0 = time.perf_counter()
    build.build("mc_first_contact")
    info = build.BUILD_LOG["mc_first_contact"]
    log(f"[2] build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info['seconds']:.2f} s) -> {info['path']}")
    for line in info["log"].splitlines():
        if any(k in line for k in ("Compiling entry", "Function properties",
                                   "registers", "spill", "error")):
            log(f"  ptxas: {line.strip()}")

    levels = Levels.from_rows(
        [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
         {"color": "orange", "type": "dashed", "index": 0, "price": 100.4}],
        max_levels=8)
    params = EngineParams.default()
    noise = McNoise.make(entry_slip_std=0.01, level_jitter_std=0.02,
                         stop_slip_std=0.015, target_slip_std=0.015)
    common = dict(num_bars=NUM_BARS, s0=100.0, mu=0.0, sigma=SIGMA,
                  dt=1.0 / (390.0 * 252.0), lanes=LANES)

    # ---- phase 3: injected uniforms
    import numpy as np

    log("[3] injected uniforms: kernel vs plain (plain on CPU copies)")
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

    # ---- phase 4: Philox stream, and the row reduction
    log(f"[4] Philox: kernel vs plain at {PHILOX_PATHS} paths (plain on the card)")
    reduce_err = 0.0
    for case, nz, anti in (("philox", None, False), ("philox+noise", noise, True)):
        kw = dict(common, num_paths=PHILOX_PATHS, noise=nz, antithetic=anti)
        want = cuda_mc.fused_totals_reference(7, levels, params, device=dev, **kw)
        rows = cuda_mc.first_contact_rows(7, levels, params, device=dev,
                                          external_uniforms=None, **kw)
        got = cuda_mc.reduce_rows(*rows)
        torch.cuda.synchronize()
        fc_err = max(fc_err, compare(case, want, got, PHILOX_PATHS))
        plain_c, plain_f = cuda_mc.reduce_rows_reference(*rows)
        if not torch.equal(plain_c, got[0]):
            raise AssertionError("mc_reduce_rows counts differ from the plain fold")
        diff = (got[1].cpu() - plain_f.cpu()).abs()
        reduce_err = max(reduce_err, float(diff.max()))
        # float64 folds of float32 rows in two orders: relative 1e-9 is ample
        if float((diff / plain_f.cpu().abs().clamp(min=1.0)).max()) > 1e-9:
            raise AssertionError(f"mc_reduce_rows floats differ by {diff.tolist()}")
    log(f"  mc_reduce_rows: counts exact, float max abs err {reduce_err:.3e}")

    # kernel and plain times at PLAIN_PATHS (Philox, no noise)
    kw = dict(common, num_paths=PLAIN_PATHS, noise=None, antithetic=False,
              external_uniforms=None)

    def run_kernel():
        return cuda_mc.first_contact_rows(1, levels, params, device=dev, **kw)

    run_kernel()
    fc_ms = cuda_ms(run_kernel, 5)
    main_rows = run_kernel()
    cuda_mc.fused_totals_reference(1, levels, params, device=dev,
                                   **dict(kw, num_paths=LANES * 16))
    plain_ms = cuda_ms(lambda: cuda_mc.fused_totals_reference(
        1, levels, params, device=dev, **kw), 2)
    red_ms = cuda_ms(lambda: cuda_mc.reduce_rows(*main_rows), 20)
    red_plain_ms = cuda_ms(lambda: cuda_mc.reduce_rows_reference(*main_rows), 20)
    log(f"  at {PLAIN_PATHS} paths: kernel {fc_ms:.3f} ms "
        f"({PLAIN_PATHS / fc_ms * 1e3:.6e} paths/s), plain {plain_ms:.3f} ms "
        f"({PLAIN_PATHS / plain_ms * 1e3:.6e} paths/s)")
    log(f"  row reduction ({main_rows[0].shape[0]} rows): kernel {red_ms:.4f} ms, "
        f"plain {red_plain_ms:.4f} ms")

    # ---- phase 5: the main path through the CLI
    log(f"[5] main path: cli paths --backend cuda --num-paths {MAIN_PATHS}")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--db", os.path.join(tmp, "smoke.db"), "paths", "--backend",
                "cuda", "--num-paths", str(MAIN_PATHS), "--num-bars",
                str(NUM_BARS), "--sigma", str(SIGMA)]
        cuda_mc.reset_launches()
        secs = []
        for rep in range(4):                   # one warm-up, three timed
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if rc != 0:
                raise AssertionError(f"cli exited {rc}")
        launches = dict(cuda_mc.LAUNCHES)
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"  cli output: {json.dumps(out)}")
    log(f"  launches in the main-path runs: {launches}")
    for name, n in launches.items():
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
    main_ms = cuda_ms(lambda: cuda_mc.first_contact_rows(
        1, levels, params, device=dev,
        **dict(kw, num_paths=MAIN_PATHS)), 3)
    log(f"  kernel alone at {MAIN_PATHS} paths: {main_ms:.3f} ms "
        f"({MAIN_PATHS / main_ms * 1e3:.6e} paths/s)")

    print(json.dumps({"kernels": [
        {"name": "mc_first_contact", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": launches["mc_first_contact"],
         "max_abs_err": fc_err, "ms": fc_ms, "plain_ms": plain_ms,
         "paths": PLAIN_PATHS, "main_path_ms": main_ms},
        {"name": "mc_reduce_rows", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": launches["mc_reduce_rows"],
         "max_abs_err": reduce_err, "ms": red_ms, "plain_ms": red_plain_ms,
         "rows": int(main_rows[0].shape[0])},
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
