"""The redesigned engine sweep (kernel #9 and its samplers,
``ops/csrc/mc_engine_bar_sweep.cu``): each path's bars made once into a bar
store and every grid row replayed over them.

On the CPU: the launch's shared memory, scratch and store, from the
kernel's own ``#define``s, fit an SM at its ``__launch_bounds__`` at every
level count and row count it takes, and the store with the scratch stays
within ``BAR_SWEEP_STORE_MIB`` at every horizon; every launch of
``cuda_engine.engine_sweep_rows`` (gbm and the samplers, at the parents'
shape and at the envelope's) goes to ``mc_engine_bar_sweep_kernel``
(``bar_sweep_plan``, the one dispatch); and the plain sweep still matches
the JAX sweep kernel in interpret mode (JAX imported inside that test
alone, so the file runs on the card's machine without it).  Marked ``cuda``
(skipped without a card): each of 18 rows with [G] noise stds equals its
one-row launch (``engine_rows``) bit for bit, partial rows and per-path rows
with their skip counts, under gbm and the three samplers at W = 40, 61, 62
and 390 and 1, 3, 30 and 64 levels; with several paths a thread and past
``BAR_SWEEP_ROWS`` rows; past the store's budget (fewer CTAs than the card
holds, up to ``MAX_BARS``); the library's plan of a launch is the
sources' model; the kernels' static shared memory within the host's count."""

import ctypes
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine
from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import BLOCK, SamplerArgs, grid_row
from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import universe_tables
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

from .test_torch_sampler_rows_kernel import histories

torch.set_num_threads(2)

SAMPLERS = ("gbm", "bootstrap", "block_bootstrap", "heston")
LEVEL_COUNTS = (1, 3, 30, 64)
HORIZONS = (40, 61, 62, 390)
SIGMA = 0.3
DT = 1.0 / (390.0 * 252.0)
LANES = cuda_engine.ENGINE_LANES
SM_SHARED = 228 * 1024          # an H100 SM's shared memory
CTA_SHARED = 227 * 1024         # a CTA's, at most
CTA_RESERVED = 1024             # the runtime's reserve a CTA
SMS = 132
CSRC = Path(cuda_engine.__file__).parent / "csrc"
TABLE = universe_tables(histories(5, 1, 500))[0]


def _defines(source: str) -> dict:
    """The integer ``#define``s of a kernel source."""
    text = (CSRC / source).read_text()
    return {k: int(v) for k, v in re.findall(r"^#define (\w+) (\d+)\b", text, re.M)}


SWEEP = _defines("mc_engine_bar_sweep.cu")
ENV = _defines("mc_engine_env.cuh")
ENGINE = _defines("mc_engine.cuh")
NC = ENGINE["N_COUNTS"] + ENGINE["N_SKIPS"]
# the kernel's static shared memory: two EngineArgs (the bars' and the
# replayed row's), the SamplerArgs, the gbm rows' warp sums, and
# env_add_path_row's counts, histogram and warp sums, with 16 bytes for
# their alignment (at most what the compiler lays out)
STATIC = (2 * ctypes.sizeof(cuda_engine._EngineArgs) + ctypes.sizeof(SamplerArgs)
          + 4 * 6 * BLOCK // 32 + 4 * NC + 4 * ENGINE["HIST_BINS"] + 4 * 6 * BLOCK // 32 + 16)


def _model(sampler: str, levels: int, num_bars: int, n_rows: int) -> tuple:
    """The launch at a shape, from the sources' constants: (rows a pass,
    dynamic shared memory, scratch slots a thread, the store's planes).
    The library's plan (``qmmx_engine_bar_sweep_plan``) is held to it on the
    card."""
    gbm = sampler == "gbm"
    rows = min(n_rows, SWEEP["BAR_SWEEP_ROWS"]) if gbm else n_rows
    words = -(-levels // 32) + -(-2 * levels // 32)
    rings = ENGINE["VOL_RING"] + ENGINE["CLOSE_RING"]
    smem = (16 * levels + ENV["ENV_THREADS"] * (4 * (rings + words) + 2 * levels)
            + (rows * (8 * NC + 4 * ENGINE["HIST_BINS"]) if gbm else 0))
    windowed = num_bars > 61
    slots = (4 * levels + (2 * 61 if windowed else 0)
             + (SWEEP["BAR_SWEEP_ACC"] * rows if gbm else 0))
    return rows, smem, slots, SWEEP["BAR_SWEEP_PLANES"] + (2 if windowed else 0)


def _ctas(sampler: str, levels: int, num_bars: int, n_rows: int, vgrid: int) -> int:
    """The physical CTAs of a launch, from the sources' constants: the
    ``__launch_bounds__`` CTAs an SM on 132 SMs, at most ``vgrid``, and no
    more than keep the store and the scratch within the budget."""
    _, _, slots, planes = _model(sampler, levels, num_bars, n_rows)
    blocks = SWEEP["BAR_SWEEP_WIN_MIN_BLOCKS" if num_bars > 61 else "BAR_SWEEP_MIN_BLOCKS"]
    return min(SMS * blocks, vgrid, BUDGET // (4 * BLOCK * (planes * num_bars + slots)))


BUDGET = SWEEP["BAR_SWEEP_STORE_MIB"] << 20


def test_bar_sweep_host_constants_are_the_kernels():
    """The kernel's constants the host relies on: the store's four planes
    (close, high, low, volume), gbm's accumulators a row's floats, the CTA
    size; and the host keeps no copy of the launch's sizes (the library's
    plan gives them)."""
    assert SWEEP["BAR_SWEEP_PLANES"] == 4
    assert SWEEP["BAR_SWEEP_ACC"] == cuda_engine.ROW_FLOATS
    assert ENV["ENV_THREADS"] == cuda_engine.ENV_THREADS == BLOCK
    assert not any(hasattr(cuda_engine, k) for k in (
        "BAR_SWEEP_PLANES", "BAR_SWEEP_ROWS", "BAR_SWEEP_ACC"))
    assert [f.name for f in dataclasses.fields(cuda_engine.BarSweepPlan)] == [
        "kernel", "counter", "kind", "windowed"]


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_bar_sweep_shared_memory_scratch_and_store_fit(sampler):
    """At every level count 1-64, 1-100 rows and W either side of the
    guard's window: a CTA's static and dynamic shared memory (the sources'
    model) fit 227 KB; the ``__launch_bounds__`` CTAs an SM
    fit an SM's 228 KB at the main paths' shapes with the CLI's 18 rows:
    ``BAR_SWEEP_MIN_BLOCKS`` (4) without the windowed guard up to the parents'
    8 levels, ``BAR_SWEEP_WIN_MIN_BLOCKS`` (3) with it up to 30 levels (the
    samplers at every level count; past these fewer CTAs share an SM).  gbm
    replays at most BAR_SWEEP_ROWS rows over one making of the bars (18
    rows: once).  The store of the resident CTAs at the bounds: 86 MB at W =
    40 (over the 50 MB L2), 949 MB at 390 (the guard's box two planes more)."""
    blocks = {40: SWEEP["BAR_SWEEP_MIN_BLOCKS"], 390: SWEEP["BAR_SWEEP_WIN_MIN_BLOCKS"]}
    most = {40: 8, 390: 30 if sampler == "gbm" else 64}
    for levels in range(1, 65):
        for n_rows in (1, 18, 32, 33, 100):
            for w in (40, 390):
                rows, smem, slots, planes = _model(sampler, levels, w, n_rows)
                assert rows == (min(n_rows, 32) if sampler == "gbm" else n_rows)
                assert planes == (6 if w > 61 else 4)
                assert STATIC + smem <= CTA_SHARED
                if levels <= most[w] and n_rows <= 18:
                    assert blocks[w] * (STATIC + smem + CTA_RESERVED) <= SM_SHARED, (
                        levels, n_rows, w)
    assert _model(sampler, 3, 40, 18)[0] == 18
    for w, mb in ((40, 87), (390, 949)):
        store = SMS * blocks[w] * _model(sampler, 3, w, 18)[3] * w * BLOCK * 4
        assert mb - 1 < store / 1e6 <= mb, w
        assert _ctas(sampler, 3, w, 18, 4096) == SMS * blocks[w]


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_bar_sweep_store_within_its_budget_at_every_horizon(sampler):
    """The store grows with W (6 planes a bar past 61 bars): the card's
    resident CTAs would want 949 MB at W = 390 and ~87 GB at ``MAX_BARS``, so
    the CTAs are capped to keep the store and the scratch within
    ``BAR_SWEEP_STORE_MIB``: the cap binds from W ~ 3500 (at 3 levels and 18
    rows), never at the main paths' 40 and 390 bars, and one CTA fits at
    every horizon up to ``MAX_BARS`` at 64 levels and 100 rows."""
    assert BUDGET == 8 << 30
    for levels in (1, 3, 30, 64):
        for n_rows in (1, 18, 100):
            for w in (2, 40, 61, 62, 390, 3000, 4000, 20000, cuda_engine.MAX_BARS):
                ctas = _ctas(sampler, levels, w, n_rows, 4096)
                _, _, slots, planes = _model(sampler, levels, w, n_rows)
                assert ctas >= 1, (levels, n_rows, w)
                assert ctas * 4 * BLOCK * (planes * w + slots) <= BUDGET, (levels, n_rows, w)
    full = [w for w in range(62, cuda_engine.MAX_BARS + 1, 50)
            if _ctas(sampler, 3, w, 18, 4096) == SMS * SWEEP["BAR_SWEEP_WIN_MIN_BLOCKS"]]
    assert 3400 < full[-1] < 3600
    assert SMS * 3 * 6 * cuda_engine.MAX_BARS * BLOCK * 4 > 85e9
    assert _ctas(sampler, 3, cuda_engine.MAX_BARS, 18, 4096) == 39


def _ladder(n: int) -> Levels:
    """An n-level ladder around 100 (four colours x solid / dashed, 0.12
    apart); one level at 100.0."""
    return Levels.from_rows(
        [{"color": ("blue", "orange", "black", "teal")[i % 4],
          "type": "solid" if (i // 4) % 2 == 0 else "dashed", "index": i // 8,
          "price": round(100.0 + (i - n // 2) * 0.12, 2)} for i in range(n)],
        max_levels=max(n, 1))


def _grid18():
    """18 rows: 3 x 3 (stop, tp) x level jitter 0 / 0.02 (the CLI's
    ``--jitter-stds 0 0.02``), the jittered rows with slips too."""
    params = EngineParams.default()
    cells = [(sp, tp, j) for sp in (0.25, 0.35, 0.45) for tp in (0.15, 0.25, 0.35)
             for j in (0.0, 0.02)]
    grid = params.replace(stop_padding=[c[0] for c in cells], tp_padding=[c[1] for c in cells])
    jit = torch.tensor([c[2] for c in cells])
    slip = jit / 2
    return grid, McNoise(level_jitter_std=jit, entry_slip_std=slip, stop_slip_std=slip,
                         target_slip_std=slip)


def _skw(sampler: str) -> dict:
    if sampler == "gbm":
        return {}
    if sampler == "heston":
        return dict(sampler=sampler)
    return dict(sampler=sampler, tables=TABLE, block_len=5)


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_every_engine_sweep_launch_goes_to_the_bar_sweep(sampler, monkeypatch):
    """``engine_sweep_rows`` at the parents' shape (<= 8 levels, an even W
    <= 61) and at the envelope's (more levels, an odd W, W > 61), and with the
    checks' hook that forces the envelope: one launch of
    ``mc_engine_bar_sweep_kernel`` through ``bar_sweep_plan``, never the
    one-row kernels' launches (``_launch``, ``_sampler_launch``)."""
    calls = []

    def bar_sweep(args, levels, samp, num_bars, **kw):
        calls.append(cuda_engine.bar_sweep_plan(samp.kind, levels.max_levels, num_bars,
                                                len(args)))
        return "launched"

    def refuse(*a, **k):
        raise AssertionError("a sweep went to a one-row kernel's launch")

    monkeypatch.setattr(cuda_engine, "_bar_sweep_launch", bar_sweep)
    monkeypatch.setattr(cuda_engine, "_launch", refuse)
    monkeypatch.setattr(cuda_engine, "_sampler_launch", refuse)
    grid, noise = _grid18()
    counter = "mc_engine_bar_sweep" + ("" if sampler == "gbm" else "_sampler")
    shapes = [(3, 40, False), (8, 61, False), (1, 40, False), (30, 40, False),
              (3, 41, False), (3, 62, False), (64, 390, False), (3, 40, True)]
    for n_lv, w, force in shapes:
        monkeypatch.setattr(cuda_engine, "_FORCE_ENVELOPE", force)
        out = cuda_engine.engine_sweep_rows(0, _ladder(n_lv), grid, noise=noise,
                                            num_paths=8 * LANES, num_bars=w, sigma=SIGMA,
                                            device="cuda", **_skw(sampler))
        assert out == "launched"
        plan = calls[-1]
        assert (plan.kernel, plan.counter, plan.windowed) == (
            "mc_engine_bar_sweep_kernel", counter, w > 61), (n_lv, w)
        assert cuda_engine.needs_envelope(n_lv, w) == (n_lv > 8 or w % 2 == 1 or w > 61)
    assert len(calls) == len(shapes)
    assert counter in cuda_engine.LAUNCHES
    assert not any(k in cuda_engine.LAUNCHES for k in (
        "mc_engine_sweep", "mc_engine_sweep_sampler", "mc_engine_wide_sweep",
        "mc_engine_wide_sweep_sampler"))


def test_plain_engine_sweep_matches_the_jax_kernel_interpret():
    """#9 under the bootstrap sampler (the block bootstrap is
    ``tests/test_torch_sampler_rows_engine_sweep_interpret.py``'s): two rows
    of engine knobs on one history's recorded bars, the plain version against
    the JAX kernel in interpret mode on the same injected uniforms, within
    that file's tolerance."""
    from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
    from qmmx_monolithic_monte_carlo_tpu.ops import pallas_engine as jPE
    from qmmx_monolithic_monte_carlo_tpu.types import Levels as JLevels
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout

    from .test_torch_sampler_rows_interpret import (ROWS, STOPS, TPS, _assert_engine,
                                                    _jax_history, _kw, _uniforms)

    sampler, w, lanes = "bootstrap", 8, 128
    jhist, jtables = _jax_history(False)
    u = _uniforms(77, (1, EngineLayout(w, False, sampler).u_rows, 8, lanes))
    j = jPE.mc_paths_pallas_engine_sweep(
        0, JLevels.from_rows(ROWS, max_levels=8),
        JParams.default().replace(stop_padding=np.float32(STOPS), tp_padding=np.float32(TPS)),
        num_paths=8 * lanes, num_bars=w, sigma=0.3, lanes=lanes, hist_bars=jhist,
        interpret=True, external_uniforms=u, **_kw(sampler))
    t = cuda_engine.mc_paths_engine_sweep_fused(
        0, Levels.from_rows(ROWS, max_levels=8),
        EngineParams.default().replace(stop_padding=STOPS, tp_padding=TPS),
        num_paths=8 * lanes, num_bars=w, sigma=0.3, lanes=lanes, tables=jtables,
        external_uniforms=torch.from_numpy(u), **_kw(sampler))
    for g in range(2):
        _assert_engine(t, j, 8 * lanes, g)


# ---------------------------------------------------------------- the card

_BUILT = []


def _cuda():
    """The card, with the sweep's and the one-row kernels' libraries built
    at once (one nvcc a source, in parallel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    if not _BUILT:
        from qmmx_monolithic_monte_carlo_tpu_torch.utils import build

        build.build_all(["mc_engine", "mc_engine_samplers", "mc_engine_wide",
                         "mc_engine_wide_samplers", cuda_engine.BAR_SWEEP_SOURCE])
        _BUILT.append(True)
    return torch.device("cuda")


def _rows_equal_one_row_launches(sampler, levels, grid, noise, n_rows, **kw):
    """One sweep launch of ``n_rows`` rows (counted once under its counter),
    each row's partial rows and per-path rows equal to ``engine_rows`` at the
    row's knobs and noise stds."""
    plan = cuda_engine.bar_sweep_plan(sampler, levels.max_levels, kw["num_bars"], n_rows)
    before = cuda_engine.LAUNCHES[plan.counter]
    got = cuda_engine.engine_sweep_rows(0, levels, grid, noise=noise, per_path=True, **kw,
                                        **_skw(sampler))
    torch.cuda.synchronize()
    assert cuda_engine.LAUNCHES[plan.counter] == before + 1
    assert [tuple(x.shape[:1]) for x in got] == [(n_rows,)] * 3
    for g in range(n_rows):
        one = cuda_engine.engine_rows(0, levels, grid_row(grid, g), noise=grid_row(noise, g),
                                      per_path=True, **kw, **_skw(sampler))
        for name, a, b in zip(("partial counts", "partial floats", "per-path rows"), one, got):
            assert torch.equal(a, b[g]), (sampler, levels.max_levels, kw["num_bars"], g, name)


@pytest.mark.cuda
@pytest.mark.parametrize("num_bars", HORIZONS)
@pytest.mark.parametrize("n_levels", LEVEL_COUNTS)
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_cuda_bar_sweep_rows_equal_one_row_launches(sampler, n_levels, num_bars):
    """18 rows with [G] noise stds on Philox: each row equal to its one-row
    launch bit for bit (the parents at 1-3 levels and W = 40, the envelope
    kernels elsewhere)."""
    dev = _cuda()
    grid, noise = _grid18()
    _rows_equal_one_row_launches(sampler, _ladder(n_levels), grid, noise, 18,
                                 num_paths=2 * 8 * LANES, num_bars=num_bars, sigma=SIGMA,
                                 dt=DT, lanes=LANES, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_cuda_bar_sweep_many_paths_a_thread_and_more_rows_than_a_pass(sampler):
    """Past 2^20 paths the one-row grid is capped (4096 CTAs), so a thread
    walks several paths and the last ones are ragged (2^20 + 2^13 paths):
    gbm's sums in path order, the samplers' chunks; then 40 rows, past
    BAR_SWEEP_ROWS (gbm makes the bars twice): each row equal to its one-row
    launch."""
    dev = _cuda()
    grid, noise = _grid18()
    kw = dict(num_bars=40, sigma=SIGMA, dt=DT, lanes=LANES, device=dev)
    _rows_equal_one_row_launches(sampler, _ladder(3), grid, noise, 18,
                                 num_paths=(1 << 20) + (1 << 13), **kw)
    params = EngineParams.default()
    sp = torch.linspace(0.15, 0.55, 40)
    jit = torch.linspace(0.0, 0.04, 40)
    grid40 = params.replace(stop_padding=sp, tp_padding=torch.flip(sp, (0,)))
    noise40 = McNoise(level_jitter_std=jit, entry_slip_std=jit / 2, stop_slip_std=jit / 2,
                      target_slip_std=jit / 2)
    _rows_equal_one_row_launches(sampler, _ladder(30), grid40, noise40, 40,
                                 num_paths=2 * 8 * LANES, **dict(kw, num_bars=62))


@pytest.mark.cuda
@pytest.mark.parametrize("sampler,num_bars", [("gbm", 4000), ("bootstrap", 4000),
                                              ("gbm", cuda_engine.MAX_BARS)])
def test_cuda_bar_sweep_rows_past_the_store_budget(sampler, num_bars):
    """Past the store's budget the launch runs fewer CTAs than the card
    holds (each takes more virtual CTAs in turn): at W = 4000 and at
    ``MAX_BARS``, 2^17 paths (512 virtual CTAs), two rows each equal to its
    one-row launch bit for bit."""
    dev = _cuda()
    grid, noise = _grid18()
    grid2, noise2 = grid_row(grid, slice(0, 4, 3)), grid_row(noise, slice(0, 4, 3))
    launch = cuda_engine.bar_sweep_launch_plan(
        cuda_engine.bar_sweep_plan(sampler, 3, num_bars, 2).kind, 3, num_bars, 2, 512)
    assert launch["ctas"] == _ctas(sampler, 3, num_bars, 2, 512) < 396
    _rows_equal_one_row_launches(sampler, _ladder(3), grid2, noise2, 2, num_paths=1 << 17,
                                 num_bars=num_bars, sigma=SIGMA, dt=DT, lanes=LANES, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ("gbm", "bootstrap", "heston"))
def test_cuda_bar_sweep_plan_is_the_sources_model(sampler):
    """The library's plan of a launch (``qmmx_engine_bar_sweep_plan``, which
    sizes the store and the scratch) against the sources' model at 1-64
    levels, 1-100 rows and W from 2 to ``MAX_BARS``: the rows a pass, the
    dynamic shared memory, the scratch and the store, and the CTAs."""
    _cuda()
    kind = cuda_engine.bar_sweep_plan(sampler, 1, 40, 1).kind
    for levels in (1, 3, 8, 30, 64):
        for n_rows in (1, 18, 33, 100):
            for w in (2, 40, 61, 62, 390, 4000, cuda_engine.MAX_BARS):
                for vgrid in (1, 4096):
                    got = cuda_engine.bar_sweep_launch_plan(kind, levels, w, n_rows, vgrid)
                    rows, smem, slots, planes = _model(sampler, levels, w, n_rows)
                    ctas = got["ctas"]
                    assert (got["rows_per_pass"], got["smem_bytes"], got["scratch_floats"],
                            got["store_floats"]) == (
                        rows, smem, ctas * slots * BLOCK, ctas * planes * w * BLOCK), (
                        levels, n_rows, w)
                    assert 1 <= ctas <= _ctas(sampler, levels, w, n_rows, vgrid)
                    # where the CPU fit test puts the __launch_bounds__ CTAs on an SM
                    if n_rows <= 18 and (levels <= 8 or w > 61 and levels <= 30):
                        assert ctas == _ctas(sampler, levels, w, n_rows, vgrid), (
                            levels, n_rows, w, vgrid)


@pytest.mark.cuda
def test_cuda_bar_sweep_static_shared_memory_within_the_host_count():
    """The six kernels' runtime static shared memory at most the host's
    count, so the fits above hold on the card."""
    _cuda()
    got = cuda_engine._bar_sweep_library().qmmx_engine_bar_sweep_size(3)
    assert 0 < got <= STATIC
