"""The sampler kernels' row axis on the card (marked ``cuda``, skipped without
one): under bootstrap, block bootstrap and Heston, the universe and sweep
launches of ``mc_first_contact_sampler_kernel`` (the sweep's
``mc_first_contact_sampler_sweep_kernel``), ``mc_gated_sampler_kernel``
(the gated sweep's ``mc_gated_sampler_sweep_kernel``) and
``mc_engine_sampler_kernel`` (kernels #2, #3, #5, #6, #9, #10, #11)
against their plain versions on injected uniforms, and every row of a launch
equal, bit for bit, to the one-row launch of its arguments (a universe's
symbol s at its own key and history, a sweep's row g at its knobs).  No JAX
here, so the file runs on the card's machine; the CPU side of this slice is
``tests/test_torch_sampler_rows.py``."""

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated, cuda_mc
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import (EngineLayout, GatedLayout,
                                                             GbmLayout)
from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row
from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import PathBars, universe_tables
from qmmx_monolithic_monte_carlo_tpu_torch.parallel.universe import stack_levels
from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import GateConfig
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

torch.set_num_threads(2)

SAMPLERS = ("bootstrap", "block_bootstrap", "heston")
BLOCK_LEN = 5
W = 40
DT = 1.0 / (390.0 * 252.0)
SYM_ROWS = [[{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
             {"color": "teal", "type": "solid", "index": 0, "price": 99.6}],
            [{"color": "red", "type": "dashed", "index": 0, "price": 100.3}],
            [{"color": "green", "type": "solid", "index": 0, "price": 99.7},
             {"color": "orange", "type": "dashed", "index": 0, "price": 100.4}]]
S0 = [100.0, 100.1, 100.2]
SIGMAS = [0.3, 0.25, 0.35]
STOPS, TPS = [0.25, 0.35, 0.45], [0.15, 0.25, 0.35]
STDS = dict(entry_slip_std=0.01, level_jitter_std=0.02, stop_slip_std=0.015,
            target_slip_std=0.015)


def histories(seed: int, n_sym: int, h: int) -> PathBars:
    """[S, H] recorded histories, one a symbol (wicks, volume bursts), each
    from its own spot (tests/test_engine_bootstrap.py's generator a row)."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(0, 0.12, (n_sym, h)).astype(np.float32)
    c = (np.asarray(S0[:n_sym], np.float32)[:, None]
         + np.cumsum(steps, axis=1, dtype=np.float32))
    o = np.concatenate([c[:, :1], c[:, :-1]], axis=1)
    hi = np.maximum(o, c) + rng.uniform(0, 0.15, (n_sym, h)).astype(np.float32)
    lo = np.minimum(o, c) - rng.uniform(0, 0.15, (n_sym, h)).astype(np.float32)
    v = rng.lognormal(13.0, 0.5, (n_sym, h)).astype(np.float32)
    v = v * (1.0 + 2.0 * (np.abs(steps) > 0.15)).astype(np.float32)
    return PathBars(*(torch.from_numpy(np.ascontiguousarray(x, np.float32))
                      for x in (o, hi, lo, c, v)))


HIST = histories(5, 3, 500)
TABLES = universe_tables(HIST)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _flips(n):
    return 2 + n // 1024


def _uniforms(seed, shape, low=1e-6):
    return torch.from_numpy(np.random.default_rng(seed).uniform(low, 1.0, shape)
                            .astype(np.float32))


def _skw(sampler, universe: bool = False, symbol: int = 0):
    """The sampler's keywords: a universe's [S, 5, H] tables, or symbol
    ``symbol``'s [5, H] table."""
    if sampler == "heston":
        return dict(sampler=sampler)
    return dict(sampler=sampler, block_len=BLOCK_LEN,
                tables=TABLES if universe else TABLES[symbol])


def _differ(got_rows, want_rows, engine: bool) -> int:
    """Paths whose trades differ (counts, or equity/dd beyond 1e-3 a trade)
    or, for the engine, whose first-fail reasons differ."""
    cols = [1, 2, 3, 4] + ([6] if engine else [])
    err = (got_rows[:, [0, 5]] - want_rows[:, [0, 5]]).abs().amax(dim=1)
    differ = ((got_rows[:, cols] != want_rows[:, cols]).any(dim=1)
              | (err > 1e-3 * torch.clamp(want_rows[:, 1], min=1.0)))
    if engine:
        differ |= (got_rows[:, 7:] != want_rows[:, 7:]).any(dim=1)
    return int(differ.sum())


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_cuda_first_contact_sampler_rows(sampler):
    """#2 and #3 under ``sampler``: totals within F of the plain version on
    injected uniforms; each universe symbol and sweep row equal to its
    one-row launch on Philox, bit for bit; the sweep kernel
    (``mc_first_contact_sampler_sweep_kernel``) at 18 rows, two launches, at
    W = 40 and 390."""
    dev = _cuda()
    levels = stack_levels(SYM_ROWS, max_levels=8)
    params = EngineParams.default()
    lanes, pps = 2048, 1 << 15
    n_rows = GbmLayout(W, False, sampler).n_rows
    u = _uniforms(11, (3, pps // lanes, n_rows, lanes), 1e-9)
    kw = dict(paths_per_symbol=pps, num_bars=W, dt=DT, lanes=lanes, **_skw(sampler, True))
    want = cuda_mc.universe_totals_reference(0, levels, params, S0, SIGMAS,
                                             external_uniforms=u, **kw)
    before = cuda_mc.LAUNCHES["mc_universe_sampler"]
    got = cuda_mc.reduce_rows(*cuda_mc.universe_rows(0, levels, params, S0, SIGMAS,
                                                     external_uniforms=u.to(dev), device=dev,
                                                     **kw))
    torch.cuda.synchronize()
    assert cuda_mc.LAUNCHES["mc_universe_sampler"] == before + 1
    f = _flips(pps)
    assert (got[0][:, 0].cpu() == pps).all()
    assert int((got[0][:, 1:5].cpu() - want[0][:, 1:5]).abs().max()) <= f
    rows = cuda_mc.universe_rows(3, levels, params, S0, SIGMAS, external_uniforms=None,
                                 device=dev, **kw)
    for s in range(3):
        one = cuda_mc.first_contact_rows(
            3, grid_row(levels, s), params, num_paths=pps, num_bars=W, s0=S0[s], mu=0.0,
            sigma=SIGMAS[s], dt=DT, lanes=lanes, noise=None, antithetic=False,
            external_uniforms=None, device=dev, symbol=s, **_skw(sampler, symbol=s))
        assert _equal((rows[0][s], rows[1][s]), one), s
    # the sweep: three (stop, tp) rows on one history
    skw = _skw(sampler)
    sw = cuda_mc.sweep_rows(3, grid_row(levels, 0), params, STOPS, TPS, num_paths=pps,
                            num_bars=W, s0=100.0, mu=0.0, sigma=0.3, dt=DT, lanes=8192,
                            external_uniforms=None, device=dev, **skw)
    plain = cuda_mc.sweep_totals_reference(3, grid_row(levels, 0), params, STOPS, TPS,
                                           num_paths=pps, num_bars=W, sigma=0.3, device=dev,
                                           **skw)
    folded = cuda_mc.reduce_rows(*sw)
    assert int((folded[0][:, 1:5] - plain[0][:, 1:5]).abs().max()) <= f
    for g, (sp, tp) in enumerate(zip(STOPS, TPS)):
        one = cuda_mc.first_contact_rows(
            3, grid_row(levels, 0), params.replace(stop_padding=sp, tp_padding=tp),
            num_paths=pps, num_bars=W, s0=100.0, mu=0.0, sigma=0.3, dt=DT, lanes=8192,
            noise=None, antithetic=False, external_uniforms=None, device=dev, **skw)
        assert _equal((sw[0][g], sw[1][g]), one), g
    # 18 rows take two launches of the sweep kernel, each path walked once a
    # launch; at W = 40 and 390 every row equals its one-row launch bit for bit
    stops18 = [sp for sp in (0.15, 0.25, 0.35, 0.45, 0.55, 0.65) for _ in range(3)]
    tps18 = [tp for _ in range(6) for tp in (0.15, 0.25, 0.35)]
    for w in (W, 390):
        before = cuda_mc.LAUNCHES["mc_sweep_sampler"]
        sw = cuda_mc.sweep_rows(5, grid_row(levels, 0), params, stops18, tps18, num_paths=pps,
                                num_bars=w, s0=100.0, mu=0.0, sigma=0.3, dt=DT, lanes=8192,
                                external_uniforms=None, device=dev, **skw)
        torch.cuda.synchronize()
        assert cuda_mc.LAUNCHES["mc_sweep_sampler"] == before + 2
        assert (cuda_mc.reduce_rows(*sw)[0][:, 1] > 0).all()
        for g, (sp, tp) in enumerate(zip(stops18, tps18)):
            one = cuda_mc.first_contact_rows(
                5, grid_row(levels, 0), params.replace(stop_padding=sp, tp_padding=tp),
                num_paths=pps, num_bars=w, s0=100.0, mu=0.0, sigma=0.3, dt=DT, lanes=8192,
                noise=None, antithetic=False, external_uniforms=None, device=dev, **skw)
            assert _equal((sw[0][g], sw[1][g]), one), (w, g)


def _lifecycle_launchers(engine: bool):
    """(the family's module, its one-row launch at seed 0)."""
    if engine:
        return cuda_engine, lambda lv, p, **k: cuda_engine.engine_rows(0, lv, p, **k)
    gate = GateConfig.from_params(EngineParams.default())
    return cuda_gated, lambda lv, p, **k: cuda_gated.gated_rows(0, lv, p, gate, **k)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", [False, True])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_cuda_lifecycle_sampler_universe_rows(engine, sampler):
    """#5 / #10 under ``sampler`` with [S] noise stds: path by path against
    the plain version on injected uniforms within F (the engine: F for
    trades, F for first-fail reasons alone); on Philox each symbol's partial
    and per-path rows equal its one-row launch at its key and history."""
    dev = _cuda()
    mod, single = _lifecycle_launchers(engine)
    levels = stack_levels(SYM_ROWS, max_levels=8)
    params = EngineParams.default()
    lanes = 256 if engine else 1024
    pps = 4 * 8 * lanes
    noise = McNoise.make(**STDS)
    lay = (EngineLayout if engine else GatedLayout)(W, True, sampler)
    u = _uniforms(21 + engine, (3, pps // (8 * lanes), lay.u_rows, 8, lanes))
    kw = dict(paths_per_symbol=pps, num_bars=W, dt=DT, lanes=lanes, noise=noise,
              per_path=True, **_skw(sampler, True))
    if engine:
        ref = lambda **k: mod.engine_universe_totals_reference(0, levels, params, S0, SIGMAS,
                                                               **k)
        launch = lambda **k: mod.engine_universe_rows(0, levels, params, S0, SIGMAS, **k)
        name = "mc_engine_rows_universe_sampler"
    else:
        gate = GateConfig.from_params(params)
        ref = lambda **k: mod.gated_universe_totals_reference(0, levels, params, S0, SIGMAS,
                                                              gate, **k)
        launch = lambda **k: mod.gated_universe_rows(0, levels, params, S0, SIGMAS, gate,
                                                     **k)
        name = "mc_gated_universe_sampler"
    want = ref(external_uniforms=u, **kw)
    before = mod.LAUNCHES[name]
    pc, pf, prow = launch(external_uniforms=u.to(dev), device=dev, **kw)
    torch.cuda.synchronize()
    assert mod.LAUNCHES[name] == before + 1
    f = _flips(pps)
    for s in range(3):
        assert _differ(prow[s].cpu(), want[2][s], engine) <= (2 * f if engine else f), s
    pc, pf, prow = launch(external_uniforms=None, device=dev, **kw)
    for s in range(3):
        one = single(grid_row(levels, s), params, num_paths=pps, num_bars=W, s0=S0[s],
                     mu=0.0, sigma=SIGMAS[s], dt=DT, lanes=lanes, noise=noise,
                     antithetic=False, external_uniforms=None, device=dev, per_path=True,
                     symbol=s, **_skw(sampler, symbol=s))
        assert _equal((pc[s], pf[s], prow[s]), one), s


@pytest.mark.cuda
@pytest.mark.parametrize("engine", [False, True])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_cuda_lifecycle_sampler_sweep_rows(engine, sampler):
    """#6 / #9 under ``sampler`` with [G] noise stds: path by path against
    the plain version on injected uniforms; on Philox each grid row equal to
    the one-row launch under its knobs; for the gated sweep also the CLI's 18
    rows (two touch limits, [G] noise stds) at W 40 and 390 in one launch of
    ``mc_gated_sampler_sweep_kernel``, each row equal to its one-row launch;
    for the engine also #11, each cell of a 3 x 2 sweep of universes equal to
    the one-row launch at its symbol and knobs."""
    dev = _cuda()
    mod, single = _lifecycle_launchers(engine)
    levels = Levels.from_rows(SYM_ROWS[2], max_levels=8)
    params = EngineParams.default()
    lanes = 256 if engine else 1024
    n = 4 * 8 * lanes
    jit = torch.tensor([0.0, 0.02, 0.04])
    noise = McNoise(level_jitter_std=jit, entry_slip_std=torch.full_like(jit, 0.01),
                    stop_slip_std=torch.full_like(jit, 0.015),
                    target_slip_std=torch.full_like(jit, 0.015))
    grid = params.replace(stop_padding=torch.tensor(STOPS), tp_padding=torch.tensor(TPS))
    lay = (EngineLayout if engine else GatedLayout)(W, True, sampler)
    u = _uniforms(31 + engine, (n // (8 * lanes), lay.u_rows, 8, lanes))
    skw = _skw(sampler)
    kw = dict(num_paths=n, num_bars=W, s0=100.0, mu=0.0, sigma=0.3, dt=DT, lanes=lanes,
              noise=noise, per_path=True, **skw)
    if engine:
        ref = lambda **k: mod.engine_sweep_totals_reference(0, levels, grid, **k)
        launch = lambda **k: mod.engine_sweep_rows(0, levels, grid, **k)
        name = "mc_engine_bar_sweep_sampler"
    else:
        ref = lambda **k: mod.gated_sweep_totals_reference(0, levels, params, STOPS, TPS,
                                                           **k)
        launch = lambda **k: mod.gated_sweep_rows(0, levels, params, STOPS, TPS, **k)
        name = "mc_gated_sweep_sampler"
    want = ref(external_uniforms=u, **kw)
    before = mod.LAUNCHES[name]
    pc, pf, prow = launch(external_uniforms=u.to(dev), device=dev, **kw)
    torch.cuda.synchronize()
    assert mod.LAUNCHES[name] == before + 1
    f = _flips(n)
    for g in range(3):
        assert _differ(prow[g].cpu(), want[2][g], engine) <= (2 * f if engine else f), g
    pc, pf, prow = launch(external_uniforms=None, device=dev, **kw)
    for g in range(3):
        one = single(levels, grid_row(grid, g), num_paths=n, num_bars=W, s0=100.0, mu=0.0,
                     sigma=0.3, dt=DT, lanes=lanes, noise=grid_row(noise, g),
                     antithetic=False, external_uniforms=None, device=dev, per_path=True,
                     **skw)
        assert _equal((pc[g], pf[g], prow[g]), one), g
    if not engine:
        # the CLI's 18 rows (3 x 3 (stop, tp) x touch limits 2, 4) with [G]
        # noise stds, one launch of mc_gated_sampler_sweep_kernel for the
        # grid: each row's partial and per-path rows equal the one-row launch
        # (mc_gated_sampler_kernel) under its knobs, at W 40 and 390
        sp18 = [sp for sp in STOPS for _ in range(6)]
        tp18 = [tp for _ in STOPS for tp in TPS for _ in (2, 4)]
        tl18 = [tl for _ in range(9) for tl in (2, 4)]
        jit18 = torch.tensor([0.0, 0.02, 0.04] * 6)
        noise18 = McNoise(level_jitter_std=jit18, entry_slip_std=torch.full_like(jit18, 0.01),
                          stop_slip_std=torch.full_like(jit18, 0.015),
                          target_slip_std=torch.full_like(jit18, 0.015))
        grid18 = params.replace(stop_padding=torch.tensor(sp18), tp_padding=torch.tensor(tp18))
        gate18 = GateConfig.from_params(params).replace(
            touch_limit=torch.tensor(tl18, dtype=torch.int32))
        for w in (W, 390):
            kw18 = dict(kw, num_bars=w, noise=noise18)
            before = mod.LAUNCHES[name]
            pc, pf, prow = mod.gated_sweep_rows(0, levels, params, sp18, tp18, gate18,
                                                external_uniforms=None, device=dev, **kw18)
            assert mod.LAUNCHES[name] == before + 1
            for g in range(18):
                one = mod.gated_rows(0, levels, grid_row(grid18, g), grid_row(gate18, g),
                                     num_paths=n, num_bars=w, s0=100.0, mu=0.0, sigma=0.3,
                                     dt=DT, lanes=lanes, noise=grid_row(noise18, g),
                                     antithetic=False, external_uniforms=None, device=dev,
                                     per_path=True, **skw)
                assert _equal((pc[g], pf[g], prow[g]), one), (w, g)
        return
    slv = stack_levels(SYM_ROWS, max_levels=8)
    sg = params.replace(stop_padding=torch.tensor(STOPS[:2]), tp_padding=torch.tensor(TPS[:2]))
    before = mod.LAUNCHES["mc_engine_rows_universe_sweep_sampler"]
    pc, pf, prow = mod.engine_universe_sweep_rows(
        0, slv, sg, S0, SIGMAS, paths_per_symbol=n, num_bars=W, dt=DT, lanes=lanes,
        device=dev, per_path=True, **_skw(sampler, True))
    assert mod.LAUNCHES["mc_engine_rows_universe_sweep_sampler"] == before + 1
    for s in range(3):
        for g in range(2):
            one = single(grid_row(slv, s), grid_row(sg, g), num_paths=n, num_bars=W,
                         s0=S0[s], mu=0.0, sigma=SIGMAS[s], dt=DT, lanes=lanes, noise=None,
                         antithetic=False, external_uniforms=None, device=dev, per_path=True,
                         symbol=s, **_skw(sampler, symbol=s))
            assert _equal((pc[s, g], pf[s, g], prow[s, g]), one), (s, g)
