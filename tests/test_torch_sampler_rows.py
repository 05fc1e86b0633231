"""The sampler rows of the sweeps and universes on the CPU: under bootstrap,
block bootstrap and Heston, every universe symbol of the plain versions
equals the single-configuration plain run at that symbol (its own history
and key) and every sweep row the single run at that row's knobs, bit for
bit; ``parallel/sweep.sweep_paths(_gated)`` under every sampler, row for row
the single pipeline and, statistically, JAX's; and the checks the JAX
universe entries make of their histories.  The CLI's ``sweep --sampler`` is
``tests/test_torch_sampler_rows_cli.py``.
The interpret-mode comparisons with the JAX kernels are
``tests/test_torch_sampler_rows_interpret.py`` and its siblings; the kernels
themselves ``tests/test_torch_sampler_rows_kernel.py``."""

import jax
import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
from qmmx_monolithic_monte_carlo_tpu.ops import pallas_engine as jPE
from qmmx_monolithic_monte_carlo_tpu.ops import pallas_mc as jPM
from qmmx_monolithic_monte_carlo_tpu.ops import pathgen as jPG
from qmmx_monolithic_monte_carlo_tpu.parallel import sweep as jSW
from qmmx_monolithic_monte_carlo_tpu.parallel import universe as jU
from qmmx_monolithic_monte_carlo_tpu.types import Levels as JLevels
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated, cuda_mc
from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row
from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import PathBars, universe_tables
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import sweep as SW
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
from qmmx_monolithic_monte_carlo_tpu_torch.sim import gatedpath as G
from qmmx_monolithic_monte_carlo_tpu_torch.sim import pathsim as PS
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

torch.set_num_threads(2)

SAMPLERS = ("bootstrap", "block_bootstrap", "heston")
FAMILIES = ("first contact", "gated", "engine")
BLOCK_LEN = 5
W = 16
SYM_ROWS = [[{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
             {"color": "teal", "type": "solid", "index": 0, "price": 99.6}],
            [{"color": "green", "type": "solid", "index": 0, "price": 100.2},
             {"color": "orange", "type": "dashed", "index": 0, "price": 100.6}]]
ROWS = SYM_ROWS[0]
S0 = [100.0, 100.2]
SIGMA = [0.3, 0.25]
STOPS, TPS = [0.25, 0.45], [0.35, 0.15]


def _histories(seed: int, n_sym: int, h: int) -> PathBars:
    """[S, H] recorded histories on a cent grid (wicks, positive volumes),
    float32; symbol s's from its own spot."""
    rng = np.random.default_rng(seed)
    c = np.round(np.asarray(S0[:n_sym])[:, None]
                 + np.cumsum(rng.normal(0, 0.08, (n_sym, h)), axis=1), 2)
    o = np.concatenate([c[:, :1], c[:, :-1]], axis=1)
    hi = np.round(np.maximum(o, c) + np.abs(rng.normal(0, 0.05, (n_sym, h))), 2)
    lo = np.round(np.minimum(o, c) - np.abs(rng.normal(0, 0.05, (n_sym, h))), 2)
    v = np.round(rng.lognormal(9.0, 0.5, (n_sym, h)))
    return PathBars(*(torch.from_numpy(x.astype(np.float32)) for x in (o, hi, lo, c, v)))


HIST = _histories(4, 2, 300)
TABLES = universe_tables(HIST)


def _skw(sampler, tables):
    return dict(sampler=sampler, block_len=BLOCK_LEN,
                **({} if sampler == "heston" else {"tables": tables}))


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _noise(n):
    jit = torch.linspace(0.0, 0.03, n)
    return McNoise(level_jitter_std=jit, entry_slip_std=torch.full((n,), 0.01),
                   stop_slip_std=torch.full((n,), 0.015),
                   target_slip_std=torch.full((n,), 0.015))


def test_universe_tables_are_each_symbols_bootstrap_tables():
    """[S, 5, H]: each symbol's ``bootstrap_tables`` (JAX's ``vmap`` of them,
    ``_hist_slab_batched``), to an ulp of JAX's own."""
    jt = jax.vmap(jPG.bootstrap_tables)(*(x.numpy() for x in HIST))
    want = np.stack([np.asarray(t) for t in jt], axis=1)
    got = TABLES.numpy()
    assert got.shape == want.shape == (2, 5, 300)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert int(ulps.max()) <= 1
    np.testing.assert_array_equal(got[:, 4], HIST.volume.numpy())


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_universe_rows_equal_the_single_plain_run(family, sampler):
    """Symbol s of a universe under ``sampler`` (its own history, key, s0,
    sigma, [S] knobs and noise stds; mu 0) equals the single configuration's
    plain run at those inputs, bit for bit."""
    levels = U.stack_levels(SYM_ROWS, max_levels=8)
    params = EngineParams.default().replace(contact_prox=[0.05, 0.08],
                                            stop_padding=[0.35, 0.25])
    noise = None if family == "first contact" else _noise(2)
    lanes = {"first contact": 2048, "gated": 1024, "engine": 256}[family]
    pps = lanes if family == "first contact" else 8 * lanes
    kw = dict(paths_per_symbol=pps, num_bars=W, lanes=lanes, device="cpu")
    if family == "first contact":
        out = cuda_mc.universe_totals_reference(0, levels, params, S0, SIGMA,
                                                **_skw(sampler, TABLES), **kw)
    elif family == "gated":
        out = cuda_gated.gated_universe_totals_reference(0, levels, params, S0, SIGMA, noise=noise,
                                                         per_path=True,
                                                         **_skw(sampler, TABLES), **kw)
    else:
        out = cuda_engine.engine_universe_totals_reference(0, levels, params, S0, SIGMA,
                                                           noise=noise, per_path=True,
                                                           **_skw(sampler, TABLES), **kw)
    for s in range(2):
        one_kw = dict(num_paths=pps, num_bars=W, s0=S0[s], mu=0.0, sigma=SIGMA[s], lanes=lanes,
                      symbol=s, device="cpu", **_skw(sampler, TABLES[s]))
        p_s = grid_row(params, s)
        if family == "first contact":
            one = cuda_mc.fused_totals_reference(0, grid_row(levels, s), p_s, **one_kw)
        elif family == "gated":
            one = cuda_gated.gated_totals_reference(0, grid_row(levels, s), p_s,
                                                    noise=grid_row(noise, s), per_path=True,
                                                    **one_kw)
        else:
            one = cuda_engine.engine_totals_reference(0, grid_row(levels, s), p_s,
                                                      noise=grid_row(noise, s), per_path=True,
                                                      **one_kw)
        _equal(tuple(x[s] for x in out), one)
    assert int(out[0][:, 1].min()) > 0
    # each symbol its own history: the two symbols' draws and bars differ
    assert not torch.equal(out[0][0], out[0][1])


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_sweep_rows_equal_the_single_plain_run(family, sampler):
    """Row g of a sweep under ``sampler`` (one history for every row, the
    caller's mu; [G] noise stds for gated and engine) equals the single
    configuration's plain run at row g's knobs, bit for bit."""
    levels = Levels.from_rows(ROWS, max_levels=8)
    params = EngineParams.default()
    lanes = {"first contact": 8192, "gated": 1024, "engine": 256}[family]
    n = lanes if family == "first contact" else 8 * lanes
    kw = dict(num_paths=n, num_bars=W, s0=100.0, mu=0.02, sigma=0.3, lanes=lanes,
              device="cpu", **_skw(sampler, TABLES[0]))
    noise = None if family == "first contact" else _noise(2)
    grid = params.replace(stop_padding=STOPS, tp_padding=TPS)
    if family == "first contact":
        out = cuda_mc.sweep_totals_reference(0, levels, params, STOPS, TPS, **kw)
    elif family == "gated":
        out = cuda_gated.gated_sweep_totals_reference(0, levels, params, STOPS, TPS, noise=noise,
                                                      per_path=True, **kw)
    else:
        out = cuda_engine.engine_sweep_totals_reference(0, levels, grid, noise=noise,
                                                        per_path=True, **kw)
    for g in range(2):
        if family == "first contact":
            one = cuda_mc.fused_totals_reference(0, levels, grid_row(grid, g), **kw)
        elif family == "gated":
            one = cuda_gated.gated_totals_reference(0, levels, grid_row(grid, g),
                                                    noise=grid_row(noise, g), per_path=True,
                                                    **kw)
        else:
            one = cuda_engine.engine_totals_reference(0, levels, grid_row(grid, g),
                                                      noise=grid_row(noise, g), per_path=True,
                                                      **kw)
        _equal(tuple(x[g] for x in out), one)
    assert not torch.equal(out[0][0], out[0][1])


@pytest.mark.parametrize("family", FAMILIES)
def test_universe_entries_take_hist_bars_or_tables(family):
    """The fused universe entries take [S, H] ``hist_bars`` or their [S, 5,
    H] tables, with the same result."""
    levels = U.stack_levels(SYM_ROWS, max_levels=8)
    lanes = {"first contact": 2048, "gated": 1024, "engine": 256}[family]
    pps = lanes if family == "first contact" else 8 * lanes
    fn = {"first contact": cuda_mc.mc_paths_universe_fused,
          "gated": cuda_gated.mc_paths_gated_universe_fused,
          "engine": cuda_engine.mc_paths_engine_universe_fused}[family]
    kw = dict(paths_per_symbol=pps, num_bars=W, lanes=lanes, device="cpu",
              sampler="block_bootstrap", block_len=BLOCK_LEN)
    a = fn(0, levels, EngineParams.default(), S0, SIGMA, hist_bars=HIST, **kw)
    b = fn(0, levels, EngineParams.default(), S0, SIGMA, tables=TABLES, **kw)
    a, b = (x[0] if isinstance(x, tuple) else x for x in (a, b))
    assert torch.equal(a.hist, b.hist) and torch.equal(a.sum_r, b.sum_r)


def _jax_sweep(gated, sampler, jlevels, jparams, hist, n):
    grid = jSW.grid_params(jparams, stop_paddings=np.float32(STOPS[:1]),
                           tp_paddings=np.float32(TPS))
    kw = dict(num_paths=n, num_bars=W, sigma=0.3, block_paths=n, sampler=sampler,
              hist_bars=hist, block_len=BLOCK_LEN)
    if gated:
        return jSW.sweep_paths_gated(jax.random.key(0), jlevels, grid, **kw)
    return jSW.sweep_paths(jax.random.key(0), jlevels, grid, **kw)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_sweep_paths_under_every_sampler(gated, sampler):
    """``sweep_paths`` / ``sweep_paths_gated`` under ``sampler``: row g
    equals the single pipeline (``mc_paths`` / ``mc_paths_gated``) bit for
    bit, and each row's entry and hit rates agree with JAX's
    ``parallel/sweep`` on the same history within 5 standard errors (the two
    draw their paths from different generators)."""
    n = 1 << 13
    levels = Levels.from_rows(ROWS, max_levels=8)
    grid = SW.grid_params(EngineParams.default(), stop_paddings=STOPS[:1], tp_paddings=TPS)
    hist = PathBars(*(x[0] for x in HIST))
    kw = dict(num_paths=n, num_bars=W, sigma=0.3, block_paths=n // 2, sampler=sampler,
              hist_bars=hist, block_len=BLOCK_LEN, device="cpu")
    run = SW.sweep_paths_gated if gated else SW.sweep_paths
    got = run(5, levels, grid, **kw)
    for g in range(2):
        if gated:
            one = G.mc_paths_gated(5, levels, grid_row(grid, g), G.GateConfig.default(), **kw)
        else:
            one = PS.mc_paths(5, levels, grid_row(grid, g), **kw)
        for f in ("n_entered", "n_tp", "n_stop", "sum_r", "sum_trades"):
            assert torch.equal(getattr(got.row(g), f), getattr(one, f)), (g, f)
    jhist = jPG.PathBars(*(x.numpy() for x in hist))
    want = _jax_sweep(gated, sampler, JLevels.from_rows(ROWS, max_levels=8), JParams.default(),
                      jhist, n)
    for g in range(2):
        for num, den in (("n_entered", "n"), ("n_tp", "n_entered")):
            p1 = float(getattr(got, num)[g]) / float(getattr(got, den)[g])
            p2 = float(np.asarray(getattr(want, num))[g]) / float(np.asarray(getattr(want, den))[g])
            se = np.sqrt(max(p1 * (1 - p1), 1e-4) * 2.0 / float(getattr(got, den)[g]))
            assert abs(p1 - p2) <= 5 * se, (g, num, p1, p2)


def _jax_universe(form, jhist, sampler, block_len=BLOCK_LEN):
    """The JAX universe entry of ``form`` on ``jhist`` (it raises before any
    kernel work on a bad history)."""
    args = (0, jU.stack_levels(SYM_ROWS, max_levels=8), JParams.default(), np.float32(S0),
            np.float32(SIGMA))
    kw = dict(num_bars=8, sampler=sampler, hist_bars=jhist, block_len=block_len, interpret=True)
    if form == "first contact":
        return jPM.mc_paths_pallas_universe(*args, paths_per_symbol=jPM.LANES, **kw)
    if form == "gated":
        return jPM.mc_paths_pallas_gated_universe(*args, paths_per_symbol=jPM.GATED_BLOCK, **kw)
    return jPE.mc_paths_pallas_engine_universe(*args, paths_per_symbol=8 * 128, lanes=128, **kw)


def _port_universe(form, sampler, **kw):
    args = (0, U.stack_levels(SYM_ROWS, max_levels=8), EngineParams.default(), S0, SIGMA)
    fn = {"first contact": cuda_mc.mc_paths_universe_fused,
          "gated": cuda_gated.mc_paths_gated_universe_fused,
          "engine": cuda_engine.mc_paths_engine_universe_fused}[form]
    lanes = {"first contact": 2048, "gated": 1024, "engine": 128}[form]
    pps = lanes if form == "first contact" else 8 * lanes
    return fn(*args, paths_per_symbol=pps, num_bars=8, lanes=lanes, sampler=sampler,
              device="cpu", **kw)


@pytest.mark.parametrize("form", ["first contact", "gated", "engine"])
def test_universe_history_checks_match_jax(form):
    """A 1-D history for a universe and a missing history raise as the JAX
    universe entries raise; a history no longer than the block raises as the
    JAX gated and engine loops do (the first-contact kernel also refuses it
    in the port)."""
    one = jPG.PathBars(*(x[0].numpy() for x in HIST))
    with pytest.raises(ValueError, match=r"\[S, H\]-batched hist_bars"):
        _jax_universe(form, one, "bootstrap")
    with pytest.raises(ValueError, match=r"\[S, H\]-batched hist_bars"):
        _port_universe(form, "bootstrap", hist_bars=PathBars(*(x[0] for x in HIST)))
    with pytest.raises(ValueError, match="requires hist_bars"):
        _jax_universe(form, None, "block_bootstrap")
    with pytest.raises(ValueError, match="requires hist_bars"):
        _port_universe(form, "block_bootstrap")
    short = PathBars(*(x[:, :BLOCK_LEN] for x in HIST))
    if form != "first contact":
        with pytest.raises(ValueError, match="longer than block_len"):
            _jax_universe(form, jPG.PathBars(*(x.numpy() for x in short)), "block_bootstrap")
    with pytest.raises(ValueError, match="longer than block_len"):
        _port_universe(form, "block_bootstrap", hist_bars=short, block_len=BLOCK_LEN)
    with pytest.raises(ValueError, match=r"\[2, 5, H\]"):
        _port_universe(form, "bootstrap", tables=TABLES[:1])
