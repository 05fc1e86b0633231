"""The port's grid sweeps (parallel/sweep.py) held against the JAX package:
the grids in values, row order and dtypes; one block's G-row replay against
JAX's ``jax.vmap(per_cfg)(grid)`` on the same numpy bars and tie coins, for
the first-contact and the gated lifecycle; the streamed pipelines' identity
with the single-configuration pipelines; ``PathStats.stack``; the histogram
binning at bin edges against numpy's IEEE float32 division; and (``slow``)
the plain sweep versions against the JAX sweep kernels in interpret mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
from qmmx_monolithic_monte_carlo_tpu.ops.pathgen import PathBars as JPathBars
from qmmx_monolithic_monte_carlo_tpu.parallel import sweep as jSW
from qmmx_monolithic_monte_carlo_tpu.sim import gatedpath as jG
from qmmx_monolithic_monte_carlo_tpu.sim import pathsim as jPS
from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise as JMcNoise
from qmmx_monolithic_monte_carlo_tpu.types import Levels as JLevels
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout, GatedLayout
from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_len, grid_row
from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import PathBars
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import sweep as SW
from qmmx_monolithic_monte_carlo_tpu_torch.sim import gatedpath as G
from qmmx_monolithic_monte_carlo_tpu_torch.sim import pathsim as PS
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

torch.set_num_threads(2)

ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "orange", "type": "dashed", "index": 0, "price": 100.4},
        {"color": "teal", "type": "solid", "index": 0, "price": 99.7}]
STATS_FIELDS = ("n", "n_tp", "n_stop", "n_open", "n_entered", "sum_trades")
FLOAT_FIELDS = ("sum_r", "sum_r2", "min_r", "max_r", "sum_dd", "max_dd")


def _leaves(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_records_equal(t, j):
    for k, v in _leaves(t).items():
        jv = np.asarray(getattr(j, k))
        assert v.numpy().dtype == jv.dtype, k
        np.testing.assert_array_equal(v.numpy(), jv, err_msg=k)


def test_grid_params_match_jax():
    stops, tps = [0.25, 0.35, 0.45], [0.15, 0.25]
    _assert_records_equal(SW.grid_params(EngineParams.default(), stop_paddings=stops,
                                         tp_paddings=tps),
                          jSW.grid_params(JParams.default(), stop_paddings=stops,
                                          tp_paddings=tps))


@pytest.mark.parametrize("axes", [dict(touch_limits=[2, 4], q_min_probs=[0.5, 0.6]),
                                  dict(touch_limits=[3]), dict()])
def test_grid_params_gated_match_jax(axes):
    stops, tps = [0.25, 0.35], [0.15, 0.25, 0.35]
    params, gate = EngineParams.default(q_min_prob=0.55), G.GateConfig.default(q_min_prob=0.55)
    jparams, jgate = JParams.default(q_min_prob=0.55), jG.GateConfig.default(q_min_prob=0.55)
    tp_g, tg_g = SW.grid_params_gated(params, gate, stop_paddings=stops, tp_paddings=tps,
                                      **axes)
    jp_g, jg_g = jSW.grid_params_gated(jparams, jgate, stop_paddings=stops,
                                       tp_paddings=tps, **axes)
    _assert_records_equal(tp_g, jp_g)
    _assert_records_equal(tg_g, jg_g)
    assert grid_len(tp_g, tg_g) == len(stops) * len(tps) * len(
        axes.get("touch_limits", [0])) * len(axes.get("q_min_probs", [0]))


def _bars(seed, p=384, w=24):
    """numpy OHLC bars (lognormal closes, open = the previous close, wicks
    around them), a tie coin per path and per (path, bar)."""
    rng = np.random.default_rng(seed)
    logc = np.log(100.0) + np.cumsum(rng.normal(0, 0.0012, (p, w)), axis=1)
    close = np.exp(logc).astype(np.float32)
    opens = np.concatenate([np.full((p, 1), 100.0), close[:, :-1]], axis=1)
    hi = np.maximum(opens, close) + np.abs(rng.normal(0, 0.05, (p, w)))
    lo = np.minimum(opens, close) - np.abs(rng.normal(0, 0.05, (p, w)))
    arrs = [a.astype(np.float32) for a in (opens, hi, lo, close, np.zeros((p, w)))]
    return (arrs, rng.uniform(size=p).astype(np.float32),
            rng.uniform(size=(p, w)).astype(np.float32))


def _assert_stats_match(t, j, exact_floats=False):
    for f in STATS_FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(t.hist.numpy(), np.asarray(j.hist))
    for f in FLOAT_FIELDS:
        # sums in another order: float32 reassociation over a few hundred paths
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                   rtol=0 if exact_floats else 1e-5,
                                   atol=0 if exact_floats else 1e-5, err_msg=f)


def test_replay_grid_matches_jax_vmap():
    """One block's G-row first-contact replay against JAX's
    ``jax.vmap(per_cfg)(grid)`` (parallel/sweep.py:123-127), G = 4."""
    arrs, tie, _ = _bars(0)
    stops, tps = [0.25, 0.45], [0.15, 0.35]
    jgrid = jSW.grid_params(JParams.default(), stop_paddings=stops, tp_paddings=tps)
    jpaths = JPathBars(*map(jnp.asarray, arrs))
    jl = JLevels.from_rows(ROWS, max_levels=8)

    def per_cfg(p):
        return jPS.PathStats.from_outcomes(*jPS.path_replay(jpaths, jl, p, jnp.asarray(tie)))

    want = jax.jit(jax.vmap(per_cfg))(jgrid)
    got = SW.replay_grid(PathBars(*map(torch.from_numpy, arrs)),
                         Levels.from_rows(ROWS, max_levels=8),
                         SW.grid_params(EngineParams.default(), stop_paddings=stops,
                                        tp_paddings=tps), torch.from_numpy(tie))
    assert got.n.shape == (4,)
    _assert_stats_match(got, want)
    assert len(set(got.n_stop.tolist())) == 4          # the rows decide differently


def test_replay_grid_gated_matches_jax_vmap_per_path():
    """One block's G-row gated lifecycle against JAX's vmapped
    ``gated_path_replay`` (parallel/sweep.py:187-195), G = 4 with the touch
    limit and q_min on the grid axis: per path exact in trades, wins, losses
    and open, equity and drawdown to ulps; the PathStats rows too."""
    arrs, _, tie = _bars(1)
    kw = dict(stop_paddings=[0.35], tp_paddings=[0.25], touch_limits=[2, 4],
              q_min_probs=[0.5, 0.65])
    jgrid, jgate_g = jSW.grid_params_gated(JParams.default(), jG.GateConfig.default(), **kw)
    grid, gate_g = SW.grid_params_gated(EngineParams.default(), G.GateConfig.default(), **kw)
    jpaths = JPathBars(*map(jnp.asarray, arrs))
    jl = JLevels.from_rows(ROWS, max_levels=8)
    want = jax.jit(jax.vmap(lambda p, gt: jG.gated_path_replay(
        jpaths, jl, p, gt, jnp.asarray(tie))))(jgrid, jgate_g)
    paths = PathBars(*map(torch.from_numpy, arrs))
    levels = Levels.from_rows(ROWS, max_levels=8)
    for g in range(4):
        got = G.gated_path_replay(paths, levels, grid_row(grid, g),
                                  grid_row(gate_g, g), torch.from_numpy(tie))
        for f in ("trades", "wins", "losses", "open_at_end"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f))[g], err_msg=f)
        for f in ("equity", "max_dd"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f))[g],
                                       rtol=1e-6, atol=1e-6, err_msg=f)
    trades = np.asarray(want.trades).sum(axis=1)
    assert len(set(trades.tolist())) == 4, trades
    jstats = jax.vmap(lambda o: jPS.PathStats.from_lifecycle(
        equity=o.equity, trades=o.trades, wins=o.wins, losses=o.losses,
        open_at_end=o.open_at_end, max_dd=o.max_dd))(want)
    _assert_stats_match(SW.replay_grid_gated(paths, levels, grid, gate_g,
                                             torch.from_numpy(tie)), jstats)


def test_sweep_paths_rows_equal_mc_paths():
    levels = Levels.from_rows(ROWS, max_levels=8)
    grid = SW.grid_params(EngineParams.default(), stop_paddings=[0.25, 0.45],
                          tp_paddings=[0.25])
    kw = dict(num_paths=512, num_bars=16, sigma=0.3, block_paths=256, device="cpu")
    got = SW.sweep_paths(4, levels, grid, **kw)
    for g in range(2):
        one = PS.mc_paths(4, levels, grid_row(grid, g), **kw)
        _assert_stats_match(got.row(g), one, exact_floats=True)


def test_sweep_paths_gated_rows_equal_mc_paths_gated():
    levels = Levels.from_rows(ROWS, max_levels=8)
    grid, gate_g = SW.grid_params_gated(EngineParams.default(), G.GateConfig.default(),
                                        stop_paddings=[0.35], tp_paddings=[0.25, 0.4],
                                        touch_limits=[1, 4])
    kw = dict(num_paths=512, num_bars=16, sigma=0.3, block_paths=256, device="cpu")
    got = SW.sweep_paths_gated(4, levels, grid, gate_g, **kw)
    for g in range(4):
        one = G.mc_paths_gated(4, levels, grid_row(grid, g), grid_row(gate_g, g), **kw)
        _assert_stats_match(got.row(g), one, exact_floats=True)
    assert float(got.sum_trades[0]) == 0.0 < float(got.sum_trades[1])   # touch limit 1
    # every sampler now: a Heston sweep's rows equal the Heston pipeline too
    got = SW.sweep_paths_gated(4, levels, grid, gate_g, sampler="heston", **kw)
    for g in range(4):
        one = G.mc_paths_gated(4, levels, grid_row(grid, g), grid_row(gate_g, g),
                               sampler="heston", **kw)
        _assert_stats_match(got.row(g), one, exact_floats=True)


def test_pathstats_stack_merges_elementwise():
    rng = np.random.default_rng(3)
    parts = []
    for _ in range(3):
        outcome = rng.integers(0, 3, 400).astype(np.int32)
        r = np.where(outcome == 1, rng.uniform(0.3, 1.8, 400),
                     np.where(outcome == 2, -1.0, 0.0)).astype(np.float32)
        entered = rng.uniform(size=400) < 0.9
        parts.append((r, outcome, entered))
    t = [PS.PathStats.from_outcomes(*map(torch.from_numpy, p)) for p in parts]
    j = [jPS.PathStats.from_outcomes(*p) for p in parts]
    st = PS.PathStats.stack(t)
    jst = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *j)
    _assert_stats_match(st, jst)
    both = st.merge(st)
    for g in range(3):
        _assert_stats_match(both.row(g), t[g].merge(t[g]), exact_floats=True)
    for m in ("hit_rate", "mean_r", "mean_trades", "mean_dd", "std_r"):
        np.testing.assert_allclose(getattr(st, m).numpy(), np.asarray(getattr(jst, m)),
                                   rtol=1e-6, err_msg=m)
    assert float(st.row(1).quantile(0.05)) == float(t[1].quantile(0.05))
    with pytest.raises(ValueError, match="row"):
        st.quantile(0.05)
    with pytest.raises(ValueError, match="row"):
        st.cvar(0.05)
    with pytest.raises(ValueError):
        PS.PathStats.stack([t[0], PS.PathStats.zero(PS.LIFE_HIST_LO, PS.LIFE_HIST_HI)])


@pytest.mark.parametrize("lifecycle", [False, True])
def test_histogram_bins_at_edges_match_ieee_division(lifecycle):
    """The bin of x is (x - lo) / (hi - lo) * 128 in float32 with an IEEE
    division (numpy's, and XLA's), on values at and one ulp beside every bin
    edge of the single-trade [-1.5, 2.5] and the lifecycle [-6, 8] ranges."""
    lo, hi = (PS.LIFE_HIST_LO, PS.LIFE_HIST_HI) if lifecycle else (PS.HIST_LO, PS.HIST_HI)
    edges = (np.float32(lo) + np.arange(129, dtype=np.float32)
             * np.float32((hi - lo) / 128)).astype(np.float32)
    x = np.concatenate([edges, np.nextafter(edges, np.float32(-np.inf)),
                        np.nextafter(edges, np.float32(np.inf))]).astype(np.float32)
    want = np.clip(((x - np.float32(lo)) / np.float32(hi - lo) * np.float32(128))
                   .astype(np.int32), 0, 127)
    want_hist = np.bincount(want, minlength=128).astype(np.float32)
    t = torch.from_numpy(x)
    if lifecycle:
        ones = torch.ones_like(t, dtype=torch.int32)
        s = PS.PathStats.from_lifecycle(equity=t, trades=ones, wins=ones, losses=0 * ones,
                                        open_at_end=torch.zeros_like(t, dtype=torch.bool),
                                        max_dd=torch.zeros_like(t))
    else:
        s = PS.PathStats.from_outcomes(t, torch.ones_like(t, dtype=torch.int32),
                                       torch.ones_like(t, dtype=torch.bool))
    np.testing.assert_array_equal(s.hist.numpy(), want_hist)


@pytest.mark.slow
def test_plain_gated_sweep_matches_the_jax_kernel_interpret():
    """The JAX gated sweep kernel in interpret mode and the plain sweep on
    the same injected uniforms: one block of 8 x 1024 paths, W = 16, two
    rows (touch limits 2 and 4); each row within the flip budget."""
    from qmmx_monolithic_monte_carlo_tpu.ops.pallas_mc import mc_paths_pallas_gated_sweep

    w, lanes, n = 16, 1024, 8 * 1024
    u = np.random.default_rng(41).uniform(
        1e-6, 1.0, (1, GatedLayout(w).u_rows, 8, lanes)).astype(np.float32)
    jgate = jG.GateConfig.default().replace(touch_limit=jnp.asarray([2, 4], jnp.int32))
    want = mc_paths_pallas_gated_sweep(
        0, JLevels.from_rows(ROWS, max_levels=8), JParams.default(), [0.35, 0.35],
        [0.25, 0.25], jgate, num_paths=n, num_bars=w, sigma=0.3, interpret=True,
        external_uniforms=u)
    gate = G.GateConfig.default().replace(touch_limit=[2, 4])
    got = cuda_gated.stats_from_gated_totals(*cuda_gated.gated_sweep_totals_reference(
        0, Levels.from_rows(ROWS, max_levels=8), EngineParams.default(), [0.35, 0.35],
        [0.25, 0.25], gate, num_paths=n, num_bars=w, sigma=0.3,
        external_uniforms=torch.from_numpy(u)))
    f = 2 + n // 1024
    for g in range(2):
        assert float(got.n[g]) == float(want.n[g]) == n
        assert abs(float(got.n_entered[g]) - float(want.n_entered[g])) <= f
        assert abs(float(got.sum_trades[g]) - float(want.sum_trades[g])) <= 2 * f
        assert float(np.abs(got.hist[g].numpy() - np.asarray(want.hist[g])).sum()) <= 2 * f
    assert float(got.sum_trades[0]) < float(got.sum_trades[1])


@pytest.mark.slow
def test_plain_engine_sweep_matches_the_jax_kernel_interpret():
    """The JAX engine sweep kernel in interpret mode and the plain sweep on
    the same injected uniforms: one block of 8 x 256 paths, W = 16, two
    noise-std rows (tests/test_pallas_engine.py:427-470); each row within the
    flip budget, skip counters within W x F."""
    from qmmx_monolithic_monte_carlo_tpu.ops.pallas_engine import mc_paths_pallas_engine_sweep

    w, lanes = 16, 256
    n = 8 * lanes
    rows = [dict(ROWS[0]), dict(ROWS[1]), dict(ROWS[2], price=99.6)]
    u = np.random.default_rng(37).uniform(
        1e-6, 1.0, (1, EngineLayout(w, True).u_rows, 8, lanes)).astype(np.float32)
    stds = [(0.0, 0.0, 0.0, 0.0), (0.02, 0.01, 0.015, 0.015)]
    cols = [np.asarray(c, np.float32) for c in zip(*stds)]
    jnoise = JMcNoise(level_jitter_std=jnp.asarray(cols[0]), entry_slip_std=jnp.asarray(cols[1]),
                      stop_slip_std=jnp.asarray(cols[2]), target_slip_std=jnp.asarray(cols[3]))
    want, wskips, wescal = mc_paths_pallas_engine_sweep(
        0, JLevels.from_rows(rows, max_levels=8), JParams.default(), num_paths=n,
        num_bars=w, sigma=0.3, lanes=lanes, noise=jnoise, n_grid=2, interpret=True,
        external_uniforms=u)
    noise = McNoise(level_jitter_std=torch.from_numpy(cols[0]),
                    entry_slip_std=torch.from_numpy(cols[1]),
                    stop_slip_std=torch.from_numpy(cols[2]),
                    target_slip_std=torch.from_numpy(cols[3]))
    got, skips, escal = cuda_engine.stats_from_engine_totals(
        *cuda_engine.engine_sweep_totals_reference(
            0, Levels.from_rows(rows, max_levels=8), EngineParams.default(), n_grid=2,
            noise=noise, num_paths=n, num_bars=w, sigma=0.3, lanes=lanes,
            external_uniforms=torch.from_numpy(u)))
    f = 2 + n // 1024
    for g in range(2):
        assert float(got.n[g]) == float(want.n[g]) == n
        assert abs(float(got.n_entered[g]) - float(want.n_entered[g])) <= f
        assert abs(float(got.sum_trades[g]) - float(want.sum_trades[g])) <= 2 * f
        assert float(np.abs(skips[g].numpy() - np.asarray(wskips[g])).max()) <= w * f
        assert abs(int(escal[g]) - float(wescal[g])) <= f
