"""Port sim/pathsim held against JAX: path_replay on the same bars, tie
uniforms and noise normals; PathStats; the streamed mc_paths statistically."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
from qmmx_monolithic_monte_carlo_tpu.ops.pathgen import PathBars as JPathBars
from qmmx_monolithic_monte_carlo_tpu.sim import pathsim as jPS
from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise as JMcNoise
from qmmx_monolithic_monte_carlo_tpu.types import Levels as JLevels
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import PathBars
from qmmx_monolithic_monte_carlo_tpu_torch.sim import pathsim as PS
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

torch.set_num_threads(2)

ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "orange", "type": "dashed", "index": 0, "price": 100.4},
        {"color": "teal", "type": "solid", "index": 0, "price": 99.7}]
STDS = dict(level_jitter_std=0.02, entry_slip_std=0.01, stop_slip_std=0.015,
            target_slip_std=0.02)


def _bars(seed, p=2048, w=30):
    rng = np.random.default_rng(seed)
    logc = np.log(100.0) + np.cumsum(rng.normal(0, 0.0012, (p, w)), axis=1)
    close = np.exp(logc).astype(np.float32)
    opens = np.concatenate([np.full((p, 1), 100.0), close[:, :-1]], axis=1)
    hi = (np.maximum(opens, close) + np.abs(rng.normal(0, 0.05, (p, w))))
    lo = (np.minimum(opens, close) - np.abs(rng.normal(0, 0.05, (p, w))))
    arrs = [a.astype(np.float32) for a in (opens, hi, lo, close, np.zeros((p, w)))]
    return arrs, rng.uniform(size=p).astype(np.float32), \
        rng.normal(size=(4, p)).astype(np.float32)


@pytest.mark.parametrize("seed,noisy", [(0, False), (1, True), (2, False)])
def test_path_replay_matches_jax(seed, noisy):
    arrs, tie, nn = _bars(seed)
    jl = JLevels.from_rows(ROWS, max_levels=8)
    tl = Levels.from_rows(ROWS, max_levels=8)
    jr, jo, je = jPS.path_replay(
        JPathBars(*map(jnp.asarray, arrs)), jl, JParams.default(),
        jnp.asarray(tie), noise=JMcNoise.make(**STDS) if noisy else None,
        noise_normals=tuple(jnp.asarray(nn)) if noisy else None)
    tr, to, te = PS.path_replay(
        PathBars(*map(torch.from_numpy, arrs)), tl, EngineParams.default(),
        torch.from_numpy(tie), noise=McNoise.make(**STDS) if noisy else None,
        noise_normals=tuple(torch.from_numpy(nn)) if noisy else None)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)
    assert te.any() and not te.all()
    assert len(np.unique(to.numpy()[te.numpy()])) == 3


def _stats_pair(seed):
    rng = np.random.default_rng(seed)
    n = 5000
    outcome = rng.integers(0, 3, n).astype(np.int32)
    r = np.where(outcome == 1, rng.uniform(0.3, 1.8, n),
                 np.where(outcome == 2, -1.0, 0.0)).astype(np.float32)
    entered = rng.uniform(size=n) < 0.9
    return (jPS.PathStats.from_outcomes(r, outcome, entered),
            PS.PathStats.from_outcomes(torch.from_numpy(r), torch.from_numpy(outcome),
                                       torch.from_numpy(entered)))


FIELDS = ("n", "n_tp", "n_stop", "n_open", "n_entered", "sum_r", "sum_r2",
          "min_r", "max_r", "sum_trades", "sum_dd", "max_dd")


def _assert_stats_close(t, j):
    for f in FIELDS:
        assert float(getattr(t, f)) == pytest.approx(float(getattr(j, f)),
                                                     rel=1e-6, abs=1e-6), f
    np.testing.assert_array_equal(t.hist.numpy(), np.asarray(j.hist))
    for prop in ("mean_r", "std_r", "hit_rate", "mean_trades", "mean_dd"):
        assert float(getattr(t, prop)) == pytest.approx(
            float(getattr(j, prop)), rel=1e-6, abs=1e-6), prop


@pytest.mark.parametrize("seed", [0, 1])
def test_pathstats_from_outcomes_merge_tails_match_jax(seed):
    j1, t1 = _stats_pair(seed)
    j2, t2 = _stats_pair(seed + 10)
    _assert_stats_close(t1, j1)
    jm, tm = j1.merge(j2), t1.merge(t2)
    _assert_stats_close(tm, jm)
    _assert_stats_close(PS.PathStats.zero().merge(tm), jPS.PathStats.zero().merge(jm))
    for q in (0.05, 0.5):
        assert float(tm.quantile(q)) == pytest.approx(float(jm.quantile(q)),
                                                      rel=1e-6, abs=1e-6)
    assert float(tm.cvar(0.05)) == pytest.approx(float(jm.cvar(0.05)),
                                                 rel=1e-6, abs=1e-6)


def test_pathstats_merge_refuses_other_ranges():
    a = PS.PathStats.zero()
    b = PS.PathStats.zero(hist_lo=PS.LIFE_HIST_LO, hist_hi=PS.LIFE_HIST_HI)
    with pytest.raises(ValueError):
        a.merge(b)


@pytest.mark.parametrize("antithetic", [False, True])
def test_mc_paths_agrees_with_jax_statistically(antithetic):
    n = 1 << 16
    jl = JLevels.from_rows(ROWS, max_levels=8)
    js = jPS.mc_paths(jax.random.key(0), jl, JParams.default(), num_paths=n,
                      num_bars=40, sigma=0.3, block_paths=1 << 14,
                      antithetic=antithetic)
    ts = PS.mc_paths(0, Levels.from_rows(ROWS, max_levels=8),
                     EngineParams.default(), num_paths=n, num_bars=40,
                     sigma=0.3, block_paths=1 << 14, antithetic=antithetic,
                     device="cpu")
    assert float(ts.n) == n
    assert float(ts.n_tp + ts.n_stop + ts.n_open) == float(ts.n_entered)
    assert float(ts.sum_dd) == float(ts.n_stop)
    ent = float(js.n_entered)
    assert abs(float(ts.n_entered) - ent) <= 4 * np.sqrt(n * 0.01) + 4
    decided = float(js.n_tp + js.n_stop)
    p = float(js.hit_rate)
    se_hit = np.sqrt(2 * p * (1 - p) / decided)
    assert abs(float(ts.hit_rate) - p) <= 4 * se_hit
    se_mean = np.sqrt(2.0 / ent) * float(js.std_r)
    assert abs(float(ts.mean_r) - float(js.mean_r)) <= 4 * se_mean


def test_mc_paths_with_noise_and_unported_samplers():
    tl = Levels.from_rows(ROWS, max_levels=8)
    s = PS.mc_paths(3, tl, EngineParams.default(), num_paths=4096, num_bars=24,
                    sigma=0.3, block_paths=2048, noise=McNoise.make(**STDS),
                    device="cpu")
    assert float(s.n) == 4096 and float(s.n_entered) > 0
    assert np.isfinite(float(s.cvar(0.05)))
    bars = PS.sample_block(0, 0, block_paths=8, num_bars=4, s0=100.0, mu=0.0,
                           sigma=0.3, dt=1e-5, sampler="heston")
    assert bars.close.shape == (8, 4) and bool(torch.isfinite(bars.close).all())
    with pytest.raises(ValueError, match="unknown sampler"):
        PS.sample_block(0, 0, block_paths=8, num_bars=4, s0=100.0, mu=0.0,
                        sigma=0.3, dt=1e-5, sampler="garch")
    with pytest.raises(ValueError):
        PS.mc_paths(0, tl, EngineParams.default(), num_paths=1000,
                    block_paths=512, device="cpu")
