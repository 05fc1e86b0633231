"""The engine's envelope on the CPU, the port's counterpart of the JAX
package's ``tests/test_engine_envelope.py``: 30 and 64 levels (and the mask
edges 17 and 33), odd horizons (a final half step), horizons past the
guard's 61-bar window (the windowed guard, W = 62, 63 and a 390-bar trading
day), with and without execution noise, antithetic at an odd W.

On the JAX kernel test's own bars (``tests/test_pallas_engine.
_bars_from_uniforms``) the port's engine replay equals JAX's
``engine_path_replay`` exactly: per path, the skip table, escalations and
histogram.  The plain version of the envelope kernels
(``engine_totals_reference`` on the same injected uniforms) makes its bars
with PyTorch's log/exp/sqrt/cos, which differ from XLA's by ulps; it is held
to the JAX replay within the engine's flip budgets, and equal, path by path,
to the port's replay over its own bars.  The sweep's and universe's plain rows
equal their one-row runs; every engine wrapper refuses 65 level slots and the
book an odd W.  The samplers at the envelope against the JAX kernel in
interpret mode are ``tests/test_torch_engine_envelope_interpret*.py``; the
kernels on the card ``tests/test_torch_engine_envelope_kernel.py``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
from qmmx_monolithic_monte_carlo_tpu.sim import enginepath as jEP
from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise as JMcNoise
from qmmx_monolithic_monte_carlo_tpu.sim.pathsim import PathStats as JPathStats
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine as CE
from qmmx_monolithic_monte_carlo_tpu_torch.ops import pathgen as PG
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout
from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
from qmmx_monolithic_monte_carlo_tpu_torch.sim import enginepath as EP
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.sim.pathsim import PathStats
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

from .test_engine_envelope import _many_levels
from .test_pallas_engine import _bars_from_uniforms

torch.set_num_threads(2)

LANES = 128          # one block of 8 x 128 = 1024 paths (256 lanes for antithetic pairs)
P = 8 * LANES
SIGMA = 0.3
STDS = dict(level_jitter_std=0.02, entry_slip_std=0.01, stop_slip_std=0.015,
            target_slip_std=0.015)
OUT = ("equity", "trades", "wins", "losses", "open_at_end", "max_dd", "escalations")

# name -> (levels, W, ladder step, noise, antithetic, EngineParams overrides)
SHAPES = {
    "30x24": (30, 24, 0.12, False, False, {}),
    "64x16": (64, 16, 0.12, False, False, {}),
    "17x24-noise": (17, 24, 0.12, True, False, {}),
    "33x24": (33, 24, 0.12, False, False, {}),
    "4x62": (4, 62, 0.3, False, False, {}),
    "3x25": (3, 25, 0.3, False, False, {}),
    "6x63-noise": (6, 63, 0.25, True, False, {}),
    "6x63-noise-antithetic": (6, 63, 0.25, True, True, {}),
    "6x390-cooldown300": (6, 390, 0.25, False, False, {"cooldown_s": 300.0}),
}


def _lanes(name) -> int:
    return 2 * LANES if SHAPES[name][4] else LANES


def port_levels(jlevels) -> Levels:
    return Levels.from_numpy({k: np.asarray(v) for k, v in vars(jlevels).items()})


@functools.lru_cache(maxsize=None)
def _case(name):
    """(injected uniforms f32[1, u_rows, 8, LANES], the JAX bars (PathBars,
    tie, noise normals or None) as numpy, JAX's replay outcome) of a shape."""
    n_lv, w, step, noisy, anti, pkw = SHAPES[name]
    u = np.random.default_rng(40 + n_lv + w + noisy + anti).uniform(
        1e-6, 1.0, (1, EngineLayout(w, noisy).u_rows, 8, _lanes(name))).astype(np.float32)
    built = _bars_from_uniforms(u[0], SIGMA, lanes=_lanes(name), w=w, with_noise=noisy,
                                antithetic=anti)
    jkw = dict(noise=JMcNoise.make(**STDS), noise_normals=built[2]) if noisy else {}
    want = jEP.engine_path_replay(built[0], _many_levels(n_lv, step=step),
                                  JParams.default(**pkw), built[1], **jkw)
    bars = PG.PathBars(*(np.asarray(x) for x in built[0]))
    nzs = tuple(np.asarray(x) for x in built[2]) if noisy else None
    return u, (bars, np.asarray(built[1]), nzs), want


def _hist(out):
    return np.asarray(PathStats.from_lifecycle(
        equity=out.equity, trades=out.trades, wins=out.wins, losses=out.losses,
        open_at_end=out.open_at_end, max_dd=out.max_dd).hist)


@pytest.mark.parametrize("name", list(SHAPES))
def test_replay_equals_jax_at_the_envelope(name):
    """The port's engine replay over the JAX bars: per path its trades,
    wins, losses, open position and escalations, the skip table and the
    histogram exactly as JAX's replay (the windowed guard past 61 bars, the
    per-level state of 17-64 levels, the odd W); equity and drawdown within
    1e-3 a trade.  (Under jit XLA turns the trailed stop's cents rounding,
    round(100 x) / 100, into round(100 x) * 0.01; the port divides, as the
    kernels do, so a trade that exits at a trailed stop may part by one price
    ulp in R.)"""
    n_lv, w, step, noisy, _, pkw = SHAPES[name]
    _, (bars, tie, nzs), want = _case(name)
    kw = (dict(noise=McNoise.make(**STDS), noise_normals=tuple(map(torch.from_numpy, nzs)))
          if noisy else {})
    got = EP.engine_path_replay(PG.PathBars(*map(torch.from_numpy, bars)),
                                port_levels(_many_levels(n_lv, step=step)),
                                EngineParams.default(**pkw), torch.from_numpy(tie), **kw)
    for f in ("trades", "wins", "losses", "open_at_end", "escalations"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    trades = np.maximum(np.asarray(want.trades), 1)
    for f in ("equity", "max_dd"):
        assert (np.abs(getattr(got, f).numpy() - np.asarray(getattr(want, f)))
                <= 1e-3 * trades).all(), f
    np.testing.assert_array_equal(got.skip_counts.numpy(),
                                  np.asarray(want.skip_counts).astype(np.int64))
    jhist = np.asarray(JPathStats.from_lifecycle(
        equity=want.equity, trades=want.trades, wins=want.wins, losses=want.losses,
        open_at_end=want.open_at_end, max_dd=want.max_dd).hist)
    np.testing.assert_array_equal(_hist(got), jhist)
    assert int(got.trades.sum()) > 0 and int(got.skip_counts.sum()) > 0


def _rows(out) -> np.ndarray:
    return np.stack([np.asarray(getattr(out, f), np.float32) for f in OUT], 1)


@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_version_matches_jax_at_the_envelope(name):
    """The plain version of the envelope kernels on the injected uniforms:
    counts, escalations and the skip table within the engine's flip budgets
    of the JAX replay (its bars differ from XLA's by ulps: F = 2 + P/1024
    paths whose trades differ, the skip counters within W * F), sum_r within
    the JAX envelope test's tolerance, and per path equal to the port's replay
    over the plain version's own bars (the windowed guard passed through, the
    odd W's half step)."""
    n_lv, w, step, noisy, anti, pkw = SHAPES[name]
    u, (jbars, _, _), want = _case(name)
    levels = port_levels(_many_levels(n_lv, step=step))
    params = EngineParams.default(**pkw)
    noise = McNoise.make(**STDS) if noisy else None
    n_paths = 8 * _lanes(name)
    counts, floats, rows = CE.engine_totals_reference(
        0, levels, params, num_paths=n_paths, num_bars=w, sigma=SIGMA, lanes=_lanes(name),
        noise=noise, antithetic=anti, external_uniforms=torch.from_numpy(u), per_path=True)
    flips = 2 + n_paths // 1024
    wr, gr = _rows(want), rows[:, :7].numpy()
    err = np.abs(gr[:, [0, 5]] - wr[:, [0, 5]]).max(axis=1)
    differ = ((gr[:, [1, 2, 3, 4, 6]] != wr[:, [1, 2, 3, 4, 6]]).any(axis=1)
              | (err > 1e-3 * np.maximum(wr[:, 1], 1.0)))
    assert int(differ.sum()) <= flips
    assert int(counts[0]) == n_paths
    assert abs(int(counts[1]) - int((wr[:, 1] > 0).sum())) <= flips
    assert abs(int(counts[6]) - int(wr[:, 6].sum())) <= flips
    skips = counts[CE.N_COUNTS:CE.N_COUNTS + CE.N_SKIPS].numpy()
    assert int(np.abs(skips - np.asarray(want.skip_counts)).max()) <= w * flips
    tol = 5e-2 if w > 100 else 2e-2
    assert abs(float(floats[0]) - float(np.asarray(want.equity).sum())) <= tol + flips * float(
        np.abs(wr[:, 0]).max())
    # the plain version is the port's replay over its own bars, path by path
    lay = EngineLayout(w, noisy)
    bars, tie, nzs = CE.engine_bars_from_uniforms(torch.from_numpy(u), lay, sigma=SIGMA,
                                                  antithetic=anti)
    np.testing.assert_allclose(bars.close.numpy(), np.asarray(jbars.close), rtol=1e-5)
    own = EP.engine_path_replay(bars, levels, params, tie, noise=noise,
                                noise_normals=None if nzs is None else tuple(nzs))
    np.testing.assert_array_equal(rows[:, :7].numpy(), _rows(own))
    np.testing.assert_array_equal(counts[CE.N_COUNTS:CE.N_COUNTS + CE.N_SKIPS].numpy(),
                                  own.skip_counts.numpy())


def test_sweep_and_universe_plain_rows_equal_their_one_row_runs():
    """30 levels x W = 25 with noise: each row of the sweep's plain version
    ([G] stop paddings and jitter stds) and each symbol of the universe's (its
    own 30-level ladder, spot and volatility) equals the one-row run, per
    path."""
    w, lay = 25, EngineLayout(25, True)
    levels = port_levels(_many_levels(30))
    u = torch.from_numpy(np.random.default_rng(5).uniform(
        1e-6, 1.0, (1, lay.u_rows, 8, LANES)).astype(np.float32))
    noise = McNoise(level_jitter_std=torch.tensor([0.0, 0.02]),
                    entry_slip_std=torch.tensor(0.01), stop_slip_std=torch.tensor(0.015),
                    target_slip_std=torch.tensor(0.015))
    grid = EngineParams.default().replace(stop_padding=[0.25, 0.35])
    kw = dict(num_paths=P, num_bars=w, sigma=SIGMA, lanes=LANES, external_uniforms=u,
              per_path=True)
    c, f, rows = CE.engine_sweep_totals_reference(0, levels, grid, noise=noise, **kw)
    for g in range(2):
        one = CE.engine_totals_reference(0, levels, grid_row(grid, g),
                                         noise=grid_row(noise, g), **kw)
        assert torch.equal(c[g], one[0]) and torch.equal(rows[g], one[2])
    s0, sig = np.array([100.0, 50.0]), np.array([0.3, 0.45])
    lv = U.stack_levels([[{"color": "blue", "type": "solid", "index": 0,
                           "price": float(s0[s]) + (i - 15) * 0.1} for i in range(30)]
                         for s in range(2)], max_levels=30)
    u = torch.from_numpy(np.random.default_rng(6).uniform(
        1e-6, 1.0, (1, EngineLayout(w).u_rows, 8, LANES)).astype(np.float32))
    uu = torch.stack([u, torch.flip(u, dims=[-1])])
    c, f, rows = CE.engine_universe_totals_reference(
        0, lv, EngineParams.default(), s0, sig, paths_per_symbol=P, num_bars=w, lanes=LANES,
        external_uniforms=uu, per_path=True)
    for s in range(2):
        one = CE.engine_totals_reference(0, grid_row(lv, s), EngineParams.default(),
                                         num_paths=P, num_bars=w, s0=float(s0[s]),
                                         sigma=float(sig[s]), lanes=LANES,
                                         external_uniforms=uu[s], per_path=True)
        assert torch.equal(c[s], one[0]) and torch.equal(rows[s], one[2])
        assert int(c[s][5]) > 0


def _refusals():
    lv65 = Levels.from_rows([], max_levels=65)
    lv65_s = U.stack_levels([[], []], max_levels=65)
    p = EngineParams.default()
    one = dict(num_paths=P, num_bars=16, lanes=LANES, device="cpu")
    uni = dict(paths_per_symbol=P, num_bars=16, lanes=LANES, device="cpu")
    s0, sig = [100.0, 50.0], [0.3, 0.3]
    return {
        "mc_paths_engine_fused": lambda: CE.mc_paths_engine_fused(0, lv65, p, **one),
        "engine_totals_reference": lambda: CE.engine_totals_reference(0, lv65, p, **one),
        "engine_rows": lambda: CE.engine_rows(0, lv65, p, **one),
        "mc_paths_engine_sweep_fused": lambda: CE.mc_paths_engine_sweep_fused(
            0, lv65, p, n_grid=1, **one),
        "engine_sweep_rows": lambda: CE.engine_sweep_rows(0, lv65, p, n_grid=1, **one),
        "mc_paths_engine_universe_fused": lambda: CE.mc_paths_engine_universe_fused(
            0, lv65_s, p, s0, sig, **uni),
        "engine_universe_rows": lambda: CE.engine_universe_rows(0, lv65_s, p, s0, sig, **uni),
        "mc_paths_engine_universe_sweep_fused":
            lambda: CE.mc_paths_engine_universe_sweep_fused(0, lv65_s, p, s0, sig, n_grid=1,
                                                            **uni),
        "mc_paths_engine_corr_fused": lambda: CE.mc_paths_engine_corr_fused(
            0, lv65_s, p, s0, sig, [0.5, 0.5], [0.5, 0.5], **uni),
        "engine_corr_rows": lambda: CE.engine_corr_rows(
            0, lv65_s, p, s0, sig, [0.5, 0.5], [0.5, 0.5], **uni),
    }


@pytest.mark.parametrize("entry", list(_refusals()))
def test_every_engine_wrapper_refuses_65_level_slots(entry):
    with pytest.raises(ValueError, match="up to 64 level slots"):
        _refusals()[entry]()


@pytest.mark.parametrize("entry", ["mc_paths_engine_corr_fused", "engine_corr_totals_reference",
                                   "engine_corr_rows"])
def test_the_book_refuses_an_odd_horizon(entry):
    lv = U.stack_levels([[{"color": "blue", "type": "solid", "index": 0, "price": 100.0}]] * 2,
                        max_levels=4)
    with pytest.raises(ValueError, match="even"):
        getattr(CE, entry)(0, lv, EngineParams.default(), [100.0, 50.0], [0.3, 0.3],
                           [0.5, 0.5], [0.5, 0.5], paths_per_symbol=P, num_bars=25,
                           lanes=LANES, device="cpu")


@pytest.mark.parametrize("n", [30, 64])
def test_levels_built_both_ways_agree(n):
    """The ladder built by the port's Levels.from_rows and carried over from
    the JAX package's Levels (``Levels.from_numpy``) are the same tensors."""
    jl = _many_levels(n)
    rows = [{"color": ("blue", "orange", "black", "teal")[i % 4],
             "type": "solid" if (i // 4) % 2 == 0 else "dashed", "index": i // 8,
             "price": 100.0 + (i - n // 2) * 0.12} for i in range(n)]
    a, b = Levels.from_rows(rows, max_levels=n), port_levels(jl)
    for k in Levels._DTYPES:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert a.max_levels == n and int(a.count) == int(jnp.sum(jl.valid))
    assert CE.needs_envelope(n, 40) and not CE.needs_envelope(8, 40)


def test_fma_rounds_once_where_a_float64_sum_would_round_twice():
    """``utils/floats.fma`` (the plain versions' counterpart of XLA's fused
    multiply-adds and the kernels' fmaf): x y + z = 2^24 + 1 + 2^-46 lies just
    above a float32 midpoint; a float64 sum lands on the midpoint and rounds
    to even, 2^24; rounded once it is 2^24 + 2, as XLA computes it under jit.
    A 390-bar Heston book makes ~10^8 such operations a run."""
    import jax

    from qmmx_monolithic_monte_carlo_tpu_torch.utils.floats import fma

    x, y, z = np.float32(1 + 2.0 ** -23), np.float32(-(1 - 2.0 ** -23)), np.float32(2.0 ** 24 + 2)
    want = float(jax.jit(lambda a, b, c: a * b + c)(x, y, z))
    assert want == 2.0 ** 24 + 2
    got = fma(torch.tensor([x, x]), torch.tensor([y, -y]), torch.tensor([z, -z]))
    assert got.tolist() == [want, -want]
    assert float((torch.tensor(x).double() * float(y) + float(z)).float()) == 2.0 ** 24
