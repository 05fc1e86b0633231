"""The port's correlated books held against the JAX package: the one-factor
mix and the book combine of ``parallel/portfolio.py`` (under ``jit``, as the
JAX book runs them) on the same numbers, for the gated lifecycle and the full
engine, per symbol and for the book; the plain version of kernel #7 against
the JAX gated book kernel in interpret mode on the same injected uniforms
(plain, [S] noise stds, antithetic), within the flip budget; (``slow``, as
``tests/test_portfolio.py:258`` is) the plain version of kernel #12 against
the JAX engine book kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
from qmmx_monolithic_monte_carlo_tpu.parallel import universe as jU
from qmmx_monolithic_monte_carlo_tpu.sim import enginepath as jEP
from qmmx_monolithic_monte_carlo_tpu.sim import gatedpath as jG
from qmmx_monolithic_monte_carlo_tpu.sim.pathsim import PathStats as JPathStats
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout, GatedLayout
from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row
from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import PathBars
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
from qmmx_monolithic_monte_carlo_tpu_torch.sim import enginepath as EP
from qmmx_monolithic_monte_carlo_tpu_torch.sim import gatedpath as G
from qmmx_monolithic_monte_carlo_tpu_torch.sim.book import BookCurve, mix_shocks, perp_of
from qmmx_monolithic_monte_carlo_tpu_torch.sim.pathsim import PathStats

from .test_pallas_engine import _bars_from_uniforms as engine_bars_jax
from .test_portfolio import _corr_bars_from_uniforms as gated_bars_jax

torch.set_num_threads(2)

W = 16
LANES = 256
N = 8 * LANES
DT = 1.0 / (390.0 * 252.0)
# the setting of tests/test_portfolio.py:195-255
ROWS2 = [[{"color": "blue", "type": "solid", "index": 0, "price": 100.0}],
         [{"color": "orange", "type": "dashed", "index": 0, "price": 50.2}]]
S0 = np.array([100.0, 50.0], np.float32)
SIGMAS = np.array([0.3, 0.4], np.float32)
BETAS = np.array([0.8, 0.6], np.float32)
WEIGHTS = np.array([0.5, 0.5], np.float32)
COUNTS = ("n", "n_entered", "n_tp", "n_stop", "n_open", "sum_trades")


def _flips(n):
    return 2 + n // 1024


@jax.jit
def _jax_mix(beta, z_mkt, eps):
    """The JAX book's per-symbol mix (parallel/portfolio.py:284-295) inside a
    jitted scan over symbols, as ``_portfolio_mc_impl`` runs it."""
    def per_symbol(carry, xs):
        bts, e = xs
        perp = jnp.sqrt(jnp.maximum(0.0, 1.0 - bts * bts))
        return carry, (perp, bts * z_mkt + perp * e)

    return jax.lax.scan(per_symbol, 0, (beta, eps))[1]


@jax.jit
def _jax_combine(curves, weights, trades, wins, losses, opens):
    """The JAX book's combine and fold (parallel/portfolio.py:318-342) inside
    a jitted scan over symbols, on given per-symbol outcomes and curves."""
    def per_symbol(carry, xs):
        port_curve, tt, ww, ll, oo = carry
        curve, wts, t, w, lo, o = xs
        return (port_curve + wts * curve, tt + t, ww + w, ll + lo,
                jnp.logical_or(oo, o)), None

    zi = jnp.zeros(curves.shape[2], jnp.int32)
    (port_curve, tt, ww, ll, oo), _ = jax.lax.scan(
        per_symbol, (jnp.zeros(curves.shape[1:], jnp.float32), zi, zi, zi,
                     jnp.zeros(curves.shape[2], bool)),
        (curves, weights, trades, wins, losses, opens))
    final = port_curve[-1]
    peak = jax.lax.cummax(jnp.maximum(port_curve, 0.0), axis=0)
    port_dd = jnp.max(peak - port_curve, axis=0)
    return port_curve, JPathStats.from_lifecycle(
        equity=final, trades=tt, wins=ww, losses=ll, open_at_end=oo, max_dd=port_dd)


def test_mix_equals_the_jitted_jax_book_bit_for_bit():
    """XLA fuses 1 - beta^2 and beta * z_mkt into the sum under jit; the
    port's ``mix_shocks`` / ``perp_of`` do the same (``utils/floats.fma``)."""
    rng = np.random.default_rng(1)
    betas = np.array([0.8, 0.6, 0.3, 0.0, 1.0, -0.45, 0.123456, 0.999], np.float32)
    zm = rng.normal(size=(W, 512)).astype(np.float32)
    eps = rng.normal(size=(len(betas), W, 512)).astype(np.float32)
    perp, z = (np.asarray(x) for x in _jax_mix(betas, zm, eps))
    for s, b in enumerate(betas):
        assert float(perp_of(float(b))) == float(perp[s]), b
        np.testing.assert_array_equal(
            mix_shocks(float(b), torch.from_numpy(zm), torch.from_numpy(eps[s])).numpy(), z[s],
            err_msg=str(b))


def _check_book(got_book: PathStats, got_curve, jstats, jcurve):
    np.testing.assert_array_equal(got_curve.numpy(), np.asarray(jcurve))
    for f in COUNTS:
        assert float(getattr(got_book, f)) == float(getattr(jstats, f)), f
    np.testing.assert_array_equal(got_book.hist.numpy(), np.asarray(jstats.hist))
    for f in ("sum_r", "sum_r2", "sum_dd"):
        np.testing.assert_allclose(float(getattr(got_book, f)), float(getattr(jstats, f)),
                                   rtol=1e-6, atol=1e-5, err_msg=f)
    for f in ("min_r", "max_r", "max_dd"):
        assert float(getattr(got_book, f)) == float(getattr(jstats, f)), f


@pytest.mark.parametrize("engine, noisy", [(False, False), (True, False), (True, True)])
def test_book_combine_matches_jax_on_the_same_bars(engine, noisy):
    """The JAX corr kernel tests' bars (tests/test_portfolio.py:148-192,
    tests/test_pallas_engine.py:40-130) from injected uniforms: each
    symbol's replay (with its post-bar curve) and the book combine, the
    port's against JAX's; the curves exactly, counts and histogram exactly,
    sums within 1e-6.  The engine also with execution noise and antithetic
    book pairs (market and idiosyncratic normals mirrored)."""
    from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise as JMcNoise
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise

    stds = dict(entry_slip_std=0.01, level_jitter_std=0.02, stop_slip_std=0.015,
                target_slip_std=0.015)
    rng = np.random.default_rng(23 + noisy if engine else 11)
    stride = (18 if noisy else 10) if engine else 8
    u = rng.uniform(1e-6, 1.0, (2, 1, stride * (W // 2), 8, LANES)).astype(np.float32)
    um = rng.uniform(1e-6, 1.0, (1, 2 * (W // 2), 8, LANES)).astype(np.float32)
    jlv = jU.stack_levels(ROWS2, max_levels=4)
    lv = U.stack_levels(ROWS2, max_levels=4)
    jparams, params = JParams.default(), EngineParams.default()
    book = BookCurve(N, W)
    jouts, jcurves = [], []
    for s in range(2):
        lv_j = jax.tree_util.tree_map(lambda x: x[s], jlv)
        jkw, tkw = {}, {}
        if engine:
            bars, tie, *nrm = engine_bars_jax(u[s, 0], float(SIGMAS[s]), lanes=LANES, w=W,
                                              s0=float(S0[s]), um=um[0], beta=float(BETAS[s]),
                                              with_noise=noisy, antithetic=noisy)
            if noisy:
                jkw = dict(noise=JMcNoise.make(**stds), noise_normals=nrm[0])
                tkw = dict(noise=McNoise.make(**stds), noise_normals=tuple(
                    torch.from_numpy(np.array(x)) for x in nrm[0]))
            jout, jcurve = jEP.engine_path_replay(bars, lv_j, jparams, tie, return_curve=True,
                                                  **jkw)
        else:
            bars, tie = gated_bars_jax(u[s, 0], um[0], float(BETAS[s]), float(S0[s]),
                                       float(SIGMAS[s]))
            jout, jcurve = jG.gated_path_replay(bars, lv_j, jparams,
                                                jG.GateConfig.from_params(jparams), tie,
                                                return_curve=True)
        tbars = PathBars(*(torch.from_numpy(np.array(a)) for a in bars))
        ttie = torch.from_numpy(np.array(tie))
        if engine:
            out, curve = EP.engine_path_replay(tbars, grid_row(lv, s), params, ttie,
                                               return_curve=True, **tkw)
        else:
            out, curve = G.gated_path_replay(tbars, grid_row(lv, s), params,
                                             G.GateConfig.from_params(params), ttie,
                                             return_curve=True)
        np.testing.assert_array_equal(curve.numpy(), np.asarray(jcurve))
        for f in ("trades", "wins", "losses", "open_at_end", "equity", "max_dd"):
            np.testing.assert_array_equal(getattr(out, f).numpy(),
                                          np.asarray(getattr(jout, f)), err_msg=f)
        book.add_curve(float(WEIGHTS[s]), curve)
        book.add_symbol(out)
        jouts.append(jout)
        jcurves.append(jcurve)
    jport_curve, jstats = _jax_combine(
        jnp.stack(jcurves), jnp.asarray(WEIGHTS),
        *(jnp.stack([getattr(o, f) for o in jouts])
          for f in ("trades", "wins", "losses", "open_at_end")))
    b = book.outcome()
    got = PathStats.from_lifecycle(equity=b.equity, trades=b.trades, wins=b.wins,
                                   losses=b.losses, open_at_end=b.open_at_end, max_dd=b.max_dd)
    _check_book(got, book.curve, jstats, jport_curve)
    assert int(got.sum_trades) > int(got.n_entered) > 0            # multi-trade book


def _check_totals(t, j, n, max_abs):
    """``tests/test_torch_universe.py:_check_totals`` for one row."""
    f = _flips(n)
    assert float(t.n) == float(j.n) == n
    for fld in ("n_entered", "n_tp", "n_stop", "n_open"):
        assert abs(float(getattr(t, fld)) - float(getattr(j, fld))) <= f, fld
    assert float(np.abs(t.hist.numpy() - np.asarray(j.hist)).sum()) <= 2 * f
    assert abs(float(t.sum_r) - float(j.sum_r)) <= f * max_abs
    assert abs(float(t.sum_trades) - float(j.sum_trades)) <= 2 * f


@pytest.mark.parametrize("case", ["plain", "noise", "antithetic"])
def test_plain_gated_book_matches_the_jax_kernel_interpret(case):
    """Kernel #7's setting (tests/test_portfolio.py:195-255), one block of
    8 x 256 paths, W = 16, the same injected uniforms: each symbol and the
    book within the flip budget (the JAX kernel mixes the shocks without
    fused multiply-adds in interpret mode, the plain version with them)."""
    from qmmx_monolithic_monte_carlo_tpu.ops.pallas_mc import mc_paths_pallas_gated_corr
    from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise as JMcNoise
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise

    noisy, anti = case == "noise", case == "antithetic"
    stds = {k: np.array(v, np.float32) for k, v in dict(
        level_jitter_std=[0.0, 0.02], entry_slip_std=[0.01, 0.0],
        stop_slip_std=[0.0, 0.015], target_slip_std=[0.015, 0.0]).items()}
    rng = np.random.default_rng(11 + len(case))
    u = rng.uniform(1e-6, 1.0, (2, 1, GatedLayout(W, noisy).u_rows, 8, LANES)).astype(np.float32)
    um = rng.uniform(1e-6, 1.0, (1, W, 8, LANES)).astype(np.float32)
    jlv = jU.stack_levels(ROWS2, max_levels=4)
    jsym, jport = mc_paths_pallas_gated_corr(
        0, jlv, JParams.default(), S0, SIGMAS, BETAS, WEIGHTS, paths_per_symbol=N,
        num_bars=W, lanes=LANES, interpret=True, external_uniforms=u, market_uniforms=um,
        noise=JMcNoise(**stds) if noisy else None, antithetic=anti)
    sym, port = cuda_gated.mc_paths_gated_corr_fused(
        0, U.stack_levels(ROWS2, max_levels=4), EngineParams.default(), S0, SIGMAS, BETAS,
        WEIGHTS, paths_per_symbol=N, num_bars=W, lanes=LANES, antithetic=anti,
        noise=McNoise(**{k: torch.from_numpy(v) for k, v in stds.items()}) if noisy else None,
        external_uniforms=torch.from_numpy(u), market_uniforms=torch.from_numpy(um))
    for s in range(2):
        _check_totals(sym.row(s), jax.tree_util.tree_map(lambda x: x[s], jsym), N,
                      float(max(sym.max_r[s].abs(), sym.min_r[s].abs())))
    _check_totals(port, jport, N, float(max(port.max_r.abs(), port.min_r.abs())))
    assert float(port.max_dd) == pytest.approx(float(jport.max_dd), abs=0.05)
    assert float(port.sum_trades) > float(port.n_entered) > 0


@pytest.mark.slow
def test_plain_engine_book_matches_the_jax_kernel_interpret():
    """Kernel #12's setting (tests/test_portfolio.py:258-336) on the same
    injected uniforms: each symbol and the book within the flip budget, the
    skip tables within W x F."""
    from qmmx_monolithic_monte_carlo_tpu.ops.pallas_engine import mc_paths_pallas_engine_corr

    rng = np.random.default_rng(23)
    u = rng.uniform(1e-6, 1.0, (2, 1, EngineLayout(W).u_rows, 8, LANES)).astype(np.float32)
    um = rng.uniform(1e-6, 1.0, (1, W, 8, LANES)).astype(np.float32)
    jsym, jport, jskips, jescal = mc_paths_pallas_engine_corr(
        0, jU.stack_levels(ROWS2, max_levels=4), JParams.default(), S0, SIGMAS, BETAS,
        WEIGHTS, paths_per_symbol=N, num_bars=W, lanes=LANES, interpret=True,
        external_uniforms=u, market_uniforms=um)
    sym, port, skips, escal = cuda_engine.mc_paths_engine_corr_fused(
        0, U.stack_levels(ROWS2, max_levels=4), EngineParams.default(), S0, SIGMAS, BETAS,
        WEIGHTS, paths_per_symbol=N, num_bars=W, lanes=LANES,
        external_uniforms=torch.from_numpy(u), market_uniforms=torch.from_numpy(um))
    f = _flips(N)
    for s in range(2):
        _check_totals(sym.row(s), jax.tree_util.tree_map(lambda x: x[s], jsym), N,
                      float(max(sym.max_r[s].abs(), sym.min_r[s].abs())))
        assert float(np.abs(skips[s].numpy() - np.asarray(jskips[s])).max()) <= W * f
        assert abs(int(escal[s]) - float(jescal[s])) <= f
    _check_totals(port, jport, N, float(max(port.max_r.abs(), port.min_r.abs())))
