"""The port's per-symbol universes and batched policy refresh held against the
JAX package: ``stack_levels``; one block's per-symbol first-contact and gated
replay against JAX's vmapped replay on the same numpy bars; the streamed
``universe_mc`` against the port's single pipelines at each symbol's key;
the IRLS ``fit`` / ``fit_batched`` / ``predict_proba`` / ``fit_sgd`` against
JAX's in float64 (exact ``n_iter`` per symbol) and against sklearn; the plain
versions of kernels #2 and #5 against the JAX universe kernels in interpret
mode, and of #10 and #11 per symbol against JAX's ``engine_path_replay`` of
the same injected-uniform bars; (``slow``) the plain #10 against the JAX
engine universe kernel in interpret mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
from qmmx_monolithic_monte_carlo_tpu.models import logistic as jL
from qmmx_monolithic_monte_carlo_tpu.ops.pathgen import PathBars as JPathBars
from qmmx_monolithic_monte_carlo_tpu.parallel import universe as jU
from qmmx_monolithic_monte_carlo_tpu.sim import enginepath as jEP
from qmmx_monolithic_monte_carlo_tpu.sim import gatedpath as jG
from qmmx_monolithic_monte_carlo_tpu.sim import pathsim as jPS
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.models import logistic as L
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated, cuda_mc
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout, GatedLayout, GbmLayout
from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row
from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import PathBars
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
from qmmx_monolithic_monte_carlo_tpu_torch.sim import gatedpath as G
from qmmx_monolithic_monte_carlo_tpu_torch.sim import pathsim as PS
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

from .test_pallas_engine import _bars_from_uniforms as engine_bars_jax

torch.set_num_threads(2)

DT = 1.0 / (390.0 * 252.0)
SIGMA = 0.3
# three symbols with their own level sets (tests/test_pallas_mc.py:272-276)
SYM_ROWS = [
    [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
     {"color": "teal", "type": "solid", "index": 0, "price": 99.6}],
    [{"color": "red", "type": "dashed", "index": 0, "price": 100.3}],
    [{"color": "green", "type": "solid", "index": 0, "price": 99.7},
     {"color": "orange", "type": "dashed", "index": 0, "price": 100.4}],
]
STATS_FIELDS = ("n", "n_tp", "n_stop", "n_open", "n_entered", "sum_trades")


def _levels(rows=SYM_ROWS, max_levels=8):
    return U.stack_levels(rows, max_levels=max_levels), jU.stack_levels(rows, max_levels=max_levels)


def _jrow(jlevels, s):
    return jax.tree_util.tree_map(lambda x: x[s], jlevels)


def _flips(n):
    return 2 + n // 1024


def test_stack_levels_matches_jax():
    t, j = _levels(max_levels=4)
    for f in dataclasses.fields(t):
        v, jv = getattr(t, f.name).numpy(), np.asarray(getattr(j, f.name))
        assert v.dtype == jv.dtype and v.shape == (3, 4), f.name
        np.testing.assert_array_equal(v, jv, err_msg=f.name)
    assert U.stack_levels(SYM_ROWS).max_levels == jU.stack_levels(SYM_ROWS).price.shape[1]


def _symbol_bars(seed, s=3, p=384, w=24):
    """numpy OHLC bars [S, P, W] (lognormal closes from each symbol's spot),
    a first-contact tie coin [S, P] and gated tie coins [S, P, W]."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(s):
        s0 = 100.0 + 0.1 * k
        logc = np.log(s0) + np.cumsum(rng.normal(0, 0.0012, (p, w)), axis=1)
        close = np.exp(logc)
        opens = np.concatenate([np.full((p, 1), s0), close[:, :-1]], axis=1)
        hi = np.maximum(opens, close) + np.abs(rng.normal(0, 0.05, (p, w)))
        lo = np.minimum(opens, close) - np.abs(rng.normal(0, 0.05, (p, w)))
        out.append([a.astype(np.float32) for a in (opens, hi, lo, close, np.zeros((p, w)))])
    arrs = [np.stack(x) for x in zip(*out)]
    return (arrs, rng.uniform(size=(s, p)).astype(np.float32),
            rng.uniform(size=(s, p, w)).astype(np.float32))


@pytest.mark.parametrize("gated", [False, True])
def test_one_block_per_symbol_replay_matches_jax_vmap(gated):
    """One block of each symbol replayed under its own levels, as the JAX
    universe's ``jax.vmap(per_symbol)`` does (parallel/universe.py:73-82),
    on the same numpy bars: first contact's PathStats, or the gated
    lifecycle path by path."""
    arrs, tie1, tie = _symbol_bars(1 + gated)
    levels, jlevels = _levels()
    params, jparams = EngineParams.default(), JParams.default()
    if not gated:
        want = jax.jit(jax.vmap(lambda b, lv, t: jPS.PathStats.from_outcomes(
            *jPS.path_replay(JPathBars(*b), lv, jparams, t))))(
                [jnp.asarray(a) for a in arrs], jlevels, jnp.asarray(tie1))
        for s in range(3):
            got = PS.PathStats.from_outcomes(*PS.path_replay(
                PathBars(*(torch.from_numpy(a[s]) for a in arrs)), grid_row(levels, s),
                params, torch.from_numpy(tie1[s])))
            for f in STATS_FIELDS:
                assert float(getattr(got, f)) == float(np.asarray(getattr(want, f))[s]), (s, f)
            np.testing.assert_array_equal(got.hist.numpy(), np.asarray(want.hist)[s])
            np.testing.assert_allclose(float(got.sum_r), float(np.asarray(want.sum_r)[s]),
                                       rtol=1e-5, atol=1e-5)
        assert len(set(np.asarray(want.n_entered).tolist())) > 1
        return
    gate, jgate = G.GateConfig.default(touch_limit=100, touch_gap_bars=1), \
        jG.GateConfig.default(touch_limit=100, touch_gap_bars=1)
    want = jax.jit(jax.vmap(lambda b, lv, t: jG.gated_path_replay(
        JPathBars(*b), lv, jparams, jgate, t)))(
            [jnp.asarray(a) for a in arrs], jlevels, jnp.asarray(tie))
    for s in range(3):
        got = G.gated_path_replay(PathBars(*(torch.from_numpy(a[s]) for a in arrs)),
                                  grid_row(levels, s), params, gate, torch.from_numpy(tie[s]))
        for f in ("trades", "wins", "losses", "open_at_end"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f))[s], err_msg=f)
        for f in ("equity", "max_dd"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f))[s],
                                       rtol=1e-6, atol=1e-6, err_msg=f)
    trades = np.asarray(want.trades)
    assert int(trades.sum()) > int((trades > 0).sum()) > 0     # multi-trade paths


@pytest.mark.parametrize("gated", [False, True])
def test_universe_mc_rows_equal_the_single_pipeline(gated):
    """Row s of ``universe_mc`` is the port's ``mc_paths`` (or
    ``mc_paths_gated``) at symbol s's levels, s0, sigma and key, bit for
    bit; symbol 0's key is the single run's."""
    levels, _ = _levels()
    s0 = np.array([100.0, 100.1, 100.2], np.float32)
    sigma = np.array([0.3, 0.2, 0.25], np.float32)
    params = EngineParams.default()
    gate = G.GateConfig.default(touch_limit=100, touch_gap_bars=1) if gated else None
    kw = dict(num_bars=16, block_paths=256, device="cpu")
    got = U.universe_mc(5, levels, params, s0, sigma, paths_per_symbol=512, gate=gate, **kw)
    assert got.n.shape == (3,)
    for s in range(3):
        one = dict(num_paths=512, s0=float(s0[s]), sigma=float(sigma[s]), symbol=s, **kw)
        want = (G.mc_paths_gated(5, grid_row(levels, s), params, gate, **one) if gated
                else PS.mc_paths(5, grid_row(levels, s), params, **one))
        for f in dataclasses.fields(want):
            if f.name not in ("hist_lo", "hist_hi"):
                assert torch.equal(getattr(got.row(s), f.name), getattr(want, f.name)), (s, f)
    # symbol 0 is today's key; symbol 1 at symbol 0's inputs draws other paths
    one = dict(num_paths=512, s0=float(s0[0]), sigma=float(sigma[0]), **kw)
    today = (G.mc_paths_gated(5, grid_row(levels, 0), params, gate, **one) if gated
             else PS.mc_paths(5, grid_row(levels, 0), params, **one))
    assert torch.equal(got.row(0).sum_r, today.sum_r)
    other = (G.mc_paths_gated(5, grid_row(levels, 0), params, gate, symbol=1, **one) if gated
             else PS.mc_paths(5, grid_row(levels, 0), params, symbol=1, **one))
    assert not torch.equal(other.sum_r, today.sum_r)


# ---------------------------------------------------------------------------
# the IRLS refresh (models/logistic.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def x64():
    """float64 in JAX for one test, then back: the kernel tests below (and
    every other test a worker runs after this file) expect float32."""
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _make_data(rng, n=200, d=3):
    """tests/test_logistic.py:9-14."""
    x = rng.normal(0, 1, (n, d))
    w_true = rng.normal(0, 2, d)
    p = 1 / (1 + np.exp(-(x @ w_true + 0.3)))
    return x, (rng.uniform(size=n) < p).astype(int)


def _assert_model_close(t, j, atol=1e-10):
    np.testing.assert_allclose(t.coef.numpy(), np.asarray(j.coef), rtol=0, atol=atol)
    np.testing.assert_allclose(t.intercept.numpy(), np.asarray(j.intercept), rtol=0, atol=atol)
    np.testing.assert_array_equal(t.n_iter.numpy(), np.asarray(j.n_iter))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_matches_jax_irls_float64(seed, x64):
    rng = np.random.default_rng(seed)
    x, y = _make_data(rng)
    want = jL.fit(x, y, max_iter=50)
    got = L.fit(torch.from_numpy(x), torch.from_numpy(y), max_iter=50)
    assert got.coef.dtype == torch.float64
    _assert_model_close(got, want)
    assert float(got.grad_norm) < 1e-10
    xq = rng.normal(0, 1, (20, 3))
    np.testing.assert_allclose(L.predict_proba(got, torch.from_numpy(xq)).numpy(),
                               np.asarray(jL.predict_proba(want, xq)), rtol=0, atol=1e-12)


def test_fit_batched_matches_jax_per_symbol_with_padding_rows(x64):
    """Four symbols of [150, 3] with 0-weight padding rows (as
    tests/test_logistic.py:78-100), one of them separable-ish, so the
    symbols stop after different Newton counts; each symbol's coefficients,
    intercept and n_iter are JAX's, and equal the unbatched fit's."""
    rng = np.random.default_rng(5)
    xs, ys = map(np.stack, zip(*[_make_data(rng, n=150) for _ in range(4)]))
    xs[3] *= 4.0                                  # a steeper fit: more iterations
    ws = np.ones((4, 150))
    ws[1, 100:] = 0.0
    ws[2, 30:] = 0.0
    want = jL.fit_batched(xs, ys, ws, max_iter=50)
    got = L.fit_batched(torch.from_numpy(xs), torch.from_numpy(ys), torch.from_numpy(ws),
                        max_iter=50)
    _assert_model_close(got, want)
    np.testing.assert_allclose(got.grad_norm.numpy(), np.asarray(want.grad_norm), atol=1e-10)
    assert len(set(got.n_iter.tolist())) > 1, got.n_iter
    for s in range(4):
        one = L.fit(torch.from_numpy(xs[s]), torch.from_numpy(ys[s]), torch.from_numpy(ws[s]),
                    max_iter=50)
        assert int(one.n_iter) == int(got.n_iter[s])
        np.testing.assert_allclose(one.coef.numpy(), got.coef[s].numpy(), rtol=0, atol=1e-12)
    dropped = L.fit(torch.from_numpy(xs[2, :30]), torch.from_numpy(ys[2, :30]), max_iter=50)
    np.testing.assert_allclose(dropped.coef.numpy(), got.coef[2].numpy(), atol=1e-8)


def test_fit_batched_stops_at_max_iter_per_symbol(x64):
    rng = np.random.default_rng(9)
    xs, ys = map(np.stack, zip(*[_make_data(rng, n=80) for _ in range(3)]))
    want = jL.fit_batched(xs, ys, max_iter=3)
    got = L.fit_batched(torch.from_numpy(xs), torch.from_numpy(ys), max_iter=3)
    _assert_model_close(got, want)
    assert got.n_iter.tolist() == [3, 3, 3]


def test_universe_policy_refresh_matches_jax(x64):
    rng = np.random.default_rng(0)
    s, n, d = 6, 80, 3
    xs = rng.normal(0, 1, (s, n, d))
    w_true = rng.normal(0, 1.5, (s, d))
    p = 1 / (1 + np.exp(-np.einsum("snd,sd->sn", xs, w_true)))
    ys = (rng.uniform(size=(s, n)) < p).astype(np.int32)
    want = jU.universe_policy_refresh(None, xs, ys)
    got = U.universe_policy_refresh(None, xs, ys, device="cpu")
    _assert_model_close(got, want)


def test_fit_matches_sklearn_tight():
    sk = pytest.importorskip("sklearn.linear_model")
    for seed in (0, 3):
        rng = np.random.default_rng(seed)
        x, y = _make_data(rng)
        ref = sk.LogisticRegression(max_iter=10000, tol=1e-12).fit(x, y)
        got = L.fit(torch.from_numpy(x), torch.from_numpy(y), max_iter=50)
        np.testing.assert_allclose(got.coef.numpy(), ref.coef_[0], atol=1e-6)
        np.testing.assert_allclose(float(got.intercept), ref.intercept_[0], atol=1e-6)
        xq = rng.normal(0, 1, (20, 3))
        np.testing.assert_allclose(L.predict_proba(got, torch.from_numpy(xq)).numpy(),
                                   ref.predict_proba(xq)[:, 1], atol=1e-6)


def test_fit_sgd_matches_jax():
    rng = np.random.default_rng(11)
    x, y = _make_data(rng, n=40)
    x = x.astype(np.float32)
    want = jL.fit_sgd(x, y.astype(np.float32), epochs=5)
    got = L.fit_sgd(torch.from_numpy(x), torch.from_numpy(y), epochs=5)
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got.intercept), float(want.intercept), atol=1e-5)


def test_float32_fit_stays_float32_and_near_float64():
    rng = np.random.default_rng(2)
    xs, ys = map(np.stack, zip(*[_make_data(rng, n=64, d=4) for _ in range(5)]))
    f32 = L.fit_batched(torch.from_numpy(xs.astype(np.float32)), torch.from_numpy(ys))
    f64 = L.fit_batched(torch.from_numpy(xs), torch.from_numpy(ys))
    assert f32.coef.dtype == torch.float32 and f64.coef.dtype == torch.float64
    np.testing.assert_allclose(f32.coef.numpy(), f64.coef.numpy(), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the plain kernel versions against JAX
# ---------------------------------------------------------------------------

def _check_totals(t, j, n, s, max_abs):
    f = _flips(n)
    assert float(t.n[s]) == float(j.n[s]) == n
    for fld in ("n_entered", "n_tp", "n_stop", "n_open"):
        assert abs(float(getattr(t, fld)[s]) - float(getattr(j, fld)[s])) <= f, (s, fld)
    assert float(np.abs(t.hist[s].numpy() - np.asarray(j.hist[s])).sum()) <= 2 * f
    assert abs(float(t.sum_r[s]) - float(j.sum_r[s])) <= f * max_abs


def test_plain_universe_matches_the_jax_kernel_interpret():
    """Kernel #2's setting (tests/test_pallas_mc.py:260-305): 3 symbols with
    distinct levels, s0, sigma, prox and paddings, one block of 2048 paths
    each, injected uniforms; each symbol within the flip budget."""
    from qmmx_monolithic_monte_carlo_tpu.ops.pallas_mc import mc_paths_pallas_universe

    w, lanes = 24, cuda_mc.UNIVERSE_LANES
    levels, jlevels = _levels()
    s0 = np.array([100.0, 100.2, 99.9], np.float32)
    sigma = np.array([0.3, 0.2, 0.35], np.float32)
    knobs = dict(contact_prox=np.array([0.05, 0.08, 0.03], np.float32),
                 stop_padding=np.array([0.35, 0.20, 0.50], np.float32),
                 tp_padding=np.array([0.25, 0.40, 0.10], np.float32))
    u = np.random.default_rng(5).uniform(
        1e-9, 1.0, (3, 1, GbmLayout(w).n_rows, lanes)).astype(np.float32)
    want = mc_paths_pallas_universe(0, jlevels, JParams.default().replace(**knobs), s0, sigma,
                                    paths_per_symbol=lanes, num_bars=w, dt=DT, interpret=True,
                                    external_uniforms=u)
    got = cuda_mc.stats_from_totals(*cuda_mc.universe_totals_reference(
        0, levels, EngineParams.default().replace(**knobs), s0, sigma, paths_per_symbol=lanes,
        num_bars=w, dt=DT, external_uniforms=torch.from_numpy(u)))
    for s in range(3):
        max_r = max(abs(float(got.min_r[s])), abs(float(got.max_r[s])))
        _check_totals(got, want, lanes, s, max_r)
    assert len(set(got.n_stop.tolist())) == 3


def test_plain_gated_universe_matches_the_jax_kernel_interpret():
    """Kernel #5's setting (tests/test_pallas_gated.py:349-397): 2 symbols
    with distinct levels and knobs, per-symbol [S] noise stds, the gate
    shared, one block of 8 x 1024 paths each; within the flip budget."""
    from qmmx_monolithic_monte_carlo_tpu.ops.pallas_mc import mc_paths_pallas_gated_universe
    from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise as JMcNoise
    from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise

    w, lanes = 16, cuda_gated.GATED_LANES
    n = 8 * lanes
    levels, jlevels = _levels(SYM_ROWS[:2])
    s0 = np.array([100.0, 100.0], np.float32)
    sigma = np.array([SIGMA, 0.2], np.float32)
    knobs = dict(contact_prox=np.array([0.05, 0.08], np.float32),
                 stop_padding=np.array([0.35, 0.20], np.float32),
                 tp_padding=np.array([0.25, 0.40], np.float32))
    stds = {k: np.array(v, np.float32) for k, v in dict(
        level_jitter_std=[0.0, 0.02], entry_slip_std=[0.01, 0.0],
        stop_slip_std=[0.0, 0.015], target_slip_std=[0.015, 0.0]).items()}
    kw = dict(touch_limit=100, touch_gap_bars=1, use_confidence=False)
    u = np.random.default_rng(13).uniform(
        1e-6, 1.0, (2, 1, GatedLayout(w, True).u_rows, 8, lanes)).astype(np.float32)
    want = mc_paths_pallas_gated_universe(
        0, jlevels, JParams.default().replace(**knobs), s0, sigma, jG.GateConfig.default(**kw),
        paths_per_symbol=n, num_bars=w, dt=DT, noise=JMcNoise(**stds), interpret=True,
        external_uniforms=u)
    got = cuda_gated.stats_from_gated_totals(*cuda_gated.gated_universe_totals_reference(
        0, levels, EngineParams.default().replace(**knobs), s0, sigma,
        G.GateConfig.default(**kw), paths_per_symbol=n, num_bars=w, dt=DT,
        noise=McNoise(**{k: torch.from_numpy(v) for k, v in stds.items()}),
        external_uniforms=torch.from_numpy(u)))
    for s in range(2):
        _check_totals(got, want, n, s, float(max(got.max_r[s].abs(), got.min_r[s].abs())))
        assert abs(float(got.sum_trades[s]) - float(want.sum_trades[s])) <= 2 * _flips(n)
    assert bool((got.sum_trades > got.n_entered).all())        # multi-trade paths


def _engine_rows(out):
    return np.stack([np.asarray(out.equity), np.asarray(out.trades), np.asarray(out.wins),
                     np.asarray(out.losses), np.asarray(out.open_at_end),
                     np.asarray(out.max_dd), np.asarray(out.escalations)], 1).astype(np.float32)


def _assert_engine_rows(rows, want, w):
    """At most F differing paths (counts, or equity / dd beyond 1e-3 per
    trade), skip counters within W x F, as tests/test_torch_engine.py holds
    the single plain version."""
    got = rows.numpy()[:, :7]
    ref = _engine_rows(want)
    f = _flips(got.shape[0])
    err = np.abs(got[:, [0, 5]] - ref[:, [0, 5]]).max(axis=1)
    differ = ((got[:, [1, 2, 3, 4, 6]] != ref[:, [1, 2, 3, 4, 6]]).any(axis=1)
              | (err > 1e-3 * np.maximum(ref[:, 1], 1.0)))
    assert int(differ.sum()) <= f
    skips = rows.numpy()[:, 7:].sum(axis=0)
    assert int(np.abs(skips - np.asarray(want.skip_counts)).max()) <= w * f


def _engine_universe_case():
    """tests/test_pallas_engine.py:352-405's 2-symbol universe: distinct
    levels, sigma, paddings and q_min, one block of 8 x 256 paths, W = 24."""
    w, lanes = 24, 256
    rows = [[{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
             {"color": "teal", "type": "solid", "index": 0, "price": 99.6}],
            [{"color": "red", "type": "dashed", "index": 0, "price": 100.3}]]
    knobs = dict(stop_padding=np.array([0.35, 0.20], np.float32),
                 tp_padding=np.array([0.25, 0.40], np.float32),
                 q_min_prob=np.array([0.60, 0.40], np.float32))
    sigma = np.array([0.3, 0.2], np.float32)
    u = np.random.default_rng(29).uniform(
        1e-6, 1.0, (2, 1, EngineLayout(w).u_rows, 8, lanes)).astype(np.float32)
    return w, lanes, rows, knobs, sigma, u


def test_plain_engine_universe_matches_jax_replay_per_symbol():
    """Kernel #10's plain version: each symbol's per-path rows against JAX's
    ``engine_path_replay`` of the bars JAX builds from that symbol's
    uniforms, at its levels, sigma and knobs."""
    w, lanes, rows, knobs, sigma, u = _engine_universe_case()
    levels, jlevels = _levels(rows)
    _, _, prow = cuda_engine.engine_universe_totals_reference(
        0, levels, EngineParams.default().replace(**knobs), np.full(2, 100.0), sigma,
        paths_per_symbol=8 * lanes, num_bars=w, dt=DT, lanes=lanes,
        external_uniforms=torch.from_numpy(u), per_path=True)
    assert prow.shape == (2, 8 * lanes, cuda_engine.PATH_COLS)
    for s in range(2):
        bars, tie = engine_bars_jax(u[s, 0], float(sigma[s]), lanes=lanes, w=w)
        jparams = JParams.default(**{k: float(v[s]) for k, v in knobs.items()})
        want = jEP.engine_path_replay(bars, _jrow(jlevels, s), jparams, tie)
        _assert_engine_rows(prow[s], want, w)
        assert int(np.asarray(want.trades).sum()) > 0


def test_plain_engine_universe_sweep_matches_jax_replay_per_cell():
    """Kernel #11's plain version on an [S, G] grid with [S, G] leaves (each
    symbol sweeps around its own paddings) and [G] noise-free rows: cell
    (s, g) against JAX's replay of symbol s's bars under row g's knobs."""
    w, lanes, rows, _, sigma, u = _engine_universe_case()
    levels, jlevels = _levels(rows)
    stops = np.array([[0.35, 0.25], [0.20, 0.30]], np.float32)
    qmin = np.array([0.60, 0.40], np.float32)
    grid = EngineParams.default().replace(stop_padding=stops, q_min_prob=qmin)
    _, _, prow = cuda_engine.engine_universe_sweep_totals_reference(
        0, levels, grid, np.full(2, 100.0), sigma, paths_per_symbol=8 * lanes, num_bars=w,
        dt=DT, lanes=lanes, external_uniforms=torch.from_numpy(u), per_path=True)
    assert prow.shape == (2, 2, 8 * lanes, cuda_engine.PATH_COLS)
    for s in range(2):
        bars, tie = engine_bars_jax(u[s, 0], float(sigma[s]), lanes=lanes, w=w)
        for g in range(2):
            jparams = JParams.default(stop_padding=float(stops[s, g]),
                                      q_min_prob=float(qmin[g]))
            want = jEP.engine_path_replay(bars, _jrow(jlevels, s), jparams, tie)
            _assert_engine_rows(prow[s, g], want, w)


@pytest.mark.slow
def test_plain_engine_universe_matches_the_jax_kernel_interpret():
    """The JAX engine universe kernel in interpret mode and the plain version
    on the same injected uniforms (tests/test_pallas_engine.py:352-405):
    each symbol within the flip budget, skip counters within W x F."""
    from qmmx_monolithic_monte_carlo_tpu.ops.pallas_engine import mc_paths_pallas_engine_universe

    w, lanes, rows, knobs, sigma, u = _engine_universe_case()
    levels, jlevels = _levels(rows)
    s0 = np.full(2, 100.0, np.float32)
    want, wskips, wescal = mc_paths_pallas_engine_universe(
        0, jlevels, JParams.default().replace(**{k: jnp.asarray(v) for k, v in knobs.items()}),
        s0, sigma, paths_per_symbol=8 * lanes, num_bars=w, dt=DT, lanes=lanes,
        interpret=True, external_uniforms=u)
    got, skips, escal = cuda_engine.stats_from_engine_totals(
        *cuda_engine.engine_universe_totals_reference(
            0, levels, EngineParams.default().replace(**knobs), s0, sigma,
            paths_per_symbol=8 * lanes, num_bars=w, dt=DT, lanes=lanes,
            external_uniforms=torch.from_numpy(u)))
    f = _flips(8 * lanes)
    for s in range(2):
        assert float(got.n[s]) == float(want.n[s])
        assert abs(float(got.n_entered[s]) - float(want.n_entered[s])) <= f
        assert abs(float(got.sum_trades[s]) - float(want.sum_trades[s])) <= 2 * f
        assert float(np.abs(skips[s].numpy() - np.asarray(wskips[s])).max()) <= w * f
        assert abs(int(escal[s]) - float(wescal[s])) <= f
