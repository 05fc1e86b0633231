"""The plain versions of the sampler rows (kernels #2, #3, #5, #6, #9, #10,
#11 under bootstrap, block bootstrap and Heston) held against the JAX kernels
in interpret mode on the same injected uniforms and JAX's own bootstrap
tables: a 2-symbol universe, each symbol on its own [S, H] history, and a
2-row sweep, at W = 8-16 and one block.  Gated and engine counts, skip
tables and escalations exact; first contact within F = 2 + paths/1024
(tests/test_pallas_mc.py:133-146).  The JAX package's own versions of these
comparisons are marked slow (tests/test_engine_bootstrap.py:226, :283,
tests/test_gated_bootstrap.py:142, tests/test_pallas_mc.py:467), so the
shapes here stay small, and the comparisons are spread over this file (the
helpers, first contact, the gated universe under Heston) and
``test_torch_sampler_rows_{gated,engine,engine_sweep,engine_usweep}_interpret.py``,
each under a minute on one worker.  The non-interpret side of this slice is
``tests/test_torch_sampler_rows.py``."""

import jax
import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
from qmmx_monolithic_monte_carlo_tpu.ops import pallas_mc as jPM
from qmmx_monolithic_monte_carlo_tpu.ops import pathgen as jPG
from qmmx_monolithic_monte_carlo_tpu.parallel import universe as jU
from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise as JMcNoise
from qmmx_monolithic_monte_carlo_tpu.types import Levels as JLevels
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_gated, cuda_mc
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import GatedLayout, GbmLayout
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

torch.set_num_threads(2)

BLOCK_LEN = 5
SYM_ROWS = [[{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
             {"color": "teal", "type": "solid", "index": 0, "price": 99.6}],
            [{"color": "green", "type": "solid", "index": 0, "price": 100.2},
             {"color": "orange", "type": "dashed", "index": 0, "price": 100.6}]]
ROWS = SYM_ROWS[0]
S0 = [100.0, 100.2]
SIGMA = [0.3, 0.25]
STDS = dict(entry_slip_std=0.01, level_jitter_std=0.02, stop_slip_std=0.015,
            target_slip_std=0.015)
STOPS, TPS = [0.25, 0.45], [0.35, 0.15]
COUNTS = ("n", "n_entered", "n_tp", "n_stop", "n_open", "sum_trades")


def _histories(seed: int, n_sym: int, h: int):
    """[S, H] recorded histories (wicks, volume bursts), float32 numpy
    o, h, l, c, v; symbol s's from its own spot."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(0, 0.12, (n_sym, h)).astype(np.float32)
    c = np.asarray(S0[:n_sym], np.float32)[:, None] + np.cumsum(steps, axis=1, dtype=np.float32)
    o = np.concatenate([c[:, :1], c[:, :-1]], axis=1)
    hi = np.maximum(o, c) + rng.uniform(0, 0.15, (n_sym, h)).astype(np.float32)
    lo = np.minimum(o, c) - rng.uniform(0, 0.15, (n_sym, h)).astype(np.float32)
    v = rng.lognormal(13.0, 0.5, (n_sym, h)).astype(np.float32)
    v = v * (1.0 + 2.0 * (np.abs(steps) > 0.15)).astype(np.float32)
    return [np.ascontiguousarray(x, np.float32) for x in (o, hi, lo, c, v)]


HIST = _histories(8, 2, 300)


def _jax_history(universe: bool):
    """(JAX's PathBars of the histories, JAX's own tables: [S, 5, H], or
    symbol 0's [5, H] for a sweep), so both sides resample the same values."""
    if universe:
        tabs = jax.vmap(jPG.bootstrap_tables)(*HIST)
        return jPG.PathBars(*HIST), np.stack([np.asarray(t) for t in tabs], axis=1)
    one = [x[0] for x in HIST]
    return jPG.PathBars(*one), np.stack([np.asarray(t) for t in jPG.bootstrap_tables(*one)])


def _kw(sampler):
    return dict(sampler=sampler, block_len=BLOCK_LEN)


def _flips(n):
    return 2 + n // 1024


def _uniforms(seed, shape, low=1e-6):
    return np.random.default_rng(seed).uniform(low, 1.0, shape).astype(np.float32)


def _row(stats, i):
    return {f: float(np.asarray(getattr(stats, f))[i]) for f in COUNTS}


def _assert_lifecycle(t, j, n, i, max_eq):
    """Row ``i``: counts exact, the histogram within 2F, the sums within
    F x max|equity| (PyTorch's exp against XLA's may move an equity across a
    bin edge)."""
    assert _row(t, i) == _row(j, i), i
    f = _flips(n)
    assert float(np.abs(t.hist.numpy()[i] - np.asarray(j.hist)[i]).sum()) <= 2 * f
    for fld in ("sum_r", "sum_dd"):
        assert abs(float(getattr(t, fld)[i]) - float(np.asarray(getattr(j, fld))[i])) \
            <= f * max_eq, (i, fld)


def _assert_first_contact(t, j, n):
    """One row's PathStats ``t`` (port) and ``j`` (JAX): n exact, the counts
    within F, the histogram within 2F."""
    f = _flips(n)
    assert float(t.n) == float(np.asarray(j.n)) == n
    for fld in ("n_entered", "n_tp", "n_stop", "n_open"):
        assert abs(float(getattr(t, fld)) - float(np.asarray(getattr(j, fld)))) <= f, fld
    assert float(np.abs(t.hist.numpy() - np.asarray(j.hist)).sum()) <= 2 * f
    assert float(t.n_entered) > 0


@pytest.mark.parametrize("sampler", ["block_bootstrap", "heston"])
def test_plain_first_contact_universe_matches_the_jax_kernel_interpret(sampler):
    """#2: each symbol on its own history (or the shared Heston constants at
    mu 0), rebased on its own s0."""
    w, lanes = 16, jPM.LANES
    jhist, jtables = _jax_history(True)
    u = _uniforms(71, (2, 1, GbmLayout(w, False, sampler).n_rows, lanes), 1e-9)
    j = jPM.mc_paths_pallas_universe(
        0, jU.stack_levels(SYM_ROWS, max_levels=8), JParams.default(), np.float32(S0),
        np.float32(SIGMA), paths_per_symbol=lanes, num_bars=w, hist_bars=jhist,
        interpret=True, external_uniforms=u, **_kw(sampler))
    t = cuda_mc.mc_paths_universe_fused(
        0, U.stack_levels(SYM_ROWS, max_levels=8), EngineParams.default(), S0, SIGMA,
        paths_per_symbol=lanes, num_bars=w, tables=jtables, external_uniforms=torch.from_numpy(u),
        **_kw(sampler))
    for i in range(2):
        _assert_first_contact(t.row(i), jax.tree_util.tree_map(lambda x: x[i], j), lanes)


@pytest.mark.parametrize("sampler", ["bootstrap", "heston"])
def test_plain_first_contact_sweep_matches_the_jax_kernel_interpret(sampler):
    """#3: the JAX sweep kernel draws its own uniforms, and its row g equals
    the JAX single kernel at (stop_g, tp_g) (pallas_mc.py:2008-2012); so each
    row of the port's plain sweep on injected uniforms is held against the
    JAX single kernel in interpret mode on the same uniforms."""
    w, lanes = 16, 8192
    jhist, jtables = _jax_history(False)
    u = _uniforms(72, (1, GbmLayout(w, False, sampler).n_rows, lanes), 1e-9)
    t = cuda_mc.mc_paths_sweep_fused(
        0, Levels.from_rows(ROWS, max_levels=8), EngineParams.default(), STOPS, TPS,
        num_paths=lanes, num_bars=w, sigma=0.3, tables=jtables,
        external_uniforms=torch.from_numpy(u), **_kw(sampler))
    for g, (sp, tp) in enumerate(zip(STOPS, TPS)):
        j = jPM.mc_paths_pallas(
            0, JLevels.from_rows(ROWS, max_levels=8),
            JParams.default().replace(stop_padding=sp, tp_padding=tp), num_paths=lanes,
            num_bars=w, sigma=0.3, hist_bars=jhist, interpret=True, external_uniforms=u,
            **_kw(sampler))
        _assert_first_contact(t.row(g), j, lanes)


@pytest.mark.parametrize("sampler,noisy", [("heston", False)])
def test_plain_gated_universe_matches_the_jax_kernel_interpret(sampler, noisy):
    """#5 with its own histories and, with noise, the same stds a symbol."""
    w, lanes = 8, jPM.GATED_LANES
    jhist, jtables = _jax_history(True)
    u = _uniforms(73, (2, 1, GatedLayout(w, noisy, sampler).u_rows, 8, lanes))
    j = jPM.mc_paths_pallas_gated_universe(
        0, jU.stack_levels(SYM_ROWS, max_levels=8), JParams.default(), np.float32(S0),
        np.float32(SIGMA), paths_per_symbol=8 * lanes, num_bars=w, hist_bars=jhist,
        noise=JMcNoise.make(**STDS) if noisy else None, interpret=True, external_uniforms=u,
        **_kw(sampler))
    kw = dict(paths_per_symbol=8 * lanes, num_bars=w, tables=jtables,
              noise=McNoise.make(**STDS) if noisy else None,
              external_uniforms=torch.from_numpy(u), **_kw(sampler))
    args = (0, U.stack_levels(SYM_ROWS, max_levels=8), EngineParams.default(), S0, SIGMA)
    t = cuda_gated.mc_paths_gated_universe_fused(*args, **kw)
    rows = cuda_gated.gated_universe_totals_reference(*args, per_path=True, **kw)[2]
    for i in range(2):
        _assert_lifecycle(t, j, 8 * lanes, i, float(rows[i][:, 0].abs().max()))
    assert float(t.sum_trades.sum()) > float(t.n_entered.sum()) > 0


def _assert_engine(t, j, n, idx):
    (ts, tskips, tescal), (js, jskips, jescal) = t, j
    assert _row(ts, idx) == _row(js, idx), idx
    np.testing.assert_array_equal(tskips.numpy()[idx], np.asarray(jskips)[idx])
    assert int(tescal[idx]) == int(np.asarray(jescal)[idx])
    assert float(np.abs(ts.hist.numpy()[idx] - np.asarray(js.hist)[idx]).sum()) \
        <= 2 * _flips(n)
