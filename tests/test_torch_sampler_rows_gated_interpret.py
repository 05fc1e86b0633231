"""The gated sampler rows (kernels #5 and #6) in interpret mode: the plain
versions against the JAX kernels on the same injected uniforms, as
``tests/test_torch_sampler_rows_interpret.py`` sets out."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
from qmmx_monolithic_monte_carlo_tpu.ops import pallas_mc as jPM
from qmmx_monolithic_monte_carlo_tpu.parallel import universe as jU
from qmmx_monolithic_monte_carlo_tpu.sim.gatedpath import GateConfig as JGateConfig
from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise as JMcNoise
from qmmx_monolithic_monte_carlo_tpu.types import Levels as JLevels
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_gated
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import GatedLayout
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import GateConfig
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

from .test_torch_sampler_rows_interpret import (ROWS, S0, SIGMA, STDS, STOPS, SYM_ROWS, TPS,
                                                _assert_lifecycle, _jax_history, _kw,
                                                _uniforms)

torch.set_num_threads(2)


@pytest.mark.parametrize("sampler,noisy", [("bootstrap", True)])
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


@pytest.mark.parametrize("sampler", ["block_bootstrap"])
def test_plain_gated_sweep_matches_the_jax_kernel_interpret(sampler):
    """#6: two (stop, tp) rows with [G] noise stds on the same uniforms."""
    w, lanes = 8, jPM.GATED_LANES
    jhist, jtables = _jax_history(False)
    u = _uniforms(74, (1, GatedLayout(w, True, sampler).u_rows, 8, lanes))
    stds = {k: np.full(2, v, np.float32) for k, v in STDS.items()}
    stds["level_jitter_std"] = np.float32([0.0, 0.03])
    j = jPM.mc_paths_pallas_gated_sweep(
        0, JLevels.from_rows(ROWS, max_levels=8), JParams.default(), np.float32(STOPS),
        np.float32(TPS), num_paths=8 * lanes, num_bars=w, sigma=0.3, hist_bars=jhist,
        noise=JMcNoise(**{k: jnp.asarray(v) for k, v in stds.items()}), interpret=True,
        external_uniforms=u, **_kw(sampler))
    noise = McNoise(**{k: torch.from_numpy(v) for k, v in stds.items()})
    kw = dict(noise=noise, num_paths=8 * lanes, num_bars=w, sigma=0.3, tables=jtables,
              external_uniforms=torch.from_numpy(u), **_kw(sampler))
    args = (0, Levels.from_rows(ROWS, max_levels=8), EngineParams.default(), STOPS, TPS)
    t = cuda_gated.mc_paths_gated_sweep_fused(*args, **kw)
    rows = cuda_gated.gated_sweep_totals_reference(*args, per_path=True, **kw)[2]
    for g in range(2):
        _assert_lifecycle(t, j, 8 * lanes, g, float(rows[g][:, 0].abs().max()))


# four rows that differ in the gate knobs as well as in the paddings and the
# noise stds: (stop, tp, touch_limit, cooldown_bars, level jitter)
GATE_ROWS = [(0.25, 0.35, 4, 0, 0.0), (0.45, 0.15, 4, 2, 0.03), (0.25, 0.35, 2, 0, 0.0),
             (0.35, 0.25, 3, 1, 0.02)]


@pytest.mark.parametrize("sampler", ["bootstrap", "heston"])
def test_plain_gated_sweep_gate_rows_match_the_jax_kernel_interpret(sampler):
    """#6 on four rows that differ in touch_limit and cooldown_bars too, with
    [G] noise stds, on the same uniforms: each row of the plain sweep (the
    oracle of ``mc_gated_sampler_sweep_kernel``, which makes a path's bars
    once for every row) against the JAX sweep kernel in interpret mode, which
    makes them again for each row: counts exact, the histogram within 2F, the
    sums within F x max|equity| (``_assert_lifecycle``)."""
    w, lanes = 8, jPM.GATED_LANES
    jhist, jtables = _jax_history(False)
    u = _uniforms(75, (1, GatedLayout(w, True, sampler).u_rows, 8, lanes))
    stops, tps, limits, cools, jit = (list(c) for c in zip(*GATE_ROWS))
    stds = {k: np.full(len(GATE_ROWS), v, np.float32) for k, v in STDS.items()}
    stds["level_jitter_std"] = np.float32(jit)
    jgate = JGateConfig.from_params(JParams.default())
    jgate = JGateConfig(touch_limit=jnp.int32(limits), q_min_prob=jgate.q_min_prob,
                        cooldown_bars=jnp.int32(cools), touch_gap_bars=jgate.touch_gap_bars,
                        use_confidence=jgate.use_confidence)
    j = jPM.mc_paths_pallas_gated_sweep(
        0, JLevels.from_rows(ROWS, max_levels=8), JParams.default(), np.float32(stops),
        np.float32(tps), jgate, num_paths=8 * lanes, num_bars=w, sigma=0.3, hist_bars=jhist,
        noise=JMcNoise(**{k: jnp.asarray(v) for k, v in stds.items()}), interpret=True,
        external_uniforms=u, **_kw(sampler))
    gate = GateConfig.from_params(EngineParams.default()).replace(
        touch_limit=torch.tensor(limits, dtype=torch.int32),
        cooldown_bars=torch.tensor(cools, dtype=torch.int32))
    noise = McNoise(**{k: torch.from_numpy(v) for k, v in stds.items()})
    kw = dict(noise=noise, num_paths=8 * lanes, num_bars=w, sigma=0.3, tables=jtables,
              external_uniforms=torch.from_numpy(u), **_kw(sampler))
    args = (0, Levels.from_rows(ROWS, max_levels=8), EngineParams.default(), stops, tps, gate)
    t = cuda_gated.mc_paths_gated_sweep_fused(*args, **kw)
    rows = cuda_gated.gated_sweep_totals_reference(*args, per_path=True, **kw)[2]
    for g in range(len(GATE_ROWS)):
        _assert_lifecycle(t, j, 8 * lanes, g, float(rows[g][:, 0].abs().max()))
    # the knobs matter: the touch limit 2 and the cooldown rows trade less
    trades = t.sum_trades.tolist()
    assert trades[2] < trades[0] and trades[1] != trades[0], trades
