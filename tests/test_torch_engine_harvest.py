"""The closed-trade label harvest of the port's engine replay held against
the JAX package's: the port's ``engine_path_replay(harvest=True)`` against
JAX's on the same bars and tie coins (counts exact, the float32 sums within
1e-6 relative: x6 = min(1, minutes / 390) is an IEEE division in the port,
``utils/floats.div``), for five of the engine test's configurations and one
envelope shape; every close labeled once; a harvest changes no trade.  The
universe, book, sampler and fused entries are
``tests/test_torch_engine_harvest_rows.py``."""

import jax
import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
from qmmx_monolithic_monte_carlo_tpu.sim import enginepath as jEP
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.models import harvest as HV
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine as CE
from qmmx_monolithic_monte_carlo_tpu_torch.ops import pathgen as PG
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout, MarketLayout
from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import portfolio as PF
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
from qmmx_monolithic_monte_carlo_tpu_torch.sim import enginepath as EP
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

from .test_engine_envelope import _many_levels
from .test_pallas_engine import DT, _bars_from_uniforms
from .test_torch_engine import CONFIGS, JLEVELS, LANES, STDS, JMcNoise, McNoise, _levels
from .test_torch_sampler_kernels import TABLES

torch.set_num_threads(2)

# five of the engine test's configurations (the defaults, the accumulation
# gates, both armed gates letting entries through, execution noise) and one
# envelope shape: 12 levels, the windowed guard (W = 70)
CASES = dict({k: CONFIGS[k] for k in ("defaults", "accumulation", "ml+policy-passing",
                                      "noise")},
             **{"12x70": (0.25, 70, False, True, None)})


def _jax_harvest(h) -> HV.EngineHarvest:
    return HV.EngineHarvest.from_numpy(h)


def assert_harvest_close(got: HV.EngineHarvest, want: HV.EngineHarvest) -> None:
    """Counts exact; sums within 1e-6 relative of the larger entry."""
    assert torch.equal(got.ml_counts, want.ml_counts)
    assert torch.equal(got.pol_counts, want.pol_counts)
    for a, b in ((got.pol_sum_x1, want.pol_sum_x1), (got.pol_sum_x6, want.pol_sum_x6)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(b.abs().max()))


def _port_bars(bars, tie):
    return (PG.PathBars(*(torch.from_numpy(np.array(a)) for a in bars)),
            torch.from_numpy(np.array(tie)))


@pytest.mark.parametrize("name", list(CASES))
def test_replay_harvest_matches_jax(name):
    sigma, w, noisy, esc, maker = CASES[name]
    jkw, tkw = maker() if maker else ({}, {})
    jlv, lv = (JLEVELS, _levels()) if name != "12x70" else (
        _many_levels(12, step=0.1), Levels.from_numpy(
            {k: np.asarray(v) for k, v in vars(_many_levels(12, step=0.1)).items()}))
    rng = np.random.default_rng(31)
    u = rng.uniform(1e-6, 1.0, (EngineLayout(w, noisy).u_rows, 8, LANES)).astype(np.float32)
    built = _bars_from_uniforms(u, sigma, with_noise=noisy, w=w)
    if noisy:
        jkw = dict(jkw, noise=JMcNoise.make(**STDS), noise_normals=built[2])
        tkw = dict(tkw, noise=McNoise.make(**STDS),
                   noise_normals=tuple(torch.from_numpy(np.array(x)) for x in built[2]))
    want = jEP.engine_path_replay(built[0], jlv, JParams.default(), built[1], escalation=esc,
                                  harvest=True, **jkw)
    bars, tie = _port_bars(built[0], built[1])
    got = EP.engine_path_replay(bars, lv, EngineParams.default(), tie, escalation=esc,
                                harvest=True, **tkw)
    assert_harvest_close(got.harvest, _jax_harvest(want.harvest))
    # every closed trade is labeled once; a harvest changes no trade
    assert int(got.harvest.n_labeled) == int(got.wins.sum() + got.losses.sum())
    plain = EP.engine_path_replay(bars, lv, EngineParams.default(), tie, escalation=esc, **tkw)
    assert plain.harvest is None
    for a, b in zip(plain[:-1], got[:-1]):
        assert torch.equal(a, b)
