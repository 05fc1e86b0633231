"""The engine sweep's sampler rows (kernel #9) in interpret mode: the plain
version against the JAX kernel on the same injected uniforms, as
``tests/test_torch_sampler_rows_interpret.py`` sets out."""

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
from qmmx_monolithic_monte_carlo_tpu.ops import pallas_engine as jPE
from qmmx_monolithic_monte_carlo_tpu.types import Levels as JLevels
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

from .test_torch_sampler_rows_interpret import (ROWS, STOPS, TPS, _assert_engine,
                                                _jax_history, _kw, _uniforms)

torch.set_num_threads(2)


@pytest.mark.parametrize("sampler", ["block_bootstrap"])
def test_plain_engine_sweep_matches_the_jax_kernel_interpret(sampler):
    """#9: two rows of engine knobs on one history's recorded bars."""
    w, lanes = 8, 128
    jhist, jtables = _jax_history(False)
    u = _uniforms(76, (1, EngineLayout(w, False, sampler).u_rows, 8, lanes))
    j = jPE.mc_paths_pallas_engine_sweep(
        0, JLevels.from_rows(ROWS, max_levels=8),
        JParams.default().replace(stop_padding=np.float32(STOPS), tp_padding=np.float32(TPS)),
        num_paths=8 * lanes, num_bars=w, sigma=0.3, lanes=lanes, hist_bars=jhist,
        interpret=True, external_uniforms=u, **_kw(sampler))
    t = cuda_engine.mc_paths_engine_sweep_fused(
        0, Levels.from_rows(ROWS, max_levels=8),
        EngineParams.default().replace(stop_padding=STOPS, tp_padding=TPS),
        num_paths=8 * lanes, num_bars=w, sigma=0.3, lanes=lanes, tables=jtables,
        external_uniforms=torch.from_numpy(u), **_kw(sampler))
    for g in range(2):
        _assert_engine(t, j, 8 * lanes, g)
