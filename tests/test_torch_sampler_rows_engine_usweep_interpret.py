"""The engine's sweep of universes under a sampler (kernel #11) in interpret
mode: the plain version against the JAX kernel on the same injected
uniforms, as ``tests/test_torch_sampler_rows_interpret.py`` sets out."""

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
from qmmx_monolithic_monte_carlo_tpu.ops import pallas_engine as jPE
from qmmx_monolithic_monte_carlo_tpu.parallel import universe as jU
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U

from .test_torch_sampler_rows_interpret import (S0, SIGMA, STOPS, SYM_ROWS, TPS,
                                                _assert_engine, _jax_history, _kw, _uniforms)

torch.set_num_threads(2)


@pytest.mark.parametrize("sampler", ["bootstrap"])
def test_plain_engine_universe_sweep_matches_the_jax_kernel_interpret(sampler):
    """#11: 2 symbols x 2 rows, each symbol on its own history."""
    w, lanes = 8, 128
    jhist, jtables = _jax_history(True)
    u = _uniforms(77, (2, 1, EngineLayout(w, False, sampler).u_rows, 8, lanes))
    j = jPE.mc_paths_pallas_engine_universe_sweep(
        0, jU.stack_levels(SYM_ROWS, max_levels=8),
        JParams.default().replace(stop_padding=np.float32(STOPS), tp_padding=np.float32(TPS)),
        np.float32(S0), np.float32(SIGMA), paths_per_symbol=8 * lanes, num_bars=w, lanes=lanes,
        hist_bars=jhist, interpret=True, external_uniforms=u, **_kw(sampler))
    t = cuda_engine.mc_paths_engine_universe_sweep_fused(
        0, U.stack_levels(SYM_ROWS, max_levels=8),
        EngineParams.default().replace(stop_padding=STOPS, tp_padding=TPS), S0, SIGMA,
        paths_per_symbol=8 * lanes, num_bars=w, lanes=lanes, tables=jtables,
        external_uniforms=torch.from_numpy(u), **_kw(sampler))
    for i in range(2):
        for g in range(2):
            _assert_engine(t, j, 8 * lanes, (i, g))
