"""The engine book's samplers (kernel #12 under bootstrap, block bootstrap and
Heston) in interpret mode: the port's plain version against the JAX kernel
``mc_paths_pallas_engine_corr`` on the same injected uniforms, market rows
and JAX's own per-symbol bootstrap tables (each symbol's recorded volumes
into its volume gates), as ``tests/test_torch_book_samplers_gated_
interpret.py`` sets out: 2 symbols on their own 300-bar histories, 8 bars,
lanes 128.  Each symbol's counts, skip table and escalations exact, its
histogram within 2F; the book's trade counts exact, its histogram and sums
within the gated file's rule."""

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

from .test_torch_book_samplers_gated_interpret import (BETAS, LANES, N, W, WEIGHTS, assert_book,
                                                       book_uniforms)
from .test_torch_sampler_rows_interpret import S0, SIGMA, SYM_ROWS, _assert_engine, _jax_history, _kw

torch.set_num_threads(2)


@pytest.mark.parametrize("sampler", ["bootstrap", "block_bootstrap", "heston"])
def test_plain_engine_book_samplers_match_the_jax_kernel_interpret(sampler):
    jhist, jtables = _jax_history(True)
    u, um = book_uniforms(95 + len(sampler), EngineLayout(W, False, sampler, book=True), sampler)
    jsym, jport, jskips, jescal = jPE.mc_paths_pallas_engine_corr(
        0, jU.stack_levels(SYM_ROWS, max_levels=8), JParams.default(), np.float32(S0),
        np.float32(SIGMA), BETAS, WEIGHTS, paths_per_symbol=N, num_bars=W, lanes=LANES,
        hist_bars=jhist, interpret=True, external_uniforms=u, market_uniforms=um,
        **_kw(sampler))
    args = (0, U.stack_levels(SYM_ROWS, max_levels=8), EngineParams.default(), S0, SIGMA,
            BETAS, WEIGHTS)
    kw = dict(paths_per_symbol=N, num_bars=W, lanes=LANES, tables=jtables,
              external_uniforms=torch.from_numpy(u), market_uniforms=torch.from_numpy(um),
              **_kw(sampler))
    sym, port, skips, escal = cuda_engine.mc_paths_engine_corr_fused(*args, **kw)
    rows = cuda_engine.engine_corr_totals_reference(*args, per_path=True, **kw)[2]
    for i in range(2):
        _assert_engine((sym, skips, escal), (jsym, jskips, jescal), N, i)
    assert_book(port, jport, N, float(rows[2][:, 0].abs().max()))
    assert float(port.n_entered) > 0 and not torch.equal(rows[0], rows[1])
    if sampler != "heston":            # the recorded volumes reach the volume veto
        assert int(skips[:, 11:13].sum()) > 0
