"""The gated book's samplers (kernel #7 under bootstrap, block bootstrap and
Heston) in interpret mode: the port's plain version against the JAX kernel
``mc_paths_pallas_gated_corr`` on the same injected uniforms, market rows and
JAX's own per-symbol bootstrap tables, as ``tests/test_torch_sampler_rows_
interpret.py`` sets out: 2 symbols, each on its own 300-bar history, 8 bars,
lanes 128 (1024 paths a symbol).  Each symbol's counts exact, its histogram
within 2F (F = 2 + paths/1024: PyTorch's expf against XLA's may move an
equity across a bin edge) and its sums within F x max|equity|; the book's
trade counts exact, its histogram and sums under the same rule (its final R
is a weighted sum of the symbols' equities, binned again).  The engine's
counterpart is ``tests/test_torch_book_samplers_engine_interpret.py``."""

import jax
import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
from qmmx_monolithic_monte_carlo_tpu.ops import pallas_mc as jPM
from qmmx_monolithic_monte_carlo_tpu.parallel import universe as jU
from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise as JMcNoise
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_gated
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import GatedLayout, MarketLayout
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise

from .test_torch_sampler_rows_interpret import (COUNTS, S0, SIGMA, STDS, SYM_ROWS, _assert_lifecycle,
                                                _flips, _jax_history, _kw, _uniforms)

torch.set_num_threads(2)

W, LANES = 8, 128
N = 8 * LANES
BETAS = np.float32([0.8, 0.6])
WEIGHTS = np.float32([0.5, 0.5])


def book_uniforms(seed: int, layout, sampler: str):
    """Injected uniforms of a 2-symbol book of one block: the symbols' and
    the market's (``ops/draws.MarketLayout``)."""
    u = _uniforms(seed, (2, 1, layout.u_rows, 8, LANES))
    um = _uniforms(seed + 1, (1, MarketLayout(W, sampler).u_rows, 8, LANES))
    return u, um


def assert_book(t, j, n: int, max_eq: float) -> None:
    """The book's row: its trade counts exact, its histogram within 2F, its
    sums within F x max|R|."""
    for f in COUNTS:
        assert float(getattr(t, f)) == float(np.asarray(getattr(j, f))), f
    f = _flips(n)
    assert float(np.abs(t.hist.numpy() - np.asarray(j.hist)).sum()) <= 2 * f
    for fld in ("sum_r", "sum_dd"):
        assert abs(float(getattr(t, fld)) - float(np.asarray(getattr(j, fld)))) <= f * max_eq


@pytest.mark.parametrize("sampler,noisy", [("bootstrap", False), ("block_bootstrap", True),
                                           ("heston", False)])
def test_plain_gated_book_samplers_match_the_jax_kernel_interpret(sampler, noisy):
    jhist, jtables = _jax_history(True)
    u, um = book_uniforms(90 + len(sampler), GatedLayout(W, noisy, sampler, book=True), sampler)
    jsym, jport = jPM.mc_paths_pallas_gated_corr(
        0, jU.stack_levels(SYM_ROWS, max_levels=8), JParams.default(), np.float32(S0),
        np.float32(SIGMA), BETAS, WEIGHTS, paths_per_symbol=N, num_bars=W, lanes=LANES,
        hist_bars=jhist, noise=JMcNoise.make(**STDS) if noisy else None, interpret=True,
        external_uniforms=u, market_uniforms=um, **_kw(sampler))
    args = (0, U.stack_levels(SYM_ROWS, max_levels=8), EngineParams.default(), S0, SIGMA,
            BETAS, WEIGHTS)
    kw = dict(paths_per_symbol=N, num_bars=W, lanes=LANES, tables=jtables,
              noise=McNoise.make(**STDS) if noisy else None,
              external_uniforms=torch.from_numpy(u), market_uniforms=torch.from_numpy(um),
              **_kw(sampler))
    sym, port = cuda_gated.mc_paths_gated_corr_fused(*args, **kw)
    rows = cuda_gated.gated_corr_totals_reference(*args, per_path=True, **kw)[2]
    for i in range(2):
        _assert_lifecycle(sym, jsym, N, i, float(rows[i][:, 0].abs().max()))
    assert_book(port, jport, N, float(rows[2][:, 0].abs().max()))
    assert float(port.sum_trades) > float(port.n_entered) > 0
    # each symbol on its own history: the two symbols' rows differ
    assert not torch.equal(rows[0], rows[1])
    assert jax.tree_util.tree_map(lambda x: x.shape, jsym).n == (2,)
