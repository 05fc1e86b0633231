"""The book sampler kernels on the card (marked ``cuda``, skipped without
one): ``mc_gated_corr_sampler_kernel`` and ``mc_engine_corr_sampler_kernel``
(kernels #7 and #12 under bootstrap, block bootstrap and Heston) against
their plain versions on the card, path by path (the same device's
transcendentals, so equal), on Philox draws and on injected uniforms with
noise; a history swap swaps the kernel's rows; one shared table equals its
copies; the fused entries launch the sampler kernel and the fold once.  No
JAX here, so the file runs on the card's machine; the CPU side of this slice
is ``tests/test_torch_book_samplers.py``."""

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import (EngineLayout, GatedLayout,
                                                             MarketLayout)
from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import universe_tables
from qmmx_monolithic_monte_carlo_tpu_torch.parallel.universe import stack_levels
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise

from .test_torch_sampler_rows_kernel import S0, SIGMAS, STDS, SYM_ROWS, histories

torch.set_num_threads(2)

SAMPLERS = ("bootstrap", "block_bootstrap", "heston")
W = 40
BETAS = [0.8, 0.6, 0.3]
WEIGHTS = [0.5, 0.3, 0.2]
TABLES = universe_tables(histories(9, 3, 600))
FAMILIES = [(cuda_gated, 1024), (cuda_engine, 256)]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _run(mod, lanes, sampler, *, plain, tables=TABLES, n_blocks=2, noise=None, ext=None,
         m_ext=None, levels=None, s0=S0, device):
    """(counts, floats, per-path rows) of the book through the kernel or the
    plain version on ``device``."""
    args = (3, stack_levels(SYM_ROWS, max_levels=8) if levels is None else levels,
            EngineParams.default(), s0, SIGMAS, BETAS, WEIGHTS)
    kw = dict(paths_per_symbol=n_blocks * 8 * lanes, num_bars=W, lanes=lanes, noise=noise,
              external_uniforms=ext, market_uniforms=m_ext, sampler=sampler, tables=tables,
              block_len=10, heston=dict(rho=-0.5) if sampler == "heston" else None,
              device=device, per_path=True)
    if plain:
        ref = (cuda_gated.gated_corr_totals_reference if mod is cuda_gated
               else cuda_engine.engine_corr_totals_reference)
        return ref(*args, **kw)[:3]
    rows = (cuda_gated.gated_corr_rows if mod is cuda_gated else cuda_engine.engine_corr_rows)
    pc, pf, per_path = rows(*args, **kw)
    return (*mod.reduce_rows(pc, pf), per_path)


def _equal(a, b):
    """Counts and every path of every row equal; min, max and drawdown
    exact; the sums within float32 rounding (the kernel adds a CTA's paths
    in float32 before the float64 fold, the plain version in float64)."""
    assert torch.equal(a[0], b[0])                           # counts, the book's too
    assert torch.equal(a[2], b[2])
    assert torch.equal(a[1][:, 3:], b[1][:, 3:])
    torch.testing.assert_close(a[1][:, :3], b[1][:, :3], rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("mod,lanes", FAMILIES)
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_book_sampler_kernel_equals_its_plain_version_on_the_card(mod, lanes, sampler):
    dev = _cuda()
    _equal(_run(mod, lanes, sampler, plain=False, device=dev),
           _run(mod, lanes, sampler, plain=True, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("mod,lanes", FAMILIES)
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_book_sampler_kernel_on_injected_uniforms_with_noise(mod, lanes, sampler):
    """The book layouts' rows (ties on 0/1 under bootstrap, the market's 2 or
    4 rows a step) read alike by the kernel and the plain version."""
    dev = _cuda()
    lay = (GatedLayout if mod is cuda_gated else EngineLayout)(W, True, sampler, book=True)
    rng = np.random.default_rng(31)
    ext = torch.from_numpy(rng.uniform(1e-6, 1.0, (3, 1, lay.u_rows, 8, lanes)).astype(
        np.float32)).to(dev)
    m_ext = torch.from_numpy(rng.uniform(1e-6, 1.0, (1, MarketLayout(W, sampler).u_rows, 8,
                                                      lanes)).astype(np.float32)).to(dev)
    kw = dict(noise=McNoise.make(**STDS), ext=ext, m_ext=m_ext, n_blocks=1, device=dev)
    _equal(_run(mod, lanes, sampler, plain=False, **kw),
           _run(mod, lanes, sampler, plain=True, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("mod,lanes", FAMILIES)
@pytest.mark.parametrize("sampler", ["bootstrap", "block_bootstrap"])
def test_swapping_two_histories_swaps_the_kernels_rows(mod, lanes, sampler):
    """Symbols 0 and 1 alike but for their histories (levels, spot, knobs and
    injected uniforms): swapping the histories swaps their rows bit for bit,
    so the kernel reads each symbol's own table; one shared [1, 5, H] table
    equals its [3, 5, H] copies."""
    dev = _cuda()
    lay = (GatedLayout if mod is cuda_gated else EngineLayout)(W, False, sampler, book=True)
    rng = np.random.default_rng(32)
    ext = torch.from_numpy(rng.uniform(1e-6, 1.0, (1, 1, lay.u_rows, 8, lanes)).astype(
        np.float32)).expand(3, -1, -1, -1, -1).contiguous().to(dev)
    m_ext = torch.from_numpy(rng.uniform(1e-6, 1.0, (1, MarketLayout(W, sampler).u_rows, 8,
                                                      lanes)).astype(np.float32)).to(dev)
    kw = dict(ext=ext, m_ext=m_ext, n_blocks=1, device=dev, s0=[S0[0]] * 3,
              levels=stack_levels([SYM_ROWS[0]] * 3, max_levels=8))
    a = _run(mod, lanes, sampler, plain=False, tables=TABLES, **kw)[2]
    b = _run(mod, lanes, sampler, plain=False, tables=TABLES[[1, 0, 2]], **kw)[2]
    assert torch.equal(a[0], b[1]) and torch.equal(a[1], b[0]) and torch.equal(a[2], b[2])
    assert not torch.equal(a[0], a[1])
    one = _run(mod, lanes, sampler, plain=False, tables=TABLES[:1].to(dev), device=dev)
    copies = _run(mod, lanes, sampler, plain=False,
                  tables=TABLES[:1].expand(3, -1, -1).contiguous(), device=dev)
    assert all(torch.equal(x, y) for x, y in zip(one, copies))


@pytest.mark.cuda
@pytest.mark.parametrize("mod,lanes", FAMILIES)
def test_fused_book_samplers_launch_their_kernel_and_fold_once(mod, lanes):
    dev = _cuda()
    family = "gated" if mod is cuda_gated else "engine"
    fused = (cuda_gated.mc_paths_gated_corr_fused if mod is cuda_gated
             else cuda_engine.mc_paths_engine_corr_fused)
    for sampler in SAMPLERS:
        mod.reset_launches()
        out = fused(0, stack_levels(SYM_ROWS, max_levels=8), EngineParams.default(), S0, SIGMAS,
                    BETAS, WEIGHTS, paths_per_symbol=8 * lanes, num_bars=W, lanes=lanes,
                    sampler=sampler, tables=TABLES, block_len=10)
        torch.cuda.synchronize()
        kernel = "mc_gated_corr_sampler" if mod is cuda_gated else "mc_engine_rows_corr_sampler"
        assert {k: v for k, v in mod.LAUNCHES.items() if v} == {
            kernel: 1, f"mc_{family}_corr_reduce_rows": 1}
        assert float(out[1].n) == 8 * lanes and bool((out[0].n == 8 * lanes).all())
    with pytest.raises(ValueError, match="antithetic"):
        fused(0, stack_levels(SYM_ROWS, max_levels=8), EngineParams.default(), S0, SIGMAS,
              BETAS, WEIGHTS, paths_per_symbol=8 * lanes, num_bars=W, lanes=lanes,
              sampler="heston", antithetic=True)
