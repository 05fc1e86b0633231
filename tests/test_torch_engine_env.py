"""The redesigned envelope kernels (``mc_engine_wide_kernel``,
``mc_engine_wide_sampler_kernel``, the books' ``mc_engine_wide_corr_kernel``
and their harvest builds, ``ops/csrc/mc_engine_env.cuh``): their flags and
contact counts in dynamic shared memory, sized by the launch's level count
(``cuda_engine.env_smem_bytes``), their touch registers and the windowed
guard's rings in a device scratch of the resident threads.

On the CPU: the shared memory for 1-64 levels, with and without the guard,
fits an SM (227 KB a CTA with the kernels' static shared memory, three CTAs
of 256 an SM; the books with their own static shared memory at their
``__launch_bounds__``) and the scratch's slots.  Marked ``cuda`` (skipped
without a card; no JAX): at 30 levels x 390 bars each kernel against its
plain version path by path, its harvest build's rows equal to the launch
without it, a sweep's rows equal to their one-row launches; the four book
builds at 30 x 390 against their plain versions, their harvest builds' rows
equal to the launches without them, and forced at 3 levels x 40 bars equal
to the parent book kernels bit for bit."""

import math

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine as CE
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout
from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise

from .test_torch_engine_envelope_kernel import LANES, SIGMA, STDS, ladder
from .test_torch_sampler_kernels import TABLES

torch.set_num_threads(2)

@pytest.mark.parametrize("num_bars", [40, 390])
def test_env_shared_memory_and_scratch_fit_at_every_level_count(num_bars):
    """1-64 levels: a CTA of 256 threads (whole warps) whose dynamic shared
    memory (the level table and env_thread_bytes a thread) and the kernels'
    static bound fit 227 KB, three CTAs an SM (228 KB, 1 KB reserved a CTA:
    768 threads, the gbm kernels' register bound); the guard (W > 61) adds
    no shared memory but 122 scratch slots a thread."""
    assert CE.ENV_THREADS % 32 == 0
    prev = 0
    for n in range(1, CE.MAX_ENGINE_LEVELS + 1):
        per_thread = CE.env_thread_bytes(n)
        smem = CE.env_smem_bytes(n)
        assert smem == 16 * n + CE.ENV_THREADS * per_thread, n
        assert smem + CE.ENV_STATIC_MAX <= 227 * 1024, n
        assert 3 * (smem + CE.ENV_STATIC_MAX + 1024) <= 228 * 1024, n
        assert per_thread > prev
        prev = per_thread
        assert CE.env_scratch_slots(n, num_bars) == 4 * n + (122 if num_bars > 61 else 0), n
    # the desk's 30 levels: 172 bytes a thread; 64 levels: 252
    assert CE.env_thread_bytes(30) == 172 and CE.env_thread_bytes(64) == 252


@pytest.mark.parametrize("num_bars", [40, 390])
@pytest.mark.parametrize("harvest", [False, True])
def test_env_book_shared_memory_and_scratch_fit_at_every_level_count(harvest, num_bars):
    """The books at 1-64 levels, with and without the harvest: their own
    static shared memory (the symbol's EngineArgs, SamplerArgs and (beta,
    weight), the row sums, the harvest's tallies) within the launch's check;
    a CTA's dynamic and static shared memory within 227 KB, and at least
    three CTAs an SM (228 KB, 1 KB reserved a CTA), the __launch_bounds__'
    CTAs at the desk's 30 levels; the scratch holds the threads those CTAs
    bring, 4 slots a level and, past 61 bars, 122 more."""
    bound = CE.ENV_BOOK_MIN_BLOCKS
    assert bound * CE.ENV_THREADS <= CE._ENV_SCRATCH_THREADS_SM
    static = CE.env_book_static_bytes(harvest)
    assert static <= CE.ENV_STATIC_MAX
    for n in range(1, CE.MAX_ENGINE_LEVELS + 1):
        smem = CE.env_smem_bytes(n)
        assert smem + static <= 227 * 1024, n
        per_sm = 228 * 1024 // (smem + static + 1024)
        assert per_sm >= 3, n
        if n <= 40:
            assert per_sm >= bound, n
        assert CE.env_scratch_slots(n, num_bars) == 4 * n + (122 if num_bars > 61 else 0)
    # the harvest adds its tallies (72 x 8 bytes) and warp sums (16 x 8 x 4)
    assert CE.env_book_static_bytes(True) - CE.env_book_static_bytes(False) == 576 + 512


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _within_budget(got, want, n_paths, w):
    """Paths whose trades differ and paths whose first-fail reasons alone
    differ, each within F = 2 + paths / 1024 x ceil(W / 40)."""
    flips = 2 + n_paths // 1024 * math.ceil(w / 40)
    err = (got[:, [0, 5]] - want[:, [0, 5]]).abs().amax(dim=1)
    trades = ((got[:, [1, 2, 3, 4, 6]] != want[:, [1, 2, 3, 4, 6]]).any(dim=1)
              | (err > 1e-3 * torch.clamp(want[:, 1], min=1.0)))
    reasons = (got[:, 7:] != want[:, 7:]).any(dim=1) & ~trades
    assert int(trades.sum()) <= flips and int(reasons.sum()) <= flips


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["gbm", "bootstrap", "heston"])
def test_cuda_env_kernels_match_plain_at_30_levels_390_bars(sampler):
    """30 levels x 390 bars (the windowed guard), injected uniforms: the
    kernel on the card against the plain version on CPU copies path by path
    within the flip budgets; Philox: against the plain version on the card,
    equal on every path; the harvest build's partial and per-path rows equal
    the launch without it."""
    dev = _cuda()
    w, nb = 390, 1
    lay = EngineLayout(w, sampler == "gbm", sampler)
    u = torch.from_numpy(np.random.default_rng(30).uniform(
        1e-6, 1.0, (nb, lay.u_rows, 8, LANES)).astype(np.float32))
    kw = dict(num_paths=nb * 8 * LANES, num_bars=w, sigma=SIGMA, lanes=LANES,
              noise=McNoise.make(**STDS) if sampler == "gbm" else None,
              antithetic=sampler == "gbm", sampler=sampler, tables=TABLES, block_len=5,
              per_path=True)
    levels, p = ladder(30), EngineParams.default()
    want = CE.engine_totals_reference(0, levels, p, external_uniforms=u, **kw)
    name = "mc_engine_wide" + ("" if sampler == "gbm" else "_sampler")
    before = CE.LAUNCHES[name]
    pc, pf, rows = CE.engine_rows(0, levels, p, external_uniforms=u.to(dev), device=dev, **kw)
    counts, _ = CE.reduce_rows(pc, pf)
    torch.cuda.synchronize()
    assert CE.LAUNCHES[name] == before + 1
    assert int(counts[0]) == kw["num_paths"] and int(counts[5]) > 0
    _within_budget(rows.cpu(), want[2], kw["num_paths"], w)
    kw.pop("antithetic")
    want = CE.engine_totals_reference(5, levels, p, device=dev, **kw)
    pc, pf, rows = CE.engine_rows(5, levels, p, device=dev, **kw)
    assert torch.equal(rows.cpu(), want[2].cpu())
    *h_rows, hc, hs = CE.engine_rows(5, levels, p, device=dev, harvest=True, **kw)
    for a, b in zip((pc, pf, rows), h_rows):
        assert torch.equal(a, b)
    counts, _ = CE.reduce_rows(pc, pf)
    assert int(CE.reduce_harvest(hc, hs).n_labeled) == int(counts[2] + counts[3])


@pytest.mark.cuda
def test_cuda_env_sweep_rows_equal_their_one_row_launches_at_390_bars():
    """30 levels x 390 bars: each row of a 3-row sweep (noise stds on the
    grid) equals its one-row launch, per path included, whatever cells the
    persistent CTAs took."""
    dev = _cuda()
    n, w = 4 * 8 * LANES, 390
    noise = McNoise(level_jitter_std=torch.tensor([0.0, 0.02, 0.0]),
                    entry_slip_std=torch.tensor(0.01), stop_slip_std=torch.tensor(0.015),
                    target_slip_std=torch.tensor(0.015))
    grid = EngineParams.default().replace(stop_padding=[0.25, 0.35, 0.45])
    kw = dict(num_paths=n, num_bars=w, sigma=SIGMA, lanes=LANES, per_path=True, device=dev)
    pc, pf, rows = CE.engine_sweep_rows(1, ladder(30), grid, noise=noise, **kw)
    for g in range(3):
        one = CE.engine_rows(1, ladder(30), grid_row(grid, g), noise=grid_row(noise, g), **kw)
        assert torch.equal(pc[g], one[0]) and torch.equal(pf[g], one[1])
        assert torch.equal(rows[g], one[2])


def _book(n_levels):
    """Two symbols on their own ladders of ``n_levels`` levels around their
    spots, with betas and weights."""
    s0 = np.array([100.0, 60.0])
    lv = U.stack_levels([[{"color": ("blue", "orange", "black", "teal")[i % 4],
                           "type": "solid" if (i // 4) % 2 == 0 else "dashed", "index": i // 8,
                           "price": float(s0[s]) + (i - n_levels // 2) * 0.12}
                          for i in range(n_levels)] for s in range(2)], max_levels=n_levels)
    return (lv, EngineParams.default(), s0, np.array([0.3, 0.35]), np.array([0.5, 0.2]),
            np.array([0.6, 0.4]))


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["gbm", "bootstrap", "block_bootstrap", "heston"])
def test_cuda_env_books_at_30_levels_390_bars(sampler, monkeypatch):
    """The book kernels on mc_engine_env.cuh's state (gbm with noise and
    antithetic pairs, the three samplers): a 2-symbol book at 30 levels x
    390 bars on Philox against the plain version on the card, every symbol
    and the book path by path within the engine's budgets; the harvest
    build's partial and per-path rows equal to the launch without it; forced
    at 3 levels x 40 bars, every symbol, the book and every path's row equal
    to the parent book kernel's bit for bit."""
    dev = _cuda()
    w, n = 390, 8 * 8 * LANES
    kw = dict(paths_per_symbol=n, lanes=LANES, sampler=sampler,
              tables=torch.from_numpy(np.stack(TABLES))[None], block_len=5, per_path=True,
              noise=McNoise.make(**STDS) if sampler == "gbm" else None,
              antithetic=sampler == "gbm", device=dev)
    want = CE.engine_corr_totals_reference(2, *_book(30), num_bars=w, **kw)
    name = "mc_engine_wide_corr" + ("" if sampler == "gbm" else "_sampler")
    before = CE.LAUNCHES[name]
    pc, pf, rows = CE.engine_corr_rows(2, *_book(30), num_bars=w, **kw)
    torch.cuda.synchronize()
    assert CE.LAUNCHES[name] == before + 1
    counts, _ = CE.reduce_rows(pc, pf)
    assert (counts[:, 0] == n).all() and int(counts[:2, 5].sum()) > 0
    for s in range(3):
        _within_budget(rows[s].cpu(), want[2][s].cpu(), n, w)
    *h_rows, hc, hs = CE.engine_corr_rows(2, *_book(30), num_bars=w, harvest=True, **kw)
    assert CE.LAUNCHES[name + "_harvest"] >= 1
    for a, b in zip((pc, pf, rows), h_rows):
        assert torch.equal(a, b)
    assert int(CE.reduce_harvest(hc, hs).n_labeled.sum()) == int(counts[:2, 2].sum()
                                                                 + counts[:2, 3].sum())
    parent = CE.engine_corr_rows(2, *_book(3), num_bars=40, **kw)
    monkeypatch.setattr(CE, "_FORCE_ENVELOPE", True)
    before = CE.LAUNCHES[name]
    forced = CE.engine_corr_rows(2, *_book(3), num_bars=40, **kw)
    assert CE.LAUNCHES[name] == before + 1
    for a, b in zip(parent, forced):
        assert torch.equal(a, b)
