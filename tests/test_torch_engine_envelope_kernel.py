"""The engine's envelope kernels on the card (``ops/csrc/mc_engine_wide*.cu``):
each held against its plain version path by path at the envelope's shapes
(9-64 levels, the mask edges 17 and 33, odd W, W past 61 under the windowed
guard), every sweep and universe row against its one-row launch, and each,
forced to run where its parent fits (<= 8 levels, an even W <= 61), equal to
the parent kernel bit for bit.  Every test needs a CUDA device and skips
without one; none imports JAX.  The CPU side (the plain version against the
JAX package) is ``tests/test_torch_engine_envelope.py``."""

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine as CE
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout, MarketLayout
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

from .test_torch_sampler_kernels import TABLES

torch.set_num_threads(2)

LANES = 256
SIGMA = 0.3
STDS = dict(level_jitter_std=0.02, entry_slip_std=0.01, stop_slip_std=0.015,
            target_slip_std=0.015)
COLORS = ("blue", "orange", "black", "teal")


def ladder(n, base=100.0, step=0.12):
    """tests/test_engine_envelope.py's n-level ladder (four colours x
    solid/dashed around base)."""
    return Levels.from_rows([{"color": COLORS[i % 4],
                              "type": "solid" if (i // 4) % 2 == 0 else "dashed",
                              "index": i // 8, "price": base + (i - n // 2) * step}
                             for i in range(n)], max_levels=n)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _uniforms(seed, layout, nb, lanes=LANES):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        1e-6, 1.0, (nb, layout.u_rows, 8, lanes)).astype(np.float32))


def _differ(got, want):
    """(paths whose trades differ, paths whose first-fail reasons alone do)."""
    err = (got[:, [0, 5]] - want[:, [0, 5]]).abs().amax(dim=1)
    trades = ((got[:, [1, 2, 3, 4, 6]] != want[:, [1, 2, 3, 4, 6]]).any(dim=1)
              | (err > 1e-3 * torch.clamp(want[:, 1], min=1.0)))
    reasons = (got[:, 7:] != want[:, 7:]).any(dim=1) & ~trades
    return int(trades.sum()), int(reasons.sum())


def _within_budget(got, want, n_paths):
    flips = 2 + n_paths // 1024
    trades, reasons = _differ(got, want)
    assert trades <= flips and reasons <= flips, (trades, reasons, flips)


# (levels, W, noise, antithetic, sampler)
SHAPES = {"30x40": (30, 40, False, False, "gbm"),
          "64x16": (64, 16, False, False, "gbm"),
          "8x62": (8, 62, False, False, "gbm"),
          "8x63-noise-anti": (8, 63, True, True, "gbm"),
          "3x25": (3, 25, False, False, "gbm"),
          "17x24": (17, 24, True, False, "gbm"),
          "33x24": (33, 24, False, False, "gbm"),
          "30x25-bootstrap": (30, 25, True, False, "bootstrap"),
          "30x62-block": (30, 62, False, False, "block_bootstrap"),
          "30x25-heston": (30, 25, True, False, "heston"),
          "8x63-heston": (8, 63, False, False, "heston")}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cuda_envelope_kernel_matches_plain_per_path(shape):
    """Injected uniforms: the envelope kernel on the card against the plain
    version on the CPU, path by path within the engine's two flip budgets
    (CUDA's transcendentals against PyTorch's); the launch goes to the
    envelope kernel."""
    dev = _cuda()
    n_lv, w, noisy, anti, sampler = SHAPES[shape]
    lay = EngineLayout(w, noisy, sampler)
    nb = 2
    u = _uniforms(len(shape), lay, nb)
    kw = dict(num_paths=nb * 8 * LANES, num_bars=w, sigma=SIGMA, lanes=LANES,
              noise=McNoise.make(**STDS) if noisy else None, antithetic=anti,
              sampler=sampler, tables=TABLES, block_len=5, per_path=True)
    levels = ladder(n_lv)
    want = CE.engine_totals_reference(0, levels, EngineParams.default(),
                                      external_uniforms=u, **kw)
    name = "mc_engine_wide" + ("" if sampler == "gbm" else "_sampler")
    before = CE.LAUNCHES[name]
    pc, pf, rows = CE.engine_rows(0, levels, EngineParams.default(),
                                  external_uniforms=u.to(dev), device=dev, **kw)
    counts, _ = CE.reduce_rows(pc, pf)
    torch.cuda.synchronize()
    assert CE.LAUNCHES[name] == before + 1
    assert int(counts[0]) == kw["num_paths"] and int(counts[5]) > 0
    _within_budget(rows.cpu(), want[2], kw["num_paths"])
    # Philox: the plain version on the card
    want = CE.engine_totals_reference(5, levels, EngineParams.default(), device=dev, **kw)
    pc, pf, rows = CE.engine_rows(5, levels, EngineParams.default(), device=dev, **kw)
    _within_budget(rows.cpu(), want[2].cpu(), kw["num_paths"])


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["gbm", "bootstrap", "heston"])
def test_cuda_envelope_kernel_equals_the_parent_where_both_fit(sampler, monkeypatch):
    """At 3 levels and W = 40 the envelope kernel (forced) and the parent
    give the same partial rows and per-path rows, bit for bit."""
    dev = _cuda()
    kw = dict(num_paths=16 * 8 * LANES, num_bars=40, sigma=SIGMA, lanes=LANES,
              noise=McNoise.make(**STDS), sampler=sampler, tables=TABLES, block_len=5,
              per_path=True, device=dev)
    levels = Levels.from_rows([{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
                               {"color": "orange", "type": "dashed", "index": 0,
                                "price": 100.4},
                               {"color": "teal", "type": "solid", "index": 0, "price": 99.7}],
                              max_levels=8)
    parent = CE.engine_rows(2, levels, EngineParams.default(), **kw)
    monkeypatch.setattr(CE, "_FORCE_ENVELOPE", True)
    wide = CE.engine_rows(2, levels, EngineParams.default(), **kw)
    for a, b in zip(parent, wide):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_envelope_sweep_and_universe_rows_equal_their_one_row_launches():
    """30 levels x W = 25: each row of a sweep (noise stds on the grid) and
    each symbol of a universe (its own 30-level ladder) equals its one-row
    launch, per path included."""
    dev = _cuda()
    w, n = 25, 8 * 8 * LANES
    noise = McNoise(level_jitter_std=torch.tensor([0.0, 0.02]),
                    entry_slip_std=torch.tensor(0.01), stop_slip_std=torch.tensor(0.015),
                    target_slip_std=torch.tensor(0.015))
    grid = EngineParams.default().replace(stop_padding=[0.25, 0.35])
    levels = ladder(30)
    kw = dict(num_paths=n, num_bars=w, sigma=SIGMA, lanes=LANES, per_path=True, device=dev)
    pc, pf, rows = CE.engine_sweep_rows(1, levels, grid, noise=noise, **kw)
    for g in range(2):
        one = CE.engine_rows(1, levels, grid.replace(stop_padding=[0.25, 0.35][g]),
                             noise=McNoise.make(level_jitter_std=[0.0, 0.02][g],
                                                entry_slip_std=0.01, stop_slip_std=0.015,
                                                target_slip_std=0.015), **kw)
        assert torch.equal(rows[g], one[2]) and torch.equal(pc[g], one[0])
    s0 = np.array([100.0, 50.0, 75.0])
    sig = np.array([0.3, 0.4, 0.25])
    lv = U.stack_levels([[{"color": COLORS[i % 4], "type": "solid", "index": 0,
                           "price": float(s0[s]) + (i - 15) * 0.1} for i in range(30)]
                         for s in range(3)], max_levels=30)
    ukw = dict(paths_per_symbol=n, num_bars=w, lanes=LANES, per_path=True, device=dev)
    pc, pf, rows = CE.engine_universe_rows(4, lv, EngineParams.default(), s0, sig, **ukw)
    for s in range(3):
        one = CE.engine_rows(4, Levels(**{k: getattr(lv, k)[s] for k in Levels._DTYPES}),
                             EngineParams.default(), num_paths=n, num_bars=w, s0=float(s0[s]),
                             sigma=float(sig[s]), lanes=LANES, per_path=True, device=dev,
                             symbol=s)
        assert torch.equal(rows[s], one[2]) and torch.equal(pc[s], one[0])


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["gbm", "block_bootstrap", "heston"])
def test_cuda_envelope_book_matches_plain_and_its_parent(sampler, monkeypatch):
    """The envelope book kernel at 30 levels x W = 62 against the plain
    version on the card, path by path (symbols and the book); forced at 2
    levels x W = 40, equal to the parent book kernel bit for bit."""
    dev = _cuda()
    s0 = np.array([100.0, 60.0, 80.0])
    sig = np.array([0.3, 0.35, 0.25])
    beta, wts = np.array([0.5, 0.2, 0.7]), np.array([0.5, 0.3, 0.2])
    lv = U.stack_levels([[{"color": COLORS[i % 4], "type": "solid", "index": 0,
                           "price": float(s0[s]) + (i - 15) * 0.1} for i in range(30)]
                         for s in range(3)], max_levels=30)
    kw = dict(paths_per_symbol=8 * 8 * LANES, lanes=LANES, sampler=sampler,
              tables=torch.from_numpy(np.stack(TABLES))[None], block_len=5, per_path=True,
              device=dev)
    want = CE.engine_corr_totals_reference(3, lv, EngineParams.default(), s0, sig, beta, wts,
                                           num_bars=62, **kw)
    name = "mc_engine_wide_corr" + ("" if sampler == "gbm" else "_sampler")
    before = CE.LAUNCHES[name]
    pc, pf, rows = CE.engine_corr_rows(3, lv, EngineParams.default(), s0, sig, beta, wts,
                                       num_bars=62, **kw)
    torch.cuda.synchronize()
    assert CE.LAUNCHES[name] == before + 1
    for s in range(4):
        _within_budget(rows[s].cpu(), want[2][s].cpu(), kw["paths_per_symbol"])
    two = U.stack_levels([[{"color": "blue", "type": "solid", "index": 0, "price": float(x)},
                           {"color": "orange", "type": "dashed", "index": 0,
                            "price": float(x) + 0.4}] for x in s0], max_levels=4)
    parent = CE.engine_corr_rows(3, two, EngineParams.default(), s0, sig, beta, wts,
                                 num_bars=40, **kw)
    monkeypatch.setattr(CE, "_FORCE_ENVELOPE", True)
    wide = CE.engine_corr_rows(3, two, EngineParams.default(), s0, sig, beta, wts,
                               num_bars=40, **kw)
    for a, b in zip(parent, wide):
        assert torch.equal(a, b)


def test_market_layout_stays_even():
    """A book's market rows walk double bars: an odd W is refused."""
    with pytest.raises(ValueError, match="even"):
        MarketLayout(25)
