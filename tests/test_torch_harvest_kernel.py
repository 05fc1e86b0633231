"""The harvest builds of the engine's envelope kernels on the card
(``ops/csrc/mc_engine_wide*_harvest.cu``): a harvest launch gives the same
lifecycle rows as the launch without it, bit for bit (at a parent's shape
too, where the launch without harvest goes to the parent); its harvest equals
the plain version's as far as the differing paths allow
(``chip_smoke.gap_within``); two runs agree bit for bit; every universe
row and its harvest equal its one-row launch; the book's symbols likewise
against the plain version.  Every test needs a CUDA device and skips without
one; none imports JAX.  The CPU side is ``tests/test_torch_engine_harvest.py``."""

import numpy as np
import pytest
import torch

from chip_smoke import differing_trades, gap_within
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.models import harvest as HV
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine as CE
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

from .test_torch_engine_envelope_kernel import COLORS, LANES, SIGMA, STDS, ladder
from .test_torch_sampler_kernels import TABLES

torch.set_num_threads(2)

THREE = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
         {"color": "orange", "type": "dashed", "index": 0, "price": 100.4},
         {"color": "teal", "type": "solid", "index": 0, "price": 99.7}]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# (levels, W, noise, sampler): the parent's shape, the envelope's, windowed
SHAPES = {"3x40": (3, 40, False, "gbm"), "30x25-noise": (30, 25, True, "gbm"),
          "8x63": (8, 63, False, "gbm"), "30x25-bootstrap": (30, 25, False, "bootstrap"),
          "8x62-heston": (8, 62, True, "heston")}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cuda_harvest_kernel_stats_unchanged_and_harvest_matches_plain(shape):
    dev = _cuda()
    n_lv, w, noisy, sampler = SHAPES[shape]
    levels = (Levels.from_rows(THREE, max_levels=8) if n_lv == 3 else ladder(n_lv))
    kw = dict(num_paths=4 * 8 * LANES, num_bars=w, sigma=SIGMA, lanes=LANES,
              noise=McNoise.make(**STDS) if noisy else None, sampler=sampler,
              tables=TABLES, block_len=5, per_path=True, device=dev)
    p = EngineParams.default()
    base = CE.engine_rows(5, levels, p, **kw)
    name = "mc_engine_wide" + ("" if sampler == "gbm" else "_sampler") + "_harvest"
    before = CE.LAUNCHES[name]
    pc, pf, rows, hc, hs = CE.engine_rows(5, levels, p, harvest=True, **kw)
    torch.cuda.synchronize()
    assert CE.LAUNCHES[name] == before + 1
    for a, b in zip(base, (pc, pf, rows)):
        assert torch.equal(a, b)
    again = CE.engine_rows(5, levels, p, harvest=True, **kw)
    for a, b in zip(again, (pc, pf, rows, hc, hs)):
        assert torch.equal(a, b)
    got = CE.reduce_harvest(hc, hs)
    assert int(got.n_labeled) == int(rows[:, 2].sum() + rows[:, 3].sum()) > 0
    wc, wf, wrows, want = CE.engine_totals_reference(5, levels, p, harvest=True, **kw)
    ok, gap = gap_within(got, want, differing_trades(rows.cpu(), wrows.cpu()))
    assert ok, gap


@pytest.mark.cuda
def test_cuda_harvest_universe_rows_equal_their_one_row_launches():
    dev = _cuda()
    n, w = 4 * 8 * LANES, 40
    s0, sig = np.array([100.0, 50.0, 75.0]), np.array([0.3, 0.4, 0.25])
    lv = U.stack_levels([[{"color": COLORS[i % 4], "type": "solid", "index": 0,
                           "price": float(s0[s]) + (i - 5) * 0.1} for i in range(10)]
                         for s in range(3)], max_levels=10)
    p = EngineParams.default()
    out = CE.engine_universe_rows(4, lv, p, s0, sig, paths_per_symbol=n, num_bars=w,
                                  lanes=LANES, per_path=True, device=dev, harvest=True)
    for s in range(3):
        one = CE.engine_rows(4, Levels(**{k: getattr(lv, k)[s] for k in Levels._DTYPES}),
                             p, num_paths=n, num_bars=w, s0=float(s0[s]), sigma=float(sig[s]),
                             lanes=LANES, per_path=True, device=dev, symbol=s, harvest=True)
        for a, b in zip(out, one):
            assert torch.equal(a[s], b)
    stats, skips, escal, hv = CE.mc_paths_engine_universe_fused(
        4, lv, p, s0, sig, paths_per_symbol=n, num_bars=w, lanes=LANES, device=dev,
        harvest=True)
    assert torch.equal(hv.ml_counts, CE.reduce_harvest(out[3], out[4]).ml_counts)


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["gbm", "block_bootstrap"])
def test_cuda_harvest_book_matches_plain(sampler):
    dev = _cuda()
    s0, sig = np.array([100.0, 60.0, 80.0]), np.array([0.3, 0.35, 0.25])
    beta, wts = np.array([0.5, 0.2, 0.7]), np.array([0.5, 0.3, 0.2])
    lv = U.stack_levels([[{"color": "blue", "type": "solid", "index": 0, "price": float(x)},
                          {"color": "orange", "type": "dashed", "index": 0,
                           "price": float(x) + 0.4}] for x in s0], max_levels=4)
    kw = dict(paths_per_symbol=4 * 8 * LANES, lanes=LANES, sampler=sampler, num_bars=40,
              tables=torch.from_numpy(np.stack(TABLES))[None], block_len=5, per_path=True,
              device=dev)
    p = EngineParams.default()
    base = CE.engine_corr_rows(3, lv, p, s0, sig, beta, wts, **kw)
    pc, pf, rows, hc, hs = CE.engine_corr_rows(3, lv, p, s0, sig, beta, wts, harvest=True, **kw)
    for a, b in zip(base, (pc, pf, rows)):
        assert torch.equal(a, b)
    got = CE.reduce_harvest(hc, hs)
    *_, wrows, want = CE.engine_corr_totals_reference(3, lv, p, s0, sig, beta, wts,
                                                      harvest=True, **kw)
    for s in range(3):
        ok, gap = gap_within(HV.EngineHarvest(*(f[s] for f in got)),
                             HV.EngineHarvest(*(f[s] for f in want)),
                             differing_trades(rows[s].cpu(), wrows[s].cpu()))
        assert ok, (s, gap)
