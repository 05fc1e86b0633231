"""The first-contact sampler sweep at 18 (stop, tp) rows, the row count that
takes two launches of ``mc_first_contact_sampler_sweep_kernel`` on the card:
the port's plain sweep (``cuda_mc.sweep_totals_reference``, the kernel's
oracle) held against the JAX kernels in interpret mode, under block
bootstrap and Heston, at W = 16.

* Against the JAX sweep kernel ``mc_paths_pallas_sweep`` itself.  It draws
  its own uniforms and takes no injected ones (tests/test_pallas_mc.py:337);
  in interpret mode the TPU PRNG gives zero bits, so every uniform it draws is
  0 x 2^-24 + 1e-12 (``pallas_mc._uniform``) and every path is the same
  path.  The port's plain sweep on uniforms all equal to that value gives
  every row's counts exactly, and its float sums within 1e-6 of the row's
  scale (the two sides' exp and log may part by an ulp).
* On random uniforms, against the JAX single kernel ``mc_paths_pallas`` at
  each row's (stop, tp) (its sweep row g equals it, pallas_mc.py:2008-2012):
  each row's counts within F = 2 + paths/1024 (tests/test_pallas_mc.py:133-146),
  its histogram within 2F.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
from qmmx_monolithic_monte_carlo_tpu.ops import pallas_mc as jPM
from qmmx_monolithic_monte_carlo_tpu.ops import pathgen as jPG
from qmmx_monolithic_monte_carlo_tpu.types import Levels as JLevels
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_mc
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import GbmLayout
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

torch.set_num_threads(2)

W = 16
LANES = 8192
ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "teal", "type": "solid", "index": 0, "price": 99.6}]
# Heston's one path on the interpret PRNG's uniforms climbs from 100 and
# touches 103.9, where the 18 rows part into targets, stops and open trades
HESTON_ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 103.9},
               {"color": "teal", "type": "solid", "index": 0, "price": 99.6}]
STOPS18 = [sp for sp in (0.15, 0.25, 0.35, 0.45, 0.55, 0.65) for _ in range(3)]
TPS18 = [tp for _ in range(6) for tp in (0.15, 0.25, 0.35)]
U_ZERO_BITS = np.float32(0.0 * (1.0 / (1 << 24)) + 1e-12)   # the interpret PRNG's uniform
COUNTS = ("n", "n_entered", "n_tp", "n_stop", "n_open")


def _history(seed: int, h: int):
    """A recorded o/h/l/c/v history (wicks, volume bursts), float32 numpy."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(0, 0.12, h).astype(np.float32)
    c = np.float32(100.0) + np.cumsum(steps, dtype=np.float32)
    o = np.concatenate([c[:1], c[:-1]])
    hi = np.maximum(o, c) + rng.uniform(0, 0.15, h).astype(np.float32)
    lo = np.minimum(o, c) - rng.uniform(0, 0.15, h).astype(np.float32)
    v = rng.lognormal(13.0, 0.5, h).astype(np.float32)
    return [np.ascontiguousarray(x, np.float32) for x in (o, hi, lo, c, v)]


HIST = _history(21, 400)
TABLES = torch.from_numpy(np.stack([np.asarray(t) for t in jPG.bootstrap_tables(*HIST)]))


def _kw(sampler):
    return dict(num_bars=W, sigma=0.3, sampler=sampler, block_len=5)


def _port_sweep(sampler, u, rows):
    """The port's plain sweep at the 18 rows on injected uniforms u."""
    return cuda_mc.mc_paths_sweep_fused(
        0, Levels.from_rows(rows, max_levels=8), EngineParams.default(), STOPS18, TPS18,
        num_paths=u.shape[0] * LANES, tables=TABLES if sampler != "heston" else None,
        external_uniforms=torch.from_numpy(u), device="cpu", **_kw(sampler))


@pytest.mark.parametrize("sampler", ["block_bootstrap", "heston"])
def test_plain_sampler_sweep_at_18_rows_equals_the_jax_sweep_interpret(sampler):
    n, rows = 4 * jPM.LANES, HESTON_ROWS if sampler == "heston" else ROWS
    j = jPM.mc_paths_pallas_sweep(
        0, JLevels.from_rows(rows, max_levels=8), JParams.default(), STOPS18, TPS18,
        num_paths=n, hist_bars=jPG.PathBars(*HIST) if sampler != "heston" else None,
        interpret=pltpu.InterpretParams(), **_kw(sampler))
    u = np.full((n // LANES, GbmLayout(W, False, sampler).n_rows, LANES), U_ZERO_BITS)
    t = _port_sweep(sampler, u, rows)
    for f in COUNTS:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), f)
    np.testing.assert_array_equal(t.hist.numpy(), np.asarray(j.hist))
    # the one path's rows part: targets, stops and open trades
    assert float(t.n_tp.min()) == 0 and float(t.n_stop.max()) == n and float(t.n_tp.max()) == n
    for f in ("sum_r", "sum_r2"):
        want = np.asarray(getattr(j, f), np.float64)
        assert np.abs(getattr(t, f).numpy() - want).max() <= 1e-6 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("sampler", ["block_bootstrap", "heston"])
def test_plain_sampler_sweep_at_18_rows_matches_the_jax_rows_interpret(sampler):
    u = np.random.default_rng(73).uniform(
        1e-9, 1.0, (1, GbmLayout(W, False, sampler).n_rows, LANES)).astype(np.float32)
    t = _port_sweep(sampler, u, ROWS)
    assert float(t.n_entered[0]) > LANES / 4
    f = 2 + LANES // 1024
    for g, (sp, tp) in enumerate(zip(STOPS18, TPS18)):
        j = jPM.mc_paths_pallas(
            0, JLevels.from_rows(ROWS, max_levels=8),
            JParams.default().replace(stop_padding=sp, tp_padding=tp), num_paths=LANES,
            hist_bars=jPG.PathBars(*HIST) if sampler != "heston" else None, interpret=True,
            external_uniforms=u, **_kw(sampler))
        row = t.row(g)
        assert float(row.n) == float(np.asarray(j.n)) == LANES
        for c in COUNTS[1:]:
            assert abs(float(getattr(row, c)) - float(np.asarray(getattr(j, c)))) <= f, (g, c)
        assert float(np.abs(row.hist.numpy() - np.asarray(j.hist)).sum()) <= 2 * f, g
