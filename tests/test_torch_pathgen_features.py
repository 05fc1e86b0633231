"""Port pathgen / features / hitscan held against the JAX package on the
same inputs (JAX's own draws; numpy-made bars and levels)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.ops import features as jF
from qmmx_monolithic_monte_carlo_tpu.ops import hitscan as jH
from qmmx_monolithic_monte_carlo_tpu.ops import pathgen as jPG
from qmmx_monolithic_monte_carlo_tpu.types import Levels as JLevels
from qmmx_monolithic_monte_carlo_tpu.utils import prng as jprng
from qmmx_monolithic_monte_carlo_tpu_torch.ops import features as F
from qmmx_monolithic_monte_carlo_tpu_torch.ops import hitscan as H
from qmmx_monolithic_monte_carlo_tpu_torch.ops import pathgen as PG
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

torch.set_num_threads(2)


@pytest.mark.parametrize("num_bars,antithetic,s0,sigma", [
    (40, False, 100.0, 0.3), (24, True, 100.0, 0.15), (10, False, 412.37, 0.6)])
def test_gbm_bars_from_jax_draws_match_jax_gbm_paths(num_bars, antithetic, s0,
                                                     sigma):
    key = jax.random.key(3)
    n = 512
    want = jPG.gbm_paths(key, num_paths=n, num_bars=num_bars, s0=s0,
                         sigma=sigma, antithetic=antithetic)
    n_draw = n // 2 if antithetic else n
    z = jax.random.normal(jprng.key_for(key, jprng.STREAM_PATH),
                          (n_draw, num_bars), jnp.float32)
    if antithetic:
        z = jnp.concatenate([z, -z], axis=0)

    def u(stream):
        return np.asarray(jax.random.uniform(jprng.key_for(key, stream),
                                             (n, num_bars), jnp.float32,
                                             1e-12, 1.0))

    got = PG.gbm_bars_from_draws(
        torch.from_numpy(np.asarray(z)), torch.from_numpy(u(jprng.STREAM_BRIDGE_HI)),
        torch.from_numpy(u(jprng.STREAM_BRIDGE_LO)), s0=s0, sigma=sigma)
    for f in ("open", "high", "low", "close"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   err_msg=f)


def test_gbm_paths_shapes_antithetic_and_volume():
    p = PG.gbm_paths(5, 2, num_paths=256, num_bars=12, s0=100.0, sigma=0.3,
                     antithetic=True)
    for f in p:
        assert f.shape == (256, 12) and bool(torch.isfinite(f).all())
    assert bool((p.high >= torch.maximum(p.open, p.close) * (1 - 1e-6)).all())
    assert bool((p.low <= torch.minimum(p.open, p.close) * (1 + 1e-6)).all())
    assert bool((p.volume >= 0.05 * PG.VolumeModel().base).all())
    # antithetic: the log-returns of the two halves are mirror images
    lr = torch.log(p.close / p.open)
    drift = float(PG.gbm_consts(100.0, 0.0, 0.3, 1.0 / (390.0 * 252.0))[0])
    np.testing.assert_allclose((lr[:128] - drift).numpy(),
                               -(lr[128:] - drift).numpy(), atol=2e-6)
    again = PG.gbm_paths(5, 2, num_paths=256, num_bars=12, s0=100.0, sigma=0.3,
                         antithetic=True)
    assert all(torch.equal(a, b) for a, b in zip(p, again))


def test_cumsum_f32_is_serial_float32():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(7, 33))
                         .astype(np.float32))
    want = np.zeros_like(x.numpy())
    acc = np.zeros(7, np.float32)
    for k in range(33):
        acc = acc + x.numpy()[:, k]
        want[:, k] = acc
    np.testing.assert_array_equal(PG.cumsum_f32(x).numpy(), want)


def _levels_pair(prices, valid, max_levels=8):
    rows = [{"color": "blue", "type": "solid", "index": i, "price": p}
            for i, p in enumerate(prices)]
    jl = JLevels.from_rows(rows, max_levels=max_levels)
    d = {k: np.asarray(v) for k, v in vars(jl).items()}
    d["valid"] = d["valid"] & np.asarray(valid + [False] * (max_levels - len(valid)))
    jl = jl.replace(valid=jnp.asarray(d["valid"]))
    return jl, Levels.from_numpy(d)


@pytest.mark.parametrize("prices,valid", [
    ([100.0, 100.4, 99.7], [True, True, True]),
    ([100.0, 100.4, 100.2, 100.2], [True, False, True, True]),   # equidistant
    ([101.0, 99.0], [False, False]),                              # none valid
])
def test_nearest_level_matches_jax(prices, valid):
    jl, tl = _levels_pair(prices, valid)
    rng = np.random.default_rng(1)
    price = rng.uniform(98.5, 101.5, (64, 17)).astype(np.float32)
    price[0, :4] = [100.2, 100.0, 100.4, 99.85]   # exact ties between levels
    ji, jd = jF.nearest_level(jl, price)
    ti, td = F.nearest_level(tl, torch.from_numpy(price))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    full_j = jF.nearest_level_full(jl, price)
    full_t = F.nearest_level_full(tl, torch.from_numpy(price))
    for a, b in zip(full_t, full_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _hit_inputs(seed):
    rng = np.random.default_rng(seed)
    p, n = 400, 20
    mid = 100.0 + np.cumsum(rng.normal(0, 0.08, (p, n)), axis=1)
    highs = (mid + np.abs(rng.normal(0, 0.1, (p, n)))).astype(np.float32)
    lows = (mid - np.abs(rng.normal(0, 0.1, (p, n)))).astype(np.float32)
    side = np.where(rng.uniform(size=p) < 0.5, 1, -1).astype(np.int32)
    entry = mid[:, 0].astype(np.float32)
    stop = (entry - side * 0.15).astype(np.float32)
    target = (entry + side * 0.1).astype(np.float32)
    # same-bar ties: a wide bar that spans both barriers
    highs[:40, 5] = np.maximum(highs[:40, 5], entry[:40] + 0.5)
    lows[:40, 5] = np.minimum(lows[:40, 5], entry[:40] - 0.5)
    # never hit: bars that stay inside both barriers
    highs[40:60] = entry[40:60, None] + 0.01
    lows[40:60] = entry[40:60, None] - 0.01
    tie = rng.uniform(size=p).astype(np.float32)
    ebar = rng.integers(0, 4, p)
    mask = np.arange(n)[None, :] > ebar[:, None]
    return dict(highs=highs, lows=lows, side=side, entry=entry, stop=stop,
                target=target, tie_uniform=tie, valid_mask=mask)


@pytest.mark.parametrize("seed,side_aware", [(0, False), (1, False), (2, True)])
def test_stop_target_outcome_matches_jax(seed, side_aware):
    kw = _hit_inputs(seed)
    jr, jo = jH.stop_target_outcome(side_aware_tie=side_aware,
                                    **{k: jnp.asarray(v) for k, v in kw.items()})
    tr, to = H.stop_target_outcome(side_aware_tie=side_aware,
                                   **{k: torch.from_numpy(np.asarray(v))
                                      for k, v in kw.items()})
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)
    assert (to.numpy() == 0).any() and (to.numpy() == 1).any() and (to.numpy() == 2).any()
    assert (kw["side"] < 0).any()


def test_first_index_and_running_extrema_match_jax():
    rng = np.random.default_rng(4)
    s = rng.normal(size=(30, 12)).astype(np.float32)
    thr = rng.normal(size=30).astype(np.float32)
    mask = rng.uniform(size=(30, 12)) < 0.7
    ts, tt, tm = torch.from_numpy(s), torch.from_numpy(thr), torch.from_numpy(mask)
    for jf, tf in ((jH.first_index_leq, H.first_index_leq),
                   (jH.first_index_geq, H.first_index_geq)):
        np.testing.assert_array_equal(tf(ts, tt).numpy(), np.asarray(jf(s, thr)))
        np.testing.assert_array_equal(tf(ts, tt, tm).numpy(),
                                      np.asarray(jf(s, thr, mask)))
    np.testing.assert_array_equal(H.running_min(ts).numpy(),
                                  np.asarray(jH.running_min(jnp.asarray(s))))
    np.testing.assert_array_equal(H.running_max(ts).numpy(),
                                  np.asarray(jH.running_max(jnp.asarray(s))))
