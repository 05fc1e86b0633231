"""The closed-trade label harvest of the port's universe, book, sampler and
fused entries held against the JAX package's: each symbol of a universe and
of a book, and a bootstrap case, the port's replay against JAX's on the same
bars (counts exact, sums within 1e-6 relative); the plain versions of the
fused entries (``ops/cuda_engine``) equal to the port's replay over their own
bars; a harvest moves none of their numbers; and (slow) the plain version
against the JAX kernel in interpret mode on injected uniforms
(``tests/test_harvest.py:32``)."""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import differing_trades, gap_within
from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
from qmmx_monolithic_monte_carlo_tpu.sim import enginepath as jEP
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.models import harvest as HV
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine as CE
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout, MarketLayout
from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import portfolio as PF
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
from qmmx_monolithic_monte_carlo_tpu_torch.sim import enginepath as EP

from .test_pallas_engine import DT, _bars_from_uniforms
from .test_torch_engine import JLEVELS, LANES, STDS, JMcNoise, McNoise, _levels
from .test_torch_engine_harvest import _jax_harvest, _port_bars, assert_harvest_close
from .test_torch_sampler_kernels import TABLES

torch.set_num_threads(2)


def _symbols():
    s0 = np.array([100.0, 60.0])
    sig = np.array([0.3, 0.25])
    rows = [[{"color": "blue", "type": "solid", "index": 0, "price": float(x)},
             {"color": "orange", "type": "dashed", "index": 0, "price": float(x) + 0.4},
             {"color": "teal", "type": "solid", "index": 0, "price": float(x) - 0.3}]
            for x in s0]
    return s0, sig, rows


def test_universe_harvest_matches_jax_replay_per_symbol():
    """Each symbol's harvest: the JAX replay of the bars JAX builds from its
    uniforms against the port's replay of the same bars; the plain universe
    (``engine_universe_totals_reference``, the fused entry's CPU path)
    against the port's replay over its own bars."""
    s0, sig, rows = _symbols()
    w, lay = 24, EngineLayout(24)
    u = np.random.default_rng(5).uniform(1e-6, 1.0, (2, 1, lay.u_rows, 8, LANES)).astype(
        np.float32)
    lv = U.stack_levels(rows, max_levels=4)
    p = EngineParams.default()
    *_, hv = CE.mc_paths_engine_universe_fused(
        0, lv, p, s0, sig, paths_per_symbol=8 * LANES, num_bars=w, lanes=LANES,
        external_uniforms=torch.from_numpy(u), harvest=True)
    for s in range(2):
        jb = _bars_from_uniforms(u[s, 0], float(sig[s]), w=w, s0=float(s0[s]))
        jlv = jax.tree_util.tree_map(lambda x: x[s], _jax_stack(rows))
        want = jEP.engine_path_replay(jb[0], jlv, JParams.default(), jb[1], harvest=True)
        got = EP.engine_path_replay(*_port_bars(jb[0], jb[1])[:1], grid_row(lv, s), p,
                                    _port_bars(jb[0], jb[1])[1], harvest=True)
        assert_harvest_close(got.harvest, _jax_harvest(want.harvest))
        bars, tie, _ = CE.engine_bars_from_uniforms(torch.from_numpy(u[s]), lay, s0=s0[s],
                                                    sigma=sig[s])
        own = EP.engine_path_replay(bars, grid_row(lv, s), p, tie, harvest=True)
        _assert_equal(HV.EngineHarvest(*(f[s] for f in hv)), own.harvest)
        assert int(own.harvest.n_labeled) > 0


def _jax_stack(rows):
    from qmmx_monolithic_monte_carlo_tpu.parallel import universe as jU

    return jU.stack_levels(rows, max_levels=4)


def _assert_equal(a: HV.EngineHarvest, b: HV.EngineHarvest) -> None:
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("noisy", [False, True])
def test_book_harvest_matches_jax_replay_per_symbol(noisy):
    """Each book symbol's harvest on its market-mixed bars: JAX's replay
    against the port's on JAX's bars; the plain book
    (``engine_corr_totals_reference``) against the port's replay over its own
    bars; the XLA-form book (``portfolio_mc_engine``) returns the [S]
    harvest, and a harvest moves none of the book's numbers."""
    s0, sig, rows = _symbols()
    beta, wts = np.array([0.5, 0.7]), np.array([0.6, 0.4])
    w = 24
    lay, mlay = EngineLayout(w, noisy, book=True), MarketLayout(w)
    rng = np.random.default_rng(9 + noisy)
    u = rng.uniform(1e-6, 1.0, (2, 1, lay.u_rows, 8, LANES)).astype(np.float32)
    um = rng.uniform(1e-6, 1.0, (1, mlay.u_rows, 8, LANES)).astype(np.float32)
    lv = U.stack_levels(rows, max_levels=4)
    p = EngineParams.default()
    noise = McNoise.make(**STDS) if noisy else None
    kw = dict(paths_per_symbol=8 * LANES, num_bars=w, lanes=LANES, noise=noise,
              external_uniforms=torch.from_numpy(u), market_uniforms=torch.from_numpy(um))
    c, f, hv = CE.engine_corr_totals_reference(0, lv, p, s0, sig, beta, wts, harvest=True, **kw)
    c0, f0 = CE.engine_corr_totals_reference(0, lv, p, s0, sig, beta, wts, **kw)
    assert torch.equal(c, c0) and torch.equal(f, f0)
    for s in range(2):
        jb = _bars_from_uniforms(u[s, 0], float(sig[s]), w=w, s0=float(s0[s]), um=um[0],
                                 beta=float(beta[s]), with_noise=noisy)
        jlv = jax.tree_util.tree_map(lambda x: x[s], _jax_stack(rows))
        jkw = dict(noise=JMcNoise.make(**STDS), noise_normals=jb[2]) if noisy else {}
        tkw = (dict(noise=noise, noise_normals=tuple(torch.from_numpy(np.array(x))
                                                     for x in jb[2])) if noisy else {})
        want = jEP.engine_path_replay(jb[0], jlv, JParams.default(), jb[1], harvest=True, **jkw)
        bars, tie = _port_bars(jb[0], jb[1])
        got = EP.engine_path_replay(bars, grid_row(lv, s), p, tie, harvest=True, **tkw)
        assert_harvest_close(got.harvest, _jax_harvest(want.harvest))
        bars, tie, nzs = CE.engine_bars_from_uniforms(
            torch.from_numpy(u[s]), lay, s0=s0[s], sigma=sig[s],
            market_uniforms=torch.from_numpy(um), beta=beta[s])
        own = EP.engine_path_replay(bars, grid_row(lv, s), p, tie, harvest=True,
                                    noise=noise, noise_normals=nzs)
        _assert_equal(HV.EngineHarvest(*(f_[s] for f_ in hv)), own.harvest)
    if noisy:
        return
    out = PF.portfolio_mc_engine(0, lv, p, s0, sig, beta, wts, num_paths=1024, num_bars=w,
                                 block_paths=512, device="cpu", harvest=True)
    assert len(out) == 5 and tuple(out[4].ml_counts.shape) == (2, HV.ML_BUCKETS, 2)
    base = PF.portfolio_mc_engine(0, lv, p, s0, sig, beta, wts, num_paths=1024, num_bars=w,
                                  block_paths=512, device="cpu")
    assert torch.equal(out[2], base[2]) and torch.equal(out[0].hist, base[0].hist)
    assert torch.equal(out[4].n_labeled, (out[0].n_tp + out[0].n_stop).to(torch.int64))


def test_bootstrap_harvest_matches_jax_replay():
    """The bootstrap sampler's bars (the plain version's, from injected
    uniforms): the plain single run's harvest equals the port's replay over
    them, and JAX's replay of the same bars agrees (counts exact)."""
    w = 24
    lay = EngineLayout(w, False, "bootstrap")
    u = np.random.default_rng(2).uniform(1e-6, 1.0, (1, lay.u_rows, 8, LANES)).astype(
        np.float32)
    tables = torch.from_numpy(np.stack(TABLES))
    p = EngineParams.default()
    *_, hv = CE.engine_totals_reference(0, _levels(), p, num_paths=8 * LANES, num_bars=w,
                                        lanes=LANES, external_uniforms=torch.from_numpy(u),
                                        sampler="bootstrap", tables=tables, harvest=True)
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.samplers import make_sampler

    bars, tie, _ = CE.engine_bars_from_uniforms(
        torch.from_numpy(u), lay, sampler=make_sampler("bootstrap", tables=tables))
    own = EP.engine_path_replay(bars, _levels(), p, tie, harvest=True)
    _assert_equal(hv, own.harvest)
    from qmmx_monolithic_monte_carlo_tpu.ops.pathgen import PathBars as JPathBars

    jbars = JPathBars(*(x.numpy() for x in bars))
    want = jEP.engine_path_replay(jbars, JLEVELS, JParams.default(), tie.numpy(), harvest=True)
    assert_harvest_close(own.harvest, _jax_harvest(want.harvest))
    assert int(own.harvest.n_labeled) > 0


def test_fused_entries_return_the_harvest_on_the_cpu():
    """``mc_paths_engine_fused`` and ``sim.enginepath.mc_paths_engine`` with
    ``harvest=True``: 4-tuples whose statistics equal the harvest-off run's."""
    kw = dict(num_paths=2048, num_bars=24, sigma=0.3, device="cpu")
    p = EngineParams.default()
    on = CE.mc_paths_engine_fused(3, _levels(), p, harvest=True, **kw)
    off = CE.mc_paths_engine_fused(3, _levels(), p, **kw)
    assert len(on) == 4 and len(off) == 3
    assert torch.equal(on[0].hist, off[0].hist) and torch.equal(on[1], off[1])
    assert int(on[3].n_labeled) == int(on[0].n_tp + on[0].n_stop)
    st = EP.mc_paths_engine(3, _levels(), p, block_paths=1024, harvest=True, **kw)
    assert len(st) == 4 and int(st[3].n_labeled) == int(st[0].n_tp + st[0].n_stop)


@pytest.mark.slow
def test_plain_version_harvest_matches_the_jax_kernel_interpret():
    """The JAX Pallas kernel with ``harvest=True`` in interpret mode and the
    plain version on the same injected uniforms (tests/test_harvest.py:32;
    ~55 s, the JAX kernel's interpretation): the lifecycle within the flip
    budget, the harvest counts within 2 a trade of the differing paths (the
    plain version's PyTorch transcendentals against XLA's), the sums within
    those trades, 16 price ulps of a close's distance a trade (the bars part
    by ulps) and the reduction orders (``chip_smoke.gap_within``)."""
    from qmmx_monolithic_monte_carlo_tpu.ops.pallas_engine import mc_paths_pallas_engine

    w, lanes = 16, 128
    lay = EngineLayout(w)
    u = np.random.default_rng(11).uniform(1e-6, 1.0, (1, lay.u_rows, 8, lanes)).astype(
        np.float32)
    jlv = JLEVELS
    _, _, _, jhv = mc_paths_pallas_engine(0, jlv, JParams.default(), num_paths=8 * lanes,
                                          num_bars=w, sigma=0.3, dt=DT, lanes=lanes,
                                          harvest=True, interpret=True, external_uniforms=u)
    c, f, rows, hv = CE.engine_totals_reference(
        0, _levels(), EngineParams.default(), num_paths=8 * lanes, num_bars=w, sigma=0.3,
        lanes=lanes, external_uniforms=torch.from_numpy(u), per_path=True, harvest=True)
    jb = _bars_from_uniforms(u[0], 0.3, lanes=lanes, w=w)
    jout = jEP.engine_path_replay(jb[0], jlv, JParams.default(), jb[1])
    jrows = torch.from_numpy(np.stack([np.asarray(getattr(jout, k), np.float32) for k in (
        "equity", "trades", "wins", "losses", "open_at_end", "max_dd", "escalations")], 1))
    cols = [1, 2, 3, 4, 6]
    assert int((rows[:, cols] != jrows[:, cols]).any(dim=1).sum()) <= 2 + rows.shape[0] // 1024
    d = differing_trades(rows, jrows)
    ok, gap = gap_within(hv, _jax_harvest(jhv), d,
                         x1_drift=16 * float(np.spacing(np.float32(100.0))))
    assert ok, gap
    assert int(hv.n_labeled) > 0
