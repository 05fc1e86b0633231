"""The fused kernels' sampler branches (bootstrap, block bootstrap, Heston) of
kernels #1, #4 and #8: each plain version held against the JAX kernel in
interpret mode on the same injected uniforms and JAX's own bootstrap tables
(W = 16, one block); and, marked ``cuda`` (skipped without a card), each
CUDA kernel against its plain version path by path.  JAX is imported inside
the interpret-mode tests only, so the ``cuda`` cases run where there is no
JAX."""

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated, cuda_mc
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import (EngineLayout, GatedLayout,
                                                             GbmLayout)
from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import bootstrap_tables
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

torch.set_num_threads(2)

W = 16
BLOCK_LEN = 5
ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "orange", "type": "dashed", "index": 0, "price": 100.4}]
STDS = dict(entry_slip_std=0.01, level_jitter_std=0.02, stop_slip_std=0.015,
            target_slip_std=0.015)


def _history(seed, h):
    """tests/test_engine_bootstrap.py's recorded history (wicks, volume
    bursts), as numpy float32 arrays o, h, l, c, v."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(0, 0.12, h).astype(np.float32)
    c = np.float32(100.0) + np.cumsum(steps, dtype=np.float32)
    o = np.concatenate([[np.float32(100.0)], c[:-1]])
    hi = np.maximum(o, c) + rng.uniform(0, 0.15, h).astype(np.float32)
    lo = np.minimum(o, c) - rng.uniform(0, 0.15, h).astype(np.float32)
    v = rng.lognormal(13.0, 0.5, h).astype(np.float32)
    v = v * (1.0 + 2.0 * (np.abs(steps) > 0.15)).astype(np.float32)
    return o, hi, lo, c, v


HIST = _history(3, 300)
TABLES = [t.numpy() for t in bootstrap_tables(*HIST)]


def _jax():
    """The JAX side of an interpret-mode comparison: (the JAX package's
    modules, its PathBars of the history, JAX's own tables, so that both
    sides resample the same float32 values)."""
    import types

    from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
    from qmmx_monolithic_monte_carlo_tpu.ops import pathgen as jPG
    from qmmx_monolithic_monte_carlo_tpu.ops.pallas_engine import mc_paths_pallas_engine
    from qmmx_monolithic_monte_carlo_tpu.ops.pallas_mc import (mc_paths_pallas,
                                                               mc_paths_pallas_gated)
    from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise as JMcNoise
    from qmmx_monolithic_monte_carlo_tpu.types import Levels as JLevels

    hist = jPG.PathBars(*HIST)
    tables = [np.asarray(t) for t in jPG.bootstrap_tables(*HIST)]
    return types.SimpleNamespace(
        Params=JParams, Levels=JLevels, McNoise=JMcNoise, mc=mc_paths_pallas,
        gated=mc_paths_pallas_gated, engine=mc_paths_pallas_engine), hist, tables


def _kw(sampler):
    return dict(sampler=sampler, block_len=BLOCK_LEN)


def _noises(noisy, J=None):
    return (J.McNoise.make(**STDS), McNoise.make(**STDS)) if noisy else (None, None)


def _flips(n):
    return 2 + n // 1024


def _uniforms(seed, shape, low=1e-6):
    return np.random.default_rng(seed).uniform(low, 1.0, shape).astype(np.float32)


@pytest.mark.parametrize("sampler,noisy", [("bootstrap", False), ("block_bootstrap", False),
                                           ("heston", False), ("bootstrap", True),
                                           ("heston", True)])
def test_plain_first_contact_matches_the_jax_kernel_interpret(sampler, noisy):
    """``_bootstrap_block`` / ``_heston_block``'s tril-matmul cumsum against
    a serial float32 sum flips O(1) outcomes per 1024 paths
    (tests/test_pallas_mc.py:133-146): counts within F = 2 + paths/1024."""
    J, jhist, jtables = _jax()
    lanes = 8192
    u = _uniforms(40 + noisy, (1, GbmLayout(W, noisy, sampler).n_rows, lanes))
    jn, tn = _noises(noisy, J)
    j = J.mc(0, J.Levels.from_rows(ROWS, max_levels=8), J.Params.default(),
             num_paths=lanes, num_bars=W, sigma=0.3, hist_bars=jhist,
             noise=jn, interpret=True, external_uniforms=u, **_kw(sampler))
    t = cuda_mc.mc_paths_fused(0, Levels.from_rows(ROWS, max_levels=8), EngineParams.default(),
                               num_paths=lanes, num_bars=W, sigma=0.3, tables=jtables, noise=tn,
                               external_uniforms=torch.from_numpy(u), **_kw(sampler))
    f = _flips(lanes)
    assert float(t.n) == float(j.n) == lanes
    for fld in ("n_entered", "n_tp", "n_stop", "n_open"):
        assert abs(float(getattr(t, fld)) - float(getattr(j, fld))) <= f, fld
    assert float(np.abs(t.hist.numpy() - np.asarray(j.hist)).sum()) <= 2 * f
    assert abs(float(t.sum_r) - float(j.sum_r)) <= f * max(abs(float(j.min_r)),
                                                           abs(float(j.max_r)))
    assert float(t.n_entered) > 0.5 * lanes


@pytest.mark.parametrize("sampler,noisy", [("bootstrap", False), ("block_bootstrap", False),
                                           ("heston", False), ("bootstrap", True)])
def test_plain_gated_matches_the_jax_kernel_interpret(sampler, noisy):
    """The gated loop's samplers: counts exact, the histogram within 2F and
    the sums within F x max|equity| (PyTorch's exp against XLA's may move an
    equity across a bin edge)."""
    J, jhist, jtables = _jax()
    lanes = 1024
    u = _uniforms(50 + noisy, (1, GatedLayout(W, noisy, sampler).u_rows, 8, lanes))
    jn, tn = _noises(noisy, J)
    j = J.gated(0, J.Levels.from_rows(ROWS, max_levels=8), J.Params.default(), None,
                num_paths=8 * lanes, num_bars=W, sigma=0.3, hist_bars=jhist, noise=jn,
                interpret=True, external_uniforms=u, **_kw(sampler))
    counts, floats, rows = cuda_gated.gated_totals_reference(
        0, Levels.from_rows(ROWS, max_levels=8), EngineParams.default(), num_paths=8 * lanes,
        num_bars=W, sigma=0.3, tables=jtables, noise=tn, external_uniforms=torch.from_numpy(u),
        per_path=True, **_kw(sampler))
    t = cuda_gated.stats_from_gated_totals(counts, floats)
    f = _flips(8 * lanes)
    for fld in ("n", "n_entered", "n_tp", "n_stop", "n_open", "sum_trades"):
        assert float(getattr(t, fld)) == float(getattr(j, fld)), fld
    assert float(np.abs(t.hist.numpy() - np.asarray(j.hist)).sum()) <= 2 * f
    max_eq = float(rows[:, 0].abs().max())
    for fld in ("sum_r", "sum_dd"):
        assert abs(float(getattr(t, fld)) - float(getattr(j, fld))) <= f * max_eq, fld
    assert float(t.sum_trades) > float(t.n_entered) > 0


def engine_against_interpret(sampler, w, noisy, lanes=256, seed=60):
    """The engine loop's sampler (recorded volumes into the volume gates
    under bootstrap) at W = ``w`` on one block of 8 x ``lanes`` paths, the
    plain version against the JAX kernel in interpret mode: counts, the
    16-reason skip table and the escalations exact, the histogram within the
    flip budget."""
    J, jhist, jtables = _jax()
    jn, tn = _noises(noisy, J)
    u = _uniforms(seed, (1, EngineLayout(w, noisy, sampler).u_rows, 8, lanes))
    js, jskips, jescal = J.engine(
        0, J.Levels.from_rows(ROWS, max_levels=8), J.Params.default(), num_paths=8 * lanes,
        num_bars=w, sigma=0.3, lanes=lanes, hist_bars=jhist, noise=jn, interpret=True,
        external_uniforms=u, **_kw(sampler))
    ts, tskips, tescal = cuda_engine.mc_paths_engine_fused(
        0, Levels.from_rows(ROWS, max_levels=8), EngineParams.default(), num_paths=8 * lanes,
        num_bars=w, sigma=0.3, lanes=lanes, tables=jtables, noise=tn,
        external_uniforms=torch.from_numpy(u), **_kw(sampler))
    for fld in ("n", "n_entered", "n_tp", "n_stop", "n_open", "sum_trades"):
        assert float(getattr(ts, fld)) == float(getattr(js, fld)), fld
    np.testing.assert_array_equal(tskips.numpy(), np.asarray(jskips))
    assert int(tescal) == int(jescal)
    f = _flips(8 * lanes)
    assert float(np.abs(ts.hist.numpy() - np.asarray(js.hist)).sum()) <= 2 * f
    assert float(ts.n_entered) > 0


@pytest.mark.parametrize("sampler", ["bootstrap", "block_bootstrap", "heston"])
def test_plain_engine_matches_the_jax_kernel_interpret(sampler):
    """The engine loop's samplers at W = 16, 256 lanes, no noise
    (``engine_against_interpret``)."""
    engine_against_interpret(sampler, W, False)


# ---------------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _differ(got_rows, want_rows, engine: bool) -> int:
    """Paths whose trades differ (counts, or equity/dd beyond 1e-3 a trade)
    or, for the engine, whose first-fail reasons differ."""
    cols = [1, 2, 3, 4] + ([6] if engine else [])
    err = (got_rows[:, [0, 5]] - want_rows[:, [0, 5]]).abs().amax(dim=1)
    differ = ((got_rows[:, cols] != want_rows[:, cols]).any(dim=1)
              | (err > 1e-3 * torch.clamp(want_rows[:, 1], min=1.0)))
    if engine:
        differ |= (got_rows[:, 7:] != want_rows[:, 7:]).any(dim=1)
    return int(differ.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("sampler,noisy", [("bootstrap", False), ("block_bootstrap", True),
                                           ("heston", False), ("heston", True)])
def test_cuda_first_contact_sampler_kernel_matches_plain(sampler, noisy):
    dev = _cuda()
    lanes, nb, w = 8192, 4, 40
    u = torch.from_numpy(_uniforms(70 + noisy, (nb, GbmLayout(w, noisy, sampler).n_rows,
                                                lanes), 1e-9))
    kw = dict(num_paths=nb * lanes, num_bars=w, s0=100.0, mu=0.0, sigma=0.3,
              dt=1.0 / (390.0 * 252.0), lanes=lanes,
              noise=McNoise.make(**STDS) if noisy else None,
              antithetic=False, tables=TABLES, **_kw(sampler))
    levels = Levels.from_rows(ROWS, max_levels=8)
    want = cuda_mc.fused_totals_reference(0, levels, EngineParams.default(),
                                          external_uniforms=u, **kw)
    before = cuda_mc.LAUNCHES["mc_first_contact_sampler"]
    got = cuda_mc.reduce_rows(*cuda_mc.first_contact_rows(
        0, levels, EngineParams.default(), external_uniforms=u.to(dev), device=dev, **kw))
    torch.cuda.synchronize()
    assert cuda_mc.LAUNCHES["mc_first_contact_sampler"] == before + 1
    f = _flips(nb * lanes)
    assert int(got[0][0]) == int(want[0][0]) == nb * lanes
    assert int((got[0][1:5].cpu() - want[0][1:5]).abs().max()) <= f
    # Philox: the kernel and the plain version on the card
    kw.pop("lanes")
    want = cuda_mc.fused_totals_reference(3, levels, EngineParams.default(), device=dev, **kw)
    got = cuda_mc.reduce_rows(*cuda_mc.first_contact_rows(
        3, levels, EngineParams.default(), external_uniforms=None, device=dev, lanes=8192, **kw))
    assert int((got[0][:5] - want[0][:5]).abs().max()) <= f


@pytest.mark.cuda
@pytest.mark.parametrize("engine", [False, True])
@pytest.mark.parametrize("sampler", ["bootstrap", "block_bootstrap", "heston"])
def test_cuda_lifecycle_sampler_kernels_match_plain_per_path(engine, sampler):
    dev = _cuda()
    mod = cuda_engine if engine else cuda_gated
    lanes = 256 if engine else 1024
    lay = (EngineLayout if engine else GatedLayout)(40, True, sampler)
    nb = 4
    u = torch.from_numpy(_uniforms(80 + engine, (nb, lay.u_rows, 8, lanes)))
    kw = dict(num_paths=nb * 8 * lanes, num_bars=40, s0=100.0, mu=0.0, sigma=0.3,
              dt=1.0 / (390.0 * 252.0), lanes=lanes, noise=McNoise.make(**STDS),
              antithetic=False, tables=TABLES, per_path=True, **_kw(sampler))
    levels = Levels.from_rows(ROWS, max_levels=8)
    args = (0, levels, EngineParams.default()) + (() if engine else (None,))
    ref = mod.engine_totals_reference if engine else mod.gated_totals_reference
    launch = mod.engine_rows if engine else mod.gated_rows
    want = ref(*args, external_uniforms=u, **kw)
    name = "mc_engine_rows_sampler" if engine else "mc_gated_sampler"
    before = mod.LAUNCHES[name]
    pc, pf, rows = launch(*args, external_uniforms=u.to(dev), device=dev, **kw)
    counts, _ = mod.reduce_rows(pc, pf)
    torch.cuda.synchronize()
    assert mod.LAUNCHES[name] == before + 1
    f = _flips(kw["num_paths"])
    assert _differ(rows.cpu(), want[2], engine) <= (2 * f if engine else f)
    assert int(counts[0]) == int(want[0][0])
    # Philox on the card: the plain version on the same device agrees path by path
    want = ref(*args, external_uniforms=None, device=dev, **kw)
    pc, pf, rows = launch(*args, external_uniforms=None, device=dev, **kw)
    assert _differ(rows.cpu(), want[2].cpu(), engine) <= (2 * f if engine else f)
