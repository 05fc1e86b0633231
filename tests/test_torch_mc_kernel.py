"""The fused first-contact kernel's plain version held against the JAX Pallas
kernel (TPU-interpret mode on the CPU) on injected uniforms; the wrapper's
device rules and checks; the kernel itself against the plain version where a
CUDA device is present.

Only the JAX comparison imports JAX, inside the test, so that the CUDA test
also runs where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_mc_kernel.py -m cuda``."""

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_mc
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import GbmLayout, fused_uniforms
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

torch.set_num_threads(2)

ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "orange", "type": "dashed", "index": 0, "price": 100.4}]
LANES = 2048
SIGMA = 0.3
STDS = dict(level_jitter_std=0.02, entry_slip_std=0.01, stop_slip_std=0.015,
            target_slip_std=0.015)


def _uniforms(seed, w, noise, nb=2, lanes=LANES):
    rng = np.random.default_rng(seed)
    rows = GbmLayout(w, noise).n_rows
    return rng.uniform(1e-9, 1.0, (nb, rows, lanes)).astype(np.float32)


@pytest.mark.parametrize("w,noisy,antithetic", [
    (24, False, False), (40, False, False), (24, True, False),
    (40, True, False), (40, False, True), (24, True, True)])
def test_plain_fused_matches_jax_kernel_interpret(w, noisy, antithetic):
    from jax.experimental.pallas import tpu as pltpu

    from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
    from qmmx_monolithic_monte_carlo_tpu.ops.pallas_mc import mc_paths_pallas
    from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise as JMcNoise
    from qmmx_monolithic_monte_carlo_tpu.types import Levels as JLevels

    u = _uniforms(w + 3 * noisy + 7 * antithetic, w, noisy)
    n = u.shape[0] * LANES
    j = mc_paths_pallas(
        0, JLevels.from_rows(ROWS, max_levels=8), JParams.default(),
        num_paths=n, num_bars=w, sigma=SIGMA, lanes=LANES,
        noise=JMcNoise.make(**STDS) if noisy else None, antithetic=antithetic,
        interpret=pltpu.InterpretParams(), external_uniforms=u)
    t = cuda_mc.mc_paths_fused_reference(
        0, Levels.from_rows(ROWS, max_levels=8), EngineParams.default(),
        num_paths=n, num_bars=w, sigma=SIGMA, lanes=LANES,
        noise=McNoise.make(**STDS) if noisy else None, antithetic=antithetic,
        external_uniforms=torch.from_numpy(u))
    # tests/test_pallas_mc.py:134-146: the JAX kernel's cumsum is a triangular
    # matmul, the port's serial float32, so O(1) outcomes per 1024 may flip
    assert float(t.n) == float(j.n) == n
    assert abs(float(t.n_entered) - float(j.n_entered)) <= 1
    for f in ("n_tp", "n_stop", "n_open"):
        assert abs(float(getattr(t, f)) - float(getattr(j, f))) <= 2, f
    assert float(t.sum_r) == pytest.approx(float(j.sum_r), abs=3.0)
    assert float(t.min_r) == pytest.approx(float(j.min_r), abs=1e-3)
    assert float(t.max_r) == pytest.approx(float(j.max_r), abs=1e-3)
    assert float(t.hist.sum()) == float(t.n_entered)
    assert float(t.n_tp + t.n_stop + t.n_open) == float(t.n_entered)
    assert float(t.sum_dd) == float(t.n_stop)
    assert float(t.sum_trades) == float(t.n_entered)
    assert float(t.max_dd) == max(0.0, -float(t.min_r))


def test_wrapper_takes_plain_version_for_cpu():
    levels = Levels.from_rows(ROWS, max_levels=8)
    u = torch.from_numpy(_uniforms(1, 24, True))
    kw = dict(num_paths=2 * LANES, num_bars=24, sigma=SIGMA, lanes=LANES,
              noise=McNoise.make(**STDS), external_uniforms=u)
    before = dict(cuda_mc.LAUNCHES)
    a = cuda_mc.mc_paths_fused(0, levels, EngineParams.default(), **kw)
    b = cuda_mc.mc_paths_fused_reference(0, levels, EngineParams.default(), **kw)
    assert cuda_mc.LAUNCHES == before
    for f in ("n", "n_entered", "n_tp", "n_stop", "n_open", "sum_r", "min_r",
              "max_r"):
        assert float(getattr(a, f)) == float(getattr(b, f)), f
    assert torch.equal(a.hist, b.hist)


def test_philox_mode_draws_the_layout_uniforms():
    """Philox mode == injecting fused_uniforms: the kernel's draws are the
    plain version's, bit for bit, in any chunking."""
    levels = Levels.from_rows(ROWS, max_levels=8)
    kw = dict(num_paths=6 * 256, num_bars=16, sigma=SIGMA, lanes=256,
              antithetic=True)
    u = fused_uniforms(9, GbmLayout(16), block0=0, n_blocks=6, lanes=256)
    a = cuda_mc.fused_totals_reference(9, levels, EngineParams.default(),
                                       device="cpu", chunk_blocks=4, **kw)
    b = cuda_mc.fused_totals_reference(9, levels, EngineParams.default(),
                                       external_uniforms=u, chunk_blocks=6, **kw)
    assert torch.equal(a[0], b[0])
    assert torch.allclose(a[1], b[1], rtol=1e-12, atol=1e-9)


def test_reduce_rows_plain_and_totals_to_stats():
    rng = np.random.default_rng(2)
    counts = torch.from_numpy(rng.integers(0, 1000, (7, cuda_mc.ROW_COUNTS)))
    floats = torch.from_numpy(rng.normal(size=(7, cuda_mc.ROW_FLOATS))
                              .astype(np.float32))
    c, f = cuda_mc.reduce_rows(counts, floats)
    assert torch.equal(c, counts.sum(0))
    assert float(f[2]) == float(floats[:, 2].min())
    assert float(f[3]) == float(floats[:, 3].max())
    assert float(f[0]) == pytest.approx(float(floats[:, 0].double().sum()))
    empty = torch.zeros(cuda_mc.ROW_COUNTS, dtype=torch.int64)
    empty[0] = 5
    s = cuda_mc.stats_from_totals(
        empty, torch.tensor([0.0, 0.0, 3.4e38, -3.4e38], dtype=torch.float64))
    assert float(s.min_r) == float("inf") and float(s.max_r) == float("-inf")
    assert float(s.max_dd) == 0.0 and float(s.n) == 5.0


def test_counts_stay_exact_int64_past_2_24():
    big = torch.zeros(cuda_mc.ROW_COUNTS, dtype=torch.int64)
    big[:2] = (1 << 28) + 1
    c, _ = cuda_mc.reduce_rows(big.view(1, -1).repeat(3, 1),
                               torch.zeros((3, cuda_mc.ROW_FLOATS)))
    assert int(c[0]) == 3 * ((1 << 28) + 1)


def test_wrapper_raises_for_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel runs instead")
    with pytest.raises(RuntimeError, match="cuda"):
        cuda_mc.mc_paths_fused(0, Levels.from_rows(ROWS, max_levels=8),
                               EngineParams.default(), num_paths=LANES,
                               num_bars=24, lanes=LANES, device="cuda")


@pytest.mark.parametrize("bad", ["paths", "odd_bars", "levels", "shape",
                                 "dtype", "numpy", "antithetic_lanes", "seed"])
def test_wrapper_rejects_bad_inputs(bad):
    levels = Levels.from_rows(ROWS, max_levels=8)
    kw = dict(num_paths=2 * LANES, num_bars=24, lanes=LANES)
    if bad == "paths":
        kw["num_paths"] = LANES + 1
    elif bad == "odd_bars":
        kw["num_bars"] = 25
    elif bad == "levels":
        levels = Levels.from_rows(
            [{"color": "blue", "type": "solid", "index": i, "price": 100.0 + i}
             for i in range(9)], max_levels=16)
    elif bad == "shape":
        kw["external_uniforms"] = torch.rand(2, 3 * 24, LANES)
    elif bad == "dtype":
        kw["external_uniforms"] = torch.rand(2, 3 * 24 + 1, LANES,
                                             dtype=torch.float64)
    elif bad == "numpy":
        kw["external_uniforms"] = np.full((2, 3 * 24 + 1, LANES), 0.5, np.float32)
    elif bad == "antithetic_lanes":
        kw.update(lanes=7, num_paths=14, antithetic=True)
    else:
        kw["seed"] = -3
    seed = kw.pop("seed", 0)
    with pytest.raises(ValueError):
        cuda_mc.mc_paths_fused(seed, levels, EngineParams.default(), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("noisy,antithetic", [(False, False), (True, True)])
def test_cuda_kernel_matches_plain(noisy, antithetic):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    levels = Levels.from_rows(ROWS, max_levels=8)
    u = torch.from_numpy(_uniforms(4, 40, noisy, nb=8, lanes=8192))
    kw = dict(num_paths=8 * 8192, num_bars=40, sigma=SIGMA, lanes=8192,
              noise=McNoise.make(**STDS) if noisy else None,
              antithetic=antithetic)
    want = cuda_mc.fused_totals_reference(0, levels, EngineParams.default(),
                                          external_uniforms=u, **kw)
    before = cuda_mc.LAUNCHES["mc_first_contact"]
    got = cuda_mc.mc_paths_fused(0, levels, EngineParams.default(),
                                 external_uniforms=u.cuda(), **kw)
    torch.cuda.synchronize()
    assert cuda_mc.LAUNCHES["mc_first_contact"] == before + 1
    flips = 2 + kw["num_paths"] // 1024
    wc = want[0].to(torch.float32)
    assert float(got.n) == float(wc[0])
    for i, f in enumerate(("n_entered", "n_tp", "n_stop", "n_open"), start=1):
        assert abs(float(getattr(got, f)) - float(wc[i])) <= flips, f
    assert abs(float(got.sum_r) - float(want[1][0])) <= flips * 1.5
    assert float(got.min_r) == pytest.approx(float(want[1][2]), abs=1e-3)
    assert float(got.max_r) == pytest.approx(float(want[1][3]), abs=1e-3)
