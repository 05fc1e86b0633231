"""The gated kernel's wrapper and plain version: device rules and checks, the
Philox layout, the row fold; the entry points' device defaults; the kernel
itself against the plain version, path by path, where a CUDA device is present.

Nothing here imports JAX, so the CUDA tests also run where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_gated_kernel.py -m cuda``."""

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_gated, cuda_mc
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import GatedLayout, gated_uniforms
from qmmx_monolithic_monte_carlo_tpu_torch.sim import gatedpath, pathsim
from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import GateConfig
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels
from qmmx_monolithic_monte_carlo_tpu_torch.utils import prng

torch.set_num_threads(2)

ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "orange", "type": "dashed", "index": 0, "price": 100.4},
        {"color": "teal", "type": "solid", "index": 0, "price": 99.7}]
STDS = dict(level_jitter_std=0.02, entry_slip_std=0.01, stop_slip_std=0.015,
            target_slip_std=0.015)
LANES = 256
SIGMA = 0.3


def _levels():
    return Levels.from_rows(ROWS, max_levels=8)


def _uniforms(seed, w, noisy, nb=2, lanes=LANES):
    rng = np.random.default_rng(seed)
    rows = GatedLayout(w, noisy).u_rows
    return torch.from_numpy(
        rng.uniform(1e-9, 1.0, (nb, rows, 8, lanes)).astype(np.float32))


def test_layout_rows_and_philox_uniforms():
    lay = GatedLayout(40)
    assert (lay.stride, lay.u_rows, lay.row(3, 5)) == (8, 160, 29)
    assert (GatedLayout(40, True).stride, GatedLayout(40, True).u_rows) == (16, 320)
    with pytest.raises(ValueError):
        GatedLayout(41)
    u = gated_uniforms(5, lay, block0=3, n_blocks=2, lanes=64)
    assert u.shape == (2, 160, 8, 64)
    # row r of block b is one row of 8 x lanes paths on the gated stream
    flat = prng.uniform_rows(5, prng.STREAM_GATED, block0=4, n_blocks=1,
                             n_rows=160, lanes=8 * 64)
    assert torch.equal(u[1].reshape(160, -1), flat[0])


def test_philox_mode_draws_the_layout_uniforms():
    """Philox mode == injecting gated_uniforms, bit for bit, in any chunking."""
    kw = dict(num_paths=3 * 8 * LANES, num_bars=12, sigma=SIGMA, lanes=LANES,
              antithetic=True, noise=McNoise.make(**STDS))
    u = gated_uniforms(9, GatedLayout(12, True), block0=0, n_blocks=3, lanes=LANES)
    a = cuda_gated.gated_totals_reference(9, _levels(), EngineParams.default(),
                                          device="cpu", chunk_blocks=2,
                                          per_path=True, **kw)
    b = cuda_gated.gated_totals_reference(9, _levels(), EngineParams.default(),
                                          external_uniforms=u, chunk_blocks=3,
                                          per_path=True, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert torch.allclose(a[1], b[1], rtol=1e-12, atol=1e-9)
    assert int(a[0][5]) > int(a[0][1]) > 0          # several trades per path


def test_wrapper_takes_plain_version_for_cpu():
    u = _uniforms(1, 16, True)
    kw = dict(num_paths=2 * 8 * LANES, num_bars=16, sigma=SIGMA, lanes=LANES,
              noise=McNoise.make(**STDS), external_uniforms=u)
    gate = GateConfig.default(touch_limit=100, touch_gap_bars=1)
    before = dict(cuda_gated.LAUNCHES)
    a = cuda_gated.mc_paths_gated_fused(0, _levels(), EngineParams.default(),
                                        gate, **kw)
    b = cuda_gated.stats_from_gated_totals(*cuda_gated.gated_totals_reference(
        0, _levels(), EngineParams.default(), gate, **kw))
    assert cuda_gated.LAUNCHES == before
    for f in ("n", "n_entered", "n_tp", "n_stop", "n_open", "sum_r", "min_r",
              "max_r", "sum_trades", "sum_dd", "max_dd"):
        assert float(getattr(a, f)) == float(getattr(b, f)), f
    assert torch.equal(a.hist, b.hist)
    assert (a.hist_lo, a.hist_hi) == (pathsim.LIFE_HIST_LO, pathsim.LIFE_HIST_HI)
    assert float(a.sum_trades) > float(a.n_entered) > 0


def test_default_gate_is_from_params():
    u = _uniforms(2, 8, False, nb=1)
    params = EngineParams.default(q_min_prob=0.75)
    kw = dict(num_paths=8 * LANES, num_bars=8, sigma=SIGMA, lanes=LANES,
              external_uniforms=u)
    a = cuda_gated.gated_totals_reference(0, _levels(), params, **kw)
    b = cuda_gated.gated_totals_reference(
        0, _levels(), params, GateConfig.from_params(params), **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_reduce_rows_plain_and_totals_to_stats():
    rng = np.random.default_rng(2)
    counts = torch.from_numpy(rng.integers(0, 1000, (7, cuda_gated.ROW_COUNTS)))
    floats = torch.from_numpy(rng.normal(size=(7, cuda_gated.ROW_FLOATS))
                              .astype(np.float32))
    c, f = cuda_gated.reduce_rows(counts, floats)
    assert torch.equal(c, counts.sum(0))
    assert float(f[3]) == float(floats[:, 3].min())
    assert float(f[4]) == float(floats[:, 4].max())
    assert float(f[5]) == float(floats[:, 5].max())
    assert float(f[2]) == pytest.approx(float(floats[:, 2].double().sum()))
    empty = torch.zeros(cuda_gated.ROW_COUNTS, dtype=torch.int64)
    empty[0] = 5
    s = cuda_gated.stats_from_gated_totals(
        empty, torch.tensor([0.0, 0.0, 0.0, 3.4e38, -3.4e38, 0.0],
                            dtype=torch.float64))
    assert float(s.min_r) == float("inf") and float(s.max_r) == float("-inf")
    assert float(s.max_dd) == 0.0 and float(s.n) == 5.0


def test_counts_stay_exact_int64_past_2_24():
    big = torch.zeros(cuda_gated.ROW_COUNTS, dtype=torch.int64)
    big[:6] = (1 << 28) + 1
    c, _ = cuda_gated.reduce_rows(big.view(1, -1).repeat(3, 1),
                                  torch.zeros((3, cuda_gated.ROW_FLOATS)))
    assert int(c[5]) == 3 * ((1 << 28) + 1)


def _entry_points():
    lv, p = _levels(), EngineParams.default()
    return {
        "mc_paths_fused": lambda: cuda_mc.mc_paths_fused(
            0, lv, p, num_paths=256, num_bars=8, lanes=256),
        "fused_totals_reference": lambda: cuda_mc.fused_totals_reference(
            0, lv, p, num_paths=256, num_bars=8, lanes=256),
        "pathsim.mc_paths": lambda: pathsim.mc_paths(
            0, lv, p, num_paths=256, num_bars=8, block_paths=256),
        "mc_paths_gated_fused": lambda: cuda_gated.mc_paths_gated_fused(
            0, lv, p, num_paths=8 * LANES, num_bars=8, lanes=LANES),
        "gated_totals_reference": lambda: cuda_gated.gated_totals_reference(
            0, lv, p, num_paths=8 * LANES, num_bars=8, lanes=LANES),
        "gatedpath.mc_paths_gated": lambda: gatedpath.mc_paths_gated(
            0, lv, p, num_paths=256, num_bars=8, block_paths=256),
    }


@pytest.mark.parametrize("name", list(_entry_points()))
def test_entry_points_default_to_the_card(name):
    """device=None means the CUDA device: without one it raises, naming the
    way to the CPU; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry point runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


@pytest.mark.parametrize("bad", ["paths", "odd_bars", "levels", "shape", "dtype",
                                 "numpy", "antithetic_lanes", "seed"])
def test_wrapper_rejects_bad_inputs(bad):
    levels = _levels()
    kw = dict(num_paths=2 * 8 * LANES, num_bars=8, lanes=LANES, device="cpu")
    if bad == "paths":
        kw["num_paths"] = 8 * LANES + 256
    elif bad == "odd_bars":
        kw["num_bars"] = 9
    elif bad == "levels":
        levels = Levels.from_rows(
            [{"color": "blue", "type": "solid", "index": i, "price": 100.0 + i}
             for i in range(9)], max_levels=16)
    elif bad == "shape":
        kw["external_uniforms"] = torch.rand(2, 31, 8, LANES)
    elif bad == "dtype":
        kw["external_uniforms"] = torch.rand(2, 32, 8, LANES, dtype=torch.float64)
    elif bad == "numpy":
        kw["external_uniforms"] = np.full((2, 32, 8, LANES), 0.5, np.float32)
    elif bad == "antithetic_lanes":
        kw.update(lanes=128, num_paths=8 * 128, antithetic=True)
    else:
        kw["seed"] = 1 << 33
    seed = kw.pop("seed", 0)
    with pytest.raises(ValueError):
        cuda_gated.mc_paths_gated_fused(seed, levels, EngineParams.default(), **kw)


def test_rows_launcher_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gated.gated_rows(
            0, _levels(), EngineParams.default(), num_paths=8 * LANES,
            num_bars=8, s0=100.0, mu=0.0, sigma=SIGMA, dt=1e-5, lanes=LANES,
            noise=None, antithetic=False, external_uniforms=None, device="cpu")


def per_path_budget(got_rows, want_rows) -> int:
    """Paths that differ: in trades/wins/losses/open, or in equity or dd by
    more than 1e-3 per trade (a flipped decision may keep the counts)."""
    err = (got_rows[:, [0, 5]] - want_rows[:, [0, 5]]).abs().amax(dim=1)
    differ = ((got_rows[:, 1:5] != want_rows[:, 1:5]).any(dim=1)
              | (err > 1e-3 * torch.clamp(want_rows[:, 1], min=1.0)))
    return int(differ.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("noisy,antithetic", [(False, False), (True, True)])
def test_cuda_kernel_matches_plain_per_path(noisy, antithetic):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    lanes, nb, w = 1024, 4, 40
    u = _uniforms(4, w, noisy, nb=nb, lanes=lanes)
    kw = dict(num_paths=nb * 8 * lanes, num_bars=w, s0=100.0, mu=0.0,
              sigma=SIGMA, dt=1.0 / (390.0 * 252.0), lanes=lanes,
              noise=McNoise.make(**STDS) if noisy else None,
              antithetic=antithetic)
    gate = GateConfig.default(touch_limit=100, touch_gap_bars=1,
                              use_confidence=False)
    want = cuda_gated.gated_totals_reference(
        0, _levels(), EngineParams.default(), gate, external_uniforms=u,
        per_path=True, **kw)
    before = cuda_gated.LAUNCHES["mc_gated"]
    pc, pf, rows = cuda_gated.gated_rows(
        0, _levels(), EngineParams.default(), gate, external_uniforms=u.cuda(),
        device=torch.device("cuda"), per_path=True, **kw)
    counts, _ = cuda_gated.reduce_rows(pc, pf)
    torch.cuda.synchronize()
    assert cuda_gated.LAUNCHES["mc_gated"] == before + 1
    flips = 2 + kw["num_paths"] // 1024
    assert per_path_budget(rows.cpu(), want[2]) <= flips
    assert int(counts[0]) == int(want[0][0])
    assert abs(int(counts[1]) - int(want[0][1])) <= flips
    assert int((counts[6:] - want[0][6:].cuda()).abs().sum()) <= 2 * flips
