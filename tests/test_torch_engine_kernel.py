"""The engine kernel's wrapper and plain version: checks and error messages,
the Philox layout, the argument packing, the row fold, the CPU path, the
entry points' device defaults; the kernel itself against the plain version,
path by path, where a CUDA device is present.

Nothing here imports JAX, so the CUDA tests also run where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_engine_kernel.py -m cuda``."""

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.engine.state import MlModel
from qmmx_monolithic_monte_carlo_tpu_torch.models.online_policy import PolicyParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine as CE
from qmmx_monolithic_monte_carlo_tpu_torch.ops import guard as G
from qmmx_monolithic_monte_carlo_tpu_torch.ops import touch as T
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout, engine_uniforms
from qmmx_monolithic_monte_carlo_tpu_torch.sim import enginepath, pathsim
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels
from qmmx_monolithic_monte_carlo_tpu_torch.utils import prng

torch.set_num_threads(2)

ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "orange", "type": "dashed", "index": 0, "price": 100.4},
        {"color": "teal", "type": "solid", "index": 0, "price": 99.6}]
STDS = dict(level_jitter_std=0.02, entry_slip_std=0.01, stop_slip_std=0.015,
            target_slip_std=0.015)
LANES = 256
SIGMA = 0.3


def _levels():
    return Levels.from_rows(ROWS, max_levels=8)


def _uniforms(seed, w, noisy, nb=2, lanes=LANES):
    rng = np.random.default_rng(seed)
    rows = EngineLayout(w, noisy).u_rows
    return torch.from_numpy(
        rng.uniform(1e-6, 1.0, (nb, rows, 8, lanes)).astype(np.float32))


def _armed_gates():
    """The ML model and policy of tests/test_pallas_engine.py:225-242."""
    rng = np.random.default_rng(7)
    w_entry = rng.normal(0, 0.8, (3, 7)).astype(np.float32)
    w_entry[0, 0] += 0.8
    w_entry[1, 0] += 0.8
    w_entry[2, 0] -= 0.5
    pol = PolicyParams.init().replace(w_entry=torch.from_numpy(w_entry))
    ml = MlModel.from_weights(np.array([0.4, -0.8, -0.3, 0.2], np.float32), 0.55)
    return dict(policy=pol, ml_model=ml)


def _passing_gates():
    """The armed ML model with a policy that passes from bar ~12 on."""
    w_entry = np.zeros((3, 7), np.float32)
    w_entry[0, 0], w_entry[0, 6] = -0.6, 20.0
    w_entry[1, 0], w_entry[1, 6] = -0.2, 20.0
    w_entry[2, 0] = -1.0
    return dict(_armed_gates(),
                policy=PolicyParams.init().replace(w_entry=torch.from_numpy(w_entry)))


def test_layout_rows_and_philox_uniforms():
    lay = EngineLayout(40)
    assert (lay.stride, lay.u_rows, lay.row(3, 5)) == (10, 200, 35)
    assert (EngineLayout(40, True).stride, EngineLayout(40, True).u_rows) == (18, 360)
    assert EngineLayout(41).u_rows == 210      # an odd W: one more step of rows
    with pytest.raises(ValueError):
        EngineLayout(41, book=True)            # a book walks double bars
    u = engine_uniforms(5, lay, block0=3, n_blocks=2, lanes=64)
    assert u.shape == (2, 200, 8, 64)
    flat = prng.uniform_rows(5, prng.STREAM_ENGINE, block0=4, n_blocks=1,
                             n_rows=200, lanes=8 * 64)
    assert torch.equal(u[1].reshape(200, -1), flat[0])
    assert prng.STREAM_ENGINE not in (prng.STREAM_GATED, prng.STREAM_PATH)


def test_philox_mode_draws_the_layout_uniforms():
    """Philox mode == injecting engine_uniforms, bit for bit, in any chunking."""
    kw = dict(num_paths=3 * 8 * LANES, num_bars=12, sigma=SIGMA, lanes=LANES,
              antithetic=True, noise=McNoise.make(**STDS))
    u = engine_uniforms(9, EngineLayout(12, True), block0=0, n_blocks=3, lanes=LANES)
    a = CE.engine_totals_reference(9, _levels(), EngineParams.default(),
                                   device="cpu", chunk_blocks=2, per_path=True, **kw)
    b = CE.engine_totals_reference(9, _levels(), EngineParams.default(),
                                   external_uniforms=u, chunk_blocks=3,
                                   per_path=True, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert torch.allclose(a[1], b[1], rtol=1e-12, atol=1e-9)
    assert int(a[0][5]) > int(a[0][1]) > 0          # several trades per path


@pytest.mark.parametrize("noisy,anti", [(False, False), (True, True)])
def test_plain_equals_the_replay_on_its_own_bars(noisy, anti):
    """The plain version drives sim.enginepath's step on the bars it
    generates: replaying those bars gives the same rows and skip table."""
    lay = EngineLayout(40, noisy)
    u = _uniforms(1 + noisy, 40, noisy)
    noise = McNoise.make(**STDS) if noisy else None
    counts, _, rows = CE.engine_totals_reference(
        0, _levels(), EngineParams.default(), num_paths=2 * 8 * LANES,
        num_bars=40, sigma=SIGMA, noise=noise, antithetic=anti,
        external_uniforms=u, chunk_blocks=1, per_path=True)
    bars, tie, nz = CE.engine_bars_from_uniforms(u, lay, sigma=SIGMA,
                                                 antithetic=anti)
    out = enginepath.engine_path_replay(bars, _levels(), EngineParams.default(),
                                        tie, noise=noise, noise_normals=nz)
    want = torch.stack([out.equity, out.trades.float(), out.wins.float(),
                        out.losses.float(), out.open_at_end.float(), out.max_dd,
                        out.escalations.float()], 1)
    assert rows.shape == (2 * 8 * LANES, CE.PATH_COLS)
    assert torch.equal(rows[:, :7], want)
    assert torch.equal(counts[CE.N_COUNTS:CE.N_COUNTS + CE.N_SKIPS], out.skip_counts)
    assert torch.equal(rows[:, 7:].long().sum(0), out.skip_counts)
    assert int(rows[:, 7:].sum(1).max()) <= 40      # one reason a bar at most
    assert int(counts[6]) == int(out.escalations.sum()) > 0
    assert int(counts[5]) > int(counts[1]) > 0


def test_wrapper_takes_plain_version_for_cpu():
    u = _uniforms(3, 16, True)
    kw = dict(num_paths=2 * 8 * LANES, num_bars=16, sigma=SIGMA, lanes=LANES,
              noise=McNoise.make(**STDS), external_uniforms=u, **_armed_gates())
    before = dict(CE.LAUNCHES)
    stats, skips, escal = CE.mc_paths_engine_fused(0, _levels(),
                                                   EngineParams.default(), **kw)
    ref = CE.stats_from_engine_totals(*CE.engine_totals_reference(
        0, _levels(), EngineParams.default(), **kw))
    assert CE.LAUNCHES == before
    for f in ("n", "n_entered", "n_tp", "n_stop", "n_open", "sum_r", "min_r",
              "max_r", "sum_trades", "sum_dd", "max_dd"):
        assert float(getattr(stats, f)) == float(getattr(ref[0], f)), f
    assert torch.equal(stats.hist, ref[0].hist) and torch.equal(skips, ref[1])
    assert int(escal) == int(ref[2])
    assert (stats.hist_lo, stats.hist_hi) == (pathsim.LIFE_HIST_LO, pathsim.LIFE_HIST_HI)
    names = dict(zip((r.name for r in enginepath.SKIP_REASONS), skips.tolist()))
    assert names["ML_CONF_LOW"] > 0 and names["ONLINE_POLICY"] > 0


def test_pack_args_fills_the_kernel_arguments():
    params = EngineParams.default(w_rules=0.6, w_ml=0.6, q_min_prob=0.55)
    levels = _levels()
    armed = _armed_gates()
    kw = enginepath.engine_knobs(bar0_minute=7, **armed)
    args = CE._pack_args(3, levels, params, kw,
                         EngineLayout(40, True), n=1, num_paths=8 * LANES, s0=100.0,
                         mu=0.0, sigma=SIGMA, dt=1e-5, lanes=LANES,
                         noise=McNoise.make(**STDS), antithetic=False,
                         volume_model=None, symbols=[0]).view(np.recarray)[0]
    assert args.w_rules == args.w_ml == pytest.approx(0.5)
    assert args.prox == pytest.approx(0.05) and args.veto_near == pytest.approx(0.06)
    assert list(args.level_valid) == [1, 1, 1, 0, 0, 0, 0, 0]
    assert list(args.level_round)[:3] == pytest.approx([100.0, 100.4, 99.6])
    assert list(args.level_kind)[:3] == [1, 0, 1]     # blue solid, orange dashed, teal solid
    assert (args.stride, args.u_rows, args.num_bars) == (18, 360, 40)
    assert args.ml_usable == 1 and args.policy_on == 1 and args.bar0_minute == 7
    assert args.cooldown_ms == 8000 and args.tm_max_bounces == 2
    assert args.g_comp == pytest.approx(18.0 / 10000.0)
    assert args.stream == prng.STREAM_ENGINE and args.seed == 3
    assert list(args.pol_w[2]) == pytest.approx(
        _armed_gates()["policy"].w_entry[2].tolist())
    assert args.vm_half_s2 == pytest.approx(0.5 * 0.35 ** 2)


def test_reduce_rows_plain_and_totals_to_stats():
    rng = np.random.default_rng(2)
    counts = torch.from_numpy(rng.integers(0, 1000, (7, CE.ROW_COUNTS)))
    floats = torch.from_numpy(rng.normal(size=(7, CE.ROW_FLOATS)).astype(np.float32))
    c, f = CE.reduce_rows(counts, floats)
    assert torch.equal(c, counts.sum(0))
    assert float(f[3]) == float(floats[:, 3].min())
    assert float(f[4]) == float(floats[:, 4].max())
    assert float(f[5]) == float(floats[:, 5].max())
    assert float(f[2]) == pytest.approx(float(floats[:, 2].double().sum()))
    empty = torch.zeros(CE.ROW_COUNTS, dtype=torch.int64)
    empty[0], empty[6], empty[CE.N_COUNTS + 4] = 5, 3, 11
    s, skips, escal = CE.stats_from_engine_totals(
        empty, torch.tensor([0.0, 0.0, 0.0, 3.4e38, -3.4e38, 0.0], dtype=torch.float64))
    assert float(s.min_r) == float("inf") and float(s.max_r) == float("-inf")
    assert float(s.max_dd) == 0.0 and float(s.n) == 5.0
    assert int(escal) == 3 and int(skips[4]) == 11 and skips.shape == (16,)


def test_counts_stay_exact_int64_past_2_24():
    big = torch.zeros(CE.ROW_COUNTS, dtype=torch.int64)
    big[:CE.N_COUNTS + CE.N_SKIPS] = (1 << 28) + 1
    c, _ = CE.reduce_rows(big.view(1, -1).repeat(3, 1),
                          torch.zeros((3, CE.ROW_FLOATS)))
    assert int(c[CE.N_COUNTS + 4]) == 3 * ((1 << 28) + 1)


def _entry_points():
    lv, p = _levels(), EngineParams.default()
    return {
        "mc_paths_engine_fused": lambda: CE.mc_paths_engine_fused(
            0, lv, p, num_paths=8 * LANES, num_bars=8, lanes=LANES),
        "engine_totals_reference": lambda: CE.engine_totals_reference(
            0, lv, p, num_paths=8 * LANES, num_bars=8, lanes=LANES),
        "enginepath.mc_paths_engine": lambda: enginepath.mc_paths_engine(
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


BAD = {
    "paths": (dict(num_paths=8 * LANES + 256), "multiple of 2048"),
    "odd_bars": (dict(num_bars=1), "at least 2"),
    "long_bars": (dict(num_bars=40000), "num_bars <= 35791"),
    "levels": (dict(levels=65), "up to 64 level slots"),
    "shape": (dict(external_uniforms=torch.rand(2, 31, 8, LANES)), "shape"),
    "dtype": (dict(external_uniforms=torch.rand(2, 40, 8, LANES, dtype=torch.float64)),
              "float32"),
    "numpy": (dict(external_uniforms=np.full((2, 40, 8, LANES), 0.5, np.float32)),
              "torch tensor"),
    "antithetic_lanes": (dict(lanes=128, num_paths=8 * 128, antithetic=True),
                         "lanes % 256"),
    "seed": (dict(seed=1 << 33), "seed"),
    "fatigue_hits": (dict(touch_params=T.TouchMemoryParams.default().replace(
        fatigue_hits=4)), "fatigue_hits == 3"),
    "guard_mas": (dict(guard_params=G.GuardParams.default().replace(vol_short=4)),
                  "5/20-bar guard MAs"),
}


@pytest.mark.parametrize("bad", list(BAD))
def test_wrapper_rejects_bad_inputs(bad):
    change, msg = BAD[bad]
    kw = dict(num_paths=2 * 8 * LANES, num_bars=8, lanes=LANES, device="cpu")
    kw.update(change)
    levels = _levels()
    if "levels" in kw:
        levels = Levels.from_rows(
            [{"color": "blue", "type": "solid", "index": i, "price": 100.0 + i}
             for i in range(9)], max_levels=kw.pop("levels"))
    seed = kw.pop("seed", 0)
    with pytest.raises(ValueError, match=msg):
        CE.mc_paths_engine_fused(seed, levels, EngineParams.default(), **kw)


def test_rows_launcher_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        CE.engine_rows(0, _levels(), EngineParams.default(), num_paths=8 * LANES,
                       num_bars=8, lanes=LANES, device="cpu")


def per_path_budget(got_rows, want_rows) -> int:
    """Paths that differ: in trades/wins/losses/open/escalations or any of
    the 16 skip counts, or in equity or dd by more than 1e-3 per trade (a
    flipped decision may keep the counts)."""
    cols = [1, 2, 3, 4] + list(range(6, CE.PATH_COLS))
    err = (got_rows[:, [0, 5]] - want_rows[:, [0, 5]]).abs().amax(dim=1)
    differ = (((got_rows[:, cols] != want_rows[:, cols]).any(dim=1))
              | (err > 1e-3 * torch.clamp(want_rows[:, 1], min=1.0)))
    return int(differ.sum())


def assert_skips_within(counts, want_counts, differing: int, w: int) -> None:
    """Each skip counter's total within W per differing path (a path moves
    at most one first-fail reason a bar): equal where no path differs."""
    skips = slice(CE.N_COUNTS, CE.N_COUNTS + CE.N_SKIPS)
    assert int((counts[skips].cpu() - want_counts[skips].cpu()).abs().max()) <= w * differing


BLEND = dict(use_blend=True, w_rules=0.5, w_ml=0.7, q_min_prob=0.62)
CUDA_CASES = {"defaults": (False, False, None, {}),
              "noise+antithetic": (True, True, None, {}),
              "ml+policy": (False, False, _armed_gates, {}),
              "policy-passing": (False, False, _passing_gates, {}),
              "blend": (False, False, _passing_gates, BLEND)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_cuda_kernel_matches_plain_per_path(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    noisy, anti, armed, params_kw = CUDA_CASES[case]
    params = EngineParams.default(**params_kw)
    nb, w = 4, 40
    u = _uniforms(4, w, noisy, nb=nb)
    kw = dict(num_paths=nb * 8 * LANES, num_bars=w, sigma=SIGMA, lanes=LANES,
              noise=McNoise.make(**STDS) if noisy else None, antithetic=anti,
              **(armed() if armed else {}))
    want = CE.engine_totals_reference(0, _levels(), params,
                                      external_uniforms=u, per_path=True, **kw)
    before = CE.LAUNCHES["mc_engine_rows"]
    pc, pf, rows = CE.engine_rows(0, _levels(), params,
                                  external_uniforms=u.cuda(), per_path=True, **kw)
    counts, _ = CE.reduce_rows(pc, pf)
    torch.cuda.synchronize()
    assert CE.LAUNCHES["mc_engine_rows"] == before + 1
    flips = 2 + kw["num_paths"] // 1024
    differing = per_path_budget(rows.cpu(), want[2])
    assert differing <= flips
    assert int(counts[0]) == int(want[0][0])
    assert_skips_within(counts, want[0], differing, w)


@pytest.mark.cuda
def test_cuda_kernel_philox_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    kw = dict(num_paths=16 * 8 * LANES, num_bars=40, sigma=SIGMA, lanes=LANES,
              noise=McNoise.make(**STDS))
    want = CE.engine_totals_reference(11, _levels(), EngineParams.default(),
                                      device="cuda", per_path=True, **kw)
    pc, pf, rows = CE.engine_rows(11, _levels(), EngineParams.default(),
                                  per_path=True, **kw)
    got = CE.reduce_rows(pc, pf)
    torch.cuda.synchronize()
    flips = 2 + kw["num_paths"] // 1024
    differing = per_path_budget(rows.cpu(), want[2].cpu())
    assert differing <= flips
    assert_skips_within(got[0], want[0], differing, kw["num_bars"])
    plain_fold = CE.reduce_rows_reference(pc, pf)
    assert torch.equal(got[0], plain_fold[0])
    assert torch.allclose(got[1], plain_fold[1], rtol=1e-9, atol=1e-9)
