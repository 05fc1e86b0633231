"""The universe kernels' wrappers and plain versions, the port alone: the
symbol in the Philox key; each plain universe's row s equals the
single-configuration plain version at symbol s's inputs and key (Philox and
injected uniforms), and a one-symbol universe is today's single run; a cell
(s, g) of the sweep of universes equals the universe under row g's knobs;
the wrappers' checks, device rules, launch counts and int64 folds; the
refresh's device rule and unported mesh; and, where a CUDA device is
present, each universe kernel against its plain version and against the
single-configuration kernel at each symbol, bit for bit.

The plain versions are held against JAX in ``test_torch_universe.py``.
Nothing here imports JAX, so the CUDA tests also run where JAX is not
installed:
``python -m pytest --noconftest tests/test_torch_universe_kernel.py -m cuda``."""

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.models import logistic as L
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine, cuda_gated, cuda_mc
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import (EngineLayout, GatedLayout,
                                                             GbmLayout, fused_uniforms)
from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import grid_row, sg_rows
from qmmx_monolithic_monte_carlo_tpu_torch.parallel import universe as U
from qmmx_monolithic_monte_carlo_tpu_torch.sim.gatedpath import GateConfig
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.utils import prng

torch.set_num_threads(2)

SIGMA = 0.3
DT = 1.0 / (390.0 * 252.0)
SYM_ROWS = [
    [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
     {"color": "teal", "type": "solid", "index": 0, "price": 99.6}],
    [{"color": "red", "type": "dashed", "index": 0, "price": 100.3}],
    [{"color": "green", "type": "solid", "index": 0, "price": 99.7},
     {"color": "orange", "type": "dashed", "index": 0, "price": 100.4}],
]
S0 = np.array([100.0, 100.1, 99.9], np.float32)
SIGMAS = np.array([0.3, 0.2, 0.35], np.float32)
# per-symbol knobs ([S] leaves) and noise stds
KNOBS = dict(stop_padding=torch.tensor([0.35, 0.20, 0.45]),
             tp_padding=torch.tensor([0.25, 0.40, 0.15]),
             q_min_prob=torch.tensor([0.60, 0.40, 0.55]))


def _levels(rows=SYM_ROWS):
    return U.stack_levels(rows, max_levels=8)


def _params():
    return EngineParams.default().replace(**KNOBS)


def _noise():
    return McNoise(level_jitter_std=torch.tensor([0.0, 0.02, 0.01]),
                   entry_slip_std=torch.tensor([0.01, 0.0, 0.0]),
                   stop_slip_std=torch.tensor([0.0, 0.015, 0.0]),
                   target_slip_std=torch.tensor([0.015, 0.0, 0.0]))


def _uniforms(seed, shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(1e-6, 1.0, shape).astype(np.float32))


# ---------------------------------------------------------------------------
# the symbol in the key
# ---------------------------------------------------------------------------

def test_stream_key_symbol_zero_is_the_single_key_and_keys_are_distinct():
    assert all(prng.stream_key(st) == st == prng.stream_key(st, 0) for st in range(16))
    keys = {prng.stream_key(st, sym) for st in range(16) for sym in range(64)}
    assert len(keys) == 16 * 64
    assert prng.stream_key(prng.STREAM_ENGINE, (1 << 24) - 1) < 1 << 32
    for bad in (dict(stream=256), dict(stream=-1), dict(stream=5, symbol=1 << 24),
                dict(stream=5, symbol=-1)):
        with pytest.raises(ValueError):
            prng.stream_key(**bad)


def test_symbol_keys_every_draw():
    layout = GbmLayout(8)
    a = fused_uniforms(3, layout, block0=2, n_blocks=1, lanes=64)
    assert torch.equal(a, fused_uniforms(3, layout, block0=2, n_blocks=1, lanes=64, symbol=0))
    b = fused_uniforms(3, layout, block0=2, n_blocks=1, lanes=64, symbol=1)
    assert not torch.equal(a, b)
    # symbol 1 of stream k draws what key word k + 256 draws
    words = prng.philox4x32((torch.arange(64), 0, 2, 0), (3, prng.STREAM_PATH + 256))
    assert torch.equal(b[0, 0], prng.to_uniform(words[0]))


# ---------------------------------------------------------------------------
# plain universes: row s equals the single configuration at symbol s
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["philox", "injected"])
def test_first_contact_universe_rows_equal_single_runs(mode):
    lanes, w = 1024, 24
    params = EngineParams.default().replace(
        contact_prox=torch.tensor([0.05, 0.08, 0.03]), stop_padding=KNOBS["stop_padding"],
        tp_padding=KNOBS["tp_padding"])
    kw = dict(paths_per_symbol=2 * lanes, num_bars=w, dt=DT, lanes=lanes)
    u = _uniforms(1, (3, 2, GbmLayout(w).n_rows, lanes)) if mode == "injected" else None
    kw.update(external_uniforms=u) if u is not None else kw.update(device="cpu")
    counts, floats = cuda_mc.universe_totals_reference(4, _levels(), params, S0, SIGMAS, **kw)
    assert counts.shape == (3, cuda_mc.ROW_COUNTS) and floats.dtype == torch.float64
    for s in range(3):
        one = dict(num_paths=2 * lanes, num_bars=w, dt=DT, lanes=lanes, s0=float(S0[s]),
                   sigma=float(SIGMAS[s]), symbol=s,
                   **(dict(external_uniforms=u[s]) if u is not None else dict(device="cpu")))
        c, f = cuda_mc.fused_totals_reference(4, grid_row(_levels(), s), grid_row(params, s),
                                              **one)
        assert torch.equal(c, counts[s]) and torch.equal(f, floats[s]), s
    assert len(set(counts[:, 3].tolist())) == 3          # the symbols decide differently
    stats = cuda_mc.mc_paths_universe_fused(4, _levels(), params, S0, SIGMAS, **kw)
    assert stats.n.shape == (3,) and torch.equal(stats.n_stop, counts[:, 3].float())


@pytest.mark.parametrize("mode", ["philox", "injected"])
def test_gated_universe_rows_equal_single_runs(mode):
    lanes, w = 256, 16
    gate = GateConfig.default(touch_limit=100, touch_gap_bars=1)
    kw = dict(paths_per_symbol=8 * lanes, num_bars=w, dt=DT, lanes=lanes, noise=_noise())
    u = _uniforms(2, (3, 1, GatedLayout(w, True).u_rows, 8, lanes)) \
        if mode == "injected" else None
    kw.update(external_uniforms=u) if u is not None else kw.update(device="cpu")
    counts, floats, rows = cuda_gated.gated_universe_totals_reference(
        6, _levels(), _params(), S0, SIGMAS, gate, per_path=True, **kw)
    assert rows.shape == (3, 8 * lanes, cuda_gated.PATH_COLS)
    for s in range(3):
        one = dict(num_paths=8 * lanes, num_bars=w, dt=DT, lanes=lanes, s0=float(S0[s]),
                   sigma=float(SIGMAS[s]), noise=grid_row(_noise(), s), symbol=s,
                   **(dict(external_uniforms=u[s]) if u is not None else dict(device="cpu")))
        c, f, r = cuda_gated.gated_totals_reference(
            6, grid_row(_levels(), s), grid_row(_params(), s), gate, per_path=True, **one)
        assert torch.equal(c, counts[s]) and torch.equal(f, floats[s]), s
        assert torch.equal(r, rows[s]), s
    assert len(set(counts[:, 5].tolist())) == 3


@pytest.mark.parametrize("mode", ["philox", "injected"])
def test_engine_universe_rows_equal_single_runs(mode):
    lanes, w = 256, 16
    kw = dict(paths_per_symbol=8 * lanes, num_bars=w, dt=DT, lanes=lanes, noise=_noise())
    u = _uniforms(3, (3, 1, EngineLayout(w, True).u_rows, 8, lanes)) \
        if mode == "injected" else None
    kw.update(external_uniforms=u) if u is not None else kw.update(device="cpu")
    counts, floats, rows = cuda_engine.engine_universe_totals_reference(
        8, _levels(), _params(), S0, SIGMAS, per_path=True, **kw)
    for s in range(3):
        one = dict(num_paths=8 * lanes, num_bars=w, dt=DT, lanes=lanes, s0=float(S0[s]),
                   sigma=float(SIGMAS[s]), noise=grid_row(_noise(), s), symbol=s,
                   **(dict(external_uniforms=u[s]) if u is not None else dict(device="cpu")))
        c, f, r = cuda_engine.engine_totals_reference(
            8, grid_row(_levels(), s), grid_row(_params(), s), per_path=True, **one)
        assert torch.equal(c, counts[s]) and torch.equal(f, floats[s]), s
        assert torch.equal(r, rows[s]), s
    stats, skips, escal = cuda_engine.stats_from_engine_totals(counts, floats)
    assert skips.shape == (3, 16) and escal.shape == (3,)
    assert len({tuple(x) for x in skips.tolist()}) == 3


def test_engine_universe_sweep_cells_equal_the_universe_under_each_row():
    """Cell (s, g) of the sweep of universes equals the engine universe at
    symbol s under row g's knobs, bit for bit: [S, G] paddings (each symbol
    its own grid), a [G] q_min row and [G] noise stds."""
    lanes, w = 256, 16
    stops = torch.tensor([[0.35, 0.25], [0.20, 0.30], [0.45, 0.35]])
    qmin = torch.tensor([0.60, 0.45])
    jit = torch.tensor([0.0, 0.02])
    grid = EngineParams.default().replace(stop_padding=stops, q_min_prob=qmin)
    noise = McNoise(level_jitter_std=jit, entry_slip_std=torch.zeros(2),
                    stop_slip_std=torch.zeros(2), target_slip_std=torch.zeros(2))
    kw = dict(paths_per_symbol=8 * lanes, num_bars=w, dt=DT, lanes=lanes, device="cpu")
    counts, floats = cuda_engine.engine_universe_sweep_totals_reference(
        9, _levels(), grid, S0, SIGMAS, noise=noise, **kw)
    assert counts.shape == (3, 2, cuda_engine.ROW_COUNTS)
    for g in range(2):
        params_g = EngineParams.default().replace(stop_padding=stops[:, g], q_min_prob=qmin[g])
        noise_g = McNoise.make(level_jitter_std=float(jit[g]), entry_slip_std=0.0,
                               stop_slip_std=0.0, target_slip_std=0.0)
        c, f = cuda_engine.engine_universe_totals_reference(9, _levels(), params_g, S0, SIGMAS,
                                                            noise=noise_g, **kw)
        assert torch.equal(c, counts[:, g]) and torch.equal(f, floats[:, g]), g
    stats, skips, _ = cuda_engine.mc_paths_engine_universe_sweep_fused(
        9, _levels(), grid, S0, SIGMAS, noise=noise, **kw)
    assert stats.n.shape == (3, 2) and skips.shape == (3, 2, 16)


def test_one_symbol_universes_are_todays_single_runs():
    lv = _levels(SYM_ROWS[:1])
    p = EngineParams.default()
    one_fc = dict(num_bars=16, dt=DT, s0=100.0, sigma=SIGMA, device="cpu")
    a = cuda_mc.mc_paths_universe_fused(2, lv, p, [100.0], [SIGMA], paths_per_symbol=2048,
                                        num_bars=16, dt=DT, device="cpu")
    b = cuda_mc.mc_paths_fused(2, grid_row(lv, 0), p, num_paths=2048, lanes=2048, **one_fc)
    assert torch.equal(a.row(0).sum_r, b.sum_r) and torch.equal(a.row(0).hist, b.hist)
    a = cuda_gated.mc_paths_gated_universe_fused(2, lv, p, [100.0], [SIGMA],
                                                 paths_per_symbol=2048, num_bars=16, dt=DT,
                                                 lanes=256, device="cpu")
    b = cuda_gated.mc_paths_gated_fused(2, grid_row(lv, 0), p, num_paths=2048, lanes=256,
                                        **one_fc)
    assert torch.equal(a.row(0).sum_r, b.sum_r) and torch.equal(a.row(0).hist, b.hist)
    a = cuda_engine.mc_paths_engine_universe_fused(2, lv, p, [100.0], [SIGMA],
                                                   paths_per_symbol=2048, num_bars=16, dt=DT,
                                                   device="cpu")
    b = cuda_engine.mc_paths_engine_fused(2, grid_row(lv, 0), p, num_paths=2048, **one_fc)
    assert torch.equal(a[0].row(0).sum_r, b[0].sum_r) and torch.equal(a[1][0], b[1])


def test_symbols_with_different_level_counts_zero_the_invalid_slots():
    from qmmx_monolithic_monte_carlo_tpu_torch.ops.kernel_args import level_slots, symbol_rows

    rows = symbol_rows(_levels(), S0, SIGMAS)
    prices, valid = zip(*(level_slots(r[0]) for r in rows))
    assert [sum(v) for v in valid] == [2.0, 1.0, 2.0]
    assert all(p == 0.0 for p, v in zip(prices[1], valid[1]) if v == 0.0)
    assert [r[1] for r in rows] == [float(x) for x in S0]       # float64 of the float32s


# ---------------------------------------------------------------------------
# checks, device rules, launches, folds
# ---------------------------------------------------------------------------

def _entries():
    lv, p = _levels(), EngineParams.default()
    fc = dict(paths_per_symbol=2048, num_bars=8)
    life = dict(paths_per_symbol=8 * 256, num_bars=8, lanes=256)
    return {
        "mc_paths_universe_fused": lambda **k: cuda_mc.mc_paths_universe_fused(
            0, lv, p, S0, SIGMAS, **{**fc, **k}),
        "universe_totals_reference": lambda **k: cuda_mc.universe_totals_reference(
            0, lv, p, S0, SIGMAS, **{**fc, **k}),
        "mc_paths_gated_universe_fused": lambda **k: cuda_gated.mc_paths_gated_universe_fused(
            0, lv, p, S0, SIGMAS, **{**life, **k}),
        "gated_universe_totals_reference":
            lambda **k: cuda_gated.gated_universe_totals_reference(
                0, lv, p, S0, SIGMAS, **{**life, **k}),
        "mc_paths_engine_universe_fused": lambda **k: cuda_engine.mc_paths_engine_universe_fused(
            0, lv, p, S0, SIGMAS, **{**life, **k}),
        "engine_universe_totals_reference":
            lambda **k: cuda_engine.engine_universe_totals_reference(
                0, lv, p, S0, SIGMAS, **{**life, **k}),
        "mc_paths_engine_universe_sweep_fused":
            lambda **k: cuda_engine.mc_paths_engine_universe_sweep_fused(
                0, lv, p, S0, SIGMAS, n_grid=2, **{**life, **k}),
        "parallel.universe_mc": lambda **k: U.universe_mc(
            0, lv, p, S0, SIGMAS, paths_per_symbol=256, num_bars=8, block_paths=256, **k),
        "parallel.universe_policy_refresh": lambda **k: U.universe_policy_refresh(
            None, np.zeros((2, 8, 3)), np.zeros((2, 8)), **k),
        "models.logistic.fit": lambda **k: L.fit(np.zeros((8, 3)), np.zeros(8), **k),
        "models.logistic.fit_batched": lambda **k: L.fit_batched(
            np.zeros((2, 8, 3)), np.zeros((2, 8)), **k),
        "models.logistic.fit_sgd": lambda **k: L.fit_sgd(np.zeros((8, 3)), np.zeros(8),
                                                         epochs=1, **k),
    }


@pytest.mark.parametrize("name", list(_entries()))
def test_entry_points_default_to_the_card(name):
    """device=None means the CUDA device: without one it raises, naming the
    way to the CPU; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry point runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entries()[name]()


def test_universe_wrappers_take_the_plain_version_for_cpu():
    mods = (cuda_mc, cuda_gated, cuda_engine)
    before = [dict(m.LAUNCHES) for m in mods]
    for name in ("mc_paths_universe_fused", "mc_paths_gated_universe_fused",
                 "mc_paths_engine_universe_fused", "mc_paths_engine_universe_sweep_fused"):
        out = _entries()[name](device="cpu")
        stats = out[0] if isinstance(out, tuple) else out
        assert stats.n.shape[0] == 3
    assert [dict(m.LAUNCHES) for m in mods] == before


def test_unported_harvest_and_mesh_raise():
    """The harvest is ported (the universe returns each symbol's, and
    harvesting changes no statistic); a mesh is not."""
    lv, p = _levels(), EngineParams.default()
    kw = dict(paths_per_symbol=2048, num_bars=8, device="cpu")
    on = cuda_engine.mc_paths_engine_universe_fused(0, lv, p, S0, SIGMAS, harvest=True, **kw)
    off = cuda_engine.mc_paths_engine_universe_fused(0, lv, p, S0, SIGMAS, **kw)
    assert len(on) == 4 and tuple(on[3].n_labeled.shape) == (3,)
    assert torch.equal(on[3].n_labeled, (on[0].n_tp + on[0].n_stop).to(torch.int64))
    assert torch.equal(on[0].hist, off[0].hist) and torch.equal(on[1], off[1])
    with pytest.raises(NotImplementedError, match="not ported yet"):
        U.universe_policy_refresh(object(), np.zeros((2, 8, 3)), np.zeros((2, 8)),
                                  device="cpu")


@pytest.mark.parametrize("bad", ["single_levels", "s0_length", "leaf_length", "paths",
                                 "uniform_shape", "shared_gate", "grid_symbols", "grid_length",
                                 "too_many_levels"])
def test_universe_wrappers_reject_bad_inputs(bad):
    lv, p = _levels(), EngineParams.default()
    many = U.stack_levels([[{"color": "blue", "type": "solid", "index": i,
                             "price": 100.0 + i} for i in range(9)]] * 3)
    fc = dict(paths_per_symbol=2048, num_bars=8, device="cpu")
    life = dict(paths_per_symbol=8 * 256, num_bars=8, lanes=256, device="cpu")
    calls = {
        "single_levels": [lambda: cuda_mc.mc_paths_universe_fused(
            0, grid_row(lv, 0), p, S0, SIGMAS, **fc)],
        "s0_length": [lambda: cuda_gated.mc_paths_gated_universe_fused(
            0, lv, p, S0[:2], SIGMAS, **life)],
        "leaf_length": [lambda: cuda_engine.mc_paths_engine_universe_fused(
            0, lv, p.replace(stop_padding=[0.2, 0.3]), S0, SIGMAS, **life)],
        "paths": [lambda: cuda_mc.mc_paths_universe_fused(
            0, lv, p, S0, SIGMAS, **dict(fc, paths_per_symbol=3000)),
            lambda: cuda_engine.mc_paths_engine_universe_fused(
                0, lv, p, S0, SIGMAS, **dict(life, paths_per_symbol=8 * 256 + 256))],
        "uniform_shape": [lambda: cuda_mc.mc_paths_universe_fused(
            0, lv, p, S0, SIGMAS, **dict(fc, external_uniforms=torch.zeros(
                (2, 1, GbmLayout(8).n_rows, 2048))))],
        "shared_gate": [lambda: cuda_gated.mc_paths_gated_universe_fused(
            0, lv, p, S0, SIGMAS, GateConfig.default().replace(touch_limit=[1, 2, 3]),
            **life)],
        "grid_symbols": [lambda: cuda_engine.mc_paths_engine_universe_sweep_fused(
            0, lv, p.replace(stop_padding=torch.ones((2, 2))), S0, SIGMAS, **life)],
        "grid_length": [lambda: cuda_engine.mc_paths_engine_universe_sweep_fused(
            0, lv, p.replace(stop_padding=torch.ones((3, 2)), tp_padding=[0.1, 0.2, 0.3]),
            S0, SIGMAS, **life)],
        "too_many_levels": [lambda: cuda_mc.mc_paths_universe_fused(0, many, p, S0, SIGMAS,
                                                                    **fc)],
    }[bad]
    for call in calls:
        with pytest.raises(ValueError):
            call()


def test_sg_rows_take_scalar_g_and_sg_leaves():
    grid = EngineParams.default().replace(stop_padding=torch.tensor([[1.0, 2.0], [3.0, 4.0]]),
                                          tp_padding=[0.1, 0.2])
    rows = sg_rows(grid, None, 2)
    assert [[float(r[0].stop_padding) for r in row] for row in rows] == [[1, 2], [3, 4]]
    assert [r[0].tp_padding for r in rows[1]] == [torch.tensor(0.1), torch.tensor(0.2)]
    q = EngineParams.default().q_min_prob
    assert all(r[1] is None and torch.equal(r[0].q_min_prob, q) for row in rows for r in row)


def test_universe_launchers_refuse_the_cpu():
    lv, p = _levels(), EngineParams.default()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_mc.universe_rows(0, lv, p, S0, SIGMAS, paths_per_symbol=2048, num_bars=8, dt=DT,
                              lanes=2048, external_uniforms=None, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gated.gated_universe_rows(0, lv, p, S0, SIGMAS, paths_per_symbol=2048,
                                       num_bars=8, dt=DT, lanes=256, noise=None,
                                       external_uniforms=None, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_engine.engine_universe_rows(0, lv, p, S0, SIGMAS, paths_per_symbol=2048,
                                         num_bars=8, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_engine.engine_universe_sweep_rows(0, lv, p, S0, SIGMAS, n_grid=2,
                                               paths_per_symbol=2048, num_bars=8, device="cpu")


@pytest.mark.parametrize("mod", [cuda_mc, cuda_gated, cuda_engine])
def test_universe_folds_stay_exact_int64_past_2_24(mod):
    big = torch.zeros((3, 4, mod.ROW_COUNTS), dtype=torch.int64)
    big[..., :6] = (1 << 27) + 3
    big[2] *= 3
    floats = torch.zeros((3, 4, mod.ROW_FLOATS))
    c, f = mod.reduce_rows(big, floats, what="unused on the CPU")
    assert c.shape == (3, mod.ROW_COUNTS) and f.dtype == torch.float64
    assert int(c[0, 5]) == 4 * ((1 << 27) + 3) and int(c[2, 0]) == 12 * ((1 << 27) + 3)
    assert int(c[2, 0]) > 1 << 24 and float(np.float32(int(c[2, 0]))) != int(c[2, 0])


def test_refresh_fits_in_the_inputs_dtype_on_the_cpu():
    rng = np.random.default_rng(0)
    xs = rng.normal(0, 1, (4, 64, 4)).astype(np.float32)
    ys = (rng.uniform(size=(4, 64)) < 0.5).astype(np.int32)
    m32 = U.universe_policy_refresh(None, xs, ys, np.ones((4, 64), np.float32), device="cpu")
    m64 = U.universe_policy_refresh(None, xs.astype(np.float64), ys, device="cpu")
    assert m32.coef.dtype == torch.float32 and m64.coef.dtype == torch.float64
    assert m32.coef.shape == (4, 4) and m32.n_iter.shape == (4,)
    np.testing.assert_allclose(m32.coef.numpy(), m64.coef.numpy(), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _lifecycle_differ(got, want) -> tuple[int, int]:
    """(paths whose trades differ, engine paths that differ in their
    first-fail reasons alone): trades differ in their counts (escalations
    too), or in equity or dd by more than 1e-3 per trade (a flipped decision
    may keep the counts); an engine path whose trades agree may still differ
    in its 16 skip counts (a ulp moved a reason from one gate to another).
    Each kind has the flip budget of ``chip_smoke.py``."""
    ints = [1, 2, 3, 4] + ([6] if got.shape[1] > 6 else [])
    err = (got[:, [0, 5]] - want[:, [0, 5]]).abs().amax(dim=1)
    trades = ((got[:, ints] != want[:, ints]).any(dim=1)
              | (err > 1e-3 * torch.clamp(want[:, 1], min=1.0)))
    reasons = (got[:, 7:] != want[:, 7:]).any(dim=1) & ~trades
    return int(trades.sum()), int(reasons.sum())


@pytest.mark.cuda
def test_cuda_universes_match_their_plain_versions():
    """Injected uniforms: each symbol within the flip budget (first contact
    on totals, gated and engine path by path; the engine also with [S]
    contact proximities)."""
    _need_cuda()
    dev = torch.device("cuda")
    lv, w = _levels(), 40
    params = EngineParams.default().replace(
        contact_prox=torch.tensor([0.05, 0.08, 0.03]), stop_padding=KNOBS["stop_padding"],
        tp_padding=KNOBS["tp_padding"])
    u = _uniforms(11, (3, 4, GbmLayout(w).n_rows, 2048))
    kw = dict(paths_per_symbol=4 * 2048, num_bars=w, dt=DT, lanes=2048)
    want = cuda_mc.universe_totals_reference(0, lv, params, S0, SIGMAS, external_uniforms=u,
                                             **kw)
    got = cuda_mc.reduce_rows(*cuda_mc.universe_rows(
        0, lv, params, S0, SIGMAS, external_uniforms=u.to(dev), device=dev, **kw))
    flips = 2 + kw["paths_per_symbol"] // 1024
    assert torch.equal(got[0][:, 0].cpu(), want[0][:, 0])
    assert int((got[0][:, 1:5].cpu() - want[0][:, 1:5]).abs().max()) <= flips
    gate = GateConfig.default(touch_limit=100, touch_gap_bars=1)
    u = _uniforms(12, (3, 2, GatedLayout(w, True).u_rows, 8, 1024))
    gkw = dict(paths_per_symbol=2 * 8 * 1024, num_bars=w, dt=DT, lanes=1024, noise=_noise(),
               per_path=True)
    want = cuda_gated.gated_universe_totals_reference(0, lv, _params(), S0, SIGMAS, gate,
                                                      external_uniforms=u, **gkw)
    got = cuda_gated.gated_universe_rows(0, lv, _params(), S0, SIGMAS, gate,
                                         external_uniforms=u.to(dev), device=dev, **gkw)
    for s in range(3):
        trades, reasons = _lifecycle_differ(got[2][s].cpu(), want[2][s])
        assert trades <= 2 + 16 and reasons == 0, (s, trades)
    u = _uniforms(13, (3, 2, EngineLayout(w, True).u_rows, 8, 256))
    ekw = dict(paths_per_symbol=2 * 8 * 256, num_bars=w, dt=DT, lanes=256, noise=_noise(),
               per_path=True)
    for p in (_params(), _params().replace(contact_prox=torch.tensor([0.05, 0.08, 0.03]))):
        want = cuda_engine.engine_universe_totals_reference(0, lv, p, S0, SIGMAS,
                                                            external_uniforms=u, **ekw)
        got = cuda_engine.engine_universe_rows(0, lv, p, S0, SIGMAS,
                                               external_uniforms=u.to(dev), device=dev, **ekw)
        for s in range(3):
            trades, reasons = _lifecycle_differ(got[2][s].cpu(), want[2][s])
            assert trades <= 2 + 4 and reasons <= 2 + 4, (s, trades, reasons)
    stops = torch.tensor([[0.35, 0.25], [0.20, 0.30], [0.45, 0.35]])
    grid = EngineParams.default().replace(stop_padding=stops)
    ekw["noise"] = McNoise(level_jitter_std=torch.tensor([0.0, 0.02]),
                           entry_slip_std=torch.zeros(2), stop_slip_std=torch.zeros(2),
                           target_slip_std=torch.zeros(2))          # [G] stds
    want = cuda_engine.engine_universe_sweep_totals_reference(
        0, lv, grid, S0, SIGMAS, external_uniforms=u, **ekw)
    got = cuda_engine.engine_universe_sweep_rows(0, lv, grid, S0, SIGMAS,
                                                 external_uniforms=u.to(dev), device=dev, **ekw)
    for s in range(3):
        for g in range(2):
            trades, reasons = _lifecycle_differ(got[2][s, g].cpu(), want[2][s, g])
            assert trades <= 2 + 4 and reasons <= 2 + 4, (s, g, trades, reasons)


@pytest.mark.cuda
def test_cuda_universe_rows_equal_single_kernels_at_each_symbol():
    """Philox: symbol s of each universe kernel equals the single kernel at
    its inputs and key (``symbol=s``), bit for bit, partial and per-path rows
    included; cell (s, g) of #11 equals #10 under row g; a one-symbol
    universe equals today's single run."""
    _need_cuda()
    dev = torch.device("cuda")
    lv, p = _levels(), _params()
    base = dict(num_bars=40, dt=DT, external_uniforms=None, device=dev)
    rows = cuda_mc.universe_rows(5, lv, p, S0, SIGMAS, paths_per_symbol=1 << 16, lanes=2048,
                                 **base)
    for s in range(3):
        one = cuda_mc.first_contact_rows(
            5, grid_row(lv, s), grid_row(p, s), num_paths=1 << 16, s0=float(S0[s]), mu=0.0,
            sigma=float(SIGMAS[s]), lanes=2048, noise=None, antithetic=False, symbol=s, **base)
        assert torch.equal(one[0], rows[0][s]) and torch.equal(one[1], rows[1][s]), s
    gate = GateConfig.default()
    got = cuda_gated.gated_universe_rows(5, lv, p, S0, SIGMAS, gate, paths_per_symbol=1 << 16,
                                         lanes=1024, noise=_noise(), per_path=True, **base)
    for s in range(3):
        one = cuda_gated.gated_rows(5, grid_row(lv, s), grid_row(p, s), gate,
                                    num_paths=1 << 16, s0=float(S0[s]), mu=0.0,
                                    sigma=float(SIGMAS[s]), lanes=1024,
                                    noise=grid_row(_noise(), s), antithetic=False,
                                    per_path=True, symbol=s, **base)
        assert all(torch.equal(a, b[s]) for a, b in zip(one, got)), s
    got = cuda_engine.engine_universe_rows(5, lv, p, S0, SIGMAS, paths_per_symbol=1 << 15,
                                           noise=_noise(), per_path=True, **base)
    for s in range(3):
        one = cuda_engine.engine_rows(5, grid_row(lv, s), grid_row(p, s), num_paths=1 << 15,
                                      s0=float(S0[s]), sigma=float(SIGMAS[s]),
                                      noise=grid_row(_noise(), s), per_path=True, symbol=s,
                                      **base)
        assert all(torch.equal(a, b[s]) for a, b in zip(one, got)), s
    stops = torch.tensor([[0.35, 0.25], [0.20, 0.30], [0.45, 0.35]])
    grid = EngineParams.default().replace(stop_padding=stops)
    sw = cuda_engine.engine_universe_sweep_rows(5, lv, grid, S0, SIGMAS,
                                                paths_per_symbol=1 << 15, per_path=True, **base)
    for g in range(2):
        uni = cuda_engine.engine_universe_rows(
            5, lv, EngineParams.default().replace(stop_padding=stops[:, g]), S0, SIGMAS,
            paths_per_symbol=1 << 15, per_path=True, **base)
        assert all(torch.equal(a, b[:, g]) for a, b in zip(uni, sw)), g
    one_sym = cuda_engine.mc_paths_engine_universe_fused(
        5, _levels(SYM_ROWS[:1]), EngineParams.default(), [100.0], [SIGMA],
        paths_per_symbol=1 << 15, num_bars=40, dt=DT, device=dev)
    today = cuda_engine.mc_paths_engine_fused(5, grid_row(_levels(SYM_ROWS[:1]), 0),
                                              EngineParams.default(), num_paths=1 << 15,
                                              sigma=SIGMA, dt=DT, device=dev)
    assert torch.equal(one_sym[1][0], today[1]) and torch.equal(one_sym[0].sum_r[0],
                                                                today[0].sum_r)
