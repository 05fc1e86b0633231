"""The port's gated lifecycle held against the JAX package on the same inputs:
compute_confidence and bar_hit_outcome exactly; gated_path_replay exactly per
path on the very bars the JAX kernel test builds from injected uniforms, and
against the scalar oracle; PathStats.from_lifecycle; the plain fused version
against the JAX Pallas kernel (interpret mode) within the flip budget, and
against the port's own replay exactly; the streamed mc_paths_gated
statistically."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
from qmmx_monolithic_monte_carlo_tpu.ops import confidence as jC
from qmmx_monolithic_monte_carlo_tpu.ops.pallas_mc import mc_paths_pallas_gated
from qmmx_monolithic_monte_carlo_tpu.ops.pathgen import PathBars as JPathBars
from qmmx_monolithic_monte_carlo_tpu.sim import gatedpath as jG
from qmmx_monolithic_monte_carlo_tpu.sim import hits as jH
from qmmx_monolithic_monte_carlo_tpu.sim import pathsim as jPS
from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise as JMcNoise
from qmmx_monolithic_monte_carlo_tpu.types import Levels as JLevels
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import confidence as C
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_gated
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import GatedLayout
from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import PathBars
from qmmx_monolithic_monte_carlo_tpu_torch.sim import gatedpath as G
from qmmx_monolithic_monte_carlo_tpu_torch.sim import hits as H
from qmmx_monolithic_monte_carlo_tpu_torch.sim import pathsim as PS
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

from .oracle import gated as O
from .test_pallas_gated import W, _bars_from_uniforms

torch.set_num_threads(2)

ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "orange", "type": "dashed", "index": 0, "price": 100.4}]
ORACLE_LEVELS = [(100.0, 1), (100.4, 0)]
STDS = dict(level_jitter_std=0.02, entry_slip_std=0.01, stop_slip_std=0.015,
            target_slip_std=0.015)
# the gate sets of tests/test_pallas_gated.py:92-96
GATES = {
    "multi": dict(touch_limit=100, touch_gap_bars=1, use_confidence=False),
    "defaults": dict(),
    "tight": dict(touch_limit=2, cooldown_bars=3),
}
SIGMA = 0.3
LANES = 1024
OUT_FIELDS = ("equity", "trades", "wins", "losses", "open_at_end", "max_dd")


def _gates(name):
    jgate = jG.GateConfig.default(**GATES[name])
    return jgate, G.GateConfig.from_numpy(
        {f.name: np.asarray(getattr(jgate, f.name))
         for f in dataclasses.fields(jgate)})


def _noises(noisy):
    return (JMcNoise.make(**STDS), McNoise.make(**STDS)) if noisy else (None, None)


def _uniforms(seed, noisy, nb=1):
    rng = np.random.default_rng(seed)
    rows = GatedLayout(W, noisy).u_rows
    return rng.uniform(1e-6, 1.0, (nb, rows, 8, LANES)).astype(np.float32)


def _assert_outcomes_equal(t, j):
    for f in OUT_FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)


# ---------------------------------------------------------------- ops/sim leaves

def test_confidence_matches_jax_exactly():
    rng = np.random.default_rng(0)
    n = 4096
    lvl = rng.choice([99.7, 100.0, 100.4], n).astype(np.float32)
    price = (lvl + rng.uniform(-0.08, 0.08, n)).astype(np.float32)
    price[:64] = lvl[:64]                                     # at the level
    price[64:128] = lvl[64:128] + np.float32(0.05)            # at the prox edge
    kind = rng.integers(0, 2, n).astype(np.int32)
    direction = rng.integers(-1, 2, n).astype(np.int32)       # up, down, unknown
    touch = rng.integers(0, 5, n).astype(np.int32)            # 0-4 touches
    for prox in (0.05, 0.0, 1e-5, 0.2):
        kw = dict(level_price=lvl, level_kind=kind, price=price,
                  direction=direction, touch_count=touch, contact_prox=prox)
        want = np.asarray(jC.compute_confidence(**kw))
        got = C.compute_confidence(**{k: torch.as_tensor(v) for k, v in kw.items()})
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 10


def test_bar_hit_outcome_matches_jax_exactly():
    rng = np.random.default_rng(1)
    n = 4096
    entry = rng.uniform(99.5, 100.5, n).astype(np.float32)
    is_long = rng.uniform(size=n) < 0.5
    stop = np.where(is_long, entry - 0.3, entry + 0.3).astype(np.float32)
    target = np.where(is_long, entry + 0.3, entry - 0.3).astype(np.float32)
    high = (entry + rng.uniform(0.0, 0.5, n)).astype(np.float32)
    low = (entry - rng.uniform(0.0, 0.5, n)).astype(np.float32)
    high[:256], low[:256] = entry[:256] + 0.4, entry[:256] - 0.4   # both, equidistant
    high[256:512], low[256:512] = target[256:512], stop[256:512]   # exactly on both
    kw = dict(is_open=rng.uniform(size=n) < 0.9, is_long=is_long, entry=entry,
              stop=stop, target=target, high=high, low=low,
              tie=rng.uniform(size=n).astype(np.float32))
    want = jH.bar_hit_outcome(**{k: jnp.asarray(v) for k, v in kw.items()})
    got = H.bar_hit_outcome(**{k: torch.as_tensor(v) for k, v in kw.items()})
    for f in H.BarHit._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    both = got.stop_hit & got.tgt_hit
    assert both.sum() > 300 and (both & got.target_first).any()
    assert (both & ~got.target_first).any() and (~torch.as_tensor(is_long) & both).any()


# ---------------------------------------------------------------- the replay

@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("gate_name", list(GATES))
def test_gated_path_replay_matches_jax_on_the_kernel_test_bars(gate_name, noisy):
    u = _uniforms(11 + len(gate_name) + noisy, noisy)[0]
    built = _bars_from_uniforms(u, noise=noisy)
    jbars, jtie = built[0], built[1]
    jnz = built[2] if noisy else None
    jgate, tgate = _gates(gate_name)
    jnoise, tnoise = _noises(noisy)
    jl = JLevels.from_rows(ROWS, max_levels=8)
    want = jG.gated_path_replay(jbars, jl, JParams.default(), jgate, jtie,
                                noise=jnoise, noise_normals=jnz)
    tbars = PathBars(*(torch.from_numpy(np.array(a)) for a in jbars))
    got = G.gated_path_replay(
        tbars, Levels.from_rows(ROWS, max_levels=8), EngineParams.default(),
        tgate, torch.from_numpy(np.array(jtie)), noise=tnoise,
        noise_normals=(tuple(torch.from_numpy(np.array(x)) for x in jnz)
                       if noisy else None))
    _assert_outcomes_equal(got, want)
    assert int(got.trades.sum()) > 1000
    if gate_name == "multi":
        assert int(got.trades.sum()) > int((got.trades > 0).sum())


def test_gated_path_replay_curve_matches_jax():
    u = _uniforms(5, False)[0]
    jbars, jtie = _bars_from_uniforms(u)
    jgate, tgate = _gates("multi")
    _, jcurve = jG.gated_path_replay(jbars, JLevels.from_rows(ROWS, max_levels=8),
                                     JParams.default(), jgate, jtie,
                                     return_curve=True)
    out, curve = G.gated_path_replay(
        PathBars(*(torch.from_numpy(np.array(a)) for a in jbars)),
        Levels.from_rows(ROWS, max_levels=8), EngineParams.default(), tgate,
        torch.from_numpy(np.array(jtie)), return_curve=True)
    np.testing.assert_array_equal(curve.numpy(), np.asarray(jcurve))
    assert torch.equal(curve[-1], out.equity)


def _random_bars(rng, p, w, s0=100.0, step=0.06):
    """Random-walk OHLC bars in exact f32 (tests/test_gatedpath.py's tape)."""
    moves = rng.normal(0.0, step, (p, w)).astype(np.float32)
    c = (s0 + np.cumsum(moves, axis=1)).astype(np.float32)
    o = np.concatenate([np.full((p, 1), s0, np.float32), c[:, :-1]], axis=1)
    h = (np.maximum(o, c) + np.abs(rng.normal(0.0, step / 2, (p, w)))).astype(np.float32)
    l = (np.minimum(o, c) - np.abs(rng.normal(0.0, step / 2, (p, w)))).astype(np.float32)
    return o, h, l, c


@pytest.mark.parametrize("gate_name", list(GATES))
def test_gated_path_replay_matches_scalar_oracle(gate_name):
    rng = np.random.default_rng(len(gate_name))
    p, w = 64, 32
    o, h, l, c = _random_bars(rng, p, w)
    tie = rng.uniform(0, 1, (p, w)).astype(np.float32)
    _, gate = _gates(gate_name)
    out = G.gated_path_replay(
        PathBars(*(torch.from_numpy(a) for a in (o, h, l, c, np.zeros_like(c)))),
        Levels.from_rows(ROWS, max_levels=8), EngineParams.default(), gate,
        torch.from_numpy(tie))
    for i in range(p):
        want = O.lifecycle_path(
            o[i], h[i], l[i], c[i], tie[i], ORACLE_LEVELS, contact_prox=0.05,
            stop_padding=0.35, tp_padding=0.25,
            touch_limit=int(gate.touch_limit), q_min_prob=float(gate.q_min_prob),
            cooldown_bars=int(gate.cooldown_bars),
            touch_gap_bars=int(gate.touch_gap_bars),
            use_confidence=bool(gate.use_confidence))
        assert int(out.trades[i]) == want["trades"], i
        assert int(out.wins[i]) == want["wins"], i
        assert int(out.losses[i]) == want["losses"], i
        assert bool(out.open_at_end[i]) == want["open_at_end"], i
        assert float(out.equity[i]) == pytest.approx(want["equity"], abs=1e-5)
        assert float(out.max_dd[i]) == pytest.approx(want["max_dd"], abs=1e-5)
    assert int(out.trades.sum()) > 0


def test_gated_path_replay_equidistant_levels_match_jax_and_oracle():
    """Closes on a 0.25 grid sit exactly halfway between the levels 99.75 and
    100.25: the nearest-level tie goes to the first slot on every side."""
    rng = np.random.default_rng(7)
    p, w = 256, 32
    c = (100.0 + 0.25 * np.cumsum(rng.integers(-1, 2, (p, w)), axis=1)).astype(np.float32)
    o = np.concatenate([np.full((p, 1), 100.0, np.float32), c[:, :-1]], axis=1)
    h = (np.maximum(o, c) + rng.choice([0.0, 0.3, 0.6], (p, w))).astype(np.float32)
    l = (np.minimum(o, c) - rng.choice([0.0, 0.3, 0.6], (p, w))).astype(np.float32)
    tie = rng.uniform(size=(p, w)).astype(np.float32)
    rows = [{"color": "blue", "type": "solid", "index": 0, "price": 99.75},
            {"color": "orange", "type": "dashed", "index": 0, "price": 100.25}]
    kw = dict(contact_prox=0.3, stop_padding=0.35, tp_padding=0.25)
    jgate, tgate = _gates("defaults")
    want = jG.gated_path_replay(
        JPathBars(*map(jnp.asarray, (o, h, l, c, np.zeros_like(c)))),
        JLevels.from_rows(rows, max_levels=4), JParams.default(**kw), jgate,
        jnp.asarray(tie))
    got = G.gated_path_replay(
        PathBars(*(torch.from_numpy(a) for a in (o, h, l, c, np.zeros_like(c)))),
        Levels.from_rows(rows, max_levels=4), EngineParams.default(**kw), tgate,
        torch.from_numpy(tie))
    _assert_outcomes_equal(got, want)
    assert int(got.trades.sum()) > 50
    for i in range(0, p, 8):
        ref = O.lifecycle_path(
            o[i], h[i], l[i], c[i], tie[i], [(99.75, 1), (100.25, 0)],
            touch_limit=4, q_min_prob=0.60, cooldown_bars=0, touch_gap_bars=3,
            **kw)
        assert int(got.trades[i]) == ref["trades"], i
        assert float(got.equity[i]) == pytest.approx(ref["equity"], abs=1e-5)


# ---------------------------------------------------------------- PathStats

FIELDS = ("n", "n_tp", "n_stop", "n_open", "n_entered", "sum_r", "sum_r2",
          "min_r", "max_r", "sum_trades", "sum_dd", "max_dd")


def _lifecycle_pair(seed, n=5000):
    rng = np.random.default_rng(seed)
    trades = rng.integers(0, 5, n).astype(np.int32)
    wins = np.minimum(rng.integers(0, 3, n), trades).astype(np.int32)
    losses = (trades - wins).astype(np.int32)
    equity = np.where(trades > 0, rng.normal(0, 2.5, n), 0.0).astype(np.float32)
    equity[:8] = [-9.0, 9.5, -6.0, 8.0, 7.999, -5.9, 0.0, 3.3]
    trades[:8] = 1
    opened = (rng.uniform(size=n) < 0.2) & (trades > 0)
    dd = np.where(trades > 0, np.abs(rng.normal(0, 1, n)), 0.0).astype(np.float32)
    kw = dict(equity=equity, trades=trades, wins=wins, losses=losses,
              open_at_end=opened, max_dd=dd)
    return (jPS.PathStats.from_lifecycle(**{k: jnp.asarray(v) for k, v in kw.items()}),
            PS.PathStats.from_lifecycle(**{k: torch.as_tensor(v) for k, v in kw.items()}))


def _assert_stats_close(t, j):
    for f in FIELDS:
        assert float(getattr(t, f)) == pytest.approx(float(getattr(j, f)),
                                                     rel=1e-6, abs=1e-6), f
    np.testing.assert_array_equal(t.hist.numpy(), np.asarray(j.hist))
    assert (t.hist_lo, t.hist_hi) == (j.hist_lo, j.hist_hi)
    for prop in ("mean_r", "std_r", "hit_rate", "mean_trades", "mean_dd"):
        assert float(getattr(t, prop)) == pytest.approx(
            float(getattr(j, prop)), rel=1e-6, abs=1e-6), prop
    for q in (0.05, 0.5):
        assert float(t.quantile(q)) == pytest.approx(float(j.quantile(q)),
                                                     rel=1e-6, abs=1e-6)
    assert float(t.cvar(0.05)) == pytest.approx(float(j.cvar(0.05)), rel=1e-6, abs=1e-6)


def test_pathstats_from_lifecycle_and_merge_match_jax():
    j1, t1 = _lifecycle_pair(0)
    j2, t2 = _lifecycle_pair(1)
    _assert_stats_close(t1, j1)
    _assert_stats_close(t1.merge(t2), j1.merge(j2))
    zero = PS.PathStats.zero(PS.LIFE_HIST_LO, PS.LIFE_HIST_HI)
    _assert_stats_close(zero.merge(t1), j1)
    with pytest.raises(ValueError):
        PS.PathStats.zero().merge(t1)


# ---------------------------------------------------------------- the plain fused version

CASES = [("multi", False, False), ("defaults", False, False),
         ("tight", False, False), ("defaults", True, False),
         ("defaults", False, True)]


def _case_id(case):
    gate_name, noisy, anti = case
    return gate_name + ("-noise" if noisy else "") + ("-antithetic" if anti else "")


def _flips(n_paths):
    return 2 + n_paths // 1024


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_fused_matches_jax_kernel_interpret(case):
    """tests/test_pallas_gated.py:97-130's setting: W = 16, one block of
    8 x 1024 paths.  The plain version's log/exp/sqrt/cos/sin are PyTorch's,
    the JAX kernel's XLA's: their ulps may flip O(1) threshold crossings per
    1024 paths, and a flip persists within its path."""
    gate_name, noisy, anti = case
    u = _uniforms(100 + len(CASES) * noisy + 2 * anti + len(gate_name), noisy)
    jgate, tgate = _gates(gate_name)
    jnoise, tnoise = _noises(noisy)
    n = 8 * LANES
    j = mc_paths_pallas_gated(
        0, JLevels.from_rows(ROWS, max_levels=8), JParams.default(), jgate,
        num_paths=n, num_bars=W, sigma=SIGMA, noise=jnoise, antithetic=anti,
        interpret=True, external_uniforms=u)
    counts, floats, rows = cuda_gated.gated_totals_reference(
        0, Levels.from_rows(ROWS, max_levels=8), EngineParams.default(), tgate,
        num_paths=n, num_bars=W, sigma=SIGMA, noise=tnoise, antithetic=anti,
        external_uniforms=torch.from_numpy(u), per_path=True)
    t = cuda_gated.stats_from_gated_totals(counts, floats)
    f = _flips(n)
    assert float(t.n) == float(j.n) == n
    assert abs(float(t.n_entered) - float(j.n_entered)) <= f
    for fld in ("n_tp", "n_stop", "n_open", "sum_trades"):
        assert abs(float(getattr(t, fld)) - float(getattr(j, fld))) <= 2 * f, fld
    assert float(np.abs(t.hist.numpy() - np.asarray(j.hist)).sum()) <= 2 * f
    max_eq = float(rows[:, 0].abs().max())
    assert abs(float(t.sum_r) - float(j.sum_r)) <= f * max_eq
    assert abs(float(t.sum_dd) - float(j.sum_dd)) <= f * max_eq
    assert float(t.hist.sum()) == float(t.n_entered)

    # per path, against the JAX replay of the JAX-built bars
    built = _bars_from_uniforms(u[0], noise=noisy)
    jbars, jtie = built[0], built[1]
    if anti:
        return          # the kernel test's bar builder has no antithetic pairs
    want = jG.gated_path_replay(jbars, JLevels.from_rows(ROWS, max_levels=8),
                                JParams.default(), jgate, jtie, noise=jnoise,
                                noise_normals=built[2] if noisy else None)
    wrows = np.stack([np.asarray(want.equity), np.asarray(want.trades),
                      np.asarray(want.wins), np.asarray(want.losses),
                      np.asarray(want.open_at_end), np.asarray(want.max_dd)], 1)
    # a path differs when its counts differ, or its equity or dd moved by
    # more than 1e-3 per trade: a log-price ulp (4.8e-7 near log 100) moves a
    # price by ~6 price ulps, and R = reward / risk (risk >= 0.3) carries it
    # on; a flipped decision may keep the counts and move a trade
    trows = rows.numpy()
    err = np.abs(trows[:, [0, 5]] - wrows[:, [0, 5]]).max(axis=1)
    differ = ((trows[:, 1:5] != wrows[:, 1:5]).any(axis=1)
              | (err > 1e-3 * np.maximum(wrows[:, 1], 1.0)))
    assert differ.sum() <= f


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_fused_equals_port_replay_on_its_own_bars(case):
    gate_name, noisy, anti = case
    u = torch.from_numpy(_uniforms(200 + len(gate_name), noisy, nb=2))
    _, gate = _gates(gate_name)
    _, noise = _noises(noisy)
    levels = Levels.from_rows(ROWS, max_levels=8)
    counts, floats, rows = cuda_gated.gated_totals_reference(
        0, levels, EngineParams.default(), gate, num_paths=2 * 8 * LANES,
        num_bars=W, sigma=SIGMA, noise=noise, antithetic=anti,
        external_uniforms=u, chunk_blocks=1, per_path=True)
    bars, tie, nz = cuda_gated.gated_bars_from_uniforms(
        u, GatedLayout(W, noisy), sigma=SIGMA, antithetic=anti)
    out = G.gated_path_replay(bars, levels, EngineParams.default(), gate, tie,
                              noise=noise, noise_normals=nz)
    want = torch.stack([out.equity, out.trades.float(), out.wins.float(),
                        out.losses.float(), out.open_at_end.float(), out.max_dd], 1)
    assert torch.equal(rows, want)
    assert int(counts[5]) == int(out.trades.sum()) > 0
    assert int(counts[1]) == int((out.trades > 0).sum())


# ---------------------------------------------------------------- the streamed pipeline

@pytest.mark.parametrize("noisy", [False, True])
def test_mc_paths_gated_agrees_with_jax_statistically(noisy):
    n = 1 << 16
    jnoise, tnoise = _noises(noisy)
    js = jG.mc_paths_gated(jax.random.key(0), JLevels.from_rows(ROWS, max_levels=8),
                           JParams.default(), num_paths=n, num_bars=40,
                           sigma=SIGMA, block_paths=1 << 14, noise=jnoise)
    ts = G.mc_paths_gated(0, Levels.from_rows(ROWS, max_levels=8),
                          EngineParams.default(), num_paths=n, num_bars=40,
                          sigma=SIGMA, block_paths=1 << 14, noise=tnoise,
                          device="cpu")
    assert float(ts.n) == n and (ts.hist_lo, ts.hist_hi) == (js.hist_lo, js.hist_hi)
    assert float(ts.hist.sum()) == float(ts.n_entered)
    ent = float(js.n_entered)
    assert abs(float(ts.n_entered) - ent) <= 4 * np.sqrt(n * 0.25) + 4
    # mean trades per entered path: trades per path are small integers, var <= 4
    se_trades = np.sqrt(2 * 4.0 / ent)
    assert abs(float(ts.mean_trades) - float(js.mean_trades)) <= 4 * se_trades
    se_mean = np.sqrt(2.0 / ent) * float(js.std_r)
    assert abs(float(ts.mean_r) - float(js.mean_r)) <= 4 * se_mean
    assert float(ts.mean_trades) > 1.0 and float(ts.max_dd) > 0.0


def test_noise_normals_per_bar_shape():
    per_bar = PS.noise_normals(3, 1, 4096, num_bars=6)
    assert len(per_bar) == 4 and all(x.shape == (4096, 6) for x in per_bar)
    for a, b in zip(per_bar, PS.noise_normals(3, 1, 4096, num_bars=6)):
        assert torch.equal(a, b)                      # a pure function of the seed
    assert not torch.equal(per_bar[0], per_bar[1])    # one stream per consumer
    assert not torch.equal(per_bar[0], PS.noise_normals(3, 2, 4096, num_bars=6)[0])
    x = torch.cat([n.reshape(-1) for n in per_bar])
    assert abs(float(x.mean())) < 0.02 and abs(float(x.std()) - 1.0) < 0.02
