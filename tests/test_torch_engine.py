"""The port's full-engine lifecycle held against the JAX package: the port's
``engine_path_replay`` equals JAX's path by path on the bars the JAX kernel
test builds from injected uniforms (seven configurations); the plain version of
the engine kernel against JAX's replay of those bars within the flip budget;
the replay against the wicked-bar scalar oracle; the streamed
``mc_paths_engine``; the state envelope; and (slow) the JAX Pallas kernel in
interpret mode against the plain version on the same uniforms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
from qmmx_monolithic_monte_carlo_tpu.engine.state import MlModel as JMl
from qmmx_monolithic_monte_carlo_tpu.models import online_policy as jOP
from qmmx_monolithic_monte_carlo_tpu.ops import guard as jG
from qmmx_monolithic_monte_carlo_tpu.ops import touch as jT
from qmmx_monolithic_monte_carlo_tpu.sim import enginepath as jEP
from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise as JMcNoise
from qmmx_monolithic_monte_carlo_tpu.types import Levels as JLevels
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.engine.state import MlModel
from qmmx_monolithic_monte_carlo_tpu_torch.models.online_policy import PolicyParams
from qmmx_monolithic_monte_carlo_tpu_torch.ops import cuda_engine as CE
from qmmx_monolithic_monte_carlo_tpu_torch.ops import guard as G
from qmmx_monolithic_monte_carlo_tpu_torch.ops import pathgen as PG
from qmmx_monolithic_monte_carlo_tpu_torch.ops import regular as R
from qmmx_monolithic_monte_carlo_tpu_torch.ops import touch as T
from qmmx_monolithic_monte_carlo_tpu_torch.ops.draws import EngineLayout
from qmmx_monolithic_monte_carlo_tpu_torch.sim import enginepath as EP
from qmmx_monolithic_monte_carlo_tpu_torch.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

from .oracle import enginebar as OB
from .test_pallas_engine import LANES, LEVELS as JLEVELS, _bars_from_uniforms

torch.set_num_threads(2)

ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "orange", "type": "dashed", "index": 0, "price": 100.4},
        {"color": "teal", "type": "solid", "index": 0, "price": 99.6}]
STDS = dict(level_jitter_std=0.02, entry_slip_std=0.01, stop_slip_std=0.015,
            target_slip_std=0.015)
OUT = ("equity", "trades", "wins", "losses", "open_at_end", "max_dd", "escalations")


def _levels():
    return Levels.from_numpy({k: np.asarray(v) for k, v in vars(JLEVELS).items()})


def _numpy(jobj):
    return {k: np.asarray(v) for k, v in vars(jobj).items()}


def _armed():
    """The ML model and policy of tests/test_pallas_engine.py:225-242, both sides."""
    rng = np.random.default_rng(7)
    w_entry = rng.normal(0, 0.8, (3, 7)).astype(np.float32)
    w_entry[0, 0] += 0.8
    w_entry[1, 0] += 0.8
    w_entry[2, 0] -= 0.5
    jpol = jOP.PolicyParams.init().replace(w_entry=jnp.asarray(w_entry))
    jml = JMl.from_weights(np.array([0.4, -0.8, -0.3, 0.2], np.float32), 0.55)
    return (dict(policy=jpol, ml_model=jml),
            dict(policy=PolicyParams.from_numpy(_numpy(jpol)),
                 ml_model=MlModel.from_numpy(_numpy(jml))))


def _passing():
    """The armed ML model with a policy that passes from bar ~12 (shorts) and
    ~20 (longs) on: both gates let some entries through."""
    w_entry = np.zeros((3, 7), np.float32)
    w_entry[0, 0], w_entry[0, 6] = -0.6, 20.0
    w_entry[1, 0], w_entry[1, 6] = -0.2, 20.0
    w_entry[2, 0] = -1.0
    jpol = jOP.PolicyParams.init().replace(w_entry=jnp.asarray(w_entry))
    jml = JMl.from_weights(np.array([0.4, -0.8, -0.3, 0.2], np.float32), 0.55)
    return (dict(policy=jpol, ml_model=jml),
            dict(policy=PolicyParams.from_numpy(_numpy(jpol)),
                 ml_model=MlModel.from_numpy(_numpy(jml))))


def _accumulating():
    """The guard and touch params of tests/test_pallas_engine.py:210-216."""
    jg = jG.GuardParams.default().replace(min_bars=jnp.int32(6),
                                          compression_bp=jnp.float32(300.0))
    jt = jT.TouchMemoryParams.default().replace(
        max_bounces=jnp.int32(1), min_time_gap_ms=jnp.int32(120_000),
        fatigue_vol_k=jnp.float32(0.0))
    return (dict(guard_params=jg, touch_params=jt),
            dict(guard_params=G.GuardParams.from_numpy(_numpy(jg)),
                 touch_params=T.TouchMemoryParams.from_numpy(_numpy(jt))))


# name -> (sigma, W, noise, escalation, (jax kw, port kw) maker)
CONFIGS = {
    "defaults": (0.3, 40, False, True, None),
    "accumulation": (0.05, 40, False, True, _accumulating),
    "ml+policy": (0.3, 40, False, True, _armed),
    "ml+policy-passing": (0.3, 40, False, True, _passing),
    "noise": (0.3, 40, True, True, None),
    "no-escalation": (0.3, 40, False, False, None),
    "windowed-W70": (0.1, 70, False, True, _accumulating),
}


def _both_replays(name, seed, **params_kw):
    sigma, w, noisy, esc, maker = CONFIGS[name]
    jkw, tkw = maker() if maker else ({}, {})
    rng = np.random.default_rng(seed)
    stride = 18 if noisy else 10
    u = rng.uniform(1e-6, 1.0, (stride * ((w + 1) // 2), 8, LANES)).astype(np.float32)
    built = _bars_from_uniforms(u, sigma, with_noise=noisy, w=w)
    bars, tie = built[0], built[1]
    if noisy:
        jkw = dict(jkw, noise=JMcNoise.make(**STDS), noise_normals=built[2])
        tkw = dict(tkw, noise=McNoise.make(**STDS),
                   noise_normals=tuple(torch.from_numpy(np.array(x)) for x in built[2]))
    want = jEP.engine_path_replay(bars, JLEVELS, JParams.default(**params_kw), tie,
                                  escalation=esc, **jkw)
    got = EP.engine_path_replay(
        PG.PathBars(*(torch.from_numpy(np.array(a)) for a in bars)), _levels(),
        EngineParams.default(**params_kw), torch.from_numpy(np.array(tie)),
        escalation=esc, **tkw)
    return got, want


def _assert_same(got, want):
    for f in OUT:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_array_equal(got.skip_counts.numpy(),
                                  np.asarray(want.skip_counts).astype(np.int64))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_replay_matches_jax_path_by_path(name):
    """P = 2048 paths on the JAX kernel test's own bars: per path counts,
    escalations, equity and drawdown, and the 16-reason skip table, exactly."""
    got, want = _both_replays(name, 11 + len(name))
    _assert_same(got, want)
    skips = dict(zip((r.name for r in EP.SKIP_REASONS), got.skip_counts.tolist()))
    if name == "accumulation":
        assert skips["EDGE_FATIGUE"] + skips["TOUCH_BUDGET"] + skips["TOUCH_COOLDOWN"] > 0
    elif name.startswith("ml+policy"):
        assert skips["ML_CONF_LOW"] > 0 and skips["ONLINE_POLICY"] > 0
        assert (int(got.trades.sum()) > 0) == (name == "ml+policy-passing")
    elif name == "no-escalation":
        assert int(got.escalations.sum()) == 0 and int(got.trades.sum()) > 0
    elif name != "windowed-W70":
        assert int(got.escalations.sum()) > 0 and int(got.trades.sum()) > 2048
    else:
        assert int(got.trades.sum()) > 0


def test_engine_replay_blend_gate_matches_jax():
    """USE_BLEND with the armed ML model: the blended score w_rules * conf +
    w_ml * proba (a fused multiply-add under XLA) gates COMBINED_LOW."""
    got, want = _both_replays("ml+policy-passing", 5, use_blend=True, w_rules=0.5,
                              w_ml=0.7, q_min_prob=0.62)
    _assert_same(got, want)
    skips = dict(zip((r.name for r in EP.SKIP_REASONS), got.skip_counts.tolist()))
    assert skips["COMBINED_LOW"] > 0 and skips["ML_CONF_LOW"] == 0
    assert int(got.trades.sum()) > 0


def test_engine_replay_curve_and_unported_harvest():
    sigma, w = 0.3, 16
    u = np.random.default_rng(3).uniform(1e-6, 1.0, (80, 8, LANES)).astype(np.float32)
    bars, tie = _bars_from_uniforms(u, sigma, w=w)
    tbars = PG.PathBars(*(torch.from_numpy(np.array(a)) for a in bars))
    out, curve = EP.engine_path_replay(tbars, _levels(), EngineParams.default(),
                                       torch.from_numpy(np.array(tie)), return_curve=True)
    _, jcurve = jEP.engine_path_replay(bars, JLEVELS, JParams.default(), tie,
                                       return_curve=True)
    np.testing.assert_array_equal(curve.numpy(), np.asarray(jcurve))
    assert torch.equal(curve[-1], out.equity)
    # the harvest is ported (tests/test_torch_engine_harvest.py holds it
    # against JAX): it labels every close and changes no trade
    hv_out = EP.engine_path_replay(tbars, _levels(), EngineParams.default(),
                                   torch.from_numpy(np.array(tie)), harvest=True)
    assert int(hv_out.harvest.n_labeled) == int(out.wins.sum() + out.losses.sum())
    assert torch.equal(hv_out.equity, out.equity) and torch.equal(hv_out.trades, out.trades)


def _path_rows(out):
    return np.stack([np.asarray(out.equity), np.asarray(out.trades),
                     np.asarray(out.wins), np.asarray(out.losses),
                     np.asarray(out.open_at_end), np.asarray(out.max_dd),
                     np.asarray(out.escalations)], 1).astype(np.float32)


def _differ(got, want):
    """Paths that differ: in their counts, or in equity or dd by more than
    1e-3 per trade (a flipped decision may keep the counts and move a trade)."""
    err = np.abs(got[:, [0, 5]] - want[:, [0, 5]]).max(axis=1)
    return ((got[:, [1, 2, 3, 4, 6]] != want[:, [1, 2, 3, 4, 6]]).any(axis=1)
            | (err > 1e-3 * np.maximum(want[:, 1], 1.0)))


@pytest.mark.parametrize("noisy,anti", [(False, False), (True, False), (False, True)])
def test_plain_version_matches_jax_replay_on_the_kernel_test_bars(noisy, anti):
    """tests/test_pallas_engine.py:_bars_from_uniforms is the JAX kernel
    test's own reference.  The plain version makes its bars from the same
    uniforms with PyTorch's log/exp/sqrt/cos/sin, which differ from XLA's by
    ulps; a close on a threshold then flips, and the flip persists within its
    path.  So at most F = 2 + P/1024 paths differ, the skip counters by at
    most W * F, the escalations by at most F."""
    w, sigma = 40, 0.3
    stride = 18 if noisy else 10
    u = np.random.default_rng(40 + noisy + 2 * anti).uniform(
        1e-6, 1.0, (1, stride * (w // 2), 8, LANES)).astype(np.float32)
    built = _bars_from_uniforms(u[0], sigma, with_noise=noisy, antithetic=anti)
    jkw = dict(noise=JMcNoise.make(**STDS), noise_normals=built[2]) if noisy else {}
    want = jEP.engine_path_replay(built[0], JLEVELS, JParams.default(), built[1], **jkw)
    counts, _, rows = CE.engine_totals_reference(
        0, _levels(), EngineParams.default(), num_paths=8 * LANES, num_bars=w,
        sigma=sigma, noise=McNoise.make(**STDS) if noisy else None, antithetic=anti,
        external_uniforms=torch.from_numpy(u), per_path=True)
    f = 2 + 8 * LANES // 1024
    assert int(_differ(rows.numpy(), _path_rows(want)).sum()) <= f
    skips = counts[CE.N_COUNTS:CE.N_COUNTS + CE.N_SKIPS].numpy()
    assert int(np.abs(skips - np.asarray(want.skip_counts)).max()) <= w * f
    assert abs(int(counts[6]) - int(np.asarray(want.escalations).sum())) <= f
    assert int(counts[5]) == int(rows[:, 1].sum()) > int(counts[1]) > 0


def test_engine_replay_matches_the_wicked_bar_oracle():
    """Wicked GBM bars (port Philox draws, windowed guard at W = 120)
    through the scalar oracle tests/oracle/enginebar.py: trades, wins,
    losses, escalations and open positions exactly, equity and drawdown to
    float32 tolerance, the skip table exactly."""
    levels_rows = ROWS + [{"color": "black", "type": "dashed", "index": 0, "price": 100.6}]
    oracle_levels = [(100.0, 1), (100.4, 0), (99.6, 1), (100.6, 0)]
    p, w = 8, 120
    bars = PG.gbm_paths(3, 0, num_paths=p, num_bars=w, s0=100.0, sigma=1.2,
                        volume_model=PG.VolumeModel(ret_coupling=0.8))
    tie = torch.from_numpy(np.random.default_rng(4).uniform(size=(p, w)).astype(np.float32))
    kw = dict(stop_padding=0.12, tp_padding=0.08, cooldown_s=120.0)
    out = EP.engine_path_replay(bars, Levels.from_rows(levels_rows, max_levels=8),
                                EngineParams.default(**kw), tie)
    agg, ties = {}, 0
    for i in range(p):
        res = OB.engine_bar_path(*(x[i].numpy() for x in (bars.open, bars.high, bars.low,
                                                          bars.close, bars.volume, tie)),
                                 oracle_levels, escalation=True, **kw)
        ties += res["ties_seen"]
        assert res["trades"] == int(out.trades[i]), i
        assert res["wins"] == int(out.wins[i]), i
        assert res["losses"] == int(out.losses[i]), i
        assert res["escalations"] == int(out.escalations[i]), i
        assert res["open_at_end"] == bool(out.open_at_end[i]), i
        assert res["equity"] == pytest.approx(float(out.equity[i]), abs=2e-4)
        assert res["max_dd"] == pytest.approx(float(out.max_dd[i]), abs=2e-4)
        for k, n in res["skips"].items():
            agg[k] = agg.get(k, 0) + n
    skips = dict(zip((r.name for r in EP.SKIP_REASONS), out.skip_counts.tolist()))
    assert {k: n for k, n in skips.items() if n} == agg
    assert ties > 0 and int(out.trades.sum()) > 0


def test_mc_paths_engine_streams_blocks():
    params = EngineParams.default()
    kw = dict(num_paths=1 << 12, num_bars=32, sigma=0.3, block_paths=1 << 11,
              device="cpu")
    stats, skips, escal = EP.mc_paths_engine(0, _levels(), params, **kw)
    again, skips1, escal1 = EP.mc_paths_engine(0, _levels(), params, **kw)
    assert float(stats.n) == 1 << 12 and float(stats.n_entered) > 0
    assert float(stats.sum_trades) >= float(stats.n_entered)
    for f in ("n", "n_entered", "n_tp", "n_stop", "sum_trades", "sum_r"):
        assert float(getattr(stats, f)) == float(getattr(again, f)), f
    assert torch.equal(skips, skips1) and int(escal) == int(escal1)
    assert skips.dtype == torch.int64 and skips.shape == (16,)
    # one block of each: the block sum is the total
    one = [EP.mc_paths_engine(0, _levels(), params, **dict(kw, num_paths=1 << 11))]
    assert int(one[0][1].sum()) < int(skips.sum())
    # the same model as the JAX pipeline, other random streams
    js, jskips, _ = jEP.mc_paths_engine(jax.random.key(0), JLEVELS, JParams.default(),
                                        num_paths=1 << 12, num_bars=32, sigma=0.3,
                                        block_paths=1 << 11)
    assert abs(float(stats.mean_trades) - float(js.mean_trades)) < 0.15
    evals = (1 << 12) * 32
    assert abs(int(skips[4]) - float(jskips[4])) < 0.05 * evals     # TOO_FAR


def test_state_envelope_rejects_unrepresentable_params():
    params = EngineParams.default()
    kw = dict(num_paths=1 << 8, num_bars=8, sigma=0.3, block_paths=1 << 8, device="cpu")
    bad_touch = T.TouchMemoryParams.default().replace(fatigue_hits=R.TAP_STACK + 1)
    with pytest.raises(ValueError, match="fatigue_hits"):
        EP.mc_paths_engine(0, _levels(), params, touch_params=bad_touch, **kw)
    bad_guard = G.GuardParams.default().replace(vol_long=EP.BARS_RING + 1)
    with pytest.raises(ValueError, match="vol windows"):
        EP.mc_paths_engine(0, _levels(), params, guard_params=bad_guard, **kw)
    with pytest.raises(ValueError, match="fatigue_hits"):
        EP.engine_path_replay(
            PG.gbm_paths(0, 0, num_paths=4, num_bars=4, s0=100.0), _levels(), params,
            torch.rand(4, 4), touch_params=bad_touch)
    ok_touch = T.TouchMemoryParams.default().replace(fatigue_hits=R.TAP_STACK)
    stats, _, _ = EP.mc_paths_engine(0, _levels(), params, touch_params=ok_touch, **kw)
    assert float(stats.n) == 1 << 8
    # harvest=True is ported: a 4-tuple, one label a closed trade
    stats_h, _, _, hv = EP.mc_paths_engine(0, _levels(), params, touch_params=ok_touch,
                                           harvest=True, **kw)
    assert torch.equal(stats_h.hist, stats.hist)
    assert int(hv.n_labeled) == int(stats.n_tp + stats.n_stop)


@pytest.mark.slow
@pytest.mark.parametrize("noisy", [False, True])
def test_plain_version_matches_the_jax_kernel_interpret(noisy):
    """The JAX Pallas kernel in interpret mode and the plain version on the
    same injected uniforms: totals within the flip budget."""
    from qmmx_monolithic_monte_carlo_tpu.ops.pallas_engine import mc_paths_pallas_engine

    w, sigma = 40, 0.3
    lay = EngineLayout(w, noisy)
    u = np.random.default_rng(60 + noisy).uniform(
        1e-6, 1.0, (1, lay.u_rows, 8, LANES)).astype(np.float32)
    jstats, jskips, jescal = mc_paths_pallas_engine(
        0, JLEVELS, JParams.default(), num_paths=8 * LANES, num_bars=w, sigma=sigma,
        lanes=LANES, noise=JMcNoise.make(**STDS) if noisy else None,
        interpret=True, external_uniforms=u)
    stats, skips, escal = CE.stats_from_engine_totals(*CE.engine_totals_reference(
        0, _levels(), EngineParams.default(), num_paths=8 * LANES, num_bars=w,
        sigma=sigma, noise=McNoise.make(**STDS) if noisy else None,
        external_uniforms=torch.from_numpy(u)))
    f = 2 + 8 * LANES // 1024
    assert float(stats.n) == float(jstats.n)
    assert abs(float(stats.n_entered) - float(jstats.n_entered)) <= f
    assert abs(float(stats.sum_trades) - float(jstats.sum_trades)) <= 2 * f
    assert float(np.abs(np.asarray(skips) - np.asarray(jskips)).max()) <= w * f
    assert abs(int(escal) - float(jescal)) <= f
