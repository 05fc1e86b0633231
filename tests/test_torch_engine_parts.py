"""The engine slice's building blocks held against the JAX package on the
same numpy inputs: reason codes, the guard / touch-memory parameters, the
confluence / policy / volume features, the soft veto, the bar-synchronous
guard and touch state stepped over random bar tapes (running and windowed
guard box), target escalation, the ML gate, the OnlinePolicy gate and the
``from_numpy`` round trips.  Exact, but for the sigmoid: XLA's
``1 / (1 + exp(-z))`` and ``torch.sigmoid`` can differ in the last place,
so probabilities agree to 2 ulps and the gates' decisions exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu import reasons as jreasons
from qmmx_monolithic_monte_carlo_tpu.config import EngineParams as JParams
from qmmx_monolithic_monte_carlo_tpu.engine import exits as jexits
from qmmx_monolithic_monte_carlo_tpu.engine.gates import _ml_allowed as j_ml_allowed
from qmmx_monolithic_monte_carlo_tpu.engine.state import MlModel as JMl
from qmmx_monolithic_monte_carlo_tpu.models import online_policy as jOP
from qmmx_monolithic_monte_carlo_tpu.ops import confidence as jC
from qmmx_monolithic_monte_carlo_tpu.ops import features as jF
from qmmx_monolithic_monte_carlo_tpu.ops import guard as jG
from qmmx_monolithic_monte_carlo_tpu.ops import regular as jR
from qmmx_monolithic_monte_carlo_tpu.ops import touch as jT
from qmmx_monolithic_monte_carlo_tpu.types import Levels as JLevels
from qmmx_monolithic_monte_carlo_tpu_torch import reasons
from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu_torch.engine import exits
from qmmx_monolithic_monte_carlo_tpu_torch.engine.gates import _ml_allowed
from qmmx_monolithic_monte_carlo_tpu_torch.engine.state import MlModel
from qmmx_monolithic_monte_carlo_tpu_torch.models import online_policy as OP
from qmmx_monolithic_monte_carlo_tpu_torch.ops import confidence as C
from qmmx_monolithic_monte_carlo_tpu_torch.ops import features as F
from qmmx_monolithic_monte_carlo_tpu_torch.ops import guard as G
from qmmx_monolithic_monte_carlo_tpu_torch.ops import regular as R
from qmmx_monolithic_monte_carlo_tpu_torch.ops import touch as T
from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

torch.set_num_threads(2)

ROWS = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "orange", "type": "dashed", "index": 0, "price": 100.4},
        {"color": "teal", "type": "solid", "index": 0, "price": 99.6},
        {"color": "black", "type": "dashed", "index": 0, "price": 100.1}]


def _levels():
    return JLevels.from_rows(ROWS, max_levels=8), Levels.from_rows(ROWS, max_levels=8)


def _np(x):
    return np.asarray(x)


def _to_torch(jobj, cls):
    """A JAX pytree's leaves as numpy -> the port's ``from_numpy``."""
    return cls.from_numpy({k: np.asarray(v) for k, v in vars(jobj).items()})


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy() if torch.is_tensor(got) else got,
                                  _np(want), err_msg=msg)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# ---------------------------------------------------------------- 1-3 codes, params

def test_reason_codes_and_returned_codes_match():
    assert {r.name: int(r) for r in reasons.Reason} == \
        {r.name: int(r) for r in jreasons.Reason}
    assert reasons.REASON_NAMES == jreasons.REASON_NAMES
    assert reasons.ACC_BREAKOUT_RETURN_CODE == jreasons.ACC_BREAKOUT_RETURN_CODE == 904
    for r in reasons.Reason:
        for strict in (False, True):
            assert reasons.returned_code(r, strict_reference_quirks=strict) == \
                jreasons.returned_code(jreasons.Reason(int(r)),
                                       strict_reference_quirks=strict), (r, strict)


def test_guard_and_touch_constants_match():
    for name in ("REGIME_UNKNOWN", "REGIME_ACCUMULATION", "REGIME_BREAKOUT_UP",
                 "REGIME_BREAKOUT_DOWN"):
        assert getattr(G, name) == getattr(jG, name), name
    for name in ("TM_LONG", "TM_SHORT", "EDGE_NONE", "EDGE_TOP", "EDGE_BOT"):
        assert getattr(T, name) == getattr(jT, name), name
    for name in ("GUARD_WINDOW_BARS", "TAP_STACK", "TAP_NEVER", "GUARD_RING"):
        assert getattr(R, name) == getattr(jR, name), name
    assert F.POLICY_FEATURE_DIM == jF.POLICY_FEATURE_DIM
    for name in ("PROXIMITY_WINDOW", "CONFLUENCE_WINDOW", "VOL_LOOKBACK",
                 "MIN_BARS_FOR_TREND", "BASIS_NONE", "BASIS_REVERSAL",
                 "BASIS_CONTINUATION"):
        assert getattr(exits, name) == getattr(jexits, name), name


@pytest.mark.parametrize("which", ["guard", "touch", "ml_absent", "ml_weights",
                                   "ml_skewed", "policy"])
def test_from_numpy_round_trips(which):
    jobj, tcls, tdefault = {
        "guard": (jG.GuardParams.default(), G.GuardParams, G.GuardParams.default()),
        "touch": (jT.TouchMemoryParams.default(), T.TouchMemoryParams,
                  T.TouchMemoryParams.default()),
        "ml_absent": (JMl.absent(), MlModel, MlModel.absent()),
        "ml_weights": (JMl.from_weights(np.array([0.4, -0.8, -0.3, 0.2]), 0.55),
                       MlModel, MlModel.from_weights([0.4, -0.8, -0.3, 0.2], 0.55)),
        "ml_skewed": (JMl.from_weights(np.array([0.4, -0.8, -0.3]), 0.1, 3),
                      MlModel, MlModel.from_weights([0.4, -0.8, -0.3], 0.1, 3)),
        "policy": (jOP.PolicyParams.init(), OP.PolicyParams, OP.PolicyParams.init()),
    }[which]
    got = _to_torch(jobj, tcls)
    for f in dataclasses.fields(got):
        a, b, d = getattr(got, f.name), np.asarray(getattr(jobj, f.name)), getattr(tdefault, f.name)
        assert a.dtype == tcls._DTYPES[f.name] == d.dtype, f.name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f.name)
        np.testing.assert_array_equal(d.numpy(), b, err_msg=f.name)
    changed = got.replace(**{f.name: getattr(got, f.name) for f in dataclasses.fields(got)})
    assert all(torch.equal(getattr(changed, f.name), getattr(got, f.name))
               for f in dataclasses.fields(got))


# ---------------------------------------------------------------- 4-5 features, veto

def test_confluence_and_policy_features_match():
    jl, tl = _levels()
    rng = np.random.default_rng(0)
    anchor = rng.choice([100.0, 100.1, 100.4, 99.6, 99.9], 4096).astype(np.float32)
    anchor += rng.uniform(-0.3, 0.3, 4096).astype(np.float32)
    for within in (0.15, 0.6, 0.0):
        _eq(F.confluence_count(tl, torch.from_numpy(anchor), within),
            jF.confluence_count(jl, jnp.asarray(anchor), within), str(within))
        _eq(F.has_confluence_near(tl, torch.from_numpy(anchor), within),
            jF.has_confluence_near(jl, jnp.asarray(anchor), within), str(within))
    kw = dict(proximity_abs=rng.uniform(0, 2, 4096).astype(np.float32),
              volume_trend=rng.normal(0, 2e6, 4096).astype(np.float32),
              approach=rng.integers(0, 2, 4096).astype(np.int32),
              confluence=rng.uniform(size=4096) < 0.5,
              minutes_since_open=rng.integers(0, 500, 4096).astype(np.int32))
    _eq(F.policy_features(**{k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()}),
        jF.policy_features(**{k: jnp.asarray(v) for k, v in kw.items()}))


@pytest.mark.parametrize("window", [6, 4])
def test_volume_slope_matches(window):
    rng = np.random.default_rng(window)
    p, n = 4096, 32
    vol = rng.lognormal(13.0, 0.6, (p, n)).astype(np.float32)
    vol[:64] = 0.0                                         # both halves zero
    n_valid = rng.integers(0, n + 1, p)
    valid = np.arange(n)[None, :] >= (n - n_valid)[:, None]   # newest-last tail
    want = jF.volume_slope(jnp.asarray(vol), jnp.asarray(valid), window=window)
    got = F.volume_slope(torch.from_numpy(vol), torch.from_numpy(valid), window=window)
    _eq(got, want)
    assert (np.asarray(want) != 0).mean() > 0.8


def test_volume_trend_and_approach_full_window_match():
    rng = np.random.default_rng(3)
    p = 8192
    level = rng.choice([99.6, 100.0, 100.4], p).astype(np.float32)
    prices = (level[:, None] + rng.normal(0, 0.2, (p, 5))).astype(np.float32)
    prices[:256, 3] = prices[:256, 4]                      # equal distances
    vols = rng.lognormal(13.0, 0.5, (p, 5)).astype(np.float32)
    want = jF.volume_trend_full_window(jnp.asarray(prices), jnp.asarray(vols),
                                       jnp.asarray(level))
    got = F.volume_trend_full_window(torch.from_numpy(prices), torch.from_numpy(vols),
                                     torch.from_numpy(level))
    _eq(got, want)
    _eq(F.infer_approach_full_window(torch.from_numpy(prices), torch.from_numpy(level)),
        jF.infer_approach_full_window(jnp.asarray(prices), jnp.asarray(level)))


def test_soft_veto_matches():
    rng = np.random.default_rng(4)
    n = 8192
    kw = dict(side=rng.choice([1, -1], n).astype(np.int32),
              volume_slope=rng.normal(0, 0.4, n).astype(np.float32),
              approach_from_below=rng.uniform(size=n) < 0.5,
              confluence=rng.uniform(size=n) < 0.3,
              proximity_abs=rng.uniform(0, 0.1, n).astype(np.float32))
    kw["volume_slope"][:128] = np.float32(0.25)            # on the strong threshold
    for prox, strong, vprox in ((0.05, 0.25, 0.06), (0.6, 0.1, 0.01)):
        ja, jr = jC.soft_veto(**{k: jnp.asarray(v) for k, v in kw.items()},
                              contact_prox=prox, veto_vol_strong=strong, veto_prox=vprox)
        ta, tr = C.soft_veto(**{k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()},
                             contact_prox=torch.tensor(prox), veto_vol_strong=torch.tensor(strong),
                             veto_prox=torch.tensor(vprox))
        _eq(ta, ja)
        _eq(tr, jr)
    assert (~ta).sum() > 100


# ---------------------------------------------------------------- 6 regular.py

def _tape(seed, p, w):
    """A calm random walk (so the guard compresses) with volume spikes (so
    breakouts confirm), closes near the levels (so touches register)."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(0, 0.03, (p, w))
    # one 5-bar burst per path: a run out of the box on 4x volume
    t0 = rng.integers(22, w - 5, p)
    burst = (np.arange(w)[None, :] >= t0[:, None]) & (np.arange(w)[None, :] < t0[:, None] + 5)
    steps += burst * rng.choice([-0.12, 0.12], (p, 1))
    c = (100.0 + np.cumsum(steps, axis=1)).astype(np.float32)
    h = (c + np.abs(rng.normal(0, 0.02, (p, w)))).astype(np.float32)
    l = (c - np.abs(rng.normal(0, 0.02, (p, w)))).astype(np.float32)
    v = (rng.lognormal(13.0, 0.3, (p, w)) * np.where(burst, 4.0, 1.0)).astype(np.float32)
    return h, l, c, v


@pytest.mark.parametrize("windowed", [False, True])
def test_guard_and_touch_state_stepped_over_a_tape_match(windowed):
    p, w = 512, 70 if windowed else 40
    h, l, c, v = _tape(5 + windowed, p, w)
    jl, tl = _levels()
    jg = jG.GuardParams.default().replace(min_bars=jnp.int32(6),
                                          compression_bp=jnp.float32(60.0))
    jt = jT.TouchMemoryParams.default().replace(fatigue_vol_k=jnp.float32(0.9),
                                                min_time_gap_ms=jnp.int32(120_000))
    tg, tt = _to_torch(jg, G.GuardParams), _to_torch(jt, T.TouchMemoryParams)
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 4, (w, p)).astype(np.int32)
    side = rng.integers(0, 2, (w, p)).astype(np.int32)

    @jax.jit
    def jstep(carry, t, hb, lb, cb, vb, ib, sb):
        guard, touch, ring = carry
        now = t * 60_000
        fat = jR.edge_fatigued(touch, jt, now)
        allow = jR.touch_allow(touch, jt, ib, sb, now)
        ring = jR.ring_push(ring, vb)
        ma_s = jR.tail_mean_minclose(ring, t + 1, 5)
        ma_l = jR.tail_mean_minclose(ring, t + 1, 20)
        guard = jR.lean_guard_push(guard, jg, bar_index=t, high=hb, low=lb,
                                   close=cb, vol_ring=ring)
        touch = jR.touch_register(
            touch, jt, jl, ts_ms=now, high=hb, low=lb, close=cb,
            box_low=guard.box_low, box_high=guard.box_high, box_valid=guard.box_valid,
            vol_ma_s=ma_s, vol_ma_l=ma_l, enabled=guard.regime == jG.REGIME_ACCUMULATION)
        bo = jnp.logical_or(guard.regime == jG.REGIME_BREAKOUT_UP,
                            guard.regime == jG.REGIME_BREAKOUT_DOWN)
        blocked = jR.guard_allow_trade(guard.regime, jnp.where(sb == 1, -1, 1))
        return (guard, touch.reset_box(bo), ring), (fat, allow, ma_s, ma_l, blocked)

    jcarry = (jR.LeanGuardState.zeros(p, windowed=windowed),
              jR.RegularTouchState.zeros(p, 8), jnp.zeros((p, 32), jnp.float32))
    guard = R.LeanGuardState.zeros(p, windowed=windowed)
    touch = R.RegularTouchState.zeros(p, 8)
    ring = torch.zeros((p, 32))
    seen = {"acc": 0, "breakout": 0, "counted": 0, "fatigued": 0, "blocked": 0}
    for t in range(w):
        cols = [x[:, t] for x in (h, l, c, v)]
        jcarry, (jfat, jallow, jms, jml, jblocked) = jstep(
            jcarry, jnp.int32(t), *map(jnp.asarray, cols), jnp.asarray(idx[t]),
            jnp.asarray(side[t]))
        hb, lb, cb, vb = (torch.from_numpy(x) for x in cols)
        now = t * 60_000
        fat = R.edge_fatigued(touch, tt, now)
        allow = R.touch_allow(touch, tt, torch.from_numpy(idx[t]),
                              torch.from_numpy(side[t]), now)
        ring = R.ring_push(ring, vb)
        ms, ml = R.tail_mean_minclose(ring, t + 1, 5), R.tail_mean_minclose(ring, t + 1, 20)
        guard = R.lean_guard_push(guard, tg, bar_index=t, high=hb, low=lb, close=cb,
                                  vol_ring=ring)
        touch = R.touch_register(
            touch, tt, tl, ts_ms=now, high=hb, low=lb, close=cb, box_low=guard.box_low,
            box_high=guard.box_high, box_valid=guard.box_valid, vol_ma_s=ms,
            vol_ma_l=ml, enabled=guard.regime == G.REGIME_ACCUMULATION)
        bo = (guard.regime == G.REGIME_BREAKOUT_UP) | (guard.regime == G.REGIME_BREAKOUT_DOWN)
        blocked = R.guard_allow_trade(guard.regime, torch.where(
            torch.from_numpy(side[t]) == 1, -1, 1))
        seen["counted"] += int((touch.count > 0).sum())
        touch = touch.reset_box(bo)
        for name, a, b in (("fat", fat, jfat), ("ma_s", ms, jms), ("ma_l", ml, jml),
                           ("allow_trade", blocked, jblocked)):
            _eq(a, b, f"{name} at bar {t}")
        for k in range(3):
            _eq(allow[k], jallow[k], f"touch_allow[{k}] at bar {t}")
        for f in dataclasses.fields(guard):
            _eq(getattr(guard, f.name), getattr(jcarry[0], f.name), f"guard.{f.name} at bar {t}")
        for f in dataclasses.fields(touch):
            if f.name == "tap_ratio":
                # XLA fuses the ratio with the two window sums it divides and
                # re-associates them; the port divides the MAs it reports
                assert int(_ulps(touch.tap_ratio.numpy(), jcarry[1].tap_ratio).max()) <= 2
            else:
                _eq(getattr(touch, f.name), getattr(jcarry[1], f.name),
                    f"touch.{f.name} at bar {t}")
        seen["acc"] += int((guard.regime == G.REGIME_ACCUMULATION).sum())
        seen["breakout"] += int(bo.sum())
        seen["fatigued"] += int((fat != T.EDGE_NONE).sum())
        seen["blocked"] += int((~blocked).sum())
    assert all(n > 0 for n in seen.values()), seen


def test_decay_pow_is_the_kernel_product():
    cnt = torch.arange(0, 12, dtype=torch.int32)
    got = R.decay_pow(torch.tensor(0.85), cnt)
    want = np.ones(12, np.float32)
    for j in range(8):
        want = (want * np.where(np.arange(12) > j, np.float32(0.85), np.float32(1.0))
                ).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    # counts 0 and 1 (all a default budget of 2 lets through) equal JAX's power
    jpow = np.asarray(jnp.float32(0.85) ** jnp.arange(2, dtype=jnp.float32))
    np.testing.assert_array_equal(got.numpy()[:2], jpow)


# ---------------------------------------------------------------- 7 exits

def test_should_escalate_on_target_matches():
    jl, tl = _levels()
    rng = np.random.default_rng(6)
    p = 8192
    anchor = rng.choice([99.6, 100.0, 100.1, 100.4], p).astype(np.float32)
    price = (anchor + rng.uniform(-0.5, 0.5, p)).astype(np.float32)
    prices = (price[:, None] + np.cumsum(rng.normal(0, 0.05, (p, 5)), 1)).astype(np.float32)
    vols = rng.lognormal(13.0, 0.5, (p, 5)).astype(np.float32)
    side = rng.choice([1, -1], p).astype(np.int32)
    entry = (price + rng.normal(0, 0.3, p)).astype(np.float32)
    entry[:512] = np.float32(99.905)                       # a half-cent to round
    want = jexits.should_escalate_on_target(
        side=jnp.asarray(side), entry=jnp.asarray(entry), current_price=jnp.asarray(price),
        levels=jl, bar_prices=jnp.asarray(prices), bar_volumes=jnp.asarray(vols),
        bar_valid=None, full_window=True)
    got = exits.should_escalate_on_target(
        side=torch.from_numpy(side), entry=torch.from_numpy(entry),
        current_price=torch.from_numpy(price), levels=tl,
        bar_prices=torch.from_numpy(prices), bar_volumes=torch.from_numpy(vols))
    for f in ("escalate", "next_target", "trail_stop", "basis"):
        _eq(getattr(got, f), getattr(want, f), f)
    assert 0 < int(got.escalate.sum()) < p
    nxt, found = exits.next_level_target(tl, torch.from_numpy(price), torch.from_numpy(side))
    jn, jf = jexits.next_level_target(jl, jnp.asarray(price), jnp.asarray(side))
    _eq(nxt, jn)
    _eq(found, jf)


# ---------------------------------------------------------------- 8-10 ML, policy

@pytest.mark.parametrize("model", ["absent", "fixed", "skewed"])
def test_ml_allowed_matches(model):
    jml = {"absent": JMl.absent(),
           "fixed": JMl.from_weights(np.array([0.4, -0.8, -0.3, 0.2], np.float32), 0.55),
           "skewed": JMl.from_weights(np.array([0.4, -0.8, -0.3], np.float32), 0.1, 3)}[model]
    rng = np.random.default_rng(8)
    n = 8192
    kw = dict(level_solid=rng.uniform(size=n) < 0.5,
              level_price=rng.choice([99.6, 100.0, 100.4], n).astype(np.float32),
              stop=rng.uniform(99, 101, n).astype(np.float32),
              touch_count=rng.integers(0, 6, n).astype(np.int32),
              direction=rng.choice([-1, 0, 1], n).astype(np.int32))
    jok, jp, ju = j_ml_allowed(jml, JParams.default(), **{k: jnp.asarray(v) for k, v in kw.items()})
    tok, tp, tu = _ml_allowed(_to_torch(jml, MlModel), EngineParams.default(),
                              **{k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()})
    _eq(tok, jok)
    _eq(tu, ju)
    assert int(_ulps(tp.numpy(), jp).max()) <= 2
    if model == "fixed":
        assert 0 < int((~tok).sum()) < n


def test_policy_score_and_entry_gate_match():
    rng = np.random.default_rng(7)
    w_entry = rng.normal(0, 0.8, (3, 7)).astype(np.float32)
    w_entry[0, 0] += 0.8
    w_entry[1, 0] += 0.8
    w_entry[2, 0] -= 0.5
    jpol = jOP.PolicyParams.init().replace(w_entry=jnp.asarray(w_entry))
    tpol = _to_torch(jpol, OP.PolicyParams)
    n = 4096
    x = np.asarray(jF.policy_features(
        proximity_abs=jnp.asarray(rng.uniform(0, 0.1, n).astype(np.float32)),
        volume_trend=jnp.zeros(n), approach=jnp.asarray(rng.integers(0, 2, n)),
        confluence=jnp.asarray(rng.uniform(size=n) < 0.5),
        minutes_since_open=jnp.asarray(rng.integers(0, 400, n))))
    go_long = rng.uniform(size=n) < 0.5
    # XLA takes the scores' dot products as one matrix product, adding in its
    # own order; the port adds in feature order, as the CUDA kernel does
    js = np.asarray(jOP.score_entry(jpol, jnp.asarray(x)))
    ts = OP.score_entry(tpol, torch.from_numpy(x.copy())).numpy()
    np.testing.assert_allclose(ts, js, rtol=2e-6, atol=1e-7)
    _eq(OP.entry_gate(tpol, torch.from_numpy(x.copy()), torch.from_numpy(go_long)),
        jOP.entry_gate(jpol, jnp.asarray(x), jnp.asarray(go_long)))
    z = torch.tensor([-60.0, -50.0, 0.0, 50.0, 60.0])
    _eq(OP.sigmoid_clamped(z), jOP._sigmoid_clamped(jnp.asarray(z.numpy())))
