"""The full 12-gate QMMX engine over generated paths.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/sim/enginepath.py:85-678``.
The gated slice (``sim/gatedpath.py``) runs five gates; this module runs the
reference's whole ``evaluate_entry`` ladder (qmmx_monolithic.py:1492-1771),
the app-level OnlinePolicy gate (:3076-3093) and target escalation
(:1950-2012) over every path, one bar at a time:

  B. position management on the bar's high/low (same-bar ties by the
     distance-weighted coin, :3467-3480); on a target touch within
     CONTACT_PROX of the close, ``should_escalate_on_target`` (:897-960) may
     roll the target to the next level and trail the stop instead of closing;
  C. entry evaluation at the close against state from bars <= t-1:
     IN_POSITION, COOLDOWN (ms), NOLEVELS, DIR_UNKNOWN, TOO_FAR, the contact
     latch and LEVEL_OVERTOUCHED, then while the guard is accumulating
     EDGE_FATIGUE / TOUCH_BUDGET / TOUCH_COOLDOWN and the decay multiplier,
     CONF_LOW, ACC_BREAKOUT_GATE, the soft volume veto (CONTRA_VOL_*), the
     ML / blend gate (ML_CONF_LOW, COMBINED_LOW), ONLINE_POLICY; the first
     failing gate of each (path, bar) is counted;
  D. the minute close of bar t (:1813-1855): the (close, volume) rings, the
     accumulation guard, touch registration while accumulating, and the
     touch-box reset on a breakout.

``EngineLifecycle.step`` is that bar; ``engine_path_replay`` and the streamed
``mc_paths_engine`` drive it here, and the plain version of the engine kernel
(``ops/cuda_engine.py``) drives the same function.  Float32 and int32 in the
JAX package's order of operations (sums in slot order; fused multiply-adds
where XLA fuses: the noise terms, the ML dot, the blend), so the same bars
give the same decisions.  The skip table is int64 (the JAX replay's float32
table stops counting exactly past 2^24 evaluations).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import EngineParams
from ..engine import exits
from ..engine.gates import _ml_allowed
from ..engine.state import MlModel
from ..models import online_policy as OP
from ..ops import confidence as C
from ..ops import features as F
from ..ops import guard as G
from ..ops import pathgen as PG
from ..ops import regular as R
from ..ops import touch as T
from ..reasons import Reason
from ..types import (DIR_DOWN, DIR_UNKNOWN, DIR_UP, KIND_SOLID, SIDE_FLAT,
                     SIDE_LONG, SIDE_SHORT, Levels)
from ..utils import device as devices
from ..utils import prng
from ..utils.floats import fma
from . import pathsim
from .hits import bar_hit_outcome
from .pathsim import LIFE_HIST_HI, LIFE_HIST_LO, PathStats

BAR_MS = 60_000
BARS_RING = 32   # volume windows the gates read are <= 20 bars

# first-fail skip buckets, in gate order (the log analyzer's table at scale)
SKIP_REASONS = (
    Reason.IN_POSITION, Reason.COOLDOWN, Reason.NOLEVELS, Reason.DIR_UNKNOWN,
    Reason.TOO_FAR, Reason.LEVEL_OVERTOUCHED, Reason.EDGE_FATIGUE,
    Reason.TOUCH_BUDGET, Reason.TOUCH_COOLDOWN, Reason.CONF_LOW,
    Reason.ACC_BREAKOUT_GATE, Reason.CONTRA_VOL_LONG, Reason.CONTRA_VOL_SHORT,
    Reason.COMBINED_LOW, Reason.ML_CONF_LOW, Reason.ONLINE_POLICY,
)
_SKIP_CODES = [int(r) for r in SKIP_REASONS]
_N_CODES = max(int(r) for r in Reason) + 1

_F32, _I32 = torch.float32, torch.int32


def skip_columns(reason: torch.Tensor) -> torch.Tensor:
    """A bar's first-fail reason codes i32[P] as i32[P, 16]: 1 in the
    column of SKIP_REASONS that the path's reason names, 0 elsewhere.
    Summed over bars, the per-path skip table."""
    codes = torch.tensor(_SKIP_CODES, dtype=reason.dtype, device=reason.device)
    return (reason[:, None] == codes).to(_I32)


def _check_state_envelope(touch_params: T.TouchMemoryParams,
                          guard_params: G.GuardParams) -> None:
    """Reject parameters the windowed state forms would silently mishandle:
    ``fatigue_hits`` deeper than the tap stack never fatigues, and guard
    volume windows wider than the shared ring under-sum."""
    fh = int(touch_params.fatigue_hits)
    vs, vl = int(guard_params.vol_short), int(guard_params.vol_long)
    if fh > R.TAP_STACK:
        raise ValueError(
            f"fatigue_hits={fh} exceeds the tap stack depth ({R.TAP_STACK}): "
            "edge fatigue would silently never fire")
    if vs > BARS_RING or vl > BARS_RING:
        raise ValueError(
            f"guard vol windows ({vs}/{vl}) exceed the shared {BARS_RING}-bar "
            "volume ring: the MAs would silently under-sum")


class EngineLifecycleOutcome(NamedTuple):
    """Per-path results ([P] each) and the first-fail skip table."""

    equity: torch.Tensor       # f32 total R over closed trades
    trades: torch.Tensor       # i32 entries taken
    wins: torch.Tensor         # i32 closes with pnl > 0
    losses: torch.Tensor       # i32 closes with pnl <= 0
    open_at_end: torch.Tensor  # bool
    max_dd: torch.Tensor       # f32 peak-tracked max drawdown in R (>= 0)
    escalations: torch.Tensor  # i32 target rolls taken
    skip_counts: torch.Tensor  # int64[16], ordered as SKIP_REASONS


def blend_weights(params: EngineParams) -> tuple[torch.Tensor, torch.Tensor]:
    """(w_rules, w_ml) normalized to sum 1, or (1, 0) when they sum <= 0
    (engine/gates.py:333-335), float32."""
    s_w = params.w_rules + params.w_ml
    bad = s_w <= 0
    safe = torch.where(bad, 1.0, s_w)
    return (torch.where(bad, 1.0, params.w_rules / safe),
            torch.where(bad, 0.0, params.w_ml / safe))


def engine_knobs(policy=None, ml_model=None, touch_params=None, guard_params=None,
                 policy_gate_disabled=None, escalation: bool = True,
                 bar0_minute: int = 0) -> dict:
    """The engine's knobs with their defaults filled in, as
    ``mc_paths_pallas_engine`` fills them (pallas_engine.py:1666-1677): no
    policy disables the policy gate (an untrained zero policy scores 0.5 <
    0.60 and would veto every entry; the reference ships DISABLE_POLICY_GATE
    for that) unless ``policy_gate_disabled`` says otherwise."""
    return dict(
        policy=OP.PolicyParams.init() if policy is None else policy,
        ml_model=MlModel.absent() if ml_model is None else ml_model,
        touch_params=T.TouchMemoryParams.default() if touch_params is None else touch_params,
        guard_params=G.GuardParams.default() if guard_params is None else guard_params,
        policy_gate_disabled=(policy is None if policy_gate_disabled is None
                              else bool(policy_gate_disabled)),
        escalation=bool(escalation), bar0_minute=int(bar0_minute))


def cooldown_ms(params: EngineParams) -> int:
    """Q_SIGNAL_COOLDOWN in ms: float32 seconds x 1000, truncated."""
    return int((params.cooldown_s.to(_F32) * 1000.0).to(_I32))


class EngineLifecycle:
    """The full engine's state over P paths; ``step`` advances one bar.

    The engine's knobs (policy, ML model, touch and guard parameters, the
    policy-gate switch, escalation, bar 0's minute of the trading day) default as
    ``engine_knobs`` fills them.  ``windowed`` carries the guard's 61-slot
    extreme rings, which horizons past GUARD_WINDOW_BARS need."""

    def __init__(self, prev_c: torch.Tensor, levels: Levels, params: EngineParams,
                 *, noise=None, exit_at_close: bool = False, windowed: bool = False,
                 **knobs):
        k = engine_knobs(**knobs)
        self.tp, self.gp = k["touch_params"], k["guard_params"]
        _check_state_envelope(self.tp, self.gp)
        self.ml, self.policy = k["ml_model"], k["policy"]
        self.policy_off = k["policy_gate_disabled"]
        self.escalation, self.bar0_minute = k["escalation"], k["bar0_minute"]
        dev = prev_c.device
        p, n_lvl = prev_c.shape[0], levels.max_levels
        self.levels, self.params, self.noise = levels.to(dev), params, noise
        self.exit_at_close = exit_at_close
        self.has_levels = bool(levels.count > 0)
        self.cooldown_ms = cooldown_ms(params)
        self.w_rules, self.w_ml = blend_weights(params)
        self.lvl_price_f = torch.where(self.levels.valid, self.levels.price, 0.0)
        self.lvl_iota = torch.arange(n_lvl, dtype=_I32, device=dev)

        zf = torch.zeros((p,), dtype=_F32, device=dev)
        zi = torch.zeros((p,), dtype=_I32, device=dev)
        self.side = zi
        self.entry = self.stop = self.target = self.risk0 = zf
        self.cooldown_until = zi - (1 << 30)
        self.last_dir = zi + DIR_UNKNOWN
        self.prev_c = prev_c.to(_F32)
        self.c_counts = torch.zeros((p, n_lvl), dtype=_I32, device=dev)
        self.c_latch = torch.zeros((p, n_lvl), dtype=torch.bool, device=dev)
        self.guard = R.LeanGuardState.zeros(p, windowed=windowed, device=dev)
        self.touch = R.RegularTouchState.zeros(p, n_lvl, device=dev)
        self.ring_c = torch.zeros((p, BARS_RING), dtype=_F32, device=dev)
        self.ring_v = torch.zeros((p, BARS_RING), dtype=_F32, device=dev)
        self.equity = self.peak = self.dd = zf
        self.trades = self.wins = self.losses = self.escal = zi
        self.skips = torch.zeros((len(SKIP_REASONS),), dtype=torch.int64, device=dev)

    def step(self, t: int, h, l, c, v, tie, nz=None) -> torch.Tensor:
        """Bar ``t`` (high/low/close/volume/tie coin f32[P]; ``nz`` the bar's
        four execution-noise normals: level jitter, entry, stop and target
        slips).  Returns the bar's first-fail reason codes i32[P]."""
        params, levels, tp = self.params, self.levels, self.tp
        prox = params.contact_prox
        side, entry, stop, target = self.side, self.entry, self.stop, self.target
        now_ms = t * BAR_MS

        # ---- B) position management (:2966-3014)
        is_open = side != SIDE_FLAT
        is_long = side == SIDE_LONG
        bh = bar_hit_outcome(is_open=is_open, is_long=is_long, entry=entry,
                             stop=stop, target=target, high=h, low=l, tie=tie)
        tf, hit = bh.target_first, bh.hit
        esc_on = self.escalation and t >= exits.VOL_LOOKBACK
        if esc_on:
            # evaluated at the close, within CONTACT_PROX of the target,
            # against the VOL_LOOKBACK newest finished bars
            k = exits.VOL_LOOKBACK
            esc = exits.should_escalate_on_target(
                side=side, entry=entry, current_price=c, levels=levels,
                bar_prices=self.ring_c[:, :k].flip(-1),
                bar_volumes=self.ring_v[:, :k].flip(-1))
            escalate = hit & tf & ((c - target).abs() <= prox) & esc.escalate
            closed = hit & ~escalate
        else:
            closed = hit
        exit_px = c if self.exit_at_close else torch.where(tf, target, stop)
        pnl = torch.where(closed, torch.where(is_long, exit_px - entry,
                                              entry - exit_px), 0.0)
        # R on the risk at open (a trailed stop would blow R up)
        r = torch.where(closed, pnl / torch.clamp(self.risk0, min=1e-9), 0.0)
        self.equity = self.equity + r
        self.peak = torch.maximum(self.peak, self.equity)
        self.dd = torch.maximum(self.dd, self.peak - self.equity)
        self.wins = self.wins + (closed & (pnl > 0)).to(_I32)
        self.losses = self.losses + (closed & (pnl <= 0)).to(_I32)
        if esc_on:
            stop = torch.where(escalate, esc.trail_stop, stop)
            target = torch.where(escalate, esc.next_target, target)
            self.escal = self.escal + escalate.to(_I32)
        side = torch.where(closed, SIDE_FLAT, side)
        self.cooldown_until = torch.where(closed, now_ms + self.cooldown_ms,
                                          self.cooldown_until)

        # ---- C) the entry ladder at the close (:1492-1771 + :3046-3112)
        reason = torch.zeros_like(side)

        def first_fail(reason, fail, code):
            return torch.where((reason == Reason.OK) & fail, int(code), reason)

        reason = first_fail(reason, is_open, Reason.IN_POSITION)
        reason = first_fail(reason, now_ms < self.cooldown_until, Reason.COOLDOWN)
        if not self.has_levels:
            reason = first_fail(reason, True, Reason.NOLEVELS)
        # direction: an eps band; a flat tick reuses the last direction
        prev_c = self.prev_c
        if t > 0:
            direction = torch.where(
                c > prev_c + 1e-9, DIR_UP,
                torch.where(c < prev_c - 1e-9, DIR_DOWN, self.last_dir)).to(_I32)
        else:
            direction = torch.full_like(side, DIR_UNKNOWN)
        reason = first_fail(reason, direction == DIR_UNKNOWN, Reason.DIR_UNKNOWN)
        idx, dist, lvlp, lvlk = F.nearest_level_full(levels, c)
        reason = first_fail(reason, dist > prox, Reason.TOO_FAR)

        # 7) contact latch + LEVEL_OVERTOUCHED; the latch moves exactly when
        # gates 2-6 passed
        reached7 = (reason == Reason.OK)[:, None]
        dist_all = torch.where(levels.valid[None, :],
                               (self.lvl_price_f[None, :] - c[:, None]).abs(),
                               float("inf"))
        is_nearest = self.lvl_iota[None, :] == idx[:, None]
        inside = dist_all <= prox
        fresh = is_nearest & inside & ~self.c_latch
        latch_new = torch.where(is_nearest, inside, self.c_latch & inside)
        self.c_counts = torch.where(reached7, self.c_counts + fresh.to(_I32),
                                    self.c_counts)
        self.c_latch = torch.where(reached7, latch_new & levels.valid[None, :],
                                   self.c_latch)
        tc = self.c_counts.gather(1, idx.long()[:, None])[:, 0]
        reason = first_fail(reason, tc >= params.overtouch_limit,
                            Reason.LEVEL_OVERTOUCHED)

        # 7b) accumulation gates (:1589-1621)
        accumulating = self.guard.regime == G.REGIME_ACCUMULATION
        fatigued_edge = R.edge_fatigued(self.touch, tp, now_ms)
        edge_for_this = torch.where(direction == DIR_DOWN, T.EDGE_TOP, T.EDGE_BOT)
        reason = first_fail(reason, accumulating & (fatigued_edge == edge_for_this),
                            Reason.EDGE_FATIGUE)
        tm_side = torch.where(direction == DIR_DOWN, T.TM_SHORT, T.TM_LONG)
        tm_ok, tm_budget, tm_mult = R.touch_allow(self.touch, tp, idx, tm_side, now_ms)
        tm_fail = accumulating & ~tm_ok
        reason = first_fail(reason, tm_fail & tm_budget, Reason.TOUCH_BUDGET)
        reason = first_fail(reason, tm_fail & ~tm_budget, Reason.TOUCH_COOLDOWN)
        decay_mult = torch.where(accumulating & tm_ok, tm_mult, 1.0)

        # 8) confidence x decay (:1626-1641)
        conf = C.compute_confidence(level_price=lvlp, level_kind=lvlk, price=c,
                                    direction=direction, touch_count=tc,
                                    contact_prox=prox) * decay_mult
        reason = first_fail(reason, conf < params.q_min_prob, Reason.CONF_LOW)

        # 9) side and the clean scaffold the gates see; 9b) breakout gate
        new_side = torch.where(direction == DIR_UP, SIDE_LONG, SIDE_SHORT).to(_I32)
        go_long = new_side == SIDE_LONG
        stop_clean = torch.where(go_long, lvlp - params.stop_padding,
                                 lvlp + params.stop_padding)
        reason = first_fail(reason, ~R.guard_allow_trade(self.guard.regime, new_side),
                            Reason.ACC_BREAKOUT_GATE)

        # 10) soft volume veto (:1677-1705 -> :1773-1794), over the finished
        # bars oldest -> newest
        n_hist = min(t, BARS_RING)
        valid_on = (torch.arange(BARS_RING, device=c.device) < n_hist).flip(-1)
        vslope = F.volume_slope(self.ring_v.flip(-1), valid_on.expand_as(self.ring_v),
                                window=6)
        veto_ok, veto_reason = C.soft_veto(
            side=new_side, volume_slope=vslope, approach_from_below=direction == DIR_UP,
            confluence=F.has_confluence_near(levels, lvlp, params.confluence_within),
            proximity_abs=dist, contact_prox=prox,
            veto_vol_strong=params.veto_vol_strong, veto_prox=params.veto_prox)
        veto_fail = params.enable_veto & ~veto_ok
        reason = torch.where((reason == Reason.OK) & veto_fail, veto_reason, reason)

        # 11) ML / blended gate (:1707-1756)
        ok_ml, ml_proba, ml_usable = _ml_allowed(
            self.ml, params, level_solid=lvlk == KIND_SOLID, level_price=lvlp,
            stop=stop_clean, touch_count=tc, direction=direction)
        ran_ml = ~params.disable_ml_gate
        if bool(params.use_blend):
            mlp = torch.where(ran_ml & ml_usable, ml_proba, conf)
            blended = fma(self.w_rules, conf, self.w_ml * mlp)
            reason = first_fail(reason, blended < params.q_min_prob,
                                Reason.COMBINED_LOW)
        else:
            reason = first_fail(reason, ran_ml & ~ok_ml, Reason.ML_CONF_LOW)

        # 12) OnlinePolicy gate (:3046-3112); the live loop hardcodes the
        # volume trend feature to 0.0 (:3072)
        if not self.policy_off:
            x = F.policy_features(
                proximity_abs=dist, volume_trend=torch.zeros_like(dist),
                approach=go_long.to(_I32),
                confluence=F.confluence_count(levels, lvlp, exits.CONFLUENCE_WINDOW) > 1,
                minutes_since_open=self.bar0_minute + t)
            reason = first_fail(reason, ~OP.entry_gate(self.policy, x, go_long),
                                Reason.ONLINE_POLICY)

        enter = reason == Reason.OK
        noise = self.noise
        if noise is not None:
            # the opened trade's level, fill and barriers jitter per entry;
            # the gates saw the clean scaffold (:3453-3461)
            lvl_eff = fma(nz[0], noise.level_jitter_std, lvlp)
            fill = fma(nz[1], noise.entry_slip_std, c)
        else:
            lvl_eff, fill = lvlp, c
        stop_new = torch.where(go_long, lvl_eff - params.stop_padding,
                               lvl_eff + params.stop_padding)
        tgt_new = torch.where(go_long, lvl_eff + params.tp_padding,
                              lvl_eff - params.tp_padding)
        if noise is not None:
            stop_new = fma(nz[2], noise.stop_slip_std, stop_new)
            tgt_new = fma(nz[3], noise.target_slip_std, tgt_new)
        self.side = torch.where(enter, new_side, side)
        self.entry = torch.where(enter, fill, entry)
        self.stop = torch.where(enter, stop_new, stop)
        self.target = torch.where(enter, tgt_new, target)
        self.risk0 = torch.where(enter, (fill - stop_new).abs(), self.risk0)
        self.trades = self.trades + enter.to(_I32)
        if t > 0:
            # direction state (:2952-2955): exact != (no eps)
            self.last_dir = torch.where(
                c != prev_c, torch.where(c > prev_c, DIR_UP, DIR_DOWN),
                self.last_dir).to(_I32)

        # ---- D) minute close of bar t (:1813-1855)
        self.ring_c = R.ring_push(self.ring_c, c)
        self.ring_v = R.ring_push(self.ring_v, v)
        vol_ma_s = R.tail_mean_minclose(self.ring_v, t + 1, 5)
        vol_ma_l = R.tail_mean_minclose(self.ring_v, t + 1, 20)
        guard = R.lean_guard_push(self.guard, self.gp, bar_index=t, high=h, low=l,
                                  close=c, vol_ring=self.ring_v)
        touch = R.touch_register(
            self.touch, tp, levels, ts_ms=now_ms, high=h, low=l, close=c,
            box_low=guard.box_low, box_high=guard.box_high,
            box_valid=guard.box_valid, vol_ma_s=vol_ma_s, vol_ma_l=vol_ma_l,
            enabled=guard.regime == G.REGIME_ACCUMULATION)
        breakout = ((guard.regime == G.REGIME_BREAKOUT_UP)
                    | (guard.regime == G.REGIME_BREAKOUT_DOWN))
        self.guard, self.touch = guard, touch.reset_box(breakout)
        self.prev_c = c
        self.skips += torch.bincount(reason.long(), minlength=_N_CODES)[_SKIP_CODES]
        return reason

    def outcome(self) -> EngineLifecycleOutcome:
        return EngineLifecycleOutcome(
            equity=self.equity, trades=self.trades, wins=self.wins,
            losses=self.losses, open_at_end=self.side != SIDE_FLAT,
            max_dd=self.dd, escalations=self.escal, skip_counts=self.skips)


def engine_path_replay(paths: PG.PathBars, levels: Levels, params: EngineParams,
                       tie_uniform, *, policy=None, ml_model=None,
                       touch_params=None, guard_params=None,
                       policy_gate_disabled: bool | None = None,
                       escalation: bool = True, bar0_minute: int = 0, noise=None,
                       noise_normals=None, exit_at_close: bool = False,
                       harvest: bool = False, return_curve: bool = False):
    """Run the full engine over every path (``EngineLifecycle``, a Python
    loop over bars).  ``tie_uniform`` f32[P, W] holds the same-bar tie coins;
    ``noise`` (sim.montecarlo.McNoise) jitters each entry's scaffold with the
    bar's normals in ``noise_normals`` (f32[4, P, W]); ``exit_at_close``
    prices exits at the close, as the live loop does.  ``return_curve=True``
    also returns the post-bar equity curve f32[W, P].  The closed-trade label
    harvest is not ported yet."""
    if harvest:
        raise NotImplementedError("harvest=True is not ported yet")
    close = torch.as_tensor(paths.close, dtype=_F32)
    w = close.shape[1]
    life = EngineLifecycle(
        torch.as_tensor(paths.open, dtype=_F32)[:, 0], levels, params,
        policy=policy, ml_model=ml_model, touch_params=touch_params,
        guard_params=guard_params, policy_gate_disabled=policy_gate_disabled,
        escalation=escalation, bar0_minute=bar0_minute, noise=noise,
        exit_at_close=exit_at_close, windowed=w > R.GUARD_WINDOW_BARS)
    tie = torch.as_tensor(tie_uniform, dtype=_F32)
    high, low = (torch.as_tensor(x, dtype=_F32) for x in (paths.high, paths.low))
    vol = torch.as_tensor(paths.volume, dtype=_F32)
    curve = []
    for t in range(w):
        nz = (tuple(n[:, t] for n in noise_normals) if noise is not None else None)
        life.step(t, high[:, t], low[:, t], close[:, t], vol[:, t], tie[:, t], nz)
        if return_curve:
            curve.append(life.equity)
    out = life.outcome()
    return (out, torch.stack(curve)) if return_curve else out


def _one_block_engine(seed: int, block: int, *, levels, params, block_paths,
                      num_bars, s0, mu, sigma, dt, sampler, antithetic,
                      volume_model, noise, device, symbol: int = 0, sampler_kw=None,
                      **engine_kw):
    paths = pathsim.sample_block(
        seed, block, block_paths=block_paths, num_bars=num_bars, s0=s0, mu=mu,
        sigma=sigma, dt=dt, sampler=sampler, antithetic=antithetic,
        volume_model=volume_model, symbol=symbol, device=device, **(sampler_kw or {}))
    tie = prng.uniform_rows(seed, prng.STREAM_TIE_COIN, block0=block, n_blocks=1,
                            n_rows=num_bars, lanes=block_paths, symbol=symbol,
                            device=device)[0].T
    draws = (pathsim.noise_normals(seed, block, block_paths, device,
                                   num_bars=num_bars, symbol=symbol)
             if noise is not None else None)
    out = engine_path_replay(paths, levels, params, tie, noise=noise,
                             noise_normals=draws, **engine_kw)
    stats = PathStats.from_lifecycle(
        equity=out.equity, trades=out.trades, wins=out.wins, losses=out.losses,
        open_at_end=out.open_at_end, max_dd=out.max_dd)
    return stats, out.skip_counts, out.escalations.sum(dtype=torch.int64)


def mc_paths_engine(seed: int, levels: Levels, params: EngineParams, *,
                    num_paths: int, num_bars: int = 40, s0=100.0, mu: float = 0.0,
                    sigma: float = 0.15, dt: float = 1.0 / (390.0 * 252.0),
                    sampler: str = "gbm", block_paths: int = 1 << 13,
                    antithetic: bool = False, policy=None, ml_model=None,
                    touch_params=None, guard_params=None,
                    policy_gate_disabled: bool | None = None,
                    escalation: bool = True, bar0_minute: int = 0, noise=None,
                    volume_model=None, harvest: bool = False, hist_bars=None,
                    block_len: int = 10, heston=None, symbol: int = 0, device=None):
    """Streamed generated-path MC under the full engine: ``num_paths`` paths
    in blocks of ``block_paths``.  Returns (PathStats over the lifecycle
    histogram range, int64[16] skip table ordered as SKIP_REASONS, int64
    escalations); ``symbol`` keys the draws and ``sampler``, ``hist_bars``,
    ``block_len`` and ``heston`` pick the bars as in ``pathsim.mc_paths``
    (the bootstrap samplers' recorded volumes reach the volume gates).  Runs
    on ``device``: the CUDA device by default (raising where there is none),
    the CPU when asked."""
    if harvest:
        raise NotImplementedError("harvest=True is not ported yet")
    if num_paths % block_paths != 0:
        raise ValueError("num_paths must be a multiple of block_paths")
    device = devices.resolve(device)
    levels = levels.to(device)
    stats = PathStats.zero(LIFE_HIST_LO, LIFE_HIST_HI, device=device)
    skips = torch.zeros((len(SKIP_REASONS),), dtype=torch.int64, device=device)
    escal = torch.zeros((), dtype=torch.int64, device=device)
    sampler_kw = dict(block_len=block_len, heston=heston,
                      tables=pathsim.sampler_tables(sampler, hist_bars))
    for b in range(num_paths // block_paths):
        st, sk, es = _one_block_engine(
            seed, b, levels=levels, params=params, block_paths=block_paths,
            num_bars=num_bars, s0=s0, mu=mu, sigma=sigma, dt=dt, sampler=sampler,
            antithetic=antithetic, volume_model=volume_model, noise=noise,
            device=device, symbol=symbol, sampler_kw=sampler_kw, policy=policy,
            ml_model=ml_model,
            touch_params=touch_params, guard_params=guard_params,
            policy_gate_disabled=policy_gate_disabled, escalation=escalation,
            bar0_minute=bar0_minute)
        stats, skips, escal = stats.merge(st), skips + sk, escal + es
    return stats, skips, escal
