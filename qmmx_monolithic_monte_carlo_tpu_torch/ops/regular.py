"""Bar-synchronous guard and touch-memory state for 1-minute bars.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/ops/regular.py:40-536``:
the forms the generated-path engine runs (``sim/enginepath.py``), where every
path emits exactly one bar a minute.  Rings shift each bar so that slot 0
holds the newest bar; the guard's 60-minute window is the newest 61 slots;
an edge's taps age monotonically, so an 8-deep stack pushed only when a tap
fires answers the fatigue query (the k-th newest tap in the window <=> at
least k taps in it).  State tensors carry a leading path axis [P, ...];
timestamps are ``bar_index * 60_000`` ms, and bar counts are Python ints
(every path is at the same bar).

Float32 window sums add the filled slots in slot order (``features.seq_sum``),
as XLA's reduction does on the JAX side; slots past the filled ones hold 0.0,
which adds nothing, so summing only the filled slots gives the same bits.

The ring-buffer ``guard_push`` / ``RegularGuardState`` form, which carries
the bars themselves, waits for the tick engine.
"""

from __future__ import annotations

import dataclasses

import torch

from ..types import SIDE_LONG, SIDE_SHORT, Levels
from ..utils.floats import div
from . import guard as G
from . import touch as T
from .features import seq_sum

GUARD_RING = 64          # the JAX form's padded volume window
GUARD_WINDOW_BARS = 61   # (t_end - ts) <= 60 min covers ages 0..60 (:1247)
TAP_STACK = 8            # supports fatigue_hits <= 8 (reference default 3)
TAP_NEVER = -(1 << 30)   # empty-slot timestamp (never in the window)

_F32, _I32 = torch.float32, torch.int32
_INF = float("inf")


def ring_push(ring: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Shift a [..., R] newest-first ring: slot 0 := new, the others age."""
    return torch.cat([new[..., None].to(ring.dtype), ring[..., :-1]], dim=-1)


def tail_mean_minclose(vol_ring: torch.Tensor, n_bars: int, k: int) -> torch.Tensor:
    """The ``_on_minute_close`` volume MA (:1827): mean of the newest
    ``min(k, n)`` volumes over ``max(1, min(k, n))``; ``vol_ring`` is
    newest-first and ``n_bars`` the bars pushed so far."""
    n_bars, k = int(n_bars), int(k)
    upto = min(k, n_bars, vol_ring.shape[-1])
    return div(seq_sum(vol_ring[..., :upto]), max(1, min(k, n_bars)))


def decay_pow(decay, cnt: torch.Tensor, max_steps: int = 8) -> torch.Tensor:
    """``decay ** cnt`` as the TPU kernel computes it (pallas_engine.py:148-155):
    a product over ``max_steps`` unrolled factors, never a ``pow``.  Counts
    past ``max_steps`` saturate; they are budget-blocked before the
    multiplier is read.  For counts 0 and 1 (every count a default budget of
    2 lets through) it equals the JAX replay's ``decay ** cnt``."""
    out = torch.ones(cnt.shape, dtype=_F32, device=cnt.device)
    for j in range(max_steps):
        out = out * torch.where(cnt > j, decay, 1.0)
    return out


# --------------------------------------------------------------------------
# guard (AccumulationBreakoutGuard, qmmx_monolithic.py:1241-1356)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class LeanGuardState:
    """The guard without bar rings: the window's extremes as running min/max
    while the horizon fits the 60-minute window, as 61-slot newest-first
    extreme rings (``windowed``) past it; the volume MAs come from the
    caller's volume ring.  +-inf sentinels are the min/max identities."""

    run_low: torch.Tensor     # f32[P] | f32[P, 61]
    run_high: torch.Tensor    # f32[P] | f32[P, 61]
    box_low: torch.Tensor     # f32[P]
    box_high: torch.Tensor    # f32[P]
    box_valid: torch.Tensor   # bool[P]
    regime: torch.Tensor      # i32[P] (G.REGIME_*)
    inside_count: torch.Tensor  # i32[P]

    @classmethod
    def zeros(cls, p: int, *, windowed: bool, device=None) -> "LeanGuardState":
        shape = (p, GUARD_WINDOW_BARS) if windowed else (p,)
        zf = torch.zeros((p,), dtype=_F32, device=device)
        zi = torch.zeros((p,), dtype=_I32, device=device)
        return cls(run_low=torch.full(shape, _INF, dtype=_F32, device=device),
                   run_high=torch.full(shape, -_INF, dtype=_F32, device=device),
                   box_low=zf, box_high=zf,
                   box_valid=torch.zeros((p,), dtype=torch.bool, device=device),
                   regime=zi + G.REGIME_UNKNOWN, inside_count=zi)


def _regime_update(params: G.GuardParams, *, price_now, box_low_w, box_high_w,
                   vol_ma_s, s_def: bool, vol_ma_l, l_def: bool, n_win: int,
                   box_low, box_high, box_valid, regime, inside_count):
    """``_update_state`` (:1284-1339) on the window's statistics: the five
    updated guard scalars."""
    box_height = box_high_w - box_low_w
    compress_thresh = price_now * (params.compression_bp / 10000.0)
    mas_ok = (vol_ma_s != 0.0) & (vol_ma_l != 0.0) & (s_def and l_def)
    in_breakout = (regime == G.REGIME_BREAKOUT_UP) | (regime == G.REGIME_BREAKOUT_DOWN)
    compressed = box_height <= torch.clamp(compress_thresh, min=1e-6)
    regime = torch.where(in_breakout, regime,
                         torch.where(compressed, G.REGIME_ACCUMULATION,
                                     G.REGIME_UNKNOWN)).to(_I32)
    box_low = torch.where(compressed, box_low_w, box_low)
    box_high = torch.where(compressed, box_high_w, box_high)
    box_valid = compressed | box_valid

    spike = mas_ok & (vol_ma_s > params.vol_k * vol_ma_l)
    can_check = box_valid & mas_ok
    up = can_check & (price_now > box_high + 1e-6) & spike
    down = can_check & ~up & (price_now < box_low - 1e-6) & spike
    regime = torch.where(up, G.REGIME_BREAKOUT_UP,
                         torch.where(down, G.REGIME_BREAKOUT_DOWN, regime)).to(_I32)
    inside_count = torch.where(up | down, 0, inside_count)

    in_breakout2 = (regime == G.REGIME_BREAKOUT_UP) | (regime == G.REGIME_BREAKOUT_DOWN)
    inside = (box_low <= price_now) & (price_now <= box_high)
    do_track = in_breakout2 & box_valid
    inside_count = torch.where(do_track, torch.where(inside, inside_count + 1, 0),
                               inside_count).to(_I32)
    cleared = do_track & inside & (inside_count >= params.reenter_clear_bars)
    regime = torch.where(cleared, G.REGIME_ACCUMULATION, regime).to(_I32)
    if n_win < int(params.min_bars):
        regime = torch.zeros_like(regime) + G.REGIME_UNKNOWN
        box_valid = torch.zeros_like(box_valid)
        inside_count = torch.zeros_like(inside_count)
    return box_low, box_high, box_valid, regime, inside_count


def lean_guard_push(st: LeanGuardState, params: G.GuardParams, *, bar_index: int,
                    high, low, close, vol_ring) -> LeanGuardState:
    """push_minute_bar + _update_state (:1268-1339) for the bar after
    ``bar_index`` earlier ones; ``vol_ring`` is the caller's newest-first
    volume ring, already holding this bar.  The guard's window MAs are
    defined only at >= k bars and divide by k (:1279-1283)."""
    h = torch.as_tensor(high, dtype=_F32)
    l = torch.as_tensor(low, dtype=_F32)
    c = torch.as_tensor(close, dtype=_F32)
    n_win = min(int(bar_index) + 1, GUARD_WINDOW_BARS)
    if st.run_low.dim() == 2:
        run_low, run_high = ring_push(st.run_low, l), ring_push(st.run_high, h)
        box_low_w, box_high_w = run_low.amin(dim=-1), run_high.amax(dim=-1)
    else:
        run_low = torch.minimum(st.run_low, l)
        run_high = torch.maximum(st.run_high, h)
        box_low_w, box_high_w = run_low, run_high
    r = min(vol_ring.shape[-1], GUARD_RING)

    def win_tail_mean(k: int):
        if n_win < k:
            return torch.zeros_like(c), False
        return div(seq_sum(vol_ring[..., :min(k, r)]), max(k, 1)), True

    vol_ma_s, s_def = win_tail_mean(int(params.vol_short))
    vol_ma_l, l_def = win_tail_mean(int(params.vol_long))
    box_low, box_high, box_valid, regime, inside_count = _regime_update(
        params, price_now=c, box_low_w=box_low_w, box_high_w=box_high_w,
        vol_ma_s=vol_ma_s, s_def=s_def, vol_ma_l=vol_ma_l, l_def=l_def,
        n_win=n_win, box_low=st.box_low, box_high=st.box_high,
        box_valid=st.box_valid, regime=st.regime, inside_count=st.inside_count)
    return LeanGuardState(run_low=run_low, run_high=run_high, box_low=box_low,
                          box_high=box_high, box_valid=box_valid, regime=regime,
                          inside_count=inside_count)


def guard_allow_trade(regime, side) -> torch.Tensor:
    """allow_trade (:1345-1356): no short after a breakout up, no long after
    a breakout down."""
    side = torch.as_tensor(side)
    blocked = (((regime == G.REGIME_BREAKOUT_UP) & (side == SIDE_SHORT))
               | ((regime == G.REGIME_BREAKOUT_DOWN) & (side == SIDE_LONG)))
    return ~blocked


# --------------------------------------------------------------------------
# touch memory (LevelTouchMemory, qmmx_monolithic.py:1112-1239)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RegularTouchState:
    """[P, ...] LevelTouchMemory; per-edge tap stacks newest-first, shifted
    only when a tap fires (empty slots hold TAP_NEVER)."""

    count: torch.Tensor      # i32[P, L, 2]
    last_ts: torch.Tensor    # i32[P, L, 2]
    last_px: torch.Tensor    # f32[P, L, 2]
    has_last: torch.Tensor   # bool[P, L, 2]
    tap_ts: torch.Tensor     # i32[P, 2, TAP_STACK]
    tap_ratio: torch.Tensor  # f32[P, 2, TAP_STACK]

    @classmethod
    def zeros(cls, p: int, max_levels: int, device=None) -> "RegularTouchState":
        shape = (p, max_levels, 2)
        return cls(count=torch.zeros(shape, dtype=_I32, device=device),
                   last_ts=torch.zeros(shape, dtype=_I32, device=device),
                   last_px=torch.zeros(shape, dtype=_F32, device=device),
                   has_last=torch.zeros(shape, dtype=torch.bool, device=device),
                   tap_ts=torch.full((p, 2, TAP_STACK), TAP_NEVER, dtype=_I32,
                                     device=device),
                   tap_ratio=torch.zeros((p, 2, TAP_STACK), dtype=_F32,
                                         device=device))

    def reset_box(self, do_reset) -> "RegularTouchState":
        """reset_box (:1154-1156) where ``do_reset`` [P] holds."""
        m = torch.as_tensor(do_reset)[:, None, None]
        return RegularTouchState(
            count=torch.where(m, 0, self.count),
            last_ts=torch.where(m, 0, self.last_ts),
            last_px=torch.where(m, 0.0, self.last_px),
            has_last=self.has_last & ~m,
            tap_ts=torch.where(m, TAP_NEVER, self.tap_ts),
            tap_ratio=torch.where(m, 0.0, self.tap_ratio))


def touch_register(st: RegularTouchState, params: T.TouchMemoryParams,
                   levels: Levels, *, ts_ms: int, high, low, close, box_low,
                   box_high, box_valid, vol_ma_s, vol_ma_l,
                   enabled) -> RegularTouchState:
    """register_touch_if_any on one finished bar (:1158-1197).  A level is
    near when the bar pierces its cent-rounded price or the close lies within
    ``tol_bps`` of it; only the side the close is on (short iff close >
    level) can count, de-duplicated by time and price against that side's
    last touch.  Edge taps push the minute-close volume ratio."""
    c = torch.as_tensor(close, dtype=_F32)[:, None]
    h = torch.as_tensor(high, dtype=_F32)[:, None]
    l = torch.as_tensor(low, dtype=_F32)[:, None]
    en = torch.as_tensor(enabled)
    lr = div(torch.round(levels.price * 100.0), 100.0)   # half to even, as jnp.round
    lr = torch.where(levels.valid, lr, _INF)[None, :]
    pierced = (l - 1e-9 <= lr) & (lr <= h + 1e-9)
    bps_c = torch.where(lr <= 0, 0.0, (c - lr).abs() / lr * 1e4)
    near = (pierced | (bps_c <= params.tol_bps)) & levels.valid[None, :]

    side_short = c > lr                                       # [P, L]
    ts_a = torch.where(side_short, st.last_ts[..., 1], st.last_ts[..., 0])
    px_a = torch.where(side_short, st.last_px[..., 1], st.last_px[..., 0])
    has_a = torch.where(side_short, st.has_last[..., 1], st.has_last[..., 0])
    hit_a = near & en[:, None]
    too_soon = has_a & ((int(ts_ms) - ts_a) < params.min_time_gap_ms)
    bps_last = torch.where(px_a <= 0, 0.0, (c - px_a).abs() / px_a * 1e4)
    too_close = has_a & (bps_last < params.min_price_gap_bps)
    counted_a = hit_a & ~(too_soon | too_close)
    counted = counted_a[..., None] & torch.stack([~side_short, side_short], dim=-1)

    at_top = torch.as_tensor(box_valid) & (h[:, 0] >= box_high - 1e-9) & en
    at_bot = torch.as_tensor(box_valid) & (l[:, 0] <= box_low + 1e-9) & en
    ratio_ok = (vol_ma_s != 0.0) & (vol_ma_l != 0.0) & (vol_ma_l > 0)
    ratio = torch.where(ratio_ok, vol_ma_s / torch.clamp(vol_ma_l, min=1e-30), 1.0)
    do_edge = torch.stack([at_top, at_bot], dim=-1)[..., None]   # [P, 2, 1]
    new_ts = torch.full(do_edge.shape[:2], int(ts_ms), dtype=_I32, device=c.device)
    new_ratio = ratio[:, None].expand(do_edge.shape[:2])
    return RegularTouchState(
        count=st.count + counted.to(_I32),
        last_ts=torch.where(counted, int(ts_ms), st.last_ts),
        last_px=torch.where(counted, c[..., None], st.last_px),
        has_last=st.has_last | counted,
        tap_ts=torch.where(do_edge, ring_push(st.tap_ts, new_ts), st.tap_ts),
        tap_ratio=torch.where(do_edge, ring_push(st.tap_ratio, new_ratio),
                              st.tap_ratio))


def edge_fatigued(st: RegularTouchState, params: T.TouchMemoryParams,
                  now_ms: int) -> torch.Tensor:
    """edge_fatigued (:1199-1220) -> i32[P] of EDGE_TOP / EDGE_BOT / EDGE_NONE:
    the ``fatigue_hits``-th newest tap lies in the window and the mean ratio
    of the newest ``fatigue_hits`` taps reaches ``fatigue_vol_k``."""
    ks = int(params.fatigue_hits)
    kth_in = st.tap_ts[:, :, ks - 1] >= int(now_ms) - params.fatigue_window_ms
    ssum = st.tap_ratio[:, :, 0]
    for j in range(1, ks):
        ssum = ssum + st.tap_ratio[:, :, j]
    fatigued = kth_in & (div(ssum, max(ks, 1)) >= params.fatigue_vol_k)
    return torch.where(fatigued[:, 0], T.EDGE_TOP,
                       torch.where(fatigued[:, 1], T.EDGE_BOT, T.EDGE_NONE)).to(_I32)


def touch_allow(st: RegularTouchState, params: T.TouchMemoryParams, level_idx,
                side, now_ms: int):
    """allow_trade_at (:1222-1239) at (level_idx, side) per path: (allowed,
    budget_blocked, decay multiplier).  Blocked when the side's count reached
    ``max_bounces`` or its last touch is younger than ``min_time_gap_ms``."""
    short = torch.as_tensor(side)[:, None] == T.TM_SHORT
    idx = torch.as_tensor(level_idx).long()[:, None]

    def pick(x):
        return torch.where(short, x[..., 1], x[..., 0]).gather(1, idx)[:, 0]

    cnt, last_ts, has = pick(st.count), pick(st.last_ts), pick(st.has_last)
    budget_blocked = cnt >= params.max_bounces
    cooldown_blocked = has & ((int(now_ms) - last_ts) < params.min_time_gap_ms)
    allowed = ~(budget_blocked | cooldown_blocked)
    mult = torch.where(allowed, decay_pow(params.decay, cnt), 1.0)
    return allowed, budget_blocked, mult
