"""Batched level-proximity featurizer and volume features.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/ops/features.py:32-286``:
the nearest level, the confluence count, the OnlinePolicy feature vector,
the soft veto's volume slope and the full-window forms of the exit
strategy's volume trend and approach inference.  The general (masked-window)
``volume_trend_toward_level`` and ``infer_approach`` wait for the tick
engine.

Every float32 sum over a window is a serial sum in slot order
(``seq_sum``): XLA's CPU reduction over a short trailing axis adds in that
order, and the CUDA kernel's register loop does too, so the three agree bit
for bit (``torch.sum`` does not: it adds in vector lanes).
"""

from __future__ import annotations

import torch

from ..types import APPROACH_FROM_BELOW, Levels
from ..utils.floats import div

_INF = float("inf")
_F32 = torch.float32
POLICY_FEATURE_DIM = 7


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis, slot 0 first, one rounding per add."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def nearest_level(levels: Levels, price) -> tuple[torch.Tensor, torch.Tensor]:
    """Index and |distance| of the nearest valid level (the first slot of a
    tie, matching Python ``min`` over the (color, type, index)-ordered
    slots)."""
    best_i, best_d, _, _ = nearest_level_full(levels, price)
    return best_i, best_d


def nearest_level_full(levels: Levels, price):
    """``nearest_level`` that also selects the winner's price and kind.
    Returns (idx i32, dist f32, level_price f32, level_kind i32); price 0.0
    where no level is valid.  The distances of every slot at once, then
    their minimum, which takes the first slot of a tie (the reference's
    strict-``<`` running minimum over the (color, type, index)-ordered
    slots); a minimum is exact in any order."""
    price = torch.as_tensor(price, dtype=torch.float32)
    d = torch.where(levels.valid, (price[..., None] - levels.price).abs(), _INF)
    best_d, idx = d.min(dim=-1)
    found = best_d < _INF
    lp = torch.where(levels.valid, levels.price, 0.0).expand(d.shape)
    kind = levels.kind.expand(d.shape)
    best_px = torch.where(found, lp.gather(-1, idx[..., None])[..., 0], 0.0)
    best_k = torch.where(found, kind.gather(-1, idx[..., None])[..., 0], 0).to(torch.int32)
    best_i = torch.where(found, idx, 0).to(torch.int32)
    return best_i, best_d, best_px, best_k


def confluence_count(levels: Levels, anchor_price, within) -> torch.Tensor:
    """Number of valid levels within ``within`` of ``anchor_price``, the
    anchor level itself included (:1886).  i32[...]."""
    anchor = torch.as_tensor(anchor_price, dtype=_F32)
    near = (levels.price - anchor[..., None]).abs() <= within
    return (near & levels.valid).sum(dim=-1, dtype=torch.int32)


def has_confluence_near(levels: Levels, anchor_price, within=0.15) -> torch.Tensor:
    """Reference ``_has_confluence_near`` (:1885-1886): >= 2 levels within."""
    return confluence_count(levels, anchor_price, within) >= 2


def policy_features(*, proximity_abs, volume_trend, approach, confluence,
                    minutes_since_open) -> torch.Tensor:
    """OnlinePolicy.build_features (:308-331) -> f32[..., 7]:
    [1, min(1, prox), clip(vol_trend/1e6, +-1), 1[from_above], 1[from_below],
    1[confluence], min(1, minutes/390)]."""
    prox = torch.clamp(torch.as_tensor(proximity_abs, dtype=_F32), max=1.0)
    vt = torch.clamp(div(torch.as_tensor(volume_trend, dtype=_F32), 1e6), -1.0, 1.0)
    approach = torch.as_tensor(approach, device=prox.device)
    from_above = (approach != APPROACH_FROM_BELOW).to(_F32)
    from_below = (approach == APPROACH_FROM_BELOW).to(_F32)
    cf = torch.as_tensor(confluence, device=prox.device).to(_F32)
    tod = torch.clamp(div(torch.as_tensor(minutes_since_open, dtype=_F32,
                                          device=prox.device), 390.0), max=1.0)
    return torch.stack([torch.ones_like(prox), prox, vt, from_above, from_below,
                        cf, tod.expand_as(prox)], dim=-1)


def volume_slope(volumes: torch.Tensor, valid: torch.Tensor,
                 window: int = 6) -> torch.Tensor:
    """Reference ``_calc_volume_slope`` (:1796-1811) on a newest-last buffer
    with a contiguous valid tail: 0 with fewer than 3 valid bars; else over
    the last m = min(window, n) volumes, half = max(2, m // 2), v1 / v2 the
    means of the first / last ``half``, slope (v2 - v1) / (|v1| + 1e-9), 0
    when both are 0."""
    volumes = torch.as_tensor(volumes, dtype=_F32)
    valid = torch.as_tensor(valid, device=volumes.device)
    n = valid.to(torch.int32).sum(dim=-1)
    m = torch.clamp(n, max=window)
    half = torch.clamp(torch.div(m, 2, rounding_mode="floor"), min=2)
    rev = valid.flip(-1).to(torch.int32)
    pos_from_end = torch.cumsum(rev, dim=-1, dtype=torch.int32).flip(-1) - 1
    in_window = valid & (pos_from_end < m[..., None])
    idx_in_win = (m[..., None] - 1) - pos_from_end
    first = in_window & (idx_in_win < half[..., None])
    last = in_window & (idx_in_win >= (m - half)[..., None])
    hf = half.to(_F32)
    v1 = seq_sum(torch.where(first, volumes, 0.0)) / hf
    v2 = seq_sum(torch.where(last, volumes, 0.0)) / hf
    slope = (v2 - v1) / (v1.abs() + 1e-9)
    slope = torch.where((v1 == 0.0) & (v2 == 0.0), 0.0, slope)
    return torch.where(n < 3, 0.0, slope)


def _halves_slope(mask: torch.Tensor, volumes: torch.Tensor):
    """avg(last k) - avg(first k) of the masked subsequence, k = max(2, cnt // 2)."""
    mi = mask.to(torch.int32)
    cnt = mi.sum(dim=-1)
    k = torch.clamp(torch.div(cnt, 2, rounding_mode="floor"), min=2)
    order = torch.cumsum(mi, dim=-1, dtype=torch.int32) - 1
    first = mask & (order < k[..., None])
    last = mask & (order >= (cnt - k)[..., None])
    kf = k.to(_F32)
    return (seq_sum(torch.where(last, volumes, 0.0)) / kf
            - seq_sum(torch.where(first, volumes, 0.0)) / kf), cnt


def volume_trend_full_window(prices, volumes, level, *,
                             min_bars_for_trend: int = 3) -> torch.Tensor:
    """``_volume_trend_toward_level`` (:567-601) on a full window: exactly
    ``vol_lookback`` valid bars, oldest -> newest.  Keeps the volumes of bars
    whose distance to the level did not grow against the previous bar (the
    first bar always kept); fewer than ``min_bars_for_trend`` kept -> all."""
    prices = torch.as_tensor(prices, dtype=_F32)
    volumes = torch.as_tensor(volumes, dtype=_F32)
    level = torch.as_tensor(level, dtype=_F32)
    k_win = prices.shape[-1]
    dist = (prices - level[..., None]).abs()
    prev = torch.roll(dist, 1, dims=-1)
    is_first = torch.arange(k_win, device=prices.device) == 0
    toward = is_first | (dist <= prev)
    trend_f, cnt_f = _halves_slope(toward, volumes)
    iota = torch.arange(k_win, device=prices.device)
    trend_all = (seq_sum(torch.where(iota >= k_win - 2, volumes, 0.0)) / 2.0
                 - seq_sum(torch.where(iota < 2, volumes, 0.0)) / 2.0)
    return torch.where(cnt_f < min_bars_for_trend, trend_all, trend_f)


def infer_approach_full_window(prices, level) -> torch.Tensor:
    """``_infer_approach`` (:554-565) on a full oldest -> newest window: from
    the last two prices, a move toward the level is from above (0) when the
    older one lies above it, else from below (1); -1 when not toward."""
    prices = torch.as_tensor(prices, dtype=_F32)
    level = torch.as_tensor(level, dtype=_F32)
    p2, p1 = prices[..., -1], prices[..., -2]
    toward = (p2 - level).abs() < (p1 - level).abs()
    approach = torch.where(p1 > level, 0, 1)
    return torch.where(toward, approach, -1).to(torch.int32)
