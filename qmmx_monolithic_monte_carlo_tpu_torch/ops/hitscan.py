"""First-hit stop/target scan primitives.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/ops/hitscan.py:30-156``: the
reference walks bars forward to find which of stop/target is hit first; here
that is a first-True-index over the bar axis.

* a *long* stop at ``s`` is hit at the first bar ``j`` with ``low[j] <= s``;
* a *long* target at ``t`` at the first ``j`` with ``high[j] >= t``; shorts mirror.

The index functions return ``N`` (one past the end) when never hit.
"""

from __future__ import annotations

import torch

from ..types import OUTCOME_OPEN, OUTCOME_STOP, OUTCOME_TP


def _first_true(hit: torch.Tensor, start_mask) -> torch.Tensor:
    if start_mask is not None:
        hit = hit & start_mask
    n = hit.shape[-1]
    idx = torch.argmax(hit.to(torch.uint8), dim=-1)
    return torch.where(hit.any(dim=-1), idx, n)


def first_index_leq(series, threshold, start_mask=None) -> torch.Tensor:
    """First index j with series[j] <= threshold (N if none).  ``start_mask``
    masks out bars before the entry bar (False = excluded)."""
    series = torch.as_tensor(series, dtype=torch.float32)
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=series.device)
    return _first_true(series <= thr[..., None], start_mask)


def first_index_geq(series, threshold, start_mask=None) -> torch.Tensor:
    """First index j with series[j] >= threshold (N if none)."""
    series = torch.as_tensor(series, dtype=torch.float32)
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=series.device)
    return _first_true(series >= thr[..., None], start_mask)


def running_min(series: torch.Tensor) -> torch.Tensor:
    return torch.cummin(series, dim=-1).values


def running_max(series: torch.Tensor) -> torch.Tensor:
    return torch.cummax(series, dim=-1).values


def stop_target_outcome(*, highs, lows, side, entry, stop, target, tie_uniform,
                        valid_mask=None, side_aware_tie: bool = False):
    """Vectorised reference ``walk_outcome``.

    stop_hit = low <= stop (long) / high >= stop (short); target_hit = high >=
    target (long) / low <= target (short), first index each; a same-bar tie is
    a coin flip with p(target first) = up_span / (up_span + down_span + 1e-9),
    up_span = max(0, high_j - entry), down_span = max(0, entry - low_j).

    The reference applies the *up* share as p(target first) for BOTH sides,
    which favours the stop for shorts.  The default reproduces that;
    ``side_aware_tie=True`` selects the down share for shorts.

    Returns (R, outcome): R = reward/risk on tp, -1 on stop, 0 open, with
    risk = max(|entry - stop|, 1e-9) and reward = |target - entry|; outcome
    codes are types.OUTCOME_{OPEN,TP,STOP}."""
    highs = torch.as_tensor(highs, dtype=torch.float32)
    lows = torch.as_tensor(lows, dtype=torch.float32)
    dev = highs.device
    is_long = torch.as_tensor(side, device=dev) > 0
    entry = torch.as_tensor(entry, dtype=torch.float32, device=dev)
    stop = torch.as_tensor(stop, dtype=torch.float32, device=dev)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)

    stop_series = torch.where(is_long[..., None], lows, -highs)
    stop_thr = torch.where(is_long, stop, -stop)
    tgt_series = torch.where(is_long[..., None], -highs, lows)
    tgt_thr = torch.where(is_long, -target, target)

    j_stop = first_index_leq(stop_series, stop_thr, valid_mask)
    j_tgt = first_index_leq(tgt_series, tgt_thr, valid_mask)

    n = highs.shape[-1]
    none_hit = (j_stop >= n) & (j_tgt >= n)
    tie = (j_stop == j_tgt) & ~none_hit

    jj = torch.clamp(torch.minimum(j_stop, j_tgt), 0, n - 1)[..., None]
    hh = torch.take_along_dim(highs, jj, dim=-1)[..., 0]
    ll = torch.take_along_dim(lows, jj, dim=-1)[..., 0]
    up_span = torch.clamp(hh - entry, min=0.0)
    down_span = torch.clamp(entry - ll, min=0.0)
    p_target_first = up_span / (up_span + down_span + 1e-9)
    if side_aware_tie:
        p_target_first = torch.where(is_long, p_target_first, 1.0 - p_target_first)
    coin_target = torch.as_tensor(tie_uniform, dtype=torch.float32,
                                  device=dev) < p_target_first

    target_first = torch.where(tie, coin_target, j_tgt < j_stop)
    risk = torch.clamp((entry - stop).abs(), min=1e-9)
    reward = (target - entry).abs()
    r = torch.where(none_hit, 0.0, torch.where(target_first, reward / risk, -1.0))
    outcome = torch.where(
        none_hit, OUTCOME_OPEN,
        torch.where(target_first, OUTCOME_TP, OUTCOME_STOP)).to(torch.int32)
    return r.to(torch.float32), outcome
