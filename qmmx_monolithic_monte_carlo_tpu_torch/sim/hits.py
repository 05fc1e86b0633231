"""Intrabar stop/target hit with the same-bar distance-weighted tie coin.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/sim/hits.py:20-52``.  A bar
that touches both barriers resolves target-first iff
``tie < up_span / (up_span + down_span + 1e-9)``, spans measured from the
entry fill to the bar's extremes (qmmx_monolithic.py:3467-3480), the same
formula for both sides.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BarHit(NamedTuple):
    """Outcome of one bar against an open position's barriers (all [...P])."""

    stop_hit: torch.Tensor      # bool: stop barrier touched this bar
    tgt_hit: torch.Tensor       # bool: target barrier touched this bar
    hit: torch.Tensor           # bool: either barrier touched
    target_first: torch.Tensor  # bool: target resolves first (tie coin on both)


def bar_hit_outcome(*, is_open, is_long, entry, stop, target, high, low,
                    tie) -> BarHit:
    """First-hit logic for one OHLC bar; ``tie`` is the pre-drawn U(0,1) of
    this (path, bar)."""
    is_open = torch.as_tensor(is_open)
    is_long = torch.as_tensor(is_long)
    stop_hit = is_open & torch.where(is_long, low <= stop, high >= stop)
    tgt_hit = is_open & torch.where(is_long, high >= target, low <= target)
    both = stop_hit & tgt_hit
    up_span = torch.clamp(high - entry, min=0.0)
    dn_span = torch.clamp(entry - low, min=0.0)
    p_tp = up_span / (up_span + dn_span + 1e-9)
    target_first = torch.where(both, tie < p_tp, tgt_hit & ~stop_hit)
    return BarHit(stop_hit=stop_hit, tgt_hit=tgt_hit, hit=stop_hit | tgt_hit,
                  target_first=target_first)
