"""ExitStrategy's target escalation, batched.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/engine/exits.py:22-174``
(the reference ``ExitStrategy``, qmmx_monolithic.py:703-1110), in the form
the generated-path engine runs: ``should_escalate_on_target`` on a full
window of the ``VOL_LOOKBACK`` newest finished bars.  When the predicted
level behaviour (reversal on falling volume into the level, continuation on
rising volume) favours continuation and does not go against the position, the
target rolls to the next level beyond the anchor and the stop trails to
max(entry, anchor - 0.35) for a long (mirrored for a short), rounded to
cents.  ``should_exit`` and the masked-window forms wait for the tick engine.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import features as F
from ..types import SIDE_LONG, Levels
from ..utils.floats import div

# ExitStrategy defaults (:704-718)
PROXIMITY_WINDOW = 0.35
CONFLUENCE_WINDOW = 0.6
VOL_LOOKBACK = 5
MIN_BARS_FOR_TREND = 3

BASIS_NONE = 0
BASIS_REVERSAL = 1
BASIS_CONTINUATION = 2

_F32 = torch.float32


def next_level_target(levels: Levels, ref_price, side):
    """``_next_level_target`` (:1038-1049): (price, found) of the next valid
    level strictly beyond ``ref_price`` in the trade's direction."""
    ref = torch.as_tensor(ref_price, dtype=_F32)
    is_long = torch.as_tensor(side, device=ref.device) == SIDE_LONG
    higher = levels.valid & (levels.price > ref[..., None] + 1e-9)
    lower = levels.valid & (levels.price < ref[..., None] - 1e-9)
    up_px = torch.where(higher, levels.price, float("inf")).amin(dim=-1)
    dn_px = torch.where(lower, levels.price, float("-inf")).amax(dim=-1)
    found = torch.where(is_long, higher.any(dim=-1), lower.any(dim=-1))
    return torch.where(is_long, up_px, dn_px), found


class Escalation(NamedTuple):
    escalate: torch.Tensor     # bool
    next_target: torch.Tensor  # f32
    trail_stop: torch.Tensor   # f32
    basis: torch.Tensor        # i32 BASIS_*


def should_escalate_on_target(*, side, entry, current_price, levels: Levels,
                              bar_prices, bar_volumes,
                              proximity_window: float = PROXIMITY_WINDOW) -> Escalation:
    """``should_escalate_on_target`` (:897-960) with ``should_exit``'s hold
    decision (:754-895) inlined, in the JAX form's ``full_window=True`` case:
    ``bar_prices`` / ``bar_volumes`` are the VOL_LOOKBACK newest finished
    bars, all valid, oldest -> newest."""
    price = torch.as_tensor(current_price, dtype=_F32)
    _, dist, level_price, _ = F.nearest_level_full(levels, price)
    has_levels = levels.count > 0           # a tensor: nothing waits on the device
    near = dist <= proximity_window
    inferred = F.infer_approach_full_window(bar_prices, level_price)
    fallback = torch.where(price > level_price, 0, 1)
    approach_below = torch.where(inferred >= 0, inferred, fallback) == 1
    vol_trend = F.volume_trend_full_window(bar_prices, bar_volumes, level_price,
                                           min_bars_for_trend=MIN_BARS_FOR_TREND)
    reversal = vol_trend < 0
    is_long = torch.as_tensor(side, device=price.device) == SIDE_LONG
    # a reversal bounces down when coming from below, a continuation goes on
    # down when coming from above: either is against a long when it points down
    move_down = torch.where(reversal, approach_below, ~approach_below)
    against = torch.where(is_long, move_down, ~move_down)
    level_valid = near & has_levels
    do_exit = level_valid & against
    basis = torch.where(level_valid, torch.where(reversal, BASIS_REVERSAL,
                                                 BASIS_CONTINUATION), BASIS_NONE)
    anchor = torch.where(level_valid, level_price, price)
    nxt, found = next_level_target(levels, anchor, side)
    entry = torch.as_tensor(entry, dtype=_F32)
    trail = torch.where(is_long, torch.maximum(entry, anchor - proximity_window),
                        torch.minimum(entry, anchor + proximity_window))
    trail = div(torch.round(trail * 100.0), 100.0)   # cents (:952), half to even
    go = ~do_exit & (basis == BASIS_CONTINUATION) & found
    return Escalation(escalate=go, next_target=nxt, trail_stop=trail,
                      basis=basis.to(torch.int32))
