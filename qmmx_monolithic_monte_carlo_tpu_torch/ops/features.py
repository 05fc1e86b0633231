"""Batched level-proximity featurizer (the nearest-level part).

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/ops/features.py:32-77``.
The policy and volume features come with the engine slice.
"""

from __future__ import annotations

import torch

from ..types import Levels

_INF = float("inf")


def nearest_level(levels: Levels, price) -> tuple[torch.Tensor, torch.Tensor]:
    """Index and |distance| of the nearest valid level.

    An unrolled running minimum over the (small) level axis; strict ``<``
    keeps the first minimum, matching Python ``min`` tie-breaks over the
    (color, type, index)-ordered slots."""
    best_i, best_d, _, _ = nearest_level_full(levels, price)
    return best_i, best_d


def nearest_level_full(levels: Levels, price):
    """``nearest_level`` that also selects the winner's price and kind in the
    same running minimum.  Returns (idx i32, dist f32, level_price f32,
    level_kind i32); price 0.0 where no level is valid."""
    price = torch.as_tensor(price, dtype=torch.float32)
    best_d = torch.full(price.shape, _INF, dtype=torch.float32, device=price.device)
    best_i = torch.zeros(price.shape, dtype=torch.int32, device=price.device)
    best_px = torch.zeros(price.shape, dtype=torch.float32, device=price.device)
    best_k = torch.zeros(price.shape, dtype=torch.int32, device=price.device)
    for i in range(levels.max_levels):
        valid = levels.valid[..., i]
        lp = levels.price[..., i]
        d = torch.where(valid, (price - lp).abs(), _INF)
        better = d < best_d
        best_d = torch.where(better, d, best_d)
        best_i = torch.where(better, i, best_i)
        best_px = torch.where(better, torch.where(valid, lp, 0.0), best_px)
        best_k = torch.where(better, levels.kind[..., i], best_k)
    return best_i, best_d, best_px, best_k
