"""Handcrafted rule confidence and the soft volume veto, as batched ops.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/ops/confidence.py:16-83``:
``compute_confidence`` (the reference's MonolithicEngine.compute_confidence,
qmmx_monolithic.py:1415-1427) and ``soft_veto`` (``_soft_veto``, :1773-1794).
"""

from __future__ import annotations

import torch

from ..reasons import Reason
from ..types import DIR_UNKNOWN, KIND_SOLID, SIDE_LONG

_F32 = torch.float32


def compute_confidence(*, level_price, level_kind, price, direction,
                       touch_count, contact_prox) -> torch.Tensor:
    """conf = clamp01( max(0, 1 - dist/max(1e-4, PROX))
                       + (0.08 solid | 0.02 dashed)
                       + (0.10 if touches<=1 | -0.08 if ==2 | -0.16 if >=3)
                       + 0.03 if direction known )

    float32 throughout, in the JAX package's order of operations, so the
    same inputs give the same bits."""
    price = torch.as_tensor(price, dtype=_F32)
    dev = price.device
    dist = (price - torch.as_tensor(level_price, dtype=_F32, device=dev)).abs()
    prox = torch.clamp(torch.as_tensor(contact_prox, dtype=_F32, device=dev),
                       min=1e-4)
    base = torch.clamp(1.0 - dist / prox, min=0.0)
    kind = torch.as_tensor(level_kind, device=dev)
    base = base + torch.where(kind == KIND_SOLID, 0.08, 0.02)
    tc = torch.as_tensor(touch_count, device=dev)
    base = base + torch.where(tc <= 1, 0.10, torch.where(tc == 2, -0.08, -0.16))
    direction = torch.as_tensor(direction, device=dev)
    base = base + torch.where(direction != DIR_UNKNOWN, 0.03, 0.0)
    return torch.clamp(base, 0.0, 1.0)


def soft_veto(*, side, volume_slope, approach_from_below, confluence,
              proximity_abs, contact_prox, veto_vol_strong,
              veto_prox) -> tuple[torch.Tensor, torch.Tensor]:
    """(allowed, reason i32): CONTRA_VOL_LONG / CONTRA_VOL_SHORT when vetoed,
    OK otherwise.  Weak evidence (|slope| < 0.05 without confluence) never
    vetoes; ``near`` is within max(VETO_PROX, CONTACT_PROX * 0.12).  Coming
    up from below, a long is vetoed on strongly falling volume and a short on
    strongly rising volume; from above, mirrored."""
    slope = torch.as_tensor(volume_slope, dtype=_F32)
    dev = slope.device
    weak = (slope.abs() < 0.05) & ~torch.as_tensor(confluence, device=dev)
    strong = torch.as_tensor(veto_vol_strong, dtype=_F32)
    slight = torch.as_tensor(contact_prox, dtype=_F32) * 0.12
    near = torch.as_tensor(proximity_abs, dtype=_F32, device=dev) <= torch.maximum(
        torch.as_tensor(veto_prox, dtype=_F32), slight)
    is_long = torch.as_tensor(side, device=dev) == SIDE_LONG
    below = torch.as_tensor(approach_from_below, device=dev)
    contra_long = torch.where(below, slope < -strong, slope > strong)
    contra_short = torch.where(below, slope > strong, slope < -strong)
    veto_long = near & is_long & contra_long
    veto_short = near & ~is_long & contra_short
    vetoed = ~weak & (veto_long | veto_short)
    reason = torch.where(vetoed, torch.where(veto_long, int(Reason.CONTRA_VOL_LONG),
                                             int(Reason.CONTRA_VOL_SHORT)),
                         int(Reason.OK)).to(torch.int32)
    return ~vetoed, reason
