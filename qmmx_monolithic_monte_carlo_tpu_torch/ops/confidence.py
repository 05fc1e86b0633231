"""Handcrafted rule confidence, as a batched op.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/ops/confidence.py:16-38``
(``compute_confidence``, the reference's MonolithicEngine.compute_confidence,
qmmx_monolithic.py:1415-1427).  The soft volume veto (``soft_veto``) needs
the reason codes and comes with the engine slice.
"""

from __future__ import annotations

import torch

from ..types import DIR_UNKNOWN, KIND_SOLID

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
