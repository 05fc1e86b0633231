"""LevelTouchMemory: side and edge codes and parameters.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/ops/touch.py:34-127`` (the
reference class, qmmx_monolithic.py:1112-1239).  The bar-synchronous touch
state the generated-path engine runs lives in ``ops/regular.py``; the
tick-scale contact latch and ring forms wait for the slice that ports the
hosts.
"""

from __future__ import annotations

import dataclasses

import torch

from ..types import TensorRecord

# sides for LevelTouchMemory arrays
TM_LONG = 0
TM_SHORT = 1

EDGE_NONE = 0
EDGE_TOP = 1
EDGE_BOT = 2

_I32, _F32 = torch.int32, torch.float32


@dataclasses.dataclass
class TouchMemoryParams(TensorRecord):
    tol_bps: torch.Tensor            # 8.0 (:1122)
    min_time_gap_ms: torch.Tensor    # 180_000 (:1123)
    min_price_gap_bps: torch.Tensor  # 4.0 (:1124)
    decay: torch.Tensor              # 0.85 (:1125)
    max_bounces: torch.Tensor        # 2 (:1126)
    fatigue_hits: torch.Tensor       # 3 (:1127)
    fatigue_window_ms: torch.Tensor  # 30*60_000 (:1128)
    fatigue_vol_k: torch.Tensor      # 1.20 (:1129)

    _DTYPES = {"tol_bps": _F32, "min_time_gap_ms": _I32, "min_price_gap_bps": _F32,
               "decay": _F32, "max_bounces": _I32, "fatigue_hits": _I32,
               "fatigue_window_ms": _I32, "fatigue_vol_k": _F32}

    @classmethod
    def default(cls) -> "TouchMemoryParams":
        return cls.from_numpy(dict(tol_bps=8.0, min_time_gap_ms=180_000,
                                   min_price_gap_bps=4.0, decay=0.85,
                                   max_bounces=2, fatigue_hits=3,
                                   fatigue_window_ms=30 * 60_000,
                                   fatigue_vol_k=1.20))
