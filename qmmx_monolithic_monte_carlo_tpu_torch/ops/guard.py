"""AccumulationBreakoutGuard: regime codes and parameters.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/ops/guard.py:21-66`` (the
reference class, qmmx_monolithic.py:1241-1356).  The bar-synchronous state
machine the generated-path engine runs lives in ``ops/regular.py``; the
tick-scale ring-buffer form waits for the slice that ports the hosts.
"""

from __future__ import annotations

import dataclasses

import torch

from ..types import TensorRecord

REGIME_UNKNOWN = 0
REGIME_ACCUMULATION = 1
REGIME_BREAKOUT_UP = 2
REGIME_BREAKOUT_DOWN = 3

_I32, _F32 = torch.int32, torch.float32


@dataclasses.dataclass
class GuardParams(TensorRecord):
    box_lookback_ms: torch.Tensor     # 60 min (:1247)
    min_bars: torch.Tensor            # 30 (:1248)
    compression_bp: torch.Tensor      # 18 (:1249)
    vol_short: torch.Tensor           # 5 (:1250)
    vol_long: torch.Tensor            # 20 (:1250)
    vol_k: torch.Tensor               # 1.40 (:1251)
    reenter_clear_bars: torch.Tensor  # 3 (:1252)

    _DTYPES = {"box_lookback_ms": _I32, "min_bars": _I32, "compression_bp": _F32,
               "vol_short": _I32, "vol_long": _I32, "vol_k": _F32,
               "reenter_clear_bars": _I32}

    @classmethod
    def default(cls) -> "GuardParams":
        return cls.from_numpy(dict(box_lookback_ms=60 * 60_000, min_bars=30,
                                   compression_bp=18.0, vol_short=5, vol_long=20,
                                   vol_k=1.40, reenter_clear_bars=3))
