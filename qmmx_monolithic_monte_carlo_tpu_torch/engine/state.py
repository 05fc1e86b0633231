"""The engine's optional linear ML gate model.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/engine/state.py:173-220``
(``MlModel``, the reference's ``engine.model``, :1400-1407, served by
``_ml_allowed`` :1454-1466).  ``n_features`` tells the fixed 4-feature model
from the reference's skewed 3-feature artifact, which disables the gate
(quirk Q5).  The tick engine's carry (``EngineCarry`` and its parts) waits
for the slice that ports the hosts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..types import TensorRecord


@dataclasses.dataclass
class MlModel(TensorRecord):
    coef: torch.Tensor        # f32[4]
    intercept: torch.Tensor   # f32
    n_features: torch.Tensor  # i32 (3 = reference-skewed, 4 = fixed)
    present: torch.Tensor     # bool

    _DTYPES = {"coef": torch.float32, "intercept": torch.float32,
               "n_features": torch.int32, "present": torch.bool}

    @classmethod
    def absent(cls) -> "MlModel":
        return cls.from_numpy(dict(coef=np.zeros(4, np.float32), intercept=0.0,
                                   n_features=4, present=False))

    @classmethod
    def from_weights(cls, coef, intercept, n_features: int = 4) -> "MlModel":
        c = np.asarray(coef, np.float32).reshape(-1)[:4]
        pad = np.zeros(4, np.float32)
        pad[:c.shape[0]] = c
        return cls.from_numpy(dict(coef=pad, intercept=np.float32(intercept),
                                   n_features=n_features, present=True))

    @property
    def usable(self) -> bool:
        return bool(self.present) and int(self.n_features) == 4
