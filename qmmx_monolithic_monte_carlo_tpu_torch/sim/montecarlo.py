"""Monte Carlo execution-noise knobs.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/sim/montecarlo.py:38-62``
(``McNoise`` only): the reference MC's per-trade gaussian perturbations —
level jitter, entry slip, stop slip, target slip — as standard deviations.
The recorded-bar Monte Carlo of that module is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class McNoise:
    entry_slip_std: torch.Tensor
    level_jitter_std: torch.Tensor
    stop_slip_std: torch.Tensor
    target_slip_std: torch.Tensor

    @classmethod
    def default(cls) -> "McNoise":
        """The reference MC's defaults."""
        return cls.make()

    @classmethod
    def make(cls, entry_slip_std=0.01, level_jitter_std=0.02,
             stop_slip_std=0.0, target_slip_std=0.0) -> "McNoise":
        def f32(x):
            return torch.tensor(float(x), dtype=torch.float32)

        return cls(entry_slip_std=f32(entry_slip_std),
                   level_jitter_std=f32(level_jitter_std),
                   stop_slip_std=f32(stop_slip_std),
                   target_slip_std=f32(target_slip_std))

    @classmethod
    def from_numpy(cls, d: dict) -> "McNoise":
        """From a dict of numpy arrays, e.g. the fields of the JAX ``McNoise``."""
        return cls(**{f.name: torch.as_tensor(np.array(d[f.name]),
                                              dtype=torch.float32)
                      for f in dataclasses.fields(cls)})
