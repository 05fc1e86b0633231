"""OnlinePolicy: the two-head online logistic model's entry gate.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/models/online_policy.py:28-149``
(the reference ``OnlinePolicy``, qmmx_monolithic.py:274-379): the entry head
over (go_long, go_short, skip) and the exit head, one weight vector per
action; a score is the sigmoid of w . x with the logit hard-clamped at +-50
(:20-26); the app-level gate (:3083-3085) passes when the chosen side scores
>= 0.60 and skip < 0.55.  The SGD / perceptron training updates wait for
the slice that ports the flywheel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.features import POLICY_FEATURE_DIM
from ..types import TensorRecord

ENTRY_ACTIONS = ("go_long", "go_short", "skip")
EXIT_ACTIONS = ("exit_now", "hold")
A_GO_LONG, A_GO_SHORT, A_SKIP = 0, 1, 2

_F32 = torch.float32


@dataclasses.dataclass
class PolicyParams(TensorRecord):
    w_entry: torch.Tensor         # f32[3, D]
    w_exit: torch.Tensor          # f32[2, D]
    lr: torch.Tensor              # f32
    l2: torch.Tensor              # f32
    use_perceptron: torch.Tensor  # bool

    _DTYPES = {"w_entry": _F32, "w_exit": _F32, "lr": _F32, "l2": _F32,
               "use_perceptron": torch.bool}

    @classmethod
    def init(cls, lr: float = 0.03, l2: float = 1e-6, use_perceptron: bool = False,
             dim: int = POLICY_FEATURE_DIM) -> "PolicyParams":
        return cls.from_numpy(dict(
            w_entry=np.zeros((len(ENTRY_ACTIONS), dim), np.float32),
            w_exit=np.zeros((len(EXIT_ACTIONS), dim), np.float32),
            lr=lr, l2=l2, use_perceptron=use_perceptron))


def sigmoid_clamped(z: torch.Tensor) -> torch.Tensor:
    """Reference ``_sigmoid`` (:20-26): exactly 0 / 1 outside +-50."""
    return torch.where(z < -50.0, 0.0, torch.where(z > 50.0, 1.0, torch.sigmoid(z)))


def score_entry(params: PolicyParams, x) -> torch.Tensor:
    """Per-action probabilities sigmoid_clamped(w . x), f32[..., 3] ordered as
    ENTRY_ACTIONS.  The products are added in feature order, one rounding
    each: the CUDA kernel's order.  (XLA computes the JAX einsum as a matrix
    product whose order is its own, so the two can differ in the last place.)"""
    x = torch.as_tensor(x, dtype=_F32)
    w = params.w_entry.to(x.device)
    out = []
    for a in range(w.shape[0]):
        z = w[a, 0] * x[..., 0]
        for d in range(1, w.shape[1]):
            z = z + w[a, d] * x[..., d]
        out.append(z)
    return sigmoid_clamped(torch.stack(out, dim=-1))


def entry_gate(params: PolicyParams, x, side_is_long, min_go: float = 0.60,
               max_skip: float = 0.55) -> torch.Tensor:
    """Chosen-action score >= 0.60 and skip score < 0.55 (:3083-3085)."""
    s = score_entry(params, x)
    chosen = torch.where(torch.as_tensor(side_is_long, device=s.device),
                         s[..., A_GO_LONG], s[..., A_GO_SHORT])
    return (chosen >= min_go) & (s[..., A_SKIP] < max_skip)
