"""The one-factor book: correlated shocks and the book's equity curve.

Counterpart of the arithmetic ``qmmx_monolithic_monte_carlo_tpu/parallel/
portfolio.py`` runs per block (``:284-343``, ``:503-565``) and its fused
kernels run per path (``ops/pallas_mc.py:1280-1284``, ``:1418-1426``,
``:2546-2561``):

* ``mix_shocks`` -- symbol s's shock ``z_s = beta_s * z_mkt + sqrt(1 -
  beta_s^2) * eps_s`` from the shared market normal and its own;
* ``BookCurve`` -- per path, the weighted post-bar equity curves of the
  symbols summed in symbol order, with the book's trades, wins, losses and
  open-at-end; ``outcome`` folds the curve into the book's final R and its
  drawdown tracked over time (the peak starts at 0).

Float32 in the JAX pipeline's order under ``jit``: XLA's CPU compiler fuses
``1 - beta * beta``, ``beta * z_mkt + (perp * eps)`` and ``curve + w *
equity`` into fused multiply-adds, so these are ``utils/floats.fma`` here and
``fmaf`` in the CUDA kernels.  With beta = 0 the shock is ``eps`` exactly,
so a book symbol is the universe's symbol bit for bit.
"""

from __future__ import annotations

import torch

from ..utils.floats import fma
from .gatedpath import LifecycleOutcome

_F32 = torch.float32
_I32 = torch.int32


def perp_of(beta) -> torch.Tensor:
    """sqrt(max(0, 1 - beta^2)) in float32, the product fused into the
    difference as the JAX book computes it."""
    b = torch.as_tensor(beta, dtype=_F32)
    return torch.sqrt(torch.clamp(fma(-b, b, 1.0), min=0.0))


def mix_shocks(beta, z_mkt: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """float32 ``beta * z_mkt + perp * eps`` with ``beta * z_mkt`` fused
    into the sum (one rounding), ``perp = perp_of(beta)``."""
    b = torch.as_tensor(beta, dtype=_F32, device=eps.device)
    return fma(b, z_mkt, perp_of(b) * eps)


class BookCurve:
    """The book of ``n`` paths over ``num_bars`` bars, filled symbol by
    symbol: ``add_bar`` after each of a symbol's bars, ``add_symbol`` after
    its last."""

    def __init__(self, n: int, num_bars: int, device=None):
        self.curve = torch.zeros((num_bars, n), dtype=_F32, device=device)
        zi = torch.zeros((n,), dtype=_I32, device=device)
        self.trades = self.wins = self.losses = zi
        self.open_any = torch.zeros((n,), dtype=torch.bool, device=device)

    def add_bar(self, t: int, weight, equity: torch.Tensor) -> None:
        w = torch.as_tensor(weight, dtype=_F32, device=equity.device)
        self.curve[t] = fma(w, equity, self.curve[t])

    def add_curve(self, weight, curve: torch.Tensor) -> None:
        """A symbol's whole post-bar equity curve f32[W, n]."""
        w = torch.as_tensor(weight, dtype=_F32, device=curve.device)
        self.curve = fma(w, curve, self.curve)

    def add_symbol(self, out) -> None:
        """A symbol's lifecycle outcome (trades, wins, losses, open_at_end)."""
        self.trades = self.trades + out.trades.to(_I32)
        self.wins = self.wins + out.wins.to(_I32)
        self.losses = self.losses + out.losses.to(_I32)
        self.open_any = self.open_any | out.open_at_end

    def outcome(self) -> LifecycleOutcome:
        """The book per path: the final R of the combined curve, the book's
        trade totals, open on any symbol, and the drawdown peak-tracked over
        time on the curve with the peak starting at 0."""
        peak = torch.cummax(torch.clamp(self.curve, min=0.0), dim=0).values
        dd = (peak - self.curve).amax(dim=0)
        return LifecycleOutcome(equity=self.curve[-1], trades=self.trades, wins=self.wins,
                                losses=self.losses, open_at_end=self.open_any, max_dd=dd)
