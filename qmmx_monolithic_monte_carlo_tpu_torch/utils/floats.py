"""Float32 arithmetic spelled out where a backend would round otherwise.

* ``fma``: under ``jit``, XLA's CPU compiler contracts ``a + b * c`` into one
  fused multiply-add wherever the product feeds an add directly.  The port
  builds its CUDA kernels with ``-fmad=false`` and writes ``fmaf`` only where
  the JAX replay contracts; its plain versions call ``fma`` there.
* ``sqrt``: PyTorch's vectorised CPU float32 square root is off by an ulp
  on about 0.7% of inputs; XLA's and CUDA's ``sqrtf`` round once.
* ``div``: PyTorch's CUDA division by a CPU scalar multiplies by the
  scalar's reciprocal (a second rounding); the plain versions divide by a
  scalar through ``div``, which keeps the IEEE division XLA and the CUDA
  kernels do, on either device.
"""

from __future__ import annotations

import torch


def fma(x, y, z) -> torch.Tensor:
    """float32 ``x * y + z`` rounded once.  float64 holds the product of two
    float32 exactly; the float64 sum is rounded to odd (its exact error by
    TwoSum: where the sum is inexact and its last bit even, the neighbour
    toward the exact value) and then to float32, which rounds the exact
    value once (round-to-odd with 53 >= 24 + 2 bits).  A plain float64 sum
    would round twice about once in 2^29 operations: on one path in ~10^5
    of a 390-bar Heston book."""
    x, y, z = (torch.as_tensor(a) for a in (x, y, z))
    p, zd = x.double() * y.double(), z.double()
    s = p + zd
    bb = s - p
    err = (p - (s - bb)) + (zd - bb)
    odd = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    return torch.where(odd, torch.nextafter(s, toward), s).float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded once: taken in float64 and rounded to
    float32 (53 bits hold enough for the double rounding to be exact)."""
    return torch.sqrt(x.double()).float()


def div(x: torch.Tensor, d) -> torch.Tensor:
    """float32 ``x / d`` for a scalar ``d``, rounded once: the divisor goes to
    ``x``'s device, where it is no CPU scalar for the reciprocal rewrite."""
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)
