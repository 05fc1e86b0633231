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
    float32 exactly, so one float64 add and one rounding to float32 give the
    fused result (but for a double rounding, about once in 2^29)."""
    x, y, z = (torch.as_tensor(a) for a in (x, y, z))
    return (x.double() * y.double() + z.double()).float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded once: taken in float64 and rounded to
    float32 (53 bits hold enough for the double rounding to be exact)."""
    return torch.sqrt(x.double()).float()


def div(x: torch.Tensor, d) -> torch.Tensor:
    """float32 ``x / d`` for a scalar ``d``, rounded once: the divisor goes to
    ``x``'s device, where it is no CPU scalar for the reciprocal rewrite."""
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)
