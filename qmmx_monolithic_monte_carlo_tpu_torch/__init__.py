"""qmmx_monolithic_monte_carlo_tpu_torch — the PyTorch/CUDA port of
``qmmx_monolithic_monte_carlo_tpu``.

The module paths mirror the JAX package, so each port module sits where its
counterpart does.  Plain tensor code is PyTorch; each Pallas kernel of the
JAX package becomes a hand-written CUDA kernel under ``ops/csrc/``, built
with ``nvcc`` at first use (``utils/build.py``).

Importing the package is cheap: it imports no kernel build and never JAX.
"""

from .version import __version__  # noqa: F401
