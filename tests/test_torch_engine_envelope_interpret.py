"""The engine's samplers at an odd horizon (W = 25: the final half step
draws one more step of rows and takes the first branch of each pair) against
the JAX kernel in interpret mode on the same injected uniforms and JAX's own
bootstrap tables, one block of 8 x 128 paths: counts, the 16-reason skip table
and escalations exact, the histogram within the flip budget.  W = 62 (the
windowed guard) is ``tests/test_torch_engine_envelope_interpret_w62.py``."""

import pytest
import torch

from .test_torch_sampler_kernels import engine_against_interpret

torch.set_num_threads(2)

W = 25


@pytest.mark.parametrize("sampler,noisy", [("bootstrap", False), ("block_bootstrap", True),
                                           ("heston", True), ("heston", False)])
def test_plain_engine_sampler_at_an_odd_horizon_matches_the_jax_kernel(sampler, noisy):
    engine_against_interpret(sampler, W, noisy, lanes=128, seed=61)
