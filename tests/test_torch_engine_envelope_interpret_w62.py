"""The engine's samplers past the guard's 61-bar window (W = 62, the oldest
bar first ages out of the windowed guard's box) against the JAX kernel in
interpret mode on the same injected uniforms and JAX's own bootstrap tables,
one block of 8 x 128 paths: counts, the 16-reason skip table and escalations
exact, the histogram within the flip budget."""

import pytest
import torch

from .test_torch_sampler_kernels import engine_against_interpret

torch.set_num_threads(2)

W = 62


@pytest.mark.parametrize("sampler", ["bootstrap", "block_bootstrap", "heston"])
def test_plain_engine_sampler_past_61_bars_matches_the_jax_kernel(sampler):
    engine_against_interpret(sampler, W, False, lanes=128, seed=62)
