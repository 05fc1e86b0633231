"""First contact past 128 bars under Heston: the plain version held against
the JAX kernel (``pallas_mc.py _heston_block``) in interpret mode on the same
injected uniforms at W = 130, within the tolerance of
``tests/test_torch_first_contact_long.py`` (its own file: the JAX kernel's
interpret-mode build at this W takes ~40 s on the CPU, so the test workers
run it beside the other cases)."""

import torch

from .test_torch_first_contact_long import _assert_close, jax_single

torch.set_num_threads(2)


def test_plain_first_contact_heston_matches_the_jax_kernel_interpret_past_128_bars():
    lanes, w = 128, 130
    j, t = jax_single("heston", w, False, False, lanes, 7)
    _assert_close(t, j, lanes, w)
