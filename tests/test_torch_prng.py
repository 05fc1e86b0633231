"""Port Philox4x32-10: known-answer vectors and counter-based independence
from how the draws are generated."""

import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu_torch.ops import draws
from qmmx_monolithic_monte_carlo_tpu_torch.utils import prng

torch.set_num_threads(2)

M = 0xFFFFFFFF


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M, M, M, M), (M, M), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    got = prng.philox4x32(tuple(torch.tensor([c]) for c in counter), key)
    assert tuple(int(w[0]) for w in got) == want


@pytest.mark.parametrize("chunk", [1, 2, 3, 5])
def test_draws_independent_of_chunking_and_order(chunk):
    n_blocks, n_rows, lanes = 6, 9, 48
    whole = prng.uniform_rows(11, prng.STREAM_PATH, block0=0, n_blocks=n_blocks,
                              n_rows=n_rows, lanes=lanes)
    parts = {}
    for b0 in reversed(range(0, n_blocks, chunk)):
        nb = min(chunk, n_blocks - b0)
        parts[b0] = prng.uniform_rows(11, prng.STREAM_PATH, block0=b0,
                                      n_blocks=nb, n_rows=n_rows, lanes=lanes)
    assert torch.equal(torch.cat([parts[b] for b in sorted(parts)]), whole)


def test_draws_independent_of_row_and_lane_count():
    a = prng.uniform_rows(3, 7, block0=2, n_blocks=1, n_rows=13, lanes=64)
    b = prng.uniform_rows(3, 7, block0=2, n_blocks=1, n_rows=6, lanes=64)
    assert torch.equal(a[:, :6], b)
    # word row % 4 of counter (lane, row // 4, block): row 5 of lane 9
    words = prng.philox4x32((torch.tensor(9), torch.tensor(1), torch.tensor(2),
                             torch.tensor(0)), (3, 7))
    assert a[0, 5, 9] == prng.to_uniform(words[1])


def test_streams_and_seeds_differ():
    base = prng.uniform_rows(1, 5, block0=0, n_blocks=1, n_rows=4, lanes=256)
    for seed, stream in ((2, 5), (1, 6)):
        other = prng.uniform_rows(seed, stream, block0=0, n_blocks=1,
                                  n_rows=4, lanes=256)
        assert not torch.equal(base, other)


def test_uniform_range_and_moments():
    u = prng.uniform_rows(5, 0, block0=0, n_blocks=4, n_rows=8, lanes=4096)
    assert u.dtype == torch.float32
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.005
    assert abs(float(u.var()) - 1.0 / 12.0) < 0.002


def test_normal_rows_moments():
    z = prng.normal_rows(9, prng.STREAM_PATH, block=3, n_rows=5, lanes=1 << 15)
    assert z.shape == (5, 1 << 15)
    assert abs(float(z.mean())) < 0.02
    assert abs(float(z.std()) - 1.0) < 0.02


def test_large_block_index_uses_high_counter_word():
    big = (1 << 32) + 3
    a = prng.uniform_rows(0, 5, block0=big, n_blocks=1, n_rows=4, lanes=8)
    b = prng.uniform_rows(0, 5, block0=3, n_blocks=1, n_rows=4, lanes=8)
    assert not torch.equal(a, b)


@pytest.mark.parametrize("seed", [-1, 1 << 32])
def test_seed_range_checked(seed):
    with pytest.raises(ValueError):
        prng.uniform_rows(seed, 0, block0=0, n_blocks=1, n_rows=1, lanes=4)


def test_fused_layout_rows():
    lay = draws.GbmLayout(40)
    assert (lay.u1, lay.u2, lay.u3, lay.u4) == (
        slice(0, 20), slice(20, 40), slice(40, 80), slice(80, 120))
    assert lay.tie == 120 and lay.n_rows == 121
    noisy = draws.GbmLayout(40, noise=True)
    assert noisy.noise_rows == (121, 122, 123, 124) and noisy.n_rows == 125
    u = draws.fused_uniforms(4, noisy, block0=1, n_blocks=2, lanes=16)
    assert u.shape == (2, 125, 16)
    with pytest.raises(ValueError):
        draws.GbmLayout(41)
