"""Counter-based random numbers: Philox4x32-10 keyed on (seed, stream).

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/utils/prng.py``.  The JAX
package derives a threefry subkey per consumer with ``fold_in``; the port
keys Philox4x32-10 on ``(seed, stream)`` and counts on
``(lane, row // 4, global block)``, taking word ``row % 4`` of the output.  A
draw is therefore a pure function of (seed, stream, block, row, lane): it does
not depend on how many blocks one call generates, in which order, or on which
device or how many of them.

This module is the plain PyTorch implementation: uint32 arithmetic in int64
tensors with masks, multiplications split into 16-bit halves so no product
leaves the int64 range.  ``ops/csrc/mc_first_contact.cu`` computes the same
bits on the card.
"""

from __future__ import annotations

import torch

# Stream tags (arbitrary but fixed small ints): the JAX package's values,
# then the port's own.
STREAM_LEVEL_JITTER = 0
STREAM_ENTRY_SLIP = 1
STREAM_STOP_SLIP = 2
STREAM_TARGET_SLIP = 3
STREAM_TIE_COIN = 4
STREAM_PATH = 5
STREAM_BOOTSTRAP = 6
STREAM_BRIDGE_HI = 7
STREAM_BRIDGE_LO = 8
STREAM_VOLUME = 9
STREAM_MARKET = 10
STREAM_GATED = 11    # the port's gated lifecycle kernel (ops/draws.GatedLayout)

_M32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10
U24_SCALE = 1.0 / (1 << 24)
U_EPS = 1e-12        # keeps log(u) finite: u in (0, 1), as the TPU kernel's
TWO_PI = 6.283185307179586


def _mulhilo(m: int, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product of constant ``m`` and the
    uint32 values in ``a`` (int64 tensor)."""
    p_lo = (a & 0xFFFF) * m           # < 2^48
    p_hi = (a >> 16) * m              # < 2^48
    t = p_hi + (p_lo >> 16)           # < 2^49
    return t >> 16, ((t & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32(counter, key) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding uint32 values.

    ``counter`` is four broadcastable tensors, ``key`` two ints.
    Returns the four output words as int64 tensors in [0, 2^32)."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) & _M32
                      for c in counter)
    k0, k1 = (int(k) & _M32 for k in key)
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & _M32
            k1 = (k1 + PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def check_seed(seed: int) -> int:
    seed = int(seed)
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed must be in [0, 2^32), got {seed}")
    return seed


def uniform_rows(seed: int, stream: int, *, block0: int, n_blocks: int,
                 n_rows: int, lanes: int, device=None) -> torch.Tensor:
    """f32[n_blocks, n_rows, lanes] uniforms in (0, 1) for global blocks
    ``block0 .. block0 + n_blocks - 1``.

    Element (b, row, lane) is word ``row % 4`` of Philox4x32-10 with key
    (seed, stream) and counter (lane, row // 4, block mod 2^32, block >> 32),
    turned into a float as the TPU kernel does: the top 24 bits times 2^-24,
    plus 1e-12."""
    seed = check_seed(seed)
    groups = -(-n_rows // 4)
    blk = torch.arange(block0, block0 + n_blocks, dtype=torch.int64,
                       device=device).view(-1, 1, 1)
    grp = torch.arange(groups, dtype=torch.int64, device=device).view(1, -1, 1)
    lane = torch.arange(lanes, dtype=torch.int64, device=device).view(1, 1, -1)
    shape = (n_blocks, groups, lanes)
    words = philox4x32(
        (lane.expand(shape), grp.expand(shape), (blk & _M32).expand(shape),
         (blk >> 32).expand(shape)),
        (seed, stream))
    bits = torch.stack(words, dim=2).reshape(n_blocks, groups * 4, lanes)
    bits = bits[:, :n_rows]
    return to_uniform(bits)


def to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64 tensor) → f32 uniforms: (bits >> 8)·2^-24 + 1e-12."""
    return (bits >> 8).to(torch.float32) * U24_SCALE + U_EPS


def normal_rows(seed: int, stream: int, *, block: int, n_rows: int,
                lanes: int, device=None) -> torch.Tensor:
    """f32[n_rows, lanes] standard normals of one global block: paired
    Box-Muller over 2·ceil(n_rows / 2) uniform rows, cosine branch first."""
    half = -(-n_rows // 2)
    u = uniform_rows(seed, stream, block0=block, n_blocks=1,
                     n_rows=2 * half, lanes=lanes, device=device)[0]
    radius = torch.sqrt(-2.0 * torch.log(u[:half]))
    angle = TWO_PI * u[half:]
    return torch.cat([radius * torch.cos(angle),
                      radius * torch.sin(angle)])[:n_rows]

