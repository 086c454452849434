"""Counter-based, stateless RNG: PCG4D, bit-exact with mitsuba_tpu/core/rng.py.

Every random number is a pure function of (seed, pixel index, dimension,
sample index), so the JAX package and the port draw the same sample stream
for the same counters. torch has no uint32 add, multiply or shift, so words
live in int64 tensors holding values in [0, 2^32) and are masked after every
add, multiply and shift. Products are split into 16-bit halves so no int64
intermediate overflows (signed overflow is not relied on, on CPU or CUDA).
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
# 1/2^24 — uniform floats built from the top 24 bits are exact in f32
_INV_2_24 = float(1.0 / (1 << 24))


def _mul32(a, b):
    """(a * b) mod 2^32 for words in [0, 2^32); every partial < 2^49."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK


def pcg4d(v: torch.Tensor) -> torch.Tensor:
    """PCG4D hash: words [..., 4] (int64 in [0, 2^32)) -> words [..., 4]."""
    v = (_mul32(v, 1664525) + 1013904223) & _MASK
    x, y, z, w = v.unbind(-1)
    x = (x + _mul32(y, w)) & _MASK
    y = (y + _mul32(z, x)) & _MASK
    z = (z + _mul32(x, y)) & _MASK
    w = (w + _mul32(y, z)) & _MASK
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + _mul32(y, w)) & _MASK
    y = (y + _mul32(z, x)) & _MASK
    z = (z + _mul32(x, y)) & _MASK
    w = (w + _mul32(y, z)) & _MASK
    return torch.stack([x, y, z, w], dim=-1)


def _to_float(bits: torch.Tensor) -> torch.Tensor:
    """Word -> float32 uniform in [0, 1) from its top 24 bits."""
    return (bits >> 8).to(torch.float32) * _INV_2_24


def _word(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def hash_u32(seed, idx, dim, samp=0) -> torch.Tensor:
    """Raw 4-word hash of the counter tuple; word order [idx, dim, seed,
    samp + 0x9E3779B9] as in the JAX package. Arguments are Python ints or
    integer tensors (values taken mod 2^32) and broadcast together."""
    device = next((a.device for a in (idx, seed, dim, samp)
                   if isinstance(a, torch.Tensor)), None)
    seed, idx, dim, samp = torch.broadcast_tensors(
        _word(seed, device), _word(idx, device), _word(dim, device),
        _word(samp, device))
    ctr = torch.stack([idx, dim, seed, (samp + 0x9E3779B9) & _MASK], dim=-1)
    return pcg4d(ctr)


def sample_1d(seed, idx, dim, samp=0) -> torch.Tensor:
    """One uniform float per counter tuple. Shape = broadcast of args."""
    return _to_float(hash_u32(seed, idx, dim, samp)[..., 0])


def sample_2d(seed, idx, dim, samp=0) -> torch.Tensor:
    """Two uniform floats per counter tuple; shape [..., 2]."""
    return _to_float(hash_u32(seed, idx, dim, samp)[..., 0:2])
