"""Sobol' sequence with hash-based Owen scrambling (port of
mitsuba_tpu/sampler/sobol.py).

Counterpart of the reference's global Sobol' sampler (ref: src/samplers/
sobol.cpp, sobolseq.h:136), re-designed for the counter-based wavefront:
instead of shipping the 108k-line vendored Joe-Kuo direction-number table
(ref: src/samplers/sobolseq.cpp), direction numbers are *generated* from
primitive polynomials over GF(2) found by search, with initial values
drawn deterministically from a hash (odd, in range — any such choice
yields a valid digital (t,s)-sequence in base 2; the classic tables only
tune cross-dimension projections, which the per-dimension-pair Owen
scrambling below randomizes anyway).

Scrambling is nested-uniform (Owen) via the Laine-Karras-style hash
(Burley, "Practical Hash-based Owen Scrambling", JCGT 2020): applied in
the reversed-bit domain, keyed per (seed, pixel, dimension). torch has no
uint32 arithmetic, so words live in int64 tensors holding values in
[0, 2^32), masked after every add, multiply and shift (core/rng.py).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.rng import _MASK, _mul32

_INV_2_32 = float(2.0 ** -32)

N_SOBOL_DIMS = 64


# ---------------------------------------------------------------------------
# direction-number generation (host side, import time)
# ---------------------------------------------------------------------------

def _primitive_polys(count: int) -> list[tuple[int, int]]:
    """First `count` primitive polynomials over GF(2), ordered by degree.
    Returns (degree s, a) where a packs interior coefficients a_1..a_{s-1}
    (Bratley-Fox convention: leading and trailing coefficient are 1)."""
    out = []
    degree = 1
    while len(out) < count:
        n = 1 << degree
        period = n - 1
        # proper divisors of the period (for primitivity order check)
        divs = [d for d in range(1, period) if period % d == 0]
        for interior in range(1 << max(degree - 1, 0)):
            # polynomial bits: x^s + (interior) + 1
            poly = (1 << degree) | (interior << 1) | 1
            # irreducibility + primitivity: order of x mod poly == period
            if not _is_primitive(poly, degree, period, divs):
                continue
            out.append((degree, interior))
            if len(out) == count:
                break
        degree += 1
    return out


def _polymod_mul(a: int, b: int, poly: int, degree: int) -> int:
    """Carry-less multiply mod `poly` in GF(2)[x]."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> degree:
            a ^= poly
    return r


def _polymod_pow(base: int, e: int, poly: int, degree: int) -> int:
    r = 1
    while e:
        if e & 1:
            r = _polymod_mul(r, base, poly, degree)
        base = _polymod_mul(base, base, poly, degree)
        e >>= 1
    return r


def _is_primitive(poly: int, degree: int, period: int, divs) -> bool:
    if degree == 1:
        return poly == 0b11          # x + 1
    # x^period == 1 and x^d != 1 for all proper divisors d
    if _polymod_pow(2, period, poly, degree) != 1:
        return False
    for d in divs:
        if d > 1 and _polymod_pow(2, d, poly, degree) == 1:
            return False
    return True


def _hash64(x: int) -> int:
    """splitmix64 finalizer — deterministic initial direction numbers."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def _build_matrices(n_dims: int) -> np.ndarray:
    """uint32 [D, 32] direction vectors v_k (column k of the generator
    matrix, MSB-aligned). Dim 0 is the van der Corput identity."""
    v = np.zeros((n_dims, 32), np.uint64)
    v[0] = [1 << (31 - k) for k in range(32)]
    polys = _primitive_polys(n_dims - 1)
    for d, (s, interior) in enumerate(polys, start=1):
        m = np.zeros(33, np.uint64)      # m_1..m_32 (1-indexed)
        for k in range(1, s + 1):
            # odd, < 2^k, deterministic
            m[k] = 2 * (_hash64(d * 1315423911 + k) % (1 << (k - 1))) + 1 \
                if k > 1 else 1 + 2 * (_hash64(d) % 1)  # m_1 = 1 always odd
        for k in range(s + 1, 33):
            acc = m[k - s] ^ (m[k - s] << s)
            for j in range(1, s):
                a_j = (interior >> (s - 1 - j)) & 1
                if a_j:
                    acc ^= m[k - j] << j
            m[k] = acc
        for k in range(1, 33):
            v[d, k - 1] = (m[k] << (32 - k)) & 0xFFFFFFFF
    return v.astype(np.uint32)


@functools.cache
def direction_numbers() -> np.ndarray:
    """The [N_SOBOL_DIMS, 32] direction vectors as int64 (built once, on
    first use: the JAX module builds them at import)."""
    return _build_matrices(N_SOBOL_DIMS).astype(np.int64)



# ---------------------------------------------------------------------------
# evaluation on tensors
# ---------------------------------------------------------------------------

def reverse_bits(x: torch.Tensor) -> torch.Tensor:
    """Bit reversal of 32-bit words (int64 tensors in [0, 2^32))."""
    x = ((x << 16) | (x >> 16)) & _MASK
    x = ((x & 0x00ff00ff) << 8) | ((x & 0xff00ff00) >> 8)
    x = ((x & 0x0f0f0f0f) << 4) | ((x & 0xf0f0f0f0) >> 4)
    x = ((x & 0x33333333) << 2) | ((x & 0xcccccccc) >> 2)
    x = ((x & 0x55555555) << 1) | ((x & 0xaaaaaaaa) >> 1)
    return x


def owen_scramble(x: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Nested-uniform scramble of an MSB-aligned 32-bit Sobol' value
    (Laine-Karras hash per Burley 2020, operating on reversed bits)."""
    x = reverse_bits(x)
    x = (x + key) & _MASK
    for c in (0x6c50b47c, 0xb82f1e52, 0xc7afe638, 0x8d22f6e6):
        x = x ^ _mul32(x, c)
    return reverse_bits(x)


def sobol_u32(index: torch.Tensor, dim: int) -> torch.Tensor:
    """Raw (unscrambled) Sobol' sample, MSB-aligned, as int64 words.
    index: int64 tensor of words; dim: a Python int (taken mod the table
    size — higher path dimensions are pad-scrambled anyway)."""
    vrow = direction_numbers()[int(dim) % N_SOBOL_DIMS]
    y = torch.zeros_like(index)
    idx = index
    for k in range(32):
        y = torch.where((idx & 1) == 1, y ^ int(vrow[k]), y)
        idx = idx >> 1
    return y


def sobol_sample(index: torch.Tensor, dim: int, key: torch.Tensor):
    """Owen-scrambled Sobol' float32 in [0, 1)."""
    return owen_scramble(sobol_u32(index, dim), key).to(
        torch.float32) * _INV_2_32
