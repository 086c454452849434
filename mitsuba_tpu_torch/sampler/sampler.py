"""Sample generators (port of mitsuba_tpu/sampler/sampler.py): independent,
stratified, low-discrepancy (0,2), Halton, Hammersley and Sobol'.

Counterparts of the reference sampler plugins (ref: src/samplers/
{independent,stratified,ldsampler,halton,hammersley,sobol}.cpp; interface
sampler.h:66-173). All samplers here are stateless functions of
(seed, pixel, sample_index, spp, dim), the functional analog of the
reference's per-pixel deterministic streams, bit for bit the JAX
package's:

  independent — PCG4D hash (core/rng.py)
  stratified  — jittered strata with a per-(pixel,dim) sample permutation
  ldsampler   — xor-scrambled (0,2)-sequence, padded per dimension pair
  halton      — digit-scrambled radical inverse, prime per dimension
  hammersley  — first coordinate i/spp, rest radical inverse
  sobol       — Owen-scrambled Sobol' with generated direction numbers
                (sampler/sobol.py)

Stratified, ld and hammersley need spp (a Python int); for 2D draws
stratified uses a ⌈√spp⌉×⌈√spp⌉ grid like the reference. spp <= 0 draws
the independent stream whatever the kind. torch has no uint32
arithmetic, so the JAX module's uint32 loops run on int64 tensors
holding words in [0, 2^32), masked after every add, multiply and shift
(core/rng.py). Divisions by spp and the grid size divide by a tensor of
the divisor, so CPU and CUDA both round the quotient (a CUDA division by
a Python scalar multiplies by its reciprocal).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import rng
from ..core.rng import _MASK, _mul32

_INV_2_32 = float(2.0 ** -32)

INDEPENDENT = "independent"
STRATIFIED = "stratified"
LD = "ldsampler"
HALTON = "halton"
HAMMERSLEY = "hammersley"
SOBOL = "sobol"
KINDS = (INDEPENDENT, STRATIFIED, LD, HALTON, HAMMERSLEY, SOBOL)

# first 64 primes (halton bases; dims beyond fall back to hashing)
_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
           59, 61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113,
           127, 131, 137, 139, 149, 151, 157, 163, 167, 173, 179, 181,
           191, 193, 197, 199, 211, 223, 227, 229, 233, 239, 241, 251,
           257, 263, 269, 271, 277, 281, 283, 293, 307, 311]


def check_kind(kind: str):
    """Raise ValueError for a sampler name that is none of KINDS."""
    if kind not in KINDS:
        raise ValueError(f"unknown sampler {kind!r}; known: {list(KINDS)}")


def _words(x, like: torch.Tensor) -> torch.Tensor:
    """x (an int or integer tensor) as int64 words on like's device,
    broadcast to like's shape."""
    x = torch.as_tensor(x, dtype=torch.int64, device=like.device) & _MASK
    return x.expand(like.shape)


def _div(x: torch.Tensor, n) -> torch.Tensor:
    """x / n in float32, n divided as a tensor (see the module note)."""
    return x / torch.full_like(x, float(n))


def _perm(x, n: int, key: torch.Tensor) -> torch.Tensor:
    """Pseudorandom permutation of [0, n) via a 3-round xor-mul cipher
    keyed by `key` (Kensler-style, cycle-walking until < n)."""
    x = _words(x, key)
    bits = int(np.ceil(np.log2(max(n, 2))))
    mask = (1 << bits) - 1
    shift = max(bits // 2, 1)

    def one_round(v):
        v = v ^ key
        v = _mul32(v, 0xe170893d) & mask
        v = v ^ (v >> shift)
        v = _mul32(v, 0x0929eb3f) & mask
        v = v ^ key
        return v & mask

    v = one_round(x)
    for _ in range(4):
        v = torch.where(v >= n, one_round(v), v)
    return torch.where(v >= n, x, v)   # give up → identity (measure-zero)


def _vdc(bits: torch.Tensor) -> torch.Tensor:
    """Base-2 radical inverse (bit reversal) of 32-bit words."""
    from .sobol import reverse_bits
    return reverse_bits(bits)


def _sobol2(index: torch.Tensor) -> torch.Tensor:
    """Second dimension of the (0,2)-sequence (Sobol' with m_i = 1)."""
    res = torch.zeros_like(index)
    v = 1 << 31
    idx = index
    for _ in range(32):
        res = torch.where((idx & 1) == 1, res ^ v, res)
        idx = idx >> 1
        v = v ^ (v >> 1)
    return res


def _radical_inverse(index: torch.Tensor, base: int,
                     scramble_key: torch.Tensor) -> torch.Tensor:
    """Digit-scrambled radical inverse in prime `base`. Scrambling: a
    per-digit additive shift keyed by (digit position, key)."""
    n_digits = int(np.ceil(32 / np.log2(base)))
    inv_base = 1.0 / base
    val = torch.zeros(index.shape, dtype=torch.float32, device=index.device)
    factor = torch.full(index.shape, inv_base, dtype=torch.float32,
                        device=index.device)
    idx = index
    for i in range(n_digits):
        digit = idx % base
        shift = (scramble_key >> (i % 27)) % base
        digit = (digit + shift) % base
        val = val + digit.to(torch.float32) * factor
        idx = idx // base
        factor = factor * inv_base
    return torch.clamp(val, max=1.0 - 1e-7)


def _u32_float(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.float32) * _INV_2_32


def draw_1d(kind: str, seed, pixel, samp, spp: int, dim):
    """One uniform float32 per lane. pixel: integer tensor [...]; seed,
    samp and dim: ints or integer tensors broadcasting against it."""
    if kind == INDEPENDENT or spp <= 0:
        return rng.sample_1d(seed, pixel, dim, samp)
    h = rng.hash_u32(seed, pixel, dim, 0)
    if kind == STRATIFIED:
        s_perm = _perm(samp, spp, h[..., 0])
        jitter = rng.sample_1d(seed, pixel, dim, samp)
        return _div(s_perm.to(torch.float32) + jitter, spp)
    if kind == LD:
        return _u32_float(_vdc(_words(samp, h[..., 0])) ^ h[..., 0])
    if kind == HALTON:
        return _radical_inverse(_words(samp, h[..., 0]), _PRIMES[0],
                                h[..., 0])
    if kind == HAMMERSLEY:
        s_perm = _perm(samp, spp, h[..., 0])
        return _div(s_perm.to(torch.float32) + 0.5, spp)
    if kind == SOBOL:
        from .sobol import sobol_sample
        return sobol_sample(_words(samp, h[..., 0]), 2 * int(dim), h[..., 0])
    raise ValueError(f"unknown sampler {kind}")


def draw_2d(kind: str, seed, pixel, samp, spp: int, dim):
    """Two uniform float32s per lane, shape [..., 2]."""
    if kind == INDEPENDENT or spp <= 0:
        return rng.sample_2d(seed, pixel, dim, samp)
    h = rng.hash_u32(seed, pixel, dim, 0)
    if kind == STRATIFIED:
        res = int(np.ceil(np.sqrt(spp)))
        s_perm = _perm(samp, min(spp, res * res), h[..., 0])
        sx = (s_perm % res).to(torch.float32)
        sy = (s_perm // res).to(torch.float32)
        jit = rng.sample_2d(seed, pixel, dim, samp)
        return torch.stack([_div(sx + jit[..., 0], res),
                            _div(sy + jit[..., 1], res)], dim=-1)
    if kind == LD:
        idx = _words(samp, h[..., 0])
        return torch.stack([_u32_float(_vdc(idx) ^ h[..., 0]),
                            _u32_float(_sobol2(idx) ^ h[..., 1])], dim=-1)
    if kind == HALTON:
        gidx = _words(samp, h[..., 0])
        return torch.stack([_radical_inverse(gidx, _PRIMES[0], h[..., 0]),
                            _radical_inverse(gidx, _PRIMES[1], h[..., 1])],
                           dim=-1)
    if kind == HAMMERSLEY:
        s_perm = _perm(samp, spp, h[..., 0])
        return torch.stack([_div(s_perm.to(torch.float32) + 0.5, spp),
                            _radical_inverse(s_perm, _PRIMES[0], h[..., 1])],
                           dim=-1)
    if kind == SOBOL:
        from .sobol import sobol_sample
        idx = _words(samp, h[..., 0])
        d2 = 2 * int(dim)
        return torch.stack([sobol_sample(idx, d2, h[..., 0]),
                            sobol_sample(idx, d2 + 1, h[..., 1])], dim=-1)
    raise ValueError(f"unknown sampler {kind}")
