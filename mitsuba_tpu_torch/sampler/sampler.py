"""The `independent` sampler of mitsuba_tpu/sampler/sampler.py.

Stateless functions of (seed, pixel, sample index, dimension). The other
kinds of the JAX package (stratified, ld, halton, hammersley, sobol) are
not ported yet: `check_kind` raises for them.
"""
from __future__ import annotations

from ..core import rng

INDEPENDENT = "independent"


def check_kind(kind: str):
    if kind != INDEPENDENT:
        raise NotImplementedError(
            f"sampler {kind!r}: the port has only the 'independent' sampler")


def draw_1d(seed, pixel, samp, dim):
    """One uniform per lane."""
    return rng.sample_1d(seed, pixel, dim, samp)


def draw_2d(seed, pixel, samp, dim):
    """Two uniforms per lane, shape [..., 2]."""
    return rng.sample_2d(seed, pixel, dim, samp)
