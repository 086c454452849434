"""Rough dielectric transmittance tables for rough plastic (port of the
lookups of mitsuba_tpu/bsdf/rtrans.py, the rtrans.h analog).

The tables are the JAX package's precomputed single-scattering microfacet
transmittance T(η, α, cosθ) and its cosine-weighted internal average,
stored beside this module as `_rtrans_*.npz` (copies of the JAX package's
files); the port loads them and does not rebuild them. Lookups are the
JAX package's trilinear and bilinear fetches in float32, in its order of
operations.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

N_ETA, N_ALPHA, N_COS = 24, 16, 32
N_SAMPLES = 2048


def _load(name):
    key = f"{name}_{N_ETA}x{N_ALPHA}x{N_COS}_{N_SAMPLES}"
    path = os.path.join(os.path.dirname(__file__), f"_rtrans_{key}.npz")
    z = np.load(path)
    return tuple(z[k] for k in z.files)


@functools.lru_cache(maxsize=4)
def transmittance_table(ggx: bool = True):
    """(T [NE, NA, NC], etas, alphas, coss): the external-side table over
    η in [1, 4], α in [0, 1] and cosθ in [0.01, 1]."""
    return _load(f"ext_{'ggx' if ggx else 'beck'}")


@functools.lru_cache(maxsize=4)
def diffuse_transmittance_inv(ggx: bool = True):
    """(T [NE, NA], etas, alphas): the internal side's cosine-weighted
    average transmittance (rtrans.h evalDiffuse)."""
    return _load(f"diff_{'ggx' if ggx else 'beck'}")


def _f32(v):
    return torch.as_tensor(v, dtype=torch.float32)


def _axis_idx(v, grid):
    g0, g1, n = float(grid[0]), float(grid[-1]), len(grid)
    x = (torch.clamp(v, g0, g1) - g0) / (g1 - g0) * (n - 1)
    i0 = torch.clamp(torch.floor(x).to(torch.int32), 0, n - 2)
    return i0.long(), x - i0


def lookup(table_pack, eta, alpha, cos_t):
    """Trilinear fetch of T(η, α, cosθ), each argument clamped into its
    grid; tensors or floats, broadcast together."""
    t, etas, alphas, coss = table_pack
    eta, alpha, cos_t = torch.broadcast_tensors(_f32(eta), _f32(alpha),
                                                _f32(cos_t))
    t = torch.as_tensor(t, device=eta.device)
    ie, fe = _axis_idx(eta, etas)
    ia, fa = _axis_idx(alpha, alphas)
    ic, fc = _axis_idx(cos_t, coss)
    out = 0.0
    for de, we in ((0, 1.0 - fe), (1, fe)):
        for da, wa in ((0, 1.0 - fa), (1, fa)):
            for dc, wc in ((0, 1.0 - fc), (1, fc)):
                out = out + we * wa * wc * t[ie + de, ia + da, ic + dc]
    return out


def lookup_diffuse(pack, eta, alpha):
    """Bilinear fetch of the internal diffuse transmittance."""
    t, etas, alphas = pack
    eta, alpha = torch.broadcast_tensors(_f32(eta), _f32(alpha))
    t = torch.as_tensor(t, device=eta.device)
    ie, fe = _axis_idx(eta, etas)
    ia, fa = _axis_idx(alpha, alphas)
    return ((1 - fe) * (1 - fa) * t[ie, ia] + fe * (1 - fa) * t[ie + 1, ia]
            + (1 - fe) * fa * t[ie, ia + 1] + fe * fa * t[ie + 1, ia + 1])
