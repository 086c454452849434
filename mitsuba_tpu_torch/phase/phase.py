"""The Henyey-Greenstein phase function (port of the HG part of
mitsuba_tpu/phase/phase.py).

Conventions are the reference's (ref: src/phase/hg.cpp:79-113): wi points
back toward the radiance source (wi = -ray.d), wo is the new direction,
and the value is taken at dot(wi, wo), so forward scattering (g > 0) peaks
at dot(wi, wo) = -1. Every function broadcasts over the wavefront axes; g
may be a float, a 0-d tensor or a per-lane tensor. The other phase
functions of the JAX module (isotropic, Rayleigh, Kajiya-Kay, SGGX, the
mixtures, the microflake) are not ported.
"""
from __future__ import annotations

import math

import torch

from ..core.math import Frame, dot
from ..core.warp import INV_FOUR_PI


def hg_eval(g, cos_theta):
    """HG phase value (1/4π)(1-g²)/(1+g²+2g·cosθ)^{3/2} (hg.cpp:105-113)."""
    g2 = g * g
    denom = torch.clamp(1.0 + g2 + 2.0 * g * cos_theta, min=1e-8)
    return INV_FOUR_PI * (1.0 - g2) / (denom * torch.sqrt(denom))


def hg_sample(g, wi, u2):
    """Exact inverse-CDF HG sampling about -wi (hg.cpp:79-90). Returns
    (wo [N, 3], pdf [N]). Below |g| = 1e-4 the cosine is 1 - 2u, the
    isotropic limit."""
    g = torch.as_tensor(g, dtype=wi.dtype, device=wi.device)
    small = torch.abs(g) < 1e-4
    safe_g = torch.where(small, 1e-4, g)
    sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u2[..., 0])
    cos_theta_g = (1.0 + g * g - sqr * sqr) / (2.0 * safe_g)
    cos_theta = torch.where(small, 1.0 - 2.0 * u2[..., 0], cos_theta_g)
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * math.pi * u2[..., 1]
    local = torch.stack([sin_theta * torch.cos(phi),
                         sin_theta * torch.sin(phi), cos_theta], dim=-1)
    wo = Frame.to_world(Frame.from_normal(-wi), local)
    return wo, hg_eval(g, dot(wi, wo))


def hg_pdf(g, wi, wo):
    return hg_eval(g, dot(wi, wo))
