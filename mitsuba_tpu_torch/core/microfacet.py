"""Microfacet distributions: GGX and Beckmann, Smith shadowing, visible-
normal sampling (port of mitsuba_tpu/core/microfacet.py).

Local-frame directions ([..., 3], +z = shading normal), anisotropic
roughness (alpha_u, alpha_v) and a per-lane distribution code: 0 =
Beckmann, 1 = GGX (ref: src/bsdfs/microfacet.h).
"""
from __future__ import annotations

import math

import torch

from .math import dot, normalize, safe_sqrt

BECKMANN = 0
GGX = 1

_MIN_ALPHA = 1e-4  # microfacet.h's minimum roughness


def clamp_alpha(a):
    return torch.clamp(a, min=_MIN_ALPHA)


def eval_d(m, alpha_u, alpha_v, dist_type):
    """Microfacet NDF D(m), zero below the horizon (microfacet.h:191)."""
    alpha_u = clamp_alpha(alpha_u)
    alpha_v = clamp_alpha(alpha_v)
    mx, my, mz = m[..., 0], m[..., 1], m[..., 2]
    cos2 = mz * mz
    t = (mx / alpha_u) ** 2 + (my / alpha_v) ** 2 + cos2
    d_ggx = 1.0 / (math.pi * alpha_u * alpha_v
                   * torch.clamp(t * t, min=1e-12))
    ex = -((mx / alpha_u) ** 2 + (my / alpha_v) ** 2) / torch.clamp(
        cos2, min=1e-12)
    d_beck = torch.exp(ex) / (math.pi * alpha_u * alpha_v
                              * torch.clamp(cos2 * cos2, min=1e-12))
    d = torch.where(dist_type == GGX, d_ggx, d_beck)
    return torch.where(mz > 0.0, d, 0.0)


def _projected_roughness(v, alpha_u, alpha_v):
    """Roughness projected onto direction v (microfacet.h
    projectRoughness)."""
    inv_sin2 = 1.0 / torch.clamp(1.0 - v[..., 2] ** 2, min=1e-12)
    cos_phi2 = v[..., 0] ** 2 * inv_sin2
    sin_phi2 = v[..., 1] ** 2 * inv_sin2
    iso = torch.abs(1.0 - v[..., 2] ** 2) < 1e-12
    a2 = torch.where(iso, alpha_u * alpha_u,
                     cos_phi2 * alpha_u ** 2 + sin_phi2 * alpha_v ** 2)
    return safe_sqrt(a2)


def smith_g1(v, m, alpha_u, alpha_v, dist_type):
    """Smith masking G1(v, m) (microfacet.h:236), zero where v lies on the
    other side of the micronormal (v·m · v·n <= 0)."""
    alpha_u = clamp_alpha(alpha_u)
    alpha_v = clamp_alpha(alpha_v)
    cos_v = v[..., 2]
    tan_theta = safe_sqrt(1.0 - cos_v * cos_v) / torch.clamp(
        torch.abs(cos_v), min=1e-12)
    alpha = _projected_roughness(v, alpha_u, alpha_v)
    a = 1.0 / torch.clamp(alpha * tan_theta, min=1e-12)
    g_ggx = 2.0 / (1.0 + safe_sqrt(1.0 + (alpha * tan_theta) ** 2))
    g_beck = torch.where(
        a < 1.6, (3.535 * a + 2.181 * a * a)
        / (1.0 + 2.276 * a + 2.577 * a * a), 1.0)
    g = torch.where(dist_type == GGX, g_ggx, g_beck)
    backfacing = dot(v, m) * cos_v <= 0.0
    g = torch.where(tan_theta < 1e-6, 1.0, g)
    return torch.where(backfacing, 0.0, g)


def smith_g(wi, wo, m, alpha_u, alpha_v, dist_type):
    return (smith_g1(wi, m, alpha_u, alpha_v, dist_type)
            * smith_g1(wo, m, alpha_u, alpha_v, dist_type))


def sample_visible(wi, u, alpha_u, alpha_v, dist_type):
    """A micronormal from the distribution of normals visible from wi
    (Heitz 2018), wi on either side by mirroring. Exact for GGX; the
    JAX package uses it as the Beckmann proposal too, with pdf_visible
    evaluated only for GGX."""
    alpha_u = clamp_alpha(alpha_u)
    alpha_v = clamp_alpha(alpha_v)
    flip = wi[..., 2] < 0.0
    wi_f = torch.where(flip[..., None], -wi, wi)
    vh = normalize(torch.stack([alpha_u * wi_f[..., 0],
                                alpha_v * wi_f[..., 1], wi_f[..., 2]], -1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = 1.0 / safe_sqrt(torch.clamp(lensq, min=1e-20))
    t1 = torch.where((lensq > 1e-20)[..., None],
                     torch.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len,
                                  torch.zeros_like(inv_len)], -1),
                     vh.new_tensor([1.0, 0.0, 0.0]).expand(vh.shape))
    t2 = torch.linalg.cross(vh, t1, dim=-1)
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - p1 * p1) + s * p2
    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + safe_sqrt(1.0 - p1 * p1 - p2 * p2)[..., None] * vh)
    m = normalize(torch.stack([alpha_u * nh[..., 0], alpha_v * nh[..., 1],
                               torch.clamp(nh[..., 2], min=1e-6)], -1))
    return torch.where(flip[..., None], -m, m)


def pdf_visible(wi, m, alpha_u, alpha_v, dist_type):
    """pdf of sample_visible: G1(wi, m) |wi·m| D(m) / |cosθi|
    (microfacet.h:240 pdfVisible)."""
    cos_i = torch.abs(wi[..., 2])
    side = torch.sign(wi[..., 2])[..., None]
    g1 = smith_g1(wi, m * side, alpha_u, alpha_v, dist_type)
    d = eval_d(m * side, alpha_u, alpha_v, dist_type)
    return g1 * torch.abs(dot(wi, m)) * d / torch.clamp(cos_i, min=1e-12)


def sample_all(u, alpha_u, alpha_v, dist_type):
    """Classic D·cosθ sampling (microfacet.h, sampleVisible=false);
    anisotropy by the per-phi roughness. Returns m."""
    alpha_u = clamp_alpha(alpha_u)
    alpha_v = clamp_alpha(alpha_v)
    phi = 2.0 * math.pi * u[..., 1]
    cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)
    u0 = torch.clamp(u[..., 0], min=1e-7)
    alpha = safe_sqrt(cos_phi ** 2 * alpha_u ** 2
                      + sin_phi ** 2 * alpha_v ** 2)
    tan2_ggx = alpha ** 2 * u0 / torch.clamp(1.0 - u0, min=1e-7)
    tan2_beck = -alpha ** 2 * torch.log(torch.clamp(1.0 - u0, min=1e-38))
    tan2 = torch.where(dist_type == GGX, tan2_ggx, tan2_beck)
    cos_theta = 1.0 / torch.sqrt(1.0 + tan2)
    sin_theta = safe_sqrt(1.0 - cos_theta ** 2)
    return torch.stack([sin_theta * cos_phi, sin_theta * sin_phi,
                        cos_theta], dim=-1)


def pdf_all(m, alpha_u, alpha_v, dist_type):
    """pdf of sample_all: D(m) cosθ."""
    return eval_d(m, alpha_u, alpha_v, dist_type) * torch.abs(m[..., 2])
