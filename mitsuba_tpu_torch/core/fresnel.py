"""Fresnel reflectance for dielectrics and conductors (port of
mitsuba_tpu/core/fresnel.py: fresnel_dielectric and
fresnel_conductor_exact), branchless, with the JAX package's clamps."""
from __future__ import annotations

import torch


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized Fresnel for a dielectric interface. cos_theta_i may be
    signed (negative: arriving from inside); eta = int_ior/ext_ior > 0.
    Returns (F, cos_theta_t, eta_it, eta_ti); cos_theta_t carries the
    transmitted side's sign (ref: util.h:473 fresnelDielectricExt)."""
    eta = torch.clamp(eta, min=1e-3)
    outside = cos_theta_i >= 0.0
    eta_it = torch.where(outside, eta, 1.0 / eta)
    eta_ti = 1.0 / eta_it
    cos_i = torch.abs(cos_theta_i)
    sin_t2 = eta_ti * eta_ti * (1.0 - cos_i * cos_i)
    tir = sin_t2 >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t2, min=1e-12))
    cos_t = torch.where(tir, 0.0, cos_t)
    rs = (cos_i - eta_it * cos_t) / torch.clamp(cos_i + eta_it * cos_t,
                                                min=1e-4)
    rp = (eta_it * cos_i - cos_t) / torch.clamp(eta_it * cos_i + cos_t,
                                                min=1e-4)
    f = torch.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
    cos_theta_t = torch.where(tir, 0.0, torch.where(outside, -cos_t, cos_t))
    return f, cos_theta_t, eta_it, eta_ti


def fresnel_conductor_exact(cos_theta_i, eta, k):
    """Exact unpolarized conductor Fresnel (ref: util.h:544-567). eta, k
    [..., 3] spectra; cos_theta_i [...] gets a channel axis appended."""
    c = torch.clamp(cos_theta_i, min=0.0)[..., None]
    c2 = c * c
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2pb2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * e2 * k2, min=1e-12))
    t1 = a2pb2 + c2
    a = torch.sqrt(torch.clamp(0.5 * (a2pb2 + t0), min=1e-12))
    t2 = 2.0 * a * c
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-6)
    t3 = c2 * a2pb2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-6)
    return 0.5 * (rp + rs)
