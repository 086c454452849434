"""Warps from the unit square, with pdfs (port of mitsuba_tpu/core/warp.py,
the subset the Cornell path uses)."""
from __future__ import annotations

import math

import torch

from .math import safe_sqrt

INV_PI = float(1.0 / math.pi)


def square_to_uniform_disk_concentric(u):
    """Shirley-Chiu concentric disk, branchless select form."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    is_zero = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    one = torch.ones_like(ox)
    ratio = torch.where(
        use_x, oy / torch.where(ox == 0, one, ox),
        ox / torch.where(oy == 0, one, oy))
    ratio = torch.where(is_zero, torch.zeros_like(ratio), ratio)
    phi = torch.where(use_x, ratio * (math.pi / 4.0),
                      (math.pi / 2.0) - ratio * (math.pi / 4.0))
    r = torch.where(is_zero, torch.zeros_like(r), r)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_cosine_hemisphere(u):
    """Cosine-weighted hemisphere via concentric disk + lift."""
    p = square_to_uniform_disk_concentric(u)
    z = safe_sqrt(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2)
    return torch.stack([p[..., 0], p[..., 1], z], dim=-1)


def square_to_cosine_hemisphere_pdf(d):
    """pdf = cosθ/π on the hemisphere (0 below)."""
    return torch.clamp(d[..., 2], min=0.0) * INV_PI


def square_to_uniform_triangle(u):
    """Barycentric warp (b0 = 1-sqrt(1-u0), b1 = u1*sqrt(1-u0))."""
    t = safe_sqrt(1.0 - u[..., 0])
    return torch.stack([1.0 - t, u[..., 1] * t], dim=-1)


INV_FOUR_PI = float(1.0 / (4.0 * math.pi))


def square_to_uniform_sphere(u):
    """Area-preserving lat-long warp (warp.h:43)."""
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
