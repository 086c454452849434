"""Vector math and shading frames (port of mitsuba_tpu/core/math.py).

A vector is a tensor whose last axis has size 3; every op broadcasts over
the leading (wavefront) axes.
"""
from __future__ import annotations

import torch

SHADOW_EPSILON = 1e-3   # shadow-ray clipping (ref scene.cpp:846)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis."""
    return torch.sum(a * b, dim=-1)


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Safe normalize: a/|a|; zero vectors map to zero."""
    l2 = torch.sum(a * a, dim=-1, keepdim=True)
    return a * torch.rsqrt(torch.clamp(l2, min=1e-30))


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_div(a, b, eps: float = 1e-8):
    """a/b with |b| < eps clamped to ±eps (sign kept)."""
    small = torch.abs(b) < eps
    guard = torch.where(b < 0, torch.full_like(b, -eps),
                        torch.full_like(b, eps))
    return a / torch.where(small, guard, b)


def coordinate_system(n: torch.Tensor):
    """Branchless orthonormal basis (Duff et al. 2017) from a unit normal.
    Returns (s, t) with [s, t, n] right-handed."""
    nx, ny, nz = n.unbind(-1)
    sign = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    t = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return s, t


class Frame:
    """Shading frame as a tuple of three direction tensors (s, t, n)."""

    @staticmethod
    def from_normal(n: torch.Tensor):
        s, t = coordinate_system(n)
        return s, t, n

    @staticmethod
    def to_local(frame, v: torch.Tensor) -> torch.Tensor:
        s, t, n = frame
        return torch.stack([dot(v, s), dot(v, t), dot(v, n)], dim=-1)

    @staticmethod
    def to_world(frame, v: torch.Tensor) -> torch.Tensor:
        s, t, n = frame
        return s * v[..., 0:1] + t * v[..., 1:2] + n * v[..., 2:3]


def reflect(wi: torch.Tensor) -> torch.Tensor:
    """Mirror reflection about +z in the local frame (ref: conductor.cpp
    `reflect`)."""
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)


def refract_local(wi: torch.Tensor, eta, cos_theta_t) -> torch.Tensor:
    """Local-frame refraction given the transmitted cosine (ref: util.cpp
    refract / dielectric.cpp). eta = int_ior/ext_ior; cos_theta_t carries
    the sign of the transmitted side."""
    scale = torch.where(cos_theta_t < 0, 1.0 / eta, eta)
    return torch.stack([-scale * wi[..., 0], -scale * wi[..., 1],
                        cos_theta_t], dim=-1)
