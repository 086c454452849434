"""Shared integrator machinery: MIS weights, ray offsets, RNG dim layout
(port of mitsuba_tpu/integrator/common.py)."""
from __future__ import annotations

import torch

from ..core.math import dot

# RNG dimension layout (core/rng.py counter scheme):
#   dims 0..3 reserved for the sensor (pixel jitter, aperture, time)
#   per-bounce block of DIMS_PER_BOUNCE starting at SENSOR_DIMS
SENSOR_DIMS = 4
DIM_PIXEL = 0
DIM_APERTURE = 1
DIM_TIME = 2

DIMS_PER_BOUNCE = 8
DIM_NEE_SEL = 0      # emitter pick (1D)
DIM_NEE_POS = 1      # emitter position/direction (2D)
DIM_BSDF_U2 = 2      # bsdf 2D sample
DIM_BSDF_U1 = 3      # bsdf component pick (1D)
DIM_RR = 4           # russian roulette (1D)
DIM_MEDIUM = 5       # medium channel + distance (2D)
DIM_PHASE = 6        # phase direction (2D)
# dim 7 reserved


def bounce_dim(bounce, offset):
    return SENSOR_DIMS + bounce * DIMS_PER_BOUNCE + offset


def mis_power(pdf_a, pdf_b):
    """Power heuristic β=2 in ratio form 1/(1 + (b/a)²), ratio clamped
    (ref: path.cpp:385-388 miWeight)."""
    r = torch.clamp(pdf_b / torch.clamp(pdf_a, min=1e-6), 0.0, 1e6)
    return torch.where(pdf_a > 0, 1.0 / (1.0 + r * r), 0.0)


def offset_ray_origin(p, ng, d):
    """Offset a secondary-ray origin out of the surface along the geometric
    normal, on the side of the outgoing direction (ref: skdtree.cpp:127)."""
    scale = 1.0 + torch.amax(torch.abs(p), dim=-1)
    eps = (1e-4 * scale)[..., None]
    side = torch.sign(dot(d, ng))[..., None]
    return p + side * eps * ng


def ray_mint(p):
    """Minimum hit distance for secondary rays, scaled to scene magnitude."""
    return 1e-4 * (1.0 + torch.amax(torch.abs(p), dim=-1))


def tile_lanes(x, k: int):
    """x [N, ...] repeated k times along dim 0: lane j·N + i is x[i]."""
    return x.repeat(k, *([1] * (x.dim() - 1)))
