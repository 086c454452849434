"""Reconstruction filters (port of mitsuba_tpu/film/rfilter.py; ref:
src/rfilters/*.cpp, rfilter.h).

Each filter is (radius, eval(x)) with x the 1D offset from the sample, in
closed form on float32 tensors. All separable, as in the reference.
"""
from __future__ import annotations

import math

import torch

BOX = 0
TENT = 1
GAUSSIAN = 2
MITCHELL = 3
CATMULLROM = 4
LANCZOS = 5

RADIUS = {
    BOX: 0.5,
    TENT: 1.0,
    GAUSSIAN: 2.0,
    MITCHELL: 2.0,
    CATMULLROM: 2.0,
    LANCZOS: 3.0,
}

NAMES = {"box": BOX, "tent": TENT, "gaussian": GAUSSIAN,
         "mitchell": MITCHELL, "catmullrom": CATMULLROM, "lanczos": LANCZOS}


def _mitchell_ab(x, b, c):
    ax = torch.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    p1 = ((12 - 9 * b - 6 * c) * ax3 + (-18 + 12 * b + 6 * c) * ax2
          + (6 - 2 * b)) / 6.0
    p2 = ((-b - 6 * c) * ax3 + (6 * b + 30 * c) * ax2
          + (-12 * b - 48 * c) * ax + (8 * b + 24 * c)) / 6.0
    return torch.where(ax < 1.0, p1, torch.where(ax < 2.0, p2, 0.0))


def eval_filter(ftype: int, x: torch.Tensor) -> torch.Tensor:
    """1D filter weight at offsets x (a float32 tensor)."""
    ax = torch.abs(x)
    if ftype == BOX:
        return torch.where(ax <= 0.5, 1.0, 0.0)
    if ftype == TENT:
        return torch.clamp(1.0 - ax, min=0.0)
    if ftype == GAUSSIAN:
        # alpha=2, truncated at r=2 and shifted to zero there (gaussian.cpp)
        alpha = 2.0
        base = math.exp(-alpha * 4.0)
        return torch.clamp(torch.exp(-alpha * x * x) - base, min=0.0)
    if ftype == MITCHELL:
        return _mitchell_ab(x, 1.0 / 3.0, 1.0 / 3.0)
    if ftype == CATMULLROM:
        return _mitchell_ab(x, 0.0, 0.5)
    if ftype == LANCZOS:
        # sinc(x)·sinc(x/3), 3-lobe (lanczos.cpp)
        px = math.pi * torch.clamp(ax, min=1e-6)
        val = (torch.sin(px) / px) * (torch.sin(px / 3.0) / (px / 3.0))
        return torch.where(ax < 1e-6, 1.0, torch.where(ax <= 3.0, val, 0.0))
    raise ValueError(f"unknown filter {ftype}")
