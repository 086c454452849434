"""Perspective camera, pinhole and thin lens (port of the PerspectiveCamera
of mitsuba_tpu/sensor/sensor.py). `sample_ray` maps continuous pixel
coordinates [N, 2] and aperture samples to world-space rays on the device
of its inputs."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import transform as tf
from ..core.math import normalize
from ..core.warp import square_to_uniform_disk_concentric


def _apply(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v @ m.T for v [N, 3], as elementwise sums (no TF32 matmul)."""
    return (v[..., 0:1] * m[:, 0] + v[..., 1:2] * m[:, 1]
            + v[..., 2:3] * m[:, 2])


@dataclass(frozen=True, eq=False)
class PerspectiveCamera:
    """fov_x in degrees along the width axis; aperture_radius > 0 turns on
    the thin lens focused at focus_distance."""
    width: int = 256
    height: int = 256
    fov_x: float = 39.0
    to_world: np.ndarray = field(default_factory=tf.identity)
    aperture_radius: float = 0.0
    focus_distance: float = 1.0

    def sample_ray(self, pixel_xy, aperture_uv=None):
        """pixel_xy: [N, 2] in [0,W)x[0,H), row 0 = image top. Returns
        (o [N,3], d [N,3]) world-space, d normalized. The camera frame is
        (left, up, forward), so image-left maps to +x."""
        dev = pixel_xy.device
        tan_half = float(np.float32(np.tan(np.radians(self.fov_x) / 2.0)))
        aspect = float(np.float32(self.height / self.width))
        r = torch.as_tensor(self.to_world[:3, :3], dtype=torch.float32,
                            device=dev)
        t = torch.as_tensor(self.to_world[:3, 3], dtype=torch.float32,
                            device=dev)
        ndc_x = 1.0 - (pixel_xy[..., 0] / self.width) * 2.0
        ndc_y = 1.0 - (pixel_xy[..., 1] / self.height) * 2.0
        dx = ndc_x * tan_half
        dy = ndc_y * tan_half * aspect
        d_local = torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)
        o_local = torch.zeros_like(d_local)
        if self.aperture_radius > 0.0 and aperture_uv is not None:
            p_focus = d_local * self.focus_distance
            lens = square_to_uniform_disk_concentric(aperture_uv)
            lens = lens * self.aperture_radius
            o_local = torch.stack(
                [lens[..., 0], lens[..., 1], torch.zeros_like(lens[..., 0])],
                dim=-1)
            d_local = p_focus - o_local
        return _apply(r, o_local) + t, normalize(_apply(r, d_local))
