"""Sensors (port of mitsuba_tpu/sensor/sensor.py): the perspective camera
(pinhole and thin lens, with the light tracer's `project`), orthographic,
spherical, telecentric and radially distorted cameras, and the radiance,
irradiance and fluence meters. `sample_ray` maps continuous pixel
coordinates [N, 2] and aperture samples [N, 2] to world-space rays on the
device of its inputs. Rotations apply as elementwise sums (`_apply`), not
matmuls, so no TF32 rounding enters on the card."""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import transform as tf
from ..core.math import normalize
from ..core.warp import (square_to_cosine_hemisphere,
                         square_to_uniform_disk_concentric,
                         square_to_uniform_sphere)


def _apply(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v @ m.T for v [N, 3], as elementwise sums (no TF32 matmul)."""
    return (v[..., 0:1] * m[:, 0] + v[..., 1:2] * m[:, 1]
            + v[..., 2:3] * m[:, 2])


def _rt(to_world, dev):
    """to_world's rotation [3, 3] and translation [3] on `dev`."""
    return (torch.as_tensor(to_world[:3, :3], dtype=torch.float32,
                            device=dev),
            torch.as_tensor(to_world[:3, 3], dtype=torch.float32,
                            device=dev))


def _film_plane(cam, pixel_xy):
    """The image plane's [-1, 1]² coordinates of pixel positions: x from
    image-left (+1) to image-right, y from the top (+1) down."""
    return (1.0 - (pixel_xy[..., 0] / cam.width) * 2.0,
            1.0 - (pixel_xy[..., 1] / cam.height) * 2.0)


def _forward(like):
    """+z [N, 3] shaped like `like`."""
    return torch.stack([torch.zeros_like(like), torch.zeros_like(like),
                        torch.ones_like(like)], dim=-1)


def _lens(aperture_uv, radius):
    """A concentric-disk point of the aperture, [N, 3] at z = 0."""
    lens = square_to_uniform_disk_concentric(aperture_uv) * radius
    return torch.stack([lens[..., 0], lens[..., 1],
                        torch.zeros_like(lens[..., 0])], dim=-1)


@dataclass(frozen=True, eq=False)
class PerspectiveCamera:
    """fov_x in degrees along the width axis; aperture_radius > 0 turns on
    the thin lens focused at focus_distance. `project` sees points past
    near_clip."""
    width: int = 256
    height: int = 256
    fov_x: float = 39.0
    to_world: np.ndarray = field(default_factory=tf.identity)
    aperture_radius: float = 0.0
    focus_distance: float = 1.0
    near_clip: float = 1e-2

    def _tan_aspect(self):
        return (float(np.float32(np.tan(np.radians(self.fov_x) / 2.0))),
                float(np.float32(self.height / self.width)))

    def sample_ray(self, pixel_xy, aperture_uv=None):
        """pixel_xy: [N, 2] in [0,W)x[0,H), row 0 = image top. Returns
        (o [N,3], d [N,3]) world-space, d normalized. The camera frame is
        (left, up, forward), so image-left maps to +x."""
        tan_half, aspect = self._tan_aspect()
        r, t = _rt(self.to_world, pixel_xy.device)
        ndc_x, ndc_y = _film_plane(self, pixel_xy)
        dx = ndc_x * tan_half
        dy = ndc_y * tan_half * aspect
        d_local = torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)
        o_local = torch.zeros_like(d_local)
        if self.aperture_radius > 0.0 and aperture_uv is not None:
            p_focus = d_local * self.focus_distance
            o_local = _lens(aperture_uv, self.aperture_radius)
            d_local = p_focus - o_local
        return _apply(r, o_local) + t, normalize(_apply(r, d_local))

    def project(self, p_world):
        """World points [N, 3] → (raster positions [N, 2], visible [N]
        bool, importance W [N]): W = 1 / (A cos³θ), A the image plane's
        area at unit distance, so that splatting W-weighted particle
        contributions gives radiance in the eye paths' units."""
        tan_half, aspect = self._tan_aspect()
        r, t = _rt(self.to_world, p_world.device)
        local = _apply(r.T, p_world - t)    # r orthonormal: inverse = r.T
        z = local[..., 2]
        visible = z > self.near_clip
        zs = torch.clamp(z, min=1e-6)
        x = local[..., 0] / zs
        y = local[..., 1] / zs
        px = (1.0 - x / tan_half) * 0.5 * self.width
        py = (1.0 - y / (tan_half * aspect)) * 0.5 * self.height
        visible = (visible & (px >= 0) & (px < self.width) & (py >= 0)
                   & (py < self.height))
        area = 4.0 * tan_half * (tan_half * aspect)
        cos_theta = zs * torch.rsqrt(
            torch.clamp((local * local).sum(-1), min=1e-12))
        w = 1.0 / torch.clamp(area * cos_theta ** 3, min=1e-9)
        return torch.stack([px, py], dim=-1), visible, w

    def position(self, device="cuda"):
        """The camera's origin [3] on `device`."""
        return _rt(self.to_world, torch.device(device))[1]

    @property
    def n_pixels(self):
        return self.width * self.height


@dataclass(frozen=True, eq=False)
class OrthographicCamera:
    """Orthographic sensor: the image plane spans [-1, 1]² in local xy
    before to_world's scale."""
    width: int = 256
    height: int = 256
    to_world: np.ndarray = field(default_factory=tf.identity)

    def sample_ray(self, pixel_xy, aperture_uv=None):
        r, t = _rt(self.to_world, pixel_xy.device)
        x, y = _film_plane(self, pixel_xy)
        o_local = torch.stack([x, y, torch.zeros_like(x)], dim=-1)
        return (_apply(r, o_local) + t,
                normalize(_apply(r, _forward(x))))

    @property
    def n_pixels(self):
        return self.width * self.height


@dataclass(frozen=True, eq=False)
class RadianceMeter:
    """One ray: the radiance arriving at to_world's origin along its +z
    axis. Renders as a 1×1 film."""
    width: int = 1
    height: int = 1
    to_world: np.ndarray = field(default_factory=tf.identity)

    def sample_ray(self, pixel_xy, aperture_uv=None):
        r, t = _rt(self.to_world, pixel_xy.device)
        n = pixel_xy.shape[0]
        return (t.expand(n, 3).clone(),
                normalize(r[:, 2][None, :]).expand(n, 3).clone())

    @property
    def n_pixels(self):
        return 1


@dataclass(frozen=True, eq=False)
class IrradianceMeter:
    """Cosine-weighted rays over to_world's +z hemisphere, drawn from the
    aperture sample (0.5, 0.5 without one); the 1×1 film's mean times π
    estimates the irradiance E."""
    width: int = 1
    height: int = 1
    to_world: np.ndarray = field(default_factory=tf.identity)

    def sample_ray(self, pixel_xy, aperture_uv=None):
        r, t = _rt(self.to_world, pixel_xy.device)
        n = pixel_xy.shape[0]
        u = aperture_uv if aperture_uv is not None else \
            torch.full((n, 2), 0.5, device=pixel_xy.device)
        d_local = square_to_cosine_hemisphere(u)
        return t.expand(n, 3).clone(), normalize(_apply(r, d_local))

    @property
    def n_pixels(self):
        return 1


@dataclass(frozen=True, eq=False)
class SphericalCamera:
    """Lat-long 360° sensor: x spans the azimuth, y the polar angle from
    the local +y axis."""
    width: int = 512
    height: int = 256
    to_world: np.ndarray = field(default_factory=tf.identity)

    def sample_ray(self, pixel_xy, aperture_uv=None):
        r, t = _rt(self.to_world, pixel_xy.device)
        phi = (1.0 - pixel_xy[..., 0] / self.width) * 2.0 * math.pi
        theta = (pixel_xy[..., 1] / self.height) * math.pi
        st = torch.sin(theta)
        d_local = torch.stack([st * torch.sin(phi), torch.cos(theta),
                               -st * torch.cos(phi)], dim=-1)
        return (t.expand(d_local.shape).clone(),
                normalize(_apply(r, d_local)))

    @property
    def n_pixels(self):
        return self.width * self.height


@dataclass(frozen=True, eq=False)
class TelecentricCamera:
    """Telecentric lens: orthographic chief rays through a thin lens of
    aperture_radius focused at focus_distance (no aperture: the
    orthographic camera)."""
    width: int = 256
    height: int = 256
    to_world: np.ndarray = field(default_factory=tf.identity)
    aperture_radius: float = 0.0
    focus_distance: float = 1.0

    def sample_ray(self, pixel_xy, aperture_uv=None):
        r, t = _rt(self.to_world, pixel_xy.device)
        x, y = _film_plane(self, pixel_xy)
        o_local = torch.stack([x, y, torch.zeros_like(x)], dim=-1)
        d_local = _forward(x)
        if self.aperture_radius > 0.0 and aperture_uv is not None:
            focus = o_local + d_local * self.focus_distance
            o_local = o_local + _lens(aperture_uv, self.aperture_radius)
            d_local = focus - o_local
        return _apply(r, o_local) + t, normalize(_apply(r, d_local))

    @property
    def n_pixels(self):
        return self.width * self.height


@dataclass(frozen=True, eq=False)
class PerspectiveRDistCamera:
    """Perspective sensor with two-term radial distortion: the image-plane
    point scales by 1 + kc0·r² + kc1·r⁴ before the ray is formed."""
    width: int = 256
    height: int = 256
    fov_x: float = 39.0
    to_world: np.ndarray = field(default_factory=tf.identity)
    kc0: float = 0.0
    kc1: float = 0.0

    def sample_ray(self, pixel_xy, aperture_uv=None):
        tan_half = float(np.float32(np.tan(np.radians(self.fov_x) / 2.0)))
        aspect = float(np.float32(self.height / self.width))
        r, t = _rt(self.to_world, pixel_xy.device)
        ndc_x, ndc_y = _film_plane(self, pixel_xy)
        dx = ndc_x * tan_half
        dy = ndc_y * tan_half * aspect
        r2 = dx * dx + dy * dy
        factor = 1.0 + self.kc0 * r2 + self.kc1 * r2 * r2
        d_local = torch.stack([dx * factor, dy * factor,
                               torch.ones_like(dx)], dim=-1)
        return (t.expand(d_local.shape).clone(),
                normalize(_apply(r, d_local)))

    @property
    def n_pixels(self):
        return self.width * self.height


@dataclass(frozen=True, eq=False)
class FluenceMeter:
    """Rays over the whole sphere at to_world's origin, drawn from the
    aperture sample (0.5, 0.5 without one); the 1×1 film's mean times 4π
    estimates the fluence."""
    width: int = 1
    height: int = 1
    to_world: np.ndarray = field(default_factory=tf.identity)

    def sample_ray(self, pixel_xy, aperture_uv=None):
        _, t = _rt(self.to_world, pixel_xy.device)
        n = pixel_xy.shape[0]
        u = aperture_uv if aperture_uv is not None else \
            torch.full((n, 2), 0.5, device=pixel_xy.device)
        return t.expand(n, 3).clone(), square_to_uniform_sphere(u)

    @property
    def n_pixels(self):
        return 1
