"""4x4 homogeneous transforms (host-side numpy — scene-compile time only).

Counterpart of the reference's Transform (ref: include/mitsuba/core/
transform.h — 4x4 matrix + cached inverse). Scene compilation bakes all
object-to-world transforms into flattened vertex/ray data, so at render time
no transform objects exist on device; these helpers are plain numpy used by
the scene builder and sensors.
"""
from __future__ import annotations

import numpy as np


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def translate(v) -> np.ndarray:
    m = identity()
    m[:3, 3] = v
    return m


def scale(v) -> np.ndarray:
    v = np.broadcast_to(np.asarray(v, np.float64), (3,))
    m = identity()
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def rotate(axis, angle_deg: float) -> np.ndarray:
    """Rotation about an axis, angle in degrees (transform.h rotate)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    s, c = np.sin(np.radians(angle_deg)), np.cos(np.radians(angle_deg))
    x, y, z = a
    k = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    r = np.eye(3) + s * k + (1 - c) * (k @ k)
    m = identity()
    m[:3, :3] = r
    return m


def look_at(origin, target, up) -> np.ndarray:
    """Camera-to-world: +z forward, +y up, +x left-handed-consistent with the
    reference (transform.h lookAt — Mitsuba cameras look down +z)."""
    origin = np.asarray(origin, np.float64)
    d = np.asarray(target, np.float64) - origin
    d = d / np.linalg.norm(d)
    left = np.cross(np.asarray(up, np.float64), d)
    n = np.linalg.norm(left)
    if n < 1e-12:
        raise ValueError("look_at: up is collinear with view direction")
    left /= n
    new_up = np.cross(d, left)
    m = identity()
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = origin
    return m


def perspective(fov_deg: float, near: float, far: float) -> np.ndarray:
    """Perspective projection matching the reference sensor's conventions
    (transform.h perspective — maps view frustum to [0,1] clip z)."""
    recip = 1.0 / (far - near)
    cot = 1.0 / np.tan(np.radians(fov_deg) / 2.0)
    m = np.array([
        [cot, 0, 0, 0],
        [0, cot, 0, 0],
        [0, 0, far * recip, -near * far * recip],
        [0, 0, 1, 0],
    ], dtype=np.float64)
    return m


def apply_point(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    p = np.asarray(p, np.float64)
    ph = np.concatenate([p, np.ones(p.shape[:-1] + (1,))], axis=-1)
    r = ph @ m.T
    return r[..., :3] / r[..., 3:4]


def apply_vector(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    return np.asarray(v, np.float64) @ m[:3, :3].T


def apply_normal(m: np.ndarray, n: np.ndarray) -> np.ndarray:
    inv_t = np.linalg.inv(m[:3, :3]).T
    return np.asarray(n, np.float64) @ inv_t.T
