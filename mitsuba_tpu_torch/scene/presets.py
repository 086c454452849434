"""Built-in scenes: the Cornell box (copy of mitsuba_tpu/scene/presets.py).

White/red/green diffuse walls, two rotated boxes, one area light, in the
classic Cornell coordinates scaled to the unit box.
"""
from __future__ import annotations

import numpy as np

from ..core import transform as tf
from .builder import SceneDesc
from .shapes import Mesh


def _quad(p0, p1, p2, p3) -> Mesh:
    """Quad from 4 corners (ccw), geometric normals only."""
    v = np.array([p0, p1, p2, p3], float)
    f = np.array([[0, 1, 2], [2, 3, 0]])
    return Mesh(v, f)


def _box(minc, maxc, rot_deg=0.0, center=None) -> Mesh:
    """Axis-aligned box optionally rotated about +y around its base center."""
    mn, mx = np.asarray(minc, float), np.asarray(maxc, float)
    corners = np.array([[x, y, z] for x in (mn[0], mx[0])
                        for y in (mn[1], mx[1]) for z in (mn[2], mx[2])])
    # faces with outward winding
    quads = [
        (0, 1, 3, 2), (4, 6, 7, 5),  # x- x+
        (0, 4, 5, 1), (2, 3, 7, 6),  # y- y+
        (0, 2, 6, 4), (1, 5, 7, 3),  # z- z+
    ]
    faces = []
    for (a, b, c, d) in quads:
        faces.append([a, b, c])
        faces.append([c, d, a])
    v = corners
    if rot_deg:
        ctr = center if center is not None else (mn + mx) / 2 * [1, 0, 1]
        r = tf.rotate([0, 1, 0], rot_deg)[:3, :3]
        v = (v - ctr) @ r.T + ctr
    return Mesh(v, np.array(faces))


def cornell_box(light_radiance=(18.4, 15.6, 8.0)) -> SceneDesc:
    """The Cornell box, unit-scale ([0,1]³-ish), camera looks down -z.

    Walls: white floor/ceiling/back, red left (x=0), green right (x=1).
    Two rotated boxes. Area light slightly below the ceiling.
    """
    d = SceneDesc()
    white = d.add_material(kind="diffuse", albedo=(0.725, 0.71, 0.68))
    red = d.add_material(kind="diffuse", albedo=(0.63, 0.065, 0.05))
    green = d.add_material(kind="diffuse", albedo=(0.14, 0.45, 0.091))

    # Box interior spanning [0,1]x[0,1]x[0,1]; camera outside at +z
    # floor (y=0, normal +y)
    d.add_shape(_quad([0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 0, 0]),
                material=white)
    # ceiling (y=1, normal -y)
    d.add_shape(_quad([0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1]),
                material=white)
    # back wall (z=0, normal +z)
    d.add_shape(_quad([0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]),
                material=white)
    # left wall (x=0, normal +x) — red
    d.add_shape(_quad([0, 0, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1]),
                material=red)
    # right wall (x=1, normal -x) — green
    d.add_shape(_quad([1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0]),
                material=green)

    # tall box (left-back), rotated ~18°
    d.add_shape(_box([0.10, 0.0, 0.12], [0.43, 0.60, 0.45], rot_deg=17.0),
                material=white)
    # short box (right-front), rotated ~-17°
    d.add_shape(_box([0.53, 0.0, 0.50], [0.86, 0.30, 0.83], rot_deg=-17.0),
                material=white)

    # area light: small quad below ceiling, emitting downward (normal -y)
    lx0, lx1, lz0, lz1, ly = 0.37, 0.63, 0.35, 0.62, 0.999
    d.add_shape(_quad([lx0, ly, lz0], [lx1, ly, lz0],
                      [lx1, ly, lz1], [lx0, ly, lz1]),
                material=white, radiance=light_radiance)
    return d


def cornell_camera(width=256, height=256, fov=39.0):
    """Standard Cornell viewpoint for the unit box."""
    from ..sensor.sensor import PerspectiveCamera
    to_world = tf.look_at(origin=[0.5, 0.5, 2.45], target=[0.5, 0.5, 0.0],
                          up=[0, 1, 0])
    return PerspectiveCamera(width=width, height=height, fov_x=fov,
                             to_world=to_world)
