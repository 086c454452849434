"""Host-side shape -> triangle mesh generators (copy of the Mesh,
rectangle, cube and sphere parts of mitsuba_tpu/scene/shapes.py). Every
shape is compiled to triangles at scene-build time."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Mesh:
    """Indexed triangle mesh, object space."""
    vertices: np.ndarray            # [V, 3] float64
    faces: np.ndarray               # [F, 3] int64
    normals: np.ndarray | None = None   # [V, 3] shading normals
    uvs: np.ndarray | None = None       # [V, 2]


def rectangle() -> Mesh:
    """Unit rectangle in the xy-plane spanning [-1,1]², normal +z
    (ref: src/shapes/rectangle.cpp)."""
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], float)
    f = np.array([[0, 1, 2], [2, 3, 0]])
    n = np.tile([0.0, 0.0, 1.0], (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], float)
    return Mesh(v, f, n, uv)


def cube() -> Mesh:
    """Axis-aligned cube spanning [-1,1]³, outward normals
    (ref: src/shapes/cube.cpp)."""
    verts, faces, normals, uvs = [], [], [], []
    axes = [(0, 1, 2), (1, 2, 0), (2, 0, 1)]
    idx = 0
    for ax, (a, b, c) in enumerate(axes):
        for s in (-1.0, 1.0):
            corners = []
            for (ua, ub) in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = np.zeros(3)
                p[c] = s
                p[a] = ua * s  # flip winding with side for outward normals
                p[b] = ub
                corners.append(p)
            n = np.zeros(3)
            n[c] = s
            verts.extend(corners)
            normals.extend([n] * 4)
            uvs.extend([[0, 0], [1, 0], [1, 1], [0, 1]])
            faces.append([idx, idx + 1, idx + 2])
            faces.append([idx + 2, idx + 3, idx])
            idx += 4
    return Mesh(np.array(verts), np.array(faces), np.array(normals),
                np.array(uvs, float))


def sphere(subdiv_theta: int = 32, subdiv_phi: int = 64) -> Mesh:
    """UV sphere of radius 1 at origin (ref: src/shapes/sphere.cpp —
    analytic there; tessellated here with exact shading normals so the
    shading-normal interpolation recovers the smooth appearance)."""
    th = np.linspace(0.0, np.pi, subdiv_theta + 1)
    ph = np.linspace(0.0, 2 * np.pi, subdiv_phi + 1)
    tg, pg = np.meshgrid(th, ph, indexing="ij")
    x = np.sin(tg) * np.cos(pg)
    y = np.sin(tg) * np.sin(pg)
    z = np.cos(tg)
    v = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    uv = np.stack([pg / (2 * np.pi), 1.0 - tg / np.pi], -1).reshape(-1, 2)
    faces = []
    w = subdiv_phi + 1
    for i in range(subdiv_theta):
        for j in range(subdiv_phi):
            a, b = i * w + j, i * w + j + 1
            c, d = (i + 1) * w + j, (i + 1) * w + j + 1
            if i > 0:
                faces.append([a, c, b])
            if i < subdiv_theta - 1:
                faces.append([b, c, d])
    return Mesh(v, np.array(faces), v.copy(), uv)
