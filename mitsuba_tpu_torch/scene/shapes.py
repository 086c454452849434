"""Host-side shape -> triangle mesh generators (copy of the Mesh,
rectangle, cube, sphere, disk, cylinder and heightfield parts of
mitsuba_tpu/scene/shapes.py). Every shape is compiled to triangles at
scene-build time. The JAX module's hair, shape groups and instances,
deformable meshes and shell-mapped heightfields are not ported."""
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
    colors: np.ndarray | None = None    # [V, 3] linear vertex colors
    #   (consumed by texture/geomtex.py bake_vertex_colors — the
    #   vertexcolors texture analog; ref: src/textures/vertexcolors.cpp)


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


def disk(subdiv: int = 64) -> Mesh:
    """Unit disk in the xy-plane, normal +z (ref: src/shapes/disk.cpp)."""
    ang = np.linspace(0, 2 * np.pi, subdiv, endpoint=False)
    rim = np.stack([np.cos(ang), np.sin(ang), np.zeros(subdiv)], -1)
    v = np.concatenate([[[0.0, 0.0, 0.0]], rim])
    f = [[0, 1 + i, 1 + (i + 1) % subdiv] for i in range(subdiv)]
    n = np.tile([0.0, 0.0, 1.0], (subdiv + 1, 1))
    uv = 0.5 * (v[:, :2] + 1.0)
    return Mesh(v, np.array(f), n, uv)


def cylinder(subdiv: int = 64) -> Mesh:
    """Open cylinder along z from 0 to 1, radius 1
    (ref: src/shapes/cylinder.cpp)."""
    ang = np.linspace(0, 2 * np.pi, subdiv, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang)], -1)
    bot = np.concatenate([ring, np.zeros((subdiv, 1))], -1)
    top = np.concatenate([ring, np.ones((subdiv, 1))], -1)
    v = np.concatenate([bot, top])
    n = np.concatenate([np.concatenate([ring, np.zeros((subdiv, 1))], -1)] * 2)
    uv = np.concatenate(
        [np.stack([ang / (2 * np.pi), np.zeros(subdiv)], -1),
         np.stack([ang / (2 * np.pi), np.ones(subdiv)], -1)])
    f = []
    for i in range(subdiv):
        j = (i + 1) % subdiv
        f.append([i, j, subdiv + i])
        f.append([j, subdiv + j, subdiv + i])
    return Mesh(v, np.array(f), n, uv)


def heightfield(heights: np.ndarray, flip_normals: bool = False) -> Mesh:
    """Regular-grid heightfield spanning [-1,1]² in xy with z = h(x, y)
    (ref: src/shapes/heightfield.cpp — winmad's 2D-SAH-quadtree shape;
    here compiled to triangles for the wavefront intersector like every
    other shape; the reference's lod/tiled/composite variants map to
    building this mesh from a chosen mip level of the height texture).

    heights: [H, W] float array of surface heights.
    """
    hts = np.asarray(heights, np.float64)
    hh, ww = hts.shape
    xs = np.linspace(-1.0, 1.0, ww)
    ys = np.linspace(-1.0, 1.0, hh)
    xg, yg = np.meshgrid(xs, ys, indexing="xy")
    v = np.stack([xg, yg, hts], axis=-1).reshape(-1, 3)
    uv = np.stack([(xg + 1) / 2, (yg + 1) / 2], -1).reshape(-1, 2)

    # central-difference shading normals (ref heightfield.cpp derivatives)
    dx = np.gradient(hts, xs, axis=1)
    dy = np.gradient(hts, ys, axis=0)
    n = np.stack([-dx, -dy, np.ones_like(hts)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    if flip_normals:
        n = -n
    n = n.reshape(-1, 3)

    idx = np.arange(hh * ww).reshape(hh, ww)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel()
    d = idx[1:, 1:].ravel()
    f = np.concatenate([np.stack([a, b, d], -1), np.stack([d, c, a], -1)])
    return Mesh(v, f, n, uv)
