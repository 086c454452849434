"""Geometry-driven textures: wireframe / vertexcolors / curvature / scale
(port of mitsuba_tpu/texture/geomtex.py: numpy bakes at scene-build time).

The reference evaluates these per-intersection from mesh data (ref:
src/textures/wireframe.cpp, vertexcolors.cpp, curvature.cpp, scale.cpp).
Here every texture is a bitmap lookup from the mip-pool (texture.py), so
these compile to bitmaps + a per-corner UV rewrite at scene-build time —
zero extra runtime cost, and one branchless code path for the wavefront:

  * `wireframe`: all triangles share ONE barycentric-space pattern bitmap
    (the edge-distance field is a function of the barycentrics alone);
    the mesh is de-indexed so each corner maps to (0,0)/(1,0)/(0,1).
    World-space lineWidth is converted to a barycentric fraction with the
    mesh's mean edge height (the reference's auto width is 10% of the
    mean edge length — wireframe.cpp:73).
  * `vertexcolors`: each triangle gets a 2×2-texel atlas block with
    corner colors (c0, c1, c2, c1+c2−c0); bilinear interpolation of that
    block reproduces barycentric interpolation EXACTLY (the uv-space
    lerp is linear, and v11 cancels the bilinear cross term), so the
    bake is not an approximation at the finest mip level.
  * `curvature`: discrete per-vertex curvature (angle-deficit Gaussian /
    cotangent-Laplacian mean) → the reference's red/blue ramp
    (curvature.cpp lookupGradient: v>0 → red=min(v·scale,1), v<0 →
    blue=min(−v·scale,1)) → baked through the vertexcolors path.
  * `scale`: folded at compile time (multiply the nested bitmap or the
    constant — scale.cpp is a pure multiplier).
"""
from __future__ import annotations

import numpy as np

from ..scene.shapes import Mesh


# ---------------------------------------------------------------------------
# wireframe
# ---------------------------------------------------------------------------

def deindex_barycentric(mesh: Mesh) -> Mesh:
    """De-index a mesh so each face corner has its own vertex, with corner
    uvs (0,0)/(1,0)/(0,1) — interpolated uv == the hit's barycentrics."""
    v = np.asarray(mesh.vertices, float)[np.asarray(mesh.faces).reshape(-1)]
    f = np.arange(len(v), dtype=np.int64).reshape(-1, 3)
    n = None
    if mesh.normals is not None:
        n = np.asarray(mesh.normals, float)[
            np.asarray(mesh.faces).reshape(-1)]
    uv = np.tile(np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
                 (len(f), 1))
    return Mesh(v, f, n, uv)


def _mean_edge_height(mesh: Mesh) -> float:
    """Mean distance from a vertex to its opposite edge (converts a
    world-space line width into a barycentric fraction)."""
    v = np.asarray(mesh.vertices, float)
    f = np.asarray(mesh.faces)
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    area2 = np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
    edges = np.stack([np.linalg.norm(p2 - p1, axis=-1),
                      np.linalg.norm(p0 - p2, axis=-1),
                      np.linalg.norm(p1 - p0, axis=-1)])
    h = area2 / np.maximum(edges, 1e-12)          # [3, F] heights
    return float(np.mean(h)) if h.size else 1.0


def wireframe_pattern(mesh: Mesh, interior=(0.5, 0.5, 0.5),
                      edge=(0.1, 0.1, 0.1), line_width: float = 0.0,
                      step_width: float = 0.5, res: int = 256
                      ) -> np.ndarray:
    """Barycentric-space wireframe bitmap shared by every triangle
    (ref: src/textures/wireframe.cpp eval — smoothstep edge-distance
    field; lineWidth 0 → 10% of the mean edge length, :73)."""
    v = np.asarray(mesh.vertices, float)
    f = np.asarray(mesh.faces)
    if line_width <= 0.0:
        e = np.concatenate([
            np.linalg.norm(v[f[:, 1]] - v[f[:, 0]], axis=-1),
            np.linalg.norm(v[f[:, 2]] - v[f[:, 1]], axis=-1),
            np.linalg.norm(v[f[:, 0]] - v[f[:, 2]], axis=-1)])
        line_width = 0.1 * float(np.mean(e)) if e.size else 0.1
    step_width = min(max(step_width, 0.0), 1.0)
    h = _mean_edge_height(mesh)

    interior = np.broadcast_to(np.asarray(interior, np.float32), (3,))
    edge = np.broadcast_to(np.asarray(edge, np.float32), (3,))
    uu, vv = np.meshgrid((np.arange(res) + 0.5) / res,
                         (np.arange(res) + 0.5) / res, indexing="xy")
    # mirror the upper-right half so padding/bilinear tails stay sane
    # (barycentric uv always lands in u+v<=1)
    over = uu + vv > 1.0
    u = np.where(over, 1.0 - uu, uu)
    w = np.where(over, 1.0 - vv, vv)
    b_min = np.minimum(np.minimum(u, w), 1.0 - u - w)
    dist = np.maximum(b_min, 0.0) * h          # ~world distance to edge
    lo = line_width * (1.0 - step_width)
    t = np.clip((dist - lo) / max(line_width - lo, 1e-9), 0.0, 1.0)
    a = (t * t * (3.0 - 2.0 * t))[..., None]   # smoothStep
    img = edge * (1.0 - a) + interior * a
    # image row 0 is v=1 in uv space (texture.py flips v)
    return img[::-1].astype(np.float32)


# ---------------------------------------------------------------------------
# vertexcolors (exact linear bake)
# ---------------------------------------------------------------------------

def bake_vertex_colors(mesh: Mesh, colors: np.ndarray
                       ) -> tuple[np.ndarray, Mesh]:
    """Bake per-vertex colors into a 2×2-block atlas + a rewritten mesh
    (ref: src/textures/vertexcolors.cpp — eval returns its.color).

    Returns (atlas_image [H, W, 3], mesh') where rendering mesh' with the
    atlas as albedo texture reproduces barycentric vertex-color
    interpolation exactly (see module docstring)."""
    colors = np.asarray(colors, np.float32)
    f = np.asarray(mesh.faces)
    nf = len(f)
    c0, c1, c2 = colors[f[:, 0]], colors[f[:, 1]], colors[f[:, 2]]

    bw = max(1, int(np.ceil(np.sqrt(nf))))
    bh = -(-nf // bw)
    W, H = 2 * bw, 2 * bh
    atlas = np.zeros((H, W, 3), np.float32)
    k = np.arange(nf)
    bx, by = (k % bw) * 2, (k // bw) * 2
    # image row r holds uv_y = 1 - (r + 0.5)/H; write with y measured
    # from the BOTTOM so uv math below stays in one convention
    yb0 = H - 1 - by          # bottom row of the block in image coords
    atlas[yb0, bx] = c0
    atlas[yb0, bx + 1] = c1
    atlas[yb0 - 1, bx] = c2
    atlas[yb0 - 1, bx + 1] = c1 + c2 - c0      # cancels the cross term

    # corner uvs at the texel centers (texture.py: fx = u·W − 0.5)
    def uv_at(tx, ty):
        return np.stack([(tx + 0.5) / W, (ty + 0.5) / H], axis=-1)

    uv0 = uv_at(bx.astype(float), by.astype(float))
    uv1 = uv_at(bx + 1.0, by.astype(float))
    uv2 = uv_at(bx.astype(float), by + 1.0)

    v = np.asarray(mesh.vertices, float)[f.reshape(-1)]
    nf3 = np.arange(len(v), dtype=np.int64).reshape(-1, 3)
    n = None
    if mesh.normals is not None:
        n = np.asarray(mesh.normals, float)[f.reshape(-1)]
    uv = np.stack([uv0, uv1, uv2], axis=1).reshape(-1, 2)
    return atlas, Mesh(v, nf3, n, uv)


# ---------------------------------------------------------------------------
# curvature
# ---------------------------------------------------------------------------

def vertex_curvature(mesh: Mesh) -> tuple[np.ndarray, np.ndarray]:
    """Discrete per-vertex (mean H, Gaussian K) curvature.

    Angle-deficit Gaussian + cotangent-Laplacian mean curvature over the
    mixed vertex area — the standard discrete analog of the reference's
    shape-operator eigenvalues (TriMesh::getCurvature via dndu/dndv)."""
    v = np.asarray(mesh.vertices, float)
    f = np.asarray(mesh.faces)
    nv = len(v)
    angle_sum = np.zeros(nv)
    area = np.zeros(nv)
    lap = np.zeros((nv, 3))

    p = [v[f[:, i]] for i in range(3)]
    for i in range(3):
        a, b, c = p[i], p[(i + 1) % 3], p[(i + 2) % 3]
        e1, e2 = b - a, c - a
        cosang = np.sum(e1 * e2, axis=-1) / np.maximum(
            np.linalg.norm(e1, axis=-1) * np.linalg.norm(e2, axis=-1),
            1e-20)
        ang = np.arccos(np.clip(cosang, -1.0, 1.0))
        np.add.at(angle_sum, f[:, i], ang)
        tri_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        np.add.at(area, f[:, i], tri_area / 3.0)
        # cot at corner i weights the OPPOSITE edge (b, c)
        sinang = np.sqrt(np.maximum(1.0 - cosang ** 2, 1e-20))
        cot = cosang / sinang
        np.add.at(lap, f[:, (i + 1) % 3], 0.5 * cot[:, None] * (c - b))
        np.add.at(lap, f[:, (i + 2) % 3], 0.5 * cot[:, None] * (b - c))

    area = np.maximum(area, 1e-20)
    K = (2.0 * np.pi - angle_sum) / area
    hn = lap / area[:, None]      # Laplace-Beltrami Δp = 2H·n
    H = 0.5 * np.linalg.norm(hn, axis=-1)
    # sign of H from the vertex normal direction when available
    if mesh.normals is not None:
        s = np.sign(np.sum(hn * np.asarray(mesh.normals, float), axis=-1))
        H = H * np.where(s == 0.0, 1.0, s)
    return H, K


def curvature_colors(mesh: Mesh, curvature: str = "gaussian",
                     scale: float = 1.0) -> np.ndarray:
    """Per-vertex curvature → the reference's ramp (curvature.cpp
    lookupGradient): v>0 → red=min(v·scale,1); v<0 → blue=min(−v·scale,1).
    Feed the result to `bake_vertex_colors`."""
    H, K = vertex_curvature(mesh)
    val = K if curvature == "gaussian" else H
    out = np.zeros((len(val), 3), np.float32)
    out[:, 0] = np.clip(val * scale, 0.0, 1.0)
    out[:, 2] = np.clip(-val * scale, 0.0, 1.0)
    return out


def bake_curvature(mesh: Mesh, curvature: str = "gaussian",
                   scale: float = 1.0) -> tuple[np.ndarray, Mesh]:
    """curvature texture, one call: atlas + rewritten mesh."""
    return bake_vertex_colors(mesh, curvature_colors(mesh, curvature,
                                                     scale))


# ---------------------------------------------------------------------------
# scale
# ---------------------------------------------------------------------------

def scale_texture(nested, scale) -> np.ndarray:
    """Compile-time fold of the scale adapter (ref: src/textures/
    scale.cpp — pure multiplication of the nested texture/constant)."""
    return (np.asarray(nested, np.float32)
            * np.asarray(scale, np.float32)).astype(np.float32)
