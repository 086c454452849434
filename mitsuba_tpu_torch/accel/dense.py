"""Plain exhaustive ray-triangle intersector: the plain PyTorch version of
the CUDA trace kernel (port of mitsuba_tpu/accel/dense.py).

Each triangle carries the inverse affine map M⁻¹ to its unit-triangle frame
(Woop's transform, columns [e1, e2, n] at p0). For a ray (o, d):

    o' = M⁻¹ (o - p0),  d' = M⁻¹ d
    t = -o'_z / d'_z,  u = o'_x + t d'_x,  v = o'_y + t d'_y
    hit ⇔ |d'_z| ≥ 1e-12 ∧ min(u, v, 1-u-v) ≥ 0 ∧ mint < t < maxt

The transform is written as elementwise products and sums, never a matmul,
so no TF32 or reordered dot product can creep in on the GPU. The order of
every float operation is the CUDA kernel's (csrc/trace.cu, which forbids
FMA contraction), so on the same card the two give bit-equal hits. The
closest hit keeps the lowest triangle index among equal t.
"""
from __future__ import annotations

import numpy as np
import torch

from ..scene.scene import Intersection, SceneData

_DZ_EPS = 1e-12
MISS = 1e30       # t reported for a miss (the kernel's value)
_CHUNK = 256      # triangles per step of the plain intersector


def build_woop(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
    """Host-side Woop transforms → (woop_o [4, 3T], woop_d [3, 3T]) f32.
    Column 3t+k holds row k of triangle t's M⁻¹ (woop_o adds the affine
    row). Degenerate triangles map every ray to "parallel" (d'_z = 0,
    o'_z = 1), so they never hit."""
    t = p0.shape[0]
    n = np.cross(e1, e2)
    m = np.stack([e1, e2, n], axis=-1)      # [T, 3, 3] cols e1, e2, n
    good = np.linalg.norm(n, axis=-1) > 1e-18
    m_safe = np.where(good[:, None, None], m, np.eye(3)[None])
    minv = np.where(good[:, None, None], np.linalg.inv(m_safe), 0.0)
    trans = -np.einsum("tij,tj->ti", minv, p0)
    trans = np.where(good[:, None], trans, np.array([0.0, 0.0, 1.0]))
    woop_d = minv.transpose(0, 2, 1).transpose(1, 0, 2).reshape(3, t * 3)
    woop_o = np.concatenate([woop_d, trans.reshape(-1)[None, :]], axis=0)
    return (np.ascontiguousarray(woop_o, np.float32),
            np.ascontiguousarray(woop_d, np.float32))


def intersect_soup(o, d, woop_o, mint, maxt, live=None):
    """Closest hit of N rays [N, 3] against every triangle of woop_o.

    Triangles are tested _CHUNK at a time to bound the [N, _CHUNK] working
    set. `live` [N] bool: dead lanes report a miss. Returns (t [N] (MISS on
    a miss), tri [N] int64 (0 on a miss), u [N], v [N], hit [N] bool)."""
    n = o.shape[0]
    w = woop_o.view(4, -1, 3)                         # [j, T, k]
    ox, oy, oz = (o[:, i, None, None] for i in range(3))
    dx, dy, dz = (d[:, i, None, None] for i in range(3))
    lo, hi = mint[:, None], maxt[:, None]
    t_best = torch.full((n,), float("inf"), device=o.device)
    u_best = torch.zeros(n, device=o.device)
    v_best = torch.zeros(n, device=o.device)
    tri_best = torch.zeros(n, dtype=torch.int64, device=o.device)
    for base in range(0, w.shape[1], _CHUNK):
        wc = w[:, base:base + _CHUNK]                  # [4, Tc, 3]
        op = ox * wc[0] + oy * wc[1] + oz * wc[2] + wc[3]   # [N, Tc, 3]
        dp = dx * wc[0] + dy * wc[1] + dz * wc[2]
        dpz = dp[..., 2]
        parallel = torch.abs(dpz) < _DZ_EPS
        t = -op[..., 2] / torch.where(parallel, _DZ_EPS, dpz)
        u = op[..., 0] + t * dp[..., 0]
        v = op[..., 1] + t * dp[..., 1]
        inside = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
        hit = ~parallel & (inside >= 0.0) & (t > lo) & (t < hi)
        tm = torch.where(hit, t, float("inf"))
        idx = torch.argmin(tm, dim=1, keepdim=True)   # first of equal t
        t_c = tm.gather(1, idx)[:, 0]
        closer = t_c < t_best
        t_best = torch.where(closer, t_c, t_best)
        u_best = torch.where(closer, u.gather(1, idx)[:, 0], u_best)
        v_best = torch.where(closer, v.gather(1, idx)[:, 0], v_best)
        tri_best = torch.where(closer, idx[:, 0] + base, tri_best)
    hit = torch.isfinite(t_best)
    if live is not None:
        hit = hit & live
    zero = torch.zeros_like(t_best)
    return (torch.where(hit, t_best, MISS),
            torch.where(hit, tri_best, 0),
            torch.where(hit, u_best, zero), torch.where(hit, v_best, zero),
            hit)


def fill_intersection(scene: SceneData, o, d, t, u, v, tri_id, hit
                      ) -> Intersection:
    """Hit record from one gather of the packed tri_attr rows; shading
    normal and uv barycentric-interpolated."""
    bary = torch.stack([1.0 - u - v, u, v], dim=-1)    # [N, 3]
    tri_c = torch.where(hit, tri_id, 0).long()
    attr = scene.tri_attr[tri_c]                        # [N, 24]
    ng = attr[:, 0:3]
    vn = attr[:, 3:12].reshape(-1, 3, 3)
    vuv = attr[:, 12:18].reshape(-1, 3, 2)
    ns = torch.sum(vn * bary[..., None], dim=-2)
    ns = ns * torch.rsqrt(torch.clamp(
        torch.sum(ns * ns, dim=-1, keepdim=True), min=1e-20))
    uv = torch.sum(vuv * bary[..., None], dim=-2)
    t_safe = torch.where(hit, t, torch.ones_like(t))
    p = o + t_safe[:, None] * d
    none = torch.full_like(tri_c, -1)
    return Intersection(
        valid=hit, t=t, p=p, ng=ng, ns=ns, uv=uv, tri_id=tri_c,
        mat_id=torch.where(hit, attr[:, 18].long(), none),
        em_id=torch.where(hit, attr[:, 19].long(), none))


def ray_intersect(scene: SceneData, o, d, mint, maxt, live=None
                  ) -> Intersection:
    """Closest-hit scene intersection with the plain intersector."""
    t, tri, u, v, hit = intersect_soup(o, d, scene.woop_o, mint, maxt, live)
    return fill_intersection(scene, o, d, t, u, v, tri, hit)


def ray_test(scene: SceneData, o, d, mint, maxt, live=None):
    """Shadow-ray predicate: any hit within (mint, maxt). [N] bool."""
    return intersect_soup(o, d, scene.woop_o, mint, maxt, live)[4]
