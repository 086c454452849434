"""Scene builder: declarative scene description → compiled SceneData on one
device (port of mitsuba_tpu/scene/builder.py, the part the port renders:
triangle meshes, the 14 leaf BSDF families with the two-sided adapter,
area emitters).

All transform work is host-side float64; device tensors are float32, as in
the JAX package, so both builders produce the same arrays. A description
that asks for something the port lacks raises NotImplementedError naming
it; nothing is silently dropped.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..accel.dense import build_woop
from ..accel.trace import (ORDER_MAX_CLUSTERS, TRIS_PER_CLUSTER,
                           build_cluster_aabbs, build_cluster_order,
                           build_woop_clustered)
from ..core import transform as tf
from ..core.distribution import Discrete1D
from ..device import resolve_device
from . import scene as S
from .shapes import Mesh


@dataclass
class Material:
    """BSDF description. The port compiles the leaf kinds of _KINDS, each
    optionally two-sided; parameters and defaults are the JAX builder's
    (each plugin's Properties defaults)."""
    kind: str = "diffuse"
    albedo: Sequence[float] = (0.5, 0.5, 0.5)       # diffuse/roughdiffuse
    eta: Sequence[float] | float = (0.2004, 0.9240, 1.1022)  # conductor (Cu)
    k: Sequence[float] = (3.9129, 2.4528, 2.1421)
    specular_reflectance: Sequence[float] = (1.0, 1.0, 1.0)
    specular_transmittance: Sequence[float] = (1.0, 1.0, 1.0)
    diffuse_reflectance: Sequence[float] = (0.5, 0.5, 0.5)
    alpha: float = 0.1
    alpha_v: Optional[float] = None
    distribution: str = "ggx"                         # "beckmann"|"ggx"
    int_ior: float = 1.5046                           # dielectric (BK7)
    ext_ior: float = 1.000277                         # air
    exponent: float = 30.0                            # phong
    nonlinear: bool = False                           # plastic
    albedo_texture: int = -1
    roughness_texture: int = -1
    two_sided: bool = False                           # twosided adapter
    normal_texture: int = -1
    bump_scale: float = 0.0
    transmittance: Sequence[float] = (0.5, 0.5, 0.5)  # difftrans
    moments0: Sequence[float] = (0.0, 0.0)   # aniso_roughdiffuse: mean
    #   slope (E[x], E[y]) of the LEADR Gaussian slope distribution
    moments1: Sequence[float] = (0.5, 0.5, 0.0)  # (E[x²], E[y²], E[xy])
    sample_visibility: bool = True           # Smith G2 shadowing on/off

    _KINDS = {"diffuse": S.MAT_DIFFUSE, "conductor": S.MAT_CONDUCTOR,
              "roughconductor": S.MAT_ROUGH_CONDUCTOR,
              "dielectric": S.MAT_DIELECTRIC, "plastic": S.MAT_PLASTIC,
              "roughdielectric": S.MAT_ROUGH_DIELECTRIC,
              "roughplastic": S.MAT_ROUGH_PLASTIC, "phong": S.MAT_PHONG,
              "ward": S.MAT_WARD, "roughdiffuse": S.MAT_ROUGH_DIFFUSE,
              "null": S.MAT_NULL, "thindielectric": S.MAT_THIN_DIELECTRIC,
              "difftrans": S.MAT_DIFFTRANS,
              "aniso_roughdiffuse": S.MAT_ANISO_ROUGHDIFFUSE}

    def compile(self):
        """→ (type code, param row [24] f32, texture slots [2] i32), the
        JAX builder's row."""
        if self.kind not in self._KINDS:
            raise NotImplementedError(
                f"material kind {self.kind!r}: the port has "
                f"{sorted(self._KINDS)}")
        for name, unset in (("albedo_texture", -1), ("roughness_texture", -1),
                            ("normal_texture", -1), ("bump_scale", 0.0)):
            if getattr(self, name) != unset:
                raise NotImplementedError(
                    f"material {name}: textures and normal/bump maps are "
                    "not ported")
        code = self._KINDS[self.kind]
        p = np.zeros(S.N_MAT_PARAMS, np.float32)
        dist = 1.0 if self.distribution == "ggx" else 0.0
        av = self.alpha if self.alpha_v is None else self.alpha_v
        if code in (S.MAT_DIFFUSE, S.MAT_ROUGH_DIFFUSE):
            p[0:3] = self.albedo
            p[9] = self.alpha
        elif code in (S.MAT_CONDUCTOR, S.MAT_ROUGH_CONDUCTOR):
            p[0:3] = self.eta if not np.isscalar(self.eta) else [self.eta] * 3
            p[3:6] = self.k
            p[6:9] = self.specular_reflectance
            p[9], p[10], p[11] = self.alpha, av, dist
        elif code in (S.MAT_DIELECTRIC, S.MAT_ROUGH_DIELECTRIC,
                      S.MAT_THIN_DIELECTRIC):
            p[0] = self.int_ior / self.ext_ior
            p[1:4] = self.specular_reflectance
            p[4:7] = self.specular_transmittance
            p[9], p[10], p[11] = self.alpha, av, dist
        elif code in (S.MAT_PLASTIC, S.MAT_ROUGH_PLASTIC):
            p[0] = self.int_ior / self.ext_ior
            p[1:4] = self.diffuse_reflectance
            p[4:7] = self.specular_reflectance
            p[7] = float(self.nonlinear)
            p[9], p[10], p[11] = self.alpha, av, dist
        elif code == S.MAT_PHONG:
            p[0:3] = self.diffuse_reflectance
            p[3:6] = self.specular_reflectance
            p[6] = self.exponent
        elif code == S.MAT_WARD:
            p[0:3] = self.diffuse_reflectance
            p[3:6] = self.specular_reflectance
            p[9], p[10] = self.alpha, av
        elif code == S.MAT_DIFFTRANS:
            p[0:3] = self.transmittance
        elif code == S.MAT_ANISO_ROUGHDIFFUSE:
            p[0:3] = self.albedo
            p[3:5] = self.moments0
            p[5:8] = self.moments1
            p[11] = float(self.sample_visibility)
        # dispatch metadata packed into the row (scene.py layout)
        p[12] = float(code)
        p[13], p[14] = -1.0, -1.0
        p[15] = float(self.two_sided)
        p[16] = -1.0
        return code, p, np.array([-1, -1], np.int32)


@dataclass
class ShapeInstance:
    """A mesh placed in the world with a material and optional emission."""
    mesh: Mesh
    to_world: np.ndarray = field(default_factory=tf.identity)
    material: int = 0
    radiance: Optional[Sequence[float]] = None  # area emitter if set
    sampling_weight: float = 1.0
    flip_normals: bool = False


@dataclass
class SceneDesc:
    materials: list = field(default_factory=list)
    shapes: list = field(default_factory=list)

    def add_material(self, **kw) -> int:
        self.materials.append(Material(**kw))
        return len(self.materials) - 1

    def add_shape(self, mesh, to_world=None, material=0, radiance=None,
                  sampling_weight=1.0, flip_normals=False):
        self.shapes.append(ShapeInstance(
            mesh, tf.identity() if to_world is None else to_world,
            material, radiance, sampling_weight, flip_normals))
        return len(self.shapes) - 1


def _spread3(x):
    """Spread the low 10 bits of x to every 3rd bit (Morton interleave)."""
    x = x.astype(np.uint64)
    x = (x | (x << 16)) & np.uint64(0x030000FF)
    x = (x | (x << 8)) & np.uint64(0x0300F00F)
    x = (x | (x << 4)) & np.uint64(0x030C30C3)
    x = (x | (x << 2)) & np.uint64(0x09249249)
    return x


def morton_order(p0, e1, e2) -> np.ndarray:
    """Stable permutation sorting triangles along a 30-bit Morton curve of
    their centroids, so consecutive trace clusters are spatially compact
    and the kernel's cluster AABB gate rejects most of them."""
    c = np.asarray(p0, np.float64) + (np.asarray(e1, np.float64)
                                      + np.asarray(e2, np.float64)) / 3.0
    lo = c.min(0)
    ext = np.maximum(c.max(0) - lo, 1e-30)
    q = np.minimum(((c - lo) / ext * 1023.0), 1023.0).astype(np.uint64)
    code = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << np.uint64(1))
            | (_spread3(q[:, 2]) << np.uint64(2)))
    return np.argsort(code, kind="stable")


def _mesh_arrays(shape: ShapeInstance):
    """World-space triangle arrays of one shape instance."""
    mesh = shape.mesh
    v = tf.apply_point(shape.to_world, mesh.vertices)
    f = mesh.faces
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    e1, e2 = p1 - p0, p2 - p0
    ng = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(ng, axis=-1)
    ngn = ng / np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
    if shape.flip_normals:
        ngn = -ngn
    if mesh.normals is not None:
        n_w = tf.apply_normal(shape.to_world, mesh.normals)
        n_w = n_w / np.maximum(
            np.linalg.norm(n_w, axis=-1, keepdims=True), 1e-20)
        if shape.flip_normals:
            n_w = -n_w
        vn = np.stack([n_w[f[:, k]] for k in range(3)], axis=1)
    else:
        vn = np.repeat(ngn[:, None, :], 3, axis=1)
    if mesh.uvs is not None:
        vuv = np.stack([mesh.uvs[f[:, k]] for k in range(3)], axis=1)
    else:
        vuv = np.zeros((len(f), 3, 2))
    return p0, e1, e2, ngn, vn, vuv, area


def compile_scene(desc: SceneDesc, cluster_size: int = 512,
                  device="cuda") -> S.SceneData:
    """Bake the description into SceneData on `device` (the GPU unless
    the caller passes device="cpu"). The triangle count is padded to a
    multiple of `cluster_size` with degenerate triangles that never hit."""
    dev = resolve_device(device)
    if not desc.materials:
        desc.materials.append(Material())

    cols = [[] for _ in range(7)]       # p0 e1 e2 ng vn vuv area
    tri_mats, tri_ems = [], []
    emitters, em_tri_lists = [], []
    base = 0
    for shape in desc.shapes:
        arrs = _mesh_arrays(shape)
        n_f = len(arrs[0])
        em_id = -1
        if shape.radiance is not None:
            em_id = len(emitters)
            emitters.append((np.asarray(shape.radiance, np.float64),
                             float(arrs[6].sum()), shape.sampling_weight))
            em_tri_lists.append((np.arange(base, base + n_f), arrs[6]))
        for col, a in zip(cols, arrs):
            col.append(a)
        tri_mats.append(np.full(n_f, shape.material, np.int32))
        tri_ems.append(np.full(n_f, em_id, np.int32))
        base += n_f
    if base:
        p0, e1, e2, ng, vn, vuv, tri_area = (np.concatenate(c) for c in cols)
        tri_mat, tri_em = np.concatenate(tri_mats), np.concatenate(tri_ems)
    else:
        p0 = e1 = e2 = ng = np.zeros((0, 3))
        vn, vuv = np.zeros((0, 3, 3)), np.zeros((0, 3, 2))
        tri_mat = tri_em = np.zeros(0, np.int32)
        tri_area = np.zeros(0)

    # Morton order above 256 triangles; small scenes keep author order
    if len(p0) > 256:
        order = morton_order(p0, e1, e2)
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        p0, e1, e2, ng = p0[order], e1[order], e2[order], ng[order]
        vn, vuv = vn[order], vuv[order]
        tri_mat, tri_em, tri_area = (tri_mat[order], tri_em[order],
                                     tri_area[order])
        em_tri_lists = [(inv[t], a) for t, a in em_tri_lists]

    # pad the soup to a cluster_size multiple with degenerate triangles
    n_tris = len(p0)
    pad = max(cluster_size, -(-max(n_tris, 1) // cluster_size)
              * cluster_size) - n_tris
    if pad:
        p0 = np.concatenate([p0, np.full((pad, 3), 1e30)])
        e1 = np.concatenate([e1, np.zeros((pad, 3))])
        e2 = np.concatenate([e2, np.zeros((pad, 3))])
        ng = np.concatenate([ng, np.tile([0.0, 0.0, 1.0], (pad, 1))])
        vn = np.concatenate([vn, np.tile([0.0, 0.0, 1.0], (pad, 3, 1))])
        vuv = np.concatenate([vuv, np.zeros((pad, 3, 2))])
        tri_mat = np.concatenate([tri_mat, np.zeros(pad, np.int32)])
        tri_em = np.concatenate([tri_em, np.full(pad, -1, np.int32)])
        tri_area = np.concatenate([tri_area, np.zeros(pad)])

    woop_o, woop_d = build_woop(p0, e1, e2)
    woop_clusters = build_woop_clustered(woop_o, TRIS_PER_CLUSTER)
    # AABBs over real triangles only (pads would inflate the last box)
    cluster_aabb = build_cluster_aabbs(p0[:n_tris], e1[:n_tris],
                                       e2[:n_tris], TRIS_PER_CLUSTER,
                                       woop_clusters.shape[0])
    if 8 <= woop_clusters.shape[0] <= ORDER_MAX_CLUSTERS:
        cl_meta, cl_order, cl_odist = build_cluster_order(cluster_aabb)
    else:
        cl_meta = cl_order = cl_odist = None

    n_tp = len(p0)
    tri_attr = np.zeros((n_tp, 24), np.float32)
    tri_attr[:, 0:3] = ng
    tri_attr[:, 3:12] = vn.reshape(n_tp, 9)
    tri_attr[:, 12:18] = vuv.reshape(n_tp, 6)
    tri_attr[:, 18] = tri_mat
    tri_attr[:, 19] = tri_em

    # area emitters: per-emitter area CDFs, "globalized" (index + cdf)
    n_em = len(emitters)
    em_pmf = Discrete1D.build(
        np.array([e[2] for e in emitters]) if n_em else np.ones(1), dev)
    tris_flat, cdfg_flat, offs = [], [], [0]
    for ei, (tris, areas) in enumerate(em_tri_lists):
        cdf = np.cumsum(areas) / areas.sum()
        cdf[-1] = 1.0
        tris_flat.append(tris)
        cdfg_flat.append(ei + cdf)
        offs.append(offs[-1] + len(tris))
    em_tris = (np.concatenate(tris_flat).astype(np.int32) if tris_flat
               else np.zeros(0, np.int32))
    em_tri_cdfg = (np.concatenate(cdfg_flat).astype(np.float32)
                   if cdfg_flat else np.zeros(0, np.float32))
    em_tri_data = (np.concatenate([p0[em_tris], e1[em_tris], e2[em_tris],
                                   ng[em_tris]], axis=1)
                   if len(em_tris) else np.zeros((1, 12)))

    mats = [m.compile() for m in desc.materials]

    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    i32 = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=dev)
    opt = lambda x, conv: None if x is None else conv(x)
    return S.SceneData(
        p0=f32(p0), e1=f32(e1), e2=f32(e2), ng=f32(ng), vn=f32(vn),
        vuv=f32(vuv), tri_mat=i32(tri_mat), tri_em=i32(tri_em),
        tri_area=f32(tri_area),
        woop_o=f32(woop_o), woop_d=f32(woop_d),
        woop_clusters=f32(woop_clusters), tri_attr=f32(tri_attr),
        mat_type=i32([m[0] for m in mats]),
        mat_params=f32(np.stack([m[1] for m in mats])),
        mat_tex=i32(np.stack([m[2] for m in mats])),
        em_type=i32(np.full(n_em, S.EM_AREA)),
        em_radiance=f32(np.reshape([e[0] for e in emitters], (n_em, 3))),
        em_pos=f32(np.zeros((n_em, 3))),
        em_area=f32([e[1] for e in emitters]),
        em_pmf=em_pmf, em_tri_offset=i32(offs), em_tris=i32(em_tris),
        em_tri_cdfg=f32(em_tri_cdfg), em_tri_data=f32(em_tri_data),
        em_aux=f32(np.zeros((n_em, 8))),
        tex_data=f32(np.zeros((1, 3))), tex_meta=i32(np.zeros((1, 4))),
        env_id=i32(-1), env_img=f32(np.zeros((1, 1, 3))),
        env_row_cdf=f32([0.0, 1.0]), env_col_cdf=f32([[0.0, 1.0]]),
        env_density=f32(np.ones((1, 1))),
        med_sigma_t=f32(np.zeros((1, 3))), med_albedo=f32(np.zeros((1, 3))),
        med_g=f32(np.zeros(1)), med_bound=f32(np.full(1, 1e30)),
        has_medium=torch.tensor(False, device=dev),
        med_grid=f32(np.zeros((1, 1, 1))), med_grid_min=f32(np.zeros(3)),
        med_grid_extent=f32(np.ones(3)), med_majorant=f32(0.0),
        med_sggx=f32(np.zeros(6)), med_fiber=f32(np.zeros(3)),
        cluster_aabb=f32(cluster_aabb),
        cluster_meta=opt(cl_meta, f32), cluster_order=opt(cl_order, i32),
        cluster_odist=opt(cl_odist, f32), n_real_tris=n_tris,
    )
