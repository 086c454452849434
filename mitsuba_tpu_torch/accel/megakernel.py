"""Path-tracing megakernels: one bounce, whole paths, or a pixel's whole
sample loop in one CUDA kernel (port of mitsuba_tpu/accel/megakernel.py:
pinhole or thin-lens camera, flat or smooth shading normals, the 14 leaf
BSDF families with the two-sided adapter, the composites over leaf
children, area, point, spot and directional emitters and the constant
environment, the global homogeneous medium, and the analytic checker and
grid albedo of textures with procedural provenance).

Three entry points share one device bounce (csrc/megakernel.cu):

  run_bounce      one bounce per launch             (make_bounce_kernel)
  run_path        up to n_bounces per lane          (make_path_kernel)
  run_persistent  `spp` whole paths per lane, with in-kernel camera-ray
                  regeneration                      (make_persistent_kernel)

Each runs the kernel for CUDA tensors and its plain version for CPU
tensors; there is no fallback. The plain version of the bounce is
MegaPlainTracer: the port's eager wavefront bounce (VolPathTracer(accel=
"plain"), which is integrator/path.py's bounce with the medium's hooks)
whose shading tail runs this module's
plain versions of the JAX megakernel's device BSDF helpers
(bsdf_eval_pdf, bsdf_sample) on the tables' material rows, the forms the
kernel computes (with the composites, composite_eval_pdf and
composite_sample), so kernel and plain version agree lane by lane; its
NEE over every emitter type and the sky on escape are the eager ones
(emitter/emitter.py), which the kernel follows op for op. When the
tables carry a medium, its hooks (integrator/volpath.py) take the JAX
megakernel's forms of the medium terms (medium_segment, hg_value,
hg_sample_kernel); MegaPlainTracer counts attempted shadow rays, as the
kernel does. When the tables carry procedural textures (MegaTables.
textured), its material rows take proc_albedo, the analytic bilinear
checker or grid at the hit's uv, in columns 0-2, as the kernel's do.
`bounce_plain` is one call, `path_plain` loops it, and `persistent_plain`
runs path_plain for every sample index and sums L and the counts, which
is the persistent kernel's per-pixel estimate. The fused shade kernel
(accel/shade_kernel.py) shares the helpers and csrc/bsdf_common.cuh.

The TPU layouts that exist for VMEM and SMEM (the transposed material
table, the adaptive-tc Woop repack, the [S, B] sublane blocks) are
dropped: the tables are row-major, one row per triangle, material or
emitter, and the trace reads the scene's own woop_clusters/cluster_aabb.
Their values are the JAX package's.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..bsdf import rtrans
from ..bsdf.bsdf import COMPOSITE_FAMILIES, LEAF_FAMILIES as _LEAVES
from ..bsdf.bsdf import BSDFSample
from ..core.math import coordinate_system
from ..core.warp import INV_FOUR_PI, INV_PI, square_to_cosine_hemisphere
from ..integrator.path import initial_state, pass_bounces
from ..integrator.volpath import VolPathTracer
from ..render import sample_camera
from ..scene.scene import (MAT_ANISO_ROUGHDIFFUSE, MAT_COATING,
                           MAT_CONDUCTOR, MAT_DIELECTRIC, MAT_DIFFTRANS,
                           MAT_DIFFUSE, MAT_MIXTURE, MAT_NULL, MAT_PHONG,
                           MAT_PLASTIC, MAT_ROUGH_COATING,
                           MAT_ROUGH_CONDUCTOR, MAT_ROUGH_DIELECTRIC,
                           MAT_ROUGH_DIFFUSE, MAT_ROUGH_PLASTIC,
                           MAT_THIN_DIELECTRIC, MAT_WARD, EM_AREA, SceneData)
from . import trace

# RNG dims (mirror integrator/common.py)
SENSOR_DIMS = 4
DIMS_PER_BOUNCE = 8
DIM_NEE_SEL, DIM_NEE_POS, DIM_BSDF_U2, DIM_BSDF_U1, DIM_RR = 0, 1, 2, 3, 4
DIM_MEDIUM, DIM_PHASE = 5, 6
DIM_PIXEL = 0       # sensor jitter dim
DIM_APERTURE = 1    # thin-lens aperture dim

N_STATE = 16        # o xyz, d xyz, throughput rgb, L rgb, active,
                    # prev_pdf, prev_delta, eta_scale
N_OUT = 18          # the 16 state rows, trace count, shadow count
N_PSTATE = 24       # rows 0..15 as the bounce state; 16 bounce, 17 done,
                    # 18:21 L_sum, 21 iter diag, 22 trace count, 23 shadow

N_ATTR = 25         # per-triangle attrs: ng xyz (0:3), mat_id (3),
                    # em_id (4), vn0 xyz (5:8), vn1-vn0 (8:11),
                    # vn2-vn0 (11:14), emitter radiance rgb (14:17),
                    # emitter area (17), emitter pmf (18), uv0 (19:21),
                    # uv1-uv0 (21:23), uv2-uv0 (23:25)
TEXROW = 24         # material columns past the scene's 24 mat_params:
                    # 24 procedural-texture kind (-1: none, 0 checker,
                    # 1 grid), 25:28 color0, 28:31 color1, 31 raster
                    # resolution, 32 tiles, 33 grid line width
RTROW = TEXROW + 10  # rough-plastic transmittance: 34 internal Fdr,
RT_KNOTS = 32       # 35:67 T(cosθ) on the table's cosθ grid, 67 grid lo,
                    # 68 grid hi (bsdf/rtrans.py collapsed per material)
N_MAT = RTROW + RT_KNOTS + 3    # 69 columns: the JAX table's rows

# Kernel launches per entry point; only the wrappers below add to them.
LAUNCHES = {"mega_bounce": 0, "mega_path": 0, "mega_persistent": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# scene tables (host side)
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class MegaTables:
    """Scene tables on the scene's device, row-major for per-thread
    gathers. `scene` is the scene they were built from; `plain_scene` is
    that scene with each triangle's corner normals and uvs rebuilt as the
    kernel rebuilds them, vn0 + (vnk - vn0) and uv0 + (uvk - uv0) in
    float32 (the same values where a triangle is flat), for the plain
    versions."""
    woop: torch.Tensor       # [C, 3*64, 4] the scene's woop_clusters
    aabb: torch.Tensor       # [C, 8] the scene's cluster_aabb
    attr: torch.Tensor       # [T, N_ATTR] per triangle
    mat: torch.Tensor        # [M, N_MAT] per material
    em_rows: torch.Tensor    # [ET_pad, 24]: p0|e1|e2|ng|cdfg|area|pmf|
                             # emid|rad; rows past et_real: cdf 1e9
    em_meta: torch.Tensor    # [E_pad, 16]: cdf_lo|pmf|type|rad rgb|area|
                             # _|pos|spot axis|cos cutoff|cos width
    em_cdf: torch.Tensor     # [E+1] the emitter pick CDF (core/distribution)
    em_count: int
    n_tris: int              # real triangles (nonzero-area prefix)
    real_tris: int           # the walk's stop (trace.real_tris, checked)
    m_real: int
    et_real: int             # real emissive-triangle rows (at least 1)
    env: int                 # the constant environment's emitter row, -1
    ext: bool                # non-area emitters, composites, a medium or
                             # procedural textures: the kernels' kExt
                             # instantiations
    textured: bool           # some material's albedo is a procedural
                             # texture (TEXROW rows): the kTex
                             # instantiations (with kExt)
    medium: tuple | None     # the homogeneous medium's σt rgb, albedo
                             # rgb, g, bound (float32 values), or None
    scene: SceneData
    plain_scene: SceneData


def to_numpy(x):
    """A tensor as a host numpy array."""
    return x.detach().cpu().numpy()


def _rough_plastic_rows(row):
    """The 35 transmittance columns RTROW.. of one rough-plastic material
    row (the JAX build_mega_tables, :335-355): its internal Fdr, T(cosθ)
    at the table's 32 cosθ knots, and the knots' range."""
    eta_m = float(max(row[0], 1e-3))
    a_m = float(max(row[9], 1e-4))
    ggx = bool(row[11] == 1)
    pack = rtrans.transmittance_table(ggx)
    coss = np.asarray(pack[3], np.float32)
    out = np.zeros(RT_KNOTS + 3, np.float32)
    out[0] = 1.0 - float(rtrans.lookup_diffuse(
        rtrans.diffuse_transmittance_inv(ggx), eta_m, a_m))
    out[1:1 + RT_KNOTS] = rtrans.lookup(pack, eta_m, a_m, coss).numpy()
    out[1 + RT_KNOTS] = float(coss[0])
    out[2 + RT_KNOTS] = float(coss[-1])
    return out


def _proc_rows(proc):
    """The TEXROW columns of a checker or grid texture's provenance
    (texture.py ProcImage.proc), as the JAX build_mega_tables writes
    them (:355-372)."""
    out = np.zeros(10, np.float32)
    out[0] = {"checker": 0.0, "grid": 1.0}[proc[0]]
    out[1:4] = proc[1]
    out[4:7] = proc[2]
    out[7] = float(proc[3])
    out[8] = float(proc[4])
    out[9] = float(proc[5]) if len(proc) > 5 else 0.0
    return out


def build_mega_tables(scene: SceneData, medium=None,
                      tex_procs=None) -> MegaTables:
    """The JAX build_mega_tables without its TPU layouts; `medium`, the 8
    floats of the JAX MegaVolPathTracer (σt rgb, albedo rgb, g, bound) or
    None, compiles in the medium branch (rounded to float32 here);
    `tex_procs`, a scene description's texture slot → procedural
    provenance (SceneDesc.tex_procs), fills the TEXROW rows of each
    material whose albedo texture has one. Other textures are left out of
    the tables (MegaPathTracer.supports refuses their scenes)."""
    mat_rows = to_numpy(scene.mat_params).astype(np.float32)
    mat = np.zeros((mat_rows.shape[0], N_MAT), np.float32)
    mat[:, :mat_rows.shape[1]] = mat_rows
    mat[:, TEXROW] = -1.0
    for mi in np.nonzero(mat_rows[:, 12] == MAT_ROUGH_PLASTIC)[0]:
        mat[mi, RTROW:] = _rough_plastic_rows(mat_rows[mi])
    for mi, slot in enumerate(mat_rows[:, 13].astype(int)):
        if slot >= 0 and (tex_procs or {}).get(slot) is not None:
            mat[mi, TEXROW:RTROW] = _proc_rows(tex_procs[slot])
    textured = bool((mat[:, TEXROW] >= 0).any())
    attr = to_numpy(scene.tri_attr)
    n_t = attr.shape[0]
    areas = to_numpy(scene.tri_area)
    n_real = int(np.max(np.nonzero(areas > 0)[0]) + 1) if \
        (areas > 0).any() else 1

    attr_p = np.zeros((n_t, N_ATTR), np.float32)
    attr_p[:, 0:3] = attr[:, 0:3]
    attr_p[:, 3] = attr[:, 18]
    attr_p[:, 4] = attr[:, 19]
    attr_p[:, 5:8] = attr[:, 3:6]                        # vn0
    attr_p[:, 8:11] = attr[:, 6:9] - attr[:, 3:6]        # vn1-vn0
    attr_p[:, 11:14] = attr[:, 9:12] - attr[:, 3:6]      # vn2-vn0
    attr_p[:, 19:21] = attr[:, 12:14]                    # uv0
    attr_p[:, 21:23] = attr[:, 14:16] - attr[:, 12:14]
    attr_p[:, 23:25] = attr[:, 16:18] - attr[:, 12:14]
    n_em = int(scene.n_emitters)
    tri_em = attr[:, 19].astype(int)
    emissive = tri_em >= 0
    eid = np.clip(tri_em, 0, max(n_em - 1, 0))
    pmf_all = to_numpy(scene.em_pmf.pmf)
    if n_em:
        rad_all, area_all = to_numpy(scene.em_radiance), to_numpy(scene.em_area)
        attr_p[:, 14:17] = np.where(emissive[:, None], rad_all[eid], 0)
        attr_p[:, 17] = np.where(emissive, area_all[eid], 1.0)
        attr_p[:, 18] = np.where(emissive, pmf_all[eid], 0.0)
    else:
        attr_p[:, 17] = 1.0

    em_tris = to_numpy(scene.em_tris)
    et = len(em_tris)
    et_pad = max(8, -(-max(et, 1) // 8) * 8)
    rows = np.zeros((et_pad, 24), np.float32)
    if et:
        cdfg = to_numpy(scene.em_tri_cdfg)
        rows[:et, 0:12] = to_numpy(scene.em_tri_data)[:et]
        rows[:et, 12] = cdfg
        em_of = np.clip(np.floor(cdfg - 1e-6).astype(int), 0, n_em - 1)
        rows[:et, 13] = to_numpy(scene.em_area)[em_of]
        rows[:et, 14] = pmf_all[em_of]
        rows[:et, 15] = em_of.astype(np.float32)
        rows[:et, 16:19] = to_numpy(scene.em_radiance)[em_of]
        rows[et:, 12] = 1e9              # cdf sentinel: never selected
    else:
        rows[:, 12] = 1e9

    e_pad = max(8, -(-max(n_em, 1) // 8) * 8)
    meta = np.zeros((e_pad, 16), np.float32)
    if n_em:
        pmf = pmf_all[:n_em]
        meta[:n_em, 0] = np.cumsum(pmf) - pmf            # cdf_lo
        meta[:n_em, 1] = pmf
        meta[:n_em, 2] = to_numpy(scene.em_type)[:n_em]
        meta[:n_em, 3:6] = to_numpy(scene.em_radiance)[:n_em]
        meta[:n_em, 6] = to_numpy(scene.em_area)[:n_em]
        meta[:n_em, 8:11] = to_numpy(scene.em_pos)[:n_em]
        aux = to_numpy(scene.em_aux)
        if aux.shape[0] >= n_em:
            meta[:n_em, 11:14] = aux[:n_em, 0:3]
            meta[:n_em, 14] = aux[:n_em, 3]
            meta[:n_em, 15] = aux[:n_em, 4]
        meta[n_em:, 0] = 2e9             # never selected
    dev = scene.device
    f32 = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                    device=dev)
    corners = attr.copy()
    corners[:, 6:9] = attr_p[:, 5:8] + attr_p[:, 8:11]
    corners[:, 9:12] = attr_p[:, 5:8] + attr_p[:, 11:14]
    corners[:, 14:16] = attr_p[:, 19:21] + attr_p[:, 21:23]
    corners[:, 16:18] = attr_p[:, 19:21] + attr_p[:, 23:25]
    return MegaTables(
        woop=scene.woop_clusters, aabb=scene.cluster_aabb, attr=f32(attr_p),
        mat=f32(mat), em_rows=f32(rows), em_meta=f32(meta),
        em_cdf=scene.em_pmf.cdf.contiguous(), em_count=n_em, n_tris=n_real,
        real_tris=trace.real_tris(scene),
        m_real=mat.shape[0], et_real=max(et, 1),
        env=int(scene.env_id) if n_em else -1,
        ext=bool((meta[:n_em, 2] != EM_AREA).any()
                 or np.isin(mat[:, 12], sorted(COMPOSITE_FAMILIES)).any()
                 or medium is not None or textured),
        textured=textured,
        medium=None if medium is None else tuple(
            float(x) for x in np.asarray(medium, np.float32)),
        scene=scene,
        plain_scene=scene._replace(tri_attr=f32(corners)))


# ---------------------------------------------------------------------------
# camera (the pinhole PerspectiveCamera and render.py's pixel jitter)
# ---------------------------------------------------------------------------

N_CAMERA = 18


def camera_consts(camera) -> list[float]:
    """The N_CAMERA camera constants of the in-kernel regeneration,
    rounded to float32 as sensor.py rounds them: rotation rows r00..r22
    (camera→world), position xyz, tan(fov_x/2), height/width, width,
    height, the thin lens's aperture radius (0: pinhole) and focus
    distance."""
    r = np.asarray(camera.to_world[:3, :3], np.float32)
    t = np.asarray(camera.to_world[:3, 3], np.float32)
    tan_half = np.float32(np.tan(np.radians(camera.fov_x) / 2.0))
    aspect = np.float32(camera.height / camera.width)
    return ([float(x) for x in r.reshape(-1)] + [float(x) for x in t]
            + [float(tan_half), float(aspect), float(camera.width),
               float(camera.height),
               float(np.float32(max(camera.aperture_radius, 0.0))),
               float(np.float32(camera.focus_distance))])


def primary_rays(camera, seed, pixel, samp):
    """Camera rays of `pixel` [N] at sample index `samp`, as render()
    makes them: (o [N, 3], d [N, 3])."""
    return sample_camera(camera, camera.width, seed, pixel, samp)[1:]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class MegaPlainTracer(VolPathTracer):
    """The megakernel bounce in PyTorch: VolPathTracer(accel="plain")'s
    bounce (PathTracer's, with the medium's hooks) on the tables'
    plain_scene and medium, whose shading tail evaluates and samples the
    BSDF through the device helpers' plain versions (composite_eval_pdf,
    composite_sample: bsdf_eval_pdf and bsdf_sample for leaf lanes) on
    the tables' material rows, with the two-sided flip of wi's and wo's
    local z, and whose medium terms take the JAX megakernel's forms. It
    differs from PathTracer and VolPathTracer in rounding only, and counts
    attempted shadow rays."""
    tables: MegaTables | None = None
    count_attempted = True

    def _settle_medium(self, scene):
        return self.tables.medium

    def _segment(self, u, t_surf, active):
        return medium_segment(self.medium, u, t_surf, active)

    def _phase_value(self, d, wo):
        cos = -((d[:, 0] * wo[:, 0] + d[:, 1] * wo[:, 1]) + d[:, 2] * wo[:, 2])
        return hg_value(self.medium[6], cos)

    def _phase_sample(self, d, u2):
        return hg_sample_kernel(self.medium[6], d, u2)

    def _rows(self, v):
        """(top, child A, child B) material rows of the vertex's lanes,
        columns 0-2 of a procedurally textured lane's rows replaced by
        proc_albedo at its uv (a textured lane is a leaf, whose child
        rows are its own)."""
        rows = child_rows(self.tables, v.its.mat_id)
        if not self.tables.textured:
            return rows
        top = rows[0]
        albedo = torch.where(top[TEXROW] >= 0, proc_albedo(top, v.its.uv),
                             top[0:3])
        return tuple(torch.cat([albedo, r[3:]]) for r in rows)

    @staticmethod
    def _flip(mat, wi):
        """-1 where the two-sided adapter mirrors back-side incidence."""
        return torch.where((mat[15] > 0.5) & (wi[:, 2] < 0.0), -1.0, 1.0)

    def _bsdf_eval(self, v, wi, wo):
        top, mat_a, mat_b = self._rows(v)
        fsign = self._flip(top, wi)
        *f, pdf = composite_eval_pdf(
            top, mat_a, mat_b, wi[:, 0], wi[:, 1], wi[:, 2] * fsign,
            wo[:, 0], wo[:, 1], wo[:, 2] * fsign, self.families)
        return torch.stack(f, -1), pdf

    def _bsdf_sample(self, v, wi, u2, u1):
        top, mat_a, mat_b = self._rows(v)
        fsign = self._flip(top, wi)
        (nwx, nwy, nwz, w_r, w_g, w_b, pdf, is_delta, eta) = composite_sample(
            top, mat_a, mat_b, wi[:, 0], wi[:, 1], wi[:, 2] * fsign,
            u2[:, 0], u2[:, 1], u1, self.families)
        return BSDFSample(torch.stack([nwx, nwy, nwz * fsign], -1),
                          torch.stack([w_r, w_g, w_b], -1), pdf, is_delta,
                          eta)


def checker_c0(xw, yw, tres, ttil):
    """1 where the checkerboard's texel (xw, yw) holds color0 (its cell's
    parity is even), else 0."""
    cxy = torch.floor(xw * ttil / tres) + torch.floor(yw * ttil / tres)
    return 1.0 - (cxy - 2.0 * torch.floor(cxy * 0.5))


def grid_c0(xw, yw, tres, ttil, lw):
    """1 where the grid's texel (xw, yw) lies on a line (within lw of an
    integer, rounding half to even), else 0."""
    ax, ay = (xw + 0.5) / tres * ttil, (yw + 0.5) / tres * ttil
    return ((torch.abs(ax - torch.round(ax)) < lw)
            | (torch.abs(ay - torch.round(ay)) < lw)).to(xw.dtype)


def proc_albedo(mat, uv):
    """The analytic bilinear checker or grid albedo [3, N] of material
    rows mat [N_MAT, N] (TEXROW..) at uv [N, 2] (the JAX megakernel's
    :720-780): texture.eval_texture_lod at level 0 over the rasterized
    bitmap (texel centers at -0.5, v flipped, repeat wrap), with each
    corner's checker_c0 or grid_c0 in place of the texel fetch. The same
    forms as the JAX kernel, in its order: the wrap x - floor(x / res)·res
    and the cell floor((x·tiles) / res) divide by the row's resolution.
    csrc/megakernel.cu computes it op for op."""
    u, v = uv[:, 0], uv[:, 1]
    tres = torch.clamp(mat[TEXROW + 7], min=1.0)
    ttil = torch.clamp(mat[TEXROW + 8], min=1.0)
    lw = mat[TEXROW + 9] * ttil
    fx = u * tres - 0.5
    fy = (1.0 - v) * tres - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = fx - x0, fy - y0
    wrap = lambda x: x - torch.floor(x / tres) * tres
    grid = mat[TEXROW] == 1.0
    c0 = lambda xw, yw: torch.where(grid, grid_c0(xw, yw, tres, ttil, lw),
                                    checker_c0(xw, yw, tres, ttil))
    xw0, xw1, yw0, yw1 = wrap(x0), wrap(x0 + 1.0), wrap(y0), wrap(y0 + 1.0)
    s0w = (c0(xw0, yw0) * (1.0 - tx) * (1.0 - ty)
           + c0(xw1, yw0) * tx * (1.0 - ty)
           + c0(xw0, yw1) * (1.0 - tx) * ty
           + c0(xw1, yw1) * tx * ty)
    return torch.stack([mat[TEXROW + 1 + k] * s0w
                        + mat[TEXROW + 4 + k] * (1.0 - s0w)
                        for k in range(3)])


# ---------------------------------------------------------------------------
# the medium terms in the JAX megakernel's forms (_bounce_rows :665-700,
# :1098-1112, :1119-1127, :1307-1371), which csrc/megakernel.cu computes op
# for op: per-channel exponents, the channel means as (a + b + c)·(1/3),
# the segment weight blended by the 0/1 medium flag, the HG value and
# sample with the constants of g in float32 arithmetic, as the kernel
# computes them, the sample in coordinate_system(d)'s frame. A constant
# over a tensor is divided as a full tensor (a Python scalar over a
# tensor is a reciprocal times the scalar in PyTorch).
# ---------------------------------------------------------------------------

def medium_segment(medium, u, t_surf, active):
    """Balance distance sampling (:665-700): (sampled [N] bool, t [N],
    the segment weight [N, 3], σs·Tr(t)/pdfSuccess on active sampled lanes
    and Tr(ts)/pdfFailure on the others, blended as imf·a + (1-imf)·b)."""
    sigma_t = torch.tensor(medium[0:3], dtype=t_surf.dtype,
                           device=t_surf.device)
    sigma_s = sigma_t * torch.tensor(medium[3:6], dtype=t_surf.dtype,
                                     device=t_surf.device)
    ch = torch.clamp((u[:, 0] * 3.0).to(torch.int64), max=2)
    sig_c = torch.clamp(sigma_t[ch], min=1e-8)
    t = -torch.log1p(-torch.clamp(u[:, 1], 0.0, 1.0 - 1e-7)) / sig_c
    seg_end = torch.clamp(t_surf, max=medium[7])
    sampled = t < seg_end
    tt = torch.exp(-torch.clamp(sigma_t * t[:, None], max=80.0))
    ts = torch.exp(-torch.clamp(sigma_t * seg_end[:, None], max=80.0))
    a = sigma_t * tt
    third = 1.0 / 3.0
    pdf_succ = torch.clamp(((a[:, 0] + a[:, 1]) + a[:, 2]) * third,
                           min=1e-20)
    pdf_fail = torch.clamp(((ts[:, 0] + ts[:, 1]) + ts[:, 2]) * third,
                           min=1e-20)
    imf = (active & sampled).to(t.dtype)[:, None]
    w = (imf * (sigma_s * tt / pdf_succ[:, None])
         + (1.0 - imf) * (ts / pdf_fail[:, None]))
    return sampled, t, w


def _g_consts(g):
    """float32 constants of the HG asymmetry g: 1 + g², 2g, 1 - g², 1 - g
    and (1/4π)(1 - g²)."""
    g = np.float32(g)
    one = np.float32(1.0)
    g2 = g * g
    return (float(one + g2), float(np.float32(2.0) * g), float(one - g2),
            float(one - g), float(np.float32(INV_FOUR_PI) * (one - g2)))


def hg_value(g, cos):
    """The HG value at cos = -(d·wo) (:1098-1112, :1336-1339):
    inv4pi·(1 - g²) / (den·sqrt(den)), den = max(1 + g² + 2g·cos, 1e-8)."""
    c1, two_g, _, _, num = _g_consts(g)
    den = torch.clamp(two_g * cos + c1, min=1e-8)
    return torch.full_like(den, num) / (den * torch.sqrt(den))


def hg_sample_kernel(g, d, u2):
    """The HG continuation (:1307-1371): cosθ by the exact inverse CDF
    (1 - 2u below |g| = 1e-4, a choice of the launch), the azimuth 2π·u,
    the direction in coordinate_system(d)'s frame about d. Returns
    (wo [N, 3], pdf [N])."""
    u0, u1 = u2[:, 0], u2[:, 1]
    c1, two_g, one_m_g2, one_m_g, _ = _g_consts(g)
    if abs(np.float32(g)) < 1e-4:
        cos_t = torch.clamp(1.0 - 2.0 * u0, -1.0, 1.0)
    else:
        sqr = torch.full_like(u0, one_m_g2) / (two_g * u0 + one_m_g)
        cos_t = torch.clamp((c1 - sqr * sqr) / torch.full_like(u0, two_g),
                            -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = (2.0 * math.pi) * u1
    s, t = coordinate_system(d)
    sc, ss = sin_t * torch.cos(phi), sin_t * torch.sin(phi)
    wo = (sc[:, None] * s + ss[:, None] * t) + cos_t[:, None] * d
    cos_pdf = -((d[:, 0] * wo[:, 0] + d[:, 1] * wo[:, 1]) + d[:, 2] * wo[:, 2])
    return wo, hg_value(g, cos_pdf)


def _plain(tables: MegaTables, max_depth, rr_depth):
    return MegaPlainTracer(max_depth=max_depth, rr_depth=rr_depth,
                           accel="plain", tables=tables).specialized_for(
                               tables.plain_scene)


def bounce_plain(tables: MegaTables, rr_depth, max_depth, state, pixel,
                 samp, seed, bounce: int):
    """[16, N] state → [18, N]: MegaPlainTracer's bounce."""
    new, traced, shadow = _plain(tables, max_depth, rr_depth).bounce(
        tables.plain_scene, state, seed, pixel, samp, bounce)
    return torch.cat([new, traced[None].to(state.dtype),
                      shadow[None].to(state.dtype)])


def path_plain(tables: MegaTables, rr_depth, max_depth, n_bounces, state,
               pixel, samp, seed):
    """bounce_plain up to n_bounces times; the count rows are summed. A
    dead lane comes out of a bounce unchanged, so the loop stops once no
    lane is live: looping on would change nothing."""
    tracer = _plain(tables, max_depth, rr_depth)
    counts = torch.zeros((2, state.shape[1]), dtype=state.dtype,
                         device=state.device)
    for b in range(n_bounces):
        if not bool((state[12] > 0.5).any()):
            break
        state, traced, shadow = tracer.bounce(tables.plain_scene, state,
                                              seed, pixel, samp, b)
        counts = counts + torch.stack([traced, shadow]).to(state.dtype)
    return torch.cat([state, counts])


def iter_cap(spp, max_depth):
    """The persistent kernel's bound on a lane's bounces over its spp
    paths: spp·max_depth + 8, with 32 bounces a path when max_depth <= 0
    (unbounded), as the JAX run_persistent (megakernel.py:2646-2647)."""
    return spp * pass_bounces(max_depth) + 8


def persistent_plain(tables: MegaTables, rr_depth, max_depth, spp, camera,
                     state, pixel, samp0, seed):
    """[24, N] → [24, N]: for s in range(spp), the paths of every live lane
    at sample samp0 + s (sample 0 from the state's rows, later ones from
    the camera) through path_plain; L and the counts summed. Rows 16:24 of
    the input are taken to be zero (fresh lanes); lanes inactive on entry
    come out unchanged, as in the kernel. Each path runs to its end, as in
    the kernel: a bounded one dies by its max_depth-th bounce, an unbounded
    one by Russian roulette or an escape. The kernel's iter_cap stops a lane
    only where its spp paths together take more bounces than that (32 a
    path when unbounded), which this does not model."""
    live = state[12] > 0.5
    lsum = state.new_zeros((3, state.shape[1]))
    counts = state.new_zeros((2, state.shape[1]))
    last = state[:N_STATE]
    for s in range(spp):
        if s == 0:
            st = state[:N_STATE]
        else:
            o, d = primary_rays(camera, seed, pixel, samp0 + s)
            st = initial_state(o, d)
            st[12] = live.to(st.dtype)
        out = path_plain(tables, rr_depth, max_depth,
                         iter_cap(spp, max_depth), st, pixel, samp0 + s,
                         seed)
        lsum = lsum + torch.where(live, out[9:12], 0.0)
        counts = counts + out[16:18]
        last = out
    rows = torch.cat([
        last[:N_STATE],
        last[16:17],                            # bounces of the last path
        torch.full_like(state[17:18], float(spp)),
        lsum, counts[0:1], counts])
    return torch.where(live, rows, state)


# ---------------------------------------------------------------------------
# device BSDF helpers, plain versions (the 14 leaf families)
# ---------------------------------------------------------------------------
# The JAX megakernel's in-kernel BSDF dispatch (_bsdf_eval_pdf :1744,
# _bsdf_sample :1951 and their helpers _rd_terms :1578, _rp_terms :1637,
# _leadr_terms :1691, _fresnel_diel_f :207, _powf :224, _fdr :230, _ggx_d,
# _ggx_g1, _fresnel_cond) over per-lane rows: `mat` holds material
# columns as rows ([>= 13, N], row 12 the type code; rough plastic reads
# the transmittance rows RTROW.. of build_mega_tables as well), directions
# are split into their x, y, z rows. Each family's expressions are the JAX
# helper's, in its order of operations, and csrc/bsdf_common.cuh computes
# them op for op; they differ from bsdf.py's in rounding (the rough
# conductor's weight is F·G1(wo) instead of f/pdf, the rough plastic's
# transmittance a 32-knot slice instead of the trilinear lookup). A lane
# outside its family's validity gets zeros, where the JAX form multiplies
# by a 0/1 mask (the same numbers wherever they are finite).

# families whose sampler draws the cosine-hemisphere candidate
MEGA_COS_FAMILIES = frozenset({
    MAT_DIFFUSE, MAT_ROUGH_DIFFUSE, MAT_PLASTIC, MAT_PHONG, MAT_WARD,
    MAT_DIFFTRANS, MAT_ROUGH_PLASTIC, MAT_ANISO_ROUGHDIFFUSE})
# the leaf families of the JAX MEGA_FAMILIES: the megakernels' dispatch
LEAF_FAMILIES = frozenset(_LEAVES)
# the fused shade kernel's: its input rows carry material columns 0..12
# and 15, not the rough-plastic transmittance rows
SHADE_FAMILIES = LEAF_FAMILIES - {MAT_ROUGH_PLASTIC}


def _families(mat, families):
    if families is not None:
        return frozenset(families)
    return frozenset(int(c) for c in torch.unique(mat[12]).tolist())


def normalize3(x, y, z):
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-30))
    return x * inv, y * inv, z * inv


def ggx_d(hx, hy, hz, a):
    """Isotropic GGX D(h) (_ggx_d), zero below the horizon."""
    qx, qy = hx / a, hy / a
    t = qx * qx + qy * qy + hz * hz
    d = 1.0 / (math.pi * a * a * torch.clamp(t * t, min=1e-12))
    return torch.where(hz > 0.0, d, 0.0)


def ggx_g1(vx, vy, vz, hx, hy, hz, a):
    """Isotropic GGX Smith G1(v, h) (_ggx_g1)."""
    vz2 = vz * vz
    tan2 = torch.clamp(1.0 - vz2, min=0.0) / torch.clamp(vz2, min=1e-12)
    g = 2.0 / (1.0 + torch.sqrt(1.0 + a * a * tan2))
    g = torch.where(tan2 < 1e-12, 1.0, g)
    back = (vx * hx + vy * hy + vz * hz) * vz <= 0.0
    return torch.where(back, 0.0, g)


def fresnel_cond(mat, ci):
    """Exact conductor Fresnel per channel (_fresnel_cond): eta in rows
    0..2, k in rows 3..5; ci >= 0. Returns three rows."""
    c2 = ci * ci
    s2 = 1.0 - c2
    out = []
    for ch in range(3):
        e2, k2 = mat[ch] * mat[ch], mat[3 + ch] * mat[3 + ch]
        t0 = e2 - k2 - s2
        a2pb2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * e2 * k2, min=1e-12))
        t1 = a2pb2 + c2
        a = torch.sqrt(torch.clamp(0.5 * (a2pb2 + t0), min=1e-12))
        t2 = 2.0 * a * ci
        rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-6)
        t3 = c2 * a2pb2 + s2 * s2
        t4 = t2 * s2
        rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-6)
        out.append(0.5 * (rp + rs))
    return out


def fresnel_diel_f(cos_i, eta):
    """Unpolarized dielectric Fresnel F for a signed cos_i
    (_fresnel_diel_f)."""
    eta = torch.clamp(eta, min=1e-3)
    outside = cos_i >= 0.0
    eta_it = torch.where(outside, eta, 1.0 / eta)
    eta_ti = 1.0 / eta_it
    ci = torch.abs(cos_i)
    sin_t2 = eta_ti * eta_ti * (1.0 - ci * ci)
    tir = sin_t2 >= 1.0
    ct = torch.where(tir, 0.0, torch.sqrt(torch.clamp(1.0 - sin_t2,
                                                      min=1e-12)))
    rs = (ci - eta_it * ct) / torch.clamp(ci + eta_it * ct, min=1e-4)
    rp = (eta_it * ci - ct) / torch.clamp(eta_it * ci + ct, min=1e-4)
    return torch.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))


def powf(a, b):
    """a**b as exp(b·log a), a > 0 (_powf)."""
    return torch.exp(b * torch.log(a))


def fdr(eta):
    """Diffuse Fresnel reflectance polynomial fits (_fdr)."""
    inv_eta = 1.0 / eta
    below = -1.4399 * (eta * eta) + 0.7099 * eta + 0.6681 + 0.0636 * inv_eta
    ie2 = inv_eta * inv_eta
    ie3 = ie2 * inv_eta
    above = (0.919317 - 3.4793 * inv_eta + 6.75335 * ie2
             - 7.80989 * ie3 + 4.98554 * ie2 * ie2 - 1.36881 * ie2 * ie3)
    return torch.where(eta < 1.0, below, above)


def _vndf(a, vx, vy, vz, u0, u1):
    """GGX visible normal (Heitz 2018) for the view (vx, vy, vz), as each
    of the JAX helper's copies computes it."""
    vx, vy, vz = normalize3(a * vx, a * vy, vz)
    lensq = vx * vx + vy * vy
    inv_len = torch.rsqrt(torch.clamp(lensq, min=1e-20))
    big = lensq > 1e-20
    t1x = torch.where(big, -vy * inv_len, 1.0)
    t1y = torch.where(big, vx * inv_len, 0.0)
    t1z = torch.zeros_like(vx)
    t2x = vy * t1z - vz * t1y
    t2y = vz * t1x - vx * t1z
    t2z = vx * t1y - vy * t1x
    rr = torch.sqrt(torch.clamp(u0, min=0.0))
    ph = 2.0 * math.pi * u1
    p1 = rr * torch.cos(ph)
    p2 = rr * torch.sin(ph)
    ss = 0.5 * (1.0 + vz)
    p2 = (1.0 - ss) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) \
        + ss * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    return normalize3(a * (p1 * t1x + p2 * t2x + p3 * vx),
                      a * (p1 * t1y + p2 * t2y + p3 * vy),
                      torch.clamp(p1 * t1z + p2 * t2z + p3 * vz, min=1e-6))


def _spec_prob(mat):
    """max(ks) / (max(kd) + max(ks)) of phong and ward."""
    sd = torch.maximum(torch.maximum(mat[0], mat[1]), mat[2])
    ss = torch.maximum(torch.maximum(mat[3], mat[4]), mat[5])
    return ss / torch.clamp(sd + ss, min=1e-7)


def _oren_nayar(mat, wix, wiy, wiz, wox, woy, woz):
    """The Oren-Nayar factor A + B·max(cos Δφ, 0)·sin α·tan β."""
    sigma = mat[9] * 0.70711
    sigma2 = sigma * sigma
    a = 1.0 - sigma2 / (2.0 * (sigma2 + 0.33))
    bb = 0.45 * sigma2 / (sigma2 + 0.09)
    st_i = torch.sqrt(torch.clamp(1.0 - wiz * wiz, min=0.0))
    st_o = torch.sqrt(torch.clamp(1.0 - woz * woz, min=0.0))
    denom = torch.clamp(st_i * st_o, min=1e-7)
    cos_dphi = torch.clamp((wix * wox + wiy * woy) / denom, -1.0, 1.0)
    sin_alpha = torch.maximum(st_i, st_o)
    tan_beta = torch.minimum(st_i / torch.clamp(wiz, min=1e-7),
                             st_o / torch.clamp(woz, min=1e-7))
    return a + bb * torch.clamp(cos_dphi, min=0.0) * sin_alpha * tan_beta


def _plastic_dw(mat, eta, ch, fdr_int, inv_eta2):
    """Plastic's compensated diffuse weight of channel ch."""
    kd = mat[1 + ch]
    den = torch.where(mat[7] > 0.5, 1.0 - kd * fdr_int, 1.0 - fdr_int)
    return kd * inv_eta2 / torch.clamp(den, min=1e-4)


def _phong_lobe(mat, wix, wiy, wiz, wox, woy, woz):
    """Phong's n, the glossy power alpha^n, and the pdf's glossy term."""
    nexp = mat[6]
    # dot(reflect(wi), wo) with reflect = (-x, -y, z)
    alpha = torch.clamp(-wix * wox - wiy * woy + wiz * woz, min=1e-7)
    an = powf(alpha, nexp)
    return nexp, an, (nexp + 1.0) * (0.5 * INV_PI) * an


def _ward_terms(mat, au, av, wix, wiy, wiz, wox, woy, woz):
    """Ward's specular value (the unnormalized half vector) and its
    half-vector pdf (the normalized one) at (wi, wo)."""
    hx, hy, hz = wix + wox, wiy + woy, wiz + woz
    ex = -((hx / au) ** 2 + (hy / av) ** 2) / torch.clamp(hz * hz, min=1e-12)
    # max(·, 0) inside the sqrt: wiz·woz < 0 on invalid lanes
    spec = (torch.exp(ex) / (4.0 * math.pi * au * av * torch.clamp(
        torch.sqrt(torch.clamp(wiz * woz, min=0.0)), min=1e-6)))
    hnx, hny, hnz = normalize3(hx, hy, hz)
    exn = -((hnx / au) ** 2 + (hny / av) ** 2) / torch.clamp(hnz * hnz,
                                                              min=1e-12)
    pdf_h = torch.exp(exn) / (math.pi * au * av
                              * torch.clamp(hnz * hnz * hnz, min=1e-6))
    pdf_s = pdf_h / torch.clamp(
        4.0 * torch.abs(wox * hnx + woy * hny + woz * hnz), min=1e-6)
    return spec, pdf_s


def rd_terms(mat, wix, wiy, wiz, wox, woy, woz):
    """Rough-dielectric (Walter 2007, isotropic GGX) eval/pdf terms at a
    (wi, wo) pair, the micronormal re-derived from them (_rd_terms).
    Returns (vs: f·|cosθo| before the reflectance/transmittance tint,
    refl: the reflection side, pdf, ok: the chirality/validity mask)."""
    eta = torch.clamp(mat[0], min=1e-3)
    a = torch.clamp(mat[9], min=1e-4)
    ci, co = wiz, woz
    refl = ci * co > 0.0
    eta_it_w = torch.where(ci > 0.0, eta, 1.0 / eta)
    mrx, mry, mrz = normalize3(wix + wox, wiy + woy, wiz + woz)
    mtx, mty, mtz = normalize3(wix + eta_it_w * wox, wiy + eta_it_w * woy,
                               wiz + eta_it_w * woz)
    mx = torch.where(refl, mrx, mtx)
    my = torch.where(refl, mry, mty)
    mz = torch.where(refl, mrz, mtz)
    sgn_m = torch.where(mz >= 0.0, 1.0, -1.0)
    mx, my, mz = mx * sgn_m, my * sgn_m, mz * sgn_m
    wim = wix * mx + wiy * my + wiz * mz
    wom = wox * mx + woy * my + woz * mz
    outs = wim >= 0.0
    eta_itm = torch.where(outs, eta, 1.0 / eta)
    eta_tim = 1.0 / eta_itm
    cia = torch.abs(wim)
    sin_t2 = eta_tim * eta_tim * (1.0 - cia * cia)
    tir = sin_t2 >= 1.0
    cts = torch.where(tir, 0.0, torch.sqrt(torch.clamp(1.0 - sin_t2,
                                                       min=1e-12)))
    rs_ = (cia - eta_itm * cts) / torch.clamp(cia + eta_itm * cts, min=1e-4)
    rp_ = (eta_itm * cia - cts) / torch.clamp(eta_itm * cia + cts, min=1e-4)
    fre = torch.where(tir, 1.0, 0.5 * (rs_ * rs_ + rp_ * rp_))
    d_ndf = ggx_d(mx, my, mz, a)
    g_both = ggx_g1(wix, wiy, wiz, mx, my, mz, a) \
        * ggx_g1(wox, woy, woz, mx, my, mz, a)
    val_r = fre * d_ndf * g_both / torch.clamp(4.0 * torch.abs(ci),
                                               min=1e-7)
    den_t = (wim + eta_itm * wom) ** 2
    val_t = (1.0 - fre) * d_ndf * g_both * torch.abs(wim * wom) \
        / torch.clamp(torch.abs(ci) * den_t, min=1e-7)
    vs = torch.where(refl, val_r, val_t)
    sw = torch.where(wiz >= 0.0, 1.0, -1.0)
    g1up = ggx_g1(wix * sw, wiy * sw, wiz * sw, mx, my, mz, a)
    pdf_m = g1up * torch.abs(wim) * d_ndf / torch.clamp(torch.abs(wiz),
                                                        min=1e-12)
    jac_r = 1.0 / torch.clamp(4.0 * torch.abs(wom), min=1e-7)
    jac_t = torch.abs(wom) * eta_itm * eta_itm / torch.clamp(den_t, min=1e-7)
    pdf = pdf_m * torch.where(refl, fre * jac_r, (1.0 - fre) * jac_t)
    chir = (refl & (wim * wom > 0.0)) | (~refl & (wim * wom < 0.0))
    ok = (torch.abs(ci) > 1e-7) & chir
    return vs, refl, pdf, ok


def rp_terms(mat, wix, wiy, wiz, wox, woy, woz):
    """Rough-plastic f·cosθo (three rows), pdf and specular pick
    probability at a (wi, wo) pair (_rp_terms): the GGX lobe plus the
    diffuse base through the rough interface, with T12·T21 from the
    material's transmittance slice (rows RTROW + 1..) and its internal
    Fdr (row RTROW). The caller masks by family and hemisphere."""
    eta = torch.clamp(mat[0], min=1e-3)
    a = torch.clamp(mat[9], min=1e-4)
    hx, hy, hz = normalize3(wix + wox, wiy + woy, wiz + woz)
    wih = wix * hx + wiy * hy + wiz * hz
    fm = fresnel_diel_f(wih, eta)
    d_h = ggx_d(hx, hy, hz, a)
    g1i = ggx_g1(wix, wiy, wiz, hx, hy, hz, a)
    g1o = ggx_g1(wox, woy, woz, hx, hy, hz, a)
    spec_base = fm * d_h * g1i * g1o / torch.clamp(4.0 * wiz, min=1e-7)
    c0 = mat[RTROW + 1 + RT_KNOTS]
    c1 = mat[RTROW + 2 + RT_KNOTS]
    inv_span = float(RT_KNOTS - 1) / torch.clamp(c1 - c0, min=1e-6)
    knots = mat[RTROW + 1:RTROW + 1 + RT_KNOTS]

    def rt_interp(ct):
        """The slice's linear interpolation at cosθ ct (the JAX select
        chain over the 31 intervals, as a gather of the interval's knots)."""
        xx = (torch.clamp(ct, c0, c1) - c0) * inv_span
        i0 = torch.clamp(torch.floor(xx), 0.0, float(RT_KNOTS - 2))
        fcv = xx - i0
        k = i0.long()[None]
        return (torch.gather(knots, 0, k)[0] * (1.0 - fcv)
                + torch.gather(knots, 0, k + 1)[0] * fcv)

    t12 = rt_interp(wiz)
    t21 = rt_interp(woz)
    fdr_r = mat[RTROW]
    inv_eta2 = 1.0 / (eta * eta)
    base_d = INV_PI * t12 * t21 * torch.clamp(woz, min=0.0)
    nonlin = mat[7] > 0.5
    fs = []
    for ch in range(3):
        kd, ks = mat[1 + ch], mat[4 + ch]
        den = torch.where(nonlin, 1.0 - kd * fdr_r, 1.0 - fdr_r)
        fs.append(ks * spec_base
                  + kd * inv_eta2 / torch.clamp(den, min=1e-4) * base_d)
    prob_s = torch.clamp(fresnel_diel_f(wiz, eta), 0.25, 0.9)
    pdf_h = g1i * torch.abs(wih) * d_h / torch.clamp(wiz, min=1e-12)
    woh = wox * hx + woy * hy + woz * hz
    pdf_s = pdf_h / torch.clamp(4.0 * torch.abs(woh), min=1e-7)
    pdf_d = torch.clamp(woz, min=0.0) * INV_PI
    pdf = prob_s * pdf_s + (1.0 - prob_s) * pdf_d
    return fs[0], fs[1], fs[2], pdf, prob_s


def leadr_terms(mat, wix, wiy, wiz, wox, woy, woz):
    """LEADR anisotropic rough diffuse (_leadr_terms): the 4-point
    unscented quadrature over the slope Gaussian with the moments' Smith
    G2. Returns (scale, valid): f·cosθo = albedo·scale where valid."""
    mux, muy = mat[3], mat[4]
    sx2 = torch.clamp(mat[5] - mux * mux, min=1e-8)
    sy2 = torch.clamp(mat[6] - muy * muy, min=1e-8)
    cxy = mat[7] - mux * muy
    use_vis = mat[11] > 0.5
    ml = torch.rsqrt(mux * mux + muy * muy + 1.0)
    mnx, mny, mnz = -mux * ml, -muy * ml, ml
    win = wix * mnx + wiy * mny + wiz * mnz

    def lam(wx, wy, wz):
        st = torch.sqrt(torch.clamp(1.0 - wz * wz, min=0.0))
        st_s = torch.clamp(st, min=1e-7)
        cphi, sphi = wx / st_s, wy / st_s
        cot = wz / st_s
        mu_phi = cphi * mux + sphi * muy
        s2phi = torch.clamp(cphi * cphi * sx2 + sphi * sphi * sy2
                            + 2.0 * cphi * sphi * cxy, min=1e-12)
        v = (cot - mu_phi) / torch.sqrt(2.0 * s2phi)
        lm = torch.where(
            v < 0.0, 1e8,
            torch.where(v < 1.6, (1.0 - 1.259 * v + 0.396 * v * v)
                        / torch.clamp(3.535 * v + 2.181 * v * v, min=1e-12),
                        0.0))
        return torch.where(st < 1e-6, 0.0, lm)

    g2 = 1.0 / (1.0 + lam(wix, wiy, wiz) + lam(wox, woy, woz))
    l11 = torch.sqrt(sx2)
    l21 = cxy / l11
    l22 = torch.sqrt(torch.clamp(sy2 - l21 * l21, min=1e-12))
    r = 0.0
    s2c = math.sqrt(2.0)
    for (z0, z1) in ((s2c, 0.0), (-s2c, 0.0), (0.0, s2c), (0.0, -s2c)):
        sx = mux + l11 * z0
        sy = muy + l21 * z0 + l22 * z1
        il = torch.rsqrt(sx * sx + sy * sy + 1.0)
        wmx, wmy, wmz = -sx * il, -sy * il, il
        di = torch.clamp(wmx * wix + wmy * wiy + wmz * wiz, min=0.0)
        do = torch.clamp(wmx * wox + wmy * woy + wmz * woz, min=0.0)
        term = di * do / wmz
        term = torch.where(use_vis & (di > 1e-7) & (do > 1e-7), term * g2,
                           torch.where(use_vis, 0.0, term))
        r = r + 0.25 * term
    scale = INV_PI * mnz / torch.clamp(win, min=1e-7) * r
    return scale, win > 0.0


def bsdf_eval_pdf(mat, wix, wiy, wiz, wox, woy, woz, families=None):
    """f·cosθo (three rows) and the solid-angle pdf of the smooth lobes
    (_bsdf_eval_pdf); the delta families give 0. `families`: the type
    codes to evaluate (None: those in mat[12])."""
    fams = _families(mat, families)
    mtype = mat[12]
    zero = torch.zeros_like(wix)
    f, pdf = [zero, zero, zero], zero
    valid = (wiz > 0.0) & (woz > 0.0)

    def put(sel, rows, p):
        nonlocal f, pdf
        f = [torch.where(sel, r, f[ch]) for ch, r in enumerate(rows)]
        pdf = torch.where(sel, p, pdf)

    def is_(code):
        return mtype == float(code)

    if MAT_DIFFUSE in fams:
        put(is_(MAT_DIFFUSE) & valid,
            [mat[ch] * INV_PI * woz for ch in range(3)], woz * INV_PI)
    if MAT_ROUGH_CONDUCTOR in fams:
        hx, hy, hz = normalize3(wix + wox, wiy + woy, wiz + woz)
        a = torch.clamp(mat[9], min=1e-4)
        d_ndf = ggx_d(hx, hy, hz, a)
        g1i = ggx_g1(wix, wiy, wiz, hx, hy, hz, a)
        g1o = ggx_g1(wox, woy, woz, hx, hy, hz, a)
        wim = wix * hx + wiy * hy + wiz * hz
        fr = fresnel_cond(mat, torch.abs(wim))
        base = d_ndf * g1i * g1o / torch.clamp(4.0 * wiz, min=1e-7)
        pdf_h = g1i * torch.abs(wim) * d_ndf / torch.clamp(wiz, min=1e-12)
        put(is_(MAT_ROUGH_CONDUCTOR) & valid,
            [fr[ch] * mat[6 + ch] * base for ch in range(3)],
            pdf_h / torch.clamp(4.0 * torch.abs(wox * hx + woy * hy
                                                + woz * hz), min=1e-7))
    if MAT_ANISO_ROUGHDIFFUSE in fams:
        sel = is_(MAT_ANISO_ROUGHDIFFUSE) & valid
        sc_l, vl = leadr_terms(mat, wix, wiy, wiz, wox, woy, woz)
        put(sel, [torch.where(vl, mat[ch] * sc_l, 0.0) for ch in range(3)],
            woz * INV_PI)
    if MAT_ROUGH_PLASTIC in fams:
        rp = rp_terms(mat, wix, wiy, wiz, wox, woy, woz)
        put(is_(MAT_ROUGH_PLASTIC) & valid, rp[:3], rp[3])
    if MAT_ROUGH_DIELECTRIC in fams:
        # Walter rough glass: reflection and transmission, two-sided
        vs, refl, pdf_rd, ok = rd_terms(mat, wix, wiy, wiz, wox, woy, woz)
        put(is_(MAT_ROUGH_DIELECTRIC) & ok,
            [vs * torch.where(refl, mat[1 + ch], mat[4 + ch])
             for ch in range(3)], pdf_rd)
    if MAT_ROUGH_DIFFUSE in fams:
        on = _oren_nayar(mat, wix, wiy, wiz, wox, woy, woz) * INV_PI \
            * torch.clamp(woz, min=0.0)
        put(is_(MAT_ROUGH_DIFFUSE) & valid,
            [mat[ch] * on for ch in range(3)], woz * INV_PI)
    if MAT_PLASTIC in fams:
        eta = torch.clamp(mat[0], min=1e-3)
        fi = fresnel_diel_f(wiz, eta)
        fo = fresnel_diel_f(woz, eta)
        fdr_int, inv_eta2 = fdr(1.0 / eta), 1.0 / (eta * eta)
        base = INV_PI * (1.0 - fi) * (1.0 - fo) * torch.clamp(woz, min=0.0)
        put(is_(MAT_PLASTIC) & valid,
            [_plastic_dw(mat, eta, ch, fdr_int, inv_eta2) * base
             for ch in range(3)], woz * INV_PI * (1.0 - fi))
    if MAT_PHONG in fams:
        nexp, an, pdf_s = _phong_lobe(mat, wix, wiy, wiz, wox, woy, woz)
        ct_o = torch.clamp(woz, min=0.0)
        glossy = (nexp + 2.0) * (0.5 * INV_PI) * an * ct_o
        diff = INV_PI * ct_o
        prob_s = _spec_prob(mat)
        put(is_(MAT_PHONG) & valid,
            [mat[3 + ch] * glossy + mat[ch] * diff for ch in range(3)],
            prob_s * pdf_s + (1.0 - prob_s) * woz * INV_PI)
    if MAT_WARD in fams:
        au = torch.clamp(mat[9], min=1e-3)
        av = torch.clamp(mat[10], min=1e-3)
        spec, pdf_s = _ward_terms(mat, au, av, wix, wiy, wiz, wox, woy, woz)
        prob_s = _spec_prob(mat)
        put(is_(MAT_WARD) & valid,
            [mat[ch] * INV_PI * woz + mat[3 + ch] * spec * woz
             for ch in range(3)],
            prob_s * pdf_s + (1.0 - prob_s) * woz * INV_PI)
    if MAT_DIFFTRANS in fams:
        # opposite hemispheres
        awz = torch.abs(woz)
        put(is_(MAT_DIFFTRANS) & (wiz * woz < 0.0),
            [mat[ch] * INV_PI * awz for ch in range(3)], awz * INV_PI)
    return f[0], f[1], f[2], pdf


def bsdf_sample(mat, wix, wiy, wiz, u0, u1, uc, families=None):
    """One BSDF sample (_bsdf_sample): (wo x, y, z, weight r, g, b, pdf,
    is_delta, eta of the sampled event). u0, u1 drive the 2-D warps, uc
    the lobe pick. `families` as for bsdf_eval_pdf."""
    fams = _families(mat, families)
    mtype = mat[12]
    zero = torch.zeros_like(wix)
    nw = [zero, zero, zero + 1.0]
    w = [zero, zero, zero]
    pdf = zero
    is_delta = torch.zeros_like(wix, dtype=torch.bool)
    eta = zero + 1.0

    def put(sel, wo, ws, p, delta=None, eta_ev=None):
        nonlocal nw, w, pdf, is_delta, eta
        nw = [torch.where(sel, v, nw[j]) for j, v in enumerate(wo)]
        w = [torch.where(sel, v, w[ch]) for ch, v in enumerate(ws)]
        pdf = torch.where(sel, p, pdf)
        if delta is not None:
            is_delta = torch.where(sel, delta, is_delta)
        if eta_ev is not None:
            eta = torch.where(sel, eta_ev, eta)

    def is_(code):
        return mtype == float(code)

    if fams & MEGA_COS_FAMILIES:
        cos = square_to_cosine_hemisphere(torch.stack([u0, u1], -1)
                                          ).unbind(-1)
        sxd, syd, szd = cos
        pdf_cos = szd * INV_PI
    up = wiz > 0.0

    if MAT_DIFFUSE in fams:
        put(is_(MAT_DIFFUSE), cos,
            [torch.where(up, mat[ch], 0.0) for ch in range(3)],
            torch.where(up, pdf_cos, 0.0))

    if MAT_ANISO_ROUGHDIFFUSE in fams:
        # cosine sample, weight = f/pdf
        sc_l, vl = leadr_terms(mat, wix, wiy, wiz, sxd, syd, szd)
        both = up & (szd > 0.0)
        ok = both & vl
        inv_pc = 1.0 / torch.clamp(pdf_cos, min=1e-6)
        put(is_(MAT_ANISO_ROUGHDIFFUSE), cos,
            [torch.where(ok, mat[ch] * sc_l * inv_pc, 0.0)
             for ch in range(3)], torch.where(both, pdf_cos, 0.0))

    if MAT_CONDUCTOR in fams:
        fr = fresnel_cond(mat, torch.clamp(wiz, min=0.0))
        sel = is_(MAT_CONDUCTOR)
        put(sel, (-wix, -wiy, wiz),
            [torch.where(up, fr[ch] * mat[6 + ch], 0.0) for ch in range(3)],
            up.to(wix.dtype), sel & up)

    if MAT_ROUGH_CONDUCTOR in fams:
        a = torch.clamp(mat[9], min=1e-4)
        mx, my, mz = _vndf(a, wix, wiy, wiz, u0, u1)
        wim = wix * mx + wiy * my + wiz * mz
        rx = 2.0 * wim * mx - wix
        ry = 2.0 * wim * my - wiy
        rz = 2.0 * wim * mz - wiz
        d_ndf = ggx_d(mx, my, mz, a)
        g1i = ggx_g1(wix, wiy, wiz, mx, my, mz, a)
        g1o = ggx_g1(rx, ry, rz, mx, my, mz, a)
        pdf_h = g1i * torch.abs(wim) * d_ndf / torch.clamp(wiz, min=1e-12)
        pdf_c = pdf_h / torch.clamp(
            4.0 * torch.abs(rx * mx + ry * my + rz * mz), min=1e-7)
        fr = fresnel_cond(mat, torch.abs(wim))
        ok = (wiz > 1e-7) & (rz > 1e-7) & (pdf_c > 0.0)
        put(is_(MAT_ROUGH_CONDUCTOR), (rx, ry, rz),
            [torch.where(ok, fr[ch] * mat[6 + ch] * g1o, 0.0)
             for ch in range(3)], torch.where(ok, pdf_c, 0.0))

    if MAT_ROUGH_DIFFUSE in fams:
        # Oren-Nayar: cosine sample; f/pdf cancels (1/π)·cosθo
        on = _oren_nayar(mat, wix, wiy, wiz, sxd, syd, szd)
        okz = up & (szd > 0.0)
        put(is_(MAT_ROUGH_DIFFUSE), cos,
            [torch.where(okz, mat[ch] * on, 0.0) for ch in range(3)],
            torch.where(up, pdf_cos, 0.0))

    if MAT_PLASTIC in fams:
        # delta coat over diffuse
        peta = torch.clamp(mat[0], min=1e-3)
        fi = fresnel_diel_f(wiz, peta)
        pick = uc < fi
        pwz = torch.where(pick, wiz, szd)
        fo = fresnel_diel_f(pwz, peta)
        fdr_int, inv_eta2 = fdr(1.0 / peta), 1.0 / (peta * peta)
        dfac = (1.0 - fi) * (1.0 - fo) / torch.clamp(1.0 - fi, min=1e-7)
        sel = is_(MAT_PLASTIC)
        put(sel, (torch.where(pick, -wix, sxd), torch.where(pick, -wiy, syd),
                  pwz),
            [torch.where(up, torch.where(
                pick, mat[4 + ch],
                _plastic_dw(mat, peta, ch, fdr_int, inv_eta2) * dfac), 0.0)
             for ch in range(3)],
            torch.where(up, torch.where(pick, fi, (1.0 - fi) * szd * INV_PI),
                        0.0), sel & pick)

    if MAT_PHONG in fams:
        prob_s = _spec_prob(mat)
        pick = uc < prob_s
        # glossy lobe around the mirror direction
        cos_a = powf(torch.clamp(u0, min=1e-7), 1.0 / (mat[6] + 1.0))
        sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
        ph = 2.0 * math.pi * u1
        lx = sin_a * torch.cos(ph)
        ly = sin_a * torch.sin(ph)
        r = torch.stack([-wix, -wiy, wiz], -1)
        fs, ft = coordinate_system(r)
        g = [lx * fs[:, j] + ly * ft[:, j] + cos_a * r[:, j]
             for j in range(3)]
        pw = [torch.where(pick, g[j], cos[j]) for j in range(3)]
        valid = up & (pw[2] > 0.0)
        nexp, an, pdf_s = _phong_lobe(mat, wix, wiy, wiz, *pw)
        pdf_c = torch.where(valid, prob_s * pdf_s
                            + (1.0 - prob_s) * pw[2] * INV_PI, 0.0)
        ct_o = torch.clamp(pw[2], min=0.0)
        glossy = (nexp + 2.0) * (0.5 * INV_PI) * an * ct_o
        diff = INV_PI * ct_o
        inv_p = 1.0 / torch.clamp(pdf_c, min=1e-6)
        wgate = (pdf_c > 1e-6).to(wix.dtype) * valid.to(wix.dtype) * inv_p
        put(is_(MAT_PHONG), pw,
            [(mat[3 + ch] * glossy + mat[ch] * diff) * wgate
             for ch in range(3)], pdf_c)

    if MAT_WARD in fams:
        au = torch.clamp(mat[9], min=1e-3)
        av = torch.clamp(mat[10], min=1e-3)
        prob_s = _spec_prob(mat)
        pick = uc < prob_s
        # cos/sin of atan2(av·s0, au·c0) directly: cp = au·c0/h,
        # sp = av·s0/h
        c0 = torch.cos(2.0 * math.pi * u1)
        s0 = torch.sin(2.0 * math.pi * u1)
        hyp = torch.sqrt(torch.clamp((au * c0) ** 2 + (av * s0) ** 2,
                                     min=1e-20))
        cp, sp = au * c0 / hyp, av * s0 / hyp
        t2 = -torch.log(torch.clamp(u0, min=1e-7)) \
            / ((cp / au) ** 2 + (sp / av) ** 2)
        cth = 1.0 / torch.sqrt(1.0 + t2)
        sth = torch.sqrt(torch.clamp(1.0 - cth * cth, min=0.0))
        hx_, hy_, hz_ = sth * cp, sth * sp, cth
        wih = wix * hx_ + wiy * hy_ + wiz * hz_
        pw = [torch.where(pick, 2.0 * wih * hx_ - wix, sxd),
              torch.where(pick, 2.0 * wih * hy_ - wiy, syd),
              torch.where(pick, 2.0 * wih * hz_ - wiz, szd)]
        valid = up & (pw[2] > 0.0)
        spec, pdf_s = _ward_terms(mat, au, av, wix, wiy, wiz, *pw)
        pdf_c = torch.where(valid, prob_s * pdf_s
                            + (1.0 - prob_s) * pw[2] * INV_PI, 0.0)
        wgate = (pdf_c > 1e-6).to(wix.dtype) * valid.to(wix.dtype) \
            / torch.clamp(pdf_c, min=1e-6)
        put(is_(MAT_WARD), pw,
            [(mat[ch] * INV_PI * pw[2] + mat[3 + ch] * spec * pw[2]) * wgate
             for ch in range(3)], pdf_c)

    if MAT_THIN_DIELECTRIC in fams:
        # thin slab: delta reflect or pass through, internal bounces
        f0 = fresnel_diel_f(torch.abs(wiz), torch.clamp(mat[0], min=1e-3))
        f = torch.where(f0 < 1.0, f0 + (1.0 - f0) * (1.0 - f0) * f0
                        / torch.clamp(1.0 - f0 * f0, min=1e-7), f0)
        pick = uc < f
        sel = is_(MAT_THIN_DIELECTRIC)
        put(sel, (-wix, -wiy, torch.where(pick, wiz, -wiz)),
            [torch.where(pick, mat[1 + ch], mat[4 + ch]) for ch in range(3)],
            torch.where(pick, f, 1.0 - f), sel)

    if MAT_DIFFTRANS in fams:
        # diffuse transmitter: the cosine lobe on the far side
        sgnw = torch.where(wiz >= 0.0, 1.0, -1.0)
        okz = torch.abs(wiz) > 0.0
        put(is_(MAT_DIFFTRANS), (sxd, syd, -sgnw * szd),
            [torch.where(okz, mat[ch], 0.0) for ch in range(3)],
            torch.where(okz, pdf_cos, 0.0))

    if MAT_NULL in fams:
        sel = is_(MAT_NULL)
        one = zero + 1.0
        put(sel, (-wix, -wiy, -wiz), (one, one, one), one, sel)

    if MAT_ROUGH_PLASTIC in fams:
        # GGX lobe or cosine base, picked by the clamped Fresnel weight;
        # weight = f/pdf at the chosen wo
        a = torch.clamp(mat[9], min=1e-4)
        prob_s = torch.clamp(fresnel_diel_f(
            wiz, torch.clamp(mat[0], min=1e-3)), 0.25, 0.9)
        pick = uc < prob_s
        mx, my, mz = _vndf(a, wix, wiy, wiz, u0, u1)
        wim = wix * mx + wiy * my + wiz * mz
        cs = (torch.where(pick, 2.0 * wim * mx - wix, sxd),
              torch.where(pick, 2.0 * wim * my - wiy, syd),
              torch.where(pick, 2.0 * wim * mz - wiz, szd))
        rp_r, rp_g, rp_b, rp_pdf, _ = rp_terms(mat, wix, wiy, wiz, *cs)
        okp = up & (cs[2] > 0.0) & (rp_pdf > 1e-12)
        inv_rp = 1.0 / torch.clamp(rp_pdf, min=1e-12)
        put(is_(MAT_ROUGH_PLASTIC), cs,
            [torch.where(okp, v * inv_rp, 0.0) for v in (rp_r, rp_g, rp_b)],
            torch.where(okp, rp_pdf, 0.0))

    if MAT_ROUGH_DIELECTRIC in fams:
        # rough glass: a GGX visible normal from the upper-hemisphere wi,
        # a Fresnel lobe pick, weight = eval/pdf with the micronormal
        # re-derived from (wi, wo)
        reta = torch.clamp(mat[0], min=1e-3)
        a = torch.clamp(mat[9], min=1e-4)
        sw = torch.where(wiz >= 0.0, 1.0, -1.0)
        mx, my, mz = _vndf(a, wix * sw, wiy * sw, wiz * sw, u0, u1)
        wim = wix * mx + wiy * my + wiz * mz          # signed
        outs = wim >= 0.0
        eta_itm = torch.where(outs, reta, 1.0 / reta)
        eta_tim = 1.0 / eta_itm
        cia = torch.abs(wim)
        sin_t2 = eta_tim * eta_tim * (1.0 - cia * cia)
        tir = sin_t2 >= 1.0
        cts = torch.where(tir, 0.0, torch.sqrt(torch.clamp(1.0 - sin_t2,
                                                           min=1e-12)))
        rs_ = (cia - eta_itm * cts) / torch.clamp(cia + eta_itm * cts,
                                                  min=1e-4)
        rp_ = (eta_itm * cia - cts) / torch.clamp(eta_itm * cia + cts,
                                                  min=1e-4)
        fre = torch.where(tir, 1.0, 0.5 * (rs_ * rs_ + rp_ * rp_))
        cos_tt = torch.where(tir, 0.0, torch.where(outs, -cts, cts))
        pick = uc < fre
        wtf = eta_tim * wim + cos_tt
        wot = normalize3(-eta_tim * wix + wtf * mx, -eta_tim * wiy + wtf * my,
                         -eta_tim * wiz + wtf * mz)
        c = (torch.where(pick, 2.0 * wim * mx - wix, wot[0]),
             torch.where(pick, 2.0 * wim * my - wiy, wot[1]),
             torch.where(pick, 2.0 * wim * mz - wiz, wot[2]))
        vs, refl, pdf_rd, ok_rd = rd_terms(mat, wix, wiy, wiz, *c)
        inv_pdf = 1.0 / torch.clamp(pdf_rd, min=1e-12)
        side_ok = (pick & (wiz * c[2] > 1e-10)) \
            | (~pick & (wiz * c[2] < -1e-10))
        okv = ok_rd & (torch.abs(wiz) > 1e-7) & (pdf_rd > 1e-12) & side_ok
        w_rd = vs * inv_pdf
        put(is_(MAT_ROUGH_DIELECTRIC), c,
            [torch.where(okv, w_rd * torch.where(refl, mat[1 + ch],
                                                 mat[4 + ch]), 0.0)
             for ch in range(3)], torch.where(okv, pdf_rd, 0.0),
            eta_ev=torch.where(pick, 1.0, eta_itm))

    if MAT_DIELECTRIC in fams:
        # smooth glass: delta reflect/refract, two-sided
        sel = is_(MAT_DIELECTRIC)
        eta_r = torch.clamp(mat[0], min=1e-3)
        outside = wiz >= 0.0
        eta_it = torch.where(outside, eta_r, 1.0 / eta_r)
        eta_ti = 1.0 / eta_it
        cos_i = torch.abs(wiz)
        sin_t2 = eta_ti * eta_ti * (1.0 - cos_i * cos_i)
        tir = sin_t2 >= 1.0
        cos_t = torch.where(tir, 0.0,
                            torch.sqrt(torch.clamp(1.0 - sin_t2, min=1e-12)))
        rs = (cos_i - eta_it * cos_t) / torch.clamp(cos_i + eta_it * cos_t,
                                                    min=1e-4)
        rp = (eta_it * cos_i - cos_t) / torch.clamp(eta_it * cos_i + cos_t,
                                                    min=1e-4)
        f = torch.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
        cos_theta_t = torch.where(tir, 0.0,
                                  torch.where(outside, -cos_t, cos_t))
        pick_r = uc < f
        scale = torch.where(cos_theta_t < 0.0, 1.0 / eta_r, eta_r)
        refl = (-wix, -wiy, wiz)
        refr = (-scale * wix, -scale * wiy, cos_theta_t)
        t_fac = eta_ti * eta_ti
        put(sel, [torch.where(pick_r, refl[j], refr[j]) for j in range(3)],
            [torch.where(pick_r, mat[1 + ch], mat[4 + ch] * t_fac)
             for ch in range(3)], torch.where(pick_r, f, 1.0 - f), sel,
            torch.where(pick_r, 1.0, eta_it))
    return (*nw, *w, pdf, is_delta, eta)


# ---------------------------------------------------------------------------
# device composite helpers, plain versions (mixture, coating, rough coating)
# ---------------------------------------------------------------------------
# The JAX megakernel's composite branches (_bounce_rows: child resolution
# :781-800, the NEE eval :1004-1083, sampling :1135-1299) over per-lane
# rows: `top` is the lane's own material row, `mat_a` and `mat_b` its
# children's (slots 18 and 19; a leaf lane's own row), each a [N_MAT, N]
# column block as for bsdf_eval_pdf. A child is a leaf (MegaPathTracer
# refuses nested composites). csrc/megakernel.cu computes them op for op.

def child_rows(tables: MegaTables, mat_id):
    """The rows (top, child A, child B) of the lanes' materials, each
    [N_MAT, N]: a composite's children by its slots 18 and 19 (B: a
    mixture's only), a leaf lane's own row for both."""
    mid = torch.clamp(mat_id, min=0)
    top = tables.mat[mid].T
    mtype = top[12]
    comp = ((mtype == MAT_MIXTURE) | (mtype == MAT_COATING)
            | (mtype == MAT_ROUGH_COATING))
    ida = torch.where(comp, top[18].long(), mid)
    idb = torch.where(mtype == MAT_MIXTURE, top[19].long(), mid)
    return top, tables.mat[ida].T, tables.mat[idb].T


def _coat_in(vx, vy, vz, inv_ce):
    """A direction bent into the coat: sinθ' = sinθ/η, same hemisphere."""
    x, y = vx * inv_ce, vy * inv_ce
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0)) \
        * torch.sign(vz)
    return x, y, z


def _coat_setup(top, wix, wiy, wiz):
    """(η, 1/η, F(wi), wi bent into the coat) of the coat row."""
    c_eta = torch.clamp(top[0], min=1.0 + 1e-4)
    inv_ce = 1.0 / c_eta
    return (c_eta, inv_ce, fresnel_diel_f(wiz, c_eta),
            _coat_in(wix, wiy, wiz, inv_ce))


def _coat_terms(top, mat_a, coat, wox, woy, woz, families):
    """f·cosθo (three rows) and pdf of the through-coat nested component
    toward wo: the child at the bent directions, absorption, both
    interface transmittances and the Jacobian (coat_terms)."""
    c_eta, inv_ce, fi_c, (cix, ciy, ciz) = coat
    fo = fresnel_diel_f(woz, c_eta)
    cox, coy, coz = _coat_in(wox, woy, woz, inv_ce)
    *e, pn = bsdf_eval_pdf(mat_a, cix, ciy, ciz, cox, coy, coz, families)
    path = (1.0 / torch.clamp(torch.abs(ciz), min=1e-4)
            + 1.0 / torch.clamp(torch.abs(coz), min=1e-4))
    jac = torch.abs(woz) / torch.clamp(torch.abs(coz), min=1e-6) \
        * (inv_ce * inv_ce)
    sc = (1.0 - fi_c) * (1.0 - fo) * jac
    f = [e[ch] * torch.exp(-top[1 + ch] * path) * sc for ch in range(3)]
    pp = (1.0 - fi_c) * pn * torch.abs(woz) \
        / torch.clamp(c_eta * c_eta * torch.abs(coz), min=1e-9)
    return f, pp


def _rc_spec(top, c_eta, wix, wiy, wiz, wox, woy, woz):
    """f·cosθo and pdf of the rough coat's GGX reflection lobe, upper
    hemisphere, visible-normal pdf (rc_spec_terms)."""
    rc_a = torch.clamp(top[9], min=1e-4)
    hx, hy, hz = normalize3(wix + wox, wiy + woy, wiz + woz)
    d_h = ggx_d(hx, hy, hz, rc_a)
    wih = wix * hx + wiy * hy + wiz * hz
    f_h = fresnel_diel_f(wih, c_eta)
    g1i = ggx_g1(wix, wiy, wiz, hx, hy, hz, rc_a)
    g_h = g1i * ggx_g1(wox, woy, woz, hx, hy, hz, rc_a)
    upf = ((wiz > 0.0) & (woz > 0.0)).to(wiz.dtype)
    val = top[4] * f_h * d_h * g_h \
        / torch.clamp(4.0 * torch.abs(wiz), min=1e-7) * upf
    pdf_h = g1i * torch.abs(wih) * d_h / torch.clamp(torch.abs(wiz),
                                                      min=1e-12)
    woh = wox * hx + woy * hy + woz * hz
    return val, pdf_h / torch.clamp(4.0 * torch.abs(woh), min=1e-7) * upf


def composite_eval_pdf(top, mat_a, mat_b, wix, wiy, wiz, wox, woy, woz,
                       families):
    """bsdf_eval_pdf with the composites: a mixture's convex sum of its
    children, a coat's nested child through the interface, a rough
    coat's too plus its reflection lobe; leaf lanes as bsdf_eval_pdf."""
    fams = _families(top, families)
    mtype = top[12]
    *f, pdf = bsdf_eval_pdf(mat_a, wix, wiy, wiz, wox, woy, woz, fams)
    if MAT_MIXTURE in fams:
        is_mix = mtype == MAT_MIXTURE
        w_mix = torch.where(is_mix, top[20], 1.0)
        *fb, pdf_b = bsdf_eval_pdf(mat_b, wix, wiy, wiz, wox, woy, woz, fams)
        one_w = 1.0 - w_mix
        f = [torch.where(is_mix, w_mix * f[ch] + one_w * fb[ch], f[ch])
             for ch in range(3)]
        pdf = torch.where(is_mix, w_mix * pdf + one_w * pdf_b, pdf)
    if fams & {MAT_COATING, MAT_ROUGH_COATING}:
        coat = _coat_setup(top, wix, wiy, wiz)
        cf, cp = _coat_terms(top, mat_a, coat, wox, woy, woz, fams)
        if MAT_COATING in fams:
            is_coat = mtype == MAT_COATING
            f = [torch.where(is_coat, cf[ch], f[ch]) for ch in range(3)]
            pdf = torch.where(is_coat, cp, pdf)
        if MAT_ROUGH_COATING in fams:
            is_rc = mtype == MAT_ROUGH_COATING
            sv, sp = _rc_spec(top, coat[0], wix, wiy, wiz, wox, woy, woz)
            f = [torch.where(is_rc, cf[ch] + sv, f[ch]) for ch in range(3)]
            pdf = torch.where(is_rc, coat[2] * sp + cp, pdf)
    return f[0], f[1], f[2], pdf


def composite_sample(top, mat_a, mat_b, wix, wiy, wiz, u0, u1, uc,
                     families):
    """bsdf_sample with the composites (same outputs): a mixture picks a
    child with uc (reused in the child's own stream) and weights a
    smooth sample by the whole mixture's f/pdf; a coat picks its mirror
    lobe (smooth) or GGX lobe (rough) with probability F(wi), else the
    child sampled inside the coat and refracted out (total internal
    reflection: dead); leaf lanes as bsdf_sample."""
    fams = _families(top, families)
    mtype = top[12]
    if MAT_MIXTURE not in fams:
        out = list(bsdf_sample(mat_a, wix, wiy, wiz, u0, u1, uc, fams))
    else:
        is_mix = mtype == MAT_MIXTURE
        w_mix = torch.where(is_mix, top[20], 1.0)
        uc_a = torch.where(is_mix, torch.clamp(
            uc / torch.clamp(w_mix, min=1e-6), 0.0, 1.0 - 1e-6), uc)
        uc_b = torch.clamp((uc - w_mix) / torch.clamp(1.0 - w_mix, min=1e-6),
                           0.0, 1.0 - 1e-6)
        a = bsdf_sample(mat_a, wix, wiy, wiz, u0, u1, uc_a, fams)
        b = bsdf_sample(mat_b, wix, wiy, wiz, u0, u1, uc_b, fams)
        pick_a = uc < w_mix
        mo = [torch.where(pick_a, a[j], b[j]) for j in range(3)]
        d_m = (pick_a & a[7]) | (~pick_a & b[7])
        *ea, pa_m = bsdf_eval_pdf(mat_a, wix, wiy, wiz, *mo, fams)
        *eb, pb_m = bsdf_eval_pdf(mat_b, wix, wiy, wiz, *mo, fams)
        one_w = 1.0 - w_mix
        pdf_mix = w_mix * pa_m + one_w * pb_m
        inv_pm = torch.where(pdf_mix > 1e-12,
                             1.0 / torch.clamp(pdf_mix, min=1e-12), 0.0)
        pdf_delta = torch.where(pick_a, w_mix, one_w) \
            * torch.where(pick_a, a[6], b[6])
        out = [torch.where(is_mix, mo[j], a[j]) for j in range(3)]
        out += [torch.where(is_mix, torch.where(
            d_m, torch.where(pick_a, a[3 + ch], b[3 + ch]),
            (w_mix * ea[ch] + one_w * eb[ch]) * inv_pm), a[3 + ch])
            for ch in range(3)]
        out += [torch.where(is_mix, torch.where(d_m, pdf_delta, pdf_mix),
                            a[6]),
                (is_mix & d_m) | (~is_mix & a[7]),
                torch.where(is_mix, torch.where(pick_a, a[8], b[8]), a[8])]
    if fams & {MAT_COATING, MAT_ROUGH_COATING}:
        coat = _coat_setup(top, wix, wiy, wiz)
        c_eta, _, fi_c, (cix, ciy, ciz) = coat
        pick_sp = uc < fi_c
        u1_n = torch.clamp((uc - fi_c) / torch.clamp(1.0 - fi_c, min=1e-6),
                           0.0, 1.0 - 1e-6)
        nc = bsdf_sample(mat_a, cix, ciy, ciz, u0, u1, u1_n, fams)
        ox2, oy2 = nc[0] * c_eta, nc[1] * c_eta
        sin2_o = ox2 * ox2 + oy2 * oy2
        oz2 = torch.sqrt(torch.clamp(1.0 - sin2_o, min=0.0)) \
            * torch.sign(nc[2])
        t_out = 1.0 - fresnel_diel_f(oz2, c_eta)
        spath = (1.0 / torch.clamp(torch.abs(ciz), min=1e-4)
                 + 1.0 / torch.clamp(torch.abs(nc[2]), min=1e-4))
        wn = [nc[3 + ch] * torch.exp(-top[1 + ch] * spath) * t_out
              for ch in range(3)]
        pdf_no = (1.0 - fi_c) * nc[6] * torch.abs(oz2) \
            / torch.clamp(c_eta * c_eta * torch.abs(nc[2]), min=1e-9)
        okf = (~(sin2_o >= 1.0) & (nc[6] > 0.0)).to(wix.dtype)
        o2 = (ox2, oy2, oz2)
        if MAT_COATING in fams:
            sel = mtype == MAT_COATING
            spec = (-wix, -wiy, wiz)
            for j in range(3):
                out[j] = torch.where(sel, torch.where(pick_sp, spec[j],
                                                      o2[j]), out[j])
                out[3 + j] = torch.where(sel, torch.where(
                    pick_sp, top[4], okf * wn[j]), out[3 + j])
            out[6] = torch.where(sel, torch.where(pick_sp, fi_c,
                                                  okf * pdf_no), out[6])
            out[7] = (sel & (pick_sp | (~pick_sp & nc[7]))) | (~sel & out[7])
            out[8] = torch.where(sel, 1.0, out[8])
        if MAT_ROUGH_COATING in fams:
            sel = mtype == MAT_ROUGH_COATING
            rmx, rmy, rmz = _vndf(torch.clamp(top[9], min=1e-4), wix, wiy,
                                  wiz, u0, u1)
            wim_r = wix * rmx + wiy * rmy + wiz * rmz
            rs = (2.0 * wim_r * rmx - wix, 2.0 * wim_r * rmy - wiy,
                  2.0 * wim_r * rmz - wiz)
            ro = [torch.where(pick_sp, rs[j], o2[j]) for j in range(3)]
            rcf, rcp = _coat_terms(top, mat_a, coat, *ro, fams)
            rsv, rsp = _rc_spec(top, c_eta, wix, wiy, wiz, *ro)
            pdf_all = fi_c * rsp + rcp
            ipa = torch.where(pdf_all > 1e-9,
                              1.0 / torch.clamp(pdf_all, min=1e-9), 0.0)
            nested_delta = ~pick_sp & nc[7]
            live = (~(pick_sp & (rs[2] <= 0.0))).to(wix.dtype)
            for j in range(3):
                out[j] = torch.where(sel, ro[j], out[j])
                out[3 + j] = torch.where(sel, torch.where(
                    nested_delta, okf * wn[j], (rcf[j] + rsv) * ipa * live),
                    out[3 + j])
            out[6] = torch.where(sel, torch.where(
                nested_delta, okf * pdf_no, pdf_all * live), out[6])
            out[7] = (sel & nested_delta) | (~sel & out[7])
            out[8] = torch.where(sel, 1.0, out[8])
    return tuple(out)


# ---------------------------------------------------------------------------
# kernels: build, bind, launch
# ---------------------------------------------------------------------------

def build(defines: tuple = ()):
    """Build csrc/megakernel.cu (trace.build_library) with these walk
    defines (trace.build), in six nvcc processes at once, one for each
    entry point's kernels under each walk (the file's MITSUBA_PART
    shares). The file is compiled with -fmad=false, so every a*b+c rounds
    twice as PyTorch's eager ops do."""
    return trace.build_library("megakernel.cu", "mitsuba_mega",
                               ("-fmad=false",) + tuple(defines), parts=6)


_TABLE_ARGS = ([ctypes.c_void_p, ctypes.c_void_p,        # woop aabb
                ctypes.c_int, ctypes.c_int]              # C, real tris
               + [ctypes.c_void_p, ctypes.c_void_p]      # attr mat
               + [ctypes.c_void_p, ctypes.c_int]         # em_rows et_real
               + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]  # meta cdf E
               + [ctypes.c_int, ctypes.c_int]            # env ext
               + [ctypes.c_void_p, ctypes.c_int])        # medium (host) tex


def _library():
    return _bind(build()[0])


@functools.lru_cache(maxsize=None)
def _bind(path):
    lib = ctypes.CDLL(str(path))
    run = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_uint32]
    lib.mitsuba_mega_bounce.argtypes = (_TABLE_ARGS + run
                                        + [ctypes.c_int] * 3
                                        + [ctypes.c_void_p])
    lib.mitsuba_mega_path.argtypes = lib.mitsuba_mega_bounce.argtypes
    lib.mitsuba_mega_persistent.argtypes = (_TABLE_ARGS + run
                                            + [ctypes.c_int] * 4
                                            + [ctypes.c_void_p] * 2)
    for fn in (lib.mitsuba_mega_bounce, lib.mitsuba_mega_path,
               lib.mitsuba_mega_persistent):
        fn.restype = ctypes.c_int
    return lib


def _route(state):
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no megakernel route for device {state.device}")
    return state.device.type == "cuda"


def _launch(name, tables: MegaTables, state, rows_in, rows_out, pixel,
            samp, seed, ints, extra=(), ext=False):
    """Check the inputs, allocate the output and launch entry `name` on
    PyTorch's current stream, in the kExt instantiation when the tables
    (or `ext`) ask for it, with the tables' medium (8 host floats, or a
    null pointer), in the kTex instantiation when they carry procedural
    textures; raises on a refused launch."""
    dev = state.device
    n = state.shape[1]
    check = trace.check_tensor
    check(state, "state", torch.float32, (rows_in, n), dev)
    check(pixel, "pixel", torch.int32, (n,), dev)
    check(samp, "samp", torch.int32, (n,), dev)
    c = tables.woop.shape[0]
    check(tables.woop, "woop", torch.float32,
          (c, 3 * trace.TRIS_PER_CLUSTER, 4), dev, align=16)
    check(tables.aabb, "aabb", torch.float32, (c, 8), dev, align=16)
    check(tables.attr, "attr", torch.float32, (tables.attr.shape[0], N_ATTR),
          dev)
    check(tables.mat, "mat", torch.float32, (tables.m_real, N_MAT), dev)
    check(tables.em_rows, "em_rows", torch.float32,
          (tables.em_rows.shape[0], 24), dev)
    check(tables.em_meta, "em_meta", torch.float32,
          (tables.em_meta.shape[0], 16), dev)
    check(tables.em_cdf, "em_cdf", torch.float32,
          (max(tables.em_count, 1) + 1,), dev)
    out = torch.empty((rows_out, n), dtype=torch.float32, device=dev)
    med = None if tables.medium is None else \
        (ctypes.c_float * 8)(*tables.medium)
    fn = getattr(_library(), f"mitsuba_{name}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(tables.woop.data_ptr(), tables.aabb.data_ptr(), c,
                 tables.real_tris, tables.attr.data_ptr(),
                 tables.mat.data_ptr(), tables.em_rows.data_ptr(),
                 tables.et_real, tables.em_meta.data_ptr(),
                 tables.em_cdf.data_ptr(),
                 tables.em_count, tables.env, int(tables.ext or ext),
                 None if med is None else ctypes.addressof(med),
                 int(tables.textured), state.data_ptr(), out.data_ptr(),
                 pixel.data_ptr(), samp.data_ptr(), n,
                 seed & 0xFFFFFFFF, *ints, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1
    return out


def run_bounce(tables: MegaTables, rr_depth, max_depth, state, pixel, samp,
               seed, bounce: int):
    """One fused bounce over the wavefront. state [16, N] f32; pixel, samp
    [N] int32; seed an int; bounce the 0-based bounce index. Returns
    [18, N]: the 16 new state rows, then the trace and shadow counts."""
    if not _route(state):
        return bounce_plain(tables, rr_depth, max_depth, state, pixel, samp,
                            seed, bounce)
    return _launch("mega_bounce", tables, state, N_STATE, N_OUT, pixel,
                   samp, seed, (bounce, max_depth, rr_depth))


def run_path(tables: MegaTables, rr_depth, max_depth, n_bounces, state,
             pixel, samp, seed):
    """Whole paths in one launch: up to n_bounces bounces per lane, each
    lane stopping when its path dies. Same inputs as run_bounce without
    the bounce index; returns [18, N] with the counts summed."""
    if not _route(state):
        return path_plain(tables, rr_depth, max_depth, n_bounces, state,
                          pixel, samp, seed)
    return _launch("mega_path", tables, state, N_STATE, N_OUT, pixel, samp,
                   seed, (n_bounces, max_depth, rr_depth))


def run_persistent(tables: MegaTables, rr_depth, max_depth, spp, camera,
                   state, pixel, samp0, seed):
    """Persistent path-regeneration render: every live lane completes
    exactly `spp` paths of its pixel, regenerating a camera ray (pinhole
    or thin lens) at sample samp0 + done whenever a path dies. state [24, N] (the first
    camera ray in rows 0..15 with active 1, rows 16.. zero); pixel, samp0
    [N] int32. Returns the final [24, N] state: L_sum rows 18:21 / spp is
    the lane's radiance estimate, rows 22 and 23 the exact ray counts."""
    if not _route(state):
        return persistent_plain(tables, rr_depth, max_depth, spp, camera,
                                state, pixel, samp0, seed)
    cam = (ctypes.c_float * N_CAMERA)(*camera_consts(camera))
    return _launch("mega_persistent", tables, state, N_PSTATE, N_PSTATE,
                   pixel, samp0, seed,
                   (spp, max_depth, rr_depth, iter_cap(spp, max_depth)),
                   (ctypes.addressof(cam),),
                   ext=float(camera.aperture_radius) > 0.0)
