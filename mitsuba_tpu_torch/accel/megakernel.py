"""Path-tracing megakernels: one bounce, whole paths, or a pixel's whole
sample loop in one CUDA kernel (port of mitsuba_tpu/accel/megakernel.py,
the Cornell subset: pinhole camera, flat shading, diffuse BSDF, area
emitters, no medium, no textures).

Three entry points share one device bounce (csrc/megakernel.cu):

  run_bounce      one bounce per launch             (make_bounce_kernel)
  run_path        up to n_bounces per lane          (make_path_kernel)
  run_persistent  `spp` whole paths per lane, with in-kernel camera-ray
                  regeneration                      (make_persistent_kernel)

Each runs the kernel for CUDA tensors and its plain version for CPU
tensors; there is no fallback. The plain versions are the port's eager
wavefront bounce, PathTracer(accel="plain").bounce (integrator/path.py):
`bounce_plain` is one call, `path_plain` loops it, and `persistent_plain`
runs path_plain for every sample index and sums L and the counts, which is
the persistent kernel's per-pixel estimate.

The module also holds the plain versions of the JAX megakernel's device
BSDF helpers for the diffuse, conductor, rough-conductor and dielectric
families (bsdf_eval_pdf, bsdf_sample), which the fused shade kernel
computes (accel/shade_kernel.py, csrc/bsdf_common.cuh).

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

from ..integrator.path import PathTracer, initial_state
from ..core.warp import INV_PI, square_to_cosine_hemisphere
from ..render import sample_camera
from ..scene.scene import (MAT_CONDUCTOR, MAT_DIELECTRIC, MAT_DIFFUSE,
                           MAT_ROUGH_CONDUCTOR, MAT_ROUGH_PLASTIC, SceneData)
from . import trace

# RNG dims (mirror integrator/common.py)
SENSOR_DIMS = 4
DIMS_PER_BOUNCE = 8
DIM_NEE_SEL, DIM_NEE_POS, DIM_BSDF_U2, DIM_BSDF_U1, DIM_RR = 0, 1, 2, 3, 4
DIM_MEDIUM, DIM_PHASE = 5, 6
DIM_PIXEL = 0       # sensor jitter dim
DIM_APERTURE = 1    # thin-lens aperture dim (not ported)

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
N_MAT = 24          # material row: the scene's mat_params columns (the
                    # JAX table's texture and rough-plastic rows past
                    # them are not ported)

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
    gathers. `scene` is kept for the plain versions."""
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
    m_real: int
    et_real: int             # real emissive-triangle rows (at least 1)
    scene: SceneData


def to_numpy(x):
    """A tensor as a host numpy array."""
    return x.detach().cpu().numpy()


def build_mega_tables(scene: SceneData) -> MegaTables:
    """The JAX build_mega_tables reduced to the subset. Raises
    NotImplementedError for textured and rough-plastic materials, whose
    extra material rows the port does not build."""
    mat = to_numpy(scene.mat_params).astype(np.float32)
    if (mat[:, 12] == MAT_ROUGH_PLASTIC).any():
        raise NotImplementedError("rough-plastic transmittance rows are "
                                  "not ported")
    if (mat[:, 13] >= 0).any():
        raise NotImplementedError("procedural-texture rows are not ported")
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
    return MegaTables(
        woop=scene.woop_clusters, aabb=scene.cluster_aabb, attr=f32(attr_p),
        mat=f32(mat), em_rows=f32(rows), em_meta=f32(meta),
        em_cdf=scene.em_pmf.cdf.contiguous(), em_count=n_em, n_tris=n_real,
        m_real=mat.shape[0], et_real=max(et, 1), scene=scene)


# ---------------------------------------------------------------------------
# camera (the pinhole PerspectiveCamera and render.py's pixel jitter)
# ---------------------------------------------------------------------------

def camera_consts(camera) -> list[float]:
    """The 16 camera constants of the in-kernel regeneration, rounded to
    float32 as sensor.py rounds them: rotation rows r00..r22
    (camera→world), position xyz, tan(fov_x/2), height/width, width,
    height."""
    if float(getattr(camera, "aperture_radius", 0.0)) > 0.0:
        raise NotImplementedError("thin-lens camera regeneration is not "
                                  "ported")
    r = np.asarray(camera.to_world[:3, :3], np.float32)
    t = np.asarray(camera.to_world[:3, 3], np.float32)
    tan_half = np.float32(np.tan(np.radians(camera.fov_x) / 2.0))
    aspect = np.float32(camera.height / camera.width)
    return ([float(x) for x in r.reshape(-1)] + [float(x) for x in t]
            + [float(tan_half), float(aspect), float(camera.width),
               float(camera.height)])


def primary_rays(camera, seed, pixel, samp):
    """Camera rays of `pixel` [N] at sample index `samp`, as render()
    makes them: (o [N, 3], d [N, 3])."""
    return sample_camera(camera, camera.width, seed, pixel, samp)[1:]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _plain(max_depth, rr_depth):
    return PathTracer(max_depth=max_depth, rr_depth=rr_depth, accel="plain",
                      families=(MAT_DIFFUSE,))


def bounce_plain(tables: MegaTables, rr_depth, max_depth, state, pixel,
                 samp, seed, bounce: int):
    """[16, N] state → [18, N]: PathTracer(accel="plain").bounce."""
    new, traced, shadow = _plain(max_depth, rr_depth).bounce(
        tables.scene, state, seed, pixel, samp, bounce)
    return torch.cat([new, traced[None].to(state.dtype),
                      shadow[None].to(state.dtype)])


def path_plain(tables: MegaTables, rr_depth, max_depth, n_bounces, state,
               pixel, samp, seed):
    """bounce_plain n_bounces times; the count rows are summed. A dead lane
    comes out of a bounce unchanged, so looping on past the last live lane
    changes nothing."""
    tracer = _plain(max_depth, rr_depth)
    counts = torch.zeros((2, state.shape[1]), dtype=state.dtype,
                         device=state.device)
    for b in range(n_bounces):
        state, traced, shadow = tracer.bounce(tables.scene, state, seed,
                                              pixel, samp, b)
        counts = counts + torch.stack([traced, shadow]).to(state.dtype)
    return torch.cat([state, counts])


def persistent_plain(tables: MegaTables, rr_depth, max_depth, spp, camera,
                     state, pixel, samp0, seed):
    """[24, N] → [24, N]: for s in range(spp), the paths of every live lane
    at sample samp0 + s (sample 0 from the state's rows, later ones from
    the camera) through path_plain; L and the counts summed. Rows 16:24 of
    the input are taken to be zero (fresh lanes); lanes inactive on entry
    come out unchanged, as in the kernel."""
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
        out = path_plain(tables, rr_depth, max_depth, max_depth, st, pixel,
                         samp0 + s, seed)
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
# device BSDF helpers, plain versions (families 0-3)
# ---------------------------------------------------------------------------
# The JAX megakernel's in-kernel BSDF dispatch (_bsdf_eval_pdf :1744,
# _bsdf_sample :1951 and their helpers _ggx_d, _ggx_g1, _fresnel_cond)
# for the diffuse, conductor, isotropic-GGX rough-conductor and smooth-
# dielectric families, over per-lane rows: `mat` holds material columns
# 0..12 as rows ([>= 13, N], row 12 the type code), directions are split
# into their x, y, z rows. The fused shade kernel (accel/shade_kernel.py,
# csrc/bsdf_common.cuh) computes these forms, op for op; they differ from
# bsdf.py's in rounding only (the rough conductor's weight is F·G1(wo)
# instead of f/pdf).

SHADE_FAMILIES = frozenset({MAT_DIFFUSE, MAT_CONDUCTOR, MAT_ROUGH_CONDUCTOR,
                            MAT_DIELECTRIC})


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


def bsdf_eval_pdf(mat, wix, wiy, wiz, wox, woy, woz):
    """f·cosθo (three rows) and the solid-angle pdf of the smooth lobes
    (_bsdf_eval_pdf): diffuse and rough conductor; the delta families
    give 0."""
    mtype = mat[12]
    zero = torch.zeros_like(wix)
    valid = (wiz > 0.0) & (woz > 0.0)
    sel = (mtype == float(MAT_DIFFUSE)) & valid
    f = [torch.where(sel, mat[ch] * INV_PI * woz, zero) for ch in range(3)]
    pdf = torch.where(sel, woz * INV_PI, zero)
    sel = (mtype == float(MAT_ROUGH_CONDUCTOR)) & valid
    hx, hy, hz = normalize3(wix + wox, wiy + woy, wiz + woz)
    a = torch.clamp(mat[9], min=1e-4)
    d_ndf = ggx_d(hx, hy, hz, a)
    g1i = ggx_g1(wix, wiy, wiz, hx, hy, hz, a)
    g1o = ggx_g1(wox, woy, woz, hx, hy, hz, a)
    wim = wix * hx + wiy * hy + wiz * hz
    fr = fresnel_cond(mat, torch.abs(wim))
    base = d_ndf * g1i * g1o / torch.clamp(4.0 * wiz, min=1e-7)
    f = [torch.where(sel, fr[ch] * mat[6 + ch] * base, f[ch])
         for ch in range(3)]
    pdf_h = g1i * torch.abs(wim) * d_ndf / torch.clamp(wiz, min=1e-12)
    pdf = torch.where(sel, pdf_h / torch.clamp(
        4.0 * torch.abs(wox * hx + woy * hy + woz * hz), min=1e-7), pdf)
    return f[0], f[1], f[2], pdf


def bsdf_sample(mat, wix, wiy, wiz, u0, u1, uc):
    """One BSDF sample (_bsdf_sample): (wo x, y, z, weight r, g, b, pdf,
    is_delta, eta of the sampled event). u0, u1 drive the 2-D warps, uc
    the dielectric's reflect/refract pick."""
    mtype = mat[12]
    zero = torch.zeros_like(wix)
    nw = [zero, zero, zero + 1.0]
    w = [zero, zero, zero]
    pdf = zero
    is_delta = torch.zeros_like(wix, dtype=torch.bool)
    eta = zero + 1.0

    sel = mtype == float(MAT_DIFFUSE)
    ok = sel & (wiz > 0.0)
    cos = square_to_cosine_hemisphere(torch.stack([u0, u1], -1)).unbind(-1)
    nw = [torch.where(sel, cos[j], nw[j]) for j in range(3)]
    w = [torch.where(sel, torch.where(ok, mat[ch], 0.0), w[ch])
         for ch in range(3)]
    pdf = torch.where(sel, torch.where(ok, cos[2] * INV_PI, 0.0), pdf)

    sel = mtype == float(MAT_CONDUCTOR)
    ok = sel & (wiz > 0.0)
    fr = fresnel_cond(mat, torch.clamp(wiz, min=0.0))
    nw = [torch.where(sel, v, nw[j]) for j, v in enumerate((-wix, -wiy, wiz))]
    w = [torch.where(sel, torch.where(ok, fr[ch] * mat[6 + ch], 0.0), w[ch])
         for ch in range(3)]
    pdf = torch.where(sel, ok.to(pdf.dtype), pdf)
    is_delta = is_delta | ok

    # GGX visible normals (Heitz 2018), as core/microfacet.py
    sel = mtype == float(MAT_ROUGH_CONDUCTOR)
    a = torch.clamp(mat[9], min=1e-4)
    vx, vy, vz = normalize3(a * wix, a * wiy, wiz)
    lensq = vx * vx + vy * vy
    inv_len = torch.rsqrt(torch.clamp(lensq, min=1e-20))
    big = lensq > 1e-20
    t1x = torch.where(big, -vy * inv_len, 1.0)
    t1y = torch.where(big, vx * inv_len, 0.0)
    t1z = zero
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
    mx, my, mz = normalize3(a * (p1 * t1x + p2 * t2x + p3 * vx),
                            a * (p1 * t1y + p2 * t2y + p3 * vy),
                            torch.clamp(p1 * t1z + p2 * t2z + p3 * vz,
                                        min=1e-6))
    wim = wix * mx + wiy * my + wiz * mz
    rx = 2.0 * wim * mx - wix
    ry = 2.0 * wim * my - wiy
    rz = 2.0 * wim * mz - wiz
    d_ndf = ggx_d(mx, my, mz, a)
    g1i = ggx_g1(wix, wiy, wiz, mx, my, mz, a)
    g1o = ggx_g1(rx, ry, rz, mx, my, mz, a)
    pdf_h = g1i * torch.abs(wim) * d_ndf / torch.clamp(wiz, min=1e-12)
    pdf_c = pdf_h / torch.clamp(4.0 * torch.abs(rx * mx + ry * my + rz * mz),
                                min=1e-7)
    fr = fresnel_cond(mat, torch.abs(wim))
    ok = sel & (wiz > 1e-7) & (rz > 1e-7) & (pdf_c > 0.0)
    nw = [torch.where(sel, v, nw[j]) for j, v in enumerate((rx, ry, rz))]
    w = [torch.where(sel, torch.where(ok, fr[ch] * mat[6 + ch] * g1o, 0.0),
                     w[ch]) for ch in range(3)]
    pdf = torch.where(sel, torch.where(ok, pdf_c, 0.0), pdf)

    # smooth glass: delta reflect/refract, two-sided
    sel = mtype == float(MAT_DIELECTRIC)
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
    cos_theta_t = torch.where(tir, 0.0, torch.where(outside, -cos_t, cos_t))
    pick_r = uc < f
    scale = torch.where(cos_theta_t < 0.0, 1.0 / eta_r, eta_r)
    refl = (-wix, -wiy, wiz)
    refr = (-scale * wix, -scale * wiy, cos_theta_t)
    nw = [torch.where(sel, torch.where(pick_r, refl[j], refr[j]), nw[j])
          for j in range(3)]
    t_fac = eta_ti * eta_ti
    w = [torch.where(sel, torch.where(pick_r, mat[1 + ch],
                                      mat[4 + ch] * t_fac), w[ch])
         for ch in range(3)]
    pdf = torch.where(sel, torch.where(pick_r, f, 1.0 - f), pdf)
    is_delta = is_delta | sel
    eta = torch.where(sel & ~pick_r, eta_it, eta)
    return (*nw, *w, pdf, is_delta, eta)


# ---------------------------------------------------------------------------
# kernels: build, bind, launch
# ---------------------------------------------------------------------------

def build():
    """Build csrc/megakernel.cu (trace.build_library). The file is
    compiled with -fmad=false, so every a*b+c rounds twice as PyTorch's
    eager ops do."""
    return trace.build_library("megakernel.cu", "mitsuba_mega",
                               ("-fmad=false",))


_TABLE_ARGS = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]   # woop aabb C
               + [ctypes.c_void_p, ctypes.c_void_p]      # attr mat
               + [ctypes.c_void_p, ctypes.c_int]         # em_rows et_real
               + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int])  # meta cdf E


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build()[0]))
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
            samp, seed, ints, extra=()):
    """Check the inputs, allocate the output and launch entry `name` on
    PyTorch's current stream; raises on a refused launch."""
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
    fn = getattr(_library(), f"mitsuba_{name}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(tables.woop.data_ptr(), tables.aabb.data_ptr(), c,
                 tables.attr.data_ptr(), tables.mat.data_ptr(),
                 tables.em_rows.data_ptr(), tables.et_real,
                 tables.em_meta.data_ptr(), tables.em_cdf.data_ptr(),
                 tables.em_count, state.data_ptr(), out.data_ptr(),
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
    exactly `spp` paths of its pixel, regenerating a pinhole camera ray at
    sample samp0 + done whenever a path dies. state [24, N] (the first
    camera ray in rows 0..15 with active 1, rows 16.. zero); pixel, samp0
    [N] int32. Returns the final [24, N] state: L_sum rows 18:21 / spp is
    the lane's radiance estimate, rows 22 and 23 the exact ray counts."""
    if not _route(state):
        return persistent_plain(tables, rr_depth, max_depth, spp, camera,
                                state, pixel, samp0, seed)
    cam = (ctypes.c_float * 16)(*camera_consts(camera))
    iter_cap = spp * max_depth + 8
    return _launch("mega_persistent", tables, state, N_PSTATE, N_PSTATE,
                   pixel, samp0, seed, (spp, max_depth, rr_depth, iter_cap),
                   (ctypes.addressof(cam),))
