"""Fused shading tail: BSDF eval toward the light sample, the shadow trace,
MIS, BSDF sampling and Russian roulette in one CUDA kernel (port of
mitsuba_tpu/accel/shade_kernel.py, make_shade_kernel and fused_shade).

PathTracer(fused_shade="on") runs it after the closest-hit trace, the
emitter-hit terms and the NEE sample (integrator/path.py). `run_shade`
launches csrc/shade.cu for CUDA tensors and runs `shade_plain`, a PyTorch
transcription of the kernel body, for CPU tensors; there is no fallback.
The BSDF arithmetic is the JAX megakernel's device form
(accel/megakernel.py bsdf_eval_pdf / bsdf_sample), for the 13 leaf
families other than rough plastic (whose transmittance rows the K_IN
layout does not carry) and the two-sided adapter.

Layout: K_IN input rows and K_OUT output rows, one column per lane
(structure of arrays). The TPU's [K*8, N/8] packing, its block padding
and its per-block live flags are dropped: a lane inactive on entry gets
the pass-through rows of the JAX kernel's dead blocks, lane by lane.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core import rng
from ..integrator.common import mis_power
from ..scene.scene import (MAT_COATING, MAT_MIXTURE, MAT_ROUGH_COATING,
                           MAT_ROUGH_CONDUCTOR, MAT_ROUGH_DIELECTRIC,
                           MAT_ROUGH_PLASTIC, SceneData)
from . import dense, trace
from .megakernel import SHADE_FAMILIES, bsdf_eval_pdf, bsdf_sample

# input rows (the JAX kernel's K_IN layout)
I_P = 0           # hit position (3)
I_NG = 3          # geometric normal (3)
I_S = 6           # frame s (3)
I_T = 9           # frame t (3)
I_N = 12          # frame n, the shading normal (3)
I_D = 15          # incident ray direction (3)
I_TP = 18         # throughput (3)
I_L = 21          # radiance so far, emitter-hit terms included (3)
I_MAT = 24        # material columns 0..12 (13; 24 + 12 = type code)
I_TWO = 37        # two-sided flag (material column 15)
I_ND = 38         # NEE direction (3)
I_NDIST = 41      # NEE distance
I_NPDF = 42       # NEE solid-angle pdf
I_NVAL = 43       # NEE value Le/pdf (3)
I_NDELTA = 46     # NEE delta-emitter flag
I_HIT = 47        # active and hit
I_ACT = 48        # active
I_ETA = 49        # eta_scale carry
K_IN = 50
K_OUT = 16        # o xyz, d xyz, throughput rgb, L rgb, alive, prev_pdf,
                  # prev_delta, eta_scale: PathTracer.bounce's state rows

# RNG dims (mirror integrator/common.py)
SENSOR_DIMS = 4
DIMS_PER_BOUNCE = 8
DIM_BSDF_U2, DIM_BSDF_U1, DIM_RR = 2, 3, 4

SHADOW_EPS = 1e-3     # core/math.py SHADOW_EPSILON

# Kernel launches; only run_shade adds to it.
LAUNCHES = {"shade": 0}


def reset_launches():
    LAUNCHES["shade"] = 0


# composite codes: the JAX kernel's dispatch has no branch for them
_COMPOSITES = {MAT_MIXTURE: "mixture", MAT_COATING: "coating",
               MAT_ROUGH_COATING: "rough coating"}


def supports(scene: SceneData, sampler: str = "independent"
             ) -> tuple[bool, str]:
    """Can the fused tail shade this scene for a tracer drawing from
    `sampler`? (ok, reason). The JAX gate (shade_kernel.py supports: the
    independent sampler, which is the stream the kernel draws, a cluster
    table, families the kernel knows), narrowed where the JAX kernel
    shades wrong: rough plastic reads transmittance rows past the K_IN
    input (RTROW = 34 onward, not packed) and the composites have no
    branch in its dispatch, so both are turned away. The kernel's
    microfacet branches are isotropic GGX, so a Beckmann or anisotropic
    rough conductor and a non-GGX or anisotropic rough dielectric are
    turned away too (the gate of integrator/mega.py) instead of rendering
    as isotropic GGX. The rows the kernel gets are texture-resolved
    (bsdf.resolve_material), and a roughness texture replaces α_u
    (column 9) alone, which makes the eager GGX anisotropic lane by lane
    (it reads α_v from column 10); so a rough conductor or dielectric
    with a roughness texture is turned away as well."""
    if sampler != "independent":
        return False, (f"sampler {sampler!r}: the kernel draws the "
                       "independent stream")
    if scene.woop_clusters is None or scene.cluster_aabb is None:
        return False, "no cluster table"
    fams = set(scene.mat_type.tolist())
    if MAT_ROUGH_PLASTIC in fams:
        return False, ("rough plastic: the kernel's input rows carry "
                       "material columns 0..12 and 15, not the "
                       "transmittance rows it reads")
    comp = sorted(fams & set(_COMPOSITES))
    if comp:
        return False, (f"composite BSDF families {comp} "
                       f"({', '.join(_COMPOSITES[c] for c in comp)}): the "
                       "kernel's dispatch has no branch for them")
    if fams - SHADE_FAMILIES:
        return False, (f"BSDF families {sorted(fams - SHADE_FAMILIES)} not "
                       "in the fused shade kernel")
    mp = scene.mat_params.detach().cpu().numpy()
    rc = mp[mp[:, 12] == MAT_ROUGH_CONDUCTOR]
    if (rc[:, 11] != 1.0).any():
        return False, "Beckmann rough conductor (the kernel's is GGX)"
    if (rc[:, 9] != rc[:, 10]).any():
        return False, "anisotropic rough conductor (the kernel's is isotropic)"
    rd = mp[mp[:, 12] == MAT_ROUGH_DIELECTRIC]
    if (rd[:, 11] != 1.0).any() or (rd[:, 9] != rd[:, 10]).any():
        return False, ("non-GGX/anisotropic rough dielectric (the kernel's "
                       "is isotropic GGX)")
    rough_tex = scene.mat_tex[:, 1].detach().cpu().numpy() >= 0
    if (rough_tex & np.isin(mp[:, 12], (MAT_ROUGH_CONDUCTOR,
                                        MAT_ROUGH_DIELECTRIC))).any():
        return False, ("roughness-textured rough conductor or dielectric: "
                       "the texture sets α_u only, so the eager GGX is "
                       "anisotropic where the kernel's is isotropic")
    return True, ""


def pack_inputs(its, frame, mat, d, throughput, L, ds, active, eta_scale):
    """The K_IN rows [K_IN, N] of the JAX wrapper's packing, from one
    bounce's hit record, shading frame, material rows, ray, carry and NEE
    sample."""
    s_v, t_v, n_v = frame
    f32 = d.dtype
    col = lambda x: x.to(f32)[:, None]
    rows = torch.cat([
        its.p, its.ng, s_v, t_v, n_v, d, throughput, L,
        mat.params[:, 0:13], mat.params[:, 15:16],
        ds.d, col(ds.dist), col(ds.pdf), ds.value, col(ds.is_delta),
        col(active & its.valid), col(active), col(eta_scale)], dim=1)
    return rows.T.contiguous()


def _sgn(x):
    """sign with sign(0) = 0, as the XLA offset_ray_origin."""
    return torch.where(x > 0.0, 1.0, torch.where(x < 0.0, -1.0, 0.0))


class _Front(NamedTuple):
    """The kernel's work before the shadow trace, per lane."""
    wi: tuple            # wi x, y, z in the shading frame (flipped)
    fsign: torch.Tensor  # -1 where the two-sided adapter flipped wi
    wo: tuple            # the NEE direction in the shading frame (flipped)
    f: tuple             # f·cosθo toward the light, r, g, b
    pdf_fwd: torch.Tensor
    contrib: torch.Tensor  # the lane traces a shadow ray (contrib0)
    eps_o: torch.Tensor  # origin offset scale at the hit
    so: torch.Tensor     # [N, 3] shadow-ray origin
    smint: torch.Tensor
    smaxt: torch.Tensor


def _front(v, bounce: int, max_depth: int) -> _Front:
    dx, dy, dz = v[I_D], v[I_D + 1], v[I_D + 2]
    sx, sy, sz = v[I_S], v[I_S + 1], v[I_S + 2]
    tx, ty, tz = v[I_T], v[I_T + 1], v[I_T + 2]
    nx, ny, nz = v[I_N], v[I_N + 1], v[I_N + 2]
    ldx, ldy, ldz = v[I_ND], v[I_ND + 1], v[I_ND + 2]
    # wi in the shading frame; the two-sided flip mirrors back-side
    # incidence into z > 0
    wix = -(dx * sx + dy * sy + dz * sz)
    wiy = -(dx * tx + dy * ty + dz * tz)
    wiz_r = -(dx * nx + dy * ny + dz * nz)
    fsign = torch.where((v[I_TWO] > 0.5) & (wiz_r < 0.0), -1.0, 1.0)
    wiz = wiz_r * fsign

    # ---- NEE: BSDF eval toward the light and its pdf --------------------
    wol_x = ldx * sx + ldy * sy + ldz * sz
    wol_y = ldx * tx + ldy * ty + ldz * tz
    wol_z = (ldx * nx + ldy * ny + ldz * nz) * fsign
    f_r, f_g, f_b, pdf_fwd = bsdf_eval_pdf(v[I_MAT:I_MAT + 13], wix, wiy,
                                           wiz, wol_x, wol_y, wol_z)
    contrib = ((v[I_HIT] > 0.5) & (bounce + 3 <= max_depth + 1)
               & (v[I_NPDF] > 0.0) & ((f_r > 0.0) | (f_g > 0.0)
                                      | (f_b > 0.0)))

    # ---- the shadow ray ----------------------------------------------------
    px_, py_, pz_ = v[I_P], v[I_P + 1], v[I_P + 2]
    ngx, ngy, ngz = v[I_NG], v[I_NG + 1], v[I_NG + 2]
    side = _sgn(ldx * ngx + ldy * ngy + ldz * ngz)
    eps_o = 1e-4 * (1.0 + torch.maximum(torch.maximum(
        torch.abs(px_), torch.abs(py_)), torch.abs(pz_)))
    sox = px_ + side * eps_o * ngx
    soy = py_ + side * eps_o * ngy
    soz = pz_ + side * eps_o * ngz
    smint = 1e-4 * (1.0 + torch.maximum(torch.maximum(
        torch.abs(sox), torch.abs(soy)), torch.abs(soz)))
    return _Front((wix, wiy, wiz), fsign, (wol_x, wol_y, wol_z),
                  (f_r, f_g, f_b), pdf_fwd, contrib,
                  eps_o, torch.stack([sox, soy, soz], -1), smint,
                  v[I_NDIST] * (1.0 - SHADOW_EPS))


def shadow_rays(packed, bounce: int, max_depth: int):
    """The shadow rays the kernel traces at this bounce, from its packed
    input: (o [N, 3], d [N, 3], mint, maxt, live [N] bool). live is the
    kernel's contrib0: hit, NEE allowed, a light sample and the smooth
    lobe nonzero toward it, so delta families trace none."""
    fr = _front(packed, bounce, max_depth)
    d = packed[I_ND:I_ND + 3].T.contiguous()
    return fr.so, d, fr.smint, fr.smaxt, fr.contrib


def shade_plain(scene: SceneData, packed, pixel, samp, seed: int,
                bounce: int, rr_depth: int, max_depth: int):
    """The kernel body (JAX shade_kernel.py:98-233) in PyTorch: packed
    [K_IN, N] f32, pixel and samp [N] integer ids → [K_OUT, N]. Every
    expression is written in the kernel's order. The shadow test is
    accel/dense.py's ray_test over the lanes that contribute."""
    v = packed
    px_, py_, pz_ = v[I_P], v[I_P + 1], v[I_P + 2]
    ngx, ngy, ngz = v[I_NG], v[I_NG + 1], v[I_NG + 2]
    sx, sy, sz = v[I_S], v[I_S + 1], v[I_S + 2]
    tx, ty, tz = v[I_T], v[I_T + 1], v[I_T + 2]
    nx, ny, nz = v[I_N], v[I_N + 1], v[I_N + 2]
    dx, dy, dz = v[I_D], v[I_D + 1], v[I_D + 2]
    tpr, tpg, tpb = v[I_TP], v[I_TP + 1], v[I_TP + 2]
    nvr, nvg, nvb = v[I_NVAL], v[I_NVAL + 1], v[I_NVAL + 2]
    eta_scale = v[I_ETA]
    dim_base = SENSOR_DIMS + bounce * DIMS_PER_BOUNCE
    depth = bounce + 2

    fr = _front(v, bounce, max_depth)
    (wix, wiy, wiz), fsign, (f_r, f_g, f_b) = fr.wi, fr.fsign, fr.f
    occluded = dense.ray_test(scene, fr.so, v[I_ND:I_ND + 3].T, fr.smint,
                              fr.smaxt, fr.contrib)
    w_nee = torch.where(v[I_NDELTA] > 0.5, 1.0,
                        mis_power(v[I_NPDF], fr.pdf_fwd))
    cgate = (fr.contrib & ~occluded).to(v.dtype) * w_nee
    lr = v[I_L] + tpr * nvr * f_r * cgate
    lg = v[I_L + 1] + tpg * nvg * f_g * cgate
    lb = v[I_L + 2] + tpb * nvb * f_b * cgate
    eps_o = fr.eps_o
    hit = v[I_HIT] > 0.5
    mat = v[I_MAT:I_MAT + 13]

    # ---- BSDF sample → next ray ------------------------------------------
    ub = rng.sample_2d(seed, pixel, dim_base + DIM_BSDF_U2, samp)
    uc = rng.sample_1d(seed, pixel, dim_base + DIM_BSDF_U1, samp)
    (nwx, nwy, nwz, w_r, w_g, w_b, pdf_b, is_delta, eta_ev) = bsdf_sample(
        mat, wix, wiy, wiz, ub[:, 0], ub[:, 1], uc)
    nwz = nwz * fsign                      # un-flip (two-sided adapter)
    ndx = nwx * sx + nwy * tx + nwz * nx
    ndy = nwx * sy + nwy * ty + nwz * ny
    ndz = nwx * sz + nwy * tz + nwz * nz
    tp_r, tp_g, tp_b = tpr * w_r, tpg * w_g, tpb * w_b
    alive = (hit & (pdf_b > 0.0) & ((tp_r > 0.0) | (tp_g > 0.0)
                                    | (tp_b > 0.0)) & (depth <= max_depth))

    # ---- Russian roulette (path.cpp:278-289) ----------------------------
    eta_next = eta_scale * eta_ev
    tp_max = torch.maximum(torch.maximum(tp_r, tp_g), tp_b)
    q = torch.clamp(tp_max * eta_next * eta_next, max=0.95)
    if depth >= rr_depth:
        rr_cont = rng.sample_1d(seed, pixel, dim_base + DIM_RR, samp) < q
        rs = torch.where(rr_cont, 1.0 / torch.clamp(q, min=1e-6), 1.0)
        alive = alive & rr_cont
    else:
        rs = torch.ones_like(q)
    af = alive.to(v.dtype)

    side_n = _sgn(ndx * ngx + ndy * ngy + ndz * ngz)
    out = torch.stack([
        px_ + side_n * eps_o * ngx, py_ + side_n * eps_o * ngy,
        pz_ + side_n * eps_o * ngz,
        torch.where(alive, ndx, dx), torch.where(alive, ndy, dy),
        torch.where(alive, ndz, dz),
        tp_r * rs * af, tp_g * rs * af, tp_b * rs * af,
        lr, lg, lb, af, torch.where(is_delta, 1.0, pdf_b),
        is_delta.to(v.dtype), eta_next])
    # lanes inactive on entry: the carry passes through (L kept, o = p)
    zero, one = torch.zeros_like(dx), torch.ones_like(dx)
    through = torch.stack([px_, py_, pz_, dx, dy, dz, zero, zero, zero,
                           v[I_L], v[I_L + 1], v[I_L + 2], zero, one, one,
                           eta_scale])
    return torch.where(v[I_ACT] > 0.5, out, through)


# ---------------------------------------------------------------------------
# the kernel: build, bind, launch
# ---------------------------------------------------------------------------

def build(defines: tuple = ()):
    """Build csrc/shade.cu (trace.build_library) with these walk defines
    (trace.build), and with -fmad=false so every a*b+c rounds twice, as
    shade_plain's eager ops do."""
    return trace.build_library("shade.cu", "mitsuba_shade",
                               ("-fmad=false",) + tuple(defines))


def _library():
    return _bind(build()[0])


@functools.lru_cache(maxsize=None)
def _bind(path):
    fn = ctypes.CDLL(str(path)).mitsuba_shade
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int, ctypes.c_uint32] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def run_shade(scene: SceneData, packed, pixel, samp, seed: int, bounce: int,
              rr_depth: int, max_depth: int):
    """The fused tail over the wavefront: packed [K_IN, N] f32 (see
    pack_inputs), pixel and samp [N] int32 → [K_OUT, N] f32. Launches the
    kernel for CUDA tensors and runs shade_plain for CPU tensors."""
    dev = packed.device
    if dev.type == "cpu":
        return shade_plain(scene, packed, pixel, samp, seed, bounce,
                           rr_depth, max_depth)
    if dev.type != "cuda":
        raise ValueError(f"no shade route for device {dev}")
    n = packed.shape[1]
    check = trace.check_tensor
    check(packed, "packed", torch.float32, (K_IN, n), dev)
    check(pixel, "pixel", torch.int32, (n,), dev)
    check(samp, "samp", torch.int32, (n,), dev)
    woop, aabb = scene.woop_clusters, scene.cluster_aabb
    c = woop.shape[0]
    check(woop, "woop_clusters", torch.float32,
          (c, 3 * trace.TRIS_PER_CLUSTER, 4), dev, align=16)
    check(aabb, "cluster_aabb", torch.float32, (c, 8), dev, align=16)
    n_real = trace.real_tris(scene)
    out = torch.empty((K_OUT, n), dtype=torch.float32, device=dev)
    fn = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(woop.data_ptr(), aabb.data_ptr(), c, n_real,
                 packed.data_ptr(), out.data_ptr(), pixel.data_ptr(),
                 samp.data_ptr(), n, seed & 0xFFFFFFFF, bounce, rr_depth,
                 max_depth, stream)
    if err != 0:
        raise RuntimeError(f"shade kernel launch failed: cudaError_t {err}")
    LAUNCHES["shade"] += 1
    return out


def fused_shade(scene: SceneData, its, frame, mat, d, throughput, L, ds,
                active, eta_scale, seed: int, pixel, samp, bounce: int,
                rr_depth: int, max_depth: int):
    """The shading tail of one bounce (the JAX fused_shade): returns the
    K_OUT rows [16, N] in the order of shade_kernel.py:218-233, o, d,
    throughput, L, alive, prev_pdf, prev_delta, eta_scale, which is
    PathTracer.bounce's state layout. samp is an int or [N] tensor."""
    n = d.shape[0]
    pix = pixel.to(torch.int32).contiguous()
    smp = torch.as_tensor(samp, device=d.device).expand(n).to(
        torch.int32).contiguous()
    packed = pack_inputs(its, frame, mat, d, throughput, L, ds, active,
                         eta_scale)
    return run_shade(scene, packed, pix, smp, seed, bounce, rr_depth,
                     max_depth)
