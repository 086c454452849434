"""BSDFs in the local shading frame (port of mitsuba_tpu/bsdf/bsdf.py: the
diffuse, conductor, rough-conductor and smooth-dielectric families and the
two-sided adapter).

Conventions are the JAX package's: wi points toward the viewer; `eval`
returns f(wi, wo)·|cosθo| (zero for delta lobes); `sample` returns (wo,
weight = f·cos/pdf, pdf, is_delta, eta). Every family in the dispatch set
runs on the whole wavefront and per-lane results are selected by the
material type code; lanes of other codes (misses) get zeros. `families`
restricts the dispatch to the codes a scene uses (None: all ported).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import microfacet as mf
from ..core.fresnel import fresnel_conductor_exact, fresnel_dielectric
from ..core.math import dot, normalize, reflect, refract_local
from ..core.warp import (INV_PI, square_to_cosine_hemisphere,
                         square_to_cosine_hemisphere_pdf)
from ..scene import scene as S

PORTED_FAMILIES = (S.MAT_DIFFUSE, S.MAT_CONDUCTOR, S.MAT_ROUGH_CONDUCTOR,
                   S.MAT_DIELECTRIC)


class BSDFSample(NamedTuple):
    wo: torch.Tensor        # [N, 3] sampled direction (local frame)
    weight: torch.Tensor    # [N, 3] f·cos/pdf
    pdf: torch.Tensor       # [N] solid-angle pdf (delta: discrete prob)
    is_delta: torch.Tensor  # [N] bool
    eta: torch.Tensor       # [N] relative ior of the sampled event


class MatInfo(NamedTuple):
    """Resolved per-lane material row (no composites in the port)."""
    mtype: torch.Tensor     # [N] type code
    params: torch.Tensor    # [N, N_MAT_PARAMS]


def _falses(wi):
    return torch.zeros(wi.shape[:-1], dtype=torch.bool, device=wi.device)


def _ones(wi):
    return torch.ones(wi.shape[:-1], dtype=wi.dtype, device=wi.device)


# ---------------------------------------------------------------------------
# diffuse (ref: src/bsdfs/diffuse.cpp)
# ---------------------------------------------------------------------------

def diffuse_eval(p, wi, wo):
    f = p[:, 0:3] * INV_PI * torch.clamp(wo[:, 2], min=0.0)[:, None]
    valid = (wi[:, 2] > 0) & (wo[:, 2] > 0)
    return torch.where(valid[:, None], f, 0.0)


def diffuse_pdf(p, wi, wo):
    valid = (wi[:, 2] > 0) & (wo[:, 2] > 0)
    return torch.where(valid, square_to_cosine_hemisphere_pdf(wo), 0.0)


def diffuse_sample(p, wi, u2, u1):
    wo = square_to_cosine_hemisphere(u2)
    pdf = square_to_cosine_hemisphere_pdf(wo)
    valid = wi[:, 2] > 0
    weight = torch.where(valid[:, None], p[:, 0:3], 0.0)
    return BSDFSample(wo, weight, torch.where(valid, pdf, 0.0),
                      _falses(wi), torch.ones_like(pdf))


# ---------------------------------------------------------------------------
# conductor: delta mirror (ref: src/bsdfs/conductor.cpp:254-268)
# ---------------------------------------------------------------------------

def conductor_sample(p, wi, u2, u1):
    valid = wi[:, 2] > 0
    f = fresnel_conductor_exact(wi[:, 2], p[:, 0:3], p[:, 3:6]) * p[:, 6:9]
    return BSDFSample(reflect(wi), torch.where(valid[:, None], f, 0.0),
                      torch.where(valid, 1.0, 0.0).to(wi.dtype),
                      torch.ones_like(valid), _ones(wi))


def conductor_eval(p, wi, wo):
    return torch.zeros_like(wi)


def conductor_pdf(p, wi, wo):
    return torch.zeros_like(wi[:, 2])


# ---------------------------------------------------------------------------
# rough conductor: GGX/Beckmann microfacet reflection
# (ref: src/bsdfs/roughconductor.cpp:298-418)
# ---------------------------------------------------------------------------

def _rc_params(p):
    return (p[:, 0:3], p[:, 3:6], p[:, 6:9], p[:, 9], p[:, 10],
            p[:, 11].to(torch.int32))


def roughconductor_eval(p, wi, wo):
    eta, k, spec, au, av, dist = _rc_params(p)
    ct_i, ct_o = wi[:, 2], wo[:, 2]
    h = normalize(wi + wo)
    d = mf.eval_d(h, au, av, dist)
    g = mf.smith_g(wi, wo, h, au, av, dist)
    fr = fresnel_conductor_exact(dot(wi, h), eta, k)
    # f·cosθo = F D G / (4 cosθi)
    val = fr * spec * (d * g / torch.clamp(4.0 * ct_i, min=1e-7))[:, None]
    valid = (ct_i > 1e-7) & (ct_o > 1e-7)
    return torch.where(valid[:, None], val, 0.0)


def roughconductor_pdf(p, wi, wo):
    """Half-vector pdf with the 1/(4 wo·h) Jacobian: visible normals for
    GGX, D·cosθ for Beckmann, so each sampler and its pdf are a pair."""
    _, _, _, au, av, dist = _rc_params(p)
    h = normalize(wi + wo)
    pdf_h = torch.where(dist == mf.GGX, mf.pdf_visible(wi, h, au, av, dist),
                        mf.pdf_all(h, au, av, dist))
    pdf = pdf_h / torch.clamp(4.0 * torch.abs(dot(wo, h)), min=1e-7)
    valid = (wi[:, 2] > 1e-7) & (wo[:, 2] > 1e-7)
    return torch.where(valid, pdf, 0.0)


def roughconductor_sample(p, wi, u2, u1):
    _, _, _, au, av, dist = _rc_params(p)
    m = torch.where((dist == mf.GGX)[:, None],
                    mf.sample_visible(wi, u2, au, av, dist),
                    mf.sample_all(u2, au, av, dist))
    wo = 2.0 * dot(wi, m)[:, None] * m - wi
    pdf = roughconductor_pdf(p, wi, wo)
    weight = roughconductor_eval(p, wi, wo) / torch.clamp(
        pdf, min=1e-12)[:, None]
    valid = (wi[:, 2] > 1e-7) & (wo[:, 2] > 1e-7) & (pdf > 1e-12)
    return BSDFSample(wo, torch.where(valid[:, None], weight, 0.0),
                      torch.where(valid, pdf, 0.0), _falses(wi), _ones(wi))


# ---------------------------------------------------------------------------
# smooth dielectric: delta reflect/refract (ref: src/bsdfs/dielectric.cpp)
# ---------------------------------------------------------------------------

def dielectric_sample(p, wi, u2, u1):
    eta_ratio = torch.clamp(p[:, 0], min=1e-3)
    f, cos_t, eta_it, eta_ti = fresnel_dielectric(wi[:, 2], eta_ratio)
    pick_reflect = u1 < f
    wo = torch.where(pick_reflect[:, None], reflect(wi),
                     refract_local(wi, eta_ratio, cos_t))
    # radiance transport: eta_ti² on refraction (dielectric.cpp:232)
    weight = torch.where(pick_reflect[:, None], p[:, 1:4],
                         p[:, 4:7] * (eta_ti * eta_ti)[:, None])
    return BSDFSample(wo, weight, torch.where(pick_reflect, f, 1.0 - f),
                      torch.ones_like(pick_reflect),
                      torch.where(pick_reflect, 1.0, eta_it))


def dielectric_eval(p, wi, wo):
    return torch.zeros_like(wi)


def dielectric_pdf(p, wi, wo):
    return torch.zeros_like(wi[:, 2])


_SMOOTH_EVAL = {S.MAT_DIFFUSE: diffuse_eval, S.MAT_CONDUCTOR: conductor_eval,
                S.MAT_ROUGH_CONDUCTOR: roughconductor_eval,
                S.MAT_DIELECTRIC: dielectric_eval}
_SMOOTH_PDF = {S.MAT_DIFFUSE: diffuse_pdf, S.MAT_CONDUCTOR: conductor_pdf,
               S.MAT_ROUGH_CONDUCTOR: roughconductor_pdf,
               S.MAT_DIELECTRIC: dielectric_pdf}
_SAMPLERS = {S.MAT_DIFFUSE: diffuse_sample, S.MAT_CONDUCTOR: conductor_sample,
             S.MAT_ROUGH_CONDUCTOR: roughconductor_sample,
             S.MAT_DIELECTRIC: dielectric_sample}


def scene_families(scene: S.SceneData) -> tuple:
    """The sorted material type codes the scene uses (a host read)."""
    return tuple(sorted(set(scene.mat_type.tolist())))


def _codes(table, families):
    if families is None:
        return list(table.items())
    return [(c, f) for c, f in table.items() if c in families]


def resolve_material(scene: S.SceneData, mat_id) -> MatInfo:
    """One gather of the material rows (mat_id -1 reads row 0, as in the
    JAX package; such lanes are masked by the caller)."""
    params = scene.mat_params[torch.clamp(mat_id, min=0)]
    return MatInfo(params[:, 12].long(), params)


def perturb_shading_frame(scene: S.SceneData, mat: MatInfo, frame, uv):
    """Normal/bump-map frame perturbation: the identity, since the port's
    scenes carry no normal or bump maps (compile_scene rejects them)."""
    return frame


def _flip_z(v):
    return torch.stack([v[:, 0], v[:, 1], -v[:, 2]], dim=-1)


def _twosided_wi(params, wi):
    """twosided adapter (ref: src/bsdfs/twosided.cpp): materials flagged
    two-sided (param slot 15) see back-side incidence mirrored into the
    upper hemisphere; sampled and evaluated directions mirror back."""
    flip = (params[:, 15] > 0.5) & (wi[:, 2] < 0.0)
    return torch.where(flip[:, None], _flip_z(wi), wi), flip


def eval_bsdf_ex(mat: MatInfo, wi, wo, families=None):
    """f(wi, wo)·cosθo of the smooth component (zero for delta lobes)."""
    wi, flip = _twosided_wi(mat.params, wi)
    wo = torch.where(flip[:, None], _flip_z(wo), wo)
    out = torch.zeros_like(wi)
    for code, fn in _codes(_SMOOTH_EVAL, families):
        out = torch.where((mat.mtype == code)[:, None],
                          fn(mat.params, wi, wo), out)
    return out


def pdf_bsdf_ex(mat: MatInfo, wi, wo, families=None):
    wi, flip = _twosided_wi(mat.params, wi)
    wo = torch.where(flip[:, None], _flip_z(wo), wo)
    out = torch.zeros_like(wi[:, 2])
    for code, fn in _codes(_SMOOTH_PDF, families):
        out = torch.where(mat.mtype == code, fn(mat.params, wi, wo), out)
    return out


def sample_bsdf_ex(mat: MatInfo, wi, u2, u1, families=None) -> BSDFSample:
    wi, flip = _twosided_wi(mat.params, wi)
    wo, weight = torch.zeros_like(wi), torch.zeros_like(wi)
    pdf, eta = torch.zeros_like(wi[:, 2]), _ones(wi)
    is_delta = _falses(wi)
    for code, fn in _codes(_SAMPLERS, families):
        s = fn(mat.params, wi, u2, u1)
        sel = mat.mtype == code
        wo = torch.where(sel[:, None], s.wo, wo)
        weight = torch.where(sel[:, None], s.weight, weight)
        pdf = torch.where(sel, s.pdf, pdf)
        is_delta = torch.where(sel, s.is_delta, is_delta)
        eta = torch.where(sel, s.eta, eta)
    wo = torch.where(flip[:, None], _flip_z(wo), wo)
    return BSDFSample(wo, weight, pdf, is_delta, eta)
