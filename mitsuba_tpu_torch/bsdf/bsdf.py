"""BSDFs in the local shading frame (port of mitsuba_tpu/bsdf/bsdf.py: the
14 leaf families, the two-sided adapter and the composites: mixture,
blend and mask (one convex-sum code), smooth coating and rough coating,
each over leaf children).

Conventions are the JAX package's: wi points toward the viewer; `eval`
returns f(wi, wo)·|cosθo| (zero for delta lobes); `sample` returns (wo,
weight = f·cos/pdf, pdf, is_delta, eta). Every family in the dispatch set
runs on the whole wavefront and per-lane results are selected by the
material type code; lanes of other codes (misses) get zeros. `families`
restricts the dispatch to the codes a scene uses (None: all ported).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import microfacet as mf
from ..core.fresnel import (fresnel_conductor_exact, fresnel_dielectric,
                            fresnel_diffuse_reflectance)
from ..core.math import Frame, dot, normalize, reflect, refract_local
from ..core.warp import (INV_PI, square_to_cosine_hemisphere,
                         square_to_cosine_hemisphere_pdf)
from ..scene import scene as S
from ..texture.texture import MAX_MIPS, eval_texture
from . import rtrans

LEAF_FAMILIES = (S.MAT_DIFFUSE, S.MAT_CONDUCTOR, S.MAT_ROUGH_CONDUCTOR,
                 S.MAT_DIELECTRIC, S.MAT_PLASTIC, S.MAT_ROUGH_DIELECTRIC,
                 S.MAT_ROUGH_PLASTIC, S.MAT_PHONG, S.MAT_WARD,
                 S.MAT_ROUGH_DIFFUSE, S.MAT_NULL, S.MAT_THIN_DIELECTRIC,
                 S.MAT_DIFFTRANS, S.MAT_ANISO_ROUGHDIFFUSE)
COMPOSITE_FAMILIES = (S.MAT_MIXTURE, S.MAT_COATING, S.MAT_ROUGH_COATING)
PORTED_FAMILIES = LEAF_FAMILIES + COMPOSITE_FAMILIES
# leaf families whose sampled direction is a function of wi and the draws
# alone (a cosine-weighted, mirror or pass-through lobe, picked by a
# comparison): a ray leaving such a surface carries no gradient of the
# material rows
FIXED_DIRECTION_FAMILIES = frozenset({
    S.MAT_DIFFUSE, S.MAT_CONDUCTOR, S.MAT_PLASTIC, S.MAT_ROUGH_DIFFUSE,
    S.MAT_NULL, S.MAT_THIN_DIELECTRIC, S.MAT_DIFFTRANS,
    S.MAT_ANISO_ROUGHDIFFUSE})


class BSDFSample(NamedTuple):
    wo: torch.Tensor        # [N, 3] sampled direction (local frame)
    weight: torch.Tensor    # [N, 3] f·cos/pdf
    pdf: torch.Tensor       # [N] solid-angle pdf (delta: discrete prob)
    is_delta: torch.Tensor  # [N] bool
    eta: torch.Tensor       # [N] relative ior of the sampled event


class MatInfo(NamedTuple):
    """Resolved per-lane material: the top row and, for composites, the
    child rows. For leaf lanes the children alias the top row and w_a is
    1."""
    mtype: torch.Tensor     # [N] top type code
    params: torch.Tensor    # [N, N_MAT_PARAMS] top row
    mtype_a: torch.Tensor   # [N] child-A type (== mtype: leaf)
    params_a: torch.Tensor  # [N, N_MAT_PARAMS]
    mtype_b: torch.Tensor   # [N] child-B type
    params_b: torch.Tensor
    w_a: torch.Tensor       # [N] mixture weight of child A


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


# ---------------------------------------------------------------------------
# rough diffuse / Oren-Nayar (ref: src/bsdfs/roughdiffuse.cpp, fast approx)
# ---------------------------------------------------------------------------

def roughdiffuse_eval(p, wi, wo):
    albedo = p[:, 0:3]
    # conversion: sigma = alpha/sqrt(2) (roughdiffuse.cpp:129)
    sigma = p[:, 9] * 0.70711
    sigma2 = sigma * sigma
    a = 1.0 - sigma2 / (2.0 * (sigma2 + 0.33))
    b = 0.45 * sigma2 / (sigma2 + 0.09)
    ct_i, ct_o = wi[:, 2], wo[:, 2]
    st_i = torch.sqrt(torch.clamp(1 - ct_i * ct_i, min=0.0))
    st_o = torch.sqrt(torch.clamp(1 - ct_o * ct_o, min=0.0))
    denom = torch.clamp(st_i * st_o, min=1e-7)
    cos_dphi = torch.clamp((wi[:, 0] * wo[:, 0] + wi[:, 1] * wo[:, 1])
                           / denom, -1.0, 1.0)
    sin_alpha = torch.maximum(st_i, st_o)
    tan_beta = torch.minimum(st_i / torch.clamp(ct_i, min=1e-7),
                             st_o / torch.clamp(ct_o, min=1e-7))
    f = (albedo * INV_PI
         * (a + b * torch.clamp(cos_dphi, min=0.0) * sin_alpha * tan_beta
            )[:, None] * torch.clamp(ct_o, min=0.0)[:, None])
    valid = (ct_i > 0) & (ct_o > 0)
    return torch.where(valid[:, None], f, 0.0)


def roughdiffuse_pdf(p, wi, wo):
    return diffuse_pdf(p, wi, wo)


def _cosine_weighted(eval_fn, p, wi, u2):
    """A cosine-hemisphere sample weighted f/pdf (roughdiffuse_sample,
    anisoroughdiffuse_sample)."""
    wo = square_to_cosine_hemisphere(u2)
    pdf = diffuse_pdf(p, wi, wo)
    f = eval_fn(p, wi, wo)
    w = torch.where(pdf[:, None] > 0,
                    f / torch.clamp(pdf, min=1e-6)[:, None], 0.0)
    return BSDFSample(wo, w, pdf, _falses(wi), _ones(wi))


def roughdiffuse_sample(p, wi, u2, u1):
    return _cosine_weighted(roughdiffuse_eval, p, wi, u2)


# ---------------------------------------------------------------------------
# LEADR anisotropic rough diffuse (ref: src/bsdfs/aniso_roughdiffuse.cpp):
# the slope Gaussian's expectation by a deterministic 4-point unscented
# quadrature, Smith G2 from the moments (the JAX package's form)
# ---------------------------------------------------------------------------

def _leadr_lambda(w, mux, muy, sx2, sy2, cxy):
    ct = w[:, 2]
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    st_s = torch.clamp(st, min=1e-7)
    cphi, sphi = w[:, 0] / st_s, w[:, 1] / st_s
    cot = ct / st_s
    mu_phi = cphi * mux + sphi * muy
    s2_phi = torch.clamp(cphi * cphi * sx2 + sphi * sphi * sy2
                         + 2.0 * cphi * sphi * cxy, min=1e-12)
    v = (cot - mu_phi) / torch.sqrt(2.0 * s2_phi)
    lam = torch.where(
        v < 0.0, 1e8,
        torch.where(v < 1.6,
                    (1.0 - 1.259 * v + 0.396 * v * v)
                    / torch.clamp(3.535 * v + 2.181 * v * v, min=1e-12),
                    0.0))
    return torch.where(st < 1e-6, 0.0, lam)


def anisoroughdiffuse_eval(p, wi, wo):
    albedo = p[:, 0:3]
    mux, muy = p[:, 3], p[:, 4]
    sx2 = torch.clamp(p[:, 5] - mux * mux, min=1e-8)
    sy2 = torch.clamp(p[:, 6] - muy * muy, min=1e-8)
    cxy = p[:, 7] - mux * muy
    use_vis = p[:, 11] > 0.5
    # mesoscale normal from the mean slope
    ml = torch.rsqrt(mux * mux + muy * muy + 1.0)
    mnx, mny, mnz = -mux * ml, -muy * ml, ml
    wi_dot_n = wi[:, 0] * mnx + wi[:, 1] * mny + wi[:, 2] * mnz
    g2 = 1.0 / (1.0 + _leadr_lambda(wi, mux, muy, sx2, sy2, cxy)
                + _leadr_lambda(wo, mux, muy, sx2, sy2, cxy))
    # Cholesky factor of the slope covariance
    l11 = torch.sqrt(sx2)
    l21 = cxy / l11
    l22 = torch.sqrt(torch.clamp(sy2 - l21 * l21, min=1e-12))
    r = 0.0
    s2 = math.sqrt(2.0)
    for (z0, z1) in ((s2, 0.0), (-s2, 0.0), (0.0, s2), (0.0, -s2)):
        sx = mux + l11 * z0
        sy = muy + l21 * z0 + l22 * z1
        il = torch.rsqrt(sx * sx + sy * sy + 1.0)
        wmx, wmy, wmz = -sx * il, -sy * il, il
        di = torch.clamp(wmx * wi[:, 0] + wmy * wi[:, 1] + wmz * wi[:, 2],
                         min=0.0)
        do = torch.clamp(wmx * wo[:, 0] + wmy * wo[:, 1] + wmz * wo[:, 2],
                         min=0.0)
        term = di * do / wmz
        term = torch.where(use_vis & (di > 1e-7) & (do > 1e-7), term * g2,
                           torch.where(use_vis, 0.0, term))
        r = r + 0.25 * term
    scale = INV_PI * mnz / torch.clamp(wi_dot_n, min=1e-7) * r
    valid = (wi[:, 2] > 0) & (wo[:, 2] > 0) & (wi_dot_n > 0)
    return torch.where(valid[:, None], albedo * scale[:, None], 0.0)


def anisoroughdiffuse_pdf(p, wi, wo):
    return diffuse_pdf(p, wi, wo)


def anisoroughdiffuse_sample(p, wi, u2, u1):
    return _cosine_weighted(anisoroughdiffuse_eval, p, wi, u2)


# ---------------------------------------------------------------------------
# rough dielectric: microfacet refraction (ref: src/bsdfs/roughdielectric.cpp,
# Walter et al. 2007)
# ---------------------------------------------------------------------------

def _rd_params(p):
    return (torch.clamp(p[:, 0], min=1e-3), p[:, 1:4], p[:, 4:7], p[:, 9],
            p[:, 10], p[:, 11].to(torch.int32))


def _rd_halfvec(wi, wo, eta, reflect_side):
    """Upper-hemisphere micronormal for a (wi, wo) pair: reflection
    m ∝ wi + wo; transmission m ∝ wi + η_it·wo (Walter 2007 eq. 16)."""
    eta_it = torch.where(wi[:, 2] > 0, eta, 1.0 / eta)
    m_r = normalize(wi + wo)
    m_t = normalize(wi + eta_it[:, None] * wo)
    m = torch.where(reflect_side[:, None], m_r, m_t)
    return m * torch.sign(m[:, 2:3])


def roughdielectric_eval(p, wi, wo):
    eta, spec_r, spec_t, au, av, dist = _rd_params(p)
    ci, co = wi[:, 2], wo[:, 2]
    reflect_side = ci * co > 0
    m = _rd_halfvec(wi, wo, eta, reflect_side)
    f, _, eta_itm, _ = fresnel_dielectric(dot(wi, m), eta)
    d_ndf = mf.eval_d(m, au, av, dist)
    g = mf.smith_g(wi, wo, m, au, av, dist)
    val_r = spec_r * (f * d_ndf * g
                      / torch.clamp(4.0 * torch.abs(ci), min=1e-7))[:, None]
    wim, wom = dot(wi, m), dot(wo, m)
    denom_t = (wim + eta_itm * wom) ** 2
    val_t = spec_t * ((1.0 - f) * d_ndf * g * torch.abs(wim * wom)
                      / torch.clamp(torch.abs(ci) * denom_t, min=1e-7)
                      )[:, None]
    val = torch.where(reflect_side[:, None], val_r, val_t)
    # Walter's side condition: same side of m for reflection, opposite
    # sides for transmission
    chirality_ok = torch.where(reflect_side, wim * wom > 0, wim * wom < 0)
    valid = (torch.abs(ci) > 1e-7) & chirality_ok
    return torch.where(valid[:, None], val, 0.0)


def roughdielectric_pdf(p, wi, wo):
    eta, _, _, au, av, dist = _rd_params(p)
    ci, co = wi[:, 2], wo[:, 2]
    reflect_side = ci * co > 0
    m = _rd_halfvec(wi, wo, eta, reflect_side)
    side = torch.sign(ci)[:, None]
    pdf_m = torch.where(dist == mf.GGX,
                        mf.pdf_visible(wi * side, m, au, av, dist),
                        mf.pdf_all(m, au, av, dist))
    f, _, eta_itm, _ = fresnel_dielectric(dot(wi, m), eta)
    wim, wom = dot(wi, m), dot(wo, m)
    jac_r = 1.0 / torch.clamp(4.0 * torch.abs(wom), min=1e-7)
    jac_t = (torch.abs(wom) * eta_itm ** 2
             / torch.clamp((wim + eta_itm * wom) ** 2, min=1e-7))
    pdf = pdf_m * torch.where(reflect_side, f * jac_r, (1.0 - f) * jac_t)
    chirality_ok = torch.where(reflect_side, wim * wom > 0, wim * wom < 0)
    return torch.where((torch.abs(ci) > 1e-7) & chirality_ok, pdf, 0.0)


def roughdielectric_sample(p, wi, u2, u1):
    eta, _, _, au, av, dist = _rd_params(p)
    ci = wi[:, 2]
    wi_up = wi * torch.sign(ci)[:, None]
    m_up = torch.where((dist == mf.GGX)[:, None],
                       mf.sample_visible(wi_up, u2, au, av, dist),
                       mf.sample_all(u2, au, av, dist))
    cos_im = dot(wi, m_up)                   # signed
    f, cos_t, eta_itm, eta_tim = fresnel_dielectric(cos_im, eta)
    pick_reflect = u1 < f
    wo_r = 2.0 * cos_im[:, None] * m_up - wi
    wo_t = (-eta_tim[:, None] * wi
            + (eta_tim * cos_im + cos_t)[:, None] * m_up)
    wo = torch.where(pick_reflect[:, None], wo_r, normalize(wo_t))
    pdf = roughdielectric_pdf(p, wi, wo)
    weight = roughdielectric_eval(p, wi, wo) / torch.clamp(
        pdf, min=1e-12)[:, None]
    co = wo[:, 2]
    side_ok = torch.where(pick_reflect, ci * co > 1e-10, ci * co < -1e-10)
    valid = (torch.abs(ci) > 1e-7) & (pdf > 1e-12) & side_ok
    eta_event = torch.where(pick_reflect, 1.0, eta_itm)
    return BSDFSample(wo, torch.where(valid[:, None], weight, 0.0),
                      torch.where(valid, pdf, 0.0), _falses(wi), eta_event)


# ---------------------------------------------------------------------------
# ward: anisotropic glossy (ref: src/bsdfs/ward.cpp, balanced variant)
# ---------------------------------------------------------------------------

def _ward_alphas(p):
    return torch.clamp(p[:, 9], min=1e-3), torch.clamp(p[:, 10], min=1e-3)


def ward_eval(p, wi, wo):
    kd, ks = p[:, 0:3], p[:, 3:6]
    au, av = _ward_alphas(p)
    ci, co = wi[:, 2], wo[:, 2]
    h = wi + wo
    ex = -((h[:, 0] / au) ** 2 + (h[:, 1] / av) ** 2) \
        / torch.clamp(h[:, 2] ** 2, min=1e-12)
    spec = (torch.exp(ex) / (4.0 * math.pi * au * av
                             * torch.clamp(torch.sqrt(ci * co), min=1e-6)))
    f = kd * (INV_PI * co)[:, None] + ks * (spec * co)[:, None]
    valid = (ci > 0) & (co > 0)
    return torch.where(valid[:, None], f, 0.0)


def _spec_prob(p):
    """Specular sampling weight max(ks) / (max(kd) + max(ks)) (ward and
    phong)."""
    sd = torch.amax(p[:, 0:3], dim=-1)
    ss = torch.amax(p[:, 3:6], dim=-1)
    return ss / torch.clamp(sd + ss, min=1e-7)


def ward_pdf(p, wi, wo):
    au, av = _ward_alphas(p)
    prob_s = _spec_prob(p)
    h = normalize(wi + wo)
    ex = -((h[:, 0] / au) ** 2 + (h[:, 1] / av) ** 2) \
        / torch.clamp(h[:, 2] ** 2, min=1e-12)
    pdf_h = torch.exp(ex) / (math.pi * au * av
                             * torch.clamp(h[:, 2] ** 3, min=1e-6))
    pdf_s = pdf_h / torch.clamp(4.0 * torch.abs(dot(wo, h)), min=1e-6)
    pdf_d = square_to_cosine_hemisphere_pdf(wo)
    valid = (wi[:, 2] > 0) & (wo[:, 2] > 0)
    return torch.where(valid, prob_s * pdf_s + (1 - prob_s) * pdf_d, 0.0)


def ward_sample(p, wi, u2, u1):
    au, av = _ward_alphas(p)
    pick_s = u1 < _spec_prob(p)
    # half-vector: φh from the anisotropic warp, θh from the exponential
    phi = torch.atan2(av * torch.sin(2 * math.pi * u2[:, 1]),
                      au * torch.cos(2 * math.pi * u2[:, 1]))
    cp, sp = torch.cos(phi), torch.sin(phi)
    t2 = -torch.log(torch.clamp(u2[:, 0], min=1e-7)) \
        / ((cp / au) ** 2 + (sp / av) ** 2)
    ct = 1.0 / torch.sqrt(1.0 + t2)
    st = torch.sqrt(torch.clamp(1 - ct * ct, min=0.0))
    h = torch.stack([st * cp, st * sp, ct], dim=-1)
    wo_s = 2.0 * dot(wi, h)[:, None] * h - wi
    wo = torch.where(pick_s[:, None], wo_s, square_to_cosine_hemisphere(u2))
    pdf = ward_pdf(p, wi, wo)
    w = torch.where(pdf[:, None] > 1e-6, ward_eval(p, wi, wo)
                    / torch.clamp(pdf, min=1e-6)[:, None], 0.0)
    return BSDFSample(wo, w, pdf, _falses(wi), _ones(wi))


# ---------------------------------------------------------------------------
# null: pass-through (ref: src/bsdfs/null.cpp)
# ---------------------------------------------------------------------------

def null_sample(p, wi, u2, u1):
    ones = _ones(wi)
    return BSDFSample(-wi, torch.ones_like(wi), ones,
                      torch.ones_like(_falses(wi)), ones)


# ---------------------------------------------------------------------------
# thin dielectric (ref: src/bsdfs/thindielectric.cpp)
# ---------------------------------------------------------------------------

def thindielectric_sample(p, wi, u2, u1):
    eta_ratio = torch.clamp(p[:, 0], min=1e-3)
    f = fresnel_dielectric(torch.abs(wi[:, 2]), eta_ratio)[0]
    # the slab's internal bounces: R' = R + T²R/(1 - R²)
    f = torch.where(f < 1.0, f + (1.0 - f) * (1.0 - f) * f
                    / torch.clamp(1.0 - f * f, min=1e-7), f)
    pick_reflect = u1 < f
    wo = torch.where(pick_reflect[:, None], reflect(wi), -wi)
    weight = torch.where(pick_reflect[:, None], p[:, 1:4], p[:, 4:7])
    return BSDFSample(wo, weight, torch.where(pick_reflect, f, 1.0 - f),
                      torch.ones_like(pick_reflect), _ones(wi))


# ---------------------------------------------------------------------------
# plastic: delta coat over diffuse (ref: src/bsdfs/plastic.cpp)
# ---------------------------------------------------------------------------

def _plastic_parts(p):
    return torch.clamp(p[:, 0], min=1e-3), p[:, 1:4], p[:, 4:7], p[:, 7]


def _diffuse_weight(kd, inv_eta2, fdr, nonlinear):
    """Internal-scattering-compensated diffuse term (plastic.cpp:~300)."""
    denom = torch.where(nonlinear[:, None] > 0.5, 1.0 - kd * fdr[:, None],
                        (1.0 - fdr)[:, None])
    return kd * inv_eta2[:, None] / torch.clamp(denom, min=1e-4)


def _plastic_diffuse_weight(eta, kd, nonlinear):
    return _diffuse_weight(kd, 1.0 / (eta * eta),
                           fresnel_diffuse_reflectance(1.0 / eta), nonlinear)


def plastic_eval(p, wi, wo):
    eta, kd, ks, nonlinear = _plastic_parts(p)
    ct_i, ct_o = wi[:, 2], wo[:, 2]
    fi = fresnel_dielectric(ct_i, eta)[0]
    fo = fresnel_dielectric(ct_o, eta)[0]
    diff = _plastic_diffuse_weight(eta, kd, nonlinear)
    f = diff * (INV_PI * (1.0 - fi) * (1.0 - fo)
                * torch.clamp(ct_o, min=0.0))[:, None]
    valid = (ct_i > 0) & (ct_o > 0)
    return torch.where(valid[:, None], f, 0.0)


def plastic_pdf(p, wi, wo):
    eta = _plastic_parts(p)[0]
    fi = fresnel_dielectric(wi[:, 2], eta)[0]
    pdf_d = square_to_cosine_hemisphere_pdf(wo) * (1.0 - fi)
    valid = (wi[:, 2] > 0) & (wo[:, 2] > 0)
    return torch.where(valid, pdf_d, 0.0)


def plastic_sample(p, wi, u2, u1):
    eta, kd, ks, nonlinear = _plastic_parts(p)
    ct_i = wi[:, 2]
    fi = fresnel_dielectric(ct_i, eta)[0]
    pick_spec = u1 < fi
    wo = torch.where(pick_spec[:, None], reflect(wi),
                     square_to_cosine_hemisphere(u2))
    # specular event: weight = ks (the pick probability F cancels Fresnel)
    fo = fresnel_dielectric(wo[:, 2], eta)[0]
    diff = _plastic_diffuse_weight(eta, kd, nonlinear)
    w_diff = diff * ((1.0 - fi) * (1.0 - fo)
                     / torch.clamp(1.0 - fi, min=1e-7))[:, None]
    weight = torch.where(pick_spec[:, None], ks, w_diff)
    pdf = torch.where(pick_spec, fi,
                      (1.0 - fi) * square_to_cosine_hemisphere_pdf(wo))
    valid = ct_i > 0
    return BSDFSample(wo, torch.where(valid[:, None], weight, 0.0),
                      torch.where(valid, pdf, 0.0), pick_spec, _ones(wi))


# ---------------------------------------------------------------------------
# rough plastic: GGX/Beckmann coat over an internally scattering diffuse
# base (ref: src/bsdfs/roughplastic.cpp), with bsdf/rtrans.py's tables
# ---------------------------------------------------------------------------

def _rp_parts(p):
    return (torch.clamp(p[:, 0], min=1e-3), p[:, 1:4], p[:, 4:7], p[:, 7],
            torch.clamp(p[:, 9], min=1e-4), p[:, 11].to(torch.int32))


def _rough_t(eta, a, ct, dist):
    """External rough transmittance T(η, α, cosθ) per distribution
    (roughplastic.cpp m_externalRoughTransmittance)."""
    t_ggx = rtrans.lookup(rtrans.transmittance_table(True), eta, a, ct)
    t_bk = rtrans.lookup(rtrans.transmittance_table(False), eta, a, ct)
    return torch.where(dist == mf.GGX, t_ggx, t_bk)


def _rough_fdr(eta, a, dist):
    """Internal diffuse Fresnel reflectance 1 − evalDiffuse(α)
    (roughplastic.cpp m_internalRoughTransmittance)."""
    d_ggx = rtrans.lookup_diffuse(rtrans.diffuse_transmittance_inv(True),
                                  eta, a)
    d_bk = rtrans.lookup_diffuse(rtrans.diffuse_transmittance_inv(False),
                                 eta, a)
    return 1.0 - torch.where(dist == mf.GGX, d_ggx, d_bk)


def roughplastic_eval(p, wi, wo):
    eta, kd, ks, nonlinear, a, dist = _rp_parts(p)
    ci, co = wi[:, 2], wo[:, 2]
    h = normalize(wi + wo)
    fm = fresnel_dielectric(dot(wi, h), eta)[0]
    d_ndf = mf.eval_d(h, a, a, dist)
    g = mf.smith_g(wi, wo, h, a, a, dist)
    spec = ks * (fm * d_ndf * g / torch.clamp(4.0 * ci, min=1e-7))[:, None]
    t12 = _rough_t(eta, a, ci, dist)
    t21 = _rough_t(eta, a, co, dist)
    diff = _diffuse_weight(kd, 1.0 / (eta * eta), _rough_fdr(eta, a, dist),
                           nonlinear)
    diffuse = diff * (INV_PI * t12 * t21
                      * torch.clamp(co, min=0.0))[:, None]
    valid = (ci > 0) & (co > 0)
    return torch.where(valid[:, None], spec + diffuse, 0.0)


def _rp_spec_prob(p, wi):
    fi = fresnel_dielectric(wi[:, 2], _rp_parts(p)[0])[0]
    return torch.clamp(fi, 0.25, 0.9)


def roughplastic_pdf(p, wi, wo):
    a, dist = _rp_parts(p)[4:]
    prob_s = _rp_spec_prob(p, wi)
    h = normalize(wi + wo)
    pdf_h = torch.where(dist == mf.GGX, mf.pdf_visible(wi, h, a, a, dist),
                        mf.pdf_all(h, a, a, dist))
    pdf_s = pdf_h / torch.clamp(4.0 * torch.abs(dot(wo, h)), min=1e-7)
    pdf_d = square_to_cosine_hemisphere_pdf(wo)
    valid = (wi[:, 2] > 0) & (wo[:, 2] > 0)
    return torch.where(valid, prob_s * pdf_s + (1 - prob_s) * pdf_d, 0.0)


def roughplastic_sample(p, wi, u2, u1):
    a, dist = _rp_parts(p)[4:]
    pick_s = u1 < _rp_spec_prob(p, wi)
    m = torch.where((dist == mf.GGX)[:, None],
                    mf.sample_visible(wi, u2, a, a, dist),
                    mf.sample_all(u2, a, a, dist))
    wo_s = 2.0 * dot(wi, m)[:, None] * m - wi
    wo = torch.where(pick_s[:, None], wo_s, square_to_cosine_hemisphere(u2))
    pdf = roughplastic_pdf(p, wi, wo)
    w = torch.where(pdf[:, None] > 1e-12, roughplastic_eval(p, wi, wo)
                    / torch.clamp(pdf, min=1e-12)[:, None], 0.0)
    valid = (wi[:, 2] > 0) & (wo[:, 2] > 0) & (pdf > 1e-12)
    return BSDFSample(wo, torch.where(valid[:, None], w, 0.0),
                      torch.where(valid, pdf, 0.0), _falses(wi), _ones(wi))


# ---------------------------------------------------------------------------
# phong (ref: src/bsdfs/phong.cpp): modified Phong, diffuse + glossy mix
# ---------------------------------------------------------------------------

def phong_eval(p, wi, wo):
    kd, ks, n = p[:, 0:3], p[:, 3:6], p[:, 6]
    ct_o = torch.clamp(wo[:, 2], min=0.0)
    alpha = torch.clamp(dot(reflect(wi), wo), min=1e-7)
    glossy = ks * ((n + 2.0) * (0.5 * INV_PI)
                   * torch.pow(alpha, n) * ct_o)[:, None]
    diff = kd * (INV_PI * ct_o)[:, None]
    valid = (wi[:, 2] > 0) & (wo[:, 2] > 0)
    return torch.where(valid[:, None], glossy + diff, 0.0)


def phong_pdf(p, wi, wo):
    n = p[:, 6]
    prob_s = _spec_prob(p)
    alpha = torch.clamp(dot(reflect(wi), wo), min=1e-7)
    pdf_s = (n + 1.0) * (0.5 * INV_PI) * torch.pow(alpha, n)
    pdf_d = square_to_cosine_hemisphere_pdf(wo)
    valid = (wi[:, 2] > 0) & (wo[:, 2] > 0)
    return torch.where(valid, prob_s * pdf_s + (1 - prob_s) * pdf_d, 0.0)


def phong_sample(p, wi, u2, u1):
    n = p[:, 6]
    pick_s = u1 < _spec_prob(p)
    # glossy: a lobe around the mirror direction
    cos_a = torch.pow(torch.clamp(u2[:, 0], min=1e-7), 1.0 / (n + 1.0))
    sin_a = torch.sqrt(torch.clamp(1 - cos_a * cos_a, min=0.0))
    phi = 2 * math.pi * u2[:, 1]
    local = torch.stack([sin_a * torch.cos(phi), sin_a * torch.sin(phi),
                         cos_a], dim=-1)
    wo_s = Frame.to_world(Frame.from_normal(reflect(wi)), local)
    wo = torch.where(pick_s[:, None], wo_s, square_to_cosine_hemisphere(u2))
    pdf = phong_pdf(p, wi, wo)
    w = torch.where(pdf[:, None] > 1e-6, phong_eval(p, wi, wo)
                    / torch.clamp(pdf, min=1e-6)[:, None], 0.0)
    return BSDFSample(wo, w, pdf, _falses(wi), _ones(wi))


# ---------------------------------------------------------------------------
# difftrans: diffuse transmitter (ref: src/bsdfs/difftrans.cpp)
# ---------------------------------------------------------------------------

def difftrans_eval(p, wi, wo):
    f = p[:, 0:3] * INV_PI * torch.abs(wo[:, 2])[:, None]
    valid = wi[:, 2] * wo[:, 2] < 0      # opposite hemispheres
    return torch.where(valid[:, None], f, 0.0)


def difftrans_pdf(p, wi, wo):
    valid = wi[:, 2] * wo[:, 2] < 0
    return torch.where(valid, torch.abs(wo[:, 2]) * INV_PI, 0.0)


def difftrans_sample(p, wi, u2, u1):
    wo_up = square_to_cosine_hemisphere(u2)
    # transmit: flip to the side opposite wi
    sgn = torch.sign(wi[:, 2])[:, None]
    wo = wo_up * torch.cat([torch.ones_like(sgn), torch.ones_like(sgn),
                            -sgn], dim=-1)
    pdf = torch.abs(wo[:, 2]) * INV_PI
    valid = torch.abs(wi[:, 2]) > 0
    return BSDFSample(wo, torch.where(valid[:, None], p[:, 0:3], 0.0),
                      torch.where(valid, pdf, 0.0), _falses(wi), _ones(wi))


_SMOOTH_EVAL = {
    S.MAT_DIFFTRANS: difftrans_eval,
    S.MAT_ROUGH_PLASTIC: roughplastic_eval,
    S.MAT_DIFFUSE: diffuse_eval,
    S.MAT_ROUGH_DIFFUSE: roughdiffuse_eval,
    S.MAT_ANISO_ROUGHDIFFUSE: anisoroughdiffuse_eval,
    S.MAT_ROUGH_CONDUCTOR: roughconductor_eval,
    S.MAT_ROUGH_DIELECTRIC: roughdielectric_eval,
    S.MAT_PLASTIC: plastic_eval,
    S.MAT_PHONG: phong_eval,
    S.MAT_WARD: ward_eval,
}
_SMOOTH_PDF = {
    S.MAT_DIFFTRANS: difftrans_pdf,
    S.MAT_ROUGH_PLASTIC: roughplastic_pdf,
    S.MAT_DIFFUSE: diffuse_pdf,
    S.MAT_ROUGH_DIFFUSE: roughdiffuse_pdf,
    S.MAT_ANISO_ROUGHDIFFUSE: anisoroughdiffuse_pdf,
    S.MAT_ROUGH_CONDUCTOR: roughconductor_pdf,
    S.MAT_ROUGH_DIELECTRIC: roughdielectric_pdf,
    S.MAT_PLASTIC: plastic_pdf,
    S.MAT_PHONG: phong_pdf,
    S.MAT_WARD: ward_pdf,
}
_SAMPLERS = {
    S.MAT_DIFFTRANS: difftrans_sample,
    S.MAT_ROUGH_PLASTIC: roughplastic_sample,
    S.MAT_DIFFUSE: diffuse_sample,
    S.MAT_ROUGH_DIFFUSE: roughdiffuse_sample,
    S.MAT_ANISO_ROUGHDIFFUSE: anisoroughdiffuse_sample,
    S.MAT_CONDUCTOR: conductor_sample,
    S.MAT_ROUGH_CONDUCTOR: roughconductor_sample,
    S.MAT_DIELECTRIC: dielectric_sample,
    S.MAT_ROUGH_DIELECTRIC: roughdielectric_sample,
    S.MAT_THIN_DIELECTRIC: thindielectric_sample,
    S.MAT_PLASTIC: plastic_sample,
    S.MAT_PHONG: phong_sample,
    S.MAT_WARD: ward_sample,
    S.MAT_NULL: null_sample,
}




def scene_families(scene: S.SceneData) -> tuple:
    """The sorted material type codes the scene uses (a host read)."""
    return tuple(sorted(set(scene.mat_type.tolist())))


def _codes(table, families):
    if families is None:
        return list(table.items())
    return [(c, f) for c, f in table.items() if c in families]


def _has_composite(families):
    return families is None or any(c in families for c in COMPOSITE_FAMILIES)


def _has_rough_coat(families):
    return families is None or S.MAT_ROUGH_COATING in families


def _tex_override(scene: S.SceneData, params, uv, lod_extent=None):
    """Texture resolution of material rows params [N, 24] at the hits' uv
    [N, 2] (None: rows as they are): uv written into slots 22-23, the
    albedo texture (slot 13) into columns 0-2 and the roughness texture's
    first channel (slot 14) into column 9 (α_u only, as the JAX
    package does). lod_extent [N]: the uv footprint, converted per
    texture to a mip level (trilinear); None: the finest level."""
    if uv is None:
        return params
    params = torch.cat([params[:, :22], uv, params[:, 24:]], dim=1)
    if scene.tex_meta.shape[0] <= 1:
        return params

    def lookup(slot):
        tex = params[:, slot].to(torch.int32)
        tid = torch.clamp(tex, min=0)
        lod = None
        if lod_extent is not None:
            meta = scene.tex_meta[(tid * MAX_MIPS).long()]
            size = torch.maximum(meta[:, 1], meta[:, 2]).to(uv.dtype)
            lod = torch.clamp(torch.log2(torch.clamp(lod_extent * size,
                                                     min=1.0)),
                              0.0, MAX_MIPS - 1.0)
        return tex >= 0, eval_texture(scene, tid, uv, lod)

    has_alb, albedo = lookup(13)
    albedo = torch.where(has_alb[:, None], albedo, params[:, 0:3])
    has_r, rough = lookup(14)
    rough = torch.where(has_r, rough[:, 0], params[:, 9])
    return torch.cat([albedo, params[:, 3:9], rough[:, None],
                      params[:, 10:]], dim=1)


def resolve_params(scene: S.SceneData, mat_id, uv=None, lod_extent=None):
    """The hits' material rows with one gather (port of the JAX
    resolve_params, bsdf.py:822-843): (type codes [N], rows [N, 24])
    resolved at the hits' uv [N, 2] (_tex_override; None: untextured).
    mat_id -1 reads row 0, as in the JAX package; such lanes are masked
    by the caller. The rows are built with torch.cat and torch.where, so
    autograd sees through them to scene.mat_params. Composite children
    are left unresolved (resolve_material resolves them)."""
    params = _tex_override(scene, scene.mat_params[torch.clamp(mat_id,
                                                               min=0)],
                           uv, lod_extent)
    return params[:, 12].long(), params


def resolve_material(scene: S.SceneData, mat_id, uv=None, families=None,
                     lod_extent=None) -> MatInfo:
    """The material rows of resolve_params and, when `families` holds a
    composite code (None: all), each composite's child rows through param
    slots 18 and 19, resolved alike, and its mixture weight (slot 20, or
    the first channel of the weight texture of slot 21); leaf lanes alias
    their own row with weight 1."""
    mtype, params = resolve_params(scene, mat_id, uv, lod_extent)
    if not _has_composite(families):
        return MatInfo(mtype, params, mtype, params, mtype, params,
                       torch.ones_like(params[:, 0]))

    def child(slot):
        crow = scene.mat_params[torch.clamp(params[:, slot].long(), min=0)]
        crow = _tex_override(scene, crow, uv, lod_extent)
        return crow[:, 12].long(), crow

    is_comp = ((mtype == S.MAT_MIXTURE) | (mtype == S.MAT_COATING)
               | (mtype == S.MAT_ROUGH_COATING))
    ta, pa = child(18)
    tb, pb = child(19)
    w = params[:, 20]
    if uv is not None and scene.tex_meta.shape[0] > 1:
        wtex = params[:, 21].to(torch.int32)
        tw = eval_texture(scene, torch.clamp(wtex, min=0), uv)[:, 0]
        w = torch.where(wtex >= 0, tw, w)
    w = torch.where(mtype == S.MAT_MIXTURE, w, 1.0)
    return MatInfo(mtype, params, torch.where(is_comp, ta, mtype),
                   torch.where(is_comp[:, None], pa, params),
                   torch.where(is_comp, tb, mtype),
                   torch.where(is_comp[:, None], pb, params), w)


def has_shading_maps(scene: S.SceneData) -> bool:
    """Whether a material carries a normal or bump map (slot 16), which
    perturb_shading_frame applies (a host read)."""
    return scene.tex_meta.shape[0] > 1 and bool(
        (scene.mat_params[:, 16] >= 0).any())


def perturb_shading_frame(scene: S.SceneData, mat: MatInfo, frame, uv):
    """Normal- and bump-map frame perturbation (ref: src/bsdfs/
    normalmap.cpp, bumpmap.cpp), before the BSDF dispatch: texture slot
    16 holds a tangent-space normal map (slot 17, the bump scale, 0) or a
    height map (scale > 0, whose gradient is taken by forward differences
    of 1e-3 in u and v). Returns the new frame (s, t, n); lanes without a
    map keep theirs."""
    if scene.tex_meta.shape[0] <= 1 or uv is None:
        return frame
    ntex = mat.params[:, 16].to(torch.int32)
    has = (ntex >= 0)[:, None]
    tid = torch.clamp(ntex, min=0)
    s, t, n = frame
    tv = eval_texture(scene, tid, uv)
    # normal map: [0, 1]³ decoded to a tangent-space normal
    nl = tv * 2.0 - 1.0
    # bump map: forward differences of the height channel
    eps = 1e-3
    step = lambda du, dv: eval_texture(
        scene, tid, uv + torch.tensor([du, dv], dtype=uv.dtype,
                                      device=uv.device))[:, 0]
    du = (step(eps, 0.0) - tv[:, 0]) / eps
    dv = (step(0.0, eps) - tv[:, 0]) / eps
    scale = mat.params[:, 17]
    nb = torch.stack([-du * scale, -dv * scale, torch.ones_like(du)], -1)
    nloc = torch.where((scale > 0.0)[:, None], nb, nl)
    nloc = nloc / torch.clamp(torch.sqrt(torch.sum(nloc * nloc, dim=-1,
                                                   keepdim=True)), min=1e-6)
    n_new = s * nloc[:, 0:1] + t * nloc[:, 1:2] + n * nloc[:, 2:3]
    n_new = torch.where(has, n_new, n)
    s2, t2, n2 = Frame.from_normal(n_new)
    return (torch.where(has, s2, s), torch.where(has, t2, t),
            torch.where(has, n2, n))


def _flip_z(v):
    return torch.stack([v[:, 0], v[:, 1], -v[:, 2]], dim=-1)


def _twosided_wi(params, wi):
    """twosided adapter (ref: src/bsdfs/twosided.cpp): materials flagged
    two-sided (param slot 15) see back-side incidence mirrored into the
    upper hemisphere; sampled and evaluated directions mirror back."""
    flip = (params[:, 15] > 0.5) & (wi[:, 2] < 0.0)
    return torch.where(flip[:, None], _flip_z(wi), wi), flip


def eval_bsdf(mtype, params, wi, wo, families=None):
    """f(wi, wo)·cosθo of the leaf rows' smooth component (zero for delta
    lobes and for composite codes)."""
    wi, flip = _twosided_wi(params, wi)
    wo = torch.where(flip[:, None], _flip_z(wo), wo)
    out = torch.zeros_like(wi)
    for code, fn in _codes(_SMOOTH_EVAL, families):
        out = torch.where((mtype == code)[:, None], fn(params, wi, wo), out)
    return out


def pdf_bsdf(mtype, params, wi, wo, families=None):
    wi, flip = _twosided_wi(params, wi)
    wo = torch.where(flip[:, None], _flip_z(wo), wo)
    out = torch.zeros_like(wi[:, 2])
    for code, fn in _codes(_SMOOTH_PDF, families):
        out = torch.where(mtype == code, fn(params, wi, wo), out)
    return out


def _dispatch_sample(mtype, params, wi, u2, u1, families):
    """The leaf family samplers selected per lane (the two-sided flip is
    the callers')."""
    wo, weight = torch.zeros_like(wi), torch.zeros_like(wi)
    pdf, eta = torch.zeros_like(wi[:, 2]), _ones(wi)
    is_delta = _falses(wi)
    for code, fn in _codes(_SAMPLERS, families):
        s = fn(params, wi, u2, u1)
        sel = mtype == code
        wo = torch.where(sel[:, None], s.wo, wo)
        weight = torch.where(sel[:, None], s.weight, weight)
        pdf = torch.where(sel, s.pdf, pdf)
        is_delta = torch.where(sel, s.is_delta, is_delta)
        eta = torch.where(sel, s.eta, eta)
    return BSDFSample(wo, weight, pdf, is_delta, eta)


def sample_bsdf(mtype, params, wi, u2, u1, families=None) -> BSDFSample:
    wi, flip = _twosided_wi(params, wi)
    s = _dispatch_sample(mtype, params, wi, u2, u1, families)
    return s._replace(wo=torch.where(flip[:, None], _flip_z(s.wo), s.wo))


# ---------------------------------------------------------------------------
# smooth coating (ref: src/bsdfs/coating.cpp): a dielectric coat over a
# nested leaf child, whose directions bend into the coat (sinθ' = sinθ/η);
# absorption e^{-σa·t·path}, both interface transmittances and the
# dω'/dω Jacobian with the 1/η² radiance compression
# ---------------------------------------------------------------------------

def _coat_eta(p):
    return torch.clamp(p[:, 0], min=1.0 + 1e-4)


def _coat_refract_in(v, eta):
    """Bend a direction into the coat: same azimuth and hemisphere."""
    xy = v[:, 0:2] * (1.0 / eta)[:, None]
    z2 = torch.clamp(1.0 - torch.sum(xy * xy, dim=-1), min=0.0)
    z = torch.sqrt(z2) * torch.sign(v[:, 2])
    return torch.cat([xy, z[:, None]], dim=-1)


def _coat_absorption(p, wi_in, wo_in):
    path = (1.0 / torch.clamp(torch.abs(wi_in[:, 2]), min=1e-4)
            + 1.0 / torch.clamp(torch.abs(wo_in[:, 2]), min=1e-4))
    return torch.exp(-p[:, 1:4] * path[:, None])


def _coating_eval(mat: MatInfo, wi, wo, families):
    """f·cosθo of the nested component under the coat; the delta coat
    lobe appears only in sampling."""
    p = mat.params
    eta = _coat_eta(p)
    fi = fresnel_dielectric(wi[:, 2], eta)[0]
    fo = fresnel_dielectric(wo[:, 2], eta)[0]
    wi_in = _coat_refract_in(wi, eta)
    wo_in = _coat_refract_in(wo, eta)
    f_n = eval_bsdf(mat.mtype_a, mat.params_a, wi_in, wo_in, families)
    a = _coat_absorption(p, wi_in, wo_in)
    jac = (torch.abs(wo[:, 2]) / torch.clamp(torch.abs(wo_in[:, 2]),
                                             min=1e-6)) / (eta * eta)
    return f_n * a * ((1.0 - fi) * (1.0 - fo) * jac)[:, None]


def _coating_pdf(mat: MatInfo, wi, wo, families):
    p = mat.params
    eta = _coat_eta(p)
    fi = fresnel_dielectric(wi[:, 2], eta)[0]
    wi_in = _coat_refract_in(wi, eta)
    wo_in = _coat_refract_in(wo, eta)
    pdf_n = pdf_bsdf(mat.mtype_a, mat.params_a, wi_in, wo_in, families)
    return (1.0 - fi) * pdf_n * torch.abs(wo[:, 2]) \
        / torch.clamp((eta * eta) * torch.abs(wo_in[:, 2]), min=1e-9)


def _coat_nested_sample(mat: MatInfo, wi, u2, u1, fi, families):
    """The nested child sampled inside the coat with u1 rescaled past the
    coat's pick probability fi, refracted back out (total internal
    reflection: a dead sample). Returns (wo, weight, pdf with the (1 - fi)
    pick and the Jacobian, ok, child delta)."""
    p = mat.params
    eta = _coat_eta(p)
    u1_n = torch.clamp((u1 - fi) / torch.clamp(1.0 - fi, min=1e-6), 0.0,
                       1.0 - 1e-6)
    wi_in = _coat_refract_in(wi, eta)
    s = _dispatch_sample(mat.mtype_a, mat.params_a, wi_in, u2, u1_n,
                         families)
    xy = s.wo[:, 0:2] * eta[:, None]
    sin2 = torch.sum(xy * xy, dim=-1)
    z = torch.sqrt(torch.clamp(1.0 - sin2, min=0.0)) * torch.sign(s.wo[:, 2])
    wo_n = torch.cat([xy, z[:, None]], dim=-1)
    fo = fresnel_dielectric(wo_n[:, 2], eta)[0]
    a = _coat_absorption(p, wi_in, s.wo)
    w_nested = s.weight * a * (1.0 - fo)[:, None]
    pdf_nested = (1.0 - fi) * s.pdf * torch.abs(wo_n[:, 2]) \
        / torch.clamp((eta * eta) * torch.abs(s.wo[:, 2]), min=1e-9)
    ok_n = (sin2 < 1.0) & (s.pdf > 0)
    return wo_n, w_nested, pdf_nested, ok_n, s.is_delta


def _coating_sample(mat: MatInfo, wi, u2, u1, families) -> BSDFSample:
    p = mat.params
    fi = fresnel_dielectric(wi[:, 2], _coat_eta(p))[0]
    pick_spec = u1 < fi
    wo_n, w_nested, pdf_nested, ok_n, delta_n = _coat_nested_sample(
        mat, wi, u2, u1, fi, families)
    wo = torch.where(pick_spec[:, None], reflect(wi), wo_n)
    weight = torch.where(pick_spec[:, None],
                         p[:, 4:5] * torch.ones_like(w_nested),
                         torch.where(ok_n[:, None], w_nested, 0.0))
    pdf = torch.where(pick_spec, fi, torch.where(ok_n, pdf_nested, 0.0))
    return BSDFSample(wo, weight, pdf, pick_spec | delta_n, _ones(wi))


# ---------------------------------------------------------------------------
# rough coating (ref: src/bsdfs/roughcoating.cpp): the smooth coat's nested
# term plus a GGX/Beckmann coat reflection lobe (visible-normal sampled)
# ---------------------------------------------------------------------------

def _rough_coat_spec_eval(p, wi, wo):
    """f·cosθo of the rough coat's reflection lobe (upper hemisphere)."""
    alpha = mf.clamp_alpha(p[:, 9])
    dist = p[:, 11]
    h = normalize(wi + wo)
    d = mf.eval_d(h, alpha, alpha, dist)
    f = fresnel_dielectric(dot(wi, h), _coat_eta(p))[0]
    g = mf.smith_g(wi, wo, h, alpha, alpha, dist)
    ci = wi[:, 2]
    val = p[:, 4] * f * d * g / torch.clamp(4.0 * torch.abs(ci), min=1e-7)
    return torch.where((ci > 0) & (wo[:, 2] > 0), val, 0.0)


def _rough_coat_spec_pdf(p, wi, wo):
    alpha = mf.clamp_alpha(p[:, 9])
    h = normalize(wi + wo)
    pdf_h = mf.pdf_visible(wi, h, alpha, alpha, p[:, 11])
    pdf = pdf_h / torch.clamp(4.0 * torch.abs(dot(wo, h)), min=1e-7)
    return torch.where((wi[:, 2] > 0) & (wo[:, 2] > 0), pdf, 0.0)


def _roughcoating_eval(mat: MatInfo, wi, wo, families):
    spec = _rough_coat_spec_eval(mat.params, wi, wo)
    return _coating_eval(mat, wi, wo, families) + spec[:, None]


def _roughcoating_pdf(mat: MatInfo, wi, wo, families):
    fi = fresnel_dielectric(wi[:, 2], _coat_eta(mat.params))[0]
    return (fi * _rough_coat_spec_pdf(mat.params, wi, wo)
            + _coating_pdf(mat, wi, wo, families))


def _roughcoating_sample(mat: MatInfo, wi, u2, u1, families) -> BSDFSample:
    p = mat.params
    alpha = mf.clamp_alpha(p[:, 9])
    fi = fresnel_dielectric(wi[:, 2], _coat_eta(p))[0]
    pick_spec = u1 < fi
    m = mf.sample_visible(wi, u2, alpha, alpha, p[:, 11])
    wo_s = 2.0 * dot(wi, m)[:, None] * m - wi
    wo_n, w_nested, pdf_nested, ok_n, delta_n = _coat_nested_sample(
        mat, wi, u2, u1, fi, families)
    wo = torch.where(pick_spec[:, None], wo_s, wo_n)
    # smooth lanes: the combined eval/pdf of both lobes (MIS-correct)
    f_all = _roughcoating_eval(mat, wi, wo, families)
    pdf_all = _roughcoating_pdf(mat, wi, wo, families)
    w_smooth = torch.where(pdf_all[:, None] > 1e-9,
                           f_all / torch.clamp(pdf_all, min=1e-9)[:, None],
                           0.0)
    nested_delta = ~pick_spec & delta_n
    weight = torch.where(nested_delta[:, None],
                         torch.where(ok_n[:, None], w_nested, 0.0), w_smooth)
    pdf = torch.where(nested_delta, torch.where(ok_n, pdf_nested, 0.0),
                      pdf_all)
    # a coat pick below the horizon is a dead sample
    dead = pick_spec & (wo_s[:, 2] <= 0)
    weight = torch.where(dead[:, None], 0.0, weight)
    pdf = torch.where(dead, 0.0, pdf)
    return BSDFSample(wo, weight, pdf, nested_delta, _ones(wi))


# ---------------------------------------------------------------------------
# MatInfo-aware entry points (leaf lanes cost exactly the leaf dispatch)
# ---------------------------------------------------------------------------

def _composite_view(mat: MatInfo, wi, wo=None):
    """(wi, wo) under the top row's two-sided flip, and the flip."""
    wi_t, flip = _twosided_wi(mat.params, wi)
    if wo is not None:
        wo = torch.where(flip[:, None], _flip_z(wo), wo)
    return wi_t, wo, flip


def eval_bsdf_ex(mat: MatInfo, wi, wo, families=None):
    """f(wi, wo)·cosθo of the smooth component (zero for delta lobes);
    a mixture's is the convex sum of its children's."""
    if not _has_composite(families):
        return eval_bsdf(mat.mtype, mat.params, wi, wo, families)
    wi_t, wo_t, _ = _composite_view(mat, wi, wo)
    f = eval_bsdf(mat.mtype_a, mat.params_a, wi_t, wo_t, families)
    if families is None or S.MAT_MIXTURE in families:
        f_b = eval_bsdf(mat.mtype_b, mat.params_b, wi_t, wo_t, families)
        f = torch.where((mat.mtype == S.MAT_MIXTURE)[:, None],
                        mat.w_a[:, None] * f
                        + (1.0 - mat.w_a)[:, None] * f_b, f)
    if families is None or S.MAT_COATING in families:
        f = torch.where((mat.mtype == S.MAT_COATING)[:, None],
                        _coating_eval(mat, wi_t, wo_t, families), f)
    if _has_rough_coat(families):
        f = torch.where((mat.mtype == S.MAT_ROUGH_COATING)[:, None],
                        _roughcoating_eval(mat, wi_t, wo_t, families), f)
    return f


def pdf_bsdf_ex(mat: MatInfo, wi, wo, families=None):
    if not _has_composite(families):
        return pdf_bsdf(mat.mtype, mat.params, wi, wo, families)
    wi_t, wo_t, _ = _composite_view(mat, wi, wo)
    p = pdf_bsdf(mat.mtype_a, mat.params_a, wi_t, wo_t, families)
    if families is None or S.MAT_MIXTURE in families:
        p_b = pdf_bsdf(mat.mtype_b, mat.params_b, wi_t, wo_t, families)
        p = torch.where(mat.mtype == S.MAT_MIXTURE,
                        mat.w_a * p + (1.0 - mat.w_a) * p_b, p)
    if families is None or S.MAT_COATING in families:
        p = torch.where(mat.mtype == S.MAT_COATING,
                        _coating_pdf(mat, wi_t, wo_t, families), p)
    if _has_rough_coat(families):
        p = torch.where(mat.mtype == S.MAT_ROUGH_COATING,
                        _roughcoating_pdf(mat, wi_t, wo_t, families), p)
    return p


def _select(sel, a: BSDFSample, b: BSDFSample) -> BSDFSample:
    """a on the lanes of sel, else b."""
    return BSDFSample(*(torch.where(sel[:, None] if x.dim() == 2 else sel,
                                    x, y) for x, y in zip(a, b)))


def _mixture_sample(mat: MatInfo, wi, u2, u1, families) -> BSDFSample:
    """Pick a child ∝ its weight with u1 (sample reuse, mixturebsdf.cpp),
    sample it with u1 remapped into its own stream; weight a smooth
    sample by the whole mixture's f/pdf (MIS-correct) and a delta one by
    the picked child's weight."""
    w_a = mat.w_a
    pick_a = u1 < w_a
    u1_a = torch.clamp(u1 / torch.clamp(w_a, min=1e-6), 0.0, 1.0 - 1e-6)
    u1_b = torch.clamp((u1 - w_a) / torch.clamp(1.0 - w_a, min=1e-6), 0.0,
                       1.0 - 1e-6)
    sa = _dispatch_sample(mat.mtype_a, mat.params_a, wi, u2, u1_a, families)
    sb = _dispatch_sample(mat.mtype_b, mat.params_b, wi, u2, u1_b, families)
    sm = _select(pick_a, sa, sb)
    f_mix = (w_a[:, None] * eval_bsdf(mat.mtype_a, mat.params_a, wi, sm.wo,
                                      families)
             + (1.0 - w_a)[:, None] * eval_bsdf(mat.mtype_b, mat.params_b,
                                                wi, sm.wo, families))
    pdf_mix = (w_a * pdf_bsdf(mat.mtype_a, mat.params_a, wi, sm.wo, families)
               + (1.0 - w_a) * pdf_bsdf(mat.mtype_b, mat.params_b, wi, sm.wo,
                                        families))
    pdf_delta = torch.where(pick_a, w_a, 1.0 - w_a) * sm.pdf
    wt_smooth = torch.where(pdf_mix[:, None] > 1e-12,
                            f_mix / torch.clamp(pdf_mix, min=1e-12)[:, None],
                            0.0)
    return BSDFSample(sm.wo, torch.where(sm.is_delta[:, None], sm.weight,
                                         wt_smooth),
                      torch.where(sm.is_delta, pdf_delta, pdf_mix),
                      sm.is_delta, sm.eta)


def sample_bsdf_ex(mat: MatInfo, wi, u2, u1, families=None) -> BSDFSample:
    if not _has_composite(families):
        return sample_bsdf(mat.mtype, mat.params, wi, u2, u1, families)
    wi_t, _, flip = _composite_view(mat, wi)
    # leaf lanes: the dispatch on child A, which is the lane's own row
    s = _dispatch_sample(mat.mtype_a, mat.params_a, wi_t, u2, u1, families)
    if families is None or S.MAT_MIXTURE in families:
        s = _select(mat.mtype == S.MAT_MIXTURE,
                    _mixture_sample(mat, wi_t, u2, u1, families), s)
    if families is None or S.MAT_COATING in families:
        s = _select(mat.mtype == S.MAT_COATING,
                    _coating_sample(mat, wi_t, u2, u1, families), s)
    if _has_rough_coat(families):
        s = _select(mat.mtype == S.MAT_ROUGH_COATING,
                    _roughcoating_sample(mat, wi_t, u2, u1, families), s)
    return s._replace(wo=torch.where(flip[:, None], _flip_z(s.wo), s.wo))
