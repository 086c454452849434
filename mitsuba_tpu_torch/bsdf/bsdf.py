"""BSDFs in the local shading frame (port of mitsuba_tpu/bsdf/bsdf.py: the
14 leaf families and the two-sided adapter; the composites are not
ported).

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
from . import rtrans

PORTED_FAMILIES = (S.MAT_DIFFUSE, S.MAT_CONDUCTOR, S.MAT_ROUGH_CONDUCTOR,
                   S.MAT_DIELECTRIC, S.MAT_PLASTIC, S.MAT_ROUGH_DIELECTRIC,
                   S.MAT_ROUGH_PLASTIC, S.MAT_PHONG, S.MAT_WARD,
                   S.MAT_ROUGH_DIFFUSE, S.MAT_NULL, S.MAT_THIN_DIELECTRIC,
                   S.MAT_DIFFTRANS, S.MAT_ANISO_ROUGHDIFFUSE)


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
