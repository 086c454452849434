"""Emitter sampling for next-event estimation (port of
mitsuba_tpu/emitter/emitter.py).

The emitter is picked ∝ sampling weight with sample reuse. An area
emitter's triangle is picked from its area CDF, stored "globalized"
(emitter index + within-emitter cdf) so one searchsorted serves all
emitters; point and spot lights (spot: linear falloff between beam width
and cutoff) and directional lights are delta emitters, whose MIS weight
the integrator forces to 1; the constant environment is sampled
uniformly over the sphere, the image-based one (emitter/envmap.py) by
its alias table, and escaped rays see either. The envmap's terms run
only for a scene that carries an environment image (envmap.has_envmap).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.math import Frame, dot, safe_div
from ..core.warp import (INV_FOUR_PI, square_to_cosine_hemisphere,
                         square_to_uniform_sphere,
                         square_to_uniform_triangle)
from ..scene import scene as S
from ..scene.scene import SceneData
from .envmap import eval_env_dir, has_envmap, pdf_env_dir, sample_env

# the "distance" of environment and directional samples (finite: the JAX
# package keeps inf out of its autodiff)
ENV_DIST = 1e30


class DirectSample(NamedTuple):
    """NEE sample toward an emitter. All [N, ...]."""
    d: torch.Tensor          # [N, 3] unit direction ref → emitter
    dist: torch.Tensor       # [N] distance
    pdf: torch.Tensor        # [N] solid-angle pdf × emitter pick (0: invalid)
    value: torch.Tensor      # [N, 3] radiance / pdf
    is_delta: torch.Tensor   # [N] bool: point, spot or directional
    n: torch.Tensor          # [N, 3] emitter surface normal (else -d)
    em_id: torch.Tensor      # [N] int64


def sample_direct(scene: SceneData, ref_p, u_sel, u2) -> DirectSample:
    """Pick an emitter with u_sel [N] and a point or direction on it with
    u2 [N, 2]. Delta samples carry pdf = the pick probability and value =
    intensity·falloff/(dist²·pmf) (point, spot) or irradiance/pmf
    (directional); the others value = radiance/pdf."""
    if scene.n_emitters == 0:
        z3 = torch.zeros_like(ref_p)
        z = z3[:, 0]
        up = torch.cat([z3[:, :2], torch.ones_like(z3[:, :1])], dim=-1)
        return DirectSample(up, z, z, z3, torch.zeros_like(z, dtype=bool),
                            z3, torch.full_like(z, -1, dtype=torch.int64))

    em_id, u_re, em_pmf_val = scene.em_pmf.sample_reuse(u_sel)
    em_type = scene.em_type[em_id]
    em_rad = scene.em_radiance[em_id]
    em_pos = scene.em_pos[em_id]

    # ---- area emitters: triangle pick via the globalized CDF -----------
    if scene.em_tris.shape[0] > 0:
        # keys are strictly increasing across segments: values in (e, e+1]
        key = em_id.to(torch.float32) + torch.clamp(u_re, 0.0, 1.0 - 1e-7)
        hi = torch.searchsorted(scene.em_tri_cdfg, key, right=True)
        row = scene.em_tri_data[hi.clamp(0, scene.em_tris.shape[0] - 1)]
        bar = square_to_uniform_triangle(u2)
        p_l = (row[:, 0:3] + bar[:, 0:1] * row[:, 3:6]
               + bar[:, 1:2] * row[:, 6:9])
        n_l = row[:, 9:12]
    else:
        p_l = torch.zeros_like(ref_p)
        n_l = torch.cat([p_l[:, :2], torch.ones_like(p_l[:, :1])], dim=-1)
    to_l = p_l - ref_p
    dist2 = torch.clamp(torch.sum(to_l * to_l, dim=-1), min=1e-12)
    dist_area = torch.sqrt(dist2)
    d_area = to_l / dist_area[:, None]
    cos_l = -dot(d_area, n_l)
    # area → solid-angle pdf: dist² / (cosθ · total area) (shape.cpp:102-126)
    pdf_area = safe_div(dist2, cos_l * torch.clamp(scene.em_area[em_id],
                                                   min=1e-12))
    pdf_area = torch.where(cos_l > 1e-6, pdf_area, 0.0)

    # ---- point and spot emitters ----------------------------------------
    to_p = em_pos - ref_p
    pdist2 = torch.clamp(torch.sum(to_p * to_p, dim=-1), min=1e-12)
    pdist = torch.sqrt(pdist2)
    d_point = to_p / pdist[:, None]
    val_point = em_rad / pdist2[:, None]

    # ---- environment: uniform sphere (constant) or the image's alias
    # table (envmap) --------------------------------------------------------
    d_env = square_to_uniform_sphere(u2)
    pdf_env = INV_FOUR_PI
    envmap = has_envmap(scene)
    if envmap:
        is_envmap = em_type == S.EM_ENVMAP
        d_map, pdf_map, _ = sample_env(scene, u2)
        d_env = torch.where(is_envmap[:, None], d_map, d_env)
        pdf_env = torch.where(is_envmap, pdf_map, INV_FOUR_PI)

    is_area = em_type == S.EM_AREA
    is_point = (em_type == S.EM_POINT) | (em_type == S.EM_SPOT)
    is_directional = em_type == S.EM_DIRECTIONAL
    is_delta = is_point | is_directional

    # spot falloff (spot.cpp falloffCurve): linear in the angle between
    # the spot axis and the direction toward the receiver
    aux = scene.em_aux[em_id]
    cos_cut, cos_beam = aux[:, 3], aux[:, 4]
    falloff = torch.clamp((dot(aux[:, 0:3], -d_point) - cos_cut)
                          / torch.clamp(cos_beam - cos_cut, min=1e-6),
                          0.0, 1.0)
    spot_scale = torch.where(em_type == S.EM_SPOT, falloff, 1.0)

    d = torch.where(is_area[:, None], d_area,
                    torch.where(is_point[:, None], d_point,
                                torch.where(is_directional[:, None], -em_pos,
                                            d_env)))
    dist = torch.where(is_area, dist_area,
                       torch.where(is_point, pdist, ENV_DIST))
    pdf_sa = torch.where(is_area, pdf_area,
                         torch.where(is_delta, 1.0, pdf_env))
    # the emitter pick folds into the pdf (scene.cpp:846)
    pdf_total = pdf_sa * em_pmf_val
    radiance = torch.where(is_envmap[:, None], eval_env_dir(scene, d),
                           em_rad) if envmap else em_rad
    val_delta = torch.where(is_directional[:, None], em_rad,
                            val_point * spot_scale[:, None])
    value = torch.where(
        is_delta[:, None],
        val_delta / torch.clamp(em_pmf_val, min=1e-12)[:, None],
        safe_div(radiance, pdf_total[:, None]))
    value = torch.where((pdf_total > 0)[:, None], value, 0.0)
    return DirectSample(
        d=d, dist=dist, pdf=torch.where(is_delta, em_pmf_val, pdf_total),
        value=value, is_delta=is_delta,
        n=torch.where(is_area[:, None], n_l, -d), em_id=em_id)


class EmitterRay(NamedTuple):
    """The start of a subpath on an area emitter. All [N, ...]."""
    em_id: torch.Tensor      # [N] int64 picked emitter
    pmf: torch.Tensor        # [N] its pick probability
    area: torch.Tensor       # [N] its total surface area
    le: torch.Tensor         # [N, 3] its radiance
    is_area: torch.Tensor    # [N] bool: an area emitter (the others start
                             # no subpath)
    p: torch.Tensor          # [N, 3] the point on it
    n: torch.Tensor          # [N, 3] its normal there
    d: torch.Tensor          # [N, 3] the cosine-weighted emission direction


def sample_emitter_ray(scene: SceneData, u_sel, u_pos, u_dir) -> EmitterRay:
    """Start a light subpath: pick an emitter with u_sel [N] (sample
    reuse), its triangle ∝ area from the reused uniform through the
    globalized CDF and a uniform point on it with u_pos [N, 2], then a
    cosine-weighted direction about its normal with u_dir [N, 2] (ref:
    emitter/area.cpp sampleRay). The light tracer, BDPT, the VPL
    generator and the photon tracer start here; each weights the start
    by its own formula."""
    n = u_sel.shape[0]
    if scene.n_emitters == 0 or scene.em_tris.shape[0] == 0:
        z3 = torch.zeros((n, 3), device=u_sel.device)
        up = torch.cat([z3[:, :2], torch.ones_like(z3[:, :1])], dim=-1)
        z = z3[:, 0]
        return EmitterRay(torch.zeros(n, dtype=torch.int64,
                                      device=u_sel.device), z, z, z3,
                          torch.zeros(n, dtype=torch.bool,
                                      device=u_sel.device), z3, up, up)
    em_id, u_re, pmf = scene.em_pmf.sample_reuse(u_sel)
    key = em_id.to(torch.float32) + torch.clamp(u_re, 0.0, 1.0 - 1e-7)
    hi = torch.searchsorted(scene.em_tri_cdfg, key, right=True)
    row = scene.em_tri_data[hi.clamp(0, scene.em_tris.shape[0] - 1)]
    bar = square_to_uniform_triangle(u_pos)
    p = (row[:, 0:3] + bar[:, 0:1] * row[:, 3:6]
         + bar[:, 1:2] * row[:, 6:9])
    n_l = row[:, 9:12]
    d = Frame.to_world(Frame.from_normal(n_l),
                       square_to_cosine_hemisphere(u_dir))
    return EmitterRay(em_id, pmf, scene.em_area[em_id],
                      scene.em_radiance[em_id],
                      scene.em_type[em_id] == S.EM_AREA, p, n_l, d)


def pdf_direct_area(scene: SceneData, em_id, d, dist, cos_l):
    """NEE pdf of a direction that hit area emitter em_id at distance dist
    with light-side cosine cos_l: the MIS weight of a BSDF-sampled hit."""
    if scene.n_emitters == 0:
        return torch.zeros_like(dist)
    eid = torch.clamp(em_id, min=0)
    em_area = scene.em_area[eid]
    pmf = scene.em_pmf.pmf[eid]
    pdf = safe_div(dist * dist,
                   cos_l * torch.clamp(em_area, min=1e-12)) * pmf
    return torch.where((em_id >= 0) & (cos_l > 1e-6), pdf, 0.0)


def eval_area(scene: SceneData, em_id, cos_surface):
    """Radiance of area emitter em_id seen with surface-side cosine
    cos_surface (> 0 ⇒ front side; one-sided emitters)."""
    if scene.n_emitters == 0:
        return torch.zeros(em_id.shape + (3,), device=em_id.device)
    rad = scene.em_radiance[torch.clamp(em_id, min=0)]
    vis = (em_id >= 0) & (cos_surface > 0)
    return torch.where(vis[:, None], rad, 0.0)


def _env(scene: SceneData):
    """(has an environment, its emitter row) as 0-d tensors."""
    return scene.env_id >= 0, torch.clamp(scene.env_id, min=0).long()


def eval_env(scene: SceneData, d):
    """Environment radiance along escaped directions (ref:
    Scene::evalEnvironment): the constant emitter's or the image's, else
    0."""
    if scene.n_emitters == 0:
        return torch.zeros_like(d)
    has_env, eid = _env(scene)
    rad = scene.em_radiance[eid].expand(d.shape)
    if has_envmap(scene):
        rad = torch.where(scene.em_type[eid] == S.EM_ENVMAP,
                          eval_env_dir(scene, d), rad)
    return torch.where(has_env, rad, 0.0)


def pdf_direct_env(scene: SceneData, d):
    """NEE pdf of an escaped ray's direction: the environment's
    (uniform-sphere or envmap) pdf times its pick probability, else 0."""
    if scene.n_emitters == 0:
        return torch.zeros_like(d[:, 0])
    has_env, eid = _env(scene)
    if has_envmap(scene):
        pdf_dir = torch.where(scene.em_type[eid] == S.EM_ENVMAP,
                              pdf_env_dir(scene, d), INV_FOUR_PI)
        return torch.where(has_env, pdf_dir * scene.em_pmf.pmf[eid], 0.0)
    pdf = INV_FOUR_PI * scene.em_pmf.pmf[eid]
    return torch.where(has_env, pdf, 0.0).expand(d.shape[:1])
