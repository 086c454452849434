"""Emitter sampling for next-event estimation (port of the area-emitter
part of mitsuba_tpu/emitter/emitter.py).

The emitter is picked ∝ sampling weight with sample reuse; an area
emitter's triangle is picked from its area CDF, stored "globalized"
(emitter index + within-emitter cdf) so one searchsorted serves all
emitters. Scenes in the port hold area emitters only: compile_scene and
convert.scene_from_numpy reject every other kind.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.math import dot, safe_div
from ..core.warp import square_to_uniform_triangle
from ..scene.scene import SceneData


class DirectSample(NamedTuple):
    """NEE sample toward an emitter. All [N, ...]."""
    d: torch.Tensor          # [N, 3] unit direction ref → emitter
    dist: torch.Tensor       # [N] distance
    pdf: torch.Tensor        # [N] solid-angle pdf × emitter pick (0: invalid)
    value: torch.Tensor      # [N, 3] radiance / pdf
    is_delta: torch.Tensor   # [N] bool (always False: no delta emitters)
    n: torch.Tensor          # [N, 3] emitter surface normal
    em_id: torch.Tensor      # [N] int64


def sample_direct(scene: SceneData, ref_p, u_sel, u2) -> DirectSample:
    """Pick an emitter with u_sel [N] and a point on it with u2 [N, 2]."""
    n_lanes = ref_p.shape[0]
    no_delta = torch.zeros(n_lanes, dtype=torch.bool, device=ref_p.device)
    if scene.n_emitters == 0:
        z3 = torch.zeros_like(ref_p)
        z = z3[:, 0]
        up = torch.cat([z3[:, :2], torch.ones_like(z3[:, :1])], dim=-1)
        return DirectSample(up, z, z, z3, no_delta, z3,
                            torch.full_like(z, -1, dtype=torch.int64))

    em_id, u_re, em_pmf_val = scene.em_pmf.sample_reuse(u_sel)
    em_rad = scene.em_radiance[em_id]
    em_area = scene.em_area[em_id]
    # keys are strictly increasing across segments: values in (e, e+1]
    key = em_id.to(torch.float32) + torch.clamp(u_re, 0.0, 1.0 - 1e-7)
    hi = torch.searchsorted(scene.em_tri_cdfg, key, right=True)
    row = scene.em_tri_data[hi.clamp(0, scene.em_tris.shape[0] - 1)]
    bar = square_to_uniform_triangle(u2)
    p_l = (row[:, 0:3] + bar[:, 0:1] * row[:, 3:6]
           + bar[:, 1:2] * row[:, 6:9])
    n_l = row[:, 9:12]

    to_l = p_l - ref_p
    dist2 = torch.clamp(torch.sum(to_l * to_l, dim=-1), min=1e-12)
    dist = torch.sqrt(dist2)
    d = to_l / dist[:, None]
    cos_l = -dot(d, n_l)
    # area → solid-angle pdf: dist² / (cosθ · total area) (shape.cpp:102-126)
    pdf = safe_div(dist2, cos_l * torch.clamp(em_area, min=1e-12))
    pdf = torch.where(cos_l > 1e-6, pdf, 0.0) * em_pmf_val
    value = safe_div(em_rad, pdf[:, None])
    value = torch.where((pdf > 0)[:, None], value, 0.0)
    return DirectSample(d=d, dist=dist, pdf=pdf, value=value,
                        is_delta=no_delta, n=n_l, em_id=em_id)


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


def eval_env(scene: SceneData, d):
    """Environment radiance along escaped directions: 0, since the port's
    scenes have no environment emitter (env_id < 0)."""
    return torch.zeros_like(d)


def pdf_direct_env(scene: SceneData, d):
    """NEE pdf of an escaped direction: 0 without an environment emitter."""
    return torch.zeros_like(d[:, 0])
