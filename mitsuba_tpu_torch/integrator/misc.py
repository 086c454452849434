"""Small integrators: ambient occlusion and the geometry AOVs (port of
mitsuba_tpu/integrator/misc.py; ref: src/integrators/direct/ao.cpp,
src/integrators/misc/field.cpp).

Both override li_stats, which render_fn, the CLI and PathTracer.li call,
so neither can fall through to PathTracer's path trace. Their traces are
PathTracer's: the trace kernel on CUDA tensors, the plain intersector on
CPU tensors."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..bsdf.bsdf import resolve_material
from ..core import rng
from ..core.math import Frame
from ..core.warp import square_to_cosine_hemisphere
from ..emitter.emitter import sample_direct
from ..scene.scene import SceneData
from .common import DIM_BSDF_U2, bounce_dim, offset_ray_origin, ray_mint
from .path import PathTracer

FIELDS = ("position", "relPosition", "distance", "geoNormal", "shNormal",
          "uv", "albedo", "primIndex", "shapeIndex", "wiMacro", "woMacro")
# woMacro's emitter-sample dims (the JAX FieldIntegrator's)
DIM_WO_SEL = 1 << 23
DIM_WO_POS = (1 << 23) + 1


@dataclass(frozen=True)
class AmbientOcclusion(PathTracer):
    """Cosine-weighted ambient occlusion (ao.cpp): shading_samples rays a
    hit over the shading normal's hemisphere, each unoccluded within
    ray_length (<= 0: 1e8) counting 1. The path fields are unused."""
    ray_length: float = -1.0
    shading_samples: int = 1

    def li_stats(self, scene: SceneData, o, d, seed, pixel_id,
                 sample_idx=0):
        """(the AO fraction in all three channels [N, 3], traced-ray count
        as a 0-d int64 tensor: one a camera ray, one an attempted AO ray,
        which is one a hit and shading sample)."""
        everyone = torch.ones_like(o[:, 0], dtype=torch.bool)
        its = self._intersect(scene, o, d, ray_mint(o), everyone)
        frame = Frame.from_normal(its.ns)
        length = self.ray_length if self.ray_length > 0 else 1e8
        acc = torch.zeros_like(o[:, 0])
        n_rays = everyone.sum()
        for k in range(self.shading_samples):
            u2 = self._d2(seed, pixel_id, sample_idx,
                          bounce_dim(k, DIM_BSDF_U2))
            wo = Frame.to_world(frame, square_to_cosine_hemisphere(u2))
            so = offset_ray_origin(its.p, its.ng, wo)
            occ = self._occluded(scene, so, wo, ray_mint(so),
                                 torch.full_like(acc, length), its.valid)
            acc = acc + torch.where(its.valid & ~occ, 1.0, 0.0)
            n_rays = n_rays + its.valid.sum()
        ao = acc / self.shading_samples
        return ao[:, None].expand(o.shape).clone(), n_rays.to(torch.int64)


@dataclass(frozen=True)
class FieldIntegrator(PathTracer):
    """Geometry AOVs (field.cpp), one of FIELDS: the hit's position, its
    position relative to the ray origin, the distance, the geometric or
    shading normal, the uv (third channel 0), the albedo (material
    columns 0-2, textures resolved), the triangle or material id, and
    the research AOVs of the reference's `baseFrameWiWo` integrator:
    wiMacro, the view direction in the shading frame, and woMacro, the
    direction of an emitter sample (sample_direct at the dims DIM_WO_SEL
    and DIM_WO_POS) in that frame, 0 where its pdf is 0. Every channel is
    0 on a miss."""
    field: str = "shNormal"

    def __post_init__(self):
        super().__post_init__()
        if self.field not in FIELDS:
            raise ValueError(f"unknown field {self.field}")

    def li_stats(self, scene: SceneData, o, d, seed, pixel_id,
                 sample_idx=0):
        """(the field [N, 3], traced-ray count as a 0-d int64 tensor: one
        a camera ray)."""
        everyone = torch.ones_like(o[:, 0], dtype=torch.bool)
        its = self._intersect(scene, o, d, ray_mint(o), everyone)
        f = self.field
        if f == "position":
            out = its.p
        elif f == "relPosition":
            out = its.p - o
        elif f == "distance":
            out = torch.where(its.valid, its.t, 0.0)[:, None].expand(o.shape)
        elif f == "geoNormal":
            out = its.ng
        elif f == "shNormal":
            out = its.ns
        elif f == "uv":
            out = torch.cat([its.uv, torch.zeros_like(its.uv[:, :1])], -1)
        elif f == "albedo":
            out = resolve_material(scene, its.mat_id, its.uv).params[:, 0:3]
        elif f in ("primIndex", "shapeIndex"):
            idx = its.tri_id if f == "primIndex" else its.mat_id
            out = idx.to(torch.float32)[:, None].expand(o.shape)
        else:
            frame = Frame.from_normal(its.ns)
            if f == "wiMacro":
                out = Frame.to_local(frame, -d)
            else:
                us = rng.sample_1d(seed, pixel_id, DIM_WO_SEL, sample_idx)
                up = rng.sample_2d(seed, pixel_id, DIM_WO_POS, sample_idx)
                ds = sample_direct(scene, its.p, us, up)
                out = torch.where((ds.pdf > 0)[:, None],
                                  Frame.to_local(frame, ds.d), 0.0)
        return (torch.where(its.valid[:, None], out, 0.0),
                everyone.sum().to(torch.int64))
