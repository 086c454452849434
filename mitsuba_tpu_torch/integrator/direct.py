"""Direct illumination integrator with sample splitting (port of
mitsuba_tpu/integrator/direct.py).

The reference `direct` plugin (ref: src/integrators/direct/direct.cpp):
emitter_samples NEE draws and bsdf_samples BSDF draws per shading point,
with MIS weights that fold in each strategy's share of the samples
(m_weightLum/m_weightBSDF/m_fracLum/m_fracBSDF, direct.cpp:131-135). Its
traces are PathTracer's (the trace kernel on CUDA tensors, the plain
intersector on CPU tensors).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..bsdf.bsdf import (eval_bsdf_ex, pdf_bsdf_ex, perturb_shading_frame,
                         resolve_material, sample_bsdf_ex)
from ..core.math import SHADOW_EPSILON, Frame, dot
from ..emitter.emitter import (eval_area, eval_env, pdf_direct_area,
                               pdf_direct_env, sample_direct)
from ..scene.scene import SceneData
from .common import (DIM_BSDF_U1, DIM_BSDF_U2, DIM_NEE_POS, DIM_NEE_SEL,
                     bounce_dim, offset_ray_origin, ray_mint)
from .path import PathTracer


def _mis_frac(pdf_a, pdf_b, frac_a, frac_b):
    """Power heuristic including sample fractions (direct.cpp miWeight)."""
    a = pdf_a * frac_a
    b = pdf_b * frac_b
    r = torch.clamp(b / torch.clamp(a, min=1e-6), 0.0, 1e6)
    return torch.where(a > 0, 1.0 / (1.0 + r * r), 0.0)


@dataclass(frozen=True)
class DirectIntegrator(PathTracer):
    """emitter_samples/bsdf_samples mirror the plugin's Properties
    (direct.cpp:99-107). The path fields max_depth and rr_depth are unused;
    there is no fused shading tail (fused_shade must stay "off") and no
    hide_emitters (the JAX DirectIntegrator reads none)."""
    emitter_samples: int = 1
    bsdf_samples: int = 1

    def __post_init__(self):
        super().__post_init__()
        if self.fused_shade != "off":
            raise ValueError("DirectIntegrator has no fused shading tail")
        if self.hide_emitters:
            raise ValueError("DirectIntegrator has no hide_emitters")

    def li_stats(self, scene: SceneData, o, d, seed, pixel_id,
                 sample_idx=0):
        """(L [N, 3], traced-ray count as a 0-d int64 tensor: the camera
        rays that hit, the unoccluded NEE rays and the BSDF rays with a
        positive pdf, as the JAX package counts them)."""
        fams = self.specialized_for(scene, o.device).families
        ne, nb = self.emitter_samples, self.bsdf_samples
        frac_lum = ne / (ne + nb)
        frac_bsdf = nb / (ne + nb)
        d1 = lambda k, off: self._d1(seed, pixel_id, sample_idx,
                                     bounce_dim(k, off))
        d2 = lambda k, off: self._d2(seed, pixel_id, sample_idx,
                                     bounce_dim(k, off))

        everyone = torch.ones_like(o[:, 0], dtype=torch.bool)
        its = self._intersect(scene, o, d, ray_mint(o), everyone)
        hit = its.valid
        L = torch.where((~hit)[:, None], eval_env(scene, d), 0.0)

        # directly visible emitters
        cos_surf = -dot(d, its.ng)
        le = eval_area(scene, its.em_id, cos_surf)
        L = L + torch.where(hit[:, None], le, 0.0)

        mat = resolve_material(scene, its.mat_id, its.uv, fams)
        frame = perturb_shading_frame(
            scene, mat, Frame.from_normal(its.ns), its.uv)
        wi_local = Frame.to_local(frame, -d)
        n_rays = hit.sum()

        # ---- emitter sampling strategy --------------------------------
        for k in range(ne):
            ds = sample_direct(scene, its.p, d1(k, DIM_NEE_SEL),
                               d2(k, DIM_NEE_POS))
            wo = Frame.to_local(frame, ds.d)
            f = eval_bsdf_ex(mat, wi_local, wo, fams)
            ok = hit & (ds.pdf > 0) & (f > 0).any(-1)
            so = offset_ray_origin(its.p, its.ng, ds.d)
            occ = self._occluded(scene, so, ds.d, ray_mint(so),
                                 ds.dist * (1.0 - SHADOW_EPSILON), ok)
            ok = ok & ~occ
            bsdf_pdf = pdf_bsdf_ex(mat, wi_local, wo, fams)
            w = torch.where(ds.is_delta, 1.0,
                            _mis_frac(ds.pdf, bsdf_pdf, frac_lum, frac_bsdf))
            L = L + torch.where(ok[:, None],
                                ds.value * f * (w / ne)[:, None], 0.0)
            n_rays = n_rays + ok.sum()

        # ---- BSDF sampling strategy -----------------------------------
        for k in range(nb):
            bs = sample_bsdf_ex(mat, wi_local, d2(k, DIM_BSDF_U2),
                                d1(k, DIM_BSDF_U1), fams)
            d2w = Frame.to_world(frame, bs.wo)
            o2 = offset_ray_origin(its.p, its.ng, d2w)
            ok = hit & (bs.pdf > 0)
            its2 = self._intersect(scene, o2, d2w, ray_mint(o2), ok)
            # an emitter hit, or an escape to the environment
            cos2 = -dot(d2w, its2.ng)
            le2 = eval_area(scene, its2.em_id, cos2)
            nee_pdf = pdf_direct_area(scene, its2.em_id, d2w, its2.t, cos2)
            radiance = torch.where(its2.valid[:, None], le2,
                                   eval_env(scene, d2w))
            counter = torch.where(its2.valid, nee_pdf,
                                  pdf_direct_env(scene, d2w))
            w = torch.where(bs.is_delta, 1.0,
                            _mis_frac(bs.pdf, counter, frac_bsdf, frac_lum))
            L = L + torch.where(ok[:, None],
                                bs.weight * radiance * (w / nb)[:, None],
                                0.0)
            n_rays = n_rays + ok.sum()

        return L, n_rays.to(torch.int64)
