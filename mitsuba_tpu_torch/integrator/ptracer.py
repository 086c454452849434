"""Adjoint particle tracer: light paths splatted through the sensor (port
of mitsuba_tpu/integrator/ptracer.py; ref: src/integrators/ptracer/
ptracer.cpp).

Particles start on the area emitters carrying power throughput
(emitter.sample_emitter_ray), walk through the scene, and every vertex
connects to the camera through a visibility ray; the contribution splats
to the projected pixel. One wavefront of N particles and a Python loop
over bounces; the camera connections are batched projections
(PerspectiveCamera.project) and shadow rays, the film a scatter-add
(index_put_ with accumulate: on the card its order of addition is not
fixed, so a card image agrees with the CPU's only to rounding).

Radiometry: with W = 1/(A·cos³θ), a vertex with power throughput α and
incoming direction wi splats α·f(wi→ω_cam)·W/d², and the image is the
splat sum × n_pixels / N, the same radiance estimate as the eye-path
tracer's.

`render` and `render_stats` are the light tracer. li and li_stats are
PathTracer's, as in the JAX package, whose ParticleTracer overrides
neither: render_fn and the command line path-trace a ptracer scene, as
the JAX command line does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..bsdf.bsdf import (eval_bsdf_ex, perturb_shading_frame,
                         resolve_material, sample_bsdf_ex)
from ..core import rng
from ..core.math import SHADOW_EPSILON, Frame, dot, normalize
from ..device import check_scene_device
from ..emitter.emitter import sample_emitter_ray
from ..scene.scene import SceneData
from .common import (DIM_BSDF_U1, DIM_BSDF_U2, DIM_NEE_POS, DIM_NEE_SEL,
                     DIM_RR, bounce_dim, offset_ray_origin, ray_mint)
from .path import PathTracer


@dataclass(frozen=True)
class ParticleTracer(PathTracer):
    """Light tracer config (maxDepth/rrDepth semantics as the reference)."""

    def render(self, scene: SceneData, camera, n_particles: int,
               seed: int = 0, device="cuda"):
        """The [H, W, 3] light-traced image of n_particles particles."""
        return self.render_stats(scene, camera, n_particles, seed,
                                 device)[0]

    def render_stats(self, scene: SceneData, camera, n_particles: int,
                     seed: int = 0, device="cuda"):
        """(the [H, W, 3] light-traced image, traced-ray count as a 0-d
        int64 tensor: one a live particle's walk ray, one a camera
        connection attempted, that is from a vertex in front of the
        camera). The draws of particle i are keyed (seed, i) with the JAX
        ParticleTracer's dims."""
        check_scene_device(scene, device)
        tracer = self.specialized_for(scene)
        dev = scene.device
        n = n_particles
        pid = torch.arange(n, dtype=torch.int64, device=dev)
        h, w = camera.height, camera.width
        cam_pos = camera.position(dev)
        accum = torch.zeros((h, w, 3), device=dev)
        n_rays = torch.zeros((), dtype=torch.int64, device=dev)

        def splat(p, value, enabled):
            raster, visible, imp = camera.project(p)
            to_cam = cam_pos - p
            d2 = torch.clamp(torch.sum(to_cam * to_cam, dim=-1), min=1e-12)
            dc = to_cam * torch.rsqrt(d2)[:, None]
            # the camera visibility ray
            so = p + dc * 1e-4 * (
                1.0 + torch.amax(torch.abs(p), dim=-1))[:, None]
            dist = torch.sqrt(d2)
            live = enabled & visible
            occ = tracer._occluded(scene, so, dc, ray_mint(so),
                                   dist * (1.0 - SHADOW_EPSILON), live)
            ok = live & ~occ
            contrib = torch.where(ok[:, None], value * (imp / d2)[:, None],
                                  0.0)
            ix = torch.clamp(raster[:, 0].to(torch.int64), 0, w - 1)
            iy = torch.clamp(raster[:, 1].to(torch.int64), 0, h - 1)
            accum.index_put_((iy, ix), contrib, accumulate=True)
            return live.sum()

        # ---- the emitter vertex (area emitters) --------------------------
        er = sample_emitter_ray(
            scene, rng.sample_1d(seed, pid, bounce_dim(0, DIM_NEE_SEL)),
            rng.sample_2d(seed, pid, bounce_dim(0, DIM_NEE_POS)),
            rng.sample_2d(seed, pid, bounce_dim(0, DIM_BSDF_U2)))
        alpha_pos = er.le * (er.area / torch.clamp(er.pmf, min=1e-12)
                             )[:, None]
        alpha_pos = torch.where(er.is_area[:, None], alpha_pos, 0.0)
        # emitter vertex → camera (directly visible light): with the
        # position density pmf/A, E[α_pos·cosθ_l·W/d²]·n_pix = Le for
        # pixels covering the emitter (one-sided)
        cos_l0 = torch.clamp(dot(normalize(cam_pos - er.p), er.n), min=0.0)
        n_rays = n_rays + splat(er.p, alpha_pos * cos_l0[:, None],
                                er.is_area)

        # ---- the walk: emission direction cosine-weighted (area.cpp) ----
        d = er.d
        alpha = alpha_pos * math.pi     # Le·π·A/pmf
        o = offset_ray_origin(er.p, er.n, d)
        active = er.is_area
        n_bounces = (self.max_depth - 1) if self.max_depth > 0 else 16
        for bounce in range(max(n_bounces, 1)):
            its = tracer._intersect(scene, o, d, ray_mint(o), active)
            n_rays = n_rays + active.sum()
            hit = active & its.valid
            mat = resolve_material(scene, its.mat_id, its.uv,
                                   tracer.families)
            frame = perturb_shading_frame(scene, mat,
                                          Frame.from_normal(its.ns), its.uv)
            wi_local = Frame.to_local(frame, -d)

            # connect to the camera
            to_cam = normalize(cam_pos - its.p)
            f_cam = eval_bsdf_ex(mat, wi_local, Frame.to_local(frame, to_cam),
                                 tracer.families)
            n_rays = n_rays + splat(its.p, alpha * f_cam, hit)

            # continue the walk
            u2 = rng.sample_2d(seed, pid, bounce_dim(bounce + 1, DIM_BSDF_U2))
            u1 = rng.sample_1d(seed, pid, bounce_dim(bounce + 1, DIM_BSDF_U1))
            bs = sample_bsdf_ex(mat, wi_local, u2, u1, tracer.families)
            d_next = Frame.to_world(frame, bs.wo)
            o_next = offset_ray_origin(its.p, its.ng, d_next)
            alpha_next = alpha * bs.weight
            alive = hit & (bs.pdf > 0) & (alpha_next > 0).any(-1)
            depth = bounce + 2
            if self.max_depth > 0:
                alive = alive & (depth <= self.max_depth)
            u_rr = rng.sample_1d(seed, pid, bounce_dim(bounce + 1, DIM_RR))
            q = torch.clamp(alpha_next.amax(-1)
                            / torch.clamp(alpha.amax(-1), min=1e-12),
                            max=0.95)
            if depth >= self.rr_depth:
                rr_cont = u_rr < q
                alpha_next = torch.where(
                    rr_cont[:, None],
                    alpha_next / torch.clamp(q, min=1e-6)[:, None],
                    alpha_next)
                alive = alive & rr_cont
            o = o_next
            d = torch.where(alive[:, None], d_next, d)
            alpha = torch.where(alive[:, None], alpha_next, 0.0)
            active = alive
        return accum * (h * w / n), n_rays.to(torch.int64)
