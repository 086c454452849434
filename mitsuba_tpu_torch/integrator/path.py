"""Unidirectional path tracer with NEE + MIS + Russian roulette (port of
mitsuba_tpu/integrator/path.py PathTracer, without lane compaction).

A Python loop over `bounce` carries the wavefront state, 16 rows per lane:
position, direction, throughput, radiance, the active flag, the previous
BSDF pdf for MIS and the RR eta scale (the JAX megakernel's layout, so the
CUDA megakernel of accel/megakernel.py holds one bounce against this one).
Every lane of the wavefront runs every bounce; terminated lanes ride along
unchanged and the trace kernel skips them (`live`). Defaults match
the reference: rr_depth=5, RR continue probability
q = min(max(throughput)·η², 0.95), power-heuristic MIS, depth counts path
vertices (camera = 1) (ref: path.cpp:120-295). Unbounded paths
(max_depth <= 0) and hidden emitters are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..accel import dense, trace
from ..bsdf.bsdf import (eval_bsdf_ex, pdf_bsdf_ex, perturb_shading_frame,
                         resolve_material, sample_bsdf_ex)
from ..core.math import SHADOW_EPSILON, Frame, dot
from ..emitter.emitter import (eval_area, eval_env, pdf_direct_area,
                               pdf_direct_env, sample_direct)
from ..sampler.sampler import check_kind, draw_1d, draw_2d
from ..scene.scene import SceneData
from .common import (DIM_BSDF_U1, DIM_BSDF_U2, DIM_NEE_POS, DIM_NEE_SEL,
                     DIM_RR, bounce_dim, mis_power, offset_ray_origin,
                     ray_mint)

_MAXT = 1e30


@dataclass(frozen=True)
class PathTracer:
    """accel: "auto" traces through the CUDA kernel for CUDA tensors and
    the plain intersector for CPU tensors; "plain" uses the plain
    intersector everywhere (to hold the kernel against it on the card)."""
    max_depth: int = 8          # path vertices, camera included
    rr_depth: int = 5
    accel: str = "auto"
    sampler: str = "independent"

    def __post_init__(self):
        if self.max_depth <= 0:
            raise NotImplementedError("max_depth <= 0 (unbounded paths)")
        if self.accel not in ("auto", "plain"):
            raise ValueError(f"accel must be 'auto' or 'plain', "
                             f"got {self.accel!r}")
        check_kind(self.sampler)

    def _intersect(self, scene, o, d, mint, live):
        maxt = torch.full_like(mint, _MAXT)
        if self.accel == "plain":
            return dense.ray_intersect(scene, o, d, mint, maxt, live)
        return trace.intersect(scene, o, d, mint, maxt, live)

    def _occluded(self, scene, o, d, mint, maxt, live):
        if self.accel == "plain":
            return dense.ray_test(scene, o, d, mint, maxt, live)
        return trace.occluded(scene, o, d, mint, maxt, live)

    def li(self, scene: SceneData, o, d, seed, pixel_id, sample_idx=0):
        """Radiance [N, 3] along primary rays (o, d) [N, 3]. seed: int;
        pixel_id: [N] integer tensor; sample_idx: int or [N] tensor —
        together they key every random draw."""
        return self.li_stats(scene, o, d, seed, pixel_id, sample_idx)[0]

    def li_stats(self, scene: SceneData, o, d, seed, pixel_id,
                 sample_idx=0):
        """Like li, but also returns the traced-ray count, a 0-d int64
        tensor: one per live intersection ray, one per attempted shadow
        ray (the JAX package's count)."""
        state = initial_state(o, d)
        n_rays = torch.zeros((), dtype=torch.int64, device=o.device)
        for bounce in range(self.max_depth):
            state, traced, shadow = self.bounce(scene, state, seed, pixel_id,
                                                sample_idx, bounce)
            n_rays = n_rays + traced.sum() + shadow.sum()
        return state[9:12].T, n_rays

    def bounce(self, scene: SceneData, state, seed, pixel, samp, bounce: int):
        """One bounce of the wavefront (the plain version of the megakernel
        bounce, accel/megakernel.py): state [16, N] with rows o xyz, d
        xyz, throughput rgb, L rgb, active, prev_pdf, prev_delta,
        eta_scale; pixel [N] integer ids, samp an int or [N] sample
        indices, bounce the 0-based bounce index. Returns (new state
        [16, N], traced [N] bool: this lane traced a closest-hit ray,
        shadow [N] bool: it attempted a shadow ray). Lanes inactive on
        entry come out unchanged."""
        o = state[0:3].T.contiguous()
        d = state[3:6].T.contiguous()
        throughput = state[6:9].T.contiguous()
        L = state[9:12].T.contiguous()
        active = state[12] > 0.5
        prev_pdf, prev_delta = state[13], state[14] > 0.5
        eta_scale = state[15]
        d1 = lambda off: draw_1d(seed, pixel, samp, bounce_dim(bounce, off))
        d2 = lambda off: draw_2d(seed, pixel, samp, bounce_dim(bounce, off))

        its = self._intersect(scene, o, d, ray_mint(o), active)

        # ---- escaped rays: environment emitter -------------------------
        escaped = active & ~its.valid
        w_env = torch.where(prev_delta, 1.0,
                            mis_power(prev_pdf, pdf_direct_env(scene, d)))
        L = L + torch.where(escaped[:, None], throughput
                            * eval_env(scene, d) * w_env[:, None], 0.0)

        # ---- emitter hit on a surface ----------------------------------
        hit = active & its.valid
        cos_surf = -dot(d, its.ng)          # > 0 ⇒ front side
        le = eval_area(scene, its.em_id, cos_surf)
        nee_pdf_hit = pdf_direct_area(scene, its.em_id, d, its.t, cos_surf)
        w_hit = torch.where(prev_delta, 1.0,
                            mis_power(prev_pdf, nee_pdf_hit))
        L = L + torch.where(hit[:, None],
                            throughput * le * w_hit[:, None], 0.0)

        depth = bounce + 2      # path vertices: camera = 1, this hit
        mat = resolve_material(scene, its.mat_id)
        frame = perturb_shading_frame(
            scene, mat, Frame.from_normal(its.ns), its.uv)
        wi_local = Frame.to_local(frame, -d)

        # ---- next-event estimation -------------------------------------
        nee_allowed = hit & (depth + 1 <= self.max_depth + 1)
        ds = sample_direct(scene, its.p, d1(DIM_NEE_SEL), d2(DIM_NEE_POS))
        shadow = nee_allowed & (ds.pdf > 0)
        wo_nee = Frame.to_local(frame, ds.d)
        f_nee = eval_bsdf_ex(mat, wi_local, wo_nee)
        contributes = shadow & (f_nee > 0).any(-1)
        # shadow ray over [ε, dist·(1-ShadowEpsilon)] (scene.cpp:846)
        so = offset_ray_origin(its.p, its.ng, ds.d)
        occluded = self._occluded(
            scene, so, ds.d, ray_mint(so),
            ds.dist * (1.0 - SHADOW_EPSILON), contributes)
        contributes = contributes & ~occluded
        w_nee = torch.where(ds.is_delta, 1.0, mis_power(
            ds.pdf, pdf_bsdf_ex(mat, wi_local, wo_nee)))
        L = L + torch.where(contributes[:, None], throughput * ds.value
                            * f_nee * w_nee[:, None], 0.0)

        # ---- BSDF sampling → next ray ----------------------------------
        bs = sample_bsdf_ex(mat, wi_local, d2(DIM_BSDF_U2), d1(DIM_BSDF_U1))
        d_next = Frame.to_world(frame, bs.wo)
        o_next = offset_ray_origin(its.p, its.ng, d_next)
        throughput_next = throughput * bs.weight
        alive = (hit & (bs.pdf > 0) & (throughput_next > 0).any(-1)
                 & (depth <= self.max_depth))

        # ---- Russian roulette (path.cpp:278-289) -----------------------
        eta_scale = eta_scale * bs.eta
        q = torch.clamp(throughput_next.amax(-1) * eta_scale ** 2, max=0.95)
        if depth >= self.rr_depth:
            rr_continue = d1(DIM_RR) < q
            throughput_next = torch.where(
                rr_continue[:, None],
                throughput_next / torch.clamp(q, min=1e-6)[:, None],
                throughput_next)
            alive = alive & rr_continue

        new = torch.cat([
            o_next.T, torch.where(alive[:, None], d_next, d).T,
            torch.where(alive[:, None], throughput_next, 0.0).T, L.T,
            torch.stack([alive.to(state.dtype),
                         torch.where(bs.is_delta, 1.0, bs.pdf),
                         bs.is_delta.to(state.dtype), eta_scale])])
        return torch.where(active, new, state), active, shadow


def initial_state(o, d):
    """[16, N] state of fresh camera paths along rays o, d [N, 3]: unit
    throughput, zero radiance, active, prev_pdf 1, prev_delta 1, eta 1."""
    n = o.shape[0]
    return torch.cat([o.T, d.T, torch.ones((3, n), dtype=o.dtype,
                                           device=o.device),
                      torch.zeros((3, n), dtype=o.dtype, device=o.device),
                      torch.ones((4, n), dtype=o.dtype, device=o.device)])
