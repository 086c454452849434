"""Path-replay backpropagation (PRB): reverse-mode gradients of the path
tracer with no path tape (port of mitsuba_tpu/integrator/prb.py,
PRBPathTracer.li_and_grad).

A detached forward pass gives L. A replay then re-traces the same paths
(the counter-based sample streams key every draw) and rebuilds each
bounce's adjoint from the path's product form

    L = Σ_k T_k · c_k,   T_{k+1} = T_k ⊙ w_k,   T_0 = 1

with c_k the bounce's own contribution (emission, environment, NEE) and
w_k its continuation weight (the BSDF weight, Russian roulette folded
in). Carrying the remaining radiance R_{k+1} = (R_k − c_k) / w_k, R_0 = L,
gives

    ∂L/∂θ = Σ_k dL ⊙ T_k · [∂c_k/∂θ + ∂w_k/∂θ ⊙ R_{k+1}],

so each bounce needs only a local vector-Jacobian product of (c_k, w_k)
with respect to the tables scene.mat_params and scene.em_radiance, taken
with torch.autograd.grad over a function that closes over the bounce's
detached decisions: the direction, pdfs, MIS weights, roulette,
visibility and the NEE sample. One bounce's graph lives at a time.

Every trace of both passes is detached, so on the card the CUDA trace
kernel (accel/trace.py) runs under them, forward only, as the TPU kernel
runs under the JAX replay; the forward pass may also take the fused shade
kernel. The replay shades as the JAX one does: leaf material rows
(bsdf.resolve_params) in Frame.from_normal(ns). `supports` refuses the
scenes where that does not reproduce the forward pass.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..bsdf.bsdf import (COMPOSITE_FAMILIES, conductor_sample, eval_bsdf,
                         has_shading_maps, pdf_bsdf, resolve_params,
                         sample_bsdf, scene_families)
from ..core.math import SHADOW_EPSILON, Frame, dot
from ..emitter.emitter import (eval_area, eval_env, pdf_direct_area,
                               pdf_direct_env, sample_direct)
from ..scene.scene import MAT_CONDUCTOR, SceneData
from .common import (DIM_BSDF_U1, DIM_BSDF_U2, DIM_NEE_POS, DIM_NEE_SEL,
                     DIM_RR, bounce_dim, mis_power, offset_ray_origin,
                     ray_mint)
from .path import PathTracer, pass_bounces


def supports(scene: SceneData) -> tuple[bool, str]:
    """(ok, reason): does the replay reproduce the forward pass on this
    scene? The JAX replay resolves leaf rows only and shades in the
    unperturbed frame of the shading normal, while its forward pass
    handles composites and normal and bump maps; and the forward pass of
    PathTracer has no medium terms (VolPathTracer's). So a composite BSDF,
    a normal or bump map or a medium is refused (a host read)."""
    comp = sorted(set(scene_families(scene)) & set(COMPOSITE_FAMILIES))
    if comp:
        return False, (f"composite BSDF families {comp}: the replay "
                       "resolves leaf rows only (resolve_params), so its "
                       "c_k and w_k do not reproduce the forward pass")
    if has_shading_maps(scene):
        return False, ("normal or bump map: the replay shades in the "
                       "shading normal's own frame, the forward pass in "
                       "the perturbed one")
    if bool(scene.has_medium):
        return False, ("participating medium: PathTracer's estimator has "
                       "no medium terms (VolPathTracer's)")
    return True, ""


@dataclass(frozen=True)
class PRBPathTracer(PathTracer):
    """PathTracer with a tape-free backward pass (li_and_grad)."""

    def li_and_grad(self, scene: SceneData, o, d, seed, pixel_id,
                    sample_idx, dL):
        """Radiance and parameter gradients in one replay sweep. o, d
        [N, 3] primary rays; seed, pixel_id, sample_idx as for li; dL
        [N, 3] the adjoint of the per-lane radiance (∂loss/∂L). Returns
        (L [N, 3], {"mat_params": [M, 24], "em_radiance": [E, 3]}), all
        detached. Raises NotImplementedError on a scene `supports`
        refuses."""
        ok, reason = supports(scene)
        if not ok:
            raise NotImplementedError(f"PRBPathTracer: {reason}")
        sc_det = scene._replace(mat_params=scene.mat_params.detach(),
                                em_radiance=scene.em_radiance.detach())
        tracer = self.specialized_for(sc_det, o.device)
        fams = tracer.families
        with torch.no_grad():
            L = tracer.li(sc_det, o, d, seed, pixel_id, sample_idx)
        mat_tbl, em_tbl = sc_det.mat_params, sc_det.em_radiance
        g_mat, g_em = torch.zeros_like(mat_tbl), torch.zeros_like(em_tbl)

        n = o.shape[0]
        ones = torch.ones(n, dtype=o.dtype, device=o.device)
        throughput, R = torch.ones_like(o), L
        active = prev_delta = ones > 0
        eta_scale = prev_pdf = ones
        for bounce in range(pass_bounces(self.max_depth)):
            d1 = lambda off: tracer._d1(seed, pixel_id, sample_idx,
                                        bounce_dim(bounce, off))
            d2 = lambda off: tracer._d2(seed, pixel_id, sample_idx,
                                        bounce_dim(bounce, off))
            # ---- the bounce's detached decisions ----------------------
            with torch.no_grad():
                its = tracer._intersect(sc_det, o, d, ray_mint(o), active)
                hit = active & its.valid
                escaped = active & ~its.valid
                cos_surf = -dot(d, its.ng)
                frame = Frame.from_normal(its.ns)
                wi = Frame.to_local(frame, -d)
                ds = sample_direct(sc_det, its.p, d1(DIM_NEE_SEL),
                                   d2(DIM_NEE_POS))
                depth = bounce + 2
                nee_try = (hit & (depth + 1 <= self.max_depth + 1)
                           if self.max_depth > 0 else hit) & (ds.pdf > 0)
                so = offset_ray_origin(its.p, its.ng, ds.d)
                occluded = tracer._occluded(
                    sc_det, so, ds.d, ray_mint(so),
                    ds.dist * (1.0 - SHADOW_EPSILON), nee_try)
                nee_live = nee_try & ~occluded
                wo_nee = Frame.to_local(frame, ds.d)
                u2, u1 = d2(DIM_BSDF_U2), d1(DIM_BSDF_U1)
                mtype, params_det = resolve_params(sc_det, its.mat_id,
                                                   its.uv)
                bs = sample_bsdf(mtype, params_det, wi, u2, u1, fams)
                # MIS weights
                hide = self.hide_emitters and bounce == 0
                w_env = torch.where(prev_delta, 1.0, mis_power(
                    prev_pdf, pdf_direct_env(sc_det, d)))
                w_hit = torch.where(prev_delta, 1.0, mis_power(
                    prev_pdf, pdf_direct_area(sc_det, its.em_id, d, its.t,
                                              cos_surf)))
                if hide:
                    w_env, w_hit = (torch.zeros_like(w_env),
                                    torch.zeros_like(w_hit))
                w_nee = torch.where(ds.is_delta, 1.0, mis_power(
                    ds.pdf, pdf_bsdf(mtype, params_det, wi, wo_nee, fams)))

            # ---- the bounce's differentiable (c_k, w_k) ---------------
            mat_live = mat_tbl.detach().requires_grad_()
            em_live = em_tbl.detach().requires_grad_()
            with torch.enable_grad():
                sc_live = scene._replace(mat_params=mat_live,
                                         em_radiance=em_live)
                c = torch.where(escaped[:, None],
                                eval_env(sc_live, d) * w_env[:, None], 0.0)
                c = c + torch.where(
                    hit[:, None],
                    eval_area(sc_live, its.em_id, cos_surf) * w_hit[:, None],
                    0.0)
                # NEE: the radiance live; pdf and visibility detached
                _, params_live = resolve_params(sc_live, its.mat_id, its.uv)
                f_nee = eval_bsdf(mtype, params_live, wi, wo_nee, fams)
                if scene.n_emitters:
                    rad_live = em_live[torch.clamp(ds.em_id, min=0)]
                    # a delta light's value holds 1/dist² and 1/pmf: scale
                    # the live radiance by the detached value/radiance
                    rad_det = rad_live.detach()
                    val_scale = torch.where(
                        rad_det > 1e-20,
                        ds.value / torch.clamp(rad_det, min=1e-20), 0.0)
                    c = c + torch.where(
                        (nee_live & (ds.em_id >= 0))[:, None],
                        rad_live * val_scale * f_nee * w_nee[:, None], 0.0)
                # the continuation weight at the detached direction and pdf
                f_cont = eval_bsdf(mtype, params_live, wi, bs.wo, fams)
                inv_pdf = torch.where(bs.pdf > 0, 1.0 / torch.clamp(
                    bs.pdf, min=1e-20), 0.0)
                w = torch.where(bs.is_delta[:, None], bs.weight,
                                f_cont * inv_pdf[:, None])
                if MAT_CONDUCTOR in fams:
                    # the conductor's delta lobe: F(wi)·spec, live params
                    wt_c = conductor_sample(params_live, wi, u2, u1).weight
                    w = torch.where((mtype == MAT_CONDUCTOR)[:, None], wt_c,
                                    w)
            c_k, w_raw = c.detach(), w.detach()

            # ---- roulette (detached), folded into w_k -----------------
            with torch.no_grad():
                eta_next = eta_scale * bs.eta
                tp_raw = throughput * w_raw
                alive = hit & (bs.pdf > 0) & (tp_raw > 0).any(-1)
                if self.max_depth > 0:
                    alive = alive & (depth <= self.max_depth)
                rr_scale = ones
                if depth >= self.rr_depth:
                    q = torch.clamp(tp_raw.amax(-1) * eta_next ** 2,
                                    max=0.95)
                    rr_continue = d1(DIM_RR) < q
                    alive = alive & rr_continue
                    rr_scale = torch.where(
                        rr_continue, 1.0 / torch.clamp(q, min=1e-6), 1.0)
                w_k = torch.where(alive[:, None],
                                  w_raw * rr_scale[:, None], 0.0)
                # the remaining radiance after this bounce, per unit T_{k+1}
                R_next = torch.where(w_k > 1e-12, (R - c_k) / torch.clamp(
                    w_k, min=1e-12), 0.0).clamp(-1e6, 1e6)
                cot_c = dL * throughput
                # w_k = w_raw · rr_scale: ∂/∂w_raw carries rr_scale
                cot_w = cot_c * R_next * rr_scale[:, None]

            # ---- the local VJP -----------------------------------------
            outs = [(x, g) for x, g in ((c, cot_c), (w, cot_w))
                    if x.requires_grad]
            if outs:
                grads = torch.autograd.grad(
                    [x for x, _ in outs], (mat_live, em_live),
                    [g for _, g in outs], allow_unused=True)
                if grads[0] is not None:
                    g_mat += grads[0]
                if grads[1] is not None:
                    g_em += grads[1]

            with torch.no_grad():
                d_next = Frame.to_world(frame, bs.wo)
                o = offset_ray_origin(its.p, its.ng, d_next)
                d = torch.where(alive[:, None], d_next, d)
                throughput = torch.where(alive[:, None], throughput * w_k,
                                         0.0)
                R, active, eta_scale = R_next, alive, eta_next
                prev_pdf = torch.where(bs.is_delta, 1.0, bs.pdf)
                prev_delta = bs.is_delta
        return L, {"mat_params": g_mat, "em_radiance": g_em}
