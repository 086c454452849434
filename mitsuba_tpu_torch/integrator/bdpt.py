"""Bidirectional path tracer, MIS over all included strategies (port of
mitsuba_tpu/integrator/bdpt.py; ref: src/integrators/bdpt/bdpt.cpp,
src/libbidir/path.cpp).

Both subpaths are walked to a fixed depth as vertex arrays (`_walk`: one
record a vertex, stacked [K, N, ...] from a Python loop), and every (eye
length e, light length l) strategy pair is a branchless connection over
the whole wavefront with one batched shadow ray. MIS is Veach's pdf-ratio
recursion in the remap-delta-to-one form; e and l are static, so the
ratio products are Python loops over [N] tensors, summed in the JAX
package's order.

Strategies: l ∈ {0 (the eye path hits the emitter), 1 (a connection to a
point sampled on the emitter), ≥ 2 (subpath connections)} with eye
surface vertices e ≥ 1. The t = 1 light-tracing strategy is not in the
sum (ParticleTracer covers it); the weights are a partition of unity over
the included set, so the estimator stays unbiased. Light subpaths start
on area emitters with cosine emission (emitter.sample_emitter_ray); the
environment and delta emitters are reached by the eye strategies only.
No Russian roulette inside subpaths.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..bsdf.bsdf import (eval_bsdf_ex, pdf_bsdf_ex, resolve_material,
                         sample_bsdf_ex)
from ..core.math import SHADOW_EPSILON, Frame, dot
from ..emitter.emitter import eval_env, sample_emitter_ray
from ..scene.scene import SceneData
from .common import (DIM_BSDF_U1, DIM_BSDF_U2, bounce_dim,
                     offset_ray_origin, ray_mint)
from .path import PathTracer

_LIGHT_DIM_BASE = 8192   # RNG dim offset: light-subpath stream
INV_PI = float(1.0 / math.pi)
WALK_KEYS = ("p", "ns", "ng", "mat_id", "uv", "wi", "beta", "d2",
             "pdf_fwd_w", "pdf_back_w", "delta", "valid", "em_id")


def _remap0(x):
    """Veach delta remap: zero (delta) pdfs count as 1 in ratio products."""
    return torch.where(x > 0, x, 1.0)


def _to_area(pdf_w, d2, cos_tgt):
    return pdf_w * torch.abs(cos_tgt) / torch.clamp(d2, min=1e-12)


def _seg(p_from, p_to):
    v = p_to - p_from
    d2 = torch.clamp(torch.sum(v * v, dim=-1), min=1e-12)
    return v * torch.rsqrt(d2)[:, None], d2


@dataclass(frozen=True)
class BDPT(PathTracer):
    """max_depth = maximum path edges (bdpt.cpp maxDepth; <= 0: 6)."""

    def _walk(self, scene, o0, d0, beta_in0, pdf_omega0, active0, seed,
              pixel_id, sample_idx, n_steps, dim_base):
        """Random walk storing one record per vertex, each stacked [K, N,
        ...] (WALK_KEYS): the hit's p, ns, ng, mat_id, uv; wi, the unit
        direction toward the predecessor; beta, the throughput into the
        vertex; d2, the squared distance to the predecessor; pdf_fwd_w,
        the solid-angle pdf with which the predecessor sampled the
        segment; pdf_back_w, the pdf of sampling the reverse segment from
        this vertex's continuation lobe; delta, that lobe was Dirac;
        valid; em_id."""
        o, d, beta, pdf_omega, active = o0, d0, beta_in0, pdf_omega0, active0
        outs = []
        for k in range(n_steps):
            its = self._intersect(scene, o, d, ray_mint(o), active)
            hit = active & its.valid
            mat = resolve_material(scene, its.mat_id, its.uv, self.families)
            frame = Frame.from_normal(its.ns)
            wi_local = Frame.to_local(frame, -d)
            u2 = self._d2(seed, pixel_id, sample_idx,
                          dim_base + bounce_dim(k, DIM_BSDF_U2))
            u1 = self._d1(seed, pixel_id, sample_idx,
                          dim_base + bounce_dim(k, DIM_BSDF_U1))
            bs = sample_bsdf_ex(mat, wi_local, u2, u1, self.families)
            pdf_back_w = pdf_bsdf_ex(mat, bs.wo, wi_local, self.families)
            d2 = torch.clamp(its.t * its.t, min=1e-12)
            outs.append((its.p, its.ns, its.ng, its.mat_id, its.uv, -d, beta,
                         d2, pdf_omega, pdf_back_w, bs.is_delta, hit,
                         its.em_id))
            d_next = Frame.to_world(frame, bs.wo)
            o = offset_ray_origin(its.p, its.ng, d_next)
            beta_next = beta * bs.weight
            alive = hit & (bs.pdf > 0) & (beta_next > 0).any(-1)
            d = torch.where(alive[:, None], d_next, d)
            beta = torch.where(alive[:, None], beta_next, 0.0)
            pdf_omega = torch.where(bs.is_delta, 0.0, bs.pdf)
            active = alive
        return {key: torch.stack([rec[i] for rec in outs])
                for i, key in enumerate(WALK_KEYS)}

    def li_stats(self, scene: SceneData, o, d, seed, pixel_id,
                 sample_idx=0):
        """(radiance [N, 3], count as a 0-d int64 tensor: the connections
        that were traced, contribute and are unoccluded, the JAX BDPT's
        count; the walks' rays are not in it)."""
        if not self.settled:
            return self.specialized_for(scene, o.device).li_stats(
                scene, o, d, seed, pixel_id, sample_idx)
        max_edges = self.max_depth if self.max_depth > 0 else 6
        n_eye = max_edges                  # eye surface vertices x1..xE
        n_light = max(max_edges - 1, 0)    # light surface verts y1..yL
        families = self.families
        zf = o[:, 0] * 0.0
        false = zf > 1.0

        # ---- eye subpath: the camera "pdf" 1e8 is a sentinel that cancels
        # (the camera edge is shared by every included strategy)
        eye = self._walk(scene, o, d, torch.zeros_like(o) + 1.0, zf + 1e8,
                         zf < 1.0, seed, pixel_id, sample_idx, n_eye, 0)

        # ---- light subpath start (area emitter, cosine emission) --------
        er = sample_emitter_ray(
            scene, self._d1(seed, pixel_id, sample_idx, _LIGHT_DIM_BASE - 4),
            self._d2(seed, pixel_id, sample_idx, _LIGHT_DIM_BASE - 3),
            self._d2(seed, pixel_id, sample_idx, _LIGHT_DIM_BASE - 2))
        y0_p, y0_n, le, is_area = er.p, er.n, er.le, er.is_area
        pdf_y0_area = er.pmf / torch.clamp(er.area, min=1e-12)   # pmf/A
        cos0 = torch.clamp(dot(er.d, y0_n), min=0.0)
        pdf_dir0 = cos0 * INV_PI
        # β into y1 = Le·cos/(pdf_pos·pdf_dir) = Le·π·A/pmf
        beta_y1 = le * (cos0 / torch.clamp(pdf_y0_area * pdf_dir0,
                                           min=1e-12))[:, None]
        beta_y1 = torch.where(is_area[:, None], beta_y1, 0.0)
        light = self._walk(scene, offset_ray_origin(y0_p, y0_n, er.d), er.d,
                           beta_y1, pdf_dir0, (zf < 1.0) & is_area, seed,
                           pixel_id, sample_idx, n_light, _LIGHT_DIM_BASE) \
            if n_light > 0 else None

        def bsdf_at(mat_id, uv, ns, wi_w, wo_w, fn):
            fr = Frame.from_normal(ns)
            return fn(resolve_material(scene, mat_id, uv, families),
                      Frame.to_local(fr, wi_w), Frame.to_local(fr, wo_w),
                      families)

        # the stored arrays' area pdfs along each subpath
        def eye_fwd_area(k):        # x_k from x_{k-1} (the camera side)
            if k == 1:
                return zf + 1.0     # the shared camera edge: cancels
            return _to_area(eye["pdf_fwd_w"][k - 1], eye["d2"][k - 1],
                            dot(eye["wi"][k - 1], eye["ns"][k - 1]))

        def eye_rev_area_stored(k):     # x_k from x_{k+1}
            return _to_area(eye["pdf_back_w"][k], eye["d2"][k],
                            dot(eye["wi"][k], eye["ns"][k - 1]))

        def light_fwd_area(k):      # y_k from y_{k-1} (the light side)
            if k == 0:
                return pdf_y0_area
            if k == 1:
                return _to_area(pdf_dir0, light["d2"][0],
                                dot(light["wi"][0], light["ns"][0]))
            return _to_area(light["pdf_fwd_w"][k - 1], light["d2"][k - 1],
                            dot(light["wi"][k - 1], light["ns"][k - 1]))

        def light_rev_area_stored(k):   # y_k from y_{k+1}
            ns_k = y0_n if k == 0 else light["ns"][k - 1]
            return _to_area(light["pdf_back_w"][k], light["d2"][k],
                            dot(light["wi"][k], ns_k))

        def eye_delta(k):
            return eye["delta"][k - 1]

        def light_delta(k):         # y0, an area emitter, is never delta
            return false if k == 0 else light["delta"][k - 1]

        def mis_weight(e, l, rev_e, rev_em1, rev_yl, rev_ylm1):
            """Strategy (e, l)'s weight from its connection's area pdfs:
            rev_e, x_e from the light side; rev_em1, x_{e-1} from x_e lit
            from the junction; rev_yl, y_{l-1} from the eye side (l ≥ 1);
            rev_ylm1, y_{l-2} from y_{l-1} (l ≥ 2)."""
            sum_ri = zf
            # eye side: shorter eye prefixes, down to {camera, x1}
            ri = zf + 1.0
            for i in range(e, 1, -1):
                rev = rev_e if i == e else (
                    rev_em1 if i == e - 1 else eye_rev_area_stored(i))
                ri = ri * _remap0(rev) / _remap0(eye_fwd_area(i))
                d_im1 = eye_delta(i - 1) if i - 1 >= 1 else false
                sum_ri = sum_ri + torch.where(~(eye_delta(i) | d_im1), ri,
                                              0.0)
            # light side: shorter light prefixes
            ri = zf + 1.0
            for i in range(l - 1, -1, -1):
                rev = rev_yl if i == l - 1 else (
                    rev_ylm1 if i == l - 2 else light_rev_area_stored(i))
                ri = ri * _remap0(rev) / _remap0(light_fwd_area(i))
                d_im1 = light_delta(i - 1) if i - 1 >= 0 else false
                sum_ri = sum_ri + torch.where(~(light_delta(i) | d_im1), ri,
                                              0.0)
            return 1.0 / (1.0 + sum_ri)

        # ---- the strategies ------------------------------------------------
        # the environment, seen on the first eye segment (weight 1)
        L = torch.where(~eye["valid"][0][:, None], eval_env(scene, d), 0.0)
        n_rays = torch.zeros((), dtype=torch.int64, device=o.device)
        for e in range(1, n_eye + 1):
            xe_valid, xe_beta = eye["valid"][e - 1], eye["beta"][e - 1]
            xe_p, xe_ns, xe_ng = (eye["p"][e - 1], eye["ns"][e - 1],
                                  eye["ng"][e - 1])
            xe_wi = eye["wi"][e - 1]
            xe_mat, xe_uv = eye["mat_id"][e - 1], eye["uv"][e - 1]
            prev_p = o if e == 1 else eye["p"][e - 2]
            prev_ns = None if e == 1 else eye["ns"][e - 2]

            # ---- l = 0: the eye path hits an emitter --------------------
            em_here = eye["em_id"][e - 1]
            em_c = torch.clamp(em_here, min=0)
            is_em = xe_valid & (em_here >= 0) & (dot(xe_wi, xe_ng) > 0)
            if e == 1:
                w0 = zf + 1.0       # directly visible light
            else:
                # x_e sampled as an emitter position; x_{e-1} from its
                # cosine emission
                rev_e0 = scene.em_pmf.pmf[em_c] / torch.clamp(
                    scene.em_area[em_c], min=1e-12)
                dir_back, d2_back = _seg(xe_p, prev_p)
                rev_em1_0 = _to_area(
                    torch.clamp(dot(dir_back, xe_ns), min=0.0) * INV_PI,
                    d2_back, dot(dir_back, prev_ns))
                w0 = mis_weight(e, 0, rev_e0, rev_em1_0, None, None)
            L = L + torch.where(is_em[:, None], xe_beta
                                * scene.em_radiance[em_c] * w0[:, None], 0.0)

            for l in range(1, min(n_light, max_edges - e) + 1):
                if l == 1:          # the junction is y0 on the emitter
                    yj_p, yj_ns, yj_valid = y0_p, y0_n, is_area
                else:
                    yj_p, yj_ns = light["p"][l - 2], light["ns"][l - 2]
                    yj_valid = light["valid"][l - 2]
                dir_ey, d2_ey = _seg(xe_p, yj_p)      # x_e → y junction
                cos_e = dot(dir_ey, xe_ns)
                cos_y = -dot(dir_ey, yj_ns)
                f_e = bsdf_at(xe_mat, xe_uv, xe_ns, xe_wi, dir_ey,
                              eval_bsdf_ex)
                pdf_e_fwd_w = bsdf_at(xe_mat, xe_uv, xe_ns, xe_wi, dir_ey,
                                      pdf_bsdf_ex)
                if l == 1:
                    # the emitter sample: Le·cosY/(d²·pdf_area)
                    radiometric = le * torch.clamp(cos_y, min=0.0)[:, None] \
                        / torch.clamp(d2_ey * pdf_y0_area,
                                      min=1e-12)[:, None]
                    contrib = xe_beta * f_e * radiometric
                    ok = xe_valid & yj_valid & (cos_y > 1e-6)
                else:
                    yj_wi = light["wi"][l - 2]
                    yj_mat, yj_uv = light["mat_id"][l - 2], light["uv"][l - 2]
                    f_y = bsdf_at(yj_mat, yj_uv, yj_ns, yj_wi, -dir_ey,
                                  eval_bsdf_ex)
                    contrib = (xe_beta * f_e * f_y * light["beta"][l - 2]
                               / torch.clamp(d2_ey, min=1e-12)[:, None])
                    ok = xe_valid & yj_valid
                ok = ok & (contrib > 0).any(-1)

                # visibility
                so = offset_ray_origin(xe_p, xe_ng, dir_ey)
                occ = self._occluded(scene, so, dir_ey, ray_mint(so),
                                     torch.sqrt(d2_ey)
                                     * (1.0 - SHADOW_EPSILON), ok)
                ok = ok & ~occ
                n_rays = n_rays + ok.sum()

                # ---- the connection's reverse pdfs ------------------------
                if l == 1:          # x_e from the emitter's cosine lobe
                    rev_e = _to_area(torch.clamp(
                        -cos_y * 0.0 + torch.clamp(cos_y, min=0.0), min=0.0)
                        * INV_PI, d2_ey, cos_e)
                else:
                    rev_e = _to_area(bsdf_at(yj_mat, yj_uv, yj_ns, yj_wi,
                                             -dir_ey, pdf_bsdf_ex),
                                     d2_ey, cos_e)
                rev_em1 = None      # e == 1: never read (the loop stops at 2)
                if e > 1:
                    dir_back, d2_back = _seg(xe_p, prev_p)
                    rev_em1 = _to_area(
                        bsdf_at(xe_mat, xe_uv, xe_ns, dir_ey, dir_back,
                                pdf_bsdf_ex),
                        d2_back, dot(dir_back, prev_ns))
                rev_yl = _to_area(pdf_e_fwd_w, d2_ey, cos_y)
                rev_ylm1 = None
                if l >= 2:
                    yprev_p = y0_p if l == 2 else light["p"][l - 3]
                    yprev_ns = y0_n if l == 2 else light["ns"][l - 3]
                    dir_yback, d2_yback = _seg(yj_p, yprev_p)
                    rev_ylm1 = _to_area(
                        bsdf_at(yj_mat, yj_uv, yj_ns, -dir_ey, dir_yback,
                                pdf_bsdf_ex),
                        d2_yback, dot(dir_yback, yprev_ns))
                w = mis_weight(e, l, rev_e, rev_em1, rev_yl, rev_ylm1)
                L = L + torch.where(ok[:, None], contrib * w[:, None], 0.0)
        return L, n_rays
