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

The shading tail of a bounce (NEE BSDF eval, shadow trace, MIS, BSDF
sampling, Russian roulette) runs either eagerly (`_shade_eager`, the JAX
_shade_xla) or as one fused kernel (accel/shade_kernel.py), chosen by
`fused_shade`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..accel import dense, trace
from ..bsdf.bsdf import (eval_bsdf_ex, pdf_bsdf_ex, perturb_shading_frame,
                         resolve_material, sample_bsdf_ex, scene_families)
from ..core.math import SHADOW_EPSILON, Frame, dot
from ..emitter.emitter import (eval_area, eval_env, pdf_direct_area,
                               pdf_direct_env, sample_direct)
from ..sampler.sampler import check_kind, draw_1d, draw_2d
from ..scene.scene import SceneData
from .common import (DIM_BSDF_U1, DIM_BSDF_U2, DIM_NEE_POS, DIM_NEE_SEL,
                     DIM_RR, bounce_dim, mis_power, offset_ray_origin,
                     ray_mint)

_MAXT = 1e30


class _Vertex(NamedTuple):
    """A bounce's path vertex, as PathTracer._vertex leaves it for the
    shading tail. Rows of [N] or [N, 3] tensors."""
    its: object             # the closest-hit Intersection
    frame: tuple            # shading frame (s, t, n)
    mat: object             # MatInfo
    d: torch.Tensor         # incident direction
    throughput: torch.Tensor
    L: torch.Tensor         # radiance with this vertex's emission added
    ds: object              # the NEE sample (emitter DirectSample)
    active: torch.Tensor    # lane active on entry
    hit: torch.Tensor       # active and hit
    shadow: torch.Tensor    # NEE attempted (a shadow ray is counted)
    eta_scale: torch.Tensor
    d1: object              # this bounce's 1-D and 2-D draws by dim offset
    d2: object


@dataclass(frozen=True)
class PathTracer:
    """accel: "auto" traces through the CUDA kernel for CUDA tensors and
    the plain intersector for CPU tensors; "plain" uses the plain
    intersector everywhere (to hold the kernel against it on the card).
    fused_shade: "on" runs the shading tail through
    accel/shade_kernel.py (the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors) and raises NotImplementedError for a scene
    the kernel does not support; "auto" does so for CUDA tensors when the
    scene is supported; "off" (the JAX default) shades eagerly.
    families: the BSDF type codes to dispatch (None: the scene's own).
    specialized_for settles families and fused_shade for one scene and
    marks the copy it returns `settled`; render_fn does so once per
    render, and li_stats and bounce on a tracer that is not settled do
    so per call."""
    max_depth: int = 8          # path vertices, camera included
    rr_depth: int = 5
    accel: str = "auto"
    sampler: str = "independent"
    fused_shade: str = "off"
    families: tuple | None = None
    # set by specialized_for only
    settled: bool = dataclasses.field(default=False, init=False, repr=False)

    def __post_init__(self):
        if self.max_depth <= 0:
            raise NotImplementedError("max_depth <= 0 (unbounded paths)")
        if self.accel not in ("auto", "plain"):
            raise ValueError(f"accel must be 'auto' or 'plain', "
                             f"got {self.accel!r}")
        if self.fused_shade not in ("on", "off", "auto"):
            raise ValueError(f"fused_shade must be 'on', 'off' or 'auto', "
                             f"got {self.fused_shade!r}")
        check_kind(self.sampler)

    def specialized_for(self, scene: SceneData, device=None) -> "PathTracer":
        """This tracer with `families` read from the scene and fused_shade
        settled to "on" or "off" for tensors on `device` (the scene's by
        default); raises NotImplementedError for fused_shade="on" on a
        scene the fused kernel does not support. A settled tracer is
        returned as it is."""
        if self.settled:
            return self
        families = self.families
        if families is None:
            families = scene_families(scene)
        fused = self.fused_shade
        if fused != "off":
            from ..accel.shade_kernel import supports
            dev = scene.device if device is None else torch.device(device)
            ok, reason = supports(scene)
            if fused == "on" and not ok:
                raise NotImplementedError(f"fused_shade='on': {reason}")
            fused = "on" if ok and (fused == "on" or dev.type == "cuda") \
                else "off"
        tracer = dataclasses.replace(self, families=families,
                                     fused_shade=fused)
        object.__setattr__(tracer, "settled", True)
        return tracer

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
        tracer = self.specialized_for(scene, o.device)
        state = initial_state(o, d)
        n_rays = torch.zeros((), dtype=torch.int64, device=o.device)
        for bounce in range(self.max_depth):
            state, traced, shadow = tracer.bounce(scene, state, seed,
                                                  pixel_id, sample_idx, bounce)
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
        if not self.settled:
            return self.specialized_for(scene, state.device).bounce(
                scene, state, seed, pixel, samp, bounce)
        v = self._vertex(scene, state, seed, pixel, samp, bounce)
        if self.fused_shade == "on":
            # one kernel for the tail: NEE BSDF eval, shadow trace, MIS,
            # BSDF sampling, RR (the same RNG dims as _shade_eager)
            from ..accel.shade_kernel import fused_shade
            new = fused_shade(scene, v.its, v.frame, v.mat, v.d,
                              v.throughput, v.L, v.ds, v.active, v.eta_scale,
                              seed, pixel, samp, bounce, self.rr_depth,
                              self.max_depth)
        else:
            new = self._shade_eager(scene, v, bounce + 2)
        return torch.where(v.active, new, state), v.active, v.shadow

    def shade_inputs(self, scene: SceneData, state, seed, pixel, samp,
                     bounce: int):
        """The fused shade kernel's packed input rows [K_IN, N] at this
        bounce of `state` (accel/shade_kernel.py pack_inputs)."""
        from ..accel.shade_kernel import pack_inputs
        v = self.specialized_for(scene, state.device)._vertex(
            scene, state, seed, pixel, samp, bounce)
        return pack_inputs(v.its, v.frame, v.mat, v.d, v.throughput, v.L,
                           v.ds, v.active, v.eta_scale)

    def _vertex(self, scene, state, seed, pixel, samp, bounce: int):
        """The bounce up to its shading tail: the closest hit, the
        environment and emitter-hit terms added to L, the material, the
        shading frame and the NEE sample."""
        o = state[0:3].T.contiguous()
        d = state[3:6].T.contiguous()
        throughput = state[6:9].T.contiguous()
        L = state[9:12].T.contiguous()
        active = state[12] > 0.5
        prev_pdf, prev_delta = state[13], state[14] > 0.5
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

        # ---- next-event estimation -------------------------------------
        nee_allowed = hit & (depth + 1 <= self.max_depth + 1)
        ds = sample_direct(scene, its.p, d1(DIM_NEE_SEL), d2(DIM_NEE_POS))
        return _Vertex(its, frame, mat, d, throughput, L, ds, active, hit,
                       nee_allowed & (ds.pdf > 0), state[15], d1, d2)

    def _bsdf_eval(self, v: "_Vertex", wi, wo):
        """f·cosθo [N, 3] and the pdf [N] of the vertex's BSDF at local
        (wi, wo): bsdf.py's families."""
        return (eval_bsdf_ex(v.mat, wi, wo, self.families),
                pdf_bsdf_ex(v.mat, wi, wo, self.families))

    def _bsdf_sample(self, v: "_Vertex", wi, u2, u1):
        """One BSDF sample at local wi (bsdf.py's families)."""
        return sample_bsdf_ex(v.mat, wi, u2, u1, self.families)

    def _shade_eager(self, scene, v: "_Vertex", depth: int):
        """The shading tail (the JAX _shade_xla): NEE BSDF eval, shadow
        trace, MIS, BSDF sampling and Russian roulette. Returns the new
        state rows [16, N]."""
        its, frame, d, throughput, L, ds, hit, shadow, eta_scale = (
            v.its, v.frame, v.d, v.throughput, v.L, v.ds, v.hit,
            v.shadow, v.eta_scale)
        d1, d2 = v.d1, v.d2
        wi_local = Frame.to_local(frame, -d)
        wo_nee = Frame.to_local(frame, ds.d)
        f_nee, pdf_nee = self._bsdf_eval(v, wi_local, wo_nee)
        contributes = shadow & (f_nee > 0).any(-1)
        # shadow ray over [ε, dist·(1-ShadowEpsilon)] (scene.cpp:846)
        so = offset_ray_origin(its.p, its.ng, ds.d)
        occluded = self._occluded(
            scene, so, ds.d, ray_mint(so),
            ds.dist * (1.0 - SHADOW_EPSILON), contributes)
        contributes = contributes & ~occluded
        w_nee = torch.where(ds.is_delta, 1.0, mis_power(ds.pdf, pdf_nee))
        L = L + torch.where(contributes[:, None], throughput * ds.value
                            * f_nee * w_nee[:, None], 0.0)

        # ---- BSDF sampling → next ray ----------------------------------
        bs = self._bsdf_sample(v, wi_local, d2(DIM_BSDF_U2), d1(DIM_BSDF_U1))
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

        return torch.cat([
            o_next.T, torch.where(alive[:, None], d_next, d).T,
            torch.where(alive[:, None], throughput_next, 0.0).T, L.T,
            torch.stack([alive.to(d.dtype),
                         torch.where(bs.is_delta, 1.0, bs.pdf),
                         bs.is_delta.to(d.dtype), eta_scale])])


def initial_state(o, d):
    """[16, N] state of fresh camera paths along rays o, d [N, 3]: unit
    throughput, zero radiance, active, prev_pdf 1, prev_delta 1, eta 1."""
    n = o.shape[0]
    return torch.cat([o.T, d.T, torch.ones((3, n), dtype=o.dtype,
                                           device=o.device),
                      torch.zeros((3, n), dtype=o.dtype, device=o.device),
                      torch.ones((4, n), dtype=o.dtype, device=o.device)])
