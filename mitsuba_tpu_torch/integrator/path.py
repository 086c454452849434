"""Unidirectional path tracer with NEE + MIS + Russian roulette (port of
mitsuba_tpu/integrator/path.py PathTracer, with its wavefront machinery).

A Python loop over `bounce` carries the wavefront state, 16 rows per lane:
position, direction, throughput, radiance, the active flag, the previous
BSDF pdf for MIS and the RR eta scale (the JAX megakernel's layout, so the
CUDA megakernel of accel/megakernel.py holds one bounce against this one).
Terminated lanes ride along unchanged and the trace kernel skips them
(`live`). Defaults match
the reference: rr_depth=5, RR continue probability
q = min(max(throughput)·η², 0.95), power-heuristic MIS, depth counts path
vertices (camera = 1) (ref: path.cpp:120-295). max_depth <= 0 is
unbounded, as in the JAX PathTracer: no depth guard, and li_stats runs
UNBOUNDED_BOUNCES bounces. hide_emitters zeroes the MIS weights of the
environment and of an emitter hit at bounce 0, as the JAX PathTracer
(path.py:239, :251): the camera sees no emitter.

The wavefront machinery of the JAX PathTracer (path.py:186-221,
:300-370), on where the trace route is the kernel's (accel="auto") and
the scene has COMPACT_MIN_TRIS real triangles or more (`wavefront`):
after every bounce a stable partition packs the live lanes to the front
(one index_select of the [16, N] state, the lanes' pixel ids, sample
indices and original positions moving with it, so every lane draws its
own sample stream), ordered by the hit triangle's cluster and the next
direction's octant where the coherence sort is on (`sort_rays`); from
GATE_MIN_LANES lanes a bounce runs on the narrowest prefix N >> k
(k <= gate_depth) that holds every live lane, and the dead tail rides
through untouched. L goes back to the caller's lane order at the end.
Every lane's value is the uncompacted loop's.

Reverse-mode autograd runs through the whole path, with respect to
scene.mat_params and scene.em_radiance (tests/test_torch_prb.py holds it
to central differences). The kernels have no backward: the wrappers
refuse an input that requires grad, fused_shade="on" raises while a
parameter table requires grad, and a bounce's rays are detached where no
ray can depend on a parameter (`fixed_rays`), so that on such a scene the
trace kernel sees inputs that need no gradient.

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
from ..bsdf.bsdf import (FIXED_DIRECTION_FAMILIES, eval_bsdf_ex,
                         has_shading_maps, pdf_bsdf_ex,
                         perturb_shading_frame, resolve_material,
                         sample_bsdf_ex, scene_families)
from ..core.math import SHADOW_EPSILON, Frame, dot
from ..emitter.emitter import (eval_area, eval_env, pdf_direct_area,
                               pdf_direct_env, sample_direct)
from ..sampler.sampler import check_kind, draw_1d, draw_2d
from ..scene.scene import SceneData
from .common import (DIM_BSDF_U1, DIM_BSDF_U2, DIM_NEE_POS, DIM_NEE_SEL,
                     DIM_RR, bounce_dim, mis_power, offset_ray_origin,
                     ray_mint)

_MAXT = 1e30
# bounces li_stats runs for an unbounded path (max_depth <= 0), as the JAX
# PathTracer (mitsuba_tpu/integrator/path.py:383)
UNBOUNDED_BOUNCES = 32
# the JAX PathTracer's thresholds of its wavefront machinery (read at
# call time: tests and chip_smoke.py raise COMPACT_MIN_TRIS to run the
# plain loop, and tests lower GATE_MIN_LANES to gate a small image)
COMPACT_MIN_TRIS = 512      # compaction: mitsuba_tpu/integrator/path.py:193
SORT_MIN_CLUSTERS = 32      # coherence sort, sort_rays="auto": :198-200
GATE_MIN_LANES = 1 << 16    # prefix gating: :218
SORT_RAYS = ("on", "off", "auto")
_DEAD_KEY = 1 << 62         # a dead lane's sort key: after every live one


def pass_bounces(max_depth: int) -> int:
    """Bounces a pass runs: max_depth, or UNBOUNDED_BOUNCES when it is
    unbounded (<= 0)."""
    return max_depth if max_depth > 0 else UNBOUNDED_BOUNCES


def wants_param_grad(scene: SceneData) -> bool:
    """Whether autograd is recording a gradient of the scene's parameter
    tables (mat_params or em_radiance) here."""
    return torch.is_grad_enabled() and (scene.mat_params.requires_grad
                                        or scene.em_radiance.requires_grad)


def fixed_rays(scene: SceneData, families) -> bool:
    """Whether no ray of a path can depend on the material rows: every
    family samples its direction from wi and the draws alone, and no
    normal or bump map (whose bump scale is a material column) perturbs
    the shading frame (a host read)."""
    return (set(families) <= FIXED_DIRECTION_FAMILIES
            and not has_shading_maps(scene))


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
    event: torch.Tensor     # active with an event: a surface hit, or a
                            # scatter in the medium (VolPathTracer)
    shadow: torch.Tensor    # NEE attempted
    eta_scale: torch.Tensor
    d1: object              # this bounce's 1-D and 2-D draws by dim offset
    d2: object
    scatter: object = None  # active and scattered in the medium, or None
    p: object = None        # the event point (the hit, or the scatter)


@dataclass(frozen=True)
class PathTracer:
    """accel: "auto" traces through the CUDA kernel for CUDA tensors and
    the plain intersector for CPU tensors; "plain" uses the plain
    intersector everywhere (to hold the kernel against it on the card).
    fused_shade: "on" runs the shading tail through
    accel/shade_kernel.py (the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors) and raises NotImplementedError for a scene
    the kernel does not support, or while scene.mat_params or
    scene.em_radiance requires grad under grad mode (the kernel has no
    backward, on either device); "auto" turns it on for CUDA tensors when
    the scene is supported and no parameter gradient is recorded, and
    settles to "off" otherwise; "off" (the JAX default) shades eagerly.
    families: the BSDF type codes to dispatch (None: the scene's own).
    sampler, spp: the sample generator of every draw (sampler/
    sampler.py), as the JAX fields; render_fn draws the pixel jitter
    with it too.
    hide_emitters: bounce 0 adds no emitted radiance (the JAX field).
    gate_depth: the prefix gate's halvings (N ... N >> gate_depth; 0
    runs every bounce on all N lanes); sort_rays: "on", "off" or "auto"
    (on from SORT_MIN_CLUSTERS clusters), the coherence sort inside the
    compaction (the JAX fields; `wavefront` says where they apply).
    specialized_for settles families, fused_shade and fixed_rays for one
    scene and marks the copy it returns `settled`; render_fn does so once
    per render, and li_stats and bounce on a tracer that is not settled
    do so per call."""
    max_depth: int = 8          # path vertices, camera included; <= 0:
                                # unbounded
    rr_depth: int = 5
    accel: str = "auto"
    sampler: str = "independent"    # sampler/sampler.py kind
    spp: int = 0                    # its strata count (stratified, ld,
                                    # hammersley); 0 draws independent
    fused_shade: str = "off"
    families: tuple | None = None
    hide_emitters: bool = False
    gate_depth: int = 5
    sort_rays: str = "auto"
    # set by specialized_for only
    settled: bool = dataclasses.field(default=False, init=False, repr=False)
    fixed_rays: bool = dataclasses.field(default=False, init=False,
                                         repr=False)
    # the shadow rays bounce counts: attempted (the JAX PathTracer and the
    # megakernel) or, when False, unoccluded (the JAX VolPathTracer)
    count_attempted = True
    # li_stats runs the wavefront machinery (the JAX PathTracer's loop; the
    # JAX VolPathTracer's own loop has none)
    compacts = True

    def __post_init__(self):
        if self.accel not in ("auto", "plain"):
            raise ValueError(f"accel must be 'auto' or 'plain', "
                             f"got {self.accel!r}")
        if self.fused_shade not in ("on", "off", "auto"):
            raise ValueError(f"fused_shade must be 'on', 'off' or 'auto', "
                             f"got {self.fused_shade!r}")
        check_kind(self.sampler)
        if self.sort_rays not in SORT_RAYS:
            raise ValueError(f"sort_rays must be 'on', 'off' or 'auto', "
                             f"got {self.sort_rays!r}")
        if not isinstance(self.gate_depth, int) or self.gate_depth < 0:
            raise ValueError(f"gate_depth must be an int >= 0, got "
                             f"{self.gate_depth!r}")

    def specialized_for(self, scene: SceneData, device=None) -> "PathTracer":
        """This tracer with `families` read from the scene, fused_shade
        settled to "on" or "off" for tensors on `device` (the scene's by
        default) and whether the scene's rays are fixed (fixed_rays);
        raises NotImplementedError for fused_shade="on" on a scene the
        fused kernel does not support or whose parameters autograd
        records. A settled tracer is returned as it is."""
        if self.settled:
            return self
        families = self.families
        if families is None:
            families = scene_families(scene)
        fused = self.fused_shade
        if fused == "on":
            self._check_fused(scene)
        if fused != "off":
            from ..accel.shade_kernel import supports
            dev = scene.device if device is None else torch.device(device)
            ok, reason = supports(scene, self.sampler)
            if fused == "on" and not ok:
                raise NotImplementedError(f"fused_shade='on': {reason}")
            fused = "on" if ok and (fused == "on" or (
                dev.type == "cuda" and not wants_param_grad(scene))) \
                else "off"
        tracer = dataclasses.replace(self, families=families,
                                     fused_shade=fused)
        object.__setattr__(tracer, "settled", True)
        object.__setattr__(tracer, "fixed_rays", fixed_rays(scene, families))
        return tracer

    @staticmethod
    def _check_fused(scene):
        if wants_param_grad(scene):
            raise NotImplementedError(
                "fused_shade='on': the shade kernel has no backward, and "
                "scene.mat_params or scene.em_radiance requires grad; use "
                "fused_shade='off' or 'auto', or run under torch.no_grad()")

    def _d1(self, seed, pixel, samp, dim):
        """One draw per lane from the tracer's sampler."""
        return draw_1d(self.sampler, seed, pixel, samp, self.spp, dim)

    def _d2(self, seed, pixel, samp, dim):
        """Two draws per lane ([N, 2]) from the tracer's sampler."""
        return draw_2d(self.sampler, seed, pixel, samp, self.spp, dim)

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

    def wavefront(self, scene: SceneData, n: int):
        """The JAX PathTracer's machinery for n lanes of this scene
        (path.py:186-221): (compact, sort, gate widths). Compaction runs
        where the trace route is the kernel's (accel="auto") and the scene
        has COMPACT_MIN_TRIS real triangles or more. This differs from
        JAX on a scene of fewer than 512 real triangles: JAX reads the
        padded count (p0.shape[0], 512 or more for any scene compiled at
        the default cluster size), so it compacts the Cornell box, and
        the port does not (ROADMAP.md Queue C, the entry on
        mitsuba_tpu/integrator/path.py:193); every lane's value is the
        same either way. The sort runs where compacting and sort_rays is
        "on", or "auto" with SORT_MIN_CLUSTERS table clusters or more;
        the gate where compacting with GATE_MIN_LANES lanes or more, at
        the widths n >> k, k = 0 ... gate_depth ([n]: no gate)."""
        compact = (self.compacts and self.accel == "auto"
                   and trace.real_tris(scene) >= COMPACT_MIN_TRIS)
        sort = compact and (self.sort_rays == "on" or (
            self.sort_rays == "auto"
            and scene.woop_clusters.shape[0] >= SORT_MIN_CLUSTERS))
        gates = [n]
        if compact and n >= GATE_MIN_LANES:
            gates = [n >> k for k in range(self.gate_depth + 1)
                     if n >> k > 0]
        return compact, sort, gates

    def li_stats(self, scene: SceneData, o, d, seed, pixel_id,
                 sample_idx=0, tex_lod=None):
        """Like li, but also returns the traced-ray count, a 0-d int64
        tensor: one per live intersection ray, one per attempted shadow
        ray (the JAX package's count). Where `wavefront` turns compaction
        on, the lanes move after every bounce and L comes back in the
        caller's order; with the gate, each bounce reads the live count
        on the host (one sync a bounce). tex_lod: None, or the primary
        hits' uv footprint extents [N] (LoD path tracing,
        integrator/footprint.py): bounce 0 looks its textures up at the
        matching mip level, every later bounce at extent 0 (level 0,
        trilinear), as the JAX PathTracer does (path.py:259-265). Bounce
        0 runs before any lane moves, so the extents need no reorder."""
        tracer = self.specialized_for(scene, o.device)
        n = o.shape[0]
        state = initial_state(o, d)
        n_rays = torch.zeros((), dtype=torch.int64, device=o.device)
        compact, sort, gates = tracer.wavefront(scene, n)
        lod = lambda bounce, m: None if tex_lod is None else (
            tex_lod if bounce == 0 else torch.zeros_like(tex_lod[:m]))
        if not compact:
            for bounce in range(pass_bounces(self.max_depth)):
                state, traced, shadow = tracer.bounce(
                    scene, state, seed, pixel_id, sample_idx, bounce,
                    lod(bounce, n))
                n_rays = n_rays + traced.sum() + shadow.sum()
            return state[9:12].T, n_rays
        # the lanes' pixel ids, sample indices and original positions
        samp = torch.as_tensor(sample_idx, device=o.device).expand(n)
        ids = torch.stack([pixel_id.to(torch.int64), samp.to(torch.int64),
                           torch.arange(n, device=o.device)])
        for bounce in range(pass_bounces(self.max_depth)):
            m = gate_width(gates, state[12])
            new, traced, shadow, tri = tracer._bounce(
                scene, state[:, :m], seed, ids[0, :m], ids[1, :m], bounce,
                lod(bounce, m))
            n_rays = n_rays + traced.sum() + shadow.sum()
            perm = torch.argsort(lane_keys(new, tri, sort), stable=True)
            state = _splice(new.index_select(1, perm), state)
            ids = _splice(ids[:, :m].index_select(1, perm), ids)
        L = state[9:12].T
        return torch.zeros_like(L).index_copy(0, ids[2], L), n_rays

    def bounce(self, scene: SceneData, state, seed, pixel, samp, bounce: int,
               tex_lod=None):
        """One bounce of the wavefront (the plain version of the megakernel
        bounce, accel/megakernel.py): state [16, N] with rows o xyz, d
        xyz, throughput rgb, L rgb, active, prev_pdf, prev_delta,
        eta_scale; pixel [N] integer ids, samp an int or [N] sample
        indices, bounce the 0-based bounce index. Returns (new state
        [16, N], traced [N] bool: this lane traced a closest-hit ray,
        shadow [N] bool: it attempted a shadow ray, or traced one that
        was not occluded where count_attempted is False). Lanes inactive
        on entry come out unchanged. tex_lod: the lanes' uv footprint
        extents [N] for the textures' mip level, or None (level 0)."""
        return self._bounce(scene, state, seed, pixel, samp, bounce,
                            tex_lod)[:3]

    def _bounce(self, scene, state, seed, pixel, samp, bounce: int,
                tex_lod=None):
        """bounce, with the closest hits' triangle ids [N] (the coherence
        sort's key) as a fourth output."""
        if not self.settled:
            return self.specialized_for(scene, state.device)._bounce(
                scene, state, seed, pixel, samp, bounce, tex_lod)
        v = self._vertex(scene, state, seed, pixel, samp, bounce, tex_lod)
        if self.fused_shade == "on":
            self._check_fused(scene)
            # one kernel for the tail: NEE BSDF eval, shadow trace, MIS,
            # BSDF sampling, RR (the same RNG dims as _shade_eager); an
            # unbounded path passes the kernel's two depth guards with
            # this vertex's own depth as the bound
            from ..accel.shade_kernel import fused_shade
            new = fused_shade(scene, v.its, v.frame, v.mat, v.d,
                              v.throughput, v.L, v.ds, v.active, v.eta_scale,
                              seed, pixel, samp, bounce, self.rr_depth,
                              self.max_depth if self.max_depth > 0
                              else bounce + 2)
            counted = v.shadow
        else:
            new, unoccluded = self._shade_eager(scene, v, bounce + 2)
            counted = v.shadow if self.count_attempted else unoccluded
        return (torch.where(v.active, new, state), v.active, counted,
                v.its.tri_id)

    def shade_inputs(self, scene: SceneData, state, seed, pixel, samp,
                     bounce: int, tex_lod=None):
        """The fused shade kernel's packed input rows [K_IN, N] at this
        bounce of `state` (accel/shade_kernel.py pack_inputs), textures
        at the mip level of tex_lod as in `bounce`."""
        from ..accel.shade_kernel import pack_inputs
        v = self.specialized_for(scene, state.device)._vertex(
            scene, state, seed, pixel, samp, bounce, tex_lod)
        return pack_inputs(v.its, v.frame, v.mat, v.d, v.throughput, v.L,
                           v.ds, v.active, v.eta_scale)

    def _vertex(self, scene, state, seed, pixel, samp, bounce: int,
                tex_lod=None):
        """The bounce up to its shading tail: the closest hit, the
        environment and emitter-hit terms added to L, the material (its
        textures at the mip level of the extents tex_lod [N], or level 0
        where None), the shading frame and the NEE sample."""
        o = state[0:3].T.contiguous()
        d = state[3:6].T.contiguous()
        if self.fixed_rays:     # their gradient is 0 wherever it is taken
            o, d = o.detach(), d.detach()
        throughput = state[6:9].T.contiguous()
        L = state[9:12].T.contiguous()
        active = state[12] > 0.5
        prev_pdf, prev_delta = state[13], state[14] > 0.5
        d1 = lambda off: self._d1(seed, pixel, samp, bounce_dim(bounce, off))
        d2 = lambda off: self._d2(seed, pixel, samp, bounce_dim(bounce, off))

        its = self._intersect(scene, o, d, ray_mint(o), active)
        throughput, scatter, p_scatter = self._medium_event(
            o, d, its, throughput, active, d2)

        # ---- escaped rays: environment emitter -------------------------
        escaped = active & ~its.valid
        hit = active & its.valid
        event, p_event = hit, its.p
        if scatter is not None:     # a scatter comes before the surface
            escaped, hit = escaped & ~scatter, hit & ~scatter
            event = hit | scatter
            p_event = torch.where(scatter[:, None], p_scatter, its.p)
        w_env = torch.where(prev_delta, 1.0,
                            mis_power(prev_pdf, pdf_direct_env(scene, d)))
        hide = self.hide_emitters and bounce == 0
        if hide:
            w_env = torch.zeros_like(w_env)
        L = L + torch.where(escaped[:, None], throughput
                            * eval_env(scene, d) * w_env[:, None], 0.0)

        # ---- emitter hit on a surface ----------------------------------
        cos_surf = -dot(d, its.ng)          # > 0 ⇒ front side
        le = eval_area(scene, its.em_id, cos_surf)
        nee_pdf_hit = pdf_direct_area(scene, its.em_id, d, its.t, cos_surf)
        w_hit = torch.where(prev_delta, 1.0,
                            mis_power(prev_pdf, nee_pdf_hit))
        if hide:
            w_hit = torch.zeros_like(w_hit)
        L = L + torch.where(hit[:, None],
                            throughput * le * w_hit[:, None], 0.0)

        depth = bounce + 2      # path vertices: camera = 1, this hit
        mat = resolve_material(scene, its.mat_id, its.uv, self.families,
                               lod_extent=tex_lod)
        frame = perturb_shading_frame(
            scene, mat, Frame.from_normal(its.ns), its.uv)

        # ---- next-event estimation from the event point ----------------
        nee_allowed = event & (depth + 1 <= self.max_depth + 1) \
            if self.max_depth > 0 else event
        ds = sample_direct(scene, p_event, d1(DIM_NEE_SEL), d2(DIM_NEE_POS))
        return _Vertex(its, frame, mat, d, throughput, L, ds, active, event,
                       nee_allowed & (ds.pdf > 0), state[15], d1, d2,
                       scatter, p_event)

    # ---- the medium's hooks: no medium here (VolPathTracer) -------------
    def _medium_event(self, o, d, its, throughput, active, d2):
        """A scatter in the medium before the closest hit: (throughput
        with the segment's weight, scatter [N] bool or None, the scatter
        point [N, 3])."""
        return throughput, None, None

    def _medium_nee(self, v: "_Vertex", f_nee, pdf_nee, so):
        """NEE's (f [N, 3], pdf [N], shadow origin [N, 3]) with the
        scattering lanes' phase function and scatter point."""
        return f_nee, pdf_nee, so

    def _medium_nee_weight(self, v: "_Vertex", nee):
        """NEE's contribution [N, 3] attenuated by the medium."""
        return nee

    def _medium_continue(self, v: "_Vertex", d_next, o_next, bs):
        """The continuation (d_next, o_next, bs) with the scattering
        lanes' phase sample."""
        return d_next, o_next, bs

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
        trace, MIS, BSDF sampling and Russian roulette. Returns (the new
        state rows [16, N], the lanes whose NEE ray was traced and not
        occluded [N] bool)."""
        its, frame, d, throughput, L, ds, shadow, eta_scale = (
            v.its, v.frame, v.d, v.throughput, v.L, v.ds, v.shadow,
            v.eta_scale)
        d1, d2 = v.d1, v.d2
        wi_local = Frame.to_local(frame, -d)
        wo_nee = Frame.to_local(frame, ds.d)
        f_nee, pdf_nee = self._bsdf_eval(v, wi_local, wo_nee)
        # shadow ray over [ε, dist·(1-ShadowEpsilon)] (scene.cpp:846)
        so = offset_ray_origin(its.p, its.ng, ds.d)
        f_nee, pdf_nee, so = self._medium_nee(v, f_nee, pdf_nee, so)
        contributes = shadow & (f_nee > 0).any(-1)
        occluded = self._occluded(
            scene, so, ds.d, ray_mint(so),
            ds.dist * (1.0 - SHADOW_EPSILON), contributes)
        contributes = contributes & ~occluded
        w_nee = torch.where(ds.is_delta, 1.0, mis_power(ds.pdf, pdf_nee))
        nee = self._medium_nee_weight(v, throughput * ds.value * f_nee)
        L = L + torch.where(contributes[:, None], nee * w_nee[:, None], 0.0)

        # ---- BSDF sampling → next ray ----------------------------------
        bs = self._bsdf_sample(v, wi_local, d2(DIM_BSDF_U2), d1(DIM_BSDF_U1))
        d_next = Frame.to_world(frame, bs.wo)
        o_next = offset_ray_origin(its.p, its.ng, d_next)
        d_next, o_next, bs = self._medium_continue(v, d_next, o_next, bs)
        throughput_next = throughput * bs.weight
        alive = v.event & (bs.pdf > 0) & (throughput_next > 0).any(-1)
        if self.max_depth > 0:
            alive = alive & (depth <= self.max_depth)

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
                         bs.is_delta.to(d.dtype), eta_scale])]), contributes


def gate_width(gates, active):
    """The narrowest width of `gates` (decreasing, gates[0] = N) that
    holds every live lane of the active row [N] (a host read), as the
    JAX lax.switch picks it; N, without a read, where there is no gate.
    The live lanes are a prefix: the last bounce's partition packed
    them."""
    if len(gates) == 1:
        return gates[0]
    live = int((active > 0.5).sum())
    return min(g for g in gates if g >= live)


def lane_keys(state, tri, sort: bool):
    """Each lane's key [N] int64 for the stable argsort that compacts the
    state [16, N]: 0 live, 1 dead; or (sort) the hit triangle's cluster
    (tri [N] // TRIS_PER_CLUSTER) shifted left 3, OR the octant of the
    next direction, and _DEAD_KEY for a dead lane (JAX path.py:306-328)."""
    alive = state[12] > 0.5
    if not sort:
        return (~alive).to(torch.int64)
    neg = (state[3:6] < 0).to(torch.int64)
    octant = neg[0] * 4 + neg[1] * 2 + neg[2]
    key = (tri.to(torch.int64) // trace.TRIS_PER_CLUSTER) << 3 | octant
    return torch.where(alive, key, _DEAD_KEY)


def _splice(head, whole):
    """whole [K, N] with its first head.shape[1] columns replaced by
    head (the gate's prefix; the tail rides through)."""
    m = head.shape[1]
    return head if m == whole.shape[1] else torch.cat([head, whole[:, m:]],
                                                      1)


def initial_state(o, d):
    """[16, N] state of fresh camera paths along rays o, d [N, 3]: unit
    throughput, zero radiance, active, prev_pdf 1, prev_delta 1, eta 1."""
    n = o.shape[0]
    return torch.cat([o.T, d.T, torch.ones((3, n), dtype=o.dtype,
                                           device=o.device),
                      torch.zeros((3, n), dtype=o.dtype, device=o.device),
                      torch.ones((4, n), dtype=o.dtype, device=o.device)])
