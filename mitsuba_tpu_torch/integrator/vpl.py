"""VPL renderer, instant radiosity (port of mitsuba_tpu/integrator/vpl.py;
ref: src/integrators/vpl/vpl.cpp, src/librender/vpl.cpp).

Particles walk from the area emitters (emitter.sample_emitter_ray) and
leave a virtual point light at their start and at every hit; the image is
lit by summing every VPL's contribution with a clamped geometry term.
Generation is one particle wavefront, a Python loop over bounces that
keeps every vertex. Shading takes the VPLs in chunks of K (K·N lanes at
most CHUNK_LANES): a chunk's K·N shadow rays go to the trace kernel in
one launch, and its contributions are added to L one VPL after another,
in the order of the JAX package's scan over VPLs, so the sum rounds as
the JAX one does.

Radiometry: a VPL stores radiant flux Φ. Emitter VPLs radiate diffusely
(I(ω) = Φ cosθ/π, vpl.cpp's area-light equivalence); surface VPLs
re-emit through their BSDF with the stored incoming direction:
    L += f_x(wi_cam, ω) · f_y(wi_y, -ω) · cosθ_y · cosθ_x / d² · Φ
with d² clamped below by (clamping · scene radius)², the bias knob of
vpl.cpp:44-48.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..bsdf.bsdf import (MatInfo, eval_bsdf_ex, perturb_shading_frame,
                         resolve_material, sample_bsdf_ex)
from ..core import rng
from ..core.math import SHADOW_EPSILON, Frame, dot
from ..device import check_scene_device
from ..emitter.emitter import eval_area, eval_env, sample_emitter_ray
from ..scene.scene import SceneData
from .common import (DIM_BSDF_U1, DIM_BSDF_U2, DIM_NEE_POS, DIM_NEE_SEL,
                     DIM_PIXEL, bounce_dim, offset_ray_origin, ray_mint,
                     tile_lanes)
from .path import PathTracer

_VPL_DIM_BASE = 1 << 18     # RNG dims of the generation walk
CHUNK_LANES = 1 << 20       # shadow rays of one chunk (one trace launch)


class VPLs(NamedTuple):
    """Flat VPL table: [NV] records (NV = n_paths · (1 + walk length)),
    the emitter VPLs first, then each bounce's."""
    p: torch.Tensor          # [NV, 3] position
    n: torch.Tensor          # [NV, 3] shading normal
    wi: torch.Tensor         # [NV, 3] incoming direction (toward source)
    flux: torch.Tensor       # [NV, 3] radiant flux Φ (already / n_paths)
    mat_id: torch.Tensor     # [NV] surface material (-1: emitter VPL)
    uv: torch.Tensor         # [NV, 2]
    valid: torch.Tensor      # [NV] bool


class Shading(NamedTuple):
    """The camera rays' first hits, shaded as the VPL sum needs them."""
    its: object              # Intersection
    mat: MatInfo
    frame: tuple             # perturbed shading frame
    wi_local: torch.Tensor   # [N, 3]
    L: torch.Tensor          # [N, 3] emitted (or environment) radiance
    min_d2: torch.Tensor     # 0-d: the clamped squared distance


@dataclass(frozen=True)
class VPLIntegrator(PathTracer):
    """vpl.cpp's properties: shadowMapResolution has no counterpart (true
    shadow rays); clamping is the relative geometry-term distance clamp;
    n_paths the generation particles."""
    n_paths: int = 256
    clamping: float = 0.1

    # ---- phase 1: VPL generation (librender/vpl.cpp generateVPLs) -------
    def generate_vpls(self, scene: SceneData, seed: int = 0) -> VPLs:
        """The VPL table of n_paths particles keyed (seed, particle)."""
        return self.specialized_for(scene)._generate(scene, seed)[0]

    def _generate(self, scene, seed):
        """(VPLs, the walk's traced rays as a 0-d int64 tensor)."""
        n = self.n_paths
        dev = scene.device
        pid = torch.arange(n, dtype=torch.int64, device=dev)
        dim = _VPL_DIM_BASE
        # the emitter start vertex (area emitters; point and directional
        # luminaire VPLs, vpl.cpp:70-110, are not generated)
        er = sample_emitter_ray(
            scene, rng.sample_1d(seed, pid, dim + bounce_dim(0, DIM_NEE_SEL)),
            rng.sample_2d(seed, pid, dim + bounce_dim(0, DIM_NEE_POS)),
            rng.sample_2d(seed, pid, dim + bounce_dim(0, DIM_BSDF_U2)))
        # path power Φ = Le·π·A/pmf, amortised over n_paths
        flux0 = er.le * (math.pi * er.area / torch.clamp(er.pmf, min=1e-12)
                         )[:, None] / n
        flux0 = torch.where(er.is_area[:, None], flux0, 0.0)
        fields = [(er.p, er.n, er.n, flux0,
                   torch.full((n,), -1, dtype=torch.int64, device=dev),
                   torch.zeros((n, 2), device=dev), er.is_area)]

        # the walk: cosine emission, power throughput stays Φ. max_depth
        # counts path edges: an emitter VPL lights camera→x→light (2
        # edges), a surface VPL after k light segments 2+k edges
        o, d = offset_ray_origin(er.p, er.n, er.d), er.d
        alpha, active = flux0, er.is_area
        n_rays = torch.zeros((), dtype=torch.int64, device=dev)
        n_surf = max((self.max_depth - 2) if self.max_depth > 0 else 6, 0)
        for bounce in range(n_surf):
            its = self._intersect(scene, o, d, ray_mint(o), active)
            n_rays = n_rays + active.sum()
            hit = active & its.valid
            mat = resolve_material(scene, its.mat_id, its.uv, self.families)
            frame = perturb_shading_frame(scene, mat,
                                          Frame.from_normal(its.ns), its.uv)
            wi_local = Frame.to_local(frame, -d)
            fields.append((its.p, its.ns, -d,
                           torch.where(hit[:, None], alpha, 0.0),
                           torch.where(hit, its.mat_id, -1), its.uv, hit))
            u2 = rng.sample_2d(seed, pid,
                               dim + bounce_dim(bounce + 1, DIM_BSDF_U2))
            u1 = rng.sample_1d(seed, pid,
                               dim + bounce_dim(bounce + 1, DIM_BSDF_U1))
            bs = sample_bsdf_ex(mat, wi_local, u2, u1, self.families)
            d_next = Frame.to_world(frame, bs.wo)
            o = offset_ray_origin(its.p, its.ng, d_next)
            alpha_next = alpha * bs.weight
            alive = hit & (bs.pdf > 0) & (alpha_next > 0).any(-1)
            d = torch.where(alive[:, None], d_next, d)
            alpha = torch.where(alive[:, None], alpha_next, 0.0)
            active = alive
        return VPLs(*(torch.cat([f[i] for f in fields])
                      for i in range(7))), n_rays

    # ---- phase 2: shading (vpl.cpp's render loop) ------------------------
    def _shading(self, scene, o, d) -> Shading:
        """The first hits of the camera rays: directly visible emission
        (exact), the material and frame, and the geometry clamp (relative
        to the scene extent; the padding triangles have zero area)."""
        its = self._intersect(scene, o, d, ray_mint(o),
                              torch.ones_like(o[:, 0], dtype=torch.bool))
        le = eval_area(scene, its.em_id, -dot(d, its.ng))
        L = torch.where(its.valid[:, None], le, eval_env(scene, d))
        mat = resolve_material(scene, its.mat_id, its.uv, self.families)
        frame = perturb_shading_frame(scene, mat, Frame.from_normal(its.ns),
                                      its.uv)
        radius = torch.amax(torch.where((scene.tri_area > 0)[:, None],
                                        torch.abs(scene.p0), 0.0))
        return Shading(its, mat, frame, Frame.to_local(frame, -d), L,
                       (self.clamping * radius) ** 2)

    def _lights(self, scene, sh: Shading, yp, yn, ywi, yflux, ymat, yuv,
                ok0, cos_x_test: bool):
        """The contributions [K, N, 3] of K lights at every shading point
        and whether each counts [K, N] (bool; unoccluded), from the
        lights' records [K, N, ...] (ymat < 0: a diffuse emitter light);
        the K·N shadow rays go in one _occluded call. Returns (contrib,
        ok, the shadow rays attempted as a 0-d tensor)."""
        k, n = ok0.shape
        flat = lambda x: x.reshape(k * n, *x.shape[2:])
        yp, yn, ywi, yflux, ymat, yuv, ok0 = (
            flat(x) for x in (yp, yn, ywi, yflux, ymat, yuv, ok0))
        its = sh.its
        p, ns, ng = tile_lanes(its.p, k), tile_lanes(its.ns, k), tile_lanes(its.ng, k)
        v = yp - p
        d2 = torch.sum(v * v, dim=-1)
        dist = torch.sqrt(torch.clamp(d2, min=1e-20))
        w = v / dist[:, None]
        cos_y = -dot(w, yn)
        g = torch.clamp(cos_y, min=0.0) / torch.maximum(d2, sh.min_d2)
        # the light's BSDF (an emitter light: the diffuse 1/π kernel);
        # eval includes cosθ_y, which g holds already
        yfr = Frame.from_normal(yn)
        f_y_b = eval_bsdf_ex(
            resolve_material(scene, torch.clamp(ymat, min=0), yuv,
                             self.families),
            Frame.to_local(yfr, ywi), Frame.to_local(yfr, -w), self.families)
        f_y = torch.where((ymat < 0)[:, None], 1.0 / math.pi,
                          f_y_b / torch.clamp(cos_y, min=1e-6)[:, None])
        frame = tuple(tile_lanes(x, k) for x in sh.frame)
        f_x = eval_bsdf_ex(MatInfo(*(tile_lanes(x, k) for x in sh.mat)),
                           tile_lanes(sh.wi_local, k), Frame.to_local(frame, w),
                           self.families)
        contrib = f_x * f_y * (g[:, None] * yflux)
        ok = ok0 & tile_lanes(its.valid, k) & (cos_y > 1e-6) \
            & (contrib > 0).any(-1)
        if cos_x_test:
            ok = ok & (dot(w, ns) > 0)
        so = offset_ray_origin(p, ng, w)
        occ = self._occluded(scene, so, w, ray_mint(so),
                             dist * (1.0 - SHADOW_EPSILON), ok)
        return (contrib.reshape(k, n, 3), (ok & ~occ).reshape(k, n),
                ok.sum())

    def li_with_vpls(self, scene: SceneData, vpls: VPLs, o, d, seed,
                     pixel_id, sample_idx=0):
        """Radiance [N, 3] along the camera rays lit by the VPL table."""
        return self.specialized_for(scene, o.device)._li_with_vpls(
            scene, vpls, o, d)[0]

    def _li_with_vpls(self, scene, vpls, o, d):
        """(radiance, camera and shadow rays traced as a 0-d tensor)."""
        sh = self._shading(scene, o, d)
        L, n = sh.L, o.shape[0]
        n_rays = torch.as_tensor(n, device=o.device)
        nv = vpls.p.shape[0]
        step = max(1, CHUNK_LANES // max(n, 1))
        for j0 in range(0, nv, step):
            sl = slice(j0, min(nv, j0 + step))
            k = sl.stop - sl.start
            bc = lambda x: x[sl, None].expand(k, n, *x.shape[1:])
            contrib, ok, tried = self._lights(
                scene, sh, bc(vpls.p), bc(vpls.n), bc(vpls.wi),
                bc(vpls.flux), bc(vpls.mat_id), bc(vpls.uv), bc(vpls.valid),
                cos_x_test=True)
            n_rays = n_rays + tried
            for j in range(k):      # the JAX scan's order
                L = L + torch.where(ok[j, :, None], contrib[j], 0.0)
        return L, n_rays

    def li_stats(self, scene: SceneData, o, d, seed, pixel_id,
                 sample_idx=0):
        """One VPL set from `seed` (the JAX li's), then li_with_vpls:
        (radiance [N, 3], traced rays as a 0-d int64 tensor: the VPL
        walk's, one a camera ray and one an attempted shadow ray)."""
        tracer = self.specialized_for(scene, o.device)
        vpls, walk = tracer._generate(scene, seed)
        L, rays = tracer._li_with_vpls(scene, vpls, o, d)
        return L, (walk + rays).to(torch.int64)

    def render(self, scene: SceneData, camera, film, spp: int = 1,
               seed: int = 0, device="cuda"):
        """Full VPL render: one VPL set, spp camera samples (the JAX
        _render_vpl)."""
        check_scene_device(scene, device)
        tracer = self.specialized_for(scene)
        vpls = tracer.generate_vpls(scene, seed)
        return render_passes(scene, camera, film, spp, seed,
                             lambda o, d: tracer._li_with_vpls(
                                 scene, vpls, o, d)[0])


def render_passes(scene: SceneData, camera, film, spp: int, seed: int,
                  li):
    """The developed image of spp passes over every pixel of `film`, each
    pass's camera rays jittered by rng dims DIM_PIXEL at sample index s
    (no aperture draw) and shaded by li(o, d) -> [N, 3]: the JAX
    _render_vpl and _render_lightcuts loop."""
    h, w = film.height, film.width
    px = torch.arange(h * w, dtype=torch.int64, device=scene.device)
    accum = film.new_accumulator(scene.device)
    for s in range(spp):
        jitter = rng.sample_2d(seed, px, DIM_PIXEL, s)
        pos = torch.stack([(px % w).to(torch.float32) + jitter[:, 0],
                           (px // w).to(torch.float32) + jitter[:, 1]], -1)
        film.splat(accum, pos, li(*camera.sample_ray(pos)))
    return film.develop(accum)
