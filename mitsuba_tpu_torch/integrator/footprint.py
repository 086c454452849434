"""Ray-differential footprints and LoD path tracing (port of
mitsuba_tpu/integrator/footprint.py).

Camera ray differentials are carried to the first hit (Igehy 1999) and
expressed as uv derivative vectors through the hit triangle's edges and
corner uvs:

  * first_hit_footprint: per-pixel (duv/dx, duv/dy) at the primary hit;
  * FootprintIntegrator: the AOV of log2 footprint extent (the
    reference's `footprint` plugin);
  * LoDPathTracer: a PathTracer whose first-hit texture lookups use the
    mip level of the pixel's footprint (li_stats(tex_lod=...)); later
    bounces look up level 0, as the base tracer does.

The traces are PathTracer's: the trace kernel on CUDA tensors, the plain
intersector on CPU tensors; LoDPathTracer's shading tail is PathTracer's
too (eager, or the fused shade kernel on the texture-resolved rows)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import rng
from ..core.math import dot
from ..device import check_scene_device
from ..scene.scene import SceneData
from .common import DIM_PIXEL, ray_mint
from .path import PathTracer


def _pixel_centres(px, w):
    return torch.stack([(px % w).to(torch.float32) + 0.5,
                        (px // w).to(torch.float32) + 0.5], dim=-1)


def first_hit_footprint(scene: SceneData, camera, pixel_xy, integ=None):
    """(Intersection, duv_dx [N, 2], duv_dy [N, 2]) of the primary rays
    through pixel_xy [N, 2], the camera sampled with no aperture. The
    Igehy transfer dp = t·dd − d·(dd·n)·t/(d·n), then dp solved in the
    triangle's (e1, e2) basis by its 2×2 Gram system, mapped to uv by
    the corner uv differences. A miss's values are not meaningful (the
    callers mask them)."""
    pt = integ or PathTracer()
    dev = pixel_xy.device
    o, d = camera.sample_ray(pixel_xy)
    _, dxd = camera.sample_ray(
        pixel_xy + torch.tensor([1.0, 0.0], device=dev))
    _, dyd = camera.sample_ray(
        pixel_xy + torch.tensor([0.0, 1.0], device=dev))
    dd_dx = dxd - d                 # pinhole: do/dx = 0
    dd_dy = dyd - d

    everyone = torch.ones_like(o[:, 0], dtype=torch.bool)
    its = pt._intersect(scene, o, d, ray_mint(o), everyone)
    t = torch.where(its.valid, its.t, 1.0)
    n = its.ng
    dn = torch.clamp(torch.abs(dot(d, n)), min=1e-6) * torch.sign(dot(d, n))

    def transfer(dd):
        dt = -(dot(dd, n) * t) / dn
        return dd * t[:, None] + d * dt[:, None]

    tri = torch.clamp(its.tri_id, min=0).long()
    e1 = scene.e1[tri]
    e2 = scene.e2[tri]
    uv0 = scene.vuv[tri, 0]
    duv1 = scene.vuv[tri, 1] - uv0
    duv2 = scene.vuv[tri, 2] - uv0
    g11 = dot(e1, e1)
    g12 = dot(e1, e2)
    g22 = dot(e2, e2)
    det = torch.clamp(g11 * g22 - g12 * g12, min=1e-18)

    def solve(dp):
        b1 = dot(dp, e1)
        b2 = dot(dp, e2)
        a = (g22 * b1 - g12 * b2) / det
        b = (g11 * b2 - g12 * b1) / det
        return a[:, None] * duv1 + b[:, None] * duv2

    return its, solve(transfer(dd_dx)), solve(transfer(dd_dy))


def footprint_extent(duv_dx, duv_dy):
    """The footprint's extent [N]: the longer derivative vector's norm."""
    return torch.maximum(torch.linalg.vector_norm(duv_dx, dim=-1),
                         torch.linalg.vector_norm(duv_dy, dim=-1))


@dataclass(frozen=True)
class FootprintIntegrator(PathTracer):
    """The AOV of log2 of the primary hit's uv footprint extent, 0 on a
    miss. A pixel-space quantity: render() only, one ray per pixel
    centre."""

    def li_stats(self, *args, **kwargs):
        raise NotImplementedError("use render(); footprints are "
                                  "pixel-space quantities")

    def render(self, scene: SceneData, camera, film, spp: int = 1,
               seed: int = 0, device="cuda"):
        """[H, W, 3] image, every channel the pixel's log2 extent (spp and
        seed unused), on `device` (the scene's)."""
        check_scene_device(scene, device)
        h, w = film.height, film.width
        px = torch.arange(h * w, dtype=torch.int64, device=scene.device)
        its, duv_dx, duv_dy = first_hit_footprint(
            scene, camera, _pixel_centres(px, w), self)
        ext = footprint_extent(duv_dx, duv_dy)
        val = torch.where(its.valid,
                          torch.log2(torch.clamp(ext, min=1e-12)), 0.0)
        return val[:, None].expand(h * w, 3).reshape(h, w, 3)


@dataclass(frozen=True)
class LoDPathTracer(PathTracer):
    """The reference's path_lod: primary-hit texture lookups at the mip
    level of the pixel's uv footprint (so minified textures are
    prefiltered, not point-sampled); later bounces at level 0."""

    def render_lod(self, scene: SceneData, camera, film, spp: int = 8,
                   seed: int = 0, device="cuda"):
        """Render with footprint-driven primary-hit texture LoD; returns
        the developed [H, W, 3] image on `device` (the scene's: the GPU
        unless the caller compiled it and passes device="cpu"). The
        footprints come from the pixel centres; each pass jitters its
        rays by rng.sample_2d(seed, px, DIM_PIXEL, s) with no aperture,
        as the JAX render_lod does."""
        return self.render_lod_stats(scene, camera, film, spp, seed,
                                     device)[0]

    def render_lod_stats(self, scene: SceneData, camera, film,
                         spp: int = 8, seed: int = 0, device="cuda"):
        """render_lod, with the traced-ray count (li_stats's count summed
        over the passes, a 0-d int64 tensor) as a second output."""
        check_scene_device(scene, device)
        tracer = self.specialized_for(scene)
        h, w = film.height, film.width
        px = torch.arange(h * w, dtype=torch.int64, device=scene.device)
        _, duv_dx, duv_dy = first_hit_footprint(
            scene, camera, _pixel_centres(px, w), tracer)
        ext = footprint_extent(duv_dx, duv_dy)
        accum = film.new_accumulator(scene.device)
        n_rays = torch.zeros((), dtype=torch.int64, device=scene.device)
        for s in range(spp):
            jitter = rng.sample_2d(seed, px, DIM_PIXEL, s)
            pos = torch.stack([(px % w).to(torch.float32) + jitter[:, 0],
                               (px // w).to(torch.float32) + jitter[:, 1]],
                              dim=-1)
            o, d = camera.sample_ray(pos)
            li, rays = tracer.li_stats(scene, o, d, seed, px, s,
                                       tex_lod=ext)
            film.splat(accum, pos, li)
            n_rays = n_rays + rays
        return film.develop(accum), n_rays
