"""Render orchestration: the sampling loop over pixels × spp (port of
mitsuba_tpu/render.py). The whole film is one wavefront of H·W rays; a
Python loop over the spp sample passes splats each pass into the film."""
from __future__ import annotations

import torch

from .core import rng
from .device import check_scene_device
from .film.film import Film
from .integrator.common import DIM_APERTURE, DIM_PIXEL
from .sampler.sampler import INDEPENDENT, draw_2d
from .scene.scene import SceneData


def sample_camera(camera, width: int, seed, px, s, sampler=INDEPENDENT,
                  spp: int = 0):
    """Camera rays of pixels px [N] (row-major ids in a film `width`
    wide) at sample index s, jittered within their pixels by the sampler
    `sampler` with `spp` strata (an integrator's fields; the aperture
    draw is independent, as in the JAX render): (continuous pixel
    positions [N, 2], o [N, 3], d [N, 3]). Every (pixel, sample) draws
    the JAX package's sample stream."""
    jitter = draw_2d(sampler, seed, px, s, spp, DIM_PIXEL)
    pos = torch.stack([(px % width).to(torch.float32) + jitter[:, 0],
                       (px // width).to(torch.float32) + jitter[:, 1]], -1)
    ap = rng.sample_2d(seed, px, DIM_APERTURE, s)
    return (pos, *camera.sample_ray(pos, ap))


def integrator_sampler(integrator):
    """(sampler kind, spp) an integrator draws its pixel jitter with:
    its `sampler` and `spp` fields, independent where it has none."""
    return (getattr(integrator, "sampler", INDEPENDENT),
            getattr(integrator, "spp", 0))


def render_fn(scene: SceneData, camera, film: Film, integrator, spp: int,
              seed: int = 0, device="cuda"):
    """Render; returns (developed [H, W, 3] image, traced-ray count as a
    0-d int64 tensor). The sample index keys the RNG, so every (pixel,
    sample) pair draws the JAX package's sample stream."""
    check_scene_device(scene, device)
    h, w = film.height, film.width
    px = torch.arange(h * w, dtype=torch.int64, device=scene.device)
    accum = film.new_accumulator(scene.device)
    n_rays = torch.zeros((), dtype=torch.int64, device=scene.device)
    specialize = getattr(integrator, "specialized_for", None)
    if specialize is not None:      # read the scene's families once
        integrator = specialize(scene)
    for s in range(spp):
        pos, o, d = sample_camera(camera, w, seed, px, s,
                                  *integrator_sampler(integrator))
        radiance, rays = integrator.li_stats(scene, o, d, seed, px, s)
        film.splat(accum, pos, radiance)
        n_rays = n_rays + rays
    return film.develop(accum), n_rays


def render(scene: SceneData, camera, film: Film, integrator, spp: int,
           seed: int = 0, device="cuda"):
    """Render and return the developed [H, W, 3] image, on `device` (the
    GPU unless the caller passes device="cpu")."""
    return render_fn(scene, camera, film, integrator, spp, seed, device)[0]
