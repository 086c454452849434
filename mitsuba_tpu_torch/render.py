"""Render orchestration: the sampling loop over pixels × spp (port of
mitsuba_tpu/render.py). The whole film is one wavefront of H·W rays; a
Python loop over the spp sample passes splats each pass into the film."""
from __future__ import annotations

import torch

from .core import rng
from .device import resolve_device
from .film.film import Film
from .integrator.common import DIM_APERTURE, DIM_PIXEL
from .sampler.sampler import draw_2d
from .scene.scene import SceneData


def render_fn(scene: SceneData, camera, film: Film, integrator, spp: int,
              seed: int = 0, device="cuda"):
    """Render; returns (developed [H, W, 3] image, traced-ray count as a
    0-d int64 tensor). The sample index keys the RNG, so every (pixel,
    sample) pair draws the JAX package's sample stream."""
    dev = resolve_device(device)
    if scene.device.type != dev.type:
        raise ValueError(f"scene lives on {scene.device}, render asked "
                         f"for {dev}")
    h, w = film.height, film.width
    px = torch.arange(h * w, dtype=torch.int64, device=scene.device)
    pix_x = (px % w).to(torch.float32)
    pix_y = (px // w).to(torch.float32)
    accum = film.new_accumulator(scene.device)
    n_rays = torch.zeros((), dtype=torch.int64, device=scene.device)
    for s in range(spp):
        jitter = draw_2d(seed, px, s, DIM_PIXEL)
        pos = torch.stack([pix_x + jitter[:, 0], pix_y + jitter[:, 1]], -1)
        ap = rng.sample_2d(seed, px, DIM_APERTURE, s)
        o, d = camera.sample_ray(pos, ap)
        radiance, rays = integrator.li_stats(scene, o, d, seed, px, s)
        film.splat(accum, pos, radiance)
        n_rays = n_rays + rays
    return film.develop(accum), n_rays


def render(scene: SceneData, camera, film: Film, integrator, spp: int,
           seed: int = 0, device="cuda"):
    """Render and return the developed [H, W, 3] image, on `device` (the
    GPU unless the caller passes device="cpu")."""
    return render_fn(scene, camera, film, integrator, spp, seed, device)[0]
