"""Adaptive sampling: per-pixel sample allocation by a confidence test
(port of mitsuba_tpu/integrator/adaptive.py; ref: src/integrators/misc/
adaptive.cpp).

Every pass keeps one lane a pixel and re-aims the lanes: the pixels not
yet converged come first under a stable argsort of the converged flag,
and the lanes go round-robin over them, so a converged pixel gives its
lane to one that is not. Each lane then draws batch_spp samples at sample
index samp · batch_spp + k, where samp is its pixel's count before the
pass plus the lane's repeat, and the per-pixel RGB sum, count, Σlum and
Σlum² grow by scatter-adds (index_add_: on the card with atomics, whose
order changes from run to run, so images there agree with the CPU's only
to rounding). A pixel has converged once it has two batches and
stderr · t ≤ max_error · mean of its luminance, with the normal quantile
of p_value for t (_QUANTILES, 1.96 for values not in it)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..core import rng
from ..device import check_scene_device
from ..film.film import Film
from ..scene.scene import SceneData
from .common import DIM_PIXEL

# two-sided normal quantiles of the common p-values (adaptive.cpp's
# default quality 0.05: 95% confidence)
_QUANTILES = {0.2: 1.2816, 0.1: 1.6449, 0.05: 1.9600, 0.01: 2.5758}


@dataclass(frozen=True)
class AdaptiveSampler:
    """maxError, pValue and the batch and pass counts (at most
    batch_spp · max_passes samples a pixel). child: the radiance
    estimator the scene file nests (None: PathTracer()), used by
    render_full."""
    max_error: float = 0.05
    p_value: float = 0.05
    batch_spp: int = 16
    max_passes: int = 8
    child: object = None

    def render(self, scene: SceneData, camera, film: Film, integrator,
               seed: int = 0, device="cuda"):
        """The developed [H, W, 3] image of `integrator`'s li_stats under
        adaptive allocation, on `device` (the scene's)."""
        return self.render_with_counts(scene, camera, film, integrator,
                                       seed, device)[0]

    def render_full(self, scene: SceneData, camera, film: Film, spp: int,
                    seed: int = 0, device="cuda"):
        """The CLI's entry: spp is the most samples a pixel, so
        max(1, spp // batch_spp) passes of the child."""
        from .path import PathTracer
        child = self.child if self.child is not None else PathTracer()
        if hasattr(child, "specialized_for"):
            child = child.specialized_for(scene)
        cfg = dataclasses.replace(
            self, max_passes=max(1, spp // self.batch_spp), child=None)
        return cfg.render(scene, camera, film, child, seed, device)

    def render_with_counts(self, scene, camera, film, integrator,
                           seed: int = 0, device="cuda"):
        """(image [H, W, 3], samples taken a pixel [H, W] float32)."""
        check_scene_device(scene, device)
        h, w = film.height, film.width
        n = h * w
        lane = torch.arange(n, dtype=torch.int64, device=scene.device)
        quantile = _QUANTILES.get(self.p_value, 1.96)
        rgb = torch.zeros((n, 3), device=scene.device)
        count = torch.zeros((n,), device=scene.device)
        mean = torch.zeros((n,), device=scene.device)
        m2 = torch.zeros((n,), device=scene.device)
        for _ in range(self.max_passes):
            var = m2 / torch.clamp(count - 1.0, min=1.0)
            stderr = torch.sqrt(var / torch.clamp(count, min=1.0)) * quantile
            conv = ((stderr <= self.max_error * torch.clamp(mean, min=1e-4))
                    & (count >= 2 * self.batch_spp))
            n_unconv = torch.clamp((~conv).sum(), min=1)
            order = torch.argsort(conv.to(torch.int32), stable=True)
            pix = order[lane % n_unconv]
            repeat = lane // n_unconv
            samp = count[pix].to(torch.int64) + repeat
            # Σlum and Σlum² through the pass, then back to (mean, M2)
            sum_l = mean * count
            sum_l2 = m2 + count * mean * mean
            for k in range(self.batch_spp):
                s = samp * self.batch_spp + k
                jitter = rng.sample_2d(seed, pix, DIM_PIXEL, s)
                pos = torch.stack(
                    [(pix % w).to(torch.float32) + jitter[:, 0],
                     (pix // w).to(torch.float32) + jitter[:, 1]], dim=-1)
                o, d = camera.sample_ray(pos)
                L = integrator.li_stats(scene, o, d, seed, pix, s)[0]
                lum = (0.212671 * L[:, 0] + 0.715160 * L[:, 1]
                       + 0.072169 * L[:, 2])
                rgb.index_add_(0, pix, L)
                count.index_add_(0, pix, torch.ones_like(lum))
                sum_l.index_add_(0, pix, lum)
                sum_l2.index_add_(0, pix, lum * lum)
            mean = sum_l / torch.clamp(count, min=1.0)
            m2 = torch.clamp(sum_l2 - count * mean * mean, min=0.0)
        img = (rgb / torch.clamp(count, min=1.0)[:, None]).reshape(h, w, 3)
        return img, count.reshape(h, w)
