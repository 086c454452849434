"""Multi-channel integrator: several integrators over the same samples
(port of mitsuba_tpu/integrator/multichannel.py; ref: src/integrators/
misc/multichannel.cpp).

One camera ray a pixel and pass feeds every child's li_stats, and each
child's result is splatted into a film accumulator of its own, so every
channel group equals its child rendered alone with the same seed. As in
the reference, AOV channels get no negative or NaN screening beyond the
film's."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import check_scene_device
from ..film.film import Film
from ..render import sample_camera
from ..scene.scene import SceneData
from .path import PathTracer


@dataclass(frozen=True)
class MultiChannelIntegrator(PathTracer):
    """children: integrators with li_stats; names: each child's channel
    group name in the EXR (default ch0, ch1, ...). The pixel jitter is
    drawn with this integrator's own sampler, as the JAX render does."""
    children: tuple = ()
    names: tuple = ()

    def channel_names(self):
        """The EXR channel names, <group>.R/G/B for each child."""
        names = self.names or tuple(
            f"ch{i}" for i in range(len(self.children)))
        return [f"{name}.{c}" for name in names for c in "RGB"]

    def specialized_for(self, scene: SceneData, device=None):
        """This integrator with every child that has specialized_for
        settled for the scene (the parent's own path fields are unused)."""
        kids = tuple(c.specialized_for(scene, device)
                     if hasattr(c, "specialized_for") else c
                     for c in self.children)
        return MultiChannelIntegrator(children=kids, names=self.names,
                                      sampler=self.sampler, spp=self.spp)

    def li_stats(self, scene: SceneData, o, d, seed, pixel_id,
                 sample_idx=0):
        """(the children's radiance concatenated [N, 3·k], the children's
        traced rays summed, a 0-d int64 tensor)."""
        outs, n_rays = [], torch.zeros((), dtype=torch.int64,
                                       device=o.device)
        for c in self.children:
            L, rays = c.li_stats(scene, o, d, seed, pixel_id, sample_idx)
            outs.append(L)
            n_rays = n_rays + rays
        return torch.cat(outs, dim=-1), n_rays

    def render(self, scene: SceneData, camera, film: Film, spp: int = 16,
               seed: int = 0, device="cuda"):
        """[H, W, 3·k]: one RGB group a child, on `device` (the scene's)."""
        return self.render_stats(scene, camera, film, spp, seed, device)[0]

    def render_stats(self, scene: SceneData, camera, film: Film,
                     spp: int = 16, seed: int = 0, device="cuda"):
        """render, with the children's traced rays summed over the passes
        (a 0-d int64 tensor) as a second output."""
        check_scene_device(scene, device)
        integ = self.specialized_for(scene)
        h, w = film.height, film.width
        px = torch.arange(h * w, dtype=torch.int64, device=scene.device)
        accums = [film.new_accumulator(scene.device) for _ in self.children]
        n_rays = torch.zeros((), dtype=torch.int64, device=scene.device)
        for s in range(spp):
            pos, o, d = sample_camera(camera, w, seed, px, s, self.sampler,
                                      self.spp)
            for acc, child in zip(accums, integ.children):
                L, rays = child.li_stats(scene, o, d, seed, px, s)
                film.splat(acc, pos, L)
                n_rays = n_rays + rays
        return torch.cat([film.develop(a) for a in accums], dim=-1), n_rays


def write_multichannel_exr(path: str, img, names, **exr):
    """Write an [H, W, C] image with its channel names (hdrfilm's
    channelNames) and the other keyword arguments of io/image.py
    write_exr (annotations, compression, pixel_type)."""
    from ..io.image import write_exr
    if torch.is_tensor(img):
        img = img.detach().cpu().numpy()
    write_exr(path, np.asarray(img, np.float32), channel_names=list(names),
              **exr)
