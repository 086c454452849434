"""Film: sample splatting, accumulation and develop (port of
mitsuba_tpu/film/film.py; ref: include/mitsuba/render/imageblock.h:40,
124-200, film.h:37). The accumulator is [H, W, 4]: RGB sums plus the
filter-weight sum. The box filter splats each sample into its own pixel;
the other filters of film/rfilter.py walk the static K×K footprint with
one scatter-add each. NaN/Inf samples are rejected, not propagated
(imageblock.h:146-151)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import rfilter


@dataclass(frozen=True)
class Film:
    """hdrfilm analog (ref: src/films/hdrfilm.cpp). banner: stamp the
    corner banner at develop time; component_format: the EXR channel
    type, "float16" (OpenEXR's default) or "float32"; compression: the
    EXR chunk compression, zip/zips/none (io/image.py)."""
    width: int = 256
    height: int = 256
    filter_name: str = "box"
    banner: bool = False
    component_format: str = "float32"
    compression: str = "zip"

    def __post_init__(self):
        if self.filter_name not in rfilter.NAMES:
            raise ValueError(f"unknown reconstruction filter "
                             f"{self.filter_name!r}; known: "
                             f"{sorted(rfilter.NAMES)}")

    @property
    def ftype(self):
        return rfilter.NAMES[self.filter_name]

    @property
    def radius(self):
        return rfilter.RADIUS[self.ftype]

    def new_accumulator(self, device):
        return torch.zeros((self.height, self.width, 4), device=device)

    def splat(self, accum, pos, value):
        """Add samples at continuous pixel coords pos [N, 2] with radiance
        value [N, 3] into accum, in place; returns accum.

        On the CPU the scatter-adds run in sample order and are
        deterministic. On CUDA they use atomics, whose order changes from
        run to run, so sums there agree with the CPU's only to rounding:
        images from the card are compared statistically."""
        finite = (torch.isfinite(value).all(dim=-1)
                  & torch.isfinite(pos).all(dim=-1))
        if self.ftype == rfilter.BOX:
            px = torch.floor(torch.where(finite, pos[:, 0], -100.0)).long()
            py = torch.floor(torch.where(finite, pos[:, 1], -100.0)).long()
            inside = ((px >= 0) & (px < self.width) & (py >= 0)
                      & (py < self.height) & finite)
            px = px.clamp(0, self.width - 1)
            py = py.clamp(0, self.height - 1)
            contrib = torch.cat([torch.where(finite[:, None], value, 0.0),
                                 torch.ones_like(value[:, :1])], dim=-1)
            contrib = torch.where(inside[:, None], contrib, 0.0)
            return accum.index_put_((py, px), contrib, accumulate=True)

        # separable filter: the sample at continuous position p reaches
        # the pixels whose centres (ix + 0.5) lie within [p - r, p + r]
        # (imageblock.h:144), a static (K+1)² footprint
        value = torch.where(finite[:, None], value, 0.0)
        pos = torch.where(finite[:, None], pos, -100.0)
        r, ftype = self.radius, self.ftype
        k = int(2 * r + 0.9999)
        x0 = torch.floor(pos[:, 0] - r + 0.5).long()
        y0 = torch.floor(pos[:, 1] - r + 0.5).long()
        for dy in range(k + 1):
            iy = y0 + dy
            wy = rfilter.eval_filter(ftype, (iy.to(torch.float32) + 0.5)
                                     - pos[:, 1])
            for dx in range(k + 1):
                ix = x0 + dx
                wx = rfilter.eval_filter(ftype, (ix.to(torch.float32) + 0.5)
                                         - pos[:, 0])
                w = wx * wy
                inside = ((ix >= 0) & (ix < self.width) & (iy >= 0)
                          & (iy < self.height) & finite)
                w = torch.where(inside, w, 0.0)
                contrib = torch.cat([value * w[:, None], w[:, None]], -1)
                accum.index_put_((iy.clamp(0, self.height - 1),
                                  ix.clamp(0, self.width - 1)), contrib,
                                 accumulate=True)
        return accum

    def develop(self, accum):
        """Weighted average → [H, W, 3] radiance image
        (ref: hdrfilm.cpp:481-494)."""
        w = accum[..., 3:4]
        return torch.where(w > 0, accum[..., 0:3] / torch.clamp(w, min=1e-20),
                           0.0)
