"""Film: box-filter sample splatting, accumulation and develop (port of
mitsuba_tpu/film/film.py). The accumulator is [H, W, 4]: RGB sums plus the
filter-weight sum. NaN/Inf samples are rejected, not propagated."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import rfilter


@dataclass(frozen=True)
class Film:
    width: int = 256
    height: int = 256
    filter_name: str = "box"

    def __post_init__(self):
        if rfilter.NAMES[self.filter_name] != rfilter.BOX:
            raise NotImplementedError(
                f"filter {self.filter_name!r}: the port has only 'box'")

    def new_accumulator(self, device):
        return torch.zeros((self.height, self.width, 4), device=device)

    def splat(self, accum, pos, value):
        """Add samples at continuous pixel coords pos [N, 2] with radiance
        value [N, 3] into accum, in place; returns accum.

        On the CPU the scatter-add runs in sample order and is
        deterministic. On CUDA it uses atomics, whose order changes from
        run to run, so sums there agree with the CPU's only to rounding:
        images from the card are compared statistically."""
        finite = (torch.isfinite(value).all(dim=-1)
                  & torch.isfinite(pos).all(dim=-1))
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

    def develop(self, accum):
        """Weighted average → [H, W, 3] radiance image."""
        w = accum[..., 3:4]
        return torch.where(w > 0, accum[..., 0:3] / torch.clamp(w, min=1e-20),
                           0.0)
