"""Discrete 1D distribution (port of mitsuba_tpu/core/distribution.py
Discrete1D): CDF built on the host in float64, sampled on the device."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Discrete1D(NamedTuple):
    """Normalized CDF table: cdf[k] = P(X < k), K+1 entries, cdf[K] = 1."""
    pmf: torch.Tensor        # [K]
    cdf: torch.Tensor        # [K+1]
    total: torch.Tensor      # scalar, unnormalized sum

    @staticmethod
    def build(weights: np.ndarray, device="cpu") -> "Discrete1D":
        w = np.maximum(np.asarray(weights, np.float64).reshape(-1), 0.0)
        total = w.sum()
        if total <= 0:
            w = np.ones_like(w)
            pmf = w / w.sum()
        else:
            pmf = w / total
        cdf = np.concatenate([[0.0], np.cumsum(pmf)])
        cdf[-1] = 1.0
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                        device=device)
        return Discrete1D(f32(pmf), f32(cdf), f32(total))

    def sample(self, u):
        """u ∈ [0,1) → index."""
        idx = torch.searchsorted(self.cdf, u, right=True) - 1
        return torch.clamp(idx, 0, self.pmf.shape[0] - 1)

    def sample_reuse(self, u):
        """Index plus u rescaled to [0,1) within the chosen bin, and the
        bin's probability (ref pmf.h sampleReuse)."""
        idx = self.sample(u)
        lo = self.cdf[idx]
        p = torch.clamp(self.pmf[idx], min=1e-20)
        u_re = torch.clamp((u - lo) / p, 0.0, 1.0 - 1e-7)
        return idx, u_re, self.pmf[idx]
