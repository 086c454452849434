"""Homogeneous medium: closed-form Beer-Lambert sampling (port of
mitsuba_tpu/media/homogeneous.py).

The balance strategy of the reference (ref: src/medium/homogeneous.cpp
:157-223, :356-410): pick a spectral channel uniformly, sample
t ∝ σt_c e^{-σt_c t}, and average the per-channel pdfs:

    pdfSuccess(t)  = (1/3) Σ_c σt_c e^{-σt_c t}
    pdfFailure(ts) = (1/3) Σ_c e^{-σt_c ts}

A medium interaction happens when the sampled t lands before the surface;
the returned weights already hold transmittance / pdf, so the caller
multiplies the throughput by them (w_medium carries σs).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class MediumSample(NamedTuple):
    """The wavefront's MediumSamplingRecord (ref: medium.h:38)."""
    sampled: torch.Tensor    # [N] bool: a medium event before the surface
    t: torch.Tensor          # [N] sampled medium distance
    w_medium: torch.Tensor   # [N, 3] σs·Tr(t)/pdfSuccess (medium lanes)
    w_surface: torch.Tensor  # [N, 3] Tr(ts)/pdfFailure (surface lanes)


def sample_distance(sigma_t, albedo, u_channel, u_dist, t_surf,
                    bound=1e30) -> MediumSample:
    """sigma_t, albedo: [3] tensors; u_*: [N]; t_surf: [N] (the surface
    distance, huge for escaped rays).

    `bound` is the medium's extent along the ray: the global medium fills
    [0, bound] and vacuum lies beyond (the flat-array stand-in for the
    reference's shape-attached medium boundaries, medium.h:121). An
    escaped ray through the whole medium is attenuated by Tr(bound)."""
    sigma_s = sigma_t * albedo
    n_ch = sigma_t.shape[-1]
    ch = torch.clamp((u_channel * n_ch).to(torch.int64), max=n_ch - 1)
    sig_c = torch.clamp(sigma_t[ch], min=1e-8)
    t = -torch.log1p(-torch.clamp(u_dist, 0.0, 1.0 - 1e-7)) / sig_c

    seg_end = torch.clamp(t_surf, max=bound)
    sampled = t < seg_end
    # clamped exponents: exp(-700) underflows f32 anyway; no inf·0
    tr_t = torch.exp(-torch.clamp(sigma_t * t[..., None], max=80.0))
    tr_s = torch.exp(-torch.clamp(sigma_t * seg_end[..., None], max=80.0))
    pdf_success = torch.mean(sigma_t * tr_t, dim=-1)
    pdf_failure = torch.mean(tr_s, dim=-1)

    w_medium = sigma_s * tr_t / torch.clamp(pdf_success, min=1e-20)[..., None]
    w_surface = tr_s / torch.clamp(pdf_failure, min=1e-20)[..., None]
    return MediumSample(sampled, t, w_medium, w_surface)


def transmittance(sigma_t, dist, bound=1e30):
    """Beer-Lambert Tr = e^{-σt min(d, bound)} (ref: homogeneous.cpp
    evalTransmittance, clipped to the medium extent)."""
    d_eff = torch.clamp(dist, max=bound)
    return torch.exp(-torch.clamp(sigma_t * d_eff[..., None], max=80.0))
