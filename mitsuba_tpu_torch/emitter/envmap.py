"""Environment map emitter: a lat-long image, importance-sampled (port of
mitsuba_tpu/emitter/envmap.py).

The luminance×sinθ density over the image (ref: src/emitters/envmap.cpp:
99-106, 282, 567-601) gives a Walker alias table over its texels and a
marginal-row / conditional-column CDF pair, both built on the host in
float64 as the JAX package builds them. Sampling picks a texel from the
alias table (the CDF pair where a scene has no alias table) with the
leftover uniforms as the in-texel offset; the pdf divides out the sinθ
Jacobian of the mapping. Directions are y-up (envmap.cpp:595-600):

    d(u, v) = (sinθ sinφ, cosθ, -sinθ cosφ),  φ = u·2π, θ = v·π
"""
from __future__ import annotations

import math

import numpy as np
import torch

LUMINANCE = (0.212671, 0.715160, 0.072169)


def build_env_tables(img: np.ndarray) -> dict:
    """Host-side tables of a lat-long HDR image [H, W, 3]: env_img,
    env_row_cdf [H+1], env_col_cdf [H, W+1], env_density [H, W] (the pdf
    over the unit square) and env_alias [H·W, 2], as numpy arrays."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    lum = (img * np.array(LUMINANCE)).sum(-1)
    sin_theta = np.sin(np.pi * (np.arange(h) + 0.5) / h)
    dens = np.maximum(lum, 0.0) * sin_theta[:, None]
    total = dens.sum()
    if total <= 0:
        dens = np.ones_like(dens)
        total = dens.sum()
    row_w = dens.sum(1)
    row_cdf = np.concatenate([[0.0], np.cumsum(row_w / total)])
    row_cdf[-1] = 1.0
    col_pmf = dens / np.maximum(row_w[:, None], 1e-300)
    col_cdf = np.concatenate([np.zeros((h, 1)), np.cumsum(col_pmf, 1)], 1)
    col_cdf[:, -1] = 1.0
    return {
        "env_img": img,
        "env_row_cdf": row_cdf.astype(np.float32),
        "env_col_cdf": col_cdf.astype(np.float32),
        "env_density": (dens / total * (h * w)).astype(np.float32),
        "env_alias": build_alias_table(dens.reshape(-1) / total),
    }


def build_alias_table(pmf: np.ndarray) -> np.ndarray:
    """Walker alias table of a discrete pmf → [K, 2] float32 (accept
    probability, alias index). k = floor(u·K) is taken if u' < prob[k],
    else alias[k]."""
    pmf = np.asarray(pmf, np.float64)
    k = len(pmf)
    scaled = pmf * k / max(pmf.sum(), 1e-300)
    prob = np.ones(k)
    alias = np.arange(k)
    small = [i for i in range(k) if scaled[i] < 1.0]
    large = [i for i in range(k) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        g = large.pop()
        prob[s] = scaled[s]
        alias[s] = g
        scaled[g] = scaled[g] - (1.0 - scaled[s])
        (small if scaled[g] < 1.0 else large).append(g)
    out = np.empty((k, 2), np.float32)
    out[:, 0] = prob
    out[:, 1] = alias.astype(np.float32)
    return out


def has_envmap(scene) -> bool:
    """Whether the scene carries an environment image (its tables are
    more than the 1×1 placeholder, or it has an alias table)."""
    return scene.env_alias is not None or scene.env_density.numel() > 1


def _uv_to_dir(u, v):
    phi = u * (2.0 * math.pi)
    theta = v * math.pi
    st = torch.sin(theta)
    return torch.stack([st * torch.sin(phi), torch.cos(theta),
                        -st * torch.cos(phi)], dim=-1)


def _dir_to_uv(d):
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 0], -d[..., 2])
    phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
    return phi / (2.0 * math.pi), theta / math.pi


def _pdf_solid_angle(pdf_sq, d):
    """The unit-square pdf over the solid angle of direction d."""
    sin_theta = torch.sqrt(torch.clamp(1.0 - d[..., 1] ** 2, min=1e-12))
    return pdf_sq / (2.0 * math.pi * math.pi * sin_theta)


def sample_env(scene, u2):
    """Importance-sample directions with u2 [N, 2]: (d [N, 3], solid-angle
    pdf [N], radiance of the texel [N, 3]). The alias table picks the
    texel and the leftover uniforms place the sample in it (the same
    continuous distribution as the CDF pair, by another mapping of u);
    without an alias table, the row CDF then the row's column CDF."""
    h, w = scene.env_density.shape
    if scene.env_alias is not None:
        k = h * w
        x = u2[..., 0] * k
        bin0 = torch.clamp(x.to(torch.int32), 0, k - 1)
        frac = torch.clamp(x - bin0.to(x.dtype), 0.0, 1.0 - 1e-6)
        pa = scene.env_alias[bin0.long()]                  # [N, 2]
        accept = u2[..., 1] < pa[..., 0]
        texel = torch.where(accept, bin0, pa[..., 1].to(torch.int32))
        # the accept draw rescaled into a fresh in-texel offset
        u_rs = torch.where(
            accept, u2[..., 1] / torch.clamp(pa[..., 0], min=1e-12),
            (u2[..., 1] - pa[..., 0]) / torch.clamp(1.0 - pa[..., 0],
                                                    min=1e-12))
        u_rs = torch.clamp(u_rs, 0.0, 1.0 - 1e-6)
        row = torch.div(texel, w, rounding_mode="floor")
        col = texel - row * w
        u = (col.to(x.dtype) + frac) / w
        v = (row.to(x.dtype) + u_rs) / h
    else:
        row = torch.clamp(torch.searchsorted(
            scene.env_row_cdf, u2[..., 0].contiguous(), right=True) - 1,
            0, h - 1)
        # the continuous offset within the row's bin (sampleReuse)
        r_lo = scene.env_row_cdf[row]
        r_p = torch.clamp(scene.env_row_cdf[row + 1] - r_lo, min=1e-12)
        v_frac = torch.clamp((u2[..., 0] - r_lo) / r_p, 0.0, 1.0 - 1e-6)
        ccdf = scene.env_col_cdf[row]                      # [N, W+1]
        col = torch.clamp(torch.sum(ccdf <= u2[..., 1][..., None], dim=-1)
                          - 1, 0, w - 1)
        c_lo = torch.gather(ccdf, -1, col[..., None])[..., 0]
        c_hi = torch.gather(ccdf, -1, col[..., None] + 1)[..., 0]
        u_frac = torch.clamp((u2[..., 1] - c_lo)
                             / torch.clamp(c_hi - c_lo, min=1e-12),
                             0.0, 1.0 - 1e-6)
        u = (col.to(u2.dtype) + u_frac) / w
        v = (row.to(u2.dtype) + v_frac) / h
    row, col = row.long(), col.long()
    d = _uv_to_dir(u, v)
    pdf_sa = _pdf_solid_angle(scene.env_density[row, col], d)
    return d, pdf_sa, scene.env_img[row, col]


def pdf_env_dir(scene, d):
    """Solid-angle pdf of sample_env toward directions d [N, 3]."""
    h, w = scene.env_density.shape
    u, v = _dir_to_uv(d)
    col = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
    row = torch.clamp((v * h).to(torch.int32), 0, h - 1).long()
    return _pdf_solid_angle(scene.env_density[row, col], d)


def eval_env_dir(scene, d):
    """Radiance along directions d [N, 3]: the bilinear lookup of
    envmap.cpp:389-407, wrapping in φ and clamping at the poles."""
    h, w = scene.env_img.shape[:2]
    u, v = _dir_to_uv(d)
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]

    def texel(xi, yi):
        return scene.env_img[torch.clamp(yi, 0, h - 1).long(),
                             torch.remainder(xi, w).long()]

    return ((texel(x0, y0) * (1 - tx) + texel(x0 + 1, y0) * tx) * (1 - ty)
            + (texel(x0, y0 + 1) * (1 - tx) + texel(x0 + 1, y0 + 1) * tx)
            * ty)
