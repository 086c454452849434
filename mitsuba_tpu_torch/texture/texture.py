"""Bitmap textures with mip pyramids in one texel pool (port of
mitsuba_tpu/texture/texture.py).

Host-side compilation builds a box-filtered mip pyramid per texture
(float32 numpy, as the JAX package builds it) and packs every level of
every texture into one [TEXELS, 3] pool; the meta table holds (offset,
width, height, wrap) per (texture, level), MAX_MIPS rows a texture, the
rows past a texture's last level repeating it. Device lookups are torch
gathers: bilinear at an explicit level, trilinear between two, and the
footprint-assembly anisotropic lookup; wrap modes repeat and clamp.

The checkerboard and grid textures are rasterized into bitmaps at
compile time, and keep their parameters in `ProcImage.proc`, so the
megakernels can evaluate the analytic form (accel/megakernel.py
proc_albedo) where the eager path samples the bitmap.
"""
from __future__ import annotations

import numpy as np
import torch

MAX_MIPS = 16
WRAP_REPEAT = 0
WRAP_CLAMP = 1


def build_pyramid(img: np.ndarray) -> list[np.ndarray]:
    """Box-filter mip chain down to 1×1 (ref: mipmap.h pyramid
    construction)."""
    levels = [np.asarray(img, np.float32)]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        prev = levels[-1]
        h, w = prev.shape[:2]
        nh, nw = max(1, h // 2), max(1, w // 2)
        ph = prev[: nh * 2, : nw * 2]
        down = 0.25 * (ph[0::2, 0::2] + ph[1::2, 0::2]
                       + ph[0::2, 1::2] + ph[1::2, 1::2])
        levels.append(down.astype(np.float32))
    return levels


def pack_textures(images: list, wraps: list | None = None):
    """→ (tex_data [TEXELS, 3] f32, tex_meta [NTEX·MAX_MIPS, 4] i32:
    offset, width, height, wrap). No images: a [1, 3] and a [1, 4] zero
    placeholder. The arrays are the JAX package's, which for a non-square
    image include its levels past the one where the short side reaches 1:
    their short side is 0 (build_pyramid halves it to nothing), and a
    lookup there reads texels that belong to no level."""
    if not images:
        return np.zeros((1, 3), np.float32), np.zeros((1, 4), np.int32)
    wraps = wraps or [WRAP_REPEAT] * len(images)
    pool, meta = [], np.zeros((len(images) * MAX_MIPS, 4), np.int32)
    offset = 0
    for ti, img in enumerate(images):
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        levels = build_pyramid(img)[:MAX_MIPS]
        for li, lvl in enumerate(levels):
            h, w = lvl.shape[:2]
            meta[ti * MAX_MIPS + li] = (offset, w, h, wraps[ti])
            pool.append(lvl.reshape(-1, 3))
            offset += h * w
        # missing levels repeat the last one's meta (a clamped lod)
        meta[ti * MAX_MIPS + len(levels):(ti + 1) * MAX_MIPS] = \
            meta[ti * MAX_MIPS + len(levels) - 1]
    return np.concatenate(pool).astype(np.float32), meta


def _wrap(x, n, mode):
    """Texel index x wrapped into [0, n): floor-mod (negative indices
    appear at uv 0 and at repeat seams) or clamp. A level with n = 0
    (pack_textures) wraps as if n were 1."""
    xr = torch.remainder(x, torch.clamp(n, min=1))
    xc = torch.minimum(torch.clamp(x, min=0), n - 1)
    return torch.where(mode == WRAP_REPEAT, xr, xc)


def eval_texture_lod(scene, tex_id, uv, level):
    """Bilinear lookup at integer mip `level` (mipmap.h:296). tex_id and
    level [N] integer tensors, uv [N, 2]; v = 0 is the image's bottom
    row."""
    meta = scene.tex_meta[(tex_id * MAX_MIPS + level).long()]   # [N, 4]
    off, w, h, wrap = meta.unbind(-1)
    fx = uv[..., 0] * w.to(uv.dtype) - 0.5
    fy = (1.0 - uv[..., 1]) * h.to(uv.dtype) - 0.5
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]

    def texel(xi, yi):
        xi = _wrap(xi, w, wrap)
        yi = _wrap(yi, h, wrap)
        return scene.tex_data[(off + yi * w + xi).long()]

    top = texel(x0, y0) * (1 - tx) + texel(x0 + 1, y0) * tx
    bot = texel(x0, y0 + 1) * (1 - tx) + texel(x0 + 1, y0 + 1) * tx
    return top * (1 - ty) + bot * ty


def eval_texture(scene, tex_id, uv, lod=None):
    """Lookup at the finest level (lod None), or the trilinear blend of
    the two levels around a fractional lod [N] (mipmap.h:60)."""
    if lod is None:
        return eval_texture_lod(scene, tex_id, uv, torch.zeros_like(tex_id))
    l0 = torch.clamp(torch.floor(lod).to(torch.int32), 0, MAX_MIPS - 2)
    frac = torch.clamp(lod - l0.to(lod.dtype), 0.0, 1.0)[..., None]
    a = eval_texture_lod(scene, tex_id, uv, l0)
    b = eval_texture_lod(scene, tex_id, uv, l0 + 1)
    return a * (1 - frac) + b * frac


def eval_texture_aniso(scene, tex_id, uv, duv0, duv1, max_aniso=8.0,
                       probes=5):
    """Anisotropic lookup from the uv footprint's derivatives duv0, duv1
    [N, 2] (∂uv/∂x, ∂uv/∂y): the ellipse integrated with `probes`
    Gaussian-weighted trilinear probes along its major axis at the minor
    axis's lod (footprint assembly, McCormack et al. "Feline" 1999, the
    JAX package's stand-in for TMIPMap's EWA loop), anisotropy clamped to
    max_aniso."""
    meta = scene.tex_meta[(tex_id * MAX_MIPS).long()]
    size = torch.maximum(meta[..., 1], meta[..., 2]).to(uv.dtype)
    l0 = torch.sum(duv0 * duv0, dim=-1)
    l1 = torch.sum(duv1 * duv1, dim=-1)
    major_is_0 = l0 >= l1
    major = torch.sqrt(torch.clamp(torch.where(major_is_0, l0, l1),
                                   min=1e-20))
    minor = torch.sqrt(torch.clamp(torch.where(major_is_0, l1, l0),
                                   min=1e-20))
    # clamp the anisotropy (mipmap.h maxAnisotropy): widen the minor axis
    ratio = major / torch.clamp(minor, min=1e-10)
    minor = torch.where(ratio > max_aniso, major / max_aniso, minor)
    lod = torch.clamp(torch.log2(torch.clamp(minor * size, min=1e-6)),
                      0.0, MAX_MIPS - 1.0)
    dir_maj = torch.where(major_is_0[..., None], duv0, duv1)
    dir_maj = dir_maj / torch.clamp(major, min=1e-10)[..., None]
    # probes spanning ±(major - minor) along the major axis
    span = torch.clamp(major - minor, min=0.0)
    ts = torch.linspace(-1.0, 1.0, probes, dtype=uv.dtype,
                        device=uv.device)
    ws = torch.exp(-2.0 * ts ** 2)
    ws = ws / ws.sum()
    out = 0.0
    for i in range(probes):
        uv_i = uv + dir_maj * (0.5 * span * ts[i])[..., None]
        out = out + ws[i] * eval_texture(scene, tex_id, uv_i, lod)
    return out


class ProcImage(np.ndarray):
    """An ndarray with procedural provenance in `.proc`: ("checker", c0,
    c1, res, tiles) or ("grid", c0, c1, res, tiles, line_width).
    SceneDesc.add_texture records it per texture slot."""
    proc: tuple | None = None


def _with_proc(img: np.ndarray, proc: tuple) -> np.ndarray:
    out = img.astype(np.float32).view(ProcImage)
    out.proc = proc
    return out


def checkerboard(color0=(0.4, 0.4, 0.4), color1=(0.2, 0.2, 0.2), res=512,
                 tiles=8) -> np.ndarray:
    """Rasterized checkerboard (ref: src/textures/checkerboard.cpp)."""
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    cell = ((xx * tiles // res) + (yy * tiles // res)) % 2
    img = np.where(cell[..., None] == 0, np.asarray(color0, np.float32),
                   np.asarray(color1, np.float32))
    return _with_proc(img, ("checker", tuple(np.ravel(color0)),
                            tuple(np.ravel(color1)), res, tiles))


def grid_texture(color0=(0.2, 0.2, 0.2), color1=(0.4, 0.4, 0.4), res=512,
                 tiles=8, line_width=0.01) -> np.ndarray:
    """Rasterized grid lines (ref: src/textures/gridtexture.cpp)."""
    t = (np.arange(res) + 0.5) / res * tiles
    on_x = np.abs(t - np.round(t)) < line_width * tiles
    on = on_x[None, :] | on_x[:, None]
    img = np.where(on[..., None], np.asarray(color0, np.float32),
                   np.asarray(color1, np.float32))
    return _with_proc(img, ("grid", tuple(np.ravel(color0)),
                            tuple(np.ravel(color1)), res, tiles,
                            float(line_width)))
