"""Photon mapping: photon tracing, a sorted hash grid, density estimation
and progressive refinement (port of mitsuba_tpu/integrator/photonmap.py;
ref: src/integrators/photonmapper/{photonmapper,ppm,sppm}.cpp).

  * Photons walk from the area emitters (emitter.sample_emitter_ray) and
    deposit at every smooth hit from the second light vertex on
    (indirect light only; NEE gives the direct).
  * The reference's kd-tree with kNN gather becomes a sorted spatial hash
    grid: photons hash to cells of side ≥ the gather radius, sort by cell
    id (a stable argsort, so the sums within a cell keep the JAX order),
    and cell spans come from searchsorted. The gather shades a cell's
    candidates as one batch of lanes and adds them in the JAX order: 27
    batches a gather, where the JAX loop's 27 × 32 steps would each be a
    round of small launches on the eager host.
  * kNN density estimation becomes fixed-radius estimation with the
    progressive radius schedule of Knaus & Zwicker 2011
    (render_progressive, the ppm/sppm class).
  * The eye pass: camera ray → through delta chains → the first smooth
    hit: emitted + NEE direct + the photon estimate of the indirect.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..bsdf.bsdf import (MatInfo, eval_bsdf_ex, resolve_material,
                         sample_bsdf_ex)
from ..core import rng
from ..core.math import SHADOW_EPSILON, Frame, dot
from ..emitter.emitter import (eval_area, eval_env, sample_direct,
                               sample_emitter_ray)
from ..scene.scene import SceneData
from .common import (DIM_BSDF_U1, DIM_BSDF_U2, DIM_NEE_POS, DIM_NEE_SEL,
                     DIM_RR, bounce_dim, offset_ray_origin, ray_mint,
                     tile_lanes)
from .path import PathTracer

# the photons' RNG dims, offset so that photon streams never collide with
# the eye paths' of the same seed
_PHOTON_DIM_BASE = 4096
MAP_SEED = 0x5bd1           # li's map seed: seed ^ MAP_SEED


class PhotonMap(NamedTuple):
    """Sorted-hash-grid photon map. P photons (padded: a dead photon
    carries power 0 and parks in cell n³)."""
    pos: torch.Tensor        # [P, 3] sorted by cell id
    power: torch.Tensor      # [P, 3] flux (W), already / count
    normal: torch.Tensor     # [P, 3] surface normal at the deposit
    wi: torch.Tensor         # [P, 3] incoming direction (toward source)
    cell_of: torch.Tensor    # [P] int64 sorted cell ids
    grid_min: torch.Tensor   # [3]
    inv_cell: torch.Tensor   # 0-d: 1 / cell size
    n_cells_dim: int         # cells per axis
    radius: float            # the gather radius the grid was built for


def _cell_id(pos, grid_min, inv_cell, n_dim):
    c = torch.floor((pos - grid_min) * inv_cell).to(torch.int32)
    c = torch.clamp(c, 0, n_dim - 1).to(torch.int64)
    return (c[..., 0] * n_dim + c[..., 1]) * n_dim + c[..., 2]


def trace_photons(scene: SceneData, tracer: PathTracer, n_photons: int,
                  seed, max_depth: int = 8):
    """Walk n_photons photons from the emitters; returns (pos, power,
    normal, wi, valid) of every deposit slot, flattened bounce-major
    [n_photons · n_bounces, ...] (gatherproc.h: power = Le·A·π/(pmf·N)
    with cosine emission)."""
    tracer = tracer.specialized_for(scene)
    n = n_photons
    dev = scene.device
    pid = torch.arange(n, dtype=torch.int64, device=dev)
    dim0 = _PHOTON_DIM_BASE
    er = sample_emitter_ray(scene, rng.sample_1d(seed, pid, dim0 + 0),
                            rng.sample_2d(seed, pid, dim0 + 1),
                            rng.sample_2d(seed, pid, dim0 + 2))
    # emitted power Φ = Le·A·π; per photon α = Φ / (pmf · N)
    alpha = er.le * (er.area * math.pi / torch.clamp(er.pmf, min=1e-12)
                     )[:, None] / n
    alpha = torch.where(er.is_area[:, None], alpha, 0.0)
    o, d, active = offset_ray_origin(er.p, er.n, er.d), er.d, er.is_area
    photons = []
    for bounce in range(max_depth if max_depth > 0 else 16):
        its = tracer._intersect(scene, o, d, ray_mint(o), active)
        hit = active & its.valid
        mat = resolve_material(scene, its.mat_id, its.uv, tracer.families)
        frame = Frame.from_normal(its.ns)
        wi_local = Frame.to_local(frame, -d)
        u2 = rng.sample_2d(seed, pid,
                           dim0 + bounce_dim(bounce + 1, DIM_BSDF_U2))
        u1 = rng.sample_1d(seed, pid,
                           dim0 + bounce_dim(bounce + 1, DIM_BSDF_U1))
        bs = sample_bsdf_ex(mat, wi_local, u2, u1, tracer.families)
        # deposit at the 2nd+ light vertex on a smooth surface (delta
        # lobes store no photons)
        depth = bounce + 2          # light vertices, the emitter's included
        photons.append((its.p, alpha, its.ns, -d,
                        hit & ~bs.is_delta & (depth >= 3)))

        d_next = Frame.to_world(frame, bs.wo)
        o = offset_ray_origin(its.p, its.ng, d_next)
        alpha_next = alpha * bs.weight
        alive = hit & (bs.pdf > 0) & (alpha_next > 0).any(-1)
        if max_depth > 0:
            alive = alive & (depth <= max_depth)
        if depth >= tracer.rr_depth:
            u_rr = rng.sample_1d(seed, pid,
                                 dim0 + bounce_dim(bounce + 1, DIM_RR))
            q = torch.clamp(alpha_next.amax(-1)
                            / torch.clamp(alpha.amax(-1), min=1e-20),
                            0.05, 0.95)
            rr_cont = u_rr < q
            alpha_next = torch.where(
                rr_cont[:, None],
                alpha_next / torch.clamp(q, min=1e-6)[:, None], alpha_next)
            alive = alive & rr_cont
        d = torch.where(alive[:, None], d_next, d)
        alpha = torch.where(alive[:, None], alpha_next, 0.0)
        active = alive
    return tuple(torch.cat([ph[i] for ph in photons]) for i in range(5))


def build_photon_map(pos, power, normal, wi, valid, radius: float,
                     scene_min, scene_max, n_cells_dim: int = 64
                     ) -> PhotonMap:
    """Sort the photons into a dense n³ grid of cell side ≥ radius. An
    invalid photon gets power 0 and parks in cell n³."""
    extent = torch.clamp(torch.amax(scene_max - scene_min), min=1e-6)
    cell = torch.clamp(extent / n_cells_dim, min=radius)
    inv_cell = 1.0 / cell
    cid = _cell_id(pos, scene_min, inv_cell, n_cells_dim)
    cid = torch.where(valid, cid, n_cells_dim ** 3)
    order = torch.argsort(cid, stable=True)
    return PhotonMap(
        pos=pos[order],
        power=torch.where(valid[order][:, None], power[order], 0.0),
        normal=normal[order], wi=wi[order], cell_of=cid[order],
        grid_min=scene_min, inv_cell=inv_cell, n_cells_dim=n_cells_dim,
        radius=radius)


def gather_radiance(pmap: PhotonMap, mat, frame, p, wi_local, radius: float,
                    families=None, max_per_cell: int = 32):
    """Density estimate L_indirect(p, wo = wi_local) = Σ f(wi_ph→wo)·Φ/(πr²)
    over the photons within `radius` (photonmap.cpp
    estimateRadiance): the 27 neighbour cells, at most max_per_cell
    photons of each (the spans by searchsorted). A cell's max_per_cell
    candidates are shaded at once as [max_per_cell · N] lanes, then
    added one after another, in the JAX loop's order."""
    nd = pmap.n_cells_dim
    r2 = radius * radius
    last = pmap.pos.shape[0] - 1
    n, k = p.shape[0], max_per_cell
    ks = torch.arange(k, device=p.device)[:, None]
    base = torch.floor((p - pmap.grid_min) * pmap.inv_cell).to(torch.int64)
    p_k = tile_lanes(p, k)
    frame_k = tuple(tile_lanes(x, k) for x in frame)
    mat_k = MatInfo(*(tile_lanes(x, k) for x in mat))
    wi_k = tile_lanes(wi_local, k)
    acc = torch.zeros((n, 3), device=p.device)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                c = base + torch.tensor([ox, oy, oz], device=p.device)
                ok_cell = ((c >= 0) & (c < nd)).all(-1)
                cid = (c[..., 0] * nd + c[..., 1]) * nd + c[..., 2]
                start = torch.searchsorted(pmap.cell_of, cid)
                end = torch.searchsorted(pmap.cell_of, cid, right=True)
                count = torch.clamp(end - start, max=max_per_cell)
                idx = torch.clamp(start + ks, max=last).reshape(-1)
                inside = ((ks < count) & ok_cell).reshape(-1) & (torch.sum(
                    (pmap.pos[idx] - p_k) ** 2, dim=-1) <= r2)
                ph_wi = Frame.to_local(frame_k, pmap.wi[idx])
                # reciprocity: f(wi_ph→wo_cam) = f(wo_cam→wi_ph); eval
                # returns f·cos(ph_wi.z), whose cosine comes off (the
                # estimate has none)
                f = eval_bsdf_ex(mat_k, wi_k, ph_wi, families)
                # photons count on the front side only
                same = dot(pmap.normal[idx], frame_k[2]) > 0.1
                contrib = torch.where(
                    (inside & same)[:, None],
                    f * pmap.power[idx] / torch.clamp(
                        torch.abs(ph_wi[:, 2:3]), min=1e-3), 0.0)
                for j in range(k):
                    acc = acc + contrib[j * n:(j + 1) * n]
    return acc / float(np.float32(np.pi * r2))


@dataclass(frozen=True)
class PhotonMapper(PathTracer):
    """Classic photon mapping (photonmapper.cpp): direct light by NEE and
    emission, the indirect by the photon density estimate at the first
    smooth hit (delta chains followed for up to specular_chain hits).
    render_progressive renders passes with the Knaus-Zwicker shrinking
    radius (ppm, sppm)."""
    n_photons: int = 1 << 16
    gather_radius: float = 0.1
    photon_depth: int = 8
    specular_chain: int = 4      # hits followed before the gather

    def build_map(self, scene: SceneData, seed, radius=None) -> PhotonMap:
        """The map of n_photons photons keyed (seed, photon)."""
        pp, pw, pn, pwi, pv = trace_photons(
            scene, self, self.n_photons, seed, self.photon_depth)
        verts = torch.cat([scene.p0, scene.p0 + scene.e1,
                           scene.p0 + scene.e2])
        # the padding triangles lie far away
        real = torch.abs(verts) < 1e29
        smin = torch.amin(torch.where(real, verts, 1e30), dim=0)
        smax = torch.amax(torch.where(real, verts, -1e30), dim=0)
        r = self.gather_radius if radius is None else radius
        return build_photon_map(pp, pw, pn, pwi, pv, r, smin, smax)

    def li_with_map(self, scene: SceneData, pmap: PhotonMap, o, d, seed,
                    pixel_id, sample_idx=0):
        """The eye pass: through delta lobes, then emitted + NEE direct
        + the photon estimate of the indirect at the first smooth
        vertex. A bounce that no lane reaches is skipped (a host read a
        bounce; it adds nothing)."""
        if not self.settled:
            return self.specialized_for(scene, o.device).li_with_map(
                scene, pmap, o, d, seed, pixel_id, sample_idx)
        n = o.shape[0]
        L = torch.zeros((n, 3), device=o.device)
        throughput = torch.ones((n, 3), device=o.device)
        active = torch.ones(n, dtype=torch.bool, device=o.device)
        prev_delta = active
        for bounce in range(self.specular_chain):
            if bounce > 0 and not bool(active.any()):
                break
            its = self._intersect(scene, o, d, ray_mint(o), active)
            escaped = active & ~its.valid
            L = L + torch.where(escaped[:, None],
                                throughput * eval_env(scene, d), 0.0)
            hit = active & its.valid
            le = eval_area(scene, its.em_id, -dot(d, its.ng))
            # emission only on delta chains (NEE covers the rest); the
            # first hit ends a chain of length 0
            L = L + torch.where((hit & prev_delta)[:, None], throughput * le,
                                0.0)
            mat = resolve_material(scene, its.mat_id, its.uv, self.families)
            frame = Frame.from_normal(its.ns)
            wi_local = Frame.to_local(frame, -d)
            u2 = self._d2(seed, pixel_id, sample_idx,
                          bounce_dim(bounce, DIM_BSDF_U2))
            u1 = self._d1(seed, pixel_id, sample_idx,
                          bounce_dim(bounce, DIM_BSDF_U1))
            bs = sample_bsdf_ex(mat, wi_local, u2, u1, self.families)
            smooth = hit & ~bs.is_delta

            # ---- a smooth vertex: direct NEE + the photon gather --------
            ds = sample_direct(
                scene, its.p,
                self._d1(seed, pixel_id, sample_idx,
                         bounce_dim(bounce, DIM_NEE_SEL)),
                self._d2(seed, pixel_id, sample_idx,
                         bounce_dim(bounce, DIM_NEE_POS)))
            f_nee = eval_bsdf_ex(mat, wi_local, Frame.to_local(frame, ds.d),
                                 self.families)
            so = offset_ray_origin(its.p, its.ng, ds.d)
            tried = smooth & (ds.pdf > 0)
            occ = self._occluded(scene, so, ds.d, ray_mint(so),
                                 ds.dist * (1.0 - SHADOW_EPSILON), tried)
            L = L + torch.where((tried & ~occ)[:, None],
                                throughput * ds.value * f_nee, 0.0)
            ind = gather_radiance(pmap, mat, frame, its.p, wi_local,
                                  pmap.radius, self.families)
            L = L + torch.where(smooth[:, None], throughput * ind, 0.0)

            # ---- a delta vertex: the chain goes on ----------------------
            cont = hit & bs.is_delta & (bs.pdf > 0)
            d_next = Frame.to_world(frame, bs.wo)
            o = torch.where(cont[:, None],
                            offset_ray_origin(its.p, its.ng, d_next), o)
            d = torch.where(cont[:, None], d_next, d)
            throughput = torch.where(cont[:, None], throughput * bs.weight,
                                     throughput)
            prev_delta = cont
            active = cont
        return L

    def li_stats(self, scene: SceneData, o, d, seed, pixel_id,
                 sample_idx=0):
        """A map from seed ^ MAP_SEED (the JAX li's), then li_with_map:
        (radiance [N, 3], the JAX count 2N + n_photons as a 0-d int64
        tensor)."""
        tracer = self.specialized_for(scene, o.device)
        pmap = tracer.build_map(scene, int(seed) ^ MAP_SEED)
        L = tracer.li_with_map(scene, pmap, o, d, seed, pixel_id, sample_idx)
        return L, torch.as_tensor(2 * o.shape[0] + self.n_photons,
                                  dtype=torch.int64, device=o.device)


def progressive_radii(r0: float, n_passes: int, alpha: float = 0.7):
    """The gather radius of passes i = 0 ... n_passes - 1: rᵢ² =
    r₀²·Πₖ₌₁^i (k+α)/(k+1) (Knaus & Zwicker 2011), in the JAX loop's
    float64 arithmetic."""
    out, r2 = [], r0 ** 2
    for i in range(n_passes):
        out.append(float(np.sqrt(r2)))
        r2 *= (i + 1 + alpha) / (i + 2)
    return out


def render_progressive(scene: SceneData, camera, film, pm: PhotonMapper,
                       n_passes: int = 8, spp_per_pass: int = 4,
                       seed: int = 0, alpha: float = 0.7, device="cuda"):
    """PPM/SPPM-class progressive render (ppm.cpp, sppm.cpp): pass i
    traces a fresh photon map (seed + 7919·i) and gathers with the radius
    of progressive_radii, so the bias falls to 0 as passes accumulate.
    Returns the running mean of the pass images [H, W, 3]."""
    from ..render import render
    acc = None
    for i, r in enumerate(progressive_radii(pm.gather_radius, n_passes,
                                            alpha)):
        pm_i = PhotonMapper(
            max_depth=pm.max_depth, rr_depth=pm.rr_depth,
            families=pm.families, accel=pm.accel, n_photons=pm.n_photons,
            gather_radius=r, photon_depth=pm.photon_depth,
            specular_chain=pm.specular_chain)
        img = render(scene, camera, film, pm_i, spp=spp_per_pass,
                     seed=seed + 7919 * i, device=device)
        acc = img if acc is None else acc + (img - acc) / (i + 1)
    return acc
