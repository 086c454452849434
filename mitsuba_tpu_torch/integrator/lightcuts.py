"""Lightcuts over a VPL light tree (port of
mitsuba_tpu/integrator/lightcuts.py; ref: src/integrators/lightcuts/
lightcuts.cpp, librender/{lighttree,lightcutter}.cpp).

Every pixel gets a cut of cut_size nodes grown by cut_size − 1
refinement steps from the root: each step replaces the cut node of
largest error bound by its two children (an argmax and a masked swap over
[N, K]; the reference grows its cut with a priority queue until the bound
drops below 2% of the estimate). A cluster's bound is |flux| · 1/d²_min
to its bounding box. One shadow ray per cut node and pixel: the cut's K·N
shadow rays go to the trace kernel in chunks of VPLIntegrator's shading,
added node by node in the JAX package's order.

The tree is built on the host with numpy (median split over the VPL
positions, a flux-proportional representative per node), flattened to
arrays, as the reference and the JAX package build it. li_stats builds
it per call, as the JAX render does (lightcuts.py:219-224), so render_fn
and the command line render lightcuts; the JAX li builds it from traced
arrays and fails under the JAX render (ROADMAP.md Queue C).
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..device import check_scene_device
from ..scene.scene import SceneData
from .vpl import CHUNK_LANES, VPLIntegrator, VPLs, render_passes


class LightTree(NamedTuple):
    """Flattened binary tree, root = index 0. Leaves have child -1."""
    child: torch.Tensor      # [M, 2] int64
    flux: torch.Tensor       # [M, 3] cluster flux sum
    bb_min: torch.Tensor     # [M, 3]
    bb_max: torch.Tensor     # [M, 3]
    rep_p: torch.Tensor      # [M, 3] representative VPL position
    rep_n: torch.Tensor      # [M, 3]
    rep_wi: torch.Tensor     # [M, 3]
    rep_mat: torch.Tensor    # [M] int64


def build_light_tree(vpls: VPLs, device=None) -> LightTree:
    """Median-split tree over the valid VPLs (host numpy, ref
    lighttree.cpp), on `device` (the VPLs' by default)."""
    dev = vpls.p.device if device is None else torch.device(device)
    host = lambda x: x.detach().cpu().numpy()
    valid = host(vpls.valid)
    p, n_, wi, flux, mat = (host(x)[valid] for x in (
        vpls.p, vpls.n, vpls.wi, vpls.flux, vpls.mat_id))
    nv = len(p)
    if nv == 0:
        raise ValueError("no valid VPLs")

    child, fluxes, bmin, bmax = [], [], [], []
    rp, rn, rwi, rm = [], [], [], []

    def build(idx):
        me = len(child)
        child.append([-1, -1])
        fluxes.append(flux[idx].sum(0))
        bmin.append(p[idx].min(0))
        bmax.append(p[idx].max(0))
        # flux-proportional representative (lighttree.cpp)
        lum = flux[idx].sum(-1)
        rep = idx[np.argmax(lum)] if lum.sum() <= 0 else \
            idx[np.searchsorted(np.cumsum(lum), 0.5 * lum.sum())
                .clip(0, len(idx) - 1)]
        rp.append(p[rep])
        rn.append(n_[rep])
        rwi.append(wi[rep])
        rm.append(mat[rep])
        if len(idx) > 1:
            ax = int(np.argmax(p[idx].max(0) - p[idx].min(0)))
            order = idx[np.argsort(p[idx, ax], kind="stable")]
            half = len(order) // 2
            child[me] = [build(order[:half]), build(order[half:])]
        return me

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * nv + 100))
    try:
        build(np.arange(nv))
    finally:
        sys.setrecursionlimit(old)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=dev)
    return LightTree(i64(child), f32(fluxes), f32(bmin), f32(bmax), f32(rp),
                     f32(rn), f32(rwi), i64(rm))


@dataclass(frozen=True)
class LightcutsIntegrator(VPLIntegrator):
    """The reference's maxLights and errorRatio map to the fixed cut_size
    (the error bound picks which nodes refine; the budget is fixed)."""
    cut_size: int = 32

    def _node_error(self, tree: LightTree, node, x):
        """The bound of cluster `node` [...] at points x [..., 3]: |flux| ·
        1/d²_min(bbox) (the material bound is the BSDF eval's); 0 for a
        leaf, which cannot refine."""
        d = torch.clamp(torch.maximum(tree.bb_min[node] - x,
                                      x - tree.bb_max[node]), min=0.0)
        d2 = torch.sum(d * d, dim=-1)
        err = torch.sum(tree.flux[node], dim=-1) / torch.clamp(d2, min=1e-4)
        return torch.where(tree.child[node, 0] < 0, 0.0, err)

    def _cut(self, tree: LightTree, x):
        """Each point's cut [N, K] of node ids (-1: an unused slot)."""
        n, k = x.shape[0], self.cut_size
        cut = torch.full((n, k), -1, dtype=torch.int64, device=x.device)
        cut[:, 0] = 0
        slots = torch.arange(k, device=x.device)[None, :]
        for i in range(k - 1):
            err = self._node_error(tree, torch.clamp(cut, min=0),
                                   x[:, None, :])
            err = torch.where(cut >= 0, err, -1.0)
            worst = torch.argmax(err, dim=-1)                 # [N]
            node_w = torch.gather(cut, 1, worst[:, None])[:, 0]
            kids = tree.child[torch.clamp(node_w, min=0)]
            can = (node_w >= 0) & (kids[:, 0] >= 0)
            # the worst becomes child a, child b goes to slot i + 1
            cut = torch.where((slots == worst[:, None]) & can[:, None],
                              kids[:, 0:1], cut)
            cut[:, i + 1] = torch.where(can, kids[:, 1], -1)
        return cut

    def li_with_tree(self, scene: SceneData, tree: LightTree, o, d, seed,
                     pixel_id, sample_idx=0):
        """Radiance [N, 3] along the camera rays lit by each pixel's cut."""
        return self.specialized_for(scene, o.device)._li_with_tree(
            scene, tree, o, d)[0]

    def _li_with_tree(self, scene, tree, o, d):
        """(radiance, camera and shadow rays traced as a 0-d tensor)."""
        sh = self._shading(scene, o, d)
        L, n = sh.L, o.shape[0]
        cut = self._cut(tree, sh.its.p).T.contiguous()       # [K, N]
        n_rays = torch.as_tensor(n, device=o.device)
        step = max(1, CHUNK_LANES // max(n, 1))
        for j0 in range(0, self.cut_size, step):
            part = cut[j0:j0 + step]
            node = torch.clamp(part, min=0)
            contrib, ok, tried = self._lights(
                scene, sh, tree.rep_p[node], tree.rep_n[node],
                tree.rep_wi[node], tree.flux[node], tree.rep_mat[node],
                torch.zeros(part.shape + (2,), device=o.device), part >= 0,
                cos_x_test=False)
            n_rays = n_rays + tried
            for j in range(part.shape[0]):      # the JAX scan's order
                L = L + torch.where(ok[j, :, None], contrib[j], 0.0)
        return L, n_rays

    def li_stats(self, scene: SceneData, o, d, seed, pixel_id,
                 sample_idx=0):
        """One VPL set from `seed` and its tree (built on the host), then
        li_with_tree: (radiance [N, 3], traced rays as a 0-d int64
        tensor: the VPL walk's, one a camera ray and one an attempted
        shadow ray)."""
        tracer = self.specialized_for(scene, o.device)
        vpls, walk = tracer._generate(scene, seed)
        L, rays = tracer._li_with_tree(scene, build_light_tree(vpls), o, d)
        return L, (walk + rays).to(torch.int64)

    def render(self, scene: SceneData, camera, film, spp: int = 1,
               seed: int = 0, device="cuda"):
        """Full lightcuts render: one VPL set and tree, spp camera samples
        (the JAX render)."""
        check_scene_device(scene, device)
        tracer = self.specialized_for(scene)
        tree = build_light_tree(tracer.generate_vpls(scene, seed))
        return render_passes(scene, camera, film, spp, seed,
                             lambda o, d: tracer._li_with_tree(
                                 scene, tree, o, d)[0])
