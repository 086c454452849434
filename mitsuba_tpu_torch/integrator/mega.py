"""MegaPathTracer: the path megakernel integrator (port of
mitsuba_tpu/integrator/mega.py).

A drop-in replacement for PathTracer on scenes the megakernel covers:
pinhole or thin-lens perspective camera, flat or smooth shading normals,
the 14 leaf BSDF families (isotropic GGX where microfacet) with the
two-sided adapter, the mixture, blend, mask, coating and rough-coating
composites over leaf children, area, point, spot and directional
emitters and at most one constant environment, albedo textures with
checker or grid provenance (evaluated in closed form: pass the scene
description's tex_procs to supports and for_scene), box film: the JAX
gate. MegaVolPathTracer adds the global homogeneous medium
(VolPathTracer's estimator). `supports()` reports whether a scene
qualifies; `for_scene(scene, ...)` packs the scene tables once. On CUDA
tensors li_stats runs whole paths in one launch of the mega_path kernel and
render_persistent renders every pixel's spp paths in one launch of
mega_persistent; on CPU tensors both run the plain versions
(accel/megakernel.py). Estimator and sample streams are PathTracer's
(VolPathTracer's for MegaVolPathTracer). Bitmap textures, roughness,
normal and bump maps and envmaps stay on the eager path, as in the JAX
package.

render_persistent_sharded runs render_persistent over the ranks of a
torch.distributed job (parallel/dist.py), each rank a contiguous slice
of the lanes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..accel.megakernel import (N_PSTATE, MegaTables,
                                build_mega_tables, primary_rays, run_path,
                                run_persistent, to_numpy)
from ..bsdf.bsdf import COMPOSITE_FAMILIES
from ..scene import scene as S
from ..scene.scene import SceneData
from ..sensor.sensor import PerspectiveCamera
from .path import PathTracer, initial_state, pass_bounces
from .volpath import scene_medium

# lanes a rank of render_persistent_sharded runs come in multiples of this
# (the persistent launch's thread block, csrc/megakernel.cu kThreads; the
# JAX package's pblock, a TPU tile, has this role there)
SHARD_BLOCK = 128

# the JAX package's megakernel limits (MEGA_FAMILIES, MEGA_EM_TYPES and
# the VMEM triangle budget), kept so supports() refuses what it refuses
_REF_FAMILIES = (frozenset(range(S.N_MAT_TYPES))
                 - {S.MAT_HK, S.MAT_TABULATED, S.MAT_IRAWAN})
_REF_EM_TYPES = frozenset({S.EM_AREA, S.EM_POINT, S.EM_CONSTANT,
                           S.EM_DIRECTIONAL, S.EM_SPOT})
_REF_MAX_TRIS = 32768
_COMPOSITES = frozenset(COMPOSITE_FAMILIES)
# the JAX gate's isotropic-GGX microfacet families (mega.py:94-110)
_GGX_ONLY = ((S.MAT_ROUGH_DIELECTRIC, "roughdielectric"),
             (S.MAT_ROUGH_CONDUCTOR, "roughconductor"),
             (S.MAT_ROUGH_COATING, "roughcoating"),
             (S.MAT_ROUGH_PLASTIC, "roughplastic"))


@dataclass(frozen=True, eq=False)
class MegaPathTracer(PathTracer):
    """eq=False: the tables are tensors, compared by identity. The JAX
    class's block, pblock and sublanes (TPU tile sizes) are dropped: a
    CUDA thread runs one lane, and the launch covers every lane. The
    megakernels have no hide_emitters (nor have the JAX ones): the
    field must stay False; nor have they another sampler than the
    independent one."""
    tables: MegaTables | None = None

    def __post_init__(self):
        super().__post_init__()
        if self.hide_emitters:
            raise ValueError(f"{type(self).__name__}: the megakernels have "
                             "no hide_emitters")
        if self.sampler != "independent" and self.spp > 0:
            raise ValueError(f"{type(self).__name__}: the megakernels draw "
                             f"the independent stream, not "
                             f"{self.sampler!r}")

    @staticmethod
    def supports(scene: SceneData, camera=None, film=None,
                 allow_medium=False, tex_procs=None) -> tuple[bool, str]:
        """(ok, reason): can this scene, camera and film run on the
        megakernel with results matching PathTracer (VolPathTracer when
        allow_medium admits a homogeneous medium) and a box-filter Film?
        Where the JAX package refuses a scene this refuses it too, with
        the JAX reason. tex_procs: the scene description's texture slot →
        procedural provenance (SceneDesc.tex_procs); an albedo texture is
        admitted where its slot has one, and roughness, normal and bump
        maps are refused."""
        em_types = [int(t) for t in to_numpy(scene.em_type)]
        bad = set(em_types) - _REF_EM_TYPES
        if em_types.count(S.EM_CONSTANT) > 1 or bad:
            return False, f"unsupported emitter types {bad or 'env×2'}"
        fams = set(int(x) for x in np.unique(to_numpy(scene.mat_type)))
        if fams - _REF_FAMILIES:
            return False, f"unsupported BSDF families {fams - _REF_FAMILIES}"
        mp, mt = to_numpy(scene.mat_params), to_numpy(scene.mat_type)
        if fams & _COMPOSITES:
            # one composite level, leaf children only, no weight
            # textures, no two-sided child, no textures anywhere
            mix = mt == S.MAT_MIXTURE
            coat = (mt == S.MAT_COATING) | (mt == S.MAT_ROUGH_COATING)
            if (to_numpy(scene.mat_tex) >= 0).any():
                return False, "composite + textures"
            if (mp[mix, 21] >= 0).any():
                return False, "textured mixture weight"
            kids = np.concatenate([mp[mix, 18], mp[mix, 19],
                                   mp[coat, 18]]).astype(int)
            if (kids < 0).any() or (kids >= mt.shape[0]).any():
                return False, "composite child out of range"
            if set(int(t) for t in mt[kids]) - (_REF_FAMILIES - _COMPOSITES):
                return False, "nested/unsupported composite children"
            if (mp[kids, 15] > 0.5).any():
                return False, "twosided composite child"
        for code, name in _GGX_ONLY:
            rows = mp[mt == code]
            # roughcoating has no alpha_v slot (the builder leaves it 0)
            aniso = code != S.MAT_ROUGH_COATING and \
                (rows[:, 9] != rows[:, 10]).any()
            if (rows[:, 11] != 1).any() or aniso:
                return False, f"non-GGX/anisotropic {name}"
        if bool(to_numpy(scene.has_medium)):
            if not allow_medium:
                return False, "participating medium"
            if scene.med_grid.numel() != 1:
                return False, "heterogeneous medium"
            # the builder stores all-zero rows for isotropic media
            if any(x is not None and bool((x != 0).any())
                   for x in (scene.med_sggx, scene.med_fiber)):
                return False, "anisotropic (SGGX/fiber) medium"
        # an albedo texture runs in closed form where its slot has
        # checker/grid provenance; roughness and normal/bump maps stay
        # on the eager path
        tex = to_numpy(scene.mat_tex)
        procs = tex_procs or {}
        if (not all(slot < 0 or slot in procs for slot in tex[:, 0])
                or (tex[:, 1] >= 0).any() or (mp[:, 16] >= 0).any()):
            return False, "textured material"
        areas = to_numpy(scene.tri_area)
        n_real = int(np.max(np.nonzero(areas > 0)[0]) + 1) if \
            (areas > 0).any() else 1
        if n_real > _REF_MAX_TRIS:
            return False, f"{n_real} triangles exceed the VMEM budget"
        if camera is not None and not isinstance(camera, PerspectiveCamera):
            return False, "non-perspective camera"
        if film is not None and film.filter_name != "box":
            return False, f"{film.filter_name} reconstruction filter"
        return True, ""

    @classmethod
    def for_scene(cls, scene: SceneData, max_depth: int = 8,
                  rr_depth: int = 5, tex_procs=None) -> "MegaPathTracer":
        """Pack the scene's tables on its device (the GPU for a scene
        compiled with the default device), with the procedural albedo
        textures of tex_procs (SceneDesc.tex_procs). Raises
        NotImplementedError, with supports()'s reason, for a scene
        outside the subset."""
        ok, reason = cls.supports(scene, tex_procs=tex_procs)
        if not ok:
            raise NotImplementedError(f"{cls.__name__}: {reason}")
        return cls(max_depth=max_depth, rr_depth=rr_depth,
                   tables=build_mega_tables(scene, cls._medium(scene),
                                            tex_procs))

    @staticmethod
    def _medium(scene):
        """The medium the tables compile in: none for MegaPathTracer."""
        return None

    def li(self, scene: SceneData, o, d, seed, pixel_id, sample_idx=0):
        return self.li_stats(scene, o, d, seed, pixel_id, sample_idx)[0]

    def li_stats(self, scene: SceneData, o, d, seed, pixel_id,
                 sample_idx=0):
        """PathTracer.li_stats through run_path: (L [N, 3], traced-ray
        count as a 0-d int64 tensor). An unbounded tracer (max_depth <= 0)
        runs up to 32 bounces, as the JAX MegaPathTracer."""
        if scene is not self.tables.scene:
            raise ValueError("MegaPathTracer was built for another scene; "
                             "use MegaPathTracer.for_scene(scene)")
        n = o.shape[0]
        samp = torch.as_tensor(sample_idx, device=o.device)
        samp = samp.expand(n).to(torch.int32).contiguous()
        out = run_path(self.tables, self.rr_depth, self.max_depth,
                       pass_bounces(self.max_depth), initial_state(o, d),
                       pixel_id.to(torch.int32).contiguous(), samp, seed)
        n_rays = out[16:18].to(torch.int64).sum()
        return out[9:12].T, n_rays


@dataclass(frozen=True, eq=False)
class MegaVolPathTracer(MegaPathTracer):
    """The megakernels with the global homogeneous medium (balance
    distance sampling and the HG phase, ref volpath.cpp:104-181) compiled
    in: VolPathTracer's estimator and sample streams, lane by lane. Its
    ray counts count ATTEMPTED NEE shadow rays, like PathTracer's;
    VolPathTracer.li_stats counts unoccluded ones."""

    @staticmethod
    def supports(scene: SceneData, camera=None, film=None,
                 allow_medium=True, tex_procs=None) -> tuple[bool, str]:
        return MegaPathTracer.supports(scene, camera, film,
                                       allow_medium=True,
                                       tex_procs=tex_procs)

    @staticmethod
    def _medium(scene):
        """(σt rgb, albedo rgb, g, bound) of the scene's medium, or None."""
        return scene_medium(scene)


def render_persistent(integ: MegaPathTracer, camera, spp: int,
                      seed: int = 0):
    """Persistent path-regeneration render (accel/megakernel.py
    run_persistent): one lane per pixel, each completing exactly `spp`
    paths with in-kernel camera-ray regeneration. Runs on the device of
    the integrator's scene. Returns (image [H, W, 3], n_rays as a 0-d
    int64 tensor). Pinhole or thin-lens perspective cameras."""
    w, h = camera.width, camera.height
    pix = torch.arange(w * h, dtype=torch.int32,
                       device=integ.tables.scene.device)
    l_mean, counts = _persistent_lanes(integ, camera, spp, seed, pix)
    return l_mean.reshape(h, w, 3), counts.sum()


def _persistent_lanes(integ: MegaPathTracer, camera, spp: int, seed,
                      pix_flat):
    """Run the persistent kernel over any int32 pixel-id lane vector (the
    sample streams are keyed by pixel id, so any lane→pixel assignment
    gives the same per-pixel estimate). Returns (L sum / spp [n, 3],
    per-lane ray counts [n] int64) in the input lane order."""
    n = pix_flat.shape[0]
    o, d = primary_rays(camera, seed, pix_flat, 0)
    state = torch.cat([initial_state(o, d),
                       o.new_zeros((N_PSTATE - 16, n))])
    out = run_persistent(integ.tables, integ.rr_depth, integ.max_depth, spp,
                         camera, state, pix_flat.contiguous(),
                         torch.zeros_like(pix_flat), seed)
    return out[18:21].T / spp, out[22:24].to(torch.int64).sum(0)


def render_persistent_sharded(integ: MegaPathTracer, camera, spp: int,
                              seed, mesh):
    """render_persistent over the ranks of a torch.distributed job
    (parallel/dist.py Mesh; port of the JAX render_persistent_sharded):
    the lane axis padded to a multiple of SHARD_BLOCK · size, lane i
    owning pixel i % n (the padding lanes' duplicates are cut), rank r
    running _persistent_lanes on its contiguous slice and writing it into
    zero buffers of every lane, which one all_reduce sums. Each lane's
    estimate is keyed by its pixel id alone, so the image is
    render_persistent's. Returns (image [H, W, 3], n_rays as a 0-d int64
    tensor) on every rank."""
    w, h = camera.width, camera.height
    n = w * h
    chunk = SHARD_BLOCK * mesh.size
    n_pad = -(-n // chunk) * chunk
    per = n_pad // mesh.size
    lo = mesh.rank * per
    pix = torch.arange(lo, lo + per, dtype=torch.int32,
                       device=mesh.device) % n
    l_mean, counts = _persistent_lanes(integ, camera, spp, seed, pix)
    # one buffer of every lane, f64: L (f32) and the counts both exact
    lanes = torch.zeros((n_pad, 4), dtype=torch.float64, device=mesh.device)
    lanes[lo:lo + per, 0:3] = l_mean
    lanes[lo:lo + per, 3] = counts
    dist.all_reduce(lanes, group=mesh.group)
    image = lanes[:n, 0:3].to(torch.float32).reshape(h, w, 3)
    return image, lanes[:n, 3].sum().to(torch.int64)
