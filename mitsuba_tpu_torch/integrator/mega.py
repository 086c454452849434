"""MegaPathTracer: the path megakernel integrator (port of
mitsuba_tpu/integrator/mega.py for surface scenes).

A drop-in replacement for PathTracer on scenes the megakernel covers:
pinhole perspective camera, flat or smooth shading normals, the 14 leaf
BSDF families (isotropic GGX where microfacet) with the two-sided
adapter, area emitters, no medium, no textures, box film. `supports()`
reports whether a scene qualifies; `for_scene(scene, ...)` packs the
scene tables once. On CUDA
tensors li_stats runs whole paths in one launch of the mega_path kernel and
render_persistent renders every pixel's spp paths in one launch of
mega_persistent; on CPU tensors both run the plain versions
(accel/megakernel.py). Estimator and sample streams are PathTracer's.

Not ported yet: the composite families (mixture, coating, rough
coating), point, spot, directional and constant emitters, the thin-lens
camera, procedural textures, MegaVolPathTracer (the homogeneous medium
branch) and render_persistent_sharded.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..accel.megakernel import (LEAF_FAMILIES, N_PSTATE, MegaTables,
                                build_mega_tables, primary_rays, run_path,
                                run_persistent, to_numpy)
from ..scene import scene as S
from ..scene.scene import SceneData
from ..sensor.sensor import PerspectiveCamera
from .path import PathTracer, initial_state

# the JAX package's megakernel limits (MEGA_FAMILIES, MEGA_EM_TYPES and
# the VMEM triangle budget), kept so supports() refuses what it refuses
_REF_FAMILIES = (frozenset(range(S.N_MAT_TYPES))
                 - {S.MAT_HK, S.MAT_TABULATED, S.MAT_IRAWAN})
_REF_EM_TYPES = frozenset({S.EM_AREA, S.EM_POINT, S.EM_CONSTANT,
                           S.EM_DIRECTIONAL, S.EM_SPOT})
_REF_MAX_TRIS = 32768
_EM_NAMES = {S.EM_POINT: "point", S.EM_CONSTANT: "constant",
             S.EM_DIRECTIONAL: "directional", S.EM_SPOT: "spot"}
# the JAX gate's isotropic-GGX microfacet families (mega.py:98-113)
_GGX_ONLY = ((S.MAT_ROUGH_DIELECTRIC, "roughdielectric"),
             (S.MAT_ROUGH_CONDUCTOR, "roughconductor"),
             (S.MAT_ROUGH_PLASTIC, "roughplastic"))


@dataclass(frozen=True, eq=False)
class MegaPathTracer(PathTracer):
    """eq=False: the tables are tensors, compared by identity. The JAX
    class's block, pblock and sublanes (TPU tile sizes) are dropped: a
    CUDA thread runs one lane, and the launch covers every lane."""
    tables: MegaTables | None = None

    @staticmethod
    def supports(scene: SceneData, camera=None, film=None
                 ) -> tuple[bool, str]:
        """(ok, reason): can this scene, camera and film run on the
        megakernel with results matching PathTracer and a box-filter
        Film? Where the JAX package refuses a scene this refuses it too;
        where the JAX package accepts a feature the port lacks, the reason
        is "<feature> not ported". The JAX arguments allow_medium and
        tex_procs belong to parts not ported (the medium branch,
        procedural textures)."""
        em_types = [int(t) for t in to_numpy(scene.em_type)]
        bad = set(em_types) - _REF_EM_TYPES
        if em_types.count(S.EM_CONSTANT) > 1 or bad:
            return False, f"unsupported emitter types {bad or 'env×2'}"
        fams = set(int(x) for x in np.unique(to_numpy(scene.mat_type)))
        if fams - _REF_FAMILIES:
            return False, f"unsupported BSDF families {fams - _REF_FAMILIES}"
        mp, mt = to_numpy(scene.mat_params), to_numpy(scene.mat_type)
        for code, name in _GGX_ONLY:
            rows = mp[mt == code]
            if (rows[:, 11] != 1).any() or (rows[:, 9] != rows[:, 10]).any():
                return False, f"non-GGX/anisotropic {name}"
        if bool(to_numpy(scene.has_medium)):
            return False, "participating medium"
        if (to_numpy(scene.mat_tex) >= 0).any() or (mp[:, 16] >= 0).any():
            return False, ("textured material (procedural checker/grid "
                           "textures not ported)")
        areas = to_numpy(scene.tri_area)
        n_real = int(np.max(np.nonzero(areas > 0)[0]) + 1) if \
            (areas > 0).any() else 1
        if n_real > _REF_MAX_TRIS:
            return False, f"{n_real} triangles exceed the VMEM budget"
        if camera is not None and not isinstance(camera, PerspectiveCamera):
            return False, "non-perspective camera"
        if film is not None and film.filter_name != "box":
            return False, f"{film.filter_name} reconstruction filter"
        # the JAX package accepts all of the above; the port's subset:
        for t in em_types:
            if t != S.EM_AREA:
                return False, f"{_EM_NAMES[t]} emitters not ported"
        if fams - LEAF_FAMILIES:
            return False, (f"BSDF families {sorted(fams - LEAF_FAMILIES)}"
                           " not ported")
        if camera is not None and camera.aperture_radius > 0.0:
            return False, "thin-lens camera not ported"
        return True, ""

    @classmethod
    def for_scene(cls, scene: SceneData, max_depth: int = 8,
                  rr_depth: int = 5) -> "MegaPathTracer":
        """Pack the scene's tables on its device (the GPU for a scene
        compiled with the default device). Raises NotImplementedError,
        with supports()'s reason, for a scene outside the subset."""
        ok, reason = cls.supports(scene)
        if not ok:
            raise NotImplementedError(f"MegaPathTracer: {reason}")
        return cls(max_depth=max_depth, rr_depth=rr_depth,
                   tables=build_mega_tables(scene))

    def li(self, scene: SceneData, o, d, seed, pixel_id, sample_idx=0):
        return self.li_stats(scene, o, d, seed, pixel_id, sample_idx)[0]

    def li_stats(self, scene: SceneData, o, d, seed, pixel_id,
                 sample_idx=0):
        """PathTracer.li_stats through run_path: (L [N, 3], traced-ray
        count as a 0-d int64 tensor)."""
        if scene is not self.tables.scene:
            raise ValueError("MegaPathTracer was built for another scene; "
                             "use MegaPathTracer.for_scene(scene)")
        n = o.shape[0]
        samp = torch.as_tensor(sample_idx, device=o.device)
        samp = samp.expand(n).to(torch.int32).contiguous()
        out = run_path(self.tables, self.rr_depth, self.max_depth,
                       self.max_depth, initial_state(o, d),
                       pixel_id.to(torch.int32).contiguous(), samp, seed)
        n_rays = out[16:18].to(torch.int64).sum()
        return out[9:12].T, n_rays


def render_persistent(integ: MegaPathTracer, camera, spp: int,
                      seed: int = 0):
    """Persistent path-regeneration render (accel/megakernel.py
    run_persistent): one lane per pixel, each completing exactly `spp`
    paths with in-kernel camera-ray regeneration. Runs on the device of
    the integrator's scene. Returns (image [H, W, 3], n_rays as a 0-d
    int64 tensor). Pinhole perspective cameras only."""
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
