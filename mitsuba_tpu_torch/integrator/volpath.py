"""Volumetric path tracer: surfaces and one global homogeneous medium
(port of mitsuba_tpu/integrator/volpath.py).

Per bounce the wavefront first samples a medium interaction against the
surface distance (media/homogeneous.py, the balance strategy), then each
lane takes the medium branch (HG-phase NEE and HG sampling) or the
surface branch (PathTracer's shading), both masked. NEE shadow rays are
attenuated by the medium's transmittance on top of surface occlusion
(ref: volpath.cpp:104-181, Scene::evalTransmittance).

The bounce is PathTracer's (integrator/path.py), over the same 16 state
rows; this class fills in its medium hooks (the event, NEE from the
scatter point, the transmittance, the HG continuation). Without a medium
the hooks do nothing and the bounce is PathTracer's with VolPathTracer's
ray count: as the JAX VolPathTracer, the active lanes and the unoccluded
NEE rays. The megakernel's plain version (accel/megakernel.py
MegaPlainTracer) overrides the medium terms (_segment, _phase_value,
_phase_sample) with the kernel's forms and counts attempted shadow rays.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..core.math import dot
from ..media.homogeneous import sample_distance, transmittance
from ..phase.phase import hg_eval, hg_sample
from ..scene.scene import SceneData
from .common import DIM_MEDIUM, DIM_PHASE
from .path import PathTracer


def scene_medium(scene: SceneData):
    """The scene's homogeneous medium as 8 floats (σt rgb, albedo rgb, g,
    bound), the JAX MegaVolPathTracer's `medium`, or None (a host read)."""
    if not bool(scene.has_medium):
        return None
    rows = torch.cat([scene.med_sigma_t[0], scene.med_albedo[0],
                      scene.med_g[:1], scene.med_bound[:1]])
    return tuple(float(x) for x in rows.tolist())


@dataclass(frozen=True)
class VolPathTracer(PathTracer):
    """volpath: PathTracer's fields; there is no fused shading tail
    (fused_shade must stay "off"). specialized_for also settles the
    scene's medium (`medium`, scene_medium's 8 floats or None)."""
    medium: tuple | None = dataclasses.field(default=None, init=False,
                                             repr=False)
    count_attempted = False
    # the JAX VolPathTracer's loop (volpath.py:47) has no compaction
    compacts = False

    def __post_init__(self):
        super().__post_init__()
        if self.fused_shade != "off":
            raise ValueError("VolPathTracer has no fused shading tail")

    def specialized_for(self, scene: SceneData, device=None):
        if self.settled:
            return self
        tracer = super().specialized_for(scene, device)
        object.__setattr__(tracer, "medium", self._settle_medium(scene))
        return tracer

    def _settle_medium(self, scene):
        return scene_medium(scene)

    def _medium_tensors(self, like):
        """(σt [3], albedo [3], g 0-d) as float32 tensors beside `like`."""
        m = torch.tensor(self.medium[:7], dtype=like.dtype,
                         device=like.device)
        return m[0:3], m[3:6], m[6]

    # ---- the medium terms (the JAX volpath forms) -------------------------
    def _segment(self, u, t_surf, active):
        """Distance sampling over the segment to the surface: (sampled
        [N] bool, t [N], the throughput's segment weight [N, 3]: w_medium
        on active sampled lanes, else w_surface)."""
        sigma_t, albedo, _ = self._medium_tensors(t_surf)
        ms = sample_distance(sigma_t, albedo, u[:, 0], u[:, 1], t_surf,
                             self.medium[7])
        in_medium = active & ms.sampled
        return ms.sampled, ms.t, torch.where(in_medium[:, None],
                                             ms.w_medium, ms.w_surface)

    def _phase_value(self, d, wo):
        """The HG value (= its pdf) toward wo at a scatter along d."""
        return hg_eval(self._medium_tensors(d)[2], dot(-d, wo))

    def _phase_sample(self, d, u2):
        """A direction sampled from HG at a scatter along d, and its pdf."""
        return hg_sample(self._medium_tensors(d)[2], -d, u2)

    # ---- PathTracer's medium hooks ----------------------------------------
    def _medium_event(self, o, d, its, throughput, active, d2):
        if self.medium is None:
            return throughput, None, None
        t_surf = torch.where(its.valid, its.t, 1e30)
        sampled, t_med, seg_w = self._segment(d2(DIM_MEDIUM), t_surf, active)
        return throughput * seg_w, active & sampled, o + t_med[:, None] * d

    def _medium_nee(self, v, f_nee, pdf_nee, so):
        if v.scatter is None:
            return f_nee, pdf_nee, so
        # the phase function toward the light, from the scatter point
        f_ph = self._phase_value(v.d, v.ds.d)
        sc = v.scatter[:, None]
        return (torch.where(sc, f_ph[:, None], f_nee),
                torch.where(v.scatter, f_ph, pdf_nee),
                torch.where(sc, v.p, so))

    def _medium_nee_weight(self, v, nee):
        if v.scatter is None:
            return nee
        sigma_t = self._medium_tensors(nee)[0]
        return nee * transmittance(sigma_t, v.ds.dist, self.medium[7])

    def _medium_continue(self, v, d_next, o_next, bs):
        if v.scatter is None:
            return d_next, o_next, bs
        # HG sampled exactly: the weight eval/pdf is 1
        d_ph, pdf_ph = self._phase_sample(v.d, v.d2(DIM_PHASE))
        sc = v.scatter
        return (torch.where(sc[:, None], d_ph, d_next),
                torch.where(sc[:, None], v.p, o_next),
                bs._replace(weight=torch.where(sc[:, None], 1.0, bs.weight),
                            pdf=torch.where(sc, pdf_ph, bs.pdf),
                            is_delta=bs.is_delta & ~sc,
                            eta=torch.where(sc, 1.0, bs.eta)))
