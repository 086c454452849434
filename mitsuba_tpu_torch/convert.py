"""Carry a compiled scene across from numpy arrays.

`scene_from_numpy` takes one array per SceneData field (em_pmf as a dict of
its pmf/cdf/total arrays), for example a compiled JAX scene's fields
converted with np.asarray, so both packages trace the same arrays: the
texel pool and its meta rows and the environment image's tables (its
alias table included) come across as they are. The procedural provenance
of checker and grid textures is not a scene field: it stays the plain
dict of the scene description (SceneDesc.tex_procs), which
MegaPathTracer.for_scene takes as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from .accel.trace import padding_start
from .bsdf.bsdf import PORTED_FAMILIES
from .core.distribution import Discrete1D
from .device import resolve_device
from .scene import scene as S


def _check_supported(a: dict):
    """Reject scenes that use what the port does not implement."""
    problems = []
    fams = set(np.unique(np.asarray(a["mat_type"])).tolist()) - set(
        PORTED_FAMILIES)
    if fams:
        problems.append(f"BSDF families {sorted(fams)}")
    if bool(np.asarray(a["has_medium"])):
        # a homogeneous medium only: a one-voxel grid and all-zero SGGX
        # and fiber rows (the JAX megakernel gate, integrator/mega.py)
        if np.asarray(a["med_grid"]).size != 1:
            problems.append("heterogeneous medium")
        if any(a.get(k) is not None and np.any(np.asarray(a[k]))
               for k in ("med_sggx", "med_fiber")):
            problems.append("anisotropic (SGGX/fiber) medium")
    if problems:
        raise NotImplementedError(f"scene uses features not ported: "
                                  f"{problems}")


def scene_from_numpy(arrays: dict, device="cuda") -> S.SceneData:
    """SceneData on `device` from a dict of numpy arrays keyed by field
    name; missing optional fields and None values stay None, but for
    n_real_tris, which a missing value derives from the Woop table (the
    triangles before its trailing padding, trace.padding_start)."""
    dev = resolve_device(device)
    _check_supported(arrays)
    fields = {}
    for name in S.SceneData._fields:
        value = arrays.get(name)
        if name == "n_real_tris":
            fields[name] = None if value is None else int(value)
        elif value is None:
            fields[name] = None
        elif name == "em_pmf":
            fields[name] = Discrete1D(*(
                torch.tensor(np.asarray(value[k]), device=dev)
                for k in Discrete1D._fields))
        else:
            fields[name] = torch.tensor(np.asarray(value), device=dev)
    if fields["n_real_tris"] is None and fields["woop_clusters"] is not None:
        fields["n_real_tris"] = padding_start(fields["woop_clusters"])
    return S.SceneData(**fields)
