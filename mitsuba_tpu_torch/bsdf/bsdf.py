"""BSDFs in the local shading frame (port of the diffuse family of
mitsuba_tpu/bsdf/bsdf.py).

Conventions are the JAX package's: wi points toward the viewer; `eval`
returns f(wi, wo)·|cosθo|; `sample` returns (wo, weight = f·cos/pdf, pdf,
is_delta, eta). Per-lane results are selected by the material type code;
the port compiles only MAT_DIFFUSE, so other lanes (misses) get zeros.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.warp import (INV_PI, square_to_cosine_hemisphere,
                         square_to_cosine_hemisphere_pdf)
from ..scene import scene as S


class BSDFSample(NamedTuple):
    wo: torch.Tensor        # [N, 3] sampled direction (local frame)
    weight: torch.Tensor    # [N, 3] f·cos/pdf
    pdf: torch.Tensor       # [N] solid-angle pdf
    is_delta: torch.Tensor  # [N] bool
    eta: torch.Tensor       # [N] relative ior of the sampled event


class MatInfo(NamedTuple):
    """Resolved per-lane material row (no composites in the port)."""
    mtype: torch.Tensor     # [N] type code
    params: torch.Tensor    # [N, N_MAT_PARAMS]


def diffuse_eval(p, wi, wo):
    f = p[:, 0:3] * INV_PI * torch.clamp(wo[:, 2], min=0.0)[:, None]
    valid = (wi[:, 2] > 0) & (wo[:, 2] > 0)
    return torch.where(valid[:, None], f, 0.0)


def diffuse_pdf(p, wi, wo):
    valid = (wi[:, 2] > 0) & (wo[:, 2] > 0)
    return torch.where(valid, square_to_cosine_hemisphere_pdf(wo), 0.0)


def diffuse_sample(p, wi, u2, u1):
    wo = square_to_cosine_hemisphere(u2)
    pdf = square_to_cosine_hemisphere_pdf(wo)
    valid = wi[:, 2] > 0
    weight = torch.where(valid[:, None], p[:, 0:3], 0.0)
    return BSDFSample(wo, weight, torch.where(valid, pdf, 0.0),
                      torch.zeros_like(valid), torch.ones_like(pdf))


def resolve_material(scene: S.SceneData, mat_id) -> MatInfo:
    """One gather of the material rows (mat_id -1 reads row 0, as in the
    JAX package; such lanes are masked by the caller)."""
    params = scene.mat_params[torch.clamp(mat_id, min=0)]
    return MatInfo(params[:, 12].long(), params)


def perturb_shading_frame(scene: S.SceneData, mat: MatInfo, frame, uv):
    """Normal/bump-map frame perturbation: the identity, since the port's
    scenes carry no normal or bump maps (compile_scene rejects them)."""
    return frame


def eval_bsdf_ex(mat: MatInfo, wi, wo):
    is_diffuse = (mat.mtype == S.MAT_DIFFUSE)[:, None]
    return torch.where(is_diffuse, diffuse_eval(mat.params, wi, wo), 0.0)


def pdf_bsdf_ex(mat: MatInfo, wi, wo):
    is_diffuse = mat.mtype == S.MAT_DIFFUSE
    return torch.where(is_diffuse, diffuse_pdf(mat.params, wi, wo), 0.0)


def sample_bsdf_ex(mat: MatInfo, wi, u2, u1) -> BSDFSample:
    s = diffuse_sample(mat.params, wi, u2, u1)
    is_diffuse = mat.mtype == S.MAT_DIFFUSE
    return BSDFSample(
        wo=torch.where(is_diffuse[:, None], s.wo, 0.0),
        weight=torch.where(is_diffuse[:, None], s.weight, 0.0),
        pdf=torch.where(is_diffuse, s.pdf, 0.0),
        is_delta=s.is_delta, eta=s.eta)
