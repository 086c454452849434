"""Compiled scene: flat structure-of-arrays tensors on one device (port of
mitsuba_tpu/scene/scene.py). Field names, shapes and codes are the JAX
package's, so a compiled JAX scene carries across array by array
(convert.scene_from_numpy)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.distribution import Discrete1D

# Material type codes (bsdf dispatch table, ref: EBSDFType bsdf.h:233).
# The port's BSDF module implements the 14 leaf families, codes 0-12 and
# 19 (bsdf.PORTED_FAMILIES); compile_scene rejects the composites and the
# other codes.
MAT_DIFFUSE = 0
MAT_CONDUCTOR = 1
MAT_ROUGH_CONDUCTOR = 2
MAT_DIELECTRIC = 3
MAT_PLASTIC = 4
MAT_ROUGH_DIELECTRIC = 5
MAT_ROUGH_PLASTIC = 6
MAT_PHONG = 7
MAT_WARD = 8
MAT_ROUGH_DIFFUSE = 9
MAT_NULL = 10
MAT_THIN_DIELECTRIC = 11
MAT_DIFFTRANS = 12
MAT_MIXTURE = 13
MAT_COATING = 14
MAT_HK = 15
MAT_TABULATED = 16
MAT_ROUGH_COATING = 17
MAT_IRAWAN = 18
MAT_ANISO_ROUGHDIFFUSE = 19
N_MAT_TYPES = 20

# Emitter type codes (ref: EEmitterType emitter.h:76); the port samples
# EM_AREA only.
EM_AREA = 0
EM_POINT = 1
EM_CONSTANT = 2
EM_ENVMAP = 3
EM_DIRECTIONAL = 4
EM_SPOT = 5

# mat_params[M, 24] row layout (see mitsuba_tpu/scene/scene.py):
# diffuse, rough diffuse: [0:3] albedo, [9] alpha
# conductors:       [0:3] eta, [3:6] k, [6:9] specular reflectance, [9]
#                   alpha_u, [10] alpha_v, [11] distribution (0 Beckmann,
#                   1 GGX)
# dielectrics (smooth, rough, thin): [0] int/ext ior ratio, [1:4] specular
#                   reflectance, [4:7] transmittance, [9:12] as conductors
# plastics (smooth, rough): [0] ior ratio, [1:4] diffuse reflectance, [4:7]
#                   specular reflectance, [7] nonlinear, [9:12] as above
# phong:            [0:3] diffuse refl, [3:6] spec refl, [6] exponent
# ward:             [0:3] diffuse refl, [3:6] spec refl, [9] alpha_u,
#                   [10] alpha_v
# difftrans:        [0:3] transmittance
# aniso_roughdiffuse: [0:3] albedo, [3:5] mean slope, [5:8] second
#                   moments, [11] sample visibility
# all:              [12] type code, [13] albedo-tex id, [14] roughness-tex
#                   id, [15] two-sided flag, [16] normal/bump-map tex id,
#                   [17] bump scale.
N_MAT_PARAMS = 24
N_MAT_TEX = 2


class Intersection(NamedTuple):
    """Wavefront hit record. All fields [N, ...]."""
    valid: torch.Tensor      # [N] bool
    t: torch.Tensor          # [N] hit distance
    p: torch.Tensor          # [N, 3] hit position (world)
    ng: torch.Tensor         # [N, 3] geometric normal
    ns: torch.Tensor         # [N, 3] interpolated shading normal
    uv: torch.Tensor         # [N, 2]
    tri_id: torch.Tensor     # [N] int64
    mat_id: torch.Tensor     # [N] int64
    em_id: torch.Tensor      # [N] int64 (-1 = not an emitter)


class SceneData(NamedTuple):
    """The compiled scene. T triangles (padded to a multiple of the cluster
    size with degenerate far-away triangles), M materials, E emitters, ET
    emissive triangles. Texture, environment and medium fields hold the
    same small placeholders the JAX builder makes for a scene without
    them."""
    # -- geometry --------------------------------------------------------
    p0: torch.Tensor         # [T, 3]
    e1: torch.Tensor         # [T, 3] p1 - p0
    e2: torch.Tensor         # [T, 3] p2 - p0
    ng: torch.Tensor         # [T, 3] unit geometric normal
    vn: torch.Tensor         # [T, 3, 3] per-corner shading normals
    vuv: torch.Tensor        # [T, 3, 2] per-corner uvs
    tri_mat: torch.Tensor    # [T] int32 material id
    tri_em: torch.Tensor     # [T] int32 emitter id (-1 none)
    tri_area: torch.Tensor   # [T]
    # -- Woop intersection transforms (accel/dense.py, accel/trace.py) ---
    woop_o: torch.Tensor     # [4, 3T] origin transform (affine)
    woop_d: torch.Tensor     # [3, 3T] direction transform (linear)
    woop_clusters: torch.Tensor  # [C, 3*64, 4] trace-kernel layout
    tri_attr: torch.Tensor   # [T, 24] ng | vn | vuv | mat | em | pad
    # -- materials -------------------------------------------------------
    mat_type: torch.Tensor   # [M] int32
    mat_params: torch.Tensor  # [M, N_MAT_PARAMS]
    mat_tex: torch.Tensor    # [M, N_MAT_TEX] int32
    # -- emitters --------------------------------------------------------
    em_type: torch.Tensor     # [E] int32
    em_radiance: torch.Tensor  # [E, 3]
    em_pos: torch.Tensor      # [E, 3]
    em_area: torch.Tensor     # [E] total surface area of area emitters
    em_pmf: Discrete1D        # emitter-selection distribution
    em_tri_offset: torch.Tensor  # [E+1] int32 segment offsets into em_tris
    em_tris: torch.Tensor     # [ET] int32 global triangle ids
    em_tri_cdfg: torch.Tensor  # [ET] emitter index + within-emitter cdf
    em_tri_data: torch.Tensor  # [max(ET,1), 12] packed p0|e1|e2|ng rows
    em_aux: torch.Tensor      # [E, 8]
    # -- textures (placeholders) -----------------------------------------
    tex_data: torch.Tensor    # [1, 3]
    tex_meta: torch.Tensor    # [1, 4] int32
    # -- environment (placeholders) --------------------------------------
    env_id: torch.Tensor      # scalar int32, -1 = no environment emitter
    env_img: torch.Tensor     # [1, 1, 3]
    env_row_cdf: torch.Tensor  # [2]
    env_col_cdf: torch.Tensor  # [1, 2]
    env_density: torch.Tensor  # [1, 1]
    # -- media (placeholders) --------------------------------------------
    med_sigma_t: torch.Tensor  # [1, 3]
    med_albedo: torch.Tensor   # [1, 3]
    med_g: torch.Tensor        # [1]
    med_bound: torch.Tensor    # [1]
    has_medium: torch.Tensor   # scalar bool
    med_grid: torch.Tensor       # [1, 1, 1]
    med_grid_min: torch.Tensor   # [3]
    med_grid_extent: torch.Tensor  # [3]
    med_majorant: torch.Tensor   # scalar
    med_sggx: torch.Tensor = None   # [6]
    med_fiber: torch.Tensor = None  # [3]
    env_alias: torch.Tensor = None  # always None in the port
    # per-cluster world AABBs [C, 8] (min xyz, max xyz, pad); padding
    # clusters hold inverted boxes
    cluster_aabb: torch.Tensor = None
    # front-to-back traversal tables (accel/trace.py build_cluster_order),
    # built for 8 <= C <= 128 clusters as in the JAX builder; the CUDA
    # kernel does not walk them yet
    cluster_meta: torch.Tensor = None    # [C, 8] f32
    cluster_order: torch.Tensor = None   # [C, C] i32
    cluster_odist: torch.Tensor = None   # [C, C] f32
    # real triangles: the padding that fills the last clusters follows
    # them and never hits, so the kernels' walk stops there
    # (accel/trace.py real_tris)
    n_real_tris: int = None

    @property
    def n_tris(self):
        return self.p0.shape[0]

    @property
    def n_emitters(self):
        return self.em_type.shape[0]

    @property
    def device(self):
        return self.p0.device
