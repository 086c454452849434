"""The port's 14 leaf BSDF families against the JAX package on the CPU:
the builder's material rows, bsdf.py's eval/pdf/sample, the megakernel's
device-helper plain versions (accel/megakernel.py) and its rough-plastic
table rows, the fused shade kernel's plain version against the JAX kernel
body on the leaf-families scene, and `supports` on what stays unported.

Whole paths (the eager PathTracer and the megakernel's plain version on
small scenes of a few families each) are in test_torch_families_path.py.
Inputs are seeded numpy; tolerances are stated per test."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import leaf_families_camera, leaf_families_desc
from test_torch_shade import _compiled, _jax_kernel

from mitsuba_tpu.accel import megakernel as jmk
from mitsuba_tpu.bsdf import bsdf as jbsdf
from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.scene import shapes as jshapes
from mitsuba_tpu.scene.builder import Material as JMat
from mitsuba_tpu.scene.builder import SceneDesc as JDesc
from mitsuba_tpu.scene.builder import compile_scene as jcompile
from mitsuba_tpu_torch.accel import megakernel as tmk
from mitsuba_tpu_torch.accel import shade_kernel as tshade
from mitsuba_tpu_torch.bsdf import bsdf as tbsdf
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.integrator.mega import MegaPathTracer
from mitsuba_tpu_torch.integrator.path import PathTracer as TPath
from mitsuba_tpu_torch.integrator.path import initial_state
from mitsuba_tpu_torch.scene import shapes as tshapes
from mitsuba_tpu_torch.scene.builder import Material as TMat
from mitsuba_tpu_torch.scene.builder import SceneDesc as TDesc
from mitsuba_tpu_torch.scene.builder import compile_scene as tcompile
from mitsuba_tpu_torch.sensor.sensor import PerspectiveCamera

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
N = 512

# every leaf kind, with the options that change its branch
KINDS = {
    "diffuse": dict(kind="diffuse", albedo=(0.3, 0.6, 0.2)),
    "conductor": dict(kind="conductor"),
    "roughconductor": dict(kind="roughconductor", alpha=0.2),
    "dielectric": dict(kind="dielectric", int_ior=1.5),
    "plastic": dict(kind="plastic", diffuse_reflectance=(0.5, 0.2, 0.2)),
    "plastic-nonlinear": dict(kind="plastic", nonlinear=True, int_ior=1.3),
    "roughdielectric": dict(kind="roughdielectric", alpha=0.2, int_ior=1.5),
    "roughdielectric-beckmann": dict(kind="roughdielectric", alpha=0.3,
                                     distribution="beckmann"),
    "roughplastic": dict(kind="roughplastic", alpha=0.25,
                         diffuse_reflectance=(0.7, 0.2, 0.15)),
    "roughplastic-beckmann": dict(kind="roughplastic", alpha=0.3,
                                  distribution="beckmann", nonlinear=True),
    "phong": dict(kind="phong", diffuse_reflectance=(0.3, 0.4, 0.2),
                  specular_reflectance=(0.4, 0.4, 0.4), exponent=40.0),
    "ward": dict(kind="ward", diffuse_reflectance=(0.3, 0.3, 0.4),
                 specular_reflectance=(0.3, 0.3, 0.3), alpha=0.15,
                 alpha_v=0.3),
    "roughdiffuse": dict(kind="roughdiffuse", albedo=(0.6, 0.5, 0.4),
                         alpha=0.4),
    "null": dict(kind="null"),
    "thindielectric": dict(kind="thindielectric", int_ior=1.5),
    "difftrans": dict(kind="difftrans", transmittance=(0.6, 0.5, 0.4)),
    "aniso_roughdiffuse": dict(kind="aniso_roughdiffuse",
                               albedo=(0.6, 0.55, 0.2), moments0=(0.2, 0.0),
                               moments1=(0.2, 0.03, 0.0)),
    "aniso_roughdiffuse-novis": dict(kind="aniso_roughdiffuse",
                                     moments0=(0.15, -0.1),
                                     moments1=(0.55, 0.4, 0.05),
                                     sample_visibility=False),
}
# the megakernel's microfacet branches are isotropic GGX
GGX_KINDS = sorted(k for k in KINDS if "beckmann" not in k)


def _dirs(rs, n):
    """Unit directions, the first half above the surface."""
    d = rs.randn(n, 3)
    d[:n // 2, 2] = np.abs(d[:n // 2, 2])
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _close(a, b):
    """Deterministic outputs: >= 99% of the lanes within rel 1e-5 / abs
    1e-6, every lane within rel 1e-4 / abs 1e-5 (an ulp of rsqrt, exp or
    log between XLA's and PyTorch's CPU math libraries, amplified by a
    grazing 1/cosθ, as LEADR's 1/max(wi·n, 1e-7) does)."""
    a = np.asarray(a, np.float32).reshape(N, -1)
    b = np.asarray(b, np.float32).reshape(N, -1)
    assert np.isclose(a, b, rtol=RTOL, atol=ATOL).all(-1).mean() >= 0.99
    np.testing.assert_allclose(a, b, rtol=10 * RTOL, atol=10 * ATOL)


def _close_sampled(outs_t, outs_j, pdf_j):
    """Sampled outputs: the warps' sin, cos, exp and log differ by an ulp
    between XLA's and PyTorch's CPU math libraries, and the sampled
    direction carries that into f/pdf, most of all where wi lies below
    the surface and the sample is discarded. So on >= 99% of the lanes
    whose JAX pdf is positive every output is within rel 1e-5 / abs 1e-6,
    and every output of every lane is within abs 1e-4 (rel 1e-3 above
    0.1)."""
    ok = np.ones(N, bool)
    for t, j in zip(outs_t, outs_j):
        t = np.asarray(t, np.float32).reshape(N, -1)
        j = np.asarray(j, np.float32).reshape(N, -1)
        ok &= np.isclose(t, j, rtol=RTOL, atol=ATOL).all(-1)
        np.testing.assert_allclose(t, j, rtol=1e-3, atol=1e-4)
    used = np.asarray(pdf_j) > 0
    assert used.sum() > N // 8
    assert ok[used].mean() >= 0.99, ok[used].mean()


# ---------------------------------------------------------------------------
# the builder's rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(KINDS))
def test_material_rows_match_jax(kind):
    """Type code, parameter row and texture slots equal the JAX builder's,
    one-sided and two-sided."""
    for two_sided in (False, True):
        t = TMat(**KINDS[kind], two_sided=two_sided).compile()
        j = JMat(**KINDS[kind], two_sided=two_sided).compile()
        assert t[0] == j[0]
        assert np.array_equal(t[1], j[1]) and np.array_equal(t[2], j[2])


def test_rough_plastic_table_rows_match_jax():
    """build_mega_tables' 69 material columns, the rough-plastic
    transmittance rows RTROW.. included, equal the JAX packer's (a GGX
    and a nonlinear one of another ior and roughness)."""
    def desc(desc_cls, tf, shapes):
        d = desc_cls()
        for kw in (KINDS["roughplastic"],
                   dict(kind="roughplastic", alpha=0.4, int_ior=1.33,
                        nonlinear=True, diffuse_reflectance=(0.1, 0.3, 0.5))):
            d.add_shape(shapes.sphere(4, 8), material=d.add_material(**kw))
        d.add_shape(shapes.rectangle(), material=0, radiance=(1, 1, 1),
                    to_world=tf.translate([0, 3, 0]))
        return d
    jscene = jcompile(desc(JDesc, jtf, jshapes))
    tt = tmk.build_mega_tables(tcompile(desc(TDesc, ttf, tshapes),
                                        device="cpu"))
    jmat = np.asarray(jmk.build_mega_tables(jscene).mat)[:, :2].T
    assert tt.mat.shape == (2, tmk.N_MAT) == jmat.shape
    assert (tt.mat[:, tmk.RTROW + 1:tmk.RTROW + 33] > 0.1).all()
    np.testing.assert_array_equal(tt.mat.numpy(), jmat)


# ---------------------------------------------------------------------------
# bsdf.py: eval, pdf and sample of each family
# ---------------------------------------------------------------------------

def _bsdf_inputs(kind, two_sided):
    code, row, _ = TMat(**KINDS[kind], two_sided=two_sided).compile()
    rs = np.random.RandomState(sorted(KINDS).index(kind) + 31 * two_sided)
    wi, wo = _dirs(rs, N), _dirs(rs, N)
    u2 = rs.rand(N, 2).astype(np.float32)
    u1 = rs.rand(N).astype(np.float32)
    return code, np.tile(row, (N, 1)), wi, wo, u2, u1


# the two-sided adapter wraps every family alike: once for each kind of
# lobe (diffuse, glossy, delta, transmissive)
TWO_SIDED = ("aniso_roughdiffuse", "phong", "plastic", "roughdielectric",
             "difftrans")


@pytest.mark.parametrize("kind,two_sided",
                         [(k, False) for k in sorted(KINDS)]
                         + [(k, True) for k in TWO_SIDED])
def test_eager_family_matches_jax(kind, two_sided):
    """eval/pdf/sample_bsdf_ex of one family on one material row per
    lane, wi on both sides of the surface: eval and pdf by the
    deterministic rule, the sample by the sampled rule."""
    code, params, wi, wo, u2, u1 = _bsdf_inputs(kind, two_sided)
    mt = np.full(N, code, np.int32)
    fams = (code,)
    jm = jbsdf.MatInfo(*(jnp.asarray(x) for x in (mt, params) * 3),
                       jnp.ones(N))
    tm = tbsdf.MatInfo(torch.as_tensor(mt).long(), torch.as_tensor(params))
    J = [jnp.asarray(x) for x in (wi, wo, u2, u1)]
    T = [torch.as_tensor(x) for x in (wi, wo, u2, u1)]
    _close(tbsdf.eval_bsdf_ex(tm, T[0], T[1], fams),
           jbsdf.eval_bsdf_ex(jm, J[0], J[1], fams))
    _close(tbsdf.pdf_bsdf_ex(tm, T[0], T[1], fams),
           jbsdf.pdf_bsdf_ex(jm, J[0], J[1], fams))
    ts = tbsdf.sample_bsdf_ex(tm, T[0], T[2], T[3], fams)
    js = jbsdf.sample_bsdf_ex(jm, J[0], J[2], J[3], fams)
    names = ("wo", "weight", "pdf", "eta")
    _close_sampled([getattr(ts, k) for k in names],
                   [getattr(js, k) for k in names], js.pdf)
    assert np.array_equal(ts.is_delta.numpy(), np.asarray(js.is_delta))
    assert (ts.weight != 0).any()


# ---------------------------------------------------------------------------
# the megakernel's device helpers: plain versions against the JAX helpers
# ---------------------------------------------------------------------------

def _table_row(kind):
    """The kind's 69-column material row of build_mega_tables."""
    code, row, _ = TMat(**KINDS[kind]).compile()
    full = np.zeros(tmk.N_MAT, np.float32)
    full[:24] = row
    full[tmk.TEXROW] = -1.0
    if code == 6:
        full[tmk.RTROW:] = tmk._rough_plastic_rows(row)
    return code, full


@pytest.mark.parametrize("kind", GGX_KINDS)
def test_helper_twins_match_jax(kind):
    """bsdf_eval_pdf and bsdf_sample against the JAX megakernel's
    _bsdf_eval_pdf and _bsdf_sample, called as jnp functions over the same
    material rows (a mat_param closure): eval by the deterministic rule,
    the sample by the sampled rule, is_delta equal."""
    code, full = _table_row(kind)
    rs = np.random.RandomState(sorted(KINDS).index(kind) + 7)
    wi, wo = _dirs(rs, N), _dirs(rs, N)
    u = rs.rand(3, N).astype(np.float32)
    mat = np.tile(full[:, None], (1, N))
    fams = (code,)

    def jax_helpers(m, wix, wiy, wiz, wox, woy, woz, u0, u1, uc):
        mp = lambda j: m[j]
        return (jmk._bsdf_eval_pdf(fams, mp, m[12], wix, wiy, wiz, wox, woy,
                                   woz),
                jmk._bsdf_sample(fams, mp, m[12], wix, wiy, wiz, u0, u1, uc))
    args = (mat, wi[:, 0], wi[:, 1], wi[:, 2], wo[:, 0], wo[:, 1], wo[:, 2],
            u[0], u[1], u[2])
    je, js = _compiled(jax_helpers, *map(jnp.asarray, args))(
        *map(jnp.asarray, args))
    T = [torch.as_tensor(x) for x in args]
    te = tmk.bsdf_eval_pdf(*T[:7])
    ts = tmk.bsdf_sample(T[0], *T[1:4], *T[7:])
    for t, j in zip(te, je):
        _close(t, j)
    _close_sampled([*ts[:7], ts[8]], [*js[:7], js[8]], js[6])
    assert np.array_equal(ts[7].numpy(), np.asarray(js[7]))
    assert any((x != 0).any() for x in ts[3:6])


# ---------------------------------------------------------------------------
# the fused shade kernel's plain version against the JAX kernel body
# ---------------------------------------------------------------------------

SHADE_N, SHADE_RES = 1024, 32


@pytest.mark.parametrize("bounce", [0, 2])
def test_shade_plain_matches_jax_kernel_on_leaf_scene(bounce):
    """shade_plain against the JAX shade kernel body (Pallas interpret
    mode, dispatching the 13 families) on one bounce of the port's eager
    pass over the leaf-families scene at sphere(6, 12), every material
    two-sided and rough plastic swapped for plastic (the JAX kernel's
    input lacks rough plastic's rows): every row within rel 1e-5 / abs
    1e-6 on >= 99.5% of the lanes active on entry and within rel 1e-3 /
    abs 1e-4 on all of them (the phong and ward samplers carry an ulp of
    XLA's CPU sin, cos, exp or log past 1e-5 on the odd lane: one of the
    ~240 live at bounce 2), alive and prev_delta equal on >= 99.5% of
    them, L within rel 1e-5 / abs 1e-6 on every lane."""
    args = ((6, 12), False, True)
    jscene = jcompile(leaf_families_desc(JDesc, jtf, jshapes, *args))
    tscene = tcompile(leaf_families_desc(TDesc, ttf, tshapes, *args),
                      device="cpu")
    assert tshade.supports(tscene) == (True, "")
    cam = leaf_families_camera(PerspectiveCamera, ttf, SHADE_RES)
    pix = torch.arange(SHADE_N, dtype=torch.int32)
    samp = torch.full((SHADE_N,), 1, dtype=torch.int32)
    tracer = TPath(max_depth=6).specialized_for(tscene)
    st = initial_state(*tmk.primary_rays(cam, 9, pix, 1))
    for b in range(bounce):
        st = tracer.bounce(tscene, st, 9, pix, samp, b)[0]
    packed = tracer.shade_inputs(tscene, st, 9, pix, samp, bounce)
    act = packed[tshade.I_ACT].numpy() > 0.5
    t = tshade.shade_plain(tscene, packed, pix, samp, 9, bounce, 5, 6).numpy()
    fams = tuple(sorted(tmk.SHADE_FAMILIES))
    j = _jax_kernel(jscene, packed.numpy(), pix.numpy(), samp.numpy(),
                    bounce, fams)
    mtypes = set(packed[tshade.I_MAT + 12][torch.as_tensor(act)].tolist())
    assert len(mtypes) >= 8, mtypes
    ok = np.isclose(t, j, rtol=RTOL, atol=ATOL)
    assert ok[:, act].all(0).mean() >= 0.995, ok[:, act].mean(1)
    np.testing.assert_allclose(t[:, act], j[:, act], rtol=1e-3, atol=1e-4)
    for row in (12, 14):
        assert (t[row, act] == j[row, act]).mean() >= 0.995, row
    assert ok[9:12].all()


# ---------------------------------------------------------------------------
# supports(): what stays unported, with reasons
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def leaf_scene():
    return tcompile(leaf_families_desc(TDesc, ttf, tshapes, (4, 8)),
                    device="cpu")


def _retyped(scene, code, col=None, value=None):
    """The scene with material 1 turned into type `code` (and one of its
    columns set)."""
    mt, mp = scene.mat_type.clone(), scene.mat_params.clone()
    mt[1], mp[1, 12] = code, float(code)
    if col is not None:
        mp[1, col] = value
    return scene._replace(mat_type=mt, mat_params=mp)


def test_supports_accepts_leaf_scenes(leaf_scene):
    """The megakernel takes the leaf-families scene (all 14 families, a
    two-sided pane, smooth spheres); the shade kernel takes it with rough
    plastic swapped out and every material two-sided."""
    assert MegaPathTracer.supports(leaf_scene) == (True, "")
    assert tmk.LEAF_FAMILIES == set(leaf_scene.mat_type.tolist())
    swapped = tcompile(leaf_families_desc(TDesc, ttf, tshapes, (4, 8),
                                          False, True), device="cpu")
    assert tshade.supports(swapped) == (True, "")
    assert MegaPathTracer.supports(swapped) == (True, "")


@pytest.mark.parametrize("case,reason", [
    ("rough plastic", "rough plastic: the kernel's input rows"),
    ("mixture", "composite BSDF families [13] (mixture)"),
    ("coating", "composite BSDF families [14] (coating)"),
    ("rough coating", "composite BSDF families [17] (rough coating)"),
    ("beckmann rough dielectric", "non-GGX/anisotropic rough dielectric"),
    ("anisotropic rough conductor", "anisotropic rough conductor"),
])
def test_shade_supports_refuses(leaf_scene, case, reason):
    """The shade kernel turns away rough plastic, the composites (no
    branch in the JAX kernel) and non-GGX or anisotropic microfacets, and
    PathTracer(fused_shade="on") raises with that reason."""
    base = tcompile(leaf_families_desc(TDesc, ttf, tshapes, (4, 8), False),
                    device="cpu")
    scene = {"rough plastic": leaf_scene,
             "mixture": _retyped(base, 13), "coating": _retyped(base, 14),
             "rough coating": _retyped(base, 17),
             "beckmann rough dielectric": _retyped(base, 5, 11, 0.0),
             "anisotropic rough conductor": _retyped(base, 2, 10, 0.05),
             }[case]
    ok, why = tshade.supports(scene)
    assert not ok and why.startswith(reason), why
    with pytest.raises(NotImplementedError, match="fused_shade='on'"):
        TPath(fused_shade="on").specialized_for(scene)


@pytest.mark.parametrize("case,reason", [
    ("mixture", "BSDF families [13] not ported"),
    ("point", "point emitters not ported"),
    ("spot", "spot emitters not ported"),
    ("directional", "directional emitters not ported"),
    ("constant", "constant emitters not ported"),
    ("thin lens", "thin-lens camera not ported"),
    ("texture", "textured material (procedural checker/grid textures not "
                "ported)"),
    ("beckmann rough plastic", "non-GGX/anisotropic roughplastic"),
    ("beckmann rough dielectric", "non-GGX/anisotropic roughdielectric"),
    ("anisotropic rough conductor", "non-GGX/anisotropic roughconductor"),
])
def test_mega_supports_refuses(leaf_scene, case, reason):
    """MegaPathTracer refuses the composites, delta and constant lights,
    the thin lens and (procedural) textures as "not ported" (the JAX
    package has them), and the non-GGX or anisotropic microfacet variants
    as the JAX gate does."""
    em = {"point": 1, "spot": 5, "directional": 4, "constant": 2}
    cam = None
    if case in em:
        scene = leaf_scene._replace(
            em_type=torch.full_like(leaf_scene.em_type, em[case]))
    elif case == "texture":
        scene = leaf_scene._replace(
            mat_tex=torch.full_like(leaf_scene.mat_tex, 0))
    elif case == "thin lens":
        scene = leaf_scene
        c = leaf_families_camera(PerspectiveCamera, ttf, 8)
        cam = PerspectiveCamera(8, 8, c.fov_x, c.to_world,
                                aperture_radius=0.1)
    else:
        scene = {"mixture": _retyped(leaf_scene, 13),
                 "beckmann rough plastic": _retyped(leaf_scene, 6, 11, 0.0),
                 "beckmann rough dielectric": _retyped(leaf_scene, 5, 11,
                                                       0.0),
                 "anisotropic rough conductor": _retyped(leaf_scene, 2, 10,
                                                         0.05)}[case]
    assert MegaPathTracer.supports(scene, cam) == (False, reason)
    if cam is None:
        with pytest.raises(NotImplementedError, match=re.escape(reason)):
            MegaPathTracer.for_scene(scene)
