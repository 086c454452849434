"""The port's composite BSDFs (mixturebsdf, blendbsdf, mask, coating,
roughcoating) against the JAX package on the CPU: the builder's rows, the
MatInfo-aware eval/pdf/sample_bsdf_ex per lane, the eager PathTracer on
the composites recipes of tests/test_mega_tpu.py (:639-751), the
megakernel's plain versions (MegaPathTracer on CPU tensors) against the
eager path, and MegaPathTracer.supports against the JAX gate. Inputs come
from numpy seeds; the JAX side runs its XLA path."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import lights_composites_desc
from test_torch_families import _close_sampled, _dirs
from test_torch_lights import (PKG, _compile, _image_rule, jax_li,
                               torch_li)
from test_torch_shade import _compiled

from mitsuba_tpu.bsdf import bsdf as jbsdf
from mitsuba_tpu.integrator.mega import MegaPathTracer as JMega
from mitsuba_tpu.scene.builder import Material as JMat
from mitsuba_tpu_torch.bsdf import bsdf as tbsdf
from mitsuba_tpu_torch.film.film import Film
from mitsuba_tpu_torch.integrator.mega import (MegaPathTracer,
                                               render_persistent)
from mitsuba_tpu_torch.integrator.path import PathTracer as TPath
from mitsuba_tpu_torch.render import render_fn
from mitsuba_tpu_torch.scene.builder import Material as TMat
from mitsuba_tpu_torch.sensor.sensor import PerspectiveCamera

torch.set_num_threads(2)

N = 4096
# each composite kind with its children, as (kind, its fields, children):
# a child is a material description, named by its index in the list
COMPOSITES = {
    "mixture": ("mixturebsdf", dict(weight=0.6),
                [dict(kind="diffuse", albedo=(0.7, 0.3, 0.2)),
                 dict(kind="roughconductor", alpha=0.2)]),
    "mixture_delta": ("mixturebsdf", dict(weight=0.5),
                      [dict(kind="dielectric", int_ior=1.5),
                       dict(kind="diffuse", albedo=(0.7, 0.3, 0.2))]),
    "blend": ("blendbsdf", dict(weight=0.3),
              [dict(kind="plastic", diffuse_reflectance=(0.2, 0.3, 0.6)),
               dict(kind="roughdiffuse", albedo=(0.6, 0.5, 0.4),
                    alpha=0.4)]),
    "mask": ("mask", dict(weight=0.4),
             [dict(kind="diffuse", albedo=(0.7, 0.3, 0.2))]),
    "coating": ("coating", dict(int_ior=1.5, sigma_a=(0.1, 0.15, 0.2),
                                thickness=1.0),
                [dict(kind="diffuse", albedo=(0.6, 0.25, 0.2))]),
    "coating_ggx": ("coating", dict(int_ior=1.49),
                    [dict(kind="roughconductor", alpha=0.25)]),
    "roughcoating": ("roughcoating", dict(int_ior=1.5, alpha=0.1,
                                          sigma_a=(0.05, 0.08, 0.1)),
                     [dict(kind="diffuse", albedo=(0.55, 0.2, 0.15))]),
}


def _all_composites(pkg, names=None):
    """The COMPOSITES entries `names` (None: all) as materials, each after
    its children, each on a small sphere under a rectangle light; returns
    the description and {name: the composite's row}."""
    builder, tf, shapes, _ = PKG[pkg]
    d = builder.SceneDesc()
    rows = {}
    for name in names or COMPOSITES:
        kind, kw, kids = COMPOSITES[name]
        ids = [d.add_material(**k) for k in kids]
        ab = dict(child_a=ids[0], child_b=ids[-1] if len(ids) > 1 else -1)
        rows[name] = d.add_material(kind=kind, **kw, **ab)
        d.add_shape(shapes.sphere(4, 8), material=rows[name])
    d.add_shape(shapes.rectangle(), material=0, radiance=(1.0, 1.0, 1.0),
                to_world=tf.translate([0, 3, 0]))
    return d, rows


@pytest.mark.parametrize("name", sorted(COMPOSITES))
def test_composite_rows_match_jax(name):
    """A scene of the composite and its children compiles to the JAX
    builder's material rows and codes bit for bit, the mask's implicit
    null child (appended, its slot patched) included."""
    j = _compile("jax", _all_composites("jax", [name])[0])
    t = _compile("torch", _all_composites("torch", [name])[0])
    assert np.array_equal(t.mat_type.numpy(), np.asarray(j.mat_type))
    assert np.array_equal(t.mat_params.numpy(), np.asarray(j.mat_params))
    assert np.array_equal(t.mat_tex.numpy(), np.asarray(j.mat_tex))
    if name == "mask":
        mp = t.mat_params.numpy()
        assert mp[int(mp[-2, 19]), 12] == 10 == mp[-1, 12]


def test_composite_material_compile_matches_jax():
    """Material.compile of each composite kind (children by index) equals
    the JAX builder's, two-sided too."""
    for kind, kw, _ in COMPOSITES.values():
        for two_sided in (False, True):
            t = TMat(kind=kind, child_a=0, child_b=1, two_sided=two_sided,
                     **kw).compile()
            j = JMat(kind=kind, child_a=0, child_b=1, two_sided=two_sided,
                     **kw).compile()
            assert t[0] == j[0]
            assert np.array_equal(t[1], j[1]) and np.array_equal(t[2], j[2])


@pytest.fixture(scope="module")
def bsdf_pair():
    """eval/pdf/sample_bsdf_ex of every composite on N lanes (each lane one
    composite, with seeded wi, wo on both sides and uniforms), by both
    packages: ({output: (port, jax)}, the lanes' composite names). The
    JAX side compiles once."""
    (dj, rows), (dt, _) = _all_composites("jax"), _all_composites("torch")
    j, t = _compile("jax", dj), _compile("torch", dt)
    rs = np.random.RandomState(23)
    names = sorted(COMPOSITES)
    pick = rs.randint(0, len(names), N)
    mid = np.array([rows[names[k]] for k in pick], np.int32)
    wi, wo = _dirs(rs, N), _dirs(rs, N)
    u2 = rs.rand(N, 2).astype(np.float32)
    u1 = rs.rand(N).astype(np.float32)
    fams = tuple(sorted(set(np.asarray(j.mat_type).tolist())))

    def ref(sc, mid, wi, wo, u2, u1):
        mat = jbsdf.resolve_material(sc, mid, families=fams)
        return (jbsdf.eval_bsdf_ex(mat, wi, wo, fams),
                jbsdf.pdf_bsdf_ex(mat, wi, wo, fams),
                jbsdf.sample_bsdf_ex(mat, wi, u2, u1, fams))

    args = (j, *(jnp.asarray(x) for x in (mid, wi, wo, u2, u1)))
    jf, jp, js = _compiled(ref, *args)(*args)
    mat = tbsdf.resolve_material(t, torch.as_tensor(mid).long(),
                                 families=fams)
    T = [torch.as_tensor(x) for x in (wi, wo, u2, u1)]
    tf = tbsdf.eval_bsdf_ex(mat, T[0], T[1], fams)
    tp = tbsdf.pdf_bsdf_ex(mat, T[0], T[1], fams)
    ts = tbsdf.sample_bsdf_ex(mat, T[0], T[2], T[3], fams)
    outs = {"eval": (tf, jf), "pdf": (tp, jp)}
    for k in ("wo", "weight", "pdf", "eta", "is_delta"):
        outs[f"sample {k}"] = (getattr(ts, k), getattr(js, k))
    return outs, np.array(names)[pick]


@pytest.mark.parametrize("name", sorted(COMPOSITES))
def test_bsdf_ex_matches_jax(bsdf_pair, name):
    """The composite's lanes: eval and pdf within rtol 1e-5 / atol 1e-6,
    the sample under the share-of-lanes rule of test_torch_families
    (>= 99% of the lanes whose JAX pdf is positive within rel 1e-5 /
    abs 1e-6, every lane within abs 1e-4, rel 1e-3 above 0.1), the delta
    flag exactly."""
    outs, lane_names = bsdf_pair
    sel = lane_names == name
    for k in ("eval", "pdf"):
        t, j = outs[k]
        np.testing.assert_allclose(t.numpy()[sel], np.asarray(j)[sel],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert (outs["eval"][0].numpy()[sel] > 0).any()
    t, j = outs["sample is_delta"]
    assert np.array_equal(t.numpy()[sel], np.asarray(j)[sel])
    names = ("wo", "weight", "pdf", "eta")
    t_s = [outs[f"sample {k}"][0].numpy()[sel] for k in names]
    j_s = [np.asarray(outs[f"sample {k}"][1])[sel] for k in names]
    _close_sampled(t_s, j_s, j_s[2])


def _composites_scene(pkg):
    """The union of tests/test_mega_tpu.py:639-751's composites: diffuse +
    GGX and glass + diffuse mixtures, a mask pane, coatings over diffuse
    and over GGX and a rough coating over diffuse, under a rectangle
    light, placed as in lights_composites_desc."""
    builder, tf, shapes, _ = PKG[pkg]
    d = builder.SceneDesc()
    m = d.add_material
    dif, ggx = m(kind="diffuse", albedo=(0.7, 0.3, 0.2)), \
        m(kind="roughconductor", alpha=0.2)
    glass = m(kind="dielectric", int_ior=1.5)
    spheres = [
        m(kind="mixturebsdf", child_a=dif, child_b=ggx, weight=0.6),
        m(kind="mixturebsdf", child_a=glass, child_b=dif, weight=0.5),
        m(kind="coating", child_a=m(kind="diffuse", albedo=(0.6, 0.25, 0.2)),
          int_ior=1.5, sigma_a=(0.1, 0.15, 0.2), thickness=1.0),
        m(kind="coating", child_a=m(kind="roughconductor", alpha=0.25),
          int_ior=1.49),
        m(kind="roughcoating", child_a=m(kind="diffuse",
                                          albedo=(0.55, 0.2, 0.15)),
          int_ior=1.5, alpha=0.1, sigma_a=(0.05, 0.08, 0.1))]
    floor = m(kind="diffuse", albedo=(0.5, 0.5, 0.55))
    d.add_shape(shapes.rectangle(), material=floor,
                to_world=tf.translate([0, -1, 0]) @ tf.rotate([1, 0, 0], -90)
                @ tf.scale([6] * 3))
    for i, mat in enumerate(spheres):
        d.add_shape(shapes.sphere(6, 12), material=mat,
                    to_world=tf.translate([1.4 * i - 2.8, -0.4, -0.5])
                    @ tf.scale([0.6] * 3))
    d.add_shape(shapes.rectangle(), material=m(kind="mask", child_a=dif,
                                               weight=0.4),
                to_world=tf.translate([0.7, 0.2, 0.6]) @ tf.scale([0.5] * 3))
    d.add_shape(shapes.rectangle(), material=floor,
                radiance=(13.0, 12.0, 11.0),
                to_world=tf.translate([0, 4, 0]) @ tf.rotate([1, 0, 0], 90)
                @ tf.scale([2.0] * 3))
    return d


CAMERA = dict(origin=[0.0, 1.5, 6.5], target=[0, -0.4, -1], up=[0, 1, 0])


def test_path_matches_jax_composites():
    """The eager PathTracer, and MegaPathTracer's plain version, against
    the JAX PathTracer at 32², 4 spp, max_depth 8, on the composites
    scene: the image rule and ray counts within rel 1e-4."""
    from mitsuba_tpu_torch.core import transform as ttf
    jscene = _compile("jax", _composites_scene("jax"))
    tscene = _compile("torch", _composites_scene("torch"))
    cam = PerspectiveCamera(32, 32, 45.0, ttf.look_at(**CAMERA))
    jL, jn = jax_li(jscene, tscene, cam)
    assert np.isfinite(jL).all() and jL.mean() > 0.01
    for integ in (TPath(max_depth=8),
                  MegaPathTracer.for_scene(tscene, max_depth=8)):
        L, n = torch_li(integ, tscene, cam)
        _image_rule(L, jL)
        assert abs(n - jn) <= 1e-4 * jn, (n, jn)


def test_mega_equals_path_composites():
    """On the CPU MegaPathTracer.li_stats and render_persistent (their
    plain versions, the JAX megakernel's composite forms) equal the
    port's PathTracer (bsdf.py's forms) within rtol 1e-4 / atol 1e-5 on
    the lights-and-composites scene at 16², 2 spp, counts exactly."""
    from mitsuba_tpu_torch.core import transform as ttf
    scene = _compile("torch", lights_composites_desc(
        *PKG["torch"][:3], (6, 12)))
    cam = PerspectiveCamera(16, 16, 45.0, ttf.look_at(**CAMERA))
    integ = MegaPathTracer.for_scene(scene, max_depth=8)
    args = (scene, cam, Film(16, 16, "box"))
    img_e, n_e = render_fn(*args, TPath(max_depth=8), 2, 5, "cpu")
    img_m, n_m = render_fn(*args, integ, 2, 5, "cpu")
    img_p, n_p = render_persistent(integ, cam, 2, 5)
    assert int(n_e) == int(n_m) == int(n_p) > 0
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(img_m.numpy(), img_e.numpy(), **tol)
    np.testing.assert_allclose(img_p.numpy(), img_e.numpy(), **tol)


def _gate_cases():
    """(name, scene edits) of the six scenes the JAX gate refuses."""
    def nested(s):
        mp, mt = s.mat_params.clone(), s.mat_type.clone()
        mix = int((mt == 13).nonzero()[0])
        mp[mix, 18] = float(mix + 1)          # a composite child
        return dict(mat_params=mp)

    def kid_two_sided(s):
        mp = s.mat_params.clone()
        mix = int((s.mat_type == 13).nonzero()[0])
        mp[int(mp[mix, 18]), 15] = 1.0
        return dict(mat_params=mp)

    def textured(s):
        tex = s.mat_tex.clone()
        tex[0, 0] = 0
        return dict(mat_tex=tex)

    def two_skies(s):
        et = s.em_type.clone()
        et[0] = 2
        return dict(em_type=et)

    def beckmann(s):
        mp = s.mat_params.clone()
        mp[s.mat_type == 17, 11] = 0.0
        return dict(mat_params=mp)

    def envmap(s):
        et = s.em_type.clone()
        et[-1] = 3
        return dict(em_type=et)

    return {"nested composite": nested, "two-sided child": kid_two_sided,
            "textured composite": textured, "two constant lights": two_skies,
            "beckmann rough coat": beckmann, "envmap": envmap}


@pytest.mark.parametrize("case", list(_gate_cases()))
def test_mega_supports_matches_jax_gate(case):
    """MegaPathTracer.supports refuses each scene the JAX gate refuses,
    with the JAX reason, and both accept the lights-and-composites scene
    as it is."""
    jscene = _compile("jax", lights_composites_desc(*PKG["jax"][:3],
                                                    (4, 8)))
    tscene = _compile("torch", lights_composites_desc(*PKG["torch"][:3],
                                                      (4, 8)))
    assert JMega.supports(jscene) == (True, "")
    assert MegaPathTracer.supports(tscene) == (True, "")
    edits = _gate_cases()[case](tscene)
    t_bad = tscene._replace(**edits)
    j_bad = jscene._replace(**{k: jnp.asarray(v.numpy())
                               for k, v in edits.items()})
    ok, why = JMega.supports(j_bad)
    assert not ok
    assert MegaPathTracer.supports(t_bad) == (False, why)
