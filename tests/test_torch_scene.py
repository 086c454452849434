"""Port scene compilation, camera, film, emitter and BSDF against the JAX
package on the CPU. Inputs come from numpy seeds and reach both packages as
numpy arrays."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.bsdf import bsdf as jbsdf
from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.emitter import emitter as jem
from mitsuba_tpu.film.film import Film as JFilm
from mitsuba_tpu.scene import presets as jpresets
from mitsuba_tpu.scene import shapes as jshapes
from chip_smoke import four_materials_desc, leaf_families_desc
from mitsuba_tpu.scene.builder import SceneDesc as JSceneDesc
from mitsuba_tpu.scene.builder import compile_scene as jcompile
from mitsuba_tpu_torch import device as tdevice
from mitsuba_tpu_torch.accel import trace as ttrace
from mitsuba_tpu_torch.bsdf import bsdf as tbsdf
from mitsuba_tpu_torch.convert import scene_from_numpy
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.emitter import emitter as tem
from mitsuba_tpu_torch.film.film import Film as TFilm
from mitsuba_tpu_torch.scene import presets as tpresets
from mitsuba_tpu_torch.scene import shapes as tshapes
from mitsuba_tpu_torch.scene.builder import Medium
from mitsuba_tpu_torch.scene.builder import SceneDesc as TSceneDesc
from mitsuba_tpu_torch.scene.builder import compile_scene as tcompile

torch.set_num_threads(2)

# Woop tables may come from the JAX package's native inverse (a different
# rounding of the same 3x3 inversion): rtol 1e-5, atol 1e-6 for entries ≈ 0.
WOOP_FIELDS = ("woop_o", "woop_d", "woop_clusters")


def _descs(with_sphere: bool):
    """The same scene described in both packages: the Cornell box, plus
    (optionally) sphere(8, 16) of radius 0.2 inside it — 260 triangles,
    past the 256-triangle Morton threshold."""
    out = []
    for presets, shapes, tf in ((jpresets, jshapes, jtf),
                                (tpresets, tshapes, ttf)):
        desc = presets.cornell_box()
        if with_sphere:
            desc.add_shape(shapes.sphere(8, 16),
                           to_world=tf.translate([0.5, 0.4, 0.5])
                           @ tf.scale(0.2), material=0)
        out.append(desc)
    return out


@pytest.fixture(scope="module", params=[False, True],
                ids=["cornell", "cornell+sphere"])
def scenes(request):
    jd, td = _descs(request.param)
    return jcompile(jd), tcompile(td, device="cpu")


def _numpy_fields(jscene):
    arrays = {k: (None if v is None else np.asarray(v))
              for k, v in jscene._asdict().items() if k != "em_pmf"}
    arrays["em_pmf"] = {k: np.asarray(v)
                        for k, v in jscene.em_pmf._asdict().items()}
    return arrays


def test_compile_scene_matches_jax(scenes):
    """Array by array: integer tables exactly equal, float tables exactly
    equal except the Woop transforms (rtol 1e-5)."""
    jscene, tscene = scenes
    assert tscene.n_tris == jscene.n_tris
    for name in jscene._fields:
        ref, out = getattr(jscene, name), getattr(tscene, name)
        if name == "em_pmf":
            for a, b in zip(out, ref):
                assert np.array_equal(a.numpy(), np.asarray(b)), name
            continue
        assert (ref is None) == (out is None), name
        if ref is None:
            continue
        ref = np.asarray(ref)
        out = out.numpy()
        assert out.shape == ref.shape, name
        if name in WOOP_FIELDS:
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        else:
            assert np.array_equal(out, ref), name


def test_morton_and_order_tables(scenes):
    """The sphere scene is Morton-ordered (so emissive triangle ids move)
    and both scenes carry the front-to-back order tables (8 clusters)."""
    jscene, tscene = scenes
    assert tscene.cluster_order is not None
    assert tscene.cluster_order.shape == (8, 8)
    n_real = int((tscene.tri_area > 0).sum())
    authored = np.array_equal(tscene.em_tris.numpy(), [34, 35])
    assert authored == (n_real <= 256), (n_real, tscene.em_tris)


def test_scene_from_numpy_round_trip(scenes):
    """The JAX scene carried across equals, field by field, bit for bit."""
    jscene, _ = scenes
    arrays = _numpy_fields(jscene)
    tscene = scene_from_numpy(arrays, device="cpu")
    for name in jscene._fields:
        out = getattr(tscene, name)
        if name == "em_pmf":
            for k, v in zip(out._fields, out):
                assert np.array_equal(v.numpy(), arrays[name][k])
        elif arrays[name] is None:
            assert out is None, name
        else:
            assert np.array_equal(out.numpy(), arrays[name]), name
            assert out.numpy().dtype == arrays[name].dtype, name


def test_scene_from_numpy_rejects_unported():
    arrays = _numpy_fields(jcompile(jpresets.cornell_box()))
    arrays["mat_type"] = arrays["mat_type"].copy()
    arrays["mat_type"][1] = 15                # Hanrahan-Krueger slab
    with pytest.raises(NotImplementedError, match=r"BSDF families \[15\]"):
        scene_from_numpy(arrays, device="cpu")
    arrays = _numpy_fields(jcompile(jpresets.cornell_box()))
    arrays["has_medium"] = np.array(True)    # a density grid
    arrays["med_grid"] = np.ones((2, 2, 2), np.float32)
    with pytest.raises(NotImplementedError, match="heterogeneous medium"):
        scene_from_numpy(arrays, device="cpu")


def _padding_descs(name):
    """The scene `name` described in both packages (small spheres)."""
    out = []
    for presets, shapes, tf, desc_cls in (
            (jpresets, jshapes, jtf, JSceneDesc),
            (tpresets, tshapes, ttf, TSceneDesc)):
        if name == "cornell":
            out.append(presets.cornell_box())
        elif name == "four_materials":
            out.append(four_materials_desc(desc_cls, tf, shapes, (8, 16)))
        else:
            out.append(leaf_families_desc(desc_cls, tf, shapes, (6, 12)))
    return out


@pytest.mark.parametrize("name", ["cornell", "four_materials",
                                  "leaf_families"])
def test_padding_follows_real_triangles(name):
    """The builder pads only past its real triangles, with Woop rows that
    never hit: the count where the kernels' walk stops passes the
    wrappers' check (trace.real_tris) and covers every triangle that can
    hit. A JAX scene carried across derives a count that passes too."""
    jd, td = _padding_descs(name)
    scene = tcompile(td, device="cpu")
    n = sum(len(shape.mesh.faces) for shape in td.shapes)
    assert ttrace.real_tris(scene) == scene.n_real_tris == n
    assert scene.n_tris > n and scene.n_tris % ttrace.TRIS_PER_CLUSTER == 0
    assert ttrace.padding_start(scene.woop_clusters) <= n
    pad = scene.woop_clusters.view(-1, 3, ttrace.TRIS_PER_CLUSTER, 4)
    pad = pad.transpose(1, 2).reshape(-1, 3, 4)[n:]
    assert (pad[:, 2, :3] == 0).all()             # d'_z = 0: never a hit
    carried = scene_from_numpy(_numpy_fields(jcompile(jd)), device="cpu")
    assert 0 < carried.n_real_tris <= n
    assert ttrace.real_tris(carried) == carried.n_real_tris


def test_padding_check_rejects_broken_table():
    """A table whose padding could hit, a count past the table and a
    missing count are refused before any launch."""
    scene = tcompile(tpresets.cornell_box(), device="cpu")
    woop = scene.woop_clusters.clone()
    woop[1, 2 * ttrace.TRIS_PER_CLUSTER + 5, 0] = 1.0   # triangle 69
    with pytest.raises(ValueError, match="triangle 69 .* can hit"):
        ttrace.real_tris(scene._replace(woop_clusters=woop))
    with pytest.raises(ValueError, match="outside the table"):
        ttrace.real_tris(scene._replace(n_real_tris=10_000))
    with pytest.raises(ValueError, match="no real triangle count"):
        ttrace.real_tris(scene._replace(n_real_tris=None))


def test_compile_scene_rejects_unported():
    d = tpresets.cornell_box()
    d.add_material(kind="hk")
    with pytest.raises(NotImplementedError, match="'hk'"):
        tcompile(d, device="cpu")
    d = tpresets.cornell_box()
    d.medium = Medium(density_grid=np.ones((2, 2, 2)))
    with pytest.raises(NotImplementedError, match="heterogeneous"):
        tcompile(d, device="cpu")
    with pytest.raises(ValueError, match="sinc"):
        TFilm(8, 8, "sinc")


def test_cuda_default_raises_without_card(monkeypatch):
    """Entry points default to the card and never move to the CPU on
    their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcompile(tpresets.cornell_box())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device("cuda")


@pytest.mark.parametrize("aperture", [0.0, 0.05])
def test_camera_matches_jax(aperture):
    """Pinhole and thin lens, rtol 1e-5 (atol 1e-6 for components ≈ 0)."""
    from mitsuba_tpu.sensor.sensor import PerspectiveCamera as JCam
    from mitsuba_tpu_torch.sensor.sensor import PerspectiveCamera as TCam
    to_world = ttf.look_at([0.5, 0.5, 2.45], [0.5, 0.5, 0.0], [0, 1, 0])
    kw = dict(width=40, height=24, fov_x=39.0, to_world=to_world,
              aperture_radius=aperture, focus_distance=2.0)
    rs = np.random.RandomState(7)
    pos = (rs.rand(2048, 2) * [40, 24]).astype(np.float32)
    ap = rs.rand(2048, 2).astype(np.float32)
    jo, jd = JCam(**kw).sample_ray(jnp.asarray(pos), jnp.asarray(ap))
    to, td = TCam(**kw).sample_ray(torch.as_tensor(pos), torch.as_tensor(ap))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)


def test_film_matches_jax():
    """Box splat with out-of-range and NaN samples, then develop: rtol 1e-5
    (sums may be taken in another order)."""
    rs = np.random.RandomState(8)
    n = 5000
    pos = (rs.rand(n, 2) * [20, 12] - [1, 1]).astype(np.float32)
    val = rs.rand(n, 3).astype(np.float32)
    val[5, 1] = np.nan
    pos[9, 0] = np.inf
    jf, tf = JFilm(18, 10, "box"), TFilm(18, 10, "box")
    ja = jf.splat(jf.new_accumulator(), jnp.asarray(pos), jnp.asarray(val))
    ta = tf.splat(tf.new_accumulator("cpu"), torch.as_tensor(pos),
                  torch.as_tensor(val))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5)
    np.testing.assert_allclose(tf.develop(ta).numpy(),
                               np.asarray(jf.develop(ja)), rtol=1e-5)


@pytest.fixture(scope="module")
def cornell_pair():
    return (jcompile(jpresets.cornell_box()),
            tcompile(tpresets.cornell_box(), device="cpu"))


def test_emitter_matches_jax(cornell_pair):
    """sample_direct toward the area light from points in the box, and
    pdf_direct_area / eval_area of the hits: rtol 1e-5."""
    jscene, tscene = cornell_pair
    rs = np.random.RandomState(9)
    n = 4096
    ref_p = (rs.rand(n, 3) * 0.98 + 0.01).astype(np.float32)
    u_sel = rs.rand(n).astype(np.float32)
    u2 = rs.rand(n, 2).astype(np.float32)
    jds = jax.jit(lambda p, a, b: jem.sample_direct(jscene, p, a, b))(
        jnp.asarray(ref_p), jnp.asarray(u_sel), jnp.asarray(u2))
    tds = tem.sample_direct(tscene, torch.as_tensor(ref_p),
                            torch.as_tensor(u_sel), torch.as_tensor(u2))
    for name in ("d", "dist", "pdf", "value", "n"):
        np.testing.assert_allclose(getattr(tds, name).numpy(),
                                   np.asarray(getattr(jds, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert np.array_equal(tds.em_id.numpy(), np.asarray(jds.em_id))
    assert not tds.is_delta.any()
    assert (tds.pdf > 0).float().mean() > 0.9

    em_id = rs.randint(-1, 1, n)
    cos_l = (rs.rand(n) * 2 - 1).astype(np.float32)
    dist = (rs.rand(n) * 2).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    np.testing.assert_allclose(
        tem.pdf_direct_area(tscene, torch.as_tensor(em_id),
                            torch.as_tensor(d), torch.as_tensor(dist),
                            torch.as_tensor(cos_l)).numpy(),
        np.asarray(jem.pdf_direct_area(jscene, jnp.asarray(em_id),
                                       jnp.asarray(d), jnp.asarray(dist),
                                       jnp.asarray(cos_l))), rtol=1e-5)
    np.testing.assert_array_equal(
        tem.eval_area(tscene, torch.as_tensor(em_id),
                      torch.as_tensor(cos_l)).numpy(),
        np.asarray(jem.eval_area(jscene, jnp.asarray(em_id),
                                 jnp.asarray(cos_l))))
    assert not tem.eval_env(tscene, torch.as_tensor(d)).any()
    assert not np.asarray(jem.eval_env(jscene, jnp.asarray(d))).any()
    assert not tem.pdf_direct_env(tscene, torch.as_tensor(d)).any()


def test_diffuse_bsdf_matches_jax(cornell_pair):
    """eval / pdf / sample through the resolved material rows, with miss
    lanes (mat_id -1) and directions below the surface: rtol 1e-5."""
    jscene, tscene = cornell_pair
    rs = np.random.RandomState(10)
    n = 4096
    mat_id = rs.randint(-1, 3, n)
    wi = rs.randn(n, 3).astype(np.float32)
    wo = rs.randn(n, 3).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    u2 = rs.rand(n, 2).astype(np.float32)
    u1 = rs.rand(n).astype(np.float32)

    fams = (0,)     # the scene's families (PathTracer.specialized_for)

    @jax.jit
    def ref(mid, wi, wo, u2, u1):
        mat = jbsdf.resolve_material(jscene, mid, families=fams)
        return (jbsdf.eval_bsdf_ex(mat, wi, wo, fams),
                jbsdf.pdf_bsdf_ex(mat, wi, wo, fams),
                jbsdf.sample_bsdf_ex(mat, wi, u2, u1, fams))

    jf, jp, js = ref(*(jnp.asarray(x) for x in (mat_id, wi, wo, u2, u1)))
    mat = tbsdf.resolve_material(tscene, torch.as_tensor(mat_id))
    twi, two = torch.as_tensor(wi), torch.as_tensor(wo)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tbsdf.eval_bsdf_ex(mat, twi, two).numpy(),
                               np.asarray(jf), **tol)
    np.testing.assert_allclose(tbsdf.pdf_bsdf_ex(mat, twi, two).numpy(),
                               np.asarray(jp), **tol)
    ts = tbsdf.sample_bsdf_ex(mat, twi, torch.as_tensor(u2),
                              torch.as_tensor(u1))
    for name in ("weight", "pdf", "eta"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), **tol,
                                   err_msg=name)
    # the lifted z of the cosine warp cancels near the rim (see
    # test_torch_core.test_warps_match_jax): atol 1e-5 there
    np.testing.assert_allclose(ts.wo.numpy(), np.asarray(js.wo), rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(ts.is_delta.numpy(), np.asarray(js.is_delta))
