"""The port's non-area lights, the constant environment and the thin lens
against the JAX package on the CPU: the builder's emitter rows, the
emitter module's sample_direct / eval_env / pdf_direct_env per lane, the
eager PathTracer on the delta-lights and multi-emitter + sky recipes of
tests/test_mega_tpu.py (:305-334, :104-142), and the megakernel's plain
versions (MegaPathTracer on CPU tensors) on the same scenes and through a
thin lens. Inputs come from numpy seeds; the JAX side runs its XLA path,
specialised to each scene's BSDF families (PathTracer.specialized_for)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import LENS, add_lights
from test_torch_shade import _compiled

from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.emitter import emitter as jem
from mitsuba_tpu.integrator.path import PathTracer as JPath
from mitsuba_tpu.scene import builder as jb
from mitsuba_tpu.scene import presets as jpresets
from mitsuba_tpu.scene import shapes as jshapes
from mitsuba_tpu_torch.accel import megakernel as tmk
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.emitter import emitter as tem
from mitsuba_tpu_torch.integrator.mega import (MegaPathTracer,
                                               render_persistent)
from mitsuba_tpu_torch.integrator.path import PathTracer as TPath
from mitsuba_tpu_torch.render import render_fn
from mitsuba_tpu_torch.film.film import Film
from mitsuba_tpu_torch.scene import builder as tb
from mitsuba_tpu_torch.scene import presets as tpresets
from mitsuba_tpu_torch.scene import shapes as tshapes
from mitsuba_tpu_torch.sensor.sensor import PerspectiveCamera

torch.set_num_threads(2)

RES, SPP, MAX_DEPTH, SEED = 32, 4, 8, 7
PKG = {"jax": (jb, jtf, jshapes, jpresets), "torch": (tb, ttf, tshapes,
                                                     tpresets)}


def _compile(pkg, desc):
    builder = PKG[pkg][0]
    if pkg == "jax":
        return builder.compile_scene(desc)
    return builder.compile_scene(desc, device="cpu")


def delta_lights(pkg):
    """tests/test_mega_tpu.py:305-334: a diffuse floor, a GGX sphere and
    point, spot and directional lights."""
    builder, tf, shapes, _ = PKG[pkg]
    d = builder.SceneDesc()
    floor = d.add_material(kind="diffuse", albedo=(0.6, 0.55, 0.5))
    ggx = d.add_material(kind="roughconductor", alpha=0.2)
    d.add_shape(shapes.rectangle(), material=floor,
                to_world=tf.translate([0, -1, 0]) @ tf.rotate([1, 0, 0], -90)
                @ tf.scale([6] * 3))
    d.add_shape(shapes.sphere(8, 16), material=ggx)
    add_lights(d, builder)
    d.constant_light = None
    return d


def multi_emitter_sky(pkg):
    """tests/test_mega_tpu.py:104-142: the Cornell box with a second,
    smaller warm area light and the constant sky."""
    builder, tf, shapes, presets = PKG[pkg]
    d = presets.cornell_box()
    d.add_shape(shapes.rectangle(), material=0, radiance=(6.0, 2.0, 1.0),
                to_world=tf.translate([0.25, 0.6, 0.02])
                @ tf.scale([0.08, 0.08, 1.0]))
    d.constant_light = builder.ConstantLight(radiance=(0.08, 0.09, 0.12))
    return d


def every_light(pkg):
    """An area light and one of each other kind (a collimated beam too)."""
    builder, tf, shapes, _ = PKG[pkg]
    d = delta_lights(pkg)
    d.add_shape(shapes.rectangle(), material=0, radiance=(4.0, 3.0, 2.0),
                to_world=tf.translate([0, 3, 0]) @ tf.rotate([1, 0, 0], 90))
    d.collimated_lights.append(builder.CollimatedLight(
        position=[0.5, 2.0, 0.5], direction=[0.0, -1.0, 0.1],
        power=[2.0, 2.0, 1.5], sampling_weight=0.5))
    d.constant_light = builder.ConstantLight(radiance=(0.08, 0.09, 0.12),
                                             sampling_weight=2.0)
    return d


RECIPES = {"delta_lights": (delta_lights, [0.0, 1.0, 5.0]),
           "multi_emitter_sky": (multi_emitter_sky, None)}
LIGHT_KINDS = ("point", "spot", "collimated", "directional", "constant")


@pytest.mark.parametrize("kind", LIGHT_KINDS)
def test_light_rows_match_jax(kind):
    """Each light kind's emitter rows, pick distribution and environment
    index equal the JAX builder's bit for bit, after an area light."""
    out = {}
    for pkg, (builder, tf, shapes, _) in PKG.items():
        d = builder.SceneDesc()
        d.add_shape(shapes.rectangle(), radiance=(1.0, 2.0, 3.0),
                    sampling_weight=0.7)
        if kind == "constant":
            d.constant_light = builder.ConstantLight((0.1, 0.2, 0.3), 2.0)
        else:
            cls = {"point": builder.PointLight, "spot": builder.SpotLight,
                   "collimated": builder.CollimatedLight,
                   "directional": builder.DirectionalLight}[kind]
            kw = {"point": dict(position=[1, 2, 3], intensity=[4, 5, 6]),
                  "spot": dict(position=[1, 2, 3], direction=[0, -1, 0.2],
                               intensity=[4, 5, 6], cutoff_angle=25.0,
                               beam_width=10.0),
                  "collimated": dict(position=[1, 2, 3],
                                     direction=[0.3, -1, 0]),
                  "directional": dict(direction=[-0.3, -1, -0.4],
                                      irradiance=[0.8, 0.8, 0.9])}[kind]
            getattr(d, f"{kind}_lights").append(cls(**kw,
                                                    sampling_weight=1.5))
        out[pkg] = _compile(pkg, d)
    j, t = out["jax"], out["torch"]
    for name in ("em_type", "em_radiance", "em_pos", "em_area", "em_aux",
                 "em_tri_offset", "em_tris", "em_tri_cdfg", "em_tri_data",
                 "env_id"):
        ref = np.asarray(getattr(j, name))
        assert np.array_equal(getattr(t, name).numpy(), ref), name
    for name in ("pmf", "cdf", "total"):
        assert np.array_equal(getattr(t.em_pmf, name).numpy(),
                              np.asarray(getattr(j.em_pmf, name))), name


def test_envmap_refused():
    """The builder compiles an EnvmapLight (tests/test_torch_textures.py);
    the megakernels refuse its scene with the JAX gate's reason."""
    d = tb.SceneDesc()
    d.envmap = tb.EnvmapLight(image=np.ones((4, 8, 3), np.float32))
    scene = tb.compile_scene(d, device="cpu")
    assert scene.em_type.tolist() == [3] and int(scene.env_id) == 0
    assert MegaPathTracer.supports(scene) == (
        False, "unsupported emitter types {3}")


def test_sample_direct_matches_jax():
    """sample_direct, eval_env and pdf_direct_env per lane on a scene with
    every light type, from seeded reference points and uniforms: within
    rtol 1e-5 / atol 1e-6 (the uniform-sphere warp's sin and cos differ
    by an ulp between the CPU math libraries); the pick, the delta flag
    and the sentinel distance exactly."""
    j, t = _compile("jax", every_light("jax")), \
        _compile("torch", every_light("torch"))
    rs = np.random.RandomState(11)
    n = 4096
    p = (rs.rand(n, 3) * [4, 2, 4] - [2, 1, 2]).astype(np.float32)
    u_sel = rs.rand(n).astype(np.float32)
    u2 = rs.rand(n, 2).astype(np.float32)
    d = rs.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    args = (j, jnp.asarray(p), jnp.asarray(u_sel), jnp.asarray(u2),
            jnp.asarray(d))
    js, jenv, jpdf = _compiled(lambda sc, p, u_sel, u2, d: (
        jem.sample_direct(sc, p, u_sel, u2), jem.eval_env(sc, d),
        jem.pdf_direct_env(sc, d)), *args)(*args)
    ts = tem.sample_direct(t, torch.as_tensor(p), torch.as_tensor(u_sel),
                           torch.as_tensor(u2))
    tol = dict(rtol=1e-5, atol=1e-6)
    for name in ("d", "dist", "pdf", "value", "n"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), **tol,
                                   err_msg=name)
    assert np.array_equal(ts.is_delta.numpy(), np.asarray(js.is_delta))
    assert np.array_equal(ts.em_id.numpy(), np.asarray(js.em_id))
    types = t.em_type[ts.em_id].numpy()
    assert set(types.tolist()) == {0, 1, 2, 4, 5}
    assert (ts.dist.numpy()[(types == 2) | (types == 4)] == 1e30).all()
    np.testing.assert_allclose(tem.eval_env(t, torch.as_tensor(d)).numpy(),
                               np.asarray(jenv), **tol)
    np.testing.assert_allclose(
        tem.pdf_direct_env(t, torch.as_tensor(d)).numpy(), np.asarray(jpdf),
        **tol)
    assert tem.eval_env(t, torch.as_tensor(d)).min() > 0


def _image_rule(img, ref):
    """tests/test_render.py:44-48: < 1% of values off by rel > 5e-2, and
    the means within rel 5e-3."""
    rel = np.abs(img - ref) / np.maximum(ref, 1e-3)
    assert (rel > 5e-2).mean() < 1e-2, ((rel > 5e-2).mean(), img.mean())
    assert np.abs(img.mean() - ref.mean()) / ref.mean() < 5e-3


def _camera(origin):
    if origin is None:
        return tpresets.cornell_camera(RES, RES)
    return PerspectiveCamera(RES, RES, 45.0, ttf.look_at(
        origin=origin, target=[0, -0.3, 0], up=[0, 1, 0]))


def jax_li(jscene, tscene, cam):
    """The JAX PathTracer's li_stats over RES² camera rays of `cam` for
    SPP samples (one compile): (mean radiance [N, 3], summed count)."""
    pix = torch.arange(RES * RES)
    jint = JPath(max_depth=MAX_DEPTH, accel="dense").specialized_for(jscene)
    o, d = (x.numpy() for x in tmk.primary_rays(cam, SEED, pix, 0))
    args = (jscene, jnp.asarray(o), jnp.asarray(d), jnp.uint32(SEED),
            jnp.arange(RES * RES, dtype=jnp.uint32), jnp.uint32(0))
    fn = _compiled(jint.li_stats, *args)
    L, n = 0.0, 0
    for s in range(SPP):
        o, d = (x.numpy() for x in tmk.primary_rays(cam, SEED, pix, s))
        jL, jn = fn(jscene, jnp.asarray(o), jnp.asarray(d),
                    jnp.uint32(SEED), args[4], jnp.uint32(s))
        L, n = L + np.asarray(jL), n + int(jn)
    return L / SPP, n


def torch_li(integ, tscene, cam):
    pix = torch.arange(RES * RES)
    L, n = 0.0, 0
    for s in range(SPP):
        o, d = tmk.primary_rays(cam, SEED, pix, s)
        tL, tn = integ.li_stats(tscene, o, d, SEED, pix, s)
        L, n = L + tL.numpy(), n + int(tn)
    return L / SPP, n


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_path_matches_jax(name):
    """The eager PathTracer, and MegaPathTracer's plain version, against
    the JAX PathTracer at 32², 4 spp, max_depth 8: the image rule and ray
    counts within rel 1e-4."""
    build, origin = RECIPES[name]
    jscene = _compile("jax", build("jax"))
    tscene = _compile("torch", build("torch"))
    cam = _camera(origin)
    jL, jn = jax_li(jscene, tscene, cam)
    assert np.isfinite(jL).all() and jL.mean() > 0.01
    tmk.reset_launches()
    for integ in (TPath(max_depth=MAX_DEPTH),
                  MegaPathTracer.for_scene(tscene, max_depth=MAX_DEPTH)):
        L, n = torch_li(integ, tscene, cam)
        _image_rule(L, jL)
        assert abs(n - jn) <= 1e-4 * jn, (n, jn)
    assert sum(tmk.LAUNCHES.values()) == 0      # CPU: the plain version


@pytest.mark.parametrize("lens", [False, True], ids=["pinhole", "thin_lens"])
def test_mega_equals_path_with_lights(lens):
    """On the CPU MegaPathTracer.li_stats and render_persistent run their
    plain versions, which equal the port's PathTracer (the recipe of
    tests/test_torch_mega.py): the delta lights under the sky at 16², 2
    spp, pinhole and through the thin lens of tests/test_mega_tpu.py
    :394-425, whose aperture blurs the image."""
    d = delta_lights("torch")
    d.constant_light = tb.ConstantLight(radiance=(0.08, 0.09, 0.12))
    scene = _compile("torch", d)
    cam = PerspectiveCamera(16, 16, 45.0, ttf.look_at(
        origin=[0.0, 1.0, 5.0], target=[0, -0.3, 0], up=[0, 1, 0]))
    if lens:
        cam = dataclasses.replace(cam, **LENS)
    integ = MegaPathTracer.for_scene(scene, max_depth=MAX_DEPTH)
    assert MegaPathTracer.supports(scene, cam) == (True, "")
    args = (scene, cam, Film(16, 16, "box"))
    img_e, n_e = render_fn(*args, TPath(max_depth=MAX_DEPTH), 2, 3, "cpu")
    img_m, n_m = render_fn(*args, integ, 2, 3, "cpu")
    img_p, n_p = render_persistent(integ, cam, 2, 3)
    assert int(n_e) == int(n_m) == int(n_p) > 0
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(img_m.numpy(), img_e.numpy(), **tol)
    np.testing.assert_allclose(img_p.numpy(), img_e.numpy(), **tol)
    if lens:
        pin = render_persistent(integ, dataclasses.replace(
            cam, aperture_radius=0.0), 2, 3)[0]
        assert (pin - img_p).abs().mean() > 1e-3
