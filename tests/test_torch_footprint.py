"""Ray-differential footprints and LoD path tracing in the port
(integrator/footprint.py, PathTracer.li_stats(tex_lod=)) against the JAX
package on the CPU, with the recipes of tests/test_footprint.py: the
analytic footprint of a fronto-parallel plane, first_hit_footprint's duv
and FootprintIntegrator's AOV on a grazing plane, render_lod on a
minified 1-px checkerboard against the JAX LoDPathTracer under the image
rule, the prefiltering's lower pixel-to-pixel variance, and on the texenv
scene (1,536 real triangles, so the compacted loop runs) the same lanes
with the wavefront machinery on and off, eager and fused."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import recipe_camera, texenv_desc
from test_torch_lights import _image_rule
from test_torch_shade import _compiled

from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.integrator import footprint as jfp
from mitsuba_tpu.scene import builder as jb
from mitsuba_tpu.scene import shapes as jshapes
from mitsuba_tpu.sensor.sensor import PerspectiveCamera as JCamera
from mitsuba_tpu.texture import texture as jtex
from mitsuba_tpu_torch.core import rng
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.film.film import Film
from mitsuba_tpu_torch.integrator import footprint as tfp
from mitsuba_tpu_torch.integrator import path as tpath
from mitsuba_tpu_torch.integrator.common import DIM_PIXEL
from mitsuba_tpu_torch.render import render_fn
from mitsuba_tpu_torch.scene import builder as tb
from mitsuba_tpu_torch.scene import shapes as tshapes
from mitsuba_tpu_torch.sensor.sensor import PerspectiveCamera as TCamera
from mitsuba_tpu_torch.texture import texture as ttex

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
PKG = {"jax": (jb, jtf, jshapes, jtex, JCamera),
       "torch": (tb, ttf, tshapes, ttex, TCamera)}


def _compile(pkg, desc):
    if pkg == "jax":
        return jb.compile_scene(desc, cluster_size=128)
    return tb.compile_scene(desc, cluster_size=128, device="cpu")


def _plane(pkg):
    """A unit diffuse quad ([-1, 1]², uv over [0, 1]²)."""
    b, tf, shapes, _, _ = PKG[pkg]
    d = b.SceneDesc()
    d.add_material(kind="diffuse")
    d.add_shape(shapes.rectangle(), material=0)
    return d


def _ground(pkg):
    """tests/test_footprint.py's grazing ground plane, 50 units wide, and
    its 32² camera 1 unit above it looking toward the horizon."""
    b, tf, shapes, _, cam = PKG[pkg]
    d = b.SceneDesc()
    d.add_material(kind="diffuse")
    d.add_shape(shapes.rectangle(), to_world=tf.rotate([1, 0, 0], -90)
                @ tf.scale(50.0), material=0)
    return d, cam(width=32, height=32, fov_x=60.0, to_world=tf.look_at(
        [0, 1.0, 0], [0, 0, -6], [0, 1, 0]))


def _checker(pkg):
    """tests/test_footprint.py's minified checkerboard (512² bitmap of
    256² tiles on a 8×8 quad) under an area light, and its 24² camera."""
    b, tf, shapes, tex, cam = PKG[pkg]
    d = b.SceneDesc()
    tid = d.add_texture(tex.checkerboard((1, 1, 1), (0, 0, 0), res=512,
                                         tiles=256))
    m = d.add_material(kind="diffuse", albedo_texture=tid)
    d.add_shape(shapes.rectangle(), to_world=tf.scale(4.0), material=m)
    d.add_shape(shapes.rectangle(),
                to_world=tf.translate([0, 0, 6]) @ tf.rotate(
                    [1, 0, 0], 180) @ tf.scale(8.0),
                material=0, radiance=(6.0, 6.0, 6.0))
    return d, cam(width=24, height=24, fov_x=45.0, to_world=tf.look_at(
        [0, 0, 5.0], [0, 0, 0], [0, 1, 0]))


def test_footprint_analytic_plane():
    """90° fov over W pixels, 1 unit from the quad: the central pixel's
    footprint is 2/W in space, 1/W in uv, along u for x and v for y."""
    w = 64
    scene = _compile("torch", _plane("torch"))
    cam = TCamera(width=w, height=w, fov_x=90.0,
                  to_world=ttf.look_at([0, 0, 1.0], [0, 0, 0], [0, 1, 0]))
    its, duv_dx, duv_dy = tfp.first_hit_footprint(
        scene, cam, torch.tensor([[w / 2, w / 2]]))
    assert bool(its.valid[0])
    assert abs(abs(float(duv_dx[0, 0])) - 1.0 / w) < 0.15 / w
    assert abs(abs(float(duv_dy[0, 1])) - 1.0 / w) < 0.15 / w


def test_footprint_matches_jax():
    """first_hit_footprint at the 32² pixel centres of the grazing plane:
    the hits equal and duv/dx, duv/dy within rel 1e-5 on them; and
    FootprintIntegrator.render's log2-extent AOV within rel 1e-5 of
    JAX's (0 on a miss), growing toward the horizon."""
    jdesc, jcam = _ground("jax")
    tdesc, tcam = _ground("torch")
    jscene, tscene = _compile("jax", jdesc), _compile("torch", tdesc)
    px = np.arange(32 * 32)
    pos = np.stack([px % 32, px // 32], -1).astype(np.float32) + 0.5
    jits, jdx, jdy = jfp.first_hit_footprint(jscene, jcam, jnp.asarray(pos))
    tits, tdx, tdy = tfp.first_hit_footprint(tscene, tcam,
                                             torch.as_tensor(pos))
    valid = tits.valid.numpy()
    assert np.array_equal(valid, np.asarray(jits.valid))
    assert 0 < valid.sum() < valid.size
    for t, j in ((tdx, jdx), (tdy, jdy)):
        np.testing.assert_allclose(t.numpy()[valid], np.asarray(j)[valid],
                                   **TOL)
    film = Film(32, 32)
    from mitsuba_tpu.film.film import Film as JFilm
    jimg = np.asarray(jfp.FootprintIntegrator(cluster_size=128).render(
        jscene, jcam, JFilm(width=32, height=32)))
    timg = tfp.FootprintIntegrator().render(tscene, tcam, film,
                                            device="cpu").numpy()
    np.testing.assert_allclose(timg, jimg, **TOL)
    col = timg[:, 16, 0]
    assert col[4:10].mean() > col[-6:].mean() + 1.0
    with pytest.raises(NotImplementedError):
        render_fn(tscene, tcam, film, tfp.FootprintIntegrator(), 1,
                  device="cpu")


@pytest.fixture(scope="module")
def checker():
    jdesc, jcam = _checker("jax")
    tdesc, tcam = _checker("torch")
    return _compile("jax", jdesc), jcam, _compile("torch", tdesc), tcam


def test_render_lod_matches_jax(checker):
    """LoDPathTracer.render_lod at 24², 2 spp, max_depth 2 against the
    JAX LoDPathTracer's li_stats(tex_lod=) on the same jittered rays,
    with the JAX footprints (one compile): the image rule and the ray
    counts within rel 1e-4."""
    jscene, jcam, tscene, tcam = checker
    res, spp, seed = 24, 2, 5
    img, n = tfp.LoDPathTracer(max_depth=2).render_lod_stats(
        tscene, tcam, Film(res, res), spp, seed, device="cpu")
    px = np.arange(res * res)
    centres = np.stack([px % res, px // res], -1).astype(np.float32) + 0.5
    _, jdx, jdy = jfp.first_hit_footprint(jscene, jcam, jnp.asarray(centres))
    ext = jnp.maximum(jnp.linalg.norm(jdx, axis=-1),
                      jnp.linalg.norm(jdy, axis=-1))
    jint = jfp.LoDPathTracer(max_depth=2, accel="dense",
                             cluster_size=128).specialized_for(jscene)
    tpx = torch.as_tensor(px)
    jL, jn, fn = 0.0, 0, None
    for s in range(spp):
        jit = rng.sample_2d(seed, tpx, DIM_PIXEL, s)
        pos = torch.stack([(tpx % res).float() + jit[:, 0],
                           (tpx // res).float() + jit[:, 1]], -1)
        o, d = (x.numpy() for x in tcam.sample_ray(pos))
        args = (jscene, jnp.asarray(o), jnp.asarray(d), jnp.uint32(seed),
                jnp.asarray(px, jnp.uint32), jnp.uint32(s), ext)
        if fn is None:
            fn = _compiled(lambda *a: jint.li_stats(*a[:6], tex_lod=a[6]),
                           *args)
        L, rays = fn(*args)
        jL, jn = jL + np.asarray(L), jn + int(rays)
    _image_rule(img.numpy(), (jL / spp).reshape(res, res, 3))
    assert abs(int(n) - jn) <= 1e-4 * jn, (int(n), jn)


def test_lod_suppresses_aliasing(checker):
    """Prefiltered first-hit lookups shrink the plane's pixel-to-pixel
    std below 0.6× the level-0 render's and keep its mean within 15%
    (tests/test_footprint.py:57)."""
    _, _, tscene, tcam = checker
    film = Film(24, 24)
    img_f = tfp.LoDPathTracer(max_depth=2).render_lod(
        tscene, tcam, film, 4, 0, device="cpu").numpy()
    img_0 = render_fn(tscene, tcam, film, tfp.LoDPathTracer(max_depth=2), 4,
                      0, device="cpu")[0].numpy()
    inner_f, inner_0 = img_f[6:18, 6:18, 0], img_0[6:18, 6:18, 0]
    assert inner_f.std() < 0.6 * inner_0.std(), (inner_f.std(),
                                                 inner_0.std())
    assert abs(inner_f.mean() - inner_0.mean()) < 0.15 * inner_0.mean()


@pytest.fixture(scope="module")
def texenv():
    desc = texenv_desc(tb, ttf, tshapes, ttex, sky=(32, 64))
    return tb.compile_scene(desc, device="cpu"), recipe_camera(TCamera, ttf,
                                                               16)


@pytest.mark.parametrize("fused", ["off", "on"])
def test_lod_lanes_with_and_without_compaction(texenv, fused, monkeypatch):
    """li_stats(tex_lod=) on texenv's 16² jittered rays, max_depth 3,
    with the compaction, coherence sort and prefix gate on (the gate
    lowered to this width) equals the plain loop (compaction threshold
    raised) lane by lane and in its count, eager and with the fused tail
    (its plain version), and the footprints change the image."""
    scene, cam = texenv
    res = 16
    px = torch.arange(res * res)
    _, dx, dy = tfp.first_hit_footprint(
        scene, cam, torch.stack([(px % res).float() + 0.5,
                                 (px // res).float() + 0.5], -1))
    ext = tfp.footprint_extent(dx, dy)
    jit = rng.sample_2d(2, px, DIM_PIXEL, 0)
    o, d = cam.sample_ray(torch.stack([(px % res).float() + jit[:, 0],
                                       (px // res).float() + jit[:, 1]], -1))
    tracer = tfp.LoDPathTracer(max_depth=3, fused_shade=fused,
                               sort_rays="on")
    assert tracer.wavefront(scene, res * res)[:2] == (True, True)
    monkeypatch.setattr(tpath, "GATE_MIN_LANES", 64)
    L_on, n_on = tracer.li_stats(scene, o, d, 2, px, 0, tex_lod=ext)
    monkeypatch.setattr(tpath, "COMPACT_MIN_TRIS", 1 << 30)
    assert not tracer.wavefront(scene, res * res)[0]
    L_off, n_off = tracer.li_stats(scene, o, d, 2, px, 0, tex_lod=ext)
    assert torch.equal(L_on, L_off)
    assert int(n_on) == int(n_off)
    L_0 = tracer.li_stats(scene, o, d, 2, px, 0)[0]
    assert (L_0 - L_off).abs().max() > 1e-3
