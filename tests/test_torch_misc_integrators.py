"""The port's image-space integrators against the JAX package's on the
CPU, on the Cornell box with a sphere: ambient occlusion and the eleven geometry AOVs
(integrator/misc.py) lane by lane, render_fn through their li_stats (not
PathTracer's), the multichannel integrator's groups against each child
rendered alone and its EXR's channel names (integrator/multichannel.py),
and the adaptive sampler's count map and image (integrator/adaptive.py).
The recipes are tests/test_integrators.py:51-80,
tests/test_multichannel_ss.py and tests/test_vpl_adaptive.py:65-80; the
rays come from a numpy seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lights import _image_rule

from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.film.film import Film as JFilm
from mitsuba_tpu.integrator import adaptive as jad
from mitsuba_tpu.integrator import misc as jmisc
from mitsuba_tpu.scene import builder as jb
from mitsuba_tpu.scene import presets as jpresets
from mitsuba_tpu.scene import shapes as jshapes
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.film.film import Film
from mitsuba_tpu_torch.integrator import adaptive as tad
from mitsuba_tpu_torch.integrator import misc as tmisc
from mitsuba_tpu_torch.integrator.multichannel import (
    MultiChannelIntegrator, write_multichannel_exr)
from mitsuba_tpu_torch.integrator.path import PathTracer
from mitsuba_tpu_torch.io import image as timage
from mitsuba_tpu_torch.render import render_fn, sample_camera
from mitsuba_tpu_torch.scene import builder as tb
from mitsuba_tpu_torch.scene import presets as tpresets
from mitsuba_tpu_torch.scene import shapes as tshapes

torch.set_num_threads(2)

RES = 16
SEED = 3
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def cornell():
    """The Cornell box with a uv-mapped sphere in both packages, the
    port's RES² camera, and jittered camera rays (o, d as numpy)."""
    def desc(presets, tf, shapes):
        d = presets.cornell_box()
        d.add_shape(shapes.sphere(8, 16), material=1,
                    to_world=tf.translate([0.5, 0.7, 0.5])
                    @ tf.scale([0.15] * 3))
        return d

    jscene = jb.compile_scene(desc(jpresets, jtf, jshapes))
    tscene = tb.compile_scene(desc(tpresets, ttf, tshapes), device="cpu")
    cam = tpresets.cornell_camera(RES, RES)
    px = torch.arange(RES * RES)
    rs = np.random.RandomState(0)
    pos = torch.as_tensor((np.stack([px % RES, px // RES], -1)
                           + rs.rand(RES * RES, 2)).astype(np.float32))
    o, d = (x.numpy() for x in cam.sample_ray(pos))
    return jscene, tscene, cam, o, d


def _both(cornell, j_integ, t_integ, samp=1):
    """(JAX li [N, C] as numpy, port (li [N, C] as numpy, count))."""
    jscene, tscene, _, o, d = cornell
    n = o.shape[0]
    jL = j_integ.li(jscene, jnp.asarray(o), jnp.asarray(d), jnp.uint32(SEED),
                    jnp.arange(n, dtype=jnp.uint32), jnp.uint32(samp))
    tL, rays = t_integ.li_stats(tscene, torch.as_tensor(o),
                                torch.as_tensor(d), SEED, torch.arange(n),
                                samp)
    return np.asarray(jL), tL.numpy(), int(rays)


@pytest.mark.parametrize("length,samples", [(0.25, 1), (-1.0, 3)])
def test_ao_matches_jax(cornell, length, samples):
    """AmbientOcclusion's li lane by lane, at a finite ray length and at
    the default (1e8); the count is a ray a camera ray plus one a hit and
    shading sample."""
    jL, tL, rays = _both(
        cornell, jmisc.AmbientOcclusion(ray_length=length,
                                        shading_samples=samples),
        tmisc.AmbientOcclusion(ray_length=length, shading_samples=samples))
    np.testing.assert_allclose(tL, jL, **TOL)
    assert 0.0 < tL.mean() < 1.0
    n = tL.shape[0]
    hits = int((np.abs(_both(cornell, jmisc.FieldIntegrator(
        field="distance"), tmisc.FieldIntegrator(field="distance"))[1][:, 0])
        > 0).sum())
    assert rays == n + samples * hits


@pytest.mark.parametrize("field", tmisc.FIELDS)
def test_field_matches_jax(cornell, field):
    """Every field of FieldIntegrator lane by lane (woMacro's emitter
    sample included); one ray a camera ray."""
    jL, tL, rays = _both(cornell, jmisc.FieldIntegrator(field=field),
                         tmisc.FieldIntegrator(field=field))
    np.testing.assert_allclose(tL, jL, **TOL)
    assert np.abs(tL).max() > 0
    assert rays == tL.shape[0]


def test_render_fn_runs_ao(cornell):
    """render_fn with AmbientOcclusion renders ambient occlusion, not a
    path trace: with the box filter each pixel is the mean of the JAX
    AO's li over the render's own camera rays, and it differs from the
    PathTracer image."""
    jscene, tscene, cam, _, _ = cornell
    film = Film(RES, RES)
    spp = 2
    img, rays = render_fn(tscene, cam, film,
                          tmisc.AmbientOcclusion(ray_length=0.25), spp,
                          SEED, device="cpu")
    px = torch.arange(RES * RES)
    jao = jmisc.AmbientOcclusion(ray_length=0.25)
    want = 0.0
    for s in range(spp):
        _, o, d = sample_camera(cam, RES, SEED, px, s)
        want = want + np.asarray(jao.li(
            jscene, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
            jnp.uint32(SEED), jnp.arange(RES * RES, dtype=jnp.uint32),
            jnp.uint32(s)))
    np.testing.assert_allclose(img.numpy().reshape(-1, 3), want / spp,
                               **TOL)
    path = render_fn(tscene, cam, film, PathTracer(max_depth=3), spp, SEED,
                     device="cpu")[0]
    assert np.abs(img.numpy() - path.numpy()).mean() > 0.1
    assert int(rays) > spp * RES * RES


def test_multichannel_groups_equal_children(cornell, tmp_path):
    """Each channel group of MultiChannelIntegrator.render equals its child
    rendered alone through render_fn (the children share the rays), the
    counts add up, and write_multichannel_exr stores the groups under
    their names (alphabetical in the file)."""
    _, tscene, cam, _, _ = cornell
    film = Film(RES, RES)
    children = (PathTracer(max_depth=3), tmisc.FieldIntegrator(
        field="shNormal"), tmisc.FieldIntegrator(field="distance"),
        tmisc.AmbientOcclusion(ray_length=0.25))
    mc = MultiChannelIntegrator(children=children,
                                names=("color", "normal", "distance", "ao"))
    img, rays = mc.render_stats(tscene, cam, film, 2, SEED, device="cpu")
    assert img.shape == (RES, RES, 12)
    total = 0
    for i, child in enumerate(children):
        solo, n = render_fn(tscene, cam, film, child, 2, SEED, device="cpu")
        assert torch.equal(img[..., 3 * i:3 * i + 3], solo), i
        total += int(n)
    assert int(rays) == total
    path = str(tmp_path / "mc.exr")
    names = mc.channel_names()
    assert names[:4] == ["color.R", "color.G", "color.B", "normal.R"]
    write_multichannel_exr(path, img, names)
    stored = timage.read_exr_channel_names(path)
    assert stored == sorted(names)
    order = [names.index(c) for c in stored]
    assert np.array_equal(timage.read_exr(path), img.numpy()[..., order])


def test_adaptive_matches_jax(cornell):
    """AdaptiveSampler.render_with_counts with an AO child (max_error 0.05,
    batches of 4, 4 passes): the count map equals JAX's on >= 99% of the
    pixels, Σcounts = pixels · batch · passes exactly, the allocation is
    not uniform, and the image holds to JAX's under the image rule."""
    jscene, tscene, cam, _, _ = cornell
    kw = dict(max_error=0.05, batch_spp=4, max_passes=4)
    jimg, jcnt = jad.AdaptiveSampler(**kw).render_with_counts(
        jscene, jpresets.cornell_camera(RES, RES), JFilm(RES, RES),
        jmisc.AmbientOcclusion(ray_length=0.25), seed=SEED)
    timg, tcnt = tad.AdaptiveSampler(**kw).render_with_counts(
        tscene, cam, Film(RES, RES), tmisc.AmbientOcclusion(ray_length=0.25),
        seed=SEED, device="cpu")
    jcnt, tcnt = np.asarray(jcnt), tcnt.numpy()
    assert (jcnt == tcnt).mean() >= 0.99
    assert tcnt.sum() == RES * RES * 4 * 4 == jcnt.sum()
    assert tcnt.max() > tcnt.min() >= 4
    _image_rule(timg.numpy(), np.asarray(jimg))
