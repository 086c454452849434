"""The port's sensors (sensor/sensor.py) against the JAX package's on the
CPU: every sensor's sample_ray on seeded pixel positions and aperture
draws (the recipes of tests/test_shapes_sensors.py:81-108 and
tests/test_meters.py), PerspectiveCamera.project and position, and the
meters rendered through render_fn."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.sensor import sensor as js
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.film.film import Film
from mitsuba_tpu_torch.integrator.path import PathTracer
from mitsuba_tpu_torch.render import render_fn
from mitsuba_tpu_torch.scene.builder import (ConstantLight, SceneDesc,
                                             compile_scene)
from mitsuba_tpu_torch.sensor import sensor as ts

torch.set_num_threads(2)

N = 512
TOL = dict(rtol=1e-6, atol=1e-6)
W, H = 24, 16


def _to_world(tf):
    return tf.look_at([0.3, 0.8, 2.5], [0.1, 0.2, -0.4], [0, 1, 0]) \
        @ tf.scale([1.5, 0.7, 1.0])


# each sensor: its class name and fields (the to_world added by _pair)
SENSORS = {
    "perspective": ("PerspectiveCamera", dict(width=W, height=H, fov_x=50.0)),
    "thinlens": ("PerspectiveCamera", dict(width=W, height=H, fov_x=35.0,
                                           aperture_radius=0.1,
                                           focus_distance=2.5)),
    "orthographic": ("OrthographicCamera", dict(width=W, height=H)),
    "spherical": ("SphericalCamera", dict(width=W, height=H)),
    "telecentric": ("TelecentricCamera", dict(width=W, height=H)),
    "telecentric_lens": ("TelecentricCamera",
                         dict(width=W, height=H, aperture_radius=0.2,
                              focus_distance=1.7)),
    "perspective_rdist": ("PerspectiveRDistCamera",
                          dict(width=W, height=H, fov_x=50.0, kc0=-0.3,
                               kc1=0.05)),
    "radiancemeter": ("RadianceMeter", {}),
    "irradiancemeter": ("IrradianceMeter", {}),
    "fluencemeter": ("FluenceMeter", {}),
}


def _pair(name):
    cls, kw = SENSORS[name]
    return (getattr(js, cls)(to_world=_to_world(jtf), **kw),
            getattr(ts, cls)(to_world=_to_world(ttf), **kw))


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    pos = (rs.rand(N, 2) * [W, H]).astype(np.float32)
    ap = rs.rand(N, 2).astype(np.float32)
    return pos, ap


@pytest.mark.parametrize("name", sorted(SENSORS))
def test_sample_ray_matches_jax(name):
    """sample_ray on N seeded pixel positions, with seeded aperture draws
    and without any: origins and directions within rel 1e-6."""
    j, t = _pair(name)
    pos, ap = _inputs()
    for aperture in (ap, None):
        jo, jd = j.sample_ray(jnp.asarray(pos), None if aperture is None
                              else jnp.asarray(aperture))
        to, td = t.sample_ray(torch.as_tensor(pos), None if aperture is None
                              else torch.as_tensor(aperture))
        assert to.shape == td.shape == (N, 3)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)


def test_project_matches_jax():
    """PerspectiveCamera.project on seeded world points (in front of the
    camera, behind it and off the film) and position: the raster
    positions within rel 1e-6, the visibility flags equal and W within
    rel 1e-5 (cos³θ)."""
    kw = dict(width=W, height=H, fov_x=50.0)
    look = lambda tf: tf.look_at([0.3, 0.8, 2.5], [0.1, 0.2, -0.4],
                                 [0, 1, 0])
    j = js.PerspectiveCamera(to_world=look(jtf), **kw)
    t = ts.PerspectiveCamera(to_world=look(ttf), **kw)
    rs = np.random.RandomState(1)
    p = (rs.randn(N, 3) * [2.0, 2.0, 3.0]).astype(np.float32)
    jxy, jvis, jw = j.project(jnp.asarray(p))
    txy, tvis, tw = t.project(torch.as_tensor(p))
    np.testing.assert_allclose(txy.numpy(), np.asarray(jxy), rtol=1e-6,
                               atol=1e-5)
    assert np.array_equal(tvis.numpy(), np.asarray(jvis))
    assert 0 < int(tvis.sum()) < N
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
    np.testing.assert_array_equal(t.position("cpu").numpy(),
                                  np.asarray(j.position))
    # a point on a camera ray projects back to the ray's pixel
    pos, _ = _inputs(2)
    o, d = t.sample_ray(torch.as_tensor(pos))
    xy, vis, _ = t.project(o + 3.0 * d)
    assert bool(vis.all())
    np.testing.assert_allclose(xy.numpy(), pos, atol=2e-4)


def _env_scene(radiance):
    d = SceneDesc()
    d.add_material(kind="diffuse")
    d.constant_light = ConstantLight(radiance=radiance)
    return compile_scene(d, device="cpu")


def test_meters_render():
    """tests/test_meters.py through render_fn on the CPU: in an empty
    scene with a constant environment L every ray escapes, so a radiance
    meter reads L, and the irradiance and fluence meters' means are L
    too (E = πL, φ = 4πL)."""
    scene = _env_scene((2.0, 3.0, 4.0))
    film = Film(1, 1)
    meter = ts.RadianceMeter(to_world=ttf.look_at([0, 0, 0], [0, 0, 1],
                                                  [0, 1, 0]))
    img, _ = render_fn(scene, meter, film, PathTracer(max_depth=2), 8,
                       device="cpu")
    np.testing.assert_allclose(img[0, 0].numpy(), [2.0, 3.0, 4.0],
                               rtol=1e-4)
    scene = _env_scene((1.5, 1.5, 1.5))
    for cls in (ts.IrradianceMeter, ts.FluenceMeter):
        img, _ = render_fn(scene, cls(), film, PathTracer(max_depth=2), 4,
                           device="cpu")
        np.testing.assert_allclose(img[0, 0].numpy(), 1.5, rtol=1e-6,
                                   err_msg=cls.__name__)
