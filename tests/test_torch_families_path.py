"""Whole paths over the port's leaf BSDF families against the JAX package
on the CPU: the eager PathTracer and the megakernel's plain version
(MegaPathTracer on CPU tensors, accel/megakernel.py path_plain) against
the JAX PathTracer specialised to each scene's families, on three small
scenes of three to five families each (the recipes of
tests/test_mega_tpu.py at sphere(6, 12)), 1,024 rays each."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_shade import _compiled

from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.integrator.path import PathTracer as JPath
from mitsuba_tpu.scene import shapes as jshapes
from mitsuba_tpu.scene.builder import SceneDesc as JDesc
from mitsuba_tpu.scene.builder import compile_scene as jcompile
from mitsuba_tpu_torch.accel import megakernel as tmk
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.integrator.mega import MegaPathTracer
from mitsuba_tpu_torch.integrator.path import PathTracer as TPath
from mitsuba_tpu_torch.scene import shapes as tshapes
from mitsuba_tpu_torch.scene.builder import SceneDesc as TDesc
from mitsuba_tpu_torch.scene.builder import compile_scene as tcompile

torch.set_num_threads(2)

N, SEED, MAX_DEPTH = 1024, 3, 6
SPHERE = (6, 12)


def _floor_and_light(d, tf, shapes, floor):
    d.add_shape(shapes.rectangle(), material=floor,
                to_world=tf.translate([0, -1, 0])
                @ tf.rotate([1, 0, 0], -90) @ tf.scale([6] * 3))
    d.add_shape(shapes.rectangle(), material=floor, radiance=(12, 11, 10),
                to_world=tf.translate([0, 4, 0])
                @ tf.rotate([1, 0, 0], 90) @ tf.scale([2] * 3))


def glossy(desc_cls, tf, shapes):
    """Plastic, phong, ward and Oren-Nayar spheres (test_mega_tpu.py
    :236-270)."""
    d = desc_cls()
    mats = [d.add_material(kind="plastic",
                           diffuse_reflectance=(0.5, 0.2, 0.2)),
            d.add_material(kind="phong", diffuse_reflectance=(0.3, 0.4, 0.2),
                           specular_reflectance=(0.4, 0.4, 0.4),
                           exponent=40.0),
            d.add_material(kind="ward", diffuse_reflectance=(0.3, 0.3, 0.4),
                           specular_reflectance=(0.3, 0.3, 0.3), alpha=0.15,
                           alpha_v=0.3),
            d.add_material(kind="roughdiffuse", albedo=(0.6, 0.5, 0.4),
                           alpha=0.4)]
    floor = d.add_material(kind="diffuse", albedo=(0.6, 0.6, 0.6))
    for i, m in enumerate(mats):
        d.add_shape(shapes.sphere(*SPHERE), material=m,
                    to_world=tf.translate([1.7 * i - 2.5, 0, 0])
                    @ tf.scale([0.7] * 3))
    _floor_and_light(d, tf, shapes, floor)
    return d


def transmissive(desc_cls, tf, shapes):
    """Thin dielectric, difftrans and null panes (test_mega_tpu.py
    :273-303) and a rough dielectric sphere (:530-560)."""
    d = desc_cls()
    panes = [d.add_material(kind="thindielectric", int_ior=1.5),
             d.add_material(kind="difftrans", transmittance=(0.6, 0.5, 0.4)),
             d.add_material(kind="null")]
    glass = d.add_material(kind="roughdielectric", int_ior=1.5, alpha=0.15)
    floor = d.add_material(kind="diffuse", albedo=(0.6, 0.6, 0.6))
    for i, m in enumerate(panes):
        d.add_shape(shapes.rectangle(), material=m,
                    to_world=tf.translate([2.2 * i - 2.2, 0.5, 0])
                    @ tf.scale([0.9] * 3))
    d.add_shape(shapes.sphere(*SPHERE), material=glass,
                to_world=tf.translate([0, -0.3, 1.5]) @ tf.scale([0.6] * 3))
    _floor_and_light(d, tf, shapes, floor)
    return d


def plastic_leadr_twosided(desc_cls, tf, shapes):
    """Rough plastic and LEADR spheres (test_mega_tpu.py :752-828) and a
    two-sided pane seen from behind (:561-590)."""
    d = desc_cls()
    rp = d.add_material(kind="roughplastic", alpha=0.15, int_ior=1.49,
                        diffuse_reflectance=(0.5, 0.15, 0.1))
    lead = d.add_material(kind="aniso_roughdiffuse", albedo=(0.6, 0.4, 0.25),
                          moments0=(0.15, -0.1), moments1=(0.55, 0.4, 0.05))
    pane = d.add_material(kind="diffuse", albedo=(0.8, 0.4, 0.3),
                          two_sided=True)
    floor = d.add_material(kind="diffuse", albedo=(0.5, 0.5, 0.55))
    d.add_shape(shapes.sphere(*SPHERE), material=rp,
                to_world=tf.translate([-1.3, 0, 0]))
    d.add_shape(shapes.sphere(*SPHERE), material=lead,
                to_world=tf.translate([1.3, 0, 0]))
    d.add_shape(shapes.rectangle(), material=pane,
                to_world=tf.translate([0, 0.5, -1.5])
                @ tf.rotate([0, 1, 0], 180) @ tf.scale([1.5] * 3))
    _floor_and_light(d, tf, shapes, floor)
    return d


SCENES = {"glossy": (glossy, [0.0, 1.0, 6.0], {0, 4, 7, 8, 9}),
          "transmissive": (transmissive, [0.0, 0.7, 5.0], {0, 5, 10, 11, 12}),
          "plastic_leadr_twosided": (plastic_leadr_twosided,
                                     [0.0, 0.8, 5.0], {0, 6, 19})}


def _rays(origin, seed=5):
    rs = np.random.RandomState(seed)
    o = np.tile(np.float32([origin]), (N, 1))
    d = rs.randn(N, 3) * [0.5, 0.4, 0.25] + [0, -0.15, -1.0]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _image_rule(img, ref):
    """tests/test_render.py:44-48: < 1% of values off by rel > 5e-2, and
    the means within rel 5e-3."""
    rel = np.abs(img - ref) / np.maximum(ref, 1e-3)
    assert (rel > 5e-2).mean() < 1e-2, ((rel > 5e-2).mean(), img.mean())
    assert np.abs(img.mean() - ref.mean()) / ref.mean() < 5e-3


@pytest.mark.parametrize("name", sorted(SCENES))
def test_paths_match_jax(name):
    """The eager PathTracer and the megakernel's plain version against
    the JAX PathTracer on the same rays, pixel ids and seed: each under
    the image rule, with ray counts within rel 1e-4, and lane by lane
    (ROADMAP's validation recipe: the same streams, so >= 99% of the
    lanes within rel 2e-3 / abs 2e-4 of the JAX radiance; a lane whose
    Russian roulette falls the other way on a rounding difference
    diverges)."""
    build, origin, fams = SCENES[name]
    jscene = jcompile(build(JDesc, jtf, jshapes))
    tscene = tcompile(build(TDesc, ttf, tshapes), device="cpu")
    assert set(tscene.mat_type.tolist()) == fams
    o, d = _rays(origin)
    jint = JPath(max_depth=MAX_DEPTH, accel="dense").specialized_for(jscene)
    args = (jscene, jnp.asarray(o), jnp.asarray(d), jnp.uint32(SEED),
            jnp.arange(N, dtype=jnp.uint32), jnp.uint32(0))
    jL, jn = _compiled(jint.li_stats, *args)(*args)
    jL, jn = np.asarray(jL), int(jn)
    assert np.isfinite(jL).all() and jL.mean() > 0.05
    mega = MegaPathTracer.for_scene(tscene, max_depth=MAX_DEPTH)
    tmk.reset_launches()
    for integ in (TPath(max_depth=MAX_DEPTH), mega):
        L, n = integ.li_stats(tscene, torch.as_tensor(o), torch.as_tensor(d),
                              SEED, torch.arange(N), 0)
        L, n = L.numpy(), int(n)
        _image_rule(L, jL)
        assert abs(n - jn) <= 1e-4 * jn, (n, jn)
        close = np.isclose(L, jL, rtol=2e-3, atol=2e-4).all(-1)
        assert close.mean() >= 0.99, close.mean()
    assert sum(tmk.LAUNCHES.values()) == 0      # CPU: the plain version
