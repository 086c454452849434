"""The homogeneous medium and the direct integrator of the port against the
JAX package (and the numpy oracle) on the CPU: the HG phase function, the
medium's distance sampling and transmittance, the builder's medium rows
and convert.py, DirectIntegrator and VolPathTracer lane by lane, the
Beer-Lambert case, the megakernels' plain versions with the medium
(MegaVolPathTracer on CPU tensors) against the eager VolPathTracer, and
the megakernel gates. The JAX integrators run specialised to each scene's
families, one compile per scene and integrator."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import FOG_CORNELL, fog_cornell_desc, fog_point_desc
from oracle.volpath import render_volpath_oracle
from test_torch_scene import _numpy_fields
from test_torch_shade import _compiled

from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.integrator.direct import DirectIntegrator as JDirect
from mitsuba_tpu.integrator.mega import MegaPathTracer as JMega
from mitsuba_tpu.integrator.volpath import VolPathTracer as JVol
from mitsuba_tpu.media import homogeneous as jmed
from mitsuba_tpu.phase import phase as jphase
from mitsuba_tpu.scene import builder as jbuilder
from mitsuba_tpu.scene import presets as jpresets
from mitsuba_tpu.scene import shapes as jshapes
from mitsuba_tpu_torch.accel import megakernel as tmk
from mitsuba_tpu_torch.convert import scene_from_numpy
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.film.film import Film as TFilm
from mitsuba_tpu_torch.integrator.direct import DirectIntegrator
from mitsuba_tpu_torch.integrator.mega import (MegaPathTracer,
                                               MegaVolPathTracer,
                                               render_persistent)
from mitsuba_tpu_torch.integrator.volpath import VolPathTracer
from mitsuba_tpu_torch.media import homogeneous as tmed
from mitsuba_tpu_torch.phase import phase as tphase
from mitsuba_tpu_torch.render import render, render_fn
from mitsuba_tpu_torch.scene import builder as tbuilder
from mitsuba_tpu_torch.scene import presets as tpresets
from mitsuba_tpu_torch.scene import shapes as tshapes
from mitsuba_tpu_torch.sensor.sensor import PerspectiveCamera as TCamera

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
N, SEED = 1024, 3
MED_FIELDS = ("med_sigma_t", "med_albedo", "med_g", "med_bound",
              "has_medium", "med_grid", "med_grid_min", "med_grid_extent",
              "med_majorant", "med_sggx", "med_fiber")


def _rs(seed=0):
    return np.random.RandomState(seed)


def _dirs(rs, n):
    d = rs.randn(n, 3)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _image_rule(img, ref):
    """tests/test_render.py:44-48: < 1% of values off by rel > 5e-2, and
    the means within rel 5e-3."""
    rel = np.abs(img - ref) / np.maximum(ref, 1e-3)
    assert (rel > 5e-2).mean() < 1e-2, ((rel > 5e-2).mean(), img.mean())
    assert np.abs(img.mean() - ref.mean()) / ref.mean() < 5e-3


def _lanes_close(a, b, share=0.99):
    """Whole paths on the same streams: >= `share` of the lanes within
    rel 2e-3 / abs 2e-4 (a lane whose Russian roulette or medium event
    falls the other way on a rounding difference diverges)."""
    close = np.isclose(a, b, rtol=2e-3, atol=2e-4).all(-1)
    assert close.mean() >= share, close.mean()


@pytest.fixture(scope="module")
def fog_point():
    """The fog-and-point-light scene (tests/test_mega_tpu.py:426-466) in
    both packages, and the recipe's rays."""
    jscene = jbuilder.compile_scene(fog_point_desc(jbuilder, jtf, jshapes))
    tscene = tbuilder.compile_scene(fog_point_desc(tbuilder, ttf, tshapes),
                                    device="cpu")
    rs = _rs(7)
    o = np.tile(np.float32([0.0, 1.0, 5.0]), (N, 1))
    d = rs.randn(N, 3) * [0.5, 0.4, 0.25] + [0, -0.1, -1.0]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return jscene, tscene, o, d


@pytest.fixture(scope="module")
def cornell():
    return (jbuilder.compile_scene(jpresets.cornell_box()),
            tbuilder.compile_scene(tpresets.cornell_box(), device="cpu"))


def _cornell_rays(res=32, seed=0):
    rs = _rs(seed)
    pos = ((np.stack(np.meshgrid(np.arange(res), np.arange(res)), -1)
            .reshape(-1, 2) + rs.rand(res * res, 2)).astype(np.float32))
    o, d = jpresets.cornell_camera(res, res).sample_ray(jnp.asarray(pos))
    return np.array(o), np.array(d)


# ---- the HG phase function ----------------------------------------------

@pytest.mark.parametrize("g", [-0.7, 0.0, 5e-5, 0.3, 0.9])
def test_hg_matches_jax(g):
    """hg_eval, hg_sample and hg_pdf lane by lane against the JAX ones
    (|g| = 5e-5 takes the isotropic branch of the sampler)."""
    rs = _rs(1)
    n = 512
    cos = rs.uniform(-1, 1, n).astype(np.float32)
    wi, wo = _dirs(rs, n), _dirs(rs, n)
    u2 = rs.rand(n, 2).astype(np.float32)
    gj, gt = jnp.float32(g), torch.tensor(g, dtype=torch.float32)
    close = lambda t, j: np.testing.assert_allclose(
        t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)
    close(tphase.hg_eval(gt, torch.as_tensor(cos)),
          jphase.hg_eval(gj, jnp.asarray(cos)))
    close(tphase.hg_pdf(gt, torch.as_tensor(wi), torch.as_tensor(wo)),
          jphase.hg_pdf(gj, jnp.asarray(wi), jnp.asarray(wo)))
    two, twp = tphase.hg_sample(gt, torch.as_tensor(wi), torch.as_tensor(u2))
    jwo, jwp = jphase.hg_sample(gj, jnp.asarray(wi), jnp.asarray(u2))
    close(two, jwo)
    close(twp, jwp)


# ---- the medium's distance sampling and transmittance --------------------

@pytest.mark.parametrize("bound", [1e30, 1.5])
def test_medium_sampling_matches_jax(bound):
    """sample_distance and transmittance against the JAX ones, with a
    quarter of the lanes escaped (t_surf 1e30) and a channel of zero σt;
    with the finite bound the medium ends before many surfaces."""
    rs = _rs(2)
    n = 1024
    sigma_t = np.float32([0.8, 0.0, 2.5])
    albedo = np.float32([0.7, 0.9, 0.5])
    u = rs.rand(n, 2).astype(np.float32)
    t_surf = rs.uniform(0.1, 4.0, n).astype(np.float32)
    t_surf[::4] = 1e30
    dist = np.where(np.arange(n) % 3 == 0, 1e30,
                    rs.uniform(0, 5, n)).astype(np.float32)
    jm = jmed.sample_distance(jnp.asarray(sigma_t), jnp.asarray(albedo),
                              jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1]),
                              jnp.asarray(t_surf), bound)
    tm = tmed.sample_distance(torch.as_tensor(sigma_t),
                              torch.as_tensor(albedo),
                              torch.as_tensor(u[:, 0]),
                              torch.as_tensor(u[:, 1]),
                              torch.as_tensor(t_surf), bound)
    assert np.array_equal(tm.sampled.numpy(), np.asarray(jm.sampled))
    assert 0.1 < tm.sampled.numpy().mean() < 0.9
    for t, j in zip(tm[1:], jm[1:]):
        assert np.isfinite(t.numpy()).all()
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(
        tmed.transmittance(torch.as_tensor(sigma_t), torch.as_tensor(dist),
                           bound).numpy(),
        np.asarray(jmed.transmittance(jnp.asarray(sigma_t),
                                      jnp.asarray(dist), bound)),
        rtol=RTOL, atol=ATOL)


# ---- builder and converter ----------------------------------------------

def test_builder_medium_rows_match_jax():
    """The builder's medium rows equal the JAX builder's exactly, with a
    medium (finite bound) and without; a density grid, an SGGX matrix or
    a fiber orientation raises."""
    for medium in ({"bound": 2.5}, None):
        descs = [fog_cornell_desc(b, p, **(medium or {}))
                 for b, p in ((jbuilder, jpresets), (tbuilder, tpresets))]
        if medium is None:
            descs[0].medium = descs[1].medium = None
        js = jbuilder.compile_scene(descs[0])
        ts = tbuilder.compile_scene(descs[1], device="cpu")
        for name in MED_FIELDS:
            assert np.array_equal(getattr(ts, name).numpy(),
                                  np.asarray(getattr(js, name))), name
    for extra in ({"density_grid": np.ones((2, 2, 2))},
                  {"sggx_s": (1, 1, 1, 0, 0, 0)},
                  {"fiber_orientation": (0, 0, 1)}):
        desc = fog_cornell_desc(tbuilder, tpresets, **extra)
        with pytest.raises(NotImplementedError, match="heterogeneous"):
            tbuilder.compile_scene(desc, device="cpu")


def test_convert_carries_fog_scene():
    """A compiled JAX fog scene carried across keeps its medium rows; a
    density grid is refused with the JAX gate's reason."""
    js = jbuilder.compile_scene(fog_cornell_desc(jbuilder, jpresets))
    ts = scene_from_numpy(_numpy_fields(js), device="cpu")
    for name in MED_FIELDS:
        assert np.array_equal(getattr(ts, name).numpy(),
                              np.asarray(getattr(js, name))), name
    assert MegaVolPathTracer.supports(ts) == (True, "")
    grid = fog_cornell_desc(jbuilder, jpresets,
                            density_grid=np.ones((2, 2, 2)))
    with pytest.raises(NotImplementedError, match="heterogeneous medium"):
        scene_from_numpy(_numpy_fields(jbuilder.compile_scene(grid)),
                         device="cpu")


# ---- the direct integrator -----------------------------------------------

@pytest.mark.parametrize("samples", [(1, 1), (2, 1)])
def test_direct_matches_jax(cornell, samples):
    """DirectIntegrator (emitter_samples, bsdf_samples) against the JAX
    DirectIntegrator on the same camera rays, pixel ids and seed: equal
    ray counts, and lane by lane under tests/test_torch_families.py's
    share-of-lanes rule (>= 99% of lanes within rel 1e-5 / abs 1e-6,
    every lane within rel 1e-4 / abs 1e-5)."""
    jscene, tscene = cornell
    ne, nb = samples
    o, d = _cornell_rays()
    n = o.shape[0]
    jint = JDirect(emitter_samples=ne, bsdf_samples=nb,
                   accel="dense").specialized_for(jscene)
    args = (jscene, jnp.asarray(o), jnp.asarray(d), jnp.uint32(SEED),
            jnp.arange(n, dtype=jnp.uint32), jnp.uint32(1))
    jL, jn = _compiled(jint.li_stats, *args)(*args)
    jL = np.asarray(jL)
    tL, tn = DirectIntegrator(emitter_samples=ne, bsdf_samples=nb).li_stats(
        tscene, torch.as_tensor(o), torch.as_tensor(d), SEED,
        torch.arange(n), 1)
    tL = tL.numpy()
    assert int(tn) == int(jn)
    assert jL.mean() > 0.05
    ok = np.isclose(tL, jL, rtol=RTOL, atol=ATOL).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    np.testing.assert_allclose(tL, jL, rtol=10 * RTOL, atol=10 * ATOL)


# ---- the eager VolPathTracer ----------------------------------------------

def test_volpath_vs_oracle():
    """The Cornell box in fog (tests/test_volpath.py:54-73: σt 0.8, 1.0,
    1.2, albedo 0.7, g 0.2) at 32², 6 spp, depth 6, seed 2 against the
    matched-stream numpy oracle under the image rule."""
    medium = {"sigma_t": (0.8, 1.0, 1.2), "albedo": (0.7, 0.7, 0.7),
              "g": 0.2}
    js = jbuilder.compile_scene(fog_cornell_desc(jbuilder, jpresets,
                                                 **medium))
    ref = render_volpath_oracle(js, jpresets.cornell_camera(32, 32), 32, 32,
                                spp=6, seed=2, max_depth=6)
    ts = tbuilder.compile_scene(fog_cornell_desc(tbuilder, tpresets,
                                                 **medium), device="cpu")
    img = render(ts, tpresets.cornell_camera(32, 32), TFilm(32, 32),
                 VolPathTracer(max_depth=6), 6, seed=2, device="cpu")
    _image_rule(img.numpy(), ref)


def test_volpath_matches_jax(fog_point):
    """The fog-and-point-light recipe (delta NEE through the medium,
    escaped rays through it) against the JAX VolPathTracer on the same
    rays, pixel ids and seed: the image rule, ray counts (active lanes
    and unoccluded NEE rays) within rel 1e-4, and >= 99% of the lanes
    within rel 2e-3 / abs 2e-4."""
    jscene, tscene, o, d = fog_point
    jint = JVol(max_depth=6, accel="dense").specialized_for(jscene)
    args = (jscene, jnp.asarray(o), jnp.asarray(d), jnp.uint32(SEED),
            jnp.arange(N, dtype=jnp.uint32), jnp.uint32(0))
    jL, jn = _compiled(jint.li_stats, *args)(*args)
    jL, jn = np.asarray(jL), int(jn)
    tL, tn = VolPathTracer(max_depth=6).li_stats(
        tscene, torch.as_tensor(o), torch.as_tensor(d), SEED,
        torch.arange(N), 0)
    tL, tn = tL.numpy(), int(tn)
    assert np.isfinite(jL).all() and jL.mean() > 0.01
    _image_rule(tL, jL)
    assert abs(tn - jn) <= 1e-4 * jn, (tn, jn)
    _lanes_close(tL, jL)


def test_beer_lambert():
    """Pure absorption (tests/test_volpath.py:75-100): an emitter seen
    through σt 0.5 over distance 3 averages 2·exp(-1.5) over 1024 samples
    of an 8×8 film (all 65,536 paths in one wavefront)."""
    desc = tbuilder.SceneDesc()
    desc.add_material(kind="diffuse", albedo=(0, 0, 0))
    desc.add_shape(tshapes.rectangle(), material=0, radiance=(2.0, 2.0, 2.0))
    desc.medium = tbuilder.Medium(sigma_t=(0.5,) * 3, albedo=(0.0,) * 3)
    scene = tbuilder.compile_scene(desc, cluster_size=64, device="cpu")
    cam = TCamera(width=8, height=8, fov_x=5.0,
                  to_world=ttf.look_at([0, 0, 3.0], [0, 0, 0], [0, 1, 0]))
    spp = 1024
    px = torch.arange(64).repeat(spp)
    samp = torch.arange(spp).repeat_interleave(64)
    pos = torch.stack([(px % 8).float() + 0.5, (px // 8).float() + 0.5], -1)
    o, d = cam.sample_ray(pos)
    L, _ = VolPathTracer(max_depth=2).li_stats(scene, o, d, 0, px, samp)
    expect = 2.0 * np.exp(-0.5 * 3.0)
    assert abs(L.mean().item() - expect) / expect < 0.03


def test_volpath_options():
    """There is no fused tail; max_depth <= 0, unbounded paths, is ported
    now and constructs (test_unbounded_volpath_matches_jax)."""
    assert VolPathTracer(max_depth=0).max_depth == 0
    with pytest.raises(ValueError, match="fused"):
        VolPathTracer(fused_shade="on")
    with pytest.raises(ValueError, match="fused"):
        DirectIntegrator(fused_shade="auto")


# ---- the megakernels' plain versions with the medium ---------------------

@pytest.mark.parametrize("name", ["fog", "fog_point"])
def test_megavol_plain_matches_eager(name, fog_point):
    """MegaVolPathTracer on CPU tensors (path_plain: VolPathTracer's bounce
    with the JAX megakernel's forms of the medium terms) against the eager
    VolPathTracer lane by lane on the two fog recipes: >= 99% of the
    lanes within rel 1e-5 / abs 1e-6, the image rule, and the kernel's
    attempted shadow rays at least VolPathTracer's unoccluded ones."""
    if name == "fog":
        scene = tbuilder.compile_scene(fog_cornell_desc(tbuilder, tpresets),
                                       device="cpu")
        o, d = (torch.as_tensor(x) for x in _cornell_rays())
    else:
        scene = fog_point[1]
        o, d = (torch.as_tensor(x) for x in fog_point[2:])
    n = o.shape[0]
    px = torch.arange(n)
    eL, en = VolPathTracer(max_depth=8).li_stats(scene, o, d, SEED, px, 0)
    mega = MegaVolPathTracer.for_scene(scene, max_depth=8)
    tmk.reset_launches()
    mL, mn = mega.li_stats(scene, o, d, SEED, px, 0)
    assert sum(tmk.LAUNCHES.values()) == 0      # CPU: the plain version
    eL, mL = eL.numpy(), mL.numpy()
    ok = np.isclose(mL, eL, rtol=RTOL, atol=ATOL).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    _image_rule(mL, eL)
    assert int(mn) >= int(en) > n
    if name == "fog":
        assert eL.mean() < 0.1          # the fog attenuates


def test_megavol_persistent_matches_render():
    """render_persistent against render() with MegaVolPathTracer at 16², 4
    spp on the foggy Cornell box of tests/test_mega_tpu.py:367-392: mean
    rel < 0.01, equal ray counts (both the kernel's per-lane paths)."""
    desc = fog_cornell_desc(tbuilder, tpresets, sigma_t=(0.6, 0.7, 0.8),
                            albedo=(0.9, 0.85, 0.8), g=0.2)
    scene = tbuilder.compile_scene(desc, device="cpu")
    cam = tpresets.cornell_camera(16, 16)
    integ = MegaVolPathTracer.for_scene(scene, max_depth=8)
    img_p, n_p = render_persistent(integ, cam, 4, seed=0)
    img_m, n_m = render_fn(scene, cam, TFilm(16, 16), integ, 4, seed=0,
                           device="cpu")
    assert torch.isfinite(img_p).all()
    rel = abs(img_p.mean() - img_m.mean()) / img_m.mean()
    assert rel < 0.01, (img_p.mean(), img_m.mean())
    assert int(n_p) == int(n_m)


def test_mega_medium_gates():
    """supports() gives the JAX gate's answer and reason: a medium refused
    by MegaPathTracer, accepted by MegaVolPathTracer; a density grid and
    SGGX or fiber rows refused by both."""
    js = jbuilder.compile_scene(fog_cornell_desc(jbuilder, jpresets))
    ts = tbuilder.compile_scene(fog_cornell_desc(tbuilder, tpresets),
                                device="cpu")
    grid = np.ones((2, 2, 2), np.float32)
    sggx = np.float32([1, 1, 1, 0, 0, 0])
    fiber = np.float32([0, 0, 1])
    cases = [{}, {"med_grid": grid}, {"med_sggx": sggx},
             {"med_fiber": fiber}]
    for fields in cases:
        jsc = js._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
        tsc = ts._replace(**{k: torch.as_tensor(v)
                             for k, v in fields.items()})
        for allow in (False, True):
            want = JMega.supports(jsc, allow_medium=allow)
            assert MegaPathTracer.supports(tsc, allow_medium=allow) == want
        assert MegaVolPathTracer.supports(tsc) == JMega.supports(
            jsc, allow_medium=True)
    assert MegaPathTracer.supports(ts) == (False, "participating medium")
    assert MegaVolPathTracer.supports(ts) == (True, "")
    with pytest.raises(NotImplementedError, match="participating medium"):
        MegaPathTracer.for_scene(ts)
    tables = MegaVolPathTracer.for_scene(ts).tables
    assert tables.ext
    assert tables.medium == tuple(float(np.float32(x)) for x in (
        *FOG_CORNELL["sigma_t"], *FOG_CORNELL["albedo"], FOG_CORNELL["g"],
        1e30))


def test_unbounded_volpath_matches_jax():
    """VolPathTracer(max_depth=0), unbounded (no depth guard, 32 bounces a
    pass, as the JAX volpath.py:108-109, :171-172, :197), on the foggy
    Cornell box against the JAX VolPathTracer(max_depth=0) at 16², 2 spp
    on render()'s camera rays (test_torch_path's passes): the image rule
    on the pass mean, the ray counts (active lanes and unoccluded NEE rays)
    within rel 1e-4, and >= 99% of the lanes within rel 2e-3 / abs 2e-4."""
    from test_torch_path import (UNB_RES, UNB_SEED, UNB_SPP, camera_passes,
                                 jax_li_passes, port_li_passes)
    jscene = jbuilder.compile_scene(fog_cornell_desc(jbuilder, jpresets))
    tscene = tbuilder.compile_scene(fog_cornell_desc(tbuilder, tpresets),
                                    device="cpu")
    passes = camera_passes(jpresets.cornell_camera(UNB_RES, UNB_RES),
                           UNB_RES, UNB_SPP, UNB_SEED)
    jL, jn = jax_li_passes(
        JVol(max_depth=0, accel="dense").specialized_for(jscene), jscene,
        passes, UNB_SEED)
    tL, tn = port_li_passes(VolPathTracer(max_depth=0), tscene, passes,
                            UNB_SEED)
    assert np.isfinite(jL).all() and jL.mean() > 0.005
    _image_rule(tL.mean(0), jL.mean(0))
    assert abs(tn - jn) <= 1e-4 * jn, (tn, jn)
    _lanes_close(tL.reshape(-1, 3), jL.reshape(-1, 3))
