"""The port's path tracer and render() against the JAX package on the CPU.

The JAX integrator runs specialized to the scene's BSDF families
(PathTracer.specialized_for): the same estimator with diffuse-only
dispatch, which compiles in seconds instead of a minute."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.film.film import Film as JFilm
from mitsuba_tpu.integrator.path import PathTracer as JPath
from mitsuba_tpu.render import render as jrender
from mitsuba_tpu.scene import presets as jpresets
from mitsuba_tpu.scene.builder import compile_scene as jcompile
from mitsuba_tpu_torch.convert import scene_from_numpy
from mitsuba_tpu_torch.film.film import Film as TFilm
from mitsuba_tpu_torch.integrator.path import PathTracer as TPath
from mitsuba_tpu_torch.render import render as trender
from mitsuba_tpu_torch.render import render_fn as trender_fn
from mitsuba_tpu_torch.scene import presets as tpresets
from mitsuba_tpu_torch.scene.builder import compile_scene as tcompile

torch.set_num_threads(2)

RES = 32


@pytest.fixture(scope="module")
def cornell():
    return (jcompile(jpresets.cornell_box()),
            tcompile(tpresets.cornell_box(), device="cpu"))


def _primary_rays(seed=0):
    rs = np.random.RandomState(seed)
    pos = ((np.stack(np.meshgrid(np.arange(RES), np.arange(RES)), -1)
            .reshape(-1, 2) + rs.rand(RES * RES, 2)).astype(np.float32))
    o, d = jpresets.cornell_camera(RES, RES).sample_ray(jnp.asarray(pos))
    return np.array(o), np.array(d)


@pytest.fixture(scope="module")
def li_stats_pair(cornell):
    """(o, d, seed) -> (JAX L, JAX count, port L, port count) on the same
    primary rays, pixel ids and sample index; the JAX side compiles once."""
    jscene, tscene = cornell
    px = np.arange(RES * RES, dtype=np.uint32) * 7 + 3
    jint = JPath(max_depth=8).specialized_for(jscene)
    jfn = jax.jit(lambda o, d, seed: jint.li_stats(
        jscene, o, d, seed, jnp.asarray(px), jnp.uint32(2)))

    def run(o, d, seed):
        jL, jn = jfn(jnp.asarray(o), jnp.asarray(d), jnp.uint32(seed))
        tL, tn = TPath(max_depth=8).li_stats(
            tscene, torch.as_tensor(o), torch.as_tensor(d), seed,
            torch.as_tensor(px.astype(np.int64)), 2)
        return np.asarray(jL), int(jn), tL.numpy(), int(tn)
    return run


def test_li_stats_lane_parity(li_stats_pair):
    """Identical primary rays at 32², max_depth 8: the traced-ray count is
    exactly equal, and ≥ 99% of lanes agree to rel 1e-3 (lanes whose path
    forks at a decision boundary, e.g. RR, may differ).

    The two packages' hit points differ in the last ulp (XLA's matmul
    intersector against elementwise sums), so a lane sitting on a decision
    boundary can move the count by one without changing any radiance
    (test_li_stats_count_boundary_lanes shows two such lanes). With jitter
    and sampler seed 0 no lane sits on such a boundary."""
    o, d = _primary_rays()
    jL, jn, tL, tn = li_stats_pair(o, d, 0)
    assert tn == jn
    rel = np.abs(tL - jL).max(-1) / np.maximum(np.abs(jL).max(-1), 1e-3)
    assert (rel <= 1e-3).mean() >= 0.99, (rel > 1e-3).mean()
    assert jL.mean() > 0.05


# Seed 6: lanes whose ray count differs by one between the packages,
# found by re-running li_stats with all other lanes pointed out of the box
BOUNDARY_SEED, BOUNDARY_LANES = 6, [110, 299]


def test_li_stats_count_boundary_lanes(li_stats_pair):
    """At a seed where the counts differ, the difference is confined to
    named boundary lanes: it is at most one ray per such lane, pointing
    those lanes out of the box (a miss: one ray in both packages) makes
    the counts exactly equal, and their radiance agrees to rel 1e-5."""
    o, d = _primary_rays(BOUNDARY_SEED)
    jL, jn, tL, tn = li_stats_pair(o, d, BOUNDARY_SEED)
    assert abs(tn - jn) <= len(BOUNDARY_LANES), (tn, jn)
    lanes = np.asarray(BOUNDARY_LANES)
    np.testing.assert_allclose(tL[lanes], jL[lanes], rtol=1e-5, atol=0)
    d_out = d.copy()
    d_out[lanes] = [0.0, 0.0, 1.0]      # away from the box, past the camera
    _, jn_out, _, tn_out = li_stats_pair(o, d_out, BOUNDARY_SEED)
    assert tn_out == jn_out


def _image_rule(img, ref):
    """tests/test_render.py's rule: < 1% of values off by rel > 5e-2, and
    the means within rel 5e-3."""
    rel = np.abs(img - ref) / np.maximum(ref, 1e-3)
    frac_bad = (rel > 5e-2).mean()
    assert frac_bad < 1e-2, (frac_bad, img.mean(), ref.mean())
    assert np.abs(img.mean() - ref.mean()) / ref.mean() < 5e-3


def test_render_matches_jax(cornell):
    """render() at 32², 4 spp, max_depth 8, seed 3 against the JAX
    render(); both draw the same PCG4D sample stream."""
    jscene, tscene = cornell
    cam_j = jpresets.cornell_camera(RES, RES)
    ref = np.asarray(jrender(jscene, cam_j, JFilm(RES, RES, "box"),
                             JPath(max_depth=8).specialized_for(jscene),
                             spp=4, seed=3))
    img = trender(tscene, tpresets.cornell_camera(RES, RES),
                  TFilm(RES, RES, "box"), TPath(max_depth=8), spp=4, seed=3,
                  device="cpu").numpy()
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all()
    _image_rule(img, ref)


def test_render_of_carried_scene(cornell):
    """The JAX scene carried across with scene_from_numpy renders the same
    image, and counts the same rays, as the port's own compile_scene."""
    jscene, tscene = cornell
    arrays = {k: (None if v is None else np.asarray(v))
              for k, v in jscene._asdict().items() if k != "em_pmf"}
    arrays["em_pmf"] = {k: np.asarray(v)
                        for k, v in jscene.em_pmf._asdict().items()}
    carried = scene_from_numpy(arrays, device="cpu")
    args = (tpresets.cornell_camera(16, 16), TFilm(16, 16, "box"),
            TPath(max_depth=4), 2, 1, "cpu")
    img_a, n_a = trender_fn(carried, *args)
    img_b, n_b = trender_fn(tscene, *args)
    assert int(n_a) == int(n_b) > 0
    np.testing.assert_allclose(img_a.numpy(), img_b.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_render_rejects_device_mismatch(cornell):
    _, tscene = cornell
    with pytest.raises(ValueError, match="lives on cpu"):
        trender(tscene, tpresets.cornell_camera(8, 8), TFilm(8, 8, "box"),
                TPath(), 1, device="meta")


def test_path_tracer_rejects_unported():
    """An unknown accel raises; max_depth <= 0, unbounded paths, is
    ported now and constructs (test_unbounded_matches_jax)."""
    assert TPath(max_depth=0).max_depth == 0
    assert TPath(max_depth=-1).max_depth == -1
    with pytest.raises(ValueError, match="accel"):
        TPath(accel="pallas")


UNB_RES, UNB_SPP, UNB_SEED = 16, 2, 3


def camera_passes(jcam, res, spp, seed):
    """render()'s camera rays of a res² film for sample passes 0..spp-1,
    from the JAX sensor: [(o, d) numpy [res², 3]] a pass."""
    from mitsuba_tpu.core import rng as jrng
    from mitsuba_tpu.integrator.common import DIM_APERTURE, DIM_PIXEL
    px = jnp.arange(res * res, dtype=jnp.uint32)

    @jax.jit
    def rays(s):
        jit = jrng.sample_2d(seed, px, DIM_PIXEL, s)
        pos = jnp.stack([(px % res).astype(jnp.float32) + jit[:, 0],
                         (px // res).astype(jnp.float32) + jit[:, 1]], -1)
        return jcam.sample_ray(pos, jrng.sample_2d(seed, px, DIM_APERTURE,
                                                   s))
    return [tuple(np.array(x) for x in rays(jnp.uint32(s)))
            for s in range(spp)]


def jax_li_passes(jint, jscene, passes, seed):
    """The JAX integrator's li_stats over camera_passes' rays, compiled
    once (test_torch_shade._compiled): (L [spp, N, 3], summed ray count)."""
    from test_torch_shade import _compiled
    px = jnp.arange(passes[0][0].shape[0], dtype=jnp.uint32)
    args = lambda o, d, s: (jscene, jnp.asarray(o), jnp.asarray(d),
                            jnp.uint32(seed), px, jnp.uint32(s))
    fn = _compiled(jint.li_stats, *args(*passes[0], 0))
    out = [fn(*args(o, d, s)) for s, (o, d) in enumerate(passes)]
    return (np.stack([np.asarray(L) for L, _ in out]),
            sum(int(n) for _, n in out))


def port_li_passes(tint, tscene, passes, seed):
    """The port's li_stats over the same passes: (L [spp, N, 3], rays)."""
    out = [tint.li_stats(tscene, torch.as_tensor(o), torch.as_tensor(d),
                         seed, torch.arange(o.shape[0]), s)
           for s, (o, d) in enumerate(passes)]
    return (np.stack([L.numpy() for L, _ in out]),
            sum(int(n) for _, n in out))


def test_unbounded_matches_jax(cornell):
    """PathTracer(max_depth=0), unbounded (no depth guard, 32 bounces a
    pass), against the JAX PathTracer(max_depth=0) at 16², 2 spp on
    render()'s camera rays: the image rule on the pass mean, the ray counts
    within rel 1e-4, >= 99% of the lanes within rel 1e-3; and it traces
    more rays than max_depth 8 on the same rays (paths go past 8)."""
    jscene, tscene = cornell
    passes = camera_passes(jpresets.cornell_camera(UNB_RES, UNB_RES),
                           UNB_RES, UNB_SPP, UNB_SEED)
    jL, jn = jax_li_passes(JPath(max_depth=0).specialized_for(jscene),
                           jscene, passes, UNB_SEED)
    tL, tn = port_li_passes(TPath(max_depth=0), tscene, passes, UNB_SEED)
    _image_rule(tL.mean(0), jL.mean(0))
    assert abs(tn - jn) <= 1e-4 * jn, (tn, jn)
    rel = np.abs(tL - jL).max(-1) / np.maximum(np.abs(jL).max(-1), 1e-3)
    assert (rel <= 1e-3).mean() >= 0.99, (rel > 1e-3).mean()
    _, n8 = port_li_passes(TPath(max_depth=8), tscene, passes, UNB_SEED)
    assert tn > n8, (tn, n8)
