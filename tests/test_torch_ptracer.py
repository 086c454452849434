"""The port's particle tracer (integrator/ptracer.py) and the shared
emitter start (emitter.sample_emitter_ray) against the JAX package on
the CPU: the Cornell box at cluster size 128, an 8×8 film. The JAX
ParticleTracer renders once for the file (jitted); its emitter start is
read at run time from its first offset_ray_origin call."""
import jax
import numpy as np
import pytest
import torch

from torch_light_subpaths import (CLUSTER, RES, SEED, assert_lanes,
                                  assert_start, cornell, lanes_of_samples,
                                  pixel_means, record_offsets)

from mitsuba_tpu.integrator import ptracer as jptracer
from mitsuba_tpu.scene import presets as jpresets
from mitsuba_tpu_torch.core import rng
from mitsuba_tpu_torch.emitter.emitter import sample_emitter_ray
from mitsuba_tpu_torch.integrator.common import (DIM_BSDF_U2, DIM_NEE_POS,
                                                 DIM_NEE_SEL, bounce_dim,
                                                 offset_ray_origin)
from mitsuba_tpu_torch.integrator.path import PathTracer
from mitsuba_tpu_torch.integrator.ptracer import ParticleTracer

torch.set_num_threads(2)

N_PARTICLES = 4096
DEPTH = 8


@pytest.fixture(scope="module")
def ref():
    """(port scene, port camera, the JAX image of N_PARTICLES particles
    at DEPTH, the JAX start's (p, n, d, offset origin))."""
    jscene, tscene, cam = cornell()
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        record_offsets(mp, jptracer, got)
        lt = jptracer.ParticleTracer(max_depth=DEPTH, cluster_size=CLUSTER) \
            .specialized_for(jscene)
        jcam = jpresets.cornell_camera(RES, RES)
        img = np.asarray(jax.jit(
            lambda: lt.render(jscene, jcam, N_PARTICLES, SEED))())
        jax.effects_barrier()
    return tscene, cam, img, got["start"]


def test_emitter_start_matches_ptracer(ref):
    """sample_emitter_ray on the light tracer's draws gives the JAX
    ParticleTracer's start (ptracer.py:71-105): its point, normal,
    emission direction and offset origin (assert_start's rule)."""
    tscene, _, _, start = ref
    pid = torch.arange(N_PARTICLES)
    er = sample_emitter_ray(
        tscene, rng.sample_1d(SEED, pid, bounce_dim(0, DIM_NEE_SEL)),
        rng.sample_2d(SEED, pid, bounce_dim(0, DIM_NEE_POS)),
        rng.sample_2d(SEED, pid, bounce_dim(0, DIM_BSDF_U2)))
    assert_start(er, offset_ray_origin(er.p, er.n, er.d), start)
    assert bool(er.is_area.all())


def test_render_matches_jax(ref):
    """ParticleTracer.render at 4,096 particles, depth 8: every pixel
    within rel 1e-4 of the JAX image (floor 1e-3); the ray count is one
    a live walk ray and one an attempted camera connection, more than
    one a particle."""
    tscene, cam, img, _ = ref
    out, n_rays = ParticleTracer(max_depth=DEPTH).render_stats(
        tscene, cam, N_PARTICLES, SEED, device="cpu")
    assert out.shape == (RES, RES, 3)
    assert_lanes(out.numpy(), img)
    assert img.mean() > 0.05
    assert int(n_rays) > N_PARTICLES


def test_mean_matches_path_tracer(ref):
    """The light tracer and the port's PathTracer estimate the same image
    (tests/test_ptracer.py's rule): 2^14 particles against 256 samples a
    pixel (lanes of one li_stats call) at depth 3, the means within 8%
    and the pixel means correlated above 0.8."""
    tscene, cam, _, _ = ref
    light = ParticleTracer(max_depth=3).render(tscene, cam, 1 << 14, 1,
                                               device="cpu").numpy()
    spp = 256
    o, d, px, samp = lanes_of_samples(cam, spp)
    L, _ = PathTracer(max_depth=3).li_stats(tscene, o, d, SEED, px, samp)
    eye = pixel_means(L, spp)
    assert abs(light.mean() - eye.mean()) / eye.mean() < 0.08, (
        light.mean(), eye.mean())
    corr = np.corrcoef(light.mean(-1).ravel(), eye.mean(-1).ravel())[0, 1]
    assert corr > 0.8, corr


def test_li_is_the_path_tracer(ref):
    """li and li_stats are PathTracer's, as the JAX ParticleTracer
    inherits them: render_fn and the command line path-trace."""
    tscene, cam, _, _ = ref
    o, d, px, samp = lanes_of_samples(cam, 2)
    got = ParticleTracer(max_depth=4).li_stats(tscene, o, d, SEED, px, samp)
    want = PathTracer(max_depth=4).li_stats(tscene, o, d, SEED, px, samp)
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
