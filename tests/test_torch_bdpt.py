"""The port's BDPT (integrator/bdpt.py) against the JAX package on the
CPU: the Cornell box at cluster size 128, 256 camera rays over an 8×8
film, depth 3 (every strategy kind: l = 0, 1 and the subpath connection
(1, 2)). The JAX li_stats runs once for the file (jitted); both of its
_walk calls (the eye and the light subpath) are recorded at run time,
inputs and vertex records."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_light_subpaths import (CLUSTER, SEED, assert_lanes, camera_rays,
                                  cornell, jx, lanes_of_samples,
                                  pixel_means, recorder, tensors)

from mitsuba_tpu.integrator import bdpt as jbdpt
from mitsuba_tpu_torch.emitter.emitter import sample_emitter_ray
from mitsuba_tpu_torch.integrator import bdpt
from mitsuba_tpu_torch.integrator.bdpt import BDPT, WALK_KEYS
from mitsuba_tpu_torch.integrator.common import offset_ray_origin
from mitsuba_tpu_torch.integrator.path import PathTracer

torch.set_num_threads(2)

N = 256
DEPTH = 3
SAMPLE = 1
EXACT = ("mat_id", "delta", "valid", "em_id")


def _record_walks(mp, cls, got):
    """Patch cls._walk to record each call's inputs (o0, d0, beta,
    pdf_omega, active) and its records, in call order."""
    orig = cls._walk

    def walk(self, scene, o0, d0, beta, pdf, active, *rest):
        out = orig(self, scene, o0, d0, beta, pdf, active, *rest)
        key = f"walk{sum(k.startswith('walk') for k in got)}"
        if isinstance(o0, torch.Tensor):
            got[key] = [x.clone() for x in (o0, d0, beta, pdf, active)] \
                + [out[k].clone() for k in WALK_KEYS]
        else:
            recorder(got, key, o0, d0, beta, pdf, active,
                     *(out[k] for k in WALK_KEYS))
            got[key] = None     # claimed now, filled when the program runs
        return out
    mp.setattr(cls, "_walk", walk)


@pytest.fixture(scope="module")
def ref():
    """(port scene, camera, rays o, d, the JAX (L, count), the JAX walks
    {"walk0": eye, "walk1": light} as 5 inputs + WALK_KEYS records)."""
    jscene, tscene, cam = cornell()
    o, d = camera_rays(cam, N)
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        _record_walks(mp, jbdpt.BDPT, got)
        ji = jbdpt.BDPT(max_depth=DEPTH, cluster_size=CLUSTER) \
            .specialized_for(jscene)
        fn = jax.jit(lambda o, d: ji.li_stats(
            jscene, o, d, jnp.uint32(SEED), jnp.arange(N, dtype=jnp.uint32),
            jnp.uint32(SAMPLE)))
        jL, jn = fn(jx(o), jx(d))
        jL = np.asarray(jL)
        jax.effects_barrier()
    return tscene, cam, o, d, (jL, int(jn)), got


def test_emitter_start_matches_bdpt(ref):
    """sample_emitter_ray on BDPT's draws (_LIGHT_DIM_BASE − 4, −3, −2)
    gives the JAX BDPT's light start (bdpt.py:145-170): the light walk's
    first ray (origin, direction) under assert_start's rule, its active
    lanes, and the start's weight Le·cos/(pdf_pos·pdf_dir) and pdf_dir
    as the port's li_stats hands them to its light walk, within rel
    1e-4 (both carry the direction's difference through its cosine)."""
    tscene, _, o, d, _, got = ref
    tracer = BDPT(max_depth=DEPTH).specialized_for(tscene)
    pid = torch.arange(N)
    base = bdpt._LIGHT_DIM_BASE
    er = sample_emitter_ray(tscene, tracer._d1(SEED, pid, SAMPLE, base - 4),
                            tracer._d2(SEED, pid, SAMPLE, base - 3),
                            tracer._d2(SEED, pid, SAMPLE, base - 2))
    o0, d0, beta, pdf, active = got["walk1"][:5]
    assert np.abs(offset_ray_origin(er.p, er.n, er.d).numpy() - o0).max() \
        <= 2.5e-7
    assert np.abs(er.d.numpy() - d0).max() <= 1e-5
    assert np.array_equal(er.is_area.numpy(), active)
    mine = {}
    with pytest.MonkeyPatch.context() as mp:
        _record_walks(mp, BDPT, mine)
        tracer.li_stats(tscene, *tensors(o, d), SEED, pid, SAMPLE)
    assert_lanes(mine["walk1"][2].numpy(), beta)
    assert_lanes(mine["walk1"][3].numpy(), pdf)


@pytest.mark.parametrize("walk", ["walk0", "walk1"])
def test_walk_matches_jax(ref, walk):
    """_walk on the JAX walk's own inputs (walk0 the eye subpath, DEPTH
    vertices; walk1 the light subpath, DEPTH − 1): the hit, material,
    delta, validity and emitter records equal, the others within rel
    1e-4 of the JAX ones (floor 1e-3) on the valid vertices."""
    tscene, _, _, _, _, got = ref
    rec = got[walk]
    steps, base = (DEPTH, 0) if walk == "walk0" else \
        (DEPTH - 1, bdpt._LIGHT_DIM_BASE)
    out = BDPT(max_depth=DEPTH).specialized_for(tscene)._walk(
        tscene, *tensors(*rec[:5]), SEED, torch.arange(N), SAMPLE, steps,
        base)
    want = dict(zip(WALK_KEYS, rec[5:]))
    valid = want["valid"]
    assert valid.sum() > N
    for key in WALK_KEYS:
        mine = out[key].numpy()
        if key in EXACT:
            assert np.array_equal(mine, want[key]), key
        else:
            assert_lanes(mine[valid], want[key][valid])


def test_li_stats_matches_jax(ref):
    """li_stats lane by lane within rel 1e-4 (floor 1e-3), and the count
    (the unoccluded connections) equal."""
    tscene, _, o, d, (jL, jn), _ = ref
    L, n = BDPT(max_depth=DEPTH).li_stats(tscene, *tensors(o, d), SEED,
                                          torch.arange(N), SAMPLE)
    assert_lanes(L.numpy(), jL)
    assert int(n) == jn
    assert jL.mean() > 0.05


def test_mean_matches_path_tracer(ref):
    """BDPT and the port's PathTracer estimate the same image
    (tests/test_bdpt.py's rule at depth 4): 256 samples a pixel as lanes
    of one li_stats call each, the means within 4%."""
    tscene, cam, _, _, _, _ = ref
    spp = 256
    o, d, px, samp = lanes_of_samples(cam, spp)
    img_b = pixel_means(BDPT(max_depth=4).li_stats(
        tscene, o, d, SEED, px, samp)[0], spp)
    img_p = pixel_means(PathTracer(max_depth=4, rr_depth=99).li_stats(
        tscene, o, d, SEED + 1, px, samp)[0], spp)
    rel = abs(img_b.mean() - img_p.mean()) / img_p.mean()
    assert rel < 0.04, (img_b.mean(), img_p.mean(), rel)
