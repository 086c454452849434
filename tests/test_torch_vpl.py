"""The port's VPL and lightcuts integrators (integrator/vpl.py,
integrator/lightcuts.py) against the JAX package on the CPU: the Cornell
box at cluster size 128, 64 camera rays over an 8×8 film, 64 VPL paths
at depth 5. The JAX VPL table, its light tree and both shadings run once
for the file (jitted); the VPL walk's emitter start is read at run time
from its first offset_ray_origin call."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_light_subpaths import (CLUSTER, RES, SEED, assert_lanes,
                                  assert_start, camera_rays, cornell, jx,
                                  record_offsets, tensors)

from mitsuba_tpu.film.film import Film as JFilm
from mitsuba_tpu.integrator import lightcuts as jlc
from mitsuba_tpu.integrator import vpl as jvpl
from mitsuba_tpu.render import render as jrender
from mitsuba_tpu.scene import presets as jpresets
from mitsuba_tpu_torch.core import rng
from mitsuba_tpu_torch.emitter.emitter import sample_emitter_ray
from mitsuba_tpu_torch.film.film import Film
from mitsuba_tpu_torch.integrator import vpl
from mitsuba_tpu_torch.integrator.common import (DIM_BSDF_U2, DIM_NEE_POS,
                                                 DIM_NEE_SEL, bounce_dim,
                                                 offset_ray_origin)
from mitsuba_tpu_torch.integrator.lightcuts import (LightcutsIntegrator,
                                                    build_light_tree)
from mitsuba_tpu_torch.integrator.vpl import VPLIntegrator, VPLs
from mitsuba_tpu_torch.render import render_fn

torch.set_num_threads(2)

N = RES * RES
PATHS = 64
DEPTH = 5
KW = dict(max_depth=DEPTH, n_paths=PATHS)


@pytest.fixture(scope="module")
def ref():
    """(JAX scene, port scene, camera, rays o, d, the JAX VPL table, the
    JAX start, li_with_vpls, light tree and li_with_tree, as numpy)."""
    jscene, tscene, cam = cornell()
    o, d = camera_rays(cam, N)
    pid = jnp.arange(N, dtype=jnp.uint32)
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        record_offsets(mp, jvpl, got)
        jv = jvpl.VPLIntegrator(cluster_size=CLUSTER, **KW) \
            .specialized_for(jscene)
        vpls = jax.jit(lambda: jv.generate_vpls(jscene, SEED))()
        jax.effects_barrier()
    L_vpl = np.asarray(jax.jit(lambda o, d: jv.li_with_vpls(
        jscene, vpls, o, d, SEED, pid))(jx(o), jx(d)))
    tree = jlc.build_light_tree(jax.device_get(vpls))
    jl = jlc.LightcutsIntegrator(cluster_size=CLUSTER, **KW) \
        .specialized_for(jscene)
    L_tree = np.asarray(jax.jit(lambda o, d: jl.li_with_tree(
        jscene, tree, o, d, SEED, pid))(jx(o), jx(d)))
    return dict(jscene=jscene, tscene=tscene, cam=cam, o=o, d=d,
                vpls=[np.asarray(x) for x in vpls], start=got["start"],
                L_vpl=L_vpl, tree=[np.asarray(x) for x in tree],
                L_tree=L_tree)


def _port_vpls(ref):
    v = ref["vpls"]
    return VPLs(*tensors(*v[:4]), torch.as_tensor(v[4]).long(),
                *tensors(*v[5:]))


def test_emitter_start_matches_vpl(ref):
    """sample_emitter_ray on the VPL walk's draws (_VPL_DIM_BASE + the
    first bounce's dims) gives the JAX generate_vpls start
    (vpl.py:69-106) under assert_start's rule, and the emitter VPLs'
    flux Le·(π·A/pmf)/n_paths and validity bit for bit."""
    pid = torch.arange(PATHS)
    base = vpl._VPL_DIM_BASE
    er = sample_emitter_ray(
        ref["tscene"],
        rng.sample_1d(SEED, pid, base + bounce_dim(0, DIM_NEE_SEL)),
        rng.sample_2d(SEED, pid, base + bounce_dim(0, DIM_NEE_POS)),
        rng.sample_2d(SEED, pid, base + bounce_dim(0, DIM_BSDF_U2)))
    assert_start(er, offset_ray_origin(er.p, er.n, er.d), ref["start"])
    mine = VPLIntegrator(**KW).generate_vpls(ref["tscene"], SEED)
    assert np.array_equal(mine.flux[:PATHS].numpy(), ref["vpls"][3][:PATHS])
    assert np.array_equal(mine.valid[:PATHS].numpy(), ref["vpls"][6][:PATHS])


def test_generate_vpls_matches_jax(ref):
    """generate_vpls: the validity and the valid VPLs' materials equal,
    their positions, normals, directions, flux and uv within rel 1e-4
    (floor 1e-3)."""
    mine = VPLIntegrator(**KW).generate_vpls(ref["tscene"], SEED)
    want = ref["vpls"]
    valid = want[6]
    assert np.array_equal(mine.valid.numpy(), valid) and valid.sum() > PATHS
    assert np.array_equal(mine.mat_id.numpy()[valid], want[4][valid])
    for got, w in zip((mine.p, mine.n, mine.wi, mine.flux, mine.uv),
                      (want[0], want[1], want[2], want[3], want[5])):
        assert_lanes(got.numpy()[valid], w[valid])


def test_li_with_vpls_matches_jax(ref, monkeypatch):
    """li_with_vpls on the JAX VPL table lane by lane within rel 1e-4
    (floor 1e-3); chunks of 64 VPLs (one trace call each) give the same
    bits as one chunk of all, the contributions being added in VPL order
    either way. li_stats is li_with_vpls on generate_vpls(seed), its
    count the walk's rays, one a camera ray and one an attempted shadow
    ray."""
    tscene = ref["tscene"]
    integ = VPLIntegrator(**KW)
    o, d = tensors(ref["o"], ref["d"])
    L = integ.li_with_vpls(tscene, _port_vpls(ref), o, d, SEED,
                           torch.arange(N))
    assert_lanes(L.numpy(), ref["L_vpl"])
    assert ref["L_vpl"].mean() > 0.05
    monkeypatch.setattr(vpl, "CHUNK_LANES", 64 * N)
    assert torch.equal(integ.li_with_vpls(tscene, _port_vpls(ref), o, d,
                                          SEED, torch.arange(N)), L)
    L2, n_rays = integ.li_stats(tscene, o, d, SEED, torch.arange(N))
    table, walk = integ._generate(tscene, SEED)
    assert torch.equal(L2, integ.li_with_vpls(tscene, table, o, d, SEED,
                                              torch.arange(N)))
    assert int(n_rays) > int(walk) + N


def test_build_light_tree_equal(ref):
    """build_light_tree on the JAX VPL table: every array of the tree
    equal to the JAX one (the same host algorithm)."""
    tree = build_light_tree(_port_vpls(ref))
    for got, want in zip(tree, ref["tree"]):
        assert np.array_equal(got.numpy(), want)


def test_li_with_tree_matches_jax(ref):
    """li_with_tree on the JAX tree lane by lane within rel 1e-4 (floor
    1e-3)."""
    o, d = tensors(ref["o"], ref["d"])
    L = LightcutsIntegrator(**KW).li_with_tree(
        ref["tscene"], build_light_tree(_port_vpls(ref)), o, d, SEED,
        torch.arange(N))
    assert_lanes(L.numpy(), ref["L_tree"])
    assert ref["L_tree"].mean() > 0.05


def test_lightcuts_render_fn(ref):
    """The JAX render() cannot run a LightcutsIntegrator: its li builds the
    light tree with numpy from traced arrays (ROADMAP.md Queue C). The
    port's render_fn renders the same scene through li_stats (the tree
    built on the host a pass), bit for bit its own render() (one VPL set
    and tree, the same camera rays)."""
    jl = jlc.LightcutsIntegrator(cluster_size=CLUSTER, **KW) \
        .specialized_for(ref["jscene"])
    with pytest.raises(jax.errors.TracerArrayConversionError):
        jrender(ref["jscene"], jpresets.cornell_camera(RES, RES),
                JFilm(width=RES, height=RES), jl, 1, SEED)
    integ = LightcutsIntegrator(**KW)
    film = Film(RES, RES)
    img, n_rays = render_fn(ref["tscene"], ref["cam"], film, integ, 2, SEED,
                            device="cpu")
    assert torch.equal(img, integ.render(ref["tscene"], ref["cam"], film, 2,
                                         SEED, device="cpu"))
    assert bool(torch.isfinite(img).all()) and img.mean() > 0.05
    assert int(n_rays) > 2 * N
