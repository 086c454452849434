"""The port's photon mapping (integrator/photonmap.py) against the JAX
package on the CPU: the Cornell box at cluster size 128, 4,096 photons
at depth 5, 64 camera rays over an 8×8 film. The JAX photon walk and
the eye pass run once for the file (jitted); the walk's emitter start is
read at run time from its first offset_ray_origin call, and the photon
estimate from the eye pass's gather_radiance call."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_light_subpaths import (CLUSTER, RES, SEED, assert_lanes,
                                  assert_share, assert_start, camera_rays,
                                  cornell, jx, record_offsets, recorder,
                                  tensors)

from mitsuba_tpu.integrator import photonmap as jpm
from mitsuba_tpu_torch.core import rng
from mitsuba_tpu_torch.emitter.emitter import sample_emitter_ray
from mitsuba_tpu_torch.film.film import Film
from mitsuba_tpu_torch.integrator import photonmap as pm
from mitsuba_tpu_torch.integrator.common import offset_ray_origin
from mitsuba_tpu_torch.integrator.photonmap import (PhotonMap, PhotonMapper,
                                                    build_photon_map,
                                                    progressive_radii,
                                                    render_progressive,
                                                    trace_photons)
from mitsuba_tpu_torch.render import render

torch.set_num_threads(2)

N = RES * RES
PHOTONS = 4096
DEPTH = 5
RADIUS = 0.05
KW = dict(max_depth=DEPTH, n_photons=PHOTONS, gather_radius=RADIUS,
          photon_depth=DEPTH, specular_chain=1)


def _record_gather(mp, module, got):
    """Patch module.gather_radiance to record its output in got["gather"]
    (numpy, or a tensor for the port's)."""
    orig = module.gather_radiance

    def wrapped(*args, **kw):
        out = orig(*args, **kw)
        if isinstance(out, torch.Tensor):
            got["gather"] = out.clone()
        else:
            recorder(got, "gather", out)
        return out
    mp.setattr(module, "gather_radiance", wrapped)


@pytest.fixture(scope="module")
def ref():
    """The port scene and camera, rays o, d, the JAX photons (pos, power,
    normal, wi, valid), the JAX start, the bounds, the JAX map, and the
    JAX eye pass's L and photon estimate, as numpy."""
    jscene, tscene, cam = cornell()
    o, d = camera_rays(cam, N)
    got = {}
    ji = jpm.PhotonMapper(cluster_size=CLUSTER, **KW).specialized_for(jscene)
    with pytest.MonkeyPatch.context() as mp:
        record_offsets(mp, jpm, got)
        photons = jax.jit(lambda: jpm.trace_photons(
            jscene, ji, PHOTONS, jnp.uint32(SEED), DEPTH))()
        jax.effects_barrier()
    smin, smax = _bounds(tscene)
    jmap = jax.jit(lambda *a: jpm.build_photon_map(*a, RADIUS, jx(smin),
                                                   jx(smax)))(*photons)
    with pytest.MonkeyPatch.context() as mp:
        _record_gather(mp, jpm, got)
        L = np.asarray(jax.jit(lambda o, d: ji.li_with_map(
            jscene, jmap, o, d, jnp.uint32(SEED),
            jnp.arange(N, dtype=jnp.uint32)))(jx(o), jx(d)))
        jax.effects_barrier()
    return dict(tscene=tscene, cam=cam, o=o, d=d,
                photons=[np.asarray(x) for x in photons],
                start=got["start"], bounds=(smin, smax),
                map=[np.asarray(x) for x in jmap[:7]], L=L,
                gather=got["gather"][0])


def _bounds(tscene):
    """build_map's scene bounds (real vertices only), as numpy."""
    verts = torch.cat([tscene.p0, tscene.p0 + tscene.e1,
                       tscene.p0 + tscene.e2])
    real = torch.abs(verts) < 1e29
    return (torch.amin(torch.where(real, verts, 1e30), 0).numpy(),
            torch.amax(torch.where(real, verts, -1e30), 0).numpy())


def _port_map(ref):
    pos, power, normal, wi, cell, gmin, inv = tensors(*ref["map"])
    return PhotonMap(pos, power, normal, wi, cell.long(), gmin, inv, 64,
                     RADIUS)


def test_emitter_start_matches_photonmap(ref):
    """sample_emitter_ray on the photon walk's draws (_PHOTON_DIM_BASE +
    0, 1, 2) gives the JAX trace_photons start (photonmap.py:66-104)
    under assert_start's rule, and the first bounce's photon power, the
    start's Le·(A·π/pmf)/N, bit for bit."""
    pid = torch.arange(PHOTONS)
    base = pm._PHOTON_DIM_BASE
    er = sample_emitter_ray(ref["tscene"], rng.sample_1d(SEED, pid, base),
                            rng.sample_2d(SEED, pid, base + 1),
                            rng.sample_2d(SEED, pid, base + 2))
    assert_start(er, offset_ray_origin(er.p, er.n, er.d), ref["start"])
    mine = trace_photons(ref["tscene"], PhotonMapper(**KW), PHOTONS, SEED,
                         DEPTH)
    assert np.array_equal(mine[1][:PHOTONS].numpy(),
                          ref["photons"][1][:PHOTONS])


def test_trace_photons_matches_jax(ref):
    """trace_photons: the deposits equal, their positions, powers,
    normals and directions under assert_share's rule (>= 99.5% of the
    deposits within rel 1e-4, all within rel 1e-3; floor 1e-3)."""
    mine = trace_photons(ref["tscene"], PhotonMapper(**KW), PHOTONS, SEED,
                         DEPTH)
    want = ref["photons"]
    valid = want[4]
    assert np.array_equal(mine[4].numpy(), valid) and valid.sum() > PHOTONS
    for got, w in zip(mine[:4], want[:4]):
        assert_share(got.numpy()[valid], w[valid])


def test_build_photon_map_order_equal(ref):
    """build_photon_map on the JAX photons: the same order (a stable
    sort), cells, grid and every array equal to the JAX map."""
    smin, smax = tensors(*ref["bounds"])
    got = build_photon_map(*tensors(*ref["photons"]), RADIUS, smin, smax)
    for g, w in zip(got[:7], ref["map"]):
        assert np.array_equal(g.numpy(), w)


def test_gather_radiance_and_li_with_map_match_jax(ref):
    """li_with_map on the JAX map lane by lane within rel 1e-4 (floor
    1e-3), and its gather_radiance call's photon estimate (27 cells × 32
    photons) likewise."""
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        _record_gather(mp, pm, got)
        L = PhotonMapper(**KW).li_with_map(
            ref["tscene"], _port_map(ref), *tensors(ref["o"], ref["d"]),
            SEED, torch.arange(N))
    assert_lanes(got["gather"].numpy(), ref["gather"])
    assert ref["gather"].mean() > 0.01
    assert_lanes(L.numpy(), ref["L"])


def test_li_stats_map_seed_and_count(ref):
    """li_stats is li_with_map on the map of seed ^ 0x5bd1 (the JAX li's),
    its count the JAX one, 2N + n_photons."""
    integ = PhotonMapper(**KW)
    o, d = tensors(ref["o"], ref["d"])
    L, n_rays = integ.li_stats(ref["tscene"], o, d, SEED, torch.arange(N))
    pmap = integ.build_map(ref["tscene"], SEED ^ 0x5bd1)
    assert torch.equal(L, integ.li_with_map(ref["tscene"], pmap, o, d, SEED,
                                            torch.arange(N)))
    assert int(n_rays) == 2 * N + PHOTONS


def test_render_progressive_radii(ref):
    """progressive_radii follows rᵢ² = r₀²·Πₖ₌₁^i (k+α)/(k+1) for passes
    i = 0, 1, ... (Knaus and Zwicker 2011) to rel 1e-12, and
    render_progressive is the mean of render() passes at those radii and
    seeds seed + 7919·i."""
    alpha = 0.7
    radii = progressive_radii(RADIUS, 4, alpha)
    for i, r in enumerate(radii):
        want = RADIUS ** 2 * np.prod([(k + alpha) / (k + 1)
                                      for k in range(1, i + 1)])
        assert abs(r ** 2 - want) <= 1e-12 * want
    assert radii[0] == RADIUS and radii[3] < radii[0]
    tscene, cam = ref["tscene"], ref["cam"]
    film = Film(RES, RES)
    small = PhotonMapper(**{**KW, "n_photons": 1024})
    img = render_progressive(tscene, cam, film, small, n_passes=2,
                             spp_per_pass=1, seed=SEED, device="cpu")
    passes = [render(tscene, cam, film, PhotonMapper(
        **{**KW, "n_photons": 1024, "gather_radius": r}), 1,
        SEED + 7919 * i, device="cpu") for i, r in enumerate(radii[:2])]
    assert torch.equal(img, passes[0] + (passes[1] - passes[0]) / 2)
    assert bool(torch.isfinite(img).all()) and img.mean() > 0.05
