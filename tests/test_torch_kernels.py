"""The port's CUDA kernels (the trace kernel, the path megakernels, the
fused shade kernel and the probes of mitsuba_tpu_torch/experiments)
against their plain PyTorch versions, on the card,
on the Cornell box (also through a thin lens), the four-material scene
(also under point, spot, directional and constant lights), the
leaf-families scene, the lights-and-composites scene, the fog scenes
(chip_smoke.py FOG_SCENES: the homogeneous medium), the proctex scene
(the megakernels' procedural albedo) and the texenv scene (the trace and
shade kernels under bitmap textures, normal and bump maps and an
envmap), the ablation probe's seven variants (csrc/ablate.cu),
mega_bounce at unbounded depth on the Cornell box, the wrappers'
refusal of inputs that require grad, the command-line renderer's
megakernel route on scenes/checker.xml, and the trace kernel on the
wavefronts of the light-subpath integrators (ptracer, BDPT, VPL,
lightcuts, photon mapping). Every test is marked
`cuda` and skips without a card.
The file
imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    MITSUBA_TPU_TESTS=1 python -m pytest tests/test_torch_kernels.py -m cuda
"""
import numpy as np
import pytest
import torch

from chip_smoke import (FOG_SCENES, LENS, ORDER_SCENES, fog_scene,
                        four_materials, leaf_families_camera,
                        leaf_families_desc, lights_scene, order_rays,
                        order_scene, tex_scene, walk_build)
from mitsuba_tpu_torch.accel import dense as tdense
from mitsuba_tpu_torch.accel import megakernel as tmk
from mitsuba_tpu_torch.accel import shade_kernel as tshade
from mitsuba_tpu_torch.accel import trace as ttrace
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.experiments import ablate
from mitsuba_tpu_torch.integrator.mega import (MegaPathTracer,
                                               MegaVolPathTracer)
from mitsuba_tpu_torch.integrator.path import PathTracer, initial_state
from mitsuba_tpu_torch.scene import presets as tpresets
from mitsuba_tpu_torch.integrator.common import offset_ray_origin, ray_mint
from mitsuba_tpu_torch.scene import shapes as tshapes
from mitsuba_tpu_torch.scene.builder import SceneDesc
from mitsuba_tpu_torch.scene.builder import compile_scene as tcompile
from mitsuba_tpu_torch.sensor.sensor import PerspectiveCamera
from torch_scenes import tie_scene

torch.set_num_threads(2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _scene(with_sphere: bool, dev):
    desc = tpresets.cornell_box()
    if with_sphere:
        desc.add_shape(tshapes.sphere(64, 128),
                       to_world=ttf.translate([0.5, 0.4, 0.5])
                       @ ttf.scale(0.2), material=0)
    return tcompile(desc, device=dev)


def _rays(dev, n=4096, seed=0):
    """Origins inside the box, uniform directions, finite segment ends."""
    rs = np.random.RandomState(seed)
    o = (rs.rand(n, 3) * 0.98 + 0.01).astype(np.float32)
    d = rs.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    mint = np.full(n, 1e-4, np.float32)
    seg = (rs.rand(n) * 1.2).astype(np.float32)
    return (torch.as_tensor(x, device=dev) for x in (o, d, mint, seg))


@pytest.mark.cuda
@pytest.mark.parametrize("with_sphere", [False, True])
def test_kernel_matches_plain_on_card(with_sphere):
    """The kernel and the plain version round alike op for op, so on the
    card their hits agree exactly, in both modes and with dead lanes."""
    dev = _card()
    scene = _scene(with_sphere, dev)
    o, d, mint, seg = _rays(dev)
    maxt = torch.full_like(seg, 1e30)
    live = torch.arange(o.shape[0], device=dev) % 5 != 0
    ttrace.reset_launches()
    ki = ttrace.intersect(scene, o, d, mint, maxt, live)
    pi = tdense.ray_intersect(scene, o, d, mint, maxt, live)
    assert torch.equal(ki.valid, pi.valid)
    assert not ki.valid[~live].any()
    for name in ("t", "tri_id", "p", "ns", "uv"):
        assert torch.equal(getattr(ki, name), getattr(pi, name)), name
    ko = ttrace.occluded(scene, o, d, mint, seg)
    assert torch.equal(ko, tdense.ray_test(scene, o, d, mint, seg))
    assert ttrace.LAUNCHES == {"trace_closest": 1, "trace_any": 1}


@pytest.mark.cuda
def test_kernel_rejects_bad_input_on_card():
    dev = _card()
    scene = _scene(False, dev)
    o, d, mint, seg = _rays(dev, 256)
    with pytest.raises(ValueError, match="float32"):
        ttrace.occluded(scene, o.double(), d, mint, seg)
    with pytest.raises(ValueError, match="shape"):
        ttrace.occluded(scene, o, d, mint[:10], seg)
    with pytest.raises(ValueError, match="on cuda"):
        ttrace.occluded(scene, o, d, mint.cpu(), seg)


def _mega_inputs(dev, res=32):
    """Cornell tables and res² camera-ray lanes on the card."""
    scene = tcompile(tpresets.cornell_box(), device=dev)
    cam = tpresets.cornell_camera(res, res)
    pix = torch.arange(res * res, dtype=torch.int32, device=dev)
    o, d = tmk.primary_rays(cam, 0, pix, 0)
    return (MegaPathTracer.for_scene(scene).tables, cam, pix,
            torch.zeros_like(pix), initial_state(o, d))


@pytest.mark.cuda
@pytest.mark.parametrize("bounce", [0, 3])
def test_mega_bounce_matches_plain_on_card(bounce):
    """The megakernel rounds as the eager plain bounce does, op for op, so
    on the card every output row agrees exactly, dead lanes included."""
    dev = _card()
    tables, _, pix, samp, st = _mega_inputs(dev)
    for b in range(bounce):
        st = tmk.bounce_plain(tables, 5, 8, st, pix, samp, 7, b)[:16]
    tmk.reset_launches()
    k = tmk.run_bounce(tables, 5, 8, st, pix, samp, 7, bounce)
    p = tmk.bounce_plain(tables, 5, 8, st, pix, samp, 7, bounce)
    assert torch.equal(k, p)
    assert tmk.LAUNCHES["mega_bounce"] == 1


@pytest.mark.cuda
def test_mega_path_and_persistent_match_plain_on_card():
    dev = _card()
    tables, cam, pix, samp, st = _mega_inputs(dev)
    tmk.reset_launches()
    k = tmk.run_path(tables, 5, 8, 8, st, pix, samp, 1)
    assert torch.equal(k, tmk.path_plain(tables, 5, 8, 8, st, pix, samp, 1))
    pst = torch.cat([st, torch.zeros_like(st[:8])])
    k = tmk.run_persistent(tables, 5, 8, 3, cam, pst, pix, samp, 1)
    p = tmk.persistent_plain(tables, 5, 8, 3, cam, pst, pix, samp, 1)
    assert torch.equal(k, p)
    assert (k[17] == 3).all()
    assert tmk.LAUNCHES == {"mega_bounce": 0, "mega_path": 1,
                            "mega_persistent": 1}


@pytest.mark.cuda
def test_mega_rejects_bad_input_on_card():
    dev = _card()
    tables, _, pix, samp, st = _mega_inputs(dev, 8)
    with pytest.raises(ValueError, match="int32"):
        tmk.run_bounce(tables, 5, 8, st, pix.long(), samp, 0, 0)
    with pytest.raises(ValueError, match="shape"):
        tmk.run_path(tables, 5, 8, 8, st[:12], pix, samp, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("two_sided,bounce", [(False, 0), (False, 3),
                                              (True, 1), (True, 2)],
                         ids=["0", "3", "two_sided-1", "two_sided-2"])
def test_shade_matches_plain_on_card(two_sided, bounce):
    """The fused shade kernel against shade_plain on the same packed rows
    of the eager pass: every row within rel 1e-5 / abs 1e-6 on >= 99.9%
    of the lanes, one launch counted. With every material two-sided, the
    rays inside the glass sphere meet it from behind and take the
    adapter's flip."""
    dev = _card()
    scene, cam = four_materials(64, dev, two_sided)
    pix = torch.arange(64 * 64, dtype=torch.int32, device=dev)
    samp = torch.zeros_like(pix)
    st = initial_state(*tmk.primary_rays(cam, 0, pix, 0))
    tracer = PathTracer(max_depth=6).specialized_for(scene)
    for b in range(bounce):
        st = tracer.bounce(scene, st, 0, pix, samp, b)[0]
    packed = tracer.shade_inputs(scene, st, 0, pix, samp, bounce)
    hit = packed[tshade.I_HIT] > 0.5
    flipped = tshade._front(packed, bounce, 6).fsign < 0
    assert (int((flipped & hit).sum()) > 16) == two_sided
    tshade.reset_launches()
    k = tshade.run_shade(scene, packed, pix, samp, 0, bounce, 5, 6)
    p = tshade.shade_plain(scene, packed, pix, samp, 0, bounce, 5, 6)
    diff = (k - p).abs()
    ok = ((diff <= 1e-6) | (diff <= 1e-5 * p.abs())).all(0)
    assert ok.float().mean().item() >= 0.999
    assert tshade.LAUNCHES["shade"] == 1


@pytest.mark.cuda
def test_fused_path_on_card():
    """PathTracer(fused_shade="on") launches the kernel once per bounce,
    "auto" picks it for CUDA tensors, and the radiance agrees with the
    eager tail."""
    dev = _card()
    scene, cam = four_materials(64, dev)
    pix = torch.arange(64 * 64, device=dev)
    o, d = tmk.primary_rays(cam, 0, pix, 0)
    assert PathTracer(fused_shade="auto").specialized_for(scene) \
        .fused_shade == "on"
    l_off, n_off = PathTracer(max_depth=6).li_stats(scene, o, d, 0, pix)
    tshade.reset_launches()
    l_on, n_on = PathTracer(max_depth=6, fused_shade="on").li_stats(
        scene, o, d, 0, pix)
    assert tshade.LAUNCHES["shade"] == 6
    close = torch.isclose(l_on, l_off, rtol=2e-3, atol=2e-4).all(-1)
    assert close.float().mean().item() > 0.995
    assert abs(int(n_on) - int(n_off)) <= 1e-4 * int(n_off)


# ---------------------------------------------------------------------------
# the leaf-families scene: every leaf BSDF family, two-sided, smooth normals
# ---------------------------------------------------------------------------

def _agree(k, p):
    """The share of lanes whose every row is within rel 1e-5 / abs 1e-6."""
    diff = (k - p).abs()
    return ((diff <= 1e-6) | (diff <= 1e-5 * p.abs())).all(0).float() \
        .mean().item()


def _leaf(dev, res=64, **kw):
    """The leaf-families scene at sphere(8, 16), its camera and the camera
    paths of its res² pixels."""
    scene = tcompile(leaf_families_desc(SceneDesc, ttf, tshapes, (8, 16),
                                        **kw), device=dev)
    cam = leaf_families_camera(PerspectiveCamera, ttf, res)
    pix = torch.arange(res * res, dtype=torch.int32, device=dev)
    st = initial_state(*tmk.primary_rays(cam, 0, pix, 0))
    return scene, cam, pix, torch.zeros_like(pix), st


@pytest.mark.cuda
@pytest.mark.parametrize("bounce", [0, 3])
def test_leaf_mega_bounce_matches_plain_on_card(bounce):
    """mega_bounce against MegaPlainTracer's bounce on every leaf family:
    every row within rel 1e-5 / abs 1e-6 on >= 99.9% of the lanes."""
    dev = _card()
    scene, _, pix, samp, st = _leaf(dev)
    tables = MegaPathTracer.for_scene(scene, max_depth=6).tables
    for b in range(bounce):
        st = tmk.bounce_plain(tables, 5, 6, st, pix, samp, 0, b)[:16]
    tmk.reset_launches()
    k = tmk.run_bounce(tables, 5, 6, st, pix, samp, 0, bounce)
    p = tmk.bounce_plain(tables, 5, 6, st, pix, samp, 0, bounce)
    assert _agree(k, p) >= 0.999
    assert tmk.LAUNCHES["mega_bounce"] == 1


@pytest.mark.cuda
def test_leaf_mega_path_and_persistent_match_plain_on_card():
    dev = _card()
    scene, cam, pix, samp, st = _leaf(dev)
    tables = MegaPathTracer.for_scene(scene, max_depth=6).tables
    k = tmk.run_path(tables, 5, 6, 6, st, pix, samp, 1)
    assert _agree(k, tmk.path_plain(tables, 5, 6, 6, st, pix, samp, 1)) \
        >= 0.999
    pst = torch.cat([st, torch.zeros_like(st[:8])])
    k = tmk.run_persistent(tables, 5, 6, 2, cam, pst, pix, samp, 1)
    p = tmk.persistent_plain(tables, 5, 6, 2, cam, pst, pix, samp, 1)
    assert _agree(k, p) >= 0.999
    assert (k[17] == 2).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bounce", [0, 3])
def test_leaf_shade_matches_plain_on_card(bounce):
    """The shade kernel on the leaf-families scene with rough plastic
    swapped for plastic and every material two-sided."""
    dev = _card()
    scene, _, pix, samp, st = _leaf(dev, rough_plastic=False,
                                    two_sided=True)
    assert tshade.supports(scene) == (True, "")
    tracer = PathTracer(max_depth=6).specialized_for(scene)
    for b in range(bounce):
        st = tracer.bounce(scene, st, 0, pix, samp, b)[0]
    packed = tracer.shade_inputs(scene, st, 0, pix, samp, bounce)
    tshade.reset_launches()
    k = tshade.run_shade(scene, packed, pix, samp, 0, bounce, 5, 6)
    p = tshade.shade_plain(scene, packed, pix, samp, 0, bounce, 5, 6)
    assert _agree(k, p) >= 0.999
    assert tshade.LAUNCHES["shade"] == 1


# ---------------------------------------------------------------------------
# the cluster walk: the warp-cooperative build and the SIMT build
# (csrc/trace_common.cuh, MITSUBA_WALK_COOP=0), each bit-equal to dense.py
# ---------------------------------------------------------------------------

WALKS = {"coop": (), "simt": ("-DMITSUBA_WALK_COOP=0",)}
# the trace kernel alone also under the index order (the default "coop"
# build walks tables of 8 to 128 clusters in order)
TRACE_WALKS = {**WALKS, "index": ("-DMITSUBA_WALK_ORDER=0",)}


def _assert_walk_equal(scene, o, d, mint, maxt, live, walk):
    """The trace kernel under `walk`, closest hit and any hit, against the
    plain version bit for bit on every lane; where the build walks the
    scene in order, its visits against ordered_walk_plain's too."""
    pt, ptri, pu, pv, phit = tdense.intersect_soup(o, d, scene.woop_o, mint,
                                                   maxt, live)
    ordered = walk == "coop" and ttrace.walks_ordered(scene)
    vis = [torch.full((-(-o.shape[0] // 32),), -1, dtype=torch.int32,
                      device=o.device) for _ in range(2)]
    with walk_build(*TRACE_WALKS[walk], trace_only=walk not in WALKS):
        t, tri, u, v, hit = ttrace.trace(scene, o, d, mint, maxt, live,
                                         False, vis[0])
        any_hit = ttrace.trace(scene, o, d, mint, maxt, live, True,
                               vis[1])[4]
    assert torch.equal(hit, phit)
    assert torch.equal(t, pt) and torch.equal(tri.long(), ptri)
    assert torch.equal(u, pu) and torch.equal(v, pv)
    assert torch.equal(any_hit, phit)
    for mode, got in zip((False, True), vis):
        if ordered:
            ref = ttrace.ordered_walk_plain(scene, o, d, mint, maxt, live,
                                            mode)
            assert torch.equal(got, ref[5])
        else:
            assert bool((got == -1).all())   # written by the ordered walk
    return tri, hit


def _leaf_rays(dev, n, seed=0):
    """n shuffled camera rays of the leaf-families scene (res 257 at most)
    with a live mask that has holes, and shadow-like rays from their hits
    toward a point under the light (finite maxt)."""
    scene, cam, pix, _, st = _leaf(dev, res=257)
    perm = torch.as_tensor(np.random.RandomState(seed).permutation(
        pix.shape[0])[:n], device=dev)
    o, d = st[0:3, perm].T.contiguous(), st[3:6, perm].T.contiguous()
    idx = torch.arange(n, device=dev)
    live = (idx % 3 != 0) & ((idx < n // 4) | (idx >= n // 2))
    maxt = torch.full_like(o[:, 0], 1e30)
    its = tdense.ray_intersect(scene, o, d, ray_mint(o), maxt, live)
    so = torch.where(its.valid[:, None], its.p + 1e-3 * its.ng, o)
    sd = torch.tensor([0.3, 3.9, -0.2], device=dev) - so
    dist = sd.norm(dim=-1)
    sd = (sd / dist[:, None]).contiguous()
    return scene, (o, d, ray_mint(o), maxt, live), \
        (so.contiguous(), sd, ray_mint(so), dist * 0.999, its.valid)


@pytest.mark.cuda
@pytest.mark.parametrize("walk", list(TRACE_WALKS))
@pytest.mark.parametrize("n", [33, 100, 65537])
def test_walk_matches_plain_on_card(n, walk):
    """Ragged ray counts (the last warp partly empty), dead lanes, lanes in
    shuffled order on the leaf-families scene, so warps diverge across
    clusters: both walks give the plain version's hits bit for bit."""
    dev = _card()
    scene, camera, shadow = _leaf_rays(dev, n)
    _assert_walk_equal(scene, *camera, walk)
    _assert_walk_equal(scene, *shadow, walk)


@pytest.mark.cuda
@pytest.mark.parametrize("walk", list(TRACE_WALKS))
@pytest.mark.parametrize("sparse", [False, True], ids=["all", "sparse"])
def test_walk_ties_on_card(walk, sparse):
    """Rays that meet two or three coincident triangles at one t report the
    lowest index (5, 40 or 80), within a cluster and across clusters,
    also where the ordered walk ("coop") visits cluster 1 before
    cluster 0. With one lane in eight live, few lanes of a warp enter a
    cluster and the cooperative branch scans it; with all live, the lanes
    scan it."""
    dev = _card()
    scene = tie_scene(dev)
    assert ttrace.real_tris(scene) == 120
    rs = np.random.RandomState(4)
    n = 4096
    o = np.stack([rs.uniform(-3.5, 3.5, n), rs.uniform(-1.5, 1.5, n),
                  np.full(n, 2.0)], -1).astype(np.float32)
    d = np.tile(np.float32([0.0, 0.0, -1.0]), (n, 1))
    o, d = (torch.as_tensor(x, device=dev) for x in (o, d))
    live = torch.arange(n, device=dev) % (8 if sparse else 1) == 0
    maxt = torch.full((n,), 10.0, device=dev)
    tri, hit = _assert_walk_equal(scene, o, d, ray_mint(o), maxt, live,
                                  walk)
    assert set(tri[hit].tolist()) == {5, 40, 80}


@pytest.mark.cuda
@pytest.mark.parametrize("walk", list(WALKS))
def test_walk_persistent_shuffled_on_card(walk):
    """mega_persistent on pixels in shuffled order (each warp's lanes far
    apart, at different bounces) against MegaPlainTracer's loop, every
    output row bit for bit, under both walks."""
    dev = _card()
    scene, cam, pix, samp, _ = _leaf(dev)
    perm = torch.as_tensor(np.random.RandomState(5).permutation(
        pix.shape[0]), device=dev)
    pix = pix[perm].contiguous()
    st = initial_state(*tmk.primary_rays(cam, 0, pix, 0))
    tables = MegaPathTracer.for_scene(scene, max_depth=6).tables
    pst = torch.cat([st, torch.zeros_like(st[:8])])
    with walk_build(*WALKS[walk]):
        k = tmk.run_persistent(tables, 5, 6, 2, cam, pst, pix, samp, 1)
    p = tmk.persistent_plain(tables, 5, 6, 2, cam, pst, pix, samp, 1)
    assert torch.equal(k, p)


# ---------------------------------------------------------------------------
# the shade kernel's shadow walk and mega_path, under both walk builds, on
# ragged, shuffled lanes with dead ones among them
# ---------------------------------------------------------------------------


def _shuffled(dev, scene_name, n, seed):
    """A scene, n shuffled pixels of its 257² film (66,049 pixels), their
    sample ids and their camera paths. Scenes: "cornell"; "leaf", the
    leaf-families scene at sphere(8, 16); "leaf_shade", the same with
    rough plastic swapped for plastic and every material two-sided (the
    shade kernel's families); "four_material"."""
    if scene_name == "cornell":
        scene = tcompile(tpresets.cornell_box(), device=dev)
        cam = tpresets.cornell_camera(257, 257)
    elif scene_name == "four_material":
        scene, cam = four_materials(257, dev)
    else:
        shade = scene_name == "leaf_shade"
        scene, cam, *_ = _leaf(dev, res=257, rough_plastic=not shade,
                               two_sided=shade)
    pix = torch.as_tensor(np.random.RandomState(seed).permutation(
        257 * 257)[:n].astype(np.int32), device=dev)
    st = initial_state(*tmk.primary_rays(cam, 0, pix, 0))
    return scene, pix, torch.zeros_like(pix), st


@pytest.mark.cuda
@pytest.mark.parametrize("walk", list(WALKS))
@pytest.mark.parametrize("scene_name", ["leaf_shade", "four_material"])
@pytest.mark.parametrize("bounce", [0, 3])
@pytest.mark.parametrize("n", [33, 100, 65537])
def test_shade_walks_match_plain_on_card(n, bounce, scene_name, walk):
    """The shade kernel's shadow walk (cooperative on these multi-cluster
    scenes, and the SIMT instantiation) against shade_plain bit for bit:
    ragged n (the last warp partly empty), shuffled lanes, and lanes
    inactive on entry in every warp beside the ones whose paths died."""
    dev = _card()
    scene, pix, samp, st = _shuffled(dev, scene_name, n, n + bounce)
    tracer = PathTracer(max_depth=6).specialized_for(scene)
    for b in range(bounce):
        st = tracer.bounce(scene, st, 0, pix, samp, b)[0]
    packed = tracer.shade_inputs(scene, st, 0, pix, samp, bounce)
    off = torch.arange(n, device=dev) % 7 == 3
    for row in (tshade.I_ACT, tshade.I_HIT):
        packed[row] = torch.where(off, 0.0, packed[row])
    tshade.reset_launches()
    with walk_build(*WALKS[walk]):
        k = tshade.run_shade(scene, packed, pix, samp, 0, bounce, 5, 6)
    assert torch.equal(k, tshade.shade_plain(scene, packed, pix, samp, 0,
                                             bounce, 5, 6))
    assert tshade.LAUNCHES["shade"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("walk", list(WALKS))
@pytest.mark.parametrize("scene_name", ["cornell", "leaf"])
@pytest.mark.parametrize("n,n_bounces", [(33, 6), (100, 2), (65537, 6)])
def test_mega_path_walks_match_plain_on_card(n, n_bounces, scene_name,
                                             walk):
    """mega_path against path_plain bit for bit, count rows included:
    ragged n (the last warp partly empty), lanes dead on entry, pixels in
    shuffled order, and launches that stop before the paths do; on the
    leaf scene under both walks (Cornell, one walked cluster, takes the
    SIMT walk under either build)."""
    dev = _card()
    scene, pix, samp, st = _shuffled(dev, scene_name, n, n)
    st[12] = torch.where(torch.arange(n, device=dev) % 5 == 2, 0.0, st[12])
    tables = MegaPathTracer.for_scene(scene, max_depth=6).tables
    tmk.reset_launches()
    with walk_build(*WALKS[walk]):
        k = tmk.run_path(tables, 5, 6, n_bounces, st, pix, samp, 1)
    assert torch.equal(k, tmk.path_plain(tables, 5, 6, n_bounces, st, pix,
                                         samp, 1))
    assert tmk.LAUNCHES["mega_path"] == 1


# ---------------------------------------------------------------------------
# the lights-and-composites scene (the megakernels' kExt instantiations),
# the thin lens, and the shade kernel under delta and constant lights: on
# ragged, shuffled lanes with dead ones among them, bit for bit
# ---------------------------------------------------------------------------

def _lights_lanes(dev, n, seed, scene_name="lights"):
    """A scene, n shuffled pixels of its 257² film, their sample ids and
    their camera paths, every fifth lane dead on entry. Scenes: "lights",
    the lights-and-composites scene at sphere(6, 12); "lens", the Cornell
    box through chip_smoke.LENS's thin lens; "shade", the four-material
    scene with chip_smoke.add_lights's lights."""
    import dataclasses
    if scene_name == "lights":
        scene, cam = lights_scene(257, dev, (6, 12))
    elif scene_name == "lens":
        scene = tcompile(tpresets.cornell_box(), device=dev)
        cam = dataclasses.replace(tpresets.cornell_camera(257, 257), **LENS)
    else:
        scene, cam = four_materials(257, dev, lights=True)
    pix = torch.as_tensor(np.random.RandomState(seed).permutation(
        257 * 257)[:n].astype(np.int32), device=dev)
    st = initial_state(*tmk.primary_rays(cam, 0, pix, 0))
    st[12] = torch.where(torch.arange(n, device=dev) % 5 == 2, 0.0, st[12])
    return scene, cam, pix, torch.zeros_like(pix), st


@pytest.mark.cuda
@pytest.mark.parametrize("bounce", [0, 3])
@pytest.mark.parametrize("n", [33, 100])
def test_lights_mega_bounce_matches_plain_on_card(n, bounce):
    """mega_bounce's kExt instantiation (delta and constant lights, the
    sky on escape, mixture, blend, mask, coating and rough coating)
    against MegaPlainTracer's bounce, every row bit for bit."""
    dev = _card()
    scene, _, pix, samp, st = _lights_lanes(dev, n, n + bounce)
    tables = MegaPathTracer.for_scene(scene, max_depth=8).tables
    assert tables.ext and tables.env >= 0
    for b in range(bounce):
        st = tmk.bounce_plain(tables, 5, 8, st, pix, samp, 0, b)[:16]
    tmk.reset_launches()
    k = tmk.run_bounce(tables, 5, 8, st, pix, samp, 0, bounce)
    assert torch.equal(k, tmk.bounce_plain(tables, 5, 8, st, pix, samp, 0,
                                           bounce))
    assert tmk.LAUNCHES["mega_bounce"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("walk", list(WALKS))
@pytest.mark.parametrize("n", [33, 100])
def test_lights_mega_path_matches_plain_on_card(n, walk):
    """mega_path's kExt instantiation against path_plain bit for bit,
    count rows included, under both walk builds."""
    dev = _card()
    scene, _, pix, samp, st = _lights_lanes(dev, n, n)
    tables = MegaPathTracer.for_scene(scene, max_depth=8).tables
    tmk.reset_launches()
    with walk_build(*WALKS[walk]):
        k = tmk.run_path(tables, 5, 8, 8, st, pix, samp, 1)
    assert torch.equal(k, tmk.path_plain(tables, 5, 8, 8, st, pix, samp, 1))
    assert tmk.LAUNCHES["mega_path"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", ["lights", "lens"])
@pytest.mark.parametrize("n", [33, 100])
def test_lights_mega_persistent_matches_plain_on_card(n, scene_name):
    """mega_persistent's kExt instantiation against persistent_plain bit
    for bit over 3 spp: on the lights-and-composites scene, and on the
    Cornell box through the thin lens, whose regenerated camera rays
    take the aperture sample."""
    dev = _card()
    scene, cam, pix, samp, st = _lights_lanes(dev, n, n, scene_name)
    tables = MegaPathTracer.for_scene(scene, max_depth=8).tables
    pst = torch.cat([st, torch.zeros_like(st[:8])])
    tmk.reset_launches()
    k = tmk.run_persistent(tables, 5, 8, 3, cam, pst, pix, samp, 1)
    p = tmk.persistent_plain(tables, 5, 8, 3, cam, pst, pix, samp, 1)
    assert torch.equal(k, p)
    live = st[12] > 0.5
    assert (k[17][live] == 3).all() and (k[17][~live] == 0).all()
    assert tmk.LAUNCHES["mega_persistent"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("bounce", [0, 3])
@pytest.mark.parametrize("n", [33, 100])
def test_lights_shade_matches_plain_on_card(n, bounce):
    """The shade kernel on the four-material scene under point, spot,
    directional and constant lights (delta NEE rows, the 1e30 distance
    of the sun and the sky) against shade_plain bit for bit."""
    dev = _card()
    scene, _, pix, samp, st = _lights_lanes(dev, n, n + bounce, "shade")
    tracer = PathTracer(max_depth=6).specialized_for(scene)
    for b in range(bounce):
        st = tracer.bounce(scene, st, 0, pix, samp, b)[0]
    packed = tracer.shade_inputs(scene, st, 0, pix, samp, bounce)
    tshade.reset_launches()
    k = tshade.run_shade(scene, packed, pix, samp, 0, bounce, 5, 6)
    assert torch.equal(k, tshade.shade_plain(scene, packed, pix, samp, 0,
                                             bounce, 5, 6))
    assert tshade.LAUNCHES["shade"] == 1


FOG_RES = 64


def _fog_lanes(dev, name):
    """MegaVolPathTracer's tables for FOG_SCENES[name] at 64², its camera
    rays with every seventh lane dead on entry, pixel ids and samples."""
    scene, cam = fog_scene(name, FOG_RES, dev)
    tables = MegaVolPathTracer.for_scene(scene, max_depth=8).tables
    assert tables.ext and tables.medium is not None
    pix = torch.arange(FOG_RES * FOG_RES, dtype=torch.int32, device=dev)
    st = initial_state(*tmk.primary_rays(cam, 0, pix, 0))
    st[12] = torch.where(pix % 7 == 3, 0.0, st[12])
    return tables, cam, pix, torch.zeros_like(pix), st


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FOG_SCENES))
def test_fog_mega_bounce_matches_plain_on_card(name):
    """mega_bounce's medium branch (distance sampling, HG NEE from the
    scatter point, the attenuated NEE, the HG continuation) against
    MegaPlainTracer's VolPathTracer bounce, every row bit for bit, at
    bounces 0-3 from the plain wavefront."""
    dev = _card()
    tables, _, pix, samp, st = _fog_lanes(dev, name)
    tmk.reset_launches()
    for b in range(4):
        p = tmk.bounce_plain(tables, 5, 8, st, pix, samp, 0, b)
        assert torch.equal(tmk.run_bounce(tables, 5, 8, st, pix, samp, 0, b),
                           p), b
        st = p[:16]
    assert tmk.LAUNCHES["mega_bounce"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FOG_SCENES))
def test_fog_mega_path_matches_plain_on_card(name):
    """mega_path with the medium against path_plain bit for bit, the
    count rows (attempted shadow rays) included."""
    dev = _card()
    tables, _, pix, samp, st = _fog_lanes(dev, name)
    tmk.reset_launches()
    k = tmk.run_path(tables, 5, 8, 8, st, pix, samp, 1)
    assert torch.equal(k, tmk.path_plain(tables, 5, 8, 8, st, pix, samp, 1))
    assert tmk.LAUNCHES["mega_path"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FOG_SCENES))
def test_fog_mega_persistent_matches_plain_on_card(name):
    """mega_persistent with the medium against persistent_plain bit for
    bit over 4 spp: each regenerated camera path samples the medium
    again from the camera."""
    dev = _card()
    tables, cam, pix, samp, st = _fog_lanes(dev, name)
    pst = torch.cat([st, torch.zeros_like(st[:8])])
    tmk.reset_launches()
    k = tmk.run_persistent(tables, 5, 8, 4, cam, pst, pix, samp, 1)
    assert torch.equal(k, tmk.persistent_plain(tables, 5, 8, 4, cam, pst,
                                               pix, samp, 1))
    live = st[12] > 0.5
    assert (k[17][live] == 4).all() and (k[17][~live] == 0).all()
    assert tmk.LAUNCHES["mega_persistent"] == 1


TEX_RES = 64


def _proctex_lanes(dev):
    """MegaPathTracer's tables for chip_smoke's proctex scene (the
    procedural checker and grid albedo) at 64², its camera rays with every
    seventh lane dead on entry, pixel ids and samples."""
    scene, cam, desc = tex_scene("proctex", TEX_RES, dev)
    tables = MegaPathTracer.for_scene(scene, max_depth=6,
                                      tex_procs=desc.tex_procs).tables
    assert tables.textured and tables.ext
    pix = torch.arange(TEX_RES * TEX_RES, dtype=torch.int32, device=dev)
    st = initial_state(*tmk.primary_rays(cam, 0, pix, 0))
    st[12] = torch.where(pix % 7 == 3, 0.0, st[12])
    return tables, cam, pix, torch.zeros_like(pix), st


@pytest.mark.cuda
def test_proctex_mega_bounce_matches_plain_on_card():
    """mega_bounce's procedural albedo (the uv from the attribute rows, the
    analytic checker and grid, the row's copy) against MegaPlainTracer's
    bounce with proc_albedo, every row bit for bit, at bounces 0-3."""
    dev = _card()
    tables, _, pix, samp, st = _proctex_lanes(dev)
    tmk.reset_launches()
    for b in range(4):
        p = tmk.bounce_plain(tables, 5, 6, st, pix, samp, 0, b)
        assert torch.equal(tmk.run_bounce(tables, 5, 6, st, pix, samp, 0, b),
                           p), b
        st = p[:16]
    assert tmk.LAUNCHES["mega_bounce"] == 4


@pytest.mark.cuda
def test_proctex_mega_path_matches_plain_on_card():
    """mega_path with the procedural albedo against path_plain bit for
    bit, the count rows included."""
    dev = _card()
    tables, _, pix, samp, st = _proctex_lanes(dev)
    tmk.reset_launches()
    k = tmk.run_path(tables, 5, 6, 6, st, pix, samp, 1)
    assert torch.equal(k, tmk.path_plain(tables, 5, 6, 6, st, pix, samp, 1))
    assert tmk.LAUNCHES["mega_path"] == 1


@pytest.mark.cuda
def test_proctex_mega_persistent_matches_plain_on_card():
    """mega_persistent with the procedural albedo against
    persistent_plain bit for bit over 4 spp."""
    dev = _card()
    tables, cam, pix, samp, st = _proctex_lanes(dev)
    pst = torch.cat([st, torch.zeros_like(st[:8])])
    tmk.reset_launches()
    k = tmk.run_persistent(tables, 5, 6, 4, cam, pst, pix, samp, 1)
    assert torch.equal(k, tmk.persistent_plain(tables, 5, 6, 4, cam, pst,
                                               pix, samp, 1))
    assert tmk.LAUNCHES["mega_persistent"] == 1


def _texenv_vertex(dev, bounce):
    """chip_smoke's texenv scene (envmap, bitmap textures, normal and bump
    maps) at 64²: the eager wavefront at `bounce` and its vertex."""
    scene, cam, _ = tex_scene("texenv", TEX_RES, dev)
    tracer = PathTracer(max_depth=8, accel="plain").specialized_for(scene)
    pix = torch.arange(TEX_RES * TEX_RES, dtype=torch.int32, device=dev)
    samp = torch.zeros_like(pix)
    st = initial_state(*tmk.primary_rays(cam, 0, pix, 0))
    for b in range(bounce):
        st = tracer.bounce(scene, st, 0, pix, samp, b)[0]
    return scene, tracer, st, pix, samp


@pytest.mark.cuda
@pytest.mark.parametrize("bounce", [0, 3])
def test_texenv_trace_matches_plain_on_card(bounce):
    """The trace kernel on texenv's wavefront and its NEE shadow rays
    (toward the envmap, maxt ~1e30): closest and any hit bit for bit."""
    dev = _card()
    scene, tracer, st, pix, samp = _texenv_vertex(dev, bounce)
    v = tracer._vertex(scene, st, 0, pix, samp, bounce)
    o, d = st[0:3].T.contiguous(), st[3:6].T.contiguous()
    so = offset_ray_origin(v.its.p, v.its.ng, v.ds.d)
    assert bool((v.ds.dist[v.shadow] >= 1e30).all()) and v.shadow.any()
    for ray in ((o, d, ray_mint(o), torch.full_like(o[:, 0], 1e30),
                 st[12] > 0.5),
                (so, v.ds.d, ray_mint(so), v.ds.dist * (1.0 - 1e-3),
                 v.shadow)):
        ki = ttrace.intersect(scene, *ray)
        pi = tdense.ray_intersect(scene, *ray)
        for name in ("valid", "t", "tri_id", "uv"):
            assert torch.equal(getattr(ki, name), getattr(pi, name)), name
        assert torch.equal(ttrace.occluded(scene, *ray),
                           tdense.ray_test(scene, *ray))


@pytest.mark.cuda
@pytest.mark.parametrize("bounce", [0, 3])
def test_texenv_shade_matches_plain_on_card(bounce):
    """The shade kernel on texenv's texture-resolved rows and normal- and
    bump-mapped frames, with envmap NEE, against shade_plain bit for
    bit."""
    dev = _card()
    scene, tracer, st, pix, samp = _texenv_vertex(dev, bounce)
    assert tshade.supports(scene) == (True, "")
    packed = tracer.shade_inputs(scene, st, 0, pix, samp, bounce)
    tshade.reset_launches()
    k = tshade.run_shade(scene, packed, pix, samp, 0, bounce, 5, 8)
    assert torch.equal(k, tshade.shade_plain(scene, packed, pix, samp, 0,
                                             bounce, 5, 8))
    assert tshade.LAUNCHES["shade"] == 1


# ---------------------------------------------------------------------------
# the ordered walk (the trace kernel on tables of 8 to 128 clusters)
# ---------------------------------------------------------------------------

ORDER_RES = 64


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ORDER_SCENES) + ["sphere"])
def test_ordered_walk_matches_plain_on_card(name):
    """The ordered kernel against ordered_walk_plain bit for bit, visits
    included, and against dense.py, closest and any hit, on the eager
    path's wavefronts at bounces 0 and 3 and their NEE shadow rays (the
    Cornell box with an 8 x 16 sphere for "sphere": 8 clusters, 5
    walked)."""
    dev = _card()
    if name == "sphere":
        desc = tpresets.cornell_box()
        desc.add_shape(tshapes.sphere(8, 16), material=0,
                       to_world=ttf.translate([0.5, 0.4, 0.5])
                       @ ttf.scale(0.2))
        scene = tcompile(desc, device=dev)
        cam = tpresets.cornell_camera(ORDER_RES, ORDER_RES)
    else:
        scene, cam = order_scene(name, ORDER_RES, dev)
    assert ttrace.walks_ordered(scene)
    for label, (o, d, mint, maxt, live) in order_rays(
            scene, cam, ORDER_RES, device=dev).items():
        ref = tdense.intersect_soup(o, d, scene.woop_o, mint, maxt, live)
        for any_hit in (False, True):
            vis = torch.full((-(-o.shape[0] // 32),), -1, dtype=torch.int32,
                             device=dev)
            k = ttrace.trace(scene, o, d, mint, maxt, live, any_hit, vis)
            p = ttrace.ordered_walk_plain(scene, o, d, mint, maxt, live,
                                          any_hit)
            assert torch.equal(vis, p[5]), label
            assert torch.equal(k[4], p[4]) and torch.equal(k[4], ref[4])
            if not any_hit:
                for a, b, c in zip((k[0], k[1].long(), k[2], k[3]), p[:4],
                                   ref[:4]):
                    assert torch.equal(a, b) and torch.equal(a, c), label


# ---------------------------------------------------------------------------
# the probes (csrc/roofline.cu, csrc/gather.cu)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("fma", [False, True], ids=["fmul_fadd", "ffma"])
def test_e0_matches_plain_on_card(fma):
    """Both variants bit-equal to e0_plain (FFMA: its fma32, one rounding a
    step), and apart from each other on over a quarter of the lanes (58.5%
    of these by the plain versions), so a build that does not fuse fails."""
    from mitsuba_tpu_torch.experiments import roofline
    dev = _card()
    x = torch.as_tensor(np.random.RandomState(0).rand(132, 1024)
                        .astype(np.float32) + 0.5, device=dev)
    roofline.reset_launches()
    k = roofline.e0(x, 64, fma)
    assert torch.equal(k, roofline.e0_plain(x, 64, fma))
    assert roofline.LAUNCHES["e0_ffma" if fma else "e0_fmul_fadd"] == 1
    other = roofline.e0(x, 64, not fma)
    assert (k != other).float().mean().item() > 0.25


@pytest.mark.cuda
@pytest.mark.parametrize("table_name", ["probe", "leaf"])
def test_e1_matches_plain_on_card(table_name):
    """e1 at the TPU probe's inputs (40 random Woop rows, randn lanes) and
    on the leaf-families table with its camera rays (ordered and in index
    order), states and hit counts bit for bit."""
    from mitsuba_tpu_torch.experiments import roofline
    dev = _card()
    if table_name == "probe":
        tables = [roofline.probe_table(device=dev)]
        st = roofline.probe_state(1000, device=dev)
        n_iter = 64
    else:
        scene, cam, pix, _, st5 = _leaf(dev)
        tables = [scene, roofline.Table(scene.woop_clusters,
                                        scene.cluster_aabb, scene.woop_o,
                                        scene.n_real_tris)]
        st = st5[0:6].contiguous()
        n_iter = 3
    p, p_hits = roofline.e1_plain(tables[0], st, n_iter)
    for table in tables:
        hits = torch.zeros(n_iter, 2, dtype=torch.int32, device=dev)
        k = roofline.e1(table, st, n_iter, hits)
        assert torch.equal(k, p) and torch.equal(hits, p_hits)
    assert int(p_hits[0, 0]) > 0


@pytest.mark.cuda
def test_gathers_match_plain_on_card():
    """Every form, at its shape and with its index rows scaled 37 times:
    the kernel's loads equal the plain version's and torch.gather's; an
    index outside the table raises."""
    from mitsuba_tpu_torch.experiments import gather_probe
    dev = _card()
    gather_probe.reset_launches()
    for name in gather_probe.FORMS:
        for scale in (1, 37):
            tab, idx, axis, col = gather_probe.make_form(name, scale, dev)
            k = gather_probe.gather(tab, idx, axis, col)
            assert torch.equal(k, gather_probe.gather_plain(tab, idx, axis,
                                                            col)), name
            assert torch.equal(k, gather_probe.gather_library(
                tab, idx.long(), axis, col)), name
    assert gather_probe.LAUNCHES["gather"] == 2 * len(gather_probe.FORMS)
    tab, idx, axis, col = gather_probe.make_form("axis0 [8,128]", 1, dev)
    with pytest.raises(ValueError, match="outside"):
        gather_probe.gather(tab, idx + 8, axis, col)


# ---------------------------------------------------------------------------
# the ablation probe (experiments/ablate.py) and unbounded depth
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("variant", range(len(ablate.VARIANTS)),
                         ids=ablate.NAMES)
def test_ablate_matches_plain_on_card(variant):
    """Each variant of csrc/ablate.cu against its plain version on the
    Cornell tables (cluster_size 64), 1,024 lanes of the probe's start
    state over 8 steps: the state and the count rows, bit for bit."""
    dev = _card()
    scene = tcompile(tpresets.cornell_box(), cluster_size=64, device=dev)
    tables = MegaPathTracer.for_scene(scene).tables
    st = ablate.probe_state(1024, dev)
    ablate.reset_launches()
    k = ablate.run_fixed(tables, st, 8, variant)
    p = ablate.run_fixed_plain(tables, st, 8, variant)
    assert torch.equal(k, p)
    assert ablate.LAUNCHES == {f"ablate_{n}": int(n == ablate.NAMES[variant])
                               for n in ablate.NAMES}


@pytest.mark.cuda
def test_mega_bounce_unbounded_on_card():
    """mega_bounce at max_depth 0 (unbounded) against bounce_plain at
    bounce 9, where a bound of 8 would already have stopped every path:
    bit for bit, with shadow rays attempted and paths still alive; at
    max_depth 8 the same bounce attempts none and ends every path."""
    dev = _card()
    tables, _, pix, samp, st = _mega_inputs(dev)
    for b in range(9):
        st = tmk.bounce_plain(tables, 5, 0, st, pix, samp, 7, b)[:16]
    k = tmk.run_bounce(tables, 5, 0, st, pix, samp, 7, 9)
    assert torch.equal(k, tmk.bounce_plain(tables, 5, 0, st, pix, samp, 7,
                                           9))
    assert (k[12] > 0.5).any() and (k[17] > 0).any()
    bounded = tmk.run_bounce(tables, 5, 8, st, pix, samp, 7, 9)
    assert not (bounded[12] > 0.5).any() and not (bounded[17] > 0).any()


@pytest.mark.cuda
def test_wrappers_refuse_grad_on_card():
    """No kernel has a backward: under grad mode the trace kernel's,
    run_path's and run_shade's wrappers refuse an input that requires
    grad, and take it under torch.no_grad(); PathTracer(fused_shade="on")
    refuses a scene whose albedos require grad, while the eager path on
    the Cornell box (no ray depends on a parameter) runs the trace kernel
    and gives finite gradients equal to accel="plain"'s within
    1e-5·max|g| (the backward's scatter-adds are atomics)."""
    dev = _card()
    tables, _, pix, samp, st = _mega_inputs(dev)
    scene = tables.scene
    o, d = st[0:3].T.contiguous(), st[3:6].T.contiguous()
    mint = ray_mint(o)
    maxt = torch.full_like(mint, 1e30)
    og = o.clone().requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        ttrace.trace(scene, og, d, mint, maxt, None, False)
    with torch.no_grad():
        ttrace.trace(scene, og, d, mint, maxt, None, False)
    with pytest.raises(ValueError, match="no backward"):
        tmk.run_path(tables, 5, 4, 4, st.clone().requires_grad_(), pix,
                     samp, 0)
    packed = PathTracer(max_depth=4).shade_inputs(scene, st, 0, pix.long(),
                                                  samp, 0)
    with pytest.raises(ValueError, match="no backward"):
        tshade.run_shade(scene, packed.clone().requires_grad_(), pix, samp,
                         0, 0, 5, 4)
    grads = {}
    for accel in ("auto", "plain"):
        mat = scene.mat_params.clone().requires_grad_()
        sc = scene._replace(mat_params=mat)
        with pytest.raises(NotImplementedError, match="no backward"):
            PathTracer(max_depth=4, fused_shade="on", accel=accel).li(
                sc, o, d, 0, pix.long(), 0)
        ttrace.reset_launches()
        PathTracer(max_depth=4, accel=accel).li(
            sc, o, d, 0, pix.long(), 0).mean().backward()
        assert sum(ttrace.LAUNCHES.values()) == (8 if accel == "auto" else 0)
        grads[accel] = mat.grad
    g, gp = grads["auto"], grads["plain"]
    assert torch.isfinite(g).all() and g.abs().max() > 0
    assert (g - gp).abs().max() <= 1e-5 * gp.abs().max()


@pytest.mark.cuda
def test_cli_megakernel_route_on_card(tmp_path):
    """The command-line renderer on scenes/checker.xml at 16 spp, with no
    --device: it takes the megakernel route on the card (one
    mega_persistent launch, no trace launch), and its EXR reads back
    equal to the image it rendered."""
    import os

    from mitsuba_tpu_torch import cli
    from mitsuba_tpu_torch.io.image import read_exr
    _card()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "checker.exr")
    ttrace.reset_launches()
    tmk.reset_launches()
    (res,) = cli.run([os.path.join(root, "scenes", "checker.xml"), "-o",
                      out, "-s", "16", "-q"])
    assert (res.route, res.device, res.refused) == ("megakernel", "cuda", "")
    assert tmk.LAUNCHES["mega_persistent"] == 1
    assert sum(ttrace.LAUNCHES.values()) == 0
    assert np.isfinite(res.image).all() and res.n_rays > 0
    assert np.array_equal(read_exr(out), res.image)


def _light_runs(scene, cam):
    """Each caller of the light-subpath integrators at 32² with small
    settings (phase 29's (g)): {name: run()}."""
    from mitsuba_tpu_torch.film.film import Film
    from mitsuba_tpu_torch.integrator.bdpt import BDPT
    from mitsuba_tpu_torch.integrator.lightcuts import LightcutsIntegrator
    from mitsuba_tpu_torch.integrator.photonmap import PhotonMapper
    from mitsuba_tpu_torch.integrator.ptracer import ParticleTracer
    from mitsuba_tpu_torch.integrator.vpl import VPLIntegrator
    from mitsuba_tpu_torch.render import render_fn
    film = Film(32, 32)
    eye = lambda integ: lambda: render_fn(scene, cam, film, integ, 1, 0,
                                          device="cuda")
    return {
        "ptracer": lambda: ParticleTracer(max_depth=4).render_stats(
            scene, cam, 1 << 14, 0, device="cuda"),
        "bdpt": eye(BDPT(max_depth=4)),
        "vpl": eye(VPLIntegrator(max_depth=4, n_paths=32)),
        "lightcuts": eye(LightcutsIntegrator(max_depth=4, n_paths=32)),
        "photonmapper": eye(PhotonMapper(max_depth=4, n_photons=4096))}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ptracer", "bdpt", "vpl", "lightcuts",
                                  "photonmapper"])
def test_light_subpath_traces_match_plain_on_card(name):
    """Phase 29's trace checks: on the second closest-hit and the second
    any-hit call of each light-subpath integrator (the light tracer's
    walk and camera connections, BDPT's eye walk and connections, the
    VPL walk and the VPL or cut-node shadow rays, the photon walk and
    the eye pass's NEE), the trace kernel equals accel/dense.py on every
    lane, in both modes."""
    from chip_smoke import recorded_traces
    dev = _card()
    scene = _scene(False, dev)
    with recorded_traces() as got:
        _light_runs(scene, tpresets.cornell_camera(32, 32))[name]()
    for kind in ("closest", "any"):
        sc, o, d, mint, maxt, live = got[kind]
        ki = ttrace.intersect(sc, o, d, mint, maxt, live)
        pi = tdense.ray_intersect(sc, o, d, mint, maxt, live)
        for f in ("valid", "t", "tri_id", "uv"):
            assert torch.equal(getattr(ki, f), getattr(pi, f)), (kind, f)
        assert torch.equal(ttrace.occluded(sc, o, d, mint, maxt, live),
                           tdense.ray_test(sc, o, d, mint, maxt, live)), kind
