"""The port's CUDA kernels (the trace kernel, the path megakernels and the
fused shade kernel) against their plain PyTorch versions, on the card,
on the Cornell box, the four-material scene and the leaf-families scene
(chip_smoke.py). Every test is marked `cuda` and skips without a card.
The file
imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    MITSUBA_TPU_TESTS=1 python -m pytest tests/test_torch_kernels.py -m cuda
"""
import numpy as np
import pytest
import torch

from chip_smoke import (four_materials, leaf_families_camera,
                        leaf_families_desc, walk_build)
from mitsuba_tpu_torch.accel import dense as tdense
from mitsuba_tpu_torch.accel import megakernel as tmk
from mitsuba_tpu_torch.accel import shade_kernel as tshade
from mitsuba_tpu_torch.accel import trace as ttrace
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.integrator.mega import MegaPathTracer
from mitsuba_tpu_torch.integrator.path import PathTracer, initial_state
from mitsuba_tpu_torch.scene import presets as tpresets
from mitsuba_tpu_torch.integrator.common import ray_mint
from mitsuba_tpu_torch.scene import shapes as tshapes
from mitsuba_tpu_torch.scene.builder import SceneDesc
from mitsuba_tpu_torch.scene.builder import compile_scene as tcompile
from mitsuba_tpu_torch.sensor.sensor import PerspectiveCamera

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


def _assert_walk_equal(scene, o, d, mint, maxt, live, walk):
    """The trace kernel under `walk`, closest hit and any hit, against the
    plain version bit for bit on every lane."""
    pt, ptri, pu, pv, phit = tdense.intersect_soup(o, d, scene.woop_o, mint,
                                                   maxt, live)
    with walk_build(*WALKS[walk]):
        t, tri, u, v, hit = ttrace.trace(scene, o, d, mint, maxt, live,
                                         False)
        any_hit = ttrace.trace(scene, o, d, mint, maxt, live, True)[4]
    assert torch.equal(hit, phit)
    assert torch.equal(t, pt) and torch.equal(tri.long(), ptri)
    assert torch.equal(u, pu) and torch.equal(v, pv)
    assert torch.equal(any_hit, phit)
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
@pytest.mark.parametrize("walk", list(WALKS))
@pytest.mark.parametrize("n", [33, 100, 65537])
def test_walk_matches_plain_on_card(n, walk):
    """Ragged ray counts (the last warp partly empty), dead lanes, lanes in
    shuffled order on the leaf-families scene, so warps diverge across
    clusters: both walks give the plain version's hits bit for bit."""
    dev = _card()
    scene, camera, shadow = _leaf_rays(dev, n)
    _assert_walk_equal(scene, *camera, walk)
    _assert_walk_equal(scene, *shadow, walk)


def _tie_scene(dev):
    """Coincident triangles in the plane z = 0, among 120 small ones far
    below: A at triangles 5, 37 (one cluster, lanes 5 and 5 + 32) and 70
    (the next cluster); B at 40 (lane 8 + 32 of cluster 0) and 66 (lane 2
    of cluster 1); C at 80 and 112 (lanes 16 and 16 + 32 of cluster 1).
    120 triangles keep the author's order (Morton order starts past 256)."""
    rs = np.random.RandomState(3)
    tris = rs.rand(120, 3, 3) * 0.1 + np.array([0.0, 0.0, -50.0])
    quad = lambda x0: np.array([[x0, -1.0, 0.0], [x0 + 2.0, -1.0, 0.0],
                                [x0, 1.0, 0.0]])
    for ids, x0 in (((5, 37, 70), -3.0), ((40, 66), -1.0), ((80, 112), 1.0)):
        for i in ids:
            tris[i] = quad(x0)
    desc = SceneDesc()
    desc.add_shape(tshapes.Mesh(tris.reshape(-1, 3),
                                np.arange(360).reshape(120, 3)),
                   material=desc.add_material(kind="diffuse"))
    return tcompile(desc, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("walk", list(WALKS))
@pytest.mark.parametrize("sparse", [False, True], ids=["all", "sparse"])
def test_walk_ties_on_card(walk, sparse):
    """Rays that meet two or three coincident triangles at one t report the
    lowest index (5, 40 or 80), within a cluster and across clusters. With
    one lane in eight live, few lanes of a warp enter a cluster and the
    cooperative branch scans it; with all live, the lanes scan it."""
    dev = _card()
    scene = _tie_scene(dev)
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
