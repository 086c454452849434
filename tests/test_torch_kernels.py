"""The port's CUDA kernels (the trace kernel, the path megakernels and the
fused shade kernel) against their plain PyTorch versions, on the card. Every test is marked `cuda` and skips without a card. The file
imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    MITSUBA_TPU_TESTS=1 python -m pytest tests/test_torch_kernels.py -m cuda
"""
import numpy as np
import pytest
import torch

from chip_smoke import four_materials
from mitsuba_tpu_torch.accel import dense as tdense
from mitsuba_tpu_torch.accel import megakernel as tmk
from mitsuba_tpu_torch.accel import shade_kernel as tshade
from mitsuba_tpu_torch.accel import trace as ttrace
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.integrator.mega import MegaPathTracer
from mitsuba_tpu_torch.integrator.path import PathTracer, initial_state
from mitsuba_tpu_torch.scene import presets as tpresets
from mitsuba_tpu_torch.scene import shapes as tshapes
from mitsuba_tpu_torch.scene.builder import compile_scene as tcompile

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


def _four_materials(dev):
    """The four-material scene of tests/test_pallas_tpu.py:160-183
    (sphere(16, 32)) and its camera at (0, 1, 6) along (0, -0.1, -1)."""
    d = SceneDesc()
    white = d.add_material(kind="diffuse", albedo=(0.7, 0.7, 0.7))
    ggx = d.add_material(kind="roughconductor", alpha=0.2)
    glass = d.add_material(kind="dielectric", int_ior=1.5)
    mirror = d.add_material(kind="conductor")
    d.add_shape(tshapes.rectangle(), material=white,
                to_world=ttf.translate([0, -1, 0])
                @ ttf.rotate([1, 0, 0], -90) @ ttf.scale([6] * 3))
    for x, mat in ((-1.5, ggx), (1.5, glass)):
        d.add_shape(tshapes.sphere(16, 32), to_world=ttf.translate([x, 0, 0]),
                    material=mat)
    d.add_shape(tshapes.cube(), material=mirror,
                to_world=ttf.translate([0, 0, -2]) @ ttf.scale([0.7] * 3))
    d.add_shape(tshapes.rectangle(), material=white, radiance=(10, 9, 8),
                to_world=ttf.translate([0, 4, 0])
                @ ttf.rotate([1, 0, 0], 90) @ ttf.scale([1.5] * 3))
    cam = PerspectiveCamera(64, 64, 39.0, ttf.look_at(
        origin=[0, 1, 6], target=[0, 0.9, 5], up=[0, 1, 0]))
    return tcompile(d, device=dev), cam


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
