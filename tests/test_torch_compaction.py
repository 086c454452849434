"""PathTracer's wavefront machinery (mitsuba_tpu_torch/integrator/path.py:
the stable-partition compaction, the coherence sort and the prefix gate,
ports of mitsuba_tpu/integrator/path.py:186-221, :300-370) on the CPU,
where accel="auto" runs the kernels' plain versions: every lane's value
and the ray counts against the same tracer with the module's thresholds
raised so that the plain loop runs, bit for bit (the CPU gave equal bits
on every lane here, so no share-of-lanes rule is needed); where each
mechanism runs and where it does not; gradients through the compacted
loop. The JAX references of these mechanisms
(tests/test_pallas_tpu.py::test_compacted_path_matches_dense,
::test_prefix_gated_path_matches_ungated) skip off a TPU, so the port is
held against its own uncompacted loop; tests/test_torch_composites.py
and tests/test_torch_textures.py hold compacted paths against the JAX
PathTracer."""
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import four_materials, leaf_scene
from mitsuba_tpu_torch.film.film import Film
from mitsuba_tpu_torch.integrator import path as tpath
from mitsuba_tpu_torch.integrator.direct import DirectIntegrator
from mitsuba_tpu_torch.integrator.mega import MegaPathTracer
from mitsuba_tpu_torch.integrator.path import PathTracer
from mitsuba_tpu_torch.integrator.volpath import VolPathTracer
from mitsuba_tpu_torch.render import render_fn
from mitsuba_tpu_torch.scene.builder import compile_scene
from mitsuba_tpu_torch.scene.presets import cornell_box, cornell_camera

torch.set_num_threads(2)

DEPTH = 6
SCENES = {"four_material": four_materials, "leaf": leaf_scene}


@pytest.fixture(scope="module")
def scenes():
    """The four-material scene (1,936 real triangles, 32 clusters: the
    sort's auto threshold) and the leaf-families scene (4,776, 80), each
    with a 32² camera, compiled once on the CPU."""
    return {name: make(32, device="cpu") for name, make in SCENES.items()}


@pytest.fixture
def spy(monkeypatch):
    """Records each compaction (lane_keys: lanes, sort) and each gate's
    choice (gate_width: width, live lanes)."""
    seen = {"keys": [], "gates": []}
    keys, width = tpath.lane_keys, tpath.gate_width

    def lane_keys(state, tri, sort):
        seen["keys"].append((state.shape[1], sort))
        return keys(state, tri, sort)

    def gate_width(gates, active):
        w = width(gates, active)
        seen["gates"].append((w, int((active > 0.5).sum())))
        return w

    monkeypatch.setattr(tpath, "lane_keys", lane_keys)
    monkeypatch.setattr(tpath, "gate_width", gate_width)
    return seen


def _render(scene, cam, res, spp, tracer):
    img, n = render_fn(scene, cam, Film(res, res), tracer, spp,
                       device="cpu")
    return img, int(n)


def _plain_loop(monkeypatch, integrate):
    """integrate() with the compaction threshold out of reach."""
    with monkeypatch.context() as m:
        m.setattr(tpath, "COMPACT_MIN_TRIS", 1 << 40)
        return integrate()


@pytest.mark.parametrize("name,res,spp", [("four_material", 32, 2),
                                          ("leaf", 16, 2)])
def test_compaction_and_sort_match_plain_loop(scenes, spy, monkeypatch,
                                              name, res, spp):
    """Compaction with the coherence sort (both on by default on these
    scenes) gives every pixel and the ray count of the plain loop, bit
    for bit."""
    scene, cam = scenes[name]
    cam = dataclasses.replace(cam, width=res, height=res)
    tracer = PathTracer(max_depth=DEPTH)
    assert tracer.wavefront(scene, res * res) == (True, True, [res * res])
    img, n = _render(scene, cam, res, spp, tracer)
    assert spy["keys"] == [(res * res, True)] * (DEPTH * spp)
    spy["keys"].clear()
    ref, n_ref = _plain_loop(monkeypatch, lambda: _render(
        scene, cam, res, spp, tracer))
    assert spy["keys"] == []
    assert torch.equal(img, ref) and n == n_ref
    assert img.mean() > 0.02


def test_partition_without_sort(scenes, spy):
    """sort_rays="off": the stable partition alone, equal to the sorted
    compaction bit for bit."""
    scene, cam = scenes["four_material"]
    cam = dataclasses.replace(cam, width=16, height=16)
    off = PathTracer(max_depth=DEPTH, sort_rays="off")
    assert off.wavefront(scene, 256) == (True, False, [256])
    img, n = _render(scene, cam, 16, 2, off)
    assert {s for _, s in spy["keys"]} == {False}
    ref, n_ref = _render(scene, cam, 16, 2, PathTracer(max_depth=DEPTH))
    assert torch.equal(img, ref) and n == n_ref


@pytest.mark.parametrize("name,res", [("four_material", 32),
                                      ("leaf", 16)])
def test_gate_matches_ungated(scenes, spy, monkeypatch, name, res):
    """The prefix gate, its lane threshold lowered to the lane count
    (res² lanes: widths res² ... res² / 32): gate_depth 5 against 0, bit
    for bit; the gate takes the narrowest width that holds the live
    lanes, and narrows."""
    n = res * res
    monkeypatch.setattr(tpath, "GATE_MIN_LANES", n)
    scene, cam = scenes[name]
    cam = dataclasses.replace(cam, width=res, height=res)
    gated = PathTracer(max_depth=DEPTH)
    assert gated.wavefront(scene, n)[2] == [n >> k for k in range(6)]
    img, n_rays = _render(scene, cam, res, 2, gated)
    widths = spy["gates"]
    assert len(widths) == DEPTH * 2
    assert all(w >= live and (w == n >> 5 or w // 2 < live)
               for w, live in widths), widths
    assert min(w for w, _ in widths) < n
    assert [k for k, _ in spy["keys"]] == [w for w, _ in widths]
    ref, n_ref = _render(scene, cam, res, 2,
                         dataclasses.replace(gated, gate_depth=0))
    assert torch.equal(img, ref) and n_rays == n_ref


def test_cornell_never_permutes(spy):
    """The Cornell box (36 real triangles) keeps the plain loop, at any
    lane count: no compaction, no sort, no gate."""
    scene = compile_scene(cornell_box(), device="cpu")
    tracer = PathTracer(max_depth=4)
    assert tracer.wavefront(scene, 1 << 16) == (False, False, [1 << 16])
    img, _ = _render(scene, cornell_camera(16, 16), 16, 2, tracer)
    assert spy["keys"] == [] and spy["gates"] == []
    assert 0.1 < img.mean() < 0.4


def test_accel_plain_keeps_plain_loop(scenes):
    """accel="plain" (the JAX accel="dense") never compacts: the
    machinery is the kernel route's."""
    scene, _ = scenes["leaf"]
    assert PathTracer(accel="plain").wavefront(scene, 1 << 16) == (
        False, False, [1 << 16])


def test_other_integrators_do_not_compact(scenes, spy, monkeypatch):
    """VolPathTracer (its JAX loop has no compaction), DirectIntegrator
    and MegaPathTracer (each with its own li_stats) run as before on the
    four-material scene: no lane moves, and the result equals the one
    with the threshold out of reach."""
    scene, cam = scenes["four_material"]
    res = 16
    cam = dataclasses.replace(cam, width=res, height=res)
    assert VolPathTracer().wavefront(scene, 1 << 16)[0] is False
    for tracer in (VolPathTracer(max_depth=4), DirectIntegrator(),
                   MegaPathTracer.for_scene(scene, max_depth=4)):
        img, n = _render(scene, cam, res, 1, tracer)
        ref, n_ref = _plain_loop(monkeypatch, lambda: _render(
            scene, cam, res, 1, tracer))
        assert torch.equal(img, ref) and n == n_ref
        assert torch.isfinite(img).all()
    assert spy["keys"] == [] and spy["gates"] == []


def test_gradients_through_compaction(scenes, spy, monkeypatch):
    """Autograd of mean(li) with respect to mat_params and em_radiance
    through the compacted, sorted loop on the four-material scene equals
    the plain loop's within rel 1e-5, NaN on the same entries, which are
    among those tests/test_torch_prb.py::test_naive_grad_nan_as_reference
    expects (GGX α, the glass's η)."""
    scene, _ = scenes["four_material"]
    rs = np.random.RandomState(5)
    n = 256
    o = torch.tensor(np.tile([[0.0, 1.0, 6.0]], (n, 1)), dtype=torch.float32)
    d = rs.randn(n, 3) * [0.5, 0.4, 0.2] + [0, -0.1, -1.0]
    d = torch.tensor(d / np.linalg.norm(d, axis=-1, keepdims=True),
                     dtype=torch.float32)
    px = torch.arange(n)

    def grads():
        leaves = {k: getattr(scene, k).clone().requires_grad_()
                  for k in ("mat_params", "em_radiance")}
        L = PathTracer(max_depth=4).li(scene._replace(**leaves), o, d, 0, px,
                                       0)
        L.mean().backward()
        return L.detach(), {k: v.grad for k, v in leaves.items()}

    L, g = grads()
    assert len(spy["keys"]) == 4
    L_ref, g_ref = _plain_loop(monkeypatch, grads)
    assert torch.equal(L, L_ref)
    for k in g:
        nan = torch.isnan(g[k])
        assert torch.equal(nan, torch.isnan(g_ref[k])), k
        assert {tuple(i) for i in nan.nonzero().tolist()} <= {
            (0, 9), (0, 10), (1, 9), (1, 10), (2, 0)}
        torch.testing.assert_close(g[k], g_ref[k], rtol=1e-5, atol=0,
                                   equal_nan=True)
        assert g[k][~nan].abs().max() > 0


def _jax_plan(n_tris, n_clusters, n, sort_rays, gate_depth):
    """mitsuba_tpu/integrator/path.py:193-221 with _use_pallas() true:
    (compact, sort_lanes, gate_sizes), given the real triangle count
    where JAX reads the padded one. So it differs from JAX on a padded
    scene of fewer than 512 real triangles (the Cornell box: JAX
    compacts it, the port does not), as ROADMAP.md Queue C's entry on
    mitsuba_tpu/integrator/path.py:193 records."""
    compact = n_tris >= 512
    sort_lanes = compact and (sort_rays == "on" or (
        sort_rays == "auto" and n_clusters >= 32))
    gate_sizes = [n]
    if compact and n >= (1 << 16):
        gate_sizes = [n >> k for k in range(gate_depth + 1) if (n >> k) > 0]
    return compact, sort_lanes, gate_sizes


@pytest.mark.parametrize("sort_rays", ["on", "off", "auto"])
def test_settings_match_jax(scenes, sort_rays):
    """wavefront() decides as the JAX PathTracer does on the real
    triangle count (JAX reads the padded one), over scenes below and
    above each threshold, lane counts about the gate's and gate depths
    0, 3 and 5; sort_rays outside on/off/auto and a negative or
    non-integer gate_depth raise."""
    cornell = compile_scene(cornell_box(), device="cpu")
    for scene in (cornell, scenes["four_material"][0], scenes["leaf"][0]):
        for n in (1024, (1 << 16) - 1, 1 << 16, (1 << 16) + 7, 1 << 20):
            for depth in (0, 3, 5):
                tracer = PathTracer(sort_rays=sort_rays, gate_depth=depth)
                assert tracer.wavefront(scene, n) == _jax_plan(
                    scene.n_real_tris, scene.woop_clusters.shape[0], n,
                    sort_rays, depth)
    for bad in ({"sort_rays": "yes"}, {"gate_depth": -1},
                {"gate_depth": 2.0}):
        with pytest.raises(ValueError):
            PathTracer(**bad)
