"""The port's multi-device layer (mitsuba_tpu_torch/parallel) on the CPU:
ranks spawned as processes (parallel/dist.py launch, the spawn start
method) over gloo, each with one torch thread, against the port's
single-process render_fn, autograd and render_persistent, and against
the JAX package (its render, and MULTICHIP_r05.json's dry run). The rank
functions live in mitsuba_tpu_torch/parallel/dryrun.py, so a rank
imports neither this module nor JAX; each rank reports the JAX modules
it holds (none)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.film.film import Film as JFilm
from mitsuba_tpu.integrator.path import PathTracer as JPath
from mitsuba_tpu.render import render as jrender
from mitsuba_tpu.render import render_fn as jrender_fn
from mitsuba_tpu.scene.builder import compile_scene as jcompile
from mitsuba_tpu.scene.presets import cornell_box as jcornell
from mitsuba_tpu.scene.presets import cornell_camera as jcamera
from mitsuba_tpu_torch.film.film import Film
from mitsuba_tpu_torch.integrator.mega import (MegaPathTracer,
                                               render_persistent)
from mitsuba_tpu_torch.integrator.path import PathTracer
from mitsuba_tpu_torch.parallel import dist as tdist
from mitsuba_tpu_torch.parallel.dryrun import cornell_cases, dryrun_multichip
from mitsuba_tpu_torch.render import render_fn
from mitsuba_tpu_torch.scene.builder import compile_scene
from mitsuba_tpu_torch.scene.presets import cornell_box, cornell_camera

torch.set_num_threads(2)

RES, DEPTH, SPP = 32, 3, 4          # tests/test_dist.py's configuration
P_RES = 16                          # render_persistent_sharded
CASES = {2: [("render", RES, DEPTH, SPP, 0), ("grad", RES, DEPTH, SPP, 0),
             ("persistent", P_RES, DEPTH, SPP, 0),
             ("replicate", 8, 1, 1, 0)],
         4: [("render", RES, DEPTH, SPP, 0), ("replicate", 8, 1, 1, 0)]}
# MULTICHIP_r05.json: dryrun_multichip(8) of the JAX package
R05_GRAD_NORM = 0.085615


@pytest.fixture(scope="module")
def ranks():
    """cornell_cases at world 2 and 4 on the CPU (gloo): each rank's
    output."""
    return {w: tdist.launch(cornell_cases, w, cases, device="cpu",
                            timeout=300)
            for w, cases in CASES.items()}


@pytest.fixture(scope="module")
def cornell():
    return compile_scene(cornell_box(), device="cpu")


def _image_rule(img, ref):
    """tests/test_render.py:44-48: < 1% of values off by rel > 5e-2, and
    the means within rel 5e-3."""
    rel = np.abs(img - ref) / np.maximum(ref, 1e-3)
    assert (rel > 5e-2).mean() < 1e-2, ((rel > 5e-2).mean(), img.mean())
    assert np.abs(img.mean() - ref.mean()) / ref.mean() < 5e-3


def test_make_mesh_needs_group():
    """make_mesh raises where torch.distributed has no process group."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no initialized process group"):
        tdist.make_mesh("cpu")


@pytest.mark.parametrize("world", [2, 4])
def test_render_sharded_matches_render_fn(ranks, cornell, world,
                                          record_property):
    """render_sharded at world 2 and 4 (Cornell 32², max_depth 3, 4 spp)
    against the single-process render_fn by tests/test_dist.py:38's rule
    (rtol 1e-4, atol 1e-5), on every rank; whether it is bit-equal is
    recorded (it is: each pixel gets its one sample a pass, and the
    all_reduce adds zeros). No rank imports JAX or the JAX package."""
    ref = render_fn(cornell, cornell_camera(RES, RES), Film(RES, RES),
                    PathTracer(max_depth=DEPTH), SPP, device="cpu")[0]
    ref = ref.numpy()
    for out in ranks[world]:
        img = out["results"][0]
        assert img.shape == (RES, RES, 3)
        np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-5)
        assert out["imported"] == []
    bit_equal = all(np.array_equal(o["results"][0], ref)
                    for o in ranks[world])
    record_property("bit_equal", bit_equal)
    print(f"render_sharded world {world}: bit-equal to render_fn: "
          f"{bit_equal}")


def test_render_sharded_matches_jax(ranks):
    """render_sharded at world 2 against the JAX render of the same
    configuration (cluster_size 128, as tests/test_dist.py), under
    tests/test_render.py:44-48's rule."""
    scene = jcompile(jcornell(), cluster_size=128)
    integ = JPath(max_depth=DEPTH, cluster_size=128).specialized_for(scene)
    ref = np.asarray(jrender(scene, jcamera(RES, RES), JFilm(RES, RES, "box"),
                             integ, spp=SPP, seed=0))
    _image_rule(ranks[2][0]["results"][0], ref)


def test_render_grad_sharded_matches_autograd(ranks, cornell):
    """render_grad_sharded at world 2 against loss.backward() of the mean
    of the single-process render_fn: the loss, and the gradients within
    rtol 1e-4, atol 1e-7, on every rank; the same gradients scaled by the
    world size (the factor JAX dist.py:141-145 warns of) fail that
    rule."""
    leaves = {k: getattr(cornell, k).clone().requires_grad_()
              for k in ("mat_params", "em_radiance")}
    img = render_fn(cornell._replace(**leaves), cornell_camera(RES, RES),
                    Film(RES, RES), PathTracer(max_depth=DEPTH), SPP,
                    device="cpu")[0]
    loss = img.mean()
    loss.backward()
    for out in ranks[2]:
        loss_r, grads = out["results"][1]
        np.testing.assert_allclose(loss_r, loss.item(), rtol=1e-6)
        for k, leaf in leaves.items():
            ref = leaf.grad.numpy()
            assert np.abs(ref).max() > 0
            np.testing.assert_allclose(grads[k], ref, rtol=1e-4, atol=1e-7)
            assert not np.allclose(2 * grads[k], ref, rtol=1e-4, atol=1e-7)


def test_render_persistent_sharded_matches(ranks, cornell):
    """render_persistent_sharded at world 2 (Cornell 16², 4 spp; the
    megakernel's plain version on the CPU) equals render_persistent, its
    ray count too."""
    integ = MegaPathTracer.for_scene(cornell, max_depth=DEPTH)
    img, n = render_persistent(integ, cornell_camera(P_RES, P_RES), SPP)
    for out in ranks[2]:
        img_r, n_r = out["results"][2]
        np.testing.assert_array_equal(img_r, img.numpy())
        assert int(n_r) == int(n) > 0


@pytest.mark.parametrize("world", [2, 4])
def test_replicate_scene(ranks, world):
    """replicate_scene gives every rank rank 0's tables: ranks r > 0 add
    r to their mat_params first and get the preset's back."""
    assert [o["results"][-1] for o in ranks[world]] == [0.0] * world


def test_launch_reports_a_rank_failure():
    """A rank that raises makes launch raise with its traceback."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="unknown case 'bogus'"):
        tdist.launch(cornell_cases, 2, [("bogus", 8, 1, 1, 0)],
                     device="cpu", timeout=120)


def test_dryrun_multichip_matches_jax(capsys):
    """dryrun_multichip(8) on the CPU (8 gloo ranks) against the JAX
    package in the entry's configuration (Cornell at cluster_size 128,
    16², max_depth 3, 1 spp, seed 0, the mean loss), as tests/test_grad.py
    differentiates it: the loss within rel 1e-5 of the JAX forward, each
    gradient entry of mat_params and em_radiance within 1e-4 of its
    jax.grad value plus 1e-6 of the leaf's largest, and the gradient norm
    within rel 1e-3 of the JAX dry run's, 0.085615
    (MULTICHIP_r05.json)."""
    loss, gnorm, grads = dryrun_multichip(8, device="cpu")
    out = capsys.readouterr().out
    assert out.startswith(f"dryrun_multichip(8): loss={loss:.6f} "
                          f"grad_norm={gnorm:.6f} OK")
    scene = jcompile(jcornell(), cluster_size=128)
    integ = JPath(max_depth=3, cluster_size=128).specialized_for(scene)

    def jloss(mat_params, em_radiance):
        sc = scene._replace(mat_params=mat_params, em_radiance=em_radiance)
        return jnp.mean(jrender_fn(sc, jcamera(16, 16), JFilm(16, 16, "box"),
                                   integ, spp=1, seed=0))

    ref, ref_g = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        scene.mat_params, scene.em_radiance)
    ref = float(ref)
    assert abs(loss - ref) <= 1e-5 * abs(ref), (loss, ref)
    for k, g_ref in zip(("mat_params", "em_radiance"), ref_g):
        g_ref = np.asarray(g_ref)
        assert grads[k].shape == g_ref.shape and np.abs(g_ref).max() > 0
        err = np.abs(grads[k] - g_ref)
        print(f"dryrun gradient {k}: max |port - jax.grad| {err.max():.3g}"
              f" of max |g| {np.abs(g_ref).max():.4g}")
        assert (err <= 1e-4 * np.abs(g_ref)
                + 1e-6 * np.abs(g_ref).max()).all(), (k, err.max())
    assert abs(gnorm - R05_GRAD_NORM) <= 1e-3 * R05_GRAD_NORM, gnorm
