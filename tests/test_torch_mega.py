"""The port's megakernel integrator (integrator/mega.py, accel/megakernel.py)
against the JAX package on the CPU, where its wrappers run their plain
versions.

The JAX megakernels run only on a TPU (tests/test_mega_tpu.py), so the
port is held against JAX's XLA PathTracer, specialized to the scene's BSDF
families as tests/test_torch_path.py does, and against the JAX table
packer, which runs on the host."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.accel.megakernel import build_mega_tables as jtables
from mitsuba_tpu.core import rng as jrng
from mitsuba_tpu.film.film import Film as JFilm
from mitsuba_tpu.integrator.common import DIM_APERTURE as J_DIM_APERTURE
from mitsuba_tpu.integrator.common import DIM_PIXEL as J_DIM_PIXEL
from mitsuba_tpu.integrator.mega import MegaPathTracer as JMega
from mitsuba_tpu.integrator.path import PathTracer as JPath
from mitsuba_tpu.render import render as jrender
from mitsuba_tpu.scene import presets as jpresets
from mitsuba_tpu.scene.builder import compile_scene as jcompile
from mitsuba_tpu_torch.accel import megakernel as tmk
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.film.film import Film as TFilm
from mitsuba_tpu_torch.integrator.mega import (MegaPathTracer,
                                               _persistent_lanes,
                                               render_persistent)
from mitsuba_tpu_torch.integrator.path import PathTracer as TPath
from mitsuba_tpu_torch.integrator.path import initial_state
from mitsuba_tpu_torch.render import render_fn as trender_fn
from mitsuba_tpu_torch.scene import presets as tpresets
from mitsuba_tpu_torch.scene import shapes as tshapes
from mitsuba_tpu_torch.scene.builder import compile_scene as tcompile

torch.set_num_threads(2)

RES = 32            # li_stats lanes: RES²
P_RES, P_SPP = 16, 4  # render_persistent


@pytest.fixture(scope="module")
def cornell():
    jscene = jcompile(jpresets.cornell_box())
    tscene = tcompile(tpresets.cornell_box(), device="cpu")
    return jscene, tscene, MegaPathTracer.for_scene(tscene)


def _image_rule(img, ref):
    """tests/test_render.py's rule: < 1% of values off by rel > 5e-2, and
    the means within rel 5e-3."""
    rel = np.abs(img - ref) / np.maximum(ref, 1e-3)
    assert (rel > 5e-2).mean() < 1e-2, ((rel > 5e-2).mean(), img.mean())
    assert np.abs(img.mean() - ref.mean()) / ref.mean() < 5e-3


def test_tables_match_jax(cornell):
    """The port's packer holds the JAX packer's values, up to the layout:
    attr rows of the real triangles, emitter rows and meta of the real
    rows, all 69 material columns."""
    jscene, _, integ = cornell
    jt, tt = jtables(jscene), integ.tables
    assert (jt.tc, jt.m_real, jt.et_real, jt.em_count) == (40, 3, 2, 1)
    assert (tt.m_real, tt.et_real, tt.em_count) == (3, 2, 1)
    assert tt.n_tris == jt.n_tris == 36 and not jt.smooth
    np.testing.assert_array_equal(
        tt.attr[:36].numpy(), np.asarray(jt.attr).reshape(-1, 25)[:36])
    np.testing.assert_array_equal(tt.em_rows[:2].numpy(),
                                  np.asarray(jt.em_rows)[:2])
    np.testing.assert_array_equal(tt.em_meta[:1].numpy(),
                                  np.asarray(jt.em_meta)[:1])
    np.testing.assert_array_equal(tt.mat.numpy(), np.asarray(jt.mat)[:, :3].T)
    # sentinel emissive-triangle rows are never picked
    assert (tt.em_rows[2:, 12] == 1e9).all()


def _with(scene, **fields):
    return scene._replace(**fields)


def test_supports(cornell):
    """True on the Cornell box, as in the JAX package, and with a smooth
    sphere added; False with the feature's name on scenes the port's
    subset excludes."""
    jscene, tscene, _ = cornell
    assert JMega.supports(jscene) == (True, "")
    assert MegaPathTracer.supports(
        tscene, tpresets.cornell_camera(8, 8), TFilm(8, 8)) == (True, "")
    mixture = tscene.mat_params.clone()
    mixture[1, 12] = 13.0
    point = _with(tscene, em_type=torch.tensor([1], dtype=torch.int32))
    desc = tpresets.cornell_box()
    desc.add_shape(tshapes.sphere(4, 8), material=0,
                   to_world=ttf.translate([0.5, 0.4, 0.5]) @ ttf.scale(0.2))
    smooth = tcompile(desc, device="cpu")
    cases = [
        (_with(tscene, mat_type=torch.tensor([0, 13, 0], dtype=torch.int32),
               mat_params=mixture), "BSDF families [13] not ported"),
        (point, "point emitters not ported"),
        (_with(tscene, has_medium=torch.tensor(True)),
         "participating medium"),
    ]
    assert MegaPathTracer.supports(smooth) == (True, "")
    for scene, reason in cases:
        assert MegaPathTracer.supports(scene) == (False, reason)
        with pytest.raises(NotImplementedError, match=re.escape(reason)):
            MegaPathTracer.for_scene(scene)
    lens = tpresets.cornell_camera(8, 8)
    lens = type(lens)(8, 8, lens.fov_x, lens.to_world, aperture_radius=0.1)
    assert MegaPathTracer.supports(tscene, lens) == \
        (False, "thin-lens camera not ported")


def _primary_rays(seed=0):
    rs = np.random.RandomState(seed)
    pos = ((np.stack(np.meshgrid(np.arange(RES), np.arange(RES)), -1)
            .reshape(-1, 2) + rs.rand(RES * RES, 2)).astype(np.float32))
    o, d = jpresets.cornell_camera(RES, RES).sample_ray(jnp.asarray(pos))
    return np.array(o), np.array(d)


def test_li_stats_matches_jax(cornell):
    """MegaPathTracer.li_stats (run_path, plain on the CPU) against JAX
    PathTracer.li_stats on the same primary rays, pixel ids and sample
    index: the ray count exactly at seed 0, and >= 99% of lanes within
    rel 1e-3 (tests/test_torch_path.py's tolerance: lanes forking at a
    decision boundary may differ)."""
    jscene, tscene, integ = cornell
    o, d = _primary_rays()
    px = np.arange(RES * RES, dtype=np.uint32) * 7 + 3
    jint = JPath(max_depth=8).specialized_for(jscene)
    jL, jn = jax.jit(lambda o, d: jint.li_stats(
        jscene, o, d, jnp.uint32(0), jnp.asarray(px), jnp.uint32(2)))(
            jnp.asarray(o), jnp.asarray(d))
    tL, tn = integ.li_stats(tscene, torch.as_tensor(o), torch.as_tensor(d),
                            0, torch.as_tensor(px.astype(np.int64)), 2)
    jL, tL = np.asarray(jL), tL.numpy()
    assert int(tn) == int(jn)
    rel = np.abs(tL - jL).max(-1) / np.maximum(np.abs(jL).max(-1), 1e-3)
    assert (rel <= 1e-3).mean() >= 0.99, (rel > 1e-3).mean()
    assert jL.mean() > 0.05


def test_render_persistent_matches_jax(cornell):
    """render_persistent at 16², 4 spp, seed 0 against JAX render() with
    the XLA PathTracer and a box Film: the tests/test_render.py rule, and
    the ray count equal to the sum of JAX li_stats counts over the same 4
    sample passes (render()'s camera rays; exact at seed 0)."""
    jscene, _, integ = cornell
    cam_j = jpresets.cornell_camera(P_RES, P_RES)
    jint = JPath(max_depth=8).specialized_for(jscene)
    ref = np.asarray(jrender(jscene, cam_j, JFilm(P_RES, P_RES, "box"),
                             jint, spp=P_SPP, seed=0))
    px = jnp.arange(P_RES * P_RES, dtype=jnp.uint32)

    @jax.jit
    def pass_count(s):
        jit = jrng.sample_2d(0, px, J_DIM_PIXEL, s)
        pos = jnp.stack([(px % P_RES).astype(jnp.float32) + jit[:, 0],
                         (px // P_RES).astype(jnp.float32) + jit[:, 1]], -1)
        o, d = cam_j.sample_ray(pos, jrng.sample_2d(0, px, J_DIM_APERTURE,
                                                    s))
        return jint.li_stats(jscene, o, d, jnp.uint32(0), px, s)[1]

    j_rays = sum(int(pass_count(jnp.uint32(s))) for s in range(P_SPP))
    img, n_rays = render_persistent(
        integ, tpresets.cornell_camera(P_RES, P_RES), P_SPP, seed=0)
    img = img.numpy()
    assert img.shape == (P_RES, P_RES, 3) and np.isfinite(img).all()
    _image_rule(img, ref)
    assert int(n_rays) == j_rays


def test_render_persistent_equals_render(cornell):
    """The persistent render is render() with MegaPathTracer: the same
    per-pixel mean over the same (pixel, sample) streams, to rel 1e-6,
    and the same ray count."""
    _, tscene, integ = cornell
    cam = tpresets.cornell_camera(P_RES, P_RES)
    img_p, n_p = render_persistent(integ, cam, P_SPP, seed=0)
    img_r, n_r = trender_fn(tscene, cam, TFilm(P_RES, P_RES), integ, P_SPP,
                            seed=0, device="cpu")
    np.testing.assert_allclose(img_p.numpy(), img_r.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert int(n_p) == int(n_r)


def test_persistent_lanes_any_order(cornell):
    """Any lane→pixel assignment gives the same per-pixel estimate and
    counts: the sample streams are keyed by pixel id."""
    _, _, integ = cornell
    cam = tpresets.cornell_camera(P_RES, P_RES)
    n = P_RES * P_RES
    ident = torch.arange(n, dtype=torch.int32)
    perm = torch.as_tensor(np.random.RandomState(1).permutation(n),
                           dtype=torch.int32)
    l_id, c_id = _persistent_lanes(integ, cam, 2, 5, ident)
    l_pm, c_pm = _persistent_lanes(integ, cam, 2, 5, perm)
    np.testing.assert_array_equal(l_pm.numpy(), l_id[perm.long()].numpy())
    np.testing.assert_array_equal(c_pm.numpy(), c_id[perm.long()].numpy())


def test_li_stats_equals_path_tracer(cornell):
    """On the CPU, MegaPathTracer.li_stats is PathTracer.li_stats bit for
    bit (run_path's plain version loops PathTracer.bounce)."""
    _, tscene, integ = cornell
    o, d = (torch.as_tensor(x) for x in _primary_rays(3))
    px = torch.arange(RES * RES)
    mL, mn = integ.li_stats(tscene, o, d, 4, px, 1)
    pL, pn = TPath().li_stats(tscene, o, d, 4, px, 1)
    assert torch.equal(mL, pL) and int(mn) == int(pn)
    with pytest.raises(ValueError, match="another scene"):
        integ.li_stats(tcompile(tpresets.cornell_box(), device="cpu"), o, d,
                       4, px, 1)


def test_plain_bounce_rows(cornell):
    """The plain versions' row layout: the path loop's state and counts
    are the bounce loop's, a lane dead on entry comes out unchanged, and
    the persistent rows hold spp, the L sum and the counts."""
    _, _, integ = cornell
    t = integ.tables
    n = 64
    pix = torch.arange(n, dtype=torch.int32)
    samp = torch.zeros_like(pix)
    o, d = tmk.primary_rays(tpresets.cornell_camera(8, 8), 0, pix, 0)
    st = initial_state(o, d)
    st[12, ::4] = 0.0
    path = tmk.run_path(t, 5, 8, 8, st, pix, samp, 0)
    s, counts = st, torch.zeros((2, n))
    for b in range(8):
        out = tmk.run_bounce(t, 5, 8, s, pix, samp, 0, b)
        s, counts = out[:16], counts + out[16:18]
    assert torch.equal(path, torch.cat([s, counts]))
    assert torch.equal(path[:16, ::4], st[:, ::4])
    assert (path[16:18, ::4] == 0).all() and (path[16, 1::4] >= 1).all()
    cam = tpresets.cornell_camera(8, 8)
    pst = torch.cat([st, torch.zeros((8, n))])
    per = tmk.run_persistent(t, 5, 8, 3, cam, pst, pix, samp, 0)
    live = st[12] > 0.5
    assert (per[17, live] == 3).all() and torch.equal(per[:, ~live],
                                                      pst[:, ~live])
    assert torch.equal(per[21], per[22]) and (per[22, live] >= 3).all()
