"""The port's ray tracing on the CPU: the plain intersector against the JAX
package's dense intersector, and the trace wrappers' CPU route. The CUDA
kernel's tests are in test_torch_kernels.py.

The Pallas kernel does not run on the CPU, so its plain reference,
mitsuba_tpu.accel.dense, is what the port is held against here."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.accel import dense as jdense
from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.scene import presets as jpresets
from mitsuba_tpu.scene import shapes as jshapes
from mitsuba_tpu.scene.builder import compile_scene as jcompile
from mitsuba_tpu_torch.accel import dense as tdense
from mitsuba_tpu_torch.accel import trace as ttrace
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.scene import presets as tpresets
from mitsuba_tpu_torch.scene import shapes as tshapes
from mitsuba_tpu_torch.scene.builder import compile_scene as tcompile

torch.set_num_threads(2)


def _descs(with_sphere: bool):
    out = []
    for presets, shapes, tf in ((jpresets, jshapes, jtf),
                                (tpresets, tshapes, ttf)):
        desc = presets.cornell_box()
        if with_sphere:
            desc.add_shape(shapes.sphere(8, 16),
                           to_world=tf.translate([0.5, 0.4, 0.5])
                           @ tf.scale(0.2), material=0)
        out.append(desc)
    return out


@pytest.fixture(scope="module", params=[False, True],
                ids=["cornell", "cornell+sphere"])
def scenes(request):
    jd, td = _descs(request.param)
    return jcompile(jd), tcompile(td, device="cpu")


def _rays(n=4096, seed=0):
    """Origins inside the box, uniform directions, finite segment ends."""
    rs = np.random.RandomState(seed)
    o = (rs.rand(n, 3) * 0.98 + 0.01).astype(np.float32)
    d = rs.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    mint = np.full(n, 1e-4, np.float32)
    seg = (rs.rand(n) * 1.2).astype(np.float32)
    return o, d, mint, seg


def test_plain_intersect_matches_jax(scenes):
    """Hit agreement ≥ 99.9%; on shared hits t rel ≤ 1e-5 plus 1e-7
    absolute (o' = M⁻¹(o - p0) rounds to ~|o|·2⁻²⁴ absolute, which
    dominates for hits a few mm away), and the same triangle on ≥ 99.9% of
    them (rays on a shared edge may pick either)."""
    jscene, tscene = scenes
    o, d, mint, _ = _rays()
    maxt = np.full(len(o), 1e30, np.float32)
    ji = jax.jit(lambda *a: jdense.ray_intersect(jscene, *a))(
        *(jnp.asarray(x) for x in (o, d, mint, maxt)))
    ti = tdense.ray_intersect(tscene, *(torch.as_tensor(x)
                                        for x in (o, d, mint, maxt)))
    jv, tv = np.asarray(ji.valid), ti.valid.numpy()
    assert (jv == tv).mean() >= 0.999
    assert tv.mean() > 0.5     # inside the box; the camera side is open
    both = jv & tv
    np.testing.assert_allclose(ti.t.numpy()[both], np.asarray(ji.t)[both],
                               rtol=1e-5, atol=1e-7)
    same = ti.tri_id.numpy()[both] == np.asarray(ji.tri_id)[both]
    assert same.mean() >= 0.999
    for name in ("p", "ng", "ns"):
        np.testing.assert_allclose(
            getattr(ti, name).numpy()[both][same],
            np.asarray(getattr(ji, name))[both][same], rtol=1e-4, atol=1e-5,
            err_msg=name)
    for name in ("mat_id", "em_id"):
        assert np.array_equal(getattr(ti, name).numpy()[both][same],
                              np.asarray(getattr(ji, name))[both][same])
    assert (ti.t.numpy()[~tv] == tdense.MISS).all()
    assert (ti.mat_id.numpy()[~tv] == -1).all()


def test_plain_occluded_matches_jax(scenes):
    """Shadow-ray predicate on finite segments: agreement ≥ 99.9%."""
    jscene, tscene = scenes
    o, d, mint, seg = _rays(seed=1)
    jh = np.asarray(jax.jit(lambda *a: jdense.ray_test(jscene, *a))(
        *(jnp.asarray(x) for x in (o, d, mint, seg))))
    th = tdense.ray_test(tscene, *(torch.as_tensor(x)
                                   for x in (o, d, mint, seg))).numpy()
    assert (jh == th).mean() >= 0.999
    assert 0.05 < th.mean() < 0.95


def test_trace_wrappers_route_cpu_to_plain(scenes):
    """On CPU tensors the wrappers run the plain version, launch nothing,
    and a dead lane reports a miss."""
    _, tscene = scenes
    o, d, mint, seg = (torch.as_tensor(x) for x in _rays(512, seed=2))
    live = torch.arange(512) % 3 != 0
    ttrace.reset_launches()
    its = ttrace.intersect(tscene, o, d, mint, torch.full_like(seg, 1e30),
                           live)
    ref = tdense.ray_intersect(tscene, o, d, mint, torch.full_like(seg, 1e30))
    assert torch.equal(its.valid, ref.valid & live)
    assert torch.equal(its.t[live], ref.t[live])
    occ = ttrace.occluded(tscene, o, d, mint, seg, live)
    assert torch.equal(occ, tdense.ray_test(tscene, o, d, mint, seg) & live)
    assert ttrace.LAUNCHES == {"trace_closest": 0, "trace_any": 0}


def test_cluster_tables(scenes):
    """Kernel layout: cluster c row k*64+t holds row k of triangle
    c*64+t's Woop transform; padding clusters hold inverted boxes."""
    _, tscene = scenes
    wc = tscene.woop_clusters.numpy()
    wo = tscene.woop_o.numpy().reshape(4, -1, 3)      # [j, T, k]
    c, t, k = 3, 17, 2
    assert np.array_equal(wc[c, k * 64 + t], wo[:, c * 64 + t, k])
    aabb = tscene.cluster_aabb.numpy()
    n_real = -(-int((tscene.tri_area > 0).sum()) // 64)
    assert (aabb[n_real:, 0:3] > aabb[n_real:, 3:6]).all()
    assert (aabb[:n_real, 0:3] <= aabb[:n_real, 3:6]).all()


def test_kernel_launch_rejects_cpu_tensors(scenes):
    """The raw launch never runs the plain version: CPU rays raise."""
    _, tscene = scenes
    o, d, mint, seg = (torch.as_tensor(x) for x in _rays(64))
    with pytest.raises(ValueError, match="CUDA kernel"):
        ttrace.trace(tscene, o, d, mint, seg, None, True)
