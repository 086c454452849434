"""The trace kernel's ordered walk on the CPU (the ordered branch of
mitsuba_tpu/accel/pallas_trace.py::_trace_kernel_fused, :242-311).

The JAX kernel body runs through pl.pallas_call in the TPU interpret mode,
with its wrapper's specs (pallas_trace.py:449-475) and one 128-wide ray
block a grid step, on two scenes with the order tables: the Cornell box
with a sphere (8 clusters, 5 walked) and a row of 24 spheres along z (24
clusters), whose camera rays all hit the first sphere, so the exit fires
there early. The port's plain version of the walk, accel/trace.py
ordered_walk_plain, is held to it on live lanes, and to dense.py bit for
bit on batches the reference does not cover: unnormalized directions,
origins outside the scene box, and ties between clusters visited out of
index order. The CUDA kernel's own tests are in test_torch_kernels.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mitsuba_tpu.accel import dense as jdense
from mitsuba_tpu.accel import pallas_trace as jpt
from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.scene import presets as jpresets
from mitsuba_tpu.scene import shapes as jshapes
from mitsuba_tpu.scene.builder import SceneDesc as JDesc
from mitsuba_tpu.scene.builder import compile_scene as jcompile
from mitsuba_tpu_torch.accel import dense as tdense
from mitsuba_tpu_torch.accel import trace as ttrace
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.scene import presets as tpresets
from mitsuba_tpu_torch.scene import shapes as tshapes
from mitsuba_tpu_torch.scene.builder import SceneDesc as TDesc
from mitsuba_tpu_torch.scene.builder import compile_scene as tcompile
from torch_scenes import tie_scene

torch.set_num_threads(2)

BLOCK = 128
N_RAYS = 512
ROW = 24            # spheres in the row, one 64-triangle cluster each


def _sphere_desc(presets, shapes, tf):
    desc = presets.cornell_box()
    desc.add_shape(shapes.sphere(8, 16), material=0,
                   to_world=tf.translate([0.5, 0.4, 0.5]) @ tf.scale(0.2))
    return desc


def _row_desc(desc_cls, shapes, tf):
    """ROW spheres of radius 0.45 (sphere(4, 8): 64 triangles) at z = 0,
    1, ..., ROW - 1 on the z axis."""
    desc = desc_cls()
    m = desc.add_material(kind="diffuse")
    for i in range(ROW):
        desc.add_shape(shapes.sphere(4, 8), material=m,
                       to_world=tf.translate([0.0, 0.0, float(i)])
                       @ tf.scale(0.45))
    return desc


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _rays(kind, n=N_RAYS, seed=0):
    """(o, d, mint, maxt, live) numpy arrays. "box": origins inside the
    Cornell box, uniform directions; "row": camera rays from (0, 0, -1.5)
    within 8° of +z, each hitting the first sphere. One lane in five is
    dead."""
    rs = np.random.RandomState(seed)
    if kind == "box":
        o = (rs.rand(n, 3) * 0.98 + 0.01).astype(np.float32)
        d = _unit(rs.randn(n, 3))
    else:
        o = np.tile(np.float32([0.0, 0.0, -1.5]), (n, 1))
        d = _unit(np.concatenate([rs.uniform(-0.14, 0.14, (n, 2)),
                                  np.ones((n, 1))], 1))
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.full(n, 1e30, np.float32)
    live = np.arange(n) % 5 != 2
    return o, d, mint, maxt, live


@pytest.fixture(scope="module", params=["box", "row"])
def scenes(request):
    """(kind, JAX scene, port scene) for the Cornell box with a sphere
    and the row of spheres."""
    if request.param == "box":
        jd = _sphere_desc(jpresets, jshapes, jtf)
        td = _sphere_desc(tpresets, tshapes, ttf)
    else:
        jd = _row_desc(JDesc, jshapes, jtf)
        td = _row_desc(TDesc, tshapes, ttf)
    return request.param, jcompile(jd), tcompile(td, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_call(woop_shape, n, any_hit, ordered):
    """_trace_kernel_fused through pallas_call in interpret mode with the
    JAX wrapper's specs, one BLOCK-wide ray block a grid step."""
    kern = functools.partial(jpt._trace_kernel_fused, tc=woop_shape[1] // 3,
                             c_clusters=woop_shape[0], any_hit=any_hit,
                             ordered=ordered)
    col = lambda rows: pl.BlockSpec((rows, BLOCK), lambda r: (0, r),
                                    memory_space=pltpu.VMEM)
    f32 = jax.ShapeDtypeStruct((1, n), jnp.float32)
    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    return jax.jit(pl.pallas_call(
        kern, grid=(n // BLOCK,),
        in_specs=[smem, pl.BlockSpec(woop_shape, lambda r: (0, 0, 0),
                                     memory_space=pltpu.VMEM),
                  smem, smem, smem, smem, smem,
                  col(1), col(4), col(4), col(1), col(1)],
        out_specs=(col(1), col(1), col(1), col(1)),
        out_shape=(f32, jax.ShapeDtypeStruct((1, n), jnp.int32), f32, f32),
        interpret=pltpu.InterpretParams()))


def _jax_trace(jscene, rays, any_hit, ordered):
    """The JAX kernel on numpy rays as pallas_trace.trace feeds it (block
    liveness, lane liveness, the block hint): (t, tri, hit)."""
    o, d, mint, maxt, live = rays
    n = o.shape[0]
    meta = np.asarray(jscene.cluster_meta)
    cen = meta[:, 0:3].astype(np.float32)
    with np.errstate(over="ignore"):
        d2 = ((o[::BLOCK, None, :] - cen[None]) ** 2).sum(-1)
    hint = np.argmin(d2, 1).astype(np.int32)
    ro = np.concatenate([o.T, np.ones((1, n), np.float32)])
    rd = np.concatenate([d.T, np.zeros((1, n), np.float32)])
    call = _jax_call(tuple(jscene.woop_clusters.shape), n, any_hit, ordered)
    t, tri, _, _ = call(
        live.reshape(-1, BLOCK).max(1).astype(np.int32),
        jscene.woop_clusters, jscene.cluster_aabb, jscene.cluster_meta,
        jscene.cluster_order, jscene.cluster_odist, hint,
        live[None].astype(np.float32), ro, rd, mint[None], maxt[None])
    t = np.asarray(t)[0]
    return t, np.asarray(tri)[0], t < 1e30


def _ties(tscene, rays, rtol=1e-5):
    """Live lanes whose two closest valid hits lie within rel `rtol` of
    each other (a ray through a shared edge, or coincident triangles):
    there a walk in another order may report either triangle."""
    o, d, mint, maxt, _ = (torch.as_tensor(x) for x in rays)
    w = tscene.woop_o.view(4, -1, 3)
    op = (o[:, 0, None, None] * w[0] + o[:, 1, None, None] * w[1]
          + o[:, 2, None, None] * w[2] + w[3])
    dp = (d[:, 0, None, None] * w[0] + d[:, 1, None, None] * w[1]
          + d[:, 2, None, None] * w[2])
    ok = dp[..., 2].abs() >= 1e-12
    t = -op[..., 2] / torch.where(ok, dp[..., 2], 1.0)
    u, v = op[..., 0] + t * dp[..., 0], op[..., 1] + t * dp[..., 1]
    ok &= ((torch.minimum(torch.minimum(u, v), 1.0 - u - v) >= -rtol)
           & (t > mint[:, None]) & (t < maxt[:, None]))
    two = torch.where(ok, t, float("inf")).topk(2, 1, largest=False).values
    return (two[:, 1] - two[:, 0] <= rtol * two[:, 0].abs()).numpy()


def _assert_hits_close(ref, got, live, any_hit, ties, rtol=1e-5):
    """The rule of test_torch_trace.py::test_plain_intersect_matches_jax
    on live lanes: hits equal; t within rel `rtol` plus 1e-7; the same
    triangle on every shared hit away from ties (`ties`, _ties)."""
    rt, rtri, rhit = ref
    gt, gtri, ghit = got
    assert np.array_equal(rhit[live], ghit[live])
    if any_hit:
        return
    both = live & rhit
    np.testing.assert_allclose(gt[both], rt[both], rtol=rtol, atol=1e-7)
    away = both & ~ties
    assert np.array_equal(gtri[away], rtri[away])
    assert away.sum() >= 0.98 * both.sum()


# The fused kernel's t is -o'_z times a refined approximate reciprocal of
# d'_z (pallas_trace.py:216-218), which stands up to 1.4e-5 (rel) off the
# division of the JAX dense intersector on these rays; the port divides as
# the dense intersector does. So t is held to the dense intersector at the
# rule's 1e-5, and the kernels' t to each other within this.
FUSED_RTOL = 3e-5


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_plain_matches_jax_ordered_kernel(scenes, any_hit):
    """ordered_walk_plain against the JAX ordered kernel (hits, triangles,
    t) and the JAX dense intersector (t), and the JAX ordered kernel
    against its exhaustive walk, on the live lanes."""
    kind, jscene, tscene = scenes
    assert jscene.cluster_order is not None and ttrace.walks_ordered(tscene)
    rays = _rays(kind)
    ordered = _jax_trace(jscene, rays, any_hit, True)
    exhaustive = _jax_trace(jscene, rays, any_hit, False)
    live = rays[4]
    t, tri, _, _, hit, visits = ttrace.ordered_walk_plain(
        tscene, *(torch.as_tensor(x) for x in rays), any_hit=any_hit)
    got = (t.numpy(), tri.numpy(), hit.numpy())
    assert hit.any() and not hit[~torch.as_tensor(live)].any()
    ties = _ties(tscene, rays)
    _assert_hits_close(ordered, got, live, any_hit, ties, FUSED_RTOL)
    _assert_hits_close(exhaustive, ordered, live, any_hit, ties)
    if not any_hit:
        its = jax.jit(lambda *a: jdense.ray_intersect(jscene, *a))(
            *(jnp.asarray(x) for x in rays[:4]))
        dense_ref = (np.asarray(its.t), np.asarray(its.tri_id),
                     np.asarray(its.valid))
        _assert_hits_close(dense_ref, got, live, False, ties)
        _assert_hits_close(dense_ref, ordered, live, False, ties,
                           FUSED_RTOL)
    assert visits.shape == (N_RAYS // 32,)


def _assert_dense_equal(scene, o, d, mint, maxt, live):
    """ordered_walk_plain bit for bit against dense.intersect_soup on every
    lane (dead ones report a miss in both), closest and any hit; returns
    the closest walk's visits."""
    ref = tdense.intersect_soup(o, d, scene.woop_o, mint, maxt, live)
    out = ttrace.ordered_walk_plain(scene, o, d, mint, maxt, live, False)
    for name, a, b in zip(("t", "tri", "u", "v", "hit"), out, ref):
        assert torch.equal(a, b), name
    any_out = ttrace.ordered_walk_plain(scene, o, d, mint, maxt, live, True)
    assert torch.equal(any_out[4], ref[4])
    n_cl = scene.cluster_order.shape[0]
    assert bool((out[5] <= n_cl).all() and (any_out[5] <= n_cl).all())
    return out[5]


@pytest.fixture(scope="module")
def row_scene():
    return tcompile(_row_desc(TDesc, tshapes, ttf), device="cpu")


@pytest.mark.parametrize("lives", ["holes", "sparse"])
@pytest.mark.parametrize("batch", ["unnormalized", "outside", "finite"])
def test_ordered_plain_equals_dense(row_scene, batch, lives):
    """The exit compares distances (each lane's cap times |d|), so it stays
    conservative for directions of any length, origins outside the scene
    box (a lane whose ray leaves the box before t = 0 holds no walk open)
    and finite segments: the walk's hits are dense.py's, bit for bit, with
    most lanes live ("holes") and with one lane in 8 ("sparse": a warp's
    origin box and reach come from 4 lanes)."""
    rs =np.random.RandomState({"unnormalized": 1, "outside": 2,
                                "finite": 3}[batch])
    n = 480
    o = np.stack([rs.uniform(-1, 1, n), rs.uniform(-1, 1, n),
                  rs.uniform(-1, ROW, n)], 1)
    d = _unit(rs.randn(n, 3))
    maxt = np.full(n, 1e30)
    if batch == "unnormalized":
        d = d * rs.uniform(1e-3, 50.0, (n, 1))
    elif batch == "outside":
        o[:, 0] += np.where(rs.rand(n) < 0.5, -3.0, 3.0)
        d[: n // 2, 0] = -np.sign(o[: n // 2, 0]) * np.abs(d[: n // 2, 0])
    else:
        maxt = rs.uniform(0.05, 3.0, n)
    live = (np.arange(n) % 7 != 3 if lives == "holes"
            else np.arange(n) % 8 == 5)
    args = [torch.as_tensor(np.asarray(x, np.float32))
            for x in (o, d, np.full(n, 1e-4), maxt)]
    visits = _assert_dense_equal(row_scene, *args, torch.as_tensor(live))
    assert bool((visits > 0).all())


@pytest.mark.parametrize("sparse", [False, True], ids=["all", "sparse"])
def test_ordered_plain_ties(sparse):
    """Rays through two or three coincident triangles in two clusters
    report the lowest index (5, 40 or 80) whichever cluster the walk
    visits first: hits replace the best on a smaller (t, index) pair."""
    scene = tie_scene("cpu")
    assert ttrace.walks_ordered(scene)
    rs = np.random.RandomState(4)
    n = 1024
    o = np.stack([rs.uniform(-3.5, 3.5, n), rs.uniform(-1.5, 1.5, n),
                  np.full(n, 2.0)], -1).astype(np.float32)
    d = np.tile(np.float32([0.0, 0.0, -1.0]), (n, 1))
    live = torch.arange(n) % (8 if sparse else 1) == 0
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    _assert_dense_equal(scene, o, d, torch.full((n,), 1e-4),
                        torch.full((n,), 10.0), live)
    t, tri, _, _, hit, _ = ttrace.ordered_walk_plain(
        scene, o, d, torch.full((n,), 1e-4), torch.full((n,), 10.0), live)
    assert set(tri[hit].tolist()) == {5, 40, 80}


def test_exit_fires_on_row_camera_rays(row_scene):
    """On the row of spheres every camera ray hits the first sphere, so
    every warp stops at half the 24 clusters: at the exit test of position
    12, the first of those every EXIT_EVERY = 4 past the 9 positions that
    no hit lies beyond; the visits stay within the table, and the hits are
    dense.py's."""
    o, d, mint, maxt, live = (torch.as_tensor(x) for x in _rays("row"))
    visits = _assert_dense_equal(row_scene, o, d, mint, maxt, live)
    assert ttrace.EXIT_EVERY == 4
    assert bool((visits == ROW // 2).all()), visits


def test_walks_ordered_needs_tables_and_clusters():
    """Cornell (order tables, one walked cluster) keeps the SIMT walk; the
    plain ordered walk refuses it."""
    cornell = tcompile(tpresets.cornell_box(), device="cpu")
    assert cornell.cluster_order is not None
    assert not ttrace.walks_ordered(cornell)
    o = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="not walked in order"):
        ttrace.ordered_walk_plain(cornell, o, o + 1, torch.zeros(4),
                                  torch.ones(4))
