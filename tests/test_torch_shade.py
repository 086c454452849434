"""The port's BSDF families, the fused shade kernel's plain version and
PathTracer(fused_shade=...) against the JAX package on the CPU.

The JAX shade kernel (mitsuba_tpu/accel/shade_kernel.py) is a Pallas TPU
kernel; its body runs here through a pallas_call that this file builds
with the JAX wrapper's block specs and interpret=True. Inputs come from
seeded numpy or from one real bounce of the four-material scene of
tests/test_pallas_tpu.py::test_fused_shade_matches_xla (spheres cut to
sphere(8, 16), 1,024 lanes)."""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import four_materials_desc

from mitsuba_tpu.accel import shade_kernel as jshade
from mitsuba_tpu.bsdf import bsdf as jbsdf
from mitsuba_tpu.core import fresnel as jfresnel
from mitsuba_tpu.core import microfacet as jmf
from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.integrator.path import PathTracer as JPath
from mitsuba_tpu.scene import shapes as jshapes
from mitsuba_tpu.scene.builder import SceneDesc as JDesc
from mitsuba_tpu.scene.builder import compile_scene as jcompile
from mitsuba_tpu_torch.accel import shade_kernel as tshade
from mitsuba_tpu_torch.bsdf import bsdf as tbsdf
from mitsuba_tpu_torch.convert import scene_from_numpy
from mitsuba_tpu_torch.core import fresnel as tfresnel
from mitsuba_tpu_torch.core import microfacet as tmf
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.integrator.path import PathTracer as TPath
from mitsuba_tpu_torch.integrator.path import initial_state
from mitsuba_tpu_torch.scene import shapes as tshapes
from mitsuba_tpu_torch.scene.builder import SceneDesc as TDesc
from mitsuba_tpu_torch.scene.builder import compile_scene as tcompile

torch.set_num_threads(2)

N = 1024             # lanes: one 128-wide block of the JAX kernel
RTOL, ATOL = 1e-5, 1e-6
SEED, MAX_DEPTH, RR_DEPTH = 9, 6, 5


def _compiled(fn, *args):
    """fn jitted for these arguments' shapes, compiled without XLA's LLVM
    optimizations: each JAX reference here runs once or twice, so they
    would cost more time than they save."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _close_sampled(a, b):
    """A sampled quantity: the warps' sin, cos and exp differ by an ulp
    between XLA's and PyTorch's CPU math libraries, and the sampled
    direction carries that into f/pdf. So >= 99% of lanes within rel
    1e-5 / abs 1e-6, and every lane within rel 1e-4 / abs 1e-5."""
    a, b = np.asarray(a), np.asarray(b)
    ok = np.isclose(a, b, rtol=RTOL, atol=ATOL)
    ok = ok.reshape(ok.shape[0], -1).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    _close(a, b, rtol=10 * RTOL, atol=10 * ATOL)


@functools.lru_cache(maxsize=None)
def _both(two_sided=False):
    """The four-material scene at sphere(8, 16), compiled by the JAX
    package and by the port."""
    return tuple(comp(four_materials_desc(desc, tf, shapes, (8, 16),
                                          two_sided), **kw)
                 for comp, desc, tf, shapes, kw in (
                     (jcompile, JDesc, jtf, jshapes, {}),
                     (tcompile, TDesc, ttf, tshapes, {"device": "cpu"})))


@pytest.fixture(scope="module")
def scenes():
    return _both()


def _rays(seed=5):
    """The JAX parity test's rays: from (0, 1, 6) along (0, -0.1, -1),
    spread."""
    rs = np.random.RandomState(seed)
    o = np.tile(np.float32([[0.0, 1.0, 6.0]]), (N, 1))
    d = rs.randn(N, 3) * [0.5, 0.4, 0.2] + [0, -0.1, -1.0]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _dirs(rs, n, upper=False):
    d = rs.randn(n, 3)
    if upper:
        d[:, 2] = np.abs(d[:, 2])
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# core: fresnel and microfacet
# ---------------------------------------------------------------------------

def test_fresnel_matches_jax():
    rs = np.random.RandomState(0)
    cos = rs.uniform(-1, 1, 512).astype(np.float32)
    eta = rs.uniform(0.5, 2.5, 512).astype(np.float32)
    e = rs.uniform(0.1, 3, (512, 3)).astype(np.float32)
    k = rs.uniform(0, 5, (512, 3)).astype(np.float32)
    jout = jax.jit(lambda c, h, e_, k_: (
        *jfresnel.fresnel_dielectric(c, h),
        jfresnel.fresnel_conductor_exact(c, e_, k_)))(cos, eta, e, k)
    tout = (*tfresnel.fresnel_dielectric(torch.as_tensor(cos),
                                         torch.as_tensor(eta)),
            tfresnel.fresnel_conductor_exact(*map(torch.as_tensor,
                                                  (cos, e, k))))
    for t, j in zip(tout, jout):
        _close(t, j)


_MF = (("eval_d", (2, 4, 5, 6)), ("smith_g1", (0, 2, 4, 5, 6)),
       ("smith_g", (0, 1, 2, 4, 5, 6)), ("pdf_visible", (0, 2, 4, 5, 6)),
       ("sample_all", (3, 4, 5, 6)), ("pdf_all", (2, 4, 5, 6)),
       ("sample_visible", (0, 3, 4, 5, 6)))


@pytest.mark.parametrize("dist", [jmf.BECKMANN, jmf.GGX])
def test_microfacet_matches_jax(dist):
    """Both distributions, anisotropic roughness, wi on both sides."""
    rs = np.random.RandomState(1 + dist)
    n = 512
    wi, wo = _dirs(rs, n), _dirs(rs, n, upper=True)
    m = _dirs(rs, n, upper=True)
    u = rs.rand(n, 2).astype(np.float32)
    au = rs.uniform(0.05, 0.8, n).astype(np.float32)
    av = rs.uniform(0.05, 0.8, n).astype(np.float32)
    dt = np.full(n, dist, np.int32)
    args = (wi, wo, m, u, au, av, dt)
    J = [jnp.asarray(x) for x in args]
    T = [torch.as_tensor(x) for x in args]
    for name, idx in _MF:
        t = getattr(tmf, name)(*(T[i] for i in idx))
        j = getattr(jmf, name)(*(J[i] for i in idx))
        if name.startswith("sample"):
            _close_sampled(t, j)
        else:
            _close(t, j)


# ---------------------------------------------------------------------------
# bsdf: the three new families, with and without the two-sided adapter
# ---------------------------------------------------------------------------

_KINDS = {
    "conductor": dict(kind="conductor"),
    "roughconductor": dict(kind="roughconductor", alpha=0.3, alpha_v=0.15),
    "roughconductor-beckmann": dict(kind="roughconductor", alpha=0.25,
                                    distribution="beckmann"),
    "dielectric": dict(kind="dielectric", int_ior=1.5),
}


@pytest.mark.parametrize("two_sided", [False, True])
@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_bsdf_matches_jax(kind, two_sided):
    """eval/pdf/sample_bsdf_ex on one material row per lane, wi on both
    sides of the surface."""
    from mitsuba_tpu.scene.builder import Material as JMat
    from mitsuba_tpu_torch.scene.builder import Material as TMat
    code, row, _ = TMat(**_KINDS[kind], two_sided=two_sided).compile()
    assert np.array_equal(row, JMat(**_KINDS[kind],
                                    two_sided=two_sided).compile()[1])
    rs = np.random.RandomState(len(kind) + two_sided)
    n = 512
    wi, wo = _dirs(rs, n), _dirs(rs, n)
    u2 = rs.rand(n, 2).astype(np.float32)
    u1 = rs.rand(n).astype(np.float32)
    params = np.tile(row, (n, 1))
    mt = np.full(n, code, np.int32)
    fams = (code,)
    jm = jbsdf.MatInfo(jnp.asarray(mt), jnp.asarray(params), jnp.asarray(mt),
                       jnp.asarray(params), jnp.asarray(mt),
                       jnp.asarray(params), jnp.ones(n))
    tm = tbsdf.MatInfo(*(torch.as_tensor(mt).long(),
                         torch.as_tensor(params)) * 3, torch.ones(n))
    J = [jnp.asarray(x) for x in (wi, wo, u2, u1)]
    T = [torch.as_tensor(x) for x in (wi, wo, u2, u1)]
    _close(tbsdf.eval_bsdf_ex(tm, T[0], T[1], fams),
           jbsdf.eval_bsdf_ex(jm, J[0], J[1], fams))
    _close(tbsdf.pdf_bsdf_ex(tm, T[0], T[1], fams),
           jbsdf.pdf_bsdf_ex(jm, J[0], J[1], fams))
    ts = tbsdf.sample_bsdf_ex(tm, T[0], T[2], T[3], fams)
    js = jbsdf.sample_bsdf_ex(jm, J[0], J[2], J[3], fams)
    for name in ("wo", "weight", "pdf", "eta"):
        _close_sampled(getattr(ts, name), getattr(js, name))
    assert np.array_equal(ts.is_delta.numpy(), np.asarray(js.is_delta))
    assert (ts.weight != 0).any()


def test_compile_rows_match_jax(scenes):
    """Material rows and type codes equal the JAX builder's, every kind
    and option; the compiled JAX scene carries across."""
    from mitsuba_tpu.scene.builder import Material as JMat
    from mitsuba_tpu_torch.scene.builder import Material as TMat
    opts = [dict(kind="diffuse", two_sided=True),
            dict(kind="conductor", eta=1.3, specular_reflectance=(.9,) * 3),
            dict(kind="roughconductor", alpha=0.2, alpha_v=0.4,
                 distribution="beckmann", two_sided=True),
            dict(kind="dielectric", int_ior=1.33, ext_ior=1.1,
                 specular_transmittance=(0.5, 0.6, 0.7))]
    for o in opts:
        tc, tp, tt = TMat(**o).compile()
        jc, jp, jt = JMat(**o).compile()
        assert tc == jc and np.array_equal(tp, jp) and np.array_equal(tt, jt)
    jscene, tscene = scenes
    for name in ("mat_type", "mat_params", "cluster_aabb", "tri_attr"):
        assert np.array_equal(getattr(tscene, name).numpy(),
                              np.asarray(getattr(jscene, name))), name
    # the JAX Woop table may come from its native 3x3 inverse
    # (tests/test_torch_scene.py WOOP_FIELDS)
    _close(tscene.woop_clusters, jscene.woop_clusters)
    arrays = {k: (None if v is None else
                  {f: np.asarray(x) for f, x in zip(v._fields, v)}
                  if k == "em_pmf" else np.asarray(v))
              for k, v in zip(jscene._fields, jscene)}
    assert torch.equal(scene_from_numpy(arrays, device="cpu").mat_params,
                       tscene.mat_params)


# ---------------------------------------------------------------------------
# the fused shade kernel's plain version against the JAX kernel body
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_kernel_call(woop_shape, k_in, n, families=(0, 1, 2, 3)):
    """make_shade_kernel's body through pallas_call in interpret mode, one
    128-wide block over n lanes, with the JAX wrapper's specs
    (shade_kernel.py:250-268), dispatching `families`; compiled once, the
    bounce index is data."""
    np8, block = n // 8, n // 8
    kern = jshade.make_shade_kernel(woop_shape[1] // 3, woop_shape[0],
                                    families, RR_DEPTH, MAX_DEPTH)
    col = lambda rows: pl.BlockSpec((rows, block), lambda r: (0, r),
                                    memory_space=pltpu.VMEM)
    call = pl.pallas_call(
        kern, grid=(1,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(woop_shape, lambda r: (0, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.SMEM),
                  col(k_in * 8), col(8), col(8),
                  pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=col(jshade.K_OUT * 8),
        out_shape=jax.ShapeDtypeStruct((jshade.K_OUT * 8, np8), jnp.float32),
        interpret=True)
    spec = jax.ShapeDtypeStruct
    return _compiled(call, spec((1,), jnp.int32),
                     spec(woop_shape, jnp.float32),
                     spec((woop_shape[0], 8), jnp.float32),
                     spec((k_in * 8, np8), jnp.float32),
                     spec((8, np8), jnp.int32), spec((8, np8), jnp.int32),
                     spec((4,), jnp.int32))


def _jax_kernel(jscene, packed, pix, samp, bounce, families=(0, 1, 2, 3)):
    """The JAX kernel body on [K_IN, N] rows, packed as its wrapper packs
    them ([K, N] → [K*8, N/8]) and unpacked back to [K_OUT, N]."""
    k_in, n = packed.shape
    np8 = n // 8
    call = _jax_kernel_call(tuple(jscene.woop_clusters.shape), k_in, n,
                            tuple(families))
    as8 = lambda x: jnp.asarray(x.reshape(-1, 8, np8).reshape(-1, np8))
    meta = jnp.asarray([SEED, 0, bounce, 0], jnp.int32)
    live = jnp.asarray([int(packed[tshade.I_ACT].max() > 0.5)], jnp.int32)
    out = call(live, jscene.woop_clusters, jscene.cluster_aabb, as8(packed),
               as8(pix), as8(samp), meta)
    return np.asarray(out).reshape(jshade.K_OUT, 8, np8).reshape(
        jshade.K_OUT, n)


@functools.lru_cache(maxsize=None)
def _bounce_inputs(two_sided):
    """bounce -> the packed kernel input of the port's eager pass at that
    bounce, with pixel and sample ids."""
    tscene = _both(two_sided)[1]
    o, d = _rays()
    tracer = TPath(max_depth=MAX_DEPTH, rr_depth=RR_DEPTH).specialized_for(
        tscene)
    pix = torch.arange(N, dtype=torch.int32) * 3 + 1
    samp = torch.full((N,), 2, dtype=torch.int32)
    state, out = initial_state(torch.as_tensor(o), torch.as_tensor(d)), {}
    for b in range(4):
        out[b] = tracer.shade_inputs(tscene, state, SEED, pix, samp, b)
        state = tracer.bounce(tscene, state, SEED, pix, samp, b)[0]
    return out, pix, samp


@pytest.mark.parametrize("two_sided,bounce", [(False, 0), (False, 3),
                                              (True, 1), (True, 2)],
                         ids=["0", "3", "two_sided-1", "two_sided-2"])
def test_shade_plain_matches_jax_kernel(two_sided, bounce):
    """shade_plain against the JAX kernel body on the same packed rows:
    every row within rel 1e-5 / abs 1e-6 on >= 99.9% of the lanes active
    on entry, alive and prev_delta equal on >= 99.9% of them, and L equal
    within the same tolerance on every lane (the JAX kernel's other rows
    of a dead lane depend on its block). With every material two-sided,
    the rays inside the glass sphere meet it from behind and take the
    adapter's flip."""
    jscene, tscene = _both(two_sided)
    packs, pix, samp = _bounce_inputs(two_sided)
    packed = packs[bounce]
    act = packed[tshade.I_ACT].numpy() > 0.5
    assert act.sum() > 64
    hit = packed[tshade.I_HIT].numpy() > 0.5
    flipped = (tshade._front(packed, bounce, MAX_DEPTH).fsign < 0).numpy()
    assert (flipped[hit].sum() > 16) == two_sided, flipped[hit].sum()
    t = tshade.shade_plain(tscene, packed, pix, samp, SEED, bounce, RR_DEPTH,
                           MAX_DEPTH).numpy()
    j = _jax_kernel(jscene, packed.numpy(), pix.numpy(), samp.numpy(),
                    bounce)
    ok = np.isclose(t, j, rtol=RTOL, atol=ATOL)
    assert ok[:, act].all(0).mean() >= 0.999, ok[:, act].mean(1)
    for row in (12, 14):
        assert (t[row, act] == j[row, act]).mean() >= 0.999, row
    assert ok[9:12].all()
    traced = tshade.shadow_rays(packed, bounce, MAX_DEPTH)[4]
    assert traced.any() and not traced[~torch.as_tensor(act)].any()


# ---------------------------------------------------------------------------
# PathTracer(fused_shade=...)
# ---------------------------------------------------------------------------

def _image_rule(img, ref):
    """tests/test_render.py:44-48: < 1% of values off by rel > 5e-2, and
    the means within rel 5e-3."""
    rel = np.abs(img - ref) / np.maximum(ref, 1e-3)
    assert (rel > 5e-2).mean() < 1e-2, ((rel > 5e-2).mean(), img.mean())
    assert np.abs(img.mean() - ref.mean()) / ref.mean() < 5e-3


def _li(tscene, fused):
    o, d = _rays()
    L, n = TPath(max_depth=MAX_DEPTH, fused_shade=fused).li_stats(
        tscene, torch.as_tensor(o), torch.as_tensor(d), SEED,
        torch.arange(N), 0)
    return L.numpy(), int(n)


def test_li_stats_off_matches_jax(scenes):
    """The eager port against the JAX XLA PathTracer on the same rays,
    pixel ids and seed."""
    jscene, tscene = scenes
    o, d = _rays()
    jint = JPath(max_depth=MAX_DEPTH, accel="dense").specialized_for(jscene)
    args = (jscene, jnp.asarray(o), jnp.asarray(d), jnp.uint32(SEED),
            jnp.arange(N, dtype=jnp.uint32), jnp.uint32(0))
    jL, jn = _compiled(jint.li_stats, *args)(*args)
    tL, tn = _li(tscene, "off")
    assert np.isfinite(tL).all() and tL.mean() > 0.1
    _image_rule(tL, np.asarray(jL))
    assert abs(tn - int(jn)) <= 1e-4 * int(jn), (tn, int(jn))


def test_fused_on_matches_off(scenes):
    """The fused tail (shade_plain on the CPU) against the eager tail,
    under the JAX test's own tolerance (test_pallas_tpu.py:196-201), with
    ray counts within rel 1e-4."""
    _, tscene = scenes
    l_off, n_off = _li(tscene, "off")
    tshade.reset_launches()
    l_on, n_on = _li(tscene, "on")
    assert tshade.LAUNCHES["shade"] == 0        # CPU tensors: plain version
    close = np.isclose(l_on, l_off, rtol=2e-3, atol=2e-4).all(-1)
    assert close.mean() > 0.995, close.mean()
    assert np.allclose(l_on.mean(0), l_off.mean(0), rtol=2e-3, atol=1e-4)
    assert abs(n_on - n_off) <= 1e-4 * n_off, (n_on, n_off)
    # "auto" leaves CPU tensors on the eager tail
    assert TPath(fused_shade="auto").specialized_for(tscene).fused_shade \
        == "off"


def test_fused_on_rejects_unsupported():
    """A Beckmann or anisotropic rough conductor, rough plastic (whose
    transmittance rows the kernel's input lacks) or a composite is turned
    away instead of shaded wrong."""
    beck, aniso = (tcompile(four_materials_desc(TDesc, ttf, tshapes, (2, 4),
                                                ggx=ggx), device="cpu")
                   for ggx in (dict(distribution="beckmann"),
                               dict(alpha_v=0.1)))
    rough_plastic = beck._replace(mat_type=beck.mat_type.clone().fill_(6))
    mixture = beck._replace(mat_type=beck.mat_type.clone().fill_(13))
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(4, 3)
    for scene, reason in ((beck, "Beckmann"), (aniso, "anisotropic"),
                          (rough_plastic, "rough plastic"),
                          (mixture, "composite BSDF families [13]")):
        assert not tshade.supports(scene)[0]
        with pytest.raises(NotImplementedError, match=re.escape(reason)):
            TPath(fused_shade="on").li(scene, o, d, 0, torch.arange(4))
        assert TPath(fused_shade="auto").specialized_for(
            scene, "cuda").fused_shade == "off"
