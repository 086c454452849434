"""Config 4, the differentiable mode, in the port against the JAX package
on the CPU: bsdf.resolve_params, path-replay backprop
(integrator/prb.py) against the JAX PRBPathTracer on the Cornell box and
on the four-material scene (conductor, GGX rough conductor, dielectric),
against the port's own reverse-mode autograd through PathTracer.li and
against central finite differences; autograd through render_fn against
central finite differences; hide_emitters against the JAX PathTracer;
prb.supports, and the reference's replay on a normal-mapped scene, where
it does not reproduce its forward pass; the kernel wrappers' grad guard
and the fused-shade rule.

Inputs come from numpy seeds at 16×16; JAX scenes are carried across
with convert.scene_from_numpy. The JAX references compile once, in three
module-scoped jits specialised to their scenes' families."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import four_materials_desc, texenv_desc
from mitsuba_tpu.bsdf import bsdf as jbsdf
from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.integrator.path import PathTracer as JPath
from mitsuba_tpu.integrator.prb import PRBPathTracer as JPRB
from mitsuba_tpu.scene import builder as jb
from mitsuba_tpu.scene import presets as jpresets
from mitsuba_tpu.scene import shapes as jshapes
from mitsuba_tpu.texture import texture as jtex
from mitsuba_tpu_torch.accel import trace as ttrace
from mitsuba_tpu_torch.bsdf import bsdf as tbsdf
from mitsuba_tpu_torch.convert import scene_from_numpy
from mitsuba_tpu_torch.film.film import Film
from mitsuba_tpu_torch.integrator import prb as tprb
from mitsuba_tpu_torch.integrator.direct import DirectIntegrator
from mitsuba_tpu_torch.integrator.mega import MegaPathTracer
from mitsuba_tpu_torch.integrator.path import PathTracer as TPath
from mitsuba_tpu_torch.render import render_fn
from mitsuba_tpu_torch.scene import presets as tpresets

torch.set_num_threads(2)

RES = 16
N = RES * RES
DEPTH = 3           # the Cornell replays (tests/test_prb.py's depth)
FOUR_DEPTH = 4      # through the glass sphere and out


def _carry(jscene):
    """The compiled JAX scene on the port's side (CPU)."""
    arrays = {k: (None if v is None else np.asarray(v))
              for k, v in jscene._asdict().items() if k != "em_pmf"}
    arrays["em_pmf"] = {k: np.asarray(v)
                        for k, v in jscene.em_pmf._asdict().items()}
    return scene_from_numpy(arrays, device="cpu")


def _cornell_rays(seed=0):
    """One jittered camera ray per pixel of the 16² Cornell film (pixel
    centres would put two rays exactly on triangle edges, where the two
    packages' intersectors part ways)."""
    rs = np.random.RandomState(seed)
    pos = (np.stack(np.meshgrid(np.arange(RES), np.arange(RES)), -1)
           .reshape(-1, 2) + rs.rand(N, 2)).astype(np.float32)
    o, d = jpresets.cornell_camera(RES, RES).sample_ray(jnp.asarray(pos))
    return np.array(o), np.array(d)


def _four_rays(seed=5):
    """tests/test_pallas_tpu.py:185-191's rays: from (0, 1, 6) toward the
    spheres and the cube."""
    rs = np.random.RandomState(seed)
    o = np.tile(np.float32([[0.0, 1.0, 6.0]]), (N, 1))
    d = rs.randn(N, 3) * [0.5, 0.4, 0.2] + [0, -0.1, -1.0]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _normal_mapped_cornell():
    """The Cornell box whose white walls and boxes carry a smooth normal
    map (from a numpy seed), through the JAX builder."""
    rs = np.random.RandomState(7)
    y, x = np.mgrid[0:32, 0:32] / 32.0
    ph = rs.rand(2) * 2 * np.pi
    n = np.stack([-0.5 * np.cos(6 * np.pi * x + ph[0]),
                  -0.5 * np.cos(4 * np.pi * y + ph[1]), np.ones_like(x)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    desc = jpresets.cornell_box()
    tex = desc.add_texture((0.5 * n + 0.5).astype(np.float32))
    desc.materials[0] = dataclasses.replace(desc.materials[0],
                                            normal_texture=tex)
    return desc


def _prb(prb, scene, o, d, px):
    """A JAX PRB replay as a function of dL."""
    return lambda dL: prb.li_and_grad(scene, jnp.asarray(o), jnp.asarray(d),
                                      jnp.uint32(0), jnp.asarray(px), 0, dL)


@pytest.fixture(scope="module")
def cornell():
    """The JAX Cornell box and its carried copy, the rays, and one jit of
    the JAX PRB (max_depth 3) with PathTracer(hide_emitters=True).li."""
    jscene = jb.compile_scene(jpresets.cornell_box())
    o, d = _cornell_rays()
    px = np.arange(N, dtype=np.uint32)
    prb = _prb(JPRB(max_depth=DEPTH).specialized_for(jscene), jscene, o, d,
               px)
    hide = JPath(max_depth=DEPTH, hide_emitters=True).specialized_for(jscene)
    fn = jax.jit(lambda dL: (prb(dL), hide.li(
        jscene, jnp.asarray(o), jnp.asarray(d), jnp.uint32(0),
        jnp.asarray(px), 0)))
    return jscene, _carry(jscene), o, d, px, fn


@pytest.fixture(scope="module")
def four():
    """The four-material scene (JAX, carried), its rays, and one jit of
    the JAX PRB (max_depth 4)."""
    jscene = jb.compile_scene(four_materials_desc(jb.SceneDesc, jtf,
                                                  jshapes, (8, 16)))
    o, d = _four_rays()
    px = np.arange(N, dtype=np.uint32)
    fn = jax.jit(_prb(JPRB(max_depth=FOUR_DEPTH).specialized_for(jscene),
                      jscene, o, d, px))
    return jscene, _carry(jscene), o, d, px, fn


def _dL(seed=1):
    return (np.random.RandomState(seed).rand(N, 3) / (N * 3)).astype(
        np.float32)


def _port_prb(scene, o, d, px, dL, depth, **kw):
    return tprb.PRBPathTracer(max_depth=depth, **kw).li_and_grad(
        scene, torch.as_tensor(o), torch.as_tensor(d), 0,
        torch.as_tensor(px.astype(np.int64)), 0, torch.as_tensor(dL))


def _lane_parity(t, j):
    """tests/test_torch_path.py:65-77's rule: >= 99% of lanes within rel
    1e-3."""
    rel = np.abs(t - j).max(-1) / np.maximum(np.abs(j).max(-1), 1e-3)
    assert (rel <= 1e-3).mean() >= 0.99, (rel > 1e-3).mean()


def _grad_rule(t, j, name):
    """|Δ| <= 2e-3·|g_jax| + 2e-4·max|g_jax| on every entry."""
    t, j = np.asarray(t), np.asarray(j)
    assert np.isfinite(t).all(), name
    lim = 2e-3 * np.abs(j) + 2e-4 * np.abs(j).max()
    bad = np.argwhere(np.abs(t - j) > lim)
    assert bad.size == 0, (name, [(tuple(i), t[tuple(i)], j[tuple(i)])
                                  for i in bad[:8]])


@pytest.mark.parametrize("scene_name", ["cornell", "four"])
def test_prb_matches_jax(scene_name, request):
    """The port's li_and_grad against the JAX one on the same rays,
    pixel ids and seeded dL: L by the lane-parity rule, both gradient
    tables entry by entry; on the four-material scene this covers the
    conductor's delta lobe, the dielectric and the GGX roughness."""
    jscene, tscene, o, d, px, fn = request.getfixturevalue(scene_name)
    dL = _dL()
    out = fn(jnp.asarray(dL))
    jL, jg = out[0] if scene_name == "cornell" else out
    depth = DEPTH if scene_name == "cornell" else FOUR_DEPTH
    tL, tg = _port_prb(tscene, o, d, px, dL, depth)
    _lane_parity(tL.numpy(), np.asarray(jL))
    for key in ("mat_params", "em_radiance"):
        _grad_rule(tg[key].numpy(), jg[key], key)
        err = np.abs(tg[key].numpy() - jg[key]).max()
        print(f"{scene_name} {key}: max |Δ| / max |g_jax| "
              f"{err / np.abs(jg[key]).max():.3g}")
    assert np.abs(np.asarray(jg["mat_params"])).max() > 0
    if scene_name == "four":    # the GGX rough conductor's α (row 1)
        assert np.abs(tg["mat_params"][1, 9].item()) > 0


def _naive(scene, o, d, px, depth, **kw):
    """Reverse-mode autograd of mean(li) through the port's PathTracer."""
    mat = scene.mat_params.clone().requires_grad_()
    em = scene.em_radiance.clone().requires_grad_()
    sc = scene._replace(mat_params=mat, em_radiance=em)
    L = TPath(max_depth=depth, **kw).li(
        sc, torch.as_tensor(o), torch.as_tensor(d), 0,
        torch.as_tensor(px.astype(np.int64)), 0)
    L.mean().backward()
    return L.detach(), mat.grad, em.grad


def _prb_rule(g, g_ad):
    """tests/test_prb.py:61-69's rule."""
    g, g_ad = g.numpy(), g_ad.numpy()
    assert np.isfinite(g).all() and np.isfinite(g_ad).all()
    np.testing.assert_allclose(g, g_ad, rtol=2e-2,
                               atol=2e-4 * max(np.abs(g_ad).max(), 1))


@pytest.mark.parametrize("depth", [2, 3])
def test_prb_matches_naive_autograd(cornell, depth):
    """The port's PRB against the port's own reverse-mode autograd
    through PathTracer.li (tests/test_prb.py:38-69): the forward values
    agree, and both gradient tables by test_prb's rule."""
    _, scene, o, d, px, _ = cornell
    L_ad, g_mat, g_em = _naive(scene, o, d, px, depth)
    L, grads = _port_prb(scene, o, d, px, np.full((N, 3), 1.0 / (N * 3),
                                                 np.float32), depth)
    np.testing.assert_allclose(L.numpy(), L_ad.numpy(), rtol=1e-5,
                               atol=1e-6)
    _prb_rule(grads["mat_params"], g_mat)
    _prb_rule(grads["em_radiance"], g_em)
    assert g_mat[:, 0:3].abs().max() > 0 and g_em.abs().max() > 0


def test_prb_gradcheck_fd(cornell):
    """PRB against central finite differences of mean(li) on the white
    albedo's R (tests/test_prb.py:71-94)."""
    _, scene, o, d, px, _ = cornell
    tracer = TPath(max_depth=DEPTH)

    def loss_at(mat):
        return tracer.li(scene._replace(mat_params=mat), torch.as_tensor(o),
                         torch.as_tensor(d), 0,
                         torch.as_tensor(px.astype(np.int64)),
                         0).mean().item()

    _, grads = _port_prb(scene, o, d, px, np.full((N, 3), 1.0 / (N * 3),
                                                 np.float32), DEPTH)
    eps = 1e-3
    delta = torch.zeros_like(scene.mat_params)
    delta[0, 0] = eps
    fd = (loss_at(scene.mat_params + delta)
          - loss_at(scene.mat_params - delta)) / (2 * eps)
    ad = grads["mat_params"][0, 0].item()
    assert abs(ad - fd) <= 2e-2 * max(abs(fd), 1e-3) + 2e-4, (ad, fd)


def _render_loss(scene, mat, em):
    sc = scene._replace(mat_params=mat, em_radiance=em)
    img, _ = render_fn(sc, tpresets.cornell_camera(RES, RES),
                       Film(RES, RES, "box"), TPath(max_depth=DEPTH), 4,
                       seed=0, device="cpu")
    return img.mean()


def _render_grads(scene):
    mat = scene.mat_params.clone().requires_grad_()
    em = scene.em_radiance.clone().requires_grad_()
    _render_loss(scene, mat, em).backward()
    return mat.grad, em.grad


def test_render_gradcheck_fd(cornell):
    """loss.backward() through render_fn (film.splat's accumulating
    index_put_ included) against central finite differences on test_grad's
    three entries: the white and red albedos' R and the light's G, with
    tests/test_grad.py:35-74's rule; every gradient is finite."""
    _, scene, *_ = cornell
    g_mat, g_em = _render_grads(scene)
    assert torch.isfinite(g_mat).all() and torch.isfinite(g_em).all()
    eps = 1e-3
    for table, idx in (("mat", (0, 0)), ("mat", (1, 0)), ("em", (0, 1))):
        base = scene.mat_params if table == "mat" else scene.em_radiance
        delta = torch.zeros_like(base)
        delta[idx] = eps
        with torch.no_grad():
            if table == "mat":
                lp = _render_loss(scene, base + delta, scene.em_radiance)
                lm = _render_loss(scene, base - delta, scene.em_radiance)
            else:
                lp = _render_loss(scene, scene.mat_params, base + delta)
                lm = _render_loss(scene, scene.mat_params, base - delta)
        fd = (lp.item() - lm.item()) / (2 * eps)
        ad = (g_mat if table == "mat" else g_em)[idx].item()
        assert abs(ad - fd) <= 1.5e-2 * max(abs(fd), 1e-3) + 2e-4, (
            table, idx, ad, fd)
        assert abs(fd) > 0, (table, idx)


def test_render_grad_deterministic(cornell):
    """Two backward passes through render_fn give equal gradients
    (tests/test_grad.py:76-83; on the CPU the scatter-adds run in
    order)."""
    _, scene, *_ = cornell
    a, b = _render_grads(scene), _render_grads(scene)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_hide_emitters_matches_jax(cornell):
    """PathTracer(hide_emitters=True).li against the JAX one by the
    lane-parity rule; the lanes whose camera ray hits the light lose its
    emission. DirectIntegrator and the megakernels have no such field
    (nor have the JAX ones, which ignore it): they refuse it."""
    jscene, tscene, o, d, px, fn = cornell
    jL = np.asarray(fn(jnp.asarray(_dL()))[1])
    args = (tscene, torch.as_tensor(o), torch.as_tensor(d), 0,
            torch.as_tensor(px.astype(np.int64)), 0)
    tL = TPath(max_depth=DEPTH, hide_emitters=True).li(*args).numpy()
    _lane_parity(tL, jL)
    shown = TPath(max_depth=DEPTH).li(*args).numpy()
    assert (tL <= shown + 1e-6).all()
    assert (shown - tL).max() > 1.0     # a lane that sees the light
    for cls in (DirectIntegrator, MegaPathTracer):    # no such field
        with pytest.raises(ValueError, match="hide_emitters"):
            cls(hide_emitters=True)


def test_resolve_params_matches_jax():
    """resolve_params with albedo and roughness textures (the texenv
    scene's materials) at 4,096 seeded material ids and uvs, against the
    JAX resolve_params: the codes exactly, the rows within rel 1e-6."""
    j = jb.compile_scene(texenv_desc(jb, jtf, jshapes, jtex, sky=(8, 16)))
    t = _carry(j)
    rs = np.random.RandomState(4)
    mid = rs.randint(-1, int(t.mat_type.shape[0]), 4096)
    uv = rs.uniform(-0.5, 1.5, (4096, 2)).astype(np.float32)
    jt, jp = jbsdf.resolve_params(j, jnp.asarray(mid, jnp.int32),
                                  jnp.asarray(uv))
    tt, tp = tbsdf.resolve_params(t, torch.as_tensor(mid),
                                  torch.as_tensor(uv))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    assert tp[mid == 0, 0].std() > 0.05         # the albedo texture
    assert tp[mid == 1, 9].std() > 0.05         # the roughness texture


@pytest.fixture(scope="module")
def normal_mapped():
    """The normal-mapped Cornell box, and one jit of the JAX PRB on it."""
    jscene = jb.compile_scene(_normal_mapped_cornell())
    o, d = _cornell_rays()
    px = np.arange(N, dtype=np.uint32)
    fn = jax.jit(_prb(JPRB(max_depth=DEPTH).specialized_for(jscene),
                      jscene, o, d, px))
    return jscene, fn


def _replay_gap(jscene, fn):
    """Forward L against the replay's Σ_k T_k c_k, summed over lanes and
    channels. With dL = 1 and area lights only, every c_k is linear in
    the radiance, so Σ_e radiance_e · ∂/∂radiance_e is Σ_k T_k c_k."""
    L, g = fn(jnp.ones((N, 3), jnp.float32))
    total = float(np.asarray(L, np.float64).sum())
    replay = float((np.asarray(jscene.em_radiance, np.float64)
                    * np.asarray(g["em_radiance"], np.float64)).sum())
    return abs(total - replay) / total


def test_reference_replay_misses_normal_maps(cornell, normal_mapped):
    """The JAX replay shades in Frame.from_normal(ns) where its forward
    pass takes the normal-mapped frame, so on the normal-mapped Cornell
    box its Σ_k T_k c_k is not its own forward L, while on the plain box
    the two agree (the fault of the reference that prb.supports turns
    away)."""
    assert _replay_gap(cornell[0], lambda dL: cornell[5](dL)[0]) < 1e-4
    assert _replay_gap(*normal_mapped) > 1e-2


def test_supports_refuses(normal_mapped):
    """prb.supports turns away a composite BSDF and a normal map, with
    reasons, and li_and_grad raises NotImplementedError there; the plain
    Cornell box is supported."""
    comp = jpresets.cornell_box()
    comp.add_material(kind="mixturebsdf", child_a=0, child_b=1, weight=0.5)
    comp.shapes[5] = dataclasses.replace(comp.shapes[5], material=3)
    scenes = {"composite": _carry(jb.compile_scene(comp)),
              "normal or bump map": _carry(normal_mapped[0])}
    o, d = _cornell_rays()
    px = np.arange(N, dtype=np.uint32)
    for reason, scene in scenes.items():
        ok, why = tprb.supports(scene)
        assert not ok and reason in why, why
        with pytest.raises(NotImplementedError, match=reason):
            _port_prb(scene, o, d, px, _dL(), DEPTH)
    assert tprb.supports(_carry(jb.compile_scene(
        jpresets.cornell_box()))) == (True, "")


# ---- the kernels have no backward ------------------------------------------

def test_kernel_wrappers_refuse_grad():
    """check_tensor, which every kernel wrapper calls before a launch,
    refuses an input that requires grad under grad mode and takes it
    under torch.no_grad()."""
    x = torch.zeros(8, 3, requires_grad=True)
    args = ("o", torch.float32, (8, 3), torch.device("cpu"))
    with pytest.raises(ValueError, match="no backward"):
        ttrace.check_tensor(x, *args)
    with torch.no_grad():
        ttrace.check_tensor(x, *args)
    ttrace.check_tensor(x.detach(), *args)


def test_fused_shade_refuses_param_grad(cornell):
    """fused_shade="on" raises while a parameter table requires grad
    under grad mode, on the CPU too; under torch.no_grad() it renders;
    "auto" settles to "off" on CUDA tensors while a gradient is recorded
    and to "on" otherwise."""
    _, scene, o, d, px, _ = cornell
    sc = scene._replace(mat_params=scene.mat_params.clone()
                        .requires_grad_())
    args = (torch.as_tensor(o), torch.as_tensor(d), 0,
            torch.as_tensor(px.astype(np.int64)), 0)
    with pytest.raises(NotImplementedError, match="no backward"):
        TPath(max_depth=2, fused_shade="on").li(sc, *args)
    with torch.no_grad():
        assert torch.isfinite(
            TPath(max_depth=2, fused_shade="on").li(sc, *args)).all()
    auto = TPath(fused_shade="auto")
    assert auto.specialized_for(sc, "cuda").fused_shade == "off"
    assert auto.specialized_for(scene, "cuda").fused_shade == "on"
    with torch.no_grad():
        assert auto.specialized_for(sc, "cuda").fused_shade == "on"


def test_trace_inputs_need_no_grad(cornell, four):
    """On the Cornell box (diffuse only) no ray depends on a parameter:
    every trace of the autograd pass gets inputs that need no gradient,
    so on the card the kernel takes them; on the four-material scene
    (GGX sampling, refraction) the rays carry the gradient and the plain
    intersector differentiates through them. (There some GGX α and the
    glass's η entries come out NaN: test_naive_grad_nan_as_reference.)"""
    seen = []

    class Spy(TPath):
        def _intersect(self, scene, o, d, mint, live):
            seen.append(o.requires_grad or d.requires_grad)
            return super()._intersect(scene, o, d, mint, live)

    for fixture, want in ((cornell, False), (four, True)):
        _, scene, o, d, px, _ = fixture
        seen.clear()
        _, g_mat, g_em = _naive(scene, o, d, px, DEPTH)
        sc = scene._replace(mat_params=scene.mat_params.clone()
                            .requires_grad_())
        Spy(max_depth=DEPTH).li(sc, torch.as_tensor(o), torch.as_tensor(d),
                                0, torch.as_tensor(px.astype(np.int64)), 0)
        assert any(seen) == want, seen
        assert torch.isfinite(g_mat[0, 0:3]).all()
        assert torch.isfinite(g_em).all() and g_em.abs().max() > 0



def test_naive_grad_nan_as_reference(four):
    """Naive autograd of mean(li) on the four-material scene at max_depth
    3 is NaN on GGX α entries and the glass's η only (every family runs
    on every lane under torch.where, so 0·∞ reaches them; the JAX
    package's naive gradient is NaN there too, on the same entries and
    [0, 10]: scripts/naive_grad_nan.py), while the albedos, the radiance
    and PRB's gradients (test_prb_matches_jax) are finite."""
    _, scene, o, d, px, _ = four
    _, g_mat, g_em = _naive(scene, o, d, px, DEPTH)
    nan = ~torch.isfinite(g_mat)
    assert nan.any()
    assert {tuple(i) for i in nan.nonzero().tolist()} <= {
        (0, 9), (0, 10), (1, 9), (1, 10), (2, 0)}
    assert torch.isfinite(g_em).all() and g_em.abs().max() > 0
