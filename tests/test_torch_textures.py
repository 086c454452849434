"""Config 3's textures and environment map, and the megakernels'
procedural albedo, in the port against the JAX package on the CPU: the
mip pyramid and texel pool, the bilinear, trilinear and anisotropic
lookups in repeat and clamp modes, the envmap's tables, sampling, pdf and
radiance, the envmap rows of sample_direct, texture-resolved materials
and normal/bump-mapped frames, the texenv scene's path (chip_smoke.py
texenv_desc) against the JAX PathTracer, the proctex scene (the recipe of
tests/test_mega_tpu.py:467-529) through the megakernels' plain version
against the JAX PathTracer, the analytic checker/grid albedo against the
port's bitmap lookup, the gates and convert.py. Inputs come from numpy
seeds; the JAX references run specialised to each scene's families (two
PathTracer compiles in the file)."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (proctex_desc, recipe_camera, sky_image,
                        smooth_noise, texenv_desc, texenv_images)
from test_torch_lights import _image_rule
from test_torch_scene import _numpy_fields
from test_torch_shade import _compiled

from mitsuba_tpu.bsdf import bsdf as jbsdf
from mitsuba_tpu.core import transform as jtf
from mitsuba_tpu.core.math import Frame as JFrame
from mitsuba_tpu.emitter import emitter as jem
from mitsuba_tpu.emitter import envmap as jenv
from mitsuba_tpu.integrator.mega import MegaPathTracer as JMega
from mitsuba_tpu.integrator.path import PathTracer as JPath
from mitsuba_tpu.scene import builder as jb
from mitsuba_tpu.scene import shapes as jshapes
from mitsuba_tpu.texture import texture as jtex
from mitsuba_tpu_torch.accel import dense as tdense
from mitsuba_tpu_torch.accel import megakernel as tmk
from mitsuba_tpu_torch.accel import shade_kernel as tshade
from mitsuba_tpu_torch.bsdf import bsdf as tbsdf
from mitsuba_tpu_torch.convert import scene_from_numpy
from mitsuba_tpu_torch.core import transform as ttf
from mitsuba_tpu_torch.core.math import Frame as TFrame
from mitsuba_tpu_torch.emitter import emitter as tem
from mitsuba_tpu_torch.emitter import envmap as tenv
from mitsuba_tpu_torch.film.film import Film
from mitsuba_tpu_torch.integrator.common import ray_mint
from mitsuba_tpu_torch.integrator.mega import (MegaPathTracer,
                                               render_persistent)
from mitsuba_tpu_torch.integrator.path import PathTracer as TPath
from mitsuba_tpu_torch.render import render_fn
from mitsuba_tpu_torch.scene import builder as tb
from mitsuba_tpu_torch.scene import shapes as tshapes
from mitsuba_tpu_torch.sensor.sensor import PerspectiveCamera
from mitsuba_tpu_torch.texture import texture as ttex

torch.set_num_threads(2)

N = 4096
TEX_TOL = dict(rtol=1e-6, atol=1e-7)     # lookups, materials, frames
ENV_TOL = dict(rtol=1e-5, atol=1e-6)     # libm's sin, cos, atan2, acos
PKG = {"jax": (jb, jtf, jshapes, jtex), "torch": (tb, ttf, tshapes, ttex)}


def _desc(name, pkg, **kw):
    make = {"texenv": texenv_desc, "proctex": proctex_desc}[name]
    return make(*PKG[pkg], **kw)


def _pair(name, **kw):
    """The scene `name` compiled by both packages (JAX, port on the
    CPU), and the port's description."""
    desc = _desc(name, "torch", **kw)
    return (jb.compile_scene(_desc(name, "jax", **kw)),
            tb.compile_scene(desc, device="cpu"), desc)


@pytest.fixture(scope="module")
def texenv():
    """The texenv scene with its sky at 64×128 (the card runs 256×512;
    test_env_tables_match_jax builds that one's tables)."""
    return _pair("texenv", sky=(64, 128))


@pytest.fixture(scope="module")
def proctex():
    return _pair("proctex")


def _close(t, j, tol=TEX_TOL, msg=""):
    np.testing.assert_allclose(t.numpy() if torch.is_tensor(t) else t,
                               np.asarray(j), **tol, err_msg=msg)


# ---- texel pool and lookups ---------------------------------------------

def _images(rs, square=False):
    """Seeded images: square ones (smooth noise, as a rendered texture
    is: on white noise a lookup turns an ulp of its uv into 1e-5 of its
    value, and this CPU build's torch.sqrt rounds the anisotropic
    footprint's minor axis an ulp away from XLA's now and then), one of
    them one-channel, and, unless `square`, non-square and odd-sized
    white noise (whose pyramids end in levels of width 0 in both
    packages: looked up, those read texels of no level)."""
    out = [smooth_noise(rs, 64, 8, 3, 0.0, 1.0),
           smooth_noise(rs, 16, 4, 3, 0.0, 1.0),
           smooth_noise(rs, 8, 2, 1, 0.0, 1.0)[..., 0]]
    if not square:
        out += [rs.rand(48, 20, 3).astype(np.float32),
                rs.rand(13, 7, 3).astype(np.float32)]
    return out


def test_pack_textures_match_jax(texenv):
    """build_pyramid and pack_textures give the JAX arrays exactly, and so
    does compile_scene's texel pool (the 512² albedo has ten levels)."""
    rs = np.random.RandomState(0)
    images = _images(rs)
    for img in images:
        for a, b in zip(ttex.build_pyramid(img), jtex.build_pyramid(img)):
            assert np.array_equal(a, b)
    wraps = [0, 1, 0, 1, 0]
    for out, ref in zip(ttex.pack_textures(images, wraps),
                        jtex.pack_textures(images, wraps)):
        assert np.array_equal(out, ref) and out.dtype == ref.dtype
    j, t, _ = texenv
    for name in ("tex_data", "tex_meta"):
        assert np.array_equal(getattr(t, name).numpy(),
                              np.asarray(getattr(j, name))), name
    assert len(ttex.build_pyramid(texenv_images()["albedo"])) == 10


@pytest.mark.parametrize("mode", [ttex.WRAP_REPEAT, ttex.WRAP_CLAMP],
                         ids=["repeat", "clamp"])
@pytest.mark.parametrize("lookup", ["lod", "trilinear", "aniso"])
def test_eval_texture_matches_jax(mode, lookup):
    """eval_texture_lod at levels 0-15, eval_texture at a fractional lod
    and eval_texture_aniso on 4,096 seeded uvs in [-1.5, 2.5]² (negative
    texel indices and repeat seams) of square textures, per lane within
    rel 1e-6."""
    rs = np.random.RandomState(1)
    images = _images(rs, square=True)
    data, meta = ttex.pack_textures(images, [mode] * len(images))
    tsc = types.SimpleNamespace(tex_data=torch.as_tensor(data),
                                tex_meta=torch.as_tensor(meta))
    jsc = types.SimpleNamespace(tex_data=jnp.asarray(data),
                                tex_meta=jnp.asarray(meta))
    tid = rs.randint(0, len(images), N).astype(np.int32)
    uv = rs.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    if lookup == "lod":
        level = rs.randint(0, ttex.MAX_MIPS, N).astype(np.int32)
        args = (tid, uv, level)
        fns = ttex.eval_texture_lod, jtex.eval_texture_lod
    elif lookup == "trilinear":
        args = (tid, uv, rs.uniform(0, 7, N).astype(np.float32))
        fns = ttex.eval_texture, jtex.eval_texture
    else:
        duv = (rs.randn(2, N, 2) * rs.choice([0.002, 0.02, 0.2], (2, N, 1))
               ).astype(np.float32)
        args = (tid, uv, duv[0], duv[1])
        fns = ttex.eval_texture_aniso, jtex.eval_texture_aniso
    out = fns[0](tsc, *(torch.as_tensor(a) for a in args))
    ref = fns[1](jsc, *(jnp.asarray(a) for a in args))
    _close(out, ref)


# ---- the environment map --------------------------------------------------

def test_env_tables_match_jax():
    """build_env_tables (with build_alias_table) gives the JAX arrays
    exactly for texenv's 256×512 sky."""
    img = sky_image(256, 512)
    out, ref = tenv.build_env_tables(img), jenv.build_env_tables(img)
    assert out.keys() == ref.keys()
    for k in ref:
        assert np.array_equal(out[k], ref[k]) and out[k].dtype == \
            ref[k].dtype, k


def _off_texel_edges(d, h, w, gap=1e-4):
    """Lanes whose direction lies further than `gap` (in texels) from a
    texel edge of the h×w lat-long map: pdf_env_dir is constant over a
    texel, so an ulp of atan2 or acos moves a lane at an edge to its
    neighbour's value."""
    d = np.asarray(d, np.float64)
    u = (np.arctan2(d[:, 0], -d[:, 2]) % (2 * np.pi)) / (2 * np.pi) * w
    v = np.arccos(np.clip(d[:, 1], -1, 1)) / np.pi * h
    edge = lambda x: np.abs(x - np.round(x))
    return (edge(u) > gap) & (edge(v) > gap)


@pytest.mark.parametrize("table", ["alias", "cdf"])
def test_sample_env_matches_jax(texenv, table):
    """sample_env by the alias table and by the CDF pair (a scene without
    an alias table) on 4,096 seeded u2, and pdf_env_dir and eval_env_dir
    on 4,096 seeded directions: rel 1e-5 (libm's trigonometry differs by
    ulps); pdf_env_dir on the lanes off texel edges."""
    j, t, _ = texenv
    if table == "cdf":
        j, t = j._replace(env_alias=None), t._replace(env_alias=None)
    rs = np.random.RandomState(2)
    u2 = rs.rand(N, 2).astype(np.float32)
    d = rs.randn(N, 3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    args = (j, jnp.asarray(u2), jnp.asarray(d))
    (jd, jpdf, jrad), jpdf_d, jrad_d = _compiled(lambda sc, u2, d: (
        jenv.sample_env(sc, u2), jenv.pdf_env_dir(sc, d),
        jenv.eval_env_dir(sc, d)), *args)(*args)
    td, tpdf, trad = tenv.sample_env(t, torch.as_tensor(u2))
    _close(td, jd, ENV_TOL, "d")
    _close(tpdf, jpdf, ENV_TOL, "pdf")
    _close(trad, jrad, ENV_TOL, "radiance")
    h, w = t.env_density.shape
    ok = _off_texel_edges(d, h, w)
    assert ok.mean() > 0.99
    _close(tenv.pdf_env_dir(t, torch.as_tensor(d)).numpy()[ok],
           np.asarray(jpdf_d)[ok], ENV_TOL)
    _close(tenv.eval_env_dir(t, torch.as_tensor(d)), jrad_d, ENV_TOL)
    # and at the sampled directions
    _close(tenv.pdf_env_dir(t, td).numpy()[_off_texel_edges(jd, h, w)],
           np.asarray(jenv.pdf_env_dir(j, jd))[_off_texel_edges(jd, h, w)],
           ENV_TOL)


def test_sample_direct_envmap_matches_jax():
    """The envmap rows of sample_direct, and eval_env and pdf_direct_env,
    on texenv's envmap beside a point and a constant light (which the
    envmap's row follows; env_id names the envmap): seeded points and
    uniforms, rel 1e-5; the picks exactly."""
    descs = []
    for pkg in ("jax", "torch"):
        d = _desc("texenv", pkg, sky=(64, 128))
        builder = PKG[pkg][0]
        d.point_lights.append(builder.PointLight(position=[1.0, 3.0, 1.0],
                                                 intensity=[5.0, 5.0, 5.0]))
        d.constant_light = builder.ConstantLight(radiance=(0.1, 0.1, 0.1))
        descs.append(d)
    j = jb.compile_scene(descs[0])
    t = tb.compile_scene(descs[1], device="cpu")
    assert int(t.env_id) == int(j.env_id) == 2
    rs = np.random.RandomState(3)
    p = (rs.rand(N, 3) * [4, 2, 4] - [2, 1, 2]).astype(np.float32)
    u_sel = rs.rand(N).astype(np.float32)
    u2 = rs.rand(N, 2).astype(np.float32)
    d = rs.randn(N, 3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    args = (j, *(jnp.asarray(x) for x in (p, u_sel, u2, d)))
    js, jenv_l, jpdf = _compiled(lambda sc, p, u_sel, u2, d: (
        jem.sample_direct(sc, p, u_sel, u2), jem.eval_env(sc, d),
        jem.pdf_direct_env(sc, d)), *args)(*args)
    ts = tem.sample_direct(t, *(torch.as_tensor(x) for x in (p, u_sel, u2)))
    assert np.array_equal(ts.em_id.numpy(), np.asarray(js.em_id))
    assert np.array_equal(ts.is_delta.numpy(), np.asarray(js.is_delta))
    types_ = t.em_type[ts.em_id].numpy()
    assert set(types_.tolist()) == {1, 2, 3}
    for name in ("d", "dist", "pdf", "value", "n"):
        _close(getattr(ts, name), getattr(js, name), ENV_TOL, name)
    td = torch.as_tensor(d)
    _close(tem.eval_env(t, td), jenv_l, ENV_TOL, "eval_env")
    h, w = t.env_density.shape
    ok = _off_texel_edges(d, h, w)
    _close(tem.pdf_direct_env(t, td).numpy()[ok], np.asarray(jpdf)[ok],
           ENV_TOL, "pdf_direct_env")


# ---- texture-resolved materials and perturbed frames ----------------------

def test_resolve_material_matches_jax():
    """resolve_material with albedo and roughness textures (texenv's
    floor, wall and checker quad), a blend whose weight is a texture and
    one over textured children, at 4,096 seeded uvs, at the finest level
    and at the lods of seeded footprints: every field within rel 1e-6."""
    descs = []
    for pkg in ("jax", "torch"):
        d = _desc("texenv", pkg, sky=(8, 16))
        d.add_material(kind="blendbsdf", child_a=0, child_b=1,
                       weight_texture=1)
        d.add_material(kind="mixturebsdf", child_a=0, child_b=4, weight=0.3)
        descs.append(d)
    j = jb.compile_scene(descs[0])
    t = tb.compile_scene(descs[1], device="cpu")
    rs = np.random.RandomState(4)
    mid = rs.randint(0, int(t.mat_type.shape[0]), N).astype(np.int32)
    uv = rs.uniform(-0.5, 1.5, (N, 2)).astype(np.float32)
    ext = (rs.rand(N) * 0.05).astype(np.float32)
    fams = tuple(sorted(set(np.asarray(j.mat_type).tolist())))
    for lod in (None, ext):
        jm = jbsdf.resolve_material(
            j, jnp.asarray(mid), jnp.asarray(uv), fams,
            None if lod is None else jnp.asarray(lod))
        tm = tbsdf.resolve_material(
            t, torch.as_tensor(mid).long(), torch.as_tensor(uv), fams,
            None if lod is None else torch.as_tensor(lod))
        for name in tm._fields:
            _close(getattr(tm, name), getattr(jm, name), msg=name)
    tm = tbsdf.resolve_material(t, torch.as_tensor(mid).long(),
                                torch.as_tensor(uv), fams)
    floor = mid == 0
    assert tm.params[floor, 0].std() > 0.05        # the albedo varies
    assert tm.params[mid == 1, 9].std() > 0.05     # the roughness varies


@pytest.mark.parametrize("kind", ["normal", "bump"])
def test_perturb_shading_frame_matches_jax(texenv, kind):
    """perturb_shading_frame with texenv's tangent-space normal map and
    its height map as a bump map (scale 0.05), on 4,096 seeded frames and
    uvs: the frame within rel 1e-6, and changed."""
    j, t, _ = texenv
    mat_id = {"normal": 2, "bump": 3}[kind]
    rs = np.random.RandomState(5)
    n = rs.randn(N, 3)
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    uv = rs.uniform(-0.5, 1.5, (N, 2)).astype(np.float32)
    mid = np.full(N, mat_id, np.int32)
    jm = jbsdf.resolve_material(j, jnp.asarray(mid), jnp.asarray(uv))
    tm = tbsdf.resolve_material(t, torch.as_tensor(mid).long(),
                                torch.as_tensor(uv))
    jf = jbsdf.perturb_shading_frame(j, jm, JFrame.from_normal(
        jnp.asarray(n)), jnp.asarray(uv))
    tf = tbsdf.perturb_shading_frame(t, tm, TFrame.from_normal(
        torch.as_tensor(n)), torch.as_tensor(uv))
    for a, b, name in zip(tf, jf, "stn"):
        _close(a, b, dict(rtol=1e-6, atol=1e-6), name)
    tilt = (tf[2] * torch.as_tensor(n)).sum(-1)
    assert (tilt < 0.9999).float().mean() > 0.5


# ---- the texenv scene's path ------------------------------------------------

def test_texenv_path_matches_jax(texenv):
    """The texenv scene (envmap NEE and escape, textured floor, wall and
    quad, normal and bump maps, GGX spheres) through the port's render_fn
    with PathTracer, the tail eager and fused (the shade kernel's plain
    version), against the JAX PathTracer at 24², 4 spp: the image rule
    and ray counts within rel 1e-4."""
    j, t, _ = texenv
    res, spp, seed, depth = 24, 4, 7, 8
    cam = recipe_camera(PerspectiveCamera, ttf, res)
    pix = torch.arange(res * res)
    jint = JPath(max_depth=depth, accel="dense").specialized_for(j)
    o, d = (x.numpy() for x in tmk.primary_rays(cam, seed, pix, 0))
    args = (j, jnp.asarray(o), jnp.asarray(d), jnp.uint32(seed),
            jnp.arange(res * res, dtype=jnp.uint32), jnp.uint32(0))
    fn = _compiled(jint.li_stats, *args)
    jL, jn = 0.0, 0
    for s in range(spp):
        o, d = (x.numpy() for x in tmk.primary_rays(cam, seed, pix, s))
        L, n = fn(j, jnp.asarray(o), jnp.asarray(d), jnp.uint32(seed),
                  args[4], jnp.uint32(s))
        jL, jn = jL + np.asarray(L), jn + int(n)
    jL = (jL / spp).reshape(res, res, 3)
    assert np.isfinite(jL).all() and jL.mean() > 0.05
    assert tshade.supports(t) == (True, "")
    for fused in ("off", "on"):
        img, n = render_fn(t, cam, Film(res, res, "box"),
                           TPath(max_depth=depth, fused_shade=fused), spp,
                           seed, "cpu")
        _image_rule(img.numpy(), jL)
        assert abs(int(n) - jn) <= 1e-4 * jn, (fused, int(n), jn)


# ---- the proctex scene through the megakernels' plain version --------------

def _recipe_rays(n=N):
    """tests/test_mega_tpu.py:511-516: origin (0, 1, 5), directions
    around (0, -0.15, -1)."""
    rs = np.random.RandomState(5)
    o = np.tile(np.float32([0.0, 1.0, 5.0]), (n, 1))
    d = rs.randn(n, 3) * [0.5, 0.4, 0.25] + [0, -0.15, -1.0]
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def _assert_close(L_ref, L_m, frac=0.02, mean_tol=8e-3):
    """tests/test_mega_tpu.py:228-233."""
    rel = np.abs(L_ref - L_m) / np.maximum(L_ref, 1e-2)
    assert (rel > 1e-2).mean() < frac, (rel > 1e-2).mean()
    ref_mean = max(L_ref.mean(), 1e-4)
    assert abs(L_ref.mean() - L_m.mean()) / ref_mean < mean_tol, (
        L_ref.mean(), L_m.mean())


def test_proctex_plain_matches_jax(proctex):
    """MegaPathTracer with the procedural albedo (the megakernels' plain
    version on CPU tensors) on the recipe's 4,096 rays, max_depth 6,
    against the JAX XLA PathTracer sampling the rasterized bitmaps: the
    recipe's _assert_close; and the analytic albedo drives the image
    (mean difference to the untextured tables above 0.05, on the first
    1,024 rays)."""
    j, t, desc = proctex
    o, d = _recipe_rays()
    px = np.arange(N, dtype=np.uint32)
    ref = JPath(max_depth=6, accel="dense").specialized_for(j)
    args = (j, jnp.asarray(o), jnp.asarray(d), jnp.uint32(3),
            jnp.asarray(px), jnp.uint32(0))
    L_ref = np.asarray(_compiled(ref.li, *args)(*args))
    mega = MegaPathTracer.for_scene(t, max_depth=6, tex_procs=desc.tex_procs)
    assert mega.tables.textured and mega.tables.ext
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    tpx = torch.as_tensor(px.astype(np.int64))
    tmk.reset_launches()
    L_m = mega.li(t, to, td, 3, tpx, 0).numpy()
    _assert_close(L_ref, L_m)
    untextured = MegaPathTracer(max_depth=6,
                                tables=tmk.build_mega_tables(t))
    assert not untextured.tables.textured
    part = slice(0, N // 4)
    L_p = untextured.li(t, to[part], td[part], 3, tpx[part], 0).numpy()
    assert np.abs(L_m[part] - L_p).mean() > 0.05
    assert sum(tmk.LAUNCHES.values()) == 0      # CPU: the plain version


def test_proctex_mega_equals_eager(proctex):
    """On CPU tensors render() with MegaPathTracer and render_persistent
    (their plain versions: MegaPlainTracer with proc_albedo) equal the
    eager PathTracer on the bitmaps at 16², 2 spp (the analytic form is
    the bilinear bitmap lookup up to rounding), ray counts exactly."""
    _, t, desc = proctex
    cam = recipe_camera(PerspectiveCamera, ttf, 16)
    integ = MegaPathTracer.for_scene(t, max_depth=6,
                                     tex_procs=desc.tex_procs)
    args = (t, cam, Film(16, 16, "box"))
    img_e, n_e = render_fn(*args, TPath(max_depth=6), 2, 3, "cpu")
    img_m, n_m = render_fn(*args, integ, 2, 3, "cpu")
    img_p, n_p = render_persistent(integ, cam, 2, 3)
    assert int(n_e) == int(n_m) == int(n_p) > 0
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(img_m.numpy(), img_e.numpy(), **tol)
    np.testing.assert_allclose(img_p.numpy(), img_e.numpy(), **tol)


def test_proc_albedo_matches_bitmap(proctex):
    """The analytic checker/grid albedo (megakernel.proc_albedo, which
    csrc/megakernel.cu computes op for op) against the port's bitmap
    lookup of the same texture (texture.eval_texture) at the recipe
    rays' floor and wall hits and at 4,096 seeded uvs in [-2, 3]²: within
    1e-6."""
    _, t, desc = proctex
    tables = MegaPathTracer.for_scene(t, tex_procs=desc.tex_procs).tables
    o, d = (torch.as_tensor(x) for x in _recipe_rays())
    its = tdense.ray_intersect(tables.plain_scene, o, d, ray_mint(o),
                               torch.full_like(o[:, 0], 1e30))
    rs = np.random.RandomState(6)
    for mat_id, uv, live in (
            (its.mat_id, its.uv, its.valid & (its.mat_id <= 1)),
            (torch.as_tensor(rs.randint(0, 2, N)),
             torch.as_tensor(rs.uniform(-2, 3, (N, 2)).astype(np.float32)),
             torch.ones(N, dtype=torch.bool))):
        assert int(live.sum()) > 1000
        mat_id, uv = mat_id[live], uv[live]
        top = tables.mat[mat_id].T
        assert (top[tmk.TEXROW] >= 0).all()
        analytic = tmk.proc_albedo(top, uv).T
        bitmap = ttex.eval_texture(t, t.mat_tex[mat_id, 0], uv)
        np.testing.assert_allclose(analytic.numpy(), bitmap.numpy(),
                                   rtol=0, atol=1e-6)
        assert set(mat_id.tolist()) == {0, 1}       # checker and grid


# ---- gates and convert.py ---------------------------------------------

def test_texture_gates(texenv, proctex):
    """MegaPathTracer refuses the proctex scene without its provenance and
    takes it with tex_procs, as the JAX gate does; it refuses texenv
    (bitmaps, roughness and normal maps, an envmap). The shade kernel
    takes texenv (its roughness texture is on rough diffuse) and turns
    away a roughness-textured GGX rough conductor."""
    jp, tp, desc = proctex
    assert MegaPathTracer.supports(tp) == (False, "textured material")
    assert JMega.supports(jp) == (False, "textured material")
    assert MegaPathTracer.supports(tp, tex_procs=desc.tex_procs) == \
        (True, "")
    assert JMega.supports(jp, tex_procs=desc.tex_procs) == (True, "")
    je, te, tdesc = texenv
    assert not MegaPathTracer.supports(te, tex_procs=tdesc.tex_procs)[0]
    assert tshade.supports(te) == (True, "")
    d = _desc("texenv", "torch", sky=(8, 16))
    d.materials[5].roughness_texture = 1          # the GGX rough conductor
    ok, why = tshade.supports(tb.compile_scene(d, device="cpu"))
    assert not ok and why.startswith("roughness-textured"), why
    with pytest.raises(NotImplementedError, match="fused_shade='on'"):
        TPath(fused_shade="on").specialized_for(
            tb.compile_scene(d, device="cpu"))


def test_convert_texenv(texenv):
    """convert.scene_from_numpy carries the JAX texenv scene across (the
    texel pool, its meta rows and the envmap's tables, alias table
    included), and the converted scene renders as the port's own."""
    j, t, _ = texenv
    c = scene_from_numpy(_numpy_fields(j), device="cpu")
    for name in ("tex_data", "tex_meta", "env_img", "env_row_cdf",
                 "env_col_cdf", "env_density", "env_alias", "env_id",
                 "mat_params", "mat_tex", "em_type"):
        assert np.array_equal(getattr(c, name).numpy(),
                              getattr(t, name).numpy()), name
    cam = recipe_camera(PerspectiveCamera, ttf, 8)
    imgs = [render_fn(s, cam, Film(8, 8, "box"), TPath(max_depth=4), 1, 2,
                      "cpu")[0] for s in (c, t)]
    np.testing.assert_allclose(imgs[0].numpy(), imgs[1].numpy(), rtol=1e-5,
                               atol=1e-6)
