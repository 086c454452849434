"""The port's image and mesh I/O, shapes and geometry textures against the
JAX package on the CPU: io/image.py (EXR bytes and readers, PFM, HDR, NPY,
PNG, text exports, the banner), io/obj.py, io/ply.py, io/serialized.py,
scene/shapes.py (disk, cylinder, heightfield) and texture/geomtex.py.
Inputs come from numpy seeds."""
import numpy as np
import pytest

from mitsuba_tpu import native
from mitsuba_tpu.io import image as jimage
from mitsuba_tpu.io import obj as jobj
from mitsuba_tpu.io import ply as jply
from mitsuba_tpu.io import serialized as jser
from mitsuba_tpu.scene import shapes as jshapes
from mitsuba_tpu.texture import geomtex as jgeom
from mitsuba_tpu_torch.io import image as timage
from mitsuba_tpu_torch.io import obj as tobj
from mitsuba_tpu_torch.io import ply as tply
from mitsuba_tpu_torch.io import serialized as tser
from mitsuba_tpu_torch.scene import shapes as tshapes
from mitsuba_tpu_torch.texture import geomtex as tgeom

MESH_FIELDS = ("vertices", "faces", "normals", "uvs", "colors")


def _image(c=3, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(7, 13, c) * 3).astype(np.float32)


def _same_mesh(a, b, exact=True):
    for name in MESH_FIELDS:
        x, y = getattr(a, name, None), getattr(b, name, None)
        assert (x is None) == (y is None), name
        if x is None:
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype, name
        if exact:
            assert np.array_equal(x, y), name
        else:
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("pixel_type", ["half", "float"])
@pytest.mark.parametrize("compression", ["zip", "zips", "none"])
def test_exr_matches_jax(tmp_path, compression, pixel_type):
    """A 13×7 image with annotations: the port's file is byte-equal to the
    JAX writer's, each reader reads the other's file exactly (half: to
    numpy's float16 rounding), and the annotations read back."""
    img = _image()
    ann = {"renderTime": 1.25, "spp": 8, "generatedBy": "test"}
    pj, pt = str(tmp_path / "j.exr"), str(tmp_path / "t.exr")
    jimage.write_exr(pj, img, annotations=ann, compression=compression,
                     pixel_type=pixel_type)
    timage.write_exr(pt, img, annotations=ann, compression=compression,
                     pixel_type=pixel_type)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    want = img if pixel_type == "float" else \
        img.astype(np.float16).astype(np.float32)
    assert np.array_equal(timage.read_exr(pj), want)
    assert np.array_equal(jimage.read_exr(pt), want)
    assert np.array_equal(timage.read_exr(pt), np.asarray(
        jimage.read_exr(pj)))
    assert timage.read_exr_annotations(pt) == \
        jimage.read_exr_annotations(pj)
    assert timage.read_exr_annotations(pt)["spp"] == 8


def test_exr_channels_match_jax(tmp_path):
    """One and four channels, and named channels: bytes equal."""
    for c, names in ((1, None), (4, None), (2, ["Z", "U"])):
        img = _image(c, seed=c)
        pj, pt = str(tmp_path / "j.exr"), str(tmp_path / "t.exr")
        jimage.write_exr(pj, img, channel_names=names)
        timage.write_exr(pt, img, channel_names=names)
        assert open(pj, "rb").read() == open(pt, "rb").read(), c
        assert np.array_equal(timage.read_exr(pt), jimage.read_exr(pj))


@pytest.mark.parametrize("ext", [".pfm", ".hdr", ".npy"])
def test_float_formats_round_trip(tmp_path, ext):
    """PFM and NPY round-trip exactly; HDR (RGBE: 8-bit mantissas on the
    pixel's largest channel's exponent, truncated) to 2^-7 of that
    channel. Each package reads the other's file to the
    same array, and read_image agrees."""
    img = np.abs(_image(seed=4))
    pj, pt = str(tmp_path / f"j{ext}"), str(tmp_path / f"t{ext}")
    jimage.write_image(pj, img)
    timage.write_image(pt, img)
    back = timage.read_image(pt)
    if ext == ".hdr":
        assert (np.abs(back - img)
                <= img.max(-1, keepdims=True) * 2 ** -7).all()
    else:
        assert np.array_equal(back, img)
    assert np.array_equal(back, jimage.read_image(pt))
    assert np.array_equal(timage.read_image(pj), jimage.read_image(pj))


def test_png_round_trip(tmp_path):
    """PNG (PIL): the port's file equals the JAX writer's pixels and
    read_image de-gammas as JAX's does."""
    pytest.importorskip("PIL")
    img = np.clip(np.abs(_image(seed=5)) / 4, 0, 1)
    pj, pt = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    jimage.write_image(pj, img)
    timage.write_image(pt, img)
    back = timage.read_image(pt)
    assert np.array_equal(back, jimage.read_image(pj))
    np.testing.assert_allclose(back, img, atol=0.02)


def test_text_exports_and_banner_match_jax(tmp_path):
    """write_m, write_mathematica and stamp_banner equal JAX's."""
    img = _image(seed=6)[:3, :4]
    for fn in ("write_m", "write_mathematica"):
        getattr(jimage, fn)(str(tmp_path / "j.txt"), img)
        getattr(timage, fn)(str(tmp_path / "t.txt"), img)
        assert (tmp_path / "j.txt").read_text() == \
            (tmp_path / "t.txt").read_text(), fn
    big = np.zeros((16, 64, 3), np.float32)
    assert np.array_equal(timage.stamp_banner(big),
                          jimage.stamp_banner(big))
    assert timage.stamp_banner(big).max() == np.float32(0.8)


_OBJ = """mtllib two.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vn 0 0 1
vn 0 1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
usemtl matA
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl matB
f -5/1/2 -4/2/2 -1/4/2
f 2/2/2 3/3/2 5/1/2
"""
_MTL = """newmtl matA
Kd 0.8 0.2 0.1
Ks 0.5 0.5 0.5
Ns 40
newmtl matB
Kd 0.1 0.7 0.3
"""


def _write_obj(tmp_path):
    (tmp_path / "two.mtl").write_text(_MTL)
    p = tmp_path / "two.obj"
    p.write_text(_OBJ)
    return str(p)


def test_obj_matches_jax(tmp_path, monkeypatch):
    """OBJ with an MTL and two groups: the port's groups, meshes and
    materials equal the JAX Python parser's exactly, and the JAX native
    parser's as triangle soups (it numbers vertices in another order)."""
    path = _write_obj(tmp_path)
    groups_n, _ = jobj.load_obj(path)
    monkeypatch.setattr(native, "available", lambda: False)
    for split in (True, False):
        jg, jm = jobj.load_obj(path, split_groups=split)
        tg, tm = tobj.load_obj(path, split_groups=split)
        assert tm == jm and len(tm) == 2
        assert [g.material_name for g in tg] == \
            [g.material_name for g in jg]
        for a, b in zip(tg, jg):
            _same_mesh(a.mesh, b.mesh)
    tg, _ = tobj.load_obj(path)
    assert [g.material_name for g in tg] == ["matA", "matB"]
    for a, b in zip(tg, groups_n):
        assert np.array_equal(a.mesh.vertices[a.mesh.faces],
                              b.mesh.vertices[b.mesh.faces])
        assert np.array_equal(a.mesh.normals[a.mesh.faces],
                              b.mesh.normals[b.mesh.faces])


def _ply_bytes(fmt):
    """A 5-vertex PLY (normals, uv, uchar colors) with a quad and a
    triangle, in `fmt`."""
    rs = np.random.RandomState(9)
    v = rs.rand(5, 8).astype(np.float32)
    col = rs.randint(0, 256, (5, 3)).astype(np.uint8)
    faces = [[0, 1, 2, 3], [1, 2, 4]]
    head = (f"ply\nformat {fmt} 1.0\ncomment test\nelement vertex 5\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property float nx\nproperty float ny\nproperty float nz\n"
            "property float u\nproperty float v\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "element face 2\nproperty list uchar int vertex_indices\n"
            "end_header\n").encode()
    if fmt == "ascii":
        rows = [" ".join([*(repr(float(x)) for x in v[i]),
                          *(str(int(c)) for c in col[i])])
                for i in range(5)]
        rows += [" ".join(map(str, [len(f), *f])) for f in faces]
        return head + ("\n".join(rows) + "\n").encode()
    e = "<" if fmt == "binary_little_endian" else ">"
    body = b"".join(v[i].astype(e + "f4").tobytes() + col[i].tobytes()
                    for i in range(5))
    for f in faces:
        body += bytes([len(f)]) + np.asarray(f, e + "i4").tobytes()
    return head + body


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian",
                                 "binary_big_endian"])
def test_ply_matches_jax(tmp_path, fmt):
    """ASCII and binary PLY of both endians: arrays equal JAX's."""
    p = tmp_path / "m.ply"
    p.write_bytes(_ply_bytes(fmt))
    tm, jm = tply.load_ply(str(p)), jply.load_ply(str(p))
    _same_mesh(tm, jm)
    assert tm.faces.tolist() == [[0, 1, 2], [0, 2, 3], [1, 2, 4]]
    assert tm.colors.max() <= 1.0


def test_serialized_matches_jax(tmp_path):
    """save_serialized files are byte-equal; each loader reads the
    other's file to equal arrays."""
    mesh = tshapes.sphere(4, 8)
    pj, pt = str(tmp_path / "j.serialized"), str(tmp_path / "t.serialized")
    jser.save_serialized(pj, jshapes.sphere(4, 8))
    tser.save_serialized(pt, mesh)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    _same_mesh(tser.load_serialized(pj), jser.load_serialized(pt))
    back = tser.load_serialized(pt)
    np.testing.assert_allclose(back.vertices, mesh.vertices, atol=1e-7)


@pytest.mark.parametrize("name", ["disk", "cylinder", "heightfield"])
def test_shapes_match_jax(name):
    """disk, cylinder and heightfield meshes equal JAX's."""
    if name == "heightfield":
        h = np.random.RandomState(2).rand(5, 7)
        _same_mesh(tshapes.heightfield(h), jshapes.heightfield(h))
        _same_mesh(tshapes.heightfield(h, True),
                   jshapes.heightfield(h, True))
    else:
        _same_mesh(getattr(tshapes, name)(12), getattr(jshapes, name)(12))


def _geom_meshes(shapes):
    two = shapes.Mesh(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                                [1, 1, 0.3]], float),
                      np.array([[0, 1, 2], [1, 3, 2]]),
                      np.tile([0.0, 0.0, 1.0], (4, 1)))
    return {"sphere": shapes.sphere(), "two_faces": two}


@pytest.mark.parametrize("which", ["sphere", "two_faces"])
def test_geomtex_matches_jax(which):
    """The geometry-texture bakes on sphere() and a two-face mesh agree
    with JAX's within 1e-6."""
    tmesh, jmesh = _geom_meshes(tshapes)[which], _geom_meshes(jshapes)[which]
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)
    _same_mesh(tgeom.deindex_barycentric(tmesh),
               jgeom.deindex_barycentric(jmesh), exact=False)
    close(tgeom.wireframe_pattern(tmesh, res=64),
          jgeom.wireframe_pattern(jmesh, res=64))
    close(tgeom.wireframe_pattern(tmesh, (0.6,) * 3, (0.1, 0.2, 0.3), 0.05,
                                  0.3, res=32),
          jgeom.wireframe_pattern(jmesh, (0.6,) * 3, (0.1, 0.2, 0.3), 0.05,
                                  0.3, res=32))
    cols = np.random.RandomState(3).rand(len(tmesh.vertices), 3)
    (ta, tm), (ja, jm) = (tgeom.bake_vertex_colors(tmesh, cols),
                          jgeom.bake_vertex_colors(jmesh, cols))
    close(ta, ja)
    _same_mesh(tm, jm, exact=False)
    for a, b in zip(tgeom.vertex_curvature(tmesh),
                    jgeom.vertex_curvature(jmesh)):
        close(a, b)
    for kind in ("gaussian", "mean"):
        close(tgeom.curvature_colors(tmesh, kind, 0.5),
              jgeom.curvature_colors(jmesh, kind, 0.5))
        (ta, tm), (ja, jm) = (tgeom.bake_curvature(tmesh, kind),
                              jgeom.bake_curvature(jmesh, kind))
        close(ta, ja)
        _same_mesh(tm, jm, exact=False)
    close(tgeom.scale_texture(cols, 0.5), jgeom.scale_texture(cols, 0.5))
