"""The port's XML scene loader (scene/xml.py) against the JAX package's on
the CPU: the five scene files of scenes/ and inline documents that
exercise parameter substitution, <include>, the 0.4 → 0.5 upgrade, OBJ,
PLY and serialized shapes, geometry textures, and bitmap textures and an
envmap read from EXR files. Both loaders must give the same film, camera,
integrator config, sampler and spp, and compile to the same arrays. The
JAX scenes compile with the JAX package's numpy Woop inverse (its native
helper's rounds differently), so every array is compared exactly."""
import dataclasses
import glob
import os
import warnings

import numpy as np
import pytest
import torch

from mitsuba_tpu import native
from mitsuba_tpu.io import image as jimage
from mitsuba_tpu.io import serialized as jser
from mitsuba_tpu.scene import shapes as jshapes
from mitsuba_tpu.scene.xml import load_xml as jload
from mitsuba_tpu_torch.scene.xml import load_xml as tload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = sorted(os.path.basename(p) for p in
                glob.glob(os.path.join(ROOT, "scenes", "*.xml")))
FILM_FIELDS = ("width", "height", "filter_name", "banner",
               "component_format", "compression")
CAMERA_FIELDS = ("width", "height", "fov_x", "aperture_radius",
                 "focus_distance")

torch.set_num_threads(2)


def _same_loaded(j, t):
    """Film, camera, integrator config, sampler and spp equal."""
    for f in FILM_FIELDS:
        assert getattr(t.film, f) == getattr(j.film, f), f
    for f in CAMERA_FIELDS:
        assert getattr(t.camera, f) == getattr(j.camera, f), f
    assert np.array_equal(t.camera.to_world, j.camera.to_world)
    assert t.integrator_config == j.integrator_config
    assert (t.sampler, t.spp) == (j.sampler, j.spp)


def _same_compiled(jscene, tscene):
    """Every SceneData array equal: integers exactly, floats within rtol
    1e-6."""
    assert tscene.n_tris == jscene.n_tris
    for name in jscene._fields:
        ref, out = getattr(jscene, name), getattr(tscene, name)
        if name == "em_pmf":
            for a, b in zip(out, ref):
                assert np.array_equal(a.numpy(), np.asarray(b)), name
            continue
        if name == "n_real_tris":
            continue
        assert (ref is None) == (out is None), name
        if ref is None:
            continue
        ref, out = np.asarray(ref), out.numpy()
        assert out.shape == ref.shape, name
        if np.issubdtype(ref.dtype, np.floating):
            np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0,
                                       err_msg=name)
        else:
            assert np.array_equal(out, ref), name


def _compare(path, monkeypatch, params=None):
    monkeypatch.setattr(native, "available", lambda: False)
    j, t = jload(path, params), tload(path, params)
    _same_loaded(j, t)
    _same_compiled(j.compile(), t.compile(device="cpu"))
    assert t.desc.tex_procs == j.desc.tex_procs
    return j, t


@pytest.mark.parametrize("name", SCENES)
def test_scene_files_match_jax(name, monkeypatch):
    """Each scenes/*.xml: loaded fields and compiled arrays equal."""
    _, t = _compare(os.path.join(ROOT, "scenes", name), monkeypatch)
    assert t.desc.shapes


_INCLUDED = """<scene version="0.5.0">
  <shape type="cube">
    <transform name="toWorld"><scale value="0.2"/>
      <translate x="$cx" y="0.3"/></transform>
    <ref id="mat_$which"/>
  </shape>
</scene>
"""

_MODERN = """<?xml version="1.0"?>
<scene version="0.5.0">
  <default name="w" value="24"/>
  <default name="which" value="a"/>
  <default name="cx" value="0.1"/>
  <integrator type="volpath">
    <integer name="maxDepth" value="$depth"/>
    <integer name="rrDepth" value="3"/>
  </integrator>
  <sensor type="thinlens">
    <float name="fov" value="41"/>
    <float name="apertureRadius" value="0.02"/>
    <float name="focusDistance" value="2.5"/>
    <transform name="toWorld">
      <lookat origin="0, 1, 4" target="0, 0.2, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="$w"/><integer name="height" value="16"/>
      <rfilter type="gaussian"/>
      <boolean name="banner" value="true"/>
      <string name="componentFormat" value="float16"/>
      <string name="compression" value="zips"/>
    </film>
    <sampler type="halton"><integer name="sampleCount" value="$spp"/></sampler>
  </sensor>
  <bsdf type="diffuse" id="mat_a">
    <texture type="bitmap" name="reflectance">
      <string name="filename" value="tex.exr"/>
    </texture>
  </bsdf>
  <bsdf type="twosided">
    <bsdf type="roughconductor" id="mat_b">
      <float name="alpha" value="0.3"/></bsdf>
  </bsdf>
  <alias id="mat_b" as="metal"/>
  <bsdf type="bumpmap" id="bumpy">
    <texture type="scale">
      <float name="scale" value="0.5"/>
      <texture type="bitmap"><string name="filename" value="tex.exr"/></texture>
    </texture>
    <bsdf type="plastic"><rgb name="diffuseReflectance" value="0.3 0.5 0.2"/></bsdf>
  </bsdf>
  <bsdf type="mixturebsdf" id="mix">
    <string name="weights" value="0.3, 0.7"/>
    <bsdf type="diffuse"/>
    <ref id="metal"/>
  </bsdf>
  <include filename="inc.xml"/>
  <shape type="obj">
    <string name="filename" value="two.obj"/>
  </shape>
  <shape type="obj">
    <string name="filename" value="two.obj"/>
    <transform name="toWorld"><translate z="-1"/></transform>
    <ref id="mix"/>
  </shape>
  <shape type="ply">
    <string name="filename" value="m.ply"/>
    <bsdf type="diffuse">
      <texture type="vertexcolors" name="reflectance"/>
    </bsdf>
  </shape>
  <shape type="serialized">
    <string name="filename" value="s.serialized"/>
    <transform name="toWorld"><scale value="0.3"/>
      <rotate y="1" angle="30"/><translate x="-0.5"/></transform>
    <ref id="bumpy"/>
  </shape>
  <shape type="disk">
    <boolean name="flipNormals" value="true"/>
    <bsdf type="diffuse">
      <texture type="curvature" name="reflectance"/>
    </bsdf>
  </shape>
  <shape type="cylinder">
    <transform name="toWorld"><matrix value="0.2 0 0 0.5 0 0.2 0 0 0 0 0.4 0 0 0 0 1"/></transform>
    <bsdf type="diffuse">
      <texture type="gridtexture" name="reflectance">
        <float name="lineWidth" value="0.02"/>
      </texture>
    </bsdf>
  </shape>
  <shape type="heightfield">
    <string name="filename" value="tex.exr"/>
    <float name="scale" value="0.1"/>
    <bsdf type="diffuse">
      <texture type="wireframe" name="reflectance">
        <float name="lineWidth" value="0.05"/>
      </texture>
    </bsdf>
  </shape>
  <shape type="sphere">
    <point name="center" x="0" y="1.5" z="0"/>
    <float name="radius" value="0.3"/>
    <ref id="mat_a"/>
    <emitter type="area"><rgb name="radiance" value="4 3 2"/></emitter>
  </shape>
  <emitter type="point">
    <point name="position" x="1" y="2" z="1"/>
    <rgb name="intensity" value="5"/>
  </emitter>
  <emitter type="envmap">
    <string name="filename" value="env.exr"/>
    <float name="scale" value="0.7"/>
  </emitter>
  <medium type="homogeneous">
    <rgb name="sigmaS" value="0.1 0.2 0.3"/>
    <rgb name="sigmaA" value="0.01"/>
    <phase type="hg"><float name="g" value="-0.3"/></phase>
  </medium>
</scene>
"""

_LEGACY = """<?xml version="1.0"?>
<scene version="0.4.0">
  <integrator type="direct"/>
  <camera type="perspective">
    <transform name="toWorld">
      <translate z="-3"/>
    </transform>
    <film type="exrfilm">
      <integer name="width" value="12"/><integer name="height" value="10"/>
      <rfilter type="lanczos"/>
    </film>
    <sampler type="sobol"><integer name="sampleCount" value="4"/></sampler>
  </camera>
  <bsdf type="lambertian" id="l">
    <rgb name="diffuseReflectance" value="0.2 0.6 0.4"/>
  </bsdf>
  <shape type="rectangle">
    <ref id="l"/>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld"><rotate x="1" angle="90"/>
      <translate y="1"/></transform>
    <bsdf type="microfacet"/>
    <luminaire type="area"><rgb name="intensity" value="3 3 3"/></luminaire>
  </shape>
  <luminaire type="constant"><rgb name="radiance" value="0.1"/></luminaire>
</scene>
"""


@pytest.fixture
def assets(tmp_path):
    """The inline documents and the files they read: an OBJ with an MTL
    and two groups, a PLY with vertex colors, a serialized sphere, and
    EXR images for the bitmap, the heightfield and the envmap."""
    from tests.test_torch_io import _MTL, _OBJ, _ply_bytes
    (tmp_path / "two.mtl").write_text(_MTL)
    (tmp_path / "two.obj").write_text(_OBJ)
    (tmp_path / "m.ply").write_bytes(_ply_bytes("binary_little_endian"))
    jser.save_serialized(str(tmp_path / "s.serialized"),
                         jshapes.sphere(6, 12))
    rs = np.random.RandomState(5)
    jimage.write_exr(str(tmp_path / "tex.exr"),
                     rs.rand(6, 9, 3).astype(np.float32))
    jimage.write_exr(str(tmp_path / "env.exr"),
                     (rs.rand(8, 16, 3) * 2).astype(np.float32))
    (tmp_path / "inc.xml").write_text(_INCLUDED)
    (tmp_path / "modern.xml").write_text(_MODERN)
    (tmp_path / "legacy.xml").write_text(_LEGACY)
    return tmp_path


def test_inline_scene_matches_jax(assets, monkeypatch):
    """The 0.5 document: $key substitution from parameters (the CLI's -D)
    over <default>, <include>, <alias>, every shape loader, the geometry
    textures, bitmap textures, the envmap, the point light and the
    medium."""
    params = {"depth": "5", "spp": "9", "which": "b", "cx": "-0.2"}
    j, t = _compare(str(assets / "modern.xml"), monkeypatch, params)
    assert t.film.width == 24 and t.spp == 9 and t.sampler == "halton"
    assert t.integrator_config == {"type": "volpath", "max_depth": 5,
                                   "rr_depth": 3}
    assert t.film.filter_name == "gaussian" and t.film.banner
    assert t.desc.medium is not None and t.desc.envmap is not None
    assert len(t.desc.textures) == len(j.desc.textures) >= 5
    integ = t.make_integrator()
    assert type(integ).__name__ == "VolPathTracer" and integ.rr_depth == 3


def test_legacy_scene_matches_jax(assets, monkeypatch):
    """The 0.4 document: camera → sensor, luminaire → emitter, exrfilm,
    lambertian → diffuse, microfacet → roughplastic, diffuseReflectance →
    reflectance, an area luminaire's intensity → radiance."""
    j, t = _compare(str(assets / "legacy.xml"), monkeypatch)
    assert [m.kind for m in t.desc.materials] == ["diffuse", "roughplastic"]
    assert t.desc.shapes[1].radiance == [3.0, 3.0, 3.0]
    assert type(t.make_integrator()).__name__ == "DirectIntegrator"


def _doc(body, sensor="perspective", integrator="path"):
    return (f'<scene version="0.5.0"><integrator type="{integrator}"/>'
            f'<sensor type="{sensor}"><film type="hdrfilm">'
            '<integer name="width" value="8"/>'
            '<integer name="height" value="8"/></film></sensor>'
            f"{body}</scene>")


@pytest.mark.parametrize("what,doc,match", [
    ("pssmlt", _doc("", integrator="pssmlt"), "integrator/pssmlt.py"),
    ("hetero", _doc("", integrator="volpath_hetero"), "integrator/hetero"),
    ("irrcache", _doc("", integrator="irrcache"), "integrator/irrcache.py"),
    ("hair", _doc('<shape type="hair"><string name="filename" '
                  'value="h.txt"/></shape>'), "hair"),
    ("hk", _doc('<shape type="cube"><bsdf type="hk"/></shape>'), "hk"),
    ("irawan", _doc('<bsdf type="irawan"><string name="filename" '
                    'value="w.wv"/></bsdf>'), "irawan"),
    ("sunsky", _doc('<emitter type="sunsky"/>'), "sunsky"),
])
def test_unported_constructs_raise(tmp_path, what, doc, match):
    """What the JAX loader builds and the port lacks raises
    NotImplementedError naming the JAX module to port (on loading, or on
    make_integrator for an integrator)."""
    p = tmp_path / f"{what}.xml"
    p.write_text(doc)
    with pytest.raises(NotImplementedError, match=match):
        tload(str(p)).make_integrator()


def test_substitutions_warn_as_jax(tmp_path, monkeypatch):
    """An unsupported BSDF becomes diffuse, with a warning, in both
    loaders (ValueError under strict), and an unknown sensor becomes the
    default perspective camera; the scenes then agree."""
    p = tmp_path / "warn.xml"
    p.write_text(_doc('<shape type="cube"><bsdf type="velvet"/></shape>',
                      sensor="fisheye"))
    for load in (jload, tload):
        with pytest.warns(UserWarning, match="velvet"):
            load(str(p))
        with pytest.raises(ValueError, match="fisheye"):
            load(str(p), strict=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _compare(str(p), monkeypatch)


def test_twosided_id_names_the_material(tmp_path):
    """A <ref> to a twosided adapter's id binds the two-sided material
    (the JAX loader drops the adapter's id and binds material 0)."""
    p = tmp_path / "ts.xml"
    p.write_text(_doc('<bsdf type="diffuse" id="d"/>'
                      '<bsdf type="twosided" id="ts"><bsdf type="conductor"/>'
                      '</bsdf><shape type="cube"><ref id="ts"/></shape>'))
    t = tload(str(p))
    mat = t.desc.materials[t.desc.shapes[0].material]
    assert (mat.kind, mat.two_sided) == ("conductor", True)


def test_compile_defaults_to_the_card(monkeypatch):
    """LoadedScene.compile runs on cuda unless asked for the CPU, and
    raises without a card."""
    loaded = tload(os.path.join(ROOT, "scenes", "cornell.xml"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loaded.compile()
    assert loaded.compile(device="cpu").device.type == "cpu"


def _same_built(j, t):
    """Two built objects (an integrator, a camera) of the same class name
    whose dataclass fields the port has are equal, recursively through
    nested integrators."""
    assert type(t).__name__ == type(j).__name__
    for f in dataclasses.fields(t):
        if not f.init or f.name not in j.__dataclass_fields__:
            continue
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(a, tuple) and a and dataclasses.is_dataclass(a[0]):
            assert len(a) == len(b), f.name
            for x, y in zip(a, b):
                _same_built(y, x)
        elif dataclasses.is_dataclass(a):
            _same_built(b, a)
        elif isinstance(a, np.ndarray):
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, (f.name, a, b)


_KID = '<integrator type="{}">{}</integrator>'
_INTEGRATORS = {
    "ao": ("ao", '<integer name="maxDepth" value="3"/>'),
    "field": ("field", '<string name="field" value="distance"/>'),
    "info": ("info", '<string name="infoName" value="distance"/>'),
    "info_aaf": ("info", '<string name="infoName" value="filterSize"/>'),
    "multichannel": ("multichannel", "".join([
        _KID.format("path", '<integer name="maxDepth" value="3"/>'),
        _KID.format("field", '<string name="field" value="shNormal"/>'),
        _KID.format("ao", ""), _KID.format("direct", ""),
        _KID.format("volpath", '<integer name="rrDepth" value="2"/>')])),
    "baseFrameWiWo": ("baseFrameWiWo",
                      '<integer name="maxDepth" value="4"/>'),
    "adaptive": ("adaptive", '<float name="maxError" value="0.1"/>'
                 '<float name="pValue" value="0.01"/>'),
    # the light-subpath kinds: clamping kept for vpl only, pLarge dropped
    "bdpt": ("bdpt", '<integer name="maxDepth" value="5"/>'
             '<integer name="rrDepth" value="3"/>'
             '<float name="pLarge" value="0.3"/>'),
    "ptracer": ("ptracer", '<integer name="maxDepth" value="6"/>'),
    "vpl": ("vpl", '<integer name="maxDepth" value="5"/>'
            '<float name="clamping" value="0.3"/>'),
    "photonmapper": ("photonmapper", '<integer name="maxDepth" value="4"/>'
                     '<float name="clamping" value="0.3"/>'),
    "ppm": ("ppm", '<boolean name="hideEmitters" value="true"/>'),
    "sppm": ("sppm", '<integer name="rrDepth" value="7"/>'),
}


def _integrator_doc(tmp_path, name, kind, body):
    p = tmp_path / f"{name}.xml"
    p.write_text(_doc("").replace('<integrator type="path"/>',
                                  f'<integrator type="{kind}">{body}'
                                  '</integrator>'))
    return str(p)


@pytest.mark.parametrize("name", sorted(_INTEGRATORS))
def test_integrators_build_as_jax(tmp_path, name):
    """Each newly ported integrator kind builds the class and dataclass
    fields that the JAX loader builds, its nested children too."""
    p = _integrator_doc(tmp_path, name, *_INTEGRATORS[name])
    j, t = jload(p), tload(p)
    assert t.integrator_config == j.integrator_config
    _same_built(j.make_integrator(), t.make_integrator())


def test_adaptive_nested_child_builds(tmp_path):
    """An adaptive integrator with a nested <integrator> child: the JAX
    loader passes the child's "type" key to PathTracer and raises
    TypeError; the port builds the child as a multichannel child."""
    p = _integrator_doc(tmp_path, "ad", "adaptive", _KID.format(
        "path", '<integer name="maxDepth" value="3"/>'))
    with pytest.raises(TypeError, match="type"):
        jload(p).make_integrator()
    integ = tload(p).make_integrator()
    assert type(integ.child).__name__ == "PathTracer"
    assert integ.child.max_depth == 3
    p = _integrator_doc(tmp_path, "ad_ao", "adaptive", _KID.format("ao", ""))
    assert type(tload(p).make_integrator().child).__name__ == \
        "AmbientOcclusion"


_SENSOR_BODY = (
    '<transform name="toWorld"><scale x="1.5" y="0.7"/>'
    '<lookat origin="0.3, 0.8, 2.5" target="0.1, 0.2, -0.4" up="0, 1, 0"/>'
    '</transform>{}<film type="hdrfilm"><integer name="width" value="12"/>'
    '<integer name="height" value="8"/><rfilter type="tent"/></film>')
_SENSORS = {
    "orthographic": ("orthographic", ""),
    "spherical": ("spherical", ""),
    "telecentric": ("telecentric", '<float name="apertureRadius" '
                    'value="0.2"/><float name="focusDistance" value="1.7"/>'),
    "rdist": ("perspective_rdist", '<float name="fov" value="50"/>'
              '<string name="kc" value="-0.3, 0.05"/>'),
    "rdist_one": ("perspective_rdist", '<float name="kc" value="0.2"/>'),
    "radiancemeter": ("radiancemeter", ""),
    "irradiancemeter": ("irradiancemeter", ""),
}


@pytest.mark.parametrize("name", sorted(_SENSORS))
def test_sensors_build_as_jax(tmp_path, name):
    """Each newly ported sensor kind builds the camera and film the JAX
    loader builds: the class, its fields and to_world (kc parsed as JAX
    parses it; a meter on a 1×1 box film)."""
    kind, props = _SENSORS[name]
    p = tmp_path / f"{name}.xml"
    p.write_text(f'<scene version="0.5.0"><sensor type="{kind}">'
                 + _SENSOR_BODY.format(props) + "</sensor></scene>")
    j, t = jload(str(p)), tload(str(p))
    _same_built(j.camera, t.camera)
    for f in FILM_FIELDS:
        assert getattr(t.film, f) == getattr(j.film, f), f
    if kind.endswith("meter"):
        assert (t.film.width, t.film.height) == (1, 1)
