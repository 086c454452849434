"""The port's command-line renderer (cli.py) on the CPU: the Cornell scene
file (ldsampler, tent filter) through `cli` against the JAX package's
render of the same file, and the flags -x, -r, -o .pfm and -p (gloo ranks,
bit-equal to one process)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mitsuba_tpu_torch import cli
from mitsuba_tpu_torch.io import image as timage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(ROOT, "scenes", "cornell.xml")

torch.set_num_threads(2)

# a small box-filter scene with the independent sampler: a floor, a back
# wall, a cube and an area light
_SMALL = """<scene version="0.5.0">
  <integrator type="path"><integer name="maxDepth" value="4"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="toWorld">
      <lookat origin="0, 1, 3" target="0, 0.3, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="16"/><integer name="height" value="12"/>
    </film>
    <sampler type="independent"><integer name="sampleCount" value="16"/></sampler>
  </sensor>
  <bsdf type="diffuse" id="w"><rgb name="reflectance" value="0.7"/></bsdf>
  <shape type="rectangle">
    <transform name="toWorld"><scale value="2"/><rotate x="1" angle="-90"/></transform>
    <ref id="w"/>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld"><scale value="2"/><translate z="-1"/></transform>
    <ref id="w"/>
  </shape>
  <shape type="cube">
    <transform name="toWorld"><scale value="0.3"/><translate y="0.3"/></transform>
    <bsdf type="roughconductor"><float name="alpha" value="0.2"/></bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld"><scale value="0.5"/><rotate x="1" angle="90"/>
      <translate y="2"/></transform>
    <ref id="w"/>
    <emitter type="area"><rgb name="radiance" value="8"/></emitter>
  </shape>
</scene>
"""


@pytest.fixture
def small(tmp_path):
    p = tmp_path / "small.xml"
    p.write_text(_SMALL)
    return str(p)


def test_cornell_cli_matches_jax_render(tmp_path):
    """`cli` on scenes/cornell.xml at -s 2 -d 3 on the CPU, read back from
    its EXR, against the JAX render of the JAX-loaded file at the same
    overrides (ldsampler, tent filter): the rules of
    tests/test_render.py:44-48. The file carries the annotations."""
    from mitsuba_tpu.render import render as jrender
    from mitsuba_tpu.scene.xml import load_xml as jload
    out = str(tmp_path / "c.exr")
    (res,) = cli.run([CORNELL, "-o", out, "-s", "2", "-d", "3",
                      "--device", "cpu", "-q"])
    img = timage.read_exr(out)
    assert np.array_equal(img, res.image)
    assert (res.route, res.device, res.spp) == ("eager", "cpu", 2)
    assert res.n_rays > 0
    ann = timage.read_exr_annotations(out)
    assert ann["spp"] == 2 and ann["generatedBy"] == "mitsuba_tpu_torch"

    j = jload(CORNELL)
    j.integrator_config["max_depth"] = 3
    scene = j.compile()
    integ = j.make_integrator().specialized_for(scene)
    integ = dataclasses.replace(integ, sampler=j.sampler, spp=2)
    assert (integ.sampler, j.film.filter_name) == ("ldsampler", "tent")
    ref = np.asarray(jrender(scene, j.camera, j.film, integ, 2, 0))
    print("max abs difference", np.abs(img - ref).max())
    rel = np.abs(img - ref) / np.maximum(ref, 1e-3)
    assert (rel > 5e-2).mean() < 1e-2, (rel > 5e-2).mean()
    assert np.abs(img.mean() - ref.mean()) / ref.mean() < 5e-3


def test_skip_existing_and_pfm(small, tmp_path):
    """-o .pfm writes a PFM equal to the image; -x skips a scene whose
    output exists, leaving the file as it was."""
    out = str(tmp_path / "s.pfm")
    (res,) = cli.run([small, "-o", out, "-s", "2", "--device", "cpu", "-q"])
    assert np.array_equal(timage.read_pfm(out), res.image)
    before = os.stat(out).st_mtime_ns
    assert cli.run([small, "-o", out, "-x", "--device", "cpu", "-q"]) == []
    assert os.stat(out).st_mtime_ns == before
    assert cli.main([small, "-o", out, "-x", "--device", "cpu", "-q"]) == 0


def test_refresh_writes_partials(small, tmp_path, monkeypatch):
    """-r renders in passes of REFRESH_CHUNK spp, flushing the running
    mean after each pass but the last; the final image is the passes'
    mean, each pass render_fn at seed + its first sample."""
    from mitsuba_tpu_torch.render import render_fn
    from mitsuba_tpu_torch.scene.xml import load_xml
    written = []
    real = timage.write_image
    monkeypatch.setattr(timage, "write_image",
                        lambda p, im: (written.append(np.array(im)),
                                       real(p, im)))
    out = str(tmp_path / "r.pfm")
    (res,) = cli.run([small, "-o", out, "-s", "16", "-r", "1e-9",
                      "--device", "cpu", "-q"])
    assert len(written) == 2              # one partial, then the final
    loaded = load_xml(small)
    scene = loaded.compile(device="cpu")
    integ = loaded.make_integrator()
    passes = [render_fn(scene, loaded.camera, loaded.film, integ, 8, s,
                        device="cpu")[0] for s in (0, 8)]
    np.testing.assert_array_equal(written[0], passes[0].numpy())
    want = ((passes[0] * 8 + passes[1] * 8) / 16).numpy()
    np.testing.assert_array_equal(res.image, want)
    np.testing.assert_array_equal(timage.read_pfm(out), want)


def test_two_ranks_equal_one(small, tmp_path):
    """-p 2 (two spawned gloo ranks on the CPU), run in a process of its
    own that has imported neither jax nor mitsuba_tpu when it ends,
    writes the image -p 1 writes, bit for bit (box filter: every pixel's
    samples come from one rank)."""
    one, two = str(tmp_path / "one.exr"), str(tmp_path / "two.exr")
    (r1,) = cli.run([small, "-o", one, "-s", "3", "-p", "1",
                     "--device", "cpu", "-q"])
    argv = [small, "-o", two, "-s", "3", "-p", "2", "--device", "cpu", "-q"]
    code = ("import sys\n"
            "from mitsuba_tpu_torch import cli\n"
            f"(res,) = cli.run({argv!r})\n"
            "assert res.image.shape == (12, 16, 3), res.image.shape\n"
            "assert (res.route, res.n_rays) == ('eager', None)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'mitsuba_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)
    assert np.array_equal(timage.read_exr(one), timage.read_exr(two))
    assert np.array_equal(timage.read_exr(one), r1.image)


def test_cuda_default_without_card(small, monkeypatch):
    """The CLI runs on cuda unless given --device cpu, and raises without
    a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([small, "-s", "1", "-q"])


_PATH_LINE = '<integrator type="path"><integer name="maxDepth" value="4"/>' \
    '</integrator>'
_ADAPTIVE = ('<integrator type="adaptive"><float name="maxError" '
             'value="0.1"/><integrator type="path"><integer name="maxDepth" '
             'value="3"/></integrator></integrator>')
_MULTI = ('<integrator type="multichannel"><integrator type="path">'
          '<integer name="maxDepth" value="3"/></integrator>'
          '<integrator type="field"><string name="field" value="distance"/>'
          '</integrator></integrator>')


def _small_with(tmp_path, name, integrator):
    assert _PATH_LINE in _SMALL
    p = tmp_path / f"{name}.xml"
    p.write_text(_SMALL.replace(_PATH_LINE, integrator))
    return str(p)


def test_adaptive_renders_through_render_full(tmp_path, monkeypatch):
    """An adaptive scene renders through AdaptiveSampler.render_full (two
    batches of 16 at -s 32), on the eager route, to the image that
    render_full gives the loaded scene, and the EXR reads back as it."""
    from mitsuba_tpu_torch.integrator.adaptive import AdaptiveSampler
    from mitsuba_tpu_torch.scene.xml import load_xml
    path = _small_with(tmp_path, "ad", _ADAPTIVE)
    calls = []
    full = AdaptiveSampler.render_full
    monkeypatch.setattr(AdaptiveSampler, "render_full",
                        lambda self, *a, **k: calls.append(a[3])
                        or full(self, *a, **k))
    out = str(tmp_path / "ad.exr")
    (res,) = cli.run([path, "-o", out, "-s", "32", "--device", "cpu", "-q"])
    assert calls == [32]
    assert (res.route, res.refused) == ("eager", "integrator AdaptiveSampler")
    loaded = load_xml(path)
    want = loaded.make_integrator().render_full(
        loaded.compile(device="cpu"), loaded.camera, loaded.film, 32, 0,
        device="cpu")
    assert np.array_equal(res.image, want.numpy())
    assert np.array_equal(timage.read_exr(out), res.image)


def test_multichannel_and_adaptive_through_the_command(tmp_path):
    """`python -m mitsuba_tpu_torch ad.xml mc.xml --device cpu -s 4`: the
    multichannel scene's EXR has its named channel groups (path.*,
    distance.*), each equal to MultiChannelIntegrator.render of the loaded
    scene, and the adaptive scene's EXR (one batch of 16) is a finite RGB
    image."""
    from mitsuba_tpu_torch.scene.xml import load_xml
    ad = _small_with(tmp_path, "ad", _ADAPTIVE)
    mc = _small_with(tmp_path, "mc", _MULTI)
    # two intra-op threads, as this module's own torch has: the suite's
    # workers share the machine's cores
    proc = subprocess.run(
        [sys.executable, "-m", "mitsuba_tpu_torch", ad, mc, "--device",
         "cpu", "-s", "4", "-q"], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = load_xml(mc)
    integ = loaded.make_integrator()
    names = integ.channel_names()
    assert names == [f"{g}.{c}" for g in ("path", "distance")
                     for c in "RGB"]
    out = mc.replace(".xml", ".exr")
    stored = timage.read_exr_channel_names(out)
    assert stored == sorted(names)
    want = integ.render(loaded.compile(device="cpu"), loaded.camera,
                        loaded.film, 4, 0, device="cpu").numpy()
    back = timage.read_exr(out)
    assert back.shape == (12, 16, 6)
    assert np.array_equal(back, want[..., [names.index(c) for c in stored]])
    img = timage.read_exr(ad.replace(".xml", ".exr"))
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0


_CORNELL_PATH = ('<integrator type="path">\n    <integer name="maxDepth" '
                 'value="4"/>\n  </integrator>')


def _cornell_as(tmp_path, kind):
    """scenes/cornell.xml at 8×8 with the integrator `kind` (the file's
    maxDepth 4), written to tmp_path."""
    with open(CORNELL) as f:
        text = f.read()
    assert _CORNELL_PATH in text and text.count('value="32"') == 2
    p = tmp_path / f"cornell_{kind}.xml"
    p.write_text(text.replace(_CORNELL_PATH, _CORNELL_PATH.replace(
        '"path"', f'"{kind}"')).replace('value="32"', 'value="8"'))
    return str(p)


def _jax_cli(path, tmp_path, *args):
    """The JAX command line's image of a scene file (a .npy output)."""
    from mitsuba_tpu import cli as jcli
    out = str(tmp_path / (os.path.basename(path) + ".npy"))
    assert jcli.main([path, "-o", out, "-q", *args]) == 0
    return np.load(out)


def _image_rule(img, ref):
    """tests/test_render.py:44-48: < 1% of values off by rel > 5e-2, and
    the means within rel 5e-3."""
    rel = np.abs(img - ref) / np.maximum(ref, 1e-3)
    assert (rel > 5e-2).mean() < 1e-2, (rel > 5e-2).mean()
    assert np.abs(img.mean() - ref.mean()) / ref.mean() < 5e-3


@pytest.mark.parametrize("kind,depth", [("bdpt", "3"), ("vpl", "2")])
def test_light_subpath_kinds_match_jax_cli(tmp_path, kind, depth):
    """An 8×8 cornell.xml under bdpt (-d 3) and vpl (-d 2: the 256
    emitter VPLs, as the file's 3,976 triangles make every shadow ray
    cost 4,096 tests on the CPU) at -s 2 --device cpu: the eager route
    through render_fn (the JAX command line's route, its render() a
    pass), the log naming the integrator, and the image within the image
    rule of the JAX command line's."""
    path = _cornell_as(tmp_path, kind)
    args = ["-s", "2", "-d", depth]
    (res,) = cli.run([path, "-o", str(tmp_path / "o.exr"), *args,
                      "--device", "cpu", "-q"])
    name = {"bdpt": "BDPT", "vpl": "VPLIntegrator"}[kind]
    assert (res.route, res.refused) == ("eager", f"integrator {name}")
    assert res.n_rays > 0 and res.image.shape == (8, 8, 3)
    _image_rule(res.image, _jax_cli(path, tmp_path, *args))


def test_ptracer_scene_file_is_path_traced(tmp_path):
    """Both command lines path-trace a ptracer scene file (ROADMAP.md Queue
    C): the JAX one renders through render() → li, which ParticleTracer
    inherits, and so does the port's. The port's image equals its own
    path scene's bit for bit, and the JAX command line's ptracer image
    agrees with it under the image rule (a light-traced image would not)."""
    ptracer = _cornell_as(tmp_path, "ptracer")
    args = ["-s", "2", "-d", "3"]
    (res,) = cli.run([ptracer, "-o", str(tmp_path / "p.exr"), *args,
                      "--device", "cpu", "-q"])
    (path,) = cli.run([_cornell_as(tmp_path, "path"), "-o",
                       str(tmp_path / "q.exr"), *args, "--device", "cpu",
                       "-q"])
    assert res.refused == "integrator ParticleTracer"
    assert np.array_equal(res.image, path.image)
    _image_rule(_jax_cli(ptracer, tmp_path, *args), res.image)
