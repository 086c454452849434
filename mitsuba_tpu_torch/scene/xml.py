"""Mitsuba-compatible XML scene loader (port of mitsuba_tpu/scene/xml.py).

Counterpart of the reference's SceneHandler (ref: src/librender/
scenehandler.cpp:157-824): parses Mitsuba 0.5/0.6 scene XML into a
SceneDesc + camera + film + integrator config. It covers what the JAX
loader covers:

  * $key parameter substitution (CLI -D equivalent; scenehandler.cpp
    ParameterMap) and <default name value>, <include>, <alias>, and the
    upgrade of 0.3/0.4 documents to the 0.5 vocabulary
  * <integrator> with its common params and nested children
    (LoadedScene.make_integrator)
  * <sensor type="perspective|thinlens|orthographic|spherical|
    telecentric|perspective_rdist|radiancemeter|irradiancemeter"> +
    <transform name="toWorld"> (lookat/translate/rotate/scale/matrix) +
    nested <film> (width/height/rfilter/banner/componentFormat/
    compression; a meter's film is 1×1 box) + <sampler type count>
  * <shape type="rectangle|cube|sphere|disk|cylinder|heightfield|obj|
    ply|serialized"> with inline <bsdf> or <ref id>, optional area
    <emitter>
  * <bsdf> types matching builder.Material kinds (+ twosided, normal and
    bump maps, the composites)
  * <emitter type="area|point|constant|envmap">
  * <texture type="checkerboard|gridtexture|scale|bitmap|wireframe|
    curvature|vertexcolors">
  * <medium type="homogeneous"> (global)

Where the JAX loader warns and substitutes (an unsupported BSDF becomes
diffuse, an unknown sensor perspective, a missing texture file gray),
this loader warns and substitutes the same way, and raises ValueError
under strict=True. Where the JAX loader builds something the port does
not have (the hk and irawan BSDFs, the hair shape, the sun and sky
emitters, the integrators of _JAX_INTEGRATORS), it raises
NotImplementedError naming the JAX module to port.
"""
from __future__ import annotations

import os
import warnings
import xml.etree.ElementTree as ET
from dataclasses import dataclass

import numpy as np

from ..core import transform as tfm
from ..film.film import Film
from ..sensor.sensor import (IrradianceMeter, OrthographicCamera,
                             PerspectiveCamera, PerspectiveRDistCamera,
                             RadianceMeter, SphericalCamera,
                             TelecentricCamera)
from . import shapes
from .builder import (ConstantLight, EnvmapLight, Medium, PointLight,
                      SceneDesc)

# the JAX modules behind what the JAX loader builds and the port lacks
_JAX_INTEGRATORS = {
    "volpath_hetero": "integrator/hetero.py (HeteroVolPathTracer)",
    "pssmlt": "integrator/pssmlt.py", "mlt": "integrator/mlt.py",
    "erpt": "integrator/erpt.py", "irrcache": "integrator/irrcache.py",
    "dipole": "integrator/dipole.py",
    "singlescatter": "integrator/singlescatter.py",
}


def _unported(what: str, module: str):
    return NotImplementedError(
        f"{what}: not in the port; port mitsuba_tpu/{module}")


@dataclass
class LoadedScene:
    """A loaded scene file: its description, camera, film, integrator
    config, sampler kind and sample count."""
    desc: SceneDesc
    camera: object
    film: Film
    integrator_config: dict
    sampler: str = "independent"
    spp: int = 16

    def compile(self, cluster_size: int = 512, device="cuda"):
        """The compiled SceneData on `device` (the GPU unless the caller
        passes device="cpu")."""
        from .builder import compile_scene
        return compile_scene(self.desc, cluster_size, device=device)

    def make_integrator(self):
        """The integrator of integrator_config, built as the JAX loader
        builds it (mitsuba_tpu/scene/xml.py:71-142). The kinds path,
        volpath, volpath_simple, direct, prb, ao, field, info,
        multichannel, baseFrameWiWo, adaptive, bdpt, ptracer, vpl,
        photonmapper, ppm and sppm (the last three PhotonMapper) are
        ported; the others raise NotImplementedError naming the JAX
        module."""
        from ..integrator.adaptive import AdaptiveSampler
        from ..integrator.bdpt import BDPT
        from ..integrator.direct import DirectIntegrator
        from ..integrator.misc import AmbientOcclusion, FieldIntegrator
        from ..integrator.multichannel import MultiChannelIntegrator
        from ..integrator.path import PathTracer
        from ..integrator.photonmap import PhotonMapper
        from ..integrator.prb import PRBPathTracer
        from ..integrator.ptracer import ParticleTracer
        from ..integrator.volpath import VolPathTracer
        from ..integrator.vpl import VPLIntegrator
        cfg = dict(self.integrator_config)
        kind = cfg.pop("type", "path")
        if kind in _JAX_INTEGRATORS:
            raise _unported(f"integrator {kind!r}", _JAX_INTEGRATORS[kind])
        child_cfg = cfg.pop("child", None)
        children_cfg = cfg.pop("children", None) or []
        kinds = {"field": FieldIntegrator, "ao": AmbientOcclusion,
                 "direct": DirectIntegrator, "volpath": VolPathTracer}

        def make(cc):
            cc = dict(cc)
            return kinds.get(cc.pop("type", "path"), PathTracer)(**cc)

        if kind == "multichannel":
            return MultiChannelIntegrator(
                children=tuple(make(cc) for cc in children_cfg),
                names=tuple(cc.get("field", cc.get("type", f"ch{i}"))
                            for i, cc in enumerate(children_cfg)))
        if kind == "info":
            # info.cpp's normal and distance maps; every other infoName
            # (the AAF's filter size among them) gives the shading normal
            field = {"normal": "shNormal", "distance": "distance"}.get(
                cfg.pop("infoName", "normal"), "shNormal")
            return FieldIntegrator(field=field)
        if kind == "baseFrameWiWo":
            # the render beside per-pixel wi and wo in the shading frame
            # (baseFrameWiWo.cpp writes wiMacro.exr and woMacro.exr)
            return MultiChannelIntegrator(
                children=(PathTracer(**cfg),
                          FieldIntegrator(field="wiMacro"),
                          FieldIntegrator(field="woMacro")),
                names=("radiance", "wiMacro", "woMacro"))
        if kind == "adaptive":
            # a nested child is built as a multichannel child is (the JAX
            # loader passes its "type" key to PathTracer and fails)
            child = make(child_cfg) if child_cfg else PathTracer()
            kw = {k: cfg[k] for k in ("max_error", "p_value") if k in cfg}
            return AdaptiveSampler(child=child, **kw)
        for k in ("max_error", "p_value", "p_large"):
            cfg.pop(k, None)
        if kind != "vpl":
            cfg.pop("clamping", None)
        cls = {"path": PathTracer, "volpath": VolPathTracer,
               "volpath_simple": VolPathTracer,
               "direct": DirectIntegrator, "prb": PRBPathTracer,
               "ao": AmbientOcclusion, "field": FieldIntegrator,
               "bdpt": BDPT, "ptracer": ParticleTracer,
               "photonmapper": PhotonMapper, "ppm": PhotonMapper,
               "sppm": PhotonMapper, "vpl": VPLIntegrator}[kind]
        return cls(**cfg)


def _subst(s: str, params: dict) -> str:
    if "$" in s:
        for k, v in params.items():
            s = s.replace(f"${k}", str(v))
    return s


def _props(elem, params) -> dict:
    """Collect typed child properties into a dict (Properties analog)."""
    out = {}
    for ch in elem:
        name = ch.get("name", "")
        val = _subst(ch.get("value", ""), params)
        if ch.tag in ("float",):
            out[name] = float(val)
        elif ch.tag == "integer":
            out[name] = int(val)
        elif ch.tag == "boolean":
            out[name] = val.lower() == "true"
        elif ch.tag == "string":
            out[name] = val
        elif ch.tag in ("rgb", "srgb", "spectrum"):
            out[name] = _parse_rgb(val)
        elif ch.tag in ("point", "vector"):
            if ch.get("x") is not None:
                out[name] = [float(_subst(ch.get(a, "0"), params))
                             for a in "xyz"]
            else:
                out[name] = [float(x) for x in val.replace(",", " ").split()]
    return out


def _parse_rgb(val: str):
    parts = val.replace(",", " ").split()
    if len(parts) == 1:
        return [float(parts[0])] * 3
    return [float(x) for x in parts[:3]]


def _parse_transform(elem, params) -> np.ndarray:
    m = tfm.identity()
    for ch in elem:
        g = lambda a, dflt="0": float(_subst(ch.get(a, dflt), params))
        if ch.tag == "translate":
            t = tfm.translate([g("x"), g("y"), g("z")])
        elif ch.tag == "scale":
            if ch.get("value") is not None:
                s = float(_subst(ch.get("value"), params))
                t = tfm.scale([s, s, s])
            else:
                t = tfm.scale([g("x", "1"), g("y", "1"), g("z", "1")])
        elif ch.tag == "rotate":
            t = tfm.rotate([g("x"), g("y"), g("z")],
                           float(_subst(ch.get("angle", "0"), params)))
        elif ch.tag in ("lookat", "lookAt"):
            spl = lambda a: [float(x) for x in
                             _subst(ch.get(a), params).replace(",", " ")
                             .split()]
            t = tfm.look_at(spl("origin"), spl("target"), spl("up"))
        elif ch.tag == "matrix":
            vals = [float(x) for x in
                    _subst(ch.get("value"), params).split()]
            t = np.array(vals, np.float64).reshape(4, 4)
        else:
            continue
        m = t @ m
    return m


def _build_heightfield(p, base):
    """heightfield/tiled_heightfield (winmad shapes): heights from an
    image file (luminance) or a constant-resolution flat grid."""
    if "filename" in p:
        from ..io.image import read_image
        img = read_image(os.path.join(base, p["filename"]))
        hts = np.asarray(img, np.float64).mean(axis=-1)
    else:
        res = int(p.get("resolution", 64))
        hts = np.zeros((res, res))
    return shapes.heightfield(hts * float(p.get("scale", 1.0)))


def _build_hair(p, base):
    raise _unported("hair shape", "scene/shapes.py (hair, load_hair)")


_SHAPE_BUILDERS = {
    "rectangle": lambda p, base: shapes.rectangle(),
    "cube": lambda p, base: shapes.cube(),
    "sphere": lambda p, base: shapes.sphere(),
    "disk": lambda p, base: shapes.disk(),
    "cylinder": lambda p, base: shapes.cylinder(),
    "heightfield": _build_heightfield,
    "tiled_heightfield": _build_heightfield,
    # winmad LoD/composite variants choose a mip level of the same
    # heights (shapes.heightfield docstring) — identical load path
    "lod_heightfield": _build_heightfield,
    "composite_heightfield": _build_heightfield,
    "hair": _build_hair,
}

_BSDF_MAP = {
    "diffuse": "diffuse", "roughdiffuse": "roughdiffuse",
    "conductor": "conductor", "roughconductor": "roughconductor",
    "dielectric": "dielectric", "roughdielectric": "roughdielectric",
    "thindielectric": "thindielectric", "plastic": "plastic",
    "roughplastic": "roughplastic", "phong": "phong", "ward": "ward",
    "null": "null", "difftrans": "difftrans",
    # winmad LEADR rough diffuse (aniso_roughdiffuse{,_simple}.cpp —
    # the _simple variant differs only in its shader, not the BSDF)
    "aniso_roughdiffuse": "aniso_roughdiffuse",
    "aniso_roughdiffuse_simple": "aniso_roughdiffuse",
}


def _expand_includes(root, base, params, depth=0):
    """Splice <include filename="..."/> children in place (ref:
    scenehandler.cpp handles <include> by re-entrant SAX parse). Included
    files must themselves be <scene> documents; nesting is bounded."""
    if depth > 8:
        raise ValueError("<include> nesting too deep (cycle?)")
    i = 0
    while i < len(root):
        elem = root[i]
        if elem.tag == "include":
            fname = _subst(elem.get("filename", ""), params)
            sub = ET.parse(os.path.join(base, fname)).getroot()
            if sub.tag != "scene":
                raise ValueError(f"included {fname}: root must be <scene>")
            _expand_includes(sub, base, params, depth + 1)
            root.remove(elem)
            for j, child in enumerate(list(sub)):
                root.insert(i + j, child)
        else:
            i += 1


# pre-0.5 scene-format upgrades, the load-time equivalent of the
# reference's XSLT chain (ref: data/schema/upgrade_0.{3,4,5}.0.xsl)
_UPGRADE_TAGS = {"camera": "sensor", "luminaire": "emitter"}
_UPGRADE_PROPS = {"diffuseReflectance": "reflectance"}
_UPGRADE_TYPES = {"exrfilm": "hdrfilm", "pngfilm": "ldrfilm",
                  "lambertian": "diffuse", "microfacet": "roughplastic"}


def _upgrade_tree(root, version: str):
    """In-place upgrade of 0.3/0.4-era documents to the 0.5 vocabulary."""
    try:
        major, minor = (int(x) for x in version.split(".")[:2])
    except ValueError:
        return
    if (major, minor) >= (0, 5):
        return
    for elem in root.iter():
        if elem.tag in _UPGRADE_TAGS:
            elem.tag = _UPGRADE_TAGS[elem.tag]
        t = elem.get("type")
        if t in _UPGRADE_TYPES:
            elem.set("type", _UPGRADE_TYPES[t])
        n = elem.get("name")
        if n in _UPGRADE_PROPS:
            elem.set("name", _UPGRADE_PROPS[n])
    # 0.3 area luminaires used "intensity" for what 0.5 calls "radiance"
    for em in root.iter("emitter"):
        if em.get("type") == "area":
            for child in em:
                if child.get("name") == "intensity":
                    child.set("name", "radiance")


def load_xml(path: str, parameters: dict | None = None,
             strict: bool = False) -> LoadedScene:
    """Load a scene XML file. `parameters` supplies $key substitutions
    (the CLI -D mechanism, mitsuba.cpp:58)."""
    params = dict(parameters or {})
    base = os.path.dirname(os.path.abspath(path))
    tree = ET.parse(path)
    root = tree.getroot()
    assert root.tag == "scene", "root element must be <scene>"
    _expand_includes(root, base, params)
    if root.get("version"):
        _upgrade_tree(root, root.get("version"))

    desc = SceneDesc()
    camera = None
    film = Film()
    integrator_config = {"type": "path"}
    sampler_kind, spp = "independent", 16
    named_materials: dict[str, int] = {}
    geom_tex: dict[int, tuple] = {}   # mat id → deferred geometry texture

    def warn_or_raise(msg):
        if strict:
            raise ValueError(msg)
        warnings.warn(msg)

    def parse_bsdf(elem) -> int:
        btype = elem.get("type")
        if btype == "irawan":
            # woven cloth (ref: src/bsdfs/irawan.cpp:25-54)
            raise _unported("irawan BSDF", "bsdf/irawan.py")
        if btype == "hk":
            # Hanrahan-Krueger slab (ref: src/bsdfs/hk.cpp)
            raise _unported("hk BSDF", "bsdf/bsdf.py (hk_eval, hk_sample)")
        if btype == "twosided":
            inner = elem.find("bsdf")
            if inner is not None:
                mid = parse_bsdf(inner)
                desc.materials[mid].two_sided = True
                # the adapter's own id names the two-sided material (the
                # JAX loader drops it, so a <ref> to it falls back to
                # material 0 there)
                if elem.get("id"):
                    named_materials[elem.get("id")] = mid
                return mid
        if btype in ("normalmap", "bumpmap", "heightmap_bsdf"):
            # adapters: parse nested child, attach the perturbation texture
            # (ref: src/bsdfs/{normalmap,bumpmap}.cpp; heightmap_bsdf.cpp
            # is the winmad research variant of the same height-field
            # frame perturbation and maps onto the bumpmap path)
            inner = elem.find("bsdf")
            mid = parse_bsdf(inner) if inner is not None \
                else desc.add_material()
            for tex in elem.findall("texture"):
                timg = _parse_texture(tex)
                if isinstance(timg, np.ndarray):
                    desc.materials[mid].normal_texture = \
                        desc.add_texture(timg)
            if btype in ("bumpmap", "heightmap_bsdf"):
                desc.materials[mid].bump_scale = 1.0
            if elem.get("id"):
                named_materials[elem.get("id")] = mid
            return mid
        if btype in ("mixturebsdf", "blendbsdf", "mask", "coating",
                     "roughcoating"):
            p = _props(elem, params)
            children = [parse_bsdf(b) for b in elem.findall("bsdf")]
            for r in elem.findall("ref"):
                children.append(named_materials[r.get("id")])
            kw = {"kind": btype, "child_a": children[0] if children else 0}
            if btype == "mixturebsdf":
                ws = [float(x) for x in str(
                    p.get("weights", "0.5, 0.5")).replace(",", " ").split()]
                kw["child_b"] = children[1] if len(children) > 1 else 0
                kw["weight"] = ws[0] / max(sum(ws), 1e-9)
            elif btype == "blendbsdf":
                kw["child_b"] = children[1] if len(children) > 1 else 0
                kw["weight"] = float(p.get("weight", 0.5))
            elif btype == "mask":
                op = p.get("opacity", (0.5, 0.5, 0.5))
                kw["weight"] = (float(np.mean(op))
                                if not np.isscalar(op) else float(op))
            else:  # coating / roughcoating
                kw["int_ior"] = float(p.get("intIOR", 1.5046))
                kw["ext_ior"] = float(p.get("extIOR", 1.000277))
                kw["sigma_a"] = p.get("sigmaA", (0.0, 0.0, 0.0))
                kw["thickness"] = float(p.get("thickness", 1.0))
                if btype == "roughcoating":
                    kw["alpha"] = float(p.get("alpha", 0.1))
                    kw["distribution"] = str(
                        p.get("distribution", "ggx"))
            for tex in elem.findall("texture"):
                timg = _parse_texture(tex)
                if isinstance(timg, np.ndarray):
                    kw["weight_texture"] = desc.add_texture(timg)
            mid = desc.add_material(**kw)
            if elem.get("id"):
                named_materials[elem.get("id")] = mid
            return mid
        if btype not in _BSDF_MAP:
            warn_or_raise(f"unsupported bsdf type {btype} → diffuse")
            btype = "diffuse"
        p = _props(elem, params)
        kw = {"kind": _BSDF_MAP[btype]}
        if "reflectance" in p:
            kw["albedo"] = p["reflectance"]
            kw["diffuse_reflectance"] = p["reflectance"]
        if "diffuseReflectance" in p:
            kw["diffuse_reflectance"] = p["diffuseReflectance"]
        if "specularReflectance" in p:
            kw["specular_reflectance"] = p["specularReflectance"]
        if "specularTransmittance" in p:
            kw["specular_transmittance"] = p["specularTransmittance"]
        if "alpha" in p:
            kw["alpha"] = p["alpha"]
        if "alphaU" in p:
            kw["alpha"] = p["alphaU"]
        if "alphaV" in p:
            kw["alpha_v"] = p["alphaV"]
        if "distribution" in p:
            kw["distribution"] = p["distribution"]
        if "intIOR" in p:
            kw["int_ior"] = p["intIOR"]
        if "extIOR" in p:
            kw["ext_ior"] = p["extIOR"]
        if "eta" in p:
            kw["eta"] = p["eta"]
        if "k" in p:
            kw["k"] = p["k"]
        if "exponent" in p:
            kw["exponent"] = p["exponent"]
        if "transmittance" in p:
            kw["transmittance"] = p["transmittance"]
        for mk, nk, n in (("moments0", "moments0", 2),
                          ("moments1", "moments1", 3)):
            if mk in p:
                v = np.atleast_1d(np.asarray(p[mk], np.float64))[:n]
                # the reference stores LEADR moments with a +1e4 offset
                # to keep Spectrum values positive
                # (aniso_roughdiffuse.cpp m_offset); undo it here
                if np.all(v >= 1e3):
                    v = v - 1e4
                kw[nk] = tuple(v)
        if "sampleVisibility" in p:
            kw["sample_visibility"] = bool(p["sampleVisibility"])
        # texture child for reflectance
        pending_geom = None
        for tex in elem.findall("texture"):
            timg = _parse_texture(tex)
            if isinstance(timg, np.ndarray):
                kw["albedo_texture"] = desc.add_texture(timg)
            elif isinstance(timg, tuple) and timg[0] == "__geom__":
                pending_geom = timg[1:]
        mid = desc.add_material(**kw)
        if pending_geom is not None:
            geom_tex[mid] = pending_geom
        if elem.get("id"):
            named_materials[elem.get("id")] = mid
        return mid

    def _parse_texture(tex):
        ttype = tex.get("type")
        p = _props(tex, params)
        if ttype == "checkerboard":
            from ..texture.texture import checkerboard
            return checkerboard(color0=p.get("color0", (0.4,) * 3),
                                color1=p.get("color1", (0.2,) * 3))
        if ttype == "gridtexture":
            from ..texture.texture import grid_texture
            return grid_texture(color0=p.get("color0", (0.2,) * 3),
                                color1=p.get("color1", (0.4,) * 3),
                                line_width=float(p.get("lineWidth", 0.01)))
        if ttype == "scale":
            # pure multiplier, folded at compile time (scale.cpp)
            from ..texture.geomtex import scale_texture
            scale = p.get("scale", 1.0)
            inner = tex.find("texture")
            if inner is not None:
                nested = _parse_texture(inner)
                if isinstance(nested, np.ndarray):
                    return scale_texture(nested, scale)
                return nested          # marker or None: cannot fold
            val = p.get("value", (1.0, 1.0, 1.0))
            if np.isscalar(val):
                val = (val,) * 3
            return scale_texture(np.asarray(val, np.float32).reshape(
                1, 1, 3), scale)
        if ttype in ("wireframe", "curvature", "vertexcolors"):
            # geometry textures: baked per shape at the shape site
            # (texture/geomtex.py — needs the mesh, deferred via marker)
            return ("__geom__", ttype, p)
        if ttype == "bitmap" and "filename" in p:
            from ..io.image import read_exr, read_pfm
            fn = os.path.join(base, p["filename"])
            try:
                if fn.lower().endswith(".exr"):
                    return read_exr(fn)
                if fn.lower().endswith(".pfm"):
                    return read_pfm(fn)
                from PIL import Image
                from ..core.spectrum import from_srgb
                img = np.asarray(Image.open(fn).convert("RGB"),
                                 np.float32) / 255.0
                return from_srgb(img)
            except Exception as e:   # missing asset: flat gray
                warn_or_raise(f"texture load failed: {e}")
                return None
        warn_or_raise(f"unsupported texture type {ttype}")
        return None

    for elem in root:
        tag = elem.tag
        if tag == "default":
            params.setdefault(elem.get("name"), elem.get("value"))
        elif tag == "integrator":
            p = _props(elem, params)
            integrator_config = {"type": elem.get("type", "path")}
            if "maxDepth" in p:
                integrator_config["max_depth"] = p["maxDepth"]
            if "rrDepth" in p:
                integrator_config["rr_depth"] = p["rrDepth"]
            if "hideEmitters" in p:
                integrator_config["hide_emitters"] = p["hideEmitters"]
            for src, dst in (("pLarge", "p_large"),
                             ("clamping", "clamping"),
                             ("maxError", "max_error"),
                             ("pValue", "p_value")):
                if src in p:
                    integrator_config[dst] = p[src]
            if "field" in p:
                integrator_config["field"] = p["field"]
            if "infoName" in p:
                integrator_config["infoName"] = p["infoName"]
            if integrator_config["type"] in ("singlescatter", "dipole"):
                for src, dst in (("sigmaS", "sigma_s"),
                                 ("sigmaA", "sigma_a"),
                                 ("g", "g"), ("eta", "eta"),
                                 ("targetMat", "target_mat"),
                                 ("fssSamples", "fss_samples"),
                                 ("singleScatterDepth", "ss_depth")):
                    if src in p:
                        v = p[src]
                        integrator_config[dst] = (tuple(v)
                                                  if isinstance(v, list)
                                                  else v)
            # nested child integrators (adaptive/irrcache wrappers take
            # one; multichannel takes several — multichannel.cpp)
            kids = []
            for child in elem.findall("integrator"):
                cp = _props(child, params)
                cc = {"type": child.get("type", "path")}
                if "maxDepth" in cp:
                    cc["max_depth"] = cp["maxDepth"]
                if "rrDepth" in cp:
                    cc["rr_depth"] = cp["rrDepth"]
                if "field" in cp:
                    cc["field"] = cp["field"]
                kids.append(cc)
            if kids:
                integrator_config["child"] = kids[0]
                integrator_config["children"] = kids
        elif tag == "sensor":
            stype = elem.get("type", "perspective")
            p = _props(elem, params)
            to_world = tfm.identity()
            tr = elem.find("transform")
            if tr is not None:
                to_world = _parse_transform(tr, params)
            w, h, filt = 256, 256, "box"
            f_el = elem.find("film")
            if f_el is not None:
                fp = _props(f_el, params)
                w = int(fp.get("width", 256))
                h = int(fp.get("height", 256))
                rf = f_el.find("rfilter")
                if rf is not None:
                    filt = {"box": "box", "tent": "tent",
                            "gaussian": "gaussian", "mitchell": "mitchell",
                            "catmullrom": "catmullrom",
                            "lanczos": "lanczos"}.get(
                                rf.get("type", "box"), "box")
            film = Film(width=w, height=h, filter_name=filt,
                        banner=str(fp.get("banner", "false")).lower()
                        in ("true", "1") if f_el is not None else False,
                        component_format=str(fp.get(
                            "componentFormat", "float32"))
                        if f_el is not None else "float32",
                        compression=str(fp.get("compression", "zip"))
                        if f_el is not None else "zip")
            if stype in ("perspective", "thinlens"):
                camera = PerspectiveCamera(
                    width=w, height=h, fov_x=float(p.get("fov", 39.0)),
                    to_world=to_world,
                    aperture_radius=float(p.get("apertureRadius", 0.0)),
                    focus_distance=float(p.get("focusDistance", 1.0)))
            elif stype == "orthographic":
                camera = OrthographicCamera(width=w, height=h,
                                            to_world=to_world)
            elif stype == "spherical":
                camera = SphericalCamera(width=w, height=h,
                                         to_world=to_world)
            elif stype == "telecentric":
                camera = TelecentricCamera(
                    width=w, height=h, to_world=to_world,
                    aperture_radius=float(p.get("apertureRadius", 0.0)),
                    focus_distance=float(p.get("focusDistance", 1.0)))
            elif stype == "perspective_rdist":
                kc = p.get("kc", [0.0, 0.0])
                if isinstance(kc, str):
                    kc = [float(x) for x in kc.replace(",", " ").split()]
                elif isinstance(kc, (int, float)):
                    kc = [float(kc), 0.0]
                camera = PerspectiveRDistCamera(
                    width=w, height=h, fov_x=float(p.get("fov", 39.0)),
                    to_world=to_world, kc0=float(kc[0]),
                    kc1=float(kc[1]) if len(kc) > 1 else 0.0)
            elif stype in ("radiancemeter", "irradiancemeter"):
                meter = RadianceMeter if stype == "radiancemeter" \
                    else IrradianceMeter
                camera = meter(to_world=to_world)
                film = Film(width=1, height=1, filter_name="box")
            else:
                warn_or_raise(f"unsupported sensor {stype} → perspective")
                camera = PerspectiveCamera(width=w, height=h,
                                           to_world=to_world)
            s_el = elem.find("sampler")
            if s_el is not None:
                sampler_kind = {"independent": "independent",
                                "stratified": "stratified",
                                "ldsampler": "ldsampler",
                                "halton": "halton",
                                "hammersley": "hammersley",
                                "sobol": "sobol"}.get(
                                    s_el.get("type"), "independent")
                sp = _props(s_el, params)
                spp = int(sp.get("sampleCount", 16))
        elif tag == "bsdf":
            parse_bsdf(elem)
        elif tag == "shape":
            stype = elem.get("type")
            p = _props(elem, params)
            to_world = tfm.identity()
            tr = elem.find("transform")
            if tr is not None:
                to_world = _parse_transform(tr, params)
            mesh = None
            obj_groups = None           # (mesh, material_idx) pairs
            if stype in _SHAPE_BUILDERS:
                mesh = _SHAPE_BUILDERS[stype](p, base)
                if stype == "sphere":
                    c = p.get("center", [0, 0, 0])
                    r = p.get("radius", 1.0)
                    to_world = to_world @ tfm.translate(c) @ tfm.scale(r)
            elif stype == "obj":
                from ..io.obj import load_obj
                has_bsdf = (elem.find("bsdf") is not None
                            or elem.find("ref") is not None)
                if has_bsdf:
                    groups, _ = load_obj(
                        os.path.join(base, p["filename"]),
                        split_groups=False)
                    mesh = groups[0].mesh
                else:
                    # no explicit BSDF: map MTL materials to BSDFs per
                    # group (ref: obj.cpp addMaterial Kd/Ks/Ns handling)
                    groups, mtls = load_obj(
                        os.path.join(base, p["filename"]))
                    obj_groups = []
                    mtl_ids: dict = {}
                    for g in groups:
                        name = g.material_name
                        if name not in mtl_ids:
                            md = mtls.get(name)
                            if md is None:
                                mtl_ids[name] = desc.add_material()
                            elif max(md["ks"]) > 0 and md["ns"] > 1:
                                mtl_ids[name] = desc.add_material(
                                    kind="phong", albedo=md["kd"],
                                    specular_reflectance=md["ks"],
                                    exponent=md["ns"])
                            else:
                                mtl_ids[name] = desc.add_material(
                                    kind="diffuse", albedo=md["kd"])
                        obj_groups.append((g.mesh, mtl_ids[name]))
            elif stype == "ply":
                from ..io.ply import load_ply
                mesh = load_ply(os.path.join(base, p["filename"]))
            elif stype == "serialized":
                from ..io.serialized import load_serialized
                mesh = load_serialized(os.path.join(base, p["filename"]),
                                       int(p.get("shapeIndex", 0)))
            else:
                warn_or_raise(f"unsupported shape {stype}; skipped")
                continue
            # material: inline bsdf or <ref id>
            mat = 0
            b_el = elem.find("bsdf")
            if b_el is not None:
                mat = parse_bsdf(b_el)
            else:
                ref = elem.find("ref")
                if ref is not None and ref.get("id") in named_materials:
                    mat = named_materials[ref.get("id")]
                elif not desc.materials:
                    mat = desc.add_material()
            radiance = None
            e_el = elem.find("emitter")
            if e_el is not None and e_el.get("type") == "area":
                ep = _props(e_el, params)
                radiance = ep.get("radiance", [1.0, 1.0, 1.0])
            flip = bool(p.get("flipNormals", False))
            if mat in geom_tex and mesh is not None:
                # geometry texture (wireframe/curvature/vertexcolors):
                # bake against THIS shape's mesh and bind a per-shape
                # material clone (texture/geomtex.py)
                import copy

                from ..texture import geomtex
                kind, tp = geom_tex[mat]
                if kind == "wireframe":
                    img = geomtex.wireframe_pattern(
                        mesh,
                        interior=tp.get("interiorColor", (0.5,) * 3),
                        edge=tp.get("edgeColor", (0.1,) * 3),
                        line_width=float(tp.get("lineWidth", 0.0)),
                        step_width=float(tp.get("stepWidth", 0.5)))
                    mesh = geomtex.deindex_barycentric(mesh)
                elif kind == "curvature":
                    img, mesh = geomtex.bake_curvature(
                        mesh, tp.get("curvature", "gaussian"),
                        float(tp.get("scale", 1.0)))
                else:                   # vertexcolors
                    if mesh.colors is None:
                        warn_or_raise(
                            "vertexcolors texture on a mesh without "
                            "vertex colors; using 0.5 gray")
                        cols = np.full((len(mesh.vertices), 3), 0.5)
                    else:
                        cols = mesh.colors
                    img, mesh = geomtex.bake_vertex_colors(mesh, cols)
                m2 = copy.deepcopy(desc.materials[mat])
                m2.albedo_texture = desc.add_texture(img)
                desc.materials.append(m2)
                mat = len(desc.materials) - 1
            if obj_groups is not None:
                for gmesh, gmat in obj_groups:
                    desc.add_shape(gmesh, to_world=to_world,
                                   material=gmat, radiance=radiance,
                                   flip_normals=flip)
            else:
                desc.add_shape(mesh, to_world=to_world, material=mat,
                               radiance=radiance, flip_normals=flip)
        elif tag == "emitter":
            etype = elem.get("type")
            p = _props(elem, params)
            if etype == "point":
                pos = p.get("position", [0, 0, 0])
                tr = elem.find("transform")
                if tr is not None:
                    pos = tfm.apply_point(_parse_transform(tr, params),
                                          np.zeros(3))
                desc.point_lights.append(PointLight(
                    position=pos, intensity=p.get("intensity", [1, 1, 1])))
            elif etype == "constant":
                desc.constant_light = ConstantLight(
                    radiance=p.get("radiance", [1, 1, 1]))
            elif etype == "envmap":
                from ..io.image import read_exr
                img = None
                if "filename" in p:
                    fn = os.path.join(base, p["filename"])
                    try:
                        img = read_exr(fn)
                    except Exception as e:
                        warn_or_raise(f"envmap load failed: {e}")
                if img is None:
                    img = np.ones((4, 8, 3), np.float32)
                desc.envmap = EnvmapLight(image=img,
                                          scale=float(p.get("scale", 1.0)))
            elif etype in ("sunsky", "sky", "sun"):
                # analytic daylight rasterised to an envmap (sky.cpp)
                raise _unported(f"emitter {etype!r}", "emitter/sunsky.py")
            else:
                warn_or_raise(f"unsupported emitter {etype}; skipped")
        elif tag == "medium":
            if elem.get("type") == "homogeneous":
                p = _props(elem, params)
                sigma_s = np.array(p.get("sigmaS", [1.0, 1.0, 1.0]))
                sigma_a = np.array(p.get("sigmaA", [0.0, 0.0, 0.0]))
                sigma_t = sigma_s + sigma_a
                albedo = np.where(sigma_t > 0, sigma_s / np.maximum(
                    sigma_t, 1e-9), 0.0)
                g = 0.0
                ph = elem.find("phase")
                if ph is not None and ph.get("type") == "hg":
                    g = float(_props(ph, params).get("g", 0.0))
                desc.medium = Medium(sigma_t=tuple(sigma_t),
                                     albedo=tuple(albedo), g=g)
            else:
                warn_or_raise(f"unsupported medium {elem.get('type')}")
        elif tag == "alias":
            # <alias id="existing" as="newname"/> — second handle for a
            # named object (ref: scenehandler.cpp alias handling); BSDFs
            # are the only ref target in this loader
            src, dst = elem.get("id"), elem.get("as")
            if src in named_materials and dst:
                named_materials[dst] = named_materials[src]
            else:
                warn_or_raise(f"<alias> of unknown id {src}")
        elif tag in ("include", "null"):
            # <include> is spliced before this loop; <null> is a no-op
            pass

    if camera is None:
        camera = PerspectiveCamera(width=film.width, height=film.height)
    return LoadedScene(desc=desc, camera=camera, film=film,
                       integrator_config=integrator_config,
                       sampler=sampler_kind, spp=spp)
