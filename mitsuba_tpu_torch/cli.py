"""Command-line renderer, the `mitsuba` executable analog (port of
mitsuba_tpu/cli.py).

Mirrors the reference CLI's core flags (ref: src/mitsuba/mitsuba.cpp:55-86):
scene XML in, image out, -D parameter substitution, -o output, spp/depth
overrides, periodic partial-image flush (-r), rendering over several
devices (-p), skipping existing outputs (-x) and the statistics table at
exit. `--device` (default cuda) picks where the scene compiles and
renders; asking for cuda with no card raises. Run as
`python -m mitsuba_tpu_torch scene.xml [options]`.

The route (as the JAX CLI chooses it): a plain PathTracer or VolPathTracer
with the independent sampler and no hide_emitters, on the card, on a
scene, camera and film that MegaPathTracer / MegaVolPathTracer.supports
admits, renders through the persistent megakernel (integrator/mega.py
render_persistent); everything else renders through render.py
render_fn, with the trace kernel on the card: BDPT, VPLIntegrator and
PhotonMapper (the bdpt, vpl, photonmapper, ppm and sppm kinds) through
their li_stats a pass, as the JAX CLI renders them through render(), and
a ptracer scene path-traced, since ParticleTracer's li_stats is
PathTracer's (the JAX CLI path-traces it too; the light tracer is
ParticleTracer.render). An integrator with its
own outer loop (render_full: the adaptive sampler) renders through it in
one call, as the JAX CLI does (mitsuba_tpu/cli.py:98-110); a
MultiChannelIntegrator renders through its own render, pass by pass, and
its EXR carries its channel names (the JAX CLI sends it through render()
and fails on the film's [H, W, 4] accumulator). Both are eager routes,
and under -p every rank renders the whole image (rank 0's is written).
The log names the route and, where the megakernel was refused, why.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import NamedTuple

# spp of one progressive pass under -r (the JAX CLI's chunk)
REFRESH_CHUNK = 8


class Rendered(NamedTuple):
    """One scene's result: the output path, the final image [H, W, C]
    (numpy float32, as written), the route ("megakernel" or "eager"), the
    megakernel's refusal reason ("" where it ran), rays traced (None
    where the route counts none), render seconds, spp, the device the
    scene rendered on, the film and the EXR channel names (None: RGB)."""
    path: str
    image: object
    route: str
    refused: str
    n_rays: int | None
    render_s: float
    spp: int
    device: str
    film: object
    channels: list | None = None


@dataclasses.dataclass(frozen=True)
class _Job:
    """What a render needs, in a form a spawned rank can take."""
    scene_path: str
    params: dict
    max_depth: int | None
    spp: int | None
    seed: int
    refresh: float
    out: str
    quiet: bool


def _parser():
    ap = argparse.ArgumentParser(
        prog="mitsuba_tpu_torch",
        description="PyTorch/CUDA path tracer (Mitsuba-compatible subset)")
    ap.add_argument("scene", nargs="+", help="scene .xml file(s); "
                    "several render back to back (mitsuba.cpp -j)")
    ap.add_argument("-o", "--output", default=None,
                    help="output image (exr/pfm/hdr/png/npy/m); default: "
                         "scene name + .exr")
    ap.add_argument("-D", action="append", default=[], metavar="key=value",
                    help="scene parameter substitution ($key in XML)")
    ap.add_argument("-s", "--spp", type=int, default=None,
                    help="override samples per pixel")
    ap.add_argument("-d", "--max-depth", type=int, default=None,
                    help="override path depth")
    ap.add_argument("-r", "--refresh", type=float, default=0.0,
                    help="write partial image every N seconds "
                         f"(progressive passes of {REFRESH_CHUNK} spp)")
    ap.add_argument("-p", "--devices", type=int, default=0,
                    help="render over N ranks, one process and device "
                         "each (0 = single)")
    ap.add_argument("-x", "--skip-existing", action="store_true",
                    help="skip scenes whose output already exists "
                         "(mitsuba.cpp:78 -x)")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to compile and render on "
                         "(default cuda; cpu for CPU runs)")
    return ap


def run(argv=None) -> list[Rendered]:
    """Parse argv as the command line does and render every scene; the
    results in order (scenes skipped under -x give none)."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.output is not None and len(args.scene) > 1:
        ap.error("-o is only valid with a single scene")
    out = []
    for scene_path in args.scene:
        res = _render_one(args, scene_path)
        if res is not None:
            out.append(res)
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


def _render_one(args, scene_path: str) -> Rendered | None:
    from .device import resolve_device
    from .util.stats import counter_add, log, print_stats

    params = {}
    for kv in args.D:
        k, _, v = kv.partition("=")
        params[k] = v
    out = args.output or (scene_path.rsplit(".", 1)[0] + ".exr")
    if args.skip_existing and os.path.exists(out):
        log.info("Skipping %s: %s exists (-x)", scene_path, out)
        return None
    device = resolve_device(args.device)
    job = _Job(scene_path, params, args.max_depth, args.spp, args.seed,
               args.refresh, out, args.quiet)
    if args.devices > 1:
        from .parallel import dist
        if device.type == "cuda":      # one nvcc run, not one a rank
            from .accel import megakernel, trace
            trace.build()
            megakernel.build()
        log.info("Rendering over %d ranks (%s)", args.devices, device.type)
        res = Rendered(*dist.launch(_rank_render, args.devices, job,
                                    device=device.type)[0])
    else:
        res = _render(job, device, None)
    _write(res, job)
    if res.n_rays is not None:
        counter_add("Rays traced", res.n_rays)
    counter_add("Render time (s)", res.render_s)
    counter_add("Samples per pixel", res.spp)
    counter_add("Pixels", res.image.shape[0] * res.image.shape[1])
    if not args.quiet:
        log.info("Wrote %s (%.2fs render)", out, res.render_s)
        print_stats()
    return res


def _rank_render(mesh, job: _Job) -> tuple:
    """One rank of a -p render (parallel/dist.py launch): the Rendered
    fields as a plain tuple, which crosses the process boundary."""
    return tuple(_render(job, mesh.device, mesh))


def _setup(job: _Job, device):
    """(loaded scene, compiled scene, integrator, spp, megakernel
    integrator or None, refusal reason)."""
    from .integrator.path import PathTracer
    from .integrator.volpath import VolPathTracer
    from .scene.xml import load_xml
    from .util.stats import log

    t0 = time.time()
    log.info("Loading scene %s", job.scene_path)
    loaded = load_xml(job.scene_path, parameters=job.params)
    if job.max_depth is not None:
        loaded.integrator_config["max_depth"] = job.max_depth
    spp = job.spp if job.spp is not None else loaded.spp
    scene = loaded.compile(device=device)
    integ = loaded.make_integrator()
    if loaded.sampler != "independent" and hasattr(integ, "sampler"):
        integ = dataclasses.replace(integ, sampler=loaded.sampler, spp=spp)
    if hasattr(integ, "specialized_for"):
        integ = integ.specialized_for(scene)
    log.info("Scene compiled: %d triangles, %d emitters (%.2fs)",
             int((scene.tri_area > 0).sum()), int(scene.em_type.shape[0]),
             time.time() - t0)

    mega, why = None, ""
    if type(integ) not in (PathTracer, VolPathTracer):
        why = f"integrator {type(integ).__name__}"
    elif loaded.sampler != "independent":
        why = f"sampler {loaded.sampler}"
    elif integ.hide_emitters:
        why = "hide_emitters"
    elif scene.device.type != "cuda":
        why = f"device {scene.device.type} (the megakernel runs on the card)"
    else:
        from .integrator.mega import MegaPathTracer, MegaVolPathTracer
        # volpath scenes with a global homogeneous medium compile the
        # medium branch into the same persistent kernel
        klass = MegaVolPathTracer if type(integ) is VolPathTracer \
            else MegaPathTracer
        tex_procs = loaded.desc.tex_procs
        ok, why = klass.supports(scene, loaded.camera, loaded.film,
                                 tex_procs=tex_procs)
        if ok:
            mega = klass.for_scene(scene, max_depth=integ.max_depth,
                                   rr_depth=integ.rr_depth,
                                   tex_procs=tex_procs)
    if mega is not None:
        log.info("Route: megakernel (render_persistent, %s) on %s",
                 type(mega).__name__, scene.device.type)
    else:
        entry = next((e for e in ("render_full", "render_stats")
                      if hasattr(integ, e)), "render_fn")
        log.info("Route: eager (%s, %s) on %s; megakernel refused: %s",
                 entry, type(integ).__name__, scene.device.type, why)
    return loaded, scene, integ, spp, mega, why


def _render(job: _Job, device, mesh) -> Rendered:
    """Render one scene on `device` (over the ranks of `mesh` where it is
    not None): progressive passes of REFRESH_CHUNK spp under -r, each
    flushed as a partial image when -r seconds have passed (by rank 0)."""
    from .integrator.mega import render_persistent, render_persistent_sharded
    from .integrator.multichannel import MultiChannelIntegrator
    from .render import render_fn
    from .util.stats import ProgressReporter

    loaded, scene, integ, spp, mega, why = _setup(job, device)
    writer = mesh is None or mesh.rank == 0
    multi = isinstance(integ, MultiChannelIntegrator)
    channels = integ.channel_names() if multi else None
    t1 = time.time()
    if hasattr(integ, "render_full"):
        # its own outer loop (adaptive sample control), in one call
        img = integ.render_full(scene, loaded.camera, loaded.film, spp,
                                job.seed, device=scene.device)
        final = img.cpu().numpy()
        return Rendered(job.out, final, "eager", why, None,
                        time.time() - t1, spp, scene.device.type,
                        loaded.film)
    chunk = max(1, min(spp, REFRESH_CHUNK)) if job.refresh > 0 else spp
    done, accum = 0, None
    n_rays = None if mesh is not None and mega is None and not multi \
        else 0
    progress = ProgressReporter("Rendering", spp, quiet=job.quiet
                                or not writer)
    last_flush = time.time()
    while done < spp:
        this = min(chunk, spp - done)
        seed = job.seed + done
        rays = None
        if multi:
            img, rays = integ.render_stats(scene, loaded.camera, loaded.film,
                                           this, seed, device=scene.device)
        elif mega is not None and mesh is not None:
            img, rays = render_persistent_sharded(mega, loaded.camera, this,
                                                  seed, mesh)
        elif mesh is not None:
            from .parallel.dist import render_sharded
            img = render_sharded(scene, loaded.camera, loaded.film, integ,
                                 this, seed, mesh)
        elif mega is not None:
            img, rays = render_persistent(mega, loaded.camera, this, seed)
        else:
            img, rays = render_fn(scene, loaded.camera, loaded.film, integ,
                                  this, seed, device=scene.device)
        if rays is not None:
            n_rays += int(rays)
        accum = img * this if accum is None else accum + img * this
        done += this
        progress.update(done)
        if (job.refresh > 0 and writer and done < spp
                and time.time() - last_flush > job.refresh):
            _save(job.out, (accum / done).cpu().numpy(), channels)
            last_flush = time.time()
    final = (accum / done).cpu().numpy()      # waits for the device
    render_s = time.time() - t1
    if loaded.film.banner:
        from .io.image import stamp_banner
        final = stamp_banner(final)
    return Rendered(job.out, final, "megakernel" if mega is not None
                    else "eager", why, n_rays, render_s, spp,
                    scene.device.type, loaded.film, channels)


def _save(path: str, image, channels=None, **exr):
    """Write an image; an EXR gets `channels` as its channel names (None:
    RGB) and the keyword arguments of write_exr."""
    from .integrator.multichannel import write_multichannel_exr
    from .io.image import write_exr, write_image
    if not path.lower().endswith(".exr"):
        write_image(path, image)
    elif channels is not None:
        write_multichannel_exr(path, image, channels, **exr)
    else:
        write_exr(path, image, **exr)


def _write(res: Rendered, job: _Job):
    """Write the final image; an EXR carries the render's annotations
    (ref: renderjob.cpp:109) in the film's compression and channel
    type, and a multichannel render's channel names."""
    _save(job.out, res.image, res.channels, annotations={
        "renderTime": float(res.render_s), "spp": int(res.spp),
        "generatedBy": "mitsuba_tpu_torch"},
        compression=res.film.compression,
        pixel_type="half"
        if res.film.component_format == "float16" else "float")


if __name__ == "__main__":
    sys.exit(main())
