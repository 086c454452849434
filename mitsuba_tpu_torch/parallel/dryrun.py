"""The multi-device dry run (the port's copy of
__graft_entry__.py::dryrun_multichip) and the Cornell-box cases a job's
ranks run (`cornell_cases`). The rank functions live here, in the port,
so that a spawned rank imports the port alone.

    python3 -m mitsuba_tpu_torch.parallel.dryrun 8 --device cpu
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from ..accel import megakernel, trace
from ..device import resolve_device
from ..film.film import Film
from ..integrator.mega import MegaPathTracer, render_persistent_sharded
from ..integrator.path import PathTracer
from ..scene.builder import compile_scene
from ..scene.presets import cornell_box, cornell_camera
from .dist import (launch, render_grad_sharded, render_sharded,
                   replicate_scene)

# the entry's configuration (__graft_entry__.py:69-80)
DRYRUN_RES = 16
DRYRUN_DEPTH = 3
DRYRUN_CLUSTER_SIZE = 128


def dryrun_rank(mesh):
    """One rank of the dry run: the Cornell box (cluster_size 128)
    replicated from rank 0, 16², max_depth 3, 1 spp, seed 0, the mean
    loss: (loss, gradient norm over mat_params and em_radiance,
    {leaf: gradient})."""
    scene = replicate_scene(compile_scene(
        cornell_box(), cluster_size=DRYRUN_CLUSTER_SIZE,
        device=mesh.device), mesh)
    film = Film(DRYRUN_RES, DRYRUN_RES, "box")
    loss, grads = render_grad_sharded(
        scene, cornell_camera(DRYRUN_RES, DRYRUN_RES), film,
        PathTracer(max_depth=DRYRUN_DEPTH), spp=1, seed=0, mesh=mesh)
    gnorm = math.sqrt(sum(float((g * g).sum()) for g in grads.values()))
    return float(loss), gnorm, grads


def dryrun_multichip(n_devices: int, device="cuda", backend=None):
    """The distributed training step of the entry on n_devices ranks
    (dist.launch: spawned processes; device and backend as
    dist.init_group takes them, so on one card pass backend="gloo").
    Prints `dryrun_multichip(n): loss=... grad_norm=... OK` and returns
    (loss, grad_norm, {leaf: gradient as a numpy array}); raises where a
    rank fails, where the ranks' results differ, or where the loss or
    the norm is not finite. The trace kernel is built here first, once,
    where the ranks run on the card."""
    if resolve_device(device).type == "cuda":
        trace.build()
    results = launch(dryrun_rank, n_devices, device=device, backend=backend)
    loss, gnorm, grads = results[0]
    if not all(r[:2] == (loss, gnorm) and all(
            np.array_equal(r[2][k], g) for k, g in grads.items())
            for r in results):
        raise RuntimeError(f"dryrun_multichip: the ranks disagree: "
                           f"{[r[:2] for r in results]}")
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        raise RuntimeError(f"dryrun_multichip: loss {loss}, grad_norm "
                           f"{gnorm}")
    print(f"dryrun_multichip({n_devices}): loss={loss:.6f} "
          f"grad_norm={gnorm:.6f} OK", flush=True)
    return loss, gnorm, grads


def _imported_reference():
    """Modules of JAX or of the JAX package in this process."""
    return sorted(m for m in sys.modules if m.split(".")[0]
                  in ("jax", "jaxlib", "mitsuba_tpu"))


def cornell_cases(mesh, cases):
    """Cases on the Cornell box (the default compile, replicated from
    rank 0), each (kind, res, max_depth, spp, seed) with kind one of
    "render" (render_sharded with PathTracer: the image), "grad"
    (render_grad_sharded, the mean loss: (loss, gradients)), "persistent"
    (render_persistent_sharded: (image, n_rays)) and "replicate" (rank r
    > 0 adds r to its mat_params before replicate_scene: the largest
    difference of the replicated table from the preset's). Returns
    {"results": one per case, "wall_s": this rank's wall seconds per
    case (the device synchronized), "launches": this rank's kernel
    launches per case (the trace and megakernel wrappers' counts),
    "imported": _imported_reference()}."""
    clean = compile_scene(cornell_box(), device=mesh.device)
    scene = replicate_scene(clean, mesh)
    out, walls, launches = [], [], []
    for kind, res, depth, spp, seed in cases:
        trace.reset_launches()
        megakernel.reset_launches()
        cam = cornell_camera(res, res)
        film = Film(res, res, "box")
        sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
                else lambda: None)
        sync()
        t0 = time.perf_counter()
        if kind == "render":
            with torch.no_grad():
                r = render_sharded(scene, cam, film,
                                   PathTracer(max_depth=depth), spp, seed,
                                   mesh)
        elif kind == "grad":
            r = render_grad_sharded(scene, cam, film,
                                    PathTracer(max_depth=depth), spp, seed,
                                    mesh)
        elif kind == "persistent":
            integ = MegaPathTracer.for_scene(scene, max_depth=depth)
            r = render_persistent_sharded(integ, cam, spp, seed, mesh)
        elif kind == "replicate":
            noisy = clean._replace(mat_params=clean.mat_params + mesh.rank)
            r = float((replicate_scene(noisy, mesh).mat_params
                       - clean.mat_params).abs().max())
        else:
            raise ValueError(f"cornell_cases: unknown case {kind!r}")
        sync()
        walls.append(time.perf_counter() - t0)
        launches.append({**trace.LAUNCHES, **megakernel.LAUNCHES})
        out.append(r)
    return {"results": out, "wall_s": walls, "launches": launches,
            "imported": _imported_reference()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", default=None)
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
