#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mitsuba_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
  1. build csrc/trace.cu, csrc/megakernel.cu and csrc/shade.cu with nvcc
     for sm_90a, one nvcc each, all started together, and start phase
     16's builds in a child process at the lowest CPU priority, so they
     compile while phases 2-15 run: trace.cu and megakernel.cu under each
     walk variant of WALK_VARIANTS (build defines of
     csrc/trace_common.cuh) and shade.cu under "old"; print ptxas's
     register and spill reports of the default builds (and, in phase 16,
     of the SIMT walk's), and fail on a spill in any build;
  2. hold the trace kernel against its plain PyTorch version on the Cornell
     box: 256² primary rays and one bounce of NEE shadow rays, closest-hit
     and any-hit, bit for bit on every lane (as in every trace phase);
  3. the same on the Cornell box plus a 261k-triangle sphere (a 12.6 MB
     cluster table, the regime of the TPU package's 2-D grid kernel);
  4. the eager path at full size: Cornell 256², 8 bounces, 64 spp through
     render_fn (render() plus the ray count) with every trace launch
     counted, then the trace kernel's own time at that path's shapes and a
     profile of one sample pass;
  5. the whole eager render through the trace kernel against the whole
     render through the plain intersector (256², 8 spp, same seed);
  6. mega_bounce against its plain version, PathTracer(accel="plain")
     .bounce, lane by lane on the 65,536 Cornell camera rays at bounce 0
     and from the state after 5 plain bounces; then one sample pass driven
     bounce by bounce through run_bounce (the debug entry), counted, and
     held against run_path on the same rays;
  7. render() with MegaPathTracer (mega_path, counted) at 256², 8 spp
     against phase 5's plain render, and mega_path against path_plain lane
     by lane;
  8. render_persistent (mega_persistent) at 256², 64 spp against phase 4's
     eager image and counts, and against persistent_plain lane by lane at
     16 spp; then the bench.py scale: 256², 2048 spp, one warm-up pass and
     two timed passes (counted), with rays/s and the kernel's time by CUDA
     events beside its bound;
  9. the fused shade kernel (csrc/shade.cu) against its plain version,
     shade_plain, lane by lane on the four-material scene (diffuse
     ground, GGX rough-conductor and dielectric spheres, conductor cube,
     area light) at 65,536 lanes, at bounce 0 and bounce 3, with the
     share of lanes that trace a shadow ray, its time and bound; then
     the same comparison with every material two-sided;
 10. that scene's path through render() with PathTracer(max_depth=6,
     fused_shade="on") at 256², 64 spp (counted) against fused_shade=
     "off" under the image rule, with both rays/s and a 1-spp profile of
     each; then the same scene on the megakernels: mega_path against
     path_plain lane by lane, and render_persistent at 64 spp against
     the eager image;
 11. the leaf-families scene (every leaf BSDF family, a two-sided pane,
     smooth spheres; 256², 6 bounces): the trace kernel against its plain
     version on its camera and shadow rays, and on the wavefront of an
     eager pass after three bounces (its live lanes, in pixel order, and
     their shadow rays), each timed beside its bound; mega_bounce against
     its plain version lane by lane at bounce 0 and from the state after
     3 plain bounces, then one pass bounce by bounce (counted);
 12. render() with MegaPathTracer (mega_path, counted) at 8 spp against
     the eager render, and mega_path against path_plain lane by lane;
 13. render_persistent at 8 spp against the eager image, then one 256-spp
     launch of mega_persistent (counted) timed by CUDA events beside its
     bound, and the kernel against persistent_plain on every 16th pixel
     at 16 spp;
 14. the shade kernel against shade_plain at bounces 0 and 3 with rough
     plastic swapped for plastic and every material two-sided, then
     one-sided (timed), with the share of lanes tracing a shadow ray;
 15. that one-sided scene's eager path with fused_shade "off" and "on"
     at 16 spp (counted), both rays/s and a 1-spp profile of each, the
     images under the image rule, and render_persistent against them;
 16. the cluster walk's builds against each other: the walk before the
     warp-cooperative redesign ("old") and the default ("new") in turns
     old, new, new, old, then each other variant once (the SIMT walk with
     the padding stop, the cooperative threshold T at 4, 8, 12, 16, 20
     and 33), on the Cornell 2048-spp mega_persistent launch (with
     bench-scale rays/s for old and new), the leaf-families 256-spp
     launch, and the trace kernel on Cornell's and the leaf scene's
     bounce-0 rays and the leaf scene's bounce-3 wavefront; for old and
     new also the shade kernel at phases 9 and 14's timed shapes; every
     build bit-equal to the plain version on every lane
     (the persistent launches: equal to the default build's, which phases
     8 and 13 hold to persistent_plain, and on those phases' plain
     comparisons equal to persistent_plain itself).

The last two lines are the card's name and power limit, as nvidia-smi
reports them, and {"ok": true, "device": {...}}; the line before them lists
every ported kernel with its launches, error and times on the Cornell box
(the shade kernel: the four-material scene), and under "leaf_families"
the same on the leaf-families scene; the line before that, {"walk": ...},
phase 16's times by variant. Exits non-zero
without a CUDA device, and without the package beside it.
"""
import atexit
import concurrent.futures
import contextlib
import functools
import json
import os
import re
import signal
import subprocess
import sys
import time

import torch

DEV = "cuda"
CORNELL_RES = 256
SPP = 64
MAX_DEPTH = 8
LARGE_SPHERE = (256, 512)   # 261,120 triangles
LARGE_RES = 128             # 16384 rays
TABLE_SWITCH_MB = 8         # pallas_trace.py:416-417 2-D grid switch
# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W)
PEAK_FP32 = 67e12           # FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12        # HBM bytes/s
# fp32 operations of one ray-triangle test in csrc/trace.cu, by how far it
# gets: d'_z (3 mul + 2 add) for every test; o'_z (3 mul + 3 add) and the
# division where |d'_z| passes; o'_x, o'_y (2 x 6), d'_x, d'_y (2 x 5),
# u and v (2 x (mul + add)) and 1-u-v (2 sub) only where t is in range
OPS_DZ, OPS_T, OPS_UV = 5, 7, 28
TRIS_PER_CLUSTER = 64
WOOP_TRI_BYTES = 3 * 16     # three float4 rows per triangle
AABB_ROW_BYTES = 32
# the megakernel phases
MEGA_SPP = 8                # render() with MegaPathTracer
PERSIST_SPP = 64            # render_persistent against the eager image
PERSIST_PLAIN_SPP = 16      # mega_persistent against persistent_plain
BENCH_SPP = 2048            # bench.py:33-36: 256², 2048 spp, 2 timed passes
BENCH_SEEDS = (1, 2)
# fp32 operations of one megakernel bounce outside its two traces, counted
# from csrc/megakernel.cu path_bounce for a lane whose ray hits (add, sub,
# mul, div, sqrt, rsqrt, min, max, abs, cos, sin and int->float each 1;
# compares and integer RNG work not counted); "diffuse f" and the diffuse
# sample's own share of "BSDF sample, next ray" are the BSDF's, charged
# per family from family_ops instead
SHADE_OPS = {"ray mint": 7, "hit record (normal, point)": 39,
             "emitter hit + MIS": 28, "shading frame": 16,
             "wi to local": 18, "RNG floats (NEE)": 6,
             "emitter sample": 55, "wo to local": 15, "diffuse f": 7,
             "shadow origin, mint, maxt": 27, "NEE MIS + L": 17,
             "BSDF sample, next ray": 62, "Russian roulette": 11}
TWO_SIDED_OPS = 3           # the flip's three multiplies
CAMERA_OPS = 41             # camera_path: jitter, pinhole ray, normalize
# the fused shade phases: the four-material scene of
# tests/test_pallas_tpu.py:160-183 at 256², 6 bounces, 64 spp
SHADE_DEPTH = 6
SHADE_BOUNCES = (0, 3)
# fp32 operations of the fused shade kernel for one active lane, counted
# from csrc/shade.cu as SHADE_OPS is: the work every active lane does, the
# shadow ray's origin and range (lanes that trace it) and Russian
# roulette (bounces past rr_depth); the BSDF's eval and sample come per
# family from family_ops
SHADE_KERNEL_OPS = {"common": 127, "shadow setup": 8, "roulette": 4}
# the leaf-families phases (11-15): 256², 6 bounces
LEAF_SPP = 8                # render() with MegaPathTracer against eager
LEAF_PERSIST_SPP = 256      # render_persistent, timed
LEAF_PLAIN_LANES = 16       # persistent_plain on every 16th pixel ...
LEAF_PLAIN_SPP = 16         # ... at 16 spp
LEAF_BOUNCES = (0, 3)
LEAF_EAGER_SPP = 16         # phase 15
# phase 16: builds of the cluster walk (csrc/trace_common.cuh defines);
# "new" is the default build
WALK_VARIANTS = {
    "old": ("-DMITSUBA_WALK_COOP=0", "-DMITSUBA_WALK_STOP=0"),
    "new": (),
    "simt": ("-DMITSUBA_WALK_COOP=0",),
    "T4": ("-DMITSUBA_WALK_T=4",),
    "T8": ("-DMITSUBA_WALK_T=8",),
    "T12": ("-DMITSUBA_WALK_T=12",),
    "T16": ("-DMITSUBA_WALK_T=16",),
    "T20": ("-DMITSUBA_WALK_T=20",),
    "T33": ("-DMITSUBA_WALK_T=33",),
}
WALK_TURNS = ("old", "new", "new", "old", "simt", "T4", "T8", "T12",
              "T16", "T20", "T33")
WALK_DEFAULT_T = 24         # MITSUBA_WALK_T's default in trace_common.cuh
# families whose eval runs without the both-above-the-surface test
TRANSMISSIVE = (5, 12)      # rough dielectric, difftrans
SHADE_ROWS_IN, SHADE_ROWS_OUT = 50, 16
SHADE_ROWS_DEAD = 11        # act, p, d, L, eta: what an inactive lane reads

@contextlib.contextmanager
def walk_build(*defines):
    """Inside the block the trace, megakernel and shade wrappers launch
    their builds under these nvcc defines of the cluster walk
    (csrc/trace_common.cuh, e.g. "-DMITSUBA_WALK_COOP=0"): each module's
    _library is rebound, and put back on leaving. For phase 16 and the
    card tests; the port's entry points launch the default builds."""
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.accel import shade_kernel as sk
    from mitsuba_tpu_torch.accel import trace
    saved = [(m, m._library) for m in (trace, mk, sk)]
    for m, _ in saved:
        m._library = lambda m=m: m._bind(m.build(defines)[0])
    try:
        yield
    finally:
        for m, lib in saved:
            m._library = lib


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def build_jobs(variants):
    """Phase 1's nvcc builds: the three libraries, or (variants) the
    walk variants phase 16 compares: trace.cu and megakernel.cu under
    each of WALK_VARIANTS, shade.cu under "old"."""
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.accel import shade_kernel as sk
    from mitsuba_tpu_torch.accel import trace
    if not variants:
        return [(trace.build, ()), (mk.build, ()), (sk.build, ())]
    return ([(fn, defines) for defines in WALK_VARIANTS.values() if defines
             for fn in (trace.build, mk.build)]
            + [(sk.build, WALK_VARIANTS["old"])])


def run_builds(jobs, shown=()):
    """Each job's build at once, one nvcc each (a cached library is
    reused); prints the ptxas report of the libraries built with the
    defines in `shown`, and fails on a missing report or a spill."""
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        builds = [b.result() for b in [pool.submit(fn, defines)
                                       for fn, defines in jobs]]
    for (lib, report), (_, defines) in zip(builds, jobs):
        label = " ".join(defines) or "(default)"
        if defines in shown:
            print(f"[build] {lib.name} {label}\n{report}", flush=True)
        check("registers" in report, f"{lib.name}: no ptxas register report")
        spills = [m.group(0) for m in re.finditer(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)
            if m.group(1) != "0" or m.group(2) != "0"]
        check(not spills, f"{lib.name} {label}: ptxas spills: {spills}")


def start_variant_builds():
    """Phase 1's variant builds in a child process at the lowest CPU
    priority, so they compile while phases 2-15 run; phase 16 waits for
    it (join_variant_builds), and the script stops it on any exit."""
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "import chip_smoke as c; c.run_builds(c.build_jobs(True))"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True, preexec_fn=lambda: os.nice(19))

    def stop():   # the child and its nvcc processes, if still running
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    atexit.register(stop)
    return proc, time.perf_counter()


def join_variant_builds(proc, t0):
    out = proc.communicate()[0]
    check(proc.returncode == 0, f"variant builds failed:\n{out}")
    print(f"[build] walk variants: {len(build_jobs(True))} builds beside "
          f"phases 2-15, done {time.perf_counter() - t0:.1f} s after they "
          f"started", flush=True)
    # cached now: print the SIMT walk's reports, check every build's
    run_builds(build_jobs(True), shown=(WALK_VARIANTS["simt"],))


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps, warmup=3):
    """Mean device time of fn() over `reps` runs, by CUDA events. A sleep
    kernel (~25 ms) queued first keeps the card busy while the host
    enqueues the runs, so host launch overhead does not enter the time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def camera_rays(cam, res, seed=0):
    """One jittered primary ray per pixel of a res² film."""
    from mitsuba_tpu_torch.core import rng
    px = torch.arange(res * res, device=DEV)
    jit = rng.sample_2d(seed, px, 0, 0)
    pos = torch.stack([(px % res).float() + jit[:, 0],
                       (px // res).float() + jit[:, 1]], -1)
    return cam.sample_ray(pos)


def shadow_rays(scene, o, d, seed=0, live=None):
    """One NEE shadow ray from each hit of the rays (o, d) (of the live
    ones, when `live` is given) toward the area light."""
    from mitsuba_tpu_torch.accel import dense
    from mitsuba_tpu_torch.core import rng
    from mitsuba_tpu_torch.core.math import SHADOW_EPSILON
    from mitsuba_tpu_torch.emitter.emitter import sample_direct
    from mitsuba_tpu_torch.integrator.common import (offset_ray_origin,
                                                     ray_mint)
    n = o.shape[0]
    its = dense.ray_intersect(scene, o, d, ray_mint(o),
                              torch.full((n,), 1e30, device=DEV), live)
    px = torch.arange(n, device=DEV)
    ds = sample_direct(scene, its.p, rng.sample_1d(seed, px, 4),
                       rng.sample_2d(seed, px, 5))
    so = offset_ray_origin(its.p, its.ng, ds.d)
    live = its.valid & (ds.pdf > 0)
    return (so, ds.d, ray_mint(so), ds.dist * (1.0 - SHADOW_EPSILON),
            live)


def compare(label, scene, o, d, mint, maxt, live, errs):
    """Kernel against plain version, closest-hit and any-hit, on the same
    rays: t, triangle, u, v and both hit flags bit for bit on every lane
    (the two round alike op for op); the agreement, t and u/v errors are
    printed too."""
    from mitsuba_tpu_torch.accel import dense, trace
    ki = trace.intersect(scene, o, d, mint, maxt, live)
    pi = dense.ray_intersect(scene, o, d, mint, maxt, live)
    agree = (ki.valid == pi.valid).float().mean().item()
    both = ki.valid & pi.valid
    n_both = int(both.sum())
    tri_ok = bool((ki.tri_id[both] == pi.tri_id[both]).all())
    t_rel = ((ki.t[both] - pi.t[both]).abs()
             / pi.t[both].abs().clamp(min=1e-30)).max().item() \
        if n_both else 0.0
    uv_abs = (ki.uv[both] - pi.uv[both]).abs().max().item() \
        if n_both else 0.0
    # uv is barycentric-interpolated from (u, v) by the same ops on both
    # sides, so it carries the kernel's u/v error unchanged
    ko = trace.occluded(scene, o, d, mint, maxt, live)
    po = dense.ray_test(scene, o, d, mint, maxt, live)
    agree_any = (ko == po).float().mean().item()
    bit = all(torch.equal(getattr(ki, f), getattr(pi, f))
              for f in ("valid", "t", "tri_id", "uv")) and torch.equal(ko, po)
    torch.cuda.synchronize()
    print(f"[{label}] rays {o.shape[0]}  closest: hit agree {agree:.6f}, "
          f"shared hits {n_both}, same tri {tri_ok}, max t rel {t_rel:.3g}, "
          f"max uv abs {uv_abs:.3g}  any: hit agree {agree_any:.6f}, "
          f"occluded {ko.float().mean().item():.4f}; bit-equal {bit}",
          flush=True)
    check(bit, f"{label}: kernel and plain version differ")
    t_abs = (ki.t[both] - pi.t[both]).abs().max().item() if n_both else 0.0
    errs["trace_closest"] = max(errs["trace_closest"], t_abs, uv_abs)
    errs["trace_any"] = max(errs["trace_any"],
                            (ko != po).float().max().item())


def needed_work(scene, o, d, mint, maxt, live, any_hit):
    """The triangle tests, fp32 operations and table bytes that these rays
    need, counted from this run's data: for each live ray, the real
    (non-padding) triangles of the clusters whose boxes it crosses before
    its closest hit (or its maxt), each charged only the stages it reaches
    (OPS_DZ, OPS_T, OPS_UV). In any-hit mode an occluded ray needs only the
    one test that finds its occluder. Slab tests are not counted, and a
    table row is counted once however many rays read it."""
    from mitsuba_tpu_torch.accel import dense
    n, c = o.shape[0], scene.woop_clusters.shape[0]
    tri_real = (scene.tri_area[:c * TRIS_PER_CLUSTER] > 0).view(
        c, TRIS_PER_CLUSTER)
    box = scene.cluster_aabb
    real = tri_real.any(-1) & (box[:, 0:3] <= box[:, 3:6]).all(-1)
    if live is None:
        live = torch.ones(n, dtype=torch.bool, device=o.device)
    hit = dense.ray_intersect(scene, o, d, mint, maxt, live)
    need_tri = torch.zeros_like(tri_real)
    tests = ops = 0
    if any_hit:
        # an occluded ray needs the test of its occluder and nothing else
        occ = hit.valid & live
        tests, ops = int(occ.sum()), int(occ.sum()) * (OPS_DZ + OPS_T + OPS_UV)
        need_tri.view(-1)[hit.tri_id[occ].long()] = True
        live, cap = live & ~occ, maxt
    else:
        cap = torch.where(hit.valid, hit.t, maxt)
    inv = torch.where(d.abs() < 1e-12, torch.where(d >= 0, 1e30, -1e30),
                      1.0 / d)
    entered = torch.zeros(c, dtype=torch.bool, device=o.device)
    for r0 in range(0, n, 4096):
        rs = slice(r0, r0 + 4096)
        for c0 in range(0, c, 512):
            b = box[c0:c0 + 512]
            t0 = (b[None, :, 0:3] - o[rs, None]) * inv[rs, None]
            t1 = (b[None, :, 3:6] - o[rs, None]) * inv[rs, None]
            near = torch.maximum(torch.minimum(t0, t1).amax(-1),
                                 mint[rs, None])
            far = torch.minimum(torch.maximum(t0, t1).amin(-1),
                                cap[rs, None])
            enter = ((near <= far) & real[None, c0:c0 + 512]
                     & live[rs, None])
            ri, ci = enter.nonzero(as_tuple=True)
            ri, ci = ri + r0, ci + c0
            entered[ci] = True
            for p0 in range(0, ri.shape[0], 32768):
                pr, pc = ri[p0:p0 + 32768], ci[p0:p0 + 32768]
                wz = scene.woop_clusters[pc, 2 * TRIS_PER_CLUSTER:]
                dz = (wz[..., 0:3] * d[pr, None]).sum(-1)
                oz = (wz[..., 0:3] * o[pr, None]).sum(-1) + wz[..., 3]
                t = -oz / dz
                test = tri_real[pc]
                dz_ok = test & (dz.abs() >= 1e-12)
                t_ok = (dz_ok & (t > mint[pr, None]) & (t < maxt[pr, None])
                        & (t <= cap[pr, None]))
                n_test, n_dz, n_t = (int(x.sum()) for x in (test, dz_ok, t_ok))
                tests += n_test
                ops += OPS_DZ * n_test + OPS_T * n_dz + OPS_UV * n_t
    need_tri |= tri_real & entered[:, None]
    table_bytes = (int(need_tri.sum()) * WOOP_TRI_BYTES
                   + int(need_tri.any(-1).sum()) * AABB_ROW_BYTES)
    return tests, ops, table_bytes


def measure(label, any_hit, scene, rays, plain_reps, card):
    """Time one kernel launch and its plain version on these rays, and
    work out the card's bound for the same work."""
    from mitsuba_tpu_torch.accel import dense, trace
    o, d, mint, maxt, live = rays
    ms = time_ms(lambda: trace.trace(scene, o, d, mint, maxt, live,
                                     any_hit), 100)
    plain_ms = time_ms(lambda: dense.intersect_soup(
        o, d, scene.woop_o, mint, maxt, live), plain_reps, warmup=1)
    n, c = o.shape[0], scene.woop_clusters.shape[0]
    tests, ops, table_bytes = needed_work(scene, o, d, mint, maxt, live,
                                          any_hit)
    n_bytes = (n * (24 + 8 + (0 if live is None else 1))   # rays in
               + n * (1 if any_hit else 17)                # hits out
               + table_bytes)                              # rows needed
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FP32 * 1e3
    out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"[time] {label}: {ms * 1e3:.2f} us/launch (plain "
          f"{plain_ms * 1e3:.1f} us, bound {out['bound_ms'] * 1e3:.4f} us "
          f"by {out['bound_by']}; {n} rays, {c} clusters, {tests} triangle "
          f"tests, {ops} fp32 ops, {n_bytes} bytes) ({card})", flush=True)
    return out


def profile_pass(scene, cam, film, integrator, card, reps=4):
    """The device's busy share of one 1-spp pass of the main path: device
    time from torch.profiler over one pass, divided by the mean wall of
    `reps` passes run without the profiler (which slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    from mitsuba_tpu_torch.render import render_fn
    run = lambda: render_fn(scene, cam, film, integrator, spp=1, seed=1,
                            device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    # device-side events only (the CPU ops that launched them carry the
    # same device time and would count it twice)
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        print("[profile] the profiler saw no device time: busy share not "
              "measured", flush=True)
        return
    busy_us = sum(r[0] for r in rows)
    print(f"[profile] 1 spp pass: wall {wall * 1e3:.1f} ms (mean of {reps}, "
          f"no profiler; {prof_wall * 1e3:.1f} ms under it), device busy "
          f"{busy_us / 1e3:.1f} ms ({busy_us / 1e4 / wall:.1f}% of the "
          f"unprofiled wall), {sum(r[1] for r in rows)} device ops ({card})",
          flush=True)
    for us, count, key in rows[:8]:
        print(f"    {us / 1e3:8.2f} ms  {count:6d}x  {key[:90]}")


def image_rule(img, ref, label):
    """tests/test_render.py's rule: < 1% of values off by rel > 5e-2 and
    the means within rel 5e-3."""
    rel = (img - ref).abs() / ref.clamp(min=1e-3)
    frac_bad = (rel > 5e-2).float().mean().item()
    mean_rel = abs(img.mean().item() - ref.mean().item()) / ref.mean().item()
    print(f"[{label}] frac rel>5e-2 {frac_bad:.5f}, mean rel {mean_rel:.3g}",
          flush=True)
    check(frac_bad < 1e-2, f"{label}: {frac_bad} of values differ")
    check(mean_rel < 5e-3, f"{label}: means differ by rel {mean_rel}")


def compare_rows(label, k, p):
    """A megakernel's output rows against its plain version's, lane by
    lane. A lane agrees when every row is within rel 1e-5, or abs 1e-6
    near 0; limit: >= 99.9% of lanes agree. Prints each row's max abs
    error, the share of lanes that are bit-equal and the lanes whose
    active flag differs. Returns the max abs error."""
    diff = (k - p).abs()
    ok = ((diff <= 1e-6) | (diff <= 1e-5 * p.abs())).all(0)
    share = ok.float().mean().item()
    bit = (k == p).all(0).float().mean().item()
    act = int(((k[12] > 0.5) != (p[12] > 0.5)).sum())
    rows = " ".join(f"{x:.3g}" for x in diff.max(1).values.tolist())
    print(f"[{label}] {k.shape[1]} lanes: agree {share:.6f}, bit-equal "
          f"{bit:.6f}, active differs on {act} lanes; row max abs: {rows}",
          flush=True)
    check(share >= 0.999, f"{label}: only {share} of lanes agree")
    return diff.max().item()


_COUNTED = {"add", "sub", "mul", "div", "truediv", "rsub", "radd", "rmul",
            "rtruediv", "neg", "sqrt", "rsqrt", "exp", "log", "sin", "cos",
            "clamp", "maximum", "minimum", "abs", "floor", "pow", "amax",
            "reciprocal"}


def family_ops(tables):
    """fp32 operations of each family's eval and sample branch for one
    lane, counted by running the plain versions of the device helpers
    (accel/megakernel.py bsdf_eval_pdf, bsdf_sample), which the kernels
    compute op for op, on one lane of each of the tables' materials
    under a TorchFunctionMode that counts arithmetic calls (selects and
    compares not counted; rough dielectric's eval computes both candidate
    micronormals where the kernel computes one, so its count is ~10
    over). Returns {family: (eval_ops, sample_ops)}."""
    from torch.overrides import TorchFunctionMode

    from mitsuba_tpu_torch.accel import megakernel as mk

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "").strip("_")
            if name in _COUNTED:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    out = {}
    for row in tables.mat.cpu():
        fam = int(row[12])
        if fam in out:
            continue
        m = row[:, None].clone()
        t = lambda *v: torch.tensor(v, dtype=torch.float32)
        wo_z = -0.6 if fam in TRANSMISSIVE else 0.6
        args = (t(0.3), t(0.2), t(0.9), t(-0.2), t(0.5), t(wo_z))
        with Count():
            Count.n = 0
            mk.bsdf_eval_pdf(m, *args, families=(fam,))
            n_eval = Count.n
            Count.n = 0
            mk.bsdf_sample(m, *args[:3], t(0.3), t(0.7), t(0.4),
                           families=(fam,))
            out[fam] = (n_eval, Count.n)
    return out


def bounce_work(tables, state, pix, samp, bounce, fam_ops, max_depth,
                seed=0):
    """needed_work for one bounce of the megakernel on its plain scene: the
    closest-hit rays of the live lanes, the shadow rays the kernel traces
    (attempted NEE with the BSDF nonzero toward the light) and the
    shading operations of the hits, each charged the common SHADE_OPS
    plus its family's sample and, where the eval branch runs, its eval.
    Returns a dict of ray counts, ops and table bytes."""
    from mitsuba_tpu_torch.accel import dense
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.core import rng
    from mitsuba_tpu_torch.core.math import SHADOW_EPSILON, Frame
    from mitsuba_tpu_torch.emitter.emitter import sample_direct
    from mitsuba_tpu_torch.integrator.common import (
        DIM_NEE_POS, DIM_NEE_SEL, bounce_dim, offset_ray_origin, ray_mint)
    scene = tables.plain_scene
    o = state[0:3].T.contiguous()
    d = state[3:6].T.contiguous()
    live = state[12] > 0.5
    maxt = torch.full_like(o[:, 0], 1e30)
    its = dense.ray_intersect(scene, o, d, ray_mint(o), maxt, live)
    ds = sample_direct(scene, its.p,
                       rng.sample_1d(seed, pix, bounce_dim(bounce,
                                                           DIM_NEE_SEL), samp),
                       rng.sample_2d(seed, pix, bounce_dim(bounce,
                                                           DIM_NEE_POS), samp))
    attempted = its.valid & (bounce + 3 <= max_depth + 1) & (ds.pdf > 0)
    mat = tables.mat[its.mat_id.clamp(min=0)].T
    frame = Frame.from_normal(its.ns)
    wi, wo = Frame.to_local(frame, -d), Frame.to_local(frame, ds.d)
    fsign = torch.where((mat[15] > 0.5) & (wi[:, 2] < 0), -1.0, 1.0)
    *f, _ = mk.bsdf_eval_pdf(mat, wi[:, 0], wi[:, 1], wi[:, 2] * fsign,
                             wo[:, 0], wo[:, 1], wo[:, 2] * fsign)
    traced = attempted & ((f[0] > 0) | (f[1] > 0) | (f[2] > 0))
    both_up = (wi[:, 2] * fsign > 0) & (wo[:, 2] * fsign > 0)
    common = (sum(SHADE_OPS.values()) - SHADE_OPS["diffuse f"]
              - fam_ops[0][1] + TWO_SIDED_OPS) if 0 in fam_ops else \
        sum(SHADE_OPS.values()) - SHADE_OPS["diffuse f"] + TWO_SIDED_OPS
    shade_ops = common * int(its.valid.sum())
    for fam, (n_eval, n_sample) in fam_ops.items():
        hit_f = its.valid & (mat[12] == fam)
        runs = attempted & hit_f & (both_up | (fam in TRANSMISSIVE))
        shade_ops += n_sample * int(hit_f.sum()) + n_eval * int(runs.sum())
    so = offset_ray_origin(its.p, its.ng, ds.d)
    c_tests, c_ops, c_bytes = needed_work(scene, o, d, ray_mint(o), maxt,
                                          live, False)
    s_tests, s_ops, s_bytes = needed_work(
        scene, so, ds.d, ray_mint(so), ds.dist * (1.0 - SHADOW_EPSILON),
        traced, True)
    return {"trace": int(live.sum()), "hit": int(its.valid.sum()),
            "shadow": int(attempted.sum()), "c_ops": c_ops, "s_ops": s_ops,
            "shade_ops": shade_ops, "tests": c_tests + s_tests,
            "table_bytes": max(c_bytes, s_bytes)}


def mega_bound(label, work, n_trace, n_shadow, n_paths, lanes, rows_in,
               rows_out, tables, card):
    """The card's least time for a megakernel launch that traced n_trace
    closest-hit rays, attempted n_shadow shadow rays and started n_paths
    camera paths: fp32 ops, the triangle tests' and the shading's per ray
    as `work` (a sample of this run's rays, bounce_work) counts them, plus
    CAMERA_OPS per path, over 67 TFLOP/s; and the bytes, the tables once
    and the lane state in and out, over 3.35 TB/s."""
    ops = (n_trace * (work["c_ops"] + work["shade_ops"]) / work["trace"]
           + n_shadow * work["s_ops"] / max(work["shadow"], 1)
           + n_paths * CAMERA_OPS)
    table_bytes = (work["table_bytes"]
                   + sum(t.numel() * 4 for t in (
                       tables.attr[:tables.n_tris], tables.mat,
                       tables.em_rows[:tables.et_real],
                       tables.em_meta[:max(tables.em_count, 1)],
                       tables.em_cdf)))
    n_bytes = table_bytes + lanes * (4 * (rows_in + rows_out) + 8)
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, n_bytes / PEAK_BYTES * 1e3
    out = {"bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    print(f"[bound] {label}: {out['bound_ms']:.5g} ms by {out['bound_by']} "
          f"({ops:.4g} fp32 ops: {n_trace} traced rays x "
          f"{work['c_ops'] / work['trace']:.1f} test ops, "
          f"{work['hit'] / work['trace']:.4f} hits per ray, "
          f"{work['shade_ops'] / max(work['hit'], 1):.1f} shading ops per "
          f"hit, {n_shadow} shadow attempts x "
          f"{work['s_ops'] / max(work['shadow'], 1):.1f} test ops, "
          f"{n_paths} paths x {CAMERA_OPS} camera ops; {n_bytes} bytes) "
          f"({card})", flush=True)
    return out


def pass_work(tables, st0, pix, samp, max_depth):
    """bounce_work over one plain sample pass from st0: the per-bounce
    works and their sum (table bytes: the largest)."""
    from mitsuba_tpu_torch.accel import megakernel as mk
    fam_ops = family_ops(tables)
    works, st = [], st0
    for b in range(max_depth):
        works.append(bounce_work(tables, st, pix, samp, b, fam_ops,
                                 max_depth))
        st = mk.bounce_plain(tables, 5, max_depth, st, pix, samp, 0, b)[:16]
    total = {key: sum(w[key] for w in works) for key in works[0]}
    total["table_bytes"] = max(w["table_bytes"] for w in works)
    return works, total


def events_ms(fn):
    """Device time of one fn() by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def four_materials_desc(desc_cls, tf, shapes, sphere=(16, 32),
                        two_sided=False, ggx=None):
    """The scene of tests/test_pallas_tpu.py:160-183 through a builder
    API: desc_cls, tf and shapes are the port's (or the JAX package's)
    SceneDesc, transform and shapes modules. two_sided puts every
    material behind the two-sided adapter (the glass sphere's inside
    then shades as its outside); ggx overrides rough-conductor fields."""
    d = desc_cls()
    white = d.add_material(kind="diffuse", albedo=(0.7, 0.7, 0.7),
                           two_sided=two_sided)
    rough = d.add_material(kind="roughconductor", alpha=0.2,
                           two_sided=two_sided, **(ggx or {}))
    glass = d.add_material(kind="dielectric", int_ior=1.5,
                           two_sided=two_sided)
    mirror = d.add_material(kind="conductor", two_sided=two_sided)
    d.add_shape(shapes.rectangle(), material=white,
                to_world=tf.translate([0, -1, 0])
                @ tf.rotate([1, 0, 0], -90) @ tf.scale([6] * 3))
    d.add_shape(shapes.sphere(*sphere), to_world=tf.translate([-1.5, 0, 0]),
                material=rough)
    d.add_shape(shapes.sphere(*sphere), to_world=tf.translate([1.5, 0, 0]),
                material=glass)
    d.add_shape(shapes.cube(), material=mirror,
                to_world=tf.translate([0, 0, -2]) @ tf.scale([0.7] * 3))
    d.add_shape(shapes.rectangle(), material=white,
                radiance=(10.0, 9.0, 8.0),
                to_world=tf.translate([0, 4, 0])
                @ tf.rotate([1, 0, 0], 90) @ tf.scale([1.5] * 3))
    return d


def leaf_families_desc(desc_cls, tf, shapes, sphere=(12, 24),
                       rough_plastic=True, two_sided=False):
    """The leaf-families scene through a builder API (desc_cls, tf and
    shapes as for four_materials_desc), from the recipes of
    tests/test_mega_tpu.py:236-303, :530-612 and :752-828: a diffuse
    floor; nine spheres (scale 0.6) of rough conductor (GGX α 0.2),
    plastic, phong, ward, rough diffuse, LEADR (scenes/materials.xml's
    moments), rough plastic (GGX α 0.25; plastic when rough_plastic is
    False), rough dielectric (GGX α 0.2) and dielectric; a conductor
    cube; four panes of thin dielectric, difftrans, null and a two-sided
    diffuse turned away from the camera and the light; a rectangle light
    at y = 4. two_sided puts every material behind the two-sided
    adapter."""
    d = desc_cls()
    ts = dict(two_sided=two_sided)
    floor = d.add_material(kind="diffuse", albedo=(0.6, 0.6, 0.6), **ts)
    rp = (dict(kind="roughplastic", diffuse_reflectance=(0.7, 0.2, 0.15),
               alpha=0.25) if rough_plastic else
          dict(kind="plastic", diffuse_reflectance=(0.7, 0.2, 0.15)))
    spheres = [
        d.add_material(kind="roughconductor", alpha=0.2, **ts),
        d.add_material(kind="plastic", diffuse_reflectance=(0.5, 0.2, 0.2),
                       **ts),
        d.add_material(kind="phong", diffuse_reflectance=(0.3, 0.4, 0.2),
                       specular_reflectance=(0.4, 0.4, 0.4), exponent=40.0,
                       **ts),
        d.add_material(kind="ward", diffuse_reflectance=(0.3, 0.3, 0.4),
                       specular_reflectance=(0.3, 0.3, 0.3), alpha=0.15,
                       alpha_v=0.3, **ts),
        d.add_material(kind="roughdiffuse", albedo=(0.6, 0.5, 0.4),
                       alpha=0.4, **ts),
        d.add_material(kind="aniso_roughdiffuse", albedo=(0.6, 0.55, 0.2),
                       moments0=(0.2, 0.0), moments1=(0.2, 0.03, 0.0), **ts),
        d.add_material(**rp, **ts),
        d.add_material(kind="roughdielectric", alpha=0.2, int_ior=1.5, **ts),
        d.add_material(kind="dielectric", int_ior=1.5, **ts),
    ]
    mirror = d.add_material(kind="conductor", **ts)
    panes = [d.add_material(kind="thindielectric", int_ior=1.5, **ts),
             d.add_material(kind="difftrans", transmittance=(0.6, 0.5, 0.4),
                            **ts),
             d.add_material(kind="null", **ts),
             d.add_material(kind="diffuse", albedo=(0.8, 0.4, 0.3),
                            two_sided=True)]
    d.add_shape(shapes.rectangle(), material=floor,
                to_world=tf.translate([0, -1, 0])
                @ tf.rotate([1, 0, 0], -90) @ tf.scale([6] * 3))
    for i, m in enumerate(spheres):
        row, col = divmod(i, 5)
        x = 1.3 * col - (2.6 if row == 0 else 1.95)
        d.add_shape(shapes.sphere(*sphere), material=m,
                    to_world=tf.translate([x, -0.4, -1.6 * row])
                    @ tf.scale([0.6] * 3))
    d.add_shape(shapes.cube(), material=mirror,
                to_world=tf.translate([0, -0.5, -3.4]) @ tf.scale([0.5] * 3))
    for i, m in enumerate(panes):
        x = (-3.4, -1.7, 1.7, 3.4)[i]
        d.add_shape(shapes.rectangle(), material=m,
                    to_world=tf.translate([x, 0.0, -3.2])
                    @ tf.rotate([0, 1, 0], 180 if i == 3 else 0)
                    @ tf.scale([0.6] * 3))
    d.add_shape(shapes.rectangle(), material=floor,
                radiance=(12.0, 11.0, 10.0),
                to_world=tf.translate([0, 4, 0])
                @ tf.rotate([1, 0, 0], 90) @ tf.scale([2.0] * 3))
    return d


def leaf_families_camera(cam_cls, tf, res):
    """A res² camera at (0, 1.5, 6.5) looking down at (0, -0.4, -1), 45°
    fov."""
    return cam_cls(res, res, 45.0, tf.look_at(
        origin=[0, 1.5, 6.5], target=[0, -0.4, -1], up=[0, 1, 0]))


def four_materials(res, device=DEV, two_sided=False):
    """The four-material scene (sphere(16, 32)) compiled on `device`, and
    a res² camera at (0, 1, 6) looking along (0, -0.1, -1) with a 39°
    fov."""
    from mitsuba_tpu_torch.core import transform as tf
    from mitsuba_tpu_torch.scene import shapes
    from mitsuba_tpu_torch.scene.builder import SceneDesc, compile_scene
    from mitsuba_tpu_torch.sensor.sensor import PerspectiveCamera
    desc = four_materials_desc(SceneDesc, tf, shapes, two_sided=two_sided)
    cam = PerspectiveCamera(res, res, 39.0, tf.look_at(
        origin=[0, 1, 6], target=[0, 0.9, 5], up=[0, 1, 0]))
    return compile_scene(desc, device=device), cam


def shade_bound(label, scene, packed, bounce, rr_depth, fam_ops, card):
    """The card's least time for one fused shade launch on these rows: the
    bytes over 3.35 TB/s and the fp32 operations over 67 TFLOP/s, each
    lane counted by what it does. A lane active on entry reads the K_IN
    rows and its pixel and sample ids; one inactive on entry reads only
    the SHADE_ROWS_DEAD rows it passes through; every lane writes the
    K_OUT rows; the NEE distance row is read only by the lanes that
    trace a shadow ray, and the table rows those rays need come on top.
    Operations: SHADE_KERNEL_OPS for each active lane, its family's
    sample and, where the eval branch runs, its eval (fam_ops, from
    family_ops), plus the shadow rays' triangle tests as needed_work
    counts them."""
    from mitsuba_tpu_torch.accel import shade_kernel as sk
    n = packed.shape[1]
    act = packed[sk.I_ACT] > 0.5
    n_act = int(act.sum())
    mtype = packed[sk.I_MAT + 12]
    fr = sk._front(packed, bounce, SHADE_DEPTH)
    both_up = (fr.wi[2] > 0) & (fr.wo[2] > 0)
    so, sd, smint, smaxt, live = sk.shadow_rays(packed, bounce, SHADE_DEPTH)
    n_live = int(live.sum())
    ops = SHADE_KERNEL_OPS["common"] * n_act
    ops += SHADE_KERNEL_OPS["shadow setup"] * n_live
    if bounce + 2 >= rr_depth:
        ops += SHADE_KERNEL_OPS["roulette"] * n_act
    for fam, (n_eval, n_sample) in fam_ops.items():
        lanes = act & (mtype == fam)
        runs = lanes & (both_up | (fam in TRANSMISSIVE))
        ops += n_eval * int(runs.sum()) + n_sample * int(lanes.sum())
    tests, trace_ops, table_bytes = needed_work(scene, so, sd, smint, smaxt,
                                                live, True)
    ops += trace_ops
    n_bytes = (n_act * (4 * (SHADE_ROWS_IN - 1) + 8) + n_live * 4
               + (n - n_act) * 4 * SHADE_ROWS_DEAD
               + n * 4 * SHADE_ROWS_OUT + table_bytes)
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, n_bytes / PEAK_BYTES * 1e3
    out = {"bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops > t_bytes else "bytes"}
    print(f"[bound] {label}: {out['bound_ms']:.5g} ms by {out['bound_by']} "
          f"({n_bytes} bytes, {n_act} of {n} lanes active; {ops} fp32 ops, "
          f"{trace_ops} of them in {tests} triangle tests of "
          f"{n_live} shadow rays) ({card})", flush=True)
    return out


def shade_phases(card):
    """Phases 9 and 10: the fused shade kernel against shade_plain lane by
    lane, then its path through render() against the eager tail. Returns
    the kernel's entry of the kernels line, and phase 16's shade cases
    (walk_phase)."""
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.accel import shade_kernel as sk
    from mitsuba_tpu_torch.accel import trace
    from mitsuba_tpu_torch.film.film import Film
    from mitsuba_tpu_torch.integrator.mega import (MegaPathTracer,
                                                   render_persistent)
    from mitsuba_tpu_torch.integrator.path import PathTracer, initial_state
    from mitsuba_tpu_torch.render import render_fn

    # ---- 9. shade kernel vs shade_plain, 65,536 lanes ----------------
    scene, cam = four_materials(CORNELL_RES)
    print(f"[shade] four-material scene: {scene.n_tris} triangles, "
          f"{scene.woop_clusters.shape[0]} clusters", flush=True)
    fam_ops = family_ops(mk.build_mega_tables(scene))
    print(f"[shade] fp32 ops by family (eval, sample): {fam_ops}",
          flush=True)
    pix = torch.arange(CORNELL_RES ** 2, dtype=torch.int32, device=DEV)
    samp = torch.zeros_like(pix)
    err, timing, walk_cases = 0.0, {}, {}
    # the scene, then the same with every material behind the two-sided
    # adapter (timed on the first only)
    scene_2s = four_materials(CORNELL_RES, two_sided=True)[0]
    for sc in (scene, scene_2s):
        two_sided = sc is scene_2s
        tracer = PathTracer(max_depth=SHADE_DEPTH).specialized_for(sc)
        st = initial_state(*mk.primary_rays(cam, 0, pix, 0))
        for b in range(max(SHADE_BOUNCES) + 1):
            if b in SHADE_BOUNCES:
                label = f"shade, bounce {b}" + ", two-sided" * two_sided
                packed = tracer.shade_inputs(sc, st, 0, pix, samp, b)
                run = lambda: sk.run_shade(sc, packed, pix, samp, 0, b,
                                           tracer.rr_depth, SHADE_DEPTH)
                plain = lambda: sk.shade_plain(sc, packed, pix, samp, 0, b,
                                               tracer.rr_depth, SHADE_DEPTH)
                ref = plain()
                err = max(err, compare_rows(label, run(), ref))
                act = packed[sk.I_ACT] > 0.5
                share = sk.shadow_rays(packed, b, SHADE_DEPTH)[4]
                flips = ((sk._front(packed, b, SHADE_DEPTH).fsign < 0)
                         & (packed[sk.I_HIT] > 0.5))
                print(f"[shade] {label}: {act.float().mean().item():.4f} of "
                      f"lanes active, {share.float().mean().item():.4f} "
                      f"trace a shadow ray, {flips.float().mean().item():.4f}"
                      f" hit a surface from behind and flip", flush=True)
                if two_sided:
                    check(bool(flips.any()), f"{label}: no lane flipped")
                else:
                    timing[b] = {"ms": time_ms(run, 100),
                                 "plain_ms": time_ms(plain, 5, warmup=1),
                                 **shade_bound(label, sc, packed, b,
                                               tracer.rr_depth, fam_ops,
                                               card)}
                    print(f"[shade] {label}: kernel "
                          f"{timing[b]['ms'] * 1e3:.2f} us/launch, plain "
                          f"{timing[b]['plain_ms']:.3f} ms ({card})",
                          flush=True)
                    walk_cases[f"four-material b{b}"] = (functools.partial(
                        sk.run_shade, sc, packed, pix, samp, 0, b,
                        tracer.rr_depth, SHADE_DEPTH), ref)
            st = tracer.bounce(sc, st, 0, pix, samp, b)[0]
    del scene_2s

    # ---- 10. the fused path through render(), against the eager tail ----
    film = Film(CORNELL_RES, CORNELL_RES, "box")
    results = {}
    for mode in ("off", "on"):
        integ = PathTracer(max_depth=SHADE_DEPTH, fused_shade=mode)
        render_fn(scene, cam, film, integ, spp=1, seed=0, device=DEV)
        torch.cuda.synchronize()                            # (warm-up)
        trace.reset_launches()
        sk.reset_launches()
        t0 = time.perf_counter()
        img, n = render_fn(scene, cam, film, integ, spp=SPP, seed=0,
                           device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**trace.LAUNCHES, **sk.LAUNCHES}
        results[mode] = (img, int(n), launches)
        print(f"[fused {mode}] {CORNELL_RES}², {SHADE_DEPTH} bounces, {SPP} "
              f"spp: {wall:.3f} s, {int(n)} rays, {int(n) / wall:.4g} rays/s,"
              f" mean {img.mean().item():.5f}, launches {launches} ({card})",
              flush=True)
        check(bool(torch.isfinite(img).all()), f"fused {mode}: NaN/Inf")
        profile_pass(scene, cam, film, integ, card)
    (img_off, n_off, l_off), (img_on, n_on, l_on) = results["off"], \
        results["on"]
    check(l_on["shade"] == SHADE_DEPTH * SPP,
          f"shade launched {l_on['shade']} times, want {SHADE_DEPTH * SPP}")
    check(l_off["shade"] == 0 and l_on["trace_any"] == 0,
          "the eager tail launched the shade kernel or the fused tail a "
          "shadow trace")
    image_rule(img_on, img_off, f"fused on vs off, {SPP} spp")
    check(abs(n_on - n_off) <= 1e-4 * n_off,
          f"ray counts {n_on} (on) vs {n_off} (off)")
    # the same scene on the megakernels: mega_path lane by lane, and the
    # persistent image against the eager one
    integ_m = MegaPathTracer.for_scene(scene, max_depth=SHADE_DEPTH)
    st0 = initial_state(*mk.primary_rays(cam, 0, pix, 0))
    k = mk.run_path(integ_m.tables, integ_m.rr_depth, SHADE_DEPTH,
                    SHADE_DEPTH, st0, pix, samp, 0)
    p = mk.path_plain(integ_m.tables, integ_m.rr_depth, SHADE_DEPTH,
                      SHADE_DEPTH, st0, pix, samp, 0)
    compare_rows("four-material mega_path, one sample", k, p)
    img_p, n_p = render_persistent(integ_m, cam, SPP, seed=0)
    image_rule(img_p, img_off, f"four-material render_persistent vs eager, "
                               f"{SPP} spp")
    check(abs(int(n_p) - n_off) <= 1e-4 * n_off,
          f"four-material persistent rays {int(n_p)} vs {n_off}")
    b0 = timing[SHADE_BOUNCES[0]]
    return {"name": "shade", "route": "cuda",
            "source": "mitsuba_tpu_torch/csrc/shade.cu",
            "replaces": "mitsuba_tpu/accel/shade_kernel.py:75",
            "launches": l_on["shade"], "max_abs_err": err,
            **b0, "library_ms": None}, walk_cases


def leaf_scene(res, device=DEV, **kw):
    """The leaf-families scene (sphere(12, 24)) compiled on `device`, and
    its res² camera."""
    from mitsuba_tpu_torch.core import transform as tf
    from mitsuba_tpu_torch.scene import shapes
    from mitsuba_tpu_torch.scene.builder import SceneDesc, compile_scene
    from mitsuba_tpu_torch.sensor.sensor import PerspectiveCamera
    desc = leaf_families_desc(SceneDesc, tf, shapes, **kw)
    return (compile_scene(desc, device=device),
            leaf_families_camera(PerspectiveCamera, tf, res))


def leaf_phases(card, kernels):
    """Phases 11-15 on the leaf-families scene, 256², 6 bounces. Adds to
    each entry of `kernels` (by name) a "leaf_families" object with the
    kernel's launches on this scene's paths, its error against its plain
    version and its times and bound here. Returns what phase 16 runs on
    this scene (walk_phase)."""
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.accel import shade_kernel as sk
    from mitsuba_tpu_torch.accel import trace
    from mitsuba_tpu_torch.film.film import Film
    from mitsuba_tpu_torch.integrator.common import ray_mint
    from mitsuba_tpu_torch.integrator.mega import (MegaPathTracer,
                                                   render_persistent)
    from mitsuba_tpu_torch.integrator.path import PathTracer, initial_state
    from mitsuba_tpu_torch.render import render_fn

    depth, res = SHADE_DEPTH, CORNELL_RES
    leaf = {k["name"]: {} for k in kernels}
    scene, cam = leaf_scene(res)
    film = Film(res, res, "box")
    fams = sorted(set(scene.mat_type.tolist()))
    print(f"[leaf] leaf-families scene: {int((scene.tri_area > 0).sum())} "
          f"triangles, {scene.woop_clusters.shape[0]} clusters, families "
          f"{fams}", flush=True)
    ok, why = MegaPathTracer.supports(scene, cam, film)
    check(ok, f"MegaPathTracer refuses the leaf-families scene: {why}")
    ok, why = sk.supports(scene)
    check(not ok and why.startswith("rough plastic"),
          f"shade supports on the leaf scene: {ok} {why}")
    integ = MegaPathTracer.for_scene(scene, max_depth=depth)
    tables, rr = integ.tables, integ.rr_depth
    pix = torch.arange(res * res, dtype=torch.int32, device=DEV)
    samp = torch.zeros_like(pix)
    o0, d0 = mk.primary_rays(cam, 0, pix, 0)
    st0 = initial_state(o0, d0)

    # ---- the trace kernel on this scene's rays -----------------------------
    errs = {"trace_closest": 0.0, "trace_any": 0.0}
    primary = (o0, d0, ray_mint(o0), torch.full_like(o0[:, 0], 1e30), None)
    shadow = shadow_rays(scene, o0, d0)
    compare("leaf primary", scene, *primary, errs)
    compare("leaf shadow", scene, *shadow, errs)
    # the wavefront the eager path traces at bounce 3: every lane in pixel
    # order with the live ones marked, as PathTracer.bounce hands it to
    # the trace kernel, and the NEE shadow rays from its hits
    tracer = PathTracer(max_depth=depth).specialized_for(scene)
    st = st0
    for b in range(3):
        st = tracer.bounce(scene, st, 0, pix, samp, b)[0]
    o3, d3, live3 = st[0:3].T.contiguous(), st[3:6].T.contiguous(), \
        st[12] > 0.5
    bounce3 = (o3, d3, ray_mint(o3), torch.full_like(o3[:, 0], 1e30), live3)
    shadow3 = shadow_rays(scene, o3, d3, seed=3, live=live3)
    print(f"[leaf] bounce-3 wavefront: {int(live3.sum())} of "
          f"{live3.shape[0]} lanes live, {int(shadow3[4].sum())} shadow "
          f"rays", flush=True)
    compare("leaf bounce 3", scene, *bounce3, errs)
    compare("leaf bounce-3 shadow", scene, *shadow3, errs)
    for name, any_hit, rays, rays3 in (
            ("trace_closest", False, primary, bounce3),
            ("trace_any", True, shadow, shadow3)):
        leaf[name] = {"max_abs_err": errs[name],
                      **measure(f"{name}, leaf bounce 0", any_hit, scene,
                                rays, 3, card),
                      "bounce_3": measure(f"{name}, leaf bounce 3", any_hit,
                                          scene, rays3, 3, card)}
    walk = {"traces": {"leaf b0 closest": (scene, primary, False),
                       "leaf b0 any": (scene, shadow, True),
                       "leaf b3 closest": (scene, bounce3, False),
                       "leaf b3 any": (scene, shadow3, True)},
            "shade": {}}

    # ---- 11. mega_bounce, lane by lane --------------------------------------
    fam_ops = family_ops(tables)
    print(f"[leaf] fp32 ops by family (eval, sample): {fam_ops}", flush=True)
    works, work_pass = pass_work(tables, st0, pix, samp, depth)
    st, err = st0, 0.0
    for b in range(max(LEAF_BOUNCES) + 1):
        if b in LEAF_BOUNCES:
            k = mk.run_bounce(tables, rr, depth, st, pix, samp, 0, b)
            p = mk.bounce_plain(tables, rr, depth, st, pix, samp, 0, b)
            err = max(err, compare_rows(f"leaf mega_bounce, bounce {b}", k,
                                        p))
        st = mk.bounce_plain(tables, rr, depth, st, pix, samp, 0, b)[:16]
    mk.reset_launches()
    st, counts = st0, torch.zeros_like(st0[:2])
    for b in range(depth):
        out = mk.run_bounce(tables, rr, depth, st, pix, samp, 0, b)
        st, counts = out[:16], counts + out[16:18]
    torch.cuda.synchronize()
    launches = mk.LAUNCHES["mega_bounce"]
    ref = mk.run_path(tables, rr, depth, depth, st0, pix, samp, 0)
    check(launches == depth, f"leaf mega_bounce launched {launches} times")
    check(torch.equal(st, ref[:16]) and torch.equal(counts, ref[16:18]),
          "leaf: bounce-by-bounce pass differs from mega_path")
    out0 = mk.run_bounce(tables, rr, depth, st0, pix, samp, 0, 0)
    leaf["mega_bounce"] = {
        "launches": launches, "max_abs_err": err,
        "ms": time_ms(lambda: mk.run_bounce(tables, rr, depth, st0, pix,
                                            samp, 0, 0), 50),
        "plain_ms": time_ms(lambda: mk.bounce_plain(
            tables, rr, depth, st0, pix, samp, 0, 0), 3, warmup=1),
        **mega_bound("leaf mega_bounce, bounce 0", works[0],
                     int(out0[16].sum()), int(out0[17].sum()), 0,
                     pix.shape[0], 16, 18, tables, card)}

    # ---- 12. mega_path: render() against the eager render -------------------
    eager = PathTracer(max_depth=depth)
    img_e, n_e = render_fn(scene, cam, film, eager, spp=LEAF_SPP, seed=0,
                           device=DEV)
    mk.reset_launches()
    img_m, n_m = render_fn(scene, cam, film, integ, spp=LEAF_SPP, seed=0,
                           device=DEV)
    torch.cuda.synchronize()
    launches = mk.LAUNCHES["mega_path"]
    n_e, n_m = int(n_e), int(n_m)
    print(f"[leaf mega path] render() with MegaPathTracer, {LEAF_SPP} spp: "
          f"{launches} mega_path launches, {n_m} rays (eager {n_e}), mean "
          f"{img_m.mean().item():.5f} (eager {img_e.mean().item():.5f})",
          flush=True)
    check(launches == LEAF_SPP, f"leaf mega_path launched {launches} times")
    check(bool(torch.isfinite(img_m).all()), "leaf mega_path image NaN/Inf")
    image_rule(img_m, img_e, f"leaf render MegaPathTracer vs eager, "
                             f"{LEAF_SPP} spp")
    check(abs(n_m - n_e) <= 1e-4 * n_e, f"leaf rays {n_m} vs {n_e}")
    k = mk.run_path(tables, rr, depth, depth, st0, pix, samp, 0)
    p = mk.path_plain(tables, rr, depth, depth, st0, pix, samp, 0)
    leaf["mega_path"] = {
        "launches": launches,
        "max_abs_err": compare_rows("leaf mega_path, one sample", k, p),
        "ms": time_ms(lambda: mk.run_path(tables, rr, depth, depth, st0, pix,
                                          samp, 0), 20),
        "plain_ms": time_ms(lambda: mk.path_plain(
            tables, rr, depth, depth, st0, pix, samp, 0), 1, warmup=1),
        **mega_bound("leaf mega_path, one sample", work_pass,
                     int(k[16].sum()), int(k[17].sum()), 0, pix.shape[0],
                     16, 18, tables, card)}

    # ---- 13. mega_persistent ------------------------------------------------
    img_r, n_r = render_persistent(integ, cam, LEAF_SPP, seed=0)
    n_r = int(n_r)
    print(f"[leaf persistent] {LEAF_SPP} spp: {n_r} rays (eager {n_e}), "
          f"mean {img_r.mean().item():.5f}", flush=True)
    image_rule(img_r, img_e, f"leaf render_persistent vs eager, {LEAF_SPP} "
                             "spp")
    check(abs(n_r - n_e) <= 1e-4 * n_e, f"leaf persistent rays {n_r}")
    pst = torch.cat([st0, torch.zeros_like(st0[:8])])
    run_p = lambda spp: mk.run_persistent(tables, rr, depth, spp, cam, pst,
                                          pix, samp, 0)
    run_p(LEAF_PERSIST_SPP)
    mk.reset_launches()
    ms, out = events_ms(lambda: run_p(LEAF_PERSIST_SPP))
    launches = mk.LAUNCHES["mega_persistent"]
    rays = int(out[22].sum()) + int(out[23].sum())
    check((out[17] == LEAF_PERSIST_SPP).all().item(), "leaf spp not done")
    check(bool(torch.isfinite(out[18:21]).all()), "leaf persistent NaN/Inf")
    print(f"[leaf persistent] {res}², {LEAF_PERSIST_SPP} spp: one launch "
          f"{ms:.4f} ms (CUDA events), {rays} rays, {rays / ms * 1e3:.6g} "
          f"rays/s in the kernel, mean "
          f"{(out[18:21] / LEAF_PERSIST_SPP).mean().item():.5f} ({card})",
          flush=True)
    sub = slice(0, None, LEAF_PLAIN_LANES)
    pst_s = pst[:, sub].contiguous()
    pix_s, samp_s = pix[sub].contiguous(), samp[sub].contiguous()
    k = mk.run_persistent(tables, rr, depth, LEAF_PLAIN_SPP, cam, pst_s,
                          pix_s, samp_s, 0)
    plain_ms, p = events_ms(lambda: mk.persistent_plain(
        tables, rr, depth, LEAF_PLAIN_SPP, cam, pst_s, pix_s, samp_s, 0))
    leaf["mega_persistent"] = {
        "launches": launches, "ms": ms,
        "max_abs_err": compare_rows(
            f"leaf mega_persistent, {pix_s.shape[0]} lanes x "
            f"{LEAF_PLAIN_SPP} spp", k, p),
        "plain_ms": plain_ms,
        "plain_shape": f"{pix_s.shape[0]} lanes x {LEAF_PLAIN_SPP} spp",
        "ms_at_plain_shape": time_ms(lambda: mk.run_persistent(
            tables, rr, depth, LEAF_PLAIN_SPP, cam, pst_s, pix_s, samp_s, 0),
            3, warmup=1),
        **mega_bound(f"leaf mega_persistent, {LEAF_PERSIST_SPP} spp",
                     work_pass, int(out[22].sum()), int(out[23].sum()),
                     LEAF_PERSIST_SPP * pix.shape[0], pix.shape[0], 24, 24,
                     tables, card)}
    walk["persistent"] = {
        f"leaf {LEAF_PERSIST_SPP} spp": (lambda: run_p(LEAF_PERSIST_SPP),
                                         out),
        f"leaf {pix_s.shape[0]} lanes x {LEAF_PLAIN_SPP} spp (plain)": (
            lambda: mk.run_persistent(tables, rr, depth, LEAF_PLAIN_SPP, cam,
                                      pst_s, pix_s, samp_s, 0), p)}

    # ---- 14. the shade kernel: rough plastic swapped, every material
    # two-sided; then one-sided for the timing --------------------------------
    scene_s = leaf_scene(res, rough_plastic=False)[0]
    scene_2s = leaf_scene(res, rough_plastic=False, two_sided=True)[0]
    ok, why = sk.supports(scene_2s)
    check(ok, f"shade refuses the swapped leaf scene: {why}")
    fam_ops = family_ops(mk.build_mega_tables(scene_s))
    err, timing, n_flips = 0.0, {}, 0
    for sc in (scene_2s, scene_s):
        two_sided = sc is scene_2s
        tracer = PathTracer(max_depth=depth).specialized_for(sc)
        st = st0
        for b in range(max(LEAF_BOUNCES) + 1):
            if b in LEAF_BOUNCES:
                label = f"leaf shade, bounce {b}" + ", two-sided" * two_sided
                packed = tracer.shade_inputs(sc, st, 0, pix, samp, b)
                run = lambda: sk.run_shade(sc, packed, pix, samp, 0, b, rr,
                                           depth)
                plain = lambda: sk.shade_plain(sc, packed, pix, samp, 0, b,
                                               rr, depth)
                ref = plain()
                err = max(err, compare_rows(label, run(), ref))
                act = packed[sk.I_ACT] > 0.5
                share = sk.shadow_rays(packed, b, depth)[4]
                flips = ((sk._front(packed, b, depth).fsign < 0)
                         & (packed[sk.I_HIT] > 0.5))
                print(f"[leaf shade] {label}: {act.float().mean().item():.4f}"
                      f" of lanes active, {share.float().mean().item():.4f} "
                      f"trace a shadow ray, {flips.float().mean().item():.4f}"
                      f" flip", flush=True)
                if two_sided:
                    n_flips += int(flips.sum())
                else:
                    timing[b] = {"ms": time_ms(run, 50),
                                 "plain_ms": time_ms(plain, 2, warmup=1),
                                 **shade_bound(label, sc, packed, b, rr,
                                               fam_ops, card)}
                    print(f"[leaf shade] {label}: kernel "
                          f"{timing[b]['ms'] * 1e3:.2f} us/launch, plain "
                          f"{timing[b]['plain_ms']:.3f} ms ({card})",
                          flush=True)
                    walk["shade"][f"leaf b{b}"] = (functools.partial(
                        sk.run_shade, sc, packed, pix, samp, 0, b, rr,
                        depth), ref)
            st = tracer.bounce(sc, st, 0, pix, samp, b)[0]
    check(n_flips > 0, "leaf shade: no lane flipped")
    del scene_2s

    # ---- 15. the eager path, tail off and fused, 16 spp ---------------------
    results = {}
    for mode in ("off", "on"):
        integ_e = PathTracer(max_depth=depth, fused_shade=mode)
        render_fn(scene_s, cam, film, integ_e, spp=1, seed=0, device=DEV)
        torch.cuda.synchronize()                            # (warm-up)
        trace.reset_launches()
        sk.reset_launches()
        t0 = time.perf_counter()
        img, n = render_fn(scene_s, cam, film, integ_e, spp=LEAF_EAGER_SPP,
                           seed=0, device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**trace.LAUNCHES, **sk.LAUNCHES}
        results[mode] = (img, int(n), launches)
        print(f"[leaf fused {mode}] {res}², {depth} bounces, "
              f"{LEAF_EAGER_SPP} spp: {wall:.3f} s, {int(n)} rays, "
              f"{int(n) / wall:.4g} rays/s, mean {img.mean().item():.5f}, "
              f"launches {launches} ({card})", flush=True)
        check(bool(torch.isfinite(img).all()), f"leaf fused {mode}: NaN/Inf")
        profile_pass(scene_s, cam, film, integ_e, card)
    (img_off, n_off, l_off), (img_on, n_on, l_on) = results["off"], \
        results["on"]
    check(l_on["shade"] == depth * LEAF_EAGER_SPP,
          f"leaf shade launched {l_on['shade']} times")
    image_rule(img_on, img_off, f"leaf fused on vs off, {LEAF_EAGER_SPP} spp")
    check(abs(n_on - n_off) <= 1e-4 * n_off, f"leaf rays {n_on} vs {n_off}")
    # the persistent kernel on the same scene and spp
    integ_s = MegaPathTracer.for_scene(scene_s, max_depth=depth)
    img_p, n_p = render_persistent(integ_s, cam, LEAF_EAGER_SPP, seed=0)
    image_rule(img_p, img_off,
               f"leaf render_persistent vs eager, {LEAF_EAGER_SPP} spp")
    check(abs(int(n_p) - n_off) <= 1e-4 * n_off,
          f"leaf persistent rays {int(n_p)} vs {n_off}")
    leaf["shade"] = {"launches": l_on["shade"], "max_abs_err": err,
                     **timing[LEAF_BOUNCES[0]],
                     "bounce_3": timing[LEAF_BOUNCES[1]]}
    for name in ("trace_closest", "trace_any"):
        leaf[name]["launches"] = l_off[name]
    for k in kernels:
        k["leaf_families"] = leaf[k["name"]]
    return walk


def walk_phase(card, cases):
    """Phase 16: each build of WALK_VARIANTS in the turns of WALK_TURNS on
    the same inputs. cases["traces"]: name -> (scene, rays, any_hit), each
    launch held to the plain version bit for bit, then timed;
    cases["persistent"]: name -> (run, reference output), each launch
    held equal to its reference bit for bit and timed by CUDA events,
    but for the entries ending "(plain)": those have persistent_plain's
    output, come first in each turn, load the build's kernels, and are
    not timed;
    cases["bench"]: the bench-scale rays/s, and cases["shade"]: name ->
    (run, shade_plain's output), each held equal bit for bit and timed,
    for "old" and "new" (the other variants leave shade.cu as it is).
    Prints the times by turn and their means by variant, and
    {"walk": ...}."""
    from mitsuba_tpu_torch.accel import dense, trace
    refs = {name: dense.intersect_soup(rays[0], rays[1], scene.woop_o,
                                       *rays[2:])
            for name, (scene, rays, _) in cases["traces"].items()}
    persistent = sorted(cases["persistent"].items(),
                        key=lambda kv: not kv[0].endswith("(plain)"))
    turns = []
    for variant in WALK_TURNS:
        row = {}
        with walk_build(*WALK_VARIANTS[variant]):
            for name, (scene, rays, any_hit) in cases["traces"].items():
                run = lambda: trace.trace(scene, *rays, any_hit)
                t, tri, u, v, hit = run()
                pt, ptri, pu, pv, phit = refs[name]
                same = torch.equal(hit, phit) and (any_hit or (
                    torch.equal(t, pt) and torch.equal(tri.long(), ptri)
                    and torch.equal(u, pu) and torch.equal(v, pv)))
                check(same, f"walk {variant}: {name} differs from plain")
                row[f"trace {name}"] = time_ms(run, 20)
            for name, (run, ref) in persistent:
                ms, out = events_ms(run)
                check(torch.equal(out, ref),
                      f"walk {variant}: {name} differs from its reference")
                if not name.endswith("(plain)"):
                    row[f"persistent {name}"] = ms
            if variant in ("old", "new"):
                row["cornell bench rays/s"] = cases["bench"]()
                for name, (run, ref) in cases["shade"].items():
                    check(torch.equal(run(), ref),
                          f"walk {variant}: shade {name} differs from plain")
                    row[f"shade {name}"] = time_ms(run, 50)
        turns.append({"variant": variant, **row})
        print(f"[walk] {variant}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in row.items()) + f" ({card})",
            flush=True)
    means = {}
    for variant in WALK_VARIANTS:
        rows = [t for t in turns if t["variant"] == variant]
        means[variant] = {k: sum(r[k] for r in rows) / len(rows)
                          for k in rows[0] if k != "variant"}
    for name in turns[0]:
        if name != "variant":
            print(f"[walk] mean {name}: " + ", ".join(
                f"{v} {m[name]:.6g}" for v, m in means.items()
                if name in m), flush=True)
    print(json.dumps({"walk": {"default_T": WALK_DEFAULT_T, "card": card,
                               "variants": {k: list(v) for k, v in
                                            WALK_VARIANTS.items()},
                               "turns": turns}}), flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.accel import shade_kernel as sk
    from mitsuba_tpu_torch.accel import trace
    from mitsuba_tpu_torch.core import transform as tf
    from mitsuba_tpu_torch.film.film import Film
    from mitsuba_tpu_torch.integrator.mega import (MegaPathTracer,
                                                   render_persistent)
    from mitsuba_tpu_torch.integrator.path import PathTracer, initial_state
    from mitsuba_tpu_torch.render import render_fn
    from mitsuba_tpu_torch.scene.builder import compile_scene
    from mitsuba_tpu_torch.scene.presets import cornell_box, cornell_camera
    from mitsuba_tpu_torch.scene.shapes import sphere

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # ---- 1. build (one nvcc per build, all started together) -----------
    variant_builds = start_variant_builds()
    t0 = time.perf_counter()
    run_builds(build_jobs(False), shown=((),))
    print(f"[build] 3 libraries, {time.perf_counter() - t0:.1f} s",
          flush=True)
    props = torch.cuda.get_device_properties(0)
    print(f"[build] {props.multi_processor_count} SMs; one lane per pixel "
          f"gives {CORNELL_RES ** 2 // 32 / props.multi_processor_count:.1f}"
          f" warps per SM at {CORNELL_RES}²", flush=True)

    # ---- 2. kernel vs plain, Cornell --------------------------------------
    errs = {"trace_closest": 0.0, "trace_any": 0.0}
    scene = compile_scene(cornell_box(), device=DEV)
    check(scene.woop_clusters.shape[0] == 8, "Cornell should have 8 clusters")
    cam = cornell_camera(CORNELL_RES, CORNELL_RES)
    o, d = camera_rays(cam, CORNELL_RES)
    from mitsuba_tpu_torch.integrator.common import ray_mint
    primary = (o, d, ray_mint(o), torch.full_like(o[:, 0], 1e30), None)
    shadow = shadow_rays(scene, o, d)
    compare("cornell primary", scene, *primary, errs)
    compare("cornell shadow", scene, *shadow, errs)

    # ---- 3. kernel vs plain, 261k triangles (row 2's regime) --------------
    desc = cornell_box()
    desc.add_shape(sphere(*LARGE_SPHERE), material=0,
                   to_world=tf.translate([0.5, 0.75, 0.5]) @ tf.scale(0.2))
    big = compile_scene(desc, device=DEV)
    table_mb = big.woop_clusters.numel() * 4 / 2**20
    print(f"[large] {big.n_tris} triangles, {big.woop_clusters.shape[0]} "
          f"clusters, Woop table {table_mb:.1f} MiB", flush=True)
    check(table_mb > TABLE_SWITCH_MB,
          f"large scene's table should exceed {TABLE_SWITCH_MB} MiB")
    ob, db = camera_rays(cornell_camera(LARGE_RES, LARGE_RES), LARGE_RES,
                         seed=1)
    compare("large primary", big, ob, db, ray_mint(ob),
            torch.full_like(ob[:, 0], 1e30), None, errs)
    big_shadow = shadow_rays(big, ob, db, seed=1)
    compare("large shadow", big, *big_shadow, errs)
    big_primary = (ob, db, ray_mint(ob), torch.full_like(ob[:, 0], 1e30),
                   None)
    measure("trace_closest, large primary", False, big, big_primary, 2,
            card)
    measure("trace_any, large shadow", True, big, big_shadow, 2, card)
    del big, big_primary, big_shadow

    # ---- 4. the main path at full size ------------------------------------
    film = Film(CORNELL_RES, CORNELL_RES, "box")
    integrator = PathTracer(max_depth=MAX_DEPTH)
    render_fn(scene, cam, film, integrator, spp=1, seed=0, device=DEV)
    torch.cuda.synchronize()                                # (warm-up)
    trace.reset_launches()
    t0 = time.perf_counter()
    img, n_rays = render_fn(scene, cam, film, integrator, spp=SPP, seed=0,
                            device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(trace.LAUNCHES)
    n_rays = int(n_rays)
    mean = img.mean().item()
    print(f"[main path] Cornell {CORNELL_RES}², {MAX_DEPTH} bounces, {SPP} "
          f"spp: {wall:.3f} s, {n_rays} rays, {n_rays / wall:.4g} rays/s, "
          f"mean {mean:.5f}, launches {launches} ({card})", flush=True)
    check(img.shape == (CORNELL_RES, CORNELL_RES, 3), f"shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "image has NaN/Inf")
    check(0.2 <= mean <= 0.3, f"image mean {mean} outside [0.2, 0.3]")
    for key in launches:
        check(launches[key] == MAX_DEPTH * SPP,
              f"{key}: {launches[key]} launches, want {MAX_DEPTH * SPP}")
    check(sum(launches.values()) == 2 * MAX_DEPTH * SPP, "launch total")

    kernels = []
    for name, any_hit, rays in (("trace_closest", False, primary),
                                ("trace_any", True, shadow)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mitsuba_tpu_torch/csrc/trace.cu",
            "replaces": "mitsuba_tpu/accel/pallas_trace.py:132",
            "launches": launches[name], "max_abs_err": errs[name],
            **measure(f"{name}, main path bounce 0", any_hit, scene, rays,
                      10, card),
            "library_ms": None})

    profile_pass(scene, cam, film, integrator, card)

    # ---- 5. kernel path against plain path, whole render -------------------
    small_spp = MEGA_SPP
    img_k = render_fn(scene, cam, film, integrator, spp=small_spp, seed=0,
                      device=DEV)[0]
    img_p, n_plain = render_fn(scene, cam, film,
                               PathTracer(max_depth=MAX_DEPTH, accel="plain"),
                               spp=small_spp, seed=0, device=DEV)
    torch.cuda.synchronize()
    image_rule(img_k, img_p, f"render kernel vs plain, {small_spp} spp")

    # ---- 6. mega_bounce ---------------------------------------------------
    integ = MegaPathTracer.for_scene(scene, max_depth=MAX_DEPTH)
    tables, rr = integ.tables, integ.rr_depth
    pix = torch.arange(CORNELL_RES ** 2, dtype=torch.int32, device=DEV)
    samp = torch.zeros_like(pix)
    o0, d0 = mk.primary_rays(cam, 0, pix, 0)
    st0 = initial_state(o0, d0)
    states = [st0]          # the plain wavefront before each bounce
    for b in range(MAX_DEPTH - 1):
        states.append(mk.bounce_plain(tables, rr, MAX_DEPTH, states[-1], pix,
                                      samp, 0, b)[:16])
    bounce_err = 0.0
    for b in (0, 5):
        k = mk.run_bounce(tables, rr, MAX_DEPTH, states[b], pix, samp, 0, b)
        pl = mk.bounce_plain(tables, rr, MAX_DEPTH, states[b], pix, samp, 0,
                             b)
        bounce_err = max(bounce_err,
                         compare_rows(f"mega_bounce, bounce {b}", k, pl))
    # the bounce path: one sample pass bounce by bounce through run_bounce
    mk.reset_launches()
    st, counts = st0, torch.zeros_like(st0[:2])
    for b in range(MAX_DEPTH):
        out = mk.run_bounce(tables, rr, MAX_DEPTH, st, pix, samp, 0, b)
        st, counts = out[:16], counts + out[16:18]
    torch.cuda.synchronize()
    bounce_launches = mk.LAUNCHES["mega_bounce"]
    ref = mk.run_path(tables, rr, MAX_DEPTH, MAX_DEPTH, st0, pix, samp, 0)
    same = torch.equal(st, ref[:16]) and torch.equal(counts, ref[16:18])
    print(f"[bounce path] {bounce_launches} mega_bounce launches for one "
          f"sample pass; equal to mega_path on the same rays: {same}",
          flush=True)
    check(bounce_launches == MAX_DEPTH,
          f"mega_bounce launched {bounce_launches} times")
    check(same, "bounce-by-bounce pass differs from mega_path")
    work, work_pass = pass_work(tables, st0, pix, samp, MAX_DEPTH)
    out0 = mk.run_bounce(tables, rr, MAX_DEPTH, st0, pix, samp, 0, 0)
    kernels.append({
        "name": "mega_bounce", "route": "cuda",
        "source": "mitsuba_tpu_torch/csrc/megakernel.cu",
        "replaces": "mitsuba_tpu/accel/megakernel.py:1395",
        "launches": bounce_launches, "max_abs_err": bounce_err,
        "ms": time_ms(lambda: mk.run_bounce(tables, rr, MAX_DEPTH, st0, pix,
                                            samp, 0, 0), 50),
        "plain_ms": time_ms(lambda: mk.bounce_plain(
            tables, rr, MAX_DEPTH, st0, pix, samp, 0, 0), 5, warmup=1),
        **mega_bound("mega_bounce, bounce 0", work[0],
                     int(out0[16].sum()), int(out0[17].sum()), 0,
                     pix.shape[0], 16, 18, tables, card),
        "library_ms": None})

    # ---- 7. mega_path: render() with MegaPathTracer ------------------------
    mk.reset_launches()
    img_m, n_mega = render_fn(scene, cam, film, integ, spp=MEGA_SPP, seed=0,
                              device=DEV)
    torch.cuda.synchronize()
    path_launches = mk.LAUNCHES["mega_path"]
    n_mega, n_plain = int(n_mega), int(n_plain)
    print(f"[mega path] render() with MegaPathTracer, {MEGA_SPP} spp: "
          f"{path_launches} mega_path launches, {n_mega} rays (plain "
          f"{n_plain}), mean {img_m.mean().item():.5f}", flush=True)
    check(path_launches == MEGA_SPP,
          f"mega_path launched {path_launches} times, want {MEGA_SPP}")
    image_rule(img_m, img_p, f"render MegaPathTracer vs plain, {MEGA_SPP} spp")
    check(abs(n_mega - n_plain) <= 1e-4 * n_plain,
          f"ray counts {n_mega} vs {n_plain}")
    k = mk.run_path(tables, rr, MAX_DEPTH, MAX_DEPTH, st0, pix, samp, 0)
    pl = mk.path_plain(tables, rr, MAX_DEPTH, MAX_DEPTH, st0, pix, samp, 0)
    path_err = compare_rows("mega_path, one sample", k, pl)
    kernels.append({
        "name": "mega_path", "route": "cuda",
        "source": "mitsuba_tpu_torch/csrc/megakernel.cu",
        "replaces": "mitsuba_tpu/accel/megakernel.py:1423",
        "launches": path_launches, "max_abs_err": path_err,
        "ms": time_ms(lambda: mk.run_path(tables, rr, MAX_DEPTH, MAX_DEPTH,
                                          st0, pix, samp, 0), 20),
        "plain_ms": time_ms(lambda: mk.path_plain(
            tables, rr, MAX_DEPTH, MAX_DEPTH, st0, pix, samp, 0), 2,
            warmup=1),
        **mega_bound("mega_path, one sample", work_pass, int(k[16].sum()),
                     int(k[17].sum()), 0, pix.shape[0], 16, 18, tables,
                     card),
        "library_ms": None})

    # ---- 8. mega_persistent: render_persistent -----------------------------
    img_r, n_r = render_persistent(integ, cam, PERSIST_SPP, seed=0)
    torch.cuda.synchronize()
    n_r = int(n_r)
    print(f"[persistent] {PERSIST_SPP} spp: {n_r} rays (eager {n_rays}), "
          f"mean {img_r.mean().item():.5f} (eager {mean:.5f})", flush=True)
    check(bool(torch.isfinite(img_r).all()), "persistent image has NaN/Inf")
    image_rule(img_r, img, f"render_persistent vs eager, {PERSIST_SPP} spp")
    check(abs(n_r - n_rays) <= 1e-4 * n_rays,
          f"persistent ray count {n_r} vs eager {n_rays}")
    pst = torch.cat([st0, torch.zeros_like(st0[:8])])
    run_p = lambda spp, seed: mk.run_persistent(
        tables, rr, MAX_DEPTH, spp, cam, pst, pix, samp, seed)
    k = run_p(PERSIST_PLAIN_SPP, 0)
    plain_ms, pl = events_ms(lambda: mk.persistent_plain(
        tables, rr, MAX_DEPTH, PERSIST_PLAIN_SPP, cam, pst, pix, samp, 0))
    persist_err = compare_rows(f"mega_persistent, {PERSIST_PLAIN_SPP} spp",
                               k, pl)
    k = run_p(PERSIST_SPP, 0)
    persist_row = {
        "ms": time_ms(lambda: run_p(PERSIST_SPP, 0), 5, warmup=1),
        "plain_ms": plain_ms,
        "plain_shape": f"{pix.shape[0]} lanes x {PERSIST_PLAIN_SPP} spp",
        "ms_at_plain_shape": time_ms(lambda: run_p(PERSIST_PLAIN_SPP, 0), 5,
                                     warmup=1),
        **mega_bound(f"mega_persistent, {PERSIST_SPP} spp", work_pass,
                     int(k[22].sum()), int(k[23].sum()),
                     PERSIST_SPP * pix.shape[0], pix.shape[0], 24, 24,
                     tables, card)}

    # the bench.py scale: one warm-up pass, two timed passes
    def bench_passes():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        passes = [render_persistent(integ, cam, BENCH_SPP, seed=s)
                  for s in BENCH_SEEDS]
        torch.cuda.synchronize()
        return time.perf_counter() - t0, passes

    render_persistent(integ, cam, BENCH_SPP, seed=0)
    mk.reset_launches()
    bench_wall, bench = bench_passes()
    persist_launches = mk.LAUNCHES["mega_persistent"]
    bench_rays = sum(int(n) for _, n in bench)
    print(f"[bench] Cornell {CORNELL_RES}², {MAX_DEPTH} bounces, {BENCH_SPP}"
          f" spp x {len(BENCH_SEEDS)} passes: {bench_wall:.4f} s, "
          f"{bench_rays} rays, {bench_rays / bench_wall:.6g} rays/s, means "
          f"{[round(i.mean().item(), 5) for i, _ in bench]}, "
          f"{persist_launches} mega_persistent launches ({card})",
          flush=True)
    check(persist_launches == len(BENCH_SEEDS),
          f"mega_persistent launched {persist_launches} times")
    for i, _ in bench:
        check(bool(torch.isfinite(i).all()) and 0.2 <= i.mean().item() <= 0.3,
              "bench image not finite or mean outside [0.2, 0.3]")
    bench_out = {}
    for s in BENCH_SEEDS:
        ms_s, out = bench_out[s] = events_ms(lambda: run_p(BENCH_SPP, s))
        rays_s = int(out[22].sum()) + int(out[23].sum())
        print(f"[bench] mega_persistent launch, seed {s}: {ms_s:.4f} ms "
              f"(CUDA events), {rays_s} rays, {rays_s / ms_s * 1e3:.6g} "
              f"rays/s in the kernel ({card})", flush=True)
        mega_bound(f"mega_persistent, {BENCH_SPP} spp, seed {s}", work_pass,
                   int(out[22].sum()), int(out[23].sum()),
                   BENCH_SPP * pix.shape[0], pix.shape[0], 24, 24, tables,
                   card)
    kernels.append({
        "name": "mega_persistent", "route": "cuda",
        "source": "mitsuba_tpu_torch/csrc/megakernel.cu",
        "replaces": "mitsuba_tpu/accel/megakernel.py:2478",
        "launches": persist_launches, "max_abs_err": persist_err,
        **persist_row, "library_ms": None})

    shade_row, shade_walk = shade_phases(card)
    kernels.append(shade_row)
    walk = leaf_phases(card, kernels)
    walk["shade"].update(shade_walk)
    s1 = BENCH_SEEDS[0]
    walk["traces"].update({"cornell b0 closest": (scene, primary, False),
                           "cornell b0 any": (scene, shadow, True)})
    walk["persistent"].update({
        f"cornell {PERSIST_PLAIN_SPP} spp (plain)": (
            lambda: run_p(PERSIST_PLAIN_SPP, 0), pl),
        f"cornell {BENCH_SPP} spp, seed {s1}": (
            lambda: run_p(BENCH_SPP, s1), bench_out[s1][1])})
    def bench_rate():
        wall, passes = bench_passes()
        return sum(int(n) for _, n in passes) / wall

    walk["bench"] = bench_rate
    join_variant_builds(*variant_builds)
    walk_phase(card, walk)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
