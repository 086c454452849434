#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mitsuba_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
  1. build csrc/trace.cu, csrc/megakernel.cu and csrc/shade.cu with nvcc
     for sm_90a, one nvcc per source, started together, and print
     ptxas's register and spill reports;
  2. hold the trace kernel against its plain PyTorch version on the Cornell
     box: 256² primary rays and one bounce of NEE shadow rays, closest-hit
     and any-hit;
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
     eager image and counts, and against persistent_plain lane by lane;
     then the bench.py scale: 256², 2048 spp, one warm-up pass and two
     timed passes (counted), with rays/s and the kernel's time by CUDA
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
     each.

The last two lines are the card's name and power limit, as nvidia-smi
reports them, and {"ok": true, "device": {...}}; the line before them lists
every ported kernel with its launches, error and times. Exits non-zero
without a CUDA device, and without the package beside it.
"""
import concurrent.futures
import json
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
BENCH_SPP = 2048            # bench.py:33-36: 256², 2048 spp, 2 timed passes
BENCH_SEEDS = (1, 2)
# fp32 operations of one megakernel bounce outside its two traces, counted
# from csrc/megakernel.cu path_bounce for a lane whose ray hits (add, sub,
# mul, div, sqrt, rsqrt, min, max, abs, cos, sin and int->float each 1;
# compares and integer RNG work not counted)
SHADE_OPS = {"ray mint": 7, "hit record (normal, point)": 39,
             "emitter hit + MIS": 28, "shading frame": 16,
             "wi to local": 18, "RNG floats (NEE)": 6,
             "emitter sample": 55, "wo to local": 15, "diffuse f": 7,
             "shadow origin, mint, maxt": 27, "NEE MIS + L": 17,
             "BSDF sample, next ray": 62, "Russian roulette": 11}
CAMERA_OPS = 41             # camera_path: jitter, pinhole ray, normalize
# the fused shade phases: the four-material scene of
# tests/test_pallas_tpu.py:160-183 at 256², 6 bounces, 64 spp
SHADE_DEPTH = 6
SHADE_BOUNCES = (0, 3)
# fp32 operations of the fused shade kernel for one active lane, counted
# from csrc/shade.cu and csrc/bsdf_common.cuh as SHADE_OPS is: the work
# every active lane does, the BSDF eval toward the light by family (only
# where wi and wo are both above the surface), the BSDF sample by family,
# the shadow ray's origin and range (lanes that trace it) and Russian
# roulette (bounces past rr_depth)
SHADE_KERNEL_OPS = {"common": 127, "shadow setup": 8, "roulette": 4,
                    "eval": {0: 7, 2: 191},
                    "sample": {0: 18, 1: 104, 2: 262, 3: 38}}
SHADE_ROWS_IN, SHADE_ROWS_OUT = 50, 16
SHADE_ROWS_DEAD = 11        # act, p, d, L, eta: what an inactive lane reads

def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


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


def shadow_rays(scene, o, d, seed=0):
    """One NEE shadow ray from each primary hit toward the area light."""
    from mitsuba_tpu_torch.accel import dense
    from mitsuba_tpu_torch.core import rng
    from mitsuba_tpu_torch.core.math import SHADOW_EPSILON
    from mitsuba_tpu_torch.emitter.emitter import sample_direct
    from mitsuba_tpu_torch.integrator.common import (offset_ray_origin,
                                                     ray_mint)
    n = o.shape[0]
    its = dense.ray_intersect(scene, o, d, ray_mint(o),
                              torch.full((n,), 1e30, device=DEV))
    px = torch.arange(n, device=DEV)
    ds = sample_direct(scene, its.p, rng.sample_1d(seed, px, 4),
                       rng.sample_2d(seed, px, 5))
    so = offset_ray_origin(its.p, its.ng, ds.d)
    live = its.valid & (ds.pdf > 0)
    return (so, ds.d, ray_mint(so), ds.dist * (1.0 - SHADOW_EPSILON),
            live)


def compare(label, scene, o, d, mint, maxt, live, errs):
    """Kernel against plain version, closest-hit and any-hit, on the same
    rays. Limits: hit equal on ≥ 99.99% of lanes; where both hit, the same
    triangle, t rel ≤ 1e-5, u and v abs ≤ 1e-5."""
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
    torch.cuda.synchronize()
    print(f"[{label}] rays {o.shape[0]}  closest: hit agree {agree:.6f}, "
          f"shared hits {n_both}, same tri {tri_ok}, max t rel {t_rel:.3g}, "
          f"max uv abs {uv_abs:.3g}  any: hit agree {agree_any:.6f}, "
          f"occluded {ko.float().mean().item():.4f}", flush=True)
    check(agree >= 0.9999, f"{label}: closest-hit agreement {agree}")
    check(tri_ok, f"{label}: triangle ids differ on shared hits")
    check(t_rel <= 1e-5, f"{label}: t rel error {t_rel}")
    check(uv_abs <= 1e-5, f"{label}: u/v abs error {uv_abs}")
    check(agree_any >= 0.9999, f"{label}: any-hit agreement {agree_any}")
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


def bounce_work(scene, state, pix, samp, bounce, seed=0):
    """needed_work for one bounce of the megakernel: the closest-hit rays
    of the live lanes and the shadow rays the kernel traces (attempted
    NEE with the diffuse BSDF nonzero toward the light: wi and wo above
    the shading normal). Returns a dict of ray counts, ops and table
    bytes."""
    from mitsuba_tpu_torch.accel import dense
    from mitsuba_tpu_torch.core import rng
    from mitsuba_tpu_torch.core.math import SHADOW_EPSILON, dot
    from mitsuba_tpu_torch.emitter.emitter import sample_direct
    from mitsuba_tpu_torch.integrator.common import (
        DIM_NEE_POS, DIM_NEE_SEL, bounce_dim, offset_ray_origin, ray_mint)
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
    attempted = its.valid & (bounce + 3 <= MAX_DEPTH + 1) & (ds.pdf > 0)
    traced = attempted & (dot(-d, its.ns) > 0) & (dot(ds.d, its.ns) > 0)
    so = offset_ray_origin(its.p, its.ng, ds.d)
    c_tests, c_ops, c_bytes = needed_work(scene, o, d, ray_mint(o), maxt,
                                          live, False)
    s_tests, s_ops, s_bytes = needed_work(
        scene, so, ds.d, ray_mint(so), ds.dist * (1.0 - SHADOW_EPSILON),
        traced, True)
    return {"trace": int(live.sum()), "hit": int(its.valid.sum()),
            "shadow": int(attempted.sum()), "c_ops": c_ops, "s_ops": s_ops,
            "tests": c_tests + s_tests, "table_bytes": max(c_bytes, s_bytes)}


def mega_bound(label, work, n_trace, n_shadow, n_paths, lanes, rows_in,
               rows_out, tables, card):
    """The card's least time for a megakernel launch that traced n_trace
    closest-hit rays, attempted n_shadow shadow rays and started n_paths
    camera paths: fp32 ops, the triangle tests' per ray as `work` (a
    sample of this run's rays, bounce_work) counts them, plus SHADE_OPS
    per hit and CAMERA_OPS per path, over 67 TFLOP/s; and the bytes, the
    tables once and the lane state in and out, over 3.35 TB/s."""
    shade = sum(SHADE_OPS.values())
    ops = (n_trace * (work["c_ops"] + work["hit"] * shade) / work["trace"]
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
          f"{work['hit'] / work['trace']:.4f} hits per ray x {shade} "
          f"shading ops, {n_shadow} shadow attempts x "
          f"{work['s_ops'] / max(work['shadow'], 1):.1f} test ops, "
          f"{n_paths} paths x {CAMERA_OPS} camera ops; {n_bytes} bytes) "
          f"({card})", flush=True)
    return out


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


def shade_bound(label, scene, packed, bounce, rr_depth, card):
    """The card's least time for one fused shade launch on these rows: the
    bytes over 3.35 TB/s and the fp32 operations over 67 TFLOP/s, each
    lane counted by what it does. A lane active on entry reads the K_IN
    rows and its pixel and sample ids; one inactive on entry reads only
    the SHADE_ROWS_DEAD rows it passes through; every lane writes the
    K_OUT rows; the NEE distance row is read only by the lanes that
    trace a shadow ray, and the table rows those rays need come on top.
    Operations: SHADE_KERNEL_OPS for each active lane by its family and
    branch, plus the shadow rays' triangle tests as needed_work counts
    them."""
    from mitsuba_tpu_torch.accel import shade_kernel as sk
    n = packed.shape[1]
    act = packed[sk.I_ACT] > 0.5
    n_act = int(act.sum())
    mtype = packed[sk.I_MAT + 12]
    fr = sk._front(packed, bounce, SHADE_DEPTH)
    both_up = (fr.wi[2] > 0) & (fr.wo[2] > 0)        # the eval branch runs
    so, sd, smint, smaxt, live = sk.shadow_rays(packed, bounce, SHADE_DEPTH)
    n_live = int(live.sum())
    ops = SHADE_KERNEL_OPS["common"] * n_act
    ops += SHADE_KERNEL_OPS["shadow setup"] * n_live
    if bounce + 2 >= rr_depth:
        ops += SHADE_KERNEL_OPS["roulette"] * n_act
    for fam, k in SHADE_KERNEL_OPS["eval"].items():
        ops += k * int((act & both_up & (mtype == fam)).sum())
    for fam, k in SHADE_KERNEL_OPS["sample"].items():
        ops += k * int((act & (mtype == fam)).sum())
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
    the kernel's entry of the kernels line."""
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.accel import shade_kernel as sk
    from mitsuba_tpu_torch.accel import trace
    from mitsuba_tpu_torch.film.film import Film
    from mitsuba_tpu_torch.integrator.path import PathTracer, initial_state
    from mitsuba_tpu_torch.render import render_fn

    # ---- 9. shade kernel vs shade_plain, 65,536 lanes ----------------
    scene, cam = four_materials(CORNELL_RES)
    print(f"[shade] four-material scene: {scene.n_tris} triangles, "
          f"{scene.woop_clusters.shape[0]} clusters", flush=True)
    pix = torch.arange(CORNELL_RES ** 2, dtype=torch.int32, device=DEV)
    samp = torch.zeros_like(pix)
    err, timing = 0.0, {}
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
                err = max(err, compare_rows(label, run(), plain()))
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
                                               tracer.rr_depth, card)}
                    print(f"[shade] {label}: kernel "
                          f"{timing[b]['ms'] * 1e3:.2f} us/launch, plain "
                          f"{timing[b]['plain_ms']:.3f} ms ({card})",
                          flush=True)
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
    b0 = timing[SHADE_BOUNCES[0]]
    return {"name": "shade", "route": "cuda",
            "source": "mitsuba_tpu_torch/csrc/shade.cu",
            "replaces": "mitsuba_tpu/accel/shade_kernel.py:75",
            "launches": l_on["shade"], "max_abs_err": err,
            **b0, "library_ms": None}


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

    # ---- 1. build (one nvcc per source, started together) -------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        builds = [pool.submit(trace.build), pool.submit(mk.build),
                  pool.submit(sk.build)]
        builds = [b.result() for b in builds]
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    for lib, report in builds:
        print(f"[build] {lib.name}\n{report}", flush=True)
        check("registers" in report, f"{lib.name}: no ptxas register report")
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
    work = [bounce_work(scene, st, pix, samp, b)
            for b, st in enumerate(states)]
    work_pass = {key: sum(w[key] for w in work) for key in work[0]}
    work_pass["table_bytes"] = max(w["table_bytes"] for w in work)
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
    k = run_p(PERSIST_SPP, 0)
    plain_ms, pl = events_ms(lambda: mk.persistent_plain(
        tables, rr, MAX_DEPTH, PERSIST_SPP, cam, pst, pix, samp, 0))
    persist_err = compare_rows(f"mega_persistent, {PERSIST_SPP} spp", k, pl)
    persist_row = {
        "ms": time_ms(lambda: run_p(PERSIST_SPP, 0), 5, warmup=1),
        "plain_ms": plain_ms,
        **mega_bound(f"mega_persistent, {PERSIST_SPP} spp", work_pass,
                     int(k[22].sum()), int(k[23].sum()),
                     PERSIST_SPP * pix.shape[0], pix.shape[0], 24, 24,
                     tables, card)}

    # the bench.py scale: one warm-up pass, two timed passes
    render_persistent(integ, cam, BENCH_SPP, seed=0)
    torch.cuda.synchronize()
    mk.reset_launches()
    t0 = time.perf_counter()
    bench = [render_persistent(integ, cam, BENCH_SPP, seed=s)
             for s in BENCH_SEEDS]
    torch.cuda.synchronize()
    bench_wall = time.perf_counter() - t0
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
    for s in BENCH_SEEDS:
        ms_s, out = events_ms(lambda: run_p(BENCH_SPP, s))
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

    kernels.append(shade_phases(card))

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
