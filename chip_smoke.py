#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mitsuba_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
  1. build csrc/trace.cu, csrc/megakernel.cu, csrc/shade.cu,
     csrc/roofline.cu and csrc/gather.cu with nvcc for sm_90a, one nvcc
     each (megakernel.cu three, one an entry point), all started
     together, and start phases 16, 22 and 23's builds in a child process
     at the lowest CPU priority, so they compile while phases 2-15 run:
     trace.cu under each walk variant of WALK_VARIANTS (build defines of
     csrc/trace_common.cuh) and megakernel.cu under those not in
     WALK_TRACE_ONLY, shade.cu under "simt", trace.cu under each of
     ORDER_VARIANTS and csrc/ablate.cu; print each build's seconds,
     ptxas's register and spill reports of the default builds (and, in
     phase 16, of the SIMT walk's and the index order's), and fail on a
     spill in any build; after each phase, a [clock] line gives the
     seconds since the start;
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
     by lane; then its cost by bounce: the launch with n_bounces = 1 ... 8,
     each timed beside the paths and warps live at that bounce;
  8. render_persistent (mega_persistent) at 256², 64 spp against phase 4's
     eager image and counts, and against persistent_plain lane by lane at
     16 spp; then the bench.py scale: 256², 2048 spp, one warm-up pass and
     two timed passes (counted), with rays/s and the kernel's time by CUDA
     events beside its bound;
  9. the fused shade kernel (csrc/shade.cu) against its plain version,
     shade_plain, lane by lane on the four-material scene (diffuse
     ground, GGX rough-conductor and dielectric spheres, conductor cube,
     area light) at 65,536 lanes, at bounce 0 and bounce 3, with the
     share of lanes that trace a shadow ray, its time and bound, and the
     trace kernel's any-hit time on exactly its shadow rays (the
     yardstick: the difference is the shading); then the same comparison
     with every material two-sided;
 10. that scene's path through render() with PathTracer(max_depth=6,
     fused_shade="on") at 256², SHADE_EAGER_SPP (counted) against
     fused_shade="off" under the image rule, with both rays/s and a 1-spp
     profile of each; then the same scene on the megakernels: mega_path
     against path_plain lane by lane, and render_persistent at
     SHADE_EAGER_SPP against the eager image;
 11. the leaf-families scene (every leaf BSDF family, a two-sided pane,
     smooth spheres; 256², 6 bounces): the trace kernel against its plain
     version on its camera and shadow rays, and on the wavefront of an
     eager pass after three bounces (its live lanes, in pixel order, and
     their shadow rays), each timed beside its bound; mega_bounce against
     its plain version lane by lane at bounce 0 and from the state after
     3 plain bounces, then one pass bounce by bounce (counted);
 12. render() with MegaPathTracer (mega_path, counted) at 8 spp against
     the eager render, mega_path against path_plain lane by lane, and its
     cost by bounce as in phase 7;
 13. render_persistent at 8 spp against the eager image, then one 256-spp
     launch of mega_persistent (counted) timed by CUDA events beside its
     bound, and the kernel against persistent_plain on every 16th pixel
     at 16 spp;
 14. the shade kernel against shade_plain at bounces 0 and 3 with rough
     plastic swapped for plastic and every material two-sided, then
     one-sided (timed, with phase 9's yardstick), with the share of lanes
     tracing a shadow ray;
 15. that one-sided scene's eager path with fused_shade "off" and "on"
     at LEAF_EAGER_SPP (counted), both rays/s and a 1-spp profile of each, the
     images under the image rule, and render_persistent against them;
 16. the cluster walk's builds against the default ("new"), in turns
     X, new, new, X for the walk before the warp-cooperative redesign
     ("old") and the SIMT walk ("simt"), then the cooperative threshold T
     at 4, 8, 12, 16, 20 and 33 once each (the trace kernel alone), on
     the Cornell 2048-spp
     mega_persistent launch (with bench-scale rays/s for old and new),
     the leaf-families 256-spp launch, and the trace kernel on Cornell's
     and the leaf scene's bounce-0 rays and the leaf scene's bounce-3
     wavefront; for simt and new also the shade kernel at phases 9 and
     14's timed shapes; every build bit-equal to the plain version on
     every lane (the persistent launches: equal to the default build's,
     which phases 8 and 13 hold to persistent_plain, and on those phases'
     plain comparisons equal to persistent_plain itself);
 17. the lights-and-composites scene (lights_composites_desc: area,
     point, spot and directional lights under a constant sky; GGX,
     mixture, blend, mask, coating and rough-coating materials; 256², 8
     bounces): the trace kernel against its plain version on its camera
     rays and bounce-0 shadow rays (to the sun and sky at maxt ~1e30),
     mega_bounce lane by lane at bounce 0 and from the state after 3
     plain bounces and one pass bounce by bounce (counted), mega_path
     against path_plain lane by lane and render() with MegaPathTracer at
     8 spp against the eager render (counted), render_persistent at
     LIGHTS_PERSIST_SPP against the eager image (its trace launches
     counted),
     mega_persistent against persistent_plain on every 16th pixel at 16
     spp, and one 256-spp launch timed beside its bound; these
     megakernel launches take the kExt instantiations;
 18. the thin lens (Cornell, aperture 0.05, focus 2): mega_persistent
     against persistent_plain lane by lane at 16 spp, render_persistent
     at LIGHTS_PERSIST_SPP against the eager render with the same camera,
     and a
     blur check against the pinhole;
 19. the shade kernel on the four-material scene with the point, spot,
     directional and constant lights added: against shade_plain lane by
     lane at bounces 0 and 3 (timed, with the shares of lanes whose NEE
     sample is delta or the sky), then the eager path at SHADE_EAGER_SPP, fused
     "on" against "off". Phases 17-20 require bit-equality on every
     lane;
 20. the homogeneous medium (FOG_SCENES: the foggy Cornell box at 256²,
     8 bounces; the fog-and-point-light scene, also with a finite medium
     extent, and the foggy box with g = 0 at 128²; MegaVolPathTracer, the
     kExt instantiations' medium branch): the trace kernel against its
     plain version on the fog's camera rays and first shadow rays (from
     scatter points, with no offset), each timed beside its bound;
     mega_bounce at bounces 0-3, mega_path over one sample and
     mega_persistent at 4 spp on 128² pixels, each against its plain
     version bit for bit with the count rows, on every fog scene; one
     pass bounce by bounce (counted) against mega_path; the eager
     VolPathTracer at 16 spp (trace launches counted; rays/s and the
     busy share of a pass), render() with MegaVolPathTracer (counted)
     and render_persistent at 16 spp against it under the image rule
     with attempted shadow rays >= its unoccluded ones; one timed
     256-spp mega_persistent launch (counted) and mega_path's time, each
     beside its bound; DirectIntegrator's rays/s on the Cornell box; the
     eager VolPathTracer and DirectIntegrator on the card against the
     same integrators on CPU tensors at 64², 2 spp; and the guards: this
     run's Cornell 2048-spp and lights 256-spp launches printed beside
     the times recorded before the medium branch (GUARD_BANDS), for
     information only: a time from another call decides nothing, and
     scripts/ab_persistent.py compares two checkouts in one call;
 21. (tex_phases) config 3's textures and envmap and the procedural
     albedo: see tex_phases;
 22. the trace kernel's ordered walk and the probes: on the wavefronts
     of bounces 0 and 3 and their NEE shadow rays on the leaf, lights,
     texenv and four-material scenes (ORDER_SCENES), the kernel against
     ordered_walk_plain (visits included) and dense.py bit for bit,
     closest and any hit, timed beside its bound and the warps' mean
     visits; then in turns (ORDER_TURNS) against its build in index
     order (ORDER_VARIANTS), held exact, with Cornell's rays too; the
     eager rays/s of leaf and texenv at ORDER_EAGER_SPP, fused off and
     on, under the default and the
     index-order builds; then the probes of mitsuba_tpu_torch/
     experiments: e0's FFMA and FMUL+FADD TFLOP/s, e1's rays/s at the
     TPU probe's inputs and on the Cornell and leaf tables with the
     share of lanes that hit at each step, and every gather form's GB/s
     beside torch.gather's (or torch.take's), each kernel against its
     plain version;
 23. (ablate_phase) the ablation probe of mitsuba_tpu_torch/experiments/
     ablate.py: each of its seven variants bit for bit against its plain
     version after 8 steps on 8,192 lanes of the Cornell tables
     (cluster_size 64, the TPU probe's start state) and of the leaf
     tables (its camera rays), each timed at 512 steps (the transform
     variant fewer on leaf) at 8,192 and 65,536 lanes beside its bound,
     and the bounce's split; then max_depth 0 (unbounded) on Cornell:
     mega_bounce at bounces 0 and 9, mega_path over 32 bounces and
     mega_persistent at 16 spp on every 16th pixel bit for bit against
     their plain versions, and render_persistent (counted) against the
     eager PathTracer(max_depth=0) under the image rule;
 24. (prb_phase) config 4, the training path, on the Cornell box at 256²,
     8 bounces: five steps of plain gradient descent on the red and green
     walls' albedos and the light's radiance toward the preset's image,
     each step a detached render of 4 spp, the per-pixel L2 loss and one
     PRBPathTracer.li_and_grad (integrator/prb.py) a sample pass, with
     the trace kernel's launches counted and the loss required to fall
     at every step; then one step through the trace kernel against
     accel="plain" (L bit for bit, gradients within 1e-5·max|g|), its
     forward with fused_shade "on" against "off", PRB against
     loss.backward() through render_fn (tests/test_prb.py:61-69's rule;
     without roulette on every entry, with it on the radiance), and the
     PRB step, the naive step and a detached forward timed beside their
     peak memory and trace launches;
 25. (dist_phase) the sharded paths of mitsuba_tpu_torch/parallel, ranks
     spawned after phase 1's builds: gloo at 2 and 4 ranks on this card,
     render_sharded (Cornell 256², 8 bounces, 4 spp) and
     render_persistent_sharded (64 spp) bit for bit equal to render_fn
     and render_persistent, render_grad_sharded at 2 ranks (64², 4 spp)
     against one process's loss.backward() (the loss bit for bit, the
     gradients within 1e-5·max|g|), dryrun_multichip(2) against the CPU
     forward, then NCCL with one rank a card at the card count; every
     rank's kernel launches counted;
 26. (compaction_phase, run last, when no build is running)
     PathTracer's wavefront machinery (compaction, coherence sort,
     prefix gate) on the leaf-families scene at LEAF_EAGER_SPP and the
     four-material scene at 16 spp, eager at 256² with the trace kernel:
     the defaults against the compaction threshold raised (all off) and
     gate_depth 0 (the gate alone off), one turn each, every image bit
     for bit equal, rays/s by setting, the live lanes and the gate's
     prefix by bounce, the trace launches;
 27. (cli_phase) the command-line renderer (mitsuba_tpu_torch/cli.py),
     in-process through cli.run on each of the five scenes/*.xml at its
     own film size and spp (cornell.xml at -s CLI_CORNELL_SPP), each
     writing an EXR:
     the route each takes (megakernel or eager, with the refusal reason),
     its trace and mega_persistent launches, rays, wall seconds and
     rays/s; every EXR read back through io/image.py's read_exr equal to
     the image bit for bit (and a half EXR to float16 rounding); each
     megakernel-route scene at 16 spp through the CLI against render_fn
     of the same loaded scene (the trace kernel) under the image rule;
     then one `python3 -m mitsuba_tpu_torch scenes/checker.xml` process
     with no --device, whose log must name the megakernel route on cuda;
 28. (lod_phase) footprint LoD path tracing on texenv (config 3's mip
     lookups): the trace kernel on the footprint's rays and the shade
     kernel on bounce 0's LoD-resolved rows against their plain versions,
     LoDPathTracer.render_lod at 256², 8 bounces, 16 spp, fused on
     (rays/s, launches) beside the level-0 render of the same rays, the
     card's render_lod fused on and off against the CPU's at
     TEXENV_CPU_RES² (image rule), the prefiltering's lower std on the
     minified checker of tests/test_footprint.py; FootprintIntegrator's
     AOV at 256², card against CPU; and scenes/cornell.xml rewritten to a
     temporary directory for each newly ported loader sensor and
     integrator (ao, field, info, multichannel, baseFrameWiWo, adaptive),
     each through cli.run on the eager route with its trace launches and
     its EXR read back bit for bit (the multichannel ones by channel
     name);
 29. (light_phase) the integrators whose subpaths start on the emitters,
     on the Cornell box at 256², 8 bounces, each class's defaults: (a)
     ParticleTracer.render_stats with 2^20 particles (7 closest-hit and 8
     any-hit launches, rays/s) against PathTracer at 16 spp (the means
     within 8%, the pixel means correlated above 0.8); (b) BDPT at 4
     spp, (c) VPLIntegrator (the VPL count and the shadow rays a launch)
     and (d) LightcutsIntegrator at 1 spp, (e) PhotonMapper at 4 spp and
     render_progressive at 4 passes × 1 spp, each through render_fn with
     its launches counted and required; (f) for each of them the trace
     kernel against accel/dense.py bit for bit on 65,536 lanes of its
     second closest-hit and second any-hit call's rays, both modes,
     timed beside the bound; (g) each on the card against CPU tensors at
     32² with small settings (the image rule; the light tracer also
     pixel by pixel; the ray counts within 1e-4); (h) scenes/cornell.xml
     under bdpt, ptracer, vpl, photonmapper, ppm and sppm through
     cli.run, each EXR read back bit for bit.

The last two lines are the card's name and power limit, as nvidia-smi
reports them, and {"ok": true, "device": {...}}; the line before them lists
every ported kernel with its launches, error and times on the Cornell box
(the shade kernel: the four-material scene), under "leaf_families" the
same on the leaf-families scene, under "lights_composites" on the
lights-and-composites scene (the shade kernel: the four-material scene
with its lights) and under "fog" (the trace kernel and the megakernels)
on the foggy Cornell box, under "textures" on phase 21's scenes, under
"ordered" (the trace kernel) phase 22's times by scene and build, and
entries for the probes' kernels (e0_ffma, e0_fmul_fadd, e1_trace_only,
gather, and ablate_<variant> for the seven ablation variants; no path of
the program launches them), and under "prb" (the trace kernel) phase
24's launches over the descent and a PRB step's, a naive step's and a
detached forward's launches, CUDA-event times and peak memory, under
"dist" (the trace kernel and mega_persistent) phase 25's launches by
rank, under "compaction" (the trace kernel) phase 26's launches,
rays/s by setting and live lanes by bounce, under "cli" (the trace
kernel and mega_persistent) phase 27's launches by scene, under "lod"
(the trace and shade kernels) phase 28's launches by run, and under
"light_subpaths" (the trace kernel) phase 29's launches by run and its
times on each caller's wavefront; phase 16
prints
{"walk": ...}, its times by variant. Exits non-zero
without a CUDA device, and without the package beside it.
"""
import atexit
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import torch

from mitsuba_tpu_torch.experiments import time_ms

# The eager spp of phases 10, 15, 17-19, 22 and 25-27 are kept low to hold
# the whole script near 600 s on a slow card host, half the time a run of
# it is given.
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
# SHADE_OPS for a lane that scatters in the medium, from the same code's
# medium branch (bounce_front / bounce_back, kExt with Tables.med): no
# emitter hit, no wo to local and no BSDF (HG's value and sample are
# medium_ops'), the shadow ray from the scatter point itself (mint 7 and
# maxt 1, no offset), and for the next ray the phase draw's two floats 4,
# the throughput's three products and eta's one
MEDIUM_SHADE_OPS = {**SHADE_OPS, "emitter hit + MIS": 0, "wo to local": 0,
                    "diffuse f": 0, "shadow origin, mint, maxt": 8,
                    "BSDF sample, next ray": 8}
CAMERA_OPS = 41             # camera_path: jitter, pinhole ray, normalize
# the emitter sample of the kExt instantiations by emitter type, counted
# from csrc/megakernel.cu sample_direct as SHADE_OPS is (the pick's
# sample reuse included; type 0, the area emitter, is SHADE_OPS's), and
# the constant environment's term on an escaped ray (eval_env, MIS)
LIGHT_OPS = {0: SHADE_OPS["emitter sample"], 1: 25, 2: 23, 4: 12, 5: 42}
ENV_OPS = 17
# the composites' own fp32 operations around their children's eval and
# sample, counted from csrc/bsdf_common.cuh mat_eval / mat_sample for one
# lane (fresnel_diel_f 25 each): the mixture's convex sum 13, its pick
# and stream remap 5, a delta child's pdf 2, a smooth sample's f/pdf 6;
# the coat's setup (η, 1/η, F(wi), wi bent in) 36, its eval around the
# child 84 (wo bent in, F(wo), path, Jacobian, absorption, pdf), the rough
# coat's GGX lobe 110, the coat's sample remap 6, the child refracted
# out 70, the rough coat's VNDF reflection 59 and its f/pdf weight 9
COMPOSITE_OPS = {"mix eval": 13, "mix pick": 5, "mix delta": 2,
                 "mix smooth": 6, "coat setup": 36, "coat eval": 84,
                 "rc lobe eval": 110, "coat remap": 6, "coat out": 70,
                 "rc lobe sample": 59, "rc weight": 9}
COMPOSITE_CODES = (13, 14, 17)
# the fused shade phases: the four-material scene of
# tests/test_pallas_tpu.py:160-183 at 256², 6 bounces, SHADE_EAGER_SPP
SHADE_DEPTH = 6
SHADE_EAGER_SPP = 16        # phases 10 and 19, fused on vs off
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
LEAF_EAGER_SPP = 8          # phases 15 and 26
# the lights-and-composites phases (17-19): 256², 8 bounces
LIGHTS_SPP = 8              # render() with MegaPathTracer against eager
LIGHTS_PERSIST_SPP = 16     # render_persistent against the eager image
LIGHTS_TIMED_SPP = 256      # one mega_persistent launch, timed
LIGHTS_PLAIN_LANES = 16     # persistent_plain on every 16th pixel ...
LIGHTS_PLAIN_SPP = 16       # ... at 16 spp
LIGHTS_BOUNCES = (0, 3)
LENS = {"aperture_radius": 0.05, "focus_distance": 2.0}  # recipe :394-425
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
# each variant against "new" in turns X, new, new, X: the walk before the
# warp-cooperative redesign ("old") and the SIMT walk ("simt", the shade
# kernel's walk before it took the warp walk); then the threshold sweep
# once each
WALK_TURNS = ("old", "simt", "new", "new", "simt", "old", "T4", "T8", "T12",
              "T16", "T20", "T33")
# the threshold sweep times the trace kernel alone: only trace.cu is built
# under these (megakernel.cu under each of them cost six more builds of
# its 18 kernels beside phases 2-15)
WALK_TRACE_ONLY = ("T4", "T8", "T12", "T16", "T20", "T33")
WALK_DEFAULT_T = 24         # MITSUBA_WALK_T's default in trace_common.cuh
# phase 20: the homogeneous medium. The foggy Cornell box of
# tests/test_mega_tpu.py:335-365 at the main path's width, the
# fog-and-point-light scene of :426-466 (an open scene: escaped rays),
# the latter with a finite medium extent and the former with g = 0
FOG_CORNELL = {"sigma_t": (2.0, 2.5, 3.0), "albedo": (0.9, 0.8, 0.7),
               "g": 0.3}
FOG_POINT = {"sigma_t": (0.25, 0.3, 0.35), "albedo": (0.9, 0.85, 0.8),
             "g": 0.1}
FOG_SCENES = {"fog": ("cornell", {}), "fog_point": ("point", {}),
              "fog_point_bound": ("point", {"bound": 4.0}),
              "fog_g0": ("cornell", {"g": 0.0})}
FOG_VARIANT_RES = 128       # every fog scene but "fog" (at CORNELL_RES)
# mega_exact (phases 20 and 21): mega_bounce against its plain version at
# these bounces, mega_persistent against persistent_plain on EXACT_PLAIN_RES²
# pixels at EXACT_PLAIN_SPP
EXACT_BOUNCES = (0, 1, 2, 3)
EXACT_PLAIN_RES = 128
EXACT_PLAIN_SPP = 4
FOG_SPP = 16                # eager VolPathTracer, render() with
                            # MegaVolPathTracer and render_persistent
FOG_TIMED_SPP = 256         # one mega_persistent launch, timed
FOG_CPU_RES, FOG_CPU_SPP = 64, 2   # the eager integrators, card vs CPU
# the guards' bands (printed, not checked): the Cornell 2048-spp and
# lights 256-spp launches as recorded before the medium branch (PERF.md §6,
# NVIDIA H100 80GB HBM3 at 700 W)
GUARD_BANDS = {"cornell 2048 spp": (165.88, 167.49),
               "lights 256 spp": (178.47, 185.23)}
# phase 21: config 3's textures and envmap ("texenv", the eager path) and
# the procedural checker/grid albedo ("proctex", the megakernels; the
# recipe of tests/test_mega_tpu.py:467-529)
TEXENV_DEPTH = 8
TEXENV_SPP = 16             # eager rays/s, fused_shade off and on
TEXENV_BOUNCES = (0, 3)     # the trace and shade kernels' rays
TEXENV_SKY = (256, 512)     # the envmap's rows and columns
TEXENV_CPU_RES, TEXENV_CPU_SPP = 64, 2   # the eager path, card vs CPU
PROCTEX_DEPTH = 6
PROCTEX_SPP = 16            # render() with MegaPathTracer, render_persistent
PROCTEX_TIMED_SPP = 256     # one mega_persistent launch, timed
# phase 22: the trace kernel's ordered walk (its exit tested every 4
# clusters, the TPU kernel's stride) against its build in index order
# ("index"), trace.cu only, in turns; the scenes walked in order (8 to 128
# clusters) and their rays at these bounces
ORDER_VARIANTS = {"index": ("-DMITSUBA_WALK_ORDER=0",)}
ORDER_TURNS = ("new", "index", "index", "new")
ORDER_SCENES = ("leaf", "lights", "texenv", "four_material")
ORDER_BOUNCES = (0, 3)
ORDER_DEPTH = 6             # the PathTracer whose wavefronts are traced
ORDER_EAGER_SPP = 4         # leaf (rough plastic swapped) and texenv
# phase 22's probes (mitsuba_tpu_torch/experiments): e0 held to its plain
# version over E0_CHECK_ITERS steps (and its variants apart on at least
# E0_DIFFER of the lanes), e1 on scene tables over E1_SCENE_ITERS
E0_CHECK_ITERS = 64
E0_DIFFER = 0.25
E1_SCENE_ITERS = 8
# phase 23: the ablation probe (mitsuba_tpu_torch/experiments/ablate.py)
# and unbounded depth. Every variant held to its plain version after
# ABLATE_CHECK_STEPS steps on ABLATE_CHECK_LANES lanes, then timed once at
# ABLATE_STEPS steps for each of ABLATE_LANES; the transform variant (its
# work grows with the table's clusters) takes the steps that keep clusters
# x lanes x steps within ABLATE_TRANSFORM_BUDGET (a power of two, at least
# ABLATE_TRANSFORM_MIN: Cornell keeps 512, leaf's 80 clusters take 32 and
# 16)
ABLATE_CHECK_LANES = 8192
ABLATE_CHECK_STEPS = 8
ABLATE_STEPS = 512
ABLATE_LANES = (8192, 65536)
ABLATE_TRANSFORM_BUDGET = 2 ** 25
ABLATE_TRANSFORM_MIN = 16
# fp32 operations a lane-step outside the bounce's parts, counted from
# csrc/ablate.cu as SHADE_OPS is: the keep-alive (3 max, 3 mul); the
# transform variant's 39 a table row (o' 3 x 6, d' 3 x 5, the sum 5, the
# min 1) and its 1 + 0·acc (2); the no-shade variant's update (mint 3,
# the shadow origin 1, the step 2, o 6, throughput 3, L 6)
ABLATE_KEEP_OPS = 6
ABLATE_ROW_OPS = 39
ABLATE_T_OPS = 2
ABLATE_NOSHADE_OPS = 21
UNBOUNDED_SPP = 16          # render_persistent(max_depth=0) and the eager
UNBOUNDED_PLAIN_LANES = 16  # image; persistent_plain on every 16th pixel
# families whose eval runs without the both-above-the-surface test
TRANSMISSIVE = (5, 12)      # rough dielectric, difftrans
SHADE_ROWS_IN, SHADE_ROWS_OUT = 50, 16
SHADE_ROWS_DEAD = 11        # act, p, d, L, eta: what an inactive lane reads
# phase 24: config 4, path-replay backprop (integrator/prb.py) on the
# Cornell box at CORNELL_RES², MAX_DEPTH bounces
PRB_SPP = 4                 # sample passes a training step
PRB_STEPS = 5               # plain gradient descent steps
PRB_SEED = 0                # the target's and every descent step's
PRB_ROWS = (1, 2)           # the red and green walls' material rows
PRB_START = 0.6             # their albedos and the light's radiance, scaled
PRB_LR = {"mat_params": 20.0, "em_radiance": 100.0}   # descent step sizes
# phase 25: the sharded paths (mitsuba_tpu_torch/parallel) on the Cornell
# box, each case (kind, res, max_depth, spp, seed) of
# parallel/dryrun.py::cornell_cases
DIST_RENDER = ("render", CORNELL_RES, MAX_DEPTH, 4, 0)           # (a)
DIST_GRAD = ("grad", 64, MAX_DEPTH, 4, 0)                        # (b)
DIST_PERSIST = ("persistent", CORNELL_RES, MAX_DEPTH, PERSIST_SPP, 0)  # (c)
DIST_WORLDS = (2, 4)        # gloo ranks sharing the one card
DIST_GRAD_REL = 1e-5        # (b): max |Δg| <= DIST_GRAD_REL · max |g|
DIST_DRYRUN = 2             # (d): dryrun_multichip's ranks (gloo)
DIST_DRYRUN_REL = 1e-5      # (d): its loss against the CPU forward
# phase 26: PathTracer's wavefront machinery (integrator/path.py), eager
# at CORNELL_RES² (65,536 lanes: the gate is on) with the trace kernel,
# SHADE_DEPTH bounces: the defaults ("on"), the gate off ("no gate") and
# all three off ("off"), in these turns
COMPACT_SCENES = (("leaf", LEAF_EAGER_SPP), ("four_material", 16))
COMPACT_TURNS = ("off", "on", "no gate")
# phase 27: the command-line renderer on the repo's scene files, each at its
# own film size and spp (cornell.xml at CLI_CORNELL_SPP, the README's -s)
CLI_SCENES = ("cornell.xml", "materials.xml", "checker.xml", "dof.xml",
              "volumetric.xml")
CLI_CORNELL_SPP = 16
CLI_CHECK_SPP = 16          # megakernel route against render_fn
# phase 28: footprint LoD path tracing on texenv (config 3's mip lookups),
# the footprint AOV, and cornell.xml under each newly ported sensor and
# integrator through the CLI
LOD_SPP = 16                # render_lod at CORNELL_RES², TEXENV_DEPTH
LOD_CHECKER = (32, 4, 2)    # the minified checker: res, spp, max_depth
LOD_FP_TOL = 1e-4           # footprint AOV, card vs CPU, on >= 99.9% of
                            # pixels: |Δ| <= LOD_FP_TOL · max(1, |ref|)
LOD_CLI_SPP = 4
LOD_CLI_ADAPTIVE_SPP = 32   # two batches of 16
CORNELL_PATH = ('<integrator type="path">\n    <integer name="maxDepth" '
                'value="4"/>\n  </integrator>')
CORNELL_SENSOR = '<sensor type="perspective">'
CORNELL_LOOKAT = 'origin="0.5, 0.5, 2.45" target="0.5, 0.5, 0"'
METER_LOOKAT = 'origin="0.5, 0.8, 0.9" target="0.5, 0.8, 0"'   # in the box
_KID = '<integrator type="{}">{}</integrator>'
LOD_CLI_SENSORS = {
    "orthographic": "", "spherical": "",
    "telecentric": '<float name="apertureRadius" value="0.02"/>'
                   '<float name="focusDistance" value="2.45"/>',
    "perspective_rdist": '<string name="kc" value="-0.1, 0.02"/>',
    "radiancemeter": "", "irradiancemeter": ""}
LOD_CLI_INTEGRATORS = {
    "ao": '<integrator type="ao"/>',
    "field": _KID.format("field", '<string name="field" value="shNormal"/>'),
    "info": _KID.format("info", '<string name="infoName" value="distance"/>'),
    "multichannel": _KID.format("multichannel", _KID.format(
        "path", '<integer name="maxDepth" value="4"/>') + _KID.format(
        "field", '<string name="field" value="distance"/>')),
    "baseFrameWiWo": _KID.format("baseFrameWiWo",
                                 '<integer name="maxDepth" value="4"/>'),
    "adaptive": _KID.format("adaptive", _KID.format(
        "path", '<integer name="maxDepth" value="4"/>'))}
# phase 29: the integrators whose subpaths start on the emitters, on the
# Cornell box at CORNELL_RES², MAX_DEPTH and each class's defaults
LIGHT_PARTICLES = 1 << 20   # (a) ParticleTracer.render
LIGHT_PATH_SPP = 16         # (a) the PathTracer image it is held to
LIGHT_BDPT_SPP = 4          # (b)
LIGHT_VPL_SPP = 1           # (c), (d)
LIGHT_PM_SPP = 4            # (e) PhotonMapper through render_fn
LIGHT_PPM = (4, 1)          # (e) render_progressive: passes, spp a pass
LIGHT_WAVE = 1 << 16        # (f) lanes of each caller's wavefront compared
LIGHT_PICK = 1              # (f) the caller's trace call compared (0-based)
LIGHT_CPU_RES = 32          # (g) card against CPU tensors, small settings
LIGHT_CPU_DEPTH = 4
LIGHT_CPU_PARTICLES = 1 << 14
LIGHT_CPU_SPP = 2
LIGHT_CPU_PATHS = 32        # VPL paths
LIGHT_CPU_PHOTONS = 4096
LIGHT_CPU_TOL = 1e-4        # (g) ptracer: |Δpixel| <= LIGHT_CPU_TOL · max,
LIGHT_CPU_SHARE = 0.99      # on at least this share of the pixels
LIGHT_CLI_INTEGRATORS = {   # (h) cornell.xml under each, LOD_CLI_SPP
    kind: _KID.format(kind, '<integer name="maxDepth" value="4"/>')
    for kind in ("bdpt", "ptracer", "vpl", "photonmapper", "ppm", "sppm")}


@contextlib.contextmanager
def walk_build(*defines, trace_only=False):
    """Inside the block the trace, megakernel and shade wrappers launch
    their builds under these nvcc defines of the cluster walk
    (csrc/trace_common.cuh, e.g. "-DMITSUBA_WALK_COOP=0"): each module's
    _library is rebound (only the trace kernel's with trace_only), and
    put back on leaving. For phases 16 and 22 and the card tests; the
    port's entry points launch the default builds."""
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.accel import shade_kernel as sk
    from mitsuba_tpu_torch.accel import trace
    saved = [(m, m._library) for m in ((trace,) if trace_only
                                       else (trace, mk, sk))]
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


_T0 = time.perf_counter()


def clock(what):
    """After each phase: the seconds since the script started."""
    print(f"[clock] {what}: {time.perf_counter() - _T0:.1f} s", flush=True)


def build_jobs(variants):
    """Phase 1's nvcc builds: the five libraries, or (variants) the
    builds the child process makes beside phases 2-15: the walk variants
    phases 16 and 22 compare, trace.cu under each of WALK_VARIANTS and
    megakernel.cu under those not in WALK_TRACE_ONLY, shade.cu under
    "simt", trace.cu under each of
    ORDER_VARIANTS, and phase 23's ablate.cu (the only build there without
    defines)."""
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.accel import shade_kernel as sk
    from mitsuba_tpu_torch.accel import trace
    from mitsuba_tpu_torch.experiments import ablate, gather_probe, roofline
    if not variants:
        return [(trace.build, ()), (mk.build, ()), (sk.build, ()),
                (roofline.build, ()), (gather_probe.build, ())]
    return ([(fn, defines) for name, defines in WALK_VARIANTS.items()
             if defines for fn in ((trace.build,) if name in WALK_TRACE_ONLY
                                   else (trace.build, mk.build))]
            + [(sk.build, WALK_VARIANTS["simt"])]
            + [(trace.build, defines) for defines in ORDER_VARIANTS.values()]
            + [(ablate.build, ())])


def run_builds(jobs, shown=(), times=True):
    """Each job's build at once, one nvcc each (a cached library is
    reused); prints each build's seconds (with times) and the ptxas
    report of the
    libraries built with the defines in `shown`, and fails on a missing
    report or a spill."""
    t0 = time.perf_counter()

    def timed(fn, defines):
        out = fn(defines)
        return out, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        builds = [b.result() for b in [pool.submit(timed, fn, defines)
                                       for fn, defines in jobs]]
    for ((lib, report), secs), (_, defines) in zip(builds, jobs):
        label = " ".join(defines) or "(default)"
        if times:
            print(f"[build] {lib.name} {label}: done {secs:.1f} s after "
                  f"the builds started", flush=True)
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
    print("\n".join(line for line in out.splitlines()
                    if line.startswith("[build] ") and ": done " in line),
          flush=True)
    print(f"[build] walk variants and ablate.cu: {len(build_jobs(True))} "
          f"builds beside phases 2-15, done {time.perf_counter() - t0:.1f} "
          f"s after they started", flush=True)
    # cached now: print the SIMT walk's, the index order's and ablate.cu's
    # reports, check every build's
    run_builds(build_jobs(True), shown=(WALK_VARIANTS["simt"],
                                        ORDER_VARIANTS["index"], ()),
               times=False)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


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
    from mitsuba_tpu_torch.accel import dense, trace
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
    inv = trace.safe_inv(d)
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


def compare_exact(label, k, p):
    """compare_rows, then every lane bit for bit (NaN where both are)."""
    err = compare_rows(label, k, p)
    same = (k == p) | (k.isnan() & p.isnan())
    check(bool(same.all()), f"{label}: {int((~same.all(0)).sum())} lanes "
                            "differ from the plain version")
    return err


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


def count_ops(fn, elementwise=False):
    """The arithmetic PyTorch calls of fn() (each op of _COUNTED once,
    selects and compares not counted; elementwise: each element of its
    result, for a lane's [1, 3] vectors), under a TorchFunctionMode; fn
    runs on one lane, so the count is the fp32 operations of one lane."""
    from torch.overrides import TorchFunctionMode

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if getattr(func, "__name__", "").strip("_") in _COUNTED:
                Count.n += out.numel() if elementwise and isinstance(
                    out, torch.Tensor) else 1
            return out

    with Count():
        fn()
    return Count.n


def family_ops(tables):
    """fp32 operations of each family's eval and sample branch for one
    lane, counted (count_ops) by running the plain versions of the device
    helpers (accel/megakernel.py bsdf_eval_pdf, bsdf_sample), which the
    kernels compute op for op, on one lane of each of the tables'
    materials (rough dielectric's eval computes both candidate
    micronormals where the kernel computes one, so its count is ~10
    over). Returns {family: (eval_ops, sample_ops)}."""
    from mitsuba_tpu_torch.accel import megakernel as mk

    out = {}
    for row in tables.mat.cpu():
        fam = int(row[12])
        if fam in out or fam in COMPOSITE_CODES:
            continue
        m = row[:, None].clone()
        t = lambda *v: torch.tensor(v, dtype=torch.float32)
        wo_z = -0.6 if fam in TRANSMISSIVE else 0.6
        args = (t(0.3), t(0.2), t(0.9), t(-0.2), t(0.5), t(wo_z))
        out[fam] = (
            count_ops(lambda: mk.bsdf_eval_pdf(m, *args, families=(fam,))),
            count_ops(lambda: mk.bsdf_sample(m, *args[:3], t(0.3), t(0.7),
                                             t(0.4), families=(fam,))))
    return out


def medium_ops(tables):
    """fp32 operations of the medium's terms for one lane, counted
    (count_ops) from their plain versions, which csrc/megakernel.cu
    computes op for op: the distance sample and segment weight of every
    live lane (accel/megakernel.py medium_segment: the channel pick, the
    log, six exps, two pdfs), the scatter point, HG toward the light
    (hg_value and its cosine), the HG continuation (hg_sample_kernel) and
    the transmittance on an unoccluded NEE ray (three exps, three
    products)."""
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.media.homogeneous import transmittance
    med = tables.medium
    t = lambda *v: torch.tensor([v], dtype=torch.float32)
    one, d, wo = t(0.5), t(0.0, 0.6, -0.8), t(0.48, 0.0, 0.8771)
    live = torch.ones(1, dtype=torch.bool)
    sigma_t = torch.tensor(med[0:3])
    count = functools.partial(count_ops, elementwise=True)
    return {
        "segment": count(lambda: mk.medium_segment(
            med, t(0.3, 0.6), one[0], live)),
        "scatter point": count(lambda: d + one[:, None] * d),
        "phase nee": count(lambda: mk.hg_value(med[6], -(
            (d[:, 0] * wo[:, 0] + d[:, 1] * wo[:, 1]) + d[:, 2] * wo[:, 2]))),
        "phase sample": count(lambda: mk.hg_sample_kernel(
            med[6], d, t(0.3, 0.6))),
        "transmittance": count(lambda: d * transmittance(
            sigma_t, one[0], med[7]))}


def tex_ops():
    """fp32 operations of the procedural albedo for one lane, counted
    (count_ops) from the plain versions csrc/megakernel.cu computes op for
    op: "uv", the hit's uv from the attribute rows (the corners rebuilt
    as uv0 + Δ, interpolated by the barycentrics), and "checker" and
    "grid", proc_albedo with its four corners' checker_c0 or grid_c0
    (proc_albedo's count less the other kind's four corner tests: the
    plain version computes both, the kernel the row's)."""
    from mitsuba_tpu_torch.accel import megakernel as mk
    t = lambda *v: torch.tensor([v], dtype=torch.float32)
    count = functools.partial(count_ops, elementwise=True)
    row = torch.zeros((mk.N_MAT, 1))
    row[mk.TEXROW + 7:mk.TEXROW + 10, 0] = torch.tensor([512.0, 8.0, 0.02])
    one, uv = t(0.3), t(0.3, 0.6)
    corner = (one[0], one[0], row[mk.TEXROW + 7], row[mk.TEXROW + 8])
    chk = 4 * count(lambda: mk.checker_c0(*corner))
    grd = 4 * count(lambda: mk.grid_c0(*corner, one[0]))
    both = count(lambda: mk.proc_albedo(row, uv))
    return {"uv": count(lambda: (uv * one + (uv + uv) * one)
                        + (uv + uv) * one),
            "checker": both - grd, "grid": both - chk}


def composite_ops(tables, fam_ops):
    """fp32 operations of each composite material row's eval and sample
    for one lane, from COMPOSITE_OPS and its children's family_ops:
    {row: (eval ops beside the children's, the children's eval ops,
    sample ops)}. Where the work depends on the lane's lobe pick, the
    cheaper branch is charged, so the bound stays a least time."""
    c = COMPOSITE_OPS
    out = {}
    mat = tables.mat.cpu()
    for i, row in enumerate(mat):
        code = int(row[12])
        if code not in COMPOSITE_CODES:
            continue
        kids = [int(mat[int(row[k]), 12]) for k in (18, 19)]
        ea, sa = fam_ops[kids[0]]
        if code == 13:
            eb, sb = fam_ops[kids[1]]
            out[i] = (c["mix eval"], ea + eb,
                      c["mix pick"] + min(sa, sb) + c["mix delta"])
            continue
        ev = c["coat setup"] + c["coat eval"] + (c["rc lobe eval"]
                                                 if code == 17 else 0)
        nested = sa + c["coat out"]
        if code == 17:
            smooth = ev + ea + c["rc weight"]
            nested = min(nested, c["rc lobe sample"]) + smooth
        out[i] = (ev, ea, c["coat setup"] + c["coat remap"]
                  + (nested if code == 17 else 0))
    return out


def nee_rays(tables, state, pix, samp, bounce, max_depth, seed=0):
    """The events of one bounce of the megakernel's plain version from
    `state`, and their NEE shadow rays: (its, in_med: the lanes that
    scatter in the tables' medium, ds: the NEE sample from the scatter
    point or the hit, so: the shadow ray's origin, the scatter point
    itself or the offset hit, attempted: the lanes that attempt it)."""
    from mitsuba_tpu_torch.accel import dense
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.core import rng
    from mitsuba_tpu_torch.emitter.emitter import sample_direct
    from mitsuba_tpu_torch.integrator.common import (
        DIM_MEDIUM, DIM_NEE_POS, DIM_NEE_SEL, bounce_dim, offset_ray_origin,
        ray_mint)
    scene = tables.plain_scene
    o = state[0:3].T.contiguous()
    d = state[3:6].T.contiguous()
    live = state[12] > 0.5
    its = dense.ray_intersect(scene, o, d, ray_mint(o),
                              torch.full_like(o[:, 0], 1e30), live)
    dim = lambda off: bounce_dim(bounce, off)
    in_med, p_event = torch.zeros_like(live), its.p
    if tables.medium is not None:
        sampled, t_med, _ = mk.medium_segment(
            tables.medium, rng.sample_2d(seed, pix, dim(DIM_MEDIUM), samp),
            torch.where(its.valid, its.t, 1e30), live)
        in_med = live & sampled
        p_event = torch.where(in_med[:, None], o + t_med[:, None] * d,
                              its.p)
    ds = sample_direct(scene, p_event,
                       rng.sample_1d(seed, pix, dim(DIM_NEE_SEL), samp),
                       rng.sample_2d(seed, pix, dim(DIM_NEE_POS), samp))
    so = torch.where(in_med[:, None], p_event,
                     offset_ray_origin(its.p, its.ng, ds.d))
    attempted = ((its.valid | in_med) & (ds.pdf > 0)
                 & (max_depth <= 0 or bounce + 3 <= max_depth + 1))
    return its, in_med, ds, so, attempted


def bounce_work(tables, state, pix, samp, bounce, fam_ops, max_depth,
                seed=0):
    """needed_work for one bounce of the megakernel on its plain scene: the
    closest-hit rays of the live lanes, the shadow rays the kernel traces
    (attempted NEE with the BSDF, or the phase function, nonzero toward
    the light) and the shading operations of the events, each charged
    the common SHADE_OPS plus, on a surface, its family's sample and,
    where the eval branch runs, its eval, and where its material has a
    procedural albedo, the uv and the albedo (tex_ops). With a medium in
    the tables,
    every live lane is charged the distance sample, a lane that scatters
    MEDIUM_SHADE_OPS in place of SHADE_OPS and the scatter point and HG's
    value and sample in place of its BSDF's, and an unoccluded NEE ray the
    transmittance (medium_ops). Returns a dict of ray counts, ops and
    table bytes."""
    from mitsuba_tpu_torch.accel import dense
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.core.math import SHADOW_EPSILON, Frame
    from mitsuba_tpu_torch.integrator.common import ray_mint
    scene = tables.plain_scene
    o = state[0:3].T.contiguous()
    d = state[3:6].T.contiguous()
    live = state[12] > 0.5
    maxt = torch.full_like(o[:, 0], 1e30)
    its, in_med, ds, so, attempted = nee_rays(tables, state, pix, samp,
                                              bounce, max_depth, seed)
    surf = its.valid & ~in_med
    mat, mat_a, mat_b = mk.child_rows(tables, its.mat_id)
    tex_kind = mat[mk.TEXROW]
    if tables.textured:      # the kernel's rows: the procedural albedo
        albedo = torch.where(tex_kind >= 0, mk.proc_albedo(mat, its.uv),
                             mat[0:3])
        mat, mat_a, mat_b = (torch.cat([albedo, r[3:]])
                             for r in (mat, mat_a, mat_b))
    frame = Frame.from_normal(its.ns)
    wi, wo = Frame.to_local(frame, -d), Frame.to_local(frame, ds.d)
    fsign = torch.where((mat[15] > 0.5) & (wi[:, 2] < 0), -1.0, 1.0)
    *f, _ = mk.composite_eval_pdf(mat, mat_a, mat_b, wi[:, 0], wi[:, 1],
                                  wi[:, 2] * fsign, wo[:, 0], wo[:, 1],
                                  wo[:, 2] * fsign,
                                  set(tables.mat[:, 12].long().tolist()))
    traced = attempted & (in_med | (f[0] > 0) | (f[1] > 0) | (f[2] > 0))
    both_up = (wi[:, 2] * fsign > 0) & (wo[:, 2] * fsign > 0)
    common = (sum(SHADE_OPS.values()) - SHADE_OPS["diffuse f"]
              - fam_ops[0][1] + TWO_SIDED_OPS) if 0 in fam_ops else \
        sum(SHADE_OPS.values()) - SHADE_OPS["diffuse f"] + TWO_SIDED_OPS
    shade_ops = (common * int(surf.sum())
                 + (sum(MEDIUM_SHADE_OPS.values()) + TWO_SIDED_OPS)
                 * int(in_med.sum()))
    for fam, (n_eval, n_sample) in fam_ops.items():
        hit_f = surf & (mat[12] == fam)
        runs = attempted & hit_f & (both_up | (fam in TRANSMISSIVE))
        shade_ops += n_sample * int(hit_f.sum()) + n_eval * int(runs.sum())
    for row, (n_own, n_kids, n_sample) in composite_ops(tables,
                                                        fam_ops).items():
        hit_r = surf & (its.mat_id == row)
        shade_ops += (n_sample * int(hit_r.sum())
                      + n_own * int((attempted & hit_r).sum())
                      + n_kids * int((attempted & hit_r & both_up).sum()))
    if tables.ext:   # the emitter sample by type, the sky on escape
        em = scene.em_type[ds.em_id.clamp(min=0)]
        for t, n in LIGHT_OPS.items():
            shade_ops += (n - LIGHT_OPS[0]) * int(((surf | in_med)
                                                   & (em == t)).sum())
        if tables.env >= 0:
            shade_ops += ENV_OPS * int((live & ~its.valid & ~in_med).sum())
    if tables.textured:      # a surface hit's procedural albedo
        t_ops = tex_ops()
        for kind, name in ((0.0, "checker"), (1.0, "grid")):
            shade_ops += (t_ops["uv"] + t_ops[name]) * int(
                (surf & (tex_kind == kind)).sum())
    if tables.medium is not None:
        m = medium_ops(tables)
        lit = traced & ~dense.ray_test(scene, so, ds.d, ray_mint(so),
                                       ds.dist * (1.0 - SHADOW_EPSILON),
                                       traced)
        shade_ops += (m["segment"] * int(live.sum())
                      + (m["scatter point"] + m["phase nee"]
                         + m["phase sample"]) * int(in_med.sum())
                      + m["transmittance"] * int(lit.sum()))
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


def path_increments(label, tables, rr, depth, st0, pix, samp, card):
    """mega_path's cost by bounce: the launch from st0 with n_bounces = k
    for k = 1 ... depth, each timed, beside the paths live at bounce k
    (read from the kernel's own state after k - 1 bounces) and the warps
    of 32 lanes that hold one, which run that bounce (lanes: a multiple
    of 32). Returns a dict for each bounce."""
    from mitsuba_tpu_torch.accel import megakernel as mk
    rows, st, prev = [], st0, 0.0
    for k in range(1, depth + 1):
        live = st[12] > 0.5
        warps = int(live.view(-1, 32).any(1).sum())
        run = functools.partial(mk.run_path, tables, rr, depth, k, st0, pix,
                                samp, 0)
        ms = time_ms(run, 20)
        rows.append({"bounce": k, "live_paths": int(live.sum()),
                     "live_warps": warps, "ms": ms,
                     "increment_ms": ms - prev})
        print(f"[bounces] {label}, bounce {k}: {int(live.sum())} live paths "
              f"in {warps} warps, n_bounces={k} {ms:.5f} ms, increment "
              f"{ms - prev:.5f} ms ({card})", flush=True)
        prev = ms
        st = run()[:16]
    return rows


def shade_yardstick(scene, packed, bounce, depth):
    """The trace kernel's any-hit time on exactly the shade kernel's
    shadow rays at this bounce: all N lanes, the same live mask."""
    from mitsuba_tpu_torch.accel import shade_kernel as sk
    from mitsuba_tpu_torch.accel import trace
    so, sd, smint, smaxt, live = sk.shadow_rays(packed, bounce, depth)
    return time_ms(lambda: trace.occluded(scene, so, sd, smint, smaxt, live),
                   100)


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


def lights_composites_desc(builder, tf, shapes, sphere=(12, 24)):
    """The lights-and-composites scene through a builder module (the
    port's or the JAX package's scene.builder; tf and shapes as for
    four_materials_desc), the union of the recipes of
    tests/test_mega_tpu.py:104-142, :305-334 and :639-751: a diffuse
    floor under a rectangle light at y = 4, a small warm area light, a
    point, a spot and a directional light and the constant sky (0.08,
    0.09, 0.12); spheres (scale 0.6) of GGX, a diffuse+GGX mixture, a
    glass+diffuse mixture, coating over diffuse, coating over GGX, rough
    coating over diffuse and a blend of plastic and rough diffuse; and a
    mask pane."""
    d = builder.SceneDesc()
    m = d.add_material
    dif = m(kind="diffuse", albedo=(0.7, 0.3, 0.2))
    ggx = m(kind="roughconductor", alpha=0.2)
    glass = m(kind="dielectric", int_ior=1.5)
    dif2 = m(kind="diffuse", albedo=(0.6, 0.25, 0.2))
    ggx2 = m(kind="roughconductor", alpha=0.25)
    dif3 = m(kind="diffuse", albedo=(0.55, 0.2, 0.15))
    plastic = m(kind="plastic", diffuse_reflectance=(0.2, 0.3, 0.6))
    rdif = m(kind="roughdiffuse", albedo=(0.6, 0.5, 0.4), alpha=0.4)
    spheres = [
        ggx,
        m(kind="mixturebsdf", child_a=dif, child_b=ggx, weight=0.6),
        m(kind="mixturebsdf", child_a=glass, child_b=dif, weight=0.5),
        m(kind="coating", child_a=dif2, int_ior=1.5,
          sigma_a=(0.1, 0.15, 0.2), thickness=1.0),
        m(kind="coating", child_a=ggx2, int_ior=1.49),
        m(kind="roughcoating", child_a=dif3, int_ior=1.5, alpha=0.1,
          sigma_a=(0.05, 0.08, 0.1), distribution="ggx"),
        m(kind="blendbsdf", child_a=plastic, child_b=rdif, weight=0.3),
    ]
    mask = m(kind="mask", child_a=dif, weight=0.4)
    floor = m(kind="diffuse", albedo=(0.5, 0.5, 0.55))
    d.add_shape(shapes.rectangle(), material=floor,
                to_world=tf.translate([0, -1, 0])
                @ tf.rotate([1, 0, 0], -90) @ tf.scale([6] * 3))
    for i, mat in enumerate(spheres):
        row, col = divmod(i, 4)
        x = 1.4 * col - (2.1 if row == 0 else 1.4)
        d.add_shape(shapes.sphere(*sphere), material=mat,
                    to_world=tf.translate([x, -0.4, -1.8 * row])
                    @ tf.scale([0.6] * 3))
    d.add_shape(shapes.rectangle(), material=mask,
                to_world=tf.translate([2.8, 0.0, -1.8])
                @ tf.scale([0.6] * 3))
    d.add_shape(shapes.rectangle(), material=floor,
                radiance=(13.0, 12.0, 11.0),
                to_world=tf.translate([0, 4, 0])
                @ tf.rotate([1, 0, 0], 90) @ tf.scale([2.0] * 3))
    d.add_shape(shapes.rectangle(), material=floor, radiance=(6.0, 2.0, 1.0),
                to_world=tf.translate([0, 1.2, -3.6]) @ tf.scale([0.3] * 3))
    return add_lights(d, builder)


def add_lights(d, builder):
    """The point, spot and directional lights of
    tests/test_mega_tpu.py:305-334 and the constant sky (0.08, 0.09, 0.12)
    of :104-142, added to the description d (builder: the package's
    scene.builder module); returns d."""
    d.point_lights.append(builder.PointLight(position=[2.0, 3.0, 1.0],
                                             intensity=[30.0, 28.0, 25.0]))
    d.spot_lights.append(builder.SpotLight(
        position=[-2.0, 3.0, 1.0], direction=[0.5, -1.0, -0.2],
        intensity=[40.0, 40.0, 40.0], cutoff_angle=30.0, beam_width=20.0))
    d.directional_lights.append(builder.DirectionalLight(
        direction=[-0.3, -1.0, -0.4], irradiance=[0.8, 0.8, 0.9]))
    d.constant_light = builder.ConstantLight(radiance=(0.08, 0.09, 0.12))
    return d


def leaf_families_camera(cam_cls, tf, res):
    """A res² camera at (0, 1.5, 6.5) looking down at (0, -0.4, -1), 45°
    fov."""
    return cam_cls(res, res, 45.0, tf.look_at(
        origin=[0, 1.5, 6.5], target=[0, -0.4, -1], up=[0, 1, 0]))


def four_materials(res, device=DEV, two_sided=False, lights=False):
    """The four-material scene (sphere(16, 32)) compiled on `device`, and
    a res² camera at (0, 1, 6) looking along (0, -0.1, -1) with a 39°
    fov. lights adds the point, spot, directional and constant lights
    (add_lights)."""
    from mitsuba_tpu_torch.core import transform as tf
    from mitsuba_tpu_torch.scene import builder, shapes
    from mitsuba_tpu_torch.scene.builder import SceneDesc, compile_scene
    from mitsuba_tpu_torch.sensor.sensor import PerspectiveCamera
    desc = four_materials_desc(SceneDesc, tf, shapes, two_sided=two_sided)
    if lights:
        add_lights(desc, builder)
    cam = PerspectiveCamera(res, res, 39.0, tf.look_at(
        origin=[0, 1, 6], target=[0, 0.9, 5], up=[0, 1, 0]))
    return compile_scene(desc, device=device), cam


def shade_bound(label, scene, packed, bounce, rr_depth, fam_ops, card,
                depth=SHADE_DEPTH):
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
    fr = sk._front(packed, bounce, depth)
    both_up = (fr.wi[2] > 0) & (fr.wo[2] > 0)
    so, sd, smint, smaxt, live = sk.shadow_rays(packed, bounce, depth)
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
                                 "any_hit_ms": shade_yardstick(
                                     sc, packed, b, SHADE_DEPTH),
                                 "plain_ms": time_ms(plain, 5, warmup=1),
                                 **shade_bound(label, sc, packed, b,
                                               tracer.rr_depth, fam_ops,
                                               card)}
                    print(f"[shade] {label}: kernel "
                          f"{timing[b]['ms'] * 1e3:.2f} us/launch, the "
                          f"trace kernel's any-hit launch on its shadow "
                          f"rays {timing[b]['any_hit_ms'] * 1e3:.2f} us, "
                          f"plain {timing[b]['plain_ms']:.3f} ms ({card})",
                          flush=True)
                    walk_cases[f"four-material b{b}"] = (functools.partial(
                        sk.run_shade, sc, packed, pix, samp, 0, b,
                        tracer.rr_depth, SHADE_DEPTH), ref)
            st = tracer.bounce(sc, st, 0, pix, samp, b)[0]
    del scene_2s

    # ---- 10. the fused path through render(), against the eager tail ----
    film = Film(CORNELL_RES, CORNELL_RES, "box")
    results, spp = {}, SHADE_EAGER_SPP
    for mode in ("off", "on"):
        integ = PathTracer(max_depth=SHADE_DEPTH, fused_shade=mode)
        render_fn(scene, cam, film, integ, spp=1, seed=0, device=DEV)
        torch.cuda.synchronize()                            # (warm-up)
        trace.reset_launches()
        sk.reset_launches()
        t0 = time.perf_counter()
        img, n = render_fn(scene, cam, film, integ, spp=spp, seed=0,
                           device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**trace.LAUNCHES, **sk.LAUNCHES}
        results[mode] = (img, int(n), launches)
        print(f"[fused {mode}] {CORNELL_RES}², {SHADE_DEPTH} bounces, {spp} "
              f"spp: {wall:.3f} s, {int(n)} rays, {int(n) / wall:.4g} rays/s,"
              f" mean {img.mean().item():.5f}, launches {launches} ({card})",
              flush=True)
        check(bool(torch.isfinite(img).all()), f"fused {mode}: NaN/Inf")
        profile_pass(scene, cam, film, integ, card)
    (img_off, n_off, l_off), (img_on, n_on, l_on) = results["off"], \
        results["on"]
    check(l_on["shade"] == SHADE_DEPTH * spp,
          f"shade launched {l_on['shade']} times, want {SHADE_DEPTH * spp}")
    check(l_off["shade"] == 0 and l_on["trace_any"] == 0,
          "the eager tail launched the shade kernel or the fused tail a "
          "shadow trace")
    image_rule(img_on, img_off, f"fused on vs off, {spp} spp")
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
    img_p, n_p = render_persistent(integ_m, cam, spp, seed=0)
    image_rule(img_p, img_off, f"four-material render_persistent vs eager, "
                               f"{spp} spp")
    check(abs(int(n_p) - n_off) <= 1e-4 * n_off,
          f"four-material persistent rays {int(n_p)} vs {n_off}")
    b0 = timing[SHADE_BOUNCES[0]]
    return {"name": "shade", "route": "cuda",
            "source": "mitsuba_tpu_torch/csrc/shade.cu",
            "replaces": "mitsuba_tpu/accel/shade_kernel.py:75",
            "launches": l_on["shade"], "max_abs_err": err,
            **b0, "library_ms": None}, walk_cases


def lights_scene(res, device=DEV, sphere=(12, 24)):
    """The lights-and-composites scene compiled on `device`, and the
    leaf-families scene's res² camera."""
    from mitsuba_tpu_torch.core import transform as tf
    from mitsuba_tpu_torch.scene import builder, shapes
    from mitsuba_tpu_torch.sensor.sensor import PerspectiveCamera
    desc = lights_composites_desc(builder, tf, shapes, sphere)
    return (builder.compile_scene(desc, device=device),
            leaf_families_camera(PerspectiveCamera, tf, res))


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
                     16, 18, tables, card),
        "by_bounce": path_increments("leaf mega_path", tables, rr, depth,
                                     st0, pix, samp, card)}

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
                                 "any_hit_ms": shade_yardstick(sc, packed, b,
                                                               depth),
                                 "plain_ms": time_ms(plain, 2, warmup=1),
                                 **shade_bound(label, sc, packed, b, rr,
                                               fam_ops, card)}
                    print(f"[leaf shade] {label}: kernel "
                          f"{timing[b]['ms'] * 1e3:.2f} us/launch, the "
                          f"trace kernel's any-hit launch on its shadow "
                          f"rays {timing[b]['any_hit_ms'] * 1e3:.2f} us, "
                          f"plain {timing[b]['plain_ms']:.3f} ms ({card})",
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


def lights_phases(card, kernels):
    """Phases 17-19: the lights-and-composites scene (256², 8 bounces),
    the thin-lens Cornell box and the shade kernel under the new lights.
    Adds to each entry of `kernels` (by name) a "lights_composites" object
    with the kernel's launches on this scene's paths, its error against
    its plain version and its times and bound here (the shade kernel's
    on the four-material scene with the new lights)."""
    import dataclasses

    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.accel import shade_kernel as sk
    from mitsuba_tpu_torch.accel import trace
    from mitsuba_tpu_torch.film.film import Film
    from mitsuba_tpu_torch.integrator.common import ray_mint
    from mitsuba_tpu_torch.integrator.mega import (MegaPathTracer,
                                                   render_persistent)
    from mitsuba_tpu_torch.integrator.path import PathTracer, initial_state
    from mitsuba_tpu_torch.render import render_fn
    from mitsuba_tpu_torch.scene.builder import compile_scene
    from mitsuba_tpu_torch.scene.presets import cornell_box, cornell_camera

    depth, res = MAX_DEPTH, CORNELL_RES
    out = {k["name"]: {} for k in kernels}
    scene, cam = lights_scene(res)
    film = Film(res, res, "box")
    em = sorted(set(scene.em_type.tolist()))
    print(f"[lights] lights-and-composites scene: "
          f"{int((scene.tri_area > 0).sum())} triangles, "
          f"{scene.woop_clusters.shape[0]} clusters, families "
          f"{sorted(set(scene.mat_type.tolist()))}, emitter types {em}",
          flush=True)
    ok, why = MegaPathTracer.supports(scene, cam, film)
    check(ok, f"MegaPathTracer refuses the lights scene: {why}")
    check(not sk.supports(scene)[0], "shade supports the composites")
    integ = MegaPathTracer.for_scene(scene, max_depth=depth)
    tables, rr = integ.tables, integ.rr_depth
    check(tables.ext and tables.env >= 0, "lights scene: no kExt tables")
    pix = torch.arange(res * res, dtype=torch.int32, device=DEV)
    samp = torch.zeros_like(pix)
    st0 = initial_state(*mk.primary_rays(cam, 0, pix, 0))
    o0, d0 = st0[0:3].T.contiguous(), st0[3:6].T.contiguous()

    # ---- 17. the trace kernel on camera rays and bounce-0 shadow rays ----
    errs = {"trace_closest": 0.0, "trace_any": 0.0}
    primary = (o0, d0, ray_mint(o0), torch.full_like(o0[:, 0], 1e30), None)
    shadow = shadow_rays(scene, o0, d0)
    far = shadow[3][shadow[4]] > 1e29
    print(f"[lights] {int(shadow[4].sum())} shadow rays, "
          f"{int(far.sum())} of them toward the sun or the sky (maxt "
          f"~1e30)", flush=True)
    compare("lights primary", scene, *primary, errs)
    compare("lights shadow", scene, *shadow, errs)
    for name, any_hit, rays in (("trace_closest", False, primary),
                                ("trace_any", True, shadow)):
        out[name] = {"max_abs_err": errs[name],
                     **measure(f"{name}, lights bounce 0", any_hit, scene,
                               rays, 3, card)}

    # ---- 17. mega_bounce lane by lane, then one pass bounce by bounce ----
    fam_ops = family_ops(tables)
    print(f"[lights] fp32 ops by family (eval, sample): {fam_ops}; "
          f"composite rows (own eval, children's eval, sample): "
          f"{composite_ops(tables, fam_ops)}", flush=True)
    works, work_pass = pass_work(tables, st0, pix, samp, depth)
    st, err = st0, 0.0
    for b in range(max(LIGHTS_BOUNCES) + 1):
        if b in LIGHTS_BOUNCES:
            k = mk.run_bounce(tables, rr, depth, st, pix, samp, 0, b)
            p = mk.bounce_plain(tables, rr, depth, st, pix, samp, 0, b)
            err = max(err, compare_exact(f"lights mega_bounce, bounce {b}",
                                         k, p))
        st = mk.bounce_plain(tables, rr, depth, st, pix, samp, 0, b)[:16]
    mk.reset_launches()
    st, counts = st0, torch.zeros_like(st0[:2])
    for b in range(depth):
        o = mk.run_bounce(tables, rr, depth, st, pix, samp, 0, b)
        st, counts = o[:16], counts + o[16:18]
    torch.cuda.synchronize()
    launches = mk.LAUNCHES["mega_bounce"]
    ref = mk.run_path(tables, rr, depth, depth, st0, pix, samp, 0)
    check(launches == depth, f"lights mega_bounce launched {launches} times")
    check(torch.equal(st, ref[:16]) and torch.equal(counts, ref[16:18]),
          "lights: bounce-by-bounce pass differs from mega_path")
    out0 = mk.run_bounce(tables, rr, depth, st0, pix, samp, 0, 0)
    out["mega_bounce"] = {
        "launches": launches, "max_abs_err": err,
        "ms": time_ms(lambda: mk.run_bounce(tables, rr, depth, st0, pix,
                                            samp, 0, 0), 50),
        "plain_ms": time_ms(lambda: mk.bounce_plain(
            tables, rr, depth, st0, pix, samp, 0, 0), 3, warmup=1),
        **mega_bound("lights mega_bounce, bounce 0", works[0],
                     int(out0[16].sum()), int(out0[17].sum()), 0,
                     pix.shape[0], 16, 18, tables, card)}

    # ---- 17. mega_path: render() against the eager render; lane by lane --
    eager = PathTracer(max_depth=depth)
    img_e, n_e = render_fn(scene, cam, film, eager, spp=LIGHTS_SPP, seed=0,
                           device=DEV)
    mk.reset_launches()
    img_m, n_m = render_fn(scene, cam, film, integ, spp=LIGHTS_SPP, seed=0,
                           device=DEV)
    torch.cuda.synchronize()
    launches = mk.LAUNCHES["mega_path"]
    n_e, n_m = int(n_e), int(n_m)
    print(f"[lights mega path] render() with MegaPathTracer, {LIGHTS_SPP} "
          f"spp: {launches} mega_path launches, {n_m} rays (eager {n_e}), "
          f"mean {img_m.mean().item():.5f} (eager "
          f"{img_e.mean().item():.5f})", flush=True)
    check(launches == LIGHTS_SPP, f"lights mega_path launched {launches}")
    check(bool(torch.isfinite(img_m).all()), "lights mega_path NaN/Inf")
    image_rule(img_m, img_e, f"lights render MegaPathTracer vs eager, "
                             f"{LIGHTS_SPP} spp")
    check(abs(n_m - n_e) <= 1e-4 * n_e, f"lights rays {n_m} vs {n_e}")
    k = mk.run_path(tables, rr, depth, depth, st0, pix, samp, 0)
    p = mk.path_plain(tables, rr, depth, depth, st0, pix, samp, 0)
    out["mega_path"] = {
        "launches": launches,
        "max_abs_err": compare_exact("lights mega_path, one sample", k, p),
        "ms": time_ms(lambda: mk.run_path(tables, rr, depth, depth, st0, pix,
                                          samp, 0), 20),
        "plain_ms": time_ms(lambda: mk.path_plain(
            tables, rr, depth, depth, st0, pix, samp, 0), 1, warmup=1),
        **mega_bound("lights mega_path, one sample", work_pass,
                     int(k[16].sum()), int(k[17].sum()), 0, pix.shape[0],
                     16, 18, tables, card)}

    # ---- 17. mega_persistent: LIGHTS_PERSIST_SPP against the eager image,
    # every 16th pixel against persistent_plain, one timed 256-spp launch
    trace.reset_launches()
    img_e, n_e = render_fn(scene, cam, film, eager, spp=LIGHTS_PERSIST_SPP,
                           seed=0, device=DEV)
    torch.cuda.synchronize()
    trace_launches = dict(trace.LAUNCHES)
    img_r, n_r = render_persistent(integ, cam, LIGHTS_PERSIST_SPP, seed=0)
    n_e, n_r = int(n_e), int(n_r)
    print(f"[lights persistent] {LIGHTS_PERSIST_SPP} spp: {n_r} rays (eager "
          f"{n_e}, trace launches {trace_launches}), mean "
          f"{img_r.mean().item():.5f} (eager {img_e.mean().item():.5f})",
          flush=True)
    check(bool(torch.isfinite(img_r).all()), "lights persistent NaN/Inf")
    image_rule(img_r, img_e, f"lights render_persistent vs eager, "
                             f"{LIGHTS_PERSIST_SPP} spp")
    check(abs(n_r - n_e) <= 1e-4 * n_e, f"lights persistent rays {n_r}")
    for name in ("trace_closest", "trace_any"):
        out[name]["launches"] = trace_launches[name]
    sub = slice(0, None, LIGHTS_PLAIN_LANES)
    pst = torch.cat([st0, torch.zeros_like(st0[:8])])
    pst_s = pst[:, sub].contiguous()
    pix_s, samp_s = pix[sub].contiguous(), samp[sub].contiguous()
    k = mk.run_persistent(tables, rr, depth, LIGHTS_PLAIN_SPP, cam, pst_s,
                          pix_s, samp_s, 0)
    plain_ms, p = events_ms(lambda: mk.persistent_plain(
        tables, rr, depth, LIGHTS_PLAIN_SPP, cam, pst_s, pix_s, samp_s, 0))
    err = compare_exact(f"lights mega_persistent, {pix_s.shape[0]} lanes x "
                        f"{LIGHTS_PLAIN_SPP} spp", k, p)
    run_p = lambda spp: mk.run_persistent(tables, rr, depth, spp, cam, pst,
                                          pix, samp, 0)
    run_p(LIGHTS_TIMED_SPP)
    mk.reset_launches()
    ms, o = events_ms(lambda: run_p(LIGHTS_TIMED_SPP))
    launches = mk.LAUNCHES["mega_persistent"]
    rays = int(o[22].sum()) + int(o[23].sum())
    check((o[17] == LIGHTS_TIMED_SPP).all().item(), "lights spp not done")
    check(bool(torch.isfinite(o[18:21]).all()), "lights persistent NaN/Inf")
    print(f"[lights persistent] {res}², {LIGHTS_TIMED_SPP} spp: one launch "
          f"{ms:.4f} ms (CUDA events), {rays} rays, {rays / ms * 1e3:.6g} "
          f"rays/s in the kernel, mean "
          f"{(o[18:21] / LIGHTS_TIMED_SPP).mean().item():.5f} ({card})",
          flush=True)
    out["mega_persistent"] = {
        "launches": launches, "ms": ms, "max_abs_err": err,
        "plain_ms": plain_ms,
        "plain_shape": f"{pix_s.shape[0]} lanes x {LIGHTS_PLAIN_SPP} spp",
        "ms_at_plain_shape": time_ms(lambda: mk.run_persistent(
            tables, rr, depth, LIGHTS_PLAIN_SPP, cam, pst_s, pix_s, samp_s,
            0), 3, warmup=1),
        **mega_bound(f"lights mega_persistent, {LIGHTS_TIMED_SPP} spp",
                     work_pass, int(o[22].sum()), int(o[23].sum()),
                     LIGHTS_TIMED_SPP * pix.shape[0], pix.shape[0], 24, 24,
                     tables, card)}
    del scene, tables, integ

    # ---- 18. thin lens: Cornell, aperture 0.05, focus 2 -------------------
    cornell = compile_scene(cornell_box(), device=DEV)
    lens = dataclasses.replace(cornell_camera(res, res), **LENS)
    ok, why = MegaPathTracer.supports(cornell, lens, film)
    check(ok, f"MegaPathTracer refuses the thin lens: {why}")
    integ = MegaPathTracer.for_scene(cornell, max_depth=depth)
    tables = integ.tables
    st0 = initial_state(*mk.primary_rays(lens, 0, pix, 0))
    pst = torch.cat([st0, torch.zeros_like(st0[:8])])
    k = mk.run_persistent(tables, rr, depth, LIGHTS_PLAIN_SPP, lens, pst,
                          pix, samp, 0)
    p = mk.persistent_plain(tables, rr, depth, LIGHTS_PLAIN_SPP, lens, pst,
                            pix, samp, 0)
    lens_err = compare_exact(f"thin-lens mega_persistent, {LIGHTS_PLAIN_SPP} "
                             "spp", k, p)
    img_e, n_e = render_fn(cornell, lens, film, PathTracer(max_depth=depth),
                           spp=LIGHTS_PERSIST_SPP, seed=0, device=DEV)
    img_r, n_r = render_persistent(integ, lens, LIGHTS_PERSIST_SPP, seed=0)
    pin = render_persistent(integ, cornell_camera(res, res),
                            LIGHTS_PERSIST_SPP, seed=0)[0]
    n_e, n_r = int(n_e), int(n_r)
    blur = (img_r - pin).abs().mean().item()
    print(f"[thin lens] {LIGHTS_PERSIST_SPP} spp: {n_r} rays (eager {n_e}),"
          f" mean {img_r.mean().item():.5f} (eager "
          f"{img_e.mean().item():.5f}); mean |thin lens - pinhole| "
          f"{blur:.4g}", flush=True)
    image_rule(img_r, img_e, f"thin-lens render_persistent vs eager, "
                             f"{LIGHTS_PERSIST_SPP} spp")
    check(abs(n_r - n_e) <= 1e-4 * n_e, f"thin-lens rays {n_r} vs {n_e}")
    check(blur > 1e-3, "the thin lens does not blur")
    ms_lens = time_ms(lambda: mk.run_persistent(
        tables, rr, depth, PERSIST_SPP, lens, pst, pix, samp, 0), 3,
        warmup=1)
    print(f"[thin lens] mega_persistent, {PERSIST_SPP} spp: {ms_lens:.4f} "
          f"ms ({card})", flush=True)
    out["mega_persistent"]["thin_lens"] = {"max_abs_err": lens_err,
                                           f"ms_{PERSIST_SPP}_spp": ms_lens}
    del cornell, tables, integ

    # ---- 19. the shade kernel under point, spot, directional and sky ------
    scene, cam4 = four_materials(res, lights=True)
    ok, why = sk.supports(scene)
    check(ok, f"shade refuses the four-material scene with lights: {why}")
    fam_ops = family_ops(mk.build_mega_tables(scene))
    tracer = PathTracer(max_depth=SHADE_DEPTH).specialized_for(scene)
    st = initial_state(*mk.primary_rays(cam4, 0, pix, 0))
    err, timing = 0.0, {}
    for b in range(max(SHADE_BOUNCES) + 1):
        if b in SHADE_BOUNCES:
            label = f"shade with lights, bounce {b}"
            packed = tracer.shade_inputs(scene, st, 0, pix, samp, b)
            run = lambda: sk.run_shade(scene, packed, pix, samp, 0, b,
                                       tracer.rr_depth, SHADE_DEPTH)
            plain = lambda: sk.shade_plain(scene, packed, pix, samp, 0, b,
                                           tracer.rr_depth, SHADE_DEPTH)
            err = max(err, compare_exact(label, run(), plain()))
            hit = packed[sk.I_HIT] > 0.5
            delta = hit & (packed[sk.I_NDELTA] > 0.5)
            env = hit & ~delta & (packed[sk.I_NDIST] > 1e29)
            lanes = sk.shadow_rays(packed, b, SHADE_DEPTH)[4]
            print(f"[shade lights] {label}: {hit.float().mean().item():.4f} "
                  f"of lanes hit, NEE delta on "
                  f"{delta.float().mean().item():.4f}, sky on "
                  f"{env.float().mean().item():.4f}, "
                  f"{lanes.float().mean().item():.4f} trace a shadow ray",
                  flush=True)
            check(bool(delta.any()) and bool(env.any()),
                  f"{label}: no delta or sky NEE sample")
            timing[b] = {"ms": time_ms(run, 50),
                         "any_hit_ms": shade_yardstick(scene, packed, b,
                                                       SHADE_DEPTH),
                         "plain_ms": time_ms(plain, 2, warmup=1),
                         **shade_bound(label, scene, packed, b,
                                       tracer.rr_depth, fam_ops, card)}
            print(f"[shade lights] {label}: kernel "
                  f"{timing[b]['ms'] * 1e3:.2f} us/launch, any-hit yardstick "
                  f"{timing[b]['any_hit_ms'] * 1e3:.2f} us ({card})",
                  flush=True)
        st = tracer.bounce(scene, st, 0, pix, samp, b)[0]
    results, spp = {}, SHADE_EAGER_SPP
    for mode in ("off", "on"):
        integ_e = PathTracer(max_depth=SHADE_DEPTH, fused_shade=mode)
        sk.reset_launches()
        t0 = time.perf_counter()
        img, n = render_fn(scene, cam4, film, integ_e, spp=spp, seed=0,
                           device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results[mode] = (img, int(n), sk.LAUNCHES["shade"])
        print(f"[shade lights fused {mode}] {res}², {SHADE_DEPTH} bounces, "
              f"{spp} spp: {wall:.3f} s, {int(n)} rays, {int(n) / wall:.4g} "
              f"rays/s, mean {img.mean().item():.5f} ({card})", flush=True)
        check(bool(torch.isfinite(img).all()), f"fused {mode}: NaN/Inf")
    (img_off, n_off, _), (img_on, n_on, l_on) = results["off"], results["on"]
    check(l_on == SHADE_DEPTH * spp, f"shade launched {l_on} times")
    image_rule(img_on, img_off, f"lights fused on vs off, {spp} spp")
    check(abs(n_on - n_off) <= 1e-4 * n_off, f"lights rays {n_on} vs {n_off}")
    out["shade"] = {"launches": l_on, "max_abs_err": err,
                    **timing[SHADE_BOUNCES[0]],
                    "bounce_3": timing[SHADE_BOUNCES[1]]}
    for k in kernels:
        k["lights_composites"] = out[k["name"]]


def fog_cornell_desc(builder, presets, **medium):
    """The foggy Cornell box (tests/test_mega_tpu.py:335-365) over either
    package's builder and presets modules; `medium` overrides fields of
    FOG_CORNELL (g, bound)."""
    desc = presets.cornell_box()
    desc.medium = builder.Medium(**{**FOG_CORNELL, **medium})
    return desc


def fog_point_desc(builder, tf, shapes, **medium):
    """The fog-and-point-light scene (tests/test_mega_tpu.py:426-466): a
    diffuse floor and sphere(16, 32) under a point light in FOG_POINT's
    fog, over either package's builder module; `medium` overrides fields
    of FOG_POINT (bound)."""
    d = builder.SceneDesc()
    floor = d.add_material(kind="diffuse", albedo=(0.6, 0.55, 0.5))
    d.add_shape(shapes.rectangle(), material=floor,
                to_world=tf.translate([0, -1, 0])
                @ tf.rotate([1, 0, 0], -90) @ tf.scale([6] * 3))
    d.add_shape(shapes.sphere(16, 32), material=floor)
    d.point_lights.append(builder.PointLight(position=[2.0, 3.0, 1.0],
                                             intensity=[40.0, 38.0, 35.0]))
    d.medium = builder.Medium(**{**FOG_POINT, **medium})
    return d


def fog_point_camera(cam_cls, tf, res):
    """A res² camera at the recipe's ray origin (0, 1, 5), looking along
    its mean direction (0, -0.1, -1), 45° fov."""
    return cam_cls(res, res, 45.0, tf.look_at(
        origin=[0, 1, 5], target=[0, 0.9, 4], up=[0, 1, 0]))


def proctex_desc(builder, tf, shapes, texture):
    """The procedural-texture scene of tests/test_mega_tpu.py:467-529 over
    either package's builder, transform, shapes and texture modules: a
    checkerboard floor, a grid wall (line width 0.02), a GGX rough
    conductor sphere(16, 32) (α 0.25) and a rectangle light at y = 4."""
    d = builder.SceneDesc()
    chk = d.add_texture(texture.checkerboard(color0=(0.7, 0.2, 0.2),
                                             color1=(0.2, 0.2, 0.7)))
    grd = d.add_texture(texture.grid_texture(color0=(0.1, 0.6, 0.1),
                                             color1=(0.7, 0.7, 0.6),
                                             line_width=0.02))
    floor = d.add_material(kind="diffuse", albedo=(1, 1, 1),
                           albedo_texture=chk)
    wall = d.add_material(kind="diffuse", albedo=(1, 1, 1),
                          albedo_texture=grd)
    metal = d.add_material(kind="roughconductor", alpha=0.25)
    d.add_shape(shapes.rectangle(), material=floor,
                to_world=tf.translate([0, -1, 0])
                @ tf.rotate([1, 0, 0], -90) @ tf.scale([4] * 3))
    d.add_shape(shapes.rectangle(), material=wall,
                to_world=tf.translate([0, 1, -3]) @ tf.scale([4] * 3))
    d.add_shape(shapes.sphere(16, 32), material=metal)
    d.add_shape(shapes.rectangle(), material=floor, radiance=(12, 11, 10),
                to_world=tf.translate([0, 4, 0])
                @ tf.rotate([1, 0, 0], 90) @ tf.scale([2] * 3))
    return d


def recipe_camera(cam_cls, tf, res, down=0.15):
    """A res² camera (45° fov) at the texture recipes' ray origin (0, 1,
    5), looking along their mean direction (0, -down, -1)."""
    return cam_cls(res, res, 45.0, tf.look_at(
        origin=[0, 1, 5], target=[0, 1 - down, 4], up=[0, 1, 0]))


def sky_image(h, w):
    """The envmap of tests/test_envmap_texture.py:15-22 at h×w: a vertical
    gradient and a bright sun patch at (u, v) = (0.3, 0.3)."""
    v, u = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                       indexing="ij")
    base = 0.2 + 0.8 * (1 - v)
    sun = 20.0 * np.exp(-(((u - 0.3) * 8) ** 2 + ((v - 0.3) * 8) ** 2))
    return np.stack([base + sun, base + 0.8 * sun, base + 0.5 * sun],
                    -1).astype(np.float32)


def smooth_noise(rs, res, cells, channels, lo, hi):
    """A res² image of `channels` channels in [lo, hi]: seeded uniform
    noise on a cells² grid, blown up and box-blurred three times over a
    cell (wrapping), so it is smooth and tiles."""
    img = np.kron(rs.rand(cells, cells, channels),
                  np.ones((res // cells, res // cells, 1)))
    k = res // cells
    for axis in (0, 1):
        for _ in range(3):
            img = sum(np.roll(img, s, axis) for s in range(-(k // 2),
                                                          k - k // 2)) / k
    return (lo + (hi - lo) * img).astype(np.float32)


@functools.lru_cache(maxsize=None)
def texenv_images(seed=0):
    """The texenv scene's bitmaps from a seed: a 512² albedo (ten mip
    levels), a 256² roughness map (σ in [0.05, 0.9]), a 256² tangent-space
    normal map (ripples, encoded to [0, 1]³) and a 256² height map. Made
    once per seed; the scene descriptions only read them."""
    rs = np.random.RandomState(seed)
    albedo = smooth_noise(rs, 512, 16, 3, 0.15, 0.85)
    rough = smooth_noise(rs, 256, 8, 1, 0.05, 0.9)[..., 0]
    y, x = np.meshgrid((np.arange(256) + 0.5) / 256,
                       (np.arange(256) + 0.5) / 256, indexing="ij")
    ph = rs.rand(2) * 2 * np.pi
    n = np.stack([-0.4 * np.cos(12 * np.pi * x + ph[0]),
                  -0.4 * np.cos(8 * np.pi * y + ph[1]), np.ones_like(x)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    height = smooth_noise(rs, 256, 8, 1, 0.0, 1.0)[..., 0]
    return {"albedo": albedo, "roughness": rough,
            "normal": (0.5 * n + 0.5).astype(np.float32), "height": height}


def texenv_desc(builder, tf, shapes, texture, sky=TEXENV_SKY):
    """Config 3's scene ("texenv") over either package's builder,
    transform, shapes and texture modules, from texenv_images(): an
    envmap (sky_image at sky = (rows, columns), scale 1) as the only
    light; a diffuse floor with the 512² albedo bitmap; a rough-diffuse
    back wall whose σ is the roughness bitmap; a diffuse quad with the
    normal map and one with the height map as a bump map (scale 0.05); a
    checkerboard quad; a GGX rough conductor sphere (α 0.2) and a GGX
    rough dielectric sphere (α 0.1)."""
    img = texenv_images()
    d = builder.SceneDesc()
    t_alb = d.add_texture(img["albedo"])
    t_rough = d.add_texture(img["roughness"])
    t_norm = d.add_texture(img["normal"])
    t_bump = d.add_texture(img["height"])
    t_chk = d.add_texture(texture.checkerboard(color0=(0.8, 0.75, 0.2),
                                               color1=(0.1, 0.1, 0.3),
                                               tiles=4))
    floor = d.add_material(kind="diffuse", albedo_texture=t_alb)
    wall = d.add_material(kind="roughdiffuse", albedo=(0.6, 0.55, 0.5),
                          roughness_texture=t_rough)
    nmap = d.add_material(kind="diffuse", albedo=(0.7, 0.7, 0.7),
                          normal_texture=t_norm)
    bump = d.add_material(kind="diffuse", albedo=(0.5, 0.6, 0.7),
                          normal_texture=t_bump, bump_scale=0.05)
    chk = d.add_material(kind="diffuse", albedo_texture=t_chk)
    metal = d.add_material(kind="roughconductor", alpha=0.2)
    glass = d.add_material(kind="roughdielectric", alpha=0.1, int_ior=1.5)
    d.add_shape(shapes.rectangle(), material=floor,
                to_world=tf.translate([0, -1, 0])
                @ tf.rotate([1, 0, 0], -90) @ tf.scale([4] * 3))
    d.add_shape(shapes.rectangle(), material=wall,
                to_world=tf.translate([0, 1, -3]) @ tf.scale([4] * 3))
    for x, m in ((-2.2, nmap), (2.2, bump)):
        d.add_shape(shapes.rectangle(), material=m,
                    to_world=tf.translate([x, 0.3, -1.5])
                    @ tf.rotate([0, 1, 0], 25 if x < 0 else -25)
                    @ tf.scale([0.8] * 3))
    d.add_shape(shapes.rectangle(), material=chk,
                to_world=tf.translate([0, 1.7, -2.0]) @ tf.scale([0.7] * 3))
    for x, m in ((-0.9, metal), (0.9, glass)):
        d.add_shape(shapes.sphere(12, 24), material=m,
                    to_world=tf.translate([x, -0.4, 0.2])
                    @ tf.scale([0.6] * 3))
    d.envmap = builder.EnvmapLight(image=sky_image(*sky))
    return d


def tex_scene(name, res, device=DEV):
    """The port's "texenv" or "proctex" scene on `device`, its res²
    camera and its scene description."""
    from mitsuba_tpu_torch.core import transform as tf
    from mitsuba_tpu_torch.scene import builder, shapes
    from mitsuba_tpu_torch.sensor.sensor import PerspectiveCamera
    from mitsuba_tpu_torch.texture import texture
    make = {"texenv": texenv_desc, "proctex": proctex_desc}[name]
    desc = make(builder, tf, shapes, texture)
    return (builder.compile_scene(desc, device=device),
            recipe_camera(PerspectiveCamera, tf, res), desc)


def fog_scene(name, res, device=DEV):
    """FOG_SCENES[name] compiled on `device`, and its res² camera."""
    from mitsuba_tpu_torch.core import transform as tf
    from mitsuba_tpu_torch.scene import builder, presets, shapes
    from mitsuba_tpu_torch.sensor.sensor import PerspectiveCamera
    kind, medium = FOG_SCENES[name]
    if kind == "cornell":
        return (builder.compile_scene(
            fog_cornell_desc(builder, presets, **medium), device=device),
            presets.cornell_camera(res, res))
    return (builder.compile_scene(
        fog_point_desc(builder, tf, shapes, **medium), device=device),
        fog_point_camera(PerspectiveCamera, tf, res))


def mega_exact(name, tables, cam, res, depth, rr, plain_cam):
    """Phases 20 and 21's lane-by-lane checks on one scene at res²:
    mega_bounce at EXACT_BOUNCES from the plain wavefront, mega_path over
    one sample, mega_persistent at EXACT_PLAIN_SPP on plain_cam's
    EXACT_PLAIN_RES² pixels, each against its plain version bit for bit
    with the count rows; returns their max abs errors and the plain
    versions' times."""
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.integrator.path import initial_state
    pix = torch.arange(res * res, dtype=torch.int32, device=DEV)
    samp = torch.zeros_like(pix)
    st0 = initial_state(*mk.primary_rays(cam, 0, pix, 0))
    errs = {"mega_bounce": 0.0}
    st = st0
    for b in range(max(EXACT_BOUNCES) + 1):
        p = mk.bounce_plain(tables, rr, depth, st, pix, samp, 0, b)
        if b in EXACT_BOUNCES:
            k = mk.run_bounce(tables, rr, depth, st, pix, samp, 0, b)
            errs["mega_bounce"] = max(errs["mega_bounce"], compare_exact(
                f"{name} mega_bounce, bounce {b}", k, p))
        st = p[:16]
    k = mk.run_path(tables, rr, depth, depth, st0, pix, samp, 0)
    plain_path_ms, p = events_ms(lambda: mk.path_plain(
        tables, rr, depth, depth, st0, pix, samp, 0))
    errs["mega_path"] = compare_exact(f"{name} mega_path, one sample", k, p)
    check(bool((k[17] <= k[16]).all()), f"{name}: shadow counts")
    pix_p = torch.arange(EXACT_PLAIN_RES ** 2, dtype=torch.int32, device=DEV)
    pst = torch.cat([initial_state(*mk.primary_rays(plain_cam, 0, pix_p, 0)),
                     torch.zeros((8, pix_p.shape[0]), device=DEV)])
    k = mk.run_persistent(tables, rr, depth, EXACT_PLAIN_SPP, plain_cam, pst,
                          pix_p, torch.zeros_like(pix_p), 0)
    plain_ms, p = events_ms(lambda: mk.persistent_plain(
        tables, rr, depth, EXACT_PLAIN_SPP, plain_cam, pst, pix_p,
        torch.zeros_like(pix_p), 0))
    errs["mega_persistent"] = compare_exact(
        f"{name} mega_persistent, {EXACT_PLAIN_RES}² x {EXACT_PLAIN_SPP} spp",
        k, p)
    check(bool((k[17] == EXACT_PLAIN_SPP).all()), f"{name}: spp not done")
    return errs, {"mega_path": plain_path_ms, "mega_persistent": plain_ms,
                  "ms_at_plain_shape": time_ms(lambda: mk.run_persistent(
                      tables, rr, depth, EXACT_PLAIN_SPP, plain_cam, pst,
                      pix_p, torch.zeros_like(pix_p), 0), 3, warmup=1)}


def eager_rate(label, scene, cam, film, integrator, card, spp=FOG_SPP,
               traced=("trace_closest", "trace_any"), profile=True,
               stats=None):
    """render_fn at `spp` with the trace and shade kernels' launches
    counted: (image, rays, launches), with rays/s (also into
    stats["rays/s"] where a dict is given) and (profile) the busy share
    of a 1-spp pass printed; fails unless each launch of `traced` ran."""
    from mitsuba_tpu_torch.accel import shade_kernel as sk
    from mitsuba_tpu_torch.accel import trace
    from mitsuba_tpu_torch.render import render_fn
    render_fn(scene, cam, film, integrator, spp=1, seed=0, device=DEV)
    torch.cuda.synchronize()                                # (warm-up)
    trace.reset_launches()
    sk.reset_launches()
    t0 = time.perf_counter()
    img, n = render_fn(scene, cam, film, integrator, spp=spp, seed=0,
                       device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**trace.LAUNCHES, **sk.LAUNCHES}
    print(f"[{label}] {film.width}², {spp} spp: {wall:.3f} s, {int(n)} "
          f"rays, {int(n) / wall:.6g} rays/s, mean {img.mean().item():.5f},"
          f" launches {launches} ({card})", flush=True)
    check(bool(torch.isfinite(img).all()), f"{label}: NaN/Inf")
    check(all(launches[k] > 0 for k in traced),
          f"{label}: a trace kernel was not launched")
    if stats is not None:
        stats["rays/s"] = int(n) / wall
    if profile:
        profile_pass(scene, cam, film, integrator, card)
    return img, int(n), launches


def fog_phases(card, kernels, guards):
    """Phase 20: the homogeneous medium (FOG_SCENES) and the direct
    integrator. Adds to the trace kernel's and the megakernels' entries of
    `kernels` a "fog" object: launches on this phase's paths (the eager
    VolPathTracer render for the trace kernel; render() with
    MegaVolPathTracer, one timed render_persistent launch and the
    bounce-by-bounce pass), the error against the plain version and the
    times and bound on the fog Cornell box. guards: the Cornell 2048-spp
    and lights 256-spp launch times of this run, printed beside
    GUARD_BANDS for information (they fail nothing)."""
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.core.math import SHADOW_EPSILON
    from mitsuba_tpu_torch.film.film import Film
    from mitsuba_tpu_torch.integrator.common import ray_mint
    from mitsuba_tpu_torch.integrator.direct import DirectIntegrator
    from mitsuba_tpu_torch.integrator.mega import (MegaPathTracer,
                                                   MegaVolPathTracer,
                                                   render_persistent)
    from mitsuba_tpu_torch.integrator.path import initial_state
    from mitsuba_tpu_torch.integrator.volpath import VolPathTracer
    from mitsuba_tpu_torch.render import render_fn
    from mitsuba_tpu_torch.scene.builder import compile_scene
    from mitsuba_tpu_torch.scene.presets import cornell_box, cornell_camera

    t_start = time.perf_counter()
    depth, res = MAX_DEPTH, CORNELL_RES
    out = {k["name"]: {} for k in kernels}
    scene, cam = fog_scene("fog", res)
    film = Film(res, res, "box")
    check(MegaPathTracer.supports(scene) == (False, "participating medium"),
          "MegaPathTracer accepts the medium")
    ok, why = MegaVolPathTracer.supports(scene, cam, film)
    check(ok, f"MegaVolPathTracer refuses the fog: {why}")
    integ = MegaVolPathTracer.for_scene(scene, max_depth=depth)
    tables, rr = integ.tables, integ.rr_depth
    check(tables.ext and tables.medium is not None, "fog: no medium tables")
    pix = torch.arange(res * res, dtype=torch.int32, device=DEV)
    samp = torch.zeros_like(pix)
    st0 = initial_state(*mk.primary_rays(cam, 0, pix, 0))
    o0, d0 = st0[0:3].T.contiguous(), st0[3:6].T.contiguous()

    # ---- 20. the trace kernel on the fog's camera rays and the shadow
    # rays of its first bounce (from scatter points, with no offset) -----
    errs = {"trace_closest": 0.0, "trace_any": 0.0}
    primary = (o0, d0, ray_mint(o0), torch.full_like(o0[:, 0], 1e30), None)
    _, in_med, ds, so, attempted = nee_rays(tables, st0, pix, samp, 0,
                                            depth)
    shadow = (so, ds.d, ray_mint(so), ds.dist * (1.0 - SHADOW_EPSILON),
              attempted)
    print(f"[fog] {int(in_med.sum())} of {pix.shape[0]} camera rays scatter "
          f"before a surface; {int(shadow[4].sum())} shadow rays, "
          f"{int((shadow[4] & in_med).sum())} from scatter points",
          flush=True)
    compare("fog primary", scene, *primary, errs)
    compare("fog shadow", scene, *shadow, errs)
    for name, any_hit, rays in (("trace_closest", False, primary),
                                ("trace_any", True, shadow)):
        out[name] = {"max_abs_err": errs[name],
                     **measure(f"{name}, fog bounce 0", any_hit, scene,
                               rays, 3, card)}

    # ---- 20. every megakernel lane by lane on each fog scene ------------
    for name in FOG_SCENES:
        r = res if name == "fog" else FOG_VARIANT_RES
        sc, cm = (scene, cam) if name == "fog" else fog_scene(name, r)
        tb = tables if name == "fog" else \
            MegaVolPathTracer.for_scene(sc, max_depth=depth).tables
        e, plain = mega_exact(name, tb, cm, r, depth, rr,
                             fog_scene(name, EXACT_PLAIN_RES)[1])
        for key, err in e.items():
            out[key]["max_abs_err"] = max(out[key].get("max_abs_err", 0.0),
                                          err)
        if name == "fog":
            fog_plain = plain
        del sc, tb

    # ---- 20. mega_bounce: one pass bounce by bounce (counted) ------------
    mk.reset_launches()
    st, counts = st0, torch.zeros_like(st0[:2])
    for b in range(depth):
        o = mk.run_bounce(tables, rr, depth, st, pix, samp, 0, b)
        st, counts = o[:16], counts + o[16:18]
    torch.cuda.synchronize()
    launches = mk.LAUNCHES["mega_bounce"]
    ref = mk.run_path(tables, rr, depth, depth, st0, pix, samp, 0)
    check(launches == depth, f"fog mega_bounce launched {launches} times")
    check(torch.equal(st, ref[:16]) and torch.equal(counts, ref[16:18]),
          "fog: bounce-by-bounce pass differs from mega_path")
    works, work_pass = pass_work(tables, st0, pix, samp, depth)
    print(f"[fog] medium fp32 ops per lane: {medium_ops(tables)}",
          flush=True)
    out0 = mk.run_bounce(tables, rr, depth, st0, pix, samp, 0, 0)
    out["mega_bounce"].update({
        "launches": launches,
        "ms": time_ms(lambda: mk.run_bounce(tables, rr, depth, st0, pix,
                                            samp, 0, 0), 50),
        "plain_ms": time_ms(lambda: mk.bounce_plain(
            tables, rr, depth, st0, pix, samp, 0, 0), 3, warmup=1),
        **mega_bound("fog mega_bounce, bounce 0", works[0],
                     int(out0[16].sum()), int(out0[17].sum()), 0,
                     pix.shape[0], 16, 18, tables, card)})

    # ---- 20. the eager VolPathTracer (counted), render() with
    # MegaVolPathTracer (counted) and render_persistent against it -------
    img_e, n_e, trace_launches = eager_rate(
        "fog eager VolPathTracer", scene, cam, film,
        VolPathTracer(max_depth=depth), card)
    for name in ("trace_closest", "trace_any"):
        out[name]["launches"] = trace_launches[name]
    mk.reset_launches()
    img_m, n_m = render_fn(scene, cam, film, integ, spp=FOG_SPP, seed=0,
                           device=DEV)
    torch.cuda.synchronize()
    launches = mk.LAUNCHES["mega_path"]
    img_r, n_r = render_persistent(integ, cam, FOG_SPP, seed=0)
    n_m, n_r = int(n_m), int(n_r)
    print(f"[fog mega] {FOG_SPP} spp: render() {launches} mega_path "
          f"launches, {n_m} rays (attempted shadow rays), render_persistent "
          f"{n_r}; eager {n_e} (unoccluded); means "
          f"{img_m.mean().item():.5f} / {img_r.mean().item():.5f} / "
          f"{img_e.mean().item():.5f}", flush=True)
    check(launches == FOG_SPP, f"fog mega_path launched {launches} times")
    for img, label in ((img_m, "render() MegaVolPathTracer"),
                       (img_r, "render_persistent")):
        check(bool(torch.isfinite(img).all()), f"fog {label}: NaN/Inf")
        image_rule(img, img_e, f"fog {label} vs eager, {FOG_SPP} spp")
    check(n_m >= n_e and n_r >= n_e and n_m == n_r,
          f"fog ray counts: attempted {n_m} / {n_r}, unoccluded {n_e}")
    check(img_e.mean().item() < 0.1, "the fog does not attenuate")
    k = mk.run_path(tables, rr, depth, depth, st0, pix, samp, 0)
    out["mega_path"].update({
        "launches": launches, "plain_ms": fog_plain["mega_path"],
        "ms": time_ms(lambda: mk.run_path(tables, rr, depth, depth, st0, pix,
                                          samp, 0), 20),
        **mega_bound("fog mega_path, one sample", work_pass,
                     int(k[16].sum()), int(k[17].sum()), 0, pix.shape[0],
                     16, 18, tables, card)})

    # ---- 20. one timed 256-spp mega_persistent launch (counted) ----------
    pst = torch.cat([st0, torch.zeros_like(st0[:8])])
    run_p = lambda: mk.run_persistent(tables, rr, depth, FOG_TIMED_SPP, cam,
                                      pst, pix, samp, 0)
    run_p()
    mk.reset_launches()
    ms, o = events_ms(run_p)
    launches = mk.LAUNCHES["mega_persistent"]
    rays = int(o[22].sum()) + int(o[23].sum())
    check(launches == 1 and bool((o[17] == FOG_TIMED_SPP).all()),
          "fog 256-spp launch")
    check(bool(torch.isfinite(o[18:21]).all()), "fog persistent NaN/Inf")
    print(f"[fog persistent] {res}², {FOG_TIMED_SPP} spp: one launch "
          f"{ms:.4f} ms (CUDA events), {rays} rays, {rays / ms * 1e3:.6g} "
          f"rays/s in the kernel, mean "
          f"{(o[18:21] / FOG_TIMED_SPP).mean().item():.5f} ({card})",
          flush=True)
    out["mega_persistent"].update({
        "launches": launches, "ms": ms,
        "plain_ms": fog_plain["mega_persistent"],
        "plain_shape": f"{EXACT_PLAIN_RES}² lanes x {EXACT_PLAIN_SPP} spp",
        "ms_at_plain_shape": fog_plain["ms_at_plain_shape"],
        **mega_bound(f"fog mega_persistent, {FOG_TIMED_SPP} spp", work_pass,
                     int(o[22].sum()), int(o[23].sum()),
                     FOG_TIMED_SPP * pix.shape[0], pix.shape[0], 24, 24,
                     tables, card)})
    del tables, integ

    # ---- 20. the eager VolPathTracer and DirectIntegrator: card against
    # CPU tensors, and DirectIntegrator's rays/s on the Cornell box -------
    cornell = compile_scene(cornell_box(), device=DEV)
    eager_rate("Cornell eager DirectIntegrator", cornell, cam, film,
               DirectIntegrator(), card)
    small = Film(FOG_CPU_RES, FOG_CPU_RES, "box")
    cam_s = cornell_camera(FOG_CPU_RES, FOG_CPU_RES)
    for label, (sc_card, sc_cpu), integrator in (
            ("VolPathTracer", (fog_scene("fog", 1)[0],
                               fog_scene("fog", 1, "cpu")[0]),
             VolPathTracer(max_depth=depth)),
            ("DirectIntegrator", (cornell, compile_scene(cornell_box(),
                                                         device="cpu")),
             DirectIntegrator(emitter_samples=2))):
        img_k, n_k = render_fn(sc_card, cam_s, small, integrator,
                               spp=FOG_CPU_SPP, seed=0, device=DEV)
        img_c, n_c = render_fn(sc_cpu, cam_s, small, integrator,
                               spp=FOG_CPU_SPP, seed=0, device="cpu")
        print(f"[fog cpu] {label}, {FOG_CPU_RES}², {FOG_CPU_SPP} spp: card "
              f"{int(n_k)} rays, CPU {int(n_c)}", flush=True)
        image_rule(img_k.cpu(), img_c, f"{label} card vs CPU tensors")
        check(abs(int(n_k) - int(n_c)) <= 1e-4 * int(n_c),
              f"{label}: rays {int(n_k)} vs {int(n_c)}")
    for key, value in guards.items():
        lo, hi = GUARD_BANDS[key]
        print(f"[guard] {key}: {value:.4f} ms; {lo}-{hi} ms in other calls "
              f"before the medium branch ({value / lo - 1:+.1%} / "
              f"{value / hi - 1:+.1%}); information only, "
              f"scripts/ab_persistent.py compares builds in one call "
              f"({card})", flush=True)
    print(f"[fog] phase 20: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    for k in kernels:
        if out[k["name"]]:
            k["fog"] = out[k["name"]]


def tex_phases(card, kernels):
    """Phase 21: config 3's textures and envmap on the eager path
    ("texenv") and the procedural albedo in the megakernels ("proctex").
    Adds to each kernel's entry of `kernels` a "textures" object: the
    trace and shade kernels' launches on texenv's eager render (fused
    "on" for the shade kernel), error and times on its rays; the
    megakernels' launches, error, times and bound on proctex."""
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.accel import shade_kernel as sk
    from mitsuba_tpu_torch.core.math import SHADOW_EPSILON
    from mitsuba_tpu_torch.film.film import Film
    from mitsuba_tpu_torch.integrator.common import (offset_ray_origin,
                                                     ray_mint)
    from mitsuba_tpu_torch.integrator.mega import (MegaPathTracer,
                                                   render_persistent)
    from mitsuba_tpu_torch.core import transform as tf
    from mitsuba_tpu_torch.integrator.path import PathTracer, initial_state
    from mitsuba_tpu_torch.render import render_fn
    from mitsuba_tpu_torch.sensor.sensor import PerspectiveCamera

    t_start = time.perf_counter()
    res = CORNELL_RES
    out = {k["name"]: {} for k in kernels}
    pix = torch.arange(res * res, dtype=torch.int32, device=DEV)
    samp = torch.zeros_like(pix)
    film = Film(res, res, "box")

    # ---- 21. proctex: every megakernel's textured branch lane by lane ----
    depth = PROCTEX_DEPTH
    scene, cam, desc = tex_scene("proctex", res)
    check(MegaPathTracer.supports(scene) == (False, "textured material"),
          "MegaPathTracer takes proctex without its provenance")
    integ = MegaPathTracer.for_scene(scene, max_depth=depth,
                                     tex_procs=desc.tex_procs)
    tables, rr = integ.tables, integ.rr_depth
    check(tables.textured and tables.ext, "proctex: no textured tables")
    print(f"[proctex] {scene.n_tris} triangles, "
          f"{scene.woop_clusters.shape[0]} clusters; albedo fp32 ops per "
          f"hit {tex_ops()}", flush=True)
    errs, plain = mega_exact("proctex", tables, cam, res, depth, rr,
                             recipe_camera(PerspectiveCamera, tf,
                                           EXACT_PLAIN_RES))
    for key, err in errs.items():
        out[key]["max_abs_err"] = err
    st0 = initial_state(*mk.primary_rays(cam, 0, pix, 0))
    mk.reset_launches()
    st, counts = st0, torch.zeros_like(st0[:2])
    for b in range(depth):
        o = mk.run_bounce(tables, rr, depth, st, pix, samp, 0, b)
        st, counts = o[:16], counts + o[16:18]
    torch.cuda.synchronize()
    launches = mk.LAUNCHES["mega_bounce"]
    ref = mk.run_path(tables, rr, depth, depth, st0, pix, samp, 0)
    check(launches == depth, f"proctex mega_bounce launched {launches}")
    check(torch.equal(st, ref[:16]) and torch.equal(counts, ref[16:18]),
          "proctex: bounce-by-bounce pass differs from mega_path")
    works, work_pass = pass_work(tables, st0, pix, samp, depth)
    out0 = mk.run_bounce(tables, rr, depth, st0, pix, samp, 0, 0)
    out["mega_bounce"].update({
        "launches": launches,
        "ms": time_ms(lambda: mk.run_bounce(tables, rr, depth, st0, pix,
                                            samp, 0, 0), 50),
        "plain_ms": time_ms(lambda: mk.bounce_plain(
            tables, rr, depth, st0, pix, samp, 0, 0), 3, warmup=1),
        **mega_bound("proctex mega_bounce, bounce 0", works[0],
                     int(out0[16].sum()), int(out0[17].sum()), 0,
                     pix.shape[0], 16, 18, tables, card)})

    # ---- 21. render() with MegaPathTracer (counted) and render_persistent
    # against the eager PathTracer on the bitmaps ------------------------
    img_e, n_e = render_fn(scene, cam, film, PathTracer(max_depth=depth),
                           spp=PROCTEX_SPP, seed=0, device=DEV)
    mk.reset_launches()
    img_m, n_m = render_fn(scene, cam, film, integ, spp=PROCTEX_SPP, seed=0,
                           device=DEV)
    torch.cuda.synchronize()
    launches = mk.LAUNCHES["mega_path"]
    img_r, n_r = render_persistent(integ, cam, PROCTEX_SPP, seed=0)
    n_e, n_m, n_r = int(n_e), int(n_m), int(n_r)
    print(f"[proctex mega] {PROCTEX_SPP} spp: render() {launches} mega_path "
          f"launches, {n_m} rays, render_persistent {n_r}, eager {n_e}; "
          f"means {img_m.mean().item():.5f} / {img_r.mean().item():.5f} / "
          f"{img_e.mean().item():.5f}", flush=True)
    check(launches == PROCTEX_SPP, f"proctex mega_path launched {launches}")
    for img, label in ((img_m, "render() MegaPathTracer"),
                       (img_r, "render_persistent")):
        check(bool(torch.isfinite(img).all()), f"proctex {label}: NaN/Inf")
        image_rule(img, img_e, f"proctex {label} vs eager, {PROCTEX_SPP} "
                               "spp")
    for n in (n_m, n_r):
        check(abs(n - n_e) <= 1e-4 * n_e, f"proctex rays {n} vs {n_e}")
    k = mk.run_path(tables, rr, depth, depth, st0, pix, samp, 0)
    out["mega_path"].update({
        "launches": launches, "plain_ms": plain["mega_path"],
        "ms": time_ms(lambda: mk.run_path(tables, rr, depth, depth, st0, pix,
                                          samp, 0), 20),
        **mega_bound("proctex mega_path, one sample", work_pass,
                     int(k[16].sum()), int(k[17].sum()), 0, pix.shape[0],
                     16, 18, tables, card)})

    # ---- 21. one timed 256-spp mega_persistent launch (counted) ----------
    pst = torch.cat([st0, torch.zeros_like(st0[:8])])
    run_p = lambda: mk.run_persistent(tables, rr, depth, PROCTEX_TIMED_SPP,
                                      cam, pst, pix, samp, 0)
    run_p()
    mk.reset_launches()
    ms, o = events_ms(run_p)
    launches = mk.LAUNCHES["mega_persistent"]
    rays = int(o[22].sum()) + int(o[23].sum())
    check(launches == 1 and bool((o[17] == PROCTEX_TIMED_SPP).all()),
          "proctex 256-spp launch")
    check(bool(torch.isfinite(o[18:21]).all()), "proctex persistent NaN/Inf")
    print(f"[proctex persistent] {res}², {PROCTEX_TIMED_SPP} spp: one launch"
          f" {ms:.4f} ms (CUDA events), {rays} rays, "
          f"{rays / ms * 1e3:.6g} rays/s in the kernel, mean "
          f"{(o[18:21] / PROCTEX_TIMED_SPP).mean().item():.5f} ({card})",
          flush=True)
    out["mega_persistent"].update({
        "launches": launches, "ms": ms,
        "plain_ms": plain["mega_persistent"],
        "plain_shape": f"{EXACT_PLAIN_RES}² lanes x {EXACT_PLAIN_SPP} spp",
        "ms_at_plain_shape": plain["ms_at_plain_shape"],
        **mega_bound(f"proctex mega_persistent, {PROCTEX_TIMED_SPP} spp",
                     work_pass, int(o[22].sum()), int(o[23].sum()),
                     PROCTEX_TIMED_SPP * pix.shape[0], pix.shape[0], 24, 24,
                     tables, card)})
    del tables, integ, scene

    # ---- 21. texenv: the trace and shade kernels on bounce-0 and bounce-3
    # rays (envmap shadow rays at maxt ENV_DIST) --------------------------
    depth = TEXENV_DEPTH
    scene, cam, _ = tex_scene("texenv", res)
    ok, why = sk.supports(scene)
    check(ok, f"the shade kernel refuses texenv: {why}")
    print(f"[texenv] {scene.n_tris} triangles, "
          f"{scene.woop_clusters.shape[0]} clusters, "
          f"{scene.tex_data.shape[0]} texels, envmap "
          f"{tuple(scene.env_img.shape[:2])}", flush=True)
    fam_ops = family_ops(mk.build_mega_tables(scene))
    tracer = PathTracer(max_depth=depth, accel="plain").specialized_for(
        scene)
    errs = {"trace_closest": 0.0, "trace_any": 0.0}
    shade_err, shade_rows = 0.0, {}
    st = initial_state(*mk.primary_rays(cam, 0, pix, 0))
    for b in range(max(TEXENV_BOUNCES) + 1):
        if b in TEXENV_BOUNCES:
            live = st[12] > 0.5
            o, d = st[0:3].T.contiguous(), st[3:6].T.contiguous()
            v = tracer._vertex(scene, st, 0, pix, samp, b)
            so = offset_ray_origin(v.its.p, v.its.ng, v.ds.d)
            rays = {"trace_closest": (o, d, ray_mint(o),
                                      torch.full_like(o[:, 0], 1e30), live),
                    "trace_any": (so, v.ds.d, ray_mint(so), v.ds.dist
                                  * (1.0 - SHADOW_EPSILON), v.shadow)}
            env = int((v.shadow & (v.ds.dist >= 1e30)).sum())
            print(f"[texenv] bounce {b}: {int(live.sum())} live rays, "
                  f"{int(v.shadow.sum())} shadow rays, {env} of them to the "
                  f"envmap at maxt ~1e30", flush=True)
            compare(f"texenv bounce {b} rays", scene, *rays["trace_closest"],
                    errs)
            compare(f"texenv bounce {b} shadow", scene, *rays["trace_any"],
                    errs)
            for name, any_hit in (("trace_closest", False),
                                  ("trace_any", True)):
                out[name][f"b{b}"] = measure(
                    f"{name}, texenv bounce {b}", any_hit, scene,
                    rays[name], 2, card)
            packed = tracer.shade_inputs(scene, st, 0, pix, samp, b)
            run = lambda: sk.run_shade(scene, packed, pix, samp, 0, b,
                                       tracer.rr_depth, depth)
            plain_fn = lambda: sk.shade_plain(scene, packed, pix, samp, 0,
                                              b, tracer.rr_depth, depth)
            shade_err = max(shade_err, compare_exact(
                f"texenv shade, bounce {b}", run(), plain_fn()))
            shade_rows[f"b{b}"] = {
                "ms": time_ms(run, 50),
                "plain_ms": time_ms(plain_fn, 3, warmup=1),
                **shade_bound(f"texenv shade, bounce {b}", scene, packed, b,
                              tracer.rr_depth, fam_ops, card, depth)}
        st = tracer.bounce(scene, st, 0, pix, samp, b)[0]
    for name in ("trace_closest", "trace_any"):
        out[name]["max_abs_err"] = errs[name]
    out["shade"].update({"max_abs_err": shade_err, **shade_rows})

    # ---- 21. the eager path, fused "off" and "on" (counted) --------------
    images = {}
    for mode in ("off", "on"):
        img, n, launches = eager_rate(
            f"texenv eager, fused {mode}", scene, cam, film,
            PathTracer(max_depth=depth, fused_shade=mode), card,
            spp=TEXENV_SPP, traced=("trace_closest",) if mode == "on"
            else ("trace_closest", "trace_any"))
        images[mode] = img
        if mode == "on":
            out["shade"]["launches"] = launches["shade"]
            check(launches["shade"] == depth * TEXENV_SPP,
                  f"texenv shade launched {launches['shade']} times")
        else:
            for name in ("trace_closest", "trace_any"):
                out[name]["launches"] = launches[name]
    image_rule(images["on"], images["off"],
               f"texenv fused on vs off, {TEXENV_SPP} spp")

    # ---- 21. the card against CPU tensors ---------------------------------
    small = Film(TEXENV_CPU_RES, TEXENV_CPU_RES, "box")
    cpu_scene, cpu_cam, _ = tex_scene("texenv", TEXENV_CPU_RES, "cpu")
    integ = PathTracer(max_depth=depth)
    img_k, n_k = render_fn(scene, cpu_cam, small, integ,
                           spp=TEXENV_CPU_SPP, seed=0, device=DEV)
    img_c, n_c = render_fn(cpu_scene, cpu_cam, small, integ,
                           spp=TEXENV_CPU_SPP, seed=0, device="cpu")
    print(f"[texenv cpu] {TEXENV_CPU_RES}², {TEXENV_CPU_SPP} spp: card "
          f"{int(n_k)} rays, CPU {int(n_c)}", flush=True)
    image_rule(img_k.cpu(), img_c, "texenv card vs CPU tensors")
    check(abs(int(n_k) - int(n_c)) <= 1e-4 * int(n_c),
          f"texenv rays {int(n_k)} vs {int(n_c)}")
    print(f"[tex] phase 21: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    for k in kernels:
        if out[k["name"]]:
            k["textures"] = out[k["name"]]


def order_scene(name, res, device=DEV):
    """A scene of ORDER_SCENES compiled on `device`, and its res²
    camera."""
    if name == "leaf":
        return leaf_scene(res, device)
    if name == "lights":
        return lights_scene(res, device)
    if name == "texenv":
        return tex_scene("texenv", res, device)[:2]
    return four_materials(res, device)


def order_rays(scene, cam, res, bounces=ORDER_BOUNCES, device=DEV):
    """The rays the eager path hands the trace kernel at each bounce of
    `bounces` (PathTracer(max_depth=ORDER_DEPTH), plain tracing, seed 0):
    "b{b}": the wavefront, every lane in pixel order with the live ones
    marked, for a closest hit; "b{b} shadow": its NEE shadow rays, for an
    any hit. Each is (o, d, mint, maxt, live)."""
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.core.math import SHADOW_EPSILON
    from mitsuba_tpu_torch.integrator.common import (offset_ray_origin,
                                                     ray_mint)
    from mitsuba_tpu_torch.integrator.path import PathTracer, initial_state
    pix = torch.arange(res * res, dtype=torch.int32, device=device)
    samp = torch.zeros_like(pix)
    tracer = PathTracer(max_depth=ORDER_DEPTH,
                        accel="plain").specialized_for(scene)
    st = initial_state(*mk.primary_rays(cam, 0, pix, 0))
    out = {}
    for b in range(max(bounces) + 1):
        if b in bounces:
            o, d = st[0:3].T.contiguous(), st[3:6].T.contiguous()
            out[f"b{b}"] = (o, d, ray_mint(o), torch.full_like(o[:, 0], 1e30),
                            st[12] > 0.5)
            v = tracer._vertex(scene, st, 0, pix, samp, b)
            so = offset_ray_origin(v.its.p, v.its.ng, v.ds.d)
            out[f"b{b} shadow"] = (so, v.ds.d, ray_mint(so),
                                   v.ds.dist * (1.0 - SHADOW_EPSILON),
                                   v.shadow)
        st = tracer.bounce(scene, st, 0, pix, samp, b)[0]
    return out


def walking_warps(live):
    """[ceil(N / 32)] bool: the warps of 32 lanes with a live lane."""
    n_w = -(-live.shape[0] // 32)
    pad = n_w * 32 - live.shape[0]
    return torch.cat([live, live.new_zeros(pad)]).view(n_w, 32).any(1)


def order_exact(label, scene, rays):
    """The trace kernel (the build bound now) against ordered_walk_plain,
    visits included, and against dense.py, closest and any hit, bit for
    bit on every lane. Returns the mean cluster positions a warp with a
    live lane stepped through, by mode."""
    from mitsuba_tpu_torch.accel import dense, trace
    o, d, mint, maxt, live = rays
    ref = dense.intersect_soup(o, d, scene.woop_o, mint, maxt, live)
    walking = walking_warps(live)
    out = {}
    for any_hit in (False, True):
        vis = torch.full((walking.shape[0],), -1, dtype=torch.int32,
                         device=DEV)
        k = trace.trace(scene, *rays, any_hit, visits=vis)
        p = trace.ordered_walk_plain(scene, *rays, any_hit)
        same = (torch.equal(k[4], p[4]) and torch.equal(k[4], ref[4])
                and torch.equal(vis, p[5]))
        if not any_hit:
            same = same and all(
                torch.equal(a, b) and torch.equal(a, c) for a, b, c in
                zip((k[0], k[1].long(), k[2], k[3]), p[:4], ref[:4]))
        check(same, f"{label} ({'any' if any_hit else 'closest'}): the "
                    "ordered kernel differs from its plain version")
        out["any" if any_hit else "closest"] = \
            vis[walking].float().mean().item()
    return out


def order_phase(card, kernels, cornell):
    """Phase 22: the ordered walk. Adds "ordered" to the trace kernel's
    entries of `kernels`: by scene and ray set its time under the default
    build (ordered, the exit every 4 clusters) beside the index order, the
    warps' visits and the bound; Cornell's times under both; the eager
    rays/s under both. cornell: {label: (scene,
    rays, any_hit)} of phase 2's rays."""
    from mitsuba_tpu_torch.accel import trace
    from mitsuba_tpu_torch.film.film import Film
    from mitsuba_tpu_torch.integrator.path import PathTracer
    t_start = time.perf_counter()
    res = CORNELL_RES
    cases, rows = {}, {"closest": {}, "any": {}}
    for name in ORDER_SCENES:
        scene, cam = order_scene(name, res, DEV)
        check(trace.walks_ordered(scene),
              f"{name}: the trace kernel does not walk it in order")
        for label, rays in order_rays(scene, cam, res, device=DEV).items():
            visits = order_exact(f"order {name} {label}", scene, rays)
            any_hit = label.endswith("shadow")
            mode = "any" if any_hit else "closest"
            key = f"{name} {label}"
            cases[key] = (scene, rays, any_hit)
            rows[mode][key] = {
                "visits": visits[mode], "clusters":
                scene.cluster_order.shape[0],
                "walked": -(-trace.real_tris(scene) // TRIS_PER_CLUSTER),
                **measure(f"trace_{mode}, {key} (ordered)", any_hit, scene,
                          rays, 1, card)}
            print(f"[order] {key}: {int(rays[4].sum())} rays, mean "
                  f"positions a warp: closest {visits['closest']:.3f}, any "
                  f"{visits['any']:.3f} of {rows[mode][key]['walked']} "
                  f"walked clusters", flush=True)
    cases.update(cornell)
    # the builds in turns; each held exact on its first turn
    held, turns = set(), []
    for variant in ORDER_TURNS:
        defines = ORDER_VARIANTS.get(variant, ())
        row = {}
        with walk_build(*defines, trace_only=True):
            for key, (scene, rays, any_hit) in cases.items():
                if variant not in held and not key.startswith("cornell"):
                    compare(f"{variant} {key}", scene, *rays,
                            {"trace_closest": 0.0, "trace_any": 0.0})
                row[key] = time_ms(lambda: trace.trace(scene, *rays,
                                                       any_hit), 20)
        held.add(variant)
        turns.append((variant, row))
        print(f"[order] {variant}: " + ", ".join(
            f"{k} {v * 1e3:.2f} us" for k, v in row.items()) + f" ({card})",
            flush=True)
    for key, (_, _, any_hit) in cases.items():
        mean = {v: np.mean([r[key] for w, r in turns if w == v])
                for v in ("new", "index")}
        print(f"[order] mean {key}: ordered {mean['new'] * 1e3:.2f} us, "
              f"index order {mean['index'] * 1e3:.2f} us ({card})",
              flush=True)
        entry = rows["any" if any_hit else "closest"].setdefault(key, {})
        entry.update({"ms_turns": mean["new"], "index_ms": mean["index"]})
    # the eager path under both builds
    film = Film(res, res, "box")
    eager = {}
    for name in ("leaf", "texenv"):
        if name == "leaf":
            scene, cam = leaf_scene(res, DEV, rough_plastic=False)
        else:
            scene, cam = order_scene(name, res, DEV)
        for variant in ("new", "index"):
            with walk_build(*ORDER_VARIANTS.get(variant, ()),
                            trace_only=True):
                for mode in ("off", "on"):
                    stats = {}
                    eager_rate(f"order eager {name} {variant}, fused {mode}",
                               scene, cam, film,
                               PathTracer(max_depth=ORDER_DEPTH if name ==
                                          "leaf" else TEXENV_DEPTH,
                                          fused_shade=mode), card,
                               spp=ORDER_EAGER_SPP, profile=False,
                               traced=("trace_closest",) if mode == "on"
                               else ("trace_closest", "trace_any"),
                               stats=stats)
                    eager[f"{name} {variant} fused {mode}"] = stats["rays/s"]
    print(f"[order] phase 22 walk: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    for k in kernels:
        if k["name"] in ("trace_closest", "trace_any"):
            k["ordered"] = {"by_rays": rows[k["name"][6:]],
                            "eager_rays_per_s": eager}


def soup_ops(woop_o, rays):
    """fp32 operations the triangle tests of these ray sets need against
    every triangle of woop_o (a table the rays all enter, as e1's
    everything-box): each test OPS_DZ, OPS_T past d'_z, OPS_UV where t
    lies in range up to the ray's closest hit; rays: [(o, d, mint, maxt,
    t), ...] with t the closest hit (MISS on a miss)."""
    from mitsuba_tpu_torch.accel import dense
    w = woop_o.view(4, -1, 3)
    n_dz = n_t = n_tests = 0
    for o, d, mint, maxt, t in rays:
        dz = ((d[:, 0, None] * w[0, :, 2] + d[:, 1, None] * w[1, :, 2])
              + d[:, 2, None] * w[2, :, 2])
        oz = (((o[:, 0, None] * w[0, :, 2] + o[:, 1, None] * w[1, :, 2])
               + o[:, 2, None] * w[2, :, 2]) + w[3, :, 2])
        ok = dz.abs() >= 1e-12
        tt = -oz / torch.where(ok, dz, 1.0)
        cap = torch.where(t < dense.MISS, t, maxt)
        in_range = (ok & (tt > mint[:, None]) & (tt < maxt[:, None])
                    & (tt <= cap[:, None]))
        n_tests += dz.numel()
        n_dz = n_dz + ok.sum()
        n_t = n_t + in_range.sum()
    return OPS_DZ * n_tests + OPS_T * int(n_dz) + OPS_UV * int(n_t)


def probe_phase(card, kernels):
    """Phase 22's probes (mitsuba_tpu_torch/experiments, the ports of
    experiments/'s TPU probes): e0's two variants, e1 at the TPU probe's
    inputs and on the Cornell and leaf tables, every gather form; each
    kernel held to its plain version, timed beside its bound and (the
    gathers) torch.gather. Appends their entries to `kernels` (no path of
    the program launches them: launches 0)."""
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.accel import trace
    from mitsuba_tpu_torch.experiments import gather_probe as gp
    from mitsuba_tpu_torch.experiments import roofline as rf
    from mitsuba_tpu_torch.scene.builder import compile_scene
    from mitsuba_tpu_torch.scene.presets import cornell_box, cornell_camera
    t_start = time.perf_counter()
    # ---- e0: the fp32 ceiling ------------------------------------------
    x = torch.ones(rf.E0_ROWS, rf.B, device=DEV)
    xr = torch.rand(rf.E0_ROWS, rf.B, device=DEV,
                    generator=torch.Generator(DEV).manual_seed(0)) + 0.5
    flops = rf.e0_flops(x.numel(), rf.E0_ITERS)
    outs = {fma: rf.e0(xr, E0_CHECK_ITERS, fma) for fma in (True, False)}
    # FFMA and FMUL+FADD round differently: the variants must differ on
    # many lanes (58.5% of these after 64 steps, by the plain versions), or
    # the FFMA build does not fuse
    differ = (outs[True] != outs[False]).float().mean().item()
    check(differ >= E0_DIFFER, f"e0: FFMA and FMUL+FADD differ on only "
                               f"{differ:.3%} of lanes")
    for fma, name in ((True, "e0_ffma"), (False, "e0_fmul_fadd")):
        k = outs[fma]
        plain_ms, p = events_ms(lambda: rf.e0_plain(xr, E0_CHECK_ITERS, fma))
        check(torch.equal(k, p), f"{name} differs from its plain version")
        ms = time_ms(lambda: rf.e0(x, rf.E0_ITERS, fma), 3, warmup=1)
        bound = flops / PEAK_FP32 * 1e3
        print(f"[e0] {name}: [{rf.E0_ROWS}, {rf.B}] x {rf.E0_ITERS} steps "
              f"{ms:.4f} ms, {flops / ms / 1e9:.6g} TFLOP/s (bound "
              f"{bound:.4f} ms at 67 TFLOP/s); bit-equal to the plain "
              f"version over {E0_CHECK_ITERS} steps, {differ:.2%} of lanes "
              f"apart from the other variant ({card})", flush=True)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mitsuba_tpu_torch/csrc/roofline.cu",
            "replaces": "experiments/_exp_roofline.py:40",
            "launches": 0, "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms,
            "plain_shape": f"{E0_CHECK_ITERS} steps",
            "bound_ms": bound, "bound_by": "operations",
            "tflops": flops / ms / 1e9, "library_ms": None})
    # ---- e1: the walk with no shading ------------------------------------
    table, st = rf.probe_table(device=DEV), rf.probe_state(device=DEV)
    hits = torch.zeros(rf.E1_ITERS, 2, dtype=torch.int32, device=DEV)
    k = rf.e1(table, st, rf.E1_ITERS, hits)
    plain_ms, (p, p_hits, rays) = events_ms(
        lambda: rf.e1_plain(table, st, rf.E1_ITERS, record=True))
    check(torch.equal(k, p) and torch.equal(hits, p_hits),
          "e1 at the probe's inputs differs from its plain version")
    ms = time_ms(lambda: rf.e1(table, st, rf.E1_ITERS), 3, warmup=1)
    ops = soup_ops(table.woop_o, rays)
    del rays
    bound = ops / PEAK_FP32 * 1e3
    share = (hits.float() / rf.B).tolist()
    n_rays = 2 * rf.B * rf.E1_ITERS
    print(f"[e1] probe inputs ({rf.B} lanes, {rf.TC} triangles, "
          f"{rf.E1_ITERS} steps): {ms:.4f} ms, {n_rays / ms * 1e3:.6g} "
          f"rays/s, bound {bound:.4f} ms ({ops} fp32 ops), plain "
          f"{plain_ms:.1f} ms, bit-equal; lanes hitting (first, second "
          f"trace) at steps 0-3 {share[:4]}, at the last {share[-1]} "
          f"({card})", flush=True)
    e1_row = {"name": "e1_trace_only", "route": "cuda",
              "source": "mitsuba_tpu_torch/csrc/roofline.cu",
              "replaces": "experiments/_exp_roofline.py:116",
              "launches": 0, "max_abs_err": 0.0, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound,
              "bound_by": "operations", "rays_per_s": n_rays / ms * 1e3,
              "hit_share": share[:4] + share[-1:], "library_ms": None}
    res = CORNELL_RES
    pix = torch.arange(res * res, dtype=torch.int32, device=DEV)
    for name, (scene, cam) in (
            ("cornell", (compile_scene(cornell_box(), device=DEV),
                         cornell_camera(res, res))),
            ("leaf", leaf_scene(res, DEV))):
        o, d = mk.primary_rays(cam, 0, pix, 0)
        st = torch.cat([o.T, d.T]).contiguous()
        p, p_hits = rf.e1_plain(scene, st, E1_SCENE_ITERS)
        # the table without its order tables: the index-order walk
        walks = {"index": rf.Table(scene.woop_clusters, scene.cluster_aabb,
                                   scene.woop_o, scene.n_real_tris)}
        if trace.walks_ordered(scene):
            walks["ordered"] = scene
        for walk, tab in walks.items():
            hits = torch.zeros(E1_SCENE_ITERS, 2, dtype=torch.int32,
                               device=DEV)
            k = rf.e1(tab, st, E1_SCENE_ITERS, hits)
            check(torch.equal(k, p) and torch.equal(hits, p_hits),
                  f"e1 on {name} ({walk}) differs from its plain version")
            ms = time_ms(lambda: rf.e1(tab, st, E1_SCENE_ITERS), 5)
            n_rays = 2 * st.shape[1] * E1_SCENE_ITERS
            share = (hits.float() / st.shape[1]).tolist()
            e1_row[f"{name} {walk}"] = {"ms": ms,
                                        "rays_per_s": n_rays / ms * 1e3,
                                        "hit_share": share}
            print(f"[e1] {name} camera rays, {walk} walk, "
                  f"{E1_SCENE_ITERS} steps: {ms:.4f} ms, "
                  f"{n_rays / ms * 1e3:.6g} rays/s, bit-equal; lanes "
                  f"hitting by step {[[round(a, 4) for a in s] for s in share]}"
                  f" (a missed ray's origin runs off by 1e27: later steps "
                  f"walk little) ({card})", flush=True)
    kernels.append(e1_row)
    # ---- the gathers ------------------------------------------------------
    forms = {}
    for name in gp.FORMS:
        tab, idx, axis, col = gp.make_form(name, gp.fill_scale(name), DEV)
        idx64 = idx.long()
        k = gp.gather(tab, idx, axis, col)
        plain_ms, p = events_ms(lambda: gp.gather_plain(tab, idx, axis, col))
        check(torch.equal(k, p), f"gather {name} differs from its plain "
                                 "version")
        check(torch.equal(gp.gather_library(tab, idx64, axis, col), p),
              f"gather {name}: the library call differs")
        ms = time_ms(lambda: gp.launch(tab, idx, axis, col), 20)
        lib_ms = time_ms(lambda: gp.gather_library(tab, idx64, axis, col),
                         20)
        n_bytes = gp.form_bytes(tab, idx)
        bound = n_bytes / PEAK_BYTES * 1e3
        forms[name] = {"idx_shape": list(idx.shape), "ms": ms,
                       "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": bound, "gb_per_s": n_bytes / ms / 1e6,
                       "library_gb_per_s": n_bytes / lib_ms / 1e6}
        print(f"[gather] {name}, idx {tuple(idx.shape)}: {ms:.4f} ms, "
              f"{n_bytes / ms / 1e6:.6g} GB/s; torch.gather/take "
              f"{lib_ms:.4f} ms, {n_bytes / lib_ms / 1e6:.6g} GB/s; plain "
              f"{plain_ms:.4f} ms; bound {bound:.4f} ms at 3.35 TB/s "
              f"({card})", flush=True)
        del tab, idx, idx64, k, p
    main_form = forms["column [512,128]"]
    kernels.append({"name": "gather", "route": "cuda",
                    "source": "mitsuba_tpu_torch/csrc/gather.cu",
                    "replaces": "experiments/_exp_gather_probe.py:29; "
                                "experiments/_exp_gather_probe2.py:23",
                    "launches": 0, "max_abs_err": 0.0,
                    **{k: main_form[k] for k in ("ms", "plain_ms",
                                                 "bound_ms")},
                    "bound_by": "bytes",
                    "library_ms": main_form["library_ms"],
                    "forms": forms})
    print(f"[probes] phase 22 probes: {time.perf_counter() - t_start:.1f} s",
          flush=True)


def ablate_ops(tables, states, fam_ops):
    """The full variant's fp32 operations a lane-step by part, bounce_work
    (at max_depth 0, seed 1) on its plain states before steps 0-7 averaged
    over lanes and steps: the closest walk's tests, the shadow walk's, the
    shading's."""
    from mitsuba_tpu_torch.experiments import ablate
    n = states[0].shape[1]
    pix = torch.arange(n, dtype=torch.int32, device=DEV)
    works = [bounce_work(tables, st, pix, torch.zeros_like(pix), k, fam_ops,
                         ablate.MAX_DEPTH, seed=ablate.SEED)
             for k, st in enumerate(states)]
    return {key: sum(w[key] for w in works) / (n * len(states))
            for key in ("c_ops", "s_ops", "shade_ops")}


def ablate_variant_ops(per, variant, clusters):
    """fp32 operations a lane-step of `variant`: the full variant's parts
    (ablate_ops) that it keeps, its own work in place of the parts it
    stubs, and the keep-alive. A bound from the full variant's rays: a
    stubbed closest hit sends other rays down the shadow walk."""
    from mitsuba_tpu_torch.experiments import ablate as ab
    c, sh, sd = per["c_ops"], per["s_ops"], per["shade_ops"]
    own = {ab.FULL: c + sh + sd, ab.NO_SHADOW: c + sd, ab.NO_CLOSEST: sh + sd,
           ab.NO_TRACES: sd, ab.NO_ATTR: c + sh + sd,
           ab.TRANSFORM: (clusters * TRIS_PER_CLUSTER * ABLATE_ROW_OPS
                          + ABLATE_T_OPS + sh + sd),
           ab.NO_SHADE: c + sh + ABLATE_NOSHADE_OPS}
    return own[variant] + ABLATE_KEEP_OPS


def ablate_steps(variant, clusters, lanes):
    """The steps of a timed launch: ABLATE_STEPS, the transform variant's
    within ABLATE_TRANSFORM_BUDGET (a power of two)."""
    from mitsuba_tpu_torch.experiments import ablate
    if variant != ablate.TRANSFORM:
        return ABLATE_STEPS
    steps = ABLATE_TRANSFORM_BUDGET // (clusters * lanes)
    steps = 1 << max(steps, 1).bit_length() - 1
    return min(ABLATE_STEPS, max(ABLATE_TRANSFORM_MIN, steps))


def ablate_phase(card, kernels, cornell, cam):
    """Phase 23: the ablation probe (csrc/ablate.cu, experiments/ablate.py)
    and unbounded depth. Every variant bit for bit against its plain
    version after ABLATE_CHECK_STEPS steps on every lane of the Cornell
    tables (cluster_size 64, the TPU probe's) from the probe's start state
    and of the leaf-families tables from every 8th of its 256² camera
    rays; then each variant timed once at ABLATE_STEPS steps (the transform
    variant: ablate_steps) on both tables at each of ABLATE_LANES (the leaf
    scene's lanes: its camera rays) beside its bound (ablate_variant_ops,
    over 67 TFLOP/s), and the bounce's split (ablate.split) for each. Then
    max_depth 0 on the megakernels (`cornell`, the phase-2 scene, and its
    256² camera): mega_bounce at bounces 0 and 9 and mega_path over 32
    bounces against their plain versions on every lane, bit for bit;
    render_persistent at UNBOUNDED_SPP spp (counted) against
    persistent_plain on every 16th pixel, bit for bit, and against the
    eager PathTracer(max_depth=0) image under the image rule. Appends the
    ablate_<variant> entries to `kernels` (launches 0: no path of the
    program launches them)."""
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.experiments import ablate as ab
    from mitsuba_tpu_torch.film.film import Film
    from mitsuba_tpu_torch.integrator.mega import (MegaPathTracer,
                                                   render_persistent)
    from mitsuba_tpu_torch.integrator.path import PathTracer, initial_state
    from mitsuba_tpu_torch.render import render_fn
    from mitsuba_tpu_torch.scene.builder import compile_scene
    from mitsuba_tpu_torch.scene.presets import cornell_box
    t_start = time.perf_counter()
    leaf, leaf_cam = leaf_scene(CORNELL_RES, DEV)
    n_px = CORNELL_RES ** 2
    pix = torch.arange(n_px, dtype=torch.int32, device=DEV)
    leaf_st = initial_state(*mk.primary_rays(leaf_cam, 0, pix, 0))
    scenes = {
        "cornell": (MegaPathTracer.for_scene(compile_scene(
            cornell_box(), cluster_size=64, device=DEV)).tables,
            {b: ab.probe_state(b, DEV) for b in ABLATE_LANES}),
        "leaf": (MegaPathTracer.for_scene(leaf, max_depth=6).tables,
                 {b: leaf_st[:, ::n_px // b].contiguous()
                  for b in ABLATE_LANES})}
    entries = [{"name": f"ablate_{name}", "route": "cuda",
                "source": "mitsuba_tpu_torch/csrc/ablate.cu",
                "replaces": "experiments/_exp_ablate.py:154",
                "launches": 0, "max_abs_err": 0.0, "label": label}
               for name, label in zip(ab.NAMES, ab.VARIANTS)]
    splits = {}
    for sname, (tables, starts) in scenes.items():
        clusters = tables.woop.shape[0]
        check(not tables.ext, f"{sname}: the ablation takes kExt = false")
        st = starts[ABLATE_CHECK_LANES]
        # ---- every variant against its plain version ----------------------
        fam_ops = family_ops(tables)
        for v, name in enumerate(ab.NAMES):
            k = ab.run_fixed(tables, st, ABLATE_CHECK_STEPS, v)
            if v == ab.FULL:   # step by step: the states bound the work
                states, p, counts = [st], st, torch.zeros_like(st[:2])
                plain_ms = 0.0
                for s in range(ABLATE_CHECK_STEPS):
                    ms, out = events_ms(lambda: ab.run_fixed_plain(
                        tables, p, 1, v, bounce0=s))
                    plain_ms += ms
                    p, counts = out[:16], counts + out[16:18]
                    states.append(p)
                p = torch.cat([p, counts])
                per = ablate_ops(tables, states[:-1], fam_ops)
            else:
                plain_ms, p = events_ms(lambda: ab.run_fixed_plain(
                    tables, st, ABLATE_CHECK_STEPS, v))
            err = compare_exact(f"ablate {name}, {sname}, "
                                f"{ABLATE_CHECK_STEPS} steps", k, p)
            e = entries[v]
            e["max_abs_err"] = max(e["max_abs_err"], err)
            e.setdefault("plain", {})[sname] = {
                "ms": plain_ms,
                "shape": f"{st.shape[1]} lanes x {ABLATE_CHECK_STEPS} steps"}
            print(f"[ablate] {sname} {name}: bit-equal to the plain version "
                  f"on {st.shape[1]} lanes after {ABLATE_CHECK_STEPS} steps; "
                  f"closest hits {k[16].mean().item():.3f}, occluded shadow "
                  f"rays {k[17].mean().item():.3f} a lane; plain "
                  f"{plain_ms:.1f} ms", flush=True)
        print(f"[ablate] {sname}: the full bounce's fp32 ops a lane-step "
              f"over steps 0-{ABLATE_CHECK_STEPS - 1}: closest walk "
              f"{per['c_ops']:.1f}, shadow walk {per['s_ops']:.1f}, shading "
              f"{per['shade_ops']:.1f}", flush=True)
        # ---- timed, beside the bound ------------------------------------------
        for b in ABLATE_LANES:
            us = []
            for v, name in enumerate(ab.NAMES):
                steps = ablate_steps(v, clusters, b)
                ms, _ = events_ms(lambda: ab.run_fixed(tables, starts[b],
                                                       steps, v))
                ops = ablate_variant_ops(per, v, clusters) * b * steps
                bound = ops / PEAK_FP32 * 1e3
                us.append(ms * 1e3 / steps)
                entries[v].setdefault("times", {})[f"{sname} {b}"] = {
                    "steps": steps, "ms": ms, "us_per_step": us[-1],
                    "bound_ms": bound}
                print(f"[ablate] {sname}, {b} lanes, {name} "
                      f"({ab.VARIANTS[v]}), {steps} steps: {ms:.4f} ms, "
                      f"{us[-1]:.3f} us/step, "
                      f"{2 * b / (us[-1] * 1e-6) / 1e6:.0f} M rays/s equiv; "
                      f"bound {bound:.4f} ms ({ops:.4g} fp32 ops), "
                      f"{ms / bound:.1f}x ({card})", flush=True)
            splits[f"{sname} {b}"] = ab.split(us)
            print(f"[ablate] split, {sname}, {b} lanes (us/step): " + ", ".join(
                f"{key} {val:.3f}" for key, val in
                splits[f"{sname} {b}"].items()) + f" of {us[ab.FULL]:.3f} "
                f"({card})", flush=True)
    t = entries[ab.TRANSFORM]["times"]
    ratio = ((t[f"leaf {ABLATE_LANES[0]}"]["us_per_step"]
              / t[f"cornell {ABLATE_LANES[0]}"]["us_per_step"]))
    print(f"[ablate] transform only: leaf ({scenes['leaf'][0].woop.shape[0]} "
          f"clusters) / Cornell (1) per step at {ABLATE_LANES[0]} lanes "
          f"{ratio:.1f}x: the transform is not folded away", flush=True)
    check(ratio > 10.0, f"transform variant scales {ratio:.1f}x with 80x "
                        "the clusters: folded away?")
    for e in entries:   # the TPU probe's shape: Cornell, 8192 lanes
        main = e["times"][f"cornell {ABLATE_LANES[0]}"]
        e.update({"ms": main["ms"], "steps": main["steps"],
                  "plain_ms": e["plain"]["cornell"]["ms"],
                  "plain_shape": e["plain"]["cornell"]["shape"],
                  "bound_ms": main["bound_ms"], "bound_by": "operations",
                  "library_ms": None})
    entries[ab.FULL]["split"] = splits
    kernels.extend(entries)
    t_ablate = time.perf_counter() - t_start

    # ---- unbounded depth on the megakernels --------------------------------
    integ = MegaPathTracer.for_scene(cornell, max_depth=0)
    tables, rr = integ.tables, integ.rr_depth
    samp = torch.zeros_like(pix)
    st0 = initial_state(*mk.primary_rays(cam, 0, pix, 0))
    st9 = st0
    for b in range(9):
        st9 = mk.bounce_plain(tables, rr, 0, st9, pix, samp, 0, b)[:16]
    for b, st in ((0, st0), (9, st9)):
        k = mk.run_bounce(tables, rr, 0, st, pix, samp, 0, b)
        compare_exact(f"mega_bounce, max_depth 0, bounce {b}", k,
                      mk.bounce_plain(tables, rr, 0, st, pix, samp, 0, b))
    k = mk.run_path(tables, rr, 0, 32, st0, pix, samp, 0)
    compare_exact("mega_path, max_depth 0, 32 bounces", k,
                  mk.path_plain(tables, rr, 0, 32, st0, pix, samp, 0))
    long_paths, longest = int((k[16] > 8).sum()), int(k[16].max())
    check(long_paths > 0, "no path went past 8 bounces at max_depth 0")
    mk.reset_launches()
    img_p, n_p = render_persistent(integ, cam, UNBOUNDED_SPP, seed=0)
    torch.cuda.synchronize()
    launches = mk.LAUNCHES["mega_persistent"]
    check(launches == 1, f"mega_persistent launched {launches} times")
    pst = torch.cat([st0, torch.zeros_like(st0[:8])])
    sub = slice(0, None, UNBOUNDED_PLAIN_LANES)
    k = mk.run_persistent(tables, rr, 0, UNBOUNDED_SPP, cam, pst, pix, samp,
                          0)
    compare_exact(f"mega_persistent, max_depth 0, {UNBOUNDED_SPP} spp, "
                  f"every {UNBOUNDED_PLAIN_LANES}th pixel", k[:, sub],
                  mk.persistent_plain(tables, rr, 0, UNBOUNDED_SPP, cam,
                                      pst[:, sub].contiguous(),
                                      pix[sub].contiguous(),
                                      samp[sub].contiguous(), 0))
    img_e, n_e = render_fn(cornell, cam, Film(CORNELL_RES, CORNELL_RES),
                           PathTracer(max_depth=0), spp=UNBOUNDED_SPP,
                           seed=0, device=DEV)
    n_p, n_e = int(n_p), int(n_e)
    image_rule(img_p, img_e, f"render_persistent vs eager, max_depth 0, "
                             f"{UNBOUNDED_SPP} spp")
    # the eager path stops at 32 bounces, the persistent kernel runs each
    # path to its end: as many rays or more, within rel 1e-3
    check(n_e <= n_p <= n_e * (1 + 1e-3),
          f"max_depth 0 rays: persistent {n_p}, eager {n_e}")
    print(f"[unbounded] Cornell {CORNELL_RES}², max_depth 0: "
          f"{long_paths} of {n_px} mega_path lanes past 8 bounces (longest "
          f"{longest}); render_persistent "
          f"{UNBOUNDED_SPP} spp {n_p} rays, mean {img_p.mean().item():.5f}; "
          f"eager {n_e} rays, mean {img_e.mean().item():.5f} ({card})",
          flush=True)
    print(f"[ablate] phase 23: ablation {t_ablate:.1f} s, unbounded "
          f"{time.perf_counter() - t_start - t_ablate:.1f} s", flush=True)


def peak_run(fn):
    """(CUDA-event ms, wall s, torch.cuda.max_memory_allocated in MiB
    after reset_peak_memory_stats, memory allocated before in MiB, fn's
    result) of one fn()."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 20
    t0 = time.perf_counter()
    ms, out = events_ms(fn)
    wall = time.perf_counter() - t0
    return ms, wall, torch.cuda.max_memory_allocated() / 2 ** 20, base, out


def prb_phase(card, kernels, scene, cam):
    """Phase 24: config 4 on the Cornell box (`scene`, `cam`: phase 2's,
    CORNELL_RES², MAX_DEPTH bounces), the training path of the port.
    PRB_STEPS steps of plain gradient descent on the red and green walls'
    albedos and the light's radiance, started at PRB_START times the
    preset's, toward a target rendered with the preset's values; the
    target and every step draw the sample stream of PRB_SEED, so the loss
    is a smooth function of the values, 0 at the preset's. Each step
    renders PRB_SPP sample passes detached, forms the per-pixel L2 loss,
    turns it into each sample's dL (the box filter: ∂loss/∂pixel / spp)
    and calls PRBPathTracer.li_and_grad once a pass; the trace kernel's
    launches counted over the loop, the loss printed a step and required
    to fall.
    Then one step at the final values and a new seed: through the trace
    kernel against accel="plain" (L bit for bit on every lane, gradients
    within 1e-5·max|g|), the forward with fused_shade "on" against "off"
    on every lane, PRB against loss.backward() through render_fn
    (fused_shade "off") by tests/test_prb.py:61-69's rule (every entry
    without roulette, the radiance with it: PRB holds roulette detached,
    naive autograd differentiates it), and the PRB
    step, the naive step and one detached forward each timed (wall and
    CUDA events) beside its peak memory and trace launches. Adds a "prb"
    object to the trace kernel's two entries of `kernels`."""
    from mitsuba_tpu_torch.accel import trace
    from mitsuba_tpu_torch.film.film import Film
    from mitsuba_tpu_torch.integrator.path import PathTracer
    from mitsuba_tpu_torch.integrator.prb import PRBPathTracer
    from mitsuba_tpu_torch.render import render_fn, sample_camera
    t_start = time.perf_counter()
    dev = scene.device
    res = cam.width
    film = Film(res, cam.height, "box")
    px = torch.arange(res * cam.height, device=dev)
    with torch.no_grad():
        target = render_fn(scene, cam, film, PathTracer(max_depth=MAX_DEPTH),
                           PRB_SPP, seed=PRB_SEED, device=dev)[0]
    mask = {"mat_params": torch.zeros_like(scene.mat_params),
            "em_radiance": torch.ones_like(scene.em_radiance)}
    mask["mat_params"][list(PRB_ROWS), 0:3] = 1.0
    params = {k: getattr(scene, k) * (1.0 - (1.0 - PRB_START) * m)
              for k, m in mask.items()}

    def loss_of(img):
        return ((img - target) ** 2).mean()

    def prb_step(params, seed, tracer):
        """(loss, gradients summed over the passes, each pass's L)."""
        sc = scene._replace(**params)
        with torch.no_grad():
            img = render_fn(sc, cam, film, tracer, PRB_SPP, seed,
                            device=dev)[0]
        loss = loss_of(img)
        dL = (2.0 * (img - target) / img.numel()).reshape(-1, 3) / PRB_SPP
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        Ls = []
        for s in range(PRB_SPP):
            _, o, d = sample_camera(cam, res, seed, px, s)
            L, g = tracer.li_and_grad(sc, o, d, seed, px, s, dL)
            Ls.append(L)
            for k in grads:
                grads[k] += g[k]
        return loss.item(), grads, Ls

    def naive_step(params, seed, rr_depth=PathTracer.rr_depth):
        live = {k: v.clone().requires_grad_() for k, v in params.items()}
        img = render_fn(scene._replace(**live), cam, film,
                        PathTracer(max_depth=MAX_DEPTH, rr_depth=rr_depth,
                                   fused_shade="off"),
                        PRB_SPP, seed, device=dev)[0]
        loss = loss_of(img)
        loss.backward()
        return loss.item(), {k: v.grad for k, v in live.items()}

    # ---- the descent, its trace launches counted -------------------------
    prb = PRBPathTracer(max_depth=MAX_DEPTH)
    losses = []
    trace.reset_launches()
    t0 = time.perf_counter()
    for step in range(PRB_STEPS):
        loss, grads, _ = prb_step(params, PRB_SEED, prb)
        losses.append(loss)
        params = {k: v - PRB_LR[k] * grads[k] * mask[k]
                  for k, v in params.items()}
        print(f"[prb] step {step}: loss {loss:.6g}, red albedo "
              f"{params['mat_params'][PRB_ROWS[0], 0:3].tolist()}, light "
              f"{params['em_radiance'][0].tolist()}", flush=True)
    with torch.no_grad():
        final = loss_of(render_fn(scene._replace(**params), cam, film, prb,
                                  PRB_SPP, PRB_SEED, device=dev)[0]).item()
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    launches = dict(trace.LAUNCHES)
    losses.append(final)
    want = (3 * PRB_STEPS + 1) * PRB_SPP * MAX_DEPTH
    print(f"[prb] {PRB_STEPS} steps of {PRB_SPP} spp at {res}², "
          f"{MAX_DEPTH} bounces: {train_wall:.3f} s, losses {losses}, trace "
          f"launches {launches} ({card})", flush=True)
    check(all(np.isfinite(losses)), f"loss not finite: {losses}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"the loss does not fall at every step: {losses}")
    check(losses[-1] < 0.5 * losses[0], f"the loss did not halve: {losses}")
    for key, n in launches.items():
        check(n == want, f"{key}: {n} launches over the descent, want {want}")

    # ---- one step at the final values, by route --------------------------
    seed = PRB_SEED + 1
    runs = {}
    for label, fn in (
            ("prb", lambda: prb_step(params, seed, prb)),
            ("prb plain", lambda: prb_step(
                params, seed, PRBPathTracer(max_depth=MAX_DEPTH,
                                            accel="plain"))),
            ("prb fused", lambda: prb_step(
                params, seed, PRBPathTracer(max_depth=MAX_DEPTH,
                                            fused_shade="on"))),
            ("naive", lambda: naive_step(params, seed)),
            ("forward", lambda: render_fn(
                scene._replace(**params), cam, film,
                PathTracer(max_depth=MAX_DEPTH), PRB_SPP, seed,
                device=dev))):
        trace.reset_launches()
        if label == "forward":
            with torch.no_grad():
                ms, wall, peak, base, out = peak_run(fn)
        else:
            ms, wall, peak, base, out = peak_run(fn)
        runs[label] = {"ms": ms, "wall_s": wall, "peak_mib": peak,
                       "base_mib": base, "launches": dict(trace.LAUNCHES),
                       "out": out}
        print(f"[prb] {label} step ({PRB_SPP} spp): wall {wall:.4f} s, "
              f"{ms:.3f} ms by CUDA events, max_memory_allocated "
              f"{peak:.1f} MiB ({base:.1f} MiB before), trace launches "
              f"{runs[label]['launches']} ({card})", flush=True)
    _, g, Ls = runs["prb"]["out"]
    _, g_plain, Ls_plain = runs["prb plain"]["out"]
    _, _, Ls_fused = runs["prb fused"]["out"]
    check(all(torch.equal(a, b) for a, b in zip(Ls, Ls_plain)),
          "PRB's L through the trace kernel differs from accel='plain'")
    for k in g:
        scale = g_plain[k].abs().max().item()
        err = (g[k] - g_plain[k]).abs().max().item()
        print(f"[prb] {k}: kernel vs plain max |Δg| {err:.3g} (max |g| "
              f"{scale:.4g})", flush=True)
        check(torch.isfinite(g[k]).all().item() and err <= 1e-5 * scale,
              f"{k}: PRB gradients through the kernel vs plain {err}")

    # PRB against naive autograd (tests/test_prb.py:61-69's rule): the
    # same estimator but for roulette, which PRB holds detached and naive
    # autograd differentiates (1/q, q from the albedo-weighted
    # throughput); so the rule holds on every entry without roulette
    # (rr_depth past the depth) and on the radiance with it
    no_rr = MAX_DEPTH + 1
    _, g_nr, _ = prb_step(params, seed, PRBPathTracer(max_depth=MAX_DEPTH,
                                                      rr_depth=no_rr))
    _, g_naive_nr = naive_step(params, seed, no_rr)
    for label, ga, gb, keys in (
            ("roulette", g, runs["naive"]["out"][1], ("em_radiance",)),
            ("no roulette", g_nr, g_naive_nr, tuple(g))):
        for k in g:
            g_ad = gb[k]
            atol = 2e-4 * max(g_ad.abs().max().item(), 1.0)
            bad = ((ga[k] - g_ad).abs() > atol + 2e-2 * g_ad.abs()).sum()
            print(f"[prb] {k}, {label}: PRB vs naive max |Δg| "
                  f"{(ga[k] - g_ad).abs().max().item():.3g} (max |g| "
                  f"{g_ad.abs().max().item():.4g}), entries off "
                  f"test_prb's rule {bad.item()}", flush=True)
            check(torch.isfinite(g_ad).all().item(),
                  f"{k}, {label}: naive gradient not finite")
            if k in keys:
                check(bad.item() == 0, f"{k}, {label}: PRB vs naive "
                      f"autograd, {bad.item()} entries off the rule")
    fused = torch.cat(Ls_fused)
    eager = torch.cat(Ls)
    rel = ((fused - eager).abs().amax(-1)
           / eager.abs().amax(-1).clamp(min=1e-3))
    exact = (fused == eager).all(-1).float().mean().item()
    print(f"[prb] forward, fused_shade on vs off: {exact:.5f} of lanes bit "
          f"for bit, max rel {rel.max().item():.3g}, lanes off rel 1e-5: "
          f"{(rel > 1e-5).float().mean().item():.5f}", flush=True)
    check((rel > 1e-5).float().mean().item() <= 1e-3,
          "PRB forward, fused_shade on vs off")
    for entry in kernels[:2]:
        name = entry["name"]
        entry["prb"] = {"descent_launches": launches[name], **{
            label: {"launches": runs[label]["launches"][name],
                    "step_ms": runs[label]["ms"],
                    "peak_mib": runs[label]["peak_mib"]}
            for label in ("prb", "naive", "forward")}}
    print(f"[prb] phase {time.perf_counter() - t_start:.1f} s", flush=True)


def dist_phase(card, kernels, scene, cam):
    """Phase 25: the sharded paths of mitsuba_tpu_torch/parallel, ranks
    spawned (parallel/dist.py launch) after phase 1 built the libraries,
    over a file:// rendezvous, each rank running
    parallel/dryrun.py::cornell_cases. (a) gloo at DIST_WORLDS ranks, every
    rank on this card: render_sharded (DIST_RENDER) bit for bit equal to
    the single-process render_fn image (`scene`, `cam`: phase 2's); (b) at
    2 ranks render_grad_sharded (DIST_GRAD) against one process's
    loss.backward(): the loss bit for bit, the gradients within
    DIST_GRAD_REL · max |g|; (c) render_persistent_sharded (DIST_PERSIST)
    at DIST_WORLDS ranks bit for bit equal to render_persistent, n_rays
    too; (d) dryrun_multichip(DIST_DRYRUN) on the card (gloo), its loss
    within DIST_DRYRUN_REL of the same forward on CPU tensors; (e) NCCL
    with one rank a card at torch.cuda.device_count() ranks, (a) and (c)
    again, with each rank's wall time of (c) as a first scaling reading
    where there are two cards or more. Every rank's trace and megakernel
    launches are counted and required; no rank may hold JAX or the JAX
    package. Ranks that share a card give no scaling figure. Adds a
    "dist" object to the trace kernel's and mega_persistent's entries of
    `kernels`."""
    from mitsuba_tpu_torch.film.film import Film
    from mitsuba_tpu_torch.integrator.mega import (MegaPathTracer,
                                                   render_persistent)
    from mitsuba_tpu_torch.integrator.path import PathTracer
    from mitsuba_tpu_torch.parallel.dist import launch
    from mitsuba_tpu_torch.parallel.dryrun import (
        DRYRUN_CLUSTER_SIZE, DRYRUN_DEPTH, DRYRUN_RES, cornell_cases,
        dryrun_multichip)
    from mitsuba_tpu_torch.render import render_fn
    from mitsuba_tpu_torch.scene.builder import compile_scene
    from mitsuba_tpu_torch.scene.presets import cornell_box, cornell_camera
    t_start = time.perf_counter()
    _, res, depth, spp, seed = DIST_RENDER
    with torch.no_grad():
        ref_img = render_fn(scene, cam, Film(res, res), PathTracer(
            max_depth=depth), spp, seed, device=DEV)[0]
    _, res_p, depth_p, spp_p, seed_p = DIST_PERSIST
    integ = MegaPathTracer.for_scene(scene, max_depth=depth_p)
    ref_p, ref_n = render_persistent(integ, cornell_camera(res_p, res_p),
                                     spp_p, seed_p)
    ref_p, ref_n = ref_p.cpu().numpy(), int(ref_n)
    _, res_g, depth_g, spp_g, seed_g = DIST_GRAD
    leaves = {k: getattr(scene, k).clone().requires_grad_()
              for k in ("mat_params", "em_radiance")}
    loss = render_fn(scene._replace(**leaves), cornell_camera(res_g, res_g),
                     Film(res_g, res_g), PathTracer(max_depth=depth_g),
                     spp_g, seed_g, device=DEV)[0].mean()
    loss.backward()
    ref_loss = loss.item()
    ref_g = {k: v.grad.cpu().numpy() for k, v in leaves.items()}
    ref_img = ref_img.cpu().numpy()
    want = {"trace_closest": depth * spp, "trace_any": depth * spp}
    dist_row = {}

    def run(label, world, cases, backend):
        t0 = time.perf_counter()
        outs = launch(cornell_cases, world, cases, device="cuda",
                      backend=backend, timeout=600)
        print(f"[dist] {label}: {world} ranks, {backend}, "
              f"{time.perf_counter() - t0:.1f} s with the spawn", flush=True)
        for r, out in enumerate(outs):
            check(out["imported"] == [],
                  f"{label} rank {r} imported {out['imported']}")
        return outs

    def check_render(label, outs, i):
        for r, out in enumerate(outs):
            img, n = out["results"][i], out["launches"][i]
            same = np.array_equal(img, ref_img)
            print(f"[dist] {label} rank {r}: render_sharded {res}², {spp} "
                  f"spp bit-equal to render_fn: {same} (max |Δ| "
                  f"{np.abs(img - ref_img).max():.3g}), launches {n}",
                  flush=True)
            check(same, f"{label} rank {r}: render_sharded differs")
            for k, v in want.items():
                check(n[k] == v, f"{label} rank {r}: {k} {n[k]}, want {v}")
        return [o["launches"][i] for o in outs]

    def check_persistent(label, outs, i):
        for r, out in enumerate(outs):
            (img, n), launched = out["results"][i], out["launches"][i]
            same = np.array_equal(img, ref_p) and int(n) == ref_n
            print(f"[dist] {label} rank {r}: render_persistent_sharded "
                  f"{res_p}², {spp_p} spp bit-equal to render_persistent: "
                  f"{same}, n_rays {int(n)} ({ref_n}), mega_persistent "
                  f"launches {launched['mega_persistent']}, wall "
                  f"{out['wall_s'][i]:.4f} s", flush=True)
            check(same, f"{label} rank {r}: render_persistent_sharded "
                  "differs")
            check(launched["mega_persistent"] == 1,
                  f"{label} rank {r}: mega_persistent not launched once")
        return [o["launches"][i]["mega_persistent"] for o in outs]

    # (a), (b), (c): gloo, every rank on this card
    for world in DIST_WORLDS:
        cases = [DIST_RENDER, DIST_PERSIST] + ([DIST_GRAD] if world == 2
                                               else [])
        label = f"gloo x{world} (one card)"
        outs = run(label, world, cases, "gloo")
        dist_row[f"gloo_{world}"] = {
            "render_launches": check_render(label, outs, 0),
            "persistent_launches": check_persistent(label, outs, 1)}
        if world == 2:
            for r, out in enumerate(outs):
                loss_r, g = out["results"][2]
                check(float(loss_r) == ref_loss, f"{label} rank {r}: loss "
                      f"{float(loss_r)} vs one process's {ref_loss}")
                for k, ref in ref_g.items():
                    err = float(np.abs(g[k] - ref).max())
                    scale = float(np.abs(ref).max())
                    print(f"[dist] {label} rank {r}: render_grad_sharded "
                          f"{res_g}², {spp_g} spp, loss {float(loss_r):.8g} "
                          f"(one process {ref_loss:.8g}), {k} max |Δg| "
                          f"{err:.3g} of max |g| {scale:.4g}", flush=True)
                    check(np.isfinite(g[k]).all() and scale > 0
                          and err <= DIST_GRAD_REL * scale,
                          f"{label} rank {r}: {k} gradients differ")
    # (d) the dry run on the card, its loss against the CPU forward
    loss_d, gnorm_d, _ = dryrun_multichip(DIST_DRYRUN, device="cuda",
                                          backend="gloo")
    cpu = compile_scene(cornell_box(), cluster_size=DRYRUN_CLUSTER_SIZE,
                        device="cpu")
    with torch.no_grad():
        cpu_loss = render_fn(cpu, cornell_camera(DRYRUN_RES, DRYRUN_RES),
                             Film(DRYRUN_RES, DRYRUN_RES),
                             PathTracer(max_depth=DRYRUN_DEPTH), 1, 0,
                             device="cpu")[0].mean().item()
    print(f"[dist] dryrun_multichip({DIST_DRYRUN}) on the card: loss "
          f"{loss_d:.8g}, CPU forward {cpu_loss:.8g}, grad_norm "
          f"{gnorm_d:.8g}", flush=True)
    check(abs(loss_d - cpu_loss) <= DIST_DRYRUN_REL * abs(cpu_loss),
          "dry run loss vs the CPU forward")
    # (e) NCCL, one rank a card
    cards = torch.cuda.device_count()
    label = f"nccl x{cards}"
    outs = run(label, cards, [DIST_RENDER, DIST_PERSIST], "nccl")
    dist_row["nccl"] = {"ranks": cards,
                        "render_launches": check_render(label, outs, 0),
                        "persistent_launches": check_persistent(label, outs,
                                                                1)}
    if cards == 1:
        print("[dist] nccl: one card on this machine, so world 1 (no "
              "scaling reading)", flush=True)
    else:
        walls = [o["wall_s"][1] for o in outs]
        dist_row["nccl"]["persistent_wall_s"] = walls
        print(f"[dist] nccl x{cards}: render_persistent_sharded wall s by "
              f"rank {walls}: a first scaling reading ({card})", flush=True)
    for entry in kernels:
        if entry["name"] in ("trace_closest", "trace_any"):
            entry["dist"] = {k: [n[entry["name"]] for n in v[
                "render_launches"]] for k, v in dist_row.items()}
        elif entry["name"] == "mega_persistent":
            entry["dist"] = {k: v["persistent_launches"]
                             for k, v in dist_row.items()}
    print(f"[dist] phase 25: {time.perf_counter() - t_start:.1f} s",
          flush=True)


@contextlib.contextmanager
def wavefront_turn(tracer, label):
    """Phase 26's tracer for a turn: "on" the defaults, "no gate"
    gate_depth 0, "off" with integrator/path.py's compaction threshold
    out of reach (so no sort and no gate either)."""
    from mitsuba_tpu_torch.integrator import path as tpath
    if label == "no gate":
        yield dataclasses.replace(tracer, gate_depth=0)
        return
    saved = tpath.COMPACT_MIN_TRIS
    if label == "off":
        tpath.COMPACT_MIN_TRIS = 1 << 62
    try:
        yield tracer
    finally:
        tpath.COMPACT_MIN_TRIS = saved


def compaction_phase(card, kernels):
    """Phase 26: PathTracer's wavefront machinery on the leaf-families
    and four-material scenes (COMPACT_SCENES), eager at CORNELL_RES² with
    the trace kernel, SHADE_DEPTH bounces, fused_shade off: each turn of
    COMPACT_TURNS renders the same seed, its trace launches counted;
    every image is bit for bit the first and every ray count equal;
    rays/s by turn; per bounce of one 1-spp pass with the defaults, the
    live lanes and the gate's prefix. Adds a "compaction" object to the
    trace kernel's entries of `kernels`."""
    from mitsuba_tpu_torch.accel import trace
    from mitsuba_tpu_torch.film.film import Film
    from mitsuba_tpu_torch.integrator import path as tpath
    from mitsuba_tpu_torch.integrator.path import PathTracer
    from mitsuba_tpu_torch.render import render_fn
    t_start = time.perf_counter()
    res, depth = CORNELL_RES, SHADE_DEPTH
    film = Film(res, res, "box")
    tracer = PathTracer(max_depth=depth)
    rows = {}
    for name, spp in COMPACT_SCENES:
        scene, cam = {"leaf": leaf_scene,
                      "four_material": four_materials}[name](res)
        plan = tracer.wavefront(scene, res * res)
        print(f"[compaction] {name}: {scene.n_real_tris} triangles, "
              f"{scene.woop_clusters.shape[0]} clusters, {res * res} lanes: "
              f"compact {plan[0]}, sort {plan[1]}, gate widths {plan[2]}",
              flush=True)
        check(plan[0] and plan[1] and len(plan[2]) > 1,
              f"{name}: the machinery is not on by default")
        # the live lanes and the gate's prefix by bounce (untimed)
        seen, width = [], tpath.gate_width

        def spy(gates, active):
            w = width(gates, active)
            seen.append((int((active > 0.5).sum()), w))
            return w
        tpath.gate_width = spy
        try:
            with torch.no_grad():
                render_fn(scene, cam, film, tracer, 1, 0, device=DEV)
        finally:
            tpath.gate_width = width
        for b, (live, w) in enumerate(seen):
            print(f"[compaction] {name} bounce {b}: {live} live lanes of "
                  f"{res * res}, prefix {w}", flush=True)
        for label in ("on", "off"):                         # (warm-up)
            with wavefront_turn(tracer, label) as t, torch.no_grad():
                render_fn(scene, cam, film, t, 1, 0, device=DEV)
        turns, ref = [], None
        for label in COMPACT_TURNS:
            with wavefront_turn(tracer, label) as t, torch.no_grad():
                torch.cuda.synchronize()
                trace.reset_launches()
                t0 = time.perf_counter()
                img, n = render_fn(scene, cam, film, t, spp, 0, device=DEV)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches, n = dict(trace.LAUNCHES), int(n)
            ref = ref or (img, n)
            same = torch.equal(img, ref[0]) and n == ref[1]
            turns.append({"turn": label, "wall_s": wall,
                          "rays_per_s": n / wall, "launches": launches})
            print(f"[compaction] {name} {label}: {res}², {spp} spp, "
                  f"{wall:.3f} s, {n} rays, {n / wall:.6g} rays/s, launches "
                  f"{launches}, bit-equal to the first turn: {same} "
                  f"({card})", flush=True)
            check(same, f"{name} {label}: image or ray count differs")
            for k, v in launches.items():
                check(v == depth * spp, f"{name} {label}: {k} {v}, want "
                      f"{depth * spp}")
        mean = {label: float(np.mean([t["rays_per_s"] for t in turns
                                      if t["turn"] == label]))
                for label in dict.fromkeys(COMPACT_TURNS)}
        print(f"[compaction] {name}: mean rays/s by setting {mean}, on/off "
              f"{mean['on'] / mean['off']:.4f} ({card})", flush=True)
        rows[name] = {"spp": spp, "live_by_bounce": [x[0] for x in seen],
                      "prefix_by_bounce": [x[1] for x in seen],
                      "rays_per_s": mean,
                      "launches_on": turns[1]["launches"]}
    for entry in kernels[:2]:
        entry["compaction"] = {
            name: {**{k: v for k, v in row.items() if k != "launches_on"},
                   "launches": row["launches_on"][entry["name"]]}
            for name, row in rows.items()}
    print(f"[compaction] phase 26: {time.perf_counter() - t_start:.1f} s",
          flush=True)


def cli_phase(card, kernels):
    """Phase 27: the command-line renderer, cli.run in-process on each of
    CLI_SCENES (the launches of each run counted from 0), every EXR read
    back, the megakernel-route scenes at CLI_CHECK_SPP against render_fn
    of the same LoadedScene, and one `python3 -m mitsuba_tpu_torch`
    process with no --device. Adds a "cli" object (launches by scene) to
    the trace kernel's and mega_persistent's entries of `kernels`."""
    import tempfile

    from mitsuba_tpu_torch import cli
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.accel import trace
    from mitsuba_tpu_torch.io.image import read_exr, write_exr
    from mitsuba_tpu_torch.render import render_fn
    from mitsuba_tpu_torch.scene.xml import load_xml
    t_start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    scene_path = lambda name: os.path.join(root, "scenes", name)
    names = ("trace_closest", "trace_any", "mega_persistent")
    launches, results = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) each scene file as written; (b) its EXR read back
        for name in CLI_SCENES:
            out = os.path.join(tmp, name.replace(".xml", ".exr"))
            extra = ["-s", str(CLI_CORNELL_SPP)] \
                if name == "cornell.xml" else []
            torch.cuda.synchronize()
            trace.reset_launches()
            mk.reset_launches()
            t0 = time.perf_counter()
            (res,) = cli.run([scene_path(name), "-o", out, "-q", *extra])
            wall = time.perf_counter() - t0
            counts = {**trace.LAUNCHES, **mk.LAUNCHES}
            launches[name] = {k: counts[k] for k in names}
            results[name] = res
            h, w = res.image.shape[:2]
            print(f"[cli] {name}: {w}x{h}, {res.spp} spp, route "
                  f"{res.route}{' (megakernel refused: ' + res.refused + ')' if res.refused else ''}"
                  f", launches {launches[name]}, {res.n_rays} rays, render "
                  f"{res.render_s:.3f} s, wall {wall:.3f} s (load, compile, "
                  f"render, write), {res.n_rays / res.render_s:.6g} rays/s "
                  f"({card})", flush=True)
            check(res.device == "cuda", f"{name}: rendered on {res.device}")
            check(np.isfinite(res.image).all(), f"{name}: NaN/Inf")
            check(0.0 < float(res.image.mean()) < 10.0,
                  f"{name}: image mean {res.image.mean()}")
            if res.route == "megakernel":
                check(launches[name]["mega_persistent"] == 1
                      and launches[name]["trace_closest"] == 0,
                      f"{name}: megakernel route launches {launches[name]}")
            else:
                check(launches[name]["trace_closest"] > 0
                      and launches[name]["mega_persistent"] == 0,
                      f"{name}: eager route launches {launches[name]}")
            back = read_exr(out)
            want = res.image if res.film.component_format != "float16" \
                else res.image.astype(np.float16).astype(np.float32)
            check(back.shape == want.shape and np.array_equal(back, want),
                  f"{name}: the EXR does not read back as the image")
        routes = {r.route for r in results.values()}
        check(routes == {"megakernel", "eager"},
              f"phase 27 took the routes {routes}, want both")
        half = os.path.join(tmp, "half.exr")
        img = results[CLI_SCENES[-1]].image
        write_exr(half, img, compression="zips", pixel_type="half")
        check(np.array_equal(read_exr(half),
                             img.astype(np.float16).astype(np.float32)),
              "half EXR does not read back to float16 rounding")
        print(f"[cli] every EXR reads back equal to its image (float32 bit "
              f"for bit, half to float16 rounding)", flush=True)

        # (c) the megakernel route against the eager path, same streams
        for name, res in results.items():
            if res.route != "megakernel":
                continue
            (r16,) = cli.run([scene_path(name), "-o",
                              os.path.join(tmp, "check.exr"), "-q", "-s",
                              str(CLI_CHECK_SPP)])
            check(r16.route == "megakernel", f"{name}: route {r16.route}")
            loaded = load_xml(scene_path(name))
            scene = loaded.compile(device=DEV)
            trace.reset_launches()
            eager, _ = render_fn(scene, loaded.camera, loaded.film,
                                 loaded.make_integrator(), CLI_CHECK_SPP, 0,
                                 device=DEV)
            check(trace.LAUNCHES["trace_closest"] > 0,
                  f"{name}: the eager render launched no trace kernel")
            image_rule(torch.as_tensor(r16.image), eager.cpu(),
                       f"cli {name} megakernel vs eager, {CLI_CHECK_SPP} "
                       "spp")

        # (d) the command a user types, no --device
        sub = os.path.join(tmp, "sub.exr")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mitsuba_tpu_torch",
             os.path.join("scenes", "checker.xml"), "-o", sub, "-q"],
            cwd=root, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        route = [line for line in proc.stderr.splitlines()
                 if "Route:" in line]
        print(f"[cli] python3 -m mitsuba_tpu_torch scenes/checker.xml: exit "
              f"{proc.returncode}, {wall:.1f} s, {route}", flush=True)
        check(proc.returncode == 0, f"the CLI process failed:\n"
                                    f"{proc.stderr[-4000:]}")
        check(os.path.exists(sub), "the CLI process wrote no image")
        check(len(route) == 1 and "Route: megakernel" in route[0]
              and route[0].endswith("on cuda"),
              f"the CLI process took the route {route}")
    for entry in kernels:
        if entry["name"] in names:
            entry["cli"] = {name: counts[entry["name"]]
                            for name, counts in launches.items()}
    print(f"[cli] phase 27: {time.perf_counter() - t_start:.1f} s",
          flush=True)


def lod_desc(builder, tf, shapes, texture):
    """tests/test_footprint.py's minified checkerboard over either
    package's modules: a 512² bitmap of 256² tiles on an 8×8 diffuse quad
    under an area light."""
    d = builder.SceneDesc()
    tid = d.add_texture(texture.checkerboard((1, 1, 1), (0, 0, 0), res=512,
                                             tiles=256))
    m = d.add_material(kind="diffuse", albedo_texture=tid)
    d.add_shape(shapes.rectangle(), to_world=tf.scale(4.0), material=m)
    d.add_shape(shapes.rectangle(),
                to_world=tf.translate([0, 0, 6]) @ tf.rotate(
                    [1, 0, 0], 180) @ tf.scale(8.0),
                material=0, radiance=(6.0, 6.0, 6.0))
    return d


def cli_variants(root, tmp, sensors=LOD_CLI_SENSORS,
                 integrators=LOD_CLI_INTEGRATORS):
    """scenes/cornell.xml written to `tmp` once for each sensor of
    `sensors` (a meter moved into the box, METER_LOOKAT) and each
    integrator of `integrators` (the file itself is not touched): {name:
    (path, -s)}."""
    with open(os.path.join(root, "scenes", "cornell.xml")) as f:
        text = f.read()
    check(all(line in text for line in (CORNELL_PATH, CORNELL_SENSOR,
                                        CORNELL_LOOKAT)),
          "scenes/cornell.xml no longer holds the lines phase 28 swaps")
    out = {}
    for kind, props in sensors.items():
        doc = text.replace(CORNELL_SENSOR, f'<sensor type="{kind}">{props}')
        # a meter looks at the back wall from inside the box
        out[kind] = doc.replace(CORNELL_LOOKAT, METER_LOOKAT) \
            if kind.endswith("meter") else doc
    for kind, xml in integrators.items():
        out[kind] = text.replace(CORNELL_PATH, xml)
    paths = {}
    for name, doc in out.items():
        path = os.path.join(tmp, f"cornell_{name}.xml")
        with open(path, "w") as f:
            f.write(doc)
        paths[name] = (path, LOD_CLI_ADAPTIVE_SPP if name == "adaptive"
                       else LOD_CLI_SPP)
    return paths


def lod_phase(card, kernels):
    """Phase 28: (a) LoDPathTracer.render_lod on texenv at CORNELL_RES²,
    TEXENV_DEPTH, LOD_SPP, fused "on" (rays/s and launches, beside the
    level-0 render of the same rays), the trace kernel on the footprint's
    rays and the shade kernel on bounce 0's LoD-resolved rows against
    their plain versions, the card's render_lod (fused on and off)
    against the CPU's at TEXENV_CPU_RES² under the image rule, and the
    prefiltering's lower pixel-to-pixel std on the minified checker; (b)
    FootprintIntegrator on texenv at CORNELL_RES², card against CPU; (c)
    scenes/cornell.xml with each new sensor and integrator through
    cli.run, every EXR read back. Adds a "lod" object (launches by run,
    the shade kernel's time on the LoD rows) to the trace and shade
    kernels' entries of `kernels`."""
    import tempfile

    from mitsuba_tpu_torch import cli
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.accel import shade_kernel as sk
    from mitsuba_tpu_torch.accel import trace
    from mitsuba_tpu_torch.core import rng
    from mitsuba_tpu_torch.core import transform as tf
    from mitsuba_tpu_torch.film.film import Film
    from mitsuba_tpu_torch.integrator.common import DIM_PIXEL, ray_mint
    from mitsuba_tpu_torch.integrator.footprint import (FootprintIntegrator,
                                                        LoDPathTracer,
                                                        first_hit_footprint,
                                                        footprint_extent)
    from mitsuba_tpu_torch.integrator.path import PathTracer, initial_state
    from mitsuba_tpu_torch.io.image import read_exr, read_exr_channel_names
    from mitsuba_tpu_torch.render import render_fn
    from mitsuba_tpu_torch.scene import builder, shapes
    from mitsuba_tpu_torch.sensor.sensor import PerspectiveCamera
    from mitsuba_tpu_torch.texture import texture

    t_start = time.perf_counter()
    names = ("trace_closest", "trace_any", "shade")
    out = {n: {} for n in names}

    def reset():
        torch.cuda.synchronize()
        trace.reset_launches()
        sk.reset_launches()

    def counted():
        torch.cuda.synchronize()
        return {k: {**trace.LAUNCHES, **sk.LAUNCHES}[k] for k in names}

    def record(run, launches):
        for k in names:
            out[k].setdefault("launches", {})[run] = launches[k]

    # ---- 28 (a). the kernels against their plain versions on this path ---
    res, depth = CORNELL_RES, TEXENV_DEPTH
    scene, cam, _ = tex_scene("texenv", res, DEV)
    film = Film(res, res, "box")
    pix = torch.arange(res * res, dtype=torch.int32, device=DEV)
    samp = torch.zeros_like(pix)
    centres = torch.stack([(pix % res).float() + 0.5,
                           (pix // res).float() + 0.5], -1)
    errs = {"trace_closest": 0.0, "trace_any": 0.0}
    o, d = cam.sample_ray(centres)
    rays = (o, d, ray_mint(o), torch.full_like(o[:, 0], 1e30), None)
    compare("lod footprint rays", scene, *rays, errs)
    out["trace_closest"]["b0"] = measure(
        "trace_closest, texenv footprint rays", False, scene, rays, 2, card)
    _, dx, dy = first_hit_footprint(scene, cam, centres)
    ext = footprint_extent(dx, dy)
    tracer = LoDPathTracer(max_depth=depth, fused_shade="on") \
        .specialized_for(scene)
    jit = rng.sample_2d(0, pix, DIM_PIXEL, 0)
    st = initial_state(*cam.sample_ray(torch.stack(
        [(pix % res).float() + jit[:, 0], (pix // res).float() + jit[:, 1]],
        -1)))
    packed = tracer.shade_inputs(scene, st, 0, pix, samp, 0, tex_lod=ext)
    level0 = tracer.shade_inputs(scene, st, 0, pix, samp, 0)
    check(not torch.equal(packed, level0),
          "the footprints did not change bounce 0's material rows")
    run = lambda: sk.run_shade(scene, packed, pix, samp, 0, 0,
                               tracer.rr_depth, depth)
    plain_fn = lambda: sk.shade_plain(scene, packed, pix, samp, 0, 0,
                                      tracer.rr_depth, depth)
    out["shade"]["max_abs_err"] = compare_exact(
        "lod shade, bounce 0 LoD rows", run(), plain_fn())
    out["shade"]["b0"] = {
        "ms": time_ms(run, 20), "plain_ms": time_ms(plain_fn, 2, warmup=1),
        **shade_bound("lod shade, bounce 0", scene, packed, 0,
                      tracer.rr_depth, family_ops(mk.build_mega_tables(
                          scene)), card, depth)}
    for k in ("trace_closest", "trace_any"):
        out[k]["max_abs_err"] = errs[k]

    # ---- 28 (a). render_lod at full width, fused on (counted) ------------
    lod = LoDPathTracer(max_depth=depth, fused_shade="on")
    lod.render_lod(scene, cam, film, 1, 0, device=DEV)      # (warm-up)
    reset()
    t0 = time.perf_counter()
    img_lod, n_lod = lod.render_lod_stats(scene, cam, film, LOD_SPP, 0,
                                          device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counted()
    record("render_lod", launches)
    n_lod = int(n_lod)
    print(f"[lod] texenv render_lod {res}², {depth} bounces, {LOD_SPP} spp, "
          f"fused on: {wall:.3f} s, {n_lod} rays, {n_lod / wall:.6g} rays/s,"
          f" mean {img_lod.mean().item():.5f}, launches {launches} ({card})",
          flush=True)
    check(bool(torch.isfinite(img_lod).all()), "render_lod: NaN/Inf")
    check(launches == {"trace_closest": depth * LOD_SPP + 1, "trace_any": 0,
                       "shade": depth * LOD_SPP},
          f"render_lod launches {launches}")
    img_0, n_0, _ = eager_rate(
        "lod texenv level 0 (render_fn, the same rays)", scene, cam, film,
        PathTracer(max_depth=depth, fused_shade="on"), card, spp=LOD_SPP,
        traced=("trace_closest", "shade"), profile=False)
    its = first_hit_footprint(scene, cam, centres)[0]
    floor = (its.mat_id == 0).reshape(res, res)
    std = lambda img: img.mean(-1)[floor].std().item()
    print(f"[lod] texenv floor ({int(floor.sum())} pixels): std LoD "
          f"{std(img_lod):.5f}, level 0 {std(img_0):.5f}; image means "
          f"{img_lod.mean().item():.5f} / {img_0.mean().item():.5f}; "
          f"render_lod / level-0 rays/s {n_lod / wall:.6g} vs the line "
          f"above", flush=True)

    # ---- 28 (a). the card against CPU tensors, fused on and off -----------
    small = Film(TEXENV_CPU_RES, TEXENV_CPU_RES, "box")
    cpu_scene, cpu_cam, _ = tex_scene("texenv", TEXENV_CPU_RES, "cpu")
    img_c, n_c = LoDPathTracer(max_depth=depth).render_lod_stats(
        cpu_scene, cpu_cam, small, TEXENV_CPU_SPP, 0, device="cpu")
    for mode in ("off", "on"):
        reset()
        img_k, n_k = LoDPathTracer(max_depth=depth, fused_shade=mode) \
            .render_lod_stats(scene, cpu_cam, small, TEXENV_CPU_SPP, 0,
                              device=DEV)
        launches = counted()
        record(f"render_lod {TEXENV_CPU_RES}² fused {mode}", launches)
        print(f"[lod cpu] {TEXENV_CPU_RES}², {TEXENV_CPU_SPP} spp, fused "
              f"{mode}: card {int(n_k)} rays, CPU {int(n_c)}, launches "
              f"{launches}", flush=True)
        check(launches["trace_closest"] > 0 and (
            launches["shade"] > 0 if mode == "on"
            else launches["trace_any"] > 0),
              f"render_lod fused {mode}: launches {launches}")
        image_rule(img_k.cpu(), img_c, f"lod card fused {mode} vs CPU")
        check(abs(int(n_k) - int(n_c)) <= 1e-4 * int(n_c),
              f"render_lod rays {int(n_k)} vs {int(n_c)}")

    # ---- 28 (a). prefiltering lowers the minified checker's std -----------
    cres, cspp, cdepth = LOD_CHECKER
    chk = builder.compile_scene(lod_desc(builder, tf, shapes, texture),
                                cluster_size=128, device=DEV)
    ccam = PerspectiveCamera(cres, cres, 45.0, tf.look_at(
        [0, 0, 5.0], [0, 0, 0], [0, 1, 0]))
    cfilm = Film(cres, cres, "box")
    img_f = LoDPathTracer(max_depth=cdepth).render_lod(chk, ccam, cfilm,
                                                       cspp, 0, device=DEV)
    img_c0 = render_fn(chk, ccam, cfilm, LoDPathTracer(max_depth=cdepth),
                       cspp, 0, device=DEV)[0]
    inner = slice(cres // 4, 3 * cres // 4)
    sf, s0 = (i[inner, inner, 0].std().item() for i in (img_f, img_c0))
    mf, m0 = (i[inner, inner, 0].mean().item() for i in (img_f, img_c0))
    print(f"[lod] minified checker {cres}², {cspp} spp: std LoD {sf:.5f}, "
          f"level 0 {s0:.5f}; means {mf:.5f} / {m0:.5f}", flush=True)
    check(sf < 0.6 * s0, f"LoD std {sf} not below 0.6 x level 0's {s0}")
    check(abs(mf - m0) < 0.15 * m0, f"LoD mean {mf} vs level 0's {m0}")

    # ---- 28 (b). the footprint AOV, card against CPU ----------------------
    reset()
    t0 = time.perf_counter()
    fp_k = FootprintIntegrator().render(scene, cam, film, device=DEV)
    torch.cuda.synchronize()
    fp_wall = time.perf_counter() - t0
    launches = counted()
    record("footprint", launches)
    fp_c = FootprintIntegrator().render(cpu_scene, cam, film, device="cpu")
    fp_k = fp_k.cpu()
    diff = (fp_k - fp_c).abs() / fp_c.abs().clamp(min=1.0)
    frac = (diff > LOD_FP_TOL).float().mean().item()
    print(f"[footprint] texenv {res}²: {fp_wall:.3f} s, launches {launches},"
          f" AOV mean {fp_k.mean().item():.5f} (CPU "
          f"{fp_c.mean().item():.5f}), same misses "
          f"{torch.equal(fp_k == 0, fp_c == 0)}, share off by more than "
          f"{LOD_FP_TOL} {frac:.6f}, max {diff.max().item():.3g}",
          flush=True)
    check(launches["trace_closest"] == 1, f"footprint launches {launches}")
    check(torch.equal(fp_k == 0, fp_c == 0), "footprint misses differ")
    check(frac <= 1e-3, f"footprint AOV: {frac} of values differ")

    # ---- 28 (c). cornell.xml under each new sensor and integrator ---------
    root = os.path.dirname(os.path.abspath(__file__))
    cli_s = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (path, spp) in cli_variants(root, tmp).items():
            exr = path.replace(".xml", ".exr")
            reset()
            mk.reset_launches()
            t0 = time.perf_counter()
            (res_c,) = cli.run([path, "-o", exr, "-q", "-s", str(spp)])
            wall = time.perf_counter() - t0
            cli_s[name] = wall
            launches = counted()
            record(f"cli {name}", launches)
            img = res_c.image
            rate = "" if res_c.n_rays is None else \
                f", {res_c.n_rays} rays, {res_c.n_rays / res_c.render_s:.6g}" \
                " rays/s"
            print(f"[lod cli] cornell {name}: {img.shape[1]}x{img.shape[0]}"
                  f"x{img.shape[2]}, {res_c.spp} spp, route {res_c.route} "
                  f"({res_c.refused}), launches {launches}, mega_persistent "
                  f"{mk.LAUNCHES['mega_persistent']}, render "
                  f"{res_c.render_s:.3f} s, wall {wall:.3f} s{rate} ({card})",
                  flush=True)
            check(res_c.route == "eager" and res_c.device == "cuda"
                  and mk.LAUNCHES["mega_persistent"] == 0,
                  f"{name}: route {res_c.route} on {res_c.device}")
            check(launches["trace_closest"] > 0,
                  f"{name}: no trace kernel launched")
            check(np.isfinite(img).all() and np.abs(img).sum() > 0,
                  f"{name}: image not finite or all zero")
            back = read_exr(exr)
            if res_c.channels is None:
                check(img.shape[2] == 3 and np.array_equal(back, img),
                      f"{name}: the EXR does not read back as the image")
                continue
            stored = read_exr_channel_names(exr)
            order = [res_c.channels.index(c) for c in stored]
            check(img.shape[2] in (6, 9)
                  and stored == sorted(res_c.channels)
                  and np.array_equal(back, img[..., order]),
                  f"{name}: the EXR's channels {stored} do not read back")
            print(f"[lod cli] {name}: channels {res_c.channels}", flush=True)
    print(f"[lod] phase 28 (c): {sum(cli_s.values()):.1f} s over "
          f"{len(cli_s)} scene files", flush=True)
    for entry in kernels:
        if entry["name"] in names:
            entry["lod"] = out[entry["name"]]
    print(f"[lod] phase 28: {time.perf_counter() - t_start:.1f} s",
          flush=True)


@contextlib.contextmanager
def recorded_traces(pick=LIGHT_PICK):
    """Inside the block every call of trace.intersect and trace.occluded
    goes through; call number `pick` of each (or the last, where there
    are fewer) is kept as (scene, o, d, mint, maxt, live) in
    got["closest"] and got["any"]."""
    from mitsuba_tpu_torch.accel import trace
    got, calls = {}, {"closest": 0, "any": 0}
    saved = trace.intersect, trace.occluded

    def keep(kind, args):
        if calls[kind] <= pick:
            got[kind] = args
        calls[kind] += 1

    def intersect(scene, o, d, mint, maxt, live=None):
        keep("closest", (scene, o, d, mint, maxt, live))
        return saved[0](scene, o, d, mint, maxt, live)

    def occluded(scene, o, d, mint, maxt, live=None):
        keep("any", (scene, o, d, mint, maxt, live))
        return saved[1](scene, o, d, mint, maxt, live)

    trace.intersect, trace.occluded = intersect, occluded
    try:
        yield got
    finally:
        trace.intersect, trace.occluded = saved


def light_phase(card, kernels, scene, cam):
    """Phase 29: the integrators whose subpaths start on the emitters, on
    the Cornell box at CORNELL_RES², MAX_DEPTH, each class's defaults:
    (a) ParticleTracer.render_stats with LIGHT_PARTICLES particles
    (launches, rays/s) against PathTracer at LIGHT_PATH_SPP (the means
    within 8%, the pixel means correlated above 0.8); (b) BDPT at
    LIGHT_BDPT_SPP, (c) VPLIntegrator and (d) LightcutsIntegrator at
    LIGHT_VPL_SPP, (e) PhotonMapper at LIGHT_PM_SPP and render_progressive
    at LIGHT_PPM, each through render_fn with its launches counted; (f)
    for each of them the trace kernel against accel/dense.py bit for bit
    on LIGHT_WAVE lanes of one of its own wavefronts (closest and any
    hit), timed beside its bound; (g) each on the card against CPU
    tensors at LIGHT_CPU_RES² with small settings (the image rule; the
    light tracer also pixel by pixel; the ray counts); (h)
    scenes/cornell.xml under bdpt, ptracer, vpl, photonmapper, ppm and
    sppm through cli.run, every EXR read back. Adds a "light_subpaths"
    object (launches by run, the wavefronts' times) to the trace
    kernel's entries of `kernels`."""
    import tempfile

    from mitsuba_tpu_torch import cli
    from mitsuba_tpu_torch.accel import megakernel as mk
    from mitsuba_tpu_torch.accel import trace
    from mitsuba_tpu_torch.film.film import Film
    from mitsuba_tpu_torch.integrator.bdpt import BDPT
    from mitsuba_tpu_torch.integrator.lightcuts import LightcutsIntegrator
    from mitsuba_tpu_torch.integrator.path import PathTracer
    from mitsuba_tpu_torch.integrator.photonmap import (PhotonMapper,
                                                        render_progressive)
    from mitsuba_tpu_torch.integrator.ptracer import ParticleTracer
    from mitsuba_tpu_torch.integrator.vpl import (CHUNK_LANES,
                                                  VPLIntegrator)
    from mitsuba_tpu_torch.io.image import read_exr
    from mitsuba_tpu_torch.render import render_fn
    from mitsuba_tpu_torch.scene.builder import compile_scene
    from mitsuba_tpu_torch.scene.presets import cornell_box, cornell_camera

    t_start = time.perf_counter()
    names = ("trace_closest", "trace_any")
    out = {n: {"launches": {}, "wavefronts": {}} for n in names}
    res, depth = CORNELL_RES, MAX_DEPTH
    film = Film(res, res, "box")
    errs = {n: 0.0 for n in names}

    def counted(label, run, want):
        """run() with the trace launches counted from 0 (its wall seconds
        and result), each wavefront of its kept; the launches must be
        `want`."""
        torch.cuda.synchronize()
        trace.reset_launches()
        with recorded_traces() as got:
            t0 = time.perf_counter()
            result = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {k: trace.LAUNCHES[k] for k in names}
        for k in names:
            out[k]["launches"][label] = launches[k]
        check(launches == want, f"{label}: launches {launches}, want {want}")
        for kind, key, any_hit in (("closest", "trace_closest", False),
                                   ("any", "trace_any", True)):
            sc, o, d, mint, maxt, live = got[kind]
            w = slice(0, LIGHT_WAVE)
            rays = (o[w], d[w], mint[w], maxt[w],
                    None if live is None else live[w])
            compare(f"light {label} {kind} wavefront", sc, *rays, errs)
            out[key]["wavefronts"][label] = measure(
                f"{key}, {label}'s wavefront", any_hit, sc, rays, 1, card)
        return wall, result

    def report(label, what, wall, img, n_rays):
        print(f"[light] {label} {what}: {wall:.3f} s, {n_rays} rays, "
              f"{n_rays / wall:.6g} rays/s, mean {img.mean().item():.5f}, "
              f"launches {out['trace_closest']['launches'][label]} closest"
              f", {out['trace_any']['launches'][label]} any ({card})",
              flush=True)
        check(bool(torch.isfinite(img).all()) and img.mean().item() > 0,
              f"{label}: image not finite or all zero")

    # ---- 29 (a). the light tracer against the path tracer ---------------
    lt = ParticleTracer(max_depth=depth)
    lt.render(scene, cam, 1 << 14, 1, device=DEV)              # (warm-up)
    wall, (img_lt, n_lt) = counted(
        "ptracer", lambda: lt.render_stats(scene, cam, LIGHT_PARTICLES, 0,
                                           device=DEV),
        {"trace_closest": depth - 1, "trace_any": depth})
    report("ptracer", f"{LIGHT_PARTICLES} particles", wall, img_lt,
           int(n_lt))
    img_pt = render_fn(scene, cam, film, PathTracer(max_depth=depth),
                       LIGHT_PATH_SPP, 0, device=DEV)[0]
    m_lt, m_pt = img_lt.mean().item(), img_pt.mean().item()
    corr = np.corrcoef(img_lt.mean(-1).flatten().cpu().numpy(),
                       img_pt.mean(-1).flatten().cpu().numpy())[0, 1]
    print(f"[light] ptracer mean {m_lt:.5f} vs PathTracer {LIGHT_PATH_SPP} "
          f"spp {m_pt:.5f} (rel {abs(m_lt - m_pt) / m_pt:.4f}), pixel-mean "
          f"correlation {corr:.4f}", flush=True)
    check(abs(m_lt - m_pt) / m_pt < 0.08, "ptracer mean off by 8% or more")
    check(corr > 0.8, f"ptracer pixel means correlate {corr}")

    # ---- 29 (b)-(e). BDPT, VPL, lightcuts, photon mapping ---------------
    n_vpl = VPLIntegrator().n_paths * (1 + depth - 2)
    chunk = CHUNK_LANES // (res * res)
    walk = PhotonMapper().photon_depth
    runs = (
        ("bdpt", BDPT(max_depth=depth), LIGHT_BDPT_SPP,
         {"trace_closest": LIGHT_BDPT_SPP * (2 * depth - 1),
          "trace_any": LIGHT_BDPT_SPP * (depth - 1) * depth // 2}),
        ("vpl", VPLIntegrator(max_depth=depth), LIGHT_VPL_SPP,
         {"trace_closest": LIGHT_VPL_SPP * (depth - 1),
          "trace_any": LIGHT_VPL_SPP * -(-n_vpl // chunk)}),
        ("lightcuts", LightcutsIntegrator(max_depth=depth), LIGHT_VPL_SPP,
         {"trace_closest": LIGHT_VPL_SPP * (depth - 1),
          "trace_any": LIGHT_VPL_SPP
          * -(-LightcutsIntegrator().cut_size // chunk)}),
        # the photon walk's depth, then the eye pass: Cornell is diffuse,
        # so every chain ends at its first hit (one closest, one NEE ray)
        ("photonmapper", PhotonMapper(max_depth=depth), LIGHT_PM_SPP,
         {"trace_closest": LIGHT_PM_SPP * (walk + 1),
          "trace_any": LIGHT_PM_SPP}))
    for label, integ, spp, want in runs:
        render_fn(scene, cornell_camera(32, 32), Film(32, 32), integ, 1, 0,
                  device=DEV)                               # (warm-up)
        wall, (img, n) = counted(label, lambda: render_fn(
            scene, cam, film, integ, spp, 0, device=DEV), want)
        report(label, f"{spp} spp", wall, img, int(n))
        if label == "vpl":
            print(f"[light] vpl: {n_vpl} VPLs, {chunk * res * res} shadow "
                  f"rays a launch ({chunk} VPLs)", flush=True)
        if label == "bdpt":
            rel = abs(img.mean().item() - m_pt) / m_pt
            print(f"[light] bdpt mean vs PathTracer: rel {rel:.4f}",
                  flush=True)
            check(rel < 0.05, f"bdpt mean off by {rel}")
    passes, pspp = LIGHT_PPM
    pm = PhotonMapper(max_depth=depth)
    wall, img = counted("render_progressive", lambda: render_progressive(
        scene, cam, film, pm, passes, pspp, 0, device=DEV),
        {"trace_closest": passes * pspp * (walk + 1),
         "trace_any": passes * pspp})
    report("render_progressive", f"{passes} x {pspp} spp", wall, img,
           passes * pspp * (2 * res * res + pm.n_photons))

    # ---- 29 (g). the card against CPU tensors ----------------------------
    r = LIGHT_CPU_RES
    small_cam, small = cornell_camera(r, r), Film(r, r, "box")
    cpu = compile_scene(cornell_box(), device="cpu")
    lt = ParticleTracer(max_depth=LIGHT_CPU_DEPTH)
    k_img, k_n = lt.render_stats(scene, small_cam, LIGHT_CPU_PARTICLES, 0,
                                 device=DEV)
    c_img, c_n = lt.render_stats(cpu, small_cam, LIGHT_CPU_PARTICLES, 0,
                                 device="cpu")
    k_img = k_img.cpu()
    image_rule(k_img, c_img, "light cpu ptracer")
    dev = (k_img - c_img).abs().amax(-1) / c_img.max()
    share = (dev <= LIGHT_CPU_TOL).float().mean().item()
    print(f"[light cpu] ptracer {r}², {LIGHT_CPU_PARTICLES} particles: "
          f"max |Δ| / max {dev.max().item():.3g}, share of pixels within "
          f"{LIGHT_CPU_TOL} of the max {share:.5f}; rays {int(k_n)} vs "
          f"{int(c_n)}", flush=True)
    check(share >= LIGHT_CPU_SHARE, f"ptracer card vs CPU: {share}")
    check(abs(int(k_n) - int(c_n)) <= 1e-4 * int(c_n), "ptracer rays")
    d = LIGHT_CPU_DEPTH
    small_runs = {
        "bdpt": BDPT(max_depth=d),
        "vpl": VPLIntegrator(max_depth=d, n_paths=LIGHT_CPU_PATHS),
        "lightcuts": LightcutsIntegrator(max_depth=d,
                                         n_paths=LIGHT_CPU_PATHS),
        "photonmapper": PhotonMapper(max_depth=d,
                                     n_photons=LIGHT_CPU_PHOTONS)}
    for label, integ in small_runs.items():
        k_img, k_n = render_fn(scene, small_cam, small, integ, LIGHT_CPU_SPP,
                               0, device=DEV)
        c_img, c_n = render_fn(cpu, small_cam, small, integ, LIGHT_CPU_SPP,
                               0, device="cpu")
        image_rule(k_img.cpu(), c_img, f"light cpu {label}")
        print(f"[light cpu] {label} {r}², {LIGHT_CPU_SPP} spp: rays "
              f"{int(k_n)} vs {int(c_n)} (equal {int(k_n) == int(c_n)})",
              flush=True)
        check(abs(int(k_n) - int(c_n)) <= 1e-4 * int(c_n),
              f"{label} rays {int(k_n)} vs {int(c_n)}")
    pm = small_runs["photonmapper"]
    image_rule(render_progressive(scene, small_cam, small, pm, 2, 1, 0,
                                  device=DEV).cpu(),
               render_progressive(cpu, small_cam, small, pm, 2, 1, 0,
                                  device="cpu"),
               "light cpu render_progressive")

    # ---- 29 (h). cornell.xml under each kind through the CLI ------------
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        for name, (path, spp) in cli_variants(
                root, tmp, {}, LIGHT_CLI_INTEGRATORS).items():
            exr = path.replace(".xml", ".exr")
            trace.reset_launches()
            mk.reset_launches()
            t0 = time.perf_counter()
            (res_c,) = cli.run([path, "-o", exr, "-q", "-s", str(spp)])
            wall = time.perf_counter() - t0
            launches = {k: trace.LAUNCHES[k] for k in names}
            for k in names:
                out[k]["launches"][f"cli {name}"] = launches[k]
            img = res_c.image
            print(f"[light cli] cornell {name}: {img.shape[1]}x"
                  f"{img.shape[0]}, {res_c.spp} spp, route {res_c.route} "
                  f"({res_c.refused}), launches {launches}, render "
                  f"{res_c.render_s:.3f} s, wall {wall:.3f} s, "
                  f"{res_c.n_rays} rays, mean {img.mean():.5f} ({card})",
                  flush=True)
            check(res_c.route == "eager" and res_c.device == "cuda"
                  and mk.LAUNCHES["mega_persistent"] == 0,
                  f"{name}: route {res_c.route} on {res_c.device}")
            check(launches["trace_closest"] > 0 and launches["trace_any"] > 0,
                  f"{name}: a trace kernel was not launched")
            check(np.isfinite(img).all() and np.abs(img).sum() > 0,
                  f"{name}: image not finite or all zero")
            check(np.array_equal(read_exr(exr), img),
                  f"{name}: the EXR does not read back as the image")
    for k in names:
        out[k]["max_abs_err"] = errs[k]
    for entry in kernels:
        if entry["name"] in names:
            entry["light_subpaths"] = out[entry["name"]]
    print(f"[light] phase 29: {time.perf_counter() - t_start:.1f} s",
          flush=True)


def walk_phase(card, cases):
    """Phase 16: each build of WALK_VARIANTS in the turns of WALK_TURNS on
    the same inputs. cases["traces"]: name -> (scene, rays, any_hit), each
    launch held to the plain version bit for bit, then timed;
    cases["persistent"]: name -> (run, reference output), each launch
    held equal to its reference bit for bit and timed by CUDA events,
    but for the entries ending "(plain)": those have persistent_plain's
    output, come first in each turn, load the build's kernels, and are
    not timed;
    cases["bench"]: the bench-scale rays/s, for "old" and "new", and
    cases["shade"]: name -> (run, shade_plain's output), each held equal
    bit for bit and timed, for "simt" and "new" (the other variants leave
    shade.cu as it is). The variants of WALK_TRACE_ONLY run the traces
    alone.
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
        trace_only = variant in WALK_TRACE_ONLY
        with walk_build(*WALK_VARIANTS[variant], trace_only=trace_only):
            for name, (scene, rays, any_hit) in cases["traces"].items():
                run = lambda: trace.trace(scene, *rays, any_hit)
                t, tri, u, v, hit = run()
                pt, ptri, pu, pv, phit = refs[name]
                same = torch.equal(hit, phit) and (any_hit or (
                    torch.equal(t, pt) and torch.equal(tri.long(), ptri)
                    and torch.equal(u, pu) and torch.equal(v, pv)))
                check(same, f"walk {variant}: {name} differs from plain")
                row[f"trace {name}"] = time_ms(run, 20)
            for name, (run, ref) in () if trace_only else persistent:
                ms, out = events_ms(run)
                check(torch.equal(out, ref),
                      f"walk {variant}: {name} differs from its reference")
                if not name.endswith("(plain)"):
                    row[f"persistent {name}"] = ms
            if variant in ("old", "new"):
                row["cornell bench rays/s"] = cases["bench"]()
            if variant in ("simt", "new"):
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
    for name in means["new"]:     # the default build runs every case
        print(f"[walk] mean {name}: " + ", ".join(
            f"{v} {m[name]:.6g}" for v, m in means.items() if name in m),
            flush=True)
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
    print(f"[build] {len(build_jobs(False))} libraries, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    props = torch.cuda.get_device_properties(0)
    print(f"[build] {props.multi_processor_count} SMs; one lane per pixel "
          f"gives {CORNELL_RES ** 2 // 32 / props.multi_processor_count:.1f}"
          f" warps per SM at {CORNELL_RES}²", flush=True)
    clock("phase 1, the five libraries")

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
    clock("phases 2-3")

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
    clock("phase 4")

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
        "library_ms": None,
        "by_bounce": path_increments("Cornell mega_path", tables, rr,
                                     MAX_DEPTH, st0, pix, samp, card)})

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
    clock("phases 5-8")

    shade_row, shade_walk = shade_phases(card)
    kernels.append(shade_row)
    clock("phases 9-10")
    walk = leaf_phases(card, kernels)
    clock("phases 11-15")
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
    clock("the variant builds joined")
    walk_phase(card, walk)
    clock("phase 16")
    lights_phases(card, kernels)
    clock("phases 17-19")
    persist = next(k for k in kernels if k["name"] == "mega_persistent")
    fog_phases(card, kernels, {
        "cornell 2048 spp": sum(bench_out[s][0] for s in BENCH_SEEDS)
        / len(BENCH_SEEDS),
        "lights 256 spp": persist["lights_composites"]["ms"]})
    clock("phase 20")
    tex_phases(card, kernels)
    clock("phase 21")
    order_phase(card, kernels, {"cornell b0": (scene, primary, False),
                                "cornell b0 shadow": (scene, shadow, True)})
    probe_phase(card, kernels)
    clock("phase 22")
    ablate_phase(card, kernels, scene, cam)
    clock("phase 23")
    prb_phase(card, kernels, scene, cam)
    clock("phase 24")
    dist_phase(card, kernels, scene, cam)
    clock("phase 25")
    # ---- 26. the wavefront machinery, timed with no build running --------
    compaction_phase(card, kernels)
    clock("phase 26")
    # ---- 27. the command-line renderer on the repo's scene files ---------
    cli_phase(card, kernels)
    clock("phase 27")
    # ---- 28. LoD path tracing, the footprint AOV, the new sensors and
    # integrators from scene files -----------------------------------------
    lod_phase(card, kernels)
    clock("phase 28")
    # ---- 29. the integrators whose subpaths start on the emitters -------
    light_phase(card, kernels, scene, cam)
    clock("phase 29")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
