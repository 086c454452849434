"""The megakernel bounce's cost by component (port of
experiments/_exp_ablate.py::run_fixed): n_iter bounces of every lane in one
launch of csrc/ablate.cu, with no regeneration and no early exit, under
seven variants that stub the closest-hit walk, the shadow walk, the hit's
record or the shading.

    python3 -m mitsuba_tpu_torch.experiments.ablate

prints each variant's µs per step and "M rays/s equiv" (2·lanes / step),
as the TPU probe prints them, on the Cornell tables (cluster_size=64) at
the probe's 8,192 lanes and at 65,536 (256², the main path's wavefront),
512 steps, 10 timed launches after a warm-up, then the split of the bounce
(split). run_fixed takes any MegaTables without the kExt features and any
[16, N] start state. It launches the kernel for CUDA tensors and runs the
plain version, run_fixed_plain, for CPU tensors; on a CUDA tensor a failed
build or launch raises. No path of the program calls it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import torch

from ..accel import dense, trace
from ..accel import megakernel as mk
from . import time_ms

# the variants in the TPU probe's order, under its labels (:184-197), and
# their names in chip_smoke.py's kernels line (ablate_<name>)
VARIANTS = ("full bounce", "no shadow trace", "no closest trace",
            "no traces (shading only)", "no attr select",
            "closest=transform only", "traces only (no shading)")
NAMES = ("full", "no_shadow", "no_closest", "no_traces", "no_attr",
         "transform", "no_shade")
(FULL, NO_SHADOW, NO_CLOSEST, NO_TRACES, NO_ATTR, TRANSFORM,
 NO_SHADE) = range(7)
B = 8192                    # the TPU probe's lanes
N_ITER = 512                # and its steps
REPS = 10                   # its timed launches
MAIN_LANES = 256 * 256      # the main path's wavefront
SEED = 1                    # the bounce's seed, rr_depth and max_depth
RR_DEPTH = 99               # (unbounded) in the probe's loop (:124-126)
MAX_DEPTH = 0
N_OUT = mk.N_STATE + 2      # the state, closest hits and occluded shadows

LAUNCHES = {f"ablate_{n}": 0 for n in NAMES}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def stub_record(device="cpu") -> torch.Tensor:
    """The hit record a stubbed trace reports, in N_ATTR's layout
    (accel/megakernel.py): ng = vn0 = (0, 1, 0) (rows 0:3, 5:8), material 0
    (row 3), emitter -1 (row 4), vn1 - vn0 = vn2 - vn0 = 0, uv 0, the other
    rows 0: the TPU stub's intent (_exp_ablate.py:26-27, a +y normal and
    no emitter) in today's rows."""
    rec = torch.zeros(mk.N_ATTR, dtype=torch.float32, device=device)
    rec[1] = rec[6] = 1.0
    rec[4] = -1.0
    return rec


def _stub_scene(device):
    """The stub record as a one-triangle tri_attr ([1, 24], the scene
    layout: ng, vn0-2, uv0-2, material, emitter) for dense.fill_intersection."""
    row = torch.zeros((1, 24), dtype=torch.float32, device=device)
    row[0, 1] = row[0, 4] = row[0, 7] = row[0, 10] = 1.0
    row[0, 19] = -1.0
    return SimpleNamespace(tri_attr=row)


def probe_state(b: int = B, device="cuda") -> torch.Tensor:
    """The TPU probe's start state (_exp_ablate.py:143-150), [16, b] f32:
    o = (0, 1, 0), d from np.random.default_rng(0).normal((3, b)) with each
    column normalized, throughput 1, L 0, active 1, prev_pdf 1,
    prev_delta 0, eta 1."""
    st = np.zeros((16, b), np.float32)
    st[1] = 1.0
    st[3:6] = np.random.default_rng(0).normal(size=(3, b))
    st[3:6] /= np.linalg.norm(st[3:6], axis=0, keepdims=True)
    st[6:9] = 1.0
    st[12] = st[13] = st[15] = 1.0
    return torch.as_tensor(st, device=device)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def transform_acc(woop, o, d):
    """Variant 5's accumulator [N] (_exp_ablate.py:47-68): over the
    clusters of woop [C, 3*64, 4], the sum of each cluster's min over its
    64 rows of ((((o'x + o'y) + o'z) + d'x) + d'y) + d'z, where o' =
    ((w0·ox + w1·oy) + w2·oz) + w3 and d' = (w0·dx + w1·dy) + w2·dz, in
    the kernel's order."""
    ox, oy, oz = (o[:, k, None] for k in range(3))
    dx, dy, dz = (d[:, k, None] for k in range(3))
    acc = torch.zeros_like(o[:, 0])
    for c in range(woop.shape[0]):
        w = woop[c].view(3, trace.TRIS_PER_CLUSTER, 4)
        op = [((w[k, :, 0] * ox + w[k, :, 1] * oy) + w[k, :, 2] * oz)
              + w[k, :, 3] for k in range(3)]
        dp = [(w[k, :, 0] * dx + w[k, :, 1] * dy) + w[k, :, 2] * dz
              for k in range(3)]
        v = ((((op[0] + op[1]) + op[2]) + dp[0]) + dp[1]) + dp[2]
        acc = acc + v.amin(1)
    return acc


@dataclasses.dataclass(frozen=True, eq=False)
class AblatePlainTracer(mk.MegaPlainTracer):
    """MegaPlainTracer whose _intersect/_occluded hooks are the variant's
    traces, as csrc/ablate.cu's policies: a stub hit at t = 1 on the stub
    record (no closest trace, no traces; t = 1 + 0·transform_acc for the
    transform variant), the plain closest hit read on the stub record (no
    attr select), every shadow ray occluded (no shadow trace, no traces),
    else the plain intersector. `tally` gathers per lane the closest rays
    that hit and the shadow rays reported occluded."""
    variant: int = FULL
    tally: dict | None = None

    def _intersect(self, scene, o, d, mint, live):
        v = self.variant
        stub = _stub_scene(o.device)
        zero = torch.zeros_like(mint)
        if v in (NO_CLOSEST, NO_TRACES, TRANSFORM):
            t = torch.ones_like(mint)
            if v == TRANSFORM:
                t = torch.where(live, 1.0 + 0.0 * transform_acc(
                    self.tables.woop, o, d), dense.MISS)
            hit = live & (t < dense.MISS)
            its = dense.fill_intersection(
                stub, o, d, torch.where(hit, t, dense.MISS), zero, zero,
                torch.zeros_like(live, dtype=torch.int64), hit)
        else:
            its = super()._intersect(scene, o, d, mint, live)
            if v == NO_ATTR:
                its = dense.fill_intersection(
                    stub, o, d, its.t, zero, zero, its.tri_id * 0, its.valid)
        self.tally["hits"] += its.valid.to(mint.dtype)
        return its

    def _occluded(self, scene, o, d, mint, maxt, live):
        if self.variant in (NO_SHADOW, NO_TRACES):
            occ = torch.ones_like(live)
        else:
            occ = super()._occluded(scene, o, d, mint, maxt, live)
        self.tally["occl"] += (live & occ).to(mint.dtype)
        return occ


def noshade_plain(tables: mk.MegaTables, st, tally):
    """Variant 6's step, _bounce_noshade (:81-103): the closest hit from o
    along d over (1e-4·(1 + |ox|), 1e30), a shadow ray from o + (0.01, 0,
    0) along (dy, dz, dx) over (the same mint, 5e29), then o + 0.001·t·d
    (t 1 on a miss), throughput ·0.999, L + 0.0001·ng (0 on a miss)."""
    scene = tables.plain_scene
    o = st[0:3].T.contiguous()
    d = st[3:6].T.contiguous()
    mint = 1e-4 * (1.0 + o[:, 0].abs())
    maxt = torch.full_like(mint, dense.MISS)
    its = dense.ray_intersect(scene, o, d, mint, maxt)
    so = torch.stack([o[:, 0] + 0.01, o[:, 1], o[:, 2]], 1)
    occ = dense.ray_test(scene, so, d[:, [1, 2, 0]].contiguous(), mint,
                         maxt * 0.5)
    tally["hits"] += its.valid.to(st.dtype)
    tally["occl"] += occ.to(st.dtype)
    k = 0.001 * torch.where(its.valid, its.t, 1.0)
    ng = torch.where(its.valid[:, None], its.ng, 0.0)
    return torch.cat([(o + k[:, None] * d).T, st[3:6], st[6:9] * 0.999,
                      st[9:12] + 0.0001 * ng.T, st[12:16]])


def keep_alive(new):
    """The probe's keep-alive step (:129-135): rows 0:6 as returned, the
    throughput max(·, 0.25) (a NaN kept), L times 0, active 1, rows 13:16
    as returned."""
    return torch.cat([new[0:6], torch.clamp(new[6:9], min=0.25),
                      new[9:12] * 0.0, torch.ones_like(new[12:13]),
                      new[13:16]])


def run_fixed_plain(tables: mk.MegaTables, state, n_iter: int, variant: int,
                    bounce0: int = 0):
    """run_fixed in torch: [16, N] → [18, N]."""
    n = state.shape[1]
    tally = {"hits": state.new_zeros(n), "occl": state.new_zeros(n)}
    pix = torch.arange(n, dtype=torch.int32, device=state.device)
    samp = torch.zeros_like(pix)
    tracer = AblatePlainTracer(
        max_depth=MAX_DEPTH, rr_depth=RR_DEPTH, accel="plain", tables=tables,
        variant=variant, tally=tally).specialized_for(tables.plain_scene)
    st = state
    for it in range(n_iter):
        if variant == NO_SHADE:
            st = noshade_plain(tables, st, tally)
        else:
            st = tracer.bounce(tables.plain_scene, st, SEED, pix, samp,
                               bounce0 + it)[0]
        st = keep_alive(st)
    return torch.cat([st, tally["hits"][None], tally["occl"][None]])


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def build(defines: tuple = ()):
    """Build csrc/ablate.cu (accel/trace.py build_library) with
    -fmad=false, as csrc/megakernel.cu, whose bounce it runs."""
    return trace.build_library("ablate.cu", "mitsuba_ablate",
                               ("-fmad=false",) + tuple(defines))


def _library():
    return _bind(build()[0])


@functools.lru_cache(maxsize=None)
def _bind(path):
    lib = ctypes.CDLL(str(path))
    fn = lib.mitsuba_ablate
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _device_stub(device):
    return stub_record(device)


def run_fixed(tables: mk.MegaTables, state, n_iter: int, variant: int,
              bounce0: int = 0):
    """n_iter kept-alive bounces of every lane of state [16, N] f32 under
    `variant` (an index of VARIANTS), the first at bounce index bounce0.
    Returns [18, N]: the state, then per lane the closest rays that hit
    and the shadow rays reported occluded. The tables must not need the
    megakernels' kExt instantiations (MegaTables.ext)."""
    if not 0 <= variant < len(VARIANTS):
        raise ValueError(f"variant {variant} outside 0..{len(VARIANTS) - 1}")
    if tables.ext:
        raise ValueError("the ablation runs the bounce without kExt: no "
                         "non-area emitters, composites, medium or textures")
    dev = state.device
    if dev.type == "cpu":
        return run_fixed_plain(tables, state, n_iter, variant, bounce0)
    if dev.type != "cuda":
        raise ValueError(f"no ablation route for device {dev}")
    n = state.shape[1]
    check = trace.check_tensor
    check(state, "state", torch.float32, (mk.N_STATE, n), dev)
    c = tables.woop.shape[0]
    check(tables.woop, "woop", torch.float32,
          (c, 3 * trace.TRIS_PER_CLUSTER, 4), dev, align=16)
    check(tables.aabb, "aabb", torch.float32, (c, 8), dev, align=16)
    check(tables.attr, "attr", torch.float32,
          (tables.attr.shape[0], mk.N_ATTR), dev)
    check(tables.mat, "mat", torch.float32, (tables.m_real, mk.N_MAT), dev)
    check(tables.em_rows, "em_rows", torch.float32,
          (tables.em_rows.shape[0], 24), dev)
    check(tables.em_meta, "em_meta", torch.float32,
          (tables.em_meta.shape[0], 16), dev)
    check(tables.em_cdf, "em_cdf", torch.float32,
          (max(tables.em_count, 1) + 1,), dev)
    stub = _device_stub(str(dev))
    out = torch.empty((N_OUT, n), dtype=torch.float32, device=dev)
    fn = _library()
    with torch.cuda.device(dev):
        err = fn(tables.woop.data_ptr(), tables.aabb.data_ptr(), c,
                 tables.real_tris, tables.attr.data_ptr(),
                 tables.mat.data_ptr(), tables.em_rows.data_ptr(),
                 tables.et_real, tables.em_meta.data_ptr(),
                 tables.em_cdf.data_ptr(), tables.em_count, stub.data_ptr(),
                 state.data_ptr(), out.data_ptr(), n, n_iter, bounce0,
                 variant, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ablation kernel launch failed: cudaError_t "
                           f"{err}")
    LAUNCHES[f"ablate_{NAMES[variant]}"] += 1
    return out


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------

def split(us):
    """The bounce's split from the variants' µs per step (a sequence in
    VARIANTS' order, or a dict by label): the closest walk = full - no
    closest trace, the shadow walk = full - no shadow trace, the hit row =
    full - no attr select, the shading = no traces."""
    if not isinstance(us, dict):
        us = dict(zip(VARIANTS, us))
    full = us[VARIANTS[FULL]]
    return {"closest walk": full - us[VARIANTS[NO_CLOSEST]],
            "shadow walk": full - us[VARIANTS[NO_SHADOW]],
            "hit row": full - us[VARIANTS[NO_ATTR]],
            "shading": us[VARIANTS[NO_TRACES]]}


def time_variants(tables, state, n_iter=N_ITER, reps=REPS, label="",
                  out=print):
    """Each variant's µs per step over n_iter steps from `state` (time_ms:
    `reps` launches after a warm-up), printed as the TPU probe prints it
    (:172-174). Returns the µs per step in VARIANTS' order."""
    b = state.shape[1]
    us = []
    for v, name in enumerate(VARIANTS):
        ms = time_ms(lambda: run_fixed(tables, state, n_iter, v), reps,
                     warmup=1)
        per = ms * 1e3 / n_iter
        us.append(per)
        out(f"{label}{name}: {per:.2f} us/iter "
            f"({2 * b / (per * 1e-6) / 1e6:.0f} M rays/s equiv)")
    return us


def main():
    import subprocess
    from ..integrator.mega import MegaPathTracer
    from ..scene.builder import compile_scene
    from ..scene.presets import cornell_box
    if not torch.cuda.is_available():
        raise SystemExit("ablate: torch sees no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    scene = compile_scene(cornell_box(), cluster_size=64, device="cuda")
    tables = MegaPathTracer.for_scene(scene, max_depth=8).tables
    for b in (B, MAIN_LANES):
        print(f"Cornell tables, {b} lanes, {N_ITER} steps ({card}):",
              flush=True)
        us = time_variants(tables, probe_state(b), label="  ",
                           out=lambda s: print(s, flush=True))
        print("  split (us/iter): " + ", ".join(
            f"{k} {v:.2f}" for k, v in split(us).items()), flush=True)


if __name__ == "__main__":
    main()
