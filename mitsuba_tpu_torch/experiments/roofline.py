"""Roofline probes on the card (port of experiments/_exp_roofline.py):
e0, the fp32 arithmetic ceiling, and e1, the cluster walk's rays/s with no
shading, through the hand-written kernels of csrc/roofline.cu.

    python3 -m mitsuba_tpu_torch.experiments.roofline

prints e0's TFLOP/s for one FFMA a step and for FMUL then FADD (the port's
kernels are built FMA-off, and PERF.md's bounds count single fp32
operations), and e1's rays/s with the share of lanes that hit at each step,
at the TPU probe's own inputs. The wrappers launch the kernels for CUDA
tensors and run the plain versions for CPU tensors; on a CUDA tensor a
failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..accel import dense, trace
from . import time_ms

B = 8192                    # the TPU probe's lanes
TC = 40                     # and its triangles (one cluster)
# e0: four chains a = x*k0 + c0, then a = a*k + c (_exp_roofline.py:22-36)
E0_K0 = (1.000001, 0.999999, 1.000002, 0.999998)
E0_C0 = (0.3, 0.1, 0.2, 0.4)
E0_K = (1.0000001, 0.9999999, 1.0000002, 0.9999998)
E0_C = (1e-7,) * 4
# 132 rows of B: 132 SMs x 2048 threads, four times over
E0_ROWS = 132
E0_ITERS = 131072           # a launch of >= 10 ms at the data sheet's peak
E1_ITERS = 1024
E1_MINT = 1e-4

LAUNCHES = {"e0_ffma": 0, "e0_fmul_fadd": 0, "e1_trace_only": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(defines: tuple = ()):
    """Build csrc/roofline.cu (accel/trace.py build_library)."""
    return trace.build_library("roofline.cu", "mitsuba_roofline", defines)


def _library():
    return _bind(build()[0])


@functools.lru_cache(maxsize=None)
def _bind(path):
    lib = ctypes.CDLL(str(path))
    e0 = lib.mitsuba_e0
    e0.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
    e1 = lib.mitsuba_e1
    e1.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5)
    for fn in (e0, e1):
        fn.restype = ctypes.c_int
    return e0, e1


def _raise(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


# ---------------------------------------------------------------------------
# e0: the fp32 ceiling
# ---------------------------------------------------------------------------

def e0_flops(n: int, n_iter: int) -> int:
    """Flops of e0 on n floats, as the TPU probe counts them: 4 chains of
    2 a step (the FMUL/FADD variant's fp32 operations too)."""
    return 4 * 2 * n * n_iter


def fma32(a: torch.Tensor, k: float, c: float) -> torch.Tensor:
    """a * k + c for float32 a and float32 k, c, rounded once, as FFMA
    rounds it: the product is exact in float64 (24 + 24 bits), the sum is
    rounded there to odd (TwoSum gives its error; an inexact sum takes the
    odd one of its two neighbours), and float32's rounding of that is the
    single rounding of the exact value (53 >= 24 + 2 bits). Rounding the
    float64 sum to nearest instead would round twice, wrong where it lands
    on a float32 halfway point."""
    p = a.double() * k
    s = p + c
    c_part = s - p
    err = (p - (s - c_part)) + (c - c_part)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.nextafter(s, torch.full_like(s, torch.inf).copysign(err))
    return torch.where((err != 0) & even, away, s).float()


def e0_plain(x: torch.Tensor, n_iter: int, fma: bool) -> torch.Tensor:
    """e0 in torch: fma rounds each x*k + c once (fma32, the FFMA's
    result), else the product and the sum each."""
    def step(a, k, c):
        k, c = float(np.float32(k)), float(np.float32(c))   # the kernel's
        if fma:
            return fma32(a, k, c)
        return a * k + c
    a, b, c, d = (step(x, k, c0) for k, c0 in zip(E0_K0, E0_C0))
    for _ in range(n_iter):
        a, b, c, d = (step(v, k, c0) for v, k, c0
                      in zip((a, b, c, d), E0_K, E0_C))
    return ((a + b) + c) + d


def e0(x: torch.Tensor, n_iter: int, fma: bool) -> torch.Tensor:
    """e0 over the floats of x (any shape): the kernel on a CUDA tensor,
    e0_plain on a CPU tensor."""
    if x.device.type != "cuda":
        return e0_plain(x, n_iter, fma)
    trace.check_tensor(x, "x", torch.float32, tuple(x.shape), x.device)
    out = torch.empty_like(x)
    coef = (ctypes.c_float * 16)(*E0_K0, *E0_C0, *E0_K, *E0_C)
    fn = _library()[0]
    with torch.cuda.device(x.device):
        _raise(fn(x.data_ptr(), out.data_ptr(), x.numel(), n_iter, int(fma),
                  coef, torch.cuda.current_stream(x.device).cuda_stream),
               "e0")
    LAUNCHES["e0_ffma" if fma else "e0_fmul_fadd"] += 1
    return out


# ---------------------------------------------------------------------------
# e1: the walk with no shading
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Table:
    """The fields of SceneData that e1 reads: the kernel's Woop clusters
    and boxes, the dense layout for the plain version, the real triangle
    count and (optional) the order tables."""
    woop_clusters: torch.Tensor     # [C, 3*64, 4]
    cluster_aabb: torch.Tensor      # [C, 8]
    woop_o: torch.Tensor            # [4, 3T]
    n_real_tris: int
    cluster_meta: torch.Tensor = None
    cluster_order: torch.Tensor = None
    cluster_odist: torch.Tensor = None


def probe_table(seed: int = 0, device="cuda", tc: int = TC) -> Table:
    """The TPU probe's table: tc random Woop rows a component, [3*tc, 4]
    f32 (np.random.randn, row k*tc + t: component k of triangle t), as one
    cluster of the port's 64, padded with triangles that never hit, under
    the everything-box (pallas_trace.py:424-428)."""
    w = np.random.RandomState(seed).randn(3 * tc, 4).astype(np.float32)
    return table_from_rows(w, tc, device)


def table_from_rows(w: np.ndarray, tc: int, device) -> Table:
    """A Table from [3*tc, 4] Woop rows in the TPU probe's layout."""
    per = w.reshape(3, tc, 4)                            # [k, t, j]
    woop_o = np.ascontiguousarray(per.transpose(2, 1, 0).reshape(4, 3 * tc))
    cl = trace.build_woop_clustered(woop_o, trace.TRIS_PER_CLUSTER)
    box = np.tile(np.float32([-1e30] * 3 + [1e30] * 3 + [0.0, 0.0]),
                  (cl.shape[0], 1))
    to = lambda a: torch.as_tensor(a, device=device)
    return Table(to(cl), to(box), to(woop_o), tc)


def probe_state(b: int = B, seed: int = 1, device="cuda") -> torch.Tensor:
    """The probe's lanes: [6, b] f32 (origin xyz, direction xyz rows) from
    np.random.randn, directions unnormalized as there."""
    return torch.as_tensor(np.random.RandomState(seed).randn(6, b)
                           .astype(np.float32), device=device)


def e1_plain(table, st: torch.Tensor, n_iter: int, record: bool = False):
    """e1 in torch on [6, b] lanes: each step a closest trace (mint 1e-4,
    maxt 1e30), a second from o + (0.1, 0, 0) along -d (maxt 5e29), then
    ox += 0.001 t1, oz += 0.001 t2 (t 1e30 on a miss). Returns the final
    [6, b] state and hits [n_iter, 2] int32 (lanes whose first and second
    trace hit); with `record`, also each step's rays and closest t as
    [(o, d, mint, maxt, t), ...]."""
    ox, oy, oz, dx, dy, dz = st.clone()
    b = st.shape[1]
    mint = torch.full((b,), E1_MINT, device=st.device)
    maxt = torch.full((b,), dense.MISS, device=st.device)
    hits = torch.zeros(n_iter, 2, dtype=torch.int32, device=st.device)
    rays = []
    for s in range(n_iter):
        o1, d1 = torch.stack([ox, oy, oz], 1), torch.stack([dx, dy, dz], 1)
        o2, d2 = torch.stack([ox + 0.1, oy, oz], 1), -d1
        t1, _, _, _, h1 = dense.intersect_soup(o1, d1, table.woop_o, mint,
                                               maxt)
        t2, _, _, _, h2 = dense.intersect_soup(o2, d2, table.woop_o, mint,
                                               maxt * 0.5)
        hits[s, 0], hits[s, 1] = h1.sum(), h2.sum()
        if record:
            rays += [(o1, d1, mint, maxt, t1), (o2, d2, mint, maxt * 0.5, t2)]
        ox = ox + 0.001 * t1
        oz = oz + 0.001 * t2
    out = torch.stack([ox, oy, oz, dx, dy, dz])
    return (out, hits, rays) if record else (out, hits)


def e1(table, st: torch.Tensor, n_iter: int, hits: torch.Tensor = None):
    """e1 on [6, b] lanes against `table` (a Table or a SceneData): one
    kernel launch on CUDA tensors (ordered where the table has the order
    tables and more than one walked cluster, as the trace kernel), with
    per-step hit counts added into `hits` ([n_iter, 2] int32) where given;
    e1_plain on CPU tensors. Returns the final [6, b] state."""
    if st.device.type != "cuda":
        out, h = e1_plain(table, st, n_iter)
        if hits is not None:
            hits += h
        return out
    dev, b = st.device, st.shape[1]
    woop, box = table.woop_clusters, table.cluster_aabb
    c = woop.shape[0]
    trace.check_tensor(woop, "woop_clusters", torch.float32,
                       (c, 3 * trace.TRIS_PER_CLUSTER, 4), dev, align=16)
    trace.check_tensor(box, "cluster_aabb", torch.float32, (c, 8), dev,
                       align=16)
    trace.check_tensor(st, "st", torch.float32, (6, b), dev)
    if hits is not None:
        trace.check_tensor(hits, "hits", torch.int32, (n_iter, 2), dev)
    tables = (table.cluster_meta, table.cluster_order, table.cluster_odist)
    if any(x is None for x in tables):
        tables = (None,) * 3
    out = torch.empty_like(st)
    ptr = lambda x: None if x is None else x.data_ptr()
    fn = _library()[1]
    with torch.cuda.device(dev):
        _raise(fn(ptr(woop), ptr(box), c, trace.real_tris(table), ptr(st),
                  ptr(out), b, n_iter, *map(ptr, tables), ptr(hits),
                  torch.cuda.current_stream(dev).cuda_stream), "e1")
    LAUNCHES["e1_trace_only"] += 1
    return out


def main():
    import subprocess
    if not torch.cuda.is_available():
        raise SystemExit("roofline: torch sees no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    x = torch.ones(E0_ROWS, B, device="cuda")
    for fma, name in ((True, "FFMA"), (False, "FMUL+FADD")):
        ms = time_ms(lambda: e0(x, E0_ITERS, fma), 3, warmup=1)
        print(f"e0 {name} [{E0_ROWS}, {B}] x {E0_ITERS}: {ms:.4f} ms, "
              f"{e0_flops(x.numel(), E0_ITERS) / ms / 1e9:.4g} TFLOP/s "
              f"({card})")
    table, st = probe_table(), probe_state()
    ms = time_ms(lambda: e1(table, st, E1_ITERS), 3, warmup=1)
    hits = torch.zeros(E1_ITERS, 2, dtype=torch.int32, device="cuda")
    e1(table, st, E1_ITERS, hits)
    share = (hits.float() / B).tolist()
    print(f"e1 at the probe's inputs ({B} lanes, {TC} triangles, "
          f"{E1_ITERS} steps): {ms:.4f} ms, "
          f"{2 * B * E1_ITERS / ms * 1e3:.6g} rays/s; lanes hitting at "
          f"steps 0-3: {share[:4]}, at the last: {share[-1]} ({card})")


if __name__ == "__main__":
    main()
