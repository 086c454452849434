"""Ray tracing through the hand-written CUDA kernel csrc/trace.cu (port of
mitsuba_tpu/accel/pallas_trace.py: trace, pallas_intersect,
pallas_occluded, and the host-side cluster table builders).

`intersect` (closest hit) and `occluded` (any hit) run the kernel for CUDA
tensors and the plain version, accel/dense.py, for CPU tensors. There is no
fallback: on a CUDA tensor a failed build or launch raises. The kernel is
built from the repository's sources at first use, with nvcc into
build/kernels/, and bound through a plain C interface with ctypes.

The kernels' cluster walk stops at the scene's last real triangle
(`real_tris`, checked once per table): the builder's padding follows it
and never hits.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import weakref
from pathlib import Path

import numpy as np
import torch

from ..scene.scene import Intersection, SceneData
from . import dense

TRIS_PER_CLUSTER = 64       # triangles per kernel cluster (csrc/trace.cu)
ORDER_MAX_CLUSTERS = 128    # order tables are built up to this many clusters

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches per entry point; only the two wrappers below add to them.
LAUNCHES = {"trace_closest": 0, "trace_any": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# host-side cluster tables (copied from mitsuba_tpu/accel/pallas_trace.py)
# ---------------------------------------------------------------------------

def build_woop_clustered(woop_o: np.ndarray, tris_per_cluster: int):
    """Repack the [4, 3T] Woop matrix (dense.build_woop, column 3t+k) into
    [C, 3Tc, 4] cluster blocks: out[c, k*Tc + t, j]. Padding triangles get
    a zero matrix with translation z = 1, so d'_z = 0 and they never hit."""
    _, t3 = woop_o.shape
    n_tris = t3 // 3
    tc = tris_per_cluster
    c = -(-n_tris // tc)
    pad = c * tc - n_tris
    w = woop_o.reshape(4, n_tris, 3)
    if pad:
        padw = np.zeros((4, pad, 3), woop_o.dtype)
        padw[3, :, 2] = 1.0
        w = np.concatenate([w, padw], axis=1)
    out = np.transpose(w.reshape(4, c, tc, 3), (1, 3, 2, 0)).reshape(
        c, 3 * tc, 4)
    return np.ascontiguousarray(out, np.float32)


def build_cluster_aabbs(p0, e1, e2, tc: int, c_clusters: int) -> np.ndarray:
    """World AABB per tc-sized cluster → [C, 8] f32 (min xyz, max xyz, 2
    pad columns). Clusters of padding only get an inverted box."""
    n = len(p0)
    out = np.empty((c_clusters, 8), np.float32)
    out[:, 0:3] = 1e30
    out[:, 3:6] = -1e30
    out[:, 6:8] = 0.0
    if n:
        v0 = np.asarray(p0, np.float64)
        v1 = v0 + np.asarray(e1, np.float64)
        v2 = v0 + np.asarray(e2, np.float64)
        lo = np.minimum(np.minimum(v0, v1), v2)
        hi = np.maximum(np.maximum(v0, v1), v2)
        for c in range(min(c_clusters, -(-n // tc))):
            s = slice(c * tc, min((c + 1) * tc, n))
            out[c, 0:3] = lo[s].min(0)
            out[c, 3:6] = hi[s].max(0)
    return out


def build_cluster_order(aabb: np.ndarray):
    """Front-to-back traversal tables from the cluster AABBs: (meta [C, 8]
    f32: center xyz, half-diagonal r, global r_max, scene AABB in rows 0/1
    cols 5:8; order [C, C] i32: clusters by center distance from cluster
    k; odist [C, C] f32: those distances)."""
    lo = aabb[:, 0:3].astype(np.float64)
    hi = aabb[:, 3:6].astype(np.float64)
    empty = (lo > hi).any(-1)
    center = np.where(empty[:, None], 1e30, (lo + hi) * 0.5)
    r = np.where(empty, 0.0,
                 0.5 * np.linalg.norm(np.maximum(hi - lo, 0), axis=-1))
    d = np.linalg.norm(center[:, None, :] - center[None, :, :], axis=-1)
    order = np.argsort(d, axis=1).astype(np.int32)
    odist = np.take_along_axis(d, order, axis=1).astype(np.float32)
    meta = np.zeros((len(center), 8), np.float32)
    meta[:, 0:3] = center
    meta[:, 3] = r
    meta[:, 4] = r[~empty].max() if (~empty).any() else 0.0
    if (~empty).any():
        meta[0, 5:8] = lo[~empty].min(0)
        meta[1, 5:8] = hi[~empty].max(0)
    return meta, order, odist


def padding_start(woop_clusters: torch.Tensor) -> int:
    """The first triangle of the [C, 3*64, 4] Woop table from which on
    every triangle is padding: its z-row (w2) has a zero linear part, so
    d'_z = 0 for every ray and it never hits."""
    wz = woop_clusters[:, 2 * TRIS_PER_CLUSTER:, :3]
    real = (wz != 0).any(-1).reshape(-1).nonzero()
    return int(real[-1]) + 1 if real.numel() else 0


_checked: dict = {}    # id(woop table) -> (weakref to it, checked count)


def real_tris(scene: SceneData) -> int:
    """The scene's count of real triangles, where the kernels' cluster
    walk stops. Raises ValueError unless every triangle of the Woop table
    past it is padding that never hits (padding_start); checked once per
    table."""
    n, woop = scene.n_real_tris, scene.woop_clusters
    if n is None:
        raise ValueError("scene has no real triangle count (n_real_tris)")
    seen = _checked.get(id(woop))
    if seen is not None and seen[0]() is woop and seen[1] == n:
        return n
    cap = woop.shape[0] * TRIS_PER_CLUSTER
    if not 0 <= n <= cap:
        raise ValueError(f"n_real_tris {n} outside the table's 0..{cap}")
    first_pad = padding_start(woop)
    if first_pad > n:
        raise ValueError(
            f"triangle {first_pad - 1} of the Woop table can hit but lies "
            f"past the scene's {n} real triangles: the walk would miss it")
    key = id(woop)
    _checked[key] = (weakref.ref(woop, lambda _: _checked.pop(key, None)), n)
    return n


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels in csrc/")
    return path


@functools.lru_cache(maxsize=None)
def build_library(source: str, stem: str, extra_flags: tuple = ()
                  ) -> tuple[Path, str]:
    """Compile csrc/<source> with nvcc into build/kernels/, once per hash
    of the source, every csrc/*.cuh header and the flags. Returns (library
    path, ptxas register and spill report); the report is kept beside the
    library, so a cached build returns it too."""
    path = CSRC / source
    flags = list(NVCC_FLAGS) + list(extra_flags)
    digest = hashlib.sha256(path.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(flags).encode())
    lib = BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"
    report_file = lib.with_suffix(".ptxas.txt")
    if lib.exists() and report_file.exists():
        return lib, report_file.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path}:\n{proc.stderr}")
    report = "\n".join(line for line in proc.stderr.splitlines()
                       if any(k in line for k in ("entry function",
                                                  "registers", "spill")))
    report_file.write_text(report)
    os.replace(tmp, lib)
    return lib, report


def build(defines: tuple = ()) -> tuple[Path, str]:
    """Build csrc/trace.cu (see build_library) with these nvcc defines of
    the cluster walk (csrc/trace_common.cuh; the wrappers launch the
    default build)."""
    return build_library("trace.cu", "mitsuba_trace", defines)


def _library():
    return _bind(build()[0])


@functools.lru_cache(maxsize=None)
def _bind(path: Path):
    fn = ctypes.CDLL(str(path)).mitsuba_trace
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    return fn


def check_tensor(x: torch.Tensor, name, dtype, shape, device, align=1):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous() or x.data_ptr() % align:
        raise ValueError(
            f"{name}: need a contiguous {align}-byte-aligned {dtype} tensor "
            f"of shape {shape} on {device}, got {x.dtype} {tuple(x.shape)} "
            f"on {x.device}")


def trace(scene: SceneData, o, d, mint, maxt, live, any_hit: bool):
    """One kernel launch over N rays on CUDA tensors (the port of
    pallas_trace.trace). Returns (t, tri, u, v, hit); in any-hit mode only
    hit is computed and the others are None."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"trace launches the CUDA kernel; rays are on {dev}")
    n = o.shape[0]
    woop, aabb = scene.woop_clusters, scene.cluster_aabb
    if aabb is None:
        raise ValueError("scene has no cluster_aabb table")
    c = woop.shape[0]
    check_tensor(woop, "woop_clusters", torch.float32,
           (c, 3 * TRIS_PER_CLUSTER, 4), dev, align=16)
    check_tensor(aabb, "cluster_aabb", torch.float32, (c, 8), dev, align=16)
    n_real = real_tris(scene)
    for x, name in ((o, "o"), (d, "d")):
        check_tensor(x, name, torch.float32, (n, 3), dev)
    for x, name in ((mint, "mint"), (maxt, "maxt")):
        check_tensor(x, name, torch.float32, (n,), dev)
    if live is not None:
        check_tensor(live, "live", torch.bool, (n,), dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    if any_hit:
        t = tri = u = v = None
    else:
        t = torch.empty(n, dtype=torch.float32, device=dev)
        tri = torch.empty(n, dtype=torch.int32, device=dev)
        u = torch.empty(n, dtype=torch.float32, device=dev)
        v = torch.empty(n, dtype=torch.float32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    fn = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(woop), ptr(aabb), c, n_real, ptr(o), ptr(d),
                 ptr(mint), ptr(maxt), ptr(live), n, int(any_hit), ptr(t),
                 ptr(tri), ptr(u), ptr(v), ptr(hit), stream)
    if err != 0:
        raise RuntimeError(f"trace kernel launch failed: cudaError_t {err}")
    LAUNCHES["trace_any" if any_hit else "trace_closest"] += 1
    return t, tri, u, v, hit


def _route(o):
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no trace route for device {o.device}")
    return o.device.type == "cuda"


def intersect(scene: SceneData, o, d, mint, maxt, live=None
              ) -> Intersection:
    """Closest hit of rays o, d [N, 3] within (mint, maxt) [N]. `live` [N]
    bool: dead lanes report a miss and cost no triangle tests."""
    if not _route(o):
        return dense.ray_intersect(scene, o, d, mint, maxt, live)
    t, tri, u, v, hit = trace(scene, o, d, mint, maxt, live, False)
    return dense.fill_intersection(scene, o, d, t, u, v, tri, hit)


def occluded(scene: SceneData, o, d, mint, maxt, live=None):
    """Any hit within (mint, maxt): [N] bool (shadow rays)."""
    if not _route(o):
        return dense.ray_test(scene, o, d, mint, maxt, live)
    return trace(scene, o, d, mint, maxt, live, True)[4]
