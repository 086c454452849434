"""Per-lane table loads on the card (port of
experiments/_exp_gather_probe.py and _exp_gather_probe2.py): one kernel,
csrc/gather.cu, for take_along_axis on either axis of a row-major table
and for the column gather table[idx, col].

    python3 -m mitsuba_tpu_torch.experiments.gather_probe

times every form of the TPU probes (FORMS) at a size that fills the card
(their index arrays' rows scaled to >= 64 MB of output, the tables kept),
and prints its GB/s against the data sheet's 3.35 TB/s beside one PyTorch
call that computes the same function (torch.gather; torch.take for the
column gather). `gather` checks the indices and launches the kernel for
CUDA tensors (`launch`, the launch alone, is what is timed) and runs
`gather_plain` for CPU tensors; on a CUDA tensor a failed build or launch
raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..accel import trace
from . import time_ms

# name -> (table shape, index shape, axis, column): the TPU probes' forms
# (_exp_gather_probe2.py:40-57, _exp_gather_probe.py:50-51)
FORMS = {
    "axis0 [8,128]": ((8, 128), (8, 128), 0, None),
    "axis0 [64,128]": ((64, 128), (8, 128), 0, None),
    "axis0 [512,128]": ((512, 128), (8, 128), 0, None),
    "axis0 [4096,128]": ((4096, 128), (8, 128), 0, None),
    "axis0 [512,1024]": ((512, 1024), (8, 1024), 0, None),
    "axis1 [8,1024]": ((8, 1024), (8, 1024), 1, None),
    "column [512,128]": ((512, 128), (8, 1024), 0, 0),
}
FILL_BYTES = 64 << 20       # output bytes a timed form reaches at least
PEAK_BYTES = 3.35e12        # the data sheet's HBM bytes/s

LAUNCHES = {"gather": 0}


def reset_launches():
    LAUNCHES["gather"] = 0


def build(defines: tuple = ()):
    """Build csrc/gather.cu (accel/trace.py build_library)."""
    return trace.build_library("gather.cu", "mitsuba_gather", defines)


def _library():
    return _bind(build()[0])


@functools.lru_cache(maxsize=None)
def _bind(path):
    fn = ctypes.CDLL(str(path)).mitsuba_gather
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def make_form(name: str, scale: int = 1, device="cuda"):
    """A form's table (np.random.default_rng(0) normals) and indices
    (default_rng(1) integers in range), the index rows times `scale`; on
    axis 1 the table's rows grow with them, as take_along_axis pairs the
    two."""
    tab_shape, idx_shape, axis, col = FORMS[name]
    rows = idx_shape[0] * scale
    if axis == 1:
        tab_shape = (rows, tab_shape[1])
    tab = np.random.default_rng(0).standard_normal(tab_shape, np.float32)
    extent = tab_shape[axis]
    idx = np.random.default_rng(1).integers(0, extent, (rows, idx_shape[1]),
                                            np.int32)
    return (torch.as_tensor(tab, device=device),
            torch.as_tensor(idx, device=device), axis, col)


def fill_scale(name: str) -> int:
    """The index-row scale at which the form's output reaches
    FILL_BYTES."""
    rows, cols = FORMS[name][1]
    return -(-FILL_BYTES // (4 * rows * cols))


def gather_plain(tab, idx, axis: int, col=None):
    """The forms by advanced indexing: axis 0, out[r, j] = tab[idx[r, j],
    j] (column `col` for every j where given); axis 1, out[r, j] = tab[r,
    idx[r, j]]."""
    if axis == 1:
        return tab[torch.arange(idx.shape[0], device=idx.device)[:, None],
                   idx.long()]
    if col is not None:
        return tab[idx.long(), col]
    return tab[idx.long(), torch.arange(idx.shape[1], device=idx.device)]


def gather_library(tab, idx64, axis: int, col=None):
    """One PyTorch call that computes the same function, on int64 indices
    (which torch.gather and torch.take take): the yardstick, called by
    nothing in the port."""
    if col is not None:
        return torch.take(tab[:, col], idx64)
    return torch.gather(tab, axis, idx64)


def gather(tab, idx, axis: int, col=None):
    """A form on CUDA tensors through the kernel (gather_plain on CPU
    tensors): tab [R, L] f32, idx [rows, cols] int32 with cols % 4 == 0.
    Raises where an index lies outside the table (one reduction each way),
    then launches."""
    if tab.device.type != "cuda":
        return gather_plain(tab, idx, axis, col)
    _check_form(tab, idx, axis, col)
    if idx.numel() and (int(idx.min()) < 0
                        or int(idx.max()) >= tab.shape[axis]):
        raise ValueError("an index lies outside the table")
    return launch(tab, idx, axis, col)


def launch(tab, idx, axis: int, col=None):
    """The kernel on CUDA tensors whose indices `gather` has checked (a
    timed loop checks them once, outside the loop); the shapes are checked
    here."""
    _check_form(tab, idx, axis, col)
    dev = tab.device
    rows, cols = idx.shape
    out = torch.empty(rows, cols, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _library()(tab.data_ptr(), tab.shape[1], idx.data_ptr(),
                         out.data_ptr(), rows, cols, axis,
                         -1 if col is None else col,
                         torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather kernel launch failed: cudaError_t {err}")
    LAUNCHES["gather"] += 1
    return out


def _check_form(tab, idx, axis, col):
    dev = tab.device
    rows, cols = idx.shape
    if tab.dim() != 2 or axis not in (0, 1) or cols % 4:
        raise ValueError("need a 2-D table, axis 0 or 1 and index rows of "
                         "a multiple of 4")
    trace.check_tensor(tab, "table", torch.float32, tuple(tab.shape), dev)
    trace.check_tensor(idx, "idx", torch.int32, (rows, cols), dev, align=16)
    if axis == 0 and col is None and cols != tab.shape[1]:
        raise ValueError(f"axis 0: index columns {cols} != table columns "
                         f"{tab.shape[1]}")
    if axis == 1 and (rows != tab.shape[0] or col is not None):
        raise ValueError("axis 1: index rows must equal table rows, no col")
    if col is not None and not 0 <= col < tab.shape[1]:
        raise ValueError(f"column {col} outside the table")


def form_bytes(tab, idx) -> int:
    """Bytes a form must move: the indices read and the output written
    once each, and the table read once."""
    return idx.numel() * 8 + tab.numel() * 4


def main():
    import subprocess
    if not torch.cuda.is_available():
        raise SystemExit("gather_probe: torch sees no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    for name in FORMS:
        tab, idx, axis, col = make_form(name, fill_scale(name))
        out = gather(tab, idx, axis, col)
        if not torch.equal(out, gather_plain(tab, idx, axis, col)):
            raise SystemExit(f"gather_probe: {name} differs from the plain "
                             "version")
        idx64 = idx.long()
        times = {"kernel": time_ms(lambda: launch(tab, idx, axis, col), 20),
                 "library": time_ms(lambda: gather_library(tab, idx64, axis,
                                                           col), 20)}
        gb = form_bytes(tab, idx) / 1e9
        print(f"{name} idx {tuple(idx.shape)}: kernel {times['kernel']:.4f}"
              f" ms, {gb / times['kernel'] * 1e3:.5g} GB/s; library "
              f"{times['library']:.4f} ms, {gb / times['library'] * 1e3:.5g}"
              f" GB/s; bound {form_bytes(tab, idx) / PEAK_BYTES * 1e3:.4f} "
              f"ms at 3.35 TB/s ({card})")


if __name__ == "__main__":
    main()
