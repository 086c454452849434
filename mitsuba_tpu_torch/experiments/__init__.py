"""Ports of the TPU probes under experiments/ (frozen there): roofline.py
(the fp32 ceiling and the cluster walk's rate with no shading),
gather_probe.py (per-lane table loads) and ablate.py (the megakernel
bounce's cost by component: n kept-alive bounces with the closest walk,
the shadow walk, the hit row or the shading stubbed). Each kernel runs on
CUDA tensors and its plain PyTorch version on CPU tensors; no path of the
program calls them. Run one on the card with, e.g.,
`python3 -m mitsuba_tpu_torch.experiments.roofline`. time_ms times a
kernel for them and for chip_smoke.py."""

import torch


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
