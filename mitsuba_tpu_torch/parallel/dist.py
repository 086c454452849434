"""Multi-device rendering and gradients over torch.distributed (port of
mitsuba_tpu/parallel/dist.py, which shards with shard_map and sums with
psum).

One process a rank. Every rank holds the whole compiled scene (broadcast
from rank 0 by replicate_scene) and renders a contiguous slice of the
padded pixel axis, with the pixels' global ids, so each (pixel, sample)
draws the sample stream render_fn gives it. Each rank splats into a
full-size film accumulator; one all_reduce(SUM) adds them. Gradients
with respect to the scene's parameter tables are each rank's local
backward, taken at the global image, summed with one all_reduce a table.

The backend is the caller's choice or, by default, "gloo" for CPU
tensors and "nccl" for CUDA tensors, one card a rank. Gloo also takes
CUDA tensors, so several ranks can share one card where the caller asks
for it (backend="gloo"). `launch` starts the ranks of one job as
processes (the spawn start method) over a file:// rendezvous.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..film.film import Film
from ..render import integrator_sampler, sample_camera
from ..scene.scene import SceneData

# the backend for a rank's device type, where the caller names none
BACKENDS = {"cpu": "gloo", "cuda": "nccl"}


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the job (the JAX Mesh's counterpart): its rank,
    the world size, the torch device it renders on, the backend and the
    process group."""
    rank: int
    size: int
    device: torch.device
    backend: str
    group: object = dataclasses.field(repr=False, compare=False)


def make_mesh(device="cuda", group=None) -> Mesh:
    """The Mesh over an initialized process group (the default group
    where `group` is None). device: the rank's device; "cuda" without an
    index takes card rank % device_count. Raises RuntimeError without an
    initialized group, and ValueError for NCCL on other than one card a
    rank."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh: torch.distributed has no initialized process "
            "group; call init_group or torch.distributed."
            "init_process_group first")
    group = dist.group.WORLD if group is None else group
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    backend = dist.get_backend(group)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if backend == "nccl" and (dev.type != "cuda"
                              or size > torch.cuda.device_count()):
        raise ValueError(
            f"NCCL needs one card a rank: {size} ranks, "
            f"{torch.cuda.device_count()} cards, device {dev}; pass "
            f"backend='gloo' to put several ranks on one card")
    return Mesh(rank, size, dev, backend, group)


def init_group(rank: int, size: int, init_method: str, device="cuda",
               backend=None) -> Mesh:
    """Initialize the default process group of a job of `size` ranks as
    rank `rank` (init_method: e.g. "file:///tmp/x/rendezvous" or
    "tcp://localhost:29500"), with `backend` or BACKENDS' for the device
    type, and return its Mesh (make_mesh)."""
    dev = resolve_device(device)
    backend = BACKENDS[dev.type] if backend is None else backend
    if backend == "nccl" and dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size)
    return make_mesh(device)


def _tensors(tree):
    """The tensors of a SceneData (its em_pmf included), in field order."""
    out = []
    for v in tree:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, tuple):
            out.extend(_tensors(v))
    return out


def _rebuild(tree, it):
    """tree with each tensor replaced by the next of `it`."""
    vals = []
    for v in tree:
        if isinstance(v, torch.Tensor):
            v = next(it)
        elif isinstance(v, tuple):
            v = _rebuild(v, it)
        vals.append(v)
    return type(tree)(*vals)


def replicate_scene(scene: SceneData, mesh: Mesh) -> SceneData:
    """Rank 0's scene on every rank, on the rank's device (the JAX
    device_put with a replicated sharding): every tensor's bytes in one
    broadcast. Every rank passes a scene of the same tables (the same
    compiled description); a rank whose tables differ in size raises,
    on every rank."""
    tensors = [t.detach().to(mesh.device).contiguous() for t in
               _tensors(scene)]
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])
    size = torch.tensor([flat.numel()], dtype=torch.int64,
                        device=mesh.device)
    dist.broadcast(size, 0, group=mesh.group)
    bad = (size != flat.numel()).to(torch.int64)
    dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=mesh.group)
    if bad.item():
        raise ValueError("replicate_scene: the ranks' scenes differ in size")
    dist.broadcast(flat, 0, group=mesh.group)
    out, at = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        # a copy of its own, aligned as the kernels' checks want it
        out.append(flat[at:at + nbytes].clone().view(t.dtype)
                   .reshape(t.shape))
        at += nbytes
    return _rebuild(scene, iter(out))


def shard_pixels(n: int, mesh: Mesh):
    """This rank's global pixel ids [chunk] int64 of the pixel axis of n
    padded to a multiple of the world size (n_pad = chunk · size), and
    which of them are real pixels (< n)."""
    chunk = -(-n // mesh.size)
    px = torch.arange(mesh.rank * chunk, (mesh.rank + 1) * chunk,
                      device=mesh.device)
    return px, px < n


def _accumulate(scene: SceneData, camera, film: Film, integrator, spp: int,
                seed: int, mesh: Mesh):
    """This rank's film accumulator [H, W, 4]: its pixels' spp sample
    passes, padded lanes splatted with radiance 0 at -100 (off the
    film), as the JAX render_sharded."""
    if scene.device != mesh.device:
        raise ValueError(f"scene lives on {scene.device}, the rank renders "
                         f"on {mesh.device}")
    px, valid = shard_pixels(film.height * film.width, mesh)
    specialize = getattr(integrator, "specialized_for", None)
    if specialize is not None:      # read the scene's families once
        integrator = specialize(scene)
    accum = film.new_accumulator(mesh.device)
    for s in range(spp):
        pos, o, d = sample_camera(camera, film.width, seed, px, s,
                                  *integrator_sampler(integrator))
        radiance = integrator.li(scene, o, d, seed, px, s)
        film.splat(accum, torch.where(valid[:, None], pos, -100.0),
                   torch.where(valid[:, None], radiance, 0.0))
    return accum


def render_sharded(scene: SceneData, camera, film: Film, integrator,
                   spp: int, seed: int, mesh: Mesh):
    """Distributed render: the developed [H, W, 3] image on every rank.
    The pixel axis is padded to a multiple of the world size and rank r
    renders the global ids [r · chunk, (r + 1) · chunk) for every pass;
    the ranks' full-size accumulators are summed with one all_reduce."""
    accum = _accumulate(scene, camera, film, integrator, spp, seed, mesh)
    dist.all_reduce(accum, group=mesh.group)
    return film.develop(accum)


class _SumOverRanks(torch.autograd.Function):
    """The all_reduce(SUM) of the ranks' accumulators. Every rank forms
    the same loss of the same sum, so ∂loss/∂(rank's accumulator) is the
    cotangent that comes in, on every rank, and the backward passes it
    through as it is: summing the ranks' cotangents here as well as their
    parameter gradients after the backward would count each world-size
    times (the factor JAX dist.py:141-145 warns of)."""

    @staticmethod
    def forward(ctx, accum, group):
        total = accum.clone()
        dist.all_reduce(total, group=group)
        return total

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def render_grad_sharded(scene: SceneData, camera, film: Film, integrator,
                        spp: int, seed: int, mesh: Mesh, loss_fn=None,
                        diff_leaves=("mat_params", "em_radiance")):
    """One distributed training step: (loss, {leaf: gradient}) on every
    rank, loss = loss_fn(develop(Σ_r accumulator_r)) (the mean by
    default) and each gradient the sum over ranks of the rank's local
    backward through its own passes (autograd through integrator.li),
    with ∂loss/∂image taken at the global image. One all_reduce of the
    accumulator forward, one of each leaf's gradient after."""
    loss_fn = torch.mean if loss_fn is None else loss_fn
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_()
              for k in diff_leaves}
    with torch.enable_grad():
        accum = _accumulate(scene._replace(**leaves), camera, film,
                            integrator, spp, seed, mesh)
        loss = loss_fn(film.develop(_SumOverRanks.apply(accum, mesh.group)))
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    out = {}
    for (k, leaf), g in zip(leaves.items(), grads):
        g = torch.zeros_like(leaf) if g is None else g.contiguous()
        dist.all_reduce(g, group=mesh.group)
        out[k] = g
    return loss.detach(), out


# ---------------------------------------------------------------------------
# the ranks of one job as processes
# ---------------------------------------------------------------------------

def _to_host(x):
    """x with every tensor a numpy array (results cross the process
    boundary by value)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(rank, size, init_method, device, backend, fn, args, out_dir):
    """One rank: one torch thread, the process group, fn(mesh, *args),
    its result pickled to out_dir/<rank>.pkl."""
    torch.set_num_threads(1)
    mesh = init_group(rank, size, init_method, device, backend)
    try:
        out = _to_host(fn(mesh, *args))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def launch(fn, size: int, *args, device="cuda", backend=None,
           timeout: float = 900.0):
    """Run fn(mesh, *args) on `size` ranks, each a process of the spawn
    start method (safe where the caller has initialized CUDA) with one
    torch thread, over a file:// rendezvous in a temporary directory;
    device and backend as init_group takes them. fn is a module-level
    function (it is pickled by name) of a module that imports no more
    than the ranks need. Returns the ranks' results in rank order, every
    tensor in them a numpy array. Where a rank fails, raises
    torch.multiprocessing's ProcessRaisedException (with the rank's
    traceback) or ProcessExitedException, and RuntimeError where the
    ranks have not all finished after `timeout` seconds; stops every
    rank it started. Kernel libraries the ranks load are best built
    first (the accel modules' build): ranks on a fresh tree would each
    run nvcc."""
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        ranks = torch.multiprocessing.start_processes(
            _rank_main, (size, init, str(device), backend, fn, args, tmp),
            nprocs=size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ranks.join(max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"launch: the ranks did not finish "
                                       f"in {timeout} s")
        finally:
            for p in ranks.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for rank in range(size):
            with open(os.path.join(tmp, f"{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
