"""What the port's light-subpath tests share (imported as a module of
tests/, which pytest puts on the path): the Cornell box in both packages
at cluster size 128, camera rays from a numpy seed, a recorder of the
arrays a JAX function passes at run time, and the lane rules."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from mitsuba_tpu.scene import presets as jpresets
from mitsuba_tpu.scene.builder import compile_scene as jcompile
from mitsuba_tpu_torch.render import sample_camera
from mitsuba_tpu_torch.scene import presets as tpresets
from mitsuba_tpu_torch.scene.builder import compile_scene as tcompile

RES = 8
SEED = 3
CLUSTER = 128


def cornell():
    """(JAX scene, port scene on the CPU, port RES² camera)."""
    return (jcompile(jpresets.cornell_box(), cluster_size=CLUSTER),
            tcompile(tpresets.cornell_box(), cluster_size=CLUSTER,
                     device="cpu"),
            tpresets.cornell_camera(RES, RES))


def camera_rays(cam, n, seed=0):
    """n camera rays over the RES² film, pixel i % RES², jittered from a
    numpy seed: (o, d) as numpy [n, 3]."""
    rs = np.random.RandomState(seed)
    px = np.arange(n) % (RES * RES)
    pos = (np.stack([px % RES, px // RES], -1)
           + rs.rand(n, 2)).astype(np.float32)
    return tuple(x.numpy() for x in cam.sample_ray(torch.as_tensor(pos)))


def lanes_of_samples(cam, spp, seed=SEED):
    """spp samples of every pixel as lanes of one call, sample-major:
    (o, d, pixel ids, sample indices) as port tensors."""
    px = torch.arange(RES * RES).repeat(spp)
    samp = torch.arange(spp).repeat_interleave(RES * RES)
    _, o, d = sample_camera(cam, RES, seed, px, samp)
    return o, d, px, samp


def pixel_means(L, spp):
    """The box-filtered image [RES, RES, 3] of lanes_of_samples' L."""
    return L.reshape(spp, RES, RES, 3).mean(0).numpy()


def recorder(got, key, *arrays):
    """Record `arrays` under got[key] as numpy when the (jitted) program
    runs, through jax.debug.callback."""
    def save(*xs):
        got[key] = [np.array(x) for x in xs]
    jax.debug.callback(save, *arrays)


def record_offsets(mp, module, got, call=0):
    """Patch `module`'s offset_ray_origin so that its Python-level call
    number `call` records (p, n, d, the offset origin) in got["start"]:
    the emitter start of a light subpath, where that call builds its
    first ray."""
    orig = module.offset_ray_origin
    calls = []

    def wrapped(p, n, d):
        out = orig(p, n, d)
        if len(calls) == call:
            recorder(got, "start", p, n, d, out)
        calls.append(1)
        return out
    mp.setattr(module, "offset_ray_origin", wrapped)


def assert_start(er, o, start):
    """A sample_emitter_ray result er and its ray's offset origin o
    against a JAX caller's recorded (p, n, d, origin): the normal bit for
    bit (the same triangle row); the point and origin within 2.5e-7
    (about 2 ulps at the box's scale: XLA fuses the barycentric sums), the
    direction within 1e-5 (the concentric map's cos and sin round
    otherwise in XLA, and z = sqrt(1 - x² - y²) magnifies that near the
    horizon)."""
    p, n, d, origin = start
    assert np.array_equal(er.n.numpy(), n)
    assert np.abs(er.p.numpy() - p).max() <= 2.5e-7
    assert np.abs(o.numpy() - origin).max() <= 2.5e-7
    assert np.abs(er.d.numpy() - d).max() <= 1e-5


def jx(x):
    return jnp.asarray(np.asarray(x))


def assert_lanes(t, j, rtol=1e-4, floor=1e-3):
    """Every element of t within rtol of j, relative to max(|j|, floor)."""
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    rel = np.abs(t - j) / np.maximum(np.abs(j), floor)
    assert rel.max() <= rtol, (rel.max(), np.unravel_index(rel.argmax(),
                                                           rel.shape))


def tensors(*xs):
    return [torch.as_tensor(np.array(x)) for x in xs]


def assert_share(t, j, share=0.995, rtol=1e-4, cap=1e-3, floor=1e-3):
    """The share-of-lanes rule for values a walk carries over several
    bounces: on >= `share` of the rows every element within rtol of j,
    every element within cap (both relative to max(|j|, floor)). The
    emission and cosine-lobe directions differ by libm ulps between XLA
    and PyTorch (assert_start), and each bounce's hit point moves them
    on, so a few late hits differ by more than rtol."""
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    rel = np.abs(t - j) / np.maximum(np.abs(j), floor)
    rows = rel.reshape(rel.shape[0], -1).max(-1)
    assert (rows <= rtol).mean() >= share, (rows <= rtol).mean()
    assert rel.max() <= cap, rel.max()
