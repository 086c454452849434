"""Port core modules (mitsuba_tpu_torch.core, .sampler) against the JAX
package on the CPU, plus the check that the port stands alone.

Inputs come from numpy seeds and reach both packages as numpy arrays."""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import distribution as jdist
from mitsuba_tpu.core import math as jmath
from mitsuba_tpu.core import rng as jrng
from mitsuba_tpu.core import warp as jwarp
from mitsuba_tpu.sampler import sampler as jsampler
from mitsuba_tpu_torch.core import distribution as tdist
from mitsuba_tpu_torch.core import math as tmath
from mitsuba_tpu_torch.core import rng as trng
from mitsuba_tpu_torch.core import warp as twarp
from mitsuba_tpu_torch.sampler import sampler as tsampler

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
N = 100_000


def _counters(seed=0):
    """10⁵ counter tuples over the full uint32 range (words ≥ 2³¹ too)."""
    rs = np.random.RandomState(seed)
    words = rs.randint(0, 2**32, size=(4, N), dtype=np.uint64)
    words[:, 0] = 0
    words[:, 1] = 2**31
    words[:, 2] = 2**32 - 1
    words[:, 3] = 2**32 - 0x9E3779B9    # samp + 0x9E3779B9 wraps to 0
    return words


def test_pcg4d_bit_exact():
    v = _counters(1).T                                  # [N, 4]
    ref = np.asarray(jrng.pcg4d(jnp.asarray(v.astype(np.uint32))))
    out = trng.pcg4d(torch.as_tensor(v.astype(np.int64))).numpy()
    assert np.array_equal(out.astype(np.uint32), ref)


@pytest.mark.parametrize("fn", ["sample_1d", "sample_2d"])
def test_sample_bit_exact(fn):
    seed, idx, dim, samp = _counters(2)
    ref = np.asarray(getattr(jrng, fn)(
        *(jnp.asarray(w.astype(np.uint32)) for w in (seed, idx, dim, samp))))
    out = getattr(trng, fn)(*(torch.as_tensor(w.astype(np.int64))
                              for w in (seed, idx, dim, samp))).numpy()
    assert out.dtype == np.float32
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("fn", ["draw_1d", "draw_2d"])
def test_independent_draws(fn):
    """Scalar seed/sample/dim broadcast against a pixel vector, as the
    integrator calls them. rtol 1e-6 (the draws are in fact bit-equal)."""
    pix = np.arange(4096, dtype=np.uint32) * 977
    ref = np.asarray(getattr(jsampler, fn)(
        "independent", 11, jnp.asarray(pix), 3, 0, 12))
    out = getattr(tsampler, fn)("independent", 11,
                                torch.as_tensor(pix.astype(np.int64)),
                                3, 0, 12).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


def test_unported_sampler_raises():
    """Every sampler of the JAX package is ported: only a name it does
    not know raises."""
    from mitsuba_tpu_torch.integrator.path import PathTracer
    with pytest.raises(ValueError, match="stratified2"):
        PathTracer(sampler="stratified2")
    PathTracer(sampler="stratified")
    tsampler.check_kind("independent")


def _unit(rs, n):
    v = rs.randn(n, 3)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def test_frame_matches_jax():
    """Duff basis, to_local and to_world: rtol 1e-6 (atol 1e-6 near 0)."""
    rs = np.random.RandomState(3)
    n, v = _unit(rs, 4096), rs.randn(4096, 3).astype(np.float32)
    jf = jmath.Frame.from_normal(jnp.asarray(n))
    tf = tmath.Frame.from_normal(torch.as_tensor(n))
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    for name in ("to_local", "to_world"):
        out = getattr(tmath.Frame, name)(tf, torch.as_tensor(v)).numpy()
        ref = np.asarray(getattr(jmath.Frame, name)(jf, jnp.asarray(v)))
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_math_helpers_match_jax():
    rs = np.random.RandomState(4)
    a = rs.randn(4096, 3).astype(np.float32)
    a[0] = 0.0
    b = (rs.randn(4096) * 1e-7).astype(np.float32)
    np.testing.assert_allclose(tmath.normalize(torch.as_tensor(a)).numpy(),
                               np.asarray(jmath.normalize(jnp.asarray(a))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tmath.safe_div(torch.as_tensor(a[:, 0]), torch.as_tensor(b)).numpy(),
        np.asarray(jmath.safe_div(jnp.asarray(a[:, 0]), jnp.asarray(b))),
        rtol=1e-6)
    np.testing.assert_allclose(
        tmath.safe_sqrt(torch.as_tensor(a[:, 0])).numpy(),
        np.asarray(jmath.safe_sqrt(jnp.asarray(a[:, 0]))), rtol=1e-6)


@pytest.mark.parametrize("fn", ["square_to_cosine_hemisphere",
                                "square_to_uniform_triangle",
                                "square_to_uniform_disk_concentric"])
def test_warps_match_jax(fn):
    """rtol 1e-6, atol 1e-6: sin/cos may differ in the last ulp. The
    hemisphere's lifted z = sqrt(1 - x² - y²) cancels near the rim, where
    such an ulp becomes up to ~4e-6 absolute, so z alone gets atol 1e-5."""
    u = np.random.RandomState(5).rand(8192, 2).astype(np.float32)
    u[0] = 0.5          # the concentric map's center
    out = getattr(twarp, fn)(torch.as_tensor(u)).numpy()
    ref = np.asarray(getattr(jwarp, fn)(jnp.asarray(u)))
    np.testing.assert_allclose(out[:, :2], ref[:, :2], rtol=1e-6, atol=1e-6)
    if fn == "square_to_cosine_hemisphere":
        np.testing.assert_allclose(out[:, 2], ref[:, 2], rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_allclose(
            twarp.square_to_cosine_hemisphere_pdf(torch.as_tensor(out)),
            np.asarray(jwarp.square_to_cosine_hemisphere_pdf(
                jnp.asarray(out))), rtol=1e-6, atol=1e-6)


def test_discrete1d_matches_jax():
    """Table build exact; sample_reuse index exact, u and pmf rtol 1e-6."""
    rs = np.random.RandomState(6)
    w = rs.rand(17)
    w[3] = 0.0
    u = rs.rand(8192).astype(np.float32)
    jd, td = jdist.Discrete1D.build(w), tdist.Discrete1D.build(w)
    for a, b in zip(td, jd):
        assert np.array_equal(a.numpy(), np.asarray(b))
    ji, ju, jp = jd.sample_reuse(jnp.asarray(u))
    ti, tu, tp = td.sample_reuse(torch.as_tensor(u))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)


def _port_sources():
    files = sorted((REPO / "mitsuba_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_stands_alone():
    """No module of the port, nor chip_smoke.py, imports jax or the JAX
    package (mitsuba_tpu_torch itself is allowed)."""
    bad = []
    files = _port_sources()
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "mitsuba_tpu"):
                    bad.append(f"{path.relative_to(REPO)}: {name}")
    assert not bad, bad
