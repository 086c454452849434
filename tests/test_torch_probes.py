"""The probes of mitsuba_tpu_torch/experiments on the CPU, against the TPU
probes of experiments/ (frozen there).

- e1 (the walk with no shading): its plain version at the probe's own
  inputs (40 random Woop rows, randn lanes, here 256 lanes and 3 steps)
  against a loop of the JAX probe's module-level `_trace`
  (experiments/_exp_roofline.py:62-88), loaded from its path.
- e0 (the fp32 ceiling): the probe's kernel body is nested inside
  e0_vpu_peak and runs only on a TPU, so the plain version is held to a
  numpy transcription of its chains (:22-36), and its single-rounding
  step (fma32, FFMA's) to exact rationals.
- the gathers: the plain versions of every form against
  np.take_along_axis (the column gather against table[idx, 0]).

The kernels themselves run only on the card (test_torch_kernels.py); here
the wrappers run their plain versions on CPU tensors.
"""
import importlib.util
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu_torch.experiments import gather_probe, roofline

torch.set_num_threads(2)

_EXP = Path(__file__).resolve().parents[1] / "experiments"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, _EXP / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_e1_plain_matches_jax_probe():
    """The JAX probe's loop body (_exp_roofline.py:96-106) around its
    `_trace`, step by step against e1_plain: the lanes that hit agree,
    their t within rel 1e-5, and the states after 3 steps too."""
    jexp = _load("_exp_roofline")
    b, steps = 256, 3
    w = np.random.RandomState(0).randn(3 * jexp.TC, 4).astype(np.float32)
    table = roofline.table_from_rows(w, jexp.TC, "cpu")
    st = roofline.probe_state(b, seed=1, device="cpu")
    out, hits, rays = roofline.e1_plain(table, st, steps, record=True)
    js = jnp.asarray(st.numpy())
    woop = jnp.asarray(w)[None]
    for s in range(steps):
        ox, oy, oz, dx, dy, dz = (js[k:k + 1] for k in range(6))
        mint = jnp.zeros_like(ox) + 1e-4
        maxt = jnp.full_like(ox, 1e30)
        t1 = jexp._trace(woop, jexp.TC, 1, ox, oy, oz, dx, dy, dz, mint,
                         maxt)
        t2 = jexp._trace(woop, jexp.TC, 1, ox + 0.1, oy, oz, -dx, -dy, -dz,
                         mint, maxt * 0.5)
        for jt, (_, _, _, _, pt) in zip((t1, t2), rays[2 * s:2 * s + 2]):
            jt = np.asarray(jt)[0]
            hit = jt < 1e30
            assert np.array_equal(hit, pt.numpy() < 1e30)
            np.testing.assert_allclose(pt.numpy()[hit], jt[hit], rtol=1e-5)
        assert hits[s].tolist() == [int((np.asarray(t1) < 1e30).sum()),
                                    int((np.asarray(t2) < 1e30).sum())]
        js = jnp.concatenate([ox + 0.001 * t1, oy, oz + 0.001 * t2, dx, dy,
                              dz], axis=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)
    assert 0 < hits[0, 0] < b


def test_e1_wrapper_runs_plain_on_cpu():
    """On CPU tensors e1 runs e1_plain, adds its hit counts and launches
    nothing."""
    table = roofline.probe_table(device="cpu")
    st = roofline.probe_state(128, device="cpu")
    roofline.reset_launches()
    hits = torch.zeros(2, 2, dtype=torch.int32)
    out = roofline.e1(table, st, 2, hits)
    ref, ref_hits = roofline.e1_plain(table, st, 2)
    assert torch.equal(out, ref) and torch.equal(hits, ref_hits)
    assert roofline.LAUNCHES["e1_trace_only"] == 0


def _e0_numpy(x, n_iter, fma):
    """_exp_roofline.py:22-36 in numpy. FMUL+FADD: float32 (Python floats
    are weak scalars, so every product and sum rounds to float32). FFMA:
    each step in float64, rounded once to float32. That is one rounding
    here, as FFMA's: with every value in [0.5, 2) and the float32
    constants, the product is a multiple of 2**-48 below 4, the constants
    multiples of 2**-47 or coarser, so the float64 sum (53 bits) is exact."""
    def step(v, k, c):
        if not fma:
            return v * k + c
        return (v.astype(np.float64) * float(np.float32(k))
                + float(np.float32(c))).astype(np.float32)
    a, b, c, d = (step(x, k, c) for k, c in
                  ((1.000001, 0.3), (0.999999, 0.1), (1.000002, 0.2),
                   (0.999998, 0.4)))
    for _ in range(n_iter):
        assert all(((0.5 <= v) & (v < 2)).all() for v in (a, b, c, d))
        a = step(a, 1.0000001, 1e-7)
        b = step(b, 0.9999999, 1e-7)
        c = step(c, 1.0000002, 1e-7)
        d = step(d, 0.9999998, 1e-7)
    return a + b + c + d


@pytest.mark.parametrize("fma", [False, True], ids=["fmul_fadd", "ffma"])
def test_e0_plain_matches_numpy(fma):
    """Each variant's plain version bit-equal to the numpy transcription,
    and the two variants apart on most lanes (one rounding a step against
    two), which the card tests and chip_smoke.py require of the kernels."""
    x = np.random.RandomState(2).rand(8, 128).astype(np.float32) + 0.5
    ref = _e0_numpy(x, 64, fma)
    assert ref.dtype == np.float32
    roofline.reset_launches()
    out = roofline.e0(torch.as_tensor(x), 64, fma).numpy()
    assert np.array_equal(out, ref)
    assert sum(roofline.LAUNCHES.values()) == 0
    assert roofline.e0_flops(x.size, 64) == 8 * x.size * 64
    assert (ref != _e0_numpy(x, 64, not fma)).mean() > 0.4


def _round32(exact):
    """The float32 nearest a Fraction, ties to even."""
    f = np.float32(float(exact))
    near = [np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf))]
    return min(near, key=lambda v: (abs(Fraction(float(v)) - exact),
                                    int(np.float32(v).view(np.int32)) & 1))


def test_fma32_rounds_once():
    """fma32 against a * k + c in exact rationals rounded once to float32,
    on 400 random triples over wide exponents and on halfway cases: a * k
    = 1 + 2**-11 + 2**-24 lies halfway between two float32s, and c = 2**-60
    moves the exact sum above it, which a float64 sum rounds away (two
    roundings give the lower neighbour, one gives the upper)."""
    a = np.float32(1 + 2 ** -12)
    for c, want in ((2.0 ** -60, 1 + 2 ** -11 + 2 ** -23),
                    (-(2.0 ** -60), 1 + 2 ** -11), (0.0, 1 + 2 ** -11)):
        got = roofline.fma32(torch.tensor([a]), float(a), c).item()
        assert got == want
    assert (torch.tensor([a]).double() * float(a) + 2.0 ** -60).float() \
        .item() == 1 + 2 ** -11
    rs = np.random.RandomState(5)
    n = 400
    av, kv, cv = ((rs.randn(n) * np.exp(rs.randn(n) * s)).astype(np.float32)
                  for s in (5, 5, 8))
    for a, k, c in zip(av, kv, cv):
        got = roofline.fma32(torch.tensor([a]), float(k), float(c)).item()
        exact = Fraction(float(a)) * Fraction(float(k)) + Fraction(float(c))
        assert np.float32(got) == _round32(exact), (a, k, c)


@pytest.mark.parametrize("name", list(gather_probe.FORMS))
def test_gather_plain_matches_numpy(name):
    """Every form at the probe's shapes (and with its index rows scaled)
    equals np.take_along_axis, or table[idx, col] for the column gather,
    exactly; the wrapper on CPU tensors is the plain version."""
    for scale in (1, 3):
        tab, idx, axis, col = gather_probe.make_form(name, scale, "cpu")
        t, i = tab.numpy(), idx.numpy()
        ref = (t[i, col] if col is not None
               else np.take_along_axis(t, i, axis))
        gather_probe.reset_launches()
        out = gather_probe.gather(tab, idx, axis, col)
        assert np.array_equal(out.numpy(), ref)
        assert gather_probe.LAUNCHES["gather"] == 0
        lib = gather_probe.gather_library(tab, idx.long(), axis, col)
        assert torch.equal(lib, out)
    assert gather_probe.fill_scale(name) * 4 * idx.shape[1] * \
        gather_probe.FORMS[name][1][0] >= gather_probe.FILL_BYTES
