"""The ablation probe's port (mitsuba_tpu_torch/experiments/ablate.py, the
plain versions of csrc/ablate.cu's seven variants) against the JAX bounce
it was written for, on the CPU.

experiments/_exp_ablate.py cannot be imported (its line 78 reads
mk._bounce_math, which is gone), so this file writes its probe loop
itself: the JAX _bounce_rows (mitsuba_tpu/accel/megakernel.py:606) with
families (0, 2), rr_depth 99, max_depth 0 (unbounded), seed 1, pixel = lane,
sample 0 and bounce = the step, followed by the keep-alive step of
_exp_ablate.py:129-135; the stubs of :37-103 are rewritten for today's
_trace_inline (:442) and 25-row hit record (N_ATTR), and swapped in with
monkeypatch. _bounce_rows runs under jax.jit on plain arrays: its refs are
only indexed, and on the CPU backend its Pallas ops (pl.reciprocal,
pltpu.bitcast) lower outside a kernel. The six variants that stub traces
share one compile: the stub reads the variant's flags at run time and
selects between the stubbed and the real values with jnp.where, so each
variant computes exactly what its own stub would. The consts are the
scene's own (MegaPathTracer.for_scene: no environment on the Cornell box).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu.accel.megakernel as jmk
from mitsuba_tpu.integrator.mega import MegaPathTracer as JMega
from mitsuba_tpu.scene import presets as jpresets
from mitsuba_tpu.scene.builder import compile_scene as jcompile
from mitsuba_tpu_torch.accel import megakernel as tmk
from mitsuba_tpu_torch.experiments import ablate
from mitsuba_tpu_torch.integrator.mega import MegaPathTracer
from mitsuba_tpu_torch.scene import presets as tpresets
from mitsuba_tpu_torch.scene.builder import compile_scene as tcompile

torch.set_num_threads(2)

LANES, STEPS = 256, 3
FAMILIES = (0, 2)           # _exp_ablate.py:124
# variant -> the JAX stub's flags (make_stub_trace's arguments, :37-38):
# skip_closest, skip_shadow, skip_attr, transform_only
FLAGS = {ablate.FULL: (0, 0, 0, 0), ablate.NO_SHADOW: (0, 1, 0, 0),
         ablate.NO_CLOSEST: (1, 0, 0, 0), ablate.NO_TRACES: (1, 1, 0, 0),
         ablate.NO_ATTR: (0, 0, 1, 0), ablate.TRANSFORM: (0, 0, 0, 1)}


def _fixed_attr(ox):
    """The stub hit record [N_ATTR, B] in today's rows (the docstring's
    intent, :26-27): ng = vn0 = +y, mat 0, em_id -1, the rest 0."""
    z = jnp.zeros((1, ox.shape[-1])) + 0.0 * ox[0:1]
    rows = [z] * jmk.N_ATTR
    rows[1] = rows[6] = z + 1.0
    rows[4] = z - 1.0
    return jnp.concatenate(rows, axis=0)


def _stub_trace(flags, orig):
    """make_stub_trace (:37-78) for today's _trace_inline, its four
    switches read from `flags` at run time."""
    skip_closest, skip_shadow, skip_attr, transform_only = (
        flags[k] > 0 for k in range(4))

    def trace(woop, tc, c_clusters, ox, oy, oz, dx, dy, dz, mint, maxt,
              attr_ref=None, need_uv=True, aabb_ref=None):
        one = jnp.full((1, ox.shape[-1]), 1.0) + 0.0 * ox[0:1]
        if attr_ref is None:                    # a shadow ray
            t, _ = orig(woop, tc, c_clusters, ox, oy, oz, dx, dy, dz, mint,
                        maxt, None, aabb_ref=aabb_ref)
            return jnp.where(skip_shadow, one, t), None
        t, attr, u, v = orig(woop, tc, c_clusters, ox, oy, oz, dx, dy, dz,
                             mint, maxt, attr_ref, need_uv=need_uv,
                             aabb_ref=aabb_ref)
        acc = jnp.zeros((1, ox.shape[-1]))      # transform only (:47-68)
        for c in range(c_clusters):
            w = woop[c]

            def comp(k):
                w0 = w[k * tc:(k + 1) * tc, 0:1]
                w1 = w[k * tc:(k + 1) * tc, 1:2]
                w2 = w[k * tc:(k + 1) * tc, 2:3]
                tr = w[k * tc:(k + 1) * tc, 3:4]
                return (w0 * ox + w1 * oy + w2 * oz + tr,
                        w0 * dx + w1 * dy + w2 * dz)

            opx, dpx = comp(0)
            opy, dpy = comp(1)
            opz, dpz = comp(2)
            acc = acc + jnp.min(opx + opy + opz + dpx + dpy + dpz, axis=0,
                                keepdims=True)
        t = jnp.where(skip_closest, one,
                      jnp.where(transform_only, 1.0 + 0.0 * acc, t))
        attr = jnp.where(skip_closest | skip_attr | transform_only,
                         _fixed_attr(ox), attr)
        if need_uv:
            stubbed = skip_closest | skip_attr | transform_only
            u, v = jnp.where(stubbed, 0.0, u), jnp.where(stubbed, 0.0, v)
        return t, attr, u, v
    return trace


def _bounce_noshade(woop, tc, c_clusters, attr_tab, st):
    """_bounce_noshade (:81-103) for today's _trace_inline."""
    ox, oy, oz = st[0:1], st[1:2], st[2:3]
    dx, dy, dz = st[3:4], st[4:5], st[5:6]
    mint = 1e-4 * (1.0 + jnp.abs(ox))
    maxt = jnp.full_like(mint, 1e30)
    t_best, attr, _, _ = jmk._trace_inline(woop, tc, c_clusters, ox, oy, oz,
                                           dx, dy, dz, mint, maxt, attr_tab,
                                           need_uv=False)
    t_sh, _ = jmk._trace_inline(woop, tc, c_clusters, ox + 0.01, oy, oz,
                                dy, dz, dx, mint, maxt * 0.5, None)
    t_safe = jnp.where(t_best < 1e30, t_best, 1.0)
    return jnp.concatenate([
        ox + 0.001 * t_safe * dx, oy + 0.001 * t_safe * dy,
        oz + 0.001 * t_safe * dz, dx, dy, dz, st[6:9] * 0.999,
        st[9:12] + 0.0001 * attr[0:3], st[12:13], st[13:16]], axis=0)


def _keep_alive(new16):
    """:129-135."""
    return jnp.concatenate([
        new16[0:6], jnp.maximum(new16[6:9], 0.25), new16[9:12] * 0.0,
        jnp.ones((1, new16.shape[1])), new16[13:16]], axis=0)


def _jax_loop(tables, consts, shade):
    """The probe's loop over STEPS steps as a jitted function of (flags,
    st0, pix, samp): the state after each step, [STEPS, 16, B]. shade:
    _bounce_rows (with the stubbed trace), else _bounce_noshade."""
    c_clusters = tables.woop.shape[0]

    def run(flags, st0, pix, samp):
        def body(i, carry):
            st, hist = carry
            if shade:
                new, _, _ = jmk._bounce_rows(
                    tables.tc, c_clusters, FAMILIES, 99, 0, tables.m_real,
                    tables.et_real, tables.em_count, tables.smooth,
                    tables.woop, tables.aabb, tables.attr, tables.mat,
                    tables.em_rows, tables.em_meta, consts, pix, samp,
                    jnp.int32(1), i, tuple(st[k:k + 1] for k in range(16)))
                new16 = jnp.concatenate(new, axis=0)
            else:
                new16 = _bounce_noshade(tables.woop, tables.tc, c_clusters,
                                        tables.attr, st)
            st = _keep_alive(new16)
            return st, hist.at[i].set(st)

        hist = jnp.zeros((STEPS,) + st0.shape)
        return jax.lax.fori_loop(0, STEPS, body, (st0, hist))[1]
    return run


@pytest.fixture(scope="module")
def probe():
    """(port tables, {variant: JAX states [STEPS, 16, LANES]}) on the
    Cornell box (cluster_size 64, as :179) from the probe's start state."""
    jscene = jcompile(jpresets.cornell_box(), cluster_size=64)
    jint = JMega.for_scene(jscene, max_depth=8)
    consts = tuple(float(x) for x in jint.meta_consts[:9])
    st0 = ablate.probe_state(LANES, "cpu").numpy()
    pix = np.arange(LANES, dtype=np.int32)[None]
    samp = np.zeros((1, LANES), np.int32)
    orig = jmk._trace_inline
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        flags_box = []
        mp.setattr(jmk, "_trace_inline",
                   lambda *a, **k: _stub_trace(flags_box[0], orig)(*a, **k))

        def traced(flags, st, p, s):
            flags_box[:] = [flags]
            return _jax_loop(jint.tables, consts, True)(flags, st, p, s)
        shade = jax.jit(traced)
        for v, flags in FLAGS.items():
            out[v] = np.asarray(shade(jnp.asarray(flags, jnp.int32), st0,
                                      pix, samp))
    out[ablate.NO_SHADE] = np.asarray(jax.jit(_jax_loop(
        jint.tables, consts, False))(jnp.zeros(4, jnp.int32), st0, pix,
                                     samp))
    tscene = tcompile(tpresets.cornell_box(), cluster_size=64, device="cpu")
    return MegaPathTracer.for_scene(tscene, max_depth=8).tables, out


# The tolerance of a state row: |port - JAX| <= ATOL + RTOL·|JAX|. The two
# bounces differ in rounding only, but the JAX walk's t is not the port's:
# on the CPU its approximate reciprocal and one Newton step (:486-487) leave
# t ~1e-5 off the port's division, which moves a hit point up to ~7e-6
# (the Cornell box is a unit cube) and its next direction and pdf by
# ~2e-7; three steps keep it there.
ATOL, RTOL = 2e-5, 1e-4


@pytest.mark.parametrize("variant", range(len(ablate.VARIANTS)),
                         ids=ablate.NAMES)
def test_variant_matches_jax(probe, variant):
    """run_fixed's plain version, one step at a time from the probe's
    start state, against the JAX loop with the same stub, every lane after
    each of STEPS steps. Lanes whose closest ray has missed (the probe's
    origin is the box's corner (0, 1, 0), so most rays leave at once) are
    held to the same rule but for two rows where the two packages' miss
    records differ: the port reads triangle 0's row (dense.
    fill_intersection, as PathTracer does), the JAX kernel an all-zero
    row, so the port offsets the next origin by 1e-4·(1 + max|p|) along
    triangle 0's normal (+y, the floor) where the JAX kernel does not
    (o.y is held to the sum of those offsets), and its prev_pdf is the
    diffuse pdf in that triangle's frame where the JAX one is 0 (row 13
    is not compared there). L is 0 after every step (the keep-alive)."""
    tables, jout = probe
    st = ablate.probe_state(LANES, "cpu")
    missed = np.zeros(LANES, bool)
    offset = np.zeros(LANES)
    for k in range(STEPS):
        out = ablate.run_fixed(tables, st, 1, variant, bounce0=k)
        st = out[:16]
        p, j = st.numpy(), jout[variant][k]
        missed |= out[16].numpy() == 0
        offset += 1e-4 * (1.0 + np.abs(p[0:3]).max(0))
        tol = ATOL + RTOL * np.abs(j)
        tol[1] = np.where(missed, tol[1] + offset, tol[1])
        ok = np.abs(p - j) <= tol
        ok[13] |= missed
        assert ok.all(), (k, np.argwhere(~ok)[:8].tolist())
        assert (p[9:12] == 0).all() and (p[12] == 1).all()
    if variant in (ablate.NO_CLOSEST, ablate.NO_TRACES, ablate.TRANSFORM):
        assert not missed.any()       # the stub hit is found on every lane


def test_probe_state():
    """probe_state against a numpy transcription of :143-150."""
    b = 64
    st0 = np.zeros((16, b), np.float32)
    st0[1] = 1.0
    st0[3:6] = np.random.default_rng(0).normal(size=(3, b))
    st0[3:6] /= np.linalg.norm(st0[3:6], axis=0, keepdims=True)
    st0[6:9] = 1.0
    st0[12] = 1.0
    st0[13] = 1.0
    st0[15] = 1.0
    np.testing.assert_array_equal(ablate.probe_state(b, "cpu").numpy(), st0)


def test_stub_record():
    """The stub record's 25 rows in N_ATTR's layout (accel/megakernel.py:
    ng 0:3, mat_id 3, em_id 4, vn0 5:8, vn1 - vn0 8:11, vn2 - vn0 11:14,
    emitter radiance, area, pmf 14:19, uv0 19:21, uv1 - uv0 21:23, uv2 -
    uv0 23:25): the JAX stub's rows here, and the one-triangle scene row
    the plain version reads packed as build_mega_tables packs tri_attr
    (megakernel.py:209-218)."""
    rec = ablate.stub_record().numpy()
    assert rec.shape == (tmk.N_ATTR,) == (25,)
    want = np.zeros(25, np.float32)
    want[0:3] = want[5:8] = (0.0, 1.0, 0.0)      # ng, vn0: +y
    want[3], want[4] = 0.0, -1.0                 # material 0, no emitter
    np.testing.assert_array_equal(rec, want)
    np.testing.assert_array_equal(
        np.asarray(_fixed_attr(jnp.zeros((1, 1))))[:, 0], want)
    a = ablate._stub_scene("cpu").tri_attr[0].numpy()
    packed = np.concatenate([a[0:3], a[18:20], a[3:6], a[6:9] - a[3:6],
                             a[9:12] - a[3:6], np.zeros(5, np.float32),
                             a[12:14], a[14:16] - a[12:14],
                             a[16:18] - a[12:14]])
    np.testing.assert_array_equal(packed, want)
