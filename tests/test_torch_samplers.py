"""The port's samplers and reconstruction filters against the JAX package
on the CPU: sampler/sampler.py draws bit for bit, film/rfilter.py weights
and the film's K×K splat within float32 rounding. Inputs come from numpy
seeds and reach both packages as numpy arrays."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.film import rfilter as jrfilter
from mitsuba_tpu.film.film import Film as JFilm
from mitsuba_tpu.sampler import sampler as jsampler
from mitsuba_tpu_torch.film import rfilter as trfilter
from mitsuba_tpu_torch.film.film import Film as TFilm
from mitsuba_tpu_torch.sampler import sampler as tsampler

torch.set_num_threads(2)

KINDS = ["independent", "stratified", "ldsampler", "halton", "hammersley",
         "sobol"]
FILTERS = ["box", "tent", "gaussian", "mitchell", "catmullrom", "lanczos"]


def _pairs(spp):
    """4,096 (pixel, sample) pairs: pixel ids up to 2^20, sample indices
    in [0, spp)."""
    rs = np.random.RandomState(spp)
    pix = rs.randint(0, 1 << 20, 4096).astype(np.uint32)
    samp = rs.randint(0, spp, 4096).astype(np.uint32)
    return pix, samp


@pytest.mark.parametrize("spp", [1, 4, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_draws_bit_equal_jax(kind, spp):
    """draw_1d and draw_2d at dims 0-7 on 4,096 (pixel, sample) pairs,
    per-lane sample indices as the compacted wavefront passes them, and
    a scalar sample index as render passes it (JAX's halton loop needs
    the index at the pixels' shape, so JAX gets it broadcast): bit-equal
    to JAX."""
    pix, samp = _pairs(spp)
    tpix = torch.as_tensor(pix.astype(np.int64))
    tsamp = torch.as_tensor(samp.astype(np.int64))
    for dim in range(8):
        for fn in ("draw_1d", "draw_2d"):
            ref = np.asarray(getattr(jsampler, fn)(
                kind, 7, jnp.asarray(pix), jnp.asarray(samp), spp, dim))
            out = getattr(tsampler, fn)(kind, 7, tpix, tsamp, spp,
                                        dim).numpy()
            assert out.dtype == np.float32 and out.shape == ref.shape
            assert np.array_equal(out, ref), (fn, dim)
    ref = np.asarray(jsampler.draw_2d(
        kind, 3, jnp.asarray(pix), jnp.full(pix.shape, spp - 1, jnp.uint32),
        spp, 5))
    out = tsampler.draw_2d(kind, 3, tpix, spp - 1, spp, 5).numpy()
    assert np.array_equal(out, ref)


def test_sampler_kinds():
    """Every kind is known; an unknown name raises, in check_kind and in
    PathTracer."""
    from mitsuba_tpu_torch.integrator.path import PathTracer
    for kind in KINDS:
        tsampler.check_kind(kind)
        PathTracer(sampler=kind, spp=4)
    with pytest.raises(ValueError, match="unknown sampler 'pmj'"):
        PathTracer(sampler="pmj")


def test_kernel_gates_refuse_other_samplers():
    """The fused shade kernel and the megakernels draw the independent
    stream: the shade gate refuses another sampler (the JAX gate), and
    the megakernel integrators cannot be given one."""
    from mitsuba_tpu_torch.accel import shade_kernel
    from mitsuba_tpu_torch.integrator.mega import MegaPathTracer
    from mitsuba_tpu_torch.scene.builder import compile_scene
    from mitsuba_tpu_torch.scene.presets import cornell_box
    scene = compile_scene(cornell_box(), device="cpu")
    assert shade_kernel.supports(scene) == (True, "")
    ok, why = shade_kernel.supports(scene, "ldsampler")
    assert not ok and "independent" in why
    with pytest.raises(ValueError, match="independent"):
        MegaPathTracer(sampler="ldsampler", spp=4)


@pytest.mark.parametrize("name", FILTERS)
def test_eval_filter_matches_jax(name):
    """Each filter at 257 offsets across [-3.5, 3.5]: atol 1e-6."""
    x = np.linspace(-3.5, 3.5, 257).astype(np.float32)
    code = trfilter.NAMES[name]
    assert code == jrfilter.NAMES[name]
    assert trfilter.RADIUS[code] == jrfilter.RADIUS[code]
    ref = np.asarray(jrfilter.eval_filter(code, jnp.asarray(x)))
    out = trfilter.eval_filter(code, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", FILTERS)
def test_film_splat_matches_jax(name):
    """Splat 4,096 samples (some off the film, one NaN, one Inf) into
    16×12 with the filter, then develop: rtol 1e-5, atol 1e-6 (sums in
    another order)."""
    rs = np.random.RandomState(11)
    pos = (rs.rand(4096, 2) * [18, 14] - [1, 1]).astype(np.float32)
    val = rs.rand(4096, 3).astype(np.float32)
    val[7, 2] = np.nan
    pos[13, 1] = np.inf
    jf, tf = JFilm(16, 12, name), TFilm(16, 12, name)
    ja = jf.splat(jf.new_accumulator(), jnp.asarray(pos), jnp.asarray(val))
    ta = tf.splat(tf.new_accumulator("cpu"), torch.as_tensor(pos),
                  torch.as_tensor(val))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tf.develop(ta).numpy(),
                               np.asarray(jf.develop(ja)), rtol=1e-5,
                               atol=1e-6)
    assert (tf.radius, tf.ftype) == (jf.radius, jf.ftype)


def test_film_fields():
    """The JAX Film's fields, and an unknown filter refused."""
    f = TFilm(8, 4, "mitchell", banner=True, component_format="float16",
              compression="zips")
    assert (f.banner, f.component_format, f.compression) == (
        True, "float16", "zips")
    with pytest.raises(ValueError, match="sinc"):
        TFilm(8, 8, "sinc")
