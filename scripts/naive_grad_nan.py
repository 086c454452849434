#!/usr/bin/env python3
"""Which entries of the naive reverse-mode gradient come out NaN on the
four-material scene (chip_smoke.py::four_materials_desc, spheres 8×16),
in the JAX package (jax.grad through PathTracer.li) and in the port
(loss.backward() through PathTracer.li), and whether PRB's are finite in
both: mean(li) over tests/test_torch_prb.py's 256 rays, max_depth 3.
CPU only:

    python3 scripts/naive_grad_nan.py
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_prb as t  # noqa: E402


def main():
    jscene = t.jb.compile_scene(t.four_materials_desc(
        t.jb.SceneDesc, t.jtf, t.jshapes, (8, 16)))
    o, d = t._four_rays()
    px = np.arange(t.N, dtype=np.uint32)
    path = t.JPath(max_depth=t.DEPTH).specialized_for(jscene)

    def loss(mat, em):
        return jnp.mean(path.li(jscene._replace(mat_params=mat,
                                                em_radiance=em),
                                jnp.asarray(o), jnp.asarray(d),
                                jnp.uint32(0), jnp.asarray(px), 0))

    jg_mat, jg_em = (np.asarray(g) for g in jax.jit(jax.grad(
        loss, argnums=(0, 1)))(jscene.mat_params, jscene.em_radiance))
    _, g_mat, g_em = t._naive(t._carry(jscene), o, d, px, t.DEPTH)
    _, prb = t._port_prb(t._carry(jscene), o, d, px,
                         np.full((t.N, 3), 1.0 / (t.N * 3), np.float32),
                         t.DEPTH)
    print("JAX naive: NaN entries of mat_params",
          np.argwhere(~np.isfinite(jg_mat)).tolist(),
          "em_radiance finite", bool(np.isfinite(jg_em).all()))
    print("port naive: NaN entries of mat_params",
          np.argwhere(~np.isfinite(g_mat.numpy())).tolist(),
          "em_radiance finite", bool(np.isfinite(g_em.numpy()).all()))
    print("port PRB finite:", all(bool(np.isfinite(g.numpy()).all())
                                  for g in prb.values()))


if __name__ == "__main__":
    main()
