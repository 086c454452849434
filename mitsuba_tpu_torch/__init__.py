"""mitsuba_tpu_torch — the PyTorch/CUDA port of the mitsuba_tpu path tracer.

Module paths mirror the JAX package (`mitsuba_tpu_torch/<pkg>/<mod>.py`
ports `mitsuba_tpu/<pkg>/<mod>.py`). The port imports torch and numpy only:
it shares no code with the JAX package, which stays the reference the tests
hold it against. Entry points (`scene.builder.compile_scene`, `render.render`)
run on the GPU unless the caller passes `device="cpu"`.
"""

import torch as _torch

__version__ = "0.1.0"

# PyTorch's CPU sqrt, exp, log, sin and cos go to MKL's vector math library,
# whose first use in a process is not safe from two threads at once: when
# that first call splits a tensor over PyTorch's threads (2,048 elements
# and up), the half that a worker thread computes has now and then come
# back accurate to about 12 bits (rel 3e-4; it failed
# tests/test_torch_core.py::test_math_helpers_match_jax). One call on a
# small tensor, made here on the importing thread, is that first use.
_torch.sqrt(_torch.ones(1))
