"""mitsuba_tpu_torch — the PyTorch/CUDA port of the mitsuba_tpu path tracer.

Module paths mirror the JAX package (`mitsuba_tpu_torch/<pkg>/<mod>.py`
ports `mitsuba_tpu/<pkg>/<mod>.py`). The port imports torch and numpy only:
it shares no code with the JAX package, which stays the reference the tests
hold it against. Entry points (`scene.builder.compile_scene`, `render.render`)
run on the GPU unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
