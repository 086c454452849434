"""Reconstruction filter codes (port of mitsuba_tpu/film/rfilter.py). The
port splats with the box filter only; the other names are known so that
asking for one raises instead of rendering with the wrong filter."""
from __future__ import annotations

BOX = 0
TENT = 1
GAUSSIAN = 2
MITCHELL = 3
CATMULLROM = 4
LANCZOS = 5

NAMES = {"box": BOX, "tent": TENT, "gaussian": GAUSSIAN,
         "mitchell": MITCHELL, "catmullrom": CATMULLROM, "lanczos": LANCZOS}
