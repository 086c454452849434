"""sRGB transfer function (copy of core/spectrum.py::from_srgb of the JAX
package, on numpy arrays: it decodes 8-bit bitmap textures at load
time)."""
from __future__ import annotations

import numpy as np


def from_srgb(c):
    """sRGB-encoded values in [0, 1] → linear, float32."""
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / np.float32(12.92),
                    np.power((c + np.float32(0.055)) / np.float32(1.055),
                             np.float32(2.4))).astype(np.float32)
