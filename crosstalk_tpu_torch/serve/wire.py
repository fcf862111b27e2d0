"""Wire-format numerics shared by the serving client and server (the port's
copy of crosstalk_tpu/serve/wire.py).

The serving protocol ships RAW intensities and lets the device min-max
normalize per (tile, channel) (reference semantics, train_model.py:211-216).
That normalization is invariant under any positive per-(tile, channel)
affine map of the input — which is exactly what makes a float16 wire format
safe: casting raw sensor counts to f16 directly would overflow anything
above 65504 (a saturated 16-bit pixel is 65535 -> inf -> NaN predictions),
so ``to_f16_wire`` first rescales each (tile, channel) plane to [0, 1] in
f32 and only then casts. The device's normalize of the rescaled plane is
numerically the same tile it would have computed from the raw one, and the
f16 quantization error on [0, 1] values is ~5e-4 relative — the documented
~1e-3 alpha perturbation.
"""

from __future__ import annotations

import numpy as np

_F16_MAX = float(np.finfo(np.float16).max)


def to_f16_wire(arr: np.ndarray, spatial_axes) -> np.ndarray:
    """Per-(tile, channel) min-max rescale to [0, 1], then cast to float16.

    ``spatial_axes`` are the H, W axes of ``arr``; every other axis is a
    tile/channel index normalized independently. Constant planes (span 0)
    keep their value — matching the device normalize's pass-through guard —
    clipped into f16 range so they can never become inf on the wire.
    """
    a = np.asarray(arr, np.float32)
    lo = a.min(axis=spatial_axes, keepdims=True)
    hi = a.max(axis=spatial_axes, keepdims=True)
    span = hi - lo
    safe = np.where(span > 0, span, 1.0)
    out = np.where(span > 0, (a - lo) / safe, np.clip(a, -_F16_MAX, _F16_MAX))
    return out.astype(np.float16)
