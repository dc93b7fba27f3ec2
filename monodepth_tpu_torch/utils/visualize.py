"""Visualization helpers: disparity colormapping, image grids.

Counterpart of `monodepth_tpu.utils.visualize` (numpy code, copied: the
port imports nothing of the JAX package), after the reference's `Tools`
inspection helpers (model_utility.py:204-297, matplotlib magma colormaps).
matplotlib stays optional: the magma LUT ships inline, so a host without
it still writes PNGs through PIL.
"""

from __future__ import annotations

import numpy as np

# 11-entry magma anchor LUT (matplotlib's colormap sampled at 0, 0.1,
# ..., 1.0); the full 256-entry table is produced by linear interpolation.
_MAGMA_ANCHORS = np.array([
    [0.001462, 0.000466, 0.013866], [0.078815, 0.054184, 0.211667],
    [0.232077, 0.059889, 0.437695], [0.390384, 0.100379, 0.501864],
    [0.550287, 0.161158, 0.505719], [0.716387, 0.214982, 0.47529],
    [0.868793, 0.287728, 0.409303], [0.967671, 0.439703, 0.35981],
    [0.994738, 0.62435, 0.427397], [0.99568, 0.812706, 0.572645],
    [0.987053, 0.991438, 0.749504],
], dtype=np.float64)


def _magma_lut() -> np.ndarray:
    xs = np.linspace(0.0, 1.0, len(_MAGMA_ANCHORS))
    grid = np.linspace(0.0, 1.0, 256)
    lut = np.stack([np.interp(grid, xs, _MAGMA_ANCHORS[:, c])
                    for c in range(3)], axis=-1)
    return (lut * 255.0 + 0.5).astype(np.uint8)


_LUT = None


def colormap_disparity(disp: np.ndarray, percentile: float = 95.0) -> np.ndarray:
    """[H, W] disparity -> [H, W, 3] uint8 magma image, normalized to the
    Nth percentile (the Monodepth2 visualization convention)."""
    global _LUT
    try:
        import matplotlib.cm  # noqa: F401  (prefer the exact colormap)
        import matplotlib.pyplot as plt

        vmax = np.percentile(disp, percentile)
        norm = np.clip(disp / max(vmax, 1e-9), 0.0, 1.0)
        return (plt.get_cmap("magma")(norm)[..., :3] * 255).astype(np.uint8)
    except ImportError:
        if _LUT is None:
            _LUT = _magma_lut()
        vmax = np.percentile(disp, percentile)
        norm = np.clip(disp / max(vmax, 1e-9), 0.0, 1.0)
        return _LUT[(norm * 255).astype(np.uint8)]


def side_by_side(image: np.ndarray, disp: np.ndarray) -> np.ndarray:
    """Stack an RGB uint8 image over its colormapped disparity."""
    return np.concatenate([image, colormap_disparity(disp)], axis=0)
