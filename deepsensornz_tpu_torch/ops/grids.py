"""Internal discretisation grid of the ConvNP (numpy copy of
``deepsensornz_tpu/ops/grids.py``).

The grid is uniform in normalised (x1, x2) space with ``density`` points
per unit; each axis length is rounded up to a multiple of ``multiple`` so
the stride-2 U-Net levels divide evenly.
"""

from __future__ import annotations

import math

import numpy as np


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def internal_grid(
    x1_range: tuple[float, float],
    x2_range: tuple[float, float],
    density: float,
    margin: float = 0.1,
    multiple: int = 16,
) -> tuple[np.ndarray, np.ndarray]:
    """Uniform internal grid covering the data extent plus a margin.

    Returns float32 1-D coordinate vectors (x1g, x2g) with spacing
    ``1/density``; lengths rounded up to ``multiple`` (extra span split
    symmetrically).
    """
    spacing = 1.0 / float(density)
    out = []
    for lo, hi in (x1_range, x2_range):
        lo, hi = float(lo) - margin, float(hi) + margin
        n = _round_up(max(int(math.ceil((hi - lo) / spacing)) + 1, multiple), multiple)
        extra = (n - 1) * spacing - (hi - lo)
        start = lo - extra / 2.0
        out.append((start + spacing * np.arange(n)).astype(np.float32))
    return out[0], out[1]


def infer_internal_density(resolutions: list[float], multiplier: float = 1.0) -> int:
    """Internal points per unit from the finest gridded context/target
    resolution (normalised-coordinate spacing): the internal grid is at
    least as fine as the finest data grid."""
    finest = min(float(r) for r in resolutions if r > 0)
    return max(int(math.ceil(multiplier / finest)), 2)


def default_lengthscale(density: float) -> float:
    """Default SetConv RBF length-scale: twice the internal grid spacing."""
    return 2.0 / float(density)
