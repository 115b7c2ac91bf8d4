"""Graph coloring for multicolor smoother sweeps.

The reference's Gauss-Seidel is strictly sequential (loop-carried dependency,
include/amg/smoother.hpp:129-174). To parallelize we partition rows
into independent sets (colors): rows of one color share no matrix edge, so
their updates commute. The 5-point Poisson stencil needs exactly 2 colors
(red-black); Galerkin-coarsened levels densify and need more.

Coloring runs on the host once per hierarchy setup. A C++ fast path exists in
amg_jax/native for large matrices; this module holds the pure-numpy greedy
first-fit fallback and the closed-form stencil colorings.
"""

from __future__ import annotations

import numpy as np


def greedy_coloring(cols: np.ndarray, data: np.ndarray, n: int) -> np.ndarray:
    """Greedy first-fit coloring over an ELL pattern.

    Args:
      cols: (n, K) ELL column indices.
      data: (n, K) ELL values (zeros mark padding — ignored).
      n: number of rows.

    Returns int array (n,) of color ids starting at 0. Rows are visited in
    natural order, each taking the smallest color unused by its neighbors.
    """
    try:
        from amg_jax.native.bindings import greedy_coloring_native
        out = greedy_coloring_native(cols, data, n)
        if out is not None:
            return out
    except ImportError:
        pass
    colors = np.full(n, -1, dtype=np.int64)
    cols_l = cols
    mask = data != 0
    for i in range(n):
        nbr = cols_l[i][mask[i]]
        used = set(int(colors[j]) for j in nbr if j != i and colors[j] >= 0)
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return colors


def red_black_2d(n: int) -> np.ndarray:
    """Closed-form red-black coloring for the n x n 5-point stencil with
    lexicographic dofs (dof = j*n + i): color = (i + j) % 2."""
    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return ((i + j) % 2).reshape(-1).astype(np.int64)


def four_color_2d(n: int) -> np.ndarray:
    """Four-coloring (2x2 block) decoupling 9-point stencils:
    color = (i % 2) + 2 * (j % 2)."""
    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return ((i % 2) + 2 * (j % 2)).reshape(-1).astype(np.int64)
