"""Grid-transfer operators: prolongation P and restriction R.

Replaces the reference interpolator layer (include/amg/interpolator.hpp).
Operators are assembled on host (scipy) during hierarchy setup and shipped to
device as ELL matrices; ``prolongation``/``restriction`` applications are ELL
SpMVs (interpolator.hpp:52-68 used Eigen SpMV).

Two interpolators:

  * ``LinearInterpolator`` — exact reference parity: classical 1-D linear
    interpolation applied to the *flattened* dof vector
    (interpolator.hpp:98-142). Column j of P carries the stencil
    [0.5, 1.0, 0.5] at rows 2j, 2j+1, 2j+2 with out-of-range rows dropped;
    R = P^T exactly (no half full-weighting scale); coarse size
    n_H = (n_h + 1)/2 - 1 (multigrid.hpp:127-130, Briggs).

  * ``BilinearInterpolator2D`` — extension: proper per-dimension
    linear interpolation P2d = kron(P1d, P1d) on the 2-D grid, which keeps
    every Galerkin coarse operator a 9-point stencil (structured,
    elementwise-friendly) and gives textbook O(10)-cycle convergence on large grids.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from amg_jax.sparse.ell import ELL


class InterpolatorBase:
    """Holds per-level P/R maps, mirroring InterpolatorBase
    (interpolator.hpp:15-87). ``make_operators(n_h, n_H, level)`` fills the
    maps; ``prolongation``/``restriction`` apply them as device SpMVs."""

    def __init__(self, n_levels: int | None = None):
        # only operators for levels 0..n_levels-2 exist (interpolator.hpp:22-26)
        self.level_to_P: dict[int, ELL] = {}
        self.level_to_R: dict[int, ELL] = {}
        self.n_levels = n_levels

    def coarse_size(self, n_h: int) -> int:
        """n_H from n_h. Default: flattened Briggs formula
        (multigrid.hpp:127-130)."""
        return (n_h + 1) // 2 - 1

    def make_operators_scipy(self, n_h: int, n_H: int):
        raise NotImplementedError

    def make_operators(self, n_h: int, n_H: int, level: int, dtype=None):
        P, R = self.make_operators_scipy(n_h, n_H)
        self.level_to_P[level] = ELL.from_scipy(P, dtype=dtype)
        self.level_to_R[level] = ELL.from_scipy(R, dtype=dtype)

    def get_P(self, level: int) -> ELL:
        return self.level_to_P[level]

    def get_R(self, level: int) -> ELL:
        return self.level_to_R[level]

    def set_level_to_P(self, level: int, P: ELL):
        self.level_to_P[level] = P

    def set_level_to_R(self, level: int, R: ELL):
        self.level_to_R[level] = R

    def prolongation(self, v, level: int):
        """P_level @ v (interpolator.hpp:52-57)."""
        return self.level_to_P[level].matvec(v)

    def restriction(self, v, level: int):
        """R_level @ v (interpolator.hpp:63-68)."""
        return self.level_to_R[level].matvec(v)


class LinearInterpolator(InterpolatorBase):
    """Reference-parity 1-D linear interpolation on the flattened dof vector
    (interpolator.hpp:98-142): 3 nnz per column at rows 2j..2j+2, bounds
    checked; R = P^T."""

    N_ELEMENTS_PER_COLUMN = 3

    def make_operators_scipy(self, n_h: int, n_H: int):
        rows, cols, vals = [], [], []
        i = 0
        for j in range(n_H):
            for off, v in ((0, 0.5), (1, 1.0), (2, 0.5)):
                if i + off < n_h:
                    rows.append(i + off)
                    cols.append(j)
                    vals.append(v)
            i += self.N_ELEMENTS_PER_COLUMN - 1
        P = sp.coo_matrix((vals, (rows, cols)), shape=(n_h, n_H)).tocsr()
        R = P.T.tocsr()
        return P, R


def linear_interp_1d(n_f: int, n_c: int) -> sp.csr_matrix:
    """1-D linear interpolation for n_f = 2*n_c + 1 interior points: column j
    has [0.5, 1, 0.5] at rows 2j, 2j+1, 2j+2 (all in range)."""
    assert n_f == 2 * n_c + 1, (n_f, n_c)
    rows = np.concatenate([2 * np.arange(n_c), 2 * np.arange(n_c) + 1,
                           2 * np.arange(n_c) + 2])
    cols = np.concatenate([np.arange(n_c)] * 3)
    vals = np.concatenate([np.full(n_c, 0.5), np.full(n_c, 1.0),
                           np.full(n_c, 0.5)])
    return sp.coo_matrix((vals, (rows, cols)), shape=(n_f, n_c)).tocsr()


class BilinearInterpolator2D(InterpolatorBase):
    """Per-dimension (tensor-product) linear interpolation on the 2-D grid.

    Grid side coarsens n -> (n - 1) / 2 (requires odd side, e.g. n = 2^k - 1);
    P2d = kron(P1d_x, P1d_y) matches the reference's lexicographic
    dof = j*n + i ordering (grid.hpp:88-98). Galerkin RAP of the 5-point
    Laplacian under this P stays a 9-point stencil at every level.
    """

    def __init__(self, fine_side: int, n_levels: int | None = None,
                 full_weighting: bool = False):
        super().__init__(n_levels)
        self.full_weighting = full_weighting
        self.sides: dict[int, int] = {0: fine_side}  # dofs n_h = side^2

    def coarse_size(self, n_h: int) -> int:
        side = int(round(np.sqrt(n_h)))
        assert side * side == n_h, f"not a square grid: {n_h} dofs"
        if side % 2 == 0 or side < 3:
            raise ValueError(
                f"BilinearInterpolator2D needs odd grid side >= 3, got {side}")
        return ((side - 1) // 2) ** 2

    def make_operators_scipy(self, n_h: int, n_H: int):
        side_f = int(round(np.sqrt(n_h)))
        side_c = (side_f - 1) // 2
        P1 = linear_interp_1d(side_f, side_c)
        P = sp.kron(P1, P1).tocsr()
        R = P.T.tocsr()
        if self.full_weighting:
            R = (R * 0.25).tocsr()
        return P, R
