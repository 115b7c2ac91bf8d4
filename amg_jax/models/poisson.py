"""2-D Poisson model problem — finite differences, homogeneous Dirichlet BCs.

A re-implementation of the reference's problem generation
(include/amg/grid.hpp): the 5-point Laplacian ``A = I (x) D + D (x) I`` on the
interior of ``[-1,1]^2`` and the forcing vector ``b`` from evaluating
``f(x, y)`` at interior grid points in column-major order. All numerics match
the reference exactly (same h scaling, same dof ordering) so converged
residuals and iteration counts are comparable.

Assembly happens on host in numpy/scipy (the setup phase is traced once);
device arrays come out as ELL matrices or stencil-coefficient planes.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import scipy.sparse as sp

from amg_jax.sparse.ell import ELL

# Two boundary points flank each direction (reference: grid.hpp:22).
N_BOUNDARY_POINTS = 2


def grid_spacing_h(n: int) -> float:
    """Grid spacing for n interior points on [-1, 1] (grid.hpp:31)."""
    return 2.0 / (n + 1)


def points_n_from_grid_spacing_h(h: float = 1.0 / 50) -> int:
    """Inverse of grid_spacing_h (grid.hpp:38-40)."""
    return int(2 / h - 1)


def second_order_central_difference(n: int) -> sp.csr_matrix:
    """1-D tridiagonal second-order central difference, scaled by 1/h^2.

    diag -2, off-diagonals +1, all divided by h^2 (grid.hpp:50-75).
    Host-side scipy CSR (setup format).
    """
    h = grid_spacing_h(n)
    main = np.full(n, -2.0)
    off = np.ones(n - 1)
    D = sp.diags([off, main, off], [-1, 0, 1], format="csr")
    return (D / (h * h)).tocsr()


def laplacian_scipy(n: int) -> sp.csr_matrix:
    """5-point Laplacian ``A = kron(I, D) + kron(D, I)``, shape (n^2, n^2).

    Lexicographic column-major dof ordering: dof = j*n + i where j indexes x
    and i indexes y (grid.hpp:88-98). Entries: -4/h^2 diagonal, +1/h^2
    neighbors. Symmetric negative definite.

    Built directly from its five diagonals (equivalent to the reference's
    Kronecker construction but O(n^2) instead of scipy's slow block kron):
    the +-1 diagonals vanish at block boundaries (i wraps), the +-n
    diagonals are dense.
    """
    h = grid_spacing_h(n)
    N = n * n
    inv_h2 = 1.0 / (h * h)
    main = np.full(N, -4.0 * inv_h2)
    off1 = np.full(N - 1, inv_h2)
    off1[n - 1::n] = 0.0  # no coupling across the i-wrap
    offn = np.full(N - n, inv_h2)
    return sp.diags([offn, off1, main, off1, offn],
                    [-n, -1, 0, 1, n], format="csr")


def laplacian(n: int, dtype=jnp.float64) -> ELL:
    """5-point Laplacian as a device ELL matrix (K = 5)."""
    return ELL.from_scipy(laplacian_scipy(n), dtype=dtype)


def default_forcing(x, y):
    """Default forcing ``f(x,y) = 5 exp(-10 (x^2 + y^2))`` (grid.hpp:110-112)."""
    return 5.0 * np.exp(-10.0 * (x * x + y * y))


def rhs(n: int, f=default_forcing, dtype=jnp.float64) -> jnp.ndarray:
    """Forcing vector b: f evaluated at the n x n interior points.

    The (n+2)-point uniform grid spans [-1, 1]; interior traversal is
    column-major — outer loop j over x, inner loop i over y, so
    ``b[j*n + i] = f(x[j+1], x[i+1])`` (grid.hpp:108-140).
    """
    domain = np.linspace(-1.0, 1.0, n + N_BOUNDARY_POINTS)
    interior = domain[1:-1]
    X, Y = np.meshgrid(interior, interior, indexing="ij")  # X varies with j
    b = f(X, Y).reshape(-1)  # row-major over (j, i) == reference dof order
    return jnp.asarray(b, dtype=dtype)


def default_forcing_jnp(x, y):
    """``default_forcing`` in jnp ops (traceable for on-device evaluation)."""
    return 5.0 * jnp.exp(-10.0 * (x * x + y * y))


def _rhs_device_build(n: int, f, dtype):
    domain = jnp.linspace(jnp.asarray(-1.0, dtype=dtype),
                          jnp.asarray(1.0, dtype=dtype),
                          n + N_BOUNDARY_POINTS)
    interior = domain[1:-1]
    X, Y = jnp.meshgrid(interior, interior, indexing="ij")
    return f(X, Y).reshape(-1).astype(dtype)


# module-level jit: a per-call jit wrapper would defeat the in-process
# trace cache and retrace on every invocation. f and dtype are
# static (f is hashable as a function object; repeat calls with the same
# function reuse the cache).
_rhs_device_j = partial(jax.jit, static_argnums=(0, 1, 2))(_rhs_device_build)


def rhs_device(n: int, f=default_forcing_jnp, dtype=jnp.float64) -> jnp.ndarray:
    """Forcing vector b evaluated ON DEVICE (jit) — no bulk host transfer.

    Same grid / traversal contract as :func:`rhs` (grid.hpp:108-140):
    ``b[j*n + i] = f(x[j+1], x[i+1])`` for the (n+2)-point uniform grid on
    [-1, 1]. ``f`` must be jnp-traceable (default matches grid.hpp:110-112).

    Rationale: at scale the host build + push dominates (134 MB of f64 at
    n=4095); generating b with a ~KB-sized compiled program keeps setup
    transfer-free. Values agree with :func:`rhs` to f64 roundoff
    (linspace endpoints are exact; see tests/test_poisson.py).
    """
    return _rhs_device_j(n, f, dtype)


def poisson2d(n: int, f=default_forcing, dtype=jnp.float64):
    """Convenience: (A_ell, b) for the n x n interior Poisson problem."""
    return laplacian(n, dtype=dtype), rhs(n, f=f, dtype=dtype)
