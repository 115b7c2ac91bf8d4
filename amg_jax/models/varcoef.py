"""Variable-coefficient 2-D diffusion problems: -div(a grad u) = f.

The reference accepts ANY assembled sparse A (multigrid.hpp:151-244); its
tests only exercise the constant-coefficient Poisson case (grid.hpp:88-98).
These generators produce the standard harder AMG test problems — jump and
anisotropic coefficients — as 9-point stencil planes built ON DEVICE (no
host assembly, no bulk host transfer), so the variable-coefficient
machinery (gs4_sweep_packed_var, the closed-form device RAP) can be
exercised end-to-end at scale.

Discretization: 5-point finite volumes on the same [-1,1]^2 interior grid
as models/poisson.py (h = 2/(n+1), lexicographic dofs u2[j, i] at
(x_j, y_i) = (-1 + (j+1)h, -1 + (i+1)h)), face diffusivities by harmonic
mean of the nodal coefficient — the standard choice that stays stable
across jumps. Sign convention matches the reference matrix (negative
diagonal): with a === 1 the planes equal ops/rap.poisson_planes exactly.
Dirichlet boundaries: out-of-range couplings are dropped from the
off-diagonal planes but their face terms stay in the diagonal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def jump_coefficient(side: int, a_in: float = 100.0, r: float = 0.5,
                     dtype=jnp.float32) -> jnp.ndarray:
    """Nodal coefficient field on the FULL (n+2, n+2) node set:
    a = a_in inside the centered square |x| < r, |y| < r, else 1."""
    n = side
    h = np.float32(2.0 / (n + 1))
    k = jax.lax.broadcasted_iota(jnp.int32, (n + 2, n + 2), 0)
    l_ = jax.lax.broadcasted_iota(jnp.int32, (n + 2, n + 2), 1)
    x = (-1.0 + k.astype(jnp.float32) * h).astype(dtype)
    y = (-1.0 + l_.astype(jnp.float32) * h).astype(dtype)
    inside = (jnp.abs(x) < r) & (jnp.abs(y) < r)
    return jnp.where(inside, jnp.asarray(a_in, dtype),
                     jnp.asarray(1.0, dtype))


def planes_from_nodal(a_full: jnp.ndarray, side: int,
                      eps_y: float = 1.0) -> jnp.ndarray:
    """(3,3,n,n) stencil planes from a FULL nodal coefficient field
    ``a_full`` ((n+2, n+2), boundary nodes included).

    Face diffusivity = harmonic mean of the two adjacent nodes; the
    y-direction faces are additionally scaled by ``eps_y`` (anisotropy
    knob — eps_y << 1 gives the classic anisotropic diffusion problem).
    """
    n = side
    h = 2.0 / (n + 1)
    inv_h2 = 1.0 / (h * h)
    dt = a_full.dtype

    def hmean(p, q):
        return 2.0 * p * q / (p + q)

    a_c = a_full[1:-1, 1:-1]                      # node (j, i)
    aN = hmean(a_c, a_full[2:, 1:-1])             # face to (j+1, i)
    aS = hmean(a_c, a_full[:-2, 1:-1])            # face to (j-1, i)
    aE = hmean(a_c, a_full[1:-1, 2:]) * eps_y     # face to (j, i+1)
    aW = hmean(a_c, a_full[1:-1, :-2]) * eps_y    # face to (j, i-1)

    j = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    i = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    c = jnp.zeros((3, 3, n, n), dtype=dt)
    c = c.at[1, 1].set(-(aN + aS + aE + aW) * inv_h2)
    c = c.at[2, 1].set(jnp.where(j < n - 1, aN * inv_h2, 0))
    c = c.at[0, 1].set(jnp.where(j > 0, aS * inv_h2, 0))
    c = c.at[1, 2].set(jnp.where(i < n - 1, aE * inv_h2, 0))
    c = c.at[1, 0].set(jnp.where(i > 0, aW * inv_h2, 0))
    return c


def jump_planes(side: int, a_in: float = 100.0, r: float = 0.5,
                eps_y: float = 1.0, dtype=jnp.float32) -> jnp.ndarray:
    """Jump-coefficient (optionally anisotropic) diffusion operator as
    (3,3,n,n) planes, fully device-built (one small jitted program)."""

    @jax.jit
    def _build():
        a = jump_coefficient(side, a_in, r, dtype)
        return planes_from_nodal(a, side, eps_y)

    return _build()


def jump_scipy(side: int, a_in: float = 100.0, r: float = 0.5,
               eps_y: float = 1.0):
    """Host (scipy CSR) assembly of the same operator, for parity tests
    and for the reference-class CPU baseline (independent numpy path)."""
    import scipy.sparse as sp

    n = side
    h = 2.0 / (n + 1)
    inv_h2 = 1.0 / (h * h)
    xs = -1.0 + np.arange(n + 2, dtype=np.float64) * np.float64(
        np.float32(h))
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    a_full = np.where((np.abs(X) < r) & (np.abs(Y) < r), a_in, 1.0)

    def hmean(p, q):
        return 2.0 * p * q / (p + q)

    a_c = a_full[1:-1, 1:-1]
    aN = hmean(a_c, a_full[2:, 1:-1])
    aS = hmean(a_c, a_full[:-2, 1:-1])
    aE = hmean(a_c, a_full[1:-1, 2:]) * eps_y
    aW = hmean(a_c, a_full[1:-1, :-2]) * eps_y

    N = n * n
    A = sp.lil_matrix((N, N))
    for j in range(n):
        for i in range(n):
            row = j * n + i
            A[row, row] = -(aN[j, i] + aS[j, i] + aE[j, i]
                            + aW[j, i]) * inv_h2
            if j < n - 1:
                A[row, row + n] = aN[j, i] * inv_h2
            if j > 0:
                A[row, row - n] = aS[j, i] * inv_h2
            if i < n - 1:
                A[row, row + 1] = aE[j, i] * inv_h2
            if i > 0:
                A[row, row - 1] = aW[j, i] * inv_h2
    return A.tocsr()
