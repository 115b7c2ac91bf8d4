"""On-device Galerkin RAP for structured 9-point levels.

The reference computes coarse operators with two host sparse-sparse products
``A_H = R (A P)`` (multigrid.hpp:219-223). On the structured path the
tensor-product transfer P = kron(P1, P1) with the fixed [1/2, 1, 1/2]
stencil closes over 9-point operators, so the whole Galerkin triple product
has a small closed form:

  A_H[dJ,dI][a,b] = sum over d1,d2,d1',d2' in {-1,0,1} with
                    |2dJ + d1' - d1| <= 1 and |2dI + d2' - d2| <= 1 of
     w(d1) w(d2) w(d1') w(d2') * c[2dJ+d1'-d1, 2dI+d2'-d2][2a+1+d1, 2b+1+d2]

— a fixed sparse contraction over the fine coefficient planes sampled at
the odd (coarse-center) points. This runs as one jitted XLA op, giving
fully on-device hierarchy (re)construction: rebuilds after coefficient
updates cost milliseconds instead of host SpGEMM round-trips
(BASELINE.json config 4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_W = (0.5, 1.0, 0.5)  # w(-1), w(0), w(1) — transfer stencil


def rap_stencil_planes(c: jnp.ndarray) -> jnp.ndarray:
    """Galerkin-coarsen 9-point coefficient planes.

    Args:
      c: (3, 3, n, n) fine planes, n odd >= 3 (c[dj+1, di+1][j, i]
         multiplies u[j+dj, i+di]).
    Returns:
      (3, 3, nc, nc) coarse planes with nc = (n-1)//2.
    """
    n = c.shape[-1]
    nc = (n - 1) // 2
    # fine planes sampled at coarse centers (2a+1+d1, 2b+1+d2): a strided
    # window per (plane, d1, d2) — setup-time cost only.
    cp = jnp.pad(c, ((0, 0), (0, 0), (1, 1), (1, 1)))

    def sample(dj, di, d1, d2):
        # rows 2a+1+d1 for a in [0, nc): padded row index 2a+2+d1
        return jax.lax.slice(
            cp[dj + 1, di + 1],
            (2 + d1, 2 + d2),
            (2 + d1 + 2 * nc - 1, 2 + d2 + 2 * nc - 1),
            (2, 2))

    a_idx = jax.lax.broadcasted_iota(jnp.int32, (nc, nc), 0)
    b_idx = jax.lax.broadcasted_iota(jnp.int32, (nc, nc), 1)
    out = jnp.zeros((3, 3, nc, nc), dtype=c.dtype)
    for dJ in (-1, 0, 1):
        for dI in (-1, 0, 1):
            acc = jnp.zeros((nc, nc), dtype=c.dtype)
            for d1 in (-1, 0, 1):
                for d1p in (-1, 0, 1):
                    dj = 2 * dJ + d1p - d1
                    if abs(dj) > 1:
                        continue
                    for d2 in (-1, 0, 1):
                        for d2p in (-1, 0, 1):
                            di = 2 * dI + d2p - d2
                            if abs(di) > 1:
                                continue
                            w = (_W[d1 + 1] * _W[d2 + 1] * _W[d1p + 1]
                                 * _W[d2p + 1])
                            acc = acc + w * sample(dj, di, d1, d2)
            # zero entries that would couple to nonexistent coarse dofs
            # (rows whose a+dJ / b+dI fall outside the coarse grid)
            valid = ((a_idx + dJ >= 0) & (a_idx + dJ < nc)
                     & (b_idx + dI >= 0) & (b_idx + dI < nc))
            out = out.at[dJ + 1, dI + 1].set(jnp.where(valid, acc, 0))
    return out


@jax.jit
def rap_stencil_planes_jit(c: jnp.ndarray) -> jnp.ndarray:
    return rap_stencil_planes(c)


def build_hierarchy_planes(c_fine: jnp.ndarray, n_levels: int):
    """Full on-device hierarchy rebuild: fine planes -> list of level
    planes via repeated closed-form RAP (all jitted XLA)."""
    planes = [c_fine]
    for _ in range(n_levels - 1):
        planes.append(rap_stencil_planes(planes[-1]))
    return planes


def coarsen_tridiag(off: float, diag: float) -> tuple[float, float]:
    """1-D Galerkin RAP of a constant symmetric tridiagonal (off, diag)
    under the [1/2, 1, 1/2] transfer: closed form

        diag' = 1.5*diag + 2*off,   off' = off + diag/4

    (derived from P1^T T P1 column overlaps; P columns are never
    boundary-truncated on 2^k-1 grids, interpolator.hpp:114-129)."""
    return off + diag / 4.0, 1.5 * diag + 2.0 * off


def poisson_const_w33(side: int, n_levels: int) -> list[tuple]:
    """Per-level constant 3x3 stencil weights for the Poisson hierarchy,
    computed analytically in f64 (no device transfer).

    A_0 = I (x) D + D (x) I is separable, and Galerkin RAP preserves the
    form A_l = M_l (x) K_l + K_l (x) M_l with M, K constant symmetric
    tridiagonals; so w33_l[dj][di] = M_l[dj]*K_l[di] + K_l[dj]*M_l[di]."""
    h = 2.0 / (side + 1)
    K = (1.0 / (h * h), -2.0 / (h * h))  # (off, diag) of D
    M = (0.0, 1.0)                       # (off, diag) of I
    out = []
    for _ in range(n_levels):
        m = {-1: M[0], 0: M[1], 1: M[0]}
        k = {-1: K[0], 0: K[1], 1: K[0]}
        out.append(tuple(
            tuple(m[dj] * k[di] + k[dj] * m[di] for di in (-1, 0, 1))
            for dj in (-1, 0, 1)))
        M = coarsen_tridiag(*M)
        K = coarsen_tridiag(*K)
    return out


def poisson_planes(side: int, dtype=jnp.float32) -> jnp.ndarray:
    """Fine-level 5-point Laplacian as (3,3,n,n) planes, built with device
    iota arithmetic — no host assembly, no bulk transfer (values match
    models/poisson.laplacian exactly: -4/h^2 diag, +1/h^2 neighbors,
    boundary couplings zeroed)."""
    n = side
    h = 2.0 / (n + 1)
    inv_h2 = 1.0 / (h * h)
    j = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    i = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    one = jnp.ones((n, n), dtype=dtype) * inv_h2
    c = jnp.zeros((3, 3, n, n), dtype=dtype)
    c = c.at[1, 1].set(-4.0 * one)
    c = c.at[0, 1].set(jnp.where(j > 0, one, 0))       # u[j-1, i]
    c = c.at[2, 1].set(jnp.where(j < n - 1, one, 0))   # u[j+1, i]
    c = c.at[1, 0].set(jnp.where(i > 0, one, 0))       # u[j, i-1]
    c = c.at[1, 2].set(jnp.where(i < n - 1, one, 0))   # u[j, i+1]
    return c


def planes_to_dense(c: jnp.ndarray) -> jnp.ndarray:
    """Densify (3,3,n,n) planes into the (n^2, n^2) matrix — device op for
    the (tiny) coarsest-level factorization."""
    n = c.shape[-1]
    N = n * n
    out = jnp.zeros((N, N), dtype=c.dtype)
    j = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    i = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    rows = (j * n + i).reshape(-1)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            jj = j + dj
            ii = i + di
            ok = (jj >= 0) & (jj < n) & (ii >= 0) & (ii < n)
            cols = (jnp.clip(jj, 0, n - 1) * n
                    + jnp.clip(ii, 0, n - 1)).reshape(-1)
            vals = jnp.where(ok, c[dj + 1, di + 1], 0).reshape(-1)
            out = out.at[rows, cols].add(vals)
    return out


def interp1d_dense(n_f: int, n_c: int, dtype=jnp.float32) -> jnp.ndarray:
    """Dense 1-D transfer matrix P1 (n_f x n_c) built on device:
    P1[f, c] = w(f - 2c - 1) with w = [1/2, 1, 1/2]."""
    f = jax.lax.broadcasted_iota(jnp.int32, (n_f, n_c), 0)
    cc = jax.lax.broadcasted_iota(jnp.int32, (n_f, n_c), 1)
    d = jnp.abs(f - 2 * cc - 1)
    return jnp.where(d == 0, 1.0, jnp.where(d == 1, 0.5, 0.0)).astype(dtype)
