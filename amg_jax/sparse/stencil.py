"""Structured 9-point stencil operators on 2-D grids — the fast path.

Under the tensor-product bilinear transfer (ops/transfer.py), Galerkin RAP of
the 5-point Laplacian (models/poisson.py, reference grid.hpp:88-98) is closed
over 9-point stencils: every level of the hierarchy is a (3, 3, n, n) array
of per-point coefficient planes on an n x n grid. SpMV, residual, smoother
sweeps, restriction, and prolongation all become shifted elementwise ops and
tiny convolutions — static shapes, no gathers, pure elementwise work. This is
the format the big-grid benchmarks run on; the general unstructured format
stays ELL (sparse/ell.py).

Index conventions match the reference's lexicographic dofs
(dof = j*n + i, j = x/outer, i = y/inner; grid.hpp:127-137): 2-D fields are
indexed ``u2[j, i]`` and ``u2.reshape(-1)`` reproduces the flat dof vector.
Coefficient plane ``c[dj+1, di+1][j, i]`` multiplies ``u2[j+dj, i+di]``.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.tree_util.register_dataclass,
         data_fields=["c"], meta_fields=["side", "w33"])
@dataclasses.dataclass(frozen=True)
class Stencil2D:
    """Variable-coefficient 9-point stencil operator on an n x n grid.

    ``w33`` (static metadata): when not None, a 3x3 nested tuple of Python
    floats asserting that the operator is *spatially constant* with
    zero-padding boundary semantics — c[dj,di][j,i] == w33[dj][di] wherever
    (j+dj, i+di) is in bounds and 0 otherwise. This holds EXACTLY (bitwise)
    for the Poisson fine level and every Galerkin/bilinear coarse level
    (verified at build; see detect_const_stencil). Operators then use the
    scalar weights as compile-time constants: SpMV and smoother sweeps read
    only u (and b) from HBM — none of the 9 coefficient planes — cutting
    smoother HBM traffic 4x. Plane-free const operators (Stencil2D.const:
    ``c`` is an empty placeholder) rebuild planes on demand for
    densify/IO accessors via ``const_planes``.
    """

    c: jnp.ndarray  # (3, 3, n, n)
    side: int
    w33: tuple | None = None

    @property
    def n_rows(self) -> int:
        return self.side * self.side

    @property
    def dtype(self):
        return self.c.dtype

    @property
    def nnz(self) -> int:
        if self.w33 is not None and self.c.size == 0:
            # plane-free const operator: closed form (offset (dj, di)
            # contributes (n-|dj|)*(n-|di|) in-bounds entries)
            n = self.side
            return sum((n - abs(dj)) * (n - abs(di))
                       for dj in (-1, 0, 1) for di in (-1, 0, 1)
                       if self.w33[dj + 1][di + 1] != 0.0)
        return int(np.count_nonzero(np.asarray(self.c)))

    def diag(self) -> jnp.ndarray:
        if self.w33 is not None and self.c.size == 0:
            # const stencil: the diagonal plane is uniform (zero-padding
            # truncation touches only off-diagonals)
            return jnp.full((self.side, self.side), self.w33[1][1],
                            dtype=self.dtype)
        return self.c[1, 1]

    # -- core ops (all static-shape shifted slices) -----------------------

    def matvec2(self, u2: jnp.ndarray) -> jnp.ndarray:
        """A @ u on the 2-D field: sum of 9 shifted products.

        With ``w33`` set, weights are scalar HLO constants and the zero
        padding supplies the boundary truncation — no plane reads."""
        n = self.side
        up = jnp.pad(u2, 1)
        out = jnp.zeros_like(u2)
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                w = (self.w33[dj + 1][di + 1] if self.w33 is not None
                     else self.c[dj + 1, di + 1])
                if isinstance(w, float) and w == 0.0:
                    continue
                out = out + w * jax.lax.slice(
                    up, (1 + dj, 1 + di), (1 + dj + n, 1 + di + n))
        return out

    def inv_diag(self):
        """1/diag as a scalar constant (const stencil) or plane."""
        if self.w33 is not None:
            return 1.0 / self.w33[1][1]
        return 1.0 / self.c[1, 1]

    def matvec(self, u: jnp.ndarray) -> jnp.ndarray:
        """Flat-vector interface matching ELL.matvec."""
        n = self.side
        return self.matvec2(u.reshape(n, n)).reshape(-1)

    # -- conversions ------------------------------------------------------

    @staticmethod
    def from_planes(c: jnp.ndarray, side: int) -> "Stencil2D":
        """Wrap (3,3,n,n) planes, detecting the constant-stencil property."""
        return Stencil2D(c=c, side=side,
                         w33=detect_const_stencil(np.asarray(c), side))

    @staticmethod
    def from_scipy(A, side: int, dtype=None) -> "Stencil2D":
        """Extract 9-point planes from a sparse matrix with lexicographic
        dofs. Raises if A has couplings outside the 3x3 neighborhood."""
        A = A.tocsr().copy()
        A.sum_duplicates()
        A.eliminate_zeros()  # drop explicit zeros before pattern checks
        A = A.tocoo()
        n = side
        c = np.zeros((3, 3, n, n), dtype=A.data.dtype)
        r_j, r_i = A.row // n, A.row % n
        c_j, c_i = A.col // n, A.col % n
        dj, di = c_j - r_j, c_i - r_i
        if np.any(np.abs(dj) > 1) or np.any(np.abs(di) > 1):
            raise ValueError("matrix is not a 9-point stencil on this grid")
        # duplicates were summed above, so plain fancy assignment suffices
        # (np.add.at is ~50x slower)
        c[dj + 1, di + 1, r_j, r_i] = A.data
        if dtype is None:
            dtype = A.data.dtype
        c = c.astype(dtype)
        return Stencil2D(c=jnp.asarray(c), side=side,
                         w33=detect_const_stencil(c, side))

    def to_scipy(self):
        import scipy.sparse as sp

        n = self.side
        if self.w33 is not None and self.c.size == 0:
            # plane-free const operator: rebuild planes for densify/IO
            c = np.asarray(const_planes(self.w33, n, self.dtype))
        else:
            c = np.asarray(self.c)
        rows, cols, vals = [], [], []
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
                jj, ii = j + dj, i + di
                ok = (jj >= 0) & (jj < n) & (ii >= 0) & (ii < n)
                v = c[dj + 1, di + 1]
                rows.append((j * n + i)[ok])
                cols.append((jj * n + ii)[ok])
                vals.append(v[ok])
        mat = sp.coo_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(n * n, n * n)).tocsr()
        mat.eliminate_zeros()
        return mat

    def astype(self, dtype) -> "Stencil2D":
        return Stencil2D(c=self.c.astype(dtype), side=self.side,
                         w33=self.w33)

    @staticmethod
    def const(w33, side: int, dtype=jnp.float32) -> "Stencil2D":
        """Constant-stencil operator with NO materialized planes (c is an
        empty (3,3,0,0) placeholder): every production op — matvec2,
        inv_diag, sweeps, packed/fused kernels — reads only the static
        w33. At 8191^2 the fine-level planes alone are 2.4 GB (f32) /
        4.8 GB (f64) of HBM the const paths never touch; skipping them is
        what lets 67M-dof hierarchies fit on one chip. Densify/IO paths
        that need planes can rebuild them with ``const_planes``."""
        if w33 is None:
            raise ValueError("Stencil2D.const requires a w33 tuple")
        return Stencil2D(c=jnp.zeros((3, 3, 0, 0), dtype=dtype),
                         side=side, w33=w33)


def const_planes(w33, side: int, dtype=jnp.float32) -> jnp.ndarray:
    """Materialize (3,3,n,n) coefficient planes for a constant stencil
    with zero-padding boundary semantics (the inverse of
    detect_const_stencil; used for the coarsest-level densify)."""
    n = side
    j = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    i = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    planes = []
    for dj in (-1, 0, 1):
        row = []
        for di in (-1, 0, 1):
            inb = ((j + dj >= 0) & (j + dj < n)
                   & (i + di >= 0) & (i + di < n))
            row.append(jnp.where(inb, jnp.asarray(w33[dj + 1][di + 1],
                                                  dtype=dtype), 0))
        planes.append(jnp.stack(row))
    return jnp.stack(planes)


def color_masks_iota(n: int, dtype=jnp.float32) -> jnp.ndarray:
    """(4, n, n) parity-class masks from iota — safe to build INSIDE a jit
    trace (color_masks is host numpy: traced use would embed a full-field
    HLO constant)."""
    j = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    i = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    return jnp.stack([((j % 2) == pj) & ((i % 2) == pi)
                      for pj, pi in FOUR_COLORS]).astype(dtype)


def detect_const_stencil(c_np: np.ndarray, side: int) -> tuple | None:
    """Return the 3x3 weight tuple if the planes are EXACTLY a constant
    stencil with zero-padding boundary semantics, else None.

    Exactness (bitwise, no tolerance) is required so switching to scalar
    weights changes no arithmetic. Poisson + tensor-product bilinear
    Galerkin RAP satisfies this on every level because the 1-D transfer
    stencil [1/2, 1, 1/2] is never boundary-truncated on 2^k-1 grids
    (interpolator.hpp:114-129 bounds-drop never fires) and scipy/our SpGEMM
    sum identical terms per interior entry.
    """
    n = side
    c_np = np.asarray(c_np)
    w = c_np[:, :, n // 2, n // 2]
    jj, ii = np.indices((n, n))
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            plane = c_np[dj + 1, di + 1]
            valid = ((jj + dj >= 0) & (jj + dj < n)
                     & (ii + di >= 0) & (ii + di < n))
            expect = np.where(valid, w[dj + 1, di + 1], plane.dtype.type(0))
            if not np.array_equal(plane, expect):
                return None
    return tuple(tuple(float(x) for x in row) for row in w)


# ---------------------------------------------------------------------------
# Four-color Gauss-Seidel sweep


def _color_slices(n: int, pj: int, pi: int):
    """Shapes of the (pj, pi)-parity sub-lattice."""
    nj = (n - pj + 1) // 2
    ni = (n - pi + 1) // 2
    return nj, ni


def gs4_color_update(S: Stencil2D, u2, b2, pj: int, pi: int,
                     omega: float = 1.0):
    """Gauss-Seidel update of the (j%2==pj, i%2==pi) color.

    Points of one 2x2-parity class share no 9-point edge, so their updates
    are independent — the structured analog of the multicolor ELL sweep
    (ops/smoothers.py), replacing the reference's sequential per-row update
    (smoother.hpp:129-138).
    """
    n = S.side
    nj, ni = _color_slices(n, pj, pi)
    up = jnp.pad(u2, 1)
    acc = jnp.zeros((nj, ni), dtype=u2.dtype)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            if dj == 0 and di == 0:
                continue
            w = jax.lax.slice(S.c[dj + 1, di + 1], (pj, pi), (n, n), (2, 2))
            nb = jax.lax.slice(up, (1 + pj + dj, 1 + pi + di),
                               (1 + pj + dj + 2 * nj - 1,
                                1 + pi + di + 2 * ni - 1), (2, 2))
            acc = acc + w * nb
    diag = jax.lax.slice(S.c[1, 1], (pj, pi), (n, n), (2, 2))
    bsub = jax.lax.slice(b2, (pj, pi), (n, n), (2, 2))
    usub = jax.lax.slice(u2, (pj, pi), (n, n), (2, 2))
    gs = (bsub - acc) / diag
    new = usub + omega * (gs - usub)
    return u2.at[pj::2, pi::2].set(new)


# Color visit order: the 2x2-block classes.
FOUR_COLORS = ((0, 0), (0, 1), (1, 0), (1, 1))


def gs4_sweep(S: Stencil2D, u2, b2, omega: float = 1.0,
              symmetric: bool = True):
    """One four-color Gauss-Seidel iteration (optionally symmetric: colors
    forward then reversed, mirroring the reference's fwd+bwd symmetric sweep,
    smoother.hpp:189-198)."""
    order = list(FOUR_COLORS)
    if symmetric:
        order = order + order[::-1]
    for pj, pi in order:
        u2 = gs4_color_update(S, u2, b2, pj, pi, omega)
    return u2


def color_masks(n: int, dtype=jnp.bool_):
    """(4, n, n) masks of the 2x2-parity classes (host numpy — setup)."""
    j, i = np.indices((n, n))
    m = np.stack([((j % 2) == pj) & ((i % 2) == pi)
                  for pj, pi in FOUR_COLORS])
    return jnp.asarray(m, dtype=dtype)


def gs4_sweep_masked(S: Stencil2D, u2, b2, masks, omega: float = 1.0,
                     symmetric: bool = True):
    """Four-color GS sweep via full-grid masked updates.

    Rationale: the strided sub-lattice variant (gs4_sweep) indexes the
    last dimension at stride 2. Here every op is full-width: per color,
    compute the GS value everywhere (one 9-point apply) and keep it only on
    that color's mask — ~2x the flops of the strided form, with unit-stride
    access only.
    """
    order = list(range(4))
    if symmetric:
        order = order + order[::-1]
    inv_diag = S.inv_diag()
    for ci in order:
        r = b2 - S.matvec2(u2)
        gs_delta = r * inv_diag  # == (gs value - u) at every point
        u2 = u2 + (omega * masks[ci]) * gs_delta
    return u2


def jacobi_sweep(S: Stencil2D, u2, b2, omega: float = 0.8):
    """Weighted-Jacobi sweep on the stencil level."""
    r = b2 - S.matvec2(u2)
    return u2 + omega * r * S.inv_diag()


def dinv_matvec2(S: Stencil2D, x2):
    """D^-1 A x — the diagonally preconditioned operator the polynomial
    smoother iterates. For the (negative-definite) Poisson-type levels
    D^-1 A is SPD-similar with spectrum in (0, 2)."""
    return S.inv_diag() * S.matvec2(x2)


def estimate_lam_max(S: Stencil2D, iters: int = 12, seed: int = 0):
    """Power-iteration estimate of lambda_max(D^-1 A) (setup-time; a few
    SpMVs). Deterministic seed for reproducible hierarchies."""
    n = S.side
    key = jax.random.PRNGKey(seed)
    x = jax.random.normal(key, (n, n), dtype=S.c.dtype)

    def body(_, x):
        y = dinv_matvec2(S, x)
        return y / jnp.sqrt(jnp.sum(y * y))

    x = jax.lax.fori_loop(0, iters, body, x)
    y = dinv_matvec2(S, x)
    # Rayleigh quotient (D^-1 A is similar to an SPD operator, so real)
    lam = jnp.sum(x * y) / jnp.sum(x * x)
    return jnp.abs(lam) * 1.05  # 5% safety margin


def const_lam_max(w33) -> float:
    """Analytic lambda_max bound of D^-1 A for a constant symmetric 9-point
    stencil: the Fourier symbol s(t1, t2)/w_c = 1 + (2 w_N c1 + 2 w_W c2 +
    4 w_d c1 c2)/w_c is bilinear in (c1, c2) = (cos t1, cos t2) in [-1,1]^2,
    so its extreme is at a corner — a compile-time Python float (Dirichlet
    eigenvalues lie strictly inside the periodic-symbol range)."""
    wc = w33[1][1]
    wN = w33[0][1]
    wW = w33[1][0]
    wd = w33[0][0] if w33[0][0] != 0.0 else w33[0][2]
    best = 0.0
    for c1 in (1.0, -1.0):
        for c2 in (1.0, -1.0):
            s = (wc + 2 * wN * c1 + 2 * wW * c2 + 4 * wd * c1 * c2) / wc
            best = max(best, s)
    return best


def chebyshev_smooth(S: Stencil2D, u2, b2, lam_max, degree: int = 3,
                     lam_min_frac: float = 0.25):
    """Chebyshev polynomial smoother of the given degree.

    The production parallel-AMG smoother (cf. "Optimal Polynomial Smoothers
    for Parallel AMG", PAPERS.md): a fixed polynomial in D^-1 A applied to
    the residual, damping the upper part [lam_max * lam_min_frac, lam_max]
    of the spectrum. Every operation is an SpMV + axpy — no color masks, no
    sequential dependencies, and ``degree`` residual applies per smooth vs
    the symmetric four-color sweep's 8 masked steps: the cheapest smoother
    per unit of high-frequency damping. Unlike Gauss-Seidel it is an
    extension beyond the reference smoother set (smoother.hpp), kept out of
    parity runs.

    Standard three-term recurrence (Adams et al. formulation) on the
    preconditioned residual d = p(D^-1 A) D^-1 r.
    """
    theta = 0.5 * (1.0 + lam_min_frac) * lam_max
    delta = 0.5 * (1.0 - lam_min_frac) * lam_max
    sigma = theta / delta
    rho = 1.0 / sigma

    r = (b2 - S.matvec2(u2)) * S.inv_diag()
    d = r / theta
    u2 = u2 + d
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r = r - dinv_matvec2(S, d)
        d = rho_new * rho * d + 2.0 * rho_new / delta * r
        u2 = u2 + d
        rho = rho_new
    return u2


# ---------------------------------------------------------------------------
# Tensor-product grid transfer (P = kron(P1, P1), R = P^T; ops/transfer.py)

_W1D = np.array([0.5, 1.0, 0.5])
W2D = np.outer(_W1D, _W1D)  # bilinear 3x3 weights


def restrict_fw(r2: jnp.ndarray) -> jnp.ndarray:
    """R @ r for R = kron(P1, P1)^T: 3x3 weighted window at stride 2
    centered on odd fine points. Fine side n = 2*nc + 1 -> coarse side nc."""
    n = r2.shape[0]
    nc = (n - 1) // 2
    w = jnp.asarray(W2D, dtype=r2.dtype)
    out = jnp.zeros((nc, nc), dtype=r2.dtype)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            out = out + w[dj + 1, di + 1] * jax.lax.slice(
                r2, (1 + dj, 1 + di), (1 + dj + 2 * nc - 1, 1 + di + 2 * nc - 1),
                (2, 2))
    return out


def prolong(uc2: jnp.ndarray, n_fine: int) -> jnp.ndarray:
    """P @ u_c: scatter coarse values to odd fine points and apply the 3x3
    bilinear kernel."""
    nc = uc2.shape[0]
    assert n_fine == 2 * nc + 1
    z = jnp.zeros((n_fine + 2, n_fine + 2), dtype=uc2.dtype)
    # fine point (2a+1, 2b+1) sits at padded index (2a+2, 2b+2)
    z = z.at[2:2 + 2 * nc:2, 2:2 + 2 * nc:2].set(uc2)
    w = jnp.asarray(W2D, dtype=uc2.dtype)
    out = jnp.zeros((n_fine, n_fine), dtype=uc2.dtype)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            out = out + w[dj + 1, di + 1] * jax.lax.slice(
                z, (1 + dj, 1 + di), (1 + dj + n_fine, 1 + di + n_fine))
    return out
