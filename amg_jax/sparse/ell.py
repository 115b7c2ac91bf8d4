"""ELL (padded-row) sparse matrix — the core device sparse format.

Rationale: XLA compiles only static shapes, and accelerators want dense,
regular data. ELL stores a sparse matrix as two dense ``(n_rows, K)``
arrays (values + column indices, rows padded to the max row degree K), so
SpMV becomes a gather + an elementwise multiply + a row reduction — all
static-shape, fusible XLA ops. This replaces the reference's Eigen
``SparseMatrix`` CSC storage (used throughout include/amg/*.hpp); CSR/CSC
remain host-side *setup* formats (scipy, converted via ``ELL.from_scipy``),
ELL is what lives on device.

Padding convention: padded slots store ``col = row`` and ``val = 0`` so that
gathers stay within any row-partition's halo window and contribute exactly
zero to every product.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.tree_util.register_dataclass,
         data_fields=["data", "cols"],
         meta_fields=["shape"])
@dataclasses.dataclass(frozen=True)
class ELL:
    """Padded-row sparse matrix.

    Attributes:
      data:  (n_rows, K) values; padded slots are 0.
      cols:  (n_rows, K) int32 column indices; padded slots hold the row index.
      shape: (n_rows, n_cols) — static metadata.
    """

    data: jnp.ndarray
    cols: jnp.ndarray
    shape: tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def row_width(self) -> int:
        """K — padded entries per row."""
        return self.data.shape[1]

    @property
    def nnz(self) -> int:
        """Number of stored (non-padding) entries. Host-side utility."""
        return int(np.count_nonzero(np.asarray(self.data)))

    @property
    def dtype(self):
        return self.data.dtype

    # -- device ops -------------------------------------------------------

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """Sparse mat-vec ``A @ x`` (gather + multiply + row-sum).

        Replaces Eigen's ``A * u`` SpMV used in residual computation
        (include/amg/multigrid.hpp:272-274) and rss (common.hpp:17-27).
        """
        return jnp.sum(self.data * x[self.cols], axis=1)

    def matvec_offdiag_and_diag(self, x: jnp.ndarray):
        """Returns (offdiag_product, diag) where offdiag excludes i==j terms.

        This is the vectorized equivalent of the reference smoother inner loop
        ``matvecprod`` (include/amg/smoother.hpp:101-117) which splits the
        row sum into the diagonal value and the off-diagonal contribution.
        """
        row_ids = jnp.arange(self.n_rows)[:, None]
        is_diag = self.cols == row_ids
        prod = jnp.sum(jnp.where(is_diag, 0, self.data * x[self.cols]), axis=1)
        diag = jnp.sum(jnp.where(is_diag, self.data, 0), axis=1)
        return prod, diag

    def diag(self) -> jnp.ndarray:
        """Extract the diagonal."""
        row_ids = jnp.arange(self.n_rows)[:, None]
        return jnp.sum(jnp.where(self.cols == row_ids, self.data, 0), axis=1)

    def to_dense(self) -> jnp.ndarray:
        """Densify (small matrices only: oracle tests, coarsest-level solve)."""
        n, m = self.shape
        out = jnp.zeros((n, m), dtype=self.data.dtype)
        rows = jnp.broadcast_to(jnp.arange(n)[:, None], self.cols.shape)
        # Padded slots (val 0, col=row) scatter-add zero — harmless.
        return out.at[rows, self.cols].add(self.data)

    # -- host-side constructors ------------------------------------------

    @staticmethod
    def from_coo(rows, cols, vals, shape, dtype=None, sort_cols=True):
        """Build from host COO triplets (duplicates are summed, like
        Eigen setFromTriplets, include/amg/interpolator.hpp:130).

        Stored entries within each row are ordered by ascending column index
        (matching Eigen CSC inner ordering for symmetric matrices, which the
        reference's Gauss-Seidel accumulation relies on,
        include/amg/smoother.hpp:101-117).
        """
        import scipy.sparse as sp

        coo = sp.coo_matrix((np.asarray(vals), (np.asarray(rows), np.asarray(cols))),
                            shape=shape)
        return ELL.from_scipy(coo.tocsr(), dtype=dtype, sort_cols=sort_cols)

    @staticmethod
    def from_scipy(mat, dtype=None, sort_cols=True):
        """Build from a scipy sparse matrix (host setup path)."""
        csr = mat.tocsr()
        csr.sum_duplicates()
        if sort_cols:
            csr.sort_indices()
        # Drop numerically-zero stored entries so K is the true max degree.
        csr.eliminate_zeros()
        n, m = csr.shape
        deg = np.diff(csr.indptr)
        K = max(int(deg.max()) if n else 0, 1)
        data = np.zeros((n, K), dtype=csr.data.dtype)
        # Padding columns: the row index clamped into range (rectangular
        # matrices like P/R have n_rows != n_cols).
        pad_col = np.minimum(np.arange(n, dtype=np.int64), max(m - 1, 0))
        cols = np.tile(pad_col[:, None], (1, K))
        # Vectorized fill: position within row
        row_idx = np.repeat(np.arange(n), deg)
        pos = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], deg)
        data[row_idx, pos] = csr.data
        cols[row_idx, pos] = csr.indices
        if dtype is None:
            dtype = csr.data.dtype
        return ELL(data=jnp.asarray(data, dtype=dtype),
                   cols=jnp.asarray(cols, dtype=jnp.int32),
                   shape=(n, m))

    def to_scipy(self):
        """Convert back to scipy CSR (host-side; for setup/oracle use)."""
        import scipy.sparse as sp

        data = np.asarray(self.data)
        cols = np.asarray(self.cols)
        n, K = data.shape
        rows = np.repeat(np.arange(n), K)
        mat = sp.coo_matrix((data.ravel(), (rows, cols.ravel())), shape=self.shape)
        mat.sum_duplicates()
        mat = mat.tocsr()
        mat.eliminate_zeros()
        return mat

    def astype(self, dtype) -> "ELL":
        return ELL(data=self.data.astype(dtype), cols=self.cols, shape=self.shape)
