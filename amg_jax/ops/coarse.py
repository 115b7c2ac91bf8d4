"""Coarsest-level direct solver.

The reference factors the coarsest Galerkin matrix once with Eigen
SimplicialLDLT at hierarchy-construction time and back-solves every V-cycle
(include/amg/multigrid.hpp:240-243, 287-288). The coarsest level is tiny
(8 dofs in the reference benchmark), so here we densify it and cache a
dense LU factorization (pivoted LU handles the Laplacian's negative-definite
sign without a sign flip).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from amg_jax.sparse.ell import ELL


@partial(jax.tree_util.register_dataclass,
         data_fields=["lu", "piv"], meta_fields=[])
@dataclasses.dataclass(frozen=True)
class CoarseSolver:
    lu: jnp.ndarray
    piv: jnp.ndarray

    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        return jax.scipy.linalg.lu_solve((self.lu, self.piv), b)


def setup_coarse_solver(A: ELL) -> CoarseSolver:
    lu, piv = jax.scipy.linalg.lu_factor(A.to_dense())
    return CoarseSolver(lu=lu, piv=piv)
