"""amg_jax — an algebraic multigrid framework for JAX.

Built from scratch in JAX/XLA/Pallas with the full capability surface of the
reference C++/Eigen library (jfdev001/algebraic-multigrid; see SURVEY.md):
Poisson problem generation, Jacobi / Gauss-Seidel / SOR smoothers,
linear-interpolation grid transfer, Galerkin (R A P) coarse operators, a
cached direct coarsest-level solve, V-cycle orchestration — plus the
extensions the reference lacks: multicolor parallel smoothers,
structured 9-point stencil levels with Pallas kernels, mixed-precision
iterative refinement, and multi-device row-partitioned V-cycles over a
``jax.sharding.Mesh``.
"""

from amg_jax.models import poisson
from amg_jax.multigrid import (Hierarchy, Level, Multigrid, SolveResult,
                               build_hierarchy, galerkin_rap,
                               n_H_dofs_from_n_h_dofs, solve, vcycle)
from amg_jax.ops.smoothers import (Jacobi, MulticolorGaussSeidel,
                                   SmootherResult, SparseGaussSeidel,
                                   SuccessiveOverRelaxation)
from amg_jax.ops.transfer import (BilinearInterpolator2D, InterpolatorBase,
                                  LinearInterpolator)
from amg_jax.sparse.ell import ELL
from amg_jax.sparse.stencil import Stencil2D
from amg_jax.structured import (StencilHierarchy, build_stencil_hierarchy,
                                solve_ir, solve_stencil, vcycle_packed,
                                vcycle_stencil)
from amg_jax.utils.metrics import rss, rss_from_residual


def __getattr__(name):
    # Lazy heavyweight sub-APIs (avoid importing the distributed/krylov
    # machinery unless used).
    if name == "DistStructuredSolver":
        from amg_jax.parallel.structured_dist import DistStructuredSolver
        return DistStructuredSolver
    if name == "EllDistSolver":
        from amg_jax.parallel.ell_dist import EllDistSolver
        return EllDistSolver
    if name == "solve_pcg_stencil":
        from amg_jax.krylov import solve_pcg_stencil
        return solve_pcg_stencil
    if name == "solve_pcg_device":
        from amg_jax.krylov import solve_pcg_device
        return solve_pcg_device
    if name == "StructuredSolver":
        from amg_jax.structured import StructuredSolver
        return StructuredSolver
    raise AttributeError(name)


def enable_x64():
    """Enable f64 device numerics (required for the reference's 1e-9-scale
    tolerances; see SURVEY.md §7 design stance)."""
    import jax

    jax.config.update("jax_enable_x64", True)


__all__ = [
    "ELL", "Hierarchy", "Level", "Multigrid", "SolveResult",
    "build_hierarchy", "galerkin_rap", "n_H_dofs_from_n_h_dofs", "solve",
    "vcycle", "Jacobi", "MulticolorGaussSeidel", "SmootherResult",
    "SparseGaussSeidel", "SuccessiveOverRelaxation",
    "BilinearInterpolator2D", "InterpolatorBase", "LinearInterpolator",
    "poisson", "rss", "rss_from_residual", "enable_x64",
]
