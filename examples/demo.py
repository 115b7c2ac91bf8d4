"""Demo driver reproducing the reference's example run (README.md:37-43,
test/testlib.cpp:147-213): builds the 35x35 / 8-level Poisson problem,
prints the level dof hierarchy, runs the standalone symmetric Gauss-Seidel
solver and the AMG solver, and reports iteration counts + final rss.

Run: python examples/demo.py        (CPU or GPU; f64)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from amg_jax import (LinearInterpolator, Multigrid, SparseGaussSeidel,
                     poisson, rss)


def main():
    n = 35
    n_levels = 8
    A, b = poisson.poisson2d(n)

    print("Multigrid instantiation:")
    amg = Multigrid(LinearInterpolator(n_levels), SparseGaussSeidel(),
                    A, b, n_levels, 1e-9, 5, 100)
    print("------------------")
    print("Dofs at Levels in Multigrid:")
    print("------------------")
    for level in range(n_levels):
        print(amg.get_n_dofs(level))

    print("------------------")
    print("Checking sparse gaussian solver:")
    print("------------------")
    gs = SparseGaussSeidel(tolerance=1e-9, compute_error_every_n_iters=100,
                           n_iters=1000)
    res_gs = gs.smooth(A, jnp.zeros_like(b), b, verbose=True)
    print(f"SPGS error: {res_gs.error:.6g}")

    print("------------------")
    print("Checking AMG solver:")
    print("------------------")
    res = amg.solve()
    print(f"AMG error: {res.error:.6g}")
    print(f"(reference: 35 iterations, rss 7.19199e-11; "
          f"900 GS sweeps, rss 8.69692e-10)")


if __name__ == "__main__":
    main()
