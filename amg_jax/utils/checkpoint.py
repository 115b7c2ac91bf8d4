"""Hierarchy serialization (checkpoint/resume).

ABSENT in the reference (SURVEY.md §5) — its solver state lives in in-memory
Eigen vectors. Here the expensive setup product (level matrices, transfer
operators, colorings, coarse factorization) can be saved once and reloaded,
skipping host-side SpGEMM on restart. Plain .npz keeps it dependency-free;
solution-vector snapshots ride along for resumable outer iterations.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def save_stencil_hierarchy(path: str, hier) -> None:
    from amg_jax.structured import StencilHierarchy

    assert isinstance(hier, StencilHierarchy)
    arrs = {"sides": np.asarray(hier.sides),
            "coarse_lu": np.asarray(hier.coarse_lu),
            "coarse_piv": np.asarray(hier.coarse_piv),
            "smoother": np.asarray(hier.smoother)}
    if hier.lam_maxes is not None:
        # Chebyshev spectral bounds (power-iteration estimates on
        # variable levels) must survive the round trip — without them a
        # reloaded chebyshev hierarchy would silently degrade to masked
        # GS on variable-coefficient levels
        arrs["lam_maxes"] = np.asarray(hier.lam_maxes)
    for i, lev in enumerate(hier.levels):
        # plane-free const levels (Stencil2D.const) serialize their 3x3
        # weights instead of (possibly multi-GB) plane arrays
        if lev.w33 is not None and lev.c.size == 0:
            arrs[f"w{i}"] = np.asarray(lev.w33)
        else:
            arrs[f"c{i}"] = np.asarray(lev.c)
    np.savez_compressed(path, **arrs)


def load_stencil_hierarchy(path: str, dtype=None):
    from amg_jax.ops.transfer import linear_interp_1d
    from amg_jax.sparse.stencil import Stencil2D, color_masks
    from amg_jax.structured import StencilHierarchy

    z = np.load(path)
    sides = tuple(int(s) for s in z["sides"])
    levels = []
    for i, side in enumerate(sides):
        if f"w{i}" in z:
            w33 = tuple(tuple(float(v) for v in row) for row in z[f"w{i}"])
            levels.append(Stencil2D.const(
                w33, side, dtype=(dtype or z["coarse_lu"].dtype)))
            continue
        c = z[f"c{i}"]
        if dtype is not None:
            c = c.astype(dtype)
        levels.append(Stencil2D.from_planes(jnp.asarray(c), side))
    dt = levels[0].c.dtype
    smoother = str(z["smoother"]) if "smoother" in z else "masked"
    P1s = tuple(jnp.asarray(linear_interp_1d(sides[l], sides[l + 1]
                                             ).toarray(), dtype=dt)
                for l in range(len(sides) - 1))
    # plane-free levels rebuild masks from iota at sweep time
    masks = tuple(None if lev.c.size == 0 else color_masks(s, dt)
                  for lev, s in zip(levels, sides))
    lam_maxes = (tuple(float(v) for v in z["lam_maxes"])
                 if "lam_maxes" in z else None)
    return StencilHierarchy(levels=tuple(levels),
                            coarse_lu=jnp.asarray(z["coarse_lu"]),
                            coarse_piv=jnp.asarray(z["coarse_piv"]),
                            P1s=P1s, masks=masks,
                            sides=sides, smoother=smoother,
                            lam_maxes=lam_maxes)


def save_hierarchy(path: str, hier) -> None:
    """Serialize an ELL ``multigrid.Hierarchy`` — the general path's
    expensive setup product (level operators + transfers from the Galerkin
    SpGEMM chain, multigrid.hpp:211-243)."""
    from amg_jax.multigrid import Hierarchy

    assert isinstance(hier, Hierarchy)
    arrs = {"n_levels": np.asarray(hier.n_levels)}
    for i, lev in enumerate(hier.levels):
        arrs[f"A{i}_data"] = np.asarray(lev.A.data)
        arrs[f"A{i}_cols"] = np.asarray(lev.A.cols)
        arrs[f"A{i}_shape"] = np.asarray(lev.A.shape)
        if lev.P is not None:
            arrs[f"P{i}_data"] = np.asarray(lev.P.data)
            arrs[f"P{i}_cols"] = np.asarray(lev.P.cols)
            arrs[f"P{i}_shape"] = np.asarray(lev.P.shape)
            arrs[f"R{i}_data"] = np.asarray(lev.R.data)
            arrs[f"R{i}_cols"] = np.asarray(lev.R.cols)
            arrs[f"R{i}_shape"] = np.asarray(lev.R.shape)
    np.savez_compressed(path, **arrs)


def load_hierarchy(path: str, smoother=None):
    """Reload an ELL hierarchy; the smoother's per-level state (host
    coloring — cheap, pattern-based) and the coarse LU are rebuilt."""
    from amg_jax.multigrid import Hierarchy, Level
    from amg_jax.ops.coarse import setup_coarse_solver
    from amg_jax.ops.smoothers import MulticolorGaussSeidel
    from amg_jax.sparse.ell import ELL

    if smoother is None:
        smoother = MulticolorGaussSeidel()
    z = np.load(path)
    n_levels = int(z["n_levels"])

    def ell(prefix):
        return ELL(data=jnp.asarray(z[f"{prefix}_data"]),
                   cols=jnp.asarray(z[f"{prefix}_cols"]),
                   shape=tuple(int(s) for s in z[f"{prefix}_shape"]))

    levels = []
    for i in range(n_levels):
        A = ell(f"A{i}")
        P = ell(f"P{i}") if f"P{i}_data" in z else None
        R = ell(f"R{i}") if f"R{i}_data" in z else None
        levels.append(Level(A=A, P=P, R=R,
                            smoother_state=smoother.setup(A)))
    coarse = setup_coarse_solver(levels[-1].A)
    return Hierarchy(levels=tuple(levels), coarse=coarse)


def save_solution(path: str, u, iteration: int, error: float) -> None:
    np.savez_compressed(path, u=np.asarray(u), iteration=iteration,
                        error=error)


def load_solution(path: str):
    z = np.load(path)
    return jnp.asarray(z["u"]), int(z["iteration"]), float(z["error"])
