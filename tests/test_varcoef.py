"""Variable-coefficient diffusion problems (models/varcoef.py) and the
on-device planes hierarchy (structured.build_stencil_hierarchy_planes).

The reference accepts any assembled sparse A (multigrid.hpp:151-244);
these tests exercise that generality on the standard harder AMG cases —
jump and (moderate) anisotropic coefficients — checking the device-built
operator bitwise against an independent host assembly, the device Galerkin
chain against host scipy RAP, and the end-to-end solve against a direct
solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from amg_jax.models import poisson
from amg_jax.models.varcoef import jump_planes, jump_scipy
from amg_jax.ops.rap import poisson_planes
from amg_jax.sparse.stencil import Stencil2D
from amg_jax.structured import (StructuredSolver,
                                build_stencil_hierarchy_planes)


def test_unit_coefficient_reduces_to_poisson():
    side = 31
    c = jump_planes(side, a_in=1.0, dtype=jnp.float64)
    p = poisson_planes(side, dtype=jnp.float64)
    assert float(jnp.abs(c - p).max()) == 0.0


@pytest.mark.parametrize("a_in,eps_y", [(100.0, 1.0), (1.0, 0.1),
                                        (1000.0, 0.5)])
def test_device_planes_match_host_assembly(a_in, eps_y):
    side = 31
    c = jump_planes(side, a_in=a_in, eps_y=eps_y, dtype=jnp.float64)
    A = jump_scipy(side, a_in=a_in, eps_y=eps_y)
    S = Stencil2D.from_scipy(A, side, dtype=jnp.float64)
    assert float(jnp.abs(c - S.c).max()) == 0.0


def test_device_rap_chain_matches_host_scipy():
    """build_stencil_hierarchy_planes' closed-form device RAP equals the
    host scipy Galerkin product (multigrid.hpp:219-223 pattern) on every
    level of a jump-coefficient hierarchy."""
    import scipy.sparse as sp

    from amg_jax.ops.transfer import linear_interp_1d

    side = 31
    c = jump_planes(side, a_in=100.0, dtype=jnp.float64)
    hier = build_stencil_hierarchy_planes(c, dtype=jnp.float64)
    A = jump_scipy(side, a_in=100.0)
    mats = [A.tocsr()]
    s = side
    for _ in range(hier.n_levels - 1):
        nc = (s - 1) // 2
        P = sp.kron(linear_interp_1d(s, nc), linear_interp_1d(s, nc)
                    ).tocsr()
        mats.append((P.T @ (mats[-1] @ P)).tocsr())
        s = nc
    for l, (S_dev, M) in enumerate(zip(hier.levels, mats)):
        S_host = Stencil2D.from_scipy(M, hier.sides[l], dtype=jnp.float64)
        scale = float(jnp.abs(S_host.c).max())
        md = float(jnp.abs(S_dev.c - S_host.c).max()) / scale
        assert md < 1e-14, f"level {l}: reldiff {md:.2e}"


def test_jump_solve_matches_direct():
    import scipy.sparse.linalg as spl

    side = 31
    A = jump_scipy(side, a_in=100.0)
    s = StructuredSolver(side, A_planes=jump_planes(side, a_in=100.0))
    assert s.smoother == "packed"  # the auto rule
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    res = s.solve_ir_fused(b2, tolerance=1e-9)
    assert res.converged and res.error <= 1e-9
    u_ref = spl.spsolve(A, np.asarray(b2).reshape(-1))
    rel = (np.abs(np.asarray(res.u).reshape(-1) - u_ref).max()
           / np.abs(u_ref).max())
    assert rel < 1e-4


def test_moderate_anisotropy_converges():
    """eps_y = 0.1 converges with the point smoother (slower than
    isotropic — the classic behavior); strong anisotropy (eps <= 0.01)
    needs line smoothers/semicoarsening and is documented out of scope."""
    side = 63
    s = StructuredSolver(side, A_planes=jump_planes(side, a_in=1.0,
                                                    eps_y=0.1))
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    res = s.solve_ir_fused(b2, tolerance=1e-9, n_refine=60)
    assert res.converged and res.iterations <= 60


def test_var_hierarchy_checkpoint_roundtrip(tmp_path):
    from amg_jax.utils.checkpoint import (load_stencil_hierarchy,
                                          save_stencil_hierarchy)

    side = 31
    hier = build_stencil_hierarchy_planes(jump_planes(side, a_in=100.0))
    p = tmp_path / "var_hier.npz"
    save_stencil_hierarchy(str(p), hier)
    h2 = load_stencil_hierarchy(str(p))
    assert h2.sides == hier.sides
    for a, b in zip(hier.levels, h2.levels):
        assert float(jnp.abs(a.c - b.c).max()) == 0.0
