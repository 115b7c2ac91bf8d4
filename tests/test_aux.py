"""Auxiliary subsystem tests: checkpoint/resume, configs, profiling
(SURVEY.md §5 equivalents)."""

import numpy as np
import jax.numpy as jnp

from amg_jax.config import (MeshConfig, SmootherConfig, SolverConfig,
                            StructuredConfig)
from amg_jax.models import poisson
from amg_jax.structured import build_stencil_hierarchy, solve_stencil
from amg_jax.utils import checkpoint
from amg_jax.utils.profiling import KernelStats, peak_for, time_fn


def test_checkpoint_roundtrip(tmp_path):
    side = 15
    hier = build_stencil_hierarchy(side, dtype=jnp.float64)
    path = str(tmp_path / "hier.npz")
    checkpoint.save_stencil_hierarchy(path, hier)
    loaded = checkpoint.load_stencil_hierarchy(path)
    assert loaded.sides == hier.sides
    for a, b in zip(loaded.levels, hier.levels):
        np.testing.assert_allclose(np.asarray(a.c), np.asarray(b.c))
    # loaded hierarchy solves identically
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    r1 = solve_stencil(hier, b2, tolerance=1e-9,
                       compute_error_every_n_iters=1)
    r2 = solve_stencil(loaded, b2, tolerance=1e-9,
                       compute_error_every_n_iters=1)
    assert r1.iterations == r2.iterations
    np.testing.assert_allclose(np.asarray(r1.u), np.asarray(r2.u))


def test_solution_snapshot_roundtrip(tmp_path):
    path = str(tmp_path / "u.npz")
    u = jnp.arange(10.0)
    checkpoint.save_solution(path, u, 7, 1e-5)
    u2, it, err = checkpoint.load_solution(path)
    np.testing.assert_allclose(np.asarray(u2), np.asarray(u))
    assert it == 7 and err == 1e-5


def test_config_defaults_match_reference():
    """Defaults mirror the reference's hard-coded ctor values
    (multigrid.hpp:155-156, smoother.hpp:25-37)."""
    s = SmootherConfig()
    assert (s.tolerance, s.compute_error_every_n_iters, s.n_iters) == (
        1e-9, 100, 1)
    m = SolverConfig()
    assert (m.tolerance, m.compute_error_every_n_iters, m.n_iters) == (
        1e-9, 10, 100)
    StructuredConfig()
    MeshConfig()


def test_configs_consumed_by_solvers():
    """The config dataclasses are accepted by the solver constructors and
    drive their behavior (not just asserted defaults)."""
    from amg_jax.multigrid import Multigrid
    from amg_jax.structured import StructuredSolver

    A, b = poisson.poisson2d(15)
    cfg = SolverConfig(n_levels=4, tolerance=1e-30,
                       compute_error_every_n_iters=2, n_iters=2)
    amg = Multigrid(None, None, A, b, 4, config=cfg)
    res = amg.solve(verbose=False)
    assert res.iterations == 2 and not res.converged  # n_iters honored

    scfg = StructuredConfig(pre_sweeps=2, post_sweeps=2, omega=1.2,
                            cycles_per_refine=3)
    s = StructuredSolver(15, precision="f64", config=scfg)
    assert s.cycles_per_refine == 3
    b2 = poisson.rhs(15, dtype=jnp.float64).reshape(15, 15)
    r = s.solve_ir(b2, tolerance=1e-9)
    assert r.converged


def test_profiling_counters():
    st = KernelStats(name="sweep", seconds=0.001, nnz=9_000_000, sweeps=2)
    assert st.nnz_per_s == 18_000_000_000
    r = peak_for("NVIDIA H100 80GB HBM3")
    sol = r.stencil_sweep_sol_s(1023 * 1023)
    assert 0 < sol < 1e-3
    assert "sweep" in st.summary(r, 1023 * 1023)
    t = time_fn(jnp.sin, jnp.ones(8), iters=2, warmup=1)
    assert t > 0


def test_api_docs_generator(tmp_path):
    """The docs pipeline (reference Doxygen analog) generates a page per
    module plus an index."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "gen_api_docs", os.path.join(os.path.dirname(__file__), "..",
                                     "scripts", "gen_api_docs.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    written = gen.main(str(tmp_path))
    assert "amg_jax_structured.md" in written
    assert "amg_jax_multigrid.md" in written
    text = (tmp_path / "amg_jax_structured.md").read_text()
    assert "StencilHierarchy" in text
    assert (tmp_path / "index.md").exists()


def test_ell_hierarchy_checkpoint_roundtrip(tmp_path):
    """The general (ELL) hierarchy — the expensive Galerkin setup product —
    round-trips through save/load and solves identically."""
    from amg_jax.multigrid import build_hierarchy, solve
    from amg_jax.ops.smoothers import MulticolorGaussSeidel

    A, b = poisson.poisson2d(20)
    sm = MulticolorGaussSeidel()
    hier = build_hierarchy(A, 4, smoother=sm)
    path = str(tmp_path / "ell_hier.npz")
    checkpoint.save_hierarchy(path, hier)
    loaded = checkpoint.load_hierarchy(path, smoother=sm)
    assert loaded.n_levels == hier.n_levels
    r1 = solve(hier, sm, b, tolerance=1e-9,
               compute_error_every_n_iters=1)
    r2 = solve(loaded, sm, b, tolerance=1e-9,
               compute_error_every_n_iters=1)
    assert r1.iterations == r2.iterations
    np.testing.assert_array_equal(np.asarray(r1.u), np.asarray(r2.u))


def test_checkpoint_plane_free_hierarchy_roundtrip():
    """Device-built (plane-free const) hierarchies must checkpoint: weights
    serialize instead of plane arrays, and the reloaded hierarchy solves
    identically."""
    import os
    import tempfile

    import jax.numpy as jnp
    import numpy as np
    from amg_jax.models import poisson
    from amg_jax.structured import (build_stencil_hierarchy_device,
                                    solve_stencil)
    from amg_jax.utils.checkpoint import (load_stencil_hierarchy,
                                          save_stencil_hierarchy)

    side = 31
    hier = build_stencil_hierarchy_device(side, dtype=jnp.float64)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "h.npz")
        save_stencil_hierarchy(p, hier)
        assert os.path.getsize(p) < 200_000  # weights, not planes
        h2 = load_stencil_hierarchy(p)
    assert h2.sides == hier.sides
    assert all(a.w33 == b.w33 for a, b in zip(h2.levels, hier.levels))
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    r1 = solve_stencil(hier, b2, tolerance=1e-9,
                       compute_error_every_n_iters=1)
    r2 = solve_stencil(h2, b2, tolerance=1e-9,
                       compute_error_every_n_iters=1)
    assert r2.converged and r1.iterations == r2.iterations
    np.testing.assert_allclose(np.asarray(r2.u), np.asarray(r1.u),
                               rtol=1e-12, atol=1e-14)


def test_explicit_args_beat_config():
    """A config must not silently override an explicitly
    passed constructor argument (None-sentinel resolution order:
    explicit > config > default)."""
    from amg_jax.structured import StructuredSolver

    cfg = StructuredConfig(smoother="masked", cycles_per_refine=3)
    s = StructuredSolver(15, smoother="packed", precision="f64",
                         config=cfg)
    assert s.smoother == "packed"          # explicit wins
    assert s.cycles_per_refine == 3        # config fills the rest
    s2 = StructuredSolver(15, precision="f64", config=cfg)
    assert s2.smoother == "masked"         # config wins over default
    s3 = StructuredSolver(15, precision="f64")
    assert s3.smoother == "packed"         # auto default


def test_prepared_rhs_solve_matches_wrapper():
    """prepare_b + solve_ir_device_prepared + finalize_u must reproduce
    solve_ir_device bitwise (the conversions are merely hoisted)."""
    import numpy as np

    from amg_jax.models import poisson
    from amg_jax.structured import StructuredSolver

    side = 255  # >= packed_min_side: the prepared path needs the
    # packed df32 solve loop
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    s = StructuredSolver(side)
    u_ref, st_ref = s.solve_ir_device(b2, tolerance=1e-9)
    u4, st = s.solve_ir_device_prepared(s.prepare_b(b2), tolerance=1e-9)
    np.testing.assert_array_equal(np.asarray(s.finalize_u(u4)),
                                  np.asarray(u_ref))
    np.testing.assert_array_equal(np.asarray(st), np.asarray(st_ref))


def test_relative_tolerance_mode():
    """rtol stops at err <= rtol * rss(b); absolute tol (reference
    semantics, common.hpp:17-27) remains the default and the two compose
    as max(tol, rtol * rss_b)."""
    from amg_jax.models import poisson
    from amg_jax.structured import StructuredSolver

    side = 63
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    s = StructuredSolver(side)
    rss_b = float(jnp.sum(b2 * b2))
    r_abs = s.solve_ir_fused(b2, tolerance=1e-9)
    r_rel = s.solve_ir_fused(b2, tolerance=1e-30, rtol=1e-12)
    assert r_rel.converged and r_rel.error <= 1e-12 * rss_b
    # a loose rtol must stop earlier than the tight absolute solve
    r_loose = s.solve_ir_fused(b2, tolerance=1e-30, rtol=1e-9)
    assert r_loose.iterations <= r_abs.iterations


def test_enable_persistent_cache_sets_stable_key_configs(tmp_path,
                                                        monkeypatch):
    """enable_persistent_cache must pin the three configs that make the
    on-disk compilation cache hit across processes — in particular
    jax_include_full_tracebacks_in_locations=False, without which a
    Pallas kernel payload embeds the CALLER's filename/line numbers and
    every entry script gets a fresh cache key (see
    amg_jax/utils/cache.py)."""
    import jax as _jax

    from amg_jax.utils.cache import enable_persistent_cache

    saved = {
        "jax_compilation_cache_dir":
            _jax.config.jax_compilation_cache_dir,
        "jax_persistent_cache_min_compile_time_secs":
            _jax.config.jax_persistent_cache_min_compile_time_secs,
        "jax_include_full_tracebacks_in_locations":
            _jax.config.jax_include_full_tracebacks_in_locations,
    }
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        enable_persistent_cache(min_compile_secs=2.5)
        assert _jax.config.jax_compilation_cache_dir == str(tmp_path)
        assert (_jax.config.jax_persistent_cache_min_compile_time_secs
                == 2.5)
        assert not _jax.config.jax_include_full_tracebacks_in_locations
        # idempotent; stable_keys=False leaves locations rich
        _jax.config.update("jax_include_full_tracebacks_in_locations",
                           True)
        enable_persistent_cache(stable_keys=False)
        assert _jax.config.jax_include_full_tracebacks_in_locations
    finally:
        for k, v in saved.items():
            _jax.config.update(k, v)
