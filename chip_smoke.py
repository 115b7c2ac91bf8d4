#!/usr/bin/env python3
"""Smoke run of the solver library on NVIDIA GPUs, checked against plain
host references.

Run from the repository root:

    python3 chip_smoke.py           # one GPU: phases a-c below
    python3 chip_smoke.py --four    # four GPUs: the multi-device checks only

Phases (one process; each raises on a failed check, nothing is caught):

  a. double-float32 arithmetic on the card: two_sum, split_f32 and
     two_prod against exact f64 on 1M random f32 pairs; the df32
     residuals (constant Poisson at 4095^2, jump coefficients at 2047^2)
     against f64 residuals computed on the host.
  b. the main path, ``StructuredSolver(side)`` with the default
     smoother, at 4095^2 and 8191^2 to rss <= 1e-7 (absolute, the
     reference's semantics), the rss recomputed on the host in f64; at
     1023^2 also the answer against scipy's sparse direct solve.
  c. the other entry points: the jump-coefficient solve at 2047^2, the
     device-resident AMG-preconditioned CG at 2047^2 in f32, and the
     reference-parity ELL pipeline (1225 dofs, f64, 35 V-cycles).
  e. (--four) the distributed solvers on four GPUs against the
     single-device solve.

Every number printed is measured on the device named in the lines above
it. The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
The script exits non-zero, and prints no such line, when JAX finds no GPU.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

TOL = 1e-7          # absolute rss, the reference's semantics
DF32_REL_TOL = 1e-13
# grid sides per phase
DF32_SIDES = (4095, 2047)          # constant Poisson, jump coefficients
FLAGSHIP_SIDES = (1023, 4095, 8191)
DIRECT_SIDE = 1023                 # also compared with scipy's spsolve
ENTRY_SIDE = 2047
FOUR_SIDE = 4095


T_START = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f}s] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"check failed: {what}")
    log(f"  check ok: {what}")


# ---------------------------------------------------------------------------
# Plain host references (numpy/scipy, f64), independent of the library.


def poisson_rhs_np(side: int) -> np.ndarray:
    """f(x, y) = 5 exp(-10 (x^2 + y^2)) at the interior points of the
    uniform grid on [-1, 1]^2 (the reference's forcing)."""
    x = np.linspace(-1.0, 1.0, side + 2)[1:-1]
    X, Y = np.meshgrid(x, x, indexing="ij")
    return 5.0 * np.exp(-10.0 * (X * X + Y * Y))


def poisson_residual_np(u: np.ndarray, b: np.ndarray) -> np.ndarray:
    """b - A u for the 5-point Laplacian (1/h^2 [1, -4, 1], h = 2/(n+1))
    with zero Dirichlet boundary, by numpy slicing."""
    n = u.shape[0]
    inv_h2 = ((n + 1) / 2.0) ** 2
    up = np.pad(u, 1)
    au = (up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
          - 4.0 * u) * inv_h2
    return b - au


def jump_residual_np(u: np.ndarray, b: np.ndarray, a_in: float,
                     r: float = 0.5) -> np.ndarray:
    """b - A u for -div(a grad u) with a = a_in on |x|,|y| < r else 1:
    5-point finite volumes, harmonic-mean face coefficients, zero
    Dirichlet boundary (the operator of models/varcoef.py)."""
    n = u.shape[0]
    h = 2.0 / (n + 1)
    xs = -1.0 + np.arange(n + 2) * np.float64(np.float32(h))
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    a = np.where((np.abs(X) < r) & (np.abs(Y) < r), a_in, 1.0)
    c = a[1:-1, 1:-1]

    def face(q):
        return 2.0 * c * q / (c + q)

    aN, aS = face(a[2:, 1:-1]), face(a[:-2, 1:-1])
    aE, aW = face(a[1:-1, 2:]), face(a[1:-1, :-2])
    up = np.pad(u, 1)
    au = (aN * up[2:, 1:-1] + aS * up[:-2, 1:-1] + aE * up[1:-1, 2:]
          + aW * up[1:-1, :-2] - (aN + aS + aE + aW) * u) / (h * h)
    return b - au


def rss_np(r: np.ndarray) -> float:
    r = r.reshape(-1)
    return float(r @ r)


# ---------------------------------------------------------------------------


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def mem_stat(dev, key: str = "peak_bytes_in_use") -> int:
    return int(dev.memory_stats()[key])


def timed(fn, *args, reps: int):
    """(first-call seconds, [steady seconds]); every call ends in
    block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, first, times


def fmt_times(ts) -> str:
    return "[" + ", ".join(f"{t:.6f}" for t in ts) + "]"


# ---------------------------------------------------------------------------
# a. df32 arithmetic


def exact_bits_ok(x: np.ndarray, bits: int) -> bool:
    """Every entry has at most ``bits`` significant bits."""
    m, _ = np.frexp(x.astype(np.float64))
    return bool(np.all(np.ldexp(m, bits) == np.round(np.ldexp(m, bits))))


def phase_df32(dev) -> None:
    import jax
    import jax.numpy as jnp

    from amg_jax.models.varcoef import jump_planes
    from amg_jax.ops.doublefloat import (DF32, df_residual, split_f32,
                                         split_f64, two_prod, two_sum)
    from amg_jax.ops.rap import poisson_const_w33
    from amg_jax.sparse.packed import df_residual_const_packed, pack, unpack

    log("phase a: df32 error-free transforms and residuals")
    rng = np.random.default_rng(0)
    n = 1 << 20

    def rand_f32():
        # |x| in [2^-8, 2^9): sums and products of two are exact in f64
        mag = (1.0 + rng.random(n)) * 2.0 ** rng.integers(-8, 9, n)
        return (np.where(rng.random(n) < 0.5, -mag, mag)).astype(np.float32)

    a, b = rand_f32(), rand_f32()
    f = jax.jit(lambda x, y: (two_sum(x, y), split_f32(x), two_prod(x, y)))
    (s, e), (hi, lo), (p, pe) = jax.device_get(
        f(jax.device_put(a, dev), jax.device_put(b, dev)))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    check(np.array_equal(s, a + b) and np.array_equal(
        e.astype(np.float64), (a64 + b64) - s.astype(np.float64)),
        "two_sum: s = fl(a+b), e = (a+b) - s exactly, 1M pairs")
    check(np.array_equal(hi.astype(np.float64) + lo.astype(np.float64), a64)
          and exact_bits_ok(hi, 12) and exact_bits_ok(lo, 12),
          "split_f32: hi + lo = a exactly, 12-bit halves, 1M values")
    check(np.array_equal(p, a * b) and np.array_equal(
        pe.astype(np.float64), a64 * b64 - p.astype(np.float64)),
        "two_prod: p = fl(ab), e = ab - p exactly, 1M pairs")
    x = rng.standard_normal(n) * 2.0 ** rng.integers(-20, 21, n)
    x_hi, x_lo = jax.device_get(jax.jit(split_f64)(jax.device_put(x, dev)))
    ref_hi = x.astype(np.float32)
    ref_lo = (x - ref_hi.astype(np.float64)).astype(np.float32)
    check(np.array_equal(x_hi, ref_hi) and np.array_equal(x_lo, ref_lo),
          "split_f64: hi = f32(x), lo = f32(x - hi) exactly, 1M values")

    def split64(x):
        x_hi = x.astype(np.float32)
        x_lo = (x - x_hi.astype(np.float64)).astype(np.float32)
        return x_hi, x_lo, x_hi.astype(np.float64) + x_lo.astype(np.float64)

    # constant-Poisson packed residual at 4095^2 (random u: no
    # cancellation, so the comparison sees the arithmetic alone)
    side = DF32_SIDES[0]
    m = (side - 1) // 2
    w33 = poisson_const_w33(side, 1)[0]
    u_hi, u_lo, u_ref = split64(rng.standard_normal((side, side)))
    b_hi, b_lo, b_ref = split64(rng.standard_normal((side, side)))

    @jax.jit
    def res_const(uh, ul, bh, bl):
        r4 = df_residual_const_packed(
            w33, DF32(hi=pack(bh, m), lo=pack(bl, m)),
            DF32(hi=pack(uh, m), lo=pack(ul, m)), m)
        return unpack(r4.hi, m), unpack(r4.lo, m)

    put = lambda x: jax.device_put(x, dev)
    r_hi, r_lo = jax.device_get(res_const(put(u_hi), put(u_lo), put(b_hi),
                                          put(b_lo)))
    r_ref = poisson_residual_np(u_ref, b_ref)
    rel = (np.abs(r_hi.astype(np.float64) + r_lo - r_ref).max()
           / np.abs(r_ref).max())
    log(f"  df_residual_const_packed {side}^2: max rel diff vs f64 = "
        f"{rel:.3e}")
    check(rel <= DF32_REL_TOL, f"df_residual_const_packed rel diff "
          f"{rel:.3e} <= {DF32_REL_TOL:g}")

    # variable-coefficient residual (df_mul / two_prod on every term)
    side = DF32_SIDES[1]
    a_in = 100.0
    planes = jump_planes(side, a_in=a_in, dtype=jnp.float64)
    c_df = DF32.from_f64(jax.device_put(planes, dev))
    u_hi, u_lo, u_ref = split64(rng.standard_normal((side, side)))
    b_hi, b_lo, b_ref = split64(rng.standard_normal((side, side)))
    r = jax.jit(df_residual)(c_df, DF32(hi=put(b_hi), lo=put(b_lo)),
                             DF32(hi=put(u_hi), lo=put(u_lo)))
    r_df = np.asarray(r.hi).astype(np.float64) + np.asarray(r.lo)
    r_ref = jump_residual_np(u_ref, b_ref, a_in)
    rel = np.abs(r_df - r_ref).max() / np.abs(r_ref).max()
    log(f"  df_residual jump {side}^2: max rel diff vs f64 = {rel:.3e}")
    check(rel <= DF32_REL_TOL, f"df_residual (jump planes) rel diff "
          f"{rel:.3e} <= {DF32_REL_TOL:g}")
    del planes, c_df, r
    log(f"  peak_bytes_in_use={mem_stat(dev)}")


# ---------------------------------------------------------------------------
# b. flagship solves


def solve_and_report(name: str, solver, b_np: np.ndarray, dev,
                     residual_np, setup_s: float, reps: int = 3):
    import jax

    b = jax.device_put(b_np, dev)
    (u, stats), first, times = timed(
        lambda bb: solver.solve_ir_device(bb, tolerance=TOL), b, reps=reps)
    rss_dev, refines = (float(v) for v in np.asarray(stats))
    u_np = np.asarray(u)
    rss_host = rss_np(residual_np(u_np, b_np))
    cycles = int(refines) * solver.cycles_per_refine
    log(f"  {name}: setup_s={setup_s:.3f} first_call_s={first:.3f} "
        f"(compile + one solve) solve_s={fmt_times(times)} "
        f"refines={int(refines)} cycles={cycles} (+FMG start) "
        f"rss_device={rss_dev:.6e} rss_host_f64={rss_host:.6e} "
        f"peak_bytes_in_use={mem_stat(dev)}")
    check(rss_dev <= TOL and rss_host <= TOL,
          f"{name}: rss <= {TOL:g} on the device and recomputed on the host")
    return u_np, rss_host, min(times)


def build_solver(dev, *args, **kw):
    import jax

    from amg_jax.structured import StructuredSolver

    t0 = time.perf_counter()
    with jax.default_device(dev):
        s = StructuredSolver(*args, **kw)
    jax.block_until_ready(s.hier)
    return s, time.perf_counter() - t0


def phase_flagship(dev) -> dict:
    import scipy.sparse.linalg as spl

    from amg_jax.models import poisson

    log("phase b: StructuredSolver(side), default smoother, rss <= 1e-7")
    out = {}
    for side in FLAGSHIP_SIDES:
        s, setup_s = build_solver(dev, side)
        b_np = poisson_rhs_np(side)
        u_np, rss_host, t = solve_and_report(
            f"poisson {side}^2", s, b_np, dev, poisson_residual_np, setup_s)
        out[side] = t
        if side == DIRECT_SIDE:
            # ||u - u*||_inf <= ||A^-1||_2 ||r||_2 = sqrt(rss) / lambda_min,
            # lambda_min = (8/h^2) sin^2(pi h / 4) of -A (h = 2/(n+1))
            A = poisson.laplacian_scipy(side).tocsc()
            t0 = time.perf_counter()
            u_ref = spl.spsolve(A, b_np.reshape(-1)).reshape(side, side)
            h = 2.0 / (side + 1)
            lam_min = 8.0 / h ** 2 * np.sin(np.pi * h / 4) ** 2
            bound = np.sqrt(rss_host) / lam_min
            diff = float(np.abs(u_np - u_ref).max())
            log(f"  scipy spsolve {side}^2 ({time.perf_counter() - t0:.1f} s "
                f"on the host): max|u - u_ref| = {diff:.3e}, bound "
                f"sqrt(rss)/lambda_min = {bound:.3e}")
            check(diff <= bound, f"{side}^2 answer within "
                  "sqrt(rss)/lambda_min of the direct solve")
        del s
    return out


# ---------------------------------------------------------------------------
# c. other entry points


def phase_entry_points(dev) -> None:
    import jax
    import jax.numpy as jnp

    from amg_jax import LinearInterpolator, Multigrid, SparseGaussSeidel
    from amg_jax.krylov import solve_pcg_device
    from amg_jax.models import poisson
    from amg_jax.models.varcoef import jump_planes
    from amg_jax.structured import build_stencil_hierarchy_device

    log("phase c: other public entry points")
    side, a_in = ENTRY_SIDE, 100.0
    t0 = time.perf_counter()
    with jax.default_device(dev):
        # f64 planes: the f64 residual then sees the exact operator
        planes = jump_planes(side, a_in=a_in, dtype=jnp.float64)
    s, setup_s = build_solver(dev, side, A_planes=planes)
    setup_s += time.perf_counter() - t0
    b_np = poisson_rhs_np(side)
    solve_and_report(f"jump a={a_in:g} {side}^2", s, b_np, dev,
                     lambda u, b: jump_residual_np(u, b, a_in), setup_s)
    del s, planes

    # f32 PCG: the device loop stops on its own (recurrence) rss. An f32
    # iterate cannot have a true rss below the one f32 rounding of the
    # exact answer leaves, so the host check compares with that floor.
    tol_pcg = 1e-5
    with jax.default_device(dev):
        hier = build_stencil_hierarchy_device(side, smoother="packed")
        b32 = jax.device_put(b_np.astype(np.float32), dev)
        (u, stats), first, times = timed(
            lambda bb: solve_pcg_device(hier, bb, tolerance=tol_pcg), b32,
            reps=3)
    err, iters = (float(v) for v in np.asarray(stats))
    s64, _ = build_solver(dev, side)
    u_ref, _ = s64.solve_ir_device(jax.device_put(b_np, dev), tolerance=TOL)
    u_ref = np.asarray(u_ref)
    floor = rss_np(poisson_residual_np(
        u_ref.astype(np.float32).astype(np.float64), b_np))
    rss_host = rss_np(poisson_residual_np(np.asarray(u, np.float64), b_np))
    log(f"  pcg f32 {side}^2: first_call_s={first:.3f} "
        f"solve_s={fmt_times(times)} iters={int(iters)} "
        f"rss_device={err:.6e} rss_host_f64={rss_host:.6e} "
        f"f32_floor_rss={floor:.6e} max|u - u_df32|="
        f"{np.abs(np.asarray(u, np.float64) - u_ref).max():.3e} "
        f"peak_bytes_in_use={mem_stat(dev)}")
    check(err <= tol_pcg, f"pcg device rss <= {tol_pcg:g}")
    check(rss_host <= 10.0 * floor, "pcg host rss within 10x the rss of "
          "the f32-rounded df32 answer")
    del hier, s64

    # reference-parity ELL pipeline (README.md:37-43 of the reference)
    with jax.default_device(dev):
        A, b = poisson.poisson2d(35, dtype=jnp.float64)
        amg = Multigrid(LinearInterpolator(8), SparseGaussSeidel(), A, b,
                        8, 1e-9, 5, 100)
        t0 = time.perf_counter()
        res = amg.solve()
        wall = time.perf_counter() - t0
    A_np = poisson.laplacian_scipy(35)
    b_np = np.asarray(b)
    r = b_np - A_np @ np.asarray(res.u)
    rss_host = float(r @ r)
    log(f"  ELL Multigrid 1225 dofs f64: iterations={res.iterations} "
        f"rss={res.error:.6e} rss_host_f64={rss_host:.6e} "
        f"wall_s={wall:.3f} (compile included)")
    check(res.iterations == 35, "ELL parity: 35 V-cycles")
    check(abs(rss_host - 7.19199e-11) <= 1e-15,
          "ELL parity: host rss = 7.19199e-11 (reference, 6 digits)")


# ---------------------------------------------------------------------------
# e. four devices (--four)


def phase_four(devs) -> None:
    import jax

    import __graft_entry__
    from amg_jax.parallel.structured_dist import DistStructuredSolver

    log("phase e: four devices")
    side = FOUR_SIDE
    b_np = poisson_rhs_np(side)
    t0 = time.perf_counter()
    dist = DistStructuredSolver(side, n_devices=4)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = dist.solve_ir(b_np, tolerance=TOL)
    u_dist = np.asarray(res.u)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = dist.solve_ir(b_np, tolerance=TOL)
    u_dist = np.asarray(res.u)
    second = time.perf_counter() - t0
    rss_dist = rss_np(poisson_residual_np(u_dist, b_np))
    log(f"  DistStructuredSolver({side}, n_devices=4, halo="
        f"{dist.cfg.halo!r}).solve_ir: setup_s={setup_s:.3f} "
        f"first_call_s={first:.3f} second_call_s={second:.3f} "
        f"(host-stepped refines) iterations={res.iterations} "
        f"rss={res.error:.6e} rss_host_f64={rss_dist:.6e}")
    for d in devs[:4]:
        log(f"  device {d.id}: bytes_in_use={mem_stat(d, 'bytes_in_use')}"
            f" peak_bytes_in_use={mem_stat(d)}")
    check(res.error <= TOL and rss_dist <= TOL,
          "distributed rss <= 1e-7 on the devices and on the host")
    single, setup1 = build_solver(devs[0], side)
    u_single, rss_single, _ = solve_and_report(
        f"single-device poisson {side}^2", single, b_np, devs[0],
        poisson_residual_np, setup1, reps=1)
    h = 2.0 / (side + 1)
    lam_min = 8.0 / h ** 2 * np.sin(np.pi * h / 4) ** 2
    bound = (np.sqrt(rss_dist) + np.sqrt(rss_single)) / lam_min
    diff = float(np.abs(u_dist - u_single).max())
    log(f"  max|u_dist - u_single| = {diff:.3e}, bound (sqrt(rss_dist) + "
        f"sqrt(rss_single)) / lambda_min = {bound:.3e}")
    check(diff <= bound, "distributed and single-device answers agree "
          "within their residual bounds")
    del single
    __graft_entry__.dryrun_multichip(4)
    check(True, "dryrun_multichip(4): distributed V-cycle, PCG and ELL "
          "checks")
    for d in devs[:4]:
        log(f"  device {d.id}: bytes_in_use={mem_stat(d, 'bytes_in_use')}"
            f" peak_bytes_in_use={mem_stat(d)}")


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU checks")
    ap.add_argument("--phases", default="abc",
                    help="one-GPU phases to run (default: abc)")
    args = ap.parse_args()

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devs[0].platform!r} "
              "devices", file=sys.stderr)
        return 1
    if args.four and len(devs) < 4:
        print(f"chip_smoke --four: needs 4 GPUs, found {len(devs)}",
              file=sys.stderr)
        return 1

    jax.config.update("jax_enable_x64", True)
    from amg_jax.utils.cache import enable_persistent_cache

    cache = enable_persistent_cache()
    for line in card_lines():
        log(f"card: {line}")
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind} "
        f"({devs[0].platform}); compile cache {cache}")

    dev = devs[0]
    if args.four:
        phase_four(devs)
    else:
        if "a" in args.phases:
            phase_df32(dev)
        if "b" in args.phases:
            phase_flagship(dev)
        if "c" in args.phases:
            phase_entry_points(dev)
    log(f"card: {card_lines()[0]}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
