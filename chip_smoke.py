"""Smoke run of the solver library on an NVIDIA GPU.

Drives the main path — SquarePlanner -> operator -> CG / BiCGStab /
GMRES / PCG ``.solve(n)`` — at the sizes its users run (2-D 5-point at
4096^2 = 16.7M unknowns, 3-D at 256^3, 1-D at 2^24, explicit matrices at
2^22-2^24 rows), checks every result against a plain fp64 numpy / scipy
reference of the same recurrence, and checks the s-step Triton kernel
against the plain jnp version of its pass.  Each phase prints its maximum
relative deviation and the tolerance it is held to; a deviation above
tolerance raises.  The last line is one JSON object naming the device.

    python chip_smoke.py           # one GPU, phases a-h
    python chip_smoke.py --four    # four GPUs: the sharded path only

Exits non-zero, printing no result, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import numpy as np

GOLDEN = [100, 4900, 4704, 4512, 4324, 4140, 3960, 3784, 3612, 3444, 3280]


# ------------------------------------------------------------ references

def np_stencil(shape, offsets):
    """Matrix-free fp64 apply of a Dirichlet stencil on a grid of
    ``shape`` (flat vectors in, flat vectors out)."""
    shape = tuple(shape)

    def apply(x):
        g = np.asarray(x, np.float64).reshape(shape)
        y = np.zeros_like(g)
        for off, v in offsets:
            dst, src = [], []
            for o, n in zip(off, shape):
                dst.append(slice(max(0, -o), n - max(0, o)))
                src.append(slice(max(0, o), n - max(0, -o)))
            y[tuple(dst)] += v * g[tuple(src)]
        return y.reshape(-1)

    return apply


def np_cg(apply, b, iters, minv=None):
    """(residual^2 history, x) of CG (PCG with diagonal ``minv``) from
    x0 = 0 — the recurrence of solvers/cg.py and solvers/pcg.py."""
    x = np.zeros_like(b)
    r = b.copy()
    z = r if minv is None else minv * r
    p = z.copy()
    rz = r @ z
    hist = [r @ r]
    for _ in range(iters):
        q = apply(p)
        a = rz / (p @ q)
        x += a * p
        r -= a * q
        z = r if minv is None else minv * r
        rz_new = r @ z
        hist.append(r @ r)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return np.array(hist), x


def np_bicgstab(apply, b, iters):
    """Residual^2 history of BiCGStab from x0 = 0, r~ = b (solvers/bicgstab.py)."""
    x = np.zeros_like(b)
    r = b.copy()
    rt = b.copy()
    p = np.zeros_like(b)
    v = np.zeros_like(b)
    rho, alpha, omega = 1.0, 0.0, 1.0
    hist = [r @ r]
    for _ in range(iters):
        rho_new = rt @ r
        beta = (rho_new / rho) * (alpha / omega)
        rho = rho_new
        p = r + beta * (p - omega * v)
        v = apply(p)
        alpha = rho / (rt @ v)
        s = r - alpha * v
        t = apply(s)
        omega = (t @ s) / (t @ t)
        x += alpha * p + omega * s
        r = s - omega * t
        hist.append(r @ r)
    return np.array(hist)


def np_gmres(apply, b, m, cycles):
    """||r||^2 at the start of each GMRES(m) cycle plus the final one, from
    x0 = 0 (solvers/gmres.py): Arnoldi with modified Gram-Schmidt and a
    dense least-squares solve — minimal residual over the Krylov space."""
    x = np.zeros_like(b)
    hist = []
    for _ in range(cycles):
        r = b - apply(x)
        beta = np.sqrt(r @ r)
        hist.append(beta * beta)
        V = [r / beta]
        H = np.zeros((m + 1, m))
        for j in range(m):
            w = apply(V[j])
            for i in range(j + 1):
                H[i, j] = V[i] @ w
                w -= H[i, j] * V[i]
            H[j + 1, j] = np.sqrt(w @ w)
            V.append(w / H[j + 1, j])
        e1 = np.zeros(m + 1)
        e1[0] = beta
        y = np.linalg.lstsq(H, e1, rcond=None)[0]
        x = x + sum(y[j] * V[j] for j in range(m))
    r = b - apply(x)
    hist.append(r @ r)
    return np.array(hist)


def rel_dev(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.isfinite(got)), "non-finite result"
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)))


def check(phase, what, dev, tol, why):
    print(f"[{phase}] {what}: max rel deviation {dev:.3e} "
          f"(tolerance {tol:.0e}: {why})", flush=True)
    if not dev <= tol:
        raise AssertionError(f"phase {phase}: {what} deviates {dev:.3e} > {tol:.0e}")


F32_WHY = ("f32 dots over {n} terms summed in another order than the fp64 "
           "reference, compounding over {it} iterations")
F64_WHY = ("f64 dots over {n} terms summed in another order, amplified by "
           "BiCGStab's cancelling rho over {it} iterations")


# --------------------------------------------------------------- builders

def stencil_system(dim, shape, dtype, block=False, pieces=1, mesh=None):
    """The benchmark's planner (benchmark.build_planner) for ``dim``."""
    import jax.numpy as jnp

    from legionsolvers_tpu import SolverOptions
    from legionsolvers_tpu.benchmark import build_planner

    shape = tuple(shape) + (1,) * (3 - len(shape))
    args = SimpleNamespace(dim=dim, nx=shape[0], ny=shape[1], nz=shape[2],
                           vp=pieces, block=block)
    options = SolverOptions(entry_dtype=jnp.dtype(dtype))
    planner, _, _ = build_planner(args, mesh, options)
    return planner


def explicit_system(A, dtype, pieces=1, mesh=None):
    import jax.numpy as jnp

    from legionsolvers_tpu import (
        BlockPartition,
        PartitionedVector,
        SolverOptions,
        SquarePlanner,
    )

    opts = SolverOptions(entry_dtype=jnp.dtype(dtype))
    part = BlockPartition(A.n_range, pieces)
    planner = SquarePlanner(mesh=mesh, options=opts)
    planner.add_sol_vector(PartitionedVector(
        "x", part, mesh=mesh, options=opts).zero_fill())
    planner.add_rhs_vector(PartitionedVector(
        "b", part, mesh=mesh, options=opts).constant_fill(1.0))
    planner.add_row_partitioned_matrix(A, 0, 0)
    return planner


def solution(planner, space=0):
    return np.asarray(planner.get_vector(0, space).to_numpy(), np.float64)


# ----------------------------------------------------------------- phases

def phase_a(pieces=1, mesh=None):
    """The reference's golden: 1-D n=100 fp64 CG, exact."""
    import jax.numpy as jnp

    from legionsolvers_tpu import (CGSolver, SolverOptions,
                                   coo_negative_laplacian_1d)

    A = coo_negative_laplacian_1d(
        100, options=SolverOptions(entry_dtype=jnp.float64))
    planner = explicit_system(A, "float64", pieces, mesh)
    hist = [float(h) for h in np.asarray(CGSolver(planner).solve(10))]
    check("a", f"1-D n=100 fp64 CG golden on {pieces} shard(s)",
          rel_dev(hist, GOLDEN), 0.0, "exact-integer fp64 trajectory")
    return hist


def phase_b(n=4096, iters=50):
    """2-D 5-point CG in f32 against fp64 numpy CG; returns the reference
    history and the compile seconds of the solve."""
    from legionsolvers_tpu import CGSolver, laplacian_stencil

    planner = stencil_system(2, (n, n), "float32")
    solver = CGSolver(planner)
    t0 = time.perf_counter()
    np.asarray(solver.solve(iters))
    first = time.perf_counter() - t0
    for v in planner.sol_vectors:
        v.zero_fill()
    solver.reset()
    t0 = time.perf_counter()
    hist = np.asarray(solver.solve(iters))
    compile_s = first - (time.perf_counter() - t0)
    ref, xref = np_cg(np_stencil((n, n), laplacian_stencil(2)),
                      np.ones(n * n), iters)
    why = F32_WHY.format(n=n * n, it=iters)
    check("b", f"2-D 5-pt CG {n}^2 f32, {iters} it, residual^2 history",
          rel_dev(hist, ref), 1e-2, why)
    xd = float(np.max(np.abs(solution(planner) - xref)) / np.max(np.abs(xref)))
    check("b", f"2-D 5-pt CG {n}^2 f32 solution (max-norm relative)",
          xd, 1e-2, why)
    return ref, compile_s


def phase_c(n=4096, bicg_it=20, restart=10, cycles=2, pcg_it=50):
    """BiCGStab (f64), GMRES(restart) and PCG-Jacobi (f32) on the 2-D grid.
    BiCGStab runs in f64: in f32 its trajectory is reduction-order chaotic
    on this operator (rho = <r~, r> cancels below the f32 noise floor), so
    no two summation orders — and no f32 run against any reference — agree
    after ten-odd iterations."""
    from legionsolvers_tpu import (BiCGStabSolver, GMRESSolver,
                                   JacobiPreconditioner, PCGSolver,
                                   laplacian_stencil)

    st = laplacian_stencil(2)
    apply = np_stencil((n, n), st)
    b = np.ones(n * n)
    N = n * n
    h = np.asarray(BiCGStabSolver(stencil_system(2, (n, n), "float64"))
                   .solve(bicg_it))
    check("c", f"BiCGStab {n}^2 f64, {bicg_it} it", rel_dev(h, np_bicgstab(
        apply, b, bicg_it)), 1e-4, F64_WHY.format(n=N, it=bicg_it))
    h = np.asarray(GMRESSolver(stencil_system(2, (n, n), "float32"),
                               restart=restart).solve(cycles))
    check("c", f"GMRES({restart}) {n}^2 f32, {cycles} cycles", rel_dev(
        h, np_gmres(apply, b, restart, cycles)), 1e-2,
        "f32 basis orthogonalized in HIGHEST-precision f32 products; "
        "the minimal residual is well conditioned")
    planner = stencil_system(2, (n, n), "float32")
    h = np.asarray(PCGSolver(planner, JacobiPreconditioner(planner))
                   .solve(pcg_it))
    ref, _ = np_cg(apply, b, pcg_it, minv=np.full(N, 1.0 / st[0][1]))
    check("c", f"PCG-Jacobi {n}^2 f32, {pcg_it} it", rel_dev(h, ref), 1e-2,
          F32_WHY.format(n=N, it=pcg_it))


def phase_d(n3=256, n1=2 ** 24, iters=20):
    """3-D 7-pt and 27-pt CG at n3^3 and 1-D 3-pt CG at n1, f32."""
    from legionsolvers_tpu import CGSolver, laplacian_stencil

    for dim, shape in ((3, (n3,) * 3), (4, (n3,) * 3), (1, (n1,))):
        planner = stencil_system(dim, shape, "float32")
        h = np.asarray(CGSolver(planner).solve(iters))
        ref, _ = np_cg(np_stencil(shape, laplacian_stencil(dim)),
                       np.ones(int(np.prod(shape))), iters)
        name = {1: "1-D 3-pt", 3: "3-D 7-pt", 4: "3-D 27-pt"}[dim]
        check("d", f"{name} CG {'x'.join(map(str, shape))} f32, {iters} it",
              rel_dev(h, ref), 1e-2,
              F32_WHY.format(n=int(np.prod(shape)), it=iters))


def laplacian_coo(n, dtype, perm=None):
    """The 2-D 5-pt Laplacian on an n x n grid as COO, rows and columns
    renumbered by ``perm`` (new index of old row i is perm[i])."""
    import jax.numpy as jnp

    from legionsolvers_tpu import (SolverOptions, create_coo_stencil_matrix,
                                   laplacian_stencil)
    from legionsolvers_tpu.core.matrix import COOMatrix

    A = create_coo_stencil_matrix((n, n), laplacian_stencil(2),
                                  options=SolverOptions(entry_dtype=jnp.dtype(dtype)))
    if perm is None:
        return A
    rows = perm[np.asarray(A.rows)]
    cols = perm[np.asarray(A.cols)]
    return COOMatrix(rows, cols, np.asarray(A.vals), n * n, n * n,
                     options=SolverOptions(entry_dtype=jnp.dtype(dtype)))


def random_spd(n, per_row, seed, dtype):
    """Seeded random symmetric matrix with ``per_row`` off-diagonal
    nonzeros per row on average and a dominant diagonal (SPD)."""
    import jax.numpy as jnp

    from legionsolvers_tpu import SolverOptions
    from legionsolvers_tpu.core.matrix import COOMatrix

    rng = np.random.default_rng(seed)
    m = n * per_row // 2
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    v = rng.uniform(-1.0, 1.0, m)
    rows = np.concatenate([r, c, np.arange(n)])
    cols = np.concatenate([c, r, np.arange(n)])
    vals = np.concatenate([v, v, np.full(n, 2.0 * per_row)])
    return COOMatrix(rows, cols, vals, n, n,
                     options=SolverOptions(entry_dtype=jnp.dtype(dtype)))


def phase_e(n_dia=4096, n_scr=2048, n_rand=2 ** 22, iters=20, seed=0):
    """Explicit matrices through the planner's tiers, CG vs scipy fp64."""
    import scipy.sparse as sp

    from legionsolvers_tpu import (CGSolver, DiaOperator, GeneralSpmvOperator,
                                   ReorderedOperator, SlicedWinEllOperator,
                                   WinEllOperator)

    rng = np.random.default_rng(seed)
    cases = (
        ("DIA", laplacian_coo(n_dia, "float32"), (DiaOperator,)),
        ("WinEll", laplacian_coo(n_scr, "float32",
                                 rng.permutation(n_scr * n_scr)),
         (WinEllOperator, SlicedWinEllOperator)),
        ("routed gather", random_spd(n_rand, 8, seed, "float32"),
         (GeneralSpmvOperator,)),
    )
    for name, A, kinds in cases:
        t0 = time.perf_counter()
        planner = explicit_system(A, "float32")
        print(f"  {name}: planner built in {time.perf_counter() - t0:.0f} s",
              flush=True)
        op = planner.row_partitioned_matrices[0][0]
        base = op.base if isinstance(op, ReorderedOperator) else op
        assert isinstance(base, kinds), (name, type(op), type(base))
        h = np.asarray(CGSolver(planner).solve(iters))
        S = sp.csr_matrix((np.asarray(A.vals, np.float64),
                           (np.asarray(A.rows), np.asarray(A.cols))),
                          shape=(A.n_range, A.n_domain))
        ref, _ = np_cg(lambda x: S @ x, np.ones(A.n_range), iters)
        check("e", f"{name} ({type(base).__name__}) n={A.n_range} f32 CG, "
              f"{iters} it", rel_dev(h, ref), 1e-2,
              F32_WHY.format(n=A.n_range, it=iters))


def phase_f(ref, n=4096, iters=50):
    """2-space block CG (the --block path): identical right-hand sides, so
    its history is twice the single-space reference."""
    from legionsolvers_tpu import CGSolver

    h = np.asarray(CGSolver(stencil_system(2, (n, n), "float32", block=True))
                   .solve(iters))
    check("f", f"2-space block CG {n}^2 f32, {iters} it", rel_dev(h, 2 * ref),
          1e-2, F32_WHY.format(n=2 * n * n, it=iters))


def phase_g(n=4096, seed=0):
    """The s-step Triton pass against the plain jnp pass, f32 and f64."""
    import jax
    import jax.numpy as jnp

    from legionsolvers_tpu.ops import grid2d
    from legionsolvers_tpu.ops.pallas import sstep2d
    from legionsolvers_tpu import laplacian_stencil

    offs = tuple(o for o, _ in laplacian_stencil(2))
    vals = tuple(v for _, v in laplacian_stencil(2))
    kw = dict(offsets=offs, values=vals)
    for dtype, tol_v, tol_g in ((jnp.float32, 1e-5, 1e-4),
                                (jnp.float64, 1e-12, 1e-10)):
        keys = jax.random.split(jax.random.PRNGKey(seed), 3)
        x, r, p = (jax.random.normal(k, (n, n), dtype) for k in keys)
        g_ref = grid2d.gram2_jnp(r, p, **kw)
        g = sstep2d.gram2(r, p, **kw)
        coef, _, _ = grid2d.cg2_coeffs(g_ref)
        ref = grid2d.step2_jnp(x, r, p, coef, **kw)
        got = sstep2d.step2(x, r, p, coef, **kw)
        name = jnp.dtype(dtype).name
        dv = max(float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))
                 for a, b in zip(got[:3], ref[:3]))
        check("g", f"Triton step2 x''/r''/p'' vs jnp {n}^2 {name}", dv, tol_v,
              "same per-element arithmetic; XLA may contract to FMA "
              "differently")
        dg = max(rel_dev(g, g_ref), rel_dev(got[3], ref[3]))
        check("g", f"Triton gram2/step2 Gram entries vs jnp {n}^2 {name}", dg,
              tol_g, f"{n * n}-term {name} sums in per-program partials vs "
              "XLA's reduction tree")


def phase_h(compile_s):
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    print(f"[h] peak_bytes_in_use {stats.get('peak_bytes_in_use')}; "
          f"phase b compile {compile_s:.1f} s", flush=True)


def four_path(n2=8192, n3=256, depth=1024, iters=None):
    """Sharded solves on four devices, each against the one-device solve of
    the same system (``iters`` overrides every iteration count)."""
    import jax

    from legionsolvers_tpu import BiCGStabSolver, CGSolver, GMRESSolver
    from legionsolvers_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(4)
    phase_a(pieces=4, mesh=mesh)
    sq = (n2, n2)
    box = (depth, n3, n3)
    f32, f64 = "float32", "float64"
    cases = (
        (f"2-D 5-pt CG {n2}^2", 2, sq, CGSolver, {}, 50, f32),
        (f"2-D 5-pt BiCGStab {n2}^2", 2, sq, BiCGStabSolver, {}, 20, f64),
        (f"2-D 5-pt GMRES(10) {n2}^2", 2, sq, GMRESSolver, {"restart": 10},
         2, f32),
        (f"3-D 27-pt CG {n3}x{n3}x{depth}", 4, box, CGSolver, {}, 50, f32),
    )
    for name, dim, shape, cls, kw, its, dt in cases:
        its = iters or its
        sharded = stencil_system(dim, shape, dt, pieces=4, mesh=mesh)
        h4 = np.asarray(cls(sharded, **kw).solve(its))
        h1 = np.asarray(cls(stencil_system(dim, shape, dt), **kw).solve(its))
        n = int(np.prod(shape))
        why = (F32_WHY if dt == f32 else F64_WHY).format(n=n, it=its)
        check("four", f"{name} {dt} on 4 shards vs 1 device", rel_dev(h4, h1),
              1e-2 if dt == f32 else 1e-4,
              why + " (shard-partial sums vs one device)")
    return len(jax.devices())


# ------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {dev.platform})",
              file=sys.stderr)
        return 1
    jax.config.update("jax_enable_x64", True)

    from legionsolvers_tpu.benchmark import card_line
    from legionsolvers_tpu.native import bindings
    from legionsolvers_tpu.utils.compile_cache import enable_compile_cache

    print(f"card: {card_line()}", flush=True)
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    print(f"native host layer loaded: {bindings.available()}", flush=True)
    t0 = time.perf_counter()

    def timed(f, *a):
        out = f(*a)
        print(f"  ({time.perf_counter() - t0:.0f} s elapsed)", flush=True)
        return out

    if args.four:
        count = four_path()
    else:
        timed(phase_a)
        ref, compile_s = timed(phase_b)
        timed(phase_c)
        timed(phase_d)
        timed(phase_f, ref)
        timed(phase_g)
        timed(phase_e)
        phase_h(compile_s)
        count = len(jax.devices())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
