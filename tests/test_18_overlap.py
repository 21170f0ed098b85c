"""Halo-exchange / compute overlap tests (parallel/overlap.py).

The sharded grid-view matvec / fused-CG / s-step paths run the main pass
with ZERO halos — so the pass has no data dependence on the iteration's
ppermutes and XLA's async collective scheduler can overlap the exchange
with the O(n) compute (the analog of Legion flying ghost copies during leaf
tasks, reference: COOMatrix.cpp:172-188) — then patch the omitted edge
terms.  These tests pin (a) numerical agreement with the dense oracle and
the unsharded path, and (b) the dataflow-independence property itself, by
walking the jaxpr: no pass (a named jit of ops/grid2d.py or the s-step
Triton pallas_call) may consume a ppermute result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legionsolvers_tpu import (
    BlockPartition,
    CGSolver,
    DiaOperator,
    PartitionedVector,
    SolverOptions,
    SquarePlanner,
    StencilOperator,
    create_coo_stencil_matrix,
    laplacian_stencil,
)

F32 = SolverOptions(entry_dtype=jnp.float32)


def _collect_eqns(jaxpr, out):
    for eqn in jaxpr.eqns:
        out.append(eqn)
        for v in eqn.params.values():
            if hasattr(v, "jaxpr"):  # ClosedJaxpr
                _collect_eqns(v.jaxpr, out)
            elif hasattr(v, "eqns"):  # Jaxpr
                _collect_eqns(v, out)
    return out


def _is_pass(eqn, kind):
    if kind == "pallas":
        return eqn.primitive.name == "pallas_call"
    name = str(eqn.params.get("name", ""))
    return eqn.primitive.name in ("jit", "pjit") and name.startswith(kind)


def assert_pallas_independent_of_ppermute(fn, *args, kind="grid2d_"):
    """No input of a pass (``kind``: a prefix of the jitted pass names of
    ops/grid2d.py, or "pallas" for the Triton kernel) may be a ppermute
    output: the pass must be schedulable concurrently with the exchange."""
    jaxpr = jax.make_jaxpr(fn)(*args)
    eqns = _collect_eqns(jaxpr.jaxpr, [])
    perm_outs = set()
    pass_eqns = []
    for eqn in eqns:
        if eqn.primitive.name == "ppermute":
            perm_outs.update(map(id, eqn.outvars))
        elif _is_pass(eqn, kind):
            pass_eqns.append(eqn)
    assert pass_eqns, f"expected at least one {kind} pass in the jaxpr"
    assert perm_outs, "expected ppermutes in the sharded jaxpr"
    for eqn in pass_eqns:
        for v in eqn.invars:
            assert id(v) not in perm_outs, (
                "a pass consumes a ppermute output: it cannot overlap the "
                "halo exchange"
            )


def dense_oracle(shape):
    from tests.test_08_stencil import dense_stencil

    return dense_stencil(shape, laplacian_stencil(len(shape)))


def test_stencil_matvec_overlap_agreement(mesh4):
    """Sharded (zero-halo + fixup) f32 matvec == dense oracle and == the
    single-piece result."""
    shape = (32, 128)
    n = 32 * 128
    part = BlockPartition(n, 4)
    op = StencilOperator(shape, laplacian_stencil(2), partition=part,
                         mesh=mesh4, options=F32)
    assert op.uses_grid_view
    op1 = StencilOperator(shape, laplacian_stencil(2),
                          partition=BlockPartition(n, 1), mesh=None,
                          options=F32)
    rng = np.random.default_rng(0)
    xh = rng.random(n).astype(np.float32)
    x = PartitionedVector.from_array("x", xh, part, mesh=mesh4, options=F32)
    x1 = PartitionedVector.from_array("x", xh, BlockPartition(n, 1),
                                      options=F32)
    y = np.asarray(op.matvec(x.data))
    y1 = np.asarray(op1.matvec(x1.data))
    np.testing.assert_allclose(y, dense_oracle(shape) @ xh, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(y, y1, rtol=1e-5, atol=1e-7)
    yd, d = op.matvec_dot(x.data)
    np.testing.assert_array_equal(np.asarray(yd), y)
    assert float(d) == pytest.approx(float(xh @ (dense_oracle(shape) @ xh)),
                                     rel=1e-4)


def test_stencil_matvec_dataflow_independence(mesh4):
    shape = (32, 128)
    n = 32 * 128
    part = BlockPartition(n, 4)
    op = StencilOperator(shape, laplacian_stencil(2), partition=part,
                         mesh=mesh4, options=F32)
    x = PartitionedVector("x", part, mesh=mesh4, options=F32).constant_fill(1.0)
    fn = op._fn(x.data, False)
    assert_pallas_independent_of_ppermute(fn, x.data)
    fnd = op._fn(x.data, True)
    assert_pallas_independent_of_ppermute(fnd, x.data)


def test_dia_matvec_overlap(mesh4):
    """Sharded DIA matvec (ring halo exchange of the band edges) == dense
    oracle and == the single-piece result."""
    shape = (32, 128)
    n = 32 * 128
    A = create_coo_stencil_matrix(shape, laplacian_stencil(2), options=F32)
    part = BlockPartition(n, 4)
    dia = DiaOperator(A, partition=part, mesh=mesh4, options=F32)
    dia1 = DiaOperator(A, partition=BlockPartition(n, 1), mesh=None,
                       options=F32)
    rng = np.random.default_rng(1)
    xh = rng.random(n).astype(np.float32)
    x = PartitionedVector.from_array("x", xh, part, mesh=mesh4, options=F32)
    y = np.asarray(dia.matvec(x.data))
    np.testing.assert_allclose(y, dense_oracle(shape) @ xh, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(y, np.asarray(dia1.matvec(jnp.asarray(xh))),
                               rtol=1e-6, atol=1e-7)


def test_sstep_pass_dataflow_independence(mesh4):
    """The sharded s-step runner's Triton pass (and its gram2 bootstrap)
    consume no ppermute output: the 4-row halo exchange flies under it."""
    shape = (64, 128)
    n = 64 * 128
    part = BlockPartition(n, 4)
    op = StencilOperator(shape, laplacian_stencil(2), partition=part,
                         mesh=mesh4, options=F32)
    assert op.step2_eligible
    runner = op.make_fused_cg_runner(4)
    x = PartitionedVector("x", part, mesh=mesh4, options=F32,
                          grid_shape=shape).constant_fill(1.0).data
    assert_pallas_independent_of_ppermute(
        lambda a, b, c: runner(a, b, c, jnp.float32(1.0))[3], x, x, x,
        kind="pallas",
    )


def test_fused_cg_overlap_agreement(mesh4):
    """Sharded fused-CG (overlapped pass 1) matches the unsharded fused-CG
    trajectory within f32 reordering noise, and its pass-1 kernel is
    ppermute-independent."""
    shape = (32, 128)
    n = 32 * 128

    def build(pieces, mesh):
        part = BlockPartition(n, pieces)
        op = StencilOperator(shape, laplacian_stencil(2), partition=part,
                             mesh=mesh, options=F32)
        planner = SquarePlanner(mesh=mesh, options=F32)
        planner.add_sol_vector(
            PartitionedVector("s", part, mesh=mesh, options=F32).zero_fill()
        )
        planner.add_rhs_vector(
            PartitionedVector("b", part, mesh=mesh, options=F32).constant_fill(1.0)
        )
        planner.add_operator(op, 0, 0)
        return planner, op

    p4, op4 = build(4, mesh4)
    h4 = np.asarray(CGSolver(p4).solve(15))
    p1, _ = build(1, None)
    h1 = np.asarray(CGSolver(p1).solve(15))
    np.testing.assert_allclose(h4, h1, rtol=2e-3)
    x4 = np.asarray(p4.get_vector(0, 0).data)
    x1 = np.asarray(p1.get_vector(0, 0).data)
    np.testing.assert_allclose(x4, x1, rtol=1e-3, atol=1e-6)

    # dataflow property of one fused iteration
    runner = op4.make_fused_cg_runner(1)
    x = p4.get_vector(0, 0).data
    r = p4.get_vector(4, 0).data
    pp = p4.get_vector(2, 0).data
    assert_pallas_independent_of_ppermute(
        lambda a, b, c: runner(a, b, c, jnp.float32(1.0))[3], x, r, pp
    )
