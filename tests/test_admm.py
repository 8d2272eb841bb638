"""ADMM outer loop: convergence, conic projections, backend parity.

The reference omits the outer loop entirely (README.md:8), so the
witness here is an independent scipy trust-constr solve of the same
constrained QP (single shooting), plus KKT feasibility checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdp_lqr_tpu.models import double_integrator, quadrotor, random_lq
from pdp_lqr_tpu.ops import projections
from pdp_lqr_tpu.solvers import admm, sequential
from pdp_lqr_tpu.utils import oracle


# ---------------------------------------------------------------- projections

def test_project_soc_cases():
    # inside
    v = jnp.asarray([2.0, 1.0, 1.0])
    np.testing.assert_allclose(projections.project_soc(v), v)
    # polar interior -> 0
    v = jnp.asarray([-2.0, 1.0, 0.5])
    np.testing.assert_allclose(projections.project_soc(v), 0.0)
    # boundary projection
    v = jnp.asarray([0.0, 3.0, 4.0])
    out = np.asarray(projections.project_soc(v))
    t, x = out[0], out[1:]
    np.testing.assert_allclose(np.linalg.norm(x), t, atol=1e-12)
    # projection is idempotent and moves orthogonally for random inputs
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(size=(50, 4)))
    p = projections.project_soc(v, axis=-1)
    p2 = projections.project_soc(p, axis=-1)
    np.testing.assert_allclose(np.asarray(p), np.asarray(p2), atol=1e-12)
    # obtuse-angle property of projections: <v - p, p> == 0 for SOC
    inner = np.sum((np.asarray(v) - np.asarray(p)) * np.asarray(p), axis=-1)
    np.testing.assert_allclose(inner, 0.0, atol=1e-10)


def test_project_zero_vector_on_boundary_row():
    v = jnp.asarray([0.0, 0.0, 0.0])
    np.testing.assert_allclose(projections.project_soc(v), 0.0)


def test_project_rsoc_cases():
    # inside: 2*2*1 = 4 >= 1
    v = jnp.asarray([2.0, 1.0, 1.0, 0.0])
    np.testing.assert_allclose(projections.project_rsoc(v), v)
    # polar interior (p, q both very negative, tiny x) -> 0
    v = jnp.asarray([-3.0, -3.0, 0.1, 0.0])
    np.testing.assert_allclose(
        projections.project_rsoc(v), 0.0, atol=1e-12
    )
    # random batch: result lies in the cone, is idempotent, and the
    # displacement is orthogonal to the projection (convex-cone KKT).
    rng = np.random.default_rng(1)
    v = jnp.asarray(rng.normal(size=(64, 5)))
    p = np.asarray(projections.project_rsoc(v, axis=-1))
    assert np.all(p[:, 0] >= -1e-12) and np.all(p[:, 1] >= -1e-12)
    memb = 2.0 * p[:, 0] * p[:, 1] - np.sum(p[:, 2:] ** 2, axis=-1)
    assert np.all(memb >= -1e-10)
    p2 = np.asarray(projections.project_rsoc(jnp.asarray(p), axis=-1))
    np.testing.assert_allclose(p, p2, atol=1e-10)
    inner = np.sum((np.asarray(v) - p) * p, axis=-1)
    np.testing.assert_allclose(inner, 0.0, atol=1e-10)


def test_normalize_cones_validation():
    assert projections.normalize_cones(((0, 3),)) == ((0, 3, "soc"),)
    assert projections.normalize_cones(((1, 4, "rsoc"),)) == ((1, 4, "rsoc"),)
    with pytest.raises(ValueError):
        projections.normalize_cones(((0, 3, "psd"),))
    with pytest.raises(ValueError):
        projections.normalize_cones(((0, 1, "rsoc"),))


# ------------------------------------------------------------------ admm core

def _settings(**kw):
    base = dict(max_iter=400, rho_update_interval=25, rho=0.1)
    base.update(kw)
    return admm.ADMMSettings(**base)


def test_unconstrained_single_solve():
    from pdp_lqr_tpu import init_iterates

    problem = random_lq(4, 2, 20, nc=0, seed=0)
    x0 = jnp.asarray(np.random.default_rng(0).normal(size=4) * 0.1)
    ws, _, info = admm.solve(problem, x0, settings=_settings())
    ws_ref, _ = sequential.solve(
        problem, init_iterates(problem, rho=0.1), x0, 1e-6
    )
    assert bool(info.converged)
    np.testing.assert_allclose(np.asarray(ws), np.asarray(ws_ref), atol=1e-8)


def test_box_constrained_double_integrator():
    problem = double_integrator(N=15, constrained=True)
    x0 = jnp.asarray([1.0, 0.0])
    ws, _, info = jax.jit(
        lambda p, x: admm.solve(p, x, settings=_settings())
    )(problem, x0)
    assert bool(info.converged), f"not converged: {info}"
    ws_ref = oracle.solve_constrained_qp(problem, np.asarray(x0))
    np.testing.assert_allclose(np.asarray(ws), ws_ref, atol=1e-4)


def test_box_constrained_quadrotor_feasible_and_optimal():
    problem, _ = quadrotor(N=12, constrained=True)
    x0 = jnp.zeros(12)
    ws, _, info = admm.solve(problem, x0, settings=_settings(max_iter=600))
    assert bool(info.converged), f"not converged: {info}"
    ws_np = np.asarray(ws)
    # Constraint feasibility to tolerance.
    vals = np.einsum("kcz,kz->kc", np.asarray(problem.D), ws_np)
    lb = np.asarray(problem.e_lb)
    ub = np.asarray(problem.e_ub)
    mask = np.any(np.asarray(problem.D) != 0, axis=-1)
    assert np.all(vals[mask] >= lb[mask] - 1e-4)
    assert np.all(vals[mask] <= ub[mask] + 1e-4)
    # Optimality vs the scipy oracle.
    ws_ref = oracle.solve_constrained_qp(problem, np.zeros(12))
    np.testing.assert_allclose(ws_np, ws_ref, atol=2e-3)


def test_soc_constrained_random():
    """Control-norm ball ||(u0,u1)|| <= margin as a shifted SOC.

    The t-row has an all-zero D row; the bound rides entirely on
    soc_shift — exercising both the cone path and the zero-row active
    mask.
    """
    rng = np.random.default_rng(3)
    nx, nu, N = 4, 2, 10
    base = random_lq(nx, nu, N, nc=0, seed=3)
    nz = nx + nu
    margin = 0.3
    D = np.zeros((N + 1, 3, nz))
    D[:N, 1, 0] = 1.0         # v1 = u_0
    D[:N, 2, 1] = 1.0         # v2 = u_1
    import dataclasses

    problem = dataclasses.replace(
        base,
        D=jnp.asarray(D),
        e_lb=jnp.full((N + 1, 3), -np.inf),
        e_ub=jnp.full((N + 1, 3), np.inf),
    )
    cones = ((0, 3),)
    shift = np.zeros((N + 1, 3))
    shift[:, 0] = margin
    shift_j = jnp.asarray(shift)
    x0 = jnp.asarray(rng.normal(size=nx) * 0.5)
    ws, _, info = admm.solve(
        problem, x0, cones=cones, settings=_settings(max_iter=800),
        soc_shift=shift_j,
    )
    assert bool(info.converged), f"not converged: {info}"
    ws_np = np.asarray(ws)
    # Cone binds: unconstrained controls exceed the ball, solved ones don't.
    norms = np.linalg.norm(ws_np[:N, :2], axis=-1)
    assert np.all(norms <= margin + 1e-4)
    from pdp_lqr_tpu.solvers import sequential
    from pdp_lqr_tpu import init_iterates

    ws_unc, _ = sequential.solve(
        base, init_iterates(base, rho=0.1), x0, 1e-6
    )
    assert np.max(np.linalg.norm(np.asarray(ws_unc)[:N, :2], axis=-1)) > margin
    ws_ref = oracle.solve_constrained_qp(
        problem, np.asarray(x0), cones=cones, soc_shift=shift
    )
    np.testing.assert_allclose(ws_np, ws_ref, atol=2e-3)


def test_rsoc_constrained_random():
    """Rotated-SOC control bound ||u||^2 <= 2 p q with constant p, q rows.

    The p/q rows ride entirely on soc_shift (all-zero D rows), giving
    an effective control ball of radius sqrt(2 p q) — cross-checked
    against the scipy oracle's nonlinear rsoc constraint.
    """
    rng = np.random.default_rng(7)
    nx, nu, N = 4, 2, 10
    base = random_lq(nx, nu, N, nc=0, seed=7)
    nz = nx + nu
    p0, q0 = 0.2, 0.225            # radius sqrt(2 p q) = 0.3
    D = np.zeros((N + 1, 4, nz))
    D[:N, 2, 0] = 1.0              # x1 = u_0
    D[:N, 3, 1] = 1.0              # x2 = u_1
    import dataclasses

    problem = dataclasses.replace(
        base,
        D=jnp.asarray(D),
        e_lb=jnp.full((N + 1, 4), -np.inf),
        e_ub=jnp.full((N + 1, 4), np.inf),
    )
    cones = ((0, 4, "rsoc"),)
    shift = np.zeros((N + 1, 4))
    shift[:, 0] = p0
    shift[:, 1] = q0
    shift_j = jnp.asarray(shift)
    x0 = jnp.asarray(rng.normal(size=nx) * 0.5)
    ws, _, info = admm.solve(
        problem, x0, cones=cones, settings=_settings(max_iter=800),
        soc_shift=shift_j,
    )
    assert bool(info.converged), f"not converged: {info}"
    ws_np = np.asarray(ws)
    radius = np.sqrt(2.0 * p0 * q0)
    norms = np.linalg.norm(ws_np[:N, :2], axis=-1)
    assert np.all(norms <= radius + 1e-4)
    from pdp_lqr_tpu import init_iterates

    ws_unc, _ = sequential.solve(base, init_iterates(base, rho=0.1), x0, 1e-6)
    assert np.max(np.linalg.norm(np.asarray(ws_unc)[:N, :2], axis=-1)) > radius
    ws_ref = oracle.solve_constrained_qp(
        problem, np.asarray(x0), cones=cones, soc_shift=shift
    )
    np.testing.assert_allclose(ws_np, ws_ref, atol=2e-3)


@pytest.mark.parametrize("backend", ["assoc", "kkt", "pdp"])
def test_backend_parity(backend):
    """All inner-solver backends drive ADMM to the same solution."""
    problem, _ = quadrotor(N=12, constrained=True)
    x0 = jnp.zeros(12)
    st = _settings(max_iter=300)
    ws_seq, _, info_seq = admm.solve(problem, x0, settings=st)
    # rho_dyn=0 makes the kkt backend's inner solve exact (its 1e-6
    # default biases every iterate at the 1e-4 level after 300 iters).
    st_b = _settings(max_iter=300, backend=backend, rho_dyn=0.0)
    ws_b, _, info_b = admm.solve(problem, x0, settings=st_b)
    assert bool(info_b.converged)
    np.testing.assert_allclose(
        np.asarray(ws_b), np.asarray(ws_seq), atol=1e-6
    )


def test_warm_start_converges_fast():
    problem, _ = quadrotor(N=12, constrained=True)
    x0 = jnp.zeros(12)
    st = _settings(max_iter=600)
    ws1, state, info1 = admm.solve(problem, x0, settings=st)
    # Re-solve the same problem warm-started: should converge immediately.
    st2 = _settings(max_iter=50, adaptive_rho=False)
    ws2, _, info2 = admm.solve(problem, x0, settings=st2, state=state)
    assert bool(info2.converged)
    assert int(info2.iter_converged) <= 5
    np.testing.assert_allclose(np.asarray(ws2), np.asarray(ws1), atol=1e-4)


def test_admm_fused_matches_per_instance():
    """Batch-fused ADMM == vmapped per-instance ADMM.

    The fused path adapts rho per instance without refactor cadence
    mechanics, so compare against per-instance runs with adaptive rho
    off to keep the iteration sequences identical.
    """
    import dataclasses

    problem, _ = quadrotor(N=10, constrained=True)
    B = 3
    rng = np.random.default_rng(1)
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), problem)
    bp = dataclasses.replace(
        bp, c=bp.c + jnp.asarray(rng.normal(size=bp.c.shape) * 0.005)
    )
    x0s = jnp.asarray(rng.normal(size=(B, 12)) * 0.05)
    st = _settings(max_iter=150, adaptive_rho=False)
    ws_f, _, info_f = admm.solve_fused(bp, x0s, (), st)
    for i in range(B):
        pi = jax.tree.map(lambda x: x[i], bp)
        ws_i, _, _ = admm.solve(pi, x0s[i], (), st)
        np.testing.assert_allclose(
            np.asarray(ws_f[i]), np.asarray(ws_i), atol=1e-8
        )


def test_admm_fused_unconstrained():
    problem, _ = quadrotor(N=8)
    B = 2
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), problem)
    x0s = jnp.zeros((B, 12))
    ws_f, _, info = admm.solve_fused(bp, x0s, (), _settings())
    from pdp_lqr_tpu.solvers import sequential
    from pdp_lqr_tpu import init_iterates

    its = jax.vmap(lambda p: init_iterates(p, rho=0.1))(bp)
    ws_ref, _ = sequential.solve_batched(bp, its, x0s, 1e-6)
    np.testing.assert_allclose(
        np.asarray(ws_f), np.asarray(ws_ref), atol=1e-9
    )


def test_admm_fused_cones_match_per_instance():
    """Fused path with SOC rows + shift == per-instance path."""
    import dataclasses

    rng = np.random.default_rng(5)
    nx, nu, N = 4, 2, 8
    base = random_lq(nx, nu, N, nc=0, seed=5)
    nz = nx + nu
    D = np.zeros((N + 1, 3, nz))
    D[:N, 1, 0] = 1.0
    D[:N, 2, 1] = 1.0
    problem = dataclasses.replace(
        base,
        D=jnp.asarray(D),
        e_lb=jnp.full((N + 1, 3), -np.inf),
        e_ub=jnp.full((N + 1, 3), np.inf),
    )
    shift = np.zeros((N + 1, 3))
    shift[:, 0] = 0.25
    shift_j = jnp.asarray(shift)
    cones = ((0, 3),)

    B = 2
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), problem)
    x0s = jnp.asarray(rng.normal(size=(B, nx)) * 0.3)
    st = _settings(max_iter=200, adaptive_rho=False)
    ws_f, _, info_f = admm.solve_fused(
        bp, x0s, cones, st, soc_shift=shift_j
    )
    for i in range(B):
        ws_i, _, _ = admm.solve(
            problem, x0s[i], cones, st, soc_shift=shift_j
        )
        np.testing.assert_allclose(
            np.asarray(ws_f[i]), np.asarray(ws_i), atol=1e-8
        )
    # The ball binds (violation bounded by the ADMM tolerance at this
    # iteration budget, not exactly feasible).
    norms = np.linalg.norm(np.asarray(ws_f)[:, :N, :2], axis=-1)
    assert np.all(norms <= 0.25 + 2e-3)
    assert np.max(norms) > 0.2  # actually active


def test_admm_batched():
    problem, _ = quadrotor(N=10, constrained=True)
    B = 3
    rng = np.random.default_rng(0)
    stacked = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), problem
    )
    x0s = jnp.asarray(rng.normal(size=(B, 12)) * 0.05)
    ws_b, _, info_b = admm.solve_batched(
        stacked, x0s, settings=_settings(max_iter=300)
    )
    assert ws_b.shape[0] == B
    for i in range(B):
        ws_i, _, _ = admm.solve(problem, x0s[i], settings=_settings(max_iter=300))
        np.testing.assert_allclose(
            np.asarray(ws_b[i]), np.asarray(ws_i), atol=1e-8
        )
