"""Ruiz equilibration (utils/scaling) + per-row rho (rho_eq_boost).

The verdict-criterion test lives here: a problem whose constraint rows
and cost span many orders of magnitude must converge in roughly the
iterations of its well-scaled equivalent once equilibrated, with
termination acting on UNSCALED residuals.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from pdp_lqr_tpu.models import quadrotor
from pdp_lqr_tpu.solvers import admm
from pdp_lqr_tpu.utils import scaling as sc


def _setup(N=12, thrust_cone=False):
    problem, cones = quadrotor(N=N, constrained=True,
                               thrust_cone=thrust_cone)
    x0 = jnp.full((problem.nx,), 0.05, problem.c.dtype)
    return problem, tuple(cones or ()), x0


def _badly_scale(problem, row_span=1e6, cost_scale=1e4):
    """Same feasible set / same argmin, horribly scaled: constraint
    row i multiplied by row_span^(i/nc - 1/2) (bounds too), cost by
    cost_scale."""
    nc = problem.nc
    expo = (np.arange(nc) / max(nc - 1, 1)) - 0.5
    rs = jnp.asarray(row_span ** expo, problem.D.dtype)
    return dataclasses.replace(
        problem,
        D=problem.D * rs[None, :, None],
        e_lb=problem.e_lb * rs[None, :],
        e_ub=problem.e_ub * rs[None, :],
        H=problem.H * cost_scale,
        h=problem.h * cost_scale,
    )


def test_ruiz_normalizes():
    problem, cones, _ = _setup()
    bad = _badly_scale(problem)
    scal = sc.ruiz_equilibrate(bad, cones)
    sp = sc.scale_problem(bad, scal)
    # Scaled [H; D] blocks have ~unit row/col inf-norms on active rows.
    Drow = np.asarray(jnp.max(jnp.abs(sp.D), axis=-1))
    active = np.asarray(jnp.any(bad.D != 0, axis=-1))
    assert Drow[active].min() > 0.05 and Drow[active].max() < 20.0
    col = np.asarray(jnp.maximum(
        jnp.max(jnp.abs(sp.H), axis=-2), jnp.max(jnp.abs(sp.D), axis=-2)
    ))
    # Terminal u-columns are zero padding; check stage rows.
    assert col[:-1].min() > 0.05 and col.max() < 20.0


def test_equilibrated_matches_plain_solution():
    problem, cones, x0 = _setup()
    st = admm.ADMMSettings(max_iter=200, eps_abs=1e-7, eps_rel=1e-7)
    ws_p, _, info_p = admm.solve(problem, x0, cones, st)
    ws_e, _, info_e = admm.solve_equilibrated(problem, x0, cones, st)
    # Both runs stop on their own (unscaled vs plain) residual
    # criteria; the iterates agree to solver tolerance, not roundoff.
    np.testing.assert_allclose(
        np.asarray(ws_e), np.asarray(ws_p), atol=5e-4)


def test_badly_scaled_converges_like_well_scaled():
    """OSQP sec. 5 rationale: equilibration restores the well-scaled
    iteration count on a problem with rows spanning 1e6."""
    problem, cones, x0 = _setup()
    bad = _badly_scale(problem)
    st = admm.ADMMSettings(max_iter=400, eps_abs=1e-4, eps_rel=1e-4)

    ws_well, _, info_well = admm.solve(problem, x0, cones, st)
    ws_bad_eq, _, info_bad_eq = admm.solve_equilibrated(bad, x0, cones, st)

    it_well = int(info_well.iter_converged)
    it_bad_eq = int(info_bad_eq.iter_converged)
    assert bool(info_well.converged)
    assert bool(info_bad_eq.converged)
    # "~ the iterations of the well-scaled equivalent"
    assert it_bad_eq <= 3 * max(it_well, 10)
    # Same solution despite the 1e6 row span (unscaled comparison).
    np.testing.assert_allclose(
        np.asarray(ws_bad_eq), np.asarray(ws_well), atol=2e-3)


def test_badly_scaled_without_equilibration_struggles():
    """Sanity: the badly-scaled problem is actually hard without
    scaling (otherwise the test above proves nothing)."""
    problem, cones, x0 = _setup()
    bad = _badly_scale(problem)
    st = admm.ADMMSettings(max_iter=400, eps_abs=1e-4, eps_rel=1e-4)
    _, _, info_well = admm.solve(problem, x0, cones, st)
    _, _, info_bad = admm.solve(bad, x0, cones, st)
    it_well = int(info_well.iter_converged)
    # Either it fails to converge within the budget, or it takes far
    # longer than the well-scaled run.
    assert (not bool(info_bad.converged)) \
        or int(info_bad.iter_converged) > 3 * max(it_well, 10)


def _eq_problem(N=10):
    """Quadrotor with an EQUALITY row (u3 pinned) appended."""
    problem, _ = quadrotor(N=N, constrained=True)
    nz = problem.nz
    row = jnp.zeros((1, nz), problem.D.dtype).at[0, 3].set(1.0)
    D = jnp.concatenate(
        [problem.D,
         jnp.broadcast_to(row, (N + 1, 1, nz)).at[-1].set(0.0)], axis=1)
    val = 0.1
    lb = jnp.concatenate(
        [problem.e_lb,
         jnp.full((N + 1, 1), val).at[-1, 0].set(-jnp.inf)], axis=1)
    ub = jnp.concatenate(
        [problem.e_ub,
         jnp.full((N + 1, 1), val).at[-1, 0].set(jnp.inf)], axis=1)
    return dataclasses.replace(problem, D=D, e_lb=lb, e_ub=ub), val


def test_rho_eq_boost_tightens_equality():
    problem, val = _eq_problem()
    x0 = jnp.full((problem.nx,), 0.05, problem.c.dtype)
    st = admm.ADMMSettings(max_iter=60, eps_abs=1e-6, eps_rel=1e-6)
    ws_b, _, _ = admm.solve(problem, x0, (), st)
    ws_n, _, _ = admm.solve(
        problem, x0, (), dataclasses.replace(st, rho_eq_boost=1.0))
    viol_b = float(jnp.max(jnp.abs(ws_b[:-1, 3] - val)))
    viol_n = float(jnp.max(jnp.abs(ws_n[:-1, 3] - val)))
    assert viol_b < 1e-4
    assert viol_b <= viol_n + 1e-12


def test_rho_eq_boost_kernel_parity():
    """The per-row rho vector flows identically through the scalar
    loop, the fused batch loop, and the fused loop on a shared model
    (rho-boost fold on width-1 stage tensors)."""
    import jax

    problem, _ = _eq_problem(N=8)
    B = 2
    bp = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), problem)
    x0 = jnp.full((B, problem.nx), 0.05, problem.c.dtype)
    st = admm.ADMMSettings(max_iter=10, adaptive_rho=False,
                           eps_abs=1e-6, eps_rel=1e-6)
    ws_2k, _, _ = admm.solve_fused(bp, x0, (), st)
    ws_1k, _, _ = admm.solve_fused(problem, x0, (), st)
    ws_s, _, _ = admm.solve(problem, x0[0], (), st)
    np.testing.assert_allclose(
        np.asarray(ws_1k), np.asarray(ws_2k), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(ws_2k[0]), np.asarray(ws_s), atol=1e-8)
    # Cached-factor paths must build factors with the SAME boosted rho
    # as the vector folds (a plain-mask factor build converges to the
    # wrong fixed point on equality rows).
    stc = dataclasses.replace(st, cached_factors=True)
    ws_2kc, _, _ = admm.solve_fused(bp, x0, (), stc)
    ws_1kc, _, _ = admm.solve_fused(problem, x0, (), stc)
    np.testing.assert_allclose(
        np.asarray(ws_2kc), np.asarray(ws_2k), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(ws_1kc), np.asarray(ws_1k), atol=1e-9)
