"""Shared-stage (broadcast) mode: one model, B scenarios.

The reference holds exactly one LQRModel per process behind all solvers
(lqr_model.hpp:66-89); prepare_shared/solve_shared serve a scenario
batch against it without B device copies of the stage matrices.  Parity
is pinned against the dense backend and against the replicated
(solve_batched) path; the Triton sweep runs in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdp_lqr_tpu import init_iterates
from pdp_lqr_tpu.models import mass_spring_chain, quadrotor, random_lq
from pdp_lqr_tpu.ops import pallas_riccati as pr
from pdp_lqr_tpu.solvers import dense

SIGMA = 1e-6


def _scenarios(problem, B, seed=0, batched_c=True, batched_iterates=False):
    """(it, x0[, c]) for a shared model: per-scenario drift + start."""
    rng = np.random.default_rng(seed)
    it = init_iterates(problem, rho=0.01)
    if batched_iterates:
        tile = lambda x: jnp.broadcast_to(x, (B,) + x.shape)
        w = tile(it.w) + jnp.asarray(
            rng.normal(size=(B,) + it.w.shape) * 0.01, it.w.dtype)
        y = tile(it.y) + jnp.asarray(
            rng.normal(size=(B,) + it.y.shape) * 0.01, it.w.dtype)
        z = tile(it.z) + jnp.asarray(
            rng.normal(size=(B,) + it.z.shape) * 0.01, it.w.dtype)
        it = dataclasses.replace(it, w=w, y=y, z=z)
    x0 = jnp.asarray(rng.normal(size=(B, problem.nx)) * 0.1, it.w.dtype)
    if batched_c:
        c_b = problem.c[None] + jnp.asarray(
            rng.normal(size=(B,) + problem.c.shape) * 0.01, it.w.dtype)
        problem = dataclasses.replace(problem, c=c_b)
    return problem, it, x0


def _replicated(problem, it, x0):
    """The same scenario batch as an ordinary batched problem."""
    B = x0.shape[0]
    tile = lambda x: jnp.broadcast_to(x, (B,) + x.shape)
    batched = lambda x, nd: x if x.ndim == nd + 1 else tile(x)
    bp = dataclasses.replace(
        jax.tree.map(tile, dataclasses.replace(problem, c=problem.c[-problem.N:] if problem.c.ndim == 2 else problem.c[0])),
        c=batched(problem.c, 2),
    )
    bit = dataclasses.replace(
        it,
        w=batched(it.w, 2), y=batched(it.y, 2), z=batched(it.z, 2),
        rho=tile(it.rho),
    )
    return bp, bit


@pytest.mark.parametrize("constrained", [False, True])
def test_shared_matches_dense(constrained):
    problem, _ = quadrotor(N=12, constrained=constrained)
    sp, it, x0 = _scenarios(problem, B=4)
    ws_sh = pr.solve_shared(sp, it, x0, SIGMA, impl="interpret")
    bp, bit = _replicated(sp, it, x0)
    ws_d, _ = dense.solve_batched(bp, bit, x0, SIGMA)
    np.testing.assert_allclose(
        np.asarray(ws_sh), np.asarray(ws_d), atol=1e-9
    )


def test_shared_matches_replicated_lanes():
    """solve_shared == solve_batched on the equivalent broadcast batch
    (kernel against the XLA sweep)."""
    problem, _ = quadrotor(N=10, constrained=True)
    sp, it, x0 = _scenarios(problem, B=3, batched_iterates=True)
    ws_sh = pr.solve_shared(sp, it, x0, SIGMA, impl="interpret")
    bp, bit = _replicated(sp, it, x0)
    ws_l = pr.solve_batched(bp, bit, x0, SIGMA, impl="xla")
    np.testing.assert_allclose(
        np.asarray(ws_sh), np.asarray(ws_l), atol=1e-9
    )


def test_shared_mass_spring_large_state():
    """The large-state shape family (nx=20, nu=10), shared model."""
    problem = mass_spring_chain(n_masses=10, N=6)
    sp, it, x0 = _scenarios(problem, B=2)
    ws_sh = pr.solve_shared(sp, it, x0, SIGMA, impl="interpret")
    bp, bit = _replicated(sp, it, x0)
    ws_d, _ = dense.solve_batched(bp, bit, x0, SIGMA)
    np.testing.assert_allclose(
        np.asarray(ws_sh), np.asarray(ws_d), atol=1e-7
    )


def test_shared_unbatched_c_and_iterates():
    """Scenario variation through x0 only (c and iterates shared)."""
    problem = random_lq(5, 3, 8, nc=2, seed=3)
    sp, it, x0 = _scenarios(problem, B=3, batched_c=False)
    ws_sh = pr.solve_shared(sp, it, x0, SIGMA, impl="interpret")
    bp, bit = _replicated(sp, it, x0)
    ws_d, _ = dense.solve_batched(bp, bit, x0, SIGMA)
    np.testing.assert_allclose(
        np.asarray(ws_sh), np.asarray(ws_d), atol=1e-9
    )


def test_shared_rejects_batched_model():
    problem, _ = quadrotor(N=6, constrained=True)
    sp, it, x0 = _scenarios(problem, B=2)
    bp, bit = _replicated(sp, it, x0)
    with pytest.raises(ValueError, match="UNBATCHED problem"):
        pr.prepare_shared(bp, it, x0, SIGMA)
    with pytest.raises(ValueError, match="unbatched.*rho"):
        pr.prepare_shared(sp, bit, x0, SIGMA)


def test_shared_horizon_one():
    """N=1 edge: single backward step, single rollout step."""
    problem, _ = quadrotor(N=1, constrained=True)
    sp, it, x0 = _scenarios(problem, B=2)
    ws_sh = pr.solve_shared(sp, it, x0, SIGMA, impl="interpret")
    bp, bit = _replicated(sp, it, x0)
    ws_d, _ = dense.solve_batched(bp, bit, x0, SIGMA)
    np.testing.assert_allclose(
        np.asarray(ws_sh), np.asarray(ws_d), atol=1e-9)


def test_shared_ragged_constraint_padding():
    """Per-stage variable constraint counts (reference ncs) through the
    shared path: padded zero-rho rows must stay exact."""
    from pdp_lqr_tpu.problem import build_problem

    rng = np.random.default_rng(5)
    nx, nu, N = 4, 2, 6
    A = np.eye(nx) + 0.05 * rng.normal(size=(nx, nx))
    B = rng.normal(size=(nx, nu))
    stage_cons = []
    for k in range(N + 1):
        if k % 3 == 0:
            stage_cons.append(None)                    # no rows
        elif k % 3 == 1:
            D1 = np.zeros((1, nu + nx)); D1[0, 0] = 1.0
            stage_cons.append((D1, [-0.5], [0.5]))     # one row
        else:
            D2 = rng.normal(size=(2, nu + nx)) * 0.3
            if k == N:
                D2[:, :nu] = 0.0                       # terminal: x only
            stage_cons.append((D2, [-1.0, -1.0], [1.0, 1.0]))
    problem = build_problem(
        A=A, B=B, c=np.zeros(nx), Q=np.eye(nx), R=0.1 * np.eye(nu),
        q=rng.normal(size=nx) * 0.1, r=None,
        stage_constraints=stage_cons, N=N)
    sp, it, x0 = _scenarios(problem, B=3, batched_iterates=True)
    ws_sh = pr.solve_shared(sp, it, x0, SIGMA, impl="interpret")
    bp, bit = _replicated(sp, it, x0)
    ws_d, _ = dense.solve_batched(bp, bit, x0, SIGMA)
    np.testing.assert_allclose(
        np.asarray(ws_sh), np.asarray(ws_d), atol=1e-9)


def test_shared_cached_factors_match_full():
    """shared_factors + solve_shared_cached == solve_shared (the
    serving-granularity without-factorization split), with the factors
    from the XLA sweep feeding the kernel's vector sweep."""
    problem, _ = quadrotor(N=8, constrained=True)
    sp, it, x0 = _scenarios(problem, B=3, batched_iterates=True)
    prep = pr.prepare_shared(sp, it, x0, SIGMA)
    ws_full = pr.solve_shared(sp, it, x0, SIGMA, impl="interpret")
    fac = pr.shared_factors(prep, impl="xla")
    ws_cached = pr.solve_shared_cached(prep, fac, impl="interpret")
    np.testing.assert_allclose(
        np.asarray(ws_cached), np.asarray(ws_full), atol=1e-10)
