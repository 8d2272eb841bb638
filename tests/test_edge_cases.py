"""Edge cases: N=1 horizon, single-constraint, empty-control-effect."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdp_lqr_tpu import init_iterates
from pdp_lqr_tpu.models import quadrotor, random_lq
from pdp_lqr_tpu.ops import pallas_riccati
from pdp_lqr_tpu.solvers import assoc, dense, kkt, pdp, sequential
from pdp_lqr_tpu.utils import oracle

SIGMA = 1e-6


def test_n1_all_backends():
    """One-stage horizon through every backend vs the dense KKT oracle."""
    problem = random_lq(3, 2, 1, nc=2, seed=0)
    it = init_iterates(problem, rho=0.01)
    x0 = jnp.asarray([0.3, -0.1, 0.2])
    ws_ref = oracle.solve_kkt_dense(problem, it, SIGMA, np.asarray(x0))

    for name, fn in [
        ("seq", lambda: sequential.solve(problem, it, x0, SIGMA)[0]),
        ("assoc", lambda: assoc.solve(problem, it, x0, SIGMA)[0]),
        ("dense", lambda: dense.solve(problem, it, x0, SIGMA)[0]),
        ("kkt", lambda: kkt.solve(problem, it, x0, SIGMA, 0.0)[0]),
        ("pdp", lambda: pdp.solve(problem, it, x0, SIGMA, 1)[0]),
    ]:
        ws = np.asarray(fn())
        np.testing.assert_allclose(ws, ws_ref, atol=1e-9, err_msg=name)

    # Triton sweep (interpret mode), batched.
    B = 2
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), problem)
    its = jax.vmap(lambda p: init_iterates(p, rho=0.01))(bp)
    ws_p = pallas_riccati.solve_batched(
        bp, its, jnp.broadcast_to(x0, (B, 3)), SIGMA, impl="interpret"
    )
    np.testing.assert_allclose(np.asarray(ws_p[0]), ws_ref, atol=1e-9)


def test_single_input_single_constraint():
    problem = random_lq(2, 1, 8, nc=1, seed=4)
    it = init_iterates(problem, rho=0.1)
    x0 = jnp.asarray([0.5, -0.5])
    ws_s, _ = sequential.solve(problem, it, x0, SIGMA)
    ws_d, _ = dense.solve(problem, it, x0, SIGMA)
    ws_ref = oracle.solve_kkt_dense(problem, it, SIGMA, np.asarray(x0))
    np.testing.assert_allclose(np.asarray(ws_s), ws_ref, atol=1e-9)
    np.testing.assert_allclose(np.asarray(ws_d), ws_ref, atol=1e-9)


def test_zero_drift_zero_linear_cost_gives_zero():
    """Zero data -> zero trajectory (no spurious constants anywhere)."""
    problem = random_lq(4, 2, 10, nc=0, seed=1)
    problem = dataclasses.replace(
        problem,
        c=jnp.zeros_like(problem.c),
        h=jnp.zeros_like(problem.h),
    )
    it = init_iterates(problem, rho=0.01)
    x0 = jnp.zeros(4)
    for fn in (sequential.solve, dense.solve, assoc.solve):
        ws, _ = fn(problem, it, x0, SIGMA)
        np.testing.assert_allclose(np.asarray(ws), 0.0, atol=1e-12)
