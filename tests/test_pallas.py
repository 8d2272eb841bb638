"""Batched inner solve (ops/pallas_riccati.solve_batched) parity, f64.

The Triton sweep runs under the Pallas interpreter (impl="interpret");
on the GPU the same solves are checked by chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdp_lqr_tpu import init_iterates
from pdp_lqr_tpu.models import quadrotor, random_lq
from pdp_lqr_tpu.ops import pallas_riccati
from pdp_lqr_tpu.solvers import dense, sequential

SIGMA = 1e-6


def _batch(problem, B, seed=0):
    rng = np.random.default_rng(seed)
    tile = lambda x: jnp.broadcast_to(x, (B,) + x.shape)
    bp = jax.tree.map(tile, problem)
    bp = dataclasses.replace(
        bp, c=bp.c + jnp.asarray(rng.normal(size=bp.c.shape) * 0.01, bp.c.dtype)
    )
    its = jax.vmap(lambda p: init_iterates(p, rho=0.01))(bp)
    x0 = jnp.asarray(rng.normal(size=(B, problem.nx)) * 0.1, bp.c.dtype)
    return bp, its, x0


@pytest.mark.parametrize("constrained", [False, True])
def test_pallas_matches_dense_quadrotor(constrained):
    problem, _ = quadrotor(N=12, constrained=constrained)
    bp, its, x0 = _batch(problem, B=4)
    ws_p = pallas_riccati.solve_batched(bp, its, x0, SIGMA, impl="interpret")
    ws_d, _ = dense.solve_batched(bp, its, x0, SIGMA)
    np.testing.assert_allclose(
        np.asarray(ws_p), np.asarray(ws_d), atol=1e-10
    )


def test_pallas_matches_sequential_random():
    problem = random_lq(5, 3, 9, nc=2, seed=1)
    bp, its, x0 = _batch(problem, B=3, seed=1)
    ws_p = pallas_riccati.solve_batched(bp, its, x0, SIGMA, impl="interpret")
    ws_s, _ = sequential.solve_batched(bp, its, x0, SIGMA)
    np.testing.assert_allclose(
        np.asarray(ws_p), np.asarray(ws_s), atol=1e-9
    )


def test_pallas_larger_state_dims():
    """Mass-spring chain (nx=40, nu=10) through the kernel (64-wide
    tiles)."""
    from pdp_lqr_tpu.models import mass_spring_chain

    problem = mass_spring_chain(n_masses=20, N=6)
    bp, its, x0 = _batch(problem, B=2)
    ws_p = pallas_riccati.solve_batched(bp, its, x0, SIGMA, impl="interpret")
    ws_d, _ = dense.solve_batched(bp, its, x0, SIGMA)
    np.testing.assert_allclose(
        np.asarray(ws_p), np.asarray(ws_d), atol=1e-8
    )


def test_pallas_centroidal_cones_dims():
    """Centroidal model (nx=24, nu=6, nc=6) through the kernel."""
    from pdp_lqr_tpu.models import centroidal

    problem, _ = centroidal(N=5)
    bp, its, x0 = _batch(problem, B=2)
    ws_p = pallas_riccati.solve_batched(bp, its, x0, SIGMA, impl="interpret")
    ws_d, _ = dense.solve_batched(bp, its, x0, SIGMA)
    np.testing.assert_allclose(
        np.asarray(ws_p), np.asarray(ws_d), atol=1e-7
    )
