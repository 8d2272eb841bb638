"""Data-parallel fused solves on a simulated multi-device mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from pdp_lqr_tpu import init_iterates
from pdp_lqr_tpu.models import quadrotor
from pdp_lqr_tpu.parallel import fused_dp, mesh as mesh_lib
from pdp_lqr_tpu.solvers import sequential

SIGMA = 1e-6


def test_fused_dp_matches_sequential():
    problem, _ = quadrotor(N=8, constrained=True)
    B = 8  # one instance per virtual device
    rng = np.random.default_rng(0)
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), problem)
    bp = dataclasses.replace(
        bp, c=bp.c + jnp.asarray(rng.normal(size=bp.c.shape) * 0.01)
    )
    its = jax.vmap(lambda p: init_iterates(p, rho=0.01))(bp)
    x0 = jnp.asarray(rng.normal(size=(B, 12)) * 0.1)

    m = mesh_lib.make_mesh(batch=4, time=2)
    ws = fused_dp.solve(m, bp, its, x0, SIGMA)
    ws_ref, _ = sequential.solve_batched(bp, its, x0, SIGMA)
    np.testing.assert_allclose(
        np.asarray(ws), np.asarray(ws_ref), atol=1e-9
    )


def test_solve_fused_dp_single_kernel_matches_local():
    """Full conic ADMM under batch shard_map == single-device run,
    warm-start state round-trip."""
    from pdp_lqr_tpu.solvers import admm

    problem, _ = quadrotor(N=6, constrained=True)
    B = 8
    rng = np.random.default_rng(5)
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), problem)
    bp = dataclasses.replace(
        bp, c=bp.c + jnp.asarray(rng.normal(size=bp.c.shape) * 0.005)
    )
    x0 = jnp.asarray(rng.normal(size=(B, 12)) * 0.05)
    st = admm.ADMMSettings(max_iter=40, rho=0.1, rho_update_interval=25)

    m = mesh_lib.make_mesh(batch=8, time=1)
    ws, state, info = fused_dp.solve_fused_dp(
        m, bp, x0, (), st
    )
    ws_ref, state_ref, info_ref = admm.solve_fused(
        bp, x0, (), st
    )
    np.testing.assert_allclose(np.asarray(ws), np.asarray(ws_ref),
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(state.rho),
                               np.asarray(state_ref.rho), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(info.r_prim),
                               np.asarray(info_ref.r_prim), rtol=1e-9,
                               atol=1e-15)

    # Warm start: sharded second solve from the sharded state.
    ws2, _, _ = fused_dp.solve_fused_dp(
        m, bp, x0, (), st, state=state,
    )
    ws2_ref, _, _ = admm.solve_fused(
        bp, x0, (), st, state=state_ref,
    )
    np.testing.assert_allclose(np.asarray(ws2), np.asarray(ws2_ref),
                               atol=1e-9)
