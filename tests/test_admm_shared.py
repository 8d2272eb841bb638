"""Shared-stage (broadcast) conic ADMM: solve_fused on one model.

Parity is pinned against the replicated solve_fused path; the GPU
sweep kernels run the shared path in chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from pdp_lqr_tpu.models import quadrotor
from pdp_lqr_tpu.solvers import admm


def _scenarios(B, N=8, seed=0, thrust_cone=False):
    problem, cones = quadrotor(N=N, constrained=True,
                               thrust_cone=thrust_cone)
    rng = np.random.default_rng(seed)
    c_b = problem.c[None] + jnp.asarray(
        rng.normal(size=(B,) + problem.c.shape) * 0.01, problem.c.dtype)
    sp = dataclasses.replace(problem, c=c_b)
    x0 = jnp.asarray(rng.normal(size=(B, problem.nx)) * 0.05,
                     problem.c.dtype)
    tile = lambda x: jnp.broadcast_to(x, (B,) + x.shape)
    bp = dataclasses.replace(
        jax.tree.map(tile, problem), c=c_b)
    return sp, bp, x0, tuple(cones or ())


SETTINGS = admm.ADMMSettings(max_iter=12, rho=0.1, adaptive_rho=True,
                             rho_update_interval=4,
                             eps_abs=1e-6, eps_rel=1e-6)


def test_shared_matches_replicated_box():
    sp, bp, x0, _ = _scenarios(B=3)
    ws_sh, st_sh, info_sh = admm.solve_fused(
        sp, x0, (), SETTINGS)
    ws_rp, st_rp, info_rp = admm.solve_fused(
        bp, x0, (), SETTINGS)
    np.testing.assert_allclose(
        np.asarray(ws_sh), np.asarray(ws_rp), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(info_sh.r_prim), np.asarray(info_rp.r_prim),
        atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(st_sh.rho), np.asarray(st_rp.rho), atol=1e-12)


def test_shared_matches_replicated_cones_shift():
    sp, bp, x0, cones = _scenarios(B=2, thrust_cone=True)
    nc = sp.nc
    shift = jnp.zeros((sp.N + 1, nc)).at[:, 16].set(8.0)
    ws_sh, _, _ = admm.solve_fused(
        sp, x0, cones, SETTINGS, soc_shift=shift)
    ws_rp, _, _ = admm.solve_fused(
        bp, x0, cones, SETTINGS, soc_shift=shift)
    np.testing.assert_allclose(
        np.asarray(ws_sh), np.asarray(ws_rp), atol=1e-9)


def test_shared_warm_start_state():
    sp, _, x0, _ = _scenarios(B=2)
    ws1, st1, _ = admm.solve_fused(
        sp, x0, (), SETTINGS)
    ws2, _, info2 = admm.solve_fused(
        sp, x0, (), SETTINGS, state=st1)
    # Warm start from the converged-ish state must not blow up and
    # should keep residuals at least as small.
    assert bool(jnp.all(jnp.isfinite(ws2)))
    assert float(jnp.max(info2.r_prim)) < 1.0


def test_shared_unconstrained_model():
    problem, _ = quadrotor(N=8, constrained=False)
    rng = np.random.default_rng(1)
    B = 2
    x0 = jnp.asarray(rng.normal(size=(B, problem.nx)) * 0.05,
                     problem.c.dtype)
    ws, st, info = admm.solve_fused(problem, x0, (), SETTINGS)
    assert ws.shape == (B, problem.N + 1, problem.nz)
    assert bool(jnp.all(jnp.isfinite(ws)))


def test_shared_cached_uniform_rho_matches_uncached():
    """Shared cached factors (batch-uniform rho) == the shared
    refactor-every-iteration path: the one shared factor build
    changes nothing numerically while rho holds, and
    the uniform-rho rule moves rho identically in both."""
    sp, _, x0, _ = _scenarios(B=3)
    st_u = dataclasses.replace(SETTINGS, uniform_rho=True)
    ws_un, state_un, info_un = admm.solve_fused(
        sp, x0, (), st_u)
    st_c = dataclasses.replace(st_u, cached_factors=True)
    ws_c, state_c, info_c = admm.solve_fused(
        sp, x0, (), st_c)
    np.testing.assert_allclose(
        np.asarray(ws_c), np.asarray(ws_un), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(state_c.rho), np.asarray(state_un.rho), rtol=1e-12)
    # rho stayed batch-uniform throughout.
    assert float(jnp.max(jnp.abs(state_c.rho - state_c.rho[0]))) == 0.0


def test_uniform_rho_replicated_consistency():
    """uniform_rho on the replicated path: one rho trajectory for the
    whole batch, finite results, residuals comparable to per-instance
    adaptation on identical instances."""
    sp, bp, x0, _ = _scenarios(B=3)
    st_u = dataclasses.replace(SETTINGS, uniform_rho=True)
    ws, state, info = admm.solve_fused(
        bp, x0, (), st_u)
    assert bool(jnp.all(jnp.isfinite(ws)))
    assert float(jnp.max(jnp.abs(state.rho - state.rho[0]))) == 0.0
