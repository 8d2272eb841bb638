"""Pod-sharded conic ADMM (parallel/admm_sharded) vs the single-device
fused loop on a simulated ("batch", "time") mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdp_lqr_tpu.models import quadrotor
from pdp_lqr_tpu.parallel import admm_sharded, mesh as mesh_lib
from pdp_lqr_tpu.solvers import admm


def _batch(problem, B, seed=0):
    rng = np.random.default_rng(seed)
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), problem)
    bp = dataclasses.replace(
        bp,
        c=bp.c + jnp.asarray(
            rng.normal(size=bp.c.shape) * 0.01, problem.c.dtype),
    )
    x0 = jnp.asarray(
        rng.normal(size=(B, problem.nx)) * 0.05, problem.c.dtype)
    return bp, x0


def _settings(**kw):
    base = dict(max_iter=30, rho_update_interval=10,
                eps_abs=1e-4, eps_rel=1e-3)
    base.update(kw)
    return admm.ADMMSettings(**base)


@pytest.mark.parametrize("time_axis", [2, 4])
def test_sharded_admm_matches_fused(time_axis):
    problem, _ = quadrotor(N=16, constrained=True, dtype=jnp.float32)
    bp, x0 = _batch(problem, B=4)
    mesh = mesh_lib.make_mesh(batch=8 // time_axis, time=time_axis)
    st = _settings()
    ws_s, state_s, info_s = admm_sharded.solve(
        mesh, bp, x0, (), st)
    ws_f, state_f, info_f = admm.solve_fused(bp, x0, (), st)
    np.testing.assert_allclose(
        np.asarray(ws_s), np.asarray(ws_f), atol=2e-4)
    # Per-instance adaptive rho follows the same trajectory.
    np.testing.assert_allclose(
        np.asarray(state_s.rho), np.asarray(state_f.rho), rtol=2e-4)
    np.testing.assert_allclose(
        np.asarray(info_s.r_prim), np.asarray(info_f.r_prim),
        rtol=0.1, atol=1e-6)


def test_sharded_admm_soc_cone():
    """Thrust-cone quadrotor (cones + soc_shift) through the sharded
    loop — the full conic path, not just boxes."""
    problem, cones = quadrotor(N=16, constrained=True, thrust_cone=True,
                               dtype=jnp.float32)
    cones = tuple(cones)
    bp, x0 = _batch(problem, B=4)
    mesh = mesh_lib.make_mesh(batch=2, time=4)
    st = _settings(max_iter=40)
    ws_s, _, info_s = admm_sharded.solve(
        mesh, bp, x0, cones, st)
    ws_f, _, info_f = admm.solve_fused(
        bp, x0, cones, st)
    np.testing.assert_allclose(
        np.asarray(ws_s), np.asarray(ws_f), atol=2e-4)


def test_sharded_admm_cached_factors_matches_refactor():
    """The with/without-factorization split on the sharded loop
    (lqr_solver_parallel.hpp:148-154,190-211): cached-factor chunks
    must reproduce the always-refactor trajectory — the matrix factors
    are iterate-independent, so the only differences are fp
    reassociation."""
    problem, _ = quadrotor(N=16, constrained=True, dtype=jnp.float64)
    bp, x0 = _batch(problem, B=4)
    mesh = mesh_lib.make_mesh(batch=2, time=4)
    st = _settings(max_iter=12, rho_update_interval=4)
    ws_r, state_r, info_r = admm_sharded.solve(
        mesh, bp, x0, (), st)
    ws_c, state_c, info_c = admm_sharded.solve(
        mesh, bp, x0, (),
        dataclasses.replace(st, cached_factors=True))
    np.testing.assert_allclose(
        np.asarray(ws_c), np.asarray(ws_r), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(state_c.rho), np.asarray(state_r.rho), rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(info_c.r_prim), np.asarray(info_r.r_prim),
        rtol=1e-6, atol=1e-12)


def test_sharded_admm_early_exit_matches_fixed():
    """All-mesh pmin early exit: stops once EVERY instance converges,
    and the result equals the fixed-trip loop truncated at the exit
    iteration (identical per-iteration math, just fewer trips)."""
    problem, _ = quadrotor(N=16, constrained=True, dtype=jnp.float64)
    bp, x0 = _batch(problem, B=4)
    mesh = mesh_lib.make_mesh(batch=2, time=4)
    st = _settings(max_iter=30, rho_update_interval=4,
                   eps_abs=1e-3, eps_rel=1e-2)
    ws_e, _, info_e = admm_sharded.solve(
        mesh, bp, x0, (), dataclasses.replace(st, early_exit=True))
    k_exit = int(info_e.iterations[0])
    assert k_exit < 30
    assert bool(jnp.all(info_e.converged))
    ws_t, _, info_t = admm_sharded.solve(
        mesh, bp, x0, (), dataclasses.replace(st, max_iter=k_exit))
    np.testing.assert_allclose(
        np.asarray(ws_e), np.asarray(ws_t), atol=1e-12)


def test_sharded_admm_cached_early_exit():
    """Cached factors + early exit compose (chunk-granular exit)."""
    problem, _ = quadrotor(N=16, constrained=True, dtype=jnp.float64)
    bp, x0 = _batch(problem, B=4)
    mesh = mesh_lib.make_mesh(batch=2, time=4)
    st = _settings(max_iter=30, rho_update_interval=5,
                   eps_abs=1e-3, eps_rel=1e-2, cached_factors=True,
                   early_exit=True)
    ws, _, info = admm_sharded.solve(mesh, bp, x0, (), st)
    assert bool(jnp.all(jnp.isfinite(ws)))
    assert bool(jnp.all(info.converged))
    assert int(info.iterations[0]) <= 30


def test_sharded_admm_warm_start():
    problem, _ = quadrotor(N=16, constrained=True, dtype=jnp.float32)
    bp, x0 = _batch(problem, B=4)
    mesh = mesh_lib.make_mesh(batch=2, time=4)
    st = _settings()
    ws1, state, _ = admm_sharded.solve(mesh, bp, x0, (), st)
    st2 = _settings(max_iter=5, adaptive_rho=False)
    ws2, _, info2 = admm_sharded.solve(
        mesh, bp, x0, (), st2, state=state)
    # Warm continuation matches the single-device fused loop from the
    # same state (plumbing parity for w/z/y/per-instance rho).
    ws2_f, _, _ = admm.solve_fused(
        bp, x0, (), st2, state=state)
    np.testing.assert_allclose(
        np.asarray(ws2), np.asarray(ws2_f), atol=2e-4)
