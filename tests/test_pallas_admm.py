"""solvers/admm.solve_fused: cached factors, warm starts, early exit.

Each variant must follow the same iteration sequence as the plain
always-refactor loop: same relaxation, projections, dual updates, exact
OSQP residuals, per-instance adaptive rho.  CPU/f64 pins the math; the
GPU sweep kernels run these paths in chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from pdp_lqr_tpu.models import quadrotor
from pdp_lqr_tpu.solvers import admm


def _settings(**kw):
    base = dict(max_iter=60, rho_update_interval=25, rho=0.1)
    base.update(kw)
    return admm.ADMMSettings(**base)


def _batched(problem, B):
    return jax.tree.map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), problem
    )


def test_cached_factors_matches_full_refactor():
    """cached_factors (vector-only sweeps between rho changes) follows
    the always-refactor iteration sequence, including across adaptive
    rho updates (which force a refactor)."""
    problem, _ = quadrotor(N=10, constrained=True)
    B = 3
    rng = np.random.default_rng(13)
    bp = _batched(problem, B)
    bp = dataclasses.replace(
        bp, c=bp.c + jnp.asarray(rng.normal(size=bp.c.shape) * 0.005)
    )
    x0s = jnp.asarray(rng.normal(size=(B, 12)) * 0.05)
    st = _settings(max_iter=80, rho_update_interval=20)
    ws_ref, st_ref, info_ref = admm.solve_fused(
        bp, x0s, (), st
    )
    st_cf = dataclasses.replace(st, cached_factors=True)
    ws_cf, st_c, info_cf = admm.solve_fused(
        bp, x0s, (), st_cf
    )
    np.testing.assert_allclose(np.asarray(ws_cf), np.asarray(ws_ref),
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(st_c.rho),
                               np.asarray(st_ref.rho), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(info_cf.r_prim),
                               np.asarray(info_ref.r_prim),
                               rtol=1e-5, atol=1e-12)
    # Shared-model cached mode (one model, per-scenario drift and
    # per-instance rho, so per-instance factors) — same sequence again.
    sp = dataclasses.replace(problem, c=bp.c)
    ws_1k, st_1, info_1k = admm.solve_fused(
        sp, x0s, (), st_cf
    )
    np.testing.assert_allclose(np.asarray(ws_1k), np.asarray(ws_ref),
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(st_1.rho),
                               np.asarray(st_ref.rho), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(info_1k.r_prim),
                               np.asarray(info_ref.r_prim),
                               rtol=1e-5, atol=1e-12)


def test_cached_factors_warm_start_reuse():
    """state.factors skip the first refactorization of a warm solve
    and give the same iterates as a warm solve that refactors."""
    problem, _ = quadrotor(N=8, constrained=True)
    B = 2
    rng = np.random.default_rng(17)
    bp = _batched(problem, B)
    bp = dataclasses.replace(
        bp, c=bp.c + jnp.asarray(rng.normal(size=bp.c.shape) * 0.004)
    )
    x0s = jnp.asarray(rng.normal(size=(B, 12)) * 0.05)
    st = _settings(max_iter=30, adaptive_rho=False, cached_factors=True)
    ws1, state, _ = admm.solve_fused(bp, x0s, (), st)
    assert state.factors is not None
    rho_f = np.asarray(state.factors[-1])
    np.testing.assert_array_equal(rho_f, np.asarray(state.rho))

    # Warm solve WITH factors vs warm solve with factors stripped.
    ws2, _, _ = admm.solve_fused(bp, x0s, (), st, state=state)
    bare = dataclasses.replace(state, factors=None)
    ws2_ref, _, _ = admm.solve_fused(bp, x0s, (), st, state=bare)
    np.testing.assert_allclose(np.asarray(ws2), np.asarray(ws2_ref),
                               atol=1e-9)
    # mpc.shift_state preserves the factors.
    from pdp_lqr_tpu import mpc

    shifted = mpc.shift_state(state, problem)
    assert shifted.factors is not None
    np.testing.assert_array_equal(np.asarray(shifted.w[:, :-1]),
                                  np.asarray(state.w[:, 1:]))


def test_early_exit_while_loop():
    """early_exit: identical math (eps=0 runs the full trip count and
    matches the scan bit-for-bit); with real tolerances it stops when
    every instance converges."""
    problem, _ = quadrotor(N=8, constrained=True)
    B = 2
    rng = np.random.default_rng(11)
    bp = _batched(problem, B)
    bp = dataclasses.replace(
        bp, c=bp.c + jnp.asarray(rng.normal(size=bp.c.shape) * 0.004)
    )
    x0s = jnp.asarray(rng.normal(size=(B, 12)) * 0.05)

    st0 = _settings(max_iter=25, eps_abs=0.0, eps_rel=0.0)
    ws_scan, _, _ = admm.solve_fused(bp, x0s, (), st0)
    ws_while, _, info_w = admm.solve_fused(
        bp, x0s, (), dataclasses.replace(st0, early_exit=True),
    )
    np.testing.assert_array_equal(np.asarray(ws_while), np.asarray(ws_scan))
    assert int(np.asarray(info_w.iterations)[0]) == 25

    st1 = _settings(max_iter=200, eps_abs=1e-4, eps_rel=1e-4,
                    early_exit=True)
    ws_e, _, info_e = admm.solve_fused(bp, x0s, (), st1)
    its = np.asarray(info_e.iterations)
    assert np.all(np.asarray(info_e.converged))
    assert int(its[0]) < 200
    # The early-exit iterate is a converged iterate of the same
    # sequence; the full run keeps polishing (adaptive rho), so they
    # agree to tolerance scale, not machine precision.
    ws_full, _, _ = admm.solve_fused(
        bp, x0s, (), dataclasses.replace(st1, early_exit=False),
    )
    assert float(jnp.max(jnp.abs(ws_e - ws_full))) < 3e-2
