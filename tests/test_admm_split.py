"""Shared-model ADMM with shared factors, and the rho ladder.

solvers/admm.solve_fused on an UNBATCHED problem with cached_factors
and uniform_rho keeps ONE copy of the per-stage factors for the whole
batch (the long-horizon shared serving path); rho_ladder snaps each
instance's rho to a rung.  Parity vs the replicated per-instance loop
on identical iterations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdp_lqr_tpu.models import quadrotor
from pdp_lqr_tpu.solvers import admm


def _setup(N=8, B=6, soc=True):
    p, cones = quadrotor(N=N, constrained=True, thrust_cone=soc,
                         dtype=jnp.float64)
    x0 = jnp.asarray(np.random.default_rng(0).normal(size=(B, 12)) * 0.05)
    shift = None
    if soc:
        shift = jnp.zeros((N + 1, p.nc)).at[:, 16].set(8.0)
    return p, tuple(cones or ()), x0, shift


def test_split_matches_replicated_two_kernel():
    p, cones, x0, shift = _setup()
    B = x0.shape[0]
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), p)
    st = admm.ADMMSettings(max_iter=8, rho=0.1, adaptive_rho=False,
                           cached_factors=True, uniform_rho=True)
    st_ref = dataclasses.replace(st, cached_factors=False,
                                 uniform_rho=False)
    ws_ref, _, info_ref = admm.solve_fused(
        bp, x0, cones, st_ref, soc_shift=shift)
    ws_sp, _, info_sp = admm.solve_fused(
        p, x0, cones, st, soc_shift=shift)
    np.testing.assert_allclose(np.asarray(ws_sp), np.asarray(ws_ref),
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(info_sp.r_prim),
                               np.asarray(info_ref.r_prim), atol=1e-9)
    np.testing.assert_allclose(np.asarray(info_sp.r_dual),
                               np.asarray(info_ref.r_dual), atol=1e-9)


def test_split_adaptive_uniform_rho_matches_single_kernel():
    p, cones, x0, shift = _setup()
    st = admm.ADMMSettings(max_iter=8, rho=0.1, adaptive_rho=True,
                           rho_update_interval=3,
                           cached_factors=True, uniform_rho=True)
    # Shared factors vs the replicated batch refactoring every
    # iteration under the same uniform-rho rule.
    B = x0.shape[0]
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), p)
    st_ref = dataclasses.replace(st, cached_factors=False)
    ws_1k, s1, _ = admm.solve_fused(bp, x0, cones, st_ref, soc_shift=shift)
    ws_sp, s2, _ = admm.solve_fused(p, x0, cones, st, soc_shift=shift)
    np.testing.assert_allclose(np.asarray(ws_sp), np.asarray(ws_1k),
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(s2.rho), np.asarray(s1.rho),
                               rtol=1e-12)


def test_split_early_exit_and_warm_start():
    p, cones, x0, shift = _setup()
    st = admm.ADMMSettings(max_iter=150, rho=0.1, adaptive_rho=True,
                           rho_update_interval=25, uniform_rho=True,
                           cached_factors=True,
                           early_exit=True, eps_abs=1e-4, eps_rel=1e-4)
    ws, state, info = admm.solve_fused(p, x0, cones, st, soc_shift=shift)
    assert bool(jnp.all(info.converged))
    # Warm restart (factors carried in state) converges immediately.
    _, _, info2 = admm.solve_fused(p, x0, cones, st, state=state,
                                   soc_shift=shift)
    assert int(jnp.max(info2.iterations)) <= 3


def test_rho_ladder_single_rung_matches_uniform():
    p, cones, x0, shift = _setup()
    st0 = admm.ADMMSettings(max_iter=8, rho=0.1, adaptive_rho=False)
    ws_l1, _, _ = admm.solve_fused(
        p, x0, cones, dataclasses.replace(st0, rho_ladder=(0.1,)),
        soc_shift=shift)
    ws_u, _, _ = admm.solve_fused(
        p, x0, cones,
        dataclasses.replace(st0, cached_factors=True, uniform_rho=True),
        soc_shift=shift)
    np.testing.assert_allclose(np.asarray(ws_l1), np.asarray(ws_u),
                               atol=1e-12)


def test_rho_ladder_per_instance_matches_replicated():
    """Each instance on its own rung == the replicated per-instance-rho
    two-kernel loop (the ladder's whole point: per-instance rho with
    batch-shared factor streams)."""
    p, cones, x0, shift = _setup()
    B = x0.shape[0]
    rungs = (0.05, 0.1, 0.5)
    rho_pi = jnp.asarray([rungs[b % 3] for b in range(B)],
                         p.H.dtype)
    state = admm.ADMMState(
        w=jnp.zeros((B, p.N + 1, p.nz), p.H.dtype),
        z=jnp.zeros((B, p.N + 1, p.nc), p.H.dtype),
        y=jnp.zeros((B, p.N + 1, p.nc), p.H.dtype),
        rho=rho_pi)
    st0 = admm.ADMMSettings(max_iter=8, adaptive_rho=False)
    ws_l, st_out, _ = admm.solve_fused(
        p, x0, cones, dataclasses.replace(st0, rho_ladder=rungs),
        state=state, soc_shift=shift)
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), p)
    ws_r, _, _ = admm.solve_fused(bp, x0, cones, st0, state=state,
                                  soc_shift=shift)
    np.testing.assert_allclose(np.asarray(ws_l), np.asarray(ws_r),
                               atol=1e-9)
    # Adaptive ladder keeps every instance on a rung.
    st_a = dataclasses.replace(st0, rho_ladder=rungs,
                               adaptive_rho=True, rho_update_interval=3)
    _, st_out, _ = admm.solve_fused(p, x0, cones, st_a, state=state,
                                    soc_shift=shift)
    ro = np.asarray(st_out.rho)
    assert all(any(abs(r - g) < 1e-12 for g in rungs) for r in ro)


def test_rho_ladder_rejects_bad_configs():
    p, cones, x0, shift = _setup()
    with pytest.raises(ValueError, match="one, not both"):
        admm.solve_fused(
            p, x0, cones,
            admm.ADMMSettings(rho_ladder=(0.1,), uniform_rho=True),
            soc_shift=shift)
    # A replicated batch takes a ladder too: rho stays on the rungs.
    B = x0.shape[0]
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), p)
    _, st_out, _ = admm.solve_fused(
        bp, x0, cones,
        admm.ADMMSettings(max_iter=6, rho_ladder=(0.05, 0.5),
                          rho_update_interval=2),
        soc_shift=shift)
    assert set(np.round(np.asarray(st_out.rho), 12)) <= {0.05, 0.5}


def test_split_centroidal_friction_cones():
    """Shared-factor generality: centroidal dims (nz=30, nc=6,
    friction cones, no box rows) vs the replicated loop."""
    from pdp_lqr_tpu.models import centroidal

    p, cone_list = centroidal(N=8, dtype=jnp.float64)
    B = 4
    x0 = jnp.asarray(
        np.random.default_rng(1).normal(size=(B, p.nx)) * 0.05)
    st = admm.ADMMSettings(max_iter=6, rho=0.1, adaptive_rho=False,
                           cached_factors=True, uniform_rho=True)
    ws_sp, _, _ = admm.solve_fused(p, x0, tuple(cone_list), st)
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), p)
    st_ref = admm.ADMMSettings(max_iter=6, rho=0.1, adaptive_rho=False)
    ws_ref, _, _ = admm.solve_fused(bp, x0, tuple(cone_list), st_ref)
    np.testing.assert_allclose(np.asarray(ws_sp), np.asarray(ws_ref),
                               atol=1e-9)


def test_suggest_rho_ladder_degenerate_is_start_rho():
    """No adaptation fires within the probe budget -> one rung, the
    start rho (exactly — probe rho never moves)."""
    p, cones, x0, shift = _setup()
    rungs = admm.suggest_rho_ladder(
        p, x0, cones,
        admm.ADMMSettings(rho=0.1, rho_update_interval=10),
        rungs=4, probe_iters=2, soc_shift=shift)
    assert rungs == (0.1,)


def test_suggest_rho_ladder_covers_probe_footprint():
    p, cones, x0, shift = _setup()
    st = admm.ADMMSettings(rho=0.1, rho_update_interval=3)
    rungs = admm.suggest_rho_ladder(
        p, x0, cones, st, rungs=3, probe_iters=12,
        soc_shift=shift)
    assert 1 <= len(rungs) <= 3
    assert list(rungs) == sorted(rungs) and all(r > 0 for r in rungs)
    # The rungs are log-quantiles of the probe's per-instance rho:
    # every probe rho lies within a quantile gap of the rung span.
    import dataclasses as dc

    B = x0.shape[0]
    bp = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
    _, stp, _ = admm.solve_fused(
        bp, x0, cones, dc.replace(st, max_iter=12),
        soc_shift=shift)
    lo, hi = np.log(rungs[0]), np.log(rungs[-1])
    span = max(hi - lo, 0.1)
    logs = np.log(np.asarray(stp.rho))
    assert np.all(logs > lo - span) and np.all(logs < hi + span)
    # And the suggested ladder actually runs through the split path.
    ws, _, _ = admm.solve_fused(
        p, x0, cones,
        dc.replace(st, max_iter=6, rho_ladder=rungs),
        soc_shift=shift)
    assert bool(jnp.all(jnp.isfinite(ws)))
