"""Real-time (B=1 while_loop) path: operator exactness, parity with the
batch-SIMD ADMM loop, early exit, warm starts."""

import jax
import jax.numpy as jnp
import numpy as np

from pdp_lqr_tpu import init_iterates
from pdp_lqr_tpu.models import quadrotor
from pdp_lqr_tpu.problem import ADMMIterates
from pdp_lqr_tpu.solvers import admm, realtime, sequential

SIGMA = 1e-6


def _setup(N=30):
    problem, _ = quadrotor(N=N, constrained=True)
    settings = admm.ADMMSettings(
        sigma=SIGMA, rho=0.1, max_iter=40, rho_update_interval=40,
        adaptive_rho=False, eps_abs=1e-6, eps_rel=1e-6,
    )
    return problem, settings


def test_operator_matches_inner_solve():
    """T/J/r must reproduce the scan backend on arbitrary iterates."""
    problem, settings = _setup()
    op = realtime.build_operator(problem, rho=0.1, settings=settings)

    rng = np.random.default_rng(0)
    it0 = init_iterates(problem, rho=0.1)
    it = ADMMIterates(
        w=jnp.asarray(rng.normal(size=it0.w.shape) * 0.1),
        y=jnp.asarray(rng.normal(size=it0.y.shape) * 0.1) * (it0.rho > 0),
        z=jnp.asarray(rng.normal(size=it0.z.shape) * 0.1) * (it0.rho > 0),
        rho=it0.rho,
    )
    x0 = jnp.asarray(rng.normal(size=problem.nx) * 0.1)
    ws_ref, _ = sequential.solve(problem, it, x0, SIGMA)

    N, nz, nu = problem.N, problem.nz, problem.nu
    uterm = jnp.ones((N + 1, nz)).at[-1, :nu].set(0.0)
    g = it.z - it.inv_rho * it.y
    hf = (problem.h * uterm - SIGMA * it.w
          - jnp.einsum("kcz,kc->kz", problem.D, it.rho * g)) * uterm
    ws_op = (hf.reshape(-1) @ op.T + x0 @ op.J + op.r).reshape(N + 1, nz)
    np.testing.assert_allclose(
        np.asarray(ws_op), np.asarray(ws_ref), atol=1e-9
    )


def test_condensed_operator_matches_dense():
    """Segment-factored operator == dense T map (same affine function)."""
    problem, settings = _setup(N=24)
    dense = realtime.build_operator(problem, rho=0.1, settings=settings)
    for S in (2, 4, 8):
        cond = realtime.build_condensed_operator(
            problem, rho=0.1, num_segments=S, settings=settings
        )
        rng = np.random.default_rng(S)
        M = (problem.N + 1) * problem.nz
        hf = jnp.asarray(rng.normal(size=M) * 0.3)
        x0 = jnp.asarray(rng.normal(size=problem.nx) * 0.2)
        w_dense = dense.apply_flat(hf, dense.prepare(x0))
        w_cond = cond.apply_flat(hf, cond.prepare(x0))
        np.testing.assert_allclose(
            np.asarray(w_cond), np.asarray(w_dense), atol=1e-9
        )


def test_condensed_operator_full_solve():
    """realtime.solve runs unchanged on the factored operator."""
    problem, _ = _setup(N=20)
    settings = admm.ADMMSettings(
        sigma=SIGMA, rho=1.0, max_iter=200, rho_update_interval=200,
        adaptive_rho=False, eps_abs=1e-5, eps_rel=1e-4,
    )
    x0 = jnp.asarray(np.full(12, 0.05))
    dense = realtime.build_operator(problem, rho=1.0, settings=settings)
    cond = realtime.build_condensed_operator(
        problem, rho=1.0, num_segments=4, settings=settings
    )
    ws_d, _, info_d = realtime.solve(problem, x0, dense, (), settings)
    ws_c, _, info_c = realtime.solve(problem, x0, cond, (), settings)
    assert bool(info_c.converged)
    assert int(info_c.iterations) == int(info_d.iterations)
    np.testing.assert_allclose(np.asarray(ws_c), np.asarray(ws_d),
                               atol=1e-7)


def test_condensed_operator_segment_validation():
    problem, settings = _setup(N=10)
    import pytest

    with pytest.raises(ValueError):
        realtime.build_condensed_operator(
            problem, rho=0.1, num_segments=3, settings=settings
        )


def test_parity_with_batch_admm():
    """Same iterates as admm.solve when neither path exits early."""
    problem, settings = _setup()
    tight = admm.ADMMSettings(
        **{**settings.__dict__, "eps_abs": 0.0, "eps_rel": 0.0,
           "max_iter": 30, "rho_update_interval": 30},
    )
    x0 = jnp.zeros(problem.nx)
    op = realtime.build_operator(problem, rho=tight.rho, settings=tight)
    ws_rt, st_rt, info_rt = realtime.solve(problem, x0, op, (), tight)
    ws_b, st_b, info_b = admm.solve(problem, x0, (), tight)
    assert int(info_rt.iterations) == 30
    np.testing.assert_allclose(
        np.asarray(ws_rt), np.asarray(ws_b), atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(st_rt.y), np.asarray(st_b.y), atol=1e-8
    )


def test_early_exit_and_warm_start():
    problem, _ = _setup()
    settings = admm.ADMMSettings(
        sigma=SIGMA, rho=1.0, max_iter=200, rho_update_interval=200,
        adaptive_rho=False, eps_abs=1e-4, eps_rel=1e-3,
    )
    x0 = jnp.asarray(np.full(12, 0.05))
    op = realtime.build_operator(problem, rho=settings.rho,
                                 settings=settings)
    ws, state, info = realtime.solve(problem, x0, op, (), settings)
    assert bool(info.converged)
    assert int(info.iterations) < settings.max_iter
    # Constraint feasibility at the exit tolerance.
    viol = np.maximum(
        np.asarray(problem.e_lb) - np.einsum(
            "kcz,kz->kc", np.asarray(problem.D), np.asarray(ws)),
        np.einsum("kcz,kz->kc", np.asarray(problem.D), np.asarray(ws))
        - np.asarray(problem.e_ub),
    )
    active = np.asarray(init_iterates(problem, rho=1.0).rho) > 0
    # Feasibility to the configured tolerance: eps_abs + eps_rel * |Dw|.
    assert viol[active].max() < 5e-3

    # Warm start from the previous state: far fewer iterations (the
    # steady-state 1 kHz regime — measured 2 vs 33 cold at rho=1).
    x0b = x0 + 1e-3
    _, _, info_warm = realtime.solve(problem, x0b, op, (), settings, state)
    assert bool(info_warm.converged)
    assert int(info_warm.iterations) < int(info.iterations) // 2


def test_operator_ladder_adapts_rho():
    """Ladder replans solve on the selected rung and move the rung on a
    residual imbalance (adaptive rho without an inline rebuild)."""
    problem, _ = _setup(N=12)
    settings = admm.ADMMSettings(
        sigma=SIGMA, rho=1.0, max_iter=50, rho_update_interval=50,
        adaptive_rho=False, eps_abs=1e-9, eps_rel=1e-9,
    )
    rhos = [1e-4, 1e-2, 1.0, 1e2]
    ladder = realtime.build_ladder(problem, rhos, settings)
    fn = realtime.replan_ladder_fn(problem, ladder, (), settings)
    x0 = jnp.asarray(np.full(12, 0.05))
    state = admm.init_state(problem, settings)

    # Rung solve == direct solve with that rung's operator.
    idx0 = jnp.asarray(0, jnp.int32)
    ws, st, info, idx1 = fn(x0, state, idx0)
    op0 = realtime.build_operator(problem, rho=rhos[0], settings=settings)
    ws_ref, _, info_ref = realtime.solve(
        problem, x0, op0, (), settings, state
    )
    np.testing.assert_allclose(np.asarray(ws), np.asarray(ws_ref),
                               atol=1e-8)
    # rho = 1e-4 on this problem leaves a large primal imbalance: the
    # suggestion must move up the ladder.
    assert int(idx1) > 0
    # The suggested rung must not regress once re-solved there (a few
    # ticks settle onto a stable rung).
    idx = idx1
    for _ in range(3):
        ws, st, info, idx = fn(x0, st, idx)
    assert int(idx) >= 1
    np.testing.assert_allclose(
        float(st.rho), float(np.asarray(ladder.rhos)[int(idx)]), rtol=0
    )


def test_ladder_condensed_rungs():
    """Ladder over condensed operators: same map as dense rungs."""
    problem, settings = _setup(N=12)
    rhos = [0.05, 0.5]
    lad_d = realtime.build_ladder(problem, rhos, settings)
    lad_c = realtime.build_ladder(problem, rhos, settings, num_segments=3)
    rng = np.random.default_rng(0)
    M = (problem.N + 1) * problem.nz
    hf = jnp.asarray(rng.normal(size=M) * 0.2)
    x0 = jnp.asarray(rng.normal(size=problem.nx) * 0.1)
    for i in range(2):
        od = lad_d.select(jnp.asarray(i))
        oc = lad_c.select(jnp.asarray(i))
        np.testing.assert_allclose(
            np.asarray(oc.apply_flat(hf, oc.prepare(x0))),
            np.asarray(od.apply_flat(hf, od.prepare(x0))),
            atol=1e-9,
        )


def test_replan_fn_jits_once():
    problem, settings = _setup(N=10)
    op = realtime.build_operator(problem, rho=settings.rho,
                                 settings=settings)
    fn = realtime.replan_fn(problem, op, (), settings)
    state = admm.init_state(problem, settings)
    ws, state, info = fn(jnp.zeros(12), state)
    ws2, state2, info2 = fn(jnp.asarray(np.full(12, 0.01)), state)
    assert fn._cache_size() == 1
    assert ws2.shape == ws.shape


def test_batch_operator_matches_fused():
    """Operator-mode batched ADMM == the lane-kernel fused loop on a
    shared-structure scenario batch (c and x0 vary per instance)."""
    import dataclasses

    problem, _ = quadrotor(N=12, constrained=True)
    settings = admm.ADMMSettings(
        sigma=SIGMA, rho=0.5, max_iter=25, rho_update_interval=25,
        adaptive_rho=False, eps_abs=1e-5, eps_rel=1e-4,
    )
    B = 3
    rng = np.random.default_rng(4)
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                      problem)
    bp = dataclasses.replace(
        bp, c=bp.c + jnp.asarray(rng.normal(size=bp.c.shape) * 0.02))
    x0s = jnp.asarray(rng.normal(size=(B, 12)) * 0.05)

    op = realtime.build_batch_operator(problem, rho=0.5,
                                       settings=settings)
    ws_op, st_op, info_op = realtime.solve_batch(
        bp, x0s, op, (), settings)
    ws_f, st_f, info_f = admm.solve_fused(
        bp, x0s, (), settings)
    np.testing.assert_allclose(
        np.asarray(ws_op), np.asarray(ws_f), atol=1e-8)
    np.testing.assert_allclose(
        np.asarray(st_op.y), np.asarray(st_f.y), atol=1e-8)
    np.testing.assert_allclose(
        np.asarray(info_op.r_prim), np.asarray(info_f.r_prim),
        rtol=1e-6, atol=1e-12)


def test_cast_operator_bf16_serving():
    """bf16-storage operator: consistent ~1e-3 perturbation — the
    replan still converges and tracks the f32 solution at serving
    tolerance (the HBM-halving mode for long-horizon 1 kHz replans)."""
    problem, settings = _setup(N=16)
    import dataclasses

    settings = dataclasses.replace(settings, eps_abs=1e-3, eps_rel=1e-3,
                                   max_iter=200, rho=1.0)
    op = realtime.build_operator(problem, rho=1.0, settings=settings)
    op16 = realtime.cast_operator(op, jnp.bfloat16)
    assert op16.T.dtype == jnp.bfloat16
    assert op16.rho.dtype == op.rho.dtype          # scalars stay exact
    x0 = jnp.full((problem.nx,), 0.02, problem.H.dtype)
    ws32, _, info32 = realtime.solve(problem, x0, op, (), settings)
    ws16, _, info16 = realtime.solve(problem, x0, op16, (), settings)
    assert bool(info16.converged)
    scale = float(jnp.max(jnp.abs(ws32))) + 1e-9
    rel = float(jnp.max(jnp.abs(ws16.astype(jnp.float64)
                                - ws32.astype(jnp.float64)))) / scale
    assert rel < 2e-2, rel
