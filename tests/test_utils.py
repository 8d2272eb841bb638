"""Aux subsystems: checkpointing, failure masks, roofline, timing."""

import jax
import jax.numpy as jnp
import numpy as np

from pdp_lqr_tpu.models import double_integrator
from pdp_lqr_tpu.solvers import admm
from pdp_lqr_tpu.utils import checkpoint, profiling


def test_checkpoint_roundtrip_admm_state(tmp_path):
    problem = double_integrator(N=10, constrained=True)
    settings = admm.ADMMSettings(max_iter=50)
    _, state, _ = admm.solve(problem, jnp.asarray([0.5, 0.0]),
                             settings=settings)
    path = tmp_path / "state.npz"
    checkpoint.save_pytree(path, state)
    fresh = admm.init_state(problem, settings)
    restored = checkpoint.load_pytree(path, fresh)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    problem = double_integrator(N=10, constrained=True)
    settings = admm.ADMMSettings(max_iter=10)
    _, state, _ = admm.solve(problem, jnp.asarray([0.5, 0.0]),
                             settings=settings)
    path = tmp_path / "state.npz"
    checkpoint.save_pytree(path, state)
    other = admm.init_state(double_integrator(N=20, constrained=True),
                            settings)
    import pytest

    with pytest.raises(ValueError):
        checkpoint.load_pytree(path, other)


def test_failure_mask():
    ws = jnp.ones((3, 5, 4))
    ws = ws.at[1, 2, 0].set(jnp.nan)
    mask = profiling.failure_mask(ws)
    np.testing.assert_array_equal(np.asarray(mask), [False, True, False])


def test_roofline_sane():
    r = profiling.riccati_roofline(N=512, nx=12, nu=4, nc=16, B=512,
                                   device_kind="NVIDIA H100 80GB HBM3")
    assert r["t_mem_ms"] > 0 and r["t_compute_ms"] > 0
    assert r["bound"] in ("compute", "memory")


def test_solve_quality():
    from pdp_lqr_tpu.utils import quality

    problem = double_integrator(N=15, constrained=True, u_max=0.3)
    settings = admm.ADMMSettings(max_iter=300)
    ws, _, info = admm.solve(problem, jnp.asarray([0.0, 0.0]),
                             settings=settings)
    q = quality.assess(problem, ws)
    assert bool(info.converged)
    # Dynamics exactly feasible (inner solve property), box to tolerance.
    assert float(q.dyn_residual) < 1e-10
    assert float(q.box_violation) < 1e-5
    assert float(q.cone_violation) == 0.0
    # Objective matches a direct computation.
    ws_np = np.asarray(ws)
    H = np.asarray(problem.H)
    h = np.asarray(problem.h)
    obj = 0.5 * np.einsum("kz,kzw,kw->", ws_np, H, ws_np) + np.einsum(
        "kz,kz->", h, ws_np
    )
    np.testing.assert_allclose(float(q.objective), obj, rtol=1e-10)


def test_time_fn():
    f = jax.jit(lambda x: x * 2.0)
    t = profiling.time_fn(f, jnp.ones(16), iters=3)
    assert t.p50_ms >= 0.0 and t.compile_s >= 0.0
