"""Non-SPD failure recovery: masked regularization bump-and-retry.

The reference merely *signals* factorization failure — the Cholesky
condensed solver returns false (condensed_system.hpp:217-226) and its
caller ignores it (lqr_solver_parallel.hpp:145); QDLDL throws
(qdldl_solver.hpp:106-108).  Here failures surface per instance as
NaNs (utils.profiling.failure_mask) and this module RECOVERS them:
one fixed-shape re-solve of the whole batch with a per-instance
regularization bump folded into H, merged back only on failed lanes.

Shape of the policy: no host sync, no data-dependent shapes — the
retry always runs the full batch (a failed lane costs one extra solve
of everything, amortized to ~0 when failures are rare), and healthy
lanes take their ORIGINAL results bit-identically via jnp.where.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from pdp_lqr_tpu.utils.profiling import failure_mask


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RecoveryInfo:
    """failed: (B,) instances that failed the FIRST solve;
    recovered: failed then finite after retries;
    still_failed: non-finite even after all retries;
    bump: (B,) the regularization actually added per instance."""

    failed: jax.Array
    recovered: jax.Array
    still_failed: jax.Array
    bump: jax.Array


def solve_with_recovery(solve_batched_fn, problem, it, x0, sigma,
                        *, sigma_bump: float = 1e-4, retries: int = 1):
    """Run a batched inner solve with masked bump-and-retry.

    ``solve_batched_fn(problem, it, x0, sigma) -> ws (B, N+1, nz)`` is
    any batched backend entry (sequential/dense/pallas solve_batched ...).
    On instances whose output is non-finite, ``sigma_bump`` (escalated
    x10 per retry) is folded into that instance's H diagonal — the
    per-instance equivalent of the classic regularization bump the
    reference's failure bool was meant to trigger — and ONE fixed-shape
    re-solve of the whole batch runs; only failed lanes take the new
    result.

    Returns (ws, RecoveryInfo).
    """
    ws = solve_batched_fn(problem, it, x0, sigma)
    failed0 = failure_mask(ws)
    dt = problem.H.dtype
    Bb = ws.shape[0]
    eye = jnp.eye(problem.H.shape[-1], dtype=dt)
    bump_applied = jnp.zeros((Bb,), dt)

    bump = float(sigma_bump)
    for _ in range(max(0, retries)):
        fail = failure_mask(ws)
        add = jnp.where(fail, jnp.asarray(bump, dt), 0.0)
        pb = dataclasses.replace(
            problem,
            H=problem.H + add[:, None, None, None] * eye,
        )
        ws_retry = solve_batched_fn(pb, it, x0, sigma)
        # Healthy lanes keep their ORIGINAL result bit-identically.
        ws = jnp.where(fail[:, None, None], ws_retry, ws)
        bump_applied = jnp.where(fail, jnp.asarray(bump, dt),
                                 bump_applied)
        bump *= 10.0
    still = failure_mask(ws)
    return ws, RecoveryInfo(
        failed=failed0,
        recovered=failed0 & ~still,
        still_failed=still,
        bump=bump_applied,
    )
