"""Multi-chip PDP solver: shard_map over a ("batch", "time") mesh.

This is the cross-chip realization of the reference's parallel solver
(lqr_solver_parallel.hpp): one horizon segment per "time"-axis device,
scenario batch sharded over the "batch" axis.

Mapping of the reference's concurrency machinery onto the mesh:

  OpenMP thread per segment (:157)        -> SPMD program per device
  sched_setaffinity pinning (:102-112)    -> XLA owns placement (none)
  shared-memory update_segment_data
    handoff (:182-187)                    -> jax.lax.all_gather of the
                                             (P,F,C,p,f) boundary
                                             factors over "time" (each
                                             is nx*nx or nx — a few KB —
                                             so one exchange, no
                                             reduce-scatter needed)
  serial condensed solve on thread 0      -> condensed solve REPLICATED
    (:145)                                   on every time-device
                                             (cheaper than a gather to
                                             one chip + scatter back)
  implicit omp barrier                     -> SPMD dataflow dependency

Everything inside the shard_map body is batched over the local batch
shard (vmap), so each device runs one fused kernel over
(B/batch_axis, N/time_axis) stage blocks.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pdp_lqr_tpu.config import CondensedSolverType, f32_matmul_precision
from pdp_lqr_tpu.ops import condensed, riccati, riccati_pdp
from pdp_lqr_tpu.problem import ADMMIterates, LQRProblem, make_stage_params

_CACHE: dict = {}


def _build(mesh: Mesh, solver_type: CondensedSolverType, nu: int):
    S = mesh.shape["time"]

    @f32_matmul_precision
    def body(A, B, c, H, h, D, rho, g, HN, hN, DN, rhoN, gN, x0):
        # Local shapes: stage args (Bl, Nseg, ...); terminal args (Bl, ...).
        i = jax.lax.axis_index("time")
        is_last = i == S - 1
        nx = A.shape[-1]
        dt = A.dtype

        def reduce_one(Ak, Bk, ck, Hk, hk, Dk, rhok, gk, HNk, hNk, DNk, rhoNk, gNk):
            # Penalty fold outside the scan (one batched einsum over the
            # local segment — see riccati.backward for the rationale).
            Hfk, hfk = riccati.penalty_fold(Hk, hk, Dk, rhok, gk)
            # Terminal init computed on every device (cheap, avoids a
            # branch); masked so only the last segment uses it
            # (lqr_kernel_parallel.hpp:51-67).
            LxxN, pN = riccati.terminal_step_raw(
                HNk[nu:, nu:], hNk[nu:], DNk[:, nu:], rhoNk, gNk
            )
            w = is_last.astype(dt)
            carry0 = (
                w * LxxN,
                w * pN,
                jnp.eye(nx, dtype=dt),
                jnp.zeros((nx, nx), dt),
                jnp.zeros((nx,), dt),
            )
            carry, (L, lp, G, Fnext) = jax.lax.scan(
                riccati_pdp._segment_backward_step,
                carry0,
                (Ak, Bk, ck, Hfk, hfk),
                reverse=True,
            )
            Lxx0, p0, F0, C0, f0 = carry
            return L, lp, G, Lxx0 @ Lxx0.T, F0, C0, p0, f0

        L, lp, G, P0, F0, C0, p0, f0 = jax.vmap(reduce_one)(
            A, B, c, H, h, D, rho, g, HN, hN, DN, rhoN, gN
        )

        # Boundary handoff: all-gather (P,F,C,p,f) over the time axis.
        gath = lambda x: jnp.moveaxis(
            jax.lax.all_gather(x, "time", axis=0), 0, 1
        )  # (Bl, S, ...)
        Pg, Fg, Cg, pg, fg = gath(P0), gath(F0), gath(C0), gath(p0), gath(f0)

        # Condensed solve, replicated per time-device, batched over Bl.
        if solver_type == CondensedSolverType.CHOLESKY:
            fac = condensed.cholesky_backward(Pg, Fg, Cg)
            xhat, uhat = condensed.cholesky_forward(fac, pg, fg, x0)
        else:
            fac = condensed.lu_backward(Pg, Fg, Cg)
            xhat, uhat = condensed.lu_forward(fac, pg, fg, x0)

        xhat_i = jnp.take(xhat, i, axis=1)  # (Bl, nx)
        uhat_i = jnp.take(uhat, i, axis=1)

        # Local parallel rollout (lqr_solver_parallel.hpp:217-237).
        def roll_one(x0_seg, uh, Ak, Bk, ck, Lk, lpk, Gk):
            def step(x, stage):
                Aj, Bj, cj, Lj, lpj, Gj = stage
                u = -(lpj[:nu] + Lj[nu:, :nu].T @ x) + Gj @ uh
                u = jax.scipy.linalg.solve_triangular(
                    Lj[:nu, :nu], u, lower=True, trans=1
                )
                return Aj @ x + Bj @ u + cj, jnp.concatenate([u, x])

            x_end, ws_seg = jax.lax.scan(step, x0_seg, (Ak, Bk, ck, Lk, lpk, Gk))
            return x_end, ws_seg

        x_end, ws_local = jax.vmap(roll_one)(xhat_i, uhat_i, A, B, c, L, lp, G)

        # Terminal state lives on the last time-device; replicate it.
        xN = jax.lax.psum(
            jnp.where(is_last, x_end, jnp.zeros_like(x_end)), "time"
        )
        return ws_local, xN

    stage_spec = P("batch", "time")
    term_spec = P("batch")
    f = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(stage_spec,) * 8 + (term_spec,) * 5 + (term_spec,),
        out_specs=(stage_spec, term_spec),
        check_vma=False,
    )
    return jax.jit(f)


def solve(
    mesh: Mesh,
    problem: LQRProblem,
    it: ADMMIterates,
    x0,
    sigma: float,
    solver_type: CondensedSolverType = CondensedSolverType.CHOLESKY,
):
    """Sharded PDP solve of a batch of problems.

    Args:
      mesh: ("batch", "time") mesh; N % time == 0, B % batch == 0.
      problem/it: batched pytrees with leading axis B.
      x0: (B, nx).

    Returns ws (B, N+1, nz) with the stage rows sharded over "time".
    """
    nu = problem.nu
    key = (mesh, solver_type, nu)
    if key not in _CACHE:
        _CACHE[key] = _build(mesh, solver_type, nu)
    fn = _CACHE[key]

    params = make_stage_params(problem, it, sigma)
    ws_stages, xN = fn(
        problem.A, problem.B, problem.c,
        params.H[:, :-1], params.h[:, :-1],
        problem.D[:, :-1], it.rho[:, :-1], params.g[:, :-1],
        params.H[:, -1], params.h[:, -1],
        problem.D[:, -1], it.rho[:, -1], params.g[:, -1],
        x0,
    )
    wN = jnp.concatenate(
        [jnp.zeros(xN.shape[:-1] + (nu,), xN.dtype), xN], axis=-1
    )
    return jnp.concatenate([ws_stages, wN[:, None, :]], axis=1)
