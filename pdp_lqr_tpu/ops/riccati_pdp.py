"""Segmented parallel Riccati (PDP) — segment reduction + rollout kernels.

Reference counterparts:
  include/clqr/lqr/lqr_kernel_parallel.hpp — per-stage coupling math
  include/clqr/lqr/lqr_solver_parallel.hpp — segment orchestration

The reference partitions the horizon into ``num_segments`` contiguous
segments, runs the Riccati reduction of each segment on its own OpenMP
thread, couples segments through a condensed block-tridiagonal system
over segment-boundary states, and rolls out all segments in parallel
(lqr_solver_parallel.hpp:142-238).

Re-design decisions:
  * Segments are uniform (N % S == 0) and the reduction is ONE
    ``lax.scan`` body ``vmap``-ed over the segment axis — the OpenMP
    fork/join becomes SIMD batching; the same axis later shards across
    chips via shard_map ("time" mesh axis).
  * The reference's load-balancing alpha=1.55
    (lqr_solver_parallel.hpp:70) compensates its last segment running a
    cheaper kernel; under SIMD every lane executes the same code, so we
    run the coupling math for the last segment too (its outputs are
    ignored) and uniform segments are optimal.
  * A non-last segment's boundary init (L=0, lp=0, F=I, C=0, f=0 —
    lqr_kernel_parallel.hpp:60-66) is just a different scan carry, so
    last/non-last need no control flow: with Lxx_next = 0 the base
    step reduces exactly to the reference's zero-initialized boundary
    node.

Per-segment carries: (Lxx_next, p_next) from the base kernel plus the
segment-coupling factors (F_next, C_next, f_next).  Stage outputs:
(L, lp, G) — G is needed by the segment rollout
(lqr_kernel_parallel.hpp:197: u += G uhat).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from pdp_lqr_tpu.config import f32_matmul_precision
from pdp_lqr_tpu.ops import linalg, riccati
from pdp_lqr_tpu.problem import LQRProblem, StageParams


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PDPFactors:
    """Backward-pass cache for the PDP solver.

    L, lp, G carry a leading (S, Nseg, ...) segment layout.
    Boundary exports (per segment, at its start — the reference's
    update_segment_data payload, lqr_solver_parallel.hpp:182-187):
      P0 = Lxx_start Lxx_start^T, F0, C0, p0, f0.
    condensed: factor cache of the condensed boundary solve.
    """

    L: jax.Array       # (S, Nseg, nz, nz)
    lp: jax.Array      # (S, Nseg, nz)
    G: jax.Array       # (S, Nseg, nu, nx)
    Fnext: jax.Array   # (S, Nseg, nx, nx) incoming F at each stage
    P0: jax.Array      # (S, nx, nx)
    F0: jax.Array      # (S, nx, nx)
    C0: jax.Array      # (S, nx, nx)
    p0: jax.Array      # (S, nx)
    f0: jax.Array      # (S, nx)
    LxxN: jax.Array    # (nx, nx) true terminal Cholesky factor
    condensed: object


def _segment_backward_step(carry, stage):
    """Base Riccati step + segment-coupling propagation (folded data).

    Base step: lqr_kernel.hpp:103-147 (shared with the sequential path;
    penalty fold happens outside the scan, see riccati.backward).
    Coupling (lqr_kernel_parallel.hpp:97-135):
      K = -Luu^{-T} Lxu^T ; d = -Luu^{-T} lu
      G = -Luu^{-1} B^T F+^T
      F = F+ (A + B K) ; f = F+ (c + B d) + f+ ; C = C+ + G^T G
    """
    Lxx_next, p_next, F_next, C_next, f_next = carry
    A, B, c, H, h = stage
    nu = B.shape[-1]

    (Lxx, p), (L, lp) = riccati.backward_step_folded(
        (Lxx_next, p_next), (A, B, c, H, h)
    )

    Luu = L[:nu, :nu]
    Lxu = L[nu:, :nu]
    lu = lp[:nu]

    K = linalg.solve_lower_T(Luu, -Lxu.T)
    d = linalg.solve_lower_T(Luu, -lu)
    G = linalg.solve_lower(Luu, -(B.T @ F_next.T))
    F = F_next @ (A + B @ K)
    f = F_next @ (c + B @ d) + f_next
    C = C_next + G.T @ G

    # F_next is emitted per stage so the no-refactor fast path can redo
    # the f-propagation without the matrix work (lqr_kernel_parallel.hpp:157).
    return (Lxx, p, F, C, f), (L, lp, G, F_next)


@f32_matmul_precision
def segment_reduction(problem: LQRProblem, params: StageParams, rho,
                      num_segments: int):
    """Run the per-segment backward reductions (vmapped over segments).

    Reference: LQRParallelSolver::reduction / reduction_per_thread
    (lqr_solver_parallel.hpp:156-188).  Returns stacked per-stage
    factors and per-segment boundary exports.
    """
    S = num_segments
    N, nx, nu = problem.N, problem.nx, problem.nu
    if N % S != 0:
        raise ValueError(f"horizon N={N} must be divisible by num_segments={S}")
    Nseg = N // S
    dt = params.H.dtype

    Hf, hf = riccati.penalty_fold(
        params.H, params.h, problem.D, rho, params.g
    )
    # True terminal step feeds the last segment's init
    # (lqr_solver_parallel.hpp:170-171 with is_last_segment=true).
    LxxN = linalg.cholesky(Hf[-1, nu:, nu:])
    pN = hf[-1, nu:]

    zeros = jnp.zeros((S - 1, nx, nx), dt)
    Lxx_init = jnp.concatenate([zeros, LxxN[None]], axis=0)
    p_init = jnp.concatenate([jnp.zeros((S - 1, nx), dt), pN[None]], axis=0)
    F_init = jnp.broadcast_to(jnp.eye(nx, dtype=dt), (S, nx, nx))
    C_init = jnp.zeros((S, nx, nx), dt)
    f_init = jnp.zeros((S, nx), dt)

    seg = lambda x: x.reshape((S, Nseg) + x.shape[1:])
    stages = (
        seg(problem.A), seg(problem.B), seg(problem.c),
        seg(Hf[:-1]), seg(hf[:-1]),
    )

    def one_segment(init_Lxx, init_p, init_F, init_C, init_f, seg_stages):
        carry0 = (init_Lxx, init_p, init_F, init_C, init_f)
        carry, (L, lp, G, Fnext) = jax.lax.scan(
            _segment_backward_step, carry0, seg_stages, reverse=True
        )
        Lxx0, p0, F0, C0, f0 = carry
        return L, lp, G, Fnext, Lxx0 @ Lxx0.T, F0, C0, p0, f0

    L, lp, G, Fnext, P0, F0, C0, p0, f0 = jax.vmap(one_segment)(
        Lxx_init, p_init, F_init, C_init, f_init, stages
    )
    return L, lp, G, Fnext, P0, F0, C0, p0, f0, (LxxN, pN)


@f32_matmul_precision
def segment_reduction_no_refactor(
    problem: LQRProblem, params: StageParams, rho, factors: "PDPFactors"
):
    """Vector-only per-segment reductions reusing cached factors.

    Reference: LQRParallelSolver::backward_without_factorization /
    reduction_without_factorization (lqr_solver_parallel.hpp:148-211)
    + ParallelLQRKernel::step_without_factorization
    (lqr_kernel_parallel.hpp:139-168):
      base vector step with cached L, plus
      d = -Luu^{-T} lu ;  f = F+ (c + B d) + f+.
    Returns (lp, f0, p0, pN) — the only quantities that change.
    """
    S, Nseg = factors.L.shape[0], factors.L.shape[1]
    nx, nu = problem.nx, problem.nu
    dt = params.H.dtype

    hf = riccati.penalty_fold_vec(params.h, problem.D, rho, params.g)
    pN = hf[-1, nu:]

    # Cached Lxx_{k+1} per stage: shift within each segment; the
    # boundary entry is 0 for non-last segments (zero-initialized
    # boundary node, lqr_kernel_parallel.hpp:61) and LxxN for the last.
    bound = jnp.concatenate(
        [jnp.zeros((S - 1, nx, nx), dt), factors.LxxN[None]], axis=0
    )
    Lxx_next = jnp.concatenate(
        [factors.L[:, 1:, nu:, nu:], bound[:, None]], axis=1
    )
    p_init = jnp.concatenate([jnp.zeros((S - 1, nx), dt), pN[None]], axis=0)
    f_init = jnp.zeros((S, nx), dt)

    seg = lambda x: x.reshape((S, Nseg) + x.shape[1:])
    stages = (
        seg(problem.A), seg(problem.B), seg(problem.c),
        seg(hf[:-1]), factors.L, Lxx_next, factors.Fnext,
    )

    def step(carry, stage):
        p_next, f_next = carry
        A, B, c, h, L, Lxxn, Fn = stage
        E = jnp.concatenate([B, A], axis=-1)
        Pb = Lxxn @ (Lxxn.T @ c) + p_next
        lp = h + E.T @ Pb
        lu = linalg.solve_lower(L[:nu, :nu], lp[:nu])
        p = lp[nu:] - L[nu:, :nu] @ lu
        d = linalg.solve_lower_T(L[:nu, :nu], -lu)
        f = Fn @ (c + B @ d) + f_next
        return (p, f), jnp.concatenate([lu, p])

    def one_segment(p0, f0, seg_stages):
        (p_start, f_start), lp = jax.lax.scan(
            step, (p0, f0), seg_stages, reverse=True
        )
        return lp, p_start, f_start

    lp, p0, f0 = jax.vmap(one_segment)(p_init, f_init, stages)
    return lp, p0, f0, pN


@f32_matmul_precision
def segment_rollout(problem: LQRProblem, L, lp, G, xhat, uhat):
    """Parallel forward rollout of all segments.

    Reference: LQRParallelSolver::forward (lqr_solver_parallel.hpp:213-238)
    + ParallelLQRKernel::forward_step (lqr_kernel_parallel.hpp:170-218).
    ``uhat`` must be zero for the last segment, which makes the
    boundary-dual correction term G uhat vanish and the step reduce to
    the plain forward step.

    Returns ws (N+1, nz).
    """
    S, Nseg = L.shape[0], L.shape[1]
    nu, nx = problem.nu, problem.nx

    seg = lambda x: x.reshape((S, Nseg) + x.shape[1:])
    A, B, c = seg(problem.A), seg(problem.B), seg(problem.c)

    def one_segment(x0_seg, uhat_i, seg_stages):
        def step(x, stage):
            Ak, Bk, ck, Lk, lpk, Gk = stage
            u = -(lpk[:nu] + Lk[nu:, :nu].T @ x) + Gk @ uhat_i
            u = linalg.solve_lower_T(Lk[:nu, :nu], u)
            x_next = Ak @ x + Bk @ u + ck
            return x_next, jnp.concatenate([u, x])

        x_end, ws_seg = jax.lax.scan(step, x0_seg, seg_stages)
        return x_end, ws_seg

    x_end, ws_segs = jax.vmap(one_segment)(xhat, uhat, (A, B, c, L, lp, G))
    ws = ws_segs.reshape(S * Nseg, nu + nx)
    wN = jnp.concatenate([jnp.zeros((nu,), ws.dtype), x_end[-1]])
    return jnp.concatenate([ws, wN[None]], axis=0)
