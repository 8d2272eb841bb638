"""Throughput-optimized dense Riccati — the XLA fast path.

Same mathematics as ops/riccati.py (reference lqr_kernel.hpp:103-147)
but reorganized for batched execution rather than transcribed:

  * The value function is carried as (P, p) directly instead of the
    reference's Cholesky square-root (Lxx), removing the (nz, nz)
    factorization from the sequential loop.  The only per-step solve is
    with the (nu, nu) SPD input Hessian Huu = R~ + B^T P+ B, done by a
    fully *unrolled* Cholesky (linalg.cholesky_unrolled) that compiles
    to straight-line elementwise arithmetic over the batch — XLA's generic
    cholesky/triangular_solve lowerings are loop-heavy and orders of
    magnitude slower at these sizes.
  * The backward scan emits feedback gains (K, d) per stage, so the
    forward rollout needs no solves at all: closed-loop matrices
    M = A + B K and offsets v = B d + c are formed OUTSIDE the scan as
    one big batched matmul, and the rollout scan is a bare matvec.
  * The no-refactor fast path (reference lqr_solver.hpp:65-70) is pure
    vector work: with K cached, G^T d collapses via G = -Huu K to
    K^T (r~ + B^T(P+ c + p+)), and d reuses the cached Huu Cholesky.

Recursion (u-first [u; x] blocks R~, S~ (nu, nx), Q~, r~, q~ of the
penalty-folded stage cost):

  G   = S~ + B^T P+ A          Huu = R~ + B^T P+ B
  K   = -Huu^{-1} G            d   = -Huu^{-1} (r~ + B^T (P+ c + p+))
  P   = Q~ + A^T P+ A + G^T K  p   = q~ + A^T (P+ c + p+) + K^T (r~ + B^T(P+ c + p+))

(the p form uses G^T d = K^T Huu^T Huu^{-1}(...) = K^T (r~ + B^T Pcp),
exact by the definitions of K and d.)

Numerical note: carrying P forfeits the square-root form's guaranteed
symmetry/PSD-ness; P is re-symmetrized every step, and the f64 parity
tests pin the math to the factored backends.  Use the sequential /
assoc backends when square-root robustness matters more than raw
throughput.
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
class DenseFactors:
    """Backward-pass cache: feedback law + cost-to-go + Huu factors.

    K: (N, nu, nx)     d: (N, nu)
    P: (N+1, nx, nx)   p: (N+1, nx)
    Lhuu: (N, nu, nu)  lower Cholesky of Huu per stage (for the
                       vector-only fast path).
    """

    K: jax.Array
    d: jax.Array
    P: jax.Array
    p: jax.Array
    Lhuu: jax.Array


@f32_matmul_precision
def backward(problem: LQRProblem, params: StageParams, rho) -> DenseFactors:
    """Backward sweep in P-form (lean scan body, unrolled nu-solve)."""
    nu = problem.nu
    Hf, hf = riccati.penalty_fold(params.H, params.h, problem.D, rho, params.g)

    R = Hf[:-1, :nu, :nu]
    S = Hf[:-1, :nu, nu:]
    Q = Hf[:-1, nu:, nu:]
    r = hf[:-1, :nu]
    q = hf[:-1, nu:]

    PN = Hf[-1, nu:, nu:]
    pN = hf[-1, nu:]

    def step(carry, stage):
        P_next, p_next = carry
        A, B, c, Rk, Sk, Qk, rk, qk = stage
        BT = B.T
        PA = P_next @ A
        Pcp = P_next @ c + p_next
        G = Sk + BT @ PA
        Huu = Rk + BT @ (P_next @ B)
        Lh = linalg.cholesky_unrolled(Huu)
        rbar = rk + BT @ Pcp
        sol = linalg.chol_solve_unrolled(
            Lh, jnp.concatenate([G, rbar[..., None]], axis=-1)
        )
        K = -sol[..., :-1]
        d = -sol[..., -1]
        P = Qk + A.T @ PA + G.T @ K
        P = 0.5 * (P + P.T)
        p = qk + A.T @ Pcp + K.T @ rbar
        return (P, p), (K, d, Lh, P_next, p_next)

    stages = (problem.A, problem.B, problem.c, R, S, Q, r, q)
    (P0, p0), (K, d, Lh, Pn, pn) = jax.lax.scan(
        step, (PN, pN), stages, reverse=True
    )
    # Pn[k] = P_{k+1} (the carry entering step k), so [P0] + Pn covers
    # stages 0..N exactly.
    P = jnp.concatenate([P0[None], Pn], axis=0)
    p = jnp.concatenate([p0[None], pn], axis=0)
    return DenseFactors(K=K, d=d, P=P, p=p, Lhuu=Lh)


@f32_matmul_precision
def backward_no_refactor(
    problem: LQRProblem, params: StageParams, rho, factors: DenseFactors
) -> DenseFactors:
    """Vector-only backward with cached gains (rho/sigma unchanged).

    Reference semantics: lqr_solver.hpp:65-70 / lqr_kernel.hpp:149-178.
    Per step (K, Lhuu, P cached; only r~, q~, and the p-recursion run):

      Pcp  = P+ c + p+
      rbar = r~ + B^T Pcp
      d    = -(Lhuu Lhuu^T)^{-1} rbar
      p    = q~ + A^T Pcp + K^T rbar
    """
    nu = problem.nu
    hf = riccati.penalty_fold_vec(params.h, problem.D, rho, params.g)
    r = hf[:-1, :nu]
    q = hf[:-1, nu:]
    pN = hf[-1, nu:]

    def step(p_next, stage):
        A, B, c, K, Lh, P_next, rk, qk = stage
        Pcp = P_next @ c + p_next
        rbar = rk + B.T @ Pcp
        d = -linalg.chol_solve_unrolled(Lh, rbar[..., None])[..., 0]
        p = qk + A.T @ Pcp + K.T @ rbar
        return p, (d, p_next)

    stages = (
        problem.A, problem.B, problem.c, factors.K, factors.Lhuu,
        factors.P[1:], r, q,
    )
    p0, (d, pn) = jax.lax.scan(step, pN, stages, reverse=True)
    p = jnp.concatenate([p0[None], pn], axis=0)
    return dataclasses.replace(factors, d=d, p=p)


@f32_matmul_precision
def forward(problem: LQRProblem, factors: DenseFactors, x0):
    """Rollout with precomputed closed-loop maps (no per-step solves).

    Returns ws (N+1, nz) rows [u_k; x_k] (terminal u = 0), matching
    every other backend's layout.
    """
    nu = problem.nu
    K, d = factors.K, factors.d
    M = problem.A + problem.B @ K
    v = (problem.B @ d[..., None])[..., 0] + problem.c

    def step(x, stage):
        Mk, vk, Kk, dk = stage
        u = (Kk @ x[..., None])[..., 0] + dk
        return (Mk @ x[..., None])[..., 0] + vk, jnp.concatenate([u, x])

    xN, ws = jax.lax.scan(step, x0, (M, v, K, d))
    wN = jnp.concatenate([jnp.zeros((nu,), ws.dtype), xN])
    return jnp.concatenate([ws, wN[None]], axis=0)
