"""Sequential Riccati recursion as ``lax.scan`` — the stage-kernel layer.

Reference counterparts (cited per function):
  include/clqr/lqr/lqr_kernel.hpp   — stage math (steps, terminal, forward)
  include/clqr/lqr/lqr_solver.hpp   — the backward/forward loops

Design notes:
  * The per-stage workspace vector (``LQRKernelData``) becomes a scanned
    carry ``(Lxx_next, p_next)`` plus stacked per-stage outputs
    ``(L, lp)`` — no mutable state.
  * The reference's ragged terminal stage (no controls) is handled by
    seeding the scan carry from the terminal stage instead of padding.
  * The value function is carried in Cholesky-factored (square-root)
    form ``P = Lxx Lxx^T`` exactly like the reference, which is where
    its numerical robustness comes from.
  * The "without_factorization" variants reuse cached factors and redo
    only the O(n^2) vector work — the ADMM steady-state fast path
    (lqr_kernel.hpp:93-101,149-178).

All functions take a *single* problem; batching is ``jax.vmap`` at the
solver layer.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from pdp_lqr_tpu.config import f32_matmul_precision
from pdp_lqr_tpu.ops import linalg
from pdp_lqr_tpu.problem import LQRProblem, StageParams


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RiccatiFactors:
    """Cached backward-pass results (the reference's workspace arrays).

    L:    (N, nz, nz)  stage Cholesky factors [Luu 0; Lxu Lxx]
    lp:   (N, nz)      stage vectors [lu; p] (lu already forward-solved,
                       matching lqr_kernel.hpp:145 solveInPlace)
    LxxN: (nx, nx)     terminal Cholesky factor of H~_N
    pN:   (nx,)        terminal linear term
    """

    L: jax.Array
    lp: jax.Array
    LxxN: jax.Array
    pN: jax.Array

    @property
    def Lxx_next(self) -> jax.Array:
        """Stacked Lxx_{k+1} for k = 0..N-1, shape (N, nx, nx)."""
        nu = self.L.shape[-1] - self.LxxN.shape[-1]
        return jnp.concatenate(
            [self.L[1:, nu:, nu:], self.LxxN[None]], axis=0
        )

    @property
    def p_next(self) -> jax.Array:
        """Stacked p_{k+1} for k = 0..N-1, shape (N, nx)."""
        nu = self.L.shape[-1] - self.LxxN.shape[-1]
        return jnp.concatenate([self.lp[1:, nu:], self.pN[None]], axis=0)


def penalty_fold(H, h, D, rho, g):
    """Fold the ADMM constraint penalty into the stage cost.

    H += D^T diag(rho) D ;  h -= D^T (rho o g)
    Reference: lqr_kernel.hpp:106-112 (and :83-87 for the terminal).
    Padded constraint rows carry rho = 0 and drop out exactly.
    """
    if D.shape[-2] == 0:
        return H, h
    rhoD = rho[..., :, None] * D
    H = H + jnp.einsum("...ci,...cj->...ij", D, rhoD)
    h = h - jnp.einsum("...ci,...c->...i", D, rho * g)
    return H, h


def penalty_fold_vec(h, D, rho, g):
    """Vector-only penalty fold for the no-factorization fast path.

    Reference: lqr_kernel.hpp:152-155.
    """
    if D.shape[-2] == 0:
        return h
    return h - jnp.einsum("...ci,...c->...i", D, rho * g)


def terminal_step_raw(Hxx, hx, Dx, rho_N, g):
    """Terminal backward step on raw terminal blocks.

    Reference: LQRKernel::terminal_step_with_factorization
    (lqr_kernel.hpp:79-91): fold penalty, Lxx = chol(H~), p = h~.
    """
    Hxx, hx = penalty_fold(Hxx, hx, Dx, rho_N, g)
    Lxx = linalg.cholesky(Hxx)
    return Lxx, hx


def terminal_step(params: StageParams, problem: LQRProblem, rho_N):
    """Terminal backward step with factorization (pytree front-end)."""
    nu = problem.nu
    return terminal_step_raw(
        params.H[-1, nu:, nu:],
        params.h[-1, nu:],
        problem.D[-1, :, nu:],
        rho_N,
        params.g[-1],
    )


def backward_step(carry, stage):
    """One backward Riccati stage (with factorization).

    Reference: LQRKernel::step_with_factorization (lqr_kernel.hpp:103-147):
      fold penalty -> V = E^T Lxx+ -> M = H + V V^T -> L = chol(M)
      Pb = Lxx+ Lxx+^T c + p+ -> lp = h + E^T Pb
      lu = Luu^{-1} lp_u ;  p = lp_x - Lxu lu
    """
    A, B, c, H, h, D, rho, g = stage
    H, h = penalty_fold(H, h, D, rho, g)
    return backward_step_folded(carry, (A, B, c, H, h))


def backward_step_folded(carry, stage):
    """One backward Riccati stage on penalty-folded data.

    Reference math: LQRKernel::step_with_factorization
    (lqr_kernel.hpp:121-146) minus the fold — here the fold
    (lqr_kernel.hpp:106-112) runs *outside* the scan as one batched
    einsum over all stages, so the sequential loop body stays lean and
    D/rho/g never enter the scan's stacked inputs (memory traffic).
    """
    Lxx_next, p_next = carry
    A, B, c, H, h = stage
    nu = B.shape[-1]

    E = jnp.concatenate([B, A], axis=-1)  # (nx, nz), E = [B A]
    V = E.T @ Lxx_next  # (nz, nx)
    M = H + V @ V.T
    L = linalg.cholesky(M)

    Pb = Lxx_next @ (Lxx_next.T @ c) + p_next
    lp = h + E.T @ Pb
    lu = linalg.solve_lower(L[:nu, :nu], lp[:nu])
    p = lp[nu:] - L[nu:, :nu] @ lu
    lp = jnp.concatenate([lu, p])

    return (L[nu:, nu:], p), (L, lp)


@f32_matmul_precision
def backward(problem: LQRProblem, params: StageParams, rho) -> RiccatiFactors:
    """Full backward sweep with factorization.

    Reference: LQRSolver::backward (lqr_solver.hpp:58-63) — terminal
    step then reverse loop, here a ``lax.scan(..., reverse=True)``
    over penalty-prefolded stage data.  ``rho`` is the stacked
    (N+1, nc) penalty vector.
    """
    Hf, hf = penalty_fold(params.H, params.h, problem.D, rho, params.g)
    nu = problem.nu
    LxxN = linalg.cholesky(Hf[-1, nu:, nu:])
    pN = hf[-1, nu:]
    stages = (problem.A, problem.B, problem.c, Hf[:-1], hf[:-1])
    (_, _), (L, lp) = jax.lax.scan(
        backward_step_folded, (LxxN, pN), stages, reverse=True
    )
    return RiccatiFactors(L=L, lp=lp, LxxN=LxxN, pN=pN)


@f32_matmul_precision
def backward_no_refactor(
    problem: LQRProblem, params: StageParams, rho, factors: RiccatiFactors
) -> RiccatiFactors:
    """Backward sweep reusing cached Cholesky factors (vector work only).

    Reference: LQRSolver::backward_without_factorization
    (lqr_solver.hpp:65-70) + LQRKernel::step_without_factorization
    (lqr_kernel.hpp:149-178).  Valid when rho and sigma are unchanged
    since the factoring sweep.
    """
    nu = problem.nu
    hf = penalty_fold_vec(params.h, problem.D, rho, params.g)
    pN = hf[-1, nu:]

    def step(p_next, stage):
        A, B, c, h, L, Lxx_next = stage
        E = jnp.concatenate([B, A], axis=-1)
        Pb = Lxx_next @ (Lxx_next.T @ c) + p_next
        lp = h + E.T @ Pb
        lu = linalg.solve_lower(L[:nu, :nu], lp[:nu])
        p = lp[nu:] - L[nu:, :nu] @ lu
        return p, jnp.concatenate([lu, p])

    Lxx_next = jnp.concatenate([factors.L[1:, nu:, nu:], factors.LxxN[None]], axis=0)
    stages = (
        problem.A, problem.B, problem.c, hf[:-1], factors.L, Lxx_next,
    )
    _, lp = jax.lax.scan(step, pN, stages, reverse=True)
    return RiccatiFactors(L=factors.L, lp=lp, LxxN=factors.LxxN, pN=pN)


@f32_matmul_precision
def forward(problem: LQRProblem, factors: RiccatiFactors, x0) -> jax.Array:
    """Forward rollout: u_k = -Luu^{-T}(lu + Lxu^T x_k); x_{k+1} = A x + B u + c.

    Reference: LQRSolver::forward (lqr_solver.hpp:72-77) +
    LQRKernel::forward_step (lqr_kernel.hpp:180-204).

    Returns ws of shape (N+1, nz) with rows [u_k; x_k] (terminal u = 0),
    matching the reference's ws trajectory layout.
    """
    nu = problem.nu

    def step(x, stage):
        A, B, c, L, lp = stage
        u = -(lp[:nu] + L[nu:, :nu].T @ x)
        u = linalg.solve_lower_T(L[:nu, :nu], u)
        x_next = A @ x + B @ u + c
        return x_next, jnp.concatenate([u, x])

    xN, ws = jax.lax.scan(
        step, x0, (problem.A, problem.B, problem.c, factors.L, factors.lp)
    )
    wN = jnp.concatenate([jnp.zeros((nu,), ws.dtype), xN])
    return jnp.concatenate([ws, wN[None]], axis=0)


@f32_matmul_precision
def costates(problem: LQRProblem, params: StageParams, rho, ws) -> jax.Array:
    """Dynamics multipliers lambda_1..N via the adjoint recursion.

    The reference sketches the factor-based version in commented-out
    code (lqr_kernel.hpp:205-211: lambda+ = Lxx+ Lxx+^T x+ + p+).  Here
    we use the backend-independent adjoint recursion on the *penalized*
    stage data, which zeros the x-stationarity KKT rows exactly when ws
    solves the inner problem:

      lambda_N = Hxx~_N x_N + hx~_N
      lambda_k = Hxx~_k x_k + Hxu~_k u_k + hx~_k + A_k^T lambda_{k+1}

    Returns (N, nx): lambda at stages 1..N.
    """
    nu = problem.nu
    H, h = penalty_fold(params.H, params.h, problem.D, rho, params.g)

    lamN = H[-1, nu:, nu:] @ ws[-1, nu:] + h[-1, nu:]

    def step(lam_next, stage):
        A, Hk, hk, wk = stage
        grad_x = Hk[nu:, :] @ wk + hk[nu:]
        lam = grad_x + A.T @ lam_next
        return lam, lam

    # Scan k = N-1 .. 1 producing lambda_{k+1}; stage 0's x-row has no
    # multiplier of its own (x0 is data).
    _, lams = jax.lax.scan(
        step, lamN, (problem.A[1:], H[1:-1], h[1:-1], ws[1:-1]), reverse=True
    )
    return jnp.concatenate([lams, lamN[None]], axis=0)
