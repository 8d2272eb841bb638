"""Batched block-tridiagonal KKT factorization — the QDLDL-path analog.

Reference counterparts: include/clqr/lqr/kkt.hpp (sparse KKT assembly)
and include/clqr/lqr/qdldl_solver.hpp (general sparse LDL^T via QDLDL).
The reference assembles one big sparse symmetric matrix over the whole
horizon (variable ordering kkt.hpp:124-205, qdldl_solver.hpp:112-140)
and refactors it numerically every ADMM rho-update.

Re-design: general dynamic sparsity does not vectorize, but the KKT
matrix of an LQ problem is *block tridiagonal* with a fixed bandwidth
set by (nx, nu) — so the sparse LDL^T becomes a batched block-Thomas
factorization over dense stage blocks:

  stage meta-variable v_k = [lambda_k; x_k; u_k]   (m = 2 nx + nu)

  diagonal block  D_k = [ -rho_dyn I   I      0   ]
                        [  I           Q~_k   S~_k^T ]
                        [  0           S~_k   R~_k ]

  super-diagonal  E_k  couples v_k -> v_{k+1}: x_k/u_k rows carry
                  -A_k^T / -B_k^T into the lambda_{k+1} column.

  (lambda_k is the dynamics dual; constraint duals y_k are eliminated
  exactly first — the Schur complement of the -rho^{-1} diagonal block
  is the penalty fold H + D^T rho D, the same algebra the reference's
  KKT regularization encodes, kkt.hpp:198-199 & 124-205.)

  v_0 pads lambda_0/x_0 with identity dummies (x_0 is data and enters
  the right-hand side, kkt.hpp:207-222); v_N pads u_N.

Factor sweep (the LDL^T): S_0 = D_0;  S_k = D_k - E_{k-1}^T U_{k-1}
with U_k = S_k^{-1} E_k, each pivot block explicitly inverted
(indefinite — the system is symmetric quasi-definite thanks to
sigma/rho_dyn, so block elimination in stage order is stable; the
reference relies on QDLDL's fixed elimination order the same way).
Solve = forward sweep zhat_k = S_k^{-1}(rhs_k - E_{k-1}^T zhat_{k-1})
+ backward sweep v_k = zhat_k - U_k v_{k+1}.

The cached (S_k^{-1}, U_k) play the role of QDLDL's numeric factor; the
symbolic phase (qdldl_solver.hpp:47-78) disappears entirely — the
structure is static.  ``solve_cached`` is the analog of re-solving with
an existing factor (new rhs only).
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
class KKTFactors:
    """Numeric factor cache of the block-tridiagonal KKT matrix.

    Sinv: explicit inverses of the pivot blocks S_k, (N+1, m, m) —
      cached as inverses (not LU factors) so every resolve is pure
      batched matmul instead of XLA's loop-lowered
      lu_solve; the blocks are symmetric quasi-definite (sigma /
      rho_dyn regularized), so the inverse is well-conditioned.
    U: S_k^{-1} E_k for k = 0..N-1, (N, m, m).
    E: the super-diagonal blocks (needed by the forward sweep).
    """

    Sinv: jax.Array
    U: jax.Array
    E: jax.Array


def build_blocks(problem: LQRProblem, params: StageParams, rho,
                 rho_dyn: float):
    """Assemble dense stage blocks (D, E) of the block-tridiag KKT.

    Mirrors KKTSystem::form_KKT_matrix (kkt.hpp:124-205) with constraint
    duals pre-eliminated (exact Schur complement = penalty fold).
    """
    N, nx, nu = problem.N, problem.nx, problem.nu
    m = 2 * nx + nu
    H, h = riccati.penalty_fold(params.H, params.h, problem.D, rho, params.g)
    dt = H.dtype

    R = H[:, :nu, :nu]      # (N+1, nu, nu); terminal row is 0-padded
    S = H[:, :nu, nu:]
    Q = H[:, nu:, nu:]

    D = jnp.zeros((N + 1, m, m), dt)
    eye_x = jnp.eye(nx, dtype=dt)

    # lambda block: -rho_dyn I (kkt.hpp dynamics-row regularization);
    # identity dummy at stage 0 (no lambda_0 exists).
    lam_blk = jnp.broadcast_to(-rho_dyn * eye_x, (N + 1, nx, nx))
    lam_blk = lam_blk.at[0].set(eye_x)
    D = D.at[:, :nx, :nx].set(lam_blk)

    # lambda/x coupling +I (dynamics eq defines x_k); none at stage 0.
    cross = jnp.broadcast_to(eye_x, (N + 1, nx, nx))
    cross = cross.at[0].set(jnp.zeros((nx, nx), dt))
    D = D.at[:, :nx, nx : 2 * nx].set(cross)
    D = D.at[:, nx : 2 * nx, :nx].set(cross)

    # x block Q~; identity dummy at stage 0 (x_0 is data).
    Qb = Q.at[0].set(eye_x)
    D = D.at[:, nx : 2 * nx, nx : 2 * nx].set(Qb)

    # u block R~; identity dummy at terminal (u_N does not exist).
    eye_u = jnp.eye(nu, dtype=dt)
    Rb = R.at[N].set(eye_u)
    D = D.at[:, 2 * nx :, 2 * nx :].set(Rb)

    # x/u cross S~ (zero at stage 0 — x_0 contribution moves to rhs —
    # and at terminal where H's u rows are 0 already).
    Sb = S.at[0].set(jnp.zeros((nu, nx), dt))
    D = D.at[:, 2 * nx :, nx : 2 * nx].set(Sb)
    D = D.at[:, nx : 2 * nx, 2 * nx :].set(jnp.swapaxes(Sb, -1, -2))

    # Super-diagonal: x_k/u_k rows -> lambda_{k+1} column, -A^T / -B^T
    # (stage 0 keeps only the -B^T entry: x_0 is data).
    E = jnp.zeros((N, m, m), dt)
    AT = jnp.swapaxes(problem.A, -1, -2)
    AT = AT.at[0].set(jnp.zeros((nx, nx), dt))
    E = E.at[:, nx : 2 * nx, :nx].set(-AT)
    E = E.at[:, 2 * nx :, :nx].set(-jnp.swapaxes(problem.B, -1, -2))
    return D, E


def build_rhs(problem: LQRProblem, params: StageParams, rho, x0):
    """Right-hand side in the stage-block layout (kkt.hpp:224-300 +
    x0 injection :207-222)."""
    N, nx, nu = problem.N, problem.nx, problem.nu
    m = 2 * nx + nu
    H, h = riccati.penalty_fold(params.H, params.h, problem.D, rho, params.g)
    dt = h.dtype

    rhs = jnp.zeros((N + 1, m), dt)
    # lambda rows: dynamics residual c_{k-1}; stage 1 additionally
    # carries A_0 x_0.
    lam = problem.c
    lam = lam.at[0].add(problem.A[0] @ x0)
    rhs = rhs.at[1:, :nx].set(lam)
    # x rows: -q~_k; stage 0 dummy stays 0 (x_0 fixed).
    rhs = rhs.at[1:, nx : 2 * nx].set(-h[1:, nu:])
    # u rows: -r~_k; stage 0 includes the S~_0 x_0 shift; terminal dummy 0.
    ru = -h[:N, :nu]
    ru = ru.at[0].add(-(H[0, :nu, nu:] @ x0))
    rhs = rhs.at[:N, 2 * nx :].set(ru)
    return rhs


# Pivot blocks up to this size invert via the unrolled branch-free GE
# (straight-line elementwise code in the scan body); larger blocks fall back to
# XLA's LU — its sequential lowering is paid once per rho-update, and
# the resolve path stays matmul-only either way.
UNROLL_INV_MAX = 32


def _invert(S):
    m = S.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(m, dtype=S.dtype), S.shape)
    if m <= UNROLL_INV_MAX:
        return linalg.ge_solve_unrolled(S, eye)
    return jnp.linalg.solve(S, eye)


@f32_matmul_precision
def factorize(D, E) -> KKTFactors:
    """Block-Thomas factor sweep (the batched LDL^T numeric factor).

    Analog of QDLDL_factor (qdldl_solver.hpp:88-109) on the static
    block-tridiagonal structure.  Pivot-block inverses are materialized
    so the whole solve path (and the scan body's own U update) runs on
    matmuls rather than loop-lowered triangular solves.
    """
    Sinv0 = _invert(D[0])

    def step(Sinv_prev, inp):
        Dk, Ekm1 = inp
        U_prev = Sinv_prev @ Ekm1
        Sk = Dk - jnp.swapaxes(Ekm1, -1, -2) @ U_prev
        Sinv = _invert(Sk)
        return Sinv, (Sinv, U_prev)

    _, (Sinvs, Us) = jax.lax.scan(step, Sinv0, (D[1:], E))
    Sinv = jnp.concatenate([Sinv0[None], Sinvs], axis=0)
    return KKTFactors(Sinv=Sinv, U=Us, E=E)


@f32_matmul_precision
def solve_cached(fac: KKTFactors, rhs):
    """Forward + backward substitution with cached factors.

    Analog of QDLDL_solve (qdldl_solver.hpp:111-151): new rhs, no
    numeric refactorization.  Matmul-only (cached inverses).
    """
    def fwd(zhat_prev, inp):
        Sinv, Ekm1, rk = inp
        r = rk - (jnp.swapaxes(Ekm1, -1, -2) @ zhat_prev[..., None])[..., 0]
        zhat = (Sinv @ r[..., None])[..., 0]
        return zhat, zhat

    z0 = (fac.Sinv[0] @ rhs[0][..., None])[..., 0]
    _, zhats = jax.lax.scan(
        fwd, z0, (fac.Sinv[1:], fac.E, rhs[1:])
    )
    zhat = jnp.concatenate([z0[None], zhats], axis=0)

    def bwd(v_next, inp):
        zk, Uk = inp
        v = zk - (Uk @ v_next[..., None])[..., 0]
        return v, v

    vN = zhat[-1]
    _, vs = jax.lax.scan(bwd, vN, (zhat[:-1], fac.U), reverse=True)
    return jnp.concatenate([vs, vN[None]], axis=0)


def extract_ws(v, problem: LQRProblem, x0):
    """Stage-block solution -> trajectory ws (N+1, nz) rows [u_k; x_k]."""
    nx, nu = problem.nx, problem.nu
    us = v[:-1, 2 * nx :]                      # u_0..u_{N-1}
    xs = jnp.concatenate([x0[None], v[1:, nx : 2 * nx]], axis=0)
    us_full = jnp.concatenate(
        [us, jnp.zeros((1, nu), us.dtype)], axis=0
    )
    return jnp.concatenate([us_full, xs], axis=-1)


def extract_lambdas(v, problem: LQRProblem):
    """Dynamics duals lambda_1..lambda_N, (N, nx)."""
    return v[1:, : problem.nx]


def extract_constraint_duals(ws, problem: LQRProblem, params: StageParams,
                             rho):
    """Per-row constraint duals y, (N+1, nc) — the variables the block
    elimination removed.

    The reference's KKT carries y explicitly (variable ordering
    qdldl_solver.hpp:112-140) with row equations D_k w_k - rho^{-1} y_k
    = g_k (the -rho^{-1} diagonal block, kkt.hpp:198-199), so the
    eliminated duals are recovered EXACTLY from the primal solution:

        y_k = rho_k o (D_k w_k - g_k)

    Padded rows (rho = 0) return 0.
    """
    Dw = jnp.einsum("kcz,kz->kc", problem.D, ws)
    return rho * (Dw - params.g)
