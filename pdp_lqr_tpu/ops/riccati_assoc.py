"""Log-depth Riccati via ``lax.associative_scan``.

No reference counterpart: the reference parallelizes the backward sweep
only across coarse OpenMP segments (lqr_solver_parallel.hpp:142-162),
each segment still a serial O(Nseg) recursion.  Here the *whole*
backward pass is a parallel suffix reduction over conditional
value-function elements (Sarkka & Garcia-Fernandez, "Temporal
Parallelization of Dynamic Programming and Linear Quadratic Control",
public algorithm), giving O(log N) depth — the right shape for an
accelerator, where sequential small-matrix steps leave the device idle
and depth, not FLOPs, bounds latency.

Element e = (A, b, C, eta, J) represents the conditional value function
between two stages:

  V_e(x, z) = sup_l { l^T (z - A x - b) - 1/2 l^T C l }
              + 1/2 x^T J x - eta^T x      (+ const, not tracked)

(equivalently 1/2 (z-Ax-b)^T C^{-1} (z-Ax-b) + ... when C is invertible;
the sup form also covers singular C, e.g. the terminal element).

Composition over the shared intermediate state y,
V_{13}(x,z) = min_y [V_{12}(x,y) + V_{23}(y,z)], is associative with
the closed-form rule (same lemma as the parallel Kalman smoother):

  T   = (I + C1 J2)^{-1}            (eigenvalues >= 1: C1, J2 are PSD)
  A3  = A2 T A1
  b3  = A2 T (b1 + C1 eta2) + b2
  C3  = A2 T C1 A2^T + C2
  eta3 = A1^T T^T (eta2 - J2 b1) + eta1
  J3  = A1^T T^T J2 A1 + J1

using (I + J2 C1)^{-1} = (I + C1 J2)^{-T} (C, J symmetric), so one LU
factorization per combine serves both solves.

The suffix-combined element at stage k has J = P_k, eta = -p_k — the
cost-to-go of the sequential recursion.  Stage factors (L, lp) are then
recovered stage-parallel (one batched Cholesky over all N stages at
once) in the exact layout of ``riccati.RiccatiFactors``, so the
sequential forward rollout and the cached-factor fast path work
unchanged on top; ``forward_assoc`` additionally provides a log-depth
rollout as a prefix scan over affine maps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pdp_lqr_tpu.config import f32_matmul_precision
from pdp_lqr_tpu.ops import linalg, riccati
from pdp_lqr_tpu.problem import LQRProblem, StageParams


def leaf_elements(problem: LQRProblem, params: StageParams, rho):
    """Per-stage value elements from penalty-folded stage data.

    Stage k < N (cost blocks R~, S~, Q~, r~, q~ of the penalized H~, h~;
    dynamics x+ = A x + B u + c), eliminating u:

      A_k  = A - B R~^{-1} S~        b_k = c - B R~^{-1} r~
      C_k  = B R~^{-1} B^T
      J_k  = Q~ - S~^T R~^{-1} S~    eta_k = -(q~ - S~^T R~^{-1} r~)

    Terminal: A = 0, b = 0, C = 0, J = Q~_N, eta = -q~_N.

    Returns a 5-tuple of (N+1, ...) stacked arrays.
    """
    nu, nx = problem.nu, problem.nx
    H, h = riccati.penalty_fold(params.H, params.h, problem.D, rho, params.g)
    dt = H.dtype

    R = H[:-1, :nu, :nu]
    S = H[:-1, :nu, nu:]
    Q = H[:-1, nu:, nu:]
    r = h[:-1, :nu]
    q = h[:-1, nu:]

    # R~^{-1} applied to [S | r | B^T] via one batched unrolled Cholesky
    # (stage-parallel; XLA's generic lowering is loop-sequential).
    LR = linalg.cholesky_unrolled(R)
    BT = jnp.swapaxes(problem.B, -1, -2)
    rhs = jnp.concatenate([S, r[..., None], BT], axis=-1)
    sol = linalg.chol_solve_unrolled(LR, rhs)  # (N, nu, nx + 1 + nx)
    RiS = sol[..., :nx]
    Rir = sol[..., nx]
    RiBT = sol[..., nx + 1 :]

    Ae = problem.A - problem.B @ RiS
    be = problem.c - (problem.B @ Rir[..., None])[..., 0]
    Ce = problem.B @ RiBT
    Je = Q - jnp.swapaxes(S, -1, -2) @ RiS
    ee = -(q - (jnp.swapaxes(S, -1, -2) @ Rir[..., None])[..., 0])

    zero_m = jnp.zeros((1, nx, nx), dt)
    AeN = jnp.concatenate([Ae, zero_m], axis=0)
    beN = jnp.concatenate([be, jnp.zeros((1, nx), dt)], axis=0)
    CeN = jnp.concatenate([Ce, zero_m], axis=0)
    JeN = jnp.concatenate([Je, H[-1:, nu:, nu:]], axis=0)
    eeN = jnp.concatenate([ee, -h[-1:, nu:]], axis=0)
    return AeN, beN, CeN, eeN, JeN


def combine(e_early, e_late, solve=jnp.linalg.solve):
    """Associative composition of value elements (earlier, later).

    ``solve`` picks the (I + C1 J2) solver: the batched-LU default is
    safe anywhere; ``linalg.ge_solve_unrolled`` compiles to straight-
    line elementwise code and is used where the combine body appears
    only once or a few times in the program (see
    ``_suffix_scan_blocked`` — replicating the unrolled body into every
    level of a full associative-scan tree makes the program huge).
    """
    A1, b1, C1, n1, J1 = e_early
    A2, b2, C2, n2, J2 = e_late
    nx = A1.shape[-1]
    eye = jnp.eye(nx, dtype=A1.dtype)

    IpCJ = eye + C1 @ J2
    # T X for X in [A1 | C1 | b1 + C1 eta2]; T = (I + C1 J2)^{-1}.
    rhs = jnp.concatenate(
        [A1, C1, (b1 + (C1 @ n2[..., None])[..., 0])[..., None]], axis=-1
    )
    TX = solve(IpCJ, rhs)
    TA1 = TX[..., :nx]
    TC1 = TX[..., nx : 2 * nx]
    Tb = TX[..., 2 * nx]

    # T^T Y for Y in [J2 A1 | eta2 - J2 b1]; T^T = (I + J2 C1)^{-1}.
    rhsT = jnp.concatenate(
        [J2 @ A1, (n2 - (J2 @ b1[..., None])[..., 0])[..., None]], axis=-1
    )
    TTY = solve(jnp.swapaxes(IpCJ, -1, -2), rhsT)
    TJ2A1 = TTY[..., :nx]
    Tn = TTY[..., nx]

    A1T = jnp.swapaxes(A1, -1, -2)
    A3 = A2 @ TA1
    b3 = (A2 @ Tb[..., None])[..., 0] + b2
    C3 = A2 @ TC1 @ jnp.swapaxes(A2, -1, -2) + C2
    n3 = (A1T @ Tn[..., None])[..., 0] + n1
    J3 = A1T @ TJ2A1 + J1
    # Symmetrize: C and J are symmetric by construction; the solves
    # break it at roundoff and the error compounds over log N levels.
    C3 = 0.5 * (C3 + jnp.swapaxes(C3, -1, -2))
    J3 = 0.5 * (J3 + jnp.swapaxes(J3, -1, -2))
    return A3, b3, C3, n3, J3


def _identity_elements(n: int, nx: int, dt):
    """n copies of the combine identity (A=I, b=0, C=0, eta=0, J=0)."""
    eye = jnp.broadcast_to(jnp.eye(nx, dtype=dt), (n, nx, nx))
    zm = jnp.zeros((n, nx, nx), dt)
    zv = jnp.zeros((n, nx), dt)
    return eye, zv, zm, zv, zm


# In-block length for the blocked suffix scan.  Chosen so the
# sequential phase (depth L, batched over N/L blocks AND any vmap
# batch) stays shorter than the LU-lowered tree it replaces while the
# unrolled-GE combine body appears in the program only twice (scan
# body + fix-up), not once per tree level.
SCAN_BLOCK = 16

# Largest nx that uses the unrolled-GE combine in the blocked scan.
# The unrolled body is ~nx^2 HLO ops; at nx = 40 (mass-spring) its
# compile takes many minutes, while the batched LU tree compiles in
# seconds — past this size the plain
# associative_scan with jnp.linalg.solve wins on compile AND the
# per-level LU amortizes over the larger per-element matmul work.
UNROLL_NX_MAX = 20


def _suffix_scan_blocked(elems, block: int = SCAN_BLOCK):
    """Inclusive suffix combine of value elements, blocked.

    Three phases (classic blocked scan):
      1. in-block suffix scan — ``lax.scan`` over ``block`` steps,
         batched across N/block blocks; combine body (with the
         *unrolled* GE solve) appears once.
      2. associative scan over the N/block block aggregates — only
         log2(N/block) levels, each a small batched-LU combine.
      3. one batched fix-up combining every in-block suffix with the
         aggregate of all later blocks.

    Depth ~ block + log2(N/block) with straight-line vector bodies —
    measured faster than both the pure LU tree (slow levels) and the
    pure unrolled tree (uncompilable at N = 512).
    """
    N1 = elems[0].shape[0]
    nx = elems[0].shape[-1]
    dt = elems[0].dtype
    if N1 <= block or nx > UNROLL_NX_MAX:
        return jax.lax.associative_scan(
            lambda a, b: combine(b, a), elems, axis=0, reverse=True
        )
    nb = -(-N1 // block)
    pad = nb * block - N1
    if pad:
        ident = _identity_elements(pad, nx, dt)
        elems = tuple(
            jnp.concatenate([e, i], axis=0) for e, i in zip(elems, ident)
        )
    blocked = tuple(
        e.reshape((nb, block) + e.shape[1:]) for e in elems
    )

    # Phase 1: suffix within each block (carry = suffix of later stages
    # in the block), unrolled-GE combine once in the scan body.
    ident1 = _identity_elements(nb, nx, dt)

    def step(carry, stage):
        out = combine(stage, carry, solve=linalg.ge_solve_unrolled)
        return out, out

    swap = lambda t: tuple(jnp.swapaxes(e, 0, 1) for e in t)
    _, suffixes = jax.lax.scan(step, ident1, swap(blocked), reverse=True)
    suffixes = swap(suffixes)                   # (nb, block, ...)

    # Phase 2: aggregates = in-block suffix at position 0; exclusive
    # suffix over blocks (aggregate of strictly later blocks).
    aggs = tuple(s[:, 0] for s in suffixes)
    agg_suf = jax.lax.associative_scan(
        lambda a, b: combine(b, a), aggs, axis=0, reverse=True
    )
    right = tuple(
        jnp.concatenate([a[1:], i], axis=0)
        for a, i in zip(agg_suf, _identity_elements(1, nx, dt))
    )

    # Phase 3: one batched fix-up across all (nb, block) positions.
    right_b = tuple(
        jnp.broadcast_to(r[:, None], s.shape)
        for r, s in zip(right, suffixes)
    )
    full = combine(suffixes, right_b, solve=linalg.ge_solve_unrolled)
    out = tuple(
        f.reshape((nb * block,) + f.shape[2:])[:N1] for f in full
    )
    return out


@f32_matmul_precision
def cost_to_go(problem: LQRProblem, params: StageParams, rho):
    """All cost-to-go pairs (P_k, p_k), k = 0..N, in near-log depth."""
    elems = leaf_elements(problem, params, rho)
    out = _suffix_scan_blocked(elems)
    _, _, _, eta, J = out
    return J, -eta


@f32_matmul_precision
def backward(problem: LQRProblem, params: StageParams, rho) -> riccati.RiccatiFactors:
    """Log-depth backward pass producing sequential-layout factors.

    The scan yields (P_{k+1}, p_{k+1}) for every k at once; the stage
    factors of lqr_kernel.hpp:103-147 are then recovered with *one*
    batched Cholesky over all stages:

      M_k  = H~_k + E_k^T P_{k+1} E_k,  L_k = chol(M_k)
      lp_k = h~_k + E_k^T (P_{k+1} c_k + p_{k+1});  lu forward-solved.
    """
    nu = problem.nu
    P, p = cost_to_go(problem, params, rho)
    P_next, p_next = P[1:], p[1:]

    H, h = riccati.penalty_fold(params.H, params.h, problem.D, rho, params.g)
    E = jnp.concatenate([problem.B, problem.A], axis=-1)
    ET = jnp.swapaxes(E, -1, -2)

    M = H[:-1] + ET @ P_next @ E
    L = linalg.cholesky_unrolled(M)
    Pb = (P_next @ problem.c[..., None])[..., 0] + p_next
    lp = h[:-1] + (ET @ Pb[..., None])[..., 0]
    lu = linalg.solve_lower_unrolled(
        L[..., :nu, :nu], lp[..., :nu, None]
    )[..., 0]
    pv = lp[..., nu:] - (L[..., nu:, :nu] @ lu[..., None])[..., 0]
    lp = jnp.concatenate([lu, pv], axis=-1)

    LxxN = linalg.cholesky_unrolled(H[-1, nu:, nu:])
    return riccati.RiccatiFactors(L=L, lp=lp, LxxN=LxxN, pN=h[-1, nu:])


@f32_matmul_precision
def forward(problem: LQRProblem, factors: riccati.RiccatiFactors, x0):
    """Log-depth forward rollout as a prefix scan over affine maps.

    From the cached factors: u_k = K_k x_k + d_k with
    K = -Luu^{-T} Lxu^T, d = -Luu^{-T} lu, so
    x_{k+1} = (A + B K) x_k + (B d + c) — composed by an associative
    prefix scan, then u recovered stage-parallel.  Same output layout
    as ``riccati.forward`` (ws rows [u_k; x_k], terminal u = 0).
    """
    nu = problem.nu
    L, lp = factors.L, factors.lp
    Luu = L[..., :nu, :nu]
    Lxu = L[..., nu:, :nu]
    lu = lp[..., :nu]

    K = linalg.solve_lower_T_unrolled(Luu, -jnp.swapaxes(Lxu, -1, -2))
    d = linalg.solve_lower_T_unrolled(Luu, -lu[..., None])[..., 0]

    M = problem.A + problem.B @ K
    v = (problem.B @ d[..., None])[..., 0] + problem.c

    def comp(a, b):
        M1, v1 = a
        M2, v2 = b
        return M2 @ M1, (M2 @ v1[..., None])[..., 0] + v2

    Mc, vc = jax.lax.associative_scan(comp, (M, v), axis=0)
    xs_next = (Mc @ x0[None, :, None])[..., 0] + vc     # x_1..x_N
    xs = jnp.concatenate([x0[None], xs_next[:-1]], axis=0)  # x_0..x_{N-1}
    us = (K @ xs[..., None])[..., 0] + d

    ws = jnp.concatenate([us, xs], axis=-1)
    wN = jnp.concatenate([jnp.zeros((nu,), ws.dtype), xs_next[-1]])
    return jnp.concatenate([ws, wN[None]], axis=0)


@f32_matmul_precision
def backward_no_refactor(
    problem: LQRProblem, params: StageParams, rho, factors: riccati.RiccatiFactors
) -> riccati.RiccatiFactors:
    """Log-depth vector-only backward with cached factors.

    The p-recursion p_k = (A + B K_k)^T p_{k+1} + w_k is affine with
    per-stage coefficients computable stage-parallel from the cached
    L, so a suffix associative scan over (M, v) = ((A+BK)^T, w) redoes
    only O(nx^2)-per-combine work — the log-depth analog of
    lqr_solver.hpp:65-70.

    Derivation (from lqr_kernel.hpp:149-178 with L fixed):
      lp_k = h~_k + E^T (P_{k+1} c + p_{k+1}),
      lu = Luu^{-1} lp_u,  p_k = lp_x - Lxu lu
    so  p_k = (A + B K)^T p_{k+1} + [w_k from h~, P_{k+1} c] where
      K = -Luu^{-T} Lxu^T and P_{k+1} = Lxx_{k+1} Lxx_{k+1}^T.
    """
    nu = problem.nu
    h = riccati.penalty_fold_vec(params.h, problem.D, rho, params.g)
    L = factors.L
    Luu = L[..., :nu, :nu]
    Lxu = L[..., nu:, :nu]

    Lxx_next = factors.Lxx_next
    Pc = (Lxx_next @ (jnp.swapaxes(Lxx_next, -1, -2)
                      @ problem.c[..., None]))[..., 0]

    K = linalg.solve_lower_T_unrolled(Luu, -jnp.swapaxes(Lxu, -1, -2))
    # Stationary parts of lp given p_{k+1} = 0:
    lp0 = h[:-1] + (jnp.swapaxes(
        jnp.concatenate([problem.B, problem.A], axis=-1), -1, -2
    ) @ Pc[..., None])[..., 0]
    lu0 = linalg.solve_lower_unrolled(Luu, lp0[..., :nu, None])[..., 0]
    w = lp0[..., nu:] - (Lxu @ lu0[..., None])[..., 0]

    MT = jnp.swapaxes(problem.A + problem.B @ K, -1, -2)

    def comp(a, b):
        # Suffix composition p_k = MT_k p_{k+1} + w_k: (earlier, later)
        # composes as p = MT1 (MT2 p + w2) + w1.
        M1, v1 = a
        M2, v2 = b
        return M1 @ M2, (M1 @ v2[..., None])[..., 0] + v1

    pN = h[-1, nu:]
    Mc, vc = jax.lax.associative_scan(
        lambda a, b: comp(b, a), (MT, w), axis=0, reverse=True
    )
    p = (Mc @ pN[None, :, None])[..., 0] + vc  # p_k for k = 0..N-1

    # Recover lp with the true p_{k+1} (stage-parallel vector work).
    p_next = jnp.concatenate([p[1:], pN[None]], axis=0)
    ET = jnp.swapaxes(jnp.concatenate([problem.B, problem.A], axis=-1), -1, -2)
    lp = h[:-1] + (ET @ (Pc + p_next)[..., None])[..., 0]
    lu = linalg.solve_lower_unrolled(Luu, lp[..., :nu, None])[..., 0]
    pv = lp[..., nu:] - (Lxu @ lu[..., None])[..., 0]
    lp = jnp.concatenate([lu, pv], axis=-1)
    return riccati.RiccatiFactors(L=L, lp=lp, LxxN=factors.LxxN, pN=pN)
