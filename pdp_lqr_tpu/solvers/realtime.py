"""Real-time single-instance conic MPC — the 1 kHz replan path.

The reference's steady-state fast path re-solves with cached factors
every ADMM iteration (``backward_without_factorization``,
lqr_solver.hpp:65-70): with (H~, rho) fixed, only *vector* work runs.
On an accelerator that vector sweep is still a length-N sequential scan
of tiny ops — latency-bound at small batch, which is exactly the regime of a
1 kHz MPC replan loop (B = 1).

Re-design: with the factorization fixed, the inner KKT
solve is a *fixed affine map* of the iteration-varying folded cost
vector hf and the initial state:

    w~  =  hf_flat @ T  +  x0 @ J  +  r          (all dense)

so we materialize (T, J, r) ONCE per factorization by pushing basis
vectors through the cached-factor vector solve (a single batched scan),
and every subsequent ADMM iteration is ONE dense (M, M) matvec
(M = (N+1) nz, e.g. 1040 for the quadrotor at N = 64) plus
elementwise projection/dual work — no per-stage scan, no tiny-matrix
ops, near-zero serial depth.  The replan loop itself is a
``lax.while_loop`` with convergence-based early exit (the batch-SIMD
paths deliberately avoid data-dependent exits; at B = 1 the exit is
pure profit).

Memory: T is M^2 floats — 4.3 MB (f32) at N = 64, 69 MB at N = 256.
This path is for short-horizon real-time MPC; use solvers.admm for
long horizons or large batches.

Accuracy: T is the exact linear map of the cached-factor solve
evaluated on basis vectors, so the iteration math is identical to
admm.solve with ``rho_update_interval >= max_iter`` up to matmul
reassociation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from pdp_lqr_tpu.config import f32_matmul_precision
from pdp_lqr_tpu.ops import projections, riccati_dense
from pdp_lqr_tpu.problem import LQRProblem, StageParams
from pdp_lqr_tpu.solvers.admm import (
    ADMMInfo,
    ADMMSettings,
    ADMMState,
    _con_mask,
    init_state,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ResolveOperator:
    """Materialized affine inner-solve: w~ = hf @ T + x0 @ J + r.

    T: (M, M) with M = (N+1) nz — linear response to the folded cost
       vector (rows index hf entries, columns index w entries).
    J: (nx, M) — response to the initial state.
    r: (M,)   — constant part (the drift c's contribution).
    rho: ()   — scalar penalty the factorization was built at (for
       caller-side staleness checks; the map itself embeds it).
    """

    T: jax.Array
    J: jax.Array
    r: jax.Array
    rho: jax.Array

    # Operator protocol (shared with CondensedOperator): prepare(x0)
    # once per replan, apply_flat(hf_flat, prepared) per ADMM iteration.
    def prepare(self, x0):
        return x0 @ self.J + self.r

    def apply_flat(self, hf_flat, prepared):
        return hf_flat @ self.T + prepared


@f32_matmul_precision
def build_operator(
    problem: LQRProblem,
    rho: float,
    settings: ADMMSettings = ADMMSettings(),
    cones: Sequence[projections.ConeSpec] = (),
) -> ResolveOperator:
    """Factor once, then materialize the affine solve map.

    One P-form backward (riccati_dense.backward) builds the factor
    cache; M + nx + 1 cached-factor vector solves — batched through one
    vmapped scan — evaluate the map on the hf basis, the x0 basis, and
    zero.  Rebuild whenever rho (or the problem matrices) change; between
    rebuilds every replan and every ADMM iteration reuses (T, J, r).
    """
    dt = problem.H.dtype
    N, nz, nx, nu = problem.N, problem.nz, problem.nx, problem.nu
    M = (N + 1) * nz
    sigma = settings.sigma
    mask = _con_mask(problem, tuple(cones)).astype(dt)
    rho_vec = jnp.asarray(rho, dt) * mask

    eye_z = jnp.eye(nz, dtype=dt)
    zero_g = jnp.zeros(problem.e_lb.shape, dt)
    params0 = StageParams(
        H=problem.H + sigma * eye_z, h=jnp.zeros_like(problem.h), g=zero_g
    )
    factors = riccati_dense.backward(problem, params0, rho_vec)

    prob_c0 = dataclasses.replace(problem, c=jnp.zeros_like(problem.c))

    def resolve(hvec, x0v, prob):
        prm = StageParams(H=params0.H, h=hvec, g=zero_g)
        f2 = riccati_dense.backward_no_refactor(prob, prm, rho_vec, factors)
        return riccati_dense.forward(prob, f2, x0v)

    basis_h = jnp.eye(M, dtype=dt).reshape(M, N + 1, nz)
    zero_h = jnp.zeros((N + 1, nz), dt)
    zero_x = jnp.zeros((nx,), dt)

    r = resolve(zero_h, zero_x, problem).reshape(M)
    cols_T = jax.vmap(lambda hv: resolve(hv, zero_x, prob_c0))(basis_h)
    cols_J = jax.vmap(lambda xv: resolve(zero_h, xv, prob_c0))(
        jnp.eye(nx, dtype=dt)
    )
    # resolve() is affine with constant part r|_{c=0} = 0 (prob_c0 has
    # c = 0 AND h = 0 AND x0 = 0 gives the zero trajectory), so the
    # vmapped evaluations ARE the linear columns directly.
    T = cols_T.reshape(M, M)
    J = cols_J.reshape(nx, M)
    return ResolveOperator(T=T, J=J, r=r, rho=jnp.asarray(rho, dt))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CondensedOperator:
    """PDP-factored affine inner-solve — the long-horizon 1 kHz form.

    The dense (M, M) map T costs O(M^2) memory/bandwidth; at N = 256
    that alone blows the 1 ms replan budget.  This operator factors T
    through the paper's segment decomposition (the reference's
    LQRParallelSolver structure, lqr_solver_parallel.hpp:142-238,
    recast as an OPERATOR): split the horizon into S segments of Ns
    stages.  Given the per-factorization (rho-dependent, iterate-
    independent) global Riccati cache, the solution inside segment s is
    affine in ONLY (hf^(s), x_start_s, p_end_s) — the segment-local
    folded cost rows, the state entering the segment, and the
    cost-to-go *vector* at its end boundary (the matrix P at the
    boundary is cached).  The 2 S nx boundary values are themselves
    affine in (hf, x0), composed at build time from per-segment chain
    maps.  Memory/bandwidth drop from M^2 to ~M^2/S + 2 M S nx
    (minimized at S ~ sqrt(M / 2nx)), which holds the 1 kHz budget to
    N ~ 512 (BASELINE.md).

    Blocks (Ms = Ns*nz, out = Ms + nx; segment outputs are the
    segment's w rows plus its exit state, whose last instance is x_N):
      U (S, Ms, out)   response to segment-local hf rows
      X (S, nx, out)   response to the segment entry state
      Z (S, nx, out)   response to the boundary cost-to-go vector
      r (S, out)       drift (c) constant
      E_x, E_p (S, M, nx)  boundary responses to the full hf
      Jx (S, nx, nx)       boundary response to x0
      cx, cp (S, nx)       boundary constants
    """

    U: jax.Array
    X: jax.Array
    Z: jax.Array
    r: jax.Array
    E_x: jax.Array
    E_p: jax.Array
    Jx: jax.Array
    cx: jax.Array
    cp: jax.Array
    rho: jax.Array

    def prepare(self, x0):
        """Per-replan constants: x0's boundary contribution."""
        return jnp.einsum("n,snm->sm", x0, self.Jx) + self.cx

    def apply_flat(self, hf_flat, prepared):
        S, Ms, _ = self.U.shape
        nx = self.X.shape[1]
        seg_h = hf_flat[: S * Ms].reshape(S, Ms)
        x_start = jnp.einsum("m,smn->sn", hf_flat, self.E_x) + prepared
        p_end = jnp.einsum("m,smn->sn", hf_flat, self.E_p) + self.cp
        seg_out = (
            jnp.einsum("si,sio->so", seg_h, self.U)
            + jnp.einsum("sn,sno->so", x_start, self.X)
            + jnp.einsum("sn,sno->so", p_end, self.Z)
            + self.r
        )
        w_stages = seg_out[:, :Ms].reshape(-1)
        xN = seg_out[-1, Ms:]
        nu = hf_flat.shape[0] - S * Ms - nx  # terminal row = [0_u; xN]
        return jnp.concatenate(
            [w_stages, jnp.zeros((nu,), w_stages.dtype), xN]
        )


@f32_matmul_precision
def build_condensed_operator(
    problem: LQRProblem,
    rho: float,
    num_segments: int,
    settings: ADMMSettings = ADMMSettings(),
    cones: Sequence[projections.ConeSpec] = (),
) -> CondensedOperator:
    """Factor once, materialize the SEGMENT-FACTORED solve map.

    One global P-form backward builds the (iterate-independent) factor
    cache; per-segment basis pushes of length Ns — vmapped over
    (segment, basis) — materialize the local maps, and trace-time chain
    composition produces the boundary responses.  Exactly the same
    affine map as ``build_operator`` up to float reassociation
    (pinned by tests/test_realtime.py).
    """
    dt = problem.H.dtype
    N, nz, nx, nu = problem.N, problem.nz, problem.nx, problem.nu
    S = int(num_segments)
    if N % S != 0:
        raise ValueError(f"num_segments {S} must divide N {N}")
    Ns = N // S
    Ms = Ns * nz
    M = (N + 1) * nz
    sigma = settings.sigma
    mask = _con_mask(problem, tuple(cones)).astype(dt)
    rho_vec = jnp.asarray(rho, dt) * mask

    eye_z = jnp.eye(nz, dtype=dt)
    zero_g = jnp.zeros(problem.e_lb.shape, dt)
    params0 = StageParams(
        H=problem.H + sigma * eye_z, h=jnp.zeros_like(problem.h), g=zero_g
    )
    factors = riccati_dense.backward(problem, params0, rho_vec)

    from pdp_lqr_tpu.ops import linalg

    # Segment-stacked stage data / cached factors: (S, Ns, ...).
    seg = lambda x: x.reshape((S, Ns) + x.shape[1:])
    A_s, B_s, c_s = seg(problem.A), seg(problem.B), seg(problem.c)
    K_s, Lh_s = seg(factors.K), seg(factors.Lhuu)
    Pn_s = seg(factors.P[1:])           # P_{k+1} per stage
    cz_s = jnp.zeros_like(c_s)

    def seg_resolve(A, B, c, K, Lh, Pn, h_seg, p_end, x_start):
        """Segment-local cached-factor solve (riccati_dense math on a
        slice, with the boundary cost-to-go vector as the carry seed).

        Returns (w rows (Ns, nz), exit state, entry cost-to-go vector).
        """
        r = h_seg[:, :nu]
        q = h_seg[:, nu:]

        def bstep(p_next, stage):
            A_, B_, c_, K_, Lh_, P_, rk, qk = stage
            Pcp = P_ @ c_ + p_next
            rbar = rk + B_.T @ Pcp
            d = -linalg.chol_solve_unrolled(Lh_, rbar[..., None])[..., 0]
            p = qk + A_.T @ Pcp + K_.T @ rbar
            return p, d

        p_start, d = jax.lax.scan(
            bstep, p_end, (A, B, c, K, Lh, Pn, r, q), reverse=True
        )

        def fstep(x, stage):
            A_, B_, c_, K_, d_ = stage
            u = K_ @ x + d_
            return A_ @ x + B_ @ u + c_, jnp.concatenate([u, x])

        x_end, wrows = jax.lax.scan(fstep, x_start, (A, B, c, K, d))
        return wrows, x_end, p_start

    zh = jnp.zeros((Ns, nz), dt)
    zx = jnp.zeros((nx,), dt)
    bh = jnp.eye(Ms, dtype=dt).reshape(Ms, Ns, nz)
    bx = jnp.eye(nx, dtype=dt)

    # vmap over basis (inner) and segments (outer); basis pushes use
    # c = 0 so the outputs ARE the linear responses.
    def over_segments(fn, *basis):
        return jax.vmap(
            lambda A, B, c, K, Lh, Pn: jax.vmap(
                lambda *bs: fn(A, B, c, K, Lh, Pn, *bs)
            )(*basis)
        )(A_s, B_s, cz_s, K_s, Lh_s, Pn_s)

    U_w, Ux, Up = over_segments(
        lambda *a: seg_resolve(*a[:6], a[6], zx, zx), bh
    )
    Z_w, Zx, Gp = over_segments(
        lambda *a: seg_resolve(*a[:6], zh, a[6], zx), bx
    )
    X_w, Xx, _ = over_segments(
        lambda *a: seg_resolve(*a[:6], zh, zx, a[6]), bx
    )
    r_w, rx, rp = jax.vmap(
        lambda A, B, c, K, Lh, Pn: seg_resolve(A, B, c, K, Lh, Pn, zh,
                                               zx, zx)
    )(A_s, B_s, c_s, K_s, Lh_s, Pn_s)

    out = Ms + nx
    U = jnp.concatenate([U_w.reshape(S, Ms, Ms), Ux], axis=-1)
    Z = jnp.concatenate([Z_w.reshape(S, nx, Ms), Zx], axis=-1)
    X = jnp.concatenate([X_w.reshape(S, nx, Ms), Xx], axis=-1)
    r_op = jnp.concatenate([r_w.reshape(S, Ms), rx], axis=-1)
    assert U.shape == (S, Ms, out)

    # ---- boundary chains (trace-time composition; S is static) ----
    # p_end_{S-1} = hf_N x-rows (the iterate-folded terminal pN).
    Pe = [None] * S
    ce = [None] * S
    sel_term = jnp.zeros((M, nx), dt).at[
        N * nz + nu : N * nz + nz
    ].set(jnp.eye(nx, dtype=dt))
    Pe[S - 1] = sel_term
    ce[S - 1] = jnp.zeros((nx,), dt)
    for s in range(S - 1, 0, -1):
        # p_end_{s-1} = p_start_s = hf^(s) Up_s + p_end_s Gp_s + rp_s
        prev = Pe[s] @ Gp[s]
        prev = prev.at[s * Ms : (s + 1) * Ms].add(Up[s])
        Pe[s - 1] = prev
        ce[s - 1] = ce[s] @ Gp[s] + rp[s]

    Xs = [None] * S
    Jx = [None] * S
    cx = [None] * S
    Xs[0] = jnp.zeros((M, nx), dt)
    Jx[0] = jnp.eye(nx, dtype=dt)
    cx[0] = jnp.zeros((nx,), dt)
    for s in range(S - 1):
        # x_start_{s+1} = x_end_s
        #   = hf^(s) Ux_s + x_start_s Xx_s + p_end_s Zx_s + rx_s
        nxt = Xs[s] @ Xx[s] + Pe[s] @ Zx[s]
        nxt = nxt.at[s * Ms : (s + 1) * Ms].add(Ux[s])
        Xs[s + 1] = nxt
        Jx[s + 1] = Jx[s] @ Xx[s]
        cx[s + 1] = cx[s] @ Xx[s] + ce[s] @ Zx[s] + rx[s]

    return CondensedOperator(
        U=U, X=X, Z=Z, r=r_op,
        E_x=jnp.stack(Xs), E_p=jnp.stack(Pe),
        Jx=jnp.stack(Jx), cx=jnp.stack(cx), cp=jnp.stack(ce),
        rho=jnp.asarray(rho, dt),
    )


@f32_matmul_precision
def solve(
    problem: LQRProblem,
    x0,
    operator: ResolveOperator,
    cones: Sequence[projections.ConeSpec] = (),
    settings: ADMMSettings = ADMMSettings(),
    state: Optional[ADMMState] = None,
    soc_shift=None,
) -> Tuple[jax.Array, ADMMState, ADMMInfo]:
    """One warm replan: while_loop ADMM with early exit, matvec solves.

    rho is FIXED at operator.rho for the whole replan (a rho change
    invalidates T — rebuild with build_operator between replans; the
    reference pays the same cost as a full refactorization,
    lqr_kernel.hpp:93-101).  Exact OSQP 3.4 residuals drive the exit.

    Returns (ws (N+1, nz), warm state, info).
    """
    cones = tuple(cones)
    dt = problem.H.dtype
    N, nz, nu, nc = problem.N, problem.nz, problem.nu, problem.nc
    M = (N + 1) * nz
    sigma = settings.sigma
    alpha = settings.alpha
    mask = _con_mask(problem, cones).astype(dt)
    rho = jnp.asarray(operator.rho, dt)
    rho_vec = rho * mask
    inv_rho = jnp.where(mask > 0, 1.0 / rho, 0.0)

    if state is None:
        state = init_state(problem, settings)

    # Terminal-u masking of h~ (make_stage_params semantics).
    uterm = jnp.ones((N + 1, nz), dt).at[-1, :nu].set(0.0)
    h_masked = problem.h * uterm
    x0 = jnp.asarray(x0, dt)
    base = operator.prepare(x0)                  # per-replan constant

    Dw = lambda w: jnp.einsum("kcz,kz->kc", problem.D, w)
    DTv = lambda vc: jnp.einsum("kcz,kc->kz", problem.D, vc)
    Hw = lambda w: jnp.einsum("kij,kj->ki", problem.H, w)
    h_scale = jnp.max(jnp.abs(problem.h))

    def body(carry):
        w, z, y, k, _, _, _ = carry
        g = z - inv_rho * y
        hf = (h_masked - sigma * w - DTv(rho_vec * g)) * uterm
        w_t = operator.apply_flat(hf.reshape(M), base).reshape(N + 1, nz)
        z_t = Dw(w_t)

        w_new = alpha * w_t + (1.0 - alpha) * w
        v = alpha * z_t + (1.0 - alpha) * z + inv_rho * y
        z_new = projections.project_constraints(
            v, problem.e_lb, problem.e_ub, cones, soc_shift
        ) * mask
        y_new = y + rho_vec * (alpha * z_t + (1.0 - alpha) * z - z_new)

        r_prim = jnp.max(jnp.abs((Dw(w_new) - z_new) * mask))
        dw = w - w_t
        dvec = (
            (1.0 - alpha) * Hw(dw) + sigma * dw
            + DTv(rho_vec * ((alpha - 1.0) * (z_t - z) + (z - z_new)))
        )
        r_dual = jnp.max(jnp.abs(dvec))

        prim_scale = jnp.maximum(
            jnp.max(jnp.abs(Dw(w_new) * mask)), jnp.max(jnp.abs(z_new))
        )
        dual_scale = jnp.maximum(
            jnp.max(jnp.abs(Hw(w_new))),
            jnp.maximum(jnp.max(jnp.abs(DTv(y_new))), h_scale),
        )
        conv = (r_prim <= settings.eps_abs + settings.eps_rel * prim_scale) \
            & (r_dual <= settings.eps_abs + settings.eps_rel * dual_scale)
        return (w_new, z_new, y_new, k + 1, conv, r_prim, r_dual)

    def cond(carry):
        _, _, _, k, conv, _, _ = carry
        return (k < settings.max_iter) & jnp.logical_not(conv)

    carry0 = (
        state.w, state.z, state.y, jnp.asarray(0, jnp.int32),
        jnp.asarray(False), jnp.asarray(jnp.inf, dt),
        jnp.asarray(jnp.inf, dt),
    )
    w, z, y, k, conv, r_prim, r_dual = jax.lax.while_loop(
        cond, body, carry0
    )
    info = ADMMInfo(
        iterations=k, r_prim=r_prim, r_dual=r_dual, converged=conv,
        iter_converged=k,
    )
    return w, ADMMState(w=w, z=z, y=y, rho=rho), info


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BatchResolveOperator:
    """Affine inner-solve map for a SHARED-STRUCTURE scenario batch.

    Instances share (A, B, H, D, rho) — the factorization — while
    (c, x0, bounds, warm state) vary per instance:

        w~_b = hf_b @ T + c_b @ Tc + x0_b @ J

    T  (M, M):      response to the folded cost vector (M = (N+1) nz)
    Tc (N nx, M):   response to the stacked drift c
    J  (nx, M):     response to the initial state
    rho ():         scalar penalty baked into the factorization
    """

    T: jax.Array
    Tc: jax.Array
    J: jax.Array
    rho: jax.Array


@f32_matmul_precision
def build_batch_operator(
    problem: LQRProblem,
    rho: float,
    settings: ADMMSettings = ADMMSettings(),
    cones: Sequence[projections.ConeSpec] = (),
) -> BatchResolveOperator:
    """Materialize (T, Tc, J) from ONE unbatched problem instance.

    ``problem`` supplies the shared structure; its ``c`` is ignored
    (drift enters per-instance through Tc).  M + N nx + nx cached-
    factor vector solves, batched through one vmapped scan.
    """
    dt = problem.H.dtype
    N, nz, nx = problem.N, problem.nz, problem.nx
    M = (N + 1) * nz
    sigma = settings.sigma
    mask = _con_mask(problem, tuple(cones)).astype(dt)
    rho_vec = jnp.asarray(rho, dt) * mask

    eye_z = jnp.eye(nz, dtype=dt)
    zero_g = jnp.zeros(problem.e_lb.shape, dt)
    params0 = StageParams(
        H=problem.H + sigma * eye_z, h=jnp.zeros_like(problem.h), g=zero_g
    )
    factors = riccati_dense.backward(problem, params0, rho_vec)

    def resolve(hvec, x0v, cvec):
        prob = dataclasses.replace(problem, c=cvec)
        prm = StageParams(H=params0.H, h=hvec, g=zero_g)
        f2 = riccati_dense.backward_no_refactor(prob, prm, rho_vec, factors)
        return riccati_dense.forward(prob, f2, x0v)

    zero_h = jnp.zeros((N + 1, nz), dt)
    zero_x = jnp.zeros((nx,), dt)
    zero_c = jnp.zeros((N, nx), dt)

    T = jax.vmap(
        lambda hv: resolve(hv, zero_x, zero_c)
    )(jnp.eye(M, dtype=dt).reshape(M, N + 1, nz)).reshape(M, M)
    Tc = jax.vmap(
        lambda cv: resolve(zero_h, zero_x, cv)
    )(jnp.eye(N * nx, dtype=dt).reshape(N * nx, N, nx)).reshape(N * nx, M)
    J = jax.vmap(
        lambda xv: resolve(zero_h, xv, zero_c)
    )(jnp.eye(nx, dtype=dt)).reshape(nx, M)
    return BatchResolveOperator(T=T, Tc=Tc, J=J,
                                rho=jnp.asarray(rho, dt))


@f32_matmul_precision
def solve_batch(
    problem: LQRProblem,
    x0,
    operator: BatchResolveOperator,
    cones: Sequence[projections.ConeSpec] = (),
    settings: ADMMSettings = ADMMSettings(),
    state: Optional[ADMMState] = None,
    soc_shift=None,
):
    """Operator-mode batched conic ADMM — dense matmuls, no scans.

    ``problem`` is BATCHED (leading axis B); every instance must share
    the operator's (A, B, H, D) and rho — c, x0, bounds, and warm
    state vary freely (the scenario-MPC serving shape).  Per iteration
    the whole batch solves with (B, M) @ (M, M) matmuls; projections
    and duals are batched elementwise; runs exactly ``max_iter``
    iterations (SIMD batch semantics, like admm.solve_fused) with
    per-instance convergence tracked in the returned info.

    O(M^2) per solve vs the Riccati sweeps' O(N): the win is for short
    horizons, where the scan's serial depth dominates; at long
    horizons the sweeps win (where the crossover lies on the GPU is
    not measured).

    Returns (ws (B, N+1, nz), ADMMState (batched), ADMMInfo (batched)).
    """
    cones = tuple(cones)
    dt = problem.H.dtype
    Bb = problem.h.shape[0]
    N, nz, nu, nc, nx = (problem.N, problem.nz, problem.nu, problem.nc,
                         problem.nx)
    M = (N + 1) * nz
    sigma = settings.sigma
    alpha = settings.alpha
    mask = _con_mask(problem, cones).astype(dt)          # (B, N+1, nc)
    rho = jnp.asarray(operator.rho, dt)
    rho_vec = rho * mask
    inv_rho = jnp.where(mask > 0, 1.0 / rho, 0.0)

    if state is None:
        state = ADMMState(
            w=jnp.zeros(problem.h.shape, dt),
            z=jnp.zeros(problem.e_lb.shape, dt),
            y=jnp.zeros(problem.e_lb.shape, dt),
            rho=jnp.full((Bb,), rho, dt),
        )

    uterm = jnp.ones((N + 1, nz), dt).at[-1, :nu].set(0.0)
    h_masked = problem.h * uterm
    base = (jnp.asarray(x0, dt) @ operator.J
            + problem.c.reshape(Bb, N * nx) @ operator.Tc)   # (B, M)

    Dw = lambda w: jnp.einsum("bkcz,bkz->bkc", problem.D, w)
    DTv = lambda vc: jnp.einsum("bkcz,bkc->bkz", problem.D, vc)
    Hw = lambda w: jnp.einsum("bkij,bkj->bki", problem.H, w)
    h_scale = jnp.max(jnp.abs(problem.h), axis=(1, 2))
    shift = None if soc_shift is None else jnp.asarray(soc_shift, dt)

    def project(v):
        out = jnp.clip(v, problem.e_lb, problem.e_ub)
        for off, dim, kind in projections.normalize_cones(cones):
            blk = v[..., off:off + dim]
            if shift is not None:
                s = shift[..., off:off + dim]
                blk = projections.project_cone(blk + s, kind, axis=-1) - s
            else:
                blk = projections.project_cone(blk, kind, axis=-1)
            out = out.at[..., off:off + dim].set(blk)
        return out

    def iteration(carry, _):
        w, z, y, stats = carry
        k_it, iter_conv, _, _, _ = stats
        g = z - inv_rho * y
        hf = (h_masked - sigma * w - DTv(rho_vec * g)) * uterm
        w_t = (hf.reshape(Bb, M) @ operator.T + base).reshape(
            Bb, N + 1, nz)
        z_t = Dw(w_t)

        w_new = alpha * w_t + (1.0 - alpha) * w
        v = alpha * z_t + (1.0 - alpha) * z + inv_rho * y
        z_new = project(v) * mask
        y_new = y + rho_vec * (alpha * z_t + (1.0 - alpha) * z - z_new)

        am = lambda x: jnp.max(jnp.abs(x), axis=(1, 2))
        r_prim = am((Dw(w_new) - z_new) * mask)
        dw = w - w_t
        dvec = ((1.0 - alpha) * Hw(dw) + sigma * dw
                + DTv(rho_vec * ((alpha - 1.0) * (z_t - z)
                                 + (z - z_new))))
        r_dual = am(dvec)
        prim_scale = jnp.maximum(am(Dw(w_new) * mask), am(z_new))
        dual_scale = jnp.maximum(
            am(Hw(w_new)), jnp.maximum(am(DTv(y_new)), h_scale))
        conv = (r_prim <= settings.eps_abs
                + settings.eps_rel * prim_scale) \
            & (r_dual <= settings.eps_abs
               + settings.eps_rel * dual_scale)
        k_next = k_it + 1
        iter_conv = jnp.where(conv & (iter_conv < 0), k_next, iter_conv)
        return (w_new, z_new, y_new,
                (k_next, iter_conv, r_prim, r_dual, conv)), None

    stats0 = (
        jnp.asarray(0, jnp.int32), jnp.full((Bb,), -1, jnp.int32),
        jnp.full((Bb,), jnp.inf, dt), jnp.full((Bb,), jnp.inf, dt),
        jnp.zeros((Bb,), bool),
    )
    (w, z, y, stats), _ = jax.lax.scan(
        iteration, (state.w, state.z, state.y, stats0), None,
        length=settings.max_iter)
    k_it, iter_conv, r_prim, r_dual, conv = stats
    info = ADMMInfo(
        iterations=jnp.full((Bb,), k_it), r_prim=r_prim, r_dual=r_dual,
        converged=conv,
        iter_converged=jnp.where(iter_conv < 0, k_it, iter_conv),
    )
    st = ADMMState(w=w, z=z, y=y, rho=jnp.full((Bb,), rho, dt))
    return w, st, info


def cast_operator(op, dtype):
    """Narrow the materialized map's storage (bf16 serving mode).

    The replan iteration is HBM-bound on streaming the operator blocks
    (U/E_x/E_p for the condensed form, T for the dense form); bf16
    storage halves that stream.  The inner solve becomes a CONSISTENT
    perturbed linear map (~1e-3 relative — the iteration still
    contracts, the fixed point moves O(1e-3)); use at MPC serving
    tolerances, not for tight-eps solves.  rho (scalar) stays exact.
    """
    return jax.tree.map(
        lambda x: x.astype(dtype) if getattr(x, "ndim", 0) >= 2 else x,
        op,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class OperatorLadder:
    """Pre-factored operators at a static rho grid — adaptive rho for
    the realtime loop.

    A rho change invalidates the materialized map (same cost as the
    reference's full refactorization, lqr_kernel.hpp:93-101), which the
    1 kHz loop cannot afford inline.  Instead, factor ONCE at R rho
    rungs (vmapped build), keep the stack on-device, and let each
    replan (a) solve on its current rung — XLA's dynamic-slice reads
    only the selected operator from HBM — and (b) emit the OSQP 5.2
    residual-imbalance suggestion for the NEXT replan's rung.  rho
    then adapts between ticks at zero rebuild cost.

    ops: any operator pytree (ResolveOperator / CondensedOperator /
    BatchResolveOperator) stacked on a leading rung axis.
    """

    rhos: jax.Array        # (R,) ascending rho rungs
    ops: object            # stacked operator pytree, leading axis R

    def select(self, idx):
        return jax.tree.map(lambda x: x[idx], self.ops)


def build_ladder(
    problem: LQRProblem,
    rhos,
    settings: ADMMSettings = ADMMSettings(),
    cones: Sequence[projections.ConeSpec] = (),
    num_segments: Optional[int] = None,
) -> OperatorLadder:
    """vmap-build operators at each rho rung (condensed when
    ``num_segments`` is given, dense otherwise)."""
    cones = tuple(cones)
    rhos = jnp.sort(jnp.asarray(rhos, problem.H.dtype))
    if num_segments is not None:
        build = lambda r: build_condensed_operator(
            problem, r, num_segments, settings, cones
        )
    else:
        build = lambda r: build_operator(problem, r, settings, cones)
    return OperatorLadder(rhos=rhos, ops=jax.vmap(build)(rhos))


def replan_ladder_fn(
    problem: LQRProblem,
    ladder: OperatorLadder,
    cones: Sequence[projections.ConeSpec] = (),
    settings: ADMMSettings = ADMMSettings(),
    soc_shift=None,
):
    """Jitted (x0, state, idx) -> (ws, state, info, idx_next).

    Solves on rung ``idx`` and suggests the next replan's rung from the
    final scale-normalized residual imbalance (OSQP 5.2, the same rule
    the batch paths apply inline): move only on a >5x imbalance, to the
    rung nearest rho * sqrt(rel_prim / rel_dual) in log space.  y/z
    warm states carry over unchanged (they are unscaled duals/slacks).
    """
    cones = tuple(cones)
    dt = problem.H.dtype
    mask = _con_mask(problem, cones).astype(dt)
    h_scale = jnp.max(jnp.abs(problem.h))
    tiny = jnp.asarray(1e-12, dt)

    def fn(x0, state, idx):
        op = ladder.select(idx)
        state = dataclasses.replace(state, rho=ladder.rhos[idx])
        ws, st, info = solve(
            problem, x0, op, cones, settings, state, soc_shift
        )
        # Post-hoc residual scales from the final iterate (the same
        # quantities solve() used for its exit test).
        Dw = jnp.einsum("kcz,kz->kc", problem.D, st.w) * mask
        prim_scale = jnp.maximum(
            jnp.max(jnp.abs(Dw)), jnp.max(jnp.abs(st.z))
        )
        Hw = jnp.einsum("kij,kj->ki", problem.H, st.w)
        DTy = jnp.einsum("kcz,kc->kz", problem.D, st.y)
        dual_scale = jnp.maximum(
            jnp.max(jnp.abs(Hw)), jnp.maximum(jnp.max(jnp.abs(DTy)),
                                              h_scale)
        )
        rp_rel = info.r_prim / jnp.maximum(prim_scale, tiny)
        rd_rel = info.r_dual / jnp.maximum(dual_scale, tiny)
        ratio = jnp.sqrt(
            jnp.maximum(rp_rel, tiny) / jnp.maximum(rd_rel, tiny)
        )
        rho_t = jnp.clip(
            ladder.rhos[idx] * ratio, settings.rho_min, settings.rho_max
        )
        nearest = jnp.argmin(
            jnp.abs(jnp.log(ladder.rhos) - jnp.log(rho_t))
        ).astype(jnp.int32)
        upd = (ratio > 5.0) | (ratio < 0.2)
        idx_next = jnp.where(upd, nearest, idx)
        st = dataclasses.replace(st, rho=ladder.rhos[idx_next])
        return ws, st, info, idx_next

    return jax.jit(fn)


def replan_fn(
    problem: LQRProblem,
    operator: ResolveOperator,
    cones: Sequence[projections.ConeSpec] = (),
    settings: ADMMSettings = ADMMSettings(),
    soc_shift=None,
):
    """Jitted (x0, state) -> (ws, state, info) closure for the MPC loop.

    One trace covers every replan tick (x0/state are the only moving
    inputs), which is what keeps the while_loop path at microseconds.
    """
    cones = tuple(cones)

    def fn(x0, state):
        return solve(
            problem, x0, operator, cones, settings, state, soc_shift
        )

    return jax.jit(fn)
