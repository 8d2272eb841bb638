"""Conic ADMM (OSQP-style) outer loop — completing the reference.

The reference library only ships the ADMM *inner* KKT solve, explicitly
parameterized by iterates (ws, ys, zs, rho_vecs — lqr_solver.hpp:15-22)
of an outer loop it does not include ("The full code will be released
soon", README.md:8; bounds e_lb/e_ub are stored but never read by any
solver, lqr_model.hpp:22-24).  This module supplies that loop, built
exactly on the interface the reference defines:

  x-update   backend solve with StageParams(w, y, z, rho, sigma)
             (update_problem_data semantics, lqr_solver.hpp:41-56);
             dynamics are inside the solve, so they are satisfied
             exactly at every iterate.
  z-update   projection of the relaxed constraint values onto
             box x second-order cones (the "conic" in the title).
  y-update   scaled dual ascent.
  rho        adaptive penalty with the OSQP residual-balancing rule;
             a rho change triggers matrix refactorization, otherwise
             iterations ride the reference's without_factorization
             fast path (lqr_solver.hpp:65-70).

Shape of the loop: refactor-solves happen on a fixed cadence
(``rho_update_interval``) so control flow is identical across a
vmapped batch — no data-dependent branching, no host sync; convergence
is tracked per instance as a mask, and iterations between refactors
run as one ``lax.scan``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from pdp_lqr_tpu.config import f32_matmul_precision
from pdp_lqr_tpu.ops import projections
from pdp_lqr_tpu.problem import ADMMIterates, LQRProblem


@dataclasses.dataclass(frozen=True)
class ADMMSettings:
    """Static outer-loop knobs (hashable; safe under jit closure).

    sigma/rho defaults follow the reference example (lqr_example.cpp:170-171);
    alpha/adaptive-rho bounds follow OSQP defaults.
    """

    sigma: float = 1e-6
    rho: float = 0.1
    alpha: float = 1.6
    max_iter: int = 250
    rho_update_interval: int = 25
    adaptive_rho: bool = True
    rho_min: float = 1e-6
    rho_max: float = 1e6
    eps_abs: float = 1e-6
    eps_rel: float = 1e-6
    exact_dual: bool = True       # OSQP 3.4 dual residual vs cheap proxy
    rho_eq_boost: float = 1e3     # per-row rho: equality rows
    #   (e_lb == e_ub, finite) run at rho * boost (OSQP 5.2's rho_eq)
    #   — the rho_vecs interface the reference's inner step takes
    #   (lqr_solver.hpp:15-22), driven for real by the outer loop.
    #   1.0 disables.
    uniform_rho: bool = False     # solve_fused: adapt ONE shared rho
    #   for the whole batch from the max-over-batch residual imbalance
    #   instead of per-instance rho.  Trades per-instance adaptivity
    #   for batch-shared factors: with a shared model and
    #   cached_factors, one copy of (K, P, L) serves the whole batch.
    cached_factors: bool = False  # solve_fused: reuse
    #   the per-stage (K, P, chol(Huu)) factors across iterations
    #   while rho is unchanged and run the vector-only backward sweep
    #   (the reference's backward_without_factorization,
    #   lqr_solver.hpp:65-70) — refactors automatically when any
    #   instance's rho moves.  Costs ~(2 nx^2 + nu nx + nu^2) N B words
    #   of HBM for the factor carry.
    rho_ladder: tuple = ()        # solve_fused: static rho rung grid
    #   (e.g. (0.01, 0.1, 1.0, 10.0)).  Each instance's rho starts on
    #   and adapts to the nearest rung (log space) on the OSQP
    #   imbalance rule — per-instance adaptive rho on a fixed set of
    #   values.  Excludes uniform_rho.
    early_exit: bool = False      # solve_fused: stop when EVERY batch
    #   instance converges (lax.while_loop instead of the fixed-trip
    #   scan).  Big win for warm-started serving batches; keep False
    #   for fixed-cost real-time ticks and for paths with collectives
    #   inside the loop (admm_sharded's time sharding ignores it —
    #   divergent trip counts across shards would deadlock the pmax).
    backend: str = "seq"          # seq | assoc | pdp | kkt
    num_segments: int = 4         # pdp backend only
    rho_dyn: float = 1e-6         # kkt backend only


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ADMMState:
    """Warm-startable iterate state (the reference's ws/ys/zs vectors).

    ``factors`` (solve_fused with cached_factors only) carries the
    per-stage (K, P, Huu^-1) tensors (batch-leading) plus the
    rho they were built at, so a warm-started solve skips even its FIRST
    refactorization while rho and the problem data are unchanged —
    the reference's steady-state MPC pattern (update_problem_data +
    backward_without_factorization + forward across replans).  Opaque:
    valid only for the same problem/batch it came from.
    """

    w: jax.Array          # (N+1, nz) primal trajectory [u; x]
    z: jax.Array          # (N+1, nc) slack
    y: jax.Array          # (N+1, nc) dual
    rho: jax.Array        # () scalar penalty (scaled by the row mask)
    factors: object = None


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ADMMInfo:
    iterations: jax.Array     # () iterations run
    r_prim: jax.Array         # () final primal residual (inf-norm)
    r_dual: jax.Array         # () final dual residual (inf-norm)
    converged: jax.Array      # () bool
    iter_converged: jax.Array # () first iteration meeting tolerance

    def __repr__(self):  # readable in example scripts
        return (
            f"ADMMInfo(iters={self.iterations}, r_prim={self.r_prim:.3e}, "
            f"r_dual={self.r_dual:.3e}, converged={self.converged})"
        )


def _backend(settings: ADMMSettings):
    name = settings.backend
    if name == "seq":
        from pdp_lqr_tpu.solvers import sequential as be

        return be.solve, be.resolve
    if name == "assoc":
        from pdp_lqr_tpu.solvers import assoc as be

        return be.solve, be.resolve
    if name == "dense":
        from pdp_lqr_tpu.solvers import dense as be

        return be.solve, be.resolve
    if name == "kkt":
        from pdp_lqr_tpu.solvers import kkt as be

        def solve(problem, it, x0, sigma):
            return be.solve(problem, it, x0, sigma, settings.rho_dyn)

        return solve, be.resolve
    if name == "pdp":
        from pdp_lqr_tpu.config import CondensedSolverType
        from pdp_lqr_tpu.solvers import pdp as be

        def solve(problem, it, x0, sigma):
            return be.solve(
                problem, it, x0, sigma, settings.num_segments,
                CondensedSolverType.CHOLESKY,
            )

        return solve, be.resolve
    raise ValueError(f"unknown backend {name!r}")


def _con_mask(problem: LQRProblem, cones: Tuple = ()):
    """(N+1, nc) rows that actually constrain.

    A row is active when its D row is nonzero, or when it belongs to a
    cone whose block has any nonzero row at that stage (a cone's t-row
    may legitimately be all-zero D with the bound carried by
    ``soc_shift``, e.g. a plain control-norm ball ||u|| <= margin).
    """
    mask = jnp.any(problem.D != 0, axis=-1)
    for off, dim, _ in projections.normalize_cones(cones):
        blk = jnp.any(mask[..., off : off + dim], axis=-1, keepdims=True)
        mask = mask.at[..., off : off + dim].set(
            jnp.broadcast_to(blk, mask[..., off : off + dim].shape)
        )
    return mask


def init_state(problem: LQRProblem, settings: ADMMSettings) -> ADMMState:
    dt = problem.H.dtype
    return ADMMState(
        w=jnp.zeros(problem.h.shape, dt),
        z=jnp.zeros(problem.e_lb.shape, dt),
        y=jnp.zeros(problem.e_lb.shape, dt),
        rho=jnp.asarray(settings.rho, dt),
    )


def solve(
    problem: LQRProblem,
    x0,
    cones: Sequence[projections.ConeSpec] = (),
    settings: ADMMSettings = ADMMSettings(),
    state: Optional[ADMMState] = None,
    soc_shift=None,
    residual_weights=None,
):
    """Solve the constrained conic LQ problem.

    Returns (ws, state, info): ws is the (N+1, nz) trajectory (dynamics
    exactly feasible; constraint feasibility to tolerance), state warm-
    starts the next solve (receding-horizon MPC), info carries residuals.

    ``cones`` is a static sequence of (row_offset, dim) SOC specs into
    the per-stage constraint block; remaining rows are boxes.
    ``soc_shift`` ((N+1, nc) or None) adds an affine offset to cone
    rows: D_k w_k + shift_k in SOC (see projections.project_constraints).
    ``residual_weights`` ((N+1, nc) prim, (N+1, nz) dual) reweight the
    residual inf-norms — utils.scaling.residual_weights supplies the
    weights that make termination act on UNSCALED residuals when the
    problem was Ruiz-equilibrated (OSQP 5.2).
    """
    cones = tuple(cones)
    if problem.nc == 0:
        be_solve, _ = _backend(settings)
        it = ADMMIterates(
            w=jnp.zeros(problem.h.shape, problem.H.dtype),
            y=jnp.zeros(problem.e_lb.shape, problem.H.dtype),
            z=jnp.zeros(problem.e_lb.shape, problem.H.dtype),
            rho=jnp.zeros(problem.e_lb.shape, problem.H.dtype),
        )
        ws, _ = be_solve(problem, it, x0, settings.sigma)
        zero = jnp.asarray(0.0, ws.dtype)
        info = ADMMInfo(
            iterations=jnp.asarray(1), r_prim=zero, r_dual=zero,
            converged=jnp.asarray(True), iter_converged=jnp.asarray(1),
        )
        return ws, state or init_state(problem, settings), info

    be_solve, be_resolve = _backend(settings)
    sigma = settings.sigma
    alpha = settings.alpha
    dt = problem.H.dtype
    mask = _con_mask(problem, cones).astype(dt)
    # Per-row rho (the reference's rho_vecs interface,
    # lqr_solver.hpp:15-22): equality rows run at rho * rho_eq_boost.
    eq = jnp.isfinite(problem.e_lb) & (problem.e_lb == problem.e_ub)
    rscale = mask * jnp.where(eq, jnp.asarray(settings.rho_eq_boost, dt),
                              jnp.asarray(1.0, dt))
    pw, dwt = (None, None) if residual_weights is None else residual_weights

    if state is None:
        state = init_state(problem, settings)

    Dw = lambda w: jnp.einsum("kcz,kz->kc", problem.D, w)

    def iteration(carry, factors, resolve: bool):
        w, z, y, rho, stats = carry
        rho_vec = rho * rscale
        it = ADMMIterates(w=w, y=y, z=z, rho=rho_vec)
        if resolve:
            w_t, factors = be_resolve(problem, it, x0, sigma, factors)
        else:
            w_t, factors = be_solve(problem, it, x0, sigma)
        z_t = Dw(w_t)

        w_new = alpha * w_t + (1.0 - alpha) * w
        inv_rho = jnp.where(
            rscale > 0, 1.0 / jnp.maximum(rho_vec, 1e-30), 0.0)
        v = alpha * z_t + (1.0 - alpha) * z + inv_rho * y
        z_new = projections.project_constraints(
            v, problem.e_lb, problem.e_ub, cones, soc_shift
        )
        # Inactive (padded) rows stay identically zero.
        z_new = z_new * mask
        y_new = y + rho_vec * (alpha * z_t + (1.0 - alpha) * z - z_new)

        # Residuals (OSQP sec. 3.4): primal on the updated pair.
        # With residual_weights these are the UNSCALED residuals of a
        # Ruiz-equilibrated problem (E^{-1} r_prim, (c S)^{-1} r_dual).
        wp_ = (lambda x: x * pw) if pw is not None else (lambda x: x)
        wd_ = (lambda x: x * dwt) if dwt is not None else (lambda x: x)
        Dw_new = Dw(w_new)
        r_prim = jnp.max(jnp.abs(wp_((Dw_new - z_new) * mask)))

        DTv = lambda vc: jnp.einsum("kcz,kc->kz", problem.D, vc)
        if settings.exact_dual:
            # Exact dual residual H w+ + h + D^T y+ + G^T lam at the
            # inner solve's dynamics dual, via the x-update stationarity
            # (H+sI)w~ + h - sw + D^T rho (D w~ - g) + G^T lam = 0:
            #   r_d = (1-a) H (w - w~) + s (w - w~)
            #         + D^T rho [ (a-1)(z~ - z) + (z - z+) ]
            # The old proxy rho max|D^T(z+ - z)| is the a=1, sigma->0
            # special case.
            dw = w - w_t
            Hdw = jnp.einsum("kij,kj->ki", problem.H, dw)
            zt_term = rho_vec * (
                (alpha - 1.0) * (z_t - z) + (z - z_new)
            )
            dvec = (1.0 - alpha) * Hdw + sigma * dw + DTv(zt_term)
            r_dual = jnp.max(jnp.abs(wd_(dvec)))
            Hw_new = jnp.einsum("kij,kj->ki", problem.H, w_new)
            dual_scale = jnp.maximum(
                jnp.max(jnp.abs(wd_(Hw_new))),
                jnp.maximum(jnp.max(jnp.abs(wd_(DTv(y_new)))),
                            jnp.max(jnp.abs(wd_(problem.h)))),
            )
        else:
            r_dual = rho * jnp.max(jnp.abs(wd_(DTv((z_new - z) * mask))))
            dual_scale = jnp.max(jnp.abs(wd_(DTv(y_new))))

        prim_scale = jnp.maximum(
            jnp.max(jnp.abs(wp_(Dw_new * mask))),
            jnp.max(jnp.abs(wp_(z_new)))
        )
        eps_prim = settings.eps_abs + settings.eps_rel * prim_scale
        eps_dual = settings.eps_abs + settings.eps_rel * dual_scale
        conv = (r_prim <= eps_prim) & (r_dual <= eps_dual)

        # Scale-normalized residuals drive the adaptive-rho rule
        # (OSQP 5.2 uses relative, not absolute, imbalance).
        tiny = jnp.asarray(1e-20, dt)
        rp_rel = r_prim / jnp.maximum(prim_scale, tiny)
        rd_rel = r_dual / jnp.maximum(dual_scale, tiny)

        k, iter_conv, _, _, _, _, _ = stats
        k = k + 1
        iter_conv = jnp.where(conv & (iter_conv < 0), k, iter_conv)
        stats = (k, iter_conv, r_prim, r_dual, conv, rp_rel, rd_rel)
        return (w_new, z_new, y_new, rho, stats), factors

    stats0 = (
        jnp.asarray(0), jnp.asarray(-1),
        jnp.asarray(jnp.inf, dt), jnp.asarray(jnp.inf, dt),
        jnp.asarray(False),
        jnp.asarray(jnp.inf, dt), jnp.asarray(jnp.inf, dt),
    )
    carry = (state.w, state.z, state.y, jnp.asarray(state.rho, dt), stats0)

    interval = max(1, settings.rho_update_interval)
    n_chunks = -(-settings.max_iter // interval)
    tail = settings.max_iter - (n_chunks - 1) * interval  # last-chunk len

    def maybe_update_rho(carry):
        """OSQP 5.2: rho <- rho sqrt(rel_prim / rel_dual), applied only
        on a >5x relative (scale-normalized) imbalance."""
        w, z, y, rho, stats = carry
        _, _, _, _, _, rp_rel, rd_rel = stats
        tiny = jnp.asarray(1e-12, dt)
        ratio = jnp.sqrt(
            jnp.maximum(rp_rel, tiny) / jnp.maximum(rd_rel, tiny)
        )
        rho_new = jnp.clip(rho * ratio, settings.rho_min, settings.rho_max)
        update = (ratio > jnp.asarray(5.0, dt)) | (
            ratio < jnp.asarray(0.2, dt)
        )
        return (w, z, y, jnp.where(update, rho_new, rho), stats)

    def run_chunk(carry, n_cheap: int):
        # Refactor iteration (rho may have changed since the factors
        # were built) + n_cheap cached-factor iterations.
        carry, factors = iteration(carry, None, resolve=False)
        if n_cheap > 0:
            def cheap(c, _):
                c, _ = iteration(c, factors, resolve=True)
                return c, None

            carry, _ = jax.lax.scan(cheap, carry, None, length=n_cheap)
        return carry

    # All full-length chunks roll through ONE lax.scan so the refactor
    # body (the expensive inner-solve trace) is compiled once, not once
    # per chunk — trace-time chunk unrolling made compiles scale with
    # max_iter / interval (minutes at 300/25 on the kkt backend).
    n_full = n_chunks - (1 if tail != interval else 0)
    if n_full > 0:
        def full_chunk(c, first):
            if settings.adaptive_rho:
                c = jax.tree.map(
                    lambda a, b: jnp.where(first, a, b),
                    c, maybe_update_rho(c),
                )
            return run_chunk(c, interval - 1), None

        firsts = jnp.arange(n_full) == 0
        carry, _ = jax.lax.scan(full_chunk, carry, firsts)
    if tail != interval:
        if settings.adaptive_rho and n_full > 0:
            carry = maybe_update_rho(carry)
        carry = run_chunk(carry, tail - 1)

    w, z, y, rho, stats = carry
    k, iter_conv, r_prim, r_dual, conv, _, _ = stats
    info = ADMMInfo(
        iterations=k, r_prim=r_prim, r_dual=r_dual, converged=conv,
        iter_converged=jnp.where(iter_conv < 0, k, iter_conv),
    )
    return w, ADMMState(w=w, z=z, y=y, rho=rho), info


@f32_matmul_precision
def solve_fused(
    problem,
    x0,
    cones: Sequence[projections.ConeSpec] = (),
    settings: ADMMSettings = ADMMSettings(),
    state: Optional[ADMMState] = None,
    soc_shift=None,
    residual_weights=None,
    sweep: Optional[str] = None,
):
    """Batch-fused conic ADMM: one loop over the batched Riccati sweeps.

    The serving path: ``problem``/``x0`` carry a leading batch axis B
    and every iteration runs ONE backward sweep and ONE rollout over the
    whole batch (ops/pallas_riccati) — no per-instance vmap — followed
    by the projection, dual and residual tail, which XLA fuses.  The
    iteration loop is a single ``lax.scan`` (or ``lax.while_loop`` with
    ``early_exit``).  Math is identical to ``solve``; rho adapts per
    instance on the usual cadence.

    A ``problem`` WITHOUT a leading batch axis (``problem.A.ndim == 3``;
    ``c`` may still be batched for per-scenario drift) is a shared
    model: its stage data stays in device memory once, with a leading
    axis of 1, while iterates, rho and x0 are per instance — one model
    serving B scenarios, the reference's ownership shape
    (lqr_model.hpp:66-89).

    ``settings.cached_factors`` reuses the per-stage factors while rho
    is unchanged and runs the vector-only sweep (lqr_solver.hpp:65-70);
    with a shared model and ``uniform_rho`` the factors are shared too.
    ``settings.rho_ladder`` snaps each instance's adapted rho to the
    nearest rung.  ``sweep`` picks the sweep implementation
    (pallas_riccati.choose_impl; None chooses by platform).

    Returns (ws (B, N+1, nz), ADMMState (batched), ADMMInfo (batched)).
    """
    from pdp_lqr_tpu.ops import pallas_riccati as pr

    cones = tuple(cones)
    sigma = settings.sigma
    alpha = settings.alpha
    dt = problem.H.dtype
    shared_mode = problem.A.ndim == 3
    x0 = jnp.asarray(x0, dt)
    Bb = x0.shape[0]
    N = problem.A.shape[-3]
    nu, nx, nc = problem.nu, problem.nx, problem.nc
    nz = nu + nx
    ladder = tuple(sorted(float(r) for r in settings.rho_ladder))
    if ladder and settings.uniform_rho:
        raise ValueError("rho_ladder IS the per-instance alternative "
                         "to uniform_rho — set one, not both")

    if nc == 0:
        it = ADMMIterates(
            w=jnp.zeros(problem.h.shape, dt),
            y=jnp.zeros(problem.e_lb.shape, dt),
            z=jnp.zeros(problem.e_lb.shape, dt),
            rho=jnp.zeros(problem.e_lb.shape, dt),
        )
        solve_fn = pr.solve_shared if shared_mode else pr.solve_batched
        ws = solve_fn(problem, it, x0, sigma, impl=sweep)
        zero = jnp.zeros((Bb,), dt)
        info = ADMMInfo(
            iterations=jnp.ones((Bb,), jnp.int32), r_prim=zero, r_dual=zero,
            converged=jnp.ones((Bb,), bool),
            iter_converged=jnp.ones((Bb,), jnp.int32),
        )
        if state is None:
            state = ADMMState(
                w=jnp.zeros((Bb,) + problem.h.shape[-2:], dt),
                z=jnp.zeros((Bb,) + problem.e_lb.shape[-2:], dt),
                y=jnp.zeros((Bb,) + problem.e_lb.shape[-2:], dt),
                rho=jnp.full((Bb,), settings.rho, dt),
            )
        return ws, state, info

    # Batch-leading (W, N+1, ...) arrays; a shared tensor has W = 1 and
    # broadcasts against the per-instance iterates.
    lead = (lambda x: x[None]) if shared_mode else (lambda x: x)
    c_b = problem.c if problem.c.ndim == 3 else problem.c[None]
    A_b, B_b = lead(problem.A), lead(problem.B)
    H_b, h_b, D_b = lead(problem.H), lead(problem.h), lead(problem.D)
    lb_b, ub_b = lead(problem.e_lb), lead(problem.e_ub)
    mask = lead(_con_mask(problem, cones)).astype(dt)     # (W, N+1, nc)
    eq = lead(jnp.isfinite(problem.e_lb) & (problem.e_lb == problem.e_ub))
    rsc = mask * jnp.where(eq, jnp.asarray(settings.rho_eq_boost, dt), 1.0)
    Hs_b = H_b[:, :-1] + sigma * jnp.eye(nz, dtype=dt)
    HN_b = H_b[:, -1, nu:, nu:] + sigma * jnp.eye(nx, dtype=dt)
    DN_b = D_b[:, -1, :, nu:]                              # (W, nc, nx)
    uterm = jnp.ones((N + 1, nz), dt).at[-1, :nu].set(0.0)

    def Dw(w):                                             # (B, N+1, nc)
        return jnp.sum(D_b * w[:, :, None, :], axis=-1)

    def DTy(y):                                            # (B, N+1, nz)
        return jnp.sum(D_b * y[..., None], axis=-2)

    def Hw(w):
        """Original H w; the terminal row's u part is zero."""
        return jnp.sum(H_b * w[:, :, None, :], axis=-1) * uterm

    def project(v):
        out = jnp.clip(v, lb_b, ub_b)
        for off, dim, kind in projections.normalize_cones(cones):
            blk = v[..., off : off + dim]
            if soc_shift is not None:
                s = soc_shift[..., off : off + dim]
                blk = projections.project_cone(blk + s, kind, axis=-1) - s
            else:
                blk = projections.project_cone(blk, kind, axis=-1)
            out = out.at[..., off : off + dim].set(blk)
        return out

    def terminal_PN(rho_vec):
        """Folded terminal matrix HN + Dx^T diag(rho) Dx."""
        return HN_b + jnp.einsum("wci,wc,wcj->wij", DN_b, rho_vec[:, -1],
                                 DN_b, precision=jax.lax.Precision.HIGHEST)

    if residual_weights is not None:
        pwt, dwt = residual_weights            # (N+1, nc), (N+1, nz)
        wp_ = lambda x: x * pwt
        wd_ = lambda x: x * dwt
    else:
        wp_ = wd_ = lambda x: x
    h_absmax = jnp.broadcast_to(
        jnp.max(jnp.abs(wd_(h_b)), axis=(1, 2)), (Bb,))

    # Shared factors need ONE rho for the batch: the build reads rho[0].
    shared_fac = shared_mode and settings.uniform_rho
    fac_rho = (lambda r: r[:1]) if shared_fac else (lambda r: r)

    def build_factors(rho):
        """Matrix half of the sweep at ``rho``: (K, P, Huu^-1, rho)."""
        rho_vec = fac_rho(rho)[:, None, None] * rsc
        Wf = rho_vec.shape[0]
        zeros = lambda *s: jnp.zeros((Wf,) + s, dt)
        K, _, P, Hinv = pr.backward(
            A_b, B_b, zeros(N, nx), Hs_b, zeros(N, nz), D_b[:, :-1],
            rho_vec[:, :-1], zeros(N, nc), terminal_PN(rho_vec),
            zeros(nx), export_factors=True, impl=sweep)
        return K, P, Hinv, rho

    interval = max(1, settings.rho_update_interval)

    def iteration(carry, _):
        w, z, y, rho, stats, *fac = carry     # w (B,N+1,nz), z/y (B,N+1,nc)
        k_it, iter_conv, _, _, _ = stats
        rho_vec = rho[:, None, None] * rsc
        inv_rho = jnp.where(rsc > 0, 1.0 / jnp.maximum(rho_vec, 1e-30), 0.0)
        rg = rho_vec * (z - inv_rho * y)
        h_t = (h_b - sigma * w) * uterm
        pN = h_t[:, -1, nu:] - jnp.sum(DN_b * rg[:, -1, :, None], axis=-2)

        if settings.cached_factors:
            # The reference's steady-state fast path
            # (backward_without_factorization, lqr_solver.hpp:65-70):
            # refactor only when some instance's rho moved since the
            # factors were built (rho_f; fresh solves start at the -1
            # sentinel), then run the vector-only sweep.
            K_f, P_f, Hi_f, rho_f = fac[0]
            fac_new = jax.lax.cond(
                jnp.any(rho != rho_f), build_factors,
                lambda _: (K_f, P_f, Hi_f, rho_f), rho)
            K, P, Hinv, _ = fac_new
            fac = [fac_new]
            hf = (h_t - DTy(rg))[:, :-1]
            d = pr.backward_vectors(A_b, B_b, c_b, hf, P, K, Hinv, pN,
                                    impl=sweep)
        else:
            K, d = pr.backward(
                A_b, B_b, c_b, Hs_b, h_t[:, :-1], D_b[:, :-1],
                rho_vec[:, :-1], rg[:, :-1], terminal_PN(rho_vec), pN,
                impl=sweep)
        ws, xN = pr.forward(A_b, B_b, c_b, K, d, x0, impl=sweep)
        w_t = pr.stack_terminal(ws, xN, nu)              # (B, N+1, nz)

        z_t = Dw(w_t)
        w_new = alpha * w_t + (1.0 - alpha) * w
        z_new = project(alpha * z_t + (1.0 - alpha) * z + inv_rho * y) * mask
        y_new = y + rho_vec * (alpha * z_t + (1.0 - alpha) * z - z_new)

        Dw_new = Dw(w_new)
        amax = lambda x: jnp.max(jnp.abs(x), axis=(1, 2))   # -> (B,)
        r_prim = amax(wp_((Dw_new - z_new) * mask))
        if settings.exact_dual:
            # Same OSQP 3.4 exact dual residual as in solve() (see the
            # derivation there).
            dw = w - w_t
            zt_term = rho_vec * ((alpha - 1.0) * (z_t - z) + (z - z_new))
            dvec = (1.0 - alpha) * Hw(dw) + sigma * dw + DTy(zt_term)
            r_dual = amax(wd_(dvec))
            dual_scale = jnp.maximum(
                amax(wd_(Hw(w_new))),
                jnp.maximum(amax(wd_(DTy(y_new))), h_absmax),
            )
        else:
            r_dual = rho * amax(wd_(DTy((z_new - z) * mask)))
            dual_scale = amax(wd_(DTy(y_new)))
        prim_scale = jnp.maximum(amax(wp_(Dw_new * mask)),
                                 amax(wp_(z_new)))
        conv = (r_prim <= settings.eps_abs + settings.eps_rel * prim_scale) \
            & (r_dual <= settings.eps_abs + settings.eps_rel * dual_scale)

        k_next = k_it + 1
        iter_conv = jnp.where(conv & (iter_conv < 0), k_next, iter_conv)

        # Per-instance adaptive rho on the cadence (OSQP 5.2, relative
        # imbalance); uniform_rho adapts one rho on the batch's worst.
        if settings.adaptive_rho:
            tiny = jnp.asarray(1e-12, dt)
            rp_rel = r_prim / jnp.maximum(prim_scale, tiny)
            rd_rel = r_dual / jnp.maximum(dual_scale, tiny)
            if settings.uniform_rho:
                rp_rel = jnp.max(rp_rel)
                rd_rel = jnp.max(rd_rel)
            ratio = jnp.sqrt(
                jnp.maximum(rp_rel, tiny) / jnp.maximum(rd_rel, tiny)
            )
            upd = ((ratio > 5.0) | (ratio < 0.2)) & (k_next % interval == 0)
            target = jnp.clip(rho * ratio, settings.rho_min, settings.rho_max)
            if ladder:
                target = _snap(target, ladder)
            rho = jnp.where(upd, target, rho)

        stats = (k_next, iter_conv, r_prim, r_dual, conv)
        return (w_new, z_new, y_new, rho, stats, *fac), None

    if state is None:
        state = ADMMState(
            w=jnp.zeros((Bb,) + problem.h.shape[-2:], dt),
            z=jnp.zeros((Bb,) + problem.e_lb.shape[-2:], dt),
            y=jnp.zeros((Bb,) + problem.e_lb.shape[-2:], dt),
            rho=jnp.full((Bb,), settings.rho, dt),
        )
    stats0 = (
        jnp.asarray(0, jnp.int32),
        jnp.full((Bb,), -1, jnp.int32),
        jnp.full((Bb,), jnp.inf, dt),
        jnp.full((Bb,), jnp.inf, dt),
        jnp.zeros((Bb,), bool),
    )
    rho0 = jnp.broadcast_to(jnp.asarray(state.rho, dt), (Bb,))
    if ladder:
        rho0 = _snap(jnp.maximum(rho0, 1e-30), ladder)
    elif shared_fac and settings.cached_factors:
        # The shared factor build reads lane 0 and the max-based rule
        # only PRESERVES uniformity — collapse a per-instance warm rho
        # to the batch max (the conservative OSQP choice).
        rho0 = jnp.broadcast_to(jnp.max(rho0), (Bb,))
    carry0 = (state.w, state.z, state.y, rho0, stats0)
    if settings.cached_factors:
        if state.factors is not None:
            # Opaque, same-problem round trips only (ADMMState doc).
            K0, P0, Hi0, r0 = state.factors
            fac0 = (K0.astype(dt), P0.astype(dt), Hi0.astype(dt), r0)
        else:
            Wf = 1 if shared_fac else Bb
            zf = lambda *dims: jnp.zeros((Wf,) + dims, dt)
            fac0 = (zf(N, nu, nx), zf(N, nx, nx), zf(N, nu, nu),
                    jnp.full((Bb,), -1.0, dt))
        carry0 = carry0 + (fac0,)

    if settings.early_exit:
        def _cond(carry):
            stats = carry[4]
            return (stats[0] < settings.max_iter) & ~jnp.all(stats[4])

        out = jax.lax.while_loop(_cond, lambda c: iteration(c, None)[0],
                                 carry0)
    else:
        out, _ = jax.lax.scan(iteration, carry0, None,
                              length=settings.max_iter)
    w_b, z_b, y_b, rho, stats, *fac_out = out
    k_it, iter_conv, r_prim, r_dual, conv = stats
    info = ADMMInfo(
        iterations=jnp.full((Bb,), k_it), r_prim=r_prim, r_dual=r_dual,
        converged=conv,
        iter_converged=jnp.where(iter_conv < 0, k_it, iter_conv),
    )
    return w_b, ADMMState(
        w=w_b, z=z_b, y=y_b, rho=rho,
        factors=fac_out[0] if fac_out else None,
    ), info


def _snap(rho, ladder):
    """Snap each rho to the nearest rung of ``ladder`` in log space."""
    rungs = jnp.asarray(ladder, rho.dtype)
    idx = jnp.argmin(jnp.abs(jnp.log(rungs)[:, None]
                             - jnp.log(rho)[None, :]), axis=0)
    return rungs[idx]


def suggest_rho_ladder(
    problem,
    x0,
    cones: Sequence[projections.ConeSpec] = (),
    settings: ADMMSettings = ADMMSettings(),
    *,
    rungs: int = 4,
    probe_batch: int = 128,
    probe_iters: Optional[int] = None,
    soc_shift=None,
):
    """Pick ``rho_ladder`` rungs from the problem's own adaptive-rho
    footprint.

    Runs a short PER-INSTANCE adaptive-rho probe on a strided subsample
    of the batch through the replicated loop (the path with
    unrestricted per-instance rho), then places up to ``rungs``
    geometric rungs at the log-space quantiles of the probe's final rho
    distribution.  This replaces the hand-picked geometric grids of
    ``ADMMSettings.rho_ladder`` with a data-driven rung set: rungs sit
    where the OSQP sec-5.2 imbalance rule actually sends instances for
    THIS problem / scenario distribution, so snapping to rungs loses
    little vs free per-instance adaptation.  The probe is a host-side
    one-off (serving setup time, not the hot loop) of ``probe_batch``
    instances.

    Shared-mode problems (``problem.A.ndim == 3``; the ownership shape
    of the reference's model, lqr_model.hpp:66-89) are replicated over
    the probe subsample; batched problems are subsampled directly.
    Returns a sorted tuple of 1..``rungs`` distinct values — rungs
    closer than 10% in log space are merged.
    """
    import numpy as np

    B = int(x0.shape[0])
    idx = np.unique(np.linspace(0, B - 1,
                                min(int(probe_batch), B)).astype(int))
    x0p = jnp.asarray(x0)[idx]
    shared_mode = problem.A.ndim == 3
    if shared_mode:
        # Only ``c`` may carry a per-scenario batch axis in shared mode.
        c_batched = problem.c.ndim == 3
        base = (dataclasses.replace(problem, c=problem.c[0])
                if c_batched else problem)
        pp = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (len(idx),) + a.shape), base)
        if c_batched:
            pp = dataclasses.replace(pp, c=problem.c[idx])
    else:
        pp = jax.tree.map(lambda a: a[idx], problem)
    ps = dataclasses.replace(
        settings, adaptive_rho=True, cached_factors=False,
        uniform_rho=False, rho_ladder=(),
        max_iter=int(probe_iters if probe_iters is not None
                     else settings.max_iter))
    _, st, _ = solve_fused(pp, x0p, tuple(cones), ps,
                           soc_shift=soc_shift)
    rho = np.asarray(jax.device_get(st.rho), np.float64).ravel()
    rho = rho[np.isfinite(rho) & (rho > 0.0)]
    if rho.size == 0:  # degenerate probe: fall back to the start rho
        return (float(settings.rho),)
    logs = np.log(rho)
    R = max(1, int(rungs))
    picks = np.exp(np.quantile(logs, (np.arange(R) + 0.5) / R))
    out = []
    for r in picks:
        if not out or np.log(r) - np.log(out[-1]) > 0.1:
            out.append(float(r))
    return tuple(float(f"{r:.4g}") for r in out)


def solve_equilibrated(
    problem: LQRProblem,
    x0,
    cones: Sequence[projections.ConeSpec] = (),
    settings: ADMMSettings = ADMMSettings(),
    state: Optional[ADMMState] = None,
    soc_shift=None,
    *,
    ruiz_iters: int = 10,
):
    """Ruiz-equilibrated solve (OSQP sec. 5) of an UNBATCHED problem.

    Scales (H, h, D, bounds) by modified Ruiz equilibration + cost
    normalization (utils/scaling), pushes the variable scaling through
    the dynamics, solves the scaled problem with termination on the
    UNSCALED residuals (residual_weights), and returns unscaled
    (ws, state, info).  A problem whose rows span orders of magnitude
    converges in roughly the iterations of its well-scaled equivalent
    — OSQP's robustness mechanism, absent from the reference because
    its outer loop is unreleased (lqr_model.hpp:22-24 bounds stored
    but never read).

    ``state`` is in UNSCALED space (as returned by this function).
    """
    from pdp_lqr_tpu.utils import scaling as sc

    cones = tuple(cones)
    scal = sc.ruiz_equilibrate(problem, cones, ruiz_iters)
    sp = sc.scale_problem(problem, scal)
    sx0 = sc.scale_x0(x0, scal, problem.nu)
    ssh = sc.scale_soc_shift(soc_shift, scal)
    weights = sc.residual_weights(scal)
    sstate = None if state is None else sc.scale_state(state, scal)
    ws, st, info = solve(sp, sx0, cones, settings, sstate, ssh,
                         residual_weights=weights)
    return sc.unscale_ws(ws, scal), sc.unscale_state(st, scal), info


def solve_batched(problem, x0, cones=(), settings=ADMMSettings(), state=None,
                  soc_shift=None):
    """vmap over a leading batch axis of (problem, x0[, state]).

    ``soc_shift`` is unbatched (shared across instances) when given.
    """
    cones = tuple(cones)
    if state is None:
        fn = lambda p, x: solve(p, x, cones, settings, None, soc_shift)
        return jax.vmap(fn)(problem, x0)
    fn = lambda p, x, s: solve(p, x, cones, settings, s, soc_shift)
    return jax.vmap(fn)(problem, x0, state)
