"""Stage-stacked LQ problem model — the batched ``LQRModel``.

Reference counterpart: include/clqr/lqr_model.hpp.  The reference keeps a
``std::vector<Node>`` of per-stage Eigen matrices with ragged terminal
shapes (``Node`` at lqr_model.hpp:8-64: terminal stage has no controls).
Ragged shapes do not vectorize, so here every stage field is one
stacked array over the horizon, the terminal stage is padded to the full
``nz = nu + nx`` width, and a leading batch axis (added by ``jax.vmap``)
batches problem instances.

Per-stage data, ordered ``[u; x]`` exactly like the reference
(E = [B A], H = [R S; S^T Q], h = [r; q] — lqr_model.hpp:12-24):

  dynamics   x_{k+1} = A_k x_k + B_k u_k + c_k         k = 0..N-1
  cost       1/2 [u;x]^T H_k [u;x] + h_k^T [u;x]       k = 0..N   (terminal
             stage uses only the x-block; u-rows/cols of H[N], h[N] are 0)
  constraint e_lb <= D_k [u;x] <= e_ub                 k = 0..N   (terminal
             D[N][:, :nu] must be 0)

Variable per-stage constraint counts (reference ``ncs``,
lqr_model.hpp:71) become a single static ``nc`` with padded rows: a
padded row has D-row = 0, rho-row = 0, bounds (-inf, +inf).  Zero-rho
rows contribute nothing to the penalty fold (lqr_kernel.hpp:106-112), so
padding is exact, not approximate.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LQRProblem:
    """One constrained LQ optimal-control problem (unbatched).

    Shapes (nz = nu + nx):
      A: (N, nx, nx)    B: (N, nx, nu)    c: (N, nx)
      H: (N+1, nz, nz)  h: (N+1, nz)
      D: (N+1, nc, nz)  e_lb/e_ub: (N+1, nc)   (nc may be 0)

    Batched problems simply carry an extra leading axis on every field;
    all solvers are written for the unbatched shapes and lifted with
    ``jax.vmap``.
    """

    A: jax.Array
    B: jax.Array
    c: jax.Array
    H: jax.Array
    h: jax.Array
    D: jax.Array
    e_lb: jax.Array
    e_ub: jax.Array

    @property
    def N(self) -> int:
        return self.A.shape[-3]

    @property
    def nx(self) -> int:
        return self.A.shape[-1]

    @property
    def nu(self) -> int:
        return self.B.shape[-1]

    @property
    def nz(self) -> int:
        return self.nx + self.nu

    @property
    def nc(self) -> int:
        return self.D.shape[-2]

    @property
    def E(self) -> jax.Array:
        """Stacked dynamics matrix E = [B A], (N, nx, nz) — lqr_model.hpp:15."""
        return jnp.concatenate([self.B, self.A], axis=-1)


def build_problem(
    *,
    A,
    B,
    c,
    Q,
    R,
    q,
    r,
    S=None,
    QN=None,
    qN=None,
    D=None,
    e_lb=None,
    e_ub=None,
    DN=None,
    e_lbN=None,
    e_ubN=None,
    stage_constraints=None,
    N: Optional[int] = None,
    dtype=jnp.float64,
) -> LQRProblem:
    """Build an ``LQRProblem`` from per-stage blocks.

    Every argument can be a single (time-invariant) block or a stacked
    array with a leading horizon axis.  This plays the role of the
    reference's ``LQRModel::add_node`` loop (lqr_model.hpp:85-88) plus
    the example's block-filling (examples/lqr_example.cpp:122-168).

    Constraints come in two mutually exclusive forms:

    * ``D``/``e_lb``/``e_ub`` (+ terminal ``DN``/``e_lbN``/``e_ubN``):
      one uniform stage constraint block, optionally stacked over the
      horizon.
    * ``stage_constraints``: a length-``N`` or ``N+1`` sequence whose
      entry ``k`` is ``(D_k, e_lb_k, e_ub_k)`` or ``None``, with a
      *different* row count per stage — the reference's per-node ``ncs``
      (lqr_model.hpp:71-88).  Rows are padded internally to the max
      count with zero-D rows and infinite bounds; padded rows carry
      rho = 0 and contribute exactly nothing to the penalty fold
      (lqr_kernel.hpp:106-112), so the padding is exact.  A terminal
      entry may have ``nx`` columns (x-only, like the reference's
      terminal node) or ``nz`` columns with zero u-columns.
    """
    A = np.asarray(A, dtype=np.float64)
    if A.ndim == 2:
        if N is None:
            raise ValueError("N is required for time-invariant blocks")
        tile = lambda M, n: np.broadcast_to(M, (n,) + M.shape).copy()
        A = tile(A, N)
    else:
        N = A.shape[0]

    nx = A.shape[-1]
    if A.shape[-2] != nx:
        raise ValueError(f"A must be square per stage, got {A.shape[-2:]}")
    B = np.asarray(B, dtype=np.float64)
    if B.shape[-2] != nx:
        raise ValueError(
            f"B row count {B.shape[-2]} != state dimension {nx}"
        )
    nu = B.shape[-1]
    nz = nx + nu
    for name, blk, shape in (
        ("Q", Q, (nx, nx)), ("R", R, (nu, nu)),
    ):
        bs = np.asarray(blk).shape[-2:]
        if bs != shape:
            raise ValueError(f"{name} block shape {bs} != {shape}")
    if D is not None and np.asarray(D).shape[-1] != nz:
        raise ValueError(
            f"D must have nz = nu + nx = {nz} columns (u-first [u; x] "
            f"ordering), got {np.asarray(D).shape[-1]}"
        )

    def stack(M, shape):
        M = np.asarray(M, dtype=np.float64)
        if M.ndim == len(shape):
            return np.broadcast_to(M, (N,) + shape).copy()
        return M

    B = stack(B, (nx, nu))
    c = stack(np.zeros(nx) if c is None else c, (nx,))
    Q = stack(Q, (nx, nx))
    R = stack(R, (nu, nu))
    S_ = stack(np.zeros((nu, nx)) if S is None else S, (nu, nx))
    q = stack(q, (nx,))
    r = stack(np.zeros(nu) if r is None else r, (nu,))

    H = np.zeros((N + 1, nz, nz))
    h = np.zeros((N + 1, nz))
    H[:N, :nu, :nu] = R
    H[:N, nu:, nu:] = Q
    H[:N, :nu, nu:] = S_
    H[:N, nu:, :nu] = np.swapaxes(S_, -1, -2)
    h[:N, :nu] = r
    h[:N, nu:] = q
    H[N, nu:, nu:] = Q[-1] if QN is None else np.asarray(QN, dtype=np.float64)
    h[N, nu:] = q[-1] if qN is None else np.asarray(qN, dtype=np.float64)

    if stage_constraints is not None:
        if D is not None or DN is not None:
            raise ValueError(
                "stage_constraints is mutually exclusive with D/DN"
            )
        entries = list(stage_constraints)
        if len(entries) == N:
            entries.append(None)  # no terminal constraints
        if len(entries) != N + 1:
            raise ValueError(
                f"stage_constraints must have N={N} or N+1={N + 1} "
                f"entries, got {len(entries)}"
            )
        ncs = [0 if e is None else np.asarray(e[0]).shape[0]
               for e in entries]
        nc = max(ncs, default=0)
        Dfull = np.zeros((N + 1, nc, nz))
        lb = np.full((N + 1, nc), -np.inf)
        ub = np.full((N + 1, nc), np.inf)
        for k, ent in enumerate(entries):
            if ent is None:
                continue
            Dk, lbk, ubk = ent
            Dk = np.asarray(Dk, dtype=np.float64).reshape(-1, np.asarray(Dk).shape[-1])
            m = Dk.shape[0]
            if k == N and Dk.shape[1] == nx:
                # Terminal constraints act on x only (reference terminal
                # node has no u-block); pad the u-columns with zeros.
                Dk = np.concatenate([np.zeros((m, nu)), Dk], axis=1)
            if Dk.shape[1] != nz:
                raise ValueError(
                    f"stage_constraints[{k}]: D has {Dk.shape[1]} columns, "
                    f"expected nz = {nz}" + (f" or nx = {nx}" if k == N else "")
                )
            if k == N and np.any(Dk[:, :nu] != 0):
                raise ValueError(
                    "terminal constraint rows must not touch controls "
                    "(u-columns of the terminal D must be zero)"
                )
            lbk = np.broadcast_to(np.asarray(lbk, dtype=np.float64), (m,))
            ubk = np.broadcast_to(np.asarray(ubk, dtype=np.float64), (m,))
            Dfull[k, :m, :] = Dk
            lb[k, :m] = lbk
            ub[k, :m] = ubk
    elif D is None and DN is None:
        nc = 0
        Dfull = np.zeros((N + 1, 0, nz))
        lb = np.zeros((N + 1, 0))
        ub = np.zeros((N + 1, 0))
    else:
        D_ = np.zeros((N, 0, nz)) if D is None else stack(D, np.asarray(D).shape[-2:])
        ncs = D_.shape[-2]
        ncN = 0 if DN is None else np.asarray(DN).shape[-2]
        nc = max(ncs, ncN)
        Dfull = np.zeros((N + 1, nc, nz))
        lb = np.full((N + 1, nc), -np.inf)
        ub = np.full((N + 1, nc), np.inf)
        if D is not None:
            Dfull[:N, :ncs, :] = D_
            lb[:N, :ncs] = stack(e_lb, (ncs,))
            ub[:N, :ncs] = stack(e_ub, (ncs,))
        if DN is not None:
            # Terminal constraints act on x only; pad the u-columns with 0.
            Dfull[N, :ncN, nu:] = np.asarray(DN, dtype=np.float64)
            lb[N, :ncN] = np.asarray(e_lbN, dtype=np.float64)
            ub[N, :ncN] = np.asarray(e_ubN, dtype=np.float64)

    cast = lambda x: jnp.asarray(x, dtype=dtype)
    return LQRProblem(
        A=cast(A), B=cast(B), c=cast(c), H=cast(H), h=cast(h),
        D=cast(Dfull), e_lb=cast(lb), e_ub=cast(ub),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ADMMIterates:
    """ADMM iterate vectors consumed by every solver's data update.

    Reference counterpart: the (ws, ys, zs, rho_vecs, inv_rho_vecs)
    std::vectors threaded through update_problem_data / backward
    (lqr_solver.hpp:15-22, examples/lqr_example.cpp:12-46).

    Shapes: w (N+1, nz) primal trajectory [u;x] (terminal u-part unused),
    y/z/rho (N+1, nc) per-constraint-row dual / slack / penalty.  Padded
    constraint rows carry rho = 0.
    """

    w: jax.Array
    y: jax.Array
    z: jax.Array
    rho: jax.Array

    @property
    def inv_rho(self) -> jax.Array:
        """1/rho with 0 for padded (rho = 0) rows."""
        return jnp.where(self.rho > 0, 1.0 / jnp.where(self.rho > 0, self.rho, 1.0), 0.0)


def init_iterates(problem: LQRProblem, rho: float = 0.01, con_mask=None) -> ADMMIterates:
    """Zero-initialized iterates with constant rho on active rows.

    Mirrors examples/lqr_example.cpp:12-46 (initialize_vectors).
    ``con_mask`` ((N+1, nc) bool) marks real constraint rows; defaults to
    rows with a nonzero D entry or a finite bound.
    """
    dt = problem.H.dtype
    shape_c = problem.e_lb.shape
    if con_mask is None:
        has_row = jnp.any(problem.D != 0, axis=-1)
        con_mask = has_row
    rho_vec = jnp.where(con_mask, jnp.asarray(rho, dt), 0.0)
    return ADMMIterates(
        w=jnp.zeros(problem.h.shape, dt),
        y=jnp.zeros(shape_c, dt),
        z=jnp.zeros(shape_c, dt),
        rho=rho_vec.astype(dt),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StageParams:
    """Per-iteration solver inputs derived from problem + iterates.

    Reference counterpart: LQRSolver::update_problem_data
    (lqr_solver.hpp:41-56):
      H~ = H + sigma*I,  h~ = h - sigma*w,  g = z - rho^{-1} o y.
    """

    H: jax.Array  # (N+1, nz, nz) sigma-regularized cost Hessians
    h: jax.Array  # (N+1, nz)
    g: jax.Array  # (N+1, nc)


def make_stage_params(
    problem: LQRProblem, it: ADMMIterates, sigma: float
) -> StageParams:
    """Functional ``update_problem_data`` (lqr_solver.hpp:41-56).

    The terminal stage only regularizes its x-block: the reference adds
    sigma to the diagonal of the (nx, nx) terminal H
    (lqr_solver.hpp:47-48 with the terminal node's smaller H); our padded
    u-rows of H[N] stay exactly 0 and are never read by the backward
    pass, so adding sigma uniformly and masking the terminal u-part of
    h~ preserves reference semantics.
    """
    nz = problem.nz
    nu = problem.nu
    eye = jnp.eye(nz, dtype=problem.H.dtype)
    Ht = problem.H + sigma * eye
    ht = problem.h - sigma * it.w
    # Terminal stage has no controls: keep padded u-entries at zero.
    mask = jnp.ones((problem.N + 1, nz), dtype=problem.h.dtype)
    mask = mask.at[-1, :nu].set(0.0)
    ht = ht * mask
    g = it.z - it.inv_rho * it.y
    return StageParams(H=Ht, h=ht, g=g)
