"""Reference-shaped class API — drop-in lifecycle compatibility.

The reference exposes stateful solver objects with a four-call
lifecycle (include/clqr/lqr/lqr_solver.hpp:9-28):

    LQRSolver solver(model);
    solver.update_problem_data(ws, ys, zs, rho_vecs, inv_rho_vecs, sigma);
    solver.backward(rho_vecs);              // or backward_without_factorization
    solver.forward(x0, ws);

This module provides the same classes and call sequence on top of the
pure-functional backends, so a reference user can port call sites
mechanically.  Each lifecycle method dispatches to a module-level
jitted callable cached by ``(backend, kind, batched, static-config)``
— the jit cache is therefore shared across calls AND across solver
instances with the same configuration, so only the first call of each
(shape, config) combination traces/compiles.  This matters because the
reference lifecycle lives inside ADMM iteration loops where
``backward_without_factorization``/``forward`` fire every iteration.

Differences from the reference, by design:
  * ``forward`` returns the trajectory instead of mutating ``ws``.
  * ``inv_rho_vecs`` is derived, not passed (ADMMIterates.inv_rho).
  * Everything works batched: construct with a batched problem and all
    methods map over the leading axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pdp_lqr_tpu.config import CondensedSolverType
from pdp_lqr_tpu.problem import ADMMIterates, LQRProblem, make_stage_params


def _make_fn(backend: str, kind: str, cfg: tuple):
    """Build the pure function for one (backend, lifecycle-step) pair.

    ``cfg`` carries the backend's static configuration (segment count,
    condensed-solver type, rho_dyn, ...) so the returned closure is a
    function of arrays only — safe to vmap/jit once and reuse.
    """
    if backend == "seq":
        from pdp_lqr_tpu.ops import riccati

        return {
            "bw": riccati.backward,
            "bw_cached": riccati.backward_no_refactor,
            "fw": riccati.forward,
        }[kind]
    if backend == "pdp":
        from pdp_lqr_tpu.solvers import pdp

        num_segments, solver_type = cfg
        return {
            "bw": lambda p, prm, rho: pdp.backward(
                p, prm, rho, num_segments, solver_type
            ),
            "bw_cached": pdp.backward_without_factorization,
            "fw": pdp.forward,
        }[kind]
    if backend == "kkt":
        from pdp_lqr_tpu.solvers import kkt

        (rho_dyn,) = cfg
        return {
            "bw": lambda p, prm, rho: kkt.backward(p, prm, rho, rho_dyn),
            "fw": kkt.forward,
        }[kind]
    if backend == "assoc":
        from pdp_lqr_tpu.ops import riccati_assoc

        return {
            "bw": riccati_assoc.backward,
            "bw_cached": riccati_assoc.backward_no_refactor,
            "fw": riccati_assoc.forward,
        }[kind]
    if backend == "params":
        # Pseudo-backend: the update_problem_data iterate→StageParams
        # transform, cached here so it stops retracing per call too.
        (sigma,) = cfg
        return lambda p, it: make_stage_params(p, it, sigma)
    raise ValueError(f"unknown backend {backend!r}")


@functools.lru_cache(maxsize=None)
def _jitted(backend: str, kind: str, batched: bool, cfg: tuple):
    """One jitted callable per (backend, step, batchedness, config).

    lru_cache guarantees the same function object comes back for the
    same key, so jax.jit's trace cache is hit on every call after the
    first (regression-tested in tests/test_api.py).
    """
    fn = _make_fn(backend, kind, cfg)
    if batched:
        fn = jax.vmap(fn)
    return jax.jit(fn)


class _SolverBase:
    """Shared lifecycle plumbing; subclasses bind a backend name."""

    _backend: str = ""

    def __init__(self, model: LQRProblem):
        self.model = model
        self._batched = model.A.ndim == 4
        self._params = None
        self._rho = None
        self._factors = None

    def _cfg(self) -> tuple:
        """Hashable static configuration for the jit cache key."""
        return ()

    def _dispatch(self, kind: str):
        return _jitted(self._backend, kind, self._batched, self._cfg())

    # -- reference: update_problem_data (lqr_solver.hpp:41-56) ----------
    def update_problem_data(self, ws, ys, zs, rho_vecs, sigma: float):
        it = ADMMIterates(
            w=jnp.asarray(ws), y=jnp.asarray(ys), z=jnp.asarray(zs),
            rho=jnp.asarray(rho_vecs),
        )
        fn = _jitted("params", "mk", self._batched, (float(sigma),))
        self._params = fn(self.model, it)
        self._rho = it.rho
        return self

    def _require_params(self):
        if self._params is None:
            raise RuntimeError("call update_problem_data first")

    # -- reference: backward / backward_without_factorization -----------
    def backward(self):
        self._require_params()
        self._factors = self._dispatch("bw")(
            self.model, self._params, self._rho
        )
        return self

    def backward_without_factorization(self):
        self._require_params()
        if self._factors is None:
            raise RuntimeError("no cached factorization; call backward first")
        self._factors = self._dispatch("bw_cached")(
            self.model, self._params, self._rho, self._factors
        )
        return self

    # -- reference: forward (lqr_solver.hpp:72-77) -----------------------
    def forward(self, x0):
        if self._factors is None:
            raise RuntimeError("call backward first")
        return self._dispatch("fw")(
            self.model, self._factors, jnp.asarray(x0)
        )

    def clear_workspace(self):
        """Reference: LQRSolver::clear_workspace (lqr_solver.hpp:26)."""
        self._params = None
        self._rho = None
        self._factors = None
        return self


class LQRSolver(_SolverBase):
    """Sequential Riccati — reference ``clqr::LQRSolver``."""

    _backend = "seq"


class LQRParallelSolver(_SolverBase):
    """Segmented parallel Riccati — reference ``clqr::LQRParallelSolver``.

    ``num_segments`` as in the reference ctor
    (lqr_solver_parallel.hpp:22); ``load_balancing`` is accepted for
    signature compatibility and ignored — uniform segments are optimal
    under SIMD (see ops/riccati_pdp.py docstring); ``solver_type``
    picks the condensed factorization (LU or CHOLESKY).
    """

    _backend = "pdp"

    def __init__(self, model: LQRProblem, num_segments: int = 4,
                 load_balancing: bool = False,
                 solver_type: CondensedSolverType = CondensedSolverType.CHOLESKY):
        super().__init__(model)
        del load_balancing
        self.num_segments = num_segments
        self.solver_type = solver_type

    def _cfg(self):
        return (self.num_segments, self.solver_type)


class QDLDLSolver(_SolverBase):
    """Full-horizon KKT factorization — reference ``clqr::QDLDLSolver``.

    ``rho_dyn``/``sigma`` regularization defaults match the reference's
    hardwired 1e-6 (qdldl_solver.hpp:40-41).  The symbolic phase of
    QDLDL has no analog — the block-tridiagonal structure is static.
    """

    _backend = "kkt"

    def __init__(self, model: LQRProblem, rho_dyn: float = 1e-6):
        super().__init__(model)
        self.rho_dyn = rho_dyn

    def _cfg(self):
        return (self.rho_dyn,)

    def backward_without_factorization(self):
        # Numeric factor reuse == not refactoring at all (only the rhs
        # changes); the factors pass through untouched.
        self._require_params()
        if self._factors is None:
            raise RuntimeError("no cached factorization; call backward first")
        return self

    def forward(self, x0):
        if self._factors is None:
            raise RuntimeError("call backward first")
        return self._dispatch("fw")(
            self.model, self._params, self._rho, self._factors,
            jnp.asarray(x0),
        )


class AssociativeScanSolver(_SolverBase):
    """Log-depth associative-scan Riccati (no reference
    counterpart — same lifecycle for interchangeability)."""

    _backend = "assoc"


class ScenarioServer:
    """One-model-many-scenarios serving on the shared-stage sweeps.

    The reference's process shape — a single ``LQRModel`` behind all
    solvers (lqr_model.hpp:66-89) — as a first-class serving API: the
    stage matrices live in device memory once (lane width 1) while
    scenario batches (per-scenario x0, optional per-scenario drift c,
    warm-start iterates) run at full batch width.

        server = ScenarioServer(model)
        ws = server.solve(x0s)                       # inner LQ solves
        ws, state, info = server.solve_admm(x0s, cones, settings)

    ``model`` is UNBATCHED.  The sweep implementation follows the
    platform (ops/pallas_riccati.choose_impl).
    """

    def __init__(self, model: LQRProblem, rho: float = 0.01,
                 sigma: float = 1e-6):
        if model.A.ndim != 3:
            raise ValueError("ScenarioServer takes an UNBATCHED model")
        from pdp_lqr_tpu.ops import pallas_riccati as _pr
        from pdp_lqr_tpu.problem import init_iterates
        from pdp_lqr_tpu.solvers import admm as _admm

        self.model = model
        self.sigma = float(sigma)
        self._it = init_iterates(model, rho=rho)
        self._solve = jax.jit(
            lambda m, it, x0: _pr.solve_shared(m, it, x0, self.sigma))
        self._solve_admm = jax.jit(
            _admm.solve_fused, static_argnames=("cones", "settings"))

    def _with_c(self, c):
        import dataclasses as _dc

        return self.model if c is None else _dc.replace(
            self.model, c=jnp.asarray(c, self.model.c.dtype))

    def solve(self, x0s, c=None):
        """Batched inner solves: x0s (B, nx), optional per-scenario
        drift c (B, N, nx).  Returns ws (B, N+1, nz)."""
        return self._solve(self._with_c(c), self._it, jnp.asarray(x0s))

    def solve_admm(self, x0s, cones=(), settings=None, state=None,
                   soc_shift=None, c=None):
        """Full conic ADMM over the scenario batch (solve_fused on the
        shared model).  Returns (ws, state, info) — ``state``
        warm-starts the next tick."""
        from pdp_lqr_tpu.solvers import admm as _admm

        if settings is None:
            settings = _admm.ADMMSettings()
        return self._solve_admm(
            self._with_c(c), jnp.asarray(x0s), cones=tuple(cones or ()),
            settings=settings, state=state, soc_shift=soc_shift)
