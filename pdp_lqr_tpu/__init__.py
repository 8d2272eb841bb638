"""pdp_lqr_tpu — a batched conic LQR / trajectory-optimization engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
PDP-LQR reference library (parallel dynamic programming for conic linear
quadratic control).  The reference is a header-only C++17/Eigen/OpenMP
library exposing three interchangeable solvers for the ADMM inner
KKT-solve of a constrained LQ optimal-control problem; this package
provides the same three solver paths — plus the ADMM outer loop the
reference omits — as pure-functional, batched, mesh-shardable JAX
programs:

- ``solvers.sequential``  — classic Riccati recursion as a ``lax.scan``
  (reference: include/clqr/lqr/lqr_solver.hpp).
- ``solvers.pdp``         — the paper's segmented parallel Riccati with a
  condensed boundary system (reference: lqr_solver_parallel.hpp,
  condensed_system.hpp), single-device (vmapped segments) and
  multi-device (shard_map over a "time" mesh axis).
- ``solvers.kkt``         — batched block-tridiagonal LDLt factorization
  of the full-horizon KKT system (reference: kkt.hpp + qdldl_solver.hpp,
  re-designed as dense block recursions instead of general sparse).
- ``solvers.assoc``       — log-depth associative-scan Riccati
  (``lax.associative_scan`` over value-function factors), a log-depth
  formulation with no reference counterpart.
- ``solvers.admm``        — OSQP-style conic ADMM outer loop (projection
  onto boxes and second-order cones, dual updates, residuals, rho
  adaptation) completing the interface the reference solvers consume.
"""

from pdp_lqr_tpu.config import SolverConfig, LQR_INFTY, DIVISION_TOL
from pdp_lqr_tpu.problem import (
    LQRProblem,
    build_problem,
    ADMMIterates,
    StageParams,
    init_iterates,
    make_stage_params,
)
from pdp_lqr_tpu.api import (
    LQRSolver,
    LQRParallelSolver,
    QDLDLSolver,
    AssociativeScanSolver,
    ScenarioServer,
)

__all__ = [
    "SolverConfig",
    "LQR_INFTY",
    "DIVISION_TOL",
    "LQRProblem",
    "build_problem",
    "ADMMIterates",
    "StageParams",
    "init_iterates",
    "make_stage_params",
    "LQRSolver",
    "LQRParallelSolver",
    "QDLDLSolver",
    "AssociativeScanSolver",
    "ScenarioServer",
]

__version__ = "0.1.0"
