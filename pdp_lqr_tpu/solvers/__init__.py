"""Solver backends: one API, six implementations.

Every backend exposes the reference's four-call interface
(update_problem_data / backward / backward_without_factorization /
forward — lqr_solver.hpp:9-28) as pure functions plus a one-shot
``solve`` and a cached-factor ``resolve``:

  sequential — Riccati recursion via lax.scan (reference LQRSolver);
               square-root (Cholesky) value function
  pdp        — segmented parallel Riccati + condensed boundary system
               (reference LQRParallelSolver); multi-device variant
               in parallel.pdp_sharded
  kkt        — batched block-tridiagonal LDLt of the full-horizon KKT
               (reference QDLDLSolver, dense-block re-design)
  assoc      — log-depth associative-scan Riccati (no reference
               counterpart)
  dense      — P-form recursion with unrolled small-matrix solves; the
               XLA throughput backend
  (lanes)    — ops.pallas_riccati: batch-minor sweeps (a Pallas-Triton
               kernel on the GPU, XLA elsewhere), used directly or
               through admm.solve_fused — the batched serving path

  admm       — conic ADMM outer loop around any of the above
               (admm.solve per instance, admm.solve_fused batch-level,
               parallel.admm_sharded multi-device)
  realtime   — B=1 real-time MPC path: the cached-factor inner solve
               materialized as one dense matvec, early-exit
               while_loop replans at 1 kHz rates
"""
