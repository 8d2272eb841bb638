"""Dense P-form Riccati solver — the XLA throughput backend.

Same math as solvers.sequential (reference lqr_solver.hpp) carried in
P-form with unrolled small-matrix solves and a solve-free rollout; see
ops/riccati_dense.py.  This is the default backend for large-batch
workloads (bench.py); use sequential/assoc when square-root numerical
robustness is preferred.
"""

from __future__ import annotations

import jax

from pdp_lqr_tpu.ops import riccati_dense
from pdp_lqr_tpu.problem import ADMMIterates, LQRProblem, make_stage_params

DenseFactors = riccati_dense.DenseFactors

update_problem_data = make_stage_params
backward = riccati_dense.backward
backward_without_factorization = riccati_dense.backward_no_refactor
forward = riccati_dense.forward


def solve(problem: LQRProblem, it: ADMMIterates, x0, sigma: float):
    params = make_stage_params(problem, it, sigma)
    factors = riccati_dense.backward(problem, params, it.rho)
    ws = riccati_dense.forward(problem, factors, x0)
    return ws, factors


def resolve(problem: LQRProblem, it: ADMMIterates, x0, sigma: float,
            factors: DenseFactors):
    params = make_stage_params(problem, it, sigma)
    factors = riccati_dense.backward_no_refactor(problem, params, it.rho, factors)
    ws = riccati_dense.forward(problem, factors, x0)
    return ws, factors


solve_batched = jax.vmap(solve, in_axes=(0, 0, 0, None))
