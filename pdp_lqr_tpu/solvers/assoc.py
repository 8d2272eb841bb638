"""Associative-scan Riccati solver — log-depth backward AND forward.

The log-depth path: no reference counterpart (the reference's
parallelism stops at coarse OpenMP segments, lqr_solver_parallel.hpp);
see ops/riccati_assoc.py for the algorithm.  Drop-in API-compatible
with solvers.sequential: same RiccatiFactors cache, same ws layout,
same cached-factor fast path semantics (lqr_solver.hpp:65-70).
"""

from __future__ import annotations

import jax

from pdp_lqr_tpu.ops import riccati, riccati_assoc
from pdp_lqr_tpu.problem import (
    ADMMIterates,
    LQRProblem,
    make_stage_params,
)

RiccatiFactors = riccati.RiccatiFactors

update_problem_data = make_stage_params
backward = riccati_assoc.backward
backward_without_factorization = riccati_assoc.backward_no_refactor
forward = riccati_assoc.forward
cost_to_go = riccati_assoc.cost_to_go


def solve(problem: LQRProblem, it: ADMMIterates, x0, sigma: float):
    """update_problem_data + log-depth backward + log-depth forward."""
    params = make_stage_params(problem, it, sigma)
    factors = riccati_assoc.backward(problem, params, it.rho)
    ws = riccati_assoc.forward(problem, factors, x0)
    return ws, factors


def resolve(problem: LQRProblem, it: ADMMIterates, x0, sigma: float,
            factors: RiccatiFactors):
    """Re-solve with cached factors (rho/sigma unchanged), log-depth."""
    params = make_stage_params(problem, it, sigma)
    factors = riccati_assoc.backward_no_refactor(problem, params, it.rho, factors)
    ws = riccati_assoc.forward(problem, factors, x0)
    return ws, factors


solve_batched = jax.vmap(solve, in_axes=(0, 0, 0, None))
