"""Solver configuration and numeric constants.

Reference counterparts: include/clqr/typedefs.hpp:8-24 (scalar=double,
LQR_INFTY, DIVISION_TOL) and the constructor knobs scattered through
lqr_solver_parallel.hpp:64-100 (num_segments, load_balancing,
CondensedSystemSolverType) and qdldl_solver.hpp:40-41 (rho_dyn, sigma).

This build replaces the hardwired ``double`` scalar with a
configurable dtype: float64 for bit-level parity testing (CPU or GPU),
float32 for throughput on the GPU.
"""

from __future__ import annotations

import dataclasses
import enum
import functools

import jax
import jax.numpy as jnp


def f32_matmul_precision(fn):
    """Pin full-float32 matmul precision while tracing ``fn``.

    On the GPU, XLA may run a float32 matrix product in TF32, which
    keeps about three decimal digits (a 10-bit mantissa); the
    value-function recursion amplifies that truncation over the
    horizon.  Solver math must not silently run at reduced precision,
    so every compute-path entry point is wrapped with this
    decorator.  Users can still trade accuracy for speed
    explicitly by calling the ops inside their own
    ``jax.default_matmul_precision`` scope *and* bypassing the facades.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped

# Matches clqr::LQR_INFTY / clqr::DIVISION_TOL (typedefs.hpp:23-24).
LQR_INFTY = float("inf")
DIVISION_TOL = 1e-20


class CondensedSolverType(enum.Enum):
    """Which factorization solves the inter-segment condensed system.

    Reference: CondensedSystemSolverType{LU, CHOLESKY}
    (lqr_solver_parallel.hpp:14-17).
    """

    LU = "lu"
    CHOLESKY = "cholesky"


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver knobs (hashable; safe to close over under jit).

    Attributes:
      dtype: compute dtype for the solver math.
      num_segments: horizon segments for the PDP parallel solver
        (reference ``num_segments`` ctor arg, lqr_solver_parallel.hpp:22).
      condensed_solver: factorization for the condensed boundary system.
      sigma: ADMM proximal regularization added to every H diagonal
        (reference ``sigma``, lqr_solver.hpp:44-48; example value 1e-6,
        lqr_example.cpp:171).
      rho_dyn: regularization on dynamics-dual rows of the KKT backend
        (reference rho_dyn=1e-6, qdldl_solver.hpp:40).
      alpha_relax: ADMM over-relaxation (OSQP default; outer loop is
        absent from the reference).
      rho: default penalty for constraint rows (example value 0.01,
        lqr_example.cpp:170).
    """

    dtype: jnp.dtype = jnp.float32
    num_segments: int = 4
    condensed_solver: CondensedSolverType = CondensedSolverType.CHOLESKY
    sigma: float = 1e-6
    rho_dyn: float = 1e-6
    alpha_relax: float = 1.6
    rho: float = 0.01

    def __hash__(self):
        return hash(
            (
                jnp.dtype(self.dtype).name,
                self.num_segments,
                self.condensed_solver,
                self.sigma,
                self.rho_dyn,
                self.alpha_relax,
                self.rho,
            )
        )
