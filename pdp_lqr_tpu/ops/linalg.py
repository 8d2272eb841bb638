"""Small dense linear-algebra primitives used by every solver backend.

The reference leans on Eigen's LLT and triangular solves
(lqr_kernel.hpp:89,126,145,199; condensed_system.hpp LLT/PartialPivLU).
Here they are thin wrappers over jnp/XLA so that (a) every call site
reads like the math, and (b) Pallas batch-in-lanes kernels can be
swapped in behind the same names for the hot paths.

All functions operate on the *trailing* two axes and batch over any
leading axes, which is what ``vmap``/``scan`` produce.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl


def cholesky(M: jax.Array) -> jax.Array:
    """Lower-triangular Cholesky factor, L @ L.T = M.

    Reference: Eigen ``M.llt().matrixL()`` (lqr_kernel.hpp:89,126).
    """
    return jnp.linalg.cholesky(M)


def solve_lower(L: jax.Array, b: jax.Array) -> jax.Array:
    """Solve L y = b with L lower triangular (forward substitution).

    Reference: ``L.triangularView<Lower>().solveInPlace`` (lqr_kernel.hpp:145).
    """
    return jsl.solve_triangular(L, b, lower=True)


def solve_lower_T(L: jax.Array, b: jax.Array) -> jax.Array:
    """Solve L^T y = b with L lower triangular (back substitution).

    Reference: ``L.triangularView<Lower>().transpose().solveInPlace``
    (lqr_kernel.hpp:199, lqr_kernel_parallel.hpp:107-108).
    """
    return jsl.solve_triangular(L, b, lower=True, trans=1)


def chol_solve(L: jax.Array, b: jax.Array) -> jax.Array:
    """Solve (L L^T) y = b given the Cholesky factor L.

    Reference: Eigen ``LLT::solveInPlace`` (condensed_system.hpp:220,227).
    """
    return solve_lower_T(L, solve_lower(L, b))


def spd_inverse_from_chol(L: jax.Array) -> jax.Array:
    """Inverse of an SPD matrix from its Cholesky factor.

    Reference: ``P_chol_fact.solveInPlace(Pinv)`` with Pinv = I
    (condensed_system.hpp:215-220).
    """
    eye = jnp.eye(L.shape[-1], dtype=L.dtype)
    eye = jnp.broadcast_to(eye, L.shape)
    return chol_solve(L, eye)


def cholesky_unrolled(M: jax.Array) -> jax.Array:
    """Lower Cholesky of a small SPD matrix, fully scalar-unrolled.

    XLA's lowering of cholesky/triangular_solve on tiny batched
    matrices is loop-based and dominates the Riccati scan's runtime;
    for small n (<= ~8) an unrolled factorization compiles to
    straight-line elementwise arithmetic over the batch — no loops, no dynamic
    slices.  n is static (Python), so the unroll emits ~n^3/6 vector
    ops of width = batch.

    M: (..., n, n) SPD.  Returns (..., n, n) lower-triangular L.
    """
    n = M.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[..., j, j]
        for t in range(j):
            s = s - L[j][t] * L[j][t]
        L[j][j] = jnp.sqrt(s)
        inv_ljj = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = M[..., i, j]
            for t in range(j):
                s = s - L[i][t] * L[j][t]
            L[i][j] = s * inv_ljj
    zero = jnp.zeros_like(L[0][0])
    rows = [
        jnp.stack([L[i][j] if j <= i else zero for j in range(n)], axis=-1)
        for i in range(n)
    ]
    return jnp.stack(rows, axis=-2)


def chol_solve_unrolled(L: jax.Array, Bmat: jax.Array) -> jax.Array:
    """Solve (L L^T) X = B with unrolled forward/back substitution.

    L: (..., n, n) lower;  Bmat: (..., n, k).  Returns (..., n, k).
    """
    n = L.shape[-1]
    k = Bmat.shape[-1]
    inv_diag = [1.0 / L[..., i, i] for i in range(n)]
    cols = []
    for c in range(k):
        y = [None] * n
        for i in range(n):
            s = Bmat[..., i, c]
            for t in range(i):
                s = s - L[..., i, t] * y[t]
            y[i] = s * inv_diag[i]
        x = [None] * n
        for i in range(n - 1, -1, -1):
            s = y[i]
            for t in range(i + 1, n):
                s = s - L[..., t, i] * x[t]
            x[i] = s * inv_diag[i]
        cols.append(jnp.stack(x, axis=-1))
    return jnp.stack(cols, axis=-1)


def spd_solve_unrolled(M: jax.Array, Bmat: jax.Array) -> jax.Array:
    """Solve M X = B for small SPD M (unrolled Cholesky + substitution)."""
    return chol_solve_unrolled(cholesky_unrolled(M), Bmat)


def solve_lower_unrolled(L: jax.Array, Bmat: jax.Array) -> jax.Array:
    """Unrolled forward substitution: L Y = B, L lower (..., n, n).

    Bmat (..., n, k) -> (..., n, k)."""
    n = L.shape[-1]
    ys = [None] * n
    for i in range(n):
        s = Bmat[..., i, :]
        for t in range(i):
            s = s - L[..., i, t][..., None] * ys[t]
        ys[i] = s / L[..., i, i][..., None]
    return jnp.stack(ys, axis=-2)


def solve_lower_T_unrolled(L: jax.Array, Bmat: jax.Array) -> jax.Array:
    """Unrolled back substitution: L^T Y = B, L lower (..., n, n)."""
    n = L.shape[-1]
    ys = [None] * n
    for i in range(n - 1, -1, -1):
        s = Bmat[..., i, :]
        for t in range(i + 1, n):
            s = s - L[..., t, i][..., None] * ys[t]
        ys[i] = s / L[..., i, i][..., None]
    return jnp.stack(ys, axis=-2)


def ge_solve_unrolled(A: jax.Array, Bmat: jax.Array) -> jax.Array:
    """Solve A X = B for small general A, fully unrolled, with
    branch-free partial pivoting.

    Same motivation as the unrolled Cholesky: XLA's LU lowering is
    a sequential loop that dominates e.g. the associative-scan combine
    (every combine solves with I + C J, n = nx).  Pivoting is done
    with where-masks over the static row range — no dynamic slicing —
    costing ~n^2 selects per column on top of the ~n^3/3 elimination
    FMAs, all vectorized over the batch.

    A: (..., n, n); Bmat: (..., n, k).  Returns (..., n, k).
    """
    n = A.shape[-1]
    k = Bmat.shape[-1]
    # Work on row lists of (..., n + k) augmented rows.
    rows = [
        jnp.concatenate([A[..., i, :], Bmat[..., i, :]], axis=-1)
        for i in range(n)
    ]
    for col in range(n):
        # Branch-free partial pivot: bubble the max-|pivot| row (among
        # col..n-1) into position col with conditional pairwise swaps.
        cur = rows[col]
        for r in range(col + 1, n):
            swap = (jnp.abs(rows[r][..., col])
                    > jnp.abs(cur[..., col]))[..., None]
            cur, rows[r] = (
                jnp.where(swap, rows[r], cur),
                jnp.where(swap, cur, rows[r]),
            )
        rows[col] = cur
        inv_p = 1.0 / rows[col][..., col]
        for r in range(col + 1, n):
            f = (rows[r][..., col] * inv_p)[..., None]
            rows[r] = rows[r] - f * rows[col]
    # Back substitution.
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        s = rows[i][..., n:]
        for t in range(i + 1, n):
            s = s - rows[i][..., t][..., None] * xs[t]
        xs[i] = s / rows[i][..., i][..., None]
    return jnp.stack(xs, axis=-2)
