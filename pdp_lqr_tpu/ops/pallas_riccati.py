"""Batched Riccati sweeps for the GPU: one Pallas-Triton kernel per sweep.

Arrays are batch-leading, ``(W, N, ...)``: W is the batch, or 1 for a
*shared* tensor — one model serving the whole batch, held once in
device memory and read by every instance.

Three sweeps, each as a Triton kernel and as its plain XLA reference
(``impl="xla"``), with the same contract:

  ``backward``          factorizing backward sweep with the penalty fold
                        (lqr_kernel.hpp:103-147, P-form as in
                        ops/riccati_dense.py); optionally exports the
                        per-stage factors (P_{k+1}, Huu^{-1}) that
                        ``backward_vectors`` reuses;
  ``backward_vectors``  the cached-factor vector sweep — the reference's
                        backward_without_factorization
                        (lqr_kernel.hpp:149-178, lqr_solver.hpp:65-70);
  ``forward``           the closed-loop rollout x+ = A x + B (K x + d) + c.

Kernel design: the grid runs over instances, one program each; the stage
loop is a ``lax.fori_loop`` inside the program, and the cost-to-go
(P, p) is a loop value — programs run in parallel and in no order, so
nothing is carried between them.  Each stage's blocks are loaded as
power-of-two tiles (masked loads of the unpadded arrays; the padding
reads as zero), products are tile ``dot``s at "highest" precision (no
TF32), and Huu is inverted by Gauss-Jordan over its nu real pivots (the
padded diagonal reads as identity).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

HIGHEST = jax.lax.Precision.HIGHEST

# Largest state width the kernel takes; above it the XLA sweep is used
# (the rule is set by measurement on the H100: see choose_impl).
KERNEL_MAX_NX = 64

IMPLS = ("triton", "interpret", "xla")


def choose_impl(nx: int, impl: str | None = None) -> str:
    """The one place that picks a sweep implementation.

    ``impl`` given: used as is ("triton", "xla", or "interpret" — the
    Triton kernel under the Pallas interpreter, for tests).  Otherwise
    by the default backend: on "gpu" the Triton kernel for nx <=
    KERNEL_MAX_NX and XLA above it; on "cpu" XLA; any other platform
    raises.
    """
    if impl is not None:
        if impl not in IMPLS:
            raise ValueError(f"unknown sweep impl {impl!r}; one of {IMPLS}")
        return impl
    backend = jax.default_backend()
    if backend == "gpu":
        return "triton" if nx <= KERNEL_MAX_NX else "xla"
    if backend == "cpu":
        return "xla"
    raise RuntimeError(
        f"no Riccati sweep for platform {backend!r} (gpu or cpu only)")


def _tile(n: int) -> int:
    """Tile edge for a matrix dimension: a power of two, at least 16
    (the smallest ``dot`` operand on this route)."""
    return max(16, 1 << (n - 1).bit_length())


def _width(*xs):
    """Batch width of a set of batch-leading arrays (1 if all shared)."""
    ws = {x.shape[0] for x in xs if x is not None}
    ws.discard(1)
    if len(ws) > 1:
        raise ValueError(f"inconsistent batch widths {sorted(ws)}")
    return ws.pop() if ws else 1


# ------------------------------------------------------- in-kernel algebra

def _iota(shape, dim):
    return jax.lax.broadcasted_iota(jnp.int32, shape, dim)


def _mask(spans):
    shape = tuple(t for _, _, t in spans)
    mask = None
    for ax, (_, size, _) in enumerate(spans):
        m = _iota(shape, ax) < size
        mask = m if mask is None else mask & m
    return mask


def _zero():
    """A traced 0 of the default integer type (the loop index's)."""
    return (0 * pl.program_id(0)).astype(
        jax.dtypes.canonicalize_dtype(jnp.int64))


def _tiles(zero):
    """Masked tile load/store over the trailing axes of a ref.

    ``spans`` is ((offset, size, tile), ...); a tile may run past the
    end of its axis, and entries beyond ``size`` read as zero and are
    not written.  A nonzero static offset would fail the indexer's
    static bounds check, so offsets are shifted by ``zero``, a traced
    0 taken at the kernel's top level."""
    def slices(spans):
        return tuple(pl.ds(off + zero if off else 0, t)
                     for off, _, t in spans)

    def ld(ref, idx, spans):
        return plgpu.load(ref.at[idx + slices(spans)], mask=_mask(spans),
                          other=0.0)

    def st(ref, idx, spans, val):
        plgpu.store(ref.at[idx + slices(spans)], val.astype(ref.dtype),
                    mask=_mask(spans))

    return ld, st


# Tile products: a ``dot`` at full precision in float32; float64 has no
# ``dot`` on this route for these shapes (the card refuses its MMA), so
# it multiplies by broadcast-and-sum.

def _mm(a, b):
    """a @ b on tiles."""
    if a.dtype == jnp.float64:
        return jnp.sum(a[:, :, None] * b[None, :, :], axis=1)
    return jax.lax.dot_general(a, b, (((1,), (0,)), ((), ())),
                               precision=HIGHEST,
                               preferred_element_type=a.dtype)


def _mtm(a, b):
    """a^T @ b on tiles."""
    if a.dtype == jnp.float64:
        return jnp.sum(a[:, :, None] * b[:, None, :], axis=0)
    return jax.lax.dot_general(a, b, (((0,), (0,)), ((), ())),
                               precision=HIGHEST,
                               preferred_element_type=a.dtype)


def _mv(m, v):
    return jnp.sum(m * v[None, :], axis=1)


def _mtv(m, v):
    return jnp.sum(m * v[:, None], axis=0)


def _inverse(M, n):
    """Gauss-Jordan inverse of an SPD tile whose padding (beyond the
    first ``n`` rows/cols) is the identity; n static pivots.  NaN if
    the tile is not positive definite."""
    T = M.shape[0]
    r2, c2 = _iota((T, T), 0), _iota((T, T), 1)
    i1 = _iota((T,), 0)
    inv = jnp.where(r2 == c2, 1.0, 0.0).astype(M.dtype)
    min_piv = None
    for j in range(n):
        row_m = jnp.sum(jnp.where(r2 == j, M, 0.0), axis=0)
        row_i = jnp.sum(jnp.where(r2 == j, inv, 0.0), axis=0)
        col = jnp.where(i1 == j, 0.0, jnp.sum(jnp.where(c2 == j, M, 0.0),
                                              axis=1))
        piv = jnp.sum(jnp.where(i1 == j, row_m, 0.0))
        min_piv = piv if min_piv is None else jnp.minimum(min_piv, piv)
        row_m, row_i = row_m * (1.0 / piv), row_i * (1.0 / piv)
        M = jnp.where(r2 == j, row_m[None, :], M - col[:, None] * row_m)
        inv = jnp.where(r2 == j, row_i[None, :], inv - col[:, None] * row_i)
    # A non-positive pivot means Huu is not positive definite: NaN, as a
    # Cholesky factorization gives (solvers/recovery keys on it).  One
    # select after the loop: a select per pivot slowed the 64-wide
    # kernel ~9x at one batch size on the H100.
    return jnp.where(min_piv > 0.0, inv, jnp.nan)


# --------------------------------------------------------------- kernels

def _backward_kernel(N, nx, nu, nc, export, *refs):
    _ld, _st = _tiles(_zero())
    X, U, C = _tile(nx), _tile(nu), _tile(max(nc, 1))
    n_in = 10 if nc else 7
    ins, outs = refs[:n_in], refs[n_in:]
    if nc:
        A_r, B_r, c_r, H_r, h_r, D_r, rho_r, rg_r, PN_r, pN_r = ins
    else:
        A_r, B_r, c_r, H_r, h_r, PN_r, pN_r = ins
    K_o, d_o = outs[:2]
    xs, us, cs = (0, nx, X), (0, nu, U), (0, nc, C)
    xo = (nu, nx, X)                  # x block of an nz-long axis
    dt = K_o.dtype
    pad_u = jnp.where((_iota((U, U), 0) == _iota((U, U), 1))
                      & (_iota((U, U), 0) >= nu), 1.0, 0.0).astype(dt)

    def body(t, carry):
        P, p = carry
        k = N - 1 - t
        A = _ld(A_r, (0, k), (xs, xs))
        Bm = _ld(B_r, (0, k), (xs, us))
        c = _ld(c_r, (0, k), (xs,))
        R = _ld(H_r, (0, k), (us, us))
        S = _ld(H_r, (0, k), (us, xo))
        Q = _ld(H_r, (0, k), (xo, xo))
        r = _ld(h_r, (0, k), (us,))
        q = _ld(h_r, (0, k), (xo,))
        if nc:
            # Penalty fold (lqr_kernel.hpp:106-112): H += D^T diag(rho) D,
            # h -= D^T (rho g).
            Du = _ld(D_r, (0, k), (cs, us))
            Dx = _ld(D_r, (0, k), (cs, xo))
            rho = _ld(rho_r, (0, k), (cs,))
            rg = _ld(rg_r, (0, k), (cs,))
            R = R + _mtm(Du, rho[:, None] * Du)
            S = S + _mtm(Du, rho[:, None] * Dx)
            Q = Q + _mtm(Dx, rho[:, None] * Dx)
            r = r - _mtv(Du, rg)
            q = q - _mtv(Dx, rg)
        PA = _mm(P, A)
        Pcp = _mv(P, c) + p
        G = S + _mtm(Bm, PA)
        rbar = r + _mtv(Bm, Pcp)
        Hinv = _inverse(R + _mtm(Bm, _mm(P, Bm)) + pad_u, nu)
        K = -_mm(Hinv, G)
        d = -_mv(Hinv, rbar)
        Pn = Q + _mtm(A, PA) + _mtm(G, K)
        Pn = 0.5 * (Pn + Pn.T)
        pn = q + _mtv(A, Pcp) + _mtv(K, rbar)
        _st(K_o, (0, k), (us, xs), K)
        _st(d_o, (0, k), (us,), d)
        if export:
            _st(outs[2], (0, k), (xs, xs), P)
            _st(outs[3], (0, k), (us, us), Hinv)
        return Pn, pn

    P0 = _ld(PN_r, (0,), (xs, xs))
    p0 = _ld(pN_r, (0,), (xs,))
    jax.lax.fori_loop(0, N, body, (P0.astype(dt), p0.astype(dt)))


def _vectors_kernel(N, nx, nu, *refs):
    A_r, B_r, c_r, hf_r, P_r, K_r, Hi_r, pN_r, d_o = refs
    _ld, _st = _tiles(_zero())
    X, U = _tile(nx), _tile(nu)
    xs, us, xo = (0, nx, X), (0, nu, U), (nu, nx, X)

    def body(t, p):
        k = N - 1 - t
        A = _ld(A_r, (0, k), (xs, xs))
        Bm = _ld(B_r, (0, k), (xs, us))
        c = _ld(c_r, (0, k), (xs,))
        P = _ld(P_r, (0, k), (xs, xs))
        K = _ld(K_r, (0, k), (us, xs))
        Hinv = _ld(Hi_r, (0, k), (us, us))
        Pcp = _mv(P, c) + p
        rbar = _ld(hf_r, (0, k), (us,)) + _mtv(Bm, Pcp)
        _st(d_o, (0, k), (us,), -_mv(Hinv, rbar))
        return _ld(hf_r, (0, k), (xo,)) + _mtv(A, Pcp) + _mtv(K, rbar)

    p0 = _ld(pN_r, (0,), (xs,))
    jax.lax.fori_loop(0, N, body, p0.astype(d_o.dtype))


def _forward_kernel(N, nx, nu, *refs):
    A_r, B_r, c_r, K_r, d_r, x0_r, ws_o, xN_o = refs
    _ld, _st = _tiles(_zero())
    X, U = _tile(nx), _tile(nu)
    xs, us = (0, nx, X), (0, nu, U)

    def body(k, x):
        K = _ld(K_r, (0, k), (us, xs))
        u = _mv(K, x) + _ld(d_r, (0, k), (us,))
        _st(ws_o, (0, k), (us,), u)
        _st(ws_o, (0, k), ((nu, nx, X),), x)
        A = _ld(A_r, (0, k), (xs, xs))
        Bm = _ld(B_r, (0, k), (xs, us))
        return _mv(A, x) + _mv(Bm, u) + _ld(c_r, (0, k), (xs,))

    x0 = _ld(x0_r, (0,), (xs,)).astype(ws_o.dtype)
    _st(xN_o, (0,), (xs,), jax.lax.fori_loop(0, N, body, x0))


def _pallas(kernel, ins, out_shapes, width, dtype, nx, interpret, name):
    """One program per instance; a shared input (leading dim 1 while
    the batch is wider) is read by every program."""
    specs = []
    for x in ins:
        nd = x.ndim
        if x.shape[0] == width:
            imap = lambda b, nd=nd: (b,) + (0,) * (nd - 1)
        else:
            imap = lambda b, nd=nd: (0,) * nd
        specs.append(pl.BlockSpec((1,) + x.shape[1:], imap))
    X = _tile(nx)
    return pl.pallas_call(
        kernel,
        out_shape=tuple(jax.ShapeDtypeStruct((width,) + s, dtype)
                        for s in out_shapes),
        grid=(width,),
        in_specs=specs,
        out_specs=tuple(
            pl.BlockSpec((1,) + s, lambda b, n=len(s): (b,) + (0,) * n)
            for s in out_shapes),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=1 if X <= 16 else (4 if X <= 32 else 8)),
        interpret=interpret,
        name=name,
    )(*[x.astype(dtype) for x in ins])


# ---------------------------------------------------- XLA reference sweeps
# The whole batch per stage by batched matmuls inside a lax.scan; shared
# (W=1) inputs broadcast in the products.

def _xmm(a, b):
    return jnp.matmul(a, b, precision=HIGHEST)


def _xmv(a, v):
    return jnp.einsum("...ij,...j->...i", a, v, precision=HIGHEST)


def _T(x):
    return jnp.swapaxes(x, -1, -2)


def _stages(*xs):
    """(W, N, ...) -> (N, W, ...) scan inputs."""
    return tuple(jnp.moveaxis(x, 1, 0) for x in xs)


def _carry(x, width):
    return jnp.broadcast_to(x, (width,) + x.shape[1:])


def _backward_xla(A, Bm, c, H, h, D, rho, rg, PN, pN, export):
    width = _width(A, Bm, c, H, h, D, rho, rg, PN, pN)
    nu = Bm.shape[-1]
    xs = (A, Bm, c, H, h) + ((D, rho, rg) if D is not None else ())

    def step(carry, xs_k):
        P, p = carry
        Ak, Bk, ck, Hk, hk = xs_k[:5]
        if D is not None:
            Dk, rk, rgk = xs_k[5:]
            Hk = Hk + _xmm(_T(Dk) * rk[..., None, :], Dk)
            hk = hk - _xmv(_T(Dk), rgk)
        PA = _xmm(P, Ak)
        Pcp = _xmv(P, ck) + p
        G = Hk[..., :nu, nu:] + _xmm(_T(Bk), PA)
        rbar = hk[..., :nu] + _xmv(_T(Bk), Pcp)
        Huu = Hk[..., :nu, :nu] + _xmm(_T(Bk), _xmm(P, Bk))
        L = jnp.linalg.cholesky(Huu)
        eye = jnp.broadcast_to(jnp.eye(nu, dtype=Huu.dtype), Huu.shape)
        Hinv = jax.scipy.linalg.cho_solve((L, True), eye)
        K = -_xmm(Hinv, G)
        d = -_xmv(Hinv, rbar)
        Pn = Hk[..., nu:, nu:] + _xmm(_T(Ak), PA) + _xmm(_T(G), K)
        Pn = 0.5 * (Pn + _T(Pn))
        pn = hk[..., nu:] + _xmv(_T(Ak), Pcp) + _xmv(_T(K), rbar)
        return (Pn, pn), (K, d) + ((P, Hinv) if export else ())

    carry0 = (_carry(PN, width), _carry(pN, width))
    _, outs = jax.lax.scan(step, carry0, _stages(*xs), reverse=True)
    return tuple(jnp.moveaxis(o, 0, 1) for o in outs)


def _vectors_xla(A, Bm, c, hf, P, K, Hinv, pN):
    width = _width(A, Bm, c, hf, P, K, Hinv, pN)
    nu = Bm.shape[-1]

    def step(p, xs_k):
        Ak, Bk, ck, hk, Pk, Kk, Hk = xs_k
        Pcp = _xmv(Pk, ck) + p
        rbar = hk[..., :nu] + _xmv(_T(Bk), Pcp)
        d = -_xmv(Hk, rbar)
        return hk[..., nu:] + _xmv(_T(Ak), Pcp) + _xmv(_T(Kk), rbar), d

    _, d = jax.lax.scan(step, _carry(pN, width),
                        _stages(A, Bm, c, hf, P, K, Hinv), reverse=True)
    return jnp.moveaxis(d, 0, 1)


def _forward_xla(A, Bm, c, K, d, x0):
    width = _width(A, Bm, c, K, d, x0)

    def step(x, xs_k):
        Ak, Bk, ck, Kk, dk = xs_k
        u = _xmv(Kk, x) + dk
        x_next = _xmv(Ak, x) + _xmv(Bk, u) + ck
        return x_next, jnp.concatenate(
            [u, jnp.broadcast_to(x, u.shape[:-1] + x.shape[-1:])], -1)

    xN, ws = jax.lax.scan(step, _carry(x0, width),
                          _stages(A, Bm, c, K, d))
    return jnp.moveaxis(ws, 0, 1), xN


# ------------------------------------------------------------ public sweeps

def backward(A, B, c, H, h, D, rho, rg, PN, pN, *, export_factors=False,
             impl=None):
    """Factorizing backward sweep; all arrays batch-leading.

    A (W,N,nx,nx), B (W,N,nx,nu), c (W,N,nx), H (W,N,nz,nz) symmetric,
    h (W,N,nz), D (W,N,nc,nz), rho/rg (W,N,nc) the per-row penalty and
    rho*g, PN (W,nx,nx) / pN (W,nx) the folded terminal cost-to-go.
    W is the batch, or 1 for a shared tensor.  D/rho/rg may be None (no
    constraint rows).

    Returns (K (B,N,nu,nx), d (B,N,nu)), plus the factors
    (P_{k+1} (B,N,nx,nx), Huu^{-1} (B,N,nu,nu)) with ``export_factors``.
    """
    if D is not None and D.shape[-2] == 0:
        D = rho = rg = None
    N, nx, nu = A.shape[1], A.shape[-1], B.shape[-1]
    nc = 0 if D is None else D.shape[-2]
    impl = choose_impl(nx, impl)
    if impl == "xla":
        return _backward_xla(A, B, c, H, h, D, rho, rg, PN, pN,
                             export_factors)
    ins = (A, B, c, H, h) + ((D, rho, rg) if nc else ()) + (PN, pN)
    outs = [(N, nu, nx), (N, nu)]
    if export_factors:
        outs += [(N, nx, nx), (N, nu, nu)]
    return _pallas(
        functools.partial(_backward_kernel, N, nx, nu, nc, export_factors),
        ins, outs, _width(*ins), PN.dtype, nx, impl == "interpret",
        "riccati_backward")


def backward_vectors(A, B, c, hf, P, K, Hinv, pN, *, impl=None):
    """Cached-factor vector sweep -> d (B, N, nu).

    ``hf`` (W, N, nz) is the fully iterate-folded linear cost
    h - sigma w - D^T (rho g); (P, K, Hinv) come from
    ``backward(export_factors=True)`` at the same rho; pN (W, nx) is
    the folded terminal linear cost.  Per stage:

      Pcp = P_{k+1} c + p ;  rbar = hf_u + B^T Pcp ;
      d = -Huu^{-1} rbar ;  p = hf_x + A^T Pcp + K^T rbar.
    """
    N, nx, nu = A.shape[1], A.shape[-1], B.shape[-1]
    impl = choose_impl(nx, impl)
    if impl == "xla":
        return _vectors_xla(A, B, c, hf, P, K, Hinv, pN)
    ins = (A, B, c, hf, P, K, Hinv, pN)
    (d,) = _pallas(functools.partial(_vectors_kernel, N, nx, nu), ins,
                   [(N, nu)], _width(*ins), pN.dtype, nx,
                   impl == "interpret", "riccati_vectors")
    return d


def forward(A, B, c, K, d, x0, *, impl=None):
    """Closed-loop rollout u = K x + d, x+ = A x + B u + c.

    Returns (ws (B, N, nz) with rows [u; x], xN (B, nx))."""
    N, nx, nu = A.shape[1], A.shape[-1], B.shape[-1]
    impl = choose_impl(nx, impl)
    if impl == "xla":
        return _forward_xla(A, B, c, K, d, x0)
    ins = (A, B, c, K, d, x0)
    return _pallas(functools.partial(_forward_kernel, N, nx, nu), ins,
                   [(N, nx + nu), (nx,)], _width(*ins), x0.dtype, nx,
                   impl == "interpret", "riccati_forward")


# ------------------------------------------------------- whole inner solves

def stack_terminal(ws, xN, nu):
    """ws (B, N, nz), xN (B, nx) -> (B, N+1, nz) with u_N = 0."""
    wN = jnp.concatenate([jnp.zeros(xN.shape[:-1] + (nu,), xN.dtype), xN],
                         axis=-1)
    return jnp.concatenate([ws, wN[:, None]], axis=1)


def solve_batched(problem, it, x0, sigma: float, *, impl=None):
    """Batched inner solve of a batched problem (leading batch axis B).

    problem/it: standard batched pytrees; x0 (B, nx).  Returns
    ws (B, N+1, nz) like every other backend.
    """
    from pdp_lqr_tpu.problem import make_stage_params

    nu = problem.nu
    params = jax.vmap(lambda p, i: make_stage_params(p, i, sigma))(
        problem, it)
    HN = params.H[:, -1, nu:, nu:]
    hN = params.h[:, -1, nu:]
    if problem.nc > 0:
        DN, rhoN = problem.D[:, -1, :, nu:], it.rho[:, -1]
        HN = HN + jnp.einsum("bci,bc,bcj->bij", DN, rhoN, DN,
                             precision=HIGHEST)
        hN = hN - jnp.einsum("bci,bc->bi", DN, rhoN * params.g[:, -1],
                             precision=HIGHEST)
    K, d = backward(
        problem.A, problem.B, problem.c, params.H[:, :-1],
        params.h[:, :-1], problem.D[:, :-1], it.rho[:, :-1],
        it.rho[:, :-1] * params.g[:, :-1], HN, hN, impl=impl)
    ws, xN = forward(problem.A, problem.B, problem.c, K, d, x0, impl=impl)
    return stack_terminal(ws, xN, nu)


def prepare_shared(problem, it, x0, sigma: float):
    """Data for ONE shared model serving B scenarios.

    The reference holds one ``LQRModel`` per process behind all solvers
    (lqr_model.hpp:66-89); a scenario batch against it never pays B
    copies of the stage matrices:

      * ``problem`` is UNBATCHED — except ``c``, which may carry a
        leading batch axis (B, N, nx) for per-scenario drift;
      * ``it.rho`` must be UNBATCHED (N+1, nc): the folded matrices are
        shared only while the penalty is; w/y/z may be batched;
      * ``x0`` (B, nx) sets the batch size.

    Shared tensors get a leading axis of 1.  Returns the dict that
    ``shared_factors`` and ``solve_shared_cached`` take.
    """
    nu, nx, nc, N = problem.nu, problem.nx, problem.nc, problem.N
    nz = nu + nx
    dt = problem.H.dtype
    if problem.A.ndim != 3:
        raise ValueError(
            "prepare_shared takes an UNBATCHED problem (one shared "
            "model); use solve_batched for per-instance models")
    rho = it.rho
    if rho.ndim != 2:
        raise ValueError(
            "prepare_shared needs a shared (unbatched) rho (N+1, nc): "
            "the folded stage matrices are shared only while the "
            "penalty is")
    x0 = jnp.asarray(x0, dt)
    Bt = x0.shape[0]

    # Per-instance linear cost with the whole iterate fold applied
    # (update_problem_data, lqr_solver.hpp:41-56): the matrix sweep runs
    # on zero vectors and the vector sweep carries the linear recursion.
    bc = lambda x, tail: jnp.broadcast_to(x, (Bt,) + tail)
    hf = problem.h[None] - sigma * bc(it.w, (N + 1, nz))
    if nc > 0:
        inv_rho = jnp.where(rho > 0, 1.0 / jnp.where(rho > 0, rho, 1.0),
                            0.0)
        g = bc(it.z, (N + 1, nc)) - inv_rho[None] * bc(it.y, (N + 1, nc))
        hf = hf - jnp.einsum("kcz,bkc->bkz", problem.D, rho[None] * g,
                             precision=HIGHEST)
    c = problem.c if problem.c.ndim == 3 else problem.c[None]

    PN = problem.H[-1, nu:, nu:] + sigma * jnp.eye(nx, dtype=dt)
    if nc > 0:
        DNx = problem.D[-1, :, nu:]
        PN = PN + jnp.einsum("ci,c,cj->ij", DNx, rho[-1], DNx,
                             precision=HIGHEST)
    return dict(
        A=problem.A[None], B=problem.B[None], c=c,
        H=(problem.H[:-1] + sigma * jnp.eye(nz, dtype=dt))[None],
        D=problem.D[None, :-1], rho=rho[None, :-1], PN=PN[None],
        hf=hf[:, :-1], pN=hf[:, -1, nu:], x0=x0, nu=nu)


def shared_factors(prep, *, impl=None):
    """The matrix half of a shared solve: (K, P, Huu^{-1}), each shared
    (leading axis 1).  Valid while the model and rho are unchanged —
    the reference's factorization state (lqr_kernel.hpp:93-101)."""
    A, H, rho = prep["A"], prep["H"], prep["rho"]
    N, nx, nz = A.shape[1], A.shape[-1], H.shape[-1]
    zeros = lambda *s: jnp.zeros((1, N) + s, A.dtype)
    K, _, P, Hinv = backward(
        A, prep["B"], zeros(nx), H, zeros(nz), prep["D"], rho,
        jnp.zeros_like(rho), prep["PN"], jnp.zeros((1, nx), A.dtype),
        export_factors=True, impl=impl)
    return K, P, Hinv


def solve_shared_cached(prep, factors, *, impl=None):
    """Shared solve on pre-built factors: vector sweep + rollout."""
    K, P, Hinv = factors
    A, Bm, c = prep["A"], prep["B"], prep["c"]
    d = backward_vectors(A, Bm, c, prep["hf"], P, K, Hinv, prep["pN"],
                         impl=impl)
    ws, xN = forward(A, Bm, c, K, d, prep["x0"], impl=impl)
    return stack_terminal(ws, xN, prep["nu"])


def solve_shared(problem, it, x0, sigma: float, *, impl=None):
    """Shared-model batched solve (see prepare_shared for the contract).
    Returns ws (B, N+1, nz), matching solve_batched on a broadcast batch."""
    prep = prepare_shared(problem, it, x0, sigma)
    return solve_shared_cached(prep, shared_factors(prep, impl=impl),
                               impl=impl)
