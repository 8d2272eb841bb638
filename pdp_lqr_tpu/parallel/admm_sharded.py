"""Pod-scale conic ADMM: the full outer loop under shard_map.

Composes the ADMM iteration (solvers/admm.py math) with the multi-device
PDP inner solve (the segment scans of ops/riccati_pdp) on a
("batch", "time") mesh:

  * problem instances shard over "batch" (pure data parallelism);
  * the horizon shards over "time" exactly like the reference's
    OpenMP segments (lqr_solver_parallel.hpp:70-146), with one
    boundary all-gather per iteration;
  * projections and dual updates are stage-local (zero collectives);
  * per-instance residual maxima reduce with one pmax over "time";
  * ``cached_factors`` ports the parallel solver's
    with/without-factorization split
    (lqr_solver_parallel.hpp:148-154,190-211): each
    rho_update_interval-long chunk factors the segment matrices and the
    condensed system ONCE (segment_factors_local) and runs vector-only
    sweeps (segment_solve_cached) for the rest — the boundary exchange
    shrinks to the (p0, f0) vectors;
  * ``early_exit`` replaces the fixed-trip scan with a while_loop whose
    continue flag is an all-mesh ``pmin`` of per-instance convergence
    computed in the body — every device sees the identical flag, so
    divergent trip counts (the old deadlock concern) cannot happen.
    With cached_factors the exit granularity is one chunk.

Iterate layout inside the loop: stage rows (w, z, y) live as local
(Bl, Nl, ...) shards; terminal rows are replicated over "time" (every
device computes the identical terminal update from the psum'd terminal
state — cheaper than a dedicated exchange for one row of data).

This is BASELINE config #4 at fleet scale: the whole constrained conic
solve, not just the inner KKT step, scales across the mesh.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pdp_lqr_tpu.config import f32_matmul_precision
from pdp_lqr_tpu.ops import condensed, linalg, projections, riccati_pdp
from pdp_lqr_tpu.problem import LQRProblem
from pdp_lqr_tpu.solvers.admm import ADMMInfo, ADMMSettings

_CACHE: dict = {}


# ---------------------------------------------- segment pieces (XLA scans)
# One "time" device's share of the PDP inner solve, inside a shard_map
# body with a "time" axis of size S.  Arguments in the lanes layout
# (Nl, ..., Bl) of the loop below; the per-instance math runs
# batch-leading through the segment scans of ops/riccati_pdp.

def _bl(x):
    """Lanes (Nl, ..., Bl) -> batch-leading (Bl, Nl, ...)."""
    return jnp.moveaxis(x, -1, 0)


def _gather_time(x):
    """(Bl, ...) per device -> (Bl, S, ...) over the "time" axis."""
    return jnp.moveaxis(jax.lax.all_gather(x, "time", axis=0), 0, 1)


def _reduce(S, A, B, c, Hf, hf, PNb, pNb):
    """Segment Riccati reduction, batch-leading folded stage data.

    The last segment starts from the terminal cost-to-go; the others
    from the zero boundary node (lqr_kernel_parallel.hpp:51-67)."""
    is_last = jax.lax.axis_index("time") == S - 1
    w = is_last.astype(A.dtype)
    nx = A.shape[-1]

    def one(Ak, Bk, ck, Hk, hk, PN, pN):
        carry0 = (w * linalg.cholesky(PN), w * pN,
                  jnp.eye(nx, dtype=A.dtype),
                  jnp.zeros((nx, nx), A.dtype), jnp.zeros((nx,), A.dtype))
        carry, (L, lp, G, Fn) = jax.lax.scan(
            riccati_pdp._segment_backward_step, carry0,
            (Ak, Bk, ck, Hk, hk), reverse=True)
        Lxx0, p0, F0, C0, f0 = carry
        return L, lp, G, Fn, Lxx0 @ Lxx0.T, F0, C0, p0, f0

    return jax.vmap(one)(A, B, c, Hf, hf, PNb, pNb)


def _rollout(S, A, B, c, L, lp, G, xhat, uhat):
    """Per-segment rollout from the condensed boundary solution
    (lqr_solver_parallel.hpp:217-237); returns (ws_l (Nl, nz, Bl),
    xN (Bl, nx) replicated over "time")."""
    i = jax.lax.axis_index("time")
    nu = B.shape[-1]

    def one(x0_seg, uh, Ak, Bk, ck, Lk, lpk, Gk):
        def step(x, stage):
            Aj, Bj, cj, Lj, lpj, Gj = stage
            u = -(lpj[:nu] + Lj[nu:, :nu].T @ x) + Gj @ uh
            u = linalg.solve_lower_T(Lj[:nu, :nu], u)
            return Aj @ x + Bj @ u + cj, jnp.concatenate([u, x])

        return jax.lax.scan(step, x0_seg, (Ak, Bk, ck, Lk, lpk, Gk))

    x_end, ws = jax.vmap(one)(jnp.take(xhat, i, axis=1),
                              jnp.take(uhat, i, axis=1),
                              A, B, c, L, lp, G)
    xN = jax.lax.psum(jnp.where(i == S - 1, x_end, jnp.zeros_like(x_end)),
                      "time")
    return jnp.moveaxis(ws, 0, -1), xN


def segment_solve_local(S, A_l, B_l, c_l, H_l, h_l, D_l, rho_l, rg_l,
                        PNb, pNb, x0):
    """Full PDP inner solve: fold, segment reduction, boundary
    all-gather, replicated condensed solve, rollout.  PNb/pNb
    (Bl, nx[, nx]) is the folded terminal cost (read by the last
    device only)."""
    A, B, c, H, h = (_bl(x) for x in (A_l, B_l, c_l, H_l, h_l))
    D, rho, rg = _bl(D_l), _bl(rho_l), _bl(rg_l)
    Hf = H + jnp.einsum("bkci,bkc,bkcj->bkij", D, rho, D)
    hf = h - jnp.einsum("bkci,bkc->bki", D, rg)
    L, lp, G, _, P0, F0, C0, p0, f0 = _reduce(S, A, B, c, Hf, hf, PNb, pNb)
    fac = condensed.cholesky_backward(
        _gather_time(P0), _gather_time(F0), _gather_time(C0))
    xhat, uhat = condensed.cholesky_forward(
        fac, _gather_time(p0), _gather_time(f0), x0)
    return _rollout(S, A, B, c, L, lp, G, xhat, uhat)


def segment_factors_local(S, A_l, B_l, H_l, D_l, rho_l, PNb):
    """Matrix half of the PDP solve at the current rho — the cached
    half of the with/without-factorization split
    (lqr_solver_parallel.hpp:148-154).  Returns an opaque pytree for
    segment_solve_cached."""
    A, B, H, D, rho = (_bl(x) for x in (A_l, B_l, H_l, D_l, rho_l))
    Bl, Nl, nx = A.shape[0], A.shape[1], A.shape[-1]
    Hf = H + jnp.einsum("bkci,bkc,bkcj->bkij", D, rho, D)
    zeros = lambda *s: jnp.zeros((Bl, Nl) + s, A.dtype)
    L, _, G, Fn, P0, F0, C0, _, _ = _reduce(
        S, A, B, zeros(nx), Hf, zeros(Hf.shape[-1]), PNb,
        jnp.zeros((Bl, nx), A.dtype))
    is_last = jax.lax.axis_index("time") == S - 1
    LxxN = is_last.astype(A.dtype) * linalg.cholesky(PNb)
    fac = condensed.cholesky_backward(
        _gather_time(P0), _gather_time(F0), _gather_time(C0))
    return (L, G, Fn, LxxN, fac)


def segment_solve_cached(S, factors, A_l, B_l, c_l, hf_l, pNb, x0):
    """Vector-only PDP solve on cached factors
    (lqr_solver_parallel.hpp:190-211 + the cached condensed forward).
    ``hf_l`` (Nl, nz, Bl) is the fully folded linear cost
    h - sigma w - D^T (rho g); pNb (Bl, nx) its terminal row."""
    L, G, Fn, LxxN, fac = factors
    A, B, c, hf = (_bl(x) for x in (A_l, B_l, c_l, hf_l))
    nu = B.shape[-1]
    is_last = jax.lax.axis_index("time") == S - 1
    # Cached Lxx_{k+1} per stage: the next stage's factor, and at the
    # segment end the boundary node (zero unless last segment).
    Lxx_next = jnp.concatenate([L[:, 1:, nu:, nu:], LxxN[:, None]], axis=1)

    def one(pN, Ak, Bk, ck, hk, Lk, Lxxk, Fk):
        def step(carry, stage):
            p_next, f_next = carry
            Aj, Bj, cj, hj, Lj, Lxxn, Fj = stage
            Pb = Lxxn @ (Lxxn.T @ cj) + p_next
            lpj = hj + jnp.concatenate([Bj, Aj], axis=-1).T @ Pb
            lu = linalg.solve_lower(Lj[:nu, :nu], lpj[:nu])
            p = lpj[nu:] - Lj[nu:, :nu] @ lu
            d = linalg.solve_lower_T(Lj[:nu, :nu], -lu)
            f = Fj @ (cj + Bj @ d) + f_next
            return (p, f), jnp.concatenate([lu, p])

        p0 = is_last.astype(A.dtype) * pN
        (p_s, f_s), lp = jax.lax.scan(
            step, (p0, jnp.zeros_like(pN)),
            (Ak, Bk, ck, hk, Lk, Lxxk, Fk), reverse=True)
        return lp, p_s, f_s

    lp, p0, f0 = jax.vmap(one)(pNb, A, B, c, hf, L, Lxx_next, Fn)
    xhat, uhat = condensed.cholesky_forward(
        fac, _gather_time(p0), _gather_time(f0), x0)
    return _rollout(S, A, B, c, L, lp, G, xhat, uhat)


def _build(mesh: Mesh, nu: int, nc: int,
           cones: Tuple[projections.ConeSpec, ...],
           settings: ADMMSettings, has_shift: bool):
    S = mesh.shape["time"]
    sigma = settings.sigma
    alpha = settings.alpha

    @f32_matmul_precision
    def body(A, B, c, H, h, D, lb, ub, shift,
             HN, hN, DN, lbN, ubN, shiftN,
             x0, w0, z0, y0, wN0, zN0, yN0, rho0):
        # Stage shards (Bl, Nl, ...); terminal blocks (Bl, ...)
        # replicated over "time"; rho0 (Bl,).
        dt = A.dtype
        nx = A.shape[-1]
        nz = nu + nx
        Bl, Nl = A.shape[0], A.shape[1]

        lanes3 = lambda x: jnp.transpose(x, (1, 2, 3, 0))
        lanes2 = lambda x: jnp.transpose(x, (1, 2, 0))

        # Static lanes layouts (live across the whole loop).  The
        # whole iteration — folds, projections, duals, residuals —
        # runs batch-in-lanes (r5, VERDICT #6): the old batch-leading
        # (Bl, Nl, nc) elementwise tails put nc on the 128-lane tile
        # (8x padding) and dominated the iteration cost.
        A_l, B_l, c_l = lanes3(A), lanes3(B), lanes2(c)
        Hs_l = lanes3(H + sigma * jnp.eye(nz, dtype=dt))
        D_l = lanes3(D)
        h_l = lanes2(h)
        lb_l, ub_l = lanes2(lb), lanes2(ub)
        # shift is stage rows, UNBATCHED (Nl, nc): broadcast on lanes.
        sh_l = shift[:, :, None] if has_shift else None
        HNs = HN[:, nu:, nu:] + sigma * jnp.eye(nx, dtype=dt)
        DNx = DN[:, :, nu:]

        mask = jnp.any(D != 0, axis=-1).astype(dt)       # (Bl, Nl, nc)
        maskN = jnp.any(DN != 0, axis=-1).astype(dt)     # (Bl, nc)
        for off, dim, _ in projections.normalize_cones(cones):
            blk = jnp.any(mask[..., off:off + dim] > 0, axis=-1,
                          keepdims=True).astype(dt)
            mask = mask.at[..., off:off + dim].set(
                jnp.broadcast_to(blk, mask[..., off:off + dim].shape))
            blkN = jnp.any(maskN[..., off:off + dim] > 0, axis=-1,
                           keepdims=True).astype(dt)
            maskN = maskN.at[..., off:off + dim].set(
                jnp.broadcast_to(blkN, maskN[..., off:off + dim].shape))

        # Per-row rho (the reference's rho_vecs interface): equality
        # rows run at rho * rho_eq_boost (OSQP 5.2).
        boost = jnp.asarray(settings.rho_eq_boost, dt)
        rsc = mask * jnp.where(jnp.isfinite(lb) & (lb == ub), boost, 1.0)
        rscN = maskN * jnp.where(
            jnp.isfinite(lbN) & (lbN == ubN), boost, 1.0)
        rsc_l = lanes2(rsc)                              # (Nl, nc, Bl)
        mask_l = lanes2(mask)

        # Unrolled lanes constraint ops (compact (rows, Bl) tiles; the
        # pattern measured ~12x faster in solvers/admm.solve_fused).
        def Dw_l(w):                       # (Nl, nc, Bl) = D w
            acc = D_l[:, :, 0, :] * w[:, None, 0, :]
            for zi in range(1, nz):
                acc = acc + D_l[:, :, zi, :] * w[:, None, zi, :]
            return acc

        def DTv_l(vc):                     # (Nl, nz, Bl) = D^T vc
            if nc == 0:
                return jnp.zeros((Nl, nz, Bl), dt)
            acc = D_l[:, 0, :, :] * vc[:, 0, None, :]
            for ci in range(1, nc):
                acc = acc + D_l[:, ci, :, :] * vc[:, ci, None, :]
            return acc

        def Hw_l(wv):                      # (Nl, nz, Bl) = (Hs-sigma) w
            acc = Hs_l[:, :, 0, :] * wv[:, None, 0, :]
            for zi in range(1, nz):
                acc = acc + Hs_l[:, :, zi, :] * wv[:, None, zi, :]
            return acc - sigma * wv

        def project_l(v):
            out = jnp.clip(v, lb_l, ub_l)
            for off, dim, kind in projections.normalize_cones(cones):
                blk = v[:, off:off + dim, :]
                if has_shift:
                    s = sh_l[:, off:off + dim, :]
                    blk = projections.project_cone(
                        blk + s, kind, axis=-2) - s
                else:
                    blk = projections.project_cone(blk, kind, axis=-2)
                out = out.at[:, off:off + dim, :].set(blk)
            return out

        DwN = lambda w: jnp.einsum("bcz,bz->bc", DN, w)
        DTvN = lambda vc: jnp.einsum("bcz,bc->bz", DN, vc)

        def projectN(v, lo, hi, sh):
            out = jnp.clip(v, lo, hi)
            for off, dim, kind in projections.normalize_cones(cones):
                blk = v[..., off:off + dim]
                if has_shift:
                    s = sh[..., off:off + dim]
                    blk = projections.project_cone(blk + s, kind, axis=-1) - s
                else:
                    blk = projections.project_cone(blk, kind, axis=-1)
                out = out.at[..., off:off + dim].set(blk)
            return out

        pmax_t = lambda x: jax.lax.pmax(x, "time")

        def x_update(w_l, z_l, y_l, wN, zN, yN, rho, factors):
            """Inner KKT solve (reference update_problem_data +
            backward + forward) through the sharded fused-PDP path —
            cached (vector-only) when factors are given.  Stage
            iterates are lanes-resident; only the terminal row (one
            stage, replicated over "time") stays batch-leading."""
            rho_row = rho[None, None, :]
            rho_vec = rho_row * rsc_l                     # (Nl, nc, Bl)
            rhoN_vec = rho[:, None] * rscN
            inv_rho = jnp.where(
                rsc_l > 0, 1.0 / jnp.maximum(rho_vec, 1e-30), 0.0)
            inv_rhoN = jnp.where(
                rscN > 0, 1.0 / jnp.maximum(rhoN_vec, 1e-30), 0.0)
            g = z_l - inv_rho * y_l
            gN = zN - inv_rhoN * yN

            h_t = h_l - sigma * w_l                       # (Nl, nz, Bl)
            hN_t = hN.at[:, :nu].set(0.0) - sigma * (
                wN.at[:, :nu].set(0.0))
            pNb = hN_t[:, nu:] - jnp.einsum(
                "bci,bc->bi", DNx, rhoN_vec * gN)

            if factors is None:
                # Terminal penalty fold in x-block form (same math as
                # the pdp_sharded terminal step, pre-sliced DNx).
                PNb = HNs + jnp.einsum(
                    "bci,bc,bcj->bij", DNx, rhoN_vec, DNx)
                ws_l, xN = segment_solve_local(
                    S, A_l, B_l, c_l, Hs_l, h_t, D_l,
                    rho_vec, rho_vec * g, PNb, pNb, x0,
                )
            else:
                hf = h_t - DTv_l(rho_vec * g)
                ws_l, xN = segment_solve_cached(
                    S, factors,
                    A_l, B_l, c_l, hf, pNb, x0,
                )
            wN_t = jnp.concatenate(
                [jnp.zeros((Bl, nu), dt), xN], axis=-1)
            return ws_l, wN_t, rho_vec, rhoN_vec, inv_rho, inv_rhoN

        def iteration(carry, factors=None):
            w_l, z_l, y_l, wN, zN, yN, rho, stats = carry
            k_it, iter_conv, _, _, _, _ = stats
            (w_t, wN_t, rho_vec, rhoN_vec,
             inv_rho, inv_rhoN) = x_update(w_l, z_l, y_l, wN, zN, yN,
                                           rho, factors)

            z_t, zN_t = Dw_l(w_t), DwN(wN_t)
            w_new = alpha * w_t + (1.0 - alpha) * w_l
            wN_new = alpha * wN_t + (1.0 - alpha) * wN
            v = alpha * z_t + (1.0 - alpha) * z_l + inv_rho * y_l
            vN = alpha * zN_t + (1.0 - alpha) * zN + inv_rhoN * yN
            z_new = project_l(v) * mask_l
            zN_new = projectN(vN, lbN, ubN, shiftN) * maskN
            y_new = y_l + rho_vec * (
                alpha * z_t + (1.0 - alpha) * z_l - z_new)
            yN_new = yN + rhoN_vec * (
                alpha * zN_t + (1.0 - alpha) * zN - zN_new)

            # Residuals: local partial maxima + one pmax over "time".
            # Terminal rows are replicated, so folding them into the
            # local max before the pmax is exact.
            am = lambda x: jnp.max(jnp.abs(x), axis=(0, 1))      # (Bl,)
            amN = lambda x: jnp.max(jnp.abs(x), axis=-1)
            r_prim = pmax_t(jnp.maximum(
                am((Dw_l(w_new) - z_new) * mask_l),
                amN((DwN(wN_new) - zN_new) * maskN)))
            dw = w_l - w_t
            dwN = wN - wN_t
            Hdw = Hw_l(dw)
            HdwN = jnp.einsum("bij,bj->bi", HN[:, nu:, nu:], dwN[:, nu:])
            zt_term = rho_vec * (
                (alpha - 1.0) * (z_t - z_l) + (z_l - z_new))
            ztN_term = rhoN_vec * (
                (alpha - 1.0) * (zN_t - zN) + (zN - zN_new))
            dvec = (1.0 - alpha) * Hdw + sigma * dw + DTv_l(zt_term)
            dvecN = jnp.concatenate([
                jnp.zeros((Bl, nu), dt),
                (1.0 - alpha) * HdwN + sigma * dwN[:, nu:],
            ], axis=-1) + DTvN(ztN_term)
            r_dual = pmax_t(jnp.maximum(am(dvec), amN(dvecN)))

            Hw_new = Hw_l(w_new)
            HwN_new = jnp.einsum(
                "bij,bj->bi", HN[:, nu:, nu:], wN_new[:, nu:])
            prim_scale = pmax_t(jnp.maximum(
                jnp.maximum(am(Dw_l(w_new) * mask_l), am(z_new)),
                jnp.maximum(amN(DwN(wN_new) * maskN), amN(zN_new))))
            dual_scale = pmax_t(jnp.maximum(
                jnp.maximum(am(Hw_new), amN(HwN_new)),
                jnp.maximum(
                    jnp.maximum(am(DTv_l(y_new)), amN(DTvN(yN_new))),
                    jnp.maximum(am(h_l), amN(hN)))))
            conv = (r_prim <= settings.eps_abs
                    + settings.eps_rel * prim_scale) \
                & (r_dual <= settings.eps_abs
                   + settings.eps_rel * dual_scale)

            k_next = k_it + 1
            iter_conv = jnp.where(conv & (iter_conv < 0),
                                  k_next, iter_conv)
            if settings.adaptive_rho:
                tiny = jnp.asarray(1e-12, dt)
                rp_rel = r_prim / jnp.maximum(prim_scale, tiny)
                rd_rel = r_dual / jnp.maximum(dual_scale, tiny)
                ratio = jnp.sqrt(jnp.maximum(rp_rel, tiny)
                                 / jnp.maximum(rd_rel, tiny))
                interval = max(1, settings.rho_update_interval)
                upd = ((ratio > 5.0) | (ratio < 0.2)) \
                    & (k_next % interval == 0)
                rho = jnp.where(
                    upd,
                    jnp.clip(rho * ratio, settings.rho_min,
                             settings.rho_max),
                    rho)

            # Global convergence flag: identical on every device of the
            # mesh (pmin over BOTH axes), so while_loop trip counts can
            # never diverge across shards.
            all_conv = jax.lax.pmin(
                jnp.all(conv).astype(jnp.int32), ("batch", "time"))
            stats = (k_next, iter_conv, r_prim, r_dual, conv, all_conv)
            carry = (w_new, z_new, y_new, wN_new, zN_new, yN_new,
                     rho, stats)
            return carry

        def build_factors(carry):
            """Segment + condensed matrix factorization at the carry's
            current rho (iterate-independent)."""
            rho = carry[6]
            rhoN_vec = rho[:, None] * rscN
            PNb = HNs + jnp.einsum("bci,bc,bcj->bij", DNx, rhoN_vec, DNx)
            rho_vec = rho[None, None, :] * rsc_l
            return segment_factors_local(
                S, A_l, B_l, Hs_l, D_l, rho_vec, PNb)

        stats0 = (
            jnp.asarray(0, jnp.int32), jnp.full((Bl,), -1, jnp.int32),
            jnp.full((Bl,), jnp.inf, dt), jnp.full((Bl,), jnp.inf, dt),
            jnp.zeros((Bl,), bool), jnp.asarray(0, jnp.int32),
        )
        carry0 = (lanes2(w0), lanes2(z0), lanes2(y0),
                  wN0, zN0, yN0, rho0, stats0)
        max_iter = settings.max_iter
        interval = max(1, settings.rho_update_interval)

        if settings.cached_factors:
            # Chunked loop on the rho cadence: rho can only move at
            # multiples of the interval (allow_rho_update gates the
            # in-iteration rule), so factors built at a chunk start
            # stay valid for the whole chunk — the fixed-cadence
            # pattern of solvers/admm.solve, collective-safe because
            # every device runs the identical chunk schedule.
            def run_chunk(carry, n_iters):
                # Only a chunk's LAST iteration can move rho (the
                # k % interval == 0 gate inside iteration), so the
                # factors stay valid for the whole chunk.
                factors = build_factors(carry)
                carry, _ = jax.lax.scan(
                    lambda c, _: (iteration(c, factors), None),
                    carry, None, length=n_iters)
                return carry

            n_chunks = -(-max_iter // interval)
            tail = max_iter - (n_chunks - 1) * interval
            if settings.early_exit:
                def cond(c):
                    k_it, all_conv = c[7][0], c[7][5]
                    return (k_it < (n_chunks - 1) * interval) \
                        & (all_conv == 0)

                carry = jax.lax.while_loop(
                    cond, lambda c: run_chunk(c, interval), carry0)
                # Tail chunk (may be shorter), fixed-trip.
                def tail_if_needed(c):
                    k_it, all_conv = c[7][0], c[7][5]
                    need = (k_it < max_iter) & (all_conv == 0)
                    return jax.lax.cond(
                        need, lambda cc: run_chunk(cc, tail),
                        lambda cc: cc, c)
                carry = tail_if_needed(carry)
            else:
                if n_chunks > 1:
                    carry, _ = jax.lax.scan(
                        lambda c, _: (run_chunk(c, interval), None),
                        carry0, None, length=n_chunks - 1)
                else:
                    carry = carry0
                carry = run_chunk(carry, tail)
        elif settings.early_exit:
            def cond(c):
                k_it, all_conv = c[7][0], c[7][5]
                return (k_it < max_iter) & (all_conv == 0)

            carry = jax.lax.while_loop(
                cond, lambda c: iteration(c), carry0)
        else:
            carry, _ = jax.lax.scan(
                lambda c, _: (iteration(c), None), carry0, None,
                length=max_iter)

        w_l, z_l, y_l, wN, zN, yN, rho, stats = carry
        k_it, iter_conv, r_prim, r_dual, conv, _ = stats
        unlanes = lambda x: jnp.transpose(x, (2, 0, 1))  # (Bl, Nl, ...)
        return (unlanes(w_l), wN, unlanes(z_l), zN, unlanes(y_l), yN,
                rho,
                jnp.broadcast_to(k_it, (Bl,)), iter_conv,
                r_prim, r_dual, conv)

    stage = P("batch", "time")
    term = P("batch")
    in_specs = (
        (stage,) * 8                              # A B c H h D lb ub
        + (P("time") if has_shift else P(),)      # shift (stage rows,
                                                  #  unbatched)
        + (term,) * 5                             # HN hN DN lbN ubN
        + (P(),)                                  # shiftN (unbatched)
        + (term,)                                 # x0
        + (stage, stage, stage)                   # w0 z0 y0
        + (term, term, term)                      # wN0 zN0 yN0
        + (term,)                                 # rho0
    )
    out_specs = (
        stage, term, stage, term, stage, term, term,
        term, term, term, term, term,
    )
    f = jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                      out_specs=out_specs, check_vma=False)
    return jax.jit(f)


def solve(
    mesh: Mesh,
    problem: LQRProblem,
    x0,
    cones: Sequence[projections.ConeSpec] = (),
    settings: ADMMSettings = ADMMSettings(),
    state=None,
    soc_shift=None,
):
    """Pod-sharded conic ADMM solve of a batch of problems.

    problem/x0: batched pytrees (leading axis B divisible by the
    "batch" mesh size; horizon N divisible by the "time" size).
    ``state`` warm-starts from a previous solve's returned state.

    ``settings.cached_factors`` enables the parallel solver's
    with/without-factorization split on the sharded loop;
    ``settings.early_exit`` stops the whole mesh once EVERY instance
    converges (all-mesh pmin — safe under shard_map).

    Returns (ws (B, N+1, nz), ADMMState (batched), ADMMInfo (batched)).
    """
    from pdp_lqr_tpu.solvers.admm import ADMMState

    cones = tuple(cones)
    dt = problem.H.dtype
    Bb = problem.h.shape[0]
    nu, nc, nx = problem.nu, problem.nc, problem.nx
    has_shift = soc_shift is not None

    key = (mesh, nu, nc, cones, settings, has_shift)
    if key not in _CACHE:
        _CACHE[key] = _build(mesh, nu, nc, cones, settings, has_shift)
    fn = _CACHE[key]

    if state is None:
        w0 = jnp.zeros(problem.h.shape, dt)
        z0 = jnp.zeros(problem.e_lb.shape, dt)
        y0 = jnp.zeros(problem.e_lb.shape, dt)
        rho0 = jnp.full((Bb,), settings.rho, dt)
    else:
        w0, z0, y0 = state.w, state.z, state.y
        rho0 = jnp.broadcast_to(jnp.asarray(state.rho, dt), (Bb,))

    if has_shift:
        shift = jnp.asarray(soc_shift, dt)
        shift_s, shift_N = shift[:-1], shift[-1]
    else:
        z_sh = jnp.zeros((problem.N, nc), dt)
        shift_s, shift_N = z_sh, jnp.zeros((nc,), dt)

    out = fn(
        problem.A, problem.B, problem.c,
        problem.H[:, :-1], problem.h[:, :-1], problem.D[:, :-1],
        problem.e_lb[:, :-1], problem.e_ub[:, :-1], shift_s,
        problem.H[:, -1], problem.h[:, -1], problem.D[:, -1],
        problem.e_lb[:, -1], problem.e_ub[:, -1], shift_N,
        jnp.asarray(x0, dt),
        w0[:, :-1], z0[:, :-1], y0[:, :-1],
        w0[:, -1], z0[:, -1], y0[:, -1],
        rho0,
    )
    (w, wN, z, zN, y, yN, rho,
     k_it, iter_conv, r_prim, r_dual, conv) = out

    cat = lambda s, t: jnp.concatenate([s, t[:, None]], axis=1)
    w_full = cat(w, wN)
    z_full = cat(z, zN)
    y_full = cat(y, yN)
    info = ADMMInfo(
        iterations=k_it, r_prim=r_prim, r_dual=r_dual, converged=conv,
        iter_converged=jnp.where(iter_conv < 0, k_it, iter_conv),
    )
    return w_full, ADMMState(w=w_full, z=z_full, y=y_full, rho=rho), info
