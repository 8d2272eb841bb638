"""Replan latency vs the 1 kHz MPC budget (BASELINE.md metric #2).

Measures steady-state receding-horizon replan cost on one device with
the *delta method*: time K and 2K ADMM-iteration solves back-to-back and
report the marginal cost per iteration (it cancels the fixed dispatch
cost, which is also printed).

Usage: python examples/latency_mpc.py [--horizon N] [--admm-iters K]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np


def _time(fn, *args, reps=20):
    """Mean seconds per call after a warm (compiling) call; the window
    ends with block_until_ready."""
    out = jax.block_until_ready(fn(*args))
    assert bool(jnp.all(jnp.isfinite(jax.tree.leaves(out)[0])))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main():
    from pdp_lqr_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--horizon", type=int, default=64)
    ap.add_argument("--admm-iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--model", default="quadrotor",
                    choices=["quadrotor", "centroidal", "mass_spring"],
                    help="BASELINE.json config family (config #5 = "
                         "centroidal nx=24 at --horizon 1024)")
    ap.add_argument("--segments", type=int, default=0,
                    help="segments for the condensed realtime operator "
                         "(0 = auto ~ sqrt(M/2nx); must divide N)")
    ap.add_argument("--skip-xla", action="store_true",
                    help="skip the slow XLA B=1 section (long horizons)")
    ap.add_argument("--skip-dense-op", action="store_true",
                    help="skip the dense-operator path (OOM-scale M)")
    ap.add_argument("--skip-batch", action="store_true",
                    help="skip the fused-batch section (latency-only runs)")
    ap.add_argument("--bf16-op", action="store_true",
                    help="also time the bf16-storage operator (halves "
                         "the HBM-bound replan stream; ~1e-3 consistent "
                         "perturbation — serving mode)")
    args = ap.parse_args()

    from pdp_lqr_tpu.solvers import admm

    dtype = jnp.float32
    cones: tuple = ()
    if args.model == "quadrotor":
        from pdp_lqr_tpu.models import quadrotor

        problem, _ = quadrotor(N=args.horizon, constrained=True,
                               dtype=dtype)
    elif args.model == "centroidal":
        from pdp_lqr_tpu.models import centroidal

        problem, cone_list = centroidal(N=args.horizon, dtype=dtype)
        cones = tuple(cone_list)
    else:
        from pdp_lqr_tpu.models import mass_spring_chain

        problem = mass_spring_chain(n_masses=20, N=args.horizon,
                                    dtype=dtype)
    K = args.admm_iters
    M_flat = (args.horizon + 1) * problem.nz
    if M_flat > 12_000 and not args.skip_dense_op:
        # Dense T is M^2 floats (3.8 GB at centroidal N=1024) — the
        # condensed operator is the long-horizon embodiment.
        print(f"dense operator auto-skipped (M={M_flat}: T would be "
              f"{M_flat * M_flat * 4 / 1e9:.1f} GB)")
        args.skip_dense_op = True

    def settings(iters):
        return admm.ADMMSettings(
            max_iter=iters, rho_update_interval=iters,
            adaptive_rho=False, eps_abs=1e-4, eps_rel=1e-4,
        )

    # ---- single instance (XLA backend, B=1) -----------------------------
    x0 = jnp.zeros(problem.nx, dtype)
    if not args.skip_xla:
        f1 = jax.jit(lambda p, x: admm.solve(p, x, cones, settings(K))[0])
        f2 = jax.jit(lambda p, x: admm.solve(p, x, cones,
                                             settings(2 * K))[0])
        tK = _time(f1, problem, x0)
        t2K = _time(f2, problem, x0)
        per_iter = (t2K - tK) / K
        replan_ms = per_iter * K * 1e3
        print(f"single instance: {per_iter*1e6:.1f} us/ADMM-iter -> "
              f"{K}-iter warm replan ~= {replan_ms:.3f} ms "
              f"({'WITHIN' if replan_ms <= 1.0 else 'OVER'} "
              f"1 ms / 1 kHz budget)")

    # ---- real-time dense-operator path (solvers/realtime) ---------------
    # The 1 kHz production path: the inner solve is one (M, M) dense
    # matvec against a per-factorization materialized operator; the
    # replan is a while_loop with convergence exit.  Timed with the
    # early exit disabled (eps = 0) so exactly K iterations run.
    from pdp_lqr_tpu.solvers import realtime

    def rt_settings(iters):
        return admm.ADMMSettings(
            max_iter=iters, rho_update_interval=iters, rho=1.0,
            adaptive_rho=False, eps_abs=0.0, eps_rel=0.0,
        )

    state0 = admm.init_state(problem, rt_settings(K))

    def time_operator(op, label):
        # The operator must be a jit ARGUMENT, not a closure capture: a
        # captured operator becomes a program constant (gigabytes at
        # N=1024).
        r1 = jax.jit(lambda o, x, s: realtime.solve(
            problem, x, o, cones, rt_settings(K), s)[0])
        r2 = jax.jit(lambda o, x, s: realtime.solve(
            problem, x, o, cones, rt_settings(2 * K), s)[0])
        tK = _time(r1, op, x0, state0)
        t2K = _time(r2, op, x0, state0)
        per_iter = (t2K - tK) / K
        replan_ms = per_iter * K * 1e3
        fixed_ms = max(tK - per_iter * K, 0.0) * 1e3
        print(f"{label}: {per_iter*1e6:.1f} us/ADMM-iter -> "
              f"{K}-iter warm replan ~= {replan_ms:.3f} ms marginal "
              f"(+{fixed_ms:.3f} ms fixed dispatch) "
              f"({'WITHIN' if replan_ms <= 1.0 else 'OVER'} "
              f"1 ms / 1 kHz budget)")

    def time_rebuild(build_fn, label):
        """Operator REBUILD cost (VERDICT r3 #8): the rho-ladder's
        economics hinge on it — a rho step pays one rebuild, then every
        replan reuses (T, J, r).  Timed like everything else (delta-free
        single measure; the build is one program)."""
        # Reduce every operator leaf to one scalar so nothing is DCE'd
        # and the host fence has an array to pull.
        rb = jax.jit(lambda r: sum(
            jnp.sum(jnp.abs(leaf))
            for leaf in jax.tree.leaves(build_fn(r))))
        t_rb = _time(rb, jnp.asarray(1.0, dtype), reps=5)
        print(f"{label} rebuild: {t_rb*1e3:.3f} ms per rho change "
              f"(amortized over an interval-25 rho cadence: "
              f"{t_rb/25*1e6:.1f} us/iter)")

    if not args.skip_dense_op:
        op = realtime.build_operator(problem, rho=1.0,
                                     settings=rt_settings(K),
                                     cones=cones)
        time_operator(op, "realtime operator path")
        time_rebuild(
            lambda r: realtime.build_operator(
                problem, r, settings=rt_settings(K), cones=cones),
            "realtime operator",
        )

    # ---- condensed (segment-factored) operator ---------------------------
    # O(M^2) -> O(M^2/S + 2 M S nx) memory/bandwidth: the long-horizon
    # 1 kHz form (see realtime.CondensedOperator).
    N = args.horizon
    S = args.segments
    if S == 0:
        M = (N + 1) * problem.nz
        target = max(2, int(round((M / (2 * problem.nx)) ** 0.5)))
        S = max(s for s in range(2, N + 1) if N % s == 0 and s <= target)
    if N % S == 0:
        cop = realtime.build_condensed_operator(
            problem, rho=1.0, num_segments=S, settings=rt_settings(K),
            cones=cones)
        time_operator(cop, f"condensed operator (S={S}) path")
        if args.bf16_op:
            time_operator(realtime.cast_operator(cop, jnp.bfloat16),
                          f"condensed operator (S={S}, bf16) path")
        time_rebuild(
            lambda r: realtime.build_condensed_operator(
                problem, r, num_segments=S, settings=rt_settings(K),
                cones=cones),
            f"condensed operator (S={S})",
        )

    # ---- fused batch (admm.solve_fused) ----------------------------------
    if args.skip_batch:
        return
    B = args.batch
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), problem)
    x0s = jnp.zeros((B, problem.nx), dtype)
    g1 = jax.jit(lambda p, x: admm.solve_fused(p, x, cones, settings(K))[0])
    g2 = jax.jit(lambda p, x: admm.solve_fused(
        p, x, cones, settings(2 * K))[0])
    tK = _time(g1, bp, x0s)
    t2K = _time(g2, bp, x0s)
    per_iter = (t2K - tK) / K
    total_ms = per_iter * K * 1e3
    print(f"fused batch B={B}: {per_iter*1e6:.1f} us/ADMM-iter -> "
          f"{K}-iter replan ~= {total_ms:.3f} ms total, "
          f"{total_ms/B*1e3:.1f} us/instance")


if __name__ == "__main__":
    main()
