"""Scenario-batch MPC: sampled dynamics, fused solves, consensus control.

BASELINE.json config #4 as a serving workload: thousands of
sampled-dynamics quadrotor instances solved per replan through the
batch-fused conic ADMM (one backward sweep and one rollout per
iteration for the whole batch), then a consensus first control (mean
over scenarios).

Usage: python examples/scenario_mpc.py [--batch B] [--horizon N]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from pdp_lqr_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--horizon", type=int, default=64)
    ap.add_argument("--admm-iters", type=int, default=15)
    ap.add_argument("--shared-dynamics", action="store_true",
                    help="sample only additive disturbances (c) so all "
                         "scenarios share (A, B) — enables the "
                         "operator-mode serving path (realtime."
                         "solve_batch: dense matmuls, no scans) and "
                         "times it against the fused sweeps")
    args = ap.parse_args()

    from pdp_lqr_tpu.models import quadrotor
    from pdp_lqr_tpu.solvers import admm
    from pdp_lqr_tpu.utils import profiling, quality

    on_cpu = jax.default_backend() == "cpu"
    B = args.batch or (8 if on_cpu else 1024)

    base, _ = quadrotor(N=args.horizon, constrained=True, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    tile = lambda x: jnp.broadcast_to(x, (B,) + x.shape)
    bp = jax.tree.map(tile, base)
    # Sampled dynamics: perturb A and B per scenario (parameter
    # uncertainty), plus per-scenario drift.
    dc = jnp.asarray(
        rng.normal(size=(B, args.horizon, 12)).astype(np.float32) * 0.002
    )
    if args.shared_dynamics:
        bp = dataclasses.replace(bp, c=bp.c + dc)
    else:
        dA = rng.normal(size=(B, 1, 12, 12)).astype(np.float32) * 0.002
        dB = rng.normal(size=(B, 1, 12, 4)).astype(np.float32) * 0.002
        bp = dataclasses.replace(
            bp,
            A=bp.A + jnp.asarray(dA),
            B=bp.B + jnp.asarray(dB),
            c=bp.c + dc,
        )
    x0s = jnp.broadcast_to(jnp.zeros(12, jnp.float32), (B, 12))

    settings = admm.ADMMSettings(
        max_iter=args.admm_iters, rho_update_interval=args.admm_iters,
        adaptive_rho=False, eps_abs=1e-4, eps_rel=1e-4, rho=0.1,
    )
    fused = jax.jit(
        lambda p, x, s: admm.solve_fused(p, x, (), settings, s)
    )
    ws, state, info = fused(bp, x0s, None)
    assert bool(jnp.all(jnp.isfinite(ws)))
    ws_cold = ws
    n_conv = int(np.sum(np.asarray(info.converged)))
    print(f"cold replan: {n_conv}/{B} scenarios converged "
          f"(max r_prim {float(np.max(np.asarray(info.r_prim))):.2e})")

    # Warm replans at serving cadence.  (The state!=None call is a
    # separate jit trace — warm it before the timed window, or its
    # compile lands inside the measurement.)
    ws, state, info = jax.block_until_ready(fused(bp, x0s, state))
    t0 = time.perf_counter()
    reps = 10
    for _ in range(reps):
        ws, state, info = fused(bp, x0s, state)
    jax.block_until_ready(ws)
    dt = (time.perf_counter() - t0) / reps
    print(f"warm replan of {B} scenarios: {dt*1e3:.2f} ms "
          f"({dt/B*1e6:.1f} us/scenario)")

    # Consensus control: mean over scenarios of the first input.
    u0 = np.asarray(ws[:, 0, :4])
    print("consensus u0:", np.array2string(u0.mean(0), precision=4),
          "+-", np.array2string(u0.std(0), precision=4))

    mask = profiling.failure_mask(ws)
    print("failed scenarios:", int(np.sum(np.asarray(mask))))
    q = quality.assess(jax.tree.map(lambda x: x[0], bp), ws[0])
    print("scenario-0 quality:", q)

    if args.shared_dynamics:
        # Operator-mode serving: one (B, M) @ (M, M) matmul per
        # iteration instead of the Riccati sweeps.
        from pdp_lqr_tpu.solvers import realtime

        op = realtime.build_batch_operator(base, rho=settings.rho,
                                           settings=settings)
        opfn = jax.jit(
            lambda p, x, s: realtime.solve_batch(p, x, op, (),
                                                 settings, s)
        )
        ws_o, st_o, info_o = opfn(bp, x0s, None)
        assert bool(jnp.all(jnp.isfinite(ws_o)))
        err = float(jnp.max(jnp.abs(ws_o - ws_cold)))
        ws_o, st_o, _ = opfn(bp, x0s, st_o)
        t0 = time.perf_counter()
        for _ in range(reps):
            ws_o, st_o, _ = opfn(bp, x0s, st_o)
        jax.block_until_ready(ws_o)
        dt_o = (time.perf_counter() - t0) / reps
        print(f"operator-mode warm replan of {B} scenarios: "
              f"{dt_o*1e3:.2f} ms ({dt_o/B*1e6:.2f} us/scenario); "
              f"max |op - fused| = {err:.2e}")


if __name__ == "__main__":
    main()
