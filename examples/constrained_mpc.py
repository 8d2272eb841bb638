"""Constrained quadrotor MPC with the conic ADMM outer loop.

Demonstrates what the reference leaves unreleased (README.md:8): box
constraints on states/inputs and a thrust second-order cone, solved by
ADMM around the Riccati inner solver, then run closed-loop at a
receding horizon with warm starts.

Usage: python examples/constrained_mpc.py [--horizon N] [--steps T]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from pdp_lqr_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--horizon", type=int, default=40)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--thrust-cone", action="store_true")
    args = ap.parse_args()

    from pdp_lqr_tpu import mpc
    from pdp_lqr_tpu.models import quadrotor
    from pdp_lqr_tpu.solvers import admm

    problem, cone_specs = quadrotor(
        N=args.horizon, constrained=True, thrust_cone=args.thrust_cone,
        dtype=jnp.float32,
    )
    cones = tuple(cone_specs or [])
    settings = admm.ADMMSettings(
        max_iter=100, rho_update_interval=25, rho=0.1
    )

    x0 = jnp.zeros(problem.nx)
    ws, state, info = jax.jit(
        lambda p, x: admm.solve(p, x, cones, settings)
    )(problem, x0)
    print("cold solve:", info)

    # Closed loop: hover at z=1 from the ground.
    t0 = time.perf_counter()
    xs, us, infos = jax.jit(
        lambda p, x: mpc.simulate(p, x, args.steps, cones, settings)
    )(problem, x0)
    jax.block_until_ready(xs)
    wall = time.perf_counter() - t0
    xs, us = np.asarray(xs), np.asarray(us)
    print(f"closed loop: {args.steps} replans in {wall*1e3:.1f} ms "
          f"({wall/args.steps*1e3:.2f} ms/replan incl. compile)")
    print("final position:", xs[-1, :3], "(target [0, 0, 1])")
    print("u range: [%.4f, %.4f]  (box [-0.9916, 2.4084])"
          % (us.min(), us.max()))
    print("mean ADMM iterations to converge:",
          float(np.mean(np.asarray(infos.iter_converged))))


if __name__ == "__main__":
    main()
