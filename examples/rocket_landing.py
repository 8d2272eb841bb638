"""Rocket soft-landing: two-cone conic MPC end to end.

Classic powered-descent geometry (models/rocket.py: thrust gimbal SOC +
glideslope SOC + thrust box) driven through the framework three ways:

  1. single-instance optimal descent (admm.solve), feasibility report;
  2. Monte-Carlo entry dispersion through the fused batch loop
     (admm.solve_fused) — the serving shape:
     landing footprint statistics + solves/s;
  3. closed-loop MPC under wind (mpc.simulate): warm-started replans,
     convergence-iteration stats.

Run on the GPU for real numbers; on the CPU it runs the XLA sweeps in
float64.  The reference has no counterpart for any of this —
its outer loop is unreleased (README.md:8); this is what "conic" in its
title buys once completed.
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse
import time

import numpy as np


def main():
    from pdp_lqr_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--horizon", type=int, default=48)
    ap.add_argument("--batch", type=int, default=None,
                    help="Monte-Carlo batch (default 512 on GPU, 8 CPU)")
    ap.add_argument("--steps", type=int, default=30,
                    help="closed-loop MPC steps")
    ap.add_argument("--iters", type=int, default=5,
                    help="timing repetitions for the batch section")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pdp_lqr_tpu import mpc
    from pdp_lqr_tpu.models import rocket, rocket_x0
    from pdp_lqr_tpu.solvers import admm
    from pdp_lqr_tpu.utils import quality

    on_cpu = jax.default_backend() == "cpu"
    dtype = jnp.float64 if on_cpu else jnp.float32
    N = args.horizon
    B = args.batch if args.batch is not None else (8 if on_cpu else 512)

    problem, cones = rocket(N=N, dtype=dtype)
    cones = tuple(cones)
    settings = admm.ADMMSettings(
        max_iter=150, rho=1.0, rho_update_interval=10,
        eps_abs=1e-4, eps_rel=1e-3,
    )

    # ---- 1. single instance ---------------------------------------------
    x0 = rocket_x0(dtype=dtype)
    ws, _, info = jax.jit(
        lambda p, x: admm.solve(p, x, cones, settings)
    )(problem, x0)
    q = quality.assess(problem, ws, cones)
    xs = np.asarray(ws[:, 3:])
    print(
        f"single descent: converged={bool(info.converged)} "
        f"in {int(info.iter_converged)} iters | "
        f"touchdown pos err {np.linalg.norm(xs[-1, :3]):.2e} m, "
        f"vertical vel {xs[-1, 5]:.3f} m/s | "
        f"cone violation {float(q.cone_violation):.2e}, "
        f"box violation {float(q.box_violation):.2e}"
    )

    # ---- 2. Monte-Carlo entry dispersion (fused batch) ------------------
    bp = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), problem)
    x0s = rocket_x0(batch=B, dtype=dtype)
    fn = jax.jit(lambda p, x: admm.solve_fused(p, x, cones, settings))
    wsb = jax.block_until_ready(fn(bp, x0s)[0])
    assert bool(jnp.all(jnp.isfinite(wsb)))
    t0 = time.perf_counter()
    for _ in range(args.iters):
        wsb = fn(bp, x0s)[0]
    jax.block_until_ready(wsb)
    dt_s = (time.perf_counter() - t0) / args.iters
    land = np.asarray(wsb[:, -1, 3:])
    r_err = np.linalg.norm(land[:, :3], axis=1)
    print(
        f"dispersion batch B={B}: footprint p50 {np.median(r_err):.2e} m, "
        f"max {r_err.max():.2e} m | vertical vel worst "
        f"{land[:, 5].min():.3f} m/s | "
        f"{B / dt_s:.0f} landings/s ({settings.max_iter} ADMM iters each)"
    )

    # ---- 3. closed-loop MPC under wind ----------------------------------
    rng = np.random.default_rng(3)
    wind = jnp.asarray(
        rng.normal(size=(args.steps, 6)) * np.array([0, 0, 0, .08, .08, .04]),
        dtype,
    )
    mpc_settings = admm.ADMMSettings(
        max_iter=80, rho=1.0, rho_update_interval=10,
        eps_abs=1e-4, eps_rel=1e-3,
    )
    xs_cl, us_cl, infos = jax.jit(
        lambda p, x, w: mpc.simulate(p, x, args.steps, cones,
                                     mpc_settings, process_noise=w)
    )(problem, x0, wind)
    xs_cl = np.asarray(xs_cl)
    iters = np.asarray(infos.iter_converged)
    print(
        f"closed loop ({args.steps} steps, wind): altitude "
        f"{xs_cl[0, 2]:.1f} -> {xs_cl[-1, 2]:.1f} m, lateral "
        f"{np.linalg.norm(xs_cl[0, :2]):.1f} -> "
        f"{np.linalg.norm(xs_cl[-1, :2]):.1f} m | warm replans "
        f"converged in p50 {int(np.median(iters[1:]))} iters "
        f"(cold start {int(iters[0])})"
    )


if __name__ == "__main__":
    main()
