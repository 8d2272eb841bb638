"""Throughput benchmark: batched conic LQR solves/s on one device.

Workload (BASELINE.json config #4 scaled to one card): a scenario batch
of one model (quadrotor nx=12, nu=4 by default) at horizon N=512 with
per-scenario drift and start state.  Default mode times the inner
backward + forward solve; ``--admm ITERS`` times the full conic ADMM
loop (admm.solve_fused) at a fixed iteration count.

Usage:
  python bench.py [--model quadrotor|mass_spring|centroidal]
                  [--horizon N] [--batch B] [--iters K]
                  [--solver auto|pallas|seq|dense|pdp|assoc|kkt]
                  [--sweep triton|xla] [--no-shared] [--cached]
  python bench.py --admm ITERS [--soc] [--shared] [--cached] [--warm]
                  [--ladder R1,R2,...|auto] [--sweep triton|xla]

Prints one JSON line per run; every line names the device it ran on
(platform, device kind and count, and the card's name and power limit).
Each timed window ends with ``jax.block_until_ready``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from pdp_lqr_tpu.utils.runtime import device_info, enable_compile_cache


def _timed(fn, args, iters):
    """Warm (compile) once, then seconds for ``iters`` calls."""
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def _model(name, N):
    from pdp_lqr_tpu.models import centroidal, mass_spring_chain, quadrotor

    if name == "quadrotor":
        return quadrotor(N=N, constrained=True, dtype=jnp.float32)[0], 0.01
    if name == "mass_spring":
        return mass_spring_chain(n_masses=20, N=N, dtype=jnp.float32), 1e-3
    return centroidal(N=N, dtype=jnp.float32)[0], 1e-3


def run_admm_bench(args, B):
    """Full conic ADMM loop throughput; one solve = --admm iterations."""
    from pdp_lqr_tpu import mpc
    from pdp_lqr_tpu.models import centroidal, quadrotor
    from pdp_lqr_tpu.solvers import admm

    N, K = args.horizon, args.admm
    cones, shift = (), None
    if args.model == "centroidal":
        problem, cone_list = centroidal(N=N, dtype=jnp.float32)
        cones = tuple(cone_list)
    elif args.soc:
        # BASELINE.json config #3: thrust-SOC tracking; the t-row shift
        # encodes ||v|| <= beta (u_tot + 4 hover).
        problem, cone_list = quadrotor(N=N, constrained=True,
                                       thrust_cone=True, dtype=jnp.float32)
        cones = tuple(cone_list)
        shift = jnp.zeros((N + 1, problem.nc), jnp.float32).at[:, 16].set(8.0)
    else:
        problem, _ = quadrotor(N=N, constrained=True, dtype=jnp.float32)
    bp = problem if args.shared else jax.tree.map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), problem)
    x0s = jnp.full((B, problem.nx), 0.03, jnp.float32)
    if args.ladder == "auto":
        ladder = admm.suggest_rho_ladder(
            bp, x0s, cones, admm.ADMMSettings(rho=0.1), rungs=4,
            probe_iters=min(K, 50), soc_shift=shift)
    else:
        ladder = tuple(float(r) for r in args.ladder.split(",") if r)
    settings = admm.ADMMSettings(
        max_iter=K, rho_update_interval=25, rho=0.1, eps_abs=1e-4,
        eps_rel=1e-4, cached_factors=args.cached,
        uniform_rho=args.shared and args.cached and not ladder,
        rho_ladder=ladder)
    run = jax.jit(admm.solve_fused,
                  static_argnames=("cones", "settings", "sweep"))
    label = ("shared" if args.shared else "replicated") \
        + ("+cached" if args.cached else "") \
        + (f"+ladder{ladder}" if ladder else "")
    out = {"device": device_info(), "model": args.model, "N": N, "B": B,
           "iterations": K, "mode": label, "sweep": args.sweep or "auto"}

    if args.warm:
        # Receding-horizon ticks: converge cold, then each tick starts
        # from the shifted previous state (and its cached factors) at a
        # drifted x0 and stops at convergence (early_exit).
        cold = dataclasses.replace(settings, early_exit=True,
                                   max_iter=max(300, K))
        warm = dataclasses.replace(settings, early_exit=True)
        ws, state, _ = run(bp, x0s, cones=cones, settings=cold,
                           soc_shift=shift, sweep=args.sweep)
        x1 = x0s @ problem.A[0].T + ws[:, 0, :problem.nu] @ problem.B[0].T \
            + problem.c[0]
        state = mpc.shift_state(state, problem)
        tick = lambda x, s: run(bp, x, cones=cones, settings=warm, state=s,
                                soc_shift=shift, sweep=args.sweep)
        (_, _, info), dt = _timed(tick, (x1, state), args.iters)
        out.update(metric="warm conic ADMM ticks/s", unit="ticks/s",
                   value=B * args.iters / dt,
                   warm_iterations_mean=float(jnp.mean(info.iterations)))
        print(json.dumps(out))
        return 0

    fn = lambda p, x: run(p, x, cones=cones, settings=settings,
                          soc_shift=shift, sweep=args.sweep)
    (ws, _, info), dt = _timed(fn, (bp, x0s), args.iters)
    if not bool(jnp.all(jnp.isfinite(ws))):
        print("non-finite ADMM output", file=sys.stderr)
        return 1
    it_c = np.asarray(info.iter_converged)
    out.update(metric="conic ADMM solves/s", unit="solves/s",
               value=B * args.iters / dt,
               converged_frac=float(np.mean(np.asarray(info.converged))),
               iters_to_converge_p50=float(np.percentile(it_c, 50)),
               iters_to_converge_p95=float(np.percentile(it_c, 95)))
    print(json.dumps(out))
    return 0


def run_inner_bench(args, B):
    """Inner backward + forward solves/s on one scenario batch."""
    from pdp_lqr_tpu.ops import pallas_riccati as pr
    from pdp_lqr_tpu.problem import init_iterates

    N = args.horizon
    base, c_scale = _model(args.model, N)
    rng = np.random.default_rng(0)
    c_b = base.c[None] + jnp.asarray(
        rng.normal(size=(B,) + base.c.shape) * c_scale, jnp.float32)
    x0 = jnp.asarray(rng.normal(size=(B, base.nx)) * 0.1, jnp.float32)
    solver = "pallas" if args.solver == "auto" else args.solver
    shared = solver == "pallas" and not args.no_shared
    its1 = init_iterates(base, rho=0.01)

    if shared and args.cached:
        # Steady-state serving: factors built once, per-solve work is
        # the vector sweep + rollout.
        prep = pr.prepare_shared(dataclasses.replace(base, c=c_b), its1,
                                 x0, 1e-6)
        fac = pr.shared_factors(prep, impl=args.sweep)
        step = lambda prep, fac: pr.solve_shared_cached(
            prep, fac, impl=args.sweep)
        call_args = (prep, fac)
    elif shared:
        step = lambda c, x: pr.solve_shared(
            dataclasses.replace(base, c=c), its1, x, 1e-6, impl=args.sweep)
        call_args = (c_b, x0)
    else:
        problem = dataclasses.replace(
            jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                         base), c=c_b)
        its = jax.vmap(lambda p: init_iterates(p, rho=0.01))(problem)
        step = _batched_solver(solver, args.sweep)
        call_args = (problem, its, x0)

    ws, dt = _timed(jax.jit(step), call_args, args.iters)
    if not bool(jnp.all(jnp.isfinite(ws))):
        print("non-finite solve output", file=sys.stderr)
        return 1
    label = solver + ("+shared" if shared else "") \
        + ("+cached" if shared and args.cached else "")
    print(json.dumps({
        "device": device_info(), "model": args.model, "N": N, "B": B,
        "mode": label, "sweep": args.sweep or "auto",
        "metric": "inner LQ solves/s (backward + forward)",
        "unit": "solves/s", "value": B * args.iters / dt}))
    return 0


def _batched_solver(solver, sweep):
    from pdp_lqr_tpu.config import CondensedSolverType
    from pdp_lqr_tpu.ops import pallas_riccati as pr
    from pdp_lqr_tpu.solvers import assoc, dense, kkt, pdp, sequential

    if solver == "pallas":
        return lambda p, i, x: pr.solve_batched(p, i, x, 1e-6, impl=sweep)
    if solver == "kkt":
        return lambda p, i, x: jax.vmap(
            lambda a, b, c: kkt.solve(a, b, c, 1e-6)[0])(p, i, x)
    if solver == "pdp":
        return lambda p, i, x: pdp.solve_batched(
            p, i, x, 1e-6, 8, CondensedSolverType.CHOLESKY)[0]
    mod = {"seq": sequential, "dense": dense, "assoc": assoc}[solver]
    return lambda p, i, x: mod.solve_batched(p, i, x, 1e-6)[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--horizon", type=int, default=512)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--model", default="quadrotor",
                    choices=["quadrotor", "mass_spring", "centroidal"])
    ap.add_argument("--solver", default="auto",
                    choices=["auto", "pallas", "seq", "dense", "pdp",
                             "assoc", "kkt"])
    ap.add_argument("--sweep", default=None, choices=["triton", "xla"],
                    help="sweep implementation (default: by platform)")
    ap.add_argument("--no-shared", action="store_true",
                    help="pallas: replicate the model per instance "
                         "instead of one shared copy")
    ap.add_argument("--cached", action="store_true",
                    help="reuse factors (inner: built once; --admm: "
                         "between rho changes)")
    ap.add_argument("--admm", type=int, default=0, metavar="ITERS",
                    help="bench the full conic ADMM loop instead")
    ap.add_argument("--shared", action="store_true",
                    help="--admm: one shared model for the batch")
    ap.add_argument("--soc", action="store_true",
                    help="--admm: thrust-SOC quadrotor (config #3)")
    ap.add_argument("--warm", action="store_true",
                    help="--admm: warm receding-horizon ticks")
    ap.add_argument("--ladder", default="",
                    help="--admm: rho rungs, comma-separated, or 'auto'")
    args = ap.parse_args()

    enable_compile_cache()
    on_cpu = jax.default_backend() == "cpu"
    B = args.batch or (8 if on_cpu else 4096)
    if args.admm:
        return run_admm_bench(args, B)
    return run_inner_bench(args, B)


if __name__ == "__main__":
    sys.exit(main())
