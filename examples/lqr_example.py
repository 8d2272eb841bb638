"""Quadrotor MPC three-solver cross-check — the reference example.

JAX port of the reference's example program (examples/lqr_example.cpp):
build the quadrotor problem (nx=12, nu=4, N=100), run it through the
KKT, sequential-Riccati, PDP-parallel, and associative-scan backends,
time each, and print the first 5 inputs + final state for comparison
(the reference prints the same quantities, lqr_example.cpp:174-221).

Usage: python examples/lqr_example.py [--horizon N] [--f64]
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
    ap.add_argument("--horizon", type=int, default=100)
    ap.add_argument("--f64", action="store_true",
                    help="float64 (CPU parity mode)")
    args = ap.parse_args()

    if args.f64:
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if args.f64 else jnp.float32

    from pdp_lqr_tpu import init_iterates
    from pdp_lqr_tpu.models import quadrotor
    from pdp_lqr_tpu.solvers import assoc, kkt, pdp, sequential

    problem, _ = quadrotor(N=args.horizon, dtype=dtype)
    it = init_iterates(problem, rho=0.01)       # lqr_example.cpp:170
    x0 = jnp.zeros(problem.nx, dtype)
    sigma = 1e-6                                # lqr_example.cpp:171

    def bench(name, fn):
        f = jax.jit(fn)
        ws, _ = jax.block_until_ready(f(problem, it, x0))  # compile
        t0 = time.perf_counter()
        for _ in range(10):
            ws, _ = f(problem, it, x0)
        jax.block_until_ready(ws)
        dt_ms = (time.perf_counter() - t0) / 10 * 1e3
        ws = np.asarray(ws)
        print(f"=== {name} ===  ({dt_ms:.3f} ms/solve)")
        print("u[0:5,0] :", np.array2string(ws[:5, 0], precision=6))
        print("x[N]     :", np.array2string(ws[-1, problem.nu:], precision=6))
        return ws

    ws_kkt = bench("QDLDL-analog block KKT",
                   lambda p, i, x: kkt.solve(p, i, x, sigma, 1e-6))
    ws_seq = bench("sequential Riccati (lax.scan)",
                   lambda p, i, x: sequential.solve(p, i, x, sigma))
    ws_pdp = bench("PDP parallel Riccati (4 segments)",
                   lambda p, i, x: pdp.solve(p, i, x, sigma, 4))
    ws_asc = bench("associative-scan Riccati (log-depth)",
                   lambda p, i, x: assoc.solve(p, i, x, sigma))

    tol = 1e-6 if args.f64 else 1e-3
    for name, ws in [("pdp", ws_pdp), ("assoc", ws_asc)]:
        err = np.abs(ws - ws_seq).max()
        print(f"max |{name} - seq| = {err:.2e}")
        assert err < tol, f"{name} disagrees with sequential"
    err = np.abs(ws_kkt - ws_seq).max()
    print(f"max |kkt - seq|   = {err:.2e}  (rho_dyn=1e-6 regularization)")


if __name__ == "__main__":
    main()
