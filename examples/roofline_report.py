"""Roofline share of the batched backward Riccati sweep.

Times ops/pallas_riccati.backward on the bench shape (quadrotor box,
f32) and divides the least time the device could take — the larger of
bytes over peak bandwidth and FLOPs over peak float32 rate, from
utils.profiling.riccati_roofline and the published peaks of the
device (utils.profiling.PEAKS; an unknown device is an error) — by the
measured time.

Usage: python examples/roofline_report.py [--batch B] [--horizon N]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse
import json
import time

import jax


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=512)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sweep", default=None, choices=["triton", "xla"])
    args = ap.parse_args()

    from pdp_lqr_tpu.ops import pallas_riccati as pr
    from pdp_lqr_tpu.problem import make_stage_params
    from pdp_lqr_tpu.utils import profiling
    from pdp_lqr_tpu.utils.runtime import device_info, enable_compile_cache
    from __graft_entry__ import _quadrotor_batch

    enable_compile_cache()
    dev = device_info()
    B, N = args.batch, args.horizon
    problem, its, _ = _quadrotor_batch(batch=B, N=N)
    nx, nu, nc = problem.nx, problem.nu, problem.nc
    params = jax.vmap(lambda p, i: make_stage_params(p, i, 1e-6))(
        problem, its)
    stage = (problem.A, problem.B, problem.c, params.H[:, :-1],
             params.h[:, :-1], problem.D[:, :-1], its.rho[:, :-1],
             its.rho[:, :-1] * params.g[:, :-1],
             params.H[:, -1, nu:, nu:], params.h[:, -1, nu:])
    bw = jax.jit(lambda *a: pr.backward(*a, impl=args.sweep))
    out = jax.block_until_ready(bw(*stage))
    t0 = time.perf_counter()
    for _ in range(args.reps):
        out = bw(*stage)
    jax.block_until_ready(out)
    t = (time.perf_counter() - t0) / args.reps

    roof = profiling.riccati_roofline(N, nx, nu, nc, B, dev["kind"])
    bound_ms = max(roof["t_mem_ms"], roof["t_compute_ms"])
    print(json.dumps({
        "device": dev,
        "shape": f"quadrotor N={N} B={B} f32",
        "sweep": pr.choose_impl(nx, args.sweep),
        "backward_ms": t * 1e3,
        "bound_ms": bound_ms,
        "bound": roof["bound"],
        "roofline_share": bound_ms / (t * 1e3),
    }))


if __name__ == "__main__":
    main()
