"""GPU smoke run: the batched conic-LQR main path once, checked.

Runs every phase in one process on one GPU, through the entry points a
user calls (api.ScenarioServer, admm.solve_fused, admm.solve,
solvers/realtime, ops/pallas_riccati), at the BASELINE.json sizes:

  1. device and environment;
  2. inner solves, quadrotor box N=512 B=4096 (config #4), shared
     model and replicated batch, f32 and f64, against the NumPy
     Riccati oracle on sampled instances; centroidal N=1024 and
     mass-spring N=512 through the same paths;
  3. full conic ADMM: solve_fused against the per-instance XLA loop
     and the share of an iteration outside the sweeps, thrust-SOC
     (config #3) to eps 1e-4, a warm tick;
  4. real-time replans, centroidal N=1024 (config #5);
  5. the Triton sweep against XLA's sweep for each benchmark model.

``--multi`` runs only the four-GPU phase (data-parallel fused ADMM and
time-sharded ADMM / PDP against one-GPU results).

Every phase prints its max error, tolerance and wall time; the last
line of stdout is one JSON object with the device.  Exits non-zero
without a GPU or when any phase fails.

Usage: python chip_smoke.py [--multi]
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
import traceback

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pdp_lqr_tpu.utils.runtime import card, enable_compile_cache  # noqa: E402

SIGMA = 1e-6
FAILED: list = []

# (horizon, batch) of each check; the BASELINE.json sizes.
SHAPES = {
    "inner/quadrotor": (512, 4096, 4096),   # N, shared B, replicated B
    "inner/centroidal": (1024, 4096, 2048),
    "inner/mass_spring": (512, 4096, 1024),
    "admm/box": (512, 4096),
    "admm/soc": (256, 4096),
    "realtime": (1024, 32),                 # N, segments
    "sweep/quadrotor": (512, 4096),
    "sweep/centroidal": (1024, 1024),
    "sweep/mass_spring": (512, 512),
    "multi/batch": (512, 4096),             # N, B per GPU
    "multi/time": (1024, 8),
}


def report(name, err, tol, t0, extra=""):
    """One checked result line; records a failure."""
    ok = bool(np.isfinite(err)) and err <= tol
    print(f"[{name}] max_err={err:.3e} tol={tol:.1e} "
          f"wall={time.perf_counter() - t0:.1f}s "
          f"{'ok' if ok else 'FAIL'} {extra}".rstrip(), flush=True)
    if not ok:
        FAILED.append(name)


def phase(fn):
    """Run one phase; an exception fails it and the run goes on."""
    def run(*a, **k):
        t0 = time.perf_counter()
        print(f"== {fn.__name__}", flush=True)
        try:
            fn(*a, **k)
        except Exception:  # noqa: BLE001 — reported, counted as failed
            traceback.print_exc()
            FAILED.append(fn.__name__)
        print(f"== {fn.__name__} done in {time.perf_counter() - t0:.1f}s",
              flush=True)
        gc.collect()
    return run


def timed(fn, *args, reps=5):
    """(output, best seconds of ``reps`` calls) after one warm call."""
    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return out, best


# ------------------------------------------------------------- problems

def scenario_batch(model, N, B, dtype, seed=0):
    """Shared model with per-scenario drift c (B, N, nx) and x0 (B, nx).

    Returns (shared problem with batched c, cones, x0)."""
    from pdp_lqr_tpu.models import centroidal, mass_spring_chain, quadrotor

    if model == "quadrotor":
        base, cones = quadrotor(N=N, constrained=True, dtype=dtype)
        c_scale = 0.01
    elif model == "centroidal":
        base, cones = centroidal(N=N, dtype=dtype)
        c_scale = 1e-3
    else:
        base, cones = mass_spring_chain(n_masses=20, N=N, dtype=dtype), ()
        c_scale = 1e-3
    rng = np.random.default_rng(seed)
    c_b = np.asarray(base.c)[None] + rng.normal(
        size=(B,) + base.c.shape) * c_scale
    x0 = rng.normal(size=(B, base.nx)) * 0.1
    return (dataclasses.replace(base, c=jnp.asarray(c_b, dtype)),
            tuple(cones or ()), jnp.asarray(x0, dtype))


def replicate(sp, B):
    """A shared problem with batched c -> an ordinary batched problem."""
    tile = lambda x: jnp.broadcast_to(x, (B,) + x.shape)
    bp = jax.tree.map(tile, dataclasses.replace(sp, c=sp.c[0]))
    return dataclasses.replace(bp, c=sp.c)


def oracle_err(sp, x0, ws, idx):
    """Max |ws - oracle| over sampled instances, and max |oracle|."""
    from pdp_lqr_tpu.problem import init_iterates
    from pdp_lqr_tpu.utils import oracle

    base = jax.tree.map(lambda a: np.asarray(a, np.float64),
                        dataclasses.replace(sp, c=sp.c[0]))
    it = init_iterates(base, rho=0.01)
    ws = np.asarray(ws, np.float64)
    err = scale = 0.0
    for b in idx:
        p = dataclasses.replace(base, c=np.asarray(sp.c[b], np.float64))
        ref = oracle.riccati_numpy(p, it, SIGMA, np.asarray(x0[b],
                                                            np.float64))
        err = max(err, float(np.abs(ws[b] - ref).max()))
        scale = max(scale, float(np.abs(ref).max()))
    return err, scale


# --------------------------------------------------------------- phases

@phase
def device_and_environment():
    print("devices:", jax.devices(), flush=True)
    import jaxlib

    print("jax", jax.__version__, "jaxlib", jaxlib.__version__)
    print("XLA_FLAGS:", os.environ.get("XLA_FLAGS", ""))
    print("compile cache:", enable_compile_cache())


@phase
def inner_solves():
    from pdp_lqr_tpu import api
    from pdp_lqr_tpu.ops import pallas_riccati as pr
    from pdp_lqr_tpu.problem import init_iterates

    cases = [("quadrotor", jnp.float32, 1e-4),
             ("quadrotor", jnp.float64, 1e-6),
             ("centroidal", jnp.float32, 1e-4),
             ("mass_spring", jnp.float32, 1e-4)]
    for model, dt, rtol in cases:
        N, B_sh, B_rep = SHAPES[f"inner/{model}"]
        sp, _, x0 = scenario_batch(model, N, B_sh, dt)
        idx = np.linspace(0, B_sh - 1, 16).astype(int)
        tag = f"{model} N={N} {jnp.dtype(dt).name}"
        impl = pr.choose_impl(sp.nx)

        t0 = time.perf_counter()
        server = api.ScenarioServer(dataclasses.replace(sp, c=sp.c[0]))
        ws, t = timed(server.solve, x0, sp.c, reps=3)
        err, scale = oracle_err(sp, x0, ws, idx)
        report(f"inner/shared {tag} B={B_sh}", err, rtol * scale, t0,
               f"sweep={impl} solve={t * 1e3:.2f}ms")
        del ws, server

        t0 = time.perf_counter()
        spr = dataclasses.replace(sp, c=sp.c[:B_rep])
        bp = replicate(spr, B_rep)
        its = jax.vmap(lambda p: init_iterates(p, rho=0.01))(bp)
        fn = jax.jit(lambda p, i, x: pr.solve_batched(p, i, x, SIGMA))
        ws, t = timed(fn, bp, its, x0[:B_rep], reps=3)
        idx_r = np.linspace(0, B_rep - 1, 16).astype(int)
        err, scale = oracle_err(spr, x0, ws, idx_r)
        report(f"inner/replicated {tag} B={B_rep}", err, rtol * scale, t0,
               f"sweep={impl} solve={t * 1e3:.2f}ms")
        del ws, bp, its, sp, spr
        gc.collect()


@phase
def conic_admm():
    from pdp_lqr_tpu import api
    from pdp_lqr_tpu.models import quadrotor
    from pdp_lqr_tpu.ops import pallas_riccati as pr
    from pdp_lqr_tpu.problem import init_iterates
    from pdp_lqr_tpu.solvers import admm

    f32 = jnp.float32
    run = jax.jit(admm.solve_fused, static_argnames=("cones", "settings"))

    # solve_fused vs the per-instance XLA loop (dense backend), fixed
    # rho so both run the same iteration sequence.
    N, B = SHAPES["admm/box"]
    sp, _, x0 = scenario_batch("quadrotor", N, B, f32)
    bp = replicate(sp, B)
    st = admm.ADMMSettings(max_iter=20, rho=0.1, adaptive_rho=False)
    t0 = time.perf_counter()
    (ws, _, _), t = timed(lambda p, x: run(p, x, settings=st), bp, x0,
                          reps=3)
    idx = np.linspace(0, B - 1, 8).astype(int)
    sub = jax.tree.map(lambda a: a[idx], bp)
    ref, _, _ = jax.jit(lambda p, x: admm.solve_batched(
        p, x, (), dataclasses.replace(st, backend="dense")))(sub, x0[idx])
    ws_s, ref = np.asarray(ws)[idx], np.asarray(ref)
    report(f"admm/solve_fused quadrotor box N={N} B={B} 20 it f32",
           float(np.abs(ws_s - ref).max()), 1e-3 * np.abs(ref).max(), t0,
           f"solve={t * 1e3:.2f}ms ({B / t:.0f} solves/s)")
    # Share of one iteration outside the sweeps (projection, duals,
    # residuals, folds): iteration time against one inner solve.
    its = jax.vmap(lambda p: init_iterates(p, rho=0.1))(bp)
    _, t_in = timed(jax.jit(lambda p, i, x: pr.solve_batched(
        p, i, x, SIGMA)), bp, its, x0, reps=3)
    print(f"[admm/tail] iteration {t / 20 * 1e3:.3f}ms, inner solve "
          f"{t_in * 1e3:.3f}ms, tail share {1 - t_in / (t / 20):.3f}",
          flush=True)
    del ws, bp, sub, its
    gc.collect()

    # Config #3: thrust-SOC tracking to eps 1e-4 on the shared model.
    N, B = SHAPES["admm/soc"]
    p3, cones = quadrotor(N=N, constrained=True, thrust_cone=True, dtype=f32)
    shift = jnp.zeros((N + 1, p3.nc), f32).at[:, 16].set(8.0)
    x3 = jnp.full((B, p3.nx), 0.03, f32) + 0.01 * jax.random.normal(
        jax.random.PRNGKey(3), (B, p3.nx), f32)
    s3 = admm.ADMMSettings(max_iter=1000, rho=0.1, eps_abs=1e-4,
                           eps_rel=1e-4, early_exit=True)
    t0 = time.perf_counter()
    server = api.ScenarioServer(p3)
    (ws3, state3, info3), t = timed(
        lambda x: server.solve_admm(x, tuple(cones), s3, soc_shift=shift),
        x3, reps=1)
    it_c = np.asarray(info3.iter_converged)
    conv = float(np.mean(np.asarray(info3.converged)))
    finite = bool(np.all(np.isfinite(np.asarray(ws3))))
    report(f"admm/thrust-SOC N={N} B={B} eps=1e-4 (finite)",
           0.0 if finite else float("inf"), 0.0, t0,
           f"converged={conv:.4f} iters p50={np.percentile(it_c, 50):.0f} "
           f"p95={np.percentile(it_c, 95):.0f} solve={t * 1e3:.1f}ms")

    # A warm tick from that state: same x0, so it converges at once.
    t0 = time.perf_counter()
    (ws4, _, info4), t = timed(
        lambda x, s: server.solve_admm(x, tuple(cones), s3, state=s,
                                       soc_shift=shift), x3, state3, reps=3)
    report("admm/warm tick thrust-SOC (max |ws_warm - ws_cold|)",
           float(np.abs(np.asarray(ws4) - np.asarray(ws3)).max()),
           5e-2 * float(np.abs(np.asarray(ws3)).max()), t0,
           f"iters max={int(np.max(np.asarray(info4.iterations)))} "
           f"tick={t * 1e3:.2f}ms")


@phase
def realtime_replans():
    from pdp_lqr_tpu.models import centroidal
    from pdp_lqr_tpu.solvers import admm, realtime

    f32 = jnp.float32
    (N, S), K = SHAPES["realtime"], 20
    problem, cones = centroidal(N=N, dtype=f32)
    cones = tuple(cones)
    # eps = 0: every replan runs exactly K iterations (fixed cost), the
    # same sequence as admm.solve's.
    st = admm.ADMMSettings(max_iter=K, rho_update_interval=K, rho=1.0,
                           adaptive_rho=False, eps_abs=0.0, eps_rel=0.0)
    t0 = time.perf_counter()
    op = realtime.build_condensed_operator(problem, 1.0, S, st, cones)
    replan = realtime.replan_fn(problem, op, cones, st)
    x0 = jnp.zeros(problem.nx, f32)
    state = admm.init_state(problem, st)
    ws, state1, _ = jax.block_until_ready(replan(x0, state))
    lat = []
    rng = np.random.default_rng(4)
    for _ in range(300):
        x = x0 + jnp.asarray(rng.normal(size=problem.nx) * 1e-3, f32)
        t1 = time.perf_counter()
        out = jax.block_until_ready(replan(x, state1))
        lat.append(time.perf_counter() - t1)
    lat = np.asarray(lat) * 1e3
    ref, _, _ = jax.jit(lambda p, x: admm.solve(p, x, cones, st))(problem,
                                                                    x0)
    err = float(np.abs(np.asarray(ws) - np.asarray(ref)).max())
    report(f"realtime/centroidal N={N} replan vs admm.solve", err,
           1e-3 * float(np.abs(np.asarray(ref)).max()), t0,
           f"latency p50={np.percentile(lat, 50):.3f}ms "
           f"p99={np.percentile(lat, 99):.3f}ms (300 replans, {K} it, "
           f"caller side)")
    del out


@phase
def kernel_vs_xla():
    """Inner solves and 20-iteration solve_fused, Triton sweep vs XLA's
    sweep, and the per-instance XLA backends, at the benchmark shapes."""
    from pdp_lqr_tpu.ops import pallas_riccati as pr
    from pdp_lqr_tpu.problem import init_iterates
    from pdp_lqr_tpu.solvers import admm, dense, sequential

    f32 = jnp.float32
    for model in ("quadrotor", "centroidal", "mass_spring"):
        N, B = SHAPES[f"sweep/{model}"]
        sp, cones, x0 = scenario_batch(model, N, B, f32)
        bp = replicate(sp, B)
        its = jax.vmap(lambda p: init_iterates(p, rho=0.01))(bp)
        times = {}
        impls = ["triton", "xla"] if sp.nx <= pr.KERNEL_MAX_NX else ["xla"]
        for impl in impls:
            fn = jax.jit(lambda p, i, x, impl=impl: pr.solve_batched(
                p, i, x, SIGMA, impl=impl))
            _, times[f"inner/{impl}"] = timed(fn, bp, its, x0)
        for name, mod in (("dense", dense), ("sequential", sequential)):
            fn = jax.jit(lambda p, i, x, mod=mod: mod.solve_batched(
                p, i, x, SIGMA)[0])
            _, times[f"inner/{name}"] = timed(fn, bp, its, x0, reps=2)
        st = admm.ADMMSettings(max_iter=20, rho=0.1)
        for impl in impls:
            fn = jax.jit(lambda p, x, impl=impl: admm.solve_fused(
                p, x, cones, st, sweep=impl)[0])
            _, times[f"solve_fused20/{impl}"] = timed(fn, bp, x0, reps=3)
        kept = pr.choose_impl(sp.nx)
        print(f"[sweep] {model} N={N} B={B}: " + ", ".join(
            f"{k}={v * 1e3:.2f}ms" for k, v in times.items())
            + f"; kept={kept}", flush=True)
        del bp, its, sp
        gc.collect()


@phase
def multi_gpu():
    """Four GPUs: data-parallel fused ADMM over a 4-way batch mesh, and
    time-sharded ADMM / PDP over (batch=1, time=4), each against the
    one-GPU result on the same instances."""
    from pdp_lqr_tpu.parallel import admm_sharded, fused_dp, pdp_sharded
    from pdp_lqr_tpu.parallel.mesh import make_mesh
    from pdp_lqr_tpu.problem import init_iterates
    from pdp_lqr_tpu.solvers import admm, sequential

    f32 = jnp.float32
    n = len(jax.devices())
    if n != 4:
        raise RuntimeError(f"--multi needs 4 GPUs, found {n}")

    def spans(x, name):
        got = len(x.sharding.device_set)
        if got != 4:
            raise RuntimeError(f"{name} spans {got} devices, not 4")

    t0 = time.perf_counter()
    N, B = SHAPES["multi/batch"]
    sp, _, x0 = scenario_batch("quadrotor", N, 4 * B, f32)
    bp = replicate(sp, 4 * B)
    st = admm.ADMMSettings(max_iter=20, rho=0.1)
    mesh = make_mesh(batch=4, time=1)
    ws, _, _ = jax.jit(lambda p, x: fused_dp.solve_fused_dp(
        mesh, p, x, (), st))(bp, x0)
    spans(ws, "fused_dp ws")
    idx = np.arange(0, 4 * B, max(1, B // 2))
    sub = jax.tree.map(lambda a: a[idx], bp)
    ref, _, _ = jax.jit(lambda p, x: admm.solve_fused(p, x, (), st))(
        sub, x0[idx])
    ref = np.asarray(ref)
    report(f"multi/fused_dp quadrotor N={N} B=4x{B} vs one GPU",
           float(np.abs(np.asarray(ws)[idx] - ref).max()),
           1e-4 * np.abs(ref).max(), t0)
    del ws, bp, sub
    gc.collect()

    N, B = SHAPES["multi/time"]
    sp, cones, x0 = scenario_batch("centroidal", N, B, f32)
    bp = replicate(sp, B)
    tmesh = make_mesh(batch=1, time=4)
    t0 = time.perf_counter()
    sc = admm.ADMMSettings(max_iter=20, rho=0.1)
    ws, _, _ = admm_sharded.solve(tmesh, bp, x0, cones, sc)
    spans(ws, "admm_sharded ws")
    ref, _, _ = jax.jit(lambda p, x: admm.solve_fused(p, x, cones, sc))(
        bp, x0)
    ref = np.asarray(ref)
    report(f"multi/admm_sharded centroidal N={N} time=4 vs one GPU",
           float(np.abs(np.asarray(ws) - ref).max()),
           1e-3 * np.abs(ref).max(), t0)

    t0 = time.perf_counter()
    its = jax.vmap(lambda p: init_iterates(p, rho=0.01))(bp)
    ws = pdp_sharded.solve(tmesh, bp, its, x0, SIGMA)
    spans(ws, "pdp_sharded ws")
    ref = np.asarray(jax.jit(lambda p, i, x: sequential.solve_batched(
        p, i, x, SIGMA)[0])(bp, its, x0))
    report(f"multi/pdp_sharded centroidal N={N} time=4 vs one GPU",
           float(np.abs(np.asarray(ws) - ref).max()),
           1e-4 * np.abs(ref).max(), t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU phase")
    args = ap.parse_args()

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (devices: {devices})",
              file=sys.stderr)
        return 2
    print(card() or "nvidia-smi: card not readable", flush=True)
    device_and_environment()
    if args.multi:
        multi_gpu()
    else:
        inner_solves()
        conic_admm()
        realtime_replans()
        kernel_vs_xla()
    if FAILED:
        print("FAILED phases/checks: " + ", ".join(FAILED), file=sys.stderr)
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
