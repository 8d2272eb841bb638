"""REAL two-process jax.distributed smoke test (VERDICT r3 task #7).

Spawns two fresh Python processes against a localhost coordinator —
process 0 hosts it — each with 2 virtual CPU devices.  Covers
``multihost.initialize`` for real (no monkeypatching): the merged
4-device view, a cross-process allgather over the gloo CPU
collectives, and one tiny batch-sharded solve whose instances live on
BOTH processes (host-local shards -> global array -> SPMD jit).

Needs no cluster: this is the standard CPU stand-in for the
cross-process half of the multi-host story; the in-process half
(collectives inside shard_map) is covered by the virtual-mesh tests.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

WORKER = textwrap.dedent("""
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass

    addr, pid = sys.argv[1], int(sys.argv[2])
    sys.path.insert(0, sys.argv[3])

    from pdp_lqr_tpu.parallel import multihost

    multihost.initialize(coordinator_address=addr, num_processes=2,
                         process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert jax.local_device_count() == 2
    assert jax.device_count() == 4, jax.device_count()

    import dataclasses

    import numpy as np
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    # Merged view proven by an actual cross-process gather.
    g = multihost_utils.process_allgather(
        np.asarray([float(pid)]), tiled=False)
    assert g.shape == (2, 1) and g[0, 0] == 0.0 and g[1, 0] == 1.0, g
    print("SMOKE-VIEW-OK", pid, flush=True)

    from pdp_lqr_tpu import init_iterates
    from pdp_lqr_tpu.models import quadrotor
    from pdp_lqr_tpu.solvers import sequential

    mesh = multihost.make_pod_mesh(time=1)      # batch=4 over 4 devices
    B_local = 2
    problem, _ = quadrotor(N=8, constrained=True, dtype=jnp.float32)
    rng = np.random.default_rng(pid)
    tile = lambda x: np.broadcast_to(np.asarray(x),
                                     (B_local,) + x.shape)
    bp_local = jax.tree.map(tile, problem)
    bp_local = dataclasses.replace(
        bp_local,
        c=bp_local.c
        + rng.normal(size=bp_local.c.shape).astype(np.float32) * 0.01,
    )
    x0_local = rng.normal(size=(B_local, problem.nx)).astype(
        np.float32) * 0.1

    to_global = lambda x: \\
        multihost_utils.host_local_array_to_global_array(
            x, mesh, P("batch"))
    bp = jax.tree.map(to_global, bp_local)
    x0 = to_global(x0_local)
    its = jax.vmap(lambda p: init_iterates(p, rho=0.01))(bp)

    ws, _ = jax.jit(
        lambda p, i, x: sequential.solve_batched(p, i, x, 1e-6)
    )(bp, its, x0)
    assert ws.shape == (4, 9, 16)
    assert bool(jnp.all(jnp.isfinite(ws)))
    print("SMOKE-SOLVE-OK", pid, flush=True)

    # Time-sharded PDP across BOTH processes: mesh ("batch"=2,
    # "time"=2) with the horizon axis split within each process's two
    # devices and batch across processes — the boundary all-gather
    # actually rides the distributed backend.
    from pdp_lqr_tpu.parallel import pdp_sharded

    mesh2 = multihost.make_pod_mesh(time=2)
    N2 = 8
    p2, _ = quadrotor(N=N2, constrained=True, dtype=jnp.float32)
    b2 = 1   # one instance per process -> global batch 2
    tile2 = lambda x: np.broadcast_to(np.asarray(x), (b2,) + x.shape)
    bp2_local = jax.tree.map(tile2, p2)
    x02_local = rng.normal(size=(b2, p2.nx)).astype(np.float32) * 0.1
    tg2 = lambda x: multihost_utils.host_local_array_to_global_array(
        x, mesh2, P("batch"))
    bp2 = jax.tree.map(tg2, bp2_local)
    x02 = tg2(x02_local)
    its2 = jax.vmap(lambda p: init_iterates(p, rho=0.01))(bp2)
    ws2 = pdp_sharded.solve(mesh2, bp2, its2, x02, sigma=1e-6)
    assert ws2.shape == (2, N2 + 1, p2.nz)
    assert bool(jnp.all(jnp.isfinite(ws2)))
    print("SMOKE-PDP-OK", pid, flush=True)
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_solve(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    addr = f"127.0.0.1:{_free_port()}"

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    # The distributed client must not inherit xdist/test-runner state.
    env.pop("PYTEST_XDIST_WORKER", None)

    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), addr, str(pid), str(REPO)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=str(REPO),
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert f"SMOKE-VIEW-OK {pid}" in out, out
        assert f"SMOKE-SOLVE-OK {pid}" in out, out
        assert f"SMOKE-PDP-OK {pid}" in out, out
