"""parallel/multihost coverage on a simulated device set.

A real multi-host run needs a pod (hardware-blocked — one chip here);
these tests pin the parts that CAN execute anywhere: mesh construction
rules over the 8 virtual CPU devices, the initialize() error contract,
and an actual sharded solve on a make_pod_mesh mesh.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdp_lqr_tpu import init_iterates
from pdp_lqr_tpu.models import quadrotor
from pdp_lqr_tpu.parallel import multihost, pdp_sharded


def test_make_pod_mesh_shapes():
    n = len(jax.devices())
    assert n == 8  # conftest forces the 8-device virtual CPU platform

    m1 = multihost.make_pod_mesh(time=1)
    assert m1.axis_names == ("batch", "time")
    assert m1.shape == {"batch": 8, "time": 1}

    m4 = multihost.make_pod_mesh(time=4)
    assert m4.shape == {"batch": 2, "time": 4}
    # Contiguous time groups (each group stays within one host).
    arr = np.asarray(m4.devices)
    ids = np.array([[d.id for d in row] for row in arr])
    assert np.array_equal(ids, np.arange(8).reshape(2, 4))

    with pytest.raises(ValueError, match="not divisible"):
        multihost.make_pod_mesh(time=3)
    # All virtual devices report as one process here, so time spanning
    # "hosts" cannot trigger; the local-count guard is exercised by
    # monkeypatching below.


def test_make_pod_mesh_rejects_cross_host_time(monkeypatch):
    monkeypatch.setattr(jax, "local_device_count", lambda *a, **k: 2)
    with pytest.raises(ValueError, match="spans hosts"):
        multihost.make_pod_mesh(time=4)


def test_initialize_is_idempotent_contract(monkeypatch):
    """initialize() swallows only 'already initialized' errors."""
    calls = {}

    def fake_init(**kw):
        calls.update(kw)
        raise RuntimeError("backends are already initialized")

    monkeypatch.setattr(jax.distributed, "initialize", fake_init)
    multihost.initialize(coordinator_address="host:1234",
                         num_processes=2, process_id=0)
    assert calls["coordinator_address"] == "host:1234"

    def fake_init_fail(**kw):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(jax.distributed, "initialize", fake_init_fail)
    with pytest.raises(RuntimeError, match="connection refused"):
        multihost.initialize()


def test_pod_mesh_runs_sharded_solve():
    """A make_pod_mesh mesh drives the sharded PDP solve end-to-end."""
    problem, _ = quadrotor(N=16, constrained=True)
    B = 4
    rng = np.random.default_rng(0)
    bp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                      problem)
    bp = dataclasses.replace(
        bp, c=bp.c + jnp.asarray(rng.normal(size=bp.c.shape) * 0.01))
    its = jax.vmap(lambda p: init_iterates(p, rho=0.01))(bp)
    x0 = jnp.asarray(rng.normal(size=(B, 12)) * 0.1)

    mesh = multihost.make_pod_mesh(time=4)
    ws = pdp_sharded.solve(mesh, bp, its, x0, sigma=1e-6)
    from pdp_lqr_tpu.solvers import sequential

    ws_ref, _ = sequential.solve_batched(bp, its, x0, 1e-6)
    np.testing.assert_allclose(
        np.asarray(ws), np.asarray(ws_ref), atol=1e-8)
