"""Data-parallel fused solves: shard_map over "batch" x the lanes sweeps.

The scaling configuration for serving: problem instances shard across
every device of the mesh (pure data parallelism — zero collectives),
and each device runs the batched Riccati sweeps of ops/pallas_riccati
on its local shard.  Combines with the "time"-axis PDP sharding
(parallel/pdp_sharded.py) only when single-solve latency at very long
horizons matters more than throughput; for solves/s this path needs no
interconnect traffic at all.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pdp_lqr_tpu.ops import pallas_riccati as pr
from pdp_lqr_tpu.problem import ADMMIterates, LQRProblem


def solve(mesh: Mesh, problem: LQRProblem, it: ADMMIterates, x0,
          sigma: float):
    """Batched inner solve, batch axis sharded over every mesh device.

    problem/it: batched pytrees (leading axis B, divisible by the mesh
    device count); x0 (B, nx).  Returns ws (B, N+1, nz) sharded the
    same way.
    """
    axes = mesh.axis_names

    def body(p, i, x):
        return pr.solve_batched(p, i, x, sigma)

    spec = P(axes)  # shard leading batch dim over all axes jointly
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
        check_vma=False,
    )
    return fn(problem, it, x0)


def solve_fused_dp(mesh: Mesh, problem: LQRProblem, x0, cones=(),
                   settings=None, state=None, soc_shift=None):
    """FULL conic ADMM loop (solvers/admm.solve_fused) under shard_map,
    batch axis sharded over every mesh device — zero collectives.

    The data-parallel composition of the outer loop: projections,
    duals, exact residuals, and per-instance adaptive rho are all
    instance-local, so each device runs the entire constrained solve
    on its local shard; nothing crosses the interconnect.  For horizon
    sharding ("time" axis) use parallel/admm_sharded.solve, which
    exchanges segment boundary factors per iteration.

    problem/x0 (and state, if given): batched pytrees, leading axis B
    divisible by the mesh device count; soc_shift is unbatched
    (replicated).

    Returns (ws, ADMMState, ADMMInfo), all batch-sharded.
    """
    from pdp_lqr_tpu.solvers import admm

    if settings is None:
        settings = admm.ADMMSettings()
    cones = tuple(cones)
    axes = mesh.axis_names
    spec = P(axes)
    rep = P()

    def body(p, x, st, sh):
        return admm.solve_fused(p, x, cones, settings, st, sh)

    in_specs = [spec, spec]
    args = [problem, x0]
    if state is not None:
        in_specs.append(spec)
        args.append(state)
    else:
        body_st = body
        body = lambda p, x, sh: body_st(p, x, None, sh)
    if soc_shift is not None:
        in_specs.append(rep)
        args.append(soc_shift)
    else:
        body_sh = body
        body = lambda *a: body_sh(*a, None)

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(spec, spec, spec),
        check_vma=False,
    )
    return fn(*args)
