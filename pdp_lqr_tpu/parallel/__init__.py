"""Multi-device execution: meshes, shard_map solvers, collectives.

The reference's concurrency is one OpenMP thread per horizon segment
with shared-memory handoff and CPU pinning
(lqr_solver_parallel.hpp:102-112,156-188).  Here the same decomposition
maps onto a JAX device mesh: the segment axis shards over a "time" mesh
axis (an all-gather replaces the shared-memory boundary handoff, an
implicit SPMD barrier replaces the OpenMP join), and scenario batching
shards over a "batch" axis.  XLA owns placement; there is no pinning.
"""

from pdp_lqr_tpu.parallel.mesh import make_mesh
