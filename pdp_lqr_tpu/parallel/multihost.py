"""Multi-host initialization and mesh construction.

The reference is strictly single-process (OpenMP shared memory,
SURVEY.md section 2); scaling beyond one host here follows the standard
JAX recipe: ``jax.distributed.initialize`` connects the processes,
after which ``jax.devices()`` spans every process's devices and the
same ("batch", "time") mesh code works unchanged.

Axis placement follows the algorithm: the "time" axis carries the PDP
boundary exchange (parallel/pdp_sharded.py all-gathers nx*nx blocks
every solve), so it stays within one host, whose GPUs all reach each
other over NVLink at the same rate; "batch" may span hosts, since
batch instances never communicate.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Connect this process to the multi-host slice.

    Pass the coordinator address (``host:port``), the process count
    and this process's id; only cluster schedulers JAX knows can
    supply them itself.  No-op if already initialized.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def make_pod_mesh(time: int = 1) -> Mesh:
    """("batch", "time") mesh over every device in the (multi-host) slice.

    ``time`` devices per horizon-sharding group are taken contiguously
    so each group stays within one host whenever
    time <= local_device_count.
    """
    devices = jax.devices()
    n = len(devices)
    if n % time != 0:
        raise ValueError(f"device count {n} not divisible by time={time}")
    local = jax.local_device_count()
    if time > local:
        raise ValueError(
            f"time={time} spans hosts (local={local}); keep the horizon "
            "axis within one host"
        )
    arr = np.asarray(devices).reshape(n // time, time)
    return Mesh(arr, axis_names=("batch", "time"))
