"""Mesh construction helpers."""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(batch: int = 1, time: int = 1, devices=None) -> Mesh:
    """Create a ("batch", "time") mesh from the available devices.

    batch * time must equal the device count used.  The "time" axis
    carries horizon segments (the condensed boundary exchange
    all-gathers over it every solve); the "batch" axis carries
    independent problem instances (no communication).  GPUs of one
    host reach each other all to all, so the mesh shape follows the
    algorithm, not a device topology.
    """
    if devices is None:
        devices = jax.devices()
    n = batch * time
    if len(devices) < n:
        raise ValueError(
            f"need {n} devices for mesh ({batch=}, {time=}), have {len(devices)}"
        )
    arr = np.asarray(devices[:n]).reshape(batch, time)
    return Mesh(arr, axis_names=("batch", "time"))
