"""Profiling / observability helpers.

Reference status: tracing is vestigial there — a fully commented-out
Tracy client (CMakeLists.txt:24-32,67; lqr_solver_parallel.hpp:10,143)
and example-level wall-clock prints (lqr_example.cpp:178-185).  Here
the same needs are served by jax.profiler traces plus a small timing
harness and a roofline model for the batched sweeps.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@dataclass
class Timing:
    compile_s: float
    p50_ms: float
    mean_ms: float
    iters: int

    def __repr__(self):
        return (f"Timing(compile={self.compile_s:.2f}s, "
                f"p50={self.p50_ms:.3f}ms, mean={self.mean_ms:.3f}ms)")


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 1) -> Timing:
    """Wall-clock a jitted function: compile time + per-call p50/mean."""
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0
    for _ in range(max(0, warmup - 1)):
        jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    samples.sort()
    p50 = samples[len(samples) // 2] * 1e3
    mean = sum(samples) / len(samples) * 1e3
    return Timing(compile_s=compile_s, p50_ms=p50, mean_ms=mean, iters=iters)


# Published peaks per device, keyed by jax's ``device_kind``.  Dense
# rates without sparsity; float32 outside the tensor cores, since the
# solvers pin "highest" matmul precision (no TF32).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "f32_flops_per_s": 67e12,
        "source": "NVIDIA H100 SXM data sheet (700 W)",
    },
}


def peaks(device_kind: str) -> dict:
    """Peak rates of ``device_kind``; an unknown device is an error."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[device_kind]


def riccati_roofline(N: int, nx: int, nu: int, nc: int, B: int,
                     device_kind: str, dtype_bytes: int = 4):
    """Analytic bounds for the factorizing backward sweep on one device.

    Returns dict with bytes/solve, flops/solve, and the memory/compute
    time bounds against the published peaks of ``device_kind`` — how
    far a measured sweep time sits from speed-of-light.
    """
    pk = peaks(device_kind)
    nz = nx + nu
    words_per_stage = (
        nx * nx + nx * nu + nx          # A, B, c
        + nz * nz + nz                  # H, h
        + nc * nz + 2 * nc              # D, rho, rg
    )
    out_words = nu * nx + nu             # K, d
    bytes_total = (words_per_stage + out_words) * N * B * dtype_bytes

    fold = nc * nz * (nz + 1)
    # Symmetric products (P+, Huu) are computed triangle-only
    # (ops/pallas_riccati), so the model counts tri(nx) entries for P+
    # and tri(nu) rows for Huu.
    tri_x = nx * (nx + 1) // 2
    tri_u = nu * (nu + 1) // 2
    matmuls = (
        nx ** 3 + nx * nx * nu          # PA, PB
        + nu * nx * nx                  # G = S + B^T PA
        + tri_x * (nx + nu)             # P+ upper: A^T PA + G^T K
        + tri_u * nx                    # Huu lower: R + B^T PB
    )
    chol = nu ** 3 // 3 + (nx + 1) * nu * nu
    vecs = 6 * nx * nx
    flops_total = 2 * (fold + matmuls + chol + vecs) * N * B

    t_mem = bytes_total / pk["hbm_bytes_per_s"]
    t_compute = flops_total / pk["f32_flops_per_s"]
    return {
        "bytes_per_batched_solve": bytes_total,
        "flops_per_batched_solve": flops_total,
        "t_mem_ms": t_mem * 1e3,
        "t_compute_ms": t_compute * 1e3,
        "bound": "compute" if t_compute > t_mem else "memory",
    }


def failure_mask(ws) -> jax.Array:
    """Per-instance non-finite detection (no host sync).

    The reference signals numeric failure by a bool return the caller
    ignores (condensed_system.hpp:217-226 vs lqr_solver_parallel.hpp:145)
    or a throw (qdldl_solver.hpp:106-108); here failures surface as NaN
    and are reduced to a (B,) mask the caller batches over.
    """
    import jax.numpy as jnp

    axes = tuple(range(1, ws.ndim))
    return ~jnp.all(jnp.isfinite(ws), axis=axes)
