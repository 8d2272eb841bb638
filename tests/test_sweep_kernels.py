"""The Triton Riccati sweeps (ops/pallas_riccati): math, lowering, and
the choice of implementation.

On the CPU the kernels run under the Pallas interpreter (f64, against
the NumPy oracle and the XLA sweep) and are lowered for CUDA without
compiling; the compiled kernels run only on a GPU (tests marked
``gpu``, and chip_smoke.py).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdp_lqr_tpu import init_iterates
from pdp_lqr_tpu.models import mass_spring_chain, quadrotor, random_lq
from pdp_lqr_tpu.ops import pallas_riccati as pr
from pdp_lqr_tpu.utils import oracle

SIGMA = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODELS = {
    "random_lq": lambda: random_lq(4, 2, 8, nc=2, seed=3),
    "quadrotor": lambda: quadrotor(N=8, constrained=True)[0],
    "mass_spring": lambda: mass_spring_chain(n_masses=4, n_actuated=2, N=6),
}


def _scenarios(problem, B, seed=0):
    """Shared model + per-scenario drift; x0 (B, nx)."""
    rng = np.random.default_rng(seed)
    c_b = problem.c[None] + jnp.asarray(
        rng.normal(size=(B,) + problem.c.shape) * 0.01)
    x0 = jnp.asarray(rng.normal(size=(B, problem.nx)) * 0.1)
    return dataclasses.replace(problem, c=c_b), x0


def _oracle(sp, x0):
    it = init_iterates(sp, rho=0.01)
    base = dataclasses.replace(sp, c=sp.c[0])
    return np.stack([
        oracle.riccati_numpy(dataclasses.replace(base, c=sp.c[b]), it,
                             SIGMA, np.asarray(x0[b]))
        for b in range(x0.shape[0])])


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("mode", ["replicated", "shared"])
def test_interpret_matches_oracle(mode, model):
    """The kernels under the interpreter vs the NumPy Riccati oracle."""
    sp, x0 = _scenarios(MODELS[model](), B=3)
    it = init_iterates(sp, rho=0.01)
    if mode == "shared":
        ws = pr.solve_shared(sp, it, x0, SIGMA, impl="interpret")
    else:
        B = x0.shape[0]
        tile = lambda x: jnp.broadcast_to(x, (B,) + x.shape)
        bp = dataclasses.replace(
            jax.tree.map(tile, dataclasses.replace(sp, c=sp.c[0])), c=sp.c)
        its = jax.tree.map(tile, it)
        ws = pr.solve_batched(bp, its, x0, SIGMA, impl="interpret")
    np.testing.assert_allclose(np.asarray(ws), _oracle(sp, x0), atol=1e-9)


def _stage_arrays(nx, nu, nc, N, B, seed=0, dtype=np.float64):
    """Random well-posed batch-leading stage data (H SPD, D with rho)."""
    rng = np.random.default_rng(seed)
    nz = nx + nu
    f = lambda *s: jnp.asarray(rng.normal(size=(B,) + s) * 0.1, dtype)
    M = rng.normal(size=(nz, nz)) * 0.2
    H = np.broadcast_to(M @ M.T + np.eye(nz), (B, N, nz, nz))
    return dict(A=jnp.asarray(np.eye(nx), dtype) + f(N, nx, nx),
                B=f(N, nx, nu), c=f(N, nx), H=jnp.asarray(H, dtype),
                h=f(N, nz),
                D=f(N, nc, nz) if nc else None,
                rho=jnp.full((B, N, nc), 0.3, dtype) if nc else None,
                rg=f(N, nc) if nc else None,
                PN=jnp.asarray(np.broadcast_to(np.eye(nx), (B, nx, nx)),
                               dtype),
                pN=f(nx))


def test_tiles_past_matrix_edges_odd_batch():
    """Small matrices inside 16-wide tiles (masked loads and stores)
    and an odd batch: kernel == XLA sweep."""
    a = _stage_arrays(3, 2, 2, 4, 5)
    ref = pr.backward(**a, export_factors=True, impl="xla")
    out = pr.backward(**a, export_factors=True, impl="interpret")
    for r, o in zip(ref, out):
        assert o.shape == r.shape and o.shape[0] == 5
        np.testing.assert_allclose(np.asarray(o), np.asarray(r), atol=1e-10)


def test_cached_vector_sweep_matches_refactor():
    """backward_vectors on exported factors reproduces the factorizing
    sweep's d, for the kernel and the XLA sweep alike."""
    a = _stage_arrays(4, 2, 0, 5, 4, seed=1)
    for impl in ("interpret", "xla"):
        K, d, P, Hinv = pr.backward(**a, export_factors=True, impl=impl)
        d2 = pr.backward_vectors(a["A"], a["B"], a["c"], a["h"], P, K,
                                 Hinv, a["pN"], impl=impl)
        np.testing.assert_allclose(np.asarray(d2), np.asarray(d),
                                   atol=1e-11)


def test_shared_stage_tensors_match_replicated():
    """Shared (leading dim 1) stage tensors == the same data replicated."""
    a = _stage_arrays(3, 2, 2, 4, 1, seed=2)
    x0 = jnp.asarray(np.random.default_rng(5).normal(size=(5, 3)))
    rep = {k: (None if v is None else jnp.broadcast_to(
        v, (5,) + v.shape[1:])) for k, v in a.items()}
    K1, d1 = pr.backward(**a, impl="interpret")
    K2, d2 = pr.backward(**rep, impl="xla")
    np.testing.assert_allclose(np.asarray(K1[0]), np.asarray(K2[3]),
                               atol=1e-12)
    ws1, _ = pr.forward(a["A"], a["B"], a["c"], K1, d1, x0,
                        impl="interpret")
    ws2, _ = pr.forward(rep["A"], rep["B"], rep["c"], K2, d2, x0,
                        impl="xla")
    np.testing.assert_allclose(np.asarray(ws1), np.asarray(ws2),
                               atol=1e-12)


@pytest.mark.parametrize("nx,nu,nc", [(12, 4, 16), (24, 6, 6), (40, 10, 0)])
@pytest.mark.parametrize("variant", ["backward", "backward_export",
                                     "vectors", "forward"])
def test_cuda_lowering(variant, nx, nu, nc):
    """Each kernel lowers for CUDA through the Triton route (f32, the
    bench batch) — the GPU compiler itself runs only on the card."""
    S = jax.ShapeDtypeStruct
    f32 = jnp.float32
    N, B, nz = 512, 4096, nx + nu
    st = lambda *s: S((B, N) + s, f32)
    if variant.startswith("backward"):
        args = (st(nx, nx), st(nx, nu), st(nx), st(nz, nz), st(nz),
                st(nc, nz) if nc else None, st(nc) if nc else None,
                st(nc) if nc else None, S((B, nx, nx), f32), S((B, nx), f32))
        fn = lambda *a: pr.backward(
            *a, export_factors=variant == "backward_export", impl="triton")
    elif variant == "vectors":
        args = (st(nx, nx), st(nx, nu), st(nx), st(nz), st(nx, nx),
                st(nu, nx), st(nu, nu), S((B, nx), f32))
        fn = lambda *a: pr.backward_vectors(*a, impl="triton")
    else:
        args = (st(nx, nx), st(nx, nu), st(nx), st(nu, nx), st(nu),
                S((B, nx), f32))
        fn = lambda *a: pr.forward(*a, impl="triton")
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "triton" in text


@pytest.mark.parametrize("backend,nx,want", [
    ("gpu", 12, "triton"), ("gpu", "max", "triton"), ("gpu", "max+1", "xla"),
    ("cpu", 12, "xla"),
])
def test_choose_impl_by_platform(monkeypatch, backend, nx, want):
    nx = {"max": pr.KERNEL_MAX_NX, "max+1": pr.KERNEL_MAX_NX + 1}.get(nx, nx)
    monkeypatch.setattr(pr.jax, "default_backend", lambda: backend)
    assert pr.choose_impl(nx) == want


def test_choose_impl_explicit_and_unknown(monkeypatch):
    assert pr.choose_impl(40, "interpret") == "interpret"
    with pytest.raises(ValueError, match="unknown sweep impl"):
        pr.choose_impl(12, "mosaic")
    monkeypatch.setattr(pr.jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="no Riccati sweep"):
        pr.choose_impl(12)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    from pdp_lqr_tpu.utils import runtime

    calls = []
    monkeypatch.setattr(runtime.jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert runtime.enable_compile_cache() == str(tmp_path)
        assert calls == []          # JAX reads the variable itself
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(ROOT, ".jax_cache")
        assert runtime.enable_compile_cache() == want
        assert calls == [("jax_compilation_cache_dir", want)]


def test_roofline_needs_known_device():
    from pdp_lqr_tpu.utils import profiling

    with pytest.raises(KeyError, match="no published peaks"):
        profiling.riccati_roofline(512, 12, 4, 16, 4096, "cpu")


def test_chip_smoke_fails_without_gpu():
    """No GPU: non-zero exit and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


@pytest.mark.gpu
def test_triton_matches_xla_on_gpu(gpu):
    """Compiled kernels vs the XLA sweep on the card, f32."""
    a = _stage_arrays(12, 4, 16, 64, 256, dtype=np.float32)
    K1, d1 = pr.backward(**a, impl="triton")
    K2, d2 = pr.backward(**a, impl="xla")
    scale = float(jnp.max(jnp.abs(K2)))
    assert float(jnp.max(jnp.abs(K1 - K2))) <= 1e-4 * scale
