// Native CPU batch engine for constrained LQ inner solves.
//
// Role in the framework: the reference (Luyao787/PDP-LQR) is a
// header-only C++/Eigen/OpenMP library; this package keeps its compute
// path in JAX/XLA/Pallas, and this translation-unit provides the
// native-runtime counterpart — a dependency-free C++17 implementation
// of the same inner KKT solve (sigma-regularized, penalty-folded
// sequential Riccati; equations as in include/clqr/lqr/lqr_kernel.hpp
// of the reference, re-derived and written independently) with a
// std::thread batch driver standing in for the reference's OpenMP
// parallel region (lqr_solver_parallel.hpp:102-162).
//
// Uses: (1) compiled independent parity witness for the JAX backends,
// (2) fast host-side fallback when no accelerator is attached,
// (3) data-loader-side warm-start generation without touching the GPU.
//
// No Eigen / BLAS: matrices here are <= ~64x64, where simple
// loop-tiled scalar code at -O3 is competitive and keeps the build
// dependency-free (g++ -O3 -shared -fPIC, see utils/native.py).

#include <cmath>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Row-major dense helpers (m x n). All loops are over tiny static-ish
// bounds; let the compiler vectorize.

inline void matmul_nt(const double* X, const double* Y, double* Z,
                      int m, int k, int n) {
  // Z (m x n) = X (m x k) * Y^T stored as Y (n x k)?  No — keep it
  // simple: Z = X * Y with Y row-major (k x n).
  for (int i = 0; i < m; ++i) {
    for (int j = 0; j < n; ++j) Z[i * n + j] = 0.0;
    for (int t = 0; t < k; ++t) {
      const double x = X[i * k + t];
      const double* yrow = Y + t * n;
      double* zrow = Z + i * n;
      for (int j = 0; j < n; ++j) zrow[j] += x * yrow[j];
    }
  }
}

inline void matvec(const double* X, const double* v, double* out,
                   int m, int n) {
  for (int i = 0; i < m; ++i) {
    double s = 0.0;
    const double* row = X + i * n;
    for (int j = 0; j < n; ++j) s += row[j] * v[j];
    out[i] = s;
  }
}

inline void matvec_t(const double* X, const double* v, double* out,
                     int m, int n) {
  // out (n) = X^T (n x m) * v (m), X row-major (m x n).
  for (int j = 0; j < n; ++j) out[j] = 0.0;
  for (int i = 0; i < m; ++i) {
    const double x = v[i];
    const double* row = X + i * n;
    for (int j = 0; j < n; ++j) out[j] += x * row[j];
  }
}

// In-place lower Cholesky of SPD (n x n). Returns false on failure.
inline bool cholesky(double* M, int n) {
  for (int j = 0; j < n; ++j) {
    double d = M[j * n + j];
    for (int t = 0; t < j; ++t) d -= M[j * n + t] * M[j * n + t];
    if (d <= 0.0) return false;
    const double ljj = std::sqrt(d);
    M[j * n + j] = ljj;
    const double inv = 1.0 / ljj;
    for (int i = j + 1; i < n; ++i) {
      double s = M[i * n + j];
      for (int t = 0; t < j; ++t) s -= M[i * n + t] * M[j * n + t];
      M[i * n + j] = s * inv;
    }
    for (int i = 0; i < j; ++i) M[i * n + j] = 0.0;  // zero upper
  }
  return true;
}

// Solve (L L^T) x = b in place, L lower (n x n).
inline void chol_solve(const double* L, double* b, int n) {
  for (int i = 0; i < n; ++i) {
    double s = b[i];
    for (int t = 0; t < i; ++t) s -= L[i * n + t] * b[t];
    b[i] = s / L[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = b[i];
    for (int t = i + 1; t < n; ++t) s -= L[t * n + i] * b[t];
    b[i] = s / L[i * n + i];
  }
}

struct Work {
  std::vector<double> P, p, Pn, pn, Hf, hf, PA, PB, Pcp, G, Huu, rbar,
      K, d, Kall, dall, tmp;
};

// One instance: sigma-regularized, penalty-folded Riccati backward +
// forward.  Layouts are row-major, stage-major (see clqr_solve_batch).
void solve_one(int N, int nx, int nu, int nc, const double* A,
               const double* Bm, const double* c, const double* H,
               const double* h, const double* D, const double* rho,
               const double* g, const double* x0, double sigma,
               double* ws, Work& w) {
  const int nz = nx + nu;
  w.P.assign(nx * nx, 0.0);
  w.p.assign(nx, 0.0);
  w.Hf.assign(nz * nz, 0.0);
  w.hf.assign(nz, 0.0);
  w.PA.assign(nx * nx, 0.0);
  w.PB.assign(nx * nu, 0.0);
  w.Pcp.assign(nx, 0.0);
  w.G.assign(nu * nx, 0.0);
  w.Huu.assign(nu * nu, 0.0);
  w.rbar.assign(nu, 0.0);
  w.K.assign(nu * nx, 0.0);
  w.d.assign(nu, 0.0);
  w.Kall.assign((size_t)N * nu * nx, 0.0);
  w.dall.assign((size_t)N * nu, 0.0);
  w.tmp.assign(nz, 0.0);

  auto fold = [&](int k) {
    // Hf = H_k + sigma I (+ D^T rho D); hf = h_k (- D^T rho g).
    const double* Hk = H + (size_t)k * nz * nz;
    const double* hk = h + (size_t)k * nz;
    std::memcpy(w.Hf.data(), Hk, sizeof(double) * nz * nz);
    std::memcpy(w.hf.data(), hk, sizeof(double) * nz);
    for (int i = 0; i < nz; ++i) w.Hf[i * nz + i] += sigma;
    for (int ci = 0; ci < nc; ++ci) {
      const double r = rho[(size_t)k * nc + ci];
      if (r == 0.0) continue;
      const double* Dr = D + ((size_t)k * nc + ci) * nz;
      const double rg = r * g[(size_t)k * nc + ci];
      for (int i = 0; i < nz; ++i) {
        const double ri = r * Dr[i];
        for (int j = 0; j < nz; ++j) w.Hf[i * nz + j] += ri * Dr[j];
        w.hf[i] -= rg * Dr[i];
      }
    }
  };

  // Terminal: P = Hf_xx, p = hf_x (x-block of the folded terminal cost).
  fold(N);
  for (int i = 0; i < nx; ++i) {
    for (int j = 0; j < nx; ++j)
      w.P[i * nx + j] = w.Hf[(nu + i) * nz + (nu + j)];
    w.p[i] = w.hf[nu + i];
  }

  for (int k = N - 1; k >= 0; --k) {
    fold(k);
    const double* Ak = A + (size_t)k * nx * nx;
    const double* Bk = Bm + (size_t)k * nx * nu;
    const double* ck = c + (size_t)k * nx;

    matmul_nt(w.P.data(), Ak, w.PA.data(), nx, nx, nx);
    matmul_nt(w.P.data(), Bk, w.PB.data(), nx, nx, nu);
    matvec(w.P.data(), ck, w.Pcp.data(), nx, nx);
    for (int i = 0; i < nx; ++i) w.Pcp[i] += w.p[i];

    // G = S~ + B^T PA   (S~ = Hf[u rows, x cols]); Huu = R~ + B^T PB.
    for (int i = 0; i < nu; ++i)
      for (int j = 0; j < nx; ++j) {
        double s = w.Hf[i * nz + (nu + j)];
        for (int t = 0; t < nx; ++t) s += Bk[t * nu + i] * w.PA[t * nx + j];
        w.G[i * nx + j] = s;
      }
    for (int i = 0; i < nu; ++i)
      for (int j = 0; j < nu; ++j) {
        double s = w.Hf[i * nz + j];
        for (int t = 0; t < nx; ++t) s += Bk[t * nu + i] * w.PB[t * nu + j];
        w.Huu[i * nu + j] = s;
      }
    for (int i = 0; i < nu; ++i) {
      double s = w.hf[i];
      for (int t = 0; t < nx; ++t) s += Bk[t * nu + i] * w.Pcp[t];
      w.rbar[i] = s;
    }

    cholesky(w.Huu.data(), nu);
    // K = -Huu^{-1} G (column-wise), d = -Huu^{-1} rbar.
    for (int j = 0; j < nx; ++j) {
      for (int i = 0; i < nu; ++i) w.d[i] = w.G[i * nx + j];
      chol_solve(w.Huu.data(), w.d.data(), nu);
      for (int i = 0; i < nu; ++i) w.K[i * nx + j] = -w.d[i];
    }
    std::memcpy(w.d.data(), w.rbar.data(), sizeof(double) * nu);
    chol_solve(w.Huu.data(), w.d.data(), nu);
    for (int i = 0; i < nu; ++i) w.d[i] = -w.d[i];

    std::memcpy(w.Kall.data() + (size_t)k * nu * nx, w.K.data(),
                sizeof(double) * nu * nx);
    std::memcpy(w.dall.data() + (size_t)k * nu, w.d.data(),
                sizeof(double) * nu);

    // P' = Q~ + A^T PA + G^T K (symmetrized); p' = q~ + A^T Pcp + K^T rbar.
    w.Pn.assign(nx * nx, 0.0);
    w.pn.assign(nx, 0.0);
    for (int i = 0; i < nx; ++i)
      for (int j = 0; j < nx; ++j) {
        double s = w.Hf[(nu + i) * nz + (nu + j)];
        for (int t = 0; t < nx; ++t) s += Ak[t * nx + i] * w.PA[t * nx + j];
        for (int t = 0; t < nu; ++t) s += w.G[t * nx + i] * w.K[t * nx + j];
        w.Pn[i * nx + j] = s;
      }
    for (int i = 0; i < nx; ++i)
      for (int j = 0; j < i; ++j) {
        const double s = 0.5 * (w.Pn[i * nx + j] + w.Pn[j * nx + i]);
        w.Pn[i * nx + j] = s;
        w.Pn[j * nx + i] = s;
      }
    for (int i = 0; i < nx; ++i) {
      double s = w.hf[nu + i];
      for (int t = 0; t < nx; ++t) s += Ak[t * nx + i] * w.Pcp[t];
      for (int t = 0; t < nu; ++t) s += w.K[t * nx + i] * w.rbar[t];
      w.pn[i] = s;
    }
    std::swap(w.P, w.Pn);
    std::swap(w.p, w.pn);
  }

  // Forward rollout: u = K x + d; x+ = A x + B u + c.
  std::vector<double> x(x0, x0 + nx), xn(nx), u(nu);
  for (int k = 0; k < N; ++k) {
    const double* Ak = A + (size_t)k * nx * nx;
    const double* Bk = Bm + (size_t)k * nx * nu;
    const double* ck = c + (size_t)k * nx;
    const double* Kk = w.Kall.data() + (size_t)k * nu * nx;
    const double* dk = w.dall.data() + (size_t)k * nu;
    matvec(Kk, x.data(), u.data(), nu, nx);
    for (int i = 0; i < nu; ++i) u[i] += dk[i];
    double* row = ws + (size_t)k * nz;
    for (int i = 0; i < nu; ++i) row[i] = u[i];
    for (int i = 0; i < nx; ++i) row[nu + i] = x[i];
    matvec(Ak, x.data(), xn.data(), nx, nx);
    for (int i = 0; i < nx; ++i) {
      double s = xn[i] + ck[i];
      for (int t = 0; t < nu; ++t) s += Bk[i * nu + t] * u[t];
      xn[i] = s;
    }
    std::swap(x, xn);
  }
  double* last = ws + (size_t)N * nz;
  for (int i = 0; i < nu; ++i) last[i] = 0.0;
  for (int i = 0; i < nx; ++i) last[nu + i] = x[i];
}

}  // namespace

extern "C" {

// Batched solve; arrays row-major with layouts:
//   A (B,N,nx,nx)  Bm (B,N,nx,nu)  c (B,N,nx)
//   H (B,N+1,nz,nz)  h (B,N+1,nz)  D (B,N+1,nc,nz)
//   rho/g (B,N+1,nc)  x0 (B,nx)  ws_out (B,N+1,nz)
// n_threads <= 0 -> hardware_concurrency.
int clqr_solve_batch(int B, int N, int nx, int nu, int nc,
                     const double* A, const double* Bm, const double* c,
                     const double* H, const double* h, const double* D,
                     const double* rho, const double* g, const double* x0,
                     double sigma, int n_threads, double* ws_out) {
  if (B <= 0 || N <= 0 || nx <= 0 || nu <= 0 || nc < 0) return -1;
  const int nz = nx + nu;
  int nt = n_threads > 0
               ? n_threads
               : static_cast<int>(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (nt > B) nt = B;

  auto worker = [&](int tid) {
    Work w;
    for (int b = tid; b < B; b += nt) {
      solve_one(N, nx, nu, nc, A + (size_t)b * N * nx * nx,
                Bm + (size_t)b * N * nx * nu, c + (size_t)b * N * nx,
                H + (size_t)b * (N + 1) * nz * nz,
                h + (size_t)b * (N + 1) * nz,
                D + (size_t)b * (N + 1) * nc * nz,
                rho + (size_t)b * (N + 1) * nc,
                g + (size_t)b * (N + 1) * nc, x0 + (size_t)b * nx, sigma,
                ws_out + (size_t)b * (N + 1) * nz, w);
    }
  };

  if (nt == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
  return 0;
}

}  // extern "C"
