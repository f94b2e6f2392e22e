// Dense OSQP-style ADMM QP solver, C++ core.
//
// This is the framework's native equivalent of the compiled solver
// backends the reference reaches through qpsolvers.solve_problem
// (reference src/qp_problems.py:211 -> cvxopt/osqp/quadprog C/C++ code):
// a self-contained dense operator-splitting solver for
//
//     minimize    0.5 x'Px + q'x
//     subject to  l  <= Cx <= u        (m rows; equality rows have l == u)
//                 lb <=  x <= ub
//
// mirroring the algorithm of the device solver (porqua_tpu_torch/qp/admm.py)
// so CPU-vs-device parity checks compare like with like: same splitting,
// same per-row rho weighting for equality rows, same termination rules.
// Used as the serial-CPU baseline in bench.py and as an independent
// reference implementation in tests.
//
// Exported C ABI (see porqua_tpu_torch/native/__init__.py for the ctypes
// binding): one solve per call; batches are driven host-side, serially —
// exactly the execution model of the reference's per-date dispatch loop.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// Lower-triangular Cholesky factorization in place; returns false if the
// matrix is not positive definite to working precision.
bool cholesky(std::vector<double>& A, int n) {
  for (int j = 0; j < n; ++j) {
    double d = A[j * n + j];
    for (int k = 0; k < j; ++k) d -= A[j * n + k] * A[j * n + k];
    if (d <= 0.0) return false;
    const double Ljj = std::sqrt(d);
    A[j * n + j] = Ljj;
    for (int i = j + 1; i < n; ++i) {
      double s = A[i * n + j];
      for (int k = 0; k < j; ++k) s -= A[i * n + k] * A[j * n + k];
      A[i * n + j] = s / Ljj;
    }
  }
  return true;
}

// Solve L L' x = b given the factor from cholesky().
void cho_solve(const std::vector<double>& L, int n, std::vector<double>& b) {
  for (int i = 0; i < n; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i * n + k] * b[k];
    b[i] = s / L[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = b[i];
    for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * b[k];
    b[i] = s / L[i * n + i];
  }
}

double inf_norm(const double* v, int n) {
  double m = 0.0;
  for (int i = 0; i < n; ++i) m = std::max(m, std::fabs(v[i]));
  return m;
}

}  // namespace

extern "C" {

// Status codes match porqua_tpu_torch.qp.admm.Status.
enum Status : int32_t {
  kRunning = 0,
  kSolved = 1,
  kMaxIter = 2,
};

// Solves one QP. All matrices row-major float64. Returns the status.
//   P (n*n), q (n), C (m*n), l (m), u (m), lb (n), ub (n)
//   out_x (n), out_y (m), out_mu (n), out_info (4): iters, prim_res,
//   dual_res, obj_val.
int32_t porqua_solve_qp(const double* P, const double* q,
                        const double* C, const double* l, const double* u,
                        const double* lb, const double* ub,
                        int32_t n, int32_t m,
                        double eps_abs, double eps_rel,
                        int32_t max_iter, int32_t check_interval,
                        double rho0, double rho_eq_scale,
                        double sigma, double alpha,
                        double* out_x, double* out_y, double* out_mu,
                        double* out_info) {
  std::vector<double> rho(m), x(n, 0.0), z(m, 0.0), w(n), y(m, 0.0),
      mu(n, 0.0), xt(n), zt(m), rhs(n);
  for (int i = 0; i < m; ++i) {
    const bool eq = std::isfinite(l[i]) && std::isfinite(u[i]) &&
                    (u[i] - l[i]) <= 1e-10;
    rho[i] = eq ? rho0 * rho_eq_scale : rho0;
  }
  const double rho_b = rho0;
  for (int i = 0; i < n; ++i)
    w[i] = std::min(std::max(0.0, lb[i]), ub[i]);

  // K = P + sigma I + C' diag(rho) C + rho_b I, factorized once (rho is
  // not adapted in the native path; the baseline favors predictability).
  std::vector<double> K(static_cast<size_t>(n) * n);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      double v = P[i * n + j];
      if (i == j) v += sigma + rho_b;
      for (int r = 0; r < m; ++r) v += C[r * n + i] * rho[r] * C[r * n + j];
      K[i * n + j] = v;
    }
  if (!cholesky(K, n)) {
    // Not PD even after regularization: report cleanly instead of
    // leaving the output buffers uninitialized.
    std::memset(out_x, 0, n * sizeof(double));
    std::memset(out_y, 0, m * sizeof(double));
    std::memset(out_mu, 0, n * sizeof(double));
    out_info[0] = 0.0;
    out_info[1] = kInf;
    out_info[2] = kInf;
    out_info[3] = 0.0;
    return kMaxIter;
  }

  int32_t iters = 0;
  bool converged = false;
  double r_prim = kInf, r_dual = kInf;
  std::vector<double> Cx(m), dual_vec(n);

  while (iters < max_iter) {
    for (int step = 0; step < check_interval; ++step) {
      // rhs = sigma x - q + C'(rho z - y) + (rho_b w - mu)
      for (int i = 0; i < n; ++i)
        rhs[i] = sigma * x[i] - q[i] + rho_b * w[i] - mu[i];
      for (int r = 0; r < m; ++r) {
        const double s = rho[r] * z[r] - y[r];
        for (int i = 0; i < n; ++i) rhs[i] += C[r * n + i] * s;
      }
      std::memcpy(xt.data(), rhs.data(), n * sizeof(double));
      cho_solve(K, n, xt);
      for (int r = 0; r < m; ++r) {
        double s = 0.0;
        for (int i = 0; i < n; ++i) s += C[r * n + i] * xt[i];
        zt[r] = s;
      }
      for (int i = 0; i < n; ++i) x[i] = alpha * xt[i] + (1 - alpha) * x[i];
      for (int r = 0; r < m; ++r) {
        const double z_relax = alpha * zt[r] + (1 - alpha) * z[r];
        const double z_arg = z_relax + y[r] / rho[r];
        const double z_new = std::min(std::max(z_arg, l[r]), u[r]);
        y[r] += rho[r] * (z_relax - z_new);
        z[r] = z_new;
      }
      for (int i = 0; i < n; ++i) {
        const double w_relax = alpha * xt[i] + (1 - alpha) * w[i];
        const double w_arg = w_relax + mu[i] / rho_b;
        const double w_new = std::min(std::max(w_arg, lb[i]), ub[i]);
        mu[i] += rho_b * (w_relax - w_new);
        w[i] = w_new;
      }
    }
    iters += check_interval;

    for (int r = 0; r < m; ++r) {
      double s = 0.0;
      for (int i = 0; i < n; ++i) s += C[r * n + i] * x[i];
      Cx[r] = s;
    }
    double rp = 0.0;
    for (int r = 0; r < m; ++r) rp = std::max(rp, std::fabs(Cx[r] - z[r]));
    for (int i = 0; i < n; ++i) rp = std::max(rp, std::fabs(x[i] - w[i]));
    // OSQP-style relative scales, matching porqua_tpu_torch/qp/admm.py
    // _residuals: denom_d = max(|Px|, |C'y|, |q|, |mu|)_inf.
    double norm_Px = 0.0, norm_Cty = 0.0;
    for (int i = 0; i < n; ++i) {
      double Px = 0.0;
      for (int j = 0; j < n; ++j) Px += P[i * n + j] * x[j];
      double Cty = 0.0;
      for (int r = 0; r < m; ++r) Cty += C[r * n + i] * y[r];
      norm_Px = std::max(norm_Px, std::fabs(Px));
      norm_Cty = std::max(norm_Cty, std::fabs(Cty));
      dual_vec[i] = Px + q[i] + Cty + mu[i];
    }
    const double rd = inf_norm(dual_vec.data(), n);

    double denom_p = std::max(inf_norm(Cx.data(), m), inf_norm(z.data(), m));
    denom_p = std::max(denom_p, std::max(inf_norm(x.data(), n), inf_norm(w.data(), n)));
    double denom_d = std::max(std::max(norm_Px, norm_Cty),
                              std::max(inf_norm(q, n), inf_norm(mu.data(), n)));
    const double eps_p = eps_abs + eps_rel * denom_p;
    const double eps_d = eps_abs + eps_rel * denom_d;
    r_prim = rp;
    r_dual = rd;
    if (rp <= eps_p && rd <= eps_d) {
      converged = true;
      break;
    }
  }

  std::memcpy(out_x, x.data(), n * sizeof(double));
  std::memcpy(out_y, y.data(), m * sizeof(double));
  std::memcpy(out_mu, mu.data(), n * sizeof(double));
  double obj = 0.0;
  for (int i = 0; i < n; ++i) {
    double Px = 0.0;
    for (int j = 0; j < n; ++j) Px += P[i * n + j] * x[j];
    obj += 0.5 * x[i] * Px + q[i] * x[i];
  }
  out_info[0] = static_cast<double>(iters);
  out_info[1] = r_prim;
  out_info[2] = r_dual;
  out_info[3] = obj;
  return converged ? kSolved : kMaxIter;
}

}  // extern "C"
