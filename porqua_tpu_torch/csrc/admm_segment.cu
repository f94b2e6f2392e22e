// Fused ADMM segment kernels for Hopper (sm_90a), float32.
//
// Replaces the two Pallas TPU kernels of porqua_tpu/ops/admm_kernel.py:
//   admm_segment (dense operator; triangular L^-1 or explicit K^-1) and
//   admm_segment_factored (Woodbury capacitance operator).
// Each launch runs n_iters OSQP iterations for a batch of scaled
// problems, one thread block per problem, and writes the final state
// plus the last-iteration increments (x, z, w, y, mu, dx, dy, dmu).
//
// Design: the n- and m-vectors of the state and every temporary live
// in dynamic shared memory for the whole segment. The large operator
// (L^-1, K^-1, or W and V) is read from device memory on every
// iteration: at n = 500 it is 1 MB (dense) or 0.5 MB (W) per problem,
// more than one SM's shared memory. The dense form reads C from device
// memory beside it, so its shared memory holds only the O(n + m)
// vectors, 4 (14 n + 10 m) bytes: it serves every dense shape up to
// n = 1,664 at m = 2,048 (175 KB), the service's (1024, 128) rung
// included, where C alone would be 512 KB. The factored form keeps the
// m-wide matrices of its Schur step (C, Y0 and Ginv) in shared memory.
// The matvecs are f32 FMA on the CUDA cores (no tensor cores, hence no
// TF32): v M' is a warp per row
// with a shuffle reduction, v M a thread per column with the loop over
// rows coalesced across threads and summed in blocks of rows. The
// ragged edge is masked by the loop bounds; nothing is padded. One
// __device__ iteration serves both operator kinds, so the forms cannot
// drift apart, and its elementwise updates are the cluster kernels'
// (cluster_common.cuh). The factored form's Schur step is f64 (see
// FactoredSolve). Both operator kinds have a second design, on a
// thread-block cluster with the operator in shared memory
// (admm_segment_cluster.cu, admm_segment_dense_cluster.cu), for the
// shapes where it fits; this one serves every shape whose state fits
// one block. The factored kind has a third, the cluster kernel with
// every matrix left in device memory (cluster_kernel<true>), for the
// shapes where neither fits.
//
// Plain C interface for ctypes: every launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "cluster_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[r] = sum_j M[r, j] v[j] for r < rows (M row-major, rows x cols).
// lower: M is lower-triangular, only j <= r is read.
// A warp per row for wide rows, a thread per row for narrow ones.
__device__ void mv_rows(const float* __restrict__ M, int rows, int cols,
                        const float* v, float* out, bool lower) {
  if (cols < 32 && !lower) {
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const float* row = M + (size_t)r * cols;
      float acc = 0.f;
      for (int j = 0; j < cols; ++j) acc = fmaf(row[j], v[j], acc);
      out[r] = acc;
    }
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const float* row = M + (size_t)r * cols;
    const int end = lower ? r + 1 : cols;
    float acc = 0.f;
#pragma unroll 4
    for (int j = lane; j < end; j += 32) acc = fmaf(row[j], v[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) out[r] = acc;
  }
}

// Rows of one block of vm_cols' sum.
constexpr int kSumBlock = 64;

// out[j] = sum_r v[r] M[r, j] for j < cols. A thread per column.
// lower: M is lower-triangular, only r >= j is read.
// The sum over rows is blocked: each block of kSumBlock rows is summed
// serially, then the blocks' sums in order. A single serial sum over a
// long column (k = 1024) lost several times the plain version's
// accuracy; a column of at most kSumBlock rows is summed as before.
__device__ void vm_cols(const float* v, const float* __restrict__ M,
                        int rows, int cols, float* out, bool lower) {
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    const float* col = M + j;
    float total = 0.f;
    for (int r0 = lower ? j : 0; r0 < rows; r0 += kSumBlock) {
      const int end = min(rows, r0 + kSumBlock);
      float acc = 0.f;
#pragma unroll 8
      for (int r = r0; r < end; ++r)
        acc = fmaf(v[r], col[(size_t)r * cols], acc);
      total = r0 == (lower ? j : 0) ? acc : total + acc;
    }
    out[j] = total;
  }
}

// out[r] = sum_j M[r, j] v[j] for r < rows, summed in f64: a warp per
// row.
__device__ void rows_dot_f64(const float* M, int rows, int cols,
                             const float* v, double* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const float* row = M + (size_t)r * cols;
    double acc = 0.0;
    for (int j = lane; j < cols; j += 32) acc += (double)row[j] * v[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out[r] = acc;
  }
}

struct Inputs {
  // per-problem matrices (batch-strided)
  const float* op;     // dense: (n, n) L^-1 or K^-1
  const float* W;      // factored: (k, n)
  const float* inv_d;  // (n)
  const float* Y0;     // (n, m)
  const float* Ginv;   // (m, m)
  const float* V;      // (k, n), read only when refine_steps > 0
  const float* Dv;     // (n)
  const float* C;      // (m, n)
  const float *q, *l, *u, *lb, *ub, *rho, *rho_b, *l1w, *l1c;
  const float *x, *z, *w, *y, *mu;
  float *x_out, *z_out, *w_out, *y_out, *mu_out, *dx_out, *dy_out, *dmu_out;
  int n, m, k, n_iters, refine_steps, triangular;
  float sigma, alpha, one_m_alpha;
};

// Shared-memory layout, in floats. The one definition: the launchers
// size the launch by it and the Python wrapper asks for it before
// launching (porqua_admm_segment_smem_bytes).
constexpr int kVecN = 14;      // x w mu q lb ub rho_b l1w l1c rhs xt xprev muprev tmp
constexpr int kVecNFact = 5;   // inv_d Dv x0 r tmp2
constexpr int kVecM = 8;       // z y l u rho zt yprev tm

// The dense form reads C from device memory; the factored one holds it.
__host__ __device__ inline size_t smem_floats(bool factored, int n, int m,
                                              int k) {
  size_t f = 2 * (size_t)m  // C x0 in f64, first
             + (size_t)kVecN * n + (size_t)kVecM * m;
  if (factored)
    f += (size_t)m * n + (size_t)kVecNFact * n + (size_t)k + (size_t)n * m +
         (size_t)m * m;  // C, then the factored vectors, t, Y0, Ginv
  return f;
}

struct Smem {
  double* sd;  // C x0 of the factored Schur step, summed in f64
  float *x, *w, *mu, *q, *lb, *ub, *rho_b, *l1w, *l1c, *rhs, *xt, *xprev,
      *muprev, *tmp;
  float *z, *y, *l, *u, *rho, *zt, *yprev, *tm;
  const float* C;  // dense: in device memory; factored: in shared memory
  // factored only
  float *inv_d, *Dv, *x0, *r, *tmp2, *t, *Y0, *Ginv;
};

__device__ Smem carve(float* base, bool factored, int n, int m, int k) {
  Smem s;
  s.sd = reinterpret_cast<double*>(base);
  float* p = base + 2 * m;
  float** vn[kVecN] = {&s.x, &s.w, &s.mu, &s.q, &s.lb, &s.ub, &s.rho_b,
                       &s.l1w, &s.l1c, &s.rhs, &s.xt, &s.xprev, &s.muprev,
                       &s.tmp};
  for (int i = 0; i < kVecN; ++i) { *vn[i] = p; p += n; }
  float** vm[kVecM] = {&s.z, &s.y, &s.l, &s.u, &s.rho, &s.zt, &s.yprev,
                       &s.tm};
  for (int i = 0; i < kVecM; ++i) { *vm[i] = p; p += m; }
  s.C = nullptr;
  s.inv_d = s.Dv = s.x0 = s.r = s.tmp2 = s.t = s.Y0 = s.Ginv = nullptr;
  if (factored) {
    s.C = p; p += (size_t)m * n;
    float** vf[kVecNFact] = {&s.inv_d, &s.Dv, &s.x0, &s.r, &s.tmp2};
    for (int i = 0; i < kVecNFact; ++i) { *vf[i] = p; p += n; }
    s.t = p; p += k;
    s.Y0 = p; p += (size_t)n * m;
    s.Ginv = p;
  }
  return s;
}

__device__ __forceinline__ void load(float* dst, const float* src, size_t len) {
  for (size_t i = threadIdx.x; i < len; i += kThreads) dst[i] = src[i];
}

// Dense solve: xt = rhs @ K^-1, or L^-T (L^-1 rhs) when triangular.
struct DenseSolve {
  const float* op;
  int n;
  bool triangular;
  __device__ void operator()(const Smem& s, const float* rhs, float* xt) const {
    if (triangular) {
      mv_rows(op, n, n, rhs, s.tmp, true);
      __syncthreads();
      vm_cols(s.tmp, op, n, n, xt, true);
    } else {
      vm_cols(rhs, op, n, n, xt, false);
    }
    __syncthreads();
  }
};

// Factored solve: base(r) = inv_d r - (W r) W, refine_steps rounds of
// refinement against K = diag(Dv) + V'V, then the row Schur step
// xt = x0 - Y0 (Ginv (C x0)).
struct FactoredSolve {
  const float* W;
  const float* V;
  int n, m, k, refine_steps;

  // out = r * inv_d - (W r) W
  __device__ void base(const Smem& s, const float* r, float* out) const {
    mv_rows(W, k, n, r, s.t, false);
    __syncthreads();
    vm_cols(s.t, W, k, n, s.tmp, false);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads)
      out[j] = r[j] * s.inv_d[j] - s.tmp[j];
    __syncthreads();
  }

  __device__ void operator()(const Smem& s, const float* rhs, float* xt) const {
    base(s, rhs, s.x0);
    for (int it = 0; it < refine_steps; ++it) {
      mv_rows(V, k, n, s.x0, s.t, false);
      __syncthreads();
      vm_cols(s.t, V, k, n, s.tmp, false);
      __syncthreads();
      for (int j = threadIdx.x; j < n; j += kThreads)
        s.r[j] = rhs[j] - (s.Dv[j] * s.x0[j] + s.tmp[j]);
      __syncthreads();
      base(s, s.r, s.tmp2);
      for (int j = threadIdx.x; j < n; j += kThreads) s.x0[j] += s.tmp2[j];
      __syncthreads();
    }
    // The Schur step in f64: zt = C xt = C x0 - (C Y0) Ginv (C x0) is a
    // small difference of terms near C x0 where rho C K0^-1 C' is large,
    // so the rounding of an f32 C x0 comes back amplified in the row's
    // dual (past the twin rule at 2,048 assets, k = 256, and at 512, k =
    // 1024). xt = x0 - Y0 vv, vv = Ginv (C x0): each thread forms vv.
    rows_dot_f64(s.C, m, n, s.x0, s.sd);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      double acc = 0.0;
      for (int c = 0; c < m; ++c) {
        double vv = 0.0;
        for (int q = 0; q < m; ++q) vv += s.sd[q] * s.Ginv[q * m + c];
        acc += s.Y0[(size_t)j * m + c] * vv;
      }
      xt[j] = (float)(s.x0[j] - acc);
    }
    __syncthreads();
  }
};

// One OSQP iteration, shared by both operator kinds (the counterpart of
// _make_iteration): rhs build -> solve -> relaxed z-clip, prox, duals.
template <class Solve>
__device__ void one_iteration(const Smem& s, const Inputs& a, const Solve& solve) {
  const int n = a.n, m = a.m;
  const float al = a.alpha, one_m_al = a.one_m_alpha, sig = a.sigma;
  for (int r = threadIdx.x; r < m; r += kThreads) s.tm[r] = s.rho[r] * s.z[r] - s.y[r];
  __syncthreads();
  // rhs = sigma x - q + C'(rho z - y) + (rho_b w - mu)
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float ct = 0.f;
    for (int r = 0; r < m; ++r) ct = fmaf(s.tm[r], s.C[(size_t)r * n + j], ct);
    s.rhs[j] = (sig * s.x[j] - s.q[j]) + ct + (s.rho_b[j] * s.w[j] - s.mu[j]);
  }
  __syncthreads();
  solve(s, s.rhs, s.xt);
  mv_rows(s.C, m, n, s.xt, s.zt, false);
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kThreads)
    col_update(s.xt[j], al, one_m_al, s.rho_b[j], s.lb[j], s.ub[j], s.l1w[j],
               s.l1c[j], s.x[j], s.w[j], s.mu[j]);
  for (int r = threadIdx.x; r < m; r += kThreads)
    row_update(s.zt[r], al, one_m_al, s.rho[r], s.l[r], s.u[r], s.z[r],
               s.y[r]);
  __syncthreads();
}

// Two blocks per SM: the register cap (64) keeps the dense form (92
// registers without it) at two blocks of 512 threads per SM.
template <bool kFactored>
__global__ void __launch_bounds__(kThreads, 2) segment_kernel(Inputs a) {
  extern __shared__ __align__(16) float smem[];
  const int n = a.n, m = a.m, k = a.k;
  const size_t b = blockIdx.x;
  Smem s = carve(smem, kFactored, n, m, k);
  if (!kFactored) s.C = a.C + b * m * n;

  load(s.x, a.x + b * n, n);
  load(s.w, a.w + b * n, n);
  load(s.mu, a.mu + b * n, n);
  load(s.q, a.q + b * n, n);
  load(s.lb, a.lb + b * n, n);
  load(s.ub, a.ub + b * n, n);
  load(s.rho_b, a.rho_b + b * n, n);
  load(s.l1w, a.l1w + b * n, n);
  load(s.l1c, a.l1c + b * n, n);
  load(s.z, a.z + b * m, m);
  load(s.y, a.y + b * m, m);
  load(s.l, a.l + b * m, m);
  load(s.u, a.u + b * m, m);
  load(s.rho, a.rho + b * m, m);
  if (kFactored) {
    load(const_cast<float*>(s.C), a.C + b * m * n, (size_t)m * n);
    load(s.inv_d, a.inv_d + b * n, n);
    if (a.refine_steps > 0) load(s.Dv, a.Dv + b * n, n);
    load(s.Y0, a.Y0 + b * n * m, (size_t)n * m);
    load(s.Ginv, a.Ginv + b * m * m, (size_t)m * m);
  }
  __syncthreads();

  auto run = [&](const auto& solve) {
    for (int it = 0; it < a.n_iters; ++it) {
      if (it == a.n_iters - 1) {
        // Increments are between the last two iterates.
        for (int j = threadIdx.x; j < n; j += kThreads) {
          s.xprev[j] = s.x[j];
          s.muprev[j] = s.mu[j];
        }
        for (int r = threadIdx.x; r < m; r += kThreads) s.yprev[r] = s.y[r];
        __syncthreads();
      }
      one_iteration(s, a, solve);
    }
  };
  if constexpr (kFactored) {
    run(FactoredSolve{a.W + b * k * n, a.V ? a.V + b * k * n : nullptr,
                      n, m, k, a.refine_steps});
  } else {
    run(DenseSolve{a.op + b * n * n, n, a.triangular != 0});
  }

  for (int j = threadIdx.x; j < n; j += kThreads) {
    a.x_out[b * n + j] = s.x[j];
    a.w_out[b * n + j] = s.w[j];
    a.mu_out[b * n + j] = s.mu[j];
    a.dx_out[b * n + j] = s.x[j] - s.xprev[j];
    a.dmu_out[b * n + j] = s.mu[j] - s.muprev[j];
  }
  for (int r = threadIdx.x; r < m; r += kThreads) {
    a.z_out[b * m + r] = s.z[r];
    a.y_out[b * m + r] = s.y[r];
    a.dy_out[b * m + r] = s.y[r] - s.yprev[r];
  }
}

template <bool kFactored>
int launch(const Inputs& a, int batch, cudaStream_t stream) {
  const size_t bytes = smem_floats(kFactored, a.n, a.m, a.k) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      segment_kernel<kFactored>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0)
    segment_kernel<kFactored><<<batch, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int porqua_admm_segment_smem_bytes(int factored, int n, int m, int k) {
  return (int)(smem_floats(factored != 0, n, m, k) * sizeof(float));
}

int porqua_max_smem_optin(void) {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return bytes;
}

const char* porqua_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int porqua_admm_segment_dense(
    const float* op, const float* C, const float* q, const float* l,
    const float* u, const float* lb, const float* ub, const float* rho,
    const float* rho_b, const float* l1w, const float* l1c, const float* x,
    const float* z, const float* w, const float* y, const float* mu,
    float* x_out, float* z_out, float* w_out, float* y_out, float* mu_out,
    float* dx_out, float* dy_out, float* dmu_out, int batch, int n, int m,
    int n_iters, float sigma, float alpha, float one_m_alpha, int triangular,
    void* stream) {
  Inputs a{};
  a.op = op;
  a.C = C; a.q = q; a.l = l; a.u = u; a.lb = lb; a.ub = ub;
  a.rho = rho; a.rho_b = rho_b; a.l1w = l1w; a.l1c = l1c;
  a.x = x; a.z = z; a.w = w; a.y = y; a.mu = mu;
  a.x_out = x_out; a.z_out = z_out; a.w_out = w_out; a.y_out = y_out;
  a.mu_out = mu_out; a.dx_out = dx_out; a.dy_out = dy_out; a.dmu_out = dmu_out;
  a.n = n; a.m = m; a.k = 0; a.n_iters = n_iters; a.refine_steps = 0;
  a.triangular = triangular;
  a.sigma = sigma; a.alpha = alpha; a.one_m_alpha = one_m_alpha;
  return launch<false>(a, batch, (cudaStream_t)stream);
}

int porqua_admm_segment_factored(
    const float* W, const float* inv_d, const float* Y0, const float* Ginv,
    const float* V, const float* Dv, const float* C, const float* q,
    const float* l, const float* u, const float* lb, const float* ub,
    const float* rho, const float* rho_b, const float* l1w, const float* l1c,
    const float* x, const float* z, const float* w, const float* y,
    const float* mu, float* x_out, float* z_out, float* w_out, float* y_out,
    float* mu_out, float* dx_out, float* dy_out, float* dmu_out, int batch,
    int n, int m, int k, int n_iters, float sigma, float alpha,
    float one_m_alpha, int refine_steps, void* stream) {
  Inputs a{};
  a.W = W; a.inv_d = inv_d; a.Y0 = Y0; a.Ginv = Ginv; a.V = V; a.Dv = Dv;
  a.C = C; a.q = q; a.l = l; a.u = u; a.lb = lb; a.ub = ub;
  a.rho = rho; a.rho_b = rho_b; a.l1w = l1w; a.l1c = l1c;
  a.x = x; a.z = z; a.w = w; a.y = y; a.mu = mu;
  a.x_out = x_out; a.z_out = z_out; a.w_out = w_out; a.y_out = y_out;
  a.mu_out = mu_out; a.dx_out = dx_out; a.dy_out = dy_out; a.dmu_out = dmu_out;
  a.n = n; a.m = m; a.k = k; a.n_iters = n_iters;
  a.refine_steps = refine_steps; a.triangular = 0;
  a.sigma = sigma; a.alpha = alpha; a.one_m_alpha = one_m_alpha;
  return launch<true>(a, batch, (cudaStream_t)stream);
}

}  // extern "C"
