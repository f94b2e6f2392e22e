// Fused factored (Woodbury) ADMM segment for Hopper (sm_90a), float32:
// one problem per cluster of 8 thread blocks.
//
// Replaces porqua_tpu/ops/admm_kernel.py:340 (admm_segment_factored ->
// _factored_segment_kernel). Each launch runs n_iters OSQP iterations
// with the operator base(r) = inv_d r - (W r) W, refine_steps rounds of
// refinement against K = diag(Dv) + V'V, and the row Schur step
// xt = x0 - Y0 Ginv C x0; it writes (x, z, w, y, mu, dx, dy, dmu).
//
// What bound the streaming form (admm_segment.cu, segment_kernel<true>):
// one block per problem cannot hold W (k x n f32, 0.5 MB at k = 252,
// n = 500), so it read W from device memory twice per iteration and V
// twice more per refinement round: 8.9 GB per launch at refine 0 on the
// 252 x 500 batch, at 71-76% of the HBM peak and about 50x over the
// bound that reads the operator once. It was bound by device-memory
// bytes.
//
// This design reads the operator from device memory once per launch.
// The columns are partitioned across the 8 blocks of a cluster: rank r
// owns columns [r nc, min(n, (r+1) nc)), nc = ceil(n / 8), and keeps
// W[:, cols] (and V[:, cols] when refining), C[:, cols], Y0[cols, :] and
// its slice of every n-vector in shared memory for the whole segment
// (75 KB at refine 0 and 139 KB at refine 1 for n = 500, k = 252,
// m = 1; three blocks share an SM at refine 0, one at refine 1). Ginv,
// the m-vectors and the bounds are replicated: every block makes the
// m-vector updates itself, in the same order. An iteration is
// column-local except for three reductions, each summed over the 8
// blocks in rank order so that every block holds bitwise the same sum:
// - W r (and V x0 when refining), k long: each block writes its partial
//   to its own buffer, one cluster.sync(), then every block reads the 8
//   partials through distributed shared memory. The buffers alternate
//   between two, so one sync per reduction is enough: a block that
//   writes buffer p for reduction i + 2 has passed the sync of reduction
//   i + 1, which no block reaches before it has read reduction i.
// - C x0 and C xt, m long: each block stores its partial into every
//   block's receive slots with st.async, counted in bytes on that
//   block's mbarrier, and waits on its own mbarrier; no cluster barrier.
// Device-memory traffic is then one read of the inputs. What is left is
// shared-memory traffic, the latency of the chain of matvecs and
// reductions, and how many clusters are resident at once.
//
// Matvecs are f32 FMA on the CUDA cores (no tensor cores, hence no
// TF32): a matrix-vector product per problem gives them nothing to do.
// The slices are stored with a row stride ld, the slice width rounded
// up to a multiple of 4 and zero past the block's columns, so both
// products read whole rows as float4. W r is a thread per row; the
// float4 columns of each row are stored XOR-permuted by the row index,
// so the rows of one access phase fall in different banks while the
// vector's float4 is a broadcast. W' t gives each lane a float4 of
// columns, splits the k-sum across the rows of a warp and across the
// warps, and adds those partials by shuffles and through shared memory.
// The operator is copied in with cp.async, many loads in flight. The
// DSMEM, mbarrier, st.async and cp.async primitives, the m-long
// reduction and the elementwise updates are shared with the other
// kernels (cluster_common.cuh).
//
// The device-memory form (cluster_kernel<true>,
// porqua_admm_segment_factored_global) is the same cluster of 8 blocks
// and the same reductions, for the shapes where a block's slices do not
// fit its shared memory (the 5,000-asset sketch shape: 256 x 625 floats
// of W per block, 640 KB): W and V, C, Y0 and Ginv stay in device
// memory and each block reads its columns of them on every iteration.
// Shared memory holds only the block's slices of the n-vectors, the
// W't partials, the replicated m-vectors and the receive slots, about
// 4 (25 n / 8 + 28 m + 3 k) bytes (77 KB at n = 5,888, k = 252, m = 1).
// At these sizes one problem's operator (W is 5.1 MB at 256 x 5,000)
// stays in the 50 MB L2 across the segment, so device memory sees it
// about once and L2 once per use. W r is a warp per row of the block's
// columns, W't splits the rows across the warps with a lane per column
// (coalesced, like the cluster form's products, summed in warp order);
// the Schur step's C x0, its Ginv product and the Y0 correction are f64
// as in the streaming form (admm_segment.cu, FactoredSolve): at these
// widths the rounding of an f32 C x0 comes back amplified in the row's
// dual. C x0 is summed over the cluster in f64 through the same
// alternating DSMEM buffers as W r.
//
// The shared-memory sizes have one definition each, smem_floats<false>
// and smem_floats<true>, which the launchers use and the Python wrapper
// asks for (porqua_admm_cluster_smem_bytes,
// porqua_admm_cluster_global_smem_bytes) before it chooses a form.
// Plain C interface for ctypes: every launcher returns
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

#include "cluster_common.cuh"

namespace cg = cooperative_groups;

// The block's dynamic shared memory; every array below is an offset
// into it.
extern __shared__ __align__(16) float smem[];

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Inputs {
  // per-problem arrays (batch-strided), row-major
  const float* W;      // (k, n)
  const float* inv_d;  // (n)
  const float* Y0;     // (n, m)
  const float* Ginv;   // (m, m)
  const float* V;      // (k, n), read only when refine_steps > 0
  const float* Dv;     // (n), read only when refine_steps > 0
  const float* C;      // (m, n)
  const float *q, *l, *u, *lb, *ub, *rho, *rho_b, *l1w, *l1c;
  const float *x, *z, *w, *y, *mu;
  float *x_out, *z_out, *w_out, *y_out, *mu_out, *dx_out, *dy_out, *dmu_out;
  int n, m, k, n_iters, refine_steps;
  float sigma, alpha, one_m_alpha;
};

// Columns per rank, and the row stride of every column-slice array.
__host__ __device__ inline int slice_cols(int n) {
  return (n + kCluster - 1) / kCluster;
}
__host__ __device__ inline int slice_ld(int n) {
  return (slice_cols(n) + 3) & ~3;
}

// The float4 columns of row i of a W or V slice are stored permuted,
// float4 q at q ^ (i & swizzle), swizzle = the largest power of two up
// to 8 that divides ld / 4, less one: the 8 threads of a 128-bit access
// phase, one row each, then read 8 different bank groups while all of
// them read the same float4 of the vector.
__host__ __device__ inline int slice_swizzle(int ld) {
  const int q4 = ld >> 2, p = q4 & -q4;
  return (p < 8 ? p : 8) - 1;
}

// Lanes that share one row of a slice (a float4 each): 8, 16 or 32.
__device__ __forceinline__ int lanes_per_row(int ld) {
  const int q = ld >> 2;
  return q > 16 ? 32 : (q > 8 ? 16 : 8);
}

// Shared-memory layout of one block, in floats. Every float4-read
// array comes first and has a length that is a multiple of 4. Arrays
// are addressed as offsets from the one shared array, so that every
// access is a shared-memory access and no table of pointers is kept.
enum SliceVec {  // n-vectors, this block's columns
  kX, kW, kMu, kQ, kLb, kUb, kRhoB, kL1w, kL1c, kInvD, kDv, kRhs, kX0, kXt,
  kR, kXPrev, kMuPrev, kVecSlice
};
enum MVec { kZ, kY, kL, kU, kRho, kZt, kYPrev, kS, kVecM };  // m-vectors

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// The device-memory form's partial buffers: two of max(k, 2 m) floats,
// for the k-long f32 reductions and the m-long f64 one.
__host__ __device__ inline int global_ring(int k, int m) {
  return round4(k > 2 * m ? k : 2 * m);
}

// kDev: the device-memory form's layout (no W, V, C, Y0 or Ginv; f64
// C x0 and its Ginv product at the end), else the cluster form's.
template <bool kDev>
struct Layout {
  int ld, swz, k, m;  // slice row stride and swizzle, W's rows, m
  int rlen;           // floats per partial buffer
  int vec, c, y0, parts, bars, t, ring, recv, mvec, ginv, sd;  // offsets

  __device__ Layout(int n, int m_, int k_, int refine) : k(k_), m(m_) {
    ld = slice_ld(n);
    swz = slice_swizzle(ld);
    if constexpr (kDev) {
      vec = 0;
      c = y0 = ginv = -1;
      parts = vec + kVecSlice * ld;
      bars = parts + kWarps * ld;
      t = bars + 4;
      rlen = global_ring(k, m);
      ring = t + round4(k);
      recv = ring + 2 * rlen;
      mvec = recv + 2 * kCluster * m;
      sd = mvec + kVecM * m;
      sd += sd & 1;  // doubles, 8-byte aligned
    } else {
      vec = k * ld * (refine > 0 ? 2 : 1);  // W, then V
      c = vec + kVecSlice * ld;
      y0 = c + m * ld;
      parts = y0 + m * ld;
      bars = parts + kWarps * ld;  // two mbarriers, 16-byte aligned
      t = bars + 4;
      rlen = k;
      ring = t + k;
      recv = ring + 2 * k;
      mvec = recv + 2 * kCluster * m;
      ginv = mvec + kVecM * m;
      sd = -1;
    }
  }
  __device__ float* W() const { return smem; }
  __device__ float* V() const { return smem + k * ld; }
  __device__ float* v(int i) const { return smem + vec + i * ld; }
  __device__ float* mv(int i) const { return smem + mvec + i * m; }
  __device__ float* C() const { return smem + c; }
  __device__ float* Y0() const { return smem + y0; }
  __device__ float* Parts() const { return smem + parts; }
  __device__ float* Bar(int i) const { return smem + bars + 2 * i; }
  __device__ float* T() const { return smem + t; }
  __device__ float* Ring(int i) const { return smem + ring + i * rlen; }
  __device__ float* Recv(int i) const { return smem + recv + i * kCluster * m; }
  __device__ float* Ginv() const { return smem + ginv; }
  // kDev: C x0, then vv = (C x0) Ginv, m doubles each.
  __device__ double* Sd() const {
    return reinterpret_cast<double*>(smem + sd);
  }
};

template <bool kDev>
__host__ __device__ inline size_t smem_floats(int n, int m, int k,
                                              int refine) {
  const size_t ld = slice_ld(n);
  if constexpr (kDev) {
    size_t f = (size_t)kVecSlice * ld             // slice vectors
               + (size_t)kWarps * ld              // W't partials
               + 4                                // mbarriers
               + round4(k)                        // t
               + 2 * (size_t)global_ring(k, m)    // partial buffers
               + 2 * (size_t)kCluster * m         // m-partials received
               + (size_t)kVecM * m;               // m-vectors
    return f + (f & 1) + 4 * (size_t)m;           // C x0, vv in f64
  }
  return (size_t)k * ld * (refine > 0 ? 2 : 1)  // W (V)
         + (size_t)kVecSlice * ld               // slice vectors
         + 2 * (size_t)m * ld                   // C, Y0
         + (size_t)kWarps * ld                  // W't partials
         + 4                                    // mbarriers
         + 3 * (size_t)k                        // t, partial ring
         + 2 * (size_t)kCluster * m             // m-partials received
         + (size_t)kVecM * m + (size_t)m * m;   // m-vectors, Ginv
}

// Row i, column j of src (i < rows, j < cols) into row i of dst, float4
// column (j / 4) ^ (i & swz): a warp per row, through cp.async.
__device__ __forceinline__ void copy_cols(float* dst, int ld, int swz,
                                          const float* src, int src_ld,
                                          int rows, int cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < rows; i += kWarps) {
    for (int j = lane; j < cols; j += 32) {
      const int at = (((j >> 2) ^ (i & swz)) << 2) | (j & 3);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       shared_addr(dst + (size_t)i * ld + at)),
                   "l"(src + (size_t)i * src_ld + j)
                   : "memory");
    }
  }
}

// out[i] = sum_j M[i ld + j] v[j] for i < rows (M swizzled, M and v
// zero past the block's columns). A thread per row, a float4 at a time.
__device__ __forceinline__ void rows_times(const float* M, int ld, int swz,
                                           int rows, const float* v,
                                           float* out) {
  const int q4 = ld >> 2;
  const float4* v4 = reinterpret_cast<const float4*>(v);
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const float4* row = reinterpret_cast<const float4*>(M + (size_t)i * ld);
    const int s = i & swz;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int q = 0; q < q4; ++q) {
      const float4 a = row[q ^ s], b = v4[q];
      a0 = fmaf(a.x, b.x, a0);
      a1 = fmaf(a.y, b.y, a1);
      a0 = fmaf(a.z, b.z, a0);
      a1 = fmaf(a.w, b.w, a1);
    }
    out[i] = a0 + a1;
  }
}

// Calls f(j, sum_i t[i] M[i ld + j]) for j < cols (M swizzled). A lane
// takes a float4
// of columns; the rows are split across the lane groups of a warp (summed
// by shuffles) and across the warps (summed in warp order through parts).
template <class F>
__device__ __forceinline__ void cols_times(const float* t, const float* M,
                                           int ld, int swz, int rows,
                                           int cols, float* parts, F f) {
  const int q4 = ld >> 2, g = lanes_per_row(ld), per_warp = 32 / g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / g, c = lane % g;
  const int span = (rows + kWarps - 1) / kWarps;
  const int i0 = warp * span, i1 = min(rows, i0 + span);
  for (int q0 = 0; q0 < q4; q0 += g) {
    const int q = q0 + c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q < q4) {
#pragma unroll 4
      for (int i = i0 + sub; i < i1; i += per_warp) {
        const float ti = t[i];
        const float4 a =
            reinterpret_cast<const float4*>(M + (size_t)i * ld)[q ^ (i & swz)];
        acc.x = fmaf(ti, a.x, acc.x);
        acc.y = fmaf(ti, a.y, acc.y);
        acc.z = fmaf(ti, a.z, acc.z);
        acc.w = fmaf(ti, a.w, acc.w);
      }
    }
    for (int o = g; o < 32; o <<= 1) {
      acc.x += __shfl_xor_sync(kFull, acc.x, o);
      acc.y += __shfl_xor_sync(kFull, acc.y, o);
      acc.z += __shfl_xor_sync(kFull, acc.z, o);
      acc.w += __shfl_xor_sync(kFull, acc.w, o);
    }
    if (sub == 0 && q < q4)
      reinterpret_cast<float4*>(parts + (size_t)warp * ld)[q] = acc;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    float acc = parts[j];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) acc += parts[(size_t)w * ld + j];
    f(j, acc);
  }
  __syncthreads();
}

// The device-memory form's products, on this block's columns of a
// matrix in device memory (row stride ldm).
// out[i] = sum_{j < cols} M[i ldm + j] v[j] for i < rows: a warp per
// row, the lanes along the row (coalesced), summed by shuffles.
__device__ __forceinline__ void rows_times_global(const float* M, int ldm,
                                                  int rows, int cols,
                                                  const float* v,
                                                  float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < rows; i += kWarps) {
    const float* row = M + (size_t)i * ldm;
    float acc = 0.f;
#pragma unroll 4
    for (int j = lane; j < cols; j += 32) acc = fmaf(__ldg(row + j), v[j], acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
    if (lane == 0) out[i] = acc;
  }
}

// Calls f(j, sum_i t[i] M[i ldm + j]) for j < cols: the rows split
// across the warps, a lane per column (coalesced), each warp's partial
// into parts (row stride ld), summed in warp order.
template <class F>
__device__ __forceinline__ void cols_times_global(const float* t,
                                                  const float* M, int ldm,
                                                  int rows, int cols,
                                                  float* parts, int ld, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int span = (rows + kWarps - 1) / kWarps;
  const int i0 = warp * span, i1 = min(rows, i0 + span);
  for (int j = lane; j < cols; j += 32) {
    float acc = 0.f;
#pragma unroll 4
    for (int i = i0; i < i1; ++i)
      acc = fmaf(t[i], __ldg(M + (size_t)i * ldm + j), acc);
    parts[(size_t)warp * ld + j] = acc;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    float acc = parts[j];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) acc += parts[(size_t)w * ld + j];
    f(j, acc);
  }
  __syncthreads();
}

// out[r] = sum_{j < cols} C[r ldm + j] v[j] for r < rows, in f64: a
// warp per row.
__device__ __forceinline__ void rows_dot_f64(const float* C, int ldm,
                                             int rows, int cols,
                                             const float* v, double* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const float* row = C + (size_t)r * ldm;
    double acc = 0.0;
    for (int j = lane; j < cols; j += 32) acc += (double)__ldg(row + j) * v[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
    if (lane == 0) out[r] = acc;
  }
}

// One block's view of its problem: its columns and its shared memory.
// kDev: the device-memory form, whose operator, C, Y0 and Ginv are read
// from device memory through the pointers below.
template <bool kDev>
struct Block {
  cg::cluster_group cluster;
  Layout<kDev> L;
  int cols;      // this rank's column count (maybe 0)
  int flip;      // which partial buffer the next k-reduction uses
  int mflip;     // which receive buffer the next m-reduction uses
  unsigned mphase;  // bit p: the phase parity mbarrier p waits for
  // kDev: this block's columns of W, V, C (row stride n) and rows of
  // Y0, and Ginv, in device memory.
  const float *W, *V, *C, *Y0, *Ginv;
  int n;

  // out[0:len] = the sum over the cluster's blocks, in rank order, of
  // what partial(buffer) wrote to each block's buffer. Every block of
  // the cluster calls it at the same point.
  template <class T, class Partial>
  __device__ __forceinline__ void reduce(int len, T* out, Partial partial) {
    T* buf = reinterpret_cast<T*>(L.Ring(flip));
    flip ^= 1;
    partial(buf);
    cluster.sync();
    const T* src[kCluster];
#pragma unroll
    for (int q = 0; q < kCluster; ++q) src[q] = cluster.map_shared_rank(buf, q);
    for (int i = threadIdx.x; i < len; i += kThreads) {
      T v[kCluster];
#pragma unroll
      for (int q = 0; q < kCluster; ++q) v[q] = src[q][i];
      T acc = v[0];
#pragma unroll
      for (int q = 1; q < kCluster; ++q) acc += v[q];
      out[i] = acc;
    }
    __syncthreads();
  }

  // out = C v (m long), summed over the cluster (reduce_rows).
  __device__ __forceinline__ void reduce_rows(const float* v, float* out) {
    const int p = mflip;
    mflip ^= 1;
    if constexpr (kDev) {
      ::reduce_rows<kCluster, kThreads>(
          C, n, L.m, cols, v, L.Recv(p), shared_addr(L.Bar(p)),
          (mphase >> p) & 1u, (int)cluster.block_rank(), out);
    } else {
      ::reduce_rows<kCluster, kThreads>(
          L.C(), L.ld, L.m, cols, v, L.Recv(p), shared_addr(L.Bar(p)),
          (mphase >> p) & 1u, (int)cluster.block_rank(), out);
    }
    mphase ^= 1u << p;
  }

  // store(j, t[j]) for t = v M' M restricted to this block's columns,
  // M = W or V (which: 0 or 1): the k-long M v summed over the cluster,
  // then M' of it on this block's columns.
  template <class Store>
  __device__ __forceinline__ void gram(int which, const float* v,
                                       Store store) {
    const Layout<kDev> L = this->L;
    if constexpr (kDev) {
      const float* M = which ? V : W;
      const int n = this->n, cols = this->cols;
      reduce(L.k, L.T(), [=](float* buf) {
        rows_times_global(M, n, L.k, cols, v, buf);
      });
      cols_times_global(L.T(), M, n, L.k, cols, L.Parts(), L.ld, store);
    } else {
      const float* M = which ? L.V() : L.W();
      reduce(L.k, L.T(), [=](float* buf) {
        rows_times(M, L.ld, L.swz, L.k, v, buf);
      });
      cols_times(L.T(), M, L.ld, L.swz, L.k, cols, L.Parts(), store);
    }
  }

  // store(j, (r inv_d - (W r) W)[j]) on this block's columns.
  template <class Store>
  __device__ __forceinline__ void base(const float* r, Store store) {
    const float* inv_d = L.v(kInvD);
    gram(0, r, [=](int j, float wt) { store(j, r[j] * inv_d[j] - wt); });
  }

  // xt = x0 - Y0 (Ginv (C x0)), x0 = base(rhs) refined refine_steps times.
  __device__ __forceinline__ void solve(int refine_steps) {
    const Layout<kDev> L = this->L;
    const int m = L.m;
    float *rhs = L.v(kRhs), *x0 = L.v(kX0), *r = L.v(kR);
    base(rhs, [=](int j, float v) { x0[j] = v; });
    for (int it = 0; it < refine_steps; ++it) {
      const float* Dv = L.v(kDv);
      gram(1, x0, [=](int j, float vt) {
        r[j] = rhs[j] - (Dv[j] * x0[j] + vt);
      });
      base(r, [=](int j, float v) { x0[j] += v; });
    }
    float* xt = L.v(kXt);
    if constexpr (kDev) {
      // In f64, as the streaming form: sd = C x0 summed over the
      // cluster, vv = sd Ginv, xt = x0 - Y0 vv.
      double *sd = L.Sd(), *vv = sd + m;
      const float *C = this->C, *Y0 = this->Y0, *Ginv = this->Ginv;
      const int n = this->n, cols = this->cols;
      reduce(m, sd, [=](double* buf) {
        rows_dot_f64(C, n, m, cols, x0, buf);
      });
      for (int c = threadIdx.x; c < m; c += kThreads) {
        double acc = 0.0;
        for (int q = 0; q < m; ++q)
          acc += sd[q] * (double)__ldg(Ginv + (size_t)q * m + c);
        vv[c] = acc;
      }
      __syncthreads();
      for (int j = threadIdx.x; j < cols; j += kThreads) {
        const float* y0 = Y0 + (size_t)j * m;
        double acc = 0.0;
        for (int c = 0; c < m; ++c) acc += (double)__ldg(y0 + c) * vv[c];
        xt[j] = (float)(x0[j] - acc);
      }
    } else {
      float* s = L.mv(kS);
      reduce_rows(x0, s);
      // xt = x0 - Y0 vv, vv = s Ginv: each thread forms vv itself.
      const float *Y0 = L.Y0(), *Ginv = L.Ginv();
      for (int j = threadIdx.x; j < cols; j += kThreads) {
        float acc = 0.f;
        for (int c = 0; c < m; ++c) {
          float vv = 0.f;
          for (int q = 0; q < m; ++q) vv = fmaf(s[q], Ginv[q * m + c], vv);
          acc = fmaf(Y0[j * m + c], vv, acc);
        }
        xt[j] = x0[j] - acc;
      }
    }
    __syncthreads();
  }

  // One OSQP iteration (the counterpart of _make_iteration).
  __device__ __forceinline__ void iteration(const Inputs& a) {
    const Layout<kDev> L = this->L;
    const int m = L.m, ld = L.ld;
    const float al = a.alpha, one_m_al = a.one_m_alpha, sig = a.sigma;
    float *z = L.mv(kZ), *y = L.mv(kY), *zt = L.mv(kZt);
    const float *l = L.mv(kL), *u = L.mv(kU), *rho = L.mv(kRho);
    float *x = L.v(kX), *w = L.v(kW), *mu = L.v(kMu), *rhs = L.v(kRhs);
    const float *q = L.v(kQ), *lb = L.v(kLb), *ub = L.v(kUb);
    const float *rho_b = L.v(kRhoB), *l1w = L.v(kL1w), *l1c = L.v(kL1c);
    // rhs = sigma x - q + C'(rho z - y) + (rho_b w - mu)
    if constexpr (kDev) {
      const float* C = this->C;
      const int n = this->n;
      for (int j = threadIdx.x; j < cols; j += kThreads) {
        float ct = 0.f;
        for (int r = 0; r < m; ++r)
          ct = fmaf(rho[r] * z[r] - y[r], __ldg(C + (size_t)r * n + j), ct);
        rhs[j] = (sig * x[j] - q[j]) + ct + (rho_b[j] * w[j] - mu[j]);
      }
    } else {
      const float* C = L.C();
      for (int j = threadIdx.x; j < cols; j += kThreads) {
        float ct = 0.f;
        for (int r = 0; r < m; ++r)
          ct = fmaf(rho[r] * z[r] - y[r], C[r * ld + j], ct);
        rhs[j] = (sig * x[j] - q[j]) + ct + (rho_b[j] * w[j] - mu[j]);
      }
    }
    __syncthreads();
    solve(a.refine_steps);
    const float* xt = L.v(kXt);
    reduce_rows(xt, zt);
    for (int j = threadIdx.x; j < cols; j += kThreads)
      col_update(xt[j], al, one_m_al, rho_b[j], lb[j], ub[j], l1w[j], l1c[j],
                 x[j], w[j], mu[j]);
    for (int r = threadIdx.x; r < m; r += kThreads)
      row_update(zt[r], al, one_m_al, rho[r], l[r], u[r], z[r], y[r]);
    __syncthreads();
  }
};

template <bool kDev>
__global__ void __launch_bounds__(kThreads, 3) cluster_kernel(Inputs a) {
  const int n = a.n, m = a.m, k = a.k, refine = a.refine_steps;
  Block<kDev> blk{cg::this_cluster(), Layout<kDev>(n, m, k, refine), 0, 0, 0,
                  0u};
  const Layout<kDev> L = blk.L;
  const int ld = L.ld;
  const size_t b = blockIdx.x / kCluster;
  const int nc = slice_cols(n);
  const int c0 = min(n, (int)blk.cluster.block_rank() * nc);
  const int cols = min(n, c0 + nc) - c0;
  blk.cols = cols;
  if constexpr (kDev) {
    blk.n = n;
    blk.W = a.W + b * k * n + c0;
    blk.V = a.V + b * k * n + c0;
    blk.C = a.C + b * m * n + c0;
    blk.Y0 = a.Y0 + (b * n + c0) * m;
    blk.Ginv = a.Ginv + b * m * m;
  }

  // Zero first: the float4 products read the slices past their last
  // column, and those entries must be 0.
  const int total = (int)smem_floats<kDev>(n, m, k, refine);
  for (int i = threadIdx.x; i < total; i += kThreads) smem[i] = 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int p = 0; p < 2; ++p) init_barrier(shared_addr(L.Bar(p)));
    fence_barrier_init();
  }
  if (refine > 0) copy(L.v(kDv), a.Dv + b * n + c0, cols);
  if constexpr (!kDev) {
    // The operator slices, read from device memory once per launch.
    copy_cols(L.W(), ld, L.swz, a.W + b * k * n + c0, n, k, cols);
    if (refine > 0)
      copy_cols(L.V(), ld, L.swz, a.V + b * k * n + c0, n, k, cols);
    copy_cols(L.C(), ld, 0, a.C + b * m * n + c0, n, m, cols);
    copy(L.Y0(), a.Y0 + (b * n + c0) * m, cols * m);
    copy(L.Ginv(), a.Ginv + b * m * m, m * m);
  }
  copy(L.v(kInvD), a.inv_d + b * n + c0, cols);
  copy(L.v(kX), a.x + b * n + c0, cols);
  copy(L.v(kW), a.w + b * n + c0, cols);
  copy(L.v(kMu), a.mu + b * n + c0, cols);
  copy(L.v(kQ), a.q + b * n + c0, cols);
  copy(L.v(kLb), a.lb + b * n + c0, cols);
  copy(L.v(kUb), a.ub + b * n + c0, cols);
  copy(L.v(kRhoB), a.rho_b + b * n + c0, cols);
  copy(L.v(kL1w), a.l1w + b * n + c0, cols);
  copy(L.v(kL1c), a.l1c + b * n + c0, cols);
  copy(L.mv(kZ), a.z + b * m, m);
  copy(L.mv(kY), a.y + b * m, m);
  copy(L.mv(kL), a.l + b * m, m);
  copy(L.mv(kU), a.u + b * m, m);
  copy(L.mv(kRho), a.rho + b * m, m);
  wait_copies();
  // Every block's mbarriers are initialised before any block stores
  // into another.
  blk.cluster.sync();

  float *x = L.v(kX), *mu = L.v(kMu), *y = L.mv(kY);
  float *xprev = L.v(kXPrev), *muprev = L.v(kMuPrev), *yprev = L.mv(kYPrev);
  for (int it = 0; it < a.n_iters; ++it) {
    if (it == a.n_iters - 1) {
      // Increments are between the last two iterates.
      for (int j = threadIdx.x; j < cols; j += kThreads) {
        xprev[j] = x[j];
        muprev[j] = mu[j];
      }
      for (int r = threadIdx.x; r < m; r += kThreads) yprev[r] = y[r];
      __syncthreads();
    }
    blk.iteration(a);
  }

  const float* w = L.v(kW);
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    const size_t o = b * n + c0 + j;
    a.x_out[o] = x[j];
    a.w_out[o] = w[j];
    a.mu_out[o] = mu[j];
    a.dx_out[o] = x[j] - xprev[j];
    a.dmu_out[o] = mu[j] - muprev[j];
  }
  if (blk.cluster.block_rank() == 0) {
    const float* z = L.mv(kZ);
    for (int r = threadIdx.x; r < m; r += kThreads) {
      a.z_out[b * m + r] = z[r];
      a.y_out[b * m + r] = y[r];
      a.dy_out[b * m + r] = y[r] - yprev[r];
    }
  }
  // No block may exit while another can still read its shared memory.
  blk.cluster.sync();
}

// The launch configuration; attr must outlive cfg.
cudaLaunchConfig_t config(int batch, size_t bytes, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * batch, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kDev>
size_t smem_bytes(int n, int m, int k, int refine) {
  return smem_floats<kDev>(n, m, k, refine) * sizeof(float);
}

template <bool kDev>
cudaError_t set_smem(size_t bytes) {
  return cudaFuncSetAttribute(cluster_kernel<kDev>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <bool kDev>
int clamped_smem_bytes(int n, int m, int k, int refine_steps) {
  const size_t bytes = smem_bytes<kDev>(n, m, k, refine_steps);
  return bytes > (size_t)INT_MAX ? INT_MAX : (int)bytes;
}

// How many 8-block clusters of this shape the card can hold at once;
// a negative value is a CUDA error code, negated.
template <bool kDev>
int max_active(int n, int m, int k, int refine_steps) {
  const size_t bytes = smem_bytes<kDev>(n, m, k, refine_steps);
  cudaError_t err = set_smem<kDev>(bytes);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(1, bytes, 0, &attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(
      &count, (const void*)cluster_kernel<kDev>, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return count;
}

template <bool kDev>
int launch_segment(
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
  a.refine_steps = refine_steps;
  a.sigma = sigma; a.alpha = alpha; a.one_m_alpha = one_m_alpha;
  const size_t bytes = smem_bytes<kDev>(n, m, k, refine_steps);
  cudaError_t err = set_smem<kDev>(bytes);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        config(batch, bytes, (cudaStream_t)stream, &attr);
    err = cudaLaunchKernelEx(&cfg, cluster_kernel<kDev>, a);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int porqua_admm_cluster_smem_bytes(int n, int m, int k, int refine_steps) {
  return clamped_smem_bytes<false>(n, m, k, refine_steps);
}

int porqua_admm_cluster_global_smem_bytes(int n, int m, int k,
                                          int refine_steps) {
  return clamped_smem_bytes<true>(n, m, k, refine_steps);
}

int porqua_admm_cluster_max_active(int n, int m, int k, int refine_steps) {
  return max_active<false>(n, m, k, refine_steps);
}

int porqua_admm_cluster_global_max_active(int n, int m, int k,
                                          int refine_steps) {
  return max_active<true>(n, m, k, refine_steps);
}

#define PORQUA_FACTORED_ARGS                                                 \
  const float *W, const float *inv_d, const float *Y0, const float *Ginv,    \
      const float *V, const float *Dv, const float *C, const float *q,       \
      const float *l, const float *u, const float *lb, const float *ub,      \
      const float *rho, const float *rho_b, const float *l1w,                \
      const float *l1c, const float *x, const float *z, const float *w,      \
      const float *y, const float *mu, float *x_out, float *z_out,           \
      float *w_out, float *y_out, float *mu_out, float *dx_out,              \
      float *dy_out, float *dmu_out, int batch, int n, int m, int k,         \
      int n_iters, float sigma, float alpha, float one_m_alpha,              \
      int refine_steps, void *stream
#define PORQUA_FACTORED_CALL                                                 \
  W, inv_d, Y0, Ginv, V, Dv, C, q, l, u, lb, ub, rho, rho_b, l1w, l1c, x, z, \
      w, y, mu, x_out, z_out, w_out, y_out, mu_out, dx_out, dy_out, dmu_out, \
      batch, n, m, k, n_iters, sigma, alpha, one_m_alpha, refine_steps, stream

int porqua_admm_segment_factored_cluster(PORQUA_FACTORED_ARGS) {
  return launch_segment<false>(PORQUA_FACTORED_CALL);
}

// The device-memory form: the same arguments.
int porqua_admm_segment_factored_global(PORQUA_FACTORED_ARGS) {
  return launch_segment<true>(PORQUA_FACTORED_CALL);
}

}  // extern "C"
