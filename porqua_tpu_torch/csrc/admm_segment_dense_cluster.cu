// Fused dense ADMM segment for Hopper (sm_90a), float32: one problem
// per thread-block cluster, with the problem's operator split by
// columns across the blocks' shared memory, whole or with a tail
// streamed from device memory.
//
// Replaces porqua_tpu/ops/admm_kernel.py:146 (_segment_kernel, reached
// through admm_segment, :251, and its pallas_call, :317). Each launch
// runs n_iters OSQP iterations with
//   xt = L^-T (L^-1 rhs)   (triangular: the operator holds L^-1), or
//   xt = rhs @ K^-1        (otherwise: the refined explicit inverse, used
//                           as given, not as a symmetric matrix)
// and writes (x, z, w, y, mu, dx, dy, dmu). The iteration is the one of
// admm_segment.cu's one_iteration, step for step.
//
// What bound the streaming form (admm_segment.cu, segment_kernel<false>):
// one block per problem cannot hold the operator (packed L^-1 is 0.5 MB
// and K^-1 1 MB at n = 500), so it read L^-1's lower half twice per
// iteration, or K^-1 once: 6.3 GB per launch for 252 problems and 25
// iterations against the 0.13 / 0.25 GB that one read needs. On an H100
// (700 W) that took 3.63 ms (L^-1, 1.7 TB/s: its column pass over a
// triangle is strided and ragged) and 2.56 ms (K^-1, 2.5 TB/s, bound by
// device-memory bytes).
//
// This design reads the operator from device memory once per launch.
// - Triangular, 8-block cluster where a rank's slice fits, else a
//   16-block (non-portable) one (tri_ranks, the one choice; 1,024 x 128
//   needs 16): rank r owns the columns j = r (mod R), so the
//   triangle's work is balanced across ranks at any R, and keeps their
//   lower parts L^-1[j:, j] packed column-major in shared memory (63.5
//   KB at n = 500, 8 ranks). An iteration forms the rank's part of
//   t = L^-1 rhs (a thread per pair of rows i and n-1-i, the vector a
//   broadcast), all-reduces it over the cluster with st.async pushes
//   on mbarriers and no cluster barrier (a reduce-scatter to the rows'
//   owners, sums in rank order, an all-gather, so every block holds
//   bitwise the same t), then xt[j] = sum_{i >= j} L^-1[i, j] t[i]
//   for its own columns (a warp walks a group of consecutive columns and
//   its mirror group over contiguous memory).
// - Explicit inverse, 16-block (non-portable) cluster: rank r owns
//   ceil(n / 16) consecutive columns and keeps K^-1[:, cols] (64 KB at
//   n = 500). An iteration pushes the rank's slice of rhs into every
//   rank's receive array with st.async, counted in bytes on the
//   receiver's mbarrier (double-buffered; no cluster barrier), then
//   forms its columns of rhs @ K^-1 from shared memory.
// - Explicit inverse with a streamed tail, where a 16th of K^-1 does
//   not fit a block (1,024 x 128: 256 KB of 227): the first `rows`
//   rows of the slice stay in shared memory, read once, and the others
//   are read again on every iteration, from L2 (the batch's tails fit
//   it), through a ring of kStages cp.async copies per thread. A
//   thread copies exactly the float4s it multiplies, so the ring needs
//   no barrier, only cp.async.wait_group; the stream runs on across
//   iterations (the operator does not change), so the copies of an
//   iteration's first row-steps are in flight during the exchanges and
//   the resident rows' FMAs before them. tail_rows sizes `rows` from
//   the card's opt-in shared memory, the one definition. (L^-1 has no
//   tail form: its packed columns cannot be read coalesced from the
//   row-major operator, and no shape the JAX package's plan sends to
//   its kernel needs one: the L^-1 shapes no cluster holds are those
//   whose C slice and receive buffers alone fill a block.)
// - All: C xt (m long) is reduced by st.async pushes on mbarriers, as
//   in the factored cluster kernel (cluster_common.cuh); the m-vectors
//   are replicated and every block updates them itself in the same
//   order, in f32 as the TPU kernel does; everything else is
//   column-local. Ranks with fewer or no columns (n below the rank
//   count, ragged last ranks) take part in every exchange.
// About 71-75 KB per block at n = 500 and __launch_bounds__(256, 3) let
// three blocks share an SM. What is left is the latency of the chain of
// products and exchanges per iteration and the number of resident
// clusters, not device-memory bytes.
//
// Products are FMA on the CUDA cores (no tensor cores, hence no TF32):
// a matrix-vector product per problem gives wgmma nothing to do.
// K^-1's slice is copied in with cp.async, many loads in flight. Each
// block of the triangular form reads a share of the lower triangle's
// rows, coalesced, and stores every entry into its owner's packed
// column through distributed shared memory.
//
// The shared-memory size has one definition, Layout::total, which the
// launchers use and the Python wrapper asks for
// (porqua_admm_dense_cluster_smem_bytes, porqua_admm_dense_tail_smem_bytes,
// for the rank count and resident rows the launchers take) before it
// chooses a form. Plain C interface for ctypes: every launcher returns
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Blocks per cluster of each form: the triangle takes the wide count
// only where a rank's slice does not fit at the narrow one.
constexpr int kTriRanks = 8;
constexpr int kWideRanks = 16;
constexpr int kInvRanks = 16;
// Row-steps of the streamed tail in flight per thread, a float4 each.
constexpr int kStages = 8;
// Consecutive columns of L^-1 that a warp's lanes walk together.
constexpr int kGroup = 4;
// The set-up moves L^-1's lower triangle in tiles of kTile x kTile,
// staged with a padded row stride of kTile + 1.
constexpr int kTile = 32;
constexpr int kTileFloats = kTile * (kTile + 1);

struct Inputs {
  // per-problem arrays (batch-strided), row-major
  const float* op;  // (n, n): L^-1 (lower triangle read) or K^-1
  const float* C;   // (m, n)
  const float *q, *l, *u, *lb, *ub, *rho, *rho_b, *l1w, *l1c;
  const float *x, *z, *w, *y, *mu;
  float *x_out, *z_out, *w_out, *y_out, *mu_out, *dx_out, *dy_out, *dmu_out;
  int n, m, n_iters;
  int rows;  // rows of the K^-1 slice held in shared memory (tail form)
  float sigma, alpha, one_m_alpha;
};

template <class T>
__host__ __device__ inline T round4(T v) {
  return (v + 3) / 4 * 4;
}

// Shared-memory layout of one block, in floats, with offsets of type T
// (int on the card, size_t for the size the host asks for). The
// operator slice comes first (with a streamed tail: its first `rows`
// rows, then the ring of copies in flight); every array that is read
// as float4 or holds mbarriers starts at a multiple of 4.
enum SliceVec {  // n-vectors, this block's columns
  kX, kW, kMu, kQ, kLb, kUb, kRhoB, kL1w, kL1c, kRhs, kXt, kXPrev, kMuPrev,
  kVecSlice
};
enum MVec { kZ, kY, kL, kU, kRho, kYPrev, kVecM };  // m-vectors

template <bool kTri, int kRanks, bool kTail = false, class T = int>
struct Layout {
  T n, m;
  T rows;   // rows of the K^-1 slice in shared memory (n but in the tail)
  T nc;     // columns of the rank with the most
  T ld;     // nc rounded up to 4: row stride of the column-slice arrays
  T n4;     // n rounded up to 4
  T stages, vec, c, ring, work, bars, recv, zt, mvec, total;  // offsets

  __host__ __device__ Layout(int n_, int m_, int rows_)
      : n(n_), m(m_), rows(kTail ? rows_ : n_) {
    nc = (n + kRanks - 1) / kRanks;
    ld = round4(nc);
    n4 = round4(n);
    // Triangular: rank 0's packed columns j = kRanks c, c < nc, of
    // n - j entries each. Dense: rows rows of ld, then (tail) the ring:
    // kStages float4s per thread.
    stages = kTri ? round4(nc * n - kRanks * nc * (nc - 1) / 2) : rows * ld;
    vec = stages + (kTail ? kStages * kThreads * 4 : 0);
    c = vec + kVecSlice * ld;  // C[:, cols], m rows of ld
    ring = c + m * ld;         // two n-long exchange buffers (rhs or t)
    work = ring + 2 * n4;      // the reduce-scatter slots of t (two
                               // buffers) or the warps' partials of rhs K^-1
    // Six mbarriers. The triangular form stages its set-up tiles in the
    // exchange buffers, which it needs only after the set-up.
    bars = kTri ? ring + (2 * n4 + round4(2 * kRanks * nc) > kTileFloats
                              ? 2 * n4 + round4(2 * kRanks * nc)
                              : (T)kTileFloats)
                : work + kWarps * ld;
    recv = bars + 12;          // m-partials received, two buffers
    zt = recv + 2 * kRanks * m;  // C xt
    mvec = zt + m;
    total = mvec + kVecM * m;
  }
  __device__ float* op() const { return smem; }
  __device__ float4* Stage(int s) const {
    return reinterpret_cast<float4*>(smem + stages) + s * kThreads;
  }
  __device__ float* v(int i) const { return smem + vec + i * ld; }
  __device__ float* C() const { return smem + c; }
  __device__ float* Ring(int p) const { return smem + ring + p * n4; }
  __device__ float* Work() const { return smem + work; }
  __device__ float* Bar(int i) const { return smem + bars + 2 * i; }
  __device__ float* Recv(int p) const { return smem + recv + p * kRanks * m; }
  __device__ float* Zt() const { return smem + zt; }
  __device__ float* mv(int i) const { return smem + mvec + i * m; }
};

// Lanes of a warp that share one row of the K^-1 slice, a float4 each.
__device__ __forceinline__ int lanes_per_row(int q4) {
  int g = 1;
  while (g < q4 && g < 32) g <<= 1;
  return g;
}

// One block's view of its problem: its columns and its shared memory.
// Column c of this rank is j = first + stride * c: interleaved
// (first = rank, stride = kRanks) for the triangle, consecutive
// (stride 1) for K^-1.
template <bool kTri, int kRanks, bool kTail = false>
struct Block {
  cg::cluster_group cluster;
  Layout<kTri, kRanks, kTail> L;
  int rank, first, stride, cols;
  int flip;        // which ring buffer the next n-long exchange uses
  int mflip;       // which receive buffer the next m-reduction uses
  unsigned phase;  // bit i: the phase parity mbarrier i waits for
  // mbarriers: 0-1 C xt; 2-3 the rhs all-gather (K^-1) or the
  // reduce-scatter of t (L^-1); 4-5 the all-gather of t
  // The streamed tail (kTail): this thread's next row-step to copy and
  // the ring slot it goes to, and how many row-steps a pass has.
  int tail_next, tail_slot, tail_steps;

  __device__ Block(int n, int m, int rows)
      : cluster(cg::this_cluster()), L(n, m, rows), flip(0), mflip(0),
        phase(0u), tail_next(0), tail_slot(0), tail_steps(0) {
    rank = (int)cluster.block_rank();
    if (kTri) {
      first = rank;
      stride = kRanks;
      cols = rank < n ? (n - rank + kRanks - 1) / kRanks : 0;
    } else {
      first = min(n, rank * L.nc);
      stride = 1;
      cols = min(n, first + L.nc) - first;
    }
  }

  // Offset of packed column c of this rank's L^-1 slice.
  __device__ __forceinline__ int col_offset(int c) const {
    return c * (L.n - rank) - kRanks * c * (c - 1) / 2;
  }

  // rhs = sigma x - q + C'(rho z - y) + (rho_b w - mu), column c.
  __device__ __forceinline__ float rhs_at(int c, float sig) const {
    const int m = L.m, ld = L.ld;
    const float *z = L.mv(kZ), *y = L.mv(kY), *rho = L.mv(kRho);
    const float* C = L.C();
    float ct = 0.f;
    for (int r = 0; r < m; ++r)
      ct = fmaf(rho[r] * z[r] - y[r], C[r * ld + c], ct);
    return (sig * L.v(kX)[c] - L.v(kQ)[c]) + ct +
           (L.v(kRhoB)[c] * L.v(kW)[c] - L.v(kMu)[c]);
  }

  // out = C v (m long), summed over the cluster (reduce_rows).
  __device__ __forceinline__ void reduce_rows(const float* v, float* out) {
    const int p = mflip;
    mflip ^= 1;
    ::reduce_rows<kRanks, kThreads>(L.C(), L.ld, L.m, cols, v, L.Recv(p),
                                    shared_addr(L.Bar(p)),
                                    (phase >> p) & 1u, rank, out);
    phase ^= 1u << p;
  }

  // Columns of this rank that row i reaches (j <= i).
  __device__ __forceinline__ int cols_to(int i) const {
    return i < rank ? 0 : min(cols, (i - rank) / kRanks + 1);
  }

  // xt = L^-T (L^-1 rhs) on this rank's columns.
  __device__ __forceinline__ void solve_triangular() {
    const int n = L.n, ns = L.nc;  // rows of t per owner: ns = ceil(n / 8)
    const float* Lp = L.op();
    const float* rhs = L.v(kRhs);
    // t = L^-1 rhs is all-reduced in two pushes, with no cluster
    // barrier. Rank q owns rows [q ns, (q + 1) ns) of t. Reduce-scatter:
    // every block stores its part of each row into the row owner's slot
    // for it (st.async, counted on the owner's mbarrier 2 + p); the
    // owner adds the kRanks parts of its rows in rank order. All-gather:
    // it stores the sums into every block's t (mbarrier 4 + p), so every
    // block holds bitwise the same t. Slots and t alternate between two
    // buffers: a block writes buffer p again two iterations later, after
    // it has every block's part of C xt of the iteration in between,
    // which each block sends only after it has read buffer p.
    const int p = flip;
    flip ^= 1;
    float* slots = L.Work() + p * kRanks * ns;  // [source rank][row - q ns]
    float* t = L.Ring(p);
    const unsigned bar_rs = shared_addr(L.Bar(2 + p));
    const unsigned bar_ag = shared_addr(L.Bar(4 + p));
    const int row0 = min(n, rank * ns), mine = min(n, row0 + ns) - row0;
    if (threadIdx.x == 0) {
      expect_bytes(bar_rs, kRanks * mine * 4);
      expect_bytes(bar_ag, n * 4);
    }
    const auto push_part = [&](int i, float v) {
      const int q = i / ns;
      store_remote(remote_addr(shared_addr(slots + rank * ns + (i - q * ns)),
                               q),
                   v, remote_addr(bar_rs, q));
    };
    // This rank's part of t = L^-1 rhs: t[i] over its columns j <= i. A
    // thread takes rows i0 = p and i1 = n - 1 - p, about n / kRanks
    // terms in all, two columns at a time into two accumulators per row;
    // a warp's rows are consecutive addresses of each packed column.
    for (int p = threadIdx.x; p < (n + 1) / 2; p += kThreads) {
      const int i0 = p, i1 = n - 1 - p;
      const int c0 = cols_to(i0), c1 = cols_to(i1);
      float a0 = 0.f, b0 = 0.f, a1 = 0.f, b1 = 0.f;
      int c = 0, j = rank, off = 0;  // off: packed column c's offset
      for (; c + 1 < c0; c += 2) {  // columns both rows reach
        const int j2 = j + kRanks, off2 = off + (n - j);
        const float r0 = rhs[c], r1 = rhs[c + 1];
        a0 = fmaf(Lp[off + (i0 - j)], r0, a0);
        a1 = fmaf(Lp[off + (i1 - j)], r0, a1);
        b0 = fmaf(Lp[off2 + (i0 - j2)], r1, b0);
        b1 = fmaf(Lp[off2 + (i1 - j2)], r1, b1);
        off = off2 + (n - j2);
        j = j2 + kRanks;
      }
      if (c < c0) {
        const float r0 = rhs[c];
        a0 = fmaf(Lp[off + (i0 - j)], r0, a0);
        a1 = fmaf(Lp[off + (i1 - j)], r0, a1);
        off += n - j;
        j += kRanks;
        ++c;
      }
      for (; c + 1 < c1; c += 2) {  // columns only row i1 reaches
        const int j2 = j + kRanks, off2 = off + (n - j);
        b1 = fmaf(Lp[off + (i1 - j)], rhs[c], b1);
        a1 = fmaf(Lp[off2 + (i1 - j2)], rhs[c + 1], a1);
        off = off2 + (n - j2);
        j = j2 + kRanks;
      }
      if (c < c1) b1 = fmaf(Lp[off + (i1 - j)], rhs[c], b1);
      push_part(i1, a1 + b1);
      if (i0 != i1) push_part(i0, a0 + b0);
    }
    wait_phase(bar_rs, (phase >> (2 + p)) & 1u);
    phase ^= 1u << (2 + p);
    // Row r0 + k of t, summed in rank order, into block q's t.
    for (int e = threadIdx.x; e < mine * kRanks; e += kThreads) {
      const int q = e / mine, k = e - q * mine;
      float acc = slots[k];
#pragma unroll
      for (int src = 1; src < kRanks; ++src) acc += slots[src * ns + k];
      store_remote(remote_addr(shared_addr(t + row0 + k), q), acc,
                   remote_addr(bar_ag, q));
    }
    wait_phase(bar_ag, (phase >> (4 + p)) & 1u);
    phase ^= 1u << (4 + p);
    // xt[c] = sum_{i >= j} L^-1[i, j] t[i]. The columns go in groups of
    // kGroup consecutive ones, whose rows nearly coincide; warp w takes
    // group g = w + kWarps s and its mirror ng - 1 - g, a long group and
    // a short one, so that every warp walks about the same rows. Its
    // lanes stride over each group's rows (consecutive addresses of each
    // packed column, t[i] read once for the group), then all 2 kGroup
    // sums are reduced across the warp by interleaved shuffles.
    float* xt = L.v(kXt);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int ng = (cols + kGroup - 1) / kGroup;
    for (int g = warp; g < (ng + 1) / 2; g += kWarps) {
      float acc[2 * kGroup];
      int jk[2 * kGroup];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // The mirror group is the same group in the middle of an odd ng.
        const int grp = h == 0 ? g : (ng - 1 - g == g ? -1 : ng - 1 - g);
        int base[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          const int c = grp * kGroup + k;
          const bool has = grp >= 0 && c < cols;
          acc[h * kGroup + k] = 0.f;
          jk[h * kGroup + k] = has ? rank + kRanks * c : n;  // n: none
          base[k] = has ? col_offset(c) - jk[h * kGroup + k] : 0;
        }
        for (int i = jk[h * kGroup] + lane; i < n; i += 32) {
          const float ti = t[i];
#pragma unroll
          for (int k = 0; k < kGroup; ++k)
            if (i >= jk[h * kGroup + k])
              acc[h * kGroup + k] =
                  fmaf(Lp[base[k] + i], ti, acc[h * kGroup + k]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int k = 0; k < 2 * kGroup; ++k)
          acc[k] += __shfl_xor_sync(kFull, acc[k], o);
      }
#pragma unroll
      for (int k = 0; k < 2 * kGroup; ++k) {
        if (lane == k && jk[k] < n) {
          const int grp = k < kGroup ? g : ng - 1 - g;
          xt[grp * kGroup + k % kGroup] = acc[k];
        }
      }
    }
    __syncthreads();
  }

  // The product's lanes (solve_inverse): a lane takes a float4 of
  // columns, quad cq, of rows r0 + step k.
  struct Lanes {
    int q4, g, per_warp, step, warp, sub, cq, r0;
    __device__ Lanes(int ld) {
      q4 = ld >> 2;
      g = lanes_per_row(q4);
      per_warp = 32 / g;
      step = kWarps * per_warp;
      warp = threadIdx.x >> 5;
      const int lane = threadIdx.x & 31;
      sub = lane / g;
      cq = lane % g;
      r0 = warp * per_warp + sub;
    }
  };

  // Copies this thread's float4 of tail row-step k (rows rows + k step
  // + r0, quad cq of the slice) into ring slot s, as one cp.async
  // group (empty where the thread has no such entry). 16 bytes at once
  // where the source is aligned and the quad holds four columns;
  // otherwise 4 bytes a column, the columns past the slice zero-filled.
  __device__ __forceinline__ void tail_copy(const float* op, const Lanes& ln,
                                            int k, int s) const {
    const int n = L.n, i = L.rows + k * ln.step + ln.r0, c0 = 4 * ln.cq;
    if (i < n && c0 < cols) {
      float* dst = reinterpret_cast<float*>(L.Stage(s) + threadIdx.x);
      const float* src = op + (size_t)i * n + first + c0;
      if ((n & 3) == 0 && (first & 3) == 0 && c0 + 4 <= cols) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         shared_addr(dst)),
                     "l"(src)
                     : "memory");
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = c0 + e < cols;
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                           shared_addr(dst + e)),
                       "l"(in ? src + e : src), "r"(in ? 4 : 0)
                       : "memory");
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // Starts the tail's stream: the first kStages row-steps in flight.
  __device__ __forceinline__ void tail_start(const float* op) {
    const Lanes ln(L.ld);
    tail_steps = (L.n - L.rows + ln.step - 1) / ln.step;
    if (tail_steps == 0) return;
    for (int s = 0; s < kStages; ++s) {
      tail_copy(op, ln, tail_next, s);
      tail_next = tail_next + 1 == tail_steps ? 0 : tail_next + 1;
    }
  }

  // acc += the tail rows' part of rhs @ K^-1 for this lane's quad,
  // row-step by row-step as the copies land; each slot, once read, is
  // refilled with the row-step kStages further on, across the end of
  // the pass into the next iteration's.
  __device__ __forceinline__ void tail_product(const float* op,
                                               const Lanes& ln,
                                               const float* full,
                                               float4& acc) {
    const int n = L.n;
    for (int k = 0; k < tail_steps; ++k) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1)
                   : "memory");
      const int i = L.rows + k * ln.step + ln.r0;
      if (i < n && 4 * ln.cq < cols) {
        const float ri = full[i];
        const float4 v = L.Stage(tail_slot)[threadIdx.x];
        acc.x = fmaf(ri, v.x, acc.x);
        acc.y = fmaf(ri, v.y, acc.y);
        acc.z = fmaf(ri, v.z, acc.z);
        acc.w = fmaf(ri, v.w, acc.w);
      }
      tail_copy(op, ln, tail_next, tail_slot);
      tail_next = tail_next + 1 == tail_steps ? 0 : tail_next + 1;
      tail_slot = tail_slot + 1 == kStages ? 0 : tail_slot + 1;
    }
  }

  // xt = rhs @ K^-1 on this rank's columns; op is the problem's K^-1 in
  // device memory (read only for a streamed tail).
  __device__ __forceinline__ void solve_inverse(float sig, const float* op) {
    const int n = L.n, ld = L.ld;
    const int p = flip;
    flip ^= 1;
    // All-gather of rhs: every block pushes its slice into every block's
    // ring buffer p (itself included), n * 4 bytes on each receiver's
    // mbarrier 2 + p. A buffer is written again two exchanges later,
    // after the writer has every block's part of C xt of the iteration
    // in between, which each block sends only after reading the buffer.
    // With a tail (wide C) each column's rhs is formed once, not once
    // per receiver.
    float* full = L.Ring(p);
    const unsigned bar = shared_addr(L.Bar(2 + p));
    if (threadIdx.x == 0) expect_bytes(bar, n * 4);
    if constexpr (kTail) {
      float* rhs = L.v(kRhs);
      for (int c = threadIdx.x; c < cols; c += kThreads)
        rhs[c] = rhs_at(c, sig);
      __syncthreads();
      for (int idx = threadIdx.x; idx < cols * kRanks; idx += kThreads) {
        const int q = idx / cols, c = idx - q * cols;
        store_remote(remote_addr(shared_addr(full + first + c), q), rhs[c],
                     remote_addr(bar, q));
      }
    } else {
      for (int idx = threadIdx.x; idx < cols * kRanks; idx += kThreads) {
        const int q = idx / cols, c = idx - q * cols;
        store_remote(remote_addr(shared_addr(full + first + c), q),
                     rhs_at(c, sig), remote_addr(bar, q));
      }
    }
    wait_phase(bar, (phase >> (2 + p)) & 1u);
    phase ^= 1u << (2 + p);
    // rhs @ K^-1[:, cols]: a lane takes a float4 of columns; the rows
    // are split across the lane groups of a warp (summed by shuffles)
    // and across the warps (summed in warp order through parts). The
    // tail's rows follow the resident ones into the same sums (its
    // instance has ld <= 128, so one pass of q0 covers every quad).
    const float* K = L.op();
    float* parts = L.Work();
    const Lanes ln(ld);
    const int q4 = ln.q4, g = ln.g, per_warp = ln.per_warp;
    const int warp = ln.warp, sub = ln.sub, cq = ln.cq, step = ln.step;
    const int rows = kTail ? L.rows : n;
    for (int q0 = 0; q0 < q4; q0 += g) {
      const int q = q0 + cq;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < q4) {
#pragma unroll 4
        for (int i = warp * per_warp + sub; i < rows; i += step) {
          const float ri = full[i];
          const float4 k = reinterpret_cast<const float4*>(K + i * ld)[q];
          acc.x = fmaf(ri, k.x, acc.x);
          acc.y = fmaf(ri, k.y, acc.y);
          acc.z = fmaf(ri, k.z, acc.z);
          acc.w = fmaf(ri, k.w, acc.w);
        }
      }
      if constexpr (kTail) tail_product(op, ln, full, acc);
      for (int o = g; o < 32; o <<= 1) {
        acc.x += __shfl_xor_sync(kFull, acc.x, o);
        acc.y += __shfl_xor_sync(kFull, acc.y, o);
        acc.z += __shfl_xor_sync(kFull, acc.z, o);
        acc.w += __shfl_xor_sync(kFull, acc.w, o);
      }
      if (sub == 0 && q < q4)
        reinterpret_cast<float4*>(parts + warp * ld)[q] = acc;
    }
    __syncthreads();
    float* xt = L.v(kXt);
    for (int c = threadIdx.x; c < cols; c += kThreads) {
      float acc = parts[c];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) acc += parts[w * ld + c];
      xt[c] = acc;
    }
    __syncthreads();
  }

  // One OSQP iteration (the counterpart of one_iteration and of
  // _make_iteration): rhs -> solve -> relaxed z-clip, prox, duals.
  __device__ __forceinline__ void iteration(const Inputs& a,
                                            const float* op) {
    const int m = L.m;
    const float al = a.alpha, one_m_al = a.one_m_alpha, sig = a.sigma;
    if constexpr (kTri) {
      float* rhs = L.v(kRhs);
      for (int c = threadIdx.x; c < cols; c += kThreads) rhs[c] = rhs_at(c, sig);
      __syncthreads();
      solve_triangular();
    } else {
      solve_inverse(sig, op);
    }
    float *z = L.mv(kZ), *y = L.mv(kY);
    const float *l = L.mv(kL), *u = L.mv(kU), *rho = L.mv(kRho);
    const float* xt = L.v(kXt);
    float* zt = L.Zt();
    reduce_rows(xt, zt);
    float *x = L.v(kX), *w = L.v(kW), *mu = L.v(kMu);
    const float *lb = L.v(kLb), *ub = L.v(kUb), *rho_b = L.v(kRhoB);
    const float *l1w = L.v(kL1w), *l1c = L.v(kL1c);
    for (int c = threadIdx.x; c < cols; c += kThreads)
      col_update(xt[c], al, one_m_al, rho_b[c], lb[c], ub[c], l1w[c], l1c[c],
                 x[c], w[c], mu[c]);
    for (int r = threadIdx.x; r < m; r += kThreads)
      row_update(zt[r], al, one_m_al, rho[r], l[r], u[r], z[r], y[r]);
    __syncthreads();
  }

  // The operator slice, read from device memory once per launch.
  __device__ __forceinline__ void load_operator(const float* op) {
    const int n = L.n;
    if constexpr (kTri) {
      // The lower triangle in tiles of kTile x kTile, tile (ti, tj) with
      // tj <= ti, dealt to the ranks in turn. A rank reads its tile
      // coalesced (warp w its rows 4w..4w+3, a lane per column) into a
      // staging array, then each warp stores 4 of the tile's columns, a
      // lane per row: kTile consecutive entries of one owner's packed
      // column (rank j mod kRanks, column j / kRanks), through
      // distributed shared memory. The next tile's loads are in flight
      // during the stores; the caller makes the stores visible with a
      // cluster barrier.
      constexpr int kRows = kTile / kWarps;  // tile rows a warp reads
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      float* stage = L.Ring(0);
      const unsigned lp = shared_addr(L.op());
      const int nt = (n + kTile - 1) / kTile;
      int ti = 0, tj = rank;
      auto next = [&] {  // advance (ti, tj) to the tile kRanks further on
        while (tj > ti) {
          tj -= ti + 1;
          ++ti;
        }
      };
      float v[kRows];
      auto fetch = [&] {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = ti * kTile + warp * kRows + r, j = tj * kTile + lane;
          v[r] = i < n && j < n ? __ldg(op + (size_t)i * n + j) : 0.f;
        }
      };
      next();
      if (ti < nt) fetch();
      while (ti < nt) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          stage[(warp * kRows + r) * (kTile + 1) + lane] = v[r];
        __syncthreads();
        const int i = ti * kTile + lane, j0 = tj * kTile + warp * kRows;
        tj += kRanks;
        next();
        if (ti < nt) fetch();
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int j = j0 + k, owner = j % kRanks, c = j / kRanks;
          if (i < n && j <= i)
            store_cluster(
                remote_addr(lp + 4u * (c * (n - owner) -
                                       kRanks * c * (c - 1) / 2 + (i - j)),
                            owner),
                stage[lane * (kTile + 1) + warp * kRows + k]);
        }
        __syncthreads();
      }
    } else {
      // Row i of K^-1[:, cols] into row i of the slice (the first
      // `rows` rows with a streamed tail), consecutive threads on
      // consecutive addresses; 16 bytes at a time where rows and slice
      // are 16-byte aligned.
      float* K = L.op();
      const int ld = L.ld, rows = kTail ? L.rows : n;
      if ((n & 3) == 0 && (first & 3) == 0 && (cols & 3) == 0) {
        const int q4 = cols >> 2;
        for (int e = threadIdx.x; e < rows * q4; e += kThreads) {
          const int i = e / q4, q = e - i * q4;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                           shared_addr(K + i * ld + 4 * q)),
                       "l"(op + (size_t)i * n + first + 4 * q)
                       : "memory");
        }
      } else {
        for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
          const int i = e / cols, c = e - i * cols;
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                           shared_addr(K + i * ld + c)),
                       "l"(op + (size_t)i * n + first + c)
                       : "memory");
        }
      }
    }
  }
};

template <bool kTri, int kRanks, bool kTail>
__global__ void __launch_bounds__(kThreads, 3)
    dense_cluster_kernel(Inputs a) {
  const int n = a.n, m = a.m;
  Block<kTri, kRanks, kTail> blk(n, m, a.rows);
  const Layout<kTri, kRanks, kTail>& L = blk.L;
  const size_t b = blockIdx.x / kRanks;
  const int cols = blk.cols, first = blk.first, stride = blk.stride;
  const float* op = a.op + b * n * n;

  // Zero first: the float4 product reads the K^-1 slice past its last
  // column, and those entries are best 0.
  for (int i = threadIdx.x; i < L.total; i += kThreads) smem[i] = 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int p = 0; p < 6; ++p) init_barrier(shared_addr(L.Bar(p)));
    fence_barrier_init();
  }
  // Every block of the cluster runs and is zeroed before any stores
  // into another.
  blk.cluster.sync();
  blk.load_operator(op);
  const float* C = a.C + b * m * n + first;
  for (int r = 0; r < m; ++r) copy(L.C() + r * L.ld, C + r * n, cols, stride);
  const size_t o = b * n + first;
  copy(L.v(kX), a.x + o, cols, stride);
  copy(L.v(kW), a.w + o, cols, stride);
  copy(L.v(kMu), a.mu + o, cols, stride);
  copy(L.v(kQ), a.q + o, cols, stride);
  copy(L.v(kLb), a.lb + o, cols, stride);
  copy(L.v(kUb), a.ub + o, cols, stride);
  copy(L.v(kRhoB), a.rho_b + o, cols, stride);
  copy(L.v(kL1w), a.l1w + o, cols, stride);
  copy(L.v(kL1c), a.l1c + o, cols, stride);
  copy(L.mv(kZ), a.z + b * m, m);
  copy(L.mv(kY), a.y + b * m, m);
  copy(L.mv(kL), a.l + b * m, m);
  copy(L.mv(kU), a.u + b * m, m);
  copy(L.mv(kRho), a.rho + b * m, m);
  wait_copies();
  // The tail's first copies go out now, to land during the set-up's
  // last barrier and the first iteration's exchange.
  if constexpr (kTail) blk.tail_start(op);
  // The operator's stores through distributed shared memory are
  // visible, and every block's mbarriers initialised, before the first
  // exchange.
  blk.cluster.sync();

  float *x = L.v(kX), *mu = L.v(kMu), *y = L.mv(kY);
  float *xprev = L.v(kXPrev), *muprev = L.v(kMuPrev), *yprev = L.mv(kYPrev);
  for (int it = 0; it < a.n_iters; ++it) {
    if (it == a.n_iters - 1) {
      // Increments are between the last two iterates.
      for (int c = threadIdx.x; c < cols; c += kThreads) {
        xprev[c] = x[c];
        muprev[c] = mu[c];
      }
      for (int r = threadIdx.x; r < m; r += kThreads) yprev[r] = y[r];
      __syncthreads();
    }
    blk.iteration(a, op);
  }

  const float* w = L.v(kW);
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    const size_t at = o + (size_t)c * stride;
    a.x_out[at] = x[c];
    a.w_out[at] = w[c];
    a.mu_out[at] = mu[c];
    a.dx_out[at] = x[c] - xprev[c];
    a.dmu_out[at] = mu[c] - muprev[c];
  }
  if (blk.rank == 0) {
    const float* z = L.mv(kZ);
    for (int r = threadIdx.x; r < m; r += kThreads) {
      a.z_out[b * m + r] = z[r];
      a.y_out[b * m + r] = y[r];
      a.dy_out[b * m + r] = y[r] - yprev[r];
    }
  }
  // The tail's copies for an iteration that will not run land before
  // the block's shared memory goes.
  if constexpr (kTail) asm volatile("cp.async.wait_all;\n" ::: "memory");
  // No block may exit while another can still reach its shared memory.
  blk.cluster.sync();
}

template <bool kTri, int kRanks, bool kTail>
size_t smem_bytes(int n, int m, int rows) {
  return Layout<kTri, kRanks, kTail, size_t>(n, m, rows).total *
         sizeof(float);
}

// The card's shared memory per block with opt-in, for the current
// device; 0 where the query fails.
int smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

// The triangular form's rank count: 8 where a rank's packed columns fit
// the card's block, else 16. The one choice: the size, occupancy and
// launch functions below all take it from here.
int tri_ranks(int n, int m) {
  return smem_bytes<true, kTriRanks, false>(n, m, n) <= (size_t)smem_optin()
             ? kTriRanks
             : kWideRanks;
}

// Rows of the K^-1 slice the tail form keeps in shared memory: as many
// as fit beside everything else in the card's block, at most n; -1
// where not even the rest fits, or where a rank's slice is wider than
// one pass of a warp's float4 lanes (ld > 128, n > 2,048) covers.
int tail_rows(int n, int m) {
  const Layout<false, kInvRanks, true, size_t> none(n, m, 0);
  const size_t base = none.total * sizeof(float);
  const size_t limit = (size_t)smem_optin();
  if (none.ld > 128 || base > limit) return -1;
  const size_t rows = (limit - base) / (none.ld * sizeof(float));
  return rows < (size_t)n ? (int)rows : n;
}

// Sets the kernel's shared-memory size (and, above 8 blocks, allows the
// non-portable cluster size) and fills cfg; attr must outlive cfg.
template <bool kTri, int kRanks, bool kTail>
cudaError_t configure(int n, int m, int rows, int batch, cudaStream_t stream,
                      cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  const size_t bytes = smem_bytes<kTri, kRanks, kTail>(n, m, rows);
  if (bytes > (size_t)INT_MAX) return cudaErrorInvalidValue;
  auto kernel = dense_cluster_kernel<kTri, kRanks, kTail>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  if (kRanks > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kRanks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(kRanks * batch, 1, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = bytes;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <bool kTri, int kRanks, bool kTail>
int max_active(int n, int m, int rows) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err =
      configure<kTri, kRanks, kTail>(n, m, rows, 1, 0, &attr, &cfg);
  if (err != cudaSuccess) return -(int)err;
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(
      &count, (const void*)dense_cluster_kernel<kTri, kRanks, kTail>, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return count;
}

template <bool kTri, int kRanks, bool kTail>
int launch(Inputs a, int batch, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  if (!kTail) a.rows = a.n;
  cudaError_t err = configure<kTri, kRanks, kTail>(a.n, a.m, a.rows, batch,
                                                   stream, &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    err = cudaLaunchKernelEx(&cfg, dense_cluster_kernel<kTri, kRanks, kTail>,
                             a);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// Fills the launch arguments every form shares.
Inputs inputs_of(const float* op, const float* C, const float* q,
                 const float* l, const float* u, const float* lb,
                 const float* ub, const float* rho, const float* rho_b,
                 const float* l1w, const float* l1c, const float* x,
                 const float* z, const float* w, const float* y,
                 const float* mu, float* x_out, float* z_out, float* w_out,
                 float* y_out, float* mu_out, float* dx_out, float* dy_out,
                 float* dmu_out, int n, int m, int n_iters, float sigma,
                 float alpha, float one_m_alpha) {
  Inputs a{};
  a.op = op;
  a.C = C; a.q = q; a.l = l; a.u = u; a.lb = lb; a.ub = ub;
  a.rho = rho; a.rho_b = rho_b; a.l1w = l1w; a.l1c = l1c;
  a.x = x; a.z = z; a.w = w; a.y = y; a.mu = mu;
  a.x_out = x_out; a.z_out = z_out; a.w_out = w_out; a.y_out = y_out;
  a.mu_out = mu_out; a.dx_out = dx_out; a.dy_out = dy_out; a.dmu_out = dmu_out;
  a.n = n; a.m = m; a.n_iters = n_iters; a.rows = n;
  a.sigma = sigma; a.alpha = alpha; a.one_m_alpha = one_m_alpha;
  return a;
}

}  // namespace

extern "C" {

// The rank count of the resident form at this shape: 8 or 16 blocks per
// cluster.
int porqua_admm_dense_cluster_ranks(int n, int m, int triangular) {
  return triangular ? tri_ranks(n, m) : kInvRanks;
}

int porqua_admm_dense_cluster_smem_bytes(int n, int m, int triangular) {
  const size_t bytes =
      !triangular ? smem_bytes<false, kInvRanks, false>(n, m, n)
      : tri_ranks(n, m) == kTriRanks
          ? smem_bytes<true, kTriRanks, false>(n, m, n)
          : smem_bytes<true, kWideRanks, false>(n, m, n);
  return bytes > (size_t)INT_MAX ? INT_MAX : (int)bytes;
}

// How many clusters of this shape the card can hold at once; a negative
// value is a CUDA error code, negated.
int porqua_admm_dense_cluster_max_active(int n, int m, int triangular) {
  if (!triangular) return max_active<false, kInvRanks, false>(n, m, n);
  return tri_ranks(n, m) == kTriRanks
             ? max_active<true, kTriRanks, false>(n, m, n)
             : max_active<true, kWideRanks, false>(n, m, n);
}

// The resident form. ranks: -1 for the count the shape takes
// (porqua_admm_dense_cluster_ranks), or 8 or 16 (the triangle only) to
// launch that count whatever the shape takes, where it fits.
int porqua_admm_segment_dense_cluster(
    const float* op, const float* C, const float* q, const float* l,
    const float* u, const float* lb, const float* ub, const float* rho,
    const float* rho_b, const float* l1w, const float* l1c, const float* x,
    const float* z, const float* w, const float* y, const float* mu,
    float* x_out, float* z_out, float* w_out, float* y_out, float* mu_out,
    float* dx_out, float* dy_out, float* dmu_out, int batch, int n, int m,
    int n_iters, int ranks, float sigma, float alpha, float one_m_alpha,
    int triangular, void* stream) {
  const Inputs a = inputs_of(op, C, q, l, u, lb, ub, rho, rho_b, l1w, l1c,
                             x, z, w, y, mu, x_out, z_out, w_out, y_out,
                             mu_out, dx_out, dy_out, dmu_out, n, m, n_iters,
                             sigma, alpha, one_m_alpha);
  const cudaStream_t s = (cudaStream_t)stream;
  if (!triangular)
    return ranks == -1 || ranks == kInvRanks
               ? launch<false, kInvRanks, false>(a, batch, s)
               : (int)cudaErrorInvalidValue;
  if (ranks == -1) ranks = tri_ranks(n, m);
  if (ranks == kTriRanks) return launch<true, kTriRanks, false>(a, batch, s);
  if (ranks == kWideRanks) return launch<true, kWideRanks, false>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}

// The form with a streamed tail holds K^-1 only; for L^-1 the size is
// INT_MAX (no card fits it) and the launch is refused.
int porqua_admm_dense_tail_rows(int n, int m, int triangular) {
  return triangular ? -1 : tail_rows(n, m);
}

int porqua_admm_dense_tail_smem_bytes(int n, int m, int triangular) {
  const int rows = porqua_admm_dense_tail_rows(n, m, triangular);
  if (rows < 0) return INT_MAX;
  const size_t bytes = smem_bytes<false, kInvRanks, true>(n, m, rows);
  return bytes > (size_t)INT_MAX ? INT_MAX : (int)bytes;
}

int porqua_admm_dense_tail_max_active(int n, int m, int triangular) {
  const int rows = porqua_admm_dense_tail_rows(n, m, triangular);
  if (rows < 0) return 0;
  return max_active<false, kInvRanks, true>(n, m, rows);
}

// The tail form. rows: -1 for the rows the shape takes
// (porqua_admm_dense_tail_rows), or 0..n to keep that many resident and
// stream the rest, where it fits.
int porqua_admm_segment_dense_tail(
    const float* op, const float* C, const float* q, const float* l,
    const float* u, const float* lb, const float* ub, const float* rho,
    const float* rho_b, const float* l1w, const float* l1c, const float* x,
    const float* z, const float* w, const float* y, const float* mu,
    float* x_out, float* z_out, float* w_out, float* y_out, float* mu_out,
    float* dx_out, float* dy_out, float* dmu_out, int batch, int n, int m,
    int n_iters, int rows, float sigma, float alpha, float one_m_alpha,
    int triangular, void* stream) {
  Inputs a = inputs_of(op, C, q, l, u, lb, ub, rho, rho_b, l1w, l1c, x, z,
                       w, y, mu, x_out, z_out, w_out, y_out, mu_out, dx_out,
                       dy_out, dmu_out, n, m, n_iters, sigma, alpha,
                       one_m_alpha);
  const int fit = porqua_admm_dense_tail_rows(n, m, triangular);
  if (fit < 0 || rows < -1 || rows > n) return (int)cudaErrorInvalidValue;
  a.rows = rows < 0 ? fit : rows;
  return launch<false, kInvRanks, true>(a, batch, (cudaStream_t)stream);
}

}  // extern "C"
