// What the fused ADMM segment kernels share, sm_90a: the elementwise
// updates of one OSQP iteration, in f32 (all three sources), and the
// cluster primitives of the two cluster designs (admm_segment_cluster.cu,
// admm_segment_dense_cluster.cu): shared-memory addresses across the
// cluster, st.async stores counted on mbarriers, cp.async copies into
// shared memory. One set, so that the designs do not carry copies of
// each other.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// Exact prox of I_[lb,ub] + t |. - c|: clipped shifted soft-threshold.
__device__ __forceinline__ float l1_box_prox(float v, float lb, float ub,
                                             float t, float c) {
  const float s = v - c;
  const float sgn = (float)((s > 0.f) - (s < 0.f));  // sign(0) == 0
  const float soft = sgn * fmaxf(fabsf(s) - t, 0.f);
  return clipf(c + soft, lb, ub);
}

// Column j of the update, in f32 as the TPU kernel and the plain
// version do it: x = alpha xt + (1 - alpha) x, w = prox(w_pre + mu /
// rho_b), mu += rho_b (w_pre - w).
__device__ __forceinline__ void col_update(float xt, float al,
                                           float one_m_al, float rho_b,
                                           float lb, float ub, float l1w,
                                           float l1c, float& x, float& w,
                                           float& mu) {
  const float inv_rhob = 1.0f / rho_b;
  x = al * xt + one_m_al * x;
  const float w_pre = al * xt + one_m_al * w;
  const float w_new = l1_box_prox(w_pre + mu * inv_rhob, lb, ub,
                                  l1w * inv_rhob, l1c);
  mu = mu + rho_b * (w_pre - w_new);
  w = w_new;
}

// Row r of the relaxed z-step, in f32 likewise: z = clip(z_pre + y /
// rho, l, u), y += rho (z_pre - z), from zt = (C xt)[r].
__device__ __forceinline__ void row_update(float zt, float al,
                                           float one_m_al, float rho,
                                           float l, float u, float& z,
                                           float& y) {
  const float inv_rho = 1.0f / rho;
  const float z_pre = al * zt + one_m_al * z;
  const float z_new = clipf(z_pre + y * inv_rho, l, u);
  y = y + rho * (z_pre - z_new);
  z = z_new;
}

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The address of the same shared location in block `rank` of the
// cluster.
__device__ __forceinline__ unsigned remote_addr(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Stores v at addr in another block and counts its 4 bytes on that
// block's mbarrier bar (both shared::cluster addresses).
__device__ __forceinline__ void store_remote(unsigned addr, float v,
                                             unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// Stores v at addr, a shared::cluster address of this block or another.
__device__ __forceinline__ void store_cluster(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

// Arrives on this block's mbarrier bar and makes its current phase wait
// for `bytes` more bytes of st.async stores.
__device__ __forceinline__ void expect_bytes(unsigned bar, int bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::
          "r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void init_barrier(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// Makes the barriers this thread initialised visible to the cluster.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// out[r] = (C v)[r] for the m rows of C (row stride ld, this block's
// cols columns), summed over the cluster's kRanks blocks in rank order.
// Each row's warp sums this block's columns, and lanes below kRanks
// store the partial into block (lane)'s receive slots (kRanks x m floats
// at the same offset in every block) with st.async, counted on that
// block's mbarrier bar; each block waits for phase `parity` of its own
// mbarrier (no cluster barrier) and adds its kRanks slots. The caller
// alternates two slot buffers and mbarriers: a buffer is written again
// two reductions later, which no block reaches before every block has
// read it, for the exchanges in between need every block's part.
template <int kRanks, int kThreads>
__device__ __forceinline__ void reduce_rows(const float* C, int ld, int m,
                                            int cols, const float* v,
                                            float* slots, unsigned bar,
                                            unsigned parity, int me,
                                            float* out) {
  if (threadIdx.x == 0) expect_bytes(bar, kRanks * m * 4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < m; r += kThreads / 32) {
    float acc = 0.f;
    for (int j = lane; j < cols; j += 32) acc = fmaf(C[r * ld + j], v[j], acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane < kRanks)
      store_remote(remote_addr(shared_addr(slots + me * m + r), lane), acc,
                   remote_addr(bar, lane));
  }
  wait_phase(bar, parity);
  for (int r = threadIdx.x; r < m; r += kThreads) {
    float acc = slots[r];
#pragma unroll
    for (int q = 1; q < kRanks; ++q) acc += slots[q * m + r];
    out[r] = acc;
  }
  __syncthreads();
}

// dst[i] = src[i * stride] for i < len, through cp.async (4 bytes
// each): the copies stay in flight until wait_copies().
__device__ __forceinline__ void copy(float* dst, const float* src, int len,
                                     int stride = 1) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     shared_addr(dst + i)),
                 "l"(src + (size_t)i * stride)
                 : "memory");
  }
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

}  // namespace
