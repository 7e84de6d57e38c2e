// Shared helpers for the port's hand-written Hopper kernels.
#pragma once
#include <cuda_runtime.h>

#define ZP_NEG_INF (-1e30f)

__device__ __forceinline__ float zp_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Dynamic shared memory above the 48 KB default needs an explicit opt-in.
template <typename Kernel>
static cudaError_t zp_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

extern "C" const char* zp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ---------------------------------------------------------------------------
// Decode attention, one page at a time (the ragged and the dense decode
// kernels share this, so that their live rows are bit-identical).
//
// A thread block of kDecodeThreads owns one (slot, kv head) and its g query
// heads. Shared memory holds q (g*d), this page's k and v (b*d each), the
// scores / probabilities p (g*b) and the running max m, denominator l and
// rescale c (g each); each thread keeps acc[gi][j] for head dim
// tid + j*kDecodeThreads in registers.
constexpr int kDecodeThreads = 128;
constexpr int kDecodeMaxG = 8;     // query heads per kv head
constexpr int kDecodeMaxDpt = 2;   // head_dim <= kDecodeThreads * kDecodeMaxDpt = 256

struct ZpDecodeSmem {
  float *q, *k, *v, *p, *m, *l, *c;
};

__host__ __device__ __forceinline__ size_t zp_decode_smem_bytes(int g, int d, int b) {
  return sizeof(float) * ((size_t)g * d + 2 * (size_t)b * d + (size_t)g * b + 3 * (size_t)g);
}

__device__ __forceinline__ ZpDecodeSmem zp_decode_layout(float* smem, int g, int d, int b) {
  ZpDecodeSmem s;
  s.q = smem;
  s.k = s.q + g * d;
  s.v = s.k + b * d;
  s.p = s.v + b * d;
  s.m = s.p + g * b;
  s.l = s.m + g;
  s.c = s.l + g;
  return s;
}

// Load the g queries (g*d floats at qp) and reset the softmax state.
__device__ __forceinline__ void zp_decode_begin(const ZpDecodeSmem& s, const float* __restrict__ qp,
                                                float (&acc)[kDecodeMaxG][kDecodeMaxDpt],
                                                int g, int d) {
  for (int i = threadIdx.x; i < g * d; i += blockDim.x) s.q[i] = qp[i];
  if (threadIdx.x < g) {
    s.m[threadIdx.x] = ZP_NEG_INF;
    s.l[threadIdx.x] = 0.f;
  }
#pragma unroll
  for (int gi = 0; gi < kDecodeMaxG; ++gi)
#pragma unroll
    for (int j = 0; j < kDecodeMaxDpt; ++j) acc[gi][j] = 0.f;
}

// Online-softmax update with one page in s.k / s.v (the caller fills them
// and synchronises first). Entries t >= n_valid are masked: their score is
// ZP_NEG_INF, their probability exactly 0, and their V lane is read as 0,
// so stale or NaN data on the page cannot reach the output. A page with
// n_valid == 0 therefore adds exact zeros and its rescale factor is
// expf(0) == 1 (the running max stays as it was): it leaves m, l and acc
// bit for bit unchanged.
__device__ __forceinline__ void zp_decode_page(const ZpDecodeSmem& s,
                                               float (&acc)[kDecodeMaxG][kDecodeMaxDpt],
                                               int n_valid, int g, int d, int b,
                                               float scale) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int pair = warp; pair < g * b; pair += n_warps) {
    const int gi = pair / b;
    const int t = pair - gi * b;
    float dot = 0.f;
    for (int dd = lane; dd < d; dd += 32) dot += s.q[gi * d + dd] * s.k[t * d + dd];
    dot = zp_warp_sum(dot);
    if (lane == 0) s.p[pair] = t < n_valid ? dot * scale : ZP_NEG_INF;
  }
  __syncthreads();
  if (tid < g) {
    const float m_prev = s.m[tid];
    float m_new = m_prev;
    for (int t = 0; t < b; ++t) m_new = fmaxf(m_new, s.p[tid * b + t]);
    float sum = 0.f;
    for (int t = 0; t < b; ++t) {
      const float p = t < n_valid ? expf(s.p[tid * b + t] - m_new) : 0.f;
      s.p[tid * b + t] = p;
      sum += p;
    }
    const float corr = expf(m_prev - m_new);
    s.l[tid] = s.l[tid] * corr + sum;
    s.m[tid] = m_new;
    s.c[tid] = corr;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kDecodeMaxDpt; ++j) {
    const int dd = tid + j * kDecodeThreads;
    if (dd < d) {
#pragma unroll
      for (int gi = 0; gi < kDecodeMaxG; ++gi) {
        if (gi < g) {
          float a = acc[gi][j] * s.c[gi];
          for (int t = 0; t < b; ++t) {
            const float v = t < n_valid ? s.v[t * d + dd] : 0.f;
            a += s.p[gi * b + t] * v;
          }
          acc[gi][j] = a;
        }
      }
    }
  }
}

// Write acc / l for the block's g heads to o (g*d floats), after the last
// page (whose final barrier made s.l visible).
__device__ __forceinline__ void zp_decode_end(const ZpDecodeSmem& s,
                                              const float (&acc)[kDecodeMaxG][kDecodeMaxDpt],
                                              float* __restrict__ o, int g, int d) {
#pragma unroll
  for (int j = 0; j < kDecodeMaxDpt; ++j) {
    const int dd = threadIdx.x + j * kDecodeThreads;
    if (dd < d) {
#pragma unroll
      for (int gi = 0; gi < kDecodeMaxG; ++gi)
        if (gi < g) o[gi * d + dd] = acc[gi][j] / fmaxf(s.l[gi], 1e-30f);
    }
  }
}
