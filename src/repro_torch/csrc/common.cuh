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
// Tiles of keys in cache order, staged by 16-byte cp.async (flash
// redundancy and window logits). A tile is kKeyTile (or fewer) consecutive
// cache positions of one request and one kv head, d floats each, kept in shared
// memory with a row stride of d + kKeyPad floats: rows stay 16-byte
// aligned, and 16-byte reads of consecutive rows at one column hit
// distinct banks.
constexpr int kKeyTile = 64;
constexpr int kKeyPad = 4;

__device__ __forceinline__ void zp_cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int src_bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void zp_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of the committed groups are still in flight.
template <int n>
__device__ __forceinline__ void zp_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Issue the copies of one tile: cache positions pos0 .. pos0 + rows - 1
// of a request (its table row bt, n_valid live positions), kv head hh of
// h, into dst. Positions at or past n_valid, and positions on a -1 table
// entry, are zero-filled without reading the table entry or the pool, so
// stale or NaN pool data never reaches shared memory. Needs d % 4 == 0.
// The address arithmetic sits on the path that issues the copies, so it
// is kept short: when the block's threads divide into the row's 16-byte
// columns each thread keeps one column and walks rows, and a block size
// that is a power of two is divided by shifts.
__device__ __forceinline__ void zp_load_key_tile(float* dst, const float* __restrict__ pool,
                                                 const int* __restrict__ bt, int pos0,
                                                 int n_valid, int h, int hh, int d, int b,
                                                 int rows = kKeyTile) {
  const int d4 = d >> 2;
  const int ld = d + kKeyPad;
  const int shift = (b & (b - 1)) == 0 ? __ffs(b) - 1 : -1;
  auto copy = [&](int t, int c4) {
    const int pos = pos0 + t;
    const int blk = shift >= 0 ? pos >> shift : pos / b;
    const int slot = pos - blk * b;
    const int page = pos < n_valid ? bt[blk] : -1;
    const float* src =
        page >= 0 ? pool + (((size_t)page * b + slot) * h + hh) * d + 4 * c4 : pool;
    zp_cp_async16(dst + t * ld + 4 * c4, src, page >= 0);
  };
  if (blockDim.x % d4 == 0) {
    const int c4 = threadIdx.x % d4;
    for (int t = threadIdx.x / d4; t < rows; t += blockDim.x / d4) copy(t, c4);
  } else {
    for (int idx = threadIdx.x; idx < rows * d4; idx += blockDim.x) copy(idx / d4, idx % d4);
  }
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
