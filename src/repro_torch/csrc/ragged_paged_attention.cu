// Ragged paged decode attention: one query token per slot against its paged
// KV cache, GQA, online softmax over the slot's live pages only.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ragged_paged_attention.py::ragged_paged_attention.
// There the grid (B, max_blocks) ran its block axis in order on one core and
// carried the softmax state in VMEM scratch. Here one thread block owns one
// (slot, kv head) pair and walks that slot's live pages in a loop, so the
// state stays in shared memory and registers, and blocks run in parallel.
//
// Contract (same as the TPU kernel): only pages 0..ceil(seq_len/b)-1 of the
// slot's table are read, so a -1 table entry is never dereferenced; V (and
// K) lanes at positions >= seq_len are replaced by zeros before they enter
// any product, so stale or NaN pool data past seq_len cannot leak; rows
// with seq_len == 0 are exact zeros. The g query heads that share a kv head
// are scored against each page together, so a page is read once for all
// of them.
//
// What bounds it on the card: memory. Per slot it reads its live K and V
// pages once (2 * seq_len * d * 4 bytes per kv head) and does 4 * g flops
// per byte pair — far below the H100's ridge point — so the bound is the
// live pages' bytes over HBM bandwidth. This first version keeps the page
// loop simple (one page in shared memory at a time, no cp.async/TMA
// pipelining); a later revision should overlap the next page's load with
// the current page's math.
#include "common.cuh"

namespace {
constexpr int kThreads = 128;
constexpr int kMaxG = 8;     // query heads per kv head
constexpr int kMaxDpt = 2;   // head_dim <= kThreads * kMaxDpt = 256

__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const float* __restrict__ q,       // (B, hq, d)
                              const float* __restrict__ k_pool,  // (N, b, hkv, d)
                              const float* __restrict__ v_pool,  // (N, b, hkv, d)
                              const int* __restrict__ block_tables,  // (B, mb)
                              const int* __restrict__ seq_lens,      // (B,)
                              float* __restrict__ out,               // (B, hq, d)
                              int hkv, int g, int d, int b, int mb, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;               // g * d
  float* k_s = q_s + g * d;        // b * d
  float* v_s = k_s + b * d;        // b * d
  float* p_s = v_s + b * d;        // g * b: scores, then probabilities
  float* m_s = p_s + g * b;        // g running maxima
  float* l_s = m_s + g;            // g running denominators
  float* c_s = l_s + g;            // g rescale factors of this page

  const int slot = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int hq = hkv * g;
  const int seq_len = seq_lens[slot];
  float* o = out + ((size_t)slot * hq + (size_t)h * g) * d;

  if (seq_len <= 0) {  // inactive slot: exact zeros, no page touched
    for (int i = tid; i < g * d; i += blockDim.x) o[i] = 0.f;
    return;
  }

  const float* qp = q + ((size_t)slot * hq + (size_t)h * g) * d;
  for (int i = tid; i < g * d; i += blockDim.x) q_s[i] = qp[i];
  if (tid < g) {
    m_s[tid] = ZP_NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[kMaxG][kMaxDpt];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi)
#pragma unroll
    for (int j = 0; j < kMaxDpt; ++j) acc[gi][j] = 0.f;

  const int n_live = min((seq_len + b - 1) / b, mb);
  const int* bt = block_tables + (size_t)slot * mb;
  for (int i = 0; i < n_live; ++i) {
    const int page = bt[i];
    const int n_valid = min(b, seq_len - i * b);  // valid tokens on this page
    __syncthreads();  // the previous page's k_s/v_s/p_s are no longer read
    for (int idx = tid; idx < b * d; idx += blockDim.x) {
      const int t = idx / d;
      const int dd = idx - t * d;
      float kv = 0.f, vv = 0.f;
      if (t < n_valid && page >= 0) {
        const size_t off = (((size_t)page * b + t) * hkv + h) * d + dd;
        kv = k_pool[off];
        vv = v_pool[off];
      }
      k_s[idx] = kv;
      v_s[idx] = vv;
    }
    __syncthreads();
    for (int pair = warp; pair < g * b; pair += n_warps) {
      const int gi = pair / b;
      const int t = pair - gi * b;
      float s = 0.f;
      for (int dd = lane; dd < d; dd += 32) s += q_s[gi * d + dd] * k_s[t * d + dd];
      s = zp_warp_sum(s);
      if (lane == 0) p_s[pair] = (t < n_valid && page >= 0) ? s * scale : ZP_NEG_INF;
    }
    __syncthreads();
    if (tid < g) {
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int t = 0; t < b; ++t) m_new = fmaxf(m_new, p_s[tid * b + t]);
      float sum = 0.f;
      for (int t = 0; t < b; ++t) {
        const float p = (t < n_valid && page >= 0) ? expf(p_s[tid * b + t] - m_new) : 0.f;
        p_s[tid * b + t] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = m_new;
      c_s[tid] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxDpt; ++j) {
      const int dd = tid + j * kThreads;
      if (dd < d) {
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) {
          if (gi < g) {
            float a = acc[gi][j] * c_s[gi];
            for (int t = 0; t < b; ++t) a += p_s[gi * b + t] * v_s[t * d + dd];
            acc[gi][j] = a;
          }
        }
      }
    }
  }
  // l_s was last written before the final barrier of the loop
#pragma unroll
  for (int j = 0; j < kMaxDpt; ++j) {
    const int dd = tid + j * kThreads;
    if (dd < d) {
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < g) o[gi * d + dd] = acc[gi][j] / fmaxf(l_s[gi], 1e-30f);
    }
  }
}
}  // namespace

extern "C" int ragged_paged_attention_launch(const void* q, const void* k_pool,
                                             const void* v_pool, const void* block_tables,
                                             const void* seq_lens, void* out, int batch,
                                             int hkv, int g, int d, int b, int mb,
                                             float scale, void* stream) {
  if (g < 1 || g > kMaxG || d < 1 || d > kThreads * kMaxDpt) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)g * d + 2 * (size_t)b * d + (size_t)g * b + 3 * g);
  cudaError_t err = zp_allow_smem(ragged_paged_attention_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(batch, hkv);
  ragged_paged_attention_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k_pool, (const float*)v_pool,
      (const int*)block_tables, (const int*)seq_lens, (float*)out, hkv, g, d, b, mb, scale);
  return (int)cudaGetLastError();
}
