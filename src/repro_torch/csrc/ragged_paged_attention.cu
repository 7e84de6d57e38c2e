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
// the current page's math. The per-page math is zp_decode_page in
// common.cuh, shared with the dense kernel (paged_attention.cu), so that
// live rows of the two are bit-identical.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(kDecodeThreads)
ragged_paged_attention_kernel(const float* __restrict__ q,       // (B, hq, d)
                              const float* __restrict__ k_pool,  // (N, b, hkv, d)
                              const float* __restrict__ v_pool,  // (N, b, hkv, d)
                              const int* __restrict__ block_tables,  // (B, mb)
                              const int* __restrict__ seq_lens,      // (B,)
                              float* __restrict__ out,               // (B, hq, d)
                              int hkv, int g, int d, int b, int mb, float scale) {
  extern __shared__ float smem[];
  const ZpDecodeSmem s = zp_decode_layout(smem, g, d, b);
  const int slot = blockIdx.x;
  const int h = blockIdx.y;
  const int hq = hkv * g;
  const int seq_len = seq_lens[slot];
  float* o = out + ((size_t)slot * hq + (size_t)h * g) * d;

  if (seq_len <= 0) {  // inactive slot: exact zeros, no page touched
    for (int i = threadIdx.x; i < g * d; i += blockDim.x) o[i] = 0.f;
    return;
  }

  float acc[kDecodeMaxG][kDecodeMaxDpt];
  zp_decode_begin(s, q + ((size_t)slot * hq + (size_t)h * g) * d, acc, g, d);
  const int n_live = min((seq_len + b - 1) / b, mb);
  const int* bt = block_tables + (size_t)slot * mb;
  for (int i = 0; i < n_live; ++i) {
    const int page = bt[i];
    // valid tokens on this page; a -1 entry is never dereferenced
    const int n_valid = page >= 0 ? min(b, seq_len - i * b) : 0;
    __syncthreads();  // the previous page's k/v/p are no longer read
    for (int idx = threadIdx.x; idx < b * d; idx += blockDim.x) {
      const int t = idx / d;
      const int dd = idx - t * d;
      float kv = 0.f, vv = 0.f;
      if (t < n_valid) {
        const size_t off = (((size_t)page * b + t) * hkv + h) * d + dd;
        kv = k_pool[off];
        vv = v_pool[off];
      }
      s.k[idx] = kv;
      s.v[idx] = vv;
    }
    __syncthreads();
    zp_decode_page(s, acc, n_valid, g, d, b, scale);
  }
  zp_decode_end(s, acc, o, g, d);
}
}  // namespace

extern "C" int ragged_paged_attention_launch(const void* q, const void* k_pool,
                                             const void* v_pool, const void* block_tables,
                                             const void* seq_lens, void* out, int batch,
                                             int hkv, int g, int d, int b, int mb,
                                             float scale, void* stream) {
  if (g < 1 || g > kDecodeMaxG || d < 1 || d > kDecodeThreads * kDecodeMaxDpt)
    return (int)cudaErrorInvalidValue;
  const size_t smem = zp_decode_smem_bytes(g, d, b);
  cudaError_t err = zp_allow_smem(ragged_paged_attention_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(batch, hkv);
  ragged_paged_attention_kernel<<<grid, kDecodeThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k_pool, (const float*)v_pool,
      (const int*)block_tables, (const int*)seq_lens, (float*)out, hkv, g, d, b, mb, scale);
  return (int)cudaGetLastError();
}
