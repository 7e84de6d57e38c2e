// Dense paged decode attention: one query token per slot against its paged
// KV cache, GQA, online softmax over every entry of the slot's block table.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::paged_attention.
// That kernel's grid (B, h_kv, max_blocks) visits every table entry of
// every slot: a -1 entry is clamped to page 0 and its page is DMA'd and
// masked. It is the baseline the ragged kernel (ragged_paged_attention.cu)
// is measured against, so this kernel does the baseline's work: one thread
// block per (slot, kv head) walks all max_blocks entries in order, and an
// entry that is -1 or at or beyond ceil(seq_len / b) loads the clamped
// page 0 all the same. Its scores are masked to -1e30 and its V lanes are
// read as zeros before p.V, so a NaN page 0 or a stale tail cannot reach
// the output. Rows with seq_len == 0 come out as zeros, as in the JAX
// package's paged.paged_decode_attention.
//
// The per-page math is zp_decode_page (common.cuh), the same code the
// ragged kernel runs. A masked page adds exact zeros and leaves the
// running max as it was (its rescale factor is expf(0) == 1), so the live
// rows of the two kernels are bit-identical — the port's counterpart of
// the JAX package's ragged == dense.
//
// What bounds it on the card: memory, as for the ragged kernel, but over
// the whole table: it reads B * max_blocks pages of K and V per kv head
// whatever the slots' lengths, and its flops (4 * g per K/V element pair)
// stay far below the H100's ridge point.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(kDecodeThreads)
paged_attention_kernel(const float* __restrict__ q,       // (B, hq, d)
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
  const int n_live = seq_len > 0 ? (seq_len + b - 1) / b : 0;

  float acc[kDecodeMaxG][kDecodeMaxDpt];
  zp_decode_begin(s, q + ((size_t)slot * hq + (size_t)h * g) * d, acc, g, d);
  const int* bt = block_tables + (size_t)slot * mb;
  for (int i = 0; i < mb; ++i) {
    const int entry = bt[i];
    const bool live = i < n_live && entry >= 0;
    const int page = entry >= 0 ? entry : 0;  // -1 is clamped to page 0
    const int n_valid = live ? min(b, seq_len - i * b) : 0;
    __syncthreads();  // the previous page's k/v/p are no longer read
    for (int idx = threadIdx.x; idx < b * d; idx += blockDim.x) {
      const int t = idx / d;
      const int dd = idx - t * d;
      const size_t off = (((size_t)page * b + t) * hkv + h) * d + dd;
      s.k[idx] = k_pool[off];  // loaded whatever the mask: masked in the math
      s.v[idx] = v_pool[off];
    }
    __syncthreads();
    zp_decode_page(s, acc, n_valid, g, d, b, scale);
  }
  zp_decode_end(s, acc, out + ((size_t)slot * hq + (size_t)h * g) * d, g, d);
}
}  // namespace

extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* block_tables, const void* seq_lens,
                                      void* out, int batch, int hkv, int g, int d, int b,
                                      int mb, float scale, void* stream) {
  if (g < 1 || g > kDecodeMaxG || d < 1 || d > kDecodeThreads * kDecodeMaxDpt)
    return (int)cudaErrorInvalidValue;
  const size_t smem = zp_decode_smem_bytes(g, d, b);
  cudaError_t err = zp_allow_smem(paged_attention_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(batch, hkv);
  paged_attention_kernel<<<grid, kDecodeThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k_pool, (const float*)v_pool,
      (const int*)block_tables, (const int*)seq_lens, (float*)out, hkv, g, d, b, mb, scale);
  return (int)cudaGetLastError();
}
