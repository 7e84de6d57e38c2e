// Ragged paged decode attention: one query token per slot against its paged
// KV cache, GQA, online softmax over the slot's live pages only.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ragged_paged_attention.py::ragged_paged_attention.
// There the grid (B, max_blocks) ran its block axis in order on one core and
// carried the softmax state in VMEM scratch. Here the table is cut into
// chunks that run in parallel, each keeping its state in registers, and a
// second kernel merges the chunks' states in a fixed order.
//
// Contract (same as the TPU kernel): only entries 0..ceil(seq_len/b)-1 of
// the slot's table are read, and a -1 among them reads page 0 (the TPU
// kernel's clamp); K and V lanes at positions >= seq_len are zero-filled
// instead of read, and masked, so stale or NaN pool data past seq_len
// cannot leak; rows with seq_len == 0 are exact zeros. The g query heads that share a kv head are
// scored against each page together, so a page is read once for all of
// them.
//
// The design is the dense kernel's (common.cuh, "Decode attention in
// chunks"; paged_attention.cu), on the chunks and tiles that hold live
// positions only: a block whose chunk starts at or past seq_len returns at
// once, a chunk's walk stops at seq_len, and
// ragged_paged_attention_merge_kernel merges the live chunks alone. The
// shared code keeps the live rows of the two kernels bit-identical.
//
// What bounds it on the card: memory. Per slot it reads its live K and V
// pages once (2 * seq_len * d * 4 bytes per kv head in fp32, half that in
// bf16) and does 4 * g flops per element pair, far below the H100's ridge
// point, so the bound is the live pages' bytes over HBM bandwidth. What
// holds it back: the chunk size follows the table's shape, not the live
// lengths, so a short slot takes one block and a long one several, each
// walking its tiles one after
// another through chains of dependent shared loads, shuffles and exps;
// the merge is a second launch. PERF.md has the numbers.
#include "common.cuh"

namespace {

template <int G, int DPL, typename T>
__global__ void __launch_bounds__(kDecodeThreads)
ragged_paged_attention_chunk_kernel(ZpDecodeArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  zp_decode_chunk<G, DPL, false, T>(a, smem);
}

// Only the chunks that hold a position < seq_len were walked and are merged.
template <typename T>
__global__ void __launch_bounds__(kDecodeThreads)
ragged_paged_attention_merge_kernel(ZpDecodeArgs<T> a) {
  const int seq_len = max(a.seq_lens[blockIdx.y], 0);
  const int chunk_len = a.chunk_pages * a.b;
  zp_decode_merge(a, min(a.n_chunks, (seq_len + chunk_len - 1) / chunk_len));
}

const ZpDecodeChunkKernel<float> kChunkKernels[kDecodeTableG][2] =
    ZP_DECODE_TABLE(ragged_paged_attention_chunk_kernel, float);
const ZpDecodeChunkKernel<zp_bf16> kChunkKernelsBf16[kDecodeTableG][2] =
    ZP_DECODE_TABLE(ragged_paged_attention_chunk_kernel, zp_bf16);
const ZpDecodeChunkKernel<zp_f16> kChunkKernelsF16[kDecodeTableG][2] =
    ZP_DECODE_TABLE(ragged_paged_attention_chunk_kernel, zp_f16);
}  // namespace

// Floats of workspace (the chunks' fp32 parts) a launch needs after its
// output (zp_decode_out_bytes()), at either storage type.
extern "C" long long ragged_paged_attention_workspace(int batch, int hkv, int g, int d, int b,
                                                      int mb) {
  return zp_decode_workspace(batch, hkv, g, d, b, mb);
}

// q, the pools and the output in float ...
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* block_tables,
    const void* seq_lens, void* out, int batch, int hkv, int g, int d, int b, int mb,
    float scale, void* stream) {
  return zp_decode_launch<float>(kChunkKernels, ragged_paged_attention_merge_kernel<float>, q,
                                 k_pool, v_pool, block_tables, seq_lens, out, batch, hkv, g, d,
                                 b, mb, scale, stream);
}

// ... or in bf16 (the math in fp32 all the same, the output rounded once).
extern "C" int ragged_paged_attention_launch_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* block_tables,
    const void* seq_lens, void* out, int batch, int hkv, int g, int d, int b, int mb,
    float scale, void* stream) {
  return zp_decode_launch<zp_bf16>(kChunkKernelsBf16,
                                   ragged_paged_attention_merge_kernel<zp_bf16>, q, k_pool,
                                   v_pool, block_tables, seq_lens, out, batch, hkv, g, d, b, mb,
                                   scale, stream);
}

// ... or in fp16 (the same, the output rounded once to fp16).
extern "C" int ragged_paged_attention_launch_f16(
    const void* q, const void* k_pool, const void* v_pool, const void* block_tables,
    const void* seq_lens, void* out, int batch, int hkv, int g, int d, int b, int mb,
    float scale, void* stream) {
  return zp_decode_launch<zp_f16>(kChunkKernelsF16, ragged_paged_attention_merge_kernel<zp_f16>,
                                  q, k_pool, v_pool, block_tables, seq_lens, out, batch, hkv,
                                  g, d, b, mb, scale, stream);
}
