// Dense paged decode attention: one query token per slot against its paged
// KV cache, GQA, online softmax over every entry of the slot's block table.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::paged_attention.
// That kernel's grid (B, h_kv, max_blocks) visits every table entry of
// every slot: a -1 entry is clamped to page 0 and its page is DMA'd and
// masked. It is the baseline the ragged kernel (ragged_paged_attention.cu)
// is measured against, so this kernel does the baseline's work: it walks
// all max_blocks entries of every slot, and a -1 entry loads the clamped
// page 0 all the same. Positions at or past seq_len have their scores
// masked to -1e30 and their V lanes read as zeros before p.V, so a NaN
// page 0 or a stale tail past seq_len cannot reach the output; a -1 entry
// below seq_len is page 0, unmasked, as in the TPU kernel. Rows with
// seq_len == 0 come out as zeros, as in the JAX package's
// paged.paged_decode_attention.
//
// The design (common.cuh, "Decode attention in chunks", shared with the
// ragged kernel so that live rows are bit-identical): the table is cut
// into chunks; a block per (chunk, kv head, slot) walks its chunk in tiles
// of 16 positions through a three-stage cp.async ring, four warps each
// taking four rows of a tile with shuffle reductions for the scores and
// the per-head max and sum; paged_attention_merge_kernel merges the
// warps' parts in a fixed order.
//
// What bounds it on the card: memory. The function needs only the live
// pages (2 * seq_len * d * 4 bytes per kv head in fp32, half that in bf16:
// the bound PERF.md counts); the kernel also rereads page 0 for every dead entry, from L2, and its
// flops (4 * g per K/V element pair) stay far below the H100's ridge
// point. What holds it back: it runs the math of every dead tile and
// reads its page, as the baseline does (three quarters of the tiles at
// chip_smoke.py's long decode input), and a tile's math and the issue of
// its copies are chains of dependent shared loads, shuffles and exps that
// four blocks an SM (the ring's 48 KB of shared memory a block at
// d = 128) do not hide; the loads themselves arrive in time. PERF.md has
// the numbers.
#include "common.cuh"

namespace {

template <int G, int DPL, typename T>
__global__ void __launch_bounds__(kDecodeThreads) paged_attention_chunk_kernel(ZpDecodeArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  zp_decode_chunk<G, DPL, true, T>(a, smem);
}

// Every chunk is merged; a chunk with no live entry has only parts with
// m == -1e30, which the merge skips.
template <typename T>
__global__ void __launch_bounds__(kDecodeThreads) paged_attention_merge_kernel(ZpDecodeArgs<T> a) {
  zp_decode_merge(a, a.n_chunks);
}

const ZpDecodeChunkKernel<float> kChunkKernels[kDecodeTableG][2] =
    ZP_DECODE_TABLE(paged_attention_chunk_kernel, float);
const ZpDecodeChunkKernel<zp_bf16> kChunkKernelsBf16[kDecodeTableG][2] =
    ZP_DECODE_TABLE(paged_attention_chunk_kernel, zp_bf16);
const ZpDecodeChunkKernel<zp_f16> kChunkKernelsF16[kDecodeTableG][2] =
    ZP_DECODE_TABLE(paged_attention_chunk_kernel, zp_f16);
}  // namespace

// Floats of workspace (the chunks' fp32 parts) a launch needs after its
// output (zp_decode_out_bytes()), at either storage type.
extern "C" long long paged_attention_workspace(int batch, int hkv, int g, int d, int b,
                                               int mb) {
  return zp_decode_workspace(batch, hkv, g, d, b, mb);
}

// q, the pools and the output in float ...
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* block_tables,
    const void* seq_lens, void* out, int batch, int hkv, int g, int d, int b, int mb,
    float scale, void* stream) {
  return zp_decode_launch<float>(kChunkKernels, paged_attention_merge_kernel<float>, q, k_pool,
                                 v_pool, block_tables, seq_lens, out, batch, hkv, g, d, b, mb,
                                 scale, stream);
}

// ... or in bf16 (the math in fp32 all the same, the output rounded once).
extern "C" int paged_attention_launch_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* block_tables,
    const void* seq_lens, void* out, int batch, int hkv, int g, int d, int b, int mb,
    float scale, void* stream) {
  return zp_decode_launch<zp_bf16>(kChunkKernelsBf16, paged_attention_merge_kernel<zp_bf16>, q,
                                   k_pool, v_pool, block_tables, seq_lens, out, batch, hkv, g,
                                   d, b, mb, scale, stream);
}

// ... or in fp16 (the same, the output rounded once to fp16).
extern "C" int paged_attention_launch_f16(
    const void* q, const void* k_pool, const void* v_pool, const void* block_tables,
    const void* seq_lens, void* out, int batch, int hkv, int g, int d, int b, int mb,
    float scale, void* stream) {
  return zp_decode_launch<zp_f16>(kChunkKernelsF16, paged_attention_merge_kernel<zp_f16>,
                                  q, k_pool, v_pool, block_tables, seq_lens, out, batch, hkv,
                                  g, d, b, mb, scale, stream);
}
