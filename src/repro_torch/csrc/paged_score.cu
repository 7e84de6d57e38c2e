// Observation-window attention logits over paged keys (paper Alg. 1).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_score.py::paged_score_logits.
// It computes, per request and kv head, the logits Q_win . K^T * scale
// (scale = 1/sqrt(d), or 1/sqrt(head_dim + rope dim) for MLA's latent
// entries, which are d = 576 wide at h_kv = 1, g = 16) of the g*w window
// queries that share the kv head against every cache
// position, with the causal mask kpos <= seq_len - w + u and the validity
// mask kpos < seq_len; masked entries are -1e30. Output layout is the TPU
// kernel's: (n, h_kv, g, w, max_blocks * b), float32, from fp32 or bf16
// queries and keys (common.cuh: staged in their type, multiplied in fp32).
//
// What bounds it on the card: memory. Each live key element is read once
// and each output written once; g*w = 16 query rows give 32 flops per key
// element, under the H100's ridge point but not far enough under it for
// the products to be free: at T = 2048 they are a third of the byte time.
//
// The design:
//   * one thread block per (request, kv head, tile of key positions); the
//     block loads the query tile and its key tile by 16-byte cp.async;
//   * the tile width follows the grid: when tiles of 16 positions give at
//     most four blocks per SM (the serve's compressions: 2 requests x 8
//     heads x 4 tiles), a block takes a tile of 16, so the copies spread
//     over as many SMs as possible; otherwise a tile of 64;
//   * each thread owns a 2 x C micro-tile of a 16-row pass (rows ty + 8 r,
//     positions tx + 16 c) and forms it with fp32 FMAs from registers,
//     loaded as 16-byte vectors from shared memory with a padded stride;
//   * where whole rows do not fit shared memory (d > 256, as MLA's 576,
//     or g*w rows too many), d is tiled instead: a pass of 16 query rows
//     stages chunks of 128 elements of its rows and of the key tile and
//     accumulates into the same registers in the same order, so both
//     paths give the same bits;
//   * tiles wholly at or past seq_len are written as -1e30 with 16-byte
//     stores, without reading their table entries, so -1 padding is never
//     dereferenced; positions past seq_len and on a -1 entry of a live tile
//     are zero-filled by the copy and masked, so stale or NaN pool data
//     cannot reach an output.
//
// What still holds it back: a block is one chain of table, copy, products
// and stores, so copies and products overlap only across blocks, and the
// products are bound by shared memory (6 16-byte loads, 4 of them over 16
// distinct rows, feed 32 FMAs). PERF.md has the numbers.
#include "common.cuh"

namespace {
constexpr int kThreads = 128;  // 8 x 16 threads
// Whole rows of the queries and the key tile are staged when d is at most
// this and they fit shared memory; otherwise d is tiled (kDChunk).
constexpr int kWholeRowMaxD = 256;
constexpr int kDChunk = 128;   // elements of d a d-tiled stage holds

// A tile wholly at or past seq_len: fully masked, nothing read.
__device__ __forceinline__ void masked_tile(float* o, int rows, int T, int t0, int tile) {
  const int width = min(tile, T - t0);
  if ((T & 3) == 0) {  // rows and tiles start 16-byte aligned, width is a multiple of 4
    const int w4 = width >> 2;
    const float4 neg = make_float4(ZP_NEG_INF, ZP_NEG_INF, ZP_NEG_INF, ZP_NEG_INF);
    for (int idx = threadIdx.x; idx < rows * w4; idx += blockDim.x) {
      const int r = idx / w4;
      *reinterpret_cast<float4*>(o + (size_t)r * T + t0 + 4 * (idx - r * w4)) = neg;
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * width; idx += blockDim.x) {
      const int r = idx / width;
      o[(size_t)r * T + t0 + (idx - r * width)] = ZP_NEG_INF;
    }
  }
}

// The 2 x C micro-tile of a pass of 16 query rows starting at r0: its
// logits, or -1e30 where masked.
template <int C>
__device__ __forceinline__ void store_pass(float* o, const float (&acc)[2][C], const int (&page)[C],
                                           int r0, int ty, int tx, int t0, int rows, int w, int T,
                                           int seq_len, float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + ty + 8 * r;
    if (row >= rows) continue;
    const int u = row % w;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int kpos = t0 + tx + 16 * c;
      if (kpos >= T) continue;
      const bool keep = kpos <= seq_len - w + u && page[c] >= 0;  // page >= 0: kpos < seq_len
      o[(size_t)row * T + kpos] = keep ? acc[r][c] * scale : ZP_NEG_INF;
    }
  }
}

// acc[r][c] += q row (ty + 8 r) . key row (tx + 16 c) over `cols` elements
// staged at row stride ld, in the order k = 0, 4, 8, ... (the same order
// whether d is staged whole or in chunks, so both give the same bits).
template <int C, typename E>
__device__ __forceinline__ void accumulate(float (&acc)[2][C], const E* q_s, const E* k_s, int ld,
                                           int cols, int ty, int tx) {
  for (int k = 0; k < cols; k += 4) {
    float4 a[2], kv[C];
#pragma unroll
    for (int r = 0; r < 2; ++r) a[r] = zp_load4(q_s + (ty + 8 * r) * ld + k);
#pragma unroll
    for (int c = 0; c < C; ++c) kv[c] = zp_load4(k_s + (tx + 16 * c) * ld + k);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float s = acc[r][c];
        s = fmaf(a[r].x, kv[c].x, s);
        s = fmaf(a[r].y, kv[c].y, s);
        s = fmaf(a[r].z, kv[c].z, s);
        s = fmaf(a[r].w, kv[c].w, s);
        acc[r][c] = s;
      }
  }
}

// A thread owns a 2 x C micro-tile of a pass of 16 query rows by a tile of
// 16 * C positions: rows ty + 8 r, positions tx + 16 c, with tx = tid % 16
// and ty = tid / 16.
template <int C, typename E>  // E: the storage type of q_win and the keys
__global__ void __launch_bounds__(kThreads)
paged_score_kernel(const E* __restrict__ q_win,             // (n, w, hq, d)
                   const E* __restrict__ k_pool,            // (N, b, hkv, d)
                   const int* __restrict__ block_tables,    // (n, mb)
                   const int* __restrict__ seq_lens,        // (n,)
                   float* __restrict__ out,                 // (n, hkv, g*w, mb*b)
                   int hkv, int g, int w, int d, int b, int mb, float scale) {
  constexpr int kTile = 16 * C;
  constexpr int V = kVecOf<E>;
  extern __shared__ __align__(16) float smem[];
  const int ld = d + kKeyPadOf<E>;
  const int rows = g * w;                    // row r = gi * w + u
  const int rows16 = (rows + 15) & ~15;
  E* q_s = reinterpret_cast<E*>(smem);       // rows16 x ld
  E* k_s = q_s + rows16 * ld;                // kTile x ld

  const int h = blockIdx.y;
  const int ib = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty + 8 r of a pass
  const int tx = tid & 15;  // positions tx + 16 c of the tile
  const int hq = hkv * g;
  const int T = mb * b;
  const int seq_len = seq_lens[ib];
  const int live1 = max(0, min(seq_len, T));  // last live position + 1
  const int t0 = blockIdx.x * kTile;
  const int* bt = block_tables + (size_t)ib * mb;
  float* o = out + ((size_t)ib * hkv + h) * rows * (size_t)T;

  if (t0 >= live1) {
    masked_tile(o, rows, T, t0, kTile);
    return;
  }

  const int d4 = d / V;  // 16-byte columns a row
  for (int idx = tid; idx < rows16 * d4; idx += blockDim.x) {
    const int r = idx / d4;
    const int c4 = idx - r * d4;
    const int gi = r / w;
    const bool ok = r < rows;
    const E* src =
        ok ? q_win + (((size_t)ib * w + (r - gi * w)) * hq + (size_t)h * g + gi) * d + V * c4
           : q_win;
    zp_cp_async16(q_s + r * ld + V * c4, src, ok);
  }
  zp_load_key_tile(k_s, k_pool, bt, t0, live1, hkv, h, d, b, kTile);
  zp_cp_async_commit();
  int page[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int kpos = t0 + tx + 16 * c;
    page[c] = kpos < live1 ? bt[kpos / b] : -1;
  }
  zp_cp_async_wait<0>();
  __syncthreads();  // the queries and the key tile have landed

  for (int r0 = 0; r0 < rows16; r0 += 16) {
    float acc[2][C];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
    accumulate<C>(acc, q_s + r0 * ld, k_s, ld, d, ty, tx);
    store_pass<C>(o, acc, page, r0, ty, tx, t0, rows, w, T, seq_len, scale);
  }
}

// The same logits with d tiled: for wide rows (MLA's 576-wide latent
// entries) or many window rows (g = 16 heads at w = 16), whose whole rows
// would not fit shared memory. A pass of 16 query rows walks d in chunks
// of kDChunk: each chunk of the 16 rows and of the key tile is staged by
// 16-byte cp.async and multiplied into the pass's registers, so shared
// memory is (16 + 16 C) x (kDChunk + pad) elements at any d and window.
// The key tile is read once a pass (from L2 after the first).
template <int C, typename E>
__global__ void __launch_bounds__(kThreads)
paged_score_dtiled_kernel(const E* __restrict__ q_win,           // (n, w, hq, d)
                          const E* __restrict__ k_pool,          // (N, b, hkv, d)
                          const int* __restrict__ block_tables,  // (n, mb)
                          const int* __restrict__ seq_lens,      // (n,)
                          float* __restrict__ out,               // (n, hkv, g*w, mb*b)
                          int hkv, int g, int w, int d, int b, int mb, float scale) {
  constexpr int kTile = 16 * C;
  constexpr int V = kVecOf<E>;
  constexpr int ld = kDChunk + kKeyPadOf<E>;
  extern __shared__ __align__(16) float smem[];
  E* q_s = reinterpret_cast<E*>(smem);  // 16 x ld
  E* k_s = q_s + 16 * ld;               // kTile x ld

  const int h = blockIdx.y;
  const int ib = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int hq = hkv * g;
  const int rows = g * w;
  const int rows16 = (rows + 15) & ~15;
  const int T = mb * b;
  const int seq_len = seq_lens[ib];
  const int live1 = max(0, min(seq_len, T));
  const int t0 = blockIdx.x * kTile;
  const int* bt = block_tables + (size_t)ib * mb;
  float* o = out + ((size_t)ib * hkv + h) * rows * (size_t)T;

  if (t0 >= live1) {
    masked_tile(o, rows, T, t0, kTile);
    return;
  }
  int page[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int kpos = t0 + tx + 16 * c;
    page[c] = kpos < live1 ? bt[kpos / b] : -1;
  }
  const int shift = (b & (b - 1)) == 0 ? __ffs(b) - 1 : -1;

  for (int r0 = 0; r0 < rows16; r0 += 16) {
    float acc[2][C];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
    for (int c0 = 0; c0 < d; c0 += kDChunk) {
      const int n4 = min(kDChunk, d - c0) / V;  // 16-byte columns of the chunk
      for (int idx = tid; idx < 16 * n4; idx += blockDim.x) {
        const int rr = idx / n4;
        const int c4 = idx - rr * n4;
        const int r = r0 + rr;
        const bool ok = r < rows;
        const int gi = r / w;
        const E* src = ok ? q_win + (((size_t)ib * w + (r - gi * w)) * hq + (size_t)h * g + gi) * d +
                                c0 + V * c4
                          : q_win;
        zp_cp_async16(q_s + rr * ld + V * c4, src, ok);
      }
      for (int idx = tid; idx < kTile * n4; idx += blockDim.x) {
        const int t = idx / n4;
        const int c4 = idx - t * n4;
        const int pos = t0 + t;
        const int blk = shift >= 0 ? pos >> shift : pos / b;
        const int pg = pos < live1 ? bt[blk] : -1;
        const E* src =
            pg >= 0 ? k_pool + (((size_t)pg * b + (pos - blk * b)) * hkv + h) * d + c0 + V * c4
                    : k_pool;
        zp_cp_async16(k_s + t * ld + V * c4, src, pg >= 0);
      }
      zp_cp_async_commit();
      zp_cp_async_wait<0>();
      __syncthreads();  // the chunk has landed
      accumulate<C>(acc, q_s, k_s, ld, n4 * V, ty, tx);
      __syncthreads();  // the chunk is read: its buffers may be refilled
    }
    store_pass<C>(o, acc, page, r0, ty, tx, t0, rows, w, T, seq_len, scale);
  }
}

int g_sm_count = 0;  // the card's SM count, read once

int g_smem_optin = 0;  // the most shared memory a block may opt in to

template <int C, typename T>
cudaError_t launch(const void* q_win, const void* k_pool, const void* block_tables,
                   const void* seq_lens, void* out, int n, int hkv, int g, int w, int d, int b,
                   int mb, float scale, cudaStream_t stream) {
  constexpr int kTile = 16 * C;
  const int n_tiles = (mb * b + kTile - 1) / kTile;
  const int rows16 = (g * w + 15) & ~15;
  const dim3 grid(n_tiles, hkv, n);
  const size_t whole = sizeof(T) * ((size_t)rows16 + kTile) * (d + kKeyPadOf<T>);
  if (d <= kWholeRowMaxD && whole <= (size_t)g_smem_optin) {
    cudaError_t err = zp_allow_smem(paged_score_kernel<C, T>, whole);
    if (err != cudaSuccess) return err;
    paged_score_kernel<C, T><<<grid, kThreads, whole, stream>>>(
        (const T*)q_win, (const T*)k_pool, (const int*)block_tables, (const int*)seq_lens,
        (float*)out, hkv, g, w, d, b, mb, scale);
    return cudaGetLastError();
  }
  const size_t tiled = sizeof(T) * (16 + (size_t)kTile) * (kDChunk + kKeyPadOf<T>);
  cudaError_t err = zp_allow_smem(paged_score_dtiled_kernel<C, T>, tiled);
  if (err != cudaSuccess) return err;
  paged_score_dtiled_kernel<C, T><<<grid, kThreads, tiled, stream>>>(
      (const T*)q_win, (const T*)k_pool, (const int*)block_tables, (const int*)seq_lens,
      (float*)out, hkv, g, w, d, b, mb, scale);
  return cudaGetLastError();
}

// q_win and the pool in T; the logits in fp32. Rows of d elements must
// take 16-byte copies.
template <typename T>
int launch_any(const void* q_win, const void* k_pool, const void* block_tables,
               const void* seq_lens, void* out, int n, int hkv, int g, int w, int d, int b,
               int mb, float scale, void* stream) {
  if (d % kVecOf<T> != 0) return (int)cudaErrorInvalidValue;
  if (g_sm_count == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&g_smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&g_sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  // Small grids (the serve's compressions): a block per tile of 16
  // positions, so the copies spread over as many SMs as there are tiles;
  // otherwise a block per tile of 64 positions.
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)n * hkv * ((mb * b + 15) / 16) <= 4LL * g_sm_count)
    return (int)launch<1, T>(q_win, k_pool, block_tables, seq_lens, out, n, hkv, g, w, d, b, mb,
                             scale, s);
  return (int)launch<4, T>(q_win, k_pool, block_tables, seq_lens, out, n, hkv, g, w, d, b, mb,
                           scale, s);
}
}  // namespace

extern "C" int paged_score_launch(const void* q_win, const void* k_pool,
                                  const void* block_tables, const void* seq_lens, void* out,
                                  int n, int hkv, int g, int w, int d, int b, int mb,
                                  float scale, void* stream) {
  return launch_any<float>(q_win, k_pool, block_tables, seq_lens, out, n, hkv, g, w, d, b, mb,
                           scale, stream);
}

extern "C" int paged_score_launch_bf16(const void* q_win, const void* k_pool,
                                       const void* block_tables, const void* seq_lens,
                                       void* out, int n, int hkv, int g, int w, int d, int b,
                                       int mb, float scale, void* stream) {
  return launch_any<zp_bf16>(q_win, k_pool, block_tables, seq_lens, out, n, hkv, g, w, d, b,
                             mb, scale, stream);
}

// ... or in fp16 (widened to fp32 as they are read); the logits are fp32.
extern "C" int paged_score_launch_f16(const void* q_win, const void* k_pool,
                                      const void* block_tables, const void* seq_lens,
                                      void* out, int n, int hkv, int g, int w, int d, int b,
                                      int mb, float scale, void* stream) {
  return launch_any<zp_f16>(q_win, k_pool, block_tables, seq_lens, out, n, hkv, g, w, d, b, mb,
                            scale, stream);
}
