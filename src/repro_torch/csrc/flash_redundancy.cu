// Flash key redundancy (paper Alg. 3): full-sequence cosine similarity.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/redundancy.py::flash_redundancy.
// For each request and kv head it L2-normalises the keys (eps 1e-12), forms
// the T x T cosine matrix, zeroes the diagonal and every row or column at a
// position >= seq_len, zeroes per column the last (newest) row whose
// similarity exceeds p_thresh, and writes the row sums divided by
// max(seq_len, 1). Output (n, max_blocks * b, h), float32, from fp32 or bf16
// keys (staged in their type, widened to fp32 as they are read).
//
// What bounds it on the card: operations, on fp32 CUDA cores (TF32 is off
// by the port's parity rule); the bytes are the live keys once. The cosine
// matrix is symmetric, so L live keys need L (L - 1) / 2 distinct products
// of 2 * d flops per (request, head): at seq_lens 2048 and 1999, d = 128
// and 8 heads that is 8.4 GFLOP against 17 MB. This design forms both
// halves of the matrix, twice that work.
//
// The TPU kernel runs a grid (n, h, m) whose column-block axis m is
// sequential: it carries a per-column "already zeroed" tag down the row
// blocks i = N-1..0 of one m and sums every (i, m) tile into one output
// tile that m revisits. The tag looks only down its own column, so column
// strips are independent. The design spreads them over the card:
//
//   * one thread block per (strip of 64 columns, head, request); the
//     strip's keys are loaded once and stay in shared memory, with their
//     norms;
//   * the block walks row tiles of 64 keys newest to oldest, each staged by
//     16-byte cp.async into a double buffer while the previous tile is
//     computed (the tile that holds the strip's own keys is not loaded
//     again); a row's norm is taken from the staged tile by the 16
//     threads that share the row, and each product is multiplied by the
//     inverse norms of its row and column;
//   * each thread owns a 4 x 4 micro-tile and forms it with fp32 FMAs from
//     registers, loaded as 16-byte vectors from shared memory;
//   * the newest row above p_thresh per column of a tile is an integer
//     atomicMax on a row index in shared memory (an integer max does not
//     depend on order), and the per-column tag is carried to the next tile
//     in shared memory. Two barriers per 64 x 64 x d tile;
//   * each tile's row sums over the strip's columns are summed in a fixed
//     order (micro-tile columns, then a shuffle tree over 16 lanes) and
//     written as the strip's partial row sums; a second kernel adds the
//     partials of the live strips in ascending strip order. When the table
//     is one strip wide (T <= 64, the serve's compressions) the strip
//     kernel writes the output itself and the second kernel is not run.
//
// No float atomics: every sum is taken in the same order in every run, so
// two launches give the same bits (top-k margins are about 1e-5).
//
// What still holds it back: at long tables the products are bound by
// shared memory rather than by the FMA units (each 4 x 4 micro-tile step
// spends 8 16-byte shared loads, 4 of them over 16 distinct rows, on 64
// FMAs), and each tile's epilogue (norms, tag, row sums, two barriers)
// runs between products; every strip also reads all row tiles from L2; and
// every product is formed twice, once for each half of the matrix (a tile
// and its mirror could share one set of products: the next lever). At the
// serve's T = 64 there are only n * h blocks (16), so the time is one
// block's chain of table, copy and products. PERF.md has the numbers.
//
// Rows and columns at or past seq_len, and positions on a -1 table entry,
// are zero-filled by the copy without reading the pool, so stale or NaN
// pool data cannot reach an output; row tiles past seq_len are not visited
// (their entries are zeros, which no p_thresh >= 0 exceeds; for a negative
// p_thresh the newest such row would take every column's zero-out, so a
// valid entry is never zeroed, and the tag starts set).
//
// Tiles of 64 keys need 3 x 64 x (d + pad) elements of shared memory:
// ~200 KB at d = 256 in fp32 and at d = 512 in bf16. Where they do not fit
// (d = 512 in fp32, MLA's latent: ~396 KB) the same kernel runs on tiles of
// 32 keys, each thread a 2 x 2 micro-tile (~198 KB); the sums then run in
// another order, within the plain version's tolerance.
//
// Memory: `out` is the start of one buffer that flash_redundancy_cuda
// allocates: n * T * h floats of output, then flash_redundancy_workspace()
// floats for the strips' partial row sums (none when the table is one
// strip wide), so the strip width is decided here alone.
#include "common.cuh"

namespace {
constexpr int kThreads = 256;  // 16 x 16 threads, each R x R entries of a 16R x 16R tile

// R: rows (and columns) of a thread's micro-tile; tiles are 16 R keys a
// side. E: the keys' storage type.
template <int R, typename E>
__global__ void __launch_bounds__(kThreads, 2)
flash_redundancy_strip_kernel(const E* __restrict__ k_pool,          // (N, b, h, d)
                              const int* __restrict__ block_tables,  // (n, mb)
                              const int* __restrict__ seq_lens,      // (n,)
                              float* __restrict__ out,               // (n, T, h)
                              float* __restrict__ part,  // (n, h, n_strips, T), or null
                              int h, int d, int b, int mb, float p_thresh) {
  constexpr int kTile = 16 * R;
  extern __shared__ __align__(16) float smem[];
  const int ld = d + kKeyPadOf<E>;
  const int T = mb * b;
  const int n_strips = gridDim.x;
  const int J = blockIdx.x;
  const int hh = blockIdx.y;
  const int ib = blockIdx.z;
  const int tid = threadIdx.x;
  const int L = min(max(seq_lens[ib], 0), T);
  const int c0 = J * kTile;
  if (c0 >= L) {  // a dead strip adds nothing; a lone strip still writes zeros
    if (part == nullptr)
      for (int t = tid; t < T; t += blockDim.x) out[((size_t)ib * T + t) * h + hh] = 0.f;
    return;
  }
  E* col_s = reinterpret_cast<E*>(smem);           // kTile x ld: the strip's keys
  E* row_s = col_s + kTile * ld;                   // 2 x kTile x ld: row tiles
  float* cinv_s = reinterpret_cast<float*>(row_s + 2 * kTile * ld);  // kTile: 1 / norms
  int* win_s = (int*)(cinv_s + kTile);             // 2 x kTile: newest row above p
  int* done_s = win_s + 2 * kTile;                 // 2 x kTile: zeroed in a newer tile
  const int* bt = block_tables + (size_t)ib * mb;
  const int ty = tid >> 4;  // rows ty + 16 r of a tile
  const int tx = tid & 15;  // columns tx + 16 c of the strip
  const int n_tiles = (L + kTile - 1) / kTile;

  const int tag0 = p_thresh < 0.f && L < T;
  for (int c = tid; c < 2 * kTile; c += blockDim.x) {
    win_s[c] = -1;
    done_s[c] = tag0;
  }
  zp_load_key_tile(col_s, k_pool, bt, c0, L, h, hh, d, b, kTile);
  zp_cp_async_commit();
  if (n_tiles - 1 != J)  // row tile J holds the strip's own keys: not loaded twice
    zp_load_key_tile(row_s, k_pool, bt, (n_tiles - 1) * kTile, L, h, hh, d, b, kTile);
  zp_cp_async_commit();   // (maybe empty) group of the first row tile
  zp_cp_async_wait<1>();  // the strip has landed (the first row tile may not have)
  __syncthreads();
  if (tid < kTile) {  // the strip's inverse key norms: a thread per key
    const E* x = col_s + tid * ld;
    float ss = 0.f;
    for (int k = 0; k < d; k += 4) {
      const float4 v = zp_load4(x + k);
      ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
    cinv_s[tid] = 1.f / fmaxf(sqrtf(ss), 1e-12f);
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int I = n_tiles - 1 - it;  // newest row tile first
    const int cur = it & 1;
    const E* rt = I == J ? col_s : row_s + cur * kTile * ld;
    zp_cp_async_wait<0>();
    __syncthreads();  // (A) tile I has landed, the norms are in, the other buffer is free
    if (I > 0 && I - 1 != J) {
      zp_load_key_tile(row_s + (cur ^ 1) * kTile * ld, k_pool, bt, (I - 1) * kTile, L, h, hh,
                       d, b, kTile);
      zp_cp_async_commit();
    }
    float acc[R][R];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) acc[r][c] = 0.f;
    for (int k = 0; k < d; k += 4) {
      float4 a[R], q[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = zp_load4(rt + (ty + 16 * r) * ld + k);
#pragma unroll
      for (int c = 0; c < R; ++c) q[c] = zp_load4(col_s + (tx + 16 * c) * ld + k);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) {
          float s = acc[r][c];
          s = fmaf(a[r].x, q[c].x, s);
          s = fmaf(a[r].y, q[c].y, s);
          s = fmaf(a[r].z, q[c].z, s);
          s = fmaf(a[r].w, q[c].w, s);
          acc[r][c] = s;
        }
    }
    // the rows' norms: the 16 lanes that share a row each take d / 16 squares
    float rinv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const E* x = rt + (ty + 16 * r) * ld;
      float ss = 0.f;
      for (int k = 4 * tx; k < d; k += 64) {
        const float4 v = zp_load4(x + k);
        ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
      rinv[r] = 1.f / fmaxf(sqrtf(ss), 1e-12f);
    }
    const int r0 = I * kTile;
    float cinv[R];
#pragma unroll
    for (int c = 0; c < R; ++c) cinv[c] = cinv_s[tx + 16 * c];
    int* win = win_s + cur * kTile;
    const int* done = done_s + cur * kTile;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int gi = r0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int gj = c0 + tx + 16 * c;
        acc[r][c] = gi < L && gj < L && gi != gj ? acc[r][c] * rinv[r] * cinv[c] : 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < R; ++c) {  // the newest row of this tile above p, per column
      const int cl = tx + 16 * c;
      if (done[cl]) continue;
      int newest = -1;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r0 + ty + 16 * r < T && acc[r][c] > p_thresh) newest = ty + 16 * r;
      if (newest >= 0) atomicMax(&win[cl], newest);
    }
    __syncthreads();  // (B) win is complete
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int rl = ty + 16 * r;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < R; ++c) s += win[tx + 16 * c] == rl ? 0.f : acc[r][c];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      const int gi = r0 + rl;
      if (tx == 0 && gi < T) {
        if (part == nullptr)
          out[((size_t)ib * T + gi) * h + hh] = s / (float)max(L, 1);
        else if (gi < L)
          part[(((size_t)ib * h + hh) * n_strips + J) * T + gi] = s;
      }
    }
    if (ty == 0) {  // carry the tags to the next tile; reset the other win
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int cl = tx + 16 * c;
        done_s[(cur ^ 1) * kTile + cl] = done[cl] | (win[cl] >= 0);
        win_s[(cur ^ 1) * kTile + cl] = -1;
      }
    }
  }
}

// out[ib, t, hh] = the sum of the live strips' partials of row t, in
// ascending strip order, over max(seq_len, 1); rows at or past seq_len 0.
__global__ void flash_redundancy_reduce_kernel(const float* __restrict__ part,
                                               const int* __restrict__ seq_lens,
                                               float* __restrict__ out, int h, int T,
                                               int n_strips, int tile, int total) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int t = idx % T;
  const int hh = (idx / T) % h;
  const int ib = idx / (T * h);
  const int L = min(max(seq_lens[ib], 0), T);
  float s = 0.f;
  if (t < L) {
    const float* p = part + ((size_t)ib * h + hh) * n_strips * T + t;
    const int live = (L + tile - 1) / tile;
    for (int J = 0; J < live; ++J) s += p[(size_t)J * T];
    s = s / (float)L;
  }
  out[((size_t)ib * T + t) * h + hh] = s;
}

// Shared memory of a strip block with tiles of 16 R keys.
template <int R, typename E>
size_t strip_smem(int d) {
  return sizeof(E) * 3 * 16 * R * (size_t)(d + kKeyPadOf<E>) + sizeof(float) * 16 * R +
         sizeof(int) * 4 * 16 * R;
}

int g_smem_optin = 0;  // the most shared memory a block may opt in to

// The tile side a launch takes: 64 keys where three 64-key tiles fit
// shared memory, else 32 (d = 512 in fp32: MLA's latent); 0 if neither.
template <typename E>
int strip_tile(int d) {
  if (g_smem_optin == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&g_smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess)
      return 0;
  }
  if (strip_smem<4, E>(d) <= (size_t)g_smem_optin) return 64;
  if (strip_smem<2, E>(d) <= (size_t)g_smem_optin) return 32;
  return 0;
}
}  // namespace

// Floats of scratch that a launch needs after its n * T * h outputs: the
// strips' partial row sums, n * h * ceil(T / tile) * T of them, or none
// when the table is one strip wide. The tile follows d and the keys'
// element size (esize bytes) alone: strip_smem<R, E> reads E only through
// sizeof(E) and kKeyPadOf<E> (16 bytes of padding), so bf16 and fp16 keys
// take the same tile, and strip_tile<zp_bf16> stands for both.
extern "C" long long flash_redundancy_workspace(int n, int h, int d, int b, int mb, int esize) {
  static_assert(sizeof(zp_bf16) == sizeof(zp_f16) && kKeyPadOf<zp_bf16> == kKeyPadOf<zp_f16>,
                "the 16-bit types share the strip tile");
  const int tile = esize == 2 ? strip_tile<zp_bf16>(d) : strip_tile<float>(d);
  if (tile == 0) return 0;
  const long long T = (long long)mb * b;
  const long long n_strips = (T + tile - 1) / tile;
  return n_strips > 1 ? (long long)n * h * n_strips * T : 0;
}

namespace {
template <int R, typename E>
int launch_tiles(const void* k_pool, const void* block_tables, const void* seq_lens, void* out,
                 int n, int h, int d, int b, int mb, float p_thresh, cudaStream_t s) {
  constexpr int kTile = 16 * R;
  const int T = mb * b;
  const int n_strips = (T + kTile - 1) / kTile;
  const size_t smem = strip_smem<R, E>(d);
  cudaError_t err = zp_allow_smem(flash_redundancy_strip_kernel<R, E>, smem);
  if (err != cudaSuccess) return (int)err;
  float* o = (float*)out;
  float* part = n_strips > 1 ? o + (size_t)n * T * h : nullptr;
  flash_redundancy_strip_kernel<R, E><<<dim3(n_strips, h, n), kThreads, smem, s>>>(
      (const E*)k_pool, (const int*)block_tables, (const int*)seq_lens, o, part, h, d, b, mb,
      p_thresh);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return (int)err;
  const int total = n * h * T;
  flash_redundancy_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      part, (const int*)seq_lens, o, h, T, n_strips, kTile, total);
  return (int)cudaGetLastError();
}

template <typename E>
int launch(const void* k_pool, const void* block_tables, const void* seq_lens, void* out, int n,
           int h, int d, int b, int mb, float p_thresh, void* stream) {
  if (d % kVecOf<E> != 0) return (int)cudaErrorInvalidValue;
  const int tile = strip_tile<E>(d);
  cudaStream_t s = (cudaStream_t)stream;
  if (tile == 64)
    return launch_tiles<4, E>(k_pool, block_tables, seq_lens, out, n, h, d, b, mb, p_thresh, s);
  if (tile == 32)
    return launch_tiles<2, E>(k_pool, block_tables, seq_lens, out, n, h, d, b, mb, p_thresh, s);
  return (int)cudaErrorInvalidValue;
}
}  // namespace

// keys in float ...
extern "C" int flash_redundancy_launch(const void* k_pool, const void* block_tables,
                                       const void* seq_lens, void* out, int n, int h, int d,
                                       int b, int mb, float p_thresh, void* stream) {
  return launch<float>(k_pool, block_tables, seq_lens, out, n, h, d, b, mb, p_thresh, stream);
}

// ... or in bf16 (staged in bf16, widened to fp32 as they are read); the
// output is fp32.
extern "C" int flash_redundancy_launch_bf16(const void* k_pool, const void* block_tables,
                                            const void* seq_lens, void* out, int n, int h, int d,
                                            int b, int mb, float p_thresh, void* stream) {
  return launch<zp_bf16>(k_pool, block_tables, seq_lens, out, n, h, d, b, mb, p_thresh, stream);
}

// ... or in fp16 (staged in fp16, widened to fp32 as they are read); the
// output is fp32.
extern "C" int flash_redundancy_launch_f16(const void* k_pool, const void* block_tables,
                                           const void* seq_lens, void* out, int n, int h, int d,
                                           int b, int mb, float p_thresh, void* stream) {
  return launch<zp_f16>(k_pool, block_tables, seq_lens, out, n, h, d, b, mb, p_thresh, stream);
}
