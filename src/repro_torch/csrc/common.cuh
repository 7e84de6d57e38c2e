// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel is a template on the storage type T of its key, value and
// query tensors: float, __nv_bfloat16 (zp_bf16) or __half (zp_f16). Tiles
// are staged in T, by the same 16-byte copies (4 floats or 8 16-bit
// elements), and widened to fp32 when read into registers: every product,
// sum and softmax runs in fp32 whatever T is, and a 16-bit output is
// rounded once, when it is written. Scores (window logits, redundancy, F)
// are fp32 at any T.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

using zp_bf16 = __nv_bfloat16;
using zp_f16 = __half;

// Elements of T in one 16-byte copy; rows of T must hold a whole number of
// them (d % kVecOf<T> == 0) to be copied by 16-byte cp.async.
template <typename T>
constexpr int kVecOf = 16 / (int)sizeof(T);

// Four consecutive elements widened to fp32 (16-byte aligned for float,
// 8-byte for the 16-bit types); the widening is exact.
__device__ __forceinline__ float4 zp_load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 zp_load4(const zp_bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 zp_load4(const zp_f16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// An fp32 result stored as T: rounded to nearest even for the 16-bit types
// (fp16 overflows to +-inf past 65504, as a rounding cast does).
__device__ __forceinline__ void zp_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void zp_store(zp_bf16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void zp_store(zp_f16* p, float x) { *p = __float2half_rn(x); }

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
// cache positions of one request and one kv head, d elements of T each, kept
// in shared memory with a row stride of d + kKeyPadOf<T> elements (16 bytes
// of padding): rows stay 16-byte aligned, and 16-byte reads of consecutive
// rows at one column hit distinct banks.
constexpr int kKeyTile = 64;
template <typename T>
constexpr int kKeyPadOf = kVecOf<T>;

__device__ __forceinline__ void zp_cp_async16(void* smem, const void* gmem, bool valid) {
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
// stale or NaN pool data never reaches shared memory. Needs
// d % kVecOf<T> == 0. The copies are spread over threads tid of nthr (the
// whole block unless given: a warp can stage its own tile). The address
// arithmetic sits on the path that issues the copies, so it is kept short:
// when the threads divide into the row's 16-byte columns each thread keeps
// one column and walks rows, and a page size that is a power of two is
// divided by shifts.
template <typename T>
__device__ __forceinline__ void zp_load_key_tile(T* dst, const T* __restrict__ pool,
                                                 const int* __restrict__ bt, int pos0,
                                                 int n_valid, int h, int hh, int d, int b,
                                                 int rows = kKeyTile, int tid = -1,
                                                 int nthr = 0) {
  if (nthr == 0) {
    tid = threadIdx.x;
    nthr = blockDim.x;
  }
  constexpr int V = kVecOf<T>;
  const int d4 = d / V;  // 16-byte columns a row
  const int ld = d + kKeyPadOf<T>;
  const int shift = (b & (b - 1)) == 0 ? __ffs(b) - 1 : -1;
  auto copy = [&](int t, int c4) {
    const int pos = pos0 + t;
    const int blk = shift >= 0 ? pos >> shift : pos / b;
    const int slot = pos - blk * b;
    const int page = pos < n_valid ? bt[blk] : -1;
    const T* src =
        page >= 0 ? pool + (((size_t)page * b + slot) * h + hh) * d + V * c4 : pool;
    zp_cp_async16(dst + t * ld + V * c4, src, page >= 0);
  };
  if (nthr % d4 == 0) {
    const int c4 = tid % d4;
    for (int t = tid / d4; t < rows; t += nthr / d4) copy(t, c4);
  } else {
    for (int idx = tid; idx < rows * d4; idx += nthr) copy(idx / d4, idx % d4);
  }
}

__device__ __forceinline__ float zp_dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// ---------------------------------------------------------------------------
// Decode attention in chunks (flash-decoding), shared by the dense kernel
// (paged_attention.cu) and the ragged one (ragged_paged_attention.cu), so
// that the live rows of the two are bit-identical.
//
// Each slot's block table is cut into chunks of zp_decode_chunk_pages()
// entries. A thread block of kDecodeThreads owns one (chunk, kv head, slot)
// and the g query heads of that kv head. It walks the chunk's cache
// positions in tiles of kDecodeRows, staged by cp.async into a ring of
// kDecodeStages buffers: two tiles are in flight while one is computed, and
// one barrier a tile frees the buffer that the next copy overwrites. Each
// of the four warps takes kDecodeWarpRows rows of every tile and keeps its
// own online-softmax state for all g heads, so K and V are read from
// shared memory once a tile: eight lanes share a row's scores (three
// shuffles sum them, in a fixed order), a tile's max and sum per head are
// two shuffles each, and for p.V a lane owns 4 (or 8) head dims. At the
// end of the chunk the block merges its four warps' states, in warp order, into the
// chunk's part of the workspace, and a second kernel (defined in each .cu,
// so that a profiler tells the two apart) merges the parts of a (slot, kv
// head) in ascending chunk order and writes acc / max(l, 1e-30). Both
// merges are zp_decode_merge_parts: they skip every state whose m is
// -1e30, and they load the parts in parallel before the ordered sums.
// Every rounding step is spelled out (fmaf, __fmul_rn, __fadd_rn,
// __fsub_rn, expf): nothing is left to the compiler's contraction.
//
// Why the live rows of the two kernels are bit-identical:
//  * the chunk size is a function of the call's shape (B, h_kv, b, mb)
//    alone, so both kernels cut a table the same way and give each warp
//    the same rows;
//  * the ragged kernel walks a chunk's tiles only up to seq_len, the dense
//    one walks them all. A tile past seq_len is wholly masked: its scores
//    are -1e30, its probabilities exactly 0, its V lanes read as 0. It
//    leaves m as it was (a max with -1e30), its rescale factor is
//    expf(0) == 1, and it adds exact zeros to l and acc: the state is
//    unchanged (up to the sign of a zero, and -0 == +0);
//  * a chunk with no live entry leaves each of its warps, and so its
//    part, at m = -1e30, l = 0, acc = 0. The ragged kernel neither walks
//    nor merges such a chunk; the dense kernel walks it and its merge
//    skips its part, as both kernels skip any state with m == -1e30 (a
//    warp none of whose rows was valid). Both merge the same states, in
//    the same order, with the same code;
//  * a slot with seq_len == 0 has no part to merge: acc = 0, l = 0, and
//    the output is exact zeros in both kernels.
// The ragged kernel keeps its own rule: it never reads a table entry past
// ceil(seq_len / b) and zero-fills positions past seq_len instead of
// reading them. The dense kernel reads every entry's page (a -1 entry as
// page 0) and masks in the math, as the TPU baseline does.
// In both, a position is valid iff it is below seq_len, whatever its
// table entry: a -1 entry below seq_len reads page 0, as the TPU kernels
// clamp it (jnp.maximum(bt, 0)) and mask by seq_len alone. The serve
// passes such rows: a slot that decodes nothing still attends seq_len + 1
// entries over an empty table (serve_model.build_decode_step), and its
// output, unused, must equal the plain version's.
constexpr int kDecodeWarps = 4;
constexpr int kDecodeThreads = 32 * kDecodeWarps;
constexpr int kDecodeRows = 16;                              // positions a tile
constexpr int kDecodeWarpRows = kDecodeRows / kDecodeWarps;  // rows of a tile a warp takes
constexpr int kDecodeStages = 3;
constexpr int kDecodeMaxG = 16;   // query heads per kv head
// floats of probabilities a warp keeps a tile: its rows x the heads
constexpr int kDecodeWarpP = kDecodeWarpRows * kDecodeMaxG;
constexpr int kDecodeMaxD = 256;  // head_dim: two float4 columns a lane
constexpr int kDecodeTargetBlocks = 1024;
constexpr int kDecodeMaxChunks = 32;

// q, K, V and the output are T; the parts, and all the math, are fp32.
template <typename T>
struct ZpDecodeArgs {
  const T* q;                 // (B, hq, d)
  const T* k_pool;            // (N, b, hkv, d)
  const T* v_pool;            // (N, b, hkv, d)
  const int* block_tables;    // (B, mb)
  const int* seq_lens;        // (B,)
  T* out;                     // (B, hq, d)
  float* part;                // (B, hkv, n_chunks) parts of g (d + 2) floats
  int hkv, g, d, b, mb;
  int chunk_pages, n_chunks;  // zp_decode_chunk_pages, zp_decode_n_chunks
  int ld;                     // shared-memory row stride: d rounded up to kVecOf<T>
  int vec;                    // 16-byte copies (d % kVecOf<T> == 0, aligned pointers);
                              // else 4-byte ones (float only)
  float scale;
};

// Table entries a chunk: as many chunks as give about kDecodeTargetBlocks
// (chunk, kv head, slot) blocks, at most kDecodeMaxChunks a slot, and at
// least a tile of positions a chunk. A function of (B, h_kv, b, mb) alone.
__host__ __device__ inline int zp_decode_chunk_pages(int batch, int hkv, int b, int mb) {
  const long long pairs = (long long)batch * hkv > 0 ? (long long)batch * hkv : 1;
  long long chunks = (kDecodeTargetBlocks + pairs - 1) / pairs;
  if (chunks > kDecodeMaxChunks) chunks = kDecodeMaxChunks;
  if (chunks > mb) chunks = mb;
  if (chunks < 1) chunks = 1;
  const int pages = (int)((mb + chunks - 1) / chunks);
  const int min_pages = (kDecodeRows + b - 1) / b;
  return pages > min_pages ? pages : min_pages;
}

__host__ __device__ inline int zp_decode_n_chunks(int mb, int chunk_pages) {
  const int n = (mb + chunk_pages - 1) / chunk_pages;
  return n > 0 ? n : 1;
}

// Floats of workspace a launch needs after its B * hq * d outputs.
inline long long zp_decode_workspace(int batch, int hkv, int g, int d, int b, int mb) {
  const int n_chunks = zp_decode_n_chunks(mb, zp_decode_chunk_pages(batch, hkv, b, mb));
  return (long long)batch * hkv * n_chunks * g * (d + 2);
}

__device__ __forceinline__ void zp_cp_async4(float* smem, const float* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void zp_cp_async8(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// Copy rows 0 .. rows - 1 of two row sets (K and V, or q alone with dst1
// null) into shared memory with row stride a.ld, by 16-byte copies when
// a.vec, else 4-byte ones (float only: the columns d .. ld - 1
// zero-filled). src(t) gives the element offset of row t in both sources,
// or -1 for a row of zeros, which reads nothing.
template <typename T, typename Src>
__device__ __forceinline__ void zp_decode_copy_rows(const ZpDecodeArgs<T>& a, T* dst0,
                                                    const T* src0, T* dst1, const T* src1,
                                                    int rows, Src src) {
  constexpr int V = kVecOf<T>;
  const int tid = threadIdx.x;
  if (a.vec) {
    const int d4 = a.d / V;  // 16-byte columns a row
    auto copy = [&](int t, int c4) {
      const long long off = src(t);
      const bool ok = off >= 0;
      zp_cp_async16(dst0 + t * a.ld + V * c4, ok ? src0 + off + V * c4 : src0, ok);
      if (dst1 != nullptr)
        zp_cp_async16(dst1 + t * a.ld + V * c4, ok ? src1 + off + V * c4 : src1, ok);
    };
    if (kDecodeThreads % d4 == 0) {
      const int c4 = tid % d4;
      for (int t = tid / d4; t < rows; t += kDecodeThreads / d4) copy(t, c4);
    } else {
      for (int idx = tid; idx < rows * d4; idx += kDecodeThreads) copy(idx / d4, idx % d4);
    }
  } else if constexpr (std::is_same<T, float>::value) {
    for (int idx = tid; idx < rows * a.ld; idx += kDecodeThreads) {
      const int t = idx / a.ld;
      const int c = idx - t * a.ld;
      const long long off = src(t);
      const bool ok = off >= 0 && c < a.d;
      zp_cp_async4(dst0 + idx, ok ? src0 + off + c : src0, ok);
      if (dst1 != nullptr) zp_cp_async4(dst1 + idx, ok ? src1 + off + c : src1, ok);
    }
  }
}

// A thread's share of every tile's copies, fixed for the block, so that
// issuing a tile costs a table read and one multiply-add a row: when the
// block's threads divide into a row's 16-byte columns (and the copies are
// 16-byte ones), the thread copies 16-byte column c4 of rows t0, t0 + tstep,
// ...; otherwise (tstep == 0) the tile goes through zp_decode_copy_rows.
struct ZpDecodeCopier {
  int c4, t0, tstep;
  int shift;              // log2(b), or -1 when b is not a power of two
  long long page_stride;  // b * hkv * d
  int row_stride;         // hkv * d
  int col;                // h * d + kVecOf<T> * c4: the head and column within a row
};

template <typename T>
__device__ __forceinline__ ZpDecodeCopier zp_decode_copier(const ZpDecodeArgs<T>& a, int h) {
  constexpr int V = kVecOf<T>;
  ZpDecodeCopier c;
  const int d4 = a.d / V;
  const bool fixed = a.vec && kDecodeThreads % d4 == 0;
  c.c4 = fixed ? threadIdx.x % d4 : 0;
  c.t0 = fixed ? threadIdx.x / d4 : 0;
  c.tstep = fixed ? kDecodeThreads / d4 : 0;
  c.shift = (a.b & (a.b - 1)) == 0 ? __ffs(a.b) - 1 : -1;
  c.page_stride = (long long)a.b * a.hkv * a.d;
  c.row_stride = a.hkv * a.d;
  c.col = h * a.d + V * c.c4;
  return c;
}

// Issue the copies of the tile whose first row is chunk position rel0
// (rel0 + t for row t; n_pos positions of the chunk are walked), and write
// each row's validity (position < seq_len). tbl holds
// the chunk's table entries (-1 past what the kernel may read). The dense
// kernel reads every row of the chunk (a -1 entry as page 0); the ragged
// one reads only valid rows and zero-fills the rest.
template <bool kDense, typename T>
__device__ __forceinline__ void zp_decode_issue_tile(const ZpDecodeArgs<T>& a,
                                                     const ZpDecodeCopier& cp, T* k_dst,
                                                     T* v_dst, int* valid_dst,
                                                     const int* tbl, int rel0, int n_pos,
                                                     int pos0, int seq_len, int h) {
  const int b = a.b;
  auto entry_of = [&](int rel) { return tbl[cp.shift >= 0 ? rel >> cp.shift : rel / b]; };
  if (threadIdx.x < kDecodeRows) {
    const int rel = rel0 + threadIdx.x;
    valid_dst[threadIdx.x] = rel < n_pos && pos0 + rel < seq_len;
  }
  if (cp.tstep > 0) {
    for (int t = cp.t0; t < kDecodeRows; t += cp.tstep) {
      const int rel = rel0 + t;
      bool ok = rel < n_pos;
      long long off = 0;
      if (ok) {
        const int j = cp.shift >= 0 ? rel >> cp.shift : rel / b;
        const int e = tbl[j];
        if (!kDense) ok = pos0 + rel < seq_len;
        const int page = e >= 0 ? e : 0;  // a -1 entry reads page 0, as the TPU kernels' clamp
        off = page * cp.page_stride + (rel - j * b) * cp.row_stride + cp.col;
      }
      zp_cp_async16(k_dst + t * a.ld + kVecOf<T> * cp.c4, a.k_pool + off, ok);
      zp_cp_async16(v_dst + t * a.ld + kVecOf<T> * cp.c4, a.v_pool + off, ok);
    }
    return;
  }
  zp_decode_copy_rows(a, k_dst, a.k_pool, v_dst, a.v_pool, kDecodeRows, [&](int t) {
    const int rel = rel0 + t;
    if (rel >= n_pos) return -1LL;
    const int e = entry_of(rel);
    if (!kDense && pos0 + rel >= seq_len) return -1LL;
    const int page = e >= 0 ? e : 0;
    const int slot = rel - (cp.shift >= 0 ? (rel >> cp.shift) << cp.shift : (rel / b) * b);
    return (((long long)page * b + slot) * a.hkv + h) * a.d;
  });
}

// One tile of the online softmax for a warp's kDecodeWarpRows rows (r0 ..)
// of the tile in k_s / v_s (valid_s: the rows' validity), all G heads, q
// in q_s (G rows of ld). For the scores, eight lanes share a row, each
// over columns 4 j .. 4 j + 3, j = lane % 8, j + 8, ... of d (widened to
// fp32 as they are read), and three shuffles sum a row's dot products;
// every lane then holds all G scores of its row, and the max and sum over
// the warp's rows are two shuffles each. For p.V a lane owns the groups of
// four columns lane + 32 j (j < DPL) of acc and V, and reads the
// probabilities from p_w (the warp's 32 floats of scratch). m[gi] and
// l[gi] are the same in every lane.
template <int G, int DPL, typename T>
__device__ __forceinline__ void zp_decode_tile(const ZpDecodeArgs<T>& a, const T* k_s,
                                               const T* v_s, const int* valid_s,
                                               const T* q_s, float* p_w, float (&m)[G],
                                               float (&l)[G], float4 (&acc)[G][DPL], int lane,
                                               int r0) {
  const int d4 = a.ld >> 2;
  const int rr = lane >> 3;  // the lane's row of the warp's four
  const int part = lane & 7;
  const T* krow = k_s + (r0 + rr) * a.ld;
  float s[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) s[gi] = 0.f;
  for (int c4 = part; c4 < d4; c4 += 8) {
    const float4 kv = zp_load4(krow + 4 * c4);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) s[gi] = zp_dot4(zp_load4(q_s + gi * a.ld + 4 * c4), kv, s[gi]);
  }
  const bool valid = valid_s[r0 + rr] != 0;
  float p[G], corr[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float x = s[gi];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
    const float sc = valid ? __fmul_rn(x, a.scale) : ZP_NEG_INF;
    float mx = fmaxf(sc, __shfl_xor_sync(0xffffffffu, sc, 8));  // over the warp's rows
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float m_new = fmaxf(m[gi], mx);
    corr[gi] = expf(__fsub_rn(m[gi], m_new));
    m[gi] = m_new;
    p[gi] = valid ? expf(__fsub_rn(sc, m_new)) : 0.f;
    float ps = __fadd_rn(p[gi], __shfl_xor_sync(0xffffffffu, p[gi], 8));
    ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, 16));
    l[gi] = fmaf(l[gi], corr[gi], ps);
  }
  if (part == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) p_w[rr * G + gi] = p[gi];
  }
  __syncwarp();
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      acc[gi][j].x = __fmul_rn(acc[gi][j].x, corr[gi]);
      acc[gi][j].y = __fmul_rn(acc[gi][j].y, corr[gi]);
      acc[gi][j].z = __fmul_rn(acc[gi][j].z, corr[gi]);
      acc[gi][j].w = __fmul_rn(acc[gi][j].w, corr[gi]);
    }
#pragma unroll
  for (int r = 0; r < kDecodeWarpRows; ++r) {
    const bool ok = valid_s[r0 + r] != 0;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int c4 = lane + 32 * j;
      if (c4 < d4) {
        float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);  // masked V lanes: 0, never NaN
        if (ok) vv = zp_load4(v_s + (r0 + r) * a.ld + 4 * c4);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const float pr = p_w[r * G + gi];
          acc[gi][j].x = fmaf(pr, vv.x, acc[gi][j].x);
          acc[gi][j].y = fmaf(pr, vv.y, acc[gi][j].y);
          acc[gi][j].z = fmaf(pr, vv.z, acc[gi][j].z);
          acc[gi][j].w = fmaf(pr, vv.w, acc[gi][j].w);
        }
      }
    }
  }
  __syncwarp();  // p_w is rewritten by the next tile
}

// Merge n_parts online-softmax states of g heads, part p at parts + p *
// stride (m[g], l[g], then acc[g][d]; shared or global memory), in
// ascending order, skipping every part with m == -1e30: M = max m,
// w_p = expf(m_p - M), L = sum of l_p w_p and acc = sum of acc_p w_p, each
// sum in part order by fmaf. All threads of the block call it. scratch
// holds 2 * n_parts * g floats of shared memory; ml_s gets M (g) then L
// (g). emit(idx, gi, acc) receives element idx = gi * d + col.
template <typename Emit>
__device__ __forceinline__ void zp_decode_merge_parts(const float* parts, int stride,
                                                      int n_parts, int g, int d, float* scratch,
                                                      float* ml_s, Emit emit) {
  float* w_s = scratch;            // m, then the weights (-1: a skipped part)
  float* l_s = w_s + n_parts * g;
  for (int i = threadIdx.x; i < n_parts * g; i += blockDim.x) {
    const int p = i / g;
    const int gi = i - p * g;
    w_s[i] = parts[(size_t)p * stride + gi];
    l_s[i] = parts[(size_t)p * stride + g + gi];
  }
  __syncthreads();
  if (threadIdx.x < g) {
    const int gi = threadIdx.x;
    float M = ZP_NEG_INF;
    for (int p = 0; p < n_parts; ++p) M = fmaxf(M, w_s[p * g + gi]);
    float L = 0.f;
    for (int p = 0; p < n_parts; ++p) {
      const float mp = w_s[p * g + gi];
      float w = -1.f;
      if (mp != ZP_NEG_INF) {
        w = expf(__fsub_rn(mp, M));
        L = fmaf(l_s[p * g + gi], w, L);
      }
      w_s[p * g + gi] = w;
    }
    ml_s[gi] = M;
    ml_s[g + gi] = L;
  }
  __syncthreads();
  // four elements a thread at a time, so that the loads of a part are
  // independent of one another and of the sums
  const int n = g * d;
  for (int base = threadIdx.x; base < n; base += 4 * blockDim.x) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int gi[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) gi[k] = min(base + k * (int)blockDim.x, n - 1) / d;
#pragma unroll 4
    for (int p = 0; p < n_parts; ++p) {
      float x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int idx = base + k * blockDim.x;
        x[k] = idx < n ? parts[(size_t)p * stride + 2 * g + idx] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float w = w_s[p * g + gi[k]];
        if (w >= 0.f) acc[k] = fmaf(x[k], w, acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (base + k * (int)blockDim.x < n) emit(base + k * blockDim.x, gi[k], acc[k]);
  }
}

// Shared memory of a chunk block: the chunk's table entries, the stages'
// row validity, the warps' probabilities, q (G rows of T) and the ring of
// K and V tiles (of T), which then takes the warps' fp32 states (the
// larger of the two); every section a multiple of 16 bytes, so rows stay
// 16-byte aligned.
__host__ __device__ inline size_t zp_decode_smem_bytes(int G, int ld, int chunk_pages,
                                                       int esize, int g, int d) {
  const size_t tbl = (chunk_pages + 3) & ~3;
  const size_t ring = (size_t)esize * 2 * kDecodeStages * kDecodeRows * ld;
  const size_t states = sizeof(float) * (size_t)kDecodeWarps * g * (d + 2);
  return sizeof(float) * (tbl + kDecodeStages * kDecodeRows + kDecodeWarpP * kDecodeWarps) +
         (size_t)esize * G * ld + (ring > states ? ring : states);
}

// The chunk kernel's body: block (chunk, kv head, slot) = blockIdx (x, y, z).
template <int G, int DPL, bool kDense, typename T>
__device__ __forceinline__ void zp_decode_chunk(const ZpDecodeArgs<T>& a, float* smem) {
  const int chunk = blockIdx.x;
  const int h = blockIdx.y;
  const int slot = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seq_len = max(a.seq_lens[slot], 0);
  const int e0 = chunk * a.chunk_pages;             // the chunk's first table entry
  const int e1 = min(e0 + a.chunk_pages, a.mb);
  const int pos0 = e0 * a.b;
  int n_pos = max(e1 - e0, 0) * a.b;                // positions walked
  if (!kDense) {
    if (pos0 >= seq_len) return;  // a dead chunk: neither walked nor merged
    n_pos = min(n_pos, seq_len - pos0);
  }
  const int n_tiles = (n_pos + kDecodeRows - 1) / kDecodeRows;

  int* tbl_s = reinterpret_cast<int*>(smem);
  int* valid_s = tbl_s + ((a.chunk_pages + 3) & ~3);
  float* p_s = reinterpret_cast<float*>(valid_s + kDecodeStages * kDecodeRows);
  T* q_s = reinterpret_cast<T*>(p_s + kDecodeWarpP * kDecodeWarps);
  T* kv_s = q_s + G * a.ld;
  const int tile_elems = kDecodeRows * a.ld;  // elements of T a tile

  // the chunk's table entries; the ragged kernel reads none at or past
  // ceil(seq_len / b)
  const int* bt = a.block_tables + (size_t)slot * a.mb;
  const int n_read = kDense ? e1 - e0 : min(e1, (seq_len + a.b - 1) / a.b) - e0;
  for (int i = tid; i < e1 - e0; i += kDecodeThreads) tbl_s[i] = i < n_read ? bt[e0 + i] : -1;
  __syncthreads();

  const int hq = a.hkv * a.g;
  const T* qp = a.q + ((size_t)slot * hq + (size_t)h * a.g) * a.d;
  zp_decode_copy_rows(a, q_s, qp, (T*)nullptr, (const T*)nullptr, G,
                      [&](int gi) { return gi < a.g ? (long long)gi * a.d : -1LL; });
  const ZpDecodeCopier cp = zp_decode_copier(a, h);
  constexpr int kAhead = kDecodeStages - 1;  // tiles in flight while one is computed
  for (int j = 0; j < kAhead; ++j) {           // q goes with tile 0
    if (j < n_tiles)
      zp_decode_issue_tile<kDense>(a, cp, kv_s + 2 * j * tile_elems,
                                   kv_s + (2 * j + 1) * tile_elems, valid_s + j * kDecodeRows,
                                   tbl_s, j * kDecodeRows, n_pos, pos0, seq_len, h);
    zp_cp_async_commit();
  }

  float4 acc[G][DPL];
  float m[G], l[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = ZP_NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[gi][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int t = 0; t < n_tiles; ++t) {
    zp_cp_async_wait<kAhead - 1>();  // tile t (and q) have landed for this thread
    __syncthreads();  // ... for every thread; the buffer of tile t - 1 is free
    const int nxt = t + kAhead;
    if (nxt < n_tiles) {
      const int st = nxt % kDecodeStages;
      zp_decode_issue_tile<kDense>(a, cp, kv_s + 2 * st * tile_elems,
                                   kv_s + (2 * st + 1) * tile_elems,
                                   valid_s + st * kDecodeRows, tbl_s, nxt * kDecodeRows, n_pos,
                                   pos0, seq_len, h);
    }
    zp_cp_async_commit();
    const int st = t % kDecodeStages;
    zp_decode_tile<G, DPL, T>(a, kv_s + 2 * st * tile_elems, kv_s + (2 * st + 1) * tile_elems,
                           valid_s + st * kDecodeRows, q_s, p_s + kDecodeWarpP * warp, m, l, acc, lane,
                           warp * kDecodeWarpRows);
  }
  zp_cp_async_wait<0>();  // no copy outlives the block
  __syncthreads();        // the ring is free: it takes the warps' states

  // warp w's state at states + w * stride: m[g], l[g], acc[g][d]
  float* states = reinterpret_cast<float*>(kv_s);
  const int stride = a.g * (a.d + 2);
  float* st = states + warp * stride;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi >= a.g) break;
    if (lane == 0) {
      st[gi] = m[gi];
      st[a.g + gi] = l[gi];
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int c = 4 * (lane + 32 * j);
      float* o = st + 2 * a.g + gi * a.d + c;
      if (c < a.d) o[0] = acc[gi][j].x;
      if (c + 1 < a.d) o[1] = acc[gi][j].y;
      if (c + 2 < a.d) o[2] = acc[gi][j].z;
      if (c + 3 < a.d) o[3] = acc[gi][j].w;
    }
  }
  __syncthreads();
  // the chunk's part: the four warps' states merged in order
  float* dst = a.part + (((size_t)slot * a.hkv + h) * a.n_chunks + chunk) * stride;
  float* ml_s = p_s + 2 * kDecodeWarps * kDecodeMaxG;
  zp_decode_merge_parts(states, stride, kDecodeWarps, a.g, a.d, p_s, ml_s,
                        [&](int idx, int, float acc_v) { dst[2 * a.g + idx] = acc_v; });
  if (tid < 2 * a.g) dst[tid] = ml_s[tid];  // m, then l
}

// The merge kernel's body: block (kv head, slot) = blockIdx (x, y) merges
// the parts of chunks 0 .. n_read - 1 and writes acc / max(l, 1e-30),
// computed in fp32 and rounded once to T.
template <typename T>
__device__ __forceinline__ void zp_decode_merge(const ZpDecodeArgs<T>& a, int n_read) {
  __shared__ float scratch[2 * kDecodeMaxChunks * kDecodeMaxG + 2 * kDecodeMaxG];
  const int h = blockIdx.x;
  const int slot = blockIdx.y;
  const int stride = a.g * (a.d + 2);
  const float* parts = a.part + ((size_t)slot * a.hkv + h) * a.n_chunks * stride;
  float* ml_s = scratch + 2 * kDecodeMaxChunks * kDecodeMaxG;
  T* o = a.out + ((size_t)slot * a.hkv + h) * a.g * a.d;
  zp_decode_merge_parts(parts, stride, n_read, a.g, a.d, scratch, ml_s,
                        [&](int idx, int gi, float acc_v) {
                          zp_store(o + idx, acc_v / fmaxf(ml_s[a.g + gi], 1e-30f));
                        });
}

template <typename T>
using ZpDecodeChunkKernel = void (*)(ZpDecodeArgs<T>);
template <typename T>
using ZpDecodeMergeKernel = void (*)(ZpDecodeArgs<T>);

// The chunk kernel's instantiations for storage type T, indexed
// [log2 G][DPL - 1]. A g between two powers of two takes the larger G and
// masks the heads g .. G - 1 (their q rows are zeros, their states never
// stored): DBRX's g = 6 runs at G = 8, RecurrentGemma's g = 10 at G = 16.
#define ZP_DECODE_TABLE(kernel, T)                                                   \
  {                                                                                  \
    {kernel<1, 1, T>, kernel<1, 2, T>}, {kernel<2, 1, T>, kernel<2, 2, T>},          \
        {kernel<4, 1, T>, kernel<4, 2, T>}, {kernel<8, 1, T>, kernel<8, 2, T>},      \
        {kernel<16, 1, T>, kernel<16, 2, T>}                                         \
  }
constexpr int kDecodeTableG = 5;  // rows of ZP_DECODE_TABLE: G = 1, 2, 4, 8, 16

// Bytes of output at the start of a launch's buffer: B * hq * d elements
// of T, rounded up to 16 bytes; the fp32 parts (zp_decode_workspace()
// floats) follow.
inline long long zp_decode_out_bytes(int batch, int hq, int d, int esize) {
  return ((long long)batch * hq * d * esize + 15) & ~15LL;
}

// Launch a decode: the chunk kernel, then the merge kernel, on one stream.
// `out` is one buffer: the output (zp_decode_out_bytes()), then the parts.
// At a 16-bit T the rows must take 16-byte copies (d % 8 == 0, 16-byte
// aligned q and pools); anything else is refused.
template <typename T>
static int zp_decode_launch(const ZpDecodeChunkKernel<T> (&table)[kDecodeTableG][2],
                            ZpDecodeMergeKernel<T> merge, const void* q, const void* k_pool,
                            const void* v_pool, const void* block_tables, const void* seq_lens,
                            void* out, int batch, int hkv, int g, int d, int b, int mb,
                            float scale, void* stream) {
  constexpr int V = kVecOf<T>;
  if (g < 1 || g > kDecodeMaxG || d < 1 || d > kDecodeMaxD || b < 1 || hkv < 1 || mb < 0)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  ZpDecodeArgs<T> a;
  a.q = (const T*)q;
  a.k_pool = (const T*)k_pool;
  a.v_pool = (const T*)v_pool;
  a.block_tables = (const int*)block_tables;
  a.seq_lens = (const int*)seq_lens;
  a.out = (T*)out;
  a.part = (float*)((char*)out + zp_decode_out_bytes(batch, hkv * g, d, (int)sizeof(T)));
  a.hkv = hkv;
  a.g = g;
  a.d = d;
  a.b = b;
  a.mb = mb;
  a.chunk_pages = zp_decode_chunk_pages(batch, hkv, b, mb);
  a.n_chunks = zp_decode_n_chunks(mb, a.chunk_pages);
  a.ld = (d + V - 1) & ~(V - 1);
  const unsigned long long ptrs = (unsigned long long)q | (unsigned long long)k_pool |
                                  (unsigned long long)v_pool;
  a.vec = d % V == 0 && (ptrs & 15) == 0;
  if (!a.vec && !std::is_same<T, float>::value) return (int)cudaErrorInvalidValue;
  a.scale = scale;
  const int lg = g <= 1 ? 0 : g <= 2 ? 1 : g <= 4 ? 2 : g <= 8 ? 3 : 4;
  const int dpl = a.ld <= 128 ? 1 : 2;
  const ZpDecodeChunkKernel<T> kernel = table[lg][dpl - 1];
  const size_t smem = zp_decode_smem_bytes(1 << lg, a.ld, a.chunk_pages, (int)sizeof(T), g, d);
  cudaError_t err = zp_allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  kernel<<<dim3(a.n_chunks, hkv, batch), kDecodeThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge<<<dim3(hkv, batch), kDecodeThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
