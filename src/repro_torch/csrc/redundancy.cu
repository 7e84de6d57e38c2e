// Lightning key redundancy (paper App. C.7): page-local cosine similarity.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/redundancy.py::lightning_redundancy.
// For each request, kv head and page it L2-normalises the page's keys
// (k / max(||k||, 1e-12)), forms the b x b cosine matrix, zeroes the
// diagonal and every row or column at a position >= seq_len, then zeroes
// per column the last (newest) row whose similarity exceeds p_thresh, and
// writes the row sums divided by b. Output (n, max_blocks * b, h), float32,
// from fp32 or bf16 keys (widened to fp32 before they are normalised).
//
// Pages at or past seq_len are written as zeros without reading their
// table entry, so -1 padding is never dereferenced; key rows past seq_len
// and on a -1 entry are zero-filled by the copy, not read, so stale or NaN
// pool data cannot reach an output. No atomics: two launches give the same
// bits.
//
// What bounds it on the card: memory. Each live key element is read once;
// the distinct products are b - 1 per key at 2 d flops (32 flops a key
// element at b = 16), under the H100's ridge point, and the output is b/d
// of the key bytes. A block takes one page (grid: page, kv head, request)
// and cuts its chain of dependent steps short:
//   * the page's table entry is read once and its keys are staged by
//     16-byte cp.async;
//   * eight lanes share a key: its norm is their sum of squares and three
//     shuffles, and each divides its own columns by it, in place, before
//     any product (folding the norms into the products would round the
//     cosines differently from the plain version's and could flip a
//     > p_thresh test);
//   * the matrix is symmetric and dot(a, b) == dot(b, a) when both run in
//     the same order, so only 2 x 2 tiles of entries on and above the
//     diagonal are formed (36 at b = 16), each by a pair of lanes over
//     alternate float4 columns of d and one shuffle, and an entry above
//     the diagonal is written to both halves: four 16-byte shared loads
//     feed 16 FMAs, and key rows padded to 8 banks apart keep the loads
//     free of bank conflicts;
//   * the newest row above p_thresh of a column is a warp ballot, lane r
//     voting for row r (a word of 32 rows at a time), 31 - clz of the
//     highest non-empty word; the row sums are shuffle trees over the
//     lanes of a row, in a fixed order.
// What holds it back: a page is a chain of five short phases (table and
// copy, norms, products, vote, row sums) joined by block barriers, so at
// the serve's 64 pages the time is one chain, and at the long input's
// 2048 pages the SMs run about one and a half waves of such chains; the
// products load each key from shared memory once per tile of the matrix.
// PERF.md has the times and the designs measured on the way.
#include "common.cuh"

namespace {
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kNormLanes = 8;  // lanes that share a key's norm
constexpr int kPad = 8;        // floats of padding a key row: rows 8 banks apart

// Shared memory: the page's keys normalised in fp32 (b x ld floats), the
// cosines (b x (b + 1) floats, rounded up to 16 bytes), and, for bf16
// keys, the page as copied (b x ld elements); fp32 keys are copied into
// the first section and normalised in place.
template <typename T>
__host__ __device__ inline size_t smem_bytes(int b, int d) {
  const size_t ld = (size_t)d + kPad;
  const size_t floats = (size_t)b * ld + (((size_t)b * (b + 1) + 3) & ~(size_t)3);
  return sizeof(float) * floats + (std::is_same<T, float>::value ? 0 : sizeof(T) * b * ld);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lightning_redundancy_kernel(const T* __restrict__ k_pool,          // (N, b, h, d)
                            const int* __restrict__ block_tables,  // (n, mb)
                            const int* __restrict__ seq_lens,      // (n,)
                            float* __restrict__ out,               // (n, mb*b, h)
                            int h, int d, int b, int mb, float p_thresh) {
  constexpr int V = kVecOf<T>;
  extern __shared__ __align__(16) float smem[];
  const int ld = d + kPad;
  float* k_s = smem;                  // b x ld keys, normalised
  float* c_s = k_s + (size_t)b * ld;  // b x (b + 1) cosines
  T* raw_s = std::is_same<T, float>::value  // b x ld keys as copied
                 ? reinterpret_cast<T*>(k_s)
                 : reinterpret_cast<T*>(c_s + (((size_t)b * (b + 1) + 3) & ~(size_t)3));
  const int i = blockIdx.x;
  const int hh = blockIdx.y;
  const int ib = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seq_len = seq_lens[ib];
  float* o = out + ((size_t)ib * mb * b + (size_t)i * b) * h + hh;

  if (i * b >= seq_len) {  // dead page: every entry invalid, table entry unread
    for (int r = tid; r < b; r += kThreads) o[(size_t)r * h] = 0.f;
    return;
  }
  const int page = block_tables[(size_t)ib * mb + i];
  const int n_valid = page >= 0 ? min(b, seq_len - i * b) : 0;
  const int dv = d / V;  // 16-byte columns a row
  const T* src0 = k_pool + ((size_t)max(page, 0) * b * h + hh) * d;
  auto copy = [&](int t, int cv) {
    const bool ok = t < n_valid;
    zp_cp_async16(raw_s + t * ld + V * cv, ok ? src0 + (size_t)t * h * d + V * cv : k_pool, ok);
  };
  if (kThreads % dv == 0) {
    const int cv = tid % dv;
    for (int t = tid / dv; t < b; t += kThreads / dv) copy(t, cv);
  } else {
    for (int idx = tid; idx < b * dv; idx += kThreads) copy(idx / dv, idx % dv);
  }
  const int d4 = d >> 2;
  zp_cp_async_commit();
  zp_cp_async_wait<0>();
  __syncthreads();

  // norms: kNormLanes lanes a key, kThreads / kNormLanes keys at a time;
  // each lane widens its own columns and writes them normalised
  for (int t0 = 0; t0 < b; t0 += kThreads / kNormLanes) {
    const int t = t0 + tid / kNormLanes;
    const T* xr = raw_s + min(t, b - 1) * ld;
    float* x = k_s + min(t, b - 1) * ld;
    float ss = 0.f;
    for (int c4 = tid % kNormLanes; c4 < d4; c4 += kNormLanes) {
      const float4 v = zp_load4(xr + 4 * c4);
      ss = zp_dot4(v, v, ss);
    }
#pragma unroll
    for (int off = kNormLanes / 2; off > 0; off >>= 1)
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
    const float nrm = fmaxf(sqrtf(ss), 1e-12f);
    if (t < b) {
      for (int c4 = tid % kNormLanes; c4 < d4; c4 += kNormLanes) {
        float4 v = zp_load4(xr + 4 * c4);
        v.x = v.x / nrm;
        v.y = v.y / nrm;
        v.z = v.z / nrm;
        v.w = v.w / nrm;
        *reinterpret_cast<float4*>(x + 4 * c4) = v;
      }
    }
  }
  __syncthreads();

  // products: 2 x 2 blocks of entries (rows 2R, 2R + 1 by columns 2C,
  // 2C + 1, R <= C), block q = C (C + 1) / 2 + R, a pair of lanes a block,
  // each over alternate float4 columns of d, then one shuffle; entries
  // above the diagonal are written to both halves, the diagonal is zero
  for (int t = tid; t < b; t += kThreads) c_s[t * (b + 1) + t] = 0.f;
  const int nb2 = (b + 1) / 2;
  const int n_blocks = nb2 * (nb2 + 1) / 2;
  for (int base = 0; base < 2 * n_blocks; base += kThreads) {  // uniform: shuffles below
    const int q = (base + tid) >> 1;
    const int half = tid & 1;
    int C = (int)((sqrtf(8.f * (float)q + 1.f) - 1.f) * 0.5f);
    while (C * (C + 1) / 2 > q) --C;
    while ((C + 1) * (C + 2) / 2 <= q) ++C;
    const int R = q - C * (C + 1) / 2;
    const float* a0 = k_s + min(2 * R, b - 1) * ld;
    const float* a1 = k_s + min(2 * R + 1, b - 1) * ld;
    const float* b0 = k_s + min(2 * C, b - 1) * ld;
    const float* b1 = k_s + min(2 * C + 1, b - 1) * ld;
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    if (q < n_blocks) {
      for (int c4 = half; c4 < d4; c4 += 2) {
        const float4 x0 = *reinterpret_cast<const float4*>(a0 + 4 * c4);
        const float4 x1 = *reinterpret_cast<const float4*>(a1 + 4 * c4);
        const float4 y0 = *reinterpret_cast<const float4*>(b0 + 4 * c4);
        const float4 y1 = *reinterpret_cast<const float4*>(b1 + 4 * c4);
        acc[0][0] = zp_dot4(x0, y0, acc[0][0]);
        acc[0][1] = zp_dot4(x0, y1, acc[0][1]);
        acc[1][0] = zp_dot4(x1, y0, acc[1][0]);
        acc[1][1] = zp_dot4(x1, y1, acc[1][1]);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float dot = __fadd_rn(acc[u][v], __shfl_xor_sync(0xffffffffu, acc[u][v], 1));
        const int r = 2 * R + u;
        const int c = 2 * C + v;
        if (q < n_blocks && half == 0 && r < c && c < b) {
          const float x = r < n_valid && c < n_valid ? dot : 0.f;
          c_s[r * (b + 1) + c] = x;
          c_s[c * (b + 1) + r] = x;
        }
      }
  }
  __syncthreads();

#pragma unroll 4
  for (int c = warp; c < b; c += kWarps) {  // newest row above p_thresh, per column
    int newest = -1;
    for (int r0 = 0; r0 < b; r0 += 32) {
      const int r = r0 + lane;
      const unsigned vote = __ballot_sync(0xffffffffu, r < b && c_s[r * (b + 1) + c] > p_thresh);
      if (vote != 0u) newest = r0 + 31 - __clz(vote);
    }
    if (lane == 0 && newest >= 0) c_s[newest * (b + 1) + c] = 0.f;
  }
  __syncthreads();

  // row sums: lpr lanes a row (b rounded up to a power of two, at most
  // 32), each over columns lane % lpr + lpr k in order, then a shuffle tree
  int lpr = 1;
  while (lpr < b && lpr < 32) lpr <<= 1;
#pragma unroll 2
  for (int r0 = warp * (32 / lpr); r0 < b; r0 += kThreads / lpr) {
    const int r = r0 + lane / lpr;
    float sum = 0.f;
    if (r < b)
      for (int c = lane % lpr; c < b; c += lpr) sum = __fadd_rn(sum, c_s[r * (b + 1) + c]);
    for (int off = lpr / 2; off > 0; off >>= 1)
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
    if (lane % lpr == 0 && r < b) o[(size_t)r * h] = sum / (float)b;
  }
}

template <typename T>
int launch(const void* k_pool, const void* block_tables, const void* seq_lens, void* out, int n,
           int h, int d, int b, int mb, float p_thresh, void* stream) {
  if (d % kVecOf<T> != 0 || b < 1) return (int)cudaErrorInvalidValue;
  if ((long long)n * h * mb == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes<T>(b, d);
  cudaError_t err = zp_allow_smem(lightning_redundancy_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  lightning_redundancy_kernel<T><<<dim3(mb, h, n), kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)k_pool, (const int*)block_tables, (const int*)seq_lens, (float*)out, h, d, b,
      mb, p_thresh);
  return (int)cudaGetLastError();
}
}  // namespace

// keys in float ...
extern "C" int lightning_redundancy_launch(const void* k_pool, const void* block_tables,
                                           const void* seq_lens, void* out, int n, int h,
                                           int d, int b, int mb, float p_thresh,
                                           void* stream) {
  return launch<float>(k_pool, block_tables, seq_lens, out, n, h, d, b, mb, p_thresh, stream);
}

// ... or in bf16 (widened to fp32 as they are normalised); the output is fp32.
extern "C" int lightning_redundancy_launch_bf16(const void* k_pool, const void* block_tables,
                                                const void* seq_lens, void* out, int n, int h,
                                                int d, int b, int mb, float p_thresh,
                                                void* stream) {
  return launch<zp_bf16>(k_pool, block_tables, seq_lens, out, n, h, d, b, mb, p_thresh, stream);
}

// ... or in fp16 (widened to fp32 as they are normalised); the output is fp32.
extern "C" int lightning_redundancy_launch_f16(const void* k_pool, const void* block_tables,
                                               const void* seq_lens, void* out, int n, int h,
                                               int d, int b, int mb, float p_thresh,
                                               void* stream) {
  return launch<zp_f16>(k_pool, block_tables, seq_lens, out, n, h, d, b, mb, p_thresh, stream);
}
