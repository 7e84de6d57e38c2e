// Flash key redundancy (paper Alg. 3): full-sequence cosine similarity.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/redundancy.py::flash_redundancy.
// For each request and kv head it L2-normalises the keys (eps 1e-12), forms
// the T x T cosine matrix block by block, zeroes the diagonal and every row
// or column at a position >= seq_len, zeroes per column the last (newest)
// row whose similarity exceeds p_thresh, and writes the row sums divided by
// max(seq_len, 1). Output (n, max_blocks * b, h), float32.
//
// The TPU kernel runs a grid (n, h, m) whose column-block axis m is
// sequential: it carries the per-column "already zeroed" tag across the
// row blocks i = N-1..0 of one m, and it accumulates every (i, m) tile's
// row sums into one output tile that the m axis revisits. On the card,
// blocks per (request, head, m) adding into the same rows with atomics
// would make the sums, and so the survivors of a top-k whose margins are
// about 1e-5, depend on the run. So there are no atomics: one thread block
// per (request, head) loops m in order and, inside, i = N-1..0 with the
// (b,) tag in shared memory, and keeps the running row sums of all T rows
// in shared memory. The sums are added in a fixed order: the result is the
// same in every run.
//
// Pages at or past seq_len are not read: a dead column block is skipped
// (its columns are all masked, so its tiles add zeros), and a dead row
// block contributes an all-zero tile without loading its keys (the tag
// logic still runs over it, as the TPU kernel's does). Key rows past
// seq_len are loaded as zeros and masked, so stale or NaN pool data cannot
// reach an output.
//
// What bounds it on the card: it is a first version and latency-bound. The
// work is T^2 * d multiply-adds per (request, head) (2 * n_live^2 * d
// flops), the bytes are the live keys once; at the serve's shapes (T = 64)
// both bounds are well under a microsecond, while one block per
// (request, head) re-reads each row block from L2 for every column block
// and synchronises three times per tile.
#include "common.cuh"

namespace {
constexpr int kThreads = 128;

// Load rows of one page's keys for head hh, L2-normalised, into k_s (ld
// floats a row); rows t >= n_valid are zeros. Uses n_s (b floats).
__device__ __forceinline__ void load_normalised(const float* __restrict__ k_pool, int page,
                                                int n_valid, int hh, int h, int d, int b,
                                                float* k_s, float* n_s) {
  const int ld = d + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int idx = threadIdx.x; idx < b * d; idx += blockDim.x) {
    const int t = idx / d;
    const int dd = idx - t * d;
    float kv = 0.f;
    if (t < n_valid) kv = k_pool[(((size_t)page * b + t) * h + hh) * d + dd];
    k_s[t * ld + dd] = kv;
  }
  __syncthreads();
  for (int t = warp; t < b; t += n_warps) {
    float ss = 0.f;
    for (int dd = lane; dd < d; dd += 32) ss += k_s[t * ld + dd] * k_s[t * ld + dd];
    ss = zp_warp_sum(ss);
    if (lane == 0) n_s[t] = fmaxf(sqrtf(ss), 1e-12f);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < b * d; idx += blockDim.x) {
    const int t = idx / d;
    const int dd = idx - t * d;
    k_s[t * ld + dd] = k_s[t * ld + dd] / n_s[t];
  }
}

__global__ void __launch_bounds__(kThreads)
flash_redundancy_kernel(const float* __restrict__ k_pool,      // (N, b, h, d)
                        const int* __restrict__ block_tables,  // (n, mb)
                        const int* __restrict__ seq_lens,      // (n,)
                        float* __restrict__ out,               // (n, mb*b, h)
                        int h, int d, int b, int mb, float p_thresh) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int T = mb * b;
  float* km_s = smem;               // b * ld: column block m, normalised
  float* ki_s = km_s + b * ld;      // b * ld: row block i, normalised
  float* c_s = ki_s + b * ld;       // b * (b + 1): the (i, m) tile
  float* n_s = c_s + b * (b + 1);   // b norms
  float* r_s = n_s + b;             // T running row sums
  int* tag_s = (int*)(r_s + T);     // b: column already zeroed in a newer row block

  const int hh = blockIdx.x;
  const int ib = blockIdx.y;
  const int tid = threadIdx.x;
  const int seq_len = seq_lens[ib];
  const int n_live = min(seq_len > 0 ? (seq_len + b - 1) / b : 0, mb);
  const int* bt = block_tables + (size_t)ib * mb;

  for (int t = tid; t < T; t += blockDim.x) r_s[t] = 0.f;
  for (int m = 0; m < n_live; ++m) {  // dead column blocks add only zeros
    const int page_m = bt[m];
    const int nv_m = page_m >= 0 ? min(b, seq_len - m * b) : 0;
    __syncthreads();  // the previous m's km_s / tag_s are no longer read
    load_normalised(k_pool, page_m, nv_m, hh, h, d, b, km_s, n_s);
    for (int c = tid; c < b; c += blockDim.x) tag_s[c] = 0;
    for (int i = mb - 1; i >= 0; --i) {
      const bool row_live = i < n_live;
      const int page_i = row_live ? bt[i] : -1;
      const int nv_i = page_i >= 0 ? min(b, seq_len - i * b) : 0;
      __syncthreads();  // km_s / tag_s ready; the previous tile is consumed
      if (nv_i > 0) {
        load_normalised(k_pool, page_i, nv_i, hh, h, d, b, ki_s, n_s);
        __syncthreads();
      }
      for (int idx = tid; idx < b * b; idx += blockDim.x) {
        const int r = idx / b;
        const int c = idx - r * b;
        float s = 0.f;
        if (r < nv_i && c < nv_m && i * b + r != m * b + c) {
          const float* kr = ki_s + r * ld;
          const float* kc = km_s + c * ld;
          for (int dd = 0; dd < d; ++dd) s += kr[dd] * kc[dd];
        }
        c_s[r * (b + 1) + c] = s;
      }
      __syncthreads();
      for (int c = tid; c < b; c += blockDim.x) {  // newest row above p per column
        if (tag_s[c]) continue;
        int last = -1;
        for (int r = 0; r < b; ++r)
          if (c_s[r * (b + 1) + c] > p_thresh) last = r;
        if (last >= 0) {
          c_s[last * (b + 1) + c] = 0.f;
          tag_s[c] = 1;
        }
      }
      __syncthreads();
      for (int r = tid; r < b; r += blockDim.x) {
        float sum = 0.f;
        for (int c = 0; c < b; ++c) sum += c_s[r * (b + 1) + c];
        r_s[i * b + r] += sum;
      }
    }
  }
  __syncthreads();
  const float inv = 1.f / (float)max(seq_len, 1);
  float* o = out + (size_t)ib * T * h + hh;
  for (int t = tid; t < T; t += blockDim.x) o[(size_t)t * h] = r_s[t] * inv;
}
}  // namespace

extern "C" int flash_redundancy_launch(const void* k_pool, const void* block_tables,
                                       const void* seq_lens, void* out, int n, int h, int d,
                                       int b, int mb, float p_thresh, void* stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)b * (d + 1) + (size_t)b * (b + 1) + b +
                                       (size_t)mb * b) +
                      sizeof(int) * (size_t)b;
  cudaError_t err = zp_allow_smem(flash_redundancy_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(h, n);
  flash_redundancy_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)k_pool, (const int*)block_tables, (const int*)seq_lens, (float*)out, h, d,
      b, mb, p_thresh);
  return (int)cudaGetLastError();
}
