// Lightning key redundancy (paper App. C.7): page-local cosine similarity.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/redundancy.py::lightning_redundancy.
// For each request, kv head and page it L2-normalises the page's keys
// (eps 1e-12), forms the b x b cosine matrix, zeroes the diagonal and every
// row or column at a position >= seq_len, then zeroes per column the last
// (newest) row whose similarity exceeds p_thresh, and writes the row sums
// divided by b. Output (n, max_blocks * b, h), float32.
//
// One thread block per (page, kv head, request). Pages at or past seq_len
// are written as zeros without reading their table entry, so -1 padding
// is never dereferenced; key rows past seq_len are loaded as zeros and
// masked, so stale or NaN pool data cannot reach an output.
//
// What bounds it on the card: memory. Each live key element is read once;
// the b x b products are 2*b flops per key element (32 at b = 16), well
// under the H100's ridge point, and the output is b/d of the key bytes.
#include "common.cuh"

namespace {
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
lightning_redundancy_kernel(const float* __restrict__ k_pool,      // (N, b, h, d)
                            const int* __restrict__ block_tables,  // (n, mb)
                            const int* __restrict__ seq_lens,      // (n,)
                            float* __restrict__ out,               // (n, mb*b, h)
                            int h, int d, int b, int mb, float p_thresh) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* k_s = smem;                // b * ld, normalised keys
  float* c_s = k_s + b * ld;        // b * (b + 1) similarities
  float* n_s = c_s + b * (b + 1);   // b norms

  const int i = blockIdx.x;
  const int hh = blockIdx.y;
  const int ib = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int seq_len = seq_lens[ib];
  float* o = out + ((size_t)ib * mb * b + (size_t)i * b) * h + hh;

  if (i * b >= seq_len) {  // dead page: every entry invalid, table entry unread
    for (int r = tid; r < b; r += blockDim.x) o[(size_t)r * h] = 0.f;
    return;
  }
  const int page = block_tables[(size_t)ib * mb + i];
  const int n_valid = page >= 0 ? min(b, seq_len - i * b) : 0;
  for (int idx = tid; idx < b * d; idx += blockDim.x) {
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
  for (int idx = tid; idx < b * d; idx += blockDim.x) {
    const int t = idx / d;
    const int dd = idx - t * d;
    k_s[t * ld + dd] = k_s[t * ld + dd] / n_s[t];
  }
  __syncthreads();
  for (int idx = tid; idx < b * b; idx += blockDim.x) {
    const int r = idx / b;
    const int c = idx - r * b;
    float s = 0.f;
    if (r < n_valid && c < n_valid && r != c) {
      const float* kr = k_s + r * ld;
      const float* kc = k_s + c * ld;
      for (int dd = 0; dd < d; ++dd) s += kr[dd] * kc[dd];
    }
    c_s[r * (b + 1) + c] = s;
  }
  __syncthreads();
  for (int c = tid; c < b; c += blockDim.x) {  // newest row above p per column
    int last = -1;
    for (int r = 0; r < b; ++r)
      if (c_s[r * (b + 1) + c] > p_thresh) last = r;
    if (last >= 0) c_s[last * (b + 1) + c] = 0.f;
  }
  __syncthreads();
  for (int r = tid; r < b; r += blockDim.x) {
    float sum = 0.f;
    for (int c = 0; c < b; ++c) sum += c_s[r * (b + 1) + c];
    o[(size_t)r * h] = sum / (float)b;
  }
}
}  // namespace

extern "C" int lightning_redundancy_launch(const void* k_pool, const void* block_tables,
                                           const void* seq_lens, void* out, int n, int h,
                                           int d, int b, int mb, float p_thresh,
                                           void* stream) {
  const size_t smem = sizeof(float) * ((size_t)b * (d + 1) + (size_t)b * (b + 1) + b);
  cudaError_t err = zp_allow_smem(lightning_redundancy_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(mb, h, n);
  lightning_redundancy_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)k_pool, (const int*)block_tables, (const int*)seq_lens, (float*)out, h,
      d, b, mb, p_thresh);
  return (int)cudaGetLastError();
}
