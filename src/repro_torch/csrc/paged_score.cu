// Observation-window attention logits over paged keys (paper Alg. 1).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_score.py::paged_score_logits.
// It computes, per request, kv head and page, the logit tile
// Q_win . K_page^T / sqrt(d) for the g*w window queries that share the kv
// head, with the causal mask kpos <= seq_len - w + u and the validity mask
// kpos < seq_len; masked entries are -1e30. Output layout is the TPU
// kernel's: (n, h_kv, g, w, max_blocks * b), float32.
//
// One thread block per (page, kv head, request). A page at or past
// seq_len is written as all -1e30 without reading its table entry, so -1
// padding is never dereferenced, and key rows past seq_len are loaded as
// zeros, so stale or NaN pool data cannot reach an output.
//
// What bounds it on the card: memory. Each live page's keys are read once
// and each output written once; g*w = 16 query rows give 32 flops per key
// element, far below the H100's ridge point. The output is larger than
// the keys it reads (g*w/d of the key bytes times the table width), so the
// write of the masked tail dominates for short rows.
#include "common.cuh"

namespace {
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
paged_score_kernel(const float* __restrict__ q_win,         // (n, w, hq, d)
                   const float* __restrict__ k_pool,        // (N, b, hkv, d)
                   const int* __restrict__ block_tables,    // (n, mb)
                   const int* __restrict__ seq_lens,        // (n,)
                   float* __restrict__ out,                 // (n, hkv, g*w, mb*b)
                   int hkv, int g, int w, int d, int b, int mb, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;             // padded row: conflict-free column reads
  const int rows = g * w;           // row r = gi * w + u
  float* q_s = smem;                // rows * ld
  float* k_s = q_s + rows * ld;     // b * ld

  const int i = blockIdx.x;         // page column of the table
  const int h = blockIdx.y;
  const int ib = blockIdx.z;
  const int tid = threadIdx.x;
  const int hq = hkv * g;
  const int T = mb * b;
  const int seq_len = seq_lens[ib];
  float* o = out + ((size_t)ib * hkv + h) * rows * (size_t)T + (size_t)i * b;

  if (i * b >= seq_len) {  // dead page: fully masked, table entry unread
    for (int idx = tid; idx < rows * b; idx += blockDim.x) {
      const int r = idx / b;
      o[(size_t)r * T + (idx - r * b)] = ZP_NEG_INF;
    }
    return;
  }
  const int page = block_tables[(size_t)ib * mb + i];
  const int n_valid = min(b, seq_len - i * b);
  for (int idx = tid; idx < b * d; idx += blockDim.x) {
    const int t = idx / d;
    const int dd = idx - t * d;
    float kv = 0.f;
    if (t < n_valid && page >= 0) kv = k_pool[(((size_t)page * b + t) * hkv + h) * d + dd];
    k_s[t * ld + dd] = kv;
  }
  for (int idx = tid; idx < rows * d; idx += blockDim.x) {
    const int r = idx / d;
    const int dd = idx - r * d;
    const int gi = r / w;
    const int u = r - gi * w;
    q_s[r * ld + dd] = q_win[(((size_t)ib * w + u) * hq + (size_t)h * g + gi) * d + dd];
  }
  __syncthreads();
  for (int idx = tid; idx < rows * b; idx += blockDim.x) {
    const int r = idx / b;
    const int t = idx - r * b;
    const int u = r % w;
    const int kpos = i * b + t;
    const bool keep = kpos <= seq_len - w + u && kpos < seq_len && page >= 0;
    float s = 0.f;
    if (keep) {
      const float* qr = q_s + r * ld;
      const float* kr = k_s + t * ld;
      for (int dd = 0; dd < d; ++dd) s += qr[dd] * kr[dd];
    }
    o[(size_t)r * T + t] = keep ? s * scale : ZP_NEG_INF;
  }
}
}  // namespace

extern "C" int paged_score_launch(const void* q_win, const void* k_pool,
                                  const void* block_tables, const void* seq_lens, void* out,
                                  int n, int hkv, int g, int w, int d, int b, int mb,
                                  float scale, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)g * w + b) * (d + 1);
  cudaError_t err = zp_allow_smem(paged_score_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(mb, hkv, n);
  paged_score_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q_win, (const float*)k_pool, (const int*)block_tables,
      (const int*)seq_lens, (float*)out, hkv, g, w, d, b, mb, scale);
  return (int)cudaGetLastError();
}
