// KV-cache compaction (paper Alg. 4): move each request's surviving cache
// entries, per head, into its destination blocks, for K, V and the global
// score F, across all layers in one launch.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/compaction.py::compact_gather
// together with the scatter that the JAX engine's _compact_pool
// (src/repro/core/compression.py) does around it. The TPU kernel gathers
// one (d,) row per (head, destination rank) from a flat source slot; the
// caller then scatters the (k, h, d) result to the destination slots. Here
// one thread block per (head, request, layer) does both for its stripe:
// survivor rank j of head hh reads cache position src_cache[j] through the
// request's source table and lands in flat slot dest_flat[j].
//
// In place: the destination blocks are, in the common case, the first
// budget blocks of the request's own source table, and the survivor at rank
// j lies at a cache position >= j, so a write can land on a slot that a
// lower rank still has to read. The block therefore reads all k survivors
// of its stripe into shared memory, synchronises, and only then writes
// (K first, then V, through the same buffer). Heads touch disjoint lanes
// and layers disjoint pools, so stripes are independent.
//
// Precondition (the block manager's copy-on-write guarantees it): a request
// writes only blocks that no other request of the launch reads. A block
// that another request shares, or that the prefix cache holds, is never a
// destination: such a request compacts into fresh blocks. Padding rows and
// dropped slots write to the pools' sink page, which nothing reads.
//
// F's source is the freshly scored (L, n, T, h) tensor, not the pool, so it
// is gathered and written directly.
//
// What bounds it on the card: memory. Per (layer, request, head) it moves
// k rows of d floats for K and for V (read once, written once) and k
// floats of F; it does no arithmetic.
#include "common.cuh"

namespace {
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
compaction_kernel(float* __restrict__ k_pool,            // (L, S, h, d), S = slots
                  float* __restrict__ v_pool,            // (L, S, h, d)
                  float* __restrict__ f_pool,            // (L, S, h)
                  const float* __restrict__ new_f,       // (L, n, T, h)
                  const int* __restrict__ src_bt,        // (n, mb), -1 padded
                  const int* __restrict__ src_cache,     // (L, n, h, k)
                  const int* __restrict__ dest_flat,     // (n, k)
                  int n, int h, int d, int b, int mb, int k, int S, int T) {
  extern __shared__ float smem[];
  float* buf = smem;                // k * d
  int* slot_s = (int*)(buf + (size_t)k * d);  // k source slots

  const int hh = blockIdx.x;
  const int i = blockIdx.y;
  const int l = blockIdx.z;
  const int* sc = src_cache + (((size_t)l * n + i) * h + hh) * k;
  const int* dest = dest_flat + (size_t)i * k;
  const int* bt = src_bt + (size_t)i * mb;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const int pos = sc[j];
    const int blk = max(bt[pos / b], 0);  // -1 padding is clamped to page 0
    slot_s[j] = blk * b + pos % b;
  }
  __syncthreads();
  float* pools[2] = {k_pool, v_pool};
  for (int which = 0; which < 2; ++which) {
    float* pool = pools[which] + (size_t)l * S * h * d;
    for (int idx = threadIdx.x; idx < k * d; idx += blockDim.x) {
      const int j = idx / d;
      const int dd = idx - j * d;
      buf[idx] = pool[((size_t)slot_s[j] * h + hh) * d + dd];
    }
    __syncthreads();  // every survivor of the stripe is read before any write
    for (int idx = threadIdx.x; idx < k * d; idx += blockDim.x) {
      const int j = idx / d;
      const int dd = idx - j * d;
      pool[((size_t)dest[j] * h + hh) * d + dd] = buf[idx];
    }
    __syncthreads();  // buf is reused for V
  }
  const float* nf = new_f + ((size_t)l * n + i) * T * h;
  float* fp = f_pool + (size_t)l * S * h;
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    fp[(size_t)dest[j] * h + hh] = nf[(size_t)sc[j] * h + hh];
}
}  // namespace

extern "C" int compaction_launch(void* k_pool, void* v_pool, void* f_pool, const void* new_f,
                                 const void* src_bt, const void* src_cache,
                                 const void* dest_flat, int L, int n, int h, int d, int b,
                                 int mb, int k, int S, int T, void* stream) {
  const size_t smem = sizeof(float) * (size_t)k * d + sizeof(int) * (size_t)k;
  cudaError_t err = zp_allow_smem(compaction_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(h, n, L);
  compaction_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (float*)k_pool, (float*)v_pool, (float*)f_pool, (const float*)new_f, (const int*)src_bt,
      (const int*)src_cache, (const int*)dest_flat, n, h, d, b, mb, k, S, T);
  return (int)cudaGetLastError();
}
