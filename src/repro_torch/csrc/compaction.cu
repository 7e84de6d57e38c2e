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
// one thread block per stripe, (head hh, request i, layer l), does both:
// survivor rank j of head hh reads cache position src_cache[j] through the
// request's source table and lands in flat slot dest_flat[j]. Heads touch
// disjoint lanes of a slot and layers disjoint pools; requests touch
// disjoint blocks (below), so stripes are independent.
//
// Precondition, which the engine's compression planning guarantees
// (src/repro_torch/core/scheduler.py, plan_compression: `dest =
// r.blocks[:nb]`, or `fresh + r.blocks[n_prefix:][:nb - len(fresh)]`, which
// keeps block i at index i):
//  * rank j's destination is a slot of a fresh block, which no request of
//    the launch reads, or cache position j of the request's own table;
//  * a request writes no block that another request of the launch reads
//    (copy-on-write compacts a shared or cached source into fresh blocks);
//  * survivors are in cache order: src_cache[j] is ascending and distinct,
//    so src_cache[j] >= j.
// Padding rows and dropped slots write to the pools' sink page, which
// nothing reads.
//
// Why a chunk may be written before the stripe is read. Cut a stripe into
// chunks of `rows` consecutive ranks. Chunk c writes in place only cache
// positions [c rows, (c + 1) rows). A position p is read only by the rank
// j with src_cache[j] = p, and j <= p, so by a rank of chunk c or earlier.
// Chunk c's writes therefore wait only for the reads of chunks 0 .. c, and
// the reads of later chunks (positions >= (c + 1) rows) may be in flight
// while chunk c is written. No order holds between blocks, so a stripe is
// never split across blocks.
//
// Design. Each thread keeps one row of every chunk and one or more float4
// columns of it: with d / 4 <= kThreads a chunk is kThreads / (d / 4) rows
// (8 at d = 128, 32 at d = 32) and each thread moves one float4 of K and one
// of V a chunk; a wider row is a chunk of its own. A ring of kStages chunks
// in shared memory is filled by 16-byte cp.async, K and V together, with
// kStages - 1 chunks in flight while one is stored. cp.async rather than
// loads into registers: a block barrier waits for every earlier register
// load of the thread to be performed, so a register prefetch could not
// stay in flight across the barrier that orders chunk c's writes after its
// reads, while a cp.async group is waited for only by cp.async.wait_group.
// A row's source slot (a cache position, its table entry, one division by
// b) is computed once, a chunk ahead of its copies, so the table reads
// overlap the copies in flight. Its destination slot and its F value
// (F's source is the freshly scored new_f, not the pool, so it carries no
// hazard) travel through the ring by 8- and 4-byte cp.async beside the row
// and are written with it. Shared memory is 2 * kStages chunks of float4s plus
// 12 bytes a row a stage: 33 KB at any d <= 1024, whatever k is. The
// survivor positions and destination slots are read as the engine makes
// them (int64), so a call runs no conversion kernel. Rows are stored
// evict-first (st.global.cs): no rank of the launch reads them back, and
// they would otherwise push the reads still to come out of L2.
//
// Without a V pool (MLA's latent pool: its whole entries, 576 wide, move
// as K with h = 1) the V ring and its copies are left out.
//
// What bounds it on the card: memory. Per (layer, request, head) it moves
// k rows of d floats for K and for V (read once, written once) and k
// floats of F; it does no arithmetic.
#include "common.cuh"

namespace {
constexpr int kThreads = 256;
constexpr int kStages = 4;  // chunks in the ring: kStages - 1 in flight

// ranks a chunk: as many rows of d4 16-byte units as the block's threads
// cover
__host__ __device__ inline int zp_rows_per_chunk(int d4) {
  return d4 >= kThreads ? 1 : kThreads / d4;
}

// E: the storage type of K and V, whose bits are moved as 16-byte units
// (float4s); F is fp32 at either E. kV: whether there is a V pool (MLA's
// latent entries move as K alone, h = 1).
template <typename E, bool kV>
__global__ void __launch_bounds__(kThreads)
compaction_kernel(E* __restrict__ k_pool,                // (L, S, h, d), S = slots
                  E* __restrict__ v_pool,                // (L, S, h, d), or null
                  float* __restrict__ f_pool,            // (L, S, h)
                  const float* __restrict__ new_f,       // (L, n, T, h)
                  const int* __restrict__ src_bt,        // (n, mb), -1 padded
                  const long long* __restrict__ src_cache,  // (L, n, h, k)
                  const long long* __restrict__ dest_flat,  // (n, k)
                  int n, int h, int d, int b, int mb, int k, int S, int T) {
  constexpr int V = kVecOf<E>;
  extern __shared__ float4 smem4[];
  const int d4 = d / V;  // 16-byte units a row
  const int rows = zp_rows_per_chunk(d4);
  const int chunk4 = rows * d4;                 // float4s of one tensor a chunk
  // the ring: kStages chunks of K rows, of V rows (if any), of destination
  // slots and of F values
  float4* k_ring = smem4;
  float4* v_ring = k_ring + kStages * chunk4;  // == dst_ring without V
  long long* dst_ring = reinterpret_cast<long long*>(v_ring + (kV ? kStages * chunk4 : 0));
  float* f_ring = reinterpret_cast<float*>(dst_ring + kStages * rows);

  const int hh = blockIdx.x;
  const int i = blockIdx.y;
  const int l = blockIdx.z;
  const int tid = threadIdx.x;
  const long long* sc = src_cache + (((size_t)l * n + i) * h + hh) * k;
  const long long* dest = dest_flat + (size_t)i * k;
  const int* bt = src_bt + (size_t)i * mb;
  const float* nf = new_f + ((size_t)l * n + i) * T * h + hh;
  const size_t layer = (size_t)l * S * h * d;
  E* kl = k_pool + layer;
  E* vl = kV ? v_pool + layer : nullptr;
  float* fl = f_pool + (size_t)l * S * h + hh;

  // this thread's row of every chunk, and its first float4 column of it
  const int t = d4 >= kThreads ? 0 : tid / d4;
  const int c0 = d4 >= kThreads ? tid : tid - t * d4;
  const bool has_row = t < rows && c0 < d4;
  const bool leader = has_row && c0 == 0;     // moves the row's dest slot and F
  const int n_chunks = (k + rows - 1) / rows;

  // where the row of chunk c comes from: its cache position and the element
  // offset of (slot, hh) in a layer's pool; pos < 0 for no row
  struct Src {
    int pos;
    size_t off;
  };
  auto locate = [&](int c) {
    Src s{-1, 0};
    const int j = c * rows + t;
    if (has_row && c < n_chunks && j < k) {
      s.pos = (int)sc[j];
      const int e = s.pos / b;
      const int blk = max(bt[e], 0);  // -1 padding is clamped to page 0
      s.off = ((size_t)(blk * b + (s.pos - e * b)) * h + hh) * d;
    }
    return s;
  };
  auto issue = [&](int c, const Src& s) {
    if (s.pos >= 0) {
      const int st = c % kStages;
      float4* kd = k_ring + st * chunk4 + t * d4;
      float4* vd = v_ring + st * chunk4 + t * d4;
      for (int c4 = c0; c4 < d4; c4 += kThreads) {
        zp_cp_async16(kd + c4, kl + s.off + V * c4, true);
        if (kV) zp_cp_async16(vd + c4, vl + s.off + V * c4, true);
      }
      if (leader) {
        zp_cp_async8(dst_ring + st * rows + t, dest + c * rows + t);
        zp_cp_async4(f_ring + st * rows + t, nf + (size_t)s.pos * h, true);
      }
    }
    zp_cp_async_commit();  // one group a chunk, empty or not
  };

  for (int c = 0; c < kStages - 1; ++c) issue(c, locate(c));
  Src next = locate(kStages - 1);
  for (int c = 0; c < n_chunks; ++c) {
    zp_cp_async_wait<kStages - 2>();  // chunk c has landed for this thread
    __syncthreads();  // ... for every thread: chunks 0 .. c are read, and
                      // the buffer of chunk c - 1 is free
    const int j = c * rows + t;
    if (has_row && j < k) {
      const int st = c % kStages;
      const size_t dst = (size_t)dst_ring[st * rows + t];
      const float4* ks = k_ring + st * chunk4 + t * d4;
      const float4* vs = v_ring + st * chunk4 + t * d4;
      float4* kd = reinterpret_cast<float4*>(kl + (dst * h + hh) * d);
      for (int c4 = c0; c4 < d4; c4 += kThreads)  // evict-first: no rank reads them back
        __stcs(kd + c4, ks[c4]);
      if (kV) {
        float4* vd = reinterpret_cast<float4*>(vl + (dst * h + hh) * d);
        for (int c4 = c0; c4 < d4; c4 += kThreads) __stcs(vd + c4, vs[c4]);
      }
      if (leader) fl[dst * h] = f_ring[st * rows + t];
    }
    issue(c + kStages - 1, next);
    next = locate(c + kStages);
  }
  zp_cp_async_wait<0>();  // no copy outlives the block
}

template <typename E, bool kV>
int launch_kv(void* k_pool, void* v_pool, void* f_pool, const void* new_f, const void* src_bt,
              const void* src_cache, const void* dest_flat, int L, int n, int h, int d, int b,
              int mb, int k, int S, int T, void* stream) {
  const int d4 = d / kVecOf<E>;
  const size_t rows = zp_rows_per_chunk(d4);
  const size_t smem = kStages * ((kV ? 2 : 1) * sizeof(float4) * rows * d4 +
                                 (sizeof(long long) + sizeof(float)) * rows);
  cudaError_t err = zp_allow_smem(compaction_kernel<E, kV>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(h, n, L);
  compaction_kernel<E, kV><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (E*)k_pool, (E*)v_pool, (float*)f_pool, (const float*)new_f, (const int*)src_bt,
      (const long long*)src_cache, (const long long*)dest_flat, n, h, d, b, mb, k, S, T);
  return (int)cudaGetLastError();
}

// v_pool null: K and F only.
template <typename E>
int launch(void* k_pool, void* v_pool, void* f_pool, const void* new_f, const void* src_bt,
           const void* src_cache, const void* dest_flat, int L, int n, int h, int d, int b,
           int mb, int k, int S, int T, void* stream) {
  if (d % kVecOf<E> != 0 || b < 1) return (int)cudaErrorInvalidValue;
  if (v_pool == nullptr)
    return launch_kv<E, false>(k_pool, v_pool, f_pool, new_f, src_bt, src_cache, dest_flat, L,
                               n, h, d, b, mb, k, S, T, stream);
  return launch_kv<E, true>(k_pool, v_pool, f_pool, new_f, src_bt, src_cache, dest_flat, L, n,
                            h, d, b, mb, k, S, T, stream);
}
}  // namespace

// K and V in float ...
extern "C" int compaction_launch(void* k_pool, void* v_pool, void* f_pool, const void* new_f,
                                 const void* src_bt, const void* src_cache,
                                 const void* dest_flat, int L, int n, int h, int d, int b,
                                 int mb, int k, int S, int T, void* stream) {
  return launch<float>(k_pool, v_pool, f_pool, new_f, src_bt, src_cache, dest_flat, L, n, h, d,
                       b, mb, k, S, T, stream);
}

// ... or in bf16 (the same moves of 16-byte units, 8 elements each); F is
// fp32 either way.
extern "C" int compaction_launch_bf16(void* k_pool, void* v_pool, void* f_pool,
                                      const void* new_f, const void* src_bt,
                                      const void* src_cache, const void* dest_flat, int L,
                                      int n, int h, int d, int b, int mb, int k, int S, int T,
                                      void* stream) {
  return launch<zp_bf16>(k_pool, v_pool, f_pool, new_f, src_bt, src_cache, dest_flat, L, n, h,
                         d, b, mb, k, S, T, stream);
}

// ... or in fp16 (the same moves of 16-byte units, bit for bit); F is fp32.
extern "C" int compaction_launch_f16(void* k_pool, void* v_pool, void* f_pool,
                                     const void* new_f, const void* src_bt,
                                     const void* src_cache, const void* dest_flat, int L, int n,
                                     int h, int d, int b, int mb, int k, int S, int T,
                                     void* stream) {
  return launch<zp_f16>(k_pool, v_pool, f_pool, new_f, src_bt, src_cache, dest_flat, L, n, h,
                        d, b, mb, k, S, T, stream);
}
