// dom_release: deadline-ordered release of the DOM early buffer, for Hopper.
//
// Replaces the Pallas kernel `dom_release_pallas` (body `_dom_release_kernel`,
// src/repro/kernels/dom_release.py:59). Given deadlines [n] f64, admitted
// [n] u8 and a clock `now`, it emits the ids of the released messages
// (admitted and deadline <= now) in stable deadline order, padded with -1,
// plus their count. A launch takes G such rows at once (deadlines,
// admitted and order [G, n], count [G]): the G consensus groups of a
// sharded epoch, which the reference runs under `jax.vmap`.
//
// Both routes sort masked 64-bit time keys (lanes not released take
// KEY_TOP and sort to the tail) by a stable LSD radix sort of 8-bit digits
// with the id as payload: stability orders ties by id without an id key.
// Bound on this card: memory, 9n bytes read and 4n written. At the data
// plane's size a call is bound instead by the latency of its passes (their
// barriers and exchanges); above it, by each pass block's serial phases.
//   small     n <= 16384 (the data plane's bucket of ~1e4 requests): one
//             launch of G clusters of up to 16 blocks (the fewest that
//             hold n), cluster g = row g. The
//             keys stay in registers (4 a thread) and move between passes
//             through the cluster's distributed shared memory; a pass whose
//             digit is the same for every key of the row is skipped.
//   onesweep  larger n: the shared onesweep sort (common.cuh), a segment a
//             row: one memset, an upfront histogram kernel and eight pass
//             kernels.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

// Small route: one cluster a row on neighbouring SMs (cluster g sorts row
// g; clusters share nothing), of the fewest blocks that hold n lanes --
// 1, 2, 4, 8 or CL_BLOCKS (`dom::cluster_blocks`), one instantiation of
// the kernel each, so its loops over blocks stay unrolled. Block b
// holds lanes [b * CL_TILE, (b + 1) * CL_TILE) in registers, ranks them
// by the pass's digit in its own shared memory, writes its digit counts
// into every block's shared memory (distributed shared memory: stores do
// not wait, where loads would), and stores each (key, id) pair, one
// 16-byte store, straight into the shared memory of the block that holds
// its next place; two cluster barriers a pass. Remote stores land only
// between barriers, so no block leaves while another still writes to it.
constexpr int CL_BLOCKS = 16;      // at most; past the portable 8:
                                   // small_route_ready
constexpr int CL_THREADS = 256;
constexpr int CL_ITEMS = 4;
constexpr int CL_TILE = CL_THREADS * CL_ITEMS;
static_assert(CL_THREADS == 256, "thread t handles digit t");
constexpr int SMALL_MAX = CL_BLOCKS * CL_TILE;         // 16384

struct ClusterStorage {
  ulonglong2 item[CL_TILE];                   // this block's (key, id)
  uint32_t counts[CL_BLOCKS][256];            // every block's digit counts
                                              // (the first NB in use)
  dom::RankStorage<CL_THREADS / 32> rank;
  uint32_t base[256];                         // place - rank, per digit
  uint32_t flags[CL_BLOCKS][3];               // every block's OR of
                                              // key ^ key[0], released count
  uint32_t varying[2];                        // this block's
  uint32_t released;
};

template <int NB>          // blocks of the cluster (its size at launch)
__global__ void __launch_bounds__(CL_THREADS, 1)
release_small(const double* __restrict__ d,
              const uint8_t* __restrict__ admitted, double now, int n,
              int32_t* __restrict__ order, int32_t* __restrict__ count) {
  __shared__ ClusterStorage s;
  cg::cluster_group cluster = cg::this_cluster();
  const int b = static_cast<int>(cluster.block_rank());
  const size_t row = static_cast<size_t>(blockIdx.x / NB) * n;
  d += row;
  admitted += row;
  order += row;
  count += blockIdx.x / NB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int first = warp * 32 * CL_ITEMS + lane;     // in the block's slice
  const int lo = b * CL_TILE;
  const int tile_len = max(0, min(CL_TILE, n - lo));
  const uint64_t key_now = dom::time_key(now);
  if (threadIdx.x == 0) {
    s.varying[0] = s.varying[1] = 0;
    s.released = 0;
  }
  const uint64_t k0 = n > 0 ? dom::release_key(d[0], admitted[0], key_now)
                            : 0ull;
  uint64_t key[CL_ITEMS];
  uint32_t id[CL_ITEMS];
  uint64_t diff = 0;
  uint32_t released = 0;
#pragma unroll
  for (int c = 0; c < CL_ITEMS; ++c) {
    const int e = first + c * 32;
    key[c] = dom::KEY_TOP;
    id[c] = static_cast<uint32_t>(lo + e);
    if (e < tile_len) {
      key[c] = dom::release_key(d[lo + e], admitted[lo + e], key_now);
      diff |= key[c] ^ k0;
      released += key[c] != dom::KEY_TOP;
    }
  }
  __syncthreads();
  const uint32_t dlo = __reduce_or_sync(dom::FULL,
                                        static_cast<uint32_t>(diff));
  const uint32_t dhi = __reduce_or_sync(dom::FULL,
                                        static_cast<uint32_t>(diff >> 32));
  released = __reduce_add_sync(dom::FULL, released);
  if (lane == 0) {
    if (dlo) atomicOr(&s.varying[0], dlo);
    if (dhi) atomicOr(&s.varying[1], dhi);
    if (released) atomicAdd(&s.released, released);
  }
  __syncthreads();
  if (threadIdx.x < NB) {
    uint32_t* to = cluster.map_shared_rank(&s, threadIdx.x)->flags[b];
    to[0] = s.varying[0];
    to[1] = s.varying[1];
    to[2] = s.released;
  }
  cluster.sync();
  uint64_t varying = 0;
  uint32_t total_released = 0;
  for (int r = 0; r < NB; ++r) {
    varying |= (static_cast<uint64_t>(s.flags[r][1]) << 32) | s.flags[r][0];
    total_released += s.flags[r][2];
  }
  uint32_t pos[CL_ITEMS];
  for (int pass = 0; pass < dom::PASSES; ++pass) {
    const int shift = 8 * pass;
    if (((varying >> shift) & 0xFFu) == 0u) continue;   // constant digit
    dom::rank_tile<CL_THREADS, CL_ITEMS>(key, shift, tile_len, s.rank, pos);
    const uint32_t mine = s.rank.total[threadIdx.x];   // thread t: digit t
    for (int r = 0; r < NB; ++r)
      cluster.map_shared_rank(&s, r)->counts[b][threadIdx.x] = mine;
    // every block's counts are in; every block has read its slice of the
    // last pass's exchange into registers
    cluster.sync();
    uint32_t all = 0, before = 0;
    for (int r = 0; r < NB; ++r) {
      const uint32_t c = s.counts[r][threadIdx.x];
      before += r < b ? c : 0u;
      all += c;
    }
    const uint32_t all_excl = dom::scan_digits<CL_THREADS / 32>(all, s.rank);
    s.base[threadIdx.x] = all_excl + before - s.rank.excl[threadIdx.x];
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CL_ITEMS; ++c) {
      if (first + c * 32 < tile_len) {
        const uint32_t g =
            s.base[static_cast<uint32_t>(key[c] >> shift) & 0xFFu] + pos[c];
        ClusterStorage* o = cluster.map_shared_rank(&s, g / CL_TILE);
        o->item[g % CL_TILE] = make_ulonglong2(key[c], id[c]);
      }
    }
    cluster.sync();                          // every place is written
#pragma unroll
    for (int c = 0; c < CL_ITEMS; ++c) {
      const int e = first + c * 32;
      if (e < tile_len) {
        const ulonglong2 it = s.item[e];
        key[c] = it.x;
        id[c] = static_cast<uint32_t>(it.y);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CL_ITEMS; ++c) {
    const int e = first + c * 32;
    if (e < tile_len)
      order[lo + e] = key[c] == dom::KEY_TOP ? -1 : static_cast<int32_t>(id[c]);
  }
  if (b == 0 && threadIdx.x == 0)
    *count = static_cast<int32_t>(total_released);
}

// A cluster of more than 8 blocks: allowed once per device.
cudaError_t small_route_ready() {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && ready[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(release_small<CL_BLOCKS>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && dev < 64) ready[dev] = true;
  return e;
}

// G clusters of the fewest blocks that hold n lanes.
cudaError_t launch_small(const double* d, const uint8_t* admitted, double now,
                         int n, int G, int32_t* order, int32_t* count,
                         cudaStream_t st) {
  const int nb = dom::cluster_blocks(n, CL_TILE, CL_BLOCKS);
  switch (nb) {
    case 1:
      return dom::launch_clusters(release_small<1>, 1, G, CL_THREADS, st, d,
                                  admitted, now, n, order, count);
    case 2:
      return dom::launch_clusters(release_small<2>, 2, G, CL_THREADS, st, d,
                                  admitted, now, n, order, count);
    case 4:
      return dom::launch_clusters(release_small<4>, 4, G, CL_THREADS, st, d,
                                  admitted, now, n, order, count);
    case 8:
      return dom::launch_clusters(release_small<8>, 8, G, CL_THREADS, st, d,
                                  admitted, now, n, order, count);
    default:
      return dom::launch_clusters(release_small<CL_BLOCKS>, CL_BLOCKS, G,
                                  CL_THREADS, st, d, admitted, now, n, order,
                                  count);
  }
}

long long onesweep_scratch_bytes(int n, int G) {
  return 24ll * n * G + 4ll * static_cast<long long>(dom::work_words(n, G));
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The layout constants the wrapper mirrors: [small route's largest n,
// onesweep tile, its scratch bytes at n and G rows (or -1 for n < 0)].
void dom_release_geometry(int n, int G, long long* out) {
  out[0] = SMALL_MAX;
  out[1] = dom::OS_TILE;
  out[2] = n < 0 || G < 1 ? -1 : onesweep_scratch_bytes(n, G);
}

// Small route: n <= SMALL_MAX, one launch of G clusters, no scratch.
// deadlines, admitted, order [G, n] row-major; count [G].
int dom_release_small_launch(const double* deadlines, const uint8_t* admitted,
                             double now, int n, int G, int32_t* order,
                             int32_t* count, void* stream) {
  if (n < 0 || n > SMALL_MAX || G < 1 || G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  DOM_CHECK(small_route_ready());
  DOM_CHECK(launch_small(deadlines, admitted, now, n, G, order, count,
                         static_cast<cudaStream_t>(stream)));
  return 0;
}

// Blocks of each small-route cluster at n lanes (the wrapper mirrors it).
int dom_release_small_blocks(int n) {
  return dom::cluster_blocks(n, CL_TILE, CL_BLOCKS);
}

// Onesweep route, G segments of n. Scratch (one buffer, `scratch_bytes`
// long): ka, kb [G * n] u64; va, vb [G * n] u32; the sort's work area.
int dom_release_onesweep_launch(const double* deadlines,
                                const uint8_t* admitted, double now, int n,
                                int G, int32_t* order, int32_t* count,
                                void* scratch, long long scratch_bytes,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || G < 1 || G > 65535 ||
      scratch_bytes < onesweep_scratch_bytes(n, G))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) {
    DOM_CHECK(cudaMemsetAsync(count, 0, sizeof(int32_t) * G, st));
    return 0;
  }
  const size_t lanes = static_cast<size_t>(n) * G;
  uint64_t* ka = static_cast<uint64_t*>(scratch);
  uint64_t* kb = ka + lanes;
  uint32_t* va = reinterpret_cast<uint32_t*>(kb + lanes);
  uint32_t* vb = va + lanes;
  uint32_t* work = vb + lanes;
  DOM_CHECK(dom::onesweep_sort(deadlines, admitted, now, ka, kb, va, vb,
                               order, count, n, G, work, st));
  return 0;
}

}  // extern "C"
