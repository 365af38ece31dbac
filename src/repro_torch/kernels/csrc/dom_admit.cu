// dom_admit: DOM early-buffer admission per receiver, for Hopper.
//
// Replaces the Pallas kernel `dom_admit_pallas` (body `_dom_admit_kernel`,
// src/repro/kernels/dom_admit.py:149). For each receiver r it replays the
// 2N-event stream -- a test of message i at its arrival a_i and a watermark
// update at max(d_i, a_i) -- in (time, aux) order, with
// aux = (class * N + i) * 2 + kind and class 0 when d_i > a_i (else 1), and
// admits i iff d_i exceeds the exclusive prefix max of the finite deadlines
// before its test and a_i is finite.
//
// Bound on this card: memory, at least 8N + 8RN bytes read and RN written.
// At the data plane's size a call is bound instead by the latency of its
// dependent steps. Two routes, by N (`admit_route` in the wrapper):
//
//   small     N <= 16384 (the data plane's bucket of ~1e4 requests): one
//             launch, R clusters of 16 blocks, cluster r = receiver r, every
//             stage on chip. It sorts the N updates only: placed in aux
//             order (class 0 in message order, then class 1), a stable LSD
//             radix sort on the time key alone gives (time, aux) order. The
//             keys are first compressed (finite keys less the receiver's
//             least, +inf one above the largest), so only the 8-bit passes
//             the compressed span needs run; keys move between blocks
//             through distributed shared memory as in dom_release's small
//             route. Each test then finds by binary search how many updates
//             precede it -- every update with a smaller key, and at an equal
//             key every class-0 update and the class-1 updates of earlier
//             messages -- first over the 16 blocks' first updates, then
//             inside one block's slice, read through distributed shared
//             memory, and compares d_i with the prefix max there. No test
//             event is sorted and no verdict is scattered back.
//   onesweep  larger N, over tiles x receivers, every stage multi-block:
//     1. place   the 2N events directly in aux order, with no sort: first
//                the updates with d > a in message order, then for each
//                message its test followed by its update when d <= a. One
//                integer exclusive scan of the (d > a) flags gives every
//                position.
//     2. sort    stably on the time key alone (the shared onesweep radix
//                sort of common.cuh, a segment per receiver): stability
//                turns aux order into (time, aux) order. It moves about 24
//                bytes per event and pass, over 2RN events.
//     3. decide  an inclusive prefix max of the candidate watermark keys --
//                a tile scan plus an exclusive scan of the tile carries,
//                since blocks run in no order -- shifted by one, then each
//                test scatters its verdict back to message order (the TPU's
//                second bitonic sort existed only to avoid that gather).
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

using dom::ITEMS;
using dom::KEY_INF;
using dom::THREADS;
using dom::TILE;
using dom::time_key;
using dom::umax64;

namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// small route: one 16-block cluster per receiver
// ---------------------------------------------------------------------------
// Block b of cluster r holds messages [b * AD_TILE, (b + 1) * AD_TILE) at
// receiver r and, once sorted, the same slice of r's update order. Remote
// stores land only between cluster barriers, and no block leaves while
// another may still read or write its shared memory.
constexpr int AD_BLOCKS = 16;      // past the portable 8: admit_small_ready
constexpr int AD_THREADS = 256;
constexpr int AD_WARPS = AD_THREADS / 32;
constexpr int AD_ITEMS = 4;
constexpr int AD_TILE = AD_THREADS * AD_ITEMS;          // 1024
static_assert(AD_THREADS == 256, "thread t handles digit t");
constexpr int SMALL_MAX = AD_BLOCKS * AD_TILE;          // 16384
// An update's aux: class * CLASS1 + message. A test of message i sorts
// after every update whose (key, aux) is below (key(a_i), CLASS1 + i).
constexpr uint32_t CLASS1 = SMALL_MAX;

struct AdmitStorage {
  ulonglong2 item[AD_TILE];               // (compressed key, aux) of the slice
  union {
    uint32_t counts[AD_BLOCKS][256];      // sort: every block's digit counts
    uint64_t pmax[AD_TILE];               // then: the slice's prefix max
  } u;
  dom::RankStorage<AD_WARPS> rank;
  uint32_t base[256];                     // place - rank, per digit
  // slot q is written by block q of the cluster
  uint64_t key_lo[AD_BLOCKS];             // least finite update key
  uint64_t key_hi[AD_BLOCKS];             // largest finite update key
  uint64_t bits[AD_BLOCKS];               // OR of the compressed keys
  uint64_t slice_max[AD_BLOCKS];          // largest candidate of the slice
  ulonglong2 head[AD_BLOCKS];             // first sorted update of the slice
  uint32_t early[AD_BLOCKS];              // class-0 messages of the slice
  // this block's own
  uint64_t carry[AD_BLOCKS];              // prefix max of the slices before
  uint64_t w64[3][AD_WARPS];              // warp partials
  uint32_t w32[AD_WARPS];
};

__device__ __forceinline__ uint64_t umin64(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint64_t warp_min64(uint64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = umin64(v, __shfl_xor_sync(dom::FULL, v, o));
  return v;
}

__device__ __forceinline__ uint64_t warp_max64(uint64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = umax64(v, __shfl_xor_sync(dom::FULL, v, o));
  return v;
}

__device__ __forceinline__ uint64_t warp_or64(uint64_t v) {
  const uint32_t lo = __reduce_or_sync(dom::FULL, static_cast<uint32_t>(v));
  const uint32_t hi =
      __reduce_or_sync(dom::FULL, static_cast<uint32_t>(v >> 32));
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// Update u precedes the test (key_a, thr): a smaller time key, or the same
// key and a smaller aux. Keys are decompressed first.
struct Decompress {
  uint64_t least;      // the receiver's least finite update key
  uint64_t inf;        // the compressed key of +inf
  __device__ __forceinline__ uint64_t operator()(uint64_t c) const {
    return c == inf ? KEY_INF : c + least;
  }
};

__device__ __forceinline__ bool precedes(ulonglong2 u, const Decompress& dk,
                                         uint64_t key_a, uint32_t thr) {
  const uint64_t k = dk(u.x);
  return k < key_a || (k == key_a && static_cast<uint32_t>(u.y) < thr);
}

__global__ void __cluster_dims__(AD_BLOCKS, 1, 1)
__launch_bounds__(AD_THREADS, 1)
admit_small(const double* __restrict__ d, const double* __restrict__ a,
            int n, int R, uint8_t* __restrict__ admitted) {
  __shared__ AdmitStorage s;
  cg::cluster_group cluster = cg::this_cluster();
  // no block writes another's shared memory before every block has started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int b = static_cast<int>(cluster.block_rank());
  const int r = static_cast<int>(blockIdx.x) / AD_BLOCKS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lo = b * AD_TILE;
  const int tile_len = max(0, min(AD_TILE, n - lo));
  const int n_slices = (n + AD_TILE - 1) / AD_TILE;

  // 1. load: thread t holds messages lo + 4t .. lo + 4t + 3
  const int mine = threadIdx.x * AD_ITEMS;
  uint64_t kd[AD_ITEMS], ka[AD_ITEMS];
  uint32_t early = 0;                        // bit c: message c is class 0
  uint64_t fmin = ~0ull, fmax = 0;
#pragma unroll
  for (int c = 0; c < AD_ITEMS; ++c) {
    kd[c] = ka[c] = KEY_INF;
    if (mine + c < tile_len) {
      const int i = lo + mine + c;
      kd[c] = time_key(d[i]);
      ka[c] = time_key(a[static_cast<size_t>(i) * R + r]);
      early |= static_cast<uint32_t>(kd[c] > ka[c]) << c;
      const uint64_t u = umax64(kd[c], ka[c]);
      if (u != KEY_INF) {
        fmin = umin64(fmin, u);
        fmax = umax64(fmax, u);
      }
    }
  }
  const uint32_t cnt = __popc(early);
  uint32_t incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(dom::FULL, incl, o);
    if (lane >= o) incl += y;
  }
  fmin = warp_min64(fmin);
  fmax = warp_max64(fmax);
  if (lane == 31) s.w32[warp] = incl;
  if (lane == 0) {
    s.w64[0][warp] = fmin;
    s.w64[1][warp] = fmax;
  }
  __syncthreads();
  uint32_t before = incl - cnt;              // class-0 messages before mine
  uint32_t slice_early = 0;
  uint64_t slice_lo = ~0ull, slice_hi = 0;
#pragma unroll
  for (int w = 0; w < AD_WARPS; ++w) {
    const uint32_t v = s.w32[w];
    before += w < warp ? v : 0u;
    slice_early += v;
    slice_lo = umin64(slice_lo, s.w64[0][w]);
    slice_hi = umax64(slice_hi, s.w64[1][w]);
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");

  // 2. exchange the slice's class-0 count and finite key range
  if (threadIdx.x < AD_BLOCKS) {
    AdmitStorage* o = cluster.map_shared_rank(&s, threadIdx.x);
    o->key_lo[b] = slice_lo;
    o->key_hi[b] = slice_hi;
    o->early[b] = slice_early;
  }
  cluster.sync();
  uint32_t early_total = 0;
  uint64_t least = ~0ull, largest = 0;
#pragma unroll
  for (int q = 0; q < AD_BLOCKS; ++q) {
    const uint32_t v = s.early[q];
    before += q < b ? v : 0u;
    early_total += v;
    least = umin64(least, s.key_lo[q]);
    largest = umax64(largest, s.key_hi[q]);
  }
  // no finite key: every update takes the compressed key 0
  const Decompress dk{least, least == ~0ull ? 0ull : largest - least + 1};

  // place the updates in aux order, compressed keys, in the block that
  // holds their place
  uint64_t bits = 0;
#pragma unroll
  for (int c = 0; c < AD_ITEMS; ++c) {
    if (mine + c < tile_len) {
      const uint32_t i = static_cast<uint32_t>(lo + mine + c);
      const uint64_t u = umax64(kd[c], ka[c]);
      const uint64_t key = u == KEY_INF ? dk.inf : u - least;
      bits |= key;
      uint32_t pos, aux;
      if ((early >> c) & 1u) {
        pos = before++;
        aux = i;
      } else {
        pos = early_total + i - before;
        aux = CLASS1 + i;
      }
      cluster.map_shared_rank(&s, static_cast<int>(pos / AD_TILE))
          ->item[pos % AD_TILE] = make_ulonglong2(key, aux);
    }
  }
  bits = warp_or64(bits);
  if (lane == 0) s.w64[2][warp] = bits;
  __syncthreads();
  if (threadIdx.x < AD_BLOCKS) {
    uint64_t v = 0;
#pragma unroll
    for (int w = 0; w < AD_WARPS; ++w) v |= s.w64[2][w];
    cluster.map_shared_rank(&s, threadIdx.x)->bits[b] = v;
  }
  cluster.sync();                            // every update is placed
  // the compressed keys hold 0 (the least finite key, or every key when
  // none is finite): a digit varies iff some key has it non-zero
  uint64_t varying = 0;
#pragma unroll
  for (int q = 0; q < AD_BLOCKS; ++q) varying |= s.bits[q];

  // 3. sort: stable LSD passes over the digits that vary, as in
  // dom_release's release_small (warp-striped items in registers)
  const int first = warp * 32 * AD_ITEMS + lane;
  uint64_t key[AD_ITEMS];
  uint32_t aux[AD_ITEMS];
#pragma unroll
  for (int c = 0; c < AD_ITEMS; ++c) {
    const int e = first + c * 32;
    key[c] = dom::KEY_TOP;
    aux[c] = 0;
    if (e < tile_len) {
      const ulonglong2 it = s.item[e];
      key[c] = it.x;
      aux[c] = static_cast<uint32_t>(it.y);
    }
  }
  uint32_t pos[AD_ITEMS];
  for (int pass = 0; pass < dom::PASSES; ++pass) {
    const int shift = 8 * pass;
    if (((varying >> shift) & 0xFFu) == 0u) continue;   // constant digit
    dom::rank_tile<AD_THREADS, AD_ITEMS>(key, shift, tile_len, s.rank, pos);
    const uint32_t count = s.rank.total[threadIdx.x];   // thread t: digit t
    for (int q = 0; q < AD_BLOCKS; ++q)
      cluster.map_shared_rank(&s, q)->u.counts[b][threadIdx.x] = count;
    // every block's counts are in; every block has read its slice of the
    // last exchange into registers
    cluster.sync();
    uint32_t all = 0, below = 0;
    for (int q = 0; q < AD_BLOCKS; ++q) {
      const uint32_t v = s.u.counts[q][threadIdx.x];
      below += q < b ? v : 0u;
      all += v;
    }
    const uint32_t all_excl = dom::scan_digits<AD_WARPS>(all, s.rank);
    s.base[threadIdx.x] = all_excl + below - s.rank.excl[threadIdx.x];
    __syncthreads();
#pragma unroll
    for (int c = 0; c < AD_ITEMS; ++c) {
      if (first + c * 32 < tile_len) {
        const uint32_t g =
            s.base[static_cast<uint32_t>(key[c] >> shift) & 0xFFu] + pos[c];
        cluster.map_shared_rank(&s, static_cast<int>(g / AD_TILE))
            ->item[g % AD_TILE] = make_ulonglong2(key[c], aux[c]);
      }
    }
    cluster.sync();                          // every place is written
#pragma unroll
    for (int c = 0; c < AD_ITEMS; ++c) {
      const int e = first + c * 32;
      if (e < tile_len) {
        const ulonglong2 it = s.item[e];
        key[c] = it.x;
        aux[c] = static_cast<uint32_t>(it.y);
      }
    }
  }
  // s.item holds the slice of the updates in (time, aux) order; the
  // counts are no longer read or written, so pmax takes their place

  // 4. prefix max of the candidates (an update's finite deadline key, else
  // 0), thread-contiguous: thread t takes sorted places 4t .. 4t + 3
  uint64_t run[AD_ITEMS];
  uint64_t m = 0;
#pragma unroll
  for (int c = 0; c < AD_ITEMS; ++c) {
    uint64_t cand = 0;
    if (mine + c < tile_len) {
      const uint32_t j = static_cast<uint32_t>(s.item[mine + c].y) %
                         CLASS1;
      cand = time_key(d[j]);
      cand = cand == KEY_INF ? 0ull : cand;
    }
    m = umax64(m, cand);
    run[c] = m;
  }
  uint64_t scan = m;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t y = __shfl_up_sync(dom::FULL, scan, o);
    if (lane >= o) scan = umax64(scan, y);
  }
  uint64_t carry = __shfl_up_sync(dom::FULL, scan, 1);
  carry = lane == 0 ? 0ull : carry;
  if (lane == 31) s.w64[0][warp] = scan;
  __syncthreads();
  uint64_t slice_max = 0;
#pragma unroll
  for (int w = 0; w < AD_WARPS; ++w) {
    const uint64_t v = s.w64[0][w];
    carry = w < warp ? umax64(carry, v) : carry;
    slice_max = umax64(slice_max, v);
  }
#pragma unroll
  for (int c = 0; c < AD_ITEMS; ++c)
    if (mine + c < tile_len) s.u.pmax[mine + c] = umax64(carry, run[c]);
  if (threadIdx.x < AD_BLOCKS) {
    AdmitStorage* o = cluster.map_shared_rank(&s, threadIdx.x);
    o->slice_max[b] = slice_max;
    o->head[b] = tile_len > 0 ? s.item[0] : make_ulonglong2(0ull, 0ull);
  }
  cluster.sync();                            // every prefix max is written
  if (threadIdx.x < AD_BLOCKS) {
    uint64_t v = 0;
    for (int q = 0; q < static_cast<int>(threadIdx.x); ++q)
      v = umax64(v, s.slice_max[q]);
    s.carry[threadIdx.x] = v;
  }
  __syncthreads();

  // 5. decide: count_i = the updates that precede test i; i is admitted iff
  // a_i is finite and key(d_i) exceeds the prefix max at count_i - 1 (0
  // for none). The four searches of a thread run side by side.
  uint32_t thr[AD_ITEMS];
  int k[AD_ITEMS];
#pragma unroll
  for (int c = 0; c < AD_ITEMS; ++c) {
    thr[c] = CLASS1 + static_cast<uint32_t>(lo + mine + c);
    k[c] = 0;
  }
  // slices whose first update precedes the test (a prefix of them)
#pragma unroll
  for (int step = AD_BLOCKS; step > 0; step >>= 1) {
#pragma unroll
    for (int c = 0; c < AD_ITEMS; ++c) {
      if (ka[c] != KEY_INF && k[c] + step <= n_slices &&
          precedes(s.head[k[c] + step - 1], dk, ka[c], thr[c]))
        k[c] += step;
    }
  }
  const ulonglong2* slice[AD_ITEMS];
  int len[AD_ITEMS], at[AD_ITEMS];
#pragma unroll
  for (int c = 0; c < AD_ITEMS; ++c) {
    const int q = max(k[c] - 1, 0);
    slice[c] = cluster.map_shared_rank(&s.item[0], q);
    len[c] = k[c] > 0 ? min(AD_TILE, n - q * AD_TILE) : 0;
    at[c] = 0;                               // place 0 precedes (k > 0)
  }
  // inside the last such slice: the last update that precedes the test
#pragma unroll
  for (int step = AD_TILE / 2; step > 0; step >>= 1) {
#pragma unroll
    for (int c = 0; c < AD_ITEMS; ++c) {
      if (at[c] + step < len[c] &&
          precedes(slice[c][at[c] + step], dk, ka[c], thr[c]))
        at[c] += step;
    }
  }
#pragma unroll
  for (int c = 0; c < AD_ITEMS; ++c) {
    if (mine + c < tile_len) {
      uint64_t mark = 0;
      if (k[c] > 0) {
        const int q = k[c] - 1;
        mark = umax64(s.carry[q],
                      cluster.map_shared_rank(&s.u.pmax[0], q)[at[c]]);
      }
      const bool ok = ka[c] != KEY_INF && kd[c] > mark;
      admitted[static_cast<size_t>(lo + mine + c) * R + r] = ok ? 1 : 0;
    }
  }
  cluster.sync();                // no block leaves while another reads it
}

// A cluster of more than 8 blocks: allowed once per device. Internal
// linkage, so that no other library's flag stands in for this one.
cudaError_t admit_small_ready() {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && ready[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(admit_small,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && dev < 64) ready[dev] = true;
  return e;
}

// ---------------------------------------------------------------------------
// onesweep route
// ---------------------------------------------------------------------------
// Per tile of messages: the number with d > a at receiver r.
__global__ void admit_count_early(const double* __restrict__ d,
                                  const double* __restrict__ a, int n, int R,
                                  uint32_t* __restrict__ tile_count, int ntm) {
  __shared__ uint32_t smem[THREADS];
  const int tile = blockIdx.x;
  const int r = blockIdx.y;
  uint32_t c = 0;
  for (int j = threadIdx.x; j < TILE; j += THREADS) {
    const int i = tile * TILE + j;
    if (i < n)
      c += time_key(d[i]) > time_key(a[static_cast<size_t>(i) * R + r]);
  }
  const uint32_t ex = dom::block_exclusive_sum<THREADS>(c, smem);
  if (threadIdx.x == THREADS - 1)
    tile_count[static_cast<size_t>(r) * ntm + tile] = ex + c;
}

// Writes the 2N events of receiver r in aux order. `tile_base` is the
// exclusive scan of admit_count_early's counts, `early_total` their sums.
// Event value: message * 2 + kind (0 test, 1 update).
__global__ void admit_place(const double* __restrict__ d,
                            const double* __restrict__ a, int n, int R,
                            const uint32_t* __restrict__ tile_base, int ntm,
                            const uint32_t* __restrict__ early_total,
                            uint64_t* __restrict__ keys,
                            uint32_t* __restrict__ vals) {
  __shared__ uint32_t smem[THREADS];
  const int tile = blockIdx.x;
  const int r = blockIdx.y;
  const int first = tile * TILE + threadIdx.x * ITEMS;  // thread-contiguous
  uint64_t kd[ITEMS], ka[ITEMS];
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = first + k;
    kd[k] = 0;
    ka[k] = 0;
    if (i < n) {
      kd[k] = time_key(d[i]);
      ka[k] = time_key(a[static_cast<size_t>(i) * R + r]);
      c += kd[k] > ka[k];
    }
  }
  uint32_t before = tile_base[static_cast<size_t>(r) * ntm + tile] +
                    dom::block_exclusive_sum<THREADS>(c, smem);
  const uint32_t total = early_total[r];
  const size_t seg = static_cast<size_t>(r) * 2 * n;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = first + k;
    if (i >= n) break;
    const uint32_t i2 = 2u * static_cast<uint32_t>(i);
    const uint32_t test_pos = total + i2 - before;
    keys[seg + test_pos] = ka[k];
    vals[seg + test_pos] = i2;
    if (kd[k] > ka[k]) {                     // class 0: update at d
      keys[seg + before] = kd[k];
      vals[seg + before] = i2 + 1u;
      ++before;
    } else {                                 // class 1: update at a
      keys[seg + test_pos + 1] = ka[k];
      vals[seg + test_pos + 1] = i2 + 1u;
    }
  }
}

// Candidate watermark of a sorted event: an update's finite deadline key,
// else 0 (below every time key).
__device__ __forceinline__ uint64_t candidate(uint32_t v,
                                              const double* __restrict__ d) {
  if ((v & 1u) == 0u) return 0ull;
  const uint64_t k = time_key(d[v >> 1]);
  return k == KEY_INF ? 0ull : k;
}

__global__ void admit_tile_max(const uint32_t* __restrict__ vals,
                               const double* __restrict__ d, int len,
                               uint64_t* __restrict__ tile_max, int nte) {
  __shared__ uint64_t smem[THREADS];
  const int tile = blockIdx.x;
  const size_t seg = static_cast<size_t>(blockIdx.y) * len;
  uint64_t m = 0;
  for (int j = threadIdx.x; j < TILE; j += THREADS) {
    const int e = tile * TILE + j;
    if (e < len) m = umax64(m, candidate(vals[seg + e], d));
  }
  const uint64_t ex = dom::block_exclusive_max<THREADS>(m, smem);
  if (threadIdx.x == THREADS - 1)
    tile_max[static_cast<size_t>(blockIdx.y) * nte + tile] = umax64(ex, m);
}

// `tile_carry` holds the exclusive max-scan of admit_tile_max's values.
__global__ void admit_decide(const uint64_t* __restrict__ keys,
                             const uint32_t* __restrict__ vals,
                             const double* __restrict__ d, int n, int R,
                             const uint64_t* __restrict__ tile_carry, int nte,
                             uint8_t* __restrict__ admitted) {
  __shared__ uint64_t smem[THREADS];
  const int tile = blockIdx.x;
  const int r = blockIdx.y;
  const int len = 2 * n;
  const size_t seg = static_cast<size_t>(r) * len;
  const int first = tile * TILE + threadIdx.x * ITEMS;  // thread-contiguous
  uint64_t cand[ITEMS];
  uint32_t val[ITEMS];
  uint64_t m = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int e = first + k;
    val[k] = e < len ? vals[seg + e] : 1u;   // out of range: no test
    cand[k] = e < len ? candidate(val[k], d) : 0ull;
    m = umax64(m, cand[k]);
  }
  uint64_t run = umax64(tile_carry[static_cast<size_t>(r) * nte + tile],
                        dom::block_exclusive_max<THREADS>(m, smem));
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int e = first + k;
    if (e < len && (val[k] & 1u) == 0u) {    // a test: run is its watermark
      const uint32_t i = val[k] >> 1;
      const bool ok = time_key(d[i]) > run && keys[seg + e] != KEY_INF;
      admitted[static_cast<size_t>(i) * R + r] = ok ? 1 : 0;
    }
    run = umax64(run, cand[k]);
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The small route's largest n (the wrapper mirrors it).
int dom_admit_small_max() { return SMALL_MAX; }

// Clusters of the small route resident at once on this device, for R
// receivers (cudaOccupancyMaxActiveClusters); clusters past it wait.
int dom_admit_small_clusters(int R, int* clusters) {
  DOM_CHECK(admit_small_ready());
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(AD_BLOCKS * (R > 1 ? R : 1));
  cfg.blockDim = dim3(AD_THREADS);
  DOM_CHECK(cudaOccupancyMaxActiveClusters(clusters, admit_small, &cfg));
  return 0;
}

// Small route: n <= SMALL_MAX; deadlines [n] f64, arrivals [n, R] f64
// (row-major), admitted [n, R] u8. One launch, no scratch.
int dom_admit_small_launch(const double* deadlines, const double* arrivals,
                           int n, int R, uint8_t* admitted, void* stream) {
  if (n < 0 || n > SMALL_MAX || R < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || R == 0) return 0;
  DOM_CHECK(admit_small_ready());
  admit_small<<<AD_BLOCKS * R, AD_THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(deadlines, arrivals, n,
                                                     R, admitted);
  DOM_CHECK_LAUNCH();
  return 0;
}

// Onesweep route, same arguments. Scratch: ka, kb [R * 2n] u64; va, vb
// [R * 2n] u32; the sort's work area [dom::work_words(2n, R)] u32;
// tile_count [R * ceil(n / TILE)] u32; early_total [R] u32;
// tile_max [R * ceil(2n / TILE)] u64.
int dom_admit_onesweep_launch(const double* deadlines, const double* arrivals,
                              int n, int R, uint8_t* admitted, uint64_t* ka,
                              uint64_t* kb, uint32_t* va, uint32_t* vb,
                              uint32_t* work, uint32_t* tile_count,
                              uint32_t* early_total, uint64_t* tile_max,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0 || R == 0) return 0;
  const int ntm = dom::n_tiles(n);
  const int len = 2 * n;
  const int nte = dom::n_tiles(len);
  admit_count_early<<<dim3(ntm, R), THREADS, 0, st>>>(deadlines, arrivals, n,
                                                      R, tile_count, ntm);
  DOM_CHECK_LAUNCH();
  dom::exclusive_sum_segments<<<R, dom::SCAN_THREADS, 0, st>>>(
      tile_count, ntm, early_total);
  DOM_CHECK_LAUNCH();
  admit_place<<<dim3(ntm, R), THREADS, 0, st>>>(
      deadlines, arrivals, n, R, tile_count, ntm, early_total, ka, va);
  DOM_CHECK_LAUNCH();
  DOM_CHECK(dom::onesweep_sort(nullptr, nullptr, 0.0, ka, kb, va, vb,
                               nullptr, nullptr, len, R, work, st));
  admit_tile_max<<<dim3(nte, R), THREADS, 0, st>>>(va, deadlines, len,
                                                   tile_max, nte);
  DOM_CHECK_LAUNCH();
  dom::exclusive_max_segments<<<R, dom::SCAN_THREADS, 0, st>>>(tile_max, nte);
  DOM_CHECK_LAUNCH();
  admit_decide<<<dim3(nte, R), THREADS, 0, st>>>(ka, va, deadlines, n, R,
                                                 tile_max, nte, admitted);
  DOM_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
