// Shared device code of the DOM kernels: the 64-bit time key, block scans,
// the stable rank of a tile by one 8-bit digit, and the onesweep LSD radix
// sort that both kernels run above one block's worth of keys.
//
// Every comparison in these kernels is an integer comparison of time keys.
// The float64 times enter only through `time_key`, a bit cast, so the
// kernels do no floating-point arithmetic and have no FMA-contraction
// question.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Everything here has internal linkage: both kernel libraries include this
// header and load into one process, and a static local of a template or
// inline function with external linkage would be one object shared by
// both (GCC's unique symbols), set by one library for the other's kernels.
namespace dom {
namespace {

// ---------------------------------------------------------------------------
// time keys
// ---------------------------------------------------------------------------
// key(+inf): every non-finite time (the +inf "dropped" convention) maps here.
constexpr uint64_t KEY_INF = 0xFFF0000000000000ull;
// Strictly above every time key: masked and padding lanes.
constexpr uint64_t KEY_TOP = 0xFFFFFFFFFFFFFFFFull;

// Order-preserving unsigned key of a double: unsigned comparison of keys is
// the float64 order for non-NaN inputs; +0.0 and -0.0 share one key, and
// every non-finite input takes KEY_INF.
__device__ __forceinline__ uint64_t time_key(double x) {
  const uint64_t b = static_cast<uint64_t>(__double_as_longlong(x));
  if ((b & 0x7FF0000000000000ull) == 0x7FF0000000000000ull) return KEY_INF;
  if ((b << 1) == 0) return 0x8000000000000000ull;
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

// dom_release's masked key: released lanes (admitted, key <= key(now)) keep
// their time key, the rest take KEY_TOP and sort to the tail.
__device__ __forceinline__ uint64_t release_key(double d, uint8_t admitted,
                                                uint64_t key_now) {
  const uint64_t k = time_key(d);
  return (admitted != 0 && k <= key_now) ? k : KEY_TOP;
}

__device__ __forceinline__ uint64_t umax64(uint64_t a, uint64_t b) {
  return a > b ? a : b;
}

// ---------------------------------------------------------------------------
// the small routes' clusters
// ---------------------------------------------------------------------------
// Blocks of a small-route cluster for n lanes, `tile` a block: the least
// power of two that holds them, from 1 up to `max_blocks`. A batch of many
// short rows (a sharded epoch's groups) then takes small clusters, which
// the card holds many of at once, where 16-block clusters would queue.
inline int cluster_blocks(int n, int tile, int max_blocks) {
  int nb = 1;
  while (nb < max_blocks && nb * tile < n) nb *= 2;
  return nb;
}

// Launches `kernel` as `clusters` clusters of `nb` blocks each: the
// cluster size is chosen at launch, not compiled into the kernel.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int nb, int clusters,
                            int threads, cudaStream_t stream,
                            Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nb) * clusters);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = nb;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// ---------------------------------------------------------------------------
// launch geometry of dom_admit's own stages
// ---------------------------------------------------------------------------
constexpr int THREADS = 256;                 // threads per tile block
constexpr int ITEMS = 8;                     // items per thread
constexpr int TILE = THREADS * ITEMS;        // elements per tile
constexpr int SCAN_THREADS = 1024;           // one block per segment scans

inline int n_tiles(int len) { return (len + TILE - 1) / TILE; }

// ---------------------------------------------------------------------------
// block scans (Hillis-Steele over one value per thread; blockDim.x == N)
// ---------------------------------------------------------------------------
template <int N>
__device__ uint32_t block_exclusive_sum(uint32_t v, uint32_t* smem) {
  smem[threadIdx.x] = v;
  __syncthreads();
  for (int off = 1; off < N; off <<= 1) {
    const uint32_t o = threadIdx.x >= off ? smem[threadIdx.x - off] : 0u;
    __syncthreads();
    smem[threadIdx.x] += o;
    __syncthreads();
  }
  const uint32_t r = threadIdx.x ? smem[threadIdx.x - 1] : 0u;
  __syncthreads();
  return r;
}

template <int N>
__device__ uint64_t block_exclusive_max(uint64_t v, uint64_t* smem) {
  smem[threadIdx.x] = v;
  __syncthreads();
  for (int off = 1; off < N; off <<= 1) {
    const uint64_t o = threadIdx.x >= off ? smem[threadIdx.x - off] : 0ull;
    __syncthreads();
    smem[threadIdx.x] = umax64(smem[threadIdx.x], o);
    __syncthreads();
  }
  const uint64_t r = threadIdx.x ? smem[threadIdx.x - 1] : 0ull;
  __syncthreads();
  return r;
}

// In-place exclusive sum over each segment's `m` entries (one block per
// segment, grid = segments). Thread t owns a contiguous run of entries.
// `total`, when given, receives each segment's sum.
__global__ void exclusive_sum_segments(uint32_t* data, int m,
                                       uint32_t* total) {
  __shared__ uint32_t smem[SCAN_THREADS];
  uint32_t* x = data + static_cast<size_t>(blockIdx.x) * m;
  const int per = (m + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(static_cast<int>(threadIdx.x) * per, m);
  const int hi = min(lo + per, m);
  uint32_t s = 0;
  for (int i = lo; i < hi; ++i) s += x[i];
  uint32_t run = block_exclusive_sum<SCAN_THREADS>(s, smem);
  if (total != nullptr && threadIdx.x == SCAN_THREADS - 1)
    total[blockIdx.x] = run + s;
  for (int i = lo; i < hi; ++i) {
    const uint32_t v = x[i];
    x[i] = run;
    run += v;
  }
}

// In-place exclusive max over each segment's `m` entries (identity 0).
__global__ void exclusive_max_segments(uint64_t* data, int m) {
  __shared__ uint64_t smem[SCAN_THREADS];
  uint64_t* x = data + static_cast<size_t>(blockIdx.x) * m;
  const int per = (m + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(static_cast<int>(threadIdx.x) * per, m);
  const int hi = min(lo + per, m);
  uint64_t s = 0;
  for (int i = lo; i < hi; ++i) s = umax64(s, x[i]);
  uint64_t run = block_exclusive_max<SCAN_THREADS>(s, smem);
  for (int i = lo; i < hi; ++i) {
    const uint64_t v = x[i];
    x[i] = run;
    run = umax64(run, v);
  }
}

// ---------------------------------------------------------------------------
// stable rank of a tile by one 8-bit digit
// ---------------------------------------------------------------------------
// A tile of THREADS * ITEMS elements sits warp-striped in registers: item c
// of lane l in warp w is element w * 32 * ITEMS + c * 32 + l, so each warp
// holds a contiguous span and walks it in element order. Ties keep element
// order: lane order within a chunk of 32, chunk order within a warp, warp
// order within the tile. Every pass uses the same layout.

constexpr unsigned FULL = 0xFFFFFFFFu;

// Lanes of the warp whose 8-bit digit equals this lane's: one ballot a bit
// (the ballot form of match.any, as CUB's MatchAny).
__device__ __forceinline__ unsigned match_digit(uint32_t d) {
  unsigned peers = FULL;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned m = __ballot_sync(FULL, bit);
    peers &= bit ? m : ~m;
  }
  return peers;
}

template <int WARPS>
struct RankStorage {
  uint32_t wcnt[WARPS][256];   // per-warp digit counts, then their prefix
  uint32_t total[256];         // the tile's count of each digit
  uint32_t excl[256];          // exclusive prefix of `total` over digits
  uint32_t warp_sum[8];        // the digit scan's warp totals
};

// Exclusive prefix of one value per digit, for threads 0..255 (others get
// 0). Every thread of the block calls it: it synchronises.
template <int WARPS>
__device__ uint32_t scan_digits(uint32_t v, RankStorage<WARPS>& s) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  uint32_t x = 0;
  if (t < 256) {
    x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s.warp_sum[t >> 5] = x;
  }
  __syncthreads();
  uint32_t r = 0;
  if (t < 256) {
    for (int w = 0; w < (t >> 5); ++w) r += s.warp_sum[w];
    r += x - v;
  }
  __syncthreads();
  return r;
}

// Ranks a tile by the digit (key >> shift) & 0xFF; elements at or past
// `tile_len` take no part. On return pos[c] is item c's place in the tile's
// stable digit order, s.total[d] the tile's count of digit d and s.excl[d]
// its first place. Every thread of the block calls it: it synchronises.
template <int THREADS, int ITEMS>
__device__ void rank_tile(const uint64_t (&key)[ITEMS], int shift,
                          int tile_len, RankStorage<THREADS / 32>& s,
                          uint32_t (&pos)[ITEMS]) {
  constexpr int WARPS = THREADS / 32;
  static_assert(THREADS >= 256 && THREADS % 32 == 0, "a thread per digit");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x; j < WARPS * 256; j += THREADS)
    (&s.wcnt[0][0])[j] = 0;
  __syncthreads();
  const unsigned lower = (1u << lane) - 1u;
  const int first = warp * 32 * ITEMS + lane;
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    const bool ok = first + c * 32 < tile_len;
    const unsigned valid = __ballot_sync(FULL, ok);
    if (valid == 0u) break;                    // the rest of the span too
    const uint32_t d = static_cast<uint32_t>(key[c] >> shift) & 0xFFu;
    const unsigned peers =                     // a warp of one digit: all
        (__all_sync(FULL, d == __shfl_sync(FULL, d, 0)) ? FULL
                                                         : match_digit(d)) &
        valid;
    const uint32_t before = ok ? s.wcnt[warp][d] : 0u;
    pos[c] = before + __popc(peers & lower);
    __syncwarp();
    if (ok && (peers & lower) == 0u)           // lowest lane of the group
      s.wcnt[warp][d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  uint32_t run = 0;
  if (threadIdx.x < 256) {                     // thread d: digit d
    const int d = threadIdx.x;
    for (int w = 0; w < WARPS; ++w) {
      const uint32_t v = s.wcnt[w][d];
      s.wcnt[w][d] = run;
      run += v;
    }
    s.total[d] = run;
  }
  const uint32_t ex = scan_digits<WARPS>(run, s);
  if (threadIdx.x < 256) s.excl[threadIdx.x] = ex;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    const uint32_t d = static_cast<uint32_t>(key[c] >> shift) & 0xFFu;
    if (first + c * 32 < tile_len) pos[c] += s.excl[d] + s.wcnt[warp][d];
  }
}

// ---------------------------------------------------------------------------
// onesweep: stable LSD radix sort of (u64 key, u32 value) pairs
// ---------------------------------------------------------------------------
// After Adinets and Merrill, "Onesweep: A Faster Least Significant Digit
// Radix Sort for GPUs" (2022). One upfront kernel reads the keys once and
// counts all eight digit histograms; then one kernel a pass. A pass block
// takes its tile from an atomic counter (so it only ever waits on tiles
// whose blocks already run), ranks the tile in shared memory, publishes
// its digit counts, gets the counts of the tiles before it by a decoupled
// look-back, and writes the tile out through shared memory in digit runs.
// Segments of `len` pairs sort independently (grid.y = segment).

constexpr int OS_THREADS = 256;              // at least one per digit
constexpr int OS_ITEMS = 16;
constexpr int OS_TILE = OS_THREADS * OS_ITEMS;
constexpr int PASSES = 8;
// A look-back status word: 2 flag bits over a 30-bit count.
constexpr uint32_t ST_AGGREGATE = 1u << 30;   // the tile's own count
constexpr uint32_t ST_PREFIX = 2u << 30;      // count of tiles 0..t
constexpr uint32_t ST_COUNT = ST_AGGREGATE - 1u;
constexpr int MAX_SORT_LEN = static_cast<int>(ST_COUNT);
constexpr int LOOKBACK = 8;         // words read at once past an aggregate

inline int os_tiles(int len) { return (len + OS_TILE - 1) / OS_TILE; }

// The sort's work area, u32 words: hist [segments][8][256], the tile
// counters [8][segments], the released counts [segments] (dom_release),
// then two banks of look-back status [2][segments][tiles][256]. Only the
// words before the status banks need zeroing before the upfront kernel;
// the upfront kernel zeroes bank 0 and pass p zeroes bank (p + 1) % 2.
__host__ __device__ inline size_t work_header_words(int segments) {
  return static_cast<size_t>(segments) * (PASSES * 256 + PASSES + 1);
}
inline size_t work_words(int len, int segments) {
  return work_header_words(segments) +
         2ull * segments * os_tiles(len) * 256;
}

struct Work {
  uint32_t* hist;
  uint32_t* counter;
  uint32_t* released;
  uint32_t* status;

  __host__ __device__ static Work at(uint32_t* w, int segments) {
    Work v;
    v.hist = w;
    v.counter = w + static_cast<size_t>(segments) * PASSES * 256;
    v.released = v.counter + static_cast<size_t>(segments) * PASSES;
    v.status = w + work_header_words(segments);
    return v;
  }
};

// A status word carries its own count, so no other data rides on its
// ordering: relaxed gpu-scope accesses suffice, and an acquire load in the
// look-back's spin costs every pass time.
__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Histograms of all eight digits of each segment in one read of the keys.
// With `d` given (dom_release: a segment a row of d) it first builds the
// masked keys of its segment, writes them and counts the segment's
// released lanes; otherwise it reads `keys`.
// Block (tile, segment) also zeroes its tile's words of status bank 0.
__global__ void __launch_bounds__(OS_THREADS)
onesweep_upfront(const double* __restrict__ d,
                 const uint8_t* __restrict__ admitted, double now,
                 uint64_t* __restrict__ keys, int len, uint32_t* work) {
  __shared__ uint32_t h[PASSES][256];
  const int tile = blockIdx.x;
  const int seg = blockIdx.y;
  const int nt = gridDim.x;
  const Work w = Work::at(work, gridDim.y);
  if (threadIdx.x < 256)
    w.status[(static_cast<size_t>(seg) * nt + tile) * 256 + threadIdx.x] = 0;
  for (int j = threadIdx.x; j < PASSES * 256; j += OS_THREADS)
    (&h[0][0])[j] = 0;
  __syncthreads();
  const uint64_t key_now = time_key(now);
  const int lane = threadIdx.x & 31;
  const size_t sbase = static_cast<size_t>(seg) * len;
  uint64_t* k = keys + sbase;
  uint32_t released = 0;
  for (int c = 0; c < OS_ITEMS; ++c) {
    const int i = tile * OS_TILE + c * OS_THREADS + threadIdx.x;
    const bool ok = i < len;
    const unsigned valid = __ballot_sync(FULL, ok);
    if (valid == 0u) break;                   // the rest of the tile is past len
    uint64_t key = KEY_TOP;
    if (ok) {
      if (d != nullptr) {
        key = release_key(d[sbase + i], admitted[sbase + i], key_now);
        k[i] = key;
        released += key != KEY_TOP;
      } else {
        key = k[i];
      }
    }
    // digits that are the same across the warp (the high ones, in keys
    // near each other) take one atomic; the others one a lane
    const uint64_t diff = key ^ __shfl_sync(FULL, key, 0);
    const uint64_t varies =
        static_cast<uint64_t>(__reduce_or_sync(
            FULL, static_cast<uint32_t>(diff >> 32))) << 32 |
        __reduce_or_sync(FULL, static_cast<uint32_t>(diff));
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const uint32_t dg = static_cast<uint32_t>(key >> (8 * p)) & 0xFFu;
      if (((varies >> (8 * p)) & 0xFFu) == 0u && valid == FULL) {
        if (lane == 0) atomicAdd(&h[p][dg], 32u);
      } else if (ok) {
        atomicAdd(&h[p][dg], 1u);
      }
    }
  }
  __syncthreads();
  uint32_t* hist = w.hist + static_cast<size_t>(seg) * PASSES * 256;
  for (int j = threadIdx.x; j < PASSES * 256; j += OS_THREADS) {
    const uint32_t v = (&h[0][0])[j];
    if (v != 0u) atomicAdd(&hist[j], v);
  }
  if (d != nullptr) {
    released = __reduce_add_sync(FULL, released);
    if (lane == 0 && released != 0u) atomicAdd(&w.released[seg], released);
  }
}

// Shared memory of a pass block (dynamic: more than 48 KB).
struct PassStorage {
  uint64_t xk[OS_TILE];                       // the tile's keys, digit order
  uint32_t xv[OS_TILE];                       // and their values
  RankStorage<OS_THREADS / 32> rank;
  uint32_t base[256];                         // dst - place, per digit
  int tile;
};

// One pass over digit `pass`. FIRST: the values are the element indices
// in the segment (`vin` unread). TO_ORDER (dom_release's last pass):
// writes no keys, but order[dst] = value, or -1 for a KEY_TOP key, and
// the segment's released count into count[segment].
template <bool FIRST, bool TO_ORDER>
__global__ void __launch_bounds__(OS_THREADS, 3)    // three blocks an SM
onesweep_pass(const uint64_t* __restrict__ kin,
              const uint32_t* __restrict__ vin, uint64_t* __restrict__ kout,
              uint32_t* __restrict__ vout, int32_t* __restrict__ order,
              int32_t* __restrict__ count, int len, int pass,
              uint32_t* work) {
  extern __shared__ __align__(16) unsigned char pass_smem[];
  PassStorage& s = *reinterpret_cast<PassStorage*>(pass_smem);
  const int seg = blockIdx.y;
  const int segments = gridDim.y;
  const int nt = gridDim.x;
  const Work w = Work::at(work, segments);
  if (threadIdx.x == 0)
    s.tile = static_cast<int>(atomicAdd(&w.counter[pass * segments + seg], 1u));
  __syncthreads();
  const int tile = s.tile;
  const int tile_len = min(OS_TILE, len - tile * OS_TILE);
  const size_t sbase = static_cast<size_t>(seg) * len;
  const size_t bank = static_cast<size_t>(segments) * nt * 256;
  uint32_t* status = w.status + (pass & 1) * bank +
                     static_cast<size_t>(seg) * nt * 256;
  // the next pass's bank: its pass-(p-1) words are no longer read
  const bool digit_thread = threadIdx.x < 256;          // thread t: digit t
  if (digit_thread)
    w.status[((pass + 1) & 1) * bank +
             (static_cast<size_t>(seg) * nt + tile) * 256 + threadIdx.x] = 0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int first = warp * 32 * OS_ITEMS + lane;
  const int shift = 8 * pass;
  uint64_t key[OS_ITEMS];
  uint32_t val[OS_ITEMS];
#pragma unroll
  for (int c = 0; c < OS_ITEMS; ++c) {
    const int e = first + c * 32;
    const size_t i = sbase + tile * OS_TILE + e;
    const bool ok = e < tile_len;
    key[c] = ok ? kin[i] : KEY_TOP;
    val[c] = ok ? (FIRST ? static_cast<uint32_t>(tile * OS_TILE + e) : vin[i])
                : 0u;
  }
  // the pass's digit offsets in the segment (all blocks read the same
  // histogram, written by the upfront kernel)
  const uint32_t hv = digit_thread
      ? w.hist[(static_cast<size_t>(seg) * PASSES + pass) * 256 + threadIdx.x]
      : 0u;
  uint32_t pos[OS_ITEMS];
  rank_tile<OS_THREADS, OS_ITEMS>(key, shift, tile_len, s.rank, pos);
  uint32_t tot = 0;
  uint32_t* mine = &status[static_cast<size_t>(tile) * 256 + threadIdx.x];
  if (digit_thread) {
    tot = s.rank.total[threadIdx.x];
    store_status(mine, (tile == 0 ? ST_PREFIX : ST_AGGREGATE) | tot);
  }
  const uint32_t global_off = scan_digits<OS_THREADS / 32>(hv, s.rank);
  // decoupled look-back over the tiles before this one: wait for the
  // nearest tile's word; past an aggregate, read the next LOOKBACK - 1
  // words at once
  if (digit_thread) {
    uint32_t prior = 0;
    for (int j = tile - 1; j >= 0;) {
      const uint32_t* at = &status[threadIdx.x];
      uint32_t near = load_status(at + static_cast<size_t>(j) * 256);
      const long long start = clock64();
      while ((near & (ST_AGGREGATE | ST_PREFIX)) == 0u) {   // not yet
        if (clock64() - start > 20000000000ll) asm volatile("trap;");  // ~10 s
        near = load_status(at + static_cast<size_t>(j) * 256);
      }
      prior += near & ST_COUNT;
      if (near & ST_PREFIX) break;
      uint32_t st[LOOKBACK - 1];
#pragma unroll
      for (int k = 1; k < LOOKBACK; ++k)
        st[k - 1] = j - k >= 0 ? load_status(at + static_cast<size_t>(j - k) *
                                                      256)
                               : 0u;
      int k = 1;
      bool done = false;
      for (; k < LOOKBACK; ++k) {
        if ((st[k - 1] & (ST_AGGREGATE | ST_PREFIX)) == 0u) break;
        prior += st[k - 1] & ST_COUNT;
        if (st[k - 1] & ST_PREFIX) {
          done = true;
          break;
        }
      }
      if (done) break;
      j -= k;                       // tile 0 holds a prefix: j stays >= 0
    }
    if (tile > 0) store_status(mine, ST_PREFIX | (prior + tot));
    s.base[threadIdx.x] = global_off + prior - s.rank.excl[threadIdx.x];
  }
#pragma unroll
  for (int c = 0; c < OS_ITEMS; ++c) {
    if (first + c * 32 < tile_len) {
      s.xk[pos[c]] = key[c];
      s.xv[pos[c]] = val[c];
    }
  }
  __syncthreads();
  // out in place order: a digit's run goes to consecutive addresses
#pragma unroll
  for (int j = 0; j < OS_ITEMS; ++j) {
    const int p = j * OS_THREADS + threadIdx.x;
    if (p < tile_len) {
      const uint64_t k = s.xk[p];
      const uint32_t v = s.xv[p];
      const size_t dst =
          sbase + s.base[static_cast<uint32_t>(k >> shift) & 0xFFu] + p;
      if (TO_ORDER) {
        order[dst] = k == KEY_TOP ? -1 : static_cast<int32_t>(v);
      } else {
        kout[dst] = k;
        vout[dst] = v;
      }
    }
  }
  if (TO_ORDER && tile == 0 && threadIdx.x == 0)
    count[seg] = static_cast<int32_t>(w.released[seg]);
}

// The pass kernels' shared memory is above the 48 KB default: allowed once
// per device and instantiation.
template <bool FIRST, bool TO_ORDER>
cudaError_t pass_ready() {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && ready[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(onesweep_pass<FIRST, TO_ORDER>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(sizeof(PassStorage)));
  if (e == cudaSuccess && dev < 64) ready[dev] = true;
  return e;
}

template <bool FIRST, bool TO_ORDER>
cudaError_t launch_pass(dim3 grid, cudaStream_t stream, const uint64_t* ki,
                        const uint32_t* vi, uint64_t* ko, uint32_t* vo,
                        int32_t* order, int32_t* count, int len, int pass,
                        uint32_t* work) {
  const cudaError_t e = pass_ready<FIRST, TO_ORDER>();
  if (e != cudaSuccess) return e;
  onesweep_pass<FIRST, TO_ORDER><<<grid, OS_THREADS, sizeof(PassStorage),
                                   stream>>>(ki, vi, ko, vo, order, count,
                                             len, pass, work);
  return cudaGetLastError();
}

// Sorts `segments` segments of `len` pairs by key, stably. With `d` given
// (dom_release: segment g is row g of d [segments, len]) the upfront
// kernel builds the keys into ka from d/admitted/now, the first pass takes
// the indices in the segment as values and the last writes `order`
// [segments, len] and `count` [segments]; otherwise the pairs start in
// (ka, va) and end there. (kb, vb) are the other buffers, `work` holds
// work_words(len, segments) words. Launches: one memset of the work
// area's header, the upfront kernel, eight passes.
inline cudaError_t onesweep_sort(const double* d, const uint8_t* admitted,
                                 double now, uint64_t* ka, uint64_t* kb,
                                 uint32_t* va, uint32_t* vb, int32_t* order,
                                 int32_t* count, int len, int segments,
                                 uint32_t* work, cudaStream_t stream) {
  if (len == 0 || segments == 0) return cudaSuccess;
  if (len > MAX_SORT_LEN || segments > 65535) return cudaErrorInvalidValue;
  const bool release = d != nullptr;
  cudaError_t e = cudaMemsetAsync(
      work, 0, work_header_words(segments) * sizeof(uint32_t), stream);
  if (e != cudaSuccess) return e;
  const dim3 grid(os_tiles(len), segments);
  onesweep_upfront<<<grid, OS_THREADS, 0, stream>>>(d, admitted, now, ka,
                                                    len, work);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  for (int pass = 0; pass < PASSES; ++pass) {
    const bool even = (pass & 1) == 0;
    uint64_t* ki = even ? ka : kb;
    uint64_t* ko = even ? kb : ka;
    uint32_t* vi = even ? va : vb;
    uint32_t* vo = even ? vb : va;
    if (release && pass == 0) {
      e = launch_pass<true, false>(grid, stream, ki, vi, ko, vo, order,
                                   count, len, pass, work);
    } else if (release && pass == PASSES - 1) {
      e = launch_pass<false, true>(grid, stream, ki, vi, ko, vo, order,
                                   count, len, pass, work);
    } else {
      e = launch_pass<false, false>(grid, stream, ki, vi, ko, vo, order,
                                    count, len, pass, work);
    }
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace dom

#define DOM_CHECK(expr)                                  \
  do {                                                   \
    const cudaError_t e_ = (expr);                       \
    if (e_ != cudaSuccess) return static_cast<int>(e_);  \
  } while (0)

#define DOM_CHECK_LAUNCH() DOM_CHECK(cudaGetLastError())
