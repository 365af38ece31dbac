// Shared device code of the DOM kernels: the 64-bit time key, block scans
// and the stable multi-block LSD radix sort that both kernels run.
//
// Every comparison in these kernels is an integer comparison of time keys.
// The float64 times enter only through `time_key`, a bit cast, so the
// kernels do no floating-point arithmetic and have no FMA-contraction
// question.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dom {

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

__device__ __forceinline__ uint64_t umax64(uint64_t a, uint64_t b) {
  return a > b ? a : b;
}

// ---------------------------------------------------------------------------
// launch geometry
// ---------------------------------------------------------------------------
constexpr int THREADS = 256;                 // threads per tile block
constexpr int ITEMS = 8;                     // items per thread
constexpr int TILE = THREADS * ITEMS;        // elements per tile
constexpr int WARPS = THREADS / 32;
constexpr int WARP_SPAN = TILE / WARPS;      // contiguous elements per warp
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
// stable LSD radix sort of (u64 key, u32 value) pairs, 8 passes of 8 bits
// ---------------------------------------------------------------------------
// Segments of `len` pairs each sort independently (grid.y = segment).
// Pass structure: per-tile digit histogram -> exclusive scan over
// (digit, tile) -> stable scatter. The scan's digit-major layout makes
// hist[d * nt + tile] the global start of tile's digit-d run.

__global__ void radix_histogram(const uint64_t* __restrict__ keys, int len,
                                int nt, int shift,
                                uint32_t* __restrict__ hist) {
  __shared__ uint32_t cnt[256];
  const int tile = blockIdx.x;
  const size_t seg = blockIdx.y;
  cnt[threadIdx.x] = 0;                      // THREADS == 256 bins
  __syncthreads();
  const uint64_t* k = keys + seg * len;
  const int base = tile * TILE;
  for (int j = threadIdx.x; j < TILE; j += THREADS) {
    const int i = base + j;
    if (i < len) atomicAdd(&cnt[(k[i] >> shift) & 0xFF], 1u);
  }
  __syncthreads();
  hist[seg * 256 * nt + static_cast<size_t>(threadIdx.x) * nt + tile] =
      cnt[threadIdx.x];
}

// Stable scatter: each warp ranks its WARP_SPAN contiguous elements in
// order (match_any groups equal digits within 32 lanes; a per-warp digit
// counter carries across its chunks), then an exclusive prefix over the
// warps of the tile and the scanned histogram place every element.
__global__ void radix_scatter(const uint64_t* __restrict__ kin,
                              const uint32_t* __restrict__ vin,
                              uint64_t* __restrict__ kout,
                              uint32_t* __restrict__ vout,
                              const uint32_t* __restrict__ offs, int len,
                              int nt, int shift) {
  __shared__ uint32_t wcnt[WARPS][256];
  const int tile = blockIdx.x;
  const size_t seg = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x; j < WARPS * 256; j += THREADS)
    (&wcnt[0][0])[j] = 0;
  __syncthreads();
  const size_t sbase = seg * len;
  const int wbase = tile * TILE + warp * WARP_SPAN;
  const unsigned lower = (1u << lane) - 1u;
  uint64_t key[ITEMS];
  uint32_t val[ITEMS];
  uint32_t dig[ITEMS];
  uint32_t rank[ITEMS];
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    const int i = wbase + c * 32 + lane;
    const bool ok = i < len;
    key[c] = ok ? kin[sbase + i] : 0ull;
    val[c] = ok ? vin[sbase + i] : 0u;
    const uint32_t d = ok ? static_cast<uint32_t>((key[c] >> shift) & 0xFF)
                          : 256u;            // out of range: its own group
    dig[c] = d;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    const uint32_t before = d < 256u ? wcnt[warp][d] : 0u;
    rank[c] = before + __popc(peers & lower);
    __syncwarp();
    if (d < 256u && (peers & lower) == 0u)   // lowest lane of the group
      wcnt[warp][d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  {                                          // thread t: digit t
    const int d = threadIdx.x;
    uint32_t run = 0;
    for (int w = 0; w < WARPS; ++w) {
      const uint32_t v = wcnt[w][d];
      wcnt[w][d] = run;
      run += v;
    }
  }
  __syncthreads();
  const uint32_t* o = offs + seg * 256 * nt;
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    const uint32_t d = dig[c];
    if (d < 256u) {
      const size_t dst = sbase + o[static_cast<size_t>(d) * nt + tile] +
                         wcnt[warp][d] + rank[c];
      kout[dst] = key[c];
      vout[dst] = val[c];
    }
  }
}

// Sorts `segments` segments of `len` pairs held in (ka, va), using (kb, vb)
// as the ping-pong buffers and `hist` (segments * 256 * n_tiles(len) words)
// as scratch. Eight passes: the sorted pairs end in (ka, va).
inline cudaError_t radix_sort_pairs(uint64_t* ka, uint64_t* kb, uint32_t* va,
                                    uint32_t* vb, uint32_t* hist, int len,
                                    int segments, cudaStream_t stream) {
  if (len == 0 || segments == 0) return cudaSuccess;
  const int nt = n_tiles(len);
  const dim3 grid(nt, segments);
  for (int pass = 0; pass < 8; ++pass) {
    const int shift = 8 * pass;
    radix_histogram<<<grid, THREADS, 0, stream>>>(ka, len, nt, shift, hist);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    exclusive_sum_segments<<<segments, SCAN_THREADS, 0, stream>>>(
        hist, 256 * nt, nullptr);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    radix_scatter<<<grid, THREADS, 0, stream>>>(ka, va, kb, vb, hist, len,
                                                nt, shift);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    uint64_t* tk = ka; ka = kb; kb = tk;
    uint32_t* tv = va; va = vb; vb = tv;
  }
  return cudaSuccess;
}

}  // namespace dom

#define DOM_CHECK(expr)                                  \
  do {                                                   \
    const cudaError_t e_ = (expr);                       \
    if (e_ != cudaSuccess) return static_cast<int>(e_);  \
  } while (0)

#define DOM_CHECK_LAUNCH() DOM_CHECK(cudaGetLastError())
