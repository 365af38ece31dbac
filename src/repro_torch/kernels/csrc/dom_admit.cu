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
// Design (grid over tiles x receivers, every stage multi-block):
//   1. place   the events directly in aux order, with no sort: first the
//              updates with d > a in message order, then for each message
//              its test followed by its update when d <= a. One integer
//              exclusive scan of the (d > a) flags gives every position.
//   2. sort    stably on the time key alone (the shared LSD radix sort):
//              stability turns aux order into (time, aux) order.
//   3. decide  an inclusive prefix max of the candidate watermark keys --
//              a tile scan plus an exclusive scan of the tile carries, since
//              blocks run in no order -- shifted by one, then each test
//              scatters its verdict back to message order (the TPU's second
//              bitonic sort existed only to avoid that gather).
// Bound on this card: memory, at least 8N + 8RN bytes read and RN written;
// this first version moves far more (eight sort passes over 2RN events).
#include "common.cuh"

namespace {

using dom::ITEMS;
using dom::KEY_INF;
using dom::THREADS;
using dom::TILE;
using dom::time_key;
using dom::umax64;

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

const char* dom_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// deadlines [n] f64, arrivals [n, R] f64 (row-major), admitted [n, R] u8.
// Scratch: ka, kb [R * 2n] u64; va, vb [R * 2n] u32;
// hist [R * 256 * ceil(2n / TILE)] u32; tile_count [R * ceil(n / TILE)] u32;
// early_total [R] u32; tile_max [R * ceil(2n / TILE)] u64.
int dom_admit_launch(const double* deadlines, const double* arrivals, int n,
                     int R, uint8_t* admitted, uint64_t* ka, uint64_t* kb,
                     uint32_t* va, uint32_t* vb, uint32_t* hist,
                     uint32_t* tile_count, uint32_t* early_total,
                     uint64_t* tile_max, void* stream) {
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
  DOM_CHECK(dom::radix_sort_pairs(ka, kb, va, vb, hist, len, R, st));
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
