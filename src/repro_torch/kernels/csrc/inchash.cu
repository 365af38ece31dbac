// inchash: the fast-reply hashes of an appended replica log, for Hopper.
//
// Replaces the Pallas kernel `inchash_pallas` (body `_inchash_kernel`,
// src/repro/kernels/inchash.py:59). For n log entries, on the low 32 bits
// of (deadline_ns, client_id, request_id):
//   h_i      = fmix32(fmix32(d) ^ fmix32(c ^ 0xA5A5A5A5) * 0x01000193
//                     ^ fmix32(r ^ 0x5A5A5A5A))
//   prefix_i = h_0 ^ ... ^ h_i   (the hash the i-th fast reply carries).
// All arithmetic is exact 32-bit unsigned integer work.
//
// The TPU kernel walks its grid in order and carries the running XOR across
// blocks in SMEM. Blocks here run in parallel and in no order, so the carry
// is a reduce-then-scan in three launches:
//   1. per tile: read the three int64 columns once (coalesced), write h and
//      the tile's XOR fold;
//   2. one block: exclusive XOR scan of the tile folds, in place;
//   3. per tile: read h back, block-wide XOR scan (warp shuffles, then warp
//      totals through shared memory) chunk by chunk, XOR in the tile's
//      carry, write the prefix.
// Bound on this card: bytes. The least traffic is 24n read and 8n written;
// this design moves 36n (h is written once and read back once). The mixing
// (about 30 integer operations an entry) is far below the integer rate.
// Ragged tails are masked, never padded into memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;                 // threads per tile block
constexpr int ITEMS = 8;                     // entries per thread
constexpr int TILE = THREADS * ITEMS;        // entries per tile
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_THREADS = 1024;           // the tile-fold scan's block
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t entry_hash(int64_t d, int64_t c,
                                               int64_t r) {
  // the low 32 bits, as numpy's astype(np.uint32) and the TPU kernel's
  // .astype(jnp.uint32) take them (negative values included)
  const uint32_t hd = fmix32(static_cast<uint32_t>(d));
  const uint32_t hc = fmix32(static_cast<uint32_t>(c) ^ 0xA5A5A5A5u);
  const uint32_t hr = fmix32(static_cast<uint32_t>(r) ^ 0x5A5A5A5Au);
  return fmix32(hd ^ (hc * 0x01000193u) ^ hr);
}

__device__ __forceinline__ uint32_t warp_inclusive_xor(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t o = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v ^= o;
  }
  return v;
}

// Inclusive XOR scan over the block's threads (N threads, N / 32 <= 32
// warps); `*total` receives the XOR of all N values. `warp_tot` holds N / 32
// words of shared memory. Every thread of the block must call it.
template <int N>
__device__ uint32_t block_inclusive_xor(uint32_t v, uint32_t* warp_tot,
                                        uint32_t* total) {
  constexpr int NW = N / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t incl = warp_inclusive_xor(v);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = warp_inclusive_xor(lane < NW ? warp_tot[lane] : 0u);
    if (lane < NW) warp_tot[lane] = w;
  }
  __syncthreads();
  const uint32_t before = warp ? warp_tot[warp - 1] : 0u;
  *total = warp_tot[NW - 1];
  __syncthreads();                           // warp_tot is reused next call
  return before ^ incl;
}

__global__ void __launch_bounds__(THREADS)
hash_tiles(const int64_t* __restrict__ d, const int64_t* __restrict__ c,
           const int64_t* __restrict__ r, int n, uint32_t* __restrict__ h,
           uint32_t* __restrict__ tile_xor) {
  __shared__ uint32_t warp_tot[WARPS];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * TILE;
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t i = base + k * THREADS + threadIdx.x;
    if (i < n) {
      const uint32_t v = entry_hash(d[i], c[i], r[i]);
      h[i] = v;
      acc ^= v;                              // XOR is order-free
    }
  }
  uint32_t total;
  block_inclusive_xor<THREADS>(acc, warp_tot, &total);
  if (threadIdx.x == 0) tile_xor[blockIdx.x] = total;
}

// In-place exclusive XOR scan of the m tile folds (one block; thread t owns
// a contiguous run of them).
__global__ void __launch_bounds__(SCAN_THREADS)
scan_tile_folds(uint32_t* x, int m) {
  __shared__ uint32_t warp_tot[SCAN_THREADS / 32];
  const int per = (m + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(static_cast<int>(threadIdx.x) * per, m);
  const int hi = min(lo + per, m);
  uint32_t s = 0;
  for (int i = lo; i < hi; ++i) s ^= x[i];
  uint32_t total;
  uint32_t run = block_inclusive_xor<SCAN_THREADS>(s, warp_tot, &total) ^ s;
  for (int i = lo; i < hi; ++i) {
    const uint32_t v = x[i];
    x[i] = run;
    run ^= v;
  }
}

__global__ void __launch_bounds__(THREADS)
prefix_tiles(const uint32_t* __restrict__ h,
             const uint32_t* __restrict__ carry_in, int n,
             uint32_t* __restrict__ prefix) {
  __shared__ uint32_t warp_tot[WARPS];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * TILE;
  uint32_t carry = carry_in[blockIdx.x];
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t first = base + k * THREADS;
    if (first >= n) break;                   // uniform across the block
    const int64_t i = first + threadIdx.x;
    const uint32_t v = i < n ? h[i] : 0u;    // 0: XOR's identity
    uint32_t total;
    const uint32_t incl = block_inclusive_xor<THREADS>(v, warp_tot, &total);
    if (i < n) prefix[i] = carry ^ incl;
    carry ^= total;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// h, prefix: [n] u32; tile_xor: scratch of ceil(n / 2048) u32. n >= 1.
int inchash_launch(const int64_t* deadline_ns, const int64_t* client_id,
                   const int64_t* request_id, int n, uint32_t* h,
                   uint32_t* prefix, uint32_t* tile_xor, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const int tiles = (n + TILE - 1) / TILE;
  hash_tiles<<<tiles, THREADS, 0, st>>>(deadline_ns, client_id, request_id,
                                        n, h, tile_xor);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_tile_folds<<<1, SCAN_THREADS, 0, st>>>(tile_xor, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  prefix_tiles<<<tiles, THREADS, 0, st>>>(h, tile_xor, n, prefix);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
