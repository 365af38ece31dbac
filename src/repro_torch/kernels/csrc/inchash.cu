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
// Bound on this card: bytes. The least traffic is 24n read and 8n written,
// and this kernel moves exactly that, in one launch: the TPU kernel walks
// its grid in order and carries the running XOR across blocks in SMEM;
// here blocks run in parallel, so the carry comes from a single-pass scan
// with a decoupled look-back (Merrill and Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", 2016), as the onesweep passes of
// common.cuh do for digit counts. A block takes one 4096-entry tile:
//   1. it reads the three int64 columns once (coalesced, warp-striped:
//      warp w holds entries [256 w, 256 w + 256) of the tile, item k of
//      lane l is entry 256 w + 32 k + l), hashes them into registers and
//      writes h;
//   2. it XOR-reduces the tile (warp shuffles, then the warp totals in
//      shared memory) and publishes the tile's aggregate in its status
//      word; warp 0 then looks back over the status words of the tiles
//      before it, 32 at a time, until it meets an inclusive prefix, and
//      publishes the tile's own inclusive prefix; meanwhile every warp
//      scans its items in registers;
//   3. it XORs the carry in and writes prefix. h is never read back.
// Ragged tails are masked (XOR's identity 0 in registers), never padded
// into memory. Tiles come from an atomic ticket, not blockIdx, so a block
// only ever waits on tiles whose blocks already run; a look-back that
// waits ~10 s traps instead of hanging.
//
// The work area (u32 words, persistent, zeroed only when it is made):
//   [0, 1] the ticket word: tickets drawn (low half), generation (high
//   half); [2] sweep cursor, [3] unused;
//   then `cap` 64-bit status words, one per tile:
//   bits 0-31 the XOR value, bits 32-33 the flag (1 aggregate, 2 inclusive
//   prefix, 0 not ready), bits 34-63 the generation's low 30 bits (tag).
// A call needs no zeroing pass and no host sync:
//   - every block takes its ticket and reads the generation in one 64-bit
//     atomic add on the ticket word; the block that draws the last ticket
//     (tiles - 1) then stores (generation + 1, 0) there. Every other
//     block's add comes before the last one in the word's order, and the
//     store after it, so no block of the call sees the bump, and the next
//     call finds the counter at 0;
//   - a status word reads as ready only with the call's tag and a flag,
//     so the words of an earlier call (a larger one, say) read as not
//     ready; an aligned 64-bit relaxed access is single-copy atomic, so
//     the value rides with its flag and tag and no fence is needed;
//   - the tag wraps after 2^30 calls, so the last block also zeroes the
//     next 512 words of [tiles, cap) (a rotating sweep; this call reads
//     none of them): every word is rewritten at least once every
//     cap / 512 + 1 calls, far fewer than 2^30, so no stale word can
//     carry a tag that has come round again.
// Since the state lives on the device, a call replayed from a CUDA graph
// reads the generation as it then stands: replays are correct like eager
// calls. Calls sharing an area must be ordered (one stream).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The tile's shape. scripts/inchash_tiles.py builds other shapes with -D
// to compare them; the wrapper's TILE is THREADS * ITEMS of the default.
#ifndef INCHASH_THREADS
#define INCHASH_THREADS 512
#endif
#ifndef INCHASH_ITEMS
#define INCHASH_ITEMS 8
#endif
constexpr int THREADS = INCHASH_THREADS;     // threads per tile block
constexpr int ITEMS = INCHASH_ITEMS;         // entries per thread
constexpr int TILE = THREADS * ITEMS;        // entries per tile
constexpr int WARPS = THREADS / 32;
constexpr int HEADER_WORDS = 4;              // u32 words before the status
constexpr int SWEEP = THREADS;               // status words swept a call
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint64_t ST_AGGREGATE = 1ull << 32;
constexpr uint64_t ST_PREFIX = 2ull << 32;
constexpr uint64_t ST_FLAGS = 3ull << 32;
constexpr int TAG_SHIFT = 34;
constexpr uint32_t TAG_MASK = (1u << 30) - 1u;

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

__device__ __forceinline__ uint32_t warp_xor(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v ^= __shfl_xor_sync(FULL, v, off);
  return v;
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

__device__ __forceinline__ uint64_t status_word(uint32_t tag, uint64_t flag,
                                                uint32_t value) {
  return (static_cast<uint64_t>(tag) << TAG_SHIFT) | flag | value;
}

__device__ __forceinline__ bool ready(uint64_t w, uint32_t tag) {
  return (w & ST_FLAGS) != 0 && static_cast<uint32_t>(w >> TAG_SHIFT) == tag;
}

__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// The ticket word before the increment: generation (high half), tickets
// drawn so far (low half), in one read.
__device__ __forceinline__ uint64_t take_ticket(uint64_t* word) {
  uint64_t old;
  asm volatile("atom.relaxed.gpu.global.add.u64 %0, [%1], %2;"
               : "=l"(old) : "l"(word), "l"(1ull) : "memory");
  return old;
}

// XOR of the values of tiles 0..tile-1 (warp 0; every lane returns it).
// Lane l reads the word of tile j - l; the window is used once all 32
// words are ready, up to and including the nearest inclusive prefix.
__device__ uint32_t look_back(const uint64_t* status, int tile,
                              uint32_t tag) {
  const int lane = threadIdx.x & 31;
  uint32_t carry = 0;
  for (int j = tile - 1;; j -= 32) {
    const int at = j - lane;
    // before tile 0: an inclusive prefix of 0 (XOR's identity)
    uint64_t w = at >= 0 ? load_status(status + at)
                         : status_word(tag, ST_PREFIX, 0u);
    const long long start = clock64();
    while (!__all_sync(FULL, ready(w, tag))) {
      if (clock64() - start > 20000000000ll) asm volatile("trap;");  // ~10 s
      if (!ready(w, tag)) w = load_status(status + at);
    }
    const unsigned prefixes = __ballot_sync(FULL, (w & ST_PREFIX) != 0);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    carry ^= warp_xor(lane <= stop ? static_cast<uint32_t>(w) : 0u);
    if (prefixes) return carry;
  }
}

__global__ void __launch_bounds__(THREADS)
inchash_onepass(const int64_t* __restrict__ d, const int64_t* __restrict__ c,
                const int64_t* __restrict__ r, int n,
                uint32_t* __restrict__ h, uint32_t* __restrict__ prefix,
                uint32_t* work, int cap) {
  __shared__ uint32_t s_tile, s_tag, s_sweep, s_carry;
  __shared__ uint32_t warp_tot[WARPS];
  const int tiles = gridDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint64_t* status = reinterpret_cast<uint64_t*>(work + HEADER_WORDS);
  if (threadIdx.x == 0) {
    uint64_t* ticket = reinterpret_cast<uint64_t*>(work);
    const uint64_t old = take_ticket(ticket);
    const uint32_t t = static_cast<uint32_t>(old);
    const uint32_t gen = static_cast<uint32_t>(old >> 32);
    if (t >= static_cast<uint32_t>(tiles)) asm volatile("trap;");  // torn area
    if (t == static_cast<uint32_t>(tiles - 1)) {
      // every ticket is taken: counter 0, the next generation
      *ticket = static_cast<uint64_t>(gen + 1u) << 32;
      s_sweep = work[2];
      const uint32_t next = work[2] + SWEEP;
      work[2] = next < static_cast<uint32_t>(cap) ? next : 0u;
    }
    s_tile = t;
    s_tag = gen & TAG_MASK;
  }
  __syncthreads();
  const int tile = s_tile;
  const uint32_t tag = s_tag;
  if (tile == tiles - 1) {                   // the rotating sweep
    const uint32_t j = s_sweep + threadIdx.x;
    if (j >= static_cast<uint32_t>(tiles) && j < static_cast<uint32_t>(cap))
      status[j] = 0ull;
  }

  // 1. read, hash, write h (all loads issued before the first use)
  const int64_t base = static_cast<int64_t>(tile) * TILE + warp * 32 * ITEMS
                       + lane;
  int64_t dv[ITEMS], cv[ITEMS], rv[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t i = base + k * 32;
    if (i < n) {
      dv[k] = d[i];
      cv[k] = c[i];
      rv[k] = r[i];
    }
  }
  uint32_t v[ITEMS];
  uint32_t fold = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t i = base + k * 32;
    v[k] = i < n ? entry_hash(dv[k], cv[k], rv[k]) : 0u;
    if (i < n) h[i] = v[k];
    fold ^= v[k];
  }

  // 2. the tile's aggregate, published; warp 0 looks back
  fold = warp_xor(fold);
  if (lane == 0) warp_tot[warp] = fold;
  __syncthreads();
  if (warp == 0) {
    const uint32_t agg = warp_xor(lane < WARPS ? warp_tot[lane] : 0u);
    uint64_t* mine = status + tile;
    uint32_t carry = 0;
    if (tile == 0) {
      if (lane == 0) store_status(mine, status_word(tag, ST_PREFIX, agg));
    } else {
      if (lane == 0) store_status(mine, status_word(tag, ST_AGGREGATE, agg));
      carry = look_back(status, tile, tag);
      if (lane == 0)
        store_status(mine, status_word(tag, ST_PREFIX, carry ^ agg));
    }
    if (lane == 0) s_carry = carry;
  }
  // each warp's items, scanned in entry order (item-major, then lane)
  uint32_t run = 0;
  for (int w = 0; w < warp; ++w) run ^= warp_tot[w];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const uint32_t incl = warp_inclusive_xor(v[k]);
    v[k] = run ^ incl;
    run ^= __shfl_sync(FULL, incl, 31);
  }
  __syncthreads();

  // 3. the carry in, prefix out
  const uint32_t carry = s_carry;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t i = base + k * 32;
    if (i < n) prefix[i] = carry ^ v[k];
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// h, prefix: [n] u32. work: the persistent work area of HEADER_WORDS +
// 2 cap u32 words (zeroed when it was made), with cap >= ceil(n / TILE).
// One launch on `stream`; n <= 0 launches nothing.
int inchash_launch(const int64_t* deadline_ns, const int64_t* client_id,
                   const int64_t* request_id, int n, uint32_t* h,
                   uint32_t* prefix, uint32_t* work, int cap, void* stream) {
  if (n <= 0) return 0;
  const int tiles = (n + TILE - 1) / TILE;
  if (tiles > cap) return static_cast<int>(cudaErrorInvalidValue);
  inchash_onepass<<<tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      deadline_ns, client_id, request_id, n, h, prefix, work, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
