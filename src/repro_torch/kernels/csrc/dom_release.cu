// dom_release: deadline-ordered release of the DOM early buffer, for Hopper.
//
// Replaces the Pallas kernel `dom_release_pallas` (body `_dom_release_kernel`,
// src/repro/kernels/dom_release.py:59). Given deadlines [n] f64, admitted
// [n] u8 and a clock `now`, it emits the ids of the released messages
// (admitted and deadline <= now) in stable deadline order, padded with -1,
// plus their count.
//
// Design: masked 64-bit time keys (non-released lanes take KEY_TOP, so they
// sort to the tail), a stable 8-pass LSD radix sort with the message id as
// payload -- stability makes ties order by id without an id key -- and a
// block-reduced count. Bound on this card: memory, at least 9n bytes read
// and 4n written; this first version moves far more (eight sort passes).
#include "common.cuh"

namespace {

__global__ void release_keys(const double* __restrict__ d,
                             const uint8_t* __restrict__ admitted, double now,
                             int n, uint64_t* __restrict__ keys,
                             uint32_t* __restrict__ vals,
                             uint32_t* __restrict__ count) {
  __shared__ uint32_t block_count;
  if (threadIdx.x == 0) block_count = 0;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool released = false;
  if (i < n) {
    const uint64_t k = dom::time_key(d[i]);
    released = admitted[i] != 0 && k <= dom::time_key(now);
    keys[i] = released ? k : dom::KEY_TOP;
    vals[i] = static_cast<uint32_t>(i);
  }
  const unsigned votes = __ballot_sync(0xFFFFFFFFu, released);
  if ((threadIdx.x & 31) == 0 && votes != 0u)
    atomicAdd(&block_count, static_cast<uint32_t>(__popc(votes)));
  __syncthreads();
  if (threadIdx.x == 0 && block_count != 0u) atomicAdd(count, block_count);
}

__global__ void release_finalize(const uint32_t* __restrict__ sorted_ids,
                                 const uint32_t* __restrict__ count, int n,
                                 int32_t* __restrict__ order) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    order[i] = static_cast<uint32_t>(i) < *count
                   ? static_cast<int32_t>(sorted_ids[i])
                   : -1;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Scratch: ka, kb [n] u64; va, vb [n] u32; hist [256 * ceil(n / TILE)] u32.
int dom_release_launch(const double* deadlines, const uint8_t* admitted,
                       double now, int n, int32_t* order, int32_t* count,
                       uint64_t* ka, uint64_t* kb, uint32_t* va, uint32_t* vb,
                       uint32_t* hist, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DOM_CHECK(cudaMemsetAsync(count, 0, sizeof(int32_t), st));
  if (n == 0) return 0;
  const int blocks = (n + 255) / 256;
  release_keys<<<blocks, 256, 0, st>>>(deadlines, admitted, now, n, ka, va,
                                       reinterpret_cast<uint32_t*>(count));
  DOM_CHECK_LAUNCH();
  DOM_CHECK(dom::radix_sort_pairs(ka, kb, va, vb, hist, n, 1, st));
  release_finalize<<<blocks, 256, 0, st>>>(
      va, reinterpret_cast<const uint32_t*>(count), n, order);
  DOM_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
