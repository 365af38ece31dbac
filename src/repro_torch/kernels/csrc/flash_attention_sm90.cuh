// The tensor-core route of flash_attention: bf16 q, k, v on Hopper's
// warpgroup MMA (`wgmma`), fed by the Tensor Memory Accelerator (TMA).
// Included by flash_attention.cu, whose header says what the kernel
// computes and why it is built this way.
//
// Block: NWG consumer warpgroups of 64 query rows each (BQ = 64 NWG) and
// one producer warpgroup (see Config). Shared memory holds the Q tile,
// loaded once, and a ring of STAGES (K, V) tiles of BK keys. Every tile is stored as
// 128-byte rows with the 128-byte swizzle, one "atom" of 64 bf16 columns
// at a time (D 128 is two atoms side by side): the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B and the one the wgmma descriptors name.
//
// Per KV tile and warpgroup:
//   S = Q K^T    wgmma m64nBKk16, A = Q and B = K from shared memory,
//                both K-major (D contiguous), D/16 steps;
//   softmax      in registers on the float32 accumulator: scale and log2(e)
//                applied to S, row max and sum over the 4 threads of a quad,
//                masks only on tiles that cross the causal diagonal, the
//                window's edge or Sk;
//   O += P V     wgmma m64nDk16, A = P from registers (the S accumulator's
//                layout is the A fragment's once rounded to bf16 pairs),
//                B = V from shared memory, MN-major (transpose bit),
//                BK/16 steps.
// A warpgroup issues S of tile i together with O += P V of tile i - 1 and
// runs the softmax of tile i while the latter is on the tensor cores; the
// warpgroups take turns to issue (round robin), so the others' softmax runs
// while one's products do. The producer waits for a stage to be
// empty, then has TMA fill it and complete a transaction count on the
// stage's "full" mbarrier; consumers wait on "full", compute, and arrive on
// the stage's "empty" mbarrier once P V of the tile is done.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fa_tc {

constexpr int WG_ROWS = 64;              // query rows per consumer warpgroup
constexpr int ATOM = 64;                 // bf16 columns per 128-byte row
constexpr int ATOM_ROW_BYTES = 128;
constexpr int PRODUCER_REGS = 24;        // registers a producer thread keeps

// Tile shape by head dim. A block is NWG consumer warpgroups of 64 query
// rows and one producer warpgroup; `setmaxnreg` moves the producer's
// registers to the consumers (REGS each: 24 x 128 + REGS x 128 NWG <=
// 65536). At D 64 three consumers (BQ 192, 160 registers) keep two
// softmaxes in flight beside one warpgroup's products; at D 128 two
// consumers with 240 registers hold S, P and O of 128-key tiles. Shared
// memory: 24 KB of Q and a 4-stage ring of 32 KB K/V tiles at D 64 (152
// KB), 32 KB of Q and a 3-stage ring of 64 KB at D 128 (224 KB of the 227
// KB a block may use).
template <int D_>
struct Config;
template <>
struct Config<64> {
  static constexpr int D = 64, BK = 128, STAGES = 4, NWG = 3, REGS = 160;
};
template <>
struct Config<128> {
  static constexpr int D = 128, BK = 128, STAGES = 3, NWG = 2, REGS = 240;
};

// ---------------------------------------------------------------------------
// PTX wrappers: mbarrier, TMA, wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits on an mbarrier phase. A wait that outlasts ~10 s of SM clock traps
// (the launch then fails with an error the wrapper raises) instead of
// hanging the card on a lost transaction.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000ll) {
      asm volatile("trap;\n");
    }
  }
}

// One box of a 4-D tensor map (D, H, S, B; innermost first) into shared
// memory; rows past the tensor's extent arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. Addresses and offsets
// are in bytes; the descriptor keeps them in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Named barriers 1 .. NWG order the consumer warpgroups' turns at the
// tensor cores (barrier 0 is __syncthreads); each joins two warpgroups,
// the one whose turn it is and the one before it.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[32] += A (shared, K-major) * B (shared, K-major), m64n64k16
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[32] = A (shared, K-major) * B (shared, K-major), m64n64k16, first step
__device__ __forceinline__ void wgmma_ss_n64_first(float* d, uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// d[64] += A (shared, K-major) * B (shared, K-major), m64n128k16
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d[64] = A (shared, K-major) * B (shared, K-major), m64n128k16: the
// first step of a product, which writes d without reading it (so the
// registers are free between products)
__device__ __forceinline__ void wgmma_ss_n128_first(float* d, uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// d[32] += A (registers) * B (shared, MN-major), m64n64k16
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A (registers) * B (shared, MN-major), m64n128k16
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         bool first) {
  static_assert(N == 64 || N == 128, "S = Q K^T takes BK 64 or 128");
  if constexpr (N == 64) {
    if (first)
      wgmma_ss_n64_first(d, da, db);
    else
      wgmma_ss_n64(d, da, db);
  } else {
    if (first)
      wgmma_ss_n128_first(d, da, db);
    else
      wgmma_ss_n128(d, da, db);
  }
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "O += P V takes D 64 or 128");
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------
// Shared memory of one block, from a 1024-byte aligned base (the swizzle's
// period): the Q tile as (warpgroup, atom) blocks of 64 rows, then STAGES K
// tiles, STAGES V tiles (each DC atoms of BK rows), then the mbarriers
// full[STAGES], empty[STAGES] and q.
template <class C>
struct Smem {
  static constexpr int DC = C::D / ATOM;                     // atoms a row
  static constexpr int Q_ATOM = WG_ROWS * ATOM_ROW_BYTES;    // 8 KB
  static constexpr int KV_ATOM = C::BK * ATOM_ROW_BYTES;     // 16 KB
  static constexpr int Q_BYTES = C::NWG * WG_ROWS * C::D * 2;
  static constexpr int KV_BYTES = C::BK * C::D * 2;          // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + C::STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + C::STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (2 * C::STAGES + 1) + 1024;
};

// One block per (BQ-row query tile, batch x query head); blockIdx.x walks
// the heads fastest and the query tiles from the last (the longest causal
// band) to the first. The tiles are aligned to the end of the sequence, so
// a ragged S leaves its idle rows (before row 0) in the first tile, whose
// causal band is the shortest, and never in the last.
template <class C>
__global__ void __launch_bounds__(128 * (C::NWG + 1), 1)
fa_tc_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             __nv_bfloat16* __restrict__ out, int S, int Sk, int Hq, int Hk,
             int BH, int causal, int window, int q_offset, float scale_log2) {
  using L = Smem<C>;
  constexpr int D = C::D, BK = C::BK, STAGES = C::STAGES, NWG = C::NWG;
  constexpr int BQ = NWG * WG_ROWS, CONSUMERS = NWG * 128;
  constexpr int DC = L::DC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + L::K_OFF;
  const uint32_t v_s = base + L::V_OFF;
  const uint32_t bars = base + L::BAR_OFF;
  const uint32_t q_bar = bars + 16u * STAGES;

  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hk);
  const int q0 = S - (n_qt - qt) * BQ;       // negative in a ragged first tile

  // KV tiles of the band: key positions [lo_pos, hi_pos) can be visible
  const int first_pos = max(q0, 0) + q_offset;
  const int last_pos = q0 + BQ - 1 + q_offset;
  const int hi_pos = causal ? min(last_pos + 1, Sk) : Sk;
  const int lo_pos = window > 0 ? max(first_pos - window + 1, 0) : 0;
  const int kt_lo = lo_pos / BK;
  const int kt_hi = hi_pos > 0 ? (hi_pos + BK - 1) / BK : 0;
  const int n_kt = max(kt_hi - kt_lo, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8u * s, 1);
      mbar_init(bars + 8u * (STAGES + s), CONSUMERS);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      // a warpgroup whose 64 rows all lie before row 0 gets no Q (its rows
      // are never stored); rows before 0 in a loaded box read zeros
      const int w0 = q0 < 0 ? -q0 / WG_ROWS : 0;
      mbar_expect_tx(q_bar, (NWG - w0) * L::Q_ATOM * DC);
      for (int w = w0; w < NWG; ++w)
        for (int c = 0; c < DC; ++c)
          tma_load_4d(q_s + (w * DC + c) * L::Q_ATOM, &tq, c * ATOM, h,
                      q0 + w * WG_ROWS, b, q_bar);
      for (int i = 0; i < n_kt; ++i) {
        const int st = i % STAGES;
        const uint32_t phase = (i / STAGES) & 1;
        mbar_wait(bars + 8u * (STAGES + st), phase ^ 1);
        const uint32_t full = bars + 8u * st;
        mbar_expect_tx(full, 2 * L::KV_BYTES);
        const int k0 = (kt_lo + i) * BK;
        for (int c = 0; c < DC; ++c) {
          tma_load_4d(k_s + st * L::KV_BYTES + c * L::KV_ATOM, &tk, c * ATOM,
                      hk, k0, b, full);
          tma_load_4d(v_s + st * L::KV_BYTES + c * L::KV_ATOM, &tv, c * ATOM,
                      hk, k0, b, full);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::REGS));
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  // this thread's accumulator rows (r and r + 8 of the warpgroup's 64) and
  // its first column in every group of 8
  const int r = (t / 32) * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  const int row0 = q0 + wg * WG_ROWS + r;
  const int pos0 = row0 + q_offset;
  const int pos1 = pos0 + 8;
  const int wg_first = q0 + wg * WG_ROWS + q_offset;
  const int wg_last = wg_first + WG_ROWS - 1;

  float s[BK / 2];       // S tile: rows r / r + 8, BK / 4 columns each
  float o[D / 2];        // output accumulator, same layout over D columns
  uint32_t p[BK / 4];    // P as bf16 pairs: the A fragments of O += P V
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = -1e30f, m1 = -1e30f;   // running max, log2 units
  float l0 = 0.f, l1 = 0.f;         // this thread's share of the row sums

  mbar_wait(q_bar, 0);
  const uint32_t q_wg = q_s + wg * DC * L::Q_ATOM;
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (STAGES + st); };

  // S = Q K^T of the tile in stage st: K-major operands, 16 columns of D a
  // step (32 bytes inside a 128-byte atom row, the next atom every 4)
  auto issue_s = [&](int st) {
    const uint32_t ks = k_s + st * L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = q_wg + (kk / 4) * L::Q_ATOM + (kk % 4) * 32;
      const uint32_t bk = ks + (kk / 4) * L::KV_ATOM + (kk % 4) * 32;
      wgmma_ss<BK>(s, sw128_desc(a, 16, 1024), sw128_desc(bk, 16, 1024),
                   kk == 0);
    }
    wgmma_commit();
  };
  // O += P V of the tile in stage st: V MN-major (D contiguous), 16 keys a
  // step = 16 rows of 128 bytes; D 128's second atom lies KV_ATOM further
  auto issue_pv = [&](int st) {
    const uint32_t vs = v_s + st * L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(o, p + 4 * kk,
                  sw128_desc(vs + kk * 16 * ATOM_ROW_BYTES, L::KV_ATOM, 1024));
    wgmma_commit();
  };
  // Online softmax of the tile at key k0, in log2 units (x = s scale
  // log2(e)): masks where the tile crosses Sk, the diagonal or the window;
  // the new running max, its corrections of the old rows, the row sums;
  // p = 2^(x - m) overwrites s. Masked scores are -inf: they leave m finite
  // and give p = 0.
  auto softmax = [&](int k0, float& corr0, float& corr1) {
    const bool edge = k0 + BK > Sk ||
                      (causal && k0 + BK - 1 > wg_first) ||
                      (window > 0 && k0 <= wg_last - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + c2 + (e & 1);
          const int qpos = (e & 2) ? pos1 : pos0;
          const bool vis = kpos < Sk && (!causal || qpos >= kpos) &&
                           (window <= 0 || qpos - kpos < window);
          if (!vis) s[4 * j + e] = -INFINITY;
        }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    corr0 = ex2(m0 - mn0);
    corr1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -mn0));
      s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -mn0));
      s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -mn1));
      s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -mn1));
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
  };
  // P as bf16 pairs: 8-column group j is half of 16-key step j / 2, rows r
  // then r + 8 -- the A fragment of O += P V
  auto pack_p = [&]() {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      p[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
      p[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
  };

  // The products of one warpgroup run one tile apart: while O += P V of
  // tile i - 1 runs on the tensor cores, the softmax of tile i (whose
  // S = Q K^T was issued just before it) runs on the other pipes.
  // Turns: the warpgroups issue their products in turn, round robin, so
  // the others run their softmax while the tensor cores work for one.
  // Warpgroup w waits on barrier 1 + w for its turn and passes it on to
  // the next warpgroup's barrier.
  auto my_turn = [&]() { named_sync(1 + wg); };
  auto your_turn = [&]() { named_arrive(1 + (wg + 1) % NWG); };
  if (wg == NWG - 1) named_arrive(1);           // warpgroup 0 goes first
  float corr0, corr1;
  if (n_kt > 0) {
    mbar_wait(full(0), 0);
    my_turn();
    wgmma_fence();
    issue_s(0);
    your_turn();
    wgmma_wait<0>();
    fence_regs<BK / 2>(s);
    softmax(kt_lo * BK, corr0, corr1);
    pack_p();
  }
  for (int i = 1; i < n_kt; ++i) {
    const int st = i % STAGES;
    const int prev = (i - 1) % STAGES;
    mbar_wait(full(st), (i / STAGES) & 1);
    fence_regs<D / 2>(o);
    fence_regs<BK / 4>(p);
    my_turn();
    wgmma_fence();
    issue_s(st);
    issue_pv(prev);
    your_turn();
    wgmma_wait<1>();                  // S of tile i is in
    fence_regs<BK / 2>(s);
    softmax((kt_lo + i) * BK, corr0, corr1);
    wgmma_wait<0>();                  // O += P V of tile i - 1 is in
    fence_regs<D / 2>(o);
    fence_regs<BK / 4>(p);
    mbar_arrive(empty(prev));
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }
    pack_p();
  }
  if (n_kt > 0) {
    const int last = (n_kt - 1) % STAGES;
    fence_regs<D / 2>(o);
    fence_regs<BK / 4>(p);
    my_turn();
    wgmma_fence();
    issue_pv(last);
    your_turn();
    wgmma_wait<0>();
    fence_regs<D / 2>(o);
    fence_regs<BK / 4>(p);
    mbar_arrive(empty(last));
  }
  if (wg == 0) named_sync(1);                   // the last warpgroup's pass

  // out = O / max(l, 1e-30), rows before 0 not stored
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xFFFFFFFFu, l0, off);
    l1 += __shfl_xor_sync(0xFFFFFFFFu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int64_t stride = static_cast<int64_t>(Hq) * D;
  __nv_bfloat16* ob = out + static_cast<int64_t>(b) * S * stride + h * D;
  if (row0 >= 0) {
    __nv_bfloat16* orow = ob + row0 * stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c2) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
  }
  if (row0 + 8 >= 0) {
    __nv_bfloat16* orow = ob + (row0 + 8) * stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c2) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime's entry-point
// query, so the library needs no -lcuda at link time.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// The 4-D map of a contiguous [B, S, H, D] bf16 tensor: `map_args` holds
// dims (D, H, S, B) and the byte strides of dims 1-3, as the wrapper's
// `tensor_map_args` computes them; a box is one 64-column atom of `rows`
// rows of one head, written 128-byte swizzled.
inline bool encode_map(CUtensorMap* map, const void* ptr,
                       const unsigned long long* map_args, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {map_args[0], map_args[1], map_args[2],
                              map_args[3]};
  const cuuint64_t strides[3] = {map_args[4], map_args[5], map_args[6]};
  const cuuint32_t box[4] = {ATOM, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
constexpr int smem_bytes() {
  return Smem<Config<D>>::BYTES;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           const unsigned long long* q_map, const unsigned long long* kv_map,
           int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  using C = Config<D>;
  using L = Smem<C>;
  constexpr int BQ = C::NWG * WG_ROWS;
  const int Hq = static_cast<int>(q_map[1]);
  const int S = static_cast<int>(q_map[2]);
  const int B = static_cast<int>(q_map[3]);
  const int Hk = static_cast<int>(kv_map[1]);
  const int Sk = static_cast<int>(kv_map[2]);
  const long long bh = static_cast<long long>(B) * Hq;
  const long long blocks = bh * ((S + BQ - 1) / BQ);
  if (blocks > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, q_map, WG_ROWS) ||
      !encode_map(&tk, k, kv_map, C::BK) || !encode_map(&tv, v, kv_map, C::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fa_tc_kernel<C>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), 128 * (C::NWG + 1), L::BYTES,
           stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), S, Sk, Hq, Hk,
      static_cast<int>(bh), causal, window, q_offset,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fa_tc
