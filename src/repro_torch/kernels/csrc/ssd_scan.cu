// ssd_scan: the Mamba2 SSD chunked scan (its core, without the D skip) on
// Hopper's tensor cores, in chunk-parallel form.
//
// Replaces the Pallas kernel `ssd_scan_pallas` (body `_ssd_kernel`,
// src/repro/kernels/ssd_scan.py:61). x [b, S, H, P], dt [b, S, H]
// (positive), A [H] float32 (negative), B and C [b, S, N] (one group, shared
// by every head).
// Per chunk c of Q rows and per head, with cum = cumsum(dt A) and
// last = cum at the chunk's end:
//   inc_c = B^T (exp(last - cum_k) dt_k x_k)
//   h_c   = exp(last) h_{c-1} + inc_c                  (h_{-1} = 0)
//   y     = ((C B^T) o exp(cum_q - cum_k) dt_k, causal k <= q) x
//           + exp(cum_q) (C h_{c-1})
// y is written in x's type and the last h_c [b, H, N, P] float32 beside it.
// Rows at or past S are masked as the reference pads them: dt = 0,
// x = B = C = 0.
//
// inc_c needs chunk c alone, so only the cheap recurrence on h runs in
// chunk order. Three kernels, launched one after another on one stream:
//   1. ssd_state, a block per (batch, chunk, head, 64 columns of P):
//      inc_c = (w o B)^T x with w = exp(last - cum) dt, written to the
//      state scratch [b, nc, H, N, P], and exp(last) to [b, nc, H]. One more
//      block per (batch, chunk) computes G = C B^T [Q, Q] into the gram
//      scratch [b, nc, Q16, Q16]: once for all heads.
//   2. ssd_pass, a thread per (batch, head, 4 elements of N x P): walks
//      the chunks, writes the state entering each one, already split into
//      the bf16 parts kernel 3 multiplies, and the final state.
//   3. ssd_out, a block per (batch, chunk, head, 64 columns of P):
//      y = exp(cum_q) (C h_{c-1}) + M x, where a warp owns 16 rows and
//      builds its rows of M = G o exp(cum_q - cum_k) dt_k (masked before
//      the exponential, as the reference does) in registers, as the A
//      operand of the product.
// The state passing is a separate pass, not a look-back inside one launch:
// the look-back would make every chunk wait one L2 round trip for the
// chunk before it (nc of them in series, 256 at S 32768), while the pass
// runs every (batch, head, element) at once and is bound by the bytes of
// the states; it has no spin that could hang, and no block depends on
// another's schedule.
//
// Products: mma.sync m16n8k16, bf16 operands, float32 accumulators,
// operands fed by ldmatrix from shared memory (rows padded by 16 bytes, so
// the eight rows of an 8 x 8 matrix fall in distinct banks). A product of
// two bf16 inputs (C B^T in the bf16 route) is exact in one MMA. An operand
// that holds float32 values (w o B, M, h, and any float32 input) is split
// into K bf16 parts, v = v_0 + v_1 (+ v_2), and the product takes the
// pairs of parts (i, j) with i + j < K: no float32 value is rounded to
// bf16. K is 2 when x is bf16 (y is rounded to bf16; the remainder is
// below 2^-17 |v|) and 3 when x is float32 (the parts hold all 24 bits, and
// the pairs left out are below 2^-24 of the product): a two-part split
// misses float32's 2e-4 where long sums cancel. Exponentials are expf.
//
// Staging: a bf16 tile whose rows are 16-byte aligned is copied by
// cp.async, 16 bytes a thread at a time, with no registers (x, B and C in
// the bf16 route, and the entering states, which kernel 2 writes already
// split); w o B is then scaled and split in shared memory. Anything else
// goes through registers, eight columns a thread, the loads of four items
// issued before any is stored.
//
// Bound on this card: bytes. Each input read once and y and h written once
// is about 56 MB at b 2, S 4096, H 24, P 64, N 128 in bf16, 17 us at
// 3.35 TB/s, against 8.2 GFLOP. The chunk states go through device memory
// four times (inc_c written by 1 and read by 2, the entering states written
// by 2 and read by 3: 50 MB each at that shape), and x is read twice.
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int QMAX = 128;      // largest chunk
constexpr int NMAX = 128;      // largest state size
constexpr int PT = 64;         // columns of P a block owns
constexpr int LDN = NMAX + 8;  // bf16 row stride of [row][n] tiles (272 B)
constexpr int LDP = PT + 8;    // bf16 row stride of [row][p] tiles (144 B)
constexpr int PIECE_N = QMAX * LDN;   // elements of a [128][LDN] tile part
constexpr int PIECE_P = QMAX * LDP;   // elements of a [128][LDP] tile part
constexpr int STAGE_UNROLL = 4;       // items a thread loads before it stores
constexpr int PASS_THREADS = 256;
constexpr float NEG_INF = -1e30f;

// Parts of an operand: a bf16 input is used as it is (1), a float32 value
// is split into K bf16 parts.
template <typename T, int K>
constexpr int kParts = std::is_same<T, float>::value ? K : 1;
// K: 3 parts for a float32 x (float32 output), else 2.
template <typename TX>
constexpr int kSplit = std::is_same<TX, float>::value ? 3 : 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, bf16* dst) {
  *dst = __float2bfloat16_rn(v);
}
// (v0, v1) to dst[0..1], one 8- or 4-byte store (dst aligned to it).
__device__ __forceinline__ void store2(float v0, float v1, float* dst) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(float v0, float v1, bf16* dst) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

// (v0, v1) split into K packed bf16 pairs: out[p][idx] holds part p (v0 in
// the low half).
template <int K>
__device__ __forceinline__ void split_pack(float v0, float v1,
                                           uint32_t (&out)[K][4], int idx) {
#pragma unroll
  for (int p = 0; p < K; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    out[p][idx] = reinterpret_cast<const uint32_t&>(h);
    v0 -= __low2float(h);
    v1 -= __high2float(h);
  }
}

// ---------------------------------------------------------------------------
// PTX wrappers: ldmatrix, mma.sync
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// 16 bytes global -> shared without registers; src_bytes < 16 fills the rest
// with zeros (0: all zeros, nothing read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(src_bytes)
      : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments. A thread of the warp is (g, t) = (lane / 4, lane % 4); it holds
// A rows g and g + 8 at k 2t, 2t + 1 (and + 8), B column g at k 2t, 2t + 1
// (and + 8), and accumulator rows g and g + 8 at columns 2t, 2t + 1.

// A (16 x 16 at m0, k0) of a tile stored [m][k].
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s, int ld,
                                       int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, s + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// A (16 x 16 at m0, k0) of a tile stored [k][m].
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], const bf16* s,
                                         int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(a, s + (k0 + (lane & 7) + (lane >> 4) * 8) * ld + m0 +
                   ((lane >> 3) & 1) * 8);
}

// B of the two 8-column tiles at n0 and n0 + 8 over k0 .. k0 + 15, of a tile
// stored [n][k]: {b0, b1} of n0, then {b0, b1} of n0 + 8.
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* s, int ld,
                                       int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, s + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                 ((lane >> 3) & 1) * 8);
}

// The same from a tile stored [k][n].
__device__ __forceinline__ void frag_b_t(uint32_t (&b)[4], const bf16* s,
                                         int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                   (lane >> 4) * 8);
}

// acc (16 rows x 64 columns, eight 16 x 8 tiles) += A (one 16 x 16 k-step,
// PA parts) times rows k0 .. k0 + 15 of a [k][p] tile of 64 columns (PB
// parts, part j at bt + j * PIECE_P), over the pairs of parts i + j < K.
template <int PA, int PB, int K>
__device__ __forceinline__ void mma_k16(float (&acc)[8][4],
                                        const uint32_t (&a)[PA][4],
                                        const bf16* bt, int k0) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t bf[PB][4];
#pragma unroll
    for (int q = 0; q < PB; ++q)
      frag_b_t(bf[q], bt + q * PIECE_P, LDP, 16 * j, k0);
#pragma unroll
    for (int i = 0; i < PA; ++i)
#pragma unroll
      for (int q = 0; q < PB; ++q)
        if (i + q < K) {
          mma(acc[2 * j], a[i], bf[q][0], bf[q][1]);
          mma(acc[2 * j + 1], a[i], bf[q][2], bf[q][3]);
        }
  }
}

// ---------------------------------------------------------------------------
// Shapes, strides, staging
// ---------------------------------------------------------------------------
struct Dims {
  int S, H, P, N, Q;
  int QP;     // Q rounded up to 16
  int NP;     // N rounded up to 16
  int nc;     // chunks
  int n_ps;   // 64-column slices of P
  // rows of x, B, C and the entering states start 16-byte aligned
  bool vec_x, vec_b, vec_c, vec_h;
};

// Element strides of the batch and sequence axes of one input; its last
// axis is contiguous (x's head axis has stride P).
struct Strides {
  int64_t x_b, x_s, dt_b, dt_s, b_b, b_s, c_b, c_s;
};

constexpr int TILE_N = PIECE_N * 2;    // bytes of one part of an [.][LDN] tile
constexpr int TILE_P = PIECE_P * 2;    // bytes of one part of an [.][LDP] tile
constexpr int VECS = 3 * QMAX * 4;     // three float [128] vectors

// Dynamic shared memory of each kernel, by the parts of its operands.
template <int K, int PX>
constexpr int state_smem() {
  return K * TILE_N + PX * TILE_P + VECS;
}
template <int PC>
constexpr int gram_smem() {
  return 2 * PC * TILE_N;
}
template <int K, int PX, int PC>
constexpr int out_smem() {
  return PC * TILE_N + PX * TILE_P + K * TILE_P + VECS;
}

// Eight elements p[0..7] as float32: one 16-byte load (bf16) or two
// (float32) when `vec` and all eight are in range, else element by element
// (0 where the row is out or past `left` columns).
template <typename T>
__device__ __forceinline__ void load8(float (&v)[8], const T* p, bool row_ok,
                                      int left, bool vec) {
  if (row_ok && vec && left >= 8) {
    if constexpr (std::is_same<T, float>::value) {
      const float4 a = *reinterpret_cast<const float4*>(p);
      const float4 b = *reinterpret_cast<const float4*>(p + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = (row_ok && j < left) ? to_f32(p[j]) : 0.f;
  }
}

// Rows [0, nrows) and columns [0, width) (width a multiple of 8) of a
// row-major source into a bf16 tile [row][LD] of PARTS parts (part p at
// tile + p * QMAX * LD): element (r, col) is src[r * rs + col], times
// scale[r] when a scale is given, where r < rows and col < ncols, else 0.
// Eight columns an item; a thread loads STAGE_UNROLL items, then stores
// them.
template <int PARTS, int LD, typename T>
__device__ __forceinline__ void stage(bf16* tile, const T* src, int64_t rs,
                                      int rows, int ncols, int nrows,
                                      int width, const float* scale,
                                      bool vec) {
  const int per_row = width >> 3;
  const int items = nrows * per_row;
  for (int base = threadIdx.x; base < items;
       base += THREADS * STAGE_UNROLL) {
    float v[STAGE_UNROLL][8];
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int i = base + u * THREADS;
      const int r = i / per_row;
      const int col = (i - r * per_row) * 8;
      load8(v[u], src + r * rs + col, i < items && r < rows, ncols - col,
            vec);
    }
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int i = base + u * THREADS;
      if (i >= items) break;
      const int r = i / per_row;
      const int col = (i - r * per_row) * 8;
      if (scale != nullptr) {
        const float sc = scale[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[u][j] *= sc;
      }
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
        uint4 out;
        bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[j] = __float2bfloat16_rn(v[u][j]);
          v[u][j] -= __bfloat162float(o[j]);
        }
        *reinterpret_cast<uint4*>(tile + p * QMAX * LD + r * LD + col) = out;
      }
    }
  }
}

// The same for a bf16 source copied as it is (one part, no scale) when its
// rows are 16-byte aligned: cp.async, no registers; the caller waits with
// cp_async_wait_all. A ragged item (past ncols) is filled element by
// element.
template <int LD>
__device__ __forceinline__ void stage_async(bf16* tile, const bf16* src,
                                            int64_t rs, int rows, int ncols,
                                            int nrows, int width) {
  const int per_row = width >> 3;
  for (int i = threadIdx.x; i < nrows * per_row; i += THREADS) {
    const int r = i / per_row;
    const int col = (i - r * per_row) * 8;
    bf16* dst = tile + r * LD + col;
    const int left = ncols - col;
    if (r < rows && left > 0 && left < 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = j < left ? src[r * rs + col + j] : __float2bfloat16_rn(0.f);
    } else {
      const bool in = r < rows && left > 0;
      cp_async16(dst, in ? src + r * rs + col : src, in ? 16 : 0);
    }
  }
}

// A tile of K parts whose part 1 holds raw bf16 values (rows [0, nrows),
// columns [0, width)): every part p becomes part p of raw * scale[r]. Each
// thread reads and rewrites only its own elements.
template <int K, int LD>
__device__ __forceinline__ void split_in_place(bf16* tile, int nrows,
                                               int width,
                                               const float* scale) {
  const int per_row = width >> 3;
  for (int i = threadIdx.x; i < nrows * per_row; i += THREADS) {
    const int r = i / per_row;
    const int at = r * LD + (i - r * per_row) * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(tile + QMAX * LD + at);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
    const float sc = scale[r];
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]) * sc;
#pragma unroll
    for (int p = 0; p < K; ++p) {
      uint4 out;
      bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j] = __float2bfloat16_rn(v[j]);
        v[j] -= __bfloat162float(o[j]);
      }
      *reinterpret_cast<uint4*>(tile + p * QMAX * LD + at) = out;
    }
  }
}

// A narrow (bf16, one part) input tile by cp.async when aligned, else
// through registers; a float32 input through registers, split.
template <int PARTS, int LD, typename T>
__device__ __forceinline__ void stage_input(bf16* tile, const T* src,
                                            int64_t rs, int rows, int ncols,
                                            int nrows, int width, bool vec) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (vec) {
      stage_async<LD>(tile, src, rs, rows, ncols, nrows, width);
      return;
    }
  }
  stage<PARTS, LD>(tile, src, rs, rows, ncols, nrows, width, nullptr, vec);
}

// Warp 0: dtv[r] = dt of row r of the chunk (0 at and past `rows`), cum[r]
// = the inclusive prefix sum of dt A, for r < 128 (4 rows a lane).
template <typename TD>
__device__ __forceinline__ void chunk_cumsum(const TD* db, int64_t dt_s,
                                             float a, int rows, float* dtv,
                                             float* cum) {
  const int lane = threadIdx.x & 31;
  float loc[4];
  float run = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = 4 * lane + j;
    const float d = r < rows ? to_f32(db[r * dt_s]) : 0.f;
    dtv[r] = d;
    run = __fadd_rn(run, __fmul_rn(d, a));
    loc[j] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, t);
  }
  float excl = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) cum[4 * lane + j] = __fadd_rn(excl, loc[j]);
  __syncwarp();
}

// ---------------------------------------------------------------------------
// 1. chunk states and the gram matrix
// ---------------------------------------------------------------------------
// G = C B^T of one (batch, chunk): [q][j] over the lower triangle of 16 x 16
// tiles (the ones kernel 3 reads), a warp a tile at a time.
template <typename TBC, int K>
__device__ __forceinline__ void gram_block(const TBC* bb, const TBC* cb,
                                           const Dims& d, const Strides& st,
                                           float* gq, int rows,
                                           unsigned char* smem) {
  constexpr int PC = kParts<TBC, K>;
  bf16* ct = reinterpret_cast<bf16*>(smem);      // [q][n], PC parts
  bf16* bt = ct + PC * PIECE_N;                  // [j][n], PC parts
  stage_input<PC, LDN>(ct, cb, st.c_s, rows, d.N, d.QP, d.NP, d.vec_c);
  stage_input<PC, LDN>(bt, bb, st.b_s, rows, d.N, d.QP, d.NP, d.vec_b);
  cp_async_wait_all();
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qt_n = d.QP / 16;
  for (int u = threadIdx.x >> 5; u < qt_n * (qt_n + 1) / 2; u += WARPS) {
    int qt = 0, jt = u;
    while (jt > qt) jt -= ++qt;
    float acc[2][4] = {};
    for (int k0 = 0; k0 < d.NP; k0 += 16) {
      uint32_t a[PC][4], bf[PC][4];
#pragma unroll
      for (int p = 0; p < PC; ++p) {
        frag_a(a[p], ct + p * PIECE_N, LDN, 16 * qt, k0);
        frag_b(bf[p], bt + p * PIECE_N, LDN, 16 * jt, k0);
      }
#pragma unroll
      for (int i = 0; i < PC; ++i)
#pragma unroll
        for (int q = 0; q < PC; ++q)
          if (i + q < K) {
            mma(acc[0], a[i], bf[q][0], bf[q][1]);
            mma(acc[1], a[i], bf[q][2], bf[q][3]);
          }
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = 16 * qt + g + 8 * half;
        const int j = 16 * jt + 8 * jj + 2 * t;
        *reinterpret_cast<float2*>(gq + q * d.QP + j) =
            make_float2(acc[jj][2 * half], acc[jj][2 * half + 1]);
      }
  }
}

template <typename TX, typename TBC, typename TD>
__global__ void __launch_bounds__(THREADS, 2)
ssd_state(const TX* __restrict__ x, const TD* __restrict__ dt,
             const float* __restrict__ A, const TBC* __restrict__ Bm,
             const TBC* __restrict__ Cm, float* __restrict__ states,
             float* __restrict__ gram, float* __restrict__ decay, Dims d,
             Strides st) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int K = kSplit<TX>;
  constexpr int PX = kParts<TX, K>;
  const int c = blockIdx.x;
  const int b = blockIdx.z;
  const int s0 = c * d.Q;
  const int rows = min(d.Q, d.S - s0);
  const TBC* bb = Bm + b * st.b_b + static_cast<int64_t>(s0) * st.b_s;
  if (blockIdx.y == d.H * d.n_ps) {
    gram_block<TBC, K>(
        bb, Cm + b * st.c_b + static_cast<int64_t>(s0) * st.c_s, d, st,
        gram + (static_cast<int64_t>(b) * d.nc + c) * d.QP * d.QP, rows,
        smem);
    return;
  }
  const int h = blockIdx.y / d.n_ps;
  const int p0 = (blockIdx.y - h * d.n_ps) * PT;
  const int pn = min(PT, d.P - p0);
  bf16* bw = reinterpret_cast<bf16*>(smem);   // [k][n]: w_k B[k][n], K parts
  bf16* xt = bw + K * PIECE_N;                // [k][p], PX parts
  float* cum = reinterpret_cast<float*>(xt + PX * PIECE_P);
  float* dtv = cum + QMAX;
  float* wv = dtv + QMAX;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp == 0) {
    chunk_cumsum(dt + b * st.dt_b + static_cast<int64_t>(s0) * st.dt_s + h,
                 st.dt_s, A[h], rows, dtv, cum);
    const float last = cum[rows - 1];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * lane + j;
      wv[r] = expf(last - cum[r]) * dtv[r];
    }
    if (lane == 0 && p0 == 0)
      decay[(static_cast<int64_t>(b) * d.nc + c) * d.H + h] = expf(last);
  }
  stage_input<PX, LDP>(
      xt, x + b * st.x_b + static_cast<int64_t>(s0) * st.x_s + h * d.P + p0,
      st.x_s, rows, pn, d.QP, PT, d.vec_x);
  // w o B: a bf16 B arrives raw in part 1 while warp 0 computes w, then is
  // scaled and split in place
  constexpr bool kRawB = std::is_same<TBC, bf16>::value;
  if constexpr (kRawB) {
    if (d.vec_b)
      stage_async<LDN>(bw + PIECE_N, bb, st.b_s, rows, d.N, d.QP, d.NP);
  }
  cp_async_wait_all();
  __syncthreads();
  if (kRawB && d.vec_b) {
    split_in_place<K, LDN>(bw, d.QP, d.NP, wv);
  } else {
    stage<K, LDN>(bw, bb, st.b_s, rows, d.N, d.QP, d.NP, wv, d.vec_b);
  }
  __syncthreads();

  // inc[n][p] = sum_k (w o B)[k][n] x[k][p]; warp w owns rows 16w .. 16w + 15
  const int m0 = 16 * warp;
  if (m0 >= d.NP) return;
  float acc[8][4] = {};
  for (int k0 = 0; k0 < d.QP; k0 += 16) {
    uint32_t a[K][4];
#pragma unroll
    for (int p = 0; p < K; ++p) frag_a_t(a[p], bw + p * PIECE_N, LDN, m0, k0);
    mma_k16<K, PX, K>(acc, a, xt, k0);
  }
  float* out = states +
               ((static_cast<int64_t>(b) * d.nc + c) * d.H + h) * d.N * d.P +
               p0;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool pairs = (d.P & 1) == 0;   // (p, p + 1) 8-byte aligned
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = m0 + g + 8 * half;
      const int p = 8 * j + 2 * t;
      if (n >= d.N || p >= pn) continue;
      float* o = out + n * d.P + p;
      if (pairs && p + 1 < pn) {
        *reinterpret_cast<float2*>(o) =
            make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
      } else {
        o[0] = acc[j][2 * half];
        if (p + 1 < pn) o[1] = acc[j][2 * half + 1];
      }
    }
}

// ---------------------------------------------------------------------------
// 2. state passing
// ---------------------------------------------------------------------------
// One thread per (batch, head, VEC elements of N x P): h = 0; for every
// chunk, the state entering it goes to `enter` as K bf16 parts
// [b, nc, H, K, N, P] (the form kernel 3 multiplies), and
// h = h exp(last_c) + inc_c, rounded as the plain version rounds it; the
// last h is the output. Loads of eight chunks go out before their stores.
// VEC is 4 (16-byte loads) when N P is a multiple of 4.
template <int VEC, int K>
__global__ void __launch_bounds__(PASS_THREADS)
ssd_pass(const float* __restrict__ states, const float* __restrict__ decay,
            bf16* __restrict__ enter, float* __restrict__ h_out, int nc,
            int H, int np_elems) {
  using V = typename std::conditional<VEC == 4, float4, float>::type;
  using W = typename std::conditional<VEC == 4, uint2, bf16>::type;
  const int e = (blockIdx.x * PASS_THREADS + threadIdx.x) * VEC;
  if (e >= np_elems) return;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t slab = static_cast<int64_t>(b) * nc * H + h;   // (b, 0, h)
  const V* st = reinterpret_cast<const V*>(states + slab * np_elems + e);
  bf16* en = enter + slab * K * np_elems + e;
  const int64_t stride = static_cast<int64_t>(H) * np_elems / VEC;
  const float* dec = decay + slab;
  float hv[VEC] = {};
  for (int c0 = 0; c0 < nc; c0 += 8) {
    const int m = min(8, nc - c0);
    V v[8];
    float dv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < m) {
        v[j] = st[(c0 + j) * stride];
        dv[j] = dec[static_cast<int64_t>(c0 + j) * H];
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < m) {
        const float* in = reinterpret_cast<const float*>(&v[j]);
        float rest[VEC];
#pragma unroll
        for (int q = 0; q < VEC; ++q) rest[q] = hv[q];
        bf16* out = en + (static_cast<int64_t>(c0 + j) * H) * K * np_elems;
#pragma unroll
        for (int p = 0; p < K; ++p) {
          W w;
          bf16* o = reinterpret_cast<bf16*>(&w);
#pragma unroll
          for (int q = 0; q < VEC; ++q) {
            o[q] = __float2bfloat16_rn(rest[q]);
            rest[q] -= __bfloat162float(o[q]);
          }
          *reinterpret_cast<W*>(out + p * np_elems) = w;
        }
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          hv[q] = __fadd_rn(__fmul_rn(hv[q], dv[j]), in[q]);
      }
  }
  float* ho = h_out + (static_cast<int64_t>(b) * H + h) * np_elems + e;
#pragma unroll
  for (int q = 0; q < VEC; ++q) ho[q] = hv[q];
}

// ---------------------------------------------------------------------------
// 3. chunk output
// ---------------------------------------------------------------------------
template <typename TX, typename TBC, typename TD>
__global__ void __launch_bounds__(THREADS, 2)
ssd_out(const TX* __restrict__ x, const TD* __restrict__ dt,
           const float* __restrict__ A, const TBC* __restrict__ Cm,
           const bf16* __restrict__ enter, const float* __restrict__ gram,
           TX* __restrict__ y, Dims d, Strides st) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int K = kSplit<TX>;
  constexpr int PX = kParts<TX, K>;
  constexpr int PC = kParts<TBC, K>;
  const int c = blockIdx.x;
  const int h = blockIdx.y / d.n_ps;
  const int p0 = (blockIdx.y - h * d.n_ps) * PT;
  const int b = blockIdx.z;
  const int s0 = c * d.Q;
  const int rows = min(d.Q, d.S - s0);
  const int pn = min(PT, d.P - p0);
  bf16* ct = reinterpret_cast<bf16*>(smem);   // [q][n], PC parts
  bf16* xt = ct + PC * PIECE_N;               // [k][p], PX parts
  bf16* ht = xt + PX * PIECE_P;               // [n][p], K parts
  float* cum = reinterpret_cast<float*>(ht + K * PIECE_P);
  float* dtv = cum + QMAX;
  float* ecum = dtv + QMAX;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp == 0) {
    chunk_cumsum(dt + b * st.dt_b + static_cast<int64_t>(s0) * st.dt_s + h,
                 st.dt_s, A[h], rows, dtv, cum);
#pragma unroll
    for (int j = 0; j < 4; ++j) ecum[4 * lane + j] = expf(cum[4 * lane + j]);
  }
  stage_input<PX, LDP>(
      xt, x + b * st.x_b + static_cast<int64_t>(s0) * st.x_s + h * d.P + p0,
      st.x_s, rows, pn, d.QP, PT, d.vec_x);
  stage_input<PC, LDN>(ct,
                       Cm + b * st.c_b + static_cast<int64_t>(s0) * st.c_s,
                       st.c_s, rows, d.N, d.QP, d.NP, d.vec_c);
  const bf16* hp = enter +
                   ((static_cast<int64_t>(b) * d.nc + c) * d.H + h) * K *
                       d.N * d.P +
                   p0;
#pragma unroll
  for (int p = 0; p < K; ++p)
    stage_input<1, LDP>(ht + p * PIECE_P, hp + p * d.N * d.P, d.P, d.N, pn,
                        d.NP, PT, d.vec_h);
  // warp w owns rows q0 .. q0 + 15 and all 64 columns; the G values of its
  // first k-step are fetched before the barrier, each next one a k-step
  // ahead
  const int q0 = 16 * warp;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qa = q0 + g;
  const int qb = qa + 8;
  const float* gq = gram + (static_cast<int64_t>(b) * d.nc + c) * d.QP * d.QP;
  auto fetch_g = [&](int k0, float2 (&gv)[4]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = k0 + 2 * t + 8 * half;
      gv[2 * half] = *reinterpret_cast<const float2*>(gq + qa * d.QP + k);
      gv[2 * half + 1] = *reinterpret_cast<const float2*>(gq + qb * d.QP + k);
    }
  };
  float2 g_cur[4];
  if (q0 < d.QP) fetch_g(0, g_cur);
  cp_async_wait_all();
  __syncthreads();
  if (q0 >= d.QP) return;
  float acc[8][4] = {};
  // exp(cum_q) (C h_{c-1})
  for (int k0 = 0; k0 < d.NP; k0 += 16) {
    uint32_t a[PC][4];
#pragma unroll
    for (int p = 0; p < PC; ++p) frag_a(a[p], ct + p * PIECE_N, LDN, q0, k0);
    mma_k16<PC, K, K>(acc, a, ht, k0);
  }
  const float ea = ecum[qa];
  const float eb = ecum[qb];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] *= ea;
    acc[j][1] *= ea;
    acc[j][2] *= eb;
    acc[j][3] *= eb;
  }
  // + M x over the k-steps at or below the diagonal
  const float ca = cum[qa];
  const float cbq = cum[qb];
  for (int k0 = 0; k0 <= q0; k0 += 16) {
    float2 g_next[4] = {g_cur[0], g_cur[1], g_cur[2], g_cur[3]};
    if (k0 + 16 <= q0) fetch_g(k0 + 16, g_next);
    uint32_t m[K][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = k0 + 2 * t + 8 * half;
      const float2 ga = g_cur[2 * half];
      const float2 gb = g_cur[2 * half + 1];
      const float ck0 = cum[k], ck1 = cum[k + 1];
      const float d0 = dtv[k], d1 = dtv[k + 1];
      const float ma0 = ga.x * expf(k <= qa ? ca - ck0 : NEG_INF) * d0;
      const float ma1 = ga.y * expf(k + 1 <= qa ? ca - ck1 : NEG_INF) * d1;
      const float mb0 = gb.x * expf(k <= qb ? cbq - ck0 : NEG_INF) * d0;
      const float mb1 = gb.y * expf(k + 1 <= qb ? cbq - ck1 : NEG_INF) * d1;
      split_pack<K>(ma0, ma1, m, 2 * half);
      split_pack<K>(mb0, mb1, m, 2 * half + 1);
    }
    mma_k16<K, PX, K>(acc, m, xt, k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) g_cur[i] = g_next[i];
  }
  TX* yb = y + ((static_cast<int64_t>(b) * d.S + s0) * d.H + h) * d.P + p0;
  const int64_t y_s = static_cast<int64_t>(d.H) * d.P;
  const bool pairs = (d.P & 1) == 0;   // (p, p + 1) aligned for one store
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = qa + 8 * half;
    if (q >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = 8 * j + 2 * t;
      if (p >= pn) continue;
      TX* o = yb + q * y_s + p;
      if (pairs && p + 1 < pn) {
        store2(acc[j][2 * half], acc[j][2 * half + 1], o);
      } else {
        store(acc[j][2 * half], o);
        if (p + 1 < pn) store(acc[j][2 * half + 1], o + 1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <typename TX, typename TBC, typename TD>
int launch(const void* x, const void* dt, const float* A, const void* B,
           const void* C, void* y, float* h_out, float* states, float* gram,
           float* decay, bf16* enter, int batch, const Dims& d,
           const Strides& st, cudaStream_t stream) {
  constexpr int K = kSplit<TX>;
  constexpr int PX = kParts<TX, K>;
  constexpr int PC = kParts<TBC, K>;
  constexpr int smem1 = state_smem<K, PX>() > gram_smem<PC>()
                            ? state_smem<K, PX>()
                            : gram_smem<PC>();
  constexpr int smem3 = out_smem<K, PX, PC>();
  auto k1 = ssd_state<TX, TBC, TD>;
  auto k3 = ssd_out<TX, TBC, TD>;
  cudaError_t e = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem3);
  if (e != cudaSuccess) return static_cast<int>(e);
  const TX* xp = static_cast<const TX*>(x);
  const TD* dtp = static_cast<const TD*>(dt);
  k1<<<dim3(d.nc, d.H * d.n_ps + 1, batch), THREADS, smem1, stream>>>(
      xp, dtp, A, static_cast<const TBC*>(B), static_cast<const TBC*>(C),
      states, gram, decay, d, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int np_elems = d.N * d.P;
  if (np_elems % 4 == 0) {
    ssd_pass<4, K><<<dim3((np_elems / 4 + PASS_THREADS - 1) /
                                 PASS_THREADS,
                             d.H, batch),
                        PASS_THREADS, 0, stream>>>(states, decay, enter, h_out,
                                                   d.nc, d.H, np_elems);
  } else {
    ssd_pass<1, K><<<dim3((np_elems + PASS_THREADS - 1) / PASS_THREADS,
                             d.H, batch),
                        PASS_THREADS, 0, stream>>>(states, decay, enter, h_out,
                                                   d.nc, d.H, np_elems);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  k3<<<dim3(d.nc, d.H * d.n_ps, batch), THREADS, smem3, stream>>>(
      xp, dtp, A, static_cast<const TBC*>(C), enter, gram,
      static_cast<TX*>(y), d, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TBC>
int launch_dt(int dt_dtype, const void* x, const void* dt, const float* A,
              const void* B, const void* C, void* y, float* h_out,
              float* states, float* gram, float* decay, bf16* enter,
              int batch, const Dims& d, const Strides& st,
              cudaStream_t stream) {
  if (dt_dtype == 0)
    return launch<TX, TBC, float>(x, dt, A, B, C, y, h_out, states, gram,
                                  decay, enter, batch, d, st, stream);
  if (dt_dtype == 1)
    return launch<TX, TBC, bf16>(x, dt, A, B, C, y, h_out, states, gram,
                                 decay, enter, batch, d, st, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Every row of an input starts 16-byte aligned: its base address, its batch
// and sequence strides and (for x) the head offset are multiples of 16.
bool rows_aligned(const void* p, int64_t stride_b, int64_t stride_s,
                  int64_t extra, int size) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (stride_b * size) % 16 == 0 && (stride_s * size) % 16 == 0 &&
         (extra * size) % 16 == 0;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtypes: 0 float32, 1 bfloat16 (x_dtype is also y's; B and C share
// bc_dtype). Strides are in elements; every input's last axis is contiguous
// and x's head axis has stride P. y [batch, S, H, P] and h_out
// [batch, H, N, P] float32 are contiguous. Scratch: states [batch, nc, H, N,
// P], gram [batch, nc, Q16, Q16] and decay [batch, nc, H], float32, and
// enter [batch, nc, H, K, N, P] bf16 with K = 3 for a float32 x, else 2;
// nc = ceil(S / Q), Q16 = Q rounded up to 16. Returns a CUDA error code (0
// on success); launches three kernels on `stream`, no sync, no allocation.
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, void* y, void* h_out,
                       void* states, void* gram, void* decay, void* enter,
                       int batch, int S, int H, int P, int N, int Q,
                       int64_t x_b, int64_t x_s, int64_t dt_b, int64_t dt_s,
                       int64_t b_b, int64_t b_s, int64_t c_b, int64_t c_s,
                       int x_dtype, int bc_dtype, int dt_dtype, void* stream) {
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || S <= 0 || H <= 0 || P <= 0) return 0;
  const int n_ps = (P + PT - 1) / PT;
  if (Q < 1 || Q > QMAX || N < 1 || N > NMAX || batch > 65535 ||
      static_cast<int64_t>(H) * n_ps + 1 > 65535 || x_dtype < 0 ||
      x_dtype > 1 || bc_dtype < 0 || bc_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int xs = x_dtype == 0 ? 4 : 2;
  const int bs = bc_dtype == 0 ? 4 : 2;
  const Dims d{S, H, P, N, Q, (Q + 15) / 16 * 16, (N + 15) / 16 * 16,
               (S + Q - 1) / Q, n_ps,
               rows_aligned(x, x_b, x_s, P, xs),
               rows_aligned(B, b_b, b_s, 0, bs),
               rows_aligned(C, c_b, c_s, 0, bs),
               P % 8 == 0};
  const Strides st{x_b, x_s, dt_b, dt_s, b_b, b_s, c_b, c_s};
  const float* a = static_cast<const float*>(A);
  float* ho = static_cast<float*>(h_out);
  float* sts = static_cast<float*>(states);
  float* gr = static_cast<float*>(gram);
  float* dc = static_cast<float*>(decay);
  bf16* en = static_cast<bf16*>(enter);
  if (x_dtype == 0 && bc_dtype == 0)
    return launch_dt<float, float>(dt_dtype, x, dt, a, B, C, y, ho, sts, gr,
                                   dc, en, batch, d, st, sm);
  if (x_dtype == 0)
    return launch_dt<float, bf16>(dt_dtype, x, dt, a, B, C, y, ho, sts, gr,
                                  dc, en, batch, d, st, sm);
  if (bc_dtype == 0)
    return launch_dt<bf16, float>(dt_dtype, x, dt, a, B, C, y, ho, sts, gr,
                                  dc, en, batch, d, st, sm);
  return launch_dt<bf16, bf16>(dt_dtype, x, dt, a, B, C, y, ho, sts, gr, dc,
                               en, batch, d, st, sm);
}

}  // extern "C"
