// flash_attention: forward attention with online softmax, for Hopper.
//
// Replaces the Pallas kernel `flash_attention_pallas` (body `_fa_kernel`,
// src/repro/kernels/flash_attention.py:77, `pallas_call` at :107). q [B, S,
// Hq, D] attends k, v [B, Sk, Hk, D] (contiguous); query head h reads KV
// head h / (Hq / Hk). Query row i sits at position i + q_offset. A key is
// visible when its position is < Sk, and, if causal, <= the query's, and,
// with a window W, greater than the query's - W. Scores are scaled by
// `scale` in float32; the running max m and sum l and P.V accumulate in
// float32; masked scores contribute p = 0, so a row that sees no key comes
// out 0; out = acc / max(l, 1e-30) in q's type.
//
// Bound on this card: operations. The work is 4 D FLOPs per visible
// (query, key) pair -- 4 B Hq S Sk D, about half of that when causal --
// against 989 TFLOP/s bf16 dense on the tensor cores; q, k, v and the
// output are read and written once in far less time (at tinyllama's
// prefill shape 75.5 MB, 0.023 ms at 3.35 TB/s, against 137.5 GFLOP,
// 0.139 ms).
//
// Two routes, chosen by the wrapper from the inputs' type:
// - bf16, D 64 or 128: the tensor-core kernel of flash_attention_sm90.cuh.
//   Only `wgmma` reaches the bf16 rate, so both products run on it from
//   shared memory that TMA fills asynchronously through a ring of K/V
//   stages, while two or three consumer warpgroups compute and take turns
//   at the tensor cores (one's products overlap the others' softmax, and
//   each warpgroup's softmax of tile i overlaps its own P V of tile i - 1);
//   the softmax stays in registers on the float32 accumulator, the scale
//   is applied there (not to q in bf16: 1/sqrt(128) is not a power of 2),
//   masks are computed only on tiles that cross the diagonal, the window
//   or Sk, and only the KV tiles of the causal/window band are walked. P
//   enters the second product rounded to bf16, as the tensor cores take it
//   (within the 2e-2 tolerance of the reference's bf16 tests).
// - float32 (and bf16 on request, for comparison): the scalar kernel below.
//   It stages tiles as float32 in shared memory and does both products
//   with float32 FMAs (67 TFLOP/s peak). float32 keeps it: the tensor
//   cores take float32 only as TF32 (10-bit mantissa), which breaks the
//   2e-5 tolerance of the float32 route.
//
// Scalar kernel: one block of 256 threads per (64-row query tile, batch x
// query head); blockIdx.x is the (batch, head) and blockIdx.y the query
// tile, the last (the longest causal band) first. The block keeps its Q
// tile (transposed) in shared memory and walks the KV tiles of the band
// only, staging each 64-key K tile (transposed) and V tile as float32.
// Thread (ty, tx) of a 16 x 16 grid owns rows 4ty..4ty+3 of the tile, key
// columns 4tx..4tx+3 of S, and output columns 4tx.. (+64) of the
// accumulator; row max and sum reduce over the 16 threads of a half-warp
// with shuffles. Ragged S and Sk are masked in the kernel (no padding).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_attention_sm90.cuh"

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per KV tile
constexpr int THREADS = 256;      // 16 x 16
constexpr int PAD = 4;            // keeps float4 alignment, spreads banks
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(x);
}

// Loads 8 consecutive elements (16 bytes for bf16, two float4 for float32)
// of a row into float32. `p` is 16-byte aligned: rows are D (64 or 128)
// elements long and tensors start on allocator boundaries.
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

// Stages rows [row0, row0 + ROWS) of one head into shared memory as
// float32, transposed (dst[d * (ROWS + PAD) + r]) or not
// (dst[r * (D + PAD) + d]).
// Rows at or past `n_rows` are zero. `stride` is the element distance
// between consecutive rows (H * D).
template <typename T, int D, int ROWS, bool TRANSPOSE>
__device__ __forceinline__ void stage_tile(const T* __restrict__ base,
                                           int row0, int n_rows,
                                           int64_t stride, float mul,
                                           float* __restrict__ dst) {
  constexpr int GROUPS = D / 8;                    // 8-element groups per row
  constexpr int ITEMS = ROWS * GROUPS;
  for (int it = threadIdx.x; it < ITEMS; it += THREADS) {
    // transposed: neighbouring threads take neighbouring rows, so the
    // transposed writes fall on neighbouring banks
    const int r = TRANSPOSE ? it % ROWS : it / GROUPS;
    const int g = TRANSPOSE ? it / ROWS : it % GROUPS;
    float v[8];
    const int row = row0 + r;
    if (row < n_rows) {
      load8(base + static_cast<int64_t>(row) * stride + g * 8, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int d = g * 8 + e;
      if (TRANSPOSE)
        dst[d * (ROWS + PAD) + r] = v[e] * mul;
      else
        dst[r * (D + PAD) + d] = v[e] * mul;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int Sk, int Hq, int Hk, int causal, int window,
                       int q_offset, float scale) {
  constexpr int DC = D / 64;                       // output column groups
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* Qt = smem;                                // [D][BQ + PAD]
  float* Kt = Qt + D * (BQ + PAD);                 // [D][BK + PAD]
  float* Vs = Kt + D * (BK + PAD);                 // [BK][D + PAD]
  float* Pt = Vs + BK * (D + PAD);                 // [BK][BQ + PAD]

  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.y);  // long rows first
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hk);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = qt * BQ;

  const int64_t q_stride = static_cast<int64_t>(Hq) * D;
  const int64_t kv_stride = static_cast<int64_t>(Hk) * D;
  const T* qb = q + (static_cast<int64_t>(b) * S) * q_stride + h * D;
  const T* kb = k + (static_cast<int64_t>(b) * Sk) * kv_stride + hk * D;
  const T* vb = v + (static_cast<int64_t>(b) * Sk) * kv_stride + hk * D;
  T* ob = out + (static_cast<int64_t>(b) * S) * q_stride + h * D;

  stage_tile<T, D, BQ, true>(qb, q0, S, q_stride, scale, Qt);

  // KV tiles of the band: positions [lo_pos, hi_pos) can be visible
  const int first_pos = q0 + q_offset;                  // first row's position
  const int last_pos = min(q0 + BQ, S) - 1 + q_offset;  // last valid row's
  int hi_pos = causal ? min(last_pos + 1, Sk) : Sk;
  int lo_pos = window > 0 ? max(first_pos - window + 1, 0) : 0;
  const int kt_lo = lo_pos / BK;
  const int kt_hi = hi_pos > 0 ? (hi_pos + BK - 1) / BK : 0;

  float m[4], l[4], acc[4][4 * DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * DC; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // previous tile's Kt/Vs/Pt are consumed
    stage_tile<T, D, BK, true>(kb, k0, Sk, kv_stride, 1.f, Kt);
    stage_tile<T, D, BK, false>(vb, k0, Sk, kv_stride, 1.f, Vs);
    __syncthreads();

    // S = (scale q) k^T for rows 4ty+i, keys 4tx+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(
          &Qt[d * (BQ + PAD) + 4 * ty]);
      const float4 ka = *reinterpret_cast<const float4*>(
          &Kt[d * (BK + PAD) + 4 * tx]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online softmax update, P to shared memory (transposed)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i + q_offset;
      bool vis[4];
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tx + j;
        vis[j] = kpos < Sk && (!causal || qpos >= kpos) &&
                 (window <= 0 || qpos - kpos < window);
        if (!vis[j]) s[i][j] = NEG_INF;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xFFFFFFFFu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        Pt[(4 * tx + j) * (BQ + PAD) + 4 * ty + i] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xFFFFFFFFu, row_sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * DC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += P V for rows 4ty+i, columns 64c + 4tx + j
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(
          &Pt[c * (BQ + PAD) + 4 * ty]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float4 va = *reinterpret_cast<const float4*>(
            &Vs[c * (D + PAD) + 64 * dc + 4 * tx]);
        const float vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][4 * dc + j] = fmaf(pv[i], vv[j], acc[i][4 * dc + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = ob + static_cast<int64_t>(row) * q_stride;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        from_f32(acc[i][4 * dc + j] * inv, &orow[64 * dc + 4 * tx + j]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Sk, int Hq, int Hk, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * (D * (BQ + PAD) + D * (BK + PAD) + BK * (D + PAD) +
                       BK * (BQ + PAD));
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * Hq, (S + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Sk, Hq, Hk, causal,
      window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The scalar kernel. dtype: 0 float32, 1 bfloat16. window <= 0: no window.
// Returns a CUDA error code (0 on success); launches on `stream`, no sync,
// no allocation.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int Sk, int Hq, int Hk,
                           int D, int dtype, int causal, int window,
                           int q_offset, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (Hk <= 0 || Hq % Hk != 0 ||
      static_cast<long long>(B) * Hq > 0x7FFFFFFFll ||
      (S + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, out, B, S, Sk, Hq, Hk, causal, window,
                             q_offset, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, out, B, S, Sk, Hq, Hk, causal, window,
                              q_offset, scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, B, S, Sk, Hq, Hk, causal,
                                     window, q_offset, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, B, S, Sk, Hq, Hk, causal,
                                      window, q_offset, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of a tensor-core block at head dim D (0 for
// another D).
int flash_attention_tc_smem_bytes(int D) {
  if (D == 64) return fa_tc::smem_bytes<64>();
  if (D == 128) return fa_tc::smem_bytes<128>();
  return 0;
}

// The tensor-core kernel, bf16 only. `q_map` and `kv_map` each hold the
// 4-D tensor map's dims (D, H, S, B) and byte strides of dims 1-3 of q and
// of k and v (the wrapper's `tensor_map_args`). Same return convention.
int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                              void* out, const unsigned long long* q_map,
                              const unsigned long long* kv_map, int causal,
                              int window, int q_offset, float scale,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned long long D = q_map[0];
  if (q_map[1] == 0 || q_map[2] == 0 || q_map[3] == 0) return 0;
  if (kv_map[0] != D || kv_map[3] != q_map[3] || kv_map[1] == 0 ||
      kv_map[2] == 0 || q_map[1] % kv_map[1] != 0 ||
      q_map[2] > 0x7FFFFFFFull || kv_map[2] > 0x7FFFFFFFull)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64)
    return fa_tc::launch<64>(q, k, v, out, q_map, kv_map, causal, window,
                             q_offset, scale, st);
  if (D == 128)
    return fa_tc::launch<128>(q, k, v, out, q_map, kv_map, causal, window,
                              q_offset, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
