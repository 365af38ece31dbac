// ssd_scan: the Mamba2 SSD chunked scan (its core, without the D skip), for
// Hopper.
//
// Replaces the Pallas kernel `ssd_scan_pallas` (body `_ssd_kernel`,
// src/repro/kernels/ssd_scan.py:61). x [b, S, H, P], dt [b, S, H] (positive),
// A [H] float32 (negative), B and C [b, S, N] (one group, shared by every
// head). Per chunk of Q rows and per head, with cum = cumsum(dt A):
//   y = ((C B^T) o exp(cum_q - cum_k), causal k <= q) (dt_k x_k)
//       + (C h) exp(cum_q)
//   h <- exp(cum_last) h + B^T (exp(cum_last - cum_k) dt_k x_k)
// y is written in x's type; the final state h [b, H, N, P] float32 is the
// second output. All arithmetic is float32. Rows at or past S are masked as
// the reference pads them: dt = 0, x = 0, B = C = 0.
//
// Design: the recurrence is independent across the P columns of h, so one
// block of 256 threads owns one (batch, head, 16-column slice of P) and walks
// every chunk itself, keeping its [N, 16] float32 state in shared memory --
// the loop inside the block takes the place of the TPU's sequential chunk
// axis, and nothing crosses blocks. Each chunk stages B, C (float32,
// [128][N + 1], the odd stride spreads the banks), the block's x slice and
// dt; one warp takes the float32 prefix sum of dt A; then
//   1. G = C B^T, 8 x 8 outputs a thread, masked and scaled into
//      M = G o exp(cum_q - cum_k) dt_k (zero above the diagonal),
//   2. y = M x + exp(cum_q) (C h), 2 rows x 4 columns a thread,
//   3. h = exp(cum_last) h + B^T (exp(cum_last - cum_k) dt_k x_k), 2 state
//      rows x 4 columns a thread.
// Shared memory holds up to 128 rows whatever Q is (rows >= Q are zero).
//
// Bound on this card: bytes. The least work is each input read once and y and
// h written once (about 56 MB at B 2, S 4096, H 24, P 64, N 128 in bf16, 17 us
// at 3.35 TB/s), against about 8 GFLOP. This first version recomputes C B^T
// in every block of a (batch, chunk) -- once per head and column slice -- and
// does every product with scalar float32 FMAs from shared memory; mma/wgmma
// on the three products and the three-phase chunk-state passing of the GPU
// implementation are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PS = 16;        // state columns (of P) per block
constexpr int QMAX = 128;     // largest chunk
constexpr int NMAX = 128;     // largest state size

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

// Element strides of the batch and sequence axes of one input; its last
// axis is contiguous (x's head axis has stride P).
struct Strides {
  int64_t x_b, x_s, dt_b, dt_s, b_b, b_s, c_b, c_s;
};

// Floats of dynamic shared memory for state size n (every offset is a
// multiple of 4 floats, so the float4 reads stay aligned).
constexpr int smem_floats(int n) {
  return 2 * QMAX * (n + 1) + QMAX * (QMAX + 1) + QMAX * PS + n * PS +
         4 * QMAX + 4;
}

template <typename TX, typename TBC, typename TD>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const TX* __restrict__ x, const TD* __restrict__ dt,
                const float* __restrict__ A, const TBC* __restrict__ Bm,
                const TBC* __restrict__ Cm, TX* __restrict__ y,
                float* __restrict__ h_out, int S, int H, int P, int N, int Q,
                Strides st) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int NP1 = N + 1;
  constexpr int QP1 = QMAX + 1;
  float* Bs = smem;                          // [QMAX][N + 1]
  float* Cs = Bs + QMAX * NP1;               // [QMAX][N + 1]
  float* Ms = Cs + QMAX * NP1;               // [QMAX][QMAX + 1]
  float* Xs = Ms + QMAX * QP1;               // [QMAX][PS]
  float* Hs = Xs + QMAX * PS;                // [N][PS]
  float* cum = Hs + N * PS;                  // [QMAX]
  float* dtv = cum + QMAX;                   // [QMAX]
  float* d2e = dtv + QMAX;                   // exp(last - cum) dt
  float* ecum = d2e + QMAX;                  // exp(cum)
  float* lastv = ecum + QMAX;                // [1]: cum at the chunk's end

  const int p0 = blockIdx.x * PS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const float a = A[h];
  // y and state mapping: rows ty and ty + 64, columns 4 tx .. 4 tx + 3
  const int tx = tid & 3;
  const int ty = tid >> 2;
  // G mapping: rows gy + 16 i, columns gx + 16 j
  const int gx = tid & 15;
  const int gy = tid >> 4;

  const TX* xb = x + b * st.x_b + static_cast<int64_t>(h) * P;
  const TD* db = dt + b * st.dt_b + h;
  const TBC* bb = Bm + b * st.b_b;
  const TBC* cb = Cm + b * st.c_b;

  for (int i = tid; i < N * PS; i += THREADS) Hs[i] = 0.f;

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * Q;
    const int rows = min(Q, S - s0);         // valid rows of this chunk
    __syncthreads();                         // last chunk's readers are done

    // -- stage B, C, the x slice and dt (rows >= rows are zero) -------------
    for (int i = tid; i < QMAX * N; i += THREADS) {
      const int r = i / N;
      const int n = i - r * N;
      float bv = 0.f, cv = 0.f;
      if (r < rows) {
        const int64_t s = s0 + r;
        bv = to_f32(bb[s * st.b_s + n]);
        cv = to_f32(cb[s * st.c_s + n]);
      }
      Bs[r * NP1 + n] = bv;
      Cs[r * NP1 + n] = cv;
    }
    for (int i = tid; i < QMAX * PS; i += THREADS) {
      const int r = i / PS;
      const int p = p0 + (i - r * PS);
      float v = 0.f;
      if (r < rows && p < P)
        v = to_f32(xb[static_cast<int64_t>(s0 + r) * st.x_s + p]);
      Xs[i] = v;
    }

    // -- warp 0: cum = inclusive prefix sum of dt A over the chunk ----------
    if (tid < 32) {
      float loc[4];
      float run = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * tid + j;
        const float d =
            r < rows ? to_f32(db[static_cast<int64_t>(s0 + r) * st.dt_s]) : 0.f;
        dtv[r] = d;
        run += d * a;
        loc[j] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xFFFFFFFFu, incl, off);
        if (tid >= off) incl += t;
      }
      float excl = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) cum[4 * tid + j] = excl + loc[j];
      __syncwarp();
      const float last = cum[Q - 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * tid + j;
        d2e[r] = expf(last - cum[r]) * dtv[r];
        ecum[r] = expf(cum[r]);
      }
      if (tid == 0) lastv[0] = last;
    }
    __syncthreads();

    // -- 1. M = (C B^T) o exp(cum_q - cum_k) dt_k, causal -------------------
    {
      float g[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) g[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) cv[i] = Cs[(gy + 16 * i) * NP1 + n];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = Bs[(gx + 16 * j) * NP1 + n];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = gy + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = gx + 16 * j;
          float m = 0.f;
          if (q < Q && k <= q) m = g[i][j] * expf(cum[q] - cum[k]) * dtv[k];
          Ms[q * QP1 + k] = m;
        }
      }
    }
    __syncthreads();

    // -- 2. y = M x + exp(cum_q) (C h) ---------------------------------------
    {
      const int r0 = ty;
      const int r1 = ty + 64;
      float yi[2][4], ye[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yi[i][j] = ye[i][j] = 0.f;
      const int k_end = min(Q, r1 + 1);      // M is zero above the diagonal
      for (int k = 0; k < k_end; ++k) {
        const float m0 = Ms[r0 * QP1 + k];
        const float m1 = Ms[r1 * QP1 + k];
        const float4 xv = *reinterpret_cast<const float4*>(&Xs[k * PS + 4 * tx]);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          yi[0][j] = fmaf(m0, xa[j], yi[0][j]);
          yi[1][j] = fmaf(m1, xa[j], yi[1][j]);
        }
      }
      for (int n = 0; n < N; ++n) {
        const float c0 = Cs[r0 * NP1 + n];
        const float c1 = Cs[r1 * NP1 + n];
        const float4 hv = *reinterpret_cast<const float4*>(&Hs[n * PS + 4 * tx]);
        const float ha[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ye[0][j] = fmaf(c0, ha[j], ye[0][j]);
          ye[1][j] = fmaf(c1, ha[j], ye[1][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = i == 0 ? r0 : r1;
        if (r >= rows) continue;
        const float e = ecum[r];
        TX* yrow = y + ((static_cast<int64_t>(b) * S + s0 + r) * H + h) * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = p0 + 4 * tx + j;
          if (p < P) from_f32(yi[i][j] + ye[i][j] * e, &yrow[p]);
        }
      }
    }
    __syncthreads();                         // every reader of h is done

    // -- 3. h = exp(last) h + B^T (d2e x) -------------------------------------
    {
      const int n0 = ty;
      const int n1 = ty + 64;
      float inc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) inc[i][j] = 0.f;
      if (n0 < N) {
        const bool two = n1 < N;
        for (int k = 0; k < Q; ++k) {
          const float w = d2e[k];
          const float b0 = Bs[k * NP1 + n0];
          const float b1 = two ? Bs[k * NP1 + n1] : 0.f;
          const float4 xv =
              *reinterpret_cast<const float4*>(&Xs[k * PS + 4 * tx]);
          const float xa[4] = {w * xv.x, w * xv.y, w * xv.z, w * xv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            inc[0][j] = fmaf(b0, xa[j], inc[0][j]);
            inc[1][j] = fmaf(b1, xa[j], inc[1][j]);
          }
        }
        const float decay = expf(lastv[0]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int n = i == 0 ? n0 : n1;
          if (n >= N) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* hp = &Hs[n * PS + 4 * tx + j];
            *hp = *hp * decay + inc[i][j];
          }
        }
      }
    }
  }
  __syncthreads();

  float* hb = h_out + (static_cast<int64_t>(b) * H + h) * N * P;
  for (int i = tid; i < N * PS; i += THREADS) {
    const int n = i / PS;
    const int p = p0 + (i - n * PS);
    if (p < P) hb[static_cast<int64_t>(n) * P + p] = Hs[i];
  }
}

template <typename TX, typename TBC, typename TD>
int launch(const void* x, const void* dt, const float* A, const void* B,
           const void* C, void* y, float* h_out, int batch, int S, int H,
           int P, int N, int Q, const Strides& st, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(N);
  auto kernel = ssd_scan_kernel<TX, TBC, TD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((P + PS - 1) / PS, H, batch);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TD*>(dt), A,
      static_cast<const TBC*>(B), static_cast<const TBC*>(C),
      static_cast<TX*>(y), h_out, S, H, P, N, Q, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TBC>
int launch_dt(int dt_dtype, const void* x, const void* dt, const float* A,
              const void* B, const void* C, void* y, float* h_out, int batch,
              int S, int H, int P, int N, int Q, const Strides& st,
              cudaStream_t stream) {
  if (dt_dtype == 0)
    return launch<TX, TBC, float>(x, dt, A, B, C, y, h_out, batch, S, H, P, N,
                                  Q, st, stream);
  if (dt_dtype == 1)
    return launch<TX, TBC, __nv_bfloat16>(x, dt, A, B, C, y, h_out, batch, S,
                                          H, P, N, Q, st, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtypes: 0 float32, 1 bfloat16 (x_dtype is also y's; B and C share
// bc_dtype). Strides are in elements; every input's last axis is contiguous
// and x's head axis has stride P. y [batch, S, H, P] and h_out
// [batch, H, N, P] float32 are contiguous. Returns a CUDA error code (0 on
// success); launches on `stream`, no sync, no allocation.
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* B, const void* C, void* y, void* h_out,
                    int batch, int S, int H, int P, int N, int Q,
                    int64_t x_b, int64_t x_s, int64_t dt_b, int64_t dt_s,
                    int64_t b_b, int64_t b_s, int64_t c_b, int64_t c_s,
                    int x_dtype, int bc_dtype, int dt_dtype, void* stream) {
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || S <= 0 || H <= 0 || P <= 0) return 0;
  if (Q < 1 || Q > QMAX || N < 1 || N > NMAX || H > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{x_b, x_s, dt_b, dt_s, b_b, b_s, c_b, c_s};
  const float* a = static_cast<const float*>(A);
  float* ho = static_cast<float*>(h_out);
  if (x_dtype == 0 && bc_dtype == 0)
    return launch_dt<float, float>(dt_dtype, x, dt, a, B, C, y, ho, batch, S,
                                   H, P, N, Q, st, sm);
  if (x_dtype == 0 && bc_dtype == 1)
    return launch_dt<float, __nv_bfloat16>(dt_dtype, x, dt, a, B, C, y, ho,
                                           batch, S, H, P, N, Q, st, sm);
  if (x_dtype == 1 && bc_dtype == 0)
    return launch_dt<__nv_bfloat16, float>(dt_dtype, x, dt, a, B, C, y, ho,
                                           batch, S, H, P, N, Q, st, sm);
  if (x_dtype == 1 && bc_dtype == 1)
    return launch_dt<__nv_bfloat16, __nv_bfloat16>(
        dt_dtype, x, dt, a, B, C, y, ho, batch, S, H, P, N, Q, st, sm);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
