// Kimi Delta Attention's pass over chunks (ops/kda.py), forward and
// backward. It replaces no TPU kernel: the JAX package has no linear
// attention. It is the sequential part of the chunked gated delta rule;
// the parts parallel over chunks are batched products in ops/kda.py.
//
// One launch walks every chunk of every head in order. For a head and a
// block of V_SPLIT columns of its state R [DK, V_SPLIT] (the columns of
// the state evolve apart from each other), chunk by chunk:
//
//   out_state[c] = R
//   X_c = base_c + sign1 * A1_c^T R          A1_c^T [C, DK]  (stored A1 [DK, C])
//   R   = gamma_c * R + sign2 * A2_c^T X_c   A2_c [C, DK]   (+ extra_c)
//   out_x[c] = X_c
//
// Forward (ascending c): A1 = W^T, A2 = K~, base = U', sign1 = -1,
// sign2 = +1: out_state the states S_c entering each chunk, out_x the
// corrected values U_c = U'_c - W_c S_c. Backward (descending c): A1 =
// K~^T, A2 = W, base = dL/dU_c, extra = dL/dS_c, sign1 = +1, sign2 = -1:
// out_state dS_{c+1}, out_x the total dU_c.
//
// The bound on this card is memory: a chunk reads A1 and A2 (32 KB each)
// and its columns of base and writes the state's columns and X, against
// 4 C DK V_SPLIT float32 FMAs (the card's bytes take ~5x its products'
// time at the TF32 rate). The design follows: a grid of (V / V_SPLIT,
// heads, batch) CTAs, so that one video's 32 heads of 128 columns fill
// 128 of the 132 SMs; the next chunk's operands land by cp.async in the
// second of two stages while this one's are multiplied; the products are
// float32 FMAs from shared memory (float32 accuracy, each dot product
// summed in order), register-tiled 2 x 4 and 4 x 4 a thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int C = 64;         // shots a chunk
constexpr int DK = 128;       // key width
constexpr int VS = 32;        // state columns a CTA holds
constexpr int THREADS = 256;  // 8 warps

// one stage of shared memory, in floats
constexpr int A1_OFF = 0;                  // [DK][C]
constexpr int A2_OFF = A1_OFF + DK * C;    // [C][DK]
constexpr int BASE_OFF = A2_OFF + C * DK;  // [C][VS]
constexpr int GAMMA_OFF = BASE_OFF + C * VS;  // [DK]
constexpr int EXTRA_OFF = GAMMA_OFF + DK;     // [DK][VS], backward only
constexpr int STAGE_FWD = EXTRA_OFF;
constexpr int STAGE_BWD = EXTRA_OFF + DK * VS;

// two stages, the state R [DK][VS], X [C][VS]
constexpr int SMEM_FWD = 4 * (2 * STAGE_FWD + DK * VS + C * VS);
constexpr int SMEM_BWD = 4 * (2 * STAGE_BWD + DK * VS + C * VS);

template <bool BWD>
__device__ __forceinline__ void load_chunk(float* st, const float* a1,
                                           const float* a2, const float* base,
                                           const float* gamma,
                                           const float* extra, long chunk,
                                           int dv, int v0, int tid) {
  const float* a1c = a1 + chunk * (DK * C);
  const float* a2c = a2 + chunk * (C * DK);
  for (int i = tid; i < DK * C / 4; i += THREADS) {
    tf32::cp_async16(st + A1_OFF + 4 * i, a1c + 4 * i);
    tf32::cp_async16(st + A2_OFF + 4 * i, a2c + 4 * i);
  }
  const float* bc = base + chunk * (long)(C * dv) + v0;
  for (int i = tid; i < C * VS / 4; i += THREADS) {
    int r = i / (VS / 4), q = i % (VS / 4);
    tf32::cp_async16(st + BASE_OFF + r * VS + 4 * q, bc + (long)r * dv + 4 * q);
  }
  if (tid < DK / 4)
    tf32::cp_async16(st + GAMMA_OFF + 4 * tid, gamma + chunk * DK + 4 * tid);
  if (BWD) {
    const float* ec = extra + chunk * (long)(DK * dv) + v0;
    for (int i = tid; i < DK * VS / 4; i += THREADS) {
      int r = i / (VS / 4), q = i % (VS / 4);
      tf32::cp_async16(st + EXTRA_OFF + r * VS + 4 * q,
                       ec + (long)r * dv + 4 * q);
    }
  }
}

template <bool BWD>
__device__ __forceinline__ void chunk_pass(
    const float* __restrict__ a1, const float* __restrict__ a2,
    const float* __restrict__ base, const float* __restrict__ gamma,
    const float* __restrict__ extra, float* __restrict__ out_state,
    float* __restrict__ out_x, int heads, int n_chunks, int dv) {
  extern __shared__ __align__(16) float smem[];
  constexpr int STAGE = BWD ? STAGE_BWD : STAGE_FWD;
  constexpr float SIGN1 = BWD ? 1.f : -1.f;
  constexpr float SIGN2 = BWD ? -1.f : 1.f;
  float* rsh = smem + 2 * STAGE;  // [DK][VS]
  float* xsh = rsh + DK * VS;     // [C][VS]
  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * VS;
  const long bh = (long)blockIdx.z * heads + blockIdx.y;
  // X: rows 2 xr, 2 xr + 1; R: rows 4 xr .. + 3; both columns 4 cg .. + 3
  const int xr = tid / 8, cg = tid % 8;
  const int c0 = 4 * cg;

  float r[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) r[i][j] = 0.f;
  for (int i = tid; i < DK * VS; i += THREADS) rsh[i] = 0.f;

  auto chunk_at = [&](int step) { return BWD ? n_chunks - 1 - step : step; };
  load_chunk<BWD>(smem, a1, a2, base, gamma, extra, bh * n_chunks + chunk_at(0),
                  dv, v0, tid);
  tf32::cp_async_commit();

  for (int step = 0; step < n_chunks; ++step) {
    const int c = chunk_at(step);
    const long chunk = bh * n_chunks + c;
    const float* st = smem + (step & 1) * STAGE;
    tf32::cp_async_wait<0>();
    __syncthreads();  // this chunk's operands and last chunk's R are in
    if (step + 1 < n_chunks)
      load_chunk<BWD>(smem + ((step + 1) & 1) * STAGE, a1, a2, base, gamma,
                      extra, bh * n_chunks + chunk_at(step + 1), dv, v0, tid);
    tf32::cp_async_commit();

    // out_state[c] = R, from the registers
    float* os = out_state + chunk * (long)(DK * dv) + v0 + c0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(os + (long)(4 * xr + i) * dv) =
          make_float4(r[i][0], r[i][1], r[i][2], r[i][3]);

    // X = base + SIGN1 * A1^T R: rows 2 xr, 2 xr + 1
    float x[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) x[i][j] = 0.f;
    const float* A1 = st + A1_OFF;
#pragma unroll 8
    for (int k = 0; k < DK; ++k) {
      const float2 a = *reinterpret_cast<const float2*>(A1 + k * C + 2 * xr);
      const float4 s = *reinterpret_cast<const float4*>(rsh + k * VS + c0);
      x[0][0] += a.x * s.x; x[0][1] += a.x * s.y;
      x[0][2] += a.x * s.z; x[0][3] += a.x * s.w;
      x[1][0] += a.y * s.x; x[1][1] += a.y * s.y;
      x[1][2] += a.y * s.z; x[1][3] += a.y * s.w;
    }
    float* ox = out_x + chunk * (long)(C * dv) + v0 + c0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 2 * xr + i;
      const float4 b =
          *reinterpret_cast<const float4*>(st + BASE_OFF + row * VS + c0);
      const float4 v = make_float4(b.x + SIGN1 * x[i][0], b.y + SIGN1 * x[i][1],
                                   b.z + SIGN1 * x[i][2], b.w + SIGN1 * x[i][3]);
      *reinterpret_cast<float4*>(xsh + row * VS + c0) = v;
      *reinterpret_cast<float4*>(ox + (long)row * dv) = v;
    }
    __syncthreads();  // X is whole; every read of R's old value is done

    // R = gamma R + SIGN2 * A2^T X (+ extra): rows 4 xr .. + 3
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const float* A2 = st + A2_OFF;
#pragma unroll 8
    for (int j = 0; j < C; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(A2 + j * DK + 4 * xr);
      const float4 v = *reinterpret_cast<const float4*>(xsh + j * VS + c0);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] += av[i] * v.x; acc[i][1] += av[i] * v.y;
        acc[i][2] += av[i] * v.z; acc[i][3] += av[i] * v.w;
      }
    }
    const float4 gm =
        *reinterpret_cast<const float4*>(st + GAMMA_OFF + 4 * xr);
    const float gv[4] = {gm.x, gm.y, gm.z, gm.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * xr + i;
      float e[4] = {0.f, 0.f, 0.f, 0.f};
      if (BWD) {
        const float4 t =
            *reinterpret_cast<const float4*>(st + EXTRA_OFF + row * VS + c0);
        e[0] = t.x; e[1] = t.y; e[2] = t.z; e[3] = t.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[i][j] = gv[i] * r[i][j] + SIGN2 * acc[i][j] + e[j];
      *reinterpret_cast<float4*>(rsh + row * VS + c0) =
          make_float4(r[i][0], r[i][1], r[i][2], r[i][3]);
    }
  }
  tf32::cp_async_wait<0>();
}

__global__ void __launch_bounds__(THREADS)
    kda_fwd_kernel(const float* a1, const float* a2, const float* base,
                   const float* gamma, float* out_state, float* out_x,
                   int heads, int n_chunks, int dv) {
  chunk_pass<false>(a1, a2, base, gamma, nullptr, out_state, out_x, heads,
                    n_chunks, dv);
}

__global__ void __launch_bounds__(THREADS)
    kda_bwd_kernel(const float* a1, const float* a2, const float* base,
                   const float* gamma, const float* extra, float* out_state,
                   float* out_x, int heads, int n_chunks, int dv) {
  chunk_pass<true>(a1, a2, base, gamma, extra, out_state, out_x, heads,
                   n_chunks, dv);
}

}  // namespace

extern "C" {

// (C, DK, VS), for the wrapper to check against its own.
void avsum_kda_layout(long* out) {
  out[0] = C;
  out[1] = DK;
  out[2] = VS;
}

// One pass over every chunk of [batch, heads] heads; every tensor
// contiguous float32 [batch, heads, n_chunks, ...]: a1 [DK, C], a2
// [C, DK], base [C, dv], gamma [DK], extra [DK, dv] (backward only),
// out_state [DK, dv], out_x [C, dv]. Returns the launch's CUDA error.
int avsum_kda_pass(int backward, const float* a1, const float* a2,
                   const float* base, const float* gamma, const float* extra,
                   float* out_state, float* out_x, int batch, int heads,
                   int n_chunks, int dv, cudaStream_t stream) {
  if (dv % VS != 0 || n_chunks < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(dv / VS, heads, batch);
  if (backward) {
    const int bytes = SMEM_BWD;
    cudaError_t e = cudaFuncSetAttribute(
        kda_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    kda_bwd_kernel<<<grid, THREADS, bytes, stream>>>(
        a1, a2, base, gamma, extra, out_state, out_x, heads, n_chunks, dv);
  } else {
    const int bytes = SMEM_FWD;
    cudaError_t e = cudaFuncSetAttribute(
        kda_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    kda_fwd_kernel<<<grid, THREADS, bytes, stream>>>(
        a1, a2, base, gamma, out_state, out_x, heads, n_chunks, dv);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
