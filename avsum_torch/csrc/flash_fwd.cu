// Flash-attention forward: O = softmax(Q K^T / sqrt(D) + key bias) V with
// an online softmax, float32 throughout; the [S, S] probabilities never
// reach device memory. Also writes LSE = m + log(l) per query row.
//
// Replaces the TPU kernel avsum_tpu/ops/attention.py::_flash_fwd_kernel
// (pallas_call in _flash_fwd; wrapper flash_attention). Python wrapper:
// avsum_torch/ops/attention.py.
//
// Layout: q, k, v are [B, S, H, D] views read through their (b, s, h)
// strides with a unit stride on D, so the scorer's fused qkv projection
// [B, S, 3, H, D] is read in place. Out is [B, S, H, D] contiguous, LSE
// [B, H, S]. Keys past S (the ragged last tile) are skipped, so S needs
// no padding; masked keys get a -1e30 bias, and a row whose keys are all
// masked averages V uniformly (the materialized softmax's answer). The
// denominator is clamped at 1e-30 as in the TPU kernel.
//
// What bounds it on an H100: at the scorer's shapes (S ~ 500-7000, H = 4,
// D = 256) the work is 4 * S^2 * D flops per head against O(S * D) bytes,
// so arithmetic, and at S ~ 500 the grid is only B * H * ceil(S / 32)
// blocks, fewer than the 132 SMs. The TPU grid walked key blocks in
// order with VMEM scratch; here one block owns (b, h, 32 query rows) and
// loops over key tiles itself, keeping the running max, running sum and
// the 32 x D output accumulator in registers (8 warps x 4 rows each; lane
// i holds columns i, i+32, ...). D = 256 in float32 makes Q, K and V
// tiles of 32 x 256 x 4 B = 32 KB each, so the tiles live in dynamic
// shared memory (~100 KB at D = 256, two blocks per SM). K rows are
// padded by one float so the 32 lanes of a warp, each on its own key,
// hit 32 different banks. Plain FP32 FMAs; wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 32;
constexpr int kBlockK = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kBlockQ / kWarps;  // query rows per warp
constexpr float kMaskBias = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_floats() {
  return (size_t)kBlockQ * D + (size_t)kBlockK * (D + 1) +
         (size_t)kBlockK * D + (size_t)kBlockQ * kBlockK;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ mask,  // [B, S] or null
                 float* __restrict__ out, float* __restrict__ lse, int S,
                 int H, long qsb, long qss, long qsh, long ksb, long kss,
                 long ksh, long vsb, long vss, long vsh, float scale) {
  constexpr int kCols = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* sq = smem;                        // [kBlockQ][D]
  float* sk = sq + kBlockQ * D;            // [kBlockK][D + 1]
  float* sv = sk + kBlockK * (D + 1);      // [kBlockK][D]
  float* sp = sv + kBlockK * D;            // [kBlockQ][kBlockK]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    sq[i] = s < S ? qb[s * qss + d] : 0.f;
  }

  float acc[kRows][kCols];
  float m_run[kRows], l_run[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_run[r] = kMaskBias;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    __syncthreads();  // Q loaded / previous K, V, P tiles consumed
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int j = i / D, d = i % D, s = k0 + j;
      sk[j * (D + 1) + d] = s < S ? kb[s * kss + d] : 0.f;
      sv[i] = s < S ? vb[s * vss + d] : 0.f;
    }
    __syncthreads();

    // scores: lane = key column, warp = kRows query rows
    const int key = k0 + lane;
    const bool in_range = key < S;
    const float bias =
        (in_range && (mask == nullptr || mask[(long)b * S + key] > 0.f))
            ? 0.f : kMaskBias;
    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
    const float* krow = sk + lane * (D + 1);
    const float* qrow = sq + warp * kRows * D;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) sc[r] = fmaf(qrow[r * D + d], kd, sc[r]);
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float s = in_range ? sc[r] * scale + bias : -INFINITY;
      const float m_new = fmaxf(m_run[r], warp_max(s));
      const float p = in_range ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha + warp_sum(p);
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      sp[(warp * kRows + r) * kBlockK + lane] = p;
    }
    __syncwarp();

    // acc += P V over this warp's rows
    const float* prow = sp + warp * kRows * kBlockK;
#pragma unroll 2
    for (int j = 0; j < kBlockK; ++j) {
      float vj[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vj[c] = sv[j * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = prow[r * kBlockK + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = q0 + warp * kRows + r;
    if (s >= S) continue;
    const float denom = fmaxf(l_run[r], 1e-30f);
    const float inv = 1.f / denom;
    float* orow = out + (((long)b * S + s) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) orow[lane + 32 * c] = acc[r][c] * inv;
    if (lane == 0) lse[((long)b * H + h) * S + s] = m_run[r] + logf(denom);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* mask,
           float* out, float* lse, int B, int S, int H, const long* qs,
           const long* ks, const long* vs, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, mask, out, lse, S, H, qs[0], qs[1], qs[2], ks[0], ks[1],
      ks[2], vs[0], vs[1], vs[2], 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: float32 [B, S, H, D] with element strides {b, s, h} in
// q_strides / k_strides / v_strides and unit stride on D; mask: float32
// [B, S] contiguous (> 0 = valid key) or null; out: [B, S, H, D]
// contiguous; lse: [B, H, S]. D must be 128 or 256 (returns
// cudaErrorInvalidValue otherwise). Returns cudaGetLastError().
extern "C" int avsum_flash_fwd(const void* q, const void* k, const void* v,
                               const void* mask, void* out, void* lse, int B,
                               int S, int H, int D, const long* q_strides,
                               const long* k_strides, const long* v_strides,
                               void* stream) {
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const float* mf = (const float*)mask;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    return launch<128>(qf, kf, vf, mf, (float*)out, (float*)lse, B, S, H,
                       q_strides, k_strides, v_strides, st);
  if (D == 256)
    return launch<256>(qf, kf, vf, mf, (float*)out, (float*)lse, B, S, H,
                       q_strides, k_strides, v_strides, st);
  return (int)cudaErrorInvalidValue;
}
