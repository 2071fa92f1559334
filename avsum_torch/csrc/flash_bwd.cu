// Flash-attention backward, float32 throughout: the gradients of
// O = softmax(Q K^T / sqrt(D) + key bias) V, with the probabilities
// recomputed tile by tile as P = exp(S - LSE) from the forward's LSE, so
// the [S, S] matrices never reach device memory. Two kernels, as on the
// TPU, so no output is shared between blocks and no atomics are needed:
//
//   B3 flash_bwd_dkv_kernel: dV = P^T dO, dK = D^-1/2 dS^T Q
//   B4 flash_bwd_dq_kernel:  dQ = D^-1/2 dS K
//
// with dP = dO V^T and dS = P o (dP - delta), delta = rowsum(dO o O)
// computed by the caller. They replace the TPU kernels
// avsum_tpu/ops/attention.py::_flash_bwd_dkv_kernel and
// ::_flash_bwd_dq_kernel (pallas_calls in _flash_bwd). Python wrappers:
// avsum_torch/ops/attention.py (flash_bwd_dkv, flash_bwd_dq, and the
// autograd Function that runs flash_fwd.cu, then these two).
//
// Layout: q, k, v, dO are [B, S, H, D] views read through their (b, s, h)
// strides with a unit stride on D (q, k, v are slices of the scorer's
// fused qkv projection; dO is whatever autograd hands the Function).
// LSE and delta are [B, H, S]; dQ, dK, dV are [B, S, H, D] contiguous.
// Rows past S (the ragged last tile) are loaded as zeros, get P = 0 and
// are never written, so S needs no padding. Masked keys have bias -1e30,
// so P is exactly 0 there. A query row whose keys are all masked has
// LSE = -1e30 in float32, so its recomputed P is 1 rather than 1/S (the
// TPU kernel does the same); the scorer multiplies every attention
// output by the mask, so dO, and with it every gradient term from such a
// row, is 0.
//
// What bounds it on an H100: 8 * S^2 * D flops per head (four S x S x D
// products in each kernel, counting the recomputed scores) against
// O(S * D) bytes, so arithmetic. The TPU grid walked its inner blocks in
// order, carrying dK/dV (or dQ) in VMEM scratch; here one block owns
// (b, h, 32 rows) and loops over the 32-row tiles of the other side
// itself, with its accumulators in registers (8 warps x 4 rows each;
// lane i holds columns i, i+32, ...). In the score phase each lane owns
// one row of the streamed tile, whose shared-memory rows are padded by
// one float so the 32 lanes hit 32 banks; the resident rows are read as
// float4 broadcasts. D = 256 makes the four 32 x D tiles ~128 KB of
// dynamic shared memory, so one block runs per SM there. Plain FP32
// FMAs; wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 32;  // rows a block owns
constexpr int kTile = 32;   // rows of the other side per loop step
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kBlock / kWarps;  // owned rows per warp
constexpr float kMaskBias = -1e30f;

template <int D>
constexpr size_t smem_floats() {
  // two resident [kBlock][D] tiles, two streamed [kTile][D + 1] tiles,
  // two [kBlock][kTile] score tiles, and two [kTile] row vectors
  return 2 * (size_t)kBlock * D + 2 * (size_t)kTile * (D + 1) +
         2 * (size_t)kBlock * kTile + 2 * (size_t)kTile;
}

// Copy rows [s0, s0 + kRowsTile) of a strided [S, D] head slice into
// shared memory with row pitch `pitch`; rows past S become zeros.
template <int D, int kRowsTile>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const float* src, long row_stride,
                                          int s0, int S) {
  for (int i = threadIdx.x; i < kRowsTile * D; i += kThreads) {
    const int r = i / D, d = i % D, s = s0 + r;
    dst[r * pitch + d] = s < S ? src[s * row_stride + d] : 0.f;
  }
}

__device__ __forceinline__ float key_bias(const float* mask, int b, int S,
                                          int key) {
  return (mask == nullptr || mask[(long)b * S + key] > 0.f) ? 0.f : kMaskBias;
}

// B3: one block owns (b, h, keys [k0, k0 + 32)) and loops over query tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ mask,  // [B, S] or null
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int S,
                     int H, long qsb, long qss, long qsh, long ksb, long kss,
                     long ksh, long vsb, long vss, long vsh, long dsb,
                     long dss, long dsh, float scale) {
  constexpr int kCols = D / 32;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sk = smem;                        // [kBlock][D]  resident keys
  float* sv = sk + kBlock * D;             // [kBlock][D]  resident values
  float* sq = sv + kBlock * D;             // [kTile][D + 1]
  float* sdo = sq + kTile * (D + 1);       // [kTile][D + 1]
  float* sp = sdo + kTile * (D + 1);       // [kBlock][kTile]  P^T
  float* sds = sp + kBlock * kTile;        // [kBlock][kTile]  dS^T
  float* slse = sds + kBlock * kTile;      // [kTile]
  float* sdelta = slse + kTile;            // [kTile]

  const int k0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* qb = q + b * qsb + h * qsh;
  const float* dob = dout + b * dsb + h * dsh;
  const float* lseb = lse + ((long)b * H + h) * S;
  const float* deltab = delta + ((long)b * H + h) * S;
  load_tile<D, kBlock>(sk, D, k + b * ksb + h * ksh, kss, k0, S);
  load_tile<D, kBlock>(sv, D, v + b * vsb + h * vsh, vss, k0, S);

  float bias[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int key = k0 + warp * kRows + r;
    bias[r] = key < S ? key_bias(mask, b, S, key) : 0.f;
  }
  float acc_k[kRows][kCols], acc_v[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  const float4* krow4 = reinterpret_cast<const float4*>(sk + warp * kRows * D);
  const float4* vrow4 = reinterpret_cast<const float4*>(sv + warp * kRows * D);
  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();  // K, V loaded / the previous tile consumed
    load_tile<D, kTile>(sq, D + 1, qb, qss, q0, S);
    load_tile<D, kTile>(sdo, D + 1, dob, dss, q0, S);
    if (threadIdx.x < kTile) {
      const int s = q0 + threadIdx.x;
      slse[threadIdx.x] = s < S ? lseb[s] : 0.f;
      sdelta[threadIdx.x] = s < S ? deltab[s] : 0.f;
    }
    __syncthreads();

    // scores and dP^T: lane = query, warp = kRows keys
    float sc[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = dp[r] = 0.f;
    const float* qrow = sq + lane * (D + 1);
    const float* dorow = sdo + lane * (D + 1);
#pragma unroll 2
    for (int d4 = 0; d4 < D / 4; ++d4) {
      float qd[4], dod[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        qd[t] = qrow[4 * d4 + t];
        dod[t] = dorow[4 * d4 + t];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 kk = krow4[r * (D / 4) + d4];
        const float4 vv = vrow4[r * (D / 4) + d4];
        sc[r] = fmaf(kk.x, qd[0], sc[r]);
        sc[r] = fmaf(kk.y, qd[1], sc[r]);
        sc[r] = fmaf(kk.z, qd[2], sc[r]);
        sc[r] = fmaf(kk.w, qd[3], sc[r]);
        dp[r] = fmaf(vv.x, dod[0], dp[r]);
        dp[r] = fmaf(vv.y, dod[1], dp[r]);
        dp[r] = fmaf(vv.z, dod[2], dp[r]);
        dp[r] = fmaf(vv.w, dod[3], dp[r]);
      }
    }
    const bool q_in = q0 + lane < S;
    const float l = slse[lane], dl = sdelta[lane];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float p = q_in ? expf(sc[r] * scale + bias[r] - l) : 0.f;
      sp[(warp * kRows + r) * kTile + lane] = p;
      sds[(warp * kRows + r) * kTile + lane] = p * (dp[r] - dl);
    }
    __syncwarp();

    // dV += P^T dO, dK += dS^T Q over this warp's keys
    const float4* prow4 = reinterpret_cast<const float4*>(sp + warp * kRows * kTile);
    const float4* dsrow4 = reinterpret_cast<const float4*>(sds + warp * kRows * kTile);
    for (int i4 = 0; i4 < kTile / 4; ++i4) {
      float pr[kRows][4], dsr[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pp = prow4[r * (kTile / 4) + i4];
        const float4 dd = dsrow4[r * (kTile / 4) + i4];
        pr[r][0] = pp.x; pr[r][1] = pp.y; pr[r][2] = pp.z; pr[r][3] = pp.w;
        dsr[r][0] = dd.x; dsr[r][1] = dd.y; dsr[r][2] = dd.z; dsr[r][3] = dd.w;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = 4 * i4 + t;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float doc = sdo[i * (D + 1) + lane + 32 * c];
          const float qc = sq[i * (D + 1) + lane + 32 * c];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc_v[r][c] = fmaf(pr[r][t], doc, acc_v[r][c]);
            acc_k[r][c] = fmaf(dsr[r][t], qc, acc_k[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = k0 + warp * kRows + r;
    if (s >= S) continue;
    const long row = (((long)b * S + s) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[row + lane + 32 * c] = acc_k[r][c] * scale;
      dv[row + lane + 32 * c] = acc_v[r][c];
    }
  }
}

// B4: one block owns (b, h, queries [q0, q0 + 32)) and loops over key tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ mask,  // [B, S] or null
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int H, long qsb, long qss, long qsh, long ksb,
                    long kss, long ksh, long vsb, long vss, long vsh,
                    long dsb, long dss, long dsh, float scale) {
  constexpr int kCols = D / 32;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sq = smem;                        // [kBlock][D]  resident queries
  float* sdo = sq + kBlock * D;            // [kBlock][D]  resident dO
  float* sk = sdo + kBlock * D;            // [kTile][D + 1]
  float* sv = sk + kTile * (D + 1);        // [kTile][D + 1]
  float* sds = sv + kTile * (D + 1);       // [kBlock][kTile]

  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  load_tile<D, kBlock>(sq, D, q + b * qsb + h * qsh, qss, q0, S);
  load_tile<D, kBlock>(sdo, D, dout + b * dsb + h * dsh, dss, q0, S);

  float l[kRows], dl[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = q0 + warp * kRows + r;
    l[r] = s < S ? lse[((long)b * H + h) * S + s] : 0.f;
    dl[r] = s < S ? delta[((long)b * H + h) * S + s] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const float4* qrow4 = reinterpret_cast<const float4*>(sq + warp * kRows * D);
  const float4* dorow4 = reinterpret_cast<const float4*>(sdo + warp * kRows * D);
  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();  // Q, dO loaded / the previous tile consumed
    load_tile<D, kTile>(sk, D + 1, kb, kss, k0, S);
    load_tile<D, kTile>(sv, D + 1, vb, vss, k0, S);
    __syncthreads();

    // scores and dP: lane = key, warp = kRows queries
    float sc[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = dp[r] = 0.f;
    const float* krow = sk + lane * (D + 1);
    const float* vrow = sv + lane * (D + 1);
#pragma unroll 2
    for (int d4 = 0; d4 < D / 4; ++d4) {
      float kd[4], vd[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        kd[t] = krow[4 * d4 + t];
        vd[t] = vrow[4 * d4 + t];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = qrow4[r * (D / 4) + d4];
        const float4 oo = dorow4[r * (D / 4) + d4];
        sc[r] = fmaf(qq.x, kd[0], sc[r]);
        sc[r] = fmaf(qq.y, kd[1], sc[r]);
        sc[r] = fmaf(qq.z, kd[2], sc[r]);
        sc[r] = fmaf(qq.w, kd[3], sc[r]);
        dp[r] = fmaf(oo.x, vd[0], dp[r]);
        dp[r] = fmaf(oo.y, vd[1], dp[r]);
        dp[r] = fmaf(oo.z, vd[2], dp[r]);
        dp[r] = fmaf(oo.w, vd[3], dp[r]);
      }
    }
    const int key = k0 + lane;
    const bool k_in = key < S;
    const float bias = k_in ? key_bias(mask, b, S, key) : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float p = k_in ? expf(sc[r] * scale + bias - l[r]) : 0.f;
      sds[(warp * kRows + r) * kTile + lane] = p * (dp[r] - dl[r]);
    }
    __syncwarp();

    // dQ += dS K over this warp's queries
    const float4* dsrow4 = reinterpret_cast<const float4*>(sds + warp * kRows * kTile);
    for (int j4 = 0; j4 < kTile / 4; ++j4) {
      float dsr[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 dd = dsrow4[r * (kTile / 4) + j4];
        dsr[r][0] = dd.x; dsr[r][1] = dd.y; dsr[r][2] = dd.z; dsr[r][3] = dd.w;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 4 * j4 + t;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float kc = sk[j * (D + 1) + lane + 32 * c];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r][c] = fmaf(dsr[r][t], kc, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = q0 + warp * kRows + r;
    if (s >= S) continue;
    const long row = (((long)b * S + s) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[row + lane + 32 * c] = acc[r][c] * scale;
  }
}

struct Args {
  const float *q, *k, *v, *dout, *mask, *lse, *delta;
  int B, S, H;
  const long *qs, *ks, *vs, *ds;
  cudaStream_t stream;
};

template <int D>
int launch_dkv(const Args& a, float* dk, float* dv) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + kBlock - 1) / kBlock, a.H, a.B);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.mask, a.lse, a.delta, dk, dv, a.S, a.H,
      a.qs[0], a.qs[1], a.qs[2], a.ks[0], a.ks[1], a.ks[2], a.vs[0], a.vs[1],
      a.vs[2], a.ds[0], a.ds[1], a.ds[2], 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const Args& a, float* dq) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + kBlock - 1) / kBlock, a.H, a.B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.mask, a.lse, a.delta, dq, a.S, a.H, a.qs[0],
      a.qs[1], a.qs[2], a.ks[0], a.ks[1], a.ks[2], a.vs[0], a.vs[1], a.vs[2],
      a.ds[0], a.ds[1], a.ds[2], 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* mask, const void* lse, const void* delta, int B,
               int S, int H, const long* qs, const long* ks, const long* vs,
               const long* ds, void* stream) {
  return Args{(const float*)q, (const float*)k, (const float*)v,
              (const float*)dout, (const float*)mask, (const float*)lse,
              (const float*)delta, B, S, H, qs, ks, vs, ds,
              (cudaStream_t)stream};
}

}  // namespace

// q, k, v, dout: float32 [B, S, H, D] with element strides {b, s, h} in
// *_strides and unit stride on D; mask: float32 [B, S] contiguous (> 0 =
// valid key) or null; lse, delta: float32 [B, H, S] contiguous; dk, dv
// (and dq): [B, S, H, D] contiguous. D must be 128 or 256 (returns
// cudaErrorInvalidValue otherwise). Each returns cudaGetLastError().
extern "C" int avsum_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* mask,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int S, int H,
                                   int D, const long* q_strides,
                                   const long* k_strides,
                                   const long* v_strides,
                                   const long* do_strides, void* stream) {
  const Args a = make_args(q, k, v, dout, mask, lse, delta, B, S, H,
                           q_strides, k_strides, v_strides, do_strides, stream);
  if (D == 128) return launch_dkv<128>(a, (float*)dk, (float*)dv);
  if (D == 256) return launch_dkv<256>(a, (float*)dk, (float*)dv);
  return (int)cudaErrorInvalidValue;
}

extern "C" int avsum_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* mask,
                                  const void* lse, const void* delta, void* dq,
                                  int B, int S, int H, int D,
                                  const long* q_strides, const long* k_strides,
                                  const long* v_strides,
                                  const long* do_strides, void* stream) {
  const Args a = make_args(q, k, v, dout, mask, lse, delta, B, S, H,
                           q_strides, k_strides, v_strides, do_strides, stream);
  if (D == 128) return launch_dq<128>(a, (float*)dq);
  if (D == 256) return launch_dq<256>(a, (float*)dq);
  return (int)cudaErrorInvalidValue;
}
