// Fused log-mel: reflect-padded waveform -> windowed DFT -> power -> mel
// -> log2(mel + eps), one pass; the [frames, n_fft/2+1] power spectrogram
// never reaches device memory.
//
// Replaces the TPU kernel avsum_tpu/ops/pallas_melspec.py::_melspec_kernel
// (wrapper fused_log_mel). Python wrapper: avsum_torch/ops/melspec.py,
// which also lays out the bases this kernel streams (kernel_bases).
//
// What bounds it on an H100: arithmetic. A frame costs n_fft * 2 * n_freqs
// multiply-adds for re/im (400 * 2 * 201) and n_freqs * n_mels for the mel
// projection, against 4 * hop bytes of new input: ~370 flops per byte.
// Both products run on the tensor cores as wgmma m64nNk8 TF32 in the
// 3xTF32 split (mma_tf32.cuh), so they keep float32's accuracy: the plain
// version is float32, and a quiet band beside a loud tone needs more than
// TF32's three digits in log2(mel + eps).
//
// wgmma rather than mma.sync: with mma.sync every warp loaded every basis
// fragment from shared memory, and those loads, not the MMAs, bounded the
// kernel (0.80 ms at 2^24 samples on an H100; cutting two of every three
// MMAs saved a fifth of it). A wgmma reads its B operand once for the four
// warps of a warpgroup. Its A operand comes from registers, so the frames
// stay overlapping slices of one run of samples, loaded by address.
//
// Design:
//   - A block owns kFrames = 128 consecutive frames: two warpgroups of 64,
//     8 warps of 16. With n_fft == 2 * hop, frame f is hop-long runs f and
//     f + 1 of the block's samples, so shared memory holds kFrames + 1
//     runs, each padded from hop to hop_pad (a multiple of 8, zeros) plus
//     4 floats. The DFT is frames[128 x 2 hop_pad] @ bases[2 hop_pad x 64]
//     per chunk of 32 bins, and row f of its A operand is runs f, f + 1 read
//     in place: a k-step of 8 never straddles two runs, and the pitch
//     hop_pad + 4 = 4 * odd puts the 8 rows x 4 columns of a fragment on 32
//     banks. A warp loads and splits the A fragments of a stage's 10
//     k-steps, then its warpgroup issues 30 wgmmas m64n64k8 into a partial
//     sum from zero, added to the chunk's accumulators in float32.
//   - The bases are window-folded, split into TF32 (big, small) planes and
//     laid out once on the host in wgmma's K-major core-matrix order, bin
//     b's cos and sin in columns 2b, 2b + 1. Those land in d[4i], d[4i + 1]
//     (and d[4i + 2], d[4i + 3]) of one thread, so power = re^2 + im^2 is
//     formed in registers, and the power of a 32-bin chunk is already the
//     A fragment of the mel product's four k-steps: power[64 x 32] @
//     fbank[32 x 128] gives a chunk's mel[64 x 128] per warpgroup in 12
//     wgmmas, summed from zero and added to the mel accumulators in
//     float32, as the DFT's stages are.
//   - The bases stream in stages of kStageFloats (10 k-steps of a chunk,
//     or a chunk's fbank rows), double-buffered with 16-byte cp.async: the
//     next stage's copy overlaps the current stage's wgmmas; the block's
//     samples arrive by cp.async too, with the first stage.
//   - mel and log2(mel + eps) are written once, from the accumulators.
//   - A pass covers kMelWidth = 128 mel columns; n_mels above 128 takes
//     grid.y = 2 passes, each recomputing the DFT for its columns. The
//     fbank's columns past n_mels are zero and are never written.
//   - The wrapper lays the bases out for this tiling; avsum_melspec_layout
//     reports it, and the wrapper checks it against its own before the
//     first launch.

#include <cuda_runtime.h>
#include <math.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kFrames = 128;      // frames per block
constexpr int kThreads = 256;     // 2 warpgroups x 64 frames
constexpr int kChunkBins = 32;    // DFT bins per chunk
constexpr int kN = 2 * kChunkBins;  // DFT columns per chunk (cos, sin)
constexpr int kPlane = 8 * kN;    // floats of one k-step's B plane
constexpr int kStageSteps = 10;   // k-steps of 8 per streamed stage
constexpr int kStageFloats = kStageSteps * 2 * kPlane;  // big + small planes
constexpr int kMelSteps = kChunkBins / 8;  // mel k-steps per chunk
constexpr int kMelWidth = 128;    // mel columns per pass
static_assert(kMelSteps * 2 * 8 * kMelWidth <= kStageFloats,
              "fbank fits a stage");

struct Geometry {
  int hop_pad, pitch, n_k, n_chunks, dft_stages;
  __host__ __device__ explicit Geometry(int hop)
      : hop_pad((hop + 7) / 8 * 8),
        pitch(hop_pad + 4),
        n_k(hop_pad / 4),  // 2 * hop_pad / 8
        n_chunks((hop + 1 + kChunkBins - 1) / kChunkBins),
        dft_stages((n_k + kStageSteps - 1) / kStageSteps) {}
  __host__ __device__ int stages() const { return n_chunks * (dft_stages + 1); }
  size_t smem_bytes() const {
    return sizeof(float) *
           (2 * (size_t)kStageFloats + (size_t)(kFrames + 1) * pitch);
  }
};

__global__ void __launch_bounds__(kThreads, 1)
melspec_kernel(const float* __restrict__ x, long x_len,
               const float* __restrict__ bases,  // [passes][stages][kStageFloats]
               float* __restrict__ mel, float* __restrict__ logmel,
               int n_frames, int hop, int n_mels, float eps) {
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);  // [2][kStageFloats]
  float* seg = stage + 2 * kStageFloats;           // [kFrames + 1][pitch]
  const Geometry geo(hop);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int f0 = blockIdx.x * kFrames;
  const int n_stages = geo.stages();
  const float* src = bases + (size_t)blockIdx.y * n_stages * kStageFloats;

  auto load_stage = [&](int s) {
    const float* from = src + (size_t)s * kStageFloats;
    float* to = stage + (s & 1) * kStageFloats;
    for (int i = 4 * tid; i < kStageFloats; i += 4 * kThreads)
      tf32::cp_async16(to + i, from + i);
  };
  // Wait for stage s, then start the copy of stage s + 1 into the buffer
  // that stage s - 1 used (every wgmma on it was waited for before the
  // barrier).
  auto begin_stage = [&](int s) {
    tf32::cp_async_wait<0>();
    tf32::fence_proxy_async();
    __syncthreads();
    if (s + 1 < n_stages) {
      load_stage(s + 1);
      tf32::cp_async_commit();
    }
    return stage + (s & 1) * kStageFloats;
  };

  // Stage 0 and the block's kFrames + 1 runs of hop samples (zeros past
  // hop and x_len), as one group of async copies when the runs are
  // 16-byte aligned.
  load_stage(0);
  const long base = (long)f0 * hop;
  if ((hop & 3) == 0 && (reinterpret_cast<size_t>(x) & 15) == 0) {
    const int chunks = geo.pitch / 4;
    for (int i = tid; i < (kFrames + 1) * chunks; i += kThreads) {
      const int r = i / chunks, o = 4 * (i - r * chunks);
      const long at = base + (long)r * hop + o;
      long n = hop - o < 4 ? hop - o : 4;  // floats of this chunk to copy
      if (x_len - at < n) n = x_len - at;
      tf32::cp_async16(seg + r * geo.pitch + o, n > 0 ? x + at : x,
                       n > 0 ? 4 * (int)n : 0);
    }
  } else {
    for (int i = tid; i < (kFrames + 1) * geo.pitch; i += kThreads) {
      const int r = i / geo.pitch, o = i - r * geo.pitch;
      const long at = base + (long)r * hop + o;
      seg[i] = (o < hop && at < x_len) ? x[at] : 0.f;
    }
  }
  tf32::cp_async_commit();

  float macc[kMelWidth / 2];  // mel, kMelWidth / 8 m16n8 C fragments
#pragma unroll
  for (int i = 0; i < kMelWidth / 2; ++i) macc[i] = 0.f;
  // row g of this warp's frames; k-steps past hop_pad read the next run,
  // which starts 4 floats further than hop_pad on
  const float* arow = seg + (warp * 16 + g) * geo.pitch + t;
  int s = 0;
  for (int c = 0; c < geo.n_chunks; ++c) {
    float acc[kN / 2];  // re, im of the chunk's bins
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;

    for (int st = 0; st < geo.dft_stages; ++st) {
      const float* b = begin_stage(s++);
      const int j0 = st * kStageSteps;
      uint32_t big[kStageSteps][4], small[kStageSteps][4];
#pragma unroll
      for (int jj = 0; jj < kStageSteps; ++jj) {
        // k-steps past 2 hop_pad (a ragged last stage) have zero bases;
        // they read the row's first samples
        const int k0 = 8 * (j0 + jj);
        const float* a = arow + (k0 < geo.hop_pad       ? k0
                                 : k0 < 2 * geo.hop_pad ? k0 + 4
                                                        : 0);
        tf32::split(a[0], big[jj][0], small[jj][0]);
        tf32::split(a[8 * geo.pitch], big[jj][1], small[jj][1]);
        tf32::split(a[4], big[jj][2], small[jj][2]);
        tf32::split(a[8 * geo.pitch + 4], big[jj][3], small[jj][3]);
      }
      float d[kN / 2];
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) d[i] = 0.f;
      tf32::wgmma3<kPlane>(d, big, small, b);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[i] += d[i];
    }

    // power of the chunk's bins 8kk + t (columns of C fragment 2kk) and
    // 8kk + 4 + t (fragment 2kk + 1): the A fragment of the mel product's
    // k-step kk
    const float* b = begin_stage(s++);
    uint32_t big[kMelSteps][4], small[kMelSteps][4];
#pragma unroll
    for (int kk = 0; kk < kMelSteps; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // e: (row g | g + 8) x (fragment 2kk | 2kk + 1)
        const float* v = acc + 4 * (2 * kk + e / 2) + 2 * (e % 2);
        tf32::split(fmaf(v[0], v[0], v[1] * v[1]), big[kk][e], small[kk][e]);
      }
    float d[kMelWidth / 2];
#pragma unroll
    for (int i = 0; i < kMelWidth / 2; ++i) d[i] = 0.f;
    tf32::wgmma3<8 * kMelWidth>(d, big, small, b);
#pragma unroll
    for (int i = 0; i < kMelWidth / 2; ++i) macc[i] += d[i];
  }

  const int col0 = blockIdx.y * kMelWidth + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = f0 + warp * 16 + g + 8 * h;
    if (f >= n_frames) continue;
#pragma unroll
    for (int m = 0; m < kMelWidth / 8; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * m + e;
        if (col < n_mels) {
          const float v = macc[4 * m + 2 * h + e];
          mel[(long)f * n_mels + col] = v;
          logmel[(long)f * n_mels + col] = log2f(v + eps);
        }
      }
  }
}

}  // namespace

// The tiling for hop: out[0..9] = kFrames, kChunkBins, kStageSteps,
// kStageFloats, kMelWidth, hop_pad, pitch, n_chunks, dft_stages, and the
// dynamic shared memory in bytes.
extern "C" void avsum_melspec_layout(int hop, long* out) {
  const Geometry geo(hop);
  const long v[] = {kFrames, kChunkBins, kStageSteps, kStageFloats,
                    kMelWidth, geo.hop_pad, geo.pitch, geo.n_chunks,
                    geo.dft_stages, (long)geo.smem_bytes()};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
}

// x: reflect-padded waveform [x_len] with x_len >= (n_frames + 1) * hop;
// bases: the wrapper's stage stream for (hop, n_mels); mel, logmel:
// [n_frames, n_mels], n_mels <= 2 * kMelWidth. Returns cudaGetLastError().
extern "C" int avsum_melspec(const void* x, long x_len, const void* bases,
                             void* mel, void* logmel, int n_frames, int hop,
                             int n_mels, float eps, void* stream) {
  const size_t smem = Geometry(hop).smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      melspec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + kFrames - 1) / kFrames,
                  (n_mels + kMelWidth - 1) / kMelWidth);
  melspec_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, x_len, (const float*)bases, (float*)mel,
      (float*)logmel, n_frames, hop, n_mels, eps);
  return (int)cudaGetLastError();
}
