// Fused log-mel: reflect-padded waveform -> windowed DFT -> power -> mel
// -> log2(mel + eps), one pass; the [frames, n_fft/2+1] power spectrogram
// never reaches device memory.
//
// Replaces the TPU kernel avsum_tpu/ops/pallas_melspec.py::_melspec_kernel
// (wrapper fused_log_mel). Python wrapper: avsum_torch/ops/melspec.py.
//
// What bounds it on an H100: arithmetic. Each frame costs n_fft * n_freqs
// * 2 multiply-adds for re/im (400 * 201 * 2) plus n_freqs * 128 for the
// mel projection, against 4 * hop bytes of new input and 1 KB of output:
// ~400 flops per byte read, above the card's float32 balance point. The
// TPU kernel kept four 200x256 windowed basis planes plus the fbank
// resident (~0.9 MB); a Hopper block has 227 KB, so here:
//   - a block owns kFrames consecutive frames. Because n_fft == 2 * hop,
//     its (kFrames + 1) * hop contiguous samples in shared memory hold all
//     of them (frame t = samples [t*hop, t*hop + n_fft)): no gather and no
//     duplicated frame copy;
//   - the block walks the 201 real frequency bins in chunks of kFreqChunk,
//     streaming each chunk of the window-folded cos/sin bases (and the
//     fbank rows for those bins) from L2 into shared memory, computing
//     re/im and the power chunk, and accumulating mel[kFrames, 128] +=
//     power_chunk @ fbank_chunk in registers;
//   - mel and log2(mel + eps) are written once at the end.
// Plain FP32 FMAs on the CUDA cores (the comparison with the plain
// PyTorch version is float32 with TF32 off); tensor cores are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kFrames = 32;      // frames per block
constexpr int kFreqChunk = 16;   // DFT bins per streamed basis chunk
constexpr int kMels = 128;       // mel bands (the wrapper checks)
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kFrames * kMels / kThreads;  // 16

__global__ void __launch_bounds__(kThreads)
melspec_kernel(const float* __restrict__ x, long x_len,
               const float* __restrict__ cos_w,  // [n_fft, n_freqs]
               const float* __restrict__ sin_w,  // [n_fft, n_freqs]
               const float* __restrict__ fbank,  // [n_freqs, kMels]
               float* __restrict__ mel, float* __restrict__ logmel,
               int n_frames, int hop, int n_freqs, float eps) {
  extern __shared__ float smem[];
  const int n_fft = 2 * hop;
  const int n_seg = (kFrames + 1) * hop;
  float* seg = smem;                       // [n_seg]
  float* bc = seg + n_seg;                 // [n_fft][kFreqChunk]
  float* bs = bc + n_fft * kFreqChunk;     // [n_fft][kFreqChunk]
  float* fb = bs + n_fft * kFreqChunk;     // [kFreqChunk][kMels]
  float* pw = fb + kFreqChunk * kMels;     // [kFrames][kFreqChunk]

  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * kFrames;
  const long base = (long)f0 * hop;
  for (int i = tid; i < n_seg; i += kThreads) {
    const long g = base + i;
    seg[i] = g < x_len ? x[g] : 0.f;
  }

  // mel accumulators: this thread owns band m of frames r0, r0+2, ...
  const int m = tid % kMels;
  const int r0 = tid / kMels;
  float acc[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < n_freqs; k0 += kFreqChunk) {
    __syncthreads();  // samples loaded / previous chunk consumed
    for (int i = tid; i < n_fft * kFreqChunk; i += kThreads) {
      const int n = i / kFreqChunk;
      const int k = k0 + i % kFreqChunk;
      const bool ok = k < n_freqs;  // ragged last chunk: zero bases
      bc[i] = ok ? cos_w[(long)n * n_freqs + k] : 0.f;
      bs[i] = ok ? sin_w[(long)n * n_freqs + k] : 0.f;
    }
    for (int i = tid; i < kFreqChunk * kMels; i += kThreads) {
      const int k = k0 + i / kMels;
      fb[i] = k < n_freqs ? fbank[(long)k * kMels + i % kMels] : 0.f;
    }
    __syncthreads();

    // power chunk: each (frame, bin) pair is two n_fft-long dot products
    for (int p = tid; p < kFrames * kFreqChunk; p += kThreads) {
      const int t = p / kFreqChunk;
      const int kk = p % kFreqChunk;
      const float* s = seg + t * hop;
      float re = 0.f, im = 0.f;
      for (int n = 0; n < n_fft; ++n) {
        const float v = s[n];
        re = fmaf(v, bc[n * kFreqChunk + kk], re);
        im = fmaf(v, bs[n * kFreqChunk + kk], im);
      }
      pw[p] = re * re + im * im;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kFreqChunk; ++kk) {
      const float f = fb[kk * kMels + m];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j)
        acc[j] = fmaf(pw[(r0 + 2 * j) * kFreqChunk + kk], f, acc[j]);
    }
  }

#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int t = f0 + r0 + 2 * j;
    if (t < n_frames) {
      mel[(long)t * kMels + m] = acc[j];
      logmel[(long)t * kMels + m] = log2f(acc[j] + eps);
    }
  }
}

}  // namespace

// x: reflect-padded waveform [x_len] with x_len >= (n_frames + 1) * hop;
// bases window-folded [2*hop, n_freqs]; fbank [n_freqs, 128];
// mel, logmel: [n_frames, 128]. Returns cudaGetLastError().
extern "C" int avsum_melspec(const void* x, long x_len, const void* cos_w,
                             const void* sin_w, const void* fbank, void* mel,
                             void* logmel, int n_frames, int hop, int n_freqs,
                             float eps, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kFrames + 1) * hop +
                       2 * (size_t)(2 * hop) * kFreqChunk +
                       kFreqChunk * kMels + kFrames * kFreqChunk);
  cudaError_t err = cudaFuncSetAttribute(
      melspec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_frames + kFrames - 1) / kFrames;
  melspec_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, x_len, (const float*)cos_w, (const float*)sin_w,
      (const float*)fbank, (float*)mel, (float*)logmel, n_frames, hop,
      n_freqs, eps);
  return (int)cudaGetLastError();
}
