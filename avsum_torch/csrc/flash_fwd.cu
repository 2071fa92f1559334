// Flash-attention forward: O = softmax(Q K^T / sqrt(D) + key bias) V with
// an online softmax, float32 throughout; the [S, S] probabilities never
// reach device memory. Also writes LSE = m + log(max(l, 1e-30)) per query
// row.
//
// Replaces the TPU kernel avsum_tpu/ops/attention.py::_flash_fwd_kernel
// (pallas_call in _flash_fwd; wrapper flash_attention). Python wrapper:
// avsum_torch/ops/attention.py.
//
// Layout: q and k are [B, S, H, Dqk] views, v a [B, S, H, Dv] view, read
// through their (b, s, h) strides with a unit stride on the head width,
// so the scorer's fused qkv projection [B, S, 3, H, D] (Dqk = Dv = D) and
// latent attention's q, k and the v half of its kv_b projection (Dqk =
// 192, Dv = 128) are read in place; the strides must be multiples of 4
// floats and the base addresses 16-byte aligned, as TMA and the 16-byte
// query loads need (the wrapper copies a view that is not). Out is
// [B, S, H, Dv] contiguous, LSE [B, H, S]. The scores are scaled by
// Dqk^-1/2. The width pairs (Dqk, Dv) are (128, 128), (256, 256) and
// (192, 128); D below is Dqk where it spans q and k, Dv where it spans v. Keys past S (the ragged last
// tile) land as zeros and take no part, so S needs no padding; masked
// keys take part at a -1e30 bias, so a row whose keys are all masked
// averages V uniformly over the S keys (the materialized softmax's
// answer) and has LSE = -1e30 in float32, which the backward relies on.
//
// What bounds it on an H100: arithmetic. 2 * S^2 * (Dqk + Dv) flops per
// head (S x S x Dqk and S x S x Dv products) against O(S * D) bytes; in
// 3xTF32 (three TF32 products each, for float32's accuracy) at the dense
// TF32 peak of 495 TFLOP/s that is at least 1.28 ms at [1, 7168, 4, 256],
// 0.64 ms at D = 128 and 3.19 ms at [1, 7168, 16, 192 / 128], where q, k,
// v and out take 0.035 ms at 3.35 TB/s at [1, 7168, 4, 256].
//
// Design: on the machinery of flash_tiles.cuh (shared with the backward,
// flash_bwd.cu). A block of two warpgroups (256 threads)
// owns R queries of one (b, h): R = 64, or 32 where 64-query blocks would
// not cover the card's SMs (the launcher's choice, below). The R queries
// are the N of every product (wgmma m64nRk8 TF32 in the 3xTF32 split,
// mma_tf32.cuh), their big and small K-major B planes loaded and split
// once a block (R Dqk floats each). K and V stream in tiles of kTile = 64
// keys (wgmma's M), by TMA, in chunks of [64 keys x 64 columns of D], and
// the two groups take D's chunks by turns: group g reads chunks c with
// c % 2 == g (at Dqk = 192 group 0 K's chunks 0 and 2, group 1 chunk 1),
// gathers its A fragments from the landed chunk into
// registers and splits them there in two instructions (split_trunc, held
// to the tolerance by tests/test_torch_flash_split.py). Per tile:
//   1. S^T = K Q^T [64 keys x R queries]: each group its half of D (A the
//      K chunks by row, B the query planes), a partial sum in registers.
//   2. The exchange: each group softmaxes half of the queries, so each
//      hands the other its partial of the other's columns (16 floats a
//      thread at R = 64) through the other's columns of the P planes, which
//      that group overwrites with its P once read.
//   3. The online softmax of the group's R / 2 queries over the tile's 64
//      keys, spread over its four warps (16 rows each), in base 2: the
//      scale and the key bias times log2(e), -inf for keys past S; each
//      column's max by shuffles within a warp, then across the warps
//      through a small shared buffer (one 16-byte load a column); alpha =
//      2^(m_old - m_new), P = 2^(S^T - m_new) (the SFU's ex2) split into
//      the P planes [R queries x 64 keys], each thread's share of the
//      running sum l (the shares are added once, at the end); alpha into
//      a shared row. LSE = m / log2(e) + log(l): -1e30 log2(e) / log2(e)
//      is -1e30 again in float32, so a row with every key masked keeps
//      its LSE of -1e30 for the backward.
//   4. O^T = alpha O^T + V^T P^T [Dv x R]: each group its half of Dv's
//      64-row m-tiles (A the V chunks by column, B the P planes), rescaled
//      by every query's alpha in registers first; O^T stays in registers,
//      Dv R / 256 floats a thread: 64 at Dv = 256, R = 64; 32 at Dv = 128.
// Three barriers of all 256 threads a tile (S^T done, so the P planes are
// free; the partials exchanged; P and alpha written) and one of each
// group's 128 (its warps' maxima). The groups run the softmax at once, on
// half the columns each, while the tensor cores wait.
//
// Why both groups split D and both run a softmax: splitting the queries
// between the groups instead (N = R / 2, every chunk gathered by both)
// ran [1, 7168, 4, 256] in 3.11 ms on an H100 against this design's 2.74
// (scripts/time_flash_torch.py on both trees in turns, before the softmax
// moved to base 2; PERF.md), its wgmma stream far from the TF32 peak even
// without gathers or softmax. Here the gathers cost next to nothing and
// the softmax phase, when the tensor cores wait, is what bounds it: so
// both groups take half of it, not one group all of it. The exchange goes
// through the P planes because a buffer of its own (16 KB at R = 64) would
// cost a ring stage at D = 256.
//
// At (192, 128) the groups' shares of step 1 are 2 : 1 chunks, of step 4
// one m-tile each. Both groups feed the SM's tensor cores, which run the
// true widths' 5 products a tile where the widths padded to 256 took 8;
// the block size, the exchange and the softmax are as at the square
// widths. Time at [1, 7168, 16, 192 / 128] on an H100: PERF.md.
//
// The ring: kStages stages of 16 KB, a tile's K chunks, then its V chunks,
// tracked by full and empty mbarriers. Each chunk has one reader group,
// so a stage's empty barrier waits for four warps, and that group's first
// thread loads the chunk kStages ahead into the stage once they are done.
// The query planes and P's fill the rest of the shared memory; the ring
// takes what is left:
//   R = 64: 4 stages at D = 256 (231,744 bytes), 8 at D = 128 (231,808),
//     6 at (192, 128) (231,776);
//   R = 32: 9 stages at D = 256 (231,184), 11 at D = 128 (231,216), 10
//     at (192, 128) (231,200);
// one block an SM. avsum_flash_fwd_layout reports this tiling; the wrapper
// checks it against its own (fwd_layout) before its first launch at a
// width pair.
//
// As in the backward (flash_bwd.cu's note): each product of a chunk is 24
// wgmmas in two commit groups of 4 k-steps, the next group's A fragments
// read while the group before runs, its sum started from zero and added to
// the float32 accumulator once (8 k-steps a run); the phase loops are
// unrolled so that ptxas does not serialize the wgmmas (note C7514). The
// epilogue divides by l and stores O and LSE one element at a time.
//
// The launcher takes R = 64 where B * H * ceil(S / 64) reaches the card's
// SM count, else R = 32: [1, 7168, 4, D] runs 448 blocks of 64 queries
// (3.4 waves on 132 SMs); [1, 544, 4, D] (summarize of a 533-shot video)
// 68 blocks of 32, where 64 would fill 36 SMs; [1, 1024, 4, D] (the train
// run) 128 of 32.
//
// Time on an H100: PERF.md (chip_smoke.py's check_k2).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

using namespace flash;

constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
// named barriers of all 256 threads (1 + group: one group's own)
constexpr int kBarSDone = 3, kBarXReady = 4, kBarPReady = 5;

// The tiling of a block of R queries at head widths DQ (q, k), DV (v).
template <int DQ, int DV, int R>
struct Layout {
  static constexpr int kQChunks = DQ / kChunk;  // K's chunks a tile
  static constexpr int kVChunks = DV / kChunk;  // V's
  static constexpr int kPlane = R * DQ;      // a query plane
  static constexpr int kPPlane = R * kTile;  // a P plane
  static constexpr size_t kFixed =
      1024                           // to align the ring
      + 4 * (size_t)(2 * kPlane)     // the query planes, big and small
      + 4 * (size_t)(2 * kPPlane)    // the P planes, big and small
      + 4 * (size_t)(4 * R + R);     // the softmax's maxima and sums, alpha
  // as many stages as fit, each with full and empty mbarriers
  static constexpr int kStageBytes = kChunkBytes + 8 + 8;
  static constexpr int kStages = (kSmemLimit - (int)kFixed) / kStageBytes;
  static constexpr size_t kBytes = kFixed + (size_t)kStages * kStageBytes;
};
static_assert(Layout<256, 256, 64>::kStages == 4 &&
                  Layout<128, 128, 64>::kStages == 8 &&
                  Layout<192, 128, 64>::kStages == 6,
              "K2's ring at 64 queries a block");
static_assert(Layout<256, 256, 32>::kStages == 9 &&
                  Layout<128, 128, 32>::kStages == 11 &&
                  Layout<192, 128, 32>::kStages == 10,
              "K2's ring at 32 queries a block");

// 2^x by the SFU (ex2.approx: a relative error of ~2^-22, 2^-inf = 0); the
// softmax runs in base 2, its scores and maxima scaled by log2(e).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* q;
  long qs[3];         // q's (b, s, h) strides
  const float* mask;  // [B, S] or null
  float *out, *lse;   // [B, S, H, Dv], [B, H, S]
  int S, H;
  float scale;
};

template <int DQ, int DV, int R>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<DQ, DV, R>;
  constexpr int NQ = L::kQChunks;
  constexpr int NQ0 = (NQ + 1) / 2, NQ1 = NQ / 2;  // K chunks of group 0, 1
  constexpr int NG = L::kVChunks / 2;  // O^T's m-tiles a group takes
  constexpr int kPerTile = NQ + L::kVChunks;  // chunks a tile
  static_assert(L::kVChunks % 2 == 0 && (NQ0 == NQ1 || NQ0 == 2),
                "one or two K chunks a group, V's m-tiles split evenly");
  constexpr int HC = R / 2;          // queries whose softmax a group runs
  constexpr int I2 = R / 16;         // their 8-column n-tiles
  constexpr uint64_t kChunkDesc = 4 * 8 * 8 * R >> 4;  // 8 k-steps of a plane
  extern __shared__ float4 smem4[];
  // Shared addresses: the ring (1024-aligned for the 128-byte swizzle),
  // the query planes [big, small], the P planes [big, small], the
  // warps' maxima or sums [group][HC][warp], alpha or l [R], the
  // mbarriers full[stage], empty[stage].
  const uint32_t ring = (tf32::smem_addr(smem4) + 1023) & ~1023u;
  const uint32_t q_big = ring + L::kStages * kChunkBytes;
  const uint32_t q_small = q_big + 4 * L::kPlane;
  const uint32_t p_big = q_small + 4 * L::kPlane;
  const uint32_t p_small = p_big + 4 * L::kPPlane;
  const uint32_t red = p_small + 4 * L::kPPlane;
  const uint32_t cols = red + 4 * 4 * R;
  const uint32_t full = cols + 4 * R;
  const uint32_t empty = full + 8 * L::kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int S = p.S;
  const int n_tiles = (S + kTile - 1) / kTile;
  const int n_chunks = n_tiles * kPerTile;

  // Chunk m of the stream into its stage: tile m / kPerTile, K's chunks
  // c < NQ, then V's.
  auto load = [&](int m) {
    const int s = m % L::kStages, it = m / kPerTile, pos = m % kPerTile;
    const CUtensorMap* map = pos < NQ ? &tk : &tv;
    const int c = pos < NQ ? pos : pos - NQ;
    const uint32_t dst = ring + s * kChunkBytes;
    tf32::mbar_expect_tx(full + 8 * s, kChunkBytes);
    tf32::tma_load_4d(dst, map, full + 8 * s, c * kChunk, h, it * kTile, b);
    tf32::tma_load_4d(dst + kBoxBytes, map, full + 8 * s, c * kChunk + kBox,
                      h, it * kTile, b);
  };
  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      tf32::mbar_init(full + 8 * s, 1);
      tf32::mbar_init(empty + 8 * s, 4);  // the warps of the group reading it
    }
    tf32::mbar_fence_init();
    for (int m = 0; m < L::kStages && m < n_chunks; ++m) load(m);
  }
  split_rows<R, DQ, kThreads>(q_big, q_small, p.q + b * p.qs[0] + h * p.qs[2],
                             p.qs[1], q0, S, tid);
  tf32::fence_proxy_async();
  __syncthreads();

  // The group index through a shuffle, so that the compiler knows it is
  // the same across the warp and keeps the planes' descriptors uniform.
  const int grp = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int w = warp & 3, g = lane >> 2, t = lane & 3;
  const uint64_t qd_big = tf32::wgmma_desc_at(q_big);
  const uint64_t qd_small = tf32::wgmma_desc_at(q_small);
  const uint64_t pd_big = tf32::wgmma_desc_at(p_big);
  const uint64_t pd_small = tf32::wgmma_desc_at(p_small);
  const uint32_t my_red = red + 4 * grp * 4 * HC;  // [HC][warp]
  const Gather ga(w, g, t);
  // Value j of this thread's share of the partial scores that half hh of
  // the queries takes from the other group: in the big P plane's columns of
  // half hh, which that half's group overwrites with its P once read.
  auto xchg = [&](int hh, int j) {
    const int v = j * 128 + (tid & 127);
    return p_big + 4 * ((v / (4 * R)) * 8 * R + 4 * R * hh + v % (4 * R));
  };

  // Chunk n of the stream: wait for it to land; -> its shared address.
  auto take = [&](int n) {
    const int s = n % L::kStages;
    tf32::mbar_wait(full + 8 * s, (n / L::kStages) & 1);
    return ring + s * kChunkBytes;
  };
  // This warp is done reading chunk n; the group's first thread then loads
  // chunk n + kStages into the stage once the group's four warps are done.
  auto release = [&](int n) {
    return [&, n]() {
      const int s = n % L::kStages;
      tf32::fence_proxy_async();  // these reads before the stage's next TMA
      __syncwarp();
      if (lane == 0) tf32::mbar_arrive(empty + 8 * s);
      if ((tid & 127) == 0 && n + L::kStages < n_chunks) {
        tf32::mbar_wait(empty + 8 * s, (n / L::kStages) & 1);
        load(n + L::kStages);
      }
      __syncwarp();
    };
  };

  // Accumulator element v[4i + e] of a product: row 16w + g + 8 (e / 2),
  // query column 8i + 2t + e % 2. The group's own queries are the columns
  // grp HC + 8 i2 + 2t + j (i = grp I2 + i2); their running max and sum
  // are at [2 i2 + j].
  float acc[NG][R / 2];  // O^T, m-tile 2jj + grp of Dv at [jj]
#pragma unroll
  for (int jj = 0; jj < NG; ++jj)
#pragma unroll
    for (int i = 0; i < R / 2; ++i) acc[jj][i] = 0.f;
  float m_run[2 * I2], l_run[2 * I2];
#pragma unroll
  for (int j = 0; j < 2 * I2; ++j) {
    m_run[j] = -INFINITY;
    l_run[j] = 0.f;
  }
  Pipe<R> pq;
  const float scale2 = p.scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    const int n0 = it * kPerTile;  // the tile's first chunk
    // This thread's key rows 16w + g + 8r: the key bias, -inf past S.
    float kb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = it * kTile + 16 * w + g + 8 * r;
      kb[r] = key < S ? key_bias(p.mask, b, S, key) * kLog2e : -INFINITY;
    }

    // 1. This group's part of S^T = K Q^T: K's chunks grp (and grp + 2)
    // of Dqk, summed in the Pipe's partials (no product is added in the
    // phase, so the first partial keeps its sum)
    if constexpr (NQ0 == NQ1) {
      issue<0, true>(pq, true, ga, take(n0 + grp), qd_big + grp * kChunkDesc,
                     qd_small + grp * kChunkDesc, release(n0 + grp), pq.d[1]);
      if (NQ0 == 2)
        issue<1, true>(pq, true, ga, take(n0 + grp + 2),
                       qd_big + (grp + 2) * kChunkDesc,
                       qd_small + (grp + 2) * kChunkDesc,
                       release(n0 + grp + 2), pq.d[0]);
      if (NQ0 == 1) {
#pragma unroll
        for (int i = 0; i < R / 2; ++i) pq.d[1][i] = 0.f;
      }
      drain<NQ0 - 1>(pq, pq.d[NQ0 == 2 ? 0 : 1]);
    } else if (grp == 0) {  // three chunks: group 0 takes 0 and 2
      issue<0, true>(pq, true, ga, take(n0), qd_big, qd_small, release(n0),
                     pq.d[1]);
      issue<1, true>(pq, true, ga, take(n0 + 2), qd_big + 2 * kChunkDesc,
                     qd_small + 2 * kChunkDesc, release(n0 + 2), pq.d[0]);
      drain<1>(pq, pq.d[0]);
    } else {  // and group 1 chunk 1, its sum into the same partial
#pragma unroll
      for (int i = 0; i < R / 2; ++i) pq.d[0][i] = 0.f;
      issue<1, true>(pq, true, ga, take(n0 + 1), qd_big + kChunkDesc,
                     qd_small + kChunkDesc, release(n0 + 1), pq.d[0]);
      drain<1>(pq, pq.d[0]);
    }
    const float(&sc)[R / 2] = pq.d[NQ0 == 1 ? 1 : 0];

    // 2. Each group takes the other's part of its own queries' scores.
    float own[R / 4], oth[R / 4];
#pragma unroll
    for (int i2 = 0; i2 < I2; ++i2)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lo = sc[4 * i2 + e], hi = sc[4 * (I2 + i2) + e];
        own[4 * i2 + e] = grp ? hi : lo;
        oth[4 * i2 + e] = grp ? lo : hi;
      }
    bar_wait(kBarSDone);  // both groups' products of the last tile are done
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
      tf32::sts(xchg(grp ^ 1, j), __float_as_uint(oth[j]));
    bar_wait(kBarXReady);
#pragma unroll
    for (int j = 0; j < R / 4; ++j) own[j] += tf32::lds(xchg(grp, j));

    // 3. The online softmax of the group's queries: each column's max over
    // the warp's 16 keys (lanes g), then over the group's four warps
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
      own[j] = fmaf(own[j], scale2, kb[(j & 3) >> 1]);
    float alpha[2 * I2];
#pragma unroll
    for (int i2 = 0; i2 < I2; ++i2)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = fmaxf(own[4 * i2 + j], own[4 * i2 + 2 + j]);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
        alpha[2 * i2 + j] = x;
      }
    if (g == 0)
#pragma unroll
      for (int i2 = 0; i2 < I2; ++i2)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          tf32::sts(my_red + 4 * (4 * (8 * i2 + 2 * t + j) + w),
                    __float_as_uint(alpha[2 * i2 + j]));
    group_sync(grp);  // the warps' maxima are in; the partials are read
#pragma unroll
    for (int i2 = 0; i2 < I2; ++i2)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 mw = tf32::lds4(my_red + 16 * (8 * i2 + 2 * t + j));
        const float m = fmaxf(fmaxf(m_run[2 * i2 + j], fmaxf(mw.x, mw.y)),
                              fmaxf(mw.z, mw.w));
        alpha[2 * i2 + j] = ex2(m_run[2 * i2 + j] - m);
        m_run[2 * i2 + j] = m;
      }
#pragma unroll
    for (int i2 = 0; i2 < I2; ++i2)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = own[4 * i2 + e];
        x = ex2(x - m_run[2 * i2 + (e & 1)]);
        const uint32_t at = 4 * pds_at<R>(grp * I2 + i2, e, w, g, t);
        uint32_t hi, lo;
        tf32::split(x, hi, lo);
        tf32::sts(p_big + at, hi);
        tf32::sts(p_small + at, lo);
      }
#pragma unroll
    for (int i2 = 0; i2 < I2; ++i2)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        l_run[2 * i2 + j] = fmaf(l_run[2 * i2 + j], alpha[2 * i2 + j],
                                 own[4 * i2 + j] + own[4 * i2 + 2 + j]);
        if (w == 0 && g == 0)
          tf32::sts(cols + 4 * (grp * HC + 8 * i2 + 2 * t + j),
                    __float_as_uint(alpha[2 * i2 + j]));
      }
    tf32::fence_proxy_async();
    bar_wait(kBarPReady);  // P and alpha of every query are in

    // 4. O^T = alpha O^T + V^T P^T: V's chunks 2jj + grp, m-tiles of Dv
#pragma unroll
    for (int i = 0; i < R / 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 a2 = tf32::lds2(cols + 4 * (8 * i + 2 * t));
        const float a = j ? a2.y : a2.x;
#pragma unroll
        for (int jj = 0; jj < NG; ++jj) {
          acc[jj][4 * i + j] *= a;
          acc[jj][4 * i + 2 + j] *= a;
        }
      }
#pragma unroll
    for (int jj = 0; jj < NG; jj += 2) {
      const int n = n0 + NQ + 2 * jj + grp;
      issue<0, false>(pq, jj == 0, ga, take(n), pd_big, pd_small, release(n),
                      acc[jj > 0 ? jj - 1 : 0]);
      if (jj + 1 < NG)
        issue<1, false>(pq, false, ga, take(n + 2), pd_big, pd_small,
                        release(n + 2), acc[jj]);
    }
    if (NG % 2) drain<0>(pq, acc[NG - 1]);
    else drain<1>(pq, acc[NG - 1]);
  }

  // l of the group's queries: the shares of the warp's lanes g, then of
  // the group's four warps; then every query's through `cols`
  bar_wait(kBarSDone);  // every thread has read the last tile's alpha
#pragma unroll
  for (int j = 0; j < 2 * I2; ++j)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      l_run[j] += __shfl_xor_sync(0xffffffffu, l_run[j], o);
  if (g == 0)
#pragma unroll
    for (int i2 = 0; i2 < I2; ++i2)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        tf32::sts(my_red + 4 * (4 * (8 * i2 + 2 * t + j) + w),
                  __float_as_uint(l_run[2 * i2 + j]));
  group_sync(grp);
  const long bh = (long)b * p.H + h;
#pragma unroll
  for (int i2 = 0; i2 < I2; ++i2)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = grp * HC + 8 * i2 + 2 * t + j;
      const float4 lw = tf32::lds4(my_red + 16 * (8 * i2 + 2 * t + j));
      float l = ((lw.x + lw.y) + lw.z) + lw.w;
      l = fmaxf(l, 1e-30f);
      if (w == 0 && g == 0) {
        tf32::sts(cols + 4 * col, __float_as_uint(l));
        if (q0 + col < S)
          p.lse[bh * S + q0 + col] = m_run[2 * i2 + j] / kLog2e + logf(l);
      }
    }
  bar_wait(kBarXReady);  // every query's l is in
  // O^T's row 16w + g + 8 (e / 2) of m-tile c = 2jj + grp is column 64c +
  // 16w + g + 8 (e / 2) of Dv; its column 8i + 2t + e % 2 is query q0 +
  // that.
#pragma unroll
  for (int i = 0; i < R / 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int s = q0 + 8 * i + 2 * t + j;
      const float inv = 1.f / tf32::lds(cols + 4 * (8 * i + 2 * t + j));
      if (s < S)
#pragma unroll
        for (int jj = 0; jj < NG; ++jj)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            p.out[(((long)b * S + s) * p.H + h) * DV + 64 * (2 * jj + grp) +
                  16 * w + g + 8 * r] = acc[jj][4 * i + 2 * r + j] * inv;
    }
}

template <int DQ, int DV, int R>
int launch(const float* q, const float* k, const float* v, const float* mask,
           float* out, float* lse, int B, int S, int H, const long* qs,
           const long* ks, const long* vs, cudaStream_t stream) {
  CUtensorMap tk, tv;
  int err = make_map(&tk, k, B, S, H, DQ, ks);
  if (err == 0) err = make_map(&tv, v, B, S, H, DV, vs);
  if (err) return err;
  Params p;
  p.q = q;
  for (int i = 0; i < 3; ++i) p.qs[i] = qs[i];
  p.mask = mask;
  p.out = out;
  p.lse = lse;
  p.S = S;
  p.H = H;
  p.scale = 1.f / sqrtf((float)DQ);
  const size_t smem = Layout<DQ, DV, R>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<DQ, DV, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + R - 1) / R, H, B);
  flash_fwd_kernel<DQ, DV, R><<<grid, kThreads, smem, stream>>>(tk, tv, p);
  return (int)cudaGetLastError();
}

// 32-query blocks where 64-query blocks would not cover the card's SMs.
template <int DQ, int DV>
int launch_d(const float* q, const float* k, const float* v,
             const float* mask, float* out, float* lse, int B, int S, int H,
             const long* qs, const long* ks, const long* vs,
             cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if ((long)B * H * ((S + 63) / 64) < sms)
    return launch<DQ, DV, 32>(q, k, v, mask, out, lse, B, S, H, qs, ks, vs,
                              stream);
  return launch<DQ, DV, 64>(q, k, v, mask, out, lse, B, S, H, qs, ks, vs,
                            stream);
}

template <int DQ, int DV, int R>
void layout(long* out) {
  constexpr long kSmSmem = 233472;  // an SM's shared memory, 228 KB
  using L = Layout<DQ, DV, R>;
  const long v[] = {R, kTile, L::kStages, (long)L::kBytes,
                    kSmSmem / ((long)L::kBytes + 1024)};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
}

template <int DQ, int DV>
void layout_d(int rows, long* out) {
  if (rows == 32) layout<DQ, DV, 32>(out);
  else layout<DQ, DV, 64>(out);
}

}  // namespace

// The tiling at head widths (dqk, dv) and rows queries a block (32 or
// 64): out[0..4] = queries a block owns, keys per tile, TMA stages,
// dynamic shared memory in bytes and blocks an SM holds by shared memory
// (each block also reserves 1 KB). Returns cudaErrorInvalidValue for a
// pair other than (128, 128), (256, 256) and (192, 128), or other rows.
extern "C" int avsum_flash_fwd_layout(int dqk, int dv, int rows, long* out) {
  if (rows != 32 && rows != 64) return (int)cudaErrorInvalidValue;
  if (dqk == 128 && dv == 128) layout_d<128, 128>(rows, out);
  else if (dqk == 256 && dv == 256) layout_d<256, 256>(rows, out);
  else if (dqk == 192 && dv == 128) layout_d<192, 128>(rows, out);
  else return (int)cudaErrorInvalidValue;
  return 0;
}

// q, k: float32 [B, S, H, Dqk], v: [B, S, H, Dv], with element strides
// {b, s, h} in q_strides / k_strides / v_strides (multiples of 4, 16-byte
// aligned bases) and unit stride on the head width; mask: float32 [B, S]
// contiguous (> 0 = valid key) or null; out: [B, S, H, Dv] contiguous;
// lse: [B, H, S]. (Dqk, Dv) must be (128, 128), (256, 256) or (192, 128)
// (returns cudaErrorInvalidValue otherwise). Returns 0 or a CUDA error
// code: that of a tensor map the driver refused, of the shared-memory
// opt-in, or cudaGetLastError() after the launch.
extern "C" int avsum_flash_fwd(const void* q, const void* k, const void* v,
                               const void* mask, void* out, void* lse, int B,
                               int S, int H, int Dqk, int Dv,
                               const long* q_strides, const long* k_strides,
                               const long* v_strides, void* stream) {
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const float* mf = (const float*)mask;
  cudaStream_t st = (cudaStream_t)stream;
  if (Dqk == 128 && Dv == 128)
    return launch_d<128, 128>(qf, kf, vf, mf, (float*)out, (float*)lse, B, S,
                              H, q_strides, k_strides, v_strides, st);
  if (Dqk == 256 && Dv == 256)
    return launch_d<256, 256>(qf, kf, vf, mf, (float*)out, (float*)lse, B, S,
                              H, q_strides, k_strides, v_strides, st);
  if (Dqk == 192 && Dv == 128)
    return launch_d<192, 128>(qf, kf, vf, mf, (float*)out, (float*)lse, B, S,
                              H, q_strides, k_strides, v_strides, st);
  return (int)cudaErrorInvalidValue;
}
