// Kimi Delta Attention's chunked core (ops/kda.py) on the card: the pass
// over chunks, forward and backward (kda_fwd_kernel, kda_bwd_kernel), and
// the parts parallel over chunks, forward and backward
// (kda_intra_fwd_kernel, kda_intra_bwd_kernel). They replace no TPU
// kernel: the JAX package has no linear attention.
//
// The pass. One launch walks every chunk of every head in order. For a
// head and a block of V_SPLIT columns of its state R [DK, V_SPLIT] (the
// columns of the state evolve apart from each other), chunk by chunk:
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
//
// The chunk-parallel parts (the intra kernels, below the pass) were added
// because as batched torch products they broadcast the sub-blocks' decay
// ratios into [.., 8, 8, 8, DK] tensors (940 MB a call at [1, 7168, 32,
// 128]) and ran three times a step under autograd's recompute. A chunk's
// work is ~3 MFLOP against ~290 KB read and written, so these kernels are
// bound by bytes and by the 64-step substitution, not by FLOPs; their
// design keeps a chunk's q, k, g tiles in shared memory, recomputes in
// the backward everything but the inputs, and gives every (batch, head,
// chunk) a CTA of 8 warps (3,584 CTAs at that shape); their section
// below the pass says how.

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

// ---------------------------------------------------------------------------
// The parts parallel over chunks. One CTA of 8 warps a (batch, head,
// chunk), grid (chunks, heads, batch); the layer's q, k, v, g [B, S, H, .]
// and beta [B, S, H] are read by strides, the rows past S as zeros.
// Within a chunk (ops/kda.py's notation), G_i = g_1 + .. + g_i and
//
//   A_qk[i, j] = sum_c q_i[c] k_j[c] exp(G_i[c] - G_j[c]),   j <= i
//   A_kk[i, j] = sum_c k_i[c] k_j[c] exp(G_i[c] - G_j[c]),   j < i
//   y_i = R_i - sum_{j<i} A_kk[i, j] beta_j y_j,  R = [K exp(G) | V]
//   [W | U'] = beta y,  Q exp(G),  K~ = K exp(g summed after each shot),
//   gamma = exp(G_C).
//
// Each ratio's exponent is g summed over the shots between, all of one
// sign: inside 8-shot sub-blocks pair by pair; between sub-blocks through
// r, the shot before the later sub-block, exp(g over (r, i]) exp(g over
// (j, r]), the second exponent the sum within j's sub-block after j plus
// the whole sub-blocks between (P below). The forward kernel writes the
// six outputs; the backward kernel recomputes A_kk and the substitution
// from the inputs, runs the substitution's transpose
//
//   d_i = dX_i - sum_{j>i} beta_j A_kk[j, i] d_j,   dR = beta d,
//   dbeta_i = d_i . y_i,   dA_kk[i, j] = -beta_i beta_j d_i . y_j,
//
// and gathers the decays' gradients a channel at a time: each pair j < i
// adds to dG_i and takes from dG_j, and two scans over the chunk (dG
// summed from each shot to the end, K~'s exponent's gradient summed
// before it) give dg. float32 FMAs throughout, expf at full precision.
//
// Shared memory holds [C][DK] tiles with rows of DK + 4 floats (a warp's
// 16-byte loads of 32 rows at one column fall in 4 wavefronts), [C][C]
// matrices and the [cols][C] staging of the backward's y and d with rows
// of C + 4. The forward takes 196 KB, the backward 218 KB: one CTA an SM.

namespace intra {

constexpr int SUB = 8;                  // shots a sub-block
constexpr int NB = C / SUB;             // sub-blocks a chunk
constexpr int RS = DK + 4;              // row stride of a [C][DK] tile
constexpr int AS = C + 4;               // row stride of a [.][C] matrix
constexpr int TILE = C * RS;
constexpr int MAT = C * AS;
constexpr int PAIRS = NB * (NB - 1) / 2;  // sub-block pairs jb < ib
constexpr int OFF_COLS = SUB * PAIRS;     // (ib, j) columns, j < SUB ib
constexpr int STAGE = DK * AS;            // [DK][C] staging
constexpr int Q_TILES = (C / 4) * (C / 4 + 1) / 2;  // 4 x 4 tiles, j <= i

// forward: q (then q exp(L)), k, g, k exp(L), T, A_kk, P, beta
constexpr int F_Q = 0, F_K = TILE, F_G = 2 * TILE, F_KL = 3 * TILE,
              F_T = 4 * TILE, F_A = 5 * TILE, F_P = F_A + MAT,
              F_BETA = F_P + PAIRS * DK, F_END = F_BETA + C;
// backward: q, k, g, A_kk (then dA_kk), beta, and a region reused by
// stage: k exp(L), T, P; then A's scaled transpose; then the staging of
// y, d's K columns and d's V columns; then the totals and dA_qk
constexpr int B_Q = 0, B_K = TILE, B_G = 2 * TILE, B_A = 3 * TILE,
              B_BETA = B_A + MAT, B_BIG = B_BETA + C, B_END = B_BIG + 3 * STAGE;
constexpr int S1_KL = 0, S1_T = TILE, S1_P = 2 * TILE;
constexpr int S2_XT = 0, S2_DCK = STAGE, S2_DCV = 2 * STAGE;
constexpr int S3_TOT = 0, S3_DAQ = 2 * STAGE;
static_assert(4 * F_END <= 232448 && 4 * B_END <= 232448, "shared memory");
static_assert(S1_P + PAIRS * DK <= 3 * STAGE && 2 * NB * DK <= STAGE &&
                  MAT <= STAGE, "the backward's reused region");

// Where a CTA's chunk lies: its rows among the [B * S] shots, its index
// among the [B, H, N] chunks of the outputs, and its real shots.
struct Chunk {
  long row0, bhn;
  int rows, h, heads;
  __device__ long at(int t, int width, int col) const {
    return ((row0 + t) * heads + h) * (long)width + col;
  }
};

__device__ __forceinline__ Chunk chunk_of(int seq, int heads) {
  Chunk ch;
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  ch.row0 = (long)b * seq + (long)C * n;
  ch.bhn = ((long)b * heads + h) * gridDim.x + n;
  ch.rows = min(C, seq - C * n);
  ch.h = h;
  ch.heads = heads;
  return ch;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A [C][DK] tile of a [B, S, H, DK] tensor into shared memory by cp.async,
// the rows past S zero-filled.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          const Chunk& ch, int tid) {
  for (int i = tid; i < C * DK / 4; i += THREADS) {
    const int r = i / (DK / 4), q4 = i % (DK / 4);
    const bool ok = r < ch.rows;
    tf32::cp_async16(dst + r * RS + 4 * q4,
                     ok ? src + ch.at(r, DK, 4 * q4) : src, ok ? 16 : 0);
  }
}

// (i, j) of the idx-th pair of a sub-block, rows in order: j <= i
// (incl) or j < i.
__device__ __forceinline__ void pair_at(int idx, bool incl, int& i, int& j) {
  i = incl ? 0 : 1;
  while (idx >= (incl ? i + 1 : i)) {
    idx -= incl ? i + 1 : i;
    ++i;
  }
  j = idx;
}

// Sum each of N values over the warp's 32 lanes; lane L keeps the sums
// of values N/32 L .. N/32 (L + 1) - 1 in v[0 .. N/32 - 1].
template <int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
#pragma unroll
  for (int step = 0; step < 5; ++step) {
    const int off = 16 >> step;
    const int half = (N >> step) / 2;
    const bool upper = lane & off;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = upper ? v[k] : v[k + half];
      const float keep = upper ? v[k + half] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
}

// Warp w: the diagonal sub-block w of A_kk (and of A_qk, QK), its ratios
// pair by pair, the lanes over the channels, then summed over the warp.
// A_kk unscaled into akk; A_qk into the output's chunk aqk.
template <bool QK>
__device__ __forceinline__ void diag_products(const float* qs,
                                              const float* ks,
                                              const float* gs, float* akk,
                                              float* aqk, int warp,
                                              int lane) {
  constexpr int NV = QK ? 64 : 32;  // 36 A_qk and 28 A_kk pairs, or 28
  constexpr int KK0 = QK ? 36 : 0;
  const int r0 = SUB * warp;
  float v[NV];
#pragma unroll
  for (int m = 0; m < NV; ++m) v[m] = 0.f;
#pragma unroll
  for (int e = 0; e < DK / 32; ++e) {
    const int c = lane + 32 * e;
    float qq[SUB], kk[SUB], gg[SUB];
#pragma unroll
    for (int a = 0; a < SUB; ++a) {
      kk[a] = ks[(r0 + a) * RS + c];
      gg[a] = gs[(r0 + a) * RS + c];
      qq[a] = QK ? qs[(r0 + a) * RS + c] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const int own = QK ? j * (j + 1) / 2 + j : 0;
      if (QK) v[own] = fmaf(qq[j], kk[j], v[own]);
      float span = 0.f;
#pragma unroll
      for (int i = j + 1; i < SUB; ++i) {
        span += gg[i];
        const float kr = kk[j] * expf(span);
        const int iq = QK ? i * (i + 1) / 2 + j : 0;
        const int ik = KK0 + i * (i - 1) / 2 + j;
        if (QK) v[iq] = fmaf(qq[i], kr, v[iq]);
        v[ik] = fmaf(kk[i], kr, v[ik]);
      }
    }
  }
  reduce_scatter<NV>(v, lane);
#pragma unroll
  for (int m = 0; m < NV / 32; ++m) {
    const int idx = (NV / 32) * lane + m;
    int i, j;
    if (QK && idx < KK0) {
      pair_at(idx, true, i, j);
      aqk[(r0 + i) * C + r0 + j] = v[m];
    } else if (idx - KK0 < SUB * (SUB - 1) / 2) {
      pair_at(idx - KK0, false, i, j);
      akk[(r0 + i) * AS + r0 + j] = v[m];
    }
  }
}

// Thread c, one channel: k exp(L) (L: g summed in the sub-block up to each
// shot), T (g summed in the sub-block after each shot) and P (g summed
// over the whole sub-blocks strictly between jb and ib); FWD besides
// replaces q by q exp(L) and writes Q exp(G), K~ and gamma.
template <bool FWD>
__device__ __forceinline__ void channel_pass(float* qs, const float* ks,
                                             const float* gs, float* kls,
                                             float* ts, float* ps, int c,
                                             float* qg, float* kt,
                                             float* gamma) {
  float bsum[NB];
  float G = 0.f;
#pragma unroll
  for (int blk = 0; blk < NB; ++blk) {
    float L = 0.f;
#pragma unroll
    for (int a = 0; a < SUB; ++a) {
      const int i = SUB * blk + a;
      const float gi = gs[i * RS + c];
      L += gi;
      const float el = expf(L);
      kls[i * RS + c] = ks[i * RS + c] * el;
      if (FWD) {
        G += gi;
        const float qi = qs[i * RS + c];
        qg[i * DK + c] = qi * expf(G);
        qs[i * RS + c] = qi * el;
      }
    }
    bsum[blk] = L;
  }
  if (FWD) gamma[c] = expf(G);
  float rest = 0.f;
#pragma unroll
  for (int blk = NB - 1; blk >= 0; --blk) {
    float t = 0.f;
#pragma unroll
    for (int a = SUB - 1; a >= 0; --a) {
      const int i = SUB * blk + a;
      const float gi = gs[i * RS + c];
      ts[i * RS + c] = t;
      t += gi;
      if (FWD) {
        kt[i * DK + c] = ks[i * RS + c] * expf(rest);
        rest += gi;
      }
    }
  }
#pragma unroll
  for (int ib = 1; ib < NB; ++ib) {
    float acc = 0.f;
#pragma unroll
    for (int jb = ib - 1; jb >= 0; --jb) {
      ps[(ib * (ib - 1) / 2 + jb) * DK + c] = acc;
      acc += bsum[jb];
    }
  }
}

// Thread t < OFF_COLS: column j of the sub-block row ib > j / SUB of A_kk
// (and A_qk, QK): rows i of sub-block ib against shot j, (q_i or k_i)
// exp(L_i) . k_j exp(T_j + P_{ib, jb}), summed over the channels in order.
template <bool QK>
__device__ __forceinline__ void offdiag_products(const float* qls,
                                                 const float* ks,
                                                 const float* kls,
                                                 const float* ts,
                                                 const float* ps, float* akk,
                                                 float* aqk, int t) {
  int ib = 1;
  while (SUB / 2 * ib * (ib + 1) <= t) ++ib;
  const int j = t - SUB / 2 * ib * (ib - 1);
  const int r0 = SUB * ib;
  const float* pr = ps + (ib * (ib - 1) / 2 + j / SUB) * DK;
  float aq[SUB], ak[SUB];
#pragma unroll
  for (int a = 0; a < SUB; ++a) aq[a] = ak[a] = 0.f;
#pragma unroll 2
  for (int c = 0; c < DK; c += 4) {
    const float4 kj = lds4(ks + j * RS + c), tj = lds4(ts + j * RS + c),
                 p = lds4(pr + c);
    const float w0 = kj.x * expf(tj.x + p.x), w1 = kj.y * expf(tj.y + p.y),
                w2 = kj.z * expf(tj.z + p.z), w3 = kj.w * expf(tj.w + p.w);
#pragma unroll
    for (int a = 0; a < SUB; ++a) {
      const float4 kl = lds4(kls + (r0 + a) * RS + c);
      ak[a] = fmaf(kl.w, w3, fmaf(kl.z, w2, fmaf(kl.y, w1, fmaf(kl.x, w0, ak[a]))));
      if (QK) {
        const float4 ql = lds4(qls + (r0 + a) * RS + c);
        aq[a] = fmaf(ql.w, w3, fmaf(ql.z, w2, fmaf(ql.y, w1, fmaf(ql.x, w0, aq[a]))));
      }
    }
  }
#pragma unroll
  for (int a = 0; a < SUB; ++a) {
    akk[(r0 + a) * AS + j] = ak[a];
    if (QK) aqk[(r0 + a) * C + j] = aq[a];
  }
}

// y_i = y_i - sum_{j<i} ab[i][j] y_j in order (y holds R on entry; ab =
// A_kk diag(beta), strictly lower), one column a thread, in registers.
__device__ __forceinline__ void solve_lower(float (&y)[C], const float* ab) {
#pragma unroll
  for (int i = 1; i < C; ++i) {
    const float* a = ab + i * AS;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int j = 0; j + 4 <= i; j += 4) {
      const float4 t = lds4(a + j);
      s0 = fmaf(t.x, y[j], s0);
      s1 = fmaf(t.y, y[j + 1], s1);
      s2 = fmaf(t.z, y[j + 2], s2);
      s3 = fmaf(t.w, y[j + 3], s3);
    }
#pragma unroll
    for (int j = i & ~3; j < i; ++j) s0 = fmaf(a[j], y[j], s0);
    y[i] -= (s0 + s1) + (s2 + s3);
  }
}

// d_i = d_i - sum_{j>i} abt[i][j] d_j, last row first (d holds dX on
// entry; abt[i][j] = beta_j A_kk[j][i], strictly upper).
__device__ __forceinline__ void solve_upper(float (&d)[C], const float* abt) {
#pragma unroll
  for (int i = C - 2; i >= 0; --i) {
    const float* a = abt + i * AS;
    const int j4 = (i + 4) & ~3;  // the first multiple of 4 past i
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int j = i + 1; j < j4; ++j) s0 = fmaf(a[j], d[j], s0);
#pragma unroll
    for (int j = j4; j < C; j += 4) {
      const float4 t = lds4(a + j);
      s0 = fmaf(t.x, d[j], s0);
      s1 = fmaf(t.y, d[j + 1], s1);
      s2 = fmaf(t.z, d[j + 2], s2);
      s3 = fmaf(t.w, d[j + 3], s3);
    }
    d[i] -= (s0 + s1) + (s2 + s3);
  }
}

// Thread col's right-hand side: k exp(G) (col < DK, G summed in order) or
// v's column col - DK.
__device__ __forceinline__ void rhs_column(float (&y)[C], const float* ks,
                                           const float* gs, const float* v,
                                           const Chunk& ch, int col, int vw) {
  if (col < DK) {
    float G = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      G += gs[i * RS + col];
      y[i] = ks[i * RS + col] * expf(G);
    }
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i)
      y[i] = i < ch.rows ? v[ch.at(i, vw, col - DK)] : 0.f;
  }
}

__device__ __forceinline__ void stage_column(float* dst, const float (&x)[C]) {
#pragma unroll
  for (int m = 0; m < C / 4; ++m)
    *reinterpret_cast<float4*>(dst + 4 * m) =
        make_float4(x[4 * m], x[4 * m + 1], x[4 * m + 2], x[4 * m + 3]);
}

// acc (rows 4 ti .., columns 4 tj ..) += sum over the staged columns of
// d_i y_j: staged [col][C] rows; even and odd columns in two sums (acc
// and acc[.][.] of the second half), each a chain of cols / 2.
__device__ __forceinline__ void accumulate(float (&acc)[2][4][4],
                                           const float* dc, const float* xt,
                                           int cols, int ti, int tj) {
#pragma unroll 2
  for (int col = 0; col < cols; col += 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a = lds4(dc + (col + h) * AS + 4 * ti),
                   b = lds4(xt + (col + h) * AS + 4 * tj);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          acc[h][r][s] = fmaf(av[r], bv[s], acc[h][r][s]);
    }
  }
}

// The backward's gradients of sub-block blk's rows at channel c: dq and
// dk written, dg's part within the sub-block held (dG summed from each
// row to the sub-block's end, K~'s exponent's gradient summed before it)
// and the sub-block's two totals returned, for the scans across.
__device__ __forceinline__ void owner_task(
    int blk, int c, const float* qs, const float* ks, const float* gs,
    const float* daq, const float* dak, const float* dck, const float* bs,
    const Chunk& ch, const float* dqg, const float* dkt, const float* dgam,
    float* dq, float* dk, float (&hold)[SUB], float& tot_g, float& tot_r) {
  const int r0 = SUB * blk;
  float qo[SUB], ko[SUB], go[SUB], L[SUB], T[SUB];
  float run = 0.f;
#pragma unroll
  for (int a = 0; a < SUB; ++a) {
    qo[a] = qs[(r0 + a) * RS + c];
    ko[a] = ks[(r0 + a) * RS + c];
    go[a] = gs[(r0 + a) * RS + c];
    run += go[a];
    L[a] = run;
  }
  run = 0.f;
#pragma unroll
  for (int a = SUB - 1; a >= 0; --a) {
    T[a] = run;
    run += go[a];
  }
  // pq: into q_i; kp: into k_i as the later shot; km: into k_j as the
  // earlier one
  float pq[SUB], kp[SUB], km[SUB];
#pragma unroll
  for (int a = 0; a < SUB; ++a) pq[a] = kp[a] = km[a] = 0.f;
  // the sub-block's own pairs j < i, pairwise
#pragma unroll
  for (int j = 0; j < SUB; ++j) {
    float span = 0.f;
#pragma unroll
    for (int i = j + 1; i < SUB; ++i) {
      span += go[i];
      const float r = expf(span);
      const float aq = daq[(r0 + i) * AS + r0 + j];
      const float ak = dak[(r0 + i) * AS + r0 + j];
      const float kr = ko[j] * r;
      pq[i] = fmaf(aq, kr, pq[i]);
      kp[i] = fmaf(ak, kr, kp[i]);
      km[j] = fmaf(aq, qo[i] * r, km[j]);
      km[j] = fmaf(ak, ko[i] * r, km[j]);
    }
  }
  // the earlier sub-blocks' shots j against this sub-block's rows i:
  // exp(g over (r, i]) exp(g over (j, r]), r = r0 - 1
  float before = 0.f;  // g summed over the whole sub-blocks jb + 1 .. blk - 1
  if (blk > 0) {
    float s1[SUB], s2[SUB];
#pragma unroll
    for (int a = 0; a < SUB; ++a) s1[a] = s2[a] = 0.f;
    for (int jb = blk - 1; jb >= 0; --jb) {
      float tj = 0.f;
#pragma unroll
      for (int b = SUB - 1; b >= 0; --b) {
        const int j = SUB * jb + b;
        const float w = ks[j * RS + c] * expf(tj + before);
#pragma unroll
        for (int a = 0; a < SUB; ++a) {
          s1[a] = fmaf(daq[(r0 + a) * AS + j], w, s1[a]);
          s2[a] = fmaf(dak[(r0 + a) * AS + j], w, s2[a]);
        }
        tj += gs[j * RS + c];
      }
      before += tj;
    }
#pragma unroll
    for (int a = 0; a < SUB; ++a) {
      const float el = expf(L[a]);
      pq[a] = fmaf(el, s1[a], pq[a]);
      kp[a] = fmaf(el, s2[a], kp[a]);
    }
  }
  // this sub-block's shots j against the later sub-blocks' rows i
  float after = 0.f;  // g summed over the whole sub-blocks blk + 1 .. ib - 1
  for (int ib = blk + 1; ib < NB; ++ib) {
    float s[SUB];
#pragma unroll
    for (int a = 0; a < SUB; ++a) s[a] = 0.f;
    float li = 0.f;
#pragma unroll
    for (int b = 0; b < SUB; ++b) {
      const int i = SUB * ib + b;
      li += gs[i * RS + c];
      const float e = expf(li);
      const float ql = qs[i * RS + c] * e, kl = ks[i * RS + c] * e;
      const float4 q0 = lds4(daq + i * AS + r0), q1 = lds4(daq + i * AS + r0 + 4);
      const float4 k0 = lds4(dak + i * AS + r0), k1 = lds4(dak + i * AS + r0 + 4);
      const float aq[SUB] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      const float ak[SUB] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int a = 0; a < SUB; ++a) s[a] = fmaf(aq[a], ql, fmaf(ak[a], kl, s[a]));
    }
#pragma unroll
    for (int a = 0; a < SUB; ++a) km[a] = fmaf(expf(T[a] + after), s[a], km[a]);
    after += li;
  }
  // the rows' gradients
  float dG[SUB], dR[SUB];
#pragma unroll
  for (int a = 0; a < SUB; ++a) {
    const int i = r0 + a;
    const float eg = expf(before + L[a]), er = expf(T[a] + after);
    const float gq = dqg[i * DK + c], gt = dkt[i * DK + c];
    const float gk = bs[i] * dck[c * AS + i];
    const float own = daq[i * AS + i];  // A_qk's diagonal: no decay
    dG[a] = (gq * qo[a] + gk * ko[a]) * eg + qo[a] * pq[a] +
            ko[a] * (kp[a] - km[a]);
    if (i == C - 1) dG[a] = fmaf(dgam[c], eg, dG[a]);
    dR[a] = gt * ko[a] * er;
    if (i < ch.rows) {
      dq[ch.at(i, DK, c)] = gq * eg + pq[a] + own * ko[a];
      dk[ch.at(i, DK, c)] = gk * eg + gt * er + kp[a] + km[a] + own * qo[a];
    }
  }
  float suf = 0.f;
#pragma unroll
  for (int a = SUB - 1; a >= 0; --a) {
    suf += dG[a];
    hold[a] = suf;
  }
  float pre = 0.f;
#pragma unroll
  for (int a = 0; a < SUB; ++a) {
    hold[a] += pre;
    pre += dR[a];
  }
  tot_g = suf;
  tot_r = pre;
}

}  // namespace intra

__global__ void __launch_bounds__(THREADS, 1) kda_intra_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ beta, float* __restrict__ qg,
    float* __restrict__ a_qk, float* __restrict__ w, float* __restrict__ u0,
    float* __restrict__ kt, float* __restrict__ gamma, int seq, int heads,
    int vw) {
  using namespace intra;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + F_Q;
  float* ks = smem + F_K;
  float* gs = smem + F_G;
  float* kls = smem + F_KL;
  float* ts = smem + F_T;
  float* akk = smem + F_A;
  float* ps = smem + F_P;
  float* bs = smem + F_BETA;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Chunk ch = chunk_of(seq, heads);
  load_rows(qs, q, ch, tid);
  load_rows(ks, k, ch, tid);
  load_rows(gs, g, ch, tid);
  tf32::cp_async_commit();
  if (tid < C) bs[tid] = tid < ch.rows ? beta[ch.at(tid, 1, 0)] : 0.f;
  float* aqk = a_qk + ch.bhn * (C * C);
  tf32::cp_async_wait<0>();
  __syncthreads();

  diag_products<true>(qs, ks, gs, akk, aqk, warp, lane);
  __syncthreads();  // the diagonal has read q before the pass scales it
  if (tid < DK) {
    channel_pass<true>(qs, ks, gs, kls, ts, ps, tid, qg + ch.bhn * (C * DK),
                       kt + ch.bhn * (C * DK), gamma + ch.bhn * DK);
  } else {
    for (int e = tid - DK; e < C * C; e += THREADS - DK)
      if (e % C > e / C) aqk[e] = 0.f;
  }
  __syncthreads();
  if (tid < OFF_COLS) offdiag_products<true>(qs, ks, kls, ts, ps, akk, aqk, tid);
  __syncthreads();
  for (int e = tid; e < C * C; e += THREADS) {
    const int i = e / C, j = e % C;
    if (j < i) akk[i * AS + j] *= bs[j];
  }
  __syncthreads();

  if (tid < DK + vw) {
    float y[C];
    rhs_column(y, ks, gs, v, ch, tid, vw);
    solve_lower(y, akk);
    float* out = tid < DK ? w + ch.bhn * (C * DK) + tid
                          : u0 + ch.bhn * ((long)C * vw) + (tid - DK);
    const int stride = tid < DK ? DK : vw;
#pragma unroll
    for (int i = 0; i < C; ++i) out[i * stride] = bs[i] * y[i];
  }
}

__global__ void __launch_bounds__(THREADS, 1) kda_intra_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ beta, const float* __restrict__ d_qg,
    const float* __restrict__ d_aqk, const float* __restrict__ d_w,
    const float* __restrict__ d_u0, const float* __restrict__ d_kt,
    const float* __restrict__ d_gamma, float* __restrict__ dq,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dg,
    float* __restrict__ dbeta, int seq, int heads, int vw) {
  using namespace intra;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + B_Q;
  float* ks = smem + B_K;
  float* gs = smem + B_G;
  float* akk = smem + B_A;
  float* bs = smem + B_BETA;
  float* big = smem + B_BIG;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Chunk ch = chunk_of(seq, heads);
  load_rows(qs, q, ch, tid);
  load_rows(ks, k, ch, tid);
  load_rows(gs, g, ch, tid);
  tf32::cp_async_commit();
  if (tid < C) bs[tid] = tid < ch.rows ? beta[ch.at(tid, 1, 0)] : 0.f;
  tf32::cp_async_wait<0>();
  __syncthreads();

  // stage 1: A_kk, unscaled
  diag_products<false>(qs, ks, gs, akk, nullptr, warp, lane);
  if (tid < DK)
    channel_pass<false>(nullptr, ks, gs, big + S1_KL, big + S1_T, big + S1_P,
                        tid, nullptr, nullptr, nullptr);
  __syncthreads();
  if (tid < OFF_COLS)
    offdiag_products<false>(nullptr, ks, big + S1_KL, big + S1_T, big + S1_P,
                            akk, nullptr, tid);
  __syncthreads();
  // A_kk diag(beta) in place for the substitution, beta_j A_kk[j][i] at
  // [i][j] for its transpose
  float* abt = big;
  for (int e = tid; e < C * C; e += THREADS) {
    const int i = e / C, j = e % C;
    if (j < i) {
      const float a = akk[i * AS + j];
      akk[i * AS + j] = a * bs[j];
      abt[j * AS + i] = a * bs[i];
    }
  }
  __syncthreads();

  // stage 2: the substitution and its transpose, one column a thread
  const int cv = tid - DK;
  float y[C], d[C];
  if (tid < DK + vw) {
    rhs_column(y, ks, gs, v, ch, tid, vw);
    solve_lower(y, akk);
    const float* dx = tid < DK ? d_w + ch.bhn * (C * DK) + tid
                               : d_u0 + ch.bhn * ((long)C * vw) + cv;
    const int stride = tid < DK ? DK : vw;
#pragma unroll
    for (int i = 0; i < C; ++i) d[i] = dx[i * stride];
    solve_upper(d, abt);
    if (tid >= DK)
#pragma unroll
      for (int i = 0; i < C; ++i)
        if (i < ch.rows) dv[ch.at(i, vw, cv)] = bs[i] * d[i];
  }
  __syncthreads();  // the transpose is read; its room takes the staging
  float* xt = big + S2_XT;
  float* dck = big + S2_DCK;
  float* dcv = big + S2_DCV;
  int ti = 0, tj = 0;
  float acc[2][4][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[h][r][s] = 0.f;
  if (tid < Q_TILES) {
    int idx = tid;
    while (idx > ti) {
      idx -= ti + 1;
      ++ti;
    }
    tj = idx;
  }
  // sum over the columns of d_i y_j (j <= i), the V columns first
  if (tid >= DK && tid < DK + vw) {
    stage_column(xt + cv * AS, y);
    stage_column(dcv + cv * AS, d);
  }
  __syncthreads();
  if (tid < Q_TILES) accumulate(acc, dcv, xt, vw, ti, tj);
  __syncthreads();
  float* daq = big + S3_DAQ;  // dA_qk lands where d's V columns were
  const float* daq_src = d_aqk + ch.bhn * (C * C);
  for (int i = tid; i < C * C / 4; i += THREADS) {
    const int r = i / (C / 4), q4 = i % (C / 4);
    tf32::cp_async16(daq + r * AS + 4 * q4, daq_src + r * C + 4 * q4);
  }
  tf32::cp_async_commit();
  if (tid < DK) {
    stage_column(xt + tid * AS, y);
    stage_column(dck + tid * AS, d);
  }
  __syncthreads();
  if (tid < Q_TILES) {
    accumulate(acc, dck, xt, DK, ti, tj);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int i = 4 * ti + r, j = 4 * tj + s;
        const float dy = acc[0][r][s] + acc[1][r][s];
        if (j < i) akk[i * AS + j] = -bs[i] * bs[j] * dy;
        if (j == i && i < ch.rows) dbeta[ch.at(i, 1, 0)] = dy;
      }
  }
  tf32::cp_async_wait<0>();
  __syncthreads();

  // stage 3: the decays' gradients, sub-blocks half, half + 2, .. of
  // channel c a thread
  float* tot = big + S3_TOT;  // [2][NB][DK]: dG's and K~ exponent's totals
  const int c = tid % DK, half = tid / DK;
  const float* dqg_c = d_qg + ch.bhn * (C * DK);
  const float* dkt_c = d_kt + ch.bhn * (C * DK);
  const float* dgam_c = d_gamma + ch.bhn * DK;
  float hold[NB / 2][SUB];
#pragma unroll
  for (int m = 0; m < NB / 2; ++m) {
    const int blk = half + 2 * m;
    float tg, tr;
    owner_task(blk, c, qs, ks, gs, daq, akk, dck, bs, ch, dqg_c, dkt_c,
               dgam_c, dq, dk, hold[m], tg, tr);
    tot[blk * DK + c] = tg;
    tot[(NB + blk) * DK + c] = tr;
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < NB / 2; ++m) {
    const int blk = half + 2 * m;
    float across = 0.f;
    for (int b = blk + 1; b < NB; ++b) across += tot[b * DK + c];
    for (int b = 0; b < blk; ++b) across += tot[(NB + b) * DK + c];
#pragma unroll
    for (int a = 0; a < SUB; ++a) {
      const int i = SUB * blk + a;
      if (i < ch.rows) dg[ch.at(i, DK, c)] = hold[m][a] + across;
    }
  }
}

}  // namespace

extern "C" {

// (C, DK, VS, SUB), for the wrapper to check against its own.
void avsum_kda_layout(long* out) {
  out[0] = C;
  out[1] = DK;
  out[2] = VS;
  out[3] = intra::SUB;
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

// The chunk-parallel parts' forward: q, k, g [batch, seq, heads, DK], v
// [batch, seq, heads, vw], beta [batch, seq, heads], contiguous float32,
// 16-byte aligned -> qg, w, kt [batch, heads, n, C, DK], a_qk [.., C, C],
// u0 [.., C, vw], gamma [.., DK], n = ceil(seq / C); vw a multiple of VS
// up to DK. Returns the launch's CUDA error.
int avsum_kda_intra_fwd(const float* q, const float* k, const float* v,
                        const float* g, const float* beta, float* qg,
                        float* a_qk, float* w, float* u0, float* kt,
                        float* gamma, int batch, int seq, int heads, int vw,
                        cudaStream_t stream) {
  if (vw % VS || vw < VS || vw > DK || seq < 1 || batch < 1 || heads < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((seq + C - 1) / C, heads, batch);
  const int bytes = 4 * intra::F_END;
  cudaError_t e = cudaFuncSetAttribute(
      kda_intra_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  kda_intra_fwd_kernel<<<grid, THREADS, bytes, stream>>>(
      q, k, v, g, beta, qg, a_qk, w, u0, kt, gamma, seq, heads, vw);
  return (int)cudaGetLastError();
}

// Its backward: the forward's inputs and the gradients of its six outputs
// (each in its output's layout) -> dq, dk, dv, dg, dbeta in the inputs'
// layouts. Returns the launch's CUDA error.
int avsum_kda_intra_bwd(const float* q, const float* k, const float* v,
                        const float* g, const float* beta, const float* d_qg,
                        const float* d_aqk, const float* d_w,
                        const float* d_u0, const float* d_kt,
                        const float* d_gamma, float* dq, float* dk, float* dv,
                        float* dg, float* dbeta, int batch, int seq,
                        int heads, int vw, cudaStream_t stream) {
  if (vw % VS || vw < VS || vw > DK || seq < 1 || batch < 1 || heads < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((seq + C - 1) / C, heads, batch);
  const int bytes = 4 * intra::B_END;
  cudaError_t e = cudaFuncSetAttribute(
      kda_intra_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  kda_intra_bwd_kernel<<<grid, THREADS, bytes, stream>>>(
      q, k, v, g, beta, d_qg, d_aqk, d_w, d_u0, d_kt, d_gamma, dq, dk, dv, dg,
      dbeta, seq, heads, vw);
  return (int)cudaGetLastError();
}

}  // extern "C"
