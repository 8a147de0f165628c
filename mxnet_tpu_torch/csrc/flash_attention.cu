// FlashAttention-2 forward and backward for Hopper (sm_90a): f32, bf16 or
// f16 inputs, head dims 16, 32, 64, 128 and 256, and any multiple of 64
// above 256 (chunked over D, one launch per 64 output columns: see
// flash_fwd_wide).
//
// Replaces the three Pallas kernels of mxnet_tpu/ops/pallas/flash_attention.py:
//   _fwd_kernel (K3): out = softmax(q k^T * scale [masked]) v and the row
//     logsumexp, by an online softmax over k blocks;
//   _dq_kernel  (K4): dq = scale * sum_k p * (do v^T - delta) k;
//   _dkv_kernel (K5): dv = p^T do, dk = (p * (do v^T - delta))^T (q * scale),
// with p = exp(s - lse) recomputed from the saved lse and delta =
// rowsum(do * out) computed outside the kernels.  Keys at kpos >= Lk, and
// above the diagonal (qpos < kpos) when causal, score -1e30 as on the TPU.
// On the TPU one program holds the whole K/V (or Q/dO) of a head in VMEM and
// the grid walks q (or k) blocks in order.
//
// Bound on this card: operations.  At the BERT-base training shape
// (N = 384 heads, L = 512, hd = 64) the forward does 4 N L^2 hd = 25.8 GFLOP
// against 100 MB of q/k/v/out: ~250 flops per byte, far above the ~20 f32
// flops per byte at which even the CUDA cores' 67 TFLOP/s outrun 3.35 TB/s.
// K4 does 6 N L^2 hd = 38.7 GFLOP and K5 8 N L^2 hd = 51.5 GFLOP.  Done as
// 3xTF32 on the tensor cores (three TF32 products per f32 product, 495
// TFLOP/s dense) the least time is 3 x flops / 495 TFLOP/s: K3 0.156 ms, K4
// 0.234 ms, K5 0.312 ms; on the CUDA cores it would be 0.385, 0.577, 0.769 ms.
//
// All three kernels:
// - Products on the tensor cores in 3xTF32: mma.sync m16n8k8 TF32 with f32
//   accumulators.  Each operand is split at fragment load as x = big +
//   small (big = x rounded to TF32 as cvt.rna.tf32.f32 rounds, small =
//   x - big, which the tensor cores truncate to TF32), and small*big +
//   big*small + big*big go into one accumulator; small*small is below
//   f32's last bit.  That keeps f32 accuracy (the pair holds about 22 of
//   f32's 24 significant bits: ~2^-21 relative per product) at a third
//   of the TF32 rate, 2.5x the CUDA cores'.  The split is two integer ops
//   and a subtraction (cvt.rna itself compiles to a longer sequence), and
//   q * scale is formed once per staged tile, in shared memory.  mma.sync
//   rather than wgmma: four of the six products (P V, dS K, P^T dO,
//   dS^T Q) reduce over the row axis of a row-major tile, and TF32 wgmma
//   takes only K-major operands from shared memory.
// - A warp owns 16 rows (m16): the score tiles S (K3), S and dP (K4) or
//   S^T and dP^T (K5) are its accumulators, P and dS are computed in
//   place, and the accumulator of a 16 x 8 tile is the A operand of the
//   next product as it stands once that product's k axis is permuted (k = t
//   is column 2t, k = t + 4 is column 2t + 1): P and dS never touch shared
//   memory.
// - K3's online softmax runs in that accumulator layout: lane 4g + t holds
//   rows g and g + 8, takes their max over its columns and then over the
//   quad's four lanes (two shuffles), rescales its O accumulator by alpha
//   and keeps its own share of each row sum, summed over the quad once, at
//   the end.
// - Staging is an asynchronous two-stage ring: cp.async.cg 16-byte copies,
//   commit/wait groups, zero-fill (source size 0) for rows past Lq or Lk.
//   The streamed operand (K/V in K3 and K4; Q, dO, lse and delta in K5)
//   loads its next tile while this one is multiplied; K3 waits for a tile
//   and refills the other stage behind a single barrier per tile.
// - Tiles are padded to a row stride of hd + 4 floats, so the operands of
//   products over hd load by ldmatrix (four 8 x 4 f32 matrices an
//   instruction) and those over tile rows, X[2t][g] (lane = 4g + t), by
//   scalar loads, all without bank conflicts.  Score tiles with every
//   (q, k) pair live skip the mask tests.
// - Occupancy: at hd <= 64 a block is 4 warps and 64 rows.  K4 and K5
//   stream the other operand in 64-row tiles, and two blocks (8 warps)
//   share an SM (104,448 and 105,472 B of shared memory at hd 64).  K3
//   streams K and V in 32-row tiles (52,224 B at hd 64), keeps each warp's
//   Q fragments split in registers, and three blocks (12 warps) share an
//   SM.  At hd 128 and 256 a block is 2 warps and 32 rows and the stream
//   32-row tiles (K3 84,480 B at hd 128, two blocks an SM): K5's two
//   accumulators
//   take 2 x 64 registers a thread, and the small causal shapes get more
//   blocks (42 for 6 heads of 200 rows, not 24 of 64 rows).
// - Every output row is summed in one block: no atomics, so out, lse and
//   the gradients are bitwise repeatable.  Causal q blocks (K3, K4) skip
//   k tiles wholly above the diagonal, which are never loaded, and dk/dv
//   blocks q tiles wholly below it (there p is exactly 0).
// - bf16 and f16 inputs are converted to f32 on their way into shared
//   memory (8-byte loads of four values, two to four in flight a thread,
//   then f32 stores: cp.async cannot convert), so the f32 tiles, the 3xTF32
//   core and its fragment loaders are the f32 kernels' own; outputs are
//   rounded to the input type once, at the store; lse and delta stay f32.
// - hd 256: the staged tiles are 256 wide (K3 166,400 B of shared memory,
//   K4 199,680 B, K5 200,192 B, within the 227 KB a block may take), but a
//   launch accumulates only a window of 128 output columns (template
//   parameter DW, column offset c0), and the wrapper's call makes two
//   launches, one per window, each recomputing the scores (and in K4, K5
//   dP) over all 256: K5's two accumulators of 256 columns would need 256
//   f32 registers a thread.  The row logsumexp is written by the first.
// - Above 256 the staged rows themselves outgrow shared memory: the scores
//   are reduced over chunks of 64 columns of D, and a launch accumulates 64
//   output columns (flash_fwd_wide, flash_bwd_dq_wide, flash_bwd_dkv_wide).
// No wgmma and no TMA yet.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "dtypes.cuh"

namespace {

constexpr float kNeg = -1e30f; // the TPU kernels' mask value

template <int HD>
struct Cfg {
  static constexpr int kStride = HD + 4;  // padded row of a staged tile
};

__device__ __forceinline__ bool live(int qpos, int kpos, int Lq, int Lk, bool causal) {
  return qpos < Lq && kpos < Lk && (!causal || qpos >= kpos);
}

// ---------------------------------------------------------------------------
// 3xTF32 products on the tensor cores, fed by a cp.async ring.
// ---------------------------------------------------------------------------

// cp.async: 16-byte copies bypassing L1, and 4-byte ones for row vectors;
// a source size of 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows row0 .. row0+ROWS-1 of a (n_rows, HD) matrix of T, whose
// rows lie ld elements apart (HD, or the head dim when src points into a
// chunk of wider rows), into an f32 tile of row stride HD + 4; rows past
// n_rows are zero-filled.  f32
// goes by cp.async; bf16 and f16 (which cp.async cannot convert) by 8-byte
// loads of four values into registers, batched so that several are in
// flight, converted and stored to shared memory.  The tile is complete
// for this thread after cp_wait (f32) or at once (16-bit), and for the
// block after the next barrier either way.
template <typename T, int HD, int ROWS, int THREADS>
__device__ __forceinline__ void stage_async(float* __restrict__ dst,
                                            const T* __restrict__ src, int row0,
                                            int n_rows, int ld = HD) {
  constexpr int V = HD / 4;
  if constexpr (std::is_same<T, float>::value) {
    for (int i = threadIdx.x; i < ROWS * V; i += THREADS) {
      const int r = i / V, c = i - r * V;
      const bool ok = row0 + r < n_rows;
      cp_async16(dst + r * Cfg<HD>::kStride + 4 * c,
                 ok ? src + (size_t)(row0 + r) * ld + 4 * c : src, ok);
    }
  } else {
    // loads in flight a thread: few where the accumulators leave few
    // registers (hd >= 128), more below
    constexpr int kIter = (ROWS * V + THREADS - 1) / THREADS;
    constexpr int kMaxBatch = HD >= 128 ? 2 : 4;
    constexpr int kBatch = kIter < kMaxBatch ? kIter : kMaxBatch;
#pragma unroll
    for (int i0 = 0; i0 < kIter; i0 += kBatch) {
      uint2 u[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = threadIdx.x + (i0 + b) * THREADS, r = i / V, c = i - r * V;
        u[b] = make_uint2(0u, 0u);  // zero bits are zero in bf16 and f16
        if (i < ROWS * V && row0 + r < n_rows)
          u[b] = __ldg(reinterpret_cast<const uint2*>(src + (size_t)(row0 + r) * ld + 4 * c));
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = threadIdx.x + (i0 + b) * THREADS, r = i / V, c = i - r * V;
        if (i < ROWS * V) {
          const T* e = reinterpret_cast<const T*>(&u[b]);
          *reinterpret_cast<float4*>(dst + r * Cfg<HD>::kStride + 4 * c) = make_float4(
              mx::to_f32(e[0]), mx::to_f32(e[1]), mx::to_f32(e[2]), mx::to_f32(e[3]));
        }
      }
    }
  }
}

// Two adjacent outputs of one row, rounded to T.
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    T pair[2] = {mx::from_f32<T>(a), mx::from_f32<T>(b)};
    *reinterpret_cast<uint32_t*>(p) = *reinterpret_cast<const uint32_t*>(pair);
  }
}

// The same for entries row0 .. row0+ROWS-1 of a row vector (lse, delta).
template <int ROWS, int THREADS>
__device__ __forceinline__ void stage_vec_async(float* __restrict__ dst,
                                                const float* __restrict__ src, int row0,
                                                int n_rows) {
  for (int i = threadIdx.x; i < ROWS; i += THREADS) {
    const bool ok = row0 + i < n_rows;
    cp_async4(dst + i, ok ? src + row0 + i : src, ok);
  }
}

// An operand split as x = big + small: big is x rounded to TF32 (10
// mantissa bits, to nearest, ties away from zero: cvt.rna.tf32.f32, done
// on the bits), small = x - big exactly, passed as it is (the tensor cores
// read a TF32 operand's 19 high bits, so small is truncated to TF32).  A
// product is then the three TF32 products small*big + big*small + big*big
// with an f32 accumulator; small*small, below f32's last bit, is dropped.
template <int N>
struct Frag {
  uint32_t big[N], small[N];
};

template <int N>
__device__ __forceinline__ void split(Frag<N>& f, int i, float x) {
  f.big[i] = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;  // finite x
  f.small[i] = __float_as_uint(x - __uint_as_float(f.big[i]));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b, 16 x 8 x 8, in 3xTF32.
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// Four 8 x 4 f32 matrices from shared memory (ldmatrix at 16-bit
// granularity, two halves a word): lane l gives the address of row l % 8 of
// matrix l / 8 and receives word l % 4 of row l / 4 of each.
__device__ __forceinline__ void ldm4(uint32_t (&r)[4], const float* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Fragments of m16n8k8 for lane = 4 g + t.  The accumulator holds rows g and
// g + 8 and columns 2t, 2t + 1 of a 16 x 8 tile (c0, c1 row g; c2, c3 row g + 8).
struct Quad {
  int g, t;
};

__device__ __forceinline__ Quad quad_of() {
  const int lane = threadIdx.x & 31;
  return {lane >> 2, lane & 3};
}

// A (16 x 8) = X[r0 .. r0+15][d0 .. d0+7] from a staged tile, by one
// ldmatrix: a product that reduces over the row (hd) axis.  The 8 rows of
// 16 bytes of each matrix, HD + 4 floats apart, fall in distinct banks.
template <int HD>
__device__ __forceinline__ void load_a(Frag<4>& a, const float* __restrict__ X, int r0,
                                       int d0) {
  constexpr int S = Cfg<HD>::kStride;
  const int lane = threadIdx.x & 31, m = lane >> 3;
  uint32_t r[4];
  ldm4(r, X + (r0 + (lane & 7) + 8 * (m & 1)) * S + d0 + 4 * (m >> 1));
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a, i, __uint_as_float(r[i]));
}

// B (8 x 8) of two column tiles, B_h[k][n] = Y[n0 + 8h + n][d0 + k]: the
// other operand of a product over hd (the rows of Y are the columns of the
// result).
template <int HD>
__device__ __forceinline__ void load_b_rows2(Frag<2> (&b)[2], const float* __restrict__ Y,
                                             int n0, int d0) {
  constexpr int S = Cfg<HD>::kStride;
  const int lane = threadIdx.x & 31, m = lane >> 3;
  uint32_t r[4];
  ldm4(r, Y + (n0 + (lane & 7) + 8 * (m >> 1)) * S + d0 + 4 * (m & 1));
#pragma unroll
  for (int i = 0; i < 4; ++i) split(b[i >> 1], i & 1, __uint_as_float(r[i]));
}

// B (8 x 8), B[k][n] = X[j0 + 2k or 2k - 7][n0 + n]: the operand of a
// product that reduces over the rows of a staged tile (dS K, P^T dO,
// dS^T Q).  The k axis is permuted (k = t is row 2t, k = t + 4 is row
// 2t + 1) so that the A operand is the score accumulator as it stands (see
// a_from_acc); banks (2t (HD + 4) + g) mod 32 are distinct.
template <int HD>
__device__ __forceinline__ void load_b_cols(Frag<2>& b, const float* __restrict__ X, int j0,
                                            int n0, Quad l) {
  constexpr int S = Cfg<HD>::kStride;
  const float* x = X + (j0 + 2 * l.t) * S + n0 + l.g;
  split(b, 0, x[0]);
  split(b, 1, x[S]);
}

// The A operand (rows g, g + 8; k = t, t + 4 as columns 2t, 2t + 1) of a
// 16 x 8 accumulator tile, split: no trip through shared memory.
__device__ __forceinline__ void a_from_acc(Frag<4>& a, const float (&c)[4]) {
  split(a, 0, c[0]);
  split(a, 1, c[2]);
  split(a, 2, c[1]);
  split(a, 3, c[3]);
}

// Multiply by scale, in place, the chunks of a tile that this thread
// copied with stage_async (its own cp.async writes are visible to it after
// the wait; the block's barrier publishes them).
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void scale_own(float* __restrict__ dst, float scale) {
  constexpr int V = HD / 4;
  for (int i = threadIdx.x; i < ROWS * V; i += THREADS) {
    const int r = i / V, c = i - r * V;
    float4* p = reinterpret_cast<float4*>(dst + r * Cfg<HD>::kStride + 4 * c);
    float4 x = *p;
    x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    *p = x;
  }
}

// Tile sizes of a block: kWarps warps of 16 rows each own the block's rows
// (q rows in K3 and K4, k rows in K5); the other operand streams in tiles of
// BS rows, two in flight.
template <int HD, int BS>
struct Tiles {
  static constexpr int kWarps = HD >= 128 ? 2 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kBS = BS;
  static constexpr int kRowTile = kRows * Cfg<HD>::kStride;
  static constexpr int kTile = kBS * Cfg<HD>::kStride;
};
template <int HD>
using Bwd = Tiles<HD, HD >= 128 ? 32 : 64>;  // K4 and K5

// e^x as exp2(x log2 e): a multiply and ex2, where expf adds a longer range
// reduction.  Exactly 1 at x = 0, so a masked row still takes p = 1.
__device__ __forceinline__ float exp_e(float x) { return exp2f(x * 1.4426950408889634f); }

// K3's online softmax over one score tile, in place: s (q rows qpos,
// qpos + 8; key columns kpos + 8j + {0, 1}) becomes p = exp(s - m_new),
// the O accumulator is rescaled by alpha = exp(m - m_new), and row_sum,
// this lane's share of each row's sum, becomes row_sum * alpha + its p.
// A masked score is -1e30, so a row with no live key yet takes p = 1,
// which a later alpha = 0 wipes, as on the TPU.
template <bool kMask, int NT, int DT>
__device__ __forceinline__ void fwd_softmax(float (&s)[NT][4], float (&acc)[DT][4],
                                            float (&m)[2], float (&row_sum)[2], int qpos,
                                            int kpos, int Lq, int Lk, bool causal) {
  float m_new[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      if (kMask && !live(qpos + 8 * h, kpos + 8 * j + (e & 1), Lq, Lk, causal))
        s[j][e] = kNeg;
      m_new[h] = fmaxf(m_new[h], s[j][e]);
    }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the row's max over the quad's four lanes
    m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
    m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
    alpha[h] = exp_e(m[h] - m_new[h]);
    m[h] = m_new[h];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp_e(s[j][e] - m_new[e >> 1]);
      sum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) row_sum[h] = row_sum[h] * alpha[h] + sum[h];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] *= alpha[e >> 1];
}

// ---------------------------------------------------------------------------
// K3: forward.  Block (n, kRows q rows); loops over k tiles of kBS rows with
// an online softmax.  Warp w owns q rows 16w .. 16w+15: S = (q * scale) k^T
// as a 16 x kBS accumulator, P = exp(S - m) in place, O += P v.
// ---------------------------------------------------------------------------
// K3's tiles.  At hd <= 64 a warp keeps its Q tile's split A fragments in
// registers (hd / 8 of them, 8 registers each), and three blocks share an SM.
template <int HD>
struct Fwd : Tiles<HD, 32> {
  static constexpr bool kQRegs = HD <= 64;
  static constexpr int kMinBlocks = HD <= 64 ? 3 : 1;  // per SM, for the register budget
};

template <typename T, int HD, int DW>
__global__ void __launch_bounds__(Fwd<HD>::kThreads, Fwd<HD>::kMinBlocks)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ out, float* __restrict__ lse, int Lq, int Lk, int q_tiles,
          int causal, float sm_scale, int c0) {
  using F = Fwd<HD>;
  constexpr int NT = F::kBS / 8, DQ = HD / 8, DT = DW / 8;
  const int cw = DW == HD ? 0 : c0;  // the window of output columns
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* ring = Qs + F::kRowTile;  // two stages of (K, V)

  const int n = blockIdx.x / q_tiles;
  const int q0 = (q_tiles - 1 - blockIdx.x % q_tiles) * F::kRows;  // heaviest first
  const int r0 = 16 * (threadIdx.x >> 5);
  const Quad l = quad_of();
  const size_t qo = (size_t)n * Lq * HD, ko = (size_t)n * Lk * HD;

  int k_tiles = (Lk + F::kBS - 1) / F::kBS;
  if (causal) k_tiles = min(k_tiles, (min(q0 + F::kRows, Lq) - 1) / F::kBS + 1);
  stage_async<T, HD, F::kRows, F::kThreads>(Qs, q + qo, q0, Lq);
  if (k_tiles > 0) {
    stage_async<T, HD, F::kBS, F::kThreads>(ring, k + ko, 0, Lk);
    stage_async<T, HD, F::kBS, F::kThreads>(ring + F::kTile, v + ko, 0, Lk);
  }
  cp_commit();

  float m[2] = {kNeg, kNeg}, row_sum[2] = {0.f, 0.f}, acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  Frag<4> qf[F::kQRegs ? DQ : 1];

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_wait<0>();  // this thread's copies of tile kt (and at kt 0 of Q) are done
    if (kt == 0) scale_own<HD, F::kRows, F::kThreads>(Qs, sm_scale);  // q * sm_scale before q k^T
    // every copy is visible, and every warp is done with tile kt - 1,
    // whose stage now takes tile kt + 1 while tile kt is multiplied
    __syncthreads();
    if (kt + 1 < k_tiles) {
      float* nxt = ring + ((kt + 1) & 1) * 2 * F::kTile;
      stage_async<T, HD, F::kBS, F::kThreads>(nxt, k + ko, (kt + 1) * F::kBS, Lk);
      stage_async<T, HD, F::kBS, F::kThreads>(nxt + F::kTile, v + ko, (kt + 1) * F::kBS, Lk);
      cp_commit();
    }
    if constexpr (F::kQRegs) {
      if (kt == 0) {
#pragma unroll
        for (int d = 0; d < DQ; ++d) load_a<HD>(qf[d], Qs, r0, 8 * d);
      }
    }
    const float* Ks = ring + (kt & 1) * 2 * F::kTile;
    const float* Vs = Ks + F::kTile;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll (F::kQRegs || HD <= 32 ? DQ : 2)
    for (int d = 0; d < DQ; ++d) {
      Frag<4> qa;
      if constexpr (F::kQRegs)
        qa = qf[d];
      else
        load_a<HD>(qa, Qs, r0, 8 * d);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        Frag<2> kb[2];
        load_b_rows2<HD>(kb, Ks, 8 * j, 8 * d);
        mma3(s[j], qa, kb[0]);
        mma3(s[j + 1], qa, kb[1]);
      }
    }
    const int k0 = kt * F::kBS;
    const bool all_live = k0 + F::kBS <= Lk && q0 + F::kRows <= Lq &&
                          (!causal || k0 + F::kBS - 1 <= q0);
    if (all_live)
      fwd_softmax<false>(s, acc, m, row_sum, q0 + r0 + l.g, k0 + 2 * l.t, Lq, Lk, causal);
    else
      fwd_softmax<true>(s, acc, m, row_sum, q0 + r0 + l.g, k0 + 2 * l.t, Lq, Lk, causal);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      Frag<4> pa;
      a_from_acc(pa, s[j]);
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        Frag<2> vb;
        load_b_cols<HD>(vb, Vs, 8 * j, cw + 8 * i, l);
        mma3(acc[i], pa, vb);
      }
    }
  }
  cp_wait<0>();  // nothing in flight at exit (k_tiles may be 0)

  float safe_l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the row sum over the quad's four lanes
    float sum = row_sum[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    safe_l[h] = sum == 0.f ? 1.f : sum;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r0 + l.g + 8 * h;
    if (r >= Lq) continue;  // rows past Lq are computed from zero q, never written
    if (l.t == 0 && cw == 0) lse[(size_t)n * Lq + r] = m[h] + logf(safe_l[h]);
#pragma unroll
    for (int i = 0; i < DT; ++i)
      store2(out + qo + (size_t)r * HD + cw + 8 * i + 2 * l.t, acc[i][2 * h] / safe_l[h],
             acc[i][2 * h + 1] / safe_l[h]);
  }
}

// p = exp(s - lse) where (qpos, kpos) is live, else exactly 0.  A tile
// with every pair live takes kMask = false and skips the test.
template <bool kMask>
__device__ __forceinline__ float p_of(float s, float row_lse, int qpos, int kpos, int Lq,
                                      int Lk, bool causal) {
  return !kMask || live(qpos, kpos, Lq, Lk, causal) ? expf(s - row_lse) : 0.f;
}

// K4's dS = P (dP - delta) in place of S, for the accumulator entries of
// q rows qpos, qpos + 8 and key columns kpos + 8j + {0, 1}.
template <bool kMask, int NT>
__device__ __forceinline__ void dq_scores(float (&s)[NT][4], const float (&dp)[NT][4],
                                          const float (&row_lse)[2],
                                          const float (&row_delta)[2], int qpos, int kpos,
                                          int Lq, int Lk, bool causal) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float p = p_of<kMask>(s[j][e], row_lse[h], qpos + 8 * h, kpos + 8 * j + (e & 1),
                                  Lq, Lk, causal);
      s[j][e] = p * (dp[j][e] - row_delta[h]);
    }
}

// K5's P^T in place of S^T and dS^T = P^T (dP^T - delta) in place of dP^T,
// for key rows kpos, kpos + 8 and q columns q0 + col, col = 8j + c + {0, 1}.
template <bool kMask, int NT>
__device__ __forceinline__ void dkv_scores(float (&s)[NT][4], float (&dp)[NT][4],
                                           const float* __restrict__ lse_s,
                                           const float* __restrict__ delta_s, int q0, int c,
                                           int kpos, int Lq, int Lk, bool causal) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + c + (e & 1);
      const float p = p_of<kMask>(s[j][e], lse_s[col], q0 + col, kpos + 8 * (e >> 1), Lq, Lk,
                                  causal);
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - delta_s[col]);
    }
}

// ---------------------------------------------------------------------------
// K4: dq.  Block (n, kRows q rows); loops over k tiles of kBS rows.  Warp w
// owns q rows 16w .. 16w+15: S = (q * scale) k^T and dP = do v^T as 16 x kBS
// accumulators, dS = P (dP - delta) in place, dq += dS k.
// ---------------------------------------------------------------------------
template <typename T, int HD, int DW>
__global__ void __launch_bounds__(Bwd<HD>::kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq, int Lq, int Lk, int q_tiles,
             int causal, float sm_scale, int c0) {
  using B = Bwd<HD>;
  constexpr int NT = B::kBS / 8, DT = DW / 8;
  const int cw = DW == HD ? 0 : c0;  // the window of output columns
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + B::kRowTile;
  float* ring = dOs + B::kRowTile;  // two stages of (K, V)

  const int n = blockIdx.x / q_tiles;
  const int q0 = (q_tiles - 1 - blockIdx.x % q_tiles) * B::kRows;  // heaviest first
  const int r0 = 16 * (threadIdx.x >> 5);
  const Quad l = quad_of();
  const size_t qo = (size_t)n * Lq * HD, ko = (size_t)n * Lk * HD;

  int k_tiles = (Lk + B::kBS - 1) / B::kBS;
  if (causal) k_tiles = min(k_tiles, (min(q0 + B::kRows, Lq) - 1) / B::kBS + 1);
  stage_async<T, HD, B::kRows, B::kThreads>(Qs, q + qo, q0, Lq);
  stage_async<T, HD, B::kRows, B::kThreads>(dOs, dout + qo, q0, Lq);
  if (k_tiles > 0) {
    stage_async<T, HD, B::kBS, B::kThreads>(ring, k + ko, 0, Lk);
    stage_async<T, HD, B::kBS, B::kThreads>(ring + B::kTile, v + ko, 0, Lk);
  }
  cp_commit();

  float row_lse[2], row_delta[2], acc[DT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r0 + l.g + 8 * h;
    row_lse[h] = r < Lq ? lse[(size_t)n * Lq + r] : 0.f;
    row_delta[h] = r < Lq ? delta[(size_t)n * Lq + r] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {  // the next K/V tile loads while this one is used
      float* nxt = ring + ((kt + 1) & 1) * 2 * B::kTile;
      stage_async<T, HD, B::kBS, B::kThreads>(nxt, k + ko, (kt + 1) * B::kBS, Lk);
      stage_async<T, HD, B::kBS, B::kThreads>(nxt + B::kTile, v + ko, (kt + 1) * B::kBS, Lk);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    if (kt == 0) scale_own<HD, B::kRows, B::kThreads>(Qs, sm_scale);  // q * sm_scale before q k^T
    __syncthreads();
    const float* Ks = ring + (kt & 1) * 2 * B::kTile;
    const float* Vs = Ks + B::kTile;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll (HD <= 32 ? HD / 8 : 2)
    for (int d0 = 0; d0 < HD; d0 += 8) {
      Frag<4> qa, da;
      load_a<HD>(qa, Qs, r0, d0);
      load_a<HD>(da, dOs, r0, d0);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        Frag<2> kb[2], vb[2];
        load_b_rows2<HD>(kb, Ks, 8 * j, d0);
        mma3(s[j], qa, kb[0]);
        mma3(s[j + 1], qa, kb[1]);
        load_b_rows2<HD>(vb, Vs, 8 * j, d0);
        mma3(dp[j], da, vb[0]);
        mma3(dp[j + 1], da, vb[1]);
      }
    }
    const int k0 = kt * B::kBS;
    const bool all_live = k0 + B::kBS <= Lk && q0 + B::kRows <= Lq &&
                          (!causal || k0 + B::kBS - 1 <= q0);
    if (all_live)
      dq_scores<false>(s, dp, row_lse, row_delta, q0 + r0 + l.g, k0 + 2 * l.t, Lq, Lk, causal);
    else
      dq_scores<true>(s, dp, row_lse, row_delta, q0 + r0 + l.g, k0 + 2 * l.t, Lq, Lk, causal);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      Frag<4> a;
      a_from_acc(a, s[j]);
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        Frag<2> kb;
        load_b_cols<HD>(kb, Ks, 8 * j, cw + 8 * i, l);
        mma3(acc[i], a, kb);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }
  cp_wait<0>();  // nothing in flight at exit (k_tiles may be 0)

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r0 + l.g + 8 * h;
    if (r >= Lq) continue;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      store2(dq + qo + (size_t)r * HD + cw + 8 * i + 2 * l.t, acc[i][2 * h] * sm_scale,
             acc[i][2 * h + 1] * sm_scale);
  }
}

// ---------------------------------------------------------------------------
// K5: dk and dv.  Block (n, kRows k rows); loops over q tiles of kBS rows.
// Warp w owns k rows 16w .. 16w+15: S^T = k (q * scale)^T and dP^T = v do^T,
// P^T and dS^T in place, dv += P^T do, dk += dS^T (q * scale).
// ---------------------------------------------------------------------------
template <typename T, int HD, int DW>
__global__ void __launch_bounds__(Bwd<HD>::kThreads)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Lq,
              int Lk, int k_tiles, int causal, float sm_scale, int c0) {
  using B = Bwd<HD>;
  constexpr int NT = B::kBS / 8, DT = DW / 8;
  const int cw = DW == HD ? 0 : c0;  // the window of output columns
  constexpr int kStage = 2 * B::kTile + 2 * B::kBS;  // Q, dO, lse, delta
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + B::kRowTile;
  float* ring = Vs + B::kRowTile;

  const int n = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * B::kRows;  // first k tiles are heaviest
  const int r0 = 16 * (threadIdx.x >> 5);
  const Quad l = quad_of();
  const size_t qo = (size_t)n * Lq * HD, ko = (size_t)n * Lk * HD;
  const float* lse_n = lse + (size_t)n * Lq;
  const float* delta_n = delta + (size_t)n * Lq;

  const int q_tiles = (Lq + B::kBS - 1) / B::kBS;
  const int qt0 = causal ? k0 / B::kBS : 0;  // q tiles wholly above k0 have p = 0
  auto stage_q = [&](int qt, float* dst) {
    stage_async<T, HD, B::kBS, B::kThreads>(dst, q + qo, qt * B::kBS, Lq);
    stage_async<T, HD, B::kBS, B::kThreads>(dst + B::kTile, dout + qo, qt * B::kBS, Lq);
    stage_vec_async<B::kBS, B::kThreads>(dst + 2 * B::kTile, lse_n, qt * B::kBS, Lq);
    stage_vec_async<B::kBS, B::kThreads>(dst + 2 * B::kTile + B::kBS, delta_n, qt * B::kBS, Lq);
  };
  stage_async<T, HD, B::kRows, B::kThreads>(Ks, k + ko, k0, Lk);
  stage_async<T, HD, B::kRows, B::kThreads>(Vs, v + ko, k0, Lk);
  if (qt0 < q_tiles) stage_q(qt0, ring);
  cp_commit();

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int qt = qt0; qt < q_tiles; ++qt) {
    const int buf = (qt - qt0) & 1;
    if (qt + 1 < q_tiles) {  // the next Q/dO tile loads while this one is used
      stage_q(qt + 1, ring + (buf ^ 1) * kStage);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    float* Qs = ring + buf * kStage;
    scale_own<HD, B::kBS, B::kThreads>(Qs, sm_scale);  // q * sm_scale before k q^T
    __syncthreads();
    const float* dOs = Qs + B::kTile;
    const float* lse_s = dOs + B::kTile;
    const float* delta_s = lse_s + B::kBS;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll (HD <= 32 ? HD / 8 : 2)
    for (int d0 = 0; d0 < HD; d0 += 8) {
      Frag<4> ka, va;
      load_a<HD>(ka, Ks, r0, d0);
      load_a<HD>(va, Vs, r0, d0);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        Frag<2> qb[2], ob[2];
        load_b_rows2<HD>(qb, Qs, 8 * j, d0);
        mma3(s[j], ka, qb[0]);
        mma3(s[j + 1], ka, qb[1]);
        load_b_rows2<HD>(ob, dOs, 8 * j, d0);
        mma3(dp[j], va, ob[0]);
        mma3(dp[j + 1], va, ob[1]);
      }
    }
    const int q0 = qt * B::kBS;
    const bool all_live = q0 + B::kBS <= Lq && k0 + B::kRows <= Lk &&
                          (!causal || k0 + B::kRows - 1 <= q0);
    if (all_live)
      dkv_scores<false>(s, dp, lse_s, delta_s, q0, 2 * l.t, k0 + r0 + l.g, Lq, Lk, causal);
    else
      dkv_scores<true>(s, dp, lse_s, delta_s, q0, 2 * l.t, k0 + r0 + l.g, Lq, Lk, causal);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      Frag<4> pa, da;
      a_from_acc(pa, s[j]);
      a_from_acc(da, dp[j]);
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        Frag<2> ob, qb;
        load_b_cols<HD>(ob, dOs, 8 * j, cw + 8 * i, l);
        mma3(dv_acc[i], pa, ob);
        load_b_cols<HD>(qb, Qs, 8 * j, cw + 8 * i, l);
        mma3(dk_acc[i], da, qb);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }
  cp_wait<0>();  // nothing in flight at exit (no q tile may be live)

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = k0 + r0 + l.g + 8 * h;
    if (r >= Lk) continue;
    const size_t at = ko + (size_t)r * HD + cw + 2 * l.t;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      store2(dk + at + 8 * i, dk_acc[i][2 * h], dk_acc[i][2 * h + 1]);
      store2(dv + at + 8 * i, dv_acc[i][2 * h], dv_acc[i][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Head dims above 256, any multiple of kChunk = 64 (the wrapper zero-pads D
// to one).  A staged tile of such rows no longer fits beside its operands in
// shared memory, so K3, K4 and K5 reduce the scores (and dP) over D in
// chunks of 64 columns, each staged for the q rows and the streamed tile
// behind a barrier, and a launch accumulates one window of 64 output columns
// (c0): the call makes D / 64 launches, each recomputing the scores, as the
// hd-256 windows do.  Blocks are 4 warps of 16 rows; the other operand
// streams in tiles of 32 rows.  The staging is synchronous (copy, wait,
// barrier): a simple design, not yet a fast one.  The fragment loaders,
// the 3xTF32 core and the score functions are the narrow kernels' own.
// ---------------------------------------------------------------------------
constexpr int kChunk = 64;
using Wide = Tiles<kChunk, 32>;

// K3 at D > 256.  Block (n, 64 q rows); per k tile of 32 rows, S over D's
// chunks, the online softmax, then O[:, c0 .. c0+63] += P v[:, c0 .. c0+63].
template <typename T>
__global__ void __launch_bounds__(Wide::kThreads)
flash_fwd_wide(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ out, float* __restrict__ lse, int Lq, int Lk, int D,
               int q_tiles, int causal, float sm_scale, int c0) {
  using W = Wide;
  constexpr int NT = W::kBS / 8, DT = kChunk / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // a chunk of the block's q rows
  float* Ks = Qs + W::kRowTile;   // a chunk of the k tile, then its v window

  const int n = blockIdx.x / q_tiles;
  const int q0 = (q_tiles - 1 - blockIdx.x % q_tiles) * W::kRows;  // heaviest first
  const int r0 = 16 * (threadIdx.x >> 5);
  const Quad l = quad_of();
  const size_t qo = (size_t)n * Lq * D, ko = (size_t)n * Lk * D;

  int k_tiles = (Lk + W::kBS - 1) / W::kBS;
  if (causal) k_tiles = min(k_tiles, (min(q0 + W::kRows, Lq) - 1) / W::kBS + 1);

  float m[2] = {kNeg, kNeg}, row_sum[2] = {0.f, 0.f}, acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * W::kBS;
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kChunk) {
      __syncthreads();  // every warp is done with the staged tiles
      stage_async<T, kChunk, W::kRows, W::kThreads>(Qs, q + qo + d0, q0, Lq, D);
      stage_async<T, kChunk, W::kBS, W::kThreads>(Ks, k + ko + d0, k0, Lk, D);
      cp_commit();
      cp_wait<0>();
      scale_own<kChunk, W::kRows, W::kThreads>(Qs, sm_scale);  // q * sm_scale before q k^T
      __syncthreads();
#pragma unroll 2
      for (int dd = 0; dd < kChunk; dd += 8) {
        Frag<4> qa;
        load_a<kChunk>(qa, Qs, r0, dd);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          Frag<2> kb[2];
          load_b_rows2<kChunk>(kb, Ks, 8 * j, dd);
          mma3(s[j], qa, kb[0]);
          mma3(s[j + 1], qa, kb[1]);
        }
      }
    }
    const bool all_live = k0 + W::kBS <= Lk && q0 + W::kRows <= Lq &&
                          (!causal || k0 + W::kBS - 1 <= q0);
    if (all_live)
      fwd_softmax<false>(s, acc, m, row_sum, q0 + r0 + l.g, k0 + 2 * l.t, Lq, Lk, causal);
    else
      fwd_softmax<true>(s, acc, m, row_sum, q0 + r0 + l.g, k0 + 2 * l.t, Lq, Lk, causal);
    __syncthreads();  // every warp is done with the k chunk
    stage_async<T, kChunk, W::kBS, W::kThreads>(Ks, v + ko + c0, k0, Lk, D);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      Frag<4> pa;
      a_from_acc(pa, s[j]);
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        Frag<2> vb;
        load_b_cols<kChunk>(vb, Ks, 8 * j, 8 * i, l);
        mma3(acc[i], pa, vb);
      }
    }
  }

  float safe_l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the row sum over the quad's four lanes
    float sum = row_sum[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    safe_l[h] = sum == 0.f ? 1.f : sum;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r0 + l.g + 8 * h;
    if (r >= Lq) continue;
    if (l.t == 0 && c0 == 0) lse[(size_t)n * Lq + r] = m[h] + logf(safe_l[h]);
#pragma unroll
    for (int i = 0; i < DT; ++i)
      store2(out + qo + (size_t)r * D + c0 + 8 * i + 2 * l.t, acc[i][2 * h] / safe_l[h],
             acc[i][2 * h + 1] / safe_l[h]);
  }
}

// K4 at D > 256.  Block (n, 64 q rows); per k tile, S and dP over D's
// chunks, dS in place of S, then dq[:, c0 .. c0+63] += dS k[:, c0 .. c0+63].
template <typename T>
__global__ void __launch_bounds__(Wide::kThreads)
flash_bwd_dq_wide(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq, int Lq, int Lk, int D,
                  int q_tiles, int causal, float sm_scale, int c0) {
  using W = Wide;
  constexpr int NT = W::kBS / 8, DT = kChunk / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + W::kRowTile;
  float* Ks = dOs + W::kRowTile;  // a chunk of the k tile, then its window
  float* Vs = Ks + W::kTile;

  const int n = blockIdx.x / q_tiles;
  const int q0 = (q_tiles - 1 - blockIdx.x % q_tiles) * W::kRows;  // heaviest first
  const int r0 = 16 * (threadIdx.x >> 5);
  const Quad l = quad_of();
  const size_t qo = (size_t)n * Lq * D, ko = (size_t)n * Lk * D;

  int k_tiles = (Lk + W::kBS - 1) / W::kBS;
  if (causal) k_tiles = min(k_tiles, (min(q0 + W::kRows, Lq) - 1) / W::kBS + 1);

  float row_lse[2], row_delta[2], acc[DT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r0 + l.g + 8 * h;
    row_lse[h] = r < Lq ? lse[(size_t)n * Lq + r] : 0.f;
    row_delta[h] = r < Lq ? delta[(size_t)n * Lq + r] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * W::kBS;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kChunk) {
      __syncthreads();  // every warp is done with the staged tiles
      stage_async<T, kChunk, W::kRows, W::kThreads>(Qs, q + qo + d0, q0, Lq, D);
      stage_async<T, kChunk, W::kRows, W::kThreads>(dOs, dout + qo + d0, q0, Lq, D);
      stage_async<T, kChunk, W::kBS, W::kThreads>(Ks, k + ko + d0, k0, Lk, D);
      stage_async<T, kChunk, W::kBS, W::kThreads>(Vs, v + ko + d0, k0, Lk, D);
      cp_commit();
      cp_wait<0>();
      scale_own<kChunk, W::kRows, W::kThreads>(Qs, sm_scale);  // q * sm_scale before q k^T
      __syncthreads();
#pragma unroll 2
      for (int dd = 0; dd < kChunk; dd += 8) {
        Frag<4> qa, da;
        load_a<kChunk>(qa, Qs, r0, dd);
        load_a<kChunk>(da, dOs, r0, dd);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          Frag<2> kb[2], vb[2];
          load_b_rows2<kChunk>(kb, Ks, 8 * j, dd);
          mma3(s[j], qa, kb[0]);
          mma3(s[j + 1], qa, kb[1]);
          load_b_rows2<kChunk>(vb, Vs, 8 * j, dd);
          mma3(dp[j], da, vb[0]);
          mma3(dp[j + 1], da, vb[1]);
        }
      }
    }
    const bool all_live = k0 + W::kBS <= Lk && q0 + W::kRows <= Lq &&
                          (!causal || k0 + W::kBS - 1 <= q0);
    if (all_live)
      dq_scores<false>(s, dp, row_lse, row_delta, q0 + r0 + l.g, k0 + 2 * l.t, Lq, Lk, causal);
    else
      dq_scores<true>(s, dp, row_lse, row_delta, q0 + r0 + l.g, k0 + 2 * l.t, Lq, Lk, causal);
    __syncthreads();  // every warp is done with the k chunk
    stage_async<T, kChunk, W::kBS, W::kThreads>(Ks, k + ko + c0, k0, Lk, D);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      Frag<4> a;
      a_from_acc(a, s[j]);
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        Frag<2> kb;
        load_b_cols<kChunk>(kb, Ks, 8 * j, 8 * i, l);
        mma3(acc[i], a, kb);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r0 + l.g + 8 * h;
    if (r >= Lq) continue;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      store2(dq + qo + (size_t)r * D + c0 + 8 * i + 2 * l.t, acc[i][2 * h] * sm_scale,
             acc[i][2 * h + 1] * sm_scale);
  }
}

// K5 at D > 256.  Block (n, 64 k rows); per q tile of 32 rows, S^T and dP^T
// over D's chunks, P^T and dS^T in place, then dv[:, c0 .. c0+63] += P^T
// do[:, window] and dk[:, window] += dS^T (q * scale)[:, window].
template <typename T>
__global__ void __launch_bounds__(Wide::kThreads)
flash_bwd_dkv_wide(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                   int Lq, int Lk, int D, int k_tiles, int causal, float sm_scale, int c0) {
  using W = Wide;
  constexpr int NT = W::kBS / 8, DT = kChunk / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + W::kRowTile;
  float* Qs = Vs + W::kRowTile;  // a chunk of the q tile, then its window
  float* dOs = Qs + W::kTile;
  float* lse_s = dOs + W::kTile;
  float* delta_s = lse_s + W::kBS;

  const int n = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * W::kRows;
  const int r0 = 16 * (threadIdx.x >> 5);
  const Quad l = quad_of();
  const size_t qo = (size_t)n * Lq * D, ko = (size_t)n * Lk * D;
  const int q_tiles = (Lq + W::kBS - 1) / W::kBS;
  const int qt0 = causal ? k0 / W::kBS : 0;  // q tiles wholly above k0 have p = 0

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int qt = qt0; qt < q_tiles; ++qt) {
    const int q0 = qt * W::kBS;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kChunk) {
      __syncthreads();  // every warp is done with the staged tiles
      stage_async<T, kChunk, W::kRows, W::kThreads>(Ks, k + ko + d0, k0, Lk, D);
      stage_async<T, kChunk, W::kRows, W::kThreads>(Vs, v + ko + d0, k0, Lk, D);
      stage_async<T, kChunk, W::kBS, W::kThreads>(Qs, q + qo + d0, q0, Lq, D);
      stage_async<T, kChunk, W::kBS, W::kThreads>(dOs, dout + qo + d0, q0, Lq, D);
      if (d0 == 0) {
        stage_vec_async<W::kBS, W::kThreads>(lse_s, lse + (size_t)n * Lq, q0, Lq);
        stage_vec_async<W::kBS, W::kThreads>(delta_s, delta + (size_t)n * Lq, q0, Lq);
      }
      cp_commit();
      cp_wait<0>();
      scale_own<kChunk, W::kBS, W::kThreads>(Qs, sm_scale);  // q * sm_scale before k q^T
      __syncthreads();
#pragma unroll 2
      for (int dd = 0; dd < kChunk; dd += 8) {
        Frag<4> ka, va;
        load_a<kChunk>(ka, Ks, r0, dd);
        load_a<kChunk>(va, Vs, r0, dd);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          Frag<2> qb[2], ob[2];
          load_b_rows2<kChunk>(qb, Qs, 8 * j, dd);
          mma3(s[j], ka, qb[0]);
          mma3(s[j + 1], ka, qb[1]);
          load_b_rows2<kChunk>(ob, dOs, 8 * j, dd);
          mma3(dp[j], va, ob[0]);
          mma3(dp[j + 1], va, ob[1]);
        }
      }
    }
    const bool all_live = q0 + W::kBS <= Lq && k0 + W::kRows <= Lk &&
                          (!causal || k0 + W::kRows - 1 <= q0);
    if (all_live)
      dkv_scores<false>(s, dp, lse_s, delta_s, q0, 2 * l.t, k0 + r0 + l.g, Lq, Lk, causal);
    else
      dkv_scores<true>(s, dp, lse_s, delta_s, q0, 2 * l.t, k0 + r0 + l.g, Lq, Lk, causal);
    __syncthreads();  // every warp is done with the q chunk
    stage_async<T, kChunk, W::kBS, W::kThreads>(Qs, q + qo + c0, q0, Lq, D);
    stage_async<T, kChunk, W::kBS, W::kThreads>(dOs, dout + qo + c0, q0, Lq, D);
    cp_commit();
    cp_wait<0>();
    scale_own<kChunk, W::kBS, W::kThreads>(Qs, sm_scale);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      Frag<4> pa, da;
      a_from_acc(pa, s[j]);
      a_from_acc(da, dp[j]);
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        Frag<2> ob, qb;
        load_b_cols<kChunk>(ob, dOs, 8 * j, 8 * i, l);
        mma3(dv_acc[i], pa, ob);
        load_b_cols<kChunk>(qb, Qs, 8 * j, 8 * i, l);
        mma3(dk_acc[i], da, qb);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = k0 + r0 + l.g + 8 * h;
    if (r >= Lk) continue;
    const size_t at = ko + (size_t)r * D + c0 + 2 * l.t;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      store2(dk + at + 8 * i, dk_acc[i][2 * h], dk_acc[i][2 * h + 1]);
      store2(dv + at + 8 * i, dv_acc[i][2 * h], dv_acc[i][2 * h + 1]);
    }
  }
}

template <int HD>
constexpr size_t fwd_smem() {
  using F = Fwd<HD>;
  return (F::kRowTile + 4 * F::kTile) * sizeof(float);
}
template <int HD>
constexpr size_t dq_smem() {
  using B = Bwd<HD>;
  return (2 * B::kRowTile + 4 * B::kTile) * sizeof(float);
}
template <int HD>
constexpr size_t dkv_smem() {
  using B = Bwd<HD>;
  return (2 * B::kRowTile + 2 * (2 * B::kTile + 2 * B::kBS)) * sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The columns of the output one launch accumulates: all of them up to
// hd 128; at hd 256 two launches of 128 columns each, each recomputing the
// scores over all 256 (K5's two accumulators of 256 columns would take 256
// registers a thread).
template <int HD>
constexpr int window() {
  return HD > 128 ? 128 : HD;
}

template <typename T, int HD>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out, float* lse, int N,
                int Lq, int Lk, int causal, float sm_scale, cudaStream_t stream) {
  constexpr int DW = window<HD>();
  const size_t smem = fwd_smem<HD>();
  cudaError_t err = allow_smem(flash_fwd<T, HD, DW>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (Lq + Fwd<HD>::kRows - 1) / Fwd<HD>::kRows;
  for (int c0 = 0; c0 < HD; c0 += DW) {
    flash_fwd<T, HD, DW><<<N * tiles, Fwd<HD>::kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), lse, Lq, Lk, tiles, causal, sm_scale, c0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int HD>
cudaError_t fwd_shape(int* rows, int* threads, int* smem, int* per_sm) {
  constexpr int DW = window<HD>();
  *rows = Fwd<HD>::kRows;
  *threads = Fwd<HD>::kThreads;
  *smem = (int)fwd_smem<HD>();
  cudaError_t err = allow_smem(flash_fwd<float, HD, DW>, fwd_smem<HD>());
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, flash_fwd<float, HD, DW>,
                                                       Fwd<HD>::kThreads, fwd_smem<HD>());
}

template <typename T, int HD>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, int N, int Lq, int Lk,
                   int causal, float sm_scale, cudaStream_t stream) {
  constexpr int DW = window<HD>();
  const size_t smem = dq_smem<HD>();
  cudaError_t err = allow_smem(flash_bwd_dq<T, HD, DW>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (Lq + Bwd<HD>::kRows - 1) / Bwd<HD>::kRows;
  for (int c0 = 0; c0 < HD; c0 += DW) {
    flash_bwd_dq<T, HD, DW><<<N * tiles, Bwd<HD>::kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), Lq, Lk, tiles, causal,
        sm_scale, c0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, int HD>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int N, int Lq,
                    int Lk, int causal, float sm_scale, cudaStream_t stream) {
  constexpr int DW = window<HD>();
  const size_t smem = dkv_smem<HD>();
  cudaError_t err = allow_smem(flash_bwd_dkv<T, HD, DW>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (Lk + Bwd<HD>::kRows - 1) / Bwd<HD>::kRows;
  for (int c0 = 0; c0 < HD; c0 += DW) {
    flash_bwd_dkv<T, HD, DW><<<N * tiles, Bwd<HD>::kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Lq,
        Lk, tiles, causal, sm_scale, c0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The launches at D > 256: one per window of kChunk output columns.
constexpr size_t kFwdWideSmem = (Wide::kRowTile + Wide::kTile) * sizeof(float);
constexpr size_t kDqWideSmem = (2 * Wide::kRowTile + 2 * Wide::kTile) * sizeof(float);
constexpr size_t kDkvWideSmem =
    (2 * Wide::kRowTile + 2 * Wide::kTile + 2 * Wide::kBS) * sizeof(float);

template <typename T>
cudaError_t fwd_wide(const void* q, const void* k, const void* v, void* out, float* lse, int N,
                     int Lq, int Lk, int D, int causal, float sm_scale, cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_fwd_wide<T>, kFwdWideSmem);
  if (err != cudaSuccess) return err;
  const int tiles = (Lq + Wide::kRows - 1) / Wide::kRows;
  for (int c0 = 0; c0 < D; c0 += kChunk) {
    flash_fwd_wide<T><<<N * tiles, Wide::kThreads, kFwdWideSmem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), lse, Lq, Lk, D, tiles, causal, sm_scale, c0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t bwd_dq_wide(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dq, int N, int Lq, int Lk,
                        int D, int causal, float sm_scale, cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_bwd_dq_wide<T>, kDqWideSmem);
  if (err != cudaSuccess) return err;
  const int tiles = (Lq + Wide::kRows - 1) / Wide::kRows;
  for (int c0 = 0; c0 < D; c0 += kChunk) {
    flash_bwd_dq_wide<T><<<N * tiles, Wide::kThreads, kDqWideSmem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), Lq, Lk, D, tiles, causal,
        sm_scale, c0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t bwd_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dk, void* dv, int N,
                         int Lq, int Lk, int D, int causal, float sm_scale,
                         cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_bwd_dkv_wide<T>, kDkvWideSmem);
  if (err != cudaSuccess) return err;
  const int tiles = (Lk + Wide::kRows - 1) / Wide::kRows;
  for (int c0 = 0; c0 < D; c0 += kChunk) {
    flash_bwd_dkv_wide<T><<<N * tiles, Wide::kThreads, kDkvWideSmem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Lq,
        Lk, D, tiles, causal, sm_scale, c0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool bad_args(int N, int Lq, int Lk, int dtype) {
  return N < 0 || Lq < 0 || Lk < 0 || mx::bad_dtype(dtype);
}

// Call F<T>::template run<HD>(args...) for the element type of `dtype`
// and the head dim `hd`; above 256, F<T>::wide(args..., hd) if hd is a
// multiple of kChunk; else return cudaErrorInvalidValue.
template <template <typename> class F, typename... Args>
int by_type_hd(int dtype, int hd, Args... args) {
  auto on_hd = [&](auto tag) -> int {
    using T = decltype(tag);
    switch (hd) {
      case 16: return (int)F<T>::template run<16>(args...);
      case 32: return (int)F<T>::template run<32>(args...);
      case 64: return (int)F<T>::template run<64>(args...);
      case 128: return (int)F<T>::template run<128>(args...);
      case 256: return (int)F<T>::template run<256>(args...);
      default:
        if (hd > 256 && hd % kChunk == 0) return (int)F<T>::wide(hd, args...);
        return (int)cudaErrorInvalidValue;
    }
  };
  if (dtype == mx::kBF16) return on_hd(mx::bf16{});
  if (dtype == mx::kF16) return on_hd(mx::f16{});
  return on_hd(float{});
}

template <typename T>
struct Fwd_ {
  template <int HD, typename... A>
  static cudaError_t run(A... a) { return fwd<T, HD>(a...); }
  static cudaError_t wide(int D, const void* q, const void* k, const void* v, void* out,
                          float* lse, int N, int Lq, int Lk, int causal, float sm_scale,
                          cudaStream_t stream) {
    return fwd_wide<T>(q, k, v, out, lse, N, Lq, Lk, D, causal, sm_scale, stream);
  }
};
template <typename T>
struct Dq_ {
  template <int HD, typename... A>
  static cudaError_t run(A... a) { return bwd_dq<T, HD>(a...); }
  static cudaError_t wide(int D, const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dq, int N, int Lq, int Lk,
                          int causal, float sm_scale, cudaStream_t stream) {
    return bwd_dq_wide<T>(q, k, v, dout, lse, delta, dq, N, Lq, Lk, D, causal, sm_scale,
                          stream);
  }
};
template <typename T>
struct Dkv_ {
  template <int HD, typename... A>
  static cudaError_t run(A... a) { return bwd_dkv<T, HD>(a...); }
  static cudaError_t wide(int D, const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dk, void* dv, int N,
                          int Lq, int Lk, int causal, float sm_scale, cudaStream_t stream) {
    return bwd_dkv_wide<T>(q, k, v, dout, lse, delta, dk, dv, N, Lq, Lk, D, causal, sm_scale,
                           stream);
  }
};

}  // namespace

extern "C" {

// The entry points take q, out, dout, dq: (N, Lq, hd); k, v, dk, dv:
// (N, Lk, hd), all contiguous, 16-byte aligned, of one element type
// (dtype 0 f32, 1 bf16, 2 f16); lse, delta: (N, Lq) f32; hd in {16, 32,
// 64, 128, 256} or a multiple of 64 above 256.  Each returns
// cudaGetLastError() after its launches (or the error of the shared-memory
// opt-in); nothing is launched for an empty problem.

int mx_flash_attention_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                           int dtype, int N, int Lq, int Lk, int hd, int causal, float sm_scale,
                           cudaStream_t stream) {
  if (bad_args(N, Lq, Lk, dtype)) return (int)cudaErrorInvalidValue;
  if (N == 0 || Lq == 0) return (int)cudaSuccess;
  return by_type_hd<Fwd_>(dtype, hd, q, k, v, out, lse, N, Lq, Lk, causal, sm_scale, stream);
}

// K3's launch shape at head dim hd (f32): q rows and threads of a block,
// its dynamic shared memory in bytes, and how many such blocks an SM holds.
// A forward over N heads of Lq rows launches N * ceil(Lq / rows) blocks (at
// hd 256 twice, one launch per window of 128 output columns; above 256
// hd / 64 times).
int mx_flash_attention_fwd_shape(int hd, int* rows, int* threads, int* smem_bytes,
                                 int* blocks_per_sm) {
  switch (hd) {
    case 16: return (int)fwd_shape<16>(rows, threads, smem_bytes, blocks_per_sm);
    case 32: return (int)fwd_shape<32>(rows, threads, smem_bytes, blocks_per_sm);
    case 64: return (int)fwd_shape<64>(rows, threads, smem_bytes, blocks_per_sm);
    case 128: return (int)fwd_shape<128>(rows, threads, smem_bytes, blocks_per_sm);
    case 256: return (int)fwd_shape<256>(rows, threads, smem_bytes, blocks_per_sm);
    default:
      if (hd <= 256 || hd % kChunk) return (int)cudaErrorInvalidValue;
      *rows = Wide::kRows;
      *threads = Wide::kThreads;
      *smem_bytes = (int)kFwdWideSmem;
      {
        const cudaError_t err = allow_smem(flash_fwd_wide<float>, kFwdWideSmem);
        if (err != cudaSuccess) return (int)err;
      }
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, flash_fwd_wide<float>, Wide::kThreads, kFwdWideSmem);
  }
}

int mx_flash_attention_dq(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dq, int dtype, int N,
                          int Lq, int Lk, int hd, int causal, float sm_scale,
                          cudaStream_t stream) {
  if (bad_args(N, Lq, Lk, dtype)) return (int)cudaErrorInvalidValue;
  if (N == 0 || Lq == 0) return (int)cudaSuccess;
  return by_type_hd<Dq_>(dtype, hd, q, k, v, dout, lse, delta, dq, N, Lq, Lk, causal, sm_scale,
                         stream);
}

int mx_flash_attention_dkv(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dk, void* dv, int dtype,
                           int N, int Lq, int Lk, int hd, int causal, float sm_scale,
                           cudaStream_t stream) {
  if (bad_args(N, Lq, Lk, dtype)) return (int)cudaErrorInvalidValue;
  if (N == 0 || Lk == 0) return (int)cudaSuccess;
  return by_type_hd<Dkv_>(dtype, hd, q, k, v, dout, lse, delta, dk, dv, N, Lq, Lk, causal,
                          sm_scale, stream);
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
