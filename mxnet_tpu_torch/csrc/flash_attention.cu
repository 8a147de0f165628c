// FlashAttention-2 forward and backward, f32, for Hopper (sm_90a).
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
// TFLOP/s dense) the least time is 3 x flops / 495 TFLOP/s: K4 0.234 ms, K5
// 0.312 ms (K3 0.156 ms); on the CUDA cores it would be 0.577, 0.769 ms.
//
// K3 (forward): one 128-thread block per (head, 64-row tile); the other
// operand streams through shared memory in 64-row tiles, staged with
// 16-byte coalesced loads into rows padded by 4 floats (so the strided
// per-lane reads below hit distinct banks).  A 64 x 64 score tile is split
// 4 x 8 per thread: lane = 8 * rg + kg of warp w owns tile rows
// 16 w + rg + 4 a (a < 4) and columns kg + 8 b (b < 8), and each row's
// softmax statistics reduce over the 8 lanes of its row group by shuffles.
// A product with a 64-row operand (P V) goes through a per-warp 64 x 64 tile
// in shared memory; each thread accumulates its 4 rows by hd / 8 columns,
// so a row's hd is split over 8 lanes and an hd-128 accumulator is 64
// registers a thread, not 128 (cf. K2, which splits hd over hd / 4 lanes).
// Math is f32 FMA on the CUDA cores; causal blocks skip k tiles wholly
// above the diagonal.
//
// K4 (dq) and K5 (dk, dv), for Hopper:
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
//   rather than wgmma: three of the five products (dS K, P^T dO, dS^T Q)
//   reduce over the row axis of a row-major tile, and TF32 wgmma takes
//   only K-major operands from shared memory.
// - A warp owns 16 rows (m16): the score tiles S, dP (K4) or S^T, dP^T (K5)
//   are its accumulators, P and dS are computed in place, and the
//   accumulator of a 16 x 8 tile is the A operand of the next product as it
//   stands once that product's k axis is permuted (k = t is column 2t,
//   k = t + 4 is column 2t + 1): P and dS never touch shared memory.
// - Staging is an asynchronous two-stage ring: cp.async.cg 16-byte copies,
//   commit/wait groups, zero-fill (source size 0) for rows past Lq or Lk.
//   The streamed operand (K/V in K4; Q, dO, lse and delta in K5) loads
//   its next tile while this one is multiplied.
// - Tiles are padded to a row stride of hd + 4 floats, so the operands of
//   products over hd load by ldmatrix (four 8 x 4 f32 matrices an
//   instruction) and those over tile rows, X[2t][g] (lane = 4g + t), by
//   scalar loads, all without bank conflicts.  Score tiles with every
//   (q, k) pair live skip the mask tests.
// - Occupancy: at hd <= 64 a block is 4 warps and 64 rows, the other
//   operand streams in 64-row tiles, and two blocks (8 warps) share an SM
//   (K4 ~104 KB, K5 ~105 KB of shared memory at hd 64).  At hd 128 a block
//   is 2 warps and 32 rows and the stream 32-row tiles: K5's two hd-wide
//   accumulators take 2 x 64 registers a thread, and the small causal
//   shapes get twice the blocks.
// - Every output row is summed in one block: no atomics, deterministic
//   gradients.  Causal dq blocks skip k tiles wholly above the diagonal and
//   dk/dv blocks q tiles wholly below it (there p is exactly 0).
// No wgmma and no TMA yet.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBlock = 64;     // rows of every tile (q tile and k tile)
constexpr int kThreads = 128;  // 4 warps; warp w owns tile rows 16w .. 16w+15
constexpr int kPStride = 72;   // row stride (floats) of a 64 x 64 P / dS tile
constexpr float kNeg = -1e30f; // the TPU kernels' mask value

template <int HD>
struct Cfg {
  static constexpr int kStride = HD + 4;             // padded row of a staged tile
  static constexpr int kTile = kBlock * kStride;     // floats of a staged tile
  static constexpr int kVec = HD >= 32 ? 4 : 2;      // accumulator vector width
  static constexpr int kVecs = HD / (8 * kVec);      // vectors per row per lane
};

struct Lane {
  int ra;  // first tile row of this thread (16 w + rg); its rows are ra + 4a
  int kg;  // first tile column (kg); its columns are kg + 8b
};

__device__ __forceinline__ Lane lane_of() {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return {16 * w + (lane >> 3), lane & 7};
}

// Stage rows row0 .. row0+63 of a (n_rows, HD) matrix into a padded tile,
// times scale; rows past n_rows are zero.
template <int HD>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src, int row0,
                                      int n_rows, float scale) {
  constexpr int V = HD / 4;
  for (int i = threadIdx.x; i < kBlock * V; i += kThreads) {
    const int r = i / V, c = i - r * V;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) {
      x = __ldg(reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * HD) + c);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * Cfg<HD>::kStride + 4 * c) = x;
  }
}

// s[a][b] = sum_d A[ra + 4a][d] * B[kg + 8b][d] over staged tiles.
template <int HD>
__device__ __forceinline__ void tile_dot(const float* __restrict__ A,
                                         const float* __restrict__ B, Lane ln,
                                         float (&s)[4][8]) {
  constexpr int S = Cfg<HD>::kStride;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) s[a][b] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 av[4], bv[8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      av[a] = *reinterpret_cast<const float4*>(A + (ln.ra + 4 * a) * S + d);
#pragma unroll
    for (int b = 0; b < 8; ++b)
      bv[b] = *reinterpret_cast<const float4*>(B + (ln.kg + 8 * b) * S + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        float t = s[a][b];
        t = fmaf(av[a].x, bv[b].x, t);
        t = fmaf(av[a].y, bv[b].y, t);
        t = fmaf(av[a].z, bv[b].z, t);
        t = fmaf(av[a].w, bv[b].w, t);
        s[a][b] = t;
      }
  }
}

// Column d of this lane's i-th accumulator element (vector c, lane e).
template <int HD>
__device__ __forceinline__ int acc_col(Lane ln, int c, int e) {
  constexpr int W = Cfg<HD>::kVec;
  return ln.kg * W + 8 * W * c + e;
}

// acc[a][c*W + e] += sum_j P[ra + 4a][j] * X[j][acc_col(c, e)], P a 64 x 64
// tile (stride kPStride) and X a staged (64, HD) tile.
template <int HD>
__device__ __forceinline__ void tile_acc(const float* __restrict__ P,
                                         const float* __restrict__ X, Lane ln,
                                         float (&acc)[4][HD / 8]) {
  constexpr int S = Cfg<HD>::kStride, W = Cfg<HD>::kVec, NV = Cfg<HD>::kVecs;
#pragma unroll 4
  for (int j = 0; j < kBlock; ++j) {
    float p[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) p[a] = P[(ln.ra + 4 * a) * kPStride + j];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const float* x = X + j * S + acc_col<HD>(ln, c, 0);
      float xv[W];
      if constexpr (W == 4) {
        const float4 t = *reinterpret_cast<const float4*>(x);
        xv[0] = t.x; xv[1] = t.y; xv[2] = t.z; xv[3] = t.w;
      } else {
        const float2 t = *reinterpret_cast<const float2*>(x);
        xv[0] = t.x; xv[1] = t.y;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < W; ++e)
          acc[a][c * W + e] = fmaf(p[a], xv[e], acc[a][c * W + e]);
    }
  }
}

// Write this lane's rows (row0 + ra + 4a < n_rows) of acc * mul[a] into a
// (n_rows, HD) matrix.
template <int HD>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, int row0,
                                           int n_rows, Lane ln,
                                           const float (&acc)[4][HD / 8],
                                           const float (&mul)[4]) {
  constexpr int W = Cfg<HD>::kVec, NV = Cfg<HD>::kVecs;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = row0 + ln.ra + 4 * a;
    if (r >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      float* o = dst + (size_t)r * HD + acc_col<HD>(ln, c, 0);
      if constexpr (W == 4) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[a][c * W] * mul[a], acc[a][c * W + 1] * mul[a],
                        acc[a][c * W + 2] * mul[a], acc[a][c * W + 3] * mul[a]);
      } else {
        *reinterpret_cast<float2*>(o) =
            make_float2(acc[a][c * W] * mul[a], acc[a][c * W + 1] * mul[a]);
      }
    }
  }
}

__device__ __forceinline__ float row_max8(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum8(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ bool live(int qpos, int kpos, int Lq, int Lk, bool causal) {
  return qpos < Lq && kpos < Lk && (!causal || qpos >= kpos);
}

// ---------------------------------------------------------------------------
// K3: forward.  Block (n, q tile); loops over k tiles with an online softmax.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int Lq, int Lk, int q_tiles, int causal,
              float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + Cfg<HD>::kTile;
  float* Vs = Ks + Cfg<HD>::kTile;
  float* Ps = Vs + Cfg<HD>::kTile;

  const int n = blockIdx.x / q_tiles;
  // heaviest causal tiles (the last q rows) first
  const int q0 = (q_tiles - 1 - blockIdx.x % q_tiles) * kBlock;
  const Lane ln = lane_of();
  const size_t qo = (size_t)n * Lq * HD, ko = (size_t)n * Lk * HD;

  stage<HD>(Qs, q + qo, q0, Lq, sm_scale);  // q * sm_scale before q k^T
  float m[4], l[4], acc[4][HD / 8];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNeg;
    l[a] = 0.f;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) acc[a][i] = 0.f;
  }

  int k_tiles = (Lk + kBlock - 1) / kBlock;
  if (causal) k_tiles = min(k_tiles, (min(q0 + kBlock, Lq) - 1) / kBlock + 1);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // every warp is done with the previous K/V tile
    stage<HD>(Ks, k + ko, k0, Lk, 1.f);
    stage<HD>(Vs, v + ko, k0, Lk, 1.f);
    __syncthreads();

    float s[4][8];
    tile_dot<HD>(Qs, Ks, ln, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + ln.ra + 4 * a;
      float mt = m[a];
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int kpos = k0 + ln.kg + 8 * b;
        // rows past Lq are never written; keep them unmasked like the TPU's
        // zero-padded rows
        if (!(kpos < Lk && (!causal || qpos >= kpos))) s[a][b] = kNeg;
        mt = fmaxf(mt, s[a][b]);
      }
      mt = row_max8(mt);
      const float alpha = expf(m[a] - mt);
      float rs = 0.f;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const float p = expf(s[a][b] - mt);
        rs += p;
        Ps[(ln.ra + 4 * a) * kPStride + ln.kg + 8 * b] = p;
      }
      l[a] = l[a] * alpha + row_sum8(rs);
      m[a] = mt;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) acc[a][i] *= alpha;
    }
    __syncwarp();  // P rows of this warp are written
    tile_acc<HD>(Ps, Vs, ln, acc);
  }

  float inv[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float safe_l = l[a] == 0.f ? 1.f : l[a];
    inv[a] = 1.f / safe_l;
    const int r = q0 + ln.ra + 4 * a;
    if (ln.kg == 0 && r < Lq) lse[(size_t)n * Lq + r] = m[a] + logf(safe_l);
  }
  store_rows<HD>(out + qo, q0, Lq, ln, acc, inv);
}

// ---------------------------------------------------------------------------
// K4 and K5: 3xTF32 products on the tensor cores, fed by a cp.async ring.
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

// Start copying rows row0 .. row0+ROWS-1 of a (n_rows, HD) matrix into a
// tile of row stride HD + 4; rows past n_rows are zero-filled.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void stage_async(float* __restrict__ dst,
                                            const float* __restrict__ src, int row0,
                                            int n_rows) {
  constexpr int V = HD / 4;
  for (int i = threadIdx.x; i < ROWS * V; i += THREADS) {
    const int r = i / V, c = i - r * V;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * Cfg<HD>::kStride + 4 * c,
               ok ? src + (size_t)(row0 + r) * HD + 4 * c : src, ok);
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

// Tile sizes of K4 and K5: kWarps warps of 16 rows each own a block's
// rows; the other operand streams in tiles of kBS rows, two in flight.
template <int HD>
struct Bwd {
  static constexpr int kWarps = HD == 128 ? 2 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;  // q rows (K4) or k rows (K5) of a block
  static constexpr int kBS = HD == 128 ? 32 : 64;
  static constexpr int kRowTile = kRows * Cfg<HD>::kStride;
  static constexpr int kTile = kBS * Cfg<HD>::kStride;
};

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
template <int HD>
__global__ void __launch_bounds__(Bwd<HD>::kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int Lq, int Lk, int q_tiles, int causal,
                 float sm_scale) {
  using B = Bwd<HD>;
  constexpr int NT = B::kBS / 8, DT = HD / 8;
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
  stage_async<HD, B::kRows, B::kThreads>(Qs, q + qo, q0, Lq);
  stage_async<HD, B::kRows, B::kThreads>(dOs, dout + qo, q0, Lq);
  if (k_tiles > 0) {
    stage_async<HD, B::kBS, B::kThreads>(ring, k + ko, 0, Lk);
    stage_async<HD, B::kBS, B::kThreads>(ring + B::kTile, v + ko, 0, Lk);
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
      stage_async<HD, B::kBS, B::kThreads>(nxt, k + ko, (kt + 1) * B::kBS, Lk);
      stage_async<HD, B::kBS, B::kThreads>(nxt + B::kTile, v + ko, (kt + 1) * B::kBS, Lk);
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
        load_b_cols<HD>(kb, Ks, 8 * j, 8 * i, l);
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
      *reinterpret_cast<float2*>(dq + qo + (size_t)r * HD + 8 * i + 2 * l.t) =
          make_float2(acc[i][2 * h] * sm_scale, acc[i][2 * h + 1] * sm_scale);
  }
}

// ---------------------------------------------------------------------------
// K5: dk and dv.  Block (n, kRows k rows); loops over q tiles of kBS rows.
// Warp w owns k rows 16w .. 16w+15: S^T = k (q * scale)^T and dP^T = v do^T,
// P^T and dS^T in place, dv += P^T do, dk += dS^T (q * scale).
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(Bwd<HD>::kThreads)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk,
                  int k_tiles, int causal, float sm_scale) {
  using B = Bwd<HD>;
  constexpr int NT = B::kBS / 8, DT = HD / 8;
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
    stage_async<HD, B::kBS, B::kThreads>(dst, q + qo, qt * B::kBS, Lq);
    stage_async<HD, B::kBS, B::kThreads>(dst + B::kTile, dout + qo, qt * B::kBS, Lq);
    stage_vec_async<B::kBS, B::kThreads>(dst + 2 * B::kTile, lse_n, qt * B::kBS, Lq);
    stage_vec_async<B::kBS, B::kThreads>(dst + 2 * B::kTile + B::kBS, delta_n, qt * B::kBS, Lq);
  };
  stage_async<HD, B::kRows, B::kThreads>(Ks, k + ko, k0, Lk);
  stage_async<HD, B::kRows, B::kThreads>(Vs, v + ko, k0, Lk);
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
        load_b_cols<HD>(ob, dOs, 8 * j, 8 * i, l);
        mma3(dv_acc[i], pa, ob);
        load_b_cols<HD>(qb, Qs, 8 * j, 8 * i, l);
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
    const size_t at = ko + (size_t)r * HD + 2 * l.t;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      *reinterpret_cast<float2*>(dk + at + 8 * i) =
          make_float2(dk_acc[i][2 * h], dk_acc[i][2 * h + 1]);
      *reinterpret_cast<float2*>(dv + at + 8 * i) =
          make_float2(dv_acc[i][2 * h], dv_acc[i][2 * h + 1]);
    }
  }
}

template <int HD>
constexpr size_t fwd_smem() { return (3 * Cfg<HD>::kTile + kBlock * kPStride) * sizeof(float); }
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

template <int HD>
cudaError_t fwd(const float* q, const float* k, const float* v, float* out, float* lse,
                int N, int Lq, int Lk, int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = fwd_smem<HD>();
  cudaError_t err = allow_smem(flash_fwd_f32<HD>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (Lq + kBlock - 1) / kBlock;
  flash_fwd_f32<HD><<<N * tiles, kThreads, smem, stream>>>(q, k, v, out, lse, Lq, Lk, tiles,
                                                            causal, sm_scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t bwd_dq(const float* q, const float* k, const float* v, const float* dout,
                   const float* lse, const float* delta, float* dq, int N, int Lq, int Lk,
                   int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = dq_smem<HD>();
  cudaError_t err = allow_smem(flash_bwd_dq_f32<HD>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (Lq + Bwd<HD>::kRows - 1) / Bwd<HD>::kRows;
  flash_bwd_dq_f32<HD><<<N * tiles, Bwd<HD>::kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, Lq, Lk, tiles, causal, sm_scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t bwd_dkv(const float* q, const float* k, const float* v, const float* dout,
                    const float* lse, const float* delta, float* dk, float* dv, int N, int Lq,
                    int Lk, int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = dkv_smem<HD>();
  cudaError_t err = allow_smem(flash_bwd_dkv_f32<HD>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (Lk + Bwd<HD>::kRows - 1) / Bwd<HD>::kRows;
  flash_bwd_dkv_f32<HD><<<N * tiles, Bwd<HD>::kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Lq, Lk, tiles, causal, sm_scale);
  return cudaGetLastError();
}

bool bad_args(int N, int Lq, int Lk) { return N < 0 || Lq < 0 || Lk < 0; }

}  // namespace

extern "C" {

// The entry points take q, out, dout, dq: (N, Lq, hd); k, v, dk, dv:
// (N, Lk, hd); lse, delta: (N, Lq); all contiguous f32, 16-byte aligned;
// hd in {16, 32, 64, 128}.  Each returns cudaGetLastError() after the launch
// (or the error of the shared-memory opt-in); nothing is launched for an
// empty problem.

int mx_flash_attention_fwd_f32(const float* q, const float* k, const float* v, float* out,
                               float* lse, int N, int Lq, int Lk, int hd, int causal,
                               float sm_scale, cudaStream_t stream) {
  if (bad_args(N, Lq, Lk)) return (int)cudaErrorInvalidValue;
  if (N == 0 || Lq == 0) return (int)cudaSuccess;
  switch (hd) {
    case 16: return (int)fwd<16>(q, k, v, out, lse, N, Lq, Lk, causal, sm_scale, stream);
    case 32: return (int)fwd<32>(q, k, v, out, lse, N, Lq, Lk, causal, sm_scale, stream);
    case 64: return (int)fwd<64>(q, k, v, out, lse, N, Lq, Lk, causal, sm_scale, stream);
    case 128: return (int)fwd<128>(q, k, v, out, lse, N, Lq, Lk, causal, sm_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int mx_flash_attention_dq_f32(const float* q, const float* k, const float* v, const float* dout,
                              const float* lse, const float* delta, float* dq, int N, int Lq,
                              int Lk, int hd, int causal, float sm_scale, cudaStream_t stream) {
  if (bad_args(N, Lq, Lk)) return (int)cudaErrorInvalidValue;
  if (N == 0 || Lq == 0) return (int)cudaSuccess;
  switch (hd) {
    case 16: return (int)bwd_dq<16>(q, k, v, dout, lse, delta, dq, N, Lq, Lk, causal, sm_scale, stream);
    case 32: return (int)bwd_dq<32>(q, k, v, dout, lse, delta, dq, N, Lq, Lk, causal, sm_scale, stream);
    case 64: return (int)bwd_dq<64>(q, k, v, dout, lse, delta, dq, N, Lq, Lk, causal, sm_scale, stream);
    case 128: return (int)bwd_dq<128>(q, k, v, dout, lse, delta, dq, N, Lq, Lk, causal, sm_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int mx_flash_attention_dkv_f32(const float* q, const float* k, const float* v, const float* dout,
                               const float* lse, const float* delta, float* dk, float* dv, int N,
                               int Lq, int Lk, int hd, int causal, float sm_scale,
                               cudaStream_t stream) {
  if (bad_args(N, Lq, Lk)) return (int)cudaErrorInvalidValue;
  if (N == 0 || Lk == 0) return (int)cudaSuccess;
  switch (hd) {
    case 16: return (int)bwd_dkv<16>(q, k, v, dout, lse, delta, dk, dv, N, Lq, Lk, causal, sm_scale, stream);
    case 32: return (int)bwd_dkv<32>(q, k, v, dout, lse, delta, dk, dv, N, Lq, Lk, causal, sm_scale, stream);
    case 64: return (int)bwd_dkv<64>(q, k, v, dout, lse, delta, dk, dv, N, Lq, Lk, causal, sm_scale, stream);
    case 128: return (int)bwd_dkv<128>(q, k, v, dout, lse, delta, dk, dv, N, Lq, Lk, causal, sm_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
