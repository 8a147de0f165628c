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
// Bound on this card: f32 operations.  At the BERT-base training shape
// (N = 384 heads, L = 512, hd = 64) the forward does 4 N L^2 hd = 25.8 GFLOP
// against 100 MB of q/k/v/out: ~250 flops per byte, far above the ~20 f32
// flops per byte at which the card's 67 TFLOP/s outruns its 3.35 TB/s.
// (The tensor cores would move the bound, but TF32 keeps ~3 digits, and the
// kernels must match the f32 reference to 2e-5.)
//
// Design: every kernel is one 128-thread block per (head, 64-row tile); the
// other operand streams through shared memory in 64-row tiles, staged with
// 16-byte coalesced loads into rows padded by 4 floats (so the strided
// per-lane reads below hit distinct banks).  A 64 x 64 score tile is split
// 4 x 8 per thread: lane = 8 * rg + kg of warp w owns tile rows
// 16 w + rg + 4 a (a < 4) and columns kg + 8 b (b < 8), and each row's
// softmax statistics reduce over the 8 lanes of its row group by shuffles.
// A product with a 64-row operand (P V, dS K, P^T dO, dS^T Q) goes through a
// per-warp 64 x 64 tile in shared memory; each thread accumulates its 4 rows
// by hd / 8 columns, so a row's hd is split over 8 lanes and an hd-128
// accumulator is 64 registers a thread, not 128 (cf. K2, which splits hd
// over hd / 4 lanes).  Every partial sum lives in one block, so nothing
// crosses blocks: no atomics, and gradients are deterministic.  Causal
// forward and dq blocks skip k tiles wholly above the diagonal, and dk/dv
// blocks skip q tiles wholly below it (there p is exactly 0).  Math is f32
// FMA on the CUDA cores; no wgmma and no TMA yet.

#include <cuda_runtime.h>
#include <cstddef>

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
// K4: dq.  Block (n, q tile); loops over k tiles.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int Lq, int Lk, int q_tiles, int causal,
                 float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + Cfg<HD>::kTile;
  float* Ks = dOs + Cfg<HD>::kTile;
  float* Vs = Ks + Cfg<HD>::kTile;
  float* dSs = Vs + Cfg<HD>::kTile;

  const int n = blockIdx.x / q_tiles;
  const int q0 = (q_tiles - 1 - blockIdx.x % q_tiles) * kBlock;
  const Lane ln = lane_of();
  const size_t qo = (size_t)n * Lq * HD, ko = (size_t)n * Lk * HD;

  stage<HD>(Qs, q + qo, q0, Lq, sm_scale);
  stage<HD>(dOs, dout + qo, q0, Lq, 1.f);
  float row_lse[4], row_delta[4], acc[4][HD / 8];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = q0 + ln.ra + 4 * a;
    row_lse[a] = r < Lq ? lse[(size_t)n * Lq + r] : 0.f;
    row_delta[a] = r < Lq ? delta[(size_t)n * Lq + r] : 0.f;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) acc[a][i] = 0.f;
  }

  int k_tiles = (Lk + kBlock - 1) / kBlock;
  if (causal) k_tiles = min(k_tiles, (min(q0 + kBlock, Lq) - 1) / kBlock + 1);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();
    stage<HD>(Ks, k + ko, k0, Lk, 1.f);
    stage<HD>(Vs, v + ko, k0, Lk, 1.f);
    __syncthreads();

    float s[4][8], dp[4][8];
    tile_dot<HD>(Qs, Ks, ln, s);
    tile_dot<HD>(dOs, Vs, ln, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + ln.ra + 4 * a;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int kpos = k0 + ln.kg + 8 * b;
        const float p = live(qpos, kpos, Lq, Lk, causal) ? expf(s[a][b] - row_lse[a]) : 0.f;
        dSs[(ln.ra + 4 * a) * kPStride + ln.kg + 8 * b] = p * (dp[a][b] - row_delta[a]);
      }
    }
    __syncwarp();
    tile_acc<HD>(dSs, Ks, ln, acc);
  }
  const float mul[4] = {sm_scale, sm_scale, sm_scale, sm_scale};
  store_rows<HD>(dq + qo, q0, Lq, ln, acc, mul);
}

// ---------------------------------------------------------------------------
// K5: dk and dv.  Block (n, k tile); loops over q tiles.  Tile rows are keys
// here and tile columns queries: s^T = k (q * scale)^T.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk,
                  int k_tiles, int causal, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + Cfg<HD>::kTile;
  float* Qs = Vs + Cfg<HD>::kTile;
  float* dOs = Qs + Cfg<HD>::kTile;
  float* Ps = dOs + Cfg<HD>::kTile;
  float* dSs = Ps + kBlock * kPStride;
  float* lse_s = dSs + kBlock * kPStride;
  float* delta_s = lse_s + kBlock;

  const int n = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * kBlock;  // first k tiles are heaviest
  const Lane ln = lane_of();
  const size_t qo = (size_t)n * Lq * HD, ko = (size_t)n * Lk * HD;

  stage<HD>(Ks, k + ko, k0, Lk, 1.f);
  stage<HD>(Vs, v + ko, k0, Lk, 1.f);
  float dk_acc[4][HD / 8], dv_acc[4][HD / 8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) dk_acc[a][i] = dv_acc[a][i] = 0.f;

  const int q_tiles = (Lq + kBlock - 1) / kBlock;
  for (int qt = causal ? k0 / kBlock : 0; qt < q_tiles; ++qt) {
    const int q0 = qt * kBlock;
    __syncthreads();
    stage<HD>(Qs, q + qo, q0, Lq, sm_scale);
    stage<HD>(dOs, dout + qo, q0, Lq, 1.f);
    if (threadIdx.x < kBlock) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < Lq ? lse[(size_t)n * Lq + r] : 0.f;
      delta_s[threadIdx.x] = r < Lq ? delta[(size_t)n * Lq + r] : 0.f;
    }
    __syncthreads();

    float s[4][8];
    tile_dot<HD>(Ks, Qs, ln, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int kpos = k0 + ln.ra + 4 * a;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int col = ln.kg + 8 * b;
        const float p = live(q0 + col, kpos, Lq, Lk, causal) ? expf(s[a][b] - lse_s[col]) : 0.f;
        Ps[(ln.ra + 4 * a) * kPStride + col] = p;
      }
    }
    float dp[4][8];
    tile_dot<HD>(Vs, dOs, ln, dp);
    __syncwarp();  // P rows of this warp are written
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int col = ln.kg + 8 * b, at = (ln.ra + 4 * a) * kPStride + col;
        dSs[at] = Ps[at] * (dp[a][b] - delta_s[col]);
      }
    __syncwarp();
    tile_acc<HD>(Ps, dOs, ln, dv_acc);
    tile_acc<HD>(dSs, Qs, ln, dk_acc);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<HD>(dk + ko, k0, Lk, ln, dk_acc, one);
  store_rows<HD>(dv + ko, k0, Lk, ln, dv_acc, one);
}

template <int HD>
constexpr size_t fwd_smem() { return (3 * Cfg<HD>::kTile + kBlock * kPStride) * sizeof(float); }
template <int HD>
constexpr size_t dq_smem() { return (4 * Cfg<HD>::kTile + kBlock * kPStride) * sizeof(float); }
template <int HD>
constexpr size_t dkv_smem() {
  return (4 * Cfg<HD>::kTile + 2 * kBlock * kPStride + 2 * kBlock) * sizeof(float);
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
  const int tiles = (Lq + kBlock - 1) / kBlock;
  flash_bwd_dq_f32<HD><<<N * tiles, kThreads, smem, stream>>>(q, k, v, dout, lse, delta, dq,
                                                               Lq, Lk, tiles, causal, sm_scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t bwd_dkv(const float* q, const float* k, const float* v, const float* dout,
                    const float* lse, const float* delta, float* dk, float* dv, int N, int Lq,
                    int Lk, int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = dkv_smem<HD>();
  cudaError_t err = allow_smem(flash_bwd_dkv_f32<HD>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (Lk + kBlock - 1) / kBlock;
  flash_bwd_dkv_f32<HD><<<N * tiles, kThreads, smem, stream>>>(
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
