// Row LayerNorm over the last axis for Hopper (sm_90a): x in f32, bf16 or
// f16, any C.
//
// Replaces: mxnet_tpu/ops/pallas/fused.py::_ln_kernel (reached through
// fused.layer_norm), the TPU kernel behind every nn.LayerNorm of the
// Transformer: 256-row blocks resident in VMEM, x read in its own type, f32
// mean and rstd by the two-pass formula var = mean((x - mu)^2), affine,
// out in x's type, and mu/rstd (f32) written beside it for the backward.
//
// Bound on this card: memory bandwidth.  Per row the kernel reads C values
// of x and writes C of out (gamma/beta stay in L1/L2), about
// 2 * N * C * sizeof(x) bytes at 3.35 TB/s, against ~8 flops per element.
// At a decode step's 8 rows the bytes take nanoseconds, and what counts is
// the rounds of dependent loads before the first store.
//
// Design, by the shape of the row:
// - Aligned rows (C a multiple of a 16-byte vector, every operand 16-byte
//   aligned) with C <= 4096, the decode, prefill and training shapes: one
//   warp per row.  Each lane loads its share of the row ONCE into registers
//   with 16-byte loads (4 f32 or 8 bf16/f16 values, converted to f32), so
//   both passes and the affine write run from registers.  Where the row is
//   short enough (NV * VE <= 32 values a lane) the lane loads its gamma and
//   beta in the same round as x, so the write waits for one round trip to
//   memory, not two (K6 does so only at few rows: beside its two rows of
//   loads those registers cost occupancy at many).  Mean and variance are warp-shuffle reductions; no
//   shared memory, no block barrier.  Blocks hold one row when the rows
//   are few (decode, prefill: one warp on each of as many SMs as rows) and
//   four otherwise.
// - Short rows that are not aligned (C <= 256): the same warp per row with
//   scalar loads.
// - Everything else (C > 4096, or unaligned C > 256): one 256-thread block
//   per row.  Pass 1 sums the row and stages it in shared memory as f32 (up
//   to 12,288 values, 48 KB); passes 2 and 3 (variance, affine write) read
//   it from there.  A longer row is read again from device memory (L2)
//   in each pass.  16-byte loads where the row is aligned, scalar ones
//   where it is not.
// Every path keeps the TPU kernel's formula: two passes, the mean first.
//
// K6, the fused residual add + LayerNorm in the same file, replaces
// mxnet_tpu/ops/pallas/fused.py::_aln_kernel (reached through
// fused.add_layer_norm, which the fused_kernels pass substitutes for the
// _contrib_add_layer_norm op): LN(x + res) with the sum formed in VMEM and
// never written.  Here the same: each load of x is joined by the load of
// res at the same place, the two are added in f32, and K1's passes run on
// the sum, so the kernel reads two rows and writes one, and the sum never
// reaches device memory.  res may have its own float type; a res of
// another type than x takes the block path with scalar loads.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "dtypes.cuh"

namespace {

constexpr int kBlockThreads = 256;           // the block-per-row path
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kStageFloats = 12 * 1024;       // a staged row, 48 KB

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// VE values of T from p as f32: one 16-byte load, or one scalar.
template <typename T, int VE>
__device__ __forceinline__ void load_vals(const T* p, float* f) {
  if constexpr (VE == 1)
    f[0] = mx::to_f32(p[0]);
  else
    mx::ldg16(p, f);
}

template <typename T, int VE>
__device__ __forceinline__ void store_vals(T* p, const float* f) {
  if constexpr (VE == 1)
    p[0] = mx::from_f32<T>(f[0]);
  else
    mx::store16(p, f);
}

// VE f32 values of gamma or beta (16-byte aligned where VE > 1).
template <int VE>
__device__ __forceinline__ void load_f32(const float* p, float* f) {
  if constexpr (VE == 1) {
    f[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < VE; i += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
      f[i] = v.x; f[i + 1] = v.y; f[i + 2] = v.z; f[i + 3] = v.w;
    }
  }
}

// One warp normalises one row of x (+ res when RES) from registers.  Lane l
// holds values [VE (l + 32 i), VE (l + 32 i) + VE) for i < NV.  EARLY:
// gamma and beta are loaded with x where the row allows (NV * VE <= 32).
template <typename T, int VE, int NV, bool RES, bool EARLY>
__device__ __forceinline__ void row_warp(const T* __restrict__ x, const T* __restrict__ res,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ beta, T* __restrict__ out,
                                         float* __restrict__ mu_out,
                                         float* __restrict__ rstd_out, int n_rows, int C,
                                         float eps) {
  constexpr bool kEarlyAffine = EARLY && NV * VE <= 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int CV = C / VE;
  const T* xr = x + (size_t)row * C;
  const T* rr = RES ? res + (size_t)row * C : nullptr;

  float v[NV][VE];
  float gv[kEarlyAffine ? NV : 1][VE], bv[kEarlyAffine ? NV : 1][VE];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = lane + 32 * i;
    if (j < CV) {
      load_vals<T, VE>(xr + (size_t)j * VE, v[i]);
      if constexpr (RES) {
        float r[VE];
        load_vals<T, VE>(rr + (size_t)j * VE, r);
#pragma unroll
        for (int e = 0; e < VE; ++e) v[i][e] += r[e];
      }
      if constexpr (kEarlyAffine) {
        load_f32<VE>(gamma + j * VE, gv[i]);
        load_f32<VE>(beta + j * VE, bv[i]);
      }
#pragma unroll
      for (int e = 0; e < VE; ++e) s += v[i][e];
    } else {
#pragma unroll
      for (int e = 0; e < VE; ++e) v[i][e] = 0.f;
    }
  }
  const float mu = warp_sum(s) / C;

  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < CV) {
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        const float d = v[i][e] - mu;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / C + eps);

  T* orow = out + (size_t)row * C;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = lane + 32 * i;
    if (j < CV) {
      float g[VE], b[VE], o[VE];
      if constexpr (kEarlyAffine) {
#pragma unroll
        for (int e = 0; e < VE; ++e) { g[e] = gv[i][e]; b[e] = bv[i][e]; }
      } else {
        load_f32<VE>(gamma + j * VE, g);
        load_f32<VE>(beta + j * VE, b);
      }
#pragma unroll
      for (int e = 0; e < VE; ++e) o[e] = (v[i][e] - mu) * rstd * g[e] + b[e];
      store_vals<T, VE>(orow + (size_t)j * VE, o);
    }
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// K1, a warp per row
template <typename T, int VE, int NV>
__global__ void __launch_bounds__(128)
ln_fwd_warp(const T* __restrict__ x, const float* __restrict__ gamma,
            const float* __restrict__ beta, T* __restrict__ out, float* __restrict__ mu_out,
            float* __restrict__ rstd_out, int n_rows, int C, float eps) {
  row_warp<T, VE, NV, false, true>(x, nullptr, gamma, beta, out, mu_out, rstd_out, n_rows, C,
                                   eps);
}

// K6, a warp per row; EARLY only at few rows, where the kernel waits on
// latency: at many, the registers of gamma and beta beside two rows of
// loads would cost occupancy
template <typename T, int VE, int NV, bool EARLY>
__global__ void __launch_bounds__(128)
add_layer_norm_warp(const T* __restrict__ x, const T* __restrict__ res,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    T* __restrict__ out, float* __restrict__ mu_out, float* __restrict__ rstd_out,
                    int n_rows, int C, float eps) {
  row_warp<T, VE, NV, true, EARLY>(x, res, gamma, beta, out, mu_out, rstd_out, n_rows, C, eps);
}

// The block's sum in a fixed order; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kBlockWarps; ++w) r += red[w];
  __syncthreads();  // red is reused
  return r;
}

// One block normalises one row; VEC: 16-byte loads (x, res and out of one
// type, rows aligned), else scalar ones.  STAGE: the row sits in shared
// memory after pass 1, else each pass reads it again.
template <typename T, typename RT, bool VEC, bool RES>
__device__ __forceinline__ void row_block(const T* __restrict__ x, const RT* __restrict__ res,
                                          const float* __restrict__ gamma,
                                          const float* __restrict__ beta, T* __restrict__ out,
                                          float* __restrict__ mu_out,
                                          float* __restrict__ rstd_out, int C, float eps,
                                          bool stage) {
  constexpr int VE = VEC ? mx::Vec16<T>::N : 1;
  static_assert(!VEC || !RES || sizeof(T) == sizeof(RT), "a vector of x and of res differ");
  extern __shared__ __align__(16) float row_s[];
  __shared__ float red[kBlockWarps];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int CV = C / VE;
  const T* xr = x + (size_t)row * C;
  const RT* rr = RES ? res + (size_t)row * C : nullptr;
  auto load = [&](int j, float* f) {
    load_vals<T, VE>(xr + (size_t)j * VE, f);
    if constexpr (RES) {
      float r[VE];
      load_vals<RT, VE>(rr + (size_t)j * VE, r);
#pragma unroll
      for (int e = 0; e < VE; ++e) f[e] += r[e];
    }
  };
  auto get = [&](int j, float* f) {
    if (stage) {
#pragma unroll
      for (int e = 0; e < VE; ++e) f[e] = row_s[j * VE + e];
    } else {
      load(j, f);
    }
  };

  float s = 0.f;
  for (int j = tid; j < CV; j += kBlockThreads) {
    float f[VE];
    load(j, f);
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      s += f[e];
      if (stage) row_s[j * VE + e] = f[e];
    }
  }
  const float mu = block_sum(s, red) / C;  // its barriers publish row_s
  float q = 0.f;
  for (int j = tid; j < CV; j += kBlockThreads) {
    float f[VE];
    get(j, f);
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const float d = f[e] - mu;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(block_sum(q, red) / C + eps);
  T* orow = out + (size_t)row * C;
  for (int j = tid; j < CV; j += kBlockThreads) {
    float f[VE], g[VE], b[VE], o[VE];
    get(j, f);
    load_f32<VE>(gamma + j * VE, g);
    load_f32<VE>(beta + j * VE, b);
#pragma unroll
    for (int e = 0; e < VE; ++e) o[e] = (f[e] - mu) * rstd * g[e] + b[e];
    store_vals<T, VE>(orow + (size_t)j * VE, o);
  }
  if (tid == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// K1, a block per row
template <typename T, bool VEC>
__global__ void __launch_bounds__(kBlockThreads)
ln_fwd_block(const T* __restrict__ x, const float* __restrict__ gamma,
             const float* __restrict__ beta, T* __restrict__ out, float* __restrict__ mu_out,
             float* __restrict__ rstd_out, int C, float eps, int stage) {
  row_block<T, T, VEC, false>(x, nullptr, gamma, beta, out, mu_out, rstd_out, C, eps, stage);
}

// K6, a block per row
template <typename T, typename RT, bool VEC>
__global__ void __launch_bounds__(kBlockThreads)
add_layer_norm_block(const T* __restrict__ x, const RT* __restrict__ res,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     T* __restrict__ out, float* __restrict__ mu_out,
                     float* __restrict__ rstd_out, int C, float eps, int stage) {
  row_block<T, RT, VEC, true>(x, res, gamma, beta, out, mu_out, rstd_out, C, eps, stage);
}

struct Args {
  const void* x;
  const void* res;  // null for K1
  int res_dt;
  const float* gamma;
  const float* beta;
  void* out;
  float* mu;
  float* rstd;
  int n_rows, C;
  float eps;
  cudaStream_t stream;
};

template <typename T, int VE, int NV>
void launch_warp(const Args& a) {
  const bool few = a.n_rows <= 256;  // decode and prefill: a row a block
  const int rows = few ? 1 : 4;
  const dim3 grid((a.n_rows + rows - 1) / rows);
  const T* x = static_cast<const T*>(a.x);
  const T* res = static_cast<const T*>(a.res);
  T* out = static_cast<T*>(a.out);
  if (a.res == nullptr)
    ln_fwd_warp<T, VE, NV><<<grid, 32 * rows, 0, a.stream>>>(x, a.gamma, a.beta, out, a.mu,
                                                             a.rstd, a.n_rows, a.C, a.eps);
  else if (few)
    add_layer_norm_warp<T, VE, NV, true><<<grid, 32 * rows, 0, a.stream>>>(
        x, res, a.gamma, a.beta, out, a.mu, a.rstd, a.n_rows, a.C, a.eps);
  else
    add_layer_norm_warp<T, VE, NV, false><<<grid, 32 * rows, 0, a.stream>>>(
        x, res, a.gamma, a.beta, out, a.mu, a.rstd, a.n_rows, a.C, a.eps);
}

// The warp instantiation with enough values per lane for the row
// (MAX_NV: what the callers' C can need).
template <typename T, int VE, int MAX_NV>
void warp_path(const Args& a) {
  const int nv = (a.C / VE + 31) / 32;
  if (nv <= 1) return launch_warp<T, VE, 1>(a);
  if (nv <= 2) return launch_warp<T, VE, 2>(a);
  if (nv <= 4 || MAX_NV <= 4) return launch_warp<T, VE, 4>(a);
  if constexpr (MAX_NV > 4) {
    if (nv <= 8 || MAX_NV <= 8) return launch_warp<T, VE, 8>(a);
    if constexpr (MAX_NV > 8) {
      if (nv <= 16 || MAX_NV <= 16) return launch_warp<T, VE, 16>(a);
      if constexpr (MAX_NV > 16) return launch_warp<T, VE, 32>(a);
    }
  }
}

template <typename T, typename RT, bool VEC>
void launch_block(const Args& a) {
  const bool stage = a.C <= kStageFloats;
  const size_t smem = stage ? (size_t)a.C * sizeof(float) : 0;
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  if (a.res == nullptr)
    ln_fwd_block<T, VEC><<<a.n_rows, kBlockThreads, smem, a.stream>>>(
        x, a.gamma, a.beta, out, a.mu, a.rstd, a.C, a.eps, stage);
  else
    add_layer_norm_block<T, RT, VEC><<<a.n_rows, kBlockThreads, smem, a.stream>>>(
        x, static_cast<const RT*>(a.res), a.gamma, a.beta, out, a.mu, a.rstd, a.C, a.eps,
        stage);
}

// The path for x of type T (see the header comment).
template <typename T>
void dispatch(const Args& a) {
  constexpr int VE = mx::Vec16<T>::N;
  const bool same = a.res == nullptr || a.res_dt == mx::dtype_of<T>();
  const bool vec = same && a.C % VE == 0 && mx::aligned16(a.x) && mx::aligned16(a.out) &&
                   (a.res == nullptr || mx::aligned16(a.res)) && mx::aligned16(a.gamma) &&
                   mx::aligned16(a.beta);
  if (vec && a.C <= 4096)
    warp_path<T, VE, 4096 / VE / 32>(a);
  else if (same && a.C <= 256)
    warp_path<T, 1, 8>(a);
  else if (vec)
    launch_block<T, T, true>(a);
  else if (same)
    launch_block<T, T, false>(a);
  else if (a.res_dt == mx::kBF16)
    launch_block<T, mx::bf16, false>(a);
  else if (a.res_dt == mx::kF16)
    launch_block<T, mx::f16, false>(a);
  else
    launch_block<T, float, false>(a);
}

int run(const Args& a, int x_dt) {
  if (a.C <= 0 || a.n_rows < 0 || mx::bad_dtype(x_dt) ||
      (a.res != nullptr && mx::bad_dtype(a.res_dt)))
    return (int)cudaErrorInvalidValue;
  if (a.n_rows == 0) return (int)cudaSuccess;
  if (x_dt == mx::kBF16)
    dispatch<mx::bf16>(a);
  else if (x_dt == mx::kF16)
    dispatch<mx::f16>(a);
  else
    dispatch<float>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: (n_rows, C) contiguous, of x_dtype (0 f32, 1 bf16, 2 f16);
// gamma, beta: (C,) f32; mu, rstd: (n_rows,) f32.  Any alignment: the
// kernel takes 16-byte loads where every operand allows them.  Returns
// cudaGetLastError() after the launch.
int mx_layer_norm(const void* x, int x_dtype, const float* gamma, const float* beta,
                  void* out, float* mu, float* rstd, int n_rows, int C, float eps,
                  cudaStream_t stream) {
  return run(Args{x, nullptr, 0, gamma, beta, out, mu, rstd, n_rows, C, eps, stream}, x_dtype);
}

// K6: LN(x + res); res (n_rows, C) contiguous of res_dtype, the rest as
// mx_layer_norm.
int mx_add_layer_norm(const void* x, int x_dtype, const void* res, int res_dtype,
                      const float* gamma, const float* beta, void* out, float* mu, float* rstd,
                      int n_rows, int C, float eps, cudaStream_t stream) {
  return run(Args{x, res, res_dtype, gamma, beta, out, mu, rstd, n_rows, C, eps, stream},
             x_dtype);
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
