// Per-row softmax cross-entropy for Hopper (sm_90a): f32, bf16 or f16
// logits, an f32 loss.
//
// Replaces: mxnet_tpu/ops/pallas/fused.py::_sce_kernel (reached through
// fused.softmax_cross_entropy): for each row of logits x (N, C) and its
// integer label y, loss = logsumexp(x) - x[y], with 0 where y equals the
// ignore label.  The TPU kernel holds a (256, C) block in VMEM and reduces
// it in one pass, reading the logits in their own type and computing in
// f32; a label outside [0, C) matches no column there, so its loss is the
// row's logsumexp.
//
// Bound on this card: memory bandwidth.  Each live row's C values are read
// once and one float is written, against one exp and a few flops per
// element, so the time floor is the bytes of the rows that are not
// ignored over 3.35 TB/s.
//
// Design: one 256-thread block per row.  A row whose label is the ignore
// label writes 0 and reads nothing else.  Otherwise every thread walks its
// share of the row once, keeping an online maximum m and a sum s of
// exp(x - m) rescaled whenever m grows, so the row is read from device
// memory exactly once.  The loads are 16 bytes (4 f32 or 8 bf16/f16 values,
// converted to f32); a row whose bytes are not a multiple of 16 starts off
// a 16-byte boundary on some rows (BERT's vocabulary, 30522, is 2 mod 4),
// so the values before the first boundary are a scalar prologue, the
// aligned middle is 16-byte vectors, and the rest is a scalar tail.  The (m, s) pairs are merged by warp shuffles, then
// across the block's 8 warps in shared memory.  One thread reads x[y],
// after checking 0 <= y < C.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// (m, s) stands for s * exp(m); m == -inf means "no element yet".
struct MaxSum {
  float m, s;
};

__device__ __forceinline__ MaxSum merge(MaxSum a, MaxSum b) {
  if (b.m == -INFINITY) return a;
  if (a.m == -INFINITY) return b;
  const float m = fmaxf(a.m, b.m);
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m)};
}

__device__ __forceinline__ void add1(MaxSum& a, float x) {
  if (x > a.m) {
    a.s = a.s * expf(a.m - x) + 1.f;  // expf(-inf) == 0 on the first element
    a.m = x;
  } else if (a.m != -INFINITY) {  // x == a.m == -inf adds exp(-inf) = 0
    a.s += expf(x - a.m);
  }
}

// Fold N values into a (one rescale for all of them).
template <int N>
__device__ __forceinline__ void addn(MaxSum& a, const float* v) {
  float mv = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i) mv = fmaxf(mv, v[i]);
  const float m = fmaxf(a.m, mv);
  if (m == -INFINITY) return;  // nothing but -inf so far
  const float scale = a.m == -INFINITY ? 0.f : expf(a.m - m);
  float e[N];
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = expf(v[i] - m);
#pragma unroll
  for (int w = 1; w < N; w *= 2)  // a pairwise sum
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) e[i] += e[i + w];
  a.s = a.s * scale + e[0];
  a.m = m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sce_fwd(const T* __restrict__ logits, const int64_t* __restrict__ labels,
        float* __restrict__ loss, int C, int has_ignore, int ignore_label) {
  constexpr int VE = mx::Vec16<T>::N;
  const int row = blockIdx.x;
  const int64_t y = labels[row];
  if (has_ignore && y == (int64_t)ignore_label) {
    if (threadIdx.x == 0) loss[row] = 0.f;
    return;
  }
  const T* x = logits + (size_t)row * C;

  MaxSum acc = {-INFINITY, 0.f};
  // scalar prologue up to the first 16-byte boundary
  const int head =
      min(C, (int)(((16u - ((uintptr_t)x & 15u)) & 15u) / (unsigned)sizeof(T)));
  if ((int)threadIdx.x < head) add1(acc, mx::to_f32(x[threadIdx.x]));
  const int nv = (C - head) / VE;
  const T* xv = x + head;
  int j = threadIdx.x;
  // four independent 16-byte loads in flight per thread
  for (; j + 3 * kThreads < nv; j += 4 * kThreads) {
    float a[VE], b[VE], c[VE], d[VE];
    mx::ldg16(xv + (size_t)j * VE, a);
    mx::ldg16(xv + (size_t)(j + kThreads) * VE, b);
    mx::ldg16(xv + (size_t)(j + 2 * kThreads) * VE, c);
    mx::ldg16(xv + (size_t)(j + 3 * kThreads) * VE, d);
    addn<VE>(acc, a);
    addn<VE>(acc, b);
    addn<VE>(acc, c);
    addn<VE>(acc, d);
  }
  for (; j < nv; j += kThreads) {
    float a[VE];
    mx::ldg16(xv + (size_t)j * VE, a);
    addn<VE>(acc, a);
  }
  // scalar tail
  for (int t = head + VE * nv + threadIdx.x; t < C; t += kThreads) add1(acc, mx::to_f32(x[t]));

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    MaxSum o;
    o.m = __shfl_xor_sync(0xffffffffu, acc.m, off);
    o.s = __shfl_xor_sync(0xffffffffu, acc.s, off);
    acc = merge(acc, o);
  }
  __shared__ MaxSum part[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? part[lane] : MaxSum{-INFINITY, 0.f};
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      MaxSum o;
      o.m = __shfl_xor_sync(0xffffffffu, acc.m, off);
      o.s = __shfl_xor_sync(0xffffffffu, acc.s, off);
      acc = merge(acc, o);
    }
    if (lane == 0) {
      const float picked = (y >= 0 && y < C) ? mx::to_f32(x[y]) : 0.f;
      loss[row] = (acc.m + logf(acc.s)) - picked;
    }
  }
}

template <typename T>
int launch(const void* logits, const int64_t* labels, float* loss, int n_rows, int C,
           int has_ignore, int ignore_label, cudaStream_t stream) {
  sce_fwd<T><<<n_rows, kThreads, 0, stream>>>(static_cast<const T*>(logits), labels, loss, C,
                                              has_ignore, ignore_label);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// logits: (n_rows, C) contiguous of logits_dtype (0 f32, 1 bf16, 2 f16;
// any alignment of its type); labels: (n_rows,) int64; loss: (n_rows,)
// f32.  Rows with labels[row] == ignore_label get 0 when has_ignore is
// non-zero.  Returns cudaGetLastError() after the launch.
int mx_softmax_cross_entropy(const void* logits, int logits_dtype, const int64_t* labels,
                             float* loss, int n_rows, int C, int has_ignore, int ignore_label,
                             cudaStream_t stream) {
  if (C <= 0 || n_rows < 0 || mx::bad_dtype(logits_dtype)) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  if (logits_dtype == mx::kBF16)
    return launch<mx::bf16>(logits, labels, loss, n_rows, C, has_ignore, ignore_label, stream);
  if (logits_dtype == mx::kF16)
    return launch<mx::f16>(logits, labels, loss, n_rows, C, has_ignore, ignore_label, stream);
  return launch<float>(logits, labels, loss, n_rows, C, has_ignore, ignore_label, stream);
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
