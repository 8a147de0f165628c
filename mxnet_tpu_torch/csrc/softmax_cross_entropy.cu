// Per-row softmax cross-entropy, f32 logits, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas/fused.py::_sce_kernel (reached through
// fused.softmax_cross_entropy): for each row of logits x (N, C) and its
// integer label y, loss = logsumexp(x) - x[y], with 0 where y equals the
// ignore label.  The TPU kernel holds a (256, C) block in VMEM and reduces
// it in one pass; a label outside [0, C) matches no column there, so its
// loss is the row's logsumexp.
//
// Bound on this card: memory bandwidth.  Each live row's C floats are read
// once and one float is written, against one exp and a few flops per
// element, so the time floor is the bytes of the rows that are not
// ignored over 3.35 TB/s.
//
// Design: one 256-thread block per row.  A row whose label is the ignore
// label writes 0 and reads nothing else.  Otherwise every thread walks its
// share of the row once, keeping an online maximum m and a sum s of
// exp(x - m) rescaled whenever m grows, so the row is read from device
// memory exactly once.  The loads are float4 (16 bytes); a row of C % 4 != 0
// floats starts off a 16-byte boundary every other row (BERT's vocabulary,
// 30522, is 2 mod 4), so the first (16 - address % 16) / 4 floats are a
// scalar prologue, the aligned middle is float4, and the last C % 4 floats
// are a scalar tail.  The (m, s) pairs are merged by warp shuffles, then
// across the block's 8 warps in shared memory.  One thread reads x[y],
// after checking 0 <= y < C.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ void add4(MaxSum& a, float4 v) {
  const float m4 = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
  const float m = fmaxf(a.m, m4);
  if (m == -INFINITY) return;  // nothing but -inf so far
  const float scale = a.m == -INFINITY ? 0.f : expf(a.m - m);
  a.s = a.s * scale + ((expf(v.x - m) + expf(v.y - m)) +
                       (expf(v.z - m) + expf(v.w - m)));
  a.m = m;
}

__global__ void __launch_bounds__(kThreads)
sce_fwd_f32(const float* __restrict__ logits, const int64_t* __restrict__ labels,
            float* __restrict__ loss, int C, int has_ignore, int ignore_label) {
  const int row = blockIdx.x;
  const int64_t y = labels[row];
  if (has_ignore && y == (int64_t)ignore_label) {
    if (threadIdx.x == 0) loss[row] = 0.f;
    return;
  }
  const float* x = logits + (size_t)row * C;

  MaxSum acc = {-INFINITY, 0.f};
  // scalar prologue up to the first 16-byte boundary
  const int head = min(C, (int)(((16u - ((uintptr_t)x & 15u)) & 15u) >> 2));
  if ((int)threadIdx.x < head) add1(acc, x[threadIdx.x]);
  const int n4 = (C - head) >> 2;
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  int j = threadIdx.x;
  // four independent 16-byte loads in flight per thread
  for (; j + 3 * kThreads < n4; j += 4 * kThreads) {
    const float4 a = __ldg(x4 + j), b = __ldg(x4 + j + kThreads),
                 c = __ldg(x4 + j + 2 * kThreads), d = __ldg(x4 + j + 3 * kThreads);
    add4(acc, a);
    add4(acc, b);
    add4(acc, c);
    add4(acc, d);
  }
  for (; j < n4; j += kThreads) add4(acc, __ldg(x4 + j));
  // scalar tail
  const int tail0 = head + 4 * n4;
  if (tail0 + (int)threadIdx.x < C) add1(acc, x[tail0 + threadIdx.x]);

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
      const float picked = (y >= 0 && y < C) ? x[y] : 0.f;
      loss[row] = (acc.m + logf(acc.s)) - picked;
    }
  }
}

}  // namespace

extern "C" {

// logits: (n_rows, C) f32 contiguous (4-byte aligned is enough); labels:
// (n_rows,) int64; loss: (n_rows,) f32.  Rows with labels[row] ==
// ignore_label get 0 when has_ignore is non-zero.  Returns
// cudaGetLastError() after the launch.
int mx_softmax_cross_entropy_f32(const float* logits, const int64_t* labels,
                                 float* loss, int n_rows, int C,
                                 int has_ignore, int ignore_label,
                                 cudaStream_t stream) {
  if (C <= 0 || n_rows < 0) return (int)cudaErrorInvalidValue;
  if (n_rows > 0)
    sce_fwd_f32<<<n_rows, kThreads, 0, stream>>>(logits, labels, loss, C,
                                                 has_ignore, ignore_label);
  return (int)cudaGetLastError();
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
