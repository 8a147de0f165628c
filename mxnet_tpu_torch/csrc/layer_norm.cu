// Row LayerNorm over the last axis, f32, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas/fused.py::_ln_kernel (reached through
// fused.layer_norm), the TPU kernel behind every nn.LayerNorm of the
// Transformer: 256-row blocks resident in VMEM, f32 mean and rstd by the
// two-pass formula var = mean((x - mu)^2), affine, and mu/rstd written
// beside the output for the backward pass.
//
// Bound on this card: memory bandwidth.  Per row the kernel reads C floats
// of x and writes C floats of out (gamma/beta stay in L1/L2), about
// 2 * N * C * 4 bytes at 3.35 TB/s, against ~8 flops per element.
//
// Design: one warp per row, four rows per 128-thread block.  Each lane
// loads its share of the row ONCE into registers with 16-byte (float4)
// loads, so both passes of the two-pass variance and the affine write run
// from registers: x is read from device memory exactly once and out is
// written exactly once.  Mean and variance are warp-shuffle reductions;
// no shared memory, no block barrier.  The register array is sized at
// compile time (VPL float4 vectors per lane, C <= 128 * VPL), so C up to
// 4096 is served by one of six instantiations.

// K6, the fused residual add + LayerNorm in the same file, replaces
// mxnet_tpu/ops/pallas/fused.py::_aln_kernel (reached through
// fused.add_layer_norm, which the fused_kernels pass substitutes for the
// _contrib_add_layer_norm op): LN(x + res) with the sum formed in VMEM and
// never written.  Here the same: each lane loads its float4 slices of x and
// res, adds them in registers and runs K1's two passes on the sum, so the
// kernel reads two rows and writes one, about 3 * N * C * 4 bytes, and the
// sum never reaches device memory.  It shares K1's row body (a template
// flag adds the second load) but is a kernel of its own name.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kRowsPerBlock = 4;  // one warp per row

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One warp normalises one row of x (+ res when RES), from registers.
template <int VPL, bool RES>
__device__ __forceinline__ void row_ln(const float* __restrict__ x,
                                       const float* __restrict__ res,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ beta,
                                       float* __restrict__ out,
                                       float* __restrict__ mu_out,
                                       float* __restrict__ rstd_out,
                                       int n_rows, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int C4 = C >> 2;
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)row * C);
  const float4* rr = RES ? reinterpret_cast<const float4*>(res + (size_t)row * C)
                         : nullptr;

  float4 v[VPL];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = lane + 32 * i;
    if (j < C4) {
      v[i] = xr[j];
      if (RES) {
        const float4 r = rr[j];
        v[i].x += r.x; v[i].y += r.y; v[i].z += r.z; v[i].w += r.w;
      }
      s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    } else {
      v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const float mu = warp_sum(s) / C;

  float q = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (lane + 32 * i < C4) {
      const float a = v[i].x - mu, b = v[i].y - mu, c = v[i].z - mu, d = v[i].w - mu;
      q += (a * a + b * b) + (c * c + d * d);
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / C + eps);

  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
  float4* orow = reinterpret_cast<float4*>(out + (size_t)row * C);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = lane + 32 * i;
    if (j < C4) {
      const float4 g = __ldg(g4 + j), b = __ldg(b4 + j);
      float4 o;
      o.x = (v[i].x - mu) * rstd * g.x + b.x;
      o.y = (v[i].y - mu) * rstd * g.y + b.y;
      o.z = (v[i].z - mu) * rstd * g.z + b.z;
      o.w = (v[i].w - mu) * rstd * g.w + b.w;
      orow[j] = o;
    }
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// K1
template <int VPL>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
ln_fwd_f32(const float* __restrict__ x, const float* __restrict__ gamma,
           const float* __restrict__ beta, float* __restrict__ out,
           float* __restrict__ mu_out, float* __restrict__ rstd_out,
           int n_rows, int C, float eps) {
  row_ln<VPL, false>(x, nullptr, gamma, beta, out, mu_out, rstd_out, n_rows,
                     C, eps);
}

// K6
template <int VPL>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
add_layer_norm_f32(const float* __restrict__ x, const float* __restrict__ res,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ out,
                   float* __restrict__ mu_out, float* __restrict__ rstd_out,
                   int n_rows, int C, float eps) {
  row_ln<VPL, true>(x, res, gamma, beta, out, mu_out, rstd_out, n_rows, C,
                    eps);
}

template <int VPL>
void launch(const float* x, const float* res, const float* g, const float* b,
            float* out, float* mu, float* rstd, int n_rows, int C, float eps,
            cudaStream_t stream) {
  const dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  if (res == nullptr)
    ln_fwd_f32<VPL><<<grid, 32 * kRowsPerBlock, 0, stream>>>(
        x, g, b, out, mu, rstd, n_rows, C, eps);
  else
    add_layer_norm_f32<VPL><<<grid, 32 * kRowsPerBlock, 0, stream>>>(
        x, res, g, b, out, mu, rstd, n_rows, C, eps);
}

// The instantiation with enough float4 slots per lane for C.
int dispatch(const float* x, const float* res, const float* g, const float* b,
             float* out, float* mu, float* rstd, int n_rows, int C, float eps,
             cudaStream_t stream) {
  if (C <= 0 || (C & 3) || C > 128 * 32) return (int)cudaErrorInvalidValue;
  if (n_rows > 0) {
    const int vpl = ((C >> 2) + 31) / 32;
    if (vpl <= 1)       launch<1>(x, res, g, b, out, mu, rstd, n_rows, C, eps, stream);
    else if (vpl <= 2)  launch<2>(x, res, g, b, out, mu, rstd, n_rows, C, eps, stream);
    else if (vpl <= 4)  launch<4>(x, res, g, b, out, mu, rstd, n_rows, C, eps, stream);
    else if (vpl <= 8)  launch<8>(x, res, g, b, out, mu, rstd, n_rows, C, eps, stream);
    else if (vpl <= 16) launch<16>(x, res, g, b, out, mu, rstd, n_rows, C, eps, stream);
    else                launch<32>(x, res, g, b, out, mu, rstd, n_rows, C, eps, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest C the kernel takes (C must also be a multiple of 4).
int mx_layer_norm_max_c() { return 128 * 32; }

// x, out: (n_rows, C) f32 contiguous, 16-byte aligned; gamma, beta: (C,);
// mu, rstd: (n_rows,) f32.  Returns cudaGetLastError() after the launch.
int mx_layer_norm_f32(const float* x, const float* gamma, const float* beta,
                      float* out, float* mu, float* rstd, int n_rows, int C,
                      float eps, cudaStream_t stream) {
  return dispatch(x, nullptr, gamma, beta, out, mu, rstd, n_rows, C, eps, stream);
}

// K6: LN(x + res); res like x, the rest as mx_layer_norm_f32.
int mx_add_layer_norm_f32(const float* x, const float* res, const float* gamma,
                          const float* beta, float* out, float* mu, float* rstd,
                          int n_rows, int C, float eps, cudaStream_t stream) {
  return dispatch(x, res, gamma, beta, out, mu, rstd, n_rows, C, eps, stream);
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
