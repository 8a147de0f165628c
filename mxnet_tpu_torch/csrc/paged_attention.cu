// Ragged paged decode attention, f32, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas/paged_attention.py::_kernel (reached
// through paged_decode_attention), the TPU kernel behind the decoder's
// self-attention in every serving decode step.  One query per slot attends
// over the slot's page-table-addressed K/V pages, masked to k_pos < length,
// with an online softmax in f32 and exact zeros for length == 0.  On the
// TPU the whole K/V pools sit in VMEM and the grid walks the slots in
// order, the page table arriving by scalar prefetch.
//
// Bound on this card: memory bandwidth.  The work is one dot product and
// one axpy per cached K/V row, so the kernel must at least read
// sum_s min(length_s, P * ps) * H * hd * 2 * 4 bytes of K and V (plus q and
// out, which are small) at 3.35 TB/s; 2 flops per byte is far below the
// card's ~20 f32 flops per byte.
//
// Design: one 128-thread block per (slot, head), so S * H blocks spread over
// the 132 SMs and every block reads only its own slot's live pages.  The
// block reads lengths[s] and the page-table row itself (no prefetch) and
// loops over the ceil(length / ps) live pages only, never the padded P.
// A key row of one head is hd contiguous floats (rows of the pool layout
// (N, ps, H, hd) are H * hd apart), read by a group of T = hd / 4 lanes
// (rounded up to a power of two) with one 16-byte load each, so a warp
// works on 32 / T keys at once and each group's loads are coalesced.  Each
// group keeps its own running (m, l, acc) in registers and takes UNROLL
// keys per iteration, issuing all their K and V loads before the math so
// several loads are in flight per lane.  The groups' states merge by warp
// shuffles, then the four warps' through shared memory.  K and V are read
// from device memory exactly once; nothing but the final (H, hd) row per
// block is written.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;
constexpr float kNeg = -1e30f;  // the TPU kernel's mask value

__device__ __forceinline__ float4 f4_zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return (a.x * b.x + a.y * b.y) + (a.z * b.z + a.w * b.w);
}

__device__ __forceinline__ void axpy4(float4& acc, float p, float4 v) {
  acc.x += p * v.x; acc.y += p * v.y; acc.z += p * v.z; acc.w += p * v.w;
}

__device__ __forceinline__ void scale4(float4& acc, float a) {
  acc.x *= a; acc.y *= a; acc.z *= a; acc.w *= a;
}

// Merge another online-softmax state (mo, lo, ao) into (m, l, acc).
__device__ __forceinline__ void merge(float& m, float& l, float4& acc,
                                      float mo, float lo, float4 ao) {
  const float mn = fmaxf(m, mo);
  const float a = expf(m - mn), b = expf(mo - mn);
  l = l * a + lo * b;
  acc.x = acc.x * a + ao.x * b;
  acc.y = acc.y * a + ao.y * b;
  acc.z = acc.z * a + ao.z * b;
  acc.w = acc.w * a + ao.w * b;
  m = mn;
}

__global__ void __launch_bounds__(kThreads)
paged_decode_f32(const float* __restrict__ q, const float* __restrict__ k_pool,
                 const float* __restrict__ v_pool, const int* __restrict__ table,
                 const int* __restrict__ lengths, float* __restrict__ out,
                 int H, int hd, int ps, int P, int T, float sm_scale) {
  __shared__ float sm_m[kWarps][32];
  __shared__ float sm_l[kWarps][32];
  __shared__ float4 sm_acc[kWarps][32];

  const int s = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & (T - 1);          // lane within its key group
  const int g = lane / T;                // key group within the warp
  const int groups = 32 / T;
  const int workers = kWarps * groups;   // key groups in the block
  const bool live_lane = 4 * t < hd;     // lanes past hd hold zeros

  const size_t qo = ((size_t)s * H + h) * hd;
  int L = lengths[s];
  L = L < P * ps ? L : P * ps;
  if (L <= 0) {  // inactive slot: exact zeros, as the TPU kernel forces
    if (warp == 0 && g == 0 && live_lane)
      reinterpret_cast<float4*>(out + qo)[t] = f4_zero();
    return;
  }

  float4 qv = live_lane ? reinterpret_cast<const float4*>(q + qo)[t] : f4_zero();
  scale4(qv, sm_scale);
  const int* trow = table + (size_t)s * P;
  const size_t row_stride = (size_t)H * hd;  // floats between key rows
  const size_t head_off = (size_t)h * hd + 4 * t;

  float m = kNeg, l = 0.f;
  float4 acc = f4_zero();
  // base is uniform across the warp, so every lane reaches the shuffles;
  // group g of warp w takes keys base + g + u * workers
  for (int base = warp * groups; base < L; base += workers * kUnroll) {
    float4 kk[kUnroll], vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = base + g + u * workers;
      kk[u] = vv[u] = f4_zero();
      if (k < L && live_lane) {
        const int page = __ldg(trow + k / ps);
        const size_t off = ((size_t)page * ps + k % ps) * row_stride + head_off;
        kk[u] = __ldg(reinterpret_cast<const float4*>(k_pool + off));
        vv[u] = __ldg(reinterpret_cast<const float4*>(v_pool + off));
      }
    }
    float sc[kUnroll];
    float mn = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float d = dot4(qv, kk[u]);
      for (int off = T >> 1; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      sc[u] = base + g + u * workers < L ? d : kNeg;
      mn = fmaxf(mn, sc[u]);
    }
    const float alpha = expf(m - mn);
    l *= alpha;
    scale4(acc, alpha);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + g + u * workers < L) {
        const float p = expf(sc[u] - mn);
        l += p;
        axpy4(acc, p, vv[u]);
      }
    }
    m = mn;
  }

  // merge the key groups of this warp (lanes t of every group pair up)
  for (int off = T; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    float4 ao;
    ao.x = __shfl_xor_sync(0xffffffffu, acc.x, off);
    ao.y = __shfl_xor_sync(0xffffffffu, acc.y, off);
    ao.z = __shfl_xor_sync(0xffffffffu, acc.z, off);
    ao.w = __shfl_xor_sync(0xffffffffu, acc.w, off);
    merge(m, l, acc, mo, lo, ao);
  }
  if (g == 0) {
    sm_m[warp][t] = m;
    sm_l[warp][t] = l;
    sm_acc[warp][t] = acc;
  }
  __syncthreads();
  if (warp == 0 && g == 0 && live_lane) {
    for (int w = 1; w < kWarps; ++w) merge(m, l, acc, sm_m[w][t], sm_l[w][t], sm_acc[w][t]);
    // l > 0: at least one key is live
    reinterpret_cast<float4*>(out + qo)[t] =
        make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
  }
}

}  // namespace

extern "C" {

// Largest head_dim the kernel takes (it must also be a multiple of 4).
int mx_paged_attention_max_hd() { return 128; }

// q, out: (S, H, hd); k_pool, v_pool: (N, ps, H, hd); table: (S, P) int32;
// lengths: (S,) int32.  All contiguous f32 (int32 for table and lengths),
// 16-byte aligned.  Page ids must lie in [0, N).  Returns cudaGetLastError()
// after the launch.
int mx_paged_decode_attention_f32(const float* q, const float* k_pool,
                                  const float* v_pool, const int* table,
                                  const int* lengths, float* out, int S,
                                  int H, int hd, int ps, int P, float sm_scale,
                                  cudaStream_t stream) {
  if (hd <= 0 || (hd & 3) || hd > mx_paged_attention_max_hd() || ps <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  if (S > 0 && H > 0) {
    int T = 1;
    while (4 * T < hd) T <<= 1;
    paged_decode_f32<<<S * H, kThreads, 0, stream>>>(
        q, k_pool, v_pool, table, lengths, out, H, hd, ps, P, T, sm_scale);
  }
  return (int)cudaGetLastError();
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
