// Ragged paged decode attention for Hopper (sm_90a): f32, bf16 or f16 K/V
// pools, a query of its own float type, any head dim.
//
// Replaces: mxnet_tpu/ops/pallas/paged_attention.py::_kernel (reached
// through paged_decode_attention), the TPU kernel behind the decoder's
// self-attention in every serving decode step.  One query per slot attends
// over the slot's page-table-addressed K/V pages, masked to k_pos < length,
// with an online softmax in f32 whatever the pools' type and exact zeros
// for length == 0.  On the TPU the whole K/V pools sit in VMEM and the grid
// walks the slots in order, the page table arriving by scalar prefetch.
//
// Bound on this card: memory bandwidth.  The work is one dot product and
// one axpy per cached K/V row, so the kernel must at least read
// sum_s min(length_s, P * ps) * H * hd * 2 * sizeof(pool) bytes of K and V
// at 3.35 TB/s; 2 flops per byte is far below the card's ~20 f32 flops per
// byte.  At a decode step's few hundred keys the bytes take under a
// microsecond, so what a step sees is latency: the rounds of dependent
// loads and barriers the longest block waits for.
//
// Design (split-K, "flash-decoding", merged in a thread block cluster):
// - The P * ps keys of a table row are cut into n_split <= 8 spans of
//   `span` keys, chosen on the host from the shapes alone
//   (ops/kernels/paged_attention.py::_plan), never from the lengths,
//   which live on the card.  One 128-thread block takes one (span, head,
//   slot), and the n_split blocks of a (slot, head) form one cluster.
// - A block waits for two rounds of loads: (1) the slot's length, its
//   span's page ids (into shared memory) and q, issued together; (2) the
//   K and V rows of its span, by cp.async straight into shared memory
//   (16-byte copies where the rows allow, 4-byte or element copies where
//   they do not), all in flight at once.  A span longer than a tile of
//   shared memory is walked tile by tile, the next tile's copies in flight
//   while this one is used, with an online softmax across tiles.
// - The rows never leave shared memory: scores q.k by groups of lanes per
//   key (16-byte reads converted to f32, shuffle sums, four keys a group at
//   once), then p.V by threads that each own a 16-byte column of the row
//   and a subset of the keys, forming p = exp(s - m) as they use it and
//   summed in a fixed order into an f32 accumulator in shared memory.
//   Every barrier costs the block about half a microsecond at these sizes,
//   so a tile takes three: the scores (with the warps' maxima), the key
//   sets' sums (with their sums of p), the accumulator.
// - Merge: each block writes its state (acc, m, l) into the shared memory
//   of the cluster's first block (distributed shared memory), arrives at
//   the cluster barrier and exits; a span past the slot's length is empty
//   (m = -1e30, l = 0), which merges to nothing.  The first block waits at
//   the barrier, merges the states in span order (bitwise repeatable) and
//   writes out = acc / l, or exact zeros where no key is live.  No
//   workspace in device memory, no atomics, one launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "dtypes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 4;  // keys a lane group scores at once
constexpr float kNeg = -1e30f;  // the TPU kernel's mask value
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kMaxSplit = 8;  // blocks of a cluster (the portable limit)

__host__ __device__ __forceinline__ size_t up16(size_t x) { return (x + 15) & ~(size_t)15; }

// Where a block keeps what it stages, in bytes from the start of its
// dynamic shared memory; the host sizes the launch from the same function.
struct Layout {
  int ve;      // elements of the pool type in 16 bytes
  int nvec;    // 16-byte vectors a row needs (hd rounded up)
  int hdp;     // nvec * ve: hd rounded up to a whole vector
  int sr;      // row stride in elements: hdp + ve, 16 bytes of padding
  int stages;  // tile buffers: 2 when the span takes more than one tile
  size_t stage_bytes;  // K and V rows of one tile
  size_t q, pages, kv, sc, part, acc, states, bytes;
};

__host__ __device__ inline Layout layout(int hd, int esize, int span, int tile, int ps) {
  Layout o;
  o.ve = 16 / esize;
  o.nvec = (hd + o.ve - 1) / o.ve;
  o.hdp = o.nvec * o.ve;
  o.sr = o.hdp + o.ve;
  o.stages = span > tile ? 2 : 1;
  o.stage_bytes = 2 * (size_t)tile * o.sr * esize;
  o.q = 0;
  o.pages = up16(o.q + (size_t)o.hdp * 4);
  o.kv = up16(o.pages + (size_t)(span / ps + 2) * 4);
  o.sc = up16(o.kv + o.stages * o.stage_bytes);
  o.part = up16(o.sc + (size_t)tile * 4);
  o.acc = up16(o.part + (size_t)kThreads * 8 * 4);
  // the cluster's states, (acc, m, l) per block, read by its first block
  o.states = up16(o.acc + (size_t)o.hdp * 4);
  o.bytes = up16(o.states + (size_t)kMaxSplit * (o.hdp + 2) * 4);
  return o;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// The block's sum in a fixed order (warp trees, then the warps in turn),
// every thread getting it.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r += red[w];
  return r;
}

// Copy the K and V rows of keys k0 .. k0+nk-1 of this (slot, head) into a
// tile of row stride sr (CP: bytes a cp.async copies, 0 for element loads);
// the columns of the last vector past hd are zeroed.
template <typename KV, int CP>
__device__ __forceinline__ void stage_tile(KV* __restrict__ ks, KV* __restrict__ vs,
                                           const KV* __restrict__ k_pool,
                                           const KV* __restrict__ v_pool, const int* pg, int p0,
                                           int k0, int nk, int ps, int hd, int sr,
                                           size_t row_stride, size_t head_off, int hdp) {
  const int tid = threadIdx.x;
  if constexpr (CP != 0) {
    constexpr int U = CP / (int)sizeof(KV);  // elements a copy moves
    const int per_row = hd / U;
    for (int i = tid; i < nk * per_row; i += kThreads) {
      const int r = i / per_row, u = i - r * per_row, key = k0 + r;
      const size_t src =
          ((size_t)pg[key / ps - p0] * ps + key % ps) * row_stride + head_off + (size_t)u * U;
      cp_async<CP>(ks + r * sr + u * U, k_pool + src);
      cp_async<CP>(vs + r * sr + u * U, v_pool + src);
    }
  } else {
    for (int i = tid; i < nk * hd; i += kThreads) {
      const int r = i / hd, e = i - r * hd, key = k0 + r;
      const size_t src = ((size_t)pg[key / ps - p0] * ps + key % ps) * row_stride + head_off + e;
      ks[r * sr + e] = k_pool[src];
      vs[r * sr + e] = v_pool[src];
    }
  }
  if (hdp > hd) {
    const int tail = hdp - hd;
    for (int i = tid; i < nk * tail; i += kThreads) {
      const int r = i / tail, e = hd + i - r * tail;
      ks[r * sr + e] = mx::from_f32<KV>(0.f);
      vs[r * sr + e] = mx::from_f32<KV>(0.f);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// KV: the pools' element type.  CP: bytes a cp.async copies (16 or 4), or
// 0 for element-wise loads (2-byte rows of an odd head dim).  Launched with
// clusters of gridDim.x blocks: block (c, h, s) takes keys
// [c * span, (c + 1) * span) of slot s, head h.
template <typename KV, int CP>
__global__ void __launch_bounds__(kThreads)
paged_decode(const void* __restrict__ q, int q_dt, const KV* __restrict__ k_pool,
             const KV* __restrict__ v_pool, const int* __restrict__ table,
             const int* __restrict__ lengths, void* __restrict__ out, int H, int hd, int ps,
             int P, int span, int tile, float sm_scale) {
  constexpr int VE = mx::Vec16<KV>::N;
  const int c = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Layout lay = layout(hd, (int)sizeof(KV), span, tile, ps);
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  int* pg = reinterpret_cast<int*>(smem + lay.pages);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  float* part = reinterpret_cast<float*>(smem + lay.part);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  __shared__ float red[2][kWarps];
  __shared__ float lpart[kThreads];  // the key sets' sums of p

  // every block of the cluster is running before any writes into another's
  // shared memory: arrive now, wait just before the merge
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // round 1: the length, the span's page ids and q, issued together
  int L = __ldg(lengths + s);
  const int k0 = c * span;
  const int p0 = k0 / ps;
  const int np = (min(k0 + span, P * ps) - 1) / ps + 1 - p0;
  const int* trow = table + (size_t)s * P;
  for (int i = tid; i < np; i += kThreads) pg[i] = __ldg(trow + p0 + i);
  const size_t sh = (size_t)s * H + h;
  const size_t qo = sh * hd;
  for (int e = tid; e < lay.hdp; e += kThreads) {
    qs[e] = e < hd ? mx::load_dt(q, qo + e, q_dt) * sm_scale : 0.f;
    acc[e] = 0.f;
  }
  L = min(max(L, 0), P * ps);  // past the table: the whole row
  const int n_keys = max(0, min(span, L - k0));  // this block's live keys
  const int n_tiles = (n_keys + tile - 1) / tile;
  float m = kNeg, l = 0.f;  // an empty span merges to nothing
  __syncthreads();  // the page ids are visible

  // round 2: the span's K and V rows, tile by tile, the next in flight
  const size_t row_stride = (size_t)H * hd;
  const size_t head_off = (size_t)h * hd;
  // tile it lives in buffer it % stages
  auto stage = [&](int it) {
    return reinterpret_cast<KV*>(smem + lay.kv + (it % lay.stages) * lay.stage_bytes);
  };
  const int tile_elems = tile * lay.sr;
  if (n_tiles > 0)
    stage_tile<KV, CP>(stage(0), stage(0) + tile_elems, k_pool, v_pool, pg, p0, k0,
                       min(tile, n_keys), ps, hd, lay.sr, row_stride, head_off, lay.hdp);
  const int nvec = lay.nvec;
  int T = 1;
  while (T < nvec && T < 32) T <<= 1;
  const int G = 32 / T, g = lane / T, t = lane & (T - 1);
  for (int it = 0; it < n_tiles; ++it) {
    const int kt = k0 + it * tile, nk = min(tile, n_keys - it * tile);
    if (it + 1 < n_tiles) {
      KV* nxt = stage(it + 1);
      stage_tile<KV, CP>(nxt, nxt + tile_elems, k_pool, v_pool, pg, p0, kt + tile,
                         min(tile, n_keys - (it + 1) * tile), ps, hd, lay.sr, row_stride,
                         head_off, lay.hdp);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const KV* ks = stage(it);
    const KV* vs = ks + tile_elems;

    // scores: a group of T lanes per key, 16-byte reads, a shuffle sum;
    // each group takes kKeys keys at once, so their shuffles overlap; the
    // warps' maxima ride on the same barrier as the scores
    float wmax = kNeg;
    for (int base = warp * G; base < nk; base += kWarps * G * kKeys) {  // uniform in the warp
      float d[kKeys];
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        const int j = base + g + u * kWarps * G;
        d[u] = 0.f;
        if (j < nk) {
          const KV* kr = ks + j * lay.sr;
          for (int v = t; v < nvec; v += T) {
            float kf[VE];
            mx::load16(kr + v * VE, kf);
            const float* qv = qs + v * VE;
#pragma unroll
            for (int i = 0; i < VE; ++i) d[u] = fmaf(qv[i], kf[i], d[u]);
          }
        }
      }
      for (int off = T >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < kKeys; ++u) d[u] += __shfl_xor_sync(0xffffffffu, d[u], off);
      }
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        const int j = base + g + u * kWarps * G;
        if (j < nk) {
          if (t == 0) sc[j] = d[u];
          wmax = fmaxf(wmax, d[u]);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, off));
    if (lane == 0) red[0][warp] = wmax;
    __syncthreads();

    // the online softmax over tiles: m, l and acc rescale by alpha; p =
    // exp(s - m) is formed where p.V uses it
    float mt = red[0][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mt = fmaxf(mt, red[0][w]);
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);  // 0 on the first tile

    // p.V: thread (cv, kset) sums its keys for one 16-byte column of the
    // row; acc = acc * alpha + the tile's sum
    if (nvec >= kThreads) {
      float psum = 0.f;
      for (int j = tid; j < nk; j += kThreads) psum += expf(sc[j] - m_new);
      l = l * alpha + block_sum(psum, red[1]);
      for (int cv = tid; cv < nvec; cv += kThreads) {
        float a[VE];
#pragma unroll
        for (int i = 0; i < VE; ++i) a[i] = 0.f;
        for (int j = 0; j < nk; ++j) {
          float vf[VE];
          mx::load16(vs + j * lay.sr + cv * VE, vf);
          const float p = expf(sc[j] - m_new);
#pragma unroll
          for (int i = 0; i < VE; ++i) a[i] = fmaf(p, vf[i], a[i]);
        }
#pragma unroll
        for (int i = 0; i < VE; ++i) acc[cv * VE + i] = acc[cv * VE + i] * alpha + a[i];
      }
    } else {
      const int ksets = kThreads / nvec;
      const int cv = tid % nvec, kset = tid / nvec;
      if (kset < ksets) {
        float a[VE], psum = 0.f;
#pragma unroll
        for (int i = 0; i < VE; ++i) a[i] = 0.f;
        for (int j = kset; j < nk; j += ksets) {
          float vf[VE];
          mx::load16(vs + j * lay.sr + cv * VE, vf);
          const float p = expf(sc[j] - m_new);
          psum += p;
#pragma unroll
          for (int i = 0; i < VE; ++i) a[i] = fmaf(p, vf[i], a[i]);
        }
#pragma unroll
        for (int i = 0; i < VE; ++i) part[(kset * nvec + cv) * VE + i] = a[i];
        if (cv == 0) lpart[kset] = psum;
      }
      __syncthreads();
      float lt = 0.f;
      for (int k = 0; k < ksets; ++k) lt += lpart[k];
      l = l * alpha + lt;
      for (int e = tid; e < lay.hdp; e += kThreads) {
        float o = 0.f;
        for (int k = 0; k < ksets; ++k) o += part[k * nvec * VE + e];
        acc[e] = acc[e] * alpha + o;
      }
    }
    m = m_new;
    __syncthreads();  // the stage and sc are free for the next tile
  }
  // the merge: every block writes its (acc, m, l) into the shared memory
  // of the cluster's first block, arrives at the cluster barrier and is
  // done; the first block waits for all, merges the states in span order
  // and writes out
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), n = (int)cluster.num_blocks();
  const int sw = lay.hdp + 2;  // floats of one state
  float* states = reinterpret_cast<float*>(smem + lay.states);
  float* mine = cluster.map_shared_rank(states, 0) + rank * sw;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int e = tid; e < lay.hdp; e += kThreads) mine[e] = acc[e];
  if (tid == 0) {
    mine[lay.hdp] = m;
    mine[lay.hdp + 1] = l;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (rank != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  float M = kNeg;
  for (int r = 0; r < n; ++r) M = fmaxf(M, states[r * sw + lay.hdp]);
  float w[kMaxSplit], Lsum = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxSplit; ++r) {
    w[r] = r < n ? expf(states[r * sw + lay.hdp] - M) : 0.f;
    if (r < n) Lsum += w[r] * states[r * sw + lay.hdp + 1];
  }
  for (int e = tid; e < hd; e += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      if (r < n) o = fmaf(w[r], states[r * sw + e], o);
    // no live key (length 0): exact zeros, as the TPU kernel forces
    mx::store_dt(out, qo + e, q_dt, Lsum > 0.f ? o / Lsum : 0.f);
  }
}

template <typename KV, int CP>
int launch(const void* q, int q_dt, const void* k_pool, const void* v_pool, const int* table,
           const int* lengths, void* out, int S, int H, int hd, int ps, int P, int span,
           int tile, float sm_scale, cudaStream_t stream) {
  const int n_split = (P * ps + span - 1) / span;
  const Layout lay = layout(hd, (int)sizeof(KV), span, tile, ps);
  if (n_split > kMaxSplit || lay.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  static size_t opted = 48 * 1024;  // per instantiation
  if (lay.bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode<KV, CP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
    if (err != cudaSuccess) return (int)err;
    opted = lay.bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, H, S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, paged_decode<KV, CP>, q, q_dt, static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), table, lengths, out, H, hd, ps, P, span, tile, sm_scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename KV>
int dispatch_cp(const void* q, int q_dt, const void* k_pool, const void* v_pool,
                const int* table, const int* lengths, void* out, int S, int H, int hd, int ps,
                int P, int span, int tile, float sm_scale, cudaStream_t stream) {
  const size_t row = (size_t)hd * sizeof(KV);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(k_pool) | reinterpret_cast<uintptr_t>(v_pool);
  if (row % 16 == 0 && addr % 16 == 0)
    return launch<KV, 16>(q, q_dt, k_pool, v_pool, table, lengths, out, S, H, hd, ps, P, span,
                          tile, sm_scale, stream);
  if (row % 4 == 0 && addr % 4 == 0)
    return launch<KV, 4>(q, q_dt, k_pool, v_pool, table, lengths, out, S, H, hd, ps, P, span,
                         tile, sm_scale, stream);
  return launch<KV, 0>(q, q_dt, k_pool, v_pool, table, lengths, out, S, H, hd, ps, P, span,
                       tile, sm_scale, stream);
}

}  // namespace

extern "C" {

// q, out: (S, H, hd) in q_dtype; k_pool, v_pool: (N, ps, H, hd) in
// kv_dtype; table: (S, P) int32; lengths: (S,) int32; all contiguous.
// Dtype codes: 0 f32, 1 bf16, 2 f16.  The row's P * ps keys are split
// into spans of `span` keys (at most 8 spans), staged `tile` keys at a
// time.  Page ids must lie in [0, N).  Returns cudaGetLastError() after
// the launch.
int mx_paged_decode_attention(const void* q, int q_dtype, const void* k_pool,
                              const void* v_pool, int kv_dtype, const int* table,
                              const int* lengths, void* out, int S, int H, int hd, int ps, int P,
                              int span, int tile, float sm_scale, cudaStream_t stream) {
  if (hd <= 0 || ps <= 0 || P <= 0 || span <= 0 || tile <= 0 || tile > span || S < 0 ||
      H < 0 || mx::bad_dtype(q_dtype) || mx::bad_dtype(kv_dtype))
    return (int)cudaErrorInvalidValue;
  if (S == 0 || H == 0) return (int)cudaSuccess;
  switch (kv_dtype) {
    case mx::kBF16:
      return dispatch_cp<mx::bf16>(q, q_dtype, k_pool, v_pool, table, lengths, out, S, H, hd, ps,
                                   P, span, tile, sm_scale, stream);
    case mx::kF16:
      return dispatch_cp<mx::f16>(q, q_dtype, k_pool, v_pool, table, lengths, out, S, H, hd, ps,
                                  P, span, tile, sm_scale, stream);
    default:
      return dispatch_cp<float>(q, q_dtype, k_pool, v_pool, table, lengths, out, S, H, hd, ps,
                                P, span, tile, sm_scale, stream);
  }
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
