// FlashAttention forward (K3), dq (K4) and dk/dv (K5) for 16-bit inputs on
// Hopper's tensor cores (sm_90a): bf16 or f16 q, k, v and do at head dims 64
// and 128.
//
// Replaces, for those inputs, three Pallas kernels of
// mxnet_tpu/ops/pallas/flash_attention.py:
//   _fwd_kernel (K3): out = softmax(q k^T * scale [masked]) v and the row
//     logsumexp, by an online softmax over k tiles;
//   _dq_kernel  (K4): dq = scale * sum_k p * (do v^T - delta) k;
//   _dkv_kernel (K5): dv = p^T do, dk = (p * (do v^T - delta))^T (q * scale),
// with p = exp(s - lse) recomputed from the forward's lse and delta =
// rowsum(do * out) computed outside.  Keys at kpos >= Lk, and above the
// diagonal (qpos < kpos) when causal, score -1e30 as on the TPU.  Every
// other (dtype, head dim), and f32, run in flash_attention.cu; the wrapper
// (ops/kernels/flash_attention.py::_design) picks the file by dtype and head
// dim alone.
//
// Bound on this card.  At the BERT-base training shape (N = 384 heads,
// L = 512, hd = 64) K3 does 4 N L^2 hd = 25.8 GFLOP against 100.7 MB of
// 16-bit q, k, v and out: 256 flops a byte, just under the card's ridge of
// 989 TFLOP/s over 3.35 TB/s (~295), so bytes (0.030 ms) and operations
// (0.026 ms) bound it almost equally.  K4 does 6 N L^2 hd = 38.7 GFLOP
// against 127 MB (q, k, v, do, dq, lse, delta): bound by operations (0.039
// ms), by bytes almost as much (0.038 ms).  K5 does 8 N L^2 hd = 51.5 GFLOP
// against 151 MB (q, k, v, do, dk, dv): 341 flops a byte, bound by
// operations (0.052 ms).  All three need the tensor cores' 16-bit rate,
// which only wgmma reaches, fed from shared memory without register
// staging.
//
// The design:
// - Products are wgmma m64nNk16 with f32 accumulators.  Scores (S = Q K^T
//   in K3; S = Q K^T and dP = dO V^T in K4; S^T = K Q^T and dP^T = V dO^T
//   in K5) are SS: both operands from shared memory, K-major (hd
//   contiguous).  The products over a tile's rows (O += P V; dQ += dS K;
//   dV += P^T dO, dK += dS^T Q) are RS: the A operand is the score
//   accumulator rounded to the input type and repacked in registers
//   (accumulator columns 16kk .. 16kk+15 are the k-step kk fragment as they
//   stand), and B (V, K, dO or Q) is read MN-major through wgmma's
//   transpose bit, so no tile is ever transposed or copied.
// - P and dS are rounded to the input type before their products, where
//   the plain versions (and the Pallas kernels) keep them in f32; S, dP,
//   the softmax statistics, lse, delta and every sum stay f32, and outputs
//   are rounded once.  The error this adds is stated and tested beside the
//   plain versions (tests/test_torch_flash16.py).
// - The scale is applied to S in f32, folded with log2 e into one FMA
//   (p = 2^(s * scale * log2 e - m)); dQ and dK are multiplied by it once,
//   at the store.  Q is never rescaled, so any scale is exact to f32.
// - Tiles move by TMA (cp.async.bulk.tensor, 3-D maps over (hd, L, N) built
//   on the host with cuTensorMapEncodeTiled reached through
//   cudaGetDriverEntryPoint, passed as __grid_constant__ parameters) in
//   128-byte swizzle, the layout wgmma reads without bank conflicts.  A
//   box is 64 columns (128 bytes) wide; a 128-column row tile is two boxes,
//   stored as two column blocks.  Rows past L (in the head) are filled
//   with zeros by TMA's out-of-bounds fill.  Encoding a map costs the host
//   ~0.1 us on an H100's host (PERF.md), a few tenths of a us a call, so
//   maps are not cached.
// - Warp specialisation: a block is one producer warpgroup (one thread
//   issues every TMA; setmaxnreg lowers it to 40 registers) and two
//   consumer warpgroups of 64 rows each (raised to 232).  Streamed tiles
//   sit in a ring guarded by full and empty mbarriers: the producer waits
//   for an empty stage, arms its full barrier with the bytes to come and
//   issues the copies; consumers wait for full, multiply, and arrive on
//   empty.  No wait lasts more than microseconds; one past ~2^36 clocks
//   traps instead of hanging.
// - Persistent blocks: one block an SM walks over the work tiles (q tiles
//   in K3 and K4, key blocks in K5) with a stride of the grid, and the
//   producer loads the next tile's Q (K3), Q and dO (K4) or K and V (K5)
//   into a second buffer while the consumers finish this one: at L = 512 a
//   block's own start and drain would otherwise cost a third of K3's time.
// - K3 (flash_fwd16): work tiles of 128 q rows, K and V streamed in tiles
//   of 128 keys (hd 64) or 64 (hd 128) through three stages.  A warpgroup
//   issues tile t's S together with tile t - 1's P V and runs tile t's
//   softmax while P V is on the tensor cores.  The online softmax runs in
//   the wgmma accumulator layout: lane 4g + t of warp w holds rows 16w + g
//   and 16w + g + 8, columns 8j + 2t and 8j + 2t + 1, so a row's max and
//   sum take two quad shuffles.  Registers a consumer thread: S 64, P 32,
//   O 32 at hd 64; S 32, P 16, O 64 at hd 128.  Shared memory: two Q
//   buffers and three K/V stages, 132,176 B at hd 64, 164,944 B at hd 128.
// - K4 (flash_bwd_dq16): work tiles of 128 q rows, as K3's, with Q and dO
//   loaded a tile ahead; K and V streamed in tiles of 128 keys (hd 64) or
//   64 (hd 128) through three stages.  A warpgroup issues tile t's S and
//   dP together with tile t - 1's dS K and forms tile t's dS while dS K is
//   on the tensor cores; the K tile that S reads K-major is read MN-major
//   by dS K.  lse (times log2 e) and delta of the thread's two rows go to
//   registers once a q tile.  Registers a consumer thread: S 64, dP 64, dS
//   fragments 32, dQ 32 at hd 64; S 32, dP 32, dS 16, dQ 64 at hd 128.
//   Shared memory: two Q/dO buffers and three K/V stages, 164,944 B at hd
//   64, 230,480 B at hd 128.  At hd 64, 128-key tiles took 0.098 ms at the
//   training shape against 0.109 ms for 64-key ones (PERF.md), without a
//   spill.
// - K5 (flash_bwd_dkv16): work tiles of 128 keys (64 a consumer
//   warpgroup), Q and dO streamed in tiles of 64 q rows (hd 64) or 16 (hd
//   128) through two stages, with lse (times log2 e) and delta written into
//   the stage by the producer warp's lanes (each arrives on the stage's
//   full barrier, lane 0 with the TMA bytes).  Registers a consumer
//   thread: dK and dV 2 x 32, S^T and dP^T 2 x 32, P^T and dS^T 2 x 16 at
//   hd 64; 2 x 64, 2 x 8 and 2 x 4 at hd 128, where the 16-row q tile keeps
//   S^T and dP^T beside the two 64 x 128 accumulators.  ptxas reports the
//   168 registers of __launch_bounds__(384, 1) for every kernel (K3, K4 and
//   K5) and no spill; a 32-row q tile at hd 128 spilled and serialised K5's
//   wgmmas.
// - Every output row is summed in one block, without atomics: out, lse,
//   dq, dk and dv are bitwise repeatable.  Causal K3 and K4 tiles stop at
//   the last key tile that reaches their diagonal (later tiles are never
//   loaded), causal K5 tiles start at the first q tile that does, and tiles
//   with every (q, k) pair live skip the mask tests.
// What bounds K3 at hd 64 is the exponentials: one ex2 a score on the SFUs
// (16 a clock an SM) takes as long as the score's 4 hd products on the
// tensor cores, and the two consumer warpgroups overlap the two only in
// part (ping-pong turns between them measured slower).  K4 carries 6 hd
// products a score and K5 8, so the exponential weighs less there.  Not
// yet: an exponential on the FMA units for part of a tile, TMA stores of
// the outputs.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "dtypes.cuh"

namespace {

constexpr float kNeg = -1e30f;  // the TPU kernels' mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWG = 128;             // threads of a warpgroup
constexpr int kThreads = 3 * kWG;    // a producer and two consumer warpgroups
constexpr int kProducerRegs = 40;    // setmaxnreg: 128 x 40 + 256 x 232 <= 64 K
constexpr int kConsumerRegs = 232;
constexpr int kBoxCols = 64;         // 128 bytes of a 16-bit row: one swizzle row
constexpr int kRowBytes = 128;

// ---------------------------------------------------------------------------
// Shared memory, mbarriers, TMA and wgmma.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Arrive, and add `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// Wait until the phase of parity `parity` has completed.  No wait of these
// kernels lasts more than microseconds: one that passes ~2^36 clocks (tens
// of seconds) is a deadlock, and traps (a launch error) instead of hanging.
__device__ __forceinline__ bool bar_try(uint32_t a, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(a), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (bar_try(a, parity)) return;
  const long long t0 = clock64();
  while (!bar_try(a, parity))
    if (clock64() - t0 > (1ll << 36)) __trap();
}

// One box of a 3-D tensor map (coordinates innermost first: column, row,
// head) into shared memory; its bytes complete a transaction of `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin an accumulator's registers around the asynchronous products, so the
// compiler moves no access to them across the issue or the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A wgmma shared-memory descriptor for a tile in 128-byte swizzle: start
// address, leading byte offset (LBO) and stride byte offset (SBO), each in
// 16-byte units.  K-major: rows of 128 bytes, SBO = 1024 between groups of
// 8 rows, LBO unused (1); a k-step of 16 elements (32 bytes) inside the
// swizzle row advances the start address.  MN-major: the tile's rows run
// along K, 8-row groups 1024 bytes apart (SBO), and LBO is the distance
// between its 64-column blocks.  Tiles start 1024-byte aligned.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
constexpr uint32_t kKMajor = 16;  // LBO of a K-major tile: unused, 1 unit

// Two f32 values rounded to T and packed, the first in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi, mx::bf16) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack(float lo, float hi, mx::f16) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k-step kk of an RS wgmma from a 64 x N accumulator:
// entries 8kk .. 8kk+7 are rows g, g + 8 and columns 16kk + 2t (+1), 16kk
// + 8 + 2t (+1), as the m64nNk16 A operand lays them out.
template <typename T, int R>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const float (&d)[R], int kk) {
  a[0] = pack(d[8 * kk + 0], d[8 * kk + 1], T{});
  a[1] = pack(d[8 * kk + 2], d[8 * kk + 3], T{});
  a[2] = pack(d[8 * kk + 4], d[8 * kk + 5], T{});
  a[3] = pack(d[8 * kk + 6], d[8 * kk + 7], T{});
}

// 2^x (ex2.approx: 2 ulp; 2^0 = 1 exactly, 2^-1e30 = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two adjacent outputs of one row, rounded to T.
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack(a, b, T{});
}

// wgmma m64nNk16, f32 += T x T.  wgmma_ss: A and B from shared memory,
// both K-major; scale_d 0 overwrites d.  wgmma_rs: A from registers, B
// MN-major (transposed) from shared memory, accumulating.
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b, int scale_d, mx::bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b, int scale_d, mx::f16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d, mx::bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d, mx::f16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d, mx::bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d, mx::f16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d, mx::bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d, mx::f16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, mx::bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, mx::f16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, mx::bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, mx::f16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// Byte offsets in a block's dynamic shared memory (after aligning its
// start to 1024).  A row tile of R rows x HD columns is HD / 64 column
// blocks of R x 128 bytes, each a run of TMA boxes.
template <int HD>
struct Dkv16 {
  static constexpr int kKeys = 128;              // two consumer warpgroups of 64
  static constexpr int kBQ = HD == 64 ? 64 : 16;  // q rows of a streamed tile
  static constexpr int kStages = 2;
  static constexpr int kCB = HD / kBoxCols;
  static constexpr int kKVWG = 64 * HD * 2;      // a consumer warpgroup's K (or V) rows
  static constexpr int kQ = kBQ * HD * 2;        // one Q or dO tile
  static constexpr int kV = 2 * kKVWG;           // V after K
  static constexpr int kKV = 4 * kKVWG;          // a key block's K and V; two buffers
  static constexpr int kRing = 2 * kKV;
  static constexpr int kVec = kRing + kStages * 2 * kQ;  // lse * log2 e, delta
  // barriers: kvfull[2], kvempty[2], full[kStages], empty[kStages]
  static constexpr int kBars = kVec + kStages * 2 * kBQ * 4;
  static constexpr size_t kSmem = 1024 + kBars + 8 * (4 + 2 * kStages);
};

// The block's dynamic shared memory, its start rounded up to 1024 bytes
// (the 128-byte swizzle repeats every 8 rows of 128 bytes).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// ---------------------------------------------------------------------------
// K3: block (n, 128 q rows).  Consumer warpgroup c owns q rows 64c .. 64c+63:
// S = Q K^T over a tile of kBN keys, the online softmax in place, O += P V.
// A warpgroup issues tile t's S together with tile t - 1's P V, and runs
// tile t's softmax while P V is on the tensor cores.
// ---------------------------------------------------------------------------
// K3's online softmax over one score tile, in place: the raw scores sc
// (rows r, r + 8; key columns 8j + 2t (+1)) become p = 2^(s - m_new) with s
// = sc * scale_log2 (log2 units), m (the row max so far, log2 units)
// becomes m_new, l (this lane's share of each row sum) l * alpha + its p,
// and alpha = 2^(m - m_new) is returned for O.  kMask: scores of keys at
// kpos >= Lk or above the diagonal are -1e30 (a row with no live key yet
// takes p = 1, which a later alpha = 0 wipes, as on the TPU).  Without it
// the scale is folded into one FMA (the max of the raw scores times the
// scale is the max of the scaled ones: rounding is monotonic).
template <bool kMask, int NA>
__device__ __forceinline__ void fwd_softmax(float (&sc)[NA], float (&m)[2], float (&l)[2],
                                            float (&alpha)[2], float scale_log2, int kpos0,
                                            int row0, int Lk, int causal) {
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int h = (i >> 1) & 1;
    if (kMask) {
      const int kpos = kpos0 + 8 * (i >> 2) + (i & 1);
      sc[i] = kpos >= Lk || (causal && row0 + 8 * h < kpos) ? kNeg : sc[i] * scale_log2;
    }
    mx[h] = fmaxf(mx[h], sc[i]);
  }
  float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the row's max over the quad's four lanes
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    m_new[h] = fmaxf(m[h], kMask ? mx[h] : mx[h] * scale_log2);
    alpha[h] = ex2(m[h] - m_new[h]);
    m[h] = m_new[h];
  }
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int h = (i >> 1) & 1;
    sc[i] = kMask ? ex2(sc[i] - m_new[h]) : ex2(fmaf(sc[i], scale_log2, -m_new[h]));
    sum[h] += sc[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
}

template <int HD>
struct Fwd16 {
  static constexpr int kRows = 128;               // q rows: two consumer warpgroups of 64
  static constexpr int kBN = HD == 64 ? 128 : 64;  // keys of a streamed K or V tile
  static constexpr int kStages = 3;
  static constexpr int kCB = HD / kBoxCols;
  static constexpr int kQWG = 64 * HD * 2;   // a consumer warpgroup's Q rows
  static constexpr int kQ = 2 * kQWG;        // a q tile; two buffers
  static constexpr int kKV = kBN * HD * 2;   // one K or V tile
  static constexpr int kRing = 2 * kQ;
  // barriers: qfull[2], qempty[2], full[kStages], empty[kStages]
  static constexpr int kBars = kRing + kStages * 2 * kKV;
  static constexpr size_t kSmem = 1024 + kBars + 8 * (4 + 2 * kStages);
};

// A persistent K3 block's work: q tile w of the flattened (head, q tile)
// order, heaviest (for causal, the last) q tile of a head first.
struct FwdTile {
  int n, q0;
  __device__ FwdTile(int w, int q_tiles, int rows)
      : n(w / q_tiles), q0((q_tiles - 1 - w % q_tiles) * rows) {}
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, T* __restrict__ out,
            float* __restrict__ lse, int Lq, int Lk, int q_tiles, int n_tiles, int causal,
            float scale_log2) {
  using F = Fwd16<HD>;
  constexpr int S = F::kStages, BN = F::kBN, NA = BN / 2, NO = HD / 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + F::kBars);
  uint64_t* qempty = qfull + 2;
  uint64_t* full = qempty + 2;
  uint64_t* empty = full + S;
  // the key tiles of the q tile at q0
  auto key_tiles = [&](int q0) {
    const int kt = (Lk + BN - 1) / BN;
    return causal ? min(kt, (min(q0 + F::kRows, Lq) - 1) / BN + 1) : kt;
  };

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      bar_init(qfull + b, 1);
      bar_init(qempty + b, 2 * kWG);
    }
    for (int s = 0; s < S; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 2 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 0) {  // producer: one thread issues every copy, a q tile ahead
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int kv = 0;  // K/V tiles issued so far: the ring runs on across q tiles
      for (int w = blockIdx.x, i = 0; w < n_tiles; w += gridDim.x, ++i) {
        const FwdTile tile(w, q_tiles, F::kRows);
        const int b = i & 1;
        bar_wait(qempty + b, ((i >> 1) & 1) ^ 1);
        bar_expect_tx(qfull + b, F::kQ);
        for (int c = 0; c < 2; ++c)
          for (int cb = 0; cb < F::kCB; ++cb)
            tma_load(smem + b * F::kQ + c * F::kQWG + cb * 64 * kRowBytes, &tq, qfull + b,
                     cb * kBoxCols, tile.q0 + 64 * c, tile.n);
        const int k_tiles = key_tiles(tile.q0);
        for (int t = 0; t < k_tiles; ++t, ++kv) {
          const int s = kv % S;
          bar_wait(empty + s, ((kv / S) & 1) ^ 1);
          bar_expect_tx(full + s, 2 * F::kKV);
          uint8_t* kt = smem + F::kRing + s * 2 * F::kKV;
          for (int cb = 0; cb < F::kCB; ++cb) {
            tma_load(kt + cb * BN * kRowBytes, &tk, full + s, cb * kBoxCols, t * BN, tile.n);
            tma_load(kt + F::kKV + cb * BN * kRowBytes, &tv, full + s, cb * kBoxCols, t * BN,
                     tile.n);
          }
        }
      }
    }
  } else {  // consumers
    regs_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int r16 = 64 * c + 16 * warp + (lane >> 2);  // rows r16, r16 + 8 of a q tile
    const int col0 = 2 * (lane & 3);                    // columns 8j + col0 (+1)
    const uint32_t ring = smem_u32(smem + F::kRing);

    float o[NO], sc[NA], m[2], l[2], alpha[2];
    uint32_t pa[BN / 16][4];
    int kv = 0;  // K/V tiles consumed so far
    for (int w = blockIdx.x, i = 0; w < n_tiles; w += gridDim.x, ++i) {
      const FwdTile tile(w, q_tiles, F::kRows);
      const int k_tiles = key_tiles(tile.q0);
      const int row0 = tile.q0 + r16;
      // the first q row of this warpgroup: a key tile wholly at or below it
      // is live for every row
      const int qw0 = tile.q0 + 64 * c;
      const uint32_t qaddr = smem_u32(smem + (i & 1) * F::kQ + c * F::kQWG);
#pragma unroll
      for (int j = 0; j < NO; ++j) o[j] = 0.f;
      m[0] = m[1] = kNeg;
      l[0] = l[1] = 0.f;

      // S = Q K_t^T into sc (K-major Q and K tiles, 16 columns of hd a step)
      auto issue_s = [&](int t) {
        const uint32_t kaddr = ring + ((kv + t) % S) * 2 * F::kKV;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss(sc, desc(qaddr + (kk >> 2) * 64 * kRowBytes + (kk & 3) * 32, kKMajor),
                   desc(kaddr + (kk >> 2) * BN * kRowBytes + (kk & 3) * 32, kKMajor), kk > 0,
                   T{});
      };
      // O += P V_t (P from registers, V MN-major, 16 keys a step)
      auto issue_pv = [&](int t) {
        const uint32_t vaddr = ring + ((kv + t) % S) * 2 * F::kKV + F::kKV;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs(o, pa[kk], desc(vaddr + kk * 16 * kRowBytes, BN * kRowBytes), T{});
      };
      auto softmax = [&](int t) {
        const int k0 = t * BN;
        if (k0 + BN <= Lk && (!causal || k0 + BN - 1 <= qw0))
          fwd_softmax<false>(sc, m, l, alpha, scale_log2, k0 + col0, row0, Lk, causal);
        else
          fwd_softmax<true>(sc, m, l, alpha, scale_log2, k0 + col0, row0, Lk, causal);
      };
      auto pack_p = [&] {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) frag_a<T>(pa[kk], sc, kk);
      };
      auto full_of = [&](int t) {
        bar_wait(full + (kv + t) % S, ((kv + t) / S) & 1);
      };

      bar_wait(qfull + (i & 1), (i >> 1) & 1);
      if (k_tiles > 0) {
        full_of(0);
        wg_fence();
        issue_s(0);
        wg_commit();
        wg_wait<0>();
        fence_regs(sc);
        softmax(0);  // O is 0: its alpha is not needed
        pack_p();
      }
      for (int t = 1; t < k_tiles; ++t) {
        full_of(t);
        fence_regs(o);
        wg_fence();
        issue_s(t);
        wg_commit();
        issue_pv(t - 1);
        wg_commit();
        wg_wait<1>();  // S of tile t is in; P V of tile t - 1 runs on
        fence_regs(sc);
        softmax(t);
        wg_wait<0>();  // P V of tile t - 1 is in: pa and O are free
        fence_regs(o);
        bar_arrive(empty + (kv + t - 1) % S);  // this thread is done with tile t - 1
#pragma unroll
        for (int j = 0; j < NO; ++j) o[j] *= alpha[(j >> 1) & 1];
        pack_p();
      }
      if (k_tiles > 0) {
        fence_regs(o);
        wg_fence();
        issue_pv(k_tiles - 1);
        wg_commit();
        wg_wait<0>();
        fence_regs(o);
        bar_arrive(empty + (kv + k_tiles - 1) % S);
      }
      bar_arrive(qempty + (i & 1));  // the producer may load the q tile after next
      kv += k_tiles;

#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the row sum over the quad's four lanes
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      }
      const size_t qo = (size_t)tile.n * Lq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        if (r >= Lq) continue;  // rows past Lq are computed from zero q, never written
        const float inv = l[h] == 0.f ? 1.f : 1.f / l[h];
        // m is in log2 units; with no key at all (Lk = 0) lse is the mask value
        if (col0 == 0) lse[qo + r] = l[h] == 0.f ? kNeg : m[h] * kLn2 + logf(l[h]);
        T* orow = out + (qo + r) * HD + col0;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          store2(orow + 8 * j, o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K5: a persistent block walks over key blocks of 128 keys (n, k0), K and V
// loaded a key block ahead into two buffers.  Consumer warpgroup c owns keys
// k0 + 64c .. k0 + 64c + 63: S^T = K Q^T and dP^T = V dO^T over a tile of
// kBQ q rows, P^T and dS^T in place, dV += P^T dO, dK += dS^T Q; dK is
// scaled at the store.  The Q/dO ring runs on across key blocks.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, int Lq, int Lk, int k_blocks,
                int n_tiles, int causal, float sm_scale, float scale_log2) {
  using B = Dkv16<HD>;
  constexpr int S = B::kStages, BQ = B::kBQ, NS = BQ / 2, NO = HD / 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* vec = reinterpret_cast<float*>(smem + B::kVec);
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(smem + B::kBars);
  uint64_t* kvempty = kvfull + 2;
  uint64_t* full = kvempty + 2;
  uint64_t* empty = full + S;
  const int q_tiles = (Lq + BQ - 1) / BQ;
  // the key block of work tile w (the first key blocks of a head, the
  // heaviest when causal, first), and its first q tile: q tiles wholly
  // above k0 have p = 0
  auto key0 = [&](int w) { return (w % k_blocks) * B::kKeys; };
  auto first_q = [&](int k0) { return causal ? k0 / BQ : 0; };

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      bar_init(kvfull + b, 1);
      bar_init(kvempty + b, 2 * kWG);
    }
    for (int s = 0; s < S; ++s) {
      bar_init(full + s, 32);  // the producer warp's lanes, one with the bytes
      bar_init(empty + s, 2 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  if (wg == 0) {  // producer: warp 0, whose lane 0 issues every copy
    regs_dec<kProducerRegs>();
    if (warp == 0) {
      int qs = 0;  // Q/dO tiles issued so far: the ring runs on across key blocks
      for (int w = blockIdx.x, i = 0; w < n_tiles; w += gridDim.x, ++i) {
        const int n = w / k_blocks, k0 = key0(w), b = i & 1;
        if (lane == 0) {
          bar_wait(kvempty + b, ((i >> 1) & 1) ^ 1);
          bar_expect_tx(kvfull + b, B::kKV);
          uint8_t* kvb = smem + b * B::kKV;
          for (int c = 0; c < 2; ++c)
            for (int cb = 0; cb < B::kCB; ++cb) {
              const int at = c * B::kKVWG + cb * 64 * kRowBytes;
              tma_load(kvb + at, &tk, kvfull + b, cb * kBoxCols, k0 + 64 * c, n);
              tma_load(kvb + B::kV + at, &tv, kvfull + b, cb * kBoxCols, k0 + 64 * c, n);
            }
        }
        const float* lse_n = lse + (size_t)n * Lq;
        const float* delta_n = delta + (size_t)n * Lq;
        for (int t = first_q(k0); t < q_tiles; ++t, ++qs) {
          const int s = qs % S;
          bar_wait(empty + s, ((qs / S) & 1) ^ 1);
          float* rows = vec + s * 2 * BQ;  // lse * log2 e, then delta
          for (int r = lane; r < BQ; r += 32) {
            const int qpos = t * BQ + r;
            const bool ok = qpos < Lq;
            rows[r] = ok ? lse_n[qpos] * kLog2e : 0.f;
            rows[BQ + r] = ok ? delta_n[qpos] : 0.f;
          }
          if (lane == 0) {
            bar_expect_tx(full + s, 2 * B::kQ);
            uint8_t* qt = smem + B::kRing + s * 2 * B::kQ;
            for (int cb = 0; cb < B::kCB; ++cb) {
              tma_load(qt + cb * BQ * kRowBytes, &tq, full + s, cb * kBoxCols, t * BQ, n);
              tma_load(qt + B::kQ + cb * BQ * kRowBytes, &tdo, full + s, cb * kBoxCols, t * BQ,
                       n);
            }
          } else {
            bar_arrive(full + s);
          }
        }
      }
    }
  } else {  // consumers
    regs_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int col0 = 2 * (lane & 3);
    const int r16 = 64 * c + 16 * warp + (lane >> 2);  // keys r16, r16 + 8 of a key block
    float dk_acc[NO], dv_acc[NO], sc[NS], dp[NS];
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    int qs = 0;  // Q/dO tiles consumed so far
    for (int w = blockIdx.x, i = 0; w < n_tiles; w += gridDim.x, ++i) {
      const int n = w / k_blocks, k0 = key0(w), b = i & 1;
      const int kw0 = k0 + 64 * c;
      const int krow = k0 + r16;  // this thread's keys: krow, krow + 8
      const uint32_t kaddr = smem_u32(smem + b * B::kKV + c * B::kKVWG);
      const uint32_t vaddr = kaddr + B::kV;
#pragma unroll
      for (int j = 0; j < NO; ++j) dk_acc[j] = dv_acc[j] = 0.f;
      bar_wait(kvfull + b, (i >> 1) & 1);

      for (int t = first_q(k0); t < q_tiles; ++t, ++qs) {
        const int s = qs % S;
        bar_wait(full + s, (qs / S) & 1);
        const uint32_t qaddr = smem_u32(smem + B::kRing + s * 2 * B::kQ);
        const uint32_t oaddr = qaddr + B::kQ;
        const float* lse_s = vec + s * 2 * BQ;
        const float* delta_s = lse_s + BQ;

        wg_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t a_off = (kk >> 2) * 64 * kRowBytes + (kk & 3) * 32;
          const uint32_t b_off = (kk >> 2) * BQ * kRowBytes + (kk & 3) * 32;
          wgmma_ss(sc, desc(kaddr + a_off, kKMajor), desc(qaddr + b_off, kKMajor), kk > 0, T{});
          wgmma_ss(dp, desc(vaddr + a_off, kKMajor), desc(oaddr + b_off, kKMajor), kk > 0, T{});
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        const int q0 = t * BQ;
        const bool all_live = q0 + BQ <= Lq && kw0 + 64 <= Lk && (!causal || kw0 + 63 <= q0);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const int col = 8 * j + col0;
          const float2 ls = *reinterpret_cast<const float2*>(lse_s + col);
          const float2 de = *reinterpret_cast<const float2*>(delta_s + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i4 = 4 * j + e;
            float p = ex2(fmaf(sc[i4], scale_log2, -((e & 1) ? ls.y : ls.x)));
            if (!all_live) {
              const int qpos = q0 + col + (e & 1), kpos = krow + 8 * (e >> 1);
              if (qpos >= Lq || kpos >= Lk || (causal && qpos < kpos)) p = 0.f;
            }
            sc[i4] = p;
            dp[i4] = p * (dp[i4] - ((e & 1) ? de.y : de.x));
          }
        }
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          frag_a<T>(pa[kk], sc, kk);
          frag_a<T>(da[kk], dp, kk);
        }
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          wgmma_rs(dv_acc, pa[kk], desc(oaddr + kk * 16 * kRowBytes, BQ * kRowBytes), T{});
          wgmma_rs(dk_acc, da[kk], desc(qaddr + kk * 16 * kRowBytes, BQ * kRowBytes), T{});
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        bar_arrive(empty + s);  // this thread is done with stage s
      }
      bar_arrive(kvempty + b);  // the producer may load the key block after next

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = krow + 8 * h;
        if (r >= Lk) continue;
        const size_t at = ((size_t)n * Lk + r) * HD + col0;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          store2(dk + at + 8 * j, dk_acc[4 * j + 2 * h] * sm_scale,
                 dk_acc[4 * j + 2 * h + 1] * sm_scale);
          store2(dv + at + 8 * j, dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4: a persistent block walks over q tiles of 128 rows (n, q0), Q and dO
// loaded a q tile ahead into two buffers.  Consumer warpgroup c owns q rows
// q0 + 64c .. q0 + 64c + 63: S = Q K^T and dP = dO V^T over a tile of kBN
// keys, dS = P (dP - delta) in place, dQ += dS K with K read MN-major; dQ
// is scaled at the store.  A warpgroup issues tile t's S and dP together
// with tile t - 1's dS K and forms tile t's dS while dS K is on the tensor
// cores.  The K/V ring runs on across q tiles.
// ---------------------------------------------------------------------------
template <int HD>
struct Dq16 {
  static constexpr int kRows = 128;        // q rows: two consumer warpgroups of 64
  static constexpr int kBN = HD == 64 ? 128 : 64;  // keys of a streamed K or V tile
  static constexpr int kStages = 3;
  static constexpr int kCB = HD / kBoxCols;
  static constexpr int kQWG = 64 * HD * 2;  // a consumer warpgroup's Q (or dO) rows
  static constexpr int kQ = 2 * kQWG;       // a q tile's Q; its dO after it
  static constexpr int kQdO = 2 * kQ;       // two buffers of Q and dO
  static constexpr int kKV = kBN * HD * 2;  // one K or V tile
  static constexpr int kRing = 2 * kQdO;
  // barriers: qfull[2], qempty[2], full[kStages], empty[kStages]
  static constexpr int kBars = kRing + kStages * 2 * kKV;
  static constexpr size_t kSmem = 1024 + kBars + 8 * (4 + 2 * kStages);
};

// K4's dS over one score tile, in place: the raw scores sc (rows r, r + 8;
// key columns 8j + 2t (+1)) become ds = p (dp - delta) with p = 2^(s *
// scale_log2 - lse * log2 e) in one FMA.  kMask: p is 0 for keys at kpos >=
// Lk or above the diagonal (their -1e30 scores on the TPU).
template <bool kMask, int NA>
__device__ __forceinline__ void dq_scores(float (&sc)[NA], const float (&dp)[NA],
                                          const float (&lse2)[2], const float (&delta)[2],
                                          float scale_log2, int kpos0, int row0, int Lk,
                                          int causal) {
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int h = (i >> 1) & 1;
    float p = ex2(fmaf(sc[i], scale_log2, -lse2[h]));
    if (kMask) {
      const int kpos = kpos0 + 8 * (i >> 2) + (i & 1);
      if (kpos >= Lk || (causal && row0 + 8 * h < kpos)) p = 0.f;
    }
    sc[i] = p * (dp[i] - delta[h]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dq, int Lq, int Lk, int q_tiles, int n_tiles, int causal,
               float sm_scale, float scale_log2) {
  using F = Dq16<HD>;
  constexpr int S = F::kStages, BN = F::kBN, NA = BN / 2, NO = HD / 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + F::kBars);
  uint64_t* qempty = qfull + 2;
  uint64_t* full = qempty + 2;
  uint64_t* empty = full + S;
  // the key tiles of the q tile at q0
  auto key_tiles = [&](int q0) {
    const int kt = (Lk + BN - 1) / BN;
    return causal ? min(kt, (min(q0 + F::kRows, Lq) - 1) / BN + 1) : kt;
  };

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      bar_init(qfull + b, 1);
      bar_init(qempty + b, 2 * kWG);
    }
    for (int s = 0; s < S; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 2 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 0) {  // producer: one thread issues every copy, a q tile ahead
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int kv = 0;  // K/V tiles issued so far: the ring runs on across q tiles
      for (int w = blockIdx.x, i = 0; w < n_tiles; w += gridDim.x, ++i) {
        const FwdTile tile(w, q_tiles, F::kRows);
        const int b = i & 1;
        bar_wait(qempty + b, ((i >> 1) & 1) ^ 1);
        bar_expect_tx(qfull + b, F::kQdO);
        uint8_t* qb = smem + b * F::kQdO;
        for (int c = 0; c < 2; ++c)
          for (int cb = 0; cb < F::kCB; ++cb) {
            const int at = c * F::kQWG + cb * 64 * kRowBytes;
            tma_load(qb + at, &tq, qfull + b, cb * kBoxCols, tile.q0 + 64 * c, tile.n);
            tma_load(qb + F::kQ + at, &tdo, qfull + b, cb * kBoxCols, tile.q0 + 64 * c,
                     tile.n);
          }
        const int k_tiles = key_tiles(tile.q0);
        for (int t = 0; t < k_tiles; ++t, ++kv) {
          const int s = kv % S;
          bar_wait(empty + s, ((kv / S) & 1) ^ 1);
          bar_expect_tx(full + s, 2 * F::kKV);
          uint8_t* kt = smem + F::kRing + s * 2 * F::kKV;
          for (int cb = 0; cb < F::kCB; ++cb) {
            tma_load(kt + cb * BN * kRowBytes, &tk, full + s, cb * kBoxCols, t * BN, tile.n);
            tma_load(kt + F::kKV + cb * BN * kRowBytes, &tv, full + s, cb * kBoxCols, t * BN,
                     tile.n);
          }
        }
      }
    }
  } else {  // consumers
    regs_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int r16 = 64 * c + 16 * warp + (lane >> 2);  // rows r16, r16 + 8 of a q tile
    const int col0 = 2 * (lane & 3);                    // columns 8j + col0 (+1)
    const uint32_t ring = smem_u32(smem + F::kRing);

    float acc[NO], sc[NA], dp[NA], lse2[2], dlt[2];
    uint32_t da[BN / 16][4];
    int kv = 0;  // K/V tiles consumed so far
    for (int w = blockIdx.x, i = 0; w < n_tiles; w += gridDim.x, ++i) {
      const FwdTile tile(w, q_tiles, F::kRows);
      const int k_tiles = key_tiles(tile.q0);
      const int row0 = tile.q0 + r16;
      // the first q row of this warpgroup: a key tile wholly at or below it
      // is live for every row
      const int qw0 = tile.q0 + 64 * c;
      const uint32_t qaddr = smem_u32(smem + (i & 1) * F::kQdO + c * F::kQWG);
      const uint32_t oaddr = qaddr + F::kQ;
      const size_t qo = (size_t)tile.n * Lq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows past Lq: zero q and do, so dS = 0
        const int r = row0 + 8 * h;
        lse2[h] = r < Lq ? lse[qo + r] * kLog2e : 0.f;
        dlt[h] = r < Lq ? delta[qo + r] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[j] = 0.f;

      // S = Q K_t^T into sc and dP = dO V_t^T into dp (K-major tiles, 16
      // columns of hd a step)
      auto issue_sdp = [&](int t) {
        const uint32_t kaddr = ring + ((kv + t) % S) * 2 * F::kKV;
        const uint32_t vaddr = kaddr + F::kKV;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t a_off = (kk >> 2) * 64 * kRowBytes + (kk & 3) * 32;
          const uint32_t b_off = (kk >> 2) * BN * kRowBytes + (kk & 3) * 32;
          wgmma_ss(sc, desc(qaddr + a_off, kKMajor), desc(kaddr + b_off, kKMajor), kk > 0, T{});
          wgmma_ss(dp, desc(oaddr + a_off, kKMajor), desc(vaddr + b_off, kKMajor), kk > 0, T{});
        }
      };
      // dQ += dS K_t (dS from registers, K MN-major, 16 keys a step)
      auto issue_dsk = [&](int t) {
        const uint32_t kaddr = ring + ((kv + t) % S) * 2 * F::kKV;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs(acc, da[kk], desc(kaddr + kk * 16 * kRowBytes, BN * kRowBytes), T{});
      };
      auto scores = [&](int t) {
        const int k0 = t * BN;
        if (k0 + BN <= Lk && (!causal || k0 + BN - 1 <= qw0))
          dq_scores<false>(sc, dp, lse2, dlt, scale_log2, k0 + col0, row0, Lk, causal);
        else
          dq_scores<true>(sc, dp, lse2, dlt, scale_log2, k0 + col0, row0, Lk, causal);
      };
      auto pack_ds = [&] {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) frag_a<T>(da[kk], sc, kk);
      };
      auto full_of = [&](int t) {
        bar_wait(full + (kv + t) % S, ((kv + t) / S) & 1);
      };

      bar_wait(qfull + (i & 1), (i >> 1) & 1);
      if (k_tiles > 0) {
        full_of(0);
        wg_fence();
        issue_sdp(0);
        wg_commit();
        wg_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        scores(0);
        pack_ds();
      }
      for (int t = 1; t < k_tiles; ++t) {
        full_of(t);
        fence_regs(acc);
        wg_fence();
        issue_sdp(t);
        wg_commit();
        issue_dsk(t - 1);
        wg_commit();
        wg_wait<1>();  // S and dP of tile t are in; dS K of tile t - 1 runs on
        fence_regs(sc);
        fence_regs(dp);
        scores(t);
        wg_wait<0>();  // dS K of tile t - 1 is in: da and dQ are free
        fence_regs(acc);
        bar_arrive(empty + (kv + t - 1) % S);  // this thread is done with tile t - 1
        pack_ds();
      }
      if (k_tiles > 0) {
        fence_regs(acc);
        wg_fence();
        issue_dsk(k_tiles - 1);
        wg_commit();
        wg_wait<0>();
        fence_regs(acc);
        bar_arrive(empty + (kv + k_tiles - 1) % S);
      }
      bar_arrive(qempty + (i & 1));  // the producer may load the q tile after next
      kv += k_tiles;

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        if (r >= Lq) continue;  // rows past Lq are computed from zero q, never written
        T* row = dq + (qo + r) * HD + col0;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          store2(row + 8 * j, acc[4 * j + 2 * h] * sm_scale, acc[4 * j + 2 * h + 1] * sm_scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps and launches.
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (nothing
// new is linked), or null.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<T, mx::bf16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// The map of a contiguous (N, L, hd) tensor of T as a 3-D tensor (hd, L, N),
// read in boxes of 64 columns x box_rows rows of one head, in 128-byte
// swizzle; rows past L read as zeros.  An empty tensor (L = 0) is never
// read and gets no map.
template <typename T>
cudaError_t make_map(CUtensorMap* map, const void* base, int hd, int L, int N, int box_rows) {
  if (L == 0) return cudaSuccess;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)L, (cuuint64_t)N};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * sizeof(T), (cuuint64_t)L * hd * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)kBoxCols, (cuuint32_t)box_rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = encode(map, tma_type<T>(), 3, const_cast<void*>(base), dims, strides, box,
                            steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The current device's SMs: the persistent kernels' grid.
cudaError_t sm_count(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err
                            : cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HD>
cudaError_t fwd16(const void* q, const void* k, const void* v, void* out, float* lse, int N,
                  int Lq, int Lk, int causal, float sm_scale, cudaStream_t stream) {
  using F = Fwd16<HD>;
  CUtensorMap tq{}, tk{}, tv{};
  cudaError_t err = make_map<T>(&tq, q, HD, Lq, N, 64);
  if (err == cudaSuccess) err = make_map<T>(&tk, k, HD, Lk, N, F::kBN);
  if (err == cudaSuccess) err = make_map<T>(&tv, v, HD, Lk, N, F::kBN);
  if (err == cudaSuccess) err = allow_smem(flash_fwd16<T, HD>, F::kSmem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int tiles = (Lq + F::kRows - 1) / F::kRows;
  const int n_tiles = N * tiles;  // one block an SM walks over them
  flash_fwd16<T, HD><<<min(n_tiles, sms), kThreads, F::kSmem, stream>>>(
      tq, tk, tv, static_cast<T*>(out), lse, Lq, Lk, tiles, n_tiles, causal,
      sm_scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dkv16(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv, int N, int Lq, int Lk,
                  int causal, float sm_scale, cudaStream_t stream) {
  using B = Dkv16<HD>;
  CUtensorMap tq{}, tdo{}, tk{}, tv{};
  cudaError_t err = make_map<T>(&tq, q, HD, Lq, N, B::kBQ);
  if (err == cudaSuccess) err = make_map<T>(&tdo, dout, HD, Lq, N, B::kBQ);
  if (err == cudaSuccess) err = make_map<T>(&tk, k, HD, Lk, N, 64);
  if (err == cudaSuccess) err = make_map<T>(&tv, v, HD, Lk, N, 64);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dkv16<T, HD>, B::kSmem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int blocks = (Lk + B::kKeys - 1) / B::kKeys;
  const int n_tiles = N * blocks;  // one block an SM walks over them
  flash_bwd_dkv16<T, HD><<<min(n_tiles, sms), kThreads, B::kSmem, stream>>>(
      tq, tdo, tk, tv, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Lq, Lk, blocks,
      n_tiles, causal, sm_scale, sm_scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dq16(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, int N, int Lq, int Lk,
                 int causal, float sm_scale, cudaStream_t stream) {
  using F = Dq16<HD>;
  CUtensorMap tq{}, tdo{}, tk{}, tv{};
  cudaError_t err = make_map<T>(&tq, q, HD, Lq, N, 64);
  if (err == cudaSuccess) err = make_map<T>(&tdo, dout, HD, Lq, N, 64);
  if (err == cudaSuccess) err = make_map<T>(&tk, k, HD, Lk, N, F::kBN);
  if (err == cudaSuccess) err = make_map<T>(&tv, v, HD, Lk, N, F::kBN);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dq16<T, HD>, F::kSmem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int tiles = (Lq + F::kRows - 1) / F::kRows;
  const int n_tiles = N * tiles;  // one block an SM walks over them
  flash_bwd_dq16<T, HD><<<min(n_tiles, sms), kThreads, F::kSmem, stream>>>(
      tq, tdo, tk, tv, lse, delta, static_cast<T*>(dq), Lq, Lk, tiles, n_tiles, causal,
      sm_scale, sm_scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
struct Fwd_ {
  template <int HD, typename... A>
  static cudaError_t run(A... a) { return fwd16<T, HD>(a...); }
};
template <typename T>
struct Dq_ {
  template <int HD, typename... A>
  static cudaError_t run(A... a) { return dq16<T, HD>(a...); }
};
template <typename T>
struct Dkv_ {
  template <int HD, typename... A>
  static cudaError_t run(A... a) { return dkv16<T, HD>(a...); }
};

// F<T>::run<HD>(args...) for dtype 1 (bf16) or 2 (f16) and hd 64 or 128,
// else cudaErrorInvalidValue.
template <template <typename> class F, typename... Args>
int by_type_hd(int dtype, int hd, Args... args) {
  auto on_hd = [&](auto tag) -> int {
    using T = decltype(tag);
    if (hd == 64) return (int)F<T>::template run<64>(args...);
    if (hd == 128) return (int)F<T>::template run<128>(args...);
    return (int)cudaErrorInvalidValue;
  };
  if (dtype == mx::kBF16) return on_hd(mx::bf16{});
  if (dtype == mx::kF16) return on_hd(mx::f16{});
  return (int)cudaErrorInvalidValue;
}

bool bad_args(int N, int Lq, int Lk) { return N < 0 || Lq < 0 || Lk < 0; }

template <int HD>
cudaError_t fwd16_shape(int* rows, int* threads, int* smem, int* per_sm) {
  using F = Fwd16<HD>;
  *rows = F::kRows;
  *threads = kThreads;
  *smem = (int)F::kSmem;
  cudaError_t err = allow_smem(flash_fwd16<mx::bf16, HD>, F::kSmem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, flash_fwd16<mx::bf16, HD>,
                                                       kThreads, F::kSmem);
}

}  // namespace

extern "C" {

// The entry points take q, out, dout, dq: (N, Lq, hd); k, v, dk, dv: (N, Lk,
// hd), all contiguous, 16-byte aligned, of one 16-bit element type (dtype 1
// bf16, 2 f16); lse, delta: (N, Lq) f32; hd 64 or 128.  Each builds its
// tensor maps, launches once and returns cudaGetLastError() (or the error
// of a map or of the shared-memory opt-in); nothing is launched for an
// empty problem.

int mx_flash_attention_fwd16(const void* q, const void* k, const void* v, void* out, float* lse,
                             int dtype, int N, int Lq, int Lk, int hd, int causal,
                             float sm_scale, cudaStream_t stream) {
  if (bad_args(N, Lq, Lk)) return (int)cudaErrorInvalidValue;
  if (N == 0 || Lq == 0) return (int)cudaSuccess;
  return by_type_hd<Fwd_>(dtype, hd, q, k, v, out, lse, N, Lq, Lk, causal, sm_scale, stream);
}

int mx_flash_attention_dq16(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq, int dtype, int N,
                            int Lq, int Lk, int hd, int causal, float sm_scale,
                            cudaStream_t stream) {
  if (bad_args(N, Lq, Lk)) return (int)cudaErrorInvalidValue;
  if (N == 0 || Lq == 0) return (int)cudaSuccess;
  return by_type_hd<Dq_>(dtype, hd, q, k, v, dout, lse, delta, dq, N, Lq, Lk, causal, sm_scale,
                         stream);
}

int mx_flash_attention_dkv16(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv, int dtype,
                             int N, int Lq, int Lk, int hd, int causal, float sm_scale,
                             cudaStream_t stream) {
  if (bad_args(N, Lq, Lk)) return (int)cudaErrorInvalidValue;
  if (N == 0 || Lk == 0) return (int)cudaSuccess;
  return by_type_hd<Dkv_>(dtype, hd, q, k, v, dout, lse, delta, dk, dv, N, Lq, Lk, causal,
                          sm_scale, stream);
}

// K3's launch shape at head dim hd (64 or 128): q rows and threads of a
// block, its dynamic shared memory in bytes, and how many such blocks an SM
// holds.  A forward over N heads of Lq rows has N * ceil(Lq / rows) q
// tiles, walked by persistent blocks, at most one an SM.
int mx_flash_attention_fwd16_shape(int hd, int* rows, int* threads, int* smem_bytes,
                                   int* blocks_per_sm) {
  if (hd == 64) return (int)fwd16_shape<64>(rows, threads, smem_bytes, blocks_per_sm);
  if (hd == 128) return (int)fwd16_shape<128>(rows, threads, smem_bytes, blocks_per_sm);
  return (int)cudaErrorInvalidValue;
}

const char* mx_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
