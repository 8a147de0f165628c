#!/usr/bin/env python3
"""Drive the PyTorch port (``mxnet_tpu_torch``) on one CUDA card and check
it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ..., "ok": ...}``):

  device                  card name and power limit (nvidia-smi), torch and
                          CUDA versions, and the seconds the kernel build
                          took (one nvcc per ``csrc/*.cu``, all at once),
                          with each kernel's ``ptxas -v`` lines (registers,
                          spills); K3's block shape, shared memory and
                          blocks per SM at hd 16, 32, 64, 128 and 256; the floor of
                          back-to-back launches, a one-element in-place
                          add timed like the kernels (a yardstick only).
  kernel_layer_norm       kernel K1 vs its plain version at (8, 1024),
                          (64, 1024), (8192, 1024), BERT's training rows
                          (16384, 768) and Transformer-big's (2048, 1024)
                          and (2064, 1024) f32, atol 1e-5 on out,
                          mu and rstd; the same shapes in bf16 and f16, and
                          C 30, 8192 and 5001 in f32, bf16 and f16
                          (``ulp_ratio`` <= 1 on a 16-bit out, below); times
                          of the kernel, the plain version and
                          ``torch.nn.functional.layer_norm`` (the library
                          yardstick, never called by the port) beside the
                          bound.
  kernel_paged_attention  kernel K2 vs its plain version at the serving
                          path's shape (S 8, H 16, hd 64, pages of 16, 65-page
                          pools, P 9, ragged lengths with 0, 1, 16 and 132)
                          and at a long-context shape (lengths ~1000, P 64),
                          atol 1e-5; then both shapes with bf16 pools under
                          an f32 q, in f16 throughout, at hd 80 and 256 with
                          bf16 pools, and with sm_scale 0.3, each run twice
                          (bitwise equal); times beside the bound, with
                          ``scaled_dot_product_attention`` over the gathered
                          dense view as the library yardstick.
  serve                   Transformer-big (vocab 32000, 6+6 layers,
                          1024/4096, 16 heads) with seeded random weights
                          serves 16 requests with mid-flight arrivals through
                          ``ServingEngine`` (8 slots, pages of 16, max_len
                          128, sources padded to 64, stream_every 4).  The
                          launch counters are zeroed just before and read
                          just after: each kernel must have run exactly as
                          often as the path calls it (K1 18 times per decode
                          step and 12 per prefill, K2 6 times per step,
                          K3-K5 never: every attention there is masked).
                          TTFT p50 and p90 and queue-wait p50 from the
                          requests' stamps, and the engine's
                          ``statusz_snapshot()``.
  serve_parity            one request's encoder memory and first 4 decode
                          logits on the card vs the same weights on the CPU
                          through the plain versions, max abs diff <= 2e-3.
  serve_bf16              the serve cell with ``dtype="bfloat16"`` (bf16 KV
                          pools and encoder memory, f32 weights), then the
                          f32 engine again, both counted as in ``serve``;
                          tokens/s, decode-step ms and pool bytes of each, a
                          profile of the bf16 engine as ``serve_profile``
                          takes it, and card vs CPU memory and first 4
                          logits, both with bf16 pools, within the larger of
                          2e-3 and how far bf16 pools move the CPU's logits.
  serve_sampling          serve's traffic through ``sampling=True``: at
                          temperature 0 serve's tokens; requests 0-7 at
                          temperature 0.8, top_k 50, top_p 0.9 (seeds
                          100-107) and 8-15 greedy in engines of 8 and 5
                          slots: equal sampled streams, serve's greedy ones;
                          the greedy engine beside it (tokens/s, step ms);
                          20,000 sampler draws a row of one (8, 32000)
                          logits tensor within a TV distance of
                          sqrt(support / draws) of the filtered softmax.
  serve_spec              bench.py:1355's traffic at full width (8 requests,
                          8-token sources, 24 new tokens): plain, then
                          ``spec_k`` 4 and 1 with ``NGramDraft``, 3 trials
                          each; tokens equal plain's; proposed, accepted,
                          acceptance rate, tokens/s and verify-dispatch ms;
                          K1 18 (K+1) a verify + 18 a plain step + 12 a
                          prefill, K2 6 (K+1) a verify + 6 a plain step.
  serve_prefix            bench.py:1291's traffic at full width: 12
                          requests of 8 tokens forcing the first 24 tokens
                          of one source's greedy stream, 3 trials, the
                          prefix cache on and off: every stream is that
                          stream's tokens 24-31; hit rate, wall ratio
                          off/on, TTFT of hits and misses; pages back once
                          the entries drop; K1 18 x 8 an ingest dispatch.
  serve_beam              ``translate`` over serve's first 8 sources, beam
                          4, max_len 33 (K1 12 + 18 a beam step, K2 6 a
                          step); ``serve_beam`` equal to it, and
                          ``translate(beam_size=1)`` to the greedy engine;
                          ms a beam step, tokens/s.
  kernel_flash_attention  kernels K3 (FA2 forward), K4 (dq) and K5 (dk, dv)
                          vs the plain version (the forward, and
                          torch.autograd.grad through it for the backward)
                          at the training path's shape (N 384 = 32 x 12
                          heads, L 512, hd 64) and a causal one (N 6, L 200,
                          hd 128), timed; checked but not timed at hd 16
                          (N 8, L 96), hd 32 causal with Lq != Lk (N 4,
                          Lq 130, Lk 70), ragged hd 64 (N 8, Lq 200, Lk
                          333), and hd 48 causal through ``flash_attention``
                          (zero-padded to 64); atol 2e-5 on out and lse,
                          1e-4 on dq, dk and dv; K3, K4 and K5 run twice
                          and must agree bitwise.  K3's rows give the
                          blocks it launched.  Then bf16 and f16 at the two
                          timed shapes and hd 256 (N 48, L 512; causal N 6,
                          L 200) in f32 and bf16, timed the same way (16-bit
                          outputs by ``ulp_ratio``, lse atol 2e-5), the same
                          at hd 320 and 512 (chunks of 64 columns of D, a
                          launch per 64 output columns; 10 samples of 3
                          calls), and hd
                          200 through ``flash_attention`` (zero-padded to
                          256) in f32 and bf16, causal and not, checked.  Times of each kernel and its
                          plain version beside both bounds, with
                          ``scaled_dot_product_attention`` forward (K3) and
                          its backward (fwd+bwd minus fwd; dq, dk and dv in
                          one call, beside K4 and K5 and their sum
                          ``bwd_pair_ms``) as the library yardsticks.
  train                   BERT-base MLM (vocab 30522, 12 layers, 768/3072,
                          12 heads, dropout 0) with seeded random weights,
                          trained by ``DataParallelStep`` with Adam (lr
                          1e-4) on one fixed batch of 32 x 512 tokens, TF32
                          off: one warm-up step, then 5 timed steps with the
                          counters zeroed just before: K1 26, K3, K4 and K5
                          12 times per step; losses finite, the last below
                          the first; tokens/s, step ms, peak memory.
  train_parity            one forward and backward of the same weights on
                          the card and on the CPU (plain versions) on a
                          (2, 128) batch: loss within relative 1e-5, three
                          gradients within 1e-3 of their max abs.
  train_profile           2 training steps under torch.profiler: device
                          busy share, top kernels, K1 + K3-K5's share.
  kernel_add_layer_norm   kernel K6 (LN(x + res) in one pass) vs its plain
                          version at (16384, 768), (8192, 1024) and a
                          ragged (37, 768) f32, atol 1e-5 on out, mu and
                          rstd; times beside the bound, with ``x + r`` then
                          ``F.layer_norm`` (two calls) as the library
                          yardstick.
  kernel_softmax_cross_entropy
                          kernel K7 vs its plain version: the MLM logits
                          of BERT-base, (16384, 30522) f32 with
                          ignore_label -1 on 85% of the rows; all rows
                          live at the same shape; (64, 32000); an odd C
                          (33, 1001); and labels outside [0, C) with no
                          ignore label.  Loss atol 2e-5, and the gradient
                          through ``SoftmaxCrossEntropyFunction`` vs
                          autograd through the plain version, atol 1e-5.
                          Times beside the bound (the bytes of the rows
                          that are not ignored), with
                          ``F.cross_entropy(reduction="none",
                          ignore_index=-1)`` as the library yardstick
                          where every label is in [0, C) or -1.  Every case
                          again on bf16 and f16 logits (the loss f32 at
                          atol 2e-5, the gradient by ``ulp_ratio``).  Then
                          the path ``softmax_cross_entropy``: counters zeroed,
                          one forward and backward at the MLM shape; K7
                          must launch once.
  imperative              the MXNet imperative API on the card at
                          BERT-base's widths: NDArrays with attach_grad,
                          under ``autograd.record()``, through
                          ``nd.contrib.add_layer_norm`` (16384, 768),
                          ``nd.LayerNorm``, ``nd.contrib.flash_attention``
                          (N 384, L 512, hd 64), ``nd.FullyConnected`` to
                          the 30522-word vocabulary and the
                          ``softmax_cross_entropy`` op, then
                          ``backward()``; under
                          ``PassPipeline([FusedKernelPass()])`` (launches
                          exactly K6 1, K1 1, K3-K5 1 each per run) and
                          with no pass (K6 0, the rest as before), after a
                          warm-up of each, three runs of each in turns,
                          their median host ms.  Loss within relative
                          1e-5 and every gradient within 1e-3 of its max
                          abs between the two; then the card vs the CPU
                          (plain versions) on a (2 x 128)-token batch
                          with the pass on, the same tolerances.  Two
                          more runs with the pass under torch.profiler:
                          device busy share and the top kernels per run.
  imperative_bf16         the same path with every array in bf16 (K6, K1
                          and K3-K5 in bf16 from the MXNet entry points),
                          pass on and off with the same launches, on vs off
                          and the card vs the CPU at a (2 x 128)-token batch:
                          loss within 2^-6 relative (two bf16 units), every
                          gradient within 2^-5 of its max abs.
  train_bf16              (after train_profile) BERT-base cast to bf16 as
                          bench.py:677 does, Adam lr 1e-4, the train cell's
                          batch: one warm-up and 5 timed steps, K1 26 and
                          K3-K5 12 launches a step; losses finite and
                          falling; tokens/s, step ms and peak memory beside
                          the f32 train phase's; one profiled step with
                          K3-K5's share of the busy time.
  train_resnet            resnet50_v1b (BASELINE config 2), f32, NCHW,
                          batch 256 at 224^2, seeded weights and images,
                          SGD lr 0.1, momentum 0.9, wd 1e-4 (bench.py:781),
                          cuDNN autotuning on, TF32 off: 2 warm-up and 5
                          timed steps; images/s, step ms, peak memory, the
                          losses (finite), the model-FLOP share (conv and
                          dense FLOPs over median step ms x 67 TFLOP/s);
                          every kernel counter 0, every module output
                          contiguous.
  train_resnet_bf16       the same in NHWC and bf16 (bf16 images), as
                          bench_resnet runs on the TPU, against 989 TFLOP/s;
                          one profiled step with no NCHW<->NHWC transpose
                          kernel among its top 20.
  train_resnet_parity     resnet50_v1b on the card vs the CPU, NCHW and
                          NHWC, one training forward and backward of a
                          (4, 3, 64, 64) batch: logits, loss, three
                          gradients and every running stat, at tolerances
                          5x the CPU's own f32-vs-float64 spread.
  train_resnet_profile    one profiled step of each ResNet cell: busy share,
                          top kernels, the largest gaps between device
                          activities.
  train_transformer       Transformer-big (BASELINE config 4) trained as
                          bench_transformer trains it (bench.py:706-751):
                          vocab 32000, dropout 0.3, f32, 210,173,952
                          parameters, seeded weights; sources 16 x 128 and
                          targets 16 x 129 from RandomState(0) as
                          bench.py:735-743 makes them; Adam lr 1e-4 on
                          ``label_smoothed_ce(smoothing=0.1)`` through
                          ``DataParallelStep.step((src, tgt_in), label)``:
                          2 warm-up and 5 timed steps, K1 exactly 30
                          launches a step and K2-K7 none (every attention is
                          masked); losses finite, the last below the first;
                          train tokens/s (16 x 129 x 5 / wall s, as
                          bench.py:745 counts), step ms, peak memory, and
                          one profiled step: busy share, top kernels, K1's
                          share.
  train_transformer_bf16  the same after ``gluon.block.cast(model,
                          "bfloat16")``, as bench.py:729-730 casts it.
  train_transformer_parity
                          Transformer-big's widths at 2 + 2 layers, dropout
                          0, on the card vs the CPU from the same weights: a
                          padded batch (4 x 32 sources, 33-token targets),
                          2 Adam steps under a CosineScheduler with warmup,
                          clip_global_norm 1.0 and one parameter at lr_mult
                          0.5; then again with accum_steps 2 and remat.
                          The yardstick is the CPU in float64, LayerNorms
                          included.  First one forward and backward on the
                          card, on the CPU and in float64: the card's
                          gradient within 1e-5 (relative L2) of float64's,
                          the CPU's beside it, and the witness of their
                          gap, the FFN ReLU inputs whose sign differs from
                          float64's.  Then the runs on all three: losses
                          within 1e-5 relative of float64's and of the
                          CPU's, the card's update within 5e-4 (relative
                          L2) of float64's over the model and 2e-2 in any
                          tensor, where float64's gradient is not rounding
                          noise (TT_PARITY_TOL); K1 20 launches in the
                          first run and 80 in the second (a forward and
                          its recomputation per microbatch).
  optimizer               the imperative optimizer path: each of the 11
                          classes (SGD, NAG, Adam, Adamax, Nadam, AdaGrad,
                          AdaDelta, RMSProp, Ftrl, Signum, LAMB) through
                          ``Updater`` for 3 updates of one BERT-base layer's
                          parameter shapes, a FactorScheduler on and one
                          parameter at lr_mult 0.5, on the card vs the CPU
                          (rtol 1e-5, atol 1e-6); SGD, Adam and RMSProp
                          through ``FusedUpdater.apply`` vs per parameter
                          on the card (rtol 1e-6, atol 1e-7); and
                          ``gluon.utils.clip_global_norm`` card vs CPU.
  gluon_mnist             BASELINE config 1 as ``examples/train_mnist.py``
                          runs it, on the port: LeNet through
                          ``HybridSequential`` with deferred shapes,
                          ``initialize(Xavier)``, ``hybridize()``, Adam lr
                          0.01 through ``gluon.Trainer``,
                          ``SoftmaxCrossEntropyLoss``, ``metric.Accuracy``,
                          3 epochs of ``synthetic_mnist(2048)`` at batch 64
                          on ``cuda:0``: train accuracy > 0.95 (the
                          example's gate), every kernel counter 0, one
                          CachedOp entry; images/s and step ms of each
                          epoch, 8 profiled steps (busy share).
  gluon_bert              BERT-base (vocab 30522, dropout 0) at 32 x 512
                          through the Gluon loop: ``initialize(Normal(0.02))``,
                          ``hybridize()``, ``gluon.Trainer`` Adam lr 1e-4,
                          ``autograd.record()`` -> per-token
                          ``SoftmaxCrossEntropyLoss`` -> ``backward()`` ->
                          ``trainer.step(32 * 512)``; 2 warm-up and 5 timed
                          steps with the counters zeroed just before: K1 26
                          and K3-K5 12 a step, the loss falling, every
                          Parameter through ``FusedUpdater.apply``, one
                          CachedOp entry for the training signature;
                          tokens/s, step ms and peak memory beside the
                          ``train`` phase's, the host ms of a recorded 1 x 8
                          forward as an NDArray call and as a tensor call,
                          one profiled step.
  gluon_bert_parity       BERT-base initialized on the CPU, carried by
                          ``save_parameters`` / ``load_parameters``; one
                          Trainer step on a (2, 128) batch on the card, on
                          the CPU and on the CPU in float64 (LayerNorms
                          too): loss, gradient and update of the card
                          against float64's and the f32 CPU's, relative L2
                          over the model and in the worst tensor
                          (GB_PARITY_TOL).

16-bit outputs are held to ``ulp_ratio`` <= 1: |kernel - plain| at most
two units in the last place of the plain value plus one unit at the
tensor's largest value, since both sides compute in f32 and round once.

Then the card's nvidia-smi line, one ``{"kernels": [...]}`` line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed phase makes
the script exit non-zero without that line, as does a machine without
CUDA or a directory without the package.

Times are CUDA-event medians of 25 samples of 10 back-to-back calls each
(at K7's (16384, 30522) shapes 10 samples of 5, and 5 of 2 for its plain
version), enqueued behind a device sleep so that host-side launch cost
does not show as device time.  ``bound_ms`` is the larger of the bytes the
function must move over 3.35 TB/s and its f32 operations over 67 TFLOP/s
(the H100 SXM data sheet at 700 W); for K3-K5 the operations are f32-
accurate products on the tensor cores, three TF32 products each (3xTF32)
at 495 TFLOP/s, and the CUDA-core figure stays beside it as
``bound_f32_cores_ms``.  No kernel may read faster than its bound.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12  # dense, on the tensor cores
BF16_FLOPS_PER_S = 989e12  # dense bf16 or f16, on the tensor cores
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(n_bytes: float, n_flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_3xtf32(n_bytes: float, n_flops: float):
    """The bound of f32-accurate products on the tensor cores: each f32
    product is three TF32 ones (3xTF32), at the dense TF32 rate."""
    return bound(n_bytes, 3 * n_flops, TF32_FLOPS_PER_S)


# 16-bit outputs: both sides compute in f32 and round once to the type, so
# an element may differ by a unit in its last place where the f32 values
# straddle a rounding boundary; the tolerance is two units relative to the
# plain version's value plus one unit at the tensor's scale (max |value|)
EPS16 = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


def ulp_ratio(got, want, eps: float) -> float:
    """max |got - want| / (2 eps |want| + eps max|want|): <= 1 passes."""
    g, w = got.detach().float(), want.detach().float()
    allow = 2 * eps * w.abs() + eps * float(w.abs().max()) + 1e-30
    return float(((g - w).abs() / allow).max())


def time_ms(torch, fn, samples: int = 25, reps: int = 10) -> float:
    """Median device ms per call of ``fn``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # hold the device while the host enqueues the sample, so the
        # events bracket back-to-back device work only
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device(torch, ctx):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    ctx["smi"] = smi
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mxnet_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    from mxnet_tpu_torch.ops.kernels.flash_attention import (HEAD_DIMS,
                                                             _fwd_shape)

    # K3's launch shape per head dim; its registers and spills are in the
    # ptxas lines of flash_fwd<float, hd, ...> below
    k3 = {hd: _fwd_shape(hd) for hd in HEAD_DIMS + (320,)}
    # the floor of back-to-back launches: a one-element in-place add, a
    # yardstick that no path of the port calls
    one = torch.zeros(1, device=torch.device("cuda", 0))
    floor_ms = time_ms(torch, lambda: one.add_(1.0))
    return {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0],
            "build_s": build_s, "launch_floor_ms": floor_ms,
            "launch_floor_is": "one-element in-place add on cuda:0, "
                               "back to back",
            "flash_fwd_f32": k3,
            "ptxas": {k: _ptxas(v) for k, v in _build.BUILD_LOG.items()}}


def _ptxas(log: str) -> list:
    """The per-kernel lines of ``ptxas -v`` (mangled name, then its
    registers, shared memory and spills), as nvcc printed them."""
    return [line.strip() for line in log.splitlines()
            if "Function properties" in line or "spill" in line
            or "Used" in line]


def phase_layer_norm(torch, ctx):
    from mxnet_tpu_torch.ops.kernels import layer_norm, layer_norm_ref

    F = torch.nn.functional
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    shapes, worst = [], 0.0
    for n, c in LN_SHAPES + _beam_ln_shapes():
        x = torch.randn(n, c, device=dev, generator=g) * 2 + 0.5
        gamma = torch.randn(c, device=dev, generator=g)
        beta = torch.randn(c, device=dev, generator=g)
        got = layer_norm(x, gamma, beta)
        want = layer_norm_ref(x, gamma, beta)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        worst = max(worst, err)
        b_ms, b_by = bound(4 * (2 * n * c + 2 * c + 2 * n), 8 * n * c)
        shapes.append({
            "shape": [n, c], "max_abs_err": err, "ok": err <= 1e-5,
            "ms": time_ms(torch, lambda: layer_norm(x, gamma, beta)),
            "plain_ms": time_ms(torch, lambda: layer_norm_ref(x, gamma,
                                                              beta)),
            "library_ms": time_ms(torch, lambda: F.layer_norm(
                x, (c,), gamma, beta, 1e-5)),
            "bound_ms": b_ms, "bound_by": b_by})
    ctx["layer_norm"] = dict(shapes[0], max_abs_err=worst)
    more = _ln_rows(torch, g, fused=False)
    return {"atol": 1e-5, "shapes": shapes, "dtypes_and_widths": more,
            "tol_16bit": "ulp_ratio <= 1 on out; mu, rstd atol 1e-5",
            "ok": all(s["ok"] for s in shapes + more)}


# decode (8) and prefill (64) rows of Transformer-big, a large batch at
# its width, the training path's 32 x 512 rows of BERT-base, and
# Transformer-big's training rows: the encoder's 16 x 128 and the
# decoder's 16 x 129
LN_SHAPES = ((8, 1024), (64, 1024), (8192, 1024), (16384, 768),
             (2048, 1024), (2064, 1024))
# the same shapes again in 16 bits; then widths the warp-per-row path does
# not take: C 30 (no 16-byte vector), 8192 (a block per row, the row
# staged in shared memory) and 5001 (odd: a block per row with scalar
# loads)
LN_SHAPES_16 = LN_SHAPES


def _beam_ln_shapes():
    """serve_beam's rows: the decoder's 8 x 4 beam rows, and the encoder's
    8 sources padded to the longest of serve's first 8 (f32 only)."""
    width = max(r.tokens.size for r in _requests(16, 32000, SEED)[0][:8])
    return ((32, 1024), (8 * width, 1024))
LN_WIDTHS = ((37, 30), (16, 8192), (16, 5001))


def _ln_rows(torch, g, fused: bool):
    """K1 (or K6) against its plain version in bf16 and f16 at the path
    shapes and in every dtype at the new widths, timed; K6 also with a
    residual of its own type (bf16 x, f32 res)."""
    cases = [(n, c, dt, None) for dt in ("bfloat16", "float16")
             for n, c in LN_SHAPES_16]
    cases += [(n, c, dt, None) for dt in ("float32", "bfloat16", "float16")
              for n, c in LN_WIDTHS]
    if fused:
        cases.append((37, 768, "bfloat16", "float32"))
    return [_ln_row(torch, g, *case, fused=fused) for case in cases]


def _ln_row(torch, g, n, c, dtype, res_dtype, fused):
    from mxnet_tpu_torch.ops.kernels import (add_layer_norm,
                                             add_layer_norm_ref, layer_norm,
                                             layer_norm_ref)

    F = torch.nn.functional
    dev = g.device
    dt = getattr(torch, dtype)
    x = (torch.randn(n, c, device=dev, generator=g) * 2 + 0.5).to(dt)
    r = torch.randn(n, c, device=dev, generator=g).to(
        getattr(torch, res_dtype or dtype))
    gamma = torch.randn(c, device=dev, generator=g)
    beta = torch.randn(c, device=dev, generator=g)
    kern, plain = ((add_layer_norm, add_layer_norm_ref) if fused
                   else (layer_norm, layer_norm_ref))
    args = (x, r, gamma, beta) if fused else (x, gamma, beta)
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    stats_err = max(float((a - b).abs().max())
                    for a, b in zip(got[1:], want[1:]))
    if dtype == "float32":
        out_err = float((got[0] - want[0]).abs().max())
        ok = out_err <= 1e-5
        err = {"max_abs_err": out_err}
    else:
        ratio = ulp_ratio(got[0], want[0], EPS16[dtype])
        ok = ratio <= 1
        err = {"max_abs_err": float((got[0].float() - want[0].float())
                                    .abs().max()), "ulp_ratio": ratio}
    rows = n * c * (x.element_size() * 2 + (r.element_size() if fused
                                            else 0))
    b_ms, b_by = bound(rows + 4 * (2 * c + 2 * n), (9 if fused else 8) * n * c)
    lib_x = (lambda: x + r.to(dt)) if fused else (lambda: x)
    return {"shape": [n, c], "dtype": dtype,
            **({"res_dtype": res_dtype} if res_dtype else {}), **err,
            "stats_max_abs_err": stats_err,
            "ok": ok and stats_err <= 1e-5,
            "ms": time_ms(torch, lambda: kern(*args)),
            "plain_ms": time_ms(torch, lambda: plain(*args)),
            "library_ms": time_ms(torch, lambda: F.layer_norm(
                lib_x(), (c,), gamma.to(dt), beta.to(dt), 1e-5)),
            "bound_ms": b_ms, "bound_by": b_by}


def _paged_case(torch, g, S, H, hd, ps, P, lengths):
    """Pools and a page table whose live entries are distinct pages."""
    dev = g.device
    n_live = [math.ceil(L / ps) for L in lengths]
    N = 1 + sum(n_live)
    kp = torch.randn(N, ps, H, hd, device=dev, generator=g)
    vp = torch.randn(N, ps, H, hd, device=dev, generator=g)
    q = torch.randn(S, H, hd, device=dev, generator=g)
    perm = list(1 + np.random.RandomState(SEED).permutation(N - 1))
    table = np.zeros((S, P), np.int32)
    for s, k in enumerate(n_live):
        table[s, :k] = perm[:k]
        perm = perm[k:]
    return (q, kp, vp, torch.from_numpy(table).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def phase_paged_attention(torch, ctx):
    from mxnet_tpu_torch.ops.kernels import (paged_decode_attention,
                                             paged_decode_attention_ref)

    F = torch.nn.functional
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    H, hd, ps = 16, 64, 16
    # (slots, table width, lengths, pool pages): the serving path's 8
    # slots over a pool of 8 * 8 + 1 pages (also the verify and ingest
    # dispatches' shape), a long context, and serve_beam's 8 x 4 beam
    # rows over translate's 3-page runs in a pool of 32 * 3 + 1 pages at
    # every length a 33-token beam search attends
    cases = {"path": (8, 9, [0, 1, 16, 132, 37, 64, 100, 5], 65),
             "long_context": (8, 64, [1000 + 3 * s for s in range(8)], None),
             "beam": (32, 3, [1 + (32 * s) // 31 for s in range(32)], 97)}
    out = []
    for name, (S, P, lengths, pool) in cases.items():
        q, kp, vp, table, lens = _paged_case(torch, g, S, H, hd, ps, P,
                                             lengths)
        if pool is not None:
            pad = pool - kp.shape[0]
            kp = torch.cat([kp, torch.randn(pad, ps, H, hd, device=dev,
                                            generator=g)])
            vp = torch.cat([vp, torch.randn(pad, ps, H, hd, device=dev,
                                            generator=g)])
        args = (q, kp, vp, table, lens)
        got = paged_decode_attention(*args)
        want = paged_decode_attention_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        zero_ok = all(bool((got[s] == 0).all())
                      for s, L in enumerate(lengths) if L == 0)
        # the library yardstick: SDPA over the gathered dense view
        idx = table.reshape(-1).long()
        K = kp.index_select(0, idx).reshape(S, P * ps, H, hd).transpose(1, 2)
        V = vp.index_select(0, idx).reshape(S, P * ps, H, hd).transpose(1, 2)
        K, V = K.contiguous(), V.contiguous()
        keep = (torch.arange(P * ps, device=dev)[None] < lens[:, None].long())
        mask = keep[:, None, None, :]
        q4 = q[:, :, None, :]
        live = sum(min(L, P * ps) for L in lengths)
        n_bytes = (live * H * hd * 2 * 4 + 2 * S * H * hd * 4
                   + table.numel() * 4 + S * 4)
        b_ms, b_by = bound(n_bytes, 4 * live * H * hd)
        out.append({
            "case": name, "S": S, "H": H, "hd": hd, "page_size": ps,
            "pool_pages": kp.shape[0], "P": P, "lengths": lengths,
            "max_abs_err": err, "zeros_for_length_0": zero_ok,
            "ok": err <= 1e-5 and zero_ok,
            "ms": time_ms(torch, lambda: paged_decode_attention(*args)),
            "plain_ms": time_ms(torch,
                                lambda: paged_decode_attention_ref(*args)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, K, V, attn_mask=mask)),
            "bound_ms": b_ms, "bound_by": b_by})
    ctx["paged_decode_attention"] = dict(
        out[0], max_abs_err=max(c["max_abs_err"] for c in out))
    # 16-bit pools under an f32 q (the JAX engine's bf16 serving), f16
    # throughout, head dims 80 and 256 with bf16 pools, and a scale of
    # the caller's, each at both shapes, run twice (bitwise equal)
    more = [_paged_row(torch, g, S, H, hd, ps, P, lengths, name, q_dt, kv_dt)
            for hd, q_dt, kv_dt in ((64, "float32", "bfloat16"),
                                    (64, "float16", "float16"),
                                    (80, "float32", "bfloat16"),
                                    (256, "float32", "bfloat16"))
            for name, (S, P, lengths, _) in cases.items() if name != "beam"]
    S, P, lengths, _ = cases["path"]
    more.append(_paged_row(torch, g, S, H, hd, ps, P, lengths, "path",
                           "float32", "float32", sm_scale=0.3))
    return {"atol": 1e-5, "cases": out, "dtypes_and_widths": more,
            "tol_16bit": "atol 1e-5 where out is f32 (an f32 q), else "
                         "ulp_ratio <= 1",
            "ok": all(c["ok"] for c in out + more)}


def _paged_row(torch, g, S, H, hd, ps, P, lengths, name, q_dt, kv_dt,
               sm_scale=None):
    from mxnet_tpu_torch.ops.kernels import (paged_decode_attention,
                                             paged_decode_attention_ref)

    F = torch.nn.functional
    dev = g.device
    q, kp, vp, table, lens = _paged_case(torch, g, S, H, hd, ps, P, lengths)
    q = q.to(getattr(torch, q_dt))
    kp, vp = (t.to(getattr(torch, kv_dt)) for t in (kp, vp))
    args = (q, kp, vp, table, lens)
    got = paged_decode_attention(*args, sm_scale=sm_scale)
    again = paged_decode_attention(*args, sm_scale=sm_scale)
    want = paged_decode_attention_ref(*args, sm_scale=sm_scale)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    zero_ok = all(bool((got[s] == 0).all())
                  for s, L in enumerate(lengths) if L == 0)
    same = bool(torch.equal(got, again))
    if q_dt == "float32":
        tol_ok, extra = err <= 1e-5, {}
    else:
        ratio = ulp_ratio(got, want, EPS16[q_dt])
        tol_ok, extra = ratio <= 1, {"ulp_ratio": ratio}
    idx = table.reshape(-1).long()
    K = kp.index_select(0, idx).reshape(S, P * ps, H, hd).transpose(1, 2)
    V = vp.index_select(0, idx).reshape(S, P * ps, H, hd).transpose(1, 2)
    K, V = K.to(q.dtype).contiguous(), V.to(q.dtype).contiguous()
    keep = torch.arange(P * ps, device=dev)[None] < lens[:, None].long()
    q4 = q[:, :, None, :]
    live = sum(min(L, P * ps) for L in lengths)
    n_bytes = (live * H * hd * 2 * kp.element_size()
               + 2 * S * H * hd * q.element_size() + table.numel() * 4 + S * 4)
    b_ms, b_by = bound(n_bytes, 4 * live * H * hd)
    return {"case": name, "hd": hd, "q_dtype": q_dt, "pool_dtype": kv_dt,
            **({"sm_scale": sm_scale} if sm_scale is not None else {}),
            "P": P, "max_abs_err": err, **extra,
            "zeros_for_length_0": zero_ok, "bitwise_repeatable": same,
            "ok": tol_ok and zero_ok and same,
            "ms": time_ms(torch, lambda: paged_decode_attention(
                *args, sm_scale=sm_scale)),
            "plain_ms": time_ms(torch, lambda: paged_decode_attention_ref(
                *args, sm_scale=sm_scale)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, K, V, attn_mask=keep[:, None, None, :], scale=sm_scale)),
            "bound_ms": b_ms, "bound_by": b_by}


def _live_pairs(Lq, Lk, causal):
    """(q, k) pairs the attention must compute: all, or those on and
    below the diagonal."""
    if not causal:
        return Lq * Lk
    return sum(min(i + 1, Lk) for i in range(Lq))


def _flash_inputs(torch, g, N, Lq, Lk, D):
    dev = g.device
    return (torch.randn(N, Lq, D, device=dev, generator=g),
            torch.randn(N, Lk, D, device=dev, generator=g),
            torch.randn(N, Lk, D, device=dev, generator=g),
            torch.randn(N, Lq, D, device=dev, generator=g))


def _flash_errors(torch, q, k, v, do, causal, eps=None):
    """K3-K5 once, and each once more (bitwise equal: no atomics), against
    the plain forward and autograd through it; with ``eps`` (16-bit
    inputs) also the ulp ratios of out, dq, dk and dv."""
    from mxnet_tpu_torch.ops.kernels import (flash_attention_dkv,
                                             flash_attention_dq,
                                             flash_attention_fwd,
                                             flash_attention_ref)

    out, lse = flash_attention_fwd(q, k, v, causal)
    out2, lse2 = flash_attention_fwd(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, causal, 1.0 / math.sqrt(q.shape[-1]))
    dq = flash_attention_dq(*args)
    dk, dv = flash_attention_dkv(*args)
    again = (flash_attention_dq(*args), *flash_attention_dkv(*args))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out_r, lse_r = flash_attention_ref(*leaves, causal)
    want = torch.autograd.grad(out_r, leaves, do)
    torch.cuda.synchronize()
    got = {"out": (out, out_r), "lse": (lse, lse_r), "dq": (dq, want[0]),
           "dk": (dk, want[1]), "dv": (dv, want[2])}
    err = {key: float((a.float() - b.detach().float()).abs().max())
           for key, (a, b) in got.items()}
    same = all(bool(torch.equal(a, b)) for a, b in zip((dq, dk, dv), again))
    fwd_same = bool(torch.equal(out, out2)) and bool(torch.equal(lse, lse2))
    ratios = {key: ulp_ratio(a, b, eps) for key, (a, b) in got.items()
              if key != "lse"} if eps else {}
    return err, same, fwd_same, args, ratios


def _padded_head_dim_case(torch, g, N, L, D, causal, tol,
                          dtype="float32"):
    """``flash_attention`` at a head dim the kernels do not take (zero-
    padded to the next one): out and the gradients of q, k and v against
    autograd through the plain forward at D (16-bit: by ulp ratio)."""
    from mxnet_tpu_torch.ops.kernels import (flash_attention,
                                             flash_attention_ref)

    q, k, v, do = (t.to(getattr(torch, dtype))
                   for t in _flash_inputs(torch, g, N, L, L, D))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal=causal)
    grads = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out_r, _ = flash_attention_ref(*ref_leaves, causal)
    want = torch.autograd.grad(out_r, ref_leaves, do)
    torch.cuda.synchronize()
    pairs = {"out": (out, out_r), **dict(zip(("dq", "dk", "dv"),
                                             zip(grads, want)))}
    err = {n: float((a.detach().float() - b.detach().float()).abs().max())
           for n, (a, b) in pairs.items()}
    row = {"case": f"padded_hd{D}", "dtype": dtype, "N": N, "Lq": L,
           "Lk": L, "hd": D, "causal": causal, "errors": err}
    if dtype == "float32":
        return dict(row, ok=all(err[key] <= tol[key] for key in err))
    ratios = {n: ulp_ratio(a, b, EPS16[dtype]) for n, (a, b) in pairs.items()}
    return dict(row, ulp_ratios=ratios,
                ok=all(r <= 1 for r in ratios.values()))


def phase_flash_attention(torch, ctx):
    from mxnet_tpu_torch.ops.kernels import (flash_attention_dkv,
                                             flash_attention_dkv_ref,
                                             flash_attention_dq,
                                             flash_attention_dq_ref,
                                             flash_attention_fwd,
                                             flash_attention_ref)
    from mxnet_tpu_torch.ops.kernels.flash_attention import _fwd_shape

    F = torch.nn.functional
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    # the training path's attention (batch 32 x 12 heads), and a causal
    # head-dim-128 shape with a ragged last tile
    cases = {"train": (32 * 12, 512, 512, 64, False),
             "causal_hd128": (6, 200, 200, 128, True)}
    # checked, not timed: hd 16 and 32, Lq != Lk, ragged tiles
    checked = {"hd16": (8, 96, 96, 16, False),
               "hd32_causal_lq_ne_lk": (4, 130, 70, 32, True),
               "ragged_hd64": (8, 200, 333, 64, False)}
    tol = {"out": 2e-5, "lse": 2e-5, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4}
    outputs = {"flash_attention_fwd": ("out", "lse"),
               "flash_attention_dq": ("dq",),
               "flash_attention_dkv": ("dk", "dv")}
    out_rows = {name: [] for name in outputs}
    checks, pairs_out = [], []
    for name, (N, Lq, Lk, D, causal) in checked.items():
        err, same, fwd_same, _, _ = _flash_errors(
            torch, *_flash_inputs(torch, g, N, Lq, Lk, D), causal)
        checks.append({"case": name, "N": N, "Lq": Lq, "Lk": Lk, "hd": D,
                       "causal": causal, "errors": err,
                       "fwd_bitwise_repeatable": fwd_same,
                       "bwd_bitwise_repeatable": same,
                       "ok": same and fwd_same and all(err[key] <= tol[key]
                                                       for key in err)})
    checks.append(_padded_head_dim_case(torch, g, 4, 100, 48, True, tol))
    for name, (N, Lq, Lk, D, causal) in cases.items():
        q, k, v, do = _flash_inputs(torch, g, N, Lq, Lk, D)
        err, same, fwd_same, args, _ = _flash_errors(torch, q, k, v, do,
                                                     causal)
        rows_k3 = _fwd_shape(D)["rows"]

        pairs = _live_pairs(Lq, Lk, causal)
        nq, nk = N * Lq * D * 4, N * Lk * D * 4
        rows = N * Lq * 4
        work = {"flash_attention_fwd": (2 * nq + 2 * nk + rows,
                                        4 * N * pairs * D),
                "flash_attention_dq": (3 * nq + 2 * nk + 2 * rows,
                                       6 * N * pairs * D),
                "flash_attention_dkv": (2 * nq + 4 * nk + 2 * rows,
                                        8 * N * pairs * D)}
        q4, k4, v4, do4 = (t[None] for t in (q, k, v, do))
        sdpa_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal))
        l4 = [t.clone().requires_grad_() for t in (q4, k4, v4)]
        sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*l4, is_causal=causal), l4,
            do4)) - sdpa_fwd
        timed = {
            "flash_attention_fwd": (
                lambda: flash_attention_fwd(q, k, v, causal),
                lambda: flash_attention_ref(q, k, v, causal), sdpa_fwd),
            "flash_attention_dq": (
                lambda: flash_attention_dq(*args),
                lambda: flash_attention_dq_ref(*args), sdpa_bwd),
            "flash_attention_dkv": (
                lambda: flash_attention_dkv(*args),
                lambda: flash_attention_dkv_ref(*args), sdpa_bwd),
        }
        for kname, (kern, plain, lib_ms) in timed.items():
            keys = outputs[kname]
            e = max(err[key] for key in keys)
            b_ms, b_by = bound_3xtf32(*work[kname])
            ms = time_ms(torch, kern)
            fwd = kname == "flash_attention_fwd"
            out_rows[kname].append({
                "case": name, "N": N, "Lq": Lq, "Lk": Lk, "hd": D,
                "causal": causal, "max_abs_err": e,
                "bwd_bitwise_repeatable": same,
                **({"fwd_bitwise_repeatable": fwd_same,
                    "blocks": N * -(-Lq // rows_k3)} if fwd else {}),
                "ok": all(err[key] <= tol[key] for key in keys)
                and same and (fwd_same or not fwd) and ms >= b_ms,
                "ms": ms, "plain_ms": time_ms(torch, plain),
                "library_ms": lib_ms, "over_library": ms / lib_ms,
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_f32_cores_ms": bound(*work[kname])[0]})
        pair = (out_rows["flash_attention_dq"][-1]["ms"]
                + out_rows["flash_attention_dkv"][-1]["ms"])
        pairs_out.append({"case": name, "bwd_pair_ms": pair,
                          "library_ms": sdpa_bwd,
                          "bwd_pair_over_library": pair / sdpa_bwd})
        for kname in ("flash_attention_dq", "flash_attention_dkv"):
            out_rows[kname][-1]["bwd_pair_ms"] = pair
        del l4
        torch.cuda.empty_cache()
    for kname, rows_ in out_rows.items():
        checked_err = [c["errors"][key] for c in checks
                       for key in outputs[kname] if key in c["errors"]]
        ctx[kname] = dict(rows_[0], max_abs_err=max(
            [r["max_abs_err"] for r in rows_] + checked_err))
        ctx[kname]["library_is"] = (
            "scaled_dot_product_attention forward" if kname.endswith("fwd")
            else "scaled_dot_product_attention backward (dq, dk and dv in "
                 "one call: fwd+bwd minus fwd)")
    more = _flash_rows_16bit_and_wide(torch, g, tol)
    checks += [_padded_head_dim_case(torch, g, 4, 100, 200, causal, tol, dt)
               for dt in ("float32", "bfloat16") for causal in (False, True)]
    return {"tol": tol, "kernels": out_rows, "bwd_pairs": pairs_out,
            "checked": checks, "dtypes_and_widths": more,
            "tol_16bit": "ulp_ratio <= 1 on out, dq, dk, dv; lse atol 2e-5",
            "bound_is": "bound_ms: bytes / 3.35 TB/s or 3 x f32 operations "
                        "/ 495 TFLOP/s (3xTF32 on the tensor cores); "
                        "bound_f32_cores_ms: f32 operations / 67 TFLOP/s",
            "ok": all(r["ok"] for rows_ in out_rows.values() for r in rows_)
            and all(c["ok"] for c in checks + more)}


# name: (N, Lq, Lk, D, causal) and the dtypes each runs in: the training
# and causal shapes in 16 bits, head dim 256 (two column windows), and
# head dims 320 and 512 (chunks of 64 columns of D, a launch per 64 output
# columns)
FLASH_MORE = {"train": ((32 * 12, 512, 512, 64, False),
                        ("bfloat16", "float16")),
              "causal_hd128": ((6, 200, 200, 128, True),
                               ("bfloat16", "float16")),
              "hd256": ((48, 512, 512, 256, False), ("float32", "bfloat16")),
              "hd256_causal": ((6, 200, 200, 256, True),
                               ("float32", "bfloat16")),
              "hd320": ((48, 512, 512, 320, False), ("float32", "bfloat16")),
              "hd320_causal": ((6, 200, 200, 320, True),
                               ("float32", "bfloat16")),
              "hd512": ((48, 512, 512, 512, False), ("float32", "bfloat16")),
              "hd512_causal": ((6, 200, 200, 512, True),
                               ("float32", "bfloat16"))}
# the wide rows' calls take milliseconds: fewer samples of fewer calls
WIDE_TIMING = {"samples": 10, "reps": 3}


def _flash_rows_16bit_and_wide(torch, g, tol):
    """K3-K5 at FLASH_MORE's cases against the plain versions, timed with
    their plain versions and SDPA in the same dtype beside the bound."""
    from mxnet_tpu_torch.ops.kernels import (flash_attention_dkv,
                                             flash_attention_dkv_ref,
                                             flash_attention_dq,
                                             flash_attention_dq_ref,
                                             flash_attention_fwd,
                                             flash_attention_ref)

    F = torch.nn.functional
    rows = []
    for name, ((N, Lq, Lk, D, causal), dtypes) in FLASH_MORE.items():
        for dtype in dtypes:
            q, k, v, do = (t.to(getattr(torch, dtype))
                           for t in _flash_inputs(torch, g, N, Lq, Lk, D))
            eps = EPS16.get(dtype)
            err, same, fwd_same, args, ratios = _flash_errors(
                torch, q, k, v, do, causal, eps)
            if eps:
                ok = (all(r <= 1 for r in ratios.values())
                      and err["lse"] <= tol["lse"])
            else:
                ok = all(err[key] <= tol[key] for key in err)
            pairs = _live_pairs(Lq, Lk, causal)
            nq, nk = (N * L * D * q.element_size() for L in (Lq, Lk))
            vec = N * Lq * 4
            work = {"fwd": (2 * nq + 2 * nk + vec, 4 * N * pairs * D),
                    "dq": (3 * nq + 2 * nk + 2 * vec, 6 * N * pairs * D),
                    "dkv": (2 * nq + 4 * nk + 2 * vec, 8 * N * pairs * D)}
            q4, k4, v4, do4 = (t[None] for t in (q, k, v, do))
            tk = WIDE_TIMING if D > 256 else {}
            sdpa_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal), **tk)
            l4 = [t.clone().requires_grad_() for t in (q4, k4, v4)]
            sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(*l4, is_causal=causal), l4,
                do4), **tk) - sdpa_fwd
            timed = {"fwd": (lambda: flash_attention_fwd(q, k, v, causal),
                             lambda: flash_attention_ref(q, k, v, causal),
                             sdpa_fwd),
                     "dq": (lambda: flash_attention_dq(*args),
                            lambda: flash_attention_dq_ref(*args), sdpa_bwd),
                     "dkv": (lambda: flash_attention_dkv(*args),
                             lambda: flash_attention_dkv_ref(*args),
                             sdpa_bwd)}
            times = {}
            tk = WIDE_TIMING if D > 256 else {}
            for kname, (kern, plain, lib_ms) in timed.items():
                b_ms, b_by = bound_3xtf32(*work[kname])
                times[kname] = {"ms": time_ms(torch, kern, **tk),
                                "plain_ms": time_ms(torch, plain, **tk),
                                "library_ms": lib_ms, "bound_ms": b_ms,
                                "bound_by": b_by}
                if dtype != "float32":
                    # the least time for the work from 16-bit operands:
                    # their bytes, and the products at the dense 16-bit
                    # tensor-core rate
                    times[kname]["bound_16bit_ms"], \
                        times[kname]["bound_16bit_by"] = bound(
                            *work[kname], BF16_FLOPS_PER_S)
                times[kname]["ok"] = times[kname]["ms"] >= b_ms
            rows.append({"case": name, "dtype": dtype, "N": N, "Lq": Lq,
                         "Lk": Lk, "hd": D, "causal": causal,
                         "errors": err, "ulp_ratios": ratios,
                         "fwd_bitwise_repeatable": fwd_same,
                         "bwd_bitwise_repeatable": same,
                         "ok": ok and same and fwd_same
                         and all(t["ok"] for t in times.values()), **times})
            del l4, q, k, v, do, args
            torch.cuda.empty_cache()
    return rows


def _requests(n, vocab, seed):
    from mxnet_tpu_torch.serving import Request

    rng = np.random.RandomState(seed)
    reqs = [Request(rng.randint(3, vocab, rng.randint(8, 65)),
                    max_new_tokens=int(rng.randint(16, 97)), bos_id=1,
                    eos_id=2) for _ in range(n)]
    arrivals = [0] * min(n, 8) + sorted(
        int(a) for a in rng.randint(1, 120, max(0, n - 8)))
    return reqs, arrivals


def phase_serve(torch, ctx):
    from mxnet_tpu_torch.models.transformer import transformer_big
    from mxnet_tpu_torch.serving import ServingEngine, TransformerAdapter

    vocab = 32000
    t0 = time.perf_counter()
    model = transformer_big(vocab, dropout=0.0, max_length=1024,
                            generator=torch.Generator().manual_seed(SEED))
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    adapter = TransformerAdapter(model, src_max_len=64)
    kw = dict(slots=8, page_size=16, max_len=128, stream_every=4)
    ctx.update(model=model, adapter=adapter, engine_kw=kw)
    # warm-up: cuBLAS handles and the allocator's pools, on a fresh engine
    ServingEngine(adapter, **kw).serve(_requests(2, vocab, SEED + 1)[0])
    torch.cuda.synchronize()

    eng = ServingEngine(adapter, **kw)
    reqs, arrivals = _requests(16, vocab, SEED)
    toks, line = _serve_run(torch, eng, reqs, arrivals)
    ctx.setdefault("launches", {})["serve"] = line["launches"]
    lengths_ok = all(1 <= len(t) <= r.max_new_tokens
                     and (len(t) == r.max_new_tokens or t[-1] == r.eos_id)
                     for r, t in zip(reqs, toks))
    in_vocab = all(0 <= v < vocab for t in toks for v in t)

    src = torch.from_numpy(adapter.prefill_src(reqs[0])).cuda()
    prefill_ms = time_ms(torch, lambda: adapter.prefill(src), samples=20,
                         reps=1)
    # the greedy stream of each request, for serve_sampling's lanes
    ctx["serve_tokens"] = toks
    return {
        "model": "transformer_big", "vocab": vocab, "params": n_params,
        "init_s": init_s, "requests": len(reqs), "arrivals": arrivals,
        "engine": kw, "src_max_len": 64, "pool_pages": eng.num_pages,
        "preemptions": sum(r.preemptions for r in reqs), **line,
        "prefill_ms_median": prefill_ms, "card": ctx["smi"],
        "ok": bool(line["finished"] and lengths_ok and in_vocab
                   and line["pages_back"] and line["launches_ok"]),
        "checks": {"finished": line["finished"], "lengths": lengths_ok,
                   "in_vocab": bool(in_vocab),
                   "pages_back": line["pages_back"]}}


def _first_logits(torch, model, src_np, steps, device, feed=None,
                  dtype="float32"):
    """Encoder memory and the first ``steps`` decode logits of one
    request, teacher-forced with ``feed`` (greedy from this device's own
    logits when None), through the paged cache the engine uses, with the
    pools and the memory in ``dtype`` as the engine keeps them."""
    from mxnet_tpu_torch.serving import (PagedKVCache, PagedStepCache,
                                         page_coords)

    ps = 16
    sa = model.decoder.layers[0].self_attn
    cache = PagedKVCache(len(model.decoder.layers), 2, ps, sa.num_heads,
                         sa.head_dim, device=device, dtype=dtype)
    table = torch.tensor([[1]], dtype=torch.int32, device=device)
    with torch.no_grad():
        mem, keep = model._encode_h(torch.from_numpy(src_np).to(device))
        mem = mem.to(cache.dtype)
        tok, toks, logits = 1, [], []
        for t in range(steps):
            pos = torch.tensor([t], dtype=torch.int32, device=device)
            pages, rows = page_coords(table, pos, ps)
            caches = [PagedStepCache(k, v, table, pages, rows, pos + 1)
                      for k, v in cache.pools]
            tok_t = torch.tensor([[tok]], dtype=torch.int32, device=device)
            lg = model._decode_step(tok_t, pos, mem, keep, caches)
            logits.append(lg.cpu())
            tok = int(feed[t]) if feed is not None else int(lg.argmax())
            toks.append(tok)
    return mem.float().cpu(), torch.cat(logits), toks


def phase_serve_parity(torch, ctx):
    from mxnet_tpu_torch.models.transformer import transformer_big

    model = ctx["model"]
    cpu_model = transformer_big(32000, dropout=0.0, max_length=1024,
                                device="cpu").eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    ctx["cpu_model"] = cpu_model  # serve_bf16 compares with it too
    rng = np.random.RandomState(SEED + 2)
    src = np.zeros((1, 64), np.int32)
    src[0, :40] = rng.randint(3, 32000, 40)
    mem_g, lg_g, toks = _first_logits(torch, model, src, 4,
                                      torch.device("cuda", 0))
    mem_c, lg_c, _ = _first_logits(torch, cpu_model, src, 4,
                                   torch.device("cpu"), feed=toks)
    d_mem = float((mem_g - mem_c).abs().max())
    d_lg = float((lg_g - lg_c).abs().max())
    finite = bool(torch.isfinite(lg_g).all() and torch.isfinite(mem_g).all())
    return {"steps": 4, "max_abs_diff_memory": d_mem,
            "max_abs_diff_logits": d_lg, "logit_abs_max": float(
                lg_c.abs().max()), "tol": 2e-3, "finite": finite,
            "ok": finite and d_lg <= 2e-3 and d_mem <= 2e-3}


def phase_serve_profile(torch, ctx, dtype="float32"):
    """Where the serving time goes: 8 full slots decoding 32 steps each
    under torch.profiler (device activity only), device time by kernel
    and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.serving import Request, ServingEngine

    eng = ServingEngine(ctx["adapter"], dtype=dtype, **ctx["engine_kw"])
    rng = np.random.RandomState(SEED + 3)
    reqs = [Request(rng.randint(3, 32000, 64), max_new_tokens=32, bos_id=1,
                    eos_id=-1) for _ in range(8)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _profile_rows(prof)
    busy = sum(ms for ms, _, _ in rows)
    ours = sum(ms for ms, _, k in rows
               if "ln_fwd_" in k or "paged_decode" in k)
    return {"requests": len(reqs), "decode_steps": eng.step_count,
            "wall_ms": wall_ms, "device_busy_ms": busy if rows else None,
            "device_busy_share": busy / wall_ms if rows else None,
            "device_ops": sum(c for _, c, _ in rows),
            "k1_k2_device_ms": ours,
            "top": [{"name": k[:100], "ms": ms, "count": c}
                    for ms, c, k in rows[:12]]}


def phase_serve_bf16(torch, ctx):
    """The serve cell with bf16 KV pools and encoder memory
    (``ServingEngine(..., dtype="bfloat16")``, the JAX engine's bf16
    serving: f32 weights and queries, K2 over bf16 pools), then the same
    requests with the f32 engine in this process; the launch counters of
    each run against the path's counts.  Then one request's encoder memory
    and first 4 decode logits on the card and on the CPU, both with bf16
    pools, within a tolerance derived on the CPU: the larger of the f32
    path's 2e-3 and how far bf16 pools move the CPU's own logits (the card
    and the CPU can round a K/V value differently, never more than all of
    them)."""
    from mxnet_tpu_torch.serving import ServingEngine

    adapter, kw, vocab = ctx["adapter"], ctx["engine_kw"], 32000
    ServingEngine(adapter, dtype="bfloat16", **kw).serve(
        _requests(2, vocab, SEED + 1)[0])  # warm-up
    runs = {}
    for dtype in ("bfloat16", "float32"):
        eng = ServingEngine(adapter, dtype=dtype, **kw)
        reqs, arrivals = _requests(16, vocab, SEED)
        _, runs[dtype] = _serve_run(torch, eng, reqs, arrivals)
        runs[dtype]["pool_bytes"] = eng.pool_bytes
    ctx.setdefault("launches", {})["serve_bf16"] = runs["bfloat16"]["launches"]
    profile = phase_serve_profile(torch, ctx, dtype="bfloat16")

    model, cpu_model = ctx["model"], ctx.pop("cpu_model")
    rng = np.random.RandomState(SEED + 2)
    src = np.zeros((1, 64), np.int32)
    src[0, :40] = rng.randint(3, vocab, 40)
    mem_g, lg_g, toks = _first_logits(torch, model, src, 4,
                                      torch.device("cuda", 0),
                                      dtype="bfloat16")
    cpu = torch.device("cpu")
    mem_c, lg_c, _ = _first_logits(torch, cpu_model, src, 4, cpu, feed=toks,
                                   dtype="bfloat16")
    mem_32, lg_32, _ = _first_logits(torch, cpu_model, src, 4, cpu,
                                     feed=toks)
    del cpu_model
    tol = max(2e-3, float((lg_c - lg_32).abs().max()))
    tol_mem = max(2e-3, float((mem_c - mem_32).abs().max()))
    d_lg = float((lg_g - lg_c).abs().max())
    d_mem = float((mem_g - mem_c).abs().max())
    finite = bool(torch.isfinite(lg_g).all())
    bf, f32 = runs["bfloat16"], runs["float32"]
    return {"model": "transformer_big", "engine": kw, "dtype": "bfloat16",
            "runs": runs, "profile_bf16": profile,
            "tokens_per_s_over_f32": bf["tokens_per_s"] / f32["tokens_per_s"],
            "pool_bytes_over_f32": bf["pool_bytes"] / f32["pool_bytes"],
            "parity": {"steps": 4, "max_abs_diff_logits": d_lg,
                       "tol_logits": tol, "max_abs_diff_memory": d_mem,
                       "tol_memory": tol_mem,
                       "cpu_bf16_vs_f32_logits": float(
                           (lg_c - lg_32).abs().max()),
                       "logit_abs_max": float(lg_c.abs().max())},
            "card": ctx["smi"],
            "ok": bool(all(r["launches_ok"] and r["finished"]
                           and r["pages_back"] for r in runs.values())
                       and finite and d_lg <= tol and d_mem <= tol_mem)}


# ---------------------------------------------------------------------------
# the serving front door: sampling, speculation, the prefix cache, beams
# ---------------------------------------------------------------------------
# the sampler's settings in serve_sampling (a chat-style request mix)
SAMPLE = {"temperature": 0.8, "top_k": 50, "top_p": 0.9}
# the distribution check: TV_DRAWS draws per row of one fixed (8, 32000)
# logits tensor; the total-variation distance of each row's histogram to
# its filtered softmax must stay under sqrt(k / TV_DRAWS) for a support of
# k tokens, ~2.5x the expected distance of an exact sampler's histogram
# (0.5 sqrt(2 k / (pi n)) at most); with k <= top_k = 50, at most 0.05
TV_DRAWS, TV_CHUNK = 20000, 500
# bench.py:1366-1369 (bench_spec_decode) and :1302-1304
# (bench_prefix_cache), at Transformer-big's widths
SPEC_REQUESTS, SPEC_TOKENS, SPEC_TRIALS = 8, 24, 3
PREFIX_REQUESTS, PREFIX_TOKENS, PREFIX_NEW, PREFIX_TRIALS = 12, 24, 8, 3


def _slo(reqs):
    """TTFT and queue-wait percentiles (ms) from the requests' stamps."""
    ttft = [r.ttft_ms for r in reqs]
    wait = [r.queue_wait_ms for r in reqs]
    return {"ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p90": float(np.percentile(ttft, 90)),
            "queue_wait_ms_p50": float(np.percentile(wait, 50))}


def _counted(torch, fn):
    """Run ``fn`` with every kernel counter zeroed just before and read
    just after, the device synchronized on both sides: (fn's result,
    launches by kernel, wall s)."""
    counters = _counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {n: c.launches for n, c in counters.items()}, wall


def _expected(k1, k2):
    """The launches of a serving path: K1 and K2 as given, the rest 0."""
    exp = {n: 0 for n in ALL_KERNELS}
    exp.update(layer_norm=k1, paged_decode_attention=k2)
    return exp


def _tally(obj, name, calls):
    """Count the calls of ``obj.name`` in ``calls[name]`` through an
    instance attribute wrapping the bound method (the class is
    untouched; ``del obj.name`` undoes it)."""
    fn = getattr(obj, name)
    calls[name] = 0

    def wrapped(*args, **kwargs):
        calls[name] += 1
        return fn(*args, **kwargs)

    setattr(obj, name, wrapped)


def _serve_run(torch, eng, reqs, arrivals=None):
    """Serve ``reqs`` counted; the run's tokens and its line."""
    out, launches, wall = _counted(
        torch, lambda: eng.serve(reqs, arrival_steps=arrivals))
    toks = [list(out[r.id]) for r in reqs]
    steps = eng.step_count
    prefills = len(reqs) + sum(r.preemptions for r in reqs)
    expected = _expected(18 * steps + 12 * prefills, 6 * steps)
    n_tok = sum(len(t) for t in toks)
    return toks, {
        "slots": eng.statusz_snapshot()["slots"], "decode_steps": steps,
        "prefills": prefills, "tokens": n_tok, "wall_s": wall,
        "tokens_per_s": n_tok / wall,
        "decode_step_ms_median": statistics.median(
            1e3 * t / n for n, t in eng.burst_times),
        **_slo(reqs), "launches": launches, "launches_expected": expected,
        "launches_ok": launches == expected and steps > 0,
        "finished": all(r.stream.finished for r in reqs),
        "pages_back": eng.pages_free == eng.num_pages - 1,
        "statusz": eng.statusz_snapshot()}


def phase_serve_sampling(torch, ctx):
    """``serve``'s 16 requests and arrivals through ``sampling=True``: at
    temperature 0 every token must be ``serve``'s; then requests 0-7 at
    SAMPLE with seeds 100-107 and 8-15 greedy, in two fresh engines of 8
    and 5 slots: the sampled streams equal across the two, the greedy
    ones ``serve``'s.  The greedy engine runs the same traffic in this
    phase, in turns with the temperature-0 one (greedy, sampling,
    sampling, greedy), for tokens/s and decode-step ms beside it (means
    of each pair).  Then the sampler
    (``_filter_logits``, ``_gumbel_rows``, argmax: ``_select_token``'s
    math) draws TV_DRAWS tokens per row of one fixed (8, 32000) logits
    tensor at SAMPLE, held to the TV limit above."""
    from mxnet_tpu_torch.serving import Request, ServingEngine, sampling

    adapter, kw, vocab = ctx["adapter"], ctx["engine_kw"], 32000
    want = ctx["serve_tokens"]
    ServingEngine(adapter, sampling=True, **kw).serve(
        _requests(2, vocab, SEED + 1)[0])  # warm-up of the sampling ops

    def traffic(sampled=()):
        reqs, arrivals = _requests(16, vocab, SEED)
        for i in sampled:
            r = reqs[i]
            reqs[i] = Request(r.tokens, r.max_new_tokens, r.bos_id,
                              r.eos_id, seed=100 + i, **SAMPLE)
        return reqs, arrivals

    # greedy and temperature 0 in turns (A B B A): the host clock of a
    # shared machine drifts between runs
    runs, toks = {}, {}
    for name, samp, slots, sampled in (
            ("greedy", False, 8, ()), ("sampling_temp0", True, 8, ()),
            ("sampling_temp0_b", True, 8, ()), ("greedy_b", False, 8, ()),
            ("mixed_8_slots", True, 8, range(8)),
            ("mixed_5_slots", True, 5, range(8))):
        eng = ServingEngine(adapter, sampling=samp,
                            **dict(kw, slots=slots))
        toks[name], runs[name] = _serve_run(torch, eng, *traffic(sampled))
    temp0_equal = toks["sampling_temp0"] == toks["sampling_temp0_b"] == want
    greedy_equal = toks["greedy"] == toks["greedy_b"] == want
    sampled_repro = toks["mixed_8_slots"][:8] == toks["mixed_5_slots"][:8]
    greedy_lanes = toks["mixed_8_slots"][8:] == want[8:]
    differ = sum(toks["mixed_8_slots"][i] != want[i] for i in range(8))

    dev = next(adapter.model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(SEED)
    logits = torch.randn((8, vocab), generator=g, device=dev) * 3
    S = logits.shape[0]
    filt = sampling._filter_logits(
        logits, torch.full((S,), SAMPLE["temperature"], device=dev),
        torch.full((S,), SAMPLE["top_k"], dtype=torch.int32, device=dev),
        torch.full((S,), SAMPLE["top_p"], device=dev))
    key = torch.tensor([sampling.seed_key(100 + s) for s in range(S)],
                       device=dev)
    counts = torch.zeros((S, vocab), dtype=torch.float64, device=dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        for c0 in range(0, TV_DRAWS, TV_CHUNK):
            ctr = 2 * torch.arange(c0, c0 + TV_CHUNK, device=dev)
            gum = sampling._gumbel_rows(key[:, None].expand(S, TV_CHUNK),
                                        ctr[None].expand(S, TV_CHUNK), vocab)
            tok = torch.argmax(filt[:, None, :] + gum, dim=-1)
            counts.scatter_add_(1, tok, torch.ones_like(tok,
                                                        dtype=counts.dtype))
            del gum
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
    masked = torch.isneginf(filt)
    support = (~masked).sum(dim=1)
    tv = 0.5 * (counts / TV_DRAWS - torch.softmax(filt.double(), dim=-1)) \
        .abs().sum(dim=1)
    limit = torch.sqrt(support.double() / TV_DRAWS)
    outside = float(counts[masked].sum())
    tv_ok = bool((tv < limit).all()) and outside == 0
    ctx.setdefault("launches", {})["serve_sampling"] = {
        n: sum(r["launches"][n] for r in runs.values())
        for n in ALL_KERNELS}
    def mean(key, *names):
        return statistics.mean(runs[n][key] for n in names)

    greedy_tps = mean("tokens_per_s", "greedy", "greedy_b")
    return {"model": "transformer_big", "engine": kw, "sample": SAMPLE,
            "runs": runs,
            "tokens_per_s_sampling_temp0_over_greedy": mean(
                "tokens_per_s", "sampling_temp0", "sampling_temp0_b")
            / greedy_tps,
            "tokens_per_s_mixed_over_greedy":
                runs["mixed_8_slots"]["tokens_per_s"] / greedy_tps,
            "decode_step_ms_greedy": mean("decode_step_ms_median", "greedy",
                                          "greedy_b"),
            "decode_step_ms_sampling": mean("decode_step_ms_median",
                                            "sampling_temp0",
                                            "sampling_temp0_b"),
            "sampled_streams_differing_from_greedy": differ,
            "distribution": {"draws_per_row": TV_DRAWS,
                             "support": support.tolist(),
                             "tv": tv.tolist(), "tv_limit": limit.tolist(),
                             "draws_outside_support": outside,
                             "draw_s": draw_s},
            "checks": {"temp0_equals_serve": temp0_equal,
                       "greedy_equals_serve": greedy_equal,
                       "sampled_equal_8_vs_5_slots": sampled_repro,
                       "greedy_lanes_equal_serve": greedy_lanes,
                       "tv_under_limit": tv_ok},
            "card": ctx["smi"],
            "ok": bool(temp0_equal and greedy_equal and sampled_repro
                       and greedy_lanes and differ > 0 and tv_ok
                       and all(r["launches_ok"] and r["finished"]
                               and r["pages_back"]
                               for r in runs.values()))}


def phase_serve_spec(torch, ctx):
    """``bench_spec_decode``'s traffic (bench.py:1355) at full width: 8
    requests with 8-token sources from RandomState(0), 24 new tokens,
    bos 2, eos 1, through the plain engine and then ``spec_k`` 4 and 1
    with ``NGramDraft()``, the serve engine's settings; a warm-up request,
    then 3 trials each, the launches counted in each.  Verify and plain
    dispatches are counted by wrapping the engine's dispatch methods; K1
    must read 18 (K+1) per verify + 18 per plain step + 12 per prefill,
    K2 6 (K+1) per verify + 6 per plain step.  Tokens equal the plain
    engine's."""
    from mxnet_tpu_torch.serving import NGramDraft, Request, ServingEngine

    adapter, kw, vocab = ctx["adapter"], ctx["engine_kw"], 32000
    rng = np.random.RandomState(0)
    prompts = [rng.randint(3, vocab, 8).astype(np.int32)
               for _ in range(SPEC_REQUESTS)]
    res, streams = {}, {}
    total = {n: 0 for n in ALL_KERNELS}
    for k in (0, 4, 1):
        eng = ServingEngine(adapter, spec_k=k,
                            draft=NGramDraft() if k else None, **kw)
        eng.serve([Request(prompts[0], 4, bos_id=2, eos_id=1)])  # warm-up
        calls, verify_ms = {}, []
        _tally(eng, "_dispatch_step", calls)
        if k:
            _tally(eng, "_dispatch_spec", calls)
            dispatch, consume = eng._dispatch_spec, eng._consume_spec

            def timed_dispatch(dispatch=dispatch):
                timed_dispatch.t0 = time.perf_counter()
                return dispatch()

            def timed_consume(*args, consume=consume):
                out = consume(*args)
                verify_ms.append(1e3 * (time.perf_counter()
                                        - timed_dispatch.t0))
                return out

            eng._dispatch_spec, eng._consume_spec = (timed_dispatch,
                                                     timed_consume)
        trials = []
        for _ in range(SPEC_TRIALS):
            reqs = [Request(p, SPEC_TOKENS, bos_id=2, eos_id=1)
                    for p in prompts]
            for c in calls:
                calls[c] = 0
            prop0, acc0 = eng._spec_proposed, eng._spec_accepted
            out, launches, wall = _counted(torch, lambda: eng.serve(reqs))
            streams[k] = [list(out[r.id]) for r in reqs]
            verifies = calls.get("_dispatch_spec", 0)
            plain = calls["_dispatch_step"]
            prefills = len(reqs) + sum(r.preemptions for r in reqs)
            expected = _expected(
                18 * (k + 1) * verifies + 18 * plain + 12 * prefills,
                6 * (k + 1) * verifies + 6 * plain)
            n_tok = sum(len(s) for s in streams[k])
            trials.append({
                "wall_s": wall, "tokens": n_tok,
                "tokens_per_s": n_tok / wall, "verifies": verifies,
                "plain_steps": plain, "prefills": prefills,
                "proposed": eng._spec_proposed - prop0,
                "accepted": eng._spec_accepted - acc0,
                "launches": launches, "launches_expected": expected,
                "launches_ok": launches == expected})
            for n in ALL_KERNELS:
                total[n] += launches[n]
        prop = sum(t["proposed"] for t in trials)
        acc = sum(t["accepted"] for t in trials)
        res[f"spec_k{k}"] = {
            "trials": trials,
            "tokens_per_s_best": max(t["tokens_per_s"] for t in trials),
            "acceptance_rate": acc / prop if prop else None,
            "verify_dispatch_ms_median": (statistics.median(verify_ms)
                                          if verify_ms else None),
            "statusz": eng.statusz_snapshot(),
            "pages_back": eng.pages_free == eng.num_pages - 1}
    ctx.setdefault("launches", {})["serve_spec"] = total
    plain_tps = res["spec_k0"]["tokens_per_s_best"]
    equal = {k: streams[k] == streams[0] for k in (4, 1)}
    return {"model": "transformer_big", "engine": kw,
            "requests": SPEC_REQUESTS, "max_new_tokens": SPEC_TOKENS,
            "runs": res,
            "tokens_per_s_over_plain": {
                k: res[f"spec_k{k}"]["tokens_per_s_best"] / plain_tps
                for k in (4, 1)},
            "tokens_equal_plain": equal, "card": ctx["smi"],
            "ok": bool(all(equal.values())
                       and all(t["launches_ok"] for r in res.values()
                               for t in r["trials"])
                       and all(r["pages_back"] for r in res.values())
                       and res["spec_k4"]["trials"][0]["verifies"] > 0
                       and res["spec_k4"]["trials"][0]["proposed"] > 0)}


def phase_serve_prefix(torch, ctx):
    """``bench_prefix_cache``'s traffic (bench.py:1291) at full width: one
    8-token source from RandomState(0), bos 2; its plain greedy stream of
    32 tokens; the forced prefix is its first 24 tokens.  12 requests of 8
    new tokens with that prefix, 3 trials, the cache on and then off (a
    warm-up request with the first 5 prefix tokens first, as the bench
    does), on the serve engine's settings.  eos is -1 so that every
    stream has its 8 tokens.  Every stream must be the plain stream's
    tokens 24-31, cache on and off; the hit rate is the bench's
    (hits / lookups over the engine's life); the pages all return once
    the entries are dropped.  Ingest dispatches, prefills (encoder runs)
    and decode steps are counted by wrapping the methods; K1 must read
    18 x 8 per ingest + 18 per step + 12 per prefill, K2 6 x 8 per ingest
    + 6 per step."""
    from mxnet_tpu_torch.serving import (Request, ServingEngine,
                                         TransformerAdapter)

    model, kw = ctx["model"], ctx["engine_kw"]
    vocab = 32000
    rng = np.random.RandomState(0)
    src = rng.randint(3, vocab, 8).astype(np.int32)
    plain = list(ServingEngine(ctx["adapter"], **kw).serve(
        [Request(src, PREFIX_TOKENS + PREFIX_NEW, bos_id=2, eos_id=-1,
                 request_id="p")])["p"])
    prefix = np.asarray(plain[:PREFIX_TOKENS], np.int32)
    want = plain[PREFIX_TOKENS:PREFIX_TOKENS + PREFIX_NEW]
    res = {}
    total = {n: 0 for n in ALL_KERNELS}
    for on in (True, False):
        adapter = TransformerAdapter(model, src_max_len=64)
        eng = ServingEngine(adapter, prefix_cache=on, **kw)
        eng.serve([Request(src, 2, bos_id=2, eos_id=-1,
                           prefix=prefix[:5])])  # warm-up
        calls = {}
        _tally(adapter, "prefill", calls)
        _tally(eng, "_ingest_body", calls)
        _tally(eng, "_dispatch_step", calls)
        trials, reqs_all = [], []
        for _ in range(PREFIX_TRIALS):
            reqs = [Request(src, PREFIX_NEW, bos_id=2, eos_id=-1,
                            prefix=prefix) for _ in range(PREFIX_REQUESTS)]
            for c in calls:
                calls[c] = 0
            out, launches, wall = _counted(torch, lambda: eng.serve(reqs))
            n_ing, steps = calls["_ingest_body"], calls["_dispatch_step"]
            expected = _expected(
                18 * 8 * n_ing + 18 * steps + 12 * calls["prefill"],
                6 * 8 * n_ing + 6 * steps)
            trials.append({
                "wall_s": wall, "ingests": n_ing, "decode_steps": steps,
                "prefills": calls["prefill"], **_slo(reqs),
                "streams_equal_plain": all(list(out[r.id]) == want
                                           for r in reqs),
                "launches": launches, "launches_expected": expected,
                "launches_ok": launches == expected})
            reqs_all += reqs
            for n in ALL_KERNELS:
                total[n] += launches[n]
        del adapter.prefill
        line = {"trials": trials,
                "wall_s_min": min(t["wall_s"] for t in trials),
                "statusz": eng.statusz_snapshot()}
        if on:
            looked = eng._prefix.hits + eng._prefix.misses
            hit = [r.ttft_ms for r in reqs_all if r.prefix_hit]
            miss = [r.ttft_ms for r in reqs_all if r.prefix_hit is False]
            line.update(
                hit_rate=eng._prefix.hits / looked if looked else 0.0,
                ttft_ms_mean_hits=statistics.mean(hit) if hit else None,
                ttft_ms_mean_misses=statistics.mean(miss) if miss else None,
                hits=len(hit), misses=len(miss),
                pages_held_by_entries=eng.num_pages - 1 - eng.pages_free)
            while eng._drop_one_prefix_entry():
                pass
        line["pages_back"] = eng.pages_free == eng.num_pages - 1
        res["cache_on" if on else "cache_off"] = line
    ctx.setdefault("launches", {})["serve_prefix"] = total
    on, off = res["cache_on"], res["cache_off"]
    return {"model": "transformer_big", "engine": kw,
            "prefix_tokens": PREFIX_TOKENS, "requests": PREFIX_REQUESTS,
            "new_tokens": PREFIX_NEW, "runs": res,
            "wall_ratio_off_over_on": off["wall_s_min"] / on["wall_s_min"],
            "card": ctx["smi"],
            "ok": bool(all(t["streams_equal_plain"] and t["launches_ok"]
                           for r in res.values() for t in r["trials"])
                       and on["pages_back"] and off["pages_back"]
                       and on["hits"] > 0
                       and on["trials"][-1]["ingests"] == 0)}


def phase_serve_beam(torch, ctx):
    """``Transformer.translate`` on the card over ``serve``'s first 8
    sources (padded to the longest), beam 4, ``max_len`` 33, pages of 16,
    after a short warm-up; beam steps counted by wrapping the model's
    ``_decode_step``: K1 12 per translate + 18 per step, K2 6 per step.
    Then ``serve_beam(beam_size=4)`` with ``max_new_tokens`` 32 on the
    same requests must give each translate row, trimmed as the engine
    trims, and ``translate(beam_size=1)`` the greedy engine's tokens for
    the same sources."""
    from mxnet_tpu_torch.serving import Request, ServingEngine

    model, adapter, kw = ctx["model"], ctx["adapter"], ctx["engine_kw"]
    vocab, bos, eos, beam, new = 32000, 1, 2, 4, 32
    srcs = [r.tokens for r in _requests(16, vocab, SEED)[0][:8]]
    src = np.zeros((len(srcs), max(s.size for s in srcs)), np.int32)
    for i, s in enumerate(srcs):
        src[i, :s.size] = s
    src_t = torch.from_numpy(src).to(next(model.parameters()).device)

    def trim(row):
        toks = [int(t) for t in row[1:]]
        if eos in toks:
            toks = toks[:toks.index(eos) + 1]
        return toks[:new]

    def translate(k):
        return model.translate(src_t, bos_id=bos, eos_id=eos,
                               max_len=new + 1, beam_size=k, page_size=16)

    model.translate(src_t[:1], bos_id=bos, eos_id=eos, max_len=4,
                    beam_size=beam, page_size=16)  # warm-up
    calls = {}
    _tally(model, "_decode_step", calls)
    try:
        hyp, launches, wall = _counted(torch, lambda: translate(beam))
        steps = calls["_decode_step"]
    finally:
        del model._decode_step
    expected = _expected(12 + 18 * steps, 6 * steps)
    eng = ServingEngine(adapter, **kw)
    breqs = [Request(s, new, bos_id=bos, eos_id=eos) for s in srcs]
    bout, b_launches, b_wall = _counted(
        torch, lambda: eng.serve_beam(breqs, beam_size=beam))
    beam_equal = all(list(bout[r.id]) == trim(hyp[i])
                     for i, r in enumerate(breqs))
    hyp1 = translate(1)
    geng = ServingEngine(adapter, **kw)
    greqs = [Request(s, new, bos_id=bos, eos_id=eos) for s in srcs]
    gout = geng.serve(greqs)
    greedy_equal = all(list(gout[r.id]) == trim(hyp1[i])
                       for i, r in enumerate(greqs))
    n_tok = sum(len(trim(h)) for h in hyp)
    in_vocab = bool(((hyp >= 0) & (hyp < vocab)).all())
    ctx.setdefault("launches", {})["serve_beam"] = {
        n: launches[n] + b_launches[n] for n in ALL_KERNELS}
    return {"model": "transformer_big", "batch": len(srcs), "beam": beam,
            "max_len": new + 1, "src_width": src.shape[1],
            "beam_steps": steps, "wall_s": wall,
            "ms_per_beam_step": 1e3 * wall / steps, "tokens": n_tok,
            "tokens_per_s": n_tok / wall, "serve_beam_wall_s": b_wall,
            "launches": launches, "launches_expected": expected,
            "serve_beam_launches": b_launches,
            "statusz": eng.statusz_snapshot(),
            "checks": {"serve_beam_equals_translate": beam_equal,
                       "beam1_equals_greedy_engine": greedy_equal,
                       "in_vocab": in_vocab},
            "card": ctx["smi"],
            "ok": bool(launches == expected and steps > 0
                       and b_launches == expected and beam_equal
                       and greedy_equal and in_vocab)}


BERT_VOCAB = 30522
TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS = 32, 512, 5
FLASH = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")
# launches of each kernel per training step: embed_ln + 2 per layer +
# mlm_ln LayerNorms, and one attention per layer
TRAIN_PER_STEP = {"layer_norm": 26, "paged_decode_attention": 0,
                  **{n: 12 for n in FLASH}, "add_layer_norm": 0,
                  "softmax_cross_entropy": 0}
# substrings of the kernels' names in a trace (each is a template over the
# element type and width: ln_fwd_warp<float, 4, 8>, flash_fwd<float, 64,
# 64>, ...)
OUR_KERNELS = ("ln_fwd_", "paged_decode", "flash_fwd", "flash_bwd_dq",
               "flash_bwd_dkv")


def _mlm_loss(torch):
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    loss_fn = SoftmaxCrossEntropyLoss()

    def mlm(logits, labels):
        return loss_fn(logits.reshape(-1, logits.shape[-1]),
                       labels.reshape(-1))

    return mlm


def _train_steps(torch, step, data, label, steps):
    """``steps`` training steps, a CUDA-event span around each one's
    enqueue and the host clock around all of them, ending in a sync:
    (losses, step ms, wall s)."""
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    handles = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for start, end in marks:
        start.record()
        handles.append(step.step(data, label))
        end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([float(h) for h in handles], [a.elapsed_time(b) for a, b in marks],
            wall)


def _host_gaps(trace_path, top=5):
    """The largest gaps between consecutive device activities (kernels,
    copies, sets) of a chrome trace, in ms, with what bounds each."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    acts = sorted((e["ts"], e["ts"] + e.get("dur", 0), e.get("name", ""))
                  for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and "ts" in e)
    gaps, end, last = [], None, ""
    for ts, te, name in acts:
        if end is not None and ts > end:
            gaps.append(((ts - end) / 1e3, last[:60], name[:60]))
        if end is None or te > end:
            end, last = te, name
    gaps.sort(reverse=True)
    return {"device_activities": len(acts),
            "gaps_total_ms": sum(g for g, _, _ in gaps),
            "largest": [{"ms": g, "after": a, "before": b}
                        for g, a, b in gaps[:top]]}


def _step_profile(torch, fn, steps=1, top=15, gaps=False):
    """``steps`` calls of ``fn`` under torch.profiler (device activity
    only), totals over the calls: device busy share, top kernels, our
    kernels' ms and share of the busy time, optionally the largest host
    gaps between device activities."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _profile_rows(prof)
    busy = sum(ms for ms, _, _ in rows)
    ours = {k: sum(ms for ms, _, key in rows if k in key)
            for k in OUR_KERNELS}
    out = {"steps": steps, "wall_ms": wall_ms,
           "device_busy_ms": busy if rows else None,
           "device_busy_share": busy / wall_ms if rows else None,
           "device_ops": sum(c for _, c, _ in rows),
           "our_kernels_ms": ours,
           "our_kernels_share": sum(ours.values()) / busy if rows else None,
           "top": [{"name": k[:100], "ms": ms, "count": c}
                   for ms, c, k in rows[:top]]}
    if gaps:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", f"trace-{os.getpid()}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        out["host_gaps"] = _host_gaps(path)
        os.remove(path)
    return out


def phase_train(torch, ctx):
    from mxnet_tpu_torch.models.bert import bert_base
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import DataParallelStep

    for key in ("model", "adapter", "cpu_model"):  # serving is done
        ctx.pop(key, None)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = bert_base(BERT_VOCAB, dropout=0.0,
                      generator=torch.Generator().manual_seed(SEED))
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    step = DataParallelStep(model, _mlm_loss(torch), optimizer="adam",
                            optimizer_params={"learning_rate": 1e-4})
    ctx.update(bert=model, train_step=step)
    rng = np.random.RandomState(SEED)
    tokens = torch.from_numpy(rng.randint(
        0, BERT_VOCAB, (TRAIN_BATCH, TRAIN_LEN)).astype(np.int32)).cuda()
    labels = tokens.float()
    ctx["train_batch"] = (tokens, labels)
    torch.cuda.reset_peak_memory_stats()
    first = float(step.step(tokens, labels))  # warm-up
    torch.cuda.synchronize()

    counted = {n: getattr(kernels, n) for n in TRAIN_PER_STEP}
    for fn in counted.values():
        fn.launches = 0
    losses, step_ms, wall = _train_steps(torch, step, tokens, labels,
                                         TRAIN_STEPS)
    launches = {n: fn.launches for n, fn in counted.items()}
    ctx["launches"]["train"] = launches
    expected = {n: k * TRAIN_STEPS for n, k in TRAIN_PER_STEP.items()}
    losses = [first] + losses
    finite = all(math.isfinite(x) for x in losses)
    ctx["train_f32"] = {
        "tokens_per_s": TRAIN_BATCH * TRAIN_LEN * TRAIN_STEPS / wall,
        "step_ms_median": statistics.median(step_ms),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    return {
        "model": "bert_base", "vocab": BERT_VOCAB, "params": n_params,
        "init_s": init_s, "batch": TRAIN_BATCH, "seq_len": TRAIN_LEN,
        "optimizer": "adam", "learning_rate": 1e-4, "steps": TRAIN_STEPS,
        "wall_s": wall,
        "tokens_per_s": TRAIN_BATCH * TRAIN_LEN * TRAIN_STEPS / wall,
        "step_ms_median": statistics.median(step_ms), "step_ms": step_ms,
        "losses": losses,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "launches_expected": expected,
        "card": ctx["smi"],
        "ok": bool(finite and losses[-1] < losses[0]
                   and n_params == 133_545_786 and launches == expected)}


def phase_train_parity(torch, ctx):
    from mxnet_tpu_torch.models.bert import bert_base

    model = ctx["bert"]
    cpu_model = bert_base(BERT_VOCAB, dropout=0.0, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    names = ("bert.encoder.layers.0.attn.qkv.weight", "bert.embed_ln.weight",
             "decoder.weight")
    tokens = torch.from_numpy(np.random.RandomState(SEED + 4).randint(
        0, BERT_VOCAB, (2, 128)).astype(np.int32))
    mlm = _mlm_loss(torch)

    def forward_backward(net, device):
        net.train()
        net.zero_grad(set_to_none=True)
        t = tokens.to(device)
        loss = mlm(net(t), t.float()).float().mean()
        loss.backward()
        params = dict(net.named_parameters())
        grads = {n: params[n].grad.detach().cpu() for n in names}
        net.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    loss_g, grads_g = forward_backward(model, torch.device("cuda", 0))
    loss_c, grads_c = forward_backward(cpu_model, torch.device("cpu"))
    rel = abs(loss_g - loss_c) / abs(loss_c)
    diffs = {n: {"max_abs_diff": float((grads_g[n] - grads_c[n]).abs().max()),
                 "max_abs": float(grads_c[n].abs().max())} for n in names}
    grads_ok = all(d["max_abs_diff"] <= 1e-3 * d["max_abs"]
                   for d in diffs.values())
    return {"batch": [2, 128], "loss_card": loss_g, "loss_cpu": loss_c,
            "loss_rel_diff": rel, "grads": diffs,
            "ok": rel <= 1e-5 and grads_ok}


def _profile_rows(prof):
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return rows


def phase_train_profile(torch, ctx):
    """Where the training time goes: 2 steps under torch.profiler (device
    activity only), device time by kernel and the busy share."""
    step = ctx["train_step"]
    tokens, labels = ctx["train_batch"]
    return _step_profile(torch, lambda: step.step(tokens, labels), steps=2)


ALL_KERNELS = ("layer_norm", "paged_decode_attention", *FLASH,
               "add_layer_norm", "softmax_cross_entropy")


def _counters():
    """Every kernel wrapper by name; each counts its own launches."""
    from mxnet_tpu_torch.ops import kernels

    return {n: getattr(kernels, n) for n in ALL_KERNELS}


def phase_add_layer_norm(torch, ctx):
    from mxnet_tpu_torch.ops.kernels import add_layer_norm, add_layer_norm_ref

    F = torch.nn.functional
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    shapes, worst = [], 0.0
    # the imperative path's 32 x 512 rows of BERT-base, Transformer-big's
    # width, and a row count no block size divides
    for n, c in ((16384, 768), (8192, 1024), (37, 768)):
        x = torch.randn(n, c, device=dev, generator=g) * 2 + 0.5
        r = torch.randn(n, c, device=dev, generator=g)
        gamma = torch.randn(c, device=dev, generator=g)
        beta = torch.randn(c, device=dev, generator=g)
        got = add_layer_norm(x, r, gamma, beta)
        want = add_layer_norm_ref(x, r, gamma, beta)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        worst = max(worst, err)
        b_ms, b_by = bound(4 * (3 * n * c + 2 * c + 2 * n), 9 * n * c)
        shapes.append({
            "shape": [n, c], "max_abs_err": err, "ok": err <= 1e-5,
            "ms": time_ms(torch, lambda: add_layer_norm(x, r, gamma, beta)),
            "plain_ms": time_ms(torch, lambda: add_layer_norm_ref(
                x, r, gamma, beta)),
            "library_ms": time_ms(torch, lambda: F.layer_norm(
                x + r, (c,), gamma, beta, 1e-5)),
            "bound_ms": b_ms, "bound_by": b_by})
    ctx["add_layer_norm"] = dict(
        shapes[0], max_abs_err=worst,
        library_is="two calls: x + r, then F.layer_norm")
    more = _ln_rows(torch, g, fused=True)
    return {"atol": 1e-5, "shapes": shapes, "dtypes_and_widths": more,
            "tol_16bit": "ulp_ratio <= 1 on out; mu, rstd atol 1e-5",
            "ok": all(s["ok"] for s in shapes + more)}


def _sce_labels(n, c, kind):
    """Seeded labels: ``mlm`` keeps 15% of the rows (the rest -1),
    ``valid`` all in [0, c), ``out_of_range`` mixes -5, -1, c and c + 7
    with valid ones."""
    rng = np.random.RandomState(SEED + n + c)
    y = rng.randint(0, c, n)
    if kind == "mlm":
        y[rng.rand(n) >= 0.15] = -1
    elif kind == "out_of_range":
        y[0::4], y[1::4], y[2::8], y[3::8] = -1, c, c + 7, -5
    return y.astype(np.int64)


def phase_softmax_cross_entropy(torch, ctx):
    from mxnet_tpu_torch.ops.kernels import (SoftmaxCrossEntropyFunction,
                                             softmax_cross_entropy,
                                             softmax_cross_entropy_ref)

    F = torch.nn.functional
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    tol = {"loss": 2e-5, "grad": 1e-5}
    # name: (N, C, ignore_label, labels)
    cases = {"path": (TRAIN_BATCH * TRAIN_LEN, BERT_VOCAB, -1, "mlm"),
             "all_live": (TRAIN_BATCH * TRAIN_LEN, BERT_VOCAB, None, "valid"),
             "vocab_32000": (64, 32000, None, "valid"),
             "odd_c": (33, 1001, -1, "mlm"),
             "out_of_range": (64, BERT_VOCAB, None, "out_of_range")}
    rows = []
    for name, (n, c, ignore, kind) in cases.items():
        x = torch.randn(n, c, device=dev, generator=g) * 2
        y_np = _sce_labels(n, c, kind)
        y = torch.from_numpy(y_np).to(dev)
        gvec = torch.randn(n, device=dev, generator=g)
        got = softmax_cross_entropy(x, y, ignore)
        want = softmax_cross_entropy_ref(x, y, ignore)
        xg = x.clone().requires_grad_()
        SoftmaxCrossEntropyFunction.apply(xg, y, ignore).backward(gvec)
        xr = x.clone().requires_grad_()
        softmax_cross_entropy_ref(xr, y, ignore).backward(gvec)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        gerr = float((xg.grad - xr.grad).abs().max())
        del xg, xr, want
        torch.cuda.empty_cache()
        live = int((y_np != ignore).sum()) if ignore is not None else n
        b_ms, b_by = bound(4 * live * c + 8 * n + 4 * n, 4 * live * c)
        big = n * c > 10 ** 8
        lib = None
        if ((y_np >= 0) & (y_np < c) | (y_np == -1)).all():
            # F.cross_entropy asserts on the device for any other label
            lib = time_ms(torch, lambda: F.cross_entropy(
                x, y, reduction="none", ignore_index=-1),
                samples=10 if big else 25, reps=5 if big else 10)
        rows.append({
            "case": name, "N": n, "C": c, "ignore_label": ignore,
            "live_rows": live, "max_abs_err": err, "grad_max_abs_err": gerr,
            "ok": err <= tol["loss"] and gerr <= tol["grad"],
            "ms": time_ms(torch, lambda: softmax_cross_entropy(x, y, ignore),
                          samples=10 if big else 25, reps=5 if big else 10),
            "plain_ms": time_ms(torch, lambda: softmax_cross_entropy_ref(
                x, y, ignore), samples=5 if big else 25,
                reps=2 if big else 10),
            "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by})
        del x, y, got
        torch.cuda.empty_cache()

    rows16 = [_sce_row16(torch, g, name, dtype, *case, tol)
              for dtype in ("bfloat16", "float16")
              for name, case in cases.items()]

    # the kernel's own path: one forward and backward at the MLM shape
    n, c, ignore, kind = cases["path"]
    x = torch.randn(n, c, device=dev, generator=g).requires_grad_()
    y = torch.from_numpy(_sce_labels(n, c, kind)).to(dev)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    loss = SoftmaxCrossEntropyFunction.apply(x, y, ignore)
    loss.sum().backward()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    ctx.setdefault("launches", {})["softmax_cross_entropy"] = launches
    expected = {k: int(k == "softmax_cross_entropy") for k in ALL_KERNELS}
    finite = bool(torch.isfinite(x.grad).all() and torch.isfinite(loss).all())
    del x, loss
    torch.cuda.empty_cache()
    ctx["softmax_cross_entropy"] = dict(
        rows[0], max_abs_err=max(r["max_abs_err"] for r in rows),
        library_is="F.cross_entropy(reduction='none', ignore_index=-1)")
    return {"tol": tol, "cases": rows, "dtypes": rows16,
            "tol_16bit": "loss (f32) atol 2e-5; gradient (in the logits' "
                         "type) ulp_ratio <= 1",
            "path_launches": launches,
            "path_launches_expected": expected, "path_finite": finite,
            "ok": all(r["ok"] for r in rows + rows16)
            and launches == expected and finite}


def _sce_row16(torch, g, name, dtype, n, c, ignore, kind, tol):
    """K7 on 16-bit logits at one of the f32 cases: the loss (f32) and the
    gradient (in the logits' type) against the plain version, timed."""
    from mxnet_tpu_torch.ops.kernels import (SoftmaxCrossEntropyFunction,
                                             softmax_cross_entropy,
                                             softmax_cross_entropy_ref)

    F = torch.nn.functional
    dev = g.device
    x = (torch.randn(n, c, device=dev, generator=g) * 2).to(
        getattr(torch, dtype))
    y_np = _sce_labels(n, c, kind)
    y = torch.from_numpy(y_np).to(dev)
    gvec = torch.randn(n, device=dev, generator=g)
    err = float((softmax_cross_entropy(x, y, ignore)
                 - softmax_cross_entropy_ref(x, y, ignore)).abs().max())
    xg = x.clone().requires_grad_()
    SoftmaxCrossEntropyFunction.apply(xg, y, ignore).backward(gvec)
    xr = x.clone().requires_grad_()
    softmax_cross_entropy_ref(xr, y, ignore).backward(gvec)
    torch.cuda.synchronize()
    ratio = ulp_ratio(xg.grad, xr.grad, EPS16[dtype])
    del xg, xr
    live = int((y_np != ignore).sum()) if ignore is not None else n
    b_ms, b_by = bound(x.element_size() * live * c + 8 * n + 4 * n,
                       4 * live * c)
    big = n * c > 10 ** 8
    lib = None
    if ((y_np >= 0) & (y_np < c) | (y_np == -1)).all():
        lib = time_ms(torch, lambda: F.cross_entropy(
            x, y, reduction="none", ignore_index=-1),
            samples=10 if big else 25, reps=5 if big else 10)
    row = {"case": name, "dtype": dtype, "N": n, "C": c,
           "ignore_label": ignore, "live_rows": live, "max_abs_err": err,
           "grad_ulp_ratio": ratio, "ok": err <= tol["loss"] and ratio <= 1,
           "ms": time_ms(torch, lambda: softmax_cross_entropy(x, y, ignore),
                         samples=10 if big else 25, reps=5 if big else 10),
           "plain_ms": time_ms(torch, lambda: softmax_cross_entropy_ref(
               x, y, ignore), samples=5 if big else 25,
               reps=2 if big else 10),
           "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by}
    del x
    torch.cuda.empty_cache()
    return row


IMP_H, IMP_HD = 12, 64
# launches of one forward and backward of the imperative path
IMP_PASS_ON = {"layer_norm": 1, "paged_decode_attention": 0,
               **{n: 1 for n in FLASH}, "add_layer_norm": 1,
               "softmax_cross_entropy": 0}
IMP_PASS_OFF = dict(IMP_PASS_ON, add_layer_norm=0)


def _imperative_inputs(B, L, seed):
    rng = np.random.RandomState(seed)
    C, N = IMP_H * IMP_HD, B * IMP_H

    def f(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    arrays = {"x": f(B * L, C), "r": f(B * L, C),
              "gamma1": 1 + f(C, scale=0.1), "beta1": f(C, scale=0.1),
              "gamma2": 1 + f(C, scale=0.1), "beta2": f(C, scale=0.1),
              "k": f(N, L, IMP_HD), "v": f(N, L, IMP_HD),
              "weight": f(BERT_VOCAB, C, scale=0.02),
              "bias": f(BERT_VOCAB, scale=0.02)}
    labels = rng.randint(0, BERT_VOCAB, B * L).astype(np.float32)
    return arrays, labels


def _imperative_arrays(inputs, labels, dev, dtype="float32"):
    """The path's arrays on ``dev`` in ``dtype``, each with
    ``attach_grad()`` (write: every backward overwrites the buffers), and
    the labels."""
    from mxnet_tpu_torch import nd

    arrs = {k: nd.array(v, ctx=dev, dtype=dtype) for k, v in inputs.items()}
    for a in arrs.values():
        a.attach_grad()
    return arrs, nd.array(labels, ctx=dev)


def _imperative_run(torch, arrs, lab, B, L, fused):
    """One forward and backward of the imperative path under the
    fused_kernels pass or none: (loss, launches, wall ms)."""
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.passes import FusedKernelPass, PassPipeline

    pipe = PassPipeline([FusedKernelPass()] if fused else [])
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    C = IMP_H * IMP_HD
    arrs["x"].wait_to_read()
    t0 = time.perf_counter()
    with pipe.scope(), autograd.record():
        y = nd.contrib.add_layer_norm(arrs["x"], arrs["r"], arrs["gamma1"],
                                      arrs["beta1"])
        h = nd.LayerNorm(y, arrs["gamma2"], arrs["beta2"])
        q = h.reshape((B * IMP_H, L, IMP_HD))
        att = nd.contrib.flash_attention(q, arrs["k"], arrs["v"])
        logits = nd.FullyConnected(att.reshape((B * L, C)), arrs["weight"],
                                   arrs["bias"], num_hidden=BERT_VOCAB)
        loss = nd.softmax_cross_entropy(logits, lab)
    loss.backward()
    loss.wait_to_read()
    wall_ms = (time.perf_counter() - t0) * 1e3
    return (float(loss.asscalar()),
            {n: fn.launches for n, fn in counters.items()}, wall_ms)


def _grads(arrs):
    return {k: a.grad.asnumpy() for k, a in arrs.items()}


def _compare(loss_a, grads_a, loss_b, grads_b, loss_rel=1e-5,
             grad_of_max=1e-3):
    rel = abs(loss_a - loss_b) / abs(loss_b)
    diffs = {k: {"max_abs_diff": float(np.abs(grads_a[k] - grads_b[k]).max()),
                 "max_abs": float(np.abs(grads_b[k]).max())}
             for k in grads_b}
    finite = all(np.isfinite(g).all() for g in grads_a.values()) \
        and math.isfinite(loss_a)
    ok = finite and rel <= loss_rel and all(
        d["max_abs_diff"] <= grad_of_max * d["max_abs"]
        for d in diffs.values())
    return {"loss_rel_diff": rel, "grads": diffs, "finite": finite}, ok


def phase_imperative(torch, ctx):
    for key in ("bert", "train_step", "train_batch"):  # training is done
        ctx.pop(key, None)
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    B, L = TRAIN_BATCH, TRAIN_LEN
    arrs, lab = _imperative_arrays(*_imperative_inputs(B, L, SEED), dev)
    for fused in (True, False):  # warm-up of both
        _imperative_run(torch, arrs, lab, B, L, fused)
    torch.cuda.reset_peak_memory_stats()
    # pass on and off in turns; the last run of each gives its gradients
    order = (True, False, False, True, True, False)
    runs, grads, walls = {True: [], False: []}, {}, []
    for i, fused in enumerate(order):
        run = _imperative_run(torch, arrs, lab, B, L, fused)
        runs[fused].append(run)
        walls.append(["on" if fused else "off", run[2]])
        if fused not in order[i + 1:]:
            grads[fused] = _grads(arrs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = _imperative_profile(torch, arrs, lab, B, L)
    del arrs, lab
    on, off = runs[True][-1], runs[False][-1]
    ctx.setdefault("launches", {})["imperative"] = on[1]
    ctx["launches"]["imperative_pass_off"] = off[1]
    on_off, on_off_ok = _compare(on[0], grads[True], off[0], grads[False])
    launches_ok = (all(r[1] == IMP_PASS_ON for r in runs[True])
                   and all(r[1] == IMP_PASS_OFF for r in runs[False]))
    wall = {"wall_ms_pass_on": statistics.median(r[2] for r in runs[True]),
            "wall_ms_pass_off": statistics.median(r[2] for r in runs[False]),
            "wall_ms_runs": walls}
    del grads

    b2, l2 = 2, 128
    small = _imperative_inputs(b2, l2, SEED + 5)
    res = {}
    for d in (dev, torch.device("cpu")):
        arrs, lab = _imperative_arrays(*small, d)
        loss = _imperative_run(torch, arrs, lab, b2, l2, True)[0]
        res[d.type] = (loss, _grads(arrs))
    card_cpu, card_cpu_ok = _compare(*res["cuda"], *res["cpu"])
    return {"batch": [B, L], "hidden": IMP_H * IMP_HD, "heads": IMP_H,
            "head_dim": IMP_HD, "vocab": BERT_VOCAB,
            "launches_pass_on": on[1], "launches_pass_off": off[1],
            "launches_expected_on": IMP_PASS_ON,
            "launches_expected_off": IMP_PASS_OFF,
            **wall, "pass_on_vs_off": on_off, "card_vs_cpu": dict(
                card_cpu, batch=[b2, l2], loss_card=res["cuda"][0],
                loss_cpu=res["cpu"][0]),
            "tol": {"loss_rel": 1e-5, "grad_of_max_abs": 1e-3},
            "max_memory_allocated_gb": peak_gb, "profile_pass_on": profile,
            "ok": launches_ok and on_off_ok and card_cpu_ok}


# bf16 tolerances: the loss is a bf16 value (two units in its last place,
# 2^-6 relative); a gradient goes through several bf16 roundings (on the
# CPU, bf16 against f32 moves each by at most 1.5% of its max abs)
IMP_BF16_TOL = {"loss_rel": 2.0 ** -6, "grad_of_max_abs": 2.0 ** -5}


def phase_imperative_bf16(torch, ctx):
    """The imperative path with every array in bf16, so that K6, K1 and
    K3-K5 run in bf16 from the MXNet entry points: pass on and off (one
    warm-up and one run each, launches as in ``imperative``), on against
    off, then the card against the CPU on a (2 x 128)-token batch with the
    pass on, at IMP_BF16_TOL."""
    dev = torch.device("cuda", 0)
    B, L = TRAIN_BATCH, TRAIN_LEN
    tol = dict(loss_rel=IMP_BF16_TOL["loss_rel"],
               grad_of_max=IMP_BF16_TOL["grad_of_max_abs"])
    arrs, lab = _imperative_arrays(*_imperative_inputs(B, L, SEED), dev,
                                   "bfloat16")
    runs, grads = {}, {}
    for fused in (True, False):
        _imperative_run(torch, arrs, lab, B, L, fused)  # warm-up
        runs[fused] = _imperative_run(torch, arrs, lab, B, L, fused)
        grads[fused] = _grads(arrs)
    del arrs, lab
    torch.cuda.empty_cache()
    on, off = runs[True], runs[False]
    ctx.setdefault("launches", {})["imperative_bf16"] = on[1]
    launches_ok = on[1] == IMP_PASS_ON and off[1] == IMP_PASS_OFF
    on_off, on_off_ok = _compare(on[0], grads[True], off[0], grads[False],
                                 **tol)
    del grads
    b2, l2 = 2, 128
    small = _imperative_inputs(b2, l2, SEED + 5)
    res = {}
    for d in (dev, torch.device("cpu")):
        arrs, lab = _imperative_arrays(*small, d, "bfloat16")
        loss = _imperative_run(torch, arrs, lab, b2, l2, True)[0]
        res[d.type] = (loss, _grads(arrs))
    card_cpu, card_cpu_ok = _compare(*res["cuda"], *res["cpu"], **tol)
    return {"dtype": "bfloat16", "batch": [B, L],
            "launches_pass_on": on[1], "launches_pass_off": off[1],
            "wall_ms_pass_on": on[2], "wall_ms_pass_off": off[2],
            "pass_on_vs_off": on_off, "card_vs_cpu": dict(
                card_cpu, batch=[b2, l2], loss_card=res["cuda"][0],
                loss_cpu=res["cpu"][0]),
            "tol": IMP_BF16_TOL,
            "ok": launches_ok and on_off_ok and card_cpu_ok}


def _imperative_profile(torch, arrs, lab, B, L, runs=2):
    """Where forward and backward with the pass go: ``runs`` runs under
    torch.profiler, device time by kernel and the device's busy share;
    per run, with the count of each of the path's kernels the trace
    recorded."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_ms = sum(_imperative_run(torch, arrs, lab, B, L, True)[2]
                      for _ in range(runs))
    rows = _profile_rows(prof)
    busy = sum(ms for ms, _, _ in rows)
    ours = {k: {"ms": sum(ms for ms, _, key in rows if k in key) / runs,
                "count": sum(c for _, c, key in rows if k in key)}
            for k in ("add_layer_norm_",) + OUR_KERNELS
            if k != "paged_decode"}
    return {"runs": runs, "wall_ms": wall_ms / runs,
            "device_busy_ms": busy / runs if rows else None,
            "device_busy_share": busy / wall_ms if rows else None,
            "device_ops": sum(c for _, c, _ in rows),
            "our_kernels": ours,
            "top": [{"name": k[:100], "ms": ms / runs, "count": c}
                    for ms, c, k in rows[:12]]}


# ---------------------------------------------------------------------------
# bf16 BERT training (bench.py:660-690) and ResNet-50 v1b training
# (bench.py:758-800)
# ---------------------------------------------------------------------------
def phase_train_bf16(torch, ctx):
    """BERT-base cast to bf16 and trained with Adam at lr 1e-4, as
    bench.py:660-690 runs it on the TPU: the train cell in bf16."""
    from mxnet_tpu_torch.gluon.block import cast
    from mxnet_tpu_torch.models.bert import bert_base
    from mxnet_tpu_torch.parallel import DataParallelStep

    for key in ("bert", "train_step"):  # the f32 model is done
        ctx.pop(key, None)
    torch.cuda.empty_cache()
    model = cast(bert_base(BERT_VOCAB, dropout=0.0,
                           generator=torch.Generator().manual_seed(SEED)),
                 "bfloat16")
    dtypes = sorted({str(t.dtype) for t in model.state_dict().values()
                     if t.is_floating_point()})
    step = DataParallelStep(model, _mlm_loss(torch), optimizer="adam",
                            optimizer_params={"learning_rate": 1e-4})
    tokens, labels = ctx["train_batch"]
    torch.cuda.reset_peak_memory_stats()
    first = float(step.step(tokens, labels))  # warm-up
    counters = _counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    losses, step_ms, wall = _train_steps(torch, step, tokens, labels,
                                         TRAIN_STEPS)
    launches = {n: fn.launches for n, fn in counters.items()}
    ctx["launches"]["train_bf16"] = launches
    expected = {n: k * TRAIN_STEPS for n, k in TRAIN_PER_STEP.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = _step_profile(torch, lambda: step.step(tokens, labels))
    flash = {k: prof["our_kernels_ms"][k]
             for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    busy = prof["device_busy_ms"]  # one step
    losses = [first] + losses
    f32 = ctx.get("train_f32", {})
    tps = TRAIN_BATCH * TRAIN_LEN * TRAIN_STEPS / wall
    del step, model
    torch.cuda.empty_cache()
    return {
        "model": "bert_base", "dtype": "bfloat16", "state_dtypes": dtypes,
        "batch": TRAIN_BATCH, "seq_len": TRAIN_LEN, "optimizer": "adam",
        "learning_rate": 1e-4, "steps": TRAIN_STEPS, "wall_s": wall,
        "tokens_per_s": tps, "step_ms_median": statistics.median(step_ms),
        "step_ms": step_ms, "losses": losses,
        "max_memory_allocated_gb": peak_gb,
        "f32_train_phase": f32,
        "tokens_per_s_over_f32": tps / f32["tokens_per_s"] if f32 else None,
        "launches": launches, "launches_expected": expected,
        "profile_one_step": prof, "flash_ms": flash,
        "flash_share_of_busy": sum(flash.values()) / busy if busy else None,
        "card": ctx["smi"],
        "ok": bool(all(math.isfinite(x) for x in losses)
                   and losses[-1] < losses[0] and launches == expected
                   and dtypes == ["torch.bfloat16"])}


RESNET_BATCH, RESNET_RES = 256, 224  # bench.py:768-769
RESNET_WARMUP, RESNET_STEPS = 2, 5
RESNET_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
# dense peaks of an H100 SXM at 700 W (data sheet): f32 on the CUDA
# cores, bf16 on the tensor cores
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# NCHW <-> NHWC conversion kernels (cuDNN's and generic transposes)
TRANSPOSE_MARKS = ("nchwtonhwc", "nhwctonchw", "transpose")


def _cudnn_settings(torch):
    b = torch.backends.cudnn
    return {"enabled": b.enabled, "benchmark": b.benchmark,
            "deterministic": b.deterministic, "allow_tf32": b.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def _resnet_census(torch, model, x1):
    """From one forward of a single image: the multiply-adds of each
    conv and the dense layer, and how many module outputs are not
    contiguous in the net's layout (a channels_last leak shows there)."""
    from mxnet_tpu_torch.gluon.nn import Conv2D, Dense

    macs, loose = [], []

    def hook(m, _inp, out):
        if isinstance(m, Conv2D):
            kh, kw = m.kwargs["kernel"]
            macs.append((m, out.numel() * m.weight.shape[1] * kh * kw))
        elif isinstance(m, Dense):
            macs.append((m, out.numel() * m.weight.shape[1]))
        if torch.is_tensor(out) and not out.is_contiguous():
            loose.append(type(m).__name__)

    handles = [m.register_forward_hook(hook) for m in model.modules()]
    model.eval()
    try:
        with torch.no_grad():
            model(x1)
    finally:
        for h in handles:
            h.remove()
        model.train()
    stem = model.features[0]
    fwd = 2 * sum(n for _, n in macs)
    # backward: the weight gradient and the data gradient of each, but
    # no data gradient for the stem (the images need none)
    bwd = 2 * sum(n if m is stem else 2 * n for m, n in macs)
    return fwd, bwd, loose


def _resnet_cell(torch, ctx, layout, dtype):
    """resnet50_v1b at batch 256, 224^2, trained by DataParallelStep with
    SGD as bench.py:771-781, cuDNN autotuning on (benchmark) and TF32
    off: warm-up, then timed steps with every kernel counter zeroed."""
    from mxnet_tpu_torch.gluon.block import cast
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models.resnet import resnet50_v1b
    from mxnet_tpu_torch.parallel import DataParallelStep

    torch.backends.cudnn.benchmark = True
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = resnet50_v1b(layout=layout,
                         generator=torch.Generator().manual_seed(SEED))
    if dtype != "float32":
        cast(model, dtype)
    init_s = time.perf_counter() - t0
    values = sum(t.numel() for t in model.state_dict().values())
    step = DataParallelStep(model, SoftmaxCrossEntropyLoss(),
                            optimizer="sgd", optimizer_params=RESNET_SGD)
    B, R = RESNET_BATCH, RESNET_RES
    rng = np.random.RandomState(SEED)
    shape = (B, 3, R, R) if layout == "NCHW" else (B, R, R, 3)
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda().to(
        getattr(torch, dtype))
    y = torch.from_numpy(rng.randint(0, 1000, B).astype(np.float32)).cuda()
    fwd1, bwd1, loose = _resnet_census(torch, model, x[:1])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = [float(step.step(x, y)) for _ in range(RESNET_WARMUP)]
    warm_s = time.perf_counter() - t0
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    losses, step_ms, wall = _train_steps(torch, step, x, y, RESNET_STEPS)
    launches = {n: fn.launches for n, fn in counters.items()}
    ctx["launches"][f"train_resnet{'' if dtype == 'float32' else '_bf16'}"] \
        = launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(step_ms)
    flops = (fwd1 + bwd1) * B
    ctx[f"resnet_{dtype}"] = (step, x, y)
    losses = warm + losses
    return {
        "model": "resnet50_v1b", "layout": layout, "dtype": dtype,
        "state_values": values, "init_s": init_s, "batch": B,
        "resolution": R, "optimizer": "sgd", **RESNET_SGD,
        "warmup_steps": RESNET_WARMUP, "warmup_s": warm_s,
        "steps": RESNET_STEPS, "wall_s": wall,
        "images_per_s": B * RESNET_STEPS / wall,
        "step_ms_median": med, "step_ms": step_ms, "losses": losses,
        "max_memory_allocated_gb": peak_gb,
        "model_flops_per_step": flops,
        "model_flops_fwd_per_image": fwd1, "model_flops_bwd_per_image": bwd1,
        "peak_flops": PEAK_FLOPS[dtype],
        "model_flop_share": flops / (med / 1e3) / PEAK_FLOPS[dtype],
        "model_flop_share_is": "conv + dense fwd and bwd FLOPs / (median "
                               "step ms x the dtype's dense peak)",
        "non_contiguous_outputs": loose,
        "launches": launches, "cudnn": _cudnn_settings(torch),
        "card": ctx["smi"],
        "ok": bool(all(math.isfinite(v) for v in losses)
                   and values == 25_610_152 and not loose
                   and all(v == 0 for v in launches.values()))}


def phase_train_resnet(torch, ctx):
    return _resnet_cell(torch, ctx, "NCHW", "float32")


def _bf16_step_spread(torch, step, x, y):
    """From the bf16 cell's state after its steps: one forward and
    backward of the bf16 net and of an f32 copy of it on the same batch
    (each tensor's |g_bf16 - g_f32| / |g_f32|, the measure of what bf16
    rounding does to this step's gradient), and the share of the bf16
    weights' elements that one more step leaves unchanged (an update
    below half a bf16 spacing of its weight is lost)."""
    import copy

    from mxnet_tpu_torch.gluon.block import cast

    f32 = cast(copy.deepcopy(step.block), "float32")
    grads, losses = {}, {}
    for tag, net, inp in (("bf16", step.block, x), ("f32", f32, x.float())):
        net.train()
        loss = step.loss_fn(net(inp), y).float().mean()
        grads[tag] = torch.autograd.grad(loss, [p for p in net.parameters()
                                                if p.requires_grad])
        losses[tag] = float(loss.detach())
    del f32
    rel = sorted(float((a.float() - b).norm() / b.norm())
                 for a, b in zip(grads["bf16"], grads["f32"]))
    del grads
    before = [p.detach().clone() for p in step.params]
    step.step(x, y)
    same = sum(int((p == b).sum()) for p, b in zip(step.params, before))
    total = sum(p.numel() for p in step.params)
    return {"loss_bf16": losses["bf16"], "loss_f32": losses["f32"],
            "grad_rel_median": statistics.median(rel),
            "grad_rel_max": rel[-1],
            "grad_tensors_over_half": sum(r > 0.5 for r in rel),
            "tensors": len(rel), "weights_unchanged_share": same / total}


def phase_train_resnet_bf16(torch, ctx):
    res = _resnet_cell(torch, ctx, "NHWC", "bfloat16")
    step, x, y = ctx["resnet_bfloat16"]
    prof = _step_profile(torch, lambda: step.step(x, y), top=20)
    hits = [r["name"] for r in prof["top"]
            if any(m in r["name"].lower() for m in TRANSPOSE_MARKS)]
    res.update(profile_one_step=prof, transpose_kernels_in_top=hits,
               bf16_vs_f32_step=_bf16_step_spread(torch, step, x, y),
               ok=res["ok"] and not hits)
    return res


# card vs CPU on one training forward and backward: each tolerance is 5x
# the spread between the port's own f32 and float64 runs on the CPU at
# this batch (BatchNorm over 4 images at 2 x 2 in the last stage is badly
# conditioned: f32 moves the stem's gradient by 2% of its max abs)
RESNET_PARITY_TOL = {"logits_of_max_abs": 5e-4, "loss_rel": 5e-5,
                     "conv_grad_of_max_abs": 0.1,
                     "dense_grad_of_max_abs": 1e-3,
                     "running_stats_of_max_abs": 3e-4}
RESNET_PARITY_GRADS = ("features.0.weight", "features.5.0.body.4.weight",
                       "output.weight")


def phase_train_resnet_parity(torch, ctx):
    """resnet50_v1b on the card vs the same weights on the CPU, in NCHW
    and NHWC, f32: one training-mode forward and backward of a (4, 3,
    64, 64) batch: logits, loss, three gradients and every running stat
    after the forward.  Then bf16 NHWC: 3 SGD steps of the card against
    the CPU, each from the CPU step's state (:func:`resnet_bf16_replay`)."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models.resnet import resnet50_v1b

    tol = RESNET_PARITY_TOL
    out, ok = {}, True
    for layout in ("NCHW", "NHWC"):
        cpu_net = resnet50_v1b(layout=layout, device="cpu",
                               generator=torch.Generator().manual_seed(SEED))
        card_net = resnet50_v1b(layout=layout,
                                generator=torch.Generator().manual_seed(SEED))
        rng = np.random.RandomState(SEED + 6)
        shape = (4, 3, 64, 64) if layout == "NCHW" else (4, 64, 64, 3)
        x = torch.from_numpy(rng.rand(*shape).astype(np.float32))
        y = torch.from_numpy(rng.randint(0, 1000, 4).astype(np.float32))
        res = {}
        for net, dev in ((card_net, "cuda"), (cpu_net, "cpu")):
            net.train()
            logits = net(x.to(dev))
            loss = SoftmaxCrossEntropyLoss()(logits, y.to(dev)).float().mean()
            loss.backward()
            params = dict(net.named_parameters())
            res[dev] = (logits.detach().cpu(), float(loss.detach()),
                        {n: params[n].grad.cpu() for n in RESNET_PARITY_GRADS},
                        {k: v.cpu() for k, v in net.state_dict().items()
                         if "running" in k})

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())

        (lg_g, l_g, g_g, s_g), (lg_c, l_c, g_c, s_c) = res["cuda"], res["cpu"]
        row = {"logits_of_max_abs": rel(lg_g, lg_c),
               "loss_card": l_g, "loss_cpu": l_c,
               "loss_rel": abs(l_g - l_c) / abs(l_c),
               "grads_of_max_abs": {n: rel(g_g[n], g_c[n]) for n in g_c},
               "running_stats_of_max_abs": max(rel(s_g[k], s_c[k])
                                               for k in s_c)}
        row_ok = (row["logits_of_max_abs"] <= tol["logits_of_max_abs"]
                  and row["loss_rel"] <= tol["loss_rel"]
                  and row["running_stats_of_max_abs"]
                  <= tol["running_stats_of_max_abs"]
                  and all(v <= tol["dense_grad_of_max_abs" if n == "output."
                                   "weight" else "conv_grad_of_max_abs"]
                          for n, v in row["grads_of_max_abs"].items()))
        out[layout] = dict(row, ok=row_ok)
        ok = ok and row_ok
        del card_net
    t0 = time.perf_counter()
    bf16 = resnet_bf16_replay(torch, "cuda")
    bf16["seconds"] = time.perf_counter() - t0
    return {"batch": [4, 3, 64, 64], "tol": tol, **out, "bf16_nhwc": bf16,
            "cudnn": _cudnn_settings(torch), "ok": ok and bf16["ok"]}


# card vs CPU in bf16 over 3 SGD steps, each from the CPU step's state
# before it.  A ResNet's bf16 step is far from its f32 one (on the narrow
# net of tests/test_torch_training_bf16.py the bf16 gradient is 30% of a
# tensor's norm from the f32 one in the median, in both packages), so
# free runs part within a step at lr 0.1, and every bound is set by a CPU
# f32 step from the same state, the measure of what bf16 rounding does
# there: two roundings of the same size differ by about sqrt(2) times
# one.  The loss within 2x the f32 step's distance from the CPU bf16
# step's plus one bf16 spacing (2^-7 relative); the momenta and the
# running stats, each summed in squares over the tensors, within 2x the
# f32 step's distance; each momentum tensor within 3x; each weight
# element within its momentum's distance plus one bf16 spacing at its
# value (both round w + m to bf16 once).
RESNET_BF16_REPLAY_TOL = {"loss_vs_f32": 2.0, "loss_spacing": 2.0 ** -7,
                          "summed_vs_f32": 2.0, "per_tensor_vs_f32": 3.0}


def _bf16_spacing(torch, x):
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _copy_train_state(torch, dst_net, dst_step, src_net, src_step):
    """Weights, running stats and momenta of ``src`` into ``dst`` (the
    same model; dtypes and devices may differ)."""
    dst_net.load_state_dict(src_net.state_dict())
    with torch.no_grad():
        for d, s in zip(dst_step.opt_state[0], src_step.opt_state[0]):
            d.copy_(s)


def _summed_ratio(torch, got, want, probe):
    """(sqrt(sum |got - want|^2) / sqrt(sum |probe - want|^2), the worst
    tensor's |got - want| / |probe - want|) over lists of tensors."""
    off = floor = worst = 0.0
    for g, w, p in zip(got, want, probe):
        w = w.detach().float()
        d = float((g.detach().cpu().float() - w).norm())
        f = float((p.detach().float() - w).norm())
        off, floor = off + d * d, floor + f * f
        worst = max(worst, d / f if f > 0 else (0.0 if d == 0 else math.inf))
    return ((off / floor) ** 0.5 if floor > 0 else math.inf), worst


def resnet_bf16_replay(torch, device, steps=3, batch=16, res=64):
    """resnet50_v1b NHWC in bf16: ``steps`` SGD steps on ``device``, each
    from the CPU bf16 step's state before it, against that CPU step,
    with a CPU f32 step from the same state as the measure of bf16
    rounding (RESNET_BF16_REPLAY_TOL)."""
    from mxnet_tpu_torch.gluon.block import cast
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models.resnet import resnet50_v1b
    from mxnet_tpu_torch.parallel import DataParallelStep

    tol = RESNET_BF16_REPLAY_TOL
    rng = np.random.RandomState(SEED + 7)
    x = torch.from_numpy(rng.rand(batch, res, res, 3).astype(
        np.float32)).to(torch.bfloat16)
    y = torch.from_numpy(rng.randint(0, 1000, batch).astype(np.float32))
    runs = {}
    for tag, dev, dtype in (("cpu", "cpu", "bfloat16"),
                            ("f32", "cpu", "float32"),
                            ("card", device, "bfloat16")):
        net = cast(resnet50_v1b(layout="NHWC", device="cpu",
                                generator=torch.Generator().manual_seed(
                                    SEED)), "bfloat16")
        if dtype == "float32":
            cast(net, "float32")
        runs[tag] = (net, DataParallelStep(
            net, SoftmaxCrossEntropyLoss(), optimizer="sgd",
            optimizer_params=RESNET_SGD, device=dev), getattr(torch, dtype))
    ref_net, ref_step, _ = runs["cpu"]
    names = [n for n, p in ref_net.named_parameters() if p.requires_grad]

    def stats(tag):
        return [b for n, b in runs[tag][0].named_buffers() if "running" in n]

    rows, ok = [], True
    for k in range(steps):
        for tag in ("card", "f32"):
            _copy_train_state(torch, *runs[tag][:2], ref_net, ref_step)
        loss = {}
        for tag in ("card", "f32", "cpu"):
            _, step, dtype = runs[tag]
            loss[tag] = float(step.step(x.to(step.device, dtype),
                                        y.to(step.device)))
        card, f32 = runs["card"][1], runs["f32"][1]
        mom, mom_worst = _summed_ratio(torch, card.opt_state[0],
                                       ref_step.opt_state[0],
                                       f32.opt_state[0])
        st, _ = _summed_ratio(torch, stats("card"), stats("cpu"),
                              stats("f32"))
        weights_off = []
        for name, p_ref, p_card, m_ref, m_card in zip(
                names, ref_step.params, card.params, ref_step.opt_state[0],
                card.opt_state[0]):
            w, wr = p_card.detach().cpu().float(), p_ref.detach().float()
            allow = ((m_card.cpu() - m_ref).abs()
                     + _bf16_spacing(torch, torch.maximum(w.abs(), wr.abs()))
                     + 2.0 ** -23 * wr.abs())
            if not bool(((w - wr).abs() <= allow).all()):
                weights_off.append(name)
        d_loss, f_loss = (abs(loss[t] - loss["cpu"]) for t in ("card", "f32"))
        row = {"step": k + 1, "loss_card": loss["card"],
               "loss_cpu": loss["cpu"], "loss_cpu_f32": loss["f32"],
               "loss_vs_f32": d_loss / f_loss if f_loss > 0 else None,
               "momenta_summed_vs_f32": mom,
               "momentum_worst_tensor_vs_f32": mom_worst,
               "running_stats_summed_vs_f32": st,
               "weights_off": weights_off}
        row["ok"] = bool(
            math.isfinite(loss["card"])
            and d_loss <= (tol["loss_vs_f32"] * f_loss
                           + tol["loss_spacing"] * abs(loss["cpu"]))
            and mom <= tol["summed_vs_f32"] and st <= tol["summed_vs_f32"]
            and mom_worst <= tol["per_tensor_vs_f32"] and not weights_off)
        ok = ok and row["ok"]
        rows.append(row)
    return {"model": "resnet50_v1b", "layout": "NHWC", "dtype": "bfloat16",
            "batch": [batch, res, res, 3], "steps": rows, "tol": tol,
            "ok": ok}


def phase_train_resnet_profile(torch, ctx):
    """One profiled training step of each ResNet cell, after one step
    that is not profiled (the allocator regrows its pools after the
    phases between): busy share, the top kernels by name and the largest
    host gaps between device activities."""
    torch.backends.cudnn.benchmark = True
    res = {}
    for dtype in ("bfloat16", "float32"):
        step, x, y = ctx.pop(f"resnet_{dtype}")
        step.step(x, y)
        res[dtype] = _step_profile(torch, lambda: step.step(x, y),
                                   gaps=True)
        del step, x, y
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Transformer-big training (BASELINE config 4, bench.py:706-751) and the
# optimizer layer
# ---------------------------------------------------------------------------
TT_VOCAB, TT_BATCH, TT_LEN = 32000, 16, 128  # bench.py:719-722
TT_WARMUP, TT_STEPS = 2, 5
TT_PARAMS = 210_173_952
# K1 launches a step: 6 encoder cells x 2 LayerNorms + 6 decoder cells x
# 3; every attention carries a padding mask, so no flash kernel runs
TT_PER_STEP = {n: 0 for n in ALL_KERNELS}
TT_PER_STEP["layer_norm"] = 30


def _lsce(logits, labels):
    from mxnet_tpu_torch.models.transformer import label_smoothed_ce

    return label_smoothed_ce(logits, labels, smoothing=0.1)


def _transformer_cell(torch, ctx, dtype):
    """Transformer-big trained as bench_transformer trains it: vocab
    32000, dropout 0.3, Adam lr 1e-4, label smoothing 0.1, a batch of 16
    sources of 128 tokens and 129-token targets (bench.py:735-743)."""
    from mxnet_tpu_torch.gluon.block import cast
    from mxnet_tpu_torch.models.transformer import transformer_big
    from mxnet_tpu_torch.parallel import DataParallelStep

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = transformer_big(TT_VOCAB,
                            generator=torch.Generator().manual_seed(SEED))
    if dtype == "bfloat16":
        cast(model, dtype)  # bench.py:729-730
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    dtypes = sorted({str(t.dtype) for t in model.state_dict().values()
                     if t.is_floating_point()})
    step = DataParallelStep(model, _lsce, optimizer="adam",
                            optimizer_params={"learning_rate": 1e-4})
    rng = np.random.RandomState(SEED)
    src = rng.randint(3, TT_VOCAB, (TT_BATCH, TT_LEN)).astype(np.int32)
    tgt_in = np.concatenate([np.ones((TT_BATCH, 1), np.int32),
                             src[:, ::-1]], axis=1)
    tgt_out = np.concatenate([src[:, ::-1],
                              np.full((TT_BATCH, 1), 2, np.int32)], axis=1)
    dev = torch.device("cuda", 0)
    data = (torch.from_numpy(src).to(dev),
            torch.from_numpy(np.ascontiguousarray(tgt_in)).to(dev))
    label = torch.from_numpy(tgt_out.astype(np.float32)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    warm = [float(step.step(data, label)) for _ in range(TT_WARMUP)]
    counters = _counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    losses, step_ms, wall = _train_steps(torch, step, data, label, TT_STEPS)
    launches = {n: fn.launches for n, fn in counters.items()}
    path = "train_transformer" + ("_bf16" if dtype == "bfloat16" else "")
    ctx["launches"][path] = launches
    expected = {n: k * TT_STEPS for n, k in TT_PER_STEP.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = _step_profile(torch, lambda: step.step(data, label))
    busy = prof["device_busy_ms"]
    ln_ms = prof["our_kernels_ms"]["ln_fwd_"]
    losses = warm + losses
    tps = TT_BATCH * (TT_LEN + 1) * TT_STEPS / wall  # bench.py:745
    del step, model, data, label
    torch.cuda.empty_cache()
    return {
        "model": "transformer_big", "dtype": dtype, "state_dtypes": dtypes,
        "vocab": TT_VOCAB, "params": n_params, "dropout": 0.3,
        "init_s": init_s, "batch": TT_BATCH, "src_len": TT_LEN,
        "tgt_len": TT_LEN + 1, "optimizer": "adam", "learning_rate": 1e-4,
        "loss": "label_smoothed_ce(smoothing=0.1)",
        "warmup_steps": TT_WARMUP, "steps": TT_STEPS, "wall_s": wall,
        "tokens_per_s": tps, "step_ms_median": statistics.median(step_ms),
        "step_ms": step_ms, "losses": losses,
        "max_memory_allocated_gb": peak_gb,
        "launches": launches, "launches_expected": expected,
        "profile_one_step": prof, "layer_norm_ms": ln_ms,
        "layer_norm_share_of_busy": ln_ms / busy if busy else None,
        "card": ctx["smi"],
        "ok": bool(all(math.isfinite(x) for x in losses)
                   and losses[-1] < losses[0] and launches == expected
                   and n_params == TT_PARAMS
                   and dtypes == [f"torch.{dtype}"])}


def phase_train_transformer(torch, ctx):
    return _transformer_cell(torch, ctx, "float32")


def phase_train_transformer_bf16(torch, ctx):
    return _transformer_cell(torch, ctx, "bfloat16")


# card vs CPU on the step's features: Transformer-big's widths at 2 + 2
# layers, dropout 0, a padded batch of 4 (sources 32, targets 33), 2 Adam
# steps under a CosineScheduler with warmup, clip_global_norm 1.0 and one
# parameter at lr_mult 0.5; then again with accum_steps 2 and remat.
TT_PARITY_CFG = dict(units=1024, hidden_size=4096, num_heads=16,
                     num_layers=2, dropout=0.0)
TT_PARITY_RUNS = {"schedule_clip_mult": {},
                  "accum_remat": {"accum_steps": 2, "remat": True}}
# K1 a run of 2 steps: 2 x 2 + 2 x 3 LayerNorms a forward; one forward a
# step, or per microbatch a forward and its recomputation under remat
TT_PARITY_K1 = {"schedule_clip_mult": 10 * 2, "accum_remat": 2 * 2 * 20}
# The yardstick is the same model on the CPU in float64, its LayerNorms
# included (torch's own layer_norm there: the port's LayerNorm computes in
# f32 whatever its input, as K1 does); its update is the step's own f32
# arithmetic on the float64 gradient.  A ReLU input that lies within
# rounding of zero lands on either side in an f32 forward, and its
# gradient then flows or does not: the witness counts, per device, the
# FFN ReLU inputs whose sign differs from the yardstick's.  The card's
# gradient is held to the yardstick; the CPU's f32 one is reported beside
# it.  Adam moves an element whose gradient is rounding noise by a full lr
# step of either sign, so the updates are compared where the yardstick's
# gradient at the start is not zero to within rounding (|g| at least 1e-6
# of the model's largest |g|, the rule of
# tests/test_torch_transformer_training.py).
TT_PARITY_TOL = {"loss_rel": 1e-5, "grad_rel_model": 1e-5,
                 "update_rel_model": 5e-4, "update_rel_tensor": 2e-2}
TT_PARITY_NOISE = 1e-6


def _parity_batch():
    rng = np.random.RandomState(SEED + 5)
    src = rng.randint(3, TT_VOCAB, (4, 32)).astype(np.int32)
    src[1, 20:] = 0
    src[3, 9:] = 0
    tgt = rng.randint(3, TT_VOCAB, (4, 32)).astype(np.int32)
    tgt[2, 25:] = 0
    tgt[0, 30:] = 0
    tgt_in = np.concatenate([np.ones((4, 1), np.int32), tgt], axis=1)
    tgt_out = np.concatenate([tgt, np.full((4, 1), 2, np.int32)], axis=1)
    tgt_out[2, 26:] = 0
    tgt_out[0, 31:] = 0
    return src, tgt_in, tgt_out.astype(np.float32)


def _parity_net(torch, start, device, float64=False):
    """The parity model from ``start``; with ``float64`` the CPU yardstick,
    its LayerNorms in float64 too."""
    from mxnet_tpu_torch.gluon.nn import LayerNorm
    from mxnet_tpu_torch.models.transformer import Transformer

    net = Transformer(TT_VOCAB, device=device, **TT_PARITY_CFG)
    net.load_state_dict(start)
    if float64:
        net.double()
        for m in net.modules():
            if isinstance(m, LayerNorm):
                m.forward = (lambda x, m=m: torch.nn.functional.layer_norm(
                    x, (x.shape[-1],), m.weight, m.bias, m.eps))
    return net


def _parity_inputs(torch, device):
    return tuple(torch.from_numpy(a).to(device) for a in _parity_batch())


def _parity_run(torch, start, device, opts, float64=False):
    from mxnet_tpu_torch.optimizer.lr_scheduler import CosineScheduler
    from mxnet_tpu_torch.parallel import DataParallelStep

    net = _parity_net(torch, start, device, float64)
    net.encoder.layers[0].attn.qkv.weight.lr_mult = 0.5
    step = DataParallelStep(
        net, _lsce, optimizer="adam", device=device, clip_global_norm=1.0,
        optimizer_params={"learning_rate": 1e-4,
                          "lr_scheduler": CosineScheduler(
                              max_update=4, warmup_steps=1,
                              warmup_begin_lr=1e-5)}, **opts)
    src, tgt_in, label = _parity_inputs(torch, device)
    losses = [float(step.step((src, tgt_in), label)) for _ in range(2)]
    return losses, {k: v.detach().cpu().double()
                    for k, v in net.state_dict().items()}


def _rel_l2(got, want):
    """(relative L2 distance over every tensor, worst (ratio, name))."""
    num = den = 0.0
    worst = (0.0, "")
    for key, w in want.items():
        diff, ref = float((got[key] - w).norm()), float(w.norm())
        num, den = num + diff ** 2, den + ref ** 2
        if ref > 0:
            worst = max(worst, (diff / ref, key))
    return math.sqrt(num / den), worst


def _parity_grads(torch, start, device, float64=False):
    """The loss, every parameter's gradient and every FFN's ReLU input of
    one training forward and backward from ``start``."""
    net = _parity_net(torch, start, device, float64).train()
    relu_in = []
    for m in net.modules():
        if hasattr(m, "ffn_1"):
            m.ffn_1.register_forward_hook(
                lambda mod, inp, out: relu_in.append(out.detach().cpu()))
    src, tgt_in, label = _parity_inputs(torch, device)
    loss = _lsce(net(src, tgt_in), label)
    loss.backward()
    return (float(loss.detach()),
            {k: p.grad.detach().cpu().double()
             for k, p in net.named_parameters()}, relu_in)


def _relu_flips(relu_in, ref):
    """How many ReLU inputs lie on the other side of zero than the
    yardstick's, and the largest |input| of the yardstick among them."""
    n, worst = 0, 0.0
    for z, z64 in zip(relu_in, ref):
        flip = (z > 0) != (z64 > 0)
        n += int(flip.sum())
        if flip.any():
            worst = max(worst, float(z64[flip].abs().max()))
    return {"flips": n, "max_abs_float64_input_at_flips": worst}


def phase_train_transformer_parity(torch, ctx):
    from mxnet_tpu_torch.models.transformer import Transformer

    start = Transformer(TT_VOCAB, device="cpu",
                        generator=torch.Generator().manual_seed(SEED + 6),
                        **TT_PARITY_CFG).state_dict()
    losses, grads, relu = {}, {}, {}
    for name, dev, f64 in (("card", torch.device("cuda", 0), False),
                           ("cpu", "cpu", False),
                           ("float64", "cpu", True)):
        losses[name], grads[name], relu[name] = _parity_grads(torch, start,
                                                              dev, f64)
    ref = grads.pop("float64")
    top = max(float(g.abs().max()) for g in ref.values())
    # the elements whose gradient is rounding noise
    noise = {k: g.abs() < TT_PARITY_NOISE * top for k, g in ref.items()}
    grad = {f"{name}_vs_float64": _rel_l2(g, ref)[0]
            for name, g in grads.items()}
    grad["card_vs_cpu"] = _rel_l2(grads["card"], grads["cpu"])[0]
    witness = {name: _relu_flips(relu[name], relu["float64"])
               for name in ("card", "cpu")}
    del grads, ref, relu
    ok = grad["card_vs_float64"] <= TT_PARITY_TOL["grad_rel_model"]
    k1 = _counters()["layer_norm"]
    runs = {}
    for name, opts in TT_PARITY_RUNS.items():
        k1.launches = 0
        loss_g, w_g = _parity_run(torch, start, torch.device("cuda", 0),
                                  opts)
        launches = k1.launches
        loss_c, w_c = _parity_run(torch, start, "cpu", opts)
        loss_y, w_y = _parity_run(torch, start, "cpu", opts, float64=True)
        upd = {k: {dev: (w[k] - w0.double())[~noise[k]]
                   for dev, w in (("card", w_g), ("cpu", w_c),
                                  ("float64", w_y))}
               for k, w0 in start.items()}
        model_rel, worst = _rel_l2({k: u["card"] for k, u in upd.items()},
                                   {k: u["float64"] for k, u in upd.items()})
        cpu_rel = _rel_l2({k: u["cpu"] for k, u in upd.items()},
                          {k: u["float64"] for k, u in upd.items()})
        rel = [abs(a - b) / abs(b) for a, b in zip(loss_g, loss_y)]
        rel_cpu = [abs(a - b) / abs(b) for a, b in zip(loss_g, loss_c)]
        res = {"opts": opts, "losses_card": loss_g, "losses_cpu": loss_c,
               "losses_float64": loss_y, "loss_rel_diff": rel,
               "loss_rel_diff_card_vs_cpu": rel_cpu,
               "update_rel_model": model_rel,
               "update_rel_worst_tensor": worst[0], "worst_tensor": worst[1],
               "cpu_update_rel_model": cpu_rel[0],
               "cpu_update_rel_worst_tensor": cpu_rel[1][0],
               "k1_launches": launches, "k1_expected": TT_PARITY_K1[name]}
        res["ok"] = bool(
            max(rel + rel_cpu) <= TT_PARITY_TOL["loss_rel"]
            and model_rel <= TT_PARITY_TOL["update_rel_model"]
            and worst[0] <= TT_PARITY_TOL["update_rel_tensor"]
            and launches == TT_PARITY_K1[name]
            and loss_g[1] < loss_g[0])
        ok = ok and res["ok"]
        runs[name] = res
    torch.cuda.empty_cache()
    n_noise = sum(int(m.sum()) for m in noise.values())
    return {"config": TT_PARITY_CFG, "batch": [4, 32, 33],
            "tol": TT_PARITY_TOL, "losses_one_forward": losses,
            "grad_rel_l2": grad, "relu_sign_vs_float64": witness,
            "noise_elements": n_noise,
            "noise_share": n_noise / sum(w.numel() for w in start.values()),
            "runs": runs, "ok": ok}


# one BERT-base layer's parameter shapes (qkv, proj, ffn_1, ffn_2, a
# LayerNorm gamma, ffn_1's bias) and the position embedding
OPT_SHAPES = ((2304, 768), (768, 768), (3072, 768), (768, 3072), (768,),
              (3072,), (512, 768))
OPT_CLASSES = {"sgd": dict(momentum=0.9), "nag": dict(momentum=0.9),
               "adam": {}, "adamax": {}, "nadam": {}, "adagrad": {},
               "adadelta": {}, "rmsprop": dict(centered=True), "ftrl": {},
               "signum": dict(wd_lh=1e-3), "lamb": {}}
OPT_FUSED = ("sgd", "adam", "rmsprop")
# card vs CPU: the same f32 element-wise formulas, rounded in another
# order where the card's compiler contracts a multiply and an add (and
# LAMB's norms sum in another order); fused vs per-parameter on the card
# at the JAX fused test's tolerance
OPT_TOL = {"card_vs_cpu": {"rtol": 1e-5, "atol": 1e-6},
           "fused_vs_per_param": {"rtol": 1e-6, "atol": 1e-7}}


def _opt_inputs(rng, steps=3):
    ws = [rng.standard_normal(s).astype(np.float32) * 0.05
          for s in OPT_SHAPES]
    # each element keeps one sign over the updates, at least 0.5 away
    # from zero, so no momentum sits at zero where sign() (Signum) jumps
    signs = [np.sign(rng.standard_normal(s)).astype(np.float32)
             for s in OPT_SHAPES]
    gs = [[sg * (0.5 + rng.random_sample(s).astype(np.float32))
           for sg, s in zip(signs, OPT_SHAPES)] for _ in range(steps)]
    return ws, gs


def _opt_run(torch, name, device, ws, gs, fused):
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.optimizer import FusedUpdater, Updater, create
    from mxnet_tpu_torch.optimizer.lr_scheduler import FactorScheduler

    opt = create(name, learning_rate=0.01, wd=1e-3, rescale_grad=0.5,
                 clip_gradient=1.2,
                 lr_scheduler=FactorScheduler(step=1, factor=0.9),
                 **OPT_CLASSES[name])
    opt.set_lr_mult({1: 0.5})
    upd = FusedUpdater(opt) if fused else Updater(opt)
    w = [NDArray(torch.tensor(x, device=device)) for x in ws]
    for g in gs:
        entries = [(i, NDArray(torch.tensor(x, device=device)), w[i])
                   for i, x in enumerate(g)]
        if fused:
            upd.apply(entries)
        else:
            for i, gi, wi in entries:
                upd(i, gi, wi)
    return [x.data.cpu() for x in w], (upd.last_info if fused else None)


def _close(torch, got, want, tol):
    return max(float(((a - b).abs() - tol["rtol"] * b.abs()).max())
               for a, b in zip(got, want)) <= tol["atol"]


def phase_optimizer(torch, ctx):
    """The imperative optimizer path on the card: each of the 11 classes
    through ``Updater`` for 3 updates of one BERT-base layer's parameters
    (an lr scheduler on, one parameter at lr_mult 0.5), against the same
    updates on the CPU; SGD, Adam and RMSProp also through the fused
    updater, against the per-parameter one; ``clip_global_norm``."""
    from mxnet_tpu_torch.gluon.utils import clip_global_norm
    from mxnet_tpu_torch.ndarray import NDArray

    dev = torch.device("cuda", 0)
    ws, gs = _opt_inputs(np.random.RandomState(SEED + 7))
    classes, ok = {}, True
    for name in OPT_CLASSES:
        t0 = time.perf_counter()
        card, _ = _opt_run(torch, name, dev, ws, gs, fused=False)
        cpu, _ = _opt_run(torch, name, "cpu", ws, gs, fused=False)
        err = max(float((a - b).abs().max()) for a, b in zip(card, cpu))
        row = {"max_abs_diff_card_vs_cpu": err,
               "card_vs_cpu_ok": _close(torch, card, cpu,
                                        OPT_TOL["card_vs_cpu"])}
        if name in OPT_FUSED:
            fused, info = _opt_run(torch, name, dev, ws, gs, fused=True)
            row.update(fused_info=info,
                       max_abs_diff_fused_vs_per_param=max(
                           float((a - b).abs().max())
                           for a, b in zip(fused, card)),
                       fused_ok=_close(torch, fused, card,
                                       OPT_TOL["fused_vs_per_param"])
                       and info["n_fused"] == len(OPT_SHAPES))
        row["moved"] = max(float((a - torch.from_numpy(w0)).abs().max())
                           for a, w0 in zip(card, ws))
        row["seconds"] = time.perf_counter() - t0
        row["ok"] = bool(row["card_vs_cpu_ok"] and row.get("fused_ok", True)
                         and row["moved"] > 0)
        ok = ok and row["ok"]
        classes[name] = row
    # clip_global_norm: the norm and the scaled arrays, card vs CPU
    arrs = {d: [NDArray(torch.tensor(x, device=d)) for x in gs[0]]
            for d in (dev, "cpu")}
    norms = {d: clip_global_norm(a, 10.0) for d, a in arrs.items()}
    clip_ok = (abs(norms[dev] - norms["cpu"]) <= 1e-5 * norms["cpu"]
               and _close(torch, [a.data.cpu() for a in arrs[dev]],
                          [a.data for a in arrs["cpu"]],
                          OPT_TOL["card_vs_cpu"]))
    return {"shapes": [list(s) for s in OPT_SHAPES], "tol": OPT_TOL,
            "classes": classes,
            "clip_global_norm": {"norm_card": norms[dev],
                                 "norm_cpu": norms["cpu"], "ok": clip_ok},
            "ok": bool(ok and clip_ok)}


# name, source, the TPU kernel it replaces, the paths whose launches the
# kernels line reports (summed)
KERNELS = (
    ("layer_norm", "mxnet_tpu_torch/csrc/layer_norm.cu",
     "mxnet_tpu/ops/pallas/fused.py:98",
     ("serve", "serve_sampling", "serve_spec", "serve_prefix", "serve_beam",
      "train_transformer", "train_transformer_bf16", "gluon_bert")),
    ("paged_decode_attention", "mxnet_tpu_torch/csrc/paged_attention.cu",
     "mxnet_tpu/ops/pallas/paged_attention.py:38",
     ("serve", "serve_sampling", "serve_spec", "serve_prefix",
      "serve_beam")),
    ("flash_attention_fwd", "mxnet_tpu_torch/csrc/flash_attention.cu",
     "mxnet_tpu/ops/pallas/flash_attention.py:72", ("train", "gluon_bert")),
    ("flash_attention_dq", "mxnet_tpu_torch/csrc/flash_attention.cu",
     "mxnet_tpu/ops/pallas/flash_attention.py:131", ("train", "gluon_bert")),
    ("flash_attention_dkv", "mxnet_tpu_torch/csrc/flash_attention.cu",
     "mxnet_tpu/ops/pallas/flash_attention.py:158", ("train", "gluon_bert")),
    ("add_layer_norm", "mxnet_tpu_torch/csrc/layer_norm.cu",
     "mxnet_tpu/ops/pallas/fused.py:166", "imperative"),
    ("softmax_cross_entropy", "mxnet_tpu_torch/csrc/softmax_cross_entropy.cu",
     "mxnet_tpu/ops/pallas/fused.py:36", "softmax_cross_entropy"),
)


# ---------------------------------------------------------------------------
# the Gluon loop: Gluon core, the kvstore and the Trainer
# ---------------------------------------------------------------------------
MNIST_N, MNIST_BATCH, MNIST_EPOCHS, MNIST_LR = 2048, 64, 3, 0.01
GB_WARMUP, GB_STEPS = 2, 5
GB_PARITY_BATCH = (2, 128)
# one Adam step of BERT-base through gluon.Trainer, card vs the CPU in
# float64 (LayerNorms included) and vs the f32 CPU, the same bounds as the
# Transformer's step (TT_PARITY_TOL) with the gradient's worst tensor
# beside its whole; updates compared where float64's gradient is not
# rounding noise (TT_PARITY_NOISE)
GB_PARITY_TOL = {"loss_rel": 1e-5, "grad_rel_model": 1e-5,
                 "grad_rel_tensor": 1e-3, "update_rel_model": 5e-4,
                 "update_rel_tensor": 2e-2}


def _synthetic_mnist(n=MNIST_N):
    """``examples/train_mnist.py``'s ``synthetic_mnist`` (that file imports
    the JAX package): class-conditional blobs from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    X = np.zeros((n, 1, 28, 28), np.float32)
    y = rng.randint(0, 10, n)
    for i in range(n):
        c = y[i]
        cx, cy = 8 + (c % 4) * 4, 8 + (c // 4) * 4
        X[i, 0, cy - 3:cy + 3, cx - 3:cx + 3] = 1.0
        X[i, 0] += rng.randn(28, 28) * 0.15
    return X, y.astype(np.float32)


def _lenet(gluon):
    """``examples/train_mnist.py``'s ``build_net("lenet")``."""
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(20, 5, activation="relu"),
            gluon.nn.MaxPool2D(2, 2),
            gluon.nn.Conv2D(50, 5, activation="relu"),
            gluon.nn.MaxPool2D(2, 2), gluon.nn.Flatten(),
            gluon.nn.Dense(500, activation="relu"), gluon.nn.Dense(10))
    return net


def phase_gluon_mnist(torch, ctx):
    """BASELINE config 1 as ``examples/train_mnist.py`` runs it, on the
    port: LeNet with deferred shapes, ``initialize(Xavier)``,
    ``hybridize()``, Adam through ``gluon.Trainer``, ``metric.Accuracy``,
    3 epochs of ``synthetic_mnist(2048)`` at batch 64 on ``cuda:0``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd

    counted = _counters()
    for fn in counted.values():
        fn.launches = 0
    dev = mx.gpu(0)
    mx.random.seed(42)
    X, y = _synthetic_mnist()
    net = _lenet(gluon)
    net.initialize(mx.init.Xavier(), ctx=dev)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": MNIST_LR})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    metric = mx.metric.Accuracy()
    B = MNIST_BATCH
    shuffle = np.random.RandomState(42)

    def step(idx):
        data, label = nd.array(X[idx], ctx=dev), nd.array(y[idx], ctx=dev)
        with autograd.record():
            out = net(data)
            loss = loss_fn(out, label)
        loss.backward()
        trainer.step(B)
        metric.update(label, out)

    epochs = []
    for epoch in range(MNIST_EPOCHS):
        metric.reset()
        perm = shuffle.permutation(len(X))
        starts = range(0, len(X) - B + 1, B)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in starts:
            step(perm[i:i + B])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        epochs.append({"epoch": epoch, "accuracy": metric.get()[1],
                       "wall_s": wall,
                       "images_per_s": len(starts) * B / wall,
                       "step_ms": wall * 1e3 / len(starts)})
    launches = {n: fn.launches for n, fn in counted.items()}
    ctx.setdefault("launches", {})["gluon_mnist"] = launches
    batches = iter(shuffle.permutation(len(X))[:8 * B].reshape(8, B))
    prof = _step_profile(torch, lambda: step(next(batches)), steps=8)
    last = epochs[-1]
    ctx["gluon_mnist"] = {k: last[k] for k in ("images_per_s", "step_ms")}
    return {"net": "lenet", "images": MNIST_N, "batch": B,
            "optimizer": "adam", "learning_rate": MNIST_LR,
            "epochs": epochs, "images_per_s": last["images_per_s"],
            "step_ms": last["step_ms"], "train_accuracy": last["accuracy"],
            "cached_op_entries": net._cached_op.num_entries,
            "launches": launches, "profile_8_steps": prof,
            "card": ctx["smi"],
            "ok": bool(last["accuracy"] > 0.95
                       and not any(launches.values())
                       and net._cached_op.num_entries == 1)}


def _gluon_mlm(net, loss_fn, data, label):
    """The per-token MLM losses of BERT through the Gluon call (one value
    per token, as ``SoftmaxCrossEntropyLoss`` gives per sample)."""
    out = net(data)
    return loss_fn(out.reshape((-1, BERT_VOCAB)), label.reshape((-1,)))


def _nd_call_host_ms(torch, net, dev, rounds=6, reps=10):
    """Host ms of one recorded forward of a 1 x 8 batch as an NDArray call
    (the Gluon convention: leaves, train flag, wrapping, CachedOp) and as
    a tensor call: medians over ``rounds`` rounds, each taking the two in
    turns (ABBA), ``reps`` calls ending in a sync each."""
    from mxnet_tpu_torch import autograd, nd

    x_nd = nd.array(np.zeros((1, 8), np.int32), ctx=dev, dtype=np.int32)
    x_t = x_nd.data

    def nd_call():
        with autograd.record():
            net(x_nd)

    def tensor_call():
        with torch.enable_grad():
            net(x_t)

    def run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    run(nd_call)
    run(tensor_call)
    got = {"ndarray_call_ms": [], "tensor_call_ms": []}
    for i in range(rounds):
        order = ((nd_call, tensor_call) if i % 2 == 0
                 else (tensor_call, nd_call))
        for fn in order:
            key = "ndarray_call_ms" if fn is nd_call else "tensor_call_ms"
            got[key].append(run(fn))
    out = {k: statistics.median(v) for k, v in got.items()}
    out["convention_ms"] = out["ndarray_call_ms"] - out["tensor_call_ms"]
    out["samples"] = got
    return out


def phase_gluon_bert(torch, ctx):
    """BERT-base at full width through the Gluon loop: ``initialize(
    Normal(0.02))`` (``examples/bert_pretrain.py:69``), ``hybridize()``,
    ``gluon.Trainer`` with Adam lr 1e-4; each step ``autograd.record()``
    -> per-token loss -> ``backward()`` -> ``trainer.step(tokens)``; 2
    warm-up and 5 timed steps on the train phase's batch."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.models.bert import bert_base
    from mxnet_tpu_torch.optimizer import FusedUpdater

    torch.cuda.empty_cache()
    dev = mx.gpu(0)
    mx.random.seed(SEED)
    t0 = time.perf_counter()
    net = bert_base(BERT_VOCAB, dropout=0.0, init_weights=False)
    net.initialize(mx.init.Normal(0.02), ctx=dev)
    net.hybridize()
    init_s = time.perf_counter() - t0
    params = net.collect_params()
    n_params = sum(p.data().size for p in params.values())
    trainer = gluon.Trainer(params, "adam", {"learning_rate": 1e-4})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    tokens = np.random.RandomState(SEED).randint(
        0, BERT_VOCAB, (TRAIN_BATCH, TRAIN_LEN)).astype(np.int32)
    data = nd.array(tokens, ctx=dev, dtype=np.int32)
    label = nd.array(tokens.astype(np.float32), ctx=dev)
    n_tok = TRAIN_BATCH * TRAIN_LEN

    def step():
        with autograd.record():
            loss = _gluon_mlm(net, loss_fn, data, label)
        loss.backward()
        trainer.step(n_tok)
        return loss.mean()

    torch.cuda.reset_peak_memory_stats()
    losses = [float(step().asscalar()) for _ in range(GB_WARMUP)]
    counted = _counters()
    for fn in counted.values():
        fn.launches = 0
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(GB_STEPS)]
    handles = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for start, end in marks:
        start.record()
        handles.append(step())
        end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counted.items()}
    ctx.setdefault("launches", {})["gluon_bert"] = launches
    losses += [float(h.asscalar()) for h in handles]
    step_ms = [a.elapsed_time(b) for a, b in marks]
    peak = torch.cuda.max_memory_allocated() / 1e9
    upd = trainer._updaters[0]
    info = dict(upd.last_info)
    entries = [{"train": k[0], "signature": str(k[1]), **v}
               for k, v in net._cached_op.entries.items()]
    host = _nd_call_host_ms(torch, net, dev)
    prof = _step_profile(torch, step, steps=1)
    expected = {n: k * GB_STEPS for n, k in TRAIN_PER_STEP.items()}
    tokens_per_s = n_tok * GB_STEPS / wall
    train_entries = [e for e in entries if e["train"] and
                     f"({TRAIN_BATCH}, {TRAIN_LEN})" in e["signature"]]
    return {
        "model": "bert_base", "vocab": BERT_VOCAB, "params": n_params,
        "init_s": init_s, "batch": TRAIN_BATCH, "seq_len": TRAIN_LEN,
        "steps": GB_STEPS, "wall_s": wall, "tokens_per_s": tokens_per_s,
        "step_ms_median": statistics.median(step_ms), "step_ms": step_ms,
        "max_memory_allocated_gb": peak,
        "train_phase": ctx.get("train_f32"),
        "losses": losses, "launches": launches,
        "launches_expected": expected, "updater": type(upd).__name__,
        "updater_last_info": info, "cached_op_entries": entries,
        "host_call": host, "profile_1_step": prof, "card": ctx["smi"],
        "ok": bool(all(math.isfinite(x) for x in losses)
                   and losses[-1] < losses[0] and launches == expected
                   and n_params == 133_545_786
                   and isinstance(upd, FusedUpdater)
                   and info["n_fused"] == len(params)
                   and info["n_fallback"] == 0
                   and len(train_entries) == 1)}


def _gluon_bert_step(torch, fname, device, float64=False):
    """One ``gluon.Trainer`` Adam step of BERT-base loaded from ``fname``
    on ``device`` (with ``float64`` the CPU yardstick, LayerNorms in
    float64 too) on the parity batch: (mean loss, gradients, updates),
    float64 CPU tensors by structural name."""
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.gluon.nn import LayerNorm
    from mxnet_tpu_torch.models.bert import bert_base

    net = bert_base(BERT_VOCAB, dropout=0.0, init_weights=False)
    net.load_parameters(fname, ctx=device)
    if float64:
        net.cast("float64")
        for m in net.modules():
            if isinstance(m, LayerNorm):
                m.forward = (lambda x, m=m: torch.nn.functional.layer_norm(
                    x, (x.shape[-1],), m.weight, m.bias, m.eps))
    net.hybridize()
    # by structural name: each net's Gluon prefix takes the next count
    params = net._collect_params_with_prefix()
    before = {k: p.data().data.detach().cpu().double().clone()
              for k, p in params.items()}
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-4})
    tokens = np.random.RandomState(SEED + 7).randint(
        0, BERT_VOCAB, GB_PARITY_BATCH).astype(np.int32)
    data = nd.array(tokens, ctx=device, dtype=np.int32)
    label = nd.array(tokens.astype(np.float32), ctx=device)
    with autograd.record():
        loss = _gluon_mlm(net, gluon.loss.SoftmaxCrossEntropyLoss(), data,
                          label)
    loss.backward()
    grads = {k: p.grad().data.detach().cpu().double().clone()
             for k, p in params.items()}
    trainer.step(tokens.size)
    upd = {k: p.data().data.detach().cpu().double() - before[k]
           for k, p in params.items()}
    return float(loss.mean().asscalar()), grads, upd


def phase_gluon_bert_parity(torch, ctx):
    """One Trainer step of BERT-base at full width on a (2, 128) batch,
    from weights made on the CPU (``initialize(Normal(0.02))``) and
    carried by ``save_parameters`` / ``load_parameters``: the card vs the
    CPU in float64 and vs the f32 CPU (GB_PARITY_TOL)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models.bert import bert_base

    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    fname = os.path.join(here, "build", f"gluon_bert-{os.getpid()}.params")
    os.makedirs(os.path.dirname(fname), exist_ok=True)
    mx.random.seed(SEED + 6)
    start = bert_base(BERT_VOCAB, dropout=0.0, init_weights=False)
    start.initialize(mx.init.Normal(0.02), ctx=mx.cpu())
    start.save_parameters(fname)
    del start
    try:
        runs = {name: _gluon_bert_step(torch, fname, dev, f64)
                for name, dev, f64 in (("card", mx.gpu(0), False),
                                       ("cpu", mx.cpu(), False),
                                       ("float64", mx.cpu(), True))}
    finally:
        os.remove(fname)
    loss_y, grad_y, upd_y = runs.pop("float64")
    top = max(float(g.abs().max()) for g in grad_y.values())
    keep = {k: g.abs() >= TT_PARITY_NOISE * top for k, g in grad_y.items()}
    tol = GB_PARITY_TOL
    res, ok = {}, True
    for name, (loss, grad, upd) in runs.items():
        g_model, g_worst = _rel_l2(grad, grad_y)
        u_model, u_worst = _rel_l2({k: u[keep[k]] for k, u in upd.items()},
                                   {k: u[keep[k]] for k, u in upd_y.items()})
        res[f"{name}_vs_float64"] = {
            "loss_rel": abs(loss - loss_y) / abs(loss_y),
            "grad_rel_model": g_model, "grad_rel_worst_tensor": g_worst[0],
            "grad_worst_tensor": g_worst[1], "update_rel_model": u_model,
            "update_rel_worst_tensor": u_worst[0],
            "update_worst_tensor": u_worst[1]}
    loss_g, grad_g, upd_g = runs["card"]
    loss_c, grad_c, upd_c = runs["cpu"]
    g_model, g_worst = _rel_l2(grad_g, grad_c)
    u_model, u_worst = _rel_l2({k: u[keep[k]] for k, u in upd_g.items()},
                               {k: u[keep[k]] for k, u in upd_c.items()})
    res["card_vs_cpu"] = {
        "loss_rel": abs(loss_g - loss_c) / abs(loss_c),
        "grad_rel_model": g_model, "grad_rel_worst_tensor": g_worst[0],
        "grad_worst_tensor": g_worst[1], "update_rel_model": u_model,
        "update_rel_worst_tensor": u_worst[0],
        "update_worst_tensor": u_worst[1]}
    for key in ("card_vs_float64", "card_vs_cpu"):
        r = res[key]
        ok = ok and (r["loss_rel"] <= tol["loss_rel"]
                     and r["grad_rel_model"] <= tol["grad_rel_model"]
                     and r["grad_rel_worst_tensor"] <= tol["grad_rel_tensor"]
                     and r["update_rel_model"] <= tol["update_rel_model"]
                     and r["update_rel_worst_tensor"]
                     <= tol["update_rel_tensor"])
    n_keep = sum(int(m.sum()) for m in keep.values())
    return {"batch": list(GB_PARITY_BATCH), "tol": tol,
            "losses": {"card": loss_g, "cpu": loss_c, "float64": loss_y},
            "compared_share": n_keep / sum(m.numel() for m in keep.values()),
            **res, "ok": bool(ok)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mxnet_tpu_torch")):
        print(f"chip_smoke: no mxnet_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)

    ctx, failed = {}, []
    phases = (("device", phase_device),
              ("kernel_layer_norm", phase_layer_norm),
              ("kernel_paged_attention", phase_paged_attention),
              ("kernel_flash_attention", phase_flash_attention),
              ("kernel_add_layer_norm", phase_add_layer_norm),
              ("kernel_softmax_cross_entropy", phase_softmax_cross_entropy),
              ("serve", phase_serve),
              ("serve_parity", phase_serve_parity),
              ("serve_profile", phase_serve_profile),
              ("serve_bf16", phase_serve_bf16),
              ("serve_sampling", phase_serve_sampling),
              ("serve_spec", phase_serve_spec),
              ("serve_prefix", phase_serve_prefix),
              ("serve_beam", phase_serve_beam),
              ("train", phase_train),
              ("train_parity", phase_train_parity),
              ("train_profile", phase_train_profile),
              ("train_bf16", phase_train_bf16),
              ("imperative", phase_imperative),
              ("imperative_bf16", phase_imperative_bf16),
              ("train_resnet", phase_train_resnet),
              ("train_resnet_bf16", phase_train_resnet_bf16),
              ("train_resnet_parity", phase_train_resnet_parity),
              ("train_resnet_profile", phase_train_resnet_profile),
              ("train_transformer", phase_train_transformer),
              ("train_transformer_bf16", phase_train_transformer_bf16),
              ("train_transformer_parity", phase_train_transformer_parity),
              ("optimizer", phase_optimizer),
              ("gluon_mnist", phase_gluon_mnist),
              ("gluon_bert", phase_gluon_bert),
              ("gluon_bert_parity", phase_gluon_bert_parity))
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn(torch, ctx)
            ok = bool(res.pop("ok", True))
        except Exception as e:  # a phase's failure is reported, not fatal
            traceback.print_exc()
            res, ok = {"error": f"{type(e).__name__}: {e}"[:2000]}, False
        line = {"phase": name, "ok": ok, "seconds": time.perf_counter() - t0,
                **res}
        emit(line)
        if not ok:
            failed.append(name)

    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    kernels = []
    for name, source, replaces, paths in KERNELS:
        k = ctx[name]
        paths = (paths,) if isinstance(paths, str) else paths
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(ctx["launches"][p][name] for p in paths),
            "path": paths[0] if len(paths) == 1 else list(paths),
            "launches_by_path": {p: ctx["launches"][p][name]
                                 for p in ctx["launches"]},
            **{key: k[key] for key in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms", "bound_f32_cores_ms",
                                       "bwd_pair_ms")
               if key in k},
            **({"library_is": k["library_is"]} if "library_is" in k
               else {})})
    print(ctx["smi"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
