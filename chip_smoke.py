#!/usr/bin/env python3
"""Drive the PyTorch port (``mxnet_tpu_torch``) on one CUDA card and check
it end to end.

    python3 chip_smoke.py [PHASE ...]

With no argument every phase runs, and the kernels line and the last line
(``{"ok": true, "device": ...}``) follow.  Named phases (say ``device
kernel_flash_attention``) run alone, in the order below, with neither
line; a phase that reads what an earlier one left needs that one named
too (``train_bf16`` and ``train_amp*`` read ``train``'s batch).

Phases, each printing one JSON line (``{"phase": ..., "ok": ...}``):

  device                  card name and power limit (nvidia-smi), torch and
                          CUDA versions, and the seconds the kernel build
                          took (one nvcc per ``csrc/*.cu``, all at once),
                          with each kernel's ``ptxas -v`` lines (registers,
                          spills, wgmma serialisation); K3's block shape,
                          shared memory and blocks per SM at hd 16, 32, 64,
                          128 and 256 (f32) and of its 16-bit design at hd
                          64 and 128; the floor of
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
  serve_profile           8 full slots decoding 32 steps each under
                          torch.profiler: device time by kernel, K1 and K2's
                          share, the device's busy share of the wall time.
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
  serve_fleet             the fleet on the card: two ``ReplicaServer``s
                          (ranks 0 and 1) over serve's engine and weights,
                          each its own model, behind a ``Router`` that
                          finds them through portfiles under
                          ``build/serve_fleet``, with ``MX_TELEMETRY_DIR``
                          and ``MX_METRICS_PORT=0`` there; 8 client threads
                          post serve's 16 requests to ``/generate`` (4
                          sessions of 3, 4 without): serve's tokens, each
                          session on one replica.  Again with replica 1
                          drained after 4 answers and undrained after 12:
                          no request sent meanwhile lands on it.  Again
                          with replica 1 stopped after 4 answers: a session
                          pinned to it fails over to replica 0 and stays.
                          Transformer-big of seed + 1 written by
                          ``AsyncCheckpointer`` in format 1 and 2:
                          ``swap_weights`` of format 1 on replica 0 under
                          64 requests flips on its run loop, later
                          requests equal an engine restored from the
                          checkpoint, format 2 flips at once (generation
                          2); checkpoints of vocab 32008 and of bf16 are
                          rejected and replica 0 keeps its weights;
                          ``/metrics`` reads generation 2; the staging
                          census empties at the flip; K1 18 a step + 12 a
                          prefill and K2 6 a step summed over both engines;
                          ``tools/serve_report.py`` (one request per
                          answer), ``trace_report.py``, ``mem_report.py``
                          and ``ckpt_report.py`` exit 0.  Lines of fleet
                          tokens/s, TTFT, the router's added latency, swap
                          ms and bytes, and memwatch's census beside
                          ``max_memory_allocated``.
  serve_int8              Transformer-big served int8 through
                          ``quantize_adapter`` (naive calibration over
                          greedy ``translate`` of serve's first 8 sources):
                          serve's traffic counted as in ``serve``, then the
                          f32 and int8 engines in turns (A B B A) for
                          tokens/s; the first 4 logits card vs CPU within
                          QUANT_LOGIT_TOL of the larger of 1 and the max
                          |logit|; weight bytes against f32's, the
                          ``quantized`` memwatch census.
  serve_int4              the same with weight-only int4 in groups of 32.
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
                          Every 16-bit row names its ``design``: K3, K4
                          and K5 at bf16 and f16 and hd 64 and 128 run
                          ``wgmma16`` (csrc/flash_attention_16.cu), every
                          other row ``f32-core``; it carries the 16-bit
                          bound (989 TFLOP/s) and its time over SDPA's in
                          the same dtype; a ``wgmma16`` row may read no
                          faster than that bound and is held to ulp_ratio
                          <= 0.5, an ``f32-core`` row to the 3xTF32 bound
                          and <= 1; a ragged hd 64 bf16 case and a
                          causal Lq != Lk hd 128 f16 case are checked, not
                          timed.
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
                          K3-K5 12 launches a step, all of the
                          ``wgmma16`` design; losses finite and
                          falling; tokens/s, step ms and peak memory beside
                          the f32 train phase's; one profiled step with
                          K3-K5's share of the busy time.
  train_amp               the train cell through ``DataParallelStep`` with
                          the AMP policy in bf16 (f32 masters): losses
                          finite, falling and within 2e-2 relative of the
                          f32 cell's, K1 and K3-K5 as many launches as
                          there (K3-K5's of the ``wgmma16`` design),
                          LayerNorm fed f32 and attention bf16.
  train_amp_fp16          the same in fp16 with the dynamic loss scaler:
                          a step forced to overflow is skipped, and the
                          scaled step makes no host synchronization.
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
  gluon_resnet_amp        BASELINE config 2 as MXNet scripts run it:
                          resnet50_v1b NHWC, ``hybridize()``,
                          ``amp.init("bfloat16")``, ``convert_hybrid_block``,
                          ``gluon.Trainer`` SGD as train_resnet with
                          ``init_trainer``'s f32 masters, ``scale_loss``: 2
                          warm-up and 5 timed steps, then untimed ones to
                          30 in all; images/s against train_resnet_bf16's;
                          losses finite, the 30th below the first; bf16
                          weights, f32 masters, every kernel counter 0.
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
  train_ssd               BASELINE config 5, SSD half, as
                          ``examples/train_detection.py --rec`` runs it:
                          a seeded 256-image 512^2 JPEG RecordIO (1-8
                          boxes each over 80 classes) written under
                          ``build/`` by the port's ``recordio``,
                          ``ImageDetIter`` with ``CreateDetAugmenter((3,
                          512, 512), rand_mirror=True, rand_crop=0.5,
                          mean=True, std=True)`` onto ``cuda:0``,
                          ``ssd_300(num_classes=80)`` (21,764 anchors),
                          ``SSDTrainLoss`` and Adam lr 1e-3 through
                          ``gluon.Trainer`` at batch 32: 2 warm-up and
                          10 timed steps through the pipeline (images/s),
                          the iterator alone (ms a batch), 10 steps on a
                          staged batch (CUDA-event median), one profiled
                          step, peak memory; losses finite and falling,
                          no kernel launched.  One step at batch 2 on the
                          card, the CPU and the CPU in float64 from the
                          same weights (DET_PARITY_TOL): loss, head
                          outputs, gradients, MultiBoxTarget's targets.
  detect_ssd              ``SSD.detect`` (threshold 0.01, NMS 0.45,
                          top-k 400) on train_ssd's last batch of 32: ms a
                          batch (2 warm-up, 5 timed), one profiled call;
                          ``MultiBoxDetection`` card vs CPU on drawn
                          scores no two of which are within 1e-4: kept
                          rows, class ids and scores exact, boxes within
                          DET_BOX_ATOL.
  train_faster_rcnn       BASELINE config 5, Faster-RCNN half:
                          ``faster_rcnn_small(num_classes=80)`` with
                          ``FasterRCNNTrainLoss`` and Adam through
                          ``gluon.Trainer`` at batch 8 and 512^2 with
                          seeded pixel gt boxes and ``im_info``: 2
                          warm-up and 10 timed steps, one profiled step
                          with its host gaps, peak memory; ``detect``
                          once; one step at batch 2 on the card, the CPU
                          and the CPU in float64, the CPU steps taking
                          the card's proposals and roi sample.
  cv_ops                  every registered detection op (and
                          ``smooth_l1``) on the card vs the CPU port at
                          the paths' shapes, with tied scores, padded gt
                          rows and two gt boxes sharing their best
                          anchor: integer and mask outputs, orders and
                          selected values exact, floats within CV_TOL;
                          card ms of each.
  train_lstm_lm           the medium LSTM language model of Zaremba et al.
                          as MXNet's word_language_model example runs it
                          (``models.lstm_lm_medium``: vocabulary 10,000,
                          embedding 650, 2 x 650 LSTM on cuDNN through
                          ``_fused_rnn``, dropout 0.5, untied, 19,780,400
                          parameters, ``Uniform(0.05)``), batch 20 x 35
                          steps of a seeded Zipf stream that repeats every
                          4 batches, the state carried and detached, SGD
                          lr 1.0 through ``gluon.Trainer`` after
                          ``clip_global_norm`` (5 a token), f32, TF32 off:
                          3 warm-up and 20 timed steps (tokens/s, step ms,
                          peak memory) with the counters zeroed just before
                          (K1-K7: 0), one profiled step, then 6 more; the
                          29 recorded losses finite, the last 5 below the
                          first 5.  One step at batch 2, dropout 0, on the
                          card and the CPU from the same weights and
                          carried state: logits, loss, every gradient, the
                          parameters after the step and the new state
                          within LM_PARITY_TOL.
  rnn_variants            GRU (2 layers, TNC), bidirectional LSTM (NTC),
                          an Elman RNN (tanh, NTC), ``LSTMCell`` /
                          ``GRUCell`` / ``BidirectionalCell`` /
                          ``SequentialRNNCell`` (with a ``ResidualCell``)
                          ``unroll`` with ``valid_length``, and the packed
                          ``RNN`` op (bidirectional 2-layer LSTM over
                          MXNet's flat parameter vector), T 20, N 8, input
                          64, hidden 128: outputs, states, input and
                          parameter gradients on the card within
                          RNN_VAR_TOL of the CPU's in f32 and in float64;
                          K1-K7: 0.
  op_catalog              every op of the registry (the detection ops are
                          ``cv_ops``') on the card vs the CPU port at the
                          paths' sizes (``_op_catalog``: (1024, 1024)
                          elementwise, 1M-element reductions, batched 64 x
                          64 linear algebra, BERT-width ``batch_dot`` and
                          interleaved attention, a (30522, 768) embedding
                          table, ResNet-sized maps, the LSTM language
                          model's recurrence), forward and, where
                          differentiable, the gradient of a seeded
                          cotangent: integer, index, mask and order
                          outputs exact, floats within OP_TOL of the CPU
                          tensor's max abs by family; the random ops and
                          ``Dropout`` by shape, support, mean and variance
                          within 5 standard errors, and the same draws
                          from the same seed; card ms by family.
  module_bert             BERT-base (vocab 30522, dropout 0, seeded) exported
                          by the port's ``HybridBlock.export``, loaded by
                          ``sym.load`` / ``model.load_params`` under an MLM
                          head (``SoftmaxOutput`` over the (B*T, V) reshape,
                          ``normalization="batch"``) and trained through
                          ``mx.mod.Module`` at 32 x 512, Adam lr 1e-4, f32,
                          TF32 off: the graph holds 26 ``LayerNorm`` and
                          12 ``_contrib_flash_attention`` nodes; the first
                          step's loss and gradients against the Gluon
                          route's (``_gluon_mlm``, the same weights and
                          batch, its summed gradient over the tokens)
                          within SYM_PARITY_TOL; 2 warm-up and 5 timed
                          ``forward_backward`` + ``update`` steps with the
                          counters zeroed just before: K1 26 and K3-K5 12
                          launches a step (TRAIN_PER_STEP); losses finite
                          and falling; tokens/s, step ms (CUDA events),
                          peak memory, one profiled step (busy share).
  train_resume            the rest of the training step at the train cell's
                          widths (BERT-base, 32 x 512, Adam lr 1e-4, f32,
                          TF32 off, seeded weights): 6 DataParallelStep
                          steps at MX_ASYNC_INFLIGHT=0, again at 0, and at
                          the default window (2), each from the same
                          weights: losses and weights after ``drain`` equal
                          within RESUME_SPREAD (0: bit for bit) of the
                          first window-0 run, the window-2 run's depth
                          reaching and never passing 2, K1 26 and K3-K5 12
                          launches a step in every run (counters zeroed
                          just before each); then 3 steps under two
                          ``AsyncCheckpointer(save_every=3, keep=1)`` whose
                          target is the step (format 1 with
                          ``opt_state.nd``, and ``sharded=True``), each
                          ``checkpoint.restore``d into a fresh model of
                          another seed and a fresh step: its state_dict
                          equal to the saved one bit for bit, its steps 4-6
                          the window-0 run's losses 4-6 (RESUME_SPREAD) at
                          26 / 12 launches a step, and after
                          ``sync_to_block`` a Gluon (NDArray) forward of 2
                          x 128 tokens equal to the step's tensor forward;
                          then 3 steps of gluon_bert's loop through
                          ``gluon.Trainer`` and of module_bert's graph
                          through ``Module`` at windows 0 and 2: losses
                          equal (RESUME_SPREAD), no fence at 0, depth 2 at
                          2.  Prints tokens/s and busy share (3 profiled
                          steps) at windows 0 and 2, each format's snapshot
                          ms (device to host) and write s, peak memory.
  module_lstm_bucketing   MXNet 1.x's example/rnn/bucketing/lstm_bucketing.py
                          at its defaults (LB): 2 x ``LSTMCell(200)``,
                          Embedding 200, FullyConnected to 10,000 words,
                          SoftmaxOutput; buckets 10-60, batch 32, invalid
                          label 0; SGD lr 0.01, momentum 0, wd 1e-5,
                          rescale_grad 1/32 (MXNet's Module sets it);
                          ``Xavier(factor_type="in", magnitude=2.34)``;
                          ``Perplexity(0)``; ``Speedometer(32, 50)``; one
                          epoch of ``BucketingModule.fit`` over a seeded
                          Zipf stream of 2,400 sentences of 5-60 tokens
                          (every bucket, >= 60 batches), then the same with
                          ``FusedRNNCell(200, num_layers=2)`` from the
                          unfused net's initial weights packed: the mean
                          perplexity of the last 10 batches below the first
                          10's and below the uniform perplexity, 10,000
                          (LB_PPL_BOUND), K1-K7 0 launches; card vs CPU on
                          one batch of each of two buckets
                          (forward_backward, update, from the same weights)
                          within LB_PARITY_TOL of each tensor's max abs; batches/s and tokens/s per
                          bucket, 4 profiled batches (busy share).
  symbol_api              card vs CPU within SYM_API_TOL of each tensor's
                          max abs: the Executor's forward and backward of a
                          transformer layer's kernel ops (LayerNorm, qkv,
                          causal flash attention, proj; 4 x 64 x 64) with
                          grad_req write and add; ``SymbolBlock.imports``
                          of a port-exported ``bert_small`` (outputs and
                          gradients); a ``Module.save_checkpoint`` on the
                          card loaded by ``Module.load`` on the card and on
                          the CPU.
  train_imagenet          BASELINE config 2 as ``examples/train_imagenet.py
                          --rec --model resnet50_v2 --batch-size 256`` runs
                          it: a seeded 1,024-image JPEG RecordIO (~500 x
                          375, labels in [0, 1000)) written under
                          ``build/`` by the port's ``recordio``,
                          ``vision.get_model("resnet50_v2")``,
                          ``initialize(Xavier())``, ``DataParallelStep``
                          SGD lr 0.1, momentum 0.9, wd 1e-4, f32 NCHW,
                          ``ImageRecordIter(data_shape=(3, 224, 224),
                          shuffle, rand_crop, rand_mirror)`` in
                          ``DevicePrefetchIter``: 2 warm-up and 10 timed
                          steps over 3 epochs (images/s through the
                          pipeline), the iterator alone (ms a batch), 5
                          steps on a staged batch (CUDA events), one
                          profiled step, peak memory; losses finite, every
                          batch (256, 3, 224, 224) f32 on the card with
                          (256, 1) labels in [0, 1000), the first epoch's
                          labels the file's, K1-K7 0.
  zoo_train               vgg16 (batch 64), densenet121 (64), inceptionv3
                          (64 at 299^2), mobilenetv2_1.0 (128),
                          squeezenet1.1 (128), alexnet (128) from
                          ``get_model``, each 2 warm-up and 3 timed
                          ``DataParallelStep`` SGD steps on a staged
                          seeded batch (step ms, images/s, peak memory,
                          losses finite, K1-K7 0); then one training
                          forward and backward at batch 2 with Dropout 0
                          on the card, the CPU and the CPU in float64
                          from the same weights (ZOO_PARITY_TOL).
  zoo_forward             every one of ``get_model``'s 36 names built on
                          the card, one eval forward at batch 2 (224^2,
                          299^2 for Inception): logits (2, 1000), finite;
                          one name a family card vs CPU within
                          ZOO_FORWARD_TOL; resnet50_v2, mobilenetv2_1.0,
                          densenet121 and inceptionv3 exported and
                          ``SymbolBlock.imports``-ed on the card, equal to
                          the Block within ZOO_EXPORT_TOL; K1-K7 0.
  conv_nd                 ``Convolution`` (``num_group``, ``dilate``),
                          ``Deconvolution`` (``adj``), ``Pooling`` (max,
                          avg with and without ``count_include_pad``, sum,
                          lp, ``full``, global), ``im2col`` / ``col2im`` on
                          a 1-D audio block (16, 256, 16,000), ResNet's
                          (32, 64, 56, 56) and a 3-D video block (8, 64,
                          16, 56, 56), both layouts, f32 and bf16: forward
                          and gradients card vs CPU on the first sample
                          (CONV_ND_TOL), ms of a forward and backward at
                          the full shape; K1-K7 0.
  profile_bert            gluon_bert's step (BERT-base, 32 x 512, Adam
                          through gluon.Trainer) under ``mx.profiler``,
                          with ``hybridize(False)`` and hybridized: the
                          ranked rows name FullyConnected, LayerNorm and
                          _contrib_flash_attention, then one
                          ``CachedOp:<class>`` row and none from inside
                          it; the trace segment lists each of our
                          kernels as often as its launch counter counts;
                          each profiled step launches K1 26 and K3-K5 12
                          times; profiled and unprofiled step ms, the top
                          rows, the op sites' cost with the profiler
                          stopped.  (Runs after gluon_bert, on its net.)
  serve_fullprefix        serve's Transformer-big decoder over a fixed
                          source through ``FullPrefixAdapter`` (no pages):
                          8 slots, an (8, 64) buffer, 8 prompts of 4-24
                          tokens, 16 new tokens each; tokens equal a host
                          greedy loop over the same buffer on the card; K1
                          18 a step, K2 0; tokens/s, step ms.
  train_sparse_lm         the medium LSTM LM with ``Embedding(sparse_grad=
                          True)``, SGD lr 20, clip 0.25 a token, dropout 0:
                          20 steps, each within SPARSE_LM_STEP_TOL
                          (relative L2) of a dense step from its state on
                          every loss and parameter, its gradient a
                          RowSparseNDArray of the batch's distinct ids;
                          20-step runs' drift from the dense run (sparse,
                          a dense rerun, a dense run summing the embedding
                          gradient by index_add_) reported; tokens/s; the
                          op sites' cost; K1-K7 0.
  train_sparse_adam       the same model at WikiText-103's vocabulary
                          (267,735) with lazy Adam (wd 1e-4), 5 steps:
                          untouched rows bit-identical in the weight and
                          both moments, touched rows within SPARSE_ADAM_TOL
                          of the rule in float64; tokens/s, rows touched,
                          the embedding's lazy update vs a dense
                          ``adam_update`` of it (CUDA events); K1-K7 0.
  libsvm_sparse           a seeded Avazu-shaped LibSVM file (65,536 rows of
                          15 ids in [1, 1,000,000], 1-based) through
                          ``LibSVMIter`` at batch 8,192: components equal
                          the phase's numpy reader's; ``nd.sparse.dot``
                          with and without ``transpose_a`` within SVM_TOL of
                          float64; peak device memory under 1 GB; rows/s
                          of the iterator alone and with the products;
                          K1-K7 0.
  train_bert_dense        BERT-base as bench.py:670-690 builds it:
                          ``bert_base()`` at its default dropout 0.1, cast
                          to bf16, 32 x 512, Adam 1e-4 through
                          ``DataParallelStep``, 2 warm-up and 5 timed steps
                          on a repeated seeded batch: in training every
                          attention is dense (attention dropout active),
                          so K1 26 a step and K3-K5 0; finite, falling
                          losses; tokens/s, step ms, peak memory, one
                          profiled step's busy share.  Then a predict-mode
                          NDArray forward of the same model (the fused
                          route: K3 12, all ``wgmma16``, K4/K5 0, K1 26),
                          and a masked f32 step at (2, 128) with
                          ``valid_length`` seeded in [64, 128] and dropout
                          0, card vs CPU within DENSE_PARITY_TOL
                          (phase_train_parity's bounds), K1 26, K3-K5 0.
  graph_spellings         exports loaded as ``SymbolBlock`` on the card,
                          predict mode within GRAPH_TOL of max |eager|:
                          BERT-base at dropout 0.1 (25 Dropout nodes,
                          active in train mode; K1 26 and K3 12 launched
                          by its LayerNorm and fused-attention nodes; with
                          a ``valid_length`` the export raises, as JAX's
                          does, so the masked encoder's graph is held
                          instead: 24 ``batch_dot``, K1 24, K3 0);
                          Transformer-big's widths at 2 + 2 layers (the
                          masked and causal dense graph); SSD-512 and
                          Faster-RCNN at 512^2; ``gluon.rnn.LSTM`` and a
                          two-cell stack of each cell, which JAX cannot
                          export: the port's export raises too.
  estimator_fit           ``gluon.contrib.estimator``: LeNet (the example's
                          widths) on seeded data, ``Estimator.fit`` for 2
                          epochs of 8 batches of 64 with every handler;
                          its per-batch losses within EST_LOSS_REL of the
                          loop written out from the same weights (cuDNN
                          deterministic), the last checkpoint loaded back
                          equal to the fitted net; K1-K7 0.
  contrib_custom          ``Conv2DLSTMCell``, ``LSTMPCell`` and
                          ``VariationalDropoutCell`` (rates 0) unrolled on
                          the card vs the CPU, and an ``nd.Custom`` op's
                          forward and user backward card vs CPU, within
                          CONTRIB_TOL; K1-K7 0.
  runtime_env             ``runtime.Features()`` (CUDA, CUDNN on; TPU,
                          XLA, PALLAS off), ``util.get_gpu_count()`` and
                          ``get_gpu_memory(0)`` against torch's (free
                          within 1%), ``env_vars.check()`` over the run's
                          environment, ``rtc.CudaModule("")`` raising
                          ``MXNetError``; K1-K7 0.
  test_utils_card         ``test_utils.check_consistency`` over
                          ``[mx.cpu(), mx.gpu(0)]``: ``nd.LayerNorm``
                          (16384, 768) K1 1; ``nd.contrib.flash_attention``
                          N 24, L 512, hd 64 in f32 (K3 1, f32 core) and
                          bf16 (K3 1, ``wgmma16``); ``add_layer_norm``
                          (8192, 1024) under the fused_kernels pass, K6 1;
                          the ``softmax_cross_entropy`` op (2048, 30522),
                          plain torch, no kernel, and K7's wrapper on the
                          same inputs, K7 1; each within ``_dtype_tol``,
                          its max deviation beside it.  Then
                          ``check_numeric_gradient`` of the f32 flash
                          attention at (1, 8, 16) on the card: K3 769 (one
                          a loss), K4 1, K5 1.
  onnx_roundtrip          ``bench.py``'s ``bert_base()`` (f32, 8 x 128) and
                          ``resnet50_v1b`` (f32, 32 x 224^2) exported
                          (``HybridBlock.export`` -> ``contrib.onnx.
                          export_model``), imported on the card
                          (``import_to_gluon``) and run: within
                          ZOO_EXPORT_TOL of max |eager|; eager BERT K1 26,
                          K3 12, the imported graphs none; bytes, export
                          and import s, eager and imported ms.  An int8
                          net of Transformer-big's FFN widths exported as
                          QDQ (``export_quantized_net``) and replayed in
                          numpy: within one step of the data's
                          QuantizeLinear scale of the card's output.
  examples                ``python -m mxnet_tpu_torch.examples.<name>`` for
                          train_mnist (LeNet), train_imagenet (``--rec``, a
                          seeded 64-JPEG RecordIO, resnet50_v1b, 224^2),
                          train_detection (SSD, ``--rec``) and train_wmt
                          (``--model base``), four subprocesses on the
                          card started together, at the scripts' models
                          and widths (LeNet 2 epochs, the others 10
                          steps): exit 0, finite losses, a throughput
                          line; K1 300 in train_wmt (30 a step), no kernel
                          in the others (the counters printed at each
                          subprocess's exit).

16-bit outputs are held to ``ulp_ratio`` <= 1: |kernel - plain| at most
two units in the last place of the plain value plus one unit at the
tensor's largest value, since both sides compute in f32 and round once.

Then the card's nvidia-smi line, one ``{"kernels": [...]}`` line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed phase makes
the script exit non-zero without that line, as does a machine without
CUDA or a directory without the package.

Times are CUDA-event medians of 15 samples of 10 back-to-back calls each
(at K7's (16384, 30522) shapes 10 samples of 5, and 5 of 2 for its plain
version), enqueued behind a device sleep so that host-side launch cost
does not show as device time.  ``bound_ms`` is the larger of the bytes the
function must move over 3.35 TB/s and its f32 operations over 67 TFLOP/s
(the H100 SXM data sheet at 700 W); for K3-K5 the operations are f32-
accurate products on the tensor cores, three TF32 products each (3xTF32)
at 495 TFLOP/s, and the CUDA-core figure stays beside it as
``bound_f32_cores_ms``; a 16-bit row's ``bound_16bit_ms`` takes its
products at the dense bf16/f16 rate, 989 TFLOP/s, and is the bound of a
row of the ``wgmma16`` design; a 16-bit row of the f32 core multiplies in
3xTF32 and keeps the 3xTF32 bound.  No kernel may read faster than its
bound.
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
# the 16-bit design (wgmma16) rounds P and dS to the input type before
# their products; its rows are held to half that gate, the bound its CPU
# emulation is held to (tests/test_torch_flash16.py): the sound kernels
# read at most 0.31 on an H100, while that emulation with lse rounded to
# bf16 before the exponential reads 0.95 on dk and 0.84 on dv
ULP_WGMMA16 = 0.5


def ulp_ratio(got, want, eps: float) -> float:
    """max |got - want| / (2 eps |want| + eps max|want|): <= 1 passes."""
    g, w = got.detach().float(), want.detach().float()
    allow = 2 * eps * w.abs() + eps * float(w.abs().max()) + 1e-30
    return float(((g - w).abs() / allow).max())


def time_ms(torch, fn, samples: int = 15, reps: int = 10) -> float:
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
    k3_16 = {hd: _fwd_shape(hd, torch.bfloat16) for hd in (64, 128)}
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
            "flash_fwd_f32": k3, "flash_fwd_wgmma16": k3_16,
            "ptxas": {k: _ptxas(v) for k, v in _build.BUILD_LOG.items()}}


def _ptxas(log: str) -> list:
    """The per-kernel lines of ``ptxas -v`` (mangled name, then its
    registers, shared memory and spills), as nvcc printed them."""
    return [line.strip() for line in log.splitlines()
            if "Function properties" in line or "spill" in line
            or "Used" in line or "Performance Loss" in line]


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
    from mxnet_tpu_torch.ops.kernels.flash_attention import (_design,
                                                             pad_head_dim)

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
    row["design"] = _design(q.dtype, pad_head_dim(q, q, q)[0].shape[-1])
    gate = ULP_WGMMA16 if row["design"] == "wgmma16" else 1
    ratios = {n: ulp_ratio(a, b, EPS16[dtype]) for n, (a, b) in pairs.items()}
    return dict(row, ulp_ratios=ratios,
                ok=all(r <= gate for r in ratios.values()))


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
            [r["max_abs_err"] for r in rows_] + checked_err),
            design="f32-core")
        ctx[kname]["library_is"] = (
            "scaled_dot_product_attention forward" if kname.endswith("fwd")
            else "scaled_dot_product_attention backward (dq, dk and dv in "
                 "one call: fwd+bwd minus fwd)")
    more = _flash_rows_16bit_and_wide(torch, g, tol)
    # the kernels line's rows of the 16-bit design: the train shape in bf16
    train16 = next(r for r in more
                   if r["case"] == "train" and r["dtype"] == "bfloat16")
    for kname, key, outs in (("flash_attention_fwd", "fwd", ("out", "lse")),
                             ("flash_attention_dq", "dq", ("dq",)),
                             ("flash_attention_dkv", "dkv", ("dk", "dv"))):
        ctx[kname + "_wgmma16"] = dict(
            {k_: train16[key][k_] for k_ in ("ms", "plain_ms", "library_ms",
                                             "bound_ms", "bound_by",
                                             "design", "bwd_pair_ms")
             if k_ in train16[key]},
            max_abs_err=max(train16["errors"][o] for o in outs),
            library_is=ctx[kname]["library_is"] + ", bf16")
    checks += [_padded_head_dim_case(torch, g, 4, 100, 200, causal, tol, dt)
               for dt in ("float32", "bfloat16") for causal in (False, True)]
    return {"tol": tol, "kernels": out_rows, "bwd_pairs": pairs_out,
            "checked": checks, "dtypes_and_widths": more,
            "tol_16bit": "ulp_ratio <= 1 on out, dq, dk, dv (a wgmma16 row: "
                         "<= 0.5); lse atol 2e-5",
            "bound_is": "bound_ms: bytes / 3.35 TB/s or 3 x f32 operations "
                        "/ 495 TFLOP/s (3xTF32 on the tensor cores), or at "
                        "a wgmma16 row bound_16bit_ms; bound_f32_cores_ms: "
                        "f32 operations / 67 TFLOP/s; bound_16bit_ms: "
                        "16-bit bytes / 3.35 TB/s or operations / 989 "
                        "TFLOP/s",
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
# name: (N, Lq, Lk, D, causal) and its dtype: ragged tiles of the 16-bit
# design, checked but not timed
FLASH16_CHECKED = {"ragged_hd64": ((3, 200, 333, 64, False), "bfloat16"),
                   "causal_lq_ne_lk_hd128": ((4, 130, 70, 128, True),
                                             "float16")}


def _flash_rows_16bit_and_wide(torch, g, tol):
    """K3-K5 at FLASH_MORE's cases against the plain versions, timed with
    their plain versions and SDPA in the same dtype (K4 and K5 beside
    SDPA's whole backward) beside the bound; then FLASH16_CHECKED's cases,
    checked only.  A 16-bit row names the design K3, K4 and K5 ran
    (``_design``, one for the three) and carries the 16-bit bound, the
    bound of a ``wgmma16`` kernel; its ulp ratios (dq's too) are held to
    ``ULP_WGMMA16`` and its dq, dk and dv must repeat bitwise."""
    from mxnet_tpu_torch.ops.kernels import (flash_attention_dkv,
                                             flash_attention_dkv_ref,
                                             flash_attention_dq,
                                             flash_attention_dq_ref,
                                             flash_attention_fwd,
                                             flash_attention_ref)
    from mxnet_tpu_torch.ops.kernels.flash_attention import (_design,
                                                             _fwd_shape)

    F = torch.nn.functional
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for name, ((N, Lq, Lk, D, causal), dtypes) in FLASH_MORE.items():
        for dtype in dtypes:
            q, k, v, do = (t.to(getattr(torch, dtype))
                           for t in _flash_inputs(torch, g, N, Lq, Lk, D))
            eps = EPS16.get(dtype)
            design = _design(q.dtype, D)
            err, same, fwd_same, args, ratios = _flash_errors(
                torch, q, k, v, do, causal, eps)
            if eps:
                gate = ULP_WGMMA16 if design == "wgmma16" else 1
                ok = (all(r <= gate for r in ratios.values())
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
            for kname, (kern, plain, lib_ms) in timed.items():
                ms = time_ms(torch, kern, **tk)
                t = times[kname] = {"ms": ms,
                                    "plain_ms": time_ms(torch, plain, **tk),
                                    "library_ms": lib_ms,
                                    "over_library": ms / lib_ms}
                t["bound_ms"], t["bound_by"] = bound_3xtf32(*work[kname])
                if eps:
                    # the least time for the work from 16-bit operands:
                    # their bytes, and the products at the dense 16-bit
                    # tensor-core rate; the bound of a wgmma16 kernel
                    b16 = bound(*work[kname], BF16_FLOPS_PER_S)
                    t["design"] = design
                    t["bound_16bit_ms"], t["bound_16bit_by"] = b16
                    if t["design"] == "wgmma16":
                        t["bound_ms"], t["bound_by"] = b16
                # a row of the f32 core multiplies in 3xTF32 whatever its
                # input type: its bound stays bound_3xtf32's
                t["ok"] = ms >= t["bound_ms"]
            # K4 + K5, the backward SDPA's one call computes
            pair = times["dq"]["ms"] + times["dkv"]["ms"]
            for key in ("dq", "dkv"):
                times[key].update(bwd_pair_ms=pair,
                                  bwd_pair_over_library=pair / sdpa_bwd)
            shape = _fwd_shape(D, q.dtype)
            tiles = N * -(-Lq // shape["rows"])
            # the wgmma16 forward is persistent: one block an SM at most
            times["fwd"]["blocks"] = (min(tiles, sms) if design == "wgmma16"
                                      else tiles)
            rows.append({"case": name, "dtype": dtype, "N": N, "Lq": Lq,
                         "Lk": Lk, "hd": D, "causal": causal,
                         **({"design": design} if eps else {}),
                         "errors": err, "ulp_ratios": ratios,
                         "fwd_bitwise_repeatable": fwd_same,
                         "bwd_bitwise_repeatable": same,
                         "ok": ok and same and fwd_same
                         and all(t["ok"] for t in times.values()), **times})
            del l4, q, k, v, do, args
            torch.cuda.empty_cache()
    for name, ((N, Lq, Lk, D, causal), dtype) in FLASH16_CHECKED.items():
        q, k, v, do = (t.to(getattr(torch, dtype))
                       for t in _flash_inputs(torch, g, N, Lq, Lk, D))
        err, same, fwd_same, _, ratios = _flash_errors(
            torch, q, k, v, do, causal, EPS16[dtype])
        rows.append({"case": name, "dtype": dtype, "N": N, "Lq": Lq,
                     "Lk": Lk, "hd": D, "causal": causal,
                     "design": _design(q.dtype, D), "errors": err,
                     "ulp_ratios": ratios, "fwd_bitwise_repeatable": fwd_same,
                     "bwd_bitwise_repeatable": same,
                     "ok": (all(r <= ULP_WGMMA16 for r in ratios.values())
                            and err["lse"] <= tol["lse"] and same
                            and fwd_same)})
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


# the fleet: two replicas behind a Router, 8 client threads; 4 sessions
# of 3 requests (serve's requests 0-11) and 4 without (12-15)
FLEET_CLIENTS, FLEET_SESSIONS = 8, 4
# the traffic a swap is staged under: four times serve's 16 requests,
# several times as long as loading, verifying and staging a checkpoint
# (the phase's swap_weights line has verify_ms beside it)
FLEET_SWAP_REQUESTS = 64


def _http_json(url, body, timeout=600.0):
    """POST ``body`` and decode the JSON answer."""
    import urllib.request

    data = json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _fleet_round(url, jobs, on_done=None):
    """POST ``jobs`` ([(key, body)]) to ``url``/generate from
    FLEET_CLIENTS client threads; ``on_done(n)`` runs in the client that
    got the n-th answer.  Returns ({key: {out, t_send, t_recv}}, errors,
    wall s from the first send to the last answer)."""
    import queue
    import threading

    q = queue.Queue()
    for job in jobs:
        q.put(job)
    results, errors, lock = {}, [], threading.Lock()

    def client():
        while True:
            try:
                key, body = q.get_nowait()
            except queue.Empty:
                return
            t_send = time.perf_counter()
            try:
                out = _http_json(url + "/generate", body)
            except Exception as e:  # a failed request is the phase's verdict
                with lock:
                    errors.append(f"{key}: {type(e).__name__}: {e}"[:300])
                continue
            with lock:
                results[key] = {"out": out, "t_send": t_send,
                                "t_recv": time.perf_counter()}
                n = len(results)
            if on_done is not None:
                on_done(n)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(FLEET_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, errors, time.perf_counter() - t0


def _fleet_jobs(tag, reqs, sessions=True):
    """/generate bodies of ``reqs``: requests 0-11 in FLEET_SESSIONS
    sessions of 3, the rest without one."""
    jobs = []
    for i, r in enumerate(reqs):
        body = {"prompt": [int(t) for t in r.tokens],
                "max_new_tokens": r.max_new_tokens,
                "request_id": f"{tag}{i}"}
        if sessions and i < 3 * FLEET_SESSIONS:
            body["session"] = f"{tag}s{i % FLEET_SESSIONS}"
        jobs.append((i, body))
    return jobs


def _handle_ms(teldir):
    """trace id -> the replica's ``serve_handle`` span ms, from the
    telemetry stream (paired spans: the begin names the trace, the end
    carries the duration)."""
    from mxnet_tpu_torch import telemetry

    telemetry.flush()
    begins, out = {}, {}
    with open(telemetry.event_path(teldir, 0)) as f:
        for line in f:
            e = json.loads(line)
            if e.get("name") != "serve_handle":
                continue
            if e["kind"] == "span_begin":
                begins[e["span"]] = e.get("trace_id")
            elif e["kind"] == "span_end" and e["span"] in begins:
                out[begins[e["span"]]] = e["dur_ms"]
    return out


def _report_tool(tool, *args):
    """Run ``tools/<tool>`` with ``--json``: (exit code, its report)."""
    out = subprocess.run([sys.executable, os.path.join("tools", tool),
                          *args, "--json"], capture_output=True, text=True,
                         timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        rep = json.loads(out.stdout)
    except ValueError:
        rep = {"stdout": out.stdout[-500:], "stderr": out.stderr[-500:]}
    return out.returncode, rep


def phase_serve_fleet(torch, ctx):
    """The fleet on one card: two ReplicaServers (ranks 0 and 1, each its
    own Transformer-big engine of serve's weights) behind a Router that
    finds them through portfiles, with the telemetry recorder and the
    metrics endpoint on.  Round 1: serve's 16 requests from 8 clients (4
    sessions of 3, 4 without), each answer serve's tokens and each
    session on one replica.  Round 2: the same with replica 1 drained
    after 4 answers and undrained after 12.  Round 3: a session pinned
    to replica 1, then the 16 again with replica 1 stopped after 4
    answers; the session fails over to replica 0 and stays there.
    Round 4: a Transformer-big of seed + 1 checkpointed in format 1 and
    2 swaps into replica 0 (format 1 under FLEET_SWAP_REQUESTS requests,
    format 2 idle); requests after the flip equal an engine restored
    from the checkpoint; checkpoints of vocab 32008 and of bf16 are
    rejected.  K1 and K2 launches exact over both engines; the report
    tools exit 0 on the streams and checkpoints."""
    import shutil
    import threading
    import urllib.request

    from mxnet_tpu_torch import checkpoint, memwatch, metrics_server
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.models.transformer import transformer_big
    from mxnet_tpu_torch.serving import (ReplicaServer, Request, Router,
                                         ServingEngine, TransformerAdapter)

    vocab, kw, smi = 32000, ctx["engine_kw"], ctx["smi"]
    want = ctx["serve_tokens"]
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "serve_fleet")
    shutil.rmtree(root, ignore_errors=True)
    teldir = os.path.join(root, "telemetry")
    os.makedirs(teldir)
    env_before = {k: os.environ.get(k) for k in ("MX_TELEMETRY_DIR",
                                                 "MX_METRICS_PORT")}
    os.environ.update(MX_TELEMETRY_DIR=teldir, MX_METRICS_PORT="0")
    telemetry.reset()
    memwatch.reset()
    telemetry.enable(teldir)
    metrics_server.start()

    def big(v=vocab, seed=SEED):
        return transformer_big(v, dropout=0.0, max_length=1024,
                               generator=torch.Generator().manual_seed(seed))

    # the checkpoints: seed + 1 in format 1 and 2, and two of another
    # structure (vocab 32008; the same net in bf16)
    ck = {k: os.path.join(root, k) for k in ("f1", "f2", "bf16", "vocab")}
    t0 = time.perf_counter()
    other = big(seed=SEED + 1)
    for key, sharded in (("f1", False), ("f2", True)):
        w = checkpoint.AsyncCheckpointer(ck[key], save_every=1,
                                         sharded=sharded)
        w.step(other)
        w.close()
    other.cast("bfloat16")
    w = checkpoint.AsyncCheckpointer(ck["bf16"], save_every=1)
    w.step(other)
    w.close()
    del other
    other = big(v=vocab + 8, seed=SEED + 2)
    w = checkpoint.AsyncCheckpointer(ck["vocab"], save_every=1)
    w.step(other)
    w.close()
    del other
    torch.cuda.empty_cache()
    ckpt_s = time.perf_counter() - t0

    models = [big(), big()]
    adapters = [TransformerAdapter(m, src_max_len=64) for m in models]
    engines = [ServingEngine(a, **kw) for a in adapters]
    prefills = [{}, {}]
    for a, calls in zip(adapters, prefills):
        _tally(a, "prefill", calls)
    reps = [ReplicaServer(e, bos_id=1, eos_id=2, port=0, rank=r,
                          directory=root).start()
            for r, e in enumerate(engines)]
    # no health polls: the router learns of a dead replica by its refusal
    router = Router(root, port=0, health_sec=3600.0).start()
    url = f"http://127.0.0.1:{router.port}"
    checks, errors = {}, []
    try:
        reqs = _requests(16, vocab, SEED)[0]
        counters = _counters()
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0

        # round 1: affinity and least-outstanding
        r1, err, wall1 = _fleet_round(url, _fleet_jobs("a", reqs))
        errors += err
        homes = {}
        for i, res in r1.items():
            if i < 3 * FLEET_SESSIONS:
                homes.setdefault(i % FLEET_SESSIONS, set()).add(
                    res["out"]["routed_to"])
        checks["r1_tokens"] = all(r1[i]["out"]["tokens"] == want[i]
                                  for i in r1) and len(r1) == 16
        checks["r1_sessions_pinned"] = all(len(h) == 1
                                           for h in homes.values())
        checks["r1_both_replicas"] = {res["out"]["routed_to"]
                                      for res in r1.values()} == {0, 1}
        # the same traffic without sessions under the profiler: where the
        # fleet's time goes (device activity only)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rp, err, wallp = _fleet_round(url, _fleet_jobs("p", reqs, False))
            torch.cuda.synchronize()
        errors += err
        checks["profiled_tokens"] = all(rp[i]["out"]["tokens"] == want[i]
                                        for i in rp) and len(rp) == 16
        prof_rows = _profile_rows(prof)
        busy_ms = sum(ms for ms, _, _ in prof_rows)

        # round 2: replica 1 drained mid traffic, then undrained
        window = {}

        def drain(n):
            if n == 4 and "on" not in window:
                window["on"] = None
                _http_json(url + "/admin/drain?rank=1", {})
                window["on"] = time.perf_counter()
            elif n == 12 and "off" not in window:
                window["off"] = time.perf_counter()
                _http_json(url + "/admin/undrain?rank=1", {})

        r2, err, _ = _fleet_round(url, _fleet_jobs("b", reqs), drain)
        errors += err
        during = [res for res in r2.values()
                  if window.get("on") and res["t_send"] > window["on"]
                  and res["t_send"] < window.get("off", float("inf"))]
        checks["r2_tokens"] = all(r2[i]["out"]["tokens"] == want[i]
                                  for i in r2) and len(r2) == 16
        checks["r2_none_on_drained"] = bool(during) and all(
            res["out"]["routed_to"] == 0 for res in during)
        checks["r2_undrained"] = all(
            not r["draining"] for r in router.replicas())

        # round 3: replica 1 stopped with requests in flight
        _http_json(url + "/admin/drain?rank=0", {})
        pin = _http_json(url + "/generate", {
            "prompt": [int(t) for t in reqs[0].tokens],
            "max_new_tokens": reqs[0].max_new_tokens, "session": "fo"})
        _http_json(url + "/admin/undrain?rank=0", {})
        fo = []

        def stop_one(n):
            if n == 4 and not fo:
                fo.append(None)
                reps[1].stop()
                for _ in range(2):
                    fo.append(_http_json(url + "/generate", {
                        "prompt": [int(t) for t in reqs[0].tokens],
                        "max_new_tokens": reqs[0].max_new_tokens,
                        "session": "fo"}))

        r3, err, _ = _fleet_round(url, _fleet_jobs("c", reqs, False),
                                  stop_one)
        errors += err
        dead = [r for r in router.replicas() if r["rank"] == 1]
        checks["r3_tokens"] = all(r3[i]["out"]["tokens"] == want[i]
                                  for i in r3) and len(r3) == 16
        checks["r3_pinned_to_1_first"] = pin["routed_to"] == 1
        checks["r3_failover"] = (
            router.failovers >= 1 and len(fo) == 3
            and all(o["routed_to"] == 0 and o["tokens"] == want[0]
                    for o in fo[1:])
            and bool(dead) and not dead[0]["healthy"])

        # round 4: hot swap on replica 0 under traffic, then rejections
        eng = engines[0]
        swap, flips = {}, []
        apply = eng._apply_pending_swap

        def recorded_apply():
            # which thread flips, and the census just before it
            if eng._swap_pending is not None:
                flips.append({"thread": threading.current_thread().name,
                              "census": memwatch.census()})
            apply()

        eng._apply_pending_swap = recorded_apply

        def stage(n):
            if n == 2 and not swap:
                swap["t0"] = time.perf_counter()
                swap["step"] = eng.swap_weights(ck["f1"])
                swap["t1"] = time.perf_counter()

        many = (reqs * (FLEET_SWAP_REQUESTS // len(reqs) + 1))
        r4, err, _ = _fleet_round(
            url, _fleet_jobs("d", many[:FLEET_SWAP_REQUESTS], False), stage)
        errors += err
        census_after = memwatch.census()
        gen1 = eng.weight_generation
        after, err, _ = _fleet_round(url, _fleet_jobs("e", reqs[:8], False))
        errors += err
        rejected = {}
        for key in ("vocab", "bf16"):
            try:
                eng.swap_weights(ck[key])
                rejected[key] = False
            except MXNetError as e:
                rejected[key] = "rejected" in str(e)
        kept, err, _ = _fleet_round(url, _fleet_jobs("f", reqs[:2], False))
        errors += err
        while eng._running or eng._run_lock.locked():
            time.sleep(0.01)  # the run loop's tail after the last answer
        eng.swap_weights(ck["f2"])
        gen2 = eng.weight_generation
        kept2, err, _ = _fleet_round(url, _fleet_jobs("g", reqs[:2], False))
        errors += err
        torch.cuda.synchronize()
        launches = {n: c.launches for n, c in counters.items()}
        steps = sum(e.step_count for e in engines)
        n_prefill = sum(c["prefill"] for c in prefills)
        expected = _expected(18 * steps + 12 * n_prefill, 6 * steps)
        peak = torch.cuda.max_memory_allocated()

        with urllib.request.urlopen(
                f"http://127.0.0.1:{metrics_server.port()}/metrics",
                timeout=60) as r:
            metrics = r.read().decode()
        # rounds 1-3, the pinning request and the two failed over, round
        # 4's traffic and the requests after the flip and the rejections
        answered = (len(r1) + len(rp) + len(r2) + len(r3) + 1 + len(fo) - 1
                    + len(r4) + len(after) + len(kept) + len(kept2))
    finally:
        router.stop()
        for rep in reps:
            rep.stop()
        metrics_server.stop()

    # the references, outside the counted window and the recorder: an
    # engine restored from the format-1 checkpoint (the stopped replica's
    # model)
    telemetry.disable()
    assert checkpoint.restore(ck["f1"], models[1]) == 1
    ref_reqs = [Request(r.tokens, r.max_new_tokens, bos_id=1, eos_id=2)
                for r in reqs[:8]]
    ref = ServingEngine(adapters[1], **kw).serve(ref_reqs)
    ref = [list(ref[r.id]) for r in ref_reqs]
    # the format-1 swap flipped on replica 0's run loop (staged under
    # traffic), the format-2 one at once on this idle engine's caller
    checks["r4_flip_threads"] = [f["thread"] for f in flips] == [
        "mx-serve-engine-0", threading.current_thread().name]
    checks["r4_generation"] = (swap.get("step") == 1 and gen1 == 1
                               and gen2 == 2)
    checks["r4_after_flip_equals_restored"] = all(
        after[i]["out"]["tokens"] == ref[i]
        and after[i]["out"]["generation"] == 1 for i in after) \
        and len(after) == 8
    checks["r4_swap_changed_tokens"] = any(ref[i] != want[i]
                                           for i in range(8))
    checks["r4_rejected"] = rejected == {"vocab": True, "bf16": True}
    checks["r4_old_weights_kept"] = all(
        kept[i]["out"]["tokens"] == ref[i] for i in kept) and all(
        kept2[i]["out"]["tokens"] == ref[i]
        and kept2[i]["out"]["generation"] == 2 for i in kept2)
    staged_cat = flips[0]["census"]["categories"] if flips else {}
    checks["r4_staging_drained"] = (
        staged_cat.get("staging", {}).get("nbytes", 0) > 0
        and "staging" not in census_after["categories"])
    checks["r4_all_finished"] = len(r4) == FLEET_SWAP_REQUESTS
    checks["metrics_generation_2"] = (
        'mx_serve_weight_generation{rank="0"} 2' in metrics)
    checks["no_request_failed"] = not errors
    checks["launches_exact"] = launches == expected and steps > 0

    # the report tools on what the fleet wrote
    reports = {}
    for tool, arg in (("serve_report.py", teldir),
                      ("trace_report.py", teldir),
                      ("mem_report.py", teldir),
                      ("ckpt_report.py", ck["f1"]),
                      ("ckpt_report.py", ck["f2"])):
        rc, rep = _report_tool(tool, arg)
        reports[f"{tool}:{os.path.basename(arg)}"] = {
            "rc": rc, **{k: rep.get(k) for k in ("requests", "unfinished",
                                                 "anomalies", "causes",
                                                 "num_ranks")
                         if k in rep}}
    checks["reports_exit_0"] = all(r["rc"] == 0 for r in reports.values())
    checks["serve_report_counts_answers"] = (
        reports[f"serve_report.py:telemetry"].get("requests") == answered)

    # the printed lines
    r1_tokens = sum(len(res["out"]["tokens"]) for res in r1.values())
    ttft = [res["out"]["ttft_ms"] for rnd in (r1, rp, r2, r3, r4, after)
            for res in rnd.values()]
    handle = _handle_ms(teldir)
    added = [1e3 * (res["t_recv"] - res["t_send"])
             - handle[res["out"]["trace_id"]]
             for rnd in (r1, rp, r2, r3, after) for res in rnd.values()
             if res["out"].get("trace_id") in handle]
    swaps = []
    with open(telemetry.event_path(teldir, 0)) as f:
        for line in f:
            e = json.loads(line)
            if e["kind"] == "weight_swap" and not e.get("rejected"):
                swaps.append({k: e.get(k) for k in (
                    "generation", "staged_bytes", "verify_ms", "flip_ms")})
    census = {cat: row["nbytes"] for cat, row in
              staged_cat.items()}
    lines = [
        {"fleet_tokens_per_s": r1_tokens / wall1, "tokens": r1_tokens,
         "wall_s": wall1, "replicas": 2, "clients": FLEET_CLIENTS,
         "decode_step_ms_median_by_replica": [
             statistics.median(1e3 * t / n for n, t in e.burst_times)
             for e in engines]},
        {"fleet_profiled_wall_s": wallp,
         "device_busy_ms": busy_ms if prof_rows else None,
         "device_busy_share": busy_ms / (1e3 * wallp) if prof_rows
         else None,
         "device_ops": sum(c for _, c, _ in prof_rows),
         "top": [{"name": k[:80], "ms": ms, "count": c}
                 for ms, c, k in prof_rows[:6]]},
        {"fleet_ttft_ms_p50": float(np.percentile(ttft, 50)),
         "fleet_ttft_ms_p90": float(np.percentile(ttft, 90)),
         "requests": len(ttft)},
        {"router_added_ms_median": statistics.median(added),
         "router_added_ms_p90": float(np.percentile(added, 90)),
         "requests": len(added),
         "is": "client /generate wall minus the replica's serve_handle "
               "span (host clocks)"},
        {"swap_weights": swaps, "staged_bytes": swaps[0]["staged_bytes"]
         if swaps else None, "swap_call_s": swap.get("t1", 0)
         - swap.get("t0", 0)},
        {"memwatch_census_bytes_while_staged": census,
         "memwatch_census_bytes_after_flip": {
             cat: row["nbytes"]
             for cat, row in census_after["categories"].items()},
         "max_memory_allocated": peak}]
    for ln in lines:
        emit({"serve_fleet": ln, "card": smi})
    telemetry.reset()
    memwatch.reset()
    for k, v in env_before.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    ctx.setdefault("launches", {})["serve_fleet"] = launches
    return {"requests_answered": answered, "decode_steps": steps,
            "prefills": n_prefill, "launches": launches,
            "launches_expected": expected, "failovers": router.failovers,
            "checkpoint_prep_s": ckpt_s, "reports": reports,
            "swap": swap, "flip_threads": [f["thread"] for f in flips],
            "errors": errors[:10], "checks": checks, "card": smi,
            "ok": all(checks.values())}


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
# the wrapper whose launch counter counts each of those kernels
OUR_KERNEL_COUNTER = dict(zip(OUR_KERNELS, ("layer_norm",
                                            "paged_decode_attention") + FLASH))


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
        "losses": losses,
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


# K3's, K4's and K5's wrappers also count their launches of the 16-bit
# design (csrc/flash_attention_16.cu) in ``launches_wgmma16``
WGMMA16_KERNELS = ("flash_attention_fwd", "flash_attention_dq",
                   "flash_attention_dkv")


def _wgmma16_zero():
    from mxnet_tpu_torch.ops import kernels

    for n in WGMMA16_KERNELS:
        getattr(kernels, n).launches_wgmma16 = 0


def _wgmma16_read():
    """K3's, K4's and K5's launches of the ``wgmma16`` design since
    ``_wgmma16_zero``, by wrapper name."""
    from mxnet_tpu_torch.ops import kernels

    return {n: getattr(kernels, n).launches_wgmma16 for n in WGMMA16_KERNELS}


def _f32_core(launches, wgmma16):
    """K3's, K4's and K5's launches of the f32 core: the wrapper's count
    less the ``wgmma16`` design's."""
    return {n: launches[n] - wgmma16[n] for n in WGMMA16_KERNELS}


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
                samples=10 if big else 15, reps=5 if big else 10)
        rows.append({
            "case": name, "N": n, "C": c, "ignore_label": ignore,
            "live_rows": live, "max_abs_err": err, "grad_max_abs_err": gerr,
            "ok": err <= tol["loss"] and gerr <= tol["grad"],
            "ms": time_ms(torch, lambda: softmax_cross_entropy(x, y, ignore),
                          samples=10 if big else 15, reps=5 if big else 10),
            "plain_ms": time_ms(torch, lambda: softmax_cross_entropy_ref(
                x, y, ignore), samples=5 if big else 15,
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
            samples=10 if big else 15, reps=5 if big else 10)
    row = {"case": name, "dtype": dtype, "N": n, "C": c,
           "ignore_label": ignore, "live_rows": live, "max_abs_err": err,
           "grad_ulp_ratio": ratio, "ok": err <= tol["loss"] and ratio <= 1,
           "ms": time_ms(torch, lambda: softmax_cross_entropy(x, y, ignore),
                         samples=10 if big else 15, reps=5 if big else 10),
           "plain_ms": time_ms(torch, lambda: softmax_cross_entropy_ref(
               x, y, ignore), samples=5 if big else 15,
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
    fused_kernels pass or none: (loss, launches, wall ms, K3-K5's
    launches of the ``wgmma16`` design)."""
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.passes import FusedKernelPass, PassPipeline

    pipe = PassPipeline([FusedKernelPass()] if fused else [])
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    _wgmma16_zero()
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
            {n: fn.launches for n, fn in counters.items()}, wall_ms,
            _wgmma16_read())


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
    warm-up and one run each, launches as in ``imperative``, K3-K5's
    of the ``wgmma16`` design), on against
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
    ctx.setdefault("launches_wgmma16", {})["imperative_bf16"] = on[3]
    # bf16 at IMP_HD 64: every K3-K5 launch is of the wgmma16 design
    launches_ok = (on[1] == IMP_PASS_ON and off[1] == IMP_PASS_OFF
                   and all(r[3] == {n: r[1][n] for n in WGMMA16_KERNELS}
                           for r in (on, off)))
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
            "launches_wgmma16_pass_on": on[3],
            "launches_wgmma16_pass_off": off[3],
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
    _wgmma16_zero()
    losses, step_ms, wall = _train_steps(torch, step, tokens, labels,
                                         TRAIN_STEPS)
    launches = {n: fn.launches for n, fn in counters.items()}
    wgmma16 = _wgmma16_read()
    f32_core = _f32_core(launches, wgmma16)
    ctx["launches"]["train_bf16"] = launches
    ctx.setdefault("launches_wgmma16", {})["train_bf16"] = wgmma16
    expected = {n: k * TRAIN_STEPS for n, k in TRAIN_PER_STEP.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = _step_profile(torch, lambda: step.step(tokens, labels))
    flash = {k: prof["our_kernels_ms"][k]
             for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    busy = prof["device_busy_ms"]  # one step
    losses = [first] + losses
    f32 = ctx.get("train_f32", {})
    tps = TRAIN_BATCH * TRAIN_LEN * TRAIN_STEPS / wall
    ctx["train_bf16"] = {"tokens_per_s": tps,
                         "step_ms_median": statistics.median(step_ms),
                         "max_memory_allocated_gb": peak_gb,
                         "losses": losses}
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
        "launches_wgmma16": wgmma16, "launches_f32_core": f32_core,
        "profile_one_step": prof, "flash_ms": flash,
        "flash_share_of_busy": sum(flash.values()) / busy if busy else None,
        "card": ctx["smi"],
        "ok": bool(all(math.isfinite(x) for x in losses)
                   and losses[-1] < losses[0] and launches == expected
                   and wgmma16 == {n: expected[n] for n in wgmma16}
                   and not any(f32_core.values())
                   and dtypes == ["torch.bfloat16"])}


# ---------------------------------------------------------------------------
# multi-GPU part 1 on one card: a one-rank NCCL group and the sp routes
# ---------------------------------------------------------------------------
DIST_STEPS = 3
DIST_TRAINER_BATCH = (4, 128)
DIST_TRAINER_STEPS = 2
SP_SHAPE = (96, 512, 64)  # BERT-base's attention at 8 x 512 a rank


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _one_rank_group():
    """This process as a one-rank NCCL group (localhost, a free port)."""
    from mxnet_tpu_torch.parallel import dist

    if not dist.is_initialized():
        dist.init(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda:0")
    return dist


def _dist_bert_run(torch, dtype, mesh, tokens, labels):
    """BERT-base from train's weights (seed), DIST_STEPS Adam steps at lr
    1e-4 through DataParallelStep (over ``mesh`` when given) -> (losses,
    parameters, launches by wrapper, wgmma16 launches)."""
    from mxnet_tpu_torch.gluon.block import cast
    from mxnet_tpu_torch.models.bert import bert_base
    from mxnet_tpu_torch.parallel import DataParallelStep

    model = bert_base(BERT_VOCAB, dropout=0.0,
                      generator=torch.Generator().manual_seed(SEED))
    if dtype == "bfloat16":
        model = cast(model, "bfloat16")
    step = DataParallelStep(model, _mlm_loss(torch), optimizer="adam",
                            optimizer_params={"learning_rate": 1e-4},
                            mesh=mesh)
    counters = _counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    _wgmma16_zero()
    losses = [float(step.step(tokens, labels)) for _ in range(DIST_STEPS)]
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    params = [p.detach().clone() for p in model.parameters()]
    del step, model
    torch.cuda.empty_cache()
    return losses, params, launches, _wgmma16_read()


def _gluon_trainer_run(torch, kvstore, tokens, labels):
    """The Gluon loop on BERT-base (NDArray call, record, backward,
    ``Trainer.step``) for DIST_TRAINER_STEPS Adam steps through ``kvstore``
    -> (losses, parameters)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.models.bert import bert_base

    net = bert_base(BERT_VOCAB, dropout=0.0,
                    generator=torch.Generator().manual_seed(SEED))
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-4}, kvstore=kvstore)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    x = nd.array(tokens, ctx=mx.gpu(0), dtype="int32")
    y = nd.array(labels, ctx=mx.gpu(0))
    losses = []
    for _ in range(DIST_TRAINER_STEPS):
        with autograd.record():
            out = net(x)
            loss = loss_fn(out.reshape((-1, BERT_VOCAB)),
                           y.reshape((-1,))).mean()
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asscalar()))
    trainer.drain()
    params = [p.detach().clone() for p in net.parameters()]
    del net, trainer
    torch.cuda.empty_cache()
    return losses, params


def _same(torch, a, b) -> bool:
    """Two lists of tensors equal bit for bit."""
    return len(a) == len(b) and all(bool(torch.equal(x, y))
                                    for x, y in zip(a, b))


def phase_dist_single(torch, ctx):
    """The multi-GPU path on the one card: a one-rank NCCL group (a
    localhost rendezvous on a free port) and ``make_mesh()`` of one rank.
    BERT-base at 32 x 512 from train's weights and batch, DIST_STEPS Adam
    steps through ``DataParallelStep(mesh=...)``, f32 then bf16: the
    gradients go through the flat-bucket all-reduce of the group, which
    over one rank is exact, so losses and parameters must equal the plain
    step's bit for bit (run here from the same weights), and the losses
    the first DIST_STEPS of the ``train`` / ``train_bf16`` phases.
    Launches a step: K1 26, K3-K5 12 (all ``wgmma16`` in bf16).  Then the
    Gluon loop on BERT-base at DIST_TRAINER_BATCH for DIST_TRAINER_STEPS
    steps with ``kvstore="dist_sync"`` and with a ``nccl`` store over
    ``[gpu(0)]``, each equal to ``kvstore="device"`` bit for bit."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import make_mesh

    dist = _one_rank_group()
    mesh = make_mesh()
    tokens, labels = ctx["train_batch"]
    rows, ok = {}, True
    for dtype, phase in (("float32", "train_f32"),
                         ("bfloat16", "train_bf16")):
        plain = _dist_bert_run(torch, dtype, None, tokens, labels)
        meshed = _dist_bert_run(torch, dtype, mesh, tokens, labels)
        launches, w16 = meshed[2], meshed[3]
        want = {n: k * DIST_STEPS for n, k in TRAIN_PER_STEP.items()}
        want16 = ({n: want[n] for n in WGMMA16_KERNELS}
                  if dtype == "bfloat16" else {n: 0 for n in WGMMA16_KERNELS})
        earlier = ctx.get(phase, {}).get("losses", [])[:DIST_STEPS]
        row = {"losses": meshed[0], "plain_losses": plain[0],
               "phase_losses": earlier,
               "losses_bitwise": meshed[0] == plain[0],
               "params_bitwise": _same(torch, meshed[1], plain[1]),
               "phase_losses_equal": meshed[0] == earlier,
               "launches": launches, "launches_expected": want,
               "launches_wgmma16": w16}
        row["ok"] = bool(row["losses_bitwise"] and row["params_bitwise"]
                         and row["phase_losses_equal"]
                         and launches == want and w16 == want16)
        ctx["launches"][f"dist_single_{dtype}"] = launches
        if dtype == "bfloat16":
            ctx.setdefault("launches_wgmma16", {})[
                "dist_single_bfloat16"] = w16
        rows[dtype] = row
        ok = ok and row["ok"]
        del plain, meshed
    B, L = DIST_TRAINER_BATCH
    tb, lb = tokens[:B, :L], labels[:B, :L]
    ref = _gluon_trainer_run(torch, "device", tb, lb)
    for name, kv in (("dist_sync", "dist_sync"),
                     ("nccl", mx.kv.create("nccl"))):
        got = _gluon_trainer_run(torch, kv, tb, lb)
        rows[f"trainer_{name}"] = r = {
            "losses": got[0], "device_losses": ref[0],
            "losses_bitwise": got[0] == ref[0],
            "params_bitwise": _same(torch, got[1], ref[1])}
        r["ok"] = bool(r["losses_bitwise"] and r["params_bitwise"])
        ok = ok and r["ok"]
    return {"backend": dist.backend(), "world": dist.process_count(),
            "mesh": dict(mesh.shape), **rows, "card": ctx["smi"], "ok": ok}


def _sp_case(torch, route, q, k, v, do, causal, mesh):
    """One route's output and q/k/v gradients, with the launches it made."""
    from mxnet_tpu_torch.parallel import (ring_self_attention,
                                          ulysses_self_attention)
    from mxnet_tpu_torch.parallel.ring import gather_attention

    fns = {"ring": lambda *a: ring_self_attention(mesh, *a, causal=causal),
           "ulysses": lambda *a: ulysses_self_attention(mesh, *a,
                                                        causal=causal),
           "gather": lambda *a: gather_attention(*a, causal=causal,
                                                 mesh=mesh)}
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    _wgmma16_zero()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fns[route](*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    launches = {n: counters[n].launches for n in FLASH}
    return out.detach(), grads, launches, _wgmma16_read()


def phase_sp_single(torch, ctx):
    """The three sequence-parallel attention routes called directly on a
    one-rank ``sp`` slice of the group (``make_mesh(sp=1)``) at BERT-base's
    attention shape SP_SHAPE, f32 and bf16, causal and not: outputs and
    q/k/v gradients against the plain version (``flash_attention_ref`` and
    autograd) within the flash phase's tolerances (f32: 2e-5 on the
    output, 1e-4 on the gradients; 16-bit: ``ulp_ratio`` <= 1, the
    ``wgmma16`` design's 0.5).  This runs the routes' code and the kernels
    on the card, not the exchanges: a slice of one exchanges nothing.
    Ulysses and the gather run K3-K5 (one launch each a call); the ring's
    per-block products are plain torch, as the JAX ring's are ``jnp``, so
    it launches none.  The ring's one-block forward is timed beside K3 on
    the same block."""
    from mxnet_tpu_torch.ops.kernels import (flash_attention_fwd,
                                             flash_attention_ref)
    from mxnet_tpu_torch.ops.kernels.flash_attention import _design
    from mxnet_tpu_torch.parallel import make_mesh, ring_self_attention

    _one_rank_group()
    mesh = make_mesh(sp=1)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    N, L, D = SP_SHAPE
    tol = {"out": 2e-5, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4}
    rows, ok = [], True
    total = {n: 0 for n in FLASH}
    total16 = {n: 0 for n in WGMMA16_KERNELS}
    for dtype in ("float32", "bfloat16"):
        base = _flash_inputs(torch, g, N, L, L, D)
        q, k, v, do = (t.to(getattr(torch, dtype)) for t in base)
        eps = EPS16.get(dtype)
        gate = (ULP_WGMMA16 if eps and _design(q.dtype, D) == "wgmma16"
                else 1)
        for causal in (False, True):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            ref_out, _ = flash_attention_ref(*leaves, causal)
            ref = (ref_out.detach(),
                   *torch.autograd.grad(ref_out, leaves, do))
            for route in ("ring", "ulysses", "gather"):
                out, grads, launches, w16 = _sp_case(
                    torch, route, q, k, v, do, causal, mesh)
                got = dict(zip(("out", "dq", "dk", "dv"), (out, *grads)))
                want = dict(zip(("out", "dq", "dk", "dv"), ref))
                if eps:
                    # the ring rounds once from f32 (gate 1); the kernel
                    # routes take the design's gate
                    g_route = 1 if route == "ring" else gate
                    err = {key: ulp_ratio(got[key], want[key], eps)
                           for key in got}
                    good = all(e <= g_route for e in err.values())
                else:
                    err = {key: float((got[key].float()
                                       - want[key].float()).abs().max())
                           for key in got}
                    good = all(err[key] <= tol[key] for key in err)
                expect = {n: 0 if route == "ring" else 1 for n in FLASH}
                expect16 = {n: expect[n] if eps else 0
                            for n in WGMMA16_KERNELS}
                row = {"route": route, "dtype": dtype, "causal": causal,
                       "errors" if not eps else "ulp_ratio": err,
                       "launches": launches, "launches_wgmma16": w16,
                       "ok": bool(good and launches == expect
                                  and w16 == expect16)}
                rows.append(row)
                ok = ok and row["ok"]
                for n in FLASH:
                    total[n] += launches[n]
                    total16[n] += w16[n]
    ctx["launches"]["sp_single"] = {n: total.get(n, 0) for n in ALL_KERNELS}
    ctx.setdefault("launches_wgmma16", {})["sp_single"] = total16
    # the ring's per-block product against K3 on the same block (f32)
    q, k, v, _ = _flash_inputs(torch, g, N, L, L, D)
    ring_ms = time_ms(torch, lambda: ring_self_attention(mesh, q, k, v))
    k3_ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v))
    return {"shape": SP_SHAPE, "mesh": dict(mesh.shape), "rows": rows,
            "launches": ctx["launches"]["sp_single"],
            "ring_block_fwd_ms": ring_ms, "k3_fwd_ms": k3_ms,
            "card": ctx["smi"], "ok": ok}


# ---------------------------------------------------------------------------
# multi-GPU part 2 on one card: the pipelined BERT and the tp / pp paths
# ---------------------------------------------------------------------------
PP_STEPS = 3
PP_SINGLE_MICRO = 4
# one stacked layer, kernel route vs plain route (f32: of each tensor's
# max |plain|; bf16: the kernel route's distance from the f32 plain route
# as a multiple of the bf16 plain route's, as the bf16 training checks
# bound a bf16 step by its own spread; see _route_errors)
PP_LAYER_TOL = {"float32": 1e-4, "bfloat16": 2.0}
# against the plain step from the same weights (multigpu_smoke's f32 gates)
PP_SINGLE_TOL = {"loss_rel": 1e-5, "param_of_max": 1e-5}


def _bert_pp(torch, dtype):
    from mxnet_tpu_torch.gluon.block import cast
    from mxnet_tpu_torch.models.bert_pp import BERTForMLMPipelined

    model = BERTForMLMPipelined(BERT_VOCAB, dropout=0.0,
                                generator=torch.Generator().manual_seed(SEED))
    return cast(model, "bfloat16") if dtype == "bfloat16" else model


def _counted_run(torch, step, tokens, labels, steps, scope=None):
    """``steps`` steps with the counters zeroed just before and read just
    after -> (losses, step ms, launches, wgmma16 launches)."""
    import contextlib

    counters = _counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    _wgmma16_zero()
    losses, ms = [], []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        with scope() if scope is not None else contextlib.nullcontext():
            handle = step.step(tokens, labels)
        b.record()
        losses.append(handle)
        ms.append((a, b))
    torch.cuda.synchronize()
    return ([float(h) for h in losses], [a.elapsed_time(b) for a, b in ms],
            {n: fn.launches for n, fn in counters.items()}, _wgmma16_read())


def _layer_routes(torch, enc, x):
    """Layer 0 of the stack on ``x``: the kernels' route (K1, K3-K5) and
    the plain one (``layer_norm_ref``, ``flash_attention_ref``) -> their
    outputs and the gradients of x and of the layer's tensors, a dict
    each."""
    from mxnet_tpu_torch.ops.kernels import flash_attention_ref, layer_norm_ref

    def plain_ln(y, gamma, beta):
        u = y.shape[-1]
        return layer_norm_ref(y.reshape(-1, u), gamma, beta,
                              1e-5)[0].reshape(y.shape)

    def plain_attention(q, k, v):
        return flash_attention_ref(q, k, v, False)[0]

    g = torch.Generator(device=x.device).manual_seed(SEED + 7)
    cot = torch.randn(x.shape, generator=g, device=x.device).to(x.dtype)
    out = {}
    for route, kw in (("kernel", {}), ("plain", {"ln": plain_ln,
                                               "attention": plain_attention})):
        p = {k: v[0].detach().clone().requires_grad_()
             for k, v in enc.stacked().items()}
        xi = x.detach().clone().requires_grad_()
        y = enc._layer(p, xi, **kw)
        y.backward(cot)
        out[route] = {"out": y.detach(), "dx": xi.grad,
                      **{f"d{k}": v.grad for k, v in p.items()}}
    return out


def _route_errors(routes, tol, ref=None):
    """Each tensor's kernel-route error: f32, max |kernel - plain| within
    ``tol`` of max |plain|; bf16 (``ref`` the f32 plain route), the kernel
    route's max distance from ``ref`` within ``tol`` times the bf16 plain
    route's plus one bf16 epsilon of max |ref|."""
    k, p = routes["kernel"], routes["plain"]
    out = {}
    for n in k:
        if ref is None:
            err = float((k[n].float() - p[n].float()).abs().max())
            allow = tol * max(float(p[n].float().abs().max()), 1e-30)
            out[n] = {"err": err, "allow": allow}
        else:
            err = float((k[n].float() - ref[n]).abs().max())
            plain = float((p[n].float() - ref[n]).abs().max())
            allow = (tol * plain
                     + EPS16["bfloat16"] * float(ref[n].abs().max()))
            out[n] = {"err": err, "plain_err": plain, "allow": allow}
        out[n]["ok"] = bool(out[n]["err"] <= out[n]["allow"])
    return out


def phase_train_bert_pp(torch, ctx):
    """``BERTForMLMPipelined()`` at BERT-base's widths (12 x 768, vocab
    30,522, dropout 0) from seeded weights trains PP_STEPS Adam steps at
    lr 1e-4 on train's 32 x 512 batch off the pp mesh (the stack's loop),
    f32 then bf16: finite falling losses, K1 26 and K3-K5 12 a step (all
    ``wgmma16`` in bf16).  Layer 0 of the stack on a (32, 512, 768) input
    runs the kernels' route and the plain one (``layer_norm_ref``,
    ``flash_attention_ref``) on the card: output, input and parameter
    gradients within PP_LAYER_TOL."""
    from mxnet_tpu_torch.parallel import DataParallelStep

    tokens, labels = ctx["train_batch"]
    rows, ok = {}, True
    layer_ref = None
    for dtype in ("float32", "bfloat16"):
        model = _bert_pp(torch, dtype)
        # the layer check first, on the seeded weights (bf16: the f32
        # ones rounded), so the f32 plain route is the same function
        dev = tokens.device
        g = torch.Generator(device=dev).manual_seed(SEED + 6)
        x = torch.randn((TRAIN_BATCH, TRAIN_LEN, model.encoder._units),
                        generator=g, device=dev).to(getattr(torch, dtype))
        routes = _layer_routes(torch, model.encoder, x)
        if dtype == "float32":
            layer_ref = {n: t.float() for n, t in routes["plain"].items()}
        err = _route_errors(routes, PP_LAYER_TOL[dtype],
                            None if dtype == "float32" else layer_ref)
        del routes, x
        step = DataParallelStep(model, _mlm_loss(torch), optimizer="adam",
                                optimizer_params={"learning_rate": 1e-4})
        losses, ms, launches, w16 = _counted_run(torch, step, tokens, labels,
                                                 PP_STEPS)
        # embed_ln + 2 a layer + mlm_ln, an attention a layer: BERT-base's
        want = {n: k * PP_STEPS for n, k in TRAIN_PER_STEP.items()}
        want16 = {n: want[n] if dtype == "bfloat16" else 0
                  for n in WGMMA16_KERNELS}
        path = f"train_bert_pp_{dtype}"
        ctx["launches"][path] = launches
        if dtype == "bfloat16":
            ctx.setdefault("launches_wgmma16", {})[path] = w16
        row = {"losses": losses, "step_ms": ms,
               "step_ms_median": statistics.median(ms),
               "tokens_per_s": TRAIN_BATCH * TRAIN_LEN
               / (statistics.median(ms) * 1e-3),
               "launches": launches, "launches_expected": want,
               "launches_wgmma16": w16,
               "layer_route": err}
        row["ok"] = bool(all(math.isfinite(v) for v in losses)
                         and losses[-1] < losses[0] and launches == want
                         and w16 == want16
                         and all(e["ok"] for e in err.values()))
        rows[dtype] = row
        ok = ok and row["ok"]
        del step, model
        torch.cuda.empty_cache()
    return {"model": "BERTForMLMPipelined", "batch": TRAIN_BATCH,
            "seq_len": TRAIN_LEN, **rows, "card": ctx["smi"], "ok": ok}


def _pp_single_run(torch, make, rules, mesh, tokens, labels, scope=None):
    from mxnet_tpu_torch.parallel import DataParallelStep

    model = make()
    step = DataParallelStep(model, _mlm_loss(torch), optimizer="adam",
                            optimizer_params={"learning_rate": 1e-4},
                            mesh=mesh, rules=rules)
    losses, ms, launches, w16 = _counted_run(torch, step, tokens, labels,
                                             PP_STEPS, scope)
    shards = len(step._shards)
    state = step.state_dict() if mesh is not None else None
    params = [p.detach().clone() for p in model.parameters()]
    del step, model
    torch.cuda.empty_cache()
    return losses, params, launches, shards, state


def phase_tp_pp_single(torch, ctx):
    """The tensor- and pipeline-parallel code paths at size one on the one
    card: a one-rank NCCL group and ``make_mesh()`` (tp 1, pp 1).  BERT-base
    with ``bert_sharding_rules`` (every matched parameter sliced to its
    one-rank shard, the layers' tp branches and collectives, the vocab-
    parallel embedding and the gathered decoder) and
    ``BERTForMLMPipelined`` with ``bert_pp_sharding_rules`` under a
    ``pipeline_parallel_scope`` of PP_SINGLE_MICRO microbatches (the GPipe
    schedule at pp 1), PP_STEPS f32 Adam steps each at 32 x 512, held
    against the plain step (no mesh) from the same weights within
    PP_SINGLE_TOL (the tp path's bit-equality is recorded too).  Launches
    a step: K1 26 and K3-K5 12 on the tp path; K1 2 + 24 x 4 and K3-K5
    12 x 4 on the pp path.  The gathered ``state_dict()`` holds every
    array whole."""
    import functools

    from mxnet_tpu_torch.models.bert import bert_base, bert_sharding_rules
    from mxnet_tpu_torch.models.bert_pp import bert_pp_sharding_rules
    from mxnet_tpu_torch.parallel import make_mesh
    from mxnet_tpu_torch.parallel.scope import pipeline_parallel_scope

    _one_rank_group()
    mesh = make_mesh()
    tokens, labels = ctx["train_batch"]
    M = PP_SINGLE_MICRO
    cases = {
        "tp": (lambda: bert_base(BERT_VOCAB, dropout=0.0,
                                 generator=torch.Generator().manual_seed(
                                     SEED)),
               bert_sharding_rules(), None,
               {n: k * PP_STEPS for n, k in TRAIN_PER_STEP.items()}),
        "pp": (functools.partial(_bert_pp, torch, "float32"),
               bert_pp_sharding_rules(),
               lambda: pipeline_parallel_scope(mesh, (), M),
               {**{n: 0 for n in ALL_KERNELS},
                "layer_norm": (2 + 24 * M) * PP_STEPS,
                **{n: 12 * M * PP_STEPS for n in FLASH}}),
    }
    rows, ok = {}, True
    for name, (make, rules, scope, want) in cases.items():
        plain = _pp_single_run(torch, make, None, None, tokens, labels)
        got = _pp_single_run(torch, make, rules, mesh, tokens, labels, scope)
        scale = max(float(p.float().abs().max()) for p in plain[1])
        param_err = max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(got[1], plain[1])) / scale
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got[0], plain[0]))
        whole = sorted(tuple(np.shape(v)) for v in
                       got[4]["params"].values()) == sorted(
                           tuple(p.shape) for p in plain[1])
        path = f"tp_pp_single_{name}"
        ctx["launches"][path] = got[2]
        row = {"losses": got[0], "plain_losses": plain[0],
               "loss_rel_err": loss_rel, "param_err_of_max": param_err,
               "bitwise": got[0] == plain[0] and param_err == 0.0,
               "sharded_params": got[3], "state_whole": whole,
               "launches": got[2], "launches_expected": want}
        row["ok"] = bool(loss_rel <= PP_SINGLE_TOL["loss_rel"]
                         and param_err <= PP_SINGLE_TOL["param_of_max"]
                         and got[3] > 0 and whole and got[2] == want)
        rows[name] = row
        ok = ok and row["ok"]
        del plain, got
    return {"mesh": dict(mesh.shape), "microbatches": M, **rows,
            "card": ctx["smi"], "ok": ok}


ELASTIC_STEPS = 4  # the uninterrupted run; the other saves at half
ELASTIC_RESNET_BATCH = 32
ELASTIC_RESNET_STEPS = 2
# sync_batch_norm over the one-rank group against the local BatchNorm on
# the stem's BatchNorm input: of the reference's max |value|
ELASTIC_SYNCBN_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _elastic_bert(torch, mesh):
    from mxnet_tpu_torch.models.bert import bert_base
    from mxnet_tpu_torch.parallel import DataParallelStep

    model = bert_base(BERT_VOCAB, dropout=0.0,
                      generator=torch.Generator().manual_seed(SEED))
    return DataParallelStep(model, _mlm_loss(torch), optimizer="adam",
                            optimizer_params={"learning_rate": 1e-4},
                            mesh=mesh)


def _elastic_resnet(torch, mesh, x, y):
    """resnet50_v1b NCHW f32 from the seed, ELASTIC_RESNET_STEPS SGD
    steps (over ``mesh`` when given) -> (losses, parameters and float
    buffers)."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models.resnet import resnet50_v1b
    from mxnet_tpu_torch.parallel import DataParallelStep

    model = resnet50_v1b(layout="NCHW",
                         generator=torch.Generator().manual_seed(SEED))
    step = DataParallelStep(model, SoftmaxCrossEntropyLoss(),
                            optimizer="sgd", optimizer_params=RESNET_SGD,
                            mesh=mesh)
    losses = [float(step.step(x, y)) for _ in range(ELASTIC_RESNET_STEPS)]
    state = [t.detach().clone() for t in model.state_dict().values()]
    del step, model
    torch.cuda.empty_cache()
    return losses, state


def _syncbn_function_check(torch, mesh):
    """``sync_batch_norm`` over the one-rank group (its all-gather and
    all-reduce on the card) against the local BatchNorm (torch's fused
    one) on a seeded (ELASTIC_RESNET_BATCH, 64, 112, 112) input, the
    stem's BatchNorm input, f32 NCHW and bf16 NHWC: output and the
    gradients of the input, gamma and beta, each of the reference's max
    |value| (ELASTIC_SYNCBN_TOL)."""
    from mxnet_tpu_torch.ops import nn as ops_nn
    from mxnet_tpu_torch.parallel.sync_batch_norm import sync_batch_norm

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    shape = (ELASTIC_RESNET_BATCH, 64, 112, 112)
    x0 = torch.randn(shape, generator=g, device=dev) * 2 + 0.5
    dy0 = torch.randn(shape, generator=g, device=dev)
    w0 = torch.rand(64, generator=g, device=dev) + 0.5
    b0 = torch.randn(64, generator=g, device=dev)
    red = (mesh.group(("dp", "sp")), 1)
    rows, ok = {}, True
    for dtype, axis in (("float32", 1), ("bfloat16", 3)):
        dt = getattr(torch, dtype)
        x = x0 if axis == 1 else x0.permute(0, 2, 3, 1).contiguous()
        dy = dy0 if axis == 1 else dy0.permute(0, 2, 3, 1).contiguous()
        errs = {}
        outs = []
        for fn in ("sync", "local"):
            leaves = [x.to(dt).detach().clone().requires_grad_(),
                      w0.clone().requires_grad_(),
                      b0.clone().requires_grad_()]
            if fn == "sync":
                out = sync_batch_norm(*leaves, 1e-5, axis, red)[0]
            else:
                out = ops_nn.batch_norm(
                    leaves[0], leaves[1], leaves[2], torch.zeros_like(w0),
                    torch.ones_like(w0), eps=1e-5, fix_gamma=False,
                    axis=axis, training=True)
            out.backward(dy.to(dt))
            outs.append([out.detach().float()]
                        + [t.grad.float() for t in leaves])
        for name, a, b in zip(("out", "dx", "dgamma", "dbeta"), *outs):
            errs[name] = float((a - b).abs().max()) / float(b.abs().max())
        tol = ELASTIC_SYNCBN_TOL[dtype]
        rows[dtype] = {"err_of_max": errs, "tol": tol,
                       "ok": all(e <= tol for e in errs.values())}
        ok = ok and rows[dtype]["ok"]
        del outs
    torch.cuda.synchronize()
    return rows, ok


def phase_elastic_single(torch, ctx):
    """The elastic path on the one card, over the one-rank NCCL group of
    ``dist_single`` and ``make_mesh()``.  BERT-base at 32 x 512 from
    train's weights and batch: ELASTIC_STEPS f32 Adam steps uninterrupted,
    against half of them, a format-2 save (``AsyncCheckpointer(sharded=
    True)``, the step's ``shard_state_dict``: no collective), a restore
    into a fresh step (``checkpoint.restore``, the lazy arrays read block
    by block) and the other half: losses and parameters equal bit for
    bit; launches over the interrupted run's steps K1 26 and K3-K5 12 a
    step.  Then resnet50_v1b NCHW f32 at ELASTIC_RESNET_BATCH x 224^2
    (cuDNN deterministic, no autotuning), ELASTIC_RESNET_STEPS SGD steps
    through the meshed step (its BatchNorm path) against the plain step:
    losses, parameters and running statistics equal bit for bit; and the
    synchronized BatchNorm's autograd function over the one-rank group
    against the local BatchNorm (``_syncbn_function_check``)."""
    import shutil

    from mxnet_tpu_torch import checkpoint
    from mxnet_tpu_torch.parallel import make_mesh

    _one_rank_group()
    mesh = make_mesh()
    tokens, labels = ctx["train_batch"]
    half = ELASTIC_STEPS // 2
    ref = _elastic_bert(torch, mesh)
    ref_losses = [float(ref.step(tokens, labels))
                  for _ in range(ELASTIC_STEPS)]
    ref_params = [p.detach().clone() for p in ref.block.parameters()]
    del ref
    torch.cuda.empty_cache()
    ckdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "elastic_single")
    shutil.rmtree(ckdir, ignore_errors=True)
    counters = _counters()
    step = _elastic_bert(torch, mesh)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    _wgmma16_zero()
    ck = checkpoint.AsyncCheckpointer(ckdir, save_every=half, sharded=True)
    losses = []
    for _ in range(half):
        losses.append(float(step.step(tokens, labels)))
        ck.step(step)
    t0 = time.perf_counter()
    ck.close()
    save_s = time.perf_counter() - t0
    del step
    torch.cuda.empty_cache()
    step = _elastic_bert(torch, mesh)
    t0 = time.perf_counter()
    restored = checkpoint.restore(ckdir, step)
    restore_s = time.perf_counter() - t0
    losses += [float(step.step(tokens, labels)) for _ in range(half)]
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    w16 = _wgmma16_read()
    ctx["launches"]["elastic_single"] = launches
    params = [p.detach().clone() for p in step.block.parameters()]
    nbytes = sum(os.path.getsize(os.path.join(ckdir, f"step-{half}", f))
                 for f in os.listdir(os.path.join(ckdir, f"step-{half}")))
    del step
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    want = {n: k * ELASTIC_STEPS for n, k in TRAIN_PER_STEP.items()}
    bert = {"losses": losses, "uninterrupted_losses": ref_losses,
            "restored_step": restored,
            "losses_bitwise": losses == ref_losses,
            "params_bitwise": _same(torch, params, ref_params),
            "launches": launches, "launches_expected": want,
            "launches_wgmma16": w16, "save_s": save_s,
            "restore_s": restore_s, "checkpoint_bytes": nbytes}
    bert["ok"] = bool(bert["losses_bitwise"] and bert["params_bitwise"]
                      and restored == half and launches == want
                      and not any(w16.values()))
    del params, ref_params
    bench = torch.backends.cudnn.benchmark
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        B, R = ELASTIC_RESNET_BATCH, RESNET_RES
        rng = np.random.RandomState(SEED)
        x = torch.from_numpy(rng.rand(B, 3, R, R).astype(np.float32)).cuda()
        y = torch.from_numpy(rng.randint(0, 1000, B).astype(
            np.float32)).cuda()
        plain = _elastic_resnet(torch, None, x, y)
        meshed = _elastic_resnet(torch, mesh, x, y)
        fn_rows, fn_ok = _syncbn_function_check(torch, mesh)
    finally:
        torch.backends.cudnn.benchmark = bench
        torch.backends.cudnn.deterministic = det
    resnet = {"batch": B, "losses": meshed[0], "plain_losses": plain[0],
              "losses_bitwise": meshed[0] == plain[0],
              "state_bitwise": _same(torch, meshed[1], plain[1]),
              "sync_function": fn_rows}
    resnet["ok"] = bool(resnet["losses_bitwise"] and resnet["state_bitwise"]
                        and fn_ok)
    return {"mesh": dict(mesh.shape), "bert": bert, "resnet": resnet,
            "card": ctx["smi"], "ok": bert["ok"] and resnet["ok"]}


RESNET_BATCH, RESNET_RES = 256, 224  # bench.py:768-769
RESNET_WARMUP, RESNET_STEPS = 2, 5
RESNET_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
# gluon_resnet_amp's falling-loss gate reads the loss after this many
# steps on its one repeated batch.  bf16 at lr 0.1 overshoots at step 3
# (7.69 -> 6.88 -> 7.9..8.5 on the H100) and the timing-chosen cuDNN
# algorithms make each run's recovery differ: the loss after step 7
# ranged 6.31..6.84 over seven runs of the whole script, and an eighth
# failed the gate read there.  tools/resnet_amp_gate_probe.py repeats
# the cell in fresh processes (PERF.md §6).
RESNET_AMP_FALL_STEPS = 30
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
    ctx["train_resnet_bf16"] = {k: res[k] for k in (
        "images_per_s", "step_ms_median", "max_memory_allocated_gb")}
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


# ---------------------------------------------------------------------------
# the precision subsystem: AMP training with dynamic loss scaling, the
# contrib.amp Gluon loop (BASELINE config 2), int8 and int4 serving
# ---------------------------------------------------------------------------
# an AMP step's loss at each of its 6 steps against the f32 train phase's
# on the same batch from the same weights, relative
AMP_LOSS_REL = 2e-2
# first decode logits of a quantized adapter, card vs the same adapter on
# the CPU: max |diff| <= tol * max(1, max |logit|).  int8: an activation's
# int8 code may move by one where the card's and the CPU's f32 inputs to
# a layer round differently; int4 computes in f32 from equal dequantized
# weights, so it is held to serve_parity's 2e-3
QUANT_LOGIT_TOL = {"int8": 0.05, "int4": 2e-3}
# naive calibration: greedy translate of serve's first 8 sources
QUANT_CALIB_SOURCES, QUANT_CALIB_LEN = 8, 32


def _probe_dtypes(torch, step, batch):
    """One more step with the LayerNorm and flash-attention call sites
    wrapped: the dtypes K1 and K3 (and so K4 and K5) are given."""
    from mxnet_tpu_torch.gluon.nn import basic_layers
    from mxnet_tpu_torch.models import transformer

    seen = {"layer_norm": set(), "flash_attention": set()}
    ln_cls, fa = basic_layers.LayerNormFunction, transformer.flash_attention

    class LayerNormProbe:
        @staticmethod
        def apply(x, *args):
            seen["layer_norm"].add(str(x.dtype))
            return ln_cls.apply(x, *args)

    def flash_probe(q, k, v, **kw):
        seen["flash_attention"].update(str(t.dtype) for t in (q, k, v))
        return fa(q, k, v, **kw)

    basic_layers.LayerNormFunction = LayerNormProbe
    transformer.flash_attention = flash_probe
    try:
        step.step(*batch)
        torch.cuda.synchronize()
    finally:
        basic_layers.LayerNormFunction = ln_cls
        transformer.flash_attention = fa
    return {k: sorted(v) for k, v in seen.items()}


def _skip_step(torch, step, poison, batch):
    """One step whose loss, and so every gradient, is made infinite: the
    parameters, Adam's moments and ``t`` must hold bit for bit, the
    scale halve, ``growth`` reset and ``skipped`` count one more."""
    before = [t.clone() for t in step._held_state()]
    t0 = step._t.clone()
    sc0 = {k: v.clone() for k, v in step.scaler_state.items()}
    poison.fill_(float("inf"))
    try:
        loss = float(step.step(*batch))
    finally:
        poison.fill_(1.0)
    held = all(torch.equal(a, b) for a, b in zip(step._held_state(), before))
    sc1 = step.scaler_state
    res = {"loss": loss, "state_held_bitwise": held,
           "t_held": bool(torch.equal(step._t, t0)), "t": int(step._t),
           "scale_before": float(sc0["scale"]),
           "scale_after": float(sc1["scale"]),
           "growth_after": int(sc1["growth"]),
           "skipped_after": int(sc1["skipped"])}
    res["ok"] = bool(held and res["t_held"]
                     and res["scale_after"] == res["scale_before"] / 2
                     and res["growth_after"] == 0
                     and res["skipped_after"] == int(sc0["skipped"]) + 1)
    return res


def _sync_free(torch, step, batch, steps=2):
    """``steps`` scaled steps under ``set_sync_debug_mode("error")``: any
    host sync inside them raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handles = [step.step(*batch) for _ in range(steps)]
        err = None
    except RuntimeError as e:
        handles, err = [], f"{type(e).__name__}: {e}"[:600]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return {"steps": steps, "losses": [float(h) for h in handles],
            "error": err, "ok": err is None}


def _amp_cell(torch, ctx, dtype):
    """BERT-base at 32 x 512, Adam lr 1e-4, through DataParallelStep with
    the AMP policy in ``dtype`` (f32 masters; fp16 with the dynamic loss
    scaler), on the train phase's batch from the same seeded weights."""
    from mxnet_tpu_torch.models.bert import bert_base
    from mxnet_tpu_torch.parallel import DataParallelStep
    from mxnet_tpu_torch.precision import (AmpPolicy, LossScaleConfig,
                                           PrecisionConfig)

    torch.cuda.empty_cache()
    scaled = dtype == "float16"
    model = bert_base(BERT_VOCAB, dropout=0.0,
                      generator=torch.Generator().manual_seed(SEED))
    prec = PrecisionConfig(amp=AmpPolicy(dtype=dtype),
                           loss_scale=LossScaleConfig() if scaled else None)
    mlm = _mlm_loss(torch)
    # fp16: a factor on the loss (1.0, exact) that _skip_step makes inf
    tokens, labels = ctx["train_batch"]
    poison = torch.ones((), device=tokens.device)
    loss_fn = (lambda lo, la: mlm(lo, la) * poison) if scaled else mlm
    step = DataParallelStep(model, loss_fn, optimizer="adam",
                            optimizer_params={"learning_rate": 1e-4},
                            precision=prec)
    torch.cuda.reset_peak_memory_stats()
    first = float(step.step(tokens, labels))  # warm-up
    counters = _counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    _wgmma16_zero()
    losses, step_ms, wall = _train_steps(torch, step, tokens, labels,
                                         TRAIN_STEPS)
    launches = {n: fn.launches for n, fn in counters.items()}
    wgmma16 = _wgmma16_read()
    f32_core = _f32_core(launches, wgmma16)
    name = "train_amp" if dtype == "bfloat16" else "train_amp_fp16"
    ctx["launches"][name] = launches
    ctx.setdefault("launches_wgmma16", {})[name] = wgmma16
    expected = {n: k * TRAIN_STEPS for n, k in TRAIN_PER_STEP.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [first] + losses
    f32 = ctx["train_f32"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, f32["losses"]))
    tps = TRAIN_BATCH * TRAIN_LEN * TRAIN_STEPS / wall
    line = {
        "model": "bert_base", "policy": dtype, "batch": TRAIN_BATCH,
        "seq_len": TRAIN_LEN, "optimizer": "adam", "learning_rate": 1e-4,
        "steps": TRAIN_STEPS, "wall_s": wall, "tokens_per_s": tps,
        "step_ms_median": statistics.median(step_ms), "step_ms": step_ms,
        "max_memory_allocated_gb": peak_gb, "losses": losses,
        "f32_losses": f32["losses"], "loss_rel_vs_f32_max": rel,
        "loss_rel_tol": AMP_LOSS_REL,
        "train": {k: v for k, v in f32.items() if k != "losses"},
        "train_bf16": ctx.get("train_bf16"),
        "tokens_per_s_over_train": tps / f32["tokens_per_s"],
        "launches": launches, "launches_expected": expected,
        "launches_wgmma16": wgmma16, "launches_f32_core": f32_core}
    if scaled:
        line["scaler_after_steps"] = {
            k: float(v) for k, v in step.scaler_state.items()}
        line["sync_debug_error_steps"] = _sync_free(torch, step,
                                                    (tokens, labels))
        line["skip_step"] = _skip_step(torch, step, poison,
                                       (tokens, labels))
    dtypes = _probe_dtypes(torch, step, (tokens, labels))
    masters = sorted({str(p.dtype) for p in model.parameters()})
    line.update(kernel_input_dtypes=dtypes, parameter_dtypes=masters,
                card=ctx["smi"])
    del step, model
    torch.cuda.empty_cache()
    line["ok"] = bool(
        all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
        and launches == expected and rel <= AMP_LOSS_REL
        and wgmma16 == {n: expected[n] for n in wgmma16}
        and not any(f32_core.values())
        and dtypes == {"layer_norm": ["torch.float32"],
                       "flash_attention": [f"torch.{dtype}"]}
        and masters == ["torch.float32"]
        and (not scaled or (line["skip_step"]["ok"]
                            and line["sync_debug_error_steps"]["ok"])))
    return line


def phase_train_amp(torch, ctx):
    return _amp_cell(torch, ctx, "bfloat16")


def phase_train_amp_fp16(torch, ctx):
    return _amp_cell(torch, ctx, "float16")


def phase_gluon_resnet_amp(torch, ctx):
    """BASELINE config 2 as MXNet scripts run it: resnet50_v1b (NHWC),
    ``hybridize()``, ``amp.init("bfloat16")``, ``convert_hybrid_block``,
    ``gluon.Trainer`` SGD (bench.py's momentum 0.9, lr 0.1, wd 1e-4) with
    ``init_trainer``'s f32 masters, ``scale_loss``; batch 256 at 224^2, 2
    warm-up and 5 timed steps, then untimed steps up to
    RESNET_AMP_FALL_STEPS for the falling-loss gate.  No kernel of ours
    is on this path."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.models.resnet import resnet50_v1b
    from mxnet_tpu_torch.ndarray.ndarray import NDArray

    torch.backends.cudnn.benchmark = True
    torch.cuda.empty_cache()
    dev = mx.gpu(0)
    amp.init(target_dtype="bfloat16")
    net = resnet50_v1b(layout="NHWC",
                       generator=torch.Generator().manual_seed(SEED))
    net.hybridize()
    amp.convert_hybrid_block(net)
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(RESNET_SGD))
    amp.init_trainer(trainer)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    B, R = RESNET_BATCH, RESNET_RES
    rng = np.random.RandomState(SEED)
    x = NDArray(torch.from_numpy(rng.rand(B, R, R, 3).astype(
        np.float32)).cuda().bfloat16(), ctx=dev)
    y = NDArray(torch.from_numpy(rng.randint(0, 1000, B).astype(
        np.float32)).cuda(), ctx=dev)

    def step():
        with autograd.record():
            loss = loss_fn(net(x), y)
        with amp.scale_loss(loss, trainer) as scaled:
            scaled.backward()
        trainer.step(B)
        return loss.mean()

    torch.cuda.reset_peak_memory_stats()
    losses = [float(step().asscalar()) for _ in range(RESNET_WARMUP)]
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(RESNET_STEPS)]
    handles = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for start, end in marks:
        start.record()
        handles.append(step())
        end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    handles += [step() for _ in range(RESNET_AMP_FALL_STEPS - RESNET_WARMUP
                                      - RESNET_STEPS)]
    launches = {n: fn.launches for n, fn in counters.items()}
    losses += [float(h.asscalar()) for h in handles]
    ips = B * RESNET_STEPS / wall
    ref = ctx.get("train_resnet_bf16", {})
    weights = sorted({str(p.dtype) for p in net.parameters()})
    masters = sorted({str(st[0]._data.dtype)
                      for st in trainer._updaters[0].states.values()})
    peak = torch.cuda.max_memory_allocated() / 1e9
    del net, trainer, x, y
    torch.cuda.empty_cache()
    return {
        "model": "resnet50_v1b", "layout": "NHWC", "amp": "bfloat16",
        "hybridized": True, "batch": B, "resolution": R, "optimizer": "sgd",
        **RESNET_SGD, "warmup_steps": RESNET_WARMUP, "steps": RESNET_STEPS,
        "fall_steps": RESNET_AMP_FALL_STEPS,
        "wall_s": wall, "images_per_s": ips,
        "step_ms_median": statistics.median(
            a.elapsed_time(b) for a, b in marks),
        "max_memory_allocated_gb": peak, "losses": losses,
        "train_resnet_bf16": ref,
        "images_per_s_over_train_resnet_bf16":
            ips / ref["images_per_s"] if ref else None,
        "weight_dtypes": weights, "master_dtypes": masters,
        "launches": launches, "cudnn": _cudnn_settings(torch),
        "card": ctx["smi"],
        "ok": bool(all(math.isfinite(v) for v in losses)
                   and losses[-1] < losses[0]
                   and weights == ["torch.bfloat16"]
                   and masters == ["torch.float32"]
                   and all(v == 0 for v in launches.values()))}


def _quant_cpu_model(torch, ctx):
    """A CPU copy of serve's Transformer-big, made once for both
    quantized phases."""
    from mxnet_tpu_torch.models.transformer import transformer_big

    cpu = ctx.get("quant_cpu_model")
    if cpu is None:
        cpu = transformer_big(32000, dropout=0.0, max_length=1024,
                              device="cpu").eval()
        cpu.load_state_dict({k: v.cpu() for k, v in
                             ctx["model"].state_dict().items()})
        ctx["quant_cpu_model"] = cpu
    return cpu


def _quant_logits(torch, ctx, qad, cpu_qad):
    """The first 4 decode logits of one source through ``qad`` on the
    card and ``cpu_qad`` on the CPU (teacher-forced with the card's
    tokens): max |diff| and max |logit|."""
    rng = np.random.RandomState(SEED + 2)
    src = np.zeros((1, 64), np.int32)
    src[0, :40] = rng.randint(3, 32000, 40)
    model = ctx["model"]
    with qad._pass.scope():
        _, lg_g, toks = _first_logits(torch, model, src, 4,
                                      next(model.parameters()).device)
    with cpu_qad._pass.scope():
        _, lg_c, _ = _first_logits(torch, cpu_qad.model, src, 4,
                                   torch.device("cpu"), feed=toks)
    return {"max_abs_diff_logits": float((lg_g - lg_c).abs().max()),
            "logit_abs_max": float(lg_c.abs().max()),
            "finite": bool(torch.isfinite(lg_g).all())}


def _agreement(toks, ref):
    """Top-1 agreement of two engines' token streams, position by
    position, over the longer stream of each request."""
    agree = total = 0
    for a, b in zip(toks, ref):
        agree += sum(1 for x, y in zip(a, b) if x == y)
        total += max(len(a), len(b))
    return agree / total


def _quant_serve(torch, ctx, name, qad, cpu_qad, build_s):
    """``serve``'s engine and traffic through the quantized adapter:
    counted (K1 and K2 by serve's formulas), then f32 and quantized in
    turns (A B B A) for tokens/s, the logits gate, bytes and census."""
    from mxnet_tpu_torch import memwatch
    from mxnet_tpu_torch.serving import ServingEngine

    vocab, kw = 32000, ctx["engine_kw"]
    ServingEngine(qad, **kw).serve(_requests(2, vocab, SEED + 1)[0])
    eng = ServingEngine(qad, **kw)
    reqs, arrivals = _requests(16, vocab, SEED)
    toks, line = _serve_run(torch, eng, reqs, arrivals)
    ctx["launches"][name] = line["launches"]
    f32_eng = ServingEngine(ctx["adapter"], **kw)
    turns = []
    for tag, e in (("fp32", f32_eng), (name, eng), (name, eng),
                   ("fp32", f32_eng)):
        rq, arr = _requests(16, vocab, SEED)
        out, _launches, wall = _counted(
            torch, lambda: e.serve(rq, arrival_steps=arr))
        turns.append({"engine": tag, "tokens_per_s": sum(
            len(out[r.id]) for r in rq) / wall})
    mean = {t: statistics.mean(x["tokens_per_s"] for x in turns
                               if x["engine"] == t) for t in ("fp32", name)}
    census = memwatch.census()["categories"].get("quantized")
    parity = _quant_logits(torch, ctx, qad, cpu_qad)
    tol = QUANT_LOGIT_TOL[qad.precision]
    parity.update(tol=tol, ok=bool(
        parity["finite"] and parity["max_abs_diff_logits"]
        <= tol * max(1.0, parity["logit_abs_max"])))
    statusz = line["statusz"]["precision"]
    lengths_ok = all(1 <= len(t) <= r.max_new_tokens
                     for r, t in zip(reqs, toks))
    return {
        "model": "transformer_big", "vocab": vocab, "engine": kw,
        "adapter_build_s": build_s, "requests": len(reqs), **line,
        "turns": turns, "tokens_per_s_mean": mean,
        "tokens_per_s_over_fp32": mean[name] / mean["fp32"],
        "top1_agreement_with_fp32_serve": _agreement(
            toks, ctx["serve_tokens"]),
        "quantized_layers": len(qad._entries),
        "quantized_param_bytes": qad.quantized_param_bytes(),
        "fp32_param_bytes": qad.fp32_param_bytes(),
        "param_bytes_ratio": qad.quantized_param_bytes()
        / qad.fp32_param_bytes(),
        "quantized_weight_bytes": qad.quantized_weight_bytes(),
        "fp32_weight_bytes": qad.fp32_weight_bytes(),
        "weight_bytes_ratio": qad.quantized_weight_bytes()
        / qad.fp32_weight_bytes(),
        "census_quantized": census, "logits_card_vs_cpu": parity,
        "card": ctx["smi"],
        "ok": bool(line["finished"] and line["pages_back"]
                   and line["launches_ok"] and lengths_ok
                   and statusz == qad.precision and parity["ok"]
                   and census is not None)}


def phase_serve_int8(torch, ctx):
    """Transformer-big served int8: ``quantize_adapter`` with naive
    calibration over greedy ``translate`` of serve's first 8 sources."""
    from mxnet_tpu_torch.precision import QuantizedAdapter, quantize_adapter
    from mxnet_tpu_torch.serving import TransformerAdapter

    model = ctx["model"]
    reqs, _ = _requests(16, 32000, SEED)
    batches = [r.tokens[None].astype(np.int32)
               for r in reqs[:QUANT_CALIB_SOURCES]]

    def calib_fn(batch):
        model.translate(torch.from_numpy(batch).cuda(), bos_id=1, eos_id=2,
                        max_len=QUANT_CALIB_LEN, beam_size=1)

    t0 = time.perf_counter()
    qad = quantize_adapter(ctx["adapter"], batches, calib_fn,
                           calib_mode="naive")
    build_s = time.perf_counter() - t0
    cpu_qad = QuantizedAdapter(
        TransformerAdapter(_quant_cpu_model(torch, ctx), src_max_len=64),
        {p: t.act_thresh for p, t in qad._by_path.items()})
    res = _quant_serve(torch, ctx, "serve_int8", qad, cpu_qad, build_s)
    res["calibration"] = {"mode": "naive", "sources": QUANT_CALIB_SOURCES,
                          "translate_max_len": QUANT_CALIB_LEN}
    return res


def phase_serve_int4(torch, ctx):
    """Transformer-big served with weight-only int4 (groups of 32)."""
    from mxnet_tpu_torch.precision import int4_adapter
    from mxnet_tpu_torch.serving import TransformerAdapter

    t0 = time.perf_counter()
    qad = int4_adapter(ctx["adapter"], group_size=32)
    build_s = time.perf_counter() - t0
    cpu_qad = int4_adapter(TransformerAdapter(_quant_cpu_model(torch, ctx),
                                              src_max_len=64),
                           group_size=32)
    ctx.pop("quant_cpu_model")
    res = _quant_serve(torch, ctx, "serve_int4", qad, cpu_qad, build_s)
    res["group_size"] = 32
    return res


# name, source, the TPU kernel it replaces, the paths whose launches the
# kernels line reports (summed).  K3, K4 and K5 have a row for each
# design: the f32 core of flash_attention.cu (the wrapper's launches less
# the wgmma16 ones) on the f32 paths, and the 16-bit wgmma16 of
# flash_attention_16.cu (its own counts) on the 16-bit paths
F32_FLASH_PATHS = ("train", "gluon_bert", "module_bert", "train_resume",
                   "profile_bert", "graph_spellings", "test_utils_card",
                   "onnx_roundtrip", "dist_single_float32", "sp_single",
                   "train_bert_pp_float32", "tp_pp_single_tp",
                   "tp_pp_single_pp", "elastic_single")
BF16_FLASH_PATHS = ("train_bf16", "train_amp", "train_amp_fp16",
                    "train_bert_dense_predict", "test_utils_card",
                    "dist_single_bfloat16", "sp_single",
                    "train_bert_pp_bfloat16")
KERNELS = (
    ("layer_norm", "mxnet_tpu_torch/csrc/layer_norm.cu",
     "mxnet_tpu/ops/pallas/fused.py:98",
     ("serve", "serve_sampling", "serve_spec", "serve_prefix", "serve_beam",
      "serve_fleet", "serve_int8", "serve_int4", "train_transformer",
      "train_transformer_bf16", "gluon_bert", "train_amp",
      "train_amp_fp16", "module_bert", "train_resume", "serve_fullprefix",
      "profile_bert", "train_bert_dense", "train_bert_dense_predict",
      "graph_spellings", "test_utils_card", "onnx_roundtrip", "examples",
      "dist_single_float32", "dist_single_bfloat16",
      "train_bert_pp_float32", "train_bert_pp_bfloat16", "tp_pp_single_tp",
      "tp_pp_single_pp", "elastic_single")),
    ("paged_decode_attention", "mxnet_tpu_torch/csrc/paged_attention.cu",
     "mxnet_tpu/ops/pallas/paged_attention.py:38",
     ("serve", "serve_sampling", "serve_spec", "serve_prefix",
      "serve_beam", "serve_fleet", "serve_int8", "serve_int4")),
    ("flash_attention_fwd", "mxnet_tpu_torch/csrc/flash_attention.cu",
     "mxnet_tpu/ops/pallas/flash_attention.py:72", F32_FLASH_PATHS),
    ("flash_attention_dq", "mxnet_tpu_torch/csrc/flash_attention.cu",
     "mxnet_tpu/ops/pallas/flash_attention.py:131", F32_FLASH_PATHS),
    ("flash_attention_dkv", "mxnet_tpu_torch/csrc/flash_attention.cu",
     "mxnet_tpu/ops/pallas/flash_attention.py:158", F32_FLASH_PATHS),
    ("flash_attention_fwd_wgmma16",
     "mxnet_tpu_torch/csrc/flash_attention_16.cu",
     "mxnet_tpu/ops/pallas/flash_attention.py:72", BF16_FLASH_PATHS),
    ("flash_attention_dq_wgmma16",
     "mxnet_tpu_torch/csrc/flash_attention_16.cu",
     "mxnet_tpu/ops/pallas/flash_attention.py:131", BF16_FLASH_PATHS),
    ("flash_attention_dkv_wgmma16",
     "mxnet_tpu_torch/csrc/flash_attention_16.cu",
     "mxnet_tpu/ops/pallas/flash_attention.py:158", BF16_FLASH_PATHS),
    ("add_layer_norm", "mxnet_tpu_torch/csrc/layer_norm.cu",
     "mxnet_tpu/ops/pallas/fused.py:166", ("imperative", "test_utils_card")),
    ("softmax_cross_entropy", "mxnet_tpu_torch/csrc/softmax_cross_entropy.cu",
     "mxnet_tpu/ops/pallas/fused.py:36",
     ("softmax_cross_entropy", "test_utils_card")),
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
    # profile_bert profiles this loop's step, unhybridized and hybridized
    ctx["gluon_bert_loop"] = (net, step)
    ctx["gluon_bert_f32"] = {"tokens_per_s": tokens_per_s,
                             "step_ms_median": statistics.median(step_ms),
                             "max_memory_allocated_gb": peak}
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


# ---------------------------------------------------------------------------
# BASELINE config 5: SSD-512 and Faster-RCNN on a RecordIO pipeline
# ---------------------------------------------------------------------------
DET_RES, DET_CLASSES = 512, 80
SSD_BATCH, FRCNN_BATCH = 32, 8
DET_WARMUP, DET_STEPS, DET_LR = 2, 10, 1e-3
DET_REC_IMAGES, DET_MAX_BOXES = 256, 8
DET_ITER_BATCHES, DET_DETECT_CALLS = 3, 5
DET_PARITY_BATCH = 2
# card vs CPU, one training step from the same weights on the same batch:
# the head outputs of their max abs and the loss relative, card vs the
# f32 CPU; the gradients, relative L2 over the model and in the worst
# tensor, card vs the CPU in float64 (the yardstick), within the larger
# of these and DET_PARITY_SPREAD times the f32 CPU's own distance from
# float64; the targets (MultiBoxTarget's cls_target and loc_mask)
# exactly equal.  The gradient bounds are set by the card's f32
# BatchNorm backward: a gamma's gradient sums 2 x 512^2 terms that nearly
# cancel, in f32 on the card, and the error reaches every layer below.
# On an H100 80GB HBM3 at 700 W, Faster-RCNN's body gradients sat
# 4.5e-3 to 6.5e-3 from float64 (the CPU's 2.5e-4 to 4e-4), 1.30e-3 over
# the model, the same with cuDNN off
DET_PARITY_TOL = {"out_of_max_abs": 1e-4, "loss_rel": 1e-4,
                  "grad_rel_model": 5e-3, "grad_rel_tensor": 2e-2}
DET_PARITY_SPREAD = 2.0
# MultiBoxDetection card vs CPU: kept rows and class ids exact, scores
# exact (they are selected, not computed), boxes within 1e-5 (decoded)
DET_BOX_ATOL = 1e-5


def _det_build_dir():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(path, exist_ok=True)
    return path


def _det_objects(rng, pixels=False):
    """1..DET_MAX_BOXES seeded boxes over DET_CLASSES: rows [cls, x0, y0,
    x1, y1], normalized, or in pixels of a DET_RES image."""
    objs = []
    for _ in range(rng.randint(1, DET_MAX_BOXES + 1)):
        x0, y0 = rng.uniform(0.0, 0.75, 2)
        bw, bh = rng.uniform(0.08, 0.4, 2)
        objs.append([rng.randint(DET_CLASSES), x0, y0, min(x0 + bw, 1.0),
                     min(y0 + bh, 1.0)])
    objs = np.asarray(objs, np.float32)
    if pixels:
        objs[:, 1:] *= DET_RES - 1
    return objs


def _write_det_rec(folder, n, seed):
    """A detection .rec/.idx pair of ``n`` JPEG images at DET_RES^2 (a
    smooth seeded background, each box a filled rectangle) with packed
    labels (``pack_det_label``), written by the port's ``recordio``."""
    import cv2

    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.image.detection import pack_det_label

    rng = np.random.RandomState(seed)
    rec, idx = os.path.join(folder, "det.rec"), os.path.join(folder, "det.idx")
    writer = recordio.MXIndexedRecordIO(idx, rec, "w")
    n_boxes = 0
    for i in range(n):
        img = cv2.resize(rng.randint(0, 255, (16, 16, 3), np.uint8),
                         (DET_RES, DET_RES), interpolation=cv2.INTER_LINEAR)
        objs = _det_objects(rng)
        for _, x0, y0, x1, y1 in objs:
            img[int(y0 * DET_RES):int(y1 * DET_RES),
                int(x0 * DET_RES):int(x1 * DET_RES)] = rng.randint(0, 255, 3)
        n_boxes += len(objs)
        header = recordio.IRHeader(0, pack_det_label(objs), i, 0)
        writer.write_idx(i, recordio.pack_img(header, img, quality=90))
    writer.close()
    return rec, n_boxes, os.path.getsize(rec)


def _det_zero_counters():
    counted = _counters()
    for fn in counted.values():
        fn.launches = 0
    return counted


def _timed_steps(torch, step, args, steps):
    """CUDA-event spans around ``steps`` calls of ``step(*args)`` and the
    wall time of all of them, ending in a sync."""
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    handles = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for start, end in marks:
        start.record()
        handles.append(step(*args))
        end.record()
    torch.cuda.synchronize()
    return ([a.elapsed_time(b) for a, b in marks],
            time.perf_counter() - t0, handles)


def _grads_by_name(net):
    return {k: p.grad().data.detach().cpu().double().clone()
            for k, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def _carried_nets(torch, build_net, fname, warm):
    """{"card", "cpu", "float64"} nets with the same weights: made and
    initialized on the CPU (``Xavier``; ``warm`` resolves the deferred
    shapes), carried by ``save_parameters`` / ``load_parameters`` to the
    card and to a CPU net cast to float64."""
    import mxnet_tpu_torch as mx

    mx.random.seed(SEED + 11)
    cpu_net = build_net()
    cpu_net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    warm(cpu_net)
    cpu_net.save_parameters(fname)
    card_net = build_net()
    card_net.load_parameters(fname, ctx=mx.gpu(0))
    f64_net = build_net()
    f64_net.load_parameters(fname, ctx=mx.cpu())
    f64_net.cast("float64")
    os.remove(fname)
    return {"card": card_net, "cpu": cpu_net, "float64": f64_net}


def _worst_tensors(got, want, top=4):
    """The ``top`` tensors farthest from ``want`` (relative L2)."""
    rel = [(float((got[k] - w).norm() / w.norm()), k)
           for k, w in want.items() if float(w.norm()) > 0]
    return [{"tensor": k, "rel": r} for r, k in sorted(rel)[::-1][:top]]


def _det_parity_row(torch, res, tol=None, spread=DET_PARITY_SPREAD):
    """The ``tol`` (default DET_PARITY_TOL) comparison of the card's
    (loss, grads, out) with the f32 CPU's and the float64 yardstick's,
    the gradient bounds widened to ``spread`` x the f32 CPU's own
    distance from float64."""
    (l_g, g_g, o_g), (l_c, g_c, o_c), (_, g_y, _) = (
        res["card"], res["cpu"], res["float64"])
    card_model, card_worst = _rel_l2(g_g, g_y)
    cpu_model, cpu_worst = _rel_l2(g_c, g_y)
    tol = DET_PARITY_TOL if tol is None else tol
    bound_model = max(tol["grad_rel_model"], spread * cpu_model)
    bound_tensor = max(tol["grad_rel_tensor"], spread * cpu_worst[0])
    row = {"loss_card": l_g, "loss_cpu": l_c, "loss_float64": res[
               "float64"][0],
           "loss_rel": abs(l_g - l_c) / abs(l_c),
           "out_of_max_abs": float((o_g - o_c).abs().max()
                                   / o_c.abs().max()),
           "grad_rel_model_vs_float64": {"card": card_model,
                                         "cpu": cpu_model,
                                         "bound": bound_model},
           "grad_rel_worst_tensor_vs_float64": {
               "card": card_worst[0], "card_tensor": card_worst[1],
               "cpu": cpu_worst[0], "cpu_tensor": cpu_worst[1],
               "bound": bound_tensor},
           "grad_rel_model_card_vs_cpu": _rel_l2(g_g, g_c)[0],
           "worst_tensors_vs_float64": {
               name: _worst_tensors(res[name][1], g_y)
               for name in ("card", "cpu")}}
    row["ok"] = bool(row["out_of_max_abs"] <= tol["out_of_max_abs"]
                     and row["loss_rel"] <= tol["loss_rel"]
                     and card_model <= bound_model
                     and card_worst[0] <= bound_tensor)
    return row


def _ssd_parity(torch, data_np, lab_np):
    """One SSD training forward and backward at batch DET_PARITY_BATCH on
    the card and on the CPU from the same weights: loss, gradients,
    MultiBoxTarget's targets."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.models import SSDTrainLoss, ssd_300
    from mxnet_tpu_torch.ops import cv_ops

    def warm(net):
        net(nd.array(data_np[:1], ctx=mx.cpu()))

    fname = os.path.join(_det_build_dir(), f"ssd-{os.getpid()}.params")
    nets = _carried_nets(torch, lambda: ssd_300(num_classes=DET_CLASSES),
                         fname, warm)
    res, targets = {}, {}
    for name, net in nets.items():
        dev = mx.gpu(0) if name == "card" else mx.cpu()
        dt = np.float64 if name == "float64" else np.float32
        x = nd.array(data_np.astype(dt), ctx=dev, dtype=dt)
        y = nd.array(lab_np.astype(dt), ctx=dev, dtype=dt)
        with autograd.record():
            anchors, cls_preds, box_preds = net(x)
            loss = SSDTrainLoss()(anchors, cls_preds, box_preds, y)
        loss.backward()
        _, mask, cls_t = cv_ops.multibox_target(
            anchors.data, y.data, cls_preds.data.detach().transpose(1, 2),
            negative_mining_ratio=3.0)
        res[name] = (float(loss.asscalar()), _grads_by_name(net),
                     cls_preds.data.detach().cpu().double())
        targets[name] = (cls_t.cpu().float(), mask.cpu().float())
    row = _det_parity_row(torch, res)
    (t_g, m_g), (t_c, m_c) = targets["card"], targets["cpu"]
    row["cls_target_mismatches"] = int((t_g != t_c).sum())
    row["loc_mask_mismatches"] = int((m_g != m_c).sum())
    row["cls_target_mismatches_vs_float64"] = int(
        (t_g != targets["float64"][0]).sum())
    row["ok"] = bool(row["ok"] and not row["cls_target_mismatches"]
                     and not row["loc_mask_mismatches"])
    return row


def phase_train_ssd(torch, ctx):
    """BASELINE config 5, SSD half, as ``examples/train_detection.py``
    runs it with ``--rec``, at full width: a seeded detection RecordIO,
    ``ImageDetIter`` with ``CreateDetAugmenter((3, 512, 512),
    rand_mirror=True, rand_crop=0.5, mean=True, std=True)`` on
    ``cuda:0``, ``ssd_300(num_classes=80)`` with ``Xavier``,
    ``SSDTrainLoss``, Adam lr 1e-3 through ``gluon.Trainer``; record ->
    backward -> ``trainer.step(32)``."""
    import random
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.image import CreateDetAugmenter, ImageDetIter
    from mxnet_tpu_torch.models import SSDTrainLoss, ssd_300

    torch.cuda.empty_cache()
    dev = mx.gpu(0)
    B, R = SSD_BATCH, DET_RES
    folder = tempfile.mkdtemp(prefix="det_rec-", dir=_det_build_dir())
    try:
        t0 = time.perf_counter()
        rec, n_boxes, rec_bytes = _write_det_rec(folder, DET_REC_IMAGES,
                                                 SEED)
        write_s = time.perf_counter() - t0
        random.seed(SEED)
        np.random.seed(SEED)
        mx.random.seed(SEED)
        augs = CreateDetAugmenter((3, R, R), rand_mirror=True, rand_crop=0.5,
                                  mean=True, std=True)
        it = ImageDetIter(batch_size=B, data_shape=(3, R, R),
                          path_imgrec=rec, shuffle=True, aug_list=augs,
                          ctx=dev)
        net = ssd_300(num_classes=DET_CLASSES)
        net.initialize(mx.init.Xavier(), ctx=dev)
        loss_block = SSDTrainLoss()
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": DET_LR})

        def next_batch():
            try:
                return next(it)
            except StopIteration:
                it.reset()
                return next(it)

        def step(data, label):
            with autograd.record():
                anchors, cls_preds, box_preds = net(data)
                loss = loss_block(anchors, cls_preds, box_preds, label)
            loss.backward()
            trainer.step(B)
            return loss

        def pipeline_step():
            batch = next_batch()
            ctx["ssd_batch"] = batch
            return step(batch.data[0], batch.label[0])

        torch.cuda.reset_peak_memory_stats()
        losses = [pipeline_step() for _ in range(DET_WARMUP)]
        counted = _det_zero_counters()
        span_ms, wall, handles = _timed_steps(torch, pipeline_step, (),
                                              DET_STEPS)
        launches = {n: fn.launches for n, fn in counted.items()}
        ctx.setdefault("launches", {})["train_ssd"] = launches
        losses = [float(h.asscalar()) for h in losses + handles]
        batch = ctx["ssd_batch"]
        data, label = batch.data[0], batch.label[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DET_ITER_BATCHES):
            next_batch()
        torch.cuda.synchronize()
        iter_ms = (time.perf_counter() - t0) * 1e3 / DET_ITER_BATCHES
        step_ms, _, _ = _timed_steps(torch, step, (data, label), DET_STEPS)
        prof = _step_profile(torch, lambda: step(data, label), steps=1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        data_np, label_np = (data.asnumpy()[:DET_PARITY_BATCH],
                             label.asnumpy()[:DET_PARITY_BATCH])
        ctx["ssd"] = {"net": net, "data": data}
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    parity = _ssd_parity(torch, data_np, label_np)
    ok = bool(all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0]
              and data.context == dev and label.context == dev
              and tuple(data.shape) == (B, 3, R, R)
              and not any(launches.values()) and parity["ok"])
    return {"model": "ssd_300", "num_classes": DET_CLASSES,
            "input": "RecordIO via ImageDetIter (cv2 decode)",
            "rec_images": DET_REC_IMAGES, "rec_boxes": n_boxes,
            "rec_bytes": rec_bytes, "rec_write_s": write_s,
            "batch": B, "res": R, "steps": DET_STEPS,
            "pipeline_wall_s": wall,
            "pipeline_images_per_s": DET_STEPS * B / wall,
            "pipeline_step_ms_median": statistics.median(span_ms),
            "iter_ms_per_batch": iter_ms,
            "step_ms_median": statistics.median(step_ms),
            "step_ms": step_ms, "staged_images_per_s":
                B * 1e3 / statistics.median(step_ms),
            "max_memory_allocated_gb": peak, "losses": losses,
            "batch_device": str(data.context),
            "label_shape": list(label.shape), "launches": launches,
            "profile_1_step": prof, "parity_tol": DET_PARITY_TOL,
            "parity_spread": DET_PARITY_SPREAD, "parity": parity,
            "card": ctx["smi"], "ok": ok}


def _det_scores(rng, b, n, valid):
    """MultiBoxDetection inputs with no two competing scores within 1e-4:
    per image ``valid`` anchors get one foreground class at a distinct
    score 0.02 + k * 1.5e-4; every other score lies below 0.004, under
    the 0.01 threshold."""
    prob = rng.uniform(0.0, 0.004, (b, DET_CLASSES + 1, n)).astype(np.float32)
    for i in range(b):
        rows = rng.choice(n, valid, replace=False)
        prob[i, rng.randint(1, DET_CLASSES + 1, valid), rows] = (
            0.02 + rng.permutation(valid) * 1.5e-4)
    return prob


def _detection_card_vs_cpu(torch, anchors, b=4, valid=5000):
    """MultiBoxDetection (threshold 0.01, NMS 0.45, top-k 400) on the
    card vs the CPU on drawn scores and offsets over ``anchors``."""
    from mxnet_tpu_torch.ops import cv_ops

    rng = np.random.RandomState(SEED + 12)
    n = anchors.shape[1]
    valid = min(valid, n // 2)
    prob = torch.from_numpy(_det_scores(rng, b, n, valid))
    loc = torch.from_numpy(rng.normal(0, 0.5, (b, n * 4)).astype(np.float32))
    kw = dict(threshold=0.01, nms_threshold=0.45, nms_topk=400)
    card = cv_ops.multibox_detection(prob.cuda(), loc.cuda(),
                                     anchors.cuda(), **kw).cpu()
    cpu = cv_ops.multibox_detection(prob, loc, anchors.cpu(), **kw)
    kept_g, kept_c = card[..., 0] >= 0, cpu[..., 0] >= 0
    return {"batch": b, "valid_rows": valid,
            "kept_rows": int(kept_c.sum()),
            "kept_equal": bool(torch.equal(kept_g, kept_c)),
            "class_ids_equal": bool(torch.equal(card[..., 0], cpu[..., 0])),
            "scores_equal": bool(torch.equal(card[..., 1], cpu[..., 1])),
            "box_max_abs": float((card[..., 2:] - cpu[..., 2:]).abs().max()),
            "box_atol": DET_BOX_ATOL}


def phase_detect_ssd(torch, ctx):
    """``SSD.detect`` (threshold 0.01, NMS 0.45, top-k 400) on the train
    phase's last batch of 32 augmented 512^2 images with its trained net:
    2 warm-up and DET_DETECT_CALLS timed calls, each ending in a sync;
    then MultiBoxDetection card vs CPU on drawn inputs over the net's
    21,764 anchors."""
    net, data = ctx["ssd"]["net"], ctx["ssd"]["data"]
    counted = _det_zero_counters()
    for _ in range(2):
        det = net.detect(data, threshold=0.01, nms_threshold=0.45, topk=400)
    torch.cuda.synchronize()
    ms = []
    for _ in range(DET_DETECT_CALLS):
        t0 = time.perf_counter()
        det = net.detect(data, threshold=0.01, nms_threshold=0.45, topk=400)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {n: fn.launches for n, fn in counted.items()}
    ctx.setdefault("launches", {})["detect_ssd"] = launches
    out = det.asnumpy()
    kept = (out[..., 0] >= 0).sum(axis=1)
    with torch.no_grad():
        anchors = net(data.data[:1])[0]
    prof = _step_profile(torch, lambda: net.detect(data), steps=1)
    gate = _detection_card_vs_cpu(torch, anchors)
    ok = bool(out.shape == (SSD_BATCH, anchors.shape[1], 6)
              and np.isfinite(out).all() and kept.max() <= 400
              and not any(launches.values())
              and gate["kept_equal"] and gate["class_ids_equal"]
              and gate["scores_equal"]
              and gate["box_max_abs"] <= DET_BOX_ATOL)
    return {"batch": SSD_BATCH, "res": DET_RES, "anchors": anchors.shape[1],
            "ms_per_batch_median": statistics.median(ms), "ms": ms,
            "images_per_s": SSD_BATCH * 1e3 / statistics.median(ms),
            "kept_rows_per_image": {"min": int(kept.min()),
                                    "max": int(kept.max()),
                                    "mean": float(kept.mean())},
            "launches": launches, "profile_1_call": prof,
            "multibox_detection_card_vs_cpu": gate, "card": ctx["smi"],
            "ok": ok}


def _frcnn_batch(b, seed):
    """(images, pixel gt boxes padded with -1 rows, im_info) at DET_RES."""
    rng = np.random.RandomState(seed)
    x = rng.rand(b, 3, DET_RES, DET_RES).astype(np.float32)
    gt = np.full((b, DET_MAX_BOXES, 5), -1.0, np.float32)
    for i in range(b):
        objs = _det_objects(rng, pixels=True)
        gt[i, :len(objs)] = objs
    info = np.tile(np.array([[DET_RES, DET_RES, 1.0]], np.float32), (b, 1))
    return x, gt, info


def _frcnn_parity(torch):
    """One FasterRCNNTrainLoss forward and backward at batch
    DET_PARITY_BATCH on the card and on the CPU from the same weights.
    The CPU steps take the card's proposals and its ProposalTarget
    sample: which of the RPN's 24,576 near-equal scores make the pre-NMS
    top 256, and which rois of near-equal IoU make the 32 an image, turn
    on rounding (the cv_ops phase holds both ops card vs CPU, exactly, on
    the same inputs); whether the CPU's own choices equal the card's is
    reported."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.models import (FasterRCNN, FasterRCNNTrainLoss,
                                        faster_rcnn_small)
    from mxnet_tpu_torch.ops import cv_ops

    x, gt, info = _frcnn_batch(DET_PARITY_BATCH, SEED + 13)

    def warm(net):
        cpu = mx.cpu()
        FasterRCNNTrainLoss(net)(nd.array(x, ctx=cpu), nd.array(gt, ctx=cpu),
                                 nd.array(info, ctx=cpu))

    fname = os.path.join(_det_build_dir(), f"frcnn-{os.getpid()}.params")
    nets = _carried_nets(
        torch, lambda: faster_rcnn_small(num_classes=DET_CLASSES), fname,
        warm)
    seen = {}

    def pinned(name, net):
        def proposals(F, rpn_cls, rpn_bbox, im_info):
            seen[name] = FasterRCNN.proposals(net, F, rpn_cls, rpn_bbox,
                                              im_info)
            seen["rpn_" + name] = rpn_cls.detach()
            if name == "card":
                return seen[name]
            return seen["card"].to(rpn_cls.device, rpn_cls.dtype)
        return proposals

    sample = cv_ops.proposal_target

    def pinned_sample(name):
        def proposal_target(rois, gt_boxes, **kw):
            seen["sample_" + name] = sample(rois, gt_boxes, **kw)
            if name == "card":
                return seen["sample_card"]
            return tuple(t.to(rois.device, rois.dtype)
                         for t in seen["sample_card"])
        return proposal_target

    def run(name, net):
        net.proposals = pinned(name, net)
        cv_ops.proposal_target = pinned_sample(name)
        dev = mx.gpu(0) if name == "card" else mx.cpu()
        dt = np.float64 if name == "float64" else np.float32
        args = [nd.array(a.astype(dt), ctx=dev, dtype=dt)
                for a in (x, gt, info)]
        with autograd.record():
            loss = FasterRCNNTrainLoss(net)(*args)
        loss.backward()
        return (float(loss.asscalar()), _grads_by_name(net),
                seen["rpn_" + name].cpu().double())

    res = {}
    try:
        for name, net in nets.items():
            res[name] = run(name, net)
        own = {"own_proposals_equal": bool(torch.equal(seen["card"].cpu(),
                                                       seen["cpu"])),
               "own_sample_equal": all(
                   torch.equal(a.cpu(), b) for a, b in zip(
                       seen["sample_card"], seen["sample_cpu"]))}
        # the card again with cuDNN off (torch's own convolutions): the
        # gap to float64 is not cuDNN's algorithms
        cudnn = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = False
        try:
            no_cudnn = run("card", nets["card"])[1]
        finally:
            torch.backends.cudnn.enabled = cudnn
    finally:
        cv_ops.proposal_target = sample
    row = _det_parity_row(torch, res)
    row["grad_rel_model_vs_float64_card_cudnn_off"] = _rel_l2(
        no_cudnn, res["float64"][1])[0]
    return {**row, **own}


def phase_train_faster_rcnn(torch, ctx):
    """BASELINE config 5, Faster-RCNN half, at full width:
    ``faster_rcnn_small(num_classes=80)`` (body 16/32/64, 6 anchors a
    cell, RPN 128, pre/post NMS 256/64, 32 rois an image, hidden 256)
    with ``Xavier``, ``FasterRCNNTrainLoss`` and Adam lr 1e-3 through
    ``gluon.Trainer``, batch 8 at 512^2 with seeded pixel gt boxes and
    ``im_info``; then ``FasterRCNN.detect`` once."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.models import FasterRCNNTrainLoss, faster_rcnn_small

    ctx.pop("ssd", None)
    ctx.pop("ssd_batch", None)
    torch.cuda.empty_cache()
    dev = mx.gpu(0)
    B = FRCNN_BATCH
    mx.random.seed(SEED)
    x_np, gt_np, info_np = _frcnn_batch(B, SEED)
    x, gt, info = (nd.array(a, ctx=dev) for a in (x_np, gt_np, info_np))
    net = faster_rcnn_small(num_classes=DET_CLASSES)
    net.initialize(mx.init.Xavier(), ctx=dev)
    loss_block = FasterRCNNTrainLoss(net)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": DET_LR})

    def step():
        with autograd.record():
            loss = loss_block(x, gt, info)
        loss.backward()
        trainer.step(B)
        return loss

    torch.cuda.reset_peak_memory_stats()
    losses = [step() for _ in range(DET_WARMUP)]
    counted = _det_zero_counters()
    step_ms, wall, handles = _timed_steps(torch, step, (), DET_STEPS)
    launches = {n: fn.launches for n, fn in counted.items()}
    ctx.setdefault("launches", {})["train_faster_rcnn"] = launches
    losses = [float(h.asscalar()) for h in losses + handles]
    prof = _step_profile(torch, step, steps=1, gaps=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    counted = _det_zero_counters()
    # threshold 0: every roi's best class takes part in the NMS (at the
    # default 0.05 a net this young keeps no row of 81 classes)
    net.detect(x, threshold=0.0)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det = net.detect(x, threshold=0.0)
    detect_ms = (time.perf_counter() - t0) * 1e3
    det_launches = {n: fn.launches for n, fn in counted.items()}
    ctx["launches"]["detect_faster_rcnn"] = det_launches
    out = det.asnumpy()
    kept = (out[..., 0] >= 0).sum(axis=1)
    del net, loss_block, trainer
    torch.cuda.empty_cache()
    parity = _frcnn_parity(torch)
    ok = bool(all(math.isfinite(v) for v in losses)
              and losses[-1] < losses[0]
              and out.shape == (B, 64, 6) and np.isfinite(out).all()
              and not any(launches.values())
              and not any(det_launches.values()) and parity["ok"])
    return {"model": "faster_rcnn_small", "num_classes": DET_CLASSES,
            "batch": B, "res": DET_RES,
            "gt_boxes": int((gt_np[..., 0] >= 0).sum()),
            "steps": DET_STEPS, "wall_s": wall,
            "images_per_s": DET_STEPS * B / wall,
            "step_ms_median": statistics.median(step_ms),
            "step_ms": step_ms, "max_memory_allocated_gb": peak,
            "losses": losses, "launches": launches,
            "profile_1_step": prof, "detect_threshold": 0.0,
            "detect_ms": detect_ms,
            "detect_kept_rows_per_image": kept.tolist(),
            "detect_launches": det_launches, "parity_tol": DET_PARITY_TOL,
            "parity_spread": DET_PARITY_SPREAD, "parity": parity,
            "card": ctx["smi"], "ok": ok}


# cv_ops card vs CPU: float outputs within these (absolute, on outputs of
# order one; ROIAlign's output and feature gradient relative to their max
# abs, the gradient accumulating with atomic adds on the card); integer
# and mask outputs, selected values and orders exact
CV_TOL = {"iou": 1e-6, "prior": 1e-6, "loc_target": 1e-4, "decode": 1e-5,
          "roi_align": 1e-5, "roi_align_grad": 1e-5, "proposal_box": 1e-3,
          "encode": 1e-4, "mask_target": 1e-5, "smooth_l1": 1e-6}


def _cv_card_vs_cpu(torch, fn, args, kw=None):
    """``fn(*args, **kw)`` on the card (one warm-up call, one timed call
    ending in a sync) and on the CPU: (card outputs on the CPU, CPU
    outputs, card ms)."""
    kw = kw or {}
    card_args = [a.cuda() if isinstance(a, torch.Tensor) else a
                 for a in args]
    fn(*card_args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = fn(*card_args, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    cpu = fn(*args, **kw)
    card = card if isinstance(card, (tuple, list)) else (card,)
    cpu = cpu if isinstance(cpu, (tuple, list)) else (cpu,)
    return [c.cpu() for c in card], list(cpu), ms


def _max_abs(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def phase_cv_ops(torch, ctx):
    """Every registered detection op on the card vs the CPU port at the
    detection paths' shapes (SSD-512: 21,764 anchors, batch 32, 81
    classes; Faster-RCNN: a 64 x 64 map of 6 anchors, batch 8, 256 rois),
    on seeded inputs with tied scores, padded gt rows and two gt boxes
    sharing their best anchor."""
    from mxnet_tpu_torch.ops import cv_ops, registry
    from mxnet_tpu_torch.ops.elemwise import smooth_l1

    rng = np.random.RandomState(SEED + 14)
    T = torch.from_numpy
    rows, ok = {}, True

    def record(name, exact, close, ms, **extra):
        nonlocal ok
        row_ok = all(exact.values()) and all(v <= CV_TOL[k.split(":")[0]]
                                             for k, v in close.items())
        rows[name] = {"ms": ms, "exact": exact, "max_abs": close, **extra,
                      "ok": bool(row_ok)}
        ok = ok and row_ok

    # SSD's anchors at 512^2 and a batch of gt boxes, padded with -1 rows;
    # image 0's rows 0 and 1 are one box under two classes, so both force
    # the same best anchor
    feats = [T(np.zeros((1, 1, s, s), np.float32)) for s in (64, 32, 16, 8, 1)]
    sizes = [[0.2, 0.272], [0.37, 0.447], [0.54, 0.619], [0.71, 0.79],
             [0.88, 0.961]]
    priors = []
    for f, sz in zip(feats, sizes):
        g, c, ms = _cv_card_vs_cpu(torch, cv_ops.multibox_prior, (f,),
                                   {"sizes": sz, "ratios": [1, 2, 0.5]})
        priors.append(c[0])
        record(f"MultiBoxPrior_{f.shape[-1]}", {}, {"prior": _max_abs(
            g[0], c[0])}, ms)
    anchors = torch.cat(priors, dim=1)
    n = anchors.shape[1]
    labels = np.full((SSD_BATCH, DET_MAX_BOXES, 5), -1.0, np.float32)
    for i in range(SSD_BATCH):
        objs = _det_objects(rng)
        labels[i, :len(objs)] = objs
    labels[0, 1] = labels[0, 0]
    labels[0, 1, 0] = (labels[0, 0, 0] + 1) % DET_CLASSES
    labels = T(labels)
    # logits on a grid of 1/8: many exact ties among the mining scores
    cls_pred = T(np.round(rng.normal(0, 1, (SSD_BATCH, DET_CLASSES + 1, n))
                          * 8).astype(np.float32) / 8)
    g, c, ms = _cv_card_vs_cpu(torch, cv_ops.box_iou,
                               (anchors[0], labels[:, :, 1:5]))
    record("box_iou", {}, {"iou": _max_abs(g[0], c[0])}, ms)
    g, c, ms = _cv_card_vs_cpu(torch, cv_ops.multibox_target,
                               (anchors, labels, cls_pred),
                               {"negative_mining_ratio": 3.0})
    # the shared best anchor goes to the higher gt index, on both
    shared = int(torch.argmax(cv_ops.box_iou(anchors[0], labels[0, :1,
                                                                1:5])))
    want = float(labels[0, 1, 0]) + 1.0
    record("MultiBoxTarget",
           {"cls_target": torch.equal(g[2], c[2]),
            "loc_mask": torch.equal(g[1], c[1]),
            "shared_anchor_to_higher_gt": float(g[2][0, shared]) == want
            and float(c[2][0, shared]) == want},
           {"loc_target": _max_abs(g[0], c[0])}, ms,
           positives=int((c[2] > 0).sum()), kept=int((c[2] >= 0).sum()))
    gate = _detection_card_vs_cpu(torch, anchors, b=2, valid=3000)
    record("MultiBoxDetection",
           {k: gate[k] for k in ("kept_equal", "class_ids_equal",
                                 "scores_equal")},
           {"decode": gate["box_max_abs"]}, None, kept=gate["kept_rows"])
    # box_nms with top-k off on Faster-RCNN's detect rows, scores tied on
    # a grid of 1/16
    det = np.zeros((FRCNN_BATCH, 64, 6), np.float32)
    det[..., 0] = rng.randint(0, 4, (FRCNN_BATCH, 64))
    det[..., 1] = np.round(rng.uniform(0, 1, (FRCNN_BATCH, 64)) * 16) / 16
    xy = rng.uniform(0, 400, (FRCNN_BATCH, 64, 2))
    det[..., 2:4] = xy
    det[..., 4:6] = xy + rng.uniform(20, 120, (FRCNN_BATCH, 64, 2))
    g, c, ms = _cv_card_vs_cpu(torch, cv_ops.box_nms, (T(det),),
                               {"overlap_thresh": 0.3, "valid_thresh": 0.05,
                                "topk": -1, "id_index": 0})
    record("box_nms", {"rows": torch.equal(g[0], c[0])}, {}, ms,
           kept=int((c[0][..., 0] >= 0).sum()))
    scores = T(np.round(rng.uniform(0, 1, (FRCNN_BATCH, 64, DET_MAX_BOXES))
                        * 8).astype(np.float32) / 8)
    g, c, ms = _cv_card_vs_cpu(torch, cv_ops.bipartite_matching, (scores,),
                               {"threshold": 0.25})
    record("bipartite_matching", {"rows": torch.equal(g[0], c[0]),
                                  "cols": torch.equal(g[1], c[1])}, {}, ms)
    # Faster-RCNN: RPN outputs on a 64 x 64 map, scores tied on 1/64
    a, hw = 6, DET_RES // 8
    fg = np.round(rng.uniform(0, 1, (FRCNN_BATCH, a, hw, hw)) * 64) / 64
    rpn_prob = T(np.concatenate([1 - fg, fg], 1).astype(np.float32))
    rpn_bbox = T(rng.normal(0, 0.1, (FRCNN_BATCH, 4 * a, hw, hw))
                 .astype(np.float32))
    info = T(np.tile(np.array([[DET_RES, DET_RES, 1.0]], np.float32),
                     (FRCNN_BATCH, 1)))
    pkw = dict(rpn_pre_nms_top_n=256, rpn_post_nms_top_n=64,
               rpn_min_size=4, scales=(2.0, 4.0), ratios=(0.5, 1.0, 2.0),
               feature_stride=8, output_score=True)
    for name, fn in (("Proposal", cv_ops.proposal),
                     ("MultiProposal", cv_ops.multi_proposal)):
        g, c, ms = _cv_card_vs_cpu(torch, fn, (rpn_prob, rpn_bbox, info), pkw)
        record(name, {"scores_in_order": torch.equal(g[1], c[1])},
               {"proposal_box": _max_abs(g[0], c[0])}, ms)
    rois = g[0]
    gt = np.full((FRCNN_BATCH, DET_MAX_BOXES, 5), -1.0, np.float32)
    for i in range(FRCNN_BATCH):
        objs = _det_objects(rng, pixels=True)
        gt[i, :len(objs)] = objs
    gt = T(gt)
    g, c, ms = _cv_card_vs_cpu(torch, cv_ops.rpn_anchor_target,
                               (rpn_prob, gt),
                               {"scales": (2.0, 4.0),
                                "ratios": (0.5, 1.0, 2.0),
                                "feature_stride": 8})
    record("RPNAnchorTarget", {"labels": torch.equal(g[0], c[0]),
                               "weights": torch.equal(g[2], c[2])},
           {"encode": _max_abs(g[1], c[1])}, ms,
           fg=int((c[0] == 1).sum()))
    g, c, ms = _cv_card_vs_cpu(torch, cv_ops.proposal_target, (rois, gt),
                               {"num_classes": DET_CLASSES + 1,
                                "batch_images": FRCNN_BATCH,
                                "batch_rois": FRCNN_BATCH * 32,
                                "fg_fraction": 0.5})
    record("ProposalTarget", {"rois": torch.equal(g[0], c[0]),
                              "labels": torch.equal(g[1], c[1]),
                              "weights": torch.equal(g[3], c[3])},
           {"encode": _max_abs(g[2], c[2])}, ms,
           fg=int((c[1] > 0).sum()))
    feat = T(rng.normal(0, 1, (FRCNN_BATCH, 64, hw, hw)).astype(np.float32))
    sel = c[0]

    def align_with_grad(f, r):
        f = f.clone().requires_grad_(True)
        out = cv_ops.roi_align(f, r, pooled_size=(7, 7),
                               spatial_scale=1.0 / 8)
        (out * out).sum().backward()
        return out.detach(), f.grad

    g, c, ms = _cv_card_vs_cpu(torch, align_with_grad, (feat, sel))
    record("ROIAlign", {}, {"roi_align": _max_abs(g[0], c[0])
                            / float(c[0].abs().max()),
                            "roi_align_grad": _max_abs(g[1], c[1])
                            / float(c[1].abs().max())}, ms)
    small = T(rng.normal(0, 1, (2, 16, 32, 32)).astype(np.float32))
    prois = np.zeros((16, 5), np.float32)
    prois[:, 0] = rng.randint(0, 2, 16)
    prois[:, 1:3] = rng.uniform(0, 150, (16, 2))
    prois[:, 3:5] = prois[:, 1:3] + rng.uniform(4, 100, (16, 2))
    g, c, ms = _cv_card_vs_cpu(torch, cv_ops.roi_pooling, (small, T(prois)),
                               {"pooled_size": (7, 7),
                                "spatial_scale": 1.0 / 8})
    record("ROIPooling", {"out": torch.equal(g[0], c[0])}, {}, ms)
    samples = T(rng.choice([-1.0, 0.0, 1.0], (FRCNN_BATCH, n))
                .astype(np.float32))
    matches = T(rng.randint(0, DET_MAX_BOXES, (FRCNN_BATCH, n))
                .astype(np.float32))
    refs = labels[:FRCNN_BATCH, :, 1:5].abs()
    refs = torch.cat([torch.minimum(refs[..., :2], refs[..., 2:]),
                      torch.maximum(refs[..., :2], refs[..., 2:]) + 0.01], -1)
    g, c, ms = _cv_card_vs_cpu(torch, cv_ops.box_encode,
                               (samples, matches,
                                anchors.expand(FRCNN_BATCH, -1, -1), refs))
    record("box_encode", {"masks": torch.equal(g[1], c[1])},
           {"encode": _max_abs(g[0], c[0])}, ms)
    deltas = T(rng.normal(0, 1, (FRCNN_BATCH, n, 4)).astype(np.float32))
    g, c, ms = _cv_card_vs_cpu(torch, cv_ops.box_decode, (deltas, anchors),
                               {"clip": 1.0})
    record("box_decode", {}, {"decode": _max_abs(g[0], c[0])}, ms)
    mrois = T(np.concatenate([rng.uniform(0, 30, (2, 16, 2)),
                              rng.uniform(34, 63, (2, 16, 2))], -1)
              .astype(np.float32))
    masks = T((rng.uniform(0, 1, (2, 4, 64, 64)) > 0.5).astype(np.float32))
    g, c, ms = _cv_card_vs_cpu(
        torch, cv_ops.mrcnn_mask_target,
        (mrois, masks, T(rng.randint(0, 4, (2, 16)).astype(np.float32)),
         T(rng.randint(0, 3, (2, 16)).astype(np.float32))),
        {"num_classes": 3, "mask_size": (14, 14)})
    record("mrcnn_mask_target", {"weights": torch.equal(g[1], c[1])},
           {"mask_target": _max_abs(g[0], c[0])}, ms)
    g, c, ms = _cv_card_vs_cpu(torch, smooth_l1, (deltas,), {"scalar": 3.0})
    record("smooth_l1", {}, {"smooth_l1": _max_abs(g[0], c[0])}, ms)
    names = {f"_contrib_{k}" if k not in ("ROIPooling", "smooth_l1") else k
             for k in rows}
    names = {k.rsplit("_", 1)[0] if k.startswith("_contrib_MultiBoxPrior")
             else k for k in names}
    missing = sorted(set(DET_OPS) - names)
    registered = sorted(o for o in DET_OPS if o in registry.list_ops())
    return {"tol": CV_TOL, "ops": rows, "not_run": missing,
            "registered": len(registered),
            "ok": bool(ok and not missing and len(registered) == len(DET_OPS))}


DET_OPS = ("_contrib_box_iou", "_contrib_box_nms",
           "_contrib_bipartite_matching", "_contrib_MultiBoxPrior",
           "_contrib_MultiBoxTarget", "_contrib_MultiBoxDetection",
           "ROIPooling", "_contrib_ROIAlign", "_contrib_Proposal",
           "_contrib_MultiProposal", "_contrib_box_encode",
           "_contrib_box_decode", "_contrib_mrcnn_mask_target",
           "_contrib_RPNAnchorTarget", "_contrib_ProposalTarget",
           "smooth_l1")


# the LSTM language model: Zaremba et al.'s "medium" configuration as
# MXNet's example/gluon/word_language_model runs it (--emsize 650 --nhid
# 650 --dropout 0.5, untied), on a seeded synthetic stream
LM_VOCAB, LM_WIDTH, LM_LAYERS, LM_DROPOUT = 10000, 650, 2, 0.5
LM_BATCH, LM_BPTT, LM_LR, LM_CLIP = 20, 35, 1.0, 5.0
LM_WARMUP, LM_STEPS, LM_TRAIN_STEPS = 3, 20, 30
LM_PERIOD = 4  # the stream repeats every 4 batches
LM_PARITY_BATCH = 2
# card vs CPU, one step at batch 2 from the same weights and carried
# state, dropout 0, f32 on both (TF32 off): logits and every gradient
# relative to their tensor's max abs, the parameters after the step
# relative to theirs, the loss relative, the new state absolute (|h|, |c|
# < 1 here)
LM_PARITY_TOL = {"logits_of_max_abs": 1e-4, "loss_rel": 1e-5,
                 "grad_of_max_abs": 1e-4, "params_of_max_abs": 1e-6,
                 "state_abs": 1e-5}


def _lm_batches(batch, seed, vocab=LM_VOCAB):
    """LM_PERIOD (data, target) pairs of (LM_BPTT, batch) token ids from
    a Zipf-distributed (p ~ 1/rank) seeded stream, laid out in ``batch``
    columns as MXNet's ``batchify`` lays out a corpus."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    rows = LM_PERIOD * LM_BPTT + 1
    stream = rng.choice(vocab, size=rows * batch, p=p / p.sum())
    cols = stream.reshape(batch, rows).T.astype(np.float32)
    return [(cols[i * LM_BPTT:(i + 1) * LM_BPTT],
             cols[i * LM_BPTT + 1:(i + 1) * LM_BPTT + 1])
            for i in range(LM_PERIOD)]


def _lm_trainer(torch, net, dev, batches):
    """``step()``: one training step on the next of ``batches`` (NDArrays
    on ``dev``) with the carried state detached, ``clip_global_norm`` at
    LM_CLIP per token and ``Trainer.step(bptt * batch)``; returns the
    mean per-token loss."""
    from mxnet_tpu_torch import autograd, gluon

    params = net.collect_params()
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": LM_LR})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    batch = batches[0][0].shape[1]
    state = {"k": 0, "hidden": net.begin_state(batch, ctx=dev)}

    def step():
        x, y = batches[state["k"] % len(batches)]
        state["k"] += 1
        hidden = [h.detach() for h in state["hidden"]]
        with autograd.record():
            logits, hidden = net(x, hidden)
            loss = loss_fn(logits, y.reshape((-1,)))
        loss.backward()
        state["hidden"] = hidden
        gluon.utils.clip_global_norm([p.grad() for p in params.values()],
                                     LM_CLIP * LM_BPTT * batch)
        trainer.step(LM_BPTT * batch)
        return loss.mean()

    return step


def _lm_parity(torch):
    """One training step at batch 2, dropout 0, on the card and on the
    CPU from the same weights and the same (seeded, nonzero) carried
    state."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.models import lstm_lm_medium

    mx.random.seed(SEED + 21)
    cpu_net = lstm_lm_medium(dropout=0.0, prefix="lmp_")
    cpu_net.initialize(mx.init.Uniform(0.05), ctx=mx.cpu())
    card_net = lstm_lm_medium(dropout=0.0, prefix="lmp_")
    card_net.initialize(ctx=mx.gpu(0))
    for k, p in card_net.collect_params().items():
        p.set_data(cpu_net.collect_params()[k].data()._data)
    x, y = _lm_batches(LM_PARITY_BATCH, SEED + 22)[0]
    rng = np.random.RandomState(SEED + 23)
    h0 = [(rng.standard_normal((LM_LAYERS, LM_PARITY_BATCH, LM_WIDTH))
           * 0.1).astype(np.float32) for _ in range(2)]
    res = {}
    for name, net, dev in (("card", card_net, mx.gpu(0)),
                           ("cpu", cpu_net, mx.cpu())):
        params = net.collect_params()
        trainer = gluon.Trainer(params, "sgd", {"learning_rate": LM_LR})
        with autograd.record():
            logits, hidden = net(nd.array(x, ctx=dev),
                                 [nd.array(h, ctx=dev) for h in h0])
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                logits, nd.array(y.reshape(-1), ctx=dev))
        loss.backward()
        grads = {k: p.grad().asnumpy().copy() for k, p in params.items()}
        gluon.utils.clip_global_norm([p.grad() for p in params.values()],
                                     LM_CLIP * LM_BPTT * LM_PARITY_BATCH)
        trainer.step(LM_BPTT * LM_PARITY_BATCH)
        res[name] = {"logits": logits.asnumpy(),
                     "loss": float(loss.mean().asscalar()), "grads": grads,
                     "params": {k: p.data().asnumpy()
                                for k, p in params.items()},
                     "state": [h.asnumpy() for h in hidden]}

    def of_max(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    card, cpu = res["card"], res["cpu"]
    errs = {"logits_of_max_abs": of_max(card["logits"], cpu["logits"]),
            "loss_rel": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
            "grad_of_max_abs": {k: of_max(card["grads"][k], v)
                                for k, v in cpu["grads"].items()},
            "params_of_max_abs": {k: of_max(card["params"][k], v)
                                  for k, v in cpu["params"].items()},
            "state_abs": max(float(np.abs(a - b).max()) for a, b in zip(
                card["state"], cpu["state"]))}
    ok = all((max(v.values()) if isinstance(v, dict) else v)
             <= LM_PARITY_TOL[k] for k, v in errs.items())
    return {"batch": LM_PARITY_BATCH, "loss_card": card["loss"],
            "loss_cpu": cpu["loss"], "errors": errs, "tol": LM_PARITY_TOL,
            "ok": bool(ok)}


def phase_train_lstm_lm(torch, ctx):
    """The medium LSTM language model (vocabulary 10,000, embedding 650,
    2 x 650 LSTM, dropout 0.5, 19.8 M parameters, ``Uniform(0.05)``)
    trained on ``cuda:0`` as MXNet's word_language_model example trains
    it: batch 20, 35 unrolled steps, the state carried and detached, SGD
    lr 1.0 through ``gluon.Trainer``, ``clip_global_norm`` 5 per token,
    ``SoftmaxCrossEntropyLoss``; f32, TF32 off."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.models import lstm_lm_medium

    torch.cuda.empty_cache()
    dev = mx.gpu(0)
    mx.random.seed(SEED + 20)
    net = lstm_lm_medium(prefix="lm_")
    net.initialize(mx.init.Uniform(0.05), ctx=dev)
    n_params = sum(p.data().size for p in net.collect_params().values())
    batches = [(nd.array(x, ctx=dev), nd.array(y, ctx=dev))
               for x, y in _lm_batches(LM_BATCH, SEED + 20)]
    step = _lm_trainer(torch, net, dev, batches)
    torch.cuda.reset_peak_memory_stats()
    losses = [step() for _ in range(LM_WARMUP)]
    counted = _det_zero_counters()
    step_ms, wall, handles = _timed_steps(torch, step, (), LM_STEPS)
    launches = {n: fn.launches for n, fn in counted.items()}
    ctx.setdefault("launches", {})["train_lstm_lm"] = launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = _step_profile(torch, step, steps=1)
    losses = losses + handles
    losses += [step() for _ in range(LM_TRAIN_STEPS - len(losses) - 1)]
    losses = [float(h.asscalar()) for h in losses]
    tokens = LM_STEPS * LM_BPTT * LM_BATCH
    del net, batches, step
    torch.cuda.empty_cache()
    parity = _lm_parity(torch)
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    ok = bool(all(math.isfinite(v) for v in losses) and last < first
              and not any(launches.values()) and parity["ok"])
    return {"model": "lstm_lm_medium", "vocab": LM_VOCAB,
            "embed": LM_WIDTH, "hidden": LM_WIDTH, "layers": LM_LAYERS,
            "dropout": LM_DROPOUT, "params": n_params, "batch": LM_BATCH,
            "bptt": LM_BPTT, "lr": LM_LR, "clip": LM_CLIP,
            "stream_period_batches": LM_PERIOD,
            "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn": torch.backends.cudnn.allow_tf32},
            "steps": LM_STEPS, "wall_s": wall, "tokens_per_s": tokens / wall,
            "step_ms_median": statistics.median(step_ms),
            "step_ms": step_ms, "max_memory_allocated_gb": peak,
            "losses": losses, "loss_first5_mean": float(first),
            "loss_last5_mean": float(last), "launches": launches,
            "profile_1_step": prof, "parity": parity, "card": ctx["smi"],
            "ok": ok}


# rnn_variants: small widths, the card within RNN_VAR_TOL of each tensor's
# max abs of the CPU in f32 and of the CPU in float64, from the same
# weights (a wrong gate order, weight or direction moves it by O(1))
RNN_VAR = {"T": 20, "B": 8, "I": 64, "H": 128}
RNN_VAR_TOL = 1e-4


def _rnn_variant_blocks():
    """name -> (make(gluon), call(block, nd, x, states), input layout,
    number of begin states)."""
    H = RNN_VAR["H"]

    def layer(b, nd, x, states):
        return b(x, states)

    def unroll(layout, valid=None, merge=True):
        def call(b, nd, x, states):
            v = None if valid is None else nd.array(
                np.asarray(valid, np.float32), ctx=x.context)
            return b.unroll(RNN_VAR["T"], x, states, layout=layout,
                            merge_outputs=merge, valid_length=v)

        return call

    def seq(g):
        net = g.rnn.SequentialRNNCell(prefix="vseq_")
        with net.name_scope():
            net.add(g.rnn.LSTMCell(H))
            net.add(g.rnn.ResidualCell(g.rnn.GRUCell(H)))
        return net

    lens = [20, 3, 17, 1, 20, 9, 12, 5]
    return {
        "gru_2layer_tnc": (lambda g: g.rnn.GRU(H, 2, prefix="vg_"), layer,
                           "TNC", 1),
        "lstm_bidirectional_ntc": (
            lambda g: g.rnn.LSTM(H, 2, layout="NTC", bidirectional=True,
                                 prefix="vl_"), layer, "NTC", 2),
        "rnn_tanh_ntc": (lambda g: g.rnn.RNN(H, 1, activation="tanh",
                                             layout="NTC", prefix="vr_"),
                         layer, "NTC", 1),
        "lstm_cell_valid_length": (
            lambda g: g.rnn.LSTMCell(H, prefix="vc_"),
            unroll("NTC", lens), "NTC", 2),
        "gru_cell_valid_length_tnc": (
            lambda g: g.rnn.GRUCell(H, prefix="vgc_"),
            unroll("TNC", lens), "TNC", 1),
        "bidirectional_cell": (
            lambda g: g.rnn.BidirectionalCell(
                g.rnn.LSTMCell(H, prefix="vbl_"),
                g.rnn.GRUCell(H, prefix="vbr_")),
            unroll("NTC", lens), "NTC", 3),
        "sequential_residual_cell": (seq, unroll("TNC", merge=False),
                                     "TNC", 3),
    }


def _rnn_variant_run(torch, block, call, x_np, states_np, dev, w_seed,
                     dtype="float32"):
    """Outputs, input gradients and parameter gradients of sum(out * w)
    over every output, recorded on ``dev``."""
    from mxnet_tpu_torch import autograd, nd

    x = nd.array(x_np, ctx=dev, dtype=dtype)
    states = [nd.array(s, ctx=dev, dtype=dtype) for s in states_np]
    for a in [x] + states:
        a.attach_grad()
    with autograd.record():
        out = call(block, nd, x, states)
        flat, stack = [], [out]
        while stack:
            o = stack.pop()
            if isinstance(o, (list, tuple)):
                stack.extend(o)
            else:
                flat.append(o)
        rng = np.random.RandomState(w_seed)
        total = None
        for o in sorted(flat, key=lambda a: a.shape):
            w = nd.array(rng.standard_normal(o.shape).astype(np.float32),
                         ctx=dev, dtype=dtype)
            term = (o * w).sum()
            total = term if total is None else total + term
    total.backward()
    got = {f"out{i}": o.asnumpy() for i, o in enumerate(
        sorted(flat, key=lambda a: a.shape))}
    got.update({f"grad_in{i}": a.grad.asnumpy()
                for i, a in enumerate([x] + states)})
    got.update({k: p.grad().asnumpy() for k, p in
                block.collect_params().items()})
    return got


def phase_rnn_variants(torch, ctx):
    """GRU, bidirectional LSTM, the NTC layout, the cells' ``unroll``
    with ``valid_length`` and the packed ``RNN`` op on the card vs the
    CPU at small widths (T 20, N 8, input 64, hidden 128), from the same
    weights: outputs, states, input and parameter gradients within
    RNN_VAR_TOL of each tensor's max abs of the CPU in f32 and in
    float64, with the f32 CPU's own distance from float64 beside."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.ops import rnn_ops
    from mxnet_tpu_torch.ops.nn import rnn_op

    counted = _det_zero_counters()
    T, B, I, H = (RNN_VAR[k] for k in ("T", "B", "I", "H"))
    rows, ok = {}, True
    for name, (make, call, layout, n_states) in _rnn_variant_blocks().items():
        mx.random.seed(SEED + 30)
        rng = np.random.RandomState(SEED + 31)
        width = H if name.startswith("sequential") else I
        x = rng.uniform(-1, 1, (T, B, width) if layout == "TNC"
                        else (B, T, width)).astype(np.float32)
        cpu_b, card_b, f64_b = make(gluon), make(gluon), make(gluon)
        cpu_b.initialize(mx.init.Uniform(0.1), ctx=mx.cpu())
        card_b.initialize(ctx=mx.gpu(0))
        f64_b.initialize(ctx=mx.cpu())
        info = cpu_b.state_info(B)
        states = [rng.uniform(-0.5, 0.5, i["shape"]).astype(np.float32)
                  for i in info][:n_states]
        # the first call finishes the deferred shapes; then the weights
        # are carried by name
        for blk, dev in ((cpu_b, mx.cpu()), (card_b, mx.gpu(0)),
                         (f64_b, mx.cpu())):
            _rnn_variant_run(torch, blk, call, x, states, dev, 0)
        f64_b.cast("float64")
        for blk in (card_b, f64_b):
            for k, p in blk.collect_params().items():
                p.set_data(cpu_b.collect_params()[k].data()._data)
        cpu = _rnn_variant_run(torch, cpu_b, call, x, states, mx.cpu(), 1)
        f64 = _rnn_variant_run(torch, f64_b, call, x, states, mx.cpu(), 1,
                               "float64")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = _rnn_variant_run(torch, card_b, call, x, states, mx.gpu(0), 1)
        ms = (time.perf_counter() - t0) * 1e3
        def of_max(got, want):
            return max(float(np.abs(got[k] - v).max()
                             / max(np.abs(v).max(), 1e-30))
                       for k, v in want.items())

        errs = {k: of_max({k: card[k]}, {k: v}) for k, v in cpu.items()}
        card64, cpu64 = of_max(card, f64), of_max(cpu, f64)
        row_ok = (sorted(card) == sorted(cpu)
                  and max(errs.values()) <= RNN_VAR_TOL
                  and card64 <= RNN_VAR_TOL)
        rows[name] = {"ms_fwd_bwd": ms, "worst": max(errs, key=errs.get),
                      "worst_of_max_abs": max(errs.values()),
                      "card_vs_float64": card64, "cpu_vs_float64": cpu64,
                      "ok": bool(row_ok)}
        ok = ok and row_ok
    # the packed RNN op: bidirectional 2-layer LSTM over MXNet's flat
    # parameter vector
    rng = np.random.RandomState(SEED + 32)
    _, total = rnn_ops.rnn_packed_layout("lstm", I, H, 2, True)
    args = [rng.uniform(-0.1, 0.1, s).astype(np.float32)
            for s in ((T, B, I), (total,), (4, B, H), (4, B, H))]
    kw = dict(state_size=H, num_layers=2, bidirectional=True, mode="lstm",
              state_outputs=True)

    def packed(dev):
        ts = [torch.from_numpy(a).to(dev).requires_grad_(True) for a in args]
        outs = rnn_op(*ts, **kw)
        loss = sum((o * (i + 1)).sum() for i, o in enumerate(outs))
        grads = torch.autograd.grad(loss, ts)
        return [t.detach().cpu().numpy() for t in list(outs) + list(grads)]

    cpu, card = packed(mx.cpu()), packed(mx.gpu(0))
    args = [a.astype(np.float64) for a in args]
    f64 = packed(mx.cpu())

    def worst(got, want):
        return max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                   for a, b in zip(got, want))

    perr, card64, cpu64 = worst(card, cpu), worst(card, f64), worst(cpu, f64)
    p_ok = perr <= RNN_VAR_TOL and card64 <= RNN_VAR_TOL
    rows["packed_RNN_op_lstm_bi"] = {"worst_of_max_abs": perr,
                                     "card_vs_float64": card64,
                                     "cpu_vs_float64": cpu64,
                                     "ok": bool(p_ok)}
    ok = ok and p_ok
    launches = {n: fn.launches for n, fn in counted.items()}
    ctx.setdefault("launches", {})["rnn_variants"] = launches
    return {"widths": RNN_VAR, "tol_of_max_abs": RNN_VAR_TOL,
            "variants": rows, "launches": launches, "card": ctx["smi"],
            "ok": bool(ok and not any(launches.values()))}


# op_catalog: every registered op card vs CPU.  Floats within OP_TOL of
# the CPU tensor's max abs, by family (0: exact); integer, index, mask
# and order outputs, and every output of the exact families, bit for bit
OP_TOL = {"elemwise": 1e-5, "compare": 0.0, "creation": 1e-7,
          "shape": 1e-6, "reduce": 1e-5, "order": 0.0, "product": 1e-5,
          "linalg": 1e-4, "indexing": 1e-5, "nn": 1e-4, "output": 1e-5,
          "loss": 1e-4, "warp": 1e-4, "contrib": 1e-4, "rnn": 1e-4,
          "optimizer": 1e-6, "quantization": 0.0, "kernel": 1e-4}
OP_RANDOM_N = 1 << 20
# the detection ops, held card vs CPU by the cv_ops phase
OP_ELSEWHERE = ("cv_ops",)


def _cat(op, family, inputs, grad=None, exact=False, post=None, **attrs):
    return {"op": op, "family": family, "inputs": inputs, "grad": grad,
            "exact": exact, "post": post, "attrs": attrs}


def _lq_signs(outs):
    """(Q, L) with L's diagonal made positive (Q's rows and L's columns
    flipped together): an LQ factorization fixes no sign, and the card's
    solver may take others than LAPACK's."""
    q, l_ = outs
    d = l_.diagonal(dim1=-2, dim2=-1)
    sign = d.sign() + (d == 0).to(d.dtype)
    return [q * sign[..., :, None], l_ * sign[..., None, :]]


def _op_catalog(rng):
    """The catalog's cases at sizes the paths use: (1024, 1024)
    elementwise, 1M-element reductions, (1024, 1024) products, batched
    64 x 64 linear algebra, BERT-width per-head ``batch_dot`` (48 x 512 x
    64) and interleaved attention (512 tokens x 8 x 12 heads of 64), a
    (30522, 768) embedding table, ResNet-sized feature maps, and the
    convolution and pooling ops at their 1-D (audio) and 3-D (video)
    ranks too."""
    def U(shape, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def Z(shape, lo=0, hi=3):
        return rng.randint(lo, hi, shape).astype(np.float32)

    M = (1024, 1024)
    c = []
    unary = {
        "relu": (-1, 1), "sigmoid": (-3, 3), "hard_sigmoid": (-4, 4),
        "softsign": (-2, 2), "tanh": (-2, 2), "exp": (-2, 2),
        "expm1": (-1, 1), "log": (0.2, 3), "log2": (0.2, 3),
        "log10": (0.2, 3), "log1p": (-0.5, 2), "sqrt": (0.1, 3),
        "rsqrt": (0.2, 3), "cbrt": (0.2, 3), "rcbrt": (0.2, 3),
        "square": (-2, 2), "abs": (-2, 2), "sign": (-2, 2),
        "floor": (-3, 3), "ceil": (-3, 3), "round": (-3, 3),
        "rint": (-3, 3), "trunc": (-3, 3), "fix": (-3, 3),
        "negative": (-2, 2), "reciprocal": (0.3, 3), "erf": (-2, 2),
        "erfinv": (-0.9, 0.9), "gamma": (0.5, 3), "gammaln": (0.5, 3),
        "digamma": (0.5, 3), "sin": (-3, 3), "cos": (-3, 3),
        "tan": (-1.2, 1.2), "arcsin": (-0.9, 0.9), "arccos": (-0.9, 0.9),
        "arctan": (-3, 3), "sinh": (-2, 2), "cosh": (-2, 2),
        "arcsinh": (-3, 3), "arccosh": (1.2, 3), "arctanh": (-0.9, 0.9),
        "degrees": (-3, 3), "radians": (-90, 90), "identity": (-1, 1),
        "_copy": (-1, 1), "stop_gradient": (-1, 1), "BlockGrad": (-1, 1),
        "make_loss": (-1, 1), "smooth_l1": (-2, 2)}
    c += [_cat(op, "elemwise", [U(M, *dom)]) for op, dom in unary.items()]
    c.append(_cat("logical_not", "compare", [Z(M, -1, 2)]))
    for name in ("add", "sub", "mul", "div", "mod", "power", "maximum",
                 "minimum", "hypot", "plus", "minus"):
        lo = 0.3 if name in ("power", "mod", "div") else -2
        c.append(_cat("broadcast_" + name, "elemwise",
                      [U(M, 0.3 if name == "power" else -2, 2),
                       U((M[0], 1), lo, 2)]))
    for name in ("add", "sub", "mul", "div"):
        c.append(_cat("elemwise_" + name, "elemwise", [U(M), U(M, 0.5, 2)]))
    c += [_cat(n, "elemwise", [U(M), U((1, M[1]))])
          for n in ("maximum", "minimum")]
    for name in ("equal", "not_equal", "greater", "greater_equal",
                 "lesser", "lesser_equal", "logical_and", "logical_or",
                 "logical_xor"):
        c.append(_cat("broadcast_" + name, "compare",
                      [Z(M), Z((M[0], 1))]))
        c.append(_cat(f"_{name}_scalar", "compare", [Z(M)], scalar=1.0))
    for op, (lo, hi, sc) in {
            "_plus_scalar": (-1, 1, 0.7), "_minus_scalar": (-1, 1, 0.7),
            "_rminus_scalar": (-1, 1, 0.7), "_mul_scalar": (-1, 1, -1.3),
            "_div_scalar": (-1, 1, 0.7), "_rdiv_scalar": (0.3, 2, 1.7),
            "_mod_scalar": (-3, 3, 0.7), "_rmod_scalar": (0.3, 2, 3.3),
            "_power_scalar": (0.3, 2, 2.5), "_rpower_scalar": (-1, 1, 1.7),
            "_maximum_scalar": (-1, 1, 0.2),
            "_minimum_scalar": (-1, 1, 0.2)}.items():
        c.append(_cat(op, "elemwise", [U(M, lo, hi)], scalar=sc))
    c += [
        _cat("clip", "elemwise", [U(M, -2, 2)], a_min=-0.3, a_max=0.4),
        _cat("add_n", "elemwise", [U(M), U(M), U(M)], num_args=3),
        _cat("ElementWiseSum", "elemwise", [U(M), U(M)], num_args=2),
        _cat("Cast", "compare", [U(M, -3, 3)], dtype="int32"),
        _cat("Cast", "compare", [U(M, -3, 3)], dtype="float16"),
        _cat("all_finite", "compare", [U(M)]),
        _cat("multi_all_finite", "compare", [U(M), U((7,))], num_arrays=2),
        _cat("digamma", "elemwise", [U(M, 0.5, 3)]),
    ]
    # creation
    c += [_cat("_zeros", "creation", [], shape=M),
          _cat("_ones", "creation", [], shape=M, dtype="int32"),
          _cat("_full", "creation", [], shape=M, value=2.5),
          _cat("_arange", "creation", [], start=0.0, stop=1e6, step=1.0,
               repeat=2),
          _cat("_eye", "creation", [], N=1024, M=2048, k=3),
          _cat("_linspace", "creation", [], start=-1.0, stop=1.0,
               num=1 << 20),
          _cat("zeros_like", "creation", [U(M)]),
          _cat("ones_like", "creation", [U(M)])]
    # reductions and orders
    R = (64, 128, 128)
    for op in ("sum", "mean", "max", "min", "nansum"):
        c.append(_cat(op, "reduce", [U(R)], axis=(0, 2)))
        c.append(_cat(op, "reduce", [U(R)], axis=1, keepdims=True))
    c += [_cat(op, "reduce", [U(R, 0.995, 1.005)], axis=2)
          for op in ("prod", "nanprod")]
    c += [_cat(op, "reduce", [U(R)], axis=2)
          for op in ("sum_axis", "max_axis", "min_axis")]
    c += [_cat("norm", "reduce", [U(R)], axis=(1, 2)),
          _cat("norm", "reduce", [U(R)], ord=1, axis=2),
          _cat("L2Normalization", "reduce", [U((64, 256, 8, 8))],
               mode="channel"),
          _cat("logsumexp", "reduce", [U(R)], axis=2)]
    T_ = Z(M, 0, 50)  # ties
    c += [_cat("argmax", "order", [T_], axis=1),
          _cat("argmin", "order", [T_], axis=0),
          _cat("argmax_channel", "order", [T_]),
          _cat("topk", "order", [T_], k=10, ret_typ="both"),
          _cat("sort", "order", [T_], is_ascend=False),
          _cat("argsort", "order", [T_], is_ascend=False)]
    # shape moves
    X = U(R)
    c += [_cat("reshape", "shape", [X], shape=(-3, 0)),
          _cat("Reshape", "shape", [X], shape=(0, -4, 2, -1, -2)),
          _cat("Flatten", "shape", [X]),
          _cat("transpose", "shape", [X], axes=(2, 0, 1)),
          _cat("expand_dims", "shape", [X], axis=1),
          _cat("squeeze", "shape", [U((64, 1, 128, 1))]),
          _cat("swapaxes", "shape", [X], dim1=0, dim2=2),
          _cat("SwapAxis", "shape", [X], dim1=1, dim2=2),
          _cat("flip", "shape", [X], axis=1),
          _cat("reverse", "shape", [X], axis=(0, 2)),
          _cat("tile", "shape", [U((64, 128))], reps=(4, 2)),
          _cat("repeat", "shape", [U((64, 128))], repeats=3, axis=0),
          _cat("broadcast_to", "shape", [U((1, 128, 1))], shape=(64, 0, 128)),
          _cat("broadcast_like", "shape", [U((1, 128, 1)), X], grad=(0,)),
          _cat("broadcast_axis", "shape", [U((1, 128, 1))], axis=(0, 2),
               size=(64, 128)),
          _cat("Concat", "shape", [X, X, X], dim=1, num_args=3),
          _cat("stack", "shape", [X, X], axis=1, num_args=2),
          _cat("split", "shape", [X], num_outputs=4, axis=1),
          _cat("SliceChannel", "shape", [X], num_outputs=2, axis=0),
          _cat("split_v2", "shape", [X], indices_or_sections=(10, 70),
               axis=2),
          _cat("slice", "shape", [X], begin=(None, 100), end=(None, 5),
               step=(None, -3)),
          _cat("slice_axis", "shape", [X], axis=2, begin=5, end=100),
          _cat("slice_like", "shape", [X, U((32, 64))], grad=(0,)),
          _cat("pad", "shape", [U((32, 64, 28, 28))], mode="reflect",
               pad_width=(0, 0, 0, 0, 2, 2, 1, 3)),
          _cat("Pad", "shape", [U((32, 64, 28, 28))], mode="edge",
               pad_width=(0, 0, 0, 0, 2, 2, 1, 3)),
          _cat("Crop", "shape", [U((32, 64, 28, 28))], h_w=(20, 20),
               center_crop=True),
          _cat("depth_to_space", "shape", [U((32, 64, 28, 28))],
               block_size=2),
          _cat("space_to_depth", "shape", [U((32, 16, 56, 56))],
               block_size=2),
          _cat("diag", "shape", [U((64, 512, 512))], k=1),
          _cat("shape_array", "shape", [X]),
          _cat("size_array", "shape", [X]),
          _cat("zeros_like_legacy", "shape", [X]),
          _cat("reshape_like", "shape", [X, U((8192, 128))], grad=(0,)),
          _cat("where", "shape", [Z(M, 0, 2), U(M), U(M)], grad=(1, 2)),
          _cat("cumsum", "reduce", [U(M)], axis=1)]
    # products and linear algebra (TF32 off)
    c += [_cat("dot", "product", [U(M), U(M)]),
          _cat("dot", "product", [U(M), U(M)], transpose_a=True,
               transpose_b=True),
          _cat("batch_dot", "product", [U((48, 512, 64)),
                                        U((48, 512, 64))],
               transpose_b=True),
          _cat("khatri_rao", "product", [U((64, 256)), U((32, 256))]),
          _cat("linalg_gemm2", "product", [U((256, 64, 64)),
                                           U((256, 64, 64))], alpha=0.5),
          _cat("linalg_gemm", "product", [U((256, 64, 64)),
                                          U((256, 64, 64)),
                                          U((256, 64, 64))], beta=2.0),
          _cat("linalg_syrk", "product", [U((256, 64, 64))])]
    eye = np.eye(64, dtype=np.float32)
    A = U((256, 64, 64), -0.05, 0.05) + eye
    L = np.tril(A)
    S = A @ A.transpose(0, 2, 1)
    c += [_cat("linalg_potrf", "linalg", [S]),
          _cat("linalg_potri", "linalg", [L[0]]),
          _cat("linalg_trsm", "linalg", [L, U((256, 64, 32))]),
          _cat("linalg_trmm", "linalg", [A, U((256, 64, 32))],
               lower=False),
          _cat("linalg_sumlogdiag", "linalg", [S]),
          _cat("linalg_extractdiag", "linalg", [A]),
          _cat("linalg_makediag", "linalg", [U((256, 64))]),
          _cat("linalg_inverse", "linalg", [A]),
          _cat("linalg_det", "linalg", [A]),
          _cat("linalg_slogdet", "linalg", [A]),
          _cat("linalg_gelqf", "linalg", [U((256, 32, 64))],
               post=_lq_signs)]
    # indexing (BERT's embedding table and token batch)
    ids = Z((32, 512), 0, 30522)
    c += [_cat("Embedding", "indexing", [ids, U((30522, 768))], grad=(1,),
               input_dim=30522, output_dim=768),
          _cat("take", "indexing", [U((30522, 768)), ids], grad=(0,)),
          _cat("take", "indexing", [U((768, 30522)), ids], grad=(0,),
               axis=1, mode="wrap"),
          _cat("pick", "indexing", [U((4096, 1000)), Z((4096,), 0, 1000)],
               grad=(0,)),
          _cat("batch_take", "indexing", [U((4096, 1000)),
                                          Z((4096,), 0, 1000)], grad=(0,)),
          _cat("choose_element_0index", "indexing",
               [U((4096, 1000)), Z((4096,), 0, 1000)]),
          _cat("fill_element_0index", "indexing",
               [U((4096, 1000)), U((4096,)), Z((4096,), 0, 1000)]),
          _cat("onehot_encode", "indexing", [Z((4096,), 0, 1000),
                                             U((4096, 1000))]),
          _cat("one_hot", "indexing", [Z((4096,), -1, 1001)], depth=1000)]
    flat = rng.permutation(64 * 128 * 128)[:65536]
    nd_idx = np.stack(np.unravel_index(flat, R)).astype(np.float32)
    c += [_cat("gather_nd", "indexing", [X, nd_idx], grad=(0,)),
          _cat("scatter_nd", "indexing", [U((65536,)), nd_idx], grad=(0,),
               shape=R),
          _cat("_scatter_set_nd", "indexing", [X, nd_idx, U((65536,))],
               grad=(0, 2), shape=R),
          _cat("_ravel_multi_index", "indexing", [nd_idx], shape=R),
          _cat("ravel_multi_index", "indexing", [nd_idx], shape=R),
          _cat("_unravel_index", "indexing", [flat.astype(np.float32)],
               shape=R),
          _cat("unravel_index", "indexing", [flat.astype(np.float32)],
               shape=R),
          _cat("boolean_mask", "indexing", [U((4096, 256)),
                                            Z((4096,), 0, 2)])]
    seq = U((128, 64, 512))
    lens = Z((64,), 1, 129)
    for op in ("SequenceMask", "SequenceLast", "SequenceReverse"):
        c.append(_cat(op, "indexing", [seq, lens], grad=(0,),
                      use_sequence_length=True))
    # layers
    img = U((32, 64, 28, 28))
    aud, vid = U((16, 64, 4000)), U((4, 32, 8, 28, 28))
    c += [_cat("Deconvolution", "nn", [img, U((64, 32, 4, 4), -0.1, 0.1),
                                       U((32,))],
               kernel=(4, 4), stride=(2, 2), pad=(1, 1), num_filter=32,
               no_bias=False),
          _cat("softmin", "nn", [U((4096, 1000))], axis=-1),
          _cat("SoftmaxActivation", "nn", [img], mode="channel"),
          _cat("InstanceNorm", "nn", [img, U((64,)), U((64,))]),
          _cat("GroupNorm", "nn", [img, U((64,)), U((64,))], num_groups=8),
          _cat("LRN", "nn", [img], nsize=5),
          _cat("UpSampling", "nn", [img], scale=2),
          _cat("UpSampling", "nn", [img], scale=2, sample_type="bilinear"),
          _cat("BilinearResize2D", "nn", [img], height=19, width=45),
          _cat("moments", "nn", [img], axes=(0, 2, 3)),
          _cat("im2col", "nn", [img], kernel=(3, 3), pad=(1, 1)),
          _cat("col2im", "nn", [U((32, 64 * 9, 784))], output_size=(28, 28),
               kernel=(3, 3), pad=(1, 1)),
          _cat("FullyConnected", "product", [U((4096, 768)),
                                             U((3072, 768)), U((3072,))],
               num_hidden=3072),
          _cat("Convolution", "nn", [img, U((64, 64, 3, 3), -0.1, 0.1)],
               kernel=(3, 3), pad=(1, 1), num_filter=64, no_bias=True),
          _cat("Pooling", "nn", [img], kernel=(3, 3), stride=(2, 2),
               pad=(1, 1), pool_type="max"),
          # the 1-D and 3-D ranks: audio (16, 64, 4000), video (4, 32, 8,
          # 28, 28) blocks
          _cat("Convolution", "nn", [aud, U((64, 32, 3), -0.1, 0.1)],
               kernel=(3,), pad=(2,), dilate=(2,), num_filter=64,
               num_group=2, no_bias=True),
          _cat("Convolution", "nn", [vid, U((32, 32, 3, 3, 3), -0.1, 0.1),
                                     U((32,))],
               kernel=(3, 3, 3), pad=(1, 1, 1), num_filter=32),
          _cat("Deconvolution", "nn", [aud, U((64, 32, 4), -0.1, 0.1)],
               kernel=(4,), stride=(2,), pad=(1,), adj=(1,),
               num_filter=32),
          _cat("Deconvolution", "nn", [vid, U((32, 16, 3, 3, 3), -0.1, 0.1)],
               kernel=(3, 3, 3), stride=(2, 2, 2), pad=(1, 1, 1),
               adj=(1, 1, 1), num_filter=16),
          _cat("Pooling", "nn", [aud], kernel=(3,), stride=(2,), pad=(1,),
               pool_type="lp", p_value=2),
          _cat("Pooling", "nn", [vid], kernel=(3, 3, 3), stride=(2, 2, 2),
               pool_type="avg", pooling_convention="full",
               count_include_pad=False),
          _cat("im2col", "nn", [aud[:4, :16]], kernel=(5,), stride=(2,),
               pad=(2,)),
          _cat("im2col", "nn", [vid[:2, :8]], kernel=(3, 3, 3),
               pad=(1, 1, 1)),
          _cat("col2im", "nn", [U((4, 16 * 5, 2000))], output_size=(4000,),
               kernel=(5,), stride=(2,), pad=(2,)),
          _cat("col2im", "nn", [U((2, 8 * 27, 8 * 28 * 28))],
               output_size=(8, 28, 28), kernel=(3, 3, 3), pad=(1, 1, 1)),
          _cat("Activation", "elemwise", [U(M)], act_type="softrelu"),
          _cat("LeakyReLU", "elemwise", [U(M)], act_type="gelu"),
          _cat("softmax", "nn", [U((4096, 1000))]),
          _cat("log_softmax", "nn", [U((4096, 1000))]),
          _cat("BatchNorm", "nn", [img, U((64,)), U((64,)), U((64,)),
                                   U((64,), 0.5, 1.5)], fix_gamma=False,
               training=True, grad=(0, 1, 2)),
          _cat("LayerNorm", "kernel", [U((4096, 768)), U((768,)),
                                       U((768,))]),
          _cat("_contrib_add_layer_norm", "nn", [U((4096, 768)),
                                                 U((4096, 768)), U((768,)),
                                                 U((768,))]),
          _cat("_contrib_flash_attention", "kernel",
               [U((48, 512, 64)), U((48, 512, 64)), U((48, 512, 64))],
               causal=True)]
    logits = U((4096, 1000), -2, 2)
    lab = Z((4096,), 0, 1000)
    c += [_cat("SoftmaxOutput", "output", [logits, lab], grad=(0,),
               use_ignore=True, ignore_label=3.0, normalization="valid"),
          _cat("softmax_cross_entropy", "output", [logits, lab],
               grad=(0,)),
          _cat("SVMOutput", "output", [logits, lab], grad=(0,)),
          _cat("MakeLoss", "output", [U(M)], normalization="batch")]
    c += [_cat(op, "output", [U(M), U(M)], grad=(0,))
          for op in ("LinearRegressionOutput", "MAERegressionOutput",
                     "LogisticRegressionOutput")]
    # CTC at a speech-recognition shape: 100 frames, batch 32, 30 symbols,
    # label lengths 5-30 (blank last, -1 pads)
    lab_len = rng.randint(5, 31, 32)
    ctc_lab = np.full((32, 30), -1, np.float32)
    for b, n in enumerate(lab_len):
        ctc_lab[b, :n] = rng.randint(0, 29, n)
    c.append(_cat("ctc_loss", "loss", [U((100, 32, 30), -2, 2), ctc_lab],
                  grad=(0,), blank_label="last"))
    # warping
    c += [_cat("BilinearSampler", "warp", [U((32, 64, 32, 32)),
                                           U((32, 2, 32, 32), -1.1, 1.1)]),
          _cat("GridGenerator", "warp", [U((32, 6))], target_shape=(64, 64)),
          _cat("GridGenerator", "warp", [U((32, 2, 64, 64), -3, 3)],
               transform_type="warp"),
          _cat("SpatialTransformer", "warp",
               [U((32, 64, 32, 32)),
                np.float32([1, 0, 0, 0, 1, 0]) + U((32, 6), -0.2, 0.2)],
               target_shape=(24, 24)),
          _cat("Correlation", "warp", [U((4, 64, 48, 64)),
                                       U((4, 64, 48, 64))],
               max_displacement=8, stride2=2, pad_size=8)]
    # contrib
    qkv = U((512, 8, 3 * 12 * 64), -0.5, 0.5)
    c += [_cat("_contrib_interleaved_matmul_selfatt_qk", "contrib", [qkv],
               heads=12),
          _cat("_contrib_interleaved_matmul_selfatt_valatt", "contrib",
               [qkv, U((96, 512, 512), 0, 0.01)], heads=12),
          _cat("_contrib_AdaptiveAvgPooling2D", "contrib",
               [U((32, 512, 7, 7))], output_size=(3, 3)),
          _cat("_contrib_DeformableConvolution", "contrib",
               [U((2, 64, 32, 32)), U((2, 18, 32, 32)),
                U((64, 64, 3, 3), -0.1, 0.1)], kernel=(3, 3), pad=(1, 1),
               num_filter=64, no_bias=True),
          _cat("histogram", "reduce", [U((1 << 20,))], bin_cnt=100,
               range=(-1.0, 1.0))]
    # recurrences at the language model's width
    H, I_ = 650, 650
    lw = []
    for layer in range(2):
        lw += [U((4 * H, I_ if layer == 0 else H), -0.05, 0.05),
               U((4 * H, H), -0.05, 0.05), U((4 * H,), -0.05, 0.05),
               U((4 * H,), -0.05, 0.05)]
    c += [_cat("_fused_rnn", "rnn", [U((35, 20, I_)), U((2, 20, H)),
                                     U((2, 20, H))] + lw,
               state_size=H, num_layers=2),
          _cat("_begin_state_zeros", "rnn", [U((20, 650))], num_hidden=650),
          _cat("_begin_state_zeros_layers", "rnn", [U((35, 20, 650))],
               num_hidden=650, num_layers=2)]
    from mxnet_tpu_torch.ops.rnn_ops import rnn_packed_layout

    _, total = rnn_packed_layout("gru", 256, 256, 2, True)
    c.append(_cat("RNN", "rnn", [U((35, 20, 256)), U((total,), -0.06, 0.06),
                                 U((4, 20, 256))],
                  state_size=256, num_layers=2, bidirectional=True,
                  mode="gru", state_outputs=True))
    # optimizer updates on a (1024, 1024) parameter
    W, G = U(M), U(M, -0.1, 0.1)

    def P():
        return U(M, 0.0, 1.0)

    W16, G16 = W.astype(np.float16), G.astype(np.float16)
    c += [_cat("sgd_update", "optimizer", [W, G], lr=0.1, wd=1e-4),
          _cat("sgd_mom_update", "optimizer", [W, G, P()], momentum=0.9),
          _cat("mp_sgd_update", "optimizer", [W16, G16, W]),
          _cat("mp_sgd_mom_update", "optimizer", [W16, G16, P(), W],
               momentum=0.9),
          _cat("nag_mom_update", "optimizer", [W, G, P()], momentum=0.9),
          _cat("adam_update", "optimizer", [W, G, P(), P()], wd=1e-4),
          _cat("mp_adam_update", "optimizer", [W16, G16, P(), P(), W]),
          _cat("ftrl_update", "optimizer", [W, G, P(), P()]),
          _cat("signsgd_update", "optimizer", [W, G]),
          _cat("signum_update", "optimizer", [W, G, P()], momentum=0.9),
          _cat("rmsprop_update", "optimizer", [W, G, P()]),
          _cat("rmspropalex_update", "optimizer",
               [W, G, P() + 1.0, U(M, -0.1, 0.1), P()]),
          _cat("adagrad_update", "optimizer", [W, G, P()]),
          _cat("adadelta_update", "optimizer", [W, G, P(), P()]),
          _cat("lamb_update_phase1", "optimizer", [W, G, P(), P()], t=3),
          _cat("lamb_update_phase2", "optimizer",
               [W, G, U((1,), 0.5, 1), U((1,), 0.5, 1)]),
          _cat("multi_sgd_update", "optimizer", [W, G, W, G],
               lrs=(0.1, 0.2), wds=(0.0, 1e-4), num_weights=2),
          _cat("multi_sgd_mom_update", "optimizer", [W, G, P(), W, G, P()],
               lrs=(0.1, 0.2), wds=(0.0, 1e-4), momentum=0.9,
               num_weights=2),
          _cat("multi_mp_sgd_update", "optimizer", [W16, G16, W] * 2,
               lrs=(0.1, 0.2), wds=(0.0, 1e-4), num_weights=2),
          _cat("multi_mp_sgd_mom_update", "optimizer",
               [W16, G16, P(), W] * 2, lrs=(0.1, 0.2), wds=(0.0, 1e-4),
               momentum=0.9, num_weights=2),
          _cat("preloaded_multi_sgd_update", "optimizer",
               [W, G, W, G, np.float32([0.1, 0.2]), np.float32([0, 1e-4])],
               num_weights=2),
          _cat("preloaded_multi_sgd_mom_update", "optimizer",
               [W, G, P(), W, G, P(), np.float32([0.1, 0.2]),
                np.float32([0, 1e-4])], momentum=0.9, num_weights=2)]
    # int8 / int4 serving ops
    q8 = rng.randint(-127, 128, (256, 1024)).astype(np.int8)
    w8 = rng.randint(-127, 128, (1024, 1024)).astype(np.int8)
    rmin, rmax = np.float32([-2.0]), np.float32([2.0])
    c += [_cat("_contrib_quantize_v2", "quantization", [U((4096, 1024))]),
          _cat("_contrib_quantize_v2", "quantization", [U((4096, 1024))],
               min_calib_range=-0.8, max_calib_range=0.9),
          _cat("_contrib_dequantize", "quantization", [q8, rmin, rmax]),
          _cat("_contrib_requantize", "quantization",
               [rng.randint(-2 ** 30, 2 ** 30, (4096, 1024)).astype(
                   np.int32), rmin, rmax]),
          _cat("_contrib_dequantize_int4", "quantization",
               [rng.randint(0, 256, (1024, 512)).astype(np.uint8),
                U((1024, 32), 0.01, 0.1)], group_size=32, cols=1024),
          _cat("_contrib_quantized_fully_connected", "quantization",
               [q8, w8, U((1024,)), rmin, rmax, rmin, rmax],
               num_hidden=1024),
          _cat("_contrib_quantized_conv", "quantization",
               [rng.randint(-127, 128, (8, 64, 28, 28)).astype(np.int8),
                rng.randint(-127, 128, (64, 64, 3, 3)).astype(np.int8),
                U((64,)), rmin, rmax, rmin, rmax], kernel=(3, 3),
               pad=(1, 1), num_filter=64)]
    return c


def _catalog_run(torch, op, case, device, seed):
    """(outputs, gradients) of one case on ``device``: where the op is
    differentiable, the gradient of a seeded random cotangent with respect
    to the case's float inputs."""
    fn = op.fn
    ts = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
          for a in case["inputs"]]
    gi = case["grad"]
    if gi is None:
        gi = [i for i, t in enumerate(ts) if t.is_floating_point()]
    if not op.differentiable:
        gi = []
    for i in gi:
        ts[i].requires_grad_(True)
    with torch.device(device), torch.set_grad_enabled(bool(gi)):
        out = fn(*ts, **case["attrs"])
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    if case["post"] is not None:
        outs = case["post"](outs)
    diff = [o for o in outs if o.requires_grad]
    grads = []
    if gi and diff:
        g = torch.Generator().manual_seed(seed)
        cts = [torch.randn(o.shape, generator=g, dtype=torch.float32).to(
            device=device, dtype=o.dtype) for o in diff]
        grads = [torch.zeros_like(ts[i]) if d is None else d for i, d in zip(
            gi, torch.autograd.grad(diff, [ts[i] for i in gi], cts,
                                    allow_unused=True))]
    return ([o.detach() for o in outs], [d.detach() for d in grads])


def _catalog_error(card, cpu, exact):
    """Exactness, or the largest |card - cpu| over the CPU tensor's max
    abs."""
    card = card.cpu()
    if exact or not cpu.is_floating_point():
        return None, bool(card.dtype == cpu.dtype and card.shape == cpu.shape
                          and card.equal(cpu))
    scale = float(cpu.double().abs().max()) if cpu.numel() else 0.0
    err = float((card.double() - cpu.double()).abs().max()) \
        if cpu.numel() else 0.0
    return err / max(scale, 1e-30), card.dtype == cpu.dtype


# the random ops: attributes, the distribution's mean and variance, its
# support
OP_RANDOM = {
    "_random_uniform": (dict(low=-1.0, high=3.0), 1.0, 16 / 12,
                        lambda x: (x >= -1).all() and (x < 3).all()),
    "_random_normal": (dict(loc=1.0, scale=2.0), 1.0, 4.0, None),
    "_random_gamma": (dict(alpha=2.5, beta=0.5), 1.25, 0.625,
                      lambda x: (x > 0).all()),
    "_random_exponential": (dict(lam=2.0), 0.5, 0.25,
                            lambda x: (x >= 0).all()),
    "_random_poisson": (dict(lam=3.0), 3.0, 3.0,
                        lambda x: (x >= 0).all() and (x == x.round()).all()),
    "_random_randint": (dict(low=-2, high=5, dtype="int32"), 1.0, 4.0,
                        lambda x: (x >= -2).all() and (x < 5).all()),
    "_random_negative_binomial": (
        dict(k=3, p=0.4), 4.5, 11.25,
        lambda x: (x >= 0).all() and (x == x.round()).all()),
    "_random_generalized_negative_binomial": (
        dict(mu=2.0, alpha=0.5), 2.0, 4.0,
        lambda x: (x >= 0).all() and (x == x.round()).all()),
}


def _moments(x, mean, var):
    """|mean - mean0| and |var - var0| in standard errors estimated from
    the sample."""
    x = x.double().reshape(-1)
    n = x.numel()
    m, v = float(x.mean()), float(x.var(unbiased=False))
    m4 = float(((x - m) ** 4).mean())
    return (abs(m - mean) / math.sqrt(v / n),
            abs(v - var) / math.sqrt(max(m4 - v * v, 1e-12) / n))


def _catalog_random(torch, registry, dev):
    """Each random op on the card ``dev``: its shape and dtype, support,
    mean and variance within 5 standard errors of the distribution's, the
    same draws from the same seed and others from another."""
    n = OP_RANDOM_N
    rows, ok = {}, True

    def draw(op, seed, *inputs, **attrs):
        g = torch.Generator(device=dev).manual_seed(seed)
        with torch.device(dev):
            return registry.get_op(op).fn(*inputs, generator=g, **attrs)

    for op, (attrs, mean, var, support) in OP_RANDOM.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = draw(op, 1, shape=(n,), **attrs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        sm, sv = _moments(x.cpu(), mean, var)
        row_ok = (tuple(x.shape) == (n,) and x.device == dev
                  and (support is None or bool(support(x)))
                  and sm < 5 and sv < 5
                  and torch.equal(x, draw(op, 1, shape=(n,), **attrs))
                  and not torch.equal(x, draw(op, 2, shape=(n,), **attrs)))
        rows[op] = {"ms": ms, "dtype": str(x.dtype), "mean_se": sm,
                    "var_se": sv, "ok": bool(row_ok)}
        ok = ok and row_ok
    low = torch.tensor([0.0, -2.0, 5.0], device=dev)
    high = torch.tensor([1.0, 2.0, 5.5], device=dev)
    u = draw("sample_uniform", 3, low, high, shape=(n,))
    z = draw("sample_normal", 3, low, high, shape=(n,))
    se = [max(_moments(u[i].cpu(), float((low[i] + high[i]) / 2),
                       float((high[i] - low[i]) ** 2 / 12)))
          for i in range(3)]
    se_z = [max(_moments(z[i].cpu(), float(low[i]), float(high[i] ** 2)))
            for i in range(3)]
    r_ok = (u.shape == (3, n) and bool((u >= low[:, None]).all())
            and max(se) < 5 and max(se_z) < 5
            and torch.equal(z, draw("sample_normal", 3, low, high,
                                    shape=(n,))))
    rows["sample_uniform"] = {"se": max(se), "ok": bool(r_ok)}
    rows["sample_normal"] = {"se": max(se_z), "ok": bool(r_ok)}
    p = torch.softmax(torch.randn(16, 1000, generator=torch.Generator()
                                  .manual_seed(4)), -1).to(dev)
    idx, logp = draw("_sample_multinomial", 5, p[0], shape=(1 << 16,),
                     get_prob=True)
    freq = torch.bincount(idx.long(), minlength=1000).double().cpu() \
        / (1 << 16)
    p0 = p[0].double().cpu()
    z_freq = float(((freq - p0).abs() / (p0 * (1 - p0) / (1 << 16)).sqrt()
                    ).max())
    rows_idx = draw("_sample_multinomial", 5, p, shape=(64,))
    m_ok = (z_freq < 6 and rows_idx.shape == (16, 64)
            and torch.allclose(logp, p[0].log()[idx.long()], rtol=1e-5)
            and torch.equal(rows_idx, draw("_sample_multinomial", 5, p,
                                           shape=(64,))))
    rows["_sample_multinomial"] = {"max_freq_se": z_freq, "ok": bool(m_ok)}
    data = torch.arange(1 << 20, device=dev, dtype=torch.float32)
    sh = draw("_shuffle", 6, data)
    s_ok = (torch.equal(sh.sort().values, data)
            and not torch.equal(sh, data)
            and torch.equal(sh, draw("_shuffle", 6, data)))
    rows["_shuffle"] = {"ok": bool(s_ok)}
    ones = torch.ones((1024, 1024), device=dev)
    d = draw("Dropout", 7, ones, p=0.5, training=True)
    kept = float((d != 0).float().mean())
    d_ok = (abs(kept - 0.5) < 5 * math.sqrt(0.25 / d.numel())
            and bool(((d == 0) | (d == 2)).all())
            and torch.equal(d, draw("Dropout", 7, ones, p=0.5,
                                    training=True)))
    rows["Dropout"] = {"kept": kept, "ok": bool(d_ok)}
    ok = ok and r_ok and m_ok and s_ok and d_ok
    return rows, ok


def phase_op_catalog(torch, ctx):
    """Every op of the port's registry on the card vs the CPU port at
    realistic sizes (``_op_catalog``), forward and, where the op is
    differentiable, the gradient of a seeded cotangent; random ops by
    shape, support, moments and repeatability; card ms by family."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry

    dev = mx.gpu(0)
    t_phase = time.perf_counter()
    rng = np.random.RandomState(SEED + 40)
    cases = _op_catalog(rng)
    spent = {"make_inputs_s": time.perf_counter() - t_phase, "cpu_s": 0.0,
             "card_first_call_s": 0.0, "card_timed_s": 0.0}
    rows, fams, ok = {}, {}, True
    for i, case in enumerate(cases):
        op = registry.get_op(case["op"])
        fam = case["family"]
        tol = OP_TOL[fam]
        exact = case["exact"] or tol == 0.0
        t0 = time.perf_counter()
        cpu_out, cpu_grads = _catalog_run(torch, op, case, mx.cpu(), i)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        _catalog_run(torch, op, case, dev, i)  # warm-up
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        card_out, card_grads = _catalog_run(torch, op, case, dev, i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        spent["cpu_s"] += cpu_ms / 1e3
        spent["card_first_call_s"] += first_ms / 1e3
        spent["card_timed_s"] += ms / 1e3
        errs, unequal = [], []
        for j, (a, b) in enumerate(zip(card_out + card_grads,
                                       cpu_out + cpu_grads)):
            err, match = _catalog_error(a, b, exact)
            if not (match and a.shape == b.shape):
                unequal.append(j)
            if err is not None:
                errs.append(err)
        same = not unequal
        worst = max(errs) if errs else 0.0
        row_ok = (same and len(card_out) == len(cpu_out)
                  and len(card_grads) == len(cpu_grads)
                  and all(o.device == dev for o in card_out)
                  and worst <= tol)
        key = case["op"] if case["op"] not in rows else f"{case['op']}#{i}"
        rows[key] = {"family": fam, "ms": ms, "cpu_ms": cpu_ms,
                     "first_call_ms": first_ms,
                     "of_max_abs": worst, "grads": len(card_grads),
                     "ok": bool(row_ok)}
        if unequal:
            rows[key]["unequal_outputs"] = unequal
        f = fams.setdefault(fam, {"ops": 0, "card_ms": 0.0, "worst": 0.0,
                                  "failed": []})
        f["ops"] += 1
        f["card_ms"] += ms
        f["worst"] = max(f["worst"], worst)
        if not row_ok:
            f["failed"].append(key)
        ok = ok and row_ok
    t0 = time.perf_counter()
    random_rows, random_ok = _catalog_random(torch, registry, dev)
    spent["random_s"] = time.perf_counter() - t0
    covered = ({c["op"] for c in cases} | set(OP_RANDOM)
               | {"sample_uniform", "sample_normal", "_sample_multinomial",
                  "_shuffle", "Dropout"} | set(DET_OPS))
    missing = sorted(set(registry.list_ops()) - covered)
    return {"tol_of_max_abs": OP_TOL, "families": fams,
            "cases": len(cases), "registry_ops": len(registry.list_ops()),
            "not_run": missing, "detection_ops_in": "cv_ops",
            "time_spent": spent,
            "random": random_rows, "ops": rows, "card": ctx["smi"],
            "ok": bool(ok and random_ok and not missing)}


# ---------------------------------------------------------------------------
# the symbolic API: BERT-base through mx.mod.Module, MXNet's bucketing LSTM
# through BucketingModule, and the executor / SymbolBlock / checkpoints
# card vs CPU
# ---------------------------------------------------------------------------
MB_WARMUP, MB_STEPS = 2, 5
# the Module's first step against the Gluon route's on the same weights and
# batch, both on the card (the loss relative; the gradients, relative L2
# over the model and in the worst tensor; Gluon's summed per-token
# gradient over the tokens against SoftmaxOutput's batch-normalized one)
SYM_PARITY_TOL = {"loss_rel": 1e-5, "grad_rel_model": 1e-5,
                  "grad_rel_tensor": 1e-3}
# MXNet 1.x example/rnn/bucketing/lstm_bucketing.py at its defaults
LB = {"buckets": [10, 20, 30, 40, 50, 60], "batch": 32, "embed": 200,
      "hidden": 200, "layers": 2, "vocab": 10000, "lr": 0.01, "mom": 0.0,
      "wd": 1e-5, "invalid_label": 0, "disp_batches": 50}
LB_SENTENCES = 2400          # about 75 batches an epoch, every bucket
LB_ZIPF_A = 1.2
LB_PARITY_TOL = 1e-4         # card vs CPU, of each tensor's max abs
# the last 10 batches' mean perplexity must be below the uniform model's,
# the vocabulary size: a run that diverged and fell back a little fails
LB_PPL_BOUND = float(LB["vocab"])
SYM_API_TOL = 1e-4           # card vs CPU, of each tensor's max abs


def _max_abs_ratio(got, want):
    """max |got - want| / max |want| over numpy arrays."""
    scale = float(np.abs(want).max()) or 1.0
    return float(np.abs(got - want).max()) / scale


def _mlm_module(mx, body, dev, batch, length):
    """The MLM head on an exported BERT graph: SoftmaxOutput over the
    (B*T, V) reshape, normalized by the batch (the gradient of the mean
    per-token cross-entropy), bound through Module on ``dev``."""
    head = mx.sym.SoftmaxOutput(mx.sym.Reshape(body, shape=(-1, BERT_VOCAB)),
                                normalization="batch", name="softmax")
    mod = mx.mod.Module(head, context=dev)
    mod.bind(data_shapes=[("data", (batch, length))],
             label_shapes=[("softmax_label", (batch * length,))])
    return mod


def _softmax_loss(torch, probs, label):
    """Mean -log p[label] of SoftmaxOutput's probabilities (a device
    scalar)."""
    p = probs._data.gather(1, label._data.long().reshape(-1, 1))
    return -torch.log(p).mean()


def phase_module_bert(torch, ctx):
    """BERT-base exported by the port's ``HybridBlock.export``, loaded
    with ``sym.load`` / ``nd.load`` and trained through ``mx.mod.Module``
    at the train cell's batch and optimizer (32 x 512, Adam lr 1e-4, f32,
    TF32 off): the first step against the Gluon route, then 2 warm-up and
    5 timed ``forward_backward`` + ``update`` steps with the counters
    zeroed just before."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.models.bert import bert_base
    from mxnet_tpu_torch.symbol.symbol import _topo_order

    torch.cuda.empty_cache()
    dev = mx.gpu(0)
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, "build", f"module_bert-{os.getpid()}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    net = bert_base(BERT_VOCAB, dropout=0.0,
                    generator=torch.Generator().manual_seed(SEED + 15))
    t0 = time.perf_counter()
    net.export(path, 0)
    export_s = time.perf_counter() - t0
    tokens = np.random.RandomState(SEED + 15).randint(
        0, BERT_VOCAB, (TRAIN_BATCH, TRAIN_LEN)).astype(np.int32)
    n_tok = tokens.size
    data = nd.array(tokens, ctx=dev, dtype=np.int32)
    label = nd.array(tokens.reshape(-1).astype(np.float32), ctx=dev)

    # the Gluon route's first step on the same weights and batch
    with autograd.record():
        gl = _gluon_mlm(net, gluon.loss.SoftmaxCrossEntropyLoss(), data,
                        label)
    gl.backward()
    gluon_loss = float(gl.mean().asscalar())
    gluon_grads = {p.name: (p.grad().data.detach().double() / n_tok).cpu()
                   for p in net.collect_params().values()}
    del net, gl
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    body = mx.sym.load(f"{path}-symbol.json")
    arg, aux = mx.model.load_params(path, 0)
    ops = [n.op for n in _topo_order(body._entries) if not n.is_variable()]
    mod = _mlm_module(mx, body, dev, TRAIN_BATCH, TRAIN_LEN)
    mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 1e-4})
    bind_s = time.perf_counter() - t0
    for suffix in ("-symbol.json", "-0000.params"):
        os.remove(path + suffix)
    n_params = sum(mod._exec.arg_dict[n].size for n in mod._param_names)
    batch = mx.io.DataBatch([data], [label])

    def step():
        mod.forward_backward(batch)
        mod.update()
        return _softmax_loss(torch, mod.get_outputs()[0], label)

    torch.cuda.reset_peak_memory_stats()
    mod.forward_backward(batch)
    first = float(_softmax_loss(torch, mod.get_outputs()[0], label))
    grads = {n: g._data.detach().double().cpu()
             for n, g in mod._exec.grad_dict.items()}
    mod.update()
    g_model, g_worst = _rel_l2(grads, {n: gluon_grads[n] for n in grads})
    parity = {"loss_module": first, "loss_gluon": gluon_loss,
              "loss_rel": abs(first - gluon_loss) / abs(gluon_loss),
              "grad_rel_model": g_model, "grad_rel_worst_tensor": g_worst[0],
              "grad_worst_tensor": g_worst[1], "tol": SYM_PARITY_TOL}
    del grads, gluon_grads
    losses = [first] + [float(step()) for _ in range(MB_WARMUP - 1)]
    counted = _det_zero_counters()
    step_ms, wall, handles = _timed_steps(torch, step, (), MB_STEPS)
    launches = {n: fn.launches for n, fn in counted.items()}
    ctx.setdefault("launches", {})["module_bert"] = launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses += [float(h) for h in handles]
    prof = _step_profile(torch, step, steps=1)
    expected = {n: k * MB_STEPS for n, k in TRAIN_PER_STEP.items()}
    tokens_per_s = n_tok * MB_STEPS / wall
    ok = bool(all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0] and launches == expected
              and ops.count("LayerNorm") == 26
              and ops.count("_contrib_flash_attention") == 12
              and parity["loss_rel"] <= SYM_PARITY_TOL["loss_rel"]
              and g_model <= SYM_PARITY_TOL["grad_rel_model"]
              and g_worst[0] <= SYM_PARITY_TOL["grad_rel_tensor"])
    del mod, batch
    torch.cuda.empty_cache()
    return {"model": "bert_base", "vocab": BERT_VOCAB, "params": n_params,
            "graph_op_nodes": len(ops),
            "graph_layer_norm_nodes": ops.count("LayerNorm"),
            "graph_flash_attention_nodes":
                ops.count("_contrib_flash_attention"),
            "export_s": export_s, "load_bind_init_s": bind_s,
            "batch": TRAIN_BATCH, "seq_len": TRAIN_LEN, "optimizer": "adam",
            "learning_rate": 1e-4, "steps": MB_STEPS, "wall_s": wall,
            "tokens_per_s": tokens_per_s,
            "step_ms_median": statistics.median(step_ms),
            "step_ms": step_ms, "max_memory_allocated_gb": peak,
            "gluon_bert_phase": ctx.get("gluon_bert_f32"),
            "train_phase": ctx.get("train_f32"),
            "losses": losses, "parity_vs_gluon": parity,
            "launches": launches, "launches_expected": expected,
            "profile_1_step": prof, "card": ctx["smi"], "ok": ok}


# ---------------------------------------------------------------------------
# the rest of the training step: the in-flight window, checkpoints of a
# step, resume
# ---------------------------------------------------------------------------
RESUME_STEPS, RESUME_AT, RESUME_LOOP_STEPS = 6, 3, 3
# the largest difference allowed between two runs that must agree (losses
# and weights across windows and across a restore): 0, bit for bit, as
# none of the port's kernels and no op on the path accumulates in an order
# that varies; each run also repeats window 0 and reports its spread
RESUME_SPREAD = 0.0
RESUME_GLUON_BATCH = (2, 128)


def _resume_window(window):
    """Set ``MX_ASYNC_INFLIGHT`` (None: unset, the default window 2)."""
    if window is None:
        os.environ.pop("MX_ASYNC_INFLIGHT", None)
    else:
        os.environ["MX_ASYNC_INFLIGHT"] = str(window)


def _resume_run(torch, step, batch, n):
    """``n`` steps of ``step`` at the current window, the depth after each
    dispatch, then ``drain``: (losses, depths, wall s)."""
    handles, depths = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        handles.append(step.step(*batch))
        depths.append(step.inflight_depth)
    step.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [float(h) for h in handles], depths, wall


def _resume_diff(a, b):
    """The largest |a - b| over two equal-length lists of floats, or of
    tensors (0.0 when every pair is equal bit for bit)."""
    worst = 0.0
    for x, y in zip(a, b):
        if hasattr(x, "shape"):
            if not bool((x == y).all()):
                worst = max(worst, float((x.double() - y.double()).abs()
                                         .max()))
        elif x != y:
            worst = max(worst, abs(x - y))
    return worst


def _state_diff(a, b):
    """Whether two ``state_dict()``s have the same keys, and the largest
    difference over their values (numpy arrays, or CPU tensors)."""
    import torch

    def t(v):
        return v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.asarray(v))

    same_keys = all(sorted(a[s]) == sorted(b[s])
                    for s in ("params", "opt_state"))
    vals = [(t(a[s][k]), t(b[s][k])) for s in ("params", "opt_state")
            for k in a[s] if k in b[s]]
    return same_keys and a["optimizer"] == b["optimizer"], _resume_diff(
        [x for x, _ in vals], [y for _, y in vals])


def phase_train_resume(torch, ctx):
    """BERT-base through ``DataParallelStep`` at the train cell's widths
    (32 x 512, Adam lr 1e-4, f32, TF32 off): windows 0 and 2, a checkpoint
    of the step at step 3 in formats 1 and 2, each restored into a fresh
    model (another seed) and step and continued; then the Gluon Trainer's
    and the Module's windows."""
    import shutil
    import tempfile

    before = os.environ.get("MX_ASYNC_INFLIGHT")
    here = os.path.dirname(os.path.abspath(__file__))
    build = os.path.join(here, "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="train_resume-", dir=build)
    try:
        return _train_resume(torch, ctx, root, build)
    finally:
        _resume_window(None if before is None else int(before))
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def _train_resume(torch, ctx, root, build):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, checkpoint, gluon, nd
    from mxnet_tpu_torch.models.bert import bert_base
    from mxnet_tpu_torch.parallel import DataParallelStep

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = mx.gpu(0)
    tokens_np = np.random.RandomState(SEED).randint(
        0, BERT_VOCAB, (TRAIN_BATCH, TRAIN_LEN)).astype(np.int32)
    tokens = torch.from_numpy(tokens_np).cuda()
    batch = (tokens, tokens.float())
    n_tok = tokens_np.size
    per_step = {n: k for n, k in TRAIN_PER_STEP.items()}
    checks = {}

    def new_step(model):
        return DataParallelStep(model, _mlm_loss(torch), optimizer="adam",
                                optimizer_params={"learning_rate": 1e-4})

    def launches_ok(launches, steps):
        return launches == {n: k * steps for n, k in per_step.items()}

    # -- leg 1: window 0 (twice) against the default window --------------
    t0 = time.perf_counter()
    model = bert_base(BERT_VOCAB, dropout=0.0,
                      generator=torch.Generator().manual_seed(SEED))
    init_s = time.perf_counter() - t0
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    legs, ref = {}, None
    for name, window in (("window0", 0), ("window0_repeat", 0),
                         ("window2", None)):
        model.load_state_dict(start)
        step = new_step(model)
        _resume_window(window)
        counted = _det_zero_counters()
        losses, depths, wall = _resume_run(torch, step, batch,
                                           RESUME_STEPS)
        launches = {n: fn.launches for n, fn in counted.items()}
        weights = [v.detach().clone() for v in model.state_dict().values()]
        if ref is None:
            ref = (losses, weights)
        leg = {"losses": losses, "inflight_depths": depths,
               "tokens_per_s": n_tok * RESUME_STEPS / wall,
               "launches": launches,
               "loss_diff_vs_window0": _resume_diff(losses, ref[0]),
               "weight_diff_vs_window0": _resume_diff(weights, ref[1])}
        del weights
        if name != "window0_repeat":
            leg["profile_3_steps"] = _step_profile(
                torch, lambda: step.step(*batch), steps=3)
            step.drain()
        if name == "window2":
            ctx.setdefault("launches", {})["train_resume"] = launches
        legs[name] = leg
        checks[f"{name}_launches"] = launches_ok(launches, RESUME_STEPS)
        checks[f"{name}_depth"] = max(depths) <= (0 if window == 0 else 2)
        del step
    checks["window2_depth_reached_2"] = max(
        legs["window2"]["inflight_depths"]) == 2
    checks["window0_repeat"] = (
        legs["window0_repeat"]["loss_diff_vs_window0"] <= RESUME_SPREAD
        and legs["window0_repeat"]["weight_diff_vs_window0"]
        <= RESUME_SPREAD)
    checks["window2_equals_window0"] = (
        legs["window2"]["loss_diff_vs_window0"] <= RESUME_SPREAD
        and legs["window2"]["weight_diff_vs_window0"] <= RESUME_SPREAD)
    want_rest = ref[0][RESUME_AT:]
    del ref
    torch.cuda.empty_cache()

    # -- leg 2: checkpoint at step 3 in both formats, restore, continue ----
    _resume_window(None)
    model.load_state_dict(start)
    del start
    step = new_step(model)
    dirs = {"format1": os.path.join(root, "format1"),
            "format2": os.path.join(root, "format2")}
    ckpts = {"format1": checkpoint.AsyncCheckpointer(
                 dirs["format1"], save_every=RESUME_AT, keep=1),
             "format2": checkpoint.AsyncCheckpointer(
                 dirs["format2"], save_every=RESUME_AT, keep=1,
                 sharded=True)}
    saves = {}
    for i in range(RESUME_AT):
        step.step(*batch)
        if i + 1 == RESUME_AT:
            step.drain()  # the snapshot's copies then wait on nothing
            torch.cuda.synchronize()
        for fmt, ck in ckpts.items():
            t0 = time.perf_counter()
            saved = ck.step(step)
            t1 = time.perf_counter()
            ck.wait()
            t2 = time.perf_counter()
            if saved:
                d = os.path.join(dirs[fmt], f"step-{RESUME_AT}")
                saves[fmt] = {
                    "snapshot_d2h_ms": (t1 - t0) * 1e3,
                    "write_s": t2 - t1,
                    "bytes": sum(os.path.getsize(os.path.join(d, f))
                                 for f in os.listdir(d)),
                    "files": sorted(os.listdir(d))}
    for ck in ckpts.values():
        ck.close()
    saved_state = step.state_dict()
    checks["saved_both_formats"] = sorted(saves) == ["format1", "format2"]
    checks["format1_has_opt_state"] = "opt_state.nd" in saves.get(
        "format1", {}).get("files", [])
    del step, model
    torch.cuda.empty_cache()
    resumed = {}
    for k, fmt in enumerate(("format1", "format2")):
        t0 = time.perf_counter()
        fresh = bert_base(BERT_VOCAB, dropout=0.0,
                          generator=torch.Generator().manual_seed(
                              SEED + 16 + k))
        step = new_step(fresh)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        at = checkpoint.restore(dirs[fmt], step)
        restore_s = time.perf_counter() - t0
        same_keys, state_diff = _state_diff(step.state_dict(), saved_state)
        counted = _det_zero_counters()
        losses, depths, _ = _resume_run(torch, step, batch,
                                        RESUME_STEPS - RESUME_AT)
        launches = {n: fn.launches for n, fn in counted.items()}
        # a Gluon forward after sync_to_block against the step's forward
        step.sync_to_block()
        small = tokens[:RESUME_GLUON_BATCH[0], :RESUME_GLUON_BATCH[1]]
        with torch.no_grad():
            fresh.eval()
            want = fresh(small)
        got = fresh(nd.array(small.cpu().numpy(), ctx=dev, dtype=np.int32))
        gluon_diff = _resume_diff([got._data], [want])
        resumed[fmt] = {
            "restored_step": at, "model_build_s": build_s,
            "restore_s": restore_s, "state_keys_equal": same_keys,
            "state_diff": state_diff, "losses_4_6": losses,
            "loss_diff_vs_window0": _resume_diff(losses, want_rest),
            "inflight_depths": depths, "launches": launches,
            "gluon_forward_diff": gluon_diff}
        checks[f"{fmt}_restored"] = bool(
            at == RESUME_AT and same_keys and state_diff == 0.0
            and resumed[fmt]["loss_diff_vs_window0"] <= RESUME_SPREAD
            and launches_ok(launches, RESUME_STEPS - RESUME_AT)
            and gluon_diff == 0.0)
        del step, fresh, got, want
        torch.cuda.empty_cache()
    del saved_state

    # -- leg 3: the Trainer's and the Module's windows ---------------------
    data = nd.array(tokens_np, ctx=dev, dtype=np.int32)
    label = nd.array(tokens_np.astype(np.float32), ctx=dev)
    mx.random.seed(SEED)
    net = bert_base(BERT_VOCAB, dropout=0.0, init_weights=False)
    net.initialize(mx.init.Normal(0.02), ctx=dev)
    net.hybridize()
    params = net.collect_params()
    init = {k: p._reduce().clone() for k, p in params.items()}
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    loops = {}
    for window in (0, None):
        _resume_window(window)
        for k, p in params.items():
            p.set_data(init[k])
        trainer = gluon.Trainer(params, "adam", {"learning_rate": 1e-4})
        handles, depths = [], []
        for _ in range(RESUME_LOOP_STEPS):
            with autograd.record():
                loss = _gluon_mlm(net, loss_fn, data, label)
            loss.backward()
            trainer.step(n_tok)
            handles.append(loss.mean())
            depths.append(0 if trainer._inflight is None
                          else trainer._inflight.depth)
        trainer.drain()
        loops[f"trainer_window{2 if window is None else 0}"] = {
            "losses": [float(h.asscalar()) for h in handles],
            "inflight_depths": depths, "fences": trainer._inflight
            is not None}
        del trainer, handles, loss
    del net, params, init
    torch.cuda.empty_cache()
    src = bert_base(BERT_VOCAB, dropout=0.0,
                    generator=torch.Generator().manual_seed(SEED + 15))
    path = os.path.join(build, f"train_resume_module-{os.getpid()}")
    src.export(path, 0)
    del src
    body = mx.sym.load(f"{path}-symbol.json")
    arg, aux = mx.model.load_params(path, 0)
    for suffix in ("-symbol.json", "-0000.params"):
        os.remove(path + suffix)
    flat = nd.array(tokens_np.reshape(-1).astype(np.float32), ctx=dev)
    mbatch = mx.io.DataBatch([data], [flat])
    for window in (0, None):
        _resume_window(window)
        mod = _mlm_module(mx, body, dev, TRAIN_BATCH, TRAIN_LEN)
        mod.init_params(arg_params=arg, aux_params=aux)
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": 1e-4})
        handles, depths = [], []
        for _ in range(RESUME_LOOP_STEPS):
            mod.forward_backward(mbatch)
            mod.update()
            handles.append(_softmax_loss(torch, mod.get_outputs()[0], flat))
            ring = getattr(mod, "_inflight", None)
            depths.append(0 if ring is None else ring.depth)
        mod.drain()
        loops[f"module_window{2 if window is None else 0}"] = {
            "losses": [float(h) for h in handles],
            "inflight_depths": depths,
            "fences": getattr(mod, "_inflight", None) is not None}
        del mod, handles
        torch.cuda.empty_cache()
    for kind in ("trainer", "module"):
        w0, w2 = loops[f"{kind}_window0"], loops[f"{kind}_window2"]
        diff = _resume_diff(w0["losses"], w2["losses"])
        loops[f"{kind}_loss_diff"] = diff
        checks[f"{kind}_windows"] = bool(
            diff <= RESUME_SPREAD and not w0["fences"] and w2["fences"]
            and max(w2["inflight_depths"]) == 2
            and all(math.isfinite(x) for x in w0["losses"]))

    peak = torch.cuda.max_memory_allocated() / 1e9
    return {"model": "bert_base", "vocab": BERT_VOCAB, "init_s": init_s,
            "batch": TRAIN_BATCH, "seq_len": TRAIN_LEN, "optimizer": "adam",
            "learning_rate": 1e-4, "steps": RESUME_STEPS,
            "checkpoint_at": RESUME_AT, "spread_allowed": RESUME_SPREAD,
            "window_legs": legs, "saves": saves, "resumed": resumed,
            "loops": loops, "max_memory_allocated_gb": peak,
            "launches": ctx["launches"]["train_resume"],
            "launches_expected": {n: k * RESUME_STEPS
                                  for n, k in per_step.items()},
            "checks": checks, "card": ctx["smi"],
            "ok": all(checks.values())}


def _lb_sentences(seed):
    """A seeded Zipf stream over ids 1..V-1 (0 is the invalid label), cut
    into sentences of 5-60 tokens: the stand-in for PTB."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(5, 61, LB_SENTENCES)
    ids = (rng.zipf(LB_ZIPF_A, int(lengths.sum())) - 1) % (
        LB["vocab"] - 1) + 1
    cuts = np.cumsum(lengths)[:-1]
    return [s.tolist() for s in np.split(ids, cuts)]


def _lb_sym_gen(mx, cell):
    """lstm_bucketing.py's sym_gen over ``cell`` (a SequentialRNNCell of
    LSTMCells, or a FusedRNNCell as cudnn_lstm_bucketing.py)."""
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data=data, input_dim=LB["vocab"],
                                 output_dim=LB["embed"], name="embed")
        cell.reset()
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, LB["hidden"]))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=LB["vocab"],
                                     name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)

    return sym_gen


def _lb_cells(mx):
    stack = mx.rnn.SequentialRNNCell()
    for i in range(LB["layers"]):
        stack.add(mx.rnn.LSTMCell(num_hidden=LB["hidden"],
                                  prefix=f"lstm_l{i}_"))
    fused = mx.rnn.FusedRNNCell(LB["hidden"], num_layers=LB["layers"],
                                mode="lstm", prefix="lstm_")
    return stack, fused


def _lb_module(mx, cell, dev, it, arg_params):
    mod = mx.mod.BucketingModule(_lb_sym_gen(mx, cell),
                                 default_bucket_key=it.default_bucket_key,
                                 context=dev)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params=arg_params)
    # rescale_grad 1 / batch: MXNet's Module sets it from the batch size
    # (module.py init_optimizer); the JAX Module, and so the port's, does
    # not, so the example's optimizer passes it
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": LB["lr"], "momentum": LB["mom"], "wd": LB["wd"],
        "rescale_grad": 1.0 / LB["batch"]})
    return mod


def _lb_iter(mx, sentences, dev, seed):
    import random

    random.seed(seed)
    np.random.seed(seed)
    return mx.rnn.BucketSentenceIter(sentences, LB["batch"],
                                     buckets=list(LB["buckets"]),
                                     invalid_label=LB["invalid_label"],
                                     ctx=dev)


def _lb_parity(torch, mx, cell_of, args, sentences):
    """Card vs CPU: two batches of two buckets through forward_backward
    and update from the same weights; outputs and gradients of each, of
    each tensor's max abs."""
    runs = {}
    for name, dev in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        it = _lb_iter(mx, sentences, dev, SEED + 31)
        picked, keys = [], set()
        for b in it:
            if b.bucket_key not in keys:
                picked.append(b)
                keys.add(b.bucket_key)
            if len(picked) == 2:
                break
        mod = _lb_module(mx, cell_of(), dev, it, {
            k: v.copyto(dev) for k, v in args.items()})
        got = []
        for b in picked:
            mod.forward_backward(b)
            ex = mod._curr_module._exec
            got.append({"output": ex.outputs[0].asnumpy(),
                        **{f"grad:{k}": v.asnumpy()
                           for k, v in ex.grad_dict.items()}})
            mod.update()
        runs[name] = (got, sorted(keys))
    worst = max(_max_abs_ratio(c[k], p[k])
                for c, p in zip(runs["card"][0], runs["cpu"][0]) for k in c)
    return {"buckets": runs["card"][1], "worst_of_max_abs": worst,
            "tol": LB_PARITY_TOL, "ok": worst <= LB_PARITY_TOL}


def _lb_fit(torch, mx, mod, it):
    """One epoch through BucketingModule.fit with the example's metric and
    Speedometer; per batch: bucket, host seconds since the last batch end,
    and the batch's perplexity (from the metric's running sums)."""
    metric = mx.metric.Perplexity(LB["invalid_label"])
    rows, last = [], {"t": None, "sum": 0.0, "n": 0}
    speed = mx.callback.Speedometer(LB["batch"], LB["disp_batches"],
                                    auto_reset=False)

    def record(param):
        now = time.perf_counter()
        s, n = param.eval_metric.sum_metric, param.eval_metric.num_inst
        key = param.locals["data_batch"].bucket_key
        rows.append({"bucket": key,
                     "s": None if last["t"] is None else now - last["t"],
                     "ppl": math.exp((s - last["sum"])
                                     / max(n - last["n"], 1))})
        last.update(t=now, sum=s, n=n)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.fit(it, eval_metric=metric, num_epoch=1,
            batch_end_callback=[record, speed])
    torch.cuda.synchronize()
    return rows, time.perf_counter() - t0


def _lb_rates(rows):
    out = {}
    for key in LB["buckets"]:
        ss = [r["s"] for r in rows if r["bucket"] == key and r["s"]]
        if ss:
            med = statistics.median(ss)
            out[str(key)] = {"batches": len(ss), "batch_ms_median": med * 1e3,
                             "batches_per_s": 1.0 / med,
                             "tokens_per_s": LB["batch"] * key / med}
    return out


def phase_module_lstm_bucketing(torch, ctx):
    """MXNet 1.x's example/rnn/bucketing/lstm_bucketing.py at its defaults
    on the card: 2 x LSTMCell(200) (``lstm_l%d_``), Embedding 200,
    FullyConnected to the 10,000-word vocabulary, SoftmaxOutput; buckets
    10-60, batch 32, invalid label 0; SGD lr 0.01, momentum 0, wd 1e-5
    and ``rescale_grad`` 1/32, as MXNet's Module sets it;
    ``Xavier(factor_type="in", magnitude=2.34)``; ``Perplexity(0)``;
    ``Speedometer(32, 50)``; one epoch of BucketingModule.fit over a seeded
    Zipf stream.  Then the same net with ``FusedRNNCell(200,
    num_layers=2)`` (cudnn_lstm_bucketing.py), from the unfused net's
    initial weights packed."""
    import mxnet_tpu_torch as mx

    torch.cuda.empty_cache()
    dev = mx.gpu(0)
    mx.random.seed(SEED + 30)
    sentences = _lb_sentences(SEED + 30)
    # the example's Xavier draw, through a bound module
    stack, fused = _lb_cells(mx)
    it = _lb_iter(mx, sentences, dev, SEED + 30)
    probe = mx.mod.BucketingModule(_lb_sym_gen(mx, stack),
                                   default_bucket_key=it.default_bucket_key,
                                   context=dev)
    probe.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    probe.init_params(initializer=mx.init.Xavier(factor_type="in",
                                                 magnitude=2.34))
    args0 = {k: v.copyto(mx.cpu()) for k, v in probe.get_params()[0].items()}
    del probe
    args_fused = fused.pack_weights(stack.unpack_weights(dict(args0)))
    parity = {
        "unfused": _lb_parity(torch, mx, lambda: _lb_cells(mx)[0], args0,
                              sentences),
        "fused": _lb_parity(torch, mx, lambda: _lb_cells(mx)[1], args_fused,
                            sentences)}
    res, ok = {}, all(p["ok"] for p in parity.values())
    for name, cell, args in (("unfused", stack, args0),
                             ("fused", fused, args_fused)):
        it = _lb_iter(mx, sentences, dev, SEED + 30)
        mod = _lb_module(mx, cell, dev, it, {k: v.copyto(dev)
                                              for k, v in args.items()})
        counted = _det_zero_counters()
        rows, wall = _lb_fit(torch, mx, mod, it)
        launches = {n: fn.launches for n, fn in counted.items()}
        ctx.setdefault("launches", {})[f"module_lstm_bucketing_{name}"] = \
            launches
        it.reset()
        batches = [b for b, _ in zip(it, range(4))]
        pending = iter(batches)

        def step():
            mod.forward_backward(next(pending))
            mod.update()

        prof = _step_profile(torch, step, steps=len(batches))
        ppl = [r["ppl"] for r in rows]
        first, last = float(np.mean(ppl[:10])), float(np.mean(ppl[-10:]))
        tokens = sum(LB["batch"] * r["bucket"] for r in rows)
        good = bool(len(rows) >= 60
                    and {r["bucket"] for r in rows} == set(LB["buckets"])
                    and all(math.isfinite(p) for p in ppl) and last < first
                    and last < LB_PPL_BOUND
                    and not any(launches.values()))
        ok = ok and good
        res[name] = {"batches": len(rows), "wall_s": wall,
                     "batches_per_s": len(rows) / wall,
                     "tokens_per_s": tokens / wall,
                     "per_bucket": _lb_rates(rows),
                     "perplexity_first10_mean": first,
                     "perplexity_last10_mean": last,
                     "perplexity_last10_bound": LB_PPL_BOUND,
                     "perplexity_by_batch": ppl, "launches": launches,
                     "profile_4_batches": prof, "ok": good}
        del mod
    torch.cuda.empty_cache()
    return {"config": LB, "sentences": LB_SENTENCES, "zipf_a": LB_ZIPF_A,
            "params": sum(v.size for v in args0.values()),
            "parity_card_vs_cpu": parity, **res, "card": ctx["smi"],
            "ok": bool(ok)}


def _api_block(mx):
    """A transformer layer's kernel ops as an exported graph spells them
    (LayerNorm, qkv, flash attention over 2 heads of 32, proj)."""
    sym = mx.sym
    x = sym.LayerNorm(sym.Variable("data"), name="ln", eps=1e-5)
    qkv = sym.FullyConnected(x, num_hidden=192, flatten=False, name="qkv")
    q, k, v = sym.split(qkv, num_outputs=3, axis=-1)
    heads = [sym.Reshape(sym.transpose(sym.Reshape(
        t, shape=(0, 0, -4, 2, 32)), axes=(0, 2, 1, 3)), shape=(-3, 0, 0))
        for t in (q, k, v)]
    out = sym._contrib_flash_attention(*heads, causal=True)
    out = sym.Reshape(sym.transpose(sym.Reshape(
        out, shape=(-4, -1, 2, 0, 0)), axes=(0, 2, 1, 3)), shape=(0, 0, -3))
    return sym.FullyConnected(out, num_hidden=64, flatten=False, name="proj")


def phase_symbol_api(torch, ctx):
    """Card vs CPU, each within SYM_API_TOL of each tensor's max abs: the
    Executor's forward and backward (grad_req write, then add over two
    passes) of a transformer layer's kernel ops; ``SymbolBlock.imports``
    of a port-exported small BERT (outputs and gradients); a
    ``Module.save_checkpoint`` on the card loaded by ``Module.load`` on
    the CPU and on the card (outputs)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.models.bert import bert_small

    rs = np.random.RandomState(SEED + 40)
    shapes = {"data": (4, 64, 64)}
    sym0 = _api_block(mx)
    arg_shapes, _, _ = sym0.infer_shape(**shapes)
    feeds = {n: (rs.randn(*s) * (1.0 if n == "data" else 0.2)).astype(
        np.float32) for n, s in zip(sym0.list_arguments(), arg_shapes)}
    og = rs.randn(4, 64, 64).astype(np.float32)
    res, worst = {}, {}
    for req in ("write", "add"):
        got = {}
        for name, dev in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
            exe = _api_block(mx).simple_bind(ctx=dev, grad_req=req, **shapes)
            for _ in range(2 if req == "add" else 1):
                exe.forward(is_train=True, **feeds)
                exe.backward([nd.array(og, ctx=dev)])
            got[name] = {"output": exe.outputs[0].asnumpy(),
                         **{f"grad:{k}": v.asnumpy()
                            for k, v in exe.grad_dict.items()}}
        worst[f"executor_{req}"] = max(
            _max_abs_ratio(got["card"][k], got["cpu"][k])
            for k in got["cpu"])

    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, "build", f"symbol_api-{os.getpid()}")
    net = bert_small(dropout=0.0, device="cpu",
                     generator=torch.Generator().manual_seed(SEED + 40))
    net.export(path, 0)
    x = rs.randint(0, 512, (2, 16)).astype(np.float32)
    got = {}
    for name, dev in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        sb = mx.gluon.SymbolBlock.imports(f"{path}-symbol.json", ["data"],
                                          f"{path}-0000.params", ctx=dev)
        xa = nd.array(x, ctx=dev)
        with autograd.record():
            out = sb(xa)
            loss = (out * out).mean()
        loss.backward()
        got[name] = {"output": out.asnumpy(),
                     **{f"grad:{p.name}": p.grad().asnumpy()
                        for p in sb.collect_params().values()
                        if p.grad_req != "null"}}
    worst["symbol_block_imports"] = max(
        _max_abs_ratio(got["card"][k], got["cpu"][k]) for k in got["cpu"])

    body = mx.sym.load(f"{path}-symbol.json")
    arg, aux = mx.model.load_params(path, 0)
    head = mx.sym.SoftmaxOutput(mx.sym.Reshape(body, shape=(-1, 512)),
                                normalization="batch", name="softmax")
    batch = mx.io.DataBatch([nd.array(x, ctx=mx.gpu(0))],
                            [nd.array(x.reshape(-1), ctx=mx.gpu(0))])
    mod = mx.mod.Module(head, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", (x.size,))])
    mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 1e-3})
    mod.forward_backward(batch)
    mod.update()
    mod.save_checkpoint(path, 1, save_optimizer_states=True)
    mod.forward(batch, is_train=False)
    want = mod.get_outputs()[0].asnumpy()
    outs = {}
    for name, dev in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        m2 = mx.mod.Module.load(path, 1, load_optimizer_states=True,
                                context=dev)
        m2.bind(data_shapes=[("data", x.shape)],
                label_shapes=[("softmax_label", (x.size,))],
                for_training=False)
        m2.init_params()
        m2.forward(mx.io.DataBatch([nd.array(x, ctx=dev)]), is_train=False)
        outs[name] = m2.get_outputs()[0].asnumpy()
    worst["checkpoint_reload_card"] = _max_abs_ratio(outs["card"], want)
    worst["checkpoint_reload_cpu"] = _max_abs_ratio(outs["cpu"], want)
    for f in os.listdir(os.path.dirname(path)):
        if f.startswith(os.path.basename(path)):
            os.remove(os.path.join(os.path.dirname(path), f))
    res["worst_of_max_abs"] = worst
    return {**res, "tol": SYM_API_TOL, "card": ctx["smi"],
            "ok": bool(all(v <= SYM_API_TOL for v in worst.values()))}


# ---------------------------------------------------------------------------
# the vision model zoo and config 2's ImageNet input path
# (examples/train_imagenet.py --rec), and the 1-D / 3-D conv family
# ---------------------------------------------------------------------------
IMAGENET_REC_IMAGES, IMAGENET_BATCH, IMAGENET_RES = 1024, 256, 224
IMAGENET_WARMUP, IMAGENET_STEPS = 2, 12  # 12 steps: 3 epochs of 4 batches
IMAGENET_ITER_BATCHES, IMAGENET_STAGED_STEPS = 4, 5
# (name, batch, resolution) of zoo_train; the parity step's resolution:
# 224 where BatchNorm needs 7 x 7 maps at batch 2 to be well conditioned,
# 64 for VGG (no BatchNorm; its CPU float64 step at 224 takes ~15 s)
ZOO_TRAIN = (("vgg16", 64, 224, 64), ("densenet121", 64, 224, 224),
             ("inceptionv3", 64, 299, 299),
             ("mobilenetv2_1.0", 128, 224, 224),
             ("squeezenet1.1", 128, 224, 224), ("alexnet", 128, 224, 224))
ZOO_WARMUP, ZOO_STEPS = 2, 3
# card vs CPU at batch 2 from the same weights, Dropout 0: the logits of
# their max abs and the loss relative, card vs the f32 CPU; the
# gradients, relative L2 over the net and in the worst tensor, card vs
# the CPU in float64 within the larger of these and ZOO_PARITY_SPREAD x
# the f32 CPU's own distance from float64 (DET_PARITY_TOL's reasoning:
# the f32 BatchNorm backward's sums cancel)
ZOO_PARITY_TOL = {"out_of_max_abs": 1e-4, "loss_rel": 1e-4,
                  "grad_rel_model": 5e-3, "grad_rel_tensor": 2e-2}
ZOO_PARITY_SPREAD = 2.0
# a float64 gradient this far below the largest tensor's is 0 but for
# rounding (see _zoo_parity)
ZOO_ZERO_GRAD = 1e-9
# zoo_forward: eval logits card vs CPU (one name a family) of their max
# abs; an exported graph's SymbolBlock vs its Block, both on the card
ZOO_FORWARD_TOL, ZOO_EXPORT_TOL = 1e-4, 1e-5
ZOO_FORWARD_REF = ("resnet18_v1", "resnet50_v2", "alexnet", "vgg11",
                   "squeezenet1.0", "densenet121", "mobilenet1.0",
                   "mobilenetv2_1.0", "inceptionv3")
ZOO_EXPORT = ("resnet50_v2", "mobilenetv2_1.0", "densenet121",
              "inceptionv3")
# conv_nd: card vs CPU of each output's and gradient's max abs, on inputs
# that bf16 holds exactly (the CPU's f32 result is the yardstick of both
# dtypes); bf16 rounds each output once after f32 sums (2^-8 of a value)
CONV_ND_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# rank -> (N, C, spatial): audio, ResNet's stage 1, a video clip
CONV_ND_BLOCKS = {1: (16, 256, (16000,)), 2: (32, 64, (56, 56)),
                  3: (8, 64, (16, 56, 56))}


def _panoramas(rng, count, size=1024):
    """``count`` seeded photo-like HWC uint8 images of ``size``^2: four
    octaves of smooth noise (upsampled 12-, 48-, 192- and 500-cell grids)
    and a little grain, so that a JPEG cut from one has an ImageNet-like
    size (white noise would not compress)."""
    import cv2

    out = []
    for _ in range(count):
        img = rng.normal(128.0, 8.0, (size, size, 3)).astype(np.float32)
        for cells, amp in ((12, 80.0), (48, 40.0), (192, 30.0), (500, 20.0)):
            small = rng.uniform(-amp, amp, (cells, cells, 3))
            img += cv2.resize(small.astype(np.float32), (size, size),
                              interpolation=cv2.INTER_CUBIC)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _write_imagenet_rec(folder, n, seed):
    """A classification .rec/.idx pair of ``n`` JPEGs (quality 90) at
    ImageNet-like sizes (500 on the long side, 333-375 on the other; each
    a seeded cut of one of 16 panoramas, mirrored at random), labels
    drawn from [0, 1000), written by the port's ``recordio`` and
    ``cv2.imencode``: (the .rec path, the labels, the file's bytes)."""
    import cv2

    from mxnet_tpu_torch import recordio

    rng = np.random.RandomState(seed)
    views = _panoramas(rng, 16)
    rec = os.path.join(folder, "train.rec")
    writer = recordio.MXIndexedRecordIO(os.path.join(folder, "train.idx"),
                                        rec, "w")
    labels = rng.randint(0, 1000, n)
    for i in range(n):
        short = int(rng.randint(333, 376))
        h, w = (short, 500) if rng.rand() < 0.75 else (500, short)
        view = views[rng.randint(len(views))]
        y0, x0 = rng.randint(0, view.shape[0] - h), rng.randint(
            0, view.shape[1] - w)
        img = view[y0:y0 + h, x0:x0 + w]
        if rng.rand() < 0.5:
            img = img[:, ::-1]
        ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(img),
                               [int(cv2.IMWRITE_JPEG_QUALITY), 90])
        if not ok:
            raise RuntimeError("cv2.imencode failed")
        header = recordio.IRHeader(0, float(labels[i]), i, 0)
        writer.write_idx(i, recordio.pack(header, buf.tobytes()))
    writer.close()
    return rec, labels, os.path.getsize(rec)


def phase_train_imagenet(torch, ctx):
    """BASELINE config 2 as ``examples/train_imagenet.py --rec train.rec
    --model resnet50_v2 --batch-size 256`` runs it (``:49-107``), on the
    port: ``vision.get_model("resnet50_v2")``, ``initialize(Xavier())``
    (f32, NCHW, on the card), ``DataParallelStep`` SGD lr 0.1, momentum
    0.9, wd 1e-4, ``ImageRecordIter(batch_size=256, data_shape=(3, 224,
    224), shuffle=True, rand_crop=True, rand_mirror=True)`` at its other
    defaults over a seeded 1,024-image JPEG RecordIO, wrapped in
    ``DevicePrefetchIter(it, step)``; the example's ``batches()`` loop,
    resetting at each epoch's end."""
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.parallel import DataParallelStep

    torch.backends.cudnn.benchmark = True
    torch.cuda.empty_cache()
    B, R = IMAGENET_BATCH, IMAGENET_RES
    folder = tempfile.mkdtemp(prefix="imagenet_rec-", dir=_det_build_dir())
    try:
        t0 = time.perf_counter()
        rec, written, rec_bytes = _write_imagenet_rec(
            folder, IMAGENET_REC_IMAGES, SEED)
        write_s = time.perf_counter() - t0
        mx.random.seed(SEED)
        t0 = time.perf_counter()
        net = vision.get_model("resnet50_v2")
        net.initialize(mx.init.Xavier())
        init_s = time.perf_counter() - t0
        values = sum(t.numel() for t in net.state_dict().values())
        step = DataParallelStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                optimizer="sgd", optimizer_params=RESNET_SGD)
        it_args = dict(path_imgrec=rec, batch_size=B, data_shape=(3, R, R),
                       shuffle=True, rand_crop=True, rand_mirror=True)
        it = mx.io.DevicePrefetchIter(mx.io.ImageRecordIter(**it_args), step)
        seen = []

        def batches():
            epoch = 0
            while True:
                for b in it:
                    d, lab = b.data[0], b.label[0]
                    # the label tensor itself: a host copy here would
                    # wait for the step before it
                    seen.append((epoch, tuple(d.shape), d._data.dtype,
                                 d._data.device, lab._data))
                    yield d, lab
                it.reset()
                epoch += 1

        gen = batches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        warm = [step.step(*next(gen)) for _ in range(IMAGENET_WARMUP)]
        warm = [float(h) for h in warm]
        warm_s = time.perf_counter() - t0
        counted = _det_zero_counters()
        handles = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(IMAGENET_STEPS - IMAGENET_WARMUP):
            data, label = next(gen)
            handles.append(step.step(data, label))
        step.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counted.items()}
        ctx.setdefault("launches", {})["train_imagenet"] = launches
        losses = warm + [float(h) for h in handles]
        # two steps through the pipeline under the profiler: how long the
        # card waits for the host between them
        pipe_prof = _step_profile(torch, lambda: step.step(*next(gen)),
                                  steps=2, gaps=True)
        gen.close()
        # the iterator alone, a fresh one: host ms of ``next`` (decode,
        # augment and the copy to the card, the workers running ahead)
        raw = mx.io.ImageRecordIter(**it_args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(IMAGENET_ITER_BATCHES):
            raw.next()
        torch.cuda.synchronize()
        iter_ms = (time.perf_counter() - t0) * 1e3 / IMAGENET_ITER_BATCHES
        del raw
        step_ms, _, _ = _timed_steps(torch, step.step, (data, label),
                                     IMAGENET_STAGED_STEPS)
        prof = _step_profile(torch, lambda: step.step(data, label), steps=1)
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    dev = torch.device(mx.gpu(0))
    seen = [s[:4] + (tuple(s[4].shape), s[4].cpu().numpy()[:, 0])
            for s in seen]
    first = [s for s in seen if s[0] == 0]
    epoch0 = np.sort(np.concatenate([s[5] for s in first]))
    batches_ok = all(s[1] == (B, 3, R, R) and s[2] == torch.float32
                     and s[3] == dev and s[4] == (B, 1)
                     and s[5].min() >= 0 and s[5].max() < 1000
                     and np.array_equal(s[5], np.round(s[5]))
                     for s in seen)
    cover = (len(first) == IMAGENET_REC_IMAGES // B
             and np.array_equal(epoch0, np.sort(written).astype(np.float32)))
    staged = B * 1e3 / statistics.median(step_ms)
    pipeline = B * (IMAGENET_STEPS - IMAGENET_WARMUP) / wall
    iterator = B * 1e3 / iter_ms
    return {"model": "resnet50_v2", "layout": "NCHW", "dtype": "float32",
            "state_values": values, "init_s": init_s, "batch": B,
            "resolution": R, "optimizer": "sgd", **RESNET_SGD,
            "input": "ImageRecordIter (cv2 decode, 4 threads) -> "
                     "DevicePrefetchIter",
            "rec_images": IMAGENET_REC_IMAGES, "rec_bytes": rec_bytes,
            "rec_mean_jpeg_kb": rec_bytes / IMAGENET_REC_IMAGES / 1e3,
            "rec_write_s": write_s, "warmup_steps": IMAGENET_WARMUP,
            "warmup_s": warm_s, "steps": IMAGENET_STEPS,
            "epochs_seen": 1 + max(s[0] for s in seen),
            "pipeline_wall_s": wall,
            "pipeline_images_per_s": pipeline,
            "iter_ms_per_batch": iter_ms,
            "iter_images_per_s": iterator,
            "staged_step_ms_median": statistics.median(step_ms),
            "staged_step_ms": step_ms, "staged_images_per_s": staged,
            "bound_by": ("the pipeline" if pipeline < 0.9 * staged
                         else "the step"),
            "pipeline_over_staged": pipeline / staged,
            "losses": losses, "max_memory_allocated_gb": peak,
            "profile_1_step": prof, "profile_pipeline_2_steps": pipe_prof,
            "host_cpus": len(os.sched_getaffinity(0)),
            "launches": launches,
            "first_epoch_labels_cover_the_file": bool(cover),
            "batches_ok": bool(batches_ok), "card": ctx["smi"],
            "ok": bool(all(math.isfinite(v) for v in losses)
                       and not any(launches.values()) and batches_ok
                       and cover)}


def _zero_dropout(net):
    from mxnet_tpu_torch.gluon import nn

    for m in net.modules():
        if isinstance(m, nn.Dropout):
            m.rate = 0.0
    return net


def _zoo_parity(torch, name, res):
    """One training forward and backward of ``name`` (Dropout 0) at batch
    2 on the card, the CPU and the CPU in float64 from the same weights:
    the ZOO_PARITY_TOL row of :func:`_det_parity_row`."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision

    rng = np.random.RandomState(SEED + 17)
    x = rng.rand(2, 3, res, res).astype(np.float32)
    y = rng.randint(0, 1000, 2).astype(np.float32)

    def warm(net):
        net.eval()
        with torch.no_grad():
            net(torch.from_numpy(x[:1]))

    fname = os.path.join(_det_build_dir(), f"zoo-{os.getpid()}.params")
    nets = _carried_nets(torch, lambda: _zero_dropout(vision.get_model(name)),
                         fname, warm)
    out = {}
    for key, net in nets.items():
        dev = torch.device(mx.gpu(0)) if key == "card" else "cpu"
        dt = torch.float64 if key == "float64" else torch.float32
        net.train()
        logits = net(torch.from_numpy(x).to(dev, dt))
        loss = SoftmaxCrossEntropyLoss()(
            logits, torch.from_numpy(y).to(dev, dt)).mean()
        loss.backward()
        out[key] = (float(loss.detach()), _grads_by_name(net),
                    logits.detach().cpu().double())
    del nets
    # a BatchNorm beta feeding another training-mode BatchNorm through
    # linear layers only (MobileNetV2's linear bottlenecks) has a gradient
    # of exactly 0: a per-channel shift the next BatchNorm's mean removes.
    # Its float64 value is rounding noise, so it leaves the per-tensor
    # bound (the model-wide one keeps it)
    yard = out["float64"][1]
    top = max(float(g.norm()) for g in yard.values())
    zero = sorted(k for k, g in yard.items()
                  if float(g.norm()) <= ZOO_ZERO_GRAD * top)
    for key in out:
        loss, grads, logits = out[key]
        out[key] = (loss, {k: g for k, g in grads.items() if k not in zero},
                    logits)
    row = _det_parity_row(torch, out, ZOO_PARITY_TOL, ZOO_PARITY_SPREAD)
    row["zero_gradient_tensors"] = zero
    return row


def phase_zoo_train(torch, ctx):
    """The other vision families at ImageNet width, each as
    ``train_imagenet`` trains resnet50_v2 but on a staged seeded batch:
    ``get_model(name)``, ``initialize(Xavier())`` on the card, one
    inference forward to resolve the deferred shapes, ``DataParallelStep``
    SGD (``RESNET_SGD``); 2 warm-up and 3 timed steps (CUDA events),
    every kernel counter zeroed before them.  Then :func:`_zoo_parity` at
    batch 2."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.parallel import DataParallelStep

    torch.backends.cudnn.benchmark = True
    rows, ok, total = {}, True, {}
    for name, B, R, parity_res in ZOO_TRAIN:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rng = np.random.RandomState(SEED + 16)
        x = torch.from_numpy(rng.rand(B, 3, R, R).astype(np.float32)).cuda()
        y = torch.from_numpy(rng.randint(0, 1000, B).astype(
            np.float32)).cuda()
        mx.random.seed(SEED)
        t0 = time.perf_counter()
        net = vision.get_model(name)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net.eval()
        with torch.no_grad():
            net(x[:1])
        net.train()
        init_s = time.perf_counter() - t0
        values = sum(t.numel() for t in net.state_dict().values())
        step = DataParallelStep(net, SoftmaxCrossEntropyLoss(),
                                optimizer="sgd", optimizer_params=RESNET_SGD)
        warm = [float(step.step(x, y)) for _ in range(ZOO_WARMUP)]
        counted = _det_zero_counters()
        step_ms, wall, handles = _timed_steps(torch, step.step, (x, y),
                                              ZOO_STEPS)
        launches = {n: fn.launches for n, fn in counted.items()}
        for n, v in launches.items():
            total[n] = total.get(n, 0) + v
        losses = warm + [float(h) for h in handles]
        peak = torch.cuda.max_memory_allocated() / 1e9
        med = statistics.median(step_ms)
        del step, net, x, y
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        parity = _zoo_parity(torch, name, parity_res)
        parity["res"], parity["seconds"] = parity_res, \
            time.perf_counter() - t0
        row_ok = bool(all(math.isfinite(v) for v in losses)
                      and not any(launches.values()) and parity["ok"])
        rows[name] = {"batch": B, "resolution": R, "state_values": values,
                      "init_s": init_s, "step_ms_median": med,
                      "step_ms": step_ms, "images_per_s": B * 1e3 / med,
                      "wall_images_per_s": B * ZOO_STEPS / wall,
                      "losses": losses, "max_memory_allocated_gb": peak,
                      "launches": launches, "parity": parity, "ok": row_ok}
        ok = ok and row_ok
    ctx.setdefault("launches", {})["zoo_train"] = total
    return {"optimizer": "sgd", **RESNET_SGD, "warmup_steps": ZOO_WARMUP,
            "steps": ZOO_STEPS, "parity_tol": ZOO_PARITY_TOL,
            "parity_spread": ZOO_PARITY_SPREAD, "nets": rows,
            "launches": total, "cudnn": _cudnn_settings(torch),
            "card": ctx["smi"], "ok": ok}


def phase_zoo_forward(torch, ctx):
    """Every name of ``get_model``'s table on the card: built,
    ``initialize(Xavier())``, one eval forward of a seeded (2, 3, 224,
    224) batch (299^2 for Inception): finite logits of shape (2, 1000).
    One name a family (ZOO_FORWARD_REF) is built and initialized on the
    CPU, carried by ``save_parameters`` / ``load_parameters`` and held
    card vs CPU within ZOO_FORWARD_TOL; four (ZOO_EXPORT) are exported and
    ``SymbolBlock.imports``-ed on the card, whose output must be the
    Block's within ZOO_EXPORT_TOL.  cuDNN autotuning is off here (one
    forward a shape)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon.model_zoo import vision

    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    here = _det_build_dir()
    rows, ok = {}, True
    counted = _det_zero_counters()
    try:
        for name in sorted(vision._models):
            torch.cuda.empty_cache()
            R = 299 if name.startswith("inception") else 224
            x = np.random.RandomState(SEED + 18).rand(2, 3, R, R).astype(
                np.float32)
            xt = torch.from_numpy(x).cuda()
            mx.random.seed(SEED)
            row = {"resolution": R}
            t0 = time.perf_counter()
            if name in ZOO_FORWARD_REF:
                cpu_net = vision.get_model(name)
                cpu_net.initialize(mx.init.Xavier(), ctx=mx.cpu())
                cpu_net.eval()
                with torch.no_grad():
                    want = cpu_net(torch.from_numpy(x))
                fname = os.path.join(here, f"zoo-{os.getpid()}.params")
                cpu_net.save_parameters(fname)
                net = vision.get_model(name)
                net.load_parameters(fname, ctx=mx.gpu(0))
                os.remove(fname)
                del cpu_net
            else:
                net = vision.get_model(name)
                net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
            net.eval()
            with torch.no_grad():
                out = net(xt)
            torch.cuda.synchronize()
            row["build_and_forward_s"] = time.perf_counter() - t0
            row["shape"] = list(out.shape)
            row_ok = bool(tuple(out.shape) == (2, 1000)
                          and torch.isfinite(out).all())
            if name in ZOO_FORWARD_REF:
                row["card_vs_cpu_of_max_abs"] = _max_abs_ratio(
                    out.cpu().numpy(), want.numpy())
                row_ok = row_ok and (row["card_vs_cpu_of_max_abs"]
                                     <= ZOO_FORWARD_TOL)
            if name in ZOO_EXPORT:
                path = os.path.join(here, f"zoo_export-{os.getpid()}")
                net.export(path, 0)
                sb = mx.gluon.SymbolBlock.imports(
                    f"{path}-symbol.json", ["data"], f"{path}-0000.params",
                    ctx=mx.gpu(0))
                got = sb(nd.array(x, ctx=mx.gpu(0))).asnumpy()
                with open(f"{path}-symbol.json") as f:
                    row["graph_nodes"] = len(json.load(f)["nodes"])
                row["symbol_block_of_max_abs"] = _max_abs_ratio(
                    got, out.cpu().numpy())
                row_ok = row_ok and (row["symbol_block_of_max_abs"]
                                     <= ZOO_EXPORT_TOL)
                for suffix in ("-symbol.json", "-0000.params"):
                    os.remove(path + suffix)
                del sb
            row["ok"] = row_ok
            rows[name] = row
            ok = ok and row_ok
            del net, out, xt
    finally:
        torch.backends.cudnn.benchmark = bench
    launches = {n: fn.launches for n, fn in counted.items()}
    ctx.setdefault("launches", {})["zoo_forward"] = launches
    return {"names": len(rows), "tol": ZOO_FORWARD_TOL,
            "export_tol": ZOO_EXPORT_TOL, "nets": rows,
            "launches": launches, "card": ctx["smi"],
            "ok": bool(ok and len(rows) == 36
                       and not any(launches.values()))}


def _conv_nd_cases(rng):
    """(name, op, rank, full-size inputs, attrs) of conv_nd: a 1-D audio block (N 16, C 256, W 16,000), ResNet's
    (32, 64, 56, 56) and a 3-D video block (N 8, C 64, 16 x 56 x 56),
    channels first; values that bf16 holds exactly."""
    import ml_dtypes

    def U(*shape, s=1.0):
        a = rng.uniform(-s, s, shape).astype(np.float32)
        return a.astype(ml_dtypes.bfloat16).astype(np.float32)

    cases = []
    for n, (N, C, sp) in CONV_ND_BLOCKS.items():
        x = U(N, C, *sp)
        k, ones = (3,) * n, (1,) * n
        cases.append((f"conv{n}d", "Convolution", n,
                      [x, U(C, C // 2, *k, s=0.1), U(C, s=0.1)],
                      dict(kernel=k, pad=(2,) * n, dilate=(2,) * n,
                           num_filter=C, num_group=2, no_bias=False)))
        cases.append((f"deconv{n}d", "Deconvolution", n,
                      [x, U(C, C // 2, *k, s=0.1), U(C // 2, s=0.1)],
                      dict(kernel=k, stride=(2,) * n, pad=ones, adj=ones,
                           num_filter=C // 2, no_bias=False)))
        pool = dict(kernel=k, stride=(2,) * n, pad=ones)
        for tag, attrs in (("max", dict(pool_type="max")),
                           ("avg", dict(pool_type="avg")),
                           ("avg_nopad", dict(pool_type="avg",
                                              count_include_pad=False)),
                           ("sum", dict(pool_type="sum")),
                           ("lp2", dict(pool_type="lp", p_value=2)),
                           ("max_full", dict(pool_type="max",
                                             pooling_convention="full")),
                           ("global_avg", dict(pool_type="avg",
                                               global_pool=True))):
            cases.append((f"pool{n}d_{tag}", "Pooling", n, [x],
                          dict(pool, **attrs)))
        # im2col / col2im (channels first only) on a narrower block
        small = U(2, 8, *[s // 2 for s in sp])
        cases.append((f"im2col{n}d", "im2col", n, [small],
                      dict(kernel=k, pad=ones, stride=(2,) * n)))
        o = [(s // 2 + 2 - 3) // 2 + 1 for s in sp]
        cases.append((f"col2im{n}d", "col2im", n,
                      [U(2, 8 * 3 ** n, int(np.prod(o)))],
                      dict(output_size=tuple(s // 2 for s in sp), kernel=k,
                           pad=ones, stride=(2,) * n)))
    return cases


def _conv_nd_run(torch, fn, inputs, attrs, last, dev, dtype, seed):
    """(outputs, input gradients) of one case in channels-first order:
    the data (and weight) moved to the channel-last layout when
    ``last``, gradients of a seeded cotangent."""
    ts = []
    for i, a in enumerate(inputs):
        t = torch.from_numpy(a)
        if last and i < 2 and t.dim() > 2:
            t = t.movedim(1, -1).contiguous()
        ts.append(t.to(dev, dtype).requires_grad_(True))
    out = fn(*ts, **attrs)
    g = torch.Generator().manual_seed(seed)
    first = out.movedim(-1, 1) if last else out
    ct = torch.randn(first.shape, generator=g).to(dev, dtype)
    grads = torch.autograd.grad(out, ts, ct.movedim(1, -1) if last else ct)
    res = [out.detach()] + [d.detach() for d in grads]
    if last:
        res = [r.movedim(-1, 1) if r.dim() > 2 and i < 3 else r
               for i, r in enumerate(res)]
    return [r.float().cpu() for r in res]


def phase_conv_nd(torch, ctx):
    """The 1-D, 2-D and 3-D convolution and pooling family at the shapes
    users run (:func:`_conv_nd_cases`), card vs CPU: each case in both
    layouts (but ``im2col`` / ``col2im``, channels first) in f32 and bf16,
    forward and the gradient of a seeded cotangent, on the first sample
    (the first two for the column ops) against the CPU's f32 on the same
    values, within CONV_ND_TOL of each tensor's max abs; then the card's
    ms for the forward and backward at the full shape (CUDA events, median
    of 3 after a warm-up)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry

    torch.backends.cudnn.benchmark = True
    card = torch.device(mx.gpu(0))
    rng = np.random.RandomState(SEED + 19)
    rows, ok = {}, True
    counted = _det_zero_counters()
    for name, op, n, inputs, attrs in _conv_nd_cases(rng):
        fn = registry.get_op(op).fn
        one = [inputs[0][:1 if op not in ("im2col", "col2im") else 2]] + \
            inputs[1:]
        layouts = (("first", "last") if op not in ("im2col", "col2im")
                   else ("first",))
        want = _conv_nd_run(torch, fn, one, attrs, False, "cpu",
                            torch.float32, SEED)
        row = {"shape": list(inputs[0].shape)}
        for lay in layouts:
            kw = dict(attrs)
            if lay == "last":
                kw["layout"] = ("NWC", "NHWC", "NDHWC")[n - 1]
            for dt in ("float32", "bfloat16"):
                dtype = getattr(torch, dt)
                got = _conv_nd_run(torch, fn, one, kw, lay == "last",
                                   card, dtype, SEED)
                err = max(_max_abs_ratio(g.numpy(), w.numpy())
                          for g, w in zip(got, want))
                full = []
                for i, a in enumerate(inputs):
                    t = torch.from_numpy(a)
                    if lay == "last" and i < 2 and t.dim() > 2:
                        t = t.movedim(1, -1).contiguous()
                    full.append(t.to(card, dtype).requires_grad_(True))

                def fwd_bwd():
                    out = fn(*full, **kw)
                    out.backward(torch.ones_like(out))

                fwd_bwd()
                marks = [(torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                         for _ in range(3)]
                for a, b in marks:
                    a.record()
                    fwd_bwd()
                    b.record()
                torch.cuda.synchronize()
                key = f"{lay}_{dt}"
                row[key] = {"of_max_abs": err,
                            "fwd_bwd_ms": statistics.median(
                                a.elapsed_time(b) for a, b in marks)}
                row_ok = err <= CONV_ND_TOL[dt]
                row[key]["ok"] = bool(row_ok)
                ok = ok and row_ok
                del full
        rows[name] = row
        torch.cuda.empty_cache()
    launches = {k: fn.launches for k, fn in counted.items()}
    ctx.setdefault("launches", {})["conv_nd"] = launches
    return {"tol_of_max_abs": CONV_ND_TOL, "cases": rows,
            "launches": launches, "cudnn": _cudnn_settings(torch),
            "card": ctx["smi"],
            "ok": bool(ok and not any(launches.values()))}


# ---------------------------------------------------------------------------
# the profiler, serving without pages, nd.sparse
# ---------------------------------------------------------------------------
# rows the unhybridized BERT step must show under their registry names, and
# the op rows a hybridized call must not show (its ops run inside the
# CachedOp row, as the JAX package traces them)
PROFILE_NAMES = ("FullyConnected", "LayerNorm", "_contrib_flash_attention")
PROFILE_INSIDE = PROFILE_NAMES + ("Embedding",)


def _trace_kernels(path):
    """The device kernels a Chrome trace lists: count, and ours by name."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {"kernels": len(names), "bytes": os.path.getsize(path),
            "ours": {k: sum(k in n for n in names) for k in OUR_KERNELS}}


def _site_cost(torch, step, step_s, calls=200_000, rounds=5):
    """What the profiler's op sites cost with the profiler stopped: the
    site calls in one ``step()`` (every call of a site, nested ones too,
    counted by ``sys.setprofile``), the time a site adds to a call (a site
    around a function that returns at once, against that function, the
    best of ``rounds`` loops of ``calls``), and their product over the
    step's time ``step_s``."""
    import sys
    from mxnet_tpu_torch import profiler

    assert not profiler.is_recording()

    def bare(a, b, c, k=None):
        return a

    site = profiler.op_site("probe", bare)
    code, n = site.__code__, [0]

    def count(frame, event, arg):
        if event == "call" and frame.f_code is code:
            n[0] += 1

    sys.setprofile(count)
    try:
        step()
        torch.cuda.synchronize()
    finally:
        sys.setprofile(None)
    best = {"site": math.inf, "bare": math.inf}
    for _ in range(rounds):
        for name, fn in (("site", site), ("bare", bare)):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(1, 2, 3, k=4)
            best[name] = min(best[name], (time.perf_counter() - t0) / calls)
    added = best["site"] - best["bare"]
    return {"site_calls_a_step": n[0], "ns_added_a_call": added * 1e9,
            "ns_bare_call": best["bare"] * 1e9,
            "us_a_step": n[0] * added * 1e6, "step_ms": step_s * 1e3,
            "share_of_step": n[0] * added / step_s}


def _profiled_step(torch, step):
    """One unprofiled step, then one between ``profiler.start()`` and
    ``stop()`` with the kernel counters zeroed just before; each ends in
    a sync: (plain ms, profiled ms, start() ms, launches, json rows,
    trace file)."""
    from mxnet_tpu_torch import profiler

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    profiler.reset_stats()
    counted = _det_zero_counters()
    t0 = time.perf_counter()
    profiler.start()
    start_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t0) * 1e3
    profiler.stop()
    launches = {n: fn.launches for n, fn in counted.items()}
    rows = json.loads(profiler.dumps(format="json", reset=True))
    return (plain_ms, prof_ms, start_ms, launches, rows,
            profiler.dump()[-1])


def _torch_profiled_step(torch, step, path):
    """One step in a bare ``torch.profiler`` session (no
    ``mx.profiler`` prime): each of our kernels as [listed in the trace,
    launched]."""
    from torch.profiler import ProfilerActivity, profile

    counted = _det_zero_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    ours = _trace_kernels(path)["ours"]
    return {k: [ours[k], counted[c].launches]
            for k, c in OUR_KERNEL_COUNTER.items()}


def phase_profile_bert(torch, ctx):
    """gluon_bert's BERT-base step (32 x 512, Adam through gluon.Trainer)
    under ``mx.profiler``: once with ``hybridize(False)``, once
    hybridized.  Unhybridized the ranked rows name FullyConnected,
    LayerNorm and _contrib_flash_attention; hybridized one
    ``CachedOp:<class>`` row and no op row from inside it; the trace
    segment lists each of our kernels as often as its wrapper's counter
    saw it launched; each profiled step launches K1 26 and K3-K5 12
    times, as an unprofiled step.  Also the op sites' cost in an eager
    step with the profiler stopped."""
    from mxnet_tpu_torch import profiler

    net, step = ctx.pop("gluon_bert_loop")
    here = os.path.dirname(os.path.abspath(__file__))
    profiler.set_config(filename=os.path.join(here, "build", "profile_bert",
                                              "bert.json"))
    res, ok = {}, True
    want = dict(TRAIN_PER_STEP)
    # the control: the same step in a bare torch.profiler session, whose
    # trace loses some of the first device events late in a process
    net.hybridize(False)
    step()
    os.makedirs(os.path.join(here, "build", "profile_bert"), exist_ok=True)
    res["bare_torch_profiler_traced_and_launched"] = _torch_profiled_step(
        torch, step, os.path.join(here, "build", "profile_bert",
                                  "bare.json"))
    for tag, active in (("eager", False), ("hybridized", True)):
        net.hybridize(active)
        step()  # a first call of this form outside the window
        plain, prof, start_ms, launches, rows, seg = _profiled_step(torch,
                                                                    step)
        names = [r["name"] for r in rows]
        totals = [r["total_ms"] for r in rows]
        trace = _trace_kernels(seg)
        cached = [n for n in names if n.startswith("CachedOp:")]
        if active:
            shape_ok = (len(cached) == 1
                        and not set(names) & set(PROFILE_INSIDE))
        else:
            shape_ok = set(PROFILE_NAMES) <= set(names) and not cached
        traced = {k: [trace["ours"][k], launches[c]]
                  for k, c in OUR_KERNEL_COUNTER.items()}
        this_ok = bool(shape_ok and launches == want
                       and totals == sorted(totals, reverse=True)
                       and trace["kernels"] > 0
                       and all(t == n for t, n in traced.values()))
        ok = ok and this_ok
        ctx.setdefault("launches", {})
        ctx["launches"]["profile_bert"] = {
            n: ctx["launches"].get("profile_bert", {}).get(n, 0) + v
            for n, v in launches.items()}
        res[tag] = {"ok": this_ok, "step_ms": plain, "profiled_step_ms": prof,
                    "start_ms": start_ms,
                    "overhead": prof / plain, "rows": len(rows),
                    "top5": rows[:5], "cached_op_rows": cached,
                    "launches": launches, "trace": trace,
                    "traced_and_launched": traced,
                    "trace_file": os.path.relpath(seg, here)}
        if not active:
            res[tag]["profiler_sites_stopped"] = _site_cost(
                torch, step, plain / 1e3)
    net.hybridize()
    return {"model": "bert_base", "batch": TRAIN_BATCH, "seq_len": TRAIN_LEN,
            "launches_expected_a_step": want, **res, "card": ctx["smi"],
            "ok": ok}


FP_SLOTS, FP_LEN, FP_REQUESTS, FP_NEW = 8, 64, 8, 16


def phase_serve_fullprefix(torch, ctx):
    """Transformer-big's decoder over a fixed source (serve's model and
    seeded weights; a seeded 8-token source per slot) served by
    ``FullPrefixAdapter``: no pages, the prompt in the slot's (8, 64)
    buffer, the decoder over the whole buffer every step.  8 requests of
    4-24 prompt tokens, 16 new tokens each.  Tokens equal a host greedy
    loop over the same buffer through the same logits function on the
    card, and so does the buffer of the engine's last step (each token
    written after its position); K1 3 a decoder layer a step (18), K2
    0."""
    from mxnet_tpu_torch.serving import (FullPrefixAdapter, Request,
                                         ServingEngine)

    model = ctx["model"]
    vocab, S, L = 32000, FP_SLOTS, FP_LEN
    dev = next(model.parameters()).device
    rng = np.random.RandomState(SEED + 40)
    with torch.no_grad():
        src = torch.from_numpy(rng.randint(3, vocab, (S, 8)).astype(
            np.int32)).to(dev)
        mem, keep = model._encode_h(src)
    seen = {}

    def logits_fn(buf):
        seen["buf"] = buf.clone()
        return model._decode_h(buf, mem, keep)

    prompts = [rng.randint(3, vocab, rng.randint(4, 25)).astype(np.int32)
               for _ in range(FP_REQUESTS)]

    def requests():
        return [Request(p, max_new_tokens=FP_NEW, bos_id=1, eos_id=-1)
                for p in prompts]

    kw = dict(slots=S, max_len=L)
    ServingEngine(FullPrefixAdapter(logits_fn, L), **kw).serve(
        requests()[:2])
    eng = ServingEngine(FullPrefixAdapter(logits_fn, L), **kw)
    reqs = requests()
    out, launches, wall = _counted(torch, lambda: eng.serve(reqs))
    toks = [[int(t) for t in out[r.id]] for r in reqs]
    engine_buf = seen["buf"].cpu().numpy()
    steps = eng.step_count
    n_layers = len(model.decoder.layers)
    expected = _expected(3 * n_layers * steps, 0)
    ctx.setdefault("launches", {})["serve_fullprefix"] = launches
    # the host greedy loop: every row of the same buffer through the same
    # function, the engine's gather and selection
    buf = torch.zeros((S, L), dtype=torch.int32, device=dev)
    for i, p in enumerate(prompts):
        buf[i, :len(p)] = torch.from_numpy(p)
    pos = torch.tensor([len(p) - 1 for p in prompts], device=dev)
    rows = torch.arange(S, device=dev)
    loop = []
    with torch.no_grad():
        for _ in range(FP_NEW):
            lg = logits_fn(buf)
            loop_buf = seen["buf"].cpu().numpy()
            at = pos[:, None, None].expand(-1, 1, lg.shape[-1])
            nxt = torch.argmax(torch.log_softmax(lg.gather(1, at)[:, 0],
                                                 dim=-1), dim=-1)
            loop.append(nxt.cpu().numpy())
            buf[rows, torch.clamp(pos + 1, max=L - 1)] = nxt.to(torch.int32)
            pos = pos + 1
    loop = np.stack(loop, axis=1).tolist()
    bursts = [t / n * 1e3 for n, t in eng.burst_times if n]
    return {"model": "transformer_big decoder", "slots": S, "max_len": L,
            "requests": FP_REQUESTS, "prompt_lengths": [len(p) for p in
                                                        prompts],
            "new_tokens": FP_NEW, "steps": steps, "wall_s": wall,
            "tokens_per_s": FP_REQUESTS * FP_NEW / wall,
            "step_ms_median": statistics.median(bursts),
            "launches": launches, "launches_expected": expected,
            "k1_a_step": 3 * n_layers, "tokens_equal_host_loop":
            toks == loop, "last_buffer_equal": bool(np.array_equal(
                engine_buf, loop_buf)), "pool_bytes": eng.pool_bytes,
            "distinct_tokens": len({t for r in toks for t in r}),
            "card": ctx["smi"],
            "ok": bool(toks == loop and np.array_equal(engine_buf, loop_buf)
                       and launches == expected
                       and eng.pool_bytes == 0
                       and all(len(t) == FP_NEW for t in toks))}


# the sparse-gradient LSTM: MXNet's word_language_model defaults (lr 20,
# clip 0.25 a token), dropout 0 for the comparison.  Each of 20 sparse
# steps is held to a dense step from the same state on the same batch:
# the loss and every parameter after it within SPARSE_LM_STEP_TOL
# (relative L2; measured at most 6.9e-10 on an H100).  Two 20-step runs
# from the same weights drift apart by the order of each embedding row's
# sum (the sparse gradient's index_add_ against the dense lookup's
# backward), which 20 steps at lr 20 amplify to about 1e-4 and which
# differs from one run to the next: the drift is reported beside that
# of a dense run whose embedding gradient is summed by index_add_ (the
# same sums in another order) and of a dense rerun, and not gated.
# (Float64 does not remove it: the dense update rounds every weight
# through f32, as the reference's ops do, and the lazy one adds an f32
# step to the rows.)
SPARSE_LM_LR, SPARSE_LM_CLIP, SPARSE_LM_STEPS = 20.0, 0.25, 20
SPARSE_LM_STEP_TOL = 1e-6


def _swap_encoder(torch, net, kind):
    """Give ``net``'s encoder, under the same name, a row-sparse gradient
    (``kind`` "sparse": ``Embedding(sparse_grad=True)``) or a dense one
    summed by ``index_add_`` ("atomic": the dense lookup with only its
    sums' order changed); "dense" keeps it."""
    from mxnet_tpu_torch.gluon import nn

    old = net.encoder
    if kind == "sparse":
        net.encoder = nn.Embedding(old.input_dim, old.output_dim,
                                   sparse_grad=True, prefix=old.prefix)
    elif kind == "atomic":
        class Lookup(torch.autograd.Function):
            @staticmethod
            def forward(fctx, idx, weight):
                fctx.save_for_backward(idx)
                fctx.rows = weight.shape[0]
                return weight[idx]

            @staticmethod
            def backward(fctx, g):
                (idx,) = fctx.saved_tensors
                width = g.shape[-1]
                return None, g.new_zeros((fctx.rows, width)).index_add_(
                    0, idx.reshape(-1), g.reshape(-1, width))

        class AtomicEmbedding(nn.Embedding):
            def forward(self, x):
                return Lookup.apply(x.long().clamp(0, self.input_dim - 1),
                                    self.weight)

        net.encoder = AtomicEmbedding(old.input_dim, old.output_dim,
                                      prefix=old.prefix)
    return net


def _lm_step_fn(torch, net, dev):
    """``step(x, y, hidden) -> (loss, hidden, encoder grad stype, rows)``:
    one Trainer step of the LSTM LM (SGD lr 20, clip 0.25 a token)."""
    from mxnet_tpu_torch import autograd, gluon

    params = net.collect_params()
    enc = next(p for p in params.values()
               if p.name.endswith("embedding0_weight"))
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": SPARSE_LM_LR})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def step(x, y, hidden):
        batch = x.shape[1]
        hidden = [h.detach() for h in hidden]
        with autograd.record():
            logits, hidden = net(x, hidden)
            loss = loss_fn(logits, y.reshape((-1,)))
        loss.backward()
        g = enc.grad()
        info = (g.stype, int(g._data.shape[0]))
        gluon.utils.clip_global_norm([p.grad() for p in params.values()],
                                     SPARSE_LM_CLIP * LM_BPTT * batch)
        trainer.step(LM_BPTT * batch)
        return loss.mean(), hidden, info

    return step


def _rel_l2_params(torch, a_net, b_net):
    b_params = b_net.collect_params()
    out = {}
    for k, p in a_net.collect_params().items():
        a = p.data()._data.detach().double()
        b = b_params[k].data()._data.detach().double()
        out[k] = float((a - b).norm() / max(float(b.norm()), 1e-30))
    return out


def _lm_run(torch, net, dev, batches):
    """20 steps of ``net`` from its weights: (losses, seconds after the
    first step)."""
    step = _lm_step_fn(torch, net, dev)
    hidden = net.begin_state(LM_BATCH, ctx=dev)
    losses = []
    for k in range(SPARSE_LM_STEPS):
        if k == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        loss, hidden, _ = step(*batches[k % len(batches)], hidden)
        losses.append(loss)
    torch.cuda.synchronize()
    return [float(v.asscalar()) for v in losses], time.perf_counter() - t0


def phase_train_sparse_lm(torch, ctx):
    """The medium LSTM LM (vocabulary 10,000, 650, 2 x 650, batch 20 x
    35) with ``Embedding(sparse_grad=True)``, SGD lr 20, clip 0.25 a
    token, dropout 0 (plain SGD with wd 0 updates the same either way):
    20 steps, each held to a dense step from the same state within
    SPARSE_LM_STEP_TOL, its gradient a RowSparseNDArray of the batch's
    distinct ids; then 20-step runs (sparse, dense, a dense rerun, a
    dense run summing the embedding gradient by index_add_) from the
    same weights, timed, their drift from the dense run reported; and
    the profiler sites' cost in a dense step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.models import lstm_lm_medium

    torch.cuda.empty_cache()
    dev = mx.gpu(0)
    mx.random.seed(SEED + 30)
    start = lstm_lm_medium(dropout=0.0, prefix="slm_")
    start.initialize(mx.init.Uniform(0.05), ctx=dev)

    def fresh(kind):
        net = _swap_encoder(torch, lstm_lm_medium(dropout=0.0,
                                                  prefix="slm_"), kind)
        net.initialize(ctx=dev)
        mine = net.collect_params()
        for k, p in start.collect_params().items():
            mine[k].set_data(p.data()._data)
        return net

    host = _lm_batches(LM_BATCH, SEED + 30)
    ids = [len(np.unique(x)) for x, _ in host]
    batches = [(nd.array(x, ctx=dev), nd.array(y, ctx=dev))
               for x, y in host]
    counted = _det_zero_counters()
    # each sparse step against a dense step from the same state
    sparse_net, shadow = fresh("sparse"), fresh("dense")
    s_step = _lm_step_fn(torch, sparse_net, dev)
    d_step = _lm_step_fn(torch, shadow, dev)
    hidden = sparse_net.begin_state(LM_BATCH, ctx=dev)
    per_step, grads = [], []
    for k in range(SPARSE_LM_STEPS):
        for key, p in sparse_net.collect_params().items():
            shadow.collect_params()[key].set_data(p.data()._data)
        x, y = batches[k % len(batches)]
        d_loss, _, d_info = d_step(x, y, hidden)
        s_loss, hidden, s_info = s_step(x, y, hidden)
        a, b = float(s_loss.asscalar()), float(d_loss.asscalar())
        rel = _rel_l2_params(torch, sparse_net, shadow)
        per_step.append({"loss_rel": abs(a - b) / abs(b),
                         "param_rel_l2_max": max(rel.values()),
                         "worst": max(rel, key=rel.get)})
        grads.append((s_info[0], s_info[1], ids[k % len(batches)],
                      d_info[0]))
    # the 20-step runs from the same weights, timed after their first step
    runs = {}
    for kind in ("sparse", "dense", "dense_rerun", "atomic"):
        net = fresh(kind.split("_")[0])
        losses, wall = _lm_run(torch, net, dev, batches)
        runs[kind] = (losses, wall, net)
    launches = {n: fn.launches for n, fn in counted.items()}
    ctx.setdefault("launches", {})["train_sparse_lm"] = launches
    ld, wd, dnet = runs["dense"]
    drift = {kind: {"loss_rel_max": max(abs(a - b) / abs(b)
                                        for a, b in zip(runs[kind][0], ld)),
                    "param_rel_l2": _rel_l2_params(torch, runs[kind][2],
                                                   dnet)}
             for kind in ("sparse", "dense_rerun", "atomic")}
    for d in drift.values():
        d["param_rel_l2_max"] = max(d["param_rel_l2"].values())
    step_loss = max(r["loss_rel"] for r in per_step)
    step_param = max(r["param_rel_l2_max"] for r in per_step)
    grads_ok = all(st == "row_sparse" and 0 < rows <= n and dst == "default"
                   for st, rows, n, dst in grads)
    tokens = (SPARSE_LM_STEPS - 1) * LM_BPTT * LM_BATCH
    d_step = _lm_step_fn(torch, dnet, dev)
    hidden = dnet.begin_state(LM_BATCH, ctx=dev)
    sites = _site_cost(torch, lambda: d_step(*batches[0], hidden),
                       wd / (SPARSE_LM_STEPS - 1))
    ls = runs["sparse"][0]
    walls = {k: v[1] for k, v in runs.items()}
    del start, sparse_net, shadow, runs, dnet, batches
    torch.cuda.empty_cache()
    return {"model": "lstm_lm_medium", "vocab": LM_VOCAB, "batch": LM_BATCH,
            "bptt": LM_BPTT, "lr": SPARSE_LM_LR, "clip": SPARSE_LM_CLIP,
            "steps": SPARSE_LM_STEPS, "tol_step_rel_l2": SPARSE_LM_STEP_TOL,
            "per_step_loss_rel_max": step_loss,
            "per_step_param_rel_l2_max": step_param, "per_step": per_step,
            "tokens_per_s": {k: tokens / w for k, w in walls.items()},
            "losses_sparse": ls, "losses_dense": ld,
            "run_drift_from_dense": drift,
            "grad_rows_and_distinct_ids": [[r, n] for _, r, n, _ in grads],
            "profiler_sites_stopped": sites,
            "launches": launches, "card": ctx["smi"],
            "ok": bool(grads_ok and step_loss <= SPARSE_LM_STEP_TOL
                       and step_param <= SPARSE_LM_STEP_TOL
                       and all(math.isfinite(v) for v in ls + ld)
                       and not any(launches.values()))}


# lazy Adam at WikiText-103's vocabulary (267,735, as GluonNLP's
# WikiText103 counts it): untouched rows exactly as they started, touched
# rows the rule's (mxnet_tpu/optimizer/optimizer.py:231-240) in float64
# on the host from the same aggregated gradients
WT103_VOCAB = 267_735
SPARSE_ADAM = {"learning_rate": 1e-3, "wd": 1e-4}
SPARSE_ADAM_STEPS = 5
SPARSE_ADAM_TOL = {"weight_abs": 1e-6, "moment_of_max_abs": 1e-5}


def _lazy_adam_f64(w0, records, lr, wd, b1=0.9, b2=0.999, eps=1e-8):
    """Replay the lazy Adam rule in float64 over ``records`` (each a step's
    (ids, f32 summed rows, rescale)) from the rows ``w0``: (weight, mean,
    var) of those rows."""
    w = w0.astype(np.float64)
    mean, var = np.zeros_like(w), np.zeros_like(w)
    rows = records[0][3]
    for t, (ids, vals, rescale, _) in enumerate(records, 1):
        at = np.searchsorted(rows, ids)
        g = vals.astype(np.float64) * rescale + wd * w[at]
        lr_t = lr * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        mean[at] = b1 * mean[at] + (1 - b1) * g
        var[at] = b2 * var[at] + (1 - b2) * g * g
        w[at] -= lr_t * mean[at] / (np.sqrt(var[at]) + eps)
    return w, mean, var


def phase_train_sparse_adam(torch, ctx):
    """The LSTM LM at WikiText-103's vocabulary (267,735 x 650 embedding
    with ``sparse_grad=True``, 2 x 650, dense decoder) trained 5 steps
    with lazy Adam (lr 1e-3, wd 1e-4) through ``gluon.Trainer``, clip
    0.25 a token.  Rows no batch touched: bit-identical in the weight,
    zero in both moments; touched rows within SPARSE_ADAM_TOL of the rule
    in float64.  Then the embedding's lazy update timed against a dense
    ``adam_update`` of the same weight (CUDA events)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.models import lstm_lm_medium
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray
    from mxnet_tpu_torch.optimizer import Adam

    torch.cuda.empty_cache()
    dev = mx.gpu(0)
    mx.random.seed(SEED + 50)
    t0 = time.perf_counter()
    net = _swap_encoder(torch, lstm_lm_medium(
        vocab_size=WT103_VOCAB, dropout=0.0, prefix="wt_"), "sparse")
    net.initialize(mx.init.Uniform(0.05), ctx=dev)
    init_s = time.perf_counter() - t0
    params = net.collect_params()
    enc = params["wt_embedding0_weight"]
    w0 = enc.data()._data.detach().clone()
    trainer = gluon.Trainer(params, "adam", dict(SPARSE_ADAM))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    host = _lm_batches(LM_BATCH, SEED + 50, vocab=WT103_VOCAB)
    batches = [(nd.array(x, ctx=dev), nd.array(y, ctx=dev))
               for x, y in host]
    hidden = net.begin_state(LM_BATCH, ctx=dev)
    n_tok = LM_BPTT * LM_BATCH
    records, losses = [], []
    counted = _det_zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(SPARSE_ADAM_STEPS):
        x, y = batches[k % len(batches)]
        hidden = [h.detach() for h in hidden]
        with autograd.record():
            logits, hidden = net(x, hidden)
            loss = loss_fn(logits, y.reshape((-1,)))
        loss.backward()
        gluon.utils.clip_global_norm([p.grad() for p in params.values()],
                                     SPARSE_LM_CLIP * n_tok)
        g = enc.grad()
        records.append((g._aux["indices"].cpu().numpy(),
                        g._data.cpu().numpy(), 1.0 / n_tok, None))
        trainer.step(n_tok)
        losses.append(loss.mean())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counted.items()}
    ctx.setdefault("launches", {})["train_sparse_adam"] = launches
    losses = [float(v.asscalar()) for v in losses]
    touched = np.unique(np.concatenate([r[0] for r in records]))
    records = [(i, v, s, touched) for i, v, s, _ in records]
    idx = trainer._param2idx[enc.name]
    mean, var = trainer._updaters[0].states[idx]
    w1 = enc.data()._data.detach()
    keep = torch.ones(WT103_VOCAB, dtype=torch.bool, device=w1.device)
    keep[torch.from_numpy(touched).to(w1.device)] = False
    untouched_ok = bool(torch.equal(w1[keep], w0[keep])
                        and not mean._data[keep].any()
                        and not var._data[keep].any())
    rw, rm, rv = _lazy_adam_f64(w0[torch.from_numpy(touched).to(
        w1.device)].cpu().numpy(), records, SPARSE_ADAM["learning_rate"],
        SPARSE_ADAM["wd"])
    sel = torch.from_numpy(touched).to(w1.device)
    err = {"weight_abs": float(np.abs(w1[sel].cpu().numpy() - rw).max()),
           "moment_of_max_abs": max(
               float(np.abs(m._data[sel].cpu().numpy() - r).max()
                     / max(np.abs(r).max(), 1e-30))
               for m, r in ((mean, rm), (var, rv)))}
    # the embedding's update alone: lazy (the last step's gradient) vs a
    # dense adam_update of the same weight
    ids_t = torch.from_numpy(records[-1][0]).to(dev)
    vals_t = torch.from_numpy(records[-1][1]).to(dev)
    g_rs = RowSparseNDArray(vals_t, {"indices": ids_t}, tuple(w1.shape),
                            ctx=dev)
    w_nd = NDArray(w1.clone(), ctx=dev)
    st = (NDArray(torch.zeros_like(w1), ctx=dev),
          NDArray(torch.zeros_like(w1), ctx=dev))
    opt = Adam(rescale_grad=1.0 / n_tok, **SPARSE_ADAM)
    lazy_ms = time_ms(torch, lambda: opt.update(0, w_nd, g_rs, st),
                      samples=10, reps=5)
    g_dense = g_rs.todense()
    dense_ms = time_ms(torch, lambda: nd.adam_update(
        w_nd, g_dense, st[0], st[1], lr=1e-3, wd=1e-4,
        rescale_grad=1.0 / n_tok), samples=10, reps=5)
    row_bytes = 650 * 4
    peak = torch.cuda.max_memory_allocated() / 1e9
    del net, trainer, batches, w_nd, st, g_dense, w0, mean, var
    torch.cuda.empty_cache()
    return {"model": "lstm LM, WikiText-103 vocabulary", "vocab":
            WT103_VOCAB, "embed": 650, "init_s": init_s,
            "steps": SPARSE_ADAM_STEPS, "optimizer": SPARSE_ADAM,
            "wall_s": wall, "tokens_per_s": SPARSE_ADAM_STEPS * n_tok / wall,
            "losses": losses, "rows_touched": int(touched.size),
            "rows_a_step": [int(r[0].size) for r in records],
            "untouched_bit_identical": untouched_ok, "errors": err,
            "tol": SPARSE_ADAM_TOL,
            "embedding_update_ms": {"lazy": lazy_ms, "dense_adam_update":
                                    dense_ms, "dense_over_lazy":
                                    dense_ms / lazy_ms},
            "dense_update_bytes": 7 * WT103_VOCAB * row_bytes,
            "max_memory_allocated_gb": peak, "launches": launches,
            "card": ctx["smi"],
            "ok": bool(untouched_ok and all(math.isfinite(v) for v in losses)
                       and all(err[k] <= SPARSE_ADAM_TOL[k] for k in err)
                       and not any(launches.values()))}


# an Avazu-shaped LibSVM file: 65,536 rows of 15 distinct 1-based feature
# ids in [1, 1,000,000], value 1, a 0/1 label
SVM_ROWS, SVM_NNZ, SVM_FEAT, SVM_BATCH = 65_536, 15, 1_000_000, 8192
SVM_TOL = 1e-5  # of the product's max abs, against float64


def _write_libsvm(path, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, SVM_FEAT + 1, (SVM_ROWS, SVM_NNZ))
    while True:  # redraw the rows with a repeated id
        ids.sort(axis=1)
        dup = (np.diff(ids, axis=1) == 0).any(axis=1)
        if not dup.any():
            break
        ids[dup] = rng.randint(1, SVM_FEAT + 1, (int(dup.sum()), SVM_NNZ))
    labels = rng.randint(0, 2, SVM_ROWS)
    order = rng.rand(SVM_ROWS, SVM_NNZ).argsort(axis=1)  # unsorted on disk
    shuffled = np.take_along_axis(ids, order, axis=1)
    with open(path, "w") as f:
        f.writelines(f"{lab} " + " ".join(f"{i}:1" for i in row) + "\n"
                     for lab, row in zip(labels, shuffled.tolist()))


def _read_libsvm(path):
    """The phase's own reader (numpy on the file's tokens): labels and
    each row's sorted 0-based ids and values."""
    with open(path) as f:
        tok = np.array(f.read().split()).reshape(SVM_ROWS, SVM_NNZ + 1)
    labels = tok[:, 0].astype(np.float32)
    pairs = np.char.partition(tok[:, 1:], ":")
    ids = pairs[..., 0].astype(np.int64) - 1
    vals = pairs[..., 2].astype(np.float32)
    order = ids.argsort(axis=1)
    return (labels, np.take_along_axis(ids, order, axis=1),
            np.take_along_axis(vals, order, axis=1))


def phase_libsvm_sparse(torch, ctx):
    """``LibSVMIter(data_shape=(1000000,), batch_size=8192, one_based=True)``
    over a seeded Avazu-shaped file written here: each batch's indptr,
    indices and values equal the phase's own numpy reader's; ``nd.sparse.
    dot(batch, w)`` with w (1,000,000, 1) and ``dot(batch, r,
    transpose_a=True)`` with r (8192, 1) within SVM_TOL of float64; the
    phase's peak device memory under 1 GB (no dense batch)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io, nd

    here = os.path.dirname(os.path.abspath(__file__))
    folder = os.path.join(here, "build", "libsvm")
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, "avazu_shaped.libsvm")
    t0 = time.perf_counter()
    _write_libsvm(path, SEED + 60)
    write_s = time.perf_counter() - t0
    labels, ids, vals = _read_libsvm(path)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dev = mx.gpu(0)
    t0 = time.perf_counter()
    it = io.LibSVMIter(path, data_shape=(SVM_FEAT,), batch_size=SVM_BATCH,
                       one_based=True, ctx=dev)
    parse_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED + 61)
    w_np = rng.randn(SVM_FEAT, 1).astype(np.float32)
    r_np = rng.randn(SVM_BATCH, 1).astype(np.float32)
    w, r = nd.array(w_np, ctx=dev), nd.array(r_np, ctx=dev)
    counted = _det_zero_counters()

    def epoch(products):
        it.reset()
        out = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for b in it:
            csr = b.data[0]
            if products:
                out.append((csr, nd.sparse.dot(csr, w),
                            nd.sparse.dot(csr, r, transpose_a=True)))
            else:
                out.append((csr, b.label[0]))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    alone, alone_s = epoch(False)
    with_dot, dot_s = epoch(True)
    launches = {n: fn.launches for n, fn in counted.items()}
    ctx.setdefault("launches", {})["libsvm_sparse"] = launches
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    comps_ok, dot_err, tdot_err = True, 0.0, 0.0
    for k, ((csr, lab), (_, y, yt)) in enumerate(zip(alone, with_dot)):
        rows = slice(k * SVM_BATCH, (k + 1) * SVM_BATCH)
        want_ptr = np.arange(0, SVM_BATCH * SVM_NNZ + 1, SVM_NNZ)
        comps_ok = comps_ok and bool(
            np.array_equal(csr.indptr.asnumpy(), want_ptr)
            and np.array_equal(csr.indices.asnumpy(), ids[rows].ravel())
            and np.array_equal(csr.data.asnumpy(), vals[rows].ravel())
            and np.array_equal(lab.asnumpy(), labels[rows]))
        ref = w_np.astype(np.float64)[ids[rows]].sum(axis=1)
        dot_err = max(dot_err, float(np.abs(y.asnumpy() - ref).max()
                                     / np.abs(ref).max()))
        reft = np.bincount(ids[rows].ravel(), minlength=SVM_FEAT,
                           weights=np.repeat(r_np[:, 0].astype(np.float64),
                                             SVM_NNZ))[:, None]
        tdot_err = max(tdot_err, float(np.abs(yt.asnumpy() - reft).max()
                                       / np.abs(reft).max()))
    return {"rows": SVM_ROWS, "features": SVM_FEAT, "nnz_a_row": SVM_NNZ,
            "batch": SVM_BATCH, "batches": len(alone),
            "file_mb": os.path.getsize(path) / 1e6, "write_s": write_s,
            "parse_s": parse_s, "rows_per_s_iterator": SVM_ROWS / alone_s,
            "rows_per_s_with_products": SVM_ROWS / dot_s,
            "components_equal": comps_ok, "dot_of_max_abs": dot_err,
            "dot_transpose_a_of_max_abs": tdot_err, "tol": SVM_TOL,
            "peak_device_gb": peak_gb, "launches": launches,
            "card": ctx["smi"],
            "ok": bool(comps_ok and len(alone) == SVM_ROWS // SVM_BATCH
                       and dot_err <= SVM_TOL and tdot_err <= SVM_TOL
                       and peak_gb < 1.0 and not any(launches.values()))}


# ---------------------------------------------------------------------------
# BERT as bench.py builds it (dropout 0.1, the dense route), the graph
# spellings, gluon.contrib's Estimator and cells, nd.Custom
# ---------------------------------------------------------------------------
DENSE_WARMUP, DENSE_STEPS = 2, 5  # bench.py:670-690
DENSE_PREDICT_BATCH = 8
# the masked f32 step's batch and phase_train_parity's bounds: the loss
# within 1e-5 relative, each gradient within 1e-3 of its max abs
DENSE_PARITY_BATCH, DENSE_VLEN = (2, 128), (64, 128)
DENSE_PARITY_TOL = {"loss_rel": 1e-5, "grad_of_max": 1e-3}
# per step of BERT-base at dropout 0.1 in training: every LayerNorm on
# K1, every attention dense (plain torch, as the JAX package leaves it
# to XLA)
DENSE_PER_STEP = {**{n: 0 for n in ALL_KERNELS}, "layer_norm": 26}


def _bert_tokens(torch, shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, BERT_VOCAB, shape).astype(np.int32))


def _zero_launches(torch, counters):
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    _wgmma16_zero()


def _read_launches(torch, counters):
    """Every wrapper's launches and the ``wgmma16`` design's since
    ``_zero_launches``."""
    torch.cuda.synchronize()
    return {n: fn.launches for n, fn in counters.items()}, _wgmma16_read()


def _dense_parity(torch):
    """One masked f32 step (dropout 0, ``valid_length`` seeded in
    DENSE_VLEN) of BERT-base on the card and on the CPU from the same
    weights: loss and three gradients, and the card step's launches."""
    from mxnet_tpu_torch.models.bert import bert_base

    net = bert_base(BERT_VOCAB, dropout=0.0,
                    generator=torch.Generator().manual_seed(SEED + 21))
    cpu_net = bert_base(BERT_VOCAB, dropout=0.0, device="cpu")
    cpu_net.load_state_dict({k: v.cpu() for k, v in
                             net.state_dict().items()})
    names = ("bert.encoder.layers.0.attn.qkv.weight", "bert.embed_ln.weight",
             "decoder.weight")
    tokens = _bert_tokens(torch, DENSE_PARITY_BATCH, SEED + 22)
    lo, hi = DENSE_VLEN
    vlen = torch.from_numpy(np.random.RandomState(SEED + 23).randint(
        lo, hi + 1, DENSE_PARITY_BATCH[0]).astype(np.float32))
    mlm = _mlm_loss(torch)
    counters = _counters()

    def forward_backward(model, device):
        model.train()
        model.zero_grad(set_to_none=True)
        t = tokens.to(device)
        loss = mlm(model(t, None, vlen.to(device)), t.float()).float().mean()
        loss.backward()
        params = dict(model.named_parameters())
        grads = {n: params[n].grad.detach().cpu() for n in names}
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    _zero_launches(torch, counters)
    loss_g, grads_g = forward_backward(net, next(net.parameters()).device)
    launches, wgmma16 = _read_launches(torch, counters)
    loss_c, grads_c = forward_backward(cpu_net, torch.device("cpu"))
    rel = abs(loss_g - loss_c) / abs(loss_c)
    diffs = {n: {"max_abs_diff": float((grads_g[n] - grads_c[n]).abs().max()),
                 "max_abs": float(grads_c[n].abs().max())} for n in names}
    ok = (rel <= DENSE_PARITY_TOL["loss_rel"]
          and all(d["max_abs_diff"] <= DENSE_PARITY_TOL["grad_of_max"]
                  * d["max_abs"] for d in diffs.values())
          and launches == DENSE_PER_STEP)
    del net, cpu_net
    return {"batch": list(DENSE_PARITY_BATCH),
            "valid_length": vlen.tolist(), "loss_card": loss_g,
            "loss_cpu": loss_c, "loss_rel_diff": rel, "grads": diffs,
            "tol": DENSE_PARITY_TOL, "launches": launches,
            "launches_wgmma16": wgmma16, "ok": bool(ok)}


def phase_train_bert_dense(torch, ctx):
    """BERT-base as bench.py:670-690 builds it: ``bert_base()`` at its
    default dropout of 0.1, cast to bf16, 32 x 512, Adam at 1e-4 through
    ``DataParallelStep``, 2 warm-up and 5 timed steps on one repeated
    seeded batch.  In training every attention takes the dense route
    (attention dropout is active): K1 26 launches a step, K3-K5 none.
    Then one predict-mode NDArray forward of the same model takes the
    fused route (K3 12 times, all of the ``wgmma16`` design), and one
    masked f32 step (``valid_length``, dropout 0) is held against the
    CPU (DENSE_PARITY_TOL)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.block import cast
    from mxnet_tpu_torch.models.bert import bert_base
    from mxnet_tpu_torch.parallel import DataParallelStep

    for key in ("model", "adapter", "cpu_model", "bert", "train_step",
                "gluon_bert_loop"):
        ctx.pop(key, None)
    torch.cuda.empty_cache()
    model = cast(bert_base(BERT_VOCAB,
                           generator=torch.Generator().manual_seed(SEED)),
                 "bfloat16")
    rate = model.bert.encoder.layers[0].attn.attn_drop.rate
    step = DataParallelStep(model, _mlm_loss(torch), optimizer="adam",
                            optimizer_params={"learning_rate": 1e-4})
    tokens = _bert_tokens(torch, (TRAIN_BATCH, TRAIN_LEN), SEED).cuda()
    labels = tokens.float()
    torch.cuda.reset_peak_memory_stats()
    warm = [float(step.step(tokens, labels)) for _ in range(DENSE_WARMUP)]
    counters = _counters()
    _zero_launches(torch, counters)
    losses, step_ms, wall = _train_steps(torch, step, tokens, labels,
                                         DENSE_STEPS)
    launches, wgmma16 = _read_launches(torch, counters)
    ctx["launches"]["train_bert_dense"] = launches
    ctx.setdefault("launches_wgmma16", {})["train_bert_dense"] = wgmma16
    expected = {n: k * DENSE_STEPS for n, k in DENSE_PER_STEP.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = _step_profile(torch, lambda: step.step(tokens, labels))
    tps = TRAIN_BATCH * TRAIN_LEN * DENSE_STEPS / wall
    all_losses = warm + losses
    train_ok = (all(math.isfinite(x) for x in all_losses)
                and all_losses[-1] < all_losses[0] and launches == expected
                and not any(wgmma16.values()) and rate == 0.1)

    # predict mode: MXNet's flag off, attention dropout inactive -> fused
    _zero_launches(torch, counters)
    with autograd.predict_mode():
        out = model(mx.nd.NDArray(tokens[:DENSE_PREDICT_BATCH]))
    pred_launches, pred_w16 = _read_launches(torch, counters)
    ctx["launches"]["train_bert_dense_predict"] = pred_launches
    ctx["launches_wgmma16"]["train_bert_dense_predict"] = pred_w16
    pred_ok = (bool(torch.isfinite(out.data.float()).all())
               and pred_launches["layer_norm"] == 26
               and pred_launches["flash_attention_fwd"] == 12
               and pred_w16["flash_attention_fwd"] == 12
               and pred_launches["flash_attention_dq"] == 0
               and pred_launches["flash_attention_dkv"] == 0)
    del out, step, model
    torch.cuda.empty_cache()
    parity = _dense_parity(torch)
    torch.cuda.empty_cache()
    return {
        "model": "bert_base", "dropout": rate, "dtype": "bfloat16",
        "batch": TRAIN_BATCH, "seq_len": TRAIN_LEN, "optimizer": "adam",
        "learning_rate": 1e-4, "warmup": DENSE_WARMUP, "steps": DENSE_STEPS,
        "warmup_losses": warm, "losses": losses, "wall_s": wall,
        "tokens_per_s": tps, "step_ms_median": statistics.median(step_ms),
        "step_ms": step_ms, "max_memory_allocated_gb": peak_gb,
        "profile_one_step": prof, "launches": launches,
        "launches_expected": expected, "launches_wgmma16": wgmma16,
        "predict": {"batch": DENSE_PREDICT_BATCH, "launches": pred_launches,
                    "launches_wgmma16": pred_w16, "ok": pred_ok},
        "masked_f32_step": parity, "card": ctx["smi"],
        "ok": bool(train_ok and pred_ok and parity["ok"])}


# the graphs' outputs against the eager blocks', max |diff| / max |eager|
# (the zoo's export bound; both run the same kernels on the card)
GRAPH_TOL = ZOO_EXPORT_TOL
GRAPH_BERT_BATCH = (2, 128)
# Transformer-big's widths at 2 + 2 layers
GRAPH_S2S = {"vocab": 32000, "units": 1024, "hidden": 4096, "heads": 16,
             "layers": 2, "batch": 2, "src": 32, "tgt": 24}
GRAPH_DET_BATCH = 2
GRAPH_RNN = {"hidden": 256, "layers": 2, "input": 128}


def _exports_dir():
    """``build/exports``: the exports and checkpoints of the graph and
    Estimator phases, removed as each is read back."""
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, "build", "exports")
    os.makedirs(path, exist_ok=True)
    return path


def _graph_roundtrip(torch, mx, net, names, inputs, want, counters=None):
    """Export ``net`` with ``names``, load it as ``SymbolBlock`` on the
    card and run it in predict mode on ``inputs`` (NDArrays): its
    outputs against ``want`` (numpy) and the graph's node count; with
    ``counters``, the kernels launched by the SymbolBlock's forward."""
    path = os.path.join(_exports_dir(), f"g-{os.getpid()}")
    t0 = time.perf_counter()
    net.export(path, 0, input_names=names)
    with open(f"{path}-symbol.json") as f:
        ops = [n["op"] for n in json.load(f)["nodes"]]
    sb = mx.gluon.SymbolBlock.imports(f"{path}-symbol.json", list(names),
                                      f"{path}-0000.params", ctx=mx.gpu(0))
    if counters is not None:
        _zero_launches(torch, counters)
    got = sb(*inputs)
    got = got if isinstance(got, (list, tuple)) else [got]
    got = [g.asnumpy() for g in got]
    row = {"nodes": len(ops), "export_load_run_s": time.perf_counter() - t0,
           "of_max_abs": [_max_abs_ratio(g, w) for g, w in zip(got, want)]}
    if counters is not None:
        row["launches"], row["launches_wgmma16"] = _read_launches(torch, counters)
    row["ok"] = bool(len(got) == len(want)
                     and max(row["of_max_abs"]) <= GRAPH_TOL)
    for suffix in ("-symbol.json", "-0000.params"):
        os.remove(path + suffix)
    return row, ops, sb


def _raises(fn):
    try:
        fn()
    except AttributeError as e:
        return f"AttributeError: {e}"[:200]
    return None


def _graph_bert(torch, mx, counters):
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.models.bert import bert_base

    net = bert_base(BERT_VOCAB,
                    generator=torch.Generator().manual_seed(SEED + 31))
    net.eval()
    tokens = _bert_tokens(torch, GRAPH_BERT_BATCH, SEED + 32).cuda()
    with torch.no_grad():
        want = net(tokens).float().cpu().numpy()
    x = mx.nd.NDArray(tokens)
    row, ops, sb = _graph_roundtrip(torch, mx, net, ("data",), [x], [want],
                                    counters)
    with autograd.train_mode():
        trained = sb(x).asnumpy()
    row["dropout_nodes"] = ops.count("Dropout")
    row["train_mode_of_max_abs"] = _max_abs_ratio(trained, want)
    lay = row["launches"]
    row["ok"] = bool(row["ok"] and ops.count("LayerNorm") == 26
                     and ops.count("_contrib_flash_attention") == 12
                     and lay["layer_norm"] == 26
                     and lay["flash_attention_fwd"] == 12
                     and lay["flash_attention_dq"] == 0
                     and row["dropout_nodes"] == 25
                     and row["train_mode_of_max_abs"] > 10 * GRAPH_TOL)
    # with a valid_length the body reads inputs.shape: no graph, as in JAX
    row["valid_length_export"] = _raises(lambda: net.export(
        os.path.join(_exports_dir(), "vl"), 0,
        input_names=("data", "types", "valid_length")))
    # the masked encoder: the graph a valid_length batch runs past its mask
    lo, hi = DENSE_VLEN
    vlen = np.random.RandomState(SEED + 33).randint(lo, hi + 1,
                                                    GRAPH_BERT_BATCH[0])
    B, T = GRAPH_BERT_BATCH
    keep = (np.arange(T)[None] < vlen[:, None]).astype(np.float32)
    mask = keep[:, :, None] * keep[:, None, :]
    units = net.bert.pooler.weight.shape[0]
    h = np.random.RandomState(SEED + 34).randn(B, T, units).astype(
        np.float32)
    with torch.no_grad():
        want_enc = net.bert.encoder(torch.from_numpy(h).cuda(),
                                    torch.from_numpy(mask).cuda())
    enc, enc_ops, _ = _graph_roundtrip(
        torch, mx, net.bert.encoder, ("data", "mask"),
        [mx.nd.array(h, ctx=mx.gpu(0)), mx.nd.array(mask, ctx=mx.gpu(0))],
        [want_enc.cpu().numpy()], counters)
    enc["ok"] = bool(enc["ok"] and enc_ops.count("batch_dot") == 24
                     and enc["launches"]["layer_norm"] == 24
                     and enc["launches"]["flash_attention_fwd"] == 0)
    row["masked_encoder"] = enc
    row["ok"] = bool(row["ok"] and row["valid_length_export"] is not None
                     and enc["ok"])
    del net, sb
    return row


def _graph_seq2seq(torch, mx):
    from mxnet_tpu_torch.models.transformer import Transformer

    c = GRAPH_S2S
    net = Transformer(c["vocab"], units=c["units"], hidden_size=c["hidden"],
                      num_heads=c["heads"], num_layers=c["layers"],
                      dropout=0.3,
                      generator=torch.Generator().manual_seed(SEED + 41))
    net.eval()
    rng = np.random.RandomState(SEED + 42)
    src = rng.randint(3, c["vocab"], (c["batch"], c["src"])).astype(np.int32)
    tgt = rng.randint(3, c["vocab"], (c["batch"], c["tgt"])).astype(np.int32)
    src[1, -7:] = 0  # padding: the key-padding masks matter
    tgt[1, -5:] = 0
    st, tt = torch.from_numpy(src).cuda(), torch.from_numpy(tgt).cuda()
    with torch.no_grad():
        want = net(st, tt).cpu().numpy()
    row, ops, sb = _graph_roundtrip(
        torch, mx, net, ("src", "tgt"),
        [mx.nd.NDArray(st), mx.nd.NDArray(tt)], [want])
    row["ok"] = bool(row["ok"] and ops.count("cumsum") == c["layers"]
                     and ops.count("batch_dot") == 6 * c["layers"])
    del net, sb
    return row


def _graph_detectors(torch, mx):
    from mxnet_tpu_torch.models import faster_rcnn_small, ssd_300

    rows = {}
    x = np.random.RandomState(SEED + 51).rand(
        GRAPH_DET_BATCH, 3, DET_RES, DET_RES).astype(np.float32)
    xn = mx.nd.array(x, ctx=mx.gpu(0))
    for name, make in (("ssd_512", lambda: ssd_300(num_classes=DET_CLASSES)),
                       ("faster_rcnn", lambda: faster_rcnn_small(
                           num_classes=DET_CLASSES))):
        net = make()
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        if name == "faster_rcnn":
            net.detect(xn)  # both stages' deferred shapes
        else:
            net(xn)
        net.eval()
        with torch.no_grad():
            want = [o.cpu().numpy() for o in net(xn.data)]
        rows[name], _, sb = _graph_roundtrip(torch, mx, net, ("data",),
                                             [xn], want)
        del net, sb
    return rows


def _graph_rnn(torch, mx):
    """No recurrent cell or layer traces a graph in either package: the
    layer's export and each two-cell stack's ``unroll`` on Symbols
    raise, as the JAX blocks' do."""
    from mxnet_tpu_torch.gluon import rnn

    c = GRAPH_RNN
    rows = {}
    layer = rnn.LSTM(c["hidden"], num_layers=c["layers"],
                     input_size=c["input"])
    layer.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    rows["LSTM"] = {"export": _raises(lambda: layer.export(
        os.path.join(_exports_dir(), "lstm"), 0))}
    cells = {"RNNCell": lambda: rnn.RNNCell(c["hidden"],
                                            input_size=c["input"]),
             "LSTMCell": lambda: rnn.LSTMCell(c["hidden"],
                                              input_size=c["input"]),
             "GRUCell": lambda: rnn.GRUCell(c["hidden"],
                                            input_size=c["input"]),
             "DropoutCell": lambda: rnn.DropoutCell(0.5),
             "ZoneoutCell": lambda: rnn.ZoneoutCell(
                 rnn.RNNCell(c["input"], input_size=c["input"]), 0.3, 0.3),
             "ResidualCell": lambda: rnn.ResidualCell(
                 rnn.GRUCell(c["input"], input_size=c["input"]))}
    for name, make in cells.items():
        stack = rnn.SequentialRNNCell()
        stack.add(make())
        stack.add(make())
        stack.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        sym = mx.sym
        names = [f"h{i}" for i in range(len(stack.state_info()))]
        rows[name] = {"stack_unroll_on_symbols": _raises(
            lambda: stack.unroll(2, [sym.var("x0"), sym.var("x1")],
                                 begin_state=[sym.var(n) for n in names]))}
    for row in rows.values():
        row["ok"] = all(v is not None for v in row.values())
    return rows, all(row["ok"] for row in rows.values())


def phase_graph_spellings(torch, ctx):
    """The graph spellings on the card: BERT-base (dropout 0.1) exported
    and loaded as ``SymbolBlock`` (predict mode equal to the eager model,
    K1 26 and K3 12 launched by its LayerNorm and fused-attention nodes,
    train mode's Dropout nodes active), with a ``valid_length`` raising
    as in JAX and the masked encoder's graph instead; the seq2seq
    Transformer-big at 2 + 2 layers and full widths; SSD-512 and
    Faster-RCNN (JAX exports both); ``gluon.rnn.LSTM`` and a two-cell
    stack of each cell, which JAX cannot export: the port raises too.
    Outputs within GRAPH_TOL of max |eager|."""
    import mxnet_tpu_torch as mx

    for key in ("model", "adapter", "cpu_model", "bert", "train_step",
                "gluon_bert_loop"):
        ctx.pop(key, None)
    torch.cuda.empty_cache()
    counters = _counters()
    out = {"tol": GRAPH_TOL}
    out["bert_base"] = bert = _graph_bert(torch, mx, counters)
    enc = bert["masked_encoder"]
    ctx["launches"]["graph_spellings"] = {
        n: bert["launches"][n] + enc["launches"][n] for n in counters}
    ctx.setdefault("launches_wgmma16", {})["graph_spellings"] = {
        n: bert["launches_wgmma16"][n] + enc["launches_wgmma16"][n]
        for n in WGMMA16_KERNELS}
    torch.cuda.empty_cache()
    out["transformer_big_2_2"] = _graph_seq2seq(torch, mx)
    torch.cuda.empty_cache()
    out.update(_graph_detectors(torch, mx))
    rnn_rows, rnn_ok = _graph_rnn(torch, mx)
    out["rnn"] = rnn_rows
    torch.cuda.empty_cache()
    ok = all(out[k]["ok"] for k in ("bert_base", "transformer_big_2_2",
                                    "ssd_512", "faster_rcnn")) and rnn_ok
    return {**out, "card": ctx["smi"], "ok": bool(ok)}


EST_BATCH, EST_TRAIN, EST_VAL, EST_EPOCHS = 64, 8, 2, 2  # batches
EST_LR = 1e-3
EST_LOSS_REL = 1e-6


def _est_batches(mx):
    X, y = _synthetic_mnist((EST_TRAIN + EST_VAL) * EST_BATCH)
    dev = mx.gpu(0)
    out = [(mx.nd.array(X[i:i + EST_BATCH], ctx=dev),
            mx.nd.array(y[i:i + EST_BATCH], ctx=dev))
           for i in range(0, len(X), EST_BATCH)]
    return out[:EST_TRAIN], out[EST_TRAIN:]


def phase_estimator_fit(torch, ctx):
    """``gluon.contrib.estimator``: LeNet at examples/train_mnist.py's
    widths on seeded data, ``Estimator.fit`` for 2 epochs with every
    handler (stopping, metrics, validation every 4 batches, logging,
    checkpoints with the best kept, early stopping), Adam at 1e-3 through
    ``gluon.Trainer``; its per-batch losses against the loop written out
    (``record`` -> ``backward`` -> ``Trainer.step``) from the same
    weights on the card, EST_LOSS_REL relative (cuDNN deterministic);
    the last checkpoint loaded back through ``load_parameters`` equal to
    the fitted net; K1-K7 0."""
    import logging

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.contrib import estimator as E

    folder = os.path.join(_exports_dir(), f"estimator-{os.getpid()}")
    os.makedirs(folder, exist_ok=True)
    counters = _counters()
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        train, val = _est_batches(mx)
        net = _lenet(gluon)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net(train[0][0])
        start = os.path.join(folder, "start.params")
        net.save_parameters(start)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        est = E.Estimator(net, loss_fn, context=mx.gpu(0),
                          trainer=gluon.Trainer(net.collect_params(), "adam",
                                                {"learning_rate": EST_LR}))
        seen = []

        class Losses(E.BatchEnd):
            def batch_end(self, estimator, *args, **kwargs):
                seen.append(float(kwargs["loss"].mean().asscalar()))

        ck = E.CheckpointHandler(folder, "lenet",
                                 monitor=est.train_loss_metric,
                                 save_best=True, max_checkpoints=2)
        handlers = [E.StoppingHandler(max_epoch=EST_EPOCHS),
                    E.MetricHandler(est.train_metrics
                                    + [est.train_loss_metric]),
                    E.ValidationHandler(val, est.evaluate, batch_period=4),
                    E.LoggingHandler(log_interval=4,
                                     metrics=est.train_metrics),
                    ck, E.EarlyStoppingHandler(est.train_metrics[0],
                                               patience=EST_EPOCHS),
                    Losses()]
        records = []
        log = logging.getLogger("mxnet_tpu_torch.estimator")
        catcher = logging.Handler()
        catcher.emit = records.append
        level = log.level
        log.addHandler(catcher)
        log.setLevel(logging.INFO)
        _zero_launches(torch, counters)
        t0 = time.perf_counter()
        est.fit(train, val_data=val, epochs=EST_EPOCHS,
                event_handlers=handlers)
        fit_s = time.perf_counter() - t0
        launches, _ = _read_launches(torch, counters)
        log.removeHandler(catcher)
        log.setLevel(level)
        ctx["launches"]["estimator_fit"] = launches
        val_metrics = est.evaluate(val)

        # the loop written out, from the same weights
        net2 = _lenet(gluon)
        net2.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net2(train[0][0])
        net2.load_parameters(start, ctx=mx.gpu(0))
        trainer2 = gluon.Trainer(net2.collect_params(), "adam",
                                 {"learning_rate": EST_LR})
        manual = []
        for _ in range(EST_EPOCHS):
            for data, label in train:
                with autograd.record():
                    loss = loss_fn(net2(data), label)
                loss.backward()
                trainer2.step(data.shape[0])
                manual.append(float(loss.mean().asscalar()))
        rel = max(abs(a - b) / abs(b) for a, b in zip(seen, manual))
        files = sorted(os.listdir(folder))
        net3 = _lenet(gluon)
        net3.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net3(train[0][0])
        net3.load_parameters(os.path.join(
            folder, f"lenet-epoch{EST_EPOCHS}.params"), ctx=mx.gpu(0))
        same = all(np.array_equal(a.data().asnumpy(), b.data().asnumpy())
                   for a, b in zip(net3.collect_params().values(),
                                   net.collect_params().values()))
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    for name in os.listdir(folder):
        os.remove(os.path.join(folder, name))
    os.rmdir(folder)
    n = EST_EPOCHS * EST_TRAIN
    return {"model": "lenet", "batch": EST_BATCH, "batches": EST_TRAIN,
            "epochs": EST_EPOCHS, "fit_s": fit_s,
            "images_per_s": n * EST_BATCH / fit_s,
            "losses": seen, "loop_losses": manual,
            "max_loss_rel_diff": rel, "tol": EST_LOSS_REL,
            "val": val_metrics, "log_lines": len(records),
            "checkpoint_files": files, "checkpoint_loads_back": same,
            "handlers": [type(h).__name__ for h in handlers],
            "launches": launches, "card": ctx["smi"],
            "ok": bool(len(seen) == len(manual) == n
                       and rel <= EST_LOSS_REL and same
                       and "lenet-best.params" in files
                       and f"lenet-epoch{EST_EPOCHS}.params" in files
                       and len(records) == 2 + EST_EPOCHS * (
                           1 + EST_TRAIN // 4)
                       and not any(launches.values()))}


CONTRIB_TOL = 1e-4  # of max |CPU|: f32 recurrences over 8-16 steps
CONTRIB_CELLS = {"conv2d_lstm": {"input": (16, 32, 32), "hidden": 32,
                                 "seq": 8, "batch": 4},
                 "lstmp": {"input": 64, "hidden": 256, "proj": 128,
                           "seq": 16, "batch": 8},
                 "vardrop_lstm": {"input": 64, "hidden": 128, "seq": 16,
                                  "batch": 8}}
CUSTOM_SHAPE = (1024, 1024)


def _contrib_cell(mx, name):
    crnn = mx.gluon.contrib.rnn
    c = CONTRIB_CELLS[name]
    if name == "conv2d_lstm":
        return crnn.Conv2DLSTMCell(c["input"], c["hidden"], 3, 3,
                                   i2h_pad=1, prefix="c2dlstm_")
    if name == "lstmp":
        return crnn.LSTMPCell(c["hidden"], c["proj"], input_size=c["input"],
                              prefix="lstmp_")
    return crnn.VariationalDropoutCell(
        mx.gluon.rnn.LSTMCell(c["hidden"], input_size=c["input"],
                              prefix="vdlstm_"), 0.0, 0.0, 0.0)


def _unroll_on(mx, cell, x, states, ctx):
    out, st = cell.unroll(x.shape[1], mx.nd.array(x, ctx=ctx), layout="NTC",
                          merge_outputs=True,
                          begin_state=[mx.nd.array(s, ctx=ctx)
                                       for s in states])
    return [out.asnumpy()] + [s.asnumpy() for s in st]


def _register_chip_op(mx):
    op = mx.operator

    @op.register("chip_scaled_square")
    class Prop(op.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class ScaledSquare(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                in_data[0] * in_data[0] * 0.5)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    # the user's gradient, not the forward's derivative
                    self.assign(in_grad[0], req[0],
                                3.0 * in_data[0] * out_grad[0])

            return ScaledSquare()


def phase_contrib_custom(torch, ctx):
    """``gluon.contrib.rnn``'s Conv2DLSTMCell, LSTMPCell and
    VariationalDropoutCell (rates 0) unrolled on the card against the
    same weights and states on the CPU, and an ``nd.Custom`` op's forward
    and user backward card vs CPU, within CONTRIB_TOL of max |CPU|;
    K1-K7 0."""
    import mxnet_tpu_torch as mx

    counters = _counters()
    _zero_launches(torch, counters)
    rows, ok = {}, True
    rng = np.random.RandomState(SEED + 71)
    for name, c in CONTRIB_CELLS.items():
        cell = _contrib_cell(mx, name)
        cell.initialize(mx.init.Xavier(), ctx=mx.cpu())
        inp = c["input"] if isinstance(c["input"], tuple) else (c["input"],)
        x = rng.randn(c["batch"], c["seq"], *inp).astype(np.float32)
        states = [rng.randn(*s["shape"]).astype(np.float32)
                  for s in cell.state_info(c["batch"])]
        t0 = time.perf_counter()
        want = _unroll_on(mx, cell, x, states, mx.cpu())
        cell.collect_params().reset_ctx(mx.gpu(0))
        got = _unroll_on(mx, cell, x, states, mx.gpu(0))
        torch.cuda.synchronize()
        err = max(_max_abs_ratio(g, w) for g, w in zip(got, want))
        rows[name] = {"shape": list(x.shape), "of_max_abs": err,
                      "s": time.perf_counter() - t0,
                      "ok": bool(err <= CONTRIB_TOL)}
        ok = ok and rows[name]["ok"]
    _register_chip_op(mx)
    x = rng.randn(*CUSTOM_SHAPE).astype(np.float32)
    res = []
    for dev in (mx.cpu(), mx.gpu(0)):
        xa = mx.nd.array(x, ctx=dev)
        xa.attach_grad()
        with mx.autograd.record():
            y = mx.nd.Custom(xa, op_type="chip_scaled_square")
            loss = (y * 2.0).sum()
        loss.backward()
        res.append((y.asnumpy(), xa.grad.asnumpy()))
    (cy, cg), (gy, gg) = res
    custom = {"shape": list(CUSTOM_SHAPE),
              "forward_of_max_abs": _max_abs_ratio(gy, cy),
              "backward_of_max_abs": _max_abs_ratio(gg, cg),
              "user_backward": bool(np.allclose(cg, 6.0 * x, rtol=1e-6))}
    custom["ok"] = bool(custom["forward_of_max_abs"] <= CONTRIB_TOL
                        and custom["backward_of_max_abs"] <= CONTRIB_TOL
                        and custom["user_backward"])
    launches, _ = _read_launches(torch, counters)
    ctx["launches"]["contrib_custom"] = launches
    return {"cells": rows, "custom": custom, "tol": CONTRIB_TOL,
            "launches": launches, "card": ctx["smi"],
            "ok": bool(ok and custom["ok"]
                       and not any(launches.values()))}


# ---------------------------------------------------------------------------
# the last host-side modules: runtime, util, env_vars, rtc; test_utils'
# card-vs-CPU oracles; contrib.onnx on the card; the example scripts
# ---------------------------------------------------------------------------
def phase_runtime_env(torch, ctx):
    """``runtime.Features()`` on the card (CUDA and CUDNN on; TPU, XLA
    and PALLAS off), ``util.get_gpu_count()`` equal to
    ``torch.cuda.device_count()``, ``util.get_gpu_memory(0)`` within 1% of
    ``torch.cuda.mem_get_info(0)`` (total equal), ``env_vars.check()`` over
    the run's environment raising nothing, ``rtc.CudaModule("")`` raising
    ``MXNetError``; K1-K7 0."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import env_vars, rtc, runtime, util

    counters = _counters()
    _zero_launches(torch, counters)
    feats = {k: bool(f.enabled) for k, f in runtime.Features().items()}
    feats_ok = (feats["CUDA"] and feats["CUDNN"]
                and not any(feats[k] for k in ("TPU", "XLA", "PALLAS")))
    count = util.get_gpu_count()
    free, total = util.get_gpu_memory(0)
    t_free, t_total = torch.cuda.mem_get_info(0)
    mem_rel = abs(free - t_free) / max(t_free, 1)
    env_vars._warned = False  # the import's check ran; run it again here
    try:
        env_vars.check(dict(os.environ))
        env_error = None
    except Exception as e:  # noqa: BLE001 - the gate is "raises nothing"
        env_error = f"{type(e).__name__}: {e}"[:300]
    try:
        rtc.CudaModule("")
        rtc_raised = None
    except mx.MXNetError as e:
        rtc_raised = str(e)[:200]
    set_mxnet = sorted(k for k in os.environ if k.startswith("MXNET_"))
    launches, _ = _read_launches(torch, counters)
    ctx["launches"]["runtime_env"] = launches
    return {"features": feats, "features_ok": bool(feats_ok),
            "get_gpu_count": count,
            "device_count": torch.cuda.device_count(),
            "get_gpu_memory": [int(free), int(total)],
            "mem_get_info": [int(t_free), int(t_total)],
            "free_rel_diff": mem_rel, "env_check_error": env_error,
            "mxnet_vars_set": set_mxnet,
            "env_vars_registered": len(env_vars.ENV_VARS),
            "rtc_raised": rtc_raised, "launches": launches,
            "card": ctx["smi"],
            "ok": bool(feats_ok and count == torch.cuda.device_count()
                       and mem_rel <= 0.01 and total == t_total
                       and env_error is None and rtc_raised is not None
                       and not any(launches.values()))}


# check_consistency over [cpu, gpu(0)]: (name, shapes of the numpy inputs,
# launches expected on the card side, wgmma16 launches expected)
TU_LN, TU_ALN, TU_SCE = (16384, 768), (8192, 1024), (2048, 30522)
TU_FLASH = (24, 512, 64)  # N 24 (2 x 12 heads), L 512, hd 64
TU_GRAD = (1, 8, 16)      # check_numeric_gradient's q, k, v: 384 elements
TU_GRAD_EPS, TU_GRAD_RTOL, TU_GRAD_ATOL = 1e-2, 5e-2, 1e-3


def _tu_inputs(rng, name):
    if name == "LayerNorm":
        return [rng.randn(*TU_LN), 1 + 0.1 * rng.randn(TU_LN[1]),
                0.1 * rng.randn(TU_LN[1])]
    if name.startswith("flash_attention"):
        return [0.5 * rng.randn(*TU_FLASH) for _ in range(3)]
    if name == "add_layer_norm":
        return [rng.randn(*TU_ALN), rng.randn(*TU_ALN),
                1 + 0.1 * rng.randn(TU_ALN[1]), 0.1 * rng.randn(TU_ALN[1])]
    n, c = TU_SCE
    return [2 * rng.randn(n, c), rng.randint(0, c, n)]


def _tu_fns(mx):
    """The functions check_consistency runs under each context."""
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.passes import FusedKernelPass, PassPipeline

    nd = mx.nd
    fused = PassPipeline([FusedKernelPass()])

    def aln(x, r, g, b):
        # the nd op is plain torch; the fused_kernels pass brings K6
        with fused.scope():
            return nd.contrib.add_layer_norm(x, r, g, b)

    def bf16(q, k, v):
        return nd.contrib.flash_attention(q.astype("bfloat16"),
                                          k.astype("bfloat16"),
                                          v.astype("bfloat16"))

    return {
        "LayerNorm": (lambda x, g, b: nd.LayerNorm(x, g, b),
                      {"layer_norm": 1}, {}),
        "flash_attention_f32": (lambda q, k, v: nd.contrib.flash_attention(
            q, k, v), {"flash_attention_fwd": 1}, {}),
        "flash_attention_bf16": (bf16, {"flash_attention_fwd": 1},
                                 {"flash_attention_fwd": 1}),
        "add_layer_norm": (aln, {"add_layer_norm": 1}, {}),
        # the nd op is plain torch in both packages: no kernel
        "softmax_cross_entropy": (lambda x, y: nd.softmax_cross_entropy(
            x, y), {}, {}),
        # K7 through its wrapper, per-row losses
        "softmax_cross_entropy_kernel": (lambda x, y: mx.nd.NDArray(
            kernels.softmax_cross_entropy(x.data, y.data.long())),
            {"softmax_cross_entropy": 1}, {}),
    }


def _tu_row(torch, mx, counters, name, fn, inputs, want, want16):
    from mxnet_tpu_torch.test_utils import (_dtype_tol, _get_tols,
                                            check_consistency)

    _zero_launches(torch, counters)
    t0 = time.perf_counter()
    try:
        cpu_out, card_out = check_consistency(fn, [mx.cpu(), mx.gpu(0)],
                                              inputs_np=inputs)
        error = None
    except AssertionError as e:
        cpu_out = card_out = None
        error = str(e)[-600:]
    seconds = time.perf_counter() - t0
    launches, w16 = _read_launches(torch, counters)
    expected = {n: want.get(n, 0) for n in counters}
    expected16 = {n: want16.get(n, 0) for n in WGMMA16_KERNELS}
    row = {"shapes": [list(np.shape(a)) for a in inputs], "s": seconds,
           "launches": launches, "launches_wgmma16": w16,
           "launches_exact": launches == expected and w16 == expected16,
           "error": error}
    if cpu_out is not None:
        kind = "bfloat16" if name.endswith("bf16") else "float32"
        rtol, atol = _dtype_tol(kind)
        diff = np.abs(cpu_out.astype(np.float64) - card_out)
        row.update({"dtype": kind, "rtol": rtol, "atol": atol,
                    "max_abs_dev": float(diff.max()),
                    "dev_over_allowed": float(
                        (diff / (atol + rtol * np.abs(card_out))).max())})
    row["ok"] = bool(error is None and row["launches_exact"])
    return row, launches, w16


def phase_test_utils_card(torch, ctx):
    """MXNet's own GPU-backend oracles on the card: ``test_utils.
    check_consistency`` over ``[mx.cpu(), mx.gpu(0)]`` (the CPU side runs
    the plain versions) for ``nd.LayerNorm`` at (16384, 768) (K1),
    ``nd.contrib.flash_attention`` at N 24, L 512, hd 64 in f32 (K3's f32
    core) and bf16 (K3's ``wgmma16`` design), ``nd.contrib.add_layer_norm``
    at (8192, 1024) under the fused_kernels pass (K6), the
    ``nd.softmax_cross_entropy`` op at (2048, 30522) (plain torch in both
    packages: no kernel) and K7's wrapper on the same inputs, each within
    ``_dtype_tol``; then ``check_numeric_gradient`` of the f32 flash
    attention at (1, 8, 16) on the card (K3 once a loss, K4 and K5 once).
    Launch counts exact; each comparison's max deviation beside its
    tolerance."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.test_utils import check_numeric_gradient

    counters = _counters()
    rng = np.random.RandomState(SEED + 91)
    rows, total, total16 = {}, {n: 0 for n in counters}, {
        n: 0 for n in WGMMA16_KERNELS}
    for name, (fn, want, want16) in _tu_fns(mx).items():
        inputs = [np.asarray(a, np.float32) for a in _tu_inputs(rng, name)]
        rows[name], lau, w16 = _tu_row(torch, mx, counters, name, fn,
                                       inputs, want, want16)
        for n in total:
            total[n] += lau[n]
        for n in total16:
            total16[n] += w16[n]
        torch.cuda.empty_cache()

    # the numeric gradient, on the card; its comparisons recorded as made
    q, k, v, w = (rng.randn(*TU_GRAD).astype(np.float32) * s
                  for s in (0.5, 0.5, 0.5, 1.0))
    arrs = [mx.nd.array(a, ctx=mx.gpu(0)) for a in (q, k, v)]
    wt = mx.nd.array(w, ctx=mx.gpu(0))
    devs, real = [], np.testing.assert_allclose

    def spy(actual, desired, *args, **kw):
        devs.append(float(np.abs(np.asarray(actual, np.float64)
                                 - np.asarray(desired)).max()))
        return real(actual, desired, *args, **kw)

    _zero_launches(torch, counters)
    t0 = time.perf_counter()
    np.testing.assert_allclose = spy
    try:
        check_numeric_gradient(
            lambda q_, k_, v_: (mx.nd.contrib.flash_attention(q_, k_, v_)
                                * wt).sum(),
            arrs, eps=TU_GRAD_EPS, rtol=TU_GRAD_RTOL, atol=TU_GRAD_ATOL)
        grad_error = None
    except AssertionError as e:
        grad_error = str(e)[-600:]
    finally:
        np.testing.assert_allclose = real
    launches, w16 = _read_launches(torch, counters)
    elems = 3 * int(np.prod(TU_GRAD))
    want = {n: 0 for n in counters}
    want.update(flash_attention_fwd=1 + 2 * elems, flash_attention_dq=1,
                flash_attention_dkv=1)
    rows["check_numeric_gradient"] = grad = {
        "shape": list(TU_GRAD), "elements": elems, "eps": TU_GRAD_EPS,
        "rtol": TU_GRAD_RTOL, "atol": TU_GRAD_ATOL,
        "max_abs_dev_by_input": devs, "s": time.perf_counter() - t0,
        "launches": launches, "launches_expected": want,
        "error": grad_error,
        "ok": bool(grad_error is None and launches == want
                   and not any(w16.values()))}
    for n in total:
        total[n] += launches[n]
    ctx["launches"]["test_utils_card"] = total
    ctx.setdefault("launches_wgmma16", {})["test_utils_card"] = total16
    return {**rows, "launches": total, "launches_wgmma16": total16,
            "card": ctx["smi"],
            "ok": all(r["ok"] for r in rows.values()) and grad["ok"]}


ONNX_BERT_BATCH = (8, 128)
ONNX_RESNET = (32, 224)
# the int8 net: Transformer-big's FFN widths, as serve_int8 quantizes them
ONNX_QUANT = {"units": 1024, "hidden": 4096, "batch": 64, "calib": 4}
ONNX_BERT_LAUNCHES = {"layer_norm": 26, "flash_attention_fwd": 12}


def _run_qdq_graph(graph, x):
    """A numpy replay of an exported QDQ graph (the oracle of
    ``tests/test_onnx.py``'s ``_run_qdq_graph``)."""
    vals = {"data": x}
    for t in graph["initializer"]:
        vals[t["name"]] = t["array"]
    for n in graph["node"]:
        i = [vals[k] for k in n["input"]]
        op = n["op_type"]
        if op == "QuantizeLinear":
            vals[n["output"][0]] = np.clip(
                np.round(i[0] / i[1]), -128, 127).astype(np.int8)
        elif op == "DequantizeLinear":
            vals[n["output"][0]] = i[0].astype(np.float32) * i[1]
        elif op == "Gemm":
            wm = i[1].T if n["attrs"].get("transB") else i[1]
            vals[n["output"][0]] = i[0] @ wm + i[2]
        elif op == "MatMul":
            vals[n["output"][0]] = i[0] @ i[1]
        elif op == "Add":
            vals[n["output"][0]] = i[0] + i[1]
        elif op == "Relu":
            vals[n["output"][0]] = np.maximum(i[0], 0)
        elif op == "Flatten":
            vals[n["output"][0]] = i[0].reshape(i[0].shape[0], -1)
        else:
            raise AssertionError(f"unexpected op {op}")
    return vals[graph["output"][0]["name"]]


def _onnx_model(torch, mx, counters, net, x, dtype, expected):
    """``net`` (eval mode, on the card) -> its eager output, counted and
    timed -> ``HybridBlock.export`` -> ``export_model`` -> ``import_to_gluon``
    on the card -> the imported forward, counted and timed."""
    from mxnet_tpu_torch.contrib import onnx as onnx_mx

    path = os.path.join(_exports_dir(), f"onnx-{os.getpid()}")
    _zero_launches(torch, counters)
    with torch.no_grad():
        want = net(x).float().cpu().numpy()
    eager_launches, eager16 = _read_launches(torch, counters)
    with torch.no_grad():
        eager_ms = time_ms(torch, lambda: net(x), samples=5, reps=2)
    t0 = time.perf_counter()
    net.export(path, 0)
    export_s = time.perf_counter() - t0
    onnx_path = path + ".onnx"
    t0 = time.perf_counter()
    onnx_mx.export_model(f"{path}-symbol.json", f"{path}-0000.params",
                         [tuple(x.shape)], dtype, onnx_path)
    onnx_s = time.perf_counter() - t0
    onnx_bytes = os.path.getsize(onnx_path)
    t0 = time.perf_counter()
    sb = onnx_mx.import_to_gluon(onnx_path, ctx=mx.gpu(0))
    import_s = time.perf_counter() - t0
    xa = mx.nd.NDArray(x)
    _zero_launches(torch, counters)
    got = sb(xa)
    got = (got[0] if isinstance(got, (list, tuple)) else got).asnumpy()
    imported_launches, imported16 = _read_launches(torch, counters)
    imported_ms = time_ms(torch, lambda: sb(xa), samples=5, reps=2)
    nodes = len(onnx_mx.proto.parse_model(open(onnx_path, "rb").read())[
        "graph"]["node"])
    for suffix in ("-symbol.json", "-0000.params", ".onnx"):
        os.remove(path + suffix)
    want_l = {n: expected.get(n, 0) for n in counters}
    row = {"input": list(x.shape), "onnx_bytes": onnx_bytes,
           "onnx_nodes": nodes, "hybrid_export_s": export_s,
           "export_model_s": onnx_s, "import_to_gluon_s": import_s,
           "eager_ms": eager_ms, "imported_ms": imported_ms,
           "of_max_abs": _max_abs_ratio(got, want), "tol": ZOO_EXPORT_TOL,
           "eager_launches": eager_launches,
           "eager_launches_wgmma16": eager16,
           "imported_launches": imported_launches,
           "imported_launches_wgmma16": imported16,
           "finite": bool(np.isfinite(got).all())}
    row["ok"] = bool(row["finite"] and got.shape == want.shape
                     and row["of_max_abs"] <= ZOO_EXPORT_TOL
                     and eager_launches == want_l
                     and not any(eager16.values())
                     and not any(imported_launches.values())
                     and not any(imported16.values()))
    return row, eager_launches


def _onnx_quantized(torch, mx):
    """A net of Transformer-big's FFN widths quantized to int8 on the card
    (naive calibration on seeded batches), exported as QDQ and replayed
    in numpy: within one step of the data's QuantizeLinear scale (its
    calibrated threshold / 127) of the card's int8 output."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.contrib import onnx as onnx_mx
    from mxnet_tpu_torch.contrib.quantization import quantize_net

    c = ONNX_QUANT
    rng = np.random.RandomState(SEED + 93)
    mx.random.seed(SEED + 93)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(c["hidden"], activation="relu",
                           in_units=c["units"]),
            gluon.nn.Dense(c["units"], in_units=c["hidden"]))
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    calib = [mx.nd.array(rng.randn(c["batch"], c["units"]), ctx=mx.gpu(0))
             for _ in range(c["calib"])]
    qnet = quantize_net(net, calib_data=calib, calib_mode="naive")
    x = rng.randn(c["batch"], c["units"]).astype(np.float32)
    card = qnet(mx.nd.array(x, ctx=mx.gpu(0))).asnumpy()
    path = os.path.join(_exports_dir(), f"q-{os.getpid()}.onnx")
    t0 = time.perf_counter()
    onnx_mx.export_quantized_net(qnet, x.shape, path)
    export_s = time.perf_counter() - t0
    graph = onnx_mx.proto.parse_model(open(path, "rb").read())["graph"]
    nbytes = os.path.getsize(path)
    os.remove(path)
    ops = [n["op_type"] for n in graph["node"]]
    inits = {t["name"]: t["array"] for t in graph["initializer"]}
    first_q = next(n for n in graph["node"] if n["op_type"] == "QuantizeLinear")
    # a scalar initializer is written with dims [1], as the JAX codec does
    step = float(np.asarray(inits[first_q["input"][1]]).reshape(-1)[0])
    replay = _run_qdq_graph(graph, x)
    dev = float(np.abs(replay - card).max())
    int8_weights = sum(1 for a in inits.values()
                       if a.dtype == np.int8 and a.ndim == 2)
    return {"widths": [c["units"], c["hidden"], c["units"]],
            "batch": c["batch"], "onnx_bytes": nbytes, "export_s": export_s,
            "quantize_linear": ops.count("QuantizeLinear"),
            "dequantize_linear": ops.count("DequantizeLinear"),
            "int8_weight_initializers": int8_weights,
            "max_abs_dev": dev, "scale_step": step,
            "output_max_abs": float(np.abs(card).max()),
            "ok": bool(dev <= step and ops.count("QuantizeLinear") == 2
                       and ops.count("DequantizeLinear") == 4
                       and int8_weights == 2)}


def phase_onnx_roundtrip(torch, ctx):
    """``contrib.onnx`` on the card: ``bench.py``'s ``bert_base()`` (f32,
    inference mode, 8 x 128 tokens) and ``resnet50_v1b`` (f32, 32 x 3 x
    224 x 224, BatchNorm stats from one training-mode forward) each
    ``HybridBlock.export``-ed, ``export_model``-ed (opset 11: LayerNorm and
    the fused attention as their decompositions),
    ``import_to_gluon(ctx=mx.gpu(0))``-ed and run once: within
    ZOO_EXPORT_TOL of max |eager|; the eager BERT forward K1 26 and K3 12
    (f32 core), the imported graphs no kernel; the file's bytes, the
    export and import seconds and CUDA-event ms of each forward.  Then
    ``export_quantized_net`` of an int8 net of Transformer-big's FFN
    widths, replayed in numpy against the card (``_onnx_quantized``)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.models.bert import bert_base

    torch.cuda.empty_cache()
    counters = _counters()
    out = {}
    net = bert_base(generator=torch.Generator().manual_seed(SEED + 92))
    net.eval()
    tokens = _bert_tokens(torch, ONNX_BERT_BATCH, SEED + 92).cuda()
    out["bert_base"], launches = _onnx_model(
        torch, mx, counters, net, tokens, np.int32, ONNX_BERT_LAUNCHES)
    del net
    torch.cuda.empty_cache()
    B, R = ONNX_RESNET
    mx.random.seed(SEED + 94)
    net = vision.get_model("resnet50_v1b")
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    x = torch.from_numpy(np.random.RandomState(SEED + 94).rand(
        B, 3, R, R).astype(np.float32)).cuda()
    net.train()
    with torch.no_grad():
        net(x)  # the deferred shapes and BatchNorm's running stats
    net.eval()
    out["resnet50_v1b"], _ = _onnx_model(torch, mx, counters, net, x,
                                         np.float32, {})
    del net
    torch.cuda.empty_cache()
    _zero_launches(torch, counters)
    out["int8_qdq"] = _onnx_quantized(torch, mx)
    quant_launches, _ = _read_launches(torch, counters)
    out["int8_qdq"]["launches"] = quant_launches
    out["int8_qdq"]["ok"] = bool(out["int8_qdq"]["ok"]
                                 and not any(quant_launches.values()))
    ctx["launches"]["onnx_roundtrip"] = launches
    return {**out, "launches": launches, "card": ctx["smi"],
            "ok": all(r["ok"] for r in out.values())}


# the examples as `python -m mxnet_tpu_torch.examples.<name>` runs them,
# with the kernels' launch counters printed at exit
EXAMPLE_RUNNER = (
    "import json, runpy, sys\n"
    "name = sys.argv[1]\n"
    "sys.argv = [name] + sys.argv[2:]\n"
    "from mxnet_tpu_torch.ops import kernels\n"
    "try:\n"
    "    runpy.run_module('mxnet_tpu_torch.examples.' + name,\n"
    "                     run_name='__main__', alter_sys=True)\n"
    "finally:\n"
    "    names = " + repr(ALL_KERNELS) + "\n"
    "    print('LAUNCHES ' + json.dumps({n: getattr(kernels, n).launches\n"
    "                                    for n in names}), flush=True)\n")
EXAMPLE_TIMEOUT = 600
# the cuts (the script's whole run had passed 1,100 s): LeNet 2 epochs of
# the script's 3 (it converges by the second), the others 10 steps of
# their 30 or 20; the scripts' models, widths and batches are untouched
EXAMPLE_EPOCHS_MNIST, EXAMPLE_STEPS = 2, 10


def _example_args(folder):
    """name -> (arguments, cut) of each example's card run: the default
    model at full width; only steps or epochs are cut."""
    img_rec, _, _ = _write_imagenet_rec(folder, 64, SEED + 95)
    det_dir = os.path.join(folder, "det")
    os.makedirs(det_dir)
    det_rec, _, _ = _write_det_rec(det_dir, 64, SEED + 96)
    steps = ["--steps", str(EXAMPLE_STEPS)]
    return {
        "train_mnist": (["--network", "lenet", "--epochs",
                         str(EXAMPLE_EPOCHS_MNIST)],
                        f"{EXAMPLE_EPOCHS_MNIST} epochs of 3"),
        "train_imagenet": (["--rec", img_rec, "--model", "resnet50_v1b",
                            *steps],
                           f"{EXAMPLE_STEPS} steps of 30 (batch 32, 224^2, "
                           "a seeded 64-JPEG RecordIO)"),
        # the RecordIO's boxes carry DET_CLASSES classes
        "train_detection": (["--model", "ssd", "--rec", det_rec,
                             "--num-classes", str(DET_CLASSES), *steps],
                            f"{EXAMPLE_STEPS} steps of 20 (the script's "
                            "96^2, batch 4)"),
        "train_wmt": (["--model", "base", *steps],
                      f"{EXAMPLE_STEPS} steps of 30"),
    }


def _example_numbers(stdout):
    """The losses, accuracies and the throughput line an example
    printed."""
    import re

    number = r"([-+0-9.eE]+|nan|inf)"
    losses = [float(v) for v in re.findall(r"loss[= ]" + number, stdout)]
    losses += [float(v) for v in re.findall(r"-> " + number, stdout)]
    acc = [float(v) for v in re.findall(r"train-accuracy=([0-9.]+)", stdout)]
    through = [line for line in stdout.splitlines()
               if line.startswith("throughput ")]
    return losses, acc, through[-1] if through else None


def _example_row(name, args, cut, proc, out, err, wall):
    lines = out.splitlines()
    launches = next((json.loads(x[len("LAUNCHES "):])
                     for x in lines if x.startswith("LAUNCHES ")), None)
    losses, acc, through = _example_numbers(out)
    want = {n: 0 for n in ALL_KERNELS}
    if name == "train_wmt":
        want["layer_norm"] = TT_PER_STEP["layer_norm"] * EXAMPLE_STEPS
    row = {"args": args, "cut": cut, "returncode": proc.returncode,
           "s": wall, "losses": losses, "accuracies": acc,
           "throughput": through, "launches": launches,
           "launches_expected": want, "stdout_tail": out[-600:],
           "stderr_tail": err[-600:]}
    finite = all(math.isfinite(v) for v in losses) and bool(losses or acc)
    row["ok"] = bool(proc.returncode == 0 and finite
                     and through is not None and launches == want
                     and (name != "train_mnist"
                          or "MNIST example OK" in out))
    return row


def phase_examples(torch, ctx):
    """The four ported example scripts, each a subprocess on the card at
    its default model and full width, the four started together (their
    throughputs share the host and the card): ``train_mnist`` (LeNet),
    ``train_imagenet --rec`` over a seeded 64-image JPEG RecordIO
    (``_write_imagenet_rec``) with ``resnet50_v1b`` at 224^2,
    ``train_detection`` (SSD, ``--rec`` from ``_write_det_rec``),
    ``train_wmt --model base``; epochs and steps cut (``_example_args``).
    Each exits 0 with finite losses (LeNet: its accuracy gate) and prints
    its throughput on a line of its own; K1 30 a step in train_wmt (every
    attention masked: no flash kernel), no kernel in the others."""
    import shutil
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    folder = tempfile.mkdtemp(prefix="examples-", dir=_det_build_dir())
    env = dict(os.environ, PYTHONPATH=here)
    rows, total, procs = {}, {n: 0 for n in ALL_KERNELS}, {}
    try:
        plan = _example_args(folder)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        for name, (args, _) in plan.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", EXAMPLE_RUNNER, name, *args],
                cwd=here, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        for name, proc in procs.items():
            out, err = proc.communicate(
                timeout=max(1.0, EXAMPLE_TIMEOUT - (time.perf_counter()
                                                    - t0)))
            args, cut = plan[name]
            rows[name] = row = _example_row(name, args, cut, proc, out, err,
                                            time.perf_counter() - t0)
            if row["throughput"] is not None:
                print(f"examples {name}: {row['throughput']}", flush=True)
            for n in total:
                total[n] += (row["launches"] or {}).get(n, 0)
        wall = time.perf_counter() - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(folder, ignore_errors=True)
    ctx["launches"]["examples"] = total
    return {**rows, "together_s": wall, "launches": total,
            "card": ctx["smi"],
            "ok": len(rows) == 4 and all(r["ok"] for r in rows.values())}

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

    # launches by path: the serving phases and the training phases add to it
    ctx, failed = {"launches": {}}, []
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
              ("serve_fleet", phase_serve_fleet),
              ("serve_int8", phase_serve_int8),
              ("serve_int4", phase_serve_int4),
              ("serve_fullprefix", phase_serve_fullprefix),
              ("train", phase_train),
              ("train_parity", phase_train_parity),
              ("train_profile", phase_train_profile),
              ("train_bf16", phase_train_bf16),
              ("train_amp", phase_train_amp),
              ("train_amp_fp16", phase_train_amp_fp16),
              ("dist_single", phase_dist_single),
              ("sp_single", phase_sp_single),
              ("train_bert_pp", phase_train_bert_pp),
              ("tp_pp_single", phase_tp_pp_single),
              ("elastic_single", phase_elastic_single),
              ("imperative", phase_imperative),
              ("imperative_bf16", phase_imperative_bf16),
              ("train_resnet", phase_train_resnet),
              ("train_resnet_bf16", phase_train_resnet_bf16),
              ("train_resnet_parity", phase_train_resnet_parity),
              ("train_resnet_profile", phase_train_resnet_profile),
              ("gluon_resnet_amp", phase_gluon_resnet_amp),
              ("train_transformer", phase_train_transformer),
              ("train_transformer_bf16", phase_train_transformer_bf16),
              ("train_transformer_parity", phase_train_transformer_parity),
              ("optimizer", phase_optimizer),
              ("gluon_mnist", phase_gluon_mnist),
              ("gluon_bert", phase_gluon_bert),
              ("profile_bert", phase_profile_bert),
              ("gluon_bert_parity", phase_gluon_bert_parity),
              ("train_ssd", phase_train_ssd),
              ("detect_ssd", phase_detect_ssd),
              ("train_faster_rcnn", phase_train_faster_rcnn),
              ("cv_ops", phase_cv_ops),
              ("train_lstm_lm", phase_train_lstm_lm),
              ("rnn_variants", phase_rnn_variants),
              ("op_catalog", phase_op_catalog),
              ("module_bert", phase_module_bert),
              ("train_resume", phase_train_resume),
              ("module_lstm_bucketing", phase_module_lstm_bucketing),
              ("symbol_api", phase_symbol_api),
              ("train_imagenet", phase_train_imagenet),
              ("zoo_train", phase_zoo_train),
              ("zoo_forward", phase_zoo_forward),
              ("conv_nd", phase_conv_nd),
              ("train_sparse_lm", phase_train_sparse_lm),
              ("train_sparse_adam", phase_train_sparse_adam),
              ("libsvm_sparse", phase_libsvm_sparse),
              ("train_bert_dense", phase_train_bert_dense),
              ("graph_spellings", phase_graph_spellings),
              ("estimator_fit", phase_estimator_fit),
              ("contrib_custom", phase_contrib_custom),
              ("runtime_env", phase_runtime_env),
              ("test_utils_card", phase_test_utils_card),
              ("onnx_roundtrip", phase_onnx_roundtrip),
              ("examples", phase_examples))
    named = sys.argv[1:]
    unknown = sorted(set(named) - {n for n, _ in phases})
    if unknown:
        print(f"chip_smoke: no phase {unknown}", file=sys.stderr)
        return 2
    if named:
        phases = tuple(p for p in phases if p[0] in named)
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
    from mxnet_tpu_torch.parallel import dist

    dist.shutdown()  # the one-rank group of dist_single to elastic_single

    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    if named:
        return 0
    kernels = []
    w16 = ctx.get("launches_wgmma16", {})
    for name, source, replaces, paths in KERNELS:
        k = ctx[name]
        paths = (paths,) if isinstance(paths, str) else paths
        wrapper = name.removesuffix("_wgmma16")
        if wrapper != name:  # the wgmma16 design: its own counts
            by_path = {p: c[wrapper] for p, c in w16.items()}
        elif wrapper in WGMMA16_KERNELS:  # the f32 core: the rest
            by_path = {p: c[wrapper] - w16.get(p, {}).get(wrapper, 0)
                       for p, c in ctx["launches"].items()}
        else:
            by_path = {p: c[name] for p, c in ctx["launches"].items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_path[p] for p in paths),
            "path": paths[0] if len(paths) == 1 else list(paths),
            "launches_by_path": by_path,
            **{key: k[key] for key in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms", "bound_f32_cores_ms",
                                       "bwd_pair_ms", "design")
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
