"""Environment-variable map of the port, the counterpart of
the JAX package's ``env_vars.py`` (reference: the documented variables of
docs/static_site/src/pages/api/faq/env_var.md).

Every variable the JAX package registers is here under the same name,
with what the port does with it, and so is every variable only the port
reads:

  honored      read by the port at the cited site, same semantics;
  absorbed     the responsibility moved into torch or CUDA; the variable
               is accepted but has nothing to configure here (the
               torch-level control is named);
  tool         read by a report tool under ``tools/`` that runs over the
               port's telemetry files (and by its copy under
               ``mxnet_tpu_torch/tools/``, which the port's launcher runs),
               not by the package;
  not honored  the port reads it nowhere yet; the detail names the
               ROADMAP item that queues it, or says that none does.

``describe()`` returns the table; ``check(environ)`` logs (once) each set
``MXNET_*`` variable that has no effect here, as the JAX one does.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Tuple

__all__ = ["ENV_VARS", "describe", "check"]

_STEP = "ROADMAP A.1 (the superstep, with the captured training step)"
_AOT = ("not queued: the port compiles no executables, so there is no "
        "AOT executable cache (aot_cache.py has no counterpart)")
_NO_EFFECT = ("absorbed", "n/a", "not honored", "tool")

# name -> (disposition, detail)
ENV_VARS: Dict[str, Tuple[str, str]] = {
    "MXNET_ENGINE_TYPE": (
        "honored", "NaiveEngine -> every op synchronizes the card after it "
        "runs (engine.py, read once at import)"),
    "MXNET_USE_FUSION": (
        "not honored", "not queued: MX_PALLAS_FUSED is the port's switch "
        "for the fused-kernel pass (passes/builtin.py); ROADMAP C, PR 3"),
    "MXNET_SUBGRAPH_BACKEND": (
        "honored", "partitions symbol graphs at bind time (subgraph.py "
        "env_backend)"),
    "MXNET_PROFILER_AUTOSTART": (
        "honored", "starts the profiler at import (profiler.py)"),
    "MXNET_SAFE_ACCUMULATION": (
        "absorbed", "always on: the CUDA kernels (csrc/*.cu) accumulate "
        "f32 for 16-bit inputs, and cuBLAS/cuDNN accumulate 16-bit GEMMs "
        "and convolutions in f32; setting it to 0 has no effect"),
    "MXNET_TEST_DEVICE": (
        "honored", "test_utils.default_context device selection (cpu or "
        "gpu; gpu is gpu(0))"),
    "MXNET_USE_NATIVE_IO": (
        "not honored", "ROADMAP A.13: the native libmxio pipeline is "
        "parked, so ImageRecordIter is always the Python iterator"),
    "MXNET_EXEC_BULK_EXEC_TRAIN": (
        "absorbed", "ops dispatch eagerly to torch; there is no "
        "per-segment bulking to tune"),
    "MXNET_EXEC_BULK_EXEC_INFERENCE": (
        "absorbed", "same as MXNET_EXEC_BULK_EXEC_TRAIN"),
    "MXNET_GPU_MEM_POOL_TYPE": (
        "absorbed", "PyTorch's caching allocator owns the card's memory; "
        "use PYTORCH_CUDA_ALLOC_CONF"),
    "MXNET_GPU_MEM_POOL_RESERVE": (
        "absorbed", "see MXNET_GPU_MEM_POOL_TYPE"),
    "MXNET_GPU_WORKER_NTHREADS": (
        "absorbed", "no per-device worker threads: work is queued on "
        "torch's CUDA streams"),
    "MXNET_CPU_WORKER_NTHREADS": (
        "absorbed", "host parallelism: preprocess_threads on the data "
        "iterators, num_workers on the DataLoader; torch's intra-op pool "
        "is torch.set_num_threads"),
    "MXNET_CUDNN_AUTOTUNE_DEFAULT": (
        "absorbed", "cuDNN's algorithm search is "
        "torch.backends.cudnn.benchmark, which the caller sets"),
    "MXNET_KVSTORE_USETREE": (
        "absorbed", "no reduction tree to shape: a device list reduces "
        "through torch.cuda.comm (NCCL), processes through one all-reduce "
        "a bucket (kvstore.py)"),
    "MXNET_KVSTORE_BIGARRAY_BOUND": (
        "absorbed", "no PS key sharding: MX_ALLREDUCE_BUCKET_MB sizes the "
        "flat buckets (kvstore.py push_bucketed)"),
    "MXNET_ENABLE_GPU_P2P": (
        "absorbed", "peer access is NCCL's choice (NCCL_P2P_DISABLE)"),
    "MXNET_ENGINE_INFO": (
        "absorbed", "dependency logging: use mx.profiler or "
        "torch.profiler traces"),
    "OMP_NUM_THREADS": (
        "absorbed", "torch's intra-op thread pool and OpenCV read it "
        "themselves at start"),
    "DMLC_ROLE": (
        "absorbed", "every process is a worker (no parameter-server "
        "role); tools/launch.py exports it"),
    "DMLC_PS_ROOT_URI": (
        "honored", "rendezvous host when MX_COORDINATOR is unset "
        "(parallel/dist.py init_from_env)"),
    "DMLC_PS_ROOT_PORT": (
        "honored", "rendezvous port when MX_COORDINATOR is unset "
        "(parallel/dist.py init_from_env)"),
    "DMLC_NUM_WORKER": (
        "honored", "process count: the rendezvous when MX_NUM_PROCS is "
        "unset (parallel/dist.py), the fault harness (fault.py)"),
    "DMLC_WORKER_ID": (
        "honored", "process rank: the rendezvous when MX_PROC_ID is unset "
        "(parallel/dist.py), fault.py rank=, telemetry.py stream naming"),
    "DMLC_NUM_SERVER": (
        "absorbed", "no parameter-server role"),
    "PS_VERBOSE": ("absorbed", "see DMLC_NUM_SERVER"),
    # fault tolerance
    "MX_FAULT_SPEC": (
        "honored", "fault-injection harness: crash / crash-write / "
        "torn-write / slow-write specs with rank=/shard=/if-restart= "
        "qualifiers (fault.py, hooks in checkpoint.py)"),
    "MX_CKPT_SHARDED": (
        "honored", "default AsyncCheckpointer(sharded=): shard-granular "
        "(format 2) checkpoints (checkpoint.py)"),
    "MX_CKPT_SHARD_WAIT_S": (
        "honored", "seconds the leader rank waits for peer shard commit "
        "markers before publishing a sharded step (checkpoint.py)"),
    "MX_RENDEZVOUS_TIMEOUT": (
        "honored", "seconds the rendezvous retries with backoff (default "
        "300; parallel/dist.py)"),
    "MX_RESTART_COUNT": (
        "honored", "gang incarnation index: fault.py if-restart= and "
        "telemetry.py"),
    "MX_ELASTIC": (
        "honored", "set by tools/launch.py --elastic in every incarnation: "
        "a restore onto another world size then records no resize event "
        "(parallel/data_parallel.py load_state_dict), the rendezvous does"),
    "MX_PREV_NUM_PROCS": (
        "honored", "the world size before an elastic resize, exported to "
        "the first incarnation after it (tools/launch.py): a resize "
        "telemetry event at the rendezvous (parallel/dist.py), and the "
        "restore records none (parallel/data_parallel.py)"),
    # launcher contract
    "MX_COORDINATOR": (
        "honored", "host:port of the rendezvous store, rank 0 serves it "
        "(parallel/dist.py init_from_env; tools/launch.py exports it)"),
    "MX_NUM_PROCS": (
        "honored", "gang process count: the rendezvous "
        "(parallel/dist.py), fault.py"),
    "MX_PROC_ID": (
        "honored", "this process's gang rank: the rendezvous "
        "(parallel/dist.py), fault.py rank= qualifier, telemetry.py stream "
        "naming"),
    "MX_LOCAL_RANK": (
        "honored", "this process's card, cuda:<MX_LOCAL_RANK> (default "
        "MX_PROC_ID; parallel/dist.py, exported by tools/launch.py)"),
    "MX_FORCE_CPU": (
        "honored", "1 starts the process group on the CPU with gloo "
        "instead of NCCL on a card (parallel/dist.py; tools/launch.py "
        "--force-cpu)"),
    # fused optimizer apply + bucketed allreduce
    "MX_FUSED_UPDATE": (
        "honored", "0 pins the per-parameter Updater path instead of the "
        "fused optimizer apply (optimizer/fused.py get_updater)"),
    "MX_ALLREDUCE_BUCKET_MB": (
        "honored", "flat-bucket cap of the gradient all-reduce (default "
        "32; 0 = one collective a key): kvstore.py push_bucketed, "
        "DataParallelStep over a mesh (parallel/dist.py bucket_cap_bytes)"),
    # async step pipeline
    "MX_ASYNC_INFLIGHT": (
        "honored", "bounded in-flight step window (default 2; 0 = every "
        "step forced at dispatch), read per step call by "
        "parallel/async_loss.py; DataParallelStep.step, gluon "
        "Trainer.step and Module.update"),
    # superstep + AOT executable cache
    "MX_SUPERSTEP": ("not honored", _STEP),
    "MX_SUPERSTEP_FORCE_CPU": ("not honored", _STEP),
    "MX_EXECUTABLE_CACHE_DIR": ("not honored", _AOT),
    "MX_EXECUTABLE_CACHE": ("not honored", _AOT),
    # inference serving
    "MX_SERVE_SLOTS": (
        "honored", "decode-slot count of the serving engine (default 8; "
        "serving/engine.py ServingEngine)"),
    "MX_SERVE_PAGE_SIZE": (
        "honored", "tokens per KV-cache page (default 16; "
        "serving/engine.py)"),
    "MX_SERVE_POOL_PAGES": (
        "honored", "pages in the per-layer KV pools (default 0 = auto; "
        "serving/engine.py)"),
    "MX_SERVE_QUEUE": (
        "honored", "request-queue bound (default 256; 0 = unbounded; "
        "serving/scheduler.py)"),
    "MX_SERVE_STREAM_EVERY": (
        "honored", "decode steps per stream boundary (default 4; "
        "serving/engine.py)"),
    "MX_SERVE_FLASH": (
        "not honored", "not queued: the port's engine always runs K2 "
        "(csrc/paged_attention.cu) on the card and its plain version on "
        "the CPU; there is no gather path to pin"),
    "MX_SERVE_SAMPLING": (
        "honored", "1 builds the engine with per-slot sampling state "
        "(serving/engine.py)"),
    "MX_SERVE_SPEC_K": (
        "honored", "speculative decoding draft depth (default 0 = off; "
        "serving/engine.py)"),
    "MX_SERVE_PREFIX_CACHE": (
        "honored", "1 enables the copy-on-write prefix cache "
        "(serving/engine.py)"),
    "MX_SERVE_PREFIX_ENTRIES": (
        "honored", "prefix-cache LRU bound (default 64; "
        "serving/engine.py)"),
    "MX_SERVE_PREFIX_CHUNK": (
        "honored", "tokens per ingest dispatch of a missed prefix "
        "(default 8; serving/engine.py)"),
    "MX_SERVE_PORT": (
        "honored", "replica HTTP port: N binds N+rank (serving/router.py "
        "ReplicaServer)"),
    "MX_SERVE_ROUTER_PORT": (
        "honored", "router bind port (serving/router.py Router)"),
    "MX_SERVE_HOST": (
        "honored", "bind host of replica servers and the router (default "
        "127.0.0.1; serving/router.py)"),
    "MX_SERVE_HEALTH_SEC": (
        "honored", "router health-poll cadence in seconds (default 2.0; "
        "serving/router.py Router)"),
    "MX_SERVE_TEMPERATURE": (
        "honored", "default sampling temperature of /generate bodies that "
        "omit it (serving/router.py)"),
    "MX_SERVE_TOP_K": (
        "honored", "default top-k of /generate bodies that omit it "
        "(serving/router.py)"),
    "MX_SERVE_TOP_P": (
        "honored", "default top-p of /generate bodies that omit it "
        "(serving/router.py)"),
    "MX_SERVE_SLO_TTFT_MS": (
        "honored", "submission->first-token SLO in ms "
        "(telemetry.record_serve_request, serving/router.py)"),
    "MX_SERVE_SLO_TPOT_MS": (
        "honored", "time-per-output-token SLO in ms "
        "(telemetry.record_serve_request)"),
    # request tracing
    "MX_RQTRACE": (
        "honored", "0/false/off disables serving request tracing "
        "(serving/router.py rqtrace_enabled)"),
    "MX_RQTRACE_SAMPLE": (
        "honored", "head-based sampling rate of request traces "
        "(serving/router.py mint_trace)"),
    "MX_RQTRACE_TRACEZ_K": (
        "honored", "completed request trees kept by the /tracez rings "
        "(serving/router.py, telemetry.py)"),
    "MX_RQTRACE_STRAGGLER_X": (
        "tool", "tools/serve_report.py's straggler multiple (default "
        "2.0), over the port's telemetry directory"),
    # live metrics endpoint
    "MX_METRICS_PORT": (
        "honored", "per-rank HTTP /metrics /healthz /statusz endpoint "
        "(metrics_server.py)"),
    "MX_METRICS_HOST": (
        "honored", "bind address of the metrics endpoint "
        "(metrics_server.py)"),
    # runtime telemetry
    "MX_TELEMETRY_DIR": (
        "honored", "enables the telemetry recorder: rank-<R>.jsonl and "
        "heartbeat-<R>.json per rank (telemetry.py)"),
    "MX_TELEMETRY_FLUSH_SEC": (
        "honored", "seconds between background flushes (telemetry.py)"),
    "MX_HEARTBEAT_SEC": (
        "honored", "min seconds between heartbeat-file writes "
        "(telemetry.py)"),
    "MX_TELEMETRY_RETRACE_LIMIT": (
        "honored", "distinct input signatures one executor may accumulate "
        "before the retrace-storm warning fires (telemetry.py)"),
    "MX_TELEMETRY_SPANS": (
        "honored", "0 disables span tracing while keeping step events "
        "and heartbeats (telemetry.py spans_enabled)"),
    "MX_TRACE_EXPORT": (
        "honored", "exports a Chrome/Perfetto trace.json and per-rank "
        "OpenMetrics snapshots at exit (telemetry.py)"),
    "MX_TRACE_WINDOW": (
        "tool", "tools/trace_report.py's window of steady steps "
        "(default 20), over the port's telemetry directory"),
    "MX_TRACE_STRAGGLER_PCT": (
        "tool", "tools/trace_report.py's straggler percent (default 25)"),
    "MX_TRACE_HEARTBEAT_GAP_SEC": (
        "tool", "tools/trace_report.py's silent-stream gap (default 30)"),
    # parallelism Plan
    "MX_PLAN": (
        "honored", "the planner's strategy override, auto | dp | tp | pp | "
        "sp | ring | ulysses (parallel/planner.py plan_for)"),
    # precision
    "MX_AMP": (
        "honored", "graph-level AMP for steps built without an explicit "
        "precision: bf16 or fp16 (precision/config.py "
        "PrecisionConfig.from_env)"),
    "MX_AMP_POLICY": (
        "honored", "inline-JSON override of the AMP op-class lists "
        "(precision/config.py AmpPolicy)"),
    "MX_LOSS_SCALE": (
        "honored", "loss scaling under MX_AMP: dynamic, a fixed scale, or "
        "0/off (precision/config.py)"),
    "MX_QUANTIZE": (
        "honored", "int8 routes maybe_quantize_adapter to a calibrated "
        "int8 serving adapter (precision/quantize.py)"),
    "MX_QUANT_CALIB": (
        "honored", "calibration mode for MX_QUANTIZE: naive or entropy "
        "(precision/quantize.py)"),
    "MX_SERVE_INT4": (
        "honored", "int4 routes maybe_int4_adapter to a weight-only int4 "
        "serving adapter (precision/quantize.py)"),
    "MX_QUANT_GROUP": (
        "honored", "group size of MX_SERVE_INT4's int4 scales (default "
        "32; precision/quantize.py)"),
    # pass pipeline
    "MX_PASSES": (
        "honored", "comma-separated per-pass toggles of every constructed "
        "pass pipeline (passes/pipeline.py apply_env_toggles)"),
    "MX_PALLAS_FUSED": (
        "honored", "fused-kernel substitution pass: auto (default) on "
        "where a card is present, 1 forces it (the CPU runs the plain "
        "versions), 0 pins the stock ops "
        "(passes/builtin.fused_kernels_from_env)"),
    # memory observability
    "MX_MEMWATCH": (
        "honored", "device-memory watchdog riding the telemetry recorder; "
        "0 disables it (memwatch.py)"),
    "MX_MEMWATCH_EVERY": (
        "honored", "memory-sample cadence in step boundaries (default 10; "
        "memwatch.py)"),
    "MX_MEMWATCH_LEAK_WINDOW": (
        "honored", "samples in the leak detector's window (default 12; "
        "memwatch.py)"),
    # the port's own
    "CUDA_HOME": (
        "honored", "the CUDA toolkit whose nvcc builds csrc/*.cu (default "
        "/usr/local/cuda; ops/kernels/_build.py)"),
}

_warned = False


def describe() -> str:
    width = max(len(k) for k in ENV_VARS) + 2
    lines = [f"{'Variable':<{width}}{'Disposition':<13}Detail"]
    for name, (disp, detail) in sorted(ENV_VARS.items()):
        lines.append(f"{name:<{width}}{disp:<13}{detail}")
    return "\n".join(lines)


def check(environ=None) -> None:
    """Log (once) any set MXNET_* variable that has no effect here."""
    global _warned
    if _warned:
        return
    _warned = True
    environ = environ if environ is not None else os.environ
    log = logging.getLogger("mxnet_tpu_torch")
    for name, value in environ.items():
        if not name.startswith("MXNET_"):
            continue
        disp, detail = ENV_VARS.get(name, (None, None))
        if disp in _NO_EFFECT:
            log.info("env var %s=%s has no effect in the port (%s): %s",
                     name, value, disp, detail)
        elif disp is None:
            log.info("env var %s is not recognized by mxnet_tpu_torch (see "
                     "mxnet_tpu_torch.env_vars.describe())", name)
