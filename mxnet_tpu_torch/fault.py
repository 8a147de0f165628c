"""Fault injection and preemption handling.

The counterpart of ``mxnet_tpu/fault.py``: an env-driven chaos harness
whose hooks are wired into ``AsyncCheckpointer`` (checkpoint.py) so every
failure path — worker crash, crash mid-write, torn write, slow disk — can
be reproduced on demand, plus the SIGTERM preemption handler that turns
an eviction into one final synchronous checkpoint and a distinguishable
exit code.  The grammar, exit codes and messages are the JAX module's.

Fault spec grammar (``MX_FAULT_SPEC``, ';'-separated specs)::

    spec       := kind (":" key "=" value)*
    kind       := "crash" | "crash-write" | "torn-write" | "slow-write"
                | "oom" | "crash-rendezvous"
    key        := "step" | "ms" | "file" | "rank" | "shard"
                | "if-restart" | "if-world"

  crash:step=N        hard os._exit(EXIT_INJECTED_CRASH) when the training
                      step counter reaches N (before N's checkpoint is
                      enqueued — deterministic: step N is never on disk)
  oom:step=N          raise a synthetic RESOURCE_EXHAUSTED inside step N's
                      dispatch (a training step calls on_dispatch before
                      its dispatch), so the OOM post-mortem
                      path — memwatch.emit_oom_report + the supervisor's
                      death diagnosis — is testable without real HBM
                      exhaustion
  crash-write:step=N  die mid-write of step N's checkpoint: payload files
                      are on disk but meta.json is not, and the staging
                      ``.tmp-N`` dir is left behind (never published)
  torn-write:step=N   publish step N, then truncate its files in place —
                      the on-disk shape of a power loss between write and
                      fsync; file=meta|params|all (default all) picks which.
                      shard=R instead corrupts ONE rank's shard file
                      (params-shard-R.nd) of a shard-granular checkpoint —
                      the single-torn-shard chaos shape (validation must
                      reject the step and restore fall back)
  slow-write:ms=M     sleep M ms at the start of every checkpoint write
                      (step=N restricts it to one write)
  crash-rendezvous    die DURING the gang rendezvous (a rendezvous
                      calls on_rendezvous right before
                      the process group forms) — the re-rendezvous
                      failure shape of an elastic resize; no step=

Qualifiers on any spec: ``rank=R`` fires only on that worker
(MX_PROC_ID/DMLC_WORKER_ID), ``if-restart=K`` only on gang incarnation
K (MX_RESTART_COUNT, exported by tools/launch.py --max-restarts), and
``if-world=N`` only when the gang's world size (MX_NUM_PROCS/
DMLC_NUM_WORKER) is N — so ``crash:step=30:rank=1:if-restart=0`` kills
rank 1 on the first attempt and lets the restarted gang run clean, and
``crash:step=30:rank=2:if-world=3`` kills rank 2 *permanently at world
size 3* (every incarnation) while letting an elastic resize to 2 ranks
(tools/launch.py --elastic) run clean — the scriptable "lost host"
(docs/FAULT_TOLERANCE.md §Elastic resize).
"""
from __future__ import annotations

import os
import signal
import time
from typing import List, Optional

from .base import MXNetError

__all__ = ["EXIT_INJECTED_CRASH", "EXIT_PREEMPTED", "Fault", "parse_spec",
           "active_faults", "install_preemption_handler"]

# Exit code of an injected `crash` fault — distinguishable from a real bug's
# traceback exit (1) and from signal deaths (negative returncodes).
EXIT_INJECTED_CRASH = 57
# Exit code after a SIGTERM-triggered final checkpoint ("clean preemption").
# tools/launch.py hard-codes the same value.
EXIT_PREEMPTED = 83

_KINDS = ("crash", "crash-write", "torn-write", "slow-write", "oom",
          "crash-rendezvous")
_KEYS = ("step", "ms", "file", "rank", "shard", "if-restart",
         "if-world")


class Fault:
    """One parsed fault: kind + trigger qualifiers."""

    __slots__ = ("kind", "step", "ms", "file", "rank", "shard",
                 "if_restart", "if_world")

    def __init__(self, kind: str, step: Optional[int] = None,
                 ms: Optional[int] = None, file: str = "all",
                 rank: Optional[int] = None,
                 shard: Optional[int] = None,
                 if_restart: Optional[int] = None,
                 if_world: Optional[int] = None):
        self.kind = kind
        self.step = step
        self.ms = ms
        self.file = file
        self.rank = rank
        self.shard = shard
        self.if_restart = if_restart
        self.if_world = if_world

    def __repr__(self):
        quals = [f"{k}={v}" for k in _KEYS
                 if (v := getattr(self, k.replace("-", "_"), None))
                 is not None and not (k == "file" and v == "all")]
        return f"Fault({self.kind}:{':'.join(quals)})"

    def applies_here(self) -> bool:
        """Rank / incarnation qualifiers against this process's env."""
        if self.rank is not None:
            r = os.environ.get("MX_PROC_ID",
                               os.environ.get("DMLC_WORKER_ID", "0"))
            if int(r) != self.rank:
                return False
        if self.if_restart is not None:
            if int(os.environ.get("MX_RESTART_COUNT", "0")) != self.if_restart:
                return False
        if self.if_world is not None:
            w = os.environ.get("MX_NUM_PROCS",
                               os.environ.get("DMLC_NUM_WORKER", "1"))
            if int(w) != self.if_world:
                return False
        return True


def parse_spec(text: str) -> List[Fault]:
    """Parse an ``MX_FAULT_SPEC`` string; raises MXNetError on bad grammar."""
    faults = []
    for spec in filter(None, (s.strip() for s in text.split(";"))):
        parts = spec.split(":")
        kind = parts[0].strip()
        if kind not in _KINDS:
            raise MXNetError(
                f"MX_FAULT_SPEC: unknown fault kind {kind!r} in {spec!r} "
                f"(known: {', '.join(_KINDS)})")
        kw = {}
        for qual in parts[1:]:
            key, sep, val = qual.partition("=")
            key = key.strip()
            if not sep or key not in _KEYS:
                raise MXNetError(
                    f"MX_FAULT_SPEC: bad qualifier {qual!r} in {spec!r} "
                    f"(known: {', '.join(_KEYS)})")
            if key == "file":
                if val not in ("meta", "params", "all"):
                    raise MXNetError(
                        f"MX_FAULT_SPEC: file= must be meta|params|all, "
                        f"got {val!r}")
                kw["file"] = val
            else:
                try:
                    kw[key.replace("-", "_")] = int(val)
                except ValueError:
                    raise MXNetError(
                        f"MX_FAULT_SPEC: {key}= wants an integer, got "
                        f"{val!r}") from None
        f = Fault(kind, **kw)
        if f.kind in ("crash", "crash-write", "torn-write", "oom") \
                and f.step is None:
            raise MXNetError(f"MX_FAULT_SPEC: {f.kind} requires step=N")
        if f.kind == "slow-write" and f.ms is None:
            raise MXNetError("MX_FAULT_SPEC: slow-write requires ms=N")
        if f.shard is not None and f.kind != "torn-write":
            raise MXNetError(
                "MX_FAULT_SPEC: shard=R only applies to torn-write "
                "(it selects which rank's shard file to corrupt in a "
                "shard-granular checkpoint)")
        if f.kind == "crash-rendezvous" and f.step is not None:
            raise MXNetError(
                "MX_FAULT_SPEC: crash-rendezvous fires at rendezvous time, "
                "before any training step exists — step= does not apply "
                "(scope it with rank=/if-restart=/if-world=)")
        faults.append(f)
    return faults


# Parsed-spec cache keyed on the raw env value so the per-step hook is a
# dict lookup + string compare, not a re-parse.
_cached_text: Optional[str] = None
_cached_faults: List[Fault] = []


def active_faults() -> List[Fault]:
    text = os.environ.get("MX_FAULT_SPEC", "")
    global _cached_text, _cached_faults
    if text != _cached_text:
        _cached_faults = parse_spec(text)
        _cached_text = text
    return _cached_faults


def _match(kind: str, step: Optional[int] = None):
    for f in active_faults():
        if f.kind != kind or not f.applies_here():
            continue
        if step is not None and f.step is not None and f.step != step:
            continue
        return f
    return None


# ---------------------------------------------------------------------------
# hooks (called by AsyncCheckpointer; no-ops when MX_FAULT_SPEC is unset)
# ---------------------------------------------------------------------------
def on_train_step(step: int) -> None:
    """`crash` injection point — AsyncCheckpointer.step() calls this right
    after incrementing its counter, before any checkpoint is enqueued."""
    f = _match("crash", step)
    if f is not None and f.step == step:
        print(f"mxnet_tpu_torch.fault: injected crash at step {step}",
              flush=True)
        os._exit(EXIT_INJECTED_CRASH)


def on_dispatch(step: int) -> None:
    """``oom`` injection point — a training step calls this right before
    its dispatch.  The synthetic error spells RESOURCE_EXHAUSTED, which
    ``memwatch.is_resource_exhausted`` matches as it matches
    ``torch.cuda.OutOfMemoryError``, so it takes the real OOM
    post-mortem path."""
    f = _match("oom", step)
    if f is not None and f.step == step:
        raise MXNetError(
            f"RESOURCE_EXHAUSTED: injected device OOM at step {step} "
            f"(MX_FAULT_SPEC): out of memory while allocating step "
            f"buffers")


def on_rendezvous() -> None:
    """``crash-rendezvous`` injection point — a rendezvous calls this
    right before its process group forms, so an elastic
    re-rendezvous (tools/launch.py --elastic) can be made to fail on a
    chosen rank/incarnation/world size.  Scoped with ``if-world=N`` it
    models a host that comes back broken: admitted into the resized gang
    but dead before the coordination service ever sees it."""
    f = _match("crash-rendezvous")
    if f is not None:
        print("mxnet_tpu_torch.fault: injected crash during rendezvous",
              flush=True)
        os._exit(EXIT_INJECTED_CRASH)


def on_write_begin(step: int) -> None:
    f = _match("slow-write", step)
    if f is not None:
        time.sleep(f.ms / 1000.0)


def on_write_mid(step: int) -> None:
    """Called between the payload writes and meta.json — a crash here
    leaves a half-filled ``.tmp-<step>`` staging dir, never published."""
    f = _match("crash-write", step)
    if f is not None and f.step == step:
        print("mxnet_tpu_torch.fault: injected crash mid-write of step "
              f"{step}", flush=True)
        os._exit(EXIT_INJECTED_CRASH)


def on_write_published(step: int, final_dir: str) -> None:
    """Called after step's checkpoint dir is published and ``latest``
    updated; torn-write truncates files in place so the *newest* checkpoint
    is the corrupt one (the fallback path load must survive)."""
    f = _match("torn-write", step)
    if f is None or f.step != step:
        return
    if f.shard is not None:
        # shard-granular checkpoints: corrupt exactly rank R's shard
        # file — the single-shard-corruption chaos shape (the whole step
        # must fail validation and restore fall back past it)
        targets = [f"params-shard-{f.shard}.nd"]
    else:
        targets = {"meta": ["meta.json"], "params": ["params.nd"],
                   "all": ["meta.json", "params.nd"]}[f.file]
    for fname in targets:
        path = os.path.join(final_dir, fname)
        if not os.path.exists(path):
            continue
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            fh.truncate(size // 2)
    print(f"mxnet_tpu_torch.fault: tore checkpoint step {step} "
          f"({'+'.join(targets)})", flush=True)


# ---------------------------------------------------------------------------
# preemption handling
# ---------------------------------------------------------------------------
def install_preemption_handler(ckpt, params, trainer=None,
                               exit_code: int = EXIT_PREEMPTED):
    """Turn SIGTERM (pod preemption, or the gang supervisor's fan-out) into
    one final *synchronous* checkpoint and a clean, distinguishable exit.

    Best-effort by design: python delivers signals between bytecodes, so a
    rank blocked inside a native collective (waiting on a dead peer) may
    never run the handler — the supervisor's bounded SIGKILL escalation
    reaps it, and the gang resumes from that rank's last *published*
    checkpoint instead.  Because the final checkpoint lands at whatever
    step SIGTERM caught this rank, a restarted sync-SGD gang must agree on
    a common resume step — see ``checkpoint.agree_resume_step``.

    Caveat for exact-trajectory resume: SIGTERM can land mid-update (the
    Trainer's per-param python loop) or after an update whose step() call
    hasn't run yet, so the off-cycle snapshot may mix in (part of) the
    NEXT step's update under the previous step's label.  Gang resume is
    immune (it agrees on scheduled steps only); a solo run that needs
    bit-exact resumption should restore its last *scheduled* step —
    ``restore(dir, net, trainer,
    step=latest_valid_step(dir, multiple_of=save_every))`` — and treat the
    off-cycle checkpoint as a freshest-effort snapshot.

    Returns the installed handler (mainly for tests)."""
    def _handler(signum, frame):
        # the port has no in-flight ring to drain (ROADMAP A.6): the
        # snapshot's host copies wait for the device work they read
        step = None
        try:
            step = ckpt.save_now(params, trainer=trainer)
        except BaseException as e:  # noqa: BLE001 — dying anyway, by design
            print(f"mxnet_tpu_torch.fault: preemption checkpoint failed: "
                  f"{e}", flush=True)
        if step:
            print(f"mxnet_tpu_torch.fault: preempted; final checkpoint at "
                  f"step {step}", flush=True)
        os._exit(exit_code)

    signal.signal(signal.SIGTERM, _handler)
    return _handler
