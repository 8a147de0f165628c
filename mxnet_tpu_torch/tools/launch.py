"""Launch a gang of worker processes on this host, one per card.

The port's counterpart of the JAX package's ``tools/launch.py`` (its
command line and environment contract; the supervisor, restarts and
preemption resume are ROADMAP A.9 part 3)::

    python -m mxnet_tpu_torch.tools.launch -n 4 --launcher local \\
        python -m mxnet_tpu_torch.tools.multigpu_smoke

Each worker gets ``MX_COORDINATOR`` (127.0.0.1 and a free port),
``MX_NUM_PROCS``, ``MX_PROC_ID``, ``MX_LOCAL_RANK`` and the reference
spellings ``DMLC_ROLE``, ``DMLC_PS_ROOT_URI``, ``DMLC_PS_ROOT_PORT``,
``DMLC_NUM_WORKER``, ``DMLC_NUM_SERVER`` and ``DMLC_WORKER_ID``;
``--force-cpu`` adds ``MX_FORCE_CPU=1`` (a gloo group on the CPU).  The
workers' lines are copied to this process's streams with a ``[rank N]``
prefix.  A worker that exits non-zero brings the others down (SIGTERM,
then SIGKILL after ``--term-timeout`` seconds) and the launcher exits with
that worker's code; the launcher exits 0 when every worker does.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time

__all__ = ["main", "launch"]


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tee(stream, sink, prefix: str) -> None:
    try:
        for line in iter(stream.readline, ""):
            sink.write(prefix + line)
            sink.flush()
    except ValueError:  # the stream closed under us during teardown
        pass
    finally:
        try:
            stream.close()
        except OSError:
            pass


def _spawn(command, n: int, force_cpu: bool, port: int):
    procs, tees = [], []
    for rank in range(n):
        env = dict(os.environ)
        env["PYTHONUNBUFFERED"] = "1"
        env.update({
            "MX_COORDINATOR": f"127.0.0.1:{port}",
            "MX_NUM_PROCS": str(n),
            "MX_PROC_ID": str(rank),
            "MX_LOCAL_RANK": str(rank),
            "DMLC_ROLE": "worker",
            "DMLC_PS_ROOT_URI": "127.0.0.1",
            "DMLC_PS_ROOT_PORT": str(port),
            "DMLC_NUM_WORKER": str(n),
            "DMLC_NUM_SERVER": "0",
            "DMLC_WORKER_ID": str(rank),
        })
        if force_cpu:
            env["MX_FORCE_CPU"] = "1"
        p = subprocess.Popen(command, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True,
                             errors="replace", bufsize=1)
        procs.append(p)
        for stream, sink in ((p.stdout, sys.stdout), (p.stderr, sys.stderr)):
            t = threading.Thread(target=_tee,
                                 args=(stream, sink, f"[rank {rank}] "),
                                 daemon=True)
            t.start()
            tees.append(t)
    return procs, tees


def _terminate(procs, term_timeout: float) -> None:
    """SIGTERM every live worker, then SIGKILL those still alive after
    ``term_timeout`` seconds; reaps them all."""
    for p in procs:
        if p.poll() is None:
            try:
                p.send_signal(signal.SIGTERM)
            except OSError:
                pass
    deadline = time.monotonic() + term_timeout
    for p in procs:
        if p.poll() is not None:
            continue
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            try:
                p.kill()  # a rank blocked in a collective ignores SIGTERM
            except OSError:
                pass
    for p in procs:
        try:
            p.wait(timeout=10.0)
        except subprocess.TimeoutExpired:  # pragma: no cover
            pass


def _wait(procs, term_timeout: float) -> int:
    """Poll every worker: the first non-zero exit brings the rest down and
    is the gang's code; 0 when all exit 0."""
    while True:
        codes = [p.poll() for p in procs]
        bad = [c for c in codes if c not in (None, 0)]
        if bad:
            _terminate(procs, term_timeout)
            return bad[0]
        if all(c == 0 for c in codes):
            return 0
        time.sleep(0.05)


def launch(command, n: int, force_cpu: bool = False,
           term_timeout: float = 10.0) -> int:
    """Run ``command`` as ``n`` workers; returns the gang's exit code."""
    procs, tees = _spawn(list(command), n, force_cpu, _free_port())
    try:
        rc = _wait(procs, term_timeout)
    except KeyboardInterrupt:
        _terminate(procs, term_timeout)
        rc = 130
    for t in tees:
        t.join(timeout=5.0)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Launch a gang of mxnet_tpu_torch workers, one per "
                    "card of this host.")
    ap.add_argument("-n", "--num-workers", type=int, required=True,
                    help="number of worker processes")
    ap.add_argument("-s", "--num-servers", type=int, default=0,
                    help="accepted for the reference's command line; "
                         "there is no parameter-server role")
    ap.add_argument("--launcher", default="local", choices=["local"],
                    help="only 'local' (one host) is ported")
    ap.add_argument("--force-cpu", action="store_true",
                    help="run the workers on the CPU (a gloo group)")
    ap.add_argument("--term-timeout", type=float, default=10.0,
                    metavar="S", help="seconds between SIGTERM and SIGKILL "
                                      "when a gang is torn down")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="the worker command line")
    args = ap.parse_args(argv)
    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        ap.error("no worker command given")
    if args.num_workers < 1:
        ap.error("-n must be at least 1")
    return launch(command, args.num_workers, args.force_cpu,
                  args.term_timeout)


if __name__ == "__main__":
    sys.exit(main())
