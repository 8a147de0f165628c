"""Training monitor (counterpart of ``mxnet_tpu/monitor.py``): statistics
of the watched arrays every ``interval`` batches, for finding divergence and
NaNs.  It watches an executor's observable arrays (arguments, gradients,
aux states, outputs), as the JAX monitor does; the per-op outputs of the
reference's engine callback are not watched.
"""
from __future__ import annotations

import logging
import re
from typing import Callable, List, Optional, Tuple

__all__ = ["Monitor"]


class Monitor:
    """Watch arrays matching `pattern` every `interval` batches."""

    def __init__(self, interval: int, stat_func: Optional[Callable] = None,
                 pattern: str = ".*", sort: bool = False):
        self.interval = max(1, int(interval))
        if stat_func is None:
            def stat_func(arr):
                import numpy as np

                # reference default: norm(x)/sqrt(x.size) i.e. RMS
                # (python/mxnet/monitor.py asum_stat)
                a = np.asarray(arr, dtype=np.float64)
                return float(np.sqrt(np.mean(np.square(a))))
        self.stat_func = stat_func
        self.re_pattern = re.compile(pattern)
        self.sort = sort
        self.step = 0
        self.activated = False
        self.exes: List = []
        self.queue: List[Tuple[int, str, str]] = []
        self.logger = logging.getLogger("mxnet_tpu_torch.monitor")

    def install(self, exe) -> None:
        """Watch an Executor's arg/grad/aux/output arrays (idempotent;
        a repeated fit() re-installs without duplicating)."""
        if not any(e is exe for e in self.exes):
            self.exes.append(exe)

    def replace(self, old_exe, new_exe) -> None:
        """Swap a rebound module's executor (force_rebind) so stats never
        come from the abandoned executor's frozen arrays."""
        self.exes = [e for e in self.exes if e is not old_exe]
        self.install(new_exe)

    # ------------------------------------------------------------------
    def tic(self) -> None:
        """Start collection for this batch when the interval hits."""
        self.activated = (self.step % self.interval == 0)
        self.step += 1

    def _collect(self, name, nd_arr):
        if not self.re_pattern.match(name):
            return
        import numpy as np

        arr = np.asarray(nd_arr.asnumpy())
        try:
            stat = self.stat_func(arr)
        except Exception as exc:  # a bad stat fn shouldn't kill training
            stat = f"<stat error: {exc}>"
        self.queue.append((self.step - 1, name, str(stat)))

    def toc(self) -> List[Tuple[int, str, str]]:
        """Collect stats from installed executors; returns (step, name,
        stat) triples and clears the queue."""
        if not self.activated:
            return []
        for exe in self.exes:
            # only executors that ran since the last toc (bucketing: the
            # inactive buckets' outputs are stale and their shared params
            # would be reported twice).  Executors outside a fit loop
            # default to "ran" so manual tic/forward/toc works.
            if not getattr(exe, "_monitor_ran", True):
                continue
            exe._monitor_ran = False
            for name, arr in getattr(exe, "arg_dict", {}).items():
                self._collect(name, arr)
            for name, arr in (getattr(exe, "grad_dict", {}) or {}).items():
                if arr is not None:
                    self._collect(name + "_grad", arr)
            for name, arr in getattr(exe, "aux_dict", {}).items():
                self._collect(name, arr)
            for i, out in enumerate(getattr(exe, "outputs", []) or []):
                self._collect(f"output{i}", out)
        self.activated = False
        res = self.queue
        if self.sort:
            res = sorted(res, key=lambda t: t[1])
        self.queue = []
        return res

    def toc_print(self) -> None:
        for step, name, stat in self.toc():
            self.logger.info("Batch: %7d %30s %s", step, name, stat)
