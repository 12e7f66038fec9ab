"""Tracing / profiling / metrics (``rna_algos_tpu.utils.trace``).

Per-phase timers with DP cells/s throughput counters, device syncs for
wall-clock timing, structured JSONL run logs, and a ``torch.profiler``
trace context.  A phase on a CUDA device is timed with CUDA events on the
device's current stream; elsewhere with ``time.perf_counter``.
"""

import contextlib
import json
import os
import sys
import time

import torch

from .debug import tree_leaves_with_path
from .platform import on_cuda


class PhaseTimer:
    """Named phase timing + derived throughput metrics."""

    def __init__(self):
        self.phases = {}

    @contextlib.contextmanager
    def phase(self, name, cells=None, items=None, device=None):
        """Time the body as phase ``name``.  With a CUDA ``device`` the time
        is the elapsed time between two CUDA events recorded on its current
        stream around the body (the end event waited for), so work the body
        queued counts; otherwise the host clock."""
        events = None
        if device is not None and on_cuda(device):
            stream = torch.cuda.current_stream(device)
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record(stream)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if events is None:
                dt = time.perf_counter() - t0
            else:
                events[1].record(stream)
                events[1].synchronize()
                dt = events[0].elapsed_time(events[1]) / 1e3
            rec = self.phases.setdefault(
                name, {"seconds": 0.0, "cells": 0, "items": 0, "calls": 0}
            )
            rec["seconds"] += dt
            rec["calls"] += 1
            if cells:
                rec["cells"] += int(cells)
            if items:
                rec["items"] += int(items)

    def summary(self):
        out = {}
        for name, rec in self.phases.items():
            s = dict(rec)
            if rec["seconds"] > 0:
                if rec["cells"]:
                    s["cells_per_s"] = rec["cells"] / rec["seconds"]
                if rec["items"]:
                    s["items_per_s"] = rec["items"] / rec["seconds"]
            out[name] = s
        return out


def _tensors(tree):
    """The non-empty tensors among the tree's leaves, in leaf order."""
    return [t for _, t in tree_leaves_with_path(tree)
            if torch.is_tensor(t) and t.numel()]


def force(tree):
    """Wait until the devices holding the tree's tensors have run everything
    queued on them.  Returns the number of non-empty tensors (CPU tensors
    are counted and need no wait)."""
    n = 0
    synced = set()
    for t in _tensors(tree):
        if on_cuda(t) and t.device not in synced:
            torch.cuda.synchronize(t.device)
            synced.add(t.device)
        n += 1
    return n


def force_last(tree):
    """One sync: wait for the device of the tree's last non-empty tensor.
    Returns 1, or 0 when the tree holds no non-empty tensor."""
    tensors = _tensors(tree)
    if tensors and on_cuda(tensors[-1]):
        torch.cuda.synchronize(tensors[-1].device)
    return min(len(tensors), 1)


def dp_cells(n, window=31):
    """DP cell-update count of one McCaskill run: inside + outside wavefronts,
    counting the bounded 2-loop window per pair cell."""
    n = int(n)
    return 2 * (n * n * (window * window) // 2 + n**3 // 6)


@contextlib.contextmanager
def device_trace(log_dir):
    """``torch.profiler`` context over the host and, where a GPU is present,
    its CUDA activity; on exit writes a Chrome trace
    (``trace_{pid}_{ns}.json``) into ``log_dir``.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class RunLog:
    """Structured JSONL event log."""

    def __init__(self, path=None):
        self.path = path or os.environ.get("RNA_ALGOS_RUNLOG")
        self._f = open(self.path, "a") if self.path else None

    def event(self, kind, **fields):
        rec = {"ts": time.time(), "event": kind, **fields}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        elif os.environ.get("RNA_ALGOS_VERBOSE"):
            print(json.dumps(rec), file=sys.stderr)

    def close(self):
        if self._f:
            self._f.close()
