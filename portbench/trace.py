"""What a traced run records: the benchmark's own spans, the device's
activity from ``torch.profiler`` and the host syncs the window made.

Spans are kept in memory on the epoch clock (``time.time_ns``), the clock
of the profiler's events, so a device gap can be labelled by the span the
host was in.  The profiler records the CUDA activity alone: kernels,
copies and runtime calls, no CPU operators.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings


def process_start_s() -> float:
    """The epoch second at which this process started (/proc), or now
    when /proc cannot tell."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


class Spans:
    """Named host intervals [start_ns, end_ns) with their parent."""

    def __init__(self):
        self.items: list = []
        self._stack: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        parent = self._stack[-1] if self._stack else None
        idx = len(self.items)
        self.items.append([name, time.time_ns(), None, parent])
        self._stack.append(idx)
        try:
            yield
        finally:
            self._stack.pop()
            self.items[idx][2] = time.time_ns()

    def innermost(self, t_ns: int) -> str:
        """The name of the deepest span holding ``t_ns``."""
        best, depth = "outside spans", -1
        for name, a, b, parent in self.items:
            if a <= t_ns < (b or a):
                d, p = 0, parent
                while p is not None:
                    d, p = d + 1, self.items[p][3]
                if d > depth:
                    best, depth = name, d
        return best


@contextlib.contextmanager
def sync_count(out: dict):
    """Counts in ``out['syncs']`` the host syncs torch's sync debug mode
    warns of inside the block."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
            out["syncs"] = sum(1 for w in caught
                               if "synchroniz" in str(w.message))


@contextlib.contextmanager
def device_activity(out: dict):
    """Records the CUDA activity of the block; ``out['events']`` gets
    (name, start_ns, end_ns) of every kernel, copy and set on the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize()
    events = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            start = e.start_ns()
            events.append((e.name(), start, start + e.duration_ns()))
    out["events"] = sorted(events, key=lambda ev: ev[1])


def summarize(events: list, t0_ns: int, t1_ns: int, spans: Spans,
              top: int = 10) -> dict:
    """From the device events of the window [t0_ns, t1_ns): ``busy_s`` (the
    union of the events' intervals), ``kernel_s`` (device seconds by
    name), ``device_ops`` (the ``top`` names by device time) and
    ``idle_gaps`` (the ``top`` longest gaps, each named by the span the
    host was in at its middle)."""
    busy, gaps, by_name = 0, [], {}
    cursor = t0_ns
    for name, a, b in events:
        a, b = max(a, t0_ns), min(b, t1_ns)
        if b <= a:
            continue
        by_name[name] = by_name.get(name, 0) + (b - a)
        if a > cursor:
            gaps.append((a - cursor, cursor))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if t1_ns > cursor:
        gaps.append((t1_ns - cursor, cursor))
    gaps.sort(reverse=True)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": busy / 1e9,
        "kernel_s": {k: v / 1e9 for k, v in by_name.items()},
        "device_ops": [[k[:120], v / 1e9] for k, v in ops],
        "idle_gaps": [[spans.innermost(start + g // 2), g / 1e9]
                      for g, start in gaps[:top]],
    }
