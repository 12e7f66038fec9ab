"""The traced run's reduction: the profiler's events in memory, reduced to
the device's busy time, the benchmark's spans, the work each span's device
operations did, the operations that took most time and the idle gaps.

Events are (name, start_us, end_us) on the profiler's clock, device
events kept apart from the host's.  The benchmark's spans are host events
named ``bench.<name>`` (``torch.profiler.record_function`` around its
calls into the program).
"""

import bisect

SPAN_PREFIX = "bench."
TOP = 10


def union(intervals):
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def merged(intervals):
    """The intervals' union as sorted disjoint (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def is_copy(name):
    return name.startswith("Memcpy") or name.startswith("Memset")


def is_d2h(name):
    return "DtoH" in name or "Device -> Pageable" in name


class Trace:
    """One traced window: ``device`` and ``host`` lists of (name, start,
    end) in microseconds, and the window's (start, end)."""

    def __init__(self, device, host, window):
        self.device = sorted(device, key=lambda e: e[1])
        self.host = sorted(host, key=lambda e: e[1])
        self.window = window
        self.spans = {}
        self._bench, self._other = [], []
        for rec in self.host:
            name = rec[0]
            if name.startswith(SPAN_PREFIX):
                self.spans.setdefault(name[len(SPAN_PREFIX):], []).append(
                    rec[1:])
                self._bench.append(rec)
            else:
                self._other.append(rec)
        self._starts = [e[1] for e in self.device]
        self._bench_starts = [e[1] for e in self._bench]
        self._other_starts = [e[1] for e in self._other]

    @classmethod
    def from_profiler(cls, prof, window_span="call"):
        """From a finished ``torch.profiler.profile``, read from its raw
        Kineto events (``prof.events()`` builds a tree of them, minutes for
        a window's million events): the window runs from the first
        ``bench.<window_span>`` span's start to the last one's end."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        device, host = [], []
        for e in prof.profiler.kineto_results.events():
            name, start = e.name(), e.start_ns()
            rec = (name, start / 1e3, (start + e.duration_ns()) / 1e3)
            if e.device_type() != cuda:
                host.append(rec)
            elif not name.startswith(SPAN_PREFIX):
                # the device-side copies of the benchmark's spans are no
                # device work
                device.append(rec)
        calls = [(s, e) for n, s, e in host
                 if n == SPAN_PREFIX + window_span]
        window = ((min(s for s, _ in calls), max(e for _, e in calls))
                  if calls else (0.0, 0.0))
        return cls(device, host, window)

    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self):
        """Seconds in the window in which an operation ran on the device."""
        lo, hi = self.window
        return union([(max(s, lo), min(e, hi)) for _, s, e in self.device
                      if e > lo and s < hi]) / 1e6

    def in_spans(self, span):
        """The device events that start inside a ``bench.<span>`` span."""
        out = []
        for s, e in self.spans.get(span, ()):
            k = bisect.bisect_left(self._starts, s)
            while k < len(self.device) and self.device[k][1] < e:
                out.append(self.device[k])
                k += 1
        return out

    def top_ops(self, n=TOP):
        """[name, seconds] of the device operations that took most time in
        the window, summed by name."""
        lo, hi = self.window
        by = {}
        for name, s, e in self.device:
            if lo <= s < hi:
                by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[k[:200], v] for k, v in sorted(by.items(),
                                                key=lambda kv: -kv[1])[:n]]

    @staticmethod
    def _innermost(events, starts, t, reach=5000):
        """The name of the event of ``events`` (sorted by start) that holds
        time t and started last, looking back at most ``reach`` events."""
        k = bisect.bisect_right(starts, t) - 1
        stop = max(-1, k - reach)
        while k > stop:
            name, s, e = events[k]
            if e > t:
                return name
            k -= 1
        return None

    def _host_at(self, t):
        """What the host was doing at time t: the innermost benchmark span
        and, inside it, the innermost other host event."""
        span = self._innermost(self._bench, self._bench_starts, t)
        span = "client" if span is None else span[len(SPAN_PREFIX):]
        inner = self._innermost(self._other, self._other_starts, t)
        return span if inner is None else f"{span}/{inner}"

    def idle_gaps(self, n=TOP, longest=200):
        """[name, seconds] of the idle gaps in the window, summed by what the
        host was doing at each gap's middle, over the ``longest`` gaps."""
        lo, hi = self.window
        busy = merged([(max(s, lo), min(e, hi)) for _, s, e in self.device
                       if e > lo and s < hi])
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[k + 1] - edges[k], edges[k], edges[k + 1])
                for k in range(0, len(edges) - 1, 2)
                if edges[k + 1] > edges[k]]
        gaps.sort(reverse=True)
        by = {}
        for g, s, e in gaps[:longest]:
            name = self._host_at((s + e) / 2)[:200]
            by[name] = by.get(name, 0.0) + g / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]
