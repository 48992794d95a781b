"""The traced run's profiler and its reduction to device busy time.

``torch.profiler`` records the window with CPU and CUDA activity; no
trace file is written.  After the window the raw events are reduced in
memory: every CUDA-side event (kernel, copy, memset; not the device-lane
copies of ``record_function`` ranges) is an interval of busy time on its
device; the intervals of a device are merged into
their union, which is then intersected with each operation's span.  The
harness's spans are ``record_function`` ranges named ``portbench.<op>``
and share the events' clock.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

SPAN_PREFIX = "portbench."


class Union:
    """Merged busy intervals of one device, with prefix sums."""

    def __init__(self, intervals):
        merged = []
        for s, e in sorted(intervals):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self.prefix = [0]
        for s, e in merged:
            self.prefix.append(self.prefix[-1] + e - s)

    def _before(self, t: int) -> int:
        """Busy ns in (-inf, t)."""
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0
        return self.prefix[i - 1] + min(self.ends[i - 1], t) - \
            self.starts[i - 1]

    def busy(self, a: int, b: int) -> int:
        return self._before(b) - self._before(a) if b > a else 0

    def gaps(self, a: int, b: int):
        """Idle intervals inside [a, b]."""
        out, t = [], a
        i = bisect.bisect_right(self.ends, a)
        while i < len(self.starts) and self.starts[i] < b:
            if self.starts[i] > t:
                out.append((t, self.starts[i]))
            t = max(t, self.ends[i])
            i += 1
        if t < b:
            out.append((t, b))
        return out


class Tracer:
    """Starts the profiler; ``reduce`` turns its events into a summary."""

    def __init__(self, cuda: bool):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()

    def events(self):
        res = getattr(self.prof.profiler, "kineto_results", None)
        return [] if res is None else res.events()

    def reduce(self, n_devices: int, window_ns) -> dict:
        """Per-op busy ns per device, device op totals, idle gaps."""
        busy = defaultdict(list)
        by_name = defaultdict(int)
        spans, host = [], []
        for ev in self.events():
            s = ev.start_ns()
            e = s + ev.duration_ns()
            name = ev.name()
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                if name.startswith(SPAN_PREFIX) or _annotation(ev):
                    continue        # a range's shadow on the device lane
                busy[ev.device_index()].append((s, e))
                by_name[name] += e - s
            elif name.startswith(SPAN_PREFIX):
                spans.append((s, e, name[len(SPAN_PREFIX):]))
            elif e > s:
                host.append((s, e, name))
        unions = {d: Union(busy.get(d, [])) for d in range(n_devices)}
        spans.sort()
        a, b = spans[0][0] if spans else window_ns[0], \
            spans[-1][1] if spans else window_ns[1]
        a, b = min(a, window_ns[0]), max(b, window_ns[1])
        return {
            "ops": [{"kind": k, "span_ns": e - s,
                     "busy_ns": [unions[d].busy(s, e)
                                 for d in range(n_devices)]}
                    for s, e, k in spans],
            "window_ns": b - a,
            "busy_ns": [unions[d].busy(a, b) for d in range(n_devices)],
            "device_events": sum(len(v) for v in busy.values()),
            "device_ops": sorted(([n, t / 1e9] for n, t in by_name.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": _label_gaps(unions.get(0), a, b, spans, host),
        }


def _annotation(ev) -> bool:
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else False


def _label_gaps(union, a, b, spans, host, keep: int = 10):
    """The longest idle gaps of device 0, each named by the harness span
    around it and the host operation that overlaps it most."""
    if union is None or not union.starts:
        return []
    gaps = sorted(union.gaps(a, b), key=lambda g: g[0] - g[1])[:keep]
    host.sort()
    starts = [h[0] for h in host]
    out = []
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        span = next((k for s, e, k in spans if s <= mid < e), "harness")
        best, op = 0, "no profiled host operation"
        i = bisect.bisect_left(starts, g1)
        for s, e, name in host[max(0, i - 2000):i]:
            over = min(e, g1) - max(s, g0)
            if over > best:
                best, op = over, name
        out.append([f"{span}: {op}", (g1 - g0) / 1e9])
    return out
