"""The reduction of one `torch.profiler` trace to what the readers use.

The traced run profiles a few steady steps (CPU and CUDA activity) inside
``record_function`` spans of the benchmark's own (`SPANS`); the profiled
window is the span ``perfbench.window``. From the trace: every device
activity interval (kernels, copies, sets) clipped to the window, their
union (busy time), the device operations that took most time, the
longest gaps in which the device was idle with what the host was doing
at the gap's start (the innermost host op then), and the device time of
kernels by name.
"""
from __future__ import annotations

import dataclasses

SPANS = ("perfbench.window", "perfbench.submit", "perfbench.step",
         "perfbench.collect")


@dataclasses.dataclass
class Trace:
    start_us: float
    end_us: float
    device: list          # (name, start_us, end_us), clipped to the window
    host: list            # (name, start_us, end_us), host ops in the window

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self) -> list:
        merged = []
        for _, s, e in sorted(self.device, key=lambda t: t[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernel_s(self, marks) -> float | None:
        """Device seconds of kernels whose name holds any of ``marks``;
        None when no such kernel ran."""
        ts = [e - s for n, s, e in self.device if any(m in n for m in marks)]
        return sum(ts) / 1e6 if ts else None

    def top_ops(self, n: int = 10) -> list:
        tot: dict[str, float] = {}
        for name, s, e in self.device:
            tot[name] = tot.get(name, 0.0) + (e - s) / 1e6
        return sorted(([k[:120], v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def host_at(self, t: float) -> str:
        """The benchmark span and the innermost host op running at ``t``."""
        span, inner, inner_start = "host", None, -1.0
        for name, s, e in self.host:
            if s <= t <= e:
                if name in SPANS and name != "perfbench.window":
                    span = name
                elif name not in SPANS and s >= inner_start:
                    inner, inner_start = name, s
        return span if inner is None else f"{span}:{inner}"

    def idle_gaps(self, n: int = 10) -> list:
        busy = self.busy_intervals()
        edges = [self.start_us] + [x for iv in busy for x in iv] + [self.end_us]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.host_at(s), (e - s) / 1e6] for s, e in gaps[:n]]


def reduce(prof) -> Trace:
    """Reduce a finished `torch.profiler.profile` to a `Trace`."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    win = [e for e in events if e.name == "perfbench.window"
           and e.device_type == DeviceType.CPU]
    if not win:
        raise RuntimeError("the profiled window's span is not in the trace")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    device, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if t < w0 or s > w1:
            continue
        if e.device_type == DeviceType.CUDA:
            if e.name in SPANS or getattr(e, "is_user_annotation", False):
                continue            # a span's mirror on the device timeline
            device.append((e.name, max(s, w0), min(t, w1)))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, s, t))
    return Trace(w0, w1, device, host)
