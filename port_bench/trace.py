"""The traced span of a `--trace 1` run: torch.profiler over whole steps of
the window's first request, reduced to what the per-layer readers take.

`kernel_group` is a frozen copy of `chip_smoke.py`'s grouping of device
kernels by the part of a step they belong to. A device event is a kernel
or a copy on the card, never a `record_function` range drawn on the device
timeline (which covers its kernels and the gaps between them).
"""
from __future__ import annotations

from dataclasses import dataclass, field

SPAN_PREFIX = "port_bench."   # the harness's own record_function ranges
OTHER = "other (elementwise, reductions, copies)"
CONV = "conv (cuDNN)"


def kernel_group(name: str) -> str:
    """Which part of a step a device kernel belongs to. The block12 entry
    points share their kernels: their groups are by stage."""
    for key, group in (("block12_gram_df", "block12_* Gram cotangent"),
                       ("block12_gram", "block12_* Gram partials"),
                       ("block12_pool_bwd", "block12_* pool backward"),
                       ("block12_pool", "block12_* pool forward"),
                       ("block12_gather", "block12_* band copies"),
                       ("block12_scatter", "block12_* band copies"),
                       ("EpiBiasRelu", "block12_* convs (bias+ReLU)"),
                       ("EpiF32", "block12_* convs (input gradient)"),
                       ("gram_relu_fwd", "gram_relu_fwd"),
                       ("gram_relu_bwd", "gram_relu_bwd"),
                       ("gram_fwd", "gram_fwd"),
                       ("gram_reduce", "gram_fwd (+ gram_relu_fwd's reduce)"),
                       ("gram_wbwd", "gram_wbwd"),
                       ("gram_bwd", "gram_bwd"), ("pool2_bwd", "pool_bwd"),
                       ("lap_matvec", "lap_matvec"),
                       ("conv3x3", "conv3x3")):
        if key in name:
            return group
    low = name.lower()
    if any(k in low for k in ("conv", "xmma", "cudnn", "gemm", "sm90",
                              "dgrad", "implicit")):
        return CONV
    if "max_pool" in low:
        return "max_pool forward"
    return OTHER


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


@dataclass
class Span:
    """A traced span of whole steps: device events and host ops as
    (name, start µs, end µs) on the profiler's clock, and the span's
    bounds on that clock."""
    steps: int
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    start_us: float = 0.0
    end_us: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def groups_ms(self) -> dict:
        """Device ms a step by kernel group."""
        out: dict = {}
        for name, t0, t1 in self.device:
            g = kernel_group(name)
            out[g] = out.get(g, 0.0) + (t1 - t0) / 1e3 / self.steps
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def kernels(self) -> int:
        return sum(1 for name, _, _ in self.device if not is_copy(name))

    def busy_intervals(self) -> list:
        """The union of the device events' intervals, clipped to the span,
        in order."""
        merged = []
        for _, t0, t1 in sorted((e for e in self.device),
                                key=lambda e: e[1]):
            t0, t1 = max(t0, self.start_us), min(t1, self.end_us)
            if t1 <= t0:
                continue
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        return merged

    def busy_s(self) -> float:
        return sum(t1 - t0 for t0, t1 in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> list:
        """(start µs, end µs) of each stretch of the span with no device
        event."""
        gaps, t = [], self.start_us
        for t0, t1 in self.busy_intervals():
            if t0 > t:
                gaps.append((t, t0))
            t = max(t, t1)
        if self.end_us > t:
            gaps.append((t, self.end_us))
        return gaps

    def top_device_ops(self, n: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        tot: dict = {}
        for name, t0, t1 in self.device:
            tot[name] = tot.get(name, 0.0) + (t1 - t0) / 1e6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def top_idle_gaps(self, n: int = 10, most: int = 2000) -> list:
        """[what the host was doing, seconds] of the `most` longest idle
        gaps, summed by the innermost host op that covers each gap's middle
        ("host: no op" where none does), the largest first."""
        import bisect
        host = sorted(self.host, key=lambda e: e[1])
        starts = [e[1] for e in host]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:most]
        tot: dict = {}
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            key = "host: no op"
            # the covering op that started last is the innermost
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 256, -1), -1):
                if host[j][2] >= mid:
                    key = host[j][0]
                    break
            tot[key] = tot.get(key, 0.0) + (g1 - g0) / 1e6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]


class Tracer:
    """torch.profiler started and stopped at two stamps of the loop (each
    right after a device sync), so that the span holds whole steps."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.steps = 0

    def start(self) -> None:
        self.prof.start()

    def stop(self, steps: int) -> None:
        self.prof.stop()
        self.steps = steps

    def span(self) -> Span:
        from torch.autograd import DeviceType
        span = Span(steps=self.steps)
        for ev in self.prof.events():
            t0, t1 = ev.time_range.start, ev.time_range.end
            if ev.device_type == DeviceType.CUDA:
                if not (getattr(ev, "is_user_annotation", False)
                        or ev.name.startswith(SPAN_PREFIX)):
                    span.device.append((ev.name, t0, t1))
            else:
                span.host.append((ev.name, t0, t1))
        if not span.device:
            raise RuntimeError("torch.profiler recorded no device event")
        # the span runs from the first host op the profiler saw to the
        # last: the profiler starts and stops right after a sync
        span.start_us = min(t0 for _, t0, _ in span.host + span.device)
        span.end_us = max(t1 for _, _, t1 in span.host + span.device)
        return span
