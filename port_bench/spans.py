"""The program's own spans in a traced run: the `dpst::` ranges that
`dpst_tpu_torch.utils.runtime.span` opens while a profiler records. The
traced span's host ops hold their ranges on the profiler's clock; the
program's record (`runtime.spans()`, read and never emptied here) holds
the device ms of each, from a pair of CUDA events.

The record keeps every span closed while a profiler recorded in the
process, so the traced steps' are its last ones: as many of a name as the
traced span holds ranges of it. Where the traced span holds none (a
program without spans), or the record holds fewer (a run on the CPU,
which records no events), a reading is None."""
from __future__ import annotations

PREFIX = "dpst::"


def host_ranges(span, name: str) -> list:
    """(start µs, end µs) of each `dpst::<name>` range of the traced
    span."""
    return [(t0, t1) for n, t0, t1 in span.host if n == PREFIX + name]


def device_ms_per_step(r, name: str) -> float | None:
    """Device ms a traced step of the `dpst::<name>` spans."""
    n = len(host_ranges(r.span, name))
    if not n:
        return None
    from dpst_tpu_torch.utils import runtime
    ms = [v for k, v in runtime.spans() if k == PREFIX + name]
    if len(ms) < n:
        return None
    return sum(ms[-n:]) / r.span.steps


def host_ms_per_step(r, name: str) -> float | None:
    """Host ms a traced step of the `dpst::<name>` ranges (the profiler's
    clock)."""
    ranges = host_ranges(r.span, name)
    if not ranges:
        return None
    return sum(t1 - t0 for t0, t1 in ranges) / 1e3 / r.span.steps
