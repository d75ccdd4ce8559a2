"""Runtime knobs of the port: the device, profiling and NaN checks.

`resolve_device` is where every entry point picks its device: the CUDA
card unless the caller names one; `params_on` moves a weight dict there.
The rest is the counterpart of `dpst_tpu/utils/runtime.py`.
`maybe_profile` traces a block with torch.profiler (the CPU, and CUDA
where there is a card) and writes a Chrome trace into the directory.
`span(name)` marks a stage of the program (`dpst::step`, `dpst::features`,
…) in such a trace, and times it on the card; `spans()` reads those
times. Both cost nothing beyond one check while no profiler is recording.
`timer(name)` counts and times, profiler or not, the `timed(name, batch)`
blocks inside it (PSPNet's forwards, for `segmentation`'s record).
`check_finite` is what `StylizeConfig.debug_nans` turns on: the
optimization loop calls it after each evaluation of the objective, and it
raises FloatingPointError naming the step where the loss or the gradient
is not finite, where `jax_debug_nans` would stop a JAX run. It is a flag
the loop reads, not process-wide state, and it costs a sync an evaluation
only when on.

`enable_compilation_cache` has no counterpart: PyTorch runs eagerly, and
the CUDA kernels' build directory (`ops/kernels.py`, keyed by a hash of
the sources) already keeps what was compiled across processes.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; raise if there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def canonical(device) -> torch.device:
    """The device as a tensor's `.device` names it ("cuda" -> "cuda:0" on
    the current device), so that devices compare equal to tensors'."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def params_on(params: dict, dev: torch.device) -> dict:
    """A weight dict ({layer: {name: tensor}}) with every tensor on `dev`.
    A packed dict (`models.vgg.PackedParams`) stays packed: its packed
    forms move with it, so that `pack_params` takes it as it is."""
    out = {k: {n: t.to(dev) for n, t in p.items()}
           for k, p in params.items()}
    if not hasattr(params, "key"):
        return out
    out = type(params)(out)
    out.key = params.key
    out.block12 = type(params.block12)(*(t.to(dev) for t in params.block12))
    return out


def check_finite(step: int, loss: torch.Tensor, grad: torch.Tensor) -> None:
    """Raise FloatingPointError where the loss or the gradient holds a NaN
    or an infinity (one sync). A batch's (B,) losses and (B, ...) gradient
    name the first pair at fault."""
    ok = torch.isfinite(loss) & torch.isfinite(grad).flatten(
        loss.dim()).all(-1)
    if not bool(ok.all()):
        where = f"step {step}"
        if loss.dim():
            where += f", pair {int(torch.nonzero(~ok)[0, 0])}"
        raise FloatingPointError(
            f"debug_nans: non-finite loss or gradient at {where}")


PREFIX = "dpst::"
_profiling = torch._C._autograd._profiler_enabled
_UNTRACED = contextlib.nullcontext()
# (range name, start event, end event) of each span closed while a
# profiler recorded, on a CUDA device; `maybe_profile` empties it
_SPANS: list = []


class _Span:
    """A `record_function` range `dpst::<name>` on the profiler's clock
    and, where CUDA is in use, a pair of timing events on the current
    stream at its entry and exit, kept in `_SPANS` at its exit."""

    __slots__ = ("name", "range", "start")

    def __init__(self, name: str):
        self.name = PREFIX + name

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.start = None
        if torch.cuda.is_initialized():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()

    def __exit__(self, *exc):
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            _SPANS.append((self.name, self.start, end))
        self.range.__exit__(*exc)


def span(name: str):
    """A context manager marking a stage of the program as the range
    `dpst::<name>` where a torch profiler is recording, timed on the card
    by CUDA events (read by `spans()`); a no-op otherwise. Spans nest on
    one thread, and none stays open across a generator's `yield`."""
    if not _profiling():
        return _UNTRACED
    return _Span(name)


def spans() -> list:
    """(range name, device ms) of each span recorded since the record was
    last emptied, in the order they closed (a nested span before the one
    around it); waits for their events."""
    for _, _, end in _SPANS:
        end.synchronize()
    return [(name, start.elapsed_time(end)) for name, start, end in _SPANS]


def clear_spans() -> None:
    _SPANS.clear()


# the `timer`s open, by name, that `timed` blocks report to
_TIMERS: dict = {}


class Timer:
    """What the `timed` blocks of one name did while their `timer` was
    open, kept whether or not a profiler records: the items they took and,
    on a CUDA device, a pair of timing events around each."""

    def __init__(self):
        self.items = 0
        self.events = []

    def ms(self) -> float | None:
        """Device ms of the blocks (waits for their events), or None where
        none ran on CUDA."""
        if not self.events:
            return None
        self.events[-1][1].synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


@contextlib.contextmanager
def timer(name: str):
    """Opens a `Timer` that the `timed(name, ...)` blocks inside report
    to."""
    _TIMERS[name] = t = Timer()
    try:
        yield t
    finally:
        del _TIMERS[name]


@contextlib.contextmanager
def timed(name: str, batch: torch.Tensor):
    """A block of work on `batch` (its first axis the items), counted by
    the open timer `name` and, on CUDA, timed by events on the batch's
    current stream; nothing where no such timer is open."""
    t = _TIMERS.get(name)
    if t is None:
        yield
        return
    t.items += batch.shape[0]
    if batch.device.type != "cuda":
        yield
        return
    stream = torch.cuda.current_stream(batch.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    yield
    end.record(stream)
    t.events.append((start, end))


@contextlib.contextmanager
def maybe_profile(profile_dir: str):
    """torch.profiler over the block when `profile_dir` is set (else a
    no-op); the trace goes to `profile_dir/dpst_<time>_<pid>.pt.trace.json`
    (chrome://tracing, Perfetto), with the program's `span` ranges, whose
    record it empties first."""
    if not profile_dir:
        yield
        return
    clear_spans()
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    name = f"dpst_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}"
    prof.export_chrome_trace(os.path.join(profile_dir,
                                          name + ".pt.trace.json"))
