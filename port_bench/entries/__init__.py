"""How a request reaches the program. Each module here is an entry that a
traffic file names (`"entry"`): `resolve(cfg)` gives the config the entry
runs under, and `run_request(ctx, pairs, request)` drives one request,
calling `request.begin()`, `request.precomputed()` where the entry can
sync after its precompute, `request.stamp(step)` every `stamp_every`
steps (after which it stops if the stamp says the window has closed), and
`request.keep(image, history)` with the image and the loss history of the
steps before each stamp."""
from __future__ import annotations

import math
import time

import torch


class Request:
    """The stamps of one request: host time after a device sync at its
    start, after its precompute where the entry can tell, and every
    `stamp_every` steps; where it is `compared`, the image and the history
    rows at its first stamp (copied to the host); and whether the window's
    end cut it. No request is cut before it has timed some steps between
    two stamps, a compared one before its first stamp, nor a traced one
    before an interval undisturbed by the profiler has followed its traced
    span (the step time that the precompute and the device's shares are
    taken against): `tracer` (a `trace.Tracer`) is started at step
    `trace_from` and stopped `trace_steps` later."""

    def __init__(self, steps: int, stamp_every: int, sync,
                 deadline: float = math.inf, compared: bool = False,
                 tracer=None, trace_from: int = 0, trace_steps: int = 0):
        self.steps, self.stamp_every, self.sync = steps, stamp_every, sync
        self.deadline, self.compared = deadline, compared
        self.tracer, self.trace_from = tracer, trace_from
        self.trace_end = trace_from + trace_steps
        self.t0 = None
        self.precompute_inside = False
        self.stamps: list[tuple[int, float]] = []
        self.rows = None         # history rows up to the first stamp
        self.image = None        # the image (or batch) at the first stamp
        self.cut = False
        self.traced = None       # (first step, last step) of the traced span

    def _now(self) -> float:
        self.sync()
        return time.perf_counter()

    def begin(self, precompute_inside: bool = False) -> None:
        self.precompute_inside = precompute_inside
        self.t0 = self._now()

    def precomputed(self) -> bool:
        """Stamp the precompute's end (step 0); True where the window has
        closed, which ends the request."""
        t = self._now()
        self.stamps.append((0, t))
        self.cut = t >= self.deadline and self.may_cut()
        return self.cut

    def stamp(self, step: int, final: bool = False) -> bool:
        """Stamp `step`; True where the window has closed and the request
        is cut here. A step stamped already is not stamped again."""
        if self.stamps and self.stamps[-1][0] == step:
            return self.cut
        t = self._now()
        self.stamps.append((step, t))
        if self.tracer is not None:
            if step == self.trace_end and self.traced is None:
                self.tracer.stop(self.trace_end - self.trace_from)
                self.traced = (self.trace_from, self.trace_end)
            elif step == self.trace_from:
                self.tracer.start()
        self.cut = not final and t >= self.deadline and self.may_cut()
        return self.cut

    def has_rows(self) -> bool:
        return not self.compared or self.image is not None

    def may_cut(self) -> bool:
        if len(self.stamps) < 2:
            return False
        if self.tracer is None:
            return self.has_rows()
        return (self.has_rows() and self.traced is not None
                and self.stamps[-1][0] >= self.trace_end
                + 2 * self.stamp_every)

    def keep(self, image: torch.Tensor, hist: torch.Tensor) -> None:
        """Keep the image and the history (the step axis the one before
        the last) that the program returned at the first stamp, where the
        request is compared."""
        if self.has_rows():
            return
        self.image = image.detach().to("cpu")
        self.rows = hist.detach().to("cpu")

    def intervals(self) -> list[tuple[int, float, bool]]:
        """(steps, seconds, disturbed) between consecutive stamps of the
        loop: from the precompute's end, or from the first stamp where the
        precompute is inside the call. Disturbed: an interval that the
        profiler's start or stop falls in."""
        out = []
        for (s0, t0), (s1, t1) in zip(self.stamps, self.stamps[1:]):
            disturbed = (self.traced is not None
                         and self.traced[0] <= s0 <= self.traced[1])
            out.append((s1 - s0, t1 - t0, disturbed))
        return out
