"""The readers of the program's spans (`port_bench/spans.py` and its five
metrics) on a traced span and a record made by hand: device ms a step
from the record's last spans, host ms a step from the traced ranges, and
None where the span holds no range (a program without spans) or the
record too few (a run on the CPU)."""
import pytest

from port_bench import trace
from port_bench.metrics import (Reading, backward_ms_per_step,
                                features_ms_per_step, host_ms_per_step,
                                loss_ms_per_step, update_ms_per_step)

STAGES = (features_ms_per_step, loss_ms_per_step, backward_ms_per_step,
          update_ms_per_step)


def traced(steps=2):
    """`steps` steps of 100 µs: `dpst::step` over 10-90 µs of each, the
    four stages inside it, and an aten op."""
    s = trace.Span(steps=steps, start_us=0.0, end_us=100.0 * steps)
    for i in range(steps):
        t = 100.0 * i
        s.host += [("dpst::step", t + 10, t + 90),
                   ("dpst::features", t + 11, t + 30),
                   ("aten::conv2d", t + 12, t + 20),
                   ("dpst::loss", t + 30, t + 50),
                   ("dpst::backward", t + 50, t + 80),
                   ("dpst::update", t + 80, t + 89)]
    s.device = [("elementwise_kernel", 0.0, 100.0 * steps)]
    return s


def record(steps=2, before=0):
    """The program's record: `before` spans of another traced run, then
    `steps` steps of the traced one, a nested span before the one around
    it."""
    out = []
    for i in range(before + steps):
        old = 100.0 if i < before else 0.0
        out += [("dpst::features", old + 20.0), ("dpst::loss", old + 5.0),
                ("dpst::backward", old + 40.0), ("dpst::update", old + 2.0),
                ("dpst::step", old + 67.5)]
    return out


def reading(span):
    return Reading(cell={"name": "x"}, config={}, traffic={}, cfg=None,
                   span=span, window={})


class Event:
    """A CUDA timing event made by hand, at `t` ms."""

    def __init__(self, t):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def hold(monkeypatch):
    """Sets the program's record, emptied for the test, to the (name, ms)
    pairs given."""
    from dpst_tpu_torch.utils import runtime
    monkeypatch.setattr(runtime, "_SPANS", [])
    return lambda pairs: runtime._SPANS.extend(
        (n, Event(0.0), Event(ms)) for n, ms in pairs)


@pytest.mark.parametrize("before", [0, 3])
def test_stage_readers(hold, before):
    hold(record(before=before))
    r = reading(traced())
    got = [m.read(r) for m in STAGES]
    # the traced run's two steps alone, over two steps
    assert got == [pytest.approx(v) for v in (20.0, 5.0, 40.0, 2.0)]


def test_host_ms_a_step():
    # two dpst::step ranges of 80 µs over two steps
    assert host_ms_per_step.read(reading(traced())) == pytest.approx(0.08)


def test_readers_find_nothing(hold):
    # a run on the CPU: ranges, but no CUDA event in the record
    r = reading(traced())
    assert [m.read(r) for m in STAGES] == [None] * 4
    # a program without spans: no range in the traced span
    hold(record())
    bare = traced()
    bare.host = [e for e in bare.host if not e[0].startswith("dpst::")]
    r = reading(bare)
    assert [m.read(r) for m in STAGES] == [None] * 4
    assert host_ms_per_step.read(r) is None


def test_the_readers_leave_the_record_as_it_is(hold):
    from dpst_tpu_torch.utils import runtime
    hold(record())
    r = reading(traced())
    for m in STAGES:
        m.read(r)
    assert runtime.spans() == record()
