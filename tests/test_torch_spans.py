"""The port's spans (`utils/runtime.span`): nothing entered or recorded
while no profiler records; under torch.profiler, one `dpst::step` a step
around `dpst::features`, `dpst::loss`, `dpst::backward` and `dpst::update`
in that order, one `dpst::precompute` a stage; the same bits with the
profiler on and off; and the record's device times, with timing events
made by hand."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import dpst_tpu_torch
from dpst_tpu_torch import optimize
from dpst_tpu_torch.models import vgg
from dpst_tpu_torch.ops import laplacian_spmd
from dpst_tpu_torch.parallel import batch as pb
from dpst_tpu_torch.utils import runtime

STAGES = ["dpst::features", "dpst::loss", "dpst::backward", "dpst::update"]
CFG = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"], iterations=3,
                          compute_dtype="float32", laplacian_impl="xla",
                          max_classes=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return vgg.init_params(0)


def _pairs(b, size=48, k=2, seed=5):
    """b pairs of (content, style, content masks, style masks): k bands
    across the rows and across the columns."""
    r = np.random.default_rng(seed)
    imgs = r.uniform(0, 255, (2, b, size, size, 3)).astype(np.float32)
    band = np.minimum(np.arange(size) * k // size, k - 1)
    cm = np.stack([np.broadcast_to((band == j)[:, None], (size, size))
                   for j in range(k)]).astype(np.float32)
    cm = np.broadcast_to(cm, (b, k, size, size)).copy()
    sm = np.swapaxes(cm, -1, -2).copy()
    return imgs[0], imgs[1], cm, sm


def _stylize(params, cfg=CFG):
    content, style, cm, sm = _pairs(1)
    return dpst_tpu_torch.stylize(
        content[0], style[0], cfg, content_masks=cm[0], style_masks=sm[0],
        vgg_params=params, return_history=True, device="cpu")


def _adam_batch(params, cfg=CFG):
    arrays = [torch.from_numpy(a) for a in _pairs(2)]
    packed = vgg.params_by_device(params, [torch.device("cpu")],
                                  cfg.compute_dtype, cfg.conv_impl)
    packed = packed[torch.device("cpu")]
    consts, contents, means = pb.prepare_batch_stage(
        *arrays, packed, (48, 48), cfg)
    images = optimize.init_image(cfg, contents, means)
    state = optimize.init_opt_state(optimize.make_optimizer(cfg), cfg,
                                    images)
    return optimize.drain(optimize.adam_segment(
        images, state, consts, optimize.LossWeights.from_config(cfg), packed,
        cfg.iterations, cfg))[::2]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.name.startswith(runtime.PREFIX)),
                    key=lambda e: (e[1], -e[2]))
    return out, ranges


def _check_steps(ranges, steps):
    """One `dpst::step` a step, with the four stages inside it in order,
    and no stage outside a step."""
    step_ranges = [r for r in ranges if r[0] == "dpst::step"]
    assert len(step_ranges) == steps
    for _, t0, t1 in step_ranges:
        inside = [n for n, s0, s1 in ranges
                  if t0 <= s0 and s1 <= t1 and n != "dpst::step"]
        assert inside == STAGES
    assert sum(n in STAGES for n, _, _ in ranges) == 4 * steps


class _Raise:
    def __init__(self, *args, **kwargs):
        raise AssertionError("entered while no profiler records")


def test_no_range_or_event_without_a_profiler(params, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Raise)
    monkeypatch.setattr(torch.cuda, "Event", _Raise)
    runtime.clear_spans()
    with runtime.span("step"):
        pass
    _, hist = _stylize(params, dataclasses.replace(CFG, iterations=1))
    assert hist.shape == (1, 5)
    assert runtime.spans() == []


def test_stylize_steps_and_precompute_under_the_profiler(params):
    cfg = dataclasses.replace(CFG, scales=(32, 48), scale_iters=(2, 3),
                              iterations=5)
    (out, hist), ranges = _profiled(lambda: _stylize(params, cfg))
    assert hist.shape == (5, 5)
    _check_steps(ranges, 5)
    assert [n for n, _, _ in ranges].count("dpst::precompute") == 2
    # each stage's precompute comes before its steps
    pre = [t0 for n, t0, _ in ranges if n == "dpst::precompute"]
    steps = [t0 for n, t0, _ in ranges if n == "dpst::step"]
    assert pre[0] < steps[0] and steps[1] < pre[1] < steps[2]


def test_adam_batch_steps_under_the_profiler(params):
    (images, hist), ranges = _profiled(lambda: _adam_batch(params))
    assert images.shape == (2, 48, 48, 3) and hist.shape == (2, 3, 5)
    _check_steps(ranges, 3)
    assert [n for n, _, _ in ranges].count("dpst::precompute") == 1


@pytest.mark.parametrize("run", [_stylize, _adam_batch])
def test_the_same_bits_with_the_profiler_on_and_off(params, run):
    a_img, a_hist = run(params)
    (b_img, b_hist), ranges = _profiled(lambda: run(params))
    assert ranges
    for a, b in ((a_img, b_img), (a_hist, b_hist)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_halo_exchanges_are_spans(monkeypatch):
    """The halo exchange and the level gather of a row-sharded image open
    `dpst::halo` (the range a profile's halo group is found by) under the
    profiler, and enter no range without one."""
    shards = list(torch.arange(48.0).reshape(1, 8, 6).split(4, dim=-2))

    def run():
        ext = laplacian_spmd.exchange_rows(shards)
        return laplacian_spmd.gather_rows(ext, torch.device("cpu"))
    out, ranges = _profiled(run)
    assert laplacian_spmd.HALO_RANGE == "dpst::halo"
    assert [n for n, _, _ in ranges] == ["dpst::halo"] * 2
    monkeypatch.setattr(torch.profiler, "record_function", _Raise)
    assert torch.equal(run(), out)


class _FakeEvent:
    """A timing event on a clock of its own: `record` reads the next
    tick."""
    clock = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self):
        _FakeEvent.clock += 1.5
        self.t = _FakeEvent.clock

    def synchronize(self):
        assert self.t is not None

    def elapsed_time(self, end):
        return end.t - self.t


def test_the_record_of_device_times(monkeypatch, tmp_path):
    """Where CUDA is in use, a span keeps its two events at its exit (a
    nested span first); `spans()` gives their ms without emptying the
    record; `maybe_profile` empties it."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    runtime.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with runtime.span("step"):
            with runtime.span("features"):
                pass
            with runtime.span("update"):
                pass
    with runtime.span("step"):   # no profiler: not kept
        pass
    want = [("dpst::features", 1.5), ("dpst::update", 1.5),
            ("dpst::step", 7.5)]
    assert runtime.spans() == want
    assert runtime.spans() == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with runtime.maybe_profile(""):
        assert runtime.spans() == want
    with runtime.maybe_profile(str(tmp_path)):
        assert runtime.spans() == []
