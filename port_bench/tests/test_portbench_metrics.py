"""The window's arithmetic (`gpu_s_per_image` and its parts), the traced
span's reduction and the per-layer readers, on stamps and events made by
hand."""
import math

import pytest

from port_bench import harness, trace
from port_bench.entries import Request
from port_bench.metrics import Reading


def stamped(t0, stamps, inside=False, traced=None):
    r = Request(500, 25, lambda: None)
    r.t0, r.precompute_inside, r.stamps = t0, inside, stamps
    r.traced = traced
    return r


def test_gpu_s_per_image_with_a_synced_precompute():
    # two requests of 8 pairs: precomputes of 0.5 and 0.7 s, then 50 and
    # 25 steps at 30 ms
    a = stamped(10.0, [(0, 10.5), (25, 11.25), (50, 12.0)])
    b = stamped(12.0, [(0, 12.7), (25, 13.45)])
    wm = harness.window_metrics([a, b], pairs=8, steps=500)
    assert wm["precompute_s"] == pytest.approx(0.6)
    assert wm["step_s"] == pytest.approx(0.03)
    assert wm["steps"] == 75
    assert wm["gpu_s_per_image"] == pytest.approx((0.6 + 500 * 0.03) / 8)


def test_gpu_s_per_image_with_the_precompute_inside_the_call():
    # the first stamp comes 5 steps of 160 ms after a 4 s precompute
    r = stamped(0.0, [(5, 4.8), (10, 5.6), (15, 6.4)], inside=True)
    wm = harness.window_metrics([r], pairs=1, steps=500)
    assert wm["step_s"] == pytest.approx(0.16)
    assert wm["precompute_s"] == pytest.approx(4.0)
    assert wm["gpu_s_per_image"] == pytest.approx(4.0 + 500 * 0.16)


def test_traced_intervals_are_left_out_of_the_untraced_step_time():
    r = stamped(0.0, [(0, 1.0), (25, 2.0), (50, 4.0), (75, 6.0), (100, 7.0)],
                traced=(25, 50))
    wm = harness.window_metrics([r], pairs=1, steps=500)
    # the intervals from the traced span's start and from its stop are
    # disturbed: 25-50 and 50-75
    assert wm["step_s_untraced"] == pytest.approx(2.0 / 50)
    assert wm["step_s"] == pytest.approx(6.0 / 100)
    # a precompute inside the call takes the undisturbed step time
    r = stamped(0.0, [(5, 1.2), (10, 1.4), (15, 9.4), (20, 9.6)],
                inside=True, traced=(10, 15))
    wm = harness.window_metrics([r], pairs=1, steps=500)
    assert wm["step_s_untraced"] == pytest.approx(0.04)
    assert wm["precompute_s"] == pytest.approx(1.0)


def span():
    s = trace.Span(steps=2, start_us=0.0, end_us=100.0)
    s.device = [("cutlass_sm90_gemm_bf16", 10, 30),
                ("gram_fwd_kernel", 30, 40),
                ("Memcpy HtoD", 40, 45),
                ("elementwise_kernel", 60, 70),
                ("block12_gram_df", 70, 80)]
    s.host = [("aten::add", 45, 62), ("cudaLaunchKernel", 50, 55),
              ("aten::mul", 80, 99)]
    return s


def test_span_reduction():
    s = span()
    assert s.busy_s() == pytest.approx(55e-6)
    assert s.window_s == pytest.approx(100e-6)
    assert s.kernels() == 4
    assert s.idle_gaps() == [(0.0, 10), (45, 60), (80, 100.0)]
    g = s.groups_ms()
    assert g[trace.CONV] == pytest.approx(0.01)
    assert g["gram_fwd"] == pytest.approx(0.005)
    assert g["block12_* Gram cotangent"] == pytest.approx(0.005)
    assert s.top_device_ops(1) == [["cutlass_sm90_gemm_bf16", 20e-6]]
    gaps = dict(s.top_idle_gaps())
    # gap 45-60: its middle 52.5 is inside cudaLaunchKernel (the innermost)
    assert gaps["cudaLaunchKernel"] == pytest.approx(15e-6)
    assert gaps["aten::mul"] == pytest.approx(20e-6)
    assert gaps["host: no op"] == pytest.approx(10e-6)


def reading(s, step_s=0.03):
    from dpst_tpu_torch import PRESETS
    cfg = PRESETS["config3"]
    blocks = [[2, 64], [2, 128], [4, 256], [4, 512], [4, 512]]
    return Reading(cell={"name": "x"}, config={"vgg19_blocks": blocks},
                   traffic={"pairs_per_request": 8, "size": 512,
                            "classes": 4},
                   cfg=cfg, span=s,
                   window={"precompute_s": 0.5, "step_s_untraced": step_s})


def test_readers():
    from port_bench.metrics import (block12_roofline_pct, conv_roofline_pct,
                                    device_idle_pct, glue_ms_per_step,
                                    gram_roofline_pct, kernels_per_step,
                                    mfu_pct, precompute_s)
    from port_bench.work import conv, gram, model, peaks
    s = span()
    r = reading(s)
    assert precompute_s.read(r) == 0.5
    assert kernels_per_step.read(r) == 2
    # 27.5 µs busy a step against 30 ms a step untraced
    assert device_idle_pct.read(r) == pytest.approx(
        100 * (1 - 27.5e-6 / 0.03))
    # the elementwise kernel and the copy
    assert glue_ms_per_step.read(r) == pytest.approx(0.0075)
    blocks = r.config["vgg19_blocks"]
    bound = 8 * sum(2 * peaks.bound_s(*conv.conv_work(*c, 2), "bfloat16")
                    for c in conv.step_convs(blocks, 512, 512, "conv5_1"))
    # block12 kernels ran in this span: blocks 1-2's convs are theirs
    tail = 8 * sum(2 * peaks.bound_s(*conv.conv_work(*c, 2), "bfloat16")
                   for c in conv.step_convs(blocks, 512, 512, "conv5_1",
                                            "conv3_1"))
    assert r.block12_ran
    assert conv_roofline_pct.read(r) == pytest.approx(100 * tail / 1e-5)
    assert bound > tail
    g = sum(peaks.bound_s(*gram.gram_fwd_work(c, p, 4, 2), "bfloat16")
            + peaks.bound_s(*gram.gram_bwd_work(c, p, 4, 2), "bfloat16")
            for c, p in ((256, 128 * 128), (512, 64 * 64), (512, 32 * 32)))
    assert gram_roofline_pct.read(r) == pytest.approx(100 * 8 * g / 5e-6)
    assert block12_roofline_pct.read(r) > 0
    ops = 8 * model.step_ops(blocks, 512, 512, 4, r.cfg.style_layers,
                             "conv5_1")
    assert mfu_pct.read(r) == pytest.approx(100 * ops / 0.03 / 989e12)


def test_readers_find_nothing():
    from port_bench.metrics import (block12_roofline_pct, device_idle_pct,
                                    gram_roofline_pct, mfu_pct)
    s = trace.Span(steps=1, start_us=0.0, end_us=10.0)
    s.device = [("elementwise_kernel", 0, 5)]
    r = reading(s, step_s=math.nan)
    assert block12_roofline_pct.read(r) is None
    assert gram_roofline_pct.read(r) is None
    assert mfu_pct.read(r) is None
    assert device_idle_pct.read(r) is None


def test_the_compared_request_is_not_cut_before_its_rows():
    import torch
    r = Request(500, 25, lambda: None, deadline=-math.inf, compared=True)
    assert r.precomputed() is False
    r.keep(torch.ones(8, 4, 4, 3), torch.zeros(8, 25, 5))
    assert r.stamp(25) is True
    r.keep(torch.zeros(8, 4, 4, 3), torch.ones(8, 25, 5))
    assert r.rows.shape == (8, 25, 5) and float(r.rows.sum()) == 0.0
    assert float(r.image.sum()) == 8 * 48
    other = Request(500, 25, lambda: None, deadline=-math.inf)
    assert other.precomputed() is False    # no steps timed yet
    assert other.stamp(25) is True
    other.keep(torch.ones(1), torch.ones(1))
    assert other.image is None
    # a request whose precompute is inside its call: two stamps first
    inside = Request(500, 5, lambda: None, deadline=-math.inf)
    inside.begin(precompute_inside=True)
    assert inside.stamp(5) is False and inside.stamp(10) is True


def test_a_traced_request_is_not_cut_before_its_span_closes():
    class Tracer:
        def start(self):
            self.started = True

        def stop(self, steps):
            self.steps = steps
    tracer = Tracer()
    r = Request(500, 5, lambda: None, deadline=-math.inf, tracer=tracer,
                trace_from=5, trace_steps=10)
    assert r.precomputed() is False
    assert r.stamp(5) is False and tracer.started
    assert r.stamp(10) is False
    assert r.stamp(15) is False and r.traced == (5, 15)
    assert tracer.steps == 10
    # the interval from 15 holds the profiler's stop; 20 to 25 does not
    assert r.stamp(20) is False
    assert r.stamp(25) is True
    assert [d for _, _, d in r.intervals()] == [False, True, True, True,
                                                 False]
