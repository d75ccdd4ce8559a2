"""The automatic-mask cell's pieces on the CPU: its readers on a program
with and without the segmentation counter, PSPNet-50's work by hand, and
its entry's refusals."""
import math

import pytest

from port_bench import trace
from port_bench.metrics import Reading


def reading():
    from dpst_tpu_torch import PRESETS
    return Reading(cell={"name": "x"}, config={}, traffic={
        "pairs_per_request": 1, "size": 2048, "classes": 8},
        cfg=PRESETS["config3"], span=trace.Span(steps=1),
        window={"precompute_s": 1.0, "step_s_untraced": 0.05})


READERS = ("segment_s", "merge_s", "pspnet_roofline_pct")


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_the_counter(monkeypatch, name):
    """A program without `segmentation.last_call` (the parent's), and one
    that has not segmented yet: None."""
    import importlib
    from dpst_tpu_torch import segmentation
    reader = importlib.import_module(f"port_bench.metrics.{name}")
    monkeypatch.delattr(segmentation, "last_call", raising=False)
    assert reader.read(reading()) is None
    monkeypatch.setattr(segmentation, "last_call", None, raising=False)
    assert reader.read(reading()) is None


def test_readers_read_the_counter(monkeypatch):
    from dpst_tpu_torch import segmentation
    from port_bench.metrics import merge_s, pspnet_roofline_pct, segment_s
    from port_bench.work import peaks, pspnet
    rec = segmentation.SegmentRecord(
        segment_s=0.05, merge_s=0.4, forward_ms=6.9, forwards=2,
        eval_size=473, classes=5, k=8)
    monkeypatch.setattr(segmentation, "last_call", rec)
    r = reading()
    assert segment_s.read(r) == 0.05 and merge_s.read(r) == 0.4
    bound = peaks.bound_s(*pspnet.forward_work(473, 2), "bfloat16")
    assert pspnet_roofline_pct.read(r) == pytest.approx(
        100 * 2 * bound / 6.9e-3)
    # two forwards of 324 GFLOP in 6.9 ms against 989 TFLOP/s
    assert 9 < pspnet_roofline_pct.read(r) < 10
    # a call on the CPU timed no forward on a card
    monkeypatch.setattr(segmentation, "last_call", rec.__class__(
        **{**rec.__dict__, "forward_ms": None}))
    assert pspnet_roofline_pct.read(r) is None


def test_pspnet_work_by_hand():
    from port_bench.work import pspnet
    shapes = pspnet.conv_shapes(473)
    # stem 473 → 237 (stride 2), max pool → 119, res3 → 60 and on
    assert shapes[0] == (3, 3, 64, 473, 237)
    assert shapes[3] == (1, 128, 64, 119, 119)
    assert [s[3:] for s in shapes[-6:]] == [
        (1, 1), (2, 2), (3, 3), (6, 6), (60, 60), (60, 60)]
    nbytes, ops = pspnet.forward_work(473, 2)
    assert ops == pytest.approx(323.75e9, rel=1e-4)
    # the head alone: 512 → 150 at 60², and the fp32 logits at 473²
    head = (2.0 * 512 * 150 * 3600, (512 * 3600 + 150 * 3600 + 512 * 150) * 2
            + 150 * 473 * 473 * 4)
    assert head[0] < ops and head[1] < nbytes
    assert math.isclose(nbytes, 734_553_534)


def test_entry_refuses_masks_and_a_config_without_segmentation():
    import dataclasses
    from dpst_tpu_torch import PRESETS
    from port_bench import harness, inputs
    from port_bench.entries import Request, stylize_auto
    cfg = PRESETS["config3"]
    with pytest.raises(ValueError, match="use_segmentation"):
        stylize_auto.resolve(dataclasses.replace(cfg, use_segmentation=False))
    ctx = harness.Context(cfg, {}, "cpu", "bands")
    pair = inputs.Pair(*[None] * 2, *inputs.band_masks(2, 4, 0, 0)[None]
                       .repeat(2, 0))
    with pytest.raises(ValueError, match="bands"):
        stylize_auto.run_request(ctx, [pair], Request(2, 2, lambda: None))
