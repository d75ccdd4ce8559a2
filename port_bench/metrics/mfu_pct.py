"""The whole step: the model's operations a step (`work/model.py`: VGG-19's
forward to its deepest tap and input gradient, the masked Grams and their
cotangents) over the step time of the window's undisturbed intervals,
against the bf16 peak."""
from port_bench.work.conv import deepest
from port_bench.work.model import step_ops
from port_bench.work.peaks import PEAK_OPS


def read(r):
    t = r.window["step_s_untraced"]
    if not t == t:   # NaN: no undisturbed interval
        return None
    last = deepest(r.cfg.style_layers + r.cfg.content_layers)
    ops = step_ops(r.config["vgg19_blocks"], *r.hw, r.traffic["classes"],
                   r.cfg.style_layers, last) * r.pairs
    return 100.0 * ops / t / PEAK_OPS["bfloat16"]
