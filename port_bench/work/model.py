"""The model operations of one optimizer step of one pair, whatever
implements them: VGG-19's forward to its deepest tap and its input
gradient (every conv twice), and the masked Grams of the style taps with
their cotangents (twice 2·K·C²·P each)."""
from __future__ import annotations

from port_bench.work.conv import conv_work, layer_shapes


def step_ops(blocks, h: int, w: int, k: int, style_layers, last: str
             ) -> float:
    ops = 0.0
    widths = {}
    for name, cin, cout, hl, wl in layer_shapes(blocks, h, w, last):
        ops += 2 * conv_work(cin, cout, hl, wl, 2)[1]
        widths[name] = (cout, hl * wl)
    for layer in style_layers:
        c, p = widths[layer]
        ops += 2 * 2.0 * k * c * c * p
    return ops
