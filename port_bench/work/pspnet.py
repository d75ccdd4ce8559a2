"""Operations and bytes of one PSPNet-50 forward of one image at its
evaluation size (`reference/pspnet.py`'s layers), from shapes alone: each
conv reads its input and weights once and writes its output once, in the
compute dtype, and does 2·k²·Cin·Cout operations an output pixel; the
forward then writes the 150 logits at the evaluation size in float32 (the
aligned-corners upsampling of the head's output). Pools, sums and the
pyramid's upsamplings are left out: they are under 1 % of the bytes."""
from __future__ import annotations

from port_bench.reference.pspnet import BINS, CLASSES, STAGES, layers


def conv_shapes(size: int) -> list[tuple[int, int, int, int, int]]:
    """(k, Cin, Cout, input side, output side) of every conv of a forward
    at size², "SAME" padded (an output side of ceil(side / stride))."""
    down = lambda n: -(-n // 2)
    side = {"stem1": (size, down(size))}
    s = down(size)
    side["stem2"] = side["stem3"] = (s, s)
    s = down(s)                                  # the max pool
    for name, blocks, _, stride, _ in STAGES:
        for b in range(blocks):
            p = f"{name}_{b}"
            out = down(s) if stride == 2 and b == 0 else s
            side[f"{p}_a"] = (s, s)
            side[f"{p}_b"] = (s, out)
            side[f"{p}_c"] = (out, out)
            if b == 0:
                side[f"{p}_proj"] = (s, out)
            s = out
    for b in BINS:                               # on the pooled bins
        n = s // (s // b)
        side[f"ppm{b}"] = (n, n)
    side["fuse"] = side["head"] = (s, s)
    return [(k, cin, cout, *side[name]) for name, k, cin, cout in layers()]


def forward_work(size: int, isz: int) -> tuple[float, float]:
    """(bytes, operations) of one forward of one size² image."""
    nbytes = ops = 0.0
    for k, cin, cout, n_in, n_out in conv_shapes(size):
        ops += 2.0 * k * k * cin * cout * n_out * n_out
        nbytes += (cin * n_in * n_in + cout * n_out * n_out
                   + k * k * cin * cout) * isz
    return nbytes + CLASSES * size * size * 4, ops
