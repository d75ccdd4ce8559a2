"""Operations and bytes of VGG-19's 3×3 convolutions, from shapes alone:
each conv's forward and its input gradient read their input and weights
once and write their output once; 2·9·Cin·Cout operations a pixel."""
from __future__ import annotations

from port_bench.inputs import conv_layers


def deepest(layers) -> str:
    """The deepest of VGG tap names ("conv<block>_<n>")."""
    return max(layers, key=lambda l: (int(l[4]), int(l[6:])))


def layer_shapes(blocks, h: int, w: int, last: str
                 ) -> list[tuple[str, int, int, int, int]]:
    """[(name, Cin, Cout, H_l, W_l)] of the convs up to `last`; a block
    runs at the input size over 2^(block - 1)."""
    out = []
    for name, cin, cout in conv_layers(blocks):
        s = 2 ** (int(name[4]) - 1)
        out.append((name, cin, cout, h // s, w // s))
        if name == last:
            break
    return out


def conv_work(cin: int, cout: int, h: int, w: int, isz: int
              ) -> tuple[float, float]:
    """(bytes, operations) of one SAME 3×3 conv of one image, or of its
    input gradient (the same shapes in the other direction)."""
    ops = 2.0 * 9 * cin * cout * h * w
    nbytes = ((cin + cout) * h * w + 9 * cin * cout) * isz
    return nbytes, ops


def step_convs(blocks, h: int, w: int, last: str, first: str | None = None
               ) -> list[tuple[int, int, int, int]]:
    """(Cin, Cout, H_l, W_l) of the convs a step runs from `first` (the
    first conv when None) to `last`; each runs forward and as an input
    gradient."""
    shapes = layer_shapes(blocks, h, w, last)
    names = [s[0] for s in shapes]
    start = names.index(first) if first else 0
    return [s[1:] for s in shapes[start:]]
