"""VGG's convs on cuDNN: the least time their forwards and input
gradients could take a step (each conv the larger of its operations over
the peak and its bytes over the bandwidth, `work/conv.py`) over their
device time (`trace.kernel_group`'s "conv (cuDNN)"). Blocks 1-2's convs
are left out where the block12 kernels ran them."""
from port_bench.trace import CONV
from port_bench.work.conv import conv_work, deepest, step_convs
from port_bench.work.peaks import bound_s, itemsize


def read(r):
    ms = r.span.groups_ms().get(CONV)
    if not ms:
        return None
    isz = itemsize(r.dtype)
    first = "conv3_1" if r.block12_ran else None
    last = deepest(r.cfg.style_layers + r.cfg.content_layers)
    bound = sum(2 * bound_s(*conv_work(*shape, isz), r.dtype)
                for shape in step_convs(r.config["vgg19_blocks"], *r.hw,
                                        last, first))
    return 100.0 * bound * r.pairs / (ms / 1e3)
