"""The Gram kernels (`gram_fwd`, `gram_bwd`, `gram_wbwd`, `gram_relu_fwd`,
`gram_relu_bwd`): the summed bounds of a step's masked Grams and their
cotangents at the style taps they serve (`work/gram.py`) over their
summed device time. The taps of blocks 1-2 are left out where the block12
kernels ran them."""
from port_bench.work.conv import layer_shapes
from port_bench.work.gram import gram_bwd_work, gram_fwd_work
from port_bench.work.peaks import bound_s, itemsize


def read(r):
    ms = r.group_ms("gram_")
    if not ms:
        return None
    isz, k = itemsize(r.dtype), r.traffic["classes"]
    shapes = {name: (cout, h * w) for name, _, cout, h, w in layer_shapes(
        r.config["vgg19_blocks"], *r.hw, "conv5_4")}
    taps = [l for l in r.cfg.style_layers
            if not (r.block12_ran and int(l[4]) <= 2)]
    bound = sum(bound_s(*gram_fwd_work(*shapes[l], k, isz), r.dtype)
                + bound_s(*gram_bwd_work(*shapes[l], k, isz), r.dtype)
                for l in taps)
    return 100.0 * bound * r.pairs / (ms / 1e3)
