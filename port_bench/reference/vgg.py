"""VGG-19 (configuration E of Simonyan and Zisserman, arXiv:1409.1556) up
to a chosen tap, in plain PyTorch: Caffe preprocessing (RGB in [0, 255] to
BGR less the ImageNet means), SAME 3×3 convs with biases, ReLU, and a 2×2
pool after each block. Taps are the post-ReLU activations."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference.precision import Precision

BGR_MEANS = (103.939, 116.779, 123.68)


def layer_order(blocks) -> list[str]:
    """conv1_1, conv1_2, pool1, conv2_1, ... for `blocks` [(convs, width)]."""
    out = []
    for b, (n, _) in enumerate(blocks, start=1):
        out += [f"conv{b}_{i}" for i in range(1, n + 1)] + [f"pool{b}"]
    return out


def stride(layer: str) -> int:
    """A tap's stride against the image: 2^(block - 1)."""
    return 2 ** (int(layer[4]) - 1)


def preprocess(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) RGB in [0, 255] -> (1, 3, H, W) BGR less the means."""
    means = torch.tensor(BGR_MEANS, dtype=image.dtype, device=image.device)
    return (image.flip(-1) - means).permute(2, 0, 1)[None]


def taps(params: dict, image: torch.Tensor, layers, blocks, pooling: str,
         prec: Precision) -> dict:
    """{layer: (C, H_l, W_l)} post-ReLU taps of an (H, W, 3) image, the
    network run up to the deepest of `layers`."""
    order = layer_order(blocks)
    last = max(order.index(l) for l in layers)
    x = prec.round(preprocess(image))
    out = {}
    for name in order[:last + 1]:
        if name.startswith("pool"):
            x = (F.max_pool2d(x, 2) if pooling == "max"
                 else F.avg_pool2d(x, 2))
            continue
        p = params[name]
        x = prec.round(F.relu(prec.conv(x, p["w"]) + p["b"][:, None, None]))
        if name in layers:
            out[name] = x[0]
    return out
