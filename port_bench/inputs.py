"""Everything a run feeds the program, made from `--seed`.

The VGG-19 weights (He-normal, zero biases) and each request's pair of
images with their class masks. Both are drawn on the run's device from one
`torch.Generator` seeded with the run's seed, weights first, in a few large
calls. The image generators are frozen copies of `chip_smoke.py`'s
`smooth_image` and `textured_image`, drawn on the device and handed over
as float32 numpy arrays in [0, 255], as a caller of the program holds
them. The band masks follow `chip_smoke.py`'s `band_masks`: K bands that
cover the image, so every class is non-empty; each pair draws its axes and
cyclic offsets from the seed.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


def conv_layers(blocks) -> list[tuple[str, int, int]]:
    """[(name, Cin, Cout)] of the convs of `blocks` ([(convs, width)] per
    block), named conv<block>_<i>, from 3 input channels."""
    out, cin = [], 3
    for b, (n, width) in enumerate(blocks, start=1):
        for i in range(1, n + 1):
            out.append((f"conv{b}_{i}", cin, width))
            cin = width
    return out


def vgg_weights(blocks, gen: torch.Generator, device) -> dict:
    """{conv: {"w": (Cout, Cin, 3, 3), "b": (Cout,)}} float32 on `device`:
    He-normal weights (std sqrt(2 / (9 Cin))) from one draw for all convs,
    zero biases."""
    layers = conv_layers(blocks)
    sizes = [cout * cin * 9 for _, cin, cout in layers]
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    params, off = {}, 0
    for (name, cin, cout), n in zip(layers, sizes):
        w = flat[off:off + n].view(cout, cin, 3, 3) * math.sqrt(2.0 / (9 * cin))
        params[name] = {"w": w.contiguous(),
                        "b": torch.zeros(cout, dtype=torch.float32,
                                         device=device)}
        off += n
    return params


def smooth_image(gen: torch.Generator, device, size: int) -> torch.Tensor:
    """A seeded photo-like (size, size, 3) image in [0, 255]: low-frequency
    colour fields plus noise."""
    low = torch.rand((1, 3, max(size // 32, 1), max(size // 32, 1)),
                     generator=gen, device=device)
    img = F.interpolate(low, size=(size, size), mode="bicubic",
                        align_corners=False)[0].permute(1, 2, 0)
    img = img + 0.05 * torch.randn((size, size, 3), generator=gen,
                                   device=device)
    return (img.clamp(0, 1) * 255).contiguous()


def textured_image(gen: torch.Generator, device, size: int) -> torch.Tensor:
    """A seeded style photo with texture: `smooth_image` plus per-pixel
    noise of 40 grey levels, so that the style term keeps its weight
    against the photorealism term at large sizes, as a real style photo
    does."""
    img = smooth_image(gen, device, size)
    img = img + 40.0 * torch.randn(img.shape, generator=gen, device=device)
    return img.clamp(0, 255).contiguous()


def band_masks(k: int, size: int, axis: int, shift: int) -> np.ndarray:
    """(k, size, size) one-hot float32 masks: k bands of size // k rows
    (axis 0) or columns (axis 1), the last taking any remainder, moved on
    cyclically by `shift` pixels. Every class is non-empty."""
    band = size // k
    cls = np.minimum((np.arange(size) + shift) % size // band, k - 1)
    m = np.zeros((k, size, size), np.float32)
    for j in range(k):
        if axis == 0:
            m[j, cls == j, :] = 1.0
        else:
            m[j, :, cls == j] = 1.0
    return m


class Pair(NamedTuple):
    content: np.ndarray        # (H, W, 3) float32 [0, 255]
    style: np.ndarray          # (H, W, 3) float32 [0, 255]
    content_masks: np.ndarray  # (K, H, W) float32
    style_masks: np.ndarray    # (K, H, W) float32


def make_pairs(traffic: dict, gen: torch.Generator, device) -> list[Pair]:
    """The pool of distinct pairs a run's requests take, in order: a
    smooth content image, a textured (or smooth) style image, and K band
    masks for each, the content's bands across one axis and the style's
    across the other, each at an offset drawn from the seed."""
    size, k = traffic["size"], traffic["classes"]
    n = traffic["pairs_per_request"] * traffic["pool_requests"]
    style_fn = (textured_image if traffic["style"] == "textured"
                else smooth_image)
    pairs = []
    for _ in range(n):
        content = smooth_image(gen, device, size).cpu().numpy()
        style = style_fn(gen, device, size).cpu().numpy()
        axis, c_shift, s_shift = (int(v) for v in torch.randint(
            0, size, (3,), generator=gen, device=device).cpu())
        axis %= 2
        pairs.append(Pair(content, style,
                          band_masks(k, size, axis, c_shift),
                          band_masks(k, size, 1 - axis, s_shift)))
    return pairs


def request_pairs(pool: list[Pair], per_request: int, index: int
                  ) -> list[Pair]:
    """The pairs of request `index`: the pool's slices in turn."""
    slices = len(pool) // per_request
    start = (index % slices) * per_request
    return pool[start:start + per_request]
