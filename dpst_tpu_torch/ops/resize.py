"""Resize and mask-pyramid utilities (images and per-class masks)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_image(image: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) to (..., hw[0], hw[1], C).

    Antialiased when downsampling, like `jax.image.resize(method=
    "bilinear")`, which the JAX package uses."""
    lead = image.shape[:-3]
    h, w, c = image.shape[-3:]
    x = image.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(x.float(), size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, hw[0], hw[1], c)


def downsample_mask(masks: torch.Tensor, factor: int,
                    method: str = "avg") -> torch.Tensor:
    """Downsample (K, H, W) soft masks (or a batch (B, K, H, W)) by an
    integer stride.

    "avg": average pooling (keeps Σ_k m_k = 1 exact where it held);
    "nearest": strided subsampling.
    """
    if factor == 1:
        return masks
    if method == "nearest":
        return masks[..., ::factor, ::factor]
    x = masks if masks.dim() == 4 else masks[None]
    s = F.avg_pool2d(x, factor, factor, divisor_override=1)
    s = s if masks.dim() == 4 else s[0]
    return s / float(factor * factor)


def layer_downsample_factor(layer: str) -> int:
    """Spatial stride of a VGG layer relative to the input."""
    return 2 ** (int(layer[4]) - 1)


def mask_pyramid(masks: torch.Tensor, layers: tuple[str, ...],
                 method: str = "avg") -> dict:
    """Per-style-layer mask stacks: {layer: (K, H/2^(b-1), W/2^(b-1))}
    (with the batch axis of a (B, K, H, W) batch)."""
    return {layer: downsample_mask(masks, layer_downsample_factor(layer),
                                   method)
            for layer in layers}
