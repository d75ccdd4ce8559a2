"""Mask pipeline of the port: uniform masks, coverage weights, pyramids.

Automatic segmentation (PSPNet and class merging) is not ported yet;
`stylize` raises NotImplementedError when it would be needed.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.resize import mask_pyramid


def uniform_masks(hw: tuple[int, int], max_classes: int = 1) -> np.ndarray:
    """Single all-ones mask (zero-padded to max_classes): the masked style
    loss then is the plain Gatys Gram loss."""
    masks = np.zeros((max_classes, hw[0], hw[1]), dtype=np.float32)
    masks[0] = 1.0
    return masks


def coverage_weights(content_masks: torch.Tensor) -> torch.Tensor:
    """(K,) per-class style-loss weights: content-image coverage fractions.

    Zero-padded classes get exactly 0."""
    m = content_masks.to(torch.float32)
    area = torch.sum(m * m, dim=(1, 2))
    total = torch.clamp_min(torch.sum(area), 1e-8)
    return area / total


def layer_masks(masks: torch.Tensor, style_layers: tuple[str, ...],
                method: str = "avg") -> dict:
    """Per-style-layer downsampled mask stacks."""
    return mask_pyramid(masks.to(torch.float32), style_layers, method)
