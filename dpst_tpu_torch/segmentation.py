"""Mask pipeline of the port: automatic masks, uniform masks, coverage
weights, pyramids.

The automatic pipeline (`dpst_tpu/segmentation.py`): PSPNet
(`models/pspnet.py`) segments the content and the style image into
ADE20K label maps on the device, the maps come back to the host as int32
numpy, `semantic_merge.merge_classes` aligns the two label sets there, and
`masks_from_labels` turns the merged maps into one-hot (K_max, H, W) mask
stacks, zero-padded to `max_classes`.
"""
from __future__ import annotations

import numpy as np
import torch

from . import semantic_merge
from .models import pspnet
from .ops.resize import mask_pyramid
from .utils.runtime import params_on, resolve_device


def segment_images(content: np.ndarray, style: np.ndarray,
                   params: dict | None = None,
                   compute_dtype="bfloat16", protocol: str = "resize",
                   seg_scales: tuple = (1.0,), device=None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """PSPNet on both (H, W, 3) images on `device` (None: the CUDA card)
    -> per-pixel ADE20K class maps (H, W) as int32 numpy. `params` is the
    port's PSPNet dict (`models.pspnet.params_from_numpy` converts the JAX
    package's); None takes `pspnet.get_params()` (seed 0).
    `protocol`/`seg_scales` select the inference protocol
    (`pspnet.segment`)."""
    dev = resolve_device(device)
    params = (pspnet.get_params(device=dev) if params is None
              else params_on(params, dev))
    return tuple(
        pspnet.segment(params, torch.as_tensor(
            np.asarray(img, np.float32)).to(dev), compute_dtype,
            protocol=protocol, scales=seg_scales).cpu().numpy()
        for img in (content, style))


def masks_from_labels(labels: np.ndarray, class_ids: list[int],
                      max_classes: int) -> np.ndarray:
    """One-hot (K_max, H, W) float32 masks for `class_ids`, zero-padded.

    `class_ids` is the merged class list shared by content and style
    (`semantic_merge.merge_classes`); its order is the class axis."""
    if len(class_ids) > max_classes:
        raise ValueError(
            f"{len(class_ids)} merged classes > max_classes={max_classes}; "
            "raise StylizeConfig.max_classes")
    h, w = labels.shape
    masks = np.zeros((max_classes, h, w), dtype=np.float32)
    for k, cid in enumerate(class_ids):
        masks[k] = (labels == cid)
    return masks


def _merged_masks(seg_c: np.ndarray, seg_s: np.ndarray, cfg
                  ) -> tuple[np.ndarray, np.ndarray, list[int]]:
    merged_c, merged_s, class_ids = semantic_merge.merge_classes(
        seg_c, seg_s, metric=cfg.similarity_metric,
        threshold=cfg.similarity_threshold, max_classes=cfg.max_classes)
    return (masks_from_labels(merged_c, class_ids, cfg.max_classes),
            masks_from_labels(merged_s, class_ids, cfg.max_classes),
            class_ids)


def automatic_masks(content: np.ndarray, style: np.ndarray, cfg,
                    params: dict | None = None, device=None
                    ) -> tuple[np.ndarray, np.ndarray, list[int]]:
    """The automatic pipeline for one pair: segment both on `device`, merge
    the label sets on the host -> aligned (K_max, H, W) mask stacks for
    content and style, and the merged class ids."""
    seg_c, seg_s = segment_images(content, style, params, cfg.compute_dtype,
                                  protocol=cfg.seg_protocol,
                                  seg_scales=cfg.seg_scales, device=device)
    return _merged_masks(seg_c, seg_s, cfg)


def automatic_masks_batch(contents: np.ndarray, style: np.ndarray, cfg,
                          params: dict | None = None, device=None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """`automatic_masks` for N content images sharing one style:
    (N, H, W, 3) + (H, W, 3) -> ((N, K, H, W), (N, K, H, W)). With the
    resize protocol the contents go through `pspnet.segment_batch` and the
    style is segmented once; the merge stays per pair. The sliding
    protocol's window geometry is per image, so it loops over the pairs."""
    dev = resolve_device(device)
    params = (pspnet.get_params(device=dev) if params is None
              else params_on(params, dev))
    if cfg.seg_protocol != "resize":
        pairs = [automatic_masks(c, style, cfg, params, dev)
                 for c in contents]
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]))
    seg_c_all = pspnet.segment_batch(
        params, torch.as_tensor(np.asarray(contents, np.float32)).to(dev),
        cfg.compute_dtype).cpu().numpy()
    seg_s = pspnet.segment(
        params, torch.as_tensor(np.asarray(style, np.float32)).to(dev),
        cfg.compute_dtype).cpu().numpy()
    pairs = [_merged_masks(seg_c, seg_s, cfg)[:2] for seg_c in seg_c_all]
    return (np.stack([p[0] for p in pairs]),
            np.stack([p[1] for p in pairs]))


def uniform_masks(hw: tuple[int, int], max_classes: int = 1) -> np.ndarray:
    """Single all-ones mask (zero-padded to max_classes): the masked style
    loss then is the plain Gatys Gram loss."""
    masks = np.zeros((max_classes, hw[0], hw[1]), dtype=np.float32)
    masks[0] = 1.0
    return masks


def coverage_weights(content_masks: torch.Tensor) -> torch.Tensor:
    """(K,) per-class style-loss weights: content-image coverage fractions
    ((B, K) for a batch (B, K, H, W)).

    Zero-padded classes get exactly 0."""
    m = content_masks.to(torch.float32)
    area = torch.sum(m * m, dim=(-2, -1))
    total = torch.clamp_min(torch.sum(area, dim=-1, keepdim=True), 1e-8)
    return area / total


def layer_masks(masks: torch.Tensor, style_layers: tuple[str, ...],
                method: str = "avg") -> dict:
    """Per-style-layer downsampled mask stacks."""
    return mask_pyramid(masks.to(torch.float32), style_layers, method)
