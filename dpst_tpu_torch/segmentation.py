"""Mask pipeline of the port: automatic masks, uniform masks, coverage
weights, pyramids.

The automatic pipeline (`dpst_tpu/segmentation.py`): PSPNet
(`models/pspnet.py`) segments the content and the style image into
ADE20K label maps on the device, the maps come back to the host as int32
numpy, `semantic_merge.merge_classes` aligns the two label sets there, and
`masks_from_labels` turns the merged maps into one-hot (K_max, H, W) mask
stacks, zero-padded to `max_classes`, on the device (so that the labels
cross to the card, and no mask stack does).

Each automatic call marks its two stages with spans (`utils/runtime.span`):
`dpst::segment` around both photos' PSPNet stage, up to the label maps on
the host, and `dpst::merge` around the merge and the mask stacks. It
leaves a `SegmentRecord` in `last_call` whether or not a profiler records:
the stages' host seconds, and the device ms of the PSPNet forwards
(`runtime.timer`), read after the labels' copy to the host has synced (so
the record adds no sync).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import semantic_merge
from .models import pspnet
from .ops.resize import mask_pyramid
from .utils import runtime
from .utils.runtime import params_on, resolve_device


@dataclasses.dataclass(frozen=True)
class SegmentRecord:
    """What the last automatic call (`automatic_masks` or
    `automatic_masks_batch`) did and took."""
    segment_s: float             # host s: PSPNet, to the labels on the host
    merge_s: float               # host s: the class merge and the masks
    forward_ms: float | None     # device ms of the forwards; None off CUDA
    forwards: int                # images through PSPNet, at eval_size²
    eval_size: int
    classes: int                 # merged classes (of a batch, its most)
    k: int                       # the class axis after padding


# The record of the last automatic call; None before the first
last_call: SegmentRecord | None = None


def _record(forwards: runtime.Timer, t0: float, t1: float, t2: float,
            classes: int, cfg) -> None:
    global last_call
    last_call = SegmentRecord(
        segment_s=t1 - t0, merge_s=t2 - t1, forward_ms=forwards.ms(),
        forwards=forwards.items, eval_size=pspnet.EVAL_SIZE,
        classes=classes, k=cfg.max_classes)


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
                      max_classes: int, device="cpu") -> torch.Tensor:
    """One-hot (K_max, H, W) float32 masks for `class_ids`, zero-padded,
    made on `device` from the labels.

    `class_ids` is the merged class list shared by content and style
    (`semantic_merge.merge_classes`); its order is the class axis."""
    if len(class_ids) > max_classes:
        raise ValueError(
            f"{len(class_ids)} merged classes > max_classes={max_classes}; "
            "raise StylizeConfig.max_classes")
    labels = torch.as_tensor(np.ascontiguousarray(labels)).to(device)
    ids = torch.as_tensor(class_ids, dtype=labels.dtype, device=labels.device)
    masks = torch.zeros((max_classes,) + labels.shape, dtype=torch.float32,
                        device=labels.device)
    masks[:len(class_ids)] = labels[None] == ids[:, None, None]
    return masks


def _merged_masks(seg_c: np.ndarray, seg_s: np.ndarray, cfg, device="cpu"):
    merged_c, merged_s, class_ids = semantic_merge.merge_classes(
        seg_c, seg_s, metric=cfg.similarity_metric,
        threshold=cfg.similarity_threshold, max_classes=cfg.max_classes)
    return (masks_from_labels(merged_c, class_ids, cfg.max_classes, device),
            masks_from_labels(merged_s, class_ids, cfg.max_classes, device),
            class_ids)


def automatic_masks(content: np.ndarray, style: np.ndarray, cfg,
                    params: dict | None = None, device=None
                    ) -> tuple[torch.Tensor, torch.Tensor, list[int]]:
    """The automatic pipeline for one pair: segment both on `device`, merge
    the label sets on the host -> aligned (K_max, H, W) float32 mask stacks
    for content and style, made on `device` as `stylize` takes them, and
    the merged class ids. Spans `segment` and `merge`; leaves its
    `last_call` record."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    with runtime.timer("pspnet") as forwards, runtime.span("segment"):
        seg_c, seg_s = segment_images(content, style, params,
                                      cfg.compute_dtype,
                                      protocol=cfg.seg_protocol,
                                      seg_scales=cfg.seg_scales, device=dev)
    t1 = time.perf_counter()
    with runtime.span("merge"):
        out = _merged_masks(seg_c, seg_s, cfg, dev)
    _record(forwards, t0, t1, time.perf_counter(), len(out[2]), cfg)
    return out


def automatic_masks_batch(contents: np.ndarray, style: np.ndarray, cfg,
                          params: dict | None = None, device=None):
    """`automatic_masks` for N content images sharing one style:
    (N, H, W, 3) + (H, W, 3) -> ((N, K, H, W), (N, K, H, W)) numpy. With the
    resize protocol the contents go through `pspnet.segment_batch` and the
    style is segmented once; the merge stays per pair. The sliding
    protocol's window geometry is per image, so it segments pair by pair.
    Spans `segment` and `merge`; leaves its `last_call` record."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    with runtime.timer("pspnet") as forwards, runtime.span("segment"):
        params = (pspnet.get_params(device=dev) if params is None
                  else params_on(params, dev))
        if cfg.seg_protocol != "resize":
            segs = [segment_images(c, style, params, cfg.compute_dtype,
                                   protocol=cfg.seg_protocol,
                                   seg_scales=cfg.seg_scales, device=dev)
                    for c in contents]
        else:
            seg_c_all = pspnet.segment_batch(
                params, torch.as_tensor(np.asarray(contents, np.float32)
                                        ).to(dev),
                cfg.compute_dtype).cpu().numpy()
            seg_s = pspnet.segment(
                params, torch.as_tensor(np.asarray(style, np.float32)
                                        ).to(dev),
                cfg.compute_dtype).cpu().numpy()
            segs = [(seg_c, seg_s) for seg_c in seg_c_all]
    t1 = time.perf_counter()
    with runtime.span("merge"):
        pairs = [_merged_masks(seg_c, seg_s, cfg) for seg_c, seg_s in segs]
        out = (torch.stack([p[0] for p in pairs]).numpy(),
               torch.stack([p[1] for p in pairs]).numpy())
    _record(forwards, t0, t1, time.perf_counter(),
            max(len(p[2]) for p in pairs), cfg)
    return out


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
