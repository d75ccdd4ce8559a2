"""Public API of the port: `stylize(content, style, config=...) -> image`.

Stylization: load → masks (given; else automatic -- PSPNet on the
device, class merging on the host -- or uniform when segmentation is off) →
per scale of the schedule: resize to the stage size, precompute (content
features, masked style Grams, mask pyramid, coverage, Laplacian stats),
carry the image up from the stage before, optimize with Adam or L-BFGS
(checkpointed per stage where asked) → clip → the smooth-local-affine
post-process where asked → result. Entry points run on the CUDA card
unless the caller passes `device="cpu"`; with no card and no device given
they raise. With `laplacian_impl="spmd"` the photorealism term's matvec
splits its rows over the ambient mesh (`parallel.mesh.use_mesh`), and
raises ValueError outside one; the row-sharded loop as a whole is
`parallel.spatial.stylize_spatial`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from . import optimize, segmentation
from .config import StylizeConfig
from .models import vgg
from .ops import laplacian as lap
from .ops import losses as losses_mod
from .ops.guided_filter import smooth_local_affine
from .ops.laplacian_cuda import pack_stats
from .ops.resize import resize_image
from .utils import io, runtime
from .utils.checkpoint import RunCheckpointer
from .utils.runtime import params_on, resolve_device


@torch.no_grad()
def prepare_constants(content: torch.Tensor, style: torch.Tensor,
                      content_masks: torch.Tensor, style_masks: torch.Tensor,
                      cfg: StylizeConfig, vgg_params: dict
                      ) -> optimize.StylizeConstants:
    """Everything the optimizer loop consumes, computed once: content
    features, per-class masked style Grams (on the fused route whatever
    `gram_impl` says, as the JAX package computes them), the content mask
    pyramid, coverage weights and the packed matting-Laplacian stats.
    Tensors are used on their own device. A batch of B pairs ((B, H, W, 3)
    images, (B, K, H, W) masks) gives batched constants, its VGG passes
    and Grams once for all pairs."""
    content = content.to(torch.float32)
    style = style.to(torch.float32)
    content_feats = vgg.extract_features(
        vgg_params, content, cfg.content_layers, pooling=cfg.pooling,
        compute_dtype=cfg.compute_dtype, conv_impl=cfg.conv_impl)
    style_feats = vgg.extract_features(
        vgg_params, style, cfg.style_layers, pooling=cfg.pooling,
        compute_dtype=cfg.compute_dtype, conv_impl=cfg.conv_impl)
    smask_pyr = segmentation.layer_masks(
        style_masks, cfg.style_layers, cfg.mask_downsample)
    gram_norm = "m1" if cfg.style_norm == "paper" else "m2"
    style_grams = {
        layer: losses_mod.masked_grams(
            style_feats[layer], smask_pyr[layer],
            compute_dtype=cfg.compute_dtype, norm=gram_norm)
        for layer in cfg.style_layers}
    cmask_pyr = segmentation.layer_masks(
        content_masks, cfg.style_layers, cfg.mask_downsample)
    coverage = segmentation.coverage_weights(content_masks)
    lap_stats = None
    if cfg.use_photorealism:
        stats = lambda c: pack_stats(lap.precompute_stats(
            c * (1.0 / 255.0), eps=cfg.matting_epsilon))
        lap_stats = (stats(content) if content.dim() == 3
                     else torch.stack([stats(c) for c in content]))
    return optimize.StylizeConstants(
        content_feats=content_feats, style_grams=style_grams,
        masks=cmask_pyr, coverage=coverage, lap_stats=lap_stats)


def _prepare_stage(content: torch.Tensor, style: torch.Tensor,
                   cmasks: torch.Tensor, smasks: torch.Tensor,
                   vgg_params: dict, hw: tuple[int, int],
                   cfg: StylizeConfig):
    """One stage of the schedule: resize the full-resolution images and
    masks to `hw` (only where the size differs; masks clipped to [0, 1])
    and precompute the stage's constants. Returns (constants, the stage's
    content image, the style image's (1, 1, 3) mean); of a batch, batched
    constants, (B, h, w, 3) contents and (B, 1, 1, 3) means. The span
    `precompute`."""
    with runtime.span("precompute"):
        if tuple(content.shape[-3:-1]) != tuple(hw):
            content = resize_image(content, hw)
            style = resize_image(style, hw)
            cmasks = torch.clamp(
                resize_image(cmasks[..., None], hw)[..., 0], 0.0, 1.0)
            smasks = torch.clamp(
                resize_image(smasks[..., None], hw)[..., 0], 0.0, 1.0)
        consts = prepare_constants(content, style, cmasks, smasks, cfg,
                                   vgg_params)
        style_mean = torch.mean(style, dim=(-3, -2), keepdim=True)
        return consts, content, style_mean


def _carry_image(image: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Upsample the running output (or a batch's) to the next stage's
    size."""
    return torch.clamp(resize_image(image, hw), 0.0, 255.0)


def _fit_masks(masks: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Resize a (K, H, W) mask stack to the working resolution if needed."""
    if masks.shape[1:] == tuple(hw):
        return masks
    resized = resize_image(torch.from_numpy(masks)[..., None], hw)[..., 0]
    return torch.clamp(resized, 0.0, 1.0).numpy()


def _scale_schedule(cfg: StylizeConfig, hw: tuple[int, int]
                    ) -> list[tuple[int, int, int]]:
    """[(H, W, iters)] per stage; no `scales` means one stage at the native
    size. No stage exceeds the native size (larger scales clamp to it),
    stages are multiples of 8 pixels, consecutive stages of one size merge
    (their iterations summed), and the last stage is always the native
    size, so the output has the requested shape."""
    if not cfg.scales:
        return [(hw[0], hw[1], cfg.iterations)]
    stages: list[tuple[int, int, int]] = []
    n = len(cfg.scales)
    for i, s in enumerate(cfg.scales):
        scale = min(1.0, s / max(hw))
        if scale == 1.0:
            h, w = hw
        else:
            h = max(8, int(round(hw[0] * scale / 8.0)) * 8)
            w = max(8, int(round(hw[1] * scale / 8.0)) * 8)
        if cfg.scale_iters:
            iters = cfg.scale_iters[i]
        else:
            iters = max(1, int(round(
                cfg.iterations * cfg.scale_iter_factor ** (n - 1 - i))))
        if stages and stages[-1][:2] == (h, w):
            stages[-1] = (h, w, stages[-1][2] + iters)
        else:
            stages.append((h, w, iters))
    if stages[-1][:2] != tuple(hw):
        stages.append((hw[0], hw[1], cfg.iterations))
    return stages


def _stage_loop(contents, styles, cmasks, smasks, cfg: StylizeConfig,
                vgg_params: dict, segment, last_segment=None):
    """Generator of a run through `cfg`'s schedule (`_scale_schedule`) of
    one image or a batch: each stage's precompute (`_prepare_stage`), the
    image started (`optimize.init_image`) or carried up (`_carry_image`),
    then `segment(images, consts, iters)`, a generator that returns
    (images, history); the native-size stage takes `last_segment` where
    given. Returns (images, the stages' histories joined on their step
    axis)."""
    images, hists = None, []
    stages = _scale_schedule(cfg, tuple(contents.shape[-3:-1]))
    for i, (h, w, iters) in enumerate(stages):
        consts, contents_s, style_means = _prepare_stage(
            contents, styles, cmasks, smasks, vgg_params, (h, w), cfg)
        images = (optimize.init_image(cfg, contents_s, style_means)
                  if images is None else _carry_image(images, (h, w)))
        run = (last_segment if last_segment is not None
               and i + 1 == len(stages) else segment)
        images, hist = yield from run(images, consts, iters)
        hists.append(hist)
    return images, torch.cat(hists, dim=-2)


def _inputs(content, style, cfg: StylizeConfig, size, content_masks,
            style_masks, vgg_params, seg_params, dev: torch.device):
    """What `stylize` and `autotune` start from, on `dev`: the content image
    at `size` and the style image at its size ((H, W, 3) fp32), their
    (K, H, W) masks (given and fitted to the images, automatic, or
    uniform), and the VGG weights packed for `cfg`."""
    if (content_masks is None) != (style_masks is None):
        raise ValueError(
            "content_masks and style_masks must be provided together "
            "(their class channels must be aligned); got only "
            + ("content_masks" if style_masks is None else "style_masks"))
    content_np = io.load_image(content, size)
    hw = content_np.shape[:2]
    style_np = io.load_image(style, hw)
    if content_masks is None and cfg.use_segmentation:
        # at the images' sizes, made on `dev` from the merged labels
        cmasks, smasks, _ = segmentation.automatic_masks(
            content_np, style_np, cfg, seg_params, device=dev)
    else:
        if content_masks is None:
            content_masks = segmentation.uniform_masks(hw)
            style_masks = segmentation.uniform_masks(style_np.shape[:2])
        cmasks = torch.from_numpy(_fit_masks(
            np.asarray(content_masks, np.float32), hw)).to(dev)
        smasks = torch.from_numpy(_fit_masks(
            np.asarray(style_masks, np.float32), style_np.shape[:2])).to(dev)
    if vgg_params is None:
        vgg_params = vgg.get_params(seed=cfg.seed, device=dev)
    vgg_params = vgg.pack_params(params_on(vgg_params, dev),
                                 cfg.compute_dtype, cfg.conv_impl)
    return (torch.from_numpy(content_np).to(dev),
            torch.from_numpy(style_np).to(dev), cmasks, smasks, vgg_params)


def stylize(content, style, config: StylizeConfig | None = None, *,
            size: int | tuple[int, int] | None = None,
            content_masks: np.ndarray | None = None,
            style_masks: np.ndarray | None = None,
            vgg_params: dict | None = None,
            seg_params: dict | None = None,
            callback: Callable | None = None,
            resume: bool = False,
            return_history: bool = False,
            device=None):
    """Stylize `content` with the style of `style` (paths or HWC arrays).

    `content_masks`/`style_masks` (K, H, W) give the aligned class masks;
    without them `use_segmentation=True` builds them
    (`segmentation.automatic_masks`: PSPNet with `seg_params`, the port's
    PSPNet dict, or its seed-0 weights; `max_classes` one-hot masks) and
    `use_segmentation=False` runs one uniform class. `vgg_params` is the
    port's weight dict (`models.vgg.params_from_numpy` converts the JAX
    package's); the call packs it once for its kernels
    (`models.vgg.pack_params`). `cfg.scales` runs a coarse-to-fine
    schedule (`_scale_schedule`), each stage with a fresh optimizer state.
    `callback(step, image, history_chunk)` fires every
    `cfg.intermediate_interval` steps, `step` counted across all stages.
    With `cfg.checkpoint_dir`, each stage checkpoints its image and
    optimizer state at that cadence (in `stage{i}_{h}x{w}` when there is
    more than one stage), and `resume=True` continues from the latest
    checkpoints. `cfg.post_smooth > 0` applies `smooth_local_affine` after
    the last stage; `cfg.profile_dir` traces the call with torch.profiler;
    `cfg.debug_nans` raises FloatingPointError at the first non-finite
    loss or gradient. Returns a float32 [0,255] RGB (H, W, 3) np.ndarray
    (and the (iters, 5) loss history of the steps run -- [total, content,
    style, photoreal, tv] per step -- if `return_history`). `device=None`
    runs on the CUDA card.
    """
    cfg = config or StylizeConfig()
    if cfg.profile_dir:
        with runtime.maybe_profile(cfg.profile_dir):
            return stylize(
                content, style, dataclasses.replace(cfg, profile_dir=""),
                size=size, content_masks=content_masks,
                style_masks=style_masks, vgg_params=vgg_params,
                seg_params=seg_params, callback=callback, resume=resume,
                return_history=return_history, device=device)
    dev = resolve_device(device)
    content_full, style_full, cmask_full, smask_full, vgg_params = _inputs(
        content, style, cfg, size, content_masks, style_masks, vgg_params,
        seg_params, dev)
    hw = tuple(content_full.shape[:2])
    weights = optimize.LossWeights.from_config(cfg)

    image = None
    histories = []
    stages = _scale_schedule(cfg, hw)
    steps_before = 0
    for stage_i, (h, w, iters) in enumerate(stages):
        stage_ckpt = None
        if cfg.checkpoint_dir:
            # optimizer states differ in shape across scales: one directory
            # a stage, the flat directory for a single stage
            stage_ckpt = RunCheckpointer(
                cfg.checkpoint_dir if len(stages) == 1 else os.path.join(
                    cfg.checkpoint_dir, f"stage{stage_i}_{h}x{w}"))
        consts, content_s, style_mean = _prepare_stage(
            content_full, style_full, cmask_full, smask_full, vgg_params,
            (h, w), cfg)
        if image is None:
            image = optimize.init_image(cfg, content_s, style_mean)
        else:
            image = _carry_image(image, (h, w))
        stage_cb = None
        if callback is not None:
            stage_cb = (lambda step, img, hist, _off=steps_before:
                        callback(_off + step, img, hist))
        image, hist = optimize.run(image, consts, weights, vgg_params, cfg,
                                   iterations=iters, callback=stage_cb,
                                   checkpointer=stage_ckpt, resume=resume)
        histories.append(hist)
        steps_before += iters
    image = torch.clamp(image, 0.0, 255.0)
    if cfg.post_smooth > 0:
        # content_s is the last stage's: the output resolution
        image = smooth_local_affine(content_s, image, radius=cfg.post_smooth,
                                    eps=cfg.post_smooth_eps)
    result = image.cpu().numpy()
    if return_history:
        return result, torch.cat(histories).cpu().numpy()
    return result
