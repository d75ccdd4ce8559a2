"""Batched stylization: B image pairs as one batched Adam loop.

The port's counterpart of `dpst_tpu/parallel/batch.py` (BASELINE config 5:
many pairs in one call; the substrate of `autotune`'s Γ sweep). Where the
JAX package `vmap`s the per-pair pipeline, here every tensor of the loop
carries a leading pair axis: each VGG pass, loss term and kernel launch of
a step covers all B pairs, the hand-written kernels (`lap_matvec`,
`gram_fwd`, `gram_bwd`, `gram_relu_fwd`, `gram_relu_bwd`) taking the pair
as an index of their grid and the pool backward the pairs folded into its
channels. Pairs share no math: the objective is the sum of the pairs'
losses, whose gradient is each pair's own, and Adam is elementwise. A
step therefore launches each kernel as often as one pair's step does.

One device only: `mesh` (the JAX package's device mesh over the pairs) is
not ported yet (ROADMAP.md queue 1, item 15).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import optimize
from ..api import _carry_image, _prepare_stage, _scale_schedule, \
    prepare_constants
from ..config import StylizeConfig
from ..models import vgg
from ..utils.runtime import params_on, resolve_device


def resolve_config(cfg: StylizeConfig) -> StylizeConfig:
    """The config a batch runs, as `dpst_tpu/parallel/batch.py` (and, for
    its Γ sweep, `dpst_tpu/autotune.py`) resolves it on one device: no s2b
    strips (the pairs are already a batch), `s2d_gram` "auto" as "pallas"
    (the batched Gram kernel; in the port it sends the block-1 style taps
    to the fused bias+ReLU Gram pair from 2^18 pixels,
    `optimize.fused_block1_taps`), and `laplacian_impl="spmd"` as the XLA
    stencil (no row-sharded Laplacian under a batch; `autotune` refuses
    "spmd" before it resolves)."""
    if cfg.s2b_strips:
        cfg = dataclasses.replace(cfg, s2b_strips=0)
    if cfg.s2d_gram == "auto":
        cfg = dataclasses.replace(cfg, s2d_gram="pallas")
    if cfg.laplacian_impl == "spmd":
        cfg = dataclasses.replace(cfg, laplacian_impl="xla")
    return cfg


def prepare_batch(contents: torch.Tensor, styles: torch.Tensor,
                  cmasks: torch.Tensor, smasks: torch.Tensor,
                  vgg_params: dict, cfg: StylizeConfig
                  ) -> optimize.StylizeConstants:
    """The constants of B pairs ((B, H, W, 3) images, (B, K, H, W) masks)
    in one batched precompute: `StylizeConstants` with a leading B axis."""
    return prepare_constants(contents, styles, cmasks, smasks, cfg,
                             vgg_params)


def prepare_batch_stage(contents, styles, cmasks, smasks, vgg_params,
                        hw: tuple[int, int], cfg: StylizeConfig):
    """One multi-scale stage's batched precompute (`api._prepare_stage` on
    the batch): every pair resized to `hw` and its loop constants built.
    Returns (batched constants, stage contents (B, h, w, 3), style means
    (B, 1, 1, 3))."""
    return _prepare_stage(contents, styles, cmasks, smasks, vgg_params, hw,
                          cfg)


def _pair_weights(weights: optimize.LossWeights, b: int,
                  dev: torch.device) -> optimize.LossWeights:
    """Per-pair weights as (B,) fp32 tensors on `dev`."""
    out = []
    for w in weights:
        t = torch.as_tensor(np.asarray(w, np.float32)).to(dev)
        if t.shape != (b,):
            raise ValueError(f"per-pair weights must be ({b},), got "
                             f"{tuple(t.shape)}")
        out.append(t)
    return optimize.LossWeights(*out)


def run_batch(images: torch.Tensor, consts: optimize.StylizeConstants,
              weights: optimize.LossWeights, vgg_params: dict,
              cfg: StylizeConfig, n_steps: int,
              per_pair_weights: bool = False):
    """`n_steps` optimizer steps for every pair, from a fresh optimizer
    state. images: (B, H, W, 3); consts: batched constants; weights: a
    LossWeights of scalars (shared), or of (B,) values when
    `per_pair_weights` (the Γ sweep). Returns (images, history (B,
    n_steps, 5))."""
    if per_pair_weights:
        weights = _pair_weights(weights, images.shape[0], images.device)
    opt = optimize.make_optimizer(cfg)
    state = optimize.init_opt_state(opt, cfg, images)
    images, _, hist = optimize.run_segment(images, state, consts, weights,
                                           vgg_params, n_steps, cfg)
    return images, hist


def stylize_batch(contents, styles, cmasks, smasks,
                  cfg: StylizeConfig | None = None,
                  vgg_params: dict | None = None,
                  weights: optimize.LossWeights | None = None,
                  per_pair_weights: bool = False, mesh=None, device=None):
    """Stylize B image pairs in one batched loop.

    contents/styles: (B, H, W, 3) float [0, 255]; cmasks/smasks: (B, K, H,
    W) soft masks (`segmentation.uniform_masks` per pair for the unmasked
    case). `cfg.scales` runs `stylize`'s coarse-to-fine schedule, each
    stage with a batched precompute and the outputs upsampled between
    stages. `vgg_params` is the port's weight dict (`cfg.seed`'s He init
    when None); `weights` a LossWeights of scalars, or of (B,) values with
    `per_pair_weights`. The config is resolved as a batch runs
    (`resolve_config`). `mesh` must be None (the multi-GPU mesh is not
    ported yet). Runs on the CUDA card unless `device` names another.
    Returns (images (B, H, W, 3), history (B, total iterations, 5)) as
    float32 numpy arrays.
    """
    if mesh is not None:
        raise NotImplementedError(
            "not ported yet (see ROADMAP.md queue 1): a device mesh for "
            "the pairs (item 15: multi-GPU)")
    cfg = resolve_config(cfg or StylizeConfig())
    dev = resolve_device(device)
    if vgg_params is None:
        vgg_params = vgg.get_params(seed=cfg.seed, device=dev)
    vgg_params = vgg.pack_params(params_on(vgg_params, dev),
                                 cfg.compute_dtype, cfg.conv_impl)
    if weights is None:
        weights = optimize.LossWeights.from_config(cfg)
    batch = [torch.as_tensor(np.asarray(a, np.float32)).to(dev)
             for a in (contents, styles, cmasks, smasks)]
    if batch[0].dim() != 4 or batch[2].dim() != 4:
        raise ValueError("stylize_batch takes (B, H, W, 3) images and "
                         "(B, K, H, W) masks")
    images, hists = None, []
    for h, w, iters in _scale_schedule(cfg, tuple(batch[0].shape[1:3])):
        consts, contents_s, style_means = prepare_batch_stage(
            *batch, vgg_params, (h, w), cfg)
        images = (optimize.init_image(cfg, contents_s, style_means)
                  if images is None else _carry_image(images, (h, w)))
        images, hist = run_batch(images, consts, weights, vgg_params, cfg,
                                 iters, per_pair_weights)
        hists.append(hist)
    return images.cpu().numpy(), torch.cat(hists, dim=1).cpu().numpy()
