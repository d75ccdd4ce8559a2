"""Batched stylization: B image pairs as one batched Adam loop, over a
device mesh.

The port's counterpart of `dpst_tpu/parallel/batch.py` (BASELINE config 5:
many pairs in one call; the substrate of `autotune`'s Γ sweep). Where the
JAX package `vmap`s the per-pair pipeline, here every tensor of the loop
carries a leading pair axis: each VGG pass, loss term and kernel launch of
a step covers all B pairs, the hand-written kernels (`lap_matvec`,
`gram_fwd`, `gram_bwd`, `gram_relu_fwd`, `gram_relu_bwd`) taking the pair
as an index of their grid and the pool backward the pairs folded into its
channels; `gram_wbwd` and `conv3x3` (the "pallas" routes) take the pair
as a grid index too. Pairs share no math: the objective is the sum of the
pairs' losses, whose gradient is each pair's own, and Adam is
elementwise. A step therefore launches each kernel as often as one pair's
step does. L-BFGS runs the pairs in lockstep (`optim.lbfgs(pairs=True)`):
each pair has its own memory and zoom linesearch, and every round of the
searches is one batched evaluation of all B pairs with one sync.

Over a mesh (`parallel/mesh.py`) the pairs split over its batch axis:
each device (a group of row devices on a 2-D mesh) runs the batched loop
on its pairs, row-sharded over its row devices on a 2-D mesh
(`parallel/spatial.py`). The groups take their Adam steps in turns, so
that their devices overlap; L-BFGS yields nothing between steps, so the
groups of an L-BFGS batch run one after another, each one batched loop of
its pairs (row-sharded on a 2-D mesh).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import optimize
from ..api import _prepare_stage, _stage_loop, prepare_constants
from ..config import StylizeConfig
from ..models import vgg
from ..utils.runtime import resolve_device
from . import mesh as mesh_lib
from . import spatial
from .mesh import BATCH_AXIS, ROW_AXIS, Mesh


def resolve_config(cfg: StylizeConfig, n_devices: int = 1) -> StylizeConfig:
    """The config a batch runs, as `dpst_tpu/parallel/batch.py` (and, for
    its Γ sweep, `dpst_tpu/autotune.py`) resolves it: no s2b strips (the
    pairs are already a batch), `s2d_gram` "auto" as "pallas" (the batched
    Gram kernel; in the port it sends the block-1 style taps to the fused
    bias+ReLU Gram pair from 2^18 pixels, `optimize.fused_block1_taps`),
    then `spmd_safe` on a mesh of more than one device, and
    `laplacian_impl="spmd"` as the one-device matvec (the pairs' loops use
    no ambient mesh)."""
    if cfg.s2b_strips:
        cfg = dataclasses.replace(cfg, s2b_strips=0)
    if cfg.s2d_gram == "auto":
        cfg = dataclasses.replace(cfg, s2d_gram="pallas")
    if n_devices > 1:
        cfg = cfg.spmd_safe()
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


def batch_steps(images: torch.Tensor, consts: optimize.StylizeConstants,
                weights: optimize.LossWeights, vgg_params: dict,
                cfg: StylizeConfig, n_steps: int,
                per_pair_weights: bool = False):
    """`run_batch` as a generator that yields after each Adam step (L-BFGS
    runs its steps through without yielding); returns (images, history)."""
    if per_pair_weights:
        weights = _pair_weights(weights, images.shape[0], images.device)
    opt = optimize.make_optimizer(cfg)
    state = optimize.init_opt_state(opt, cfg, images)
    if cfg.optimizer == "adam":
        images, _, hist = yield from optimize.adam_segment(
            images, state, consts, weights, vgg_params, n_steps, cfg)
    else:
        images, _, hist = optimize.run_segment(
            images, state, consts, weights, vgg_params, n_steps, cfg)
    return images, hist


def run_batch(images: torch.Tensor, consts: optimize.StylizeConstants,
              weights: optimize.LossWeights, vgg_params: dict,
              cfg: StylizeConfig, n_steps: int,
              per_pair_weights: bool = False):
    """`n_steps` optimizer steps for every pair, from a fresh optimizer
    state. images: (B, H, W, 3); consts: batched constants; weights: a
    LossWeights of scalars (shared), or of (B,) values when
    `per_pair_weights` (the Γ sweep). Returns (images, history (B,
    n_steps, 5))."""
    return optimize.drain(batch_steps(images, consts, weights, vgg_params,
                                      cfg, n_steps, per_pair_weights))


def _device_stages(contents, styles, cmasks, smasks, cfg: StylizeConfig,
                   vgg_params: dict, weights: optimize.LossWeights):
    """Generator of one device's share of a batch through the whole
    schedule (inputs, packed weights and per-pair weights on that device):
    `api._stage_loop` with `batch_steps` a stage. Returns (images,
    history)."""
    return (yield from _stage_loop(
        contents, styles, cmasks, smasks, cfg, vgg_params,
        lambda images, consts, iters: batch_steps(
            images, consts, weights, vgg_params, cfg, iters)))


def stylize_batch(contents, styles, cmasks, smasks,
                  cfg: StylizeConfig | None = None,
                  vgg_params: dict | None = None,
                  weights: optimize.LossWeights | None = None,
                  per_pair_weights: bool = False, mesh: Mesh | None = None,
                  device=None):
    """Stylize B image pairs in one batched loop, split over a mesh.

    contents/styles: (B, H, W, 3) float [0, 255]; cmasks/smasks: (B, K, H,
    W) soft masks (`segmentation.uniform_masks` per pair for the unmasked
    case). `cfg.scales` runs `stylize`'s coarse-to-fine schedule, each
    stage with a batched precompute and the outputs upsampled between
    stages. `vgg_params` is the port's weight dict (`cfg.seed`'s He init
    when None); `weights` a LossWeights of scalars, or of (B,) values with
    `per_pair_weights` (split with the pairs).

    `mesh` (`parallel/mesh.py`): the pairs split over its batch axis, each
    device's share one batched loop; a 1-D mesh shrinks to the largest
    device count that divides B, a 2-D (pairs × rows) mesh raises
    ValueError unless its batch axis divides B and row-shards each share
    (`parallel/spatial.py`; its native-size stage, as `stylize_spatial`).
    None means `device` alone where given, else `make_mesh()`: every CUDA
    device. The config is resolved as a batch runs (`resolve_config`;
    `spmd_safe` on more than one device). Returns (images (B, H, W, 3),
    history (B, total iterations, 5)) as float32 numpy arrays, in pair
    order.
    """
    if mesh is None:
        mesh = (mesh_lib.make_mesh(devices=[resolve_device(device)])
                if device is not None else mesh_lib.make_mesh())
    batch = [torch.as_tensor(a, dtype=torch.float32)
             for a in (contents, styles, cmasks, smasks)]
    if batch[0].dim() != 4 or batch[2].dim() != 4:
        raise ValueError("stylize_batch takes (B, H, W, 3) images and "
                         "(B, K, H, W) masks")
    b = batch[0].shape[0]
    n_batch = mesh.shape[BATCH_AXIS]
    if b % n_batch:
        if mesh_lib.has_row_axis(mesh):
            raise ValueError(f"batch {b} does not divide the mesh's "
                             f"{n_batch}-way batch axis")
        n_batch = max(k for k in range(1, min(n_batch, b) + 1)
                      if b % k == 0)
        mesh = mesh_lib.make_mesh(n_batch, list(mesh.devices.flat))
    groups = mesh.devices.reshape(n_batch, -1)
    rows = mesh_lib.has_row_axis(mesh)
    cfg = resolve_config(cfg or StylizeConfig(), mesh.size)
    firsts = Mesh(groups[:, 0], (BATCH_AXIS,))
    if vgg_params is None:
        vgg_params = vgg.get_params(seed=cfg.seed, device=firsts.first)
    if weights is None:
        weights = optimize.LossWeights.from_config(cfg)
    split = None
    if per_pair_weights:
        split = mesh_lib.shard_batch(
            list(_pair_weights(weights, b, torch.device("cpu"))), firsts)
    shares = mesh_lib.shard_batch(batch, firsts)
    packed = vgg.params_by_device(vgg_params, groups[:, 0],
                                  cfg.compute_dtype, cfg.conv_impl)
    gens = []
    for i, group in enumerate(groups):
        share = [a[i] for a in shares]
        w_i = weights if split is None else optimize.LossWeights(
            *(w[i] for w in split))
        if rows:
            gens.append(spatial.spatial_stages(
                *share, cfg, packed[group[0]], Mesh(group, (ROW_AXIS,)),
                w_i))
        else:
            gens.append(_device_stages(*share, cfg, packed[group[0]], w_i))
    results = optimize.interleave(gens)
    return (torch.cat([r[0].cpu() for r in results]).numpy(),
            torch.cat([r[1].cpu() for r in results]).numpy())
