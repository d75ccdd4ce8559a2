"""NIMA-guided automatic style-weight (Γ) tuning.

The port's counterpart of `dpst_tpu/autotune.py` (paper §3.3 of
arXiv:1901.03915): the image-pair-dependent style weight Γ is chosen by
maximizing the NIMA aesthetic score of the stylization result.

Each stage's constants (content features, masked style Grams, mask
pyramid, Laplacian stats) are computed once per call; the candidates then
run one after another, each from a fresh optimizer state with Γ in place
of `LossWeights.style`, each carrying its own image between the stages of
a multi-scale schedule. One batched NIMA forward scores every result of a
round. Optional bracketing rounds re-sweep a narrowed log-range around the
incumbent. A candidate's image is what `stylize` returns for the sweep's
resolved config (`resolve_config`) with `style_weight` = Γ and
`post_smooth` = 0.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import optimize
from .api import _carry_image, _inputs, _prepare_stage, _scale_schedule
from .config import StylizeConfig
from .models import nima as nima_mod
from .utils.runtime import params_on, resolve_device

DEFAULT_GAMMAS = (1.0, 10.0, 100.0, 1000.0)


class TuneResult(NamedTuple):
    best_gamma: float
    best_image: np.ndarray
    gammas: np.ndarray          # every candidate evaluated, all rounds
    scores: np.ndarray          # NIMA score per candidate
    images: np.ndarray          # (N, H, W, 3) final images (last round)


def resolve_config(cfg: StylizeConfig) -> StylizeConfig:
    """The config the sweep runs, as `dpst_tpu/autotune.py` resolves it on
    one device: no s2b strips (the candidates are already a batch there),
    and `s2d_gram` "auto" as "pallas" (its batched Gram kernel). In the
    port the second sends the block-1 style taps to the fused bias+ReLU
    Gram kernels from 2^18 pixels (`optimize.fused_block1_taps`)."""
    if cfg.s2b_strips:
        cfg = dataclasses.replace(cfg, s2b_strips=0)
    if cfg.s2d_gram == "auto":
        cfg = dataclasses.replace(cfg, s2d_gram="pallas")
    return cfg


def autotune(content, style, config: StylizeConfig | None = None, *,
             size=None, gammas=None, rounds: int = 1,
             content_masks=None, style_masks=None,
             vgg_params=None, nima_params=None, seg_params=None,
             mesh=None, device=None) -> TuneResult:
    """Find the NIMA-optimal style weight Γ for one image pair.

    gammas: the initial candidate set (`DEFAULT_GAMMAS`); rounds > 1 adds
    bracketing re-sweeps of the same width in log-space, narrowed around
    the incumbent best. Masks, `vgg_params` and `seg_params` are as in
    `stylize`; `nima_params` is the port's NIMA dict (seeded with
    `cfg.seed` when None). `mesh` shards the candidates over devices in the
    JAX package; the port takes None only. Runs on the CUDA card unless
    `device` names another. Returns every (Γ, score) evaluated, the best
    stylization and the last round's images.
    """
    if mesh is not None:
        raise NotImplementedError(
            "not ported yet (see ROADMAP.md queue 1): a device mesh for "
            "the candidates (item 15: multi-GPU)")
    cfg = config or StylizeConfig()
    dev = resolve_device(device)
    content_full, style_full, cmask_full, smask_full, vgg_params = _inputs(
        content, style, cfg, size, content_masks, style_masks, vgg_params,
        seg_params, dev)
    nima_params = (nima_mod.get_params(seed=cfg.seed, device=dev)
                   if nima_params is None else params_on(nima_params, dev))
    base_weights = optimize.LossWeights.from_config(cfg)
    cfg = resolve_config(cfg)
    stages = [(_prepare_stage(content_full, style_full, cmask_full,
                              smask_full, vgg_params, (h, w), cfg), iters)
              for h, w, iters in _scale_schedule(
                  cfg, tuple(content_full.shape[:2]))]

    def run_candidate(gamma: float) -> torch.Tensor:
        weights = base_weights._replace(style=gamma)
        image = None
        for (consts, content_s, style_mean), iters in stages:
            if image is None:
                image = optimize.init_image(cfg, content_s, style_mean)
            else:
                image = _carry_image(image, tuple(content_s.shape[:2]))
            image, _ = optimize.run(image, consts, weights, vgg_params, cfg,
                                    iterations=iters)
        return torch.clamp(image, 0.0, 255.0)

    cand = np.asarray(gammas if gammas is not None else DEFAULT_GAMMAS,
                      np.float32)
    all_gammas, all_scores = [], []
    best_gamma, best_score, best_img, images = None, -np.inf, None, None
    for rnd in range(max(1, rounds)):
        imgs = torch.stack([run_candidate(float(g)) for g in cand])
        scores = nima_mod.nima_score(nima_params, imgs).cpu().numpy()
        all_gammas.append(cand)
        all_scores.append(scores)
        images = imgs.cpu().numpy()
        i_best = int(np.argmax(scores))
        if scores[i_best] > best_score:
            best_score = float(scores[i_best])
            best_gamma = float(cand[i_best])
            best_img = images[i_best]
        if rnd + 1 < rounds:
            # narrow the log-bracket around the incumbent
            lo = cand[max(0, i_best - 1)]
            hi = cand[min(len(cand) - 1, i_best + 1)]
            if lo == hi:
                lo, hi = lo * 0.5, hi * 2.0
            cand = np.logspace(np.log10(max(lo, 1e-6)),
                               np.log10(max(hi, 1e-6)),
                               num=len(cand), dtype=np.float32)

    return TuneResult(
        best_gamma=best_gamma, best_image=best_img,
        gammas=np.concatenate(all_gammas),
        scores=np.concatenate(all_scores), images=images)

