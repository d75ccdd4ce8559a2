"""NIMA-guided automatic style-weight (Γ) tuning.

The port's counterpart of `dpst_tpu/autotune.py` (paper §3.3 of
arXiv:1901.03915): the image-pair-dependent style weight Γ is chosen by
maximizing the NIMA aesthetic score of the stylization result.

Each stage's constants (content features, masked style Grams, mask
pyramid, Laplacian stats) are computed once per call; a round's candidates
then run as one batch (`parallel.batch.run_batch` with per-pair weights, Γ
in place of `LossWeights.style`), the pair's constants shared by every
candidate as views with a batch stride of 0 (`in_axes=None` in the JAX
package), each candidate from a fresh optimizer state and carrying its own
image between the stages of a multi-scale schedule. One batched NIMA
forward scores every result of a round. Optional bracketing rounds
re-sweep a narrowed log-range around the incumbent. Over a mesh the
candidates split over the largest number of its devices that divides
their count, each device's share one batch, the devices taking their
steps in turns (the JAX package shards the candidate axis). A candidate's
image is
the batch's image for its Γ; it equals what `stylize` returns for the
sweep's resolved config (`resolve_config`) with `style_weight` = Γ and
`post_smooth` = 0 up to the reductions that a batch takes in another
order than one pair (see `tests/test_torch_autotune.py`).
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
from .models import vgg
from .parallel import mesh as mesh_lib
from .parallel.batch import batch_steps, resolve_config
from .utils.runtime import params_on, resolve_device

DEFAULT_GAMMAS = (1.0, 10.0, 100.0, 1000.0)


class TuneResult(NamedTuple):
    best_gamma: float
    best_image: np.ndarray
    gammas: np.ndarray          # every candidate evaluated, all rounds
    scores: np.ndarray          # NIMA score per candidate
    images: np.ndarray          # (N, H, W, 3) final images (last round)


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
    `cfg.seed` when None). `mesh` (`parallel/mesh.py`): the candidates
    split over its first k devices, k the largest device count that
    divides their number; `s2d_gram` "auto" resolves to "pallas" where k
    is 1, else "nd", as in the JAX package. None means `device` alone
    where given, else `make_mesh()`: every CUDA device. The stages'
    constants, the NIMA scoring and the result are on the mesh's first
    device. Returns every (Γ, score) evaluated, the best stylization and
    the last round's images.
    """
    cfg = config or StylizeConfig()
    if mesh is None:
        mesh = (mesh_lib.make_mesh(devices=[resolve_device(device)])
                if device is not None else mesh_lib.make_mesh())
    dev = mesh.first
    content_full, style_full, cmask_full, smask_full, vgg_params = _inputs(
        content, style, cfg, size, content_masks, style_masks, vgg_params,
        seg_params, dev)
    nima_params = (nima_mod.get_params(seed=cfg.seed, device=dev)
                   if nima_params is None else params_on(nima_params, dev))
    base_weights = optimize.LossWeights.from_config(cfg)
    n_cand = len(gammas if gammas is not None else DEFAULT_GAMMAS)
    n_shard = max(k for k in range(1, min(mesh.size, n_cand) + 1)
                  if n_cand % k == 0)
    devs = list(mesh.devices.flat)[:n_shard]
    if cfg.s2d_gram == "auto":
        cfg = dataclasses.replace(
            cfg, s2d_gram="pallas" if n_shard == 1 else "nd")
    cfg = resolve_config(cfg)
    packed = vgg.params_by_device(vgg_params, devs, cfg.compute_dtype,
                                  cfg.conv_impl)
    stages = [(_prepare_stage(content_full, style_full, cmask_full,
                              smask_full, packed[dev], (h, w), cfg), iters)
              for h, w, iters in _scale_schedule(
                  cfg, tuple(content_full.shape[:2]))]

    def candidates(gammas: np.ndarray, d: torch.device):
        """Generator of the candidates `gammas` on device d through every
        stage as one batch; returns their final images (n, H, W, 3)."""
        n = len(gammas)
        weights = base_weights._replace(style=torch.from_numpy(gammas).to(d))
        images = None
        for (consts, content_s, style_mean), iters in stages:
            shared = consts.map(lambda t: t.to(d).expand(n, *t.shape))
            if images is None:
                images = optimize.init_image(
                    cfg, content_s.to(d), style_mean.to(d)
                ).expand(n, -1, -1, -1).clone()
            else:
                images = _carry_image(images, tuple(content_s.shape[:2]))
            images, _ = yield from batch_steps(images, shared, weights,
                                               packed[d], cfg, iters)
        return torch.clamp(images, 0.0, 255.0)

    def sweep(gammas: np.ndarray) -> torch.Tensor:
        """Every candidate of a round, their shares on their devices taking
        their steps in turns; the final images (N, H, W, 3) on dev."""
        gens = [candidates(g, d)
                for g, d in zip(np.split(gammas, n_shard), devs)]
        return torch.cat([im.to(dev) for im in optimize.interleave(gens)])

    cand = np.asarray(gammas if gammas is not None else DEFAULT_GAMMAS,
                      np.float32)
    all_gammas, all_scores = [], []
    best_gamma, best_score, best_img, images = None, -np.inf, None, None
    for rnd in range(max(1, rounds)):
        imgs = sweep(cand)
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

