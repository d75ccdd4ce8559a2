"""Image optimization loop (the hot path): loss, optimizer, history.

The port's counterpart of `dpst_tpu/optimize.py` (one scale; the
multi-scale schedule is `api.stylize`'s). PyTorch runs eagerly. An Adam
step is one VGG forward and input gradient, the content, masked-Gram
style, photorealism and TV terms, one Adam update and the [0, 255] clip;
its loss history stays on the device and reaches the host once per
segment. An L-BFGS step (`optim.lbfgs`, optax's algorithm) runs in logit
space where `clip_pixels`, evaluates the same objective once or more in
its zoom linesearch, and syncs once an evaluation.

The loop also takes a batch of B pairs (`parallel/batch.py`): an image
(B, H, W, 3) with batched constants (`StylizeConstants` with a leading
axis on every tensor). Each VGG pass, loss term and kernel launch of an
Adam step then covers all B pairs; the objective is the sum of the pairs'
losses (they share no math, so its gradient is each pair's own), Adam and
the clip are elementwise with bias corrections shared (every pair is at
the same step), and the history is (B, n, 5). L-BFGS runs the pairs as
the JAX package's vmapped optax does: each pair with its own memory and
zoom linesearch (on the host), the searches in lockstep, every round one
batched evaluation of all B pairs and one sync (`optim.lbfgs(pairs=
True)`); one image runs as a batch of one. The L-BFGS loop
(`lbfgs_steps`) takes any objective of a batch, whose parameter may be
the row shards (`parallel/spatial.py`; `optim` then works shard by
shard).
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import optim
from .config import StylizeConfig
from .models import vgg
from .ops import block12_pallas as b12
from .ops import laplacian as lap
from .ops import laplacian_spmd, losses
from .ops.gram_stream import normalize
from .utils import runtime

HISTORY_TERMS = ("total", "content", "style", "photoreal", "tv")


class LossWeights(NamedTuple):
    """The four term weights: Python floats, or (B,) fp32 tensors on the
    loop's device, one weight a pair of a batch (the Γ sweep's
    `per_pair_weights`)."""
    content: float
    style: float
    reg: float
    tv: float

    @staticmethod
    def from_config(cfg: StylizeConfig) -> "LossWeights":
        return LossWeights(float(np.float32(cfg.content_weight)),
                           float(np.float32(cfg.style_weight)),
                           float(np.float32(cfg.regularization_weight)),
                           float(np.float32(cfg.tv_weight)))


class StylizeConstants(NamedTuple):
    """Per-run precomputed device constants (of a batch: every tensor with
    a leading B axis)."""
    content_feats: dict      # {layer: (C, h, w)} in the compute dtype
    style_grams: dict        # {layer: (K, C, C)} fp32
    masks: dict              # {layer: (K, h_l, w_l)} content-side masks
    coverage: torch.Tensor   # (K,)
    lap_stats: torch.Tensor | None  # (14, H, W) packed stats, or None

    def map(self, fn) -> "StylizeConstants":
        """The constants with `fn` applied to every tensor."""
        return StylizeConstants(
            content_feats={k: fn(v) for k, v in self.content_feats.items()},
            style_grams={k: fn(v) for k, v in self.style_grams.items()},
            masks={k: fn(v) for k, v in self.masks.items()},
            coverage=fn(self.coverage),
            lap_stats=None if self.lap_stats is None else fn(self.lap_stats))


# Routing of the block-1 style taps, as the JAX package routes them on a
# TPU (dpst_tpu/optimize.py:_s2d_gram_kernel and :_block1_s2d_ok, with the
# TPU branches of the resolvers they call): where the TPU takes the
# space-to-depth block 1 with its streamed Gram kernel (gram_s2d), the port
# takes its fused bias+ReLU Gram kernels (ops/gram_s2d.py); everywhere else
# (the TPU's nd consumption, or its direct convs) the unfused route, ReLU
# then the masked Gram kernels.

def _resolve_block1(block1_impl: str, h: int, w: int) -> bool:
    """dpst_tpu/models/vgg.py:_resolve_block1 on a TPU: space-to-depth
    block 1 when asked, or by default from 2^18 pixels."""
    return block1_impl == "s2d" or (block1_impl == "auto"
                                    and h * w >= 2 ** 18)


def _s2b_active(s2b_strips: int, h: int, w: int, layers) -> bool:
    """dpst_tpu/models/vgg.py:s2b_active on a TPU: would the strip
    decomposition of blocks 1-2 run?"""
    n = s2b_strips
    if n == -1:
        n = 0 if h % 64 or h * w < 512 * 512 else h // 64
    if n <= 1 or h % n:
        return False
    hs = h // n
    return (hs % 4 == 0 and hs >= 4 * vgg.S2B_HALO
            and max(vgg.LAYER_ORDER.index(l) for l in layers)
            > vgg.LAYER_ORDER.index("pool2"))


def _s2d_gram_kernel(cfg: StylizeConfig, h: int, w: int, k: int) -> bool:
    """Does `s2d_gram` select the Gram kernel of the block-1 taps at an
    h × w image with k classes? "pallas", "pallas1" and "pallas2" always
    (v1 and v2 compute one function, which the fused kernels serve); "auto"
    from 2^19 pixels, or where the conv1_1 Gram is not fused-routed; "nd"
    never."""
    if cfg.s2d_gram in ("pallas", "pallas1", "pallas2"):
        return True
    if cfg.s2d_gram == "auto":
        if h * w >= 2 ** 19:
            return True
        c = vgg.VGG19_BLOCKS[0][1]
        return losses.gram_route(h, w, k, c, cfg.gram_impl) != "fused"
    return False


def _block1_s2d_ok(cfg: StylizeConfig, image_shape, all_layers,
                   b1_layers, mask_shapes: dict) -> bool:
    """Would a TPU take the space-to-depth block 1 for these taps? Only if
    `block1_impl` resolves to it, h and w are even, the strips (if any)
    feed their Grams in flat form, and every block-1 tap is style-only with
    a Gram the s2d tap can feed (fused-routed, or the Gram kernel's)."""
    h, w = image_shape[:2]
    if not _resolve_block1(cfg.block1_impl, h, w) or h % 2 or w % 2:
        return False
    if (_s2b_active(cfg.s2b_strips, h, w, all_layers)
            and cfg.strip_gram == "interior"):
        return False
    for l in b1_layers:
        if l not in cfg.style_layers or l in cfg.content_layers:
            return False
        k, hl, wl = mask_shapes[l]
        c = vgg.VGG19_BLOCKS[0][1]
        if (losses.gram_route(hl, wl, k, c, cfg.gram_impl) != "fused"
                and not _s2d_gram_kernel(cfg, h, w, k)):
            return False
    return True


_POOL2 = vgg.LAYER_ORDER.index("pool2")


def _block12_layers(cfg: StylizeConfig) -> tuple[tuple, tuple, tuple]:
    """(all taps, the taps of blocks 1-2, the taps past pool2), in the
    order of style_layers + content_layers."""
    all_layers = tuple(dict.fromkeys(cfg.style_layers + cfg.content_layers))
    b12 = tuple(l for l in all_layers if vgg.LAYER_ORDER.index(l) < _POOL2)
    return all_layers, b12, tuple(l for l in all_layers if l not in b12)


def block12_route(cfg: StylizeConfig, image_shape) -> str:
    """How blocks 1-2 run at an (H, W, 3) image, as `dpst_tpu/optimize.py:
    make_loss_fn` decides on a TPU (`vgg.stream12_strips`'s TPU branch).
    The route streams where `stream12` resolves to strips that
    `stream12_compatible` takes and every block-1/2 tap is a style tap and
    no content tap; then "kernel" where `stream12_impl="pallas"`, the
    block-1/2 taps are exactly (conv1_1, conv2_1), w % 256 == 0 and
    h % 32 == 0 (the fused kernels, `ops/block12_pallas.py`), else
    "stream-standard" (the TPU's strip scan, a memory lowering the port
    does not carry: the standard path, its block-1/2 Grams on the fused
    route). Otherwise "standard"."""
    all_layers, b12_layers, _ = _block12_layers(cfg)
    h, w = image_shape[:2]
    strips = vgg.stream12_strips(cfg.stream12, h, w)
    if not (vgg.stream12_compatible(all_layers, strips, tuple(image_shape))
            and all(l in cfg.style_layers and l not in cfg.content_layers
                    for l in b12_layers)):
        return "standard"
    if (cfg.stream12_impl == "pallas"
            and b12_layers == ("conv1_1", "conv2_1")
            and w % 256 == 0 and h % 32 == 0):
        return "kernel"
    return "stream-standard"


def fused_block1_taps(cfg: StylizeConfig, image_shape,
                      masks: dict) -> tuple[str, ...]:
    """The block-1 style taps that take the fused bias+ReLU Gram kernels
    at this image size: all of them where a TPU would feed them to its
    s2d Gram kernel, else none (and none where blocks 1-2 stream)."""
    if block12_route(cfg, image_shape) != "standard":
        return ()
    all_layers = tuple(dict.fromkeys(cfg.style_layers + cfg.content_layers))
    b1_layers = tuple(l for l in all_layers if l in ("conv1_1", "conv1_2"))
    if not b1_layers:
        return ()
    mask_shapes = {l: tuple(masks[l].shape) for l in b1_layers
                   if l in masks}
    if not _block1_s2d_ok(cfg, image_shape, all_layers, b1_layers,
                          mask_shapes):
        return ()
    h, w = image_shape[:2]
    if not _s2d_gram_kernel(cfg, h, w, mask_shapes[b1_layers[0]][0]):
        return ()
    return b1_layers


def make_loss_fn(cfg: StylizeConfig) -> Callable[..., tuple]:
    """Build loss(image, consts, weights, vgg_params) -> (total, terms),
    with image (H, W, 3) in [0, 255] and terms the (5,) history row
    [total, content, style, photoreal, tv]; for a batch, image (B, H, W, 3)
    with batched constants, total the sum of the pairs' totals and terms
    (B, 5). One pair runs as a batch of one. Blocks 1-2 take
    `block12_route`'s route, decided on one pair's shapes. With
    `laplacian_impl="spmd"` the photorealism term's matvec splits its rows
    over the ambient mesh (`ops/laplacian_spmd.AmbientMatvec`). The VGG
    forward is the span `features`, the terms and the total `loss`."""
    style_lw = dict(zip(cfg.style_layers, cfg.style_layer_weights))
    all_layers, b12_layers, deep_layers = _block12_layers(cfg)
    norm = "m1" if cfg.style_norm == "paper" else "m2"
    matvec = (laplacian_spmd.AmbientMatvec()
              if cfg.laplacian_impl == "spmd" else None)

    def features(image, consts, vgg_params):
        """(batched taps, normalized Grams of the layers that need no
        tap)."""
        vgg_params = vgg.pack_params(vgg_params, cfg.compute_dtype,
                                     cfg.conv_impl)
        route = block12_route(cfg, image.shape[1:])
        if route != "kernel":
            one_masks = {l: m[0] for l, m in consts.masks.items()}
            feats = vgg.extract_features(
                vgg_params, image, all_layers, pooling=cfg.pooling,
                compute_dtype=cfg.compute_dtype, conv_impl=cfg.conv_impl,
                raw_taps=fused_block1_taps(cfg, image.shape[1:], one_masks))
            if route == "standard":
                return feats, {}
            # the strip scan forms its block-1/2 Grams weighted before the
            # product (the fused route), whatever gram_impl says at full size
            return feats, {l: losses.masked_grams(
                feats[l], consts.masks[l], compute_dtype=cfg.compute_dtype,
                norm=norm) for l in b12_layers}
        # every pair of the batch in one launch of each block12 entry
        # point, as the reference's vmap runs its kernels
        op = b12.make_block12_fused(pooling=cfg.pooling,
                                    compute_dtype=cfg.compute_dtype)
        m1 = consts.masks["conv1_1"].to(torch.float32)
        m2 = consts.masks["conv2_1"].to(torch.float32)
        g1, g2, p2 = op(vgg.preprocess_noflip(image), m1 * m1, m2 * m2,
                        vgg_params.block12)
        feats = vgg.extract_tail(
            vgg_params, p2, deep_layers, pooling=cfg.pooling,
            compute_dtype=cfg.compute_dtype, conv_impl=cfg.conv_impl)
        return feats, {"conv1_1": normalize(g1, m1, norm),
                       "conv2_1": normalize(g2, m2, norm)}

    def batch_loss(image: torch.Tensor, consts: StylizeConstants,
                   weights: LossWeights, vgg_params: dict):
        with runtime.span("features"):
            feats, g_out = features(image, consts, vgg_params)
        with runtime.span("loss"):
            zero = torch.zeros(image.shape[:1], dtype=torch.float32,
                               device=image.device)
            l_content = zero
            for layer in cfg.content_layers:
                l_content = l_content + losses.content_loss(
                    feats[layer], consts.content_feats[layer])
            l_style = losses.style_loss(
                feats, consts.style_grams, consts.masks, consts.coverage,
                style_lw, compute_dtype=cfg.compute_dtype,
                style_norm=cfg.style_norm, gram_impl=cfg.gram_impl,
                g_out=g_out)
            l_reg = (lap.photoreal_loss(consts.lap_stats, image, matvec)
                     if consts.lap_stats is not None else zero)
            l_tv = losses.tv_loss(image) if cfg.tv_weight else zero
            total = (weights.content * l_content + weights.style * l_style
                     + weights.reg * l_reg + weights.tv * l_tv)
            terms = torch.stack([total, l_content, l_style, l_reg, l_tv], -1)
            return torch.sum(total), terms

    def loss_fn(image: torch.Tensor, consts: StylizeConstants,
                weights: LossWeights, vgg_params: dict):
        if image.dim() == 4:
            return batch_loss(image, consts, weights, vgg_params)
        total, terms = batch_loss(image[None], consts.map(lambda t: t[None]),
                                  weights, vgg_params)
        return total, terms[0]

    return loss_fn


class AdamState(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor
    count: int


class Adam:
    """Adam as optax.adam computes it, in optax's form (`init(params) ->
    AdamState`, `update(grad, state) -> (updates, state)`): μ and ν moving
    averages, bias corrections 1 − b^t in fp32, eps outside the square
    root, the update −lr·μ̂/(√ν̂ + eps)."""

    def __init__(self, cfg: StylizeConfig):
        self.lr = cfg.learning_rate
        self.b1, self.b2, self.eps = cfg.adam_b1, cfg.adam_b2, cfg.adam_eps

    def init(self, params: torch.Tensor) -> AdamState:
        return AdamState(torch.zeros_like(params), torch.zeros_like(params),
                         0)

    @torch.no_grad()
    def update(self, grad: torch.Tensor, state: AdamState
               ) -> tuple[torch.Tensor, AdamState]:
        mu = (1 - self.b1) * grad + self.b1 * state.mu
        nu = (1 - self.b2) * (grad * grad) + self.b2 * state.nu
        count = state.count + 1
        bc1 = np.float32(1) - np.float32(self.b1) ** np.float32(count)
        bc2 = np.float32(1) - np.float32(self.b2) ** np.float32(count)
        mu_hat = mu / float(bc1)
        nu_hat = nu / float(bc2)
        update = -self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        return update, AdamState(mu, nu, count)


def make_optimizer(cfg: StylizeConfig):
    """`dpst_tpu/optimize.py:make_optimizer`: Adam, or `optax.lbfgs()`
    (memory 10, the zoom linesearch of at most 20 evaluations) of a batch
    of pairs, as `jax.vmap` runs it (`optim.lbfgs(pairs=True)`; one pair
    runs as a batch of one)."""
    if cfg.optimizer == "adam":
        return Adam(cfg)
    return optim.lbfgs(pairs=True)


# --- L-BFGS pixel parameterization ---------------------------------------
# L-BFGS's curvature pairs and Wolfe linesearch do not survive a clip after
# every step, so with clip_pixels it optimizes a logit image u, pixels =
# 255·sigmoid(u), a smooth bijection onto (0, 255).
_LOGIT_EPS = 1e-4


def _to_logits(image: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(lap.exact_div(image.to(torch.float32), 255.0),
                    _LOGIT_EPS, 1.0 - _LOGIT_EPS)
    return torch.log(p) - torch.log1p(-p)


def pixels_to_logits(image: optim.Vector) -> optim.Vector:
    """The logit image of an image (or of each of its row shards)."""
    return optim.tree_map(_to_logits, image)


def logits_to_pixels(u: optim.Vector) -> optim.Vector:
    return optim.tree_map(lambda x: 255.0 * torch.sigmoid(x), u)


def init_opt_state(opt, cfg: StylizeConfig, image0: optim.Vector):
    """Optimizer state for `image0` (an image, a batch (B, H, W, 3), or the
    list of a batch's row shards): L-BFGS's of one image that of a batch of
    one, in logit space when boxed (the state keeps the parameters it last
    stepped from)."""
    if cfg.optimizer == "adam":
        return opt.init(image0)
    if isinstance(image0, torch.Tensor) and image0.dim() == 3:
        image0 = image0[None]
    return opt.init(pixels_to_logits(image0) if cfg.clip_pixels else image0)


def history_terms(cfg: StylizeConfig) -> str:
    """`StylizeConfig.loop_config`'s resolution (`dpst_tpu/config.py:
    256-258`): Adam records "full" (its terms come with the step); L-BFGS
    "total" under "auto" (column 0 the linesearch's cached value, columns
    1-4 zeros, no extra forward), else as asked."""
    if cfg.optimizer == "adam":
        return "full"
    return "total" if cfg.history_terms == "auto" else cfg.history_terms


# Lists that `record_evaluations` hands out; every L-BFGS step appends its
# record to each.
_EVALUATION_RECORDS: list[list] = []


@contextlib.contextmanager
def record_evaluations():
    """Collect one dict per L-BFGS step run inside the block, in order:
    `evaluations` (objective evaluations the step made: its linesearch's,
    plus one where `value_and_grad_from_state` found no finite cached
    value), `num_linesearch_steps`, `decrease_error` and `curvature_error`
    (optax's ZoomLinesearchInfo; either error positive: the search failed
    and took the safe step), `value_finite` (the value the search leaves
    for the next step is finite, so that step evaluates nothing afresh)
    and `trace` (each search evaluation in order: its stepsize, the rule
    that proposed it — "interval", or the zoom's "cubic", "quadratic" or
    "bisection" — the value and slope found there, the errors and the
    verdict). Of a batch's step: `evaluations` the batched evaluations it
    ran (the most any pair's search took, plus one where a cached value
    was not finite), `num_linesearch_steps` and the errors the largest
    over the pairs, `value_finite` whether every pair's is, and `pairs`,
    each pair's own record (its evaluations, search and trace)."""
    log: list = []
    _EVALUATION_RECORDS.append(log)
    try:
        yield log
    finally:
        _EVALUATION_RECORDS.remove(log)


def _record(rec: dict) -> None:
    for log in _EVALUATION_RECORDS:
        log.append(rec)


def _lbfgs_step(cfg: StylizeConfig, loss, opt, first_step: int = 0):
    """The L-BFGS step of a batch of B pairs (`dpst_tpu/optimize.py:557`
    under `jax.vmap`): `step(u, state) -> (u, state, history rows (B, 5),
    the pairs' ZoomLinesearchInfo)` under `loss(image) -> (Σ_b total_b,
    terms (B, 5))` at `to_img(u)`, u a batch or its row shards, `opt` =
    `optim.lbfgs(pairs=True)`. One evaluation (a forward and an input
    gradient) serves all B pairs, each pair's value its total_b; with
    `cfg.debug_nans` a non-finite loss or gradient (of any shard) raises
    FloatingPointError naming the pair. Steps are numbered from
    `first_step`."""
    to_img = logits_to_pixels if cfg.clip_pixels else (lambda u: u)
    full_hist = history_terms(cfg) != "total"
    counter = {"step": first_step}

    def value_and_grad_fn(u: optim.Vector):
        with torch.enable_grad():
            u = optim.tree_map(lambda x: x.detach().requires_grad_(True), u)
            total, terms = loss(to_img(u))
            if isinstance(u, list):
                grad = list(torch.autograd.grad(total, u))
            else:
                (grad,) = torch.autograd.grad(total, u)
        values = terms[..., 0].detach()
        if cfg.debug_nans:
            optim.tree_map(lambda g: runtime.check_finite(
                counter["step"], values.to(g.device), g), grad)
        return values, grad

    vg = optim.value_and_grad_from_state(value_and_grad_fn, pairs=True)

    def step(u: optim.Vector, st: tuple):
        stale = [not np.isfinite(v) for v in st[-1].value]
        values, grad = vg(u, state=st)
        if full_hist:
            # the terms at the pre-update point cost one more forward
            _, terms = loss(to_img(u))
            rows = terms.cpu().numpy()
        else:
            values = optim.fetch(*values)
            rows = np.zeros((len(values), 5), np.float32)
            rows[:, 0] = values
        traces = []
        updates, st = opt.update(grad, st, u, value=values, grad=grad,
                                 value_and_grad_fn=value_and_grad_fn,
                                 trace=traces)
        u = optim.apply_updates(u, updates)
        ls = st[-1]
        pairs = [{"evaluations": i.num_linesearch_steps + s,
                  "num_linesearch_steps": i.num_linesearch_steps,
                  "decrease_error": float(i.decrease_error),
                  "curvature_error": float(i.curvature_error),
                  "value_finite": bool(np.isfinite(v)), "trace": tr}
                 for i, s, v, tr in zip(ls.info, stale, ls.value, traces)]
        _record({"evaluations": ls.rounds + any(stale),
                 "num_linesearch_steps": max(
                     p["num_linesearch_steps"] for p in pairs),
                 "decrease_error": max(p["decrease_error"] for p in pairs),
                 "curvature_error": max(p["curvature_error"]
                                        for p in pairs),
                 "value_finite": all(p["value_finite"] for p in pairs),
                 "pairs": pairs})
        counter["step"] += 1
        return u, st, rows, ls.info

    return step


@torch.no_grad()
def lbfgs_steps(image: optim.Vector, opt_state, loss, n_steps: int,
                cfg: StylizeConfig, first_step: int = 0):
    """n_steps L-BFGS steps from `image`, a batch (B, H, W, 3) of pairs or
    the list of its row shards, under `loss(image) -> (Σ_b total_b, terms
    (B, 5))`, with the state `opt_state` (`make_optimizer(cfg)`'s, in
    logit space when boxed). Returns (u, state, history (B, n_steps, 5) on
    the image's (first shard's) device, evaluations of each step's
    linesearch (B, n_steps))."""
    step = _lbfgs_step(cfg, loss, make_optimizer(cfg), first_step)
    u = pixels_to_logits(image) if cfg.clip_pixels else image
    rows, evals = [], []
    for _ in range(n_steps):
        u, opt_state, row, info = step(u, opt_state)
        rows.append(row)
        evals.append([i.num_linesearch_steps for i in info])
    b = optim.first_vec(image).shape[0]
    history = torch.from_numpy(
        np.stack(rows, -2) if rows else np.zeros((b, 0, 5), np.float32)
    ).to(optim.first_device(image))
    evals = torch.tensor(evals, dtype=torch.int32).reshape(n_steps, b)
    return u, opt_state, history, evals.movedim(0, -1)


def _lbfgs_loop(image, opt_state, consts, weights, vgg_params, n_steps,
                cfg, first_step=0):
    """`lbfgs_steps` under `make_loss_fn(cfg)` of a batch (B, H, W, 3), or
    of one (H, W, 3) image as a batch of one (its constants too; u,
    history and evaluations come back without the pair axis)."""
    loss_fn = make_loss_fn(cfg)
    one = image.dim() == 3
    if one:
        image, consts = image[None], consts.map(lambda t: t[None])
    u, opt_state, history, evals = lbfgs_steps(
        image, opt_state, lambda im: loss_fn(im, consts, weights, vgg_params),
        n_steps, cfg, first_step)
    if one:
        u, history, evals = u[0], history[0], evals[0]
    return u, opt_state, history, evals


def lbfgs_eval_trajectory(image: torch.Tensor, opt_state,
                          consts: StylizeConstants, weights: LossWeights,
                          vgg_params: dict, *, n_steps: int,
                          cfg: StylizeConfig):
    """`run_segment`'s L-BFGS steps (the same step function) that also
    return optax's ZoomLinesearchInfo.num_linesearch_steps of each step:
    (history (n_steps, 5), evals (n_steps,) int32)."""
    if cfg.optimizer != "lbfgs":
        raise ValueError("lbfgs_eval_trajectory requires optimizer='lbfgs'")
    _, _, history, evals = _lbfgs_loop(image, opt_state, consts, weights,
                                       vgg_params, n_steps, cfg)
    return history, evals


def init_image(cfg: StylizeConfig, content: torch.Tensor,
               style_mean: torch.Tensor | None = None) -> torch.Tensor:
    """Initial output image per cfg.init_mode, of one (H, W, 3) content
    image or a batch (B, H, W, 3) with style means (B, 1, 1, 3). "noise"
    draws from a torch.Generator seeded with cfg.seed, the same draw for
    every pair of a batch (as `jax.vmap` with one key): it does not
    reproduce the JAX package's bits."""
    if cfg.init_mode == "content":
        return content.to(torch.float32).clone()
    if cfg.init_mode == "noise":
        gen = torch.Generator().manual_seed(cfg.seed)
        noise = torch.randn(content.shape[-3:], generator=gen,
                            dtype=torch.float32).to(content.device)
        noise = noise.expand(content.shape)
        return torch.clamp(127.5 + cfg.init_noise_scale * noise, 0.0, 255.0)
    base = content.to(torch.float32)
    mean_c = torch.mean(base, dim=(-3, -2), keepdim=True)
    mean_s = style_mean if style_mean is not None else mean_c
    return torch.clamp(base - mean_c + mean_s, 0.0, 255.0)


def run_segment(image: torch.Tensor, opt_state, consts: StylizeConstants,
                weights: LossWeights, vgg_params: dict, n_steps: int,
                cfg: StylizeConfig, first_step: int = 0):
    """`n_steps` optimizer steps. Returns (image, opt_state, history
    (n_steps, 5)) with history [total, content, style, photoreal, tv] per
    step, taken at the image before the step's update; with L-BFGS and
    `history_terms(cfg) == "total"`, columns 1-4 are zeros and column 0 is
    the linesearch's cached value. Boxed L-BFGS re-enters logit space from
    `image`, and keeps the cached value and gradient of the state as they
    are (`dpst_tpu/optimize.py:run_segment` does the same). Adam runs on
    the device without a sync; L-BFGS syncs once an evaluation.
    `first_step` numbers the steps in debug_nans errors. A batch (image (B,
    H, W, 3), batched constants, weights of scalars or (B,) tensors) gives
    history (B, n_steps, 5); with L-BFGS its pairs run as one batched loop,
    each evaluation one sync for all pairs (one image runs as a batch of
    one)."""
    if cfg.optimizer == "lbfgs":
        u, opt_state, history, _ = _lbfgs_loop(
            image, opt_state, consts, weights, vgg_params, n_steps, cfg,
            first_step)
        return (logits_to_pixels(u) if cfg.clip_pixels else u), opt_state, \
            history
    return drain(adam_segment(image, opt_state, consts, weights, vgg_params,
                              n_steps, cfg, first_step))


def adam_steps(params: list, states: list, loss, n_steps: int,
               cfg: StylizeConfig, first_step: int = 0):
    """Generator of `n_steps` Adam steps of the tensors `params` (one image,
    or the row shards of one, `parallel/spatial.py`) with their AdamStates,
    under `loss(params) -> (total, terms)`: each step the loss and its
    gradient for every tensor, the check of `cfg.debug_nans` (a batch's
    names the pair), the update and the clip of each tensor. Yields after
    each step; returns (params, states, the steps' detached terms). A step
    is the span `step`, around `backward` (the gradient) and `update`;
    `make_loss_fn`'s loss adds `features` and `loss` before them."""
    opt = Adam(cfg)
    rows = []
    for i in range(n_steps):
        with runtime.span("step"):
            leaves = [p.detach().requires_grad_(True) for p in params]
            total, terms = loss(leaves)
            with runtime.span("backward"):
                grads = torch.autograd.grad(total, leaves)
            if cfg.debug_nans:
                for g in grads:
                    runtime.check_finite(first_step + i,
                                         terms[..., 0].to(g.device), g)
            with runtime.span("update"):
                rows.append(terms.detach())
                params, new_states = [], []
                for leaf, g, st in zip(leaves, grads, states):
                    update, st = opt.update(g, st)
                    p = leaf.detach() + update
                    params.append(torch.clamp(p, 0.0, 255.0)
                                  if cfg.clip_pixels else p)
                    new_states.append(st)
                states = new_states
        yield
    return params, states, rows


def stack_rows(rows: list, image: torch.Tensor) -> torch.Tensor:
    """The history (n, 5), or (B, n, 5) for a batch image, of the terms
    that `adam_steps` returned."""
    if rows:
        return torch.stack(rows, -2)
    return torch.zeros((*image.shape[:-3], 0, 5), dtype=torch.float32,
                       device=image.device)


def adam_segment(image: torch.Tensor, opt_state, consts: StylizeConstants,
                 weights: LossWeights, vgg_params: dict, n_steps: int,
                 cfg: StylizeConfig, first_step: int = 0):
    """`run_segment`'s Adam steps as a generator that yields after each
    step (so that loops on several devices can take their steps in turns);
    returns (image, opt_state, history)."""
    loss_fn = make_loss_fn(cfg)
    (image,), (opt_state,), rows = yield from adam_steps(
        [image], [opt_state],
        lambda p: loss_fn(p[0], consts, weights, vgg_params), n_steps, cfg,
        first_step)
    return image, opt_state, stack_rows(rows, image)


def drain(gen):
    """Run a generator to its end; its return value."""
    return interleave([gen])[0]


def interleave(gens: list) -> list:
    """Advance the generators one step each in turn until every one has
    ended; their return values, in order."""
    out = [None] * len(gens)
    live = list(range(len(gens)))
    while live:
        for i in list(live):
            try:
                next(gens[i])
            except StopIteration as stop:
                out[i] = stop.value
                live.remove(i)
    return out


def run(image0: torch.Tensor, consts: StylizeConstants,
        weights: LossWeights, vgg_params: dict, cfg: StylizeConfig,
        iterations: int | None = None,
        callback: Callable | None = None, checkpointer=None,
        resume: bool = False):
    """Full optimization at one scale.

    `callback(step, image, history_chunk)` fires every
    `cfg.intermediate_interval` steps; with no callback the run is one
    segment. `checkpointer` (utils.checkpoint.RunCheckpointer) saves
    (step, image, opt_state) at the same cadence (every 100 steps where the
    interval is 0); `resume=True` continues from its latest checkpoint, and
    the history then covers only the new steps. Returns (final image
    (H, W, 3), (iterations run, 5) history).
    """
    opt = make_optimizer(cfg)
    opt_state = init_opt_state(opt, cfg, image0)
    total_iters = cfg.iterations if iterations is None else iterations
    interval = cfg.intermediate_interval if (callback or checkpointer) \
        else 0
    if interval <= 0 and checkpointer is not None:
        interval = 100
    image = image0
    done = 0
    if checkpointer is not None and resume:
        restored = checkpointer.restore(image0, opt_state)
        if restored is not None:
            done, image, opt_state = restored
    histories = []
    while done < total_iters:
        n = total_iters - done if interval <= 0 else min(
            interval, total_iters - done)
        image, opt_state, hist = run_segment(
            image, opt_state, consts, weights, vgg_params, n, cfg,
            first_step=done)
        done += n
        histories.append(hist)
        if callback is not None:
            callback(done, image, hist)
        if checkpointer is not None:
            checkpointer.save(done, image, opt_state)
    history = (torch.cat(histories) if histories else
               torch.zeros((0, 5), dtype=torch.float32, device=image0.device))
    if not cfg.clip_pixels:
        image = torch.clamp(image, 0.0, 255.0)
    return image, history
