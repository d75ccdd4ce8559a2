"""Spatial (row) sharding: one image's rows over the devices of a mesh.

The port's counterpart of `dpst_tpu/parallel/spatial.py`. There XLA's
automatic SPMD partitions the unmodified loop and inserts the halo
exchanges of the convs, pools and stencils and the reductions of the
Grams and losses. Here they are written out, in one process that holds a
tensor per shard (`parallel/mesh.py`):

  * every 3×3 conv exchanges one row with each neighbour
    (`ops/laplacian_spmd.exchange_rows`) and runs `vgg.conv2d(ext, w,
    padding=(0, 1))` on its shard (cuDNN on the card), then bias and
    ReLU (`vgg._BiasRelu`, relu′(0) = ½); the 2×2 max pool
    (`vgg._MaxPool2`, the `pool_bwd` kernel) runs per shard;
  * `level_plan` says which VGG levels stay sharded; the first that
    cannot, and every deeper one, is gathered onto the mesh's first
    device and runs there;
  * each shard forms its raw masked Grams with `gram_fwd`
    (`gram_stream.masked_grams_raw`; its backward `gram_bwd` runs on the
    shard through autograd); they are summed on the first device in shard
    order and normalized by the whole image's Σ m² (or Σ m), taken once
    from the unsharded masks;
  * the content term sums the shards' Σ d² over the global count; the
    photorealism term is `laplacian_spmd.photoreal_shards` (a 2-row halo
    and `lap_matvec` on every shard); the TV term takes a 1-row halo and
    the global counts;
  * Adam runs per shard with one shared count (`optimize.adam_steps`);
    L-BFGS (`optimize.lbfgs_steps`) takes the shards as one vector of a
    batch of pairs (`optim.lbfgs(pairs=True)`): `optim` steps each shard
    on its device, keeps a ring of curvature pairs a shard, and sums each
    pair's dot products from the shards' partial dots on the first device
    in shard order (its scalars stay there, and its linesearches, one a
    pair in lockstep, sync once a batched evaluation).

Halo rows move by `.to(device)`; autograd carries their gradients back,
so no backward is written for the exchange. The precompute runs on the
first device and its constants are then placed by field (`shard_spatial`).
A mesh that repeats one device (`make_spatial_mesh(devices=["cpu"] * 4)`)
runs the same decomposition on that device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import optimize
from ..api import _stage_loop
from ..config import StylizeConfig
from ..models import vgg
from ..ops import losses
from ..ops.gram_stream import mask_norms, masked_grams_raw, normalize
from ..ops.kernels import torch_dtype
from ..ops.laplacian_spmd import (HALO, HALO_SPAN, exchange_rows,
                                  gather_rows, photoreal_shards, row_devices)
from ..utils import runtime
from . import mesh as mesh_lib
from .mesh import ROW_AXIS, Mesh, NamedSharding

LEVELS = len(vgg.VGG19_BLOCKS)    # conv{b}_* run at 1/2^(b-1) of the image


def make_spatial_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D row mesh over the first `n_devices` of `devices` (the visible
    CUDA devices by default; a list may repeat a device)."""
    return Mesh(mesh_lib.make_mesh(n_devices, devices).devices, (ROW_AXIS,))


def level_plan(h: int, n: int) -> tuple[bool, ...]:
    """Which of the five VGG levels (heights h, h/2, … h/16) run
    row-sharded over n shards. Level 0 is sharded when n divides h; a
    deeper level stays sharded while the level above it was sharded with
    an even number of rows a shard (so each shard's 2×2 pools stay whole)
    and its own height divides by n. The first level that fails, and every
    deeper one, runs gathered on the mesh's first device: the counterpart
    of `dpst_tpu/parallel/spatial.py:_row_spec`'s fallback to replication.
    24 rows on 2 shards: levels 24, 12 and 6 sharded, 3 gathered; 48 on
    4: 48 and 24 sharded, 12 (3 rows a shard) sharded, 6 gathered; 64 or
    4096 on 4: every level sharded."""
    plan = [h % n == 0]
    for _ in range(LEVELS - 1):
        ok = plan[-1] and (h // n) % 2 == 0
        h //= 2
        plan.append(ok and h % n == 0)
    return tuple(plan)


def _level(layer: str) -> int:
    return int(layer[4]) - 1              # "conv3_1" -> 2


class SpatialConstants(NamedTuple):
    """The loop constants of a row-sharded run. A field at a sharded level
    is a list of the shards' tensors (rows at dim -2, in mesh order);
    at a gathered level, and for the fields that are whole, one tensor on
    the first device."""
    content_feats: dict      # {layer: shards or tensor} (..., C, h, w)
    style_grams: dict        # {layer: tensor} (..., K, C, C), whole
    masks: dict              # {layer: shards or tensor} (..., K, h, w)
    coverage: torch.Tensor   # (..., K), whole
    lap_stats: list | None   # halo-extended shards (..., 14, h + 4, W)
    norms: dict              # {layer: (..., K)} Σ m² (Σ m) of whole masks
    plan: tuple              # level_plan(H, n)
    devices: tuple           # the row devices, first device first

    def map(self, fn) -> "SpatialConstants":
        """The constants with `fn` applied to every tensor, shard by
        shard."""
        each = lambda x: (None if x is None else [fn(s) for s in x]
                          if isinstance(x, list) else fn(x))
        field = lambda d: {k: each(v) for k, v in d.items()}
        return self._replace(
            content_feats=field(self.content_feats),
            style_grams=field(self.style_grams), masks=field(self.masks),
            coverage=each(self.coverage), lap_stats=each(self.lap_stats),
            norms=field(self.norms))


def spatial_shardings(consts: optimize.StylizeConstants, image, mesh: Mesh):
    """The placement of `shard_spatial` from shapes alone (only `.shape` is
    read): (a StylizeConstants of NamedShardings, the image's). Row-sharded
    on their row axis (-2) where `level_plan` shards their level:
    `content_feats`, `masks` and the packed Laplacian stats (level 0); the
    image (..., H, W, 3) on -3. Whole on the first device (the counterpart
    of replicated: where every shard's terms are reduced): `style_grams`,
    `coverage`, and the fields of gathered levels. Field identity decides,
    never divisibility: a (K, C, C) Gram whose K divides the mesh stays
    whole."""
    rows = mesh.shape[ROW_AXIS]
    plan = level_plan(image.shape[-3], rows)
    whole = NamedSharding(Mesh([mesh.first], (ROW_AXIS,)), ())

    def row_spec(x, axis: int, level: int = 0) -> NamedSharding:
        if not plan[level]:
            return whole
        spec = [None] * len(x.shape)
        spec[axis] = ROW_AXIS
        return NamedSharding(mesh, tuple(spec))

    sh = optimize.StylizeConstants(
        content_feats={k: row_spec(v, -2, _level(k))
                       for k, v in consts.content_feats.items()},
        style_grams={k: whole for k in consts.style_grams},
        masks={k: row_spec(v, -2, _level(k)) for k, v in consts.masks.items()},
        coverage=whole,
        lap_stats=(None if consts.lap_stats is None
                   else row_spec(consts.lap_stats, -2)))
    return sh, row_spec(image, -3)


def _place(x: torch.Tensor, sharding: NamedSharding):
    pieces = list(mesh_lib.put(x, sharding).flat)
    return pieces if any(sharding.spec) else pieces[0]


def shard_spatial(consts: optimize.StylizeConstants, image: torch.Tensor,
                  mesh: Mesh, style_norm: str = "gatys"):
    """Place the loop constants and the image on a row mesh, field by field
    (`spatial_shardings`); the packed stats' shards get their 2-row halos
    once here (`exchange_rows`), and the Gram normalizers are taken from
    the whole masks (`style_norm` "paper": Σ m, else Σ m²). Returns
    (SpatialConstants, the image's row shards). Raises ValueError with the
    JAX package's text where the Laplacian's shards would have fewer than
    HALO rows."""
    sh, sh_image = spatial_shardings(consts, image, mesh)
    norm = "m1" if style_norm == "paper" else "m2"
    lap_stats = None
    if consts.lap_stats is not None:
        row_devices(mesh, ROW_AXIS, consts.lap_stats.shape[-2])
        lap_stats = exchange_rows(_place(consts.lap_stats, sh.lap_stats),
                                  HALO)
    sc = SpatialConstants(
        content_feats={k: _place(v, sh.content_feats[k])
                       for k, v in consts.content_feats.items()},
        style_grams={k: _place(v, sh.style_grams[k])
                     for k, v in consts.style_grams.items()},
        masks={k: _place(v, sh.masks[k]) for k, v in consts.masks.items()},
        coverage=_place(consts.coverage, sh.coverage),
        lap_stats=lap_stats,
        norms={k: mask_norms(v, norm).to(mesh.first)
               for k, v in consts.masks.items()},
        plan=level_plan(image.shape[-3], mesh.shape[ROW_AXIS]),
        devices=tuple(mesh.devices.flat))
    return sc, _place(image, sh_image)


def features_rows(params: dict, shards: list, layers, pooling: str, cdt,
                  plan: tuple, first: torch.device) -> dict:
    """VGG-19 on the row shards of an image batch ((B, h, W, 3) each, in
    mesh order) up to the deepest of `layers`: `vgg._run_layers` with a
    1-row exchange before each conv of a sharded level and the levels
    after `plan`'s first gathered one on `first`. `params` maps each
    device to its `vgg.pack_params` weights. Returns {layer: shards} at a
    sharded level, {layer: tensor on first} at a gathered one, (B, C, h,
    W) post-ReLU taps in `cdt`."""
    if first.type == "cuda":
        vgg.set_exact_backends(cdt)
    x = [vgg.preprocess(s).to(cdt) for s in shards]
    deepest = max(vgg.LAYER_ORDER.index(l) for l in layers)
    level, taps = 0, {}
    for name in vgg.LAYER_ORDER[:deepest + 1]:
        if name.startswith("pool"):
            level += 1
            if isinstance(x, list) and not plan[level]:
                x = gather_rows(x, first)
            x = ([vgg._pool(s, pooling) for s in x] if isinstance(x, list)
                 else vgg._pool(x, pooling))
            continue
        if isinstance(x, list):
            x = [vgg._BiasRelu.apply(
                     vgg.conv2d(e, params[e.device][name]["wc"],
                                padding=(0, 1)),
                     params[e.device][name]["bc"])
                 for e in exchange_rows(x, 1)]
        else:
            p = params[first][name]
            x = vgg._BiasRelu.apply(vgg.conv2d(x, p["wc"]), p["bc"])
        if name in layers:
            taps[name] = x
    return taps


def _raw_grams(f: torch.Tensor, m: torch.Tensor, cdt) -> torch.Tensor:
    """Unnormalized masked Grams of a (B, C, h, w) tap and (B, K, h, w)
    masks, as `losses.masked_grams` forms them."""
    m2 = (m * m).to(cdt).flatten(-2).contiguous()
    return masked_grams_raw(f.to(cdt).flatten(-2).contiguous(), m2)


def grams_rows(tap, masks, norms: torch.Tensor, cdt, first: torch.device
               ) -> torch.Tensor:
    """Normalized masked Grams (B, K, C, C) on `first` of a tap, its shards'
    raw Grams summed in shard order."""
    if isinstance(tap, list):
        g = None
        for f, m in zip(tap, masks):
            gi = _raw_grams(f, m, cdt).to(first)
            g = gi if g is None else g + gi
    else:
        g = _raw_grams(tap, masks, cdt)
    return normalize(g, None, norms=norms)


def _sum_sq(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    d = x.to(torch.float32) if y is None else (
        x.to(torch.float32) - y.to(torch.float32))
    return torch.sum(d * d, dim=(-3, -2, -1))


def _reduce(vals, first: torch.device) -> torch.Tensor:
    """Σ of per-shard values on `first`, in shard order."""
    total = None
    for v in vals:
        v = v.to(first)
        total = v if total is None else total + v
    return total


def content_rows(tap, target, first: torch.device) -> torch.Tensor:
    """½·mean squared difference over (C, H, W) of a tap and its content
    features: the shards' Σ d² over the global count."""
    if not isinstance(tap, list):
        return losses.content_loss(tap, target)
    count = tap[0].shape[-3] * sum(t.shape[-2] for t in tap) * \
        tap[0].shape[-1]
    return 0.5 * _reduce(map(_sum_sq, tap, target), first) / count


def tv_rows(shards: list, first: torch.device) -> torch.Tensor:
    """`losses.tv_loss` of the row-sharded image: each shard's row
    differences with the next shard's first row appended (a 1-row halo),
    over the global counts."""
    h = sum(s.shape[-3] for s in shards)
    w = shards[0].shape[-2]
    dh, dw = [], []
    for i, x in enumerate(shards):
        ext = x
        if i + 1 < len(shards):
            with runtime.span(HALO_SPAN):
                ext = torch.cat([x, shards[i + 1][..., :1, :, :].to(
                    x.device)], dim=-3)
        dh.append(_sum_sq(ext[..., 1:, :, :] - ext[..., :-1, :, :]))
        dw.append(_sum_sq(x[..., :, 1:, :] - x[..., :, :-1, :]))
    return (_reduce(dh, first) / ((h - 1) * w * 3)
            + _reduce(dw, first) / (h * (w - 1) * 3))


def make_spatial_loss(cfg: StylizeConfig):
    """loss(image shards, SpatialConstants, weights, params by device) ->
    (total, terms (B, 5)) on the first device: `optimize.make_loss_fn`'s
    objective of a batch (B, H, W, 3) whose rows are sharded, each term
    reduced from the shards as the module docstring says. `cfg` is
    `spmd_safe`: cuDNN convs, the fused Gram route."""
    style_lw = dict(zip(cfg.style_layers, cfg.style_layer_weights))
    all_layers = tuple(dict.fromkeys(cfg.style_layers + cfg.content_layers))
    cdt = torch_dtype(cfg.compute_dtype)

    def loss(shards: list, sc: SpatialConstants,
             weights: optimize.LossWeights, params: dict):
        first = sc.devices[0]
        feats = features_rows(params, shards, all_layers, cfg.pooling, cdt,
                              sc.plan, first)
        zero = torch.zeros(shards[0].shape[:1], dtype=torch.float32,
                           device=first)
        l_content = zero
        for layer in cfg.content_layers:
            l_content = l_content + content_rows(
                feats[layer], sc.content_feats[layer], first)
        l_style = zero
        for layer, w in style_lw.items():
            g = grams_rows(feats[layer], sc.masks[layer], sc.norms[layer],
                           cdt, first)
            l_style = l_style + w * losses.style_layer_loss(
                None, sc.style_grams[layer], None, sc.coverage, cdt,
                cfg.style_norm, g_out=g)
        l_reg = (_reduce(photoreal_shards(sc.lap_stats, shards), first)
                 if sc.lap_stats is not None else zero)
        l_tv = tv_rows(shards, first) if cfg.tv_weight else zero
        total = (weights.content * l_content + weights.style * l_style
                 + weights.reg * l_reg + weights.tv * l_tv)
        terms = torch.stack([total, l_content, l_style, l_reg, l_tv], -1)
        return torch.sum(total), terms

    return loss


def spatial_segment(shards: list, sc: SpatialConstants,
                    weights: optimize.LossWeights, params: dict,
                    n_steps: int, cfg: StylizeConfig):
    """Generator of `n_steps` optimizer steps of a row-sharded image batch
    from a fresh state: Adam per shard, one shared count, yielding after
    each step; or L-BFGS over the shards, the pairs as one batched loop,
    yielding nothing. `cfg.debug_nans` checks every shard. Returns
    (shards, history (B, n_steps, 5) on the first device)."""
    loss = make_spatial_loss(cfg)
    if cfg.optimizer == "lbfgs":
        opt = optimize.make_optimizer(cfg)
        u, _, hist, _ = optimize.lbfgs_steps(
            shards, optimize.init_opt_state(opt, cfg, shards),
            lambda x: loss(x, sc, weights, params), n_steps, cfg)
        return (optimize.logits_to_pixels(u) if cfg.clip_pixels else u,
                hist)
    opt = optimize.Adam(cfg)
    shards, _, rows = yield from optimize.adam_steps(
        shards, [opt.init(s) for s in shards],
        lambda p: loss(p, sc, weights, params), n_steps, cfg)
    return shards, optimize.stack_rows(rows, shards[0])


def spatial_stages(contents, styles, cmasks, smasks, cfg: StylizeConfig,
                   params: dict, mesh: Mesh, weights: optimize.LossWeights):
    """Generator of a whole stylization of a batch ((B, H, W, 3) images,
    (B, K, H, W) masks on the row mesh's first device) whose native-size
    stage is row-sharded over `mesh` (`api._stage_loop`): `cfg.scales`'
    coarser stages run on the first device (their sizes need not divide
    the mesh; an "spmd" Laplacian there as the one-device matvec), the
    native-size stage's precompute too, then `shard_spatial` and
    `spatial_segment`, each with `cfg.optimizer`. `params` is the weight
    dict, raw or packed, packed once and moved to each device
    (`vgg.params_by_device`); `cfg` is `spmd_safe`; `weights` scalars or
    (B,) tensors on the first device. Yields after every Adam step (an
    L-BFGS stage runs through); returns (images (B, H, W, 3) gathered on
    the first device, history (B, all steps, 5) there)."""
    h = contents.shape[-3]
    if h % mesh.shape[ROW_AXIS]:
        raise ValueError(f"image rows {h} not divisible by mesh size "
                         f"{mesh.shape[ROW_AXIS]}")
    first = mesh.first
    packed = vgg.params_by_device(params, mesh.devices.flat,
                                  cfg.compute_dtype, cfg.conv_impl)
    coarse_cfg = (dataclasses.replace(cfg, laplacian_impl="xla")
                  if cfg.laplacian_impl == "spmd" else cfg)

    def coarse(images, consts, iters):
        if cfg.optimizer == "lbfgs":
            opt = optimize.make_optimizer(coarse_cfg)
            images, _, hist = optimize.run_segment(
                images, optimize.init_opt_state(opt, coarse_cfg, images),
                consts, weights, packed[first], iters, coarse_cfg)
            return images, hist
        images, _, hist = yield from optimize.adam_segment(
            images, optimize.Adam(cfg).init(images), consts, weights,
            packed[first], iters, coarse_cfg)
        return images, hist

    def native(images, consts, iters):
        sc, shards = shard_spatial(consts, images, mesh, cfg.style_norm)
        shards, hist = yield from spatial_segment(
            shards, sc, weights, packed, iters, cfg)
        return gather_rows(shards, first, dim=-3), hist

    images, hist = yield from _stage_loop(
        contents, styles, cmasks, smasks, cfg, packed[first], coarse, native)
    if not cfg.clip_pixels:
        images = torch.clamp(images, 0.0, 255.0)
    return images, hist


def stylize_spatial(content, style, content_masks, style_masks,
                    cfg: StylizeConfig | None = None,
                    vgg_params: dict | None = None,
                    mesh: Mesh | None = None):
    """Stylize one pair with its rows sharded over the devices of `mesh`
    (all of them, as one row axis; `make_spatial_mesh()` by default: the
    CUDA devices).

    content/style: (H, W, 3) [0, 255]; masks (K, H, W). H (the native
    size) must divide by the mesh size. With `cfg.scales` the coarser
    stages run on the first device and the native-size stage runs
    sharded. `cfg` is made `spmd_safe` (an "pallas" Laplacian becomes
    "spmd": the kernel on every shard). Adam or L-BFGS (`cfg.optimizer`,
    as `optimize.run`: L-BFGS boxed in logit space under `clip_pixels`,
    its history `history_terms`' columns). One difference from the JAX
    package: the first
    stage starts from `optimize.init_image` with the style image's mean,
    as `stylize` does (the JAX package's `stylize_spatial` passes none,
    which matters only for `init_mode="style_mean"`). Returns (image (H,
    W, 3), history (iterations, 5)) as `optimize.run` does: tensors on the
    mesh's first device."""
    cfg = (cfg or StylizeConfig()).spmd_safe()
    if mesh is None:
        mesh = make_spatial_mesh()
    mesh = Mesh(list(mesh.devices.flat), (ROW_AXIS,))
    first = mesh.first
    if vgg_params is None:
        vgg_params = vgg.get_params(seed=cfg.seed, device=first)
    arrays = [torch.as_tensor(a, dtype=torch.float32).to(first)[None]
              for a in (content, style, content_masks, style_masks)]
    images, hist = optimize.drain(spatial_stages(
        *arrays, cfg, vgg_params, mesh,
        optimize.LossWeights.from_config(cfg)))
    return images[0], hist[0]
