"""Loss terms: content, masked Gram style, total variation.

The port's counterpart of `dpst_tpu/ops/losses.py`. VGG taps arrive as
(C, H, W) planes of one image, NCHW or, on the card's bf16 cuDNN route,
channels_last: flattened, a tap is the (C, P) operand of the Gram kernels,
contiguous, or with stride 1 on C, which their (P, C) forms read as it
lies (no tap is copied). `gram_route` resolves `gram_impl` per
layer as the JAX package does on a TPU: the fused route (and "dotg" and
"scan") takes `gram_stream.masked_grams_raw`, whose backward weights by m²
before the product (`gram_fwd`, `gram_bwd`); "pallas", "stream" and
"hybrid" take `gram_pallas.masked_grams_pallas`, whose backward weights
after it (`gram_fwd`, `gram_wbwd`). The style image's Grams always take
the fused route; the block-1 taps that the optimizer routes as raw taps
take `gram_s2d.masked_grams_relu`. All loss accumulation is fp32.

Every term also takes a batch of B pairs (a leading axis on the taps,
masks, Grams and coverage) and returns one value a pair: the Gram kernels
then run once for the batch, and the route is decided on one pair's
shapes, as `jax.vmap` leaves them in the JAX package.
"""
from __future__ import annotations

import torch

from . import kernels
from .gram_pallas import masked_grams_pallas, use_pallas
from .gram_s2d import RawTap, masked_grams_relu
from .gram_stream import masked_grams_raw, normalize, tap_operand
from .kernels import torch_dtype


def content_loss(feat_out: torch.Tensor, feat_content: torch.Tensor
                 ) -> torch.Tensor:
    """½·mean squared feature difference over (C, H, W): a scalar, or (B,)
    for a batch. Channels_last features are read in their memory order
    (H, W, C), so that the gradient comes back channels_last: one in NCHW
    order would cost the tap's gradient sum a strided add and the
    bias+ReLU backward a copy."""
    if kernels.channels_last(feat_out):
        feat_out = feat_out.movedim(-3, -1)
        feat_content = feat_content.movedim(-3, -1)
    d = feat_out.to(torch.float32) - feat_content.to(torch.float32)
    return 0.5 * torch.mean(d * d, dim=(-3, -2, -1))


def masked_grams(feat: torch.Tensor, masks: torch.Tensor,
                 eps: float = 1e-8, compute_dtype="float32",
                 norm: str = "m2") -> torch.Tensor:
    """All K masked Grams: (C, H, W) tap × (K, H, W) masks -> (K, C, C);
    a batch (B, C, H, W) × (B, K, H, W) -> (B, K, C, C).

    G_k = (m_k∘F)(m_k∘F)ᵀ / max(n_k, eps), with n_k = Σ m_k² ("m2", the
    default) or Σ m_k ("m1", the reference lineage's normalizer). Operands
    are in `compute_dtype`; accumulation is fp32.
    """
    cdt = torch_dtype(compute_dtype)
    f = tap_operand(feat.to(cdt).flatten(-2))
    m2 = (masks * masks).to(cdt).flatten(-2).contiguous()
    return normalize(masked_grams_raw(f, m2), masks, norm, eps)


# dpst_tpu/ops/losses.py:_FUSED_MAX_ELEMENTS: the largest (P, K·C) weighted
# block the TPU's fused route forms; past it "auto" streams the Gram
FUSED_MAX_ELEMENTS = 1 << 29


def gram_route(h: int, w: int, k: int, c: int, gram_impl: str) -> str:
    """The masked-Gram route of one layer shape, as `dpst_tpu/ops/losses.py:
    gram_route` resolves it on a TPU: "stream" when asked, or for "auto"
    past FUSED_MAX_ELEMENTS; "hybrid", "pallas" and "dotg" when asked; else
    "fused" up to the bound and "scan" past it."""
    size = h * w * k * c
    if gram_impl == "stream" or (gram_impl == "auto"
                                 and size > FUSED_MAX_ELEMENTS):
        return "stream"
    if gram_impl == "hybrid":
        return "hybrid"
    if use_pallas(h, w, k, c, gram_impl):
        return "pallas"
    if gram_impl == "dotg":
        return "dotg"
    return "fused" if size <= FUSED_MAX_ELEMENTS else "scan"


def route_grams(route: str, feat: torch.Tensor, masks: torch.Tensor,
                compute_dtype="float32", norm: str = "m2") -> torch.Tensor:
    """The masked Grams of `feat` by the Gram route `route`."""
    if route in ("pallas", "stream", "hybrid"):
        return masked_grams_pallas(feat, masks, compute_dtype=compute_dtype,
                                   norm=norm,
                                   weighted_left=route != "hybrid")
    return masked_grams(feat, masks, compute_dtype=compute_dtype, norm=norm)


def style_layer_loss(feat_out: torch.Tensor | None,
                     style_grams: torch.Tensor,
                     out_masks: torch.Tensor, coverage: torch.Tensor,
                     compute_dtype="float32",
                     style_norm: str = "gatys",
                     gram_impl: str = "auto",
                     g_out: torch.Tensor | None = None) -> torch.Tensor:
    """Masked Gram style loss of one VGG layer, summed over classes: a
    scalar, or (B,) for a batch (a leading axis on every tensor).

    `feat_out` is a (C, H, W) tap, whose Grams take `gram_route`'s route
    for `gram_impl`, or a `RawTap` of the raw conv output and its bias,
    whose Grams of relu(z + b) take the fused bias+ReLU kernels
    (`ops/gram_s2d.py`). `g_out`, the (K, C, C) output Grams already
    normalized (blocks 1-2 where they stream), replaces the tap:
    `feat_out` may then be None.

    "gatys": Σ_k coverage_k / (4C²) · ‖G_out,k − G_style,k‖² with
    Σm²-normalized Grams; "paper": Σ_k ½‖ΔG_k‖² with Σm-normalized Grams
    and no coverage weights.
    """
    c = style_grams.shape[-1]
    if style_norm == "paper":
        scale, class_w, norm = 0.5, torch.ones_like(coverage), "m1"
    else:
        scale, class_w, norm = 1.0 / (4.0 * c * c), coverage, "m2"
    if g_out is not None:
        g_o = g_out
    elif isinstance(feat_out, RawTap):
        g_o = masked_grams_relu(feat_out.z, feat_out.b, out_masks, norm=norm)
    else:
        route = gram_route(*feat_out.shape[-2:], out_masks.shape[-3], c,
                           gram_impl)
        g_o = route_grams(route, feat_out, out_masks, compute_dtype, norm)
    d = g_o - style_grams
    per_class = torch.sum(d * d, dim=(-2, -1))
    return scale * torch.sum(class_w * per_class, dim=-1)


def style_loss(feats_out: dict, style_grams: dict, out_masks: dict,
               coverage: torch.Tensor, layer_weights: dict,
               compute_dtype="float32",
               style_norm: str = "gatys",
               gram_impl: str = "auto",
               g_out: dict | None = None) -> torch.Tensor:
    """Sum of per-layer masked style losses, weighted per layer (one a pair
    for a batch). A layer in `g_out` ({layer: normalized (K, C, C)
    Grams}) uses those and needs no tap."""
    g_out = g_out or {}
    total = torch.zeros(coverage.shape[:-1], dtype=torch.float32,
                        device=coverage.device)
    for layer, w in layer_weights.items():
        total = total + w * style_layer_loss(
            feats_out.get(layer), style_grams[layer], out_masks[layer],
            coverage, compute_dtype, style_norm, gram_impl,
            g_out=g_out.get(layer))
    return total


def tv_loss(image: torch.Tensor) -> torch.Tensor:
    """Anisotropic total variation on an (H, W, 3) image (mean-normalized);
    (B,) for a batch (B, H, W, 3)."""
    dh = image[..., 1:, :, :] - image[..., :-1, :, :]
    dw = image[..., :, 1:, :] - image[..., :, :-1, :]
    dims = (-3, -2, -1)
    return torch.mean(dh * dh, dim=dims) + torch.mean(dw * dw, dim=dims)
