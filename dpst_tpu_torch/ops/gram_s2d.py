"""Masked Grams of relu(z + b) taken from the raw block-1 conv output: the
fused bias+ReLU CUDA kernels, their plain versions and the autograd
Function.

The port's counterpart of `dpst_tpu/ops/gram_s2d.py`, whose v2 kernels
(`_fwd_kernel2`, `_bwd_kernel2`, `s2d_gram="pallas"` and "auto") and v1
kernels (`_fwd_kernel`, `_bwd_kernel`, `"pallas1"`) compute one function:

    forward   F = round(max(z + b, 0)),   G_k = F · (F ∘ m²_k)ᵀ
    backward  dz = relu′(z + b) ∘ Σ_k (S_k · F) ∘ m²_k,   S_k = dG_k + dG_kᵀ

z is the raw conv output (no bias) as its (C, P) NCHW planes and b the (C,)
bias, both in the compute dtype; z + b is formed in fp32 and F rounded to
the compute dtype; relu′ is 1 above 0, ½ at exactly 0 and 0 below (the
subgradient of `jnp.maximum`, as `models.vgg._BiasRelu` has it); the sum
over classes is fp32 in class order, rounded once. No gradient flows to b
or to the masks.

The TPU kernels read the tap as a space-to-depth parity grid, contract it
in two-half 128-lane diagonal blocks and pack the masks into lanes. Those
are layout devices of the TPU and are not carried: the operands here are
the ones `gram_stream` takes, and any C and any K are accepted.

In bf16 both run Hopper bodies of csrc/gram_wgmma.cuh on `gram_stream`'s
padding (P to a multiple of 8) and, for the backward, its cotangent matrix
(`s_matrix`). The forward is `gram_fwd`'s body with a bias+ReLU prologue.
The backward is `gram_wbwd`'s class-outer order with the cook and relu′
added (C up to 512): at C <= 64 and up to RELU_BWD_MAX_K classes — conv1_1,
the only tap the fused route takes — a body of its own, bound by bytes,
that keeps the cotangent resident and the raw tap in flight; above, the
`gram_wbwd` body itself, cooking each chunk where it lands. `relu_bwd_plan`
gives either its grid.

A batch of B pairs, z (B, C, P) with one shared bias and m² (B, K, P), runs
both in one launch each, the pair an index of the grid (`gram_stream`'s
batch), and both plans take B: the forward splits each pair as one pair's
plan does, and the backward's B sets only its blocks over p tiles.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import kernels
from .gram_pallas import WBWD_MAX_C, class_sum_plain, wbwd_plan
from .gram_stream import (_SMS, _fwd_one, check_operands, launch_bwd,
                          launch_fwd, normalize, per_pair, symmetrize)

RELU_BWD_MAX_K = 8   # classes whose cotangent tiles the C <= 64 body keeps
RELU_BWD_PIXELS = 256  # pixels of its p tile, 64 for each of 4 warpgroups


class RawTap(NamedTuple):
    """A VGG tap taken before its bias and ReLU: the raw conv output z
    (C, H, W) and the bias b (C,), both in the compute dtype."""
    z: torch.Tensor
    b: torch.Tensor


def _cook(z: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu(z + b) with z + b formed in fp32, rounded to z's dtype."""
    return torch.clamp_min(z.float() + b.float()[:, None], 0).to(z.dtype)


def _relu_grad(z: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu′(z + b) in fp32: 1 above 0, ½ at exactly 0, 0 below."""
    x = z.float() + b.float()[:, None]
    return (x > 0).float() + 0.5 * (x == 0).float()


def gram_relu_fwd_plain(z: torch.Tensor, b: torch.Tensor,
                        m2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch forward: (C, P) raw tap, (C,) bias × (K, P) m² ->
    (K, C, C) fp32 (a batch pair by pair)."""
    one = lambda z, b, m2: _fwd_one(_cook(z, b), m2)
    return per_pair(one, z, b, m2) if z.dim() == 3 else one(z, b, m2)


def gram_relu_bwd_plain(z: torch.Tensor, b: torch.Tensor, m2: torch.Tensor,
                        s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch backward: dz (C, P) in z's dtype, from the symmetrized
    cotangent s (K, C, C) in z's dtype (a batch pair by pair)."""
    def one(z, b, m2, s):
        acc = class_sum_plain(_cook(z, b), m2, s)
        return (acc * _relu_grad(z, b)).to(z.dtype)

    return per_pair(one, z, b, m2, s) if z.dim() == 3 else one(z, b, m2, s)


def _check(z: torch.Tensor, b: torch.Tensor, m2: torch.Tensor
           ) -> tuple[int, int, int, int]:
    """(B, C, P, K) of a (C, P) raw tap or a (B, C, P) batch, its (C,) bias
    and its m², validated for a kernel."""
    bsz, c, p, k = check_operands(z, m2, "z")
    kernels.require(b, "b", (c,), z.dtype)
    return bsz, c, p, k


def gram_relu_fwd(z: torch.Tensor, b: torch.Tensor,
                  m2: torch.Tensor) -> torch.Tensor:
    """Raw masked Grams of relu(z + b), z (C, P) or a batch (B, C, P) with
    one bias. CPU tensors take the plain version; CUDA tensors launch the
    kernel (csrc/gram.cu), once for all pairs. In bf16 that is
    `gram_fwd`'s Hopper body with a bias+ReLU prologue, on `gram_fwd`'s
    padding and plan: the zero columns that pad P to a multiple of 8 cook
    to relu(b), but their m² is zero, so they add nothing."""
    _check(z, b, m2)
    if not kernels.on_cuda(z, b, m2):
        return gram_relu_fwd_plain(z, b, m2)
    return launch_fwd("gram_relu_fwd", z, m2, b)


def relu_bwd_plan(c: int, p: int, k: int, b: int = 1
                  ) -> tuple[int, int, int]:
    """(c tile, groups, splits) of the bf16 backward, as the kernel takes
    them. At C <= 64 and K <= RELU_BWD_MAX_K its own body: one 64-row c
    tile, all K classes in every block (splits = 1), and `groups` blocks a
    pair, at most one an SM in all (B pairs share the SMs), walking the
    RELU_BWD_PIXELS-pixel p tiles. Else `gram_wbwd`'s plan, which its body
    takes."""
    if c <= 64 and k <= RELU_BWD_MAX_K:
        return 64, min(-(-p // RELU_BWD_PIXELS), max(1, _SMS // b)), 1
    return wbwd_plan(c, p, k, b)


def gram_relu_bwd(z: torch.Tensor, b: torch.Tensor, m2: torch.Tensor,
                  s: torch.Tensor) -> torch.Tensor:
    """dz of the raw masked Grams of relu(z + b), z (C, P) or a batch (B,
    C, P). CPU tensors take the plain version; CUDA tensors launch the
    kernel (csrc/gram.cu; in bf16 csrc/gram_relu_bwd.cu, on
    `relu_bwd_plan`, with C <= WBWD_MAX_C), once for all pairs."""
    _, c, p, k = _check(z, b, m2)
    kernels.require(s, "s", (*z.shape[:-2], k, c, c), z.dtype)
    if not kernels.on_cuda(z, b, m2, s):
        return gram_relu_bwd_plain(z, b, m2, s)
    if z.dtype == torch.bfloat16 and c > WBWD_MAX_C:
        raise ValueError(f"gram_relu_bwd in bf16 takes C <= {WBWD_MAX_C}, "
                         f"not {c}")
    return launch_bwd("gram_relu_bwd", z, m2, s, relu_bwd_plan, bias=b)


class GramReluRaw(torch.autograd.Function):
    """Unnormalized masked Grams of relu(z + b) with the one-pass analytic
    backward; gradient to z only."""

    @staticmethod
    def forward(ctx, z: torch.Tensor, b: torch.Tensor,
                m2: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(z, b, m2)
        return gram_relu_fwd(z, b, m2)

    @staticmethod
    def backward(ctx, d: torch.Tensor):
        z, b, m2 = ctx.saved_tensors
        return gram_relu_bwd(z, b, m2, symmetrize(d, z.dtype)), None, None


def masked_grams_relu(z: torch.Tensor, b: torch.Tensor, masks: torch.Tensor,
                      eps: float = 1e-8, norm: str = "m2") -> torch.Tensor:
    """All K masked Grams of relu(z + b): (C, H, W) raw tap and (C,) bias ×
    (K, H, W) masks -> (K, C, C), normalized like `losses.masked_grams`
    (a batch: (B, C, H, W) × (B, K, H, W) -> (B, K, C, C)). The operands
    stay in z's dtype (the compute dtype the tap was made in); b is rounded
    to it."""
    lead = z.shape[:-3]
    m2 = (masks * masks).to(z.dtype).flatten(-2).contiguous()
    g = GramReluRaw.apply(z.reshape(*lead, z.shape[-3], -1).contiguous(),
                          b.to(z.dtype).contiguous(), m2)
    return normalize(g, masks, norm, eps)
