"""Masked Grams whose backward weights by m² after the product: the
`gram_wbwd` CUDA kernel, its plain version and the autograd Function.

The port's counterpart of `dpst_tpu/ops/gram_pallas.py` (`gram_impl=
"pallas"`), and of the streamed Grams of `dpst_tpu/ops/gram_stream.py`
(`"stream"`, `"hybrid"`, and `"auto"` past the fused size bound), whose
backward kernels compute the same function:

    forward   G_k[i, j] = Σ_p round(F_ip · m²_kp) · F_jp
    backward  dF = Σ_k (S_k · F) ∘ m²_k,   S_k = round(dG_k + dG_kᵀ)

F is a VGG tap as its (C, P) planes in the compute dtype, NCHW or
channels_last (stride 1 on C: the kernels' (P, C) forms take it as
it lies and return dF in its layout). The forward
is `gram_stream.gram_fwd`'s function with each G_k transposed (the TPU
kernels put the weighted operand on the left; the fused route and
`gram_fwd` on the right). The backward differs from `gram_stream.gram_bwd`
in where m² enters: each class's product S_k · F is accumulated in fp32,
then multiplied by m²_k in fp32 and summed over k in class order, and the
sum is rounded once, where `gram_bwd` rounds F ∘ m²_k to the compute dtype
before one product. Masks are constants of the optimization: no gradient
flows to them.

In bf16 the backward is the Hopper body `gram_wbwd_body` of
csrc/gram_wgmma.cuh: classes outer, each class's product complete before
it meets its mask, F resident in shared memory across the classes, two
warpgroups on 128-pixel tiles. It takes `gram_stream`'s padding (P to a
multiple of 8) and cotangent matrix (`s_matrix`), C up to 512, and the
plan of `wbwd_plan`.
"""
from __future__ import annotations

import torch

from . import kernels
from .gram_stream import (_SMS, check_operands, gram_fwd, launch_bwd,
                          like_tap, normalize, per_pair, symmetrize,
                          tap_operand)
from .kernels import torch_dtype

WBWD_PIXELS = 128   # pixels of the bf16 backward's p tile
WBWD_MAX_C = 512    # channels whose F chunks fit its shared memory


def class_sum_plain(f: torch.Tensor, m2: torch.Tensor,
                    s: torch.Tensor) -> torch.Tensor:
    """Σ_k (S_k · F) ∘ m²_k in fp32, each class's product in fp32, weighted
    after the product and summed in class order: (C, P) × (K, P) × (K, C,
    C) -> (C, P) fp32."""
    f32 = f.float()
    acc = torch.zeros(f.shape, dtype=torch.float32, device=f.device)
    for k in range(s.shape[0]):
        acc = acc + torch.matmul(s[k].float(), f32) * m2[k].float()
    return acc


def gram_wbwd_plain(f: torch.Tensor, m2: torch.Tensor,
                    s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch backward: dF (C, P) in f's dtype, from the symmetrized
    cotangent s (K, C, C) in f's dtype (a batch pair by pair)."""
    one = lambda f, m2, s: class_sum_plain(f, m2, s).to(f.dtype)
    return per_pair(one, f, m2, s) if f.dim() == 3 else one(f, m2, s)


def wbwd_plan(c: int, p: int, k: int, b: int = 1) -> tuple[int, int, int]:
    """(c tile, groups, splits) of the bf16 backward, as the kernel takes
    them: one block of two warpgroups an SM; c tiles of 64 rows for C <= 64,
    else 128; p tiles of WBWD_PIXELS. `splits` is one pair's: 1 when one
    pair's grid of p tiles × c tiles fills the SMs, else the classes cut
    into ranges of whole classes (a class's product must be complete
    before it meets its mask), as many as make the grid's waves × the
    classes a block walks least (fewest on a tie). A batch of B pairs (of
    `gram_wbwd` or of the bias+ReLU backward, the pair an index of the
    grid) keeps those splits, so each pair's dF rounds as alone. With one
    split, `groups` blocks per c tile of each pair walk its p tiles, as
    many as fill the SMs; with more, every p tile of every pair has its
    block."""
    tile = 64 if c <= 64 else 128
    ctiles, ptiles = -(-c // tile), -(-p // WBWD_PIXELS)
    splits = 1
    if ptiles * ctiles < _SMS:
        cost = {}
        for n in range(1, k + 1):
            per = -(-k // n)
            n_splits = -(-k // per)
            cost.setdefault(n_splits,
                            -(-ptiles * ctiles * n_splits // _SMS) * per)
        splits = min(cost, key=lambda n: (cost[n], n))
    if splits > 1:
        return tile, ptiles, splits
    return tile, min(ptiles, max(1, _SMS // (b * ctiles))), 1


def gram_wbwd(f: torch.Tensor, m2: torch.Tensor,
              s: torch.Tensor) -> torch.Tensor:
    """dF of the masked Grams, weighted after the product, of f (C, P) or a
    batch (B, C, P). CPU tensors take the plain version; CUDA tensors
    launch the kernel (csrc/gram.cu; a batch in one launch, the pair an
    index of the grid, csrc/gram_wbwd_pairs.cu in bf16)."""
    _, c, _, k = check_operands(f, m2)
    kernels.require(s, "s", (*f.shape[:-2], k, c, c), f.dtype)
    if not kernels.on_cuda(f, m2, s):
        return like_tap(f, gram_wbwd_plain(f, m2, s))
    if f.dtype == torch.bfloat16 and c > WBWD_MAX_C:
        raise ValueError(f"gram_wbwd in bf16 takes C <= {WBWD_MAX_C}, not {c}")
    return launch_bwd("gram_wbwd", f, m2, s, wbwd_plan)


class WeightedGrams(torch.autograd.Function):
    """Unnormalized masked Grams G_k = F · (F ∘ m²_k)ᵀ (`gram_fwd`) with
    the backward that weights after the product (`gram_wbwd`)."""

    @staticmethod
    def forward(ctx, f: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(f, m2)
        return gram_fwd(f, m2)

    @staticmethod
    def backward(ctx, d: torch.Tensor):
        f, m2 = ctx.saved_tensors
        return gram_wbwd(f, m2, symmetrize(d, f.dtype)), None


def weighted_grams(f: torch.Tensor, m2: torch.Tensor,
                   weighted_left: bool = True) -> torch.Tensor:
    """(C, P) features × (K, P) m² -> (K, C, C) fp32, unnormalized.
    `weighted_left` puts the rounded F ∘ m²_k on the left of each product,
    as the TPU's Pallas and streamed kernels do; False keeps `gram_fwd`'s
    orientation, the fused forward's (`gram_impl="hybrid"`)."""
    g = WeightedGrams.apply(f, m2)
    return g.transpose(-1, -2) if weighted_left else g


def masked_grams_pallas(feat: torch.Tensor, masks: torch.Tensor,
                        eps: float = 1e-8, compute_dtype="float32",
                        norm: str = "m2",
                        weighted_left: bool = True) -> torch.Tensor:
    """All K masked Grams: (C, H, W) tap × (K, H, W) masks -> (K, C, C)
    (a batch: (B, C, H, W) × (B, K, H, W) -> (B, K, C, C)), normalized by
    max(Σ m², eps) ("m2") or max(Σ m, eps) ("m1"), operands in
    `compute_dtype`, accumulation in fp32. A channels_last tap is read as
    it lies, never copied."""
    cdt = torch_dtype(compute_dtype)
    f = tap_operand(feat.to(cdt).flatten(-2))
    m2 = (masks * masks).to(cdt).flatten(-2).contiguous()
    return normalize(weighted_grams(f, m2, weighted_left), masks, norm, eps)


def use_pallas(h: int, w: int, k: int, c: int, impl: str) -> bool:
    """`dpst_tpu/ops/gram_pallas.py:use_pallas`: only an explicit
    `gram_impl="pallas"` selects this route."""
    return impl == "pallas"
