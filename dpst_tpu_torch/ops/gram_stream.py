"""Masked Gram matrices with their one-pass analytic backward: CUDA kernels,
plain versions and the autograd Function.

The port's counterpart of `dpst_tpu/ops/gram_stream.py` (and of
`losses._grams_raw_flat`, which computes the same function):

    forward   G_k = F · (F ∘ m²_k)ᵀ              f (C, P), m² (K, P) -> (K, C, C)
    backward  dF  = Σ_k S_k · (F ∘ m²_k),  S_k = dG_k + dG_kᵀ

F is a VGG tap as its (C, P) NCHW planes, in the compute dtype; F ∘ m²_k
is rounded to that dtype; every product accumulates in fp32; G is fp32,
dF is in the compute dtype. Masks are constants of the optimization: the
Function returns no gradient for them.

Any C and any K are accepted (the TPU's s2d Gram kernel hard-coded C = 64;
this one does not). In bf16 the kernels are the Hopper bodies of
csrc/gram_wgmma.cuh, which read 16-byte rows: the wrapper pads P to a
multiple of 8 with zero columns (they add nothing to G; their dF is
dropped) and hands the backward its cotangent as the matrix `s_matrix(s)`.

A batch of B pairs, f (B, C, P) and m² (B, K, P), gives G (B, K, C, C)
(and dF (B, C, P) from s (B, K, C, C)) in one launch, the pair an index of
the kernel's grid. The plans take B, but B only sets what cuts
independent outputs (the backward's blocks over p tiles): a pair's
reductions are split as one pair's plan splits them, so that each pair's
sums round in a batch as they do alone. The plain versions take a batch
pair by pair.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels

_TILE = 64
_DEPTH = 32
_TARGET_BLOCKS = 4 * 132   # a few waves of blocks on the H100's 132 SMs
# the bf16 (wgmma) forward: 128-pixel stages, up to 4 classes a block, two
# blocks an SM
_WG_DEPTH = 128
_WG_CLASSES = 4
_WG_BLOCKS = 2 * 132
# the most pixels one split of the bf16 forward sums in its wgmma fp32
# accumulators: the tensor cores' accumulation does not round to nearest,
# and a split sums low by about its length in k16 steps times 2^-25 of its
# size (conv1_1's Grams at 4096², mean: 1.4e-4 below fp64 with 63616
# pixels a split, still 1.1e-5 with 8064; NVIDIA H100 80GB HBM3, 700.00
# W); the splits' partials are then summed with round-to-nearest adds.
# 8192 leaves every 512² plan as it was, the B = 8 batch's 8064-pixel
# splits at conv1_1 among them
FWD_SPLIT_MAX = 8192
_ROW = 8                   # bf16 elements in a 16-byte row segment
_SMS = 132                 # streaming multiprocessors of the H100
# blocks of the bf16 backward resident on one SM, by c tile (shared memory:
# 66.5 KB with 64-row tiles, 97.5 KB with 128-row tiles)
_BWD_RESIDENT = {64: 3, 128: 2}


def per_pair(fn, *tensors: torch.Tensor) -> torch.Tensor:
    """fn on each pair of a batch (the leading axis of every operand but a
    1-D bias, which the pairs share), stacked."""
    return torch.stack([fn(*(t[i] if t.dim() > 1 else t for t in tensors))
                        for i in range(tensors[0].shape[0])])


def _fwd_one(f: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    fw = f.unsqueeze(0) * m2.unsqueeze(1)                  # (K, C, P) cdt
    return torch.matmul(f.float(), fw.float().transpose(1, 2))


def gram_fwd_plain(f: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch forward: (C, P) × (K, P) -> (K, C, C) fp32 (a batch
    pair by pair)."""
    return per_pair(_fwd_one, f, m2) if f.dim() == 3 else _fwd_one(f, m2)


def _bwd_one(f: torch.Tensor, m2: torch.Tensor,
             s: torch.Tensor) -> torch.Tensor:
    k, c, _ = s.shape
    fw = (f.unsqueeze(0) * m2.unsqueeze(1)).reshape(k * c, -1)  # (K·C, P)
    a = s.permute(1, 0, 2).reshape(c, k * c)                    # (C, K·C)
    return torch.matmul(a.float(), fw.float()).to(f.dtype)


def gram_bwd_plain(f: torch.Tensor, m2: torch.Tensor,
                   s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch backward: dF (C, P) in f's dtype, from the symmetrized
    cotangent s (K, C, C) in f's dtype (a batch pair by pair)."""
    return (per_pair(_bwd_one, f, m2, s) if f.dim() == 3
            else _bwd_one(f, m2, s))


def fwd_splits(c: int, p: int, k: int) -> tuple[int, int]:
    """(splits, chunk): how many blocks share one output tile's P range,
    and how many pixels (a multiple of the tile depth) each covers."""
    tiles = (-(-c // _TILE)) ** 2
    splits = -(-_TARGET_BLOCKS // (tiles * k))
    splits = max(1, min(splits, -(-p // 512)))
    chunk = -(-p // splits)
    chunk = -(-chunk // _DEPTH) * _DEPTH
    return -(-p // chunk), chunk


def fwd_plan(c: int, p: int, k: int, b: int = 1) -> tuple[int, int]:
    """(splits, chunk) of the bf16 forward: P cut into `splits` ranges of
    `chunk` pixels (a multiple of the 128-pixel stage): as many as keep
    one pair's grid of tiles × class groups × splits within one wave of
    two blocks for each of the H100's SMs, each split at least two stages
    deep; where those would exceed FWD_SPLIT_MAX pixels (a multiple of
    128), enough more to keep within it, raised to fill the grid's last
    wave. The splits cut each pair's reduction over P, so B pairs take
    one pair's plan (a pair's Grams then round in a batch as alone) and
    the grid is B times as long."""
    del b   # a batch splits each pair as one pair's plan does
    blocks = fwd_blocks(c, k, 1)
    splits = max(1, min(_WG_BLOCKS // blocks, -(-p // (2 * _WG_DEPTH))))
    if -(-p // splits) > FWD_SPLIT_MAX:
        splits = -(-p // FWD_SPLIT_MAX)
        waves = -(-blocks * splits // _WG_BLOCKS)
        splits = max(splits, waves * _WG_BLOCKS // blocks)
    chunk = -(-p // splits)
    chunk = -(-chunk // _WG_DEPTH) * _WG_DEPTH
    return -(-p // chunk), chunk


def fwd_blocks(c: int, k: int, splits: int) -> int:
    """Blocks of the bf16 forward's grid: 64 × 64 tiles of G, groups of
    up to 4 classes, splits of P."""
    return (-(-c // _TILE)) ** 2 * -(-k // _WG_CLASSES) * splits


def bwd_plan(c: int, p: int, k: int, b: int = 1) -> tuple[int, int, int]:
    """(c tile, groups, splits) of the bf16 backward, as the kernel takes
    them. The c tile has 64 rows for C <= 64, else 128. `splits` is one
    pair's: when one pair's grid of 64-pixel p tiles × c tiles fills one
    wave of resident blocks, 1; else the reduction over (k, c') items of
    64 channels is cut into `splits` non-empty ranges to fill the wave.
    A batch keeps those splits (each pair's dF then rounds as alone).
    With one split, `groups` blocks per c tile of each of the B pairs walk
    its p tiles, as many as fill the wave; with more, every p tile of
    every pair has its block."""
    tile = 64 if c <= 64 else 128
    slots = _SMS * _BWD_RESIDENT[tile]
    ctiles, ptiles = -(-c // tile), -(-p // 64)
    splits = 1
    if ptiles * ctiles < slots:
        items = -(-c // 64) * k
        splits = max(1, min(items, slots // (ptiles * ctiles)))
        splits = -(-items // -(-items // splits))
    if splits > 1:
        return tile, ptiles, splits
    return tile, min(ptiles, max(1, slots // (b * ctiles))), 1


def s_matrix(s: torch.Tensor) -> torch.Tensor:
    """The cotangent stack S (K, C, C) as the bf16 backward reads it: A
    (C, K·Cp) with A[c, k·Cp + c'] = S_k[c, c'], Cp = C rounded up to a
    multiple of 8 and the padding zero (the plain version's `a` when C %
    8 == 0); a batch (B, K, C, C) gives (B, C, K·Cp)."""
    k, c, _ = s.shape[-3:]
    a = s.transpose(-3, -2)
    if c % _ROW:
        a = F.pad(a, (0, -c % _ROW))
    return a.reshape(*s.shape[:-3], c, -1)


def pad_pixels(t: torch.Tensor) -> torch.Tensor:
    """(..., rows, P) -> (..., rows, P rounded up to 8), the new columns
    zero; `t` itself when P % 8 == 0."""
    extra = -t.shape[-1] % _ROW
    return F.pad(t, (0, extra)) if extra else t


def check_operands(f: torch.Tensor, m2: torch.Tensor, name: str = "f"
                   ) -> tuple[int, int, int, int]:
    """(B, C, P, K) of a (C, P) tap or a (B, C, P) batch and its (K, P) or
    (B, K, P) m², validated for a kernel."""
    if f.dim() not in (2, 3) or m2.dim() != f.dim():
        raise ValueError(f"takes {name} (C, P) and m2 (K, P), or a batch "
                         f"(B, C, P) and (B, K, P); got "
                         f"{tuple(f.shape)} and {tuple(m2.shape)}")
    b = f.shape[0] if f.dim() == 3 else 1
    c, p = f.shape[-2:]
    k = m2.shape[-2]
    kernels.require(f, name)
    kernels.require(m2, "m2", (*f.shape[:-2], k, p), f.dtype)
    return b, c, p, k


def gram_fwd(f: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """Raw masked Grams of f (C, P) or a batch (B, C, P). CPU tensors take
    the plain version; CUDA tensors launch the kernel (csrc/gram.cu), once
    for all pairs."""
    check_operands(f, m2)
    if not kernels.on_cuda(f, m2):
        return gram_fwd_plain(f, m2)
    return launch_fwd("gram_fwd", f, m2)


def launch_fwd(name: str, f: torch.Tensor, m2: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the split-P forward kernel `name` ("gram_fwd", or
    "gram_relu_fwd" with the (C,) `bias`, csrc/gram.cu) on the CUDA (C, P)
    tap f and (K, P) m², or a batch (B, C, P) and (B, K, P); returns the
    (K, C, C) (or (B, K, C, C)) fp32 Grams. In bf16 (the Hopper body) P is
    padded to a multiple of 8 and cut by `fwd_plan`; fp32 takes
    `fwd_splits`."""
    lead = f.shape[:-2]
    b = f.shape[0] if lead else 1
    c, k = f.shape[-2], m2.shape[-2]
    if f.dtype == torch.bfloat16:
        f, m2 = pad_pixels(f), pad_pixels(m2)
        splits, chunk = fwd_plan(c, f.shape[-1], k, b)
    else:
        splits, chunk = fwd_splits(c, f.shape[-1], k)
    operands = (f, m2) if bias is None else (f, bias, m2)
    out = torch.empty((*lead, k, c, c), dtype=torch.float32, device=f.device)
    work = (torch.empty((b, splits, k, c, c), dtype=torch.float32,
                        device=f.device) if splits > 1 else out)
    rc = getattr(kernels.library(), "dpst_" + name)(
        *map(kernels.ptr, operands), kernels.ptr(work), kernels.ptr(out),
        c, f.shape[-1], k, b, splits, chunk, kernels.DTYPE_CODES[f.dtype],
        kernels.stream_ptr(f))
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return out


def gram_bwd(f: torch.Tensor, m2: torch.Tensor,
             s: torch.Tensor) -> torch.Tensor:
    """dF of the raw masked Grams, of f (C, P) or a batch (B, C, P). CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (csrc/gram.cu), once for all pairs."""
    _, c, _, k = check_operands(f, m2)
    kernels.require(s, "s", (*f.shape[:-2], k, c, c), f.dtype)
    if not kernels.on_cuda(f, m2, s):
        return gram_bwd_plain(f, m2, s)
    return launch_bwd("gram_bwd", f, m2, s, bwd_plan)


def launch_bwd(name: str, f: torch.Tensor, m2: torch.Tensor,
               s: torch.Tensor, plan,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the backward kernel `name` ("gram_bwd", "gram_wbwd", or
    "gram_relu_bwd" with the (C,) `bias` and f the raw tap z, csrc/gram.cu)
    on the CUDA (C, P) tap f, (K, P) m² and (K, C, C) cotangent
    s, or a batch (B, C, P), (B, K, P) and (B, K, C, C); returns dF (C, P)
    (or (B, C, P)). In bf16 (the Hopper bodies) P is padded to a multiple
    of 8, s goes as `s_matrix(s)` and `plan(C, P, K, B)` gives (c tile,
    groups, splits), with fp32 split partials where splits > 1."""
    lead = f.shape[:-2]
    b = f.shape[0] if lead else 1
    c, p = f.shape[-2:]
    k = m2.shape[-2]
    tile = groups = splits = 1
    work = None
    if f.dtype == torch.bfloat16:
        f, m2, s = pad_pixels(f), pad_pixels(m2), s_matrix(s).contiguous()
        tile, groups, splits = plan(c, f.shape[-1], k, b)
        if splits > 1:
            work = torch.empty((splits, b, c, f.shape[-1]),
                               dtype=torch.float32, device=f.device)
    out = torch.empty_like(f)
    operands = (f, m2, s) if bias is None else (f, bias, m2, s)
    rc = getattr(kernels.library(), "dpst_" + name)(
        *map(kernels.ptr, operands), kernels.ptr(work), kernels.ptr(out), c,
        f.shape[-1], k, b, tile, groups, splits,
        kernels.DTYPE_CODES[f.dtype], kernels.stream_ptr(f))
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return out if out.shape[-1] == p else out[..., :p].contiguous()


def symmetrize(d: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The cotangent S_k = dG_k + dG_kᵀ of (..., K, C, C) Gram cotangents,
    summed in fp32 and rounded to `dtype`."""
    d = d.float()
    return (d + d.transpose(-1, -2)).to(dtype).contiguous()


class GramRaw(torch.autograd.Function):
    """Unnormalized masked Grams with the one-pass analytic backward."""

    @staticmethod
    def forward(ctx, f: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(f, m2)
        return gram_fwd(f, m2)

    @staticmethod
    def backward(ctx, d: torch.Tensor):
        f, m2 = ctx.saved_tensors
        return gram_bwd(f, m2, symmetrize(d, f.dtype)), None


def masked_grams_raw(f: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """(C, P) features × (K, P) m² weights -> (K, C, C) fp32, unnormalized
    (a batch: (B, C, P) × (B, K, P) -> (B, K, C, C))."""
    return GramRaw.apply(f, m2)


def mask_norms(masks: torch.Tensor, norm: str = "m2") -> torch.Tensor:
    """n_k = Σ m_k² ("m2") or Σ m_k ("m1") of the fp32 (..., K, h, w)
    masks: (..., K)."""
    m32 = masks.to(torch.float32)
    return (torch.sum(m32 * m32, dim=(-2, -1)) if norm == "m2"
            else torch.sum(m32, dim=(-2, -1)))


def normalize(g: torch.Tensor, masks: torch.Tensor, norm: str = "m2",
              eps: float = 1e-8, norms: torch.Tensor | None = None
              ) -> torch.Tensor:
    """Raw (..., K, C, C) Grams over max(n_k, eps), n_k the `mask_norms` of
    the masks, or the (..., K) `norms` given (a row-sharded loop takes
    them from the whole image's masks; `masks` may then be None)."""
    n = mask_norms(masks, norm) if norms is None else norms
    return g / torch.clamp_min(n, eps)[..., None, None]
