"""Matrix-free matting-Laplacian operator (Levin closed-form matting).

The port's counterpart of `dpst_tpu/ops/laplacian.py`. For each interior
3×3 window k of the content image I,
    W_k[i,j] = δ_ij − (1/9)·(1 + (I_i−μ_k)ᵀ (Σ_k + ε/9·Id)⁻¹ (I_j−μ_k)),
and L = Σ_k W_k. The matvec y = L·v is two 3×3 box passes and pointwise
3-vector algebra:

  pass 1 (per window centre k):  s = box3(v), t = box3(I∘v) − μ·s,
      b = Λ·t, α = (μᵀb − s)/9, β = −b/9, zeroed at invalid centres;
  pass 2 (per pixel i):          y = n_i·v_i + box3(α) + Iᵀ·box3(β).

Everything is fp32 elementwise math, written out component by component:
Λ reaches about 1e6, so no matmul or einsum (which could round through
TF32 or reassociate) touches the 3-vector contractions. The box sums
round in a fixed order, (x[j] + x[j+1]) + x[j−1] along columns then the
same along rows, which the CUDA kernel (csrc/lap_matvec.cu) repeats.

The photorealism loss Σ_c v_cᵀ L v_c has gradient 2·L·v_c; its autograd
Function reuses the forward matvec, so each step pays one matvec.

Every division by 9 is one rounded division on the CPU and on the card
alike (`exact_div`): torch divides a CUDA tensor by a Python scalar
through its reciprocal, which rounds apart from the CPU's division in
about one element of ten, and the window covariance m2 − μμᵀ then cancels
those last bits into Λ ≈ 1e6.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

WIN = 9.0  # |w|: 3×3 windows


class LaplacianStats(NamedTuple):
    """Per-window-centre statistics of the content image (all (H, W, ...))."""
    mu: torch.Tensor         # (H, W, 3)    window mean (0 at invalid centres)
    lam: torch.Tensor        # (H, W, 3, 3) (Σ_k + ε/9·Id)⁻¹ (0 at invalid)
    valid: torch.Tensor      # (H, W)       1.0 at interior window centres
    win_count: torch.Tensor  # (H, W)       n_i = #valid windows containing i
    image: torch.Tensor      # (H, W, 3)    I in [0, 1]


def exact_div(x: torch.Tensor, d) -> torch.Tensor:
    """x / d as one rounded division on every device (`d` a tensor or a
    number; a number goes as a 0-d tensor on x's device)."""
    if not isinstance(d, torch.Tensor):
        d = torch.full((), d, dtype=x.dtype, device=x.device)
    return x / d


def _shift(x: torch.Tensor, dim: int, off: int) -> torch.Tensor:
    """out[i] = x[i + off] along `dim`, 0 past the edge."""
    n = x.shape[dim]
    out = torch.zeros_like(x)
    if off > 0:
        out.narrow(dim, 0, n - off).copy_(x.narrow(dim, off, n - off))
    else:
        out.narrow(dim, -off, n + off).copy_(x.narrow(dim, 0, n + off))
    return out


def _box3(x: torch.Tensor) -> torch.Tensor:
    """3×3 neighbourhood sum over dims (0, 1), zero-padded ("SAME")."""
    c = (x + _shift(x, 1, 1)) + _shift(x, 1, -1)
    return (_shift(c, 0, -1) + c) + _shift(c, 0, 1)


def _sym3_inv(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of symmetric 3×3 matrices (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / det
    row0 = torch.stack([co00, co01, co02], dim=-1)
    row1 = torch.stack([co01, co11, co12], dim=-1)
    row2 = torch.stack([co02, co12, co22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) * inv_det[..., None, None]


def precompute_stats(image01: torch.Tensor,
                     eps: float = 1e-5) -> LaplacianStats:
    """Window statistics of the content image (once per stylization).

    image01: (H, W, 3) float in [0, 1].
    """
    img = image01.to(torch.float32)
    h, w, _ = img.shape
    valid = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    valid[1:-1, 1:-1] = 1.0               # interior window centres only
    mu = exact_div(_box3(img), WIN)
    outer = img[..., :, None] * img[..., None, :]            # (H, W, 3, 3)
    m2 = exact_div(_box3(outer.reshape(h, w, 9)).reshape(h, w, 3, 3), WIN)
    cov = m2 - mu[..., :, None] * mu[..., None, :]
    eye = torch.eye(3, dtype=torch.float32, device=img.device)
    lam = _sym3_inv(cov + (eps / WIN) * eye)
    mu = mu * valid[..., None]
    lam = lam * valid[..., None, None]
    win_count = _box3(valid)
    return LaplacianStats(mu=mu, lam=lam, valid=valid,
                          win_count=win_count, image=img)


def zero_stats(h: int, w: int, device=None) -> LaplacianStats:
    """Stats of the zero operator: matvec(zero_stats, v) == 0 exactly."""
    z2 = torch.zeros((h, w), dtype=torch.float32, device=device)
    z3 = torch.zeros((h, w, 3), dtype=torch.float32, device=device)
    return LaplacianStats(
        mu=z3, lam=torch.zeros((h, w, 3, 3), dtype=torch.float32,
                               device=device),
        valid=z2, win_count=z2, image=z3)


def matvec(stats: LaplacianStats, v: torch.Tensor) -> torch.Tensor:
    """y = L·v for v of shape (H, W) or (H, W, C): the plain PyTorch path
    (the counterpart of the JAX package's matvec_xla)."""
    squeeze = v.dim() == 2
    if squeeze:
        v = v[..., None]
    v = v.to(torch.float32)
    img, mu, lam = stats.image, stats.mu, stats.lam
    valid = stats.valid[..., None]
    i3 = [img[..., m, None] for m in range(3)]      # (H, W, 1) each
    mu3 = [mu[..., m, None] for m in range(3)]

    s = _box3(v)                                                  # (H, W, C)
    t = [_box3(i3[m] * v) - mu3[m] * s for m in range(3)]
    b = [(lam[..., m, 0, None] * t[0] + lam[..., m, 1, None] * t[1])
         + lam[..., m, 2, None] * t[2] for m in range(3)]
    mub = (mu3[0] * b[0] + mu3[1] * b[1]) + mu3[2] * b[2]
    alpha = exact_div(mub - s, WIN) * valid
    beta = [exact_div(-b[m], WIN) * valid for m in range(3)]
    ib = [i3[m] * _box3(beta[m]) for m in range(3)]
    y = ((stats.win_count[..., None] * v + _box3(alpha))
         + ((ib[0] + ib[1]) + ib[2]))
    return y[..., 0] if squeeze else y


class _Photoreal(torch.autograd.Function):
    """vᵀLv summed over RGB, v = img/255, one value a pair; backward
    (2/255)·y·g from the forward's y (L is symmetric)."""

    @staticmethod
    def forward(ctx, packed: torch.Tensor, img255: torch.Tensor, matvec):
        v3 = (img255.to(torch.float32) * (1.0 / 255.0)).movedim(
            -1, -3).contiguous()
        y = matvec(packed, v3)
        ctx.save_for_backward(y)
        return torch.sum(v3 * y, dim=(-3, -2, -1))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (y,) = ctx.saved_tensors
        return None, ((2.0 / 255.0) * y * g[..., None, None, None]).movedim(
            -3, -1), None


def photoreal_loss(packed: torch.Tensor, img255: torch.Tensor,
                   matvec=None) -> torch.Tensor:
    """Photorealism regularizer Σ_c v_cᵀ·L·v_c on a [0,255] (H, W, 3) image
    (a scalar), or on a batch (B, H, W, 3) ((B,), one matvec launch).

    `packed` is the (14, H, W) plane stack of `laplacian_cuda.pack_stats`
    (for a batch (B, 14, H, W), or one stack shared by the pairs). One
    matvec per call, `matvec(packed, v3)`: by default `lap_matvec` (the
    CUDA kernel on CUDA tensors, the plain path on CPU tensors);
    `laplacian_impl="spmd"` passes a `laplacian_spmd.AmbientMatvec`."""
    if matvec is None:
        # laplacian_cuda imports this module for its plain version
        from .laplacian_cuda import lap_matvec as matvec
    return _Photoreal.apply(packed, img255, matvec)
