"""Color guided filter: the smooth-local-affine post-process.

The counterpart of `dpst_tpu/ops/guided_filter.py`: He et al.'s color
guided filter fits, in every (2r+1)² window, the affine model from the
content photo (the [0, 1] RGB guide I) to the stylization (the signal p),

    A_k = (Σ_k + ε·Id)⁻¹ · cov_k(I, p),   b_k = p̄_k − A_kᵀ·μ_k,
    q_i = Ā_iᵀ·I_i + b̄_i                 (the window-averaged model),

with border-aware window counts. Plain PyTorch, no kernel of its own (the
JAX package keeps it in XLA too), and fp32 whatever `compute_dtype` says:
ε ~ 1e-4 makes the inversion sensitive to the cancellation in
corr − μ². So the window sums are shifted adds in `reduce_window`'s order
(no cuDNN convolution, no TF32), the 3-vector algebra is elementwise (no
matmul), and every division is one rounding on the CPU and on the card
alike (torch divides a CUDA tensor by a Python scalar through the
reciprocal).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .laplacian import _sym3_inv
from .laplacian import exact_div as _div


def _box(x: torch.Tensor, r: int) -> torch.Tensor:
    """(2r+1)² window sums over the leading two axes of (H, W, C), zero
    padded ("SAME"), each window summed row by row, left to right."""
    h, w = x.shape[:2]
    xp = F.pad(x, (0, 0, r, r, r, r))
    acc = None
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            s = xp[dy:dy + h, dx:dx + w]
            acc = s.clone() if acc is None else acc + s
    return acc


def _box_counts(h: int, w: int, r: int, device=None) -> torch.Tensor:
    """Border-aware window pixel counts, (H, W, 1) fp32: a window at i
    holds min(i, r) + 1 + min(n−1−i, r) pixels along an axis."""
    def axis_counts(n: int) -> torch.Tensor:
        i = torch.arange(n, dtype=torch.float32, device=device)
        return torch.clamp(i, max=r) + 1.0 + torch.clamp(n - 1 - i, max=r)
    return (axis_counts(h)[:, None] * axis_counts(w)[None, :])[..., None]


def _matvec3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Σ_j m[..., i, j] · v[..., j, c] for (..., 3, 3) m, (..., 3, C) v."""
    return ((m[..., :, 0, None] * v[..., 0, None, :]
             + m[..., :, 1, None] * v[..., 1, None, :])
            + m[..., :, 2, None] * v[..., 2, None, :])


def _dot3(u: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Σ_i u[..., i] · a[..., i, c] for (..., 3) u, (..., 3, C) a."""
    return ((u[..., 0, None] * a[..., 0, :] + u[..., 1, None] * a[..., 1, :])
            + u[..., 2, None] * a[..., 2, :])


def guided_filter(guide: torch.Tensor, src: torch.Tensor, radius: int = 2,
                  eps: float = 1e-4) -> torch.Tensor:
    """Edge-preserving smoothing of `src` (H, W, C), any range, guided by
    `guide` (H, W, 3) in [0, 1]; `radius` and the ridge `eps` as in the
    JAX package."""
    guide = guide.to(torch.float32)
    src = src.to(torch.float32)
    h, w, _ = guide.shape
    c = src.shape[-1]

    n = _box_counts(h, w, radius, guide.device)
    mu = _div(_box(guide, radius), n)                          # (H,W,3)
    pbar = _div(_box(src, radius), n)                          # (H,W,C)

    ii = guide[..., :, None] * guide[..., None, :]             # (H,W,3,3)
    corr_ii = _div(_box(ii.reshape(h, w, 9), radius).reshape(h, w, 3, 3),
                   n[..., None])
    cov_ii = corr_ii - mu[..., :, None] * mu[..., None, :]
    ip = guide[..., :, None] * src[..., None, :]               # (H,W,3,C)
    corr_ip = _div(_box(ip.reshape(h, w, 3 * c), radius).reshape(h, w, 3, c),
                   n[..., None])
    cov_ip = corr_ip - mu[..., :, None] * pbar[..., None, :]

    eye = torch.eye(3, dtype=torch.float32, device=guide.device)
    lam = _sym3_inv(cov_ii + eps * eye)
    a = _matvec3(lam, cov_ip)                                  # (H,W,3,C)
    b = pbar - _dot3(mu, a)                                    # (H,W,C)

    a_bar = _div(_box(a.reshape(h, w, 3 * c), radius).reshape(h, w, 3, c),
                 n[..., None])
    b_bar = _div(_box(b, radius), n)
    return _dot3(guide, a_bar) + b_bar


def smooth_local_affine(content: torch.Tensor, stylized: torch.Tensor,
                        radius: int = 2, eps: float = 1e-4) -> torch.Tensor:
    """The photorealism post-process: the stylization re-expressed as a
    smoothed local affine function of the content photo. content and
    stylized are (H, W, 3) [0, 255] RGB; the result is clipped to
    [0, 255]."""
    out = guided_filter(_div(content.to(torch.float32), 255.0),
                        _div(stylized.to(torch.float32), 255.0),
                        radius=radius, eps=eps)
    return torch.clamp(out * 255.0, 0.0, 255.0)
