"""Levin's closed-form matting Laplacian over 3×3 windows, matrix-free, in
float64 (Levin, Lischinski and Weiss, "A Closed Form Solution to Natural
Image Matting", 2006, eq. 12; the photorealism term of Luan et al.).

For each window k whose 3×3 pixels all lie in the image,
    L_k[i, j] = δ_ij − (1/9)·(1 + (I_i − μ_k)ᵀ (Σ_k + ε/9·Id)⁻¹ (I_j − μ_k)),
and L = Σ_k L_k. Then, with s_k = Σ_{j∈k} v_j, t_k = Σ_{j∈k} I_j v_j − μ_k s_k
and b_k = Λ_k t_k (Λ_k the inverse above),
    (L v)_i = n_i v_i − (1/9)·Σ_{k∋i} (s_k − μ_kᵀ b_k) − (1/9)·I_iᵀ Σ_{k∋i} b_k,
n_i the number of windows that hold pixel i.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


def _box(x: torch.Tensor) -> torch.Tensor:
    """Sum over each pixel's 3×3 neighbourhood of an (H, W, ...) tensor,
    zero outside the image."""
    h, w = x.shape[:2]
    p = F.pad(x.movedim((0, 1), (-2, -1)), (1, 1, 1, 1)).movedim(
        (-2, -1), (0, 1))
    out = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            out = out + p[dy:dy + h, dx:dx + w]
    return out


class Stats(NamedTuple):
    image: torch.Tensor   # (H, W, 3) float64 in [0, 1]
    mu: torch.Tensor      # (H, W, 3) window means at centres, 0 elsewhere
    lam: torch.Tensor     # (H, W, 3, 3) (Σ + ε/9·Id)⁻¹ at centres, 0 elsewhere
    valid: torch.Tensor   # (H, W) 1 at window centres
    count: torch.Tensor   # (H, W) windows holding each pixel


def stats(content255: torch.Tensor, eps: float) -> Stats:
    """The windows' statistics of an (H, W, 3) content image in [0, 255]."""
    img = content255.to(torch.float64) / 255.0
    h, w, _ = img.shape
    valid = torch.zeros((h, w), dtype=torch.float64, device=img.device)
    valid[1:-1, 1:-1] = 1.0
    mu = _box(img) / 9.0
    second = _box(img[..., :, None] * img[..., None, :]) / 9.0
    cov = second - mu[..., :, None] * mu[..., None, :]
    eye = torch.eye(3, dtype=torch.float64, device=img.device)
    lam = torch.linalg.inv(cov + (eps / 9.0) * eye)
    return Stats(img, mu * valid[..., None], lam * valid[..., None, None],
                 valid, _box(valid))


def matvec(st: Stats, v: torch.Tensor) -> torch.Tensor:
    """L·v for one (H, W) float64 plane."""
    s = _box(v)
    t = _box(st.image * v[..., None]) - st.mu * s[..., None]
    b = torch.einsum("hwij,hwj->hwi", st.lam, t) * st.valid[..., None]
    a = (s - (st.mu * b).sum(-1)) * st.valid
    return (st.count * v - _box(a) / 9.0
            - (st.image * _box(b)).sum(-1) / 9.0)


def photoreal(st: Stats, image255: torch.Tensor
              ) -> tuple[float, torch.Tensor]:
    """Σ_c v_cᵀ L v_c at v = image / 255, and its gradient with respect to
    the [0, 255] image ((H, W, 3) float32)."""
    v = image255.to(torch.float64) / 255.0
    value, grad = 0.0, torch.empty_like(image255, dtype=torch.float32)
    for c in range(3):
        y = matvec(st, v[..., c])
        value += float((v[..., c] * y).sum())
        grad[..., c] = (2.0 / 255.0 * y).to(torch.float32)
    return value, grad
