"""Image metrics: SSIM and PSNR, the counterpart of
`dpst_tpu/ops/metrics.py` (Wang et al. 2004 with the 11×11 Gaussian window
of σ = 1.5 and VALID windows, as skimage's `structural_similarity(...,
gaussian_weights=True, use_sample_covariance=False)` for [0, 255] images).

The blur is separable shifted sums in fp32 (no cuDNN convolution, so no
TF32 on the card), with the window computed on the CPU so that both
devices use the same taps.
"""
from __future__ import annotations

import torch

_K1, _K2 = 0.01, 0.03
_SIGMA = 1.5
_RADIUS = 5  # 11×11 window


def _gaussian_kernel() -> torch.Tensor:
    x = torch.arange(-_RADIUS, _RADIUS + 1, dtype=torch.float32)
    g = torch.exp(-(x * x) / torch.tensor(2.0 * _SIGMA ** 2))
    return g / torch.sum(g)


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian filter over (H, W, C), VALID windows: along H,
    then along W, each a sum of the taps in order."""
    g = _gaussian_kernel().tolist()
    k = 2 * _RADIUS + 1
    h, w = x.shape[:2]
    y = sum((x[i:i + h - k + 1] * g[i] for i in range(1, k)), x[0:h - k + 1]
            * g[0])
    return sum((y[:, i:i + w - k + 1] * g[i] for i in range(1, k)),
               y[:, 0:w - k + 1] * g[0])


def _as_f32(a, device=None) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def ssim(a, b, data_range: float = 255.0) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) or (H, W) image pair (tensors or
    arrays; the result on `a`'s device)."""
    a = _as_f32(a)
    b = _as_f32(b, a.device)
    if a.dim() == 2:
        a, b = a[..., None], b[..., None]
    c1 = (_K1 * data_range) ** 2
    c2 = (_K2 * data_range) ** 2
    mu_a, mu_b = _blur(a), _blur(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a = _blur(a * a) - mu_aa
    var_b = _blur(b * b) - mu_bb
    cov = _blur(a * b) - mu_ab
    num = (2.0 * mu_ab + c1) * (2.0 * cov + c2)
    den = (mu_aa + mu_bb + c1) * (var_a + var_b + c2)
    return torch.mean(num / den)


def psnr(a, b, data_range: float = 255.0) -> torch.Tensor:
    a = _as_f32(a)
    b = _as_f32(b, a.device)
    mse = torch.clamp(torch.mean((a - b) ** 2), min=1e-12)
    peak = torch.full((), data_range ** 2, device=a.device)
    return 10.0 * torch.log10(peak / mse)
