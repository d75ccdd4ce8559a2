"""Matting-Laplacian matvec: CUDA kernel, stats packing and plain version.

The port's counterpart of `dpst_tpu/ops/laplacian_pallas.py`. The stats
travel as one (14, H, W) fp32 plane stack in the JAX kernel's plane order
(img×3, μ×3, Λ-sym×6 as 00 01 02 11 12 22, valid, win_count), packed once
per stylization; v and y are (3, H, W) planes.
"""
from __future__ import annotations

import torch

from . import kernels
from .laplacian import LaplacianStats, matvec

N_STATS = 14
_SYM = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def pack_stats(stats) -> torch.Tensor:
    """LaplacianStats -> (14, H, W) fp32 plane stack (kernel layout)."""
    img = stats.image.permute(2, 0, 1)
    mu = stats.mu.permute(2, 0, 1)
    lam6 = torch.stack([stats.lam[..., i, j] for i, j in _SYM])
    return torch.cat([img, mu, lam6, stats.valid[None],
                      stats.win_count[None]]).to(torch.float32).contiguous()


def unpack_stats(packed: torch.Tensor):
    """(14, H, W) plane stack -> LaplacianStats (the inverse of pack_stats)."""
    hwc = lambda t: t.permute(1, 2, 0)
    l6 = packed[6:12]
    lam = torch.stack([torch.stack([l6[0], l6[1], l6[2]]),
                       torch.stack([l6[1], l6[3], l6[4]]),
                       torch.stack([l6[2], l6[4], l6[5]])])   # (3, 3, H, W)
    return LaplacianStats(mu=hwc(packed[3:6]), lam=lam.permute(2, 3, 0, 1),
                          valid=packed[12], win_count=packed[13],
                          image=hwc(packed[0:3]))


def lap_matvec_plain(packed: torch.Tensor, v3: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version on the kernel's layout: laplacian.matvec on
    the unpacked stats."""
    y = matvec(unpack_stats(packed), v3.permute(1, 2, 0))
    return y.permute(2, 0, 1).contiguous()


def lap_matvec(packed: torch.Tensor, v3: torch.Tensor) -> torch.Tensor:
    """y = L·v for v3 (3, H, W) fp32. CPU tensors take the plain version;
    CUDA tensors launch the kernel (csrc/lap_matvec.cu)."""
    if packed.dim() != 3 or packed.shape[0] != N_STATS:
        raise ValueError(f"packed stats must be ({N_STATS}, H, W), "
                         f"got {tuple(packed.shape)}")
    _, h, w = packed.shape
    kernels.require(packed, "packed", dtype=torch.float32)
    kernels.require(v3, "v", (3, h, w), torch.float32)
    if not kernels.on_cuda(packed, v3):
        return lap_matvec_plain(packed, v3)
    lib = kernels.library()
    y = torch.empty_like(v3)
    rc = lib.dpst_lap_matvec(kernels.ptr(packed), kernels.ptr(v3),
                             kernels.ptr(y), h, w, kernels.stream_ptr(v3))
    kernels.check(rc, "lap_matvec")
    kernels.LAUNCHES["lap_matvec"] += 1
    return y
