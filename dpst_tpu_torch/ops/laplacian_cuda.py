"""Matting-Laplacian matvec: CUDA kernel, stats packing and plain version.

The port's counterpart of `dpst_tpu/ops/laplacian_pallas.py`. The stats
travel as one (14, H, W) fp32 plane stack in the JAX kernel's plane order
(img×3, μ×3, Λ-sym×6 as 00 01 02 11 12 22, valid, win_count), packed once
per stylization; v and y are (3, H, W) planes.

The kernel (csrc/lap_matvec.cu) walks strips: a warp owns LAP_COLS output
columns and `lap_plan(H, W)` rows, and walks down them a row a step,
carrying the last three rows' horizontal box sums in registers.
"""
from __future__ import annotations

import functools

import torch

from . import kernels
from .laplacian import LaplacianStats, matvec

N_STATS = 14
_SYM = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
LAP_COLS = 30        # output columns of a warp's strip (lanes 1..30)
LAP_WARPS = 4        # strips of a block
_SMS = 132           # streaming multiprocessors of the H100
# resident blocks of the kernel (its launch bounds: 4 blocks an SM)
LAP_SLOTS = 4 * _SMS


@functools.lru_cache(maxsize=None)
def lap_plan(h: int, w: int) -> int:
    """Output rows of a strip. The grid is ceil(ceil(W / LAP_COLS) /
    LAP_WARPS) × ceil(H / rows) blocks; an SM walks its blocks' steps
    (rows + 2 each, the strip's halo rows loaded too) in turns, so the
    time goes as the blocks on the busiest SM × (rows + 4). Among the
    heights that keep two blocks on (nearly) every SM, or as many as the
    image has, the one that costs least, the taller on a tie."""
    bx = -(-(-(-w // LAP_COLS)) // LAP_WARPS)
    floor = min(int(0.95 * 2 * _SMS), bx * h)
    best = None
    for rows in range(1, h + 1):
        blocks = bx * -(-h // rows)
        if blocks < floor:
            break
        cost = (-(-blocks // _SMS) * (rows + 4), -rows)
        if best is None or cost < best[0]:
            best = (cost, rows)
    return best[1]


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
                             kernels.ptr(y), h, w, lap_plan(h, w),
                             kernels.stream_ptr(v3))
    kernels.check(rc, "lap_matvec")
    kernels.LAUNCHES["lap_matvec"] += 1
    return y
