"""Matting-Laplacian matvec: CUDA kernel, stats packing and plain version.

The port's counterpart of `dpst_tpu/ops/laplacian_pallas.py`. The stats
travel as one (14, H, W) fp32 plane stack in the JAX kernel's plane order
(img×3, μ×3, Λ-sym×6 as 00 01 02 11 12 22, valid, win_count), packed once
per stylization; v and y are (3, H, W) planes.

The kernel (csrc/lap_matvec.cu) walks strips: a warp owns LAP_COLS output
columns and `lap_plan(H, W, B)` rows, and walks down them a row a step,
carrying the last three rows' horizontal box sums in registers. A batch of
B pairs, v (B, 3, H, W), is one launch with the pair as the grid's third
index; its stats are a (B, 14, H, W) stack, or one (14, H, W) stack that
every pair shares (read with a pair stride of 0, never copied).
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
def lap_plan(h: int, w: int, b: int = 1) -> int:
    """Output rows of a strip. The grid is ceil(ceil(W / LAP_COLS) /
    LAP_WARPS) × ceil(H / rows) × B blocks; an SM walks its blocks' steps
    (rows + 2 each, the strip's halo rows loaded too) in turns, so the
    time goes as the blocks on the busiest SM × (rows + 4). Among the
    heights that keep two blocks on (nearly) every SM, or as many as the
    B images have, the one that costs least, the taller on a tie: B pairs
    fill the SMs with taller strips, and fewer halo rows."""
    bx = b * -(-(-(-w // LAP_COLS)) // LAP_WARPS)
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
    the unpacked stats; a batch pair by pair (a (14, H, W) stack serves
    every pair)."""
    def one(packed, v3):
        y = matvec(unpack_stats(packed), v3.permute(1, 2, 0))
        return y.permute(2, 0, 1).contiguous()

    if v3.dim() == 3:
        return one(packed, v3)
    return torch.stack([one(packed if packed.dim() == 3 else packed[i],
                            v3[i]) for i in range(v3.shape[0])])


def _pair_stride(packed: torch.Tensor, b: int) -> int:
    """Floats from one pair's stats to the next's: 0 for one (14, H, W)
    stack, or a (B, 14, H, W) stack expanded from one (stride 0); else the
    stack must be contiguous."""
    if packed.dim() == 3:
        kernels.require(packed, "packed", dtype=torch.float32)
        return 0
    if packed.shape[0] != b:
        raise ValueError(f"packed stats for {packed.shape[0]} pairs, v for "
                         f"{b}")
    if packed.stride(0) == 0:
        kernels.require(packed[0], "packed", dtype=torch.float32)
        return 0
    kernels.require(packed, "packed", dtype=torch.float32)
    return packed.stride(0)


def lap_matvec(packed: torch.Tensor, v3: torch.Tensor) -> torch.Tensor:
    """y = L·v for v3 (3, H, W) or a batch (B, 3, H, W), fp32, with the
    stats (14, H, W) (shared by a batch's pairs) or (B, 14, H, W). CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (csrc/lap_matvec.cu), once for all pairs."""
    if packed.dim() not in (3, 4) or packed.shape[-3] != N_STATS:
        raise ValueError(f"packed stats must be ([B,] {N_STATS}, H, W), "
                         f"got {tuple(packed.shape)}")
    h, w = packed.shape[-2:]
    if v3.dim() not in (3, 4) or (v3.dim() == 3 and packed.dim() == 4):
        raise ValueError(f"v must be (3, H, W) or (B, 3, H, W), got "
                         f"{tuple(v3.shape)} with stats "
                         f"{tuple(packed.shape)}")
    b = v3.shape[0] if v3.dim() == 4 else 1
    kernels.require(v3, "v", (*v3.shape[:-3], 3, h, w), torch.float32)
    spair = _pair_stride(packed, b)
    if not kernels.on_cuda(packed, v3):
        return lap_matvec_plain(packed, v3)
    lib = kernels.library()
    y = torch.empty_like(v3)
    rc = lib.dpst_lap_matvec(kernels.ptr(packed), kernels.ptr(v3),
                             kernels.ptr(y), h, w, lap_plan(h, w, b), b,
                             spair, kernels.stream_ptr(v3))
    kernels.check(rc, "lap_matvec")
    kernels.LAUNCHES["lap_matvec"] += 1
    return y
