"""Tie-splitting 2×2/2 max-pool backward: CUDA kernel and plain version.

The port's counterpart of `dpst_tpu/ops/pool_pallas.py`. Inside each 2×2
window, mask = (x == y), ties = Σ mask and gx = mask · (g / max(ties, 1)):
the cotangent is split equally among tied maxima, where PyTorch's own
max-pool backward gives all of it to the first tie. An odd trailing row or
column never entered the pool and gets 0.

Layout: one image's NCHW planes, x (C, H, W), y and g (C, H//2, W//2).
"""
from __future__ import annotations

import torch

from . import kernels


def maxpool2_bwd_plain(x: torch.Tensor, y: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, in the pool's dtype."""
    c, h, w = x.shape
    h2, w2 = h // 2, w // 2
    xc = x[:, :2 * h2, :2 * w2]
    up = lambda t: t.repeat_interleave(2, 1).repeat_interleave(2, 2)
    mask = (xc == up(y)).to(g.dtype)
    ties = mask.reshape(c, h2, 2, w2, 2).sum(dim=(2, 4))
    gx = mask * up(g / ties.clamp_min(1))
    if (h, w) != (2 * h2, 2 * w2):
        gx = torch.nn.functional.pad(gx, (0, w - 2 * w2, 0, h - 2 * h2))
    return gx


def maxpool2_bwd(x: torch.Tensor, y: torch.Tensor,
                 g: torch.Tensor) -> torch.Tensor:
    """Gradient of the 2×2/2 max pool w.r.t. x. CPU tensors take the plain
    version; CUDA tensors launch the kernel (csrc/pool_bwd.cu)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (C, H, W), got {tuple(x.shape)}")
    c, h, w = x.shape
    pooled = (c, h // 2, w // 2)
    kernels.require(x, "x")
    kernels.require(y, "y", pooled, x.dtype)
    kernels.require(g, "g", pooled, x.dtype)
    if not kernels.on_cuda(x, y, g):
        return maxpool2_bwd_plain(x, y, g)
    lib = kernels.library()
    gx = torch.empty_like(x)
    rc = lib.dpst_pool2_bwd(
        kernels.ptr(x), kernels.ptr(y), kernels.ptr(g), kernels.ptr(gx),
        c, h, w, kernels.DTYPE_CODES[x.dtype], kernels.stream_ptr(x))
    kernels.check(rc, "pool_bwd")
    kernels.LAUNCHES["pool_bwd"] += 1
    return gx
