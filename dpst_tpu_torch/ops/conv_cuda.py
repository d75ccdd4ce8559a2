"""3×3 SAME convolution of one image: CUDA kernel and plain version.

The port's counterpart of `dpst_tpu/ops/conv_pallas.py`:

    y[co, h, w] = Σ_{dy, dx, ci} x[ci, h + dy − 1, w + dx − 1] · w[co, ci, dy, dx]

x (Cin, H, W) NCHW planes, w (Cout, Cin, 3, 3) OIHW, y (Cout, H, W), all in
the compute dtype; stride 1, zero padding, fp32 accumulation, the output
rounded once to the compute dtype. No bias and no ReLU: `extract_features`
adds them. One kernel serves both directions: the input gradient is
`conv3x3_same(g, flip_transpose_weights(w))`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels


def flip_transpose_weights(w: torch.Tensor) -> torch.Tensor:
    """Weights of the input-gradient conv: rotated 180° spatially, input
    and output channels swapped. ft[ci, co, dy, dx] = w[co, ci, 2 − dy,
    2 − dx]."""
    return w.flip(2, 3).transpose(0, 1).contiguous()


def conv3x3_acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The nine tap matmuls of the TPU kernel, each in fp32 and accumulated
    in fp32 in (dy, dx) order: (Cout, H, W) fp32, not rounded."""
    cin, h, wd = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    acc = torch.zeros((w.shape[0], h * wd), dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + h, dx:dx + wd].reshape(cin, h * wd)
            acc = acc + torch.matmul(w[:, :, dy, dx].float(), tap.float())
    return acc.reshape(-1, h, wd)


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: `conv3x3_acc`, then one cast."""
    return conv3x3_acc(x, w).to(x.dtype)


def conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3×3 conv: (Cin, H, W) × (Cout, Cin, 3, 3) -> (Cout, H, W). CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (csrc/conv3x3.cu)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (Cin, H, W), got {tuple(x.shape)}")
    cin, h, wd = x.shape
    cout = w.shape[0]
    kernels.require(x, "x")
    kernels.require(w, "w", (cout, cin, 3, 3), x.dtype)
    if not kernels.on_cuda(x, w):
        return conv3x3_plain(x, w)
    y = torch.empty((cout, h, wd), dtype=x.dtype, device=x.device)
    rc = kernels.library().dpst_conv3x3(
        kernels.ptr(x), kernels.ptr(w), kernels.ptr(y), cin, cout, h, wd,
        kernels.DTYPE_CODES[x.dtype], kernels.stream_ptr(x))
    kernels.check(rc, "conv3x3")
    kernels.LAUNCHES["conv3x3"] += 1
    return y
