"""The VGG's bias add and ReLU, forward and backward: CUDA kernels and
plain versions.

    forward   y = max(z + b_c, 0)
    backward  dz = g where z + b_c > 0, g · ½ where it is exactly 0, else 0

z is a conv's raw output, (N, C, H, W) or (C, H, W), and b its (C,) bias,
in one dtype; z + b_c is rounded to that dtype before the ReLU, and the
backward recomputes it from z and b. relu′(0) = ½ is the subgradient of the
JAX package's `jnp.maximum(x, 0)` (torch.relu's backward gives 0). The
plain versions are the composite of ATen ops the kernels replace, and the
kernels (csrc/bias_relu.cu) equal them bit for bit.

A z that lies channels_last (`kernels.channels_last`: the VGG's
activations on the card's bf16 cuDNN route) takes the NHWC form of each
kernel, which indexes the bias by the fastest dimension and returns y or dz
channels_last; the plain versions keep z's layout too. Any other layout of
z takes the NCHW form, on a contiguous z.
"""
from __future__ import annotations

import torch

from . import kernels


def bias_relu_fwd_plain(z: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward."""
    return torch.clamp_min(z + b[:, None, None], 0)


def bias_relu_bwd_plain(z: torch.Tensor, b: torch.Tensor,
                        g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward."""
    a = z + b[:, None, None]
    return torch.where(a > 0, g, torch.where(a == 0, g * 0.5,
                                             torch.zeros_like(g)))


def _check_nhwc(z: torch.Tensor, b: torch.Tensor, *others) -> None:
    """Validate the NHWC form's operands: z and the others channels_last
    alike, b (C,) in z's dtype."""
    hwc = z.movedim(-3, -1)
    kernels.require(hwc, "z")
    kernels.require(b, "b", (z.shape[-3],), z.dtype)
    for name, t in others:
        if not t.movedim(-3, -1).is_contiguous():
            raise ValueError(f"{name}: must lie channels_last, as z does")
        kernels.require(t.movedim(-3, -1), name, hwc.shape, z.dtype)


def _planes(z: torch.Tensor, b: torch.Tensor, *others) -> tuple:
    """Validate the operands; return (planes, C, H·W) of z."""
    if z.dim() not in (3, 4):
        raise ValueError("z must be (C, H, W) or (N, C, H, W), got "
                         f"{tuple(z.shape)}")
    c, hw = z.shape[-3], z.shape[-2] * z.shape[-1]
    kernels.require(z, "z")
    kernels.require(b, "b", (c,), z.dtype)
    for name, t in others:
        kernels.require(t, name, z.shape, z.dtype)
    return z.numel() // max(hw, 1), c, hw


def bias_relu_fwd(z: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max(z + b_c, 0). CPU tensors take the plain version; CUDA tensors
    launch the kernel (`dpst_bias_relu_fwd`, or `dpst_bias_relu_fwd_nhwc`
    for a channels_last z)."""
    if kernels.channels_last(z):
        _check_nhwc(z, b)
        if not kernels.on_cuda(z, b):
            return bias_relu_fwd_plain(z, b)
        y = torch.empty_like(z)
        rc = kernels.library().dpst_bias_relu_fwd_nhwc(
            kernels.ptr(z), kernels.ptr(b), kernels.ptr(y), z.numel(),
            z.shape[-3], kernels.DTYPE_CODES[z.dtype], kernels.stream_ptr(z))
        kernels.check(rc, "bias_relu_fwd_nhwc")
        kernels.LAUNCHES["bias_relu_fwd_nhwc"] += 1
        return y
    planes, c, hw = _planes(z, b)
    if not kernels.on_cuda(z, b):
        return bias_relu_fwd_plain(z, b)
    y = torch.empty_like(z)
    rc = kernels.library().dpst_bias_relu_fwd(
        kernels.ptr(z), kernels.ptr(b), kernels.ptr(y), planes, c, hw,
        kernels.DTYPE_CODES[z.dtype], kernels.stream_ptr(z))
    kernels.check(rc, "bias_relu_fwd")
    kernels.LAUNCHES["bias_relu_fwd"] += 1
    return y


def bias_relu_bwd(z: torch.Tensor, b: torch.Tensor,
                  g: torch.Tensor) -> torch.Tensor:
    """The gradient of bias_relu_fwd w.r.t. z, given the cotangent g of its
    output. CPU tensors take the plain version; CUDA tensors launch the
    kernel (`dpst_bias_relu_bwd`, or `dpst_bias_relu_bwd_nhwc` for a
    channels_last z, whose g must lie as z does)."""
    if kernels.channels_last(z):
        _check_nhwc(z, b, ("g", g))
        if not kernels.on_cuda(z, b, g):
            return bias_relu_bwd_plain(z, b, g)
        dz = torch.empty_like(z)
        rc = kernels.library().dpst_bias_relu_bwd_nhwc(
            kernels.ptr(z), kernels.ptr(b), kernels.ptr(g), kernels.ptr(dz),
            z.numel(), z.shape[-3], kernels.DTYPE_CODES[z.dtype],
            kernels.stream_ptr(z))
        kernels.check(rc, "bias_relu_bwd_nhwc")
        kernels.LAUNCHES["bias_relu_bwd_nhwc"] += 1
        return dz
    planes, c, hw = _planes(z, b, ("g", g))
    if not kernels.on_cuda(z, b, g):
        return bias_relu_bwd_plain(z, b, g)
    dz = torch.empty_like(z)
    rc = kernels.library().dpst_bias_relu_bwd(
        kernels.ptr(z), kernels.ptr(b), kernels.ptr(g), kernels.ptr(dz),
        planes, c, hw, kernels.DTYPE_CODES[z.dtype], kernels.stream_ptr(z))
    kernels.check(rc, "bias_relu_bwd")
    kernels.LAUNCHES["bias_relu_bwd"] += 1
    return dz
