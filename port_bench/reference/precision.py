"""The precision the reference computes its VGG and Gram operands in.

`PLAIN` is float32 throughout: the reference. `FP8` rounds every operand
that the configuration computes in bfloat16 (the conv inputs, weights,
outputs and input gradients, the taps and the Grams' operands) to
float8 e4m3 with one scale a tensor, and computes in float32 from there:
the control, the precision one step below the configuration's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = float(x.abs().max()) if x.numel() else 0.0
    if amax == 0.0:
        return x
    scale = amax / E4M3_MAX
    # e4m3 has no infinity: a value past its range converts to NaN
    q = torch.clamp(x / scale, -E4M3_MAX, E4M3_MAX)
    return q.to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Round(torch.autograd.Function):
    """`_fp8` forward, the gradient passed through as it is: where a
    gradient is rounded, the conv's backward rounds it with a scale of its
    own (autograd would cast it to e4m3 unscaled)."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return g


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the whole tensor (its
    largest magnitude maps to e4m3's largest), back in x's dtype."""
    return _Round.apply(x)


class _Fp8Conv(torch.autograd.Function):
    """SAME 3×3 conv with fp8 operands both ways: the forward's input and
    weights, the input gradient's incoming gradient and weights, and both
    outputs rounded."""

    @staticmethod
    def forward(ctx, x, w):
        wq = _fp8(w)
        ctx.save_for_backward(wq)
        ctx.shape = x.shape
        return _fp8(F.conv2d(_fp8(x), wq, padding=1))

    @staticmethod
    def backward(ctx, g):
        (wq,) = ctx.saved_tensors
        gx = torch.nn.grad.conv2d_input(ctx.shape, wq, _fp8(g), padding=1)
        return _fp8(gx), None


class Precision:
    """How the reference rounds: `round` applies to a tap or a Gram operand,
    `conv` is the SAME 3×3 conv of an (N, C, H, W) batch."""

    def __init__(self, name: str):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "float32" else fp8_round(x)

    def conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return F.conv2d(x, w, padding=1)
        return _Fp8Conv.apply(x, w)


PLAIN = Precision("float32")
FP8 = Precision("fp8")
