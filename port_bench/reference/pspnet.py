"""PSPNet-50 (Zhao et al., "Pyramid Scene Parsing Network", CVPR 2017,
arXiv:1612.01105) as "Automated Deep Photo Style Transfer" (arXiv:1901.03915,
§3) segments with it: ADE20K's 150 classes at a 473² evaluation size, in
plain PyTorch, float32 with TF32 off, the reference that a configuration's
automatic masks are held to.

The network, from the published layer list:

- the "deep base" stem: three 3×3 convs (3 → 64, stride 2; 64 → 64;
  64 → 128), then a 3×3 max pool of stride 2;
- ResNet-50's bottlenecks (1×1 reduce, 3×3, 1×1 expand, each with its
  batch norm; a 1×1 projection on the first block of a stage): res2 3
  blocks of 256, res3 4 of 512 with stride 2 on the first block's 3×3 and
  projection, res4 6 of 1024 with every 3×3 dilated by 2, res5 3 of 2048
  dilated by 4: an output stride of 8 (60² at 473²);
- pyramid pooling over bins 1, 2, 3 and 6: average pools of window and
  stride ⌊h / bin⌋ (Caffe's 60, 30, 20 and 10 at 473²), each a 1×1 conv to
  512 channels, upsampled bilinearly with aligned corners and concatenated
  with the features (4096 channels);
- a 3×3 fuse conv to 512 channels, a 1×1 head to 150 classes, the logits
  upsampled to the input with aligned corners.

Every conv but the head is followed by a ReLU (after the residual sum in a
bottleneck's expand); every conv pads as "SAME" does, lo = total // 2 and
hi the rest (at 473² Caffe's symmetric pad of 1), the max pool with −∞.
Batch norm is folded into one scale and bias a conv. Left out, as
inference leaves them out: the auxiliary res4 branch and the dropout
before the head. The inputs are RGB in [0, 255], less ImageNet's mean
over its deviation.

The resize protocol: the photo squashed to 473² (bilinear, half-pixel,
antialiased), one forward, the logits resized back to the photo's size the
same way, the arg-max over the classes.

`weights` draws He-normal weights from a seed on the device, in one draw,
with batch norm folded to scale 1 and bias 0: the dict that the benchmark
hands the program (`seg_params=`) and that this module runs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference.precision import Precision

CLASSES = 150
EVAL_SIZE = 473
BINS = (1, 2, 3, 6)
PPM_WIDTH = 512
FUSE_WIDTH = 512
MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)
# (name, blocks, width, stride, dilation) of the bottleneck stages
STAGES = (("res2", 3, 256, 1, 1), ("res3", 4, 512, 2, 1),
          ("res4", 6, 1024, 1, 2), ("res5", 3, 2048, 1, 4))


def layers() -> list[tuple[str, int, int, int]]:
    """(name, kernel, Cin, Cout) of every conv, in the order `weights`
    draws them."""
    out = [("stem1", 3, 3, 64), ("stem2", 3, 64, 64), ("stem3", 3, 64, 128)]
    cin = 128
    for name, blocks, width, _, _ in STAGES:
        mid = width // 4
        for b in range(blocks):
            p = f"{name}_{b}"
            out += [(f"{p}_a", 1, cin if b == 0 else width, mid),
                    (f"{p}_b", 3, mid, mid), (f"{p}_c", 1, mid, width)]
            if b == 0:
                out.append((f"{p}_proj", 1, cin, width))
        cin = width
    out += [(f"ppm{b}", 1, cin, PPM_WIDTH) for b in BINS]
    out += [("fuse", 3, cin + PPM_WIDTH * len(BINS), FUSE_WIDTH),
            ("head", 1, FUSE_WIDTH, CLASSES)]
    return out


def weights(seed: int, device) -> dict:
    """{conv: {"w": (Cout, Cin, k, k), "scale": (Cout,), "bias": (Cout,)}}
    float32 on `device`: He-normal weights (std sqrt(2 / (k² Cin))) from one
    draw of a generator seeded with `seed` on the device, scale 1, bias
    0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    specs = layers()
    sizes = [k * k * cin * cout for _, k, cin, cout in specs]
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    params, off = {}, 0
    for (name, k, cin, cout), n in zip(specs, sizes):
        w = flat[off:off + n].view(cout, cin, k, k) * math.sqrt(
            2.0 / (k * k * cin))
        params[name] = {
            "w": w.contiguous(),
            "scale": torch.ones(cout, dtype=torch.float32, device=device),
            "bias": torch.zeros(cout, dtype=torch.float32, device=device)}
        off += n
    return params


def _same(n: int, k: int, stride: int, dilation: int) -> tuple[int, int]:
    reach = (k - 1) * dilation + 1
    out = -(-n // stride)
    total = max((out - 1) * stride + reach - n, 0)
    return total // 2, total - total // 2


def _pad(x: torch.Tensor, k: int, stride: int = 1, dilation: int = 1,
         value: float = 0.0) -> torch.Tensor:
    (t, b), (l, r) = (_same(n, k, stride, dilation) for n in x.shape[2:])
    return F.pad(x, (l, r, t, b), value=value)


def _conv(params: dict, name: str, x: torch.Tensor, prec: Precision,
          stride: int = 1, dilation: int = 1, relu: bool = True
          ) -> torch.Tensor:
    """conv, folded batch norm, ReLU; the conv's input, weights and output
    rounded by `prec` (the operands the program computes in bf16)."""
    p = params[name]
    k = p["w"].shape[-1]
    y = prec.round(F.conv2d(prec.round(_pad(x, k, stride, dilation)),
                            prec.round(p["w"]), stride=stride,
                            dilation=dilation))
    y = y * p["scale"][:, None, None] + p["bias"][:, None, None]
    return torch.relu(y) if relu else y


def _upsample_aligned(x: torch.Tensor, hw) -> torch.Tensor:
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=True)


@torch.no_grad()
def logits(params: dict, images: torch.Tensor, prec: Precision
           ) -> torch.Tensor:
    """(n, H, W, 3) RGB in [0, 255] -> (n, 150, H, W) float32 logits."""
    mean = torch.tensor(MEAN, device=images.device)
    std = torch.tensor(STD, device=images.device)
    x = ((images.float() - mean) / std).permute(0, 3, 1, 2)
    x = _conv(params, "stem1", x, prec, stride=2)
    x = _conv(params, "stem2", x, prec)
    x = _conv(params, "stem3", x, prec)
    x = F.max_pool2d(_pad(x, 3, 2, value=-math.inf), 3, 2)
    for name, blocks, _, stride, dilation in STAGES:
        for b in range(blocks):
            p = f"{name}_{b}"
            s = stride if b == 0 else 1
            y = _conv(params, f"{p}_a", x, prec)
            y = _conv(params, f"{p}_b", y, prec, stride=s, dilation=dilation)
            y = _conv(params, f"{p}_c", y, prec, relu=False)
            short = (_conv(params, f"{p}_proj", x, prec, stride=s,
                           relu=False) if b == 0 else x)
            x = torch.relu(y + short)
    h, w = x.shape[2:]
    branches = [x]
    for b in BINS:
        window = (h // b, w // b)
        pooled = F.avg_pool2d(x, window, stride=window)
        branches.append(_upsample_aligned(
            _conv(params, f"ppm{b}", pooled, prec), (h, w)))
    x = _conv(params, "fuse", torch.cat(branches, 1), prec)
    z = _conv(params, "head", x, prec, relu=False)
    return _upsample_aligned(z, images.shape[1:3])


def _resize(x: torch.Tensor, hw) -> torch.Tensor:
    """Half-pixel bilinear resize of (n, C, h, w), antialiased."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=True)


@torch.no_grad()
def labels(params: dict, image: torch.Tensor, prec: Precision,
           eval_size: int = EVAL_SIZE) -> torch.Tensor:
    """The resize protocol: (H, W, 3) RGB in [0, 255] -> (H, W) int64
    ADE20K class ids."""
    hw = image.shape[:2]
    x = _resize(image.float().permute(2, 0, 1)[None],
                (eval_size, eval_size)).permute(0, 2, 3, 1)
    z = _resize(logits(params, x, prec), hw)
    return z[0].argmax(0)
