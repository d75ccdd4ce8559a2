"""PSPNet-50 semantic segmentation (dilated ResNet-50 + pyramid pooling).

The port's counterpart of `dpst_tpu/models/pspnet.py` ("Pyramid Scene
Parsing Network", Zhao et al., CVPR 2017): a ResNet-v1c stem (three 3×3
convs), res2-res5 bottleneck stages with res4/res5 dilated 2 and 4 (output
stride 8), pyramid pooling over (1, 2, 3, 6) bins, the fuse conv and a
150-way ADE20K classifier upsampled to the input size. Inference only:
batch norms are folded into one scale and bias per conv.

The convs run on cuDNN (`F.conv2d`, NCHW) in the compute dtype, scale and
bias in that dtype, the head's logits in fp32; every conv and the stem's
max pool pad as XLA's "SAME" does (lo = total // 2, hi = the rest, which is
asymmetric for stride 2 at even sizes), with explicit `F.pad`. On CUDA the
convs run with `vgg.set_exact_backends`, so a rerun repeats the label maps
bit for bit. Each forward of `segment` and `segment_batch` is a
`runtime.timed("pspnet", ...)` block, which `segmentation` counts and times.

Weights: `weights/pspnet50_ade20k.npz` ($DPST_PSPNET_WEIGHTS) in the JAX
package's bundle format if present, else a seeded He init; the
architecture is exact either way. `params_from_numpy` carries the JAX
package's parameters across (HWIO -> OIHW).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kernels import torch_dtype
from ..ops.resize import resize_image
from ..utils import assets, runtime
from .vgg import set_exact_backends

N_CLASSES = 150
EVAL_SIZE = 473                  # PSPNet ADE20K crop size
BASE_SIZE = 512                  # semseg ADE20K eval base (long side)
PPM_BINS = (1, 2, 3, 6)
# ImageNet means/std (RGB) of PSPNet's preprocessing
RGB_MEAN = (123.675, 116.28, 103.53)
RGB_STD = (58.395, 57.12, 57.375)

# (blocks, out_channels, stride, dilation) per stage
STAGES = ((3, 256, 1, 1), (4, 512, 2, 1), (6, 1024, 1, 2), (3, 2048, 1, 4))


def _conv_spec():
    """Every (name, kh, kw, cin, cout) conv of the network."""
    specs = [("stem1", 3, 3, 3, 64), ("stem2", 3, 3, 64, 64),
             ("stem3", 3, 3, 64, 128)]
    cin = 128
    for si, (blocks, cout, _stride, _dil) in enumerate(STAGES):
        mid = cout // 4
        for b in range(blocks):
            p = f"res{si + 2}_{b}"
            specs += [(f"{p}_a", 1, 1, cin if b == 0 else cout, mid),
                      (f"{p}_b", 3, 3, mid, mid),
                      (f"{p}_c", 1, 1, mid, cout)]
            if b == 0:
                specs.append((f"{p}_proj", 1, 1, cin, cout))
        cin = cout
    for bin_ in PPM_BINS:
        specs.append((f"ppm{bin_}", 1, 1, 2048, 512))
    specs += [("fuse", 3, 3, 2048 + 512 * len(PPM_BINS), 512),
              ("head", 1, 1, 512, N_CLASSES)]
    return specs


CONV_SPECS = _conv_spec()


def init_params(seed: int = 0, generator: torch.Generator | None = None,
                device=None) -> dict:
    """He-normal init from a seeded torch.Generator (on the CPU, then moved
    to `device`); BN folded to scale 1, bias 0. Not the JAX package's bits:
    its init draws from JAX's PRNG."""
    gen = generator if generator is not None else torch.Generator(
        ).manual_seed(seed)
    params = {}
    for name, kh, kw, cin, cout in CONV_SPECS:
        w = torch.randn((cout, cin, kh, kw), generator=gen,
                        dtype=torch.float32) * float(
                            np.sqrt(2.0 / (kh * kw * cin)))
        params[name] = {
            "w": w.to(device),
            "scale": torch.ones(cout, dtype=torch.float32, device=device),
            "bias": torch.zeros(cout, dtype=torch.float32, device=device)}
    return params


def params_from_numpy(params: dict, device=None) -> dict:
    """Weight bridge: {name: {"w": HWIO, "scale": (Cout,), "bias": (Cout,)}}
    (the JAX package's layout, as numpy arrays) -> the same dict with OIHW
    fp32 tensors on `device`."""
    out = {}
    for name, kh, kw, cin, cout in CONV_SPECS:
        w = np.asarray(params[name]["w"], np.float32)
        scale = np.asarray(params[name]["scale"], np.float32)
        bias = np.asarray(params[name]["bias"], np.float32)
        if (w.shape != (kh, kw, cin, cout) or scale.shape != (cout,)
                or bias.shape != (cout,)):
            raise ValueError(f"{name}: bad shape {w.shape}")
        out[name] = {
            "w": torch.from_numpy(np.ascontiguousarray(
                w.transpose(3, 2, 0, 1))).to(device),
            "scale": torch.from_numpy(scale.copy()).to(device),
            "bias": torch.from_numpy(bias.copy()).to(device)}
    return out


def load_params(path: str, device=None) -> dict:
    """`.npz` bundle with keys `<name>_w` (HWIO), `<name>_scale` and
    `<name>_bias` (BN pre-folded) -- the JAX package's bundle format."""
    data = np.load(path)
    return params_from_numpy(
        {name: {k: data[f"{name}_{k}"] for k in ("w", "scale", "bias")}
         for name, *_ in CONV_SPECS}, device)


def get_params(weights_path: str | None = None, seed: int = 0,
               device=None) -> dict:
    """ADE20K weights if a bundle exists (`utils.assets.bundle_path`:
    $DPST_PSPNET_WEIGHTS or weights/pspnet50_ade20k.npz), else the seeded
    random init."""
    if weights_path is None:
        weights_path = assets.bundle_path("pspnet50_ade20k")
    if weights_path and os.path.exists(weights_path):
        return load_params(weights_path, device)
    return init_params(seed, device=device)


def same_pads(n: int, k: int, stride: int = 1, dilation: int = 1
              ) -> tuple[int, int]:
    """XLA's "SAME" padding of one axis of size n: out = ceil(n / stride),
    the total pad split as lo = total // 2, hi = the rest."""
    k_eff = (k - 1) * dilation + 1
    out = -(-n // stride)
    total = max((out - 1) * stride + k_eff - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int = 1, dilation: int = 1,
              value: float = 0.0) -> torch.Tensor:
    ph = same_pads(x.shape[2], k, stride, dilation)
    pw = same_pads(x.shape[3], k, stride, dilation)
    if ph == pw == (0, 0):
        return x
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def _resize_align_corners(x: torch.Tensor, out_hw: tuple[int, int]
                          ) -> torch.Tensor:
    """Bilinear resize of (B, C, h, w) with align_corners=True in fp32, back
    in x's dtype: the checkpoint lineage's upsampling of the PPM branches
    and the logits (a 1×1 input broadcasts)."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    return F.interpolate(x.float(), size=tuple(out_hw), mode="bilinear",
                         align_corners=True).to(x.dtype)


def _conv(params, name, x, stride=1, dilation=1, relu=True):
    p = params[name]
    w = p["w"].to(x.dtype)
    y = F.conv2d(_pad_same(x, w.shape[2], stride, dilation), w,
                 stride=stride, dilation=dilation)
    y = (y * p["scale"].to(y.dtype)[:, None, None]
         + p["bias"].to(y.dtype)[:, None, None])
    return torch.clamp_min(y, 0.0) if relu else y


def _bottleneck(params, prefix, x, mid_stride, dilation, project):
    shortcut = x
    y = _conv(params, f"{prefix}_a", x)
    y = _conv(params, f"{prefix}_b", y, stride=mid_stride, dilation=dilation)
    y = _conv(params, f"{prefix}_c", y, relu=False)
    if project:
        shortcut = _conv(params, f"{prefix}_proj", x, stride=mid_stride,
                         relu=False)
    return torch.clamp_min(y + shortcut, 0.0)


def _forward(params: dict, images: torch.Tensor, compute_dtype,
             taps: dict | None = None) -> torch.Tensor:
    """(B, H, W, 3) float [0, 255] RGB -> (B, 150, H, W) fp32 logits;
    with `taps`, fills it with the per-stage activations (B, C, h, w)."""
    cdt = torch_dtype(compute_dtype)
    if images.device.type == "cuda":
        set_exact_backends(cdt)
    mean = torch.tensor(RGB_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(RGB_STD, dtype=torch.float32, device=images.device)
    x = ((images.to(torch.float32) - mean) / std).to(cdt)
    x = x.permute(0, 3, 1, 2).contiguous()
    taps = {} if taps is None else taps

    x = _conv(params, "stem1", x, stride=2)
    x = _conv(params, "stem2", x)
    x = _conv(params, "stem3", x)
    x = F.max_pool2d(_pad_same(x, 3, 2, value=-float("inf")), 3, 2)
    taps["stem"] = x

    for si, (blocks, _cout, stride, dilation) in enumerate(STAGES):
        for b in range(blocks):
            x = _bottleneck(params, f"res{si + 2}_{b}", x,
                            mid_stride=stride if b == 0 else 1,
                            dilation=dilation, project=(b == 0))
        taps[f"res{si + 2}"] = x

    # pyramid pooling: VALID sum windows of h // bin, divided in the
    # feature dtype, then upsampled with align_corners=True
    feat = x
    bsz, c, h, w = feat.shape
    pooled = [feat]
    for bin_ in PPM_BINS:
        kh, kw = h // bin_, w // bin_
        nh, nw = h // kh, w // kw
        p = feat[:, :, :nh * kh, :nw * kw].reshape(
            bsz, c, nh, kh, nw, kw).sum(dim=(3, 5))
        p = p / torch.tensor(kh * kw, dtype=feat.dtype, device=feat.device)
        p = _conv(params, f"ppm{bin_}", p)
        pooled.append(_resize_align_corners(p.float(), (h, w)).to(feat.dtype))
    x = torch.cat(pooled, dim=1)
    taps["ppm"] = x
    x = _conv(params, "fuse", x)
    taps["fuse"] = x
    logits = _conv(params, "head", x, relu=False).to(torch.float32)
    taps["logits"] = logits
    return _resize_align_corners(logits, tuple(images.shape[1:3]))


def forward(params: dict, images: torch.Tensor,
            compute_dtype="bfloat16", return_taps: bool = False):
    """(B, H, W, 3) float [0,255] RGB -> (B, H, W, 150) fp32 logits (the
    JAX package's layout). With `return_taps=True` also returns the
    per-stage activations {stem, res2..res5, ppm, fuse, logits} as
    (B, C, h, w) tensors."""
    taps = {} if return_taps else None
    out = _forward(params, images, compute_dtype, taps).permute(0, 2, 3, 1)
    return (out, taps) if return_taps else out


def _bilinear(x: torch.Tensor, hw: tuple[int, int],
                   antialias: bool) -> torch.Tensor:
    """Half-pixel bilinear resize of (B, C, h, w) fp32 scores."""
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=antialias)


def _scale_process(params: dict, image: torch.Tensor,
                   compute_dtype="bfloat16", flip: bool = True,
                   crop: int = EVAL_SIZE) -> torch.Tensor:
    """Sliding-window inference at one (already scaled) size, the
    semseg-lineage eval protocol: mean-pad to at least crop², crop² windows
    at a stride of ceil(2/3 · crop), per-window fp32 softmax probabilities
    averaged with the mirrored window's, overlap-count normalization. Every
    window and its mirror go through one batched forward. (h, w, 3)
    [0, 255] RGB -> (150, h, w) fp32 probabilities."""
    h, w = image.shape[:2]
    pad_h, pad_w = max(crop - h, 0), max(crop - w, 0)
    ph0, pw0 = pad_h // 2, pad_w // 2
    nh, nw = h + pad_h, w + pad_w
    mean = torch.tensor(RGB_MEAN, dtype=torch.float32, device=image.device)
    padded = mean.expand(nh, nw, 3).clone()
    padded[ph0:ph0 + h, pw0:pw0 + w] = image.to(torch.float32)

    stride = int(np.ceil(crop * 2.0 / 3.0))
    gh = int(np.ceil(max(nh - crop, 0) / stride)) + 1
    gw = int(np.ceil(max(nw - crop, 0) / stride)) + 1
    origins = [(min(i * stride, nh - crop), min(j * stride, nw - crop))
               for i in range(gh) for j in range(gw)]

    crops = torch.stack([padded[sh:sh + crop, sw:sw + crop]
                         for sh, sw in origins])
    batch = torch.cat([crops, crops.flip(2)]) if flip else crops
    with runtime.timed("pspnet", batch):
        logits = _forward(params, batch, compute_dtype)
    probs = torch.softmax(logits, dim=1)
    if flip:
        n = len(origins)
        probs = 0.5 * (probs[:n] + probs[n:].flip(3))

    canvas = torch.zeros((N_CLASSES, nh, nw), dtype=torch.float32,
                         device=image.device)
    count = torch.zeros((1, nh, nw), dtype=torch.float32, device=image.device)
    for (sh, sw), p in zip(origins, probs):
        canvas[:, sh:sh + crop, sw:sw + crop] += p
        count[:, sh:sh + crop, sw:sw + crop] += 1.0
    return (canvas / count)[:, ph0:ph0 + h, pw0:pw0 + w]


def _labels_resize(params: dict, images: torch.Tensor,
                   compute_dtype) -> torch.Tensor:
    """The resize protocol on a batch (n, H, W, 3): squash to EVAL_SIZE²
    (antialiased bilinear), one forward, class scores resized back
    (antialiased where they shrink), argmax -> (n, H, W) int32."""
    h, w = images.shape[1:3]
    x = resize_image(images.to(torch.float32), (EVAL_SIZE, EVAL_SIZE))
    with runtime.timed("pspnet", x):
        logits = _forward(params, x, compute_dtype)
    logits = _bilinear(logits, (h, w), antialias=True)
    return torch.argmax(logits, dim=1).to(torch.int32)


def segment_batch(params: dict, images, compute_dtype="bfloat16",
                  chunk: int = 8) -> torch.Tensor:
    """(N, H, W, 3) [0,255] RGB -> (N, H, W) int32 class maps, the resize
    protocol in forwards of at most `chunk` images. Each image's labels
    are those of `segment` on it."""
    imgs = torch.as_tensor(images, dtype=torch.float32)
    return torch.cat([_labels_resize(params, imgs[i:i + chunk],
                                     compute_dtype)
                      for i in range(0, imgs.shape[0], chunk)])


def segment(params: dict, image, compute_dtype="bfloat16", *,
            protocol: str = "resize", base_size: int | None = None,
            scales: tuple = (1.0,), flip: bool = True,
            crop_size: int | None = None) -> torch.Tensor:
    """(H, W, 3) [0,255] RGB -> (H, W) int32 ADE20K class map, on the
    device of `image` (a tensor; a numpy array runs on the CPU).

    protocol="resize" (default): squash to EVAL_SIZE² and resize the class
    scores back. protocol="sliding": the semseg-lineage eval protocol:
    aspect-preserving resize of the long side to scale · base_size for
    each scale in `scales` (bilinear, no antialias), sliding windows with
    mirror averaging (`_scale_process`), probabilities resized back to
    (H, W) (no antialias) and summed over scales, argmax. EVAL_SIZE and
    BASE_SIZE are read at call time."""
    if crop_size is None:
        crop_size = EVAL_SIZE
    if base_size is None:
        base_size = BASE_SIZE
    img = torch.as_tensor(image, dtype=torch.float32)
    h, w = img.shape[:2]
    if protocol == "resize":
        return _labels_resize(params, img[None], compute_dtype)[0]
    if protocol != "sliding":
        raise ValueError(f"unknown segmentation protocol {protocol!r}")
    planes = img.permute(2, 0, 1)[None]
    total = torch.zeros((1, N_CLASSES, h, w), dtype=torch.float32,
                        device=img.device)
    for scale in scales:
        long_size = int(round(scale * base_size))
        if h > w:
            nh, nw = long_size, max(1, int(round(long_size / h * w)))
        else:
            nh, nw = max(1, int(round(long_size / w * h))), long_size
        scaled = _bilinear(planes, (nh, nw), antialias=False)
        probs = _scale_process(params, scaled[0].permute(1, 2, 0),
                               compute_dtype, flip, crop_size)
        total = total + _bilinear(probs[None], (h, w), antialias=False)
    return torch.argmax(total[0], dim=0).to(torch.int32)
