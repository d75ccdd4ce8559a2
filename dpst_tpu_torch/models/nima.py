"""NIMA aesthetic scorer: MobileNetV1 backbone + 10-way score head.

The port's counterpart of `dpst_tpu/models/nima.py` ("NIMA: Neural Image
Assessment", Talebi & Milanfar, 2018): a MobileNet-224 feature extractor
(a 3×3/2 stem, 13 depthwise-separable blocks, ReLU6, BN folded into one
scale and bias per conv), global average pooling and a 10-way softmax over
the scores 1..10; the aesthetic score is the distribution's mean. It
scores the candidates of the style-weight sweep (`autotune`) in one
batched forward.

The convs run on cuDNN (`F.conv2d`, NCHW; the depthwise ones with
`groups=cin`) in the compute dtype, padded as XLA's "SAME" pads them
(`pspnet.same_pads`), with `vgg.set_exact_backends` on CUDA; the head is
fp32. Weights: `weights/nima_mobilenet.npz` ($DPST_NIMA_WEIGHTS) in the
JAX package's bundle format if present, else a seeded He init.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kernels import torch_dtype
from ..ops.resize import resize_image
from .pspnet import same_pads
from .vgg import set_exact_backends

EVAL_SIZE = 224
N_BINS = 10
# MobileNetV1: (stride, out_channels) per depthwise-separable block
MB_BLOCKS = ((1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
             (1, 512), (1, 512), (1, 512), (1, 512), (1, 512), (2, 1024),
             (1, 1024))

_DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "..",
                                "weights", "nima_mobilenet.npz")


def _specs():
    specs = [("stem", "conv", 3, 32)]              # 3×3/2 full conv
    cin = 32
    for i, (_s, cout) in enumerate(MB_BLOCKS):
        specs.append((f"dw{i}", "dw", cin, cin))     # 3×3 depthwise
        specs.append((f"pw{i}", "conv", cin, cout))  # 1×1 pointwise
        cin = cout
    specs.append(("head", "dense", 1024, N_BINS))
    return specs


SPECS = _specs()


def _shape(name: str, kind: str, cin: int, cout: int) -> tuple:
    """The port's weight shape: OIHW for convs, (cin, 1, 3, 3) for the
    depthwise ones, (cin, cout) for the head."""
    if kind == "dw":
        return (cin, 1, 3, 3)
    if kind == "dense":
        return (cin, cout)
    k = 3 if name == "stem" else 1
    return (cout, cin, k, k)


def init_params(seed: int = 0, generator: torch.Generator | None = None,
                device=None) -> dict:
    """He-normal init from a seeded torch.Generator (on the CPU, then moved
    to `device`); BN folded to scale 1, bias 0. Not the JAX package's bits:
    its init draws from JAX's PRNG."""
    gen = generator if generator is not None else torch.Generator(
        ).manual_seed(seed)
    params = {}
    for name, kind, cin, cout in SPECS:
        shape = _shape(name, kind, cin, cout)
        fan = cin if kind == "dense" else int(np.prod(shape[1:]))
        n = cin if kind == "dw" else cout
        w = torch.randn(shape, generator=gen, dtype=torch.float32)
        params[name] = {
            "w": (w * float(np.sqrt(2.0 / fan))).to(device),
            "scale": torch.ones(n, dtype=torch.float32, device=device),
            "bias": torch.zeros(n, dtype=torch.float32, device=device)}
    return params


def params_from_numpy(params: dict, device=None) -> dict:
    """Weight bridge: the JAX package's {name: {"w", "scale", "bias"}} as
    numpy arrays (convs HWIO, depthwise (3, 3, 1, cin), head (cin, cout))
    -> the port's layout as fp32 tensors on `device`."""
    out = {}
    for name, kind, cin, cout in SPECS:
        w = np.asarray(params[name]["w"], np.float32)
        if kind != "dense":
            w = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
        if w.shape != _shape(name, kind, cin, cout):
            raise ValueError(f"{name}: bad shape {w.shape}")
        out[name] = {"w": torch.from_numpy(w.copy()).to(device)}
        for k in ("scale", "bias"):
            out[name][k] = torch.from_numpy(np.asarray(
                params[name][k], np.float32).copy()).to(device)
    return out


def load_params(path: str, device=None) -> dict:
    """`.npz` bundle with keys `<name>_w`, `<name>_scale`, `<name>_bias`
    -- the JAX package's bundle format."""
    data = np.load(path)
    return params_from_numpy(
        {name: {k: data[f"{name}_{k}"] for k in ("w", "scale", "bias")}
         for name, *_ in SPECS}, device)


def get_params(weights_path: str | None = None, seed: int = 0,
               device=None) -> dict:
    """AVA weights if a bundle exists ($DPST_NIMA_WEIGHTS or
    weights/nima_mobilenet.npz), else the seeded random init."""
    if weights_path is None:
        weights_path = os.environ.get("DPST_NIMA_WEIGHTS", _DEFAULT_WEIGHTS)
    if weights_path and os.path.exists(weights_path):
        return load_params(weights_path, device)
    return init_params(seed, device=device)


def _conv(p, x, stride=1, groups=1):
    w = p["w"].to(x.dtype)
    k = w.shape[2]
    ph = same_pads(x.shape[2], k, stride)
    pw = same_pads(x.shape[3], k, stride)
    if ph != (0, 0) or pw != (0, 0):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(x, w, stride=stride, groups=groups)
    y = (y * p["scale"].to(y.dtype)[:, None, None]
         + p["bias"].to(y.dtype)[:, None, None])
    return torch.clamp(y, 0.0, 6.0)                  # ReLU6 (MobileNet)


def backbone_features(params: dict, images: torch.Tensor,
                      compute_dtype="bfloat16") -> torch.Tensor:
    """(B, 224, 224, 3) [0,255] RGB -> (B, 1024) fp32 GAP features."""
    cdt = torch_dtype(compute_dtype)
    if images.device.type == "cuda":
        set_exact_backends(cdt)
    half = torch.tensor(127.5, dtype=torch.float32, device=images.device)
    x = (images.to(torch.float32) / half - 1.0).to(cdt)  # MobileNet [-1, 1]
    x = _conv(params["stem"], x.permute(0, 3, 1, 2).contiguous(), stride=2)
    cin = 32
    for i, (stride, cout) in enumerate(MB_BLOCKS):
        x = _conv(params[f"dw{i}"], x, stride=stride, groups=cin)
        x = _conv(params[f"pw{i}"], x)
        cin = cout
    return torch.mean(x.to(torch.float32), dim=(2, 3))


def score_distribution(params: dict, images: torch.Tensor,
                       compute_dtype="bfloat16") -> torch.Tensor:
    """(B, 224, 224, 3) [0,255] RGB -> (B, 10) score distribution; the head
    is (feat @ w) * scale + bias in fp32."""
    feat = backbone_features(params, images, compute_dtype)
    head = params["head"]
    logits = (feat @ head["w"]) * head["scale"] + head["bias"]
    return torch.softmax(logits, dim=-1)


def nima_score(params: dict, image, compute_dtype="bfloat16"
               ) -> torch.Tensor:
    """Image(s) -> aesthetic score(s), the mean of the 1..10 distribution.
    Takes (H, W, 3) or (B, H, W, 3) at any size (a tensor on the device to
    score on; a numpy array scores on the CPU), resized to 224² with the
    antialiased bilinear resize."""
    img = torch.as_tensor(image, dtype=torch.float32)
    squeeze = img.ndim == 3
    if squeeze:
        img = img[None]
    x = resize_image(img, (EVAL_SIZE, EVAL_SIZE))
    dist = score_distribution(params, x, compute_dtype)
    bins = torch.arange(1.0, N_BINS + 1.0, dtype=torch.float32,
                        device=dist.device)
    scores = dist @ bins
    return scores[0] if squeeze else scores
