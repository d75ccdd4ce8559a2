"""VGG-19 feature extractor (PyTorch, NCHW).

The port's counterpart of `dpst_tpu/models/vgg.py`: Caffe-style BGR +
ImageNet-mean preprocessing, the 16 3×3 convs truncated at the deepest
requested tap, post-ReLU taps in the compute dtype. The convs run on
cuDNN, or with `conv_impl="pallas"` (Cin ≥ 8, so every conv but conv1_1)
on the port's own 3×3 conv kernel (`ops/conv_cuda.py`), whose input
gradient is the same kernel on the flipped, transposed weights. A run packs
its weights once (`pack_params`): the compute-dtype casts, the kernel's
packed forward and input-gradient weights, and blocks 1-2's
(`ops/block12_pallas.pack_weights`).

Two gradient conventions of the JAX package differ from PyTorch's
defaults, so both are autograd Functions here:
  * ReLU's gradient at exactly 0 is 0.5, as for `jnp.maximum(x, 0)`
    (torch.relu gives 0); the bias add and the ReLU run as one kernel
    each way on CUDA tensors (`ops/bias_relu_cuda.py`);
  * the 2×2 max pool splits its cotangent equally among tied maxima
    (F.max_pool2d's backward gives it all to the first); its backward is
    the CUDA kernel of `ops/pool_cuda.py` on CUDA tensors.

The network takes a batch of N images (NCHW) as one: cuDNN's convs and
the pool backward (the batch folded into its channels) run once for all
of them; the port's own conv kernel (`conv_impl="pallas"`) has no batch
grid dimension and runs once an image. A single (H, W, 3) image is a batch
of one, and its taps come back without the batch axis.

The TPU lowerings of the JAX package (s2b strips, space-to-depth block 1,
the BGR weight fold, post-activation pooling) are exact re-expressions of
the same math and are not carried here.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import block12_pallas
from ..ops.bias_relu_cuda import bias_relu_bwd, bias_relu_fwd
from ..ops.conv_cuda import conv3x3_same, pack_grad_weights, pack_weights
from ..ops.gram_s2d import RawTap
from ..ops.kernels import torch_dtype
from ..ops.pool_cuda import maxpool2_bwd
from ..utils import assets
from ..utils.runtime import canonical, params_on

# VGG-19 convolutional topology: block -> (num convs, out channels).
VGG19_BLOCKS = ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512))

# Canonical layer order: conv1_1, conv1_2, pool1, conv2_1, ...
LAYER_ORDER: tuple[str, ...] = tuple(
    name
    for b, (n, _) in enumerate(VGG19_BLOCKS, start=1)
    for name in [f"conv{b}_{i}" for i in range(1, n + 1)] + [f"pool{b}"]
)

CONV_SHAPES: dict[str, tuple[int, int]] = {}
_in_ch = 3
for _b, (_n, _out) in enumerate(VGG19_BLOCKS, start=1):
    for _i in range(1, _n + 1):
        CONV_SHAPES[f"conv{_b}_{_i}"] = (_in_ch, _out)
        _in_ch = _out

# Caffe/ImageNet channel means in BGR order.
BGR_MEANS = (103.939, 116.779, 123.68)


def params_from_numpy(params: dict, device=None) -> dict:
    """Weight bridge: {layer: {"w": HWIO array, "b": (Cout,)}} (the JAX
    package's layout, as numpy arrays) -> {layer: {"w": OIHW, "b": (Cout,)}}
    fp32 tensors on `device`."""
    out = {}
    for name, (cin, cout) in CONV_SHAPES.items():
        w = np.asarray(params[name]["w"], np.float32)
        b = np.asarray(params[name]["b"], np.float32)
        if w.shape != (3, 3, cin, cout) or b.shape != (cout,):
            raise ValueError(f"{name}: bad weight shapes {w.shape}, {b.shape}")
        out[name] = {
            "w": torch.from_numpy(np.ascontiguousarray(
                w.transpose(3, 2, 0, 1))).to(device),
            "b": torch.from_numpy(b.copy()).to(device)}
    return out


def load_params(path: str, device=None) -> dict:
    """Load a `.npz` weight bundle: keys `<layer>_w` (3,3,Cin,Cout) HWIO and
    `<layer>_b` (Cout,) -- the JAX package's bundle format."""
    data = np.load(path)
    return params_from_numpy(
        {name: {"w": data[f"{name}_w"], "b": data[f"{name}_b"]}
         for name in CONV_SHAPES}, device)


def init_params(seed: int = 0, generator: torch.Generator | None = None,
                device=None) -> dict:
    """He-normal init of all 16 convs from a seeded torch.Generator (on the
    CPU, then moved to `device`). Not the JAX package's bits: its init
    draws from JAX's PRNG."""
    gen = generator if generator is not None else torch.Generator(
        ).manual_seed(seed)
    params = {}
    for name, (cin, cout) in CONV_SHAPES.items():
        w = torch.randn((cout, cin, 3, 3), generator=gen,
                        dtype=torch.float32) * float(np.sqrt(2.0 / (9 * cin)))
        params[name] = {"w": w.to(device),
                        "b": torch.zeros(cout, dtype=torch.float32,
                                         device=device)}
    return params


def get_params(weights_path: str | None = None, seed: int = 0,
               device=None) -> dict:
    """ImageNet weights if a bundle exists (`utils.assets.bundle_path`:
    $DPST_VGG_WEIGHTS or weights/vgg19.npz), else the seeded random
    init."""
    if weights_path is None:
        weights_path = assets.bundle_path("vgg19")
    if weights_path and os.path.exists(weights_path):
        return load_params(weights_path, device)
    return init_params(seed, device=device)


@functools.lru_cache(maxsize=None)
def _means(device: torch.device, rgb: bool = False) -> torch.Tensor:
    """BGR_MEANS (or in RGB order) as an fp32 tensor on `device`, made once
    a device: the copy from the host synchronizes the card, and a forward
    of each shard of each evaluation would otherwise pay it."""
    return torch.tensor(BGR_MEANS[::-1] if rgb else BGR_MEANS,
                        dtype=torch.float32, device=device)


def preprocess(image: torch.Tensor) -> torch.Tensor:
    """[0,255] RGB (H, W, 3), or a batch (N, H, W, 3) -> mean-subtracted
    BGR as an (N, 3, H, W) batch (N = 1 for one image)."""
    bgr = image.to(torch.float32).flip(-1)
    x = (bgr - _means(image.device)).movedim(-1, -3)
    return (x if x.dim() == 4 else x[None]).contiguous()


def preprocess_noflip(image: torch.Tensor) -> torch.Tensor:
    """[0,255] RGB (H, W, 3) -> the (3, H, W) fp32 planes of the means
    subtracted in RGB order (`dpst_tpu/models/vgg.py:_preprocess_noflip`);
    a batch (B, H, W, 3) -> (B, 3, H, W). The BGR flip is folded into
    conv1_1's weights instead (`ops/block12_pallas.pack_weights`)."""
    return (image.to(torch.float32) - _means(image.device, rgb=True)
            ).movedim(-1, -3).contiguous()


class _BiasRelu(torch.autograd.Function):
    """max(z + b_c, 0) of a conv's raw output z ((N, C, H, W) or (C, H, W))
    and its (C,) bias, with gradient 1 above 0, 0 below and 0.5 at exactly
    0: apply(z, b), one kernel each way on the card
    (`ops/bias_relu_cuda.py`). It saves z and b and recomputes z + b in the
    backward. No gradient flows to b (the VGG weights are constants)."""

    @staticmethod
    def forward(ctx, z, b):
        z = z.contiguous()
        ctx.save_for_backward(z, b)
        return bias_relu_fwd(z, b)

    @staticmethod
    def backward(ctx, g):
        z, b = ctx.saved_tensors
        return bias_relu_bwd(z, b, g.contiguous()), None


class _MaxPool2(torch.autograd.Function):
    """2×2/2 max pool of an (N, C, H, W) batch with the tie-splitting
    backward, one launch for the batch: its N·C planes are the kernel's
    channels."""

    @staticmethod
    def forward(ctx, x):
        y = F.max_pool2d(x, 2, 2)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        fold = lambda t: t.reshape(-1, *t.shape[2:])
        return maxpool2_bwd(fold(x), fold(y),
                            fold(g.contiguous())).reshape(x.shape)


class _Conv3x3(torch.autograd.Function):
    """SAME 3×3 conv of an (N, Cin, H, W) batch on the port's kernel, one
    launch a direction for the batch: apply(x, wp, ftp) with the packed
    weights and the packed flipped, transposed weights of the input
    gradient (`pack_params`). The VGG weights are constants of the
    optimization: the backward is the input gradient only, the same kernel
    on the flipped, transposed weights, and no gradient flows to the
    weights."""

    @staticmethod
    def forward(ctx, x, wp, ftp):
        ctx.save_for_backward(ftp)
        return conv3x3_same(x.contiguous(), wp)

    @staticmethod
    def backward(ctx, g):
        (ftp,) = ctx.saved_tensors
        return conv3x3_same(g.contiguous(), ftp), None, None


def _use_pallas_conv(conv_impl: str, cin: int) -> bool:
    """`dpst_tpu/models/vgg.py:_use_pallas_conv`: the conv kernel only for
    `conv_impl="pallas"`, and only from 8 input channels (conv1_1's 3-deep
    contraction stays on cuDNN)."""
    return conv_impl == "pallas" and cin >= 8


class PackedParams(dict):
    """A run's weight dict ({layer: {"w", "b"}}, as `params_from_numpy`)
    with the forms the kernels read, made once (`pack_params`): each
    layer also holds "wc" and "bc", its weights and bias in the compute
    dtype, and with `conv_impl="pallas"` each layer the conv kernel takes
    holds "wp" and "ftp", its packed weights and packed input-gradient
    weights; `block12` is blocks 1-2's `block12_pallas.pack_weights`, and
    `key` the (compute dtype, pallas conv) it was packed for."""

    key: tuple
    block12: tuple


def pack_params(params: dict, compute_dtype,
                conv_impl: str = "auto") -> PackedParams:
    """`params` with the compute-dtype and packed forms of its weights, for
    a run in `compute_dtype` with `conv_impl` (see `PackedParams`). A dict
    already packed for both comes back as it is."""
    cdt = torch_dtype(compute_dtype)
    key = (cdt, conv_impl == "pallas")
    if getattr(params, "key", None) == key:
        return params
    out = PackedParams()
    for name, p in params.items():
        layer = {"w": p["w"], "b": p["b"], "wc": p["w"].to(cdt),
                 "bc": p["b"].to(cdt)}
        if _use_pallas_conv(conv_impl, CONV_SHAPES[name][0]):
            layer["wp"] = pack_weights(layer["wc"])
            layer["ftp"] = pack_grad_weights(layer["wc"])
        out[name] = layer
    out.key = key
    out.block12 = block12_pallas.pack_weights(params, cdt)
    return out


def params_by_device(params: dict, devices, compute_dtype,
                     conv_impl: str = "auto") -> dict:
    """{device: `pack_params` of `params` on it} for each distinct device
    of `devices`, keyed as tensors name their devices
    (`runtime.canonical`): packed once, on the first, and moved packed
    (`runtime.params_on`) to the others."""
    devs = list(dict.fromkeys(map(canonical, devices)))
    packed = pack_params(params_on(params, devs[0]), compute_dtype,
                         conv_impl)
    return {d: params_on(packed, d) for d in devs}


def _pool(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "max":
        return _MaxPool2.apply(x)
    return F.avg_pool2d(x, 2, 2, divisor_override=1) * 0.25


def set_exact_backends(compute_dtype) -> None:
    """Backend flags every extraction sets on CUDA: fp32 convs and matmuls
    without TF32 in fp32 mode (cuDNN defaults to TF32 for fp32 convs), and
    deterministic cuDNN algorithms so that a rerun gives bit-identical
    results."""
    if torch_dtype(compute_dtype) == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


class _AtenConv(torch.autograd.Function):
    """F.conv2d and its input gradient with cuDNN off: ATen's own CUDA
    convolution, an im2col and a GEMM an image (so a batch's images round
    as they do one at a time). apply(x, w, padding); no gradient flows to
    the weights (the VGG weights are constants)."""

    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.save_for_backward(w)
        ctx.shape, ctx.padding = x.shape, padding
        with torch.backends.cudnn.flags(enabled=False):
            return F.conv2d(x, w, padding=padding)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        with torch.backends.cudnn.flags(enabled=False):
            return torch.nn.grad.conv2d_input(ctx.shape, w, g,
                                              padding=ctx.padding), None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, padding=1) -> torch.Tensor:
    """3×3 conv of an (N, C, H, W) batch: `F.conv2d` (cuDNN on the card),
    but in fp32 on the card ATen's own convolution (`_AtenConv`), and in
    bf16 on the card one cuDNN call an image. cuDNN's algorithms round
    apart by shape (a row shard's conv from the whole image's, a batch
    from its images one at a time) and from the CPU, and the near-ties of
    ReLU and max pooling let an optimizer grow that rounding: 10 steps of
    64² fp32 L-BFGS ended at SSIM 0.80 card against CPU and 0.94 sharded
    against unsharded on the card, an fp32 `autotune` candidate 0.9-1.9
    of 255 from its `stylize` run after 5 Adam steps, and a bf16 L-BFGS
    batch of 8 at 512² one pair 1.15e-2 from its run alone in the first
    ten rows after 10 steps (the batch's bf16 input gradients 3.6e-3 of
    max|g| off; image by image, 1.3e-7; NVIDIA H100 80GB HBM3, 700.00 W).
    So a batch's images take cuDNN's bf16 forward and backward as each
    image alone does."""
    if x.is_cuda and x.dtype == torch.float32:
        return _AtenConv.apply(x, w, padding)
    if x.is_cuda and x.shape[0] > 1:
        return torch.cat([F.conv2d(xi[None], w, padding=padding)
                          for xi in x.unbind(0)])
    return F.conv2d(x, w, padding=padding)


def _run_layers(params: PackedParams, x: torch.Tensor, names, layers,
                pooling: str, conv_impl: str, raw_taps=()) -> dict:
    """Run the layers `names` (in LAYER_ORDER) on the (N, C, H, W) batch x
    with `pack_params`' weights; returns the (N, C_l, H_l, W_l) taps of
    those in `layers` (see extract_features)."""
    taps = {}
    for name in names:
        if name.startswith("pool"):
            x = _pool(x, pooling)
            continue
        p = params[name]
        if _use_pallas_conv(conv_impl, x.shape[1]):
            z = _Conv3x3.apply(x, p["wp"], p["ftp"])
        else:
            z = conv2d(x, p["wc"])
        b = p["bc"]
        x = _BiasRelu.apply(z, b)
        if name in raw_taps:
            taps[name] = RawTap(z, b)
        elif name in layers:
            taps[name] = x
    return taps


def _one(taps: dict) -> dict:
    """The taps of a batch of one without the batch axis."""
    return {name: RawTap(t.z[0], t.b) if isinstance(t, RawTap) else t[0]
            for name, t in taps.items()}


def extract_features(params: dict, image: torch.Tensor,
                     layers: tuple[str, ...], pooling: str = "max",
                     compute_dtype="float32", conv_impl: str = "auto",
                     raw_taps: tuple[str, ...] = ()) -> dict:
    """Run VGG-19 up to the deepest layer in `layers`.

    params: {layer: {"w": OIHW, "b": (Cout,)}} (see params_from_numpy),
    packed here unless `pack_params` already packed it for this call.
    image: (H, W, 3) float RGB in [0, 255], or a batch (N, H, W, 3).
    Returns {layer: (C_l, H_l, W_l)} post-ReLU taps in the compute dtype
    (NCHW planes of the one image: a tap is the contiguous (C, P) operand
    of the Gram kernels), or (N, C_l, H_l, W_l) for a batch. `conv_impl` picks the conv of every layer but
    conv1_1 (see the module docstring). A layer also in `raw_taps` is
    returned as a `RawTap` of its raw conv output and its bias (the
    counterpart of the JAX package's `S2dTap`), for the fused bias+ReLU
    Gram; the forward still goes on through the ReLU, so the raw output
    gets the gradients of both consumers.
    """
    cdt = torch_dtype(compute_dtype)
    if image.device.type == "cuda":
        set_exact_backends(cdt)
    deepest = max(LAYER_ORDER.index(l) for l in layers)
    taps = _run_layers(pack_params(params, cdt, conv_impl),
                       preprocess(image).to(cdt),
                       LAYER_ORDER[:deepest + 1], layers, pooling, conv_impl,
                       raw_taps)
    return taps if image.dim() == 4 else _one(taps)


def extract_tail(params: dict, x: torch.Tensor, layers: tuple[str, ...],
                 pooling: str = "max", compute_dtype="float32",
                 conv_impl: str = "auto") -> dict:
    """Run VGG-19 from the pool2 output x (128, H/4, W/4), or a batch (N,
    128, H/4, W/4), to the deepest layer in `layers`
    (`dpst_tpu/models/vgg.py:extract_tail`): the continuation of the
    streamed blocks 1-2, with extract_features' convs, ReLU and pools.
    Returns {layer: (C_l, H_l, W_l)} taps ((N, C_l, H_l, W_l) for a
    batch)."""
    cdt = torch_dtype(compute_dtype)
    if x.device.type == "cuda":
        set_exact_backends(cdt)
    start = LAYER_ORDER.index("pool2") + 1
    if min(LAYER_ORDER.index(l) for l in layers) < start:
        raise ValueError("extract_tail: a tap before pool2")
    deepest = max(LAYER_ORDER.index(l) for l in layers)
    taps = _run_layers(pack_params(params, cdt, conv_impl),
                       (x if x.dim() == 4 else x[None]).to(cdt),
                       LAYER_ORDER[start:deepest + 1], layers, pooling,
                       conv_impl)
    return taps if x.dim() == 4 else _one(taps)


# --- blocks 1-2 streamed (the stream12 route) ---------------------------------

S2B_HALO = 8                    # dpst_tpu/models/vgg.py:_S2B_HALO


def stream12_strips(stream12: int, h: int, w: int) -> int:
    """`dpst_tpu/models/vgg.py:stream12_strips` as it resolves on a TPU: -1
    streams above 3072² pixels, in strips of 128 rows where h allows (else
    64, else not at all); 0 is off; N is N strips."""
    if stream12 != -1:
        return stream12
    if h * w <= 3072 * 3072:
        return 0
    if h % 128 == 0:
        return h // 128
    return h // 64 if h % 64 == 0 else 0


def stream12_compatible(layers, strips: int, image_shape) -> bool:
    """`dpst_tpu/models/vgg.py:stream12_compatible`: at least two strips
    that divide h, of a height that is a multiple of 4 and at least
    4 × S2B_HALO, w a multiple of 4, and a tap past pool2."""
    if strips <= 1 or len(image_shape) != 3:
        return False
    h, w, _ = image_shape
    hs = h // strips
    return (h % strips == 0 and hs % 4 == 0 and hs >= 4 * S2B_HALO
            and w % 4 == 0
            and max(LAYER_ORDER.index(l) for l in layers)
            > LAYER_ORDER.index("pool2"))
