"""3×3 SAME convolution of an image or a batch: CUDA kernel and plain
version.

The port's counterpart of `dpst_tpu/ops/conv_pallas.py`:

    y[co, h, w] = Σ_{dy, dx, ci} x[ci, h + dy − 1, w + dx − 1] · w[co, ci, dy, dx]

x (Cin, H, W) NCHW planes, w (Cout, Cin, 3, 3) OIHW, y (Cout, H, W), all in
the compute dtype; stride 1, zero padding, fp32 accumulation, the output
rounded once to the compute dtype. No bias and no ReLU: `extract_features`
adds them. One kernel serves both directions: the input gradient is
`conv3x3_same(g, flip_transpose_weights(w))`. A batch (N, Cin, H, W) is
one launch, the image an index of the kernel's grid (the JAX package's
vmapped `pallas_call`); each image's sums have the order of its own
launch.

The kernels read the weights packed as (9, Cout, Cinp) (`pack_weights`,
and `pack_grad_weights` for the input gradient; block12's conv1_1 in bf16
as (Cout, 32), `pack_k27`), which the VGG path
makes once per run (`models/vgg.pack_params`,
`block12_pallas.pack_weights`). In bf16 the kernel is the wgmma body of
csrc/conv3x3_wgmma.cuh on `conv_plan`'s grid.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels

SMS = 132                  # streaming multiprocessors of the H100
TILE = (8, 32)             # output rows × columns of a bf16 block
CHUNK = 64                 # input channels of a bf16 stage
K27 = 32                   # conv1_1's 27 (tap, channel) pairs, padded
_RING = 5                  # weight slots of the bf16 ring
SMEM_LIMIT = 232448        # shared memory a block can use on the H100


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, 3, 3) -> the kernels' (9, Cout, Cinp):
    wp[3·dy + dx, co, ci] = w[co, ci, dy, dx], Cinp = Cin rounded up to 8,
    the padding zero (16-byte rows)."""
    cout, cin = w.shape[:2]
    wp = w.permute(2, 3, 0, 1).reshape(9, cout, cin)
    if cin % 8:
        wp = F.pad(wp, (0, _pad8(cin) - cin))
    return wp.contiguous()


def pack_grad_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, 3, 3) -> the input-gradient conv's weights, flipped,
    transposed and packed in one step: (9, Cin, Coutp) with
    wt[3·dy + dx, ci, co] = w[co, ci, 2 − dy, 2 − dx], i.e.
    `pack_weights(flip_transpose_weights(w))`."""
    cout, cin = w.shape[:2]
    wt = w.flip(2, 3).permute(2, 3, 1, 0).reshape(9, cin, cout)
    if cout % 8:
        wt = F.pad(wt, (0, _pad8(cout) - cout))
    return wt.contiguous()


def unpack_weights(wp: torch.Tensor, cin: int) -> torch.Tensor:
    """`pack_weights`' inverse: (9, Cout, Cinp) -> OIHW (Cout, cin, 3, 3)."""
    return wp[:, :, :cin].permute(1, 2, 0).reshape(
        wp.shape[1], cin, 3, 3).contiguous()


def pack_k27(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, 3, 3, 3) -> (Cout, 32): column k = 3·tap + ci (tap =
    3·dy + dx) holds w[co, ci, dy, dx], columns 27… zero: conv1_1 as one
    contraction of depth 32 over `im2col_k27`'s rows."""
    cout = w.shape[0]
    wk = w.permute(0, 2, 3, 1).reshape(cout, 27)
    return F.pad(wk, (0, K27 - 27)).contiguous()


def im2col_k27(x: torch.Tensor) -> torch.Tensor:
    """(3, H, W) -> (27, H·W): row 3·tap + ci is channel ci shifted by the
    tap (dy, dx), zero outside the image."""
    _, h, wd = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    return torch.stack([xp[ci, dy:dy + h, dx:dx + wd].reshape(h * wd)
                        for dy in range(3) for dx in range(3)
                        for ci in range(3)])


def conv3x3_k27_acc(x: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """conv1_1 in the form its kernel computes it: the packed (Cout, 32)
    weights times the im2col of the 3-channel x, fp32, not rounded:
    (Cout, H, W)."""
    _, h, wd = x.shape
    acc = torch.matmul(wk[:, :27].float(), im2col_k27(x).float())
    return acc.reshape(-1, h, wd)


def conv_width(cout: int) -> int:
    """N tile of the bf16 kernel: Cout rounded up to 8, at most 128."""
    return 128 if cout >= 128 else _pad8(cout)


def conv_smem_bytes(bn: int, cps: int) -> int:
    """Dynamic shared memory of a bf16 block with N tiles of bn summing
    cps chunks: the weight ring, the alignment slack and the (8 + 2) × (32
    + 2)-pixel slabs of 128 bytes a pixel, two where the block sums more
    than one chunk or bn > 64, else one (two such blocks share an SM)."""
    slabs = 2 if cps > 1 or bn > 64 else 1
    return (_RING * bn * 128 + slabs * (TILE[0] + 2) * (TILE[1] + 2) * 128
            + 1024)


def conv_blocks(cout: int, h: int, w: int) -> int:
    """Output tiles of the bf16 kernel: pixel tiles × channel tiles."""
    return (-(-h // TILE[0]) * -(-w // TILE[1])
            * -(-cout // conv_width(cout)))


def conv_plan(cin: int, cout: int, h: int, w: int,
              b: int = 1) -> tuple[int, int, int]:
    """(bn, splits, cps) of the bf16 kernel: N tiles of bn channels, and
    Cin's chunks of 64 cut into `splits` non-empty ranges of `cps` where
    one image's tiles alone leave SMs idle. One block fits an SM, so the
    cost of a plan is its waves of blocks times the chunks a block sums;
    the cheapest wins, the fewest splits among equals (each split adds an
    fp32 partial of the output and a pass that sums them). The splits cut
    each image's sum over Cin, so a batch of b images takes one image's
    plan (an image then rounds in a batch as alone), on a grid b times as
    long."""
    del b   # a batch splits each image as one image's plan does
    blocks = conv_blocks(cout, h, w)
    chunks = -(-cin // CHUNK)
    best = None
    for s in range(1, chunks + 1):
        cps = -(-chunks // s)
        splits = -(-chunks // cps)
        cost = -(-blocks * splits // SMS) * cps
        if best is None or cost < best[0]:
            best = (cost, splits, cps)
    return conv_width(cout), best[1], best[2]


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
    """Plain PyTorch version: `conv3x3_acc`, then one cast (of a batch,
    image by image)."""
    if x.dim() == 4:
        return torch.stack([conv3x3_acc(xi, w).to(x.dtype) for xi in x])
    return conv3x3_acc(x, w).to(x.dtype)


def conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3×3 conv: (Cin, H, W) × weights -> (Cout, H, W), or a batch
    (N, Cin, H, W) -> (N, Cout, H, W) in one launch. The weights are OIHW
    (Cout, Cin, 3, 3), packed on each call, or already packed (9, Cout,
    Cinp) by `pack_weights`. CPU tensors take the plain version; CUDA
    tensors launch the kernel (csrc/conv3x3.cu)."""
    if x.dim() not in (3, 4):
        raise ValueError(f"x must be (Cin, H, W) or (N, Cin, H, W), got "
                         f"{tuple(x.shape)}")
    lead = x.shape[:-3]
    b = x.shape[0] if lead else 1
    cin, h, wd = x.shape[-3:]
    packed = w.dim() == 3
    cout = w.shape[1] if packed else w.shape[0]
    kernels.require(x, "x")
    kernels.require(w, "w", (9, cout, _pad8(cin)) if packed
                    else (cout, cin, 3, 3), x.dtype)
    if not kernels.on_cuda(x, w):
        return conv3x3_plain(x, unpack_weights(w, cin) if packed else w)
    wp = w if packed else pack_weights(w)
    kernels.require_aligned(wp, "w")
    bn, splits, cps = (conv_plan(cin, cout, h, wd, b)
                       if x.dtype == torch.bfloat16 else (0, 1, 1))
    work = (torch.empty((b, splits, cout, h, wd), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    y = torch.empty((*lead, cout, h, wd), dtype=x.dtype, device=x.device)
    rc = kernels.library().dpst_conv3x3(
        kernels.ptr(x), kernels.ptr(wp), kernels.ptr(y), kernels.ptr(work),
        cin, cout, h, wd, b, bn, splits, cps, kernels.DTYPE_CODES[x.dtype],
        kernels.stream_ptr(x))
    kernels.check(rc, "conv3x3")
    kernels.LAUNCHES["conv3x3"] += 1
    return y
