"""VGG-19 blocks 1-2 streamed in bands of rows, with the masked Gram sums of
conv1_1 and conv2_1: CUDA kernels, plain versions and the autograd Function.

The port's counterpart of `dpst_tpu/ops/block12_pallas.py` (the
`stream12_impl="pallas"` route). The forward runs conv1_1 → conv1_2 →
pool1 → conv2_1 → conv2_2 → pool2 on the preprocessed image and returns

    g1 (K, 64, 64) and g2 (K, 128, 128)   fp32 Gram SUMS (unnormalized),
                                          G_k = f · (round(m²_k) ∘ f)ᵀ
    p2 (128, H/4, W/4)                    in the compute dtype

and, for the backward, the residuals a11 (64, H, W), a21 and a22 (128,
H/2, W/2). The backward gives the image cotangent dx (3, H, W) fp32 from
(dg1, dg2, dp2): `block12_bwd_deep` (pool2 → conv2_2 → conv2_1 and the
conv2_1 Gram term → dp1) then `block12_bwd_shallow` (conv1_2 recomputed
from a11, then pool1 → conv1_2 → conv1_1 and the conv1_1 Gram term → dx).
Every function walks the image in bands of `band_rows(H, W)` own rows with a
halo of 8 rows at full resolution (4 at half, 2 at quarter), recomputed per
band, and adds the Gram partials of the bands in band order; no block-1/2
activation but the three residuals exists at full resolution. The TPU
kernel's bands (`tb_f` / `tb_b`) are 32 rows, a tile it keeps in VMEM; here
a band lives in a device-memory scratch, so it is as tall as that scratch
allows (256 rows at 4096²), and the halo's recompute falls from 50 % of the
own rows at 32 to 6.25 % at 256. A band's own rows come out the same
whatever its height: each pixel's sums keep their order, and the kernels'
Gram splits (`GRAM_CHUNK` pixels of a band's own rows, in band order) cut
the image as at 32 rows wherever W is a multiple of 512 (16 half-resolution
rows, 8 · W pixels, a multiple of `GRAM_CHUNK`): the Grams too are the same
bits there, as at 4096².

Rounding points are the TPU kernel's (see `csrc/block12.cu`): forward convs
sum in fp32, add the bias in fp32, ReLU, zero the rows outside the image and
round once; the image is rounded to the compute dtype once; avg pool adds
((a + b) + c) + d in the compute dtype, then × 0.25; the pool backward
splits among ties in fp32 and rounds once; relu′ is (a > 0); the
input-gradient convs and the Gram cotangent stay fp32 until da is rounded
after relu′; dp1 is rounded, dx is fp32.

Layout: channel-major planes, as the TPU kernel's. The image enters as the
`preprocess_noflip` planes (RGB order, means subtracted) and `pack_weights`
flips conv1_1's input channels, as the JAX package does. `pack_weights`
also makes, once per run, the forms the kernels read: every forward conv
and every input-gradient conv (the flipped, transposed weights) packed by
`conv_cuda.pack_weights` and `pack_grad_weights`, conv1_1 in bf16 as one
contraction of depth 32 (`conv_cuda.pack_k27`).

A batch of B pairs takes a leading pair axis on every image, mask, output
and cotangent (the weights are shared): the reference vmaps the loop, so
its pallas_calls take the pair as a grid dimension; here each entry point
is one call that walks the B pairs' bands, `unit_groups` of them at a time
(a group may run from one pair into the next), each pair's outputs equal
to its own call's bit for bit.

CPU tensors take the plain versions, which walk the same bands in the same
order (a batch pair by pair); CUDA tensors launch `csrc/block12.cu` or
raise. The backwards' Gram
cotangent stage (`gram_dz_plain`, and `block12_gram_dz` alone on the card)
is per pixel: in bf16 the kernels compute it only on the rows `dz_rows`
that reach an own output row, and take the cotangent as
`gram_stream.s_matrix(s)`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import gram_stream, kernels
from .conv_cuda import (conv3x3_acc, flip_transpose_weights,
                        pack_grad_weights, pack_k27,
                        pack_weights as pack_conv)
from .kernels import torch_dtype

HALO = 8                     # full-resolution halo rows on each side
# The band heights `band_rows` picks from, tallest first: multiples of 32,
# as H is on the block12 route (csrc/block12.cu's TB_MIN)
BAND_ROWS = (256, 128, 64, 32)
B12 = ("conv1_1", "conv1_2", "conv2_1", "conv2_2")
_CINOUT = {"conv1_1": (3, 64), "conv1_2": (64, 64), "conv2_1": (64, 128),
           "conv2_2": (128, 128)}
# Own pixels of the group of bands the kernels process at once, and of a
# band at most: the scratch holds one group (0.51 GB forward, 0.76 GB
# shallow backward in bf16 at 4096², one band of 256 rows)
GROUP_PIXELS = 1 << 20
GRAM_CHUNK = 4096            # pixels of a forward Gram split (csrc/block12.cu)

# The last entry point call's walk, whichever route it took: its band
# height and the rows each stage walks over the own rows, (tb + 2·HALO) / tb
last_band_rows: int | None = None
last_rows_walked: float | None = None


def band_rows(h: int, w: int) -> int:
    """Own rows of a band at an h × w image: the tallest of BAND_ROWS that
    divides h with at most GROUP_PIXELS own pixels a band, else 32. Every
    call at one shape walks the same bands, so a batch's pairs walk as
    alone."""
    for tb in BAND_ROWS:
        if h % tb == 0 and tb * w <= GROUP_PIXELS:
            return tb
    return BAND_ROWS[-1]


def dz_rows(which: str, tb: int) -> tuple[int, int]:
    """Rows [lo, hi) of a band of tb own rows whose Gram cotangent reaches
    an own output row of the backward (the 3×3 input-gradient conv after
    the stage reads one row past each side of the own rows): dz11 in the
    shallow backward's bands of tb + 2·HALO rows, dz21 in the deep
    backward's bands of half as many. The bf16 kernels walk only these rows
    (csrc/block12.cu's `Geom::dz_lo`, `dz_hi`)."""
    if which == "shallow":
        return HALO - 1, HALO + tb + 1
    return HALO // 2 - 1, HALO // 2 + tb // 2 + 1


class Block12Weights(NamedTuple):
    """The four convs' weights in every form the entry points read, in the
    compute dtype (biases fp32): OIHW for the plain versions, then packed
    for the kernels (k: forward, t: input gradient)."""
    w11: torch.Tensor
    b11: torch.Tensor
    w12: torch.Tensor
    b12: torch.Tensor
    w21: torch.Tensor
    b21: torch.Tensor
    w22: torch.Tensor
    b22: torch.Tensor
    k11: torch.Tensor
    k12: torch.Tensor
    k21: torch.Tensor
    k22: torch.Tensor
    t11: torch.Tensor
    t12: torch.Tensor
    t21: torch.Tensor
    t22: torch.Tensor


def pack_weights(params: dict, compute_dtype) -> Block12Weights:
    """OIHW weights in the compute dtype and fp32 biases, conv1_1's input
    channels flipped so that it reads the RGB-ordered `preprocess_noflip`
    image; then the kernels' forms of the same weights: each conv packed
    (conv1_1 in bf16 as `pack_k27`) and each input-gradient conv's
    flipped, transposed weights packed."""
    cdt = torch_dtype(compute_dtype)
    oihw = []
    for name in B12:
        w = params[name]["w"]
        if name == "conv1_1":
            w = w.flip(1)
        oihw.append(w.to(cdt).contiguous())
        oihw.append(params[name]["b"].to(torch.float32).contiguous())
    ws = oihw[0::2]
    fwd = [pack_k27(ws[0]) if cdt == torch.bfloat16 else pack_conv(ws[0])]
    fwd += [pack_conv(w) for w in ws[1:]]
    bwd = [pack_grad_weights(w) for w in ws]
    return Block12Weights(*oihw, *fwd, *bwd)


def group_bands(h: int, w: int, tb: int | None = None) -> int:
    """Bands of tb rows (by default `band_rows(h, w)`) the kernels process
    at once at an h × w image."""
    tb = tb or band_rows(h, w)
    return max(1, min(h // tb, GROUP_PIXELS // (tb * w)))


def unit_groups(b: int, h: int, w: int, group: int | None = None,
                tb: int | None = None) -> list[list[tuple[int, int]]]:
    """The groups of csrc/block12.cu's walk over a batch of b pairs of h × w
    images in bands of tb rows (by default `band_rows(h, w)`): units (pair,
    band), pair-major, `group` (by default `group_bands(h, w, tb)`, at most
    h // tb) a group, so that a group may hold the last bands of one pair
    and the first of the next. The scratch holds one group whatever b
    is."""
    tb = tb or band_rows(h, w)
    nb = h // tb
    group = min(group or group_bands(h, w, tb), nb)
    units = [divmod(u, nb) for u in range(b * nb)]
    return [units[i:i + group] for i in range(0, len(units), group)]


def gram_dz_plan(c: int, nb: int, r: int, w: int,
                 rows: tuple[int, int]) -> tuple[int, ...]:
    """The bf16 Gram cotangent stage's walk over a stacked group of nb
    bands of r rows of w pixels, as csrc/block12.cu's `df_plan`: (c tile,
    groups, splits, pb, pe, p tiles a band, p tiles). Each band's rows
    [lo, hi) widen to the 16-byte boundaries pb = ⌊lo·w/8⌋·8 and pe =
    ⌈hi·w/8⌉·8 of the band and are cut into 64-pixel tiles, which `groups`
    blocks of each c tile share; one split, since the epilogue needs the
    whole sum."""
    lo, hi = rows
    tile = 64 if c <= 64 else 128
    pb, pe = lo * w // 8 * 8, -(-hi * w // 8) * 8
    tpb = -(-(pe - pb) // 64)
    slots = gram_stream._SMS * gram_stream._BWD_RESIDENT[tile]
    groups = min(nb * tpb, max(1, slots // -(-c // tile)))
    return tile, groups, 1, pb, pe, tpb, nb * tpb


def scratch_bytes(which: int, k: int, h: int, w: int, group: int,
                  compute_dtype, tb: int | None = None) -> int:
    """Bytes of scratch an entry point takes in bands of tb rows (by default
    `band_rows(h, w)`), as csrc/block12.cu's `dpst_block12_scratch_bytes`
    counts them (buffers 256-byte aligned): which = 0 forward, 1 deep
    backward, 2 shallow backward."""
    isz = torch_dtype(compute_dtype).itemsize
    tb = tb or band_rows(h, w)
    nb = min(group, h // tb)
    r0 = tb + 2 * HALO
    p0, p1 = nb * r0 * w, nb * (r0 // 2) * (w // 2)
    p2 = nb * (r0 // 4) * (w // 4)
    if which == 0:
        def splits(p):
            return -(-p // GRAM_CHUNK)
        work = max(nb * splits(tb * w) * k * 64 * 64,
                   nb * splits(tb // 2 * (w // 2)) * k * 128 * 128)
        parts = [(n, isz) for n in (3 * p0, 64 * p0, 64 * p0, 64 * p1,
                                    128 * p1, 128 * p1, 128 * p2)]
        parts.append((work, 4))
        if isz == 2:
            parts.append((k * nb * tb * w, 2))     # the group's rounded m²
    elif which == 1:      # a21, a22, dp2, dz, m², t
        parts = [(128 * p1, isz), (128 * p1, isz), (128 * p2, isz),
                 (128 * p1, isz), (k * p1, isz), (128 * p1, 4)]
    else:                 # a11, dp1, a12, dz, m², t
        parts = [(64 * p0, isz), (64 * p1, isz), (64 * p0, isz),
                 (64 * p0, isz), (k * p0, isz), (64 * p0, 4)]
    return sum(-(-n * sz // 256) * 256 for n, sz in parts)


# --- plain versions -----------------------------------------------------------

def _band(x: torch.Tensor, i: int, tbl: int, halo: int) -> torch.Tensor:
    """Rows [i·tbl − halo, i·tbl + tbl + halo) of (C, Hl, W), zero outside."""
    c, hl, w = x.shape
    lo, hi = i * tbl - halo, (i + 1) * tbl + halo
    out = x.new_zeros((c, hi - lo, w))
    a, b = max(lo, 0), min(hi, hl)
    out[:, a - lo:b - lo] = x[:, a:b]
    return out


def _row_mask(i: int, tbl: int, halo: int, hl: int, r: int,
              device) -> torch.Tensor:
    """(1, r, 1) fp32: 1 on the band's rows inside the image of hl rows."""
    g = i * tbl - halo + torch.arange(r, device=device)
    return ((g >= 0) & (g < hl)).to(torch.float32)[None, :, None]


def _conv_bias_relu(x, w, b, rowmask, cdt):
    acc = conv3x3_acc(x, w) + b.to(torch.float32)[:, None, None]
    return (torch.clamp_min(acc, 0.0) * rowmask).to(cdt)


def _quads(x: torch.Tensor):
    """The four corners of each 2×2 window: rows 2i / 2i+1, columns 2j /
    2j+1."""
    return x[:, 0::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 0::2], x[:, 1::2, 1::2]


def _pool(x: torch.Tensor, pooling: str) -> torch.Tensor:
    a, b, c, d = _quads(x)
    if pooling == "max":
        return torch.maximum(torch.maximum(a, b), torch.maximum(c, d))
    return (((a + b) + c) + d) * 0.25


def _pool_bwd(dp: torch.Tensor, x_pre: torch.Tensor, pooling: str, cdt):
    """(C, R/2, W/2) cotangent and (C, R, W) pre-pool activation -> (C, R, W)
    in cdt: ties share the max's cotangent, computed in fp32, one cast."""
    q = dp.to(torch.float32)
    if pooling == "avg":
        parts = [q * 0.25] * 4
    else:
        quads = [t.to(torch.float32) for t in _quads(x_pre)]
        m = torch.maximum(torch.maximum(quads[0], quads[1]),
                          torch.maximum(quads[2], quads[3]))
        eq = [(t == m).to(torch.float32) for t in quads]
        q = q / (((eq[0] + eq[1]) + eq[2]) + eq[3])
        parts = [q * e for e in eq]
    out = torch.empty(x_pre.shape, dtype=torch.float32, device=dp.device)
    for (r, c), part in zip(((0, 0), (0, 1), (1, 0), (1, 1)), parts):
        out[:, r::2, c::2] = part
    return out.to(cdt)


def _relu_grad(a: torch.Tensor) -> torch.Tensor:
    """relu′ of a post-ReLU activation: 1 where a > 0, else 0 (fp32)."""
    return (a.to(torch.float32) > 0).to(torch.float32)


def _partial_gram(f: torch.Tensor, msq: torch.Tensor, cdt) -> torch.Tensor:
    """(C, r, W) tap × (K, r, W) fp32 m² -> (K, C, C) fp32 sums
    G_k = f · (round(m²_k) ∘ f)ᵀ, the weighted operand in cdt."""
    c = f.shape[0]
    f2 = f.reshape(c, -1)
    f32 = f2.to(torch.float32)
    return torch.stack([
        torch.matmul(f32, (msq[k].to(cdt).reshape(1, -1) * f2)
                     .to(torch.float32).t())
        for k in range(msq.shape[0])])


def _gram_df(f: torch.Tensor, msq: torch.Tensor, s: torch.Tensor, cdt):
    """Σ_k s_k · (round(m²_k) ∘ f) in fp32, classes summed in order; s (K,
    C, C) is the symmetrized cotangent in cdt."""
    c, r, w = f.shape
    out = torch.zeros((c, r * w), dtype=torch.float32, device=f.device)
    for k in range(s.shape[0]):
        fw = (msq[k].to(cdt)[None] * f).reshape(c, r * w)
        out = out + torch.matmul(s[k].to(torch.float32), fw.to(torch.float32))
    return out.reshape(c, r, w)


def gram_dz_plain(f: torch.Tensor, msq: torch.Tensor, s: torch.Tensor,
                  t: torch.Tensor, cdt) -> torch.Tensor:
    """The backward's Gram cotangent stage: dz = round((t + Σ_k s_k ·
    (round(m²_k) ∘ f)) · (f > 0)) in cdt, from the tap f (C, r, W), its m²
    (K, r, W), s (K, C, C) = `symmetrize(dG)` and the fp32 conv term t (C,
    r, W); the sum in fp32, rounded once. Each pixel's dz depends on that
    pixel alone."""
    return ((t + _gram_df(f, msq, s, cdt)) * _relu_grad(f)).to(cdt)


def _pairwise(fn, *batch):
    """fn on each pair of the batched operands (a leading pair axis), its
    outputs stacked: a tuple of stacks for a tuple of outputs."""
    outs = [fn(*(t[i] for t in batch)) for i in range(batch[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(col) for col in zip(*outs))
    return torch.stack(outs)


def block12_fwd_plain(x, m1sq, m2sq, weights, pooling="max",
                      compute_dtype="bfloat16", save_res=True, tb=None):
    """Plain PyTorch forward, band by band in bands of tb rows (by default
    `band_rows(H, W)`, the kernels' walk): (g1, g2, p2) and with
    `save_res` also (a11, a21, a22); a batch (x (B, 3, H, W)) pair by
    pair."""
    tb = tb or band_rows(*x.shape[-2:])
    if x.dim() == 4:
        return _pairwise(lambda *t: _fwd_plain_one(
            *t, weights, pooling, compute_dtype, save_res, tb),
            x, m1sq, m2sq)
    return _fwd_plain_one(x, m1sq, m2sq, weights, pooling, compute_dtype,
                          save_res, tb)


def _fwd_plain_one(x, m1sq, m2sq, weights, pooling, compute_dtype,
                   save_res, tb):
    cdt = torch_dtype(compute_dtype)
    w11, b11, w12, b12, w21, b21, w22, b22 = weights[:8]
    h = x.shape[1]
    k = m1sq.shape[0]
    dev = x.device
    g1 = torch.zeros((k, 64, 64), dtype=torch.float32, device=dev)
    g2 = torch.zeros((k, 128, 128), dtype=torch.float32, device=dev)
    p2s, a11s, a21s, a22s = [], [], [], []
    for i in range(h // tb):
        xe = _band(x, i, tb, HALO).to(cdt)
        r0 = xe.shape[1]
        rm0 = _row_mask(i, tb, HALO, h, r0, dev)
        rm1 = _row_mask(i, tb // 2, HALO // 2, h // 2, r0 // 2, dev)
        a11 = _conv_bias_relu(xe, w11, b11, rm0, cdt)
        a12 = _conv_bias_relu(a11, w12, b12, rm0, cdt)
        a21 = _conv_bias_relu(_pool(a12, pooling), w21, b21, rm1, cdt)
        a22 = _conv_bias_relu(a21, w22, b22, rm1, cdt)
        p2 = _pool(a22, pooling)
        f11 = a11[:, HALO:HALO + tb]
        f21 = a21[:, HALO // 2:HALO // 2 + tb // 2]
        g1 = g1 + _partial_gram(f11, m1sq[:, i * tb:(i + 1) * tb], cdt)
        g2 = g2 + _partial_gram(
            f21, m2sq[:, i * tb // 2:(i + 1) * tb // 2], cdt)
        p2s.append(p2[:, HALO // 4:HALO // 4 + tb // 4])
        if save_res:
            a11s.append(f11)
            a21s.append(f21)
            a22s.append(a22[:, HALO // 2:HALO // 2 + tb // 2])
    out = (g1, g2, torch.cat(p2s, dim=1))
    if save_res:
        out += tuple(torch.cat(t, dim=1) for t in (a11s, a21s, a22s))
    return out


def block12_bwd_deep_plain(a21, a22, dp2, m2sq, s2, weights, pooling="max",
                           compute_dtype="bfloat16", tb=None):
    """Plain PyTorch deep backward in bands of tb full-resolution rows (by
    default `band_rows(H, W)`): dp1 (64, H/2, W/2) in cdt; a batch (a21 (B,
    128, H/2, W/2)) pair by pair."""
    h2, w2 = a21.shape[-2:]
    tb = tb or band_rows(2 * h2, 2 * w2)
    if a21.dim() == 4:
        return _pairwise(lambda *t: _bwd_deep_plain_one(
            *t, weights, pooling, compute_dtype, tb), a21, a22, dp2, m2sq,
            s2)
    return _bwd_deep_plain_one(a21, a22, dp2, m2sq, s2, weights, pooling,
                               compute_dtype, tb)


def _bwd_deep_plain_one(a21, a22, dp2, m2sq, s2, weights, pooling,
                        compute_dtype, tb):
    cdt = torch_dtype(compute_dtype)
    ft21 = flip_transpose_weights(weights[4])
    ft22 = flip_transpose_weights(weights[6])
    h2 = a21.shape[1]
    tb2, h1 = tb // 2, HALO // 2
    outs = []
    for i in range(2 * h2 // tb):
        a21e = _band(a21, i, tb2, h1)
        a22e = _band(a22, i, tb2, h1)
        dp2e = _band(dp2, i, tb // 4, HALO // 4)
        m2e = _band(m2sq, i, tb2, h1)
        dz22 = _pool_bwd(dp2e, a22e, pooling, cdt) * _relu_grad(a22e).to(cdt)
        dz21 = gram_dz_plain(a21e, m2e, s2, conv3x3_acc(dz22, ft22), cdt)
        outs.append(conv3x3_acc(dz21, ft21)[:, h1:h1 + tb2].to(cdt))
    return torch.cat(outs, dim=1)


def block12_bwd_shallow_plain(a11, dp1, m1sq, s1, weights, pooling="max",
                              compute_dtype="bfloat16", tb=None):
    """Plain PyTorch shallow backward in bands of tb rows (by default
    `band_rows(H, W)`): dx (3, H, W) fp32; a batch (a11 (B, 64, H, W)) pair
    by pair."""
    tb = tb or band_rows(*a11.shape[-2:])
    if a11.dim() == 4:
        return _pairwise(lambda *t: _bwd_shallow_plain_one(
            *t, weights, pooling, compute_dtype, tb), a11, dp1, m1sq, s1)
    return _bwd_shallow_plain_one(a11, dp1, m1sq, s1, weights, pooling,
                                  compute_dtype, tb)


def _bwd_shallow_plain_one(a11, dp1, m1sq, s1, weights, pooling,
                           compute_dtype, tb):
    cdt = torch_dtype(compute_dtype)
    ft11 = flip_transpose_weights(weights[0])
    ft12 = flip_transpose_weights(weights[2])
    h = a11.shape[1]
    outs = []
    for i in range(h // tb):
        a11e = _band(a11, i, tb, HALO)
        dp1e = _band(dp1, i, tb // 2, HALO // 2)
        m1e = _band(m1sq, i, tb, HALO)
        rm0 = _row_mask(i, tb, HALO, h, a11e.shape[1], a11.device)
        a12e = _conv_bias_relu(a11e, weights[2], weights[3], rm0, cdt)
        dz12 = _pool_bwd(dp1e, a12e, pooling, cdt) * _relu_grad(a12e).to(cdt)
        dz11 = gram_dz_plain(a11e, m1e, s1, conv3x3_acc(dz12, ft12), cdt)
        outs.append(conv3x3_acc(dz11, ft11)[:, HALO:HALO + tb])
    return torch.cat(outs, dim=1)


# --- kernel wrappers ----------------------------------------------------------

def _walk(h: int, w: int, pooling: str) -> int:
    """An entry point's band height at an h × w image, `band_rows(h, w)`,
    after checking the geometry and pooling; recorded in `last_band_rows`
    and `last_rows_walked`."""
    global last_band_rows, last_rows_walked
    if h % BAND_ROWS[-1] or w % 4:
        raise ValueError(f"block12: needs H % {BAND_ROWS[-1]} == 0 and "
                         f"W % 4 == 0; got H={h}, W={w}")
    if pooling not in ("max", "avg"):
        raise ValueError(f"block12: unknown pooling {pooling!r}")
    tb = band_rows(h, w)
    last_band_rows, last_rows_walked = tb, (tb + 2 * HALO) / tb
    return tb


def _check_weights(weights: tuple, cdt) -> Block12Weights:
    if len(weights) != len(Block12Weights._fields):
        raise ValueError("block12: weights are pack_weights' "
                         f"{len(Block12Weights._fields)} tensors")
    wts = Block12Weights(*weights)
    for i, name in enumerate(B12):
        cin, cout = _CINOUT[name]
        kernels.require(wts[2 * i], name + " w", (cout, cin, 3, 3), cdt)
        kernels.require(wts[2 * i + 1], name + " b", (cout,), torch.float32)
        kernels.require(wts[8 + i], name + " packed",
                        (cout, 32) if cin == 3 and cdt == torch.bfloat16
                        else (9, cout, -(-cin // 8) * 8), cdt)
        kernels.require(wts[12 + i], name + " packed input gradient",
                        (9, cin, cout), cdt)
        for t, what in ((wts[8 + i], " packed"),
                        (wts[12 + i], " packed input gradient")):
            kernels.require_aligned(t, name + what)
    return wts


def _pairs(lead: tuple[int, ...]) -> int:
    return lead[0] if lead else 1


def _scratch(which: int, k: int, h: int, w: int, tb: int, cdt,
             device) -> tuple[torch.Tensor, int]:
    group = group_bands(h, w, tb)
    n = kernels.library().dpst_block12_scratch_bytes(
        which, k, h, w, group, tb, kernels.DTYPE_CODES[cdt])
    return torch.empty(n, dtype=torch.uint8, device=device), group


def _lead(t: torch.Tensor, what: str, dims: int) -> tuple[int, ...]:
    """() for a `dims`-D operand of one pair, (B,) for a batch of B."""
    if t.dim() not in (dims, dims + 1):
        raise ValueError(f"block12: {what} must be {dims}-D, or {dims + 1}-D "
                         f"with a leading pair axis; got {tuple(t.shape)}")
    return tuple(t.shape[:t.dim() - dims])


def _fwd(x, m1sq, m2sq, weights, pooling, compute_dtype, save_res):
    cdt = torch_dtype(compute_dtype)
    lead = _lead(x, "x", 3)
    if x.shape[-3] != 3:
        raise ValueError(f"block12: x must be (3, H, W) or (B, 3, H, W), "
                         f"got {tuple(x.shape)}")
    h, w = x.shape[-2:]
    k = m1sq.shape[-3]
    tb = _walk(h, w, pooling)
    kernels.require(x, "x", None, torch.float32)
    kernels.require(m1sq, "m1sq", (*lead, k, h, w), torch.float32)
    kernels.require(m2sq, "m2sq", (*lead, k, h // 2, w // 2), torch.float32)
    wts = _check_weights(weights, cdt)
    if not kernels.on_cuda(x, m1sq, m2sq, *weights):
        return block12_fwd_plain(x, m1sq, m2sq, weights, pooling, cdt,
                                 save_res, tb)
    dev = x.device

    def out(*shape, dtype=cdt):
        return torch.empty((*lead, *shape), dtype=dtype, device=dev)

    g1 = out(k, 64, 64, dtype=torch.float32)
    g2 = out(k, 128, 128, dtype=torch.float32)
    p2 = out(128, h // 4, w // 4)
    res = ((out(64, h, w), out(128, h // 2, w // 2), out(128, h // 2, w // 2))
           if save_res else (None, None, None))
    scratch, group = _scratch(0, k, h, w, tb, cdt, dev)
    name = "block12_fwd_res" if save_res else "block12_fwd"
    rc = kernels.library().dpst_block12_fwd(
        *map(kernels.ptr, (x, m1sq, m2sq, wts.k11, wts.b11, wts.k12, wts.b12,
                           wts.k21, wts.b21, wts.k22, wts.b22, g1, g2, p2,
                           *res, scratch)),
        k, h, w, group, tb, _pairs(lead), int(pooling == "avg"),
        int(save_res), kernels.DTYPE_CODES[cdt], kernels.stream_ptr(x))
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return (g1, g2, p2) + (res if save_res else ())


def block12_fwd(x: torch.Tensor, m1sq: torch.Tensor, m2sq: torch.Tensor,
                weights: tuple, *, pooling: str = "max",
                compute_dtype="bfloat16") -> tuple:
    """x (3, H, W) fp32 preprocessed planes, m1sq (K, H, W) and m2sq (K,
    H/2, W/2) fp32 squared masks, `pack_weights` -> (g1, g2, p2); a batch
    of B pairs with a leading pair axis on each (one launch). CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    return _fwd(x, m1sq, m2sq, weights, pooling, compute_dtype, False)


def block12_fwd_res(x: torch.Tensor, m1sq: torch.Tensor, m2sq: torch.Tensor,
                    weights: tuple, *, pooling: str = "max",
                    compute_dtype="bfloat16") -> tuple:
    """`block12_fwd` that also returns the residuals: (g1, g2, p2, a11,
    a21, a22)."""
    return _fwd(x, m1sq, m2sq, weights, pooling, compute_dtype, True)


def symmetrize(dg: torch.Tensor, compute_dtype) -> torch.Tensor:
    """round(dG_k + dG_kᵀ) in the compute dtype, the sum in fp32; dg (...,
    K, C, C)."""
    d = dg.to(torch.float32)
    return (d + d.transpose(-1, -2)).to(torch_dtype(compute_dtype)
                                        ).contiguous()


def _cotangent(s: torch.Tensor) -> torch.Tensor:
    """s = `symmetrize(dG)` as the entry points' Gram cotangent stage reads
    it: in bf16 the (C, K·C) matrix of `gram_stream.s_matrix` (the wgmma
    body's operand), in fp32 the (K, C, C) stack itself (a batch with its
    leading pair axis)."""
    if s.dtype == torch.bfloat16:
        return gram_stream.s_matrix(s).contiguous()
    return s


def block12_gram_dz(f: torch.Tensor, msq: torch.Tensor, s: torch.Tensor,
                    t: torch.Tensor, *, band_rows: int,
                    rows: tuple[int, int] | None = None) -> torch.Tensor:
    """The backward entry points' Gram cotangent stage alone, on a stacked
    group of bands of `band_rows` rows: f (C, NB·R, W) the tap and msq (K,
    NB·R, W) its m² rounded, both in the compute dtype; s (K, C, C) =
    `symmetrize(dG)`; t (C, NB·R, W) fp32, the conv term -> dz (C, NB·R,
    W) in the compute dtype, `gram_dz_plain`'s function. CPU tensors take
    the plain version on every row. CUDA tensors launch the stage's kernel:
    in bf16 the wgmma body on rows `rows` = (lo, hi) of each band (every
    row by default), widened to 16-byte boundaries (`gram_dz_plan`), the
    other rows of dz left unwritten; in fp32 the CUDA-core tile on every
    row."""
    if f.dim() != 3:
        raise ValueError(f"f must be (C, NB·R, W), got {tuple(f.shape)}")
    c, n, w = f.shape
    k, r = msq.shape[0], band_rows
    lo, hi = rows or (0, r)
    if r < 1 or n % r or not 0 <= lo < hi <= r:
        raise ValueError(f"block12_gram_dz: rows {lo}..{hi} of bands of {r} "
                         f"rows do not cut {n} rows")
    cdt = f.dtype
    kernels.require(f, "f")
    kernels.require(msq, "msq", (k, n, w), cdt)
    kernels.require(s, "s", (k, c, c), cdt)
    kernels.require(t, "t", (c, n, w), torch.float32)
    if not kernels.on_cuda(f, msq, s, t):
        return gram_dz_plain(f, msq, s, t, cdt)
    if (r * w) % 8:
        raise ValueError(f"block12_gram_dz: a band of {r} x {w} pixels is "
                         "not a whole number of 16-byte rows")
    for x, what in ((f, "f"), (msq, "msq"), (t, "t")):
        kernels.require_aligned(x, what)
    dz = torch.empty_like(f)
    sm = _cotangent(s)
    rc = kernels.library().dpst_block12_gram_dz(
        *map(kernels.ptr, (f, msq, sm, t, dz)), c, k, n // r, r,
        w, lo, hi, kernels.DTYPE_CODES[cdt], kernels.stream_ptr(f))
    kernels.check(rc, "block12_gram_dz")
    kernels.LAUNCHES["block12_gram_dz"] += 1
    return dz


def block12_bwd_deep(a21, a22, dp2, m2sq, s2, weights, *,
                     pooling: str = "max", compute_dtype="bfloat16"
                     ) -> torch.Tensor:
    """pool2 → conv2_2 → conv2_1 backward with the conv2_1 Gram term: dp1
    (64, H/2, W/2) in the compute dtype from the residuals a21, a22, the
    pool2 cotangent dp2 and s2 = `symmetrize(dG2)`; a batch of B pairs
    with a leading pair axis on each (one launch)."""
    cdt = torch_dtype(compute_dtype)
    lead = _lead(a21, "a21", 3)
    h2, w2 = a21.shape[-2:]
    h, w = 2 * h2, 2 * w2
    k = m2sq.shape[-3]
    tb = _walk(h, w, pooling)
    kernels.require(a21, "a21", (*lead, 128, h2, w2), cdt)
    kernels.require(a22, "a22", (*lead, 128, h2, w2), cdt)
    kernels.require(dp2, "dp2", (*lead, 128, h // 4, w // 4), cdt)
    kernels.require(m2sq, "m2sq", (*lead, k, h2, w2), torch.float32)
    kernels.require(s2, "s2", (*lead, k, 128, 128), cdt)
    wts = _check_weights(weights, cdt)
    if not kernels.on_cuda(a21, a22, dp2, m2sq, s2, *weights):
        return block12_bwd_deep_plain(a21, a22, dp2, m2sq, s2, weights,
                                      pooling, cdt, tb)
    dp1 = torch.empty((*lead, 64, h2, w2), dtype=cdt, device=a21.device)
    scratch, group = _scratch(1, k, h, w, tb, cdt, a21.device)
    sm = _cotangent(s2)
    rc = kernels.library().dpst_block12_bwd_deep(
        *map(kernels.ptr, (a21, a22, dp2, m2sq, sm, wts.t21, wts.t22, dp1,
                           scratch)),
        k, h, w, group, tb, _pairs(lead), int(pooling == "avg"),
        kernels.DTYPE_CODES[cdt], kernels.stream_ptr(a21))
    kernels.check(rc, "block12_bwd_deep")
    kernels.LAUNCHES["block12_bwd_deep"] += 1
    return dp1


def block12_bwd_shallow(a11, dp1, m1sq, s1, weights, *,
                        pooling: str = "max", compute_dtype="bfloat16"
                        ) -> torch.Tensor:
    """conv1_2 recomputed from a11, then pool1 → conv1_2 → conv1_1 backward
    with the conv1_1 Gram term: dx (3, H, W) fp32 from dp1 and s1 =
    `symmetrize(dG1)`; a batch of B pairs with a leading pair axis on each
    (one launch)."""
    cdt = torch_dtype(compute_dtype)
    lead = _lead(a11, "a11", 3)
    h, w = a11.shape[-2:]
    k = m1sq.shape[-3]
    tb = _walk(h, w, pooling)
    kernels.require(a11, "a11", (*lead, 64, h, w), cdt)
    kernels.require(dp1, "dp1", (*lead, 64, h // 2, w // 2), cdt)
    kernels.require(m1sq, "m1sq", (*lead, k, h, w), torch.float32)
    kernels.require(s1, "s1", (*lead, k, 64, 64), cdt)
    wts = _check_weights(weights, cdt)
    if not kernels.on_cuda(a11, dp1, m1sq, s1, *weights):
        return block12_bwd_shallow_plain(a11, dp1, m1sq, s1, weights,
                                         pooling, cdt, tb)
    dx = torch.empty((*lead, 3, h, w), dtype=torch.float32,
                     device=a11.device)
    scratch, group = _scratch(2, k, h, w, tb, cdt, a11.device)
    sm = _cotangent(s1)
    rc = kernels.library().dpst_block12_bwd_shallow(
        *map(kernels.ptr, (a11, dp1, m1sq, sm, wts.t11, wts.t12, wts.k12,
                           wts.b12, dx, scratch)),
        k, h, w, group, tb, _pairs(lead), int(pooling == "avg"),
        kernels.DTYPE_CODES[cdt], kernels.stream_ptr(a11))
    kernels.check(rc, "block12_bwd_shallow")
    kernels.LAUNCHES["block12_bwd_shallow"] += 1
    return dx


def block12_bwd(a11, a21, a22, dp2, m1sq, m2sq, dg1, dg2, weights, *,
                pooling: str = "max", compute_dtype="bfloat16"
                ) -> torch.Tensor:
    """Backward of `block12_fwd_res` wrt the image planes: the deep half,
    then the shallow half; dx (3, H, W) fp32 (a batch with its leading
    pair axis)."""
    kw = dict(pooling=pooling, compute_dtype=compute_dtype)
    dp1 = block12_bwd_deep(a21, a22, dp2, m2sq,
                           symmetrize(dg2, compute_dtype), weights, **kw)
    return block12_bwd_shallow(a11, dp1, m1sq,
                               symmetrize(dg1, compute_dtype), weights, **kw)


class Block12(torch.autograd.Function):
    """(x, m1sq, m2sq, weights) -> (g1, g2, p2) with the backward of
    `block12_bwd`. Masks and weights are constants of the optimization: no
    gradient flows to them."""

    @staticmethod
    def forward(ctx, x, m1sq, m2sq, opts, *weights):
        pooling, compute_dtype = opts
        g1, g2, p2, a11, a21, a22 = block12_fwd_res(
            x, m1sq, m2sq, weights, pooling=pooling,
            compute_dtype=compute_dtype)
        ctx.opts = opts
        ctx.save_for_backward(m1sq, m2sq, a11, a21, a22, *weights)
        return g1, g2, p2

    @staticmethod
    def backward(ctx, dg1, dg2, dp2):
        m1sq, m2sq, a11, a21, a22, *weights = ctx.saved_tensors
        pooling, compute_dtype = ctx.opts
        dx = block12_bwd(a11, a21, a22,
                         dp2.to(torch_dtype(compute_dtype)).contiguous(),
                         m1sq, m2sq, dg1.contiguous(), dg2.contiguous(),
                         tuple(weights), pooling=pooling,
                         compute_dtype=compute_dtype)
        return (dx, None, None, None) + (None,) * len(weights)


def make_block12_fused(*, pooling: str = "max", compute_dtype="bfloat16"):
    """The differentiable blocks-1-2 op: f(x, m1sq, m2sq, weights) -> (g1,
    g2, p2), with x the (3, H, W) fp32 `preprocess_noflip` planes, or a
    batch (B, 3, H, W) with masks (B, K, ...) in one launch of each entry
    point, and `weights` from `pack_weights`."""
    opts = (pooling, compute_dtype)

    def fused(x, m1sq, m2sq, weights):
        return Block12.apply(x, m1sq, m2sq, opts, *weights)

    return fused
