"""On the card: the forms of the hand-written kernels that take the VGG's
channels_last activations as they lie (the bias+ReLU pair's and the pool
backward's NHWC forms, the Gram kernels' (P, C) forms) EQUAL their NCHW /
(C, P) twins bit for bit, at the channel counts of a 2048² step on small
pixel counts, on batches, on ragged shapes and where the plans split; and
the bf16 cuDNN route keeps a batch's pairs bit-equal to their runs alone.

Marked `card`: every test skips without a CUDA device. Run on the card,
without the CPU suite's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_nhwc_card.py
"""
import pytest
import torch

from dpst_tpu_torch.models import vgg
from dpst_tpu_torch.ops import bias_relu_cuda as br
from dpst_tpu_torch.ops import gram_pallas as gp
from dpst_tpu_torch.ops import gram_s2d as g2
from dpst_tpu_torch.ops import gram_stream as gs
from dpst_tpu_torch.ops import kernels, losses
from dpst_tpu_torch.ops import pool_cuda

pytestmark = pytest.mark.card

CL = torch.channels_last
# (C, H, W) of the taps of a 2048² step, cut to a few thousand pixels
STEP_CHANNELS = (64, 128, 256, 512)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(
        torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _same(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(_bits(a), _bits(b))


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _launched(name):
    return kernels.LAUNCHES[name]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 64, 32, 48), (1, 128, 16, 24),
                                   (1, 256, 16, 16), (1, 512, 8, 12),
                                   (8, 64, 16, 16), (3, 5, 7, 9),
                                   (2, 24, 5, 3)])
def test_bias_relu_nhwc_equals_nchw(dev, shape, dtype):
    gen = _gen(dev, sum(shape))
    z = torch.randn(shape, generator=gen, device=dev).to(dtype)
    b = (torch.randn(shape[1], generator=gen, device=dev) * 0.5).to(dtype)
    z[:, :, ::3] = -b[:, None, None]          # exact zeros of z + b
    g = torch.randn(shape, generator=gen, device=dev).to(dtype)
    zc, gc = z.contiguous(memory_format=CL), g.contiguous(memory_format=CL)
    before = _launched("bias_relu_fwd_nhwc"), _launched("bias_relu_bwd_nhwc")
    y, dz = br.bias_relu_fwd(zc, b), br.bias_relu_bwd(zc, b, gc)
    assert (_launched("bias_relu_fwd_nhwc"),
            _launched("bias_relu_bwd_nhwc")) == (before[0] + 1, before[1] + 1)
    assert kernels.channels_last(y) and kernels.channels_last(dz)
    _same(y, br.bias_relu_fwd(z, b))
    _same(dz, br.bias_relu_bwd(z, b, g))
    _same(y, br.bias_relu_fwd_plain(z, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 64, 64, 64), (1, 512, 16, 16),
                                   (8, 128, 16, 16), (2, 64, 17, 15),
                                   (2, 6, 9, 10)])
def test_pool_bwd_nhwc_equals_nchw(dev, shape, dtype):
    gen = _gen(dev, sum(shape))
    x = torch.relu(torch.round(torch.randn(shape, generator=gen, device=dev)
                               * 4) / 4).to(dtype)          # many ties
    y = torch.nn.functional.max_pool2d(x, 2, 2)
    g = torch.randn(y.shape, generator=gen, device=dev).to(dtype)
    xc, yc, gc = (t.contiguous(memory_format=CL) for t in (x, y, g))
    before = _launched("pool_bwd_nhwc")
    gx = pool_cuda.maxpool2_bwd_nhwc(xc, yc, gc)
    assert _launched("pool_bwd_nhwc") == before + 1
    assert gx.is_contiguous(memory_format=CL)
    fold = lambda t: t.reshape(-1, *t.shape[2:])
    ref = pool_cuda.maxpool2_bwd(fold(x), fold(y), fold(g)).reshape(x.shape)
    _same(gx, ref)


def _tap(dev, b, c, p, k, seed, raw=False):
    """A (B, C, P) tap lying (P, C), its (C, P) copy, m², a cotangent, a
    bias."""
    gen = _gen(dev, seed)
    t = torch.randn((b, p, c), generator=gen, device=dev)
    t = (t if raw else t.abs()).to(torch.bfloat16)
    f_pc = t.transpose(-1, -2)
    m = torch.rand((b, k, p), generator=gen, device=dev)
    m2 = (m * m).to(torch.bfloat16)
    d = torch.randn((b, k, c, c), generator=gen, device=dev)
    s = (d + d.transpose(-1, -2)).to(torch.bfloat16).contiguous()
    bias = (torch.randn(c, generator=gen, device=dev) * 0.5).to(
        torch.bfloat16)
    if raw:
        f_pc[:, :, ::7] = -bias[:, None]     # exact zeros of z + b
    return f_pc, f_pc.contiguous(), m2, s, bias


# (B, C, P, K): a 2048² step's channel counts on small P (the backwards
# split their reductions there), a batch, K = 8; and P not a multiple of 8
# (the masks padded to P8, F's rows and dF's bounded by P), B = 1 and 2:
# 1001, and 2852, conv5_1 of a 1000×750 image (62×46)
GRAM_CASES = [(1, c, p, 4) for c in STEP_CHANNELS for p in (4096, 1000)]
GRAM_CASES += [(1, 64, 70000, 8), (2, 128, 3000, 4), (3, 64, 2048, 5),
               (1, 256, 20000, 8)]
GRAM_CASES += [(b, c, p, 4) for b in (1, 2)
               for c, p in ((128, 1001), (512, 2852))]


@pytest.mark.parametrize("b,c,p,k", GRAM_CASES)
def test_gram_pc_forms_equal_their_twins(dev, b, c, p, k):
    f_pc, f, m2, s, bias = _tap(dev, b, c, p, k, seed=c + p + k)
    if b == 1:
        f_pc, f, m2, s = f_pc[0], f[0], m2[0], s[0]
    assert kernels.channels_last(f_pc, -2)
    assert not kernels.channels_last(f, -2)
    names = ("gram_fwd_pc", "gram_bwd_pc", "gram_wbwd_pc")
    before = [_launched(n) for n in names]
    g, dff, dfw = (gs.gram_fwd(f_pc, m2), gs.gram_bwd(f_pc, m2, s),
                   gp.gram_wbwd(f_pc, m2, s))
    assert [_launched(n) for n in names] == [n + 1 for n in before]
    _same(g, gs.gram_fwd(f, m2))
    assert kernels.channels_last(dff, -2) and kernels.channels_last(dfw, -2)
    _same(dff, gs.gram_bwd(f, m2, s))
    _same(dfw, gp.gram_wbwd(f, m2, s))


# the fused pair: conv1_1's C = 64 (its own backward body up to K = 8, one
# split), K = 9 and C = 128 (gram_wbwd's body, the classes split), and P
# not a multiple of 8 on both bodies, B = 1 and 2
@pytest.mark.parametrize("b,c,p,k", [(1, 64, 4096, 4), (1, 64, 70000, 8),
                                     (1, 64, 1000, 4), (2, 64, 3000, 4),
                                     (1, 64, 5000, 9), (1, 128, 3000, 4),
                                     (1, 64, 1001, 4), (2, 64, 2852, 4),
                                     (1, 128, 1001, 4), (2, 128, 2852, 4)])
def test_gram_relu_pc_forms_equal_their_twins(dev, b, c, p, k):
    z_pc, z, m2, s, bias = _tap(dev, b, c, p, k, seed=c * p + k, raw=True)
    if b == 1:
        z_pc, z, m2, s = z_pc[0], z[0], m2[0], s[0]
    names = ("gram_relu_fwd_pc", "gram_relu_bwd_pc")
    before = [_launched(n) for n in names]
    g, dz = g2.gram_relu_fwd(z_pc, bias, m2), g2.gram_relu_bwd(z_pc, bias,
                                                               m2, s)
    assert [_launched(n) for n in names] == [n + 1 for n in before]
    _same(g, g2.gram_relu_fwd(z, bias, m2))
    assert kernels.channels_last(dz, -2)
    _same(dz, g2.gram_relu_bwd(z, bias, m2, s))


def _taps_and_grads(params, images, route_masks):
    """Taps, raw Grams of each route and the image's gradient of a bf16 VGG
    pass on the card (the channels_last route). The Grams are left
    unnormalized: the masks' norms are ATen reductions over the batch."""
    images = images.clone().requires_grad_(True)
    layers = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv4_2",
              "conv5_1")
    taps = vgg.extract_features(params, images, layers,
                                compute_dtype="bfloat16",
                                raw_taps=("conv1_1",))
    grams, total = {}, 0
    for layer, t in taps.items():
        m = route_masks[layer]
        m2 = (m * m).to(torch.bfloat16).flatten(-2).contiguous()
        if isinstance(t, g2.RawTap):
            g = g2.GramReluRaw.apply(t.z.flatten(-2), t.b, m2)
        elif layer == "conv2_1":          # the "stream" route's Function
            g = gp.weighted_grams(t.flatten(-2), m2)
        else:                             # the fused route's
            g = gs.masked_grams_raw(t.flatten(-2), m2)
        grams[layer] = g
        total = total + (g * g).sum()
    total = total + losses.content_loss(taps["conv4_2"],
                                        taps["conv4_2"].detach() * 0.5).sum()
    (grad,) = torch.autograd.grad(total, images)
    return taps, grams, grad


def test_channels_last_route_keeps_a_pair_equal_to_its_run_alone(dev):
    gen = _gen(dev, 27)
    params = vgg.pack_params(vgg.init_params(3, device=dev), "bfloat16")
    assert params.channels_last
    images = torch.rand((2, 64, 96, 3), generator=gen, device=dev) * 255
    masks = {l: torch.rand((2, 3, 64 >> i, 96 >> i), generator=gen,
                           device=dev)
             for l, i in (("conv1_1", 0), ("conv2_1", 1), ("conv3_1", 2),
                          ("conv4_1", 3), ("conv4_2", 3), ("conv5_1", 4))}
    taps, grams, grad = _taps_and_grads(params, images, masks)
    for layer, t in taps.items():
        t = t.z if isinstance(t, g2.RawTap) else t
        assert kernels.channels_last(t), layer
    for i in range(2):
        one = {l: m[i:i + 1] for l, m in masks.items()}
        taps1, grams1, grad1 = _taps_and_grads(params, images[i:i + 1], one)
        for layer in taps:
            a, b = taps[layer], taps1[layer]
            a, b = ((a.z, b.z) if isinstance(a, g2.RawTap) else (a, b))
            _same(a[i:i + 1], b)
            _same(grams[layer][i:i + 1], grams1[layer])
        _same(grad[i:i + 1], grad1)


@pytest.mark.parametrize("dtype,conv_impl,cl", [
    ("bfloat16", "auto", True), ("float32", "auto", False),
    ("bfloat16", "pallas", False)])
def test_route_on_the_card(dev, dtype, conv_impl, cl):
    params = vgg.init_params(4, device=dev)
    image = torch.rand((32, 32, 3), device=dev) * 255
    taps = vgg.extract_features(params, image, ("conv1_1", "conv3_1"),
                                compute_dtype=dtype, conv_impl=conv_impl)
    for t in taps.values():
        assert kernels.channels_last(t[None]) == cl
