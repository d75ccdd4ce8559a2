"""The VGG's channels_last route on the CPU, at 48 px: `_run_layers` follows
the memory format of the batch it is given, and a channels_last batch
gives the contiguous batch's taps, Grams (the fused route, the "stream"
route with its weighted-after backward, the raw-tap bias+ReLU pair) and
image gradient, with every tap and raw conv output channels_last; the
plain versions of the kernels' NHWC and (P, C) forms equal the NCHW
plain versions; the route is taken only for a CUDA tensor in bf16 on
cuDNN's convs (fp32, `conv_impl="pallas"`, `extract_tail` and every CPU
pass stay NCHW); and on tensors taken as on the card the wrappers launch
the new forms on the operands as they lie (no copy), counted under their
own names. The kernels themselves are held to their twins on the card
(`tests/test_torch_nhwc_card.py`, `chip_smoke.py`)."""
import ctypes

import numpy as np
import pytest
import torch

from dpst_tpu_torch.models import vgg
from dpst_tpu_torch.ops import bias_relu_cuda as br
from dpst_tpu_torch.ops import gram_pallas as gp
from dpst_tpu_torch.ops import gram_s2d as g2
from dpst_tpu_torch.ops import gram_stream as gs
from dpst_tpu_torch.ops import kernels, losses, pool_cuda

CL = torch.channels_last
LAYERS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv4_2", "conv5_1")
DEEPEST = vgg.LAYER_ORDER[:vgg.LAYER_ORDER.index("conv5_1") + 1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the CPU's threaded reductions may round a run apart from the next
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return vgg.init_params(seed=5)


def _bits(t):
    return t.contiguous().view(
        torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _same(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(_bits(a), _bits(b))


def _close(got, ref, rel):
    got, ref = got.detach().double(), ref.detach().double()
    assert got.shape == ref.shape
    scale = max(float(ref.abs().max()), 1e-30)
    assert float((got - ref).abs().max()) <= rel * scale


def _pass(params, dtype, images, channels_last, route):
    """Taps, Grams and the images' gradient of a VGG pass to conv5_1 on a
    batch, its activations channels_last or not; `route` takes every
    style tap's Grams on the fused route, the "stream" route, or conv1_1
    as a raw tap through the fused bias+ReLU pair."""
    images = images.clone().requires_grad_(True)
    x = vgg.preprocess(images, channels_last).to(vgg.torch_dtype(dtype))
    raw = ("conv1_1",) if route == "raw" else ()
    taps = vgg._run_layers(vgg.pack_params(params, dtype), x, DEEPEST,
                           LAYERS, "max", "auto", raw)
    gen = torch.Generator().manual_seed(3)
    grams, total = {}, 0
    for layer, t in taps.items():
        feat = t.z if isinstance(t, g2.RawTap) else t
        masks = torch.rand((images.shape[0], 3, *feat.shape[-2:]),
                           generator=gen)
        if isinstance(t, g2.RawTap):
            g = g2.masked_grams_relu(t.z, t.b, masks)
        else:
            g = losses.route_grams("stream" if route == "stream" else "fused",
                                   t, masks, dtype)
        grams[layer] = g
        total = total + (g * g).sum()
    total = total + losses.content_loss(
        taps["conv4_2"], taps["conv4_2"].detach() * 0.5).sum()
    (grad,) = torch.autograd.grad(total, images)
    return taps, grams, grad


@pytest.mark.parametrize("route", ["fused", "stream", "raw"])
@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
def test_channels_last_batch_equals_the_contiguous_batch(params, route,
                                                         dtype, rel):
    images = torch.rand((2, 48, 48, 3),
                        generator=torch.Generator().manual_seed(1)) * 255
    ref_taps, ref_grams, ref_grad = _pass(params, dtype, images, False,
                                          route)
    taps, grams, grad = _pass(params, dtype, images, True, route)
    for layer in LAYERS:
        t, r = taps[layer], ref_taps[layer]
        if isinstance(t, g2.RawTap):
            assert route == "raw" and layer == "conv1_1"
            t, r = t.z, r.z
        assert t.is_contiguous(memory_format=CL), layer
        assert r.is_contiguous(), layer
        _close(t, r, rel)
        _close(grams[layer], ref_grams[layer], rel)
    # the images' gradient comes back in their own (N, H, W, 3) layout
    assert grad.is_contiguous()
    _close(grad, ref_grad, rel)


@pytest.mark.parametrize("fmt", [torch.contiguous_format, CL])
def test_per_image_conv_keeps_the_batch_layout(fmt):
    """The card's bf16 batch runs cuDNN one call an image
    (`vgg.per_image_conv2d`): the batch's convolution, output and input
    gradient in the batch's layout, and a channels_last batch joined and
    split along its memory view (no copy but the `cat`s)."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((3, 16, 10, 12), generator=gen).contiguous(
        memory_format=fmt).requires_grad_(True)
    w = torch.randn((8, 16, 3, 3), generator=gen).contiguous(
        memory_format=fmt)
    g = torch.randn((3, 8, 10, 12), generator=gen).contiguous(
        memory_format=fmt)
    with torch.profiler.profile() as prof:
        y = vgg.per_image_conv2d(x, w)
        (gx,) = torch.autograd.grad(y, x, g)
    _close(y, torch.nn.functional.conv2d(x, w, padding=1), 1e-6)
    assert y.is_contiguous(memory_format=fmt)
    assert gx.is_contiguous(memory_format=fmt)
    if fmt == CL:
        ops = {e.key for e in prof.key_averages()}
        assert not ops & {"aten::copy_", "aten::clone", "aten::stack"}


@pytest.mark.parametrize("lead", [(), (2,)])
def test_content_loss_keeps_a_channels_last_gradient(lead):
    gen = torch.Generator().manual_seed(6)
    a = torch.randn((*lead, 8, 5, 6), generator=gen)
    b = torch.randn((*lead, 8, 5, 6), generator=gen)
    cl = lambda t: (t.contiguous(memory_format=CL) if t.dim() == 4
                    else t.permute(1, 2, 0).contiguous().permute(2, 0, 1))
    x, xc = a.clone().requires_grad_(True), cl(a).requires_grad_(True)
    ref, got = losses.content_loss(x, b), losses.content_loss(xc, cl(b))
    _close(got, ref, 1e-6)
    (g,) = torch.autograd.grad(ref.sum(), x)
    (gc,) = torch.autograd.grad(got.sum(), xc)
    assert gc.stride() == xc.stride()          # the tap's own layout
    _close(gc, g, 1e-6)


def _bias_relu_operands(shape, dtype, seed):
    r = np.random.default_rng(seed)
    c = shape[1]
    b = torch.from_numpy(r.normal(scale=0.5, size=(c,)).astype(
        np.float32)).to(dtype)
    z = torch.from_numpy(r.normal(size=shape).astype(np.float32)).to(dtype)
    z[:, :, ::3] = -b[:, None, None]             # exact zeros of z + b
    flat = z.view(-1)
    for i, v in enumerate((-0.0, float("nan"), float("inf"), -float("inf"))):
        flat[(i + 1) * flat.numel() // 5] = v
    g = torch.from_numpy(r.normal(size=shape).astype(np.float32)).to(dtype)
    return z, b, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 16, 6, 10), (3, 5, 7, 9)])
def test_bias_relu_nhwc_plain_equals_nchw_plain(shape, dtype):
    z, b, g = _bias_relu_operands(shape, dtype, seed=sum(shape))
    zc, gc = z.contiguous(memory_format=CL), g.contiguous(memory_format=CL)
    before = dict(kernels.LAUNCHES)
    y, dz = br.bias_relu_fwd(zc, b), br.bias_relu_bwd(zc, b, gc)
    assert kernels.LAUNCHES == before          # CPU: the plain versions
    assert kernels.channels_last(y) and kernels.channels_last(dz)
    _same(y, br.bias_relu_fwd_plain(z, b))
    _same(dz, br.bias_relu_bwd_plain(z, b, g))
    with pytest.raises(ValueError):
        br.bias_relu_bwd(zc, b, g)             # g must lie as z does


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 6, 8, 10), (1, 4, 9, 7),
                                   (3, 8, 2, 2)])
def test_pool_bwd_nhwc_plain_equals_nchw_plain(shape, dtype):
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.relu(torch.round(torch.randn(shape, generator=gen) * 4)
                   / 4).to(dtype)              # many tied maxima
    y = torch.nn.functional.max_pool2d(x, 2, 2)
    g = torch.randn(y.shape, generator=gen).to(dtype)
    xc, yc, gc = (t.contiguous(memory_format=CL) for t in (x, y, g))
    gx = pool_cuda.maxpool2_bwd_nhwc(xc, yc, gc)
    assert gx.is_contiguous(memory_format=CL)
    ref = torch.stack([pool_cuda.maxpool2_bwd_plain(x[i], y[i], g[i])
                       for i in range(shape[0])])
    _same(gx, ref)


def test_max_pool_function_takes_the_nhwc_backward():
    gen = torch.Generator().manual_seed(8)
    x = torch.relu(torch.round(torch.randn((2, 4, 6, 6), generator=gen) * 2)
                   / 2).requires_grad_(True)
    xc = x.detach().contiguous(memory_format=CL).requires_grad_(True)
    y, yc = vgg._MaxPool2.apply(x), vgg._MaxPool2.apply(xc)
    assert yc.is_contiguous(memory_format=CL)
    g = torch.randn(y.shape, generator=gen)
    (gx,) = torch.autograd.grad(y, x, g)
    (gxc,) = torch.autograd.grad(yc, xc, g)      # a contiguous cotangent
    assert gxc.is_contiguous(memory_format=CL)
    _same(gxc, gx)


def _pc_operands(b, c, p, k, dtype, seed):
    r = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dtype)
    f_pc = t(np.abs(r.normal(size=(b, p, c)))).transpose(-1, -2)
    z_pc = t(r.normal(size=(b, p, c))).transpose(-1, -2)
    m2 = t(r.uniform(size=(b, k, p)) ** 2)
    s = r.normal(size=(b, k, c, c))
    s = t(s + s.transpose(0, 1, 3, 2))
    bias = t(r.normal(scale=0.5, size=(c,)))
    return f_pc, z_pc, m2, s, bias


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b", [1, 2])
def test_gram_pc_plain_forms_equal_the_cp_plain_forms(b, dtype, rel):
    c, p, k = 16, 75, 3
    f_pc, z_pc, m2, s, bias = _pc_operands(b, c, p, k, dtype, seed=b)
    if b == 1:
        f_pc, z_pc, m2, s = f_pc[0], z_pc[0], m2[0], s[0]
    assert kernels.channels_last(f_pc, -2) and kernels.channels_last(z_pc, -2)
    f, z = f_pc.contiguous(), z_pc.contiguous()
    _close(gs.gram_fwd(f_pc, m2), gs.gram_fwd(f, m2), rel)
    _close(g2.gram_relu_fwd(z_pc, bias, m2), g2.gram_relu_fwd(z, bias, m2),
           rel)
    for got, ref in ((gs.gram_bwd(f_pc, m2, s), gs.gram_bwd(f, m2, s)),
                     (gp.gram_wbwd(f_pc, m2, s), gp.gram_wbwd(f, m2, s)),
                     (g2.gram_relu_bwd(z_pc, bias, m2, s),
                      g2.gram_relu_bwd(z, bias, m2, s))):
        assert kernels.channels_last(got, -2)   # dF, dz in the tap's layout
        _close(got, ref, rel)


@pytest.mark.parametrize("device,dtype,conv_impl,route,expected", [
    ("cuda", "bfloat16", "auto", "standard", True),
    ("cuda:1", torch.bfloat16, "stream", "standard", True),
    ("cuda", "bfloat16", "auto", "stream-standard", True),
    ("cuda", "bfloat16", "auto", "kernel", False),
    ("cuda", "bfloat16", "auto", "rows", False),
    ("cuda", "float32", "auto", "standard", False),
    ("cuda", "bfloat16", "pallas", "standard", False),
    ("cpu", "bfloat16", "auto", "standard", False),
    ("cpu", "float32", "auto", "standard", False)])
def test_channels_last_route_is_cuda_bf16_cudnn(device, dtype, conv_impl,
                                                route, expected):
    assert vgg.channels_last_route(device, dtype, conv_impl,
                                   route) is expected


@pytest.mark.parametrize("shape,channels", [
    ((2, 8, 5, 6), -3), ((8, 5, 6), -3), ((8, 30), -2), ((2, 8, 30), -2)])
def test_one_predicate_for_activations_and_flattened_taps(shape, channels):
    """`kernels.channels_last`: the channel axis fastest and the tensor not
    also contiguous, for 4-D and 3-D activations and flattened taps."""
    t = torch.zeros(shape)
    moved = t.movedim(channels, -1).contiguous().movedim(-1, channels)
    assert kernels.channels_last(moved, channels)
    assert not kernels.channels_last(t, channels)
    assert not kernels.channels_last(moved.transpose(-1, -2), channels)
    if len(shape) == 4:
        assert kernels.channels_last(t.contiguous(memory_format=CL))
        assert kernels.channels_last(moved.flatten(-2), -2)


def test_cpu_passes_and_the_tail_stay_nchw(params, monkeypatch):
    """Packed on the CPU, on any route, the weights and every pass are
    NCHW. Weights packed channels_last (as on the card's route, here by
    forcing `channels_last_route`) take `extract_features` channels_last,
    with the NCHW pass's taps, and leave `extract_tail` NCHW; a packed dict
    comes back as it is, whatever route it is asked for."""
    image = torch.rand((32, 32, 3),
                       generator=torch.Generator().manual_seed(2)) * 255
    x = torch.rand((128, 8, 8), generator=torch.Generator().manual_seed(4))
    for route in ("standard", "stream-standard", "kernel", "rows"):
        nchw = vgg.pack_params(params, "bfloat16", route=route)
        assert not nchw.channels_last
        assert nchw["conv2_1"]["wc"].is_contiguous()
        taps = vgg.extract_features(nchw, image, ("conv1_1", "conv3_1"),
                                    compute_dtype="bfloat16")
        assert all(t.is_contiguous() for t in taps.values())
    monkeypatch.setattr(vgg, "channels_last_route", lambda *a: True)
    cl = vgg.pack_params(params, "bfloat16")
    assert cl.channels_last
    assert cl["conv2_1"]["wc"].is_contiguous(memory_format=CL)
    for route in ("standard", "kernel"):
        assert vgg.pack_params(cl, "bfloat16", route=route) is cl
    taps = vgg.extract_features(cl, image, ("conv1_1", "conv3_1"),
                                compute_dtype="bfloat16")
    ref = vgg.extract_features(nchw, image, ("conv1_1", "conv3_1"),
                               compute_dtype="bfloat16")
    for layer, t in taps.items():
        assert kernels.channels_last(t), layer
        _close(t, ref[layer], 1e-2)
    for packed in (cl, nchw):
        tail = vgg.extract_tail(packed, x, ("conv3_1", "conv4_1"),
                                compute_dtype="bfloat16")
        assert all(t.is_contiguous() for t in tail.values())


class _Recorder:
    """A stand-in for the kernel library that records each entry point's
    arguments and launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def on_card(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(kernels, "on_cuda", lambda *t: True)
    monkeypatch.setattr(kernels, "library", lambda: rec)
    monkeypatch.setattr(kernels, "stream_ptr", lambda t: None)
    monkeypatch.setattr(kernels, "LAUNCHES",
                        dict.fromkeys(kernels.KERNELS, 0))
    return rec


def _ptr(arg):
    return arg.value if isinstance(arg, ctypes.c_void_p) else arg


@pytest.mark.parametrize("b", [1, 3])
def test_gram_wrappers_launch_the_pc_forms_on_the_tap_as_it_lies(on_card,
                                                                 b):
    c, p, k = 64, 1000, 4                 # P padded to 1000 (a multiple of 8)
    f_pc, z_pc, m2, s, bias = _pc_operands(b, c, p - 3, k, torch.bfloat16,
                                           seed=9)
    if b == 1:
        f_pc, z_pc, m2, s = f_pc[0], z_pc[0], m2[0], s[0]
    pp = p - 3
    outs = [gs.gram_fwd(f_pc, m2), gs.gram_bwd(f_pc, m2, s),
            gp.gram_wbwd(f_pc, m2, s), g2.gram_relu_fwd(z_pc, bias, m2),
            g2.gram_relu_bwd(z_pc, bias, m2, s)]
    names = [n for n, _ in on_card.calls]
    assert names == ["dpst_gram_fwd", "dpst_gram_bwd", "dpst_gram_wbwd",
                     "dpst_gram_relu_fwd", "dpst_gram_relu_bwd"]
    args = dict(on_card.calls)
    # the entry points' C signatures: pointers, ints (the dtype and the pc
    # flag last), the stream
    assert [len(a) for _, a in on_card.calls] == [13, 15, 15, 14, 16]
    assert all(a[-3:-1] == (1, 1) for _, a in on_card.calls)  # bf16, pc
    # the tap's own storage, not a copy; (C, P, K, B) after the pointers,
    # P the tap's own, the plans at P rounded up to 8
    assert _ptr(args["dpst_gram_fwd"][0]) == f_pc.data_ptr()
    assert args["dpst_gram_fwd"][4:8] == (c, pp, k, b)
    assert args["dpst_gram_fwd"][8:10] == gs.fwd_plan(c, p, k, b)
    for name, plan in (("dpst_gram_bwd", gs.bwd_plan),
                       ("dpst_gram_wbwd", gp.wbwd_plan)):
        assert _ptr(args[name][0]) == f_pc.data_ptr()
        assert args[name][5:9] == (c, pp, k, b)
        assert args[name][9:12] == plan(c, p, k, b)
    assert _ptr(args["dpst_gram_relu_fwd"][0]) == z_pc.data_ptr()
    assert args["dpst_gram_relu_fwd"][5:9] == (c, pp, k, b)
    assert _ptr(args["dpst_gram_relu_bwd"][0]) == z_pc.data_ptr()
    assert args["dpst_gram_relu_bwd"][6:10] == (c, pp, k, b)
    assert args["dpst_gram_relu_bwd"][10:13] == g2.relu_bwd_plan(c, p, k, b)
    # dF and dz lie as the tap does
    assert all(kernels.channels_last(o, -2)
               for o in (outs[1], outs[2], outs[4]))
    assert {n: v for n, v in kernels.LAUNCHES.items() if v} == {
        n: 1 for n in ("gram_fwd_pc", "gram_bwd_pc", "gram_wbwd_pc",
                       "gram_relu_fwd_pc", "gram_relu_bwd_pc")}


@pytest.mark.parametrize("b", [1, 3])
def test_gram_wrappers_launch_contiguous_taps_with_pc_off(on_card, b):
    c, p, k = 64, 1000, 4
    f_pc, z_pc, m2, s, bias = _pc_operands(b, c, p, k, torch.bfloat16,
                                           seed=10)
    f, z = f_pc.contiguous(), z_pc.contiguous()
    if b == 1:
        f, z, m2, s = f[0], z[0], m2[0], s[0]
    gs.gram_fwd(f, m2), gs.gram_bwd(f, m2, s), gp.gram_wbwd(f, m2, s)
    g2.gram_relu_fwd(z, bias, m2), g2.gram_relu_bwd(z, bias, m2, s)
    assert all(a[-3:-1] == (1, 0) for _, a in on_card.calls)  # bf16, (C, P)
    assert _ptr(dict(on_card.calls)["dpst_gram_fwd"][0]) == f.data_ptr()
    assert {n: v for n, v in kernels.LAUNCHES.items() if v} == {
        n: 1 for n in ("gram_fwd", "gram_bwd", "gram_wbwd", "gram_relu_fwd",
                       "gram_relu_bwd")}


def test_bias_relu_and_pool_wrappers_launch_the_nhwc_forms(on_card):
    z = torch.zeros((2, 64, 6, 10), dtype=torch.bfloat16).contiguous(
        memory_format=CL)
    b = torch.zeros(64, dtype=torch.bfloat16)
    y = br.bias_relu_fwd(z, b)
    br.bias_relu_bwd(z, b, z)
    x = torch.zeros((2, 64, 7, 10), dtype=torch.bfloat16).contiguous(
        memory_format=CL)
    py = torch.zeros((2, 64, 3, 5), dtype=torch.bfloat16).contiguous(
        memory_format=CL)
    gx = pool_cuda.maxpool2_bwd_nhwc(x, py, py)
    assert [n for n, _ in on_card.calls] == [
        "dpst_bias_relu_fwd_nhwc", "dpst_bias_relu_bwd_nhwc",
        "dpst_pool2_bwd_nhwc"]
    args = dict(on_card.calls)
    assert [len(a) for _, a in on_card.calls] == [7, 8, 10]
    assert _ptr(args["dpst_bias_relu_fwd_nhwc"][0]) == z.data_ptr()
    assert args["dpst_bias_relu_fwd_nhwc"][3:5] == (z.numel(), 64)
    assert args["dpst_bias_relu_bwd_nhwc"][4:6] == (z.numel(), 64)
    assert args["dpst_pool2_bwd_nhwc"][4:8] == (2, 64, 7, 10)
    assert y.is_contiguous(memory_format=CL)
    assert gx.is_contiguous(memory_format=CL)
    assert {n: v for n, v in kernels.LAUNCHES.items() if v} == {
        "bias_relu_fwd_nhwc": 1, "bias_relu_bwd_nhwc": 1, "pool_bwd_nhwc": 1}


def test_every_new_form_counts_beside_its_twin():
    assert set(kernels.NHWC_FORMS) <= set(kernels.KERNELS)
    assert set(kernels.NHWC_FORMS.values()) <= set(kernels.KERNELS)
    for form, twin in kernels.NHWC_FORMS.items():
        assert form.startswith(twin) and form[len(twin):] in ("_nhwc", "_pc")
