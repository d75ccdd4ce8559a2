"""The VGG's bias add and ReLU as one autograd Function (`vgg._BiasRelu`,
`ops/bias_relu_cuda.py`) EQUALS the composite it replaced, `max(z + b, 0)`
with relu′(0) = ½ in an autograd Function of its own, bit for bit: forward
and backward, in bf16 and fp32, with exact zeros of z + b, signed zeros,
infinities and NaN. On the CPU the Function takes the plain versions; the
CUDA kernels are held to the same composite by `chip_smoke.py`."""
import numpy as np
import pytest
import torch

from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.ops import bias_relu_cuda as br
from dpst_tpu_torch.ops import kernels


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the CPU's threaded reductions may round a run apart from the next
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _CompositeRelu(torch.autograd.Function):
    """The ReLU the Function replaced, applied to z + b[:, None, None]."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp_min(x, 0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x > 0, g, torch.where(x == 0, g * 0.5,
                                                 torch.zeros_like(g)))


def _composite(z, b):
    return _CompositeRelu.apply(z + b[:, None, None])


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_bits(a), _bits(b))


def _operands(shape, dtype, seed=0):
    """z with exact zeros of z + b, -0.0 (also against a -0.0 bias), ±inf
    and NaN; b with a -0.0 and a +0.0 channel; a cotangent g."""
    r = np.random.default_rng(seed)
    c = shape[-3]
    b = r.normal(scale=0.5, size=(c,)).astype(np.float32)
    b[0] = -0.0
    if c > 1:
        b[1] = 0.0
    z = r.normal(size=shape).astype(np.float32)
    zb = torch.from_numpy(b).to(dtype).float().numpy()
    # exact zeros of z + b: z = -b in the dtype
    zero = r.uniform(size=shape) < 0.15
    z[zero] = -np.broadcast_to(zb[:, None, None], shape)[zero]
    flat = z.reshape(-1)
    n = flat.size
    flat[0] = -0.0                  # channel 0's first pixel: -0 + -0
    for i, v in enumerate((-0.0, np.nan, np.inf, -np.inf), start=1):
        flat[i * n // 5] = v
    g = r.normal(size=shape).astype(np.float32)
    return (torch.from_numpy(z).to(dtype), torch.from_numpy(b).to(dtype),
            torch.from_numpy(g).to(dtype))


SHAPES = [(1, 4, 8, 8), (3, 5, 7, 9), (1, 3, 1, 3), (3, 16, 11, 13),
          (6, 5, 7)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_function_equals_composite(shape, dtype):
    z, b, g = _operands(shape, dtype, seed=len(shape) + shape[-1])
    zr = z.clone().requires_grad_(True)
    ref = _composite(zr, b)
    (dref,) = torch.autograd.grad(ref, zr, g)
    zf = z.clone().requires_grad_(True)
    got = tvgg._BiasRelu.apply(zf, b)
    (dgot,) = torch.autograd.grad(got, zf, g)
    _same_bits(got, ref)
    _same_bits(dgot, dref)
    assert torch.isnan(got).any()            # NaN propagates forward
    # relu′ is ½ exactly where z + b rounds to 0 (signed zeros included)
    a = z + b[:, None, None]
    assert (a == 0).any()
    _same_bits(dgot[a == 0], (g * 0.5)[a == 0])
    assert torch.equal(_bits(dgot[~(a >= 0)]),
                       torch.zeros_like(_bits(dgot[~(a >= 0)])))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_versions_are_the_composite(dtype):
    z, b, g = _operands((2, 6, 5, 6), dtype, seed=3)
    zr = z.clone().requires_grad_(True)
    ref = _composite(zr, b)
    (dref,) = torch.autograd.grad(ref, zr, g)
    _same_bits(br.bias_relu_fwd_plain(z, b), ref)
    _same_bits(br.bias_relu_bwd_plain(z, b, g), dref)
    _same_bits(br.bias_relu_fwd(z, b), ref)
    _same_bits(br.bias_relu_bwd(z, b, g), dref)


def test_signed_zero_and_nan_cases():
    """The cases one by one: z + b = -0 + -0, -1 + 1, +0, a NaN, ±inf."""
    z = torch.tensor([-0.0, -1.0, 0.0, float("nan"), float("inf"),
                      -float("inf"), 2.0]).reshape(1, 1, 7)
    b = torch.tensor([-0.0])
    g = torch.full((1, 1, 7), 3.0)
    _same_bits(tvgg._BiasRelu.apply(z, b), _composite(z, b))
    zr = z.clone().requires_grad_(True)
    (d,) = torch.autograd.grad(tvgg._BiasRelu.apply(zr, b), zr, g)
    np.testing.assert_array_equal(d.numpy().ravel(),
                                  [1.5, 0.0, 1.5, 0.0, 3.0, 0.0, 3.0])
    b1 = torch.tensor([1.0])
    (d,) = torch.autograd.grad(tvgg._BiasRelu.apply(zr, b1), zr, g)
    np.testing.assert_array_equal(d.numpy().ravel(),
                                  [3.0, 1.5, 3.0, 0.0, 3.0, 0.0, 3.0])


def test_no_gradient_to_the_bias():
    z = torch.randn(1, 2, 3, 3, requires_grad=True)
    b = torch.zeros(2, requires_grad=True)
    dz, db = torch.autograd.grad(tvgg._BiasRelu.apply(z, b).sum(), (z, b),
                                 allow_unused=True)
    assert dz is not None and db is None


def test_noncontiguous_input_is_taken_contiguous():
    z, b, g = _operands((1, 4, 6, 6), torch.float32, seed=5)
    zt, gt = z.transpose(-1, -2), g.transpose(-1, -2)
    zr, zf = (zt.clone().requires_grad_(True) for _ in range(2))
    assert not zf.is_contiguous() and not gt.is_contiguous()
    ref = _composite(zr, b)
    (dref,) = torch.autograd.grad(ref, zr, gt)
    got = tvgg._BiasRelu.apply(zf, b)
    (dgot,) = torch.autograd.grad(got, zf, gt)
    _same_bits(got, ref)
    _same_bits(dgot, dref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vgg_features_and_gradient_equal_the_composite(dtype, monkeypatch):
    """Every layer of extract_features (a raw tap among them) through the
    Function gives the composite's taps and input gradient bit for bit."""
    params = tvgg.init_params(seed=1)
    r = np.random.default_rng(2)
    img = torch.from_numpy(
        r.uniform(0, 255, (16, 16, 3)).astype(np.float32))
    layers = ("conv1_1", "conv2_1", "conv3_1", "conv5_1")

    def run():
        x = img.clone().requires_grad_(True)
        taps = tvgg.extract_features(params, x, layers, compute_dtype=dtype,
                                     raw_taps=("conv1_1",))
        loss = sum(((t.z if isinstance(t, tvgg.RawTap) else t).float() ** 2
                    ).sum() for t in taps.values())
        (gx,) = torch.autograd.grad(loss, x)
        return taps, gx

    taps, gx = run()

    class Composite:
        apply = staticmethod(_composite)

    monkeypatch.setattr(tvgg, "_BiasRelu", Composite)
    ref_taps, ref_gx = run()
    for name in layers:
        got, ref = taps[name], ref_taps[name]
        if isinstance(got, tvgg.RawTap):
            got, ref = got.z, ref.z
        _same_bits(got, ref)
    _same_bits(gx, ref_gx)


def test_wrapper_checks_and_counts_nothing_on_cpu():
    assert {"bias_relu_fwd", "bias_relu_bwd"} <= set(kernels.LAUNCHES)
    before = dict(kernels.LAUNCHES)
    z, b = torch.zeros((2, 3, 4, 4)), torch.zeros(3)
    br.bias_relu_fwd(z, b)
    br.bias_relu_bwd(z, b, torch.zeros_like(z))
    br.bias_relu_fwd(z[0], b)
    assert kernels.LAUNCHES == before
    assert kernels.LAUNCHES["bias_relu_fwd"] == 0
    assert kernels.LAUNCHES["bias_relu_bwd"] == 0
    bad = [
        lambda: br.bias_relu_fwd(z, torch.zeros(4)),            # bias length
        lambda: br.bias_relu_fwd(z, torch.zeros((3, 1))),       # bias rank
        lambda: br.bias_relu_fwd(z.reshape(6, 16), b),          # 2-D
        lambda: br.bias_relu_fwd(z[None], b),                   # 5-D
        lambda: br.bias_relu_bwd(z, b, torch.zeros((2, 3, 4, 5))),
        lambda: br.bias_relu_fwd(z, b.to(torch.bfloat16)),      # dtypes
        lambda: br.bias_relu_bwd(z, b, z.to(torch.bfloat16)),
        lambda: br.bias_relu_fwd(z.to(torch.int32),
                                 b.to(torch.int32)),
        lambda: br.bias_relu_fwd(z.to(torch.float16),
                                 b.to(torch.float16)),
        lambda: br.bias_relu_fwd(z.transpose(2, 3), b),         # strides
        lambda: br.bias_relu_bwd(z, b, torch.zeros_like(z).transpose(2, 3)),
        lambda: br.bias_relu_fwd(z.to("meta"), b),              # devices
        lambda: br.bias_relu_fwd(z.to("meta"), b.to("meta")),
        lambda: br.bias_relu_bwd(z, b, torch.zeros_like(z).to("meta")),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert kernels.LAUNCHES == before
