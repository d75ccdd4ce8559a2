"""The port's 3×3 conv (`ops/conv_cuda.py`: the plain path of the `conv3x3`
kernel, and the `_Conv3x3` autograd Function of `models/vgg.py`) against
the JAX package's Pallas conv (`conv_pallas.conv3x3_same`, interpreted
off-TPU) and `vgg._pallas_conv`, and the `conv_impl` routing of
`extract_features`.

Tolerance: fp32 at 1e-5 of max|y| (the two sides sum nine tap products in
the same order, each tap's Cin-deep product in its own order); bf16 at one
bf16 ulp of max|y| (both round the same fp32 sum once, and may land on the
two sides of a rounding boundary); whole VGG stacks at 1e-4 of each tap's
max, as tests/test_torch_vgg.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpst_tpu.models import vgg as jvgg
from dpst_tpu.ops import conv_pallas as jconv
from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.ops import conv_cuda as tconv
from dpst_tpu_torch.ops import kernels


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_ulp(ref: np.ndarray) -> float:
    """One bf16 ulp at max|ref| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _operands(h, w, cin, cout, dtype, seed=0):
    """x (H, W, Cin) and HWIO weights as JAX arrays in `dtype`, and the same
    values as the port's (Cin, H, W) and OIHW tensors."""
    r = np.random.default_rng(seed)
    jx = jnp.asarray(r.normal(size=(h, w, cin)).astype(np.float32), dtype)
    jw = jnp.asarray(r.normal(0, np.sqrt(2.0 / (9 * cin)),
                              (3, 3, cin, cout)).astype(np.float32), dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tx = torch.from_numpy(np.ascontiguousarray(
        np.asarray(jx, np.float32).transpose(2, 0, 1))).to(tdt)
    tw = torch.from_numpy(np.ascontiguousarray(
        np.asarray(jw, np.float32).transpose(3, 2, 0, 1))).to(tdt)
    return jx, jw, tx, tw


def _close(got: torch.Tensor, ref, dtype):
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    tol = (1e-5 * np.abs(ref).max() if dtype == jnp.float32
           else _bf16_ulp(ref))
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= tol


SHAPES = [(16, 24, 64, 64), (9, 13, 32, 48), (8, 8, 128, 256)]
DTYPES = [jnp.float32, jnp.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_conv_matches_pallas_kernel(shape, dtype):
    jx, jw, tx, tw = _operands(*shape, dtype, seed=sum(shape))
    ref = np.asarray(jconv.conv3x3_same(jx, jw), np.float32).transpose(2, 0, 1)
    got = tconv.conv3x3_same(tx, tw)
    assert got.dtype == tx.dtype
    _close(got, ref, dtype)


def test_flip_transpose_matches_jax():
    _, jw, _, tw = _operands(4, 4, 8, 16, jnp.float32)
    ref = np.asarray(jconv.flip_transpose_weights(jw)).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(tconv.flip_transpose_weights(tw).numpy(),
                                  ref)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_function_input_gradient_matches_jax(dtype):
    """The Function's input gradient against the JAX kernel on the flipped,
    transposed weights and against jax.vjp of vgg._pallas_conv. The
    cotangent reaches the backward as a non-contiguous view."""
    h, w, cin, cout = 9, 13, 32, 48
    jx, jw, tx, tw = _operands(h, w, cin, cout, dtype, seed=7)
    r = np.random.default_rng(8)
    jg = jnp.asarray(r.normal(size=(h, w, cout)).astype(np.float32), dtype)
    ref = np.asarray(jconv.conv3x3_same(jg, jconv.flip_transpose_weights(jw)),
                     np.float32).transpose(2, 0, 1)
    _, vjp = jax.vjp(lambda x: jvgg._pallas_conv(x, jw), jx[None])
    ref_vjp = np.asarray(vjp(jg[None])[0][0], np.float32).transpose(2, 0, 1)

    x = tx[None].clone().requires_grad_(True)
    y = tvgg._Conv3x3.apply(x, tconv.pack_weights(tw),
                            tconv.pack_grad_weights(tw))
    g_t = torch.from_numpy(np.ascontiguousarray(
        np.asarray(jg, np.float32).transpose(2, 1, 0)[None])).to(tx.dtype)
    (gx,) = torch.autograd.grad(y.transpose(2, 3), x, grad_outputs=g_t)
    _close(gx[0], ref, dtype)
    _close(gx[0], ref_vjp, dtype)


def test_weight_gradient_is_none_and_cpu_counts_nothing():
    _, _, tx, tw = _operands(6, 7, 8, 16, jnp.float32)
    x = tx[None].clone().requires_grad_(True)
    w = tw.clone().requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    y = tvgg._Conv3x3.apply(x, tconv.pack_weights(w),
                            tconv.pack_grad_weights(w))
    gx, gw = torch.autograd.grad(y.sum(), (x, w), allow_unused=True)
    assert gw is None and gx.shape == x.shape
    assert kernels.LAUNCHES == before


def test_wrapper_validates_operands():
    x, w = torch.zeros(8, 5, 6), torch.zeros(16, 8, 3, 3)
    with pytest.raises(ValueError):
        tconv.conv3x3_same(x[None, None], w)       # not (C, H, W) or a batch
    with pytest.raises(ValueError):
        tconv.conv3x3_same(x, torch.zeros(16, 4, 3, 3))      # Cin mismatch
    with pytest.raises(ValueError):
        tconv.conv3x3_same(x, w.to(torch.bfloat16))          # dtype mismatch
    with pytest.raises(ValueError):
        tconv.conv3x3_same(x.transpose(1, 2), w)             # not contiguous
    with pytest.raises(ValueError):                          # never falls back
        tconv.conv3x3_same(x.to("meta"), w)


# --- extract_features ---------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    jp = jvgg.init_params(0)
    return jp, tvgg.params_from_numpy(jax.tree.map(np.asarray, jp))


def test_features_and_gradient_match_jax_pallas(params):
    """extract_features(conv_impl="pallas") taps and image gradient against
    the JAX package's on its Pallas conv, at 32×48, as
    tests/test_conv_pallas.py drives the JAX side."""
    jp, tp = params
    layers = ("conv1_2", "conv2_1", "conv3_1")
    img = np.random.default_rng(5).uniform(0, 255, (32, 48, 3)).astype(
        np.float32)
    ref = jvgg.extract_features(jp, jnp.asarray(img), layers,
                                compute_dtype="float32", conv_impl="pallas")
    x = torch.from_numpy(img).requires_grad_(True)
    got = tvgg.extract_features(tp, x, layers, compute_dtype="float32",
                                conv_impl="pallas")
    for layer in layers:
        r = np.asarray(ref[layer])
        g = got[layer].detach().permute(1, 2, 0).numpy()
        assert g.shape == r.shape, layer
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max(), layer

    def jloss(im):
        f = jvgg.extract_features(jp, im, ("conv2_1",),
                                  compute_dtype="float32", conv_impl="pallas")
        return jnp.sum(f["conv2_1"] ** 2)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(img)))
    (tg,) = torch.autograd.grad(torch.sum(got["conv2_1"] ** 2), x)
    assert np.abs(tg.numpy() - jg).max() <= 1e-4 * np.abs(jg).max()


@pytest.mark.parametrize("conv_impl", ["pallas", "auto", "xla", "flipvjp",
                                       "padbwd", "dotbwd", "dot11"])
def test_only_pallas_reaches_the_kernel_and_never_conv1_1(
        params, monkeypatch, conv_impl):
    """conv_impl="pallas" sends every conv with Cin ≥ 8 (all but conv1_1),
    and its input gradient, to the conv kernel's path; no other value
    reaches it."""
    seen = []
    plain = tconv.conv3x3_plain

    def counting(x, w):
        seen.append(x.shape[-3])
        return plain(x, w)

    monkeypatch.setattr(tconv, "conv3x3_plain", counting)
    img = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 255, (16, 16, 3)).astype(np.float32)).requires_grad_(True)
    f = tvgg.extract_features(params[1], img, ("conv1_1", "conv3_1"),
                              conv_impl=conv_impl)
    n_fwd = len(seen)
    torch.autograd.grad(f["conv3_1"].sum() + f["conv1_1"].sum(), img)
    if conv_impl != "pallas":
        assert seen == []
        return
    # forward: conv1_2, conv2_1, conv2_2, conv3_1 (Cin 64, 64, 128, 128);
    # backward: their input gradients (Cin = each layer's Cout)
    assert seen[:n_fwd] == [64, 64, 128, 128]
    assert sorted(seen[n_fwd:]) == [64, 128, 128, 256]
    assert 3 not in seen
