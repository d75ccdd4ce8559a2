"""The port's VGG-19 features and their input gradient against the JAX
package's, with the same weight arrays.

Tolerance: fp32 on the CPU, relative error ≤ 1e-4 of each tap's max|·|
(the two frameworks sum a 3×3×Cin conv window in different orders, and
16 layers compound it)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpst_tpu.models import vgg as jvgg
from dpst_tpu_torch.models import vgg as tvgg

LAYERS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv4_2", "conv5_1")
REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jvgg.init_params(0)
    return jp, tvgg.params_from_numpy(jax.tree.map(np.asarray, jp))


def _close(got, ref, rel=REL):
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    assert float(np.max(np.abs(got - ref))) <= rel * scale


def _image(seed=0, hw=(32, 32)):
    return np.random.default_rng(seed).uniform(0, 255, hw + (3,)).astype(
        np.float32)


@pytest.mark.parametrize("pooling", ["max", "avg"])
def test_features_match_jax(params, pooling):
    jp, tp = params
    img = _image()
    ref = jvgg.extract_features(jp, jnp.asarray(img), LAYERS,
                                pooling=pooling)
    got = tvgg.extract_features(tp, torch.from_numpy(img), LAYERS,
                                pooling=pooling)
    assert set(got) == set(LAYERS)
    for layer in LAYERS:
        r = np.asarray(ref[layer])
        g = got[layer].permute(1, 2, 0).numpy()
        assert g.shape == r.shape, layer
        _close(g, r)


def test_truncation_and_bf16_dtype(params):
    _, tp = params
    img = torch.from_numpy(_image(1, (24, 16)))
    taps = tvgg.extract_features(tp, img, ("conv2_1",),
                                 compute_dtype="bfloat16")
    assert list(taps) == ["conv2_1"]
    assert taps["conv2_1"].dtype == torch.bfloat16
    assert taps["conv2_1"].shape == (128, 12, 8)


def _tap_grads(params, img, layers, seed):
    jp, tp = params
    r = np.random.default_rng(seed)
    shapes = {l: jvgg.extract_features(jp, jnp.asarray(img), (l,))[l].shape
              for l in layers}
    weights = {l: r.normal(size=s).astype(np.float32)
               for l, s in shapes.items()}

    def jloss(x):
        f = jvgg.extract_features(jp, x, layers)
        return sum(jnp.sum(f[l] * weights[l]) for l in layers)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(img)))
    x = torch.from_numpy(img).requires_grad_(True)
    f = tvgg.extract_features(tp, x, layers)
    loss = sum(torch.sum(f[l].permute(1, 2, 0) * torch.from_numpy(weights[l]))
               for l in layers)
    (tg,) = torch.autograd.grad(loss, x)
    return tg.numpy(), jg


def test_input_gradient_matches_jax(params):
    tg, jg = _tap_grads(params, _image(2), ("conv1_1", "conv3_1", "conv4_2"),
                        seed=3)
    _close(tg, jg)


def test_input_gradient_relu_tie_is_half(params):
    """An image equal to the channel means makes every pre-activation
    exactly 0 (zero biases): the whole gradient flows through relu′(0) =
    0.5 and the all-tie pool windows, as in JAX's jnp.maximum."""
    img = np.broadcast_to(np.asarray(tvgg.BGR_MEANS[::-1], np.float32),
                          (16, 16, 3)).copy()
    tg, jg = _tap_grads(params, img, ("conv1_1", "conv2_1"), seed=4)
    assert np.abs(jg).max() > 0
    _close(tg, jg)


def test_relu_gradient_at_zero():
    x = torch.tensor([-1.0, 0.0, 2.0]).reshape(1, 1, 3).requires_grad_(True)
    (g,) = torch.autograd.grad(
        tvgg._BiasRelu.apply(x, torch.zeros(1)).sum(), x)
    np.testing.assert_array_equal(g.numpy().ravel(), [0.0, 0.5, 1.0])


def test_preprocess_matches_jax():
    img = _image(5, (8, 6))
    ref = np.asarray(jvgg.preprocess(jnp.asarray(img)))
    got = tvgg.preprocess(torch.from_numpy(img))[0].permute(1, 2, 0).numpy()
    np.testing.assert_array_equal(got, ref)


def test_load_params_reads_the_bundle_format(params, tmp_path):
    jp, tp = params
    bundle = {}
    for name in jvgg.CONV_SHAPES:
        bundle[f"{name}_w"] = np.asarray(jp[name]["w"])
        bundle[f"{name}_b"] = np.asarray(jp[name]["b"]) + 0.5
    path = tmp_path / "vgg19.npz"
    np.savez(path, **bundle)
    loaded = tvgg.load_params(str(path))
    for name in jvgg.CONV_SHAPES:
        np.testing.assert_array_equal(loaded[name]["w"].numpy(),
                                      tp[name]["w"].numpy())
        np.testing.assert_array_equal(loaded[name]["b"].numpy(),
                                      bundle[f"{name}_b"])
    assert tvgg.get_params(str(path))["conv1_1"]["b"][0] == 0.5


def test_init_params_is_seeded_he_normal():
    a = tvgg.init_params(7)
    b = tvgg.init_params(7, generator=torch.Generator().manual_seed(7))
    for name, (cin, cout) in tvgg.CONV_SHAPES.items():
        assert a[name]["w"].shape == (cout, cin, 3, 3)
        assert torch.equal(a[name]["w"], b[name]["w"])
    std = float(a["conv3_1"]["w"].std())
    assert abs(std - np.sqrt(2.0 / (9 * 128))) < 0.05 * std
