"""The port's mask pipeline (uniform masks, coverage weights, per-layer mask
pyramids, bilinear resize) against the JAX package's.

Tolerance: the pyramids and coverage weights are sums of at most 256 fp32
mask values, 1e-6 relative; the antialiased resize runs different filter
code on the two sides, 1e-4 of the [0, 1] mask range."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpst_tpu import segmentation as jseg
from dpst_tpu.ops import resize as jresize
from dpst_tpu_torch import segmentation as tseg
from dpst_tpu_torch.ops import resize as tresize

LAYERS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")


def _masks(k=3, h=48, w=32, seed=0):
    m = np.random.default_rng(seed).uniform(size=(k, h, w)).astype(np.float32)
    m[-1] = 0.0                      # a zero-padded class
    return m


@pytest.mark.parametrize("method", ["avg", "nearest"])
def test_layer_masks_match_jax(method):
    m = _masks()
    ref = jseg.layer_masks(jnp.asarray(m), LAYERS, method)
    got = tseg.layer_masks(torch.from_numpy(m), LAYERS, method)
    assert set(got) == set(LAYERS)
    for layer in LAYERS:
        assert tuple(got[layer].shape) == tuple(ref[layer].shape)
        np.testing.assert_allclose(got[layer].numpy(),
                                   np.asarray(ref[layer]), rtol=1e-6,
                                   atol=1e-7)


def test_coverage_weights_match_jax():
    m = _masks(seed=1)
    got = tseg.coverage_weights(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jseg.coverage_weights(jnp.asarray(m))), rtol=1e-6)
    assert got[-1] == 0.0


def test_uniform_masks_match_jax():
    for args in (((8, 12),), ((8, 12), 3)):
        np.testing.assert_array_equal(tseg.uniform_masks(*args),
                                      jseg.uniform_masks(*args))


def test_resize_image_matches_jax_when_downsampling():
    m = _masks(k=2, h=37, w=53, seed=2).transpose(1, 2, 0)[None]
    ref = np.asarray(jresize.resize_image(jnp.asarray(m), (16, 24)))
    got = tresize.resize_image(torch.from_numpy(np.ascontiguousarray(m)),
                               (16, 24)).numpy()
    assert got.shape == ref.shape == (1, 16, 24, 2)
    np.testing.assert_allclose(got, ref, atol=1e-4)
