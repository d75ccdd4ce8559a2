"""The port's guided filter and smooth-local-affine post-process
(`dpst_tpu_torch/ops/guided_filter.py`) against `dpst_tpu/ops/
guided_filter.py`, and `stylize(..., post_smooth=2)` against the JAX
package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpst_tpu
from dpst_tpu.models import vgg as jvgg
from dpst_tpu.ops import guided_filter as jgf
import dpst_tpu_torch
from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.ops import guided_filter as tgf

# (H, W, C, radius): odd and even shapes, C = 1 and 3, radius 1-3
CASES = [(17, 23, 3, 1), (16, 16, 1, 2), (31, 20, 3, 3), (24, 18, 1, 1),
         (20, 33, 3, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(h, w, c, seed):
    r = np.random.default_rng(seed)
    return (r.uniform(0, 1, (h, w, 3)).astype(np.float32),
            r.uniform(0, 255, (h, w, c)).astype(np.float32))


@pytest.mark.parametrize("h,w,c,radius", CASES)
def test_box_sums_and_counts_match_jax(h, w, c, radius):
    """Window counts exactly; window sums within 1e-6 relative (the port
    adds each window in reduce_window's row-major order)."""
    _, src = _inputs(h, w, c, 1)
    np.testing.assert_array_equal(
        tgf._box_counts(h, w, radius).numpy(),
        np.asarray(jgf._box_counts(h, w, radius)))
    np.testing.assert_allclose(
        tgf._box(torch.from_numpy(src), radius).numpy(),
        np.asarray(jgf._box(jnp.asarray(src), radius)), rtol=1e-6)


@pytest.mark.parametrize("h,w,c,radius", CASES)
def test_guided_filter_matches_jax(h, w, c, radius):
    """Within 1e-5 of the output's largest magnitude: ε = 1e-4 on random
    guides inverts covariances with condition numbers near 1e4, where the
    3x3 products' rounding (JAX's einsum, the port's ordered products)
    shows."""
    guide, src = _inputs(h, w, c, 2)
    ref = np.asarray(jgf.guided_filter(jnp.asarray(guide), jnp.asarray(src),
                                       radius=radius, eps=1e-4))
    got = tgf.guided_filter(torch.from_numpy(guide), torch.from_numpy(src),
                            radius, 1e-4).numpy()
    assert got.shape == (h, w, c) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("h,w,c,radius", CASES)
def test_smooth_local_affine_matches_jax(h, w, c, radius):
    """Within 5e-3 on the [0, 255] scale, clipped to [0, 255]."""
    r = np.random.default_rng(3)
    content = r.uniform(0, 255, (h, w, 3)).astype(np.float32)
    stylized = r.uniform(0, 255, (h, w, 3)).astype(np.float32)
    ref = np.asarray(jgf.smooth_local_affine(
        jnp.asarray(content), jnp.asarray(stylized), radius, 1e-4))
    got = tgf.smooth_local_affine(torch.from_numpy(content),
                                  torch.from_numpy(stylized), radius,
                                  1e-4).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-3)
    assert got.min() >= 0.0 and got.max() <= 255.0


def test_stylize_post_smooth_matches_jax():
    """stylize with post_smooth=2 after 3 Adam steps at 32 px, against
    dpst_tpu's: within 0.05 on the [0, 255] scale (3 Adam steps apart by a
    few fp32 ulps, then the filter); and the filter was applied (the
    result differs from the unsmoothed run's)."""
    r = np.random.default_rng(8)
    content = r.uniform(0, 255, (32, 32, 3)).astype(np.float32)
    style = r.uniform(0, 255, (32, 32, 3)).astype(np.float32)
    jp = jvgg.init_params(0)
    tp = tvgg.params_from_numpy(jax.tree.map(np.asarray, jp))
    kw = dict(use_segmentation=False, use_photorealism=True,
              laplacian_impl="xla", compute_dtype="float32", iterations=3,
              regularization_weight=100.0, post_smooth=2,
              post_smooth_eps=1e-4)
    ref = dpst_tpu.stylize(content, style, dpst_tpu.StylizeConfig(**kw),
                           vgg_params=jp)
    got = dpst_tpu_torch.stylize(content, style,
                                 dpst_tpu_torch.StylizeConfig(**kw),
                                 vgg_params=tp, device="cpu")
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=0.05)
    raw = dpst_tpu_torch.stylize(
        content, style, dpst_tpu_torch.StylizeConfig(**dict(kw,
                                                           post_smooth=0)),
        vgg_params=tp, device="cpu")
    assert np.abs(raw - got).max() > 1.0
