"""The port's multi-scale stylize: the stage schedule, the per-stage resize
and the image carry against the JAX package's functions, and the committed
config4 golden (tests/test_golden.py's bounds) on both block-1 routes.

Tolerance of the resize comparisons: the antialiased bilinear filter runs
different code on the two sides; 1e-3 on the [0, 255] image scale and
1e-5 on the [0, 1] mask scale (a few fp32 ulps of the weighted sums)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpst_tpu
from dpst_tpu import api as japi
from dpst_tpu.models import vgg as jvgg
from dpst_tpu.ops.metrics import ssim
import dpst_tpu_torch
from dpst_tpu_torch import api as tapi
from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.ops import gram_s2d as tg

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jvgg.get_params(seed=0)
    return jp, tvgg.params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("kw,hw", [
    ({}, (48, 48)),                                         # one stage
    ({"scales": (16, 32, 48)}, (48, 48)),
    ({"scales": (256, 512, 1024)}, (1024, 1024)),           # config4
    ({"scales": (256, 512, 1024)}, (600, 400)),             # clamp + merge
    ({"scales": (64, 4096, 8192)}, (512, 512)),             # all clamp
    ({"scales": (16, 32)}, (100, 60)),                      # all coarser
    ({"scales": (16, 32, 48), "scale_iters": (5, 7, 9)}, (48, 48)),
    ({"scales": (16, 48, 48), "scale_iters": (5, 7, 9)}, (48, 48)),
    ({"scales": (16, 32, 48), "scale_iter_factor": 0.5}, (48, 48)),
    ({"scales": (100, 200), "scale_iter_factor": 1.7}, (300, 150)),
    ({"scales": (3,)}, (40, 70)),                           # 8-px floor
])
def test_scale_schedule_matches_jax(kw, hw):
    kw = dict(kw, iterations=30)
    ref = japi._scale_schedule(dpst_tpu.StylizeConfig(**kw), hw)
    got = tapi._scale_schedule(dpst_tpu_torch.StylizeConfig(**kw), hw)
    assert got == ref
    assert got[-1][:2] == hw


def _pair(size=48, k=3, seed=21):
    r = np.random.default_rng(seed)
    content = r.uniform(0, 255, (size, size, 3)).astype(np.float32)
    style = r.uniform(0, 255, (size, size, 3)).astype(np.float32)
    cmask = r.uniform(size=(k, size, size)).astype(np.float32)
    smask = r.uniform(size=(k, size, size)).astype(np.float32)
    return content, style, cmask, smask


@pytest.mark.parametrize("hw", [(16, 16), (32, 32), (48, 48)])
def test_prepare_stage_matches_jax(params, hw):
    content, style, cmask, smask = _pair()
    cfg_kw = dict(use_photorealism=False, compute_dtype="float32",
                  style_layers=("conv1_1", "conv2_1"),
                  style_layer_weights=(0.5, 0.5),
                  content_layers=("conv2_2",))
    jconsts, jcontent, jmean = japi._prepare_stage(
        *(jnp.asarray(a) for a in (content, style, cmask, smask)),
        params[0], hw, dpst_tpu.StylizeConfig(**cfg_kw))
    tconsts, tcontent, tmean = tapi._prepare_stage(
        *(torch.from_numpy(a) for a in (content, style, cmask, smask)),
        params[1], hw, dpst_tpu_torch.StylizeConfig(**cfg_kw))
    np.testing.assert_allclose(tcontent.numpy(), np.asarray(jcontent),
                               atol=1e-3)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), atol=1e-3)
    for layer in ("conv1_1", "conv2_1"):        # the resized content masks
        np.testing.assert_allclose(tconsts.masks[layer].numpy(),
                                   np.asarray(jconsts.masks[layer]),
                                   atol=1e-5)
    np.testing.assert_allclose(tconsts.coverage.numpy(),
                               np.asarray(jconsts.coverage), atol=1e-5)
    # the resized style image and masks, through their Grams
    for layer in ("conv1_1", "conv2_1"):
        ref = np.asarray(jconsts.style_grams[layer])
        np.testing.assert_allclose(
            tconsts.style_grams[layer].numpy(), ref, rtol=1e-4,
            atol=1e-5 * float(np.abs(ref).max()))
    if hw == (48, 48):                          # native size: no resize
        np.testing.assert_array_equal(tcontent.numpy(), content)


@pytest.mark.parametrize("src,dst", [((16, 16), (32, 32)),
                                     ((32, 32), (48, 48)),
                                     ((24, 40), (48, 80))])
def test_carry_image_matches_jax(src, dst):
    img = np.random.default_rng(22).uniform(-20, 275, (*src, 3)).astype(
        np.float32)
    ref = np.asarray(japi._carry_image(jnp.asarray(img), dst))
    got = tapi._carry_image(torch.from_numpy(img), dst).numpy()
    assert got.shape == (*dst, 3)
    assert got.min() >= 0.0 and got.max() <= 255.0
    np.testing.assert_allclose(got, ref, atol=1e-3)


GOLDEN_CFG = dict(use_segmentation=False, use_photorealism=True,
                  laplacian_impl="xla", compute_dtype="float32",
                  iterations=30, scales=(16, 32, 48),
                  regularization_weight=100.0)


@pytest.mark.parametrize("route", [{}, {"s2d_gram": "pallas",
                                        "block1_impl": "s2d"}],
                         ids=["unfused", "fused"])
def test_golden_config4_multiscale(params, monkeypatch, route):
    """tests/test_golden.py's config4 golden, on the unfused route (the
    default "auto" at 48 px) and on the fused bias+ReLU Gram route, which
    then runs at every step of every stage."""
    calls = []
    plain = tg.gram_relu_fwd_plain
    monkeypatch.setattr(tg, "gram_relu_fwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    r = np.random.default_rng(1234)
    content = r.uniform(0, 255, (48, 48, 3)).astype(np.float32)
    style = r.uniform(0, 255, (48, 48, 3)).astype(np.float32)
    cfg = dpst_tpu_torch.StylizeConfig(**GOLDEN_CFG, **route)
    out, hist = dpst_tpu_torch.stylize(content, style, cfg,
                                       vgg_params=params[1],
                                       return_history=True, device="cpu")
    assert len(calls) == (90 if route else 0)
    assert out.shape == content.shape
    golden = np.load(os.path.join(GOLDEN_DIR, "config4_multiscale_48px.npy"))
    assert float(ssim(out, golden)) >= 0.98
    golden_loss = np.load(
        os.path.join(GOLDEN_DIR, "config4_multiscale_48px_loss.npy"))
    np.testing.assert_allclose(hist[:, 0], golden_loss, rtol=5e-3)
    for a, b in ((0, 30), (30, 60), (60, 90)):     # per-stage descent
        assert hist[b - 1, 0] < 0.2 * hist[a, 0]


def test_callback_steps_are_global_across_stages(params):
    r = np.random.default_rng(23)
    content = r.uniform(0, 255, (32, 32, 3)).astype(np.float32)
    style = r.uniform(0, 255, (32, 32, 3)).astype(np.float32)
    cfg = dpst_tpu_torch.StylizeConfig(
        use_segmentation=False, compute_dtype="float32", scales=(16, 32),
        scale_iters=(3, 4), intermediate_interval=2)
    seen = []
    out, hist = dpst_tpu_torch.stylize(
        content, style, cfg, vgg_params=params[1], return_history=True,
        device="cpu",
        callback=lambda step, img, h: seen.append(
            (step, tuple(img.shape), tuple(h.shape))))
    assert seen == [(2, (16, 16, 3), (2, 5)), (3, (16, 16, 3), (1, 5)),
                    (5, (32, 32, 3), (2, 5)), (7, (32, 32, 3), (2, 5))]
    assert hist.shape == (7, 5) and out.shape == (32, 32, 3)
    # callbacks only cut segments: the run is the same without them
    out1, hist1 = dpst_tpu_torch.stylize(
        content, style, cfg, vgg_params=params[1], return_history=True,
        device="cpu")
    np.testing.assert_array_equal(hist, hist1)
    np.testing.assert_array_equal(out, out1)
