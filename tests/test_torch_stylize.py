"""The port's single-scale stylize as a whole: the committed JAX goldens
(reproduced with the JAX package's weight arrays, the bounds of
tests/test_golden.py), history parity with JAX's stylize, and the entry
point's contract (masks, callback cadence, what is not ported yet)."""
import os

import jax
import numpy as np
import pytest
import torch

import dpst_tpu
from dpst_tpu.models import vgg as jvgg
from dpst_tpu.ops.metrics import ssim
import dpst_tpu_torch
from dpst_tpu_torch import api as tapi
from dpst_tpu_torch import optimize as topt
from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.utils import io as tio

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


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


def _masked_case():
    r = np.random.default_rng(4321)
    content = r.uniform(0, 255, (48, 48, 3)).astype(np.float32)
    style = r.uniform(0, 255, (48, 48, 3)).astype(np.float32)
    cmask = np.zeros((3, 48, 48), np.float32)
    cmask[0, :16] = 1
    cmask[1, 16:32] = 1
    cmask[2, 32:] = 1
    smask = np.zeros((3, 48, 48), np.float32)
    smask[0, :, :16] = 1
    smask[1, :, 16:32] = 1
    smask[2, :, 32:] = 1
    return content, style, cmask, smask


MASKED_CFG = dict(use_segmentation=True, use_photorealism=True,
                  laplacian_impl="xla", compute_dtype="float32",
                  iterations=50, max_classes=3, regularization_weight=100.0)


def test_golden_config3(params):
    r = np.random.default_rng(1234)
    content = r.uniform(0, 255, (48, 48, 3)).astype(np.float32)
    style = r.uniform(0, 255, (48, 48, 3)).astype(np.float32)
    cfg = dpst_tpu_torch.StylizeConfig(
        use_segmentation=False, use_photorealism=True, laplacian_impl="xla",
        compute_dtype="float32", iterations=60, regularization_weight=100.0)
    out, hist = dpst_tpu_torch.stylize(content, style, cfg,
                                       vgg_params=params[1],
                                       return_history=True, device="cpu")
    golden = np.load(os.path.join(GOLDEN_DIR, "config3_48px.npy"))
    assert float(ssim(out, golden)) >= 0.98
    golden_loss = np.load(os.path.join(GOLDEN_DIR, "config3_48px_loss.npy"))
    np.testing.assert_allclose(hist[:, 0], golden_loss, rtol=5e-3)
    assert hist[0, 0] / hist[-1, 0] > 8.0


def test_golden_config2_masked(params):
    content, style, cmask, smask = _masked_case()
    cfg = dpst_tpu_torch.StylizeConfig(**MASKED_CFG)
    out, hist = dpst_tpu_torch.stylize(
        content, style, cfg, content_masks=cmask, style_masks=smask,
        vgg_params=params[1], return_history=True, device="cpu")
    golden = np.load(os.path.join(GOLDEN_DIR, "config2_masked_48px.npy"))
    assert float(ssim(out, golden)) >= 0.98
    golden_loss = np.load(
        os.path.join(GOLDEN_DIR, "config2_masked_48px_loss.npy"))
    np.testing.assert_allclose(hist[:, 0], golden_loss, rtol=5e-3)
    assert out.shape == (48, 48, 3) and out.dtype == np.float32
    assert out.min() >= 0.0 and out.max() <= 255.0


def test_first_history_rows_match_jax(params):
    """Rows 0-4 of [total, content, style, photoreal, tv], column by column.

    Tolerance: rtol 1e-3 on each column, with an absolute floor of 1e-3 of
    the column's largest value: the photoreal term starts near 0 (vᵀLv at
    the content image is a sum of cancelling terms of size ~|v|², where
    fp32 roundoff of different summation orders shows), and the content
    term is exactly 0 at row 0."""
    content, style, cmask, smask = _masked_case()
    kw = dict(MASKED_CFG, iterations=5)
    _, jh = dpst_tpu.stylize(content, style, dpst_tpu.StylizeConfig(**kw),
                             content_masks=cmask, style_masks=smask,
                             vgg_params=params[0], return_history=True)
    _, th = dpst_tpu_torch.stylize(
        content, style, dpst_tpu_torch.StylizeConfig(**kw),
        content_masks=cmask, style_masks=smask, vgg_params=params[1],
        return_history=True, device="cpu")
    assert th.shape == (5, 5)
    for col in range(5):
        ref = np.asarray(jh[:, col])
        np.testing.assert_allclose(
            th[:, col], ref, rtol=1e-3,
            atol=1e-3 * float(np.abs(ref).max()) + 1e-12,
            err_msg=f"history column {col}")


def test_callback_cadence_and_segments(params):
    r = np.random.default_rng(3)
    content = r.uniform(0, 255, (16, 16, 3)).astype(np.float32)
    style = r.uniform(0, 255, (16, 16, 3)).astype(np.float32)
    cfg = dpst_tpu_torch.StylizeConfig(
        use_segmentation=False, compute_dtype="float32", iterations=5,
        intermediate_interval=2)
    seen = []
    out, hist = dpst_tpu_torch.stylize(
        content, style, cfg, vgg_params=params[1], return_history=True,
        device="cpu",
        callback=lambda step, img, h: seen.append((step, tuple(h.shape))))
    assert seen == [(2, (2, 5)), (4, (2, 5)), (5, (1, 5))]
    out1, hist1 = dpst_tpu_torch.stylize(
        content, style, cfg, vgg_params=params[1], return_history=True,
        device="cpu")
    np.testing.assert_array_equal(hist, hist1)   # segments change nothing
    np.testing.assert_array_equal(out, out1)


@pytest.mark.parametrize("kw,masks", [
    ({"debug_nans": True}, True),
    ({"optimizer": "lbfgs"}, True),
    ({"post_smooth": 2}, True),
    ({"use_segmentation": True}, False),
    ({"laplacian_impl": "spmd"}, True),
    ({"checkpoint_dir": "ckpt"}, True),
])
def test_unported_features_raise(kw, masks, params, tmp_path, monkeypatch):
    """Every feature is ported: debug_nans, L-BFGS, post-smoothing,
    checkpointing and automatic segmentation (use_segmentation=True
    without masks; PSPNet at 48² here) each run a step at 16²; the
    multi-GPU Laplacian (laplacian_impl="spmd") runs inside an ambient
    mesh and, outside one, raises the JAX package's ValueError."""
    from dpst_tpu_torch.models import pspnet
    from dpst_tpu_torch.parallel import mesh as tmesh
    monkeypatch.setattr(pspnet, "EVAL_SIZE", 48)
    if "checkpoint_dir" in kw:
        kw = {"checkpoint_dir": str(tmp_path / kw["checkpoint_dir"])}
    cfg = dpst_tpu_torch.StylizeConfig(iterations=1, max_classes=2, **kw)
    img = np.random.default_rng(3).uniform(0, 255, (16, 16, 3)).astype(
        np.float32)
    m = np.ones((1, 16, 16), np.float32) if masks else None
    run = lambda: dpst_tpu_torch.stylize(
        img, img[::-1].copy(), cfg, content_masks=m, style_masks=m,
        vgg_params=params[1], device="cpu")
    if "laplacian_impl" not in kw:
        assert np.isfinite(run()).all()
        return
    with pytest.raises(ValueError, match="ambient mesh"):
        run()
    with tmesh.use_mesh(tmesh.Mesh(["cpu"] * 2, (tmesh.ROW_AXIS,))):
        assert np.isfinite(run()).all()


def test_masks_must_come_together():
    img = np.zeros((16, 16, 3), np.float32)
    with pytest.raises(ValueError, match="together"):
        dpst_tpu_torch.stylize(img, img, content_masks=np.ones((1, 16, 16)),
                               device="cpu")


def test_fit_masks_matches_jax():
    from dpst_tpu import api as japi
    m = np.random.default_rng(5).uniform(size=(2, 37, 53)).astype(np.float32)
    ref = japi._fit_masks(m, (16, 24))
    got = tapi._fit_masks(m, (16, 24))
    assert got.shape == (2, 16, 24)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert tapi._fit_masks(m, (37, 53)) is m


def test_init_image_matches_jax():
    import jax.numpy as jnp
    from dpst_tpu import optimize as jopt
    r = np.random.default_rng(6)
    content = r.uniform(0, 255, (8, 8, 3)).astype(np.float32)
    smean = r.uniform(0, 255, (1, 1, 3)).astype(np.float32)
    for mode in ("content", "style_mean"):
        ref = jopt.init_image(dpst_tpu.StylizeConfig(init_mode=mode),
                              jnp.asarray(content), jnp.asarray(smean))
        got = topt.init_image(dpst_tpu_torch.StylizeConfig(init_mode=mode),
                              torch.from_numpy(content),
                              torch.from_numpy(smean))
        # the image mean sums 64 pixels in another order: a few fp32 ulps
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    noise = topt.init_image(dpst_tpu_torch.StylizeConfig(init_mode="noise"),
                            torch.from_numpy(content))
    assert noise.shape == (8, 8, 3) and 0 <= noise.min() <= noise.max() <= 255


def test_adam_matches_optax():
    import optax
    r = np.random.default_rng(7)
    p = r.normal(size=(5, 4)).astype(np.float32)
    cfg = dpst_tpu_torch.StylizeConfig()
    opt = optax.adam(cfg.learning_rate, b1=cfg.adam_b1, b2=cfg.adam_b2,
                     eps=cfg.adam_eps)
    jp, st = p, opt.init(p)
    tadam = topt.Adam(cfg)
    tp = torch.from_numpy(p)
    tst = tadam.init(tp)
    for _ in range(4):
        g = r.normal(size=p.shape).astype(np.float32)
        u, st = opt.update(g, st, jp)
        jp = optax.apply_updates(jp, u)
        tu, tst = tadam.update(torch.from_numpy(g), tst)
        tp = tp + tu
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)


@pytest.mark.parametrize("fn,args", [
    ("load_image", (np.full((4, 6, 3), 0.5, np.float32),)),
    ("load_image", (np.arange(60, dtype=np.uint8).reshape(4, 5, 3), 8)),
    ("to_uint8", (np.asarray([0.4, 0.6, 254.5, 300.0, -2.0]),)),
    ("_target_hw", ((300, 200), 100)),
])
def test_io_matches_jax(fn, args):
    from dpst_tpu.utils import io as jio
    np.testing.assert_array_equal(getattr(tio, fn)(*args),
                                  getattr(jio, fn)(*args))
