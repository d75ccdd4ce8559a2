"""The port's stylize on the route `conv_impl="pallas", gram_impl="pallas"`
as a whole: history parity with the JAX package's stylize on its Pallas
conv and Pallas Grams (interpreted off-TPU), the committed masked golden
reproduced on this route, and the calls per step that the route implies.

Tolerances: the history at rtol 1e-3 per column with a floor of 1e-3 of the
column's max, as tests/test_torch_stylize.py; the golden at SSIM ≥ 0.98
and loss rtol 5e-3, as tests/test_golden.py."""
import functools
import os

import jax
import numpy as np
import pytest
import torch

import dpst_tpu
from dpst_tpu.models import vgg as jvgg
from dpst_tpu.ops import gram_pallas as jgp
from dpst_tpu.ops.metrics import ssim
import dpst_tpu_torch
from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.ops import conv_cuda, gram_pallas, gram_stream

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
ROUTE = dict(conv_impl="pallas", gram_impl="pallas")


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


def _masked_case(size=48):
    """The masked 48-px case of tests/test_torch_stylize.py (at other sizes,
    the same layout): three bands of rows in the content, three bands of
    columns in the style."""
    r = np.random.default_rng(4321)
    content = r.uniform(0, 255, (size, size, 3)).astype(np.float32)
    style = r.uniform(0, 255, (size, size, 3)).astype(np.float32)
    cmask = np.zeros((3, size, size), np.float32)
    smask = np.zeros((3, size, size), np.float32)
    for k in range(3):
        cmask[k, k * size // 3:(k + 1) * size // 3] = 1
        smask[k, :, k * size // 3:(k + 1) * size // 3] = 1
    return content, style, cmask, smask


MASKED_CFG = dict(use_segmentation=True, use_photorealism=True,
                  laplacian_impl="xla", compute_dtype="float32",
                  iterations=50, max_classes=3, regularization_weight=100.0)


def test_first_history_rows_match_jax(params, monkeypatch):
    """Rows 0-2 of [total, content, style, photoreal, tv] at 32 px against
    the JAX package's stylize with the same config, whose Pallas Grams run
    interpreted on the CPU (its conv kernel interprets off-TPU by
    itself)."""
    monkeypatch.setattr(jgp, "masked_grams_pallas", functools.partial(
        jgp.masked_grams_pallas, interpret=True))
    content, style, cmask, smask = _masked_case(32)
    kw = dict(MASKED_CFG, iterations=3, **ROUTE)
    _, jh = dpst_tpu.stylize(content, style, dpst_tpu.StylizeConfig(**kw),
                             content_masks=cmask, style_masks=smask,
                             vgg_params=params[0], return_history=True)
    _, th = dpst_tpu_torch.stylize(
        content, style, dpst_tpu_torch.StylizeConfig(**kw),
        content_masks=cmask, style_masks=smask, vgg_params=params[1],
        return_history=True, device="cpu")
    assert th.shape == (3, 5)
    for col in range(5):
        ref = np.asarray(jh[:, col])
        np.testing.assert_allclose(
            th[:, col], ref, rtol=1e-3,
            atol=1e-3 * float(np.abs(ref).max()) + 1e-12,
            err_msg=f"history column {col}")


def test_golden_config2_masked_on_this_route(params):
    content, style, cmask, smask = _masked_case()
    cfg = dpst_tpu_torch.StylizeConfig(**MASKED_CFG, **ROUTE)
    out, hist = dpst_tpu_torch.stylize(
        content, style, cfg, content_masks=cmask, style_masks=smask,
        vgg_params=params[1], return_history=True, device="cpu")
    golden = np.load(os.path.join(GOLDEN_DIR, "config2_masked_48px.npy"))
    assert float(ssim(out, golden)) >= 0.98
    golden_loss = np.load(
        os.path.join(GOLDEN_DIR, "config2_masked_48px_loss.npy"))
    np.testing.assert_allclose(hist[:, 0], golden_loss, rtol=5e-3)


def test_calls_per_step(params, monkeypatch):
    """At 24 px with K = 3 every style tap's Gram takes the Pallas route
    (the fused block-1 route opens from 2^18 pixels): per step 12 convs
    forward and 12 input gradients (conv1_2 … conv5_1) and 5 weighted
    Gram backwards; the precompute adds 9 + 12 convs (content to conv4_2,
    style to conv5_1) and no Gram backward."""
    calls = []
    for mod, name in ((conv_cuda, "conv3x3_plain"),
                      (gram_pallas, "gram_wbwd_plain"),
                      (gram_stream, "gram_bwd_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name: (
            calls.append(_n), _fn(*a))[1])
    content, style, cmask, smask = _masked_case(24)
    steps = 2
    cfg = dpst_tpu_torch.StylizeConfig(**dict(MASKED_CFG, iterations=steps),
                                       **ROUTE)
    dpst_tpu_torch.stylize(content, style, cfg, content_masks=cmask,
                           style_masks=smask, vgg_params=params[1],
                           device="cpu")
    assert calls.count("conv3x3_plain") == 21 + 24 * steps
    assert calls.count("gram_wbwd_plain") == 5 * steps
    assert calls.count("gram_bwd_plain") == 0
