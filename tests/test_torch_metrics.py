"""The port's SSIM and PSNR (`dpst_tpu_torch/ops/metrics.py`) against
`dpst_tpu/ops/metrics.py`."""
import numpy as np
import pytest
import torch

from dpst_tpu.ops import metrics as jm
from dpst_tpu_torch.ops import metrics as tm


def _pair(h, w, c, seed):
    r = np.random.default_rng(seed)
    a = r.uniform(0, 255, (h, w, c)).astype(np.float32)
    noise = r.normal(scale=20.0, size=(h, w, c)).astype(np.float32)
    return a, np.clip(a + noise, 0, 255).astype(np.float32)


@pytest.mark.parametrize("h,w,c", [(32, 32, 3), (17, 29, 3), (24, 20, 1),
                                   (11, 11, 3)])
def test_ssim_and_psnr_match_jax(h, w, c):
    """SSIM within 1e-5 absolute (11x11 Gaussian taps summed in another
    order), PSNR within 1e-5 relative; grayscale (H, W) inputs too."""
    a, b = _pair(h, w, c, h * w)
    np.testing.assert_allclose(float(tm.ssim(a, b)), float(jm.ssim(a, b)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(tm.psnr(a, b)), float(jm.psnr(a, b)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm.ssim(a[..., 0], b[..., 0])),
                               float(jm.ssim(a[..., 0], b[..., 0])),
                               rtol=0, atol=1e-5)


def test_ssim_of_identical_images_is_one_and_takes_tensors():
    a, _ = _pair(16, 16, 3, 0)
    t = torch.from_numpy(a)
    assert abs(float(tm.ssim(t, t)) - 1.0) < 1e-6
    assert float(tm.psnr(t, t)) == pytest.approx(
        float(jm.psnr(a, a)), rel=1e-6)
    assert tm.ssim(t, a).dtype == torch.float32
