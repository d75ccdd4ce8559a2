"""The port's fp64 matting-Laplacian oracle (`dpst_tpu_torch/ops/
matting_oracle.py`) against the JAX package's, against the port's plain
matvec, and its native C++ path against its CSR matrix."""
import os
import subprocess

import numpy as np
import pytest
import torch

from dpst_tpu.ops import matting_oracle as jmo
from dpst_tpu_torch.ops import laplacian as tlap
from dpst_tpu_torch.ops import matting_oracle as mo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _image(h, w, seed):
    return np.random.default_rng(seed).uniform(0.05, 0.95, (h, w, 3))


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_csr_equals_the_jax_oracles(eps):
    img = _image(12, 14, seed=1)
    got, ref = mo.build_laplacian_csr(img, eps), jmo.build_laplacian_csr(
        img, eps)
    assert got.shape == ref.shape == (168, 168)
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.data, ref.data)


@pytest.mark.parametrize("channels", [None, 3])
def test_plain_matvec_agrees_with_the_oracle(channels):
    """The port's fp32 matvec within 1e-5 of max|y| (as tests/
    test_torch_laplacian.py holds it: box sums in another order, and Λ ≈
    1e6 amplifies the roundoff of the cancelling terms)."""
    img = _image(16, 20, seed=2).astype(np.float32)
    r = np.random.default_rng(3)
    v = r.normal(size=(16, 20) if channels is None else (16, 20, channels))
    ref = mo.matvec_oracle(img.astype(np.float64), v)
    stats = tlap.precompute_stats(torch.from_numpy(img), eps=1e-5)
    vt = torch.from_numpy(v.astype(np.float32))
    got = tlap.matvec(stats, vt if channels else vt[..., None]).numpy()
    got = got if channels else got[..., 0]
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    np.testing.assert_array_equal(ref, jmo.matvec_oracle(
        img.astype(np.float64), v))


def test_native_matches_the_csr():
    if not mo.native_available():
        res = subprocess.run([os.path.join(REPO, "tools", "build_native.sh")],
                             capture_output=True, text=True)
        if res.returncode != 0:
            pytest.skip(f"native build failed: {res.stderr[-500:]}")
    assert mo.native_available()
    img = _image(20, 24, seed=4)
    v = np.random.default_rng(5).normal(size=(20, 24, 3))
    np.testing.assert_allclose(mo.matvec_native(img, v),
                               mo.matvec_oracle(img, v), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(mo.matvec_native(img, v[..., 0]),
                               mo.matvec_oracle(img, v[..., 0]),
                               rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError):
        mo.matvec_native(img[:10], v)
