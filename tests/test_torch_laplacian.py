"""The port's matting Laplacian (stats, plain matvec, packed-plane path and
photorealism loss) against the JAX package's XLA path, its Pallas kernel
(interpreted off-TPU) and the scipy CSR oracle.

Tolerance: relative error ≤ 1e-5 of max|y| (fp32; both sides sum the box
windows in different orders, and Λ ≈ 1e6 amplifies the roundoff of the
cancelling terms t = q − μ·s)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpst_tpu.ops import laplacian as jlap
from dpst_tpu.ops import laplacian_pallas as jlap_pallas
from dpst_tpu.ops import matting_oracle as oracle
from dpst_tpu_torch.ops import kernels
from dpst_tpu_torch.ops import laplacian as tlap
from dpst_tpu_torch.ops import laplacian_cuda as tlapc

EPS = 1e-5
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(h=20, w=24, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(
        np.float32)


def _close(got, ref, rel=REL):
    scale = float(np.max(np.abs(ref)))
    assert float(np.max(np.abs(got - ref))) <= rel * scale


def test_precompute_stats_match():
    img = _image()
    js = jlap.precompute_stats(jnp.asarray(img), eps=EPS)
    ts = tlap.precompute_stats(torch.from_numpy(img), eps=EPS)
    for name in ("valid", "win_count"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    np.testing.assert_allclose(ts.mu.numpy(), np.asarray(js.mu),
                               rtol=1e-6, atol=1e-7)
    # Λ = (Σ + ε/9·Id)⁻¹ reaches ~1e6: compare relative to its scale
    _close(ts.lam.numpy(), np.asarray(js.lam), rel=1e-4)


@pytest.mark.parametrize("channels", [1, 3])
def test_matvec_matches_xla_and_oracle(channels):
    img = _image()
    v = np.random.default_rng(1).normal(size=img.shape[:2] + (channels,)
                                        ).astype(np.float32)
    ts = tlap.precompute_stats(torch.from_numpy(img), eps=EPS)
    got = tlap.matvec(ts, torch.from_numpy(v)).numpy()
    js = jlap.precompute_stats(jnp.asarray(img), eps=EPS)
    _close(got, np.asarray(jlap.matvec_xla(js, jnp.asarray(v))))
    _close(got, oracle.matvec_oracle(img, v, eps=EPS))


def test_matvec_matches_pallas_interpreted():
    img = _image(16, 16, seed=2)
    v = np.random.default_rng(3).normal(size=(16, 16, 3)).astype(np.float32)
    js = jlap.precompute_stats(jnp.asarray(img), eps=EPS)
    ref = np.asarray(jlap_pallas.matvec_pallas(js, jnp.asarray(v)))
    ts = tlap.precompute_stats(torch.from_numpy(img), eps=EPS)
    _close(tlap.matvec(ts, torch.from_numpy(v)).numpy(), ref)


def test_packed_path_equals_plain_matvec():
    """lap_matvec on CPU tensors is the plain version, in the kernel's
    (3, H, W) layout, and counts no kernel launch."""
    img = _image(18, 22, seed=4)
    v = np.random.default_rng(5).normal(size=(18, 22, 3)).astype(np.float32)
    ts = tlap.precompute_stats(torch.from_numpy(img), eps=EPS)
    packed = tlapc.pack_stats(ts)
    assert packed.shape == (14, 18, 22) and packed.is_contiguous()
    back = tlapc.unpack_stats(packed)
    for a, b in zip(back, ts):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    before = dict(kernels.LAUNCHES)
    y3 = tlapc.lap_matvec(packed, torch.from_numpy(v).permute(2, 0, 1)
                          .contiguous())
    assert kernels.LAUNCHES == before
    np.testing.assert_array_equal(
        y3.permute(1, 2, 0).numpy(), tlap.matvec(ts, torch.from_numpy(v)))


def test_lap_matvec_rejects_bad_inputs():
    packed = torch.zeros((14, 8, 8))
    with pytest.raises(ValueError):
        tlapc.lap_matvec(packed, torch.zeros((3, 8, 9)))
    with pytest.raises(ValueError):
        tlapc.lap_matvec(packed, torch.zeros((3, 8, 8), dtype=torch.float64))
    with pytest.raises(ValueError):
        tlapc.lap_matvec(packed[:13], torch.zeros((3, 8, 8)))


def test_zero_stats_give_exact_zero():
    v = torch.from_numpy(np.random.default_rng(6).normal(
        size=(10, 12, 3)).astype(np.float32))
    y = tlap.matvec(tlap.zero_stats(10, 12), v)
    assert torch.count_nonzero(y) == 0


def test_photoreal_loss_value_and_gradient_match_jax():
    img01 = _image(20, 20, seed=7)
    out255 = np.random.default_rng(8).uniform(0, 255, (20, 20, 3)).astype(
        np.float32)
    js = jlap.precompute_stats(jnp.asarray(img01), eps=EPS)
    jval, jgrad = jax.value_and_grad(
        lambda x: jlap.photoreal_loss(js, x, impl="xla"))(jnp.asarray(out255))
    packed = tlapc.pack_stats(tlap.precompute_stats(torch.from_numpy(img01),
                                                    eps=EPS))
    x = torch.from_numpy(out255).requires_grad_(True)
    tval = tlap.photoreal_loss(packed, x)
    (tgrad,) = torch.autograd.grad(tval, x)
    # the value is Σ v·(L v): compare at the scale of Σ|v|·|L v|
    y = tlap.matvec(tlapc.unpack_stats(packed), x.detach() / 255.0)
    scale = float(torch.sum(torch.abs(x.detach() / 255.0) * torch.abs(y)))
    assert abs(float(tval.detach()) - float(jval)) <= REL * scale
    assert tgrad.shape == (20, 20, 3)
    _close(tgrad.numpy(), np.asarray(jgrad))
