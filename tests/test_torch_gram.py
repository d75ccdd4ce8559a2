"""The port's masked Grams (plain path of the Gram kernels and their
autograd Function) against the JAX package's fused XLA Grams and its
streamed Pallas Grams (interpreted off-TPU), values and gradients, both
normalizers, C ∈ {8, 64, 96} and K ∈ {1, 3}.

Tolerance: fp32, rtol 1e-5 on values; gradients at 1e-5 of max|dF| (the
two sides sum P products in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpst_tpu.ops import gram_stream as jgs
from dpst_tpu.ops import losses as jlosses
from dpst_tpu_torch.ops import gram_stream as tgs
from dpst_tpu_torch.ops import kernels
from dpst_tpu_torch.ops import losses as tlosses


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(c, k, h=12, w=10, seed=0):
    r = np.random.default_rng(seed)
    feat = r.normal(size=(h, w, c)).astype(np.float32)      # JAX layout
    masks = r.uniform(size=(k, h, w)).astype(np.float32)
    if k > 1:
        masks[-1] = 0.0              # a padded class contributes exactly 0
    return feat, masks


def _chw(feat):
    return torch.from_numpy(np.ascontiguousarray(feat.transpose(2, 0, 1)))


@pytest.mark.parametrize("norm", ["m2", "m1"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("c", [8, 64, 96])
def test_masked_grams_match_jax(c, k, norm):
    feat, masks = _inputs(c, k)
    got = tlosses.masked_grams(_chw(feat), torch.from_numpy(masks),
                               norm=norm).numpy()
    fused = np.asarray(jlosses.masked_grams_fused(
        jnp.asarray(feat), jnp.asarray(masks), norm=norm))
    stream = np.asarray(jgs.masked_grams_stream(
        jnp.asarray(feat), jnp.asarray(masks), norm=norm))
    atol = 1e-5 * float(np.abs(fused).max())
    np.testing.assert_allclose(got, fused, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got, stream, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("c", [8, 64, 96])
def test_masked_grams_gradient_matches_jax(c, k):
    feat, masks = _inputs(c, k, seed=1)
    tgt = np.random.default_rng(2).normal(size=(k, c, c)).astype(np.float32)

    def jloss(fn):
        return lambda x: jnp.sum((fn(x, jnp.asarray(masks)) - tgt) ** 2)

    g_fused = np.asarray(jax.grad(jloss(jlosses.masked_grams_fused))(
        jnp.asarray(feat)))
    g_stream = np.asarray(jax.grad(jloss(jgs.masked_grams_stream))(
        jnp.asarray(feat)))
    x = _chw(feat).requires_grad_(True)
    loss = torch.sum((tlosses.masked_grams(x, torch.from_numpy(masks))
                      - torch.from_numpy(tgt)) ** 2)
    (g,) = torch.autograd.grad(loss, x)
    got = g.permute(1, 2, 0).numpy()
    atol = 1e-5 * float(np.abs(g_fused).max())
    np.testing.assert_allclose(got, g_fused, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got, g_stream, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("style_norm", ["gatys", "paper"])
def test_style_layer_loss_matches_jax(style_norm):
    feat, masks = _inputs(16, 2, h=16, w=12, seed=3)
    grams = np.random.default_rng(4).normal(size=(2, 16, 16)).astype(
        np.float32)
    cov = np.asarray([0.4, 0.6], np.float32)
    jf = lambda x: jlosses.style_layer_loss(
        x, jnp.asarray(grams), jnp.asarray(masks), jnp.asarray(cov),
        style_norm=style_norm)
    jval, jgrad = jax.value_and_grad(jf)(jnp.asarray(feat))
    x = _chw(feat).requires_grad_(True)
    tval = tlosses.style_layer_loss(
        x, torch.from_numpy(grams), torch.from_numpy(masks),
        torch.from_numpy(cov), style_norm=style_norm)
    (tgrad,) = torch.autograd.grad(tval, x)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(tgrad.permute(1, 2, 0).numpy(),
                               np.asarray(jgrad), rtol=1e-4,
                               atol=1e-5 * float(np.abs(jgrad).max()))


def test_content_and_tv_loss_match_jax():
    r = np.random.default_rng(5)
    a, b = (r.normal(size=(6, 5, 8)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        float(tlosses.content_loss(torch.from_numpy(a), torch.from_numpy(b))),
        float(jlosses.content_loss(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6)
    img = r.uniform(0, 255, (9, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(float(tlosses.tv_loss(torch.from_numpy(img))),
                               float(jlosses.tv_loss(jnp.asarray(img))),
                               rtol=1e-6)


def test_bf16_plain_path_rounds_weighted_operand():
    """In bf16 the weighted operand F∘m² is rounded to bf16 before the
    fp32-accumulated product, as the JAX package forms it."""
    feat, masks = _inputs(8, 2, seed=6)
    f = _chw(feat).reshape(8, -1).to(torch.bfloat16)
    m2 = torch.from_numpy(masks * masks).reshape(2, -1).to(torch.bfloat16)
    got = tgs.gram_fwd(f, m2).numpy()
    ref = np.asarray(jlosses._grams_raw_flat(
        jnp.asarray(f.float().numpy().T, jnp.bfloat16),
        jnp.asarray(m2.float().numpy(), jnp.bfloat16)))
    ref = ref.reshape(8, 2, 8).transpose(1, 0, 2)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


def test_mask_gets_no_gradient_and_cpu_counts_nothing():
    feat, masks = _inputs(8, 2, seed=7)
    f = _chw(feat).reshape(8, -1).requires_grad_(True)
    m2 = torch.from_numpy(masks * masks).reshape(2, -1).requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    g = tgs.masked_grams_raw(f, m2)
    gf, gm = torch.autograd.grad(g.sum(), (f, m2), allow_unused=True)
    assert gm is None and gf.shape == f.shape
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("c,p,k", [(64, 262144, 4), (512, 1024, 4),
                                   (96, 1000, 3), (8, 40, 1),
                                   (128, 262144, 4), (64, 1 << 24, 4),
                                   (96, 1001, 3), (512, 9, 4)])
def test_forward_split_plan_covers_p(c, p, k):
    splits, chunk = tgs.fwd_splits(c, p, k)
    assert chunk % 32 == 0 and splits >= 1
    assert (splits - 1) * chunk < p <= splits * chunk
