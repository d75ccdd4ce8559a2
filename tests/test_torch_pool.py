"""The port's tie-splitting max-pool backward (plain path of the CUDA
kernel) EQUALS the JAX package's `vgg._maxpool2_bwd` and its Pallas kernel
(interpreted off-TPU), bit for bit, with ties forced."""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpst_tpu.models import vgg as jvgg
from dpst_tpu.ops import pool_pallas
from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.ops import kernels
from dpst_tpu_torch.ops import pool_cuda


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _interp_pool_bwd(x, y, g):
    real = pool_pallas.pl.pallas_call

    def icall(*a, **k):
        k["interpret"] = True
        return real(*a, **k)

    with mock.patch.object(pool_pallas.pl, "pallas_call", icall):
        return pool_pallas.maxpool2_bwd_pallas(x, y, g)


def _case(shape, seed, dtype=np.float32):
    """x (1, H, W, C) with forced ties: a constant block, all-zero (post-
    ReLU-like) windows and exact pair ties."""
    r = np.random.default_rng(seed)
    x = r.normal(size=shape).astype(np.float32)
    x[0, :4, :4, :] = 0.5
    x[0, 4:8, :, 0] = 0.0
    x[0, 8:10, 0, :] = x[0, 8:10, 1, :]
    x = jnp.asarray(x, dtype)
    y = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max,
                              (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    g = jnp.asarray(r.normal(size=y.shape), dtype)
    return x, y, g


def _port(x, y, g, dtype=torch.float32):
    t = lambda a: torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, np.float32)[0].transpose(2, 0, 1))
    ).to(dtype)
    return pool_cuda.maxpool2_bwd(t(x), t(y), t(g))


def _hwc(t):
    return t.float().permute(1, 2, 0).numpy()[None]


@pytest.mark.parametrize("shape", [(1, 16, 16, 8), (1, 32, 24, 16),
                                   (1, 16, 256, 64)])
def test_equals_xla_and_pallas(shape):
    x, y, g = _case(shape, seed=shape[2])
    ref = np.asarray(jvgg._maxpool2_bwd("xla", (x, y), g)[0])
    pallas = np.asarray(_interp_pool_bwd(x, y, g))
    got = _hwc(_port(x, y, g))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)
    # tie splitting conserves the gradient mass
    np.testing.assert_allclose(got.sum(), float(jnp.sum(g)), rtol=1e-4)


@pytest.mark.parametrize("shape", [(1, 17, 16, 4), (1, 16, 15, 4),
                                   (1, 13, 11, 3)])
def test_odd_sizes_equal_xla(shape):
    """An odd trailing row/column never entered the pool: gradient 0."""
    x, y, g = _case(shape, seed=7)
    ref = np.asarray(jvgg._maxpool2_bwd("xla", (x, y), g)[0])
    got = _hwc(_port(x, y, g))
    np.testing.assert_array_equal(got, ref)


def test_bf16_equals_xla():
    x, y, g = _case((1, 16, 24, 8), seed=9, dtype=jnp.bfloat16)
    ref = np.asarray(jvgg._maxpool2_bwd("xla", (x, y), g)[0].astype(
        jnp.float32))
    got = _hwc(_port(x, y, g, torch.bfloat16))
    np.testing.assert_array_equal(got, ref)


def test_autograd_pool_uses_tie_split():
    """The port's max pool (an autograd Function) backpropagates through
    the tie-splitting backward, not F.max_pool2d's first-tie rule."""
    x = torch.zeros((1, 2, 4, 4), requires_grad=True)
    y = tvgg._pool(x, "max")
    (gx,) = torch.autograd.grad(y.sum(), x)
    np.testing.assert_array_equal(gx.numpy(), np.full((1, 2, 4, 4), 0.25))


def test_wrapper_checks_and_counts_nothing_on_cpu():
    x = torch.zeros((2, 4, 4))
    before = dict(kernels.LAUNCHES)
    pool_cuda.maxpool2_bwd(x, torch.zeros((2, 2, 2)), torch.zeros((2, 2, 2)))
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError):
        pool_cuda.maxpool2_bwd(x, torch.zeros((2, 2, 3)),
                               torch.zeros((2, 2, 2)))
    with pytest.raises(ValueError):
        pool_cuda.maxpool2_bwd(x.transpose(1, 2), torch.zeros((2, 2, 2)),
                               torch.zeros((2, 2, 2)))
    with pytest.raises(ValueError):
        pool_cuda.maxpool2_bwd(x.to("meta"), torch.zeros((2, 2, 2)),
                               torch.zeros((2, 2, 2)))
