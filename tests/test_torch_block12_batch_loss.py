"""The stream12 kernel route on a batch: `optimize.make_loss_fn`'s loss of
B = 2 pairs at 256² (stream12=8, stream12_impl="pallas", K = 2, fp32, the
taps to conv3_1) calls each plain block12 version once for the batch, and
its loss and image gradient match the JAX package's loss on its kernel
route under `jax.vmap` (the reference's batch: its block12 pallas_calls
interpreted, the pair a grid dimension), pair by pair, at
tests/test_torch_block12.py's tolerances for that case: value rtol 1e-5,
gradient rtol 1e-3 with atol 5e-6 of max|g| (tests/test_stream12.py's
max-pool bound)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpst_tpu
from dpst_tpu import optimize as jopt
from dpst_tpu.models import vgg as jvgg
from dpst_tpu.parallel import batch as jbatch
import dpst_tpu_torch
from dpst_tpu_torch import optimize as topt
from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.ops import block12_pallas as tb
from dpst_tpu_torch.parallel import batch as tbatch

SIZE, B = 256, 2
CFG = dict(use_segmentation=True, use_photorealism=True,
           laplacian_impl="xla", compute_dtype="float32", max_classes=2,
           iterations=4, pooling="max", stream12=8, stream12_impl="pallas",
           style_layers=("conv1_1", "conv2_1", "conv3_1"),
           content_layers=("conv3_1",), style_layer_weights=(0.2, 0.2, 0.2))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs():
    """Two distinct pairs, two masks each (the halves, split at another
    column for each pair), and a noisy image each."""
    r = np.random.default_rng(29)
    content = r.uniform(0, 255, (B, SIZE, SIZE, 3)).astype(np.float32)
    style = r.uniform(0, 255, (B, SIZE, SIZE, 3)).astype(np.float32)
    masks = np.zeros((B, 2, SIZE, SIZE), np.float32)
    for i, cut in enumerate((SIZE // 2, SIZE // 2 + 40)):
        masks[i, 0, :, :cut] = 1.0
        masks[i, 1, :, cut:] = 1.0
    image = np.clip(content + r.normal(0, 8, content.shape), 0, 255)
    return content, style, masks, image.astype(np.float32)


def test_batched_kernel_route_matches_jax_vmap(monkeypatch):
    content, style, masks, image = _pairs()
    jp = jvgg.init_params(0)
    tp = tvgg.params_from_numpy(jax.tree.map(np.asarray, jp))
    cfg = dpst_tpu_torch.StylizeConfig(**CFG)
    assert topt.block12_route(cfg, image.shape[1:]) == "kernel"
    calls = []
    for name in ("block12_fwd_plain", "block12_bwd_deep_plain",
                 "block12_bwd_shallow_plain"):
        fn = getattr(tb, name)
        monkeypatch.setattr(tb, name, lambda *a, _fn=fn, _n=name: (
            calls.append((_n, a[0].shape[0])), _fn(*a))[1])
    consts, _, _ = tbatch.prepare_batch_stage(
        *(torch.from_numpy(a) for a in (content, style, masks, masks.copy())),
        tp, (SIZE, SIZE), cfg)
    img = torch.from_numpy(image).requires_grad_(True)
    total, terms = topt.make_loss_fn(cfg)(
        img, consts, topt.LossWeights.from_config(cfg), tp)
    (g,) = torch.autograd.grad(total, img)
    # one call of each for both pairs (a batch's leading axis of 2)
    assert sorted(calls) == [("block12_bwd_deep_plain", B),
                             ("block12_bwd_shallow_plain", B),
                             ("block12_fwd_plain", B)]
    terms, g = terms.detach().numpy(), g.numpy()

    jcfg = dpst_tpu.StylizeConfig(**CFG)
    jconsts, _, _ = jbatch.prepare_batch_stage(
        *(jnp.asarray(a) for a in (content, style, masks, masks.copy())), jp,
        (SIZE, SIZE), jcfg)
    fn = jopt.make_loss_fn(jcfg.loop_config())
    (t_j, terms_j), g_j = jax.vmap(
        jax.value_and_grad(fn, has_aux=True), in_axes=(0, 0, None, None))(
        jnp.asarray(image), jconsts, jopt.LossWeights.from_config(jcfg), jp)
    t_j, terms_j, g_j = (np.asarray(a) for a in (t_j, terms_j, g_j))
    np.testing.assert_allclose(float(total.detach()), t_j.sum(), rtol=1e-5)
    for i in range(B):
        np.testing.assert_allclose(terms[i], terms_j[i], rtol=1e-5,
                                   atol=1e-6 * abs(t_j[i]),
                                   err_msg=f"pair {i}")
        np.testing.assert_allclose(g[i], g_j[i], rtol=1e-3,
                                   atol=5e-6 * np.abs(g_j[i]).max(),
                                   err_msg=f"pair {i}")
