"""The port's fused bias+ReLU masked Grams (`ops/gram_s2d.py`: plain path of
the `gram_relu_fwd`/`gram_relu_bwd` kernels and their autograd Function)
against the JAX package: at the function level against
`masked_grams_fused(vgg._relu(z + b))` and its VJP, and against the port's
own unfused route; at the loss level against the JAX loss through the
`gram_s2d` v2 and v1 Pallas kernels (interpreted off-TPU); and the routing
of block-1 taps against the JAX package's on a TPU.

Tolerance: fp32, rtol 1e-5 on values; gradients at 1e-5 of max|g| (the
sides sum P products in different orders). The relu′(0) = ½ case is
forced with entries z = −b, whose fp32 sum is exactly 0."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpst_tpu
from dpst_tpu import optimize as jopt
from dpst_tpu.api import prepare_constants as jprepare
from dpst_tpu.models import vgg as jvgg
from dpst_tpu.ops import losses as jlosses
import dpst_tpu_torch
from dpst_tpu_torch import api as tapi
from dpst_tpu_torch import optimize as topt
from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.ops import gram_s2d as tg
from dpst_tpu_torch.ops import kernels
from dpst_tpu_torch.ops import losses as tlosses


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(c, k, h=12, w=10, seed=0):
    """Raw tap z (H, W, C) with a few exact zeros of z + b, bias b (C,),
    masks (K, H, W) with a zero-padded last class."""
    r = np.random.default_rng(seed)
    z = r.normal(size=(h, w, c)).astype(np.float32)
    b = r.normal(scale=0.5, size=(c,)).astype(np.float32)
    zero = r.uniform(size=(h, w, c)) < 0.1
    z[zero] = -np.broadcast_to(b, z.shape)[zero]
    masks = r.uniform(size=(k, h, w)).astype(np.float32)
    if k > 1:
        masks[-1] = 0.0
    return z, b, masks


def _chw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)))


def _jax_grams(z, b, masks, norm="m2"):
    return jlosses.masked_grams_fused(
        jvgg._relu(z + jnp.asarray(b)), jnp.asarray(masks), norm=norm)


def _unfused(zt, bt, mt, norm="m2"):
    f = tvgg._BiasRelu.apply(zt, bt)
    return tlosses.masked_grams(f, mt, norm=norm)


@pytest.mark.parametrize("norm", ["m2", "m1"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("c", [8, 64, 96])
def test_masked_grams_relu_match_jax(c, k, norm):
    z, b, masks = _inputs(c, k)
    zt, bt, mt = _chw(z), torch.from_numpy(b), torch.from_numpy(masks)
    got = tg.masked_grams_relu(zt, bt, mt, norm=norm).numpy()
    ref = np.asarray(_jax_grams(jnp.asarray(z), b, masks, norm))
    atol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got, _unfused(zt, bt, mt, norm).numpy(),
                               rtol=1e-5, atol=atol)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("c", [8, 64, 96])
def test_masked_grams_relu_gradient_matches_jax(c, k):
    z, b, masks = _inputs(c, k, seed=1)
    tgt = np.random.default_rng(2).normal(size=(k, c, c)).astype(np.float32)
    jl = lambda x: jnp.sum((_jax_grams(x, b, masks) - tgt) ** 2)
    _, vjp = jax.vjp(jl, jnp.asarray(z))
    (g_ref,) = vjp(jnp.float32(1.0))
    g_ref = np.asarray(g_ref)

    def tgrad(fn):
        x = _chw(z).requires_grad_(True)
        loss = torch.sum((fn(x, torch.from_numpy(b), torch.from_numpy(masks))
                          - torch.from_numpy(tgt)) ** 2)
        (g,) = torch.autograd.grad(loss, x)
        return g.permute(1, 2, 0).numpy()

    atol = 1e-5 * float(np.abs(g_ref).max())
    fused = tgrad(tg.masked_grams_relu)
    np.testing.assert_allclose(fused, g_ref, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(fused, tgrad(_unfused), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relu_grad_at_zero_is_half(dtype):
    """dz = relu′(z + b) ∘ Σ_k (S_k·F) ∘ m²_k with relu′ = 1, ½, 0 above,
    at and below 0: exact zeros of z + b get half the cotangent."""
    z, b, masks = _inputs(16, 2, seed=3)
    zt = _chw(z).reshape(16, -1).to(dtype)
    bt = torch.from_numpy(b).to(dtype)
    zt = torch.where(torch.rand(zt.shape, generator=torch.Generator()
                                .manual_seed(0)) < 0.2,
                     -bt[:, None].expand_as(zt), zt).contiguous()
    m2 = torch.from_numpy(masks * masks).reshape(2, -1).to(dtype)
    d = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 16, 16)).astype(np.float32))
    s = (d + d.transpose(1, 2)).to(dtype).contiguous()
    dz = tg.gram_relu_bwd(zt, bt, m2, s).float()
    f = tg._cook(zt, bt).float()
    cot = sum(torch.matmul(s[k].float(), f) * m2[k].float()
              for k in range(2))
    x = zt.float() + bt.float()[:, None]
    at_zero = x == 0
    assert int(at_zero.sum()) > 20
    np.testing.assert_array_equal(dz[at_zero].numpy(),
                                  (0.5 * cot[at_zero]).to(dtype).float()
                                  .numpy())
    assert float(dz[x < 0].abs().max()) == 0.0
    np.testing.assert_array_equal(dz[x > 0].numpy(),
                                  cot[x > 0].to(dtype).float().numpy())


def test_fused_gets_no_bias_or_mask_gradient_and_cpu_counts_nothing():
    z, b, masks = _inputs(8, 2, seed=5)
    zt = _chw(z).reshape(8, -1).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    m2 = torch.from_numpy(masks * masks).reshape(2, -1).requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    g = tg.GramReluRaw.apply(zt, bt, m2)
    gz, gb, gm = torch.autograd.grad(g.sum(), (zt, bt, m2),
                                     allow_unused=True)
    assert gb is None and gm is None and gz.shape == zt.shape
    assert kernels.LAUNCHES == before


def test_wrappers_validate_operands():
    z = torch.zeros(4, 10)
    with pytest.raises(ValueError):
        tg.gram_relu_fwd(z, torch.zeros(5), torch.zeros(2, 10))
    with pytest.raises(ValueError):
        tg.gram_relu_fwd(z, torch.zeros(4), torch.zeros(2, 9))
    with pytest.raises(ValueError):
        tg.gram_relu_bwd(z, torch.zeros(4), torch.zeros(2, 10),
                         torch.zeros(2, 4, 5))
    with pytest.raises(ValueError):
        tg.gram_relu_fwd(z, torch.zeros(4, dtype=torch.bfloat16),
                         torch.zeros(2, 10))


# --- the loss as the optimizer builds it ------------------------------------

BASE = dict(use_segmentation=True, use_photorealism=True, max_classes=2,
            compute_dtype="float32", s2b_strips=8, block1_impl="s2d")
B1_STYLED = {"style_layers": ("conv1_1", "conv1_2", "conv2_1", "conv3_1",
                              "conv4_1", "conv5_1"),
             "style_layer_weights": (0.2,) * 6}


def _tall_pair():
    r = np.random.default_rng(11)
    content = r.uniform(0, 255, (256, 64, 3)).astype(np.float32)
    style = r.uniform(0, 255, (256, 64, 3)).astype(np.float32)
    masks = np.zeros((2, 256, 64), np.float32)
    masks[0, :128] = 1.0
    masks[1, 128:] = 1.0
    return content, style, masks


@pytest.fixture(scope="module")
def tall_params():
    jp = jvgg.get_params(seed=0)
    return jp, tvgg.params_from_numpy(jax.tree.map(np.asarray, jp))


def _jax_value_grad(params, content, style, masks, **kw):
    cfg = dpst_tpu.StylizeConfig(**{**BASE, **kw})
    consts = jprepare(jnp.asarray(content), jnp.asarray(style),
                      jnp.asarray(masks), jnp.asarray(masks), cfg, params)
    lcfg = cfg.loop_config()
    consts = jopt._with_s2d_masks(lcfg, consts, content.shape)
    assert consts.s2d_gram_consts is not None     # the Pallas kernel runs
    w = jopt.LossWeights.from_config(cfg)
    (v, _), g = jax.value_and_grad(jopt.make_loss_fn(lcfg), has_aux=True)(
        jnp.asarray(content) + 3.0, consts, w, params)
    return float(v), np.asarray(g)


def _torch_value_grad(params, content, style, masks, **kw):
    cfg = dpst_tpu_torch.StylizeConfig(**{**BASE, **kw})
    mt = torch.from_numpy(masks)
    consts = tapi.prepare_constants(torch.from_numpy(content),
                                    torch.from_numpy(style), mt, mt, cfg,
                                    params)
    b1 = tuple(l for l in cfg.style_layers if l.startswith("conv1_"))
    assert topt.fused_block1_taps(cfg, content.shape, consts.masks) == b1
    img = (torch.from_numpy(content) + 3.0).requires_grad_(True)
    total, _ = topt.make_loss_fn(cfg)(
        img, consts, topt.LossWeights.from_config(cfg), params)
    (g,) = torch.autograd.grad(total, img)
    return float(total.detach()), g.numpy()


@pytest.mark.parametrize("kw", [{}, B1_STYLED], ids=["default",
                                                     "conv1_2-tap"])
def test_fused_loss_matches_jax_s2d_kernels(tall_params, kw):
    """The port's loss and image gradient with s2d_gram="pallas" against
    the JAX loss through gram_s2d v2 ("pallas") and v1 ("pallas1"), each
    run in interpret mode; the port's "pallas1" takes the same kernels."""
    content, style, masks = _tall_pair()
    jp, tp = tall_params
    v_t, g_t = _torch_value_grad(tp, content, style, masks,
                                 s2d_gram="pallas", **kw)
    v_t1, g_t1 = _torch_value_grad(tp, content, style, masks,
                                   s2d_gram="pallas1", **kw)
    np.testing.assert_array_equal(g_t1, g_t)
    assert v_t1 == v_t
    for variant in ("pallas", "pallas1"):
        v_j, g_j = _jax_value_grad(jp, content, style, masks,
                                   s2d_gram=variant, **kw)
        scale = float(np.abs(g_j).max())
        np.testing.assert_allclose(v_t, v_j, rtol=1e-5, err_msg=variant)
        np.testing.assert_allclose(g_t / scale, g_j / scale, atol=1e-5,
                                   err_msg=variant)


# --- routing ------------------------------------------------------------------

ROUTES = [
    # (h, w, K, cfg fields, port takes the fused kernels)
    (512, 512, 4, {}, False),                      # auto: nd below 2^19
    (768, 768, 4, {}, True),                       # auto: kernel from 2^19
    (1024, 1024, 4, {}, True),                     # config4's last stage
    (1024, 1024, 8, {}, True),
    (2048, 2048, 4, {}, True),                     # past the fused bound
    (1024, 1024, 4, {"s2d_gram": "nd"}, False),
    (1024, 1024, 4, {"block1_impl": "conv"}, False),
    (1024, 1024, 4, {"content_layers": ("conv1_1", "conv4_2")}, False),
    (1023, 1024, 4, {}, False),                    # odd h
    (1024, 1024, 4, B1_STYLED, True),              # conv1_2 tap too
    (1024, 1024, 4, {"strip_gram": "interior"}, False),
    (1024, 1024, 4, {"strip_gram": "interior", "s2b_strips": 0}, True),
    (512, 512, 4, {"gram_impl": "stream"}, True),  # non-fused Gram route
    (512, 512, 4, {"gram_impl": "xla"}, False),
    (256, 256, 4, {"s2d_gram": "pallas"}, False),  # block 1 auto < 2^18
    (256, 256, 4, {"s2d_gram": "pallas", "block1_impl": "s2d"}, True),
    (256, 256, 4, {"s2d_gram": "pallas1", "block1_impl": "s2d"}, True),
    (256, 256, 4, {"s2d_gram": "pallas2", "block1_impl": "s2d"}, True),
    (256, 256, 4, {"block1_impl": "s2d"}, False),   # s2d, nd Gram
    (512, 512, 4, {"gram_impl": "stream", "s2d_gram": "nd"}, False),
    (4096, 4096, 4, {"s2d_gram": "nd"}, False),      # s2d gate closes
]


@pytest.mark.parametrize("h,w,k,kw,fused", ROUTES)
def test_routing_matches_jax_on_tpu(monkeypatch, h, w, k, kw, fused):
    monkeypatch.setattr(jopt.jax, "default_backend", lambda: "tpu")
    lcfg = dpst_tpu.StylizeConfig(**kw).loop_config()
    all_layers = tuple(dict.fromkeys(lcfg.style_layers
                                     + lcfg.content_layers))
    b1 = tuple(l for l in all_layers if l in ("conv1_1", "conv1_2"))
    shapes = {l: (k, h, w) for l in b1 if l in lcfg.style_layers}
    jax_s2d = jopt._block1_s2d_ok(lcfg, (h, w, 3), all_layers, b1, shapes)
    jax_kernel = jopt._s2d_gram_kernel(lcfg, h, w, k)
    tcfg = dpst_tpu_torch.StylizeConfig(**kw)
    assert topt._block1_s2d_ok(tcfg, (h, w, 3), all_layers, b1,
                               shapes) == jax_s2d
    assert topt._s2d_gram_kernel(tcfg, h, w, k) == jax_kernel
    masks = {l: torch.empty((k, h, w), device="meta")
             for l in tcfg.style_layers}
    got = topt.fused_block1_taps(tcfg, (h, w, 3), masks)
    assert bool(got) == (jax_s2d and jax_kernel) == fused
    if fused:
        assert got == b1


def test_config4_takes_the_fused_kernels_only_at_1024():
    cfg = dpst_tpu_torch.PRESETS["config4"]
    stages = tapi._scale_schedule(cfg, (1024, 1024))
    assert [s[:2] for s in stages] == [(256, 256), (512, 512), (1024, 1024)]
    masks = lambda n: {l: torch.empty((4, n, n), device="meta")
                       for l in cfg.style_layers}
    assert [topt.fused_block1_taps(cfg, (h, w, 3), masks(h))
            for h, w, _ in stages] == [(), (), ("conv1_1",)]
    nd = dataclasses.replace(cfg, s2d_gram="nd")
    assert topt.fused_block1_taps(nd, (1024, 1024, 3), masks(1024)) == ()
