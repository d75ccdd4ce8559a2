"""The port's streamed blocks 1-2 (`ops/block12_pallas.py`: the plain path
of the four block12 CUDA entry points and their autograd Function) against
the JAX package's `block12_pallas` kernels run in interpret mode: the
forward with and without residuals, the backward fed the JAX residuals, the
Function's VJP against `jax.vjp` of `make_block12_fused`, and the loss and
image gradient of `stream12_impl="pallas"` at 256² against the JAX loss on
its kernel route and on its standard path; and the routing of blocks 1-2
against the JAX package's conditions on a TPU.

Tolerances, relative to the largest magnitude of the reference:
  * forward activations and pool2: 1e-6 in fp32 (fp32 sums in two orders,
    rounded once), one bf16 ulp in bf16 (2^-7, a rounding that lands on
    the other side);
  * Gram sums: 1e-5 (fp32 sums of up to 4096 products per band in two
    orders);
  * the backward's dx and dp1: 1e-5 in fp32; 1e-2 in bf16, where dp1 is
    rounded once and its ulp flips propagate through two fp32 convs;
  * the loss: as tests/test_stream12.py holds the JAX kernel route to its
    standard path (value rtol 1e-5, gradient rtol 1e-3 with atol 5e-6 of
    max|g| for max pooling's tie flips).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpst_tpu
from dpst_tpu import optimize as jopt
from dpst_tpu.api import prepare_constants as jprepare
from dpst_tpu.models import vgg as jvgg
from dpst_tpu.ops import block12_pallas as jb
from dpst_tpu.ops import gram_pallas as jgp
import dpst_tpu_torch
from dpst_tpu_torch import api as tapi
from dpst_tpu_torch import optimize as topt
from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.ops import block12_pallas as tb
from dpst_tpu_torch.ops import gram_pallas, gram_stream, kernels


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


def _inputs(h, w, k, seed, ties=False):
    """A preprocessed-range image (H, W, 3), m1² (K, H, W) and m2² (K, H/2,
    W/2) from soft masks. `ties`: the image is constant on 8 × 8 patches,
    so that pooled windows hold tied maxima."""
    r = np.random.default_rng(seed)
    if ties:
        img = np.repeat(np.repeat(
            r.uniform(-120, 130, (h // 8, w // 8, 3)), 8, 0), 8, 1)
    else:
        img = r.uniform(-120, 130, (h, w, 3))
    m1 = r.uniform(0, 1, (k, h, w)) ** 2
    m2 = r.uniform(0, 1, (k, h // 2, w // 2)) ** 2
    return (img.astype(np.float32), m1.astype(np.float32),
            m2.astype(np.float32))


def _planes(img):
    return torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _act_tol(dtype):
    return 1e-6 if dtype == "float32" else 2.0 ** -7


def _close(got, ref, tol, what):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)
    assert err <= tol, f"{what}: {err} > {tol}"


FWD_CASES = [
    # (h, w, K, dtype, pooling, residuals)
    (64, 64, 1, "float32", "max", True),
    (64, 256, 3, "float32", "avg", True),
    (64, 64, 3, "bfloat16", "max", True),
    (64, 256, 1, "bfloat16", "avg", True),
    (64, 256, 3, "bfloat16", "max", False),
    (64, 64, 1, "float32", "avg", False),
]


@pytest.mark.parametrize("h,w,k,dtype,pooling,res", FWD_CASES)
def test_forward_matches_jax(params, h, w, k, dtype, pooling, res):
    img, m1, m2 = _inputs(h, w, k, seed=h + w + k)
    jfn = jb.block12_fwd_res if res else jb.block12_fwd
    ref = jfn(jnp.asarray(img), jnp.asarray(m1), jnp.asarray(m2),
              jb.pack_weights(params[0], dtype), pooling=pooling,
              compute_dtype=dtype, interpret=True)
    tfn = tb.block12_fwd_res if res else tb.block12_fwd
    got = tfn(_planes(img), torch.from_numpy(m1), torch.from_numpy(m2),
              tb.pack_weights(params[1], dtype), pooling=pooling,
              compute_dtype=dtype)
    names = ("g1", "g2", "p2", "a11", "a21", "a22")[:len(ref)]
    assert len(got) == len(ref)
    for name, g, r in zip(names, got, ref):
        assert g.dtype == (torch.float32 if name[0] == "g"
                           else getattr(torch, dtype)), name
        _close(g, r, 1e-5 if name[0] == "g" else _act_tol(dtype), name)


BWD_CASES = [
    # (h, w, K, dtype, pooling, ties)
    (64, 64, 1, "float32", "max", False),
    (64, 256, 3, "float32", "max", True),
    (64, 256, 3, "bfloat16", "avg", False),
    (64, 64, 3, "bfloat16", "max", False),
]


@pytest.mark.parametrize("h,w,k,dtype,pooling,ties", BWD_CASES)
def test_backward_matches_jax(params, h, w, k, dtype, pooling, ties):
    """The backward alone: both sides take the JAX forward's residuals and
    the same random cotangents."""
    img, m1, m2 = _inputs(h, w, k, seed=7 * h + w, ties=ties)
    jw = jb.pack_weights(params[0], dtype)
    _, _, _, a11, a21, a22 = jb.block12_fwd_res(
        jnp.asarray(img), jnp.asarray(m1), jnp.asarray(m2), jw,
        pooling=pooling, compute_dtype=dtype, interpret=True)
    r = np.random.default_rng(3)
    dg1 = r.normal(size=(k, 64, 64)).astype(np.float32)
    dg2 = r.normal(size=(k, 128, 128)).astype(np.float32)
    dp2 = jnp.asarray(r.normal(size=(128, h // 4, w // 4)), dtype)
    ref = jb.block12_bwd(a11, None, a21, a22, dp2, jnp.asarray(m1),
                         jnp.asarray(m2), jnp.asarray(dg1), jnp.asarray(dg2),
                         jw, pooling=pooling, compute_dtype=dtype,
                         interpret=True)
    cdt = getattr(torch, dtype)
    res = [torch.from_numpy(np.array(_f32(a))).to(cdt)
           for a in (a11, a21, a22, dp2)]
    if ties:   # the constant patches tie positive values inside windows
        a = res[0].float()
        tied = (a[:, 0::2, 0::2] == a[:, 0::2, 1::2]) & (a[:, 0::2, 0::2] > 0)
        assert bool(tied.any())
    got = tb.block12_bwd(*res, torch.from_numpy(m1), torch.from_numpy(m2),
                         torch.from_numpy(dg1), torch.from_numpy(dg2),
                         tb.pack_weights(params[1], dtype), pooling=pooling,
                         compute_dtype=dtype)
    assert got.dtype == torch.float32
    _close(got, ref, 1e-5 if dtype == "float32" else 1e-2, "dx")


def test_function_vjp_matches_jax(params):
    """Torch autograd through `make_block12_fused` against `jax.vjp` of the
    JAX package's, interpreted, at (64, 256), K = 2, fp32."""
    h, w, k = 64, 256, 2
    img, m1, m2 = _inputs(h, w, k, seed=5)
    r = np.random.default_rng(6)
    cots = (r.normal(size=(k, 64, 64)), r.normal(size=(k, 128, 128)),
            r.normal(size=(128, h // 4, w // 4)))
    cots = [c.astype(np.float32) for c in cots]
    jfused = jb.make_block12_fused(pooling="max", compute_dtype="float32",
                                   interpret=True)
    jw = jb.pack_weights(params[0], "float32")
    outs, vjp = jax.vjp(lambda x: jfused(x, jnp.asarray(m1),
                                         jnp.asarray(m2), jw),
                        jnp.asarray(img))
    (jdx,) = vjp(tuple(jnp.asarray(c) for c in cots))

    x = _planes(img).requires_grad_(True)
    tfused = tb.make_block12_fused(pooling="max", compute_dtype="float32")
    got = tfused(x, torch.from_numpy(m1), torch.from_numpy(m2),
                 tb.pack_weights(params[1], "float32"))
    for g, o in zip(got, outs):
        _close(g.detach(), o, 1e-5, "forward")
    (dx,) = torch.autograd.grad(got, x, [torch.from_numpy(c) for c in cots])
    _close(dx.permute(1, 2, 0), jdx, 1e-5, "vjp")


def test_wrappers_validate_and_count_nothing_on_cpu(params):
    w = tb.pack_weights(params[1], "float32")
    x = torch.zeros((3, 64, 64))
    m1, m2 = torch.zeros((2, 64, 64)), torch.zeros((2, 32, 32))
    before = dict(kernels.LAUNCHES)
    tb.block12_fwd(x, m1, m2, w, compute_dtype="float32")
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError):          # H not a multiple of 32
        tb.block12_fwd(torch.zeros((3, 48, 64)), torch.zeros((2, 48, 64)),
                       torch.zeros((2, 24, 32)), w, compute_dtype="float32")
    with pytest.raises(ValueError):          # weights of another dtype
        tb.block12_fwd(x, m1, m2, w, compute_dtype="bfloat16")
    with pytest.raises(ValueError):          # a device that is not CPU/CUDA
        tb.block12_fwd(x.to("meta"), m1, m2, w, compute_dtype="float32")


# --- the loss at 256² --------------------------------------------------------

LOSS_CFG = dict(use_segmentation=True, use_photorealism=True,
                laplacian_impl="xla", compute_dtype="float32",
                max_classes=2, iterations=4)


def _pair(size=256):
    r = np.random.default_rng(23)
    content = r.uniform(0, 255, (size, size, 3)).astype(np.float32)
    style = r.uniform(0, 255, (size, size, 3)).astype(np.float32)
    masks = np.zeros((2, size, size), np.float32)
    masks[0, :, :size // 2] = 1.0
    masks[1, :, size // 2:] = 1.0
    image = np.clip(content + r.normal(0, 8, content.shape), 0, 255)
    return content, style, masks, image.astype(np.float32)


def _jax_loss(params, pooling, **kw):
    content, style, masks, image = _pair()
    cfg = dpst_tpu.StylizeConfig(**LOSS_CFG, pooling=pooling, **kw)
    consts = jprepare(jnp.asarray(content), jnp.asarray(style),
                      jnp.asarray(masks), jnp.asarray(masks.copy()), cfg,
                      params)
    fn = jopt.make_loss_fn(cfg.loop_config())
    (total, terms), g = jax.value_and_grad(fn, has_aux=True)(
        jnp.asarray(image), consts, jopt.LossWeights.from_config(cfg),
        params)
    return float(total), np.asarray(terms), np.asarray(g)


TAP_SETS = {
    "config3 taps": {},
    "taps to conv3_1": dict(style_layers=("conv1_1", "conv2_1", "conv3_1"),
                            content_layers=("conv3_1",),
                            style_layer_weights=(0.2, 0.2, 0.2)),
}


@pytest.mark.parametrize("taps,pooling,atol,vs_standard", [
    ("taps to conv3_1", "max", 5e-6, True),
    ("taps to conv3_1", "avg", 5e-6, False),
    ("config3 taps", "avg", 1e-5, False),
])
def test_loss_at_256_matches_jax(params, monkeypatch, taps, pooling, atol,
                                 vs_standard):
    """stream12=8, stream12_impl="pallas" at 256², K = 2, fp32: the port's
    loss and image gradient on its kernel route (the plain versions on the
    CPU, one call of each a step) against the JAX loss on its kernel route
    (interpreted) and, with `vs_standard`, on its standard path.

    The gradient is held at rtol 1e-3 with atol `atol`·max|g|. 5e-6 is
    tests/test_stream12.py's max-pool tolerance; it holds here for both
    poolings, the port's and the JAX package's convs summing in other
    orders. With config3's taps the tail runs pool3 and pool4: there, in
    max pooling, a near-tied maximum that two fp32 computations round
    differently can send a window's cotangent to another maximum, a
    different valid subgradient that moves a few percent of the pixels by
    up to a fraction of a percent of max|g|; so that case is held on the
    taps to conv3_1, and config3's taps in avg pooling at the 1e-5·max|g|
    of the port's other loss-level checks (tests/test_torch_gram_s2d.py)."""
    kw = dict(stream12=8, stream12_impl="pallas", **TAP_SETS[taps])
    content, style, masks, image = _pair()
    cfg = dpst_tpu_torch.StylizeConfig(**LOSS_CFG, pooling=pooling, **kw)
    assert topt.block12_route(cfg, image.shape) == "kernel"
    calls = []
    for name in ("block12_fwd_plain", "block12_bwd_deep_plain",
                 "block12_bwd_shallow_plain"):
        fn = getattr(tb, name)
        monkeypatch.setattr(tb, name, lambda *a, _fn=fn, _n=name: (
            calls.append(_n), _fn(*a))[1])
    mt = torch.from_numpy(masks)
    consts = tapi.prepare_constants(torch.from_numpy(content),
                                    torch.from_numpy(style), mt, mt, cfg,
                                    params[1])
    img = torch.from_numpy(image).requires_grad_(True)
    total, terms = topt.make_loss_fn(cfg)(
        img, consts, topt.LossWeights.from_config(cfg), params[1])
    (g,) = torch.autograd.grad(total, img)
    assert sorted(calls) == ["block12_bwd_deep_plain",
                             "block12_bwd_shallow_plain", "block12_fwd_plain"]
    total, terms, g = float(total.detach()), terms.detach().numpy(), g.numpy()

    refs = [_jax_loss(params[0], pooling, **kw)]
    if vs_standard:
        refs.append(_jax_loss(params[0], pooling,
                              **dict(kw, stream12=0)))
    for t_j, terms_j, g_j in refs:
        np.testing.assert_allclose(total, t_j, rtol=1e-5)
        np.testing.assert_allclose(terms, terms_j, rtol=1e-5,
                                   atol=1e-6 * abs(t_j))
        np.testing.assert_allclose(g, g_j, rtol=1e-3,
                                   atol=atol * np.abs(g_j).max())


def test_scan_route_keeps_the_standard_path_with_fused_block12_grams(
        params, monkeypatch):
    """stream12=2, stream12_impl="scan" at 64², gram_impl="pallas", fp32:
    the port keeps its standard path, but the block-1/2 style taps take
    the fused Gram route (gram_bwd: m² before the product), as the JAX
    scan forms its per-strip Grams, while conv3_1 … conv5_1 keep
    gram_impl's route (gram_wbwd). Held to the JAX scan lowering (its
    Pallas Grams interpreted) at value rtol 1e-5 and gradient atol
    1e-5·max|g|, as the port's other loss-level checks."""
    monkeypatch.setattr(jgp, "masked_grams_pallas", functools.partial(
        jgp.masked_grams_pallas, interpret=True))
    kw = dict(stream12=2, stream12_impl="scan", gram_impl="pallas")
    content, style, masks, image = _pair(64)
    cfg = dpst_tpu_torch.StylizeConfig(**LOSS_CFG, **kw)
    assert topt.block12_route(cfg, image.shape) == "stream-standard"
    calls = []
    for mod, name in ((gram_stream, "gram_bwd_plain"),
                      (gram_pallas, "gram_wbwd_plain"),
                      (tb, "block12_fwd_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name: (
            calls.append(_n), _fn(*a))[1])
    mt = torch.from_numpy(masks)
    consts = tapi.prepare_constants(torch.from_numpy(content),
                                    torch.from_numpy(style), mt, mt, cfg,
                                    params[1])
    img = torch.from_numpy(image).requires_grad_(True)
    total, _ = topt.make_loss_fn(cfg)(
        img, consts, topt.LossWeights.from_config(cfg), params[1])
    (g,) = torch.autograd.grad(total, img)
    assert sorted(calls) == ["gram_bwd_plain"] * 2 + ["gram_wbwd_plain"] * 3

    jcfg = dpst_tpu.StylizeConfig(**LOSS_CFG, **kw)
    jconsts = jprepare(jnp.asarray(content), jnp.asarray(style),
                       jnp.asarray(masks), jnp.asarray(masks), jcfg,
                       params[0])
    (t_j, _), g_j = jax.value_and_grad(
        jopt.make_loss_fn(jcfg.loop_config()), has_aux=True)(
        jnp.asarray(image), jconsts, jopt.LossWeights.from_config(jcfg),
        params[0])
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(float(total.detach()), float(t_j), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-3,
                               atol=1e-5 * np.abs(g_j).max())


# --- routing -----------------------------------------------------------------

SIZES = [(4096, 4096), (3072, 3072), (256, 256), (1024, 1024), (288, 256),
         (272, 256), (256, 384)]
TAPS = {"default": {},
        "block-2 content tap": {"content_layers": ("conv4_2", "conv2_2")}}


def _jax_route(cfg, h, w):
    """dpst_tpu/optimize.py:make_loss_fn's decision (l. 217-235), with
    vgg.stream12_strips resolving as on a TPU."""
    lcfg = cfg.loop_config()
    all_layers = tuple(dict.fromkeys(lcfg.style_layers
                                     + lcfg.content_layers))
    p2 = jvgg.LAYER_ORDER.index("pool2")
    b12 = tuple(l for l in all_layers if jvgg.LAYER_ORDER.index(l) < p2)
    strips = jvgg.stream12_strips(lcfg.stream12, h, w)
    if not (jvgg.stream12_compatible(all_layers, strips, (h, w, 3))
            and all(l in lcfg.style_layers and l not in lcfg.content_layers
                    for l in b12)):
        return "standard"
    if (lcfg.stream12_impl == "pallas" and b12 == ("conv1_1", "conv2_1")
            and w % 256 == 0 and h % 32 == 0):
        return "kernel"
    return "stream-standard"


@pytest.mark.parametrize("taps", sorted(TAPS))
@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("stream12", [-1, 0, 2, 8, 32])
@pytest.mark.parametrize("h,w", SIZES)
def test_routing_matches_jax_on_tpu(monkeypatch, h, w, stream12, impl,
                                    taps):
    monkeypatch.setattr(jvgg.jax, "default_backend", lambda: "tpu")
    kw = dict(stream12=stream12, stream12_impl=impl, **TAPS[taps])
    want = _jax_route(dpst_tpu.StylizeConfig(**kw), h, w)
    cfg = dpst_tpu_torch.StylizeConfig(**kw)
    assert topt.block12_route(cfg, (h, w, 3)) == want
    if want != "standard":
        masks = {l: torch.empty((4, h, w), device="meta")
                 for l in cfg.style_layers}
        assert topt.fused_block1_taps(cfg, (h, w, 3), masks) == ()


def test_config6_streams_32_strips_through_the_kernels():
    """config6 (bench.py): the config3 objective at 4096² with
    stream12_impl="pallas"; stream12=-1 resolves to 32 strips of 128 rows."""
    cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                              stream12_impl="pallas")
    assert tvgg.stream12_strips(cfg.stream12, 4096, 4096) == 32
    assert topt.block12_route(cfg, (4096, 4096, 3)) == "kernel"
    assert topt.block12_route(cfg, (512, 512, 3)) == "standard"
