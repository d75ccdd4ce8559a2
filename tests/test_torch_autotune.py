"""The port's NIMA scorer and Γ autotune against dpst_tpu on the CPU, and
the sweep against sequential `stylize` runs of the port itself.

Weights are drawn from numpy seeds in the JAX package's layouts (He
init; NIMA with scales and biases of its own) and carried across with the
port's `params_from_numpy`. NIMA: distributions within 1e-5 and scores
within 1e-4 in fp32. autotune: both packages on the same VGG, NIMA (and
PSPNet) weights, at 32 px; every candidate's image within the goldens'
bounds (SSIM >= 0.98), the final images' fp32 NIMA scores within 1e-3,
the sweep's own scores (bf16 NIMA in both packages, as `autotune` scores)
within 5e-3, and the same best Γ wherever the top two scores differ by
more than that. XLA and oneDNN round the bf16 convs' outputs apart by an
ulp here and there, which moves a bf16 score by up to 2.5e-3 (measured
on these inputs)."""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import dpst_tpu
from dpst_tpu.models import nima as jnima
from dpst_tpu.models import pspnet as jpsp
from dpst_tpu.ops.metrics import ssim
import dpst_tpu_torch
from dpst_tpu_torch import optimize as topt
from dpst_tpu_torch.models import nima as tnima
from dpst_tpu_torch.models import pspnet as tpsp
from dpst_tpu_torch.models import vgg as tvgg

jauto = importlib.import_module("dpst_tpu.autotune")
tauto = importlib.import_module("dpst_tpu_torch.autotune")

DIST_TOL = 1e-5
SCORE_TOL = 1e-4     # fp32 NIMA
TUNE_SCORE_TOL = 1e-3    # fp32 NIMA of the final images
BF16_SCORE_TOL = 5e-3    # bf16 NIMA, the sweep's own scores


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _he(r, shape, fan):
    return r.standard_normal(shape, np.float32) * np.float32(
        np.sqrt(2.0 / fan))


@pytest.fixture(scope="module")
def weights():
    """VGG-19, NIMA and PSPNet parameters in the JAX package's layouts
    (numpy) for dpst_tpu, and the port's copies."""
    r = np.random.default_rng(5)
    jv = {name: {"w": _he(r, (3, 3, cin, cout), 9 * cin),
                 "b": np.zeros(cout, np.float32)}
          for name, (cin, cout) in tvgg.CONV_SHAPES.items()}
    jn = {}
    for name, kind, cin, cout in jnima.SPECS:
        shape = {"conv": (3 if name == "stem" else 1,) * 2 + (cin, cout),
                 "dw": (3, 3, 1, cin), "dense": (cin, cout)}[kind]
        n = cin if kind == "dw" else cout
        jn[name] = {"w": _he(r, shape, int(np.prod(shape[:-1]))),
                    "scale": r.uniform(0.5, 1.5, n).astype(np.float32),
                    "bias": (0.1 * r.standard_normal(n)).astype(np.float32)}
    jp = {name: {"w": _he(r, (kh, kw, cin, cout), kh * kw * cin),
                 "scale": np.ones(cout, np.float32),
                 "bias": np.zeros(cout, np.float32)}
          for name, kh, kw, cin, cout in jpsp.CONV_SPECS}
    return {"jax": dict(vgg_params=jv, nima_params=jn, seg_params=jp),
            "torch": dict(vgg_params=tvgg.params_from_numpy(jv),
                          nima_params=tnima.params_from_numpy(jn),
                          seg_params=tpsp.params_from_numpy(jp))}


def _pair(size=32, seed=17):
    r = np.random.default_rng(seed)
    return (r.uniform(0, 255, (size, size, 3)).astype(np.float32),
            r.uniform(0, 255, (size, size, 3)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nima_matches_jax(weights, dtype):
    r = np.random.default_rng(13)
    img = r.uniform(0, 255, (2, 224, 224, 3)).astype(np.float32)
    jn, tn = weights["jax"]["nima_params"], weights["torch"]["nima_params"]
    ref = np.asarray(jnima.score_distribution(jn, img, dtype))
    got = tnima.score_distribution(tn, torch.from_numpy(img), dtype).numpy()
    feat = tnima.backbone_features(tn, torch.from_numpy(img), dtype)
    assert feat.shape == (2, 1024) and feat.dtype == torch.float32
    odd = r.uniform(0, 255, (3, 71, 97, 3)).astype(np.float32)
    ref_s = np.asarray(jnima.nima_score(jn, odd, dtype))
    got_s = tnima.nima_score(tn, torch.from_numpy(odd), dtype).numpy()
    one = float(tnima.nima_score(tn, odd[0], dtype))
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=DIST_TOL)
        np.testing.assert_allclose(got_s, ref_s, atol=SCORE_TOL)
        assert abs(one - float(ref_s[0])) <= SCORE_TOL
    else:   # bf16 convs round differently in the two packages
        np.testing.assert_allclose(got_s, ref_s, atol=BF16_SCORE_TOL)
    assert np.all((got_s >= 1.0) & (got_s <= 10.0))


def test_nima_param_count_pin():
    params = tnima.init_params(seed=0)
    n_w = sum(int(np.prod(p["w"].shape)) for p in params.values())
    assert n_w == 3_195_328
    assert sum(int(p["scale"].numel() + p["bias"].numel())
               for p in params.values()) == 21_908


def _stripes(k, size):
    cm = np.zeros((k, size, size), np.float32)
    sm = np.zeros((k, size, size), np.float32)
    for i in range(k):
        cm[i, i * size // k:(i + 1) * size // k] = 1
        sm[i, :, i * size // k:(i + 1) * size // k] = 1
    return cm, sm


TUNE_CASES = {
    # one scale, masks given, two rounds (a bracketing re-sweep)
    "one-scale": (dict(use_segmentation=True, iterations=8),
                  dict(gammas=(10.0, 1000.0), rounds=2, masks=True)),
    # two scales, automatic masks (PSPNet on both, merged to 4 classes)
    "two-scale-automatic": (dict(use_segmentation=True, iterations=6,
                                 scales=(16, 32), max_classes=4),
                            dict(gammas=(1.0, 1000.0), rounds=1,
                                 masks=False)),
}


@pytest.mark.parametrize("case", sorted(TUNE_CASES))
def test_autotune_matches_jax(weights, case, monkeypatch):
    monkeypatch.setattr(jpsp, "EVAL_SIZE", 64)
    monkeypatch.setattr(tpsp, "EVAL_SIZE", 64)
    cfg_kw, call = TUNE_CASES[case]
    kw = dict(use_photorealism=True, laplacian_impl="xla",
              compute_dtype="float32", regularization_weight=100.0,
              **cfg_kw)
    content, style = _pair()
    args = dict(gammas=call["gammas"], rounds=call["rounds"])
    if call["masks"]:
        cm, sm = _stripes(3, 32)
        args.update(content_masks=cm, style_masks=sm)
    ref = jauto.autotune(content, style, dpst_tpu.StylizeConfig(**kw),
                         **args, **weights["jax"])
    got = tauto.autotune(content, style, dpst_tpu_torch.StylizeConfig(**kw),
                         **args, **weights["torch"], device="cpu")
    np.testing.assert_allclose(got.gammas, ref.gammas, rtol=1e-6)
    assert got.images.shape == (len(call["gammas"]), 32, 32, 3)
    for a, b in zip(got.images, np.asarray(ref.images)):
        assert float(ssim(a, b)) >= 0.98
    np.testing.assert_allclose(
        tnima.nima_score(weights["torch"]["nima_params"],
                         torch.from_numpy(got.images), "float32").numpy(),
        np.asarray(jnima.nima_score(weights["jax"]["nima_params"],
                                    ref.images, "float32")),
        atol=TUNE_SCORE_TOL)
    np.testing.assert_allclose(got.scores, ref.scores, atol=BF16_SCORE_TOL)
    top = np.sort(ref.scores)
    if top[-1] - top[-2] > BF16_SCORE_TOL:
        assert got.best_gamma == ref.best_gamma
    assert got.scores[list(got.gammas).index(got.best_gamma)] \
        == got.scores.max()


def _sweep_and_sequential(weights, compute_dtype):
    """A two-round sweep of two Γ (two scales; block1_impl="s2d" so that
    the resolved s2d_gram sends conv1_1 to the fused bias+ReLU Gram pair,
    which plain `stylize` does not take at this size), and each last-round
    candidate's `stylize` run under the sweep's resolved config with
    style_weight = Γ."""
    content, style = _pair()
    cm, sm = _stripes(3, 32)
    cfg = dpst_tpu_torch.StylizeConfig(
        compute_dtype=compute_dtype, iterations=5, scales=(16, 32),
        block1_impl="s2d", regularization_weight=100.0, s2b_strips=4)
    res = tauto.autotune(content, style, cfg, gammas=(3.0, 300.0),
                         rounds=2, content_masks=cm, style_masks=sm,
                         **weights["torch"], device="cpu")
    resolved = tauto.resolve_config(cfg)
    assert resolved.s2d_gram == "pallas" and resolved.s2b_strips == 0
    masks = {"conv1_1": torch.zeros(3, 32, 32)}
    assert topt.fused_block1_taps(resolved, (32, 32, 3), masks) == (
        "conv1_1",)
    assert topt.fused_block1_taps(cfg, (32, 32, 3), masks) == ()
    outs = [dpst_tpu_torch.stylize(
        content, style, dataclasses.replace(
            resolved, style_weight=float(gamma)),
        content_masks=cm, style_masks=sm,
        vgg_params=weights["torch"]["vgg_params"], device="cpu")
        for gamma in res.gammas[-2:]]
    # the best image is the batch's image for the best Γ, bit for bit
    i = int(np.argmax(res.scores))
    assert res.best_gamma == float(res.gammas[i])
    if i >= len(res.gammas) - 2:
        np.testing.assert_array_equal(res.best_image,
                                      res.images[i - len(res.gammas) + 2])
    return res, outs


def test_sweep_equals_sequential_stylize(weights):
    """Each candidate's image, run in the sweep's batch, against a port
    `stylize` run of that candidate alone. In fp32 the two differ by the
    oneDNN fp32 convolutions, which take another algorithm for a batch
    of two than for one image and round apart (`test_fp32_batch_rounding_is_the_convs`); so they are held to
    the JAX package's own batch ≡ sequential bounds
    (tests/test_sharding.py: pixels rtol 1e-2, atol 0.25). In bf16 they
    are equal bit for bit (`test_sweep_equals_sequential_stylize_bf16`)."""
    res, outs = _sweep_and_sequential(weights, "float32")
    for image, out in zip(res.images, outs):
        np.testing.assert_allclose(image, out, rtol=1e-2, atol=0.25)


def test_sweep_equals_sequential_stylize_bf16(weights):
    """In bf16 every candidate's image equals its `stylize` run alone bit
    for bit."""
    res, outs = _sweep_and_sequential(weights, "bfloat16")
    for image, out in zip(res.images, outs):
        np.testing.assert_array_equal(image, out)


def test_fp32_batch_rounding_is_the_convs(weights):
    """What breaks fp32 bit-equality between a batch and one image on the
    CPU: oneDNN's fp32 convolution picks its algorithm by batch size and
    rounds a batch's images apart from the same images one at a time
    (conv1_1 shown here); its bf16 convolution does not."""
    import torch.nn.functional as F
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.normal(size=(2, 3, 32, 32)).astype(np.float32))
    w = weights["torch"]["vgg_params"]["conv1_1"]["w"]
    conv = lambda x: F.conv2d(x, w.to(x.dtype), padding=1)
    one = lambda x: torch.cat([conv(x[i:i + 1]) for i in range(2)])
    assert not torch.equal(conv(x), one(x))
    xb = x.bfloat16()
    assert torch.equal(conv(xb), one(xb))


def test_resolve_config_as_one_device():
    cfg = dpst_tpu_torch.PRESETS["config3"]
    out = tauto.resolve_config(cfg)
    assert (out.s2b_strips, out.s2d_gram) == (0, "pallas")
    kept = dpst_tpu_torch.StylizeConfig(s2d_gram="nd", s2b_strips=0)
    assert tauto.resolve_config(kept) is kept
    # at 512² the resolved config3 takes the fused pair at conv1_1 (K = 8)
    masks = {"conv1_1": torch.zeros(8, 512, 512)}
    assert topt.fused_block1_taps(out, (512, 512, 3), masks) == ("conv1_1",)
    assert topt.fused_block1_taps(cfg, (512, 512, 3), masks) == ()


def test_autotune_callable_after_submodule_import(weights):
    mod = importlib.import_module("dpst_tpu_torch.autotune")
    import dpst_tpu_torch.autotune  # noqa: F401  (the submodule again)
    assert dpst_tpu_torch.autotune is mod.autotune
    content, style = _pair(16)
    cfg = dpst_tpu_torch.StylizeConfig(
        use_segmentation=False, use_photorealism=False,
        compute_dtype="float32", iterations=2)
    res = dpst_tpu_torch.autotune(content, style, cfg, gammas=(1.0,),
                                  **weights["torch"], device="cpu")
    assert res.images.shape == (1, 16, 16, 3)
    assert res.best_gamma == 1.0 and np.isfinite(res.scores).all()
    # over a mesh of two CPU devices: one candidate each, the same result
    # as the two candidates as one batch on one device (s2d_gram resolves
    # to "nd" on two devices and to "pallas" on one; at 16² both take the
    # unfused block-1 route)
    from dpst_tpu_torch.parallel import mesh as tmesh
    two = dict(gammas=(1.0, 100.0), **weights["torch"])
    on_mesh = dpst_tpu_torch.autotune(
        content, style, cfg, mesh=tmesh.make_mesh(devices=["cpu"] * 2),
        **two)
    alone = dpst_tpu_torch.autotune(content, style, cfg, device="cpu", **two)
    np.testing.assert_allclose(on_mesh.images, alone.images, rtol=1e-2,
                               atol=0.25)
    np.testing.assert_array_equal(on_mesh.gammas, alone.gammas)
