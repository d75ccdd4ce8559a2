"""Row-sharded stylization in the port (`dpst_tpu_torch/parallel/spatial.py`)
against the JAX package's `stylize_spatial` (on conftest's 8 virtual CPU
devices) and against the port's own unsharded run; the port's meshes
repeat the "cpu" device.

Tolerances:
  * against the JAX package, its own test's bounds (`tests/
    test_spatial.py`): history column 0 rtol 1e-3; pixels rtol 5e-2,
    atol 2.0 (Adam's first step moves a pixel by ±lr wherever the
    gradient's sign is near a tie, so pixels get a loose bound and the
    loss curve the tight one);
  * against the port's unsharded run of the same `spmd_safe` config:
    the first history row within 1e-5 of each column's max (one forward:
    the shards' convs and reductions round apart), column 0 rtol 5e-4,
    mean |pixel| 0.05 and pixels rtol 5e-2, atol 2.0;
  * the input gradient of the whole sharded loss against the unsharded
    one: 1e-5 of max|g| (fp32);
  * "pallas" (→ "spmd") against "xla" in spatial mode: bit for bit (the
    port runs the one row-sharded matvec for both)."""
import jax
import numpy as np
import pytest
import torch

import dpst_tpu
import dpst_tpu_torch
from dpst_tpu.models import vgg as jvgg
from dpst_tpu.parallel import spatial as jspatial
from dpst_tpu_torch import optimize as topt
from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.ops import kernels
from dpst_tpu_torch.parallel import mesh as tmesh
from dpst_tpu_torch.parallel import spatial as tspatial

HIST_RTOL, PIX_RTOL, PIX_ATOL = 1e-3, 5e-2, 2.0       # the JAX test's
ROW0_TOL, SELF_HIST_RTOL, SELF_PIX_MEAN = 1e-5, 5e-4, 0.05
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """tests/test_spatial.py's pair: 64², two half-image masks."""
    r = np.random.default_rng(41)
    content = r.uniform(0, 255, (64, 64, 3)).astype(np.float32)
    style = r.uniform(0, 255, (64, 64, 3)).astype(np.float32)
    masks = np.zeros((2, 64, 64), np.float32)
    masks[0, :32] = 1.0
    masks[1, 32:] = 1.0
    return content, style, masks


@pytest.fixture(scope="module")
def params():
    jp = jvgg.init_params(seed=0)
    return jp, tvgg.params_from_numpy(jax.tree.map(np.asarray, jp))


def _cfg(pkg, **kw):
    base = dict(use_segmentation=True, use_photorealism=True,
                laplacian_impl="xla", compute_dtype="float32",
                max_classes=2, iterations=6)
    base.update(kw)
    return pkg.StylizeConfig(**base)


def _cpu_mesh(n):
    return tspatial.make_spatial_mesh(devices=["cpu"] * n)


def _port_spatial(pair, params, n=4, **kw):
    content, style, masks = pair
    img, hist = tspatial.stylize_spatial(
        content, style, masks, masks, _cfg(dpst_tpu_torch, **kw), params[1],
        _cpu_mesh(n))
    return img.numpy(), hist.numpy()


@pytest.fixture(scope="module")
def jax_runs(pair, params):
    """The JAX package's stylize_spatial on 4 virtual devices: one scale
    (6 steps) and scales (32, 64) (4 a stage), computed once."""
    content, style, masks = pair
    out = {}
    for name, kw in (("one", {}), ("multi", dict(scales=(32, 64),
                                                  iterations=4))):
        img, hist = jspatial.stylize_spatial(
            content, style, masks, masks, cfg=_cfg(dpst_tpu, **kw),
            vgg_params=params[0], mesh=jspatial.make_spatial_mesh(4))
        out[name] = (np.asarray(img), np.asarray(hist))
    return out


@pytest.fixture(scope="module")
def port_runs(pair, params):
    """The port's sharded run (4 shards) and its unsharded `stylize` of the
    same spmd_safe config, 6 steps."""
    content, style, masks = pair
    sharded = _port_spatial(pair, params)
    unsharded = dpst_tpu_torch.stylize(
        content, style, _cfg(dpst_tpu_torch).spmd_safe(),
        content_masks=masks, style_masks=masks, vgg_params=params[1],
        return_history=True, device="cpu")
    return sharded, unsharded


def test_spatial_matches_jax(port_runs, jax_runs):
    img, hist = port_runs[0]
    ref_img, ref_hist = jax_runs["one"]
    assert img.shape == (64, 64, 3) and hist.shape == (6, 5)
    np.testing.assert_allclose(hist[:, 0], ref_hist[:, 0], rtol=HIST_RTOL)
    np.testing.assert_allclose(img, ref_img, rtol=PIX_RTOL, atol=PIX_ATOL)


def test_spatial_matches_unsharded(port_runs):
    (img, hist), (ref_img, ref_hist) = port_runs
    top = np.abs(ref_hist).max(axis=0) + 1e-30
    assert (np.abs(hist[0] - ref_hist[0]) <= ROW0_TOL * top).all()
    np.testing.assert_allclose(hist[:, 0], ref_hist[:, 0],
                               rtol=SELF_HIST_RTOL)
    assert np.abs(img - ref_img).mean() <= SELF_PIX_MEAN
    np.testing.assert_allclose(img, ref_img, rtol=PIX_RTOL, atol=PIX_ATOL)


def test_spatial_multiscale_matches_jax(pair, params, jax_runs):
    """scales (32, 64): the 32² stage on the first device, the 64² stage
    sharded; the whole trajectory against the JAX package's."""
    img, hist = _port_spatial(pair, params, scales=(32, 64), iterations=4)
    ref_img, ref_hist = jax_runs["multi"]
    assert hist.shape == ref_hist.shape == (8, 5)
    np.testing.assert_allclose(hist[:, 0], ref_hist[:, 0], rtol=HIST_RTOL)
    np.testing.assert_allclose(img, ref_img, rtol=PIX_RTOL, atol=PIX_ATOL)


def test_spatial_rejects_indivisible_rows_and_lbfgs(pair, params):
    content, style, masks = pair
    with pytest.raises(ValueError, match="not divisible"):
        tspatial.stylize_spatial(content[:63], style, masks[:, :63], masks,
                                 _cfg(dpst_tpu_torch), params[1],
                                 _cpu_mesh(4))
    with pytest.raises(ValueError, match="local rows"):
        # 64 rows over 64 shards: one row a shard for the Laplacian
        tspatial.stylize_spatial(content, style, masks, masks,
                                 _cfg(dpst_tpu_torch), params[1],
                                 _cpu_mesh(64))


def test_spmd_pallas_laplacian_equals_xla(pair, params):
    """laplacian_impl="pallas" is made "spmd" in spatial mode and runs the
    same row-sharded matvec as "xla": bit for bit."""
    cfg = _cfg(dpst_tpu_torch, laplacian_impl="pallas")
    assert cfg.spmd_safe().laplacian_impl == "spmd"
    ref = _port_spatial(pair, params, iterations=3)
    got = _port_spatial(pair, params, iterations=3, laplacian_impl="pallas")
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0], ref[0])


def test_constants_placement_is_field_explicit(pair, params):
    """test_spatial.py's placement test at K = 4 = n: Grams and coverage
    whole (never split along K), masks, content features and the image
    row-sharded where the level plan shards them, the packed stats
    row-sharded with their neighbours' 2-row halos; `spatial_shardings`
    gives the same placement from shapes alone (meta tensors)."""
    content, style, _ = pair
    mc = np.zeros((4, 64, 64), np.float32)
    for k in range(4):
        mc[k, k * 16:(k + 1) * 16] = 1.0
    cfg = _cfg(dpst_tpu_torch, max_classes=4)
    tp = tvgg.pack_params(params[1], "float32")
    arrays = [torch.from_numpy(a) for a in (content, style, mc, mc)]
    consts = dpst_tpu_torch.prepare_constants(*arrays, cfg, tp)
    image = topt.init_image(cfg, arrays[0])
    mesh = _cpu_mesh(4)
    sc, shards = tspatial.shard_spatial(consts, image, mesh)
    assert sc.plan == (True,) * 5
    for layer, g in sc.style_grams.items():
        assert torch.is_tensor(g) and torch.equal(g, consts.style_grams[layer])
    assert torch.equal(sc.coverage, consts.coverage)
    for field in ("masks", "content_feats"):
        for layer, whole in getattr(consts, field).items():
            parts = getattr(sc, field)[layer]
            assert [tuple(p.shape) for p in parts] == [
                (*whole.shape[:-2], whole.shape[-2] // 4,
                 whole.shape[-1])] * 4, (field, layer)
            assert torch.equal(torch.cat(parts, -2), whole)
    pad = torch.nn.functional.pad(consts.lap_stats, (0, 0, 2, 2))
    assert [tuple(s.shape) for s in sc.lap_stats] == [(14, 20, 64)] * 4
    for i, s in enumerate(sc.lap_stats):
        assert torch.equal(s, pad[:, 16 * i:16 * i + 20])
    assert [tuple(s.shape) for s in shards] == [(16, 64, 3)] * 4
    for layer, m in consts.masks.items():
        assert torch.equal(sc.norms[layer], (m * m).sum((-2, -1)))
    # the placement from shapes alone
    meta = consts.map(lambda t: torch.empty(t.shape, device="meta"))
    sh, sh_img = tspatial.spatial_shardings(
        meta, torch.empty(image.shape, device="meta"), mesh)
    assert all(s.spec == () for s in sh.style_grams.values())
    assert sh.coverage.spec == ()
    assert all(s.spec == (None, "rows", None) for s in sh.masks.values())
    assert sh.lap_stats.spec == (None, "rows", None)
    assert sh_img.spec == ("rows", None, None)


@pytest.mark.parametrize("size,n,plan", [
    (24, 2, (True, True, True, False, False)),
    (48, 4, (True, True, True, False, False)),
    (64, 4, (True,) * 5),
    (4096, 4, (True,) * 5),
    (40, 4, (True, True, False, False, False)),
    (30, 4, (False,) * 5),
])
def test_level_plan(size, n, plan):
    assert tspatial.level_plan(size, n) == plan


@pytest.mark.parametrize("size,n", [(48, 4), (64, 4), (24, 2)])
def test_sharded_loss_and_gradient_match_unsharded(size, n, params):
    """One evaluation of the whole sharded objective (a batch of two, tv
    on, four classes) against `optimize.make_loss_fn`'s: every term
    within 1e-5 of its value and the input gradient within 1e-5 of
    max|g| (fp32). At 48² on 4 shards levels 3-4 run gathered, at 24² on
    2 level 3 on; a halo-gradient fault would show in the rows next to
    the shard edges. Launch counts are unchanged (CPU shards run the
    plain versions)."""
    r = np.random.default_rng(size)
    cfg = _cfg(dpst_tpu_torch, tv_weight=10.0).spmd_safe()
    img = torch.from_numpy(r.uniform(0, 255, (2, size, size, 3)).astype(
        np.float32))
    style = torch.from_numpy(r.uniform(0, 255, (2, size, size, 3)).astype(
        np.float32))
    masks = torch.from_numpy(r.uniform(0, 1, (2, 4, size, size)).astype(
        np.float32))
    tp = tvgg.pack_params(params[1], "float32")
    consts = dpst_tpu_torch.prepare_constants(img, style, masks, masks,
                                              cfg, tp)
    x = (img * 0.5 + 60).requires_grad_(True)
    weights = topt.LossWeights.from_config(cfg)
    total, terms = topt.make_loss_fn(cfg)(x, consts, weights, tp)
    (g,) = torch.autograd.grad(total, x)
    sc, shards = tspatial.shard_spatial(consts, x.detach(),
                                        _cpu_mesh(n))
    assert sc.plan == tspatial.level_plan(size, n)
    shards = [s.requires_grad_(True) for s in shards]
    before = dict(kernels.LAUNCHES)
    total2, terms2 = tspatial.make_spatial_loss(cfg)(
        shards, sc, weights, {torch.device("cpu"): tp})
    g2 = torch.cat(torch.autograd.grad(total2, shards), dim=-3)
    assert kernels.LAUNCHES == before
    np.testing.assert_allclose(terms2.detach().numpy(),
                               terms.detach().numpy(), rtol=GRAD_TOL)
    np.testing.assert_allclose(g2.numpy(), g.numpy(), rtol=0,
                               atol=GRAD_TOL * float(g.abs().max()))


def test_spatial_one_shard_is_the_unsharded_loop(pair, params):
    """A mesh of one device runs the shard loop on one shard: bit for bit
    `stylize` under the same spmd_safe config."""
    content, style, masks = pair
    img, hist = _port_spatial(pair, params, n=1, iterations=3)
    ref_img, ref_hist = dpst_tpu_torch.stylize(
        content, style, _cfg(dpst_tpu_torch, iterations=3).spmd_safe(),
        content_masks=masks, style_masks=masks, vgg_params=params[1],
        return_history=True, device="cpu")
    np.testing.assert_array_equal(hist, ref_hist)
    np.testing.assert_array_equal(img, ref_img)


def test_spatial_debug_nans_checks_every_shard(pair, params):
    content, style, masks = pair
    content = content.copy()
    content[50, 3, 1] = np.nan          # in the last of four shards
    with pytest.raises(FloatingPointError, match="step 0"):
        tspatial.stylize_spatial(content, style, masks, masks,
                                 _cfg(dpst_tpu_torch, debug_nans=True),
                                 params[1], _cpu_mesh(4))


def test_make_spatial_mesh():
    mesh = tspatial.make_spatial_mesh(2, devices=["cpu"] * 3)
    assert mesh.axis_names == (tmesh.ROW_AXIS,) and mesh.size == 2
    with pytest.raises(ValueError, match="requested 4 devices, have 3"):
        tspatial.make_spatial_mesh(4, devices=["cpu"] * 3)
