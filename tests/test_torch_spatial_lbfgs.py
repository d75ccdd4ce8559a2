"""L-BFGS on a row-sharded image in the port (`optim` over a list of row
shards, `parallel/spatial.py`), against the JAX package's
`stylize_spatial` and, on a 2 × 2 mesh, `stylize_batch` with
optimizer="lbfgs" (on conftest's 8 virtual CPU devices) and against the
port's own unsharded L-BFGS; the port's meshes repeat the "cpu" device.

Tolerances: the L-BFGS golden's (`tests/test_golden.py`,
`tests/test_torch_lbfgs.py::test_golden_lbfgs_config3`): SSIM >= 0.98
between the images, the loss history within rtol 1e-2 over its first 10
rows and 8e-2 over all (L-BFGS amplifies the last bits of an fp32 sum
taken in another order into its stepsizes within a few steps). Against
the port's unsharded run the first row, one evaluation before any step,
within 1e-5 as well. A mesh of one shard is the unsharded loop bit for
bit, evaluation counts included; the sharded dot product is the
shard-order sum of the partial dots exactly."""
import jax
import numpy as np
import pytest
import torch

import dpst_tpu
from dpst_tpu.models import vgg as jvgg
from dpst_tpu.ops.metrics import ssim
from dpst_tpu.parallel import batch as jbatch
from dpst_tpu.parallel import mesh as jmesh
from dpst_tpu.parallel import spatial as jspatial
import dpst_tpu_torch
from dpst_tpu_torch import cli as tcli
from dpst_tpu_torch import optim
from dpst_tpu_torch import optimize as topt
from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.parallel import mesh as tmesh
from dpst_tpu_torch.parallel import spatial as tspatial
from dpst_tpu_torch.utils import io

SSIM_MIN, HIST10_RTOL, HIST_RTOL = 0.98, 1e-2, 8e-2   # the golden's
ROW0_TOL = 1e-5


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
                max_classes=2, iterations=6, optimizer="lbfgs")
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


def _port_unsharded(pair, params, **kw):
    content, style, masks = pair
    return dpst_tpu_torch.stylize(
        content, style, _cfg(dpst_tpu_torch, **kw).spmd_safe(),
        content_masks=masks, style_masks=masks, vgg_params=params[1],
        return_history=True, device="cpu")


def _golden_bounds(img, hist, ref_img, ref_hist):
    assert img.shape == ref_img.shape and hist.shape == ref_hist.shape
    assert float(ssim(img, ref_img)) >= SSIM_MIN
    np.testing.assert_allclose(hist[:10, 0], ref_hist[:10, 0],
                               rtol=HIST10_RTOL)
    np.testing.assert_allclose(hist[:, 0], ref_hist[:, 0], rtol=HIST_RTOL)


@pytest.fixture(scope="module")
def sharded(pair, params):
    """The port's sharded L-BFGS on 4 shards, 6 steps, with its record."""
    with topt.record_evaluations() as rec:
        img, hist = _port_spatial(pair, params)
    return img, hist, rec


def test_spatial_lbfgs_matches_jax(pair, params, sharded):
    """(a) The JAX package's stylize_spatial with optimizer="lbfgs" over
    its mesh of 4, the same inputs and weights, 6 steps."""
    content, style, masks = pair
    ref_img, ref_hist = jspatial.stylize_spatial(
        content, style, masks, masks, cfg=_cfg(dpst_tpu),
        vgg_params=params[0], mesh=jspatial.make_spatial_mesh(4))
    img, hist, _ = sharded
    assert hist.shape == (6, 5) and not hist[:, 1:].any()
    assert hist[-1, 0] < hist[0, 0]
    _golden_bounds(img, hist, np.asarray(ref_img), np.asarray(ref_hist))


def test_spatial_lbfgs_one_shard_is_the_unsharded_loop(pair, params):
    """(b) A mesh of one device: the image, the history and each step's
    evaluations and linesearch record of the unsharded loop, bit for
    bit."""
    with topt.record_evaluations() as rec:
        img, hist = _port_spatial(pair, params, n=1, iterations=4)
    with topt.record_evaluations() as ref_rec:
        ref_img, ref_hist = _port_unsharded(pair, params, iterations=4)
    np.testing.assert_array_equal(hist, ref_hist)
    np.testing.assert_array_equal(img, ref_img)
    assert rec == ref_rec and len(rec) == 4


def test_spatial_lbfgs_matches_unsharded(pair, params, sharded):
    """(c) 4 shards against the port's unsharded run of the same
    spmd_safe config: the first row (one evaluation) within 1e-5, then the
    golden's bounds; every evaluation is the linesearch's but the first."""
    img, hist, rec = sharded
    ref_img, ref_hist = _port_unsharded(pair, params)
    assert abs(hist[0, 0] - ref_hist[0, 0]) <= ROW0_TOL * abs(ref_hist[0, 0])
    _golden_bounds(img, hist, ref_img, ref_hist)
    assert len(rec) == 6
    assert sum(r["evaluations"] for r in rec) == 1 + sum(
        r["num_linesearch_steps"] for r in rec)


@pytest.mark.parametrize("n", [1, 3])
def test_sharded_vdot_is_the_shard_order_sum(n):
    """(d) ⟨a, b⟩ of shards: the partial dots added in shard order on the
    first shard's device, exactly; of one shard, vdot of the tensor."""
    r = np.random.default_rng(n)
    a = [torch.from_numpy(r.normal(size=(1, 5 + i, 7, 3)).astype(np.float32))
         for i in range(n)]
    b = [torch.from_numpy(r.normal(size=x.shape).astype(np.float32))
         for x in a]
    want = torch.sum(a[0] * b[0])
    for x, y in zip(a[1:], b[1:]):
        want = want + torch.sum(x * y)
    got = optim.vdot(a, b)
    assert got.dim() == 0 and torch.equal(got, want)
    if n == 1:
        assert torch.equal(got, optim.vdot(a[0], b[0]))
    assert torch.equal(optim.vdot(a, a),
                       optim.vdot([x.clone() for x in a], a))


def test_lbfgs_update_of_one_shard_is_the_tensors():
    """scale_by_lbfgs over a list of one tensor: the tensor's update bit
    for bit, three steps into its ring."""
    r = np.random.default_rng(5)
    opt = optim.scale_by_lbfgs()
    x = torch.from_numpy(r.normal(size=(6, 4, 3)).astype(np.float32))
    st, st1 = opt.init(x), opt.init([x])
    for _ in range(3):
        g = torch.from_numpy(r.normal(size=x.shape).astype(np.float32))
        u, st = opt.update(g, st, x)
        u1, st1 = opt.update([g], st1, [x])
        assert torch.equal(u1[0], u)
        x = x - 0.1 * u


def test_spatial_lbfgs_multiscale_falls_in_each_stage(pair, params):
    """(e) scales (32, 64), 4 steps a stage: the 32² stage's L-BFGS on the
    first device, the 64² stage's over 4 shards; the loss falls in each."""
    img, hist = _port_spatial(pair, params, scales=(32, 64), iterations=4)
    assert img.shape == (64, 64, 3) and hist.shape == (8, 5)
    assert np.isfinite(img).all() and 0.0 <= img.min() <= img.max() <= 255.0
    assert hist[3, 0] < hist[0, 0] and hist[7, 0] < hist[4, 0]


@pytest.fixture(scope="module")
def mesh_batch(params):
    """Two 24² pairs, and the port's stylize_batch with L-BFGS over a
    2 × 2 mesh (the pairs split two ways, each share row-sharded over two
    devices, the shares in turns), 5 steps."""
    r = np.random.default_rng(31)
    b, h, k = 2, 24, 2
    contents = r.uniform(0, 255, (b, h, h, 3)).astype(np.float32)
    styles = r.uniform(0, 255, (b, h, h, 3)).astype(np.float32)
    masks = np.zeros((b, k, h, h), np.float32)
    masks[:, 0, :12] = 1.0
    masks[:, 1, 12:] = 1.0
    inputs = (contents, styles, masks, masks)
    img, hist = dpst_tpu_torch.stylize_batch(
        *inputs, _cfg(dpst_tpu_torch, iterations=5), vgg_params=params[1],
        mesh=tmesh.make_mesh_2d(2, 2, devices=["cpu"] * 4))
    assert hist.shape == (b, 5, 5)
    return inputs, img, hist


def test_lbfgs_batch_on_a_2x2_mesh_matches_one_device(params, mesh_batch):
    """(f) The 2 × 2 mesh batch against the one-device stylize_batch of
    the same spmd_safe config: each pair within the golden's bounds."""
    inputs, img, hist = mesh_batch
    ref_img, ref_hist = dpst_tpu_torch.stylize_batch(
        *inputs, _cfg(dpst_tpu_torch, iterations=5).spmd_safe(),
        vgg_params=params[1], device="cpu")
    for i in range(len(img)):
        _golden_bounds(img[i], hist[i], ref_img[i], ref_hist[i])


def test_lbfgs_batch_on_a_2x2_mesh_matches_jax(params, mesh_batch):
    """(f) The 2 × 2 mesh batch against the JAX package's stylize_batch
    with L-BFGS over its 2 × 2 mesh of virtual CPU devices: each pair
    within the golden's bounds."""
    inputs, img, hist = mesh_batch
    ref_img, ref_hist = jbatch.stylize_batch(
        *inputs, cfg=_cfg(dpst_tpu, iterations=5), vgg_params=params[0],
        mesh=jmesh.make_mesh_2d(2, 2))
    for i in range(len(img)):
        _golden_bounds(img[i], hist[i], np.asarray(ref_img[i]),
                       np.asarray(ref_hist[i]))


def test_cli_spatial_lbfgs(tmp_path, capsys):
    """(g) python -m dpst_tpu_torch --device cpu --spatial 2 --optimizer
    lbfgs writes its image and its loss CSV."""
    r = np.random.default_rng(9)
    c, s = str(tmp_path / "content.png"), str(tmp_path / "style.png")
    io.save_image(r.uniform(0, 255, (32, 32, 3)), c)
    io.save_image(r.uniform(0, 255, (32, 32, 3)), s)
    out, csv = str(tmp_path / "out.png"), str(tmp_path / "loss.csv")
    assert tcli.main(["--content", c, "--style", s, "--size", "32",
                      "--output", out, "--loss-csv", csv, "--iterations",
                      "3", "--optimizer", "lbfgs", "--spatial", "2",
                      "--no-segmentation", "--laplacian-impl", "xla",
                      "--dtype", "float32", "--device", "cpu"]) == 0
    assert "2-way row-sharded" in capsys.readouterr().out
    assert io.load_image(out).shape == (32, 32, 3)
    hist = np.loadtxt(csv, delimiter=",", skiprows=1)
    assert hist.shape == (3, 5) and hist[-1, 0] < hist[0, 0]
