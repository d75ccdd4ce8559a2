"""The port's device mesh (`dpst_tpu_torch/parallel/mesh.py`) and the mesh
arguments of `stylize_batch` and `autotune`, against the JAX package on
conftest's 8 virtual CPU devices; the port's meshes repeat the "cpu"
device.

Tolerances (fp32):
  * port over a 1-D mesh of 4 against the JAX package over its mesh of 4
    (`tests/test_sharding.py`'s toy batch): images rtol 1e-2, atol 0.25,
    history column 0 rtol 1e-3 — the JAX package's batch ≡ sequential
    bounds;
  * a 2-D (4 × 2) mesh against the 1-D mesh of 4, the same pairs row-
    sharded over two devices: the JAX test's history rtol 1e-3 and pixels
    rtol 5e-2, atol 2.0, and a tighter bound of the port's own, history
    rtol 1e-4 and mean |pixel| 0.01;
  * a shrunk mesh of one device against the run without a mesh, and the
    share of each device against the same pairs alone: bit for bit;
  * `autotune` over a mesh of 2 against the JAX package's over its mesh
    of 2: images rtol 1e-2, atol 0.25 (its batch bounds); the sweep's own
    scores (bf16 NIMA in both packages) within 5e-3 and the same best Γ
    where the top two scores differ by more, as
    `tests/test_torch_autotune.py` holds them."""
import jax
import numpy as np
import pytest
import torch

import dpst_tpu
import dpst_tpu_torch
from dpst_tpu.autotune import autotune as jautotune
from dpst_tpu.models import nima as jnima
from dpst_tpu.models import vgg as jvgg
from dpst_tpu.parallel import batch as jbatch
from dpst_tpu.parallel import mesh as jmesh
from dpst_tpu_torch import optimize as topt
from dpst_tpu_torch.models import nima as tnima
from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.parallel import batch as tbatch
from dpst_tpu_torch.parallel import mesh as tmesh

HIST_RTOL, PIX_RTOL, PIX_ATOL = 1e-3, 1e-2, 0.25
ROWS_PIX_RTOL, ROWS_PIX_ATOL = 5e-2, 2.0
OWN_HIST_RTOL, OWN_PIX_MEAN = 1e-4, 0.01
BF16_SCORE_TOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy_batch():
    """tests/test_sharding.py's toy batch: B = 4, 24², K = 2."""
    r = np.random.default_rng(31)
    b, h, w, k = 4, 24, 24, 2
    contents = r.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    styles = r.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    cmasks = np.zeros((b, k, h, w), np.float32)
    smasks = np.zeros((b, k, h, w), np.float32)
    cmasks[:, 0, :12] = 1.0
    cmasks[:, 1, 12:] = 1.0
    smasks[:, 0, :, :12] = 1.0
    smasks[:, 1, :, 12:] = 1.0
    return contents, styles, cmasks, smasks


@pytest.fixture(scope="module")
def params():
    jp = jvgg.init_params(seed=0)
    return jp, tvgg.params_from_numpy(jax.tree.map(np.asarray, jp))


def _cfg(pkg, **kw):
    base = dict(use_segmentation=True, use_photorealism=True,
                laplacian_impl="xla", compute_dtype="float32",
                max_classes=2, iterations=8)
    base.update(kw)
    return pkg.StylizeConfig(**base)


def _cpu(n):
    return ["cpu"] * n


def _port(batch, params, mesh=None, **kw):
    weights = kw.pop("weights", None)
    per_pair = kw.pop("per_pair_weights", False)
    return dpst_tpu_torch.stylize_batch(
        *batch, _cfg(dpst_tpu_torch, **kw), vgg_params=params[1],
        weights=weights, per_pair_weights=per_pair, mesh=mesh,
        device=None if mesh is not None else "cpu")


@pytest.fixture(scope="module")
def runs(toy_batch, params):
    """The JAX package's stylize_batch over its mesh of 4, and the port's
    over a 1-D mesh of 4 and a 2-D mesh of 4 × 2, computed once."""
    jimg, jhist = jbatch.stylize_batch(
        *toy_batch, cfg=_cfg(dpst_tpu), vgg_params=params[0],
        mesh=jmesh.make_mesh(4))
    return {"jax": (np.asarray(jimg), np.asarray(jhist)),
            "1d": _port(toy_batch, params, tmesh.make_mesh(devices=_cpu(4))),
            "2d": _port(toy_batch, params,
                        tmesh.make_mesh_2d(4, 2, devices=_cpu(8)))}


def test_batch_mesh_matches_jax(runs):
    img, hist = runs["1d"]
    ref_img, ref_hist = runs["jax"]
    assert img.shape == (4, 24, 24, 3) and hist.shape == (4, 8, 5)
    np.testing.assert_allclose(hist[..., 0], ref_hist[..., 0],
                               rtol=HIST_RTOL)
    np.testing.assert_allclose(img, ref_img, rtol=PIX_RTOL, atol=PIX_ATOL)


def test_batch_2d_mesh_matches_1d(runs):
    img, hist = runs["2d"]
    ref_img, ref_hist = runs["1d"]
    np.testing.assert_allclose(hist[..., 0], ref_hist[..., 0],
                               rtol=HIST_RTOL)
    np.testing.assert_allclose(img, ref_img, rtol=ROWS_PIX_RTOL,
                               atol=ROWS_PIX_ATOL)
    np.testing.assert_allclose(hist[..., 0], ref_hist[..., 0],
                               rtol=OWN_HIST_RTOL)
    assert np.abs(img - ref_img).mean() <= OWN_PIX_MEAN


def test_each_device_runs_its_own_pairs(toy_batch, params, runs):
    """Over a 1-D mesh of 4 each device runs one pair: pair i equals the
    one-pair batch of pair i under the same (spmd_safe) config, bit for
    bit; the results come back in pair order."""
    img, hist = runs["1d"]
    for i in (0, 3):
        one = tuple(a[i:i + 1] for a in toy_batch)
        ref_img, ref_hist = _port(one, params,
                                  tmesh.make_mesh(devices=_cpu(1)),
                                  **vars_spmd_safe())
        np.testing.assert_array_equal(hist[i:i + 1], ref_hist)
        np.testing.assert_array_equal(img[i:i + 1], ref_img)


def vars_spmd_safe() -> dict:
    """The fields `spmd_safe` changes in the toy config, so that a run on
    one device takes what a mesh of more than one resolves to."""
    safe = _cfg(dpst_tpu_torch).spmd_safe()
    return {f: getattr(safe, f) for f in (
        "laplacian_impl", "gram_impl", "block1_impl", "s2d_gram",
        "s2b_strips", "strip_gram")}


def test_mesh_batch_errors_and_shrink(toy_batch, params):
    """A 2-D mesh whose batch axis does not divide B raises; a 1-D mesh
    shrinks to the largest device count that divides B (3 pairs on 2
    devices: one device, which is the run without a mesh bit for bit)."""
    three = tuple(a[:3] for a in toy_batch)
    with pytest.raises(ValueError, match="does not divide"):
        _port(three, params, tmesh.make_mesh_2d(4, 2, devices=_cpu(8)))
    seen = []
    real = tbatch._device_stages

    def spy(*a, **k):
        seen.append(a[0].device)
        return real(*a, **k)

    tbatch._device_stages = spy
    try:
        img, hist = _port(three, params, tmesh.make_mesh(devices=_cpu(2)),
                          iterations=3)
    finally:
        tbatch._device_stages = real
    assert len(seen) == 1
    ref_img, ref_hist = _port(three, params, iterations=3)
    np.testing.assert_array_equal(hist, ref_hist)
    np.testing.assert_array_equal(img, ref_img)


def test_per_pair_weights_on_a_mesh(toy_batch, params):
    """test_sharding.py's per-pair weights over a mesh of 4 (each device
    one pair's Γ): zero style weight gives total = content at every step,
    and the step-0 totals rise with Γ."""
    gammas = np.asarray([0.0, 10.0, 100.0, 1000.0], np.float32)
    weights = topt.LossWeights(content=np.ones(4, np.float32), style=gammas,
                               reg=np.zeros(4, np.float32),
                               tv=np.zeros(4, np.float32))
    _, hist = _port(toy_batch, params, tmesh.make_mesh(devices=_cpu(4)),
                    use_photorealism=False, iterations=5, weights=weights,
                    per_pair_weights=True)
    np.testing.assert_allclose(hist[0, :, 0], hist[0, :, 1], rtol=1e-5)
    assert np.all(np.diff(hist[:, 0, 0]) > 0), hist[:, 0, 0]


def test_single_device_spmd_falls_back(toy_batch, params):
    """A config carrying laplacian_impl="spmd" runs on a one-device mesh
    as the one-device matvec (test_laplacian_spmd.py's fallback); so does a
    mesh of two, after spmd_safe."""
    two = tuple(a[:2] for a in toy_batch)
    for n in (1, 2):
        _, hist = _port(two, params, tmesh.make_mesh(devices=_cpu(n)),
                        laplacian_impl="spmd", iterations=2)
        assert np.isfinite(hist).all()
        assert (hist[..., 3] > 0).all()       # the photoreal term runs
    assert tbatch.resolve_config(_cfg(dpst_tpu_torch, laplacian_impl="spmd"),
                                 2).laplacian_impl == "xla"
    assert tbatch.resolve_config(_cfg(dpst_tpu_torch),
                                 2).s2d_gram == "nd"
    assert tbatch.resolve_config(_cfg(dpst_tpu_torch)).s2d_gram == "pallas"


def test_mesh_helpers():
    mesh = tmesh.make_mesh_2d(2, 3, devices=_cpu(6))
    assert mesh.shape == {"batch": 2, "rows": 3} and mesh.size == 6
    assert tmesh.has_row_axis(mesh)
    assert not tmesh.has_row_axis(tmesh.make_mesh(devices=_cpu(2)))
    with pytest.raises(ValueError, match="requested 6 devices, have 5"):
        tmesh.make_mesh_2d(2, 3, devices=_cpu(5))
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        tmesh.make_mesh(3, devices=_cpu(2))
    x = torch.arange(2 * 6 * 4 * 3, dtype=torch.float32).reshape(2, 6, 4, 3)
    img = tmesh.put(x, tmesh.image_sharding(mesh))
    assert img.shape == (2, 3)
    for (i, j), piece in np.ndenumerate(img):
        assert torch.equal(piece, x[i:i + 1, 2 * j:2 * j + 2])
    m = torch.zeros(2, 5, 6, 4)
    assert tmesh.put(m, tmesh.mask_sharding(mesh))[1, 2].shape == (1, 5, 2, 4)
    tree = {"a": x, "w": topt.LossWeights(1.0, torch.ones(2), 0.0, 0.0)}
    sharded = tmesh.shard_batch(tree, tmesh.make_mesh(devices=_cpu(2)))
    assert torch.equal(sharded["a"][1], x[1:])
    assert sharded["w"].content[0] == 1.0
    assert torch.equal(sharded["w"].style[1], torch.ones(1))
    rep = tmesh.replicate([x], tmesh.make_mesh(devices=_cpu(2)))
    assert all(torch.equal(p, x) for p in rep[0])
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.put(torch.zeros(3, 2), tmesh.batch_sharding(mesh))
    assert tmesh.current_mesh() is None
    with tmesh.use_mesh(mesh):
        assert tmesh.current_mesh() is mesh
    assert tmesh.current_mesh() is None


def test_params_by_device_packs_once(params):
    """Weights are packed once for a mesh and moved packed: a repeated
    device is packed once, a packed dict keeps its packed forms (no
    repacking on its own device), and `params_on` keeps it packed."""
    from dpst_tpu_torch.utils.runtime import params_on
    cpu = torch.device("cpu")
    packed = tvgg.params_by_device(params[1], _cpu(3), "bfloat16")
    assert list(packed) == [cpu]
    p = packed[cpu]
    assert isinstance(p, tvgg.PackedParams)
    assert p.key == (torch.bfloat16, False)
    assert p["conv2_1"]["wc"].dtype == torch.bfloat16
    again = tvgg.params_by_device(p, _cpu(2), "bfloat16")[cpu]
    moved = params_on(p, cpu)
    for q in (again, moved, tvgg.pack_params(moved, "bfloat16")):
        assert isinstance(q, tvgg.PackedParams) and q.key == p.key
        assert q["conv2_1"]["wc"] is p["conv2_1"]["wc"]
        assert all(a is b for a, b in zip(q.block12, p.block12))
    assert not isinstance(params_on(params[1], cpu), tvgg.PackedParams)


def test_interleave_takes_steps_in_turns():
    order = []

    def gen(name, n):
        for i in range(n):
            order.append((name, i))
            yield
        return name

    assert topt.interleave([gen("a", 2), gen("b", 3)]) == ["a", "b"]
    assert order == [("a", 0), ("b", 0), ("a", 1), ("b", 1), ("b", 2)]


@pytest.fixture(scope="module")
def tune_pair():
    r = np.random.default_rng(17)
    return (r.uniform(0, 255, (24, 24, 3)).astype(np.float32),
            r.uniform(0, 255, (24, 24, 3)).astype(np.float32))


def test_autotune_mesh_matches_jax(tune_pair, params):
    """autotune over a mesh of 2 (two candidates a device, s2d_gram "nd")
    against the JAX package's over its mesh of 2 (tests/
    test_autotune.py's pair and config)."""
    content, style = tune_pair
    jn = jnima.init_params(seed=0)
    tn = tnima.params_from_numpy(jax.tree.map(np.asarray, jn))
    gammas = (1.0, 10.0, 100.0, 1000.0)
    kw = dict(use_segmentation=False, use_photorealism=False,
              compute_dtype="float32", iterations=6)
    ref = jautotune(content, style, dpst_tpu.StylizeConfig(**kw),
                    gammas=gammas, vgg_params=params[0], nima_params=jn,
                    mesh=jmesh.make_mesh(2))
    got = dpst_tpu_torch.autotune(
        content, style, dpst_tpu_torch.StylizeConfig(**kw), gammas=gammas,
        vgg_params=params[1], nima_params=tn,
        mesh=tmesh.make_mesh(devices=_cpu(3)))     # shrinks to 2 of 3
    np.testing.assert_array_equal(got.gammas, np.asarray(ref.gammas))
    np.testing.assert_allclose(got.images, np.asarray(ref.images),
                               rtol=PIX_RTOL, atol=PIX_ATOL)
    ref_scores = np.asarray(ref.scores)
    np.testing.assert_allclose(got.scores, ref_scores, atol=BF16_SCORE_TOL)
    top = np.sort(ref_scores)
    if top[-1] - top[-2] > BF16_SCORE_TOL:
        assert got.best_gamma == float(ref.best_gamma)
    assert got.scores[list(got.gammas).index(got.best_gamma)] \
        == got.scores.max()
