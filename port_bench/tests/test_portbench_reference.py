"""The plain reference: its Laplacian against the matrix written out from
Levin's definition, its walk over blocks of rows against one block, and
its history against the port's plain CPU path at 48 px."""
import numpy as np
import pytest
import torch

from conftest import run_small, small_cell
from port_bench import check, harness, inputs
from port_bench.reference import laplacian, objective, precision


def dense_laplacian(img: np.ndarray, eps: float) -> np.ndarray:
    """L from its definition, window by window, in float64."""
    h, w, _ = img.shape
    n = h * w
    lap = np.zeros((n, n))
    idx = np.arange(n).reshape(h, w)
    for cy in range(1, h - 1):
        for cx in range(1, w - 1):
            win = idx[cy - 1:cy + 2, cx - 1:cx + 2].ravel()
            pix = img[cy - 1:cy + 2, cx - 1:cx + 2].reshape(9, 3)
            mu = pix.mean(0)
            d = pix - mu
            cov = d.T @ d / 9
            lam = np.linalg.inv(cov + eps / 9 * np.eye(3))
            lap[np.ix_(win, win)] += np.eye(9) - (1 + d @ lam @ d.T) / 9
    return lap


def test_laplacian_matvec_against_its_definition():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (6, 7, 3))
    v = rng.normal(size=(6, 7))
    st = laplacian.stats(torch.from_numpy(img), 1e-5)
    got = laplacian.matvec(st, torch.from_numpy(v)).numpy().ravel()
    want = dense_laplacian(img / 255.0, 1e-5) @ v.ravel()
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())
    value, grad = laplacian.photoreal(st, torch.from_numpy(
        np.repeat(v[..., None], 3, -1) * 255.0).float())
    assert grad.dtype == torch.float32


def test_blocks_of_rows_agree_with_one_block():
    """At 320² in blocks of 64 rows with config6's halo of 96, some block
    runs on rows cut on both sides; every block's own rows see none of the
    cuts (VGG's reach to conv5_1 is 85 rows). The widths are narrowed to
    keep the test short: the walk does not depend on them."""
    cell = harness.load_cell(harness.load_spec(harness.HERE.parent),
                             "config6.single_4096")
    size, halo = 320, cell["check_file"]["halo"]
    blocks = [[n, 8] for n, _ in cell["config_file"]["vgg19_blocks"]]
    config = dict(cell["config_file"], vgg19_blocks=blocks)
    traffic = dict(cell["traffic_file"], size=size, pool_requests=1)
    cut = [b for b in objective._blocks(size, 64, halo)
           if b[2] > 0 and b[3] < size]
    assert cut, "no block is cut on both sides"
    gen = torch.Generator().manual_seed(11)
    params = inputs.vgg_weights(blocks, gen, "cpu")
    pair = [torch.from_numpy(a) for a in inputs.make_pairs(traffic, gen,
                                                           "cpu")[0]]
    obj = objective.Objective.from_config(config)
    image = pair[0] + torch.empty_like(pair[0]).uniform_(
        -20, 20, generator=gen)
    out = []
    for rows, h in ((size, 0), (64, halo)):
        p = objective.Pair(obj, params, *pair, precision.PLAIN, rows, h)
        out.append(p.loss_and_grad(image.clamp(0, 255)))
    (t1, g1), (t2, g2) = out
    np.testing.assert_allclose(t2, t1, rtol=1e-6)
    assert float((g2 - g1).abs().max() / g1.abs().max()) < 1e-5


@pytest.mark.parametrize("cell", ["config3.batch8_512",
                                  "config6.single_4096"])
def test_reference_against_the_port_on_the_cpu(cell):
    """The port's plain CPU path in float32 against the reference: the
    terms of the first rows agree to float32 rounding (the photorealism
    term to the port's float32 Laplacian, Λ reaching 1e6), and so do the
    images' changes, to the pixels whose gradient is near enough to zero
    that Adam's first, near sign steps may take them either way."""
    c = small_cell(cell, steps=6, dtype="float32")
    c["traffic_file"].update(stamp_every=3, trace_from=3, trace_steps=3)
    c["check_file"]["limits"] = {name: 1.0 for name in check.NUMBERS}
    result = run_small(c)
    values = {k: v["value"] for k, v in result["check"].items()}
    assert values["total_gap"] < 1e-5
    assert values["style_gap"] < 1e-5
    assert values["content_gap"] < 1e-3
    assert values["photoreal_gap"] < 5e-3
    assert values["change_gap"] < 1e-3
