"""The port's automatic segmentation against dpst_tpu on the CPU: PSPNet-50
(its taps at an odd and an even size, both inference protocols, the
batched form), the class merge, the mask stacks, and the automatic
`stylize`. JAX's PSPNet parameters are built once and carried across with
`models.pspnet.params_from_numpy`; inputs come from numpy seeds.

Label maps are held by the near-tie rule: the port's class scores within a
stated tolerance of the reference's, and its labels equal the reference's
at every pixel whose reference top-2 margin is at least twice the largest
score difference measured. Under the seeded He init (BN folded to
identity) the logits reach |z| of about 3e3, so fp32 rounding alone moves
them by a few 1e-3, and near-tied softmax probabilities by up to half
that."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpst_tpu
from dpst_tpu import segmentation as jseg
from dpst_tpu import semantic_merge as jsm
from dpst_tpu.models import pspnet as jpsp
from dpst_tpu.ops.metrics import ssim
import dpst_tpu_torch
from dpst_tpu_torch import segmentation as tseg
from dpst_tpu_torch import semantic_merge as tsm
from dpst_tpu_torch.models import pspnet as tpsp
from dpst_tpu_torch.models import vgg as tvgg

TAP_TOL = 1e-4       # relative to the tap's max|.|, fp32
PROB_TOL = 1e-3      # absolute, softmax probabilities of the sliding protocol
EVAL = 64            # EVAL_SIZE of the resize protocol in these tests


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def psp():
    """JAX's seed-0 PSPNet parameters (numpy) and the port's copy."""
    jp = jax.tree.map(np.asarray, jpsp.init_params(0))
    return jp, tpsp.params_from_numpy(jp)


@pytest.fixture
def small_eval(monkeypatch):
    monkeypatch.setattr(jpsp, "EVAL_SIZE", EVAL)
    monkeypatch.setattr(tpsp, "EVAL_SIZE", EVAL)


def _hold_labels(labels: np.ndarray, got: np.ndarray, ref: np.ndarray,
                 tol: float) -> None:
    """labels (H, W), the argmax of the port's scores `got` (H, W, C),
    against the reference's scores `ref`: max|got - ref| <= tol, and the
    labels equal ref's argmax wherever ref's top-2 margin is at least
    twice that difference."""
    np.testing.assert_array_equal(labels, got.argmax(-1))
    diff = float(np.abs(got - ref).max())
    assert diff <= tol, f"scores differ by {diff} > {tol}"
    top2 = np.sort(ref, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    differ = labels != ref.argmax(-1)
    assert not (differ & (margin >= 2 * diff)).any(), (
        f"{int(differ.sum())} labels differ, margins "
        f"{margin[differ].tolist()[:8]} (score difference {diff})")


def test_same_pads_follow_xla():
    # 473: symmetric everywhere; 64: the stride-2 stem pads (0, 1)
    assert tpsp.same_pads(473, 3, 2) == (1, 1)
    assert tpsp.same_pads(64, 3, 2) == (0, 1)
    assert tpsp.same_pads(33, 3, 1, 4) == (4, 4)
    assert tpsp.same_pads(64, 1, 2) == (0, 0)
    assert tpsp.same_pads(25, 1, 2) == (0, 0)


@pytest.mark.parametrize("size", [97, 64])
def test_forward_taps_match_jax(psp, size):
    """Every stage's activation and the logits, fp32, within TAP_TOL of
    max|tap| (97: every SAME pad symmetric; 64: the stride-2 stem, pool,
    res3_0_b pad (0, 1), and the PPM's bin-3 windows leave a row)."""
    img = np.random.default_rng(size).uniform(
        0, 255, (1, size, size, 3)).astype(np.float32)
    ref, ref_taps = jpsp.forward(psp[0], img, "float32", return_taps=True)
    got, taps = tpsp.forward(psp[1], torch.from_numpy(img), "float32",
                             return_taps=True)
    pairs = [(k, np.asarray(ref_taps[k]),
              taps[k].permute(0, 2, 3, 1).numpy()) for k in ref_taps]
    pairs.append(("out", np.asarray(ref), got.numpy()))
    assert {k for k, *_ in pairs} == {"stem", "res2", "res3", "res4",
                                      "res5", "ppm", "fuse", "logits", "out"}
    for name, a, b in pairs:
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err = np.abs(a - b).max() / np.abs(a).max()
        assert err <= TAP_TOL, f"{name}: rel err {err:.2e}"


def _resize_scores(psp, img):
    """Both packages' resize protocol up to the argmax (dpst_tpu/models/
    pspnet.py:segment): the (H, W, 150) scores whose argmax are the
    labels, and the tolerance of the port's."""
    h, w = img.shape[:2]
    x = jax.image.resize(jnp.asarray(img), (EVAL, EVAL, 3), "bilinear")
    logits = jpsp.forward(psp[0], x[None], "float32")[0]
    ref = np.asarray(jax.image.resize(logits, (h, w, 150), "bilinear"))
    xt = tpsp.resize_image(torch.from_numpy(img), (EVAL, EVAL))
    got = tpsp._bilinear(tpsp._forward(psp[1], xt[None], "float32"), (h, w),
                         antialias=True)[0].permute(1, 2, 0).numpy()
    return got, ref, TAP_TOL * float(np.abs(ref).max())


def test_segment_resize_protocol(psp, small_eval):
    img = np.random.default_rng(3).uniform(
        0, 255, (48, 56, 3)).astype(np.float32)
    got, ref, tol = _resize_scores(psp, img)
    np.testing.assert_array_equal(
        ref.argmax(-1), np.asarray(jpsp.segment(psp[0], img, "float32")))
    labels = tpsp.segment(psp[1], img, "float32")
    assert labels.dtype == torch.int32 and labels.shape == (48, 56)
    _hold_labels(labels.numpy(), got, ref, tol)


def test_segment_sliding_protocol(psp):
    """The sliding protocol at crop 89 (a 12² feature grid), base 96, two
    scales, on a non-square image: each scale's `_scale_process`
    probabilities within PROB_TOL, then the labels of the summed
    probabilities."""
    img = np.random.default_rng(7).uniform(
        0, 255, (110, 74, 3)).astype(np.float32)
    h, w = img.shape[:2]
    base, scales = 96, (0.75, 1.0)
    ref = np.zeros((h, w, 150), np.float32)
    got = torch.zeros((1, 150, h, w))
    planes = torch.from_numpy(img).permute(2, 0, 1)[None]
    for scale in scales:
        long_size = int(round(scale * base))
        nh, nw = long_size, max(1, int(round(long_size / h * w)))
        scaled = jax.image.resize(jnp.asarray(img), (nh, nw, 3), "linear",
                                  antialias=False)
        probs = jpsp._scale_process(psp[0], scaled, "float32", True, 89)
        ref += np.asarray(jax.image.resize(probs, (h, w, 150), "linear",
                                           antialias=False))
        scaled_t = tpsp._bilinear(planes, (nh, nw), antialias=False)
        np.testing.assert_allclose(scaled_t[0].permute(1, 2, 0).numpy(),
                                   np.asarray(scaled), atol=1e-3)
        probs_t = tpsp._scale_process(psp[1], scaled_t[0].permute(1, 2, 0),
                                      "float32", True, 89)
        np.testing.assert_allclose(probs_t.permute(1, 2, 0).numpy(),
                                   np.asarray(probs), atol=PROB_TOL)
        got = got + tpsp._bilinear(probs_t[None], (h, w), antialias=False)
    np.testing.assert_array_equal(ref.argmax(-1), np.asarray(jpsp.segment(
        psp[0], img, "float32", protocol="sliding", base_size=base,
        scales=scales, crop_size=89)))
    labels = tpsp.segment(psp[1], img, "float32", protocol="sliding",
                          base_size=base, scales=scales, crop_size=89)
    _hold_labels(labels.numpy(), got[0].permute(1, 2, 0).numpy(), ref,
                 2 * PROB_TOL)
    with pytest.raises(ValueError, match="protocol"):
        tpsp.segment(psp[1], img, "float32", protocol="tiles")


def test_segment_batch_equals_segment(psp, small_eval):
    r = np.random.default_rng(11)
    imgs = r.uniform(0, 255, (3, 40, 44, 3)).astype(np.float32)
    batch = tpsp.segment_batch(psp[1], imgs, "float32", chunk=2)
    assert batch.shape == (3, 40, 44) and batch.dtype == torch.int32
    for i in range(3):
        np.testing.assert_array_equal(
            batch[i].numpy(), tpsp.segment(psp[1], imgs[i], "float32").numpy())


def _label_maps(seed: int, n_c: int, n_s: int, shared: int):
    """Two (40, 36) label maps drawing from n_c and n_s classes of which
    `shared` are common, in patches of uneven area."""
    r = np.random.default_rng(seed)
    ids = r.permutation(150)
    c_ids = ids[:n_c]
    s_ids = np.concatenate([ids[:shared], ids[n_c:n_c + n_s - shared]])
    maps = []
    for pool in (c_ids, s_ids):
        coarse = r.choice(pool, size=(10, 9), p=r.dirichlet(
            np.ones(len(pool))))
        maps.append(np.kron(coarse, np.ones((4, 4), np.int64)))
    return maps


MERGE_CASES = [(0, 5, 4, 3, 8), (1, 14, 12, 9, 8), (2, 4, 4, 0, 8),
               (3, 20, 20, 20, 4), (4, 9, 6, 2, 3), (5, 1, 3, 1, 8)]


@pytest.mark.parametrize("metric", ["grouped", "token", "combined"])
@pytest.mark.parametrize("case", MERGE_CASES)
def test_merge_classes_matches_jax(metric, case):
    """Exact: merged maps and class ids, for shared, disjoint and
    over-`max_classes` label sets under every built-in metric."""
    seed, n_c, n_s, shared, k = case
    seg_c, seg_s = _label_maps(seed, n_c, n_s, shared)
    for thr in (0.25, 0.9):
        ref = jsm.merge_classes(seg_c, seg_s, metric, thr, k)
        got = tsm.merge_classes(seg_c, seg_s, metric, thr, k)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2] and len(got[2]) <= k
    np.testing.assert_array_equal(tsm._builtin_matrix(metric),
                                  jsm._builtin_matrix(metric))


def test_merge_classes_external_matrix(tmp_path, monkeypatch):
    """An asset given through $DPST_SIMILARITY_MATRIX (cosines in [-1, 1],
    normalized on load) takes precedence in both packages; a bad one
    raises in both."""
    r = np.random.default_rng(9)
    a = r.uniform(-1, 1, (150, 150)).astype(np.float32)
    path = tmp_path / "similarity_matrix.npz"
    np.savez(path, similarity=(a + a.T) / 2)
    monkeypatch.setenv("DPST_SIMILARITY_MATRIX", str(path))
    for metric in ("embedding", "grouped"):
        np.testing.assert_array_equal(tsm.similarity_matrix(metric),
                                      jsm.similarity_matrix(metric))
        for case in MERGE_CASES[:4]:
            seg_c, seg_s = _label_maps(*case[:4])
            ref = jsm.merge_classes(seg_c, seg_s, metric, 0.6, case[4])
            got = tsm.merge_classes(seg_c, seg_s, metric, 0.6, case[4])
            np.testing.assert_array_equal(got[0], ref[0])
            np.testing.assert_array_equal(got[1], ref[1])
            assert got[2] == ref[2]
    bad = tmp_path / "bad.npz"
    np.savez(bad, similarity=a)                      # not symmetric
    monkeypatch.setenv("DPST_SIMILARITY_MATRIX", str(bad))
    with pytest.raises(ValueError, match="symmetric"):
        tsm.similarity_matrix("grouped")
    monkeypatch.setenv("DPST_SIMILARITY_MATRIX", str(tmp_path / "none.npz"))
    with pytest.raises(FileNotFoundError):
        tsm.similarity_matrix("embedding")


def test_masks_exact_given_equal_labels(monkeypatch):
    """masks_from_labels and automatic_masks equal the reference's exactly
    when both packages see the same label maps."""
    seg_c, seg_s = _label_maps(1, 14, 12, 9)
    seg_c, seg_s = seg_c.astype(np.int32), seg_s.astype(np.int32)
    ids = [int(i) for i in np.unique(seg_c)[:5]]
    np.testing.assert_array_equal(tseg.masks_from_labels(seg_c, ids, 8),
                                  jseg.masks_from_labels(seg_c, ids, 8))
    with pytest.raises(ValueError, match="max_classes"):
        tseg.masks_from_labels(seg_c, ids, 4)
    monkeypatch.setattr(jseg, "segment_images",
                        lambda *a, **k: (seg_c, seg_s))
    monkeypatch.setattr(tseg, "segment_images",
                        lambda *a, **k: (seg_c, seg_s))
    img = np.zeros((40, 36, 3), np.float32)
    for k in (8, 3):
        ref = jseg.automatic_masks(img, img, dpst_tpu.StylizeConfig(
            max_classes=k), None)
        got = tseg.automatic_masks(img, img, dpst_tpu_torch.StylizeConfig(
            max_classes=k), None, device="cpu")
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2]
        np.testing.assert_array_equal(got[0].sum(0), 1.0)


def test_automatic_masks_batch_matches_pairs(psp, small_eval):
    r = np.random.default_rng(12)
    contents = r.uniform(0, 255, (2, 40, 44, 3)).astype(np.float32)
    style = r.uniform(0, 255, (40, 44, 3)).astype(np.float32)
    cfg = dpst_tpu_torch.StylizeConfig(max_classes=4,
                                       compute_dtype="float32")
    cm, sm = tseg.automatic_masks_batch(contents, style, cfg, psp[1],
                                        device="cpu")
    assert cm.shape == sm.shape == (2, 4, 40, 44)
    for i, c in enumerate(contents):
        mc, ms, _ = tseg.automatic_masks(c, style, cfg, psp[1],
                                         device="cpu")
        np.testing.assert_array_equal(cm[i], mc)
        np.testing.assert_array_equal(sm[i], ms)


def test_stylize_automatic_matches_jax(psp, small_eval):
    """stylize(use_segmentation=True) with no masks at 48 px, both packages
    on the same VGG and PSPNet weights: the same label maps (near-tie
    rule), then the goldens' bounds (SSIM >= 0.98, loss rtol 5e-3)."""
    r = np.random.default_rng(4321)
    content = r.uniform(0, 255, (48, 48, 3)).astype(np.float32)
    style = r.uniform(0, 255, (48, 48, 3)).astype(np.float32)
    kw = dict(use_segmentation=True, use_photorealism=True,
              laplacian_impl="xla", compute_dtype="float32", iterations=40,
              max_classes=8, regularization_weight=100.0)
    for img in (content, style):
        _hold_labels(tpsp.segment(psp[1], img, "float32").numpy(),
                     *_resize_scores(psp, img))
    r = np.random.default_rng(0)
    jv = {name: {"w": r.standard_normal((3, 3, cin, cout), np.float32)
                 * np.float32(np.sqrt(2.0 / (9 * cin))),
                 "b": np.zeros(cout, np.float32)}
          for name, (cin, cout) in tvgg.CONV_SHAPES.items()}
    tv = tvgg.params_from_numpy(jv)
    ref, ref_hist = dpst_tpu.stylize(
        content, style, dpst_tpu.StylizeConfig(**kw), vgg_params=jv,
        seg_params=psp[0], return_history=True)
    got, hist = dpst_tpu_torch.stylize(
        content, style, dpst_tpu_torch.StylizeConfig(**kw), vgg_params=tv,
        seg_params=psp[1], return_history=True, device="cpu")
    assert float(ssim(got, np.asarray(ref))) >= 0.98
    np.testing.assert_allclose(hist[:, 0], ref_hist[:, 0], rtol=5e-3)
    assert hist[-1, 0] < hist[0, 0]
