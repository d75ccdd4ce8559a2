"""The port's automatic masks against the benchmark's plain references on
the CPU, with seeded weights: PSPNet-50's logits (`port_bench/reference/
pspnet.py`), the class merge (`reference/merge.py`), a whole
`stylize(use_segmentation=True)` against `reference/automatic.py`'s run, and
the counter record and spans that `segmentation` leaves.

PSPNet's weights are `reference.pspnet.weights`: He-normal with batch norm
folded to identity, the dict the benchmark hands the program. Under them the
logits reach |z| of 2e3-4e3 at these sizes."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from dpst_tpu_torch import StylizeConfig, semantic_merge, stylize
from dpst_tpu_torch import segmentation as tseg
from dpst_tpu_torch.config import PRESETS
from dpst_tpu_torch.models import pspnet as tpsp
from dpst_tpu_torch.utils import runtime
from port_bench import harness, inputs
from port_bench.reference import automatic, merge, precision
from port_bench.reference import pspnet as rpsp

# Relative to the reference's largest |logit|: both are float32 through
# about 55 convs that sum up to 4096·9 products, in other orders (cuDNN's
# or oneDNN's algorithms, an average pool against a sum and a division);
# they read 1.5e-6 apart at 64² and 97². bf16 operands would put them
# about 1e-2 apart.
LOGIT_TOL = 2e-5
EVAL = 64            # the resize protocol's size in the stylize tests
CONFIG = harness.load_cell(harness.load_spec(harness.HERE.parent),
                           "config3_pspnet.auto_2048")["config_file"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seg_params():
    return rpsp.weights(2 ** 31 + 3, "cpu")


@pytest.fixture
def small_eval(monkeypatch):
    monkeypatch.setattr(tpsp, "EVAL_SIZE", EVAL)


def photos(seed: int, size: int) -> tuple[np.ndarray, np.ndarray]:
    """A smooth content photo and a textured style photo, as the benchmark
    draws them."""
    gen = torch.Generator().manual_seed(seed)
    return (inputs.smooth_image(gen, "cpu", size).numpy(),
            inputs.textured_image(gen, "cpu", size).numpy())


def test_reference_layers_are_the_ports():
    """The weights the benchmark draws fit the port's dict: the same
    convs, names and shapes."""
    assert [(n, kh, cin, cout) for n, kh, kw, cin, cout in tpsp.CONV_SPECS
            ] == rpsp.layers()
    assert sum(k * k * cin * cout for _, k, cin, cout in rpsp.layers()
               ) == 46_723_776


@pytest.mark.parametrize("size", [64, 97])
def test_forward_logits_match_the_plain_reference(seg_params, size):
    gen = torch.Generator().manual_seed(size)
    x = torch.rand((2, size, size, 3), generator=gen) * 255.0
    got = tpsp.forward(seg_params, x, "float32").permute(0, 3, 1, 2)
    want = rpsp.logits(seg_params, x, precision.PLAIN)
    assert got.shape == want.shape == (2, 150, size, size)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= LOGIT_TOL * scale


def test_similarity_and_labels_are_the_ports():
    np.testing.assert_array_equal(
        merge.grouped_similarity(), semantic_merge.similarity_matrix("grouped"))
    assert merge.LABELS == tuple(
        lbl.split("|")[0] for lbl in semantic_merge.ADE20K_LABELS)


def _label_maps(seed: int, case: str) -> tuple[np.ndarray, np.ndarray]:
    """Two (48, 40) label maps drawn from class pools that make `case`."""
    rng = np.random.default_rng(seed)
    pools = {
        # both draw from one pool of a few classes
        "overlap": ([2, 4, 9, 12], [2, 4, 9, 12]),
        # one-sided classes: grass (9) and tree (4) share a group, water
        # (21) and sea (26) another; car (20) and person (12) shared alone
        "one_sided": ([4, 21, 12, 20, 2], [9, 26, 12, 20, 2, 7]),
        # nothing in common
        "disjoint": ([0, 1, 2], [3, 4, 5]),
        # 20 shared classes folded down to max_classes
        "fold": (list(range(20)), list(range(20))),
        # many classes, some one-sided, folded
        "fold_one_sided": (list(range(0, 48, 2)),
                           list(range(30)) + [100, 101]),
    }
    pc, ps = pools[case]
    # blocks of 4×4 pixels, so that classes have uneven areas
    cells = lambda pool: np.kron(
        rng.choice(pool, (12, 10), p=rng.dirichlet(np.ones(len(pool)))),
        np.ones((4, 4), np.int64))
    return cells(pc).astype(np.int32), cells(ps).astype(np.int32)


@pytest.mark.parametrize("max_classes", [1, 3, 8])
@pytest.mark.parametrize("case", ["overlap", "one_sided", "disjoint", "fold",
                                  "fold_one_sided"])
def test_merge_matches_the_plain_merge(case, max_classes):
    kept = []
    for seed in range(4):
        seg_c, seg_s = _label_maps(seed, case)
        got = semantic_merge.merge_classes(seg_c, seg_s, metric="grouped",
                                           threshold=0.25,
                                           max_classes=max_classes)
        want = merge.merge(seg_c, seg_s, 0.25, max_classes)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert list(got[2]) == want[2] and len(want[2]) <= max_classes
        kept.append(len(want[2]))
        for labels in want[:2]:
            np.testing.assert_array_equal(
                tseg.masks_from_labels(labels, got[2], max_classes),
                merge.one_hot(labels, want[2], max_classes))
    if case.startswith("fold"):
        assert kept == [max_classes] * 4   # every fold ran past max_classes


def test_automatic_masks_match_the_reference(seg_params, small_eval):
    """The port's masks (PSPNet, merge, one-hot) at 64², fp32, against the
    reference's at the same evaluation size: equal, since no pixel of these
    photos lies within the logits' rounding gap of a tie."""
    content, style = photos(11, 64)
    cfg = dataclasses.replace(PRESETS["config3"], compute_dtype="float32")
    config = dict(CONFIG, pspnet=dict(CONFIG["pspnet"], eval_size=EVAL))
    cm, sm, ids = tseg.automatic_masks(content, style, cfg, seg_params,
                                       device="cpu")
    rcm, rsm, rids = automatic.masks(config, seg_params, content, style,
                                     precision.PLAIN, "cpu")
    assert list(ids) == rids and cm.shape == (8, 64, 64)
    np.testing.assert_array_equal(cm, rcm)
    np.testing.assert_array_equal(sm, rsm)


def test_masks_made_on_the_device_equal_the_host_masks(seg_params,
                                                      small_eval):
    """`automatic_masks` makes its masks as float32 tensors on its device
    from the merged labels; they equal the reference's numpy one-hot
    stacks of those labels, zero-padding included."""
    content, style = photos(17, 48)
    cfg = StylizeConfig(compute_dtype="float32", max_classes=12)
    cm, sm, ids = tseg.automatic_masks(content, style, cfg, seg_params,
                                       device="cpu")
    assert isinstance(cm, torch.Tensor) and cm.dtype == torch.float32
    assert len(ids) < 12
    seg_c, seg_s = tseg.segment_images(content, style, seg_params,
                                       "float32", device="cpu")
    merged = merge.merge(seg_c, seg_s, cfg.similarity_threshold, 12)
    assert merged[2] == list(ids)
    np.testing.assert_array_equal(cm.numpy(),
                                  merge.one_hot(merged[0], merged[2], 12))
    np.testing.assert_array_equal(sm.numpy(),
                                  merge.one_hot(merged[1], merged[2], 12))


def test_stylize_automatic_matches_the_reference_run(seg_params, small_eval):
    """`stylize` with no masks and segmentation on, against the automatic
    reference's run on the same weights and photos, 4 Adam steps at 64² in
    float32: each term of each row within 1e-5 of the reference's largest
    (the photorealism term within 5e-3: the port's Laplacian is float32,
    the reference's float64, with Λ reaching 1e6), the image's change from
    the content within 1e-3 (pixels with a gradient near zero may take
    Adam's first, near-sign steps either way)."""
    steps = 4
    content, style = photos(12, 64)
    gen = torch.Generator().manual_seed(13)
    params = inputs.vgg_weights(CONFIG["vgg19_blocks"], gen, "cpu")
    config = dict(CONFIG, pspnet=dict(CONFIG["pspnet"], eval_size=EVAL),
                  stylize=dict(CONFIG["stylize"], iterations=steps,
                               compute_dtype="float32"))
    cfg = harness.stylize_config(config)
    seg = rpsp.weights(config["stylize"]["seed"], "cpu")
    image, hist = stylize(content, style, cfg, vgg_params=params,
                          seg_params=seg, return_history=True, device="cpu")
    rows, images = automatic.reference_run(
        config, params, [inputs.Pair(content, style, None, None)], steps,
        precision.PLAIN, 64, 0, "cpu")
    assert hist.shape == rows.shape[1:] == (steps, 5)
    scale = np.abs(rows[0]).max(axis=0)
    gap = np.abs(hist - rows[0]).max(axis=0) / np.maximum(scale, 1e-30)
    assert gap[0] < 1e-5 and gap[1] < 1e-5 and gap[2] < 1e-5
    assert gap[3] < 5e-3
    change = np.linalg.norm(image - content)
    ref_change = np.linalg.norm(images[0] - content)
    assert abs(change - ref_change) / ref_change < 1e-3
    assert tseg.last_call.classes >= 2     # the masks are not one class


def _check_record(rec, forwards: int, classes: int):
    assert rec.forwards == forwards and rec.eval_size == EVAL
    assert rec.classes == classes and rec.k == 8
    assert rec.segment_s > 0 and rec.merge_s > 0
    assert rec.forward_ms is None          # no CUDA events on the CPU


@pytest.mark.parametrize("batch", [False, True])
def test_record_without_a_profiler(seg_params, small_eval, batch):
    """Every automatic call leaves its record, with no profiler running:
    the images that went through PSPNet (a batch's contents and its style
    once), the merged classes (a batch's most), K after padding, and the
    stages' host seconds."""
    content, style = photos(14, 40)
    cfg = StylizeConfig(compute_dtype="float32")
    tseg.last_call = None
    if batch:
        contents = np.stack([content, style, content[::-1]])
        cm, _ = tseg.automatic_masks_batch(contents, style, cfg, seg_params,
                                           device="cpu")
        classes = max(int((m.reshape(8, -1).max(1) > 0).sum()) for m in cm)
        _check_record(tseg.last_call, 4, classes)
    else:
        _, _, ids = tseg.automatic_masks(content, style, cfg, seg_params,
                                         device="cpu")
        _check_record(tseg.last_call, 2, len(ids))


@pytest.mark.parametrize("batch", [False, True])
def test_spans_under_a_profiler(seg_params, small_eval, batch):
    content, style = photos(15, 40)
    cfg = StylizeConfig(compute_dtype="float32")
    with torch.profiler.profile() as prof:
        if batch:
            tseg.automatic_masks_batch(content[None], style, cfg, seg_params,
                                       device="cpu")
        else:
            tseg.automatic_masks(content, style, cfg, seg_params,
                                 device="cpu")
    names = [e.name for e in prof.events() if e.name.startswith("dpst::")]
    assert names.count("dpst::segment") == names.count("dpst::merge") == 1


def test_spans_in_a_profile_dir_trace(seg_params, small_eval, tmp_path):
    """`stylize(profile_dir=...)` (the CLI's `--profile-dir`) writes both
    ranges into its trace, the segmentation's before the precompute."""
    content, style = photos(16, 40)
    cfg = StylizeConfig(compute_dtype="float32", iterations=1,
                        profile_dir=str(tmp_path))
    stylize(content, style, cfg, seg_params=seg_params, device="cpu")
    (trace,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    start = {e["name"]: e["ts"] for e in events
             if e.get("name", "").startswith("dpst::")}
    assert start["dpst::segment"] < start["dpst::merge"] < start[
        "dpst::precompute"]


def test_clock_sees_every_forward(seg_params, small_eval):
    """An open `runtime.timer("pspnet")` counts the images of each
    forward: chunks of `segment_batch`, the sliding protocol's windows
    with their mirrors; with none open, nothing is counted."""
    imgs = torch.rand((3, 40, 40, 3)) * 255.0
    with runtime.timer("pspnet") as forwards:
        tpsp.segment_batch(seg_params, imgs, "float32", chunk=2)
    assert forwards.items == 3 and forwards.ms() is None
    with runtime.timer("pspnet") as forwards:
        tpsp.segment(seg_params, imgs[0], "float32", protocol="sliding",
                     base_size=80, crop_size=48)
    assert forwards.items == 8           # 2×2 windows and their mirrors
    tpsp.segment(seg_params, imgs[0], "float32")
    assert forwards.items == 8
