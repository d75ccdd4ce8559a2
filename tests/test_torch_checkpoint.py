"""Checkpoint/resume, profiling and NaN checks of the port
(`dpst_tpu_torch/utils/checkpoint.py`, `utils/runtime.py`, through
`stylize`): a resumed run equals the straight run bit for bit, for Adam
and L-BFGS, single-stage and multi-scale (modelled on tests/test_cli.py's
resume tests of the JAX package)."""
import os

import numpy as np
import pytest
import torch

import dpst_tpu_torch
from dpst_tpu_torch.models import vgg
from dpst_tpu_torch.utils.checkpoint import RunCheckpointer

BASE = dict(use_segmentation=False, use_photorealism=True,
            laplacian_impl="xla", compute_dtype="float32",
            regularization_weight=100.0, intermediate_interval=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    r = np.random.default_rng(17)
    content = r.uniform(0, 255, (32, 32, 3)).astype(np.float32)
    style = r.uniform(0, 255, (32, 32, 3)).astype(np.float32)
    return content, style, vgg.init_params(0)


def _stylize(pair, resume=False, **kw):
    content, style, params = pair
    cfg = dpst_tpu_torch.StylizeConfig(**dict(BASE, **kw))
    return dpst_tpu_torch.stylize(content, style, cfg, vgg_params=params,
                                  return_history=True, resume=resume,
                                  device="cpu")


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_resume_equals_straight_run(pair, tmp_path, optimizer):
    """4 steps, then resume to 8 ≡ 8 straight steps at the same
    checkpoint interval: the image and the rows of steps 5-8 bit for bit
    (the restored state carries Adam's count and moments, or L-BFGS's
    memory and its linesearch's cached value and gradient)."""
    straight, hist = _stylize(pair, optimizer=optimizer, iterations=8,
                              checkpoint_dir=str(tmp_path / "straight"))
    ckpt = str(tmp_path / "ckpt")
    _stylize(pair, optimizer=optimizer, iterations=4, checkpoint_dir=ckpt)
    assert RunCheckpointer(ckpt).latest_step() == 4
    resumed, rhist = _stylize(pair, resume=True, optimizer=optimizer,
                              iterations=8, checkpoint_dir=ckpt)
    assert rhist.shape == (4, 5)
    np.testing.assert_array_equal(rhist, hist[4:])
    np.testing.assert_array_equal(resumed, straight)
    # max_to_keep = 3 of the checkpoints at steps 2, 4, 6 and 8
    assert sorted(os.listdir(ckpt)) == ["step_4.pt", "step_6.pt",
                                        "step_8.pt"]
    # a finished run resumes to no new step and the same image
    again, ahist = _stylize(pair, resume=True, optimizer=optimizer,
                            iterations=8, checkpoint_dir=ckpt)
    assert ahist.shape == (0, 5)
    np.testing.assert_array_equal(again, straight)


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_multiscale_resume_per_stage(pair, tmp_path, optimizer):
    """scales=(16, 32): one checkpoint directory a stage
    (`stage{i}_{h}x{w}`); a run stopped inside the second stage resumes
    there, the first stage restoring its finished state, and ends on the
    straight run's image and rows bit for bit."""
    kw = dict(optimizer=optimizer, scales=(16, 32))
    straight, hist = _stylize(pair, scale_iters=(4, 6),
                              checkpoint_dir=str(tmp_path / "straight"),
                              **kw)
    ckpt = tmp_path / "ckpt"
    _stylize(pair, scale_iters=(4, 2), checkpoint_dir=str(ckpt), **kw)
    assert sorted(os.listdir(ckpt)) == ["stage0_16x16", "stage1_32x32"]
    assert RunCheckpointer(str(ckpt / "stage1_32x32")).latest_step() == 2
    resumed, rhist = _stylize(pair, resume=True, scale_iters=(4, 6),
                              checkpoint_dir=str(ckpt), **kw)
    assert rhist.shape == (4, 5)
    np.testing.assert_array_equal(rhist, hist[6:])
    np.testing.assert_array_equal(resumed, straight)


def test_restore_keeps_types_and_refuses_other_shapes(tmp_path):
    from dpst_tpu_torch import optim
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    opt = optim.lbfgs()
    st = opt.init(x)
    ck = RunCheckpointer(str(tmp_path))
    assert ck.restore(x, st) is None
    ck.save(3, x + 1, st)
    step, img, got = ck.restore(torch.zeros_like(x), st)
    assert step == 3 and torch.equal(img, x + 1)
    assert type(got[2].value) is np.float32 and np.isinf(got[2].value)
    assert type(got[0].count) is int
    assert torch.equal(got[0].diff_params_memory, st[0].diff_params_memory)
    with pytest.raises(ValueError):
        ck.restore(torch.zeros(3, 2), opt.init(torch.zeros(3, 2)))


def test_profile_dir_writes_a_trace(pair, tmp_path):
    prof = tmp_path / "prof"
    out, hist = _stylize(pair, iterations=1, profile_dir=str(prof))
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1 and os.path.getsize(prof / traces[0]) > 0
    assert hist.shape == (1, 5) and np.isfinite(out).all()


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_debug_nans(pair, optimizer):
    """debug_nans raises FloatingPointError, naming the step, at a NaN
    input; on a finite one it stays silent and changes nothing."""
    content, style, params = pair
    cfg = dpst_tpu_torch.StylizeConfig(**dict(
        BASE, optimizer=optimizer, iterations=2, debug_nans=True))
    bad = content.copy()
    bad[3, 4, 1] = np.nan
    with pytest.raises(FloatingPointError, match="step 0"):
        dpst_tpu_torch.stylize(bad, style, cfg, vgg_params=params,
                               device="cpu")
    checked, h1 = _stylize(pair, optimizer=optimizer, iterations=2,
                           debug_nans=True)
    plain, h2 = _stylize(pair, optimizer=optimizer, iterations=2)
    np.testing.assert_array_equal(checked, plain)
    np.testing.assert_array_equal(h1, h2)
