"""The port's CLI (`python -m dpst_tpu_torch`) against the JAX package's
(`dpst_tpu.cli`): the same flags and the same StylizeConfig from the same
argv; the counterparts of tests/test_cli.py run in-process with `--device
cpu` (the plain PyTorch path, as JAX_PLATFORMS=cpu runs the JAX CLI there)
at 24-32 px in fp32; one subprocess of `python -m dpst_tpu_torch`; and
both CLIs end to end on one argv and one VGG bundle.

Tolerances: the loss CSVs of the two CLIs column by column within rtol
1e-3, with a floor of 1e-3 of the column's largest value (as
tests/test_torch_stylize.py holds the two packages' histories: fp32 sums
in other orders, and the photoreal term starts near 0); their images at
the goldens' SSIM >= 0.98. The row-sharded CLI run against the unsharded
one within 3.0 of [0, 255], as tests/test_cli.py holds the JAX CLI's."""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dpst_tpu import cli as jcli
from dpst_tpu.models import vgg as jvgg
from dpst_tpu_torch import cli as tcli
from dpst_tpu_torch.ops import metrics as tmetrics
from dpst_tpu_torch.utils import io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
SMALL = ["--no-segmentation", "--no-photorealism", "--dtype", "float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    r = np.random.default_rng(9)
    c, s = str(d / "content.png"), str(d / "style.png")
    io.save_image(r.uniform(0, 255, (32, 32, 3)), c)
    io.save_image(r.uniform(0, 255, (32, 32, 3)), s)
    return c, s, d


def _pair(image_files, size=32):
    c, s, _ = image_files
    return ["--content", c, "--style", s, "--size", str(size)]


# --- the flags and the config ---------------------------------------------

def _actions(parser) -> dict:
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_has_the_jax_clis_flags():
    """Every action of dpst_tpu.cli.build_parser(): the same option
    strings, default, choices, type, nargs, required flag and kind.
    --device is the one difference: it also takes "cpu"."""
    ref, got = _actions(jcli.build_parser()), _actions(tcli.build_parser())
    assert sorted(got) == sorted(ref)
    for dest, a in ref.items():
        b = got[dest]
        assert b.option_strings == a.option_strings, dest
        assert type(b) is type(a), dest
        for attr in ("default", "choices", "nargs", "required", "const",
                     "metavar"):
            assert getattr(b, attr) == getattr(a, attr), (dest, attr)
        if dest != "device":
            assert b.type is a.type, dest
    p = tcli.build_parser()
    assert p.prog == "dpst_tpu_torch"
    base = ["--content", "c", "--style", "s"]
    assert p.parse_args(base + ["--device", "cpu"]).device == "cpu"
    assert p.parse_args(base + ["--device", "3"]).device == 3
    with pytest.raises(SystemExit):
        p.parse_args(base + ["--device", "gpu"])


ARGVS = [
    [],
    ["--preset", "config1"], ["--preset", "config2"],
    ["--preset", "config3"], ["--preset", "config4"],
    ["--preset", "config5"],
    # a flag passed explicitly at its parser default still overrides
    ["--preset", "config1", "--dtype", "bfloat16"],
    ["--preset", "config3", "--iterations", "7", "--lr", "1.5"],
    ["--scales", "256", "512"], ["--seg-scales", "0.75", "1.0", "1.25"],
    ["--no-segmentation"], ["--no-photorealism"],
    ["--checkpoint-dir", "ck"], ["--debug-nans"],
    ["--preset", "config4", "--scales", "128", "--seg-scales", "1.0",
     "--no-segmentation", "--no-photorealism", "--checkpoint-dir", "ck",
     "--profile-dir", "pr", "--debug-nans"],
    ["--optimizer", "lbfgs", "--history-terms", "full", "--post-smooth",
     "2", "--laplacian-impl", "pallas", "--conv-impl", "pallas",
     "--gram-impl", "stream", "--stream12", "8", "--s2d-gram", "pallas",
     "--block1-impl", "s2d", "--pooling", "avg", "--remat", "block12",
     "--init", "style_mean", "--similarity-metric", "combined",
     "--seg-protocol", "sliding", "--max-classes", "5"],
]


@pytest.mark.parametrize("extra", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_config_equals_the_jax_clis(extra):
    """config_from_args gives the JAX CLI's StylizeConfig field by field
    (all 52 fields), from argv and, for a preset, from parsed flags alone
    (the programmatic path)."""
    argv = ["--content", "c.png", "--style", "s.png"] + extra
    ref = jcli.config_from_args(jcli.build_parser().parse_args(argv), argv)
    got = tcli.config_from_args(tcli.build_parser().parse_args(argv), argv)
    assert len(dataclasses.fields(got)) == len(dataclasses.fields(ref)) == 52
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    ref = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    got = tcli.config_from_args(tcli.build_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


# --- the CLI's behaviour, in-process on the CPU -----------------------------

def test_cli_basic(image_files, capsys):
    out = str(image_files[2] / "out.png")
    assert tcli.main(_pair(image_files) + ["--output", out,
                                           "--iterations", "5"]
                     + SMALL + CPU) == 0
    assert "final losses" in capsys.readouterr().out
    assert io.load_image(out).shape == (32, 32, 3)


def test_cli_intermediates_and_csv(image_files, tmp_path, capsys):
    inter, csv = str(tmp_path / "inter"), str(tmp_path / "loss.csv")
    assert tcli.main(_pair(image_files) + [
        "--output", str(tmp_path / "o.png"), "--iterations", "6",
        "--intermediate-interval", "3", "--intermediate-dir", inter,
        "--loss-csv", csv] + SMALL + CPU) == 0
    assert sorted(os.listdir(inter)) == ["iter_00003.png", "iter_00006.png"]
    assert np.loadtxt(csv, delimiter=",", skiprows=1).shape == (6, 5)
    out = capsys.readouterr().out
    assert "  step 3: total=" in out and f"wrote {csv}" in out


def test_cli_multiscale_intermediates_no_collision(image_files, tmp_path):
    """A global step count: stage 2 never overwrites stage 1's files."""
    inter = str(tmp_path / "inter_ms")
    assert tcli.main(_pair(image_files) + [
        "--output", str(tmp_path / "ms.png"), "--iterations", "4",
        "--scales", "16", "32", "--intermediate-interval", "2",
        "--intermediate-dir", inter] + SMALL + CPU) == 0
    assert sorted(os.listdir(inter)) == [
        "iter_00002.png", "iter_00004.png", "iter_00006.png",
        "iter_00008.png"]
    assert io.load_image(os.path.join(inter, "iter_00002.png")).shape == (
        16, 16, 3)
    assert io.load_image(os.path.join(inter, "iter_00008.png")).shape == (
        32, 32, 3)


@pytest.mark.parametrize("segmentation", [False, True])
def test_cli_content_dir(image_files, tmp_path, capsys, segmentation):
    """A directory as one batch (stylize_batch); with segmentation its
    masks come from automatic_masks_batch (one PSPNet forward for the
    contents, one for the style)."""
    r = np.random.default_rng(77)
    src = tmp_path / "src"
    src.mkdir()
    n = 2 if segmentation else 3
    for i in range(n):
        io.save_image(r.uniform(0, 255, (24, 24, 3)), str(src / f"img{i}.png"))
    outdir = str(tmp_path / "out")
    seg = ["--max-classes", "4"] if segmentation else ["--no-segmentation"]
    assert tcli.main(["--content-dir", str(src), "--style",
                      image_files[1], "--output", outdir, "--size", "24",
                      "--iterations", "2", "--no-photorealism", "--dtype",
                      "float32", "--metrics"] + seg + CPU) == 0
    assert sorted(os.listdir(outdir)) == [f"img{i}.png" for i in range(n)]
    out = capsys.readouterr().out
    assert f"stylized {n} images" in out and out.count("SSIM=") == n


def test_cli_spatial_matches_unsharded(image_files, tmp_path, capsys):
    """--spatial 2 on a mesh of two CPU devices against the unsharded
    run (photorealism on, the plain Laplacian)."""
    common = _pair(image_files) + ["--iterations", "4", "--no-segmentation",
                                   "--laplacian-impl", "xla", "--dtype",
                                   "float32"] + CPU
    sp, ref = str(tmp_path / "sp.png"), str(tmp_path / "ref.png")
    assert tcli.main(common + ["--output", sp, "--spatial", "2",
                               "--metrics"]) == 0
    out = capsys.readouterr().out
    assert "2-way row-sharded" in out and "SSIM=" in out
    assert tcli.main(common + ["--output", ref]) == 0
    np.testing.assert_allclose(io.load_image(sp), io.load_image(ref),
                               atol=3.0)


def test_cli_lbfgs_history_terms(image_files, tmp_path, capsys):
    """L-BFGS logs totals only by default; --history-terms full gives the
    per-term line."""
    common = _pair(image_files) + ["--output", str(tmp_path / "lb.png"),
                                   "--iterations", "3", "--optimizer",
                                   "lbfgs"] + SMALL + CPU
    assert tcli.main(common) == 0
    assert "per-term history off" in capsys.readouterr().out
    assert tcli.main(common + ["--history-terms", "full"]) == 0
    out = capsys.readouterr().out
    assert "final losses" in out and "content=" in out


def test_cli_metrics_flag(image_files, tmp_path, capsys):
    assert tcli.main(_pair(image_files) + [
        "--output", str(tmp_path / "m.png"), "--iterations", "3",
        "--metrics"] + SMALL + CPU) == 0
    line = [x for x in capsys.readouterr().out.splitlines()
            if "SSIM=" in x][0]
    assert "PSNR=" in line
    assert -1.0 <= float(line.split("SSIM=")[1].split()[0]) <= 1.0


def test_cli_resume_equals_straight_run(image_files, tmp_path):
    """4 steps, then --resume to 8, equals 8 straight steps (the
    checkpoint holds the image and Adam's state)."""
    ck = str(tmp_path / "ck")
    common = _pair(image_files) + ["--intermediate-interval", "4"] + SMALL \
        + CPU
    paths = {k: str(tmp_path / f"{k}.png") for k in ("straight", "resumed")}
    assert tcli.main(common + ["--iterations", "8", "--output",
                               paths["straight"]]) == 0
    assert tcli.main(common + ["--iterations", "4", "--checkpoint-dir", ck,
                               "--output", str(tmp_path / "half.png")]) == 0
    assert tcli.main(common + ["--iterations", "8", "--checkpoint-dir", ck,
                               "--resume", "--output",
                               paths["resumed"]]) == 0
    np.testing.assert_array_equal(io.load_image(paths["resumed"]),
                                  io.load_image(paths["straight"]))


def test_cli_profile_dir(image_files, tmp_path):
    prof = tmp_path / "prof"
    assert tcli.main(_pair(image_files, 24) + [
        "--output", str(tmp_path / "p.png"), "--iterations", "2",
        "--profile-dir", str(prof), "--no-compile-cache"] + SMALL + CPU) == 0
    assert [p.suffix for p in prof.iterdir()] == [".json"]


@pytest.mark.parametrize("args,message", [
    ([], "--content"),
    (["--content", "c.png", "--laplacian-impl", "spmd"], "--spatial"),
    (["--content", "c.png", "--spatial", "2", "--autotune"], "--spatial"),
    (["--content-dir", ".", "--spatial", "2"], "--spatial"),
])
def test_cli_flag_validation(args, message, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--style", "s.png"] + args + CPU)
    assert e.value.code != 0
    assert message in capsys.readouterr().err


def test_cli_empty_content_dir(image_files, tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no images found"):
        tcli.main(["--content-dir", str(empty), "--style", image_files[1]]
                  + CPU)


def test_cli_autotune_refuses_a_directory(image_files, tmp_path):
    with pytest.raises(SystemExit, match="--autotune tunes one pair"):
        tcli.main(["--content-dir", str(tmp_path), "--style",
                   image_files[1], "--autotune"] + CPU)


def test_cli_masks_come_together(image_files, tmp_path):
    np.save(tmp_path / "cm.npy", np.ones((1, 32, 32), np.float32))
    with pytest.raises(SystemExit, match="given together"):
        tcli.main(_pair(image_files) + ["--content-masks",
                                        str(tmp_path / "cm.npy"),
                                        "--spatial", "2"] + SMALL + CPU)


def test_cli_device_out_of_range(image_files):
    with pytest.raises(SystemExit, match="--device 99 out of range"):
        tcli.main(_pair(image_files) + ["--device", "99"])


def test_cli_without_a_card_needs_device_cpu(image_files, monkeypatch):
    """No card and no --device: the CLI stops with resolve_device's "no
    CUDA device", and never runs on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(_pair(image_files) + ["--iterations", "1"] + SMALL)


def test_python_m_dpst_tpu_torch(image_files, tmp_path):
    """`python -m dpst_tpu_torch`: --help, then a 2-step --device cpu run;
    the process imports nothing of JAX."""
    def run(args):
        code = ("import runpy, sys; sys.argv = ['dpst_tpu_torch'] + "
                f"{args!r}\n"
                "try:\n    runpy.run_module('dpst_tpu_torch', "
                "run_name='__main__')\n"
                "except SystemExit as e:\n    rc = e.code\n"
                "assert not any(m in ('jax', 'dpst_tpu') or m.startswith(('jax.', "
                "'dpst_tpu.')) for m in sys.modules)\n"
                "print('rc', rc)")
        return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              capture_output=True, text=True, timeout=300)
    res = run(["--help"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "usage: dpst_tpu_torch" in res.stdout and "--device" in res.stdout
    assert res.stdout.strip().endswith("rc 0")
    out = str(tmp_path / "sub.png")
    res = run(_pair(image_files, 24) + ["--output", out, "--iterations",
                                        "2"] + SMALL + CPU)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "final losses" in res.stdout and res.stdout.strip().endswith(
        "rc 0")
    assert io.load_image(out).shape == (24, 24, 3)


# --- the slice against the JAX package ------------------------------------

def test_cli_matches_the_jax_cli(image_files, tmp_path, monkeypatch,
                                 capsys):
    """Both CLIs in-process on one argv (32 px, fp32, 5 steps,
    photorealism on, no masks) and one VGG bundle, the JAX package's
    init_params(0) written as the .npz both read ($DPST_VGG_WEIGHTS): the
    loss CSVs and the images agree."""
    bundle = str(tmp_path / "vgg19.npz")
    jp = jax.tree.map(np.asarray, jvgg.init_params(0))
    np.savez(bundle, **{f"{n}_{k}": v[k] for n, v in jp.items()
                        for k in ("w", "b")})
    monkeypatch.setenv("DPST_VGG_WEIGHTS", bundle)
    argv = _pair(image_files) + ["--iterations", "5", "--no-segmentation",
                                 "--dtype", "float32",
                                 "--regularization-weight", "100",
                                 "--no-compile-cache"]
    runs = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", tcli.main, CPU)):
        out, csv = str(tmp_path / f"{name}.png"), str(tmp_path / f"{name}.csv")
        assert main(argv + ["--output", out, "--loss-csv", csv] + extra) == 0
        runs[name] = (io.load_image(out),
                      np.loadtxt(csv, delimiter=",", skiprows=1))
    assert "final losses" in capsys.readouterr().out
    (jimg, jh), (timg, th) = runs["jax"], runs["torch"]
    assert th.shape == jh.shape == (5, 5)
    for col in range(5):
        np.testing.assert_allclose(
            th[:, col], jh[:, col], rtol=1e-3,
            atol=1e-3 * float(np.abs(jh[:, col]).max()) + 1e-12,
            err_msg=f"history column {col}")
    assert float(tmetrics.ssim(timg, jimg)) >= 0.98
